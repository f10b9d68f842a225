"""High-level client operations: assign + upload/download/delete.

Functional equivalent of reference weed/operation (assign_file_id.go,
upload_content.go, delete_content.go): assign a fid from the master, then
move bytes with the volume server, optionally gzip-compressing.

The port's copy of seaweedfs_tpu/client/operation.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import gzip
import urllib.parse
from typing import Optional

from seaweedfs_tpu_torch.client.wdclient import MasterClient
from seaweedfs_tpu_torch.storage.file_id import parse_needle_id_cookie
from seaweedfs_tpu_torch.utils import headers as weed_headers
from seaweedfs_tpu_torch.utils import tracing
from seaweedfs_tpu_torch.utils.httpd import HttpError, http_call, http_json
from seaweedfs_tpu_torch.utils.resilience import Deadline, hedged


class UploadResult:
    def __init__(self, fid: str, url: str, size: int, etag: str = ""):
        self.fid = fid
        self.url = url
        self.size = size
        self.etag = etag

    def __repr__(self):
        return f"UploadResult(fid={self.fid!r}, size={self.size})"


def upload_data(mc: MasterClient, data: bytes, name: str = "",
                collection: str = "", replication: str = "",
                ttl: str = "", mime: str = "",
                compress: bool = False) -> UploadResult:
    # batched assigns: one master round trip mints a pool of keys, so
    # the hot path is a single volume-server POST per file (reference
    # clients amortize the assign plane the same way via gRPC)
    with tracing.child_scope("client.upload_data"):
        a = mc.assign_batched(collection=collection,
                              replication=replication, ttl=ttl)
        if "error" in a and a["error"]:
            raise RuntimeError(a["error"])
        fid, url = a["fid"], a["url"]
        return upload_to(fid, url, data, name=name, mime=mime,
                         compress=compress, auth=a.get("auth", ""))


def upload_to(fid: str, server_url: str, data: bytes, name: str = "",
              mime: str = "", compress: bool = False,
              auth: str = "") -> UploadResult:
    body = data
    qs = {"name": name, "mime": mime}
    if compress and len(data) > 128:
        gz = gzip.compress(data, 6)
        if len(gz) < len(data) * 0.9:
            body = gz
            qs["gzip"] = "1"
    query = urllib.parse.urlencode({k: v for k, v in qs.items() if v})
    headers = {"Authorization": f"Bearer {auth}"} if auth else {}
    status, resp, _ = http_call(
        "POST", f"http://{server_url}/{fid}?{query}", body=body,
        headers=headers)
    if status >= 400:
        raise HttpError(status, resp)
    return UploadResult(fid, server_url, len(data))


def read_data(mc: MasterClient, fid: str,
              byte_range: Optional[tuple] = None) -> bytes:
    """Read one needle (or, with ``byte_range=(lo, hi)`` inclusive, just
    that slice of its payload — served via a Range request, which an EC
    volume satisfies by reconstructing only the covering byte ranges on
    degraded reads). Replica holders are ranked by the client's
    learned per-peer health (breakers screen recently-failing servers)
    and a stalled first pick triggers a hedged backup fetch on the
    next-ranked replica — the serial walk failed over only after a
    full timeout, paying the slowest server's tail on every read.
    delete_file below stays serial: deletes are not safe to race.

    Two divergence-era behaviors ride the fetch:
    - cache-aware routing: a replica whose response carries the
      cache-hot header gets a bounded per-needle affinity entry in the
      MasterClient, and is tried first on the next read of the same
      needle (fairness guard in affinity_get keeps the other replicas
      warm);
    - read-repair reporting: a replica that answered 404 while a
      sibling served the bytes is lagging a quorum write — after the
      successful read, each lagging holder gets a best-effort
      /admin/replica_repair nudge so it pulls the needle now instead
      of waiting for the owner's hint drain."""
    vid = int(fid.split(",")[0])
    try:
        key, _cookie = parse_needle_id_cookie(fid.split(",", 1)[1])
    except (IndexError, ValueError):
        key = None
    urls = [loc["url"] for loc in mc.lookup_volume(vid)]
    if not urls:
        raise RuntimeError("no locations")
    errors: list[Exception] = []
    lagging: list[str] = []
    headers = {}
    if byte_range is not None:
        lo, hi = byte_range
        headers["Range"] = f"bytes={lo}-{hi}"

    def fetch(url: str):
        try:
            status, body, hdrs = http_call(
                "GET", f"http://{url}/{fid}", headers=headers or None)
        except ConnectionError as e:
            errors.append(e)
            return None
        if status == 200 or (status == 206 and byte_range is not None):
            return (url, body, hdrs)
        if status == 404:
            # may be legitimately absent everywhere; only report once
            # some sibling proves it exists by serving it
            lagging.append(url)
        errors.append(HttpError(status, body))
        return None

    health = mc.peer_health
    tracing.annotate("read.replicas", len(urls))
    ranked = health.rank(urls)
    if key is not None:
        preferred = mc.affinity_get(vid, key)
        if preferred in ranked:
            ranked = [preferred] + [u for u in ranked if u != preferred]
    out = hedged(fetch, ranked, health=health)
    if out is None:
        # every replica failed: the holder set may have moved — drop
        # the cached lookup so the next attempt sees fresh locations
        mc.invalidate(vid)
        if key is not None:
            mc.affinity_drop(vid, key)
        raise errors[-1] if errors else RuntimeError(
            f"no replica of {fid} answered")
    url, body, hdrs = out
    if key is not None:
        if hdrs.get(weed_headers.CACHE_HOT):
            mc.affinity_note(vid, key, url)
        for lag in lagging:
            if lag == url:
                continue
            try:
                http_json("POST", f"http://{lag}/admin/replica_repair",
                          {"volume_id": vid, "key": key},
                          deadline=Deadline.after(5.0))
            except (ConnectionError, HttpError):
                pass  # best-effort: the hint drain still covers it
    return body


def delete_file(mc: MasterClient, fid: str) -> bool:
    vid = int(fid.split(",")[0])
    for loc in mc.lookup_volume(vid):
        try:
            status, _, _ = http_call("DELETE",
                                     f"http://{loc['url']}/{fid}")
            return status < 400
        except ConnectionError:
            continue
    return False
