"""RemoteFilerStore: a FilerStore backed by another filer's HTTP API.

This is what lets gateways run as standalone processes attached to an
existing filer — `weed-tpu s3 -filer=<addr>`, `webdav`, `ftp` — the way
the reference's gateways dial a remote filer over filer_pb gRPC
(weed/command/s3.go, webdav.go). The adapter speaks the filer's
row-level metadata endpoints (/__api/entry meta_only/raw, /__api/list,
/__api/kv), so exactly one hard-link/GC layer runs (the local wrapper in
the gateway's Filer); the remote filer's own clients see the same rows
and shared KV records.

Shard-aware placement: the `/__api/*` row endpoints serve LOCAL rows
and never 307-redirect, so against a sharded filer cluster a
single-address gateway would silently see one shard's slice of the
namespace.  The adapter therefore probes its home filer's
`/__api/shard/status` (TTL-cached), and when sharding is active routes
every row operation straight to the owning shard per the ring — which
is also the perf win the rebalancer banks on: one routed hop saved on
every namespace op, and a migrated directory is followed within one
ring refresh.  Ring adoption is forward-only (`>=` on the epoch), same
discipline as wdclient.

The port's copy of seaweedfs_tpu/filer/remote_store.py, the same code
with its imports pointed at the port; it imports nothing of that
package.
"""

from __future__ import annotations

import threading
import urllib.parse
from typing import Optional

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore
from seaweedfs_tpu_torch.filer.shard_ring import ShardRing
from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json

# how long a pulled ring serves before the next status probe; short
# enough that a live migration is followed within the mover's
# post-flip delta window
RING_TTL_S = 5.0


class RemoteFilerStore(FilerStore):
    name = "remote"

    def __init__(self, filer_addr: str, ring_ttl_s: float = RING_TTL_S):
        self.addr = filer_addr
        self.ring_ttl_s = ring_ttl_s
        self._ring: Optional[ShardRing] = None
        self._ring_deadline = 0.0
        self._ring_lock = threading.Lock()

    def _base(self, addr: str) -> str:
        return f"http://{addr}/__api"

    # ---- shard ring (home-filer probe, TTL-cached) ----
    def _ring_now(self) -> Optional[ShardRing]:
        now = clockctl.now()
        with self._ring_lock:
            if now < self._ring_deadline:
                return self._ring
            # claim the refresh slot before dropping the lock; a
            # failed probe just serves the stale ring for one more TTL
            self._ring_deadline = now + self.ring_ttl_s
        ring = None
        try:
            out = http_json(
                "GET", f"{self._base(self.addr)}/shard/status", timeout=5)
            if out.get("active") and out.get("ring"):
                ring = ShardRing.from_dict(out["ring"])
        except Exception:
            return self._ring
        with self._ring_lock:
            if ring is None:
                self._ring = None
            elif self._ring is None or ring.epoch >= self._ring.epoch:
                self._ring = ring
            return self._ring

    def _addr_for_path(self, path: str) -> str:
        """The shard holding the row at `path`, else the home filer."""
        ring = self._ring_now()
        if ring is not None and len(ring) > 1:
            return ring.owner_for_path(path) or self.addr
        return self.addr

    def _addr_for_dir(self, dir_path: str) -> str:
        """The shard owning `dir_path`'s child rows (listings and
        children-deletes are single-shard by construction)."""
        ring = self._ring_now()
        if ring is not None and len(ring) > 1:
            return ring.owner(dir_path) or self.addr
        return self.addr

    def insert_entry(self, entry: Entry) -> None:
        http_json("POST",
                  f"{self._base(self._addr_for_path(entry.full_path))}"
                  f"/entry",
                  {"entry": entry.to_dict(), "meta_only": True})

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Optional[Entry]:
        q = urllib.parse.quote(full_path)
        try:
            out = http_json(
                "GET",
                f"{self._base(self._addr_for_path(full_path))}"
                f"/entry?path={q}&raw=true")
        except HttpError as e:
            if e.status == 404:
                return None
            raise
        return Entry.from_dict(out["entry"])

    def delete_entry(self, full_path: str) -> None:
        # http_json raises on errors — a swallowed failure here would let
        # the caller GC chunks while the remote row survives
        q = urllib.parse.quote(full_path)
        http_json("DELETE",
                  f"{self._base(self._addr_for_path(full_path))}"
                  f"/entry?path={q}")

    def delete_folder_children(self, full_path: str) -> None:
        q = urllib.parse.quote(full_path)
        http_json("DELETE",
                  f"{self._base(self._addr_for_dir(full_path))}"
                  f"/entry?path={q}&children=true")

    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        qs = urllib.parse.urlencode({
            "dir": dir_path, "start": start_name,
            "include_start": "true" if include_start else "false",
            "limit": str(limit), "prefix": prefix})
        out = http_json(
            "GET", f"{self._base(self._addr_for_dir(dir_path))}/list?{qs}")
        return [Entry.from_dict(d) for d in out["entries"]]

    # KV records stay on the home filer: they are shared cluster state
    # (filer.conf, hard-link refcounts) replicated outside the ring's
    # directory partitioning
    def kv_put(self, key: bytes, value: bytes) -> None:
        http_json("POST", f"{self._base(self.addr)}/kv",
                  {"key": key.decode(), "value": value.hex()})

    def kv_get(self, key: bytes) -> Optional[bytes]:
        q = urllib.parse.quote(key.decode())
        try:
            out = http_json("GET", f"{self._base(self.addr)}/kv?key={q}")
        except HttpError as e:
            if e.status == 404:
                return None
            raise
        return bytes.fromhex(out["value"])

    def kv_delete(self, key: bytes) -> None:
        http_json("POST", f"{self._base(self.addr)}/kv",
                  {"key": key.decode(), "delete": True})
