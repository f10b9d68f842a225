"""volume.fsck: cross-check filer chunk references against volume-server
needle inventories.

Redesign of reference weed/shell/command_volume_fsck.go:37-80: the filer
namespace is walked collecting every referenced fid (manifest chunks
expanded), each volume server's needle inventory is collected via the
volume-digest admin plane, and the two sets are diffed both ways:

  orphans — needles no filer entry references (leaked by crashed
            uploads, aborted multiparts, missed GC); `fix=True` purges
            them (reference -forcePurging)
  missing — chunk references whose needle is gone (broken files a user
            WILL hit); always report-only

Like the reference, fsck assumes a quiesced namespace: an upload whose
entry has not been created yet (e.g. a mount handle between write and
flush) looks orphaned — run without active writers, or without fix.

The port's copy of seaweedfs_tpu/shell/fsck.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import json
from typing import Optional

from seaweedfs_tpu_torch.utils.httpd import HttpError, http_call, http_json


def volume_fsck(sh, filer_url: str, fix: bool = False,
                collection: Optional[str] = None) -> dict:
    """sh: ShellContext (topology + volume-server plane access)."""
    # 1) referenced fids, per volume id
    referenced: dict[int, set[str]] = {}
    broken_entries: list[dict] = []
    walk_errors: list[str] = []
    _walk_filer(filer_url, "/", referenced, broken_entries, walk_errors)

    # 2) needle inventory per volume, per server
    topo = sh.topology()
    orphans: list[dict] = []
    missing: list[dict] = []
    seen_fids: dict[int, set[str]] = {}
    volume_homes: dict[int, list[str]] = {}
    for dc in topo.get("data_centers", []):
        for rack in dc.get("racks", []):
            for node in rack.get("nodes", []):
                for v in node.get("volumes", []):
                    vid = v["id"]
                    if collection and v.get("collection") != collection:
                        continue
                    volume_homes.setdefault(vid, []).append(node["id"])
                    try:
                        digest = http_json(
                            "GET", f"http://{node['id']}"
                                   f"/admin/volume_digest?volumeId={vid}")
                    except (ConnectionError, HttpError):
                        continue
                    keys = seen_fids.setdefault(vid, set())
                    for k, _size in digest.get("keys", []):
                        keys.add(f"{k:x}")

    # 3) diff
    for vid, keys in seen_fids.items():
        refs = {fid.split(",")[1][:-8].lstrip("0") or "0"
                for fid in referenced.get(vid, set())}
        for key_hex in sorted(keys - refs):
            orphans.append({"volume_id": vid, "needle": key_hex,
                            "servers": volume_homes.get(vid, [])})
    for vid, fids in referenced.items():
        have = seen_fids.get(vid)
        if have is None:
            continue  # volume not served right now (moving/ec) — skip
        for fid in sorted(fids):
            key_hex = fid.split(",")[1][:-8].lstrip("0") or "0"
            if key_hex not in have:
                missing.append({"volume_id": vid, "fid": fid})

    purged = 0
    # NEVER purge off an incomplete picture: a directory that failed to
    # list (or a manifest that failed to read) hides live references,
    # and everything under it would look orphaned (reference fsck
    # aborts on traverse errors the same way)
    purge_refused = fix and bool(walk_errors or broken_entries)
    if purge_refused:
        fix = False
    if fix and orphans:
        by_server: dict[str, list[str]] = {}
        for o in orphans:
            for server in o["servers"]:
                # cookie-less delete: the admin plane purge path
                by_server.setdefault(server, []).append(
                    f"{o['volume_id']},{o['needle']}00000000")
        for server, fids in by_server.items():
            try:
                out = sh._vs(server, "/admin/batch_delete",
                             {"file_ids": fids,
                              "skip_cookie_check": True})
                purged += sum(1 for r in out.get("results", [])
                              if r.get("status", 500) < 300)
            except (ConnectionError, HttpError, RuntimeError):
                continue

    return {
        "volumes_checked": len(seen_fids),
        "entries_referencing": sum(len(s) for s in referenced.values()),
        "orphans": orphans,
        "orphan_count": len(orphans),
        "missing": missing,
        "missing_count": len(missing),
        "broken_entries": broken_entries,
        "walk_errors": walk_errors,
        "purged": purged,
        "purge_refused": purge_refused,
    }


def _walk_filer(filer_url: str, path: str,
                referenced: dict[int, set[str]],
                broken: list[dict], errors: list[str],
                page: int = 10000) -> None:
    last = ""
    while True:
        qs = f"?limit={page}"
        if last:
            qs += f"&lastFileName={_quote_qv(last)}"
        try:
            out = http_json("GET",
                            f"http://{filer_url}{_quote(path)}{qs}")
        except (ConnectionError, HttpError) as e:
            errors.append(f"{path}: {e}")
            return
        entries = out.get("Entries", [])
        for e in entries:
            if e.get("IsDirectory"):
                _walk_filer(filer_url, e["FullPath"], referenced,
                            broken, errors, page)
                continue
            for c in e.get("chunks", []):
                _collect_chunk(filer_url, e["FullPath"], c, referenced,
                               broken)
        # keep paging while the filer says the listing was truncated
        if not out.get("ShouldDisplayLoadMore") or not entries:
            return
        last = entries[-1]["FullPath"].rsplit("/", 1)[-1]


def _collect_chunk(filer_url: str, entry_path: str, chunk: dict,
                   referenced: dict[int, set[str]],
                   broken: list[dict]) -> None:
    fid = chunk.get("fid", "")
    try:
        vid = int(fid.split(",")[0])
    except (ValueError, IndexError):
        broken.append({"entry": entry_path, "bad_fid": fid})
        return
    referenced.setdefault(vid, set()).add(fid)
    if chunk.get("is_chunk_manifest"):
        # a manifest blob references leaf chunks — expand (reference
        # fsck resolves manifests the same way)
        try:
            ck = chunk.get("cipher_key", "")
            qs = f"?cipher_key={ck}" if ck else ""
            status, blob, _ = http_call(
                "GET", f"http://{filer_url}/__api/chunk/{fid}{qs}")
            if status != 200:
                raise HttpError(status, blob)
            for leaf in json.loads(blob)["chunks"]:
                _collect_chunk(filer_url, entry_path, leaf, referenced,
                               broken)
        except (ConnectionError, HttpError, ValueError, KeyError):
            broken.append({"entry": entry_path,
                           "unreadable_manifest": fid})


def _quote(path: str) -> str:
    import urllib.parse
    return urllib.parse.quote(path)


def _quote_qv(value: str) -> str:
    import urllib.parse
    return urllib.parse.quote(value, safe="")
