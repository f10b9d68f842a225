"""Offline volume maintenance: fix, export, backup.

Functional equivalents of reference weed/command/fix.go (rebuild .idx by
scanning .dat), export.go (dump needles to files), backup.go (copy a
volume from a live server), compact.go (offline vacuum).

The port's copy of seaweedfs_tpu/storage/maintenance.py, the incremental
backup over the volume server's gRPC tail plane (server/volume_grpc.py)
included. It takes no device and imports nothing of that package.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional

from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import CrcError, Needle
from seaweedfs_tpu_torch.storage.super_block import SuperBlock


def scan_volume_file(dat_path: str,
                     check_crc: bool = False,
                     stats: Optional[dict] = None
                     ) -> Iterator[tuple[int, Needle]]:
    """Walk every needle record in a .dat, yielding (offset, needle).
    Deletion records (size==0) are yielded too.

    With check_crc, records whose body fails its CRC32-C are counted in
    stats["crc_errors"] and SKIPPED — the header framing is still intact
    so the walk continues at the next record instead of truncating the
    scan at the first flipped bit. Structural damage (unparseable
    header/body) still ends the walk."""
    size = os.path.getsize(dat_path)
    if stats is not None:
        stats.setdefault("crc_errors", 0)
    with open(dat_path, "rb") as f:
        sb = SuperBlock.parse(f.read(super_len := 8 + 65536)[:8 + 65536])
        # needle records are 8-byte aligned; a superblock with extra
        # bytes (e.g. the wide-offset marker) ends unaligned
        offset = (sb.block_size + t.NEEDLE_PADDING_SIZE - 1) \
            // t.NEEDLE_PADDING_SIZE * t.NEEDLE_PADDING_SIZE
        version = sb.version
        while offset + t.NEEDLE_HEADER_SIZE <= size:
            f.seek(offset)
            header = f.read(t.NEEDLE_HEADER_SIZE)
            if len(header) < t.NEEDLE_HEADER_SIZE:
                break
            n = Needle.parse_header(header)
            if n.size < 0:
                break
            record_len = t.get_actual_size(n.size, version)
            f.seek(offset)
            blob = f.read(record_len)
            if len(blob) < record_len:
                break
            try:
                needle = Needle.from_bytes(blob, n.size, version,
                                           check_crc=check_crc)
            except CrcError:
                if stats is not None:
                    stats["crc_errors"] += 1
                offset += record_len
                continue
            except Exception:
                break
            yield offset, needle
            offset += record_len


def detect_offset_bytes(base_path: str) -> int:
    """Offset width of a volume from its superblock marker (volumes
    created with offset_bytes=5 carry b"5BO" in the extra field)."""
    from seaweedfs_tpu_torch.storage.volume import Volume
    try:
        with open(base_path + ".dat", "rb") as f:
            sb = SuperBlock.parse(f.read(8 + 65536))
        return 5 if sb.extra == Volume._WIDE_OFFSET_MARKER else 4
    except (OSError, ValueError):
        return 4


def fix_volume(base_path: str, stats: Optional[dict] = None) -> int:
    """Rebuild <base>.idx from <base>.dat (reference command/fix.go:62).
    Returns number of live entries written. Body CRCs are verified while
    scanning: a bit-rotted needle is dropped from the rebuilt index
    (reads would fail its checksum anyway) and counted in
    stats["crc_errors"]."""
    from seaweedfs_tpu_torch.storage.needle_map import MemDb
    width = detect_offset_bytes(base_path)
    db = MemDb()
    for offset, n in scan_volume_file(base_path + ".dat", check_crc=True,
                                      stats=stats):
        if n.size > 0:
            db.set(n.id, t.actual_to_offset(offset), n.size)
        else:
            db.delete(n.id)
    db.save_to_idx(base_path + ".idx", offset_bytes=width)
    return len(db)


def export_volume(base_path: str, out_dir: str,
                  name_fn: Optional[Callable[[Needle], str]] = None) -> int:
    """Dump live needles as individual files (reference command/export.go).
    Returns file count."""
    from seaweedfs_tpu_torch.storage.needle_map import MemDb
    os.makedirs(out_dir, exist_ok=True)
    live = MemDb.load_from_idx(base_path + ".idx",
                               detect_offset_bytes(base_path)) \
        if os.path.exists(base_path + ".idx") else None
    count = 0
    for offset, n in scan_volume_file(base_path + ".dat"):
        if n.size <= 0:
            continue
        if live is not None:
            hit = live.get(n.id)
            if hit is None or t.offset_to_actual(hit[0]) != offset:
                continue  # overwritten or deleted
        name = (name_fn(n) if name_fn else None) or \
            (n.name.decode(errors="replace") if n.name else f"{n.id:x}")
        safe = name.replace("/", "_") or f"{n.id:x}"
        data = n.data
        if n.is_compressed:
            import gzip
            try:
                data = gzip.decompress(data)
            except OSError:
                pass
        with open(os.path.join(out_dir, safe), "wb") as f:
            f.write(data)
        count += 1
    return count


def backup_volume(master_url: str, vid: int, out_dir: str,
                  collection: str = "") -> str:
    """Pull a volume to a local directory (reference command/backup.go).
    First run copies .dat/.idx whole; later runs against the same
    out_dir catch up INCREMENTALLY via the gRPC tail plane when the
    source serves it — only records appended since the local tail cross
    the wire (the reference's backup does the same via appendAtNs).
    Returns the local base path."""
    from seaweedfs_tpu_torch.utils.httpd import http_call, http_json
    os.makedirs(out_dir, exist_ok=True)
    locs = http_json(
        "GET", f"http://{master_url}/dir/lookup?volumeId={vid}")
    if not locs.get("locations"):
        raise LookupError(f"volume {vid} has no locations")
    url = locs["locations"][0]["url"]
    name = f"{collection}_{vid}" if collection else str(vid)
    base = os.path.join(out_dir, name)

    if os.path.exists(base + ".dat") and os.path.exists(base + ".idx"):
        gport = _grpc_port_for(master_url, url)
        if gport:
            try:
                return _backup_incremental(out_dir, collection, vid,
                                           base, url, gport)
            except Exception:
                pass  # fall through to a full copy

    for ext in (".dat", ".idx"):
        status, body, _ = http_call(
            "GET", f"http://{url}/admin/volume_file?volumeId={vid}"
            f"&ext={ext}&collection={collection}", timeout=600)
        if status >= 400:
            raise IOError(f"backup {ext}: HTTP {status}")
        with open(base + ext, "wb") as f:
            f.write(body)
    return base


def _grpc_port_for(master_url: str, node_url: str) -> int:
    """The node's advertised gRPC port, from the master topology.
    Best-effort: ANY failure means 'no gRPC plane' and the caller does
    a full copy."""
    from seaweedfs_tpu_torch.cluster.topology import find_node_info
    from seaweedfs_tpu_torch.utils.httpd import http_json
    try:
        topo = http_json("GET", f"http://{master_url}/dir/status")
        node = find_node_info(topo.get("Topology", topo), node_url)
    except Exception:
        return 0
    return node.get("grpc_port", 0) if node else 0


def _backup_incremental(out_dir: str, collection: str, vid: int,
                        base: str, node_url: str, gport: int) -> str:
    """Open the local copy as a volume and replay the source's tail
    (appends + deletes) since the local last-append timestamp."""
    from seaweedfs_tpu_torch.server.volume_grpc import GrpcVolumeClient
    from seaweedfs_tpu_torch.storage.volume import Volume
    host = node_url.rsplit(":", 1)[0]
    v = Volume(out_dir, collection, vid)
    try:
        client = GrpcVolumeClient(f"{host}:{gport}")
        try:
            # a source-side vacuum rewrote history (deletes absorbed
            # into the compacted file would never reach the tail) —
            # revision mismatch forces a full re-copy, like the
            # reference's CompactRevision check (command/backup.go)
            st = client.read_volume_file_status(vid)
            if st.compaction_revision != \
                    v.super_block.compaction_revision:
                raise RuntimeError("compaction revision changed")
            since = _last_local_append_ns(v, base)
            for n in client.volume_tail_needles(vid, since_ns=since):
                if n.size == 0 and not n.data:
                    v.delete_needle(n.id)
                else:
                    v.write_needle(n)
        finally:
            client.close()
    finally:
        v.close()
    return base


def _last_local_append_ns(v, base: str) -> int:
    """append_at_ns of the newest LIVE record in the local copy: walk
    the .idx backwards past tombstones to the last addressable needle
    (replaying a hair too much is harmless — the records are
    idempotent)."""
    esize = t.entry_size(v.offset_bytes)
    try:
        size = os.path.getsize(base + ".idx")
    except OSError:
        return 0
    with open(base + ".idx", "rb") as f:
        pos = size - esize
        while pos >= 0:
            f.seek(pos)
            key, off, sz = t.unpack_entry(f.read(esize), 0,
                                          v.offset_bytes)
            if off != 0 and t.size_is_valid(sz):
                try:
                    return v.read_needle(key).append_at_ns
                except Exception:
                    # the needle behind this stale idx entry was later
                    # deleted (or is unreadable) — keep walking back
                    pass
            pos -= esize
    return 0


def compact_volume(base_path: str) -> tuple[int, int]:
    """Offline vacuum (reference command/compact.go): open the volume in
    place and compact. Returns (before_bytes, after_bytes)."""
    from seaweedfs_tpu_torch.storage.volume import Volume
    directory, name = os.path.split(base_path)
    if "_" in name:
        collection, vid = name.rsplit("_", 1)
    else:
        collection, vid = "", name
    v = Volume(directory, collection, int(vid))
    before = v.content_size()
    v.compact()
    after = v.content_size()
    v.close()
    return before, after
