"""Disk-backed needle maps: memory-light alternatives to CompactMap (the
port of seaweedfs_tpu/storage/needle_map_disk.py).

The reference selects a NeedleMapKind per volume server
(weed/storage/needle_map.go:13-19): in-memory CompactMap, three LevelDB
flavors (needle_map_leveldb.go) trading memory for disk, and a
sorted-file map for readonly volumes (needle_map_sorted_file.go). This
module provides the disk-backed kinds over our own primitives:

  - LdbNeedleMap: id -> (offset,size) in the LSM engine (utils/lsm.py),
    O(1) memory in needle count like the reference's LevelDB maps; the
    .ldb directory sits next to the volume files and is rebuilt from
    .idx when missing or stale (reference needle_map_leveldb.go:40-70).
  - SortedFileNeedleMap: binary search over a sorted .sdx file built
    from the .idx log — for readonly/sealed volumes (reference
    needle_map_sorted_file.go; same idea as the EC .ecx index,
    ec_encoder.go:27-54).

Both expose the CompactMap surface used by Volume: set/get/delete/
ascending_visit + file_count/deleted_count stats.
"""

from __future__ import annotations

import os
import struct
from typing import Callable, Optional

from seaweedfs_tpu_torch.storage import idx as idxmod
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.utils.lsm import LsmKv

_KEY = struct.Struct(">Q")
_VAL = struct.Struct(">Qi")  # offset in units (fits 5-byte widths), size


class LdbNeedleMap:
    """id -> (offset,size) in an LSM directory next to the volume."""

    def __init__(self, ldb_dir: str, idx_path: Optional[str] = None,
                 offset_bytes: int = 4):
        self.offset_bytes = offset_bytes
        self.kv = LsmKv(ldb_dir, fsync=False)  # .idx is the durable log
        self.file_count = 0
        self.deleted_count = 0
        self.deleted_bytes = 0
        self._live: Optional[int] = None  # lazily counted, then tracked
        self._load_stats()
        if idx_path and os.path.exists(idx_path):
            self._sync_from_idx(idx_path)

    def _load_stats(self) -> None:
        import json
        raw = self.kv.get(b"\x00stats")
        if raw:
            s = json.loads(raw)
            self.file_count = s.get("file_count", 0)
            self.deleted_count = s.get("deleted_count", 0)
            self.deleted_bytes = s.get("deleted_bytes", 0)
            if "live" in s:
                self._live = s["live"]

    def _save_stats(self) -> None:
        import json
        self.kv.put(b"\x00stats", json.dumps(
            {"file_count": self.file_count,
             "deleted_count": self.deleted_count,
             "deleted_bytes": self.deleted_bytes,
             "live": len(self)}).encode())

    def _sync_from_idx(self, idx_path: str) -> None:
        """Replay .idx entries the map hasn't seen yet. The watermark is
        the .idx size at last sync (reference needle_map_metric +
        leveldb recovery replays from a stored watermark)."""
        mark = self.kv.get(b"\x00watermark")
        start = int(mark) if mark else 0
        idx_size = os.path.getsize(idx_path)
        if idx_size < start:
            # idx truncated (vacuum rewrote it): stale LSM entries would
            # survive an incremental replay — wipe and rebuild
            import shutil
            ldb_dir = self.kv.dir
            self.kv.close()
            shutil.rmtree(ldb_dir, ignore_errors=True)
            self.kv = LsmKv(ldb_dir, fsync=False)
            self.file_count = self.deleted_count = self.deleted_bytes = 0
            self._live = 0
            start = 0

        def visit(key, off, size):
            if off != 0 and size != t.TOMBSTONE_FILE_SIZE:
                self.set(key, off, size)
                self.file_count += 1
            elif self.delete(key):
                self.deleted_count += 1

        esize = t.entry_size(self.offset_bytes)
        idxmod.walk_index_file(idx_path, visit, start_from=start // esize,
                               offset_bytes=self.offset_bytes)
        self.kv.put(b"\x00watermark", str(idx_size).encode())

    def set(self, key: int, offset_units: int, size: int) -> None:
        if self._live is not None and self.kv.get(_KEY.pack(key)) is None:
            self._live += 1
        self.kv.put(_KEY.pack(key), _VAL.pack(offset_units, size))

    def get(self, key: int) -> Optional[tuple[int, int]]:
        raw = self.kv.get(_KEY.pack(key))
        if raw is None:
            return None
        off, size = _VAL.unpack(raw)
        if size == t.TOMBSTONE_FILE_SIZE:
            return None
        return off, size

    def delete(self, key: int) -> bool:
        existed = self.get(key) is not None
        if existed:
            self.kv.put(_KEY.pack(key), None)
            if self._live is not None:
                self._live -= 1
        return existed

    def ascending_visit(self, fn: Callable[[int, int, int], None]) -> None:
        for key, raw in self.kv.scan(_KEY.pack(0)):
            if key == b"\x00watermark" or len(key) != 8:
                continue
            off, size = _VAL.unpack(raw)
            fn(_KEY.unpack(key)[0], off, size)

    def __len__(self) -> int:
        """Live needle count; O(n) once per open, then O(1) (the
        heartbeat asks for this every pulse)."""
        if self._live is None:
            self._live = sum(1 for k, _ in self.kv.scan() if len(k) == 8)
        return self._live

    def mark_watermark(self, idx_path: str) -> None:
        self.kv.put(b"\x00watermark",
                    str(os.path.getsize(idx_path)).encode())
        self._save_stats()

    def close(self) -> None:
        self.kv.close()


class SortedFileNeedleMap:
    """Readonly needle map: binary search over a sorted .sdx file."""

    def __init__(self, sdx_path: str, offset_bytes: int = 4):
        self.path = sdx_path
        self.offset_bytes = offset_bytes
        self._esize = t.entry_size(offset_bytes)
        self._f = open(sdx_path, "rb")
        self._count = os.path.getsize(sdx_path) // self._esize
        self.file_count = self._count
        self.deleted_count = 0
        self.deleted_bytes = 0

    @classmethod
    def build_from_idx(cls, idx_path: str, sdx_path: str,
                       offset_bytes: int = 4) -> "SortedFileNeedleMap":
        """Replay the .idx log into a sorted snapshot (reference
        WriteSortedFileFromIdx, needle_map_sorted_file.go:95)."""
        from seaweedfs_tpu_torch.storage.needle_map import MemDb
        db = MemDb.load_from_idx(idx_path, offset_bytes)
        db.save_to_idx(sdx_path, offset_bytes)
        return cls(sdx_path, offset_bytes)

    def _entry_at(self, i: int) -> tuple[int, int, int]:
        self._f.seek(i * self._esize)
        return t.unpack_entry(self._f.read(self._esize), 0,
                              self.offset_bytes)

    def get(self, key: int) -> Optional[tuple[int, int]]:
        lo, hi = 0, self._count
        while lo < hi:
            mid = (lo + hi) // 2
            k, off, size = self._entry_at(mid)
            if k == key:
                if size == t.TOMBSTONE_FILE_SIZE:
                    return None
                return off, size
            if k < key:
                lo = mid + 1
            else:
                hi = mid
        return None

    def set(self, key: int, offset_units: int, size: int) -> None:
        raise PermissionError("sorted-file needle map is readonly")

    def delete(self, key: int) -> bool:
        """Tombstone in place, like the EC .ecx delete
        (ec_volume_delete.go:13-49): seek and overwrite the size."""
        lo, hi = 0, self._count
        while lo < hi:
            mid = (lo + hi) // 2
            k, off, size = self._entry_at(mid)
            if k == key:
                if size == t.TOMBSTONE_FILE_SIZE:
                    return False
                with open(self.path, "r+b") as wf:
                    wf.seek(mid * self._esize)
                    wf.write(t.pack_entry(k, off, t.TOMBSTONE_FILE_SIZE,
                                          self.offset_bytes))
                self.deleted_count += 1
                return True
            if k < key:
                lo = mid + 1
            else:
                hi = mid
        return False

    def ascending_visit(self, fn: Callable[[int, int, int], None]) -> None:
        for i in range(self._count):
            k, off, size = self._entry_at(i)
            fn(k, off, size)

    def __len__(self) -> int:
        return self._count

    def close(self) -> None:
        self._f.close()
