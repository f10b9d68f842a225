"""Needle maps: id -> (offset, size) per volume.

Two implementations mirroring the reference's roles:
  - MemDb: sorted in-memory map used for offline work (.idx -> .ecx
    conversion, vacuum); reference weed/storage/needle_map/memdb.go uses a
    btree, we keep a dict + sort-on-visit which is O(n log n) amortized and
    cache-friendly.
  - CompactMap: the serving map. The reference
    (weed/storage/needle_map/compact_map.go:28-37) uses sectioned sorted
    arrays with binary search; we use numpy sorted arrays with
    np.searchsorted — same asymptotics, vectorized rebuilds.
"""

from __future__ import annotations

import io
from typing import Callable, Iterator, Optional

import numpy as np

from seaweedfs_tpu_torch.storage import idx as idxmod
from seaweedfs_tpu_torch.storage import types as t


class MemDb:
    """Offline needle map with ascending iteration."""

    def __init__(self):
        self._m: dict[int, tuple[int, int]] = {}

    def set(self, key: int, offset_units: int, size: int) -> None:
        self._m[key] = (offset_units, size)

    def delete(self, key: int) -> None:
        self._m.pop(key, None)

    def get(self, key: int) -> Optional[tuple[int, int]]:
        return self._m.get(key)

    def __len__(self):
        return len(self._m)

    def ascending_visit(self, fn: Callable[[int, int, int], None]) -> None:
        for key in sorted(self._m):
            off, size = self._m[key]
            fn(key, off, size)

    def items_ascending(self) -> Iterator[tuple[int, int, int]]:
        for key in sorted(self._m):
            off, size = self._m[key]
            yield key, off, size

    @classmethod
    def load_from_idx(cls, idx_path: str, offset_bytes: int = 4) -> "MemDb":
        """Replay an .idx log: later entries win; tombstones delete
        (reference ec_encoder.go readNeedleMap)."""
        db = cls()
        def visit(key, off, size):
            if off != 0 and size != t.TOMBSTONE_FILE_SIZE:
                db.set(key, off, size)
            else:
                db.delete(key)
        idxmod.walk_index_file(idx_path, visit, offset_bytes=offset_bytes)
        return db

    def save_to_idx(self, path: str, offset_bytes: int = 4) -> None:
        buf = io.BytesIO()
        for key, off, size in self.items_ascending():
            buf.write(t.pack_entry(key, off, size, offset_bytes))
        with open(path, "wb") as f:
            f.write(buf.getvalue())


class CompactMap:
    """Serving needle map over sorted numpy arrays.

    Append-heavy workloads batch inserts in a small dict overlay and merge
    into the sorted base arrays when the overlay grows; lookups check the
    overlay then binary-search the base.
    """

    _MERGE_THRESHOLD = 4096

    def __init__(self):
        self._keys = np.empty(0, dtype=np.uint64)
        # uint64 offsets so 5-byte-offset volumes (8TB) fit too
        self._offsets = np.empty(0, dtype=np.uint64)
        self._sizes = np.empty(0, dtype=np.int32)
        self._overlay: dict[int, tuple[int, int]] = {}
        self.file_count = 0
        self.deleted_count = 0
        self.deleted_bytes = 0

    def __len__(self):
        return len(self._keys) + len(self._overlay)

    def _merge(self) -> None:
        if not self._overlay:
            return
        ok = np.fromiter(self._overlay.keys(), dtype=np.uint64,
                         count=len(self._overlay))
        ov = list(self._overlay.values())
        oo = np.array([v[0] for v in ov], dtype=np.uint64)
        os_ = np.array([v[1] for v in ov], dtype=np.int32)
        keys = np.concatenate([self._keys, ok])
        offs = np.concatenate([self._offsets, oo])
        sizes = np.concatenate([self._sizes, os_])
        # stable sort; for duplicate keys keep the LAST occurrence (overlay wins)
        order = np.argsort(keys, kind="stable")
        keys, offs, sizes = keys[order], offs[order], sizes[order]
        keep = np.ones(len(keys), dtype=bool)
        if len(keys) > 1:
            keep[:-1] = keys[:-1] != keys[1:]
        self._keys, self._offsets, self._sizes = keys[keep], offs[keep], sizes[keep]
        self._overlay.clear()

    def set(self, key: int, offset_units: int, size: int) -> None:
        self._overlay[key] = (offset_units, size)
        if len(self._overlay) >= self._MERGE_THRESHOLD:
            self._merge()

    def get(self, key: int) -> Optional[tuple[int, int]]:
        v = self._overlay.get(key)
        if v is not None:
            if v[1] == t.TOMBSTONE_FILE_SIZE:
                return None
            return v
        i = np.searchsorted(self._keys, np.uint64(key))
        if i < len(self._keys) and self._keys[i] == key:
            size = int(self._sizes[i])
            if size == t.TOMBSTONE_FILE_SIZE:
                return None
            return int(self._offsets[i]), size
        return None

    def delete(self, key: int) -> bool:
        existed = self.get(key) is not None
        if existed:
            self._overlay[key] = (0, t.TOMBSTONE_FILE_SIZE)
        return existed

    def ascending_visit(self, fn: Callable[[int, int, int], None]) -> None:
        self._merge()
        for i in range(len(self._keys)):
            fn(int(self._keys[i]), int(self._offsets[i]), int(self._sizes[i]))
