"""Tiered chunk cache (reference weed/util/chunk_cache: in-memory + on-disk
tiers in front of volume-server chunk fetches, used by filer and mount).

The port's copy of seaweedfs_tpu/utils/chunk_cache.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Optional


class MemChunkCache:
    def __init__(self, capacity_bytes: int = 64 * 1024 * 1024):
        self.capacity = capacity_bytes
        self._used = 0
        self._data: "collections.OrderedDict[str, bytes]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return None

    def put(self, key: str, value: bytes) -> None:
        if len(value) > self.capacity:
            return
        with self._lock:
            if key in self._data:
                self._used -= len(self._data.pop(key))
            while self._used + len(value) > self.capacity and self._data:
                _, evicted = self._data.popitem(last=False)
                self._used -= len(evicted)
            self._data[key] = value
            self._used += len(value)

    def contains(self, key: str) -> bool:
        """Presence probe that does NOT touch LRU order or counters
        (prefetch planning must not look like traffic)."""
        with self._lock:
            return key in self._data


class DiskChunkCache:
    def __init__(self, directory: str,
                 capacity_bytes: int = 1024 * 1024 * 1024):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.capacity = capacity_bytes
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        h = hashlib.sha1(key.encode()).hexdigest()
        return os.path.join(self.directory, h[:2], h)

    def get(self, key: str) -> Optional[bytes]:
        p = self._path(key)
        try:
            with open(p, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def contains(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def put(self, key: str, value: bytes) -> None:
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with self._lock:
            with open(p + ".tmp", "wb") as f:
                f.write(value)
            os.replace(p + ".tmp", p)
            self._evict_if_needed()

    def _evict_if_needed(self) -> None:
        total = 0
        files = []
        for root, _dirs, names in os.walk(self.directory):
            for n in names:
                p = os.path.join(root, n)
                try:
                    st = os.stat(p)
                except FileNotFoundError:
                    continue
                total += st.st_size
                files.append((st.st_atime, st.st_size, p))
        if total <= self.capacity:
            return
        files.sort()
        for _, size, p in files:
            try:
                os.remove(p)
            except FileNotFoundError:
                continue
            total -= size
            if total <= self.capacity:
                break


class TieredChunkCache:
    """Memory in front of disk (reference chunk_cache.NewTieredChunkCache)."""

    def __init__(self, mem_bytes: int = 64 * 1024 * 1024,
                 disk_dir: Optional[str] = None,
                 disk_bytes: int = 1024 * 1024 * 1024):
        self.mem = MemChunkCache(mem_bytes)
        self.disk = DiskChunkCache(disk_dir, disk_bytes) if disk_dir else None

    def get(self, key: str) -> Optional[bytes]:
        hit = self.mem.get(key)
        if hit is not None:
            return hit
        if self.disk is not None:
            hit = self.disk.get(key)
            if hit is not None:
                self.mem.put(key, hit)
        return hit

    def put(self, key: str, value: bytes) -> None:
        self.mem.put(key, value)
        if self.disk is not None and len(value) >= 1024:
            self.disk.put(key, value)

    def contains(self, key: str) -> bool:
        if self.mem.contains(key):
            return True
        return self.disk is not None and self.disk.contains(key)
