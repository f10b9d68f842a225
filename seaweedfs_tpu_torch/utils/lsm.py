"""Generic embedded LSM key-value engine (the port of
seaweedfs_tpu/utils/lsm.py).

The storage engine behind the disk-backed needle map
(storage/needle_map_disk.py) — the role the reference delegates to the
LevelDB library (weed/storage/needle_map_leveldb.go).
Structure: write-ahead log for the active memtable, sorted immutable
SSTable segments, size-tiered full compaction, point reads newest-first,
range scans as a merged view.

Record framing (WAL and SSTable share it):
  <key_len:u32 LE> <val_len:u32 LE | 0xFFFFFFFF = tombstone> <key> <val>
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
from typing import Iterator, Optional

_TOMB = 0xFFFFFFFF
_REC = struct.Struct("<II")  # key_len, val_len (or _TOMB)

MEMTABLE_FLUSH_KEYS = 4096
COMPACT_AT_SEGMENTS = 6


def _pack(key: bytes, val: Optional[bytes]) -> bytes:
    if val is None:
        return _REC.pack(len(key), _TOMB) + key
    return _REC.pack(len(key), len(val)) + key + val


def _iter_records(blob: bytes) -> Iterator[tuple[bytes, Optional[bytes]]]:
    for key, val, _end in _iter_records_pos(blob):
        yield key, val


def _iter_records_pos(blob: bytes
                      ) -> Iterator[tuple[bytes, Optional[bytes], int]]:
    """Yields (key, val, end_offset); stops before a torn tail record
    (crash mid-append) so replay can truncate at the last good byte."""
    pos, n = 0, len(blob)
    while pos + _REC.size <= n:
        klen, vlen = _REC.unpack_from(blob, pos)
        body = klen + (0 if vlen == _TOMB else vlen)
        if pos + _REC.size + body > n:
            break  # torn tail record — drop it
        pos += _REC.size
        key = blob[pos:pos + klen]
        pos += klen
        if vlen == _TOMB:
            yield key, None, pos
        else:
            yield key, blob[pos:pos + vlen], pos + vlen
            pos += vlen


class _SSTable:
    """Immutable sorted segment; full key index kept in memory (the
    segments hold metadata-scale records, so a sparse index buys
    nothing here)."""

    def __init__(self, path: str):
        self.path = path
        self.keys: list[bytes] = []
        self.vals: list[Optional[bytes]] = []
        with open(path, "rb") as f:
            blob = f.read()
        for key, val in _iter_records(blob):
            self.keys.append(key)
            self.vals.append(val)

    def get(self, key: bytes) -> tuple[bool, Optional[bytes]]:
        i = bisect.bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return True, self.vals[i]
        return False, None

    def scan(self, lo: bytes, hi: Optional[bytes]
             ) -> Iterator[tuple[bytes, Optional[bytes]]]:
        i = bisect.bisect_left(self.keys, lo)
        while i < len(self.keys) and (hi is None or self.keys[i] < hi):
            yield self.keys[i], self.vals[i]
            i += 1


class LsmKv:
    """The engine: open a directory, get/put/delete/scan bytes keys."""

    def __init__(self, path: str, fsync: bool = True,
                 flush_keys: int = MEMTABLE_FLUSH_KEYS,
                 compact_at: int = COMPACT_AT_SEGMENTS):
        self.dir = path
        self.fsync = fsync
        self.flush_keys = flush_keys
        self.compact_at = compact_at
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()
        self._mem: dict[bytes, Optional[bytes]] = {}
        self._mem_sorted: list[bytes] = []
        self._tables: list[_SSTable] = []  # oldest first
        self._next_seg = 0
        for name in sorted(os.listdir(path)):
            if name.endswith(".sst"):
                self._tables.append(_SSTable(os.path.join(path, name)))
                self._next_seg = max(self._next_seg,
                                     int(name.split(".")[0]) + 1)
        self._wal_path = os.path.join(path, "wal.log")
        self._replay_wal()
        self._wal = open(self._wal_path, "ab")

    # ---- WAL / memtable / segments ----
    def _replay_wal(self) -> None:
        try:
            with open(self._wal_path, "rb") as f:
                blob = f.read()
        except OSError:
            return
        good = 0
        for key, val, end in _iter_records_pos(blob):
            self._mem_put(key, val)
            good = end
        if good < len(blob):
            # cut the torn tail NOW: the WAL reopens in append mode, and
            # appending after torn bytes would let the dropped record
            # resurrect (half-merged with the new one) on a later replay
            with open(self._wal_path, "r+b") as f:
                f.truncate(good)

    def _mem_put(self, key: bytes, val: Optional[bytes]) -> None:
        if key not in self._mem:
            bisect.insort(self._mem_sorted, key)
        self._mem[key] = val

    def put(self, key: bytes, val: Optional[bytes]) -> None:
        """val=None writes a tombstone."""
        with self._lock:
            self._wal.write(_pack(key, val))
            self._wal.flush()
            if self.fsync:
                os.fsync(self._wal.fileno())
            self._mem_put(key, val)
            if len(self._mem) >= self.flush_keys:
                self._flush_memtable()

    def _flush_memtable(self) -> None:
        if not self._mem:
            return
        seg = os.path.join(self.dir, f"{self._next_seg:08d}.sst")
        self._next_seg += 1
        with open(seg + ".tmp", "wb") as f:
            for key in self._mem_sorted:
                f.write(_pack(key, self._mem[key]))
            f.flush()
            os.fsync(f.fileno())
        os.rename(seg + ".tmp", seg)
        self._tables.append(_SSTable(seg))
        self._mem.clear()
        self._mem_sorted.clear()
        self._wal.close()
        self._wal = open(self._wal_path, "wb")
        if len(self._tables) >= self.compact_at:
            self._compact()

    def _compact(self) -> None:
        """Merge every segment into one; newest value wins, tombstones
        dropped (nothing older than a full merge can resurrect)."""
        merged: dict[bytes, Optional[bytes]] = {}
        for table in self._tables:  # oldest -> newest
            for key, val in zip(table.keys, table.vals):
                merged[key] = val
        seg = os.path.join(self.dir, f"{self._next_seg:08d}.sst")
        self._next_seg += 1
        with open(seg + ".tmp", "wb") as f:
            for key in sorted(merged):
                if merged[key] is not None:
                    f.write(_pack(key, merged[key]))
            f.flush()
            os.fsync(f.fileno())
        os.rename(seg + ".tmp", seg)
        old = self._tables
        self._tables = [_SSTable(seg)]
        for t in old:
            try:
                os.remove(t.path)
            except OSError:
                pass

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            if key in self._mem:
                return self._mem[key]
            for table in reversed(self._tables):
                hit, val = table.get(key)
                if hit:
                    return val
        return None

    def scan(self, lo: bytes = b"",
             hi: Optional[bytes] = None) -> list[tuple[bytes, bytes]]:
        """Merged live view of [lo, hi) (hi=None -> unbounded): memtable
        shadows newer tables shadow older ones; tombstones omitted."""
        with self._lock:
            merged: dict[bytes, Optional[bytes]] = {}
            for table in self._tables:
                for key, val in table.scan(lo, hi):
                    merged[key] = val
            i = bisect.bisect_left(self._mem_sorted, lo)
            while i < len(self._mem_sorted) and (
                    hi is None or self._mem_sorted[i] < hi):
                key = self._mem_sorted[i]
                merged[key] = self._mem[key]
                i += 1
        return sorted((k, v) for k, v in merged.items() if v is not None)

    def __len__(self) -> int:
        """Live key count (scans everything; debugging/stats use)."""
        return len(self.scan())

    def close(self) -> None:
        with self._lock:
            self._flush_memtable()
            self._wal.close()
