"""Volume: append-only needle log (.dat) + index log (.idx).

The part of seaweedfs_tpu/storage/volume.py the EC path needs (reference
weed/storage/volume.go, volume_write.go, volume_read.go,
volume_loading.go): create or load a volume, append needles, read them
back, sync and close. The .dat begins with an 8-byte superblock; every
write appends a padded needle record to .dat and a 16-byte entry to .idx,
byte-identical to the JAX package's files. Backends, tiering, the ldb and
sorted needle maps, deletion and compaction are not ported yet.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from seaweedfs_tpu_torch.storage import idx as idxmod
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import CURRENT_VERSION, Needle
from seaweedfs_tpu_torch.storage.needle_map import CompactMap
from seaweedfs_tpu_torch.storage.super_block import (TTL, ReplicaPlacement,
                                                     SuperBlock)


class NotFoundError(Exception):
    pass


class DeletedError(Exception):
    pass


class CookieMismatchError(Exception):
    pass


class Volume:
    # superblock `extra` marker for wide-offset volumes (the reference
    # fixes offset width at compile time via the 5BytesOffset build tag,
    # offset_5bytes.go:15; it is recorded per volume so both widths coexist)
    _WIDE_OFFSET_MARKER = b"5BO"

    def __init__(self, directory: str, collection: str, volume_id: int,
                 replica_placement: Optional[ReplicaPlacement] = None,
                 ttl: Optional[TTL] = None, version: int = CURRENT_VERSION,
                 offset_bytes: int = 4):
        self.directory = directory
        self.collection = collection
        self.id = volume_id
        self.offset_bytes = offset_bytes
        self._lock = threading.RLock()
        self.last_append_at_ns = 0
        base = self.file_name()
        if os.path.exists(base + ".dat"):
            self._load()
            return
        if offset_bytes not in (4, 5):
            raise ValueError(f"offset_bytes must be 4 or 5, got {offset_bytes}")
        self.super_block = SuperBlock(
            version=version,
            replica_placement=replica_placement or ReplicaPlacement(),
            ttl=ttl or TTL(),
            extra=(self._WIDE_OFFSET_MARKER if offset_bytes == 5 else b""))
        self._dat = open(base + ".dat", "w+b")
        self._dat.write(self.super_block.to_bytes())
        self._dat.flush()
        self._idx = open(base + ".idx", "a+b")
        self.nm = CompactMap()

    # ---- naming ----
    def file_name(self) -> str:
        name = str(self.id) if not self.collection else \
            f"{self.collection}_{self.id}"
        return os.path.join(self.directory, name)

    @property
    def version(self) -> int:
        return self.super_block.version

    # ---- load ----
    def _load(self):
        base = self.file_name()
        self._dat = open(base + ".dat", "r+b")
        self.super_block = SuperBlock.parse(
            self._dat.read(super_block_probe_len()))
        # the superblock marker is authoritative for offset width — a
        # caller-supplied width that disagrees would mis-stride the .idx
        self.offset_bytes = (5 if self.super_block.extra
                             == self._WIDE_OFFSET_MARKER else 4)
        self._idx = open(base + ".idx", "a+b")
        self.nm = CompactMap()

        def visit(key, off, size):
            if off != 0 and size != t.TOMBSTONE_FILE_SIZE:
                self.nm.set(key, off, size)
                self.nm.file_count += 1
            elif self.nm.delete(key):
                self.nm.deleted_count += 1
        idxmod.walk_index_file(base + ".idx", visit,
                               offset_bytes=self.offset_bytes)

    # ---- write ----
    def write_needle(self, n: Needle) -> int:
        """Append; returns stored size (reference volume_write.go:109-162).
        Both appends are flushed to the OS before returning, so they
        survive the death of this process."""
        with self._lock:
            if not n.append_at_ns:
                n.append_at_ns = time.time_ns()
            self._dat.seek(0, os.SEEK_END)
            offset = self._dat.tell()
            if offset % t.NEEDLE_PADDING_SIZE != 0:
                offset += (-offset) % t.NEEDLE_PADDING_SIZE
                self._dat.seek(offset)
            if offset >= t.max_volume_size(self.offset_bytes):
                raise IOError(f"volume {self.id} exceeds max size")
            self._dat.write(n.to_bytes(self.version))
            self.last_append_at_ns = n.append_at_ns
            off_units = t.actual_to_offset(offset)
            self.nm.set(n.id, off_units, n.size)
            self._idx.write(t.pack_entry(n.id, off_units, n.size,
                                         self.offset_bytes))
            self._dat.flush()
            self._idx.flush()
        return n.size

    # ---- read ----
    def read_needle(self, needle_id: int, cookie: Optional[int] = None,
                    check_crc: bool = True) -> Needle:
        with self._lock:
            nv = self.nm.get(needle_id)
            if nv is None:
                raise NotFoundError(f"needle {needle_id:x} not found")
            off_units, size = nv
            if not t.size_is_valid(size):
                raise DeletedError(f"needle {needle_id:x} deleted")
            self._dat.seek(t.offset_to_actual(off_units))
            blob = self._dat.read(t.get_actual_size(size, self.version))
        n = Needle.from_bytes(blob, size, self.version, check_crc)
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatchError(
                f"cookie mismatch for needle {needle_id:x}")
        return n

    def file_count(self) -> int:
        return len(self.nm)

    def sync(self) -> None:
        with self._lock:
            self._dat.flush()
            os.fsync(self._dat.fileno())
            self._idx.flush()
            os.fsync(self._idx.fileno())

    def close(self) -> None:
        with self._lock:
            try:
                self._dat.flush()
                self._idx.flush()
            finally:
                self._dat.close()
                self._idx.close()


def super_block_probe_len() -> int:
    return 8 + 65536  # superblock + max extra
