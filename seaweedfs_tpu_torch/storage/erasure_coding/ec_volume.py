"""EC volume reads: .vif sidecar, sorted-index search, shard files.

The part of seaweedfs_tpu/storage/erasure_coding/ec_volume.py the EC path
needs (reference weed/storage/erasure_coding/ec_volume.go, ec_shard.go,
ec_volume_info.go): mount local shards, find a needle in the .ecx, map
its record to shard intervals and read them. Deletion (.ecj writes) is
not ported yet; the journal is read for the decoder.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterator, Optional

from seaweedfs_tpu_torch.models.coder import scheme_from_dict, scheme_to_dict
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.erasure_coding import layout


def read_volume_info(base_file_name: str) -> dict:
    """Parse the .vif sidecar ({"version": ..., "code": CodeSpec dict}).
    Empty dict when absent/corrupt — pre-CodeSpec volumes default to
    version 3 / RS(10,4)."""
    try:
        with open(base_file_name + ".vif", "r", encoding="utf-8") as f:
            info = json.load(f)
        return info if isinstance(info, dict) else {}
    except (OSError, ValueError):
        return {}


def write_volume_info(base_file_name: str, version: int, scheme) -> None:
    """Persist the .vif sidecar: version + the volume's CodeSpec (the same
    bytes seaweedfs_tpu writes)."""
    with open(base_file_name + ".vif", "w", encoding="utf-8") as f:
        json.dump({"version": version,
                   "code": scheme_to_dict(scheme)}, f)


class NotFoundError(Exception):
    pass


def search_needle_from_sorted_index(ecx_file, ecx_size: int,
                                    needle_id: int) -> tuple[int, int]:
    """Binary search a sorted 16-byte-entry index for needle_id. Returns
    (offset_units, size); raises NotFoundError
    (reference ec_volume.go:221-250 SearchNeedleFromSortedIndex)."""
    lo, hi = 0, ecx_size // t.NEEDLE_MAP_ENTRY_SIZE
    while lo < hi:
        mid = (lo + hi) // 2
        ecx_file.seek(mid * t.NEEDLE_MAP_ENTRY_SIZE)
        key, off, size = t.unpack_entry(
            ecx_file.read(t.NEEDLE_MAP_ENTRY_SIZE))
        if key == needle_id:
            return off, size
        if key < needle_id:
            lo = mid + 1
        else:
            hi = mid
    raise NotFoundError(f"needle {needle_id:x} not in ecx")


def iterate_ecj_file(base_file_name: str) -> Iterator[int]:
    """Yield needle ids from the deletion journal (8-byte big-endian each,
    reference ec_decoder.go iterateEcjFile)."""
    path = base_file_name + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            buf = f.read(t.NEEDLE_ID_SIZE)
            if len(buf) != t.NEEDLE_ID_SIZE:
                return
            yield int.from_bytes(buf, "big")


class EcVolumeShard:
    """One local .ecNN file (reference ec_shard.go:17-49)."""

    def __init__(self, directory: str, collection: str, volume_id: int,
                 shard_id: int):
        self.directory = directory
        self.collection = collection
        self.volume_id = volume_id
        self.shard_id = shard_id
        self.path = os.path.join(
            directory, f"{volume_id}{layout.shard_ext(shard_id)}")
        self._f = open(self.path, "rb")
        self.shard_size = os.path.getsize(self.path)
        self._lock = threading.Lock()

    def read_at(self, offset: int, length: int) -> bytes:
        with self._lock:
            self._f.seek(offset)
            return self._f.read(length)

    def close(self):
        self._f.close()


class EcVolume:
    """A mounted EC volume: local shards + .ecx index
    (reference ec_volume.go:25-76)."""

    def __init__(self, directory: str, collection: str, volume_id: int,
                 version: int = 3):
        self.directory = directory
        self.collection = collection
        self.volume_id = volume_id
        self.base_file_name = os.path.join(directory, str(volume_id))
        info = read_volume_info(self.base_file_name)
        self.version = int(info.get("version", version))
        # the volume's CodeSpec (RS(10,4) when the .vif predates CodeSpec
        # persistence) — every shard-count consumer below derives from it
        self.scheme = scheme_from_dict(info.get("code"))
        self.shards: dict[int, EcVolumeShard] = {}
        self._ecx_lock = threading.Lock()
        ecx = self.base_file_name + ".ecx"
        self.ecx_file = open(ecx, "rb") if os.path.exists(ecx) else None
        self.ecx_file_size = os.path.getsize(ecx) if self.ecx_file else 0

    @property
    def data_shards(self) -> int:
        return self.scheme.data_shards

    @property
    def total_shards(self) -> int:
        return self.scheme.total_shards

    def add_shard(self, shard: EcVolumeShard) -> bool:
        if shard.shard_id in self.shards:
            return False
        self.shards[shard.shard_id] = shard
        return True

    def shard_size(self) -> int:
        for s in self.shards.values():
            return s.shard_size
        return 0

    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """(offset_bytes, size); raises NotFoundError; tombstones surface as
        deleted size (reference ec_volume.go:205-250)."""
        if self.ecx_file is None:
            raise NotFoundError("no ecx file")
        with self._ecx_lock:
            off_units, size = search_needle_from_sorted_index(
                self.ecx_file, self.ecx_file_size, needle_id)
        return t.offset_to_actual(off_units), size

    def locate_needle(self, needle_id: int,
                      large_block: int = layout.LARGE_BLOCK_SIZE,
                      small_block: int = layout.SMALL_BLOCK_SIZE
                      ) -> tuple[list[layout.Interval], int, int]:
        """(intervals, offset, size) for the needle's whole on-disk record
        (reference ec_volume.go LocateEcShardNeedle)."""
        offset, size = self.find_needle_from_ecx(needle_id)
        if t.size_is_deleted(size):
            return [], offset, size
        record = t.get_actual_size(size, self.version)
        intervals = layout.locate_data(
            large_block, small_block,
            self.data_shards * self.shard_size(), offset, record,
            data_shards=self.data_shards)
        return intervals, offset, size

    def read_interval(self, interval: layout.Interval,
                      large_block: int = layout.LARGE_BLOCK_SIZE,
                      small_block: int = layout.SMALL_BLOCK_SIZE
                      ) -> tuple[Optional[bytes], int]:
        """Read one interval from a LOCAL shard. Returns (data, shard_id);
        data is None when the shard is not local (the caller goes remote or
        degraded, reference store_ec.go:188-218)."""
        shard_id, off = interval.to_shard_id_and_offset(
            large_block, small_block, self.data_shards)
        shard = self.shards.get(shard_id)
        if shard is None:
            return None, shard_id
        return shard.read_at(off, interval.size), shard_id

    def close(self):
        if self.ecx_file:
            self.ecx_file.close()
            self.ecx_file = None
        for s in self.shards.values():
            s.close()
        self.shards.clear()
