"""DiskLocation: one data directory holding volumes and EC shards
(the port of seaweedfs_tpu/storage/disk_location.py; reference
weed/storage/disk_location.go:22-38, disk_location_ec.go)."""

from __future__ import annotations

import os
import re
import threading
from typing import Optional

from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import (
    EcVolume, EcVolumeShard)
from seaweedfs_tpu_torch.storage.volume import Volume

_DAT_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.dat$")
_EC_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.ec(?P<shard>\d{2})$")


class DiskLocation:
    def __init__(self, directory: str, max_volume_count: int = 8,
                 disk_type: str = "hdd", needle_map_kind: str = "memory",
                 fsync: bool = False):
        self.needle_map_kind = needle_map_kind
        self.fsync = fsync
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_volume_count = max_volume_count
        self.disk_type = disk_type
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        self._lock = threading.RLock()

    # ---- scanning ----
    def load_existing_volumes(self) -> None:
        with self._lock:
            for name in sorted(os.listdir(self.directory)):
                m = _DAT_RE.match(name)
                if not m and name.endswith(".vif"):
                    # cloud-tiered volume: no local .dat, .vif records
                    # the remote tier (reference volume_tier.go)
                    m = _DAT_RE.match(name[:-4] + ".dat")
                    if m:
                        from seaweedfs_tpu_torch.storage.backend import \
                            load_volume_info
                        base_path = os.path.join(self.directory, name[:-4])
                        if os.path.exists(base_path + ".dat") or \
                                "remote" not in load_volume_info(base_path):
                            m = None  # not tiered (or .dat scan handles it)
                if m:
                    vid = int(m.group("vid"))
                    col = m.group("col") or ""
                    base = os.path.join(self.directory,
                                        f"{col}_{vid}" if col else str(vid))
                    if not os.path.exists(base + ".idx"):
                        continue
                    if vid not in self.volumes:
                        self.volumes[vid] = Volume(
                            self.directory, col, vid,
                            needle_map_kind=self.needle_map_kind,
                            fsync=self.fsync)
            self.load_all_ec_shards()

    def load_all_ec_shards(self) -> None:
        """Scan .ecNN + .ecx files and mount found shards
        (reference disk_location_ec.go:118 loadAllEcShards)."""
        found: dict[int, tuple[str, list[int]]] = {}
        for name in sorted(os.listdir(self.directory)):
            m = _EC_RE.match(name)
            if not m:
                continue
            vid = int(m.group("vid"))
            col = m.group("col") or ""
            found.setdefault(vid, (col, []))[1].append(int(m.group("shard")))
        for vid, (col, shards) in found.items():
            base = os.path.join(self.directory,
                                f"{col}_{vid}" if col else str(vid))
            if not os.path.exists(base + ".ecx"):
                continue
            for sid in shards:
                self.load_ec_shard(col, vid, sid)

    # ---- volumes ----
    def add_volume(self, vol: Volume) -> None:
        with self._lock:
            self.volumes[vol.id] = vol

    def find_volume(self, vid: int) -> Optional[Volume]:
        return self.volumes.get(vid)

    def delete_volume(self, vid: int) -> bool:
        with self._lock:
            v = self.volumes.pop(vid, None)
            if v is None:
                return False
            v.destroy()
            return True

    def volumes_len(self) -> int:
        return len(self.volumes)

    # ---- ec shards ----
    def load_ec_shard(self, collection: str, vid: int, shard_id: int) -> bool:
        with self._lock:
            ev = self.ec_volumes.get(vid)
            if ev is None:
                ev = EcVolume(self.directory, collection, vid)
                self.ec_volumes[vid] = ev
            shard = EcVolumeShard(self.directory, collection, vid, shard_id)
            return ev.add_shard(shard)

    def unload_ec_shard(self, vid: int, shard_id: int) -> bool:
        with self._lock:
            ev = self.ec_volumes.get(vid)
            if ev is None:
                return False
            shard = ev.delete_shard(shard_id)
            if shard is not None:
                shard.close()
            if not ev.shards:
                ev.close()
                del self.ec_volumes[vid]
            return shard is not None

    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        return self.ec_volumes.get(vid)

    def destroy_ec_volume(self, vid: int) -> None:
        with self._lock:
            ev = self.ec_volumes.pop(vid, None)
            if ev is not None:
                ev.destroy()

    def close(self) -> None:
        with self._lock:
            for v in self.volumes.values():
                v.close()
            for ev in self.ec_volumes.values():
                ev.close()
            self.volumes.clear()
            self.ec_volumes.clear()
