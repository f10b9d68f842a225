"""Embedded log-structured (LSM) filer store.

The reference ships LevelDB-family embedded stores (weed/filer/leveldb,
leveldb2, leveldb3 — `leveldb_store.go`) as its default durable metadata
backends. This is the same component over our from-scratch LSM engine
(`utils/lsm.py` — WAL + memtable + SSTables + compaction) instead of a
linked library. The key encoding makes one directory a contiguous key
range, mirroring the reference's `genKey(dirPath, fileName)` scheme
(weed/filer/leveldb/leveldb_store.go:103-110):

  entry:  b"E" + dir + b"\\x00" + name   -> entry JSON
  kv:     b"K" + user key                -> raw value

The port's copy of seaweedfs_tpu/filer/lsm_store.py, the same code: an
LSM directory written by either package opens in the other. It imports
nothing of that package.
"""

from __future__ import annotations

import json
from typing import Optional

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore
from seaweedfs_tpu_torch.utils.lsm import LsmKv


class LsmStore(FilerStore):
    name = "lsm"

    def __init__(self, path: str, **kv_opts):
        self.kv = LsmKv(path, **kv_opts)

    # ---- key encoding ----
    @staticmethod
    def _entry_key(full_path: str) -> bytes:
        full_path = full_path.rstrip("/") or "/"
        if full_path == "/":
            return b"E\x00/"
        d, _, n = full_path.rpartition("/")
        return b"E" + (d or "/").encode() + b"\x00" + n.encode()

    # ---- FilerStore SPI ----
    def insert_entry(self, entry: Entry) -> None:
        self.kv.put(self._entry_key(entry.full_path),
                    json.dumps(entry.to_dict()).encode())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Optional[Entry]:
        val = self.kv.get(self._entry_key(full_path))
        return Entry.from_dict(json.loads(val)) if val is not None else None

    def delete_entry(self, full_path: str) -> None:
        self.kv.put(self._entry_key(full_path), None)

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        lo = b"E" + base.encode() + b"\x00"
        hi = b"E" + base.encode() + b"\x01"
        for key, _ in self.kv.scan(lo, hi):
            self.kv.put(key, None)
        # grandchildren: any dir key beginning with "<base>/" (for the
        # root, every dir string starts with "/", so scan all of them)
        stem = b"" if base == "/" else base.encode()
        lo2 = b"E" + stem + b"/"
        hi2 = b"E" + stem + b"0"  # '0' = '/'+1
        for key, _ in self.kv.scan(lo2, hi2):
            self.kv.put(key, None)

    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        base = (dir_path.rstrip("/") or "/").encode()
        lo = b"E" + base + b"\x00" + (prefix or start_name or "").encode()
        if start_name and (not prefix or start_name > prefix):
            lo = b"E" + base + b"\x00" + start_name.encode()
        hi = b"E" + base + b"\x01"
        out: list[Entry] = []
        for key, val in self.kv.scan(lo, hi):
            name = key.split(b"\x00", 1)[1].decode()
            if prefix and not name.startswith(prefix):
                if name > prefix:
                    break
                continue
            if start_name:
                if name < start_name:
                    continue
                if name == start_name and not include_start:
                    continue
            out.append(Entry.from_dict(json.loads(val)))
            if len(out) >= limit:
                break
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.kv.put(b"K" + key, value)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self.kv.get(b"K" + key)

    def kv_delete(self, key: bytes) -> None:
        self.kv.put(b"K" + key, None)

    def close(self) -> None:
        self.kv.close()
