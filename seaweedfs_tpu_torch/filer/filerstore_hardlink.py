"""Hard-link resolution wrapper around any FilerStore.

Functional equivalent of reference weed/filer/filerstore_hardlink.go: an
entry whose hard_link_id is set keeps its real metadata (attr + chunks +
a link counter) in the store's KV space under "hardlink/<id>"; the
directory rows are thin pointers. Finding or listing resolves the shared
metadata; unlinking decrements the counter and only reports the chunks
as garbage once the last name is gone.

The port's copy of seaweedfs_tpu/filer/filerstore_hardlink.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import json
import threading
import uuid
from typing import Callable, Optional

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore

HARDLINK_PREFIX = b"hardlink/"


def new_hard_link_id() -> str:
    return uuid.uuid4().hex


class HardLinkStore(FilerStore):
    """Delegating wrapper; entry rows with hard_link_id are pointers into
    the shared KV metadata record."""

    def __init__(self, inner: FilerStore):
        self.inner = inner
        self.name = inner.name
        self._lock = threading.RLock()
        # post-mutation hook: called with the entry path after every
        # write-side op (None means "everything changed"). Lets the
        # filer's entry cache stay coherent even when callers mutate
        # through filer.store directly instead of the Filer API.
        self.invalidate_fn: Optional[Callable[[Optional[str]], None]] = None

    def _invalidate(self, full_path: Optional[str]) -> None:
        fn = self.invalidate_fn
        if fn is not None:
            fn(full_path)

    # ---- shared metadata record ----
    def _meta_key(self, link_id: str) -> bytes:
        return HARDLINK_PREFIX + link_id.encode()

    def _load_meta(self, link_id: str) -> Optional[dict]:
        blob = self.inner.kv_get(self._meta_key(link_id))
        return json.loads(blob) if blob else None

    def _save_meta(self, link_id: str, meta: dict) -> None:
        self.inner.kv_put(self._meta_key(link_id),
                          json.dumps(meta).encode())

    def link_count(self, link_id: str) -> int:
        meta = self._load_meta(link_id)
        return meta["counter"] if meta else 0

    def _resolve(self, entry: Entry) -> Entry:
        """Non-mutating: returns a fresh Entry carrying the shared
        metadata (stores may hand back aliased objects)."""
        if not entry.hard_link_id:
            return entry
        meta = self._load_meta(entry.hard_link_id)
        if meta is None:
            return entry
        shared = Entry.from_dict(meta["entry"])
        shared.full_path = entry.full_path
        shared.hard_link_id = entry.hard_link_id
        return shared

    def _strip(self, entry: Entry) -> Entry:
        thin = Entry(full_path=entry.full_path, attr=entry.attr,
                     hard_link_id=entry.hard_link_id)
        thin.chunks = []
        return thin

    # ---- entry ops ----
    def insert_entry(self, entry: Entry, count_link: bool = True) -> None:
        if entry.hard_link_id:
            with self._lock:
                meta = self._load_meta(entry.hard_link_id)
                counter = meta["counter"] if meta else 0
                existing = self.inner.find_entry(entry.full_path)
                if count_link and not (
                        existing is not None
                        and existing.hard_link_id == entry.hard_link_id):
                    counter += 1
                self._save_meta(entry.hard_link_id, {
                    "counter": counter,
                    "entry": entry.to_dict(),
                })
                self.inner.insert_entry(self._strip(entry))
            self._invalidate(entry.full_path)
            return
        self.inner.insert_entry(entry)
        self._invalidate(entry.full_path)

    def update_entry(self, entry: Entry) -> None:
        if entry.hard_link_id:
            with self._lock:
                meta = self._load_meta(entry.hard_link_id) or {"counter": 1}
                meta["entry"] = entry.to_dict()
                self._save_meta(entry.hard_link_id, meta)
                self.inner.update_entry(self._strip(entry))
            self._invalidate(entry.full_path)
            return
        self.inner.update_entry(entry)
        self._invalidate(entry.full_path)

    def find_entry(self, full_path: str) -> Optional[Entry]:
        entry = self.inner.find_entry(full_path)
        return self._resolve(entry) if entry is not None else None

    def delete_entry(self, full_path: str) -> None:
        self.inner.delete_entry(full_path)
        self._invalidate(full_path)

    def unlink(self, link_id: str) -> int:
        """Decrement the link counter; returns the remaining count.
        At zero the shared record is removed (caller GCs the chunks)."""
        with self._lock:
            meta = self._load_meta(link_id)
            if meta is None:
                return 0
            meta["counter"] -= 1
            if meta["counter"] <= 0:
                self.inner.kv_delete(self._meta_key(link_id))
                return 0
            self._save_meta(link_id, meta)
            return meta["counter"]

    def delete_folder_children(self, full_path: str) -> None:
        self.inner.delete_folder_children(full_path)
        self._invalidate(None)

    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        return [self._resolve(e) for e in self.inner.list_directory_entries(
            dir_path, start_name, include_start, limit, prefix)]

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.inner.kv_put(key, value)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self.inner.kv_get(key)

    def kv_delete(self, key: bytes) -> None:
        self.inner.kv_delete(key)

    def close(self) -> None:
        self.inner.close()
