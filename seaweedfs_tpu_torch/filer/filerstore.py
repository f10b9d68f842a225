"""FilerStore SPI + the store registry + MemoryStore.

Functional equivalent of reference weed/filer/filerstore.go:21-44 plus
the plugin table weed/command/imports.go:17-36. Ten store families
register in STORES below: embedded (memory here; sqlite and the shared
SQL mapping in abstract_sql.py; lsm_store.py) and wire-protocol
(redis_store.py RESP2, etcd_store.py gRPC, mysql_store.py,
postgres_store.py, mongodb_store.py OP_MSG, cassandra_store.py CQL,
elastic_store.py REST). New stores implement the same five entry ops +
kv + listing.

The port's copy of seaweedfs_tpu/filer/filerstore.py, with every family
of the reference's registry. It imports nothing of that package.
"""

from __future__ import annotations

import abc
import bisect
import threading
from typing import Optional

from seaweedfs_tpu_torch.filer.entry import Entry


class FilerStore(abc.ABC):
    name = "abstract"

    @abc.abstractmethod
    def insert_entry(self, entry: Entry) -> None: ...

    @abc.abstractmethod
    def update_entry(self, entry: Entry) -> None: ...

    @abc.abstractmethod
    def find_entry(self, full_path: str) -> Optional[Entry]: ...

    @abc.abstractmethod
    def delete_entry(self, full_path: str) -> None: ...

    @abc.abstractmethod
    def delete_folder_children(self, full_path: str) -> None: ...

    @abc.abstractmethod
    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]: ...

    # kv store used for filer.conf etc (reference KvPut/KvGet)
    @abc.abstractmethod
    def kv_put(self, key: bytes, value: bytes) -> None: ...

    @abc.abstractmethod
    def kv_get(self, key: bytes) -> Optional[bytes]: ...

    @abc.abstractmethod
    def kv_delete(self, key: bytes) -> None:
        """Remove the key. b"" is a legitimate stored value, not a
        deletion marker — every backend deletes for real."""

    def close(self) -> None:
        pass


class MemoryStore(FilerStore):
    name = "memory"

    def __init__(self):
        self._entries: dict[str, Entry] = {}
        self._sorted: list[str] = []
        self._kv: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry) -> None:
        # store by value (like every durable store, which serializes) so
        # callers mutating returned entries can't corrupt the store
        with self._lock:
            if entry.full_path not in self._entries:
                bisect.insort(self._sorted, entry.full_path)
            self._entries[entry.full_path] = Entry.from_dict(entry.to_dict())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Optional[Entry]:
        e = self._entries.get(full_path)
        return Entry.from_dict(e.to_dict()) if e is not None else None

    def delete_entry(self, full_path: str) -> None:
        with self._lock:
            if full_path in self._entries:
                del self._entries[full_path]
                i = bisect.bisect_left(self._sorted, full_path)
                if i < len(self._sorted) and self._sorted[i] == full_path:
                    self._sorted.pop(i)

    def delete_folder_children(self, full_path: str) -> None:
        prefix = full_path.rstrip("/") + "/"
        with self._lock:
            # the folder's own entry survives (for root, "/" itself
            # matches the "/" prefix and must be excluded)
            doomed = [p for p in self._sorted
                      if p.startswith(prefix) and p != full_path]
            for p in doomed:
                self.delete_entry(p)

    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        base = dir_path.rstrip("/") or ""
        out = []
        with self._lock:
            lo = bisect.bisect_right(self._sorted, base + "/")
            for p in self._sorted[lo:]:
                if not p.startswith(base + "/"):
                    break
                name = p[len(base) + 1:]
                if "/" in name:
                    continue  # deeper level
                if prefix and not name.startswith(prefix):
                    continue
                if start_name:
                    if name < start_name:
                        continue
                    if name == start_name and not include_start:
                        continue
                out.append(Entry.from_dict(self._entries[p].to_dict()))
                if len(out) >= limit:
                    break
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._kv[key] = value

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self._kv.get(key)

    def kv_delete(self, key: bytes) -> None:
        self._kv.pop(key, None)


def _lazy(module: str, cls: str):
    """Import-on-first-use factory so optional store backends (each a
    wire-protocol client) don't load until requested."""
    def factory(**kwargs):
        import importlib
        return getattr(importlib.import_module(module), cls)(**kwargs)
    factory.__name__ = cls
    return factory


# The store registry — the analogue of the reference's blank-import
# plugin table (weed/command/imports.go:17-36). Ten families:
# embedded (memory, sqlite, lsm) and wire-protocol (redis RESP2,
# etcd gRPC, mysql, postgres, mongodb OP_MSG, cassandra CQL,
# elasticsearch REST), plus
# the remote-filer adapter used by gateway mode.
STORES = {
    "memory": MemoryStore,
    "sqlite": _lazy("seaweedfs_tpu_torch.filer.abstract_sql", "SqliteStore"),
    "lsm": _lazy("seaweedfs_tpu_torch.filer.lsm_store", "LsmStore"),
    "redis": _lazy("seaweedfs_tpu_torch.filer.redis_store",
                   "RedisFilerStore"),
    "etcd": _lazy("seaweedfs_tpu_torch.filer.etcd_store", "EtcdFilerStore"),
    "mysql": _lazy("seaweedfs_tpu_torch.filer.mysql_store",
                   "MysqlFilerStore"),
    "postgres": _lazy("seaweedfs_tpu_torch.filer.postgres_store",
                      "PostgresFilerStore"),
    "mongodb": _lazy("seaweedfs_tpu_torch.filer.mongodb_store",
                     "MongoFilerStore"),
    "cassandra": _lazy("seaweedfs_tpu_torch.filer.cassandra_store",
                       "CassandraFilerStore"),
    "elastic": _lazy("seaweedfs_tpu_torch.filer.elastic_store",
                     "ElasticFilerStore"),
    "remote": _lazy("seaweedfs_tpu_torch.filer.remote_store",
                    "RemoteFilerStore"),
}
_ALIASES = {"mongo": "mongodb", "postgres2": "postgres",
            "mysql2": "mysql", "redis2": "redis",
            "cassandra2": "cassandra", "elastic7": "elastic"}


def __getattr__(name):
    # SqliteStore lives in abstract_sql (it subclasses the shared SQL
    # mapping, which itself imports FilerStore from this module); the
    # lazy re-export keeps `from filerstore import SqliteStore` working
    # without a circular module-level import.
    if name == "SqliteStore":
        from seaweedfs_tpu_torch.filer.abstract_sql import SqliteStore
        return SqliteStore
    raise AttributeError(name)


def make_store(name: str, **kwargs) -> FilerStore:
    return STORES[_ALIASES.get(name, name)](**kwargs)
