"""Shared SQL mapping for every SQL-backed FilerStore.

Redesign of reference weed/filer/abstract_sql/abstract_sql_store.go:1
(there: one `filemeta` table keyed (dirhash, name, directory), shared by
mysql/mysql2/postgres/postgres2 via database/sql drivers). Here the same
idea — ALL entry/kv SQL lives in one class — with two bindings:

  * AbstractSqlStore: builds statements with `?` placeholders; a
    subclass supplies _exec/_query (e.g. sqlite3 bound parameters).
  * TextProtocolSqlStore: for stores that speak a database's wire
    protocol directly (MySQL COM_QUERY, PostgreSQL simple query) where
    statements travel as text — parameters are spliced as quoted SQL
    literals ('' doubling; the MySQL session is pinned to
    NO_BACKSLASH_ESCAPES so standard quoting is sound there too).

Schema (all dialects):
  entries (dir, name, meta TEXT-JSON, PRIMARY KEY (dir, name))
  kv      (k hex-text PRIMARY KEY, v hex-text)

kv cells are hex-encoded so no dialect needs binary literals.

The port's copy of seaweedfs_tpu/filer/abstract_sql.py, the same code;
the wire-protocol stores that build on TextProtocolSqlStore come with a
later slice. It imports nothing of that package.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Optional

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore


class AbstractSqlStore(FilerStore):
    name = "abstract_sql"

    # Generic DDL (sqlite): TEXT everywhere, BINARY collation gives
    # memcmp ordering. MySQL/Postgres override with types that keep
    # real servers inside index-size limits and bytewise ordering.
    DDL = (
        "CREATE TABLE IF NOT EXISTS entries ("
        "dir TEXT NOT NULL, name TEXT NOT NULL, "
        "meta TEXT NOT NULL, PRIMARY KEY (dir, name))",
        "CREATE TABLE IF NOT EXISTS kv ("
        "k TEXT NOT NULL, v TEXT, PRIMARY KEY (k))",
    )
    # sqlite and mysql share REPLACE INTO; postgres overrides with
    # INSERT ... ON CONFLICT (which sqlite >= 3.24 also accepts, so the
    # sqlite-backed mini servers can execute either dialect verbatim)
    UPSERT_ENTRY = ("REPLACE INTO entries (dir, name, meta) "
                    "VALUES (?, ?, ?)")
    UPSERT_KV = "REPLACE INTO kv (k, v) VALUES (?, ?)"

    # ---- subclass API ----
    def _exec(self, sql: str, params: tuple = ()) -> None:
        raise NotImplementedError

    def _query(self, sql: str, params: tuple = ()) -> list[tuple]:
        raise NotImplementedError

    def _init_tables(self) -> None:
        for ddl in self.DDL:
            self._exec(ddl)

    # ---- path helpers (same split as the reference's (dir, name)) ----
    @staticmethod
    def _split(full_path: str) -> tuple[str, str]:
        full_path = full_path.rstrip("/") or "/"
        if full_path == "/":
            return "", "/"
        d, _, n = full_path.rpartition("/")
        return d or "/", n

    @staticmethod
    def _like_escape(s: str) -> str:
        """Escape LIKE wildcards with '!' (ESCAPE '!' below) — paths
        may legally contain % and _."""
        return s.replace("!", "!!").replace("%", "!%").replace("_", "!_")

    # ---- entry ops ----
    def insert_entry(self, entry: Entry) -> None:
        import json
        d, n = self._split(entry.full_path)
        self._exec(self.UPSERT_ENTRY,
                   (d, n, json.dumps(entry.to_dict())))

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Optional[Entry]:
        import json
        d, n = self._split(full_path)
        rows = self._query(
            "SELECT meta FROM entries WHERE dir = ? AND name = ?", (d, n))
        return Entry.from_dict(json.loads(rows[0][0])) if rows else None

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        self._exec("DELETE FROM entries WHERE dir = ? AND name = ?",
                   (d, n))

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/")
        self._exec(
            "DELETE FROM entries WHERE dir = ? "
            "OR dir LIKE ? ESCAPE '!'",
            (base or "/", self._like_escape(base) + "/%"))

    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        import json
        d = dir_path.rstrip("/") or "/"
        cmp = ">=" if include_start else ">"
        rows = self._query(
            f"SELECT meta FROM entries WHERE dir = ? AND name {cmp} ? "
            "AND name LIKE ? ESCAPE '!' ORDER BY name LIMIT ?",
            (d, start_name, self._like_escape(prefix or "") + "%", limit))
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    # ---- kv ----
    # Cells are hex-encoded so no dialect needs binary literals; the
    # sqlite binding overrides the codec to keep raw-BLOB params
    # (backward compatible with older filer.db files).
    def _kv_enc(self, raw: bytes):
        return raw.hex()

    def _kv_dec(self, stored) -> bytes:
        return bytes.fromhex(stored)

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._exec(self.UPSERT_KV,
                   (self._kv_enc(key), self._kv_enc(value)))

    def kv_get(self, key: bytes) -> Optional[bytes]:
        rows = self._query("SELECT v FROM kv WHERE k = ?",
                           (self._kv_enc(key),))
        return self._kv_dec(rows[0][0]) if rows else None

    def kv_delete(self, key: bytes) -> None:
        self._exec("DELETE FROM kv WHERE k = ?", (self._kv_enc(key),))


class TextProtocolSqlStore(AbstractSqlStore):
    """SQL travels as literal text over a database wire protocol.

    Subclasses implement _run(sql) -> (affected_rows, rows). Parameter
    splice: our statements never contain '?' outside placeholder
    position, strings are quoted with '' doubling, ints pass bare."""

    def _run(self, sql: str) -> tuple[int, list[tuple]]:
        raise NotImplementedError

    @staticmethod
    def _literal(v) -> str:
        if isinstance(v, int):
            return str(v)
        return "'" + str(v).replace("'", "''") + "'"

    def _interpolate(self, sql: str, params: tuple) -> str:
        parts = sql.split("?")
        if len(parts) - 1 != len(params):
            raise ValueError(f"placeholder mismatch in {sql!r}")
        out = [parts[0]]
        for p, nxt in zip(params, parts[1:]):
            out.append(self._literal(p))
            out.append(nxt)
        return "".join(out)

    def _exec(self, sql: str, params: tuple = ()) -> None:
        self._run(self._interpolate(sql, params))

    def _query(self, sql: str, params: tuple = ()) -> list[tuple]:
        return self._run(self._interpolate(sql, params))[1]


class SqliteStore(AbstractSqlStore):
    """stdlib sqlite3 binding of the shared SQL mapping (reference
    weed/filer/sqlite/sqlite_store.go, itself a thin shell over
    abstract_sql — same relationship here)."""

    name = "sqlite"

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        self._init_tables()

    # kv cells stay raw BLOBs (sqlite binds bytes natively and
    # older filer.db files already hold them that way)
    def _kv_enc(self, raw: bytes):
        return raw

    def _kv_dec(self, stored) -> bytes:
        return bytes(stored)

    def _exec(self, sql: str, params: tuple = ()) -> None:
        with self._lock:
            self._conn.execute(sql, params)
            self._conn.commit()

    def _query(self, sql: str, params: tuple = ()) -> list[tuple]:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def close(self) -> None:
        self._conn.close()
