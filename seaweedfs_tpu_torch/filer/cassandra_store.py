"""Cassandra-protocol FilerStore: filer metadata over the CQL native
protocol (v4 framing) with no driver dependency.

Redesign of reference weed/filer/cassandra/cassandra_store.go — there
gocql with a `filemeta (directory, name, meta)` table, PRIMARY KEY
(directory, name) so a partition is one directory and the clustering
key gives sorted child listings; here the same data model spoken
directly: STARTUP/READY handshake, QUERY opcode with text literals
('' doubling — CQL strings escape exactly like SQL), RESULT rows
parsing. delete_folder_children walks directories recursively because
a partition key cannot be range-deleted (the reference store has the
same property; its filer core recurses too).

MiniCassandraServer speaks the same wire protocol with sqlite as the
executor (the emitted CQL shapes are SQL after a tiny textual
translation) — the test double AND an embedded dev backend.

The port's copy of seaweedfs_tpu/filer/cassandra_store.py. It imports nothing
of that package.
"""

from __future__ import annotations

import re
import socket
import sqlite3
import struct
import threading
from typing import Optional

from seaweedfs_tpu_torch.filer.abstract_sql import (AbstractSqlStore,
                                              TextProtocolSqlStore)
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore

VERSION_REQ = 0x04  # CQL native protocol v4
VERSION_RESP = 0x84
OP_ERROR, OP_STARTUP, OP_READY = 0x00, 0x01, 0x02
OP_AUTHENTICATE, OP_QUERY, OP_RESULT = 0x03, 0x07, 0x08
RESULT_VOID, RESULT_ROWS = 0x0001, 0x0002
CONSISTENCY_ONE = 0x0001


class CassandraError(RuntimeError):
    pass


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _long_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">i", len(b)) + b


class CqlClient:
    """Minimal CQL v4 client: STARTUP + QUERY with ONE consistency."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the connect timeout would otherwise persist as the I/O
        # timeout; make the per-op deadline explicit so an idle
        # keepalive connection isn't killed by the connect budget
        self.sock.settimeout(timeout)
        self._rfile = self.sock.makefile("rb")
        self._lock = threading.Lock()
        self._stream = 0
        body = (struct.pack(">H", 1)
                + _string("CQL_VERSION") + _string("3.0.0"))
        op, payload = self._request(OP_STARTUP, body)
        if op == OP_AUTHENTICATE:
            raise CassandraError(
                "server requires authentication; configure a "
                "passwordless listener for this store")
        if op != OP_READY:
            raise CassandraError(f"unexpected startup reply opcode {op}")

    def _request(self, opcode: int, body: bytes) -> tuple[int, bytes]:
        with self._lock:
            self._stream = (self._stream + 1) % 32768
            frame = struct.pack(">BBhBi", VERSION_REQ, 0, self._stream,
                                opcode, len(body)) + body
            self.sock.sendall(frame)
            hdr = self._rfile.read(9)
            if len(hdr) < 9:
                raise ConnectionError("cassandra connection closed")
            _, flags, _, op, length = struct.unpack(">BBhBi", hdr)
            payload = self._rfile.read(length) if length else b""
        payload = self._strip_flag_prefixes(flags, payload)
        if op == OP_ERROR:
            code = struct.unpack(">i", payload[:4])[0]
            n = struct.unpack(">H", payload[4:6])[0]
            raise CassandraError(
                f"cql error 0x{code:04x}: "
                f"{payload[6:6 + n].decode(errors='replace')}")
        return op, payload

    @staticmethod
    def _strip_flag_prefixes(flags: int, payload: bytes) -> bytes:
        """Real servers may prefix the body per the frame flags:
        tracing id (0x02), warnings string-list (0x08 — e.g. tombstone
        threshold warnings), custom-payload bytes-map (0x04). Skip them
        so the result body parses from offset 0."""
        pos = 0
        if flags & 0x02:
            pos += 16  # tracing UUID
        if flags & 0x08:
            n = struct.unpack_from(">H", payload, pos)[0]
            pos += 2
            for _ in range(n):
                ln = struct.unpack_from(">H", payload, pos)[0]
                pos += 2 + ln
        if flags & 0x04:
            n = struct.unpack_from(">H", payload, pos)[0]
            pos += 2
            for _ in range(n):
                ln = struct.unpack_from(">H", payload, pos)[0]
                pos += 2 + ln  # key
                vlen = struct.unpack_from(">i", payload, pos)[0]
                pos += 4 + max(0, vlen)
        return payload[pos:] if pos else payload

    def query(self, cql: str) -> list[tuple]:
        body = (_long_string(cql) + struct.pack(">H", CONSISTENCY_ONE)
                + b"\x00")  # no flags: no values, default page size
        op, payload = self._request(OP_QUERY, body)
        if op != OP_RESULT:
            raise CassandraError(f"unexpected reply opcode {op}")
        kind = struct.unpack(">i", payload[:4])[0]
        if kind != RESULT_ROWS:
            return []
        pos = 4
        flags, col_count = struct.unpack_from(">ii", payload, pos)
        pos += 8
        if flags & 0x0002:  # has_more_pages: paging state
            n = struct.unpack_from(">i", payload, pos)[0]
            pos += 4 + max(0, n)
        if flags & 0x0001:  # global tables spec: one ks/table pair
            for _ in range(2):
                n = struct.unpack_from(">H", payload, pos)[0]
                pos += 2 + n
        for _ in range(col_count):  # per-column specs
            if not flags & 0x0001:
                for _ in range(2):
                    n = struct.unpack_from(">H", payload, pos)[0]
                    pos += 2 + n
            n = struct.unpack_from(">H", payload, pos)[0]  # name
            pos += 2 + n
            t = struct.unpack_from(">H", payload, pos)[0]  # type id
            pos += 2
            if t == 0x0000:  # custom type: class string follows
                n = struct.unpack_from(">H", payload, pos)[0]
                pos += 2 + n
        rows_count = struct.unpack_from(">i", payload, pos)[0]
        pos += 4
        rows = []
        for _ in range(rows_count):
            row = []
            for _ in range(col_count):
                n = struct.unpack_from(">i", payload, pos)[0]
                pos += 4
                if n < 0:
                    row.append(None)
                else:
                    row.append(payload[pos:pos + n].decode())
                    pos += n
            rows.append(tuple(row))
        return rows

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class CassandraFilerStore(FilerStore):
    name = "cassandra"

    KEYSPACE = "seaweedfs"

    def __init__(self, host: str = "127.0.0.1", port: int = 9042,
                 keyspace: str = ""):
        self.client = CqlClient(host, port)
        self.ks = keyspace or self.KEYSPACE
        if not self.ks.replace("_", "").isalnum():
            raise ValueError(f"bad keyspace name {self.ks!r}")
        self.client.query(
            f"CREATE KEYSPACE IF NOT EXISTS {self.ks} WITH replication"
            " = {'class': 'SimpleStrategy', 'replication_factor': 1}")
        self.client.query(
            f"CREATE TABLE IF NOT EXISTS {self.ks}.filemeta ("
            "directory text, name text, meta text, "
            "PRIMARY KEY (directory, name))")
        self.client.query(
            f"CREATE TABLE IF NOT EXISTS {self.ks}.kv ("
            "k text PRIMARY KEY, v text)")

    # one copy of the (dir, name) split and '' quoting conventions for
    # every SQL-shaped store (abstract_sql owns them)
    _split = staticmethod(AbstractSqlStore._split)
    _lit = staticmethod(TextProtocolSqlStore._literal)

    def insert_entry(self, entry: Entry) -> None:
        import json
        d, n = self._split(entry.full_path)
        self.client.query(  # CQL INSERT is an upsert
            f"INSERT INTO {self.ks}.filemeta (directory, name, meta) "
            f"VALUES ({self._lit(d)}, {self._lit(n)}, "
            f"{self._lit(json.dumps(entry.to_dict()))})")

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Optional[Entry]:
        import json
        d, n = self._split(full_path)
        rows = self.client.query(
            f"SELECT meta FROM {self.ks}.filemeta WHERE directory = "
            f"{self._lit(d)} AND name = {self._lit(n)}")
        return Entry.from_dict(json.loads(rows[0][0])) if rows else None

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        self.client.query(
            f"DELETE FROM {self.ks}.filemeta WHERE directory = "
            f"{self._lit(d)} AND name = {self._lit(n)}")

    def delete_folder_children(self, full_path: str) -> None:
        # a partition key cannot be range-scanned, so descend the tree
        # (paginated — a one-shot LIMIT would orphan descendants of
        # huge directories): one partition delete per directory, which
        # the recursion's own tail performs for each subdirectory
        # (reference cassandra store deletes per-directory partitions
        # the same way)
        base = full_path.rstrip("/") or "/"
        last = ""
        while True:
            batch = self.list_directory_entries(base, start_name=last,
                                                limit=1024)
            if not batch:
                break
            for e in batch:
                if e.is_directory:
                    child = (f"{base}/{e.name}" if base != "/"
                             else f"/{e.name}")
                    self.delete_folder_children(child)
            last = batch[-1].name
        self.client.query(
            f"DELETE FROM {self.ks}.filemeta WHERE directory = "
            f"{self._lit(base)}")

    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        import json
        d = dir_path.rstrip("/") or "/"
        conds = [f"directory = {self._lit(d)}"]
        # single merged lower bound: Cassandra rejects two restrictions
        # on one clustering column
        lo, incl = "", True
        if start_name:
            lo, incl = start_name, include_start
        if prefix and prefix > lo:
            lo, incl = prefix, True
        if lo:
            conds.append(f"name {'>=' if incl else '>'} {self._lit(lo)}")
        # ORDER BY name ASC is the (default) clustering order — stated
        # explicitly so the sqlite-backed mini server is held to the
        # same guarantee real Cassandra gives
        rows = self.client.query(
            f"SELECT name, meta FROM {self.ks}.filemeta WHERE "
            + " AND ".join(conds)
            + f" ORDER BY name ASC LIMIT {int(limit)}")
        out = []
        for name, meta in rows:
            if prefix and not name.startswith(prefix):
                if name >= prefix:
                    break  # sorted: past the contiguous prefix range
                continue
            out.append(Entry.from_dict(json.loads(meta)))
        return out

    # ---- kv ----
    def kv_put(self, key: bytes, value: bytes) -> None:
        self.client.query(
            f"INSERT INTO {self.ks}.kv (k, v) VALUES "
            f"('{key.hex()}', '{value.hex()}')")

    def kv_get(self, key: bytes) -> Optional[bytes]:
        rows = self.client.query(
            f"SELECT v FROM {self.ks}.kv WHERE k = '{key.hex()}'")
        return bytes.fromhex(rows[0][0]) if rows else None

    def kv_delete(self, key: bytes) -> None:
        self.client.query(
            f"DELETE FROM {self.ks}.kv WHERE k = '{key.hex()}'")

    def close(self) -> None:
        self.client.close()


# ------------------------------------------------------------ dev server

class MiniCassandraServer:
    """In-process CQL-wire server executing received statements with
    sqlite (the store's CQL shapes are SQL after stripping the keyspace
    qualifier and CREATE KEYSPACE/WITH clauses). One thread per
    connection, one shared database."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._db = sqlite3.connect(":memory:", check_same_thread=False)
        self._dblock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="cassandra-accept")

    def start(self) -> "MiniCassandraServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="cassandra-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        f = conn.makefile("rb")

        def send(stream: int, opcode: int, body: bytes) -> None:
            conn.sendall(struct.pack(">BBhBi", VERSION_RESP, 0, stream,
                                     opcode, len(body)) + body)

        try:
            while not self._stop.is_set():
                hdr = f.read(9)
                if len(hdr) < 9:
                    return
                _, _, stream, op, length = struct.unpack(">BBhBi", hdr)
                payload = f.read(length) if length else b""
                if op == OP_STARTUP:
                    send(stream, OP_READY, b"")
                    continue
                if op != OP_QUERY:
                    send(stream, OP_ERROR, struct.pack(">i", 0x000A)
                         + _string("unsupported opcode"))
                    continue
                n = struct.unpack(">i", payload[:4])[0]
                cql = payload[4:4 + n].decode()
                try:
                    send(stream, OP_RESULT, self._execute(cql))
                except Exception as e:
                    send(stream, OP_ERROR, struct.pack(">i", 0x2200)
                         + _string(str(e)[:300]))
        except (OSError, ValueError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _execute(self, cql: str) -> bytes:
        sql = cql.strip().rstrip(";")
        up = sql.upper()
        if up.startswith("CREATE KEYSPACE"):
            return struct.pack(">i", RESULT_VOID)
        # strip the keyspace qualifier — ONLY at the table-name
        # position (after FROM/INTO/EXISTS) and only OUTSIDE string
        # literals, where "backup.kv" / "from x.filemeta"-shaped entry
        # names legally occur — then translate the CQL-isms the store
        # emits into sqlite SQL. Literals ('' escaping) are split out
        # first so the rewrite can never touch data.
        segments = re.split(r"('(?:[^']|'')*')", sql)
        sql = "".join(
            seg if i % 2 else re.sub(
                r"(?i)\b(FROM|INTO|EXISTS)\s+"
                r"[A-Za-z_][A-Za-z_0-9]*\.(filemeta|kv)\b",
                r"\1 \2", seg)
            for i, seg in enumerate(segments))
        if up.startswith("INSERT INTO"):
            sql = "INSERT OR REPLACE INTO" + sql[len("INSERT INTO"):]
        with self._dblock:
            cur = self._db.execute(sql)
            rows = cur.fetchall() if cur.description else None
            names = ([d[0] for d in cur.description]
                     if cur.description else [])
            self._db.commit()
        if rows is None:
            return struct.pack(">i", RESULT_VOID)
        # RESULT Rows with the global-tables-spec flag
        body = bytearray(struct.pack(">i", RESULT_ROWS))
        body += struct.pack(">ii", 0x0001, len(names))
        body += _string("seaweedfs") + _string("filemeta")
        for name in names:
            body += _string(name) + struct.pack(">H", 0x000D)  # varchar
        body += struct.pack(">i", len(rows))
        for row in rows:
            for v in row:
                if v is None:
                    body += struct.pack(">i", -1)
                else:
                    vb = str(v).encode()
                    body += struct.pack(">i", len(vb)) + vb
        return bytes(body)
