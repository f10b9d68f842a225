"""PostgreSQL-protocol FilerStore: the shared abstract_sql mapping over
the PostgreSQL v3 wire protocol, no driver dependency.

Redesign of reference weed/filer/postgres/postgres_store.go +
weed/filer/abstract_sql/abstract_sql_store.go — there lib/pq under
database/sql; here a dependency-free client performs the startup/auth
exchange (trust, cleartext and md5 password methods) and ships
statements through the simple-query protocol ('Q'), so the same bytes
flow against a stock PostgreSQL.

MiniPostgresServer speaks the same wire protocol with sqlite as the
executor (the emitted dialect — INSERT ... ON CONFLICT DO UPDATE,
LIKE ... ESCAPE — is accepted by both engines).

The port's copy of seaweedfs_tpu/filer/postgres_store.py. It imports nothing
of that package.
"""

from __future__ import annotations

import hashlib
import socket
import sqlite3
import struct
import threading
from typing import Optional

from seaweedfs_tpu_torch.filer.abstract_sql import TextProtocolSqlStore

PROTOCOL_V3 = 196608  # 3.0
SSL_REQUEST = 80877103


class PostgresError(RuntimeError):
    pass


class PostgresClient:
    """Minimal v3 simple-query client."""

    def __init__(self, host: str, port: int, user: str = "postgres",
                 password: str = "", database: str = "postgres",
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the connect timeout would otherwise persist as the I/O
        # timeout; make the per-op deadline explicit so an idle
        # keepalive connection isn't killed by the connect budget
        self.sock.settimeout(timeout)
        self._rfile = self.sock.makefile("rb")
        self._lock = threading.Lock()
        self._startup(user, password, database)

    # ---- framing ----
    def _read_msg(self) -> tuple[bytes, bytes]:
        t = self._rfile.read(1)
        if not t:
            raise ConnectionError("postgres connection closed")
        n = struct.unpack(">I", self._rfile.read(4))[0]
        return t, self._rfile.read(n - 4)

    def _send(self, type_byte: bytes, body: bytes) -> None:
        self.sock.sendall(type_byte + struct.pack(">I", len(body) + 4)
                          + body)

    # ---- startup / auth ----
    def _startup(self, user: str, password: str, database: str) -> None:
        params = (b"user\0" + user.encode() + b"\0"
                  + b"database\0" + database.encode() + b"\0\0")
        body = struct.pack(">I", PROTOCOL_V3) + params
        self.sock.sendall(struct.pack(">I", len(body) + 4) + body)
        while True:
            t, payload = self._read_msg()
            if t == b"E":
                raise PostgresError(self._parse_error(payload))
            if t == b"R":
                method = struct.unpack(">I", payload[:4])[0]
                if method == 0:
                    continue  # AuthenticationOk
                if method == 3:  # cleartext
                    self._send(b"p", password.encode() + b"\0")
                    continue
                if method == 5:  # md5(md5(password + user) + salt)
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        password.encode() + user.encode()).hexdigest()
                    digest = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._send(b"p", b"md5" + digest.encode() + b"\0")
                    continue
                raise PostgresError(f"unsupported auth method {method}")
            if t == b"Z":  # ReadyForQuery
                return
            # 'S' ParameterStatus, 'K' BackendKeyData, 'N' notice: skip

    @staticmethod
    def _parse_error(payload: bytes) -> str:
        fields = {}
        for part in payload.split(b"\0"):
            if part:
                fields[chr(part[0])] = part[1:].decode(errors="replace")
        return fields.get("M", payload.decode(errors="replace"))

    # ---- simple query ----
    def query(self, sql: str) -> tuple[int, list[tuple]]:
        with self._lock:
            self._send(b"Q", sql.encode() + b"\0")
            rows: list[tuple] = []
            affected = 0
            error: Optional[str] = None
            while True:
                t, payload = self._read_msg()
                if t == b"T":
                    pass  # RowDescription: names/types unused
                elif t == b"D":
                    ncols = struct.unpack(">H", payload[:2])[0]
                    pos, row = 2, []
                    for _ in range(ncols):
                        n = struct.unpack(">i", payload[pos:pos + 4])[0]
                        pos += 4
                        if n < 0:
                            row.append(None)
                        else:
                            row.append(payload[pos:pos + n].decode())
                            pos += n
                    rows.append(tuple(row))
                elif t == b"C":  # CommandComplete: "DELETE 3" etc
                    tag = payload.rstrip(b"\0").split()
                    if tag and tag[-1].isdigit():
                        affected = int(tag[-1])
                elif t == b"E":
                    error = self._parse_error(payload)
                elif t == b"Z":
                    if error:
                        raise PostgresError(error)
                    return affected, rows
                # 'N' NoticeResponse, 'I' EmptyQueryResponse: skip

    def close(self) -> None:
        try:
            self._send(b"X", b"")  # Terminate
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class PostgresFilerStore(TextProtocolSqlStore):
    name = "postgres"

    # COLLATE "C" pins ORDER BY/range comparisons to bytewise order on
    # real servers whose database locale would otherwise dictate e.g.
    # en_US collation (breaking listing pagination); the mini server
    # strips the clause for sqlite, whose default BINARY collation is
    # already memcmp.
    DDL = (
        "CREATE TABLE IF NOT EXISTS entries ("
        'dir TEXT COLLATE "C" NOT NULL, '
        'name TEXT COLLATE "C" NOT NULL, '
        "meta TEXT NOT NULL, PRIMARY KEY (dir, name))",
        "CREATE TABLE IF NOT EXISTS kv ("
        'k TEXT COLLATE "C" NOT NULL, v TEXT, PRIMARY KEY (k))',
    )
    # postgres has no REPLACE INTO; sqlite >= 3.24 accepts this exact
    # upsert syntax too, which keeps the mini server a pure pass-through
    UPSERT_ENTRY = ("INSERT INTO entries (dir, name, meta) "
                    "VALUES (?, ?, ?) ON CONFLICT (dir, name) "
                    "DO UPDATE SET meta = EXCLUDED.meta")
    UPSERT_KV = ("INSERT INTO kv (k, v) VALUES (?, ?) "
                 "ON CONFLICT (k) DO UPDATE SET v = EXCLUDED.v")

    def __init__(self, host: str = "127.0.0.1", port: int = 5432,
                 user: str = "postgres", password: str = "",
                 database: str = "postgres"):
        self.client = PostgresClient(host, port, user=user,
                                     password=password, database=database)
        self._init_tables()

    def _run(self, sql: str) -> tuple[int, list[tuple]]:
        return self.client.query(sql)

    def close(self) -> None:
        self.client.close()


# ------------------------------------------------------------ dev server

class MiniPostgresServer:
    """In-process PostgreSQL-wire server executing received SQL with
    sqlite. Trust auth (AuthenticationOk immediately); one shared
    database, per-connection thread."""

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
                                        name="postgres-accept")

    def start(self) -> "MiniPostgresServer":
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
            # a reply is several small writes: without TCP_NODELAY the
            # second one waits out the client's delayed ACK (~40 ms a
            # query), as a real server's sockets do not
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="postgres-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        f = conn.makefile("rb")

        def send(t: bytes, body: bytes) -> None:
            conn.sendall(t + struct.pack(">I", len(body) + 4) + body)

        try:
            # startup (possibly preceded by an SSLRequest)
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    return
                n = struct.unpack(">I", hdr)[0]
                body = f.read(n - 4)
                proto = struct.unpack(">I", body[:4])[0]
                if proto == SSL_REQUEST:
                    conn.sendall(b"N")  # no TLS; client retries plain
                    continue
                break
            send(b"R", struct.pack(">I", 0))  # AuthenticationOk
            send(b"S", b"server_version\0 14.0-mini\0")
            send(b"Z", b"I")
            while not self._stop.is_set():
                t = f.read(1)
                if not t or t == b"X":
                    return
                n = struct.unpack(">I", f.read(4))[0]
                payload = f.read(n - 4)
                if t != b"Q":
                    send(b"E", b"SERROR\0C0A000\0Munsupported message\0\0")
                    send(b"Z", b"I")
                    continue
                sql = payload.rstrip(b"\0").decode()
                try:
                    self._execute(sql, send)
                except Exception as e:
                    send(b"E", b"SERROR\0C42601\0M"
                         + str(e).encode()[:400] + b"\0\0")
                send(b"Z", b"I")
        except (OSError, ValueError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _execute(self, sql: str, send) -> None:
        stripped = sql.strip().rstrip(";").strip()
        if not stripped or stripped.upper().startswith("SET "):
            send(b"C", b"SET\0")
            return
        if stripped.upper().startswith("CREATE TABLE"):
            # sqlite rejects postgres' COLLATE "C"; its default BINARY
            # collation is already bytewise, so just strip the clause
            stripped = stripped.replace(' COLLATE "C"', "")
        with self._dblock:
            cur = self._db.execute(stripped)
            rows = cur.fetchall() if cur.description else None
            names = ([d[0] for d in cur.description]
                     if cur.description else [])
            affected = cur.rowcount if cur.rowcount > 0 else 0
            self._db.commit()
        if rows is None:
            verb = stripped.split(None, 1)[0].upper()
            send(b"C", f"{verb} {affected}\0".encode())
            return
        desc = bytearray(struct.pack(">H", len(names)))
        for name in names:
            desc += name.encode() + b"\0"
            # table oid, attr no, type oid (25=text), len, mod, format
            desc += struct.pack(">IHIhIH", 0, 0, 25, -1, 0, 0)
        send(b"T", bytes(desc))
        for row in rows:
            body = bytearray(struct.pack(">H", len(row)))
            for v in row:
                if v is None:
                    body += struct.pack(">i", -1)
                else:
                    vb = str(v).encode()
                    body += struct.pack(">I", len(vb)) + vb
            send(b"D", bytes(body))
        send(b"C", f"SELECT {len(rows)}\0".encode())
