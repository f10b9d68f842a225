"""MySQL-protocol FilerStore: the shared abstract_sql mapping carried
over the MySQL client/server wire protocol with no driver dependency.

Redesign of reference weed/filer/mysql/mysql_store.go +
weed/filer/abstract_sql/abstract_sql_store.go — there a database/sql
driver talks to MySQL; here a dependency-free client performs the v10
handshake (mysql_native_password scramble included) and ships the
statements via COM_QUERY text resultsets, so the same bytes flow
against a stock MySQL/MariaDB server.

MiniMysqlServer is an in-process server speaking the same wire protocol
with sqlite as the executor — the test double AND an embedded dev
backend (the statement dialect the store emits is accepted by both).

The port's copy of seaweedfs_tpu/filer/mysql_store.py. It imports nothing
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

CLIENT_LONG_PASSWORD = 0x1
CLIENT_PROTOCOL_41 = 0x200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000


def _lenenc_int(data: bytes, pos: int) -> tuple[int, int]:
    b = data[pos]
    if b < 0xfb:
        return b, pos + 1
    if b == 0xfc:
        return int.from_bytes(data[pos + 1:pos + 3], "little"), pos + 3
    if b == 0xfd:
        return int.from_bytes(data[pos + 1:pos + 4], "little"), pos + 4
    if b == 0xfe:
        return int.from_bytes(data[pos + 1:pos + 9], "little"), pos + 9
    raise ValueError(f"bad length-encoded int 0x{b:02x}")


def _lenenc_bytes(v: bytes) -> bytes:
    n = len(v)
    if n < 251:
        return bytes([n]) + v
    if n < 1 << 16:
        return b"\xfc" + n.to_bytes(2, "little") + v
    if n < 1 << 24:
        return b"\xfd" + n.to_bytes(3, "little") + v
    return b"\xfe" + n.to_bytes(8, "little") + v


def _native_scramble(password: str, nonce: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(nonce + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(nonce + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


class MysqlError(RuntimeError):
    pass


class MysqlClient:
    """Minimal text-protocol client: handshake + COM_QUERY/COM_PING."""

    def __init__(self, host: str, port: int, user: str = "root",
                 password: str = "", database: str = "",
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the connect timeout would otherwise persist as the I/O
        # timeout; make the per-op deadline explicit so an idle
        # keepalive connection isn't killed by the connect budget
        self.sock.settimeout(timeout)
        self._rfile = self.sock.makefile("rb")
        self._lock = threading.Lock()
        self._seq = 0
        self._handshake(user, password, database)

    # ---- packet framing (3-byte length + sequence id) ----
    def _read_packet(self) -> bytes:
        hdr = self._rfile.read(4)
        if len(hdr) < 4:
            raise ConnectionError("mysql connection closed")
        n = int.from_bytes(hdr[:3], "little")
        self._seq = (hdr[3] + 1) & 0xff
        payload = self._rfile.read(n)
        if len(payload) < n:
            raise ConnectionError("short mysql packet")
        return payload

    def _send_packet(self, payload: bytes) -> None:
        self.sock.sendall(len(payload).to_bytes(3, "little")
                          + bytes([self._seq]) + payload)
        self._seq = (self._seq + 1) & 0xff

    # ---- connection phase ----
    def _handshake(self, user: str, password: str, database: str) -> None:
        greeting = self._read_packet()
        if greeting[:1] == b"\xff":
            raise MysqlError(self._parse_err(greeting))
        if greeting[0] != 10:
            raise MysqlError(f"unsupported protocol {greeting[0]}")
        pos = greeting.index(b"\0", 1) + 1  # server version
        pos += 4  # thread id
        nonce = greeting[pos:pos + 8]
        pos += 8 + 1 + 2 + 1 + 2 + 2  # filler, cap-lo, charset, status, cap-hi
        auth_len = greeting[pos]
        pos += 1 + 10
        # part 2: documented as max(13, auth_len - 8), NUL-padded
        part2 = greeting[pos:pos + max(13, auth_len - 8)]
        nonce = (nonce + part2).rstrip(b"\0")[:20]

        caps = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41
                | CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION
                | CLIENT_PLUGIN_AUTH)
        if database:
            caps |= 0x8  # CLIENT_CONNECT_WITH_DB
        auth = _native_scramble(password, nonce)
        payload = (struct.pack("<IIB", caps, 1 << 24, 33) + b"\0" * 23
                   + user.encode() + b"\0"
                   + bytes([len(auth)]) + auth
                   + (database.encode() + b"\0" if database else b"")
                   + b"mysql_native_password\0")
        self._send_packet(payload)
        reply = self._read_packet()
        if reply[:1] == b"\xfe" and len(reply) > 1:
            # AuthSwitchRequest: plugin name NUL, fresh nonce
            p = reply.index(b"\0", 1)
            plugin = reply[1:p].decode()
            if plugin != "mysql_native_password":
                raise MysqlError(
                    f"server requires auth plugin {plugin!r}; only "
                    "mysql_native_password is supported — create the "
                    "account WITH mysql_native_password")
            fresh = reply[p + 1:].rstrip(b"\0")[:20]
            self._send_packet(_native_scramble(password, fresh))
            reply = self._read_packet()
        if reply[:1] == b"\xff":
            raise MysqlError(self._parse_err(reply))
        # 0x00 OK expected. Append (not replace — wiping the default
        # would drop STRICT_TRANS_TABLES and let long values truncate
        # silently) the mode that makes '' the only string escape, so
        # TextProtocolSqlStore literals are sound.
        self.query("SET SESSION sql_mode = "
                   "CONCAT(@@sql_mode, ',NO_BACKSLASH_ESCAPES')")

    @staticmethod
    def _parse_err(pkt: bytes) -> str:
        code = int.from_bytes(pkt[1:3], "little")
        msg = pkt[3:]
        if msg[:1] == b"#":
            msg = msg[6:]
        return f"mysql error {code}: {msg.decode(errors='replace')}"

    # ---- command phase ----
    def query(self, sql: str) -> tuple[int, list[tuple]]:
        """COM_QUERY. Returns (affected_rows, rows); rows hold str/None
        (text resultset)."""
        with self._lock:
            self._seq = 0
            self._send_packet(b"\x03" + sql.encode())
            pkt = self._read_packet()
            if pkt[:1] == b"\xff":
                raise MysqlError(self._parse_err(pkt))
            if pkt[:1] == b"\x00":
                affected, _ = _lenenc_int(pkt, 1)
                return affected, []
            ncols, _ = _lenenc_int(pkt, 0)
            for _ in range(ncols):
                self._read_packet()  # column definitions: unused
            self._read_packet()  # EOF after columns
            rows: list[tuple] = []
            while True:
                pkt = self._read_packet()
                if pkt[:1] == b"\xfe" and len(pkt) < 9:
                    return 0, rows
                if pkt[:1] == b"\xff":
                    raise MysqlError(self._parse_err(pkt))
                row, pos = [], 0
                for _ in range(ncols):
                    if pkt[pos] == 0xfb:  # NULL
                        row.append(None)
                        pos += 1
                    else:
                        n, pos = _lenenc_int(pkt, pos)
                        row.append(pkt[pos:pos + n].decode())
                        pos += n
                rows.append(tuple(row))

    def close(self) -> None:
        try:
            with self._lock:
                self._seq = 0
                self._send_packet(b"\x01")  # COM_QUIT
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class MysqlFilerStore(TextProtocolSqlStore):
    name = "mysql"

    # VARBINARY keeps comparisons bytewise (the reference declares
    # `name` BINARY too) and the composite PK at 1024 bytes, inside
    # InnoDB's 3072-byte index cap; MEDIUMTEXT because entry meta with
    # many chunks overflows MySQL's 64KB TEXT. Paths/kv keys cap at
    # 512 bytes per segment on strict servers.
    DDL = (
        "CREATE TABLE IF NOT EXISTS entries ("
        "dir VARBINARY(512) NOT NULL, name VARBINARY(512) NOT NULL, "
        "meta MEDIUMTEXT NOT NULL, PRIMARY KEY (dir, name))",
        "CREATE TABLE IF NOT EXISTS kv ("
        "k VARBINARY(512) NOT NULL, v MEDIUMTEXT, PRIMARY KEY (k))",
    )

    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 user: str = "root", password: str = "",
                 database: str = "seaweedfs"):
        self.client = MysqlClient(host, port, user=user,
                                  password=password)
        if database:
            # bootstrap rather than CONNECT_WITH_DB so a fresh server
            # works out of the box (identifier allowlist, not quoting)
            if not database.replace("_", "").isalnum():
                raise ValueError(f"bad database name {database!r}")
            self.client.query(f"CREATE DATABASE IF NOT EXISTS {database}")
            self.client.query(f"USE {database}")
        self._init_tables()

    def _run(self, sql: str) -> tuple[int, list[tuple]]:
        return self.client.query(sql)

    def close(self) -> None:
        self.client.close()


# ------------------------------------------------------------ dev server

class MiniMysqlServer:
    """In-process MySQL-wire server executing received SQL with sqlite
    (the dialect the store emits is accepted by both engines). Accepts
    any credentials via mysql_native_password; per-connection thread,
    one shared database."""

    NONCE = b"0123456789abcdefghij"  # 20 bytes, fixed

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
                                        name="mysql-accept")

    def start(self) -> "MiniMysqlServer":
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
                             daemon=True, name="mysql-conn").start()

    # ---- per-connection protocol ----
    def _serve_conn(self, conn: socket.socket) -> None:
        f = conn.makefile("rb")
        seq = [0]

        def send(payload: bytes) -> None:
            conn.sendall(len(payload).to_bytes(3, "little")
                         + bytes([seq[0]]) + payload)
            seq[0] = (seq[0] + 1) & 0xff

        def recv() -> Optional[bytes]:
            hdr = f.read(4)
            if len(hdr) < 4:
                return None
            seq[0] = (hdr[3] + 1) & 0xff
            return f.read(int.from_bytes(hdr[:3], "little"))

        try:
            # HandshakeV10
            caps = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41
                    | CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION
                    | CLIENT_PLUGIN_AUTH)
            send(b"\x0a" + b"8.0.0-mini\0" + struct.pack("<I", 1)
                 + self.NONCE[:8] + b"\0"
                 + struct.pack("<HBHH", caps & 0xffff, 33, 2,
                               (caps >> 16) & 0xffff)
                 + bytes([len(self.NONCE) + 1]) + b"\0" * 10
                 + self.NONCE[8:] + b"\0"
                 + b"mysql_native_password\0")
            if recv() is None:  # HandshakeResponse41: accept anyone
                return
            send(b"\x00\x00\x00\x02\x00\x00\x00")  # OK
            while not self._stop.is_set():
                seq[0] = 1  # responses continue the command's seq 0
                pkt = recv()
                if pkt is None or pkt[:1] == b"\x01":  # EOF / COM_QUIT
                    return
                if pkt[:1] == b"\x0e":  # COM_PING
                    send(b"\x00\x00\x00\x02\x00\x00\x00")
                    continue
                if pkt[:1] != b"\x03":  # only COM_QUERY beyond here
                    send(self._err(1047, "unsupported command"))
                    continue
                sql = pkt[1:].decode()
                try:
                    self._execute(sql, send)
                except Exception as e:
                    send(self._err(1064, str(e)))
        except (OSError, ValueError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _execute(self, sql: str, send) -> None:
        stripped = sql.strip().rstrip(";").strip()
        upper = stripped.upper()
        if (not stripped
                or upper.startswith(("SET ", "SET@", "CREATE DATABASE",
                                     "USE "))):
            # session/database statements: fine on real MySQL,
            # meaningless for the single sqlite executor here
            send(b"\x00\x00\x00\x02\x00\x00\x00")
            return
        if upper.startswith("CREATE TABLE"):
            # MySQL column types → sqlite-safe ones. sqlite's affinity
            # for VARBINARY is NUMERIC, which would coerce digit-only
            # names to integers and break comparisons — declare TEXT.
            import re
            stripped = re.sub(r"VARBINARY\(\d+\)", "TEXT", stripped)
            stripped = stripped.replace("MEDIUMTEXT", "TEXT")
        with self._dblock:
            cur = self._db.execute(stripped)
            rows = cur.fetchall() if cur.description else None
            ncols = len(cur.description) if cur.description else 0
            names = ([d[0] for d in cur.description]
                     if cur.description else [])
            affected = cur.rowcount if cur.rowcount > 0 else 0
            self._db.commit()
        if rows is None:
            # OK: affected (lenenc, always < 251 here), last_insert_id,
            # status, warnings
            send(b"\x00" + bytes([min(affected, 250)]) + b"\x00"
                 + b"\x02\x00\x00\x00")
            return
        send(bytes([ncols]))  # column count (always < 251)
        for name in names:
            nb = name.encode()
            send(_lenenc_bytes(b"def") + _lenenc_bytes(b"")
                 + _lenenc_bytes(b"entries") + _lenenc_bytes(b"entries")
                 + _lenenc_bytes(nb) + _lenenc_bytes(nb)
                 + b"\x0c" + struct.pack("<HIBHB", 33, 1024, 0xfd, 0, 0)
                 + b"\x00\x00")
        send(b"\xfe\x00\x00\x02\x00")  # EOF after columns
        for row in rows:
            buf = bytearray()
            for v in row:
                if v is None:
                    buf += b"\xfb"
                else:
                    buf += _lenenc_bytes(str(v).encode())
            send(bytes(buf))
        send(b"\xfe\x00\x00\x02\x00")  # EOF after rows

    @staticmethod
    def _err(code: int, msg: str) -> bytes:
        return (b"\xff" + code.to_bytes(2, "little") + b"#42000"
                + msg.encode()[:400])
