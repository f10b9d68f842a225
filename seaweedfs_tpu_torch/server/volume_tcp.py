"""Raw TCP data path for the volume server.

Functional equivalent of reference
weed/server/volume_server_tcp_handlers_write.go (enabled by
`weed benchmark -useTcp` / the volume server's TCP listener): a
persistent connection that skips HTTP parsing entirely for the
hot write/read path. Framing (all big-endian):

  request:  op(1: W/R/D) fid_len(u16) fid body_len(u32) body
  response: status(1: 0=ok) body_len(u32) body

The write path goes through Store.write_volume_needle like the HTTP
handler, but without headers, query parsing, or JWT (the TCP port is an
internal/benchmark surface, like the reference's).

The port's copy of seaweedfs_tpu/server/volume_tcp.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import (CookieMismatchError, DeletedError,
                                          NotFoundError)

_HDR = struct.Struct(">BH")
_LEN = struct.Struct(">I")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


class TcpDataServer:
    """Accept loop + per-connection request loop over a Store."""

    def __init__(self, store, host: str = "127.0.0.1", port: int = 0):
        self.store = store
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="volume-tcp-accept")
        self._thread.start()

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
                             daemon=True,
                             name="volume-tcp-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                head = _recv_exact(conn, _HDR.size)
                op, fid_len = _HDR.unpack(head)
                fid = _recv_exact(conn, fid_len).decode()
                body_len = _LEN.unpack(_recv_exact(conn, _LEN.size))[0]
                body = _recv_exact(conn, body_len) if body_len else b""
                status, payload = self._dispatch(chr(op), fid, body)
                conn.sendall(bytes([status]) + _LEN.pack(len(payload))
                             + payload)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, op: str, fid: str, body: bytes
                  ) -> tuple[int, bytes]:
        try:
            f = FileId.parse(fid)
            vid, key, cookie = f.volume_id, f.key, f.cookie
        except (ValueError, IndexError):
            return 1, b"bad fid"
        try:
            if op == "W":
                n = Needle(id=key, cookie=cookie, data=body)
                n.set_flags_from_fields()
                self.store.write_volume_needle(vid, n)
                return 0, b""
            if op == "R":
                n = self.store.read_volume_needle(vid, key, cookie)
                return 0, n.data
            if op == "D":
                self.store.delete_volume_needle(vid, key, cookie)
                return 0, b""
        except (NotFoundError, DeletedError) as e:
            return 2, str(e).encode()
        except CookieMismatchError as e:
            return 3, str(e).encode()
        except Exception as e:  # keep the connection alive on errors
            return 1, f"{type(e).__name__}: {e}".encode()
        return 1, b"unknown op"


class TcpClient:
    """Persistent-connection client (benchmark -useTcp side)."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def _roundtrip(self, op: str, fid: str, body: bytes = b""
                   ) -> tuple[int, bytes]:
        f = fid.encode()
        with self._lock:
            self._sock.sendall(_HDR.pack(ord(op), len(f)) + f
                               + _LEN.pack(len(body)) + body)
            status = _recv_exact(self._sock, 1)[0]
            plen = _LEN.unpack(_recv_exact(self._sock, _LEN.size))[0]
            payload = _recv_exact(self._sock, plen) if plen else b""
        return status, payload

    def write(self, fid: str, data: bytes) -> None:
        status, payload = self._roundtrip("W", fid, data)
        if status != 0:
            raise IOError(f"tcp write {fid}: {payload.decode()}")

    def read(self, fid: str) -> bytes:
        status, payload = self._roundtrip("R", fid)
        if status != 0:
            raise IOError(f"tcp read {fid}: {payload.decode()}")
        return payload

    def delete(self, fid: str) -> None:
        status, payload = self._roundtrip("D", fid)
        if status != 0:
            raise IOError(f"tcp delete {fid}: {payload.decode()}")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
