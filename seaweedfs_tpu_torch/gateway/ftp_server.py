"""FTP gateway over the filer.

The reference ships only an 81-line skeleton (weed/ftpd/ftp_server.go —
options struct + TODO). This is a small but WORKING control/data-channel
implementation of the same idea: an FTP front end whose file system is
the filer namespace, sharing the FilerServer's chunk plumbing the way
the S3 and WebDAV gateways do.

Supported verbs: USER/PASS (anonymous by default, or a fixed
user/password), SYST, FEAT, TYPE, NOOP, PWD, CWD, CDUP, PASV, EPSV,
LIST, NLST, SIZE, RETR, STOR, DELE, MKD, RMD, RNFR/RNTO, QUIT.
Passive mode only (each transfer opens a fresh ephemeral listener).

The port's copy of seaweedfs_tpu/gateway/ftp_server.py, the same code
with its imports pointed at the port; it imports nothing of that
package. It takes no device.
"""

from __future__ import annotations

import posixpath
import socket
import threading
import time
from typing import Optional

from seaweedfs_tpu_torch.filer.entry import Entry


class FtpServer:
    def __init__(self, filer_server, host: str = "127.0.0.1",
                 port: int = 0, user: str = "", password: str = ""):
        self.fs = filer_server  # a FilerServer (chunk IO + Filer)
        self.user = user
        self.password = password
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._stop = threading.Event()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="ftp-accept").start()

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
            threading.Thread(target=_FtpSession(self, conn).run,
                             daemon=True, name="ftp-session").start()


class _FtpSession:
    def __init__(self, server: FtpServer, conn: socket.socket):
        self.srv = server
        self.conn = conn
        self.cwd = "/"
        self.authed = False
        self.username = ""
        self._pasv: Optional[socket.socket] = None
        self._rnfr = ""

    # ---- plumbing ----
    def _send(self, code: int, text: str) -> None:
        self.conn.sendall(f"{code} {text}\r\n".encode())

    def _abs(self, arg: str) -> str:
        path = arg if arg.startswith("/") else \
            posixpath.join(self.cwd, arg)
        norm = posixpath.normpath(path)
        return norm if norm.startswith("/") else "/"

    def _open_data(self) -> Optional[socket.socket]:
        if self._pasv is None:
            self._send(425, "Use PASV first.")
            return None
        listener, self._pasv = self._pasv, None
        listener.settimeout(10)
        try:
            data, _ = listener.accept()
            return data
        except OSError:
            self._send(425, "Data connection failed.")
            return None
        finally:
            listener.close()

    # ---- session loop ----
    def run(self) -> None:
        try:
            self._send(220, "seaweedfs-tpu FTP ready")
            buf = b""
            while not self.srv._stop.is_set():
                while b"\r\n" not in buf:
                    chunk = self.conn.recv(4096)
                    if not chunk:
                        return
                    buf += chunk
                line, _, buf = buf.partition(b"\r\n")
                verb, _, arg = line.decode(errors="replace").partition(" ")
                verb = verb.upper()
                if verb == "QUIT":
                    self._send(221, "Bye.")
                    return
                handler = getattr(self, f"_cmd_{verb.lower()}", None)
                if handler is None:
                    self._send(502, f"{verb} not implemented.")
                    continue
                if not self.authed and verb not in ("USER", "PASS",
                                                    "SYST", "FEAT"):
                    self._send(530, "Log in first.")
                    continue
                try:
                    handler(arg)
                except Exception as e:
                    self._send(451, f"{type(e).__name__}: {e}")
        finally:
            try:
                self.conn.close()
            except OSError:
                pass

    # ---- auth / session ----
    def _cmd_user(self, arg: str) -> None:
        self.username = arg
        if self.srv.password:
            self._send(331, "Password required.")
        else:
            self.authed = True
            self._send(230, "Logged in (anonymous).")

    def _cmd_pass(self, arg: str) -> None:
        if self.srv.password and (
                self.username != self.srv.user
                or arg != self.srv.password):
            self._send(530, "Bad credentials.")
            return
        self.authed = True
        self._send(230, "Logged in.")

    def _cmd_syst(self, arg: str) -> None:
        self._send(215, "UNIX Type: L8")

    def _cmd_feat(self, arg: str) -> None:
        self.conn.sendall(b"211-Features:\r\n EPSV\r\n SIZE\r\n211 End\r\n")

    def _cmd_type(self, arg: str) -> None:
        self._send(200, f"Type set to {arg or 'I'}.")

    def _cmd_noop(self, arg: str) -> None:
        self._send(200, "OK.")

    # ---- navigation ----
    def _cmd_pwd(self, arg: str) -> None:
        self._send(257, f'"{self.cwd}" is the current directory')

    def _cmd_cwd(self, arg: str) -> None:
        path = self._abs(arg)
        entry = self.srv.fs.filer.find_entry(path)
        if entry is None or not entry.is_directory:
            self._send(550, "No such directory.")
            return
        self.cwd = path
        self._send(250, "Directory changed.")

    def _cmd_cdup(self, arg: str) -> None:
        self._cmd_cwd("..")

    # ---- passive data channel ----
    def _new_pasv(self) -> int:
        if self._pasv is not None:  # stale listener from a prior PASV
            try:
                self._pasv.close()
            except OSError:
                pass
        # bind where the control connection landed — self.srv.host may
        # be 0.0.0.0 or a hostname, neither of which clients can dial
        local_ip = self.conn.getsockname()[0]
        self._pasv = socket.create_server((local_ip, 0))
        return self._pasv.getsockname()[1]

    def _cmd_pasv(self, arg: str) -> None:
        port = self._new_pasv()
        h = self.conn.getsockname()[0].replace(".", ",")
        self._send(227, f"Entering Passive Mode ({h},{port >> 8},"
                        f"{port & 0xFF}).")

    def _cmd_epsv(self, arg: str) -> None:
        port = self._new_pasv()
        self._send(229, f"Entering Extended Passive Mode (|||{port}|)")

    # ---- listings ----
    def _list_lines(self, path: str, names_only: bool) -> list[str]:
        entries = self.srv.fs.filer.list_entries(path, limit=1 << 16)
        out = []
        for e in entries:
            if names_only:
                out.append(e.name)
                continue
            kind = "d" if e.is_directory else "-"
            mtime = time.strftime("%b %d %H:%M",
                                  time.localtime(e.attr.mtime or 0))
            out.append(f"{kind}rw-r--r-- 1 weed weed "
                       f"{e.file_size():>12} {mtime} {e.name}")
        return out

    def _cmd_list(self, arg: str) -> None:
        self._xfer_listing(arg, names_only=False)

    def _cmd_nlst(self, arg: str) -> None:
        self._xfer_listing(arg, names_only=True)

    def _xfer_listing(self, arg: str, names_only: bool) -> None:
        path = self._abs(arg or ".")
        data = self._open_data()
        if data is None:
            return
        self._send(150, "Here comes the directory listing.")
        try:
            lines = self._list_lines(path, names_only)
            data.sendall(("\r\n".join(lines) + "\r\n").encode()
                         if lines else b"")
        finally:
            data.close()
        self._send(226, "Directory send OK.")

    # ---- files ----
    def _cmd_size(self, arg: str) -> None:
        entry = self.srv.fs.filer.find_entry(self._abs(arg))
        if entry is None or entry.is_directory:
            self._send(550, "No such file.")
            return
        self._send(213, str(entry.file_size()))

    def _cmd_retr(self, arg: str) -> None:
        path = self._abs(arg)
        entry = self.srv.fs.filer.find_entry(path)
        if entry is None or entry.is_directory:
            self._send(550, "No such file.")
            return
        data = self._open_data()
        if data is None:
            return
        self._send(150, f"Opening data connection for {arg}.")
        try:
            data.sendall(self.srv.fs._read_entry_bytes(entry))
        finally:
            data.close()
        self._send(226, "Transfer complete.")

    def _cmd_stor(self, arg: str) -> None:
        path = self._abs(arg)
        data = self._open_data()
        if data is None:
            return
        self._send(150, "Ok to send data.")
        chunks = []
        while True:
            piece = data.recv(1 << 16)
            if not piece:
                break
            chunks.append(piece)
        data.close()
        body = b"".join(chunks)
        # store through the filer's normal write path (chunking, rules,
        # cipher) by synthesizing an internal request
        import urllib.parse

        from seaweedfs_tpu_torch.utils.httpd import http_call
        status, resp, _ = http_call(
            "POST",
            f"http://{self.srv.fs.url}{urllib.parse.quote(path)}",
            body=body)
        if status >= 400:
            self._send(550, f"Store failed: HTTP {status}")
            return
        self._send(226, f"Stored {len(body)} bytes.")

    def _cmd_dele(self, arg: str) -> None:
        try:
            self.srv.fs.filer.delete_entry(self._abs(arg))
            self._send(250, "Deleted.")
        except FileNotFoundError:
            self._send(550, "No such file.")

    def _cmd_mkd(self, arg: str) -> None:
        path = self._abs(arg)
        self.srv.fs.filer.mkdirs(path)
        self._send(257, f'"{path}" created.')

    def _cmd_rmd(self, arg: str) -> None:
        try:
            self.srv.fs.filer.delete_entry(self._abs(arg), recursive=False)
            self._send(250, "Removed.")
        except FileNotFoundError:
            self._send(550, "No such directory.")
        except OSError:
            self._send(550, "Directory not empty.")

    def _cmd_rnfr(self, arg: str) -> None:
        self._rnfr = self._abs(arg)
        self._send(350, "Ready for RNTO.")

    def _cmd_rnto(self, arg: str) -> None:
        if not self._rnfr:
            self._send(503, "RNFR first.")
            return
        try:
            self.srv.fs.filer.rename_entry(self._rnfr, self._abs(arg))
            self._send(250, "Renamed.")
        except FileNotFoundError:
            self._send(550, "No such file.")
        finally:
            self._rnfr = ""
