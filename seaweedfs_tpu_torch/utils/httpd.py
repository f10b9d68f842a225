"""Minimal selector-core HTTP/JSON server + client helpers.

The control plane speaks HTTP/JSON end to end (the reference speaks
gRPC + HTTP; we keep one wire format for the whole plane — long-lived
streams become periodic POSTs / long-polls). Data paths (uploads, shard
copy) use raw bodies with query params.

Serving model (reference: Go's netpoller + goroutine-per-request, here
selectors + a bounded worker pool): ONE selector thread owns the
listener and every parked keep-alive socket; a connection costs a
thread only while a request is actually being served. Ready sockets are
handed to a bounded, demand-grown worker pool, so 10k mostly-idle
connections hold 10k fds but ~0 threads. Ambient context (Deadline,
QoS class, trace span, RED observation) is entered per DISPATCHED
REQUEST inside ``_dispatch`` — never per connection — so a parked
socket holds no scope and a worker thread never leaks one request's
scope into the next.

The port's copy of seaweedfs_tpu/utils/httpd.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import re
import select
import selectors
import socket
import stat
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Optional

from seaweedfs_tpu_torch.qos import classes as qos_classes
from seaweedfs_tpu_torch.utils import (clockctl, glog, profiler, resilience,
                                 tracing)

# route-family derivation for the RED histogram: a closed, low-
# cardinality set so (server, route_family, class, status_family)
# never explodes. Needle fids ("/3,0101f2") collapse to one family;
# anything not in the control-plane set is user namespace ("fs" —
# filer paths, S3 objects, DAV trees).
_NEEDLE_RE = re.compile(r"^/\d+,")
_CONTROL_FAMILIES = frozenset((
    "dir", "vol", "col", "cluster", "admin", "metrics", "status",
    "debug", "ui", "heartbeat", "raft", "scrub", "ec", "delete",
    "batch"))


def route_family(path: str) -> str:
    if not path or path == "/":
        return "root"
    if _NEEDLE_RE.match(path):
        return "needle"
    seg = path.split("/", 2)[1]
    if seg == "__api":
        return "api"
    if seg in _CONTROL_FAMILIES:
        return seg
    return "fs"


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler, match: re.Match,
                 body: Optional[bytes] = None, stream=None):
        self.handler = handler
        self.method = handler.command
        parsed = urllib.parse.urlparse(handler.path)
        # percent-decode like every mainstream HTTP server: a client
        # PUTting /a%20b and one GETting "/a b" name the same resource.
        # raw_path keeps the wire form (SigV4 canonical URIs sign it).
        self.path = urllib.parse.unquote(parsed.path)
        self.raw_path = parsed.path
        self.query = {k: v[0] for k, v in
                      urllib.parse.parse_qs(
                          parsed.query, keep_blank_values=True).items()}
        self.match = match
        self._body = body
        # incremental body reader (BodyStream). Handlers that consume
        # it chunk-at-a-time (filer streaming ingest) never pay
        # whole-body memory; handlers that touch .body instead get the
        # old buffered semantics lazily.
        self.stream = stream
        self.headers = handler.headers

    @property
    def body(self) -> bytes:
        if self._body is None:
            self._body = (self.stream.readall()
                          if self.stream is not None else b"")
        return self._body

    @body.setter
    def body(self, value: bytes) -> None:
        self._body = value

    def json(self) -> Any:
        return json.loads(self.body) if self.body else None


class LocalRequest:
    """Duck-typed Request for in-process dispatch (the gRPC planes reuse
    the HTTP handler bodies without a socket)."""

    def __init__(self, body: Any = None, query: Optional[dict] = None,
                 method: str = "POST", path: str = "/",
                 headers: Optional[dict] = None):
        self.method = method
        self.path = path
        self.raw_path = path
        self.query = query or {}
        self.body = (json.dumps(body).encode()
                     if isinstance(body, (dict, list)) else (body or b""))
        self.headers = headers or {}
        self.match = None
        self.handler = None

    def json(self) -> Any:
        return json.loads(self.body) if self.body else None


class FileSlice:
    """A ``(fd, offset, count)`` window of a regular file standing in
    for a response body — the zero-copy read-plane descriptor. The
    payload never enters userspace on the common path: ``_send`` hands
    the window to ``os.sendfile`` and the kernel moves pages straight
    from the page cache to the socket. ``__len__`` is the window size,
    so Content-Length, access-log byte counts, and the ledger all work
    unchanged.

    Owns its fd (``send_file`` dups the caller's): the transport closes
    it after the send, win or lose, so a descriptor response stays
    valid even if the producing volume is compacted or closed while the
    bytes are in flight — the dup'd fd pins the old inode."""

    __slots__ = ("fd", "offset", "count", "_closed")

    def __init__(self, fd: int, offset: int, count: int):
        self.fd = fd
        self.offset = int(offset)
        self.count = int(count)
        self._closed = False

    def __len__(self) -> int:
        return self.count

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            os.close(self.fd)
        except OSError:
            pass

    def read_all(self) -> bytes:
        """Materialize the window (in-process LocalRequest dispatch and
        tests — NOT the wire path, which sendfiles it)."""
        out = bytearray()
        off, end = self.offset, self.offset + self.count
        while off < end:
            piece = os.pread(self.fd, min(1 << 20, end - off), off)
            if not piece:
                raise OSError(
                    f"FileSlice: EOF at {off}, wanted {end - off} more")
            out += piece
            off += len(piece)
        return bytes(out)


def send_file(fd: int, offset: int, count: int, *, status: int = 200,
              content_type: str = "application/octet-stream",
              headers: Optional[dict] = None) -> Response:
    """Descriptor response primitive: serve ``count`` bytes of the
    regular file behind ``fd`` starting at ``offset`` without reading
    them into Python. The fd is dup'd here (the response owns the dup;
    the caller keeps its handle) and closed by the transport after the
    payload is on the wire. Callers that may fail between building and
    returning the Response must close ``resp.body`` on that error
    path."""
    return Response(FileSlice(os.dup(fd), offset, count), status=status,
                    content_type=content_type, headers=headers)


class Response:
    def __init__(self, body: Any = None, status: int = 200,
                 content_type: str = "application/json",
                 headers: Optional[dict] = None):
        self.status = status
        self.headers = headers or {}
        # invoked after the response hits the wire (in-flight accounting)
        self.on_sent = None
        if isinstance(body, (dict, list)):
            self.body = json.dumps(body).encode()
            self.content_type = "application/json"
        elif isinstance(body, str):
            self.body = body.encode()
            self.content_type = content_type
        elif body is None:
            self.body = b""
            self.content_type = content_type
        elif isinstance(body, (memoryview, FileSlice)):
            # zero-copy bodies ride through uncoerced: a memoryview is
            # written to the socket as-is, a FileSlice is sendfile'd
            self.body = body
            self.content_type = content_type
        else:
            self.body = bytes(body)
            self.content_type = content_type


class HeaderDict:
    """Case-insensitive header mapping that preserves wire-case keys —
    a lean stand-in for email.message.Message on the hot path (the
    stdlib parse_headers routes every message through the full email
    parser, which costs more than our entire dispatch)."""

    __slots__ = ("_d",)

    def __init__(self):
        self._d: dict[str, tuple[str, str]] = {}

    def add(self, key: str, value: str) -> None:
        lk = key.lower()
        old = self._d.get(lk)
        if old is not None:  # duplicate header: RFC 7230 comma-join
            self._d[lk] = (old[0], old[1] + ", " + value)
        else:
            self._d[lk] = (key, value)

    def get(self, key: str, default=None):
        hit = self._d.get(key.lower())
        return hit[1] if hit is not None else default

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __contains__(self, key) -> bool:
        return str(key).lower() in self._d

    def items(self):
        return list(self._d.values())

    def __iter__(self):
        return iter(k for k, _ in self._d.values())


Route = tuple[str, re.Pattern, Callable[[Request], Response]]


class _BufferedReader:
    """Buffered reader owned by the connection (replaces ``makefile``).
    Exposes ``has_buffered()`` so the dispatch loop can see pipelined
    bytes that are already in user space — those would never make the
    parked socket readable again, so parking on them would strand the
    request."""

    __slots__ = ("_sock", "_buf", "_pos", "_eof")
    _CHUNK = 65536

    def __init__(self, sock):
        self._sock = sock
        self._buf = b""
        self._pos = 0
        self._eof = False

    def has_buffered(self) -> bool:
        return self._pos < len(self._buf)

    def _compact(self) -> None:
        if self._pos >= len(self._buf):
            self._buf = b""
            self._pos = 0

    def readline(self, limit: int = -1) -> bytes:
        while True:
            i = self._buf.find(b"\n", self._pos)
            if i != -1:
                i += 1
                if 0 <= limit < i - self._pos:
                    i = self._pos + limit
                line = self._buf[self._pos:i]
                self._pos = i
                self._compact()
                return line
            if 0 <= limit <= len(self._buf) - self._pos:
                line = self._buf[self._pos:self._pos + limit]
                self._pos += limit
                self._compact()
                return line
            if self._eof:
                line = self._buf[self._pos:]
                self._buf = b""
                self._pos = 0
                return line
            data = self._sock.recv(self._CHUNK)
            if not data:
                self._eof = True
                continue
            if self._pos:
                self._buf = self._buf[self._pos:] + data
                self._pos = 0
            else:
                self._buf += data

    def read(self, n: int = -1) -> bytes:
        if n < 0:  # read to EOF (not on the server hot path)
            chunks = [self._buf[self._pos:]]
            self._buf = b""
            self._pos = 0
            while not self._eof:
                data = self._sock.recv(self._CHUNK)
                if not data:
                    self._eof = True
                    break
                chunks.append(data)
            return b"".join(chunks)
        avail = len(self._buf) - self._pos
        if avail >= n:
            out = self._buf[self._pos:self._pos + n]
            self._pos += n
            self._compact()
            return out
        chunks = [self._buf[self._pos:]] if avail else []
        self._buf = b""
        self._pos = 0
        got = avail
        while got < n and not self._eof:
            data = self._sock.recv(min(self._CHUNK, n - got))
            if not data:
                self._eof = True
                break
            chunks.append(data)
            got += len(data)
        return b"".join(chunks)


class BodyStream:
    """Incremental request-body reader handed to handlers as
    ``Request.stream`` — the home of every body read in the process
    (no handler reads the socket for a body on its own).

    Content-Length mode hands out at most the declared length and
    raises ConnectionError when the client hangs up short — a lying
    Content-Length must surface as an error, never a silently
    truncated object. Chunked mode decodes Transfer-Encoding: chunked
    incrementally as chunks arrive. Never holds more than one read()'s
    worth of bytes, so body memory is the CALLER's budget."""

    __slots__ = ("_rfile", "_remaining", "_chunked", "_chunk_left",
                 "_done", "consumed", "broken")

    def __init__(self, rfile, length: int = 0, chunked: bool = False):
        self._rfile = rfile
        self._remaining = max(0, length)
        self._chunked = chunked
        self._chunk_left = 0
        self._done = not chunked and length <= 0
        self.consumed = 0
        # a transport error mid-body desyncs HTTP framing: the
        # connection must close, not serve another request
        self.broken = False

    @property
    def exhausted(self) -> bool:
        return self._done

    def read(self, n: int) -> bytes:
        """Up to n body bytes; b'' at end of body. Chunked mode may
        return less than n with more still coming (one wire chunk at
        a time) — loop until b'' for exact counts."""
        if self._done or n <= 0:
            return b""
        try:
            data = (self._read_chunked(n) if self._chunked
                    else self._read_plain(n))
        except (OSError, ConnectionError):
            self.broken = True
            raise
        self.consumed += len(data)
        return data

    def _read_plain(self, n: int) -> bytes:
        want = min(n, self._remaining)
        data = self._rfile.read(want)
        if len(data) < want:
            raise ConnectionError(
                f"short request body: got {self.consumed + len(data)} "
                f"of a declared {self.consumed + self._remaining}")
        self._remaining -= want
        if self._remaining <= 0:
            self._done = True
        return data

    def _read_chunked(self, n: int) -> bytes:
        if self._chunk_left == 0:
            size_line = self._rfile.readline(1026)
            if not size_line:
                raise ConnectionError("EOF in chunked request body")
            try:
                self._chunk_left = int(
                    size_line.split(b";")[0].strip() or b"0", 16)
            except ValueError:
                raise ConnectionError(
                    f"bad chunk size {size_line[:32]!r}") from None
            if self._chunk_left == 0:
                while self._rfile.readline(65537) not in (b"\r\n", b"\n",
                                                          b""):
                    pass  # discard trailers
                self._done = True
                return b""
        take = min(n, self._chunk_left)
        data = self._rfile.read(take)
        if len(data) < take:
            raise ConnectionError("EOF mid-chunk in request body")
        self._chunk_left -= take
        if self._chunk_left == 0:
            self._rfile.readline(3)  # chunk-terminating CRLF
        return data

    def readall(self) -> bytes:
        out = bytearray()
        while True:
            piece = self.read(1 << 20)
            if not piece:
                return bytes(out)
            out += piece

    def drain(self, limit: int = 8 << 20) -> bool:
        """Discard the unread remainder so the next keep-alive request
        starts at a frame boundary. False (caller must close the
        connection) when the transport already broke or more than
        ``limit`` bytes would be thrown away — reading out a huge
        ignored body is worse than a reconnect (Go's server draws the
        same line)."""
        if self.broken:
            return False
        thrown = 0
        try:
            while not self._done:
                piece = self.read(65536)
                thrown += len(piece)
                if thrown > limit:
                    return False
        except (OSError, ConnectionError):
            return False
        return True


# worker-loop verdicts for one service() slice of a connection
_PARK = "park"
_CLOSE = "close"


def _fd_readable(sock) -> bool:
    """Zero-timeout readability probe. poll() where available:
    select.select() raises ValueError for fds >= FD_SETSIZE (1024),
    which an edge holding thousands of parked sockets crosses early."""
    if hasattr(select, "poll"):
        p = select.poll()
        p.register(sock.fileno(), select.POLLIN)
        return bool(p.poll(0))
    r, _, _ = select.select([sock], [], [], 0)
    return bool(r)


def _fd_writable(sock, timeout: Optional[float]) -> bool:
    """Block until the socket's send buffer drains (or timeout). The
    sendfile loop lands here on EAGAIN: service() armed a socket
    timeout, which puts the fd in non-blocking mode internally, so a
    full send buffer surfaces as BlockingIOError instead of blocking
    inside the syscall."""
    if hasattr(select, "poll"):
        p = select.poll()
        p.register(sock.fileno(), select.POLLOUT)
        return bool(p.poll(None if timeout is None else timeout * 1000))
    _, w, _ = select.select([], [sock], [], timeout)
    return bool(w)


_BUSY_BODY = b'{"error": "server busy"}'


class _ConnHandler(BaseHTTPRequestHandler):
    """Per-connection handler object; lives as long as the connection
    (parked or active) and is re-entered by worker threads one request
    at a time. Subclasses BaseHTTPRequestHandler for its response
    helpers (send_response/send_error/handle_expect_100) but owns its
    read loop: ``service()`` runs zero-or-more pipelined requests and
    reports whether to park the socket back on the selector or close.
    """

    protocol_version = "HTTP/1.1"
    # buffered response writes + no Nagle: headers and body coalesce
    # into one segment instead of trickling out in tiny writes that
    # collide with delayed ACKs (a flat +40ms/request on keep-alive
    # connections otherwise)
    wbufsize = 64 * 1024
    disable_nagle_algorithm = True

    def __init__(self, sock, addr, srv: "HttpServer"):
        # deliberately NOT calling super().__init__ — socketserver's
        # constructor runs the whole request loop inline
        self.srv = srv
        self.connection = self.request = sock
        self.client_address = addr
        self.server = None
        self.command = ""
        self.requestline = ""
        self.request_version = self.default_request_version
        self.close_connection = True
        if self.disable_nagle_algorithm:
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        self.rfile = _BufferedReader(sock)
        self.wfile = sock.makefile("wb", self.wbufsize)

    def log_message(self, *args):
        pass  # request lines are emitted via glog at -v=2

    # ------------------------------------------------ connection loop

    def service(self) -> str:
        """Serve requests until the connection goes idle (-> park),
        closes, or errors. Runs on a worker thread; every request
        re-enters the ambient scopes inside _dispatch, so nothing
        leaks across requests or across the park/resume boundary."""
        try:
            # re-armed per service slice; parked sockets idle under
            # the selector, not under a timeout
            self.connection.settimeout(self.srv.io_timeout)
        except OSError:
            return _CLOSE
        try:
            while True:
                self.close_connection = True
                self.raw_requestline = self.rfile.readline(65537)
                if not self.raw_requestline:
                    return _CLOSE
                if len(self.raw_requestline) > 65536:
                    self.requestline = ""
                    self.request_version = self.default_request_version
                    self.command = ""
                    self.send_error(414)
                    self.wfile.flush()
                    return _CLOSE
                if not self.parse_request():
                    self.wfile.flush()
                    return _CLOSE
                if not hasattr(self, "do_" + self.command):
                    self.send_error(
                        501, f"Unsupported method ({self.command!r})")
                    self.wfile.flush()
                    return _CLOSE
                self._dispatch()
                self.wfile.flush()
                if self.close_connection:
                    return _CLOSE
                if not self._pending():
                    return _PARK
        except (TimeoutError, socket.timeout, ConnectionError):
            return _CLOSE
        except OSError:
            return _CLOSE
        except Exception as e:
            # parity with socketserver.handle_error, minus the spew for
            # severed connections
            glog.exception("connection handler error: %s",
                           type(e).__name__)
            return _CLOSE

    def _pending(self) -> bool:
        """True when another request's bytes are already available:
        buffered in user space (pipelined), buffered inside the TLS
        record layer, or readable on the socket. Parking such a
        connection would never wake the selector for it."""
        if self.rfile.has_buffered():
            return True
        try:
            pending = getattr(self.connection, "pending", None)
            if pending is not None and pending():
                return True
            return _fd_readable(self.connection)
        except (OSError, ValueError):
            return True  # let the read loop surface the error

    def handle_expect_100(self):
        ok = super().handle_expect_100()
        try:
            self.wfile.flush()  # interim 100 must hit the wire NOW
        except OSError:
            return False
        return ok

    def shed_busy(self, retry_after: float = 1.0) -> None:
        """Best-effort canned 503 when the worker queue is full. Runs
        on the selector thread, so it must never block: one
        non-blocking send, then close."""
        try:
            self.connection.setblocking(False)
            msg = ("HTTP/1.1 503 Service Unavailable\r\n"
                   "Content-Type: application/json\r\n"
                   f"Content-Length: {len(_BUSY_BODY)}\r\n"
                   f"Retry-After: {retry_after:g}\r\n"
                   "Connection: close\r\n\r\n").encode("latin-1")
            self.connection.send(msg + _BUSY_BODY)
        except OSError:
            pass
        self.close_conn()

    def close_conn(self) -> None:
        try:
            self.wfile.close()
        except OSError:
            pass
        try:
            self.connection.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        try:
            self.connection.close()
        except OSError:
            pass

    # ------------------------------------------------ request handling

    def parse_request(self) -> bool:
        """Minimal HTTP/1.1 request parse replacing the stdlib
        email-parser path (which dominates per-request CPU on
        the 1KB data path). Sets the same attributes the base
        class would: command/path/request_version/headers/
        close_connection, incl. Expect: 100-continue."""
        self.command = None
        self.request_version = version = "HTTP/0.9"
        self.close_connection = True
        raw = str(self.raw_requestline, "latin-1").rstrip("\r\n")
        self.requestline = raw
        parts = raw.split()
        if len(parts) == 3:
            command, path, version = parts
            if not version.startswith("HTTP/"):
                self.send_error(400,
                                f"Bad request version {version!r}")
                return False
        elif len(parts) == 2:
            command, path = parts
        else:
            self.send_error(400, f"Bad request syntax {raw!r}")
            return False
        self.command, self.path = command, path
        self.request_version = version
        headers = HeaderDict()
        n_headers = 0
        while True:
            line = self.rfile.readline(65537)
            if len(line) > 65536:
                self.send_error(431, "header line too long")
                return False
            if line in (b"\r\n", b"\n", b"", b"\r"):
                break
            n_headers += 1
            if n_headers > 100:  # stdlib _MAXHEADERS parity
                self.send_error(431, "too many headers")
                return False
            k, sep, v = line.decode("latin-1").partition(":")
            if sep:
                headers.add(k.strip(), v.strip())
        self.headers = headers
        conn = (headers.get("Connection") or "").lower()
        if version >= "HTTP/1.1":
            self.close_connection = conn == "close"
        else:
            self.close_connection = conn != "keep-alive"
        if version >= "HTTP/1.1" and \
                headers.get("Expect", "").lower() == "100-continue":
            if not self.handle_expect_100():
                return False
        return True

    def _reject(self, verdict, length):
        # reject WITHOUT buffering the body: drain it in
        # discarded 64KB chunks (bounded memory) so the
        # client finishes sending and can actually read
        # the 413/429/503; truly huge payloads are cut off
        # after a few MB like Go's http server does
        remaining = min(length, 8 << 20)
        try:
            while remaining > 0:
                got = self.rfile.read(min(remaining, 65536))
                if not got:
                    break
                remaining -= len(got)
        except OSError:
            pass
        verdict.headers.setdefault("Connection", "close")
        self.close_connection = True
        self._send(verdict)

    def _dispatch(self):
        server = self.srv
        length = int(self.headers.get("Content-Length") or 0)
        if server.draining:
            # a draining server takes no NEW work; kept-alive
            # clients get a clean 503 + close so their retry
            # lands on another replica immediately
            self._reject(Response(
                {"error": "draining"}, status=503,
                headers={"Retry-After": "1"}), length)
            return
        with server._inflight_lock:
            server._inflight += 1
        try:
            self._dispatch_traced(length)
        finally:
            with server._inflight_lock:
                server._inflight -= 1

    def _dispatch_traced(self, length):
        server = self.srv
        path = urllib.parse.unquote(
            urllib.parse.urlparse(self.path).path)
        # server span: continue an inbound X-Weed-Trace or mint
        # a fresh trace at this edge. Ambient BEFORE the gates
        # so QoS verdicts annotate it, and around the handler so
        # nested http_calls inject the header downstream. With
        # no tracer (or disabled) this is one attribute check
        # plus the shared NOOP span — no allocation.
        tracer = server.tracer
        span = (tracer.server_span(f"{self.command} {path}",
                                   self.headers)
                if tracer is not None else tracing.NOOP)
        tok = tracing.attach(span)
        try:
            self._dispatch_inner(path, length, span)
        finally:
            tracing.detach(tok)

    def _dispatch_inner(self, path, length, span):
        server = self.srv
        fam = route_family(path)
        eff_cls = qos_classes.from_headers(self.headers) \
            or qos_classes.classify(self.command, path)
        # continuous-profiling scope: the wall sampler attributes this
        # thread's stacks to (class, route) while the request runs.
        # With no sampler active tag() is one global check.
        ptok = profiler.tag(eff_cls, fam,
                            span.trace_id if span.sampled else None)
        ledger = server.ledger
        t_cpu = clockctl.thread_time() if ledger is not None else 0.0
        status, bytes_in, bytes_out = 500, 0, 0
        try:
            status, bytes_in, bytes_out = self._dispatch_gated(
                path, length, span, fam, eff_cls)
        finally:
            profiler.untag(ptok)
            if ledger is not None:
                # the handler ran on THIS thread, so the per-thread
                # CPU clock delta is exactly the request's burn
                tenant = (server.tenant_fn(self.headers,
                                           self.client_address[0])
                          if server.tenant_fn is not None
                          else self.client_address[0])
                ledger.observe_request(
                    eff_cls, tenant,
                    cpu_s=clockctl.thread_time() - t_cpu,
                    bytes_in=bytes_in, bytes_out=bytes_out)

    def _dispatch_gated(self, path, length, span, fam, eff_cls):
        server = self.srv
        # RED edge observation brackets EVERYTHING — admission
        # sheds, gate rejects, 404s, handler 500s — so the
        # duration histogram is the true edge view. clockctl
        # timing: under the sim's virtual clock the same
        # histograms elapse in virtual seconds.
        t_red = clockctl.monotonic()
        red = server.red

        def red_observe(status):
            if red is None:
                return
            red.observe(fam, eff_cls, status,
                        clockctl.monotonic() - t_red,
                        exemplar=span.trace_id
                        if span.sampled else None)

        release = None
        agate = server.admission_gate
        if agate is not None:
            verdict = agate(self.command, path, self.headers,
                            self.client_address[0])
            if isinstance(verdict, Response):
                self._reject(verdict, length)
                red_observe(verdict.status)
                span.finish(status=verdict.status)
                return verdict.status, 0, 0
            release = verdict
        on_sent = None
        resp = None
        stream = None
        out_status = 500
        t0 = clockctl.monotonic()
        try:
            gate = server.body_gate
            if gate is not None and length and \
                    self.command in ("POST", "PUT"):
                verdict = gate(path, length)
                if isinstance(verdict, Response):
                    out_status = verdict.status
                    self._reject(verdict, length)
                    return out_status, 0, 0
                on_sent = verdict
            # the body stays ON THE WIRE until the handler asks for
            # it: streaming handlers pull req.stream a chunk at a
            # time (bounded memory regardless of object size), the
            # rest materialize lazily via req.body
            chunked = "chunked" in (
                self.headers.get("Transfer-Encoding") or "").lower()
            stream = BodyStream(self.rfile, length, chunked)
            # the effective class (propagated header, else edge
            # classification) becomes ambient for the handler, so
            # nested http_calls re-inject it and ledger disk charges
            # land in the same (class, tenant) row as the request
            for method, pattern, fn in server.routes:
                if method != self.command:
                    continue
                m = pattern.match(path)
                if m:
                    try:
                        with qos_classes.class_scope(eff_cls):
                            resp = fn(Request(self, m, stream=stream))
                    except Exception as e:  # surface as 500 JSON
                        glog.exception(
                            "handler error: %s %s -> %s",
                            self.command, path,
                            type(e).__name__)
                        resp = Response(
                            {"error": f"{type(e).__name__}: {e}"},
                            status=500)
                    break
            else:
                resp = Response({"error": "not found"}, status=404)
            # keep-alive framing: whatever body the handler left
            # unread must come off the wire before the next request
            # can parse; a broken or oversized remainder closes
            if not stream.exhausted and not stream.drain():
                resp.headers.setdefault("Connection", "close")
                self.close_connection = True
            out_status = resp.status
            self._send(resp)
            glog.vlog(2, "%s %s %d %dB %.1fms",
                      self.command, self.path, resp.status,
                      len(resp.body),
                      (clockctl.monotonic() - t0) * 1e3)
        finally:
            if on_sent is not None:
                on_sent()
            cb = getattr(resp, "on_sent", None)
            if cb is not None:
                cb()
            if release is not None:
                release()
            red_observe(out_status)
            span.finish(status=out_status)
        return (out_status,
                stream.consumed if stream is not None else 0,
                len(resp.body) if resp is not None else 0)

    def _send(self, resp):
        body = resp.body
        try:
            self.send_response(resp.status)
            self.send_header("Content-Type", resp.content_type)
            if "Content-Length" not in resp.headers:
                # HEAD handlers set it to the entity size; the
                # wire body is still suppressed below
                self.send_header("Content-Length",
                                 str(len(body)))
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.end_headers()
            if self.command == "HEAD":
                return
            if isinstance(body, FileSlice):
                self._send_file_slice(body)
            else:
                self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            if isinstance(body, FileSlice):
                body.close()

    # pread granularity for the buffered descriptor fallback
    _FILE_CHUNK = 1 << 20

    def _send_file_slice(self, fs: FileSlice) -> None:
        """Payload of a descriptor response. The headers are sitting in
        wfile's buffer: flush them, then hand the file window to
        ``os.sendfile`` so the kernel streams page-cache pages to the
        socket with zero userspace copies. A short write (EAGAIN — the
        fd is non-blocking under the service() socket timeout) parks on
        writability for the same io_timeout budget and resumes at the
        short-write offset; sendfile with an explicit offset never
        moves the fd position, so concurrent descriptor sends off one
        volume fd don't interfere. TLS connections (payload must cross
        the record layer), non-regular files, and platforms without
        os.sendfile take the buffered pread loop instead."""
        if fs.count <= 0:
            return
        use_sendfile = (hasattr(os, "sendfile")
                        and getattr(self.connection, "pending",
                                    None) is None)
        if use_sendfile:
            try:
                if not stat.S_ISREG(os.fstat(fs.fd).st_mode):
                    use_sendfile = False
            except OSError:
                use_sendfile = False
        if not use_sendfile:
            self._send_file_buffered(fs)
            return
        self.wfile.flush()  # response head precedes the payload
        off, end = fs.offset, fs.offset + fs.count
        timeout = self.connection.gettimeout()
        while off < end:
            try:
                sent = os.sendfile(self.connection.fileno(), fs.fd,
                                   off, end - off)
            except BlockingIOError:
                if not _fd_writable(self.connection, timeout):
                    raise socket.timeout(
                        "sendfile: send buffer stayed full past "
                        "io_timeout")
                continue
            except OSError:
                if off == fs.offset:
                    # first call refused (EINVAL/ENOTSOCK class):
                    # this transport can't sendfile — buffered loop
                    self._send_file_buffered(fs)
                    return
                raise  # mid-payload failure: framing is unrecoverable
            if sent == 0:
                raise ConnectionError("sendfile: peer gone mid-file")
            off += sent

    def _send_file_buffered(self, fs: FileSlice) -> None:
        off, end = fs.offset, fs.offset + fs.count
        while off < end:
            piece = os.pread(fs.fd, min(self._FILE_CHUNK, end - off),
                             off)
            if not piece:
                # under-delivering Content-Length corrupts framing —
                # close the connection rather than serve a truncation
                raise OSError(
                    f"descriptor read hit EOF at {off}, "
                    f"{end - off} bytes short")
            self.wfile.write(piece)
            off += len(piece)

    do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _dispatch
    # WebDAV verbs
    do_OPTIONS = do_PROPFIND = do_PROPPATCH = _dispatch
    do_MKCOL = do_MOVE = do_COPY = do_LOCK = do_UNLOCK = _dispatch


class _WorkerPool:
    """Bounded, demand-grown request worker pool. Threads spawn only
    when a task arrives and no worker is idle, and exit after sitting
    idle — a node serving six HttpServers doesn't pay six full pools.
    submit() never blocks: a full queue returns False and the caller
    sheds (the selector thread must stay responsive)."""

    def __init__(self, max_workers: int, queue_depth: int,
                 idle_exit: float = 10.0):
        self.max_workers = max(1, int(max_workers))
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        self._idle_exit = idle_exit
        self._lock = threading.Lock()
        self._threads = 0
        self._idle = 0
        self._stopping = False

    def submit(self, fn) -> bool:
        try:
            self._q.put_nowait(fn)
        except queue.Full:
            return False
        spawn = False
        with self._lock:
            if not self._stopping and self._idle == 0 \
                    and self._threads < self.max_workers:
                self._threads += 1
                spawn = True
        if spawn:
            threading.Thread(target=self._work, daemon=True,
                             name="httpd-worker").start()
        return True

    def _work(self):
        while True:
            with self._lock:
                self._idle += 1
            try:
                fn = self._q.get(timeout=self._idle_exit)
            except queue.Empty:
                try:  # one last sweep before shrinking away
                    fn = self._q.get_nowait()
                except queue.Empty:
                    fn = None
            finally:
                with self._lock:
                    self._idle -= 1
            if fn is None or self._stopping:
                break
            try:
                fn()
            except Exception:
                glog.exception("httpd worker task error")
        respawn = False
        with self._lock:
            self._threads -= 1
            # a task enqueued during our shutdown window must not
            # strand until the next submit
            if not self._stopping and not self._q.empty() \
                    and self._idle == 0 \
                    and self._threads < self.max_workers:
                self._threads += 1
                respawn = True
        if respawn:
            threading.Thread(target=self._work, daemon=True,
                             name="httpd-worker").start()

    def stats(self) -> dict:
        with self._lock:
            return {"threads": self._threads, "idle": self._idle,
                    "queued": self._q.qsize(),
                    "max_workers": self.max_workers}

    def stop(self):
        self._stopping = True
        for _ in range(self.max_workers):
            try:
                self._q.put_nowait(None)
            except queue.Full:
                break


# selector registration tags for the two non-connection fds
_ACCEPT = object()
_WAKE = object()


class _SelectorCore:
    """The connection core: one thread multiplexing the listener +
    every parked keep-alive socket through a selector; request
    servicing happens on the bounded worker pool. Exposes ``.socket``
    (a TLS wrapper may swap it for an SSLSocket in place — same fd, so
    the selector registration survives; the port has no TLS wrapper
    yet, utils/tls.py is still to be ported) and ``server_address``
    for ThreadingHTTPServer drop-in parity."""

    def __init__(self, srv: "HttpServer", host: str, port: int,
                 workers: int, queue_depth: int):
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(1024)
        sock.setblocking(False)
        self.socket = sock
        self.server_address = sock.getsockname()
        self.srv = srv
        self._sel = selectors.DefaultSelector()
        # register the raw fd, not the socket object: a later TLS wrap
        # detaches the fd into a new SSLSocket and the old object goes
        # invalid, but the fd (and this registration) live on
        self._sel.register(sock.fileno(), selectors.EVENT_READ, _ACCEPT)
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, _WAKE)
        self._pool = _WorkerPool(workers, queue_depth)
        self._lock = threading.Lock()
        self._parked: dict = {}          # handler -> parked_at
        self._inbox: collections.deque = collections.deque()
        self._conns: set = set()         # every live handler
        self._accepting = True
        self._running = True
        self._accepted = 0
        self._shed = 0
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ---------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="httpd-selector")
        self._thread.start()

    def stop_accepting(self) -> None:
        """Drain phase one: stop taking new connections while the loop
        keeps serving parked ones (their next request gets the 503 +
        close from _dispatch's draining check)."""
        self._accepting = False
        self._wakeup()

    def shutdown(self) -> None:
        self._running = False
        self._wakeup()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._pool.stop()
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
            self._parked.clear()
        for h in conns:
            try:
                h.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            h.close_conn()
        try:
            self.socket.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        self._sel.close()

    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass  # a pending wake byte already does the job

    # ---- stats -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = {"connections": len(self._conns),
                   "parked": len(self._parked),
                   "accepted": self._accepted,
                   "shed_busy": self._shed}
        out.update(self._pool.stats())
        return out

    # ---- selector loop (single thread) -------------------------------

    def _run(self) -> None:
        last_sweep = clockctl.monotonic()
        while self._running:
            try:
                events = self._sel.select(timeout=1.0)
            except OSError:
                continue
            if not self._running:
                break
            for key, _ in events:
                tag = key.data
                if tag is _WAKE:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                elif tag is _ACCEPT:
                    if self._accepting:
                        self._accept_burst()
                else:  # a parked connection became readable (or EOF'd)
                    h = tag
                    try:
                        self._sel.unregister(key.fileobj)
                    except (KeyError, ValueError, OSError):
                        pass
                    with self._lock:
                        self._parked.pop(h, None)
                    self._submit(h)
            self._drain_inbox()
            now = clockctl.monotonic()
            if now - last_sweep >= 5.0:
                last_sweep = now
                self._sweep_idle(now)

    def _accept_burst(self) -> None:
        for _ in range(128):
            try:
                # via self.socket, not a captured local: a TLS wrapper
                # may have swapped in an SSLSocket (handshake-in-accept,
                # same as the threaded server's behavior)
                conn, addr = self.socket.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                # TLS handshake failures arrive here (ssl.SSLError is
                # an OSError): that connection is dead, the listener
                # is fine — keep draining the backlog
                if type(e).__name__.startswith("SSL"):
                    continue
                glog.vlog(1, "accept error: %s", e)
                return
            try:
                conn.setblocking(True)
            except OSError:
                continue
            self._accepted += 1
            h = _ConnHandler(conn, addr, self.srv)
            with self._lock:
                self._conns.add(h)
            self._submit(h)

    def _submit(self, h) -> None:
        if self._pool.submit(lambda: self._service(h)):
            return
        # worker queue saturated: canned 503 + close, never blocking
        # the selector thread. Retry-After stretches with governor
        # pressure so clients back off harder the hotter we run.
        self._shed += 1
        gov = self.srv.governor
        retry = 1.0
        if gov is not None:
            try:
                retry = round(0.5 + 2.0 * gov.pressure(), 1)
            except Exception:
                pass
        h.shed_busy(retry)
        with self._lock:
            self._conns.discard(h)

    def _service(self, h) -> None:
        outcome = h.service()
        if outcome == _PARK and self._running:
            with self._lock:
                self._inbox.append(h)
            self._wakeup()
        else:
            h.close_conn()
            with self._lock:
                self._conns.discard(h)

    def _drain_inbox(self) -> None:
        while True:
            with self._lock:
                if not self._inbox:
                    return
                h = self._inbox.popleft()
            if not self._running:
                h.close_conn()
                with self._lock:
                    self._conns.discard(h)
                continue
            try:
                self._sel.register(h.connection, selectors.EVENT_READ, h)
            except (KeyError, ValueError, OSError):
                h.close_conn()
                with self._lock:
                    self._conns.discard(h)
                continue
            with self._lock:
                self._parked[h] = clockctl.monotonic()

    def _sweep_idle(self, now: float) -> None:
        timeout = self.srv.idle_timeout
        with self._lock:
            stale = [h for h, t in self._parked.items()
                     if now - t > timeout]
            for h in stale:
                self._parked.pop(h, None)
                self._conns.discard(h)
        for h in stale:
            try:
                self._sel.unregister(h.connection)
            except (KeyError, ValueError, OSError):
                pass
            h.close_conn()


class HttpServer:
    """Route table + selector connection core. Routes are
    (METHOD, regex); see the module docstring for the serving model."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 workers: Optional[int] = None, queue_depth: int = 2048,
                 idle_timeout: float = 75.0, io_timeout: float = 60.0):
        self.routes: list[Route] = []
        self.host = host
        self.port = port
        # worker-pool knobs: `workers` bounds service threads (None ->
        # sized at start(), QoS-aware when a governor is wired);
        # `queue_depth` bounds dispatch backlog before canned-503 shed;
        # `idle_timeout` reaps parked keep-alive sockets; `io_timeout`
        # bounds per-syscall progress on an ACTIVE request (parked
        # sockets carry no timeout — the selector owns their idleness).
        self.workers = workers
        self.queue_depth = queue_depth
        self.idle_timeout = idle_timeout
        self.io_timeout = io_timeout
        # QosGovernor wired by the owning server (like tracer/red):
        # sizes the worker pool and shapes shed Retry-After hints
        self.governor = None
        self._httpd: Optional[_SelectorCore] = None
        self._thread: Optional[threading.Thread] = None
        # body_gate(path, content_length) is consulted BEFORE the request
        # body is read from the socket: it returns a Response to reject
        # the request unread (413/429 load shedding), a callable to be
        # invoked once the response is fully sent (in-flight byte
        # accounting), or None to proceed unthrottled (reference
        # weed/server/volume_server_handlers.go inFlight*DataLimitCond).
        self.body_gate = None
        # admission_gate(method, path, headers, client_ip) runs first,
        # for EVERY method: the QoS governor's hook. Same verdict
        # contract as body_gate — a Response sheds the request (503 +
        # Retry-After) before its body is buffered, a callable releases
        # the admission slot once the response is fully sent, None
        # passes. See seaweedfs_tpu_torch/qos/governor.py.
        self.admission_gate = None
        # tracing.Tracer wired by the owning server: _dispatch mints a
        # server span per request (continuing an inbound X-Weed-Trace)
        # and records it into the node's flight recorder. None -> the
        # shared NOOP span, zero allocation.
        self.tracer = None
        # metrics.RedRecorder wired by the owning server: ONE
        # observation site covers every edge's rate/errors/duration,
        # including requests the gates shed. None -> one attribute
        # check per request.
        self.red = None
        # stats.ledger.ResourceLedger wired by the owning server: the
        # dispatch bracket bills each request's thread-CPU delta and
        # wire bytes to (class, tenant). None -> one attribute check.
        self.ledger = None
        # tenant_fn(headers, client_ip) -> str names the ledger row's
        # tenant; None -> client ip (the filer/volume tier's identity;
        # the S3 gateway overrides with the request's access key).
        self.tenant_fn = None
        # graceful-drain state: once draining, new requests (including
        # ones arriving on kept-alive connections) are answered 503 +
        # Connection: close while in-flight requests run to completion;
        # drain() waits on the in-flight counter.
        self.draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    def route(self, method: str, pattern: str):
        compiled = re.compile("^" + pattern + "$")

        def deco(fn):
            self.routes.append((method.upper(), compiled, fn))
            return fn
        return deco

    def add(self, method: str, pattern: str, fn) -> None:
        self.routes.append((method.upper(), re.compile("^" + pattern + "$"),
                            fn))

    def start(self) -> None:
        workers = self.workers
        if workers is None:
            # QoS-aware sizing: with a governor wired, the pool tracks
            # the adaptive limiter's ceiling (every admitted request
            # deserves a thread); without one, a fixed bound
            gov = self.governor
            if gov is not None:
                workers = max(16, min(128, gov.limiter.max_limit))
            else:
                workers = 64
        core = _SelectorCore(self, self.host, self.port,
                             workers=workers, queue_depth=self.queue_depth)
        self._httpd = core
        self.port = core.server_address[1]
        core.start()
        self._thread = core._thread

    def conn_stats(self) -> dict:
        """Connection-core counters for metrics / the conn bench:
        open + parked connections, worker threads, queue depth, busy
        sheds, in-flight requests."""
        core = self._httpd
        out = core.stats() if core is not None else {
            "connections": 0, "parked": 0, "accepted": 0,
            "shed_busy": 0, "threads": 0, "idle": 0, "queued": 0,
            "max_workers": 0}
        with self._inflight_lock:
            out["inflight"] = self._inflight
        return out

    def drain(self, timeout: float = 10.0) -> bool:
        """Graceful-stop phase one: refuse new requests (503 + close),
        stop accepting connections, and wait for in-flight requests to
        finish.  Returns True when the server went idle within
        ``timeout``; the caller then runs stop() for the hard close.
        Idempotent, and safe before start(). Parked keep-alive
        connections stay serviced (their next request gets the 503 +
        Connection: close) until stop() severs them."""
        self.draining = True
        if self._httpd:
            self._httpd.stop_accepting()
        deadline = clockctl.monotonic() + timeout
        while clockctl.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    return True
            clockctl.sleep(0.02)
        with self._inflight_lock:
            return self._inflight == 0

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd = None


class RangeNotSatisfiable(Exception):
    """Raise-to-416: the range is well-formed but outside the entity
    (RFC 7233 §4.4; S3 answers InvalidRange). Callers respond 416 with
    'Content-Range: bytes */<total>' — serving a 200 full body instead
    would corrupt resuming downloaders that append the response."""


def parse_byte_range(spec: str, total: int) -> Optional[tuple[int, int]]:
    """RFC 7233 single-range parse: 'bytes=a-b' / 'bytes=a-' /
    'bytes=-n' (suffix: the LAST n bytes). Returns (lo, hi) inclusive;
    None when no/malformed range (serve the full body, per RFC);
    raises RangeNotSatisfiable when lo lies beyond the entity."""
    if not spec or not spec.startswith("bytes="):
        return None
    lo_s, _, hi_s = spec[6:].partition("-")
    try:
        if not lo_s:  # suffix form
            n = int(hi_s)
            if n <= 0:
                return None
            if total == 0:
                # no last-N bytes of an empty entity (AWS: 416)
                raise RangeNotSatisfiable(spec)
            return max(0, total - n), total - 1
        lo = int(lo_s)
        hi = int(hi_s) if hi_s else total - 1
    except ValueError:
        return None
    if lo >= total:
        # beyond EOF — includes the open-ended 'bytes=<past-end>-'
        # form, whose default hi (total-1) is < lo and must not be
        # mistaken for a malformed spec
        raise RangeNotSatisfiable(spec)
    if hi < lo:
        return None
    return lo, min(hi, total - 1)


class HttpError(Exception):
    def __init__(self, status: int, body: bytes,
                 retry_after: Optional[float] = None):
        self.status = status
        self.body = body
        # server-sent pacing hint (429/503): RetryPolicy sleeps this
        # instead of its own computed backoff
        self.retry_after = retry_after
        super().__init__(f"HTTP {status}: {body[:200]!r}")


def retry_after_hint(status: int, resp_headers) -> Optional[float]:
    """Seconds from a Retry-After header on a shed response (429/503
    only — the statuses the limiters emit); None otherwise. Only the
    delta-seconds form is parsed (what this codebase sends); an
    HTTP-date or garbage value degrades to None, not an error."""
    if status not in (429, 503) or not resp_headers:
        return None
    for k, v in resp_headers.items():
        if k.lower() == "retry-after":
            try:
                return max(0.0, float(v))
            except (TypeError, ValueError):
                return None
    return None


# Process-wide keep-alive connection pool (below, after
# RawHttpConnection). The data path makes millions of tiny requests;
# per-request TCP setup/teardown (urllib's behavior) costs more than
# the request itself and floods TIME_WAIT. The reference leans on Go's
# pooled http.Transport the same way (weed/util/http_util.go).


class RawHttpConnection:
    """Minimal pooled HTTP/1.1 client connection. Replaces
    http.client on the hot data path: no email-parser response
    headers, no per-response makefile, one buffered reader for the
    connection's lifetime. Handles Content-Length, chunked and
    read-to-close bodies, keep-alive, and 1xx skipping."""

    def __init__(self, netloc: str, timeout: float):
        self.netloc = netloc
        host, port = netloc, 80
        if netloc.startswith("["):  # IPv6 literal [::1]:8080
            host, _, rest = netloc[1:].partition("]")
            if rest.startswith(":"):
                port = int(rest[1:])
        elif ":" in netloc:
            host, _, p = netloc.rpartition(":")
            port = int(p)
        # _pooled_conn re-arms settimeout() per request with the
        # caller's deadline
        self.sock = socket.create_connection((host or "127.0.0.1", port),
                                             timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self.sock.makefile("rb", buffering=65536)

    def close(self) -> None:
        sock, self.sock = self.sock, None
        if sock is None:
            return  # already closed
        for closer in (self._rfile.close, sock.close):
            try:
                closer()
            except OSError:
                pass

    def _read_exact(self, n: int) -> bytes:
        data = self._rfile.read(n)
        if data is None or len(data) < n:
            raise ConnectionError("short HTTP body")
        return data

    def _read_chunked(self) -> bytes:
        out = bytearray()
        while True:
            size_line = self._rfile.readline(1026)
            if not size_line:
                raise ConnectionError("EOF in chunked body")
            n = int(size_line.split(b";")[0].strip() or b"0", 16)
            if n == 0:
                while self._rfile.readline(65537) not in (b"\r\n", b"\n",
                                                          b""):
                    pass  # discard trailers
                return bytes(out)
            out += self._read_exact(n)
            self._rfile.readline(3)  # chunk CRLF

    def send_request(self, method: str, target: str,
                     body: Optional[bytes],
                     headers: Optional[dict]) -> None:
        buf = [f"{method} {target} HTTP/1.1\r\n"]
        has_len = has_host = False
        for k, v in (headers or {}).items():
            lk = k.lower()
            if lk == "content-length":
                has_len = True
            elif lk == "host":
                has_host = True  # caller-set (SigV4 signs it): no dup
            buf.append(f"{k}: {v}\r\n")
        if not has_host:
            buf.append(f"Host: {self.netloc}\r\n")
        if not has_len and (body or method not in ("GET", "HEAD")):
            buf.append(f"Content-Length: {len(body or b'')}\r\n")
        buf.append("\r\n")
        msg = "".join(buf).encode("latin-1")
        self.sock.sendall(msg + body if body else msg)

    def read_response(self, method: str) -> tuple[int, bytes, dict, bool]:
        """Returns (status, body, headers, will_close)."""
        while True:  # skip 1xx interim responses
            line = self._rfile.readline(65537)
            if not line:
                raise ConnectionError("no HTTP status line")
            parts = line.decode("latin-1").split(None, 2)
            if len(parts) < 2 or not parts[0].startswith("HTTP/"):
                raise ConnectionError(f"bad status line {line!r}")
            version, status = parts[0], int(parts[1])
            resp = HeaderDict()
            n_headers = 0
            while True:
                hl = self._rfile.readline(65537)
                if hl in (b"\r\n", b"\n", b""):
                    break
                n_headers += 1
                if n_headers > 100:  # stdlib _MAXHEADERS parity
                    raise ConnectionError("too many response headers")
                k, sep, v = hl.decode("latin-1").partition(":")
                if sep:
                    resp.add(k.strip(), v.strip())
            if status >= 200:
                break
        conn_hdr = (resp.get("Connection") or "").lower()
        will_close = (conn_hdr == "close"
                      or (version == "HTTP/1.0"
                          and conn_hdr != "keep-alive"))
        te = (resp.get("Transfer-Encoding") or "").lower()
        if method == "HEAD" or status in (204, 304):
            data = b""
        elif "chunked" in te:
            data = self._read_chunked()
        elif resp.get("Content-Length") is not None:
            data = self._read_exact(int(resp["Content-Length"]))
        else:  # body delimited by connection close (HTTP/1.0 style)
            data = self._rfile.read()
            will_close = True
        return status, data, dict(resp.items()), will_close


def _make_conn(netloc: str, timeout: float) -> RawHttpConnection:
    return RawHttpConnection(netloc, timeout)


def _conn_alive(conn: RawHttpConnection) -> bool:
    """Liveness check before reuse (urllib3's is_connection_dropped):
    a peer that closed shows readable-EOF, and sending into it would
    "succeed" into the kernel buffer and only fail at response time —
    un-retryable for non-idempotent methods. This matters when a
    server restarts on a reused port."""
    if conn.sock is None:
        return False
    try:
        readable = _fd_readable(conn.sock)
    except (OSError, ValueError):
        return False
    # EOF or unsolicited bytes: the peer is gone (or the stream is
    # desynced) — not reusable
    return not readable


class HttpConnectionPool:
    """Process-wide keep-alive pool: per-destination bounded idle
    stacks under one lock. Replaces the per-thread pool, whose idle
    socket count scaled with threads x destinations (a filer with 64
    workers kept 64 sockets per volume server alive).

    Checkout/checkin model: acquire() pops a live idle connection (or
    dials), release() parks it back unless the destination stack or
    the global cap is full — overflow closes the NEWLY returned socket
    and a breached global cap also evicts the globally oldest idle one
    (LRU across destinations). Eviction is breaker-aware twice over:
    any transport failure drops the whole destination (its siblings
    share the dead peer), and a circuit breaker opening anywhere in
    the process evicts that peer's idles via resilience's
    on_breaker_open hook."""

    def __init__(self, per_dest: int = 4, max_idle: int = 128,
                 idle_ttl: float = 30.0):
        self.per_dest = per_dest
        self.max_idle = max_idle
        self.idle_ttl = idle_ttl
        self._lock = threading.Lock()
        self._idle: dict[str, list] = {}  # netloc -> [(conn, parked_at)]
        self._total = 0
        self.dials = 0
        self.reuses = 0
        self.evictions = 0

    def acquire(self, netloc: str,
                timeout: float) -> tuple[RawHttpConnection, bool]:
        """Returns (conn, reused): `reused` is True when the socket was
        already open from a previous request — the only case where an
        automatic retry is safe (a stale kept-alive socket fails before
        the server sees anything; a fresh connection that dies
        mid-response may have EXECUTED the request, so replaying it is
        the caller's call)."""
        now = clockctl.monotonic()
        while True:
            with self._lock:
                stack = self._idle.get(netloc)
                if not stack:
                    break
                conn, parked_at = stack.pop()
                if not stack:
                    del self._idle[netloc]
                self._total -= 1
            if now - parked_at > self.idle_ttl or not _conn_alive(conn):
                self.evictions += 1
                conn.close()
                continue
            # re-armed per request with the caller's deadline-capped
            # timeout
            conn.sock.settimeout(timeout)
            self.reuses += 1
            return conn, True
        self.dials += 1
        return _make_conn(netloc, timeout), False

    def release(self, conn: RawHttpConnection) -> None:
        if conn.sock is None:
            return
        evicted = None
        with self._lock:
            stack = self._idle.get(conn.netloc)
            if stack is not None and len(stack) >= self.per_dest:
                self.evictions += 1
                evicted = conn  # destination stack full: close this one
            else:
                if self._total >= self.max_idle:
                    evicted = self._evict_oldest_locked()
                if stack is None:
                    stack = self._idle.setdefault(conn.netloc, [])
                stack.append((conn, clockctl.monotonic()))
                self._total += 1
        if evicted is not None:
            evicted.close()

    def _evict_oldest_locked(self):
        """Drop the globally least-recently-parked idle connection
        (LRU destination eviction). Caller holds the lock."""
        oldest_key, oldest_i, oldest_t = None, -1, None
        for key, stack in self._idle.items():
            # index 0 is the oldest entry of each destination stack
            t = stack[0][1]
            if oldest_t is None or t < oldest_t:
                oldest_key, oldest_i, oldest_t = key, 0, t
        if oldest_key is None:
            return None
        conn, _ = self._idle[oldest_key].pop(oldest_i)
        if not self._idle[oldest_key]:
            del self._idle[oldest_key]
        self._total -= 1
        self.evictions += 1
        return conn

    def drop(self, netloc: str) -> None:
        """Evict every idle connection to `netloc` — called on any
        transport failure and when the peer's breaker opens (the
        siblings ride the same dead peer)."""
        with self._lock:
            stack = self._idle.pop(netloc, None)
            if stack:
                self._total -= len(stack)
                self.evictions += len(stack)
        for conn, _ in stack or ():
            conn.close()

    def stats(self) -> dict:
        with self._lock:
            return {"idle": self._total,
                    "destinations": len(self._idle),
                    "dials": self.dials, "reuses": self.reuses,
                    "evictions": self.evictions}


_POOL = HttpConnectionPool()


def _breaker_evict(peer: str) -> None:
    # peer keys are 'ip:port' or a full URL; the pool keys by netloc
    _POOL.drop(urllib.parse.urlsplit(peer).netloc
               if "//" in peer else peer)


resilience.on_breaker_open(_breaker_evict)


def _pooled_conn(netloc: str, timeout: float):
    return _POOL.acquire(netloc, timeout)


def _drop_conn(netloc: str) -> None:
    _POOL.drop(netloc)


def http_call(method: str, url: str, body: Optional[bytes] = None,
              json_body: Any = None, timeout: float = 30.0,
              headers: Optional[dict] = None, deadline=None,
              follow_redirects: bool = True) -> tuple[int, bytes, dict]:
    # Trace propagation: when a trace is ambient, this outbound RPC
    # becomes a client child span and its ids ride X-Weed-Trace so the
    # callee's server span nests under it. No ambient trace (or tracing
    # disabled) costs one ContextVar read — no span allocation.
    amb = tracing.current_span()
    if amb is None:
        return _http_call_following(method, url, body, json_body,
                                    timeout, headers, deadline,
                                    follow_redirects)
    span = amb.child(f"{method.upper()} {url.split('?', 1)[0]}")
    headers = dict(headers or {})
    headers.setdefault(tracing.TRACE_HEADER, span.header_value())
    status, err = 0, ""
    try:
        out = _http_call_following(method, url, body, json_body,
                                   timeout, headers, deadline,
                                   follow_redirects)
        status = out[0]
        return out
    except BaseException as e:
        status, err = 599, f"{type(e).__name__}: {e}"
        raise
    finally:
        span.finish(status=status, error=err)


# Data-plane redirects (the filer/S3 read path answers eligible GETs
# with a 302 volume-direct URL) are followed transparently for safe
# methods, re-sending the original headers (Range, class, deadline) at
# the target. 307 is deliberately NOT in this set: that status is the
# filer namespace-shard redirect protocol, consumed by
# wdclient.filer_call with its own ring-epoch bookkeeping.
_REDIRECT_STATUSES = (301, 302, 303)
_MAX_REDIRECT_HOPS = 4


def _http_call_following(method, url, body, json_body, timeout,
                         headers, deadline,
                         follow: bool) -> tuple[int, bytes, dict]:
    out = _http_call_impl(method, url, body, json_body, timeout,
                          headers, deadline)
    if not follow or method.upper() not in ("GET", "HEAD"):
        return out
    hops = 0
    while out[0] in _REDIRECT_STATUSES and hops < _MAX_REDIRECT_HOPS:
        loc = next((v for k, v in out[2].items()
                    if k.lower() == "location"), None)
        if not loc:
            break
        url = urllib.parse.urljoin(url, loc)
        out = _http_call_impl(method, url, None, None, timeout,
                              headers, deadline)
        hops += 1
    return out


def _http_call_impl(method: str, url: str, body: Optional[bytes] = None,
                    json_body: Any = None, timeout: float = 30.0,
                    headers: Optional[dict] = None,
                    deadline=None) -> tuple[int, bytes, dict]:
    # Deadline propagation: `timeout` becomes a CAP under the caller's
    # remaining budget (explicit `deadline` arg, else the ambient
    # request-scope one), and the remaining seconds ride along in the
    # X-Weed-Deadline header so the callee inherits the same budget.
    # An already-expired deadline raises DeadlineExceeded (a
    # ConnectionError) before any bytes hit the wire.
    if deadline is None:
        deadline = resilience.current_deadline()
    if deadline is not None:
        timeout = deadline.timeout(cap=timeout)
        headers = dict(headers or {})
        headers.setdefault(resilience.DEADLINE_HEADER,
                           deadline.header_value())
    # traffic class rides along exactly like the deadline: ambient
    # scope -> X-Weed-Class header -> callee re-enters the scope
    cls = qos_classes.current_class()
    if cls is not None:
        headers = dict(headers or {})
        headers.setdefault(qos_classes.CLASS_HEADER, cls)
    if json_body is not None:
        body = json.dumps(json_body).encode()
        headers = dict(headers or {})
        headers["Content-Type"] = "application/json"
    parsed = urllib.parse.urlsplit(url)
    if parsed.scheme == "https":  # rare path: no pooling, plain urllib
        req = urllib.request.Request(url, data=body, method=method.upper(),
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)
        except (urllib.error.URLError, socket.timeout, ConnectionError) as e:
            raise ConnectionError(f"{method} {url}: {e}") from e
    target = parsed.path or "/"
    if parsed.query:
        target += "?" + parsed.query
    method = method.upper()
    last_err = None
    for attempt in (0, 1):
        sent = False
        reused = False
        conn = None
        try:
            # inside the try: connection setup itself can raise
            # (SYN timeout, DNS failure, bad netloc) and must surface
            # as ConnectionError like every other transport failure
            conn, reused = _POOL.acquire(parsed.netloc, timeout)
            conn.send_request(method, target, body, headers)
            sent = True
            status, data, resp_headers, will_close = \
                conn.read_response(method)
            if will_close:
                conn.close()
            else:
                _POOL.release(conn)
            return status, data, resp_headers
        except (BrokenPipeError, ConnectionResetError,
                ConnectionRefusedError, ConnectionAbortedError,
                ConnectionError, socket.timeout, ValueError,
                OSError) as e:
            if conn is not None:
                conn.close()
            # the destination's idle siblings share the dead peer
            _POOL.drop(parsed.netloc)
            last_err = e
            # Replay rules (Go http.Transport's): only on a REUSED
            # kept-alive socket, and only when the request either
            # failed during SEND (server closed it idle; it never
            # executed) or is idempotent (GET/HEAD). A non-idempotent
            # POST that died mid-response may have executed — surface
            # the error rather than silently running it twice.
            idempotent = method in ("GET", "HEAD")
            if not reused or (sent and not idempotent) or \
                    isinstance(e, (ConnectionRefusedError,
                                   socket.timeout)):
                break
    raise ConnectionError(f"{method} {url}: {last_err}") from last_err


def http_json(method: str, url: str, json_body: Any = None,
              timeout: float = 30.0, deadline=None) -> Any:
    status, body, resp_headers = http_call(method, url, json_body=json_body,
                                           timeout=timeout,
                                           deadline=deadline)
    if status >= 400:
        raise HttpError(status, body,
                        retry_after=retry_after_hint(status, resp_headers))
    return json.loads(body) if body else None
