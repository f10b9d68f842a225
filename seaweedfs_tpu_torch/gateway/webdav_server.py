"""WebDAV gateway over the filer (reference weed/server/webdav_server.go,
which wraps golang.org/x/net/webdav; we implement the protocol subset
directly: OPTIONS, PROPFIND depth 0/1, GET/HEAD, PUT, DELETE, MKCOL,
MOVE, COPY, and no-op LOCK/UNLOCK for client compatibility).

The port's copy of seaweedfs_tpu/gateway/webdav_server.py, the same code
with its imports pointed at the port; it imports nothing of that
package. It takes no device.
"""

from __future__ import annotations

import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Optional

from seaweedfs_tpu_torch.utils import clockctl, tracing
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.utils.httpd import HttpServer, Request, Response
from seaweedfs_tpu_torch.utils.resilience import Deadline, deadline_scope

DAV_NS = "DAV:"

# edge budget when the client didn't propagate one
DAV_DEADLINE_S = 30.0


class WebDavServer:
    def __init__(self, filer_server, host: str = "127.0.0.1", port: int = 0,
                 root: str = "/", tracing_enabled: bool = True,
                 trace_sample: float = 0.01):
        self.fs = filer_server
        self.filer: Filer = filer_server.filer
        self.root = "/" + root.strip("/") if root.strip("/") else ""
        self.http = HttpServer(host, port)
        # without a tracer this edge attaches the shared NOOP span and
        # an inbound X-Weed-Trace dies here instead of riding the
        # filer's chunk uploads to the volume tier
        self.tracer = tracing.Tracer(
            node=f"webdav@{host}:{port}", enabled=tracing_enabled,
            sample_rate=trace_sample)
        self.http.tracer = self.tracer
        # RED at this edge rides a private metrics listener, same as
        # the filer: every path on the DAV port is user namespace
        from seaweedfs_tpu_torch.utils.metrics import Registry, RedRecorder
        self.metrics = Registry()
        self.red = RedRecorder(self.metrics, "webdav")
        self.http.red = self.red
        self.metrics_http = HttpServer(host, 0)
        self.metrics_http.add(
            "GET", "/metrics",
            lambda req: Response(self.metrics.expose_text(),
                                 content_type="text/plain; version=0.0.4"))
        self.metrics_http.add("GET", "/admin/telemetry",
                              self._handle_telemetry)
        for m in ("OPTIONS", "PROPFIND", "GET", "HEAD", "PUT", "DELETE",
                  "MKCOL", "MOVE", "COPY", "LOCK", "UNLOCK", "PROPPATCH"):
            self.http.add(m, "/.*", self._dispatch)

    def start(self) -> None:
        self.http.start()
        self.metrics_http.start()

    def stop(self) -> None:
        self.http.stop()
        self.metrics_http.stop()
        self.metrics.stop_push()

    @property
    def metrics_url(self) -> str:
        return f"{self.metrics_http.host}:{self.metrics_http.port}"

    def telemetry_snapshot(self) -> dict:
        return {"node": self.url, "server": "webdav",
                "red": self.red.snapshot()}

    def _handle_telemetry(self, req: Request) -> Response:
        return Response(self.telemetry_snapshot())

    @property
    def url(self) -> str:
        return f"{self.http.host}:{self.http.port}"

    # ---- dispatch ----
    def _fpath(self, url_path: str) -> str:
        p = urllib.parse.unquote(url_path).rstrip("/") or "/"
        return (self.root + p).rstrip("/") or "/"

    def _dispatch(self, req: Request) -> Response:
        # edge deadline: honor an inbound X-Weed-Deadline (or mint the
        # default) so the filer's chunk reads/uploads below inherit the
        # remaining budget and re-inject the header volume-ward
        with deadline_scope(Deadline.from_headers(req.headers,
                                                  default=DAV_DEADLINE_S)):
            return self._route(req)

    def _route(self, req: Request) -> Response:
        m = req.method
        if m == "OPTIONS":
            return Response(b"", headers={
                "DAV": "1,2", "MS-Author-Via": "DAV",
                "Allow": "OPTIONS,PROPFIND,GET,HEAD,PUT,DELETE,MKCOL,"
                         "MOVE,COPY,LOCK,UNLOCK"})
        if m == "PROPFIND":
            return self._propfind(req)
        if m in ("GET", "HEAD"):
            return self._get(req, head=(m == "HEAD"))
        if m == "PUT":
            return self._put(req)
        if m == "DELETE":
            return self._delete(req)
        if m == "MKCOL":
            self.filer.mkdirs(self._fpath(req.path))
            return Response(b"", status=201)
        if m in ("MOVE", "COPY"):
            return self._move_copy(req, copy=(m == "COPY"))
        if m in ("LOCK", "UNLOCK", "PROPPATCH"):
            # advertise success; we don't enforce locks
            if m == "LOCK":
                tok = "opaquelocktoken:seaweedfs-tpu"
                body = (f'<?xml version="1.0"?><D:prop xmlns:D="DAV:">'
                        f'<D:lockdiscovery><D:activelock><D:locktoken>'
                        f'<D:href>{tok}</D:href></D:locktoken>'
                        f'</D:activelock></D:lockdiscovery></D:prop>')
                return Response(body.encode(), status=200,
                                content_type="application/xml",
                                headers={"Lock-Token": f"<{tok}>"})
            return Response(b"", status=204)
        return Response(b"", status=405)

    # ---- handlers ----
    def _propfind(self, req: Request) -> Response:
        path = self._fpath(req.path)
        entry = self.filer.find_entry(path)
        if entry is None:
            return Response(b"", status=404)
        depth = req.headers.get("Depth", "1")
        items = [(req.path.rstrip("/") or "/", entry)]
        if entry.is_directory and depth != "0":
            for child in self.filer.list_entries(path):
                href = (req.path.rstrip("/") or "") + "/" + child.name
                items.append((href, child))
        ET.register_namespace("D", DAV_NS)
        ms = ET.Element(f"{{{DAV_NS}}}multistatus")
        for href, e in items:
            r = ET.SubElement(ms, f"{{{DAV_NS}}}response")
            ET.SubElement(r, f"{{{DAV_NS}}}href").text = \
                urllib.parse.quote(href + ("/" if e.is_directory else ""))
            ps = ET.SubElement(r, f"{{{DAV_NS}}}propstat")
            prop = ET.SubElement(ps, f"{{{DAV_NS}}}prop")
            rt = ET.SubElement(prop, f"{{{DAV_NS}}}resourcetype")
            if e.is_directory:
                ET.SubElement(rt, f"{{{DAV_NS}}}collection")
            else:
                ET.SubElement(
                    prop, f"{{{DAV_NS}}}getcontentlength").text = \
                    str(e.file_size())
                ET.SubElement(
                    prop, f"{{{DAV_NS}}}getcontenttype").text = \
                    e.attr.mime or "application/octet-stream"
            ET.SubElement(prop, f"{{{DAV_NS}}}getlastmodified").text = \
                time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                              time.gmtime(e.attr.mtime))
            ET.SubElement(ps, f"{{{DAV_NS}}}status").text = \
                "HTTP/1.1 200 OK"
        body = (b'<?xml version="1.0" encoding="utf-8"?>'
                + ET.tostring(ms))
        return Response(body, status=207, content_type="application/xml")

    def _get(self, req: Request, head: bool) -> Response:
        path = self._fpath(req.path)
        entry = self.filer.find_entry(path)
        if entry is None or entry.is_directory:
            return Response(b"", status=404)
        data = b"" if head else self.fs._read_entry_bytes(entry)
        return Response(data, content_type=entry.attr.mime
                        or "application/octet-stream")

    def _put(self, req: Request) -> Response:
        path = self._fpath(req.path)
        from seaweedfs_tpu_torch.filer.entry import Attr
        # the filer's streaming ingest: chunked as bytes arrive,
        # bounded memory, inline-vs-chunks decided by the same head
        content, chunks, size = self.fs._ingest_body(req, "", "")
        now = clockctl.now()
        entry = Entry(full_path=path,
                      attr=Attr(mtime=now, crtime=now,
                                mime=req.headers.get("Content-Type", ""),
                                file_size=size))
        entry.content = content
        entry.chunks = chunks
        try:
            self.filer.create_entry(entry)
        except IsADirectoryError:
            return Response(b"", status=409)
        return Response(b"", status=201)

    def _delete(self, req: Request) -> Response:
        try:
            self.filer.delete_entry(self._fpath(req.path), recursive=True)
        except FileNotFoundError:
            return Response(b"", status=404)
        return Response(b"", status=204)

    def _move_copy(self, req: Request, copy: bool) -> Response:
        dest = req.headers.get("Destination", "")
        if not dest:
            return Response(b"", status=400)
        dest_path = self._fpath(urllib.parse.urlparse(dest).path)
        src_path = self._fpath(req.path)
        entry = self.filer.find_entry(src_path)
        if entry is None:
            return Response(b"", status=404)
        if copy:
            if entry.is_directory:
                return Response(b"", status=501)
            data = self.fs._read_entry_bytes(entry)
            from seaweedfs_tpu_torch.filer.entry import Attr
            now = clockctl.now()
            new = Entry(full_path=dest_path,
                        attr=Attr(mtime=now, crtime=now,
                                  mime=entry.attr.mime,
                                  file_size=len(data)))
            if len(data) <= 2048:
                new.content = data
            else:
                new.chunks = self.fs._upload_chunks(data, "", "")
            self.filer.create_entry(new)
        else:
            self.filer.rename_entry(src_path, dest_path)
        return Response(b"", status=201)
