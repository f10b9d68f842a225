"""Azure-Blob-wire remote storage client (reference
weed/remote_storage/azure/azure_storage_client.go, which uses the Azure
SDK; here the Blob service REST API is spoken directly — SharedKey
HMAC-SHA256 request signing, Put/Get/Delete Blob, List Blobs — the same
dependency-free approach as the S3/SQS/Kafka wire clients).

Works against any Blob-protocol endpoint (Azure, azurite); tests run
against MiniAzureServer below, which verifies the SharedKey signature.

The port's copy of seaweedfs_tpu/remote_storage/azure_client.py. It
imports nothing of that package.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Iterator, Optional

from seaweedfs_tpu_torch.utils.httpd import http_call
from seaweedfs_tpu_torch.remote_storage.remote_storage import (
    RemoteFile, RemoteStorageClient)

API_VERSION = "2020-10-02"


def shared_key_signature(account: str, key_b64: str, method: str,
                         path: str, query: dict, headers: dict) -> str:
    """SharedKey StringToSign (the 2015+ scheme: empty Content-Length
    for zero-length bodies). `headers` keys must be lower-case."""
    length = headers.get("content-length", "")
    if length in ("0", 0):
        length = ""
    canon_headers = "".join(
        f"{k}:{headers[k]}\n"
        for k in sorted(h for h in headers if h.startswith("x-ms-")))
    canon_resource = f"/{account}{path}"
    for k in sorted(query):
        canon_resource += f"\n{k.lower()}:{query[k]}"
    sts = "\n".join([
        method,
        headers.get("content-encoding", ""),
        headers.get("content-language", ""),
        str(length),
        headers.get("content-md5", ""),
        headers.get("content-type", ""),
        headers.get("date", ""),
        headers.get("if-modified-since", ""),
        headers.get("if-match", ""),
        headers.get("if-none-match", ""),
        headers.get("if-unmodified-since", ""),
        headers.get("range", ""),
    ]) + "\n" + canon_headers + canon_resource
    mac = hmac.new(base64.b64decode(key_b64), sts.encode("utf-8"),
                   hashlib.sha256)
    return base64.b64encode(mac.digest()).decode()


class AzureRemote(RemoteStorageClient):
    """Blob container as a remote (account key = RemoteConf.secret_key,
    account name = RemoteConf.access_key, container = bucket)."""

    def __init__(self, endpoint: str, container: str, account: str,
                 key_b64: str, timeout: float = 20.0):
        self.endpoint = endpoint.rstrip("/")
        self.container = container
        self.account = account
        self.key_b64 = key_b64
        self.timeout = timeout

    def _call(self, method: str, blob: str, query: Optional[dict] = None,
              body: bytes = b"", headers: Optional[dict] = None,
              ok=(200, 201, 202, 206)):
        query = query or {}
        path = f"/{self.container}"
        if blob:
            path += "/" + urllib.parse.quote(blob)
        hdrs = {
            "x-ms-date": time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                                       time.gmtime()),
            "x-ms-version": API_VERSION,
            **(headers or {}),
        }
        if body:
            hdrs["Content-Length"] = str(len(body))
        lower = {k.lower(): v for k, v in hdrs.items()}
        sig = shared_key_signature(self.account, self.key_b64, method,
                                   path, query, lower)
        hdrs["Authorization"] = f"SharedKey {self.account}:{sig}"
        qs = ("?" + urllib.parse.urlencode(query)) if query else ""
        # http_call: deadline/class/trace headers propagate to the
        # remote tier; SharedKey only canonicalizes x-ms-* headers, so
        # the extra X-Weed-* headers don't disturb the signature
        status, data, resp_headers = http_call(
            method, f"{self.endpoint}{path}{qs}", body=body or None,
            timeout=self.timeout, headers=hdrs)
        if status not in ok:
            raise ConnectionError(f"azure {method} {path}: {status}")
        return status, data, resp_headers

    # ---- RemoteStorageClient ----
    def traverse(self, prefix: str = "") -> Iterator[RemoteFile]:
        marker = ""
        while True:
            query = {"restype": "container", "comp": "list"}
            if prefix:
                query["prefix"] = prefix.lstrip("/")
            if marker:
                query["marker"] = marker
            _, data, _ = self._call("GET", "", query=query)
            root = ET.fromstring(data)
            for b in root.iter("Blob"):
                name = b.findtext("Name")
                props = b.find("Properties")
                size = int(props.findtext("Content-Length", "0"))
                etag = props.findtext("Etag", "")
                yield RemoteFile(path=name, size=size, mtime=0,
                                 etag=etag)
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return

    def read_file(self, path: str, offset: int = 0,
                  size: int = -1) -> bytes:
        headers = {}
        if offset or size >= 0:
            end = "" if size < 0 else str(offset + size - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        _, data, _ = self._call("GET", path.lstrip("/"), headers=headers)
        return data

    def write_file(self, path: str, data: bytes) -> RemoteFile:
        _, _, resp_headers = self._call(
            "PUT", path.lstrip("/"), body=data,
            headers={"x-ms-blob-type": "BlockBlob",
                     "Content-Type": "application/octet-stream"})
        return RemoteFile(path=path.lstrip("/"), size=len(data),
                          mtime=int(time.time()),
                          etag=resp_headers.get("Etag", ""))

    def remove_file(self, path: str) -> None:
        self._call("DELETE", path.lstrip("/"), ok=(200, 202, 404))

    def stat(self, path: str) -> Optional[RemoteFile]:
        status, _, h = self._call("HEAD", path.lstrip("/"),
                                  ok=(200, 404))
        if status == 404:
            return None
        return RemoteFile(path=path.lstrip("/"),
                          size=int(h.get("Content-Length", 0)),
                          mtime=0, etag=h.get("Etag", ""))


class MiniAzureServer:
    """In-process Blob endpoint for tests: verifies the SharedKey
    signature and keeps blobs in memory."""

    def __init__(self, account: str = "devaccount",
                 key_b64: str = ""):
        from seaweedfs_tpu_torch.utils.httpd import HttpServer, Response
        self.account = account
        self.key_b64 = key_b64 or base64.b64encode(b"devkey").decode()
        self.blobs: dict[str, dict[str, bytes]] = {}
        self._response_cls = Response
        self.http = HttpServer("127.0.0.1", 0)
        self.http.add("GET", r"/([^/?]+)$", self._list)
        self.http.add("PUT", r"/([^/?]+)/(.+)$", self._put)
        self.http.add("GET", r"/([^/?]+)/(.+)$", self._get)
        self.http.add("HEAD", r"/([^/?]+)/(.+)$", self._get)
        self.http.add("DELETE", r"/([^/?]+)/(.+)$", self._delete)

    def start(self):
        self.http.start()
        return self

    def stop(self):
        self.http.stop()

    @property
    def url(self) -> str:
        return f"http://{self.http.host}:{self.http.port}"

    def _authed(self, req, method: str) -> bool:
        auth = req.headers.get("Authorization", "")
        if not auth.startswith("SharedKey "):
            return False
        try:
            account, their_sig = auth[len("SharedKey "):].split(":", 1)
        except ValueError:
            return False
        if account != self.account:
            return False
        lower = {k.lower(): v for k, v in req.headers.items()}
        if req.body:
            lower["content-length"] = str(len(req.body))
        path = urllib.parse.quote(req.path)
        ours = shared_key_signature(self.account, self.key_b64, method,
                                    path, req.query, lower)
        return hmac.compare_digest(ours, their_sig)

    def _deny(self):
        return self._response_cls(b"<Error>AuthenticationFailed</Error>",
                                  status=403,
                                  content_type="application/xml")

    def _put(self, req):
        if not self._authed(req, "PUT"):
            return self._deny()
        container, blob = req.match.group(1), req.match.group(2)
        self.blobs.setdefault(container, {})[blob] = req.body or b""
        return self._response_cls(
            b"", status=201,
            headers={"Etag": f'"{hashlib.md5(req.body or b"").hexdigest()}"'})

    def _get(self, req):
        if not self._authed(req, req.method):
            return self._deny()
        container, blob = req.match.group(1), req.match.group(2)
        data = self.blobs.get(container, {}).get(blob)
        if data is None:
            return self._response_cls(b"", status=404)
        rng = req.headers.get("Range", "")
        status = 200
        if rng.startswith("bytes="):
            lo_s, _, hi_s = rng[len("bytes="):].partition("-")
            lo = int(lo_s)
            hi = int(hi_s) + 1 if hi_s else len(data)
            data, status = data[lo:hi], 206
        body = b"" if req.method == "HEAD" else data
        return self._response_cls(
            body, status=status,
            headers={"Content-Length": str(len(data)),
                     "Etag": f'"{hashlib.md5(data).hexdigest()}"'})

    def _delete(self, req):
        if not self._authed(req, "DELETE"):
            return self._deny()
        container, blob = req.match.group(1), req.match.group(2)
        existed = self.blobs.get(container, {}).pop(blob, None)
        return self._response_cls(
            b"", status=202 if existed is not None else 404)

    def _list(self, req):
        if req.query.get("comp") != "list":
            return self._response_cls(b"", status=400)
        if not self._authed(req, "GET"):
            return self._deny()
        container = req.match.group(1)
        prefix = req.query.get("prefix", "")
        root = ET.Element("EnumerationResults")
        blobs_el = ET.SubElement(root, "Blobs")
        for name, data in sorted(self.blobs.get(container, {}).items()):
            if not name.startswith(prefix):
                continue
            b = ET.SubElement(blobs_el, "Blob")
            ET.SubElement(b, "Name").text = name
            props = ET.SubElement(b, "Properties")
            ET.SubElement(props, "Content-Length").text = str(len(data))
            ET.SubElement(props, "Etag").text = \
                f'"{hashlib.md5(data).hexdigest()}"'
        ET.SubElement(root, "NextMarker")
        return self._response_cls(ET.tostring(root),
                                  content_type="application/xml")
