"""IAM API: users / access keys / policies persisted in the filer.

Functional equivalent of reference weed/iamapi: an AWS-IAM-flavored REST
endpoint (form-encoded Action=...) whose state lives at
/etc/iam/identity.json inside the filer, shared with the S3 gateway's
credential check (reference iamapi_server.go + s3api auth_credentials.go).

The port's copy of seaweedfs_tpu/gateway/iam_server.py, the same code
with its imports pointed at the port; it imports nothing of that
package. It takes no device.
"""

from __future__ import annotations

import json
import secrets
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Optional

from seaweedfs_tpu_torch.utils import clockctl, tracing
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.utils.httpd import HttpServer, Request, Response
from seaweedfs_tpu_torch.utils.resilience import Deadline, deadline_scope

IDENTITY_PATH = "/etc/iam/identity.json"

# edge budget when the client didn't propagate one
IAM_DEADLINE_S = 10.0


class IdentityStore:
    """Load/save the identity file in the filer."""

    def __init__(self, filer: Filer):
        self.filer = filer

    def load(self) -> dict:
        entry = self.filer.find_entry(IDENTITY_PATH)
        if entry is None or not entry.content:
            return {"identities": []}
        return json.loads(entry.content)

    def save(self, conf: dict) -> None:
        data = json.dumps(conf, indent=2).encode()
        now = clockctl.now()
        self.filer.create_entry(Entry(
            full_path=IDENTITY_PATH,
            attr=Attr(mtime=now, crtime=now, mime="application/json",
                      file_size=len(data)),
            content=data))

    def find_by_access_key(self, access_key: str) -> Optional[dict]:
        for ident in self.load()["identities"]:
            for cred in ident.get("credentials", []):
                if cred["accessKey"] == access_key:
                    return {**ident, "secretKey": cred["secretKey"]}
        return None


class IamServer:
    def __init__(self, filer_server, host: str = "127.0.0.1", port: int = 0,
                 tracing_enabled: bool = True,
                 trace_sample: float = 0.01):
        self.store = IdentityStore(filer_server.filer)
        self.http = HttpServer(host, port)
        # continue inbound X-Weed-Trace at this edge so identity writes
        # that reach the filer/volume tier stay on the caller's trace
        self.tracer = tracing.Tracer(
            node=f"iam@{host}:{port}", enabled=tracing_enabled,
            sample_rate=trace_sample)
        self.http.tracer = self.tracer
        # RED on the main port: the IAM API is action-parameter based
        # (POST/GET "/"), so reserved GET paths can't shadow anything
        from seaweedfs_tpu_torch.utils.metrics import Registry, RedRecorder
        self.metrics = Registry()
        self.red = RedRecorder(self.metrics, "iam")
        self.http.red = self.red
        self.http.add(
            "GET", "/metrics",
            lambda req: Response(self.metrics.expose_text(),
                                 content_type="text/plain; version=0.0.4"))
        self.http.add("GET", "/admin/telemetry", self._handle_telemetry)
        self.http.add("POST", "/", self._handle)
        self.http.add("GET", "/", self._handle)

    def start(self) -> None:
        self.http.start()

    def stop(self) -> None:
        self.http.stop()
        self.metrics.stop_push()

    @property
    def url(self) -> str:
        return f"{self.http.host}:{self.http.port}"

    def telemetry_snapshot(self) -> dict:
        return {"node": self.url, "server": "iam",
                "red": self.red.snapshot()}

    def _handle_telemetry(self, req: Request) -> Response:
        return Response(self.telemetry_snapshot())

    def _handle(self, req: Request) -> Response:
        params = dict(req.query)
        if req.body:
            params.update({
                k: v[0] for k, v in urllib.parse.parse_qs(
                    req.body.decode()).items()})
        action = params.get("Action", "")
        fn = getattr(self, f"_do_{action}", None)
        if fn is None:
            return _iam_err("InvalidAction", action, 400)
        # edge deadline: identity reads/writes that reach the filer (and
        # its volume-ward calls) inherit the caller's remaining budget
        with deadline_scope(Deadline.from_headers(req.headers,
                                                  default=IAM_DEADLINE_S)):
            return fn(params)

    # ---- actions ----
    def _do_CreateUser(self, p) -> Response:
        name = p["UserName"]
        conf = self.store.load()
        if any(i["name"] == name for i in conf["identities"]):
            return _iam_err("EntityAlreadyExists", name, 409)
        conf["identities"].append(
            {"name": name, "credentials": [], "actions": ["Read", "Write"]})
        self.store.save(conf)
        return _iam_ok("CreateUser", {"User": {"UserName": name}})

    def _do_ListUsers(self, p) -> Response:
        conf = self.store.load()
        return _iam_ok("ListUsers", {
            "Users": [{"UserName": i["name"]} for i in conf["identities"]]})

    def _do_DeleteUser(self, p) -> Response:
        name = p["UserName"]
        conf = self.store.load()
        before = len(conf["identities"])
        conf["identities"] = [i for i in conf["identities"]
                              if i["name"] != name]
        if len(conf["identities"]) == before:
            return _iam_err("NoSuchEntity", name, 404)
        self.store.save(conf)
        return _iam_ok("DeleteUser", {})

    def _do_CreateAccessKey(self, p) -> Response:
        name = p["UserName"]
        conf = self.store.load()
        for ident in conf["identities"]:
            if ident["name"] == name:
                cred = {"accessKey": "AKID" + secrets.token_hex(8).upper(),
                        "secretKey": secrets.token_urlsafe(30)}
                ident.setdefault("credentials", []).append(cred)
                self.store.save(conf)
                return _iam_ok("CreateAccessKey", {"AccessKey": {
                    "UserName": name, "AccessKeyId": cred["accessKey"],
                    "SecretAccessKey": cred["secretKey"],
                    "Status": "Active"}})
        return _iam_err("NoSuchEntity", name, 404)

    def _do_DeleteAccessKey(self, p) -> Response:
        akid = p["AccessKeyId"]
        conf = self.store.load()
        for ident in conf["identities"]:
            creds = ident.get("credentials", [])
            kept = [c for c in creds if c["accessKey"] != akid]
            if len(kept) != len(creds):
                ident["credentials"] = kept
                self.store.save(conf)
                return _iam_ok("DeleteAccessKey", {})
        return _iam_err("NoSuchEntity", akid, 404)

    def _do_PutUserPolicy(self, p) -> Response:
        name = p["UserName"]
        conf = self.store.load()
        for ident in conf["identities"]:
            if ident["name"] == name:
                ident["policy"] = p.get("PolicyDocument", "")
                self.store.save(conf)
                return _iam_ok("PutUserPolicy", {})
        return _iam_err("NoSuchEntity", name, 404)

    def _do_GetUserPolicy(self, p) -> Response:
        name = p["UserName"]
        for ident in self.store.load()["identities"]:
            if ident["name"] == name:
                return _iam_ok("GetUserPolicy", {
                    "UserName": name,
                    "PolicyDocument": ident.get("policy", "")})
        return _iam_err("NoSuchEntity", name, 404)


def _dict_to_xml(parent: ET.Element, data) -> None:
    if isinstance(data, dict):
        for k, v in data.items():
            child = ET.SubElement(parent, k)
            _dict_to_xml(child, v)
    elif isinstance(data, list):
        for item in data:
            child = ET.SubElement(parent, "member")
            _dict_to_xml(child, item)
    else:
        parent.text = str(data)


def _iam_ok(action: str, payload: dict) -> Response:
    root = ET.Element(f"{action}Response")
    result = ET.SubElement(root, f"{action}Result")
    _dict_to_xml(result, payload)
    meta = ET.SubElement(root, "ResponseMetadata")
    ET.SubElement(meta, "RequestId").text = secrets.token_hex(8)
    return Response(
        b'<?xml version="1.0"?>' + ET.tostring(root),
        content_type="application/xml")


def _iam_err(code: str, message: str, status: int) -> Response:
    root = ET.Element("ErrorResponse")
    err = ET.SubElement(root, "Error")
    ET.SubElement(err, "Code").text = code
    ET.SubElement(err, "Message").text = message
    return Response(b'<?xml version="1.0"?>' + ET.tostring(root),
                    status=status, content_type="application/xml")
