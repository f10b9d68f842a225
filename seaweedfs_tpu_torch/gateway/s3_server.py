"""S3-compatible gateway over the filer namespace.

Functional equivalent of (a subset of) reference weed/s3api: bucket CRUD,
object PUT/GET/HEAD/DELETE, ListObjects V1+V2, ListBuckets, multipart
uploads (init/part/complete/abort — completion composes the parts' chunk
lists without copying data, like reference s3api/filer_multipart.go),
CopyObject (chunk-list compose, s3api_object_copy_handlers.go), object
tagging (s3api_object_tagging_handlers.go; tags live in entry.extended
with the reference's "Seaweed-x-amz-tagging-" convention), POST policy
form uploads (s3api_object_handlers_postpolicy.go), a circuit breaker
(global/bucket concurrent-request limits, s3api_circuit_breaker.go), ACL
/ location / versioning stubs, and AWS SigV4 verification — both the
Authorization header and presigned X-Amz-Signature query forms
(auth_signature_v4.go) — with anonymous access when no credentials are
configured.

Buckets live at /buckets/<name> in the filer (reference filer_buckets.go).

The port's copy of seaweedfs_tpu/gateway/s3_server.py, the same code
with its imports pointed at the port; it imports nothing of that
package. It takes no device and imports no torch: the card is reached
through the volume servers that hold the objects' chunks.
"""

from __future__ import annotations

import base64
import calendar
import hashlib
import hmac
import json
import re
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from typing import Optional

from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.qos import INTERACTIVE, WRITE, QosGovernor
from seaweedfs_tpu_torch.utils import glog, profiler, tracing
from seaweedfs_tpu_torch.utils.httpd import HttpServer, Request, Response

BUCKETS_PATH = "/buckets"
UPLOADS_PATH = "/buckets/.uploads"
TAG_PREFIX = "Seaweed-x-amz-tagging-"


class CircuitBreaker:
    """Concurrent-request limiter (reference s3api_circuit_breaker.go).

    Limits are counts of simultaneous read/write requests, globally and
    per bucket; exceeding one returns 503 TooManyRequests. Byte limits
    from the reference are a plug point (our handlers buffer bodies, so
    count limits dominate).
    """

    def __init__(self, global_read: int = 0, global_write: int = 0,
                 buckets: Optional[dict] = None):
        # 0 = unlimited, matching the reference's "absent action" default
        self.global_limits = {"Read": global_read, "Write": global_write}
        self.bucket_limits = buckets or {}  # bucket -> {"Read": n, ...}
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def _keys(self, bucket: str, action: str):
        return [("", action), (bucket, action)] if bucket else [("", action)]

    def _limit(self, bucket: str, action: str) -> int:
        if bucket:
            return int(self.bucket_limits.get(bucket, {}).get(action, 0))
        return int(self.global_limits.get(action, 0))

    def acquire(self, bucket: str, action: str) -> bool:
        with self._lock:
            for b, a in self._keys(bucket, action):
                limit = self._limit(b, a)
                if limit and self._counts.get((b, a), 0) >= limit:
                    return False
            for key in self._keys(bucket, action):
                self._counts[key] = self._counts.get(key, 0) + 1
            return True

    def release(self, bucket: str, action: str) -> None:
        with self._lock:
            for key in self._keys(bucket, action):
                self._counts[key] = max(0, self._counts.get(key, 0) - 1)


def _xml(root: ET.Element) -> bytes:
    return (b'<?xml version="1.0" encoding="UTF-8"?>'
            + ET.tostring(root))


def _err(code: str, message: str, status: int) -> Response:
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = code
    ET.SubElement(root, "Message").text = message
    return Response(_xml(root), status=status, content_type="application/xml")


class S3Server:
    def __init__(self, filer_server, host: str = "127.0.0.1", port: int = 0,
                 access_key: str = "", secret_key: str = "",
                 circuit_breaker: Optional[CircuitBreaker] = None,
                 qos: bool = True,
                 tracing_enabled: bool = True,
                 trace_sample: float = 0.01,
                 profile_hz: float = profiler.DEFAULT_HZ):
        # filer_server: in-process FilerServer (gateway composes chunk
        # lists directly; the data path still flows through volume servers)
        self.fs = filer_server
        self.filer: Filer = filer_server.filer
        self.access_key = access_key
        self.secret_key = secret_key
        self.breaker = circuit_breaker or CircuitBreaker()
        from seaweedfs_tpu_torch.gateway.iam_server import IdentityStore
        self._identities = IdentityStore(self.filer)
        # reference stats/metrics.go s3 subsystem: per-action request
        # counter + latency histogram (action = the S3 operation class)
        from seaweedfs_tpu_torch.utils.metrics import Registry
        self.metrics = Registry()
        self._m_req = self.metrics.counter(
            "s3", "request_total", "s3 requests", ("action", "bucket"))
        self._m_lat = self.metrics.histogram(
            "s3", "request_seconds", "s3 request latency", ("action",))
        self.http = HttpServer(host, port)
        # metrics ride a dedicated listener (reference -metricsPort):
        # the public port is all bucket namespace (this server does not
        # validate bucket names, so no path is safely reservable) and
        # the exposition would leak bucket names/traffic to
        # unauthenticated clients
        self.metrics_http = HttpServer(host, 0)
        self.metrics_http.add("GET", "/metrics", self._handle_metrics)
        # gateway-edge admission: class-weighted adaptive concurrency
        # (GET/HEAD = interactive, everything else = write) plus
        # per-tenant buckets keyed by the request's access key.
        # qos=False is the bit-for-bit comparator switch.
        self.qos = QosGovernor(metrics=self.metrics, enabled=qos)
        # operator surface rides the private metrics listener — every
        # path on the public port is bucket namespace
        self.metrics_http.add("GET", "/admin/qos", self._handle_qos)
        self.metrics_http.add("POST", "/admin/qos",
                              self._handle_qos_configure)
        # tracing: spans mint on the public port's dispatch; the flight
        # recorder rides the private listener like /metrics (the public
        # port is all bucket namespace and must not leak trace data)
        self.tracer = tracing.Tracer(
            node=f"s3@{host}:{port}", enabled=tracing_enabled,
            sample_rate=trace_sample)
        self.http.tracer = self.tracer
        self.metrics_http.tracer = self.tracer
        # cluster telemetry plane: RED histogram on the public port's
        # dispatch + hot path/tenant sketches on the private listener
        # (same reasoning as /metrics: bucket names must not leak)
        from seaweedfs_tpu_torch.stats.hotkeys import HotKeys
        from seaweedfs_tpu_torch.utils.metrics import RedRecorder
        self.red = RedRecorder(self.metrics, "s3")
        self.http.red = self.red
        self.hotkeys = HotKeys(dims=("path", "tenant"))
        # volume_redirect=False relays every object GET through the
        # gateway + filer — the bit-identity comparator for the 302
        # volume-direct path (both this flag AND the filer's must be
        # on for the gateway to redirect)
        self.volume_redirect = True
        self.metrics_http.add("GET", "/admin/hotkeys",
                              self.hotkeys.handler(self.url))
        self.metrics_http.add("GET", "/admin/telemetry",
                              self._handle_telemetry)
        # continuous profiling + per-(class, tenant) ledger. Tenant at
        # the gateway = the request's ACCESS KEY (same identity the
        # governor buckets on), so /cluster/telemetry chargeback rows
        # name S3 principals, not NAT'd client IPs. /admin/profile
        # rides the private listener like /metrics.
        from seaweedfs_tpu_torch.stats.ledger import ResourceLedger
        self.sampler = profiler.WallSampler(hz=profile_hz)
        self.ledger = ResourceLedger()
        self.http.ledger = self.ledger
        self.http.tenant_fn = self._tenant_from_headers
        self.metrics_http.add("GET", "/admin/profile",
                              profiler.make_profile_handler(
                                  self.sampler, lambda: self.url,
                                  "s3"))
        from seaweedfs_tpu_torch.utils.debug import install_debug_routes
        install_debug_routes(self.metrics_http)
        self._register_routes()

    def start(self) -> None:
        self.http.start()
        self.metrics_http.start()
        self.sampler.start()
        self.tracer.node = f"s3@{self.http.host}:{self.http.port}"
        glog.info("s3 gateway up at %s (metrics=%s)", self.url,
                  self.metrics_url)
        # announce to the master like a filer does, so the cluster
        # telemetry aggregator can pull this gateway's RED/hotkeys
        # snapshots from the private metrics listener (skipped in
        # gateway mode, where the filer itself doesn't register either)
        if getattr(self.fs, "announce", True):
            import threading
            self._announce_stop = threading.Event()
            threading.Thread(target=self._announce_loop,
                             name="s3-announce", daemon=True).start()

    def _announce_loop(self) -> None:
        from seaweedfs_tpu_torch.utils.httpd import http_json

        def announce():
            try:
                http_json("POST",
                          f"http://{self.fs.master_url}/cluster/register",
                          {"type": "s3", "url": self.url,
                           "metrics_url": self.metrics_url}, timeout=5)
            except Exception as e:
                glog.vlog(1, "s3 announce to master %s failed: %s",
                          self.fs.master_url, e)

        announce()
        while not self._announce_stop.wait(15.0):
            announce()

    def stop(self) -> None:
        self.sampler.stop()
        if hasattr(self, "_announce_stop"):
            self._announce_stop.set()
        self.http.stop()
        self.metrics_http.stop()
        self.metrics.stop_push()

    @property
    def url(self) -> str:
        return f"{self.http.host}:{self.http.port}"

    @property
    def metrics_url(self) -> str:
        return f"{self.metrics_http.host}:{self.metrics_http.port}"

    # ---- routing ----
    def _register_routes(self) -> None:
        r = self.http.add
        r("GET", "/", self._list_buckets)
        for m in ("GET", "PUT", "DELETE", "HEAD", "POST"):
            r(m, r"/([^/]+)", self._bucket_dispatch)
            r(m, r"/([^/]+)/(.+)", self._object_dispatch)

    def _handle_metrics(self, req: Request) -> Response:
        return Response(self.metrics.expose_text(),
                        content_type="text/plain; version=0.0.4")

    def telemetry_snapshot(self) -> dict:
        snap = {"node": self.url, "server": "s3",
                "red": self.red.snapshot(),
                "hotkeys": self.hotkeys.snapshot(),
                "ledger": self.ledger.snapshot()}
        # S3 HEAD-heavy traffic is the negative-lookup cache's reason
        # to exist — surface its hit rates where operators look
        if self.filer.entry_cache is not None:
            snap["entry_cache"] = self.filer.entry_cache.snapshot()
        return snap

    def _handle_telemetry(self, req: Request) -> Response:
        return Response(self.telemetry_snapshot())

    # ---- QoS admission ----
    def _handle_qos(self, req: Request) -> Response:
        return Response({"url": self.url, **self.qos.snapshot()})

    def _handle_qos_configure(self, req: Request) -> Response:
        return Response({"url": self.url,
                         **self.qos.configure(**(req.json() or {}))})

    @staticmethod
    def _tenant_from_headers(headers, client_ip: str) -> str:
        """HttpServer.tenant_fn: ledger row identity from the SigV4
        Authorization credential, client IP for anonymous traffic
        (same keying as _tenant_of minus the presigned-query form,
        which the dispatch hook can't see)."""
        auth = headers.get("Authorization", "") or ""
        if auth.startswith("AWS4-HMAC-SHA256 "):
            m = re.search(r"Credential=([^/,]+)", auth)
            if m:
                return m.group(1)
        return client_ip

    @staticmethod
    def _tenant_of(req: Request) -> str:
        """Bucket key for per-tenant quotas: the request's access key
        (unverified — a wrong signature still *bills* that key's bucket
        and then fails auth), falling back to client IP for anonymous
        traffic."""
        auth = req.headers.get("Authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256 "):
            m = re.search(r"Credential=([^/,]+)", auth)
            if m:
                return m.group(1)
        cred = req.query.get("X-Amz-Credential", "")
        if cred:
            return cred.split("/")[0]
        if req.handler is not None:
            return req.handler.client_address[0]
        return "anonymous"

    def _admit(self, req: Request):
        """(release_fn, None) when admitted, (None, Response) on shed.
        Runs BEFORE signature verification: an overloaded gateway
        sheds without paying the HMAC cost."""
        cls = INTERACTIVE if req.method in ("GET", "HEAD") else WRITE
        grant = self.qos.admit(cls, tenant=self._tenant_of(req))
        if grant.ok:
            return grant.release, None
        resp = _err("SlowDown", "reduce your request rate", 503)
        resp.headers["Retry-After"] = f"{grant.retry_after:.2f}"
        return None, resp

    # ---- auth (SigV4 subset; static key or IAM identities) ----
    def _secret_for(self, access_key: str) -> Optional[str]:
        if self.access_key and access_key == self.access_key:
            return self.secret_key
        ident = self._identities.find_by_access_key(access_key)
        return ident["secretKey"] if ident else None

    def _auth_required(self) -> bool:
        if self.access_key:
            return True
        return bool(self._identities.load()["identities"])

    @staticmethod
    def _signing_key(secret: str, date: str, region: str,
                     service: str) -> bytes:
        from seaweedfs_tpu_torch.utils import sigv4
        return sigv4.signing_key(secret, date, region, service)

    @staticmethod
    def _sig_v4(secret: str, date: str, region: str, service: str,
                amz_date: str, method: str, path: str,
                query: dict, headers, signed_headers: list[str],
                payload_hash: str) -> str:
        # single shared canonicalization — the remote-storage S3 client
        # signs with the SAME function (utils/sigv4.py)
        from seaweedfs_tpu_torch.utils import sigv4
        return sigv4.signature(secret, date, region, service, amz_date,
                               method, path, query, headers,
                               signed_headers, payload_hash)

    def _check_presigned(self, req: Request) -> Optional[Response]:
        """Presigned-URL (query-string) SigV4, reference
        auth_signature_v4.go doesPresignedSignatureMatch."""
        try:
            cred = req.query["X-Amz-Credential"].split("/")
            akey, date, region, service = cred[0], cred[1], cred[2], cred[3]
            secret = self._secret_for(akey)
            if secret is None:
                return _err("InvalidAccessKeyId", "unknown key", 403)
            amz_date = req.query.get("X-Amz-Date", "")
            expires = int(req.query.get("X-Amz-Expires", "900"))
            t = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
            if time.time() - t > expires:  # X-Amz-Date is an absolute epoch
                return _err("AccessDenied", "request has expired", 403)
            signed_headers = req.query["X-Amz-SignedHeaders"].split(";")
            query = {k: v for k, v in req.query.items()
                     if k != "X-Amz-Signature"}
            sig = self._sig_v4(secret, date, region, service, amz_date,
                               req.method, req.raw_path, query, req.headers,
                               signed_headers, "UNSIGNED-PAYLOAD")
            if not hmac.compare_digest(sig, req.query["X-Amz-Signature"]):
                return _err("SignatureDoesNotMatch", "bad signature", 403)
        except (KeyError, IndexError, ValueError):
            return _err("AccessDenied", "malformed presigned request", 403)
        return None

    def _check_auth(self, req: Request) -> Optional[Response]:
        if not self._auth_required():
            return None  # anonymous allowed
        if "X-Amz-Signature" in req.query:
            return self._check_presigned(req)
        auth = req.headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return _err("AccessDenied", "missing signature", 403)
        try:
            parts = dict(p.strip().split("=", 1)
                         for p in auth[len("AWS4-HMAC-SHA256 "):].split(","))
            cred = parts["Credential"].split("/")
            akey, date, region, service = cred[0], cred[1], cred[2], cred[3]
            secret = self._secret_for(akey)
            if secret is None:
                return _err("InvalidAccessKeyId", "unknown key", 403)
            signed_headers = parts["SignedHeaders"].split(";")
            payload_hash = req.headers.get("x-amz-content-sha256",
                                           "UNSIGNED-PAYLOAD")
            sig = self._sig_v4(secret, date, region, service,
                               req.headers.get("x-amz-date", ""),
                               req.method, req.raw_path, req.query, req.headers,
                               signed_headers, payload_hash)
            if not hmac.compare_digest(sig, parts["Signature"]):
                return _err("SignatureDoesNotMatch", "bad signature", 403)
        except (KeyError, IndexError, ValueError):
            return _err("AccessDenied", "malformed authorization", 403)
        return None

    # ---- buckets ----
    def _list_buckets(self, req: Request) -> Response:
        denied = self._check_auth(req)
        if denied:
            return denied
        root = ET.Element("ListAllMyBucketsResult")
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "seaweedfs-tpu"
        buckets = ET.SubElement(root, "Buckets")
        for e in self.filer.list_entries(BUCKETS_PATH):
            if not e.is_directory or e.name.startswith("."):
                continue
            b = ET.SubElement(buckets, "Bucket")
            ET.SubElement(b, "Name").text = e.name
            ET.SubElement(b, "CreationDate").text = _iso(e.attr.crtime)
        return Response(_xml(root), content_type="application/xml")

    def _bucket_dispatch(self, req: Request) -> Response:
        release, shed = self._admit(req)
        if shed is not None:
            return shed
        try:
            return self._bucket_dispatch_inner(req)
        finally:
            release()

    def _bucket_dispatch_inner(self, req: Request) -> Response:
        bucket = req.match.group(1)
        if req.method == "POST" and "delete" not in req.query:
            ctype = req.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                # POST policy uploads authenticate via the signed policy
                # document itself, not the Authorization header
                return self._post_policy_upload(req, bucket, ctype)
        denied = self._check_auth(req)
        if denied:
            return denied
        # count only after auth: unauthenticated probes of random
        # bucket names must not mint unbounded label cardinality
        self._m_req.inc(f"Bucket{req.method.capitalize()}", bucket)
        if req.method == "PUT":
            self.filer.mkdirs(f"{BUCKETS_PATH}/{bucket}")
            return Response(b"", content_type="application/xml")
        if req.method == "DELETE":
            try:
                self.filer.delete_entry(f"{BUCKETS_PATH}/{bucket}",
                                        recursive=True)
            except FileNotFoundError:
                return _err("NoSuchBucket", bucket, 404)
            return Response(b"", status=204, content_type="application/xml")
        if req.method in ("GET", "HEAD"):
            if self.filer.find_entry(f"{BUCKETS_PATH}/{bucket}") is None:
                return _err("NoSuchBucket", bucket, 404)
            if req.method == "HEAD":
                return Response(b"", content_type="application/xml")
            if "location" in req.query:
                root = ET.Element("LocationConstraint")
                return Response(_xml(root), content_type="application/xml")
            if "versioning" in req.query:
                # unversioned, like the reference's stub
                root = ET.Element("VersioningConfiguration")
                return Response(_xml(root), content_type="application/xml")
            if "acl" in req.query:
                return self._acl_response()
            if "uploads" in req.query:
                return self._list_multipart_uploads(bucket)
            return self._list_objects(req, bucket)
        if req.method == "POST" and "delete" in req.query:
            return self._delete_objects(req, bucket)
        return _err("MethodNotAllowed", req.method, 405)

    def _acl_response(self) -> Response:
        """Canned FULL_CONTROL owner ACL — the reference's ACL handlers
        are stubs too (s3api_bucket_handlers.go GetBucketAclHandler)."""
        root = ET.Element("AccessControlPolicy")
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "seaweedfs-tpu"
        acl = ET.SubElement(root, "AccessControlList")
        grant = ET.SubElement(acl, "Grant")
        grantee = ET.SubElement(grant, "Grantee")
        ET.SubElement(grantee, "ID").text = "seaweedfs-tpu"
        ET.SubElement(grant, "Permission").text = "FULL_CONTROL"
        return Response(_xml(root), content_type="application/xml")

    def _list_multipart_uploads(self, bucket: str) -> Response:
        root = ET.Element("ListMultipartUploadsResult")
        ET.SubElement(root, "Bucket").text = bucket
        try:
            uploads = self.filer.list_entries(UPLOADS_PATH, limit=10000)
        except FileNotFoundError:
            uploads = []
        for e in uploads:
            meta = self.filer.find_entry(f"{UPLOADS_PATH}/{e.name}/.meta")
            if meta is None or meta.extended.get("bucket") != bucket:
                continue
            u = ET.SubElement(root, "Upload")
            ET.SubElement(u, "Key").text = meta.extended.get("key", "")
            ET.SubElement(u, "UploadId").text = e.name
            ET.SubElement(u, "Initiated").text = _iso(e.attr.crtime)
        return Response(_xml(root), content_type="application/xml")

    def _post_policy_upload(self, req: Request, bucket: str,
                            ctype: str) -> Response:
        """Browser POST form upload with policy (reference
        s3api_object_handlers_postpolicy.go). Verifies the policy
        signature (SigV4 over the base64 policy) then stores the file
        field under the form's key."""
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            return _err("MalformedPOSTRequest", "no boundary", 400)
        fields, file_data, file_name = _parse_multipart_form(
            req.body, m.group(1).encode())
        if self._auth_required():
            policy = fields.get("policy", "")
            akey_cred = fields.get("x-amz-credential", "")
            sig = fields.get("x-amz-signature", "")
            if not policy or not akey_cred:
                return _err("AccessDenied", "missing policy", 403)
            cred = akey_cred.split("/")
            try:
                akey, date, region, service = (cred[0], cred[1], cred[2],
                                               cred[3])
            except IndexError:
                return _err("AccessDenied", "malformed credential", 403)
            secret = self._secret_for(akey)
            if secret is None:
                return _err("InvalidAccessKeyId", "unknown key", 403)
            k = self._signing_key(secret, date, region, service)
            want = hmac.new(k, policy.encode(), hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, sig):
                return _err("SignatureDoesNotMatch", "bad signature", 403)
            try:
                pol = json.loads(base64.b64decode(policy))
                exp = pol.get("expiration", "")
                if exp:
                    stamp = exp.rstrip("Z").split(".")[0]
                    t = calendar.timegm(time.strptime(
                        stamp, "%Y-%m-%dT%H:%M:%S"))
                    if time.time() > t:  # policy expiry is an absolute epoch
                        return _err("AccessDenied", "policy expired", 403)
            except (ValueError, KeyError):
                return _err("MalformedPOSTRequest", "bad policy", 400)
        else:
            pol = None
        key = fields.get("key", "")
        if not key:
            return _err("InvalidArgument", "missing key field", 400)
        key = key.replace("${filename}", file_name or "file")
        if file_data is None:
            return _err("InvalidArgument", "missing file field", 400)
        if pol is not None:
            err = _check_policy_conditions(pol, bucket, key,
                                           len(file_data), fields)
            if err:
                return _err("AccessDenied", err, 403)
        resp, _etag = self._store_object(bucket, key, file_data,
                                         fields.get("Content-Type", ""))
        if resp is not None:
            return resp
        try:
            status = int(fields.get("success_action_status", "204"))
        except ValueError:
            status = 204
        if status not in (200, 201, 204):
            status = 204
        return Response(b"", status=status, content_type="application/xml")

    def _list_objects(self, req: Request, bucket: str) -> Response:
        prefix = req.query.get("prefix", "")
        delimiter = req.query.get("delimiter", "")
        max_keys = int(req.query.get("max-keys", 1000))
        v2 = req.query.get("list-type") == "2"
        if v2:
            start_after = req.query.get(
                "start-after", req.query.get("continuation-token", ""))
        else:
            start_after = req.query.get("marker", "")
        base = f"{BUCKETS_PATH}/{bucket}"

        keys: list[tuple[str, Entry]] = []
        prefixes: set[str] = set()
        self._walk(base, "", prefix, delimiter, keys, prefixes,
                   start_after, max_keys)

        root = ET.Element("ListBucketResult")
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = prefix
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        if v2:
            ET.SubElement(root, "KeyCount").text = str(len(keys))
        truncated = len(keys) >= max_keys
        ET.SubElement(root, "IsTruncated").text = \
            "true" if truncated else "false"
        if truncated and keys:
            if v2:
                ET.SubElement(root, "NextContinuationToken").text = \
                    keys[-1][0]
            else:
                ET.SubElement(root, "NextMarker").text = keys[-1][0]
        for key, e in keys:
            c = ET.SubElement(root, "Contents")
            ET.SubElement(c, "Key").text = key
            ET.SubElement(c, "LastModified").text = _iso(e.attr.mtime)
            ET.SubElement(c, "Size").text = str(e.file_size())
            ET.SubElement(c, "ETag").text = f'"{e.attr.md5.hex()}"'
            ET.SubElement(c, "StorageClass").text = "STANDARD"
        for p in sorted(prefixes):
            cp = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(cp, "Prefix").text = p
        return Response(_xml(root), content_type="application/xml")

    def _walk(self, base, rel, prefix, delimiter, keys, prefixes,
              start_after, max_keys):
        if len(keys) >= max_keys:
            return
        for e in self.filer.list_entries(base + ("/" + rel if rel else ""),
                                         limit=1 << 20):
            key = f"{rel}/{e.name}" if rel else e.name
            if e.is_directory:
                if prefix and not (key + "/").startswith(prefix) \
                        and not prefix.startswith(key + "/"):
                    continue
                if delimiter == "/" and key.startswith(prefix):
                    # collapse under a common prefix
                    tail = key[len(prefix):]
                    if "/" not in tail:
                        prefixes.add(key + "/")
                        continue
                self._walk(base, key, prefix, delimiter, keys, prefixes,
                           start_after, max_keys)
            else:
                if prefix and not key.startswith(prefix):
                    continue
                if start_after and key <= start_after:
                    continue
                keys.append((key, e))
                if len(keys) >= max_keys:
                    return

    def _delete_objects(self, req: Request, bucket: str) -> Response:
        body = ET.fromstring(req.body)
        ns = ""
        if body.tag.startswith("{"):
            ns = body.tag.split("}")[0] + "}"
        root = ET.Element("DeleteResult")
        for obj in body.findall(f"{ns}Object"):
            key = obj.find(f"{ns}Key").text
            try:
                self.filer.delete_entry(f"{BUCKETS_PATH}/{bucket}/{key}")
                d = ET.SubElement(root, "Deleted")
                ET.SubElement(d, "Key").text = key
            except (FileNotFoundError, OSError):
                d = ET.SubElement(root, "Error")
                ET.SubElement(d, "Key").text = key
        return Response(_xml(root), content_type="application/xml")

    # ---- circuit-breaker hot-reload ----
    CB_PATH = "/etc/s3/circuit_breaker"
    CB_TTL = 2.0

    def _refresh_breaker(self) -> None:
        """Hot-reload /etc/s3/circuit_breaker (proto bytes,
        weedtpu_s3_pb.S3CircuitBreakerConfig — reference
        s3api_circuit_breaker.go loads the same message from the
        filer) at most every CB_TTL seconds, mtime-gated."""
        now = clockctl.now()
        next_at, seen_mtime = getattr(self, "_cb_state", (0.0, -1.0))
        if now < next_at:
            return
        self._cb_state = (now + self.CB_TTL, seen_mtime)
        entry = self.filer.find_entry(self.CB_PATH)
        mtime = entry.attr.mtime if entry is not None else 0.0
        if mtime == seen_mtime:
            return
        self._cb_state = (now + self.CB_TTL, mtime)
        # full entry read, not entry.content — a config big enough to
        # chunk (or on a cipher-enabled filer) has empty inline content
        data = self.fs._read_entry_bytes(entry) if entry is not None else b""
        if not data:
            if seen_mtime > 0:
                # config entry deleted after having existed: drop limits.
                # A missing entry on first look leaves constructor-
                # provided limits (still a public parameter) untouched.
                self.breaker.global_limits = {"Read": 0, "Write": 0}
                self.breaker.bucket_limits = {}
            return
        from seaweedfs_tpu_torch.pb import s3_pb2
        try:
            conf = s3_pb2.S3CircuitBreakerConfig.FromString(data)
        except Exception:
            return  # malformed config must not take the gateway down
        def limits(opts):
            if not opts.enabled:
                return {}
            return {a: int(n) for a, n in opts.actions.items()}
        self.breaker.global_limits = limits(conf.global_options)
        self.breaker.bucket_limits = {
            b: limits(o) for b, o in conf.buckets.items()}

    # ---- objects ----
    def _object_dispatch(self, req: Request) -> Response:
        release, shed = self._admit(req)
        if shed is not None:
            return shed
        try:
            denied = self._check_auth(req)
            if denied:
                return denied
            bucket, key = req.match.group(1), req.match.group(2)
            action = "Read" if req.method in ("GET", "HEAD") else "Write"
            self._m_req.inc(action, bucket)
            # hot-key sketches, post-auth for the same cardinality reason
            self.hotkeys.record("path", f"/{bucket}/{key}")
            self.hotkeys.record("tenant", self._tenant_of(req))
            self._refresh_breaker()
            if not self.breaker.acquire(bucket, action):
                return _err("TooManyRequests", "circuit breaker open", 503)
            try:
                with self._m_lat.time(action):
                    return self._object_dispatch_inner(req, bucket, key)
            finally:
                self.breaker.release(bucket, action)
        finally:
            release()

    def _object_dispatch_inner(self, req: Request, bucket: str,
                               key: str) -> Response:
        if "uploads" in req.query and req.method == "POST":
            return self._initiate_multipart(bucket, key)
        if "uploadId" in req.query:
            if req.method == "PUT":
                return self._upload_part(req, bucket, key)
            if req.method == "POST":
                return self._complete_multipart(req, bucket, key)
            if req.method == "DELETE":
                return self._abort_multipart(req, bucket, key)
            if req.method == "GET":
                return self._list_parts(req, bucket, key)
        if "tagging" in req.query:
            return self._object_tagging(req, bucket, key)
        if "acl" in req.query and req.method == "GET":
            return self._acl_response()
        path = f"{BUCKETS_PATH}/{bucket}/{key}"
        if req.method == "PUT":
            if req.headers.get("x-amz-copy-source"):
                return self._copy_object(req, bucket, key)
            return self._put_object(req, bucket, key)
        if req.method in ("GET", "HEAD"):
            entry = self.filer.find_entry(path)
            if entry is None or entry.is_directory:
                return _err("NoSuchKey", key, 404)
            if req.method == "HEAD":
                return Response(b"", headers={
                    "Content-Length": str(entry.file_size()),
                    "ETag": f'"{entry.attr.md5.hex()}"',
                    "Last-Modified": _http_date(entry.attr.mtime),
                })
            # zero-copy read plane: a single-chunk object's payload
            # skips the gateway+filer relay — 302 to the JWT-stamped
            # volume URL (which sendfiles it); http_call-based clients
            # follow transparently, re-sending Range at the target.
            # ?proxy=1 forces the relay (comparator/debug).
            if self.volume_redirect and self.fs.volume_redirect \
                    and req.query.get("proxy") != "1":
                loc = self.fs.volume_direct_url(entry)
                if loc is not None:
                    self._m_req.inc("ReadRedirect", bucket)
                    return Response(b"", status=302,
                                    content_type="application/xml",
                                    headers={"Location": loc})
            # edge deadline, same contract as the filer's GET: honor an
            # inbound X-Weed-Deadline (or mint the default) so chunk
            # fetches behind a dead volume server give up inside the
            # caller's budget instead of each burning a full timeout
            from seaweedfs_tpu_torch.server.filer_server import READ_DEADLINE_S
            from seaweedfs_tpu_torch.utils.resilience import (Deadline,
                                                        deadline_scope)
            from seaweedfs_tpu_torch.utils.httpd import (RangeNotSatisfiable,
                                                   parse_byte_range)
            total = entry.file_size()
            try:
                rng = parse_byte_range(req.headers.get("Range", ""),
                                       total)
            except RangeNotSatisfiable:
                resp = _err("InvalidRange",
                            "the requested range is not satisfiable", 416)
                resp.headers["Content-Range"] = f"bytes */{total}"
                return resp
            with deadline_scope(Deadline.from_headers(
                    req.headers, default=READ_DEADLINE_S)):
                if rng is not None:
                    # ranged GET assembles only the overlapping chunks
                    lo, hi = rng
                    piece = self.fs._read_entry_range(entry, lo,
                                                      hi - lo + 1)
                    return Response(piece, status=206,
                                    content_type=entry.attr.mime
                                    or "application/octet-stream",
                                    headers={"Content-Range":
                                             f"bytes {lo}-{hi}/{total}"})
                data = self.fs._read_entry_bytes(entry)
            return Response(data, content_type=entry.attr.mime
                            or "application/octet-stream",
                            headers={"ETag": f'"{entry.attr.md5.hex()}"'})
        if req.method == "DELETE":
            try:
                self.filer.delete_entry(path)
            except (FileNotFoundError, OSError):
                pass
            return Response(b"", status=204, content_type="application/xml")
        return _err("MethodNotAllowed", req.method, 405)

    def _put_object(self, req: Request, bucket: str, key: str) -> Response:
        """Object PUT rides the filer's streaming ingest: the body is
        chunked as it arrives (bounded memory — a 5GB upload costs ~3
        chunk buffers), with the md5 ETag folded in stream order.
        SigV4 stays compatible: the payload hash is taken from
        x-amz-content-sha256, never recomputed from the body."""
        tags = _parse_tag_header(req.headers.get("x-amz-tagging", ""))
        bucket_entry = self.filer.find_entry(f"{BUCKETS_PATH}/{bucket}")
        if bucket_entry is None:
            return _err("NoSuchBucket", bucket, 404)
        # quota is priced on the DECLARED length — the honest number
        # available before the body is consumed
        declared = int(req.headers.get("Content-Length") or 0)
        denied = self._check_quota(bucket, bucket_entry, declared)
        if denied is not None:
            return denied
        md5 = hashlib.md5()
        content, chunks, size = self.fs._ingest_body(
            req, bucket, self.fs.default_replication, hasher=md5)
        now = clockctl.now()
        entry = Entry(
            full_path=f"{BUCKETS_PATH}/{bucket}/{key}",
            attr=Attr(mtime=now, crtime=now,
                      mime=req.headers.get("Content-Type", ""),
                      file_size=size, md5=md5.digest(),
                      collection=bucket))
        for k, v in (tags or {}).items():
            entry.extended[TAG_PREFIX + k] = v
        entry.content = content
        entry.chunks = chunks
        self.filer.create_entry(entry)
        return Response(b"", headers={"ETag": f'"{md5.hexdigest()}"'})

    def _store_object(self, bucket: str, key: str, data: bytes,
                      mime: str, tags: Optional[dict] = None
                      ) -> tuple[Optional[Response], str]:
        """Create the object entry; returns (error Response or None,
        etag hex)."""
        bucket_entry = self.filer.find_entry(f"{BUCKETS_PATH}/{bucket}")
        if bucket_entry is None:
            return _err("NoSuchBucket", bucket, 404), ""
        denied = self._check_quota(bucket, bucket_entry, len(data))
        if denied is not None:
            return denied, ""
        md5 = hashlib.md5(data).digest()
        now = clockctl.now()
        entry = Entry(
            full_path=f"{BUCKETS_PATH}/{bucket}/{key}",
            attr=Attr(mtime=now, crtime=now, mime=mime,
                      file_size=len(data), md5=md5, collection=bucket))
        for k, v in (tags or {}).items():
            entry.extended[TAG_PREFIX + k] = v
        if len(data) <= 2048:
            entry.content = data
        else:
            entry.chunks = self.fs._upload_chunks(
                data, bucket, self.fs.default_replication)
        self.filer.create_entry(entry)
        return None, md5.hex()

    # bucket usage cache: bucket -> (expires, bytes). Quota checks walk
    # the subtree at most every TTL; successful writes bump the cached
    # figure so bursts can't overshoot by more than one TTL of writes.
    QUOTA_USAGE_TTL = 5.0

    def _check_quota(self, bucket: str, bucket_entry: Entry,
                     incoming: int) -> Optional[Response]:
        """Per-bucket size quota (reference
        shell command_s3_bucket_quota.go + s3api quota enforcement):
        quota_bytes rides the bucket entry's extended attrs."""
        raw = bucket_entry.extended.get("quota_bytes", b"")
        if isinstance(raw, bytes):
            raw = raw.decode() if raw else ""
        if not raw or int(raw) <= 0:
            return None
        quota = int(raw)
        if not hasattr(self, "_usage_cache"):
            self._usage_cache = {}
        now = clockctl.now()
        hit = self._usage_cache.get(bucket)
        if hit is None or hit[0] < now:
            used = self._subtree_size(f"{BUCKETS_PATH}/{bucket}")
            self._usage_cache[bucket] = [now + self.QUOTA_USAGE_TTL, used]
        entry = self._usage_cache[bucket]
        if entry[1] + incoming > quota:
            return _err("QuotaExceeded",
                        f"bucket quota of {quota} bytes exceeded", 403)
        entry[1] += incoming
        return None

    def _subtree_size(self, path: str) -> int:
        total = 0
        for e in self.filer.list_entries(path, limit=1 << 20):
            if e.is_directory:
                total += self._subtree_size(e.full_path)
            else:
                total += e.file_size()
        return total

    def _copy_object(self, req: Request, bucket: str, key: str) -> Response:
        """Server-side copy (reference s3api_object_copy_handlers.go
        CopyObjectHandler: re-reads and re-writes data, so deleting the
        source can never orphan the copy's chunks)."""
        src = urllib.parse.unquote(req.headers["x-amz-copy-source"])
        src = src.lstrip("/")
        try:
            src_bucket, src_key = src.split("/", 1)
        except ValueError:
            return _err("InvalidArgument", "bad copy source", 400)
        src_entry = self.filer.find_entry(
            f"{BUCKETS_PATH}/{src_bucket}/{src_key}")
        if src_entry is None or src_entry.is_directory:
            return _err("NoSuchKey", src, 404)
        if self.filer.find_entry(f"{BUCKETS_PATH}/{bucket}") is None:
            return _err("NoSuchBucket", bucket, 404)
        now = clockctl.now()
        entry = Entry(
            full_path=f"{BUCKETS_PATH}/{bucket}/{key}",
            attr=Attr(mtime=now, crtime=now, mime=src_entry.attr.mime,
                      file_size=src_entry.file_size(),
                      md5=src_entry.attr.md5, collection=bucket))
        if req.headers.get("x-amz-metadata-directive") == "REPLACE":
            tags = _parse_tag_header(req.headers.get("x-amz-tagging", ""))
            for k, v in tags.items():
                entry.extended[TAG_PREFIX + k] = v
        else:
            entry.extended = dict(src_entry.extended)
        if src_entry.content:
            entry.content = src_entry.content
        else:
            # data is re-uploaded so source delete can't orphan the copy
            data = self.fs._read_entry_bytes(src_entry)
            if not entry.attr.md5:
                # multipart-composed sources carry no plain md5
                entry.attr.md5 = hashlib.md5(data).digest()
            entry.chunks = self.fs._upload_chunks(
                data, bucket, self.fs.default_replication)
        self.filer.create_entry(entry)
        root = ET.Element("CopyObjectResult")
        ET.SubElement(root, "ETag").text = f'"{entry.attr.md5.hex()}"'
        ET.SubElement(root, "LastModified").text = _iso(now)
        return Response(_xml(root), content_type="application/xml")

    def _object_tagging(self, req: Request, bucket: str,
                        key: str) -> Response:
        """GET/PUT/DELETE ?tagging (reference
        s3api_object_tagging_handlers.go; tags in extended attrs)."""
        path = f"{BUCKETS_PATH}/{bucket}/{key}"
        entry = self.filer.find_entry(path)
        if entry is None or entry.is_directory:
            return _err("NoSuchKey", key, 404)
        if req.method == "GET":
            root = ET.Element("Tagging")
            tagset = ET.SubElement(root, "TagSet")
            for k, v in sorted(entry.extended.items()):
                if k.startswith(TAG_PREFIX):
                    t = ET.SubElement(tagset, "Tag")
                    ET.SubElement(t, "Key").text = k[len(TAG_PREFIX):]
                    ET.SubElement(t, "Value").text = v
            return Response(_xml(root), content_type="application/xml")
        if req.method == "PUT":
            body = ET.fromstring(req.body)
            ns = body.tag.split("}")[0] + "}" if body.tag.startswith("{") \
                else ""
            entry.extended = {k: v for k, v in entry.extended.items()
                              if not k.startswith(TAG_PREFIX)}
            for tag in body.iter(f"{ns}Tag"):
                k = tag.find(f"{ns}Key").text or ""
                v = tag.find(f"{ns}Value").text or ""
                entry.extended[TAG_PREFIX + k] = v
            self.filer.update_entry(entry)
            return Response(b"", content_type="application/xml")
        if req.method == "DELETE":
            entry.extended = {k: v for k, v in entry.extended.items()
                              if not k.startswith(TAG_PREFIX)}
            self.filer.update_entry(entry)
            return Response(b"", status=204,
                            content_type="application/xml")
        return _err("MethodNotAllowed", req.method, 405)

    # ---- multipart ----
    def _initiate_multipart(self, bucket: str, key: str) -> Response:
        upload_id = uuid.uuid4().hex
        self.filer.mkdirs(f"{UPLOADS_PATH}/{upload_id}")
        marker = Entry(f"{UPLOADS_PATH}/{upload_id}/.meta",
                       attr=Attr(mtime=clockctl.now()))
        marker.extended = {"bucket": bucket, "key": key}
        self.filer.create_entry(marker)
        root = ET.Element("InitiateMultipartUploadResult")
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        return Response(_xml(root), content_type="application/xml")

    def _upload_part(self, req: Request, bucket: str, key: str) -> Response:
        """Multipart part upload, streamed through the same bounded-
        memory ingest as object PUT."""
        upload_id = req.query["uploadId"]
        part = int(req.query["partNumber"])
        if self.filer.find_entry(f"{UPLOADS_PATH}/{upload_id}") is None:
            return _err("NoSuchUpload", upload_id, 404)
        md5 = hashlib.md5()
        content, chunks, size = self.fs._ingest_body(
            req, bucket, self.fs.default_replication, hasher=md5)
        now = clockctl.now()
        entry = Entry(f"{UPLOADS_PATH}/{upload_id}/{part:05d}.part",
                      attr=Attr(mtime=now, crtime=now, md5=md5.digest(),
                                file_size=size))
        entry.content = content
        entry.chunks = chunks
        self.filer.create_entry(entry)
        return Response(b"", headers={"ETag": f'"{md5.hexdigest()}"'})

    def _complete_multipart(self, req: Request, bucket: str,
                            key: str) -> Response:
        """Compose part chunk lists into the final entry without moving
        data (reference filer_multipart.go completeMultipartUpload)."""
        upload_id = req.query["uploadId"]
        dirp = f"{UPLOADS_PATH}/{upload_id}"
        parts = [e for e in self.filer.list_entries(dirp, limit=100000)
                 if e.name.endswith(".part")]
        if not parts:
            return _err("NoSuchUpload", upload_id, 404)
        parts.sort(key=lambda e: e.name)
        chunks: list[FileChunk] = []
        offset = 0
        md5 = hashlib.md5()
        for p in parts:
            if p.content:
                # inline content gets re-uploaded as a chunk
                up = self.fs._upload_chunks(
                    p.content, bucket, self.fs.default_replication)
                for c in up:
                    c.offset += offset
                    chunks.append(c)
            else:
                for c in sorted(p.chunks, key=lambda c: c.offset):
                    chunks.append(FileChunk(
                        fid=c.fid, offset=offset + c.offset, size=c.size,
                        mtime_ns=c.mtime_ns))
            offset += p.file_size()
            md5.update(p.attr.md5)
        etag = md5.hexdigest() + f"-{len(parts)}"
        now = clockctl.now()
        entry = Entry(f"{BUCKETS_PATH}/{bucket}/{key}",
                      attr=Attr(mtime=now, crtime=now, file_size=offset,
                                collection=bucket))
        entry.chunks = chunks
        self.filer.create_entry(entry)
        # drop part entries WITHOUT chunk GC (chunks now owned by the
        # composed object)
        for p in parts:
            p.chunks = []
            self.filer.update_entry(p)
        self.filer.delete_entry(dirp, recursive=True)
        root = ET.Element("CompleteMultipartUploadResult")
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "ETag").text = f'"{etag}"'
        return Response(_xml(root), content_type="application/xml")

    def _list_parts(self, req: Request, bucket: str,
                    key: str) -> Response:
        """ListParts (reference s3api_object_multipart_handlers.go
        ListObjectPartsHandler): the uploaded parts of one in-progress
        multipart upload."""
        upload_id = req.query["uploadId"]
        dirp = f"{UPLOADS_PATH}/{upload_id}"
        meta = self.filer.find_entry(f"{dirp}/.meta")
        if meta is None or meta.extended.get("bucket") != bucket \
                or meta.extended.get("key") != key:
            # AWS answers NoSuchUpload when the id belongs to a
            # different bucket/key — never another upload's part list
            return _err("NoSuchUpload", upload_id, 404)
        max_parts = int(req.query.get("max-parts", 1000))
        marker = int(req.query.get("part-number-marker", 0))
        parts = sorted(
            (e for e in self.filer.list_entries(dirp, limit=100000)
             if e.name.endswith(".part")), key=lambda e: e.name)
        root = ET.Element("ListPartsResult")
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        ET.SubElement(root, "PartNumberMarker").text = str(marker)
        ET.SubElement(root, "MaxParts").text = str(max_parts)
        shown = 0
        last_num = marker
        truncated = False
        for p in parts:
            num = int(p.name.split(".")[0])
            if num <= marker:
                continue
            if shown >= max_parts:
                truncated = True
                break
            el = ET.SubElement(root, "Part")
            ET.SubElement(el, "PartNumber").text = str(num)
            ET.SubElement(el, "Size").text = str(p.file_size())
            ET.SubElement(el, "ETag").text = f'"{p.attr.md5.hex()}"'
            ET.SubElement(el, "LastModified").text = \
                _http_date(p.attr.mtime)
            shown += 1
            last_num = num
        ET.SubElement(root, "IsTruncated").text = \
            "true" if truncated else "false"
        if truncated:
            ET.SubElement(root, "NextPartNumberMarker").text = \
                str(last_num)
        return Response(_xml(root), content_type="application/xml")

    def _abort_multipart(self, req: Request, bucket: str,
                         key: str) -> Response:
        upload_id = req.query["uploadId"]
        try:
            self.filer.delete_entry(f"{UPLOADS_PATH}/{upload_id}",
                                    recursive=True)
        except FileNotFoundError:
            return _err("NoSuchUpload", upload_id, 404)
        return Response(b"", status=204, content_type="application/xml")


def _check_policy_conditions(pol: dict, bucket: str, key: str,
                             size: int, fields: dict) -> str:
    """Enforce the POST policy's conditions (reference
    policy/post-policy.go): exact-match {"field": "value"} / ["eq", ...],
    ["starts-with", "$field", prefix], ["content-length-range", lo, hi].
    Returns an error string, or "" if every condition holds."""
    actual = {k.lower(): v for k, v in fields.items()}
    actual["bucket"] = bucket
    actual["key"] = key
    for cond in pol.get("conditions", []):
        if isinstance(cond, dict):
            for f, want in cond.items():
                if actual.get(f.lower(), "") != str(want):
                    return f"policy condition failed: {f}"
        elif isinstance(cond, list) and cond:
            op = str(cond[0]).lower()
            if op == "content-length-range":
                lo, hi = int(cond[1]), int(cond[2])
                if not lo <= size <= hi:
                    return "content-length out of policy range"
            elif op in ("eq", "starts-with"):
                f = str(cond[1]).lstrip("$").lower()
                have = actual.get(f, "")
                want = str(cond[2])
                ok = (have == want if op == "eq"
                      else have.startswith(want))
                if not ok:
                    return f"policy condition failed: {f}"
    return ""


def _parse_tag_header(header: str) -> dict:
    """x-amz-tagging: url-encoded k=v&k=v."""
    if not header:
        return {}
    return {k: v[0] for k, v in
            urllib.parse.parse_qs(header, keep_blank_values=True).items()}


def _parse_multipart_form(body: bytes, boundary: bytes
                          ) -> tuple[dict, Optional[bytes], str]:
    """Parse a multipart/form-data body. Returns (fields, file_bytes,
    file_name); the part named "file" is the payload, everything else a
    text field."""
    fields: dict[str, str] = {}
    file_data: Optional[bytes] = None
    file_name = ""
    delim = b"--" + boundary
    for part in body.split(delim):
        # trim exactly the delimiting CRLFs, never payload bytes
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part == b"--":
            continue
        header_blob, _, content = part.partition(b"\r\n\r\n")
        headers = header_blob.decode("utf-8", "replace")
        m = re.search(r'name="([^"]*)"', headers)
        if not m:
            continue
        name = m.group(1)
        if name == "file":
            file_data = content
            fm = re.search(r'filename="([^"]*)"', headers)
            file_name = fm.group(1) if fm else ""
        else:
            fields[name] = content.decode("utf-8", "replace")
    return fields, file_data, file_name


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


def _http_date(ts: float) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))
