"""The port's S3 / IAM / WebDAV / FTP gateways, its SigV4, its S3-dialect
client, its cloud tier and its remote filer store, held against the JAX
package's.

Each stack is one package's master, volume server (the port's with
device="cpu"), filer and gateways; the packages meet only over sockets
and files. The same seeded script runs through both stacks and the
answers are held equal with no tolerance: status codes, the headers of
record and the XML, with request ids, upload ids and times masked. The
clients cross: each package's S3 client against each package's gateway,
a volume tiered by one package read back by the other, a gateway of one
package over the other's filer through filer/remote_store.py.
"""

import ftplib
import hashlib
import io
import json
import random
import re
import socket
import time
import types
import urllib.parse
import xml.etree.ElementTree as ET

import grpc
import numpy as np
import pytest

from seaweedfs_tpu.gateway import ftp_server as jftp
from seaweedfs_tpu.gateway import iam_server as jiam
from seaweedfs_tpu.gateway import s3_server as js3
from seaweedfs_tpu.gateway import webdav_server as jdav
from seaweedfs_tpu.pb import iam_pb2 as jiam_pb2
from seaweedfs_tpu.pb import s3_pb2 as js3_pb2
from seaweedfs_tpu.remote_storage import s3_client as js3_client
from seaweedfs_tpu.server import filer_server as jfiler_server
from seaweedfs_tpu.server.master import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.shell.commands import ShellContext as JShellContext
from seaweedfs_tpu.shell.repl import run_command as jrun_command
from seaweedfs_tpu.storage import backend as jbackend
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu.storage.volume import Volume as JVolume
from seaweedfs_tpu.utils import httpd as jhttpd
from seaweedfs_tpu.utils import sigv4 as jsigv4
from seaweedfs_tpu_torch.filer import remote_store
from seaweedfs_tpu_torch.gateway import ftp_server
from seaweedfs_tpu_torch.gateway import iam_server
from seaweedfs_tpu_torch.gateway import s3_server
from seaweedfs_tpu_torch.gateway import webdav_server
from seaweedfs_tpu_torch.pb import iam_pb2
from seaweedfs_tpu_torch.pb import s3_pb2
from seaweedfs_tpu_torch.remote_storage import s3_client
from seaweedfs_tpu_torch.server import filer_server
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import ShellContext
from seaweedfs_tpu_torch.shell.repl import run_command
from seaweedfs_tpu_torch.storage import backend
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils import httpd
from seaweedfs_tpu_torch.utils import sigv4
from seaweedfs_tpu_torch.utils.crc import crc32c

AK, SK = "WEEDTPUCROSSKEY", "cross/secret/KEY"
AMZ_DATE = "20260101T000000Z"
KIB, MIB = 1 << 10, 1 << 20


def _port_vs(dirs, master_url, **kw):
    return VolumeServer(dirs, master_url, device="cpu", **kw)


PORT = types.SimpleNamespace(
    name="port", Master=MasterServer, VS=_port_vs, fmod=filer_server,
    s3=s3_server, iam=iam_server, dav=webdav_server, ftp=ftp_server,
    http=httpd, client=s3_client, backend=backend, Volume=Volume,
    Needle=Needle, Shell=ShellContext, run=run_command, iam_pb2=iam_pb2,
    s3_pb2=s3_pb2)
JAX = types.SimpleNamespace(
    name="jax", Master=JMasterServer, VS=JVolumeServer, fmod=jfiler_server,
    s3=js3, iam=jiam, dav=jdav, ftp=jftp, http=jhttpd, client=js3_client,
    backend=jbackend, Volume=JVolume, Needle=JNeedle, Shell=JShellContext,
    run=jrun_command, iam_pb2=jiam_pb2, s3_pb2=js3_pb2)
PKGS = {"port": PORT, "jax": JAX}


def _payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return sorted(s.getsockname()[1] for s in socks)
    finally:
        for s in socks:
            s.close()


def _wait(cond, what, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class _Stack:
    """One package's master, volume server and filer; gateways are
    started on it by the tests."""

    def __init__(self, pkg, root, **filer_kw):
        self.pkg, self.root = pkg, root
        self.master = pkg.Master(volume_size_limit_mb=64)
        self.master.start()
        self.vs = pkg.VS([str(root / "v0")], self.master.url,
                         port=_free_ports(1)[0])
        self.vs.start()
        self.filer = pkg.fmod.FilerServer(self.master.url, **filer_kw)
        self.filer.start()
        self.extra = []
        _wait(lambda: self.master.topo.all_nodes(), "the volume server")

    def start(self, srv):
        srv.start()
        self.extra.append(srv)
        return srv

    def stop(self):
        for srv in [*reversed(self.extra), self.filer, self.vs,
                    self.master]:
            try:
                srv.stop()
            except Exception:
                pass


@pytest.fixture
def stacks(tmp_path):
    made = {}
    for name, pkg in PKGS.items():
        made[name] = _Stack(pkg, tmp_path / name)
    yield made
    for st in made.values():
        st.stop()


# ---------------- SigV4 ----------------


def test_sigv4_bytes_are_equal_over_seeded_inputs():
    rng = random.Random(1207)
    alphabet = "abcXYZ019-_.~/ %+=&!*'()"
    for _ in range(200):
        def word(lo, hi):
            return "".join(rng.choice(alphabet)
                           for _ in range(rng.randint(lo, hi)))
        secret = word(1, 40)
        date = f"2026{rng.randint(1, 12):02d}{rng.randint(1, 28):02d}"
        region = rng.choice(["us-east-1", "eu-west-3", "ap-south-1"])
        service = rng.choice(["s3", "iam"])
        assert sigv4.signing_key(secret, date, region, service) == \
            jsigv4.signing_key(secret, date, region, service)
        query = {word(1, 8): word(0, 12) for _ in range(rng.randint(0, 4))}
        headers = {"host": f"127.0.0.1:{rng.randint(1, 65535)}",
                   "x-amz-date": date + "T010203Z",
                   "x-amz-content-sha256": hashlib.sha256(
                       word(0, 30).encode()).hexdigest(),
                   "x-amz-meta-k": "  " + word(0, 10) + "  "}
        signed = sorted(rng.sample(sorted(headers), rng.randint(1, 4)))
        path = "/" + urllib.parse.quote(word(1, 20), safe="/~")
        args = (secret, date, region, service, date + "T010203Z",
                rng.choice(["GET", "PUT", "POST", "DELETE", "HEAD"]), path,
                query, headers, signed, headers["x-amz-content-sha256"])
        assert sigv4.signature(*args) == jsigv4.signature(*args)


# ---------------- the S3 request script ----------------


def _signed(base, method, path, query=None, body=b"", headers=None):
    """Header-signed request at a fixed X-Amz-Date (the gateways check
    no clock skew), so the same request signs the same way."""
    query = query or {}
    host = base.split("//", 1)[1]
    payload_hash = hashlib.sha256(body).hexdigest()
    hdrs = {"Host": host, "x-amz-date": AMZ_DATE,
            "x-amz-content-sha256": payload_hash, **(headers or {})}
    lower = {k.lower(): v for k, v in hdrs.items()}
    signed = sorted(k for k in lower
                    if k in ("host", "x-amz-date", "x-amz-content-sha256")
                    or k.startswith("x-amz-"))
    sig = sigv4.signature(SK, AMZ_DATE[:8], "us-east-1", "s3", AMZ_DATE,
                          method, path, query, lower, signed, payload_hash)
    hdrs["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={AK}/{AMZ_DATE[:8]}/us-east-1/s3/"
        f"aws4_request, SignedHeaders={';'.join(signed)}, Signature={sig}")
    qs = urllib.parse.urlencode(query, quote_via=urllib.parse.quote)
    return httpd.http_call(method, base + path + (f"?{qs}" if qs else ""),
                           body=body, headers=hdrs)


def _presigned_url(base, method, path, expires=300):
    host = base.split("//", 1)[1]
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    query = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256",
             "X-Amz-Credential": f"{AK}/{amz_date[:8]}/us-east-1/s3/"
                                 "aws4_request",
             "X-Amz-Date": amz_date, "X-Amz-Expires": str(expires),
             "X-Amz-SignedHeaders": "host"}
    query["X-Amz-Signature"] = sigv4.signature(
        SK, amz_date[:8], "us-east-1", "s3", amz_date, method, path, query,
        {"host": host}, ["host"], "UNSIGNED-PAYLOAD")
    return base + path + "?" + urllib.parse.urlencode(
        query, quote_via=urllib.parse.quote)


MASKED_TAGS = {"LastModified", "CreationDate", "UploadId", "Initiated",
               "RequestId", "HostId"}
HEADERS_OF_RECORD = ("content-type", "content-length", "etag",
                     "content-range", "accept-ranges", "x-amz-tagging-count",
                     "x-amz-meta-color", "x-amz-version-id",
                     "x-amz-delete-marker")


def _norm_xml(body):
    if not body.startswith(b"<?xml"):
        return body
    root = ET.fromstring(body)
    for el in root.iter():
        if el.tag.split("}")[-1] in MASKED_TAGS:
            el.text = "*"
    return ET.tostring(root)


def _record(status, body, headers):
    hdrs = {k.lower(): v for k, v in headers.items()}
    return (status, {k: hdrs[k] for k in HEADERS_OF_RECORD if k in hdrs},
            _norm_xml(body))


def _s3_script(base):
    """Every S3 call of the script, as (step, status, headers, body)."""
    out = []

    def step(name, method, path, query=None, body=b"", headers=None):
        status, got, hdrs = _signed(base, method, path, query, body,
                                    headers)
        out.append((name, *_record(status, got, hdrs)))
        return status, got, hdrs

    objs = {"docs/a.txt": _payload(3 * KIB, 1),
            "docs/b/c.bin": _payload(37 * KIB + 5, 2),
            "docs/b/d.bin": _payload(1 * MIB + 17, 3),
            "img/e.png": _payload(2 * MIB, 4), "z": _payload(1, 5)}
    step("create", "PUT", "/bkt")
    step("create-again", "PUT", "/bkt")
    for key, data in objs.items():
        step(f"put {key}", "PUT", f"/bkt/{key}", body=data,
             headers={"Content-Type": "application/octet-stream",
                      "x-amz-meta-color": "blue"})
    for key, data in objs.items():
        status, got, _ = step(f"get {key}", "GET", f"/bkt/{key}")
        assert status == 200 and got == data
        step(f"head {key}", "HEAD", f"/bkt/{key}")
    step("range", "GET", "/bkt/docs/b/d.bin",
         headers={"Range": "bytes=1000-70000"})
    step("suffix range", "GET", "/bkt/img/e.png",
         headers={"Range": "bytes=-4096"})
    step("bad range", "GET", "/bkt/z", headers={"Range": "bytes=9-20"})
    step("missing", "GET", "/bkt/nope")
    step("missing bucket", "GET", "/nobkt/x")
    step("list v1", "GET", "/bkt")
    step("list v1 prefix delimiter", "GET", "/bkt",
         {"prefix": "docs/", "delimiter": "/"})
    step("list v1 marker", "GET", "/bkt", {"marker": "docs/b/c.bin",
                                           "max-keys": "2"})
    status, got, _ = step("list v2 page 1", "GET", "/bkt",
                          {"list-type": "2", "max-keys": "2"})
    token = ET.fromstring(got).findtext(
        "{*}NextContinuationToken") or ET.fromstring(got).findtext(
        "NextContinuationToken")
    assert token
    step("list v2 page 2", "GET", "/bkt",
         {"list-type": "2", "max-keys": "2", "continuation-token": token})
    step("list v2 prefix delimiter", "GET", "/bkt",
         {"list-type": "2", "prefix": "docs/b", "delimiter": "/"})
    # multipart: init, three parts, complete; a second upload aborted
    status, got, _ = step("mp init", "POST", "/bkt/mp/big.bin",
                          {"uploads": ""})
    upload_id = ET.fromstring(got).findtext("{*}UploadId") or \
        ET.fromstring(got).findtext("UploadId")
    parts = [_payload(MIB, 10), _payload(MIB, 11), _payload(123, 12)]
    etags = []
    for i, data in enumerate(parts, 1):
        _, _, hdrs = step(f"mp part {i}", "PUT", "/bkt/mp/big.bin",
                          {"partNumber": str(i), "uploadId": upload_id},
                          body=data)
        etags.append({k.lower(): v for k, v in hdrs.items()}["etag"])
    step("mp list parts", "GET", "/bkt/mp/big.bin", {"uploadId": upload_id})
    done = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>")
    step("mp complete", "POST", "/bkt/mp/big.bin", {"uploadId": upload_id},
         body=done.encode())
    status, got, _ = step("mp get", "GET", "/bkt/mp/big.bin")
    assert got == b"".join(parts)
    _, got, _ = step("mp2 init", "POST", "/bkt/mp/aborted", {"uploads": ""})
    upload2 = ET.fromstring(got).findtext("{*}UploadId") or \
        ET.fromstring(got).findtext("UploadId")
    step("mp2 part", "PUT", "/bkt/mp/aborted",
         {"partNumber": "1", "uploadId": upload2}, body=b"x" * 100)
    step("mp2 abort", "DELETE", "/bkt/mp/aborted", {"uploadId": upload2})
    step("mp2 gone", "GET", "/bkt/mp/aborted")
    # copy, tagging
    step("copy", "PUT", "/bkt/copy/of-c.bin",
         headers={"x-amz-copy-source": "/bkt/docs/b/c.bin"})
    step("copy get", "GET", "/bkt/copy/of-c.bin")
    tags = ("<Tagging><TagSet><Tag><Key>team</Key><Value>storage</Value>"
            "</Tag><Tag><Key>tier</Key><Value>cold</Value></Tag></TagSet>"
            "</Tagging>")
    step("tag put", "PUT", "/bkt/docs/a.txt", {"tagging": ""},
         body=tags.encode())
    step("tag get", "GET", "/bkt/docs/a.txt", {"tagging": ""})
    step("tag head", "HEAD", "/bkt/docs/a.txt")
    step("tag delete", "DELETE", "/bkt/docs/a.txt", {"tagging": ""})
    step("tag get empty", "GET", "/bkt/docs/a.txt", {"tagging": ""})
    # delete-multiple (one key that does not exist)
    multi = ("<Delete>" + "".join(
        f"<Object><Key>{k}</Key></Object>"
        for k in ("docs/a.txt", "z", "never/was")) + "</Delete>")
    step("delete multiple", "POST", "/bkt", {"delete": ""},
         body=multi.encode())
    step("list after delete", "GET", "/bkt", {"list-type": "2"})
    step("delete one", "DELETE", "/bkt/copy/of-c.bin")
    # a presigned GET, a presigned URL for another key, a bad signature
    status, got, hdrs = httpd.http_call(
        "GET", _presigned_url(base, "GET", "/bkt/img/e.png"))
    out.append(("presigned", *_record(status, got, hdrs)))
    assert status == 200 and got == objs["img/e.png"]
    url = _presigned_url(base, "GET", "/bkt/img/e.png").replace(
        "/img/e.png", "/docs/b/c.bin")
    out.append(("presigned other key", *_record(*httpd.http_call("GET",
                                                                  url))))
    status, got, hdrs = _signed(base, "GET", "/bkt/img/e.png")
    auth = {"Authorization": "AWS4-HMAC-SHA256 Credential=" + AK
            + "/20260101/us-east-1/s3/aws4_request, SignedHeaders=host;"
            "x-amz-content-sha256;x-amz-date, Signature=" + "0" * 64,
            "x-amz-date": AMZ_DATE,
            "x-amz-content-sha256": hashlib.sha256(b"").hexdigest()}
    out.append(("bad signature", *_record(*httpd.http_call(
        "GET", base + "/bkt/img/e.png", headers=auth))))
    out.append(("unsigned", *_record(*httpd.http_call(
        "GET", base + "/bkt/img/e.png"))))
    out.append(("unknown key", *_record(*httpd.http_call(
        "GET", base + "/bkt/img/e.png",
        headers={**auth, "Authorization": auth["Authorization"].replace(
            AK, "NOSUCHKEY")}))))
    step("list buckets", "GET", "/")
    step("delete bucket", "DELETE", "/bkt")
    step("list buckets after", "GET", "/")
    return out


def test_s3_script_answers_equal(stacks):
    got = {}
    for name, st in stacks.items():
        gw = st.start(st.pkg.s3.S3Server(st.filer, access_key=AK,
                                         secret_key=SK))
        got[name] = _s3_script(f"http://{gw.url}")
    assert len(got["port"]) == len(got["jax"]) > 50
    for p, j in zip(got["port"], got["jax"]):
        assert p == j, p[0]
    statuses = {step: status for step, status, _, _ in got["port"]}
    assert statuses["bad signature"] == statuses["unsigned"] == 403
    assert statuses["missing"] == 404 and statuses["bad range"] == 416
    assert statuses["presigned"] == 200


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("gateway_pkg", ["port", "jax"])
def test_s3_clients_cross_gateways(tmp_path, client_pkg, gateway_pkg):
    """Either package's S3Remote against either package's gateway gives
    the answers the JAX client gets from the JAX gateway."""
    def run(cpkg, gpkg, root):
        st = _Stack(gpkg, root)
        try:
            gw = st.start(gpkg.s3.S3Server(st.filer, access_key=AK,
                                           secret_key=SK))
            cli = cpkg.client.S3Remote(f"http://{gw.url}", "remote",
                                       access_key=AK, secret_key=SK)
            status, _, _ = _signed(f"http://{gw.url}", "PUT", "/remote")
            assert status == 200
            files = {f"d{i % 3}/obj{i}.bin": _payload(
                int(np.random.default_rng(i).integers(1, 300 * KIB)), i)
                for i in range(9)}
            wrote = [(k, cli.write_file(k, v).size)
                     for k, v in files.items()]
            listed = sorted((f.path, f.size, f.is_directory)
                            for f in cli.traverse(""))
            reads = [cli.read_file(k, 7, 1000) for k in sorted(files)]
            whole = all(cli.read_file(k) == v for k, v in files.items())
            stat = cli.stat("d1/obj1.bin")
            cli.remove_file("d1/obj1.bin")
            gone = cli.stat("d1/obj1.bin")
            buckets = cpkg.client.S3Remote(
                f"http://{gw.url}", "", access_key=AK,
                secret_key=SK).list_buckets()
            bad = cpkg.client.S3Remote(f"http://{gw.url}", "remote",
                                       access_key=AK, secret_key="wrong")
            with pytest.raises(Exception) as ei:
                bad.read_file("d0/obj0.bin")
            return (wrote, listed, reads, whole, stat.size, gone, buckets,
                    type(ei.value).__name__)
        finally:
            st.stop()
    want = run(JAX, JAX, tmp_path / "ref")
    assert want[3] is True and want[5] is None
    assert run(PKGS[client_pkg], PKGS[gateway_pkg], tmp_path / "x") == want


# ---------------- IAM and the filer's S3 Configure service ----------------


class _SeededSecrets:
    """A stand-in for the `secrets` module: the same draws in both
    packages, so access keys and request ids come out equal."""

    def __init__(self, seed):
        self._rng = random.Random(seed)

    def token_hex(self, n):
        return "".join(self._rng.choice("0123456789abcdef")
                       for _ in range(2 * n))

    def token_urlsafe(self, n):
        return "".join(self._rng.choice(
            "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
            "-_") for _ in range(n + n // 3))


IDENTITY_PATH = "/etc/iam/identity.json"


def _identity_entry(st):
    http = st.pkg.http
    status, body, _ = http.http_call(
        "GET", f"http://{st.filer.url}{IDENTITY_PATH}")
    if status == 404:
        return status, b"", None, 0
    meta = http.http_json("GET", f"http://{st.filer.url}/__api/entry"
                                 f"?path={IDENTITY_PATH}")["entry"]
    return (status, body, meta["attr"].get("mime"),
            meta["attr"].get("file_size", len(body)))


def test_iam_script_answers_and_identity_entry_equal(stacks, monkeypatch):
    for mod in (iam_server, jiam):
        monkeypatch.setattr(mod, "secrets", _SeededSecrets(223))
    got = {}
    for name, st in stacks.items():
        iam = st.start(st.pkg.iam.IamServer(st.filer))
        s3 = st.start(st.pkg.s3.S3Server(st.filer))
        out = []

        def act(**params):
            status, body, hdrs = httpd.http_call(
                "POST", f"http://{iam.url}/",
                body=urllib.parse.urlencode(params).encode(),
                headers={"Content-Type":
                         "application/x-www-form-urlencoded"})
            out.append((params["Action"], status,
                        {k.lower(): v for k, v in hdrs.items()
                         }.get("content-type"), body))
            return body
        act(Action="CreateUser", UserName="alice")
        act(Action="CreateUser", UserName="alice")
        act(Action="CreateUser", UserName="bob")
        act(Action="ListUsers")
        key = ET.fromstring(act(Action="CreateAccessKey", UserName="alice"))
        akid = key.findtext(".//AccessKeyId")
        secret = key.findtext(".//SecretAccessKey")
        act(Action="CreateAccessKey", UserName="nobody")
        act(Action="PutUserPolicy", UserName="alice",
            PolicyDocument='{"Statement": [{"Effect": "Allow"}]}')
        act(Action="GetUserPolicy", UserName="alice")
        act(Action="GetUserPolicy", UserName="ghost")
        act(Action="DeleteUser", UserName="bob")
        act(Action="DeleteUser", UserName="bob")
        act(Action="NoSuchAction")
        act(Action="ListUsers")
        entry = _identity_entry(st)
        # the gateway now asks for SigV4, and takes IAM's key
        unsigned = httpd.http_call("PUT", f"http://{s3.url}/iam-bkt")[0]
        global AK, SK
        saved = AK, SK
        AK, SK = akid, secret
        try:
            signed = _signed(f"http://{s3.url}", "PUT", "/iam-bkt")[0]
        finally:
            AK, SK = saved
        act(Action="DeleteAccessKey", AccessKeyId=akid)
        act(Action="DeleteAccessKey", AccessKeyId="AKIDNOPE")
        # IdentityStore writes the same filer entry in both packages
        conf = {"identities": [{"name": "carol", "credentials": [
            {"accessKey": "AKIDCAROL", "secretKey": "c/s"}],
            "actions": ["Read"]}]}
        st.pkg.iam.IdentityStore(st.filer.filer).save(conf)
        loaded = st.pkg.iam.IdentityStore(st.filer.filer).load()
        found = st.pkg.iam.IdentityStore(
            st.filer.filer).find_by_access_key("AKIDCAROL")
        got[name] = (out, entry, unsigned, signed, _identity_entry(st),
                     loaded, found)
    assert got["port"] == got["jax"]
    out, entry, unsigned, signed = got["port"][:4]
    assert [s for _, s, _, _ in out][:4] == [200, 409, 200, 200]
    assert unsigned == 403 and signed == 200
    assert entry[0] == 200 and b"alice" in entry[1]


S3_CONFIGURE = "/weedtpu_s3_pb.SeaweedTpuS3/Configure"


def test_filer_s3_configure_rpc_answers_as_the_jax_filer(tmp_path):
    """The same Configure payloads (an S3ApiConfiguration proto, the
    legacy identity JSON, garbage, a JSON scalar) give the same status
    codes and the same /etc/iam/identity.json on both filers."""
    got = {}
    for name, pkg in PKGS.items():
        st = _Stack(pkg, tmp_path / name, grpc_port=0)
        try:
            chan = grpc.insecure_channel(f"127.0.0.1:{st.filer.grpc_port}")
            fn = chan.unary_unary(S3_CONFIGURE,
                                  request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
            api = pkg.iam_pb2.S3ApiConfiguration(identities=[
                pkg.iam_pb2.Identity(name="alice", credentials=[
                    pkg.iam_pb2.Credential(access_key="AKIA1",
                                           secret_key="s3cr3t")],
                    actions=["Read", "Write"])])
            payloads = [api.SerializeToString(),
                        json.dumps({"identities": [
                            {"name": "bob", "credentials": [],
                             "actions": ["Admin"]}]}).encode(),
                        b"\xff\xfegarbage", b"42"]
            out = []
            for body in payloads:
                req = pkg.s3_pb2.S3ConfigureRequest(
                    s3_configuration_file_content=body).SerializeToString()
                try:
                    resp = fn(req, timeout=10)
                    code = grpc.StatusCode.OK
                except grpc.RpcError as e:
                    resp, code = b"", e.code()
                out.append((code, resp, _identity_entry(st)))
            chan.close()
            got[name] = out
        finally:
            st.stop()
    assert got["port"] == got["jax"]
    assert [c for c, _, _ in got["port"]] == [
        grpc.StatusCode.OK, grpc.StatusCode.OK,
        grpc.StatusCode.INVALID_ARGUMENT, grpc.StatusCode.INVALID_ARGUMENT]
    assert b"AKIA1" in got["port"][0][2][1]


# ---------------- the cloud tier ----------------


def _seed_volume(directory, pkg, vid, seed, n=24):
    """A sealed volume of seeded needles; returns {key: data}."""
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    v = pkg.Volume(str(directory), "", vid)
    payloads = {}
    for key in range(1, n + 1):
        data = rng.bytes(int(rng.integers(1, 200 * KIB)))
        nd = pkg.Needle(id=key, cookie=int(rng.integers(1, 1 << 32)),
                        data=data, name=f"n{key}.bin".encode(),
                        append_at_ns=1_700_000_000_000_000_000 + key)
        nd.set_flags_from_fields()
        v.write_needle(nd)
        payloads[key] = data
    v.close()
    return payloads


def _gateway(st, **kw):
    gw = st.start(st.pkg.s3.S3Server(st.filer, **kw))
    assert httpd.http_call("PUT", f"http://{gw.url}/tier")[0] == 200
    return f"http://{gw.url}"


def test_a_tiered_volume_reads_across_packages(stacks, tmp_path):
    """Each package tiers the same sealed volume to the other package's
    gateway; each reads the other's upload back through its own
    open_backend_for_volume and Volume. The .vif JSON, file_crc32c and
    every ranged read are equal."""
    endpoints = {name: _gateway(st) for name, st in stacks.items()}
    src = tmp_path / "src"
    payloads = _seed_volume(src, PORT, 5, seed=99)
    original = (src / "5.dat").read_bytes()
    crc = {name: pkg.backend.file_crc32c(str(src / "5.dat"),
                                         chunk_bytes=64 * KIB)
           for name, pkg in PKGS.items()}
    assert crc["port"] == crc["jax"] == PORT.backend.file_crc32c(
        str(src / "5.dat"))
    vifs, dirs = {}, {}
    for name, other in (("port", "jax"), ("jax", "port")):
        d = tmp_path / f"tiered_by_{name}"
        d.mkdir()
        for ext in (".dat", ".idx"):
            (d / f"5{ext}").write_bytes((src / f"5{ext}").read_bytes())
        info = PKGS[name].backend.tier_volume_to_s3(
            str(d / "5"), endpoints[other], "tier", key=f"{name}_5.dat")
        assert not (d / "5.dat").exists()
        vifs[name] = json.loads((d / "5.vif").read_text())
        assert vifs[name] == info
        dirs[name] = d
    for name in ("port", "jax"):
        vifs[name]["remote"].pop("endpoint")
        vifs[name]["remote"].pop("key")
    assert vifs["port"] == vifs["jax"]
    assert vifs["port"]["remote"]["crc32c"] == crc["port"]
    rng = np.random.default_rng(7)
    ranges = [(int(o), int(n)) for o, n in zip(
        rng.integers(0, len(original) - 1, 32),
        rng.integers(1, 300 * KIB, 32))]
    for reader in PKGS.values():
        for writer in ("port", "jax"):
            be = reader.backend.open_backend_for_volume(
                str(dirs[writer] / "5"))
            assert type(be).__name__ == "S3BackendFile"
            assert be.size() == len(original)
            for off, n in ranges:
                assert be.read_at(off, n) == original[off:off + n]
            v = reader.Volume(str(dirs[writer]), "", 5)
            assert v.is_tiered and v.read_only
            for key, data in payloads.items():
                assert v.read_needle(key).data == data
            v.close()


def test_verify_tiered_copy_refuses_short_or_corrupt_copies(stacks):
    endpoint = _gateway(stacks["port"])
    body = _payload(300 * KIB + 3, 31)
    good_crc = crc32c(body)
    for key, data in (("good", body), ("short", body[:-1]),
                      ("corrupt", body[:100] + bytes([body[100] ^ 1])
                       + body[101:])):
        assert httpd.http_call("PUT", f"{endpoint}/tier/{key}",
                               body=data)[0] == 200
    errors = {}
    for name, pkg in PKGS.items():
        ok = pkg.backend.S3BackendFile(endpoint, "tier", "good")
        pkg.backend.verify_tiered_copy(ok, len(body), good_crc,
                                       chunk_bytes=64 * KIB)
        errs = []
        for key in ("short", "corrupt"):
            remote = pkg.backend.S3BackendFile(endpoint, "tier", key)
            with pytest.raises(IOError) as ei:
                pkg.backend.verify_tiered_copy(remote, len(body), good_crc,
                                               chunk_bytes=64 * KIB)
            errs.append(str(ei.value))
        errors[name] = errs
    assert errors["port"] == errors["jax"]
    assert "size" in errors["port"][0] and "crc32c" in errors["port"][1]


def test_unsigned_tier_io_gets_403_once_identities_exist(stacks, tmp_path):
    """Kept from the reference: the backend signs nothing, so a gateway
    that holds any identity refuses the tier's reads and uploads (403)
    in both packages; the local .dat stays."""
    got = {}
    for name, st in stacks.items():
        endpoint = _gateway(st)
        httpd.http_call("PUT", f"{endpoint}/tier/obj", body=b"x" * 4096)
        st.pkg.iam.IdentityStore(st.filer.filer).save({"identities": [
            {"name": "u", "credentials": [{"accessKey": "AK1",
                                           "secretKey": "SK1"}],
             "actions": ["Admin"]}]})
        out = []
        for pkg in PKGS.values():
            with pytest.raises(IOError) as ei:
                pkg.backend.S3BackendFile(endpoint, "tier",
                                          "obj").read_at(0, 10)
            out.append(str(ei.value))
            d = tmp_path / f"{name}_{pkg.name}"
            _seed_volume(d, pkg, 3, seed=5, n=3)
            with pytest.raises(IOError) as ei:
                pkg.backend.tier_volume_to_s3(str(d / "3"), endpoint,
                                              "tier")
            out.append(str(ei.value))
            assert (d / "3.dat").exists() and not (d / "3.vif").exists()
        got[name] = out
    assert got["port"] == got["jax"]
    assert got["port"][0] == "s3 read: HTTP 403"
    assert "HTTP 403" in got["port"][1]


@pytest.mark.parametrize("mover_pkg", ["port", "jax"])
def test_tier_mover_cloud_rung_against_a_gateway(stacks, mover_pkg):
    """TierMover's cloud rung: a sealed volume on one package's volume
    server demotes to the other package's gateway (its .dat gone, every
    needle read from the cloud rung) and promotes back, bytes equal."""
    from seaweedfs_tpu.storage import tiering as jtiering
    from seaweedfs_tpu_torch.storage import tiering
    tmod = {"port": tiering, "jax": jtiering}[mover_pkg]
    st = stacks[mover_pkg]
    other = stacks["jax" if mover_pkg == "port" else "port"]
    endpoint = _gateway(other)
    http = st.pkg.http
    a = http.http_json("GET", f"http://{st.master.url}/dir/assign"
                              "?collection=cold")
    vid = int(a["fid"].split(",")[0])
    bodies = {}
    for i in range(12):
        a = http.http_json("GET", f"http://{st.master.url}/dir/assign"
                                  "?collection=cold")
        if int(a["fid"].split(",")[0]) != vid:
            continue
        data = _payload(int(np.random.default_rng(i).integers(1, 90 * KIB)),
                        100 + i)
        status, _, _ = http.http_call("POST", f"http://{a['url']}/"
                                      f"{a['fid']}", body=data)
        assert status < 300
        bodies[a["fid"]] = data
    assert bodies
    http.http_json("POST", f"http://{st.vs.url}/admin/mark_readonly",
                   {"volume_id": vid, "read_only": True})
    vdir = st.root / "v0"
    dat = next(vdir.glob(f"*{vid}.dat"))
    original = dat.read_bytes()
    planner = tmod.TieringPlanner()
    mover = tmod.TierMover(planner, endpoint=endpoint, bucket="tier")

    def run(frm, to):
        assert mover.start({"moves": [{"vid": vid, "from": frm, "to": to,
                                       "urls": [st.vs.url],
                                       "size": len(original)}]})
        _wait(lambda: not mover.busy, "the tier mover", timeout=60)
        assert mover.status()["error"] is None, mover.status()
    run(tmod.RUNG_HOT, tmod.RUNG_CLOUD)
    assert not dat.exists()
    for fid, data in bodies.items():
        assert http.http_call("GET", f"http://{st.vs.url}/{fid}")[1] == data
    run(tmod.RUNG_CLOUD, tmod.RUNG_HOT)
    assert dat.read_bytes() == original
    for fid, data in bodies.items():
        assert http.http_call("GET", f"http://{st.vs.url}/{fid}")[1] == data
    assert mover.status()["moves_done"] == 2


# ---------------- a gateway over the other package's filer ----------------


@pytest.mark.parametrize("gateway_pkg", ["port", "jax"])
def test_gateway_over_the_other_packages_filer(stacks, gateway_pkg):
    """A standalone gateway of one package (FilerServer(store="remote"))
    over the other package's filer: objects written through it read back
    through the home filer's own gateway and HTTP listing, and the
    reverse."""
    gpkg = PKGS[gateway_pkg]
    home = stacks["jax" if gateway_pkg == "port" else "port"]
    view = gpkg.fmod.FilerServer(home.master.url, store="remote",
                                 store_dir=home.filer.url, announce=False)
    view.start()
    try:
        gw = gpkg.s3.S3Server(view)
        gw.start()
        home_gw = home.start(home.pkg.s3.S3Server(home.filer))
        try:
            objs = {f"k{i}/o.bin": _payload(
                int(np.random.default_rng(i).integers(1, 2 * MIB)), i)
                for i in range(6)}
            assert httpd.http_call("PUT", f"http://{gw.url}/shared")[0] \
                == 200
            for key, data in objs.items():
                assert httpd.http_call("PUT", f"http://{gw.url}/shared/"
                                       f"{key}", body=data)[0] == 200
            for key, data in objs.items():
                for url in (gw.url, home_gw.url):
                    assert httpd.http_call(
                        "GET", f"http://{url}/shared/{key}")[1] == data
            httpd.http_call("PUT", f"http://{home_gw.url}/shared/back",
                            body=b"from home")
            assert httpd.http_call("GET", f"http://{gw.url}/shared/back"
                                   )[1] == b"from home"
            listing = [e["FullPath"] for e in home.pkg.http.http_json(
                "GET", f"http://{home.filer.url}/buckets/shared/"
            )["Entries"]]
            assert sorted(listing) == sorted(
                ["/buckets/shared/back"]
                + [f"/buckets/shared/k{i}" for i in range(6)])
            lists = [_norm_xml(httpd.http_call(
                "GET", f"http://{url}/shared?list-type=2")[1])
                for url in (gw.url, home_gw.url)]
            assert lists[0] == lists[1]
        finally:
            gw.stop()
    finally:
        view.stop()


def test_make_store_remote_speaks_to_either_filer(stacks):
    """make_store("remote") is the remote filer store: over either
    package's filer the port's and the JAX package's adapters see each
    other's rows and kv records."""
    from seaweedfs_tpu.filer import entry as jentry
    from seaweedfs_tpu.filer.filerstore import make_store as jmake_store
    from seaweedfs_tpu_torch.filer import entry
    from seaweedfs_tpu_torch.filer.filerstore import make_store
    for st in stacks.values():
        port = make_store("remote", filer_addr=st.filer.url)
        ref = jmake_store("remote", filer_addr=st.filer.url)
        assert isinstance(port, remote_store.RemoteFilerStore)
        port.insert_entry(entry.Entry(
            full_path="/rs/p.txt", attr=entry.Attr(mtime=1, crtime=1,
                                                   mode=0o644)))
        ref.insert_entry(jentry.Entry(
            full_path="/rs/j.txt", attr=jentry.Attr(mtime=2, crtime=2,
                                                    mode=0o644)))
        port.kv_put(b"k-port", b"v1")
        ref.kv_put(b"k-jax", b"v2")
        for a, b in ((port, ref), (ref, port)):
            assert b.kv_get(b"k-port") == b"v1"
            assert b.kv_get(b"k-jax") == b"v2"
            assert a.find_entry("/rs/j.txt").attr.mtime == 2
            assert a.find_entry("/rs/p.txt").attr.mtime == 1
        assert [e.full_path for e in port.list_directory_entries("/rs")] \
            == [e.full_path for e in ref.list_directory_entries("/rs")] \
            == ["/rs/j.txt", "/rs/p.txt"]


# ---------------- WebDAV and FTP ----------------


def _norm_dav(body):
    return re.sub(rb"<D:getlastmodified>[^<]*</D:getlastmodified>",
                  b"<D:getlastmodified>*</D:getlastmodified>", body)


def _dav_script(base):
    out = []

    def call(method, path, body=b"", headers=None):
        status, got, hdrs = httpd.http_call(method, base + path, body=body,
                                            headers=headers)
        h = {k.lower(): v for k, v in hdrs.items()}
        out.append((method, path, status, h.get("content-type"),
                    h.get("dav"), _norm_dav(got)))
        return got
    small, big = _payload(700, 41), _payload(3 * MIB + 11, 42)
    call("OPTIONS", "/")
    call("MKCOL", "/dav")
    call("MKCOL", "/dav/sub")
    call("PUT", "/dav/small.txt", small, {"Content-Type": "text/plain"})
    call("PUT", "/dav/sub/big.bin", big)
    call("PROPFIND", "/dav", headers={"Depth": "1"})
    call("PROPFIND", "/dav/sub/big.bin", headers={"Depth": "0"})
    call("PROPFIND", "/dav/none", headers={"Depth": "0"})
    assert call("GET", "/dav/sub/big.bin") == big
    call("HEAD", "/dav/small.txt")
    call("MOVE", "/dav/small.txt",
         headers={"Destination": base + "/dav/sub/moved.txt"})
    call("COPY", "/dav/sub/big.bin",
         headers={"Destination": base + "/dav/copy.bin"})
    call("MOVE", "/dav/gone.txt", headers={"Destination": base + "/x"})
    call("PROPFIND", "/dav/sub", headers={"Depth": "1"})
    assert call("GET", "/dav/sub/moved.txt") == small
    assert call("GET", "/dav/copy.bin") == big
    call("DELETE", "/dav/copy.bin")
    call("DELETE", "/dav/copy.bin")
    call("PROPFIND", "/dav", headers={"Depth": "1"})
    return out


def _ftp_script(host, port):
    out = []
    ftp = ftplib.FTP()
    out.append(ftp.connect(host, port, timeout=10))
    out.append(ftp.login())
    out.append(ftp.sendcmd("SYST"))
    out.append(ftp.mkd("/ftp"))
    out.append(ftp.cwd("/ftp"))
    out.append(ftp.pwd())
    body = _payload(2 * MIB + 5, 51)
    out.append(ftp.storbinary("STOR data.bin", io.BytesIO(body)))
    out.append(ftp.storbinary("STOR note.txt", io.BytesIO(b"note")))
    out.append(ftp.size("data.bin"))
    got = io.BytesIO()
    out.append(ftp.retrbinary("RETR data.bin", got.write))
    assert got.getvalue() == body
    lines = []
    out.append(ftp.retrlines("LIST", lines.append))
    # the listing's dates are the entries' mtimes: mask them
    out.append([re.sub(r"\w{3} [ \d]\d \d\d:\d\d", "*", ln)
                for ln in lines])
    out.append(ftp.nlst())
    out.append(ftp.rename("note.txt", "renamed.txt"))
    out.append(ftp.nlst())
    out.append(ftp.delete("renamed.txt"))
    try:
        ftp.sendcmd("RETR missing.bin")
    except ftplib.error_perm as e:
        out.append(str(e))
    out.append(ftp.nlst())
    out.append(ftp.quit())
    return out


def test_webdav_and_ftp_answers_equal(stacks):
    got = {}
    for name, st in stacks.items():
        dav = st.start(st.pkg.dav.WebDavServer(st.filer))
        ftp = st.start(st.pkg.ftp.FtpServer(st.filer))
        fhost, fport = ftp.url.rsplit(":", 1)
        got[name] = (_dav_script(f"http://{dav.url}"),
                     _ftp_script(fhost, int(fport)))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    statuses = [s for _, _, s, _, _, _ in got["port"][0]]
    assert 207 in statuses and 201 in statuses and 404 in statuses


# ---------------- the REPL's s3.* and remote.* families ----------------


@pytest.mark.parametrize("line", ["s3.configure -user u -access AKU "
                                  "-secret SKU -actions Read,Write",
                                  "s3.bucket.list", "remote.configure "
                                  "-name r -type local -root {root}",
                                  "remote.status"])
def test_repl_s3_and_remote_families_answer_as_the_jax_repl(
        stacks, tmp_path, line):
    """The port's REPL runs the s3.* and remote.* families against its
    filer and answers what the JAX REPL answers against the JAX filer."""
    root = tmp_path / "remote_root"
    (root / "d").mkdir(parents=True)
    (root / "d" / "f.txt").write_bytes(b"remote")
    setup = ["s3.bucket.create -name pics", "s3.bucket.create -name docs",
             f"remote.configure -name loc -type local -root {root}",
             "remote.mount -dir /m -remote loc"]
    got = {}
    for name, st in stacks.items():
        _wait(lambda: st.pkg.http.http_json(
            "GET", f"http://{st.master.url}/cluster/nodes?type=filer"
        ).get("cluster_nodes"), "the filer to register")
        sh = st.pkg.Shell(st.master.url)
        outs = [st.pkg.run(sh, ln) for ln in setup]
        outs.append(st.pkg.run(sh, line.format(root=root)))
        outs.append(st.pkg.run(sh, "s3.bucket.list"))
        outs.append(st.pkg.run(sh, "remote.status"))
        outs.append(_identity_entry(st)[:2])
        got[name] = outs
    assert got["port"] == got["jax"]
    assert got["port"][-3] == ["docs", "pics"]


# ---------------- the command line ----------------


@pytest.mark.parametrize("argv", [
    ["s3"], ["webdav"], ["ftp"], ["iam"],
    ["server", "-filer", "-s3", "-device", "cpu"], ["filer", "-ftp"]])
def test_gateway_commands_start_and_serve(stacks, monkeypatch, tmp_path,
                                          argv):
    """`weed s3`, `webdav`, `ftp`, `iam` over a running filer,
    `server -filer -s3` and `filer -ftp` start the port's gateways
    through cli.main, and each answers."""
    from seaweedfs_tpu_torch import cli
    st = stacks["port"]
    served = []
    monkeypatch.setattr(cli, "_serve_until_signal",
                        lambda *srv, ready="": served.extend(srv))
    port = _free_ports(1)[0]
    args = list(argv)
    if argv[0] in ("s3", "webdav", "ftp", "iam"):
        args += ["-port", str(port), "-filer", st.filer.url,
                 "-master", st.master.url]
    elif argv[0] == "server":
        mport, vport, fport, sport = _free_ports(4)
        args += ["-masterPort", str(mport), "-port", str(vport),
                 "-filerPort", str(fport), "-s3Port", str(sport),
                 "-dir", str(tmp_path / "srv")]
        port = sport
    else:
        args += ["-master", st.master.url, "-port", str(port),
                 "-ftpPort", str(_free_ports(1)[0])]
    try:
        cli.main(args)
        kinds = {type(s).__name__ for s in served}
        if argv[0] == "filer":
            ftp = next(s for s in served if type(s).__name__ == "FtpServer")
            host, fport = ftp.url.rsplit(":", 1)
            conn = ftplib.FTP()
            assert conn.connect(host, int(fport), timeout=10) \
                .startswith("220")
            conn.close()
        elif argv[0] == "ftp":
            conn = ftplib.FTP()
            assert conn.connect("127.0.0.1", port, timeout=10) \
                .startswith("220")
            conn.close()
        elif argv[0] == "webdav":
            assert httpd.http_call(
                "OPTIONS", f"http://127.0.0.1:{port}/")[0] == 200
        elif argv[0] == "iam":
            assert httpd.http_call(
                "POST", f"http://127.0.0.1:{port}/",
                body=b"Action=ListUsers", headers={
                    "Content-Type": "application/x-www-form-urlencoded"}
            )[0] == 200
        else:
            status, body, _ = httpd.http_call("GET",
                                              f"http://127.0.0.1:{port}/")
            assert status == 200 and b"ListAllMyBucketsResult" in body
        assert kinds
    finally:
        for srv in served:
            try:
                srv.stop()
            except Exception:
                pass


def test_standalone_gateway_sees_identities_written_through_its_filer(
        stacks, monkeypatch):
    """`weed s3 -filer F` in the port reads through to F, so an identity
    that `s3.configure` writes through F turns on SigV4 at once. The
    reference builds the same filer view with its entry cache on, which
    never hears of that write: its gateway goes on serving anonymous
    requests (a fault of the reference the port does not share)."""
    from seaweedfs_tpu_torch import cli
    served = []
    monkeypatch.setattr(cli, "_serve_until_signal",
                        lambda *srv, ready="": served.extend(srv))
    got = {}
    try:
        for name, st in stacks.items():
            port = _free_ports(1)[0]
            if name == "port":
                cli.main(["s3", "-port", str(port), "-filer", st.filer.url,
                          "-master", st.master.url])
            else:
                # as the reference's cmd_gateway builds it
                view = st.pkg.fmod.FilerServer(
                    st.master.url, store="remote", store_dir=st.filer.url,
                    announce=False)
                view.start()
                served.append(view)
                served.append(st.pkg.s3.S3Server(view, port=port))
                served[-1].start()
            url = f"http://127.0.0.1:{port}/"
            before = httpd.http_call("GET", url)[0]
            _wait(lambda: st.pkg.http.http_json(
                "GET", f"http://{st.master.url}/cluster/nodes?type=filer"
            ).get("cluster_nodes"), "the filer to register")
            st.pkg.run(st.pkg.Shell(st.master.url),
                       "s3.configure -user u -access AKU -secret SKU")
            got[name] = (before, httpd.http_call("GET", url)[0])
    finally:
        for srv in served:
            srv.stop()
    assert got == {"port": (200, 403), "jax": (200, 200)}
