"""S3 gateway tests over a live mini-stack (reference model:
test/s3/basic/basic_test.go drives the real S3 API against weed server).

The port's copy of ref tests/test_s3.py: the same cases on the port's
gateway, filer and master, its volume servers on device="cpu"."""

import time
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from seaweedfs_tpu_torch.gateway.s3_server import S3Server
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils.httpd import http_call


def _cpu_vs(dirs, master_url, **kw):
    """The port's volume server on the kernels' plain versions (the
    tests run without a card)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(dirs, master_url, device="cpu", **kw)


@pytest.fixture
def s3stack(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _cpu_vs([str(tmp_path / "v0")], master.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    s3 = S3Server(fs)
    s3.start()
    time.sleep(0.2)
    yield s3
    s3.stop()
    fs.stop()
    vs.stop()
    master.stop()


def test_bucket_lifecycle(s3stack):
    base = f"http://{s3stack.url}"
    status, _, _ = http_call("PUT", f"{base}/mybucket")
    assert status == 200
    status, body, _ = http_call("GET", f"{base}/")
    assert status == 200 and b"<Name>mybucket</Name>" in body
    status, _, _ = http_call("HEAD", f"{base}/mybucket")
    assert status == 200
    status, _, _ = http_call("DELETE", f"{base}/mybucket")
    assert status == 204
    status, _, _ = http_call("HEAD", f"{base}/mybucket")
    assert status == 404


def test_object_put_get_delete(s3stack):
    base = f"http://{s3stack.url}"
    http_call("PUT", f"{base}/b1")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 5_000_000, dtype=np.uint8).tobytes()
    status, _, headers = http_call("PUT", f"{base}/b1/dir/obj.bin",
                                   body=data)
    assert status == 200 and headers.get("ETag")
    status, body, _ = http_call("GET", f"{base}/b1/dir/obj.bin")
    assert status == 200 and body == data

    # range read
    status, body, headers = http_call(
        "GET", f"{base}/b1/dir/obj.bin",
        headers={"Range": "bytes=100-199"})
    assert status == 206 and body == data[100:200]

    status, _, _ = http_call("DELETE", f"{base}/b1/dir/obj.bin")
    assert status == 204
    status, _, _ = http_call("GET", f"{base}/b1/dir/obj.bin")
    assert status == 404

    # missing bucket
    status, _, _ = http_call("PUT", f"{base}/nobucket/x", body=b"d")
    assert status == 404


def test_list_objects_v2(s3stack):
    base = f"http://{s3stack.url}"
    http_call("PUT", f"{base}/lst")
    for key in ("a/1.txt", "a/2.txt", "b/3.txt", "top.txt"):
        http_call("PUT", f"{base}/lst/{key}", body=b"x" * 10)
    status, body, _ = http_call("GET", f"{base}/lst?list-type=2")
    assert status == 200
    root = ET.fromstring(body)
    keys = sorted(c.find("Key").text for c in root.findall("Contents"))
    assert keys == ["a/1.txt", "a/2.txt", "b/3.txt", "top.txt"]

    # prefix filter
    status, body, _ = http_call("GET", f"{base}/lst?list-type=2&prefix=a/")
    keys = sorted(c.find("Key").text
                  for c in ET.fromstring(body).findall("Contents"))
    assert keys == ["a/1.txt", "a/2.txt"]

    # delimiter rolls up common prefixes
    status, body, _ = http_call(
        "GET", f"{base}/lst?list-type=2&delimiter=/")
    root = ET.fromstring(body)
    cps = sorted(p.find("Prefix").text
                 for p in root.findall("CommonPrefixes"))
    assert cps == ["a/", "b/"]
    keys = [c.find("Key").text for c in root.findall("Contents")]
    assert keys == ["top.txt"]


def test_multipart_upload(s3stack):
    base = f"http://{s3stack.url}"
    http_call("PUT", f"{base}/mp")
    status, body, _ = http_call("POST", f"{base}/mp/big.bin?uploads")
    upload_id = ET.fromstring(body).find("UploadId").text

    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 256, 3_000_000, dtype=np.uint8).tobytes()
             for _ in range(3)]
    for i, p in enumerate(parts, start=1):
        status, _, _ = http_call(
            "PUT", f"{base}/mp/big.bin?uploadId={upload_id}&partNumber={i}",
            body=p)
        assert status == 200
    status, body, _ = http_call(
        "POST", f"{base}/mp/big.bin?uploadId={upload_id}", body=b"<x/>")
    assert status == 200 and b"CompleteMultipartUploadResult" in body

    status, body, _ = http_call("GET", f"{base}/mp/big.bin")
    assert status == 200 and body == b"".join(parts)


def test_delete_objects_batch(s3stack):
    base = f"http://{s3stack.url}"
    http_call("PUT", f"{base}/db")
    http_call("PUT", f"{base}/db/x.txt", body=b"1")
    http_call("PUT", f"{base}/db/y.txt", body=b"2")
    payload = (b"<Delete><Object><Key>x.txt</Key></Object>"
               b"<Object><Key>y.txt</Key></Object></Delete>")
    status, body, _ = http_call("POST", f"{base}/db?delete", body=payload)
    assert status == 200
    assert body.count(b"<Deleted>") == 2
    status, _, _ = http_call("GET", f"{base}/db/x.txt")
    assert status == 404


def test_sigv4_auth_rejects_anonymous(tmp_path):
    master = MasterServer()
    master.start()
    vs = _cpu_vs([str(tmp_path / "v")], master.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    s3 = S3Server(fs, access_key="AKID", secret_key="SECRET")
    s3.start()
    try:
        status, body, _ = http_call("GET", f"http://{s3.url}/")
        assert status == 403 and b"AccessDenied" in body
    finally:
        s3.stop()
        fs.stop()
        vs.stop()
        master.stop()


def test_list_objects_v1_marker(s3stack):
    base = f"http://{s3stack.url}"
    http_call("PUT", f"{base}/v1l")
    for key in ("a.txt", "b.txt", "c.txt"):
        http_call("PUT", f"{base}/v1l/{key}", body=b"x")
    status, body, _ = http_call("GET", f"{base}/v1l?max-keys=2")
    assert status == 200
    root = ET.fromstring(body)
    keys = [c.find("Key").text for c in root.findall("Contents")]
    assert keys == ["a.txt", "b.txt"]
    assert root.find("IsTruncated").text == "true"
    marker = root.find("NextMarker").text
    status, body, _ = http_call("GET", f"{base}/v1l?marker={marker}")
    root = ET.fromstring(body)
    keys = [c.find("Key").text for c in root.findall("Contents")]
    assert keys == ["c.txt"]


def test_copy_object(s3stack):
    base = f"http://{s3stack.url}"
    http_call("PUT", f"{base}/src")
    http_call("PUT", f"{base}/dst")
    payload = bytes(np.random.default_rng(7).integers(0, 256, 9000,
                                                      dtype=np.uint8))
    http_call("PUT", f"{base}/src/orig.bin", body=payload,
              headers={"x-amz-tagging": "team=infra"})
    status, body, _ = http_call(
        "PUT", f"{base}/dst/copy.bin", body=b"",
        headers={"x-amz-copy-source": "/src/orig.bin"})
    assert status == 200 and b"CopyObjectResult" in body
    status, body, _ = http_call("GET", f"{base}/dst/copy.bin")
    assert status == 200 and body == payload
    # tags are copied by default (COPY directive)
    _, body, _ = http_call("GET", f"{base}/dst/copy.bin?tagging")
    assert b"team" in body and b"infra" in body
    # deleting the source must not break the copy
    http_call("DELETE", f"{base}/src/orig.bin")
    status, body, _ = http_call("GET", f"{base}/dst/copy.bin")
    assert status == 200 and body == payload
    # missing source
    status, _, _ = http_call(
        "PUT", f"{base}/dst/x.bin", body=b"",
        headers={"x-amz-copy-source": "/src/nope.bin"})
    assert status == 404


def test_object_tagging(s3stack):
    base = f"http://{s3stack.url}"
    http_call("PUT", f"{base}/tg")
    http_call("PUT", f"{base}/tg/o.txt", body=b"hi",
              headers={"x-amz-tagging": "a=1&b=two"})
    status, body, _ = http_call("GET", f"{base}/tg/o.txt?tagging")
    assert status == 200
    root = ET.fromstring(body)
    tags = {t.find("Key").text: t.find("Value").text
            for t in root.iter("Tag")}
    assert tags == {"a": "1", "b": "two"}
    # replace via PUT ?tagging
    put_body = (b'<Tagging><TagSet><Tag><Key>c</Key><Value>3</Value>'
                b'</Tag></TagSet></Tagging>')
    status, _, _ = http_call("PUT", f"{base}/tg/o.txt?tagging",
                             body=put_body)
    assert status == 200
    _, body, _ = http_call("GET", f"{base}/tg/o.txt?tagging")
    root = ET.fromstring(body)
    tags = {t.find("Key").text: t.find("Value").text
            for t in root.iter("Tag")}
    assert tags == {"c": "3"}
    # delete all tags
    status, _, _ = http_call("DELETE", f"{base}/tg/o.txt?tagging")
    assert status == 204
    _, body, _ = http_call("GET", f"{base}/tg/o.txt?tagging")
    assert b"<Tag>" not in body
    # object data unaffected
    _, body, _ = http_call("GET", f"{base}/tg/o.txt")
    assert body == b"hi"


def test_bucket_stubs(s3stack):
    base = f"http://{s3stack.url}"
    http_call("PUT", f"{base}/stub")
    status, body, _ = http_call("GET", f"{base}/stub?location")
    assert status == 200 and b"LocationConstraint" in body
    status, body, _ = http_call("GET", f"{base}/stub?versioning")
    assert status == 200 and b"VersioningConfiguration" in body
    status, body, _ = http_call("GET", f"{base}/stub?acl")
    assert status == 200 and b"FULL_CONTROL" in body
    status, body, _ = http_call("GET", f"{base}/stub?uploads")
    assert status == 200 and b"ListMultipartUploadsResult" in body


def test_circuit_breaker(s3stack):
    from seaweedfs_tpu_torch.gateway.s3_server import CircuitBreaker
    cb = CircuitBreaker(global_read=2, buckets={"hot": {"Write": 1}})
    assert cb.acquire("b", "Read") and cb.acquire("c", "Read")
    assert not cb.acquire("d", "Read")          # global read limit hit
    cb.release("b", "Read")
    assert cb.acquire("d", "Read")
    assert cb.acquire("hot", "Write")
    assert not cb.acquire("hot", "Write")       # bucket write limit hit
    assert cb.acquire("cold", "Write")          # other buckets unaffected
    # wired into the server: saturate and expect 503
    base = f"http://{s3stack.url}"
    http_call("PUT", f"{base}/cbk")
    http_call("PUT", f"{base}/cbk/f.txt", body=b"d")
    s3stack.breaker.global_limits["Read"] = 1
    s3stack.breaker.acquire("cbk", "Read")
    try:
        status, body, _ = http_call("GET", f"{base}/cbk/f.txt")
        assert status == 503 and b"TooManyRequests" in body
    finally:
        s3stack.breaker.release("cbk", "Read")
        s3stack.breaker.global_limits["Read"] = 0
    status, _, _ = http_call("GET", f"{base}/cbk/f.txt")
    assert status == 200


def _sigv4_presign(method, host, path, akid, secret, expires=900):
    import hashlib
    import hmac
    import urllib.parse
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    scope = f"{date}/us-east-1/s3/aws4_request"
    query = {
        "X-Amz-Algorithm": "AWS4-HMAC-SHA256",
        "X-Amz-Credential": f"{akid}/{scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    }
    cq = "&".join(f"{urllib.parse.quote(k, safe='~')}="
                  f"{urllib.parse.quote(v, safe='~')}"
                  for k, v in sorted(query.items()))
    # sign the percent-encoded wire path verbatim, like real clients
    creq = "\n".join([method, path, cq,
                      f"host:{host}\n", "host", "UNSIGNED-PAYLOAD"])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    k = ("AWS4" + secret).encode()
    for msg in (date, "us-east-1", "s3", "aws4_request"):
        k = hmac.new(k, msg.encode(), hashlib.sha256).digest()
    sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
    query["X-Amz-Signature"] = sig
    return (f"http://{host}{path}?" +
            urllib.parse.urlencode(query))


@pytest.fixture
def s3auth(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _cpu_vs([str(tmp_path / "va")], master.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    s3 = S3Server(fs, access_key="AKID", secret_key="SECRET")
    s3.start()
    time.sleep(0.2)
    yield s3
    s3.stop()
    fs.stop()
    vs.stop()
    master.stop()


def test_presigned_url(s3auth):
    host = s3auth.url
    # seed a bucket+object directly through the filer (bypassing auth)
    s3auth.filer.mkdirs("/buckets/pre")
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    e = Entry("/buckets/pre/doc.txt",
              attr=Attr(mtime=time.time(), crtime=time.time(),
                        file_size=5))
    e.content = b"hello"
    s3auth.filer.create_entry(e)
    # unsigned request is rejected
    status, _, _ = http_call("GET", f"http://{host}/pre/doc.txt")
    assert status == 403
    # presigned GET succeeds
    url = _sigv4_presign("GET", host, "/pre/doc.txt", "AKID", "SECRET")
    status, body, _ = http_call("GET", url)
    assert status == 200 and body == b"hello"
    # tampered signature fails
    bad = url[:-4] + "0000"
    status, _, _ = http_call("GET", bad)
    assert status == 403
    # presigned PUT works too
    url = _sigv4_presign("PUT", host, "/pre/up.txt", "AKID", "SECRET")
    status, _, _ = http_call("PUT", url, body=b"data!")
    assert status == 200
    url = _sigv4_presign("GET", host, "/pre/up.txt", "AKID", "SECRET")
    status, body, _ = http_call("GET", url)
    assert body == b"data!"
    # percent-encoded key: signature covers the wire path verbatim
    url = _sigv4_presign("PUT", host, "/pre/a%20b.txt", "AKID", "SECRET")
    status, _, _ = http_call("PUT", url, body=b"spaced")
    assert status == 200
    url = _sigv4_presign("GET", host, "/pre/a%20b.txt", "AKID", "SECRET")
    status, body, _ = http_call("GET", url)
    assert status == 200 and body == b"spaced"


def test_post_policy_upload(s3auth):
    import base64
    import hashlib
    import hmac
    import json
    host = s3auth.url
    s3auth.filer.mkdirs("/buckets/forms")
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    scope = f"{date}/us-east-1/s3/aws4_request"
    policy = base64.b64encode(json.dumps({
        "expiration": time.strftime("%Y-%m-%dT%H:%M:%S.000Z",
                                    time.gmtime(time.time() + 600)),
        "conditions": [{"bucket": "forms"}],
    }).encode()).decode()
    k = b"AWS4SECRET"
    for msg in (date, "us-east-1", "s3", "aws4_request"):
        k = hmac.new(k, msg.encode(), hashlib.sha256).digest()
    sig = hmac.new(k, policy.encode(), hashlib.sha256).hexdigest()
    boundary = "testboundary123"
    fields = {
        "key": "uploads/${filename}",
        "policy": policy,
        "x-amz-credential": f"AKID/{scope}",
        "x-amz-signature": sig,
        "success_action_status": "201",
    }
    parts = []
    for name, val in fields.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"{name}\"\r\n\r\n{val}\r\n".encode())
    parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                 f"name=\"file\"; filename=\"report.pdf\"\r\n"
                 f"Content-Type: application/pdf\r\n\r\n".encode()
                 + b"PDFDATA" + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    body = b"".join(parts)
    status, _, _ = http_call(
        "POST", f"http://{host}/forms", body=body,
        headers={"Content-Type":
                 f"multipart/form-data; boundary={boundary}"})
    assert status == 201
    url = _sigv4_presign("GET", host, "/forms/uploads/report.pdf",
                         "AKID", "SECRET")
    status, body, _ = http_call("GET", url)
    assert status == 200 and body == b"PDFDATA"
    # bad signature rejected
    fields["x-amz-signature"] = "0" * 64
    parts = []
    for name, val in fields.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"{name}\"\r\n\r\n{val}\r\n".encode())
    parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                 f"name=\"file\"; filename=\"x\"\r\n\r\n".encode()
                 + b"NO" + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    status, _, _ = http_call(
        "POST", f"http://{host}/forms", body=b"".join(parts),
        headers={"Content-Type":
                 f"multipart/form-data; boundary={boundary}"})
    assert status == 403


def test_post_policy_conditions(s3auth):
    import base64
    import hashlib
    import hmac
    import json
    host = s3auth.url
    s3auth.filer.mkdirs("/buckets/open")
    s3auth.filer.mkdirs("/buckets/locked")
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    scope = f"{date}/us-east-1/s3/aws4_request"

    def signed_policy(conditions):
        policy = base64.b64encode(json.dumps({
            "expiration": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime(time.time() + 600)),
            "conditions": conditions,
        }).encode()).decode()
        k = b"AWS4SECRET"
        for msg in (date, "us-east-1", "s3", "aws4_request"):
            k = hmac.new(k, msg.encode(), hashlib.sha256).digest()
        return policy, hmac.new(k, policy.encode(),
                                hashlib.sha256).hexdigest()

    def post(bucket, key, data, conditions):
        policy, sig = signed_policy(conditions)
        boundary = "bnd42"
        fields = {"key": key, "policy": policy,
                  "x-amz-credential": f"AKID/{scope}",
                  "x-amz-signature": sig}
        parts = [f"--{boundary}\r\nContent-Disposition: form-data; "
                 f"name=\"{n}\"\r\n\r\n{v}\r\n".encode()
                 for n, v in fields.items()]
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"file\"; filename=\"f\"\r\n\r\n".encode()
                     + data + b"\r\n")
        parts.append(f"--{boundary}--\r\n".encode())
        status, _, _ = http_call(
            "POST", f"http://{host}/{bucket}", body=b"".join(parts),
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        return status

    conds = [{"bucket": "open"}, ["starts-with", "$key", "in/"],
             ["content-length-range", 1, 100]]
    # policy scoped to bucket "open" must not write elsewhere
    assert post("locked", "in/a.txt", b"hi", conds) == 403
    # key outside starts-with prefix rejected
    assert post("open", "out/a.txt", b"hi", conds) == 403
    # oversize body rejected
    assert post("open", "in/big.txt", b"x" * 200, conds) == 403
    # conforming upload succeeds; ISO expiration without millis accepted
    assert post("open", "in/a.txt", b"hi\n", conds) == 204
    url = _sigv4_presign("GET", host, "/open/in/a.txt", "AKID", "SECRET")
    status, body, _ = http_call("GET", url)
    # trailing newline in the payload survives multipart parsing
    assert status == 200 and body == b"hi\n"
