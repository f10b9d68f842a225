"""External-client S3 compatibility matrix.

Each case is named after (and mirrors the assertions of) its ceph
s3-tests equivalent — the suite the reference runs in Docker
(test/s3/compatibility/run.sh, s3tests.conf) — plus the AWS-SDK basic
tests (test/s3/basic/basic_test.go). The requests here are built the
way external clients build them (SigV4 presign/header auth, multipart
form posts, XML payloads), not through any gateway-internal helper.


The port's copy of ref tests/test_s3_compat.py: the same cases on the port's
gateway, filer and master, its volume servers on device="cpu"."""

import base64
import hashlib
import hmac
import json
import time
import urllib.parse
import xml.etree.ElementTree as ET

import pytest

from seaweedfs_tpu_torch.gateway.s3_server import S3Server
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils import sigv4
from seaweedfs_tpu_torch.utils.httpd import http_call


def _cpu_vs(dirs, master_url, **kw):
    """The port's volume server on the kernels' plain versions (the
    tests run without a card)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(dirs, master_url, device="cpu", **kw)

AK, SK = "WEEDTPUACCESSKEY", "weedtpu/secret/KEY"


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s3compat")
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _cpu_vs([str(tmp / "v0")], master.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    time.sleep(0.2)
    yield master, vs, fs
    fs.stop()
    vs.stop()
    master.stop()


@pytest.fixture(scope="module")
def s3(cluster):
    _, _, fs = cluster
    srv = S3Server(fs)  # anonymous: most s3tests run without per-case auth
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def s3auth(cluster):
    _, _, fs = cluster
    srv = S3Server(fs, access_key=AK, secret_key=SK)
    srv.start()
    yield srv
    srv.stop()


_COUNTER = [0]


def bucket_name() -> str:
    _COUNTER[0] += 1
    return f"s3tests-bucket-{_COUNTER[0]}"


def mk_bucket(s3) -> str:
    b = bucket_name()
    status, _, _ = http_call("PUT", f"http://{s3.url}/{b}")
    assert status == 200
    return b


def put(s3, bucket, key, body=b"", headers=None):
    return http_call("PUT", f"http://{s3.url}/{bucket}/{key}", body=body,
                     headers=headers)


def list_keys(body):
    root = ET.fromstring(body)
    return [c.find("Key").text for c in root.findall("Contents")]


# ---------------------------------------------------------------- listing

def test_bucket_list_empty(s3):
    b = mk_bucket(s3)
    status, body, _ = http_call("GET", f"http://{s3.url}/{b}")
    assert status == 200
    assert list_keys(body) == []
    assert ET.fromstring(body).find("IsTruncated").text == "false"


def test_bucket_list_distinct(s3):
    b1, b2 = mk_bucket(s3), mk_bucket(s3)
    put(s3, b1, "only-in-one", b"x")
    _, body1, _ = http_call("GET", f"http://{s3.url}/{b1}")
    _, body2, _ = http_call("GET", f"http://{s3.url}/{b2}")
    assert list_keys(body1) == ["only-in-one"]
    assert list_keys(body2) == []


def test_bucket_list_many(s3):
    b = mk_bucket(s3)
    for k in ("foo", "bar", "baz"):
        put(s3, b, k, b"d")
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}?max-keys=2")
    root = ET.fromstring(body)
    assert list_keys(body) == ["bar", "baz"]
    assert root.find("IsTruncated").text == "true"
    _, body, _ = http_call("GET",
                           f"http://{s3.url}/{b}?max-keys=2&marker=baz")
    assert list_keys(body) == ["foo"]
    assert ET.fromstring(body).find("IsTruncated").text == "false"


def test_bucket_list_delimiter_basic(s3):
    b = mk_bucket(s3)
    for k in ("foo/bar", "foo/bar/xyzzy", "quux/thud", "asdf"):
        put(s3, b, k, b"d")
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}?delimiter=/")
    root = ET.fromstring(body)
    assert list_keys(body) == ["asdf"]
    prefixes = [p.find("Prefix").text
                for p in root.findall("CommonPrefixes")]
    assert sorted(prefixes) == ["foo/", "quux/"]


def test_bucket_list_delimiter_prefix(s3):
    b = mk_bucket(s3)
    for k in ("asdf", "boo/bar", "boo/baz/xyzzy", "cquux/thud"):
        put(s3, b, k, b"d")
    _, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}?delimiter=/&prefix=boo/")
    root = ET.fromstring(body)
    assert list_keys(body) == ["boo/bar"]
    assert [p.find("Prefix").text
            for p in root.findall("CommonPrefixes")] == ["boo/baz/"]


def test_bucket_list_prefix_basic(s3):
    b = mk_bucket(s3)
    for k in ("foo/bar", "foo/baz", "quux"):
        put(s3, b, k, b"d")
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}?prefix=foo/")
    assert list_keys(body) == ["foo/bar", "foo/baz"]


def test_bucket_list_maxkeys_one(s3):
    b = mk_bucket(s3)
    keys = ["bar", "baz", "foo", "quxx"]
    for k in keys:
        put(s3, b, k, b"d")
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}?max-keys=1")
    root = ET.fromstring(body)
    assert list_keys(body) == ["bar"]
    assert root.find("IsTruncated").text == "true"
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}?marker=bar")
    assert list_keys(body) == ["baz", "foo", "quxx"]


def test_bucket_listv2_continuationtoken(s3):
    b = mk_bucket(s3)
    for k in ("bar", "baz", "foo", "quxx"):
        put(s3, b, k, b"d")
    _, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}?list-type=2&max-keys=2")
    root = ET.fromstring(body)
    assert list_keys(body) == ["bar", "baz"]
    token = root.find("NextContinuationToken").text
    _, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}?list-type=2"
               f"&continuation-token={urllib.parse.quote(token)}")
    assert list_keys(body) == ["foo", "quxx"]


def test_bucket_listv2_startafter(s3):
    b = mk_bucket(s3)
    for k in ("bar", "baz", "foo", "quxx"):
        put(s3, b, k, b"d")
    _, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}?list-type=2&start-after=baz")
    assert list_keys(body) == ["foo", "quxx"]


def test_bucket_list_return_data(s3):
    b = mk_bucket(s3)
    payload = b"return-data-payload"
    put(s3, b, "foo", payload)
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}")
    c = ET.fromstring(body).find("Contents")
    assert c.find("Key").text == "foo"
    assert int(c.find("Size").text) == len(payload)
    assert c.find("ETag").text.strip('"')


def test_bucket_list_after_multipart(s3):
    """A multipart-completed object appears in listings with its full
    composed size (the list-after-multipart corner)."""
    b = mk_bucket(s3)
    part = b"p" * (5 * 1024 * 1024)
    _, body, _ = http_call("POST", f"http://{s3.url}/{b}/mp.bin?uploads")
    upload_id = ET.fromstring(body).find("UploadId").text
    etags = []
    for n in (1, 2):
        status, _, h = http_call(
            "PUT", f"http://{s3.url}/{b}/mp.bin"
                   f"?partNumber={n}&uploadId={upload_id}", body=part)
        assert status == 200
        etags.append(h["ETag"])
    complete = ET.Element("CompleteMultipartUpload")
    for n, etag in enumerate(etags, 1):
        p = ET.SubElement(complete, "Part")
        ET.SubElement(p, "PartNumber").text = str(n)
        ET.SubElement(p, "ETag").text = etag
    status, _, _ = http_call(
        "POST", f"http://{s3.url}/{b}/mp.bin?uploadId={upload_id}",
        body=ET.tostring(complete))
    assert status == 200
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}")
    c = ET.fromstring(body).find("Contents")
    assert c.find("Key").text == "mp.bin"
    assert int(c.find("Size").text) == 2 * len(part)


# ---------------------------------------------------------------- objects

def test_object_write_read_update_read_delete(s3):
    b = mk_bucket(s3)
    status, _, _ = put(s3, b, "obj", b"zzz")
    assert status == 200
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}/obj")
    assert body == b"zzz"
    put(s3, b, "obj", b"new-content")
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}/obj")
    assert body == b"new-content"
    status, _, _ = http_call("DELETE", f"http://{s3.url}/{b}/obj")
    assert status == 204
    status, _, _ = http_call("GET", f"http://{s3.url}/{b}/obj")
    assert status == 404


def test_object_head(s3):
    b = mk_bucket(s3)
    put(s3, b, "h", b"head-me-12345")
    status, body, headers = http_call("HEAD", f"http://{s3.url}/{b}/h")
    assert status == 200
    assert body == b""
    assert int(headers["Content-Length"]) == 13
    assert headers.get("ETag")


def test_object_requestid_on_error(s3):
    # ceph checks error XML carries Code/Message fields
    status, body, _ = http_call("GET", f"http://{s3.url}/no-such/key")
    assert status == 404
    root = ET.fromstring(body)
    assert root.tag == "Error" and root.find("Code") is not None


def test_multi_object_delete(s3):
    b = mk_bucket(s3)
    for k in ("key0", "key1", "key2"):
        put(s3, b, k, b"d")
    delete = ET.Element("Delete")
    for k in ("key0", "key1", "key2"):
        o = ET.SubElement(delete, "Object")
        ET.SubElement(o, "Key").text = k
    status, body, _ = http_call("POST", f"http://{s3.url}/{b}?delete",
                                body=ET.tostring(delete))
    assert status == 200
    deleted = [d.find("Key").text
               for d in ET.fromstring(body).findall("Deleted")]
    assert sorted(deleted) == ["key0", "key1", "key2"]
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}")
    assert list_keys(body) == []


# ------------------------------------------------------------------ copy

def test_object_copy_same_bucket(s3):
    b = mk_bucket(s3)
    put(s3, b, "foo123bar", b"foo")
    status, _, _ = put(s3, b, "bar321foo", b"",
                       headers={"x-amz-copy-source": f"/{b}/foo123bar"})
    assert status == 200
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}/bar321foo")
    assert body == b"foo"


def test_object_copy_diff_bucket(s3):
    b1, b2 = mk_bucket(s3), mk_bucket(s3)
    put(s3, b1, "foo123bar", b"cross-bucket")
    status, _, _ = put(s3, b2, "bar321foo", b"",
                       headers={"x-amz-copy-source": f"/{b1}/foo123bar"})
    assert status == 200
    _, body, _ = http_call("GET", f"http://{s3.url}/{b2}/bar321foo")
    assert body == b"cross-bucket"


def test_object_copy_retaining_metadata(s3):
    b = mk_bucket(s3)
    put(s3, b, "src-keep", b"meta", headers={"x-amz-tagging": "k1=v1"})
    put(s3, b, "dst-keep", b"",
        headers={"x-amz-copy-source": f"/{b}/src-keep"})
    _, body, _ = http_call("GET",
                           f"http://{s3.url}/{b}/dst-keep?tagging")
    assert b"<Key>k1</Key>" in body and b"<Value>v1</Value>" in body


def test_object_copy_replacing_metadata(s3):
    b = mk_bucket(s3)
    put(s3, b, "src-repl", b"meta", headers={"x-amz-tagging": "k1=v1"})
    put(s3, b, "dst-repl", b"",
        headers={"x-amz-copy-source": f"/{b}/src-repl",
                 "x-amz-metadata-directive": "REPLACE",
                 "x-amz-tagging": "k2=v2"})
    _, body, _ = http_call("GET",
                           f"http://{s3.url}/{b}/dst-repl?tagging")
    assert b"k2" in body and b"k1" not in body


def test_object_copy_key_not_found(s3):
    b = mk_bucket(s3)
    status, _, _ = put(s3, b, "dst", b"",
                       headers={"x-amz-copy-source": f"/{b}/missing"})
    assert status == 404


# --------------------------------------------------------------- tagging

def test_object_set_get_tagging(s3):
    b = mk_bucket(s3)
    put(s3, b, "tagged", b"d")
    tagging = ET.Element("Tagging")
    ts = ET.SubElement(tagging, "TagSet")
    t = ET.SubElement(ts, "Tag")
    ET.SubElement(t, "Key").text = "color"
    ET.SubElement(t, "Value").text = "blue"
    status, _, _ = http_call(
        "PUT", f"http://{s3.url}/{b}/tagged?tagging",
        body=ET.tostring(tagging))
    assert status == 200
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}/tagged?tagging")
    assert b"<Key>color</Key>" in body and b"<Value>blue</Value>" in body


def test_object_delete_tagging(s3):
    b = mk_bucket(s3)
    put(s3, b, "untag", b"d", headers={"x-amz-tagging": "a=b"})
    status, _, _ = http_call(
        "DELETE", f"http://{s3.url}/{b}/untag?tagging")
    assert status == 204
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}/untag?tagging")
    assert b"<Tag>" not in body


# ------------------------------------------------------------- multipart

def test_multipart_upload_list_parts(s3):
    b = mk_bucket(s3)
    part = b"q" * (5 * 1024 * 1024)
    _, body, _ = http_call("POST", f"http://{s3.url}/{b}/lp.bin?uploads")
    upload_id = ET.fromstring(body).find("UploadId").text
    for n in (1, 2):
        http_call("PUT", f"http://{s3.url}/{b}/lp.bin"
                         f"?partNumber={n}&uploadId={upload_id}",
                  body=part)
    status, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}/lp.bin?uploadId={upload_id}")
    assert status == 200
    root = ET.fromstring(body)
    nums = sorted(int(p.find("PartNumber").text)
                  for p in root.findall("Part"))
    assert nums == [1, 2]
    for p in root.findall("Part"):
        assert int(p.find("Size").text) == len(part)


def test_list_multipart_upload(s3):
    b = mk_bucket(s3)
    _, body, _ = http_call("POST",
                           f"http://{s3.url}/{b}/inflight.bin?uploads")
    upload_id = ET.fromstring(body).find("UploadId").text
    status, body, _ = http_call("GET", f"http://{s3.url}/{b}?uploads")
    assert status == 200
    root = ET.fromstring(body)
    pairs = [(u.find("Key").text, u.find("UploadId").text)
             for u in root.findall("Upload")]
    assert ("inflight.bin", upload_id) in pairs
    http_call("DELETE", f"http://{s3.url}/{b}/inflight.bin"
                        f"?uploadId={upload_id}")


def test_abort_multipart_upload(s3):
    b = mk_bucket(s3)
    part = b"a" * (5 * 1024 * 1024)
    _, body, _ = http_call("POST",
                           f"http://{s3.url}/{b}/abort.bin?uploads")
    upload_id = ET.fromstring(body).find("UploadId").text
    http_call("PUT", f"http://{s3.url}/{b}/abort.bin"
                     f"?partNumber=1&uploadId={upload_id}", body=part)
    status, _, _ = http_call(
        "DELETE", f"http://{s3.url}/{b}/abort.bin?uploadId={upload_id}")
    assert status == 204
    # the upload is gone from the in-progress listing...
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}?uploads")
    assert upload_id not in body.decode()
    # ...and no object materialized
    status, _, _ = http_call("GET", f"http://{s3.url}/{b}/abort.bin")
    assert status == 404


def test_multipart_upload_overwrite_existing_object(s3):
    b = mk_bucket(s3)
    put(s3, b, "ow.bin", b"old plain object")
    part = b"n" * (5 * 1024 * 1024)
    _, body, _ = http_call("POST", f"http://{s3.url}/{b}/ow.bin?uploads")
    upload_id = ET.fromstring(body).find("UploadId").text
    _, _, h = http_call("PUT", f"http://{s3.url}/{b}/ow.bin"
                               f"?partNumber=1&uploadId={upload_id}",
                        body=part)
    complete = ET.Element("CompleteMultipartUpload")
    p = ET.SubElement(complete, "Part")
    ET.SubElement(p, "PartNumber").text = "1"
    ET.SubElement(p, "ETag").text = h["ETag"]
    status, _, _ = http_call(
        "POST", f"http://{s3.url}/{b}/ow.bin?uploadId={upload_id}",
        body=ET.tostring(complete))
    assert status == 200
    _, body, _ = http_call("GET", f"http://{s3.url}/{b}/ow.bin")
    assert body == part


# ---------------------------------------------------------- presigned urls

def _presign(s3, method, bucket, key, expires=900, amz_date=None,
             secret=SK):
    host = s3.url
    amz_date = amz_date or time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    query = {
        "X-Amz-Algorithm": "AWS4-HMAC-SHA256",
        "X-Amz-Credential": f"{AK}/{date}/us-east-1/s3/aws4_request",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    }
    sig = sigv4.signature(
        secret, date, "us-east-1", "s3", amz_date, method,
        f"/{bucket}/{key}", query, {"host": host}, ["host"],
        "UNSIGNED-PAYLOAD")
    query["X-Amz-Signature"] = sig
    qs = urllib.parse.urlencode(query)
    return f"http://{host}/{bucket}/{key}?{qs}"


def _auth_put_bucket(s3, bucket):
    # header-auth bucket create against the authed gateway
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    headers = {"host": s3.url, "x-amz-date": amz_date,
               "x-amz-content-sha256": "UNSIGNED-PAYLOAD"}
    sig = sigv4.signature(SK, date, "us-east-1", "s3", amz_date, "PUT",
                          f"/{bucket}", {}, headers,
                          ["host", "x-amz-content-sha256", "x-amz-date"],
                          "UNSIGNED-PAYLOAD")
    headers["Authorization"] = (
        "AWS4-HMAC-SHA256 "
        f"Credential={AK}/{date}/us-east-1/s3/aws4_request, "
        "SignedHeaders=host;x-amz-content-sha256;x-amz-date, "
        f"Signature={sig}")
    status, _, _ = http_call("PUT", f"http://{s3.url}/{bucket}",
                             headers=headers)
    assert status == 200


def test_object_raw_get_x_amz_expires_not_expired(s3auth):
    b = bucket_name()
    _auth_put_bucket(s3auth, b)
    url = _presign(s3auth, "PUT", b, "pre.txt")
    status, _, _ = http_call("PUT", url, body=b"presigned body")
    assert status == 200
    status, body, _ = http_call("GET", _presign(s3auth, "GET", b,
                                                "pre.txt"))
    assert status == 200 and body == b"presigned body"


def test_object_raw_get_x_amz_expires_out_range(s3auth):
    b = bucket_name()
    _auth_put_bucket(s3auth, b)
    old = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(time.time() - 7200))
    url = _presign(s3auth, "GET", b, "anything", expires=60,
                   amz_date=old)
    status, body, _ = http_call("GET", url)
    assert status == 403


def test_object_raw_get_x_amz_expires_bad_signature(s3auth):
    b = bucket_name()
    _auth_put_bucket(s3auth, b)
    url = _presign(s3auth, "GET", b, "k", secret="wrong-secret")
    status, body, _ = http_call("GET", url)
    assert status == 403
    assert b"SignatureDoesNotMatch" in body or b"AccessDenied" in body


def test_object_anon_put_write_access_denied(s3auth):
    # with credentials configured, an unsigned write is refused
    b = bucket_name()
    _auth_put_bucket(s3auth, b)
    status, _, _ = http_call("PUT", f"http://{s3auth.url}/{b}/anon",
                             body=b"nope")
    assert status == 403


# ------------------------------------------------------------ post policy

def _post_form(fields: dict, file_data: bytes,
               boundary=b"s3compatboundary") -> bytes:
    out = bytearray()
    for name, value in fields.items():
        out += b"--" + boundary + b"\r\n"
        out += (f'Content-Disposition: form-data; name="{name}"'
                "\r\n\r\n").encode()
        out += str(value).encode() + b"\r\n"
    out += b"--" + boundary + b"\r\n"
    out += (b'Content-Disposition: form-data; name="file"; '
            b'filename="data.bin"\r\n'
            b"Content-Type: application/octet-stream\r\n\r\n")
    out += file_data + b"\r\n--" + boundary + b"--\r\n"
    return bytes(out)


def _policy_fields(bucket, key, expire_in=600):
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    expiration = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                               time.gmtime(time.time() + expire_in))
    policy = base64.b64encode(json.dumps({
        "expiration": expiration,
        "conditions": [{"bucket": bucket}, ["starts-with", "$key", ""]],
    }).encode()).decode()
    key_scope = f"{AK}/{date}/us-east-1/s3/aws4_request"
    sig = hmac.new(sigv4.signing_key(SK, date, "us-east-1", "s3"),
                   policy.encode(), hashlib.sha256).hexdigest()
    return {"key": key, "policy": policy, "x-amz-credential": key_scope,
            "x-amz-signature": sig, "x-amz-date": amz_date}


def test_post_object_authenticated_request(s3auth):
    b = bucket_name()
    _auth_put_bucket(s3auth, b)
    fields = _policy_fields(b, "posted.bin")
    body = _post_form(fields, b"posted content")
    status, _, _ = http_call(
        "POST", f"http://{s3auth.url}/{b}", body=body,
        headers={"Content-Type":
                 'multipart/form-data; boundary="s3compatboundary"'})
    assert status == 204
    status, got, _ = http_call(
        "GET", _presign(s3auth, "GET", b, "posted.bin"))
    assert status == 200 and got == b"posted content"


def test_post_object_expired_policy(s3auth):
    b = bucket_name()
    _auth_put_bucket(s3auth, b)
    fields = _policy_fields(b, "late.bin", expire_in=-600)
    status, body, _ = http_call(
        "POST", f"http://{s3auth.url}/{b}",
        body=_post_form(fields, b"x"),
        headers={"Content-Type":
                 'multipart/form-data; boundary="s3compatboundary"'})
    assert status == 403


def test_post_object_missing_signature(s3auth):
    b = bucket_name()
    _auth_put_bucket(s3auth, b)
    fields = _policy_fields(b, "nosig.bin")
    del fields["x-amz-signature"]
    fields["x-amz-signature"] = "0" * 64
    status, _, _ = http_call(
        "POST", f"http://{s3auth.url}/{b}",
        body=_post_form(fields, b"x"),
        headers={"Content-Type":
                 'multipart/form-data; boundary="s3compatboundary"'})
    assert status == 403


def test_post_object_anonymous_request(s3):
    # no credentials configured: the policy is optional, form works
    b = mk_bucket(s3)
    body = _post_form({"key": "anon-posted.txt"}, b"anon post")
    status, _, _ = http_call(
        "POST", f"http://{s3.url}/{b}", body=body,
        headers={"Content-Type":
                 'multipart/form-data; boundary="s3compatboundary"'})
    assert status == 204
    _, got, _ = http_call("GET",
                          f"http://{s3.url}/{b}/anon-posted.txt")
    assert got == b"anon post"


def test_post_object_upload_larger_than_chunk(s3):
    b = mk_bucket(s3)
    payload = bytes(range(256)) * 32768  # 8MB: chunked storage path
    body = _post_form({"key": "large.bin"}, payload)
    status, _, _ = http_call(
        "POST", f"http://{s3.url}/{b}", body=body,
        headers={"Content-Type":
                 'multipart/form-data; boundary="s3compatboundary"'})
    assert status == 204
    _, got, _ = http_call("GET", f"http://{s3.url}/{b}/large.bin")
    assert got == payload


def test_post_object_set_success_code(s3):
    b = mk_bucket(s3)
    body = _post_form({"key": "code.txt",
                       "success_action_status": "201"}, b"x")
    status, _, _ = http_call(
        "POST", f"http://{s3.url}/{b}", body=body,
        headers={"Content-Type":
                 'multipart/form-data; boundary="s3compatboundary"'})
    assert status == 201


# ------------------------------------------------------------- range/raw

def test_ranged_request_response_code(s3):
    b = mk_bucket(s3)
    content = b"testcontent"
    put(s3, b, "rng", content)
    status, body, headers = http_call(
        "GET", f"http://{s3.url}/{b}/rng",
        headers={"Range": "bytes=4-7"})
    assert status == 206
    assert body == content[4:8]
    assert headers["Content-Range"] == f"bytes 4-7/{len(content)}"


def test_ranged_request_skip_leading_bytes_response_code(s3):
    b = mk_bucket(s3)
    content = b"testcontent"
    put(s3, b, "rng2", content)
    status, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}/rng2",
        headers={"Range": "bytes=4-"})
    assert status == 206 and body == content[4:]


def test_ranged_request_return_trailing_bytes_response_code(s3):
    b = mk_bucket(s3)
    content = b"testcontent"
    put(s3, b, "rng3", content)
    status, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}/rng3",
        headers={"Range": "bytes=-7"})
    assert status == 206 and body == content[-7:]


def test_bucket_head(s3):
    b = mk_bucket(s3)
    status, _, _ = http_call("HEAD", f"http://{s3.url}/{b}")
    assert status == 200


def test_bucket_head_notexist(s3):
    status, _, _ = http_call("HEAD",
                             f"http://{s3.url}/never-created-bkt")
    assert status == 404


def test_ranged_request_invalid_range(s3):
    # range beyond the entity: 416 InvalidRange, never a 200 full body
    b = mk_bucket(s3)
    put(s3, b, "short", b"testcontent")
    status, body, headers = http_call(
        "GET", f"http://{s3.url}/{b}/short",
        headers={"Range": "bytes=40-50"})
    assert status == 416
    assert b"InvalidRange" in body
    assert headers["Content-Range"] == "bytes */11"


def test_multipart_listparts_pagination(s3):
    b = mk_bucket(s3)
    part = b"z" * (5 * 1024 * 1024)
    _, body, _ = http_call("POST", f"http://{s3.url}/{b}/pg.bin?uploads")
    upload_id = ET.fromstring(body).find("UploadId").text
    for n in (1, 2, 3):
        http_call("PUT", f"http://{s3.url}/{b}/pg.bin"
                         f"?partNumber={n}&uploadId={upload_id}",
                  body=part)
    _, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}/pg.bin"
               f"?uploadId={upload_id}&max-parts=2")
    root = ET.fromstring(body)
    assert [int(p.find("PartNumber").text)
            for p in root.findall("Part")] == [1, 2]
    assert root.find("IsTruncated").text == "true"
    marker = root.find("NextPartNumberMarker").text
    _, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}/pg.bin"
               f"?uploadId={upload_id}&part-number-marker={marker}")
    root = ET.fromstring(body)
    assert [int(p.find("PartNumber").text)
            for p in root.findall("Part")] == [3]
    assert root.find("IsTruncated").text == "false"
    http_call("DELETE",
              f"http://{s3.url}/{b}/pg.bin?uploadId={upload_id}")


def test_multipart_listparts_wrong_key_is_nosuchupload(s3):
    b = mk_bucket(s3)
    _, body, _ = http_call("POST",
                           f"http://{s3.url}/{b}/real.bin?uploads")
    upload_id = ET.fromstring(body).find("UploadId").text
    status, body, _ = http_call(
        "GET", f"http://{s3.url}/{b}/OTHER.bin?uploadId={upload_id}")
    assert status == 404 and b"NoSuchUpload" in body
    http_call("DELETE",
              f"http://{s3.url}/{b}/real.bin?uploadId={upload_id}")


def test_ranged_request_start_beyond_eof_open_ended(s3):
    # 'bytes=99-' on a short object is unsatisfiable too (the open-
    # ended form must not be mistaken for a malformed spec)
    b = mk_bucket(s3)
    put(s3, b, "tiny", b"0123456789")
    status, body, headers = http_call(
        "GET", f"http://{s3.url}/{b}/tiny",
        headers={"Range": "bytes=99-"})
    assert status == 416 and b"InvalidRange" in body
    assert headers["Content-Range"] == "bytes */10"
