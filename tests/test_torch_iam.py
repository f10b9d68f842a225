"""IAM API + S3 SigV4 auth with IAM-managed credentials, and the
filer's S3 Configure gRPC service with the circuit breaker it feeds.

The port's copy of ref tests/test_iam.py and the S3 cases of
tests/test_proto_planes.py (test_s3_configure_rpc,
test_circuit_breaker_hot_reload), on the port's gateway, filer and
master, its volume servers on device="cpu"."""

import datetime
import json
import hashlib
import hmac
import time
import urllib.parse
import xml.etree.ElementTree as ET

import pytest

from seaweedfs_tpu_torch.gateway.iam_server import IamServer
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
def stack(tmp_path):
    master = MasterServer()
    master.start()
    vs = _cpu_vs([str(tmp_path / "v")], master.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    iam = IamServer(fs)
    iam.start()
    s3 = S3Server(fs)
    s3.start()
    time.sleep(0.1)
    yield iam, s3
    s3.stop()
    iam.stop()
    fs.stop()
    vs.stop()
    master.stop()


def _iam(url, **params):
    body = urllib.parse.urlencode(params).encode()
    status, resp, _ = http_call("POST", f"http://{url}/", body=body)
    return status, resp


def test_iam_user_and_key_lifecycle(stack):
    iam, s3 = stack
    status, body = _iam(iam.url, Action="CreateUser", UserName="alice")
    assert status == 200 and b"alice" in body

    status, body = _iam(iam.url, Action="CreateUser", UserName="alice")
    assert status == 409

    status, body = _iam(iam.url, Action="CreateAccessKey", UserName="alice")
    assert status == 200
    root = ET.fromstring(body)
    akid = root.find(".//AccessKeyId").text
    secret = root.find(".//SecretAccessKey").text
    assert akid.startswith("AKID") and secret

    status, body = _iam(iam.url, Action="ListUsers")
    assert b"alice" in body

    status, body = _iam(iam.url, Action="PutUserPolicy", UserName="alice",
                        PolicyDocument='{"Statement": []}')
    assert status == 200
    status, body = _iam(iam.url, Action="GetUserPolicy", UserName="alice")
    assert b"Statement" in body

    status, body = _iam(iam.url, Action="DeleteAccessKey", AccessKeyId=akid)
    assert status == 200
    status, body = _iam(iam.url, Action="DeleteUser", UserName="bob")
    assert status == 404
    status, body = _iam(iam.url, Action="DeleteUser", UserName="alice")
    assert status == 200


def _sigv4_headers(method, host_url, path, akid, secret, body=b""):
    amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    region, service = "us-east-1", "s3"
    payload_hash = hashlib.sha256(body).hexdigest()
    signed = "host;x-amz-content-sha256;x-amz-date"
    ch = (f"host:{host_url}\n"
          f"x-amz-content-sha256:{payload_hash}\n"
          f"x-amz-date:{amz_date}\n")
    creq = "\n".join([method, path, "", ch, signed, payload_hash])
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    k = ("AWS4" + secret).encode()
    for msg in (date, region, service, "aws4_request"):
        k = hmac.new(k, msg.encode(), hashlib.sha256).digest()
    sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
    return {
        "Host": host_url,
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={akid}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"),
    }


def test_s3_uses_iam_credentials(stack):
    iam, s3 = stack
    # no identities yet: anonymous works
    status, _, _ = http_call("PUT", f"http://{s3.url}/open")
    assert status == 200

    _iam(iam.url, Action="CreateUser", UserName="carol")
    status, body = _iam(iam.url, Action="CreateAccessKey", UserName="carol")
    root = ET.fromstring(body)
    akid = root.find(".//AccessKeyId").text
    secret = root.find(".//SecretAccessKey").text

    # identities exist now: anonymous rejected
    status, body, _ = http_call("GET", f"http://{s3.url}/")
    assert status == 403

    # signed request with the IAM key succeeds
    headers = _sigv4_headers("GET", s3.url, "/", akid, secret)
    status, body, _ = http_call("GET", f"http://{s3.url}/",
                                headers=headers)
    assert status == 200 and b"ListAllMyBucketsResult" in body

    # signed with a WRONG secret fails
    headers = _sigv4_headers("GET", s3.url, "/", akid, "bogus")
    status, body, _ = http_call("GET", f"http://{s3.url}/",
                                headers=headers)
    assert status == 403


@pytest.fixture
def grpc_stack(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _cpu_vs([str(tmp_path / "v")], master.url)
    vs.start()
    fs = FilerServer(master.url, grpc_port=0)
    fs.start()
    time.sleep(0.1)
    yield master, vs, fs
    fs.stop()
    vs.stop()
    master.stop()


def test_s3_configure_rpc(grpc_stack):
    from seaweedfs_tpu_torch.gateway.iam_server import IdentityStore
    from seaweedfs_tpu_torch.pb import iam_pb2, s3_pb2
    from seaweedfs_tpu_torch.utils.tls import make_channel
    master, vs, fs = grpc_stack
    chan = make_channel(f"127.0.0.1:{fs.grpc_port}", role="client")
    fn = chan.unary_unary(
        "/weedtpu_s3_pb.SeaweedTpuS3/Configure",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=s3_pb2.S3ConfigureResponse.FromString)

    api = iam_pb2.S3ApiConfiguration(identities=[iam_pb2.Identity(
        name="alice",
        credentials=[iam_pb2.Credential(access_key="AKIA1",
                                        secret_key="s3cr3t")],
        actions=["Read", "Write"])])
    fn(s3_pb2.S3ConfigureRequest(
        s3_configuration_file_content=api.SerializeToString()), timeout=10)
    conf = IdentityStore(fs.filer).load()
    assert conf["identities"][0]["name"] == "alice"
    assert conf["identities"][0]["credentials"][0]["accessKey"] == "AKIA1"

    # legacy JSON payload is accepted too
    fn(s3_pb2.S3ConfigureRequest(s3_configuration_file_content=json.dumps(
        {"identities": [{"name": "bob", "credentials": [],
                         "actions": []}]}).encode()), timeout=10)
    assert IdentityStore(fs.filer).load()["identities"][0]["name"] == "bob"

    import grpc
    with pytest.raises(grpc.RpcError):
        fn(s3_pb2.S3ConfigureRequest(
            s3_configuration_file_content=b"\xff\xfegarbage that is "
            b"neither proto nor json"), timeout=10)
    # a JSON scalar must be INVALID_ARGUMENT, not an UNKNOWN crash
    with pytest.raises(grpc.RpcError) as exc:
        fn(s3_pb2.S3ConfigureRequest(
            s3_configuration_file_content=b"42"), timeout=10)
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    chan.close()


def test_circuit_breaker_hot_reload(grpc_stack):
    from seaweedfs_tpu_torch.gateway.s3_server import S3Server
    from seaweedfs_tpu_torch.shell.commands import ShellContext
    from seaweedfs_tpu_torch.shell.repl import run_command
    master, vs, fs = grpc_stack
    s3 = S3Server(fs, access_key="k", secret_key="s")
    s3.start()
    try:
        sh = ShellContext(master.url)
        out = run_command(
            sh, "s3.circuitbreaker -read 7 -write 3")
        assert out["global"] == {"enabled": True,
                                 "actions": {"Read": 7, "Write": 3}}
        out = run_command(sh, "s3.circuitbreaker -bucket pics -read 1")
        assert out["buckets"]["pics"]["actions"] == {"Read": 1}

        s3._cb_state = (0.0, -1.0)  # expire the TTL
        s3._refresh_breaker()
        assert s3.breaker.global_limits == {"Read": 7, "Write": 3}
        assert s3.breaker.bucket_limits == {"pics": {"Read": 1}}
        # the per-bucket Read limit of 1 actually trips
        assert s3.breaker.acquire("pics", "Read")
        assert not s3.breaker.acquire("pics", "Read")
        s3.breaker.release("pics", "Read")

        out = run_command(sh, "s3.circuitbreaker -disable")
        assert out["global"]["enabled"] is False
        s3._cb_state = (0.0, -1.0)
        s3._refresh_breaker()
        assert s3.breaker.global_limits == {}

        # query of an unconfigured bucket must not vivify it
        out = run_command(sh, "s3.circuitbreaker -bucket ghost")
        assert "ghost" not in out["buckets"]
        out = run_command(sh, "s3.circuitbreaker")
        assert "ghost" not in out["buckets"]

        # a config too big to inline (filer chunks >2KB) still loads
        from seaweedfs_tpu_torch.pb import s3_pb2
        big = s3_pb2.S3CircuitBreakerConfig()
        for i in range(200):
            big.buckets[f"bucket-{i:04d}"].enabled = True
            big.buckets[f"bucket-{i:04d}"].actions["Read"] = i + 1
        blob = big.SerializeToString()
        assert len(blob) > 2048
        from seaweedfs_tpu_torch.utils.httpd import http_call
        status, _, _ = http_call(
            "POST", f"http://{fs.url}/etc/s3/circuit_breaker", body=blob)
        assert status < 300
        s3._cb_state = (0.0, -1.0)
        s3._refresh_breaker()
        assert s3.breaker.bucket_limits["bucket-0199"] == {"Read": 200}
    finally:
        s3.stop()
