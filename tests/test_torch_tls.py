"""The port's mutual TLS for the gRPC planes and the HTTP admin listener
(utils/tls.py, reference weed/security/tls.go) held against the JAX
package's: one mTLS round trip on each of the port's planes (master,
volume, filer) with certificates from the port's generator, and across
packages both ways (the JAX clients against the port's servers and the
port's clients against the JAX servers), unauthenticated and foreign-CA
clients refused, security.toml's [grpc] / [grpc.<role>] precedence, and
the read JWT on the port's volume GETs. (ref tests/test_tls.py.)"""

import tempfile

import grpc
import pytest

from seaweedfs_tpu.server import filer_grpc as jfgrpc
from seaweedfs_tpu.server import master_grpc as jmgrpc
from seaweedfs_tpu.server import volume_grpc as jvgrpc
from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu.server.master import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.utils import tls as jtls
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
from seaweedfs_tpu_torch.server import filer_grpc as fgrpc
from seaweedfs_tpu_torch.server import master_grpc as mgrpc
from seaweedfs_tpu_torch.server import volume_grpc as vgrpc
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils import tls as tlsmod
from seaweedfs_tpu_torch.utils.httpd import http_call, http_json

PORT = dict(master=MasterServer, volume=lambda d, m: VolumeServer(
    d, m, device="cpu"), filer=FilerServer, mg=mgrpc, vg=vgrpc, fg=fgrpc)
JAX = dict(master=JMasterServer, volume=JVolumeServer, filer=JFilerServer,
           mg=jmgrpc, vg=jvgrpc, fg=jfgrpc)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return tlsmod.generate_self_signed(
        str(tmp_path_factory.mktemp("certs")))


@pytest.fixture(scope="module")
def jcerts(tmp_path_factory):
    return jtls.generate_self_signed(
        str(tmp_path_factory.mktemp("jcerts")))


def _status(client):
    return client._unary("VolumeServerStatus", vpb.VolumeServerStatusRequest(),
                         vpb.VolumeServerStatusResponse)


def test_mtls_master_rejects_unauthenticated_and_serves_mutual(certs,
                                                               tmp_path):
    master = MasterServer()
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, device="cpu")
    vs.start()
    server, port = mgrpc.start_master_grpc(master, tls=certs["master"])
    addr = f"127.0.0.1:{port}"
    try:
        bad = mgrpc.GrpcMasterClient(addr, tls=None)  # insecure channel
        with pytest.raises(grpc.RpcError) as ei:
            bad.assign(count=1)
        assert ei.value.code() in (grpc.StatusCode.UNAVAILABLE,
                                   grpc.StatusCode.INTERNAL)
        bad.close()

        other = tlsmod.generate_self_signed(tempfile.mkdtemp(),
                                            roles=("client",))
        rogue = mgrpc.GrpcMasterClient(addr, tls=tlsmod.TlsConfig(
            ca_file=certs["client"].ca_file,
            cert_file=other["client"].cert_file,
            key_file=other["client"].key_file))
        with pytest.raises(grpc.RpcError):
            rogue.assign(count=1)
        rogue.close()

        good = mgrpc.GrpcMasterClient(addr, tls=certs["client"])
        res = good.assign(count=1)
        assert res.fid and not res.error and res.location.url == vs.url
        good.close()
    finally:
        server.stop(0)
        vs.stop()
        master.stop()


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_mtls_round_trip_on_each_plane(server_pkg, client_pkg, certs,
                                       jcerts, tmp_path):
    """One mTLS round trip on the master, volume and filer planes: the
    servers of one package hold certificates from that package's
    generator, the clients of the other package a client certificate from
    the same CA."""
    srv, cli = (PORT if server_pkg == "port" else JAX), \
        (PORT if client_pkg == "port" else JAX)
    scerts = certs if server_pkg == "port" else jcerts
    ctls = scerts["client"]
    master = srv["master"]()
    master.start()
    vs = srv["volume"]([str(tmp_path / "v")], master.url)
    vs.start()
    fs = srv["filer"](master.url, store="memory")
    fs.start()
    started = [srv["mg"].start_master_grpc(master, tls=scerts["master"]),
               srv["vg"].start_volume_grpc(vs, tls=scerts["volume"]),
               srv["fg"].start_filer_grpc(fs, tls=scerts["filer"])]
    (_, mport), (_, vport), (_, fport) = started
    try:
        mc = cli["mg"].GrpcMasterClient(f"127.0.0.1:{mport}", tls=ctls)
        res = mc.assign(count=1)
        assert res.fid and res.location.url == vs.url
        vid = res.fid.split(",")[0]
        assert mc.lookup_volume([vid]).volume_id_locations[0] \
            .locations[0].url == vs.url
        mc.close()

        vc = cli["vg"].GrpcVolumeClient(f"127.0.0.1:{vport}", tls=ctls)
        st = _status(vc)
        assert st.version == "seaweedfs-tpu"
        assert [v.id for v in st.volumes] == [int(vid)]
        vc.close()

        fc = cli["fg"].GrpcFilerClient(f"127.0.0.1:{fport}", tls=ctls)
        fc.kv_put(b"tlsk", b"tlsv")
        assert fc.kv_get(b"tlsk") == b"tlsv"
        fc.close()

        # unauthenticated clients bounce off every plane
        for port in (mport, vport, fport):
            ch = grpc.insecure_channel(f"127.0.0.1:{port}")
            with pytest.raises(grpc.FutureTimeoutError):
                grpc.channel_ready_future(ch).result(timeout=1.5)
            ch.close()
    finally:
        for server, _ in started:
            server.stop(0)
        fs.stop()
        vs.stop()
        master.stop()


def test_servers_take_security_toml(certs, tmp_path, monkeypatch):
    """grpc_port servers and clients take mTLS from security.toml
    ([grpc] with a [grpc.<role>] override), as the reference's do."""
    from seaweedfs_tpu_torch.utils import config as cfg
    role = {r: c for r, c in certs.items()}
    (tmp_path / "security.toml").write_text(
        f'[grpc]\nca = "{role["client"].ca_file}"\n'
        f'cert = "{role["client"].cert_file}"\n'
        f'key = "{role["client"].key_file}"\n'
        f'[grpc.volume]\ncert = "{role["volume"].cert_file}"\n'
        f'key = "{role["volume"].key_file}"\n')
    monkeypatch.setattr(cfg, "SEARCH_PATHS", [str(tmp_path)])
    got = tlsmod.load_tls_config("volume")
    assert (got.cert_file, got.ca_file) == (role["volume"].cert_file,
                                            role["client"].ca_file)
    assert tlsmod.load_tls_config("master").cert_file == \
        role["client"].cert_file
    master = MasterServer()
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, device="cpu",
                      grpc_port=0)
    vs.start()
    try:
        vc = vgrpc.GrpcVolumeClient(f"127.0.0.1:{vs.grpc_port}")  # "auto"
        assert _status(vc).version
        vc.close()
        ch = grpc.insecure_channel(f"127.0.0.1:{vs.grpc_port}")
        with pytest.raises(grpc.FutureTimeoutError):
            grpc.channel_ready_future(ch).result(timeout=1.5)
        ch.close()
    finally:
        vs.stop()
        master.stop()


def test_http_admin_mtls(certs):
    """The HTTP admin listener can require client certs too."""
    import ssl
    import urllib.request

    from seaweedfs_tpu_torch.utils.httpd import HttpServer, Response
    srv = HttpServer()
    srv.add("GET", "/ping", lambda req: Response({"pong": True}))
    srv.start()
    try:
        tlsmod.wrap_http_server(srv, certs["master"])
        url = f"https://127.0.0.1:{srv.port}/ping"
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(certs["client"].ca_file)
        ctx.load_cert_chain(certs["client"].cert_file,
                            certs["client"].key_file)
        ctx.check_hostname = False
        with urllib.request.urlopen(url, context=ctx, timeout=5) as r:
            assert b"pong" in r.read()
        noctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        noctx.load_verify_locations(certs["client"].ca_file)
        noctx.check_hostname = False
        with pytest.raises(Exception):
            urllib.request.urlopen(url, context=noctx, timeout=5).read()
    finally:
        srv.stop()


def test_generated_chain_matches_jax_shape(certs, jcerts):
    """The port's generator writes the same files for the same roles as
    the JAX package's, and each package's leaf verifies against its CA
    (the generators' subjects and SANs are equal)."""
    import os

    from cryptography import x509
    assert sorted(certs) == sorted(jcerts)
    for role in certs:
        for attr in ("ca_file", "cert_file", "key_file"):
            assert os.path.basename(getattr(certs[role], attr)) == \
                os.path.basename(getattr(jcerts[role], attr))
        mine, theirs = (x509.load_pem_x509_certificate(
            open(c[role].cert_file, "rb").read()) for c in (certs, jcerts))
        assert mine.subject == theirs.subject
        assert mine.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value == \
            theirs.extensions.get_extension_for_class(
                x509.SubjectAlternativeName).value


def test_read_jwt_guards_volume_gets(tmp_path):
    """With a read key set, the port's volume GETs need a fid-scoped token
    (reference jwt.signing.read)."""
    from seaweedfs_tpu_torch.utils.security import gen_jwt
    master = MasterServer()
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, device="cpu",
                      jwt_read_key="read-secret")
    vs.start()
    try:
        a = http_json("GET", f"http://{master.url}/dir/assign")
        status, _, _ = http_call("POST", f"http://{a['url']}/{a['fid']}",
                                 body=b"guarded")
        assert status < 300
        status, _, _ = http_call("GET", f"http://{a['url']}/{a['fid']}")
        assert status == 401
        wrong = gen_jwt("read-secret", "9,deadbeef")
        status, _, _ = http_call(
            "GET", f"http://{a['url']}/{a['fid']}?jwt={wrong}")
        assert status == 401
        tok = gen_jwt("read-secret", a["fid"])
        status, body, _ = http_call(
            "GET", f"http://{a['url']}/{a['fid']}?jwt={tok}")
        assert status == 200 and body == b"guarded"
    finally:
        vs.stop()
        master.stop()
