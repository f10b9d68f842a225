"""The port's volume and filer gRPC planes (server/volume_grpc.py,
server/filer_grpc.py) and the routes built on them, held against the JAX
package's:

- the ref's unary suite, CopyFile and VolumeEcShardRead streams,
  BatchDelete, the EC lifecycle, the shell's gRPC-first applier (no HTTP
  admin request once a node's plane answers), and the filer's entry
  CRUD, KV and SubscribeMetadata stream, on the port's servers;
- the same volume files (seeded needles, a .dat no multiple of the EC
  block) served by a port and a JAX volume server: equal responses to one
  RPC script, and VolumeEcShardsGenerate / VolumeEcShardsRebuild over
  each package's gRPC giving sha256-equal shards, the port's rebuild for
  every loss pattern of up to 4 shards, two generates at once;
- each package's clients against the other package's servers;
- the incremental `weed backup` over VolumeTailSender;
- the filer's S3 Configure service, storing what the JAX package's
  IdentityStore writes.

The volume servers run with device="cpu" (the kernels' plain versions);
each RPC, stream and wait carries its own timeout.
(ref tests/test_grpc_planes.py, tests/test_maintenance.py::
test_backup_volume_incremental.)"""

import concurrent.futures
import hashlib
import itertools
import json
import os
import shutil
import threading
import time

import grpc
import numpy as np
import pytest

from seaweedfs_tpu.server import filer_grpc as jfgrpc
from seaweedfs_tpu.server import volume_grpc as jvgrpc
from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu.server.master import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.storage import maintenance as jmaint
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
from seaweedfs_tpu_torch.server import filer_grpc as fgrpc
from seaweedfs_tpu_torch.server import volume_grpc as vgrpc
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage import maintenance
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils.httpd import http_call, http_json
from torch_ports import free_grpc_ports

TOTAL = layout.TOTAL_SHARDS_COUNT
PKG = {
    "port": dict(master=MasterServer,
                 volume=lambda d, m, **kw: VolumeServer(d, m, device="cpu",
                                                        **kw),
                 filer=FilerServer, vg=vgrpc, fg=fgrpc, maint=maintenance),
    "jax": dict(master=JMasterServer, volume=JVolumeServer,
                filer=JFilerServer, vg=jvgrpc, fg=jfgrpc, maint=jmaint),
}


def _wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _upload(master, data: bytes, collection: str = "") -> str:
    q = f"?collection={collection}" if collection else ""
    a = http_json("GET", f"http://{master.url}/dir/assign{q}")
    status, body, _ = http_call(
        "POST", f"http://{a['url']}/{a['fid']}", body=data)
    assert status < 300, body
    return a["fid"]


@pytest.fixture
def cluster(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, grpc_port=0,
                      device="cpu")
    vs.start()
    vclient = vgrpc.GrpcVolumeClient(f"127.0.0.1:{vs.grpc_port}")
    yield master, vs, vclient
    vclient.close()
    vs.stop()
    master.stop()


def test_volume_grpc_unary_suite(cluster):
    master, vs, client = cluster
    fid = _upload(master, b"grpc-bytes-1")
    vid = int(fid.split(",")[0])
    st = client._unary("VolumeServerStatus", vpb.VolumeServerStatusRequest(),
                       vpb.VolumeServerStatusResponse)
    assert any(v.id == vid for v in st.volumes)
    out = client.call("/admin/vacuum", {"volume_id": vid,
                                        "check_only": True})
    assert out["garbage_ratio"] == 0.0
    d_grpc = client._unary("VolumeDigest",
                           vpb.VolumeDigestRequest(volume_id=vid),
                           vpb.VolumeDigestResponse)
    d_http = http_json(
        "GET", f"http://{vs.url}/admin/volume_digest?volumeId={vid}")
    assert d_grpc.digest == d_http["digest"]
    assert d_grpc.file_count == d_http["file_count"] == 1
    with pytest.raises(grpc.RpcError) as ei:
        client.call("/admin/vacuum", {"volume_id": 424242,
                                      "check_only": True})
    assert ei.value.code() == grpc.StatusCode.NOT_FOUND


def test_volume_grpc_copy_file_stream(cluster):
    master, vs, client = cluster
    fid = _upload(master, b"x" * 5000)
    vid = int(fid.split(",")[0])
    got = client.copy_file(vid, ".dat")
    v = vs.store.find_volume(vid)
    v.sync()
    with open(v.file_name() + ".dat", "rb") as f:
        assert got == f.read()
    assert len(got) > 5000


def test_volume_grpc_batch_delete(cluster):
    master, vs, client = cluster
    fids = [_upload(master, f"bd-{i}".encode()) for i in range(5)]
    resp = client.batch_delete(fids + ["bogus", "7,deadbeef01"])
    by_fid = {r.file_id: r for r in resp.results}
    for fid in fids:
        assert by_fid[fid].status == 202, by_fid[fid]
    assert by_fid["bogus"].status == 400
    assert by_fid["7,deadbeef01"].status == 404
    status, _, _ = http_call("GET", f"http://{vs.url}/{fids[0]}")
    assert status == 404


def test_volume_grpc_ec_lifecycle_and_shard_read(cluster):
    master, vs, client = cluster
    fid = _upload(master, b"E" * 3000)
    vid = int(fid.split(",")[0])
    client.call("/admin/mark_readonly", {"volume_id": vid})
    out = client.call("/admin/ec/generate", {"volume_id": vid})
    assert out["base"]
    client.call("/admin/ec/mount",
                {"volume_id": vid, "shard_ids": list(range(TOTAL))})
    base = vs._ec_base_name(vid)
    with open(base + ".ec00", "rb") as f:
        want = f.read(4096)
    got, deleted = client.ec_shard_read(vid, 0, 0, 4096)
    assert not deleted and got == want
    status, body, _ = http_call("GET", f"http://{vs.url}/{fid}")
    assert status == 200 and body == b"E" * 3000
    client.call("/admin/ec/unmount",
                {"volume_id": vid, "shard_ids": list(range(TOTAL))})
    client.call("/admin/ec/delete_shards",
                {"volume_id": vid, "shard_ids": list(range(TOTAL))})
    assert not any(os.path.exists(base + layout.shard_ext(i))
                   for i in range(TOTAL))


def test_volume_grpc_ec_rebuild_reports_shard_ids(cluster):
    master, vs, client = cluster
    fid = _upload(master, b"R" * 2000)
    vid = int(fid.split(",")[0])
    client.call("/admin/mark_readonly", {"volume_id": vid})
    client.call("/admin/ec/generate", {"volume_id": vid})
    base = vs._ec_base_name(vid)
    os.remove(base + ".ec02")
    os.remove(base + ".ec12")
    out = client.call("/admin/ec/rebuild", {"volume_id": vid})
    assert sorted(out["rebuilt_shard_ids"]) == [2, 12]
    assert os.path.exists(base + ".ec02")


def test_shell_applier_uses_grpc(tmp_path, monkeypatch):
    """ShellContext._vs routes through the node's gRPC plane (port+10000
    here) and sends no admin request over HTTP; an unmapped admin path
    falls back to HTTP; a node without a plane is probed once."""
    from seaweedfs_tpu_torch.shell import commands
    port = free_grpc_ports(1)[0]
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, port=port,
                      grpc_port=port + 10000, device="cpu")
    vs.start()
    sent = []
    real = commands.http_json
    monkeypatch.setattr(commands, "http_json", lambda m, url, *a, **kw: (
        sent.append(url), real(m, url, *a, **kw))[1])
    try:
        fid = _upload(master, b"via-shell")
        vid = int(fid.split(",")[0])
        ctx = commands.ShellContext(master.url)
        out = ctx._vs(vs.url, "/admin/vacuum",
                      {"volume_id": vid, "check_only": True})
        assert out == {"garbage_ratio": 0.0}
        assert ctx._grpc_clients[vs.url] is not None
        assert [u for u in sent if vs.url in u] == []
        out2 = ctx._vs(vs.url, "/admin/sync", {"volume_id": vid})
        assert out2 == {}
        assert ctx._vs(vs.url, "/admin/leave", {}) is not None
        assert [u for u in sent if vs.url in u] == [
            f"http://{vs.url}/admin/leave"]
        http_ctx = commands.ShellContext(master.url, use_grpc=False)
        assert http_ctx._vs(vs.url, "/admin/vacuum", {
            "volume_id": vid, "check_only": True}) == out
        assert http_ctx._grpc_clients == {}
    finally:
        vs.stop()
        master.stop()


@pytest.mark.parametrize("advertised, dialled", [
    ({"grpc_port": 0}, []),
    ({}, ["127.0.0.1:10005"]),
    ({"grpc_port": 23456}, ["127.0.0.1:23456"])])
def test_shell_probe_follows_the_advertised_grpc_port(advertised, dialled,
                                                       monkeypatch):
    """The shell's probe dials the gRPC port a node advertises in the
    master's topology, the reference's port+10000 where it advertises
    none, and nothing where it advertises 0 (a server without a plane):
    each probe is made once, a miss is cached."""
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.utils import tls
    node = "127.0.0.1:5"
    topo = {"data_centers": [{"racks": [{"nodes": [
        {"id": node, **advertised}]}]}]}
    tried = []

    def make_channel(addr):
        tried.append(addr)
        raise ConnectionRefusedError(addr)

    monkeypatch.setattr(tls, "make_channel", make_channel)
    sh = commands.ShellContext("127.0.0.1:1")
    monkeypatch.setattr(sh, "topology", lambda: topo)
    assert sh._grpc_client(node) is None
    assert sh._grpc_client(node) is None
    assert tried == dialled
    assert sh._grpc_clients == {node: None}


def test_shell_ec_lifecycle_over_grpc(tmp_path, monkeypatch):
    """ec.encode → lose a server → ec.rebuild through the port's shell
    against four port volume servers on -grpc: every volume-server call
    goes over gRPC, the rebuilt shards equal the lost ones."""
    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    from seaweedfs_tpu_torch.shell import commands
    master = MasterServer(volume_size_limit_mb=1)
    master.start()
    servers = []
    for i in range(4):
        vs = VolumeServer([str(tmp_path / f"v{i}")], master.url,
                          grpc_port=0, device="cpu", rack=f"r{i % 2}")
        vs.start()
        servers.append(vs)
    sent = []
    real = commands.http_json
    monkeypatch.setattr(commands, "http_json", lambda m, url, *a, **kw: (
        sent.append((m, url)), real(m, url, *a, **kw))[1])
    mc = MasterClient(master.url)
    try:
        rng = np.random.default_rng(7)
        fids = [operation.upload_data(mc, rng.bytes(int(n))).fid
                for n in rng.integers(100, 20000, 40)]
        vid = int(fids[0].split(",")[0])
        for vs in servers:
            vs.heartbeat_once()
        sh = commands.ShellContext(master.url)
        sh.lock()
        enc = sh.ec_encode(vid=vid)[0]
        assert set(enc["placement"]) == {vs.url for vs in servers}
        victim = next(vs for vs in servers if vs.url != enc["source"])
        lost = enc["placement"][victim.url]
        shas = {sid: hashlib.sha256(open(
            victim._ec_base_name(vid) + layout.shard_ext(sid),
            "rb").read()).hexdigest() for sid in lost}
        victim.stop()
        servers.remove(victim)
        def pruned():
            master.topo.prune_dead_nodes(timeout=4.0)
            return master.topo.find_node(victim.url) is None
        _wait(pruned, "the master to drop the stopped server", timeout=12)
        plans = sh.ec_rebuild()
        sh.unlock()
        assert sorted(plans[0]["rebuilt"]) == sorted(lost)
        rebuilder = next(vs for vs in servers
                         if vs.url == plans[0]["rebuilder"])
        for sid in lost:
            assert hashlib.sha256(open(
                rebuilder._ec_base_name(vid) + layout.shard_ext(sid),
                "rb").read()).hexdigest() == shas[sid]
        admin = [(m, u) for m, u in sent if "/admin/" in u
                 and master.url not in u]
        assert admin == []
        assert all(c is not None for c in sh._grpc_clients.values())
    finally:
        mc.stop()
        for vs in servers:
            vs.stop()
        master.stop()


@pytest.fixture
def filer_cluster(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, device="cpu")
    vs.start()
    fs = FilerServer(master.url, store="memory", grpc_port=0)
    fs.start()
    fclient = fgrpc.GrpcFilerClient(f"127.0.0.1:{fs.grpc_port}")
    yield master, vs, fs, fclient
    fclient.close()
    fs.stop()
    vs.stop()
    master.stop()


def test_filer_grpc_entry_crud_and_rename(filer_cluster):
    master, vs, fs, client = filer_cluster
    http_call("POST", f"http://{fs.url}/docs/a.txt", body=b"hello filer")
    e = client.lookup("/docs", "a.txt")
    assert e.name == "a.txt" and e.attributes.file_size == 11
    entry = fpb.Entry(name="b.txt", content=b"inline-bytes")
    entry.attributes.file_size = 12
    client.create_entry("/docs", entry)
    status, body, _ = http_call("GET", f"http://{fs.url}/docs/b.txt")
    assert status == 200 and body == b"inline-bytes"
    assert {e.name for e in client.list_entries("/docs")} == \
        {"a.txt", "b.txt"}
    client.rename("/docs", "b.txt", "/docs", "c.txt")
    assert {e.name for e in client.list_entries("/docs")} == \
        {"a.txt", "c.txt"}
    client.delete_entry("/docs", "c.txt")
    status, _, _ = http_call("GET", f"http://{fs.url}/docs/c.txt")
    assert status == 404
    client.kv_put(b"k1", b"v1")
    assert client.kv_get(b"k1") == b"v1"
    assert client.kv_get(b"absent") is None


def test_filer_grpc_subscribe_metadata_stream(filer_cluster):
    master, vs, fs, client = filer_cluster
    got: list = []
    call = client.subscribe_metadata(since_ns=0, path_prefix="/sub")

    def consume():
        try:
            for resp in call:
                got.append(resp)
                if len(got) >= 2:
                    call.cancel()
                    return
        except grpc.RpcError:
            pass

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.3)
    http_call("POST", f"http://{fs.url}/sub/one.txt", body=b"1")
    http_call("POST", f"http://{fs.url}/sub/two.txt", body=b"22")
    t.join(timeout=10)
    call.cancel()
    assert len(got) >= 2
    names = {r.event_notification.new_entry.name for r in got}
    assert {"one.txt", "two.txt"} <= names
    assert all(r.ts_ns > 0 for r in got)


def test_filer_s3_configure_is_unimplemented(filer_cluster):
    """The filer's S3 Configure service, UNIMPLEMENTED on the port's
    filer until the gateway was ported, is registered beside the filer
    plane on the same gRPC server: it stores the identity file the JAX
    package's IdentityStore writes for the same configuration, and a
    payload that is neither proto nor identity JSON is
    INVALID_ARGUMENT."""
    from seaweedfs_tpu.filer.filer import Filer as JFiler
    from seaweedfs_tpu.filer.filerstore import MemoryStore as JMemoryStore
    from seaweedfs_tpu.gateway.iam_server import IdentityStore as JIds
    from seaweedfs_tpu_torch.gateway.iam_server import IdentityStore
    from seaweedfs_tpu_torch.pb import s3_pb2
    master, vs, fs, client = filer_cluster
    fn = client.channel.unary_unary(
        "/weedtpu_s3_pb.SeaweedTpuS3/Configure",
        request_serializer=lambda b: b, response_deserializer=lambda b: b)
    conf = {"identities": [{"name": "ops", "credentials": [
        {"accessKey": "AKOPS", "secretKey": "sk/ops"}],
        "actions": ["Admin"]}]}
    req = s3_pb2.S3ConfigureRequest(
        s3_configuration_file_content=json.dumps(conf).encode())
    assert fn(req.SerializeToString(), timeout=10) == b""
    ref = JFiler(JMemoryStore())
    JIds(ref).save(conf)
    assert fs.filer.find_entry("/etc/iam/identity.json").content == \
        ref.find_entry("/etc/iam/identity.json").content
    assert IdentityStore(fs.filer).find_by_access_key("AKOPS")["name"] \
        == "ops"
    with pytest.raises(grpc.RpcError) as ei:
        fn(s3_pb2.S3ConfigureRequest(
            s3_configuration_file_content=b"[1]").SerializeToString(),
            timeout=10)
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT


# ---------------- the same volume on both packages ----------------


def _seed_volume(directory: str, seed: int, vids=(1,), n: int = 40) -> dict:
    """Volumes of seeded needles written with the port's Volume (the .dat
    no multiple of the EC block); returns {vid: [(key, cookie, data)]}."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    out = {}
    for vid in vids:
        v = Volume(directory, "", vid)
        needles = []
        for key in range(1, n + 1):
            data = rng.bytes(int(rng.integers(1, 9000)))
            cookie = int(rng.integers(1, 1 << 32))
            v.write_needle(Needle(id=key, cookie=cookie, data=data,
                                  append_at_ns=1_700_000_000_000_000_000
                                  + key))
            needles.append((key, cookie, data))
        v.close()
        out[vid] = needles
    return out


def _dead_master() -> str:
    """A local address nothing listens on: a server's master calls fail
    at once, and no master acts on the volumes (its tiering autopilot
    would encode a read-only volume of old needles on its own)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


class _Pair:
    """A port and a JAX volume server, each with its gRPC plane and no
    live master, over copies of the same volume files."""

    def __init__(self, tmp_path, seed, vids=(1,)):
        src = str(tmp_path / "seed")
        self.needles = _seed_volume(src, seed, vids)
        self.stacks = {}
        for pkg in ("port", "jax"):
            d = str(tmp_path / f"v_{pkg}")
            shutil.copytree(src, d)
            vs = PKG[pkg]["volume"]([d], _dead_master(), grpc_port=0)
            vs.start()
            self.stacks[pkg] = (None, vs)

    def client(self, server_pkg, client_pkg=None):
        vs = self.stacks[server_pkg][1]
        return PKG[client_pkg or server_pkg]["vg"].GrpcVolumeClient(
            f"127.0.0.1:{vs.grpc_port}")

    def stop(self):
        for _, vs in self.stacks.values():
            vs.stop(graceful=False)


@pytest.fixture
def pair(tmp_path):
    made = []

    def make(seed, vids=(1,)):
        made.append(_Pair(tmp_path, seed, vids))
        return made[-1]
    yield make
    for p in made:
        p.stop()


def _shards(vs, vid) -> list[bytes]:
    base = vs._ec_base_name(vid)
    out = []
    for i in range(TOTAL):
        with open(base + layout.shard_ext(i), "rb") as f:
            out.append(f.read())
    return out


def _generate(pkg, p, vid):
    c = p.client(pkg)
    try:
        c.call("/admin/mark_readonly", {"volume_id": vid})
        return c.call("/admin/ec/generate", {"volume_id": vid})
    finally:
        c.close()


LOSSES = {n: list(itertools.combinations(range(TOTAL), n))
          for n in range(1, 5)}


@pytest.mark.parametrize("lost", [1, 2, 3, 4])
def test_ec_shards_over_grpc_match_jax(pair, lost):
    """VolumeEcShardsGenerate over each package's gRPC: equal shards. Then
    VolumeEcShardsRebuild over the port's gRPC for every pattern of
    `lost` shards gives the JAX package's shards back, and the JAX
    stack's own rebuild over its gRPC does for a seeded sample of them.
    The rebuilds run on shards of the same .dat that the JAX package's
    encoder wrote with 4 KiB small blocks (the .dat no multiple of them):
    a rebuild reads what the shard files hold, and 1 MiB shards would
    make 1,470 rebuilds the heaviest CPU work of the test run."""
    from seaweedfs_tpu.models.coder import make_coder as jmake_coder
    from seaweedfs_tpu.storage.erasure_coding import encoder as jencoder
    p = pair(seed=lost)
    assert _generate("port", p, 1) == _generate("jax", p, 1)
    vs_port, vs_jax = p.stacks["port"][1], p.stacks["jax"][1]
    want = _shards(vs_jax, 1)
    assert _shards(vs_port, 1) == want
    assert len(want[0]) % layout.SMALL_BLOCK_SIZE == 0
    assert os.path.getsize(vs_port._ec_base_name(1) + ".dat") % \
        layout.SMALL_BLOCK_SIZE
    small = 4096
    for vs in (vs_port, vs_jax):
        jencoder.write_ec_files(vs._ec_base_name(1), jmake_coder("cpu"),
                                small_block=small)
    want = _shards(vs_jax, 1)
    assert _shards(vs_port, 1) == want and len(want[0]) < (1 << 20)
    assert os.path.getsize(vs_port._ec_base_name(1) + ".dat") % small
    rng = np.random.default_rng(lost)
    sample = {LOSSES[lost][int(i)] for i in rng.choice(
        len(LOSSES[lost]), min(6, len(LOSSES[lost])), replace=False)}
    for pkg, patterns in (("port", LOSSES[lost]), ("jax", sorted(sample))):
        vs = p.stacks[pkg][1]
        base = vs._ec_base_name(1)
        c = p.client(pkg)
        try:
            for pattern in patterns:
                for sid in pattern:
                    os.remove(base + layout.shard_ext(sid))
                out = c.call("/admin/ec/rebuild", {"volume_id": 1},
                             timeout=60)
                assert sorted(out["rebuilt_shard_ids"]) == list(pattern)
                for sid in pattern:
                    with open(base + layout.shard_ext(sid), "rb") as f:
                        assert f.read() == want[sid], (pkg, pattern, sid)
        finally:
            c.close()


def test_concurrent_generates_share_the_coder(pair):
    """Two VolumeEcShardsGenerate calls at once on one port server (the
    gRPC workers share the store's coder; each pipeline has its own
    buffers): each volume's shards equal the JAX server's."""
    p = pair(seed=11, vids=(1, 2))
    vs_port = p.stacks["port"][1]
    coder = vs_port.store.coder
    c = p.client("port")
    try:
        for vid in (1, 2):
            c.call("/admin/mark_readonly", {"volume_id": vid})
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            list(ex.map(lambda vid: c.call("/admin/ec/generate",
                                           {"volume_id": vid}), (1, 2)))
    finally:
        c.close()
    assert vs_port.store.coder is coder
    for vid in (1, 2):
        _generate("jax", p, vid)
        assert _shards(vs_port, vid) == _shards(p.stacks["jax"][1], vid)


def _volume_script(pkg, p) -> list:
    """One RPC script on a server of `pkg` over the seeded volume."""
    c = p.client(pkg)
    needles = p.needles[1]
    out = []
    try:
        st = c._unary("VolumeServerStatus", vpb.VolumeServerStatusRequest(),
                      vpb.VolumeServerStatusResponse)
        out.append(str(st))
        out.append(str(c._unary("VolumeDigest",
                                vpb.VolumeDigestRequest(volume_id=1),
                                vpb.VolumeDigestResponse)))
        fs = c.read_volume_file_status(1)
        out.append((fs.volume_id, fs.collection, fs.file_count,
                    fs.compaction_revision, fs.last_append_at_ns,
                    fs.dat_file_size, fs.idx_file_size))
        key, cookie, data = needles[3]
        ns = c.volume_needle_status(1, key)
        out.append((ns.needle_id, ns.cookie, ns.size, ns.crc, ns.ttl))
        out.append(c.copy_file(1, ".idx") == c.copy_file(1, ".idx"))
        out.append(hashlib.sha256(c.copy_file(1, ".dat")).hexdigest())
        out.append([(n.id, bytes(n.data), n.append_at_ns)
                    for n in c.volume_tail_needles(1, since_ns=0)])
        out.append(hashlib.sha256(
            c.volume_incremental_copy(1, 1_700_000_000_000_000_020))
            .hexdigest())
        fids = [f"1,{k:x}{ck:08x}" for k, ck, _ in needles[:3]]
        r = c.batch_delete(fids + ["bogus", "1,ffff00000001"])
        out.append([(x.file_id, x.status, x.size) for x in r.results])
        out.append(c.call("/admin/vacuum", {"volume_id": 1,
                                            "check_only": True}))
        with pytest.raises(grpc.RpcError) as ei:
            c.call("/admin/vacuum", {"volume_id": 99, "check_only": True})
        out.append(ei.value.code())
        with pytest.raises(grpc.RpcError) as ei:
            c.ec_shard_read(1, 0, 0, 10)
        out.append((ei.value.code(), ei.value.details()))
        with pytest.raises(KeyError):
            c.call("/admin/not_mapped", {})
    finally:
        c.close()
    return out


def test_volume_responses_match_jax(pair):
    p = pair(seed=3)
    got = _volume_script("port", p)
    want = _volume_script("jax", p)
    assert got == want


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"),
                                                   ("port", "jax")])
def test_volume_clients_interoperate(pair, client_pkg, server_pkg):
    """Each package's GrpcVolumeClient against the other's server: the EC
    RPCs, the streams and the tail, with the server's own answers."""
    p = pair(seed=5)
    vs = p.stacks[server_pkg][1]
    c = p.client(server_pkg, client_pkg)
    try:
        c.call("/admin/mark_readonly", {"volume_id": 1})
        assert c.call("/admin/ec/generate", {"volume_id": 1})["base"]
        base = vs._ec_base_name(1)
        os.remove(base + ".ec07")
        assert c.call("/admin/ec/rebuild", {"volume_id": 1}) == {
            "rebuilt_shard_ids": [7]}
        c.call("/admin/ec/mount", {"volume_id": 1,
                                   "shard_ids": list(range(TOTAL))})
        with open(base + ".ec07", "rb") as f:
            want = f.read(5000)
        assert c.ec_shard_read(1, 7, 0, 5000) == (want, False)
        with open(base + ".dat", "rb") as f:
            assert c.copy_file(1, ".dat") == f.read()
        tail = list(c.volume_tail_needles(1, since_ns=0))
        assert [(n.id, bytes(n.data)) for n in tail] == \
            [(k, d) for k, _, d in p.needles[1]]
        assert c.ping().stop_time_ns > 0
    finally:
        c.close()


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_backup_volume_incremental(tmp_path, client_pkg, server_pkg):
    """`weed backup`: a second run catches up over the gRPC tail instead
    of re-copying (the local .dat grows); a source vacuum forces a full
    copy. The port's backup against the port's and the JAX server, and
    the JAX backup against the port's server."""
    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    master = PKG[server_pkg]["master"](volume_size_limit_mb=64)
    master.start()
    vs = PKG[server_pkg]["volume"]([str(tmp_path / "v")], master.url,
                                   grpc_port=0)
    vs.start()
    out = str(tmp_path / "bak")
    mc = MasterClient(master.url)
    tails = []
    maint = PKG[client_pkg]["maint"]
    client_cls = PKG[client_pkg]["vg"].GrpcVolumeClient
    real = client_cls.volume_tail_needles

    def counted(self, *a, **kw):
        tails.append(a)
        return real(self, *a, **kw)
    client_cls.volume_tail_needles = counted
    try:
        fid1 = operation.upload_data(mc, b"first wave " * 50).fid
        vid = int(fid1.split(",")[0])
        vs.heartbeat_once()
        base = maint.backup_volume(master.url, vid, out)
        size_after_full = os.path.getsize(base + ".dat")
        assert tails == []
        fid2 = operation.upload_data(mc, b"second wave " * 80).fid
        for url in mc.lookup_file_id(fid1):
            http_call("DELETE", url)
        assert maint.backup_volume(master.url, vid, out) == base
        assert len(tails) == 1
        assert os.path.getsize(base + ".dat") > size_after_full
        v = Volume(out, "", vid)
        key2 = int(fid2.split(",")[1][:-8], 16)
        key1 = int(fid1.split(",")[1][:-8], 16)
        try:
            assert v.read_needle(key2).data == b"second wave " * 80
            with pytest.raises(Exception):
                v.read_needle(key1)
        finally:
            v.close()
        src_v = vs.store.find_volume(vid)
        src_v.compact()
        assert maint.backup_volume(master.url, vid, out) == base
        assert len(tails) == 1  # the revision changed: a full copy
        v = Volume(out, "", vid)
        try:
            assert v.super_block.compaction_revision == \
                src_v.super_block.compaction_revision
            assert v.read_needle(key2).data == b"second wave " * 80
            with pytest.raises(Exception):
                v.read_needle(key1)
        finally:
            v.close()
    finally:
        client_cls.volume_tail_needles = real
        mc.stop()
        vs.stop()
        master.stop()


# ---------------- the filer plane on both packages ----------------


def _filer_script(pkg, tmp_path) -> list:
    """One script through a filer's gRPC plane (HTTP for the data), the
    entries recorded without times or file ids."""
    master = PKG[pkg]["master"](volume_size_limit_mb=64)
    master.start()
    vs = PKG[pkg]["volume"]([str(tmp_path / f"fv_{pkg}")], master.url)
    vs.start()
    fs = PKG[pkg]["filer"](master.url, store="memory", grpc_port=0)
    fs.start()
    c = PKG[pkg]["fg"].GrpcFilerClient(f"127.0.0.1:{fs.grpc_port}")

    def entry(e):
        return (e.name, e.is_directory, e.attributes.file_size,
                e.attributes.mime, e.attributes.file_mode,
                bytes(e.content), [(ch.offset, ch.size) for ch in e.chunks])
    out = []
    try:
        rng = np.random.default_rng(17)
        for i in range(6):
            body = rng.bytes(int(rng.integers(10, 30000)))
            http_call("POST", f"http://{fs.url}/d/f{i}.bin", body=body)
        out.append([entry(e) for e in c.list_entries("/d")])
        out.append([entry(e) for e in c.list_entries("/d", prefix="f3")])
        out.append([entry(e) for e in c.list_entries("/d", limit=2)])
        out.append(entry(c.lookup("/d", "f1.bin")))
        e = fpb.Entry(name="inline.txt", content=b"inline")
        e.attributes.file_size = 6
        e.attributes.file_mode = 0o644
        c.create_entry("/d/sub", e)
        out.append(http_call("GET", f"http://{fs.url}/d/sub/inline.txt")[:2])
        c.rename("/d/sub", "inline.txt", "/d", "moved.txt")
        out.append(sorted(x.name for x in c.list_entries("/d")))
        c.delete_entry("/d", "f0.bin")
        out.append(http_call("GET", f"http://{fs.url}/d/f0.bin")[0])
        with pytest.raises(grpc.RpcError) as ei:
            c.lookup("/d", "f0.bin")
        out.append(ei.value.code())
        c.kv_put(b"k", b"v")
        out.append((c.kv_get(b"k"), c.kv_get(b"nope")))
        a = c.assign_volume(count=1, path="/d/x")
        out.append((a.count, bool(a.file_id), a.url == vs.url))
        out.append(sorted(c.lookup_volume([a.file_id.split(",")[0]])))
        conf = c.get_configuration()
        out.append((list(conf.masters) == [master.url], conf.version))
        stream = c.subscribe_metadata(since_ns=0, path_prefix="/d")
        timer = threading.Timer(30.0, stream.cancel)  # fail, not hang
        timer.daemon = True
        timer.start()
        events = []
        for resp in stream:
            events.append((resp.directory,
                           resp.event_notification.old_entry.name,
                           resp.event_notification.new_entry.name))
            if len(events) == 9:
                break
        stream.cancel()
        timer.cancel()
        out.append(events)
    finally:
        c.close()
        fs.stop()
        vs.stop()
        master.stop()
    return out


def test_filer_responses_match_jax(tmp_path):
    assert _filer_script("port", tmp_path) == _filer_script("jax", tmp_path)


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"),
                                                   ("port", "jax")])
def test_filer_clients_interoperate(tmp_path, client_pkg, server_pkg):
    master = PKG[server_pkg]["master"](volume_size_limit_mb=64)
    master.start()
    vs = PKG[server_pkg]["volume"]([str(tmp_path / "v")], master.url)
    vs.start()
    fs = PKG[server_pkg]["filer"](master.url, store="memory", grpc_port=0)
    fs.start()
    c = PKG[client_pkg]["fg"].GrpcFilerClient(f"127.0.0.1:{fs.grpc_port}")
    try:
        http_call("POST", f"http://{fs.url}/x/a.txt", body=b"across")
        assert [e.name for e in c.list_entries("/x")] == ["a.txt"]
        assert c.lookup("/x", "a.txt").attributes.file_size == 6
        c.kv_put(b"k", b"v")
        assert c.kv_get(b"k") == b"v"
        assert c.statistics().total_size > 0
    finally:
        c.close()
        fs.stop()
        vs.stop()
        master.stop()
