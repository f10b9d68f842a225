"""The port's VolumeServer (server/volume_server.py) under the JAX
package's master and shell, against the JAX package's VolumeServer.

Every test starts the JAX MasterServer. The comparison test runs the same
script twice, once with a JAX VolumeServer and once with the port's
VolumeServer(device="cpu"), driven the way the shell and a client drive a
server: raw POST uploads, ShellContext.ec_encode, GETs (whole and Range,
healthy and with 4 shards lost), /admin/ec/rebuild and /admin/scrub. The
two runs must give sha256-equal shards, equal bodies and equal scrub
reports. The other tests are the JAX package's own server tests with the
port's servers in them: the scrub auto-repair drill
(tests/test_scrub.py:368), partial-parallel repair across three servers
(tests/test_partial_repair.py:132-245), the -ecBatcher seam
(tests/test_mesh_batcher.py:444) and the needle cache's vacuum
invalidation (tests/test_needle_cache.py:290).

The packages talk only over sockets: each has its own context variables,
tracer and sampler.
"""

import hashlib
import os
import time

import numpy as np
import pytest

from seaweedfs_tpu.client import operation
from seaweedfs_tpu.client.wdclient import MasterClient
from seaweedfs_tpu.server.master import MasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.shell.commands import ShellContext
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.ops.rs_torch import TorchCoder
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.storage.erasure_coding import partial as ecpart
from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
from seaweedfs_tpu_torch.utils.httpd import Response, http_call, http_json
from tools import corrupt

MB = 1024 * 1024
LOSS = (0, 5, 11, 13)
TOTAL = layout.TOTAL_SHARDS_COUNT
FIXED_NS = 1_700_000_000_123_456_789


def _port(dirs, master_url, **kw):
    return VolumeServer(dirs, master_url, device="cpu", **kw)


def _await_nodes(master_url, n, timeout=10.0):
    sh = ShellContext(master_url)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        topo = sh.topology()
        if sum(len(r["nodes"]) for dc in topo["data_centers"]
               for r in dc["racks"]) == n:
            return
        time.sleep(0.05)
    raise AssertionError(f"{n} volume servers never registered")


def _needles(seed=5, n=24):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        size = int(rng.integers(100, 300_000))
        out[i + 1] = (int(rng.integers(0, 1 << 32)),
                      rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    return out


def _fid(vid, nid, cookie):
    return f"{vid},{format_needle_id_cookie(nid, cookie)}"


def _get(url, fid, **kw):
    status, body, _ = http_call("GET", f"http://{url}/{fid}", **kw)
    return status, body


def _reads(url, vid, needles, rng):
    """Every needle whole, and three seeded ranges of each."""
    out = []
    for nid, (cookie, data) in sorted(needles.items()):
        fid = _fid(vid, nid, cookie)
        out.append(_get(url, fid))
        for _ in range(3):
            lo = int(rng.integers(0, len(data)))
            hi = int(rng.integers(lo, len(data)))
            out.append(_get(url, fid,
                            headers={"Range": f"bytes={lo}-{hi}"}))
    return out


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _ec_plane(tmp_path, make_vs, name):
    """The script both servers run; returns what a client and the shell
    saw, and the shard files' digests."""
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    # the master records scrub reports but repairs nothing here (the
    # repair drill below runs the queue), so every scrub sees the flips
    reports = []
    master.repair_queue.submit = lambda vid, *a, **kw: reports.append(vid)
    d = tmp_path / name
    vs = make_vs([str(d)], master.url, scrub_interval_s=0,
                 scrub_rate_mbps=0)
    try:
        vs.start()
        _await_nodes(master.url, 1)
        mc = MasterClient(master.url, cache_ttl=0.0)
        vid = int(mc.assign()["fid"].split(",")[0])
        mc.stop()
        needles = _needles()
        for nid, (cookie, data) in needles.items():
            status, _, _ = http_call(
                "POST", f"http://{vs.url}/{_fid(vid, nid, cookie)}",
                body=data)
            assert status == 201
        out = {"healthy": _reads(vs.url, vid, needles,
                                 np.random.default_rng(1))}
        sh = ShellContext(master.url)
        sh.lock()
        assert sh.ec_encode(vid=vid)
        sh.unlock()
        base = str(d / str(vid))
        assert not os.path.exists(base + ".dat")
        out["shards"] = [_sha(base + layout.shard_ext(i))
                         for i in range(TOTAL)]
        out["ec"] = _reads(vs.url, vid, needles, np.random.default_rng(2))
        http_json("POST", f"http://{vs.url}/admin/ec/unmount",
                  {"volume_id": vid, "shard_ids": list(LOSS)})
        http_json("POST", f"http://{vs.url}/admin/ec/delete_shards",
                  {"volume_id": vid, "shard_ids": list(LOSS)})
        out["degraded"] = _reads(vs.url, vid, needles,
                                 np.random.default_rng(3))
        rebuilt = http_json("POST", f"http://{vs.url}/admin/ec/rebuild",
                            {"volume_id": vid})
        out["rebuilt"] = (sorted(rebuilt["rebuilt_shard_ids"]),
                          [_sha(base + layout.shard_ext(i)) for i in LOSS])
        http_json("POST", f"http://{vs.url}/admin/ec/mount",
                  {"volume_id": vid, "shard_ids": list(LOSS)})
        # a data shard, then a parity shard, flipped and undone in turn
        out["scrub"] = []
        for sid in (3, 12):
            corrupt.flip_bits(base + layout.shard_ext(sid), seed=sid)
            scrub = http_json("POST", f"http://{vs.url}/admin/scrub",
                              {"volume_id": vid})
            out["scrub"] += [(c["shard_ids"], c["offset"], c["detail"])
                             for c in scrub["corruptions"]]
            corrupt.flip_bits(base + layout.shard_ext(sid), seed=sid)
        out["clean"] = http_json("POST", f"http://{vs.url}/admin/scrub",
                                 {"volume_id": vid})["corruptions"]
        out["needles"] = needles
        out["vid"] = vid
        out["reports"] = reports
        return out, vs
    finally:
        vs.stop(graceful=False)
        master.stop()


def test_ec_plane_matches_jax(tmp_path, monkeypatch):
    # needle records carry time.time_ns(): pinned, both .dat files and so
    # both shard sets are byte-identical
    monkeypatch.setattr(time, "time_ns", lambda: FIXED_NS)
    calls = []
    real = rs_cuda.gf_apply

    def counted(mat, data, out=None):
        calls.append(tuple(data.shape))
        return real(mat, data, out)

    monkeypatch.setattr(rs_cuda, "gf_apply", counted)
    want, _ = _ec_plane(tmp_path, JVolumeServer, "jax")
    assert calls == []  # the JAX server never reaches the port's kernel
    got, vs = _ec_plane(tmp_path, _port, "port")
    assert isinstance(vs.store.coder, TorchCoder)
    assert vs.store.coder.device.type == "cpu"
    # generate, degraded GETs, rebuild and scrub all went through K1
    assert len(calls) > 4 * 3
    for key in ("shards", "rebuilt", "scrub", "clean", "vid", "reports"):
        assert got[key] == want[key], key
    needles = got["needles"]
    bodies = [data for _, data in (needles[n] for n in sorted(needles))]
    for key in ("healthy", "ec", "degraded"):
        assert got[key] == want[key], key
        whole = [b for s, b in got[key][::4]]
        assert whole == bodies
        assert all(s == 206 for s, _ in
                   [x for i, x in enumerate(got[key]) if i % 4])
    assert got["rebuilt"][0] == list(LOSS)
    assert [s for s, _, _ in got["scrub"]] == [[3], [12]]
    assert got["clean"] == []
    assert got["reports"] == [got["vid"]] * 2  # both reached the master


# ------------------------------------------- inject -> detect -> repair

@pytest.fixture
def scrub_cluster(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _port([str(tmp_path / "v0")], master.url, scrub_interval_s=0.4,
               scrub_rate_mbps=0)
    vs.start()
    _await_nodes(master.url, 1, timeout=5)
    yield master, vs, tmp_path / "v0"
    vs.stop()
    master.stop()


def test_scrub_detects_and_auto_repairs_on_the_port_server(scrub_cluster):
    """After tests/test_scrub.py:368: a bit flipped in a live EC shard of
    the port's server is found by its background scrubber, reported to
    the JAX master, and repaired by the master's queue, bit-identical,
    with no shell step."""
    master, vs, vdir = scrub_cluster
    mc = MasterClient(master.url, cache_ttl=0.0)
    sh = ShellContext(master.url)
    rng = np.random.default_rng(3)
    files = {}
    first = operation.upload_data(mc, b"golden-seed")
    vid = int(first.fid.split(",")[0])
    files[first.fid] = b"golden-seed"
    for _ in range(15):
        data = rng.integers(0, 256, int(rng.integers(500, 8000)),
                            dtype=np.uint8).tobytes()
        a = mc.assign()
        operation.upload_to(a["fid"], a["url"], data)
        files[a["fid"]] = data
    sh.lock()
    assert sh.ec_encode(), "no volumes encoded"
    res = sh.volume_scrub()
    assert len(res) == 1 and "error" not in res[0], res
    shard_path = vdir / f"{vid}{layout.shard_ext(12)}"
    golden = shard_path.read_bytes()
    corrupt.flip_bits(str(shard_path), seed=9)
    assert shard_path.read_bytes() != golden
    deadline = time.monotonic() + 40
    while time.monotonic() < deadline:
        st = sh.ec_repair_status()
        if (st["repaired_total"] >= 1 and not st["queue"]
                and not st["in_flight"] and shard_path.exists()
                and shard_path.read_bytes() == golden):
            break
        time.sleep(0.2)
    st = sh.ec_repair_status()
    assert st["repaired_total"] >= 1, st
    assert shard_path.read_bytes() == golden
    assert st["bytes_moved"] > 0 and st["last_lag_s"] > 0, st
    time.sleep(1.0)  # two more scrub passes: no report/repair loop
    st2 = sh.ec_repair_status()
    assert not st2["queue"] and not st2["in_flight"], st2
    scrub_st = http_json("GET", f"http://{vs.url}/admin/scrub/status")
    assert scrub_st["corruptions_found"] >= 1
    assert scrub_st["passes_completed"] >= 1
    for fid, data in files.items():
        v = int(fid.split(",")[0])
        urls = [loc["url"] for e in mc.lookup_ec_volume(v)
                for loc in e["locations"]]
        status, body = _get(urls[0], fid)
        assert status == 200 and body == data, fid
    sh.unlock()
    mc.stop()


# ------------------------------------- partial repair, three port servers

@pytest.fixture
def cluster(tmp_path):
    """After tests/test_partial_repair.py's fixture: the JAX master and
    three port servers. vs1 uploads and EC-encodes (all 14 shards local),
    then shards 4-6 move to vs2 and 7-9 to vs3."""
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs1 = _port([str(tmp_path / "v0")], master.url)
    vs1.start()
    _await_nodes(master.url, 1)
    rng = np.random.default_rng(17)
    mc = MasterClient(master.url, cache_ttl=0.0)
    files = {}
    first = operation.upload_data(mc, b"seed")
    vid = int(first.fid.split(",")[0])
    files[first.fid] = b"seed"
    for _ in range(6):
        data = rng.integers(0, 256, int(rng.integers(100, 200)) * 1024,
                            dtype=np.uint8).tobytes()
        a = mc.assign()
        operation.upload_to(a["fid"], a["url"], data)
        files[a["fid"]] = data
    sh = ShellContext(master.url, use_grpc=False)
    sh.lock()
    assert sh.ec_encode(vid=vid)
    sh.unlock()
    vs2 = _port([str(tmp_path / "v1")], master.url)
    vs2.start()
    vs3 = _port([str(tmp_path / "v2")], master.url)
    vs3.start()
    servers = [vs1, vs2, vs3]
    moves = {vs2: [4, 5, 6], vs3: [7, 8, 9]}
    for vs, sids in moves.items():
        http_json("POST", f"http://{vs.url}/admin/ec/copy",
                  {"volume_id": vid, "shard_ids": sids,
                   "source_data_node": vs1.url, "copy_ecx_file": True})
        http_json("POST", f"http://{vs.url}/admin/ec/mount",
                  {"volume_id": vid, "shard_ids": sids})
    moved = [s for sids in moves.values() for s in sids]
    http_json("POST", f"http://{vs1.url}/admin/ec/unmount",
              {"volume_id": vid, "shard_ids": moved})
    http_json("POST", f"http://{vs1.url}/admin/ec/delete_shards",
              {"volume_id": vid, "shard_ids": moved})
    time.sleep(0.3)  # let heartbeats register the move
    yield master, servers, vid, files, mc, tmp_path
    mc.stop()
    for vs in servers:
        vs.stop(graceful=False)
    master.stop()


def _kill_shard(tmp_path, vs, idx, vid, sid):
    path = tmp_path / f"v{idx}" / f"{vid}{layout.shard_ext(sid)}"
    golden = path.read_bytes()
    http_json("POST", f"http://{vs.url}/admin/ec/unmount",
              {"volume_id": vid, "shard_ids": [sid]})
    http_json("POST", f"http://{vs.url}/admin/ec/delete_shards",
              {"volume_id": vid, "shard_ids": [sid]})
    assert not path.exists()
    return golden


def test_partial_repair_bit_identical_and_frugal(cluster):
    master, (vs1, vs2, vs3), vid, files, mc, tmp_path = cluster
    golden = _kill_shard(tmp_path, vs2, 1, vid, 4)
    q = master.repair_queue
    assert q.partial_repair
    q.submit(vid, "", reason="test:partial")
    deadline = time.monotonic() + 30
    rebuilt_path = tmp_path / "v0" / f"{vid}{layout.shard_ext(4)}"
    while time.monotonic() < deadline:
        st = q.status()
        if st["repaired_total"] >= 1 and not st["in_flight"]:
            break
        q._dispatch()
        time.sleep(0.05)
    st = q.status()
    assert st["repaired_total"] >= 1, st
    assert st["partial_repairs"] == 1 and st["partial_fallbacks"] == 0, st
    assert rebuilt_path.read_bytes() == golden
    per_mb = st["last_repair_network_bytes_per_mb"]
    assert 0 < per_mb <= 1.5 * MB, per_mb
    for fid, data in files.items():
        status, body = _get(vs1.url, fid)
        assert status == 200 and body == data, fid


def test_partial_repair_falls_back_mid_chain(cluster):
    master, (vs1, vs2, vs3), vid, files, mc, tmp_path = cluster
    golden = _kill_shard(tmp_path, vs2, 1, vid, 4)
    shard_size = len(golden)
    for i, (method, pat, fn) in enumerate(vs2.http.routes):
        if pat.match(ecpart.PARTIAL_READ_PATH):
            vs2.http.routes[i] = (
                method, pat,
                lambda req: Response({"error": "degraded"}, status=500))
    sources = {}
    for e in mc.lookup_ec_volume(vid):
        urls = [loc["url"] for loc in e["locations"]
                if loc["url"] != vs1.url]
        if urls:
            sources[e["shard_id"]] = urls
    resp = http_json("POST", f"http://{vs1.url}/admin/ec/rebuild_partial",
                     {"volume_id": vid, "missing": [4],
                      "sources": sources}, timeout=120)
    assert resp["rebuilt_shard_ids"] == [4], resp
    assert any(vs2.url in f for f in resp["fallbacks"]), resp
    assert resp["network_bytes"] <= 1.5 * shard_size, resp
    rebuilt = tmp_path / "v0" / f"{vid}{layout.shard_ext(4)}"
    assert rebuilt.read_bytes() == golden


def test_shard_stat_and_degraded_range_reads(cluster):
    master, (vs1, vs2, vs3), vid, files, mc, tmp_path = cluster
    st = http_json("GET", f"http://{vs2.url}/admin/ec/shard_stat"
                          f"?volumeId={vid}")
    assert st["shards"] == [4, 5, 6] and st["shard_size"] > 0
    _kill_shard(tmp_path, vs2, 1, vid, 4)
    fid, data = max(files.items(), key=lambda kv: len(kv[1]))
    lo, hi = len(data) // 2, len(data) // 2 + 4095
    status, body, hdrs = http_call("GET", f"http://{vs1.url}/{fid}",
                                   headers={"Range": f"bytes={lo}-{hi}"})
    assert status == 206 and body == data[lo:hi + 1]
    assert hdrs.get("Content-Range") == f"bytes {lo}-{hi}/{len(data)}"
    status, body = _get(vs1.url, fid, headers={"Range": "bytes=-100"})
    assert status == 206 and body == data[-100:]
    status, _, hdrs = http_call("GET", f"http://{vs1.url}/{fid}",
                                headers={"Range": f"bytes={len(data) + 5}-"})
    assert status == 416
    assert hdrs.get("Content-Range") == f"bytes */{len(data)}"


# ------------------------------------------------ -ecBatcher, vacuum

def test_volume_server_ec_batcher_end_to_end(tmp_path):
    """After tests/test_mesh_batcher.py:444, with device="cpu": the EC
    work of ec.encode goes through the server's EcBatchScheduler."""
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _port([str(tmp_path / "v0")], master.url, scrub_interval_s=0,
               ec_batcher=True)
    try:
        vs.start()
        assert vs.ec_batcher is not None
        _await_nodes(master.url, 1, timeout=5)
        mc = MasterClient(master.url, cache_ttl=0.0)
        rng = np.random.default_rng(9)
        payload = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
        up = operation.upload_data(mc, payload)
        sh = ShellContext(master.url)
        sh.lock()
        assert sh.ec_encode(), "no volumes encoded"
        st = http_json("GET", f"http://{vs.url}/admin/ec/batcher")
        assert st["enabled"] and st["jobs_total"] >= 1
        assert st["coder_fallbacks"] == 0 and st["cpu_batches"] == 0
        assert st["mesh_batches"] >= 1
        status, body = _get(vs.url, up.fid)
        assert status == 200 and body == payload
        mc.stop()
    finally:
        vs.stop()
        master.stop()


def test_vacuum_invalidation_via_server(tmp_path):
    """tests/test_needle_cache.py:290 against the port's server."""
    master = MasterServer()
    master.start()
    vs = _port([str(tmp_path / "v")], master.url, qos=False)
    vs.start()
    try:
        _await_nodes(master.url, 1)
        mc = MasterClient(master.url)
        keep = operation.upload_data(mc, b"K" * 4096, name="keep.bin")
        drop = operation.upload_data(mc, b"D" * 4096, name="drop.bin")
        for res in (keep, drop):
            status, _ = _get(res.url, res.fid)
            assert status == 200
        assert vs.store.needle_cache.stats()["items"] >= 2
        status, _, _ = http_call("DELETE", f"http://{drop.url}/{drop.fid}")
        assert status in (200, 202, 204)
        vid = int(drop.fid.split(",")[0])
        http_json("POST", f"http://{vs.url}/admin/vacuum",
                  {"volume_id": vid})
        status, body = _get(keep.url, keep.fid)
        assert status == 200 and body == b"K" * 4096
        status, _ = _get(drop.url, drop.fid)
        assert status == 404
        snap = http_json("GET", f"http://{vs.url}/admin/cache")
        assert snap["enabled"] and "hits" in snap
        out = http_json("POST", f"http://{vs.url}/admin/cache",
                        {"capacity_bytes": 0})
        assert out["bytes"] == 0 and out["items"] == 0
        mc.stop()
    finally:
        vs.stop(graceful=False)
        master.stop()


def test_unported_planes_raise(tmp_path):
    """The gRPC plane is ported: grpc_port=0 serves it beside the HTTP
    plane and advertises its port in the heartbeat. So is the cloud tier,
    which reaches its endpoint now: a demotion to an endpoint where
    nothing listens answers 409 with the connection error, as the JAX
    server does, and leaves the volume local and writable."""
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as tvpb
    from seaweedfs_tpu_torch.server.volume_grpc import GrpcVolumeClient
    master = MasterServer()
    master.start()
    vs = _port([str(tmp_path / "t")], master.url, scrub_interval_s=0,
               grpc_port=0)
    try:
        vs.start()
        assert vs.grpc_port
        node = master.topo.find_node(vs.url)
        assert node is not None and node.grpc_port == vs.grpc_port
        http_json("POST", f"http://{vs.url}/admin/allocate_volume",
                  {"volume_id": 3})
        client = GrpcVolumeClient(f"127.0.0.1:{vs.grpc_port}", tls=None)
        try:
            st = client._unary("VolumeServerStatus",
                               tvpb.VolumeServerStatusRequest(),
                               tvpb.VolumeServerStatusResponse)
        finally:
            client.close()
        assert [v.id for v in st.volumes] == [3]
        status, body, _ = http_call(
            "POST", f"http://{vs.url}/admin/tier/demote",
            json_body={"volume_id": 3, "endpoint": "http://127.0.0.1:1",
                       "bucket": "b"})
        assert status == 409 and b"S3 backend" not in body
        vol = vs.store.find_volume(3)
        assert not vol.is_tiered and not vol.read_only
        assert http_json("GET", f"http://{vs.url}/admin/tier"
                         )["stats"]["failed"] == 1
    finally:
        vs.stop(graceful=False)
        master.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_tcp_data_path_across_packages(tmp_path, client):
    """After tests/test_storage_variants.py:242: the port's raw TCP data
    plane (server/volume_tcp.py, tcp_port >= 0) answers both packages'
    TcpClient; HTTP sees the same store."""
    from seaweedfs_tpu.server.volume_tcp import TcpClient as JTcpClient
    from seaweedfs_tpu_torch.server.volume_tcp import TcpClient
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _port([str(tmp_path / "v0")], master.url, tcp_port=0,
               scrub_interval_s=0)
    try:
        vs.start()
        _await_nodes(master.url, 1)
        assert http_json("GET", f"http://{vs.url}/status")["TcpPort"] == \
            vs.tcp_server.port
        mc = MasterClient(master.url)
        a = mc.assign()
        c = (TcpClient if client == "port" else JTcpClient)(
            "127.0.0.1", vs.tcp_server.port)
        payload = np.random.default_rng(4).bytes(4096)
        c.write(a["fid"], payload)
        assert c.read(a["fid"]) == payload
        status, body = _get(vs.url, a["fid"])
        assert status == 200 and body == payload
        c.delete(a["fid"])
        with pytest.raises(IOError):
            c.read(a["fid"])
        b = mc.assign()  # an error keeps the connection usable
        c.write(b["fid"], b"second life")
        assert c.read(b["fid"]) == b"second life"
        c.close()
        mc.stop()
    finally:
        vs.stop(graceful=False)
        master.stop()
