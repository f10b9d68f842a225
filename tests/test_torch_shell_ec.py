"""The port's cluster control plane end to end: its MasterServer with the
repair queue, its MasterClient and client.operation, and its ShellContext
driving the EC lifecycle over four of its VolumeServers (device="cpu", the
plain version of K1), side by side with the same lifecycle on an all-JAX
stack (tests/test_shell_ec.py:131).

The two stacks run the same script: upload ~30 seeded needles through
client.operation, ec.encode (14 shards spread over 4 servers on racks r0 /
r1), GET every needle, stop the server holding the most shards and prune it
from the topology, GET every needle (degraded), ec.rebuild, GET again,
ec.decode and read every needle back. Held exactly (bytes and JSON): the
placement by server index, each shard's sha256 by shard id, every GET
body, the rebuild plan, the rebuilt shards and the decoded .dat. K1 is
counted by wrapping rs_cuda.gf_apply; the expected count comes from the
encode batches, the servers' recovered-interval counters and the rebuild
batches.

Also here: the repair queue's partial chain and its copy-and-rebuild
fallback on port servers under the port master (tests/test_partial_repair.py
and the repair half of tests/test_scrub.py), and one interop case in each
direction (the port's shell and client against the JAX master; the JAX
shell against the port master), both over port volume servers.

The packages meet only over sockets and files. Needle records carry
time.time_ns() (pinned) and fid cookies come from the master's random
draws (each master's random modules get the same seeded generator), so
both stacks write byte-identical volumes.
"""

import hashlib
import os
import random
import socket
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.client import operation as joperation
from seaweedfs_tpu.client.wdclient import MasterClient as JMasterClient
from seaweedfs_tpu.cluster import topology as jtopology
from seaweedfs_tpu.cluster import volume_growth as jgrowth
from seaweedfs_tpu.server import master as jmaster
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.shell.commands import ShellContext as JShellContext
from seaweedfs_tpu_torch.client import operation
from seaweedfs_tpu_torch.client.wdclient import MasterClient
from seaweedfs_tpu_torch.cluster import topology
from seaweedfs_tpu_torch.cluster import volume_growth
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.server import master
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import ShellContext
from seaweedfs_tpu_torch.storage.erasure_coding import encoder, layout
from seaweedfs_tpu_torch.utils.httpd import Response, http_call, http_json
from tools import corrupt

TOTAL = layout.TOTAL_SHARDS_COUNT
FIXED_NS = 1_700_000_000_123_456_789
PRUNE_AFTER_S = 4.0  # two volume-server pulses (2 s) without a heartbeat


def _port_vs(dirs, master_url, **kw):
    return VolumeServer(dirs, master_url, device="cpu", **kw)


PORT = types.SimpleNamespace(
    Master=master.MasterServer, VS=_port_vs,
    Shell=ShellContext, Client=MasterClient, op=operation,
    random_mods=(master, topology, volume_growth))
JAX = types.SimpleNamespace(
    Master=jmaster.MasterServer, VS=JVolumeServer,
    Shell=JShellContext, Client=JMasterClient, op=joperation,
    random_mods=(jmaster, jtopology, jgrowth))


def _free_ports(n):
    """n free loopback ports in ascending order, so that the servers'
    urls sort in the order they start in both stacks."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return sorted(s.getsockname()[1] for s in socks)
    finally:
        for s in socks:
            s.close()


def _seed_random(monkeypatch, mods, seed=7):
    """Give each module that draws from `random` its own seeded generator
    (growth's node pick, pick_for_write, the fid cookie)."""
    for i, mod in enumerate(mods):
        monkeypatch.setattr(mod, "random", random.Random(seed + i))


def _wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _node_count(shell):
    topo = shell.topology()
    return sum(len(r["nodes"]) for dc in topo["data_centers"]
               for r in dc["racks"])


def _start_cluster(stack, tmp_path, n=4, master_obj=None, vs_factory=None,
                   **vs_kw):
    """A master (unless given) and n volume servers on racks r0 / r1 of
    dc1, each started once the one before it has registered."""
    m = master_obj or stack.Master(volume_size_limit_mb=64)
    if master_obj is None:
        m.start()
    make_vs = vs_factory or stack.VS
    servers = []
    for i, port in enumerate(_free_ports(n)):
        vs = make_vs([str(tmp_path / f"v{i}")], m.url, port=port,
                     rack=f"r{i % 2}", data_center="dc1", **vs_kw)
        vs.start()
        servers.append(vs)
        _wait(lambda: _node_count(JShellContext(m.url)) == i + 1,
              f"volume server {i} to register")
    return m, servers


def _stop(m, servers):
    for vs in servers:
        vs.stop()
    m.stop()


def _payloads(seed=42, n=30, hi=300_000):
    """n seeded payloads; at the default sizes the volume's data spans
    the first few 1 MiB blocks, i.e. data shards 0-4."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(500, hi)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _shards(tmp_path, vid, n):
    """{shard id: [(server index, sha256)]} over every server dir."""
    out = {}
    for i in range(n):
        for sid in range(TOTAL):
            p = tmp_path / f"v{i}" / f"{vid}{layout.shard_ext(sid)}"
            if p.exists():
                out.setdefault(sid, []).append((i, _sha(p)))
    return out


def _get_all(mc, files, vid, skip=()):
    """GET every needle from the first live holder of the EC volume."""
    mc.invalidate(vid)
    urls = [loc["url"] for e in mc.lookup_ec_volume(vid)
            for loc in e["locations"] if loc["url"] not in skip]
    out = []
    for fid, _ in files:
        status, body, _ = http_call("GET", f"http://{urls[0]}/{fid}")
        out.append((status, body))
    return out


def _recovered(servers, vid):
    """Intervals reconstructed so far, summed over the servers."""
    total = 0
    for vs in servers:
        st = http_json("GET", f"http://{vs.url}/admin/ec/shard_stat"
                              f"?volumeId={vid}")
        total += sum(st.get("recover_stats", {}).values())
    return total


def _lifecycle(stack, tmp_path, monkeypatch):
    """encode -> spread -> GETs -> lose a server -> degraded GETs ->
    ec.rebuild -> GETs -> ec.decode -> read back; returns what a client
    and the shell saw, by server index."""
    _seed_random(monkeypatch, stack.random_mods)
    m, servers = _start_cluster(stack, tmp_path, assign_leases=False)
    idx = {vs.url: i for i, vs in enumerate(servers)}
    live = list(servers)
    out = {}
    try:
        mc = stack.Client(m.url, cache_ttl=0.0, assign_leases=False)
        sh = stack.Shell(m.url)
        files = []
        for data in _payloads():
            res = stack.op.upload_data(mc, data)
            files.append((res.fid, data))
        vids = {int(fid.split(",")[0]) for fid, _ in files}
        assert len(vids) == 1, vids  # the master grew one volume
        vid = vids.pop()
        out["fids"] = [fid for fid, _ in files]
        sh.lock()
        enc = sh.ec_encode()
        assert [r["vid"] for r in enc] == [vid]
        out["source"] = idx[enc[0]["source"]]
        out["placement"] = {idx[t]: s
                            for t, s in enc[0]["placement"].items()}
        shards = _shards(tmp_path, vid, len(servers))
        assert sorted(shards) == list(range(TOTAL))
        assert all(len(v) == 1 for v in shards.values())  # spread, once
        out["shards"] = shards
        original = {sid: v[0][1] for sid, v in shards.items()}
        out["get_ec"] = _get_all(mc, files, vid)
        # lose the server holding the most shards (of those, the one
        # holding shard 0, which every needle's data starts in), prune it
        held = {i: (len(s), 0 in s) for i, s in out["placement"].items()}
        victim = servers[max(held, key=held.get)]
        out["victim"] = idx[victim.url]
        victim.stop()
        live.remove(victim)

        def pruned():
            m.topo.prune_dead_nodes(timeout=PRUNE_AFTER_S)
            return _node_count(sh) == len(live)

        _wait(pruned, "the stopped server to be pruned",
              timeout=PRUNE_AFTER_S + 6)
        out["degraded_recovered_before"] = _recovered(live, vid)
        out["get_degraded"] = _get_all(mc, files, vid, skip={victim.url})
        out["recovered"] = _recovered(live, vid) - \
            out["degraded_recovered_before"]
        assert not sh.ec_repair_status()["in_flight"]
        plans = sh.ec_rebuild()
        assert len(plans) == 1 and "rebuilt" in plans[0], plans
        out["rebuild"] = {"rebuilder": idx[plans[0]["rebuilder"]],
                          "missing": plans[0]["missing"],
                          "rebuilt": sorted(plans[0]["rebuilt"]),
                          "copies": sorted((c.shard_id, idx[c.source])
                                           for c in plans[0]["copies"])}
        assert out["rebuild"]["rebuilt"] == \
            sorted(out["placement"][out["victim"]])
        mc.invalidate(vid)
        present = {e["shard_id"] for e in mc.lookup_ec_volume(vid)
                   if e["locations"]}
        assert present == set(range(TOTAL))
        rb = out["rebuild"]["rebuilder"]
        for sid in out["rebuild"]["rebuilt"]:
            path = tmp_path / f"v{rb}" / f"{vid}{layout.shard_ext(sid)}"
            assert _sha(path) == original[sid], sid
        out["shard_size"] = os.path.getsize(
            tmp_path / f"v{rb}" / f"{vid}{layout.shard_ext(0)}")
        out["get_rebuilt"] = _get_all(mc, files, vid, skip={victim.url})
        dec = sh.ec_decode(vid)
        out["decode"] = {"collector": idx[dec["collector"]],
                         "dat_size": dec["dat_size"]}
        out["dat_sha"] = _sha(tmp_path / f"v{idx[dec['collector']]}"
                              / f"{vid}.dat")
        mc.invalidate(vid)
        out["read_back"] = [stack.op.read_data(mc, fid) for fid, _ in files]
        sh.unlock()
        mc.stop()
        out["bodies"] = [data for _, data in files]
        out["vid"] = vid
        return out
    finally:
        _stop(m, live)


def test_lifecycle_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: FIXED_NS)
    calls = []
    real = rs_cuda.gf_apply

    def counted(mat, data, out=None):
        calls.append(tuple(data.shape))
        return real(mat, data, out)

    monkeypatch.setattr(rs_cuda, "gf_apply", counted)
    want = _lifecycle(JAX, tmp_path / "jax", monkeypatch)
    assert calls == []  # the JAX stack never reaches the port's kernel
    got = _lifecycle(PORT, tmp_path / "port", monkeypatch)
    for key in ("fids", "source", "placement", "shards", "victim",
                "rebuild", "decode", "dat_sha", "get_ec", "get_degraded",
                "get_rebuilt", "read_back", "shard_size", "recovered"):
        assert got[key] == want[key], key
    bodies = got["bodies"]
    for key in ("get_ec", "get_degraded", "get_rebuilt"):
        assert got[key] == [(200, b) for b in bodies], key
    assert got["read_back"] == bodies
    assert len(got["placement"]) == 4  # spread over every server
    assert len(got["placement"][got["victim"]]) == 4
    # K1: the source's encode batches, one call per interval recovered
    # on a live server, the rebuilder's batches
    dat_size = got["decode"]["dat_size"]
    encode = sum(1 for _ in layout.iter_encode_batches(
        dat_size, layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE,
        encoder.DEFAULT_BATCH_SIZE, layout.DATA_SHARDS_COUNT))
    rebuild = -(-got["shard_size"] // encoder.DEFAULT_BATCH_SIZE)
    assert got["recovered"] > 0
    assert len(calls) == encode + got["recovered"] + rebuild


# ---------------- the repair queue on port servers ----------------


def _degrade_route(vs, path):
    """Make one node answer `path` with HTTP 500."""
    for i, (method, pat, fn) in enumerate(vs.http.routes):
        if pat.match(path):
            vs.http.routes[i] = (
                method, pat,
                lambda req: Response({"error": "degraded"}, status=500))


@pytest.fixture
def spread(tmp_path):
    """The port master and three port servers: vs0 takes the uploads and
    encodes while it is alone, then shards 4-6 move to vs1 and 7-9 to
    vs2 (tests/test_partial_repair.py's cluster)."""
    m = master.MasterServer(volume_size_limit_mb=64)
    m.start()
    servers = []
    vs0 = _port_vs([str(tmp_path / "v0")], m.url)
    vs0.start()
    servers.append(vs0)
    try:
        _wait(lambda: _node_count(ShellContext(m.url)) == 1,
              "vs0 to register")
        mc = MasterClient(m.url, cache_ttl=0.0)
        rng = np.random.default_rng(17)
        files = []
        for _ in range(7):
            data = rng.integers(0, 256, int(rng.integers(100, 200)) * 1024,
                                dtype=np.uint8).tobytes()
            files.append((operation.upload_data(mc, data).fid, data))
        vid = int(files[0][0].split(",")[0])
        sh = ShellContext(m.url)
        sh.lock()
        assert sh.ec_encode(vid=vid)
        sh.unlock()
        for i in (1, 2):
            vs = _port_vs([str(tmp_path / f"v{i}")], m.url)
            vs.start()
            servers.append(vs)
        moves = {servers[1]: [4, 5, 6], servers[2]: [7, 8, 9]}
        for vs, sids in moves.items():
            http_json("POST", f"http://{vs.url}/admin/ec/copy",
                      {"volume_id": vid, "shard_ids": sids,
                       "source_data_node": vs0.url, "copy_ecx_file": True})
            http_json("POST", f"http://{vs.url}/admin/ec/mount",
                      {"volume_id": vid, "shard_ids": sids})
        moved = [s for sids in moves.values() for s in sids]
        http_json("POST", f"http://{vs0.url}/admin/ec/unmount",
                  {"volume_id": vid, "shard_ids": moved})
        http_json("POST", f"http://{vs0.url}/admin/ec/delete_shards",
                  {"volume_id": vid, "shard_ids": moved})

        def registered():
            shards = {e["shard_id"]: {loc["url"] for loc in e["locations"]}
                      for e in mc.lookup_ec_volume(vid)}
            return all(shards[s] == {vs.url} for vs, sids in moves.items()
                       for s in sids)

        _wait(registered, "the moved shards to register")
        yield m, servers, vid, files, mc, tmp_path
        mc.stop()
    finally:
        _stop(m, servers)


def _kill_shard(tmp_path, vs, idx, vid, sid):
    path = tmp_path / f"v{idx}" / f"{vid}{layout.shard_ext(sid)}"
    golden = path.read_bytes()
    http_json("POST", f"http://{vs.url}/admin/ec/unmount",
              {"volume_id": vid, "shard_ids": [sid]})
    http_json("POST", f"http://{vs.url}/admin/ec/delete_shards",
              {"volume_id": vid, "shard_ids": [sid]})
    assert not path.exists()
    return golden


def _await_repair(q):
    def done():
        st = q.status()
        if st["repaired_total"] >= 1 and not st["in_flight"]:
            return st
        q._dispatch()  # stand in for the master's 5 s tick
        return None
    return _wait(done, "the repair")


@pytest.mark.parametrize("fallback", [False, True],
                         ids=["partial_chain", "copy_and_rebuild"])
def test_repair_queue_restores_a_lost_shard(spread, monkeypatch, fallback):
    """The master's queue repairs shard 4 (lost on vs1) on vs0, the
    server holding the most shards: by default through the partial chain
    (/admin/ec/rebuild_partial, host GF work, no K1 call), and, when the
    rebuilder refuses that route, through copy-and-rebuild (survivors
    staged, one K1 call per rebuild batch). Either way the shard comes
    back byte for byte and every needle reads."""
    m, (vs0, vs1, vs2), vid, files, mc, tmp_path = spread
    calls = []
    real = rs_cuda.gf_apply
    monkeypatch.setattr(rs_cuda, "gf_apply", lambda mat, data, out=None: (
        calls.append(tuple(data.shape)), real(mat, data, out))[1])
    golden = _kill_shard(tmp_path, vs1, 1, vid, 4)
    if fallback:
        _degrade_route(vs0, "/admin/ec/rebuild_partial")
    q = m.repair_queue
    assert q.partial_repair
    q.submit(vid, "", reason="test")
    st = _await_repair(q)
    rebuilt = tmp_path / "v0" / f"{vid}{layout.shard_ext(4)}"
    assert rebuilt.read_bytes() == golden
    assert st["bytes_moved"] > 0
    if fallback:
        assert (st["partial_repairs"], st["partial_fallbacks"]) == (0, 1)
        # 6 survivors staged from vs1 / vs2, then the rebuild on K1
        assert len(calls) == -(-len(golden) // encoder.DEFAULT_BATCH_SIZE)
        assert st["last_repair_network_bytes_per_mb"] > 1.5 * (1 << 20)
    else:
        assert (st["partial_repairs"], st["partial_fallbacks"]) == (1, 0)
        assert calls == []
        assert 0 < st["last_repair_network_bytes_per_mb"] <= 1.5 * (1 << 20)
    for fid, data in files:
        status, body, _ = http_call("GET", f"http://{vs0.url}/{fid}")
        assert status == 200 and body == data, fid


def test_scrub_report_auto_repairs_flipped_shard(tmp_path):
    """tests/test_scrub.py:368 on the port: a flipped parity shard is
    found by the port server's background scrubber, reported to the port
    master, and its repair queue restores it with no shell step."""
    m = master.MasterServer(volume_size_limit_mb=64)
    m.start()
    vs = _port_vs([str(tmp_path / "v0")], m.url, scrub_interval_s=0.4,
                  scrub_rate_mbps=0)
    vs.start()
    try:
        sh = ShellContext(m.url)
        _wait(lambda: _node_count(sh) == 1, "the server to register")
        mc = MasterClient(m.url, cache_ttl=0.0)
        rng = np.random.default_rng(3)
        files = []
        for _ in range(16):
            data = rng.integers(0, 256, int(rng.integers(500, 8000)),
                                dtype=np.uint8).tobytes()
            files.append((operation.upload_data(mc, data).fid, data))
        vid = int(files[0][0].split(",")[0])
        sh.lock()
        assert sh.ec_encode()
        shard = tmp_path / "v0" / f"{vid}{layout.shard_ext(12)}"
        golden = shard.read_bytes()
        corrupt.flip_bits(str(shard), seed=9)
        assert shard.read_bytes() != golden

        def repaired():
            st = sh.ec_repair_status()
            return (st["repaired_total"] >= 1 and not st["queue"]
                    and not st["in_flight"] and shard.exists()
                    and shard.read_bytes() == golden) and st

        st = _wait(repaired, "the auto-repair", timeout=30)
        assert st["bytes_moved"] > 0 and st["scrub_reports"] >= 1
        for fid, data in files:
            status, body, _ = http_call("GET", f"http://{vs.url}/{fid}")
            assert status == 200 and body == data, fid
        sh.unlock()
        mc.stop()
    finally:
        _stop(m, [vs])


# ---------------- interop: one side port, the other JAX ----------------


@pytest.mark.parametrize("side", ["port_shell_jax_master",
                                  "jax_shell_port_master"])
def test_interop_lifecycle(tmp_path, side):
    """Over port volume servers: the port's shell and client drive a JAX
    master, or the JAX shell and client drive the port master, through
    upload, ec.encode, GETs from the spread volume, ec.decode and
    read-back."""
    if side == "port_shell_jax_master":
        m = jmaster.MasterServer(volume_size_limit_mb=64)
        shell, client, op = ShellContext, MasterClient, operation
    else:
        m = master.MasterServer(volume_size_limit_mb=64)
        shell, client, op = JShellContext, JMasterClient, joperation
    m.start()
    _, servers = _start_cluster(PORT, tmp_path, n=3, master_obj=m)
    try:
        mc = client(m.url, cache_ttl=0.0)
        sh = shell(m.url)
        files = [(op.upload_data(mc, d).fid, d)
                 for d in _payloads(n=12, hi=8000)]
        vid = int(files[0][0].split(",")[0])
        sh.lock()
        enc = sh.ec_encode(vid=vid)
        assert len(enc[0]["placement"]) == 3
        assert _get_all(mc, files, vid) == [(200, d) for _, d in files]
        assert sh.ec_decode(vid)["dat_size"] > 0
        mc.invalidate(vid)
        assert [op.read_data(mc, fid) for fid, _ in files] == \
            [d for _, d in files]
        sh.unlock()
        mc.stop()
    finally:
        _stop(m, servers)
