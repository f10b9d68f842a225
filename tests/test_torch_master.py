"""The port's master (server/master.py) and the host-only modules it is
built from, against the JAX package's.

- The port MasterServer and the JAX MasterServer answer the same request
  script over HTTP with equal JSON, apart from clock fields and each
  master's own url: heartbeats (full, delta, unknown node), assign,
  lookup, lookup_ec, growth, the single-master parts of the assign-lease
  lane (tests/test_assign_lease.py), the admin lock, cluster status,
  health and qos, scrub reports and the repair queue's status, a graceful
  leave, raft status, the filer ring and the tiering and rebalance views.
  The volume servers behind the script are stubs that take
  /admin/allocate_volume; each master's random modules draw from the same
  seeded generator, so both grow the same volumes and mint the same fids.
- stats/slo.py and stats/telemetry.py on tests/test_telemetry.py's units,
  storage/tiering.py's planner on tests/test_tiering.py's, and
  filer/rebalance.py's planner with filer/shard_ring.py on
  tests/test_shard_scaleout.py's: the same feed through both packages
  gives equal outputs.
"""

import random
import time

import pytest

from seaweedfs_tpu.cluster import topology as jtopology
from seaweedfs_tpu.cluster import volume_growth as jgrowth
from seaweedfs_tpu.filer import rebalance as jrebalance
from seaweedfs_tpu.filer import shard_ring as jring
from seaweedfs_tpu.server import master as jmaster
from seaweedfs_tpu.stats import slo as jslo
from seaweedfs_tpu.stats import telemetry as jtelemetry
from seaweedfs_tpu.storage import tiering as jtiering
from seaweedfs_tpu.utils import metrics as jmetrics
from seaweedfs_tpu.stats import hotkeys as jhotkeys
from seaweedfs_tpu.stats import ledger as jledger
from seaweedfs_tpu_torch.cluster import topology
from seaweedfs_tpu_torch.cluster import volume_growth
from seaweedfs_tpu_torch.filer import rebalance
from seaweedfs_tpu_torch.filer import shard_ring
from seaweedfs_tpu_torch.server import master
from seaweedfs_tpu_torch.stats import hotkeys, ledger, slo, telemetry
from seaweedfs_tpu_torch.storage import tiering
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement
from seaweedfs_tpu_torch.utils import metrics
from seaweedfs_tpu_torch.utils.httpd import HttpServer, Response, http_call

# fields that read a clock (or a rate over one), masked before comparing
CLOCK_KEYS = {"expires_at", "remaining_s", "last_seen_s", "enqueued_at",
              "next_attempt", "master_edge", "peers", "last_lag_s"}


def _mask(x, master_url):
    if isinstance(x, dict):
        return {k: ("<clock>" if k in CLOCK_KEYS else _mask(v, master_url))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_mask(v, master_url) for v in x]
    if isinstance(x, str):
        return x.replace(master_url, "<master>")
    return x


def _vol(vid, size=100, collection="", rp="000", read_only=False):
    return {"id": vid, "size": size, "collection": collection,
            "replica_placement": ReplicaPlacement.parse(rp).to_byte(),
            "read_only": read_only, "file_count": 3, "delete_count": 0,
            "deleted_byte_count": 0, "ttl": 0, "version": 3}


@pytest.fixture
def stubs():
    """Three stand-in volume servers: they take allocate_volume and
    answer 404 to anything else."""
    servers = []
    for _ in range(3):
        s = HttpServer("127.0.0.1", 0)
        s.add("POST", "/admin/allocate_volume", lambda req: Response({}))
        s.start()
        servers.append(s)
    yield [f"127.0.0.1:{s.port}" for s in servers]
    for s in servers:
        s.stop()


def _script(m, urls):
    """The request script; returns [(method, path, status, masked json)]."""
    out = []

    def call(method, path, body=None, keys_only=False):
        status, raw, hdrs = http_call(method, f"http://{m.url}{path}",
                                      json_body=body, timeout=10)
        ctype = hdrs.get("Content-Type", "")
        if "json" in ctype:
            import json
            data = json.loads(raw) if raw else None
        else:
            data = raw.decode()
        if keys_only:  # an adaptive view: its numbers follow latencies
            data = sorted(data)
        out.append((method, path, status, _mask(data, m.url)))
        return status, data

    hb = []
    for i, u in enumerate(urls):
        ip, port = u.rsplit(":", 1)
        hb.append({"ip": ip, "port": int(port), "rack": f"r{i % 2}",
                   "data_center": "dc1", "max_volume_count": 6})
    vols = [[_vol(1), _vol(2, read_only=True), _vol(3, rp="001")],
            [_vol(3, rp="001"), _vol(4, collection="photos")],
            [_vol(6, size=10 ** 9)]]
    ec = [[{"id": 5, "ec_index_bits": 0b11111}],
          [{"id": 5, "ec_index_bits": 0b1111100000}],
          [{"id": 5, "ec_index_bits": 0b11110000000000}]]
    for i in range(3):
        call("POST", "/heartbeat",
             {**hb[i], "volumes": vols[i], "ec_shards": ec[i],
              "qos_pressure": 0.25 * i,
              # the lease lane: node 0 speaks leases, the others do not
              **({"lease_req": {"1": {}}} if i == 0 else {})})
    call("GET", "/dir/status")
    for qs in ("", "count=3", "count=16", "replication=001",
               "collection=photos", "collection=fresh", "replication=200"):
        call("GET", f"/dir/assign?{qs}")
    call("POST", "/dir/assign?count=2")
    for vid in ("1", "3", "4", "3,0000012345", "999"):
        call("GET", f"/dir/lookup?volumeId={vid}")
    call("GET", "/dir/lookup?volumeId=4&collection=photos")
    for vid in (5, 7):
        call("GET", f"/dir/lookup_ec?volumeId={vid}")
    call("POST", "/vol/grow?count=2")
    call("POST", "/vol/grow?replication=010")
    call("POST", "/vol/grow?replication=100")
    call("GET", "/cluster/leases")
    # node 0 renews with progress; node 1 a delta; an unknown node
    call("POST", "/heartbeat",
         {**hb[0], "volumes": vols[0], "ec_shards": ec[0],
          "lease_req": {"1": {"next_key": 4000}}})
    call("POST", "/heartbeat",
         {**hb[1], "is_delta": True,
          "deleted_ec_shards": [{"id": 5, "ec_index_bits": 0b100000}],
          "new_volumes": [_vol(8)], "scrubbing": True})
    call("POST", "/heartbeat", {"ip": "10.9.9.9", "port": 1,
                                "is_delta": True})
    call("GET", "/dir/lookup_ec?volumeId=5")
    call("GET", "/cluster/leases")
    call("POST", "/admin/lock", {"client": "a"})
    call("POST", "/admin/lock", {"client": "b"})
    call("POST", "/admin/unlock", {})
    call("POST", "/admin/lock", {"client": "b"})
    for path in ("/cluster/status", "/cluster/health", "/cluster/qos",
                 "/col/list", "/cluster/raft/ps", "/cluster/tiering",
                 "/cluster/rebalance", "/cluster/filers"):
        call("GET", path)
    call("GET", "/admin/qos", keys_only=True)
    call("POST", "/cluster/raft/add", {"peer": "x:1"})
    call("POST", "/raft/vote", {})
    call("POST", "/cluster/register",
         {"type": "filer", "url": "127.0.0.1:18888"})
    call("GET", "/cluster/filers")
    call("GET", "/cluster/nodes?type=filer")
    # scrub reports: an EC volume the topology does not know (the repair
    # fails at once, deterministically) and a needle report
    call("POST", "/scrub/report", {"type": "ec_shard", "volume_id": 99,
                                   "shard_ids": [3], "collection": "",
                                   "detail": "parity mismatch"})
    call("POST", "/scrub/report", {"type": "needle_crc", "volume_id": 1,
                                   "needle_id": 7})
    deadline = time.monotonic() + 10
    while m.repair_queue.failed_total < 1:
        assert time.monotonic() < deadline, "the repair never failed"
        time.sleep(0.02)
    call("GET", "/ec/repair/status")
    call("POST", "/dir/leave", {"url": urls[2]})
    call("POST", "/dir/leave", {"url": "10.9.9.9:1"})
    call("GET", "/dir/status")
    call("GET", "/dir/lookup_ec?volumeId=5")
    call("POST", "/col/delete")
    call("GET", "/ui")
    return out


def test_master_answers_the_script_like_jax(stubs, monkeypatch):
    runs = []
    for mods in ((jmaster, jtopology, jgrowth),
                 (master, topology, volume_growth)):
        for i, mod in enumerate(mods):
            monkeypatch.setattr(mod, "random", random.Random(11 + i))
        m = mods[0].MasterServer(volume_size_limit_mb=64)
        m.start()
        try:
            runs.append(_script(m, stubs))
            names = sorted({ln.split("{")[0].split(" ")[0]
                            for ln in m.metrics.expose_text().splitlines()
                            if ln and not ln.startswith("#")})
            runs[-1].append(("metrics", names))
        finally:
            m.stop()
    want, got = runs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, w[:2]
    statuses = [s for _, _, s, _ in got[:-1]]
    assert 409 in statuses and 404 in statuses and 503 in statuses
    leases = [d for meth, p, s, d in got[:-1] if p == "/cluster/leases"]
    assert leases[-1]["counters"]["grant"] >= 1


# ---------------- stats: SLO and telemetry ----------------


def _slo_run(mod):
    """tests/test_telemetry.py's SLO units, recorded."""
    trans = []
    ev = mod.SloEvaluator(
        objectives={"interactive": {"latency_s": 0.05, "goal": 0.99}},
        fast_window_s=6.0, slow_window_s=15.0,
        on_transition=lambda t, c, o, n, d: trans.append((t, c, o, n, d)))
    rec = []
    total = bad = 0
    t = 0.0
    for step, bad_per in [(10, 0), (6, 30), (20, 0)]:
        for _ in range(step):
            t += 1.0
            total += 100
            bad += bad_per
            ev.feed(t, "interactive", total, bad)
            rec.append((ev.evaluate(t), ev.state("interactive"),
                        ev.firing()))
    rec.append(trans)
    rec.append(ev.timeline())
    ev2 = mod.SloEvaluator(fast_window_s=6.0, slow_window_s=15.0)
    for now, tot, b in ((1.0, 1000, 10), (2.0, 1100, 12), (3.0, 200, 1)):
        ev2.feed(now, "write", tot, b)
    rec.append(ev2.evaluate(3.0))
    ev3 = mod.SloEvaluator(fast_window_s=6.0, slow_window_s=15.0)
    ev3.feed(1.0, "background", 50, 50)
    ev3.feed(10.0, "background", 50, 50)
    rec.append(ev3.evaluate(10.0))
    return rec


def test_slo_matches_jax():
    got, want = _slo_run(slo), _slo_run(jslo)
    assert got == want
    assert got[-4][-1][3] == slo.OK  # the last transition resolves
    assert any(tr[3] == slo.FAST_BURN for tr in got[-4])


def _node_snaps(mets, hot, led, seed):
    """Three nodes' telemetry snapshots built with one package's
    Histogram, HotKeys and ResourceLedger from the same seeded feed."""
    rng = random.Random(seed)
    snaps = []
    for n in range(3):
        red = mets.Histogram(
            "red", "red", label_names=("server", "route_family", "class",
                                       "status_family"),
            buckets=mets.RED_BUCKETS)
        hk = hot.HotKeys(("needle",))
        lg = led.ResourceLedger()
        for _ in range(200):
            cls = rng.choice(["interactive", "write", "background"])
            status = rng.choice(["2xx", "2xx", "2xx", "4xx", "5xx"])
            red.observe(rng.expovariate(50.0), "volume", "read", cls, status,
                        exemplar=f"{rng.getrandbits(64):016x}")
            hk.record("needle", f"1,{rng.randint(1, 40):x}")
            lg.observe_request(cls, f"t{rng.randint(0, 3)}",
                               cpu_s=rng.random() / 100,
                               bytes_in=rng.randint(0, 5000),
                               bytes_out=rng.randint(0, 5000))
            lg.charge_disk(rng.randint(0, 9000), cls=cls)
        snaps.append({"node": f"10.0.0.{n}:8080", "server": "volume",
                      "red": red.snapshot(), "hotkeys": hk.snapshot(),
                      "ledger": lg.snapshot(),
                      "hints": {"pending_rows": 2000 * (n == 2),
                                "oldest_debt_age_s": 0.0}})
    return snaps


def test_cluster_telemetry_matches_jax():
    outs = []
    for tel, mets, hot, led in ((telemetry, metrics, hotkeys, ledger),
                                (jtelemetry, jmetrics, jhotkeys, jledger)):
        ct = tel.ClusterTelemetry(fast_window_s=6.0, slow_window_s=15.0)
        rec = []
        for step in range(4):
            rec.append(ct.rollup(float(step), _node_snaps(mets, hot, led,
                                                          step)))
        rec.append(tel.red_class_rollup(
            _node_snaps(mets, hot, led, 9)[0]["red"],
            {"interactive": 0.05}))
        outs.append(rec)
    assert outs[0] == outs[1]
    assert "hints_stale" in outs[0][0]["alerts_firing"]
    assert outs[0][0]["top_keys"]["needle"]


# ---------------- tiering and rebalance planners ----------------


def _report(reads, rung="hot", read_only=True, shards=False, size=1000):
    return {"volumes": {1: {"reads": reads, "rung": rung,
                            "size": size, "read_only": read_only,
                            "has_ec_shards": shards}}}


def _tiering_run(mod):
    """tests/test_tiering.py's planner units, recorded."""
    def planner(**kw):
        args = dict(window_s=10.0, ewma_alpha=1.0, cool_max=1.0,
                    cold_max=0.1, heat_min=5.0, min_age_s=0.0,
                    cooldown_s=0.0, max_moves_per_plan=8,
                    cloud_enabled=True)
        args.update(kw)
        return mod.TieringPlanner(**args)

    rec = []
    for kw, feed in (
            ({}, [(0, 0, {}), (2, 4, {})]),
            ({}, [(7, 0, {}), (7, 4, {})]),
            ({"cloud_enabled": False}, [(7, 0, {}), (7, 4, {})]),
            ({}, [(0, 0, {}), (10, 4, {})]),
            ({}, [(0, 0, {"read_only": False}), (0, 4, {"read_only": False})]),
            ({}, [(0, 0, {"rung": "cloud"}), (100, 4, {"rung": "cloud"})]),
            ({}, [(0, 0, {"rung": "cloud", "shards": True}),
                  (100, 4, {"rung": "cloud", "shards": True})]),
            ({}, [(0, 0, {"rung": "ec"}), (100, 4, {"rung": "ec"})]),
            ({}, [(5, 0, {"rung": "ec"}), (5, 4, {"rung": "ec"})]),
            ({"min_age_s": 100.0}, [(0, 0, {}), (0, 4, {})]),
            ({}, [(1000, 0, {}), (3, 4, {})]),
            ({"ewma_alpha": 0.5}, [(0, 0, {}), (10, 4, {}), (30, 8, {})])):
        p = planner(**kw)
        for reads, now, rkw in feed:
            p.observe("vs1", _report(reads, **rkw), now=float(now))
        now = float(feed[-1][1])
        rec.append((p.temperature(1, now=now), p.plan(now=now),
                    p.status(now=now)))
    # cooldown, note_committed / note_failed, silence, stale members
    p = planner(cooldown_s=50.0, stale_after_s=50.0)
    p.observe("vs1", _report(0), now=0.0)
    p.observe("vs2", {"volumes": {2: {"reads": 0, "rung": "hot",
                                      "size": 9, "read_only": True}}},
              now=0.0)
    p.observe("vs1", _report(0), now=4.0)
    rec.append(p.plan(now=14.0))
    rec.append(p.paused_on_silence)
    for t in (101.0, 105.0):
        p.observe("vs1", _report(0), now=t)
    plan = p.plan(now=105.0)
    rec.append(plan)
    p.note_committed(1, now=105.0)
    p.observe("vs1", _report(0, rung="ec"), now=108.0)
    rec.append(p.plan(now=108.0))
    p.note_failed(1)
    rec.append(p.status(now=108.0))
    vols = {vid: {"reads": 0, "rung": "hot", "size": 10, "read_only": True}
            for vid in (1, 2, 3, 4, 5)}
    p = planner(max_moves_per_plan=2)
    p.observe("vs1", {"volumes": vols}, now=0.0)
    p.observe("vs1", {"volumes": vols}, now=4.0)
    first = p.plan(now=4.0)
    for mv in first["moves"]:
        p.note_committed(mv["vid"], now=4.0)
    rec += [first, p.plan(now=4.0)]
    mover = mod.TierMover(p, endpoint="", bucket="tier")
    rec.append(mover.status())
    return rec


def test_tiering_planner_matches_jax():
    got, want = _tiering_run(tiering), _tiering_run(jtiering)
    assert got == want
    assert got[0][1]["moves"][0]["to"] == tiering.RUNG_EC


def _rebalance_run(ring_mod, rb_mod):
    """tests/test_shard_scaleout.py's ring and planner units, recorded."""
    rec = []
    members = ["h1:8888", "h2:8888", "h3:8888"]
    a = ring_mod.ShardRing(members)
    dirs = [f"/zipf/b{i:03d}" for i in range(300)]
    rec.append([a.owner(d) for d in dirs])
    rec.append([a.owner_for_path(d + "/k1") for d in dirs[:20]])
    rec.append(a.spread(dirs))
    r1 = ring_mod.ring_if_changed(None, ["a", "b"])
    r2 = ring_mod.ring_if_changed(r1, ["a", "b", "c"])
    rec += [r1.to_dict(), ring_mod.ring_if_changed(r1, ["b", "a"]),
            r2.to_dict()]
    over = r2.with_overrides({"/hot/dir": "c"})
    rec += [over.to_dict(), over.owner("/hot/dir"),
            ring_mod.ring_if_changed(over, ["a", "b"]).to_dict()]
    rec += [ring_mod.parse_shard_header(v) for v in
            ("7:h:88", "junk", "", "-3:h:88",
             ring_mod.format_shard_header(7, "h:88"))]
    rec += [ring_mod.parent_dir(p) for p in ("/a/b/c", "/a", "/")]
    ring = ring_mod.ShardRing(["a", "b"])
    hot_dir = next(f"/load/d{i:02d}" for i in range(64)
                   if ring.owner(f"/load/d{i:02d}") == "a")
    tiny_dir = next(f"/load/t{i:02d}" for i in range(64)
                    if ring.owner(f"/load/t{i:02d}") == "a")
    p = rb_mod.RebalancePlanner(window_s=10.0, threshold=1.5, min_rate=1.0,
                                cooldown_s=100.0, min_share=0.05)
    p.observe("a", {"ops": 0, "dirs": []}, now=0.0)
    rec.append(p.plan(ring, now=0.0))
    for t in (0.0, 5.0, 10.0):
        p.observe("a", {"ops": 100 * t,
                        "dirs": [{"key": hot_dir, "count": 96 * t + 96},
                                 {"key": tiny_dir, "count": 4 * t + 4}]},
                  now=t)
        p.observe("b", {"ops": 1 * t, "dirs": []}, now=t)
    rec.append(p.plan(ring, now=10.0))
    rec.append(p.plan(ring, now=10.0))
    p.note_committed(hot_dir, now=10.0)
    rec += [p.plan(ring, now=11.0), p.status(now=11.0)]
    p.note_failed(hot_dir)
    p.forget("b")
    rec.append(p.status(now=12.0))
    return rec


def test_shard_ring_and_rebalance_planner_match_jax():
    got = _rebalance_run(shard_ring, rebalance)
    want = _rebalance_run(jring, jrebalance)
    assert got == want
    plan = got[-5]
    assert plan is not None and plan["moves"][0]["from"] == "a"


# ---------------- the assign-lease lane on the port's own stack ----------


@pytest.fixture
def duo(tmp_path):
    """The port master and one port volume server (the plain version of
    K1), as tests/test_assign_lease.py's duo."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    m = master.MasterServer(volume_size_limit_mb=64)
    m.start()
    vs = VolumeServer([str(tmp_path / "v")], m.url, device="cpu")
    vs.start()
    deadline = time.monotonic() + 10
    while not m.topo.all_nodes():
        assert time.monotonic() < deadline, "the server never registered"
        time.sleep(0.05)
    yield m, vs
    vs.stop()
    m.stop()


def _wait_lease(vs, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with vs._lease_lock:
            if vs._leases:
                return dict(next(iter(vs._leases.values())))
        time.sleep(0.05)
    raise AssertionError("the holder never received a lease")


def test_lease_lane_on_the_port_stack(duo):
    """The port master grants a fid-range lease on a heartbeat reply,
    the port server mints from it, the port client prefers that lane,
    and a master-minted fid (assign_leases=False) stores the same bytes
    under another key."""
    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    m, vs = duo
    leased = MasterClient(m.url)
    legacy = MasterClient(m.url, assign_leases=False)
    assert legacy.assign().get("fid")  # grows the volume
    lease = _wait_lease(vs)
    assert lease["epoch"] >= 1 and lease["key_hi"] > lease["key_lo"]
    assert m.lease_counters["grant"] >= 1
    data = b"\x00leased payload\xff" * 128
    a = leased.assign()
    assert a.get("lease_epoch") == lease["epoch"], a
    b = legacy.assign()
    assert "lease_epoch" not in b and legacy.lease_assigns == 0
    assert leased.lease_assigns == 1 and vs.lease_stats["minted"] >= 1
    operation.upload_to(a["fid"], a["url"], data)
    operation.upload_to(b["fid"], b["url"], data)
    assert operation.read_data(leased, a["fid"]) == \
        operation.read_data(legacy, b["fid"]) == data
    assert a["fid"] != b["fid"]
    reply = http_call("GET", f"http://{m.url}/cluster/leases")
    assert reply[0] == 200 and b'"grant"' in reply[1]


def test_client_reresolves_leader_and_honors_deadline():
    """tests/test_assign_lease.py's wdclient units on the port's
    MasterClient: a 503 without a usable hint re-resolves the leader
    from the peers' /cluster/status, and an ambient deadline bounds the
    hunt across dead masters."""
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    from seaweedfs_tpu_torch.utils.httpd import HttpError
    from seaweedfs_tpu_torch.utils.resilience import (Deadline,
                                                      deadline_scope)
    leader_url = []
    confused = HttpServer()
    confused.add("POST", "/dir/assign",
                 lambda req: Response({"error": "shedding"}, status=503))
    confused.add("GET", "/cluster/status",
                 lambda req: Response({"IsLeader": False,
                                       "Leader": leader_url[0]}))
    confused.start()
    leader = HttpServer()
    leader.add("POST", "/dir/assign",
               lambda req: Response({"fid": "1,00000001deadbeef",
                                     "url": "x", "count": 1}))
    leader.start()
    leader_url.append(f"127.0.0.1:{leader.port}")
    try:
        mc = MasterClient([f"127.0.0.1:{confused.port}"],
                          assign_leases=False)
        assert mc.assign().get("fid") == "1,00000001deadbeef"
        assert mc.leader == leader_url[0]
    finally:
        confused.stop()
        leader.stop()
    mc = MasterClient(["127.0.0.1:1", "127.0.0.1:2"], assign_leases=False)
    t0 = time.monotonic()
    with deadline_scope(Deadline.after(0.5)):
        with pytest.raises((ConnectionError, HttpError)):
            mc._call("POST", "/dir/assign?count=1")
    assert time.monotonic() - t0 < 3.0
