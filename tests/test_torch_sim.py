"""The port's macro simulator held against the JAX package's.

Twins of the reference's tier-1 simulator tests run on the port
(seaweedfs_tpu_torch/sim over the port's qos, resilience, slo, lrc,
rebalance and tiering modules): the fault-schedule schema, determinism,
the 16-actor incident smokes, the drain and placement cases, the real
control policies on the virtual clock, and the netchaos replay of a sim
schedule against the port's HTTP server. Then the cross-package checks:
every incident at 16 actors, seed 0, gives the same report in both
packages, log_hash included; parse_schedule and ZipfWorkload give the same
output for the same input; clockctl's now_fn / thread_time_fn / is_virtual
behave as the reference's; and the hash table chip_smoke.py pins equals
the JAX package's hashes. The 100-actor matrix is slow-marked, as the
reference's is.
(ref tests/test_macro_sim.py, tests/test_chaos_drill.py's sim rehearsals,
tests/test_telemetry.py::test_sim_az_loss_slo_timeline_is_reproducible.)
"""

import ast
import functools
import json
import pathlib
import time

import pytest

from seaweedfs_tpu.sim import faults as jfaults
from seaweedfs_tpu.sim import incidents as jincidents
from seaweedfs_tpu.sim import workload as jworkload
from seaweedfs_tpu.utils import clockctl as jclockctl
from seaweedfs_tpu_torch.qos.limiter import AdaptiveLimiter
from seaweedfs_tpu_torch.sim.faults import FaultScheduler, parse_schedule
from seaweedfs_tpu_torch.sim.harness import SimCluster
from seaweedfs_tpu_torch.sim.incidents import INCIDENTS, run_incident
from seaweedfs_tpu_torch.sim.workload import ZipfWorkload, default_tenants
from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.utils.resilience import (CLOSED, HALF_OPEN, OPEN,
                                                  CircuitBreaker)

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------- fault schedule schema

def test_schedule_parses_json_and_dict_and_list():
    events = [{"link": "filer-0->vol-3", "fault": "latency",
               "start": 5.0, "duration": 10.0, "latency_ms": 250},
              {"link": "*->vol-7", "fault": "blackhole",
               "start": 8, "duration": 6}]
    for doc in (events, {"events": events},
                json.dumps({"events": events})):
        parsed = parse_schedule(doc)
        assert [e.fault for e in parsed] == ["latency", "blackhole"]
    # round-trips through to_dict
    again = parse_schedule([e.to_dict() for e in parse_schedule(events)])
    assert again[0].latency_ms == 250
    assert again[1].dst == "vol-7" and again[1].src == "*"


def test_schedule_rejects_malformed():
    with pytest.raises(ValueError):
        parse_schedule([{"link": "no-arrow", "fault": "latency",
                         "start": 0, "duration": 1}])
    with pytest.raises(ValueError):
        parse_schedule([{"link": "a->b", "fault": "meteor",
                         "start": 0, "duration": 1}])


def test_schedule_decide_stacks_latency_and_later_mode_wins():
    now = [0.0]
    sched = FaultScheduler(parse_schedule([
        {"link": "*->*", "fault": "latency", "start": 0, "duration": 10,
         "latency_ms": 100},
        {"link": "*->vol-1", "fault": "latency", "start": 0,
         "duration": 10, "latency_ms": 50},
        {"link": "*->vol-1", "fault": "http_error", "start": 5,
         "duration": 2, "status": 429},
    ]), lambda: now[0])
    mode, extra, _ = sched.decide("filer-0", "vol-1")
    assert mode is None and extra == pytest.approx(0.150)
    mode, extra, _ = sched.decide("filer-0", "vol-2")
    assert mode is None and extra == pytest.approx(0.100)
    now[0] = 6.0
    mode, extra, status = sched.decide("filer-0", "vol-1")
    assert mode == "http_error" and status == 429
    assert extra == pytest.approx(0.150)  # latency bands still stack
    now[0] = 12.0
    assert sched.decide("filer-0", "vol-1") == (None, 0.0, 503)
    assert sched.horizon() == 10.0


# the chaos drill's documents: one for the sim rehearsal and the real
# replay, and the divergence drill's victim-scoped partition
SCHEDULE = {"events": [
    {"link": "*->*", "fault": "latency", "start": 0.0, "duration": 1.2,
     "latency_ms": 30},
    {"link": "*->*", "fault": "http_error", "start": 0.3,
     "duration": 0.5, "status": 503},
]}
PARTITION_SCHEDULE = {"events": [
    {"link": "vol-1->*", "fault": "blackhole", "start": 0.2,
     "duration": 1.0},
    {"link": "*->vol-1", "fault": "blackhole", "start": 0.2,
     "duration": 1.0},
]}


def test_schedule_rehearses_in_sim():
    """The drill schedule drives the sim transport the way the real
    replay expects: latency band, error burst overriding it, full heal
    at the horizon."""
    events = parse_schedule(json.dumps(SCHEDULE))
    t = [0.0]
    sched = FaultScheduler(events, lambda: t[0])
    t[0] = 0.1
    mode, extra, _ = sched.decide("client", "vol-1")
    assert mode is None and extra == pytest.approx(0.03)
    t[0] = 0.5
    mode, extra, status = sched.decide("client", "vol-1")
    assert mode == "http_error" and status == 503
    assert extra == pytest.approx(0.03)  # latency band still stacks
    t[0] = 1.0
    mode, _, _ = sched.decide("client", "vol-1")
    assert mode is None  # error burst over, latency band remains
    t[0] = 1.3
    assert sched.decide("client", "vol-1") == (None, 0.0, 503)
    assert sched.horizon() == pytest.approx(1.2)


def test_partition_schedule_rehearses_in_sim():
    """The blackhole window is victim-scoped (both directions dark,
    unrelated links clean) and heals on the horizon."""
    events = parse_schedule(json.dumps(PARTITION_SCHEDULE))
    t = [0.0]
    sched = FaultScheduler(events, lambda: t[0])
    t[0] = 0.1
    assert sched.decide("filer-0", "vol-1")[0] is None  # not yet
    t[0] = 0.5
    mode, extra, _ = sched.decide("filer-0", "vol-1")  # inbound dark
    assert mode == "blackhole" and extra == 0.0
    assert sched.decide("vol-1", "filer-0")[0] == "blackhole"  # outbound
    assert sched.decide("filer-0", "vol-2")[0] is None  # bystander clean
    t[0] = 1.3
    assert sched.decide("filer-0", "vol-1")[0] is None  # healed
    assert sched.horizon() == pytest.approx(1.2)


# ------------------------------------------------------------ determinism

def test_same_seed_same_event_log():
    a = run_incident("az_loss", seed=5, n_actors=16)
    b = run_incident("az_loss", seed=5, n_actors=16)
    assert a["log_hash"] == b["log_hash"]
    assert a["client"]["ops"] == b["client"]["ops"]
    c = run_incident("az_loss", seed=6, n_actors=16)
    assert c["log_hash"] != a["log_hash"]


def test_workload_is_a_pure_function_of_seed():
    spec = default_tenants(3, 60.0)
    ops1 = ZipfWorkload(spec, seed=11).generate(20.0)
    ops2 = ZipfWorkload(default_tenants(3, 60.0), seed=11).generate(20.0)
    assert [(o.t, o.tenant, o.kind, o.key) for o in ops1] == \
        [(o.t, o.tenant, o.kind, o.key) for o in ops2]
    # zipf skew: the most popular 1% of drawn keys covers a large
    # share of the draws (hot-spot traffic, not uniform)
    from collections import Counter
    counts = Counter(o.key for o in ops1)
    top = sum(n for _, n in counts.most_common(max(1, len(counts) // 100)))
    assert top / len(ops1) > 0.05


def test_sim_az_loss_slo_timeline_is_reproducible():
    """The az_loss incident's alert timeline is part of the report and
    bit-identical across same-seed runs; the incident's own
    slo_fast_burn_fired / slo_resolved_after_heal invariants hold at
    16 actors."""
    a = run_incident("az_loss", seed=3, n_actors=16)
    assert a["passed"], [c for c in a["invariants"] if not c["ok"]]
    tl = a["slo"]["timeline"]
    assert any(cls == "interactive" and new == "fast_burn"
               for _t, cls, _old, new in tl), tl
    assert not a["slo"]["firing"]
    b = run_incident("az_loss", seed=3, n_actors=16)
    assert b["slo"]["timeline"] == tl
    assert b["log_hash"] == a["log_hash"]


# ------------------------------------------------------ incident smokes

def _by_check(r):
    assert r["passed"], [c for c in r["invariants"] if not c["ok"]]
    return {c["name"]: c for c in r["invariants"]}


def test_rolling_restart_invisible_at_16_actors():
    r = run_incident("rolling_restart", seed=0, n_actors=16)
    _by_check(r)
    assert r["client"]["failed"] == 0
    assert not r["repair"]["enqueued_for"]


def test_az_loss_converges_at_16_actors():
    r = run_incident("az_loss", seed=0, n_actors=16)
    _by_check(r)
    assert r["repair"]["done"] > 0
    assert r["repair"]["converged_at"] is not None


def test_partition_heal_mid_repair_at_16_actors():
    r = run_incident("partition_heal_mid_repair", seed=0, n_actors=16)
    by_check = _by_check(r)
    # partitioned ≠ crashed: every write during the window still acked
    assert r["client"]["failed"] == 0
    assert r["repair"]["done"] > 0
    assert by_check["repair_wave_engaged_before_heal"]["ok"]
    assert by_check["breakers_reclosed"]["ok"]


def test_ec_single_shard_loss_at_16_actors():
    r = run_incident("ec_single_shard_loss", seed=0, n_actors=16)
    by_check = _by_check(r)
    # degraded reads fail over mid-repair, never fail outright
    assert r["client"]["failed"] == 0
    assert r["repair"]["done"] > 0
    assert by_check["lrc_local_strategy_for_group_shards"]["ok"]
    assert by_check["lrc_read_cost_vs_rs"]["ok"]
    assert by_check["lrc_repair_bit_identical"]["ok"]


def test_hot_shard_migration_at_16_actors():
    r = run_incident("hot_shard_migration", seed=0, n_actors=16)
    by_check = _by_check(r)
    assert r["client"]["failed"] == 0
    assert by_check["planner_moved_hot_directory"]["ok"]
    assert by_check["hot_shard_share_collapsed"]["ok"]
    assert by_check["no_ping_pong"]["ok"]


def test_diurnal_sweep_at_16_actors():
    r = run_incident("diurnal_sweep", seed=0, n_actors=16)
    by_check = _by_check(r)
    assert r["client"]["failed"] == 0
    assert by_check["cooled_set_reached_cloud"]["ok"]
    assert by_check["reheated_set_promoted_home"]["ok"]
    assert by_check["only_diurnal_set_moved"]["ok"]
    assert by_check["silence_paused_planner"]["ok"]
    assert by_check["no_ping_pong"]["ok"]


def test_master_failover_mid_write_at_16_actors():
    r = run_incident("master_failover_mid_write", seed=0, n_actors=16)
    by_check = _by_check(r)
    # a 6 s leader outage under a write flood costs nothing: every fid
    # minted from a holder's lease
    assert r["client"]["failed"] == 0
    assert r["client"]["assign"]["leased"] > 0
    assert by_check["writes_minted_during_outage"]["ok"]
    assert by_check["leader_took_over"]["ok"]
    assert by_check["no_spurious_repairs"]["ok"]


def test_master_failover_mid_repair_at_16_actors():
    r = run_incident("master_failover_mid_repair", seed=0, n_actors=16)
    by_check = _by_check(r)
    assert r["repair"]["done"] > 0
    assert by_check["repair_wave_engaged_before_failover"]["ok"]
    assert by_check["no_duplicate_rebuilds"]["ok"]
    assert by_check["repair_wave_settled"]["ok"]


def test_comparator_lane_off_routes_assigns_to_master():
    """assign_leases=False is the pre-lease protocol: every write pays
    the master round trip."""
    cluster = SimCluster(n_volume_actors=8, n_az=4, seed=3,
                         assign_leases=False)
    wl = ZipfWorkload(default_tenants(2, 40.0), seed=3)
    cluster.load(wl.generate(8.0))
    cluster.run(10.0)
    assert cluster.metrics.master_assigns > 0
    assert cluster.metrics.lease_mints == 0
    assert cluster.metrics.fail_total == 0
    # and with the lane on (default), the same fleet mints locally
    cluster2 = SimCluster(n_volume_actors=8, n_az=4, seed=3)
    wl2 = ZipfWorkload(default_tenants(2, 40.0), seed=3)
    cluster2.load(wl2.generate(8.0))
    cluster2.run(10.0)
    assert cluster2.metrics.lease_mints > 0
    assert cluster2.metrics.master_assigns == 0


def test_unknown_incident_raises():
    with pytest.raises(KeyError):
        run_incident("kraken", n_actors=16)


def test_sim_drain_excludes_node_and_finishes_inflight():
    cluster = SimCluster(n_volume_actors=8, n_az=4, seed=1)
    wl = ZipfWorkload(default_tenants(2, 40.0), seed=1)
    cluster.load(wl.generate(8.0))
    cluster.at(2.0, cluster.drain, "vol-0")
    cluster.run(12.0)
    actor = cluster.actor("vol-0")
    assert actor.draining and actor.crashed  # drain ran to completion
    assert actor.active == 0                 # nothing left in flight
    st = cluster.master.nodes["vol-0"]
    assert st["draining"]
    # the master granted drain grace instead of queueing repairs
    assert cluster.master.drain_grace_until.get("vol-0", 0) > 0
    assert not cluster.master.repair_enqueued_for


def test_az_disjoint_placement_requires_enough_zones():
    with pytest.raises(ValueError):
        SimCluster(n_volume_actors=8, n_az=2, replication=3)
    c = SimCluster(n_volume_actors=8, n_az=4, replication=3)
    for vid, holders in c.master.layout.items():
        azs = {c.actor(h).az for h in holders}
        assert len(azs) == 3  # one replica per zone


# ------------------------------------- real policies on the virtual clock

def test_breaker_walks_open_half_open_closed_on_virtual_time():
    t = [0.0]
    with clockctl.install(lambda: t[0]):
        br = CircuitBreaker(failure_threshold=3, open_for=2.0)
        for _ in range(3):
            br.record(False)
        assert br.state == OPEN and not br.allow()
        t[0] += 1.0
        assert not br.probe_ripe() and not br.allow()
        t[0] += 1.1  # open_for elapsed: one probe slot opens
        assert br.probe_ripe()
        assert br.allow()
        assert br.state == HALF_OPEN
        assert not br.allow()  # probe slots metered (half_open_max=1)
        br.record(True, 0.004)
        assert br.state == CLOSED and br.allow()


def test_breaker_failed_probe_rearms_full_window():
    t = [0.0]
    with clockctl.install(lambda: t[0]):
        br = CircuitBreaker(failure_threshold=1, open_for=2.0)
        br.record(False)
        t[0] += 2.5
        assert br.allow()      # half-open probe
        br.record(False)       # probe fails: re-open, fresh clock
        assert br.state == OPEN
        t[0] += 1.0            # only half the window
        assert not br.allow()
        t[0] += 1.5
        assert br.allow()


def test_adaptive_limiter_gradient_on_scripted_trace():
    def make():
        return AdaptiveLimiter(initial=32, min_limit=8, max_limit=256)

    lim = make()
    # steady 4 ms service -> headroom, the limit climbs
    for _ in range(200):
        lim.observe(0.004)
    grown = lim.limit
    assert grown > 32
    assert lim.queue_delay() == pytest.approx(0.0, abs=1e-9)
    # latency steps to 40 ms: the short EWMA races ahead of the long
    # baseline, the gradient drops below 1, the limit backs off
    for _ in range(50):
        lim.observe(0.040)
    assert lim.queue_delay() > 0.010
    assert lim.limit < grown
    twin = make()
    for _ in range(200):
        twin.observe(0.004)
    for _ in range(50):
        twin.observe(0.040)
    assert twin.snapshot() == lim.snapshot()


def test_scrub_token_bucket_elapses_on_virtual_time():
    """The scrubber's byte throttle rides clockctl: 400 bytes at 100 B/s
    cost 4 virtual seconds and about no wall seconds."""
    from seaweedfs_tpu_torch.utils.limiter import TokenBucket

    t = [0.0]
    with clockctl.install(lambda: t[0],
                          sleep_fn=lambda s: t.__setitem__(0, t[0] + s)):
        tb = TokenBucket(rate_bytes_per_sec=100.0)
        wall0 = time.perf_counter()
        for _ in range(4):
            assert tb.consume(100)
        wall = time.perf_counter() - wall0
    assert t[0] == pytest.approx(4.0)
    assert wall < 0.5


def test_token_bucket_refuses_to_block_inside_the_sim():
    """install() without a sleep hook (how the sim kernel runs) makes a
    limiter that would block raise instead of stalling the one thread."""
    from seaweedfs_tpu_torch.utils.limiter import TokenBucket

    with clockctl.install(lambda: 0.0):
        tb = TokenBucket(rate_bytes_per_sec=10.0)
        with pytest.raises(RuntimeError, match="virtual clock"):
            tb.consume(100)


# ------------------------- same schedule schema against real processes

def test_netchaos_replays_sim_schedule_against_real_proxy():
    from seaweedfs_tpu_torch.utils.httpd import (HttpServer, Response,
                                                 http_call)
    from tools.netchaos import ChaosProxy, ScheduleDriver

    srv = HttpServer()
    srv.add("GET", "/ping", lambda req: Response({"ok": True}))
    srv.start()
    proxy = ChaosProxy("127.0.0.1", srv.port).start()
    # the JSON the port's sim transport consumes, replayed on wall time
    doc = {"events": [e.to_dict() for e in parse_schedule([
        {"link": "*->*", "fault": "http_error", "start": 0.1,
         "duration": 0.4, "status": 418}])]}
    driver = ScheduleDriver(proxy, doc).start()
    try:
        deadline = time.monotonic() + 2.0
        saw_fault = False
        while time.monotonic() < deadline and not saw_fault:
            status, _, _ = http_call("GET", f"http://{proxy.url}/ping",
                                     timeout=2.0)
            saw_fault = status == 418
            time.sleep(0.05)
        assert saw_fault
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and not driver.done():
            time.sleep(0.05)
        assert driver.done()  # schedule exhausted, proxy healed
        status, _, _ = http_call("GET", f"http://{proxy.url}/ping",
                                 timeout=2.0)
        assert status == 200
        modes = [a["mode"] for a in driver.applied]
        assert "http_error" in modes and modes[-1] == "pass"
    finally:
        driver.stop()
        proxy.stop()
        srv.stop()


# ------------------------------------------------- cross-package

@functools.lru_cache(maxsize=None)
def _reference_report(name: str) -> str:
    """The JAX package's report at 16 actors, seed 0, as JSON (run once
    per incident for the file)."""
    return json.dumps(jincidents.run_incident(name, seed=0, n_actors=16))


@pytest.mark.parametrize("name", sorted(jincidents.INCIDENTS))
def test_incident_report_equals_the_reference(name):
    """The port's report at 16 actors, seed 0, is the JAX package's:
    every invariant, metric, SLO timeline and the event-log hash."""
    assert sorted(INCIDENTS) == sorted(jincidents.INCIDENTS)
    want = json.loads(_reference_report(name))
    got = json.loads(json.dumps(run_incident(name, seed=0, n_actors=16)))
    assert got == want
    assert got["passed"]


@pytest.mark.parametrize("doc", [
    SCHEDULE, PARTITION_SCHEDULE,
    {"events": [{"link": "filer-0->vol-3", "fault": "latency",
                 "start": 5.0, "duration": 10.0, "latency_ms": 250},
                {"link": "*->vol-7", "fault": "blackhole", "start": 8,
                 "duration": 6},
                {"link": "*->*", "fault": "http_error", "start": 1,
                 "duration": 2, "status": 429}]}])
def test_parse_schedule_and_decide_match_the_reference(doc):
    got = parse_schedule(json.dumps(doc))
    want = jfaults.parse_schedule(json.dumps(doc))
    assert [e.to_dict() for e in got] == [e.to_dict() for e in want]
    t = [0.0]
    ps = FaultScheduler(got, lambda: t[0])
    js = jfaults.FaultScheduler(want, lambda: t[0])
    assert ps.horizon() == js.horizon()
    for step in range(0, 160):
        t[0] = step * 0.1
        for link in (("filer-0", "vol-1"), ("vol-1", "filer-0"),
                     ("filer-0", "vol-3"), ("client", "vol-7")):
            assert ps.decide(*link) == js.decide(*link)


@pytest.mark.parametrize("seed,tenants,rate,horizon",
                         [(11, 3, 60.0, 20.0), (0, 4, 240.0, 8.0),
                          (7, 1, 30.0, 30.0)])
def test_workload_matches_the_reference(seed, tenants, rate, horizon):
    got = ZipfWorkload(default_tenants(tenants, rate),
                       seed=seed).generate(horizon)
    want = jworkload.ZipfWorkload(jworkload.default_tenants(tenants, rate),
                                  seed=seed).generate(horizon)
    assert [(o.t, o.tenant, o.klass, o.kind, o.key, o.size) for o in got] \
        == [(o.t, o.tenant, o.klass, o.kind, o.key, o.size) for o in want]
    assert got


@pytest.mark.parametrize("mod", [clockctl, jclockctl],
                         ids=["port", "reference"])
def test_clockctl_hooks_behave_as_the_reference(mod):
    """now_fn defaults to monotonic_fn, thread_time stays real unless
    thread_time_fn is given, is_virtual follows the installed clock, and
    nested installs restore LIFO — identically in both packages."""
    assert not mod.is_virtual()
    real_now = mod.now()
    with mod.install(lambda: 5.0):
        assert mod.is_virtual()
        assert mod.monotonic() == 5.0 and mod.now() == 5.0
        t0 = mod.thread_time()
        sum(range(20000))
        assert mod.thread_time() >= t0 and mod.thread_time() != 5.0
        with pytest.raises(RuntimeError, match="virtual clock"):
            mod.sleep(1.0)
        with mod.install(lambda: 7.0, now_fn=lambda: 1e9,
                         thread_time_fn=lambda: 0.25):
            assert (mod.monotonic(), mod.now(), mod.thread_time()) == \
                (7.0, 1e9, 0.25)
        assert (mod.monotonic(), mod.now()) == (5.0, 5.0)
        assert mod.thread_time() != 0.25
    assert not mod.is_virtual()
    assert abs(mod.now() - real_now) < 60


def _smoke_hash_table() -> dict:
    """SIM_REFERENCE_HASHES as chip_smoke.py pins it (read from its source:
    the script is not imported)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "SIM_REFERENCE_HASHES"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py pins no SIM_REFERENCE_HASHES")


def test_smoke_hash_table_equals_the_reference():
    table = _smoke_hash_table()
    assert sorted(table) == sorted(jincidents.INCIDENTS)
    for name in sorted(jincidents.INCIDENTS):
        want = json.loads(_reference_report(name))["log_hash"]
        assert table[name] == want, name


def test_cli_prints_a_compact_report(capsys):
    from seaweedfs_tpu_torch.sim.__main__ import main
    assert main(["--incident", "rolling_restart", "--actors", "16",
                 "--compact"]) == 0
    out = json.loads(capsys.readouterr().out)
    want = json.loads(_reference_report("rolling_restart"))
    assert out["passed"] and out["log_hash"] == want["log_hash"][:16]
    assert out["wall_s"] >= 0 and out["ops"] == want["client"]["ops"]


# ------------------------------------------------- 100-actor acceptance

@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(INCIDENTS))
def test_incident_matrix_100_actors(name):
    r = run_incident(name, seed=0, n_actors=100)
    assert r["passed"], [c for c in r["invariants"] if not c["ok"]]


@pytest.mark.slow
def test_bit_reproducible_at_100_actors():
    a = run_incident("rolling_restart", seed=42, n_actors=100)
    b = run_incident("rolling_restart", seed=42, n_actors=100)
    assert a["log_hash"] == b["log_hash"]
