"""Scripted incident library + machine-checked invariants.

Ten incidents, each a pure function of (seed, n_actors):

  az_loss          grey-failure prelude (scripted latency band on every
                   link), then correlated crash of one whole AZ; the
                   fleet must lose zero acked writes, re-replicate
                   within the pacing budget, keep interactive p99
                   bounded and no tenant starved.
  rolling_restart  drain -> restart every node, one AZ at a time in
                   small groups; the drain path must make this
                   invisible: ZERO failed client requests and ZERO
                   repair enqueues for drained nodes, breakers all
                   re-closed at the end.
  herd_repair      simultaneous crash of a spread of nodes (repair
                   storm) plus a scripted 5xx flap on one survivor;
                   pacing must hold (active streams never exceed the
                   budget), convergence within budget, p99 bounded,
                   breakers recovered.
  tenant_flood     one tenant floods background scans at ~4x the total
                   polite load; the governor must keep interactive p99
                   bounded, shed the flood (not the polite tenants),
                   and still leave the flooder its background slot.
  partition_heal_mid_repair
                   a spread of nodes is partitioned (blackholed, not
                   crashed) long enough to trigger a repair wave, then
                   heals while the wave drains; the master must rejoin
                   the victims, settle the half-finished wave, lose no
                   acked write, and re-close every breaker — the sim
                   rehearsal of the hinted-handoff divergence drill.
  master_failover_mid_write
                   the Raft leader dies mid-write-flood for a 6s
                   election window; the fid-range assign leases must
                   carry every write (ZERO failed client requests,
                   lease mints observed during the dark window), the
                   new leader takes over with a bumped term, and the
                   outage alone must trigger no repairs and declare
                   no node dead.
  master_failover_mid_repair
                   the leader dies while a crash-triggered repair wave
                   is mid-flight; the dead leader's streams abort, the
                   new leader re-derives the wave from its own scan and
                   finishes it — no vid rebuilt twice, no repair entry
                   lost, zero acked-write loss, convergence within the
                   budget stretched only by the election + re-detect.
  hot_shard_migration
                   one namespace directory melts its owning filer shard
                   (80% of all ops); the REAL RebalancePlanner must
                   detect the imbalance from announce-shaped telemetry,
                   emit exactly one converged move plan, and flip a
                   REAL ShardRing via the override table mid-traffic —
                   rolling_restart shape: ZERO failed client requests,
                   the hot shard's routed share collapses after the
                   flip, and the cooldown/min-share gates prevent
                   ping-pong (no second flip).
  diurnal_sweep    a virtual day for the tiering autopilot: one sealed
                   working set carries the day traffic, goes dark for
                   the "night" phase, then re-heats at dawn.  The REAL
                   TieringPlanner must walk it down the full ladder
                   (hot -> EC -> cloud) from heartbeat-shaped
                   cumulative read counters, pause outright through a
                   scripted telemetry-silence window, promote the set
                   back (cloud -> EC -> hot) when it re-heats, and
                   never touch the steady-warm set or any still-
                   writable volume — with ZERO failed client requests
                   and no ping-pong (no demotion after a promotion).
  ec_single_shard_loss
                   ONE shard holder dies under live traffic — the LRC
                   repair drill.  Hybrid incident: the sim cluster must
                   repair the lost holder with ZERO failed client ops
                   (degraded reads fail over, never fail), while the
                   code-level checks drive the real LrcCoder over every
                   single-shard erasure — group shards must plan
                   group-LOCAL repairs and the read cost must stay
                   <= 0.6x the RS(10,4) baseline of k=10 columns.

``run_incident`` returns a JSON-able report: per-invariant verdicts,
client/repair metrics, the event-log hash (bit-reproducibility), and
the sizing actually used.  Used by tests/test_torch_sim.py (16-actor
tier-1 smoke, 100-actor slow matrix) and ``python -m seaweedfs_tpu_torch.sim``.

The port's copy of seaweedfs_tpu/sim/incidents.py. It imports nothing of that
package.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.qos.classes import INTERACTIVE
from seaweedfs_tpu_torch.sim.faults import parse_schedule
from seaweedfs_tpu_torch.sim.harness import SimCluster, percentile
from seaweedfs_tpu_torch.sim.workload import TenantSpec, ZipfWorkload, \
    default_tenants
from seaweedfs_tpu_torch.stats.slo import FAST_BURN

# interactive p99 ceiling (virtual seconds) for every incident: service
# time is ~4ms, so 250ms allows one failover + backoff but not collapse
P99_BOUND_S = 0.25
# partition incidents pay one full wedged-peer read timeout (0.6s in
# FilerActor) + failover service time on the unlucky tail read; crash
# incidents never do (a dead socket refuses instantly)
P99_PARTITION_BOUND_S = 0.75
TENANT_MIN_OK_RATIO = 0.85


def _check(name: str, ok: bool, detail: str) -> dict:
    return {"name": name, "ok": bool(ok), "detail": detail}


def _common_invariants(cluster: SimCluster, checks: list) -> None:
    lost = cluster.lost_acked_writes()
    checks.append(_check(
        "zero_acked_write_loss", not lost,
        f"{len(lost)} acked writes unreadable" if lost
        else f"{len(cluster.metrics.acked)} acked writes all readable"))
    p99 = percentile(cluster.metrics.lat[INTERACTIVE], 0.99)
    checks.append(_check(
        "interactive_p99_bounded", p99 <= P99_BOUND_S,
        f"p99={p99 * 1000:.1f}ms bound={P99_BOUND_S * 1000:.0f}ms"))


def _tenant_invariant(cluster: SimCluster, checks: list,
                      exclude=()) -> None:
    worst_name, worst = "", 1.0
    for t, (ok, fail) in sorted(cluster.metrics.tenants.items()):
        if t in exclude or ok + fail == 0:
            continue
        ratio = ok / (ok + fail)
        if ratio < worst:
            worst_name, worst = t, ratio
    checks.append(_check(
        "no_tenant_starvation", worst >= TENANT_MIN_OK_RATIO,
        f"worst tenant {worst_name or 'n/a'} ok-ratio {worst:.3f} "
        f"(floor {TENANT_MIN_OK_RATIO})"))


def _slo_invariants(cluster: SimCluster, checks: list,
                    expect_cls: str) -> None:
    """The burn-rate judge must page during the incident (fast-burn on
    the class the script degrades) and stand down once healed."""
    fired = [(t, cls) for t, cls, _old, new in cluster.slo.timeline()
             if new == FAST_BURN and cls == expect_cls]
    checks.append(_check(
        "slo_fast_burn_fired", bool(fired),
        f"{expect_cls} fast-burn paged at t={fired[0][0]:.1f}s"
        if fired else f"no fast-burn transition for {expect_cls} "
                      f"(timeline: {cluster.slo.timeline()[:6]})"))
    firing = cluster.slo.firing()
    checks.append(_check(
        "slo_resolved_after_heal", not firing,
        f"still firing at end: {firing}" if firing
        else "all classes back to ok"))


def _breaker_invariant(cluster: SimCluster, checks: list) -> None:
    bad = cluster.open_breakers()
    checks.append(_check(
        "breakers_reclosed", not bad,
        f"open against live nodes: {bad[:4]}" if bad
        else "all filer breakers closed against live nodes"))


def _convergence_invariant(cluster: SimCluster, checks: list,
                           t_fault: float, n_repairs_expected: int) -> None:
    m = cluster.master
    copy_s = (cluster.volumes[0].base_volume_bytes
              / m.repair_stream_bw + 0.1)
    # detection (5 pulses + tick quantization) + continuous scan grace
    # + paced copy waves with 3.5x slack for backoff/stagger + settle
    budget = (12.0 + m.repair_grace_s
              + 3.5 * n_repairs_expected * copy_s / m.max_repair_streams
              + 15.0)
    took = (m.converged_at - t_fault) if m.converged_at else None
    checks.append(_check(
        "repair_converged_in_budget",
        took is not None and took <= budget,
        f"converged in {took:.1f}s (budget {budget:.1f}s, "
        f"{m.repairs_done} repairs)" if took is not None
        else f"NOT converged (queue={len(m._queue)} "
             f"active={len(m._active)} degraded={len(cluster.degraded_vids())})"))
    checks.append(_check(
        "repair_pacing_held",
        m.repair_active_max <= m.max_repair_streams,
        f"max active streams {m.repair_active_max} "
        f"<= budget {m.max_repair_streams}"))


def _settle(cluster: SimCluster, workload: ZipfWorkload, t0: float,
            duration: float) -> None:
    """Light post-incident traffic so half-open probes have something
    to ride on (breakers only transition on real calls)."""
    rate = max(8.0, 0.5 * len(cluster.volumes))
    ops = ZipfWorkload([TenantSpec("settle", rate)],
                       seed=cluster.kernel.seed + 7,
                       keyspace=workload.keyspace).generate(duration)
    for op in ops:
        op.t += t0
    cluster.load(ops)


# ---------------------------------------------------------------- incidents

def _az_loss(cluster: SimCluster, n_actors: int, rate: float) -> list:
    duration, t_fault = 40.0, 12.0
    schedule = [{"link": "*->*", "fault": "latency", "start": 8.0,
                 "duration": 4.0, "latency_ms": 60}]
    cluster.faults.events[:] = parse_schedule(schedule)
    wl = ZipfWorkload(default_tenants(4, rate), seed=cluster.kernel.seed)
    cluster.load(wl.generate(duration))
    cluster.at(t_fault, cluster.crash_az, 0)
    cluster.run(duration)
    n_lost = len(cluster.az_nodes(0))
    degraded = sum(1 for vid, holders in cluster.master.layout.items()
                   if any(cluster.actor(h).crashed for h in holders))
    _settle(cluster, wl, duration, 30.0)
    cluster.run_until_converged(duration + 90.0)
    cluster.run(cluster.kernel.now + 8.0)  # let probes settle
    checks: list = []
    _common_invariants(cluster, checks)
    _tenant_invariant(cluster, checks)
    _convergence_invariant(cluster, checks, t_fault, degraded)
    checks.append(_check(
        "az_dead_detected", len(cluster.master.dead) == n_lost,
        f"{len(cluster.master.dead)}/{n_lost} lost nodes declared dead"))
    # the grey-failure band (60ms on every link) pushes interactive ops
    # past their 50ms sim target, so the fast window must page — and
    # the healed, converged fleet must resolve it
    _slo_invariants(cluster, checks, INTERACTIVE)
    return checks


def _rolling_restart(cluster: SimCluster, n_actors: int,
                     rate: float) -> list:
    wl = ZipfWorkload(default_tenants(4, rate), seed=cluster.kernel.seed)

    def roll():
        yield 6.0  # warmup traffic first
        for az in range(cluster.n_az):
            nodes = cluster.az_nodes(az)
            group = max(1, len(nodes) // 4)
            for i in range(0, len(nodes), group):
                batch = nodes[i:i + group]
                drains = [cluster.kernel.spawn(
                    cluster.actor(n).drain()) for n in batch]
                yield drains
                yield 3.0  # process down: restart delay
                for n in batch:
                    cluster.restore(n)
                yield 2.0  # re-register + settle before next batch

    driver = cluster.kernel.spawn(roll())
    # traffic must cover the whole wave: 4 az * 4 groups * ~6s
    duration = 6.0 + cluster.n_az * 4 * 6.5 + 10.0
    cluster.load(wl.generate(duration))
    cluster.run(duration)
    if not driver.done:  # pragma: no cover - sizing guard
        raise RuntimeError("rolling restart did not finish in window")
    _settle(cluster, wl, duration, 10.0)
    cluster.run(duration + 12.0)  # 2x breaker open_for + probe traffic
    checks: list = []
    _common_invariants(cluster, checks)
    checks.append(_check(
        "zero_failed_client_requests", cluster.metrics.fail_total == 0,
        f"{cluster.metrics.fail_total} failed ops "
        f"(samples: {cluster.metrics.fail_samples[:3]})"
        if cluster.metrics.fail_total else
        f"all {cluster.metrics.ops_total()} ops succeeded"))
    enq = cluster.master.repair_enqueued_for
    checks.append(_check(
        "zero_repairs_for_drained_nodes", not enq,
        f"repairs enqueued for {dict(enq)}" if enq
        else "repair queue never saw a drained node"))
    _breaker_invariant(cluster, checks)
    _tenant_invariant(cluster, checks)
    return checks


def _herd_repair(cluster: SimCluster, n_actors: int, rate: float) -> list:
    duration, t_fault = 40.0, 10.0
    victims = [f"vol-{i}" for i in range(0, n_actors, 7)]
    flapper = f"vol-{3 % n_actors}"
    schedule = [{"link": f"*->{flapper}", "fault": "http_error",
                 "start": 14.0, "duration": 5.0, "status": 503}]
    cluster.faults.events[:] = parse_schedule(schedule)
    wl = ZipfWorkload(default_tenants(4, rate), seed=cluster.kernel.seed)
    cluster.load(wl.generate(duration))

    def herd():
        yield t_fault
        cluster.kernel.note("incident", "herd_crash", str(len(victims)))
        for v in victims:
            cluster.crash(v)

    cluster.kernel.spawn(herd())
    cluster.run(duration)
    degraded = sum(1 for vid, holders in cluster.master.layout.items()
                   if any(cluster.actor(h).crashed for h in holders))
    _settle(cluster, wl, duration, 30.0)
    cluster.run_until_converged(duration + 120.0)
    cluster.run(cluster.kernel.now + 8.0)
    checks: list = []
    _common_invariants(cluster, checks)
    _convergence_invariant(cluster, checks, t_fault, degraded)
    _breaker_invariant(cluster, checks)
    _tenant_invariant(cluster, checks)
    return checks


def _tenant_flood(cluster: SimCluster, n_actors: int, rate: float) -> list:
    duration = 40.0
    # 30x: enough queueing collateral to push interactive past its
    # latency target at cliff rate (fast-burn pages) even at the
    # 16-actor smoke scale, while the governor still sheds the flood
    tenants = default_tenants(4, rate, flood_tenant="flooder",
                              flood_rate=30.0 * rate)
    wl = ZipfWorkload(tenants, seed=cluster.kernel.seed)
    cluster.load(wl.generate(duration))
    cluster.run(duration + 5.0)
    # heal = the flood simply stops; polite settle traffic carries the
    # burn windows back down so the alert must resolve
    _settle(cluster, wl, duration + 5.0, 15.0)
    cluster.run(duration + 25.0)
    checks: list = []
    _common_invariants(cluster, checks)
    _tenant_invariant(cluster, checks, exclude=("flooder", "settle"))
    fl_ok, _fl_fail = cluster.metrics.tenants.get("flooder", (0, 0))
    fl_shed = cluster.metrics.sheds.get("flooder", 0)
    polite_shed = sum(n for t, n in cluster.metrics.sheds.items()
                      if t != "flooder")
    checks.append(_check(
        "flood_was_shed", fl_shed > 0 and fl_shed >= 10 * max(1, polite_shed),
        f"flooder shed {fl_shed}x vs polite tenants {polite_shed}x"))
    checks.append(_check(
        "flood_not_fully_starved", fl_ok > 0,
        f"flooder still completed {fl_ok} background ops"))
    # the judged class is interactive: the governor sheds the flood
    # (background mostly retries to completion), but the queueing
    # collateral pushes interactive ops past their latency target at
    # cliff rate — exactly the page an operator wants from a flood
    _slo_invariants(cluster, checks, INTERACTIVE)
    return checks


def _partition_heal_mid_repair(cluster: SimCluster, n_actors: int,
                               rate: float) -> list:
    """Network partition (not a crash): a spread of nodes goes dark on
    the wire long enough for the master to declare them dead and start
    a repair wave, then the partition heals while the wave is still
    draining. The victims' heartbeats resume, the master must rejoin
    them (dead set emptied), the half-finished wave must settle without
    wedging (queue and active drain, degraded set clears), no acked
    write may be lost, and breakers against the healed nodes must
    re-close. This is the sim rehearsal of the hinted-handoff drill:
    writes during the partition succeed on the surviving quorum, and
    heal-time repair closes the divergence window."""
    # part_len is tuned so the heal lands while the wave is still
    # draining: dead declared ~t_part+10, scan grace 5s, so the wave
    # starts ~t_part+15 and the heal at t_part+18 catches it mid-queue.
    # That matters beyond fidelity to the name — a completed repair
    # removes the dead holder from the layout, so a partition long
    # enough to re-home EVERY victim volume leaves the healed nodes
    # holding nothing, and no traffic (hence no breaker probe) ever
    # dials them again
    duration, t_part, part_len = 45.0, 8.0, 18.0
    victims = [f"vol-{i}" for i in range(0, n_actors, 9)]
    schedule = []
    for v in victims:
        # both directions: outbound kills the victim's heartbeats,
        # inbound kills client and repair traffic to it
        schedule.append({"link": f"{v}->*", "fault": "blackhole",
                         "start": t_part, "duration": part_len})
        schedule.append({"link": f"*->{v}", "fault": "blackhole",
                         "start": t_part, "duration": part_len})
    cluster.faults.events[:] = parse_schedule(schedule)
    wl = ZipfWorkload(default_tenants(4, rate), seed=cluster.kernel.seed)
    cluster.load(wl.generate(duration))
    # run exactly to the heal instant and snapshot the repair plane:
    # the wave must already be engaged when the partition lifts
    cluster.run(t_part + part_len)
    m = cluster.master
    wave_at_heal = (len(m._queue), len(m._active), m.repairs_done)
    dead_at_heal = sorted(m.dead)
    cluster.run(duration)
    _settle(cluster, wl, duration, 30.0)
    cluster.run_until_converged(duration + 90.0)
    # consume the whole settle window: the wave often finishes BEFORE
    # the heal (converged almost immediately), and breaker probes only
    # ride real traffic
    cluster.run(max(cluster.kernel.now + 8.0, duration + 32.0))
    checks: list = []
    lost = cluster.lost_acked_writes()
    checks.append(_check(
        "zero_acked_write_loss", not lost,
        f"{len(lost)} acked writes unreadable" if lost
        else f"{len(cluster.metrics.acked)} acked writes all readable"))
    # a blackholed peer (unlike a crashed one) answers nothing: the
    # first read to touch it pays its full timeout before failing over,
    # so the honest p99 ceiling is one wedged-peer timeout + failover,
    # not the steady-state bound — collapse would still blow through it
    p99 = percentile(cluster.metrics.lat[INTERACTIVE], 0.99)
    checks.append(_check(
        "interactive_p99_bounded", p99 <= P99_PARTITION_BOUND_S,
        f"p99={p99 * 1000:.1f}ms "
        f"bound={P99_PARTITION_BOUND_S * 1000:.0f}ms"))
    _tenant_invariant(cluster, checks)
    checks.append(_check(
        "partition_detected", bool(dead_at_heal),
        f"{len(dead_at_heal)}/{len(victims)} victims declared dead "
        f"during the partition" if dead_at_heal
        else "master never declared a victim dead"))
    checks.append(_check(
        "repair_wave_engaged_before_heal", any(wave_at_heal),
        f"at heal: queued={wave_at_heal[0]} active={wave_at_heal[1]} "
        f"done={wave_at_heal[2]}"))
    still_dead = [v for v in victims if v in m.dead]
    checks.append(_check(
        "victims_rejoined_after_heal", not still_dead,
        f"still dead: {still_dead}" if still_dead
        else f"all {len(victims)} victims heartbeating again"))
    checks.append(_check(
        "repair_wave_settled", not m._queue and not m._active
        and not cluster.degraded_vids(),
        f"queue={len(m._queue)} active={len(m._active)} "
        f"degraded={len(cluster.degraded_vids())}"))
    _breaker_invariant(cluster, checks)
    return checks


def _ec_single_shard_loss(cluster: SimCluster, n_actors: int,
                          rate: float) -> list:
    """Single-shard-loss repair drill, the LRC headline case.  The
    macro sim models whole volume holders (not individual EC shard
    files), so the incident is a hybrid: the cluster loses ONE holder
    under live traffic — the single-shard-loss analogue — and must
    repair it with zero failed client operations, degraded reads
    failing over rather than failing.  The code-level invariants then
    run the REAL LrcCoder over every single-shard erasure pattern: the
    planner must choose the group-local strategy for every shard that
    lives in a local group (data 0-9 + local parities 10-11), the mean
    plan read cost across all 14 losses must stay <= 0.6x the RS(10,4)
    baseline of k=10 columns, and a plan-driven rebuild must be
    bit-identical to the lost shard."""
    import numpy as np

    from seaweedfs_tpu_torch.ops.lrc import LrcCoder

    duration, t_fault = 35.0, 10.0
    wl = ZipfWorkload(default_tenants(4, rate), seed=cluster.kernel.seed)
    cluster.load(wl.generate(duration))
    victim = f"vol-{5 % n_actors}"
    cluster.at(t_fault, cluster.crash, victim)
    cluster.run(duration)
    degraded = sum(1 for vid, holders in cluster.master.layout.items()
                   if any(cluster.actor(h).crashed for h in holders))
    _settle(cluster, wl, duration, 30.0)
    cluster.run_until_converged(duration + 90.0)
    cluster.run(cluster.kernel.now + 8.0)
    checks: list = []
    _common_invariants(cluster, checks)
    checks.append(_check(
        "zero_failed_degraded_reads", cluster.metrics.fail_total == 0,
        f"{cluster.metrics.fail_total} failed ops mid-repair "
        f"(samples: {cluster.metrics.fail_samples[:3]})"
        if cluster.metrics.fail_total else
        f"all {cluster.metrics.ops_total()} ops succeeded while "
        f"{victim} was down"))
    _tenant_invariant(cluster, checks)
    _convergence_invariant(cluster, checks, t_fault, degraded)
    _breaker_invariant(cluster, checks)

    # ---- code-level repair-plan invariants (real LrcCoder) ----
    coder = LrcCoder()
    spec = coder.scheme
    total, k = spec.total_shards, spec.data_shards
    group_sids: set = set()
    for g in range(spec.local_groups):
        group_sids.update(spec.group_members(g))
    strategies, reads = {}, []
    for sid in range(total):
        st = coder.repair_strategy(
            [s for s in range(total) if s != sid], [sid])
        strategies[sid] = st["strategy"]
        reads.append(st["reads"])
    bad = [s for s in sorted(group_sids) if strategies[s] != "local"]
    checks.append(_check(
        "lrc_local_strategy_for_group_shards", not bad,
        f"group shards planned globally: {bad}" if bad else
        f"all {len(group_sids)} group shards plan group-local repairs "
        f"({spec.group_size} reads each)"))
    mean_reads = sum(reads) / len(reads)
    ratio = mean_reads / k
    checks.append(_check(
        "lrc_read_cost_vs_rs", ratio <= 0.6,
        f"mean plan reads {mean_reads:.2f} cols vs RS baseline {k} "
        f"-> ratio {ratio:.3f} (ceiling 0.6)"))
    rng = np.random.default_rng(cluster.kernel.seed)
    data = rng.integers(0, 256, size=(k, 512), dtype=np.uint8)
    shards = coder.encode([data[i].tobytes() for i in range(k)])
    sid = 5 % total
    src, mat = coder.plan_rebuild(
        [s for s in range(total) if s != sid], [sid])
    rec = coder.reconstruct_rows(
        np.stack([np.frombuffer(shards[s], dtype=np.uint8)
                  for s in src]), mat)
    checks.append(_check(
        "lrc_repair_bit_identical",
        rec[0].tobytes() == bytes(shards[sid]),
        f"shard {sid} rebuilt bit-identically from "
        f"{len(src)} group columns"))
    return checks


def _master_failover_mid_write(cluster: SimCluster, n_actors: int,
                               rate: float) -> list:
    """The headline lease drill: the Raft leader dies under a full
    write flood. Holders hold epoch-stamped fid-range leases renewed
    every heartbeat (TTL 15x the pulse), so local minting rides out
    any election window shorter than the TTL — the dark master must
    cost ZERO failed client requests. Reads survive on follower-served
    lookups; the new leader's bumped term proves the failover actually
    happened rather than the window being too gentle to notice."""
    duration, t_fail, outage = 40.0, 12.0, 6.0
    wl = ZipfWorkload(default_tenants(4, rate), seed=cluster.kernel.seed)
    cluster.load(wl.generate(duration))
    cluster.run(t_fail)
    mints_before = cluster.metrics.lease_mints
    cluster.fail_master_leader(outage)
    cluster.run(t_fail + outage)
    mints_during = cluster.metrics.lease_mints - mints_before
    cluster.run(duration)
    _settle(cluster, wl, duration, 10.0)
    cluster.run(duration + 12.0)
    m = cluster.master
    checks: list = []
    _common_invariants(cluster, checks)
    checks.append(_check(
        "zero_failed_client_requests", cluster.metrics.fail_total == 0,
        f"{cluster.metrics.fail_total} failed ops "
        f"(samples: {cluster.metrics.fail_samples[:3]})"
        if cluster.metrics.fail_total else
        f"all {cluster.metrics.ops_total()} ops succeeded across the "
        f"{outage:.0f}s election window"))
    checks.append(_check(
        "writes_minted_during_outage", mints_during > 0,
        f"{mints_during} fids minted from leases while the "
        f"leader was dark"))
    checks.append(_check(
        "leader_took_over", m.term == 2,
        f"term={m.term} (takeover {'happened' if m.term == 2 else 'MISSING'})"))
    checks.append(_check(
        "no_spurious_repairs", m.repairs_done == 0 and not m.dead,
        f"repairs={m.repairs_done} dead={sorted(m.dead)}"
        if m.repairs_done or m.dead else
        "election window triggered no repair and declared nobody dead"))
    _tenant_invariant(cluster, checks)
    _breaker_invariant(cluster, checks)
    return checks


def _master_failover_mid_repair(cluster: SimCluster, n_actors: int,
                                rate: float) -> list:
    """Cascading failover: a herd crash puts a repair wave in flight,
    then the leader coordinating that wave dies. The dead leader's
    streams abort at their next yield (they belong to the old
    incarnation); the new leader starts with an empty queue and must
    re-derive the remaining work from its own degraded scan — repairs
    already committed to the replicated layout are not redone (no vid
    rebuilt twice), repairs not yet committed are not forgotten (the
    fleet still converges)."""
    duration, t_crash, t_leader, outage = 45.0, 10.0, 27.0, 6.0
    victims = [f"vol-{i}" for i in range(0, n_actors, 7)]
    wl = ZipfWorkload(default_tenants(4, rate), seed=cluster.kernel.seed)
    cluster.load(wl.generate(duration))

    def herd():
        yield t_crash
        cluster.kernel.note("incident", "herd_crash", str(len(victims)))
        for v in victims:
            cluster.crash(v)

    cluster.kernel.spawn(herd())
    # run exactly to the leader failure and snapshot the repair plane:
    # the wave must already be engaged when the leader dies, or the
    # incident degenerates into plain herd_repair
    cluster.run(t_leader)
    m = cluster.master
    wave_at_fail = (len(m._queue), len(m._active), m.repairs_done)
    cluster.fail_master_leader(outage)
    cluster.run(duration)
    degraded = sum(1 for vid, holders in cluster.master.layout.items()
                   if any(cluster.actor(h).crashed for h in holders))
    _settle(cluster, wl, duration, 30.0)
    cluster.run_until_converged(duration + 120.0)
    cluster.run(cluster.kernel.now + 8.0)
    checks: list = []
    _common_invariants(cluster, checks)
    checks.append(_check(
        "repair_wave_engaged_before_failover", any(wave_at_fail),
        f"at leader death: queued={wave_at_fail[0]} "
        f"active={wave_at_fail[1]} done={wave_at_fail[2]}"))
    checks.append(_check(
        "leader_took_over", m.term == 2,
        f"term={m.term}"))
    dup = {v: n for v, n in m.repair_log.items() if n > 1}
    checks.append(_check(
        "no_duplicate_rebuilds", not dup,
        f"vids rebuilt more than once: {dup}" if dup else
        f"{len(m.repair_log)} vids rebuilt exactly once across terms"))
    checks.append(_check(
        "repair_wave_settled", not m._queue and not m._active
        and not cluster.degraded_vids(),
        f"queue={len(m._queue)} active={len(m._active)} "
        f"degraded={len(cluster.degraded_vids())}"))
    # standard pacing budget from the crash instant, stretched by the
    # election window plus one liveness re-detection cycle (takeover
    # resets every node's clock, so the dead are re-declared ~10s +
    # scan grace later)
    copy_s = (cluster.volumes[0].base_volume_bytes
              / m.repair_stream_bw + 0.1)
    budget = (12.0 + m.repair_grace_s
              + 3.5 * degraded * copy_s / m.max_repair_streams
              + 15.0 + outage + 12.0 + m.repair_grace_s)
    took = (m.converged_at - t_crash) if m.converged_at else None
    checks.append(_check(
        "repair_converged_in_budget",
        took is not None and took <= budget,
        f"converged in {took:.1f}s (budget {budget:.1f}s, "
        f"{m.repairs_done} repairs across terms)" if took is not None
        else f"NOT converged (queue={len(m._queue)} "
             f"active={len(m._active)} "
             f"degraded={len(cluster.degraded_vids())})"))
    checks.append(_check(
        "repair_pacing_held",
        m.repair_active_max <= m.max_repair_streams,
        f"max active streams {m.repair_active_max} "
        f"<= budget {m.max_repair_streams}"))
    _breaker_invariant(cluster, checks)
    _tenant_invariant(cluster, checks)
    return checks


def _hot_shard_migration(cluster: SimCluster, n_actors: int,
                         rate: float) -> list:
    """Temperature-driven directory migration, closed loop.  The sim's
    filers are client-side drivers (no namespace service plane), so the
    namespace layer is modeled HERE with the real production pieces:
    ops route to the filer owning their directory per a real ShardRing,
    per-shard counters feed a real RebalancePlanner at announce
    cadence, and a modeled mover (copy delay, then commit) flips the
    ring with a real ``with_overrides`` epoch bump.  One directory
    carries 80% of the load, melting its hash-owner; the planner must
    move it to the coolest shard with zero failed client ops
    (rolling_restart shape) and then STOP — the cooldown and min-share
    gates must prevent the destination (now hottest by construction)
    from shedding crumbs forever."""
    from seaweedfs_tpu_torch.filer.rebalance import RebalancePlanner
    from seaweedfs_tpu_torch.filer.shard_ring import ShardRing

    duration = 40.0
    hot_dir = "/zipf/hot"
    names = [f.name for f in cluster.filers]
    by_name = {f.name: f for f in cluster.filers}
    ring = [ShardRing(names)]  # one-slot holder: the flip swaps it
    hot_owner = ring[0].owner(hot_dir)
    planner = RebalancePlanner(window_s=8.0, threshold=1.5,
                               min_rate=2.0, cooldown_s=60.0)
    ops_cum = {n: 0 for n in names}
    dirs_cum: dict = {n: {} for n in names}
    routed = {"pre": {n: 0 for n in names},
              "post": {n: 0 for n in names}}
    flips: list = []

    def dir_of(op) -> str:
        # 80% of ops hammer one directory; the rest spread over 97
        # buckets so every shard has a pulse (the planner refuses to
        # plan over members it has no rate for)
        if op.key % 10 < 8:
            return hot_dir
        return "/zipf/b%03d" % (op.key % 97)

    def dispatch(op) -> None:
        owner = ring[0].owner(dir_of(op))
        ops_cum[owner] += 1
        dc = dirs_cum[owner]
        d = dir_of(op)
        dc[d] = dc.get(d, 0) + 1
        routed["post" if flips else "pre"][owner] += 1
        cluster._start_op(by_name[owner], op)

    wl = ZipfWorkload(default_tenants(4, rate), seed=cluster.kernel.seed)
    for op in wl.generate(duration):
        cluster.kernel.schedule(op.t, dispatch, op)

    def control_loop():
        # the master's announce-ingest cadence: every 2s each shard
        # reports cumulative ops + top directories, then the planner
        # gets one shot at the current ring
        while cluster.kernel.now < duration:
            yield 2.0
            now = cluster.kernel.now
            for n in names:
                top = sorted(dirs_cum[n].items(),
                             key=lambda kv: (-kv[1], kv[0]))[:8]
                planner.observe(
                    n, {"ops": ops_cum[n],
                        "dirs": [{"key": d, "count": c}
                                 for d, c in top]}, now=now)
            plan = planner.plan(ring[0], now=now)
            if plan is None:
                continue

            def mover(moves=plan["moves"]):
                yield 1.5  # modeled copy + delta drain before commit
                new = ring[0].with_overrides(
                    {m["dir"]: m["to"] for m in moves})
                assert new.epoch > ring[0].epoch
                ring[0] = new
                for m in moves:
                    planner.note_committed(m["dir"],
                                           now=cluster.kernel.now)
                flips.append((cluster.kernel.now, list(moves)))
                cluster.kernel.note("incident", "ring_flip",
                                    f"epoch={new.epoch}")

            cluster.kernel.spawn(mover())

    cluster.kernel.spawn(control_loop())
    cluster.run(duration)
    _settle(cluster, wl, duration, 10.0)
    cluster.run(duration + 12.0)
    checks: list = []
    _common_invariants(cluster, checks)
    checks.append(_check(
        "zero_failed_client_requests", cluster.metrics.fail_total == 0,
        f"{cluster.metrics.fail_total} failed ops "
        f"(samples: {cluster.metrics.fail_samples[:3]})"
        if cluster.metrics.fail_total else
        f"all {cluster.metrics.ops_total()} ops succeeded across "
        f"{len(flips)} ring flip(s)"))
    moved = flips and any(m["dir"] == hot_dir
                          for _, mv in flips for m in mv)
    checks.append(_check(
        "planner_moved_hot_directory",
        bool(moved) and ring[0].overrides.get(hot_dir) not in (
            None, hot_owner),
        f"hot dir {hot_dir}: {hot_owner} -> "
        f"{ring[0].overrides.get(hot_dir)} at "
        f"t={flips[0][0]:.1f}s (ring epoch {ring[0].epoch})"
        if flips else "planner never flipped the ring"))
    pre_n, post_n = sum(routed["pre"].values()), sum(routed["post"].values())
    pre_share = routed["pre"][hot_owner] / pre_n if pre_n else 0.0
    post_share = routed["post"][hot_owner] / post_n if post_n else 1.0
    checks.append(_check(
        "hot_shard_share_collapsed",
        pre_share >= 0.5 and post_share <= 0.35,
        f"{hot_owner} routed share {pre_share:.2f} pre-flip -> "
        f"{post_share:.2f} post-flip "
        f"({pre_n} pre / {post_n} post ops)"))
    # under zipf a couple of second-tier directories are individually
    # warm, so follow-up spread moves are legitimate — thrash is a
    # directory moving TWICE (ping-pong) or the planner never settling
    moved_dirs = [m["dir"] for _, mv in flips for m in mv]
    checks.append(_check(
        "no_ping_pong",
        len(set(moved_dirs)) == len(moved_dirs) and len(flips) <= 3,
        f"{len(flips)} flips, moved {moved_dirs} "
        f"(each dir at most once, <=3 plans)"))
    _tenant_invariant(cluster, checks)
    _breaker_invariant(cluster, checks)
    return checks


def _diurnal_sweep(cluster: SimCluster, n_actors: int,
                   rate: float) -> list:
    """A virtual day for the tiering autopilot, closed loop.  The sim's
    volume actors have no rung state, so the storage tier is modeled
    HERE around the real production planner: per-vid cumulative read
    counters (heartbeat telemetry shape) feed a real ``TieringPlanner``
    at announce cadence, and a modeled mover (copy+verify delay, then
    commit) applies rung transitions.  Working set A is sealed and
    carries the day traffic; it must ride the full ladder down
    (hot -> EC -> cloud) overnight and climb back (cloud -> EC -> hot)
    at dawn.  A steady-warm sealed set B and the writable background
    volumes must never move, a scripted telemetry-silence window must
    pause planning outright, and the whole day costs zero failed
    client ops."""
    from seaweedfs_tpu_torch.storage.tiering import (RUNG_CLOUD, RUNG_EC,
                                               RUNG_HOT, TieringPlanner)

    ladder = (RUNG_HOT, RUNG_EC, RUNG_CLOUD)
    day_end, night_end, duration = 14.0, 40.0, 60.0
    sil_start, sil_end = 16.0, 22.5    # telemetry goes dark overnight
    move_bytes = 64 << 20              # modeled .dat size per move
    n_vids = cluster.n_vids
    set_a = tuple(range(0, 6))         # diurnal set (sealed)
    # the steady set is kept small so its per-vid rate (30% of load
    # over 3 vids) sits far above the cool band — at 16 actors a
    # 6-vid steady set leaves each vid thin enough that an honest
    # multi-bin traffic lull reads as genuine cooling
    set_b = tuple(range(6, 9))         # steady-warm set (sealed)
    bg = tuple(range(9, n_vids))       # writable background
    sealed = set(set_a) | set(set_b)

    # thresholds scale with the offered per-vid hot rate so the same
    # EWMA half-life walks the bands at any actor count
    hot_rate = 0.6 * rate / len(set_a)
    planner = TieringPlanner(
        window_s=5.0, ewma_alpha=0.5,
        cool_max=0.15 * hot_rate, cold_max=0.013 * hot_rate,
        heat_min=0.5 * hot_rate, min_age_s=8.0, cooldown_s=6.0,
        max_moves_per_plan=len(set_a), cloud_enabled=True)

    rung = {vid: RUNG_HOT for vid in range(n_vids)}
    has_shards = {vid: False for vid in range(n_vids)}
    reads_cum = {vid: 0 for vid in range(n_vids)}
    moves_log: list = []
    planned_in_silence: list = []
    last_obs = [0.0]
    seq = [0]

    def a_is_hot(now: float) -> bool:
        return now < day_end or now >= night_end

    def dispatch(op) -> None:
        # 60% of traffic follows the diurnal set (sleeping on the
        # background volumes overnight), 30% holds set B steady-warm,
        # the rest trickles over the writable background.  The split
        # mixes a dispatch counter into the hash so it is uniform
        # per-op (zipf keys alone are too concentrated to warm every
        # vid of a set), and stays a pure function of the seed.
        h = ((op.key * 1103515245 + 12345)
             ^ (seq[0] * 2654435761)) & 0x7FFFFFFF
        seq[0] += 1
        r, base = h % 10, h // 10
        now = cluster.kernel.now
        if r < 6 and a_is_hot(now):
            vid = set_a[base % len(set_a)]
        elif 6 <= r < 9:
            vid = set_b[base % len(set_b)]
        else:
            vid = bg[base % len(bg)]
        op.key = base * n_vids + vid   # FilerActor routes key % n_vids
        reads_cum[vid] += 1
        cluster._start_op(cluster.filers[base % len(cluster.filers)], op)

    wl = ZipfWorkload(default_tenants(4, rate), seed=cluster.kernel.seed)
    for op in wl.generate(duration):
        cluster.kernel.schedule(op.t, dispatch, op)

    def mover(move):
        yield 1.0  # modeled stream + verify-before-delete readback
        vid = move["vid"]
        rung[vid] = move["to"]
        if move["to"] == RUNG_EC:
            has_shards[vid] = True  # encode keeps shards alongside
        elif move["to"] == RUNG_HOT:
            has_shards[vid] = False
        planner.note_committed(vid, now=cluster.kernel.now)
        moves_log.append((cluster.kernel.now, move))
        cluster.kernel.note("incident", "tier_move",
                            f"vid={vid} {move['from']}->{move['to']}")

    def control_loop():
        # the master's heartbeat-ingest cadence: every 2s one modeled
        # volume server reports cumulative reads + rung state, then
        # the planner gets one shot
        while cluster.kernel.now < duration:
            yield 2.0
            now = cluster.kernel.now
            if not (sil_start <= now < sil_end):
                planner.observe("vs-sim", {"volumes": {
                    vid: {"reads": reads_cum[vid], "rung": rung[vid],
                          "size": move_bytes,
                          "read_only": vid in sealed,
                          "has_ec_shards": has_shards[vid]}
                    for vid in range(n_vids)}}, now=now)
                last_obs[0] = now
            plan = planner.plan(now=now)
            if plan is None:
                continue
            if now - last_obs[0] > planner.window_s:
                planned_in_silence.append(now)  # must stay empty
                continue
            for m in plan["moves"]:
                cluster.kernel.spawn(mover(m))

    cluster.kernel.spawn(control_loop())
    cluster.run(duration)
    _settle(cluster, wl, duration, 10.0)
    cluster.run(duration + 12.0)

    checks: list = []
    _common_invariants(cluster, checks)
    checks.append(_check(
        "zero_failed_client_requests", cluster.metrics.fail_total == 0,
        f"{cluster.metrics.fail_total} failed ops "
        f"(samples: {cluster.metrics.fail_samples[:3]})"
        if cluster.metrics.fail_total else
        f"all {cluster.metrics.ops_total()} ops succeeded across "
        f"{len(moves_log)} tier move(s)"))
    by_vid: dict = {}
    for t, m in moves_log:
        by_vid.setdefault(m["vid"], []).append((t, m))
    reached_cloud = [v for v in set_a
                     if any(m["to"] == RUNG_CLOUD
                            for _, m in by_vid.get(v, []))]
    checks.append(_check(
        "cooled_set_reached_cloud", len(reached_cloud) == len(set_a),
        f"{len(reached_cloud)}/{len(set_a)} diurnal vids demoted to "
        f"the cloud rung overnight"))
    back_hot = [v for v in set_a if rung[v] == RUNG_HOT]
    checks.append(_check(
        "reheated_set_promoted_home", len(back_hot) == len(set_a),
        f"{len(back_hot)}/{len(set_a)} diurnal vids back on the hot "
        f"rung at dusk (end rungs: "
        f"{sorted(set(rung[v] for v in set_a))})"))
    strays = sorted(set(by_vid) - set(set_a))
    checks.append(_check(
        "only_diurnal_set_moved", not strays,
        f"steady-warm + writable volumes untouched "
        f"({len(moves_log)} moves, all within the diurnal set)"
        if not strays else f"unexpected moves for vids {strays}"))
    ping_pong = []
    for v, seq in by_vid.items():
        demoting = [ladder.index(m["to"]) > ladder.index(m["from"])
                    for _, m in seq]
        # a day is one descent then one climb: any demotion after the
        # first promotion is thrash
        first_promo = demoting.index(False) if False in demoting \
            else len(demoting)
        if len(seq) > 4 or any(demoting[first_promo:]):
            ping_pong.append(v)
    checks.append(_check(
        "no_ping_pong", not ping_pong,
        "each vid descends then climbs at most once "
        f"({max((len(s) for s in by_vid.values()), default=0)} moves "
        "max per vid)" if not ping_pong
        else f"thrashing vids {ping_pong}"))
    checks.append(_check(
        "silence_paused_planner",
        not planned_in_silence and planner.paused_on_silence > 0,
        f"planner held {planner.paused_on_silence} plan tick(s) "
        f"through the {sil_end - sil_start:.1f}s telemetry-dark window"
        if not planned_in_silence else
        f"plans fired on stale telemetry at t={planned_in_silence}"))
    _tenant_invariant(cluster, checks)
    _breaker_invariant(cluster, checks)
    return checks


INCIDENTS = {
    "az_loss": _az_loss,
    "rolling_restart": _rolling_restart,
    "herd_repair": _herd_repair,
    "tenant_flood": _tenant_flood,
    "partition_heal_mid_repair": _partition_heal_mid_repair,
    "hot_shard_migration": _hot_shard_migration,
    "diurnal_sweep": _diurnal_sweep,
    "ec_single_shard_loss": _ec_single_shard_loss,
    "master_failover_mid_write": _master_failover_mid_write,
    "master_failover_mid_repair": _master_failover_mid_repair,
}


def run_incident(name: str, seed: int = 0, n_actors: int = 100,
                 n_filers: int = 4, rate: float = 0.0) -> dict:
    """Run one scripted incident; returns the JSON-able report.
    ``rate`` 0 auto-sizes offered load to ~2.4 ops/s per actor."""
    if name not in INCIDENTS:
        raise KeyError(f"unknown incident {name!r} "
                       f"(have {sorted(INCIDENTS)})")
    if rate <= 0:
        rate = 2.4 * n_actors
    cluster = SimCluster(n_volume_actors=n_actors, n_filers=n_filers,
                         seed=seed)
    checks = INCIDENTS[name](cluster, n_actors, rate)
    report = cluster.report()
    report.update({
        "incident": name, "seed": seed, "actors": n_actors,
        "invariants": checks,
        "passed": all(c["ok"] for c in checks),
    })
    return report
