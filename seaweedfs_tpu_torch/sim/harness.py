"""SimCluster: wire kernel + transport + actors into a runnable fleet.

Construction is deterministic: actors are named ``vol-0..N-1`` and
``filer-0..M-1``, spread round-robin over ``n_az`` availability zones,
and every volume id is placed on ``replication`` holders in DISTINCT
zones (so a whole-AZ incident can never take out all copies — the same
rack-awareness contract the real placement aims for).  The workload is
pre-materialized (sim/workload.py) and scheduled up front; incident
actions (crash / restore / drain an actor or a zone) are scheduled the
same way, so the entire run is decided before the first event fires.

The port's copy of seaweedfs_tpu/sim/harness.py. It imports nothing of that
package.
"""

from __future__ import annotations

from typing import Optional

from seaweedfs_tpu_torch.qos.classes import CLASSES
from seaweedfs_tpu_torch.sim.actors import (FilerActor, MasterActor, Transport,
                                      VolumeActor)
from seaweedfs_tpu_torch.sim.faults import FaultScheduler, parse_schedule
from seaweedfs_tpu_torch.sim.kernel import SimKernel
from seaweedfs_tpu_torch.stats.slo import SloEvaluator
from seaweedfs_tpu_torch.utils.resilience import CLOSED

# Compressed SLO objectives for the sim: incidents run ~40 virtual
# seconds, so production's 5m/1h burn windows shrink to 6s/15s.
# Latency targets bracket the sim's service times (interactive reads
# complete in ~5ms healthy; a 60ms grey-failure band or crash-failover
# backoff pushes them well past 50ms), so a scripted incident flips
# ops to "bad" deterministically and a healed fleet flips them back.
SIM_SLO_OBJECTIVES = {
    "interactive": {"latency_s": 0.05, "goal": 0.99},
    "write": {"latency_s": 0.15, "goal": 0.99},
    "background": {"latency_s": 1.0, "goal": 0.99},
}
SIM_FAST_WINDOW_S = 6.0
SIM_SLOW_WINDOW_S = 15.0
SIM_SLO_TICK_S = 1.0


def percentile(xs: list, q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


class SimMetrics:
    """Client-side accounting: the invariant checkers read this."""

    def __init__(self):
        self.lat = {c: [] for c in CLASSES}
        self.tenants: dict[str, list] = {}   # name -> [ok, fail]
        self.sheds: dict[str, int] = {}      # tenant -> shed retries seen
        self.fail_total = 0
        self.fail_samples: list[str] = []
        # assign-lane split: fids minted from a holder's lease vs
        # round trips to the master's assign_fid fallback
        self.lease_mints = 0
        self.master_assigns = 0
        self.acked: dict[int, tuple] = {}    # key -> (version, vid)
        self._ver = 0
        # cumulative per-class [total, bad] for the SLO burn evaluator
        # (bad = failed, or slower than the class's sim latency target)
        self.slo_counts = {c: [0, 0] for c in CLASSES}

    def next_version(self) -> int:
        self._ver += 1
        return self._ver

    def note_ack(self, key: int, version: int, vid: int) -> None:
        cur = self.acked.get(key)
        if cur is None or version > cur[0]:
            self.acked[key] = (version, vid)

    def note_shed(self, tenant: str) -> None:
        self.sheds[tenant] = self.sheds.get(tenant, 0) + 1

    def note_op(self, op, success: bool, lat: float, err: str) -> None:
        t = self.tenants.setdefault(op.tenant, [0, 0])
        if success:
            t[0] += 1
            self.lat[op.klass].append(lat)
        else:
            t[1] += 1
            self.fail_total += 1
            if len(self.fail_samples) < 20:
                self.fail_samples.append(f"{op.tenant}/{op.kind}: {err}")
        sc = self.slo_counts[op.klass]
        sc[0] += 1
        target = SIM_SLO_OBJECTIVES.get(op.klass, {}).get("latency_s", 1.0)
        if not success or lat > target:
            sc[1] += 1

    def ops_total(self) -> int:
        return sum(ok + fail for ok, fail in self.tenants.values())

    def summary(self) -> dict:
        return {
            "ops": self.ops_total(),
            "failed": self.fail_total,
            "acked_writes": len(self.acked),
            "latency_ms": {
                c: {"p50": round(percentile(self.lat[c], 0.50) * 1000, 2),
                    "p99": round(percentile(self.lat[c], 0.99) * 1000, 2),
                    "n": len(self.lat[c])}
                for c in CLASSES},
            "tenants": {t: {"ok": v[0], "fail": v[1]}
                        for t, v in sorted(self.tenants.items())},
            "sheds": dict(sorted(self.sheds.items())),
            "assign": {"leased": self.lease_mints,
                       "master": self.master_assigns},
            "fail_samples": list(self.fail_samples),
        }


class SimCluster:
    def __init__(self, n_volume_actors: int = 100, n_filers: int = 4,
                 n_az: int = 4, seed: int = 0, vids_per_node: int = 2,
                 replication: int = 3, schedule=None,
                 repair_grace_s: float = 5.0, drain_grace_s: float = 45.0,
                 max_repair_streams: int = 6,
                 repair_stream_bw: float = 16e6,
                 assign_leases: bool = True):
        if n_az < replication:
            raise ValueError("need n_az >= replication for AZ-disjoint "
                             "placement")
        self.kernel = SimKernel(seed)
        events = parse_schedule(schedule) if schedule is not None else []
        self.faults = FaultScheduler(events, lambda: self.kernel.now)
        self.transport = Transport(self.kernel, self.faults)
        self.metrics = SimMetrics()
        self.n_az = n_az
        self.n_vids = n_volume_actors * vids_per_node
        self.replication = replication
        # comparator toggle: False routes every write's fid assignment
        # through the master (the pre-lease protocol)
        self.assign_leases = assign_leases

        self.master = MasterActor(
            self, replication=replication, repair_grace_s=repair_grace_s,
            drain_grace_s=drain_grace_s,
            max_repair_streams=max_repair_streams,
            repair_stream_bw=repair_stream_bw)
        self.transport.register(self.master)

        self.volumes: list[VolumeActor] = []
        by_az: dict[int, list] = {}
        for i in range(n_volume_actors):
            actor = VolumeActor(f"vol-{i}", az=i % n_az, sim=self)
            self.volumes.append(actor)
            self.transport.register(actor)
            self.master.register(actor.name, actor.az)
            by_az.setdefault(actor.az, []).append(actor.name)

        azs = sorted(by_az)
        for vid in range(self.n_vids):
            holders = []
            for j in range(replication):
                group = by_az[azs[(vid + j) % len(azs)]]
                holders.append(group[(vid // len(azs)) % len(group)])
            self.master.layout[vid] = holders
            for h in holders:
                self.actor(h).volumes.setdefault(vid, {})

        self.filers: list[FilerActor] = []
        for i in range(n_filers):
            filer = FilerActor(f"filer-{i}", self)
            self.filers.append(filer)
            self.transport.register(filer)

        self.master.start()
        for actor in self.volumes:
            actor.start()

        # SLO burn-rate judge: a 1s virtual ticker feeds cumulative
        # per-class totals and evaluates; alert transitions land in the
        # kernel log, so the alert timeline is part of log_hash (same
        # seed => same firing/resolution instants)
        self.slo = SloEvaluator(
            objectives=SIM_SLO_OBJECTIVES,
            fast_window_s=SIM_FAST_WINDOW_S,
            slow_window_s=SIM_SLOW_WINDOW_S,
            on_transition=self._note_slo_transition)
        self.kernel.spawn(self._slo_ticker())

    def _note_slo_transition(self, t, cls, old, new, detail) -> None:
        self.kernel.note("slo", f"{cls}:{old}->{new}", detail)

    def _slo_ticker(self):
        while True:
            for c in CLASSES:
                total, bad = self.metrics.slo_counts[c]
                self.slo.feed(self.kernel.now, c, total, bad)
            self.slo.evaluate(self.kernel.now)
            yield SIM_SLO_TICK_S

    # -- topology access --
    def actor(self, name: str) -> VolumeActor:
        return self.transport.actors[name]

    def az_nodes(self, az: int) -> list[str]:
        return [v.name for v in self.volumes if v.az == az]

    # -- incident actions (schedule with at()) --
    def at(self, t: float, fn, *args) -> None:
        self.kernel.schedule(t - self.kernel.now, fn, *args)

    def crash(self, name: str) -> None:
        self.actor(name).crash()

    def crash_az(self, az: int) -> None:
        self.kernel.note("incident", "crash_az", str(az))
        for name in self.az_nodes(az):
            self.crash(name)

    def restore(self, name: str) -> None:
        self.actor(name).restore()

    def drain(self, name: str) -> None:
        self.kernel.spawn(self.actor(name).drain())

    def fail_master_leader(self, outage_s: float) -> None:
        """Raft leader loss: leader-only master functions go dark for
        ``outage_s`` (the election window), then a follower takes over
        with the replicated state and a bumped term. Holders keep
        minting from their epoch-stamped leases the whole time."""
        self.kernel.note("incident", "master_leader_fail", f"{outage_s}")
        self.master.fail_leader()
        self.kernel.schedule(outage_s, self.master.takeover)

    # -- workload --
    def load(self, ops) -> None:
        for i, op in enumerate(ops):
            filer = self.filers[i % len(self.filers)]
            self.kernel.schedule(op.t, self._start_op, filer, op)

    def _start_op(self, filer: FilerActor, op) -> None:
        self.kernel.spawn(filer.run_op(op))

    def run(self, until: float) -> None:
        self.kernel.run_until(until)

    def run_until_converged(self, deadline: float,
                            step: float = 2.0) -> Optional[float]:
        """Advance until the master declares repair convergence (or the
        deadline); returns the convergence time if reached."""
        while (self.master.converged_at is None
               and self.kernel.now < deadline):
            self.run(min(deadline, self.kernel.now + step))
        return self.master.converged_at

    # -- invariant primitives --
    def lost_acked_writes(self) -> list:
        """Every acked write must be readable from some live replica
        (same or newer version — overwrites are fine)."""
        lost = []
        for key in sorted(self.metrics.acked):
            version, vid = self.metrics.acked[key]
            holders = self.master.layout.get(vid, [])
            if not any((not self.actor(h).crashed
                        and self.actor(h).volumes.get(vid, {})
                        .get(key, -1) >= version)
                       for h in holders):
                lost.append((key, version, vid))
        return lost

    def open_breakers(self) -> list:
        """(filer, peer, state) for every filer breaker that is not
        closed against a currently-live node."""
        bad = []
        for filer in self.filers:
            for url, snap in filer.peers.snapshot().items():
                peer = self.transport.actors.get(url)
                if peer is None or peer.crashed:
                    continue
                if snap["state"] != CLOSED:
                    bad.append((filer.name, url, snap["state"]))
        return bad

    def degraded_vids(self) -> list:
        out = []
        for vid in sorted(self.master.layout):
            live = [h for h in self.master.layout[vid]
                    if not self.actor(h).crashed]
            if len(live) < self.replication:
                out.append(vid)
        return out

    # -- reporting --
    def _run_hash(self) -> str:
        """Reproducibility digest: the kernel's incident-event log
        PLUS the client-observable outcome (metrics summary). The
        second part matters for incidents with no topology events —
        tenant_flood crashes nothing, so its kernel log is empty and
        the hash would otherwise be the empty-string constant."""
        import hashlib
        import json
        h = hashlib.sha256(self.kernel.log_hash().encode())
        h.update(json.dumps(self.metrics.summary(),
                            sort_keys=True).encode())
        h.update(str(self.kernel.events_processed).encode())
        return h.hexdigest()

    def report(self) -> dict:
        m = self.master
        return {
            "virtual_s": round(self.kernel.now, 3),
            "events": self.kernel.events_processed,
            "log_hash": self._run_hash(),
            "slo": {
                "timeline": [[round(t, 3), cls, old, new]
                             for t, cls, old, new in self.slo.timeline()],
                "firing": self.slo.firing(),
            },
            "client": self.metrics.summary(),
            "repair": {
                "done": m.repairs_done,
                "active_max": m.repair_active_max,
                "queued": len(m._queue),
                "converged_at": m.converged_at,
                "enqueued_for": dict(sorted(
                    m.repair_enqueued_for.items())),
            },
            "dead_nodes": sorted(m.dead),
        }
