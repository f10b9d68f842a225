"""Actor state machines for the macro simulation.

Three actor kinds mirror the real processes:

  VolumeActor   stores replicated volumes, admits work through a REAL
                QosGovernor (adaptive limit, class caps, tenant
                buckets), coordinates replica fan-out for writes,
                serves repair pulls, heartbeats the master, and
                supports crash / restore / graceful drain.
  FilerActor    runs client operations: volume lookup (cached), replica
                ranking and failover through a REAL PeerHealth breaker
                registry, shed-aware retries with jittered backoff.
  MasterActor   liveness from heartbeats (same pulse/timeout ratio as
                the real master), volume layout + assign exclusion for
                draining nodes, and a repair queue with the real
                queue's semantics: degraded-scan grace, drain grace,
                pacing (bounded streams x per-stream bandwidth),
                pressure-aware deferral and failure backoff.

The Transport is the in-memory loopback network: every call consults
the FaultScheduler for the (src, dst) link and races a timeout against
delivery, so blackholes cost the caller its full timeout exactly like
a real dead TCP peer.  All randomness (latency jitter, backoff jitter)
comes from the kernel's seeded RNG — the single-threaded event order
makes every run a pure function of (seed, config, schedule).

The port's copy of seaweedfs_tpu/sim/actors.py. It imports nothing of that
package.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from seaweedfs_tpu_torch.qos.classes import BACKGROUND
from seaweedfs_tpu_torch.qos.governor import QosGovernor
from seaweedfs_tpu_torch.sim.kernel import Future, SimError, SimKernel, SimShed
from seaweedfs_tpu_torch.utils.resilience import PeerHealth

PULSE = 2.0                 # heartbeat period, matches server.PULSE_SECONDS
DEAD_AFTER = PULSE * 5      # liveness timeout, matches topology prune
SIM_LEASE_TTL = 30.0        # matches server.master LEASE_TTL_S
SIM_LEASE_SAFETY = 3.0      # matches volume_server LEASE_MINT_SAFETY_S


class SimResource:
    """FIFO counted resource (the actor's 'disk'): bounded concurrent
    service, excess waits in arrival order.  This is what turns offered
    load into queueing delay the AdaptiveLimiter can observe."""

    def __init__(self, kernel: SimKernel, capacity: int):
        self.kernel = kernel
        self.capacity = capacity
        self.in_use = 0
        self._waiters: deque[Future] = deque()

    def acquire(self) -> Future:
        fut = Future()
        if self.in_use < self.capacity:
            self.in_use += 1
            self.kernel.resolve(fut, True)
        else:
            self._waiters.append(fut)
        return fut

    def release(self) -> None:
        if self._waiters:
            self.kernel.resolve(self._waiters.popleft(), True)
        else:
            self.in_use -= 1


class Transport:
    """In-memory loopback network with per-link scripted faults."""

    def __init__(self, kernel: SimKernel, faults=None,
                 base_latency: float = 0.0005, jitter: float = 0.0005):
        self.kernel = kernel
        self.faults = faults
        self.base_latency = base_latency
        self.jitter = jitter
        self.actors: dict = {}

    def register(self, actor) -> None:
        self.actors[actor.name] = actor

    def call(self, src: str, dst: str, op: str, body=None,
             timeout: float = 1.0) -> Future:
        k = self.kernel
        fut = Future()
        # the timeout always races delivery; first resolution wins
        k.schedule(timeout, k.resolve, fut, None,
                   SimError(f"timeout {src}->{dst} {op}"))
        mode, extra, status = (self.faults.decide(src, dst)
                               if self.faults is not None else (None, 0.0, 0))
        if mode == "blackhole":
            return fut  # only the timeout will ever fire
        lat = self.base_latency + extra + k.rng.random() * self.jitter
        if mode == "reset":
            k.schedule(lat, k.resolve, fut, None,
                       SimError(f"reset {src}->{dst}"))
            return fut
        if mode == "http_error":
            k.schedule(lat, k.resolve, fut, None,
                       SimError(f"http {status} {dst}"))
            return fut
        k.schedule(lat, self._deliver, src, dst, op, body, fut)
        return fut

    def _deliver(self, src, dst, op, body, fut) -> None:
        actor = self.actors.get(dst)
        if actor is None or actor.crashed:
            self.kernel.resolve(fut, None, SimError(f"refused {dst}"))
            return
        reply = self.kernel.spawn(actor.handle(op, body, src))
        self.kernel.spawn(self._reply_chain(actor, actor.epoch, reply, fut))

    def _reply_chain(self, actor, epoch, reply_fut, caller_fut):
        val = exc = None
        try:
            val = yield reply_fut
        except GeneratorExit:
            raise  # kernel/GC closing us mid-wait: don't yield again
        except BaseException as e:  # noqa: BLE001 - forwarded to caller
            exc = e
        yield self.base_latency
        if actor.crashed or actor.epoch != epoch:
            # the serving process died before the response hit the wire
            val, exc = None, SimError(f"reset {actor.name}")
        self.kernel.resolve(caller_fut, val, exc)


class VolumeActor:
    def __init__(self, name: str, az: int, sim, disk_slots: int = 4,
                 base_volume_bytes: int = 8 * 1024 * 1024):
        self.name = name
        self.az = az
        self.sim = sim
        self.kernel: SimKernel = sim.kernel
        self.crashed = False
        self.draining = False
        self.epoch = 0
        # assign lease from the master's heartbeat-reply grant
        # ({"epoch": term, "expires_at": t}); in-memory only, so a
        # restart loses it until the next heartbeat re-grants
        self.lease: Optional[dict] = None
        self.active = 0               # in-flight client/replica requests
        self.base_volume_bytes = base_volume_bytes
        self.volumes: dict[int, dict] = {}   # vid -> {key: version}
        self.gov = QosGovernor(enabled=True, initial_limit=16,
                               min_limit=4, max_limit=64)
        self.peers = PeerHealth(failure_threshold=3, open_for=2.0)
        self.disk = SimResource(self.kernel, disk_slots)

    # -- lifecycle --
    def start(self) -> None:
        self.kernel.spawn(self._hb_loop())

    def crash(self) -> None:
        self.crashed = True
        self.kernel.note(self.name, "crash")

    def restore(self) -> None:
        """Process restart: disk (volumes dict) survives, connections
        and the heartbeat loop do not."""
        self.crashed = False
        self.draining = False
        self.epoch += 1
        self.lease = None  # leases are process memory, not disk
        self.kernel.note(self.name, "restore")
        self.start()

    def drain(self):
        """Graceful stop: announce draining, finish in-flight work,
        flush, send the final heartbeat, then go dark."""
        self.draining = True
        self.kernel.note(self.name, "drain_begin")
        yield self._hb(final=False)
        waited = 0.0
        while self.active > 0 and waited < 10.0:
            yield 0.02
            waited += 0.02
        yield self._hb(final=True)
        self.crashed = True
        self.kernel.note(self.name, "drain_done")

    # -- heartbeats --
    def _hb(self, final: bool = False) -> Future:
        return self.sim.transport.call(
            self.name, "master", "heartbeat",
            {"draining": self.draining, "final": final,
             "pressure": round(self.gov.pressure(), 4),
             "vids": sorted(self.volumes)},
            timeout=1.0)

    def _hb_loop(self):
        epoch = self.epoch
        while not self.crashed and self.epoch == epoch:
            try:
                r = yield self._hb()
                lease = (r or {}).get("lease")
                if lease is not None and (
                        self.lease is None
                        or lease["epoch"] >= self.lease["epoch"]):
                    # grant/renewal piggybacked on the reply; a stale
                    # leader's lower-epoch grant never wins
                    self.lease = lease
            except (SimError, SimShed):
                pass  # missed pulse; the master's timeout does the rest
            yield PULSE

    # -- service --
    def handle(self, op, body, src):
        if self.crashed:
            raise SimError(f"refused {self.name}")
        if op == "repair_pull":
            # background repair source: admission-governed so repair
            # yields to foreground load (pressure pacing)
            grant = self.gov.admit(BACKGROUND, tenant="repair")
            if not grant.ok:
                raise SimShed(grant.retry_after, "repair")
            try:
                vid = body["vid"]
                data = dict(self.volumes.get(vid, {}))
                nbytes = self.base_volume_bytes + len(data) * body.get(
                    "avg_obj_bytes", 16 * 1024)
                yield 0.002
                return {"data": data, "bytes": nbytes}
            finally:
                grant.release()
        if op == "lease_assign":
            # local fid mint from the heartbeat-granted lease — the
            # sim twin of /admin/lease_assign. Expiry discipline uses
            # the same safety margin as the real holder; a refusal
            # sends the filer to the next holder or the master.
            yield 0.0002
            l = self.lease
            if (self.draining or l is None
                    or l["expires_at"] - self.kernel.now
                    <= SIM_LEASE_SAFETY):
                raise SimError(f"no lease {self.name}")
            return {"ok": True, "epoch": l["epoch"]}
        if op == "repair_install":
            vid = body["vid"]
            merged = self.volumes.setdefault(vid, {})
            for key, ver in body["data"].items():
                if merged.get(key, -1) < ver:
                    merged[key] = ver
            yield 0.002
            return {"ok": True}
        if op not in ("read", "write", "scan", "replicate"):
            raise SimError(f"bad op {op}")
        if self.draining and op != "replicate" and src.startswith("filer"):
            # draining: no NEW client work; in-flight finishes below
            raise SimError(f"draining {self.name}")
        grant = self.gov.admit(body["class"], tenant=body.get("tenant"))
        if not grant.ok:
            raise SimShed(grant.retry_after)
        self.active += 1
        try:
            yield self.disk.acquire()
            try:
                svc = (0.002 + body.get("size", 0) / 2e8
                       + self.kernel.rng.random() * 0.002)
                if op == "scan":
                    svc *= 12.0  # batch needle scan, not a point read
                yield svc
            finally:
                self.disk.release()
            if op == "read" or op == "scan":
                vid = body["vid"]
                return {"version": self.volumes.get(vid, {}).get(
                    body["key"])}
            # write / replicate: store, replicate if coordinating
            vid, key, ver = body["vid"], body["key"], body["version"]
            vol = self.volumes.setdefault(vid, {})
            if vol.get(key, -1) < ver:
                vol[key] = ver
            if op == "replicate":
                return {"ok": True}
            legs = []
            peers = []
            for h in body["holders"]:
                if h == self.name:
                    continue
                if not self.peers.allow(h):
                    continue
                peers.append(h)
                legs.append(self.sim.transport.call(
                    self.name, h, "replicate",
                    {"vid": vid, "key": key, "version": ver,
                     "class": body["class"], "size": body.get("size", 0)},
                    timeout=0.8))
            if legs:
                yield legs
            acks = 1
            for h, leg in zip(peers, legs):
                ok = leg.exc is None
                self.peers.record(h, ok)
                if ok:
                    acks += 1
            if acks < 2:
                raise SimError(f"replica quorum {acks}/2 vid={vid}")
            return {"ok": True, "acks": acks}
        finally:
            self.active -= 1
            grant.release()


class FilerActor:
    LOOKUP_TTL = 5.0

    def __init__(self, name: str, sim):
        self.name = name
        self.sim = sim
        self.kernel: SimKernel = sim.kernel
        self.crashed = False
        self.draining = False
        self.epoch = 0
        self.peers = PeerHealth(failure_threshold=3, open_for=2.0)
        self._layout: dict[int, list] = {}
        self._layout_at: dict[int, float] = {}

    def handle(self, op, body, src):  # pragma: no cover - filers serve none
        raise SimError("filer has no server ops in the sim")
        yield  # generator marker

    # -- client operation driver (spawned per arrival) --
    def run_op(self, op):
        k = self.kernel
        t0 = k.now
        err = ""
        success = False
        for attempt in range(4):
            try:
                if op.kind == "write":
                    yield from self._write(op)
                else:
                    yield from self._read(op)
                success = True
                break
            except SimShed as e:
                err = str(e)
                self.sim.metrics.note_shed(op.tenant)
                yield (min(1.0, e.retry_after)
                       * (0.75 + 0.5 * k.rng.random()))
            except SimError as e:
                err = str(e)
                yield (0.05 * (2 ** attempt)
                       * (0.5 + 0.5 * k.rng.random()))
        self.sim.metrics.note_op(op, success, k.now - t0, err)

    def _holders(self, vid: int):
        k = self.kernel
        if (vid in self._layout
                and k.now - self._layout_at.get(vid, -1e9) < self.LOOKUP_TTL):
            return self._layout[vid]
        try:
            r = yield self.sim.transport.call(
                self.name, "master", "lookup", {"vid": vid}, timeout=0.5)
        except (SimError, SimShed):
            if vid in self._layout:
                # stale-while-revalidate, the real wdclient's cache
                # contract: a dark master must not fail ops whose
                # layout we already know. Re-arm the clock so the
                # outage isn't re-probed on every single op.
                self._layout_at[vid] = k.now
                return self._layout[vid]
            raise
        self._layout[vid] = r["holders"]
        self._layout_at[vid] = k.now
        return r["holders"]

    def _assign(self, vid: int, holders: list):
        """The fid mint for one write: any leased holder mints locally
        (the sim twin of wdclient.assign_from_lease), the master's
        /dir/assign is the fallback. With leases off every write pays
        — and during a leader outage loses — the master round trip."""
        if self.sim.assign_leases:
            ranked = self.peers.rank(holders)
            for i, h in enumerate(ranked):
                if not self.peers.allow(h) and i < len(ranked) - 1:
                    continue
                try:
                    yield self.sim.transport.call(
                        self.name, h, "lease_assign", {"vid": vid},
                        timeout=0.5)
                except (SimError, SimShed):
                    continue
                self.sim.metrics.lease_mints += 1
                return
        yield self.sim.transport.call(
            self.name, "master", "assign_fid", {"vid": vid}, timeout=0.5)
        self.sim.metrics.master_assigns += 1

    def _read(self, op):
        vid = op.key % self.sim.n_vids
        holders = yield from self._holders(vid)
        ranked = self.peers.rank(holders)
        last: Optional[BaseException] = None
        for i, h in enumerate(ranked):
            sole = i == len(ranked) - 1 and last is None
            if not self.peers.allow(h) and not sole:
                continue
            t0 = self.kernel.now
            try:
                yield self.sim.transport.call(
                    self.name, h, op.kind,
                    {"vid": vid, "key": op.key, "class": op.klass,
                     "tenant": op.tenant},
                    timeout=0.6)
            except SimShed:
                # server alive and explicitly pushing back: not a
                # breaker failure; honor Retry-After upstream
                self.peers.record(h, True)
                raise
            except SimError as e:
                self.peers.record(h, False)
                last = e
                continue
            self.peers.record(h, True, self.kernel.now - t0)
            # piggyback half-open probes on real traffic, the same
            # trick hedging plays in utils/resilience.py: an open
            # breaker that ranks behind healthy replicas would
            # otherwise never be dialed again and never re-close
            for other in ranked:
                if other != h and self.peers.breaker(other).probe_ripe() \
                        and self.peers.allow(other):
                    self.kernel.spawn(self._probe(other, vid, op))
            return
        self._layout.pop(vid, None)  # maybe stale after repair
        raise last if last is not None else SimError(f"no holders vid={vid}")

    def _probe(self, peer, vid, op):
        """Breaker probe riding on (a copy of) real traffic; outcome
        feeds the breaker, never the client metrics."""
        t0 = self.kernel.now
        try:
            yield self.sim.transport.call(
                self.name, peer, "read",
                {"vid": vid, "key": op.key, "class": BACKGROUND,
                 "tenant": op.tenant},
                timeout=0.6)
        except SimShed:
            self.peers.record(peer, True)  # alive, just busy
        except SimError:
            self.peers.record(peer, False)
        else:
            self.peers.record(peer, True, self.kernel.now - t0)

    def _write(self, op):
        vid = op.key % self.sim.n_vids
        holders = yield from self._holders(vid)
        yield from self._assign(vid, holders)
        version = self.sim.metrics.next_version()
        ranked = self.peers.rank(holders)
        last: Optional[BaseException] = None
        for i, h in enumerate(ranked):
            sole = i == len(ranked) - 1 and last is None
            if not self.peers.allow(h) and not sole:
                continue
            t0 = self.kernel.now
            try:
                yield self.sim.transport.call(
                    self.name, h, "write",
                    {"vid": vid, "key": op.key, "version": version,
                     "size": op.size, "class": op.klass,
                     "tenant": op.tenant, "holders": holders},
                    timeout=1.0)
            except SimShed:
                self.peers.record(h, True)
                raise
            except SimError as e:
                self.peers.record(h, False)
                last = e
                continue
            self.peers.record(h, True, self.kernel.now - t0)
            self.sim.metrics.note_ack(op.key, version, vid)
            return
        self._layout.pop(vid, None)
        raise last if last is not None else SimError(f"no holders vid={vid}")


class MasterActor:
    """Liveness, layout, assign exclusion and the paced repair queue."""

    name = "master"

    def __init__(self, sim, replication: int = 3,
                 repair_grace_s: float = 5.0, drain_grace_s: float = 45.0,
                 max_repair_streams: int = 6,
                 repair_stream_bw: float = 16e6):
        self.sim = sim
        self.kernel: SimKernel = sim.kernel
        self.crashed = False
        self.draining = False
        self.epoch = 0
        # Raft modeling: the actor is "the master service", not one
        # process. leaderless=True is the election window after a
        # leader crash — leader-only ops (heartbeats, assign_fid,
        # repair control) refuse, while lookups keep flowing because
        # any follower serves them from replicated topology. term is
        # bumped on takeover(); lease grants are stamped with it, so
        # a stale leader's grants lose to the new term's.
        self.leaderless = False
        self.term = 1
        self.replication = replication
        self.repair_grace_s = repair_grace_s
        self.drain_grace_s = drain_grace_s
        self.max_repair_streams = max_repair_streams
        self.repair_stream_bw = repair_stream_bw
        self.nodes: dict[str, dict] = {}
        self.layout: dict[int, list] = {}
        self.dead: set = set()
        self.drain_grace_until: dict[str, float] = {}
        self._degraded_since: dict[int, float] = {}
        self._queue: deque = deque()
        self._queued: set = set()
        self._active: set = set()
        self.repair_active_max = 0
        self.repairs_done = 0
        self.repair_enqueued_for: dict[str, int] = {}
        # vid -> completed-rebuild count: the mid-repair failover
        # invariant reads this (no vid rebuilt twice across terms)
        self.repair_log: dict[int, int] = {}
        self.converged_at: Optional[float] = None

    def start(self) -> None:
        self.kernel.spawn(self._control_loop())

    def fail_leader(self) -> None:
        """The leader process dies. Its in-flight repair streams die
        with it (epoch bump aborts them at their next yield); every
        leader-only RPC refuses until takeover()."""
        self.leaderless = True
        self.epoch += 1
        self.kernel.note("master", "leader_fail", f"term={self.term}")

    def register(self, node: str, az: int) -> None:
        self.nodes[node] = {"last_seen": 0.0, "draining": False,
                            "pressure": 0.0, "az": az}

    # -- rpc --
    def handle(self, op, body, src):
        yield 0.0002  # request parse/dispatch cost
        if self.leaderless and op != "lookup":
            # election window: no leader to process heartbeats or
            # mint fids — but any follower serves lookups from the
            # replicated topology, so reads never notice
            raise SimError("no raft leader")
        if op == "heartbeat":
            st = self.nodes.get(src)
            if st is None:
                raise SimError(f"unknown node {src}")
            st["last_seen"] = self.kernel.now
            st["draining"] = bool(body.get("draining"))
            st["pressure"] = float(body.get("pressure", 0.0))
            if body.get("final"):
                # the drain farewell: hold repair fire for this node's
                # volumes for a planned-maintenance grace window
                self.drain_grace_until[src] = (self.kernel.now
                                               + self.drain_grace_s)
                self.kernel.note("master", "drain_grace", src)
            elif src in self.dead or src in self.drain_grace_until:
                self.dead.discard(src)
                self.drain_grace_until.pop(src, None)
                self.kernel.note("master", "rejoin", src)
            reply = {"ok": True}
            if self.sim.assign_leases and not st["draining"] \
                    and not body.get("final"):
                # grant/renew the assign lease on the reply piggyback,
                # epoch-stamped with the current term; the 15x
                # TTL/pulse ratio means a leader outage shorter than
                # the TTL never interrupts local minting
                reply["lease"] = {"epoch": self.term,
                                  "expires_at": (self.kernel.now
                                                 + SIM_LEASE_TTL)}
            return reply
        if op == "lookup":
            holders = self.layout.get(body["vid"])
            if holders is None:
                raise SimError(f"unknown vid {body['vid']}")
            return {"holders": list(holders)}
        if op == "assign":
            # writable targets: live, not draining (the drain satellite
            # contract: a draining node takes no new assignments)
            live = [n for n in sorted(self.nodes)
                    if self._fresh(n) and not self.nodes[n]["draining"]]
            if not live:
                raise SimError("no writable nodes")
            return {"nodes": live}
        if op == "assign_fid":
            # the /dir/assign fallback lane: a plain leader round trip
            # (refused outright while the leader is down — exactly the
            # outage the lease lane exists to ride out)
            return {"ok": True, "term": self.term}
        raise SimError(f"bad master op {op}")

    # -- leader failover --
    def takeover(self) -> None:
        """A follower wins the election. Raft-replicated state (node
        registry, volume layout, lease grants — all ride the log)
        survives into the new term; leader-local repair bookkeeping
        (queue, active wave, degraded-scan clocks) does not — the new
        leader re-derives it from its own degraded scan, which is how
        the real RepairQueue refills after failover. Liveness clocks
        restart so the outage itself can't declare the fleet dead."""
        self.leaderless = False
        self.epoch += 1
        self.term += 1
        now = self.kernel.now
        for st in self.nodes.values():
            st["last_seen"] = now
        self._queue.clear()
        self._queued.clear()
        self._active.clear()
        self._degraded_since.clear()
        self.converged_at = None
        self.kernel.note("master", "takeover", f"term={self.term}")

    # -- liveness helpers --
    def _fresh(self, node: str) -> bool:
        st = self.nodes.get(node)
        return (st is not None and node not in self.dead
                and self.kernel.now - st["last_seen"] <= DEAD_AFTER)

    def _counts_as_present(self, node: str) -> bool:
        """For repair accounting: a node inside its drain grace window
        is 'present' — its copies are coming back, don't rebuild them."""
        if self._fresh(node):
            return True
        until = self.drain_grace_until.get(node)
        return until is not None and self.kernel.now < until

    # -- control loop: liveness, degraded scan, repair dispatch --
    def _control_loop(self):
        while True:
            yield PULSE
            if self.crashed or self.leaderless:
                continue  # no leader: no scans, no dispatch
            now = self.kernel.now
            for node in sorted(self.nodes):
                if node in self.dead or self._counts_as_present(node):
                    continue
                self.dead.add(node)
                self.kernel.note("master", "declare_dead", node)
            self._scan(now)
            self._dispatch()
            if (not self._queue and not self._active
                    and not self._degraded_since
                    and self.converged_at is None and self.repairs_done):
                self.converged_at = now
                self.kernel.note("master", "repair_converged",
                                 str(self.repairs_done))

    def _scan(self, now: float) -> None:
        """Degraded-volume scan with continuous-grace semantics: a vid
        must stay under-replicated for repair_grace_s before it is
        queued (same rule as scrub/repair_queue.py's scan grace)."""
        for vid in sorted(self.layout):
            holders = self.layout[vid]
            present = [h for h in holders if self._counts_as_present(h)]
            if len(present) >= self.replication:
                self._degraded_since.pop(vid, None)
                continue
            since = self._degraded_since.setdefault(vid, now)
            if now - since < self.repair_grace_s:
                continue
            if vid in self._queued or vid in self._active:
                continue
            missing = [h for h in holders
                       if not self._counts_as_present(h)]
            for h in missing:
                self.repair_enqueued_for[h] = \
                    self.repair_enqueued_for.get(h, 0) + 1
            self._queue.append(vid)
            self._queued.add(vid)
            self.converged_at = None
            self.kernel.note("master", "repair_enqueue",
                             f"{vid}:{','.join(missing)}")

    def _dispatch(self) -> None:
        while self._queue and len(self._active) < self.max_repair_streams:
            vid = self._queue.popleft()
            self._queued.discard(vid)
            self._active.add(vid)
            self.repair_active_max = max(self.repair_active_max,
                                         len(self._active))
            self.kernel.spawn(self._repair_task(vid))

    def _repair_task(self, vid: int):
        # A repair stream belongs to the leader incarnation that
        # dispatched it: after a takeover the new leader rebuilds its
        # own wave, so a stale task finishing would double-rebuild the
        # vid. Check the epoch after every yield and abort silently.
        epoch0 = self.epoch
        try:
            holders = self.layout[vid]
            sources = sorted((h for h in holders if self._fresh(h)),
                             key=lambda h: (self.nodes[h]["pressure"], h))
            held = set(holders)
            targets = [n for n in sorted(self.nodes)
                       if self._fresh(n) and n not in held
                       and not self.nodes[n]["draining"]]
            targets.sort(key=lambda n: sum(
                1 for hs in self.layout.values() if n in hs))
            if not sources or not targets:
                raise SimError(f"no source/target vid={vid}")
            source, target = sources[0], targets[0]
            r = yield self.sim.transport.call(
                "master", source, "repair_pull", {"vid": vid}, timeout=5.0)
            if self.crashed or self.epoch != epoch0:
                return
            # paced stream: bytes over the per-stream bandwidth share
            yield r["bytes"] / self.repair_stream_bw
            if self.crashed or self.epoch != epoch0:
                return
            yield self.sim.transport.call(
                "master", target, "repair_install",
                {"vid": vid, "data": r["data"]}, timeout=5.0)
            if self.crashed or self.epoch != epoch0:
                return
            dead_holders = [h for h in holders
                            if not self._counts_as_present(h)]
            new = [h for h in holders if h != dead_holders[0]] \
                if dead_holders else list(holders)
            new.append(target)
            self.layout[vid] = new
            self.repairs_done += 1
            self.repair_log[vid] = self.repair_log.get(vid, 0) + 1
            self.kernel.note("master", "repair_done", f"{vid}->{target}")
        except SimShed as e:
            # source shed us (foreground pressure): back off politely
            yield min(2.0, e.retry_after) + self.kernel.rng.random() * 0.2
            if not self.crashed and self.epoch == epoch0:
                self._requeue(vid)
        except SimError:
            yield 0.5 + self.kernel.rng.random() * 0.5
            if not self.crashed and self.epoch == epoch0:
                self._requeue(vid)
        finally:
            self._active.discard(vid)

    def _requeue(self, vid: int) -> None:
        if vid not in self._queued:
            self._queue.append(vid)
            self._queued.add(vid)
