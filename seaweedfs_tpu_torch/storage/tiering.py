"""Temperature-driven tiering autopilot.

The cluster measures temperature everywhere (hot-key sketches, the
per-(class,tenant) ledger, RED p99s); this module is the piece that
ACTS on it. A master-side ``TieringPlanner`` consumes per-volume read
counters piggybacked on heartbeats (the same diff-cumulative-reports
shape as ``filer/rebalance.py``) and drives a three-rung lifecycle:

    rung         storage                     transition out
    ----         -------                     --------------
    hot          replicated local .dat       temp <= cool_max -> ec
    ec           EC shards (+ local .dat)    temp <= cold_max -> cloud
                                             temp >= heat_min -> hot
    cloud        .dat on the S3 tier seam    temp >= heat_min -> ec/hot

Temperature is a windowed read-rate blended through an EWMA.
Hysteresis comes from the band gap: demotion thresholds
(``cool_max`` > ``cold_max``) sit well below the promotion threshold
(``heat_min``), so a volume oscillating between bands never ping-pongs
— it must genuinely re-heat to climb back. Every move is additionally
gated by per-volume cooldown, a minimum observed age, and a per-plan
cap, and the planner pauses outright on telemetry silence (a member
that stops reporting means "don't plan", not "cold cluster").

The planner is pure bookkeeping; the ``TierMover`` executes plans as
BACKGROUND-classed, token-bucketed jobs, one move at a time, through
the volume servers' admin endpoints. ``demote_volume`` /
``promote_volume`` are THE entry points for rung transitions; call
them inside a ``class_scope(BACKGROUND)`` block, because an
interactive-classed tier move would ride the latency-sensitive QoS lane
with a multi-GB upload.

The port's copy of seaweedfs_tpu/storage/tiering.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional

from seaweedfs_tpu_torch.qos import BACKGROUND, class_scope
from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.utils.httpd import http_json
from seaweedfs_tpu_torch.utils.limiter import TokenBucket

RUNG_HOT = "hot"
RUNG_EC = "ec"
RUNG_CLOUD = "cloud"

# demotion order; promotion walks it backwards
_LADDER = (RUNG_HOT, RUNG_EC, RUNG_CLOUD)


def demote_volume(url: str, vid: int, to_rung: str,
                  endpoint: str = "", bucket: str = "",
                  timeout: float = 600.0) -> dict:
    """One rung down on one server: hot->ec EC-encodes in place,
    ec/hot->cloud moves the .dat to the S3 tier (verified demotion —
    the volume server deletes local bytes only after readback).
    BACKGROUND-classed callers only."""
    if to_rung == RUNG_EC:
        out = http_json("POST", f"http://{url}/admin/ec/generate",
                        {"volume_id": vid}, timeout=timeout)
        # mount what generate wrote: the rung is read off MOUNTED
        # shards (tiering_report), so an unmounted demotion would
        # look like "still hot" and the planner would refire forever.
        # The mount scan skips shard ids the code family didn't emit.
        from seaweedfs_tpu_torch.storage.erasure_coding import layout
        http_json("POST", f"http://{url}/admin/ec/mount",
                  {"volume_id": vid,
                   "shard_ids": list(range(layout.TOTAL_SHARDS_COUNT))},
                  timeout=timeout)
        return out
    return http_json("POST", f"http://{url}/admin/tier/demote",
                     {"volume_id": vid, "endpoint": endpoint,
                      "bucket": bucket}, timeout=timeout)


def promote_volume(url: str, vid: int, from_rung: str,
                   timeout: float = 600.0) -> dict:
    """One rung up on one server: cloud->local fetches + verifies +
    reopens the .dat, ec->hot decodes shards back to a plain volume.
    BACKGROUND-classed callers only."""
    if from_rung == RUNG_CLOUD:
        return http_json("POST", f"http://{url}/admin/tier/promote",
                         {"volume_id": vid}, timeout=timeout)
    return http_json("POST", f"http://{url}/admin/ec/to_volume",
                     {"volume_id": vid}, timeout=timeout)


class TieringPlanner:
    """Decides which volumes change rungs. Feed it per-server
    cumulative read counters + rung state via ``observe()`` (heartbeat
    cadence); ask for work via ``plan()``. All state is in-memory on
    the master — a failover restarts observation, which only delays
    moves (safe)."""

    def __init__(self, window_s: float = 60.0, ewma_alpha: float = 0.4,
                 cool_max: float = 0.5, cold_max: float = 0.05,
                 heat_min: float = 2.0, min_age_s: float = 120.0,
                 cooldown_s: float = 300.0, max_moves_per_plan: int = 2,
                 cloud_enabled: bool = True,
                 stale_after_s: Optional[float] = None):
        self.window_s = window_s
        self.ewma_alpha = ewma_alpha
        # short silence (one window) pauses planning; long silence
        # (stale_after_s) forgets the member/replica entirely — a
        # decommissioned server or a migrated-away replica must not
        # pause the autopilot or gate temperature() forever
        self.stale_after_s = (10 * window_s if stale_after_s is None
                              else stale_after_s)
        self.cool_max = cool_max
        self.cold_max = cold_max
        self.heat_min = heat_min
        self.min_age_s = min_age_s
        self.cooldown_s = cooldown_s
        self.max_moves_per_plan = max_moves_per_plan
        self.cloud_enabled = cloud_enabled
        # (url, vid) -> deque[(t, cumulative_reads)]
        self._samples: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=64))
        self._ewma: dict = {}            # (url, vid) -> smoothed reads/s
        self._meta: dict = {}            # vid -> {rung, size, read_only,
        #                                          urls, first_seen}
        self._members: dict = {}         # url -> last report time
        self._moved: dict = {}           # vid -> "moving" | commit time
        self.plans = 0
        self.paused_on_silence = 0

    # ---- observation ----
    def observe(self, url: str, report: Optional[dict],
                now: Optional[float] = None) -> None:
        """Ingest one server's tiering report:
        ``{"volumes": {vid: {"reads": cumulative, "rung": str,
        "size": bytes, "read_only": bool}}}``. Counters are cumulative
        — the planner diffs successive samples, so a restarted server
        (counter reset) clamps to zero rather than going negative."""
        if not report:
            return
        now = clockctl.monotonic() if now is None else now
        self._members[url] = now
        horizon = now - 2 * self.window_s
        for vid_key, v in (report.get("volumes") or {}).items():
            vid = int(vid_key)
            key = (url, vid)
            dq = self._samples[key]
            dq.append((now, float(v.get("reads", 0))))
            while dq and dq[0][0] < horizon:
                dq.popleft()
            meta = self._meta.get(vid)
            if meta is None:
                meta = {"first_seen": now, "urls": []}
                self._meta[vid] = meta
            meta["rung"] = v.get("rung", RUNG_HOT)
            meta["size"] = int(v.get("size", 0))
            meta["read_only"] = bool(v.get("read_only", False))
            meta["has_ec_shards"] = bool(v.get("has_ec_shards", False))
            if url not in meta["urls"]:
                meta["urls"].append(url)
            # advance the EWMA here, at heartbeat cadence — this is
            # the ONLY place it mutates, so temperature()/status()
            # polls cannot change the smoothing dynamics
            raw = self._rate(key, now)
            if raw is not None:
                prev = self._ewma.get(key)
                self._ewma[key] = raw if prev is None else (
                    self.ewma_alpha * raw + (1 - self.ewma_alpha) * prev)
        self._prune(now)

    def _prune(self, now: float) -> None:
        """Forget members and per-volume replicas that have been dark
        longer than stale_after_s (distinct from the short-silence
        planning pause): a decommissioned server must not hold
        _silent() true forever, and a replica that migrated away must
        not keep its volume unplannable via a never-refreshed
        (url, vid) sample key."""
        horizon = now - self.stale_after_s
        for url, last in list(self._members.items()):
            if last < horizon:
                del self._members[url]
        for key in list(self._samples):
            dq = self._samples[key]
            if dq and dq[-1][0] >= horizon:
                continue
            del self._samples[key]
            self._ewma.pop(key, None)
            url, vid = key
            meta = self._meta.get(vid)
            if meta is not None and url in meta["urls"]:
                meta["urls"].remove(url)
        for vid, meta in list(self._meta.items()):
            if not meta["urls"]:
                del self._meta[vid]
                self._moved.pop(vid, None)

    def _rate(self, key, now: float) -> Optional[float]:
        """Windowed reads/s for one (url, vid), or None without two
        in-window samples — insufficient telemetry must gate planning,
        not read as zero load."""
        dq = self._samples.get(key)
        if not dq:
            return None
        lo = next(((t, c) for t, c in dq if t >= now - self.window_s),
                  None)
        hi = dq[-1]
        if lo is None or hi[0] <= lo[0]:
            return None
        # counter-reset clamp: a restarted server restarts at zero
        return max(0.0, (hi[1] - lo[1]) / (hi[0] - lo[0]))

    def temperature(self, vid: int,
                    now: Optional[float] = None) -> Optional[float]:
        """EWMA-smoothed aggregate reads/s across the volume's
        replicas. None when any replica lacks an in-window rate.
        Pure read of the observe()-maintained EWMA — safe to poll
        from status()/tools without perturbing planning."""
        now = clockctl.monotonic() if now is None else now
        meta = self._meta.get(vid)
        if meta is None:
            return None
        total = 0.0
        for url in meta["urls"]:
            key = (url, vid)
            raw = self._rate(key, now)
            if raw is None:
                return None
            total += self._ewma.get(key, raw)
        return total

    # ---- planning ----
    def _silent(self, now: float) -> bool:
        """True when any known member hasn't reported within the
        window — planning on partial telemetry would read a dark
        server's volumes as ice-cold and demote its hot data."""
        return any(now - last > self.window_s
                   for last in self._members.values())

    def _movable(self, vid: int, now: float) -> bool:
        state = self._moved.get(vid)
        if state == "moving":
            return False
        if state is not None and now - state < self.cooldown_s:
            return False
        meta = self._meta[vid]
        return now - meta["first_seen"] >= self.min_age_s

    def plan(self, now: Optional[float] = None) -> Optional[dict]:
        """A batch of rung transitions, or None when there is nothing
        safe to do. Demotions need a sealed volume below the band;
        promotions need a cold volume above heat_min."""
        now = clockctl.monotonic() if now is None else now
        self._prune(now)
        if not self._members:
            return None
        if self._silent(now):
            self.paused_on_silence += 1
            return None
        temps = {}
        moves = []
        for vid, meta in sorted(self._meta.items()):
            temp = self.temperature(vid, now)
            if temp is None:
                continue
            temps[vid] = temp
            if len(moves) >= self.max_moves_per_plan \
                    or not self._movable(vid, now):
                continue
            rung = meta.get("rung", RUNG_HOT)
            to_rung = None
            if rung == RUNG_HOT and meta.get("read_only") \
                    and temp <= self.cool_max:
                # straight to cloud only from the bottom of the band:
                # a merely-cooling volume earns the EC rung first
                if temp <= self.cold_max and self.cloud_enabled:
                    to_rung = RUNG_CLOUD
                else:
                    to_rung = RUNG_EC
            elif rung == RUNG_EC:
                if temp >= self.heat_min:
                    to_rung = RUNG_HOT
                elif temp <= self.cold_max and self.cloud_enabled:
                    to_rung = RUNG_CLOUD
            elif rung == RUNG_CLOUD and temp >= self.heat_min:
                to_rung = RUNG_EC if self._was_ec(vid) else RUNG_HOT
            if to_rung is None:
                continue
            moves.append({"vid": vid, "from": rung, "to": to_rung,
                          "urls": list(meta["urls"]), "temp": temp,
                          "size": meta.get("size", 0)})
            self._moved[vid] = "moving"
        if not moves:
            return None
        self.plans += 1
        return {"moves": moves, "temps": temps}

    def _was_ec(self, vid: int) -> bool:
        """A promoted cloud volume lands back where it came from: on
        the EC rung if shards still exist locally (the volume server
        reports that), else straight to hot."""
        return bool(self._meta.get(vid, {}).get("has_ec_shards"))

    # ---- commit bookkeeping ----
    def note_committed(self, vid: int,
                       now: Optional[float] = None) -> None:
        self._moved[vid] = clockctl.monotonic() if now is None else now

    def note_failed(self, vid: int) -> None:
        self._moved.pop(vid, None)

    def status(self, now: Optional[float] = None) -> dict:
        now = clockctl.monotonic() if now is None else now
        vols = {}
        rungs = collections.Counter()
        for vid, meta in self._meta.items():
            rung = meta.get("rung", RUNG_HOT)
            rungs[rung] += 1
            vols[vid] = {"rung": rung, "size": meta.get("size", 0),
                         "read_only": meta.get("read_only", False),
                         "temp": self.temperature(vid, now),
                         "urls": list(meta["urls"]),
                         "moved": self._moved.get(vid)}
        return {"volumes": vols,
                "rungs": dict(rungs),
                "bands": {"cool_max": self.cool_max,
                          "cold_max": self.cold_max,
                          "heat_min": self.heat_min},
                "members": len(self._members),
                "silent": self._silent(now) if self._members else True,
                "plans": self.plans,
                "paused_on_silence": self.paused_on_silence}


class TierMover:
    """Executes one plan at a time: sequential rung transitions in a
    named daemon thread, BACKGROUND-classed end to end, paced by a
    byte token bucket so a burst of demotions cannot saturate the
    network the interactive lane shares."""

    def __init__(self, planner: TieringPlanner, endpoint: str = "",
                 bucket: str = "tier",
                 rate_bytes_per_sec: float = 64 * 1024 * 1024,
                 on_event: Optional[Callable] = None):
        self.planner = planner
        self.endpoint = endpoint
        self.bucket = bucket
        self.bandwidth = TokenBucket(rate_bytes_per_sec)
        self.on_event = on_event
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._state: dict = {"state": "idle", "move": None, "error": None,
                             "moves_done": 0, "moves_failed": 0,
                             "bytes_demoted": 0, "bytes_promoted": 0}

    @property
    def busy(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self, plan: dict) -> bool:
        with self._lock:
            if self.busy:
                return False
            self._thread = threading.Thread(
                target=self._run, args=(plan,), daemon=True,
                name="tier-mover")
            self._thread.start()
            return True

    def _run(self, plan: dict) -> None:
        with class_scope(BACKGROUND):
            for move in plan["moves"]:
                self._state.update(state="moving", move=move, error=None)
                try:
                    self._execute(move)
                except Exception as e:
                    self._state.update(state="failed", error=str(e))
                    self._state["moves_failed"] += 1
                    self.planner.note_failed(move["vid"])
                    continue
                self._state["moves_done"] += 1
                self.planner.note_committed(move["vid"])
                if self.on_event is not None:
                    self.on_event(move)
            if self._state["state"] == "moving":
                self._state.update(state="idle", move=None)

    def _execute(self, move: dict) -> None:
        vid, to_rung, from_rung = move["vid"], move["to"], move["from"]
        self.bandwidth.consume(max(move.get("size", 0), 1))
        demoting = _LADDER.index(to_rung) > _LADDER.index(from_rung)
        # every replica transitions; cloud demotions are safe to fan
        # out because each volume server uploads to a node-unique
        # object key (replica .dat files compact independently and
        # need not be byte-identical)
        for url in move["urls"]:
            if demoting:
                demote_volume(url, vid, to_rung,
                              endpoint=self.endpoint, bucket=self.bucket)
            else:
                promote_volume(url, vid, from_rung)
        counter = "bytes_demoted" if demoting else "bytes_promoted"
        self._state[counter] += move.get("size", 0) * len(move["urls"])

    def status(self) -> dict:
        out = dict(self._state)
        out["busy"] = self.busy
        out["endpoint"] = self.endpoint
        out["bucket"] = self.bucket
        return out
