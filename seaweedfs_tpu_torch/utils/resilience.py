"""Shared resilience layer for every inter-node hop.

Four cooperating pieces (reference: the Go SeaweedFS leans on grpc
deadlines + util/retry.go; the policies here follow the standard
distributed-systems playbook):

- ``Deadline``: a remaining-time budget minted once at the request edge
  (HTTP handler, shell command, bench harness) and PROPAGATED through
  nested calls via the ``X-Weed-Deadline`` header, replacing hardcoded
  per-call timeouts. A nested call gets ``min(remaining, cap)`` as its
  socket timeout, so the sum of retries/hops can never exceed what the
  caller is still willing to wait (the gRPC deadline-propagation model).

- ``RetryPolicy``: exponential backoff with FULL jitter
  (``sleep = uniform(0, min(cap, base * 2**attempt))``, the AWS
  architecture-blog result: full jitter desynchronizes retry herds
  better than equal/decorrelated jitter) plus a per-destination retry
  BUDGET (the Finagle/SRE-book rule: each fresh call earns a fraction
  of a retry token, each retry spends one, so retries are bounded to
  ~ratio of traffic and cannot amplify an outage into a storm).

- ``CircuitBreaker``: per-peer closed -> open -> half-open probing on
  consecutive failures, with an EWMA latency estimate and a sliding
  latency window for p95 — the health score callers rank peers by.

- ``hedged()``: tail-tolerant fan-out for idempotent reads (Dean &
  Barroso, "The Tail at Scale"): fire the best candidate, and if it
  hasn't answered within an adaptive delay (the primary's observed
  p95), fire the next-healthiest; first success wins, losers are
  abandoned. Open circuits are skipped unless no other holder exists.

Pure stdlib plus utils.tracing (itself stdlib-only, below us in the
import DAG); imports nothing from the HTTP plane so httpd.py can use
``DeadlineExceeded`` without a cycle. Retries and hedge outcomes
annotate the ambient trace span when one is active.

The port's copy of seaweedfs_tpu/utils/resilience.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Iterable, Optional, Sequence

from seaweedfs_tpu_torch.utils import headers
from seaweedfs_tpu_torch.utils import clockctl, tracing

DEADLINE_HEADER = headers.DEADLINE  # remaining seconds, decimal string


def _now() -> float:
    """Behavioral clock: wall monotonic in production, a test's virtual
    clock when one is installed (utils/clockctl.py) — breaker open
    windows, deadlines and retry sleeps all elapse on it."""
    return clockctl.monotonic()

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

# Process-wide breaker-open listeners: fn(peer_key) runs when any
# PeerHealth-tracked breaker transitions closed/half-open -> open.
# httpd's connection pool registers here to evict the dead peer's idle
# keep-alive sockets (they ride the same host the breaker just
# declared down). Hooks must be cheap and never raise.
_BREAKER_OPEN_HOOKS: list = []


def on_breaker_open(fn) -> None:
    _BREAKER_OPEN_HOOKS.append(fn)


class DeadlineExceeded(ConnectionError):
    """A call's time budget ran out before (or while) it was made.

    Subclasses ConnectionError on purpose: every existing
    ``except ConnectionError`` fail-over/fallback branch treats an
    exhausted deadline like any other transport failure."""


class Deadline:
    """Absolute point on the monotonic clock; all math is 'remaining'."""

    __slots__ = ("_at",)

    def __init__(self, at_monotonic: float):
        self._at = float(at_monotonic)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(_now() + max(0.0, float(seconds)))

    def remaining(self) -> float:
        return max(0.0, self._at - _now())

    def expired(self) -> bool:
        return _now() >= self._at

    def timeout(self, cap: Optional[float] = None) -> float:
        """Socket timeout for one nested call: min(remaining, cap).
        Raises DeadlineExceeded when the budget is already gone, so
        callers fail fast instead of dialing with a 0s timeout."""
        rem = self.remaining()
        if rem <= 0.0:
            raise DeadlineExceeded("deadline exceeded")
        return rem if cap is None else min(rem, float(cap))

    def sub(self, seconds: float) -> "Deadline":
        """A child deadline capped at `seconds` from now — for a step
        that must leave budget for the caller's fallback (e.g. a direct
        remote fetch must not starve degraded reconstruction)."""
        return Deadline(min(self._at, _now() + float(seconds)))

    def header_value(self) -> str:
        return f"{self.remaining():.3f}"

    @classmethod
    def from_headers(cls, headers,
                     default: Optional[float] = None) -> Optional["Deadline"]:
        """Parse a propagated deadline off an incoming request; fall
        back to a fresh `default`-second budget (None -> no deadline)."""
        raw = headers.get(DEADLINE_HEADER) if headers is not None else None
        if raw:
            try:
                return cls.after(float(raw))
            except (TypeError, ValueError):
                pass
        return cls.after(default) if default is not None else None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(remaining={self.remaining():.3f}s)"


# The ambient deadline: set once at the request edge, read by every
# nested hop without threading a parameter through each signature.
# contextvars do not cross thread boundaries on their own; pool fan-out
# sites capture current_deadline() and re-enter deadline_scope() in the
# worker (see Store._recover_one_interval).
_current_deadline: contextvars.ContextVar[Optional[Deadline]] = \
    contextvars.ContextVar("seaweedfs_tpu_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    return _current_deadline.get()


@contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    token = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(token)


class RetryPolicy:
    """Exponential backoff, full jitter, per-destination retry budget.

    Budget semantics (Finagle's RetryBudget): every fresh call to a
    destination deposits ``budget_ratio`` of a token; every retry
    withdraws a whole one. A destination serving healthy traffic
    accrues headroom for the occasional retry; a destination that is
    DOWN stops earning deposits, the balance drains, and retries stop —
    the herd cannot multiply load on an outage."""

    def __init__(self, attempts: int = 3, base: float = 0.1,
                 cap: float = 2.0, budget_ratio: float = 0.1,
                 budget_min: float = 10.0):
        self.attempts = max(1, int(attempts))
        self.base = float(base)
        self.cap = float(cap)
        self.budget_ratio = float(budget_ratio)
        self.budget_min = float(budget_min)
        self._budget: dict[str, float] = {}
        self._lock = threading.Lock()

    def backoff(self, attempt: int) -> float:
        """Full jitter: uniform(0, min(cap, base * 2**attempt))."""
        return random.uniform(
            0.0, min(self.cap, self.base * (2.0 ** max(0, attempt))))

    def record_call(self, dest: str = "") -> None:
        with self._lock:
            tokens = self._budget.get(dest, self.budget_min)
            self._budget[dest] = min(2.0 * self.budget_min,
                                     tokens + self.budget_ratio)

    def allow_retry(self, dest: str = "") -> bool:
        with self._lock:
            tokens = self._budget.get(dest, self.budget_min)
            if tokens < 1.0:
                return False
            self._budget[dest] = tokens - 1.0
            return True

    def budget_remaining(self, dest: str = "") -> float:
        with self._lock:
            return self._budget.get(dest, self.budget_min)

    def call(self, fn: Callable[[], object], dest: str = "",
             deadline: Optional[Deadline] = None,
             retry_on: tuple = (ConnectionError,)):
        """Run fn() with up to `attempts` tries. Sleeps are jittered and
        never overrun the deadline; an exhausted budget stops retrying
        immediately (the whole point)."""
        last: Optional[BaseException] = None
        for attempt in range(self.attempts):
            self.record_call(dest)
            try:
                return fn()
            except retry_on as e:
                last = e
                # cross-reference the retry storm in the trace: the
                # ambient span (if any) ends up carrying the highest
                # attempt number reached and the destination
                tracing.annotate("retry.failed_attempt", attempt + 1)
                if dest:
                    tracing.annotate("retry.dest", dest)
                if isinstance(e, DeadlineExceeded):
                    raise
                if attempt + 1 >= self.attempts \
                        or not self.allow_retry(dest):
                    raise
                delay = self.backoff(attempt)
                # a shed response (429/503 from a limiter) carries the
                # server's own pacing hint — obey it instead of our
                # jitter, so retries land after the load has drained
                ra = getattr(e, "retry_after", None)
                if ra is not None:
                    delay = max(0.0, float(ra))
                if deadline is not None \
                        and delay >= deadline.remaining():
                    # never sleep into (or retry inside) a budget that
                    # cannot fit the server-requested wait
                    raise
                clockctl.sleep(delay)
        raise last  # pragma: no cover - loop always returns/raises


class CircuitBreaker:
    """Per-peer closed/open/half-open breaker + latency health.

    - `failure_threshold` CONSECUTIVE failures trip closed -> open.
    - After `open_for` seconds an open breaker admits `half_open_max`
      probe calls (allow() does the transition); one probe success
      closes it, a probe failure re-opens with a fresh clock.
    - Every successful call feeds an EWMA latency and a sliding window
      the p95 hedge delay is computed from; both stay fresh from
      ordinary traffic and heartbeats alike."""

    WINDOW = 64

    def __init__(self, failure_threshold: int = 5, open_for: float = 5.0,
                 half_open_max: int = 1, ewma_alpha: float = 0.3):
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_for = float(open_for)
        self.half_open_max = max(1, int(half_open_max))
        self.ewma_alpha = float(ewma_alpha)
        self.state = CLOSED
        self.ewma_s: Optional[float] = None
        self.success_total = 0
        self.failure_total = 0
        self.opened_total = 0
        self.last_ok_at = 0.0
        self.last_fail_at = 0.0
        self._consec_failures = 0
        self._opened_at = 0.0
        self._probes = 0
        self._window: deque[float] = deque(maxlen=self.WINDOW)
        self._lock = threading.Lock()

    # -- admission --
    def allow(self) -> bool:
        """May this peer be dialed right now? Transitions open ->
        half-open once `open_for` has elapsed and meters the probes."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if _now() - self._opened_at < self.open_for:
                    return False
                self.state = HALF_OPEN
                self._probes = 0
            # HALF_OPEN: meter the probe slots
            if self._probes < self.half_open_max:
                self._probes += 1
                return True
            return False

    def probe_ripe(self) -> bool:
        """True when the breaker is open and due a half-open probe —
        hedging piggybacks a probe on real traffic (no separate pinger)."""
        with self._lock:
            if self.state == HALF_OPEN:
                return self._probes < self.half_open_max
            return (self.state == OPEN
                    and _now() - self._opened_at >= self.open_for)

    # -- outcomes --
    def record(self, ok: bool, latency_s: Optional[float] = None) -> None:
        with self._lock:
            if ok:
                self.success_total += 1
                self.last_ok_at = _now()
                self._consec_failures = 0
                if self.state != CLOSED:
                    self.state = CLOSED
                    self._probes = 0
                if latency_s is not None:
                    lat = max(0.0, float(latency_s))
                    self._window.append(lat)
                    self.ewma_s = lat if self.ewma_s is None else \
                        (self.ewma_alpha * lat
                         + (1.0 - self.ewma_alpha) * self.ewma_s)
                return
            self.failure_total += 1
            self.last_fail_at = _now()
            self._consec_failures += 1
            if self.state == HALF_OPEN \
                    or (self.state == CLOSED
                        and self._consec_failures >= self.failure_threshold):
                self.state = OPEN
                self._opened_at = _now()
                self.opened_total += 1
                self._probes = 0
            elif self.state == OPEN:
                # a failed ripe probe (or a forced dial on a sole
                # holder) re-arms the open window — the peer proved it
                # is still down, so back off for another `open_for`
                self._opened_at = _now()

    # -- health --
    def p95_s(self) -> Optional[float]:
        with self._lock:
            if not self._window:
                return None
            ordered = sorted(self._window)
            return ordered[min(len(ordered) - 1,
                               int(0.95 * len(ordered)))]

    def score(self) -> float:
        """Lower is healthier. EWMA latency, penalized by breaker state
        so rankings prefer closed < half-open < open; unknown peers get
        a neutral prior so they are tried before known-slow ones but
        after known-fast ones."""
        with self._lock:
            base = self.ewma_s if self.ewma_s is not None else 0.020
            if self.state == CLOSED:
                return base
            if self.state == HALF_OPEN:
                return 10.0 + base
            return 100.0 + base

    def snapshot(self) -> dict:
        with self._lock:
            now = _now()
            return {
                "state": self.state,
                "ewma_ms": (round(self.ewma_s * 1000, 2)
                            if self.ewma_s is not None else None),
                "consecutive_failures": self._consec_failures,
                "success_total": self.success_total,
                "failure_total": self.failure_total,
                "opened_total": self.opened_total,
                "last_ok_s_ago": (round(now - self.last_ok_at, 1)
                                  if self.last_ok_at else None),
                "last_fail_s_ago": (round(now - self.last_fail_at, 1)
                                    if self.last_fail_at else None),
            }


class PeerHealth:
    """Registry of per-peer breakers + the ranking/hedging policy knobs.

    One instance per server process (each volume server, the master,
    clients that want it); peers are keyed by 'ip:port'. Breaker
    parameters are plain attributes so tests and operators can tighten
    them without growing constructor signatures everywhere."""

    def __init__(self, metrics=None, failure_threshold: int = 5,
                 open_for: float = 5.0,
                 hedge_default_s: float = 0.05,
                 hedge_min_s: float = 0.005, hedge_max_s: float = 0.5):
        self.failure_threshold = failure_threshold
        self.open_for = open_for
        self.hedge_default_s = hedge_default_s
        self.hedge_min_s = hedge_min_s
        self.hedge_max_s = hedge_max_s
        self._peers: dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()
        if metrics is not None:
            self._c_outcomes = metrics.counter(
                "resilience", "peer_calls_total",
                "per-peer call outcomes", ("result",))
            self._c_hedges = metrics.counter(
                "resilience", "hedges_total",
                "hedged backup requests", ("outcome",))
            self._g_state = metrics.gauge(
                "resilience", "breakers", "breakers per state", ("state",))
            metrics.on_expose(self._refresh_gauges)
        else:
            self._c_outcomes = self._c_hedges = self._g_state = None

    def _refresh_gauges(self) -> None:
        counts = {CLOSED: 0, OPEN: 0, HALF_OPEN: 0}
        with self._lock:
            for br in self._peers.values():
                counts[br.state] = counts.get(br.state, 0) + 1
        for state, n in counts.items():
            self._g_state.set(state, value=n)

    def breaker(self, url: str) -> CircuitBreaker:
        with self._lock:
            br = self._peers.get(url)
            if br is None:
                br = CircuitBreaker(
                    failure_threshold=self.failure_threshold,
                    open_for=self.open_for)
                self._peers[url] = br
            return br

    def allow(self, url: str) -> bool:
        return self.breaker(url).allow()

    def record(self, url: str, ok: bool,
               latency_s: Optional[float] = None) -> None:
        br = self.breaker(url)
        was_open = br.state == OPEN
        br.record(ok, latency_s)
        if not ok and br.state == OPEN and not was_open:
            for fn in _BREAKER_OPEN_HOOKS:
                try:
                    fn(url)
                except Exception:
                    pass
        if self._c_outcomes is not None:
            self._c_outcomes.inc("ok" if ok else "error")

    def count_hedge(self, outcome: str) -> None:
        if self._c_hedges is not None:
            self._c_hedges.inc(outcome)

    def rank(self, urls: Iterable[str],
             pressure: Optional[dict] = None) -> list[str]:
        """Healthiest first: closed before half-open before open (open
        circuits sort last — 'skipped unless no other holder exists'),
        ties broken by the EWMA-latency score. Passive: no probe slots
        are consumed here; allow() happens at dial time.

        `pressure` ({url: qos_pressure [0,1]} from heartbeats) breaks
        ties among SIMILARLY healthy peers: latency is quantized into
        20ms buckets so a few ms of EWMA noise can't override a holder
        that is visibly shedding load, while a genuinely slower peer
        still loses to a fast loaded one."""
        def key(u: str):
            br = self.breaker(u)
            state_rank = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}[br.state]
            if br.state == OPEN and br.probe_ripe():
                state_rank = 1  # due a probe: better than hard-open
            if pressure is None:
                return (state_rank, br.score())
            s = br.score()
            return (state_rank, round(s / 0.020),
                    pressure.get(u, 0.0), s)
        return sorted(urls, key=key)

    def hedge_delay(self, primary: Optional[str] = None) -> float:
        """Adaptive hedge trigger: the primary peer's observed p95 (the
        Tail-at-Scale rule — hedge only past the latency you normally
        see), clamped to [hedge_min, hedge_max]; defaults before any
        observation exists."""
        p95 = self.breaker(primary).p95_s() if primary else None
        if p95 is None:
            return self.hedge_default_s
        return max(self.hedge_min_s, min(self.hedge_max_s, 1.5 * p95))

    def snapshot(self) -> dict:
        with self._lock:
            peers = dict(self._peers)
        return {url: br.snapshot() for url, br in sorted(peers.items())}


# Shared daemon pool for hedged fan-out. Bounded: a wedged peer parks a
# worker until its own timeout, it cannot accumulate threads unboundedly.
_hedge_pool = None
_hedge_pool_lock = threading.Lock()


def _get_hedge_pool():
    global _hedge_pool
    if _hedge_pool is None:
        with _hedge_pool_lock:
            if _hedge_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                _hedge_pool = ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="hedge")
    return _hedge_pool


def hedged(fn: Callable[[str], object], candidates: Sequence[str],
           health: Optional[PeerHealth] = None,
           delay: Optional[float] = None,
           deadline: Optional[Deadline] = None):
    """Tail-tolerant call: try candidates[0]; if it hasn't succeeded
    within `delay` (or it failed), fire the next candidate; first
    not-None result wins and the rest are abandoned. fn must be
    idempotent (reads). Outcomes and latencies are recorded into
    `health`; candidates whose breaker rejects the dial are skipped —
    unless every candidate is rejected, in which case the first is
    forced (an open circuit must not make a sole holder unreachable).
    A candidate due a half-open probe is fired immediately alongside
    the primary, so real traffic doubles as the probe. Returns the
    winning result or None."""
    from concurrent.futures import FIRST_COMPLETED, wait

    if not candidates:
        return None
    order = list(candidates)
    if health is not None:
        # PASSIVE screening — allow() would consume a half-open probe
        # slot for candidates the hedge may never dial, wedging the
        # breaker in half-open; here a dialed ripe candidate IS the
        # probe and record() below does the state transition
        usable = [c for c in order
                  if health.breaker(c).state != OPEN
                  or health.breaker(c).probe_ripe()]
        order = usable if usable else [order[0]]
    if delay is None:
        delay = (health.hedge_delay(order[0])
                 if health is not None else 0.05)
    dl = deadline or current_deadline()
    pool = _get_hedge_pool()
    ctx_dl = dl  # propagate into workers
    # ContextVars don't cross the pool: capture the ambient span here
    # and re-enter it in each worker, so every leg's http_call becomes
    # a child span of the request that hedged
    ctx_sp = tracing.current_span()

    def run_one(c: str):
        t0 = _now()
        try:
            with deadline_scope(ctx_dl), tracing.span_scope(ctx_sp):
                out = fn(c)
        except Exception:
            out = None
        lat = _now() - t0
        if health is not None:
            health.record(c, out is not None, lat if out is not None
                          else None)
        return out

    pending = {pool.submit(run_one, order[0]): order[0]}
    nxt = 1
    # a ripe open breaker rides along as an immediate probe
    if health is not None and nxt < len(order) \
            and health.breaker(order[nxt]).probe_ripe():
        pending[pool.submit(run_one, order[nxt])] = order[nxt]
        if health is not None:
            health.count_hedge("probe")
        nxt += 1
    first_fire = True
    while pending:
        if dl is not None and dl.remaining() <= 0:
            for f in pending:
                f.cancel()
            return None
        wait_s = delay if (first_fire and nxt < len(order)) else 0.5
        if dl is not None:
            wait_s = min(wait_s, max(0.001, dl.remaining()))
        done, _ = wait(pending, timeout=wait_s,
                       return_when=FIRST_COMPLETED)
        for f in done:
            result = f.result()
            won = pending.pop(f)
            if result is not None:
                if ctx_sp is not None:
                    ctx_sp.annotate("hedge.winner", won)
                    ctx_sp.annotate("hedge.legs_fired", nxt)
                for g in pending:
                    g.cancel()
                return result
        if nxt < len(order) and (done or first_fire):
            # primary too slow (hedge) or failed (fail-over): fire next
            if not done and health is not None:
                health.count_hedge("fired")
            pending[pool.submit(run_one, order[nxt])] = order[nxt]
            nxt += 1
            first_fire = False
        elif not done and not first_fire and nxt >= len(order) \
                and not pending:
            break
        elif not done and nxt >= len(order):
            # nothing left to fire; keep waiting on what's in flight
            first_fire = False
    return None
