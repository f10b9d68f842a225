"""Per-node admission control: class-weighted slots under an adaptive
concurrency limit, plus per-tenant token buckets.

The governor divides the AdaptiveLimiter's limit L into nested caps:

    background  <= bg_cap    = max(1, L // 4)
    write + bg  <= lower_cap = max(2, 3 * L // 4)
    everything  <= L, with one slot of L reserved for background

so interactive traffic always has >= L/4 of headroom that background
cannot take (no priority inversion), while background always has one
reachable slot (writes can fill neither the shared lower_cap pool nor
the global limit completely — no starvation).  Admission is a
constant-time counter check; there is no queue.  A request that does
not fit is shed immediately with a Retry-After hint sized from the
observed queue delay, which RetryPolicy (utils/resilience.py) honors.

``enabled=False`` short-circuits admit() to a shared no-op grant —
the bit-for-bit comparator switch, same convention as
``resilient_reads`` / ``parallel_replication``.

The port's copy of seaweedfs_tpu/qos/governor.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import threading
from typing import Optional

from seaweedfs_tpu_torch.qos.classes import BACKGROUND, CLASSES, INTERACTIVE, WRITE
from seaweedfs_tpu_torch.qos.limiter import AdaptiveLimiter
from seaweedfs_tpu_torch.utils import clockctl, tracing

# pressure decays with this half-life after the last shed event
_SHED_HALF_LIFE_S = 5.0


class Grant:
    """Outcome of one admit() call.  ``ok`` grants carry a release()
    that returns the slot and feeds the served latency back into the
    adaptive limiter; shed grants carry the Retry-After hint."""

    __slots__ = ("ok", "retry_after", "reason", "_fn", "_done")

    def __init__(self, ok: bool, retry_after: float = 0.0,
                 reason: str = "", release_fn=None):
        self.ok = ok
        self.retry_after = retry_after
        self.reason = reason
        self._fn = release_fn
        self._done = False

    def release(self) -> None:
        if self._fn is not None and not self._done:
            self._done = True
            self._fn()


# shared pass-through grant for the disabled comparator: zero
# allocation, zero counters, zero behavior change
_PASS = Grant(True)


class TenantBuckets:
    """Non-blocking per-tenant token buckets (keyed by S3 access key
    or client IP).  rate <= 0 means unlimited — the default, so the
    happy path is untouched until an operator configures a quota.

    Unlike utils.limiter.TokenBucket (which starts empty and *blocks*
    its caller — right for a bandwidth governor, wrong for admission),
    these start full at ``burst`` and answer immediately: admission
    must never queue."""

    def __init__(self, rate: float = 0.0, burst: Optional[float] = None):
        self._lock = threading.Lock()
        self._buckets: dict = {}  # key -> [tokens, last_monotonic]
        self.configure(rate, burst)

    def configure(self, rate: float, burst: Optional[float] = None) -> None:
        with self._lock:
            self.rate = float(rate)
            self.burst = float(burst) if burst is not None \
                else max(2.0 * self.rate, 1.0)
            self._buckets.clear()

    def try_consume(self, key, cost: float = 1.0):
        """(admitted, retry_after_s).  O(1); prunes idle tenants when
        the table grows past 4096 so an IP sweep can't balloon it."""
        if self.rate <= 0:
            return True, 0.0
        now = clockctl.monotonic()
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                if len(self._buckets) > 4096:
                    stale = now - (2.0 * self.burst / self.rate)
                    self._buckets = {k: v for k, v in
                                     self._buckets.items() if v[1] > stale}
                b = self._buckets[key] = [self.burst, now]
            tokens = min(self.burst, b[0] + (now - b[1]) * self.rate)
            b[1] = now
            if tokens >= cost:
                b[0] = tokens - cost
                return True, 0.0
            b[0] = tokens
            return False, (cost - tokens) / self.rate

    def snapshot(self) -> dict:
        with self._lock:
            return {"rate": self.rate, "burst": self.burst,
                    "tenants": len(self._buckets)}


class QosGovernor:
    def __init__(self, metrics=None, enabled: bool = True,
                 initial_limit: int = 32, min_limit: int = 8,
                 max_limit: int = 256, tenant_rate: float = 0.0,
                 tenant_burst: Optional[float] = None):
        self.enabled = enabled
        self.limiter = AdaptiveLimiter(initial=initial_limit,
                                       min_limit=min_limit,
                                       max_limit=max_limit)
        self.tenants = TenantBuckets(tenant_rate, tenant_burst)
        # per-CLASS tenant buckets: a tenant's background sweep can be
        # rate-capped without touching its interactive reads. A class
        # with a configured bucket uses it INSTEAD of the global one
        # (the global stays the catch-all for unconfigured classes).
        self.class_tenants: dict = {}
        # per-(class, tenant) OVERRIDE caps: one specific aggressor
        # clipped without touching anyone else. Installed by operators
        # or by the ledger-driven auto-capper (stats/autocap.py); wins
        # over both bucket layers above.
        self.tenant_caps: dict = {}
        self._lock = threading.Lock()
        self._inflight = {c: 0 for c in CLASSES}
        self._admitted = {c: 0 for c in CLASSES}
        self._shed = {c: 0 for c in CLASSES}
        self._shed_tenant = 0
        # per-class served-latency EWMA (ms) for the profile breakdown
        self._lat_ms = {c: 0.0 for c in CLASSES}
        self._last_shed = 0.0  # monotonic; 0 = never
        self._m_admitted = self._m_shed = None
        if metrics is not None:
            self._m_admitted = metrics.counter(
                "qos", "admitted_total", "admitted requests", ("cls",))
            self._m_shed = metrics.counter(
                "qos", "shed_total", "shed requests", ("cls", "reason"))
            self._g_inflight = metrics.gauge(
                "qos", "inflight", "in-flight requests", ("cls",))
            self._g_limit = metrics.gauge(
                "qos", "limit", "adaptive concurrency limit")
            self._g_pressure = metrics.gauge(
                "qos", "pressure", "local overload pressure [0,1]")
            self._g_qdelay = metrics.gauge(
                "qos", "queue_delay_seconds", "estimated queueing delay")
            metrics.on_expose(self._refresh_gauges)

    def _refresh_gauges(self) -> None:
        with self._lock:
            for c in CLASSES:
                self._g_inflight.set(c, value=self._inflight[c])
        self._g_limit.set(value=self.limiter.limit)
        self._g_pressure.set(value=self.pressure())
        self._g_qdelay.set(value=self.limiter.queue_delay())

    # ---- admission ----
    def _fits_locked(self, cls: str) -> bool:
        limit = self.limiter.limit
        bg_cap = max(1, limit // 4)
        lower_cap = max(2, (3 * limit) // 4)
        i = self._inflight[INTERACTIVE]
        w = self._inflight[WRITE]
        b = self._inflight[BACKGROUND]
        total = i + w + b
        if cls == INTERACTIVE:
            # one global slot stays reserved for background
            return (i + w) < limit - 1 and total < limit
        if cls == WRITE:
            # writes also leave one slot of the shared lower pool for
            # background, and can never push interactive out of its
            # reserved top quarter
            return (w < lower_cap - 1 and (w + b) < lower_cap
                    and (i + w) < limit - 1 and total < limit)
        return b < bg_cap and (w + b) < lower_cap and total < limit

    def admit(self, cls: str, tenant=None, cost: float = 1.0) -> Grant:
        if not self.enabled:
            return _PASS
        if cls not in self._inflight:
            cls = BACKGROUND
        if tenant is not None:
            bucket = (self.tenant_caps.get((cls, tenant))
                      or self.class_tenants.get(cls, self.tenants))
            ok, ra = bucket.try_consume(tenant, cost)
            if not ok:
                with self._lock:
                    self._shed_tenant += 1
                if self._m_shed:
                    self._m_shed.inc(cls, "tenant")
                tracing.annotate("qos.verdict", "shed:tenant")
                return Grant(False, retry_after=max(0.05, ra),
                             reason="tenant")
        with self._lock:
            if self._fits_locked(cls):
                self._inflight[cls] += 1
                self._admitted[cls] += 1
                if self._m_admitted:
                    self._m_admitted.inc(cls)
                t0 = clockctl.monotonic()
                # the admission verdict lands on the ambient server
                # span (annotate is a ContextVar read when no trace)
                tracing.annotate("qos.verdict", "admitted")
                tracing.annotate("qos.class", cls)
                tracing.annotate(
                    "qos.queue_delay_ms",
                    round(self.limiter.queue_delay() * 1000.0, 3))
                return Grant(True,
                             release_fn=lambda: self._release(cls, t0))
            self._shed[cls] += 1
            self._last_shed = clockctl.monotonic()
        if self._m_shed:
            self._m_shed.inc(cls, "limit")
        # polite hint: roughly the time for the queue estimate to
        # drain, bounded so clients neither hammer nor stall
        ra = min(5.0, max(0.2, 2.0 * self.limiter.queue_delay()))
        tracing.annotate("qos.verdict", "shed:limit")
        tracing.annotate("qos.class", cls)
        return Grant(False, retry_after=ra, reason="limit")

    def _release(self, cls: str, t0: float) -> None:
        dt = clockctl.monotonic() - t0
        with self._lock:
            self._inflight[cls] -= 1
            prev = self._lat_ms[cls]
            self._lat_ms[cls] = dt * 1000.0 if prev == 0.0 \
                else prev + 0.2 * (dt * 1000.0 - prev)
        self.limiter.observe(dt)

    # ---- per-tenant override caps (autocap + operators) ----
    def set_tenant_cap(self, cls: str, tenant, rate: float,
                       burst: Optional[float] = None) -> None:
        """Cap ONE (class, tenant) pair at `rate` req/s; rate <= 0
        removes the cap.  This is the hook stats/autocap.py's
        ledger-driven loop drives."""
        key = (cls, tenant)
        if rate <= 0:
            self.tenant_caps.pop(key, None)
            return
        prev = self.tenant_caps.get(key)
        if prev is None:
            self.tenant_caps[key] = TenantBuckets(rate, burst)
        else:
            prev.configure(rate, burst)

    def clear_tenant_cap(self, cls: str, tenant) -> None:
        self.tenant_caps.pop((cls, tenant), None)

    # ---- pressure (what scrubber / repair queue subscribe to) ----
    def pressure(self) -> float:
        """[0,1]: how close this node is to shedding.  Max of a
        utilization term (>0 above 50% of the limit) and an
        exponentially-decaying trace of the last shed event, so
        background throttling persists a few seconds past a burst."""
        if not self.enabled:
            return 0.0
        with self._lock:
            total = sum(self._inflight.values())
            last_shed = self._last_shed
        limit = max(1, self.limiter.limit)
        util = max(0.0, min(1.0, (total / limit - 0.5) / 0.5))
        shed = 0.0
        if last_shed > 0:
            age = clockctl.monotonic() - last_shed
            shed = 0.5 ** (age / _SHED_HALF_LIFE_S)
        return max(util, shed)

    # ---- observability / operator control ----
    def snapshot(self) -> dict:
        with self._lock:
            classes = {c: {"inflight": self._inflight[c],
                           "admitted": self._admitted[c],
                           "shed": self._shed[c],
                           "latency_ewma_ms": round(self._lat_ms[c], 3)}
                       for c in CLASSES}
            shed_tenant = self._shed_tenant
        return {"enabled": self.enabled,
                "pressure": round(self.pressure(), 4),
                "classes": classes,
                "shed_tenant": shed_tenant,
                "tenant_buckets": self.tenants.snapshot(),
                "tenant_class_buckets": {
                    c: b.snapshot()
                    for c, b in sorted(self.class_tenants.items())},
                "tenant_caps": {
                    f"{c}:{t}": b.snapshot()
                    for (c, t), b in sorted(self.tenant_caps.items(),
                                            key=lambda kv: str(kv[0]))},
                **self.limiter.snapshot()}

    def configure(self, **kw) -> dict:
        """Runtime tuning (``POST /admin/qos`` and cluster.qos):
        enabled, limit, min_limit, max_limit, tenant_rate,
        tenant_burst, tenant_class_rates ({class: req/s; <= 0 removes
        the override}), tenant_class_bursts ({class: burst}).  Returns
        the post-change snapshot."""
        if "enabled" in kw:
            self.enabled = bool(kw["enabled"])
        lim = self.limiter
        if "min_limit" in kw:
            lim.min_limit = max(1, int(kw["min_limit"]))
        if "max_limit" in kw:
            lim.max_limit = max(lim.min_limit, int(kw["max_limit"]))
        if "limit" in kw:
            lim.set_limit(int(kw["limit"]))
        else:
            lim.set_limit(lim.limit)  # re-clamp into new bounds
        if "tenant_rate" in kw or "tenant_burst" in kw:
            self.tenants.configure(
                float(kw.get("tenant_rate", self.tenants.rate)),
                kw.get("tenant_burst"))
        if "tenant_class_rates" in kw or "tenant_class_bursts" in kw:
            rates = kw.get("tenant_class_rates") or {}
            bursts = kw.get("tenant_class_bursts") or {}
            for cls in set(rates) | set(bursts):
                if cls not in CLASSES:
                    continue
                prev = self.class_tenants.get(cls)
                rate = float(rates.get(cls, prev.rate if prev else 0.0))
                if rate <= 0:
                    self.class_tenants.pop(cls, None)
                    continue
                burst = bursts.get(cls)
                if prev is None:
                    self.class_tenants[cls] = TenantBuckets(rate, burst)
                else:
                    prev.configure(rate, burst)
        if "tenant_caps" in kw:
            # {"<class>:<tenant>": req/s; <= 0 removes} — the operator
            # spelling of set_tenant_cap (cluster.qos / POST /admin/qos)
            for key, rate in (kw["tenant_caps"] or {}).items():
                cls, _, tenant = str(key).partition(":")
                if cls in CLASSES and tenant:
                    self.set_tenant_cap(cls, tenant, float(rate))
        return self.snapshot()
