"""Adaptive concurrency limit from observed service latency.

Gradient-style limiter (after Netflix's concurrency-limits Gradient2,
and the TCP Vegas lineage behind it): a fast EWMA of recent
admit->release latency is compared against a slow EWMA that stands in
for the uncongested baseline.  When recent latency rises above the
baseline the node is queueing — the limit contracts multiplicatively;
when latency sits at the baseline the limit probes upward additively
(+sqrt(limit)).  The governor (governor.py) turns the limit into
class-weighted admission slots; requests beyond them are shed with
``503 + Retry-After`` instead of queueing into deadline expiry.

This reuses the latency-observation convention of the breaker EWMAs in
utils/resilience.py (CircuitBreaker keeps the same fast/slow pair per
peer) but tracks the *local* serving latency rather than a remote
peer's.

The port's copy of seaweedfs_tpu/qos/limiter.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import math
import threading


class AdaptiveLimiter:
    """Thread-safe; observe() is called once per completed request."""

    def __init__(self, initial: int = 32, min_limit: int = 8,
                 max_limit: int = 256, tolerance: float = 1.5,
                 smoothing: float = 0.2, alpha_short: float = 0.2,
                 alpha_long: float = 0.01, update_every: int = 8):
        """tolerance is the latency headroom before the limit reacts
        (1.5 = recent latency may sit 50% over baseline); smoothing
        damps each limit step; update_every batches EWMA samples per
        limit recomputation so one slow request can't whipsaw it."""
        self.min_limit = max(1, int(min_limit))
        self.max_limit = max(self.min_limit, int(max_limit))
        self.tolerance = tolerance
        self.smoothing = smoothing
        self.alpha_short = alpha_short
        self.alpha_long = alpha_long
        self.update_every = max(1, int(update_every))
        self._limit = float(min(self.max_limit,
                                max(self.min_limit, int(initial))))
        self._short = 0.0
        self._long = 0.0
        self._samples = 0
        self._pending = 0
        self._lock = threading.Lock()

    @property
    def limit(self) -> int:
        return int(self._limit)

    def observe(self, latency_s: float) -> None:
        if latency_s < 0:
            return
        with self._lock:
            if self._samples == 0:
                self._short = self._long = latency_s
            else:
                self._short += self.alpha_short * (latency_s - self._short)
                self._long += self.alpha_long * (latency_s - self._long)
            self._samples += 1
            self._pending += 1
            if self._pending >= self.update_every:
                self._pending = 0
                self._update_locked()

    def _update_locked(self) -> None:
        if self._short <= 0 or self._long <= 0:
            return
        # >1 means headroom, <1 means queueing; clamped so one window
        # can neither collapse nor explode the limit
        gradient = max(0.5, min(1.1,
                                self.tolerance * self._long / self._short))
        new = gradient * self._limit + math.sqrt(self._limit)
        limit = ((1.0 - self.smoothing) * self._limit
                 + self.smoothing * new)
        self._limit = max(float(self.min_limit),
                          min(float(self.max_limit), limit))

    def queue_delay(self) -> float:
        """Estimated queueing component of recent latency (seconds):
        how far the fast EWMA sits above the baseline.  Feeds the
        Retry-After hint and the pressure signal."""
        with self._lock:
            return max(0.0, self._short - self._long)

    def set_limit(self, limit: int) -> None:
        """Operator override (``/admin/qos`` configure): pin the
        current limit inside [min_limit, max_limit]; adaptation
        continues from there."""
        with self._lock:
            self._limit = max(float(self.min_limit),
                              min(float(self.max_limit), float(limit)))

    def snapshot(self) -> dict:
        with self._lock:
            return {"limit": int(self._limit),
                    "min_limit": self.min_limit,
                    "max_limit": self.max_limit,
                    "latency_short_ms": self._short * 1000.0,
                    "latency_long_ms": self._long * 1000.0,
                    "queue_delay_ms":
                        max(0.0, self._short - self._long) * 1000.0,
                    "samples": self._samples}
