"""Byte-accounted in-flight transfer limiter.

Redesign of reference weed/server/volume_server.go:23-30
(inFlightUploadDataSize / inFlightDownloadDataSize + their sync.Cond
backpressure, applied in volume_server_handlers.go): concurrent
request payload bytes are accounted against a cap; a request that
would exceed it waits until others drain, up to a timeout, after
which the caller sheds load (HTTP 429).

The port's copy of seaweedfs_tpu/utils/limiter.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import threading

from seaweedfs_tpu_torch.utils import clockctl


class TokenBucket:
    """Bytes/sec token bucket for background work (the scrubber's read
    throttle). rate <= 0 means unlimited, matching InFlightLimiter.

    The bucket starts EMPTY (initial=0) so a consumer of T total bytes
    is guaranteed to take >= T/rate seconds — the property the scrub
    rate-limit contract is stated in — instead of getting a free burst
    up front. A request larger than the capacity is allowed to drive
    the balance negative (debt), which later consumers pay off, so the
    long-run rate still holds for any chunk size."""

    def __init__(self, rate_bytes_per_sec: float, capacity: float = None,
                 initial: float = 0.0):
        self.rate = float(rate_bytes_per_sec)
        self.capacity = float(capacity if capacity is not None
                              else max(self.rate, 1.0))
        self._tokens = float(initial)
        self._ts = clockctl.monotonic()
        self._lock = threading.Lock()

    def set_rate(self, rate_bytes_per_sec: float) -> None:
        with self._lock:
            self._refill()
            self.rate = float(rate_bytes_per_sec)

    def _refill(self) -> None:
        now = clockctl.monotonic()
        if self.rate > 0:
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._ts) * self.rate)
        self._ts = now

    def peek(self) -> float:
        """Current token balance (bytes) after refill; negative when in
        debt. Status/observability only — does not take tokens."""
        with self._lock:
            self._refill()
            return self._tokens

    def consume(self, n: int, stop: "threading.Event" = None) -> bool:
        """Block until n tokens are available (or the debt is payable),
        then take them. Returns False only if `stop` was set while
        waiting."""
        if self.rate <= 0 or n <= 0:
            return True
        need = min(float(n), self.capacity)
        while True:
            with self._lock:
                self._refill()
                if self._tokens >= need:
                    self._tokens -= float(n)
                    return True
                wait = (need - self._tokens) / self.rate
            wait = min(wait, 0.2)
            if stop is not None:
                if stop.wait(wait):
                    return False
            else:
                clockctl.sleep(wait)


class InFlightLimiter:
    def __init__(self, limit_bytes: int, timeout: float = 30.0):
        self.limit = limit_bytes  # <= 0 means unlimited
        self.timeout = timeout
        self._used = 0
        self._waiters = 0
        self._cond = threading.Condition()

    def try_acquire(self, n: int, timeout: float = None) -> bool:
        """Reserve n bytes; block while the cap is exceeded. Returns
        False on timeout. A single request larger than the whole cap is
        admitted once the pipe is empty (matching the reference, which
        compares BEFORE adding: volume_server_handlers.go:62-75)."""
        if self.limit <= 0 or n <= 0:
            with self._cond:
                self._used += max(n, 0)
            return True
        deadline = clockctl.monotonic() + (self.timeout if timeout is None
                                       else timeout)
        with self._cond:
            while self._used > 0 and self._used + n > self.limit:
                remaining = deadline - clockctl.monotonic()
                if remaining <= 0:
                    return False
                self._waiters += 1
                try:
                    self._cond.wait(remaining)
                finally:
                    self._waiters -= 1
            self._used += n
            return True

    def release(self, n: int) -> None:
        if n <= 0:
            return
        with self._cond:
            self._used = max(0, self._used - n)
            self._cond.notify_all()

    @property
    def in_flight(self) -> int:
        with self._cond:
            return self._used

    @property
    def waiters(self) -> int:
        with self._cond:
            return self._waiters
