"""Request deadlines and the circuit-breaker states (the part of
seaweedfs_tpu/utils/resilience.py the store's read path uses).

- ``Deadline``: a remaining-time budget minted once at the request edge
  and propagated through nested calls, via the ambient
  ``current_deadline()`` inside a process and the ``X-Weed-Deadline``
  header between nodes. A nested call gets ``min(remaining, cap)`` as its
  timeout, so retries and hops never outlast what the caller is still
  willing to wait. The store's concurrent remote shard fetch and the
  needle cache's single-flight waiters honour it.
- ``CLOSED`` / ``OPEN`` / ``HALF_OPEN``: the states of a per-peer circuit
  breaker. The breakers themselves (``PeerHealth``, ``CircuitBreaker``)
  come with the volume server; the store is handed a peer-health object
  and ranks shard holders by these states.

Time is read through utils/clockctl, so a test can install a virtual
clock.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Optional

from seaweedfs_tpu_torch.utils import clockctl, headers

DEADLINE_HEADER = headers.DEADLINE  # remaining seconds, decimal string


def _now() -> float:
    """Behavioral clock: wall monotonic unless a virtual clock is
    installed (utils/clockctl.py)."""
    return clockctl.monotonic()


CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


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
# worker (see Store._fetch_remote_shards).
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
