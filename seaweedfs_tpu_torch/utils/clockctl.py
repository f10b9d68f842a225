"""Process-wide clock indirection (the port of
seaweedfs_tpu/utils/clockctl.py: ``monotonic``, ``now``, ``sleep``,
``thread_time``, ``is_virtual`` and ``install``).

The batch scheduler, the resilience and QoS layers, the token buckets, the
scrubber and the volume server read their timers through this module
instead of ``time`` directly, so a test can put a virtual clock under them
with ``install()``. In production nothing is installed and the indirection
costs one module-attribute load.

The macro simulator (``seaweedfs_tpu_torch/sim``) installs its kernel's
virtual clock here, so O(100) in-process actors share one deterministic
timeline. Deliberately not thread-aware: the simulator is single-threaded
by construction, which is what makes it bit-reproducible.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Optional

_monotonic: Callable[[], float] = time.monotonic
_sleep: Callable[[float], None] = time.sleep
_now: Callable[[], float] = time.time
_thread_time: Callable[[], float] = time.thread_time


def monotonic() -> float:
    """The behavioral clock: wall monotonic unless a virtual clock is
    installed."""
    return _monotonic()


def now() -> float:
    """Behavioral wall clock (epoch seconds in production), for timestamps
    the code later compares against itself: TTL expiry, hint ages, the
    scrubber's last pass. Under an installed clock it follows
    ``monotonic_fn``."""
    return _now()


def sleep(seconds: float) -> None:
    """Behavioral sleep (retry backoff, token-bucket waits)."""
    _sleep(seconds)


def thread_time() -> float:
    """Per-thread CPU clock, for the ledger's per-request CPU charge.
    ``install()`` leaves it real unless given ``thread_time_fn``: CPU
    burned under a virtual clock is still real CPU."""
    return _thread_time()


def is_virtual() -> bool:
    return _monotonic is not time.monotonic


def _no_real_sleep(seconds: float) -> None:
    raise RuntimeError(
        "blocking sleep under a virtual clock — pass sleep_fn to install()")


@contextmanager
def install(monotonic_fn: Callable[[], float],
            sleep_fn: Optional[Callable[[float], None]] = None,
            now_fn: Optional[Callable[[], float]] = None,
            thread_time_fn: Optional[Callable[[], float]] = None):
    """Install a clock override for the duration of a with-block:
    ``monotonic()`` reads ``monotonic_fn``, ``now()`` reads ``now_fn``
    (``monotonic_fn`` when none is given, so now()-vs-now() comparisons
    stay coherent), ``sleep()`` calls ``sleep_fn`` (raising when none is
    given) and ``thread_time()`` reads ``thread_time_fn`` (staying real
    when none is given). Nested installs restore correctly (LIFO)."""
    global _monotonic, _sleep, _now, _thread_time
    prev = (_monotonic, _sleep, _now, _thread_time)
    _monotonic = monotonic_fn
    _sleep = sleep_fn if sleep_fn is not None else _no_real_sleep
    _now = now_fn if now_fn is not None else monotonic_fn
    if thread_time_fn is not None:
        _thread_time = thread_time_fn
    try:
        yield
    finally:
        _monotonic, _sleep, _now, _thread_time = prev
