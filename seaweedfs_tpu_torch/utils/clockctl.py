"""Process-wide monotonic-clock indirection (the port of
seaweedfs_tpu/utils/clockctl.py, its ``monotonic`` and ``install`` only).

The batch scheduler reads its coalescing deadlines and cooldowns through
``monotonic()`` instead of ``time.monotonic`` directly, so a test can put a
virtual clock under it with ``install()``. In production nothing is
installed and the indirection costs one module-attribute load.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable

_monotonic: Callable[[], float] = time.monotonic


def monotonic() -> float:
    """The behavioral clock: wall monotonic unless a virtual clock is
    installed."""
    return _monotonic()


@contextmanager
def install(monotonic_fn: Callable[[], float]):
    """Install a clock override for the duration of a with-block. Nested
    installs restore correctly (LIFO)."""
    global _monotonic
    prev = _monotonic
    _monotonic = monotonic_fn
    try:
        yield
    finally:
        _monotonic = prev
