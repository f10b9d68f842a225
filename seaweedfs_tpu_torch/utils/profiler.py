"""Thread -> ambient-scope registry (the port of the registry half of
seaweedfs_tpu/utils/profiler.py: ``tag``, ``untag``, ``scope``).

Worker loops that are not HTTP requests (the EC batch dispatcher) tag
their thread with the QoS class and route of the work they run, so a
wall-stack sampler can attribute its samples. The sampler itself is not
ported: ``_active`` counts running samplers, and while it is 0 ``tag()``
is one global check and a return — the zero-cost disabled path of the
JAX package.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

# ident -> (cls, route, trace_id); written by the owning thread only
_scopes: dict[int, tuple] = {}
# count of running samplers: the zero-cost gate for tag()
_active = 0


def tag(cls: Optional[str], route: Optional[str] = None,
        trace_id: Optional[str] = None):
    """Register the calling thread's ambient scope; returns a token for
    ``untag()`` (None while no sampler runs)."""
    if not _active:
        return None
    ident = threading.get_ident()
    prev = _scopes.get(ident)
    _scopes[ident] = (cls, route, trace_id)
    return (ident, prev)


def untag(token) -> None:
    if token is None:
        return
    ident, prev = token
    if prev is None:
        _scopes.pop(ident, None)
    else:
        _scopes[ident] = prev


@contextmanager
def scope(cls: Optional[str] = None, route: Optional[str] = None,
          trace_id: Optional[str] = None):
    """Tag the calling thread for the duration of a with-block."""
    token = tag(cls, route, trace_id)
    try:
        yield
    finally:
        untag(token)
