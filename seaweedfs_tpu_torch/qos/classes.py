"""Traffic classes and their cluster-wide propagation.

Three classes order the cluster's work: ``interactive`` (client
GET/HEAD), ``write`` (PUT/POST/DELETE and their replica legs) and
``background`` (scrub, EC rebuild/repair, replication sync).  The
class rides every internal hop in an ``X-Weed-Class`` header exactly
like ``X-Weed-Deadline`` (utils/resilience.py): a request edge enters
``class_scope``, ``http_call`` injects the header into outbound calls,
and the receiving server re-enters the scope before dispatch.  A
volume server can therefore tell a filer chunk fetch made on behalf of
a user GET from a repair shard copy, without either caller threading
the class through its own plumbing.

Contextvars do NOT cross thread pools: fan-out sites (filer chunk
upload workers, volume replica legs, master repair posts) capture
``current_class()`` before submitting and re-enter ``class_scope`` in
the worker, same as they already do for deadlines.

Stdlib-only on purpose: utils/httpd.py imports this module, so it must
not import httpd (or anything that does) back.

The port's copy of seaweedfs_tpu/qos/classes.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from seaweedfs_tpu_torch.utils import headers
CLASS_HEADER = headers.CLASS

INTERACTIVE = "interactive"
WRITE = "write"
BACKGROUND = "background"
# priority order, highest first
CLASSES = (INTERACTIVE, WRITE, BACKGROUND)

_current: contextvars.ContextVar = contextvars.ContextVar(
    "weed_qos_class", default=None)


def current_class() -> Optional[str]:
    """The ambient traffic class, or None outside any scope."""
    return _current.get()


@contextlib.contextmanager
def class_scope(cls: Optional[str]):
    """Make ``cls`` the ambient class for the duration of the block
    (None = leave whatever is already ambient in place)."""
    if cls is None:
        yield
        return
    token = _current.set(cls)
    try:
        yield
    finally:
        _current.reset(token)


def from_headers(headers, default: Optional[str] = None) -> Optional[str]:
    """Extract a propagated class from request headers; unknown or
    absent values fall back to ``default`` (a forged or future class
    name must not crash admission, just lose its priority claim)."""
    v = headers.get(CLASS_HEADER, "") if headers else ""
    v = v.strip().lower()
    return v if v in CLASSES else default


def classify(method: str, path: str) -> str:
    """Default class for a request that arrived without a header —
    the edge classification.  Admin-plane traffic (EC transfers,
    scrub triggers, repair copies) is background; client GET/HEAD is
    interactive; everything else mutates and is write class."""
    if path.startswith("/admin"):
        return BACKGROUND
    if method in ("GET", "HEAD"):
        return INTERACTIVE
    return WRITE
