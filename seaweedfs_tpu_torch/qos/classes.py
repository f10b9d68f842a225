"""Traffic classes (the port of seaweedfs_tpu/qos/classes.py's class
vocabulary and ambient scope).

Three classes order the cluster's work: ``interactive`` (client
GET/HEAD), ``write`` (PUT/POST/DELETE and their replica legs) and
``background`` (scrub, EC rebuild/repair, replication sync). The class is
ambient, in a contextvar: a caller enters ``class_scope`` and everything it
submits on that thread (the EC batch scheduler captures
``current_class()`` at submit) carries the class. Between nodes it travels
in the ``CLASS_HEADER`` request header; the serving stack that reads and
writes it is not ported.

Contextvars do NOT cross thread pools: a fan-out site captures
``current_class()`` before submitting and re-enters ``class_scope`` in
the worker.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

# seaweedfs_tpu/utils/headers.py CLASS
CLASS_HEADER = "X-Weed-Class"

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
