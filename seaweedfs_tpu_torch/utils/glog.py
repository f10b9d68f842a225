"""Leveled logging, the part of seaweedfs_tpu/utils/glog.py the port calls:
the severities (``info``, ``warning``, ``error``, ``exception``), the
verbose gate ``v`` / ``vlog`` and the per-line context hook that tracing
registers. Lines go to stderr in glog's format,
``I0730 14:03:02.123456 140395 file.py:42] message``.

The port has no CLI, so the flag surface (-v, -vmodule, log-file
rotation) is not ported: the verbosity stays 0 and v-level lines are
dropped. It imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import sys
import threading
import time

INFO, WARNING, ERROR = 0, 1, 2
_SEV_CHAR = "IWE"

_lock = threading.Lock()
_verbosity = 0
_context_provider = None  # e.g. tracing's "[t=abcd1234] " prefix hook


def set_context_provider(fn) -> None:
    """Register a callable returning a per-line prefix (e.g. the active
    trace id) inserted between the glog head and the message. Must be
    cheap and return "" when it has nothing to add; any exception it
    raises is swallowed."""
    global _context_provider
    _context_provider = fn


def _fmt(msg: str, args: tuple) -> str:
    if not args:
        return msg
    try:
        return msg % args
    except (TypeError, ValueError):
        return f"{msg} {args!r}"


def _emit(sev: int, msg: str, args: tuple) -> None:
    frame = sys._getframe(2)
    now = time.time()
    head = (f"{_SEV_CHAR[sev]}"
            f"{time.strftime('%m%d %H:%M:%S', time.localtime(now))}"
            f".{int((now % 1) * 1e6):06d} {threading.get_native_id():>6d} "
            f"{os.path.basename(frame.f_code.co_filename)}:"
            f"{frame.f_lineno}] ")
    if _context_provider is not None:
        try:
            head += _context_provider()
        except Exception:
            pass
    line = head + _fmt(msg, args) + "\n"
    with _lock:
        try:
            sys.stderr.write(line)
        except (OSError, ValueError):
            pass


def info(msg: str, *args) -> None:
    _emit(INFO, msg, args)


def warning(msg: str, *args) -> None:
    _emit(WARNING, msg, args)


def error(msg: str, *args) -> None:
    _emit(ERROR, msg, args)


def exception(msg: str, *args) -> None:
    """error() plus the current exception's traceback. Args are
    substituted BEFORE the traceback is appended — tracebacks routinely
    contain % characters that must not reach the formatter."""
    import traceback
    _emit(ERROR, _fmt(msg, args) + "\n" + traceback.format_exc(), ())


def v(level: int) -> bool:
    """True when verbose lines at `level` are admitted."""
    return level <= _verbosity


def vlog(level: int, msg: str, *args) -> None:
    """glog.V(level).Info(...) in one call."""
    if v(level):
        _emit(INFO, msg, args)
