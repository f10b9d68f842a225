"""Leveled logging — the glog analogue.

Functional equivalent of reference weed/glog/glog.go:1 (vendored google
glog: severities, -v verbosity, -vmodule per-module gating, size-based
log-file rotation). API mirrors the call sites the reference uses:

    from seaweedfs_tpu_torch.utils import glog
    glog.info("volume %d mounted", vid)
    glog.warningf("slow peer %s", addr)        # *f aliases, go-style
    glog.error("read failed: %s", err)
    if glog.v(2):                               # guarded verbose path
        glog.info("raw request %r", payload)

Severity lines always reach stderr (and the rotating file when
configured); v-level lines print only when `-v` (or a -vmodule
override for the calling module) admits them. Line format matches
glog: `I0730 14:03:02.123456 140395 file.py:42] message`.

The port's copy of seaweedfs_tpu/utils/glog.py, whole: the port's command
line (cli.py) sets -v, -vmodule and -logfile through it. It imports
nothing of that package.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from typing import Optional

INFO, WARNING, ERROR, FATAL = 0, 1, 2, 3
_SEV_CHAR = "IWEF"

_lock = threading.Lock()
_verbosity = 0
_vmodule: dict[str, int] = {}
_log_file: Optional["_RotatingFile"] = None
_also_stderr = True
_context_provider = None  # e.g. tracing's "[t=abcd1234] " prefix hook
MAX_SIZE = 64 << 20  # rotation threshold, reference glog.MaxSize


class _RotatingFile:
    def __init__(self, path: str, max_bytes: int):
        self.path = path
        self.max_bytes = max_bytes
        self._fh = open(path, "a", buffering=1)

    def write(self, line: str) -> None:
        self._fh.write(line)
        if self._fh.tell() >= self.max_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._fh.close()
        stamp = time.strftime("%Y%m%d-%H%M%S")
        rotated = f"{self.path}.{stamp}"
        try:
            os.replace(self.path, rotated)
        except OSError:
            pass
        self._fh = open(self.path, "a", buffering=1)

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


# ---- configuration (the -v / -vmodule / -logdir flag surface) ----

def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)


def set_vmodule(spec: str) -> None:
    """Per-module verbosity overrides: "volume_server=3,master=1"
    (reference glog -vmodule; patterns may use * wildcards)."""
    global _vmodule
    parsed = {}
    for part in (spec or "").split(","):
        if not part.strip():
            continue
        mod, _, lvl = part.partition("=")
        parsed[mod.strip()] = int(lvl or 0)
    with _lock:
        _vmodule = parsed


def set_log_file(path: str, max_bytes: int = MAX_SIZE,
                 also_stderr: bool = True) -> None:
    global _log_file, _also_stderr
    with _lock:
        if _log_file is not None:
            _log_file.close()
        _log_file = _RotatingFile(path, max_bytes)
        _also_stderr = also_stderr


def set_context_provider(fn) -> None:
    """Register a callable returning a per-line prefix (e.g. the active
    trace id) inserted between the glog head and the message. Must be
    cheap and return "" when it has nothing to add; any exception it
    raises is swallowed. Survives reset(): the provider is ambient
    wiring (tracing installs it at import), not test-local state."""
    global _context_provider
    _context_provider = fn


def reset() -> None:
    """Back to defaults (tests)."""
    global _log_file, _verbosity, _vmodule, _also_stderr
    with _lock:
        if _log_file is not None:
            _log_file.close()
        _log_file = None
    _verbosity = 0
    _vmodule = {}
    _also_stderr = True


# ---- emit ----

def _caller(depth: int) -> tuple[str, int]:
    frame = sys._getframe(depth)
    return os.path.basename(frame.f_code.co_filename), frame.f_lineno


def _fmt(msg: str, args: tuple) -> str:
    if not args:
        return msg
    try:
        return msg % args
    except (TypeError, ValueError):
        return f"{msg} {args!r}"


def _emit(sev: int, depth: int, msg: str, args: tuple) -> None:
    msg = _fmt(msg, args)
    fname, lineno = _caller(depth)
    now = time.time()
    frac = int((now % 1) * 1e6)
    head = (f"{_SEV_CHAR[sev]}"
            f"{time.strftime('%m%d %H:%M:%S', time.localtime(now))}"
            f".{frac:06d} {threading.get_native_id():>6d} "
            f"{fname}:{lineno}] ")
    if _context_provider is not None:
        try:
            head += _context_provider()
        except Exception:
            pass
    line = head + msg + "\n"
    with _lock:
        if _log_file is not None:
            try:
                _log_file.write(line)
            except OSError:
                pass
        if _log_file is None or _also_stderr:
            try:
                sys.stderr.write(line)
            except (OSError, ValueError):
                pass


def info(msg: str, *args) -> None:
    _emit(INFO, 3, msg, args)


def warning(msg: str, *args) -> None:
    _emit(WARNING, 3, msg, args)


def error(msg: str, *args) -> None:
    _emit(ERROR, 3, msg, args)


def fatal(msg: str, *args) -> None:
    """Log at FATAL and raise (the Go original exits the process; a
    library raise keeps tests and embedded servers controllable)."""
    _emit(FATAL, 3, msg, args)
    raise SystemExit(_fmt(msg, args))


def exception(msg: str, *args) -> None:
    """error() plus the current exception's traceback. Args are
    substituted BEFORE the traceback is appended — tracebacks routinely
    contain % characters that must not reach the formatter."""
    import traceback
    _emit(ERROR, 3, _fmt(msg, args) + "\n" + traceback.format_exc(), ())


def v(level: int, depth: int = 2) -> bool:
    """True when verbose lines at `level` are admitted for the calling
    module (its -vmodule override wins over the global -v)."""
    if _vmodule:
        fname, _ = _caller(depth)
        mod = fname[:-3] if fname.endswith(".py") else fname
        with _lock:
            for pat, lvl in _vmodule.items():
                if pat == mod or ("*" in pat and re.fullmatch(
                        pat.replace("*", ".*"), mod)):
                    return level <= lvl
    return level <= _verbosity


def vlog(level: int, msg: str, *args) -> None:
    """glog.V(level).Info(...) in one call."""
    if v(level, depth=3):
        _emit(INFO, 3, msg, args)


# go-style *f aliases (the reference writes glog.Infof/Warningf/...)
infof = info
warningf = warning
errorf = error
fatalf = fatal
