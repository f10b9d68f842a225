"""Leveled logging, the part of seaweedfs_tpu/utils/glog.py the port uses:
``warning`` lines in glog's format on stderr,
``W0730 14:03:02.123456 140395 file.py:42] message``. The other
severities, verbosity levels, -vmodule and log-file rotation are not
ported.
"""

from __future__ import annotations

import os
import sys
import threading
import time

WARNING = 1
_SEV_CHAR = "IWE"
_lock = threading.Lock()


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
    line = head + _fmt(msg, args) + "\n"
    with _lock:
        try:
            sys.stderr.write(line)
        except (OSError, ValueError):
            pass


def warning(msg: str, *args) -> None:
    _emit(WARNING, msg, args)
