"""Build one native source of this package into a shared library at first use.

Libraries land in the package's ``build/`` directory (git-ignored) under a
name that carries a hash of the source text and the command line, so an
edited source never loads a stale build and a fresh checkout builds what it
runs. The compiler writes a per-process temporary name that is renamed into
place, so two concurrent builds never see each other's half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}


class BuildError(RuntimeError):
    """The compiler is missing or refused the source."""


def _lock_for(target: str) -> threading.Lock:
    with _guard:
        return _locks.setdefault(target, threading.Lock())


def build_shared(src: str, command: list[str],
                 timeout: float = 600.0) -> tuple[str, str]:
    """Compile ``src`` with ``command + ["-o", out, src]``; returns
    (library path, compiler output). The output is empty when an earlier
    build of the same source and command is reused."""
    with open(src, "rb") as f:
        text = f.read()
    digest = hashlib.sha256(text + repr(command).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    target = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    with _lock_for(target):
        if os.path.exists(target):
            return target, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [*command, "-o", tmp, src]
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=timeout)
            except (OSError, subprocess.SubprocessError) as e:
                raise BuildError(f"{' '.join(cmd)}: {e}") from e
            if proc.returncode != 0:
                raise BuildError(
                    f"{' '.join(cmd)} exited {proc.returncode}:\n"
                    f"{proc.stderr[-4000:]}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return target, (proc.stdout + proc.stderr).strip()
