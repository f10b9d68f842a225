"""CRC32-C (Castagnoli) — the needle checksum algorithm
(reference weed/storage/needle/crc.go:13 uses Go hash/crc32 Castagnoli).

Uses the native library built from ``csrc/crc32c.cpp`` with ``g++`` at
first use, else a numpy table-driven fallback. Both accept any byte-shaped
buffer (bytes / bytearray / memoryview / ndarray) without copying it, and
both chain through ``crc=``: ``crc32c(b, crc32c(a))`` equals
``crc32c(a + b)``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from seaweedfs_tpu_torch.utils import native_build

_POLY = 0x82F63B78  # reflected Castagnoli
_SRC = os.path.join(native_build.CSRC_DIR, "crc32c.cpp")
_COMMAND = ["g++", "-O3", "-shared", "-fPIC"]


def _make_table() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (_POLY ^ (c >> 1)) if (c & 1) else (c >> 1)
        tab[i] = c
    return tab


_TAB = _make_table()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build() -> str:
    """Compile the native library (raises native_build.BuildError)."""
    return native_build.build_shared(_SRC, _COMMAND)[0]


def _native() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(build())
            except (native_build.BuildError, OSError):
                return None
            lib.crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                   ctypes.c_int64]
            lib.crc32c.restype = ctypes.c_uint32
            _lib = lib
        return _lib


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)  # a view of the caller's bytes


def _crc32c_py(data, crc: int = 0) -> int:
    c = np.uint32(crc ^ 0xFFFFFFFF)
    tab = _TAB
    for b in _as_bytes(data).tolist():
        c = tab[(int(c) ^ b) & 0xFF] ^ (int(c) >> 8)
        c = np.uint32(c)
    return int(c) ^ 0xFFFFFFFF


def crc32c(data: bytes | bytearray | memoryview | np.ndarray,
           crc: int = 0) -> int:
    lib = _native()
    if lib is None:
        return _crc32c_py(data, crc)
    buf = _as_bytes(data)
    if buf.size == 0:
        return crc & 0xFFFFFFFF
    return int(lib.crc32c(crc, buf.ctypes.data, buf.size))
