"""ctypes loader for the host GF(2^8) codec (csrc/rs_cpu.cpp), the port of
seaweedfs_tpu/native/rs_native.py.

The library is built with g++ at first use into the package's git-ignored
build/ directory (utils/native_build.py), first with ``-march=native`` and,
if the compiler refuses that, with plain ``-O3``. It falls back cleanly when
no compiler is present: callers check ``available()`` (ops/rs_cpu.py then
runs its numpy path). The CRC-32C entry of the same source is not bound
here; the port's needle checksum is utils/crc.py.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from seaweedfs_tpu_torch.utils import native_build

_SRC = os.path.join(native_build.CSRC_DIR, "rs_cpu.cpp")
# tried in order: the host's own vector extensions, then a portable build
_COMMANDS = (["g++", "-O3", "-march=native", "-shared", "-fPIC"],
             ["g++", "-O3", "-shared", "-fPIC"])

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build() -> str:
    """Compile the library (raises native_build.BuildError when every
    command of the ladder fails); returns its path."""
    err: Optional[Exception] = None
    for command in _COMMANDS:
        try:
            return native_build.build_shared(_SRC, command)[0]
        except native_build.BuildError as e:
            err = e
    raise err


def _bind(lib: ctypes.CDLL) -> None:
    lib.gf_apply.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.gf_apply.restype = None
    lib.gf_apply_strided.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64]
    lib.gf_apply_strided.restype = None
    lib.gf_force_impl.argtypes = [ctypes.c_int]
    lib.gf_force_impl.restype = ctypes.c_int
    lib.gf_impl_name.restype = ctypes.c_char_p


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(build())
            except (native_build.BuildError, OSError):
                return None
            _bind(lib)
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host codec (csrc/rs_cpu.cpp) could "
                           "not be built or loaded")
    return lib


def gf_apply(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out = mat (m,k) x data (k,n) over GF(256)."""
    lib = _lib_or_raise()
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = mat.shape
    if data.ndim != 2 or data.shape[0] != k:
        raise ValueError(f"data must be ({k}, n), got {data.shape}")
    n = data.shape[1]
    out = np.zeros((m, n), dtype=np.uint8)
    lib.gf_apply(mat.ctypes.data, m, k, data.ctypes.data, out.ctypes.data, n)
    return out


def gf_apply_into(mat: np.ndarray, data: np.ndarray, out: np.ndarray,
                  col0: int = 0, length: Optional[int] = None) -> None:
    """Accumulate mat (m,k) x data (k,n) into columns [col0, col0+length)
    of out (m,n), which must be zero there (or hold a partial sum). The
    call releases the GIL and touches nothing outside its column range, so
    disjoint ranges may run concurrently from a thread pool."""
    lib = _lib_or_raise()
    for name, a in (("mat", mat), ("data", data), ("out", out)):
        if a.dtype != np.uint8 or not a.flags.c_contiguous:
            raise ValueError(f"{name} must be C-contiguous uint8")
    m, k = mat.shape
    if data.ndim != 2 or data.shape[0] != k:
        raise ValueError(f"data must be ({k}, n), got {data.shape}")
    n = data.shape[1]
    if out.shape != (m, n):
        raise ValueError(f"out must be ({m}, {n}), got {out.shape}")
    if length is None:
        length = n - col0
    if not (0 <= col0 and 0 <= length and col0 + length <= n):
        raise ValueError(f"columns [{col0}, {col0}+{length}) outside {n}")
    lib.gf_apply_strided(mat.ctypes.data, m, k, data.ctypes.data,
                         out.ctypes.data, n, col0, length)


IMPL_AUTO, IMPL_SCALAR, IMPL_AVX2, IMPL_GFNI = 0, 1, 2, 3


def force_impl(which: int) -> int:
    """Pin the GF kernel tier (IMPL_*); returns the tier that will run."""
    return int(_lib_or_raise().gf_force_impl(which))


def impl_name() -> str:
    """Name of the GF kernel tier currently selected."""
    return _lib_or_raise().gf_impl_name().decode()
