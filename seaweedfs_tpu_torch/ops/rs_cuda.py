"""Wrapper, launch counter and build step of the hand-written Hopper kernel
for the GF(2^8) matrix apply (csrc/gf_apply.cu), the port of the Pallas
kernel in seaweedfs_tpu/ops/rs_pallas.py.

`gf_apply(mat, data)` runs the kernel on CUDA tensors and the plain
PyTorch version (rs_torch.gf_apply_reference) on CPU tensors, and only
because they lie on the CPU: for a CUDA tensor it launches the kernel or
raises. The library is built with nvcc for sm_90a into the package's
git-ignored build/ directory the first time a CUDA tensor needs it, and is
loaded with ctypes through a plain C interface.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from seaweedfs_tpu_torch.ops.rs_torch import as_matrix, gf_apply_reference
from seaweedfs_tpu_torch.utils import native_build

MAX_ROWS = 16   # m: outputs per launch (csrc/gf_apply.cu kMaxRows)
MAX_COLS = 32   # k: inputs per launch (one 32-bit selection mask)
_BLOCKS_PER_SM = 8

_SRC = os.path.join(native_build.CSRC_DIR, "gf_apply.cu")

# Kernel launches made through gf_apply; a run sets it to 0 and reads it
# back to show which path went through the kernel.
launches = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_sm_count: dict[int, int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def build() -> tuple[str, str]:
    """Compile csrc/gf_apply.cu for sm_90a; returns (library, compiler
    output with the -Xptxas -v register report)."""
    return native_build.build_shared(_SRC, [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            lib.gf_apply_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.gf_apply_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def selection_masks(mat: np.ndarray) -> np.ndarray:
    """(m * 8,) uint32: word i*8+b has bit j set iff bit b of mat[i, j] is
    set — the form in which the kernel takes its matrix."""
    bits = (mat[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1  # (m, k, 8)
    weights = np.uint64(1) << np.arange(mat.shape[1], dtype=np.uint64)
    masks = (bits.astype(np.uint64) * weights[None, :, None]).sum(axis=1)
    return np.ascontiguousarray(masks.astype(np.uint32).reshape(-1))


def max_blocks(device: torch.device) -> int:
    """Grid cap for one launch: a few resident blocks per SM; the kernel's
    grid-stride loop covers the rest of the columns."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx] * _BLOCKS_PER_SM


def _check(mat: np.ndarray, data: torch.Tensor,
           out: Optional[torch.Tensor]) -> None:
    m, k = mat.shape
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[0] != k:
        raise ValueError(f"data must be ({k}, n) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if data.shape[1] > 1 and data.stride(1) != 1:
        raise ValueError("data rows must be contiguous (stride 1)")
    if out is not None:
        if out.dtype != torch.uint8 or tuple(out.shape) != (m, data.shape[1]):
            raise ValueError(f"out must be ({m}, {data.shape[1]}) uint8, got "
                             f"{tuple(out.shape)} {out.dtype}")
        if out.device != data.device:
            raise ValueError(f"out on {out.device}, data on {data.device}")
        if out.shape[1] > 1 and out.stride(1) != 1:
            raise ValueError("out rows must be contiguous (stride 1)")


def gf_apply(mat, data: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = XOR_j mat[i, j] * data[j] over GF(256).

    mat: (m, k) coefficients on the host (m <= 16, k <= 32 on CUDA);
    data: (k, n) uint8 with contiguous rows (any row stride); out, when
    given, (m, n) uint8 on data's device. On CUDA the kernel is launched on
    the current stream without synchronising."""
    global launches
    mat = as_matrix(mat)
    _check(mat, data, out)
    if data.device.type == "cpu":
        res = gf_apply_reference(mat, data)
        if out is None:
            return res
        out.copy_(res)
        return out
    if data.device.type != "cuda":
        raise ValueError(f"gf_apply: unsupported device {data.device}")
    m, k = mat.shape
    if m > MAX_ROWS or k > MAX_COLS:
        raise ValueError(f"gf_apply kernel takes at most {MAX_ROWS}x"
                         f"{MAX_COLS} matrices, got {m}x{k}")
    n = data.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=torch.uint8, device=data.device)
    if n == 0:
        return out
    lib = _load()
    masks = selection_masks(mat)
    d_stride, o_stride = data.stride(0), out.stride(0)
    vec = int(data.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
              and (k == 1 or d_stride % 16 == 0)
              and (m == 1 or o_stride % 16 == 0))
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        rc = lib.gf_apply_launch(
            masks.ctypes.data, m, k, data.data_ptr(), d_stride,
            out.data_ptr(), o_stride, n, vec, max_blocks(data.device),
            stream)
    if rc != 0:
        raise RuntimeError(f"gf_apply kernel launch failed: CUDA error {rc}")
    with _lock:
        launches += 1
    return out
