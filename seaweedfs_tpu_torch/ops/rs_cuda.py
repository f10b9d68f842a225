"""Wrapper, launch counter and build step of the hand-written Hopper kernel
for the GF(2^8) matrix apply (csrc/gf_apply.cu), the port of the Pallas
kernel in seaweedfs_tpu/ops/rs_pallas.py.

`gf_apply(mat, data)` runs the kernel on CUDA tensors and the plain
PyTorch version (rs_torch.gf_apply_reference) on CPU tensors, and only
because they lie on the CPU: for a CUDA tensor it launches the kernel or
raises. `gf_apply_batch(mats, data)` is the kernel's batch entry under the
same rule: a (B, k, n) batch with one shared matrix or one per job, in one
launch, against `gf_apply_batch_reference`. The library is built with nvcc
for sm_90a into the package's git-ignored build/ directory the first time
a CUDA tensor needs it, and is loaded with ctypes through a plain C
interface. `run_kernel` holds the
wrapper contract that rs_mxu.mxu_apply (K2) shares.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Callable, Optional

import numpy as np
import torch

from seaweedfs_tpu_torch.ops.rs_torch import as_matrix, gf_apply_reference
from seaweedfs_tpu_torch.utils import native_build

MAX_ROWS = 16   # m: outputs per launch (csrc/gf_apply.cu kMaxRows)
MAX_COLS = 32   # k: inputs per launch (one 32-bit selection mask)

_SRC = os.path.join(native_build.CSRC_DIR, "gf_apply.cu")

# Kernel launches made through gf_apply, and through gf_apply_batch; a run
# sets them to 0 and reads them back to show which path went through which
# entry of the kernel.
launches = 0
batch_launches = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_sm_count: dict[int, int] = {}


def nvcc() -> str:
    """The CUDA compiler: nvcc on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def build() -> tuple[str, str]:
    """Compile csrc/gf_apply.cu for sm_90a; returns (library, compiler
    output with the -Xptxas -v register report)."""
    return native_build.build_shared(_SRC, [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            lib.gf_apply_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.gf_apply_launch.restype = ctypes.c_int
            lib.gf_apply_batch_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.gf_apply_batch_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def selection_masks(mat: np.ndarray) -> np.ndarray:
    """(..., m, k) uint8 -> (..., m * 8) uint32: word i*8+b has bit j set
    iff bit b of mat[..., i, j] is set — the form in which the kernel takes
    its matrix (one per job for a batch of matrices)."""
    bits = (mat[..., None] >> np.arange(8, dtype=np.uint8)) & 1  # (.., m, k, 8)
    weights = np.uint64(1) << np.arange(mat.shape[-1], dtype=np.uint64)
    masks = (bits.astype(np.uint64) * weights[:, None]).sum(axis=-2)
    return np.ascontiguousarray(
        masks.astype(np.uint32).reshape(*mat.shape[:-2], -1))


def sm_count(device: torch.device) -> int:
    """The device's streaming multiprocessors (cached per device)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


# Below this many columns (the encode batches of the small-block tier) a
# block computes half of the output rows, so the launch spreads over twice
# the blocks.
SMALL_N_LIMIT = 4 << 20
THREADS = 128   # threads per block (csrc/gf_apply.cu kThreads)
MAX_GRID = (1 << 31) - 1
MAX_GRID_Z = 65535  # the card's limit on gridDim.z (csrc/gf_apply.cu kMaxGridZ)


def pieces_per_thread(k: int) -> int:
    """16-byte pieces a K1 thread takes per grid-stride step, as
    gf_apply_launch picks its instantiation: two for k <= 16, else one."""
    return 2 if k <= 16 else 1


def launch_shape(m: int, k: int, n: int) -> tuple[int, int]:
    """K1's launch for an (m, k) matrix over n columns: (rows, grid) =
    output rows per block (the grid's y extent is ceil(m / rows)) and
    blocks along the columns, enough to cover every 16-byte piece once
    (the kernel's grid-stride loop takes the rest only past MAX_GRID).
    One launch whatever n is."""
    rows = -(-m // 2) if n < SMALL_N_LIMIT else m
    pieces = -(-n // 16)
    per_block = THREADS * pieces_per_thread(k)
    return rows, max(1, min(-(-pieces // per_block), MAX_GRID))


def batch_launch_shape(m: int, k: int, n: int,
                       batch: int) -> tuple[int, int, int]:
    """K1's batch launch for `batch` jobs of an (m, k) matrix over n
    columns: (rows, grid, grid_z) = output rows per block, blocks along
    each job's columns (as launch_shape covers one job) and blocks along
    the jobs, at most MAX_GRID_Z (the kernel's job-stride loop takes the
    rest). The row split follows launch_shape's rule on the batch's total
    columns, so a batch of one launches as gf_apply does. One launch
    whatever batch and n are."""
    rows, _ = launch_shape(m, k, batch * n)
    _, grid = launch_shape(m, k, n)
    return rows, grid, max(1, min(batch, MAX_GRID_Z))


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


def run_kernel(name: str, mat, data: torch.Tensor,
               out: Optional[torch.Tensor], plain: Callable,
               launch: Callable) -> tuple[torch.Tensor, bool]:
    """The contract the GF(2^8) kernel wrappers share (gf_apply here,
    rs_mxu.mxu_apply): mat (m, k) coefficients on the host (m <= 16,
    k <= 32 on CUDA); data (k, n) uint8 with contiguous rows (any n, any
    row stride); out, when given, (m, n) uint8 on data's device.

    CPU tensors take plain(mat, data), and only because they lie on the
    CPU. CUDA tensors call launch(mat, data, out, vec, stream), which
    enqueues the kernel on the current stream without synchronising and
    returns a CUDA error code; vec is 1 when data, out and both row
    strides are 16-byte aligned. Any other device raises. Returns
    (out, whether a kernel was launched)."""
    mat = as_matrix(mat)
    _check(mat, data, out)
    if data.device.type == "cpu":
        res = plain(mat, data)
        if out is None:
            return res, False
        out.copy_(res)
        return out, False
    if data.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {data.device}")
    m, k = mat.shape
    if m > MAX_ROWS or k > MAX_COLS:
        raise ValueError(f"{name} kernel takes at most {MAX_ROWS}x"
                         f"{MAX_COLS} matrices, got {m}x{k}")
    n = data.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=torch.uint8, device=data.device)
    if n == 0:
        return out, False
    vec = int(data.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
              and (k == 1 or data.stride(0) % 16 == 0)
              and (m == 1 or out.stride(0) % 16 == 0))
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        rc = launch(mat, data, out, vec, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, True


def _launch(mat: np.ndarray, data: torch.Tensor, out: torch.Tensor,
            vec: int, stream: int) -> int:
    m, k = mat.shape
    n = data.shape[1]
    masks = selection_masks(mat)  # alive until the call returns
    return _load().gf_apply_launch(
        masks.ctypes.data, m, k, data.data_ptr(), data.stride(0),
        out.data_ptr(), out.stride(0), n, vec,
        *launch_shape(m, k, n), stream)


def gf_apply(mat, data: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = XOR_j mat[i, j] * data[j] over GF(256), under
    run_kernel's contract: the kernel on CUDA tensors, the plain version
    (rs_torch.gf_apply_reference) on CPU tensors."""
    global launches
    out, launched = run_kernel("gf_apply", mat, data, out,
                               gf_apply_reference, _launch)
    if launched:
        with _lock:
            launches += 1
    return out


def batch_matrices(mats, batch: int) -> tuple[np.ndarray, bool]:
    """The matrices of a batch as (matrix, per_job): one (m, k) matrix
    shared by every job, or (batch, m, k) with one per job, each (r_i, k)
    matrix padded with zero rows to m = max r_i. `mats` is one 2-D matrix
    (array, tensor or nested lists), a 3-D array, or a sequence of 2-D
    matrices."""
    if isinstance(mats, torch.Tensor):
        mats = mats.detach().cpu().numpy()
    if isinstance(mats, np.ndarray) and mats.ndim == 3:
        mats = list(mats)
    elif not isinstance(mats, (list, tuple)) or not mats or \
            np.asarray(mats[0]).ndim < 2:
        return as_matrix(mats), False
    if len(mats) != batch:
        raise ValueError(f"{len(mats)} matrices for a batch of {batch}")
    mats = [as_matrix(mt) for mt in mats]
    k = mats[0].shape[1]
    if any(mt.shape[1] != k for mt in mats):
        raise ValueError("per-job matrices must share their column count")
    out = np.zeros((batch, max(mt.shape[0] for mt in mats), k), np.uint8)
    for b, mt in enumerate(mats):
        out[b, :mt.shape[0]] = mt
    return out, True


def gf_apply_batch_reference(mats, data: torch.Tensor) -> torch.Tensor:
    """The plain version of the batch entry: a loop of gf_apply_reference
    over the jobs of data (B, k, n) -> (B, m, n), with batch_matrices'
    reading of `mats`."""
    mat, per_job = batch_matrices(mats, data.shape[0])
    if data.dtype != torch.uint8 or data.dim() != 3:
        raise ValueError(f"data must be (B, k, n) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    return torch.stack([gf_apply_reference(mat[b] if per_job else mat,
                                           data[b])
                        for b in range(data.shape[0])])


def _check_batch(m: int, k: int, data: torch.Tensor,
                 out: Optional[torch.Tensor]) -> None:
    if data.dtype != torch.uint8 or data.dim() != 3 or data.shape[1] != k:
        raise ValueError(f"data must be (B, {k}, n) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if data.shape[0] == 0:
        raise ValueError("empty batch")
    if data.shape[2] > 1 and data.stride(2) != 1:
        raise ValueError("data rows must be contiguous (stride 1)")
    if out is not None:
        want = (data.shape[0], m, data.shape[2])
        if out.dtype != torch.uint8 or tuple(out.shape) != want:
            raise ValueError(f"out must be {want} uint8, got "
                             f"{tuple(out.shape)} {out.dtype}")
        if out.device != data.device:
            raise ValueError(f"out on {out.device}, data on {data.device}")
        if out.shape[2] > 1 and out.stride(2) != 1:
            raise ValueError("out rows must be contiguous (stride 1)")


def _aligned(t: torch.Tensor) -> bool:
    """t's base and the strides that matter (rows, jobs) are 16-byte
    aligned."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(d) % 16 == 0 for d in (0, 1) if t.shape[d] > 1)


def gf_apply_batch(mats, data: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[b, i] = XOR_j mat_b[i, j] * data[b, j] over GF(256), for a
    batch data (B, k, n) uint8 with contiguous rows (any n, any row and job
    stride) -> (B, m, n) on data's device: one matrix shared by every job,
    or one per job (batch_matrices). The batch entry of K1 on CUDA
    tensors, one launch whatever B and n are (m <= 16, k <= 32); the plain
    version (gf_apply_batch_reference) on CPU tensors, and only because
    they lie on the CPU; any other device raises. Per-job matrices go to
    the card from pinned host memory on the launch stream, without
    synchronising with it."""
    global batch_launches
    mat, per_job = batch_matrices(mats, data.shape[0])
    m, k = mat.shape[-2:]
    _check_batch(m, k, data, out)
    if data.device.type == "cpu":
        res = gf_apply_batch_reference(mat, data)
        if out is None:
            return res
        out.copy_(res)
        return out
    if data.device.type != "cuda":
        raise ValueError(f"gf_apply_batch: unsupported device {data.device}")
    if m > MAX_ROWS or k > MAX_COLS:
        raise ValueError(f"gf_apply_batch kernel takes at most {MAX_ROWS}x"
                         f"{MAX_COLS} matrices, got {m}x{k}")
    B, _, n = data.shape
    if out is None:
        out = torch.empty((B, m, n), dtype=torch.uint8, device=data.device)
    if n == 0:
        return out
    vec = int(_aligned(data) and _aligned(out))
    masks = selection_masks(mat)  # (m * 8,) or (B, m * 8); alive until return
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device)
        if per_job:
            host = torch.empty(masks.size, dtype=torch.int32, pin_memory=True)
            host.numpy()[:] = masks.reshape(-1).view(np.int32)
            dev = host.to(data.device, non_blocking=True)
            ptr = dev.data_ptr()
        else:
            ptr = masks.ctypes.data
        rc = _load().gf_apply_batch_launch(
            ptr, int(per_job), m, k, B, data.data_ptr(), data.stride(0),
            data.stride(1), out.data_ptr(), out.stride(0), out.stride(1), n,
            vec, *batch_launch_shape(m, k, n, B), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gf_apply_batch kernel launch failed: CUDA "
                           f"error {rc}")
    with _lock:
        batch_launches += 1
    return out
