"""The bit-plane coder ("mxu") — the port of seaweedfs_tpu/ops/rs_mxu.py.

GF(256) multiplication is linear over GF(2), so a coefficient matrix M
(m, k) is one binary matrix B (8m, 8k) acting on bit planes: bit r of
out[i] at position t = XOR over (j, b) of B[8i+r, 8j+b] & (bit b of
data[j][t]), with B[8i+r, 8j+b] = bit r of (M[i, j] * 2^b). The kernel
(csrc/mxu_apply.cu) forms that product on the int8 tensor cores;
`mxu_apply_reference` is the same arithmetic in plain PyTorch, which the
tests use and the wrapper runs for CPU tensors only.

`MxuCoder` (registered "mxu") is TorchCoder with its parity on this
kernel: encode, encode_array, encode_into and the recomputation of lost
parity in reconstruct go through K2, as the reference's MxuCoder sends its
`_parity_fn` through the Pallas kernel. Data rows (reconstruct_rows, the
pipelined rebuild, reconstruct_data) are recovered on K1 (ops/rs_cuda.py),
where the reference uses XLA's decode_fn; the bytes are the same.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from seaweedfs_tpu_torch.models.coder import register_coder
from seaweedfs_tpu_torch.ops import gf256, rs_cuda
from seaweedfs_tpu_torch.ops.rs_torch import TorchCoder, _host_rows, as_matrix
from seaweedfs_tpu_torch.utils import native_build

_SRC = os.path.join(native_build.CSRC_DIR, "mxu_apply.cu")
# Columns per step of the plain version: its float32 planes take
# 8k * 4 bytes a column, so a step stays near 1 GiB whatever n is.
_PLAIN_STEP_BYTES = 1 << 30

# Kernel launches made through mxu_apply; a run sets it to 0 and reads it
# back to show which path went through the kernel.
launches = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def bitplane_matrix(mat) -> np.ndarray:
    """The (8m, 8k) int8 GF(2) matrix of byte matrix `mat`:
    B[8i+r, 8j+b] = bit r of mat[i, j] * 2^b."""
    mat = as_matrix(mat)
    m, k = mat.shape
    prod = gf256.MUL_TABLE[mat[:, :, None],
                           (1 << np.arange(8, dtype=np.uint8))[None, None, :]]
    bits = (prod[:, None, :, :] >> np.arange(8, dtype=np.uint8)[
        None, :, None, None]) & 1                    # (m, r, k, b)
    return np.ascontiguousarray(bits.reshape(8 * m, 8 * k).astype(np.int8))


@functools.lru_cache(maxsize=256)
def _device_bitplane(coeffs: bytes, m: int, k: int,
                     device: torch.device) -> torch.Tensor:
    """B as float32 on `device`, made once per matrix: a copy from pageable
    host memory waits for the device's queue, which a per-call copy would
    put in every call."""
    mat = np.frombuffer(coeffs, dtype=np.uint8).reshape(m, k)
    return torch.from_numpy(bitplane_matrix(mat)).to(device, torch.float32)


# The valid int8 wgmma N the kernel is built for.
_WGMMA_WIDTHS = (8, 16, 24, 32, 48, 64, 128)
_K_STEPS = (1, 2, 3, 4, 8)
# Bytes between the two 16-byte K halves of a K step (LBO) and between
# groups of 8 N rows (SBO) in the kernel's no-swizzle B layout.
IMAGE_LBO, IMAGE_SBO = 128, 256


def wgmma_width(m: int) -> int:
    """N of the kernel's product for m output rows: 8m, padded up to a
    valid int8 wgmma width the kernel is built for (128 for m > 8)."""
    if not 1 <= m <= rs_cuda.MAX_ROWS:
        raise ValueError(f"m must be in 1..{rs_cuda.MAX_ROWS}, got {m}")
    return next(w for w in _WGMMA_WIDTHS if w >= 8 * m)


def k_steps(k: int) -> int:
    """K steps of 32 planes (four input rows) the kernel runs for k
    inputs: ceil(k / 4), padded up to 1, 2, 3, 4 or 8."""
    if not 1 <= k <= rs_cuda.MAX_COLS:
        raise ValueError(f"k must be in 1..{rs_cuda.MAX_COLS}, got {k}")
    return next(c for c in _K_STEPS if 4 * c >= k)


def bitplane_image(mat) -> np.ndarray:
    """B as the kernel holds it in shared memory, (width * 32 * ksteps,)
    uint8: for K step c, N row n and K column kk (plane 32c + kk), the
    byte at c * width * 32 + (n // 8) * SBO + (kk // 16) * LBO
    + (n % 8) * 16 + kk % 16 — wgmma's no-swizzle K-major core matrices
    of 8 rows x 16 bytes. Rows n >= 8m and planes >= 8k are zero."""
    mat = as_matrix(mat)
    m, k = mat.shape
    width, steps = wgmma_width(m), k_steps(k)
    padded = np.zeros((width, 32 * steps), dtype=np.uint8)
    padded[:8 * m, :8 * k] = bitplane_matrix(mat)
    # (n8, r, c, half, col) -> (c, n8, half, r, col)
    cores = padded.reshape(width // 8, 8, steps, 2, 16).transpose(2, 0, 3, 1, 4)
    return np.ascontiguousarray(cores.reshape(-1))


@functools.lru_cache(maxsize=256)
def _device_image(coeffs: bytes, m: int, k: int,
                  device: torch.device) -> torch.Tensor:
    """bitplane_image on `device`, made once per matrix. The copy comes
    from pageable host memory; the stream is synchronised once so that a
    launch on any other stream finds the image complete."""
    mat = np.frombuffer(coeffs, dtype=np.uint8).reshape(m, k)
    img = torch.from_numpy(bitplane_image(mat)).to(device)
    torch.cuda.current_stream(device).synchronize()
    return img


def _unpack_planes(data: torch.Tensor) -> torch.Tensor:
    """(k, n) uint8 -> (8k, n) uint8 of 0/1, row 8j+b = bit b of data[j].
    uint8 `>>` and `& 1` (torch on the CPU has no uint32 shifts, and `>>`
    on int32 is arithmetic)."""
    k, n = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    return ((data[:, None, :] >> shifts[None, :, None]) & 1).reshape(8 * k, n)


def _pack_planes(bits: torch.Tensor) -> torch.Tensor:
    """(8m, n) uint8 of 0/1 -> (m, n) uint8, bit r of row i = bits[8i+r]."""
    planes = bits.reshape(-1, 8, bits.shape[1])
    out = planes[:, 0].clone()
    for r in range(1, 8):
        out |= planes[:, r] << r
    return out


def mxu_apply_reference(mat, data: torch.Tensor) -> torch.Tensor:
    """out[i] = XOR_j mat[i, j] * data[j] over GF(256) as the bit-plane
    product, in plain PyTorch: unpack to planes, float32 matmul with B
    (exact: every sum is an integer <= 8k <= 256), `& 1`, repack.

    mat: (m, k) coefficients; data: (k, n) uint8 on any device -> (m, n)
    uint8 on data's device."""
    mat = as_matrix(mat)
    m, k = mat.shape
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[0] != k:
        raise ValueError(f"data must be ({k}, n) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    n = data.shape[1]
    B = _device_bitplane(mat.tobytes(), m, k, data.device)
    out = torch.empty((m, n), dtype=torch.uint8, device=data.device)
    step = max(1, _PLAIN_STEP_BYTES // (32 * k))
    for c0 in range(0, n, step):
        X = _unpack_planes(data[:, c0:c0 + step]).to(torch.float32)
        Y = torch.matmul(B, X).to(torch.int32) & 1
        out[:, c0:c0 + step] = _pack_planes(Y.to(torch.uint8))
    return out


def build() -> tuple[str, str]:
    """Compile csrc/mxu_apply.cu for sm_90a; returns (library, compiler
    output with the -Xptxas -v register report)."""
    return native_build.build_shared(_SRC, [
        rs_cuda.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
        "-fPIC"])


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            lib.mxu_apply_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.mxu_apply_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def _launch(mat: np.ndarray, data: torch.Tensor, out: torch.Tensor,
            vec: int, stream: int) -> int:
    m, k = mat.shape
    image = _device_image(np.ascontiguousarray(mat).tobytes(), m, k,
                          data.device)
    return _load().mxu_apply_launch(
        image.data_ptr(), wgmma_width(m), k_steps(k), m, k, data.data_ptr(),
        data.stride(0), out.data_ptr(), out.stride(0), data.shape[1], vec,
        rs_cuda.sm_count(data.device), stream)


def mxu_apply(mat, data: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = XOR_j mat[i, j] * data[j] over GF(256) on the tensor
    cores, under rs_cuda.run_kernel's contract (gf_apply's): the kernel on
    CUDA tensors, mxu_apply_reference on CPU tensors."""
    global launches
    out, launched = rs_cuda.run_kernel("mxu_apply", mat, data, out,
                                       mxu_apply_reference, _launch)
    if launched:
        with _lock:
            launches += 1
    return out


@register_coder("mxu")
class MxuCoder(TorchCoder):
    """TorchCoder whose parity goes through K2 (mxu_apply); rebuild and
    decode matrices stay on K1. Bytes out are identical to TorchCoder's
    and to seaweedfs_tpu's MxuCoder."""

    def apply_rows(self, mat, src: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K2 for this coder's own parity matrix (the `parity` array
        itself), K1 for every other matrix."""
        if mat is self.parity:
            return mxu_apply(mat, src, out)
        return super().apply_rows(mat, src, out)

    def reconstruct(self, shards: Sequence[Optional[bytes]]) -> list[bytes]:
        """Missing data rows on K1, then lost parity recomputed from the
        full data rows on K2 (rs_jax.JaxCoder.reconstruct's order)."""
        k = self.scheme.data_shards
        missing = [i for i, s in enumerate(shards) if s is None]
        out = self._recover(shards, [i for i in missing if i < k])
        lost_parity = [i for i in missing if i >= k]
        if lost_parity:
            parity = self._apply(self.parity, _host_rows(out[:k]))
            for i in lost_parity:
                out[i] = parity[i - k].tobytes()
        return out
