"""PyTorch Reed-Solomon coder — the port of ops/rs_jax.py.

GF(256) multiplication is linear over GF(2), so the transform factors into
bit planes. For each output row i, XOR together the input rows selected by
bit b of the matrix constants (S_ib), then fold the 8 planes with one
doubling chain per OUTPUT row (Horner form over output bits):
    P_i = ((((S_i7 * 2) ^ S_i6) * 2) ^ ...) ^ S_i0
`gf_apply_reference` is that transform written in plain PyTorch; it is the
plain version the CUDA kernel (csrc/gf_apply.cu, through ops/rs_cuda.py) is
held against, and what the kernel's wrapper runs on CPU tensors.

`TorchCoder` (registered "torch") has JaxCoder's surface (encode,
encode_array, reconstruct, reconstruct_data) plus encode_into,
rebuild_matrix and reconstruct_rows with CpuCoder's semantics, so the
pipelined rebuild runs on the card too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from seaweedfs_tpu_torch.models.coder import (DEFAULT_SCHEME, ErasureCoder,
                                              LrcScheme, RSScheme,
                                              register_coder,
                                              scheme_from_dict)
from seaweedfs_tpu_torch.ops import gf256


def as_matrix(mat) -> np.ndarray:
    """A GF(256) coefficient matrix as a host (m, k) uint8 array."""
    if isinstance(mat, torch.Tensor):
        mat = mat.detach().cpu().numpy()
    mat = np.asarray(mat)
    if mat.ndim != 2 or mat.size == 0:
        raise ValueError(f"coefficient matrix must be 2-D and non-empty, "
                         f"got shape {mat.shape}")
    if mat.dtype != np.uint8:
        if mat.min() < 0 or mat.max() > 255:
            raise ValueError("coefficients must lie in 0..255")
        mat = mat.astype(np.uint8)
    return mat


def _xtime(v: torch.Tensor) -> torch.Tensor:
    """Multiply each byte by 2 in GF(2^8). Works in uint8 lanes, where
    `<<` drops bit 8 and `>>` is logical; (the SWAR uint32 form of
    rs_jax._xtime cannot be copied: on the CPU torch has no uint32 shifts
    and `>>` on int32 is arithmetic)."""
    return (v << 1) ^ ((v >> 7) * 0x1D)


def gf_apply_reference(mat, data: torch.Tensor) -> torch.Tensor:
    """out[i] = XOR_j mat[i, j] * data[j] over GF(256), in plain PyTorch.

    mat: (m, k) coefficients (numpy, tensor or nested lists); data: (k, n)
    uint8 tensor on any device -> (m, n) uint8 on data's device. The
    Horner form of rs_jax._apply_matrix_rows, unrolled on the host over
    the matrix bits."""
    mat = as_matrix(mat)
    m, k = mat.shape
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[0] != k:
        raise ValueError(f"data must be ({k}, n) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    rows = [data[j] for j in range(k)]
    outs = []
    for i in range(m):
        p = None
        for b in range(7, -1, -1):
            s = None
            for j in range(k):
                if (int(mat[i, j]) >> b) & 1:
                    s = rows[j] if s is None else s ^ rows[j]
            if p is None:
                p = s
            else:
                p = _xtime(p)
                if s is not None:
                    p = p ^ s
        outs.append(p if p is not None else torch.zeros_like(rows[0]))
    return torch.stack(outs)


def resolve_device(device) -> torch.device:
    """The coder's device. A CUDA device with no card present raises: the
    port never carries on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device for {dev}; pass device='cpu' to run the "
                "plain PyTorch version")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _host_rows(rows: Sequence) -> np.ndarray:
    """Equal-length byte rows -> a writable (len, n) uint8 array."""
    n = len(rows[0])
    out = np.empty((len(rows), n), dtype=np.uint8)
    for r, row in enumerate(rows):
        if len(row) != n:
            raise ValueError("unequal shard sizes")
        out[r] = np.frombuffer(row, dtype=np.uint8) \
            if not isinstance(row, np.ndarray) else row
    return out


@register_coder("torch")
class TorchCoder(ErasureCoder):
    """ErasureCoder over ops/rs_cuda.gf_apply (through apply_rows): the
    hand-written kernel on a CUDA device (the default), the plain version
    on device='cpu'.
    Bytes out are identical to seaweedfs_tpu's CpuCoder and JaxCoder."""

    def __init__(self, scheme: RSScheme = DEFAULT_SCHEME,
                 device="cuda"):
        if isinstance(scheme, LrcScheme):
            raise ValueError(f"{scheme}: an RS coder; LRC codes on "
                             "ops/lrc.LrcCoder or through BatchCoder")
        super().__init__(scheme)
        self.device = resolve_device(device)
        self.parity = gf256.parity_matrix(scheme.data_shards,
                                          scheme.parity_shards)

    def apply_rows(self, mat, src: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mat (m', k') applied to (k', n) rows on the coder's device ->
        (m', n): the one place a coder picks its kernel, for its own
        calls and for the pipelines' device lane. TorchCoder: K1
        (rs_cuda.gf_apply) for every matrix."""
        from seaweedfs_tpu_torch.ops import rs_cuda
        return rs_cuda.gf_apply(mat, src, out)

    def _apply(self, mat: np.ndarray, data: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """Host (k', n) rows -> host (m', n): one copy to the device, one
        kernel launch, one copy back."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if not data.flags.writeable:  # torch.from_numpy wants writable
            data = data.copy()
        src = torch.from_numpy(data)
        res = self.apply_rows(mat, src.to(self.device)).cpu().numpy()
        if out is None:
            return res
        out[...] = res
        return out

    def encode(self, shards: Sequence[bytes]) -> list[bytes]:
        k = self.scheme.data_shards
        if len(shards) < k:
            raise ValueError(f"need {k} data shards, got {len(shards)}")
        parity = self._apply(self.parity, _host_rows(shards[:k]))
        return [bytes(shards[i]) for i in range(k)] + \
            [row.tobytes() for row in parity]

    def encode_array(self, data: np.ndarray) -> np.ndarray:
        """(k, n) uint8 -> (m, n) uint8 parity, any n."""
        return self._apply(self.parity, data)

    def encode_into(self, data: np.ndarray, out: np.ndarray) -> np.ndarray:
        """encode_array into a caller-owned (m, n) buffer."""
        return self._apply(self.parity, data, out)

    def rebuild_matrix(self, present: Sequence[int],
                       missing: Sequence[int]) -> np.ndarray:
        """Coefficient rows expressing each `missing` shard (data OR
        parity) as a GF(256) combination of the first k `present` shards
        (rs_cpu.CpuCoder.rebuild_matrix)."""
        k, total = self.scheme.data_shards, self.scheme.total_shards
        present = tuple(sorted(present))
        if len(present) < k:
            raise ValueError(f"too few shards: {len(present)} < {k}")
        dmat = gf256.decode_matrix(k, total, present)
        rows = [dmat[i] if i < k else
                gf256.gf_matmul(self.parity[i - k][None, :], dmat)[0]
                for i in missing]
        return np.stack(rows).astype(np.uint8)

    def reconstruct_rows(self, srcdata: np.ndarray, rebuild_mat: np.ndarray,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        """Apply a rebuild_matrix() to (k, n) rows of the first k present
        shards -> (len(missing), n) recovered rows."""
        return self._apply(rebuild_mat, srcdata, out)

    def _recover(self, shards: Sequence[Optional[bytes]],
                 wanted: list[int]) -> list[Optional[bytes]]:
        total = self.scheme.total_shards
        if len(shards) != total:
            raise ValueError(f"expected {total} shards, got {len(shards)}")
        present = [i for i in range(total) if shards[i] is not None]
        k = self.scheme.data_shards
        if len(present) < k:
            raise ValueError(f"too few shards: {len(present)} < {k}")
        out = [bytes(s) if s is not None else None for s in shards]
        if wanted:
            rec = self.reconstruct_rows(
                _host_rows([shards[i] for i in present[:k]]),
                self.rebuild_matrix(present, wanted))
            for r, i in enumerate(wanted):
                out[i] = rec[r].tobytes()
        return out

    def reconstruct(self, shards: Sequence[Optional[bytes]]) -> list[bytes]:
        return self._recover(
            shards, [i for i, s in enumerate(shards) if s is None])

    def reconstruct_data(self, shards: Sequence[Optional[bytes]]) -> list[Optional[bytes]]:
        return self._recover(
            shards, [i for i in range(self.scheme.data_shards)
                     if shards[i] is None])


def coder_from_numpy(code_spec: dict, parity_matrix: np.ndarray,
                     device="cuda") -> TorchCoder:
    """Carry seaweedfs_tpu's code state across: its .vif CodeSpec dict and
    its gf256.parity_matrix as numpy. Both are checked against this
    package's own derivation before the coder is returned, so a volume
    encoded by the JAX package is rebuilt here with the same code."""
    scheme = scheme_from_dict(code_spec)
    coder = TorchCoder(scheme, device=device)
    given = np.asarray(parity_matrix)
    if given.shape != coder.parity.shape or \
            not np.array_equal(given, coder.parity):
        raise ValueError(f"parity matrix {given.shape} does not match "
                         f"{scheme}'s derivation")
    return coder
