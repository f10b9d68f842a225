"""Host Reed-Solomon coder: numpy, with the native C++ codec
(csrc/rs_cpu.cpp through native/rs_native.py) when it builds. The port of
seaweedfs_tpu/ops/rs_cpu.py.

It plays the role klauspost/reedsolomon's SIMD codec plays in the reference
(go.mod:61): the always-available codec on the host. In this package it is
the EC batch scheduler's fallback (parallel/batcher.py), the matrix
derivation behind MeshCoder and BatchCoder, and the independent host check
of the shards the card writes. No card path runs through it.

Two coders are registered:
  - "cpu":    single-threaded;
  - "cpu-mt": shards each batch across a thread pool by column range. The
              native kernel releases the GIL and its strided entry point
              writes only its own columns, so workers need zero copies; the
              numpy path shards by column slices. Both give output
              bit-identical to "cpu" whatever the worker count — XOR
              accumulation is positionally independent.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from seaweedfs_tpu_torch.models.coder import (DEFAULT_SCHEME, ErasureCoder,
                                              LrcScheme, RSScheme,
                                              register_coder)
from seaweedfs_tpu_torch.ops import gf256

# column-shard boundaries stay multiples of the widest vector stride (the
# GFNI tier consumes 128B; 64 keeps word alignment and cache-line locality)
_SHARD_ALIGN = 64
# below this, pool dispatch overhead beats the parallelism
_MIN_PARALLEL_BYTES = 1 << 16

_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0


def _worker_pool(workers: int) -> ThreadPoolExecutor:
    """Shared process-wide pool, grown to the largest size requested —
    coders are cheap to construct, threads are not."""
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None or _pool_size < workers:
            if _pool is not None:
                _pool.shutdown(wait=False)
            _pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="rs-cpu")
            _pool_size = workers
        return _pool


def auto_workers() -> int:
    """Worker count for 'auto': SEAWEEDFS_TPU_EC_WORKERS overrides, else
    the scheduler-visible core count."""
    env = os.environ.get("SEAWEEDFS_TPU_EC_WORKERS")
    if env:
        return max(1, int(env))
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _column_cuts(n: int, workers: int) -> list[int]:
    """[0, ..., n] boundaries: `workers` near-equal ranges, all interior
    cuts _SHARD_ALIGN-aligned."""
    per = -(-n // workers)
    per = -(-per // _SHARD_ALIGN) * _SHARD_ALIGN
    return list(range(0, n, per)) + [n]


def _as_matrix(shards: Sequence[bytes], indices: list[int]) -> np.ndarray:
    rows = [np.frombuffer(shards[i], dtype=np.uint8) for i in indices]
    return np.stack(rows, axis=0)


def _native():
    from seaweedfs_tpu_torch.native import rs_native
    return rs_native if rs_native.available() else None


def _gf_apply_numpy_into(mat: np.ndarray, data: np.ndarray,
                         out: np.ndarray) -> None:
    """numpy path: one 65536-entry table gather per byte PAIR
    (gf256.pair_table), accumulated into out."""
    m, k = mat.shape
    n = data.shape[1]
    even = n - (n & 1)
    for j in range(k):
        d = data[j]
        d16 = d[:even].view(np.uint16)
        for i in range(m):
            c = int(mat[i, j])
            if c == 0:
                continue
            o16 = out[i, :even].view(np.uint16)
            if c == 1:
                o16 ^= d16
                if even != n:
                    out[i, -1] ^= d[-1]
            else:
                o16 ^= gf256.pair_table(c)[d16]
                if even != n:
                    out[i, -1] ^= gf256.MUL_TABLE[c][d[-1]]


def _gf_apply(mat: np.ndarray, data: np.ndarray, use_native: bool = True,
              workers: int = 1, out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[i] = XOR_j mat[i,j] * data[j] over GF(256).

    data: (k, n) uint8; mat: (m, k) uint8 -> (m, n) uint8. With
    workers > 1 the columns are sharded across a thread pool; output is
    bit-identical to workers == 1. A caller-provided `out` must be
    zero-filled (the kernels accumulate)."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, _ = mat.shape
    n = data.shape[1]
    if out is None:
        out = np.zeros((m, n), dtype=np.uint8)
    native = _native() if use_native else None
    if workers > 1 and n >= _MIN_PARALLEL_BYTES:
        cuts = _column_cuts(n, workers)
        if len(cuts) > 2:
            pool = _worker_pool(len(cuts) - 1)
            if native is not None:
                futs = [pool.submit(native.gf_apply_into, mat, data, out,
                                    a, b - a)
                        for a, b in zip(cuts, cuts[1:])]
            else:
                futs = [pool.submit(_gf_apply_numpy_into, mat,
                                    data[:, a:b], out[:, a:b])
                        for a, b in zip(cuts, cuts[1:])]
            for f in futs:
                f.result()
            return out
    if native is not None:
        native.gf_apply_into(mat, data, out)
    else:
        _gf_apply_numpy_into(mat, data, out)
    return out


def gf_partial_product(coeffs: np.ndarray, rows: np.ndarray,
                       out: Optional[np.ndarray] = None,
                       use_native: bool = True,
                       workers: int = 1) -> np.ndarray:
    """Partial-column product for distributed repair: out[i] ^=
    XOR_j coeffs[i,j] * rows[j] over GF(256).

    The per-holder half of a decode product split by column: a shard
    holder applies its own columns of the rebuild matrix to its local
    shard ranges; the rebuilder XOR-folds the contributions, which is
    associative and commutative, so any grouping of holders gives bytes
    identical to the one-machine decode. `coeffs` may be 1-D (a single
    output row); a caller-provided `out` must be zero-filled on first use
    (the kernels accumulate)."""
    mat = np.asarray(coeffs, dtype=np.uint8)
    if mat.ndim == 1:
        mat = mat[None, :]
    data = np.asarray(rows, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None, :]
    return _gf_apply(mat, data, use_native, workers, out)


@register_coder("cpu")
class CpuCoder(ErasureCoder):
    def __init__(self, scheme: RSScheme = DEFAULT_SCHEME,
                 use_native: bool = True, workers: int | str = 1):
        if isinstance(scheme, LrcScheme):
            raise ValueError(f"{scheme}: an RS coder; LRC codes on "
                             "ops/lrc.LrcCoder or through BatchCoder")
        super().__init__(scheme)
        self.use_native = use_native
        self.workers = auto_workers() if workers == "auto" else max(1, workers)
        self._parity = gf256.parity_matrix(scheme.data_shards,
                                           scheme.parity_shards)

    def _apply(self, mat: np.ndarray, data: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        return _gf_apply(mat, data, self.use_native, self.workers, out)

    def encode(self, shards: Sequence[bytes]) -> list[bytes]:
        k, total = self.scheme.data_shards, self.scheme.total_shards
        if len(shards) < k:
            raise ValueError(f"need {k} data shards, got {len(shards)}")
        n = len(shards[0])
        if any(len(shards[i]) != n for i in range(k)):
            raise ValueError("unequal shard sizes")
        parity = self._apply(self._parity, _as_matrix(shards, list(range(k))))
        return [bytes(shards[i]) for i in range(k)] + \
            [parity[i].tobytes() for i in range(total - k)]

    def encode_array(self, data: np.ndarray) -> np.ndarray:
        """(k, n) uint8 -> (m, n) uint8 parity, no bytes round-trip."""
        return self._apply(self._parity,
                           np.ascontiguousarray(data, dtype=np.uint8))

    def encode_into(self, data: np.ndarray, out: np.ndarray) -> np.ndarray:
        """encode_array into a caller-owned (m, n) buffer. Zero-fills `out`
        first — the kernels accumulate."""
        out[:] = 0
        return self._apply(self._parity,
                           np.ascontiguousarray(data, dtype=np.uint8), out)

    def reconstruct(self, shards: Sequence[Optional[bytes]]) -> list[bytes]:
        k, total = self.scheme.data_shards, self.scheme.total_shards
        if len(shards) != total:
            raise ValueError(f"expected {total} shards, got {len(shards)}")
        present = [i for i in range(total) if shards[i] is not None]
        if len(present) < k:
            raise ValueError(
                f"too few shards to reconstruct: {len(present)} < {k}")
        missing = [i for i in range(total) if shards[i] is None]
        if not missing:
            return [bytes(s) for s in shards]
        out = [bytes(s) if s is not None else None for s in shards]
        n = len(shards[present[0]])
        dmat = gf256.decode_matrix(k, total, tuple(present))
        srcdata = _as_matrix(shards, present[:k])
        missing_data = [i for i in missing if i < k]
        if missing_data:
            rec = self._apply(dmat[missing_data, :], srcdata)
            for r, i in enumerate(missing_data):
                out[i] = rec[r].tobytes()
        missing_parity = [i for i in missing if i >= k]
        if missing_parity:
            # the full data matrix, recovered rows included
            full = np.empty((k, n), dtype=np.uint8)
            for i in range(k):
                full[i] = np.frombuffer(out[i], dtype=np.uint8)
            pm = self._parity[[i - k for i in missing_parity], :]
            par = self._apply(pm, full)
            for r, i in enumerate(missing_parity):
                out[i] = par[r].tobytes()
        return out

    def rebuild_matrix(self, present: Sequence[int],
                       missing: Sequence[int]) -> np.ndarray:
        """Coefficient rows expressing each `missing` shard (data OR
        parity) as a GF(256) combination of the first k `present` shards.
        Constant across a whole volume walk — pipelines compute it once
        and stream batches through reconstruct_rows."""
        k, total = self.scheme.data_shards, self.scheme.total_shards
        present = tuple(sorted(present))
        if len(present) < k:
            raise ValueError(f"too few shards: {len(present)} < {k}")
        dmat = gf256.decode_matrix(k, total, present)
        rows = [dmat[i] if i < k else
                gf256.gf_matmul(self._parity[i - k][None, :], dmat)[0]
                for i in missing]
        return np.stack(rows).astype(np.uint8)

    def reconstruct_rows(self, srcdata: np.ndarray,
                         rebuild_mat: np.ndarray,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        """Apply a rebuild_matrix() to (k, n) rows of the first k present
        shards -> (len(missing), n) recovered rows."""
        if out is not None:
            out[:] = 0
        return self._apply(rebuild_mat,
                           np.ascontiguousarray(srcdata, dtype=np.uint8), out)

    def reconstruct_data(self, shards: Sequence[Optional[bytes]]) -> list[Optional[bytes]]:
        k, total = self.scheme.data_shards, self.scheme.total_shards
        present = [i for i in range(total) if shards[i] is not None]
        if len(present) < k:
            raise ValueError(
                f"too few shards to reconstruct: {len(present)} < {k}")
        out = [bytes(s) if s is not None else None for s in shards]
        missing_data = [i for i in range(k) if shards[i] is None]
        if missing_data:
            dmat = gf256.decode_matrix(k, total, tuple(present))
            rec = self._apply(dmat[missing_data, :],
                              _as_matrix(shards, present[:k]))
            for r, i in enumerate(missing_data):
                out[i] = rec[r].tobytes()
        return out


@register_coder("cpu-mt")
class CpuCoderMT(CpuCoder):
    """CpuCoder with workers='auto'. Same bits out, more cores in."""

    def __init__(self, scheme: RSScheme = DEFAULT_SCHEME,
                 use_native: bool = True):
        super().__init__(scheme, use_native=use_native, workers="auto")
