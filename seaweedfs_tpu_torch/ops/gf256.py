"""GF(2^8) arithmetic and Reed-Solomon matrix construction (host side).

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D),
generator 2 — the field of the reference's codec (klauspost/reedsolomon).
The encoding matrix is the systematic Vandermonde construction: rows r of V
are [r^0, r^1, ..., r^(k-1)], and the final matrix is V * inv(V[:k]) so the
top k rows are the identity. Matching this construction exactly is what
makes the .ec shards bit-identical to the reference's and to seaweedfs_tpu's.

The matrices are tiny (at most 256 x 256) and built once per code or loss
pattern, so this module stays numpy on the host; the bulk transform they
drive runs on the card (ops/rs_cuda.py).
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
GF_GENERATOR = 2


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for GF(2^8) under GF_POLY with generator 2."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    # duplicate so exp[(log a + log b)] never needs an explicit mod
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[int(GF_LOG[a]) + int(GF_LOG[b])])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(256) division by zero")
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) - int(GF_LOG[b])) % 255])


def gf_inv(a: int) -> int:
    return gf_div(1, a)


def gf_exp_pow(base: int, n: int) -> int:
    """base**n in GF(256), with 0**0 == 1 (matches the reference construction)."""
    if n == 0:
        return 1
    if base == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[base]) * n) % 255])


def _mul_table() -> np.ndarray:
    """Full 256x256 product table; MUL_TABLE[a, b] = a*b in GF(256)."""
    a = np.arange(256)
    la = GF_LOG[a][:, None]
    lb = GF_LOG[a][None, :]
    prod = GF_EXP[(la + lb) % 255].astype(np.uint8)
    prod[0, :] = 0
    prod[:, 0] = 0
    prod.setflags(write=False)
    return prod


MUL_TABLE = _mul_table()


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(256). a: (m, k) uint8, b: (k, n) uint8 -> (m, n)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"gf_matmul: inner sizes differ ({k} vs {k2})")
    out = np.zeros((m, n), dtype=np.uint8)
    for j in range(k):
        # out ^= a[:, j] * b[j, :] elementwise over GF(256)
        out ^= MUL_TABLE[a[:, j][:, None], b[j, :][None, :]]
    return out


def gf_mat_invert(mat: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(256) by Gauss-Jordan elimination."""
    mat = np.array(mat, dtype=np.uint8)
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError(f"gf_mat_invert: not square {mat.shape}")
    work = np.concatenate([mat, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        # pivot
        if work[col, col] == 0:
            for r in range(col + 1, n):
                if work[r, col] != 0:
                    work[[col, r]] = work[[r, col]]
                    break
            else:
                raise np.linalg.LinAlgError("singular matrix over GF(256)")
        inv_p = gf_inv(int(work[col, col]))
        work[col] = MUL_TABLE[inv_p, work[col]]
        for r in range(n):
            if r != col and work[r, col] != 0:
                work[r] ^= MUL_TABLE[int(work[r, col]), work[col]]
    return work[:, n:].copy()


@functools.lru_cache(maxsize=None)
def rs_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic Vandermonde encoding matrix, (total, data) uint8.

    Top `data_shards` rows are the identity; the remaining rows generate
    parity. Read-only: it is shared by every caller through the cache.
    """
    if not 0 < data_shards < total_shards <= 256:
        raise ValueError(f"invalid RS shape ({data_shards}, {total_shards})")
    vm = np.zeros((total_shards, data_shards), dtype=np.uint8)
    for r in range(total_shards):
        for c in range(data_shards):
            vm[r, c] = gf_exp_pow(r, c)
    mat = gf_matmul(vm, gf_mat_invert(vm[:data_shards, :data_shards]))
    mat.setflags(write=False)
    return mat


def parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The (parity, data) sub-matrix that maps data shards to parity shards."""
    return rs_matrix(data_shards, data_shards + parity_shards)[data_shards:]


@functools.lru_cache(maxsize=None)
def decode_matrix(data_shards: int, total_shards: int,
                  present: tuple[int, ...]) -> np.ndarray:
    """Matrix mapping the first `data_shards` present shards -> data shards.

    `present` is the sorted tuple of available shard indices (>= data_shards
    of them). Returns (data_shards, data_shards) uint8 D such that
    data = D @ stack(shards[present[:data_shards]]). Read-only (cached).
    """
    if len(present) < data_shards:
        raise ValueError(
            f"too few shards to decode: {len(present)} < {data_shards}")
    rows = rs_matrix(data_shards, total_shards)
    mat = gf_mat_invert(rows[list(present[:data_shards]), :])
    mat.setflags(write=False)
    return mat
