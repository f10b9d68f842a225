"""Distributed EC compute over a device mesh (the port of
seaweedfs_tpu/parallel/distributed.py).

One process drives every device of the mesh, as JAX's single-controller
mesh does:
  - encode: a batch of volumes x stripe length is split over ('data',
    'seq'); parity is purely columnwise, so each device runs one launch of
    K1's batch entry on its block of volumes and columns, with no fold.
    The JAX program replicates that work along 'shard'; here the first
    device along 'shard' does it.
  - degraded rebuild: surviving shard rows are split along 'shard' (like
    the reference's shards on different servers,
    weed/storage/store_ec.go:328-382) and columns along 'seq'. Each device
    applies its (n_out, shards_per_device) slice of the coefficients to
    its rows with K1 — its partial GF(256) contribution — and the partials
    are gathered to the mesh's first device and XOR-folded there. XOR is
    GF(2) addition, which no sum-reduction expresses; the fold is an
    elementwise ``^`` on tensors, as the JAX package's is XLA outside any
    Pallas kernel.

The JAX package multiplies by a traced coefficient in ``_gf_mul_dynamic``;
it has no counterpart here, because K1 takes its coefficients at run time.
"""

from __future__ import annotations

import numpy as np
import torch

from seaweedfs_tpu_torch.models.coder import RSScheme
from seaweedfs_tpu_torch.ops import gf256, rs_cuda
from seaweedfs_tpu_torch.parallel.mesh import Mesh


def _spans(total: int, parts: int, unit: int = 1) -> list[tuple[int, int]]:
    """[lo, hi) ranges splitting `total` into `parts` near-equal pieces,
    cut on multiples of `unit`."""
    cuts = np.array_split(np.arange(total // unit), parts)
    return [(int(c[0]) * unit, (int(c[-1]) + 1) * unit) if len(c) else
            (0, 0) for c in cuts]


def _to(device: torch.device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def distributed_encode(scheme: RSScheme, mesh: Mesh,
                       batch: np.ndarray) -> np.ndarray:
    """batch: (B, k, n) uint8 -> (B, m, n) uint8 parity, split over
    ('data', 'seq'): one K1 batch launch per device that has work."""
    B, k, n = batch.shape
    if k != scheme.data_shards or n % 4:
        raise ValueError(f"batch {batch.shape} for {scheme}: need k = "
                         f"{scheme.data_shards} rows, n a multiple of 4")
    parity = gf256.parity_matrix(k, scheme.parity_shards)
    out = np.empty((B, scheme.parity_shards, n), dtype=np.uint8)
    devs = mesh.devices
    parts = []
    for d, (b0, b1) in enumerate(_spans(B, mesh.shape["data"])):
        for q, (c0, c1) in enumerate(_spans(n, mesh.shape["seq"], 4)):
            if b1 > b0 and c1 > c0:
                dev = devs[d, 0, q]
                res = rs_cuda.gf_apply_batch(
                    parity, _to(dev, batch[b0:b1, :, c0:c1]))
                parts.append(((b0, b1, c0, c1), res))
    for (b0, b1, c0, c1), res in parts:
        out[b0:b1, :, c0:c1] = res.cpu().numpy()
    return out


def make_rebuild_coeff(scheme: RSScheme, present: tuple[int, ...],
                       wanted: tuple[int, ...], padded_s: int) -> np.ndarray:
    """Host-side coefficient matrix for distributed_rebuild: wanted rows
    (data or parity shard ids) as GF(256) combinations of the first k
    present shards; missing/unused columns are zero. (n_out, padded_s)
    uint32, as the JAX package returns it."""
    k, total = scheme.data_shards, scheme.total_shards
    dm = gf256.decode_matrix(k, total, present)  # (k, k)
    full = gf256.rs_matrix(k, total)  # (total, k)
    src = list(present[:k])
    coeff = np.zeros((len(wanted), padded_s), dtype=np.uint32)
    for r, w in enumerate(wanted):
        # row of (w as combo of data shards) @ (data shards as combo of src)
        combo = gf256.gf_matmul(full[w][None, :], dm)[0]  # (k,) over src
        for j, s in enumerate(src):
            coeff[r, s] = int(combo[j])
    return coeff


def distributed_rebuild(scheme: RSScheme, mesh: Mesh,
                        shards: dict[int, np.ndarray],
                        wanted: tuple[int, ...]) -> np.ndarray:
    """Rebuild `wanted` shard rows from surviving `shards` ({id: (n,)
    uint8}) across the mesh: K1 partial products per ('shard', 'seq')
    device, gathered to the first device and XOR-folded there. Returns
    (len(wanted), n) uint8."""
    k, total = scheme.data_shards, scheme.total_shards
    present = tuple(sorted(shards))
    if len(present) < k:
        raise ValueError(f"too few shards: {len(present)} < {k}")
    n = len(next(iter(shards.values())))
    if n % 4:
        raise ValueError(f"columns must be a multiple of 4, got {n}")
    shard_axis, seq_axis = mesh.shape["shard"], mesh.shape["seq"]
    padded_s = -(-total // shard_axis) * shard_axis
    spd = padded_s // shard_axis

    rows = np.zeros((padded_s, n), dtype=np.uint8)
    for i, a in shards.items():
        rows[i] = np.asarray(a, dtype=np.uint8)
    coeff = make_rebuild_coeff(scheme, present, wanted, padded_s) \
        .astype(np.uint8)

    first = mesh.devices.flat[0]
    out = np.empty((len(wanted), n), dtype=np.uint8)
    for q, (c0, c1) in enumerate(_spans(n, seq_axis, 4)):
        if c1 == c0:
            continue
        acc = None
        for s in range(shard_axis):
            dev = mesh.devices[0, s, q]
            part = rs_cuda.gf_apply(coeff[:, s * spd:(s + 1) * spd],
                                    _to(dev, rows[s * spd:(s + 1) * spd,
                                                  c0:c1]))
            part = part.to(first)
            acc = part if acc is None else acc ^ part
        out[:, c0:c1] = acc.cpu().numpy()
    return out
