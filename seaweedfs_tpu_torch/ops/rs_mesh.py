"""Mesh-split Reed-Solomon coder: a BATCH of block-groups per dispatch (the
port of seaweedfs_tpu/ops/rs_mesh.py).

The single-volume coders encode one (k, n) block-group per call, so
concurrent ``ec.encode`` pipelines and repair jobs each pay a kernel
launch. MeshCoder takes a batch of B independent block-groups — typically
coalesced from several volumes by parallel/batcher.py — and splits it over
a 1-D device mesh (parallel/mesh.batch_mesh): device d takes a contiguous
slice of the jobs and runs it as ONE launch of K1's batch entry
(ops/rs_cuda.gf_apply_batch) on its current stream, with no folds between
devices.

  - encode: every job shares the scheme's parity matrix;
  - rebuild: one (r_i, k) matrix per job, zero rows padding each to m, so
    jobs with different loss patterns ride one launch.

On the host a batch is staged once into a pinned buffer, copied to each
device without blocking, and its outputs come back into one pinned buffer
that the returned arrays are views of. The JAX package's counterparts are
batch_encode_fn and batch_apply_fn, XLA programs (jit of vmap) rather than
Pallas kernels. Output is bit-identical to CpuCoder in all modes — GF(256)
has no rounding to disagree about, and the tests hold it to that. A mesh of
CPU lanes (device="cpu") runs the same splitting on the kernel's plain
version.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from seaweedfs_tpu_torch.models.coder import (DEFAULT_SCHEME, ErasureCoder,
                                              LrcScheme, RSScheme,
                                              register_coder)
from seaweedfs_tpu_torch.ops import gf256, rs_cuda
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

# (B, k, n) uint8, or B equal-shaped (k, n) uint8 arrays
Jobs = Union[np.ndarray, Sequence[np.ndarray]]


def _jobs_shape(jobs: Jobs) -> tuple[int, int, int]:
    if isinstance(jobs, np.ndarray):
        if jobs.ndim != 3:
            raise ValueError(f"batch must be (B, k, n), got {jobs.shape}")
        return jobs.shape
    if not len(jobs):
        raise ValueError("empty batch")
    k, n = np.shape(jobs[0])
    if any(np.shape(j) != (k, n) for j in jobs):
        raise ValueError("jobs of one batch must share their shape")
    return len(jobs), k, n


def _stage(jobs: Jobs, shape: tuple[int, int, int],
           pin: bool) -> torch.Tensor:
    """The batch as one (B, k, n) uint8 host tensor: pinned when it goes
    to a card (so the copies there do not block), else a view of the
    caller's array where it is already one contiguous block."""
    if not pin and isinstance(jobs, np.ndarray) and jobs.dtype == np.uint8 \
            and jobs.flags.c_contiguous and jobs.flags.writeable:
        return torch.from_numpy(jobs)
    host = torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
    dst = host.numpy()
    if isinstance(jobs, np.ndarray):
        np.copyto(dst, jobs, casting="unsafe")
    else:
        for i, j in enumerate(jobs):
            dst[i] = j
    return host


def _apply_on_mesh(mesh: mesh_mod.Mesh, jobs: Jobs,
                        mat: np.ndarray) -> np.ndarray:
    """out[b] = mat_b x jobs[b] over GF(256) for every job: (B, k, n) ->
    (B, m, n), `mat` one (m, k) matrix shared by the jobs or (B, m, k)
    with one per job. The jobs are split in contiguous slices over the
    mesh's devices, one gf_apply_batch launch per device that has jobs,
    each on its device's current stream; returns after every device is
    done, with a host array (a view of one pinned buffer when the mesh
    holds cards)."""
    B, k, n = _jobs_shape(jobs)
    per_job = mat.ndim == 3
    m = mat.shape[-2]
    devs = list(mesh.devices.flat)
    pin = any(d.type == "cuda" for d in devs)
    host_in = _stage(jobs, (B, k, n), pin)
    host_out = torch.empty((B, m, n), dtype=torch.uint8, pin_memory=pin)
    done = []
    for dev, span in zip(devs, np.array_split(np.arange(B), len(devs))):
        if not len(span):
            continue
        b0, b1 = int(span[0]), int(span[-1]) + 1
        mats = mat[b0:b1] if per_job else mat
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                x = host_in[b0:b1].to(dev, non_blocking=True)
                res = rs_cuda.gf_apply_batch(mats, x)
                host_out[b0:b1].copy_(res, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
                done.append(ev)
        else:
            rs_cuda.gf_apply_batch(mats, host_in[b0:b1], host_out[b0:b1])
    for ev in done:
        ev.synchronize()
    return host_out.numpy()


@register_coder("mesh")
class MeshCoder(ErasureCoder):
    """ErasureCoder whose unit of dispatch is a batch of block-groups
    split across a 1-D device mesh. The scalar ErasureCoder API is a batch
    of one (bit-identical, just not faster); the batch API is what
    parallel/batcher.py feeds. Without a `mesh`, it takes batch_mesh over
    `n_devices` cards (all by default), or CPU lanes for device='cpu'; it
    raises when no card is present and the caller did not ask for the
    CPU."""

    def __init__(self, scheme: RSScheme = DEFAULT_SCHEME,
                 n_devices: Optional[int] = None,
                 mesh: Optional[mesh_mod.Mesh] = None, device="cuda"):
        if isinstance(scheme, LrcScheme):
            raise ValueError(f"{scheme}: an RS coder; LRC codes on "
                             "ops/lrc.LrcCoder or through BatchCoder")
        super().__init__(scheme)
        self.mesh = mesh if mesh is not None else \
            mesh_mod.batch_mesh(n_devices, device=device)
        self.parity = gf256.parity_matrix(scheme.data_shards,
                                          scheme.parity_shards)
        # host-side helper for rebuild-matrix derivation (pure numpy)
        from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoder
        self._host = CpuCoder(scheme)

    @property
    def n_devices(self) -> int:
        return self.mesh.devices.size

    def _check(self, shape: tuple[int, int, int]) -> None:
        _, k, n = shape
        if k != self.scheme.data_shards:
            raise ValueError(f"{k} rows per job for {self.scheme}")
        if n % 4:
            raise ValueError(f"columns must be a multiple of 4, got {n}")

    # ---- batch API (the batcher's entry points) ----

    def encode_batch(self, batch: Jobs) -> np.ndarray:
        """(B, k, n) uint8 -> (B, m, n) uint8 parity, one launch per
        device. n must be a multiple of 4 (the JAX package's uint32
        lanes)."""
        self._check(_jobs_shape(batch))
        return _apply_on_mesh(self.mesh, batch, self.parity)

    def rebuild_batch(self, srcdata: Jobs,
                      mats: Sequence[np.ndarray]) -> list[np.ndarray]:
        """srcdata: (B, k, n) uint8 — per job, rows of the first k present
        shards. mats[i]: (r_i, k) uint8 rebuild matrix (from
        rebuild_matrix(); r_i <= parity_shards). Returns a list of
        (r_i, n) uint8 recovered rows, one per job, in one launch per
        device even when jobs lost different shards."""
        shape = _jobs_shape(srcdata)
        self._check(shape)
        B, k, _ = shape
        if len(mats) != B:
            raise ValueError(f"{len(mats)} matrices for {B} jobs")
        m = self.scheme.parity_shards
        coeff = np.zeros((B, m, k), dtype=np.uint8)
        rows = []
        for i, mt in enumerate(mats):
            mt = np.asarray(mt, dtype=np.uint8)
            if mt.ndim != 2 or mt.shape[1] != k or not 0 < mt.shape[0] <= m:
                raise ValueError(f"job {i}: rebuild matrix {mt.shape} for "
                                 f"{self.scheme}")
            coeff[i, :mt.shape[0]] = mt
            rows.append(mt.shape[0])
        out = _apply_on_mesh(self.mesh, srcdata, coeff)
        return [out[i, :r] for i, r in enumerate(rows)]

    # ---- scalar ErasureCoder API (batch of one) ----

    def encode_array(self, data: np.ndarray) -> np.ndarray:
        return self.encode_batch(
            np.ascontiguousarray(data, dtype=np.uint8)[None])[0]

    def encode_into(self, data: np.ndarray, out: np.ndarray) -> np.ndarray:
        out[:] = self.encode_array(data)
        return out

    def encode(self, shards: Sequence[bytes]) -> list[bytes]:
        k = self.scheme.data_shards
        n = len(shards[0])
        data = np.zeros((k, n + (-n) % 4), dtype=np.uint8)
        for i in range(k):
            data[i, :n] = np.frombuffer(bytes(shards[i]), dtype=np.uint8)
        parity = self.encode_batch(data[None])[0]
        return [bytes(shards[i]) for i in range(k)] + \
            [parity[i, :n].tobytes() for i in range(self.scheme.parity_shards)]

    def rebuild_matrix(self, present: Sequence[int],
                       missing: Sequence[int]) -> np.ndarray:
        return self._host.rebuild_matrix(present, missing)

    def reconstruct_rows(self, srcdata: np.ndarray,
                         rebuild_mat: np.ndarray,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        rec = self.rebuild_batch(
            np.ascontiguousarray(srcdata, dtype=np.uint8)[None],
            [rebuild_mat])[0]
        if out is not None:
            out[:] = rec
            return out
        return rec

    def _recover(self, shards: Sequence[Optional[bytes]],
                 wanted: list[int]) -> list[Optional[bytes]]:
        """Every `wanted` shard from the first k present ones, in one
        launch: rebuild_matrix expresses data AND parity losses directly
        as combinations of them."""
        k, total = self.scheme.data_shards, self.scheme.total_shards
        present = [i for i in range(total) if shards[i] is not None]
        if len(present) < k:
            raise ValueError(f"too few shards: {len(present)} < {k}")
        out = [bytes(s) if s is not None else None for s in shards]
        if not wanted:
            return out
        n = len(shards[present[0]])
        src = np.zeros((k, n + (-n) % 4), dtype=np.uint8)
        for r, i in enumerate(present[:k]):
            src[r, :n] = np.frombuffer(bytes(shards[i]), dtype=np.uint8)
        rec = self.rebuild_batch(
            src[None], [self.rebuild_matrix(present, wanted)])[0]
        for r, i in enumerate(wanted):
            out[i] = rec[r, :n].tobytes()
        return out

    def reconstruct(self, shards: Sequence[Optional[bytes]]) -> list[bytes]:
        return self._recover(
            shards, [i for i, s in enumerate(shards) if s is None])

    def reconstruct_data(self, shards: Sequence[Optional[bytes]]
                         ) -> list[Optional[bytes]]:
        return self._recover(
            shards, [i for i in range(self.scheme.data_shards)
                     if shards[i] is None])
