"""Cross-volume EC batch scheduler: coalesce, dispatch on the mesh, demux
(the port of seaweedfs_tpu/parallel/batcher.py).

One mesh dispatch (ops/rs_mesh.py: one launch of K1's batch entry per
card) amortizes across many block-groups, but the work arrives one
block-group at a time from independent callers: concurrent ``ec.encode``
pipelines on different volumes, rebuild jobs, degraded reads. This module
is the funnel between them and the mesh:

  submit (any thread) -> bounded queue -> dispatcher thread coalesces a
  deadline-bounded batch -> one MeshCoder dispatch -> per-job futures.

Scheduling contract:
  - the submission queue is BOUNDED (overload becomes backpressure on
    the submitting pipeline, not memory growth);
  - every job carries a coalescing deadline (submit time + window); the
    dispatcher never waits past the EARLIEST deadline in its batch, so a
    lone job costs at most one window of latency and a burst fills a
    device-sized batch; jobs already queued when that deadline has passed
    (a backlog behind the previous dispatch) join the batch without
    waiting, up to max_batch;
  - jobs are ordered by QoS class (interactive > write > background —
    the ambient class is captured at submit) before dispatch, so a
    background rebuild flood cannot starve a degraded-read
    reconstruction sharing the mesh;
  - jobs are grouped by shape; a group of plain encodes is one launch
    under the scheduler's parity matrix, and a group that holds any
    matrix-carrying job (a rebuild, or an encode of another scheme) is one
    launch with a matrix per job, the plain encodes carrying the
    scheduler's parity matrix; a group whose jobs the mesh does
    not take (fewer than k source rows — an LRC group-local repair — or
    more than m output rows) is a routing decision: it runs on the CPU
    coder without benching the mesh, and counts as a cpu batch, not a
    fallback;
  - the CPU fallback is LOAD-BEARING: when a mesh dispatch raises, the
    failed batch and everything queued behind it drain through CpuCoderMT
    with bit-identical results, ``coder_fallbacks`` increments, the reason
    is classified (parallel/mesh.classify_failure) and logged, and the
    mesh is benched for a cooldown before being retried.

Three differences from the JAX package, on purpose: its constructor quietly
runs on the CPU coder when no mesh can be built; this one raises without a
card unless it is given device="cpu", a mesh (of CPU lanes, say) or a
mesh_coder (the fallback after a dispatch failure is the JAX package's).
And its dispatcher, once a batch's earliest deadline has passed, sends the
batch without looking at the queue, so under a backlog every job already
waiting goes out alone; this one takes them along. Its dispatcher also
groups by (kind, shape), so an RS encode and an LRC encode of the same
shape go out in two launches; here they share one.

Timing routes through utils/clockctl, so a test can install a virtual
clock; blocking primitives (queue waits) stay real.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np

from seaweedfs_tpu_torch.models.coder import (DEFAULT_SCHEME, ErasureCoder,
                                              RSScheme)
from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.qos import CLASSES, current_class
from seaweedfs_tpu_torch.utils import clockctl, glog, profiler
from seaweedfs_tpu_torch.utils.metrics import RED_BUCKETS, Histogram

# coalesced-batch-size buckets: powers of two up to the default
# max_batch, so "how full are my mesh dispatches" reads straight off
# the histogram
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

_STOP = object()
_CLASS_RANK = {c: i for i, c in enumerate(CLASSES)}


def _rank(cls: Optional[str]) -> int:
    # unknown/absent class sorts after background: un-classed work is
    # by definition not latency-sensitive
    return _CLASS_RANK.get(cls, len(CLASSES))


class _Job:
    __slots__ = ("kind", "data", "mat", "n", "cls", "submitted",
                 "deadline", "future")

    def __init__(self, kind: str, data: np.ndarray,
                 mat: Optional[np.ndarray], n: int, cls: Optional[str],
                 submitted: float):
        self.kind = kind          # "encode" | "rebuild"
        self.data = data          # (k, n4) uint8, column-padded to 4
        self.mat = mat            # rebuild only: (r, k) uint8
        self.n = n                # original column count pre-padding
        self.cls = cls
        self.submitted = submitted
        self.deadline = submitted  # + window_s, set by the scheduler
        self.future: Future = Future()


class EcBatchScheduler:
    """The funnel. Construct one per process; hand pipelines a BatchCoder
    facade over it."""

    def __init__(self, scheme: RSScheme = DEFAULT_SCHEME, *,
                 mesh_coder=None, mesh=None, device="cuda",
                 cpu_coder: Optional[ErasureCoder] = None,
                 window_s: float = 0.005, max_batch: int = 64,
                 queue_depth: int = 256, cooldown_s: float = 30.0,
                 on_fallback: Optional[Callable[[str], None]] = None):
        self.scheme = scheme
        self.window_s = window_s
        self.max_batch = max_batch
        self.cooldown_s = cooldown_s
        self._on_fallback = on_fallback
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        if mesh_coder is None:
            from seaweedfs_tpu_torch.ops.rs_mesh import MeshCoder
            mesh_coder = MeshCoder(scheme, mesh=mesh, device=device)
        self._mesh = mesh_coder
        if cpu_coder is None:
            from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoderMT
            cpu_coder = CpuCoderMT(scheme)
        self._cpu = cpu_coder
        # what a plain encode carries when it shares a launch with jobs
        # that bring their own matrix
        self._parity = gf256.parity_matrix(scheme.data_shards,
                                           scheme.parity_shards)
        self.fallback_reason: Optional[str] = None
        self._down_until = 0.0
        # counters are only written by the dispatcher thread (and stop());
        # readers (stats) tolerate a stale int
        self.jobs_total = 0
        self.batches_total = 0
        self.mesh_batches = 0
        self.cpu_batches = 0
        self.coder_fallbacks = 0
        self.max_coalesced = 0
        # submit -> dispatch wait, labelled by QoS class, and jobs per
        # dispatched batch; both ride stats() as mergeable snapshots
        self.wait_hist = Histogram(
            "ec_batch_wait_seconds",
            "submit-to-dispatch queueing delay", ("class",),
            buckets=RED_BUCKETS)
        self.size_hist = Histogram(
            "ec_batch_coalesced_jobs",
            "jobs coalesced per dispatched batch",
            buckets=BATCH_SIZE_BUCKETS)
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ec-batcher")
        self._thread.start()

    # ---- submission (any thread) ----

    def _submit(self, kind: str, data: np.ndarray,
                mat: Optional[np.ndarray], cls: Optional[str]) -> Future:
        if self._stopped:
            raise RuntimeError("EC batch scheduler is stopped")
        data = np.ascontiguousarray(data, dtype=np.uint8)
        n = data.shape[1]
        pad = (-n) % 4
        if pad:
            data = np.concatenate(
                [data, np.zeros((data.shape[0], pad), dtype=np.uint8)],
                axis=1)
        if cls is None:
            cls = current_class()
        job = _Job(kind, data, mat, n, cls, clockctl.monotonic())
        job.deadline = job.submitted + self.window_s
        self._q.put(job)  # bounded: blocks -> backpressure
        return job.future

    def submit_encode(self, data: np.ndarray,
                      cls: Optional[str] = None,
                      mat: Optional[np.ndarray] = None) -> Future:
        """(k, n) uint8 -> Future of (m, n) uint8 parity. RS parity by
        default; pass ``mat`` — an (m, k) GF(256) parity matrix of another
        scheme — to encode under it. Matrix-carrying encodes ride the same
        per-job-matrix path as rebuilds (parity IS mat @ data over
        GF(256)), so one drain can mix schemes and every future demuxes
        exactly its own rows."""
        if mat is not None:
            return self._submit("rebuild", data,
                                np.ascontiguousarray(mat, dtype=np.uint8),
                                cls)
        return self._submit("encode", data, None, cls)

    def submit_rebuild(self, srcdata: np.ndarray, rebuild_mat: np.ndarray,
                       cls: Optional[str] = None) -> Future:
        """(k, n) rows of the first k present shards + (r, k) rebuild
        matrix -> Future of (r, n) recovered rows."""
        return self._submit("rebuild", srcdata,
                            np.ascontiguousarray(rebuild_mat,
                                                 dtype=np.uint8), cls)

    def encode(self, data: np.ndarray, cls: Optional[str] = None,
               mat: Optional[np.ndarray] = None) -> np.ndarray:
        return self.submit_encode(data, cls, mat).result()

    def rebuild(self, srcdata: np.ndarray, rebuild_mat: np.ndarray,
                cls: Optional[str] = None) -> np.ndarray:
        return self.submit_rebuild(srcdata, rebuild_mat, cls).result()

    # ---- dispatcher ----

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is _STOP:
                return
            batch = [job]
            stopping = False
            while len(batch) < self.max_batch:
                # wait for more jobs only until the earliest deadline; past
                # it, still take every job already queued (a backlog that
                # built up behind the last dispatch), without waiting
                wait = min(j.deadline for j in batch) - clockctl.monotonic()
                try:
                    nxt = self._q.get(timeout=wait) if wait > 0 \
                        else self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stopping = True
                    break
                batch.append(nxt)
            self._dispatch(batch)
            if stopping:
                return

    def _mesh_healthy(self) -> bool:
        return (self._mesh is not None
                and clockctl.monotonic() >= self._down_until)

    def _dispatch(self, batch: list) -> None:
        self.jobs_total += len(batch)
        self.batches_total += 1
        self.max_coalesced = max(self.max_coalesced, len(batch))
        now = clockctl.monotonic()
        for j in batch:
            self.wait_hist.observe(max(0.0, now - j.submitted),
                                   j.cls or "-")
        self.size_hist.observe(len(batch))
        # QoS ordering: a group containing an interactive job dispatches
        # before an all-background group
        batch.sort(key=lambda j: (_rank(j.cls), j.deadline))
        groups: dict[tuple, list] = {}
        for j in batch:
            groups.setdefault(j.data.shape, []).append(j)
        # profiler attribution: the dispatcher thread does the batch's
        # work, so samples land under the batch's best (first) class
        with profiler.scope(cls=batch[0].cls or "background",
                            route="ec-batch"):
            for jobs in groups.values():
                self._run_group(jobs)

    def _mesh_compatible(self, jobs: list) -> bool:
        # the mesh takes (k, <= m)-shaped work; a job with fewer than k
        # source rows is a routing decision, not a mesh failure — send it
        # to the CPU coder without benching the mesh
        j = jobs[0]  # groups share data.shape by construction
        if j.data.shape[0] != self.scheme.data_shards:
            return False
        return all(jj.mat is None
                   or jj.mat.shape[0] <= self.scheme.parity_shards
                   for jj in jobs)

    def _run_group(self, jobs: list) -> None:
        if self._mesh_healthy() and self._mesh_compatible(jobs):
            try:
                self._run_mesh(jobs)
                self.mesh_batches += 1
                return
            except Exception as e:  # noqa: BLE001 — the fallback ladder
                from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
                self.coder_fallbacks += 1
                self.fallback_reason = mesh_mod.classify_failure(repr(e))
                self._down_until = clockctl.monotonic() + self.cooldown_s
                glog.warning(
                    "EC batcher: mesh dispatch failed (%s: %s); draining "
                    "through the CPU coder for %.0fs", type(e).__name__,
                    e, self.cooldown_s)
                if self._on_fallback is not None:
                    try:
                        self._on_fallback(self.fallback_reason or "error")
                    except Exception:  # noqa: BLE001 — observer only
                        pass
        self._run_cpu(jobs)
        self.cpu_batches += 1

    def _run_mesh(self, jobs: list) -> None:
        # the jobs go to the mesh as a list: it stages them straight into
        # its pinned buffer, with no stacked copy in between
        datas = [j.data for j in jobs]
        if all(j.mat is None for j in jobs):
            out = self._mesh.encode_batch(datas)
            recs = [out[i] for i in range(len(jobs))]
        else:
            recs = self._mesh.rebuild_batch(
                datas, [self._parity if j.mat is None else j.mat
                        for j in jobs])
        for j, rec in zip(jobs, recs):
            j.future.set_result(np.ascontiguousarray(rec[:, :j.n]))

    def _run_cpu(self, jobs: list) -> None:
        for j in jobs:
            try:
                if j.kind == "encode":
                    out = np.asarray(self._cpu.encode_array(j.data))
                else:
                    out = np.asarray(
                        self._cpu.reconstruct_rows(j.data, j.mat))
                j.future.set_result(np.ascontiguousarray(out[:, :j.n]))
            except BaseException as e:  # noqa: BLE001 — per-job demux
                j.future.set_exception(e)

    # ---- lifecycle / observability ----

    def stop(self) -> None:
        """Stop the dispatcher; anything still queued drains through the
        CPU coder so no submitted future is ever abandoned."""
        if self._stopped:
            return
        self._stopped = True
        self._q.put(_STOP)
        self._thread.join(timeout=10)
        leftovers = []
        while True:
            try:
                j = self._q.get_nowait()
            except queue.Empty:
                break
            if j is not _STOP:
                leftovers.append(j)
        if leftovers:
            self._run_cpu(leftovers)
            self.cpu_batches += 1

    def stats(self) -> dict:
        return {
            "window_s": self.window_s,
            "max_batch": self.max_batch,
            "queue_depth": self._q.maxsize,
            "queued": self._q.qsize(),
            "mesh_devices": self._mesh.n_devices,
            "mesh_healthy": self._mesh_healthy(),
            "jobs_total": self.jobs_total,
            "batches_total": self.batches_total,
            "mesh_batches": self.mesh_batches,
            "cpu_batches": self.cpu_batches,
            "coder_fallbacks": self.coder_fallbacks,
            "max_coalesced": self.max_coalesced,
            "fallback_reason": self.fallback_reason,
            "wait_hist": self.wait_hist.snapshot(),
            "size_hist": self.size_hist.snapshot(),
        }


class BatchCoder(ErasureCoder):
    """ErasureCoder facade over an EcBatchScheduler — a drop-in for the
    pipeline coder seam. Each pipeline keeps calling encode_into /
    reconstruct_rows per block-group exactly as with any host coder (it
    has no CUDA device, so the pipelines take their host lane); the facade
    turns those calls into scheduler submissions, so N concurrent volume
    pipelines coalesce into device-sized batches without knowing about
    each other.

    Pass a ``scheme`` of another code — another RS shape, or an
    LrcScheme — to get a facade for it sharing the SAME scheduler: its
    encodes and rebuilds carry their own GF matrices, so volumes of both
    codes coalesce into one drain and each future demuxes exactly its own
    rows. An LRC plan that reads fewer than k sources (a group-local
    repair) is routed to the scheduler's host coder."""

    def __init__(self, scheduler: EcBatchScheduler,
                 scheme: Optional[RSScheme] = None):
        if scheme is None:
            scheme = scheduler.scheme
        super().__init__(scheme)
        self.scheduler = scheduler
        from seaweedfs_tpu_torch.models.coder import (coder_name_for_scheme,
                                                      make_coder)
        # matrix derivation only: the work goes through the scheduler
        self._host = make_coder(coder_name_for_scheme(scheme, "cpu"), scheme)
        # None: the scheduler's own RS parity path
        self._encode_mat = None if scheme == scheduler.scheme else \
            np.ascontiguousarray(self._host._parity)

    def encode_array(self, data: np.ndarray) -> np.ndarray:
        return self.scheduler.encode(data, mat=self._encode_mat)

    def encode_into(self, data: np.ndarray, out: np.ndarray) -> np.ndarray:
        out[:] = self.scheduler.encode(data, mat=self._encode_mat)
        return out

    def encode(self, shards: Sequence[bytes]) -> list[bytes]:
        k = self.scheme.data_shards
        data = np.stack([np.frombuffer(bytes(shards[i]), dtype=np.uint8)
                         for i in range(k)])
        parity = self.scheduler.encode(data, mat=self._encode_mat)
        return [bytes(shards[i]) for i in range(k)] + \
            [parity[i].tobytes() for i in range(self.scheme.parity_shards)]

    def rebuild_matrix(self, present: Sequence[int],
                       missing: Sequence[int]) -> np.ndarray:
        return self._host.rebuild_matrix(present, missing)

    def reconstruct_rows(self, srcdata: np.ndarray,
                         rebuild_mat: np.ndarray,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        rec = self.scheduler.rebuild(srcdata, rebuild_mat)
        if out is not None:
            out[:] = rec
            return out
        return rec

    def _rebuild_plan(self, present: Sequence[int], missing: Sequence[int]
                      ) -> tuple[list[int], np.ndarray]:
        # a plan-capable host (LRC) chooses its own source subset — the
        # first k of sorted(present) can be rank-deficient for it
        if hasattr(self._host, "plan_rebuild"):
            return self._host.plan_rebuild(present, missing)
        return (sorted(present)[:self.scheme.data_shards],
                self.rebuild_matrix(present, missing))

    def _recover(self, shards: Sequence[Optional[bytes]],
                 wanted: list[int]) -> list[Optional[bytes]]:
        k, total = self.scheme.data_shards, self.scheme.total_shards
        present = [i for i in range(total) if shards[i] is not None]
        if len(present) < k and not hasattr(self._host, "plan_rebuild"):
            raise ValueError(f"too few shards: {len(present)} < {k}")
        out = [bytes(s) if s is not None else None for s in shards]
        if not wanted:
            return out
        src_sids, mat = self._rebuild_plan(present, wanted)
        src = np.stack([np.frombuffer(bytes(shards[i]), dtype=np.uint8)
                        for i in src_sids])
        rec = self.scheduler.rebuild(src, mat)
        for r, i in enumerate(wanted):
            out[i] = rec[r].tobytes()
        return out

    def reconstruct(self, shards: Sequence[Optional[bytes]]) -> list[bytes]:
        return self._recover(
            shards, [i for i, s in enumerate(shards) if s is None])

    def reconstruct_data(self, shards: Sequence[Optional[bytes]]
                         ) -> list[Optional[bytes]]:
        return self._recover(
            shards, [i for i in range(self.scheme.data_shards)
                     if shards[i] is None])
