"""The port's mesh coder and cross-volume batch scheduler against
seaweedfs_tpu's, byte for byte (ops/rs_mesh.py, parallel/mesh.py,
parallel/batcher.py).

1. MeshCoder on meshes of 1, 2 and 4 CPU lanes (torch.device("cpu")
   repeated: the kernel's plain version, split over the lanes as over
   cards) against the JAX MeshCoder on the 8-device virtual CPU mesh that
   tests/conftest.py forces: batched encode with an odd batch, rebuilds
   with different loss patterns in one launch per lane (counted through a
   patched wrapper: CPU tensors do not count as launches), the scalar
   bytes API;
2. parallel/mesh: the probe's cache and the classify_failure vocabulary;
3. EcBatchScheduler and BatchCoder, ported from tests/test_mesh_batcher.py
   (the cases that need no server or repair queue): coalescing and
   demux, odd columns, QoS ordering, routing of short jobs, a mesh that
   fails mid-run draining through the CPU, stop() draining, the facade,
   and the LRC facade with RS and LRC jobs in one drain;
4. the facade driving the port's pipelined encode and rebuild of volumes
   the JAX package wrote, concurrently through one scheduler, against the
   JAX pipelines with the JAX BatchCoder.

Every result is compared with the JAX package's on the same seeded numpy
inputs. Tolerance: byte-exact. No test asserts a wall time.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.models.coder import RSScheme as JRSScheme
from seaweedfs_tpu.ops.lrc import LrcCoder as JLrcCoder
from seaweedfs_tpu.ops.rs_cpu import CpuCoder as JCpuCoder
from seaweedfs_tpu.ops.rs_mesh import MeshCoder as JMeshCoder
from seaweedfs_tpu.parallel import batcher as jbatcher
from seaweedfs_tpu.parallel import streaming as jstreaming
from seaweedfs_tpu.storage import needle as jneedle
from seaweedfs_tpu.storage import volume as jvol
from seaweedfs_tpu_torch.models.coder import (DEFAULT_SCHEME, LrcScheme,
                                              RSScheme, make_coder)
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.ops.rs_mesh import MeshCoder
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
from seaweedfs_tpu_torch.parallel import streaming
from seaweedfs_tpu_torch.parallel.batcher import BatchCoder, EcBatchScheduler
from seaweedfs_tpu_torch.qos import BACKGROUND, INTERACTIVE, class_scope
from seaweedfs_tpu_torch.storage.erasure_coding import layout

JCPU = JCpuCoder(JRSScheme(10, 4))
K, M, TOTAL = 10, 4, 14


def _batch(b, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(b, K, n), dtype=np.uint8)


def _mesh_coder(lanes):
    return MeshCoder(mesh=mesh_mod.batch_mesh(lanes, device="cpu"))


def _cpu_scheduler(**kw):
    return EcBatchScheduler(mesh=mesh_mod.batch_mesh(2, device="cpu"), **kw)


@pytest.fixture
def batch_calls(monkeypatch):
    """Counts calls of K1's batch entry: one per lane with jobs is one
    launch per card on a mesh of cards."""
    calls = []
    real = rs_cuda.gf_apply_batch

    def counted(mats, data, out=None):
        calls.append(data.shape[0])
        return real(mats, data, out)

    monkeypatch.setattr(rs_cuda, "gf_apply_batch", counted)
    return calls


# --------------------------------------------------------- MeshCoder

@pytest.fixture(scope="module")
def jmesh():
    """The JAX MeshCoder on the whole 8-device virtual mesh (each of its
    programs compiles once per shape, so every port lane count is held
    against the same JAX results)."""
    return JMeshCoder(JRSScheme(10, 4), n_devices=8)


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("b", [1, 5])
def test_encode_batch_matches_jax_mesh(lanes, b, batch_calls, jmesh):
    """B=5 over 2 and 4 lanes splits unevenly; the JAX coder zero-pads
    its lanes instead."""
    data = _batch(b, 4096, seed=b)
    got = _mesh_coder(lanes).encode_batch(data)
    assert got.shape == (b, M, 4096)
    assert np.array_equal(got, jmesh.encode_batch(data))
    assert batch_calls == [len(s) for s in np.array_split(np.arange(b), lanes)
                           if len(s)]


LOSSES = [(0, 3, 7, 9), (10, 11, 12, 13), (0, 5, 11, 13), (2,), (12,)]


@pytest.fixture(scope="module")
def heterogeneous(jmesh):
    """Jobs with different survivor patterns (data-only, parity-only,
    mixed, single-shard) and the JAX MeshCoder's rebuild of them."""
    data = _batch(len(LOSSES), 4096, seed=1)
    srcs, mats = [], []
    for i, drop in enumerate(LOSSES):
        full = np.concatenate([data[i], JCPU.encode_array(data[i])])
        present = [j for j in range(TOTAL) if j not in drop]
        srcs.append(full[present[:K]])
        mats.append(JCPU.rebuild_matrix(present, list(drop)))
    return np.stack(srcs), mats, jmesh.rebuild_batch(np.stack(srcs), mats)


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_rebuild_batch_heterogeneous_loss_one_launch_per_lane(
        lanes, batch_calls, heterogeneous):
    """The jobs ride one launch per lane."""
    srcs, mats, want = heterogeneous
    losses = LOSSES
    got = _mesh_coder(lanes).rebuild_batch(srcs, mats)
    assert len(got) == len(want) == len(losses)
    for g, w, drop in zip(got, want, losses):
        assert g.shape == (len(drop), 4096)
        assert np.array_equal(g, w)
    assert len(batch_calls) == min(lanes, len(losses))
    assert sum(batch_calls) == len(losses)


@pytest.mark.parametrize("lanes", [1, 2])
def test_mesh_coder_scalar_bytes_api_matches_jax(lanes, jmesh):
    rng = np.random.default_rng(2)
    mc = _mesh_coder(lanes)
    jmc = jmesh
    # 4093 columns pad to the 4096 of the other cases' JAX programs
    shards = [rng.integers(0, 256, 4093, dtype=np.uint8).tobytes()
              for _ in range(K)]
    full = mc.encode(shards)
    assert full == [bytes(s) for s in jmc.encode(shards)]
    holes = [s if i not in (0, 5, 12) else None for i, s in enumerate(full)]
    assert mc.reconstruct(holes) == [bytes(s) for s in
                                     jmc.reconstruct(holes)]
    part = [s if i != 3 else None for i, s in enumerate(full)]
    assert mc.reconstruct_data(part)[3] == bytes(jmc.reconstruct_data(part)[3])
    data = _batch(1, 4096, seed=3)[0]
    assert np.array_equal(mc.encode_array(data), jmc.encode_array(data))
    out = np.empty((M, 4096), np.uint8)
    assert np.array_equal(mc.encode_into(data, out), jmc.encode_array(data))
    present = [i for i in range(TOTAL) if i not in (1, 11)]
    mat = mc.rebuild_matrix(present, [1, 11])
    assert np.array_equal(mat, jmc.rebuild_matrix(present, [1, 11]))
    full_rows = np.concatenate([data, jmc.encode_array(data)])
    assert np.array_equal(mc.reconstruct_rows(full_rows[present[:K]], mat),
                          full_rows[[1, 11]])


def test_mesh_coder_registered_and_checks_its_input():
    mc = make_coder("mesh", device="cpu")
    assert isinstance(mc, MeshCoder) and mc.n_devices == 1
    with pytest.raises(ValueError, match="multiple of 4"):
        mc.encode_batch(_batch(2, 10))
    with pytest.raises(ValueError, match="rows per job"):
        mc.encode_batch(np.zeros((2, 9, 16), np.uint8))
    with pytest.raises(ValueError, match="rebuild matrix"):
        mc.rebuild_batch(_batch(1, 16), [np.ones((5, K), np.uint8)])
    with pytest.raises(ValueError, match="LRC"):
        MeshCoder(LrcScheme(), device="cpu")


# ------------------------------------------------------ parallel/mesh

def test_probe_is_cached_and_classified(monkeypatch):
    monkeypatch.setattr(mesh_mod, "_probe_cache", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p1 = mesh_mod.probe()
    assert not p1["ok"] and p1["n_devices"] == 0
    assert p1["fallback_reason"] == "probe_error" and "no CUDA" in p1["error"]
    assert mesh_mod.probe() == p1  # cached
    # a probe that reaches its devices round-trips the tiny tensor
    monkeypatch.setattr(mesh_mod, "devices",
                        lambda n=None: mesh_mod.cpu_lanes(8))
    p2 = mesh_mod.probe(force=True)
    assert p2["ok"] and p2["n_devices"] == 8 and p2["fallback_reason"] is None
    assert mesh_mod.probe() == p2


def test_classify_failure_vocabulary():
    assert mesh_mod.classify_failure(None) is None
    assert mesh_mod.classify_failure("jax device_put rejected") == \
        "device_put"
    assert mesh_mod.classify_failure("DeadlineExceeded: timeout") == \
        "relay_timeout"
    assert mesh_mod.classify_failure("boom") == "probe_error"


@pytest.mark.parametrize("shape,axes", [((8,), ("batch",)),
                                        ((2, 1, 4), mesh_mod.AXES),
                                        (None, mesh_mod.AXES)])
def test_cpu_mesh_shapes(shape, axes):
    m = mesh_mod.make_mesh(8, axis_names=axes, shape=shape, device="cpu")
    assert m.devices.size == 8 and m.axis_names == axes
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert m.shape[axes[-1]] == (shape or mesh_mod._default_shape(8, 3))[-1]
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(8, shape=(3, 1, 3), device="cpu")


# -------------------------------------------------- EcBatchScheduler

def test_scheduler_coalesces_and_demuxes():
    sched = _cpu_scheduler(window_s=0.05)
    try:
        datas = [_batch(1, 1000, seed=i)[0] for i in range(7)]
        futs = [sched.submit_encode(d) for d in datas]
        for d, f in zip(datas, futs):
            assert np.array_equal(f.result(timeout=30), JCPU.encode_array(d))
        st = sched.stats()
        assert st["jobs_total"] == 7 and st["mesh_devices"] == 2
        assert st["mesh_batches"] >= 1 and st["cpu_batches"] == 0
        assert st["coder_fallbacks"] == 0
        assert st["max_coalesced"] >= 2  # the window actually coalesced
        sizes = st["size_hist"]["series"][0][1]
        assert sum(sizes) == st["batches_total"]
        assert st["wait_hist"]["label_names"] == ["class"]
    finally:
        sched.stop()


@pytest.mark.parametrize("n", [997, 1, 4098])
def test_scheduler_pads_odd_columns(n):
    sched = _cpu_scheduler(window_s=0.005)
    try:
        d = _batch(1, n, seed=3)[0]
        assert np.array_equal(sched.encode(d), JCPU.encode_array(d))
        present = [i for i in range(TOTAL) if i != 4]
        full = np.concatenate([d, JCPU.encode_array(d)])
        mat = JCPU.rebuild_matrix(present, [4])
        assert np.array_equal(sched.rebuild(full[present[:K]], mat),
                              full[[4]])
    finally:
        sched.stop()


class _Recorder:
    """Mesh stand-in that records dispatch shapes and answers on the JAX
    package's CPU coder."""
    n_devices = 1

    def __init__(self):
        self.shapes = []

    def encode_batch(self, b):
        b = np.stack(b)
        self.shapes.append(b.shape)
        return np.stack([JCPU.encode_array(x) for x in b])

    def rebuild_batch(self, s, mats):
        return [JCPU.reconstruct_rows(x, mt) for x, mt in zip(s, mats)]


def test_scheduler_orders_by_qos_class():
    """An interactive job submitted AFTER a background job dispatches
    first (distinct shapes -> distinct dispatch groups, so group order is
    observable)."""
    rec = _Recorder()
    sched = EcBatchScheduler(mesh_coder=rec, window_s=0.4)
    try:
        with class_scope(BACKGROUND):
            f_bg = sched.submit_encode(_batch(1, 16, seed=4)[0])
        with class_scope(INTERACTIVE):
            f_int = sched.submit_encode(_batch(1, 8, seed=5)[0])
        f_bg.result(timeout=30)
        f_int.result(timeout=30)
        assert rec.shapes[0][2] == 8, rec.shapes  # interactive first
        labels = {s[0][0] for s in sched.stats()["wait_hist"]["series"]}
        assert labels == {BACKGROUND, INTERACTIVE}
    finally:
        sched.stop()


def test_backlog_coalesces_past_the_deadline():
    """Jobs that queued up while a dispatch ran go out together in the
    next batch, although their deadlines have passed (the JAX package's
    dispatcher sends each of them alone)."""
    gate = threading.Event()

    class _Held(_Recorder):
        def encode_batch(self, b):
            gate.wait(5)
            return super().encode_batch(b)

    rec = _Held()
    sched = EcBatchScheduler(mesh_coder=rec, window_s=0.001, max_batch=4)
    try:
        first = sched.submit_encode(_batch(1, 64, seed=30)[0])
        time.sleep(0.05)  # the dispatcher is held inside the first batch
        datas = [_batch(1, 64, seed=31 + i)[0] for i in range(6)]
        futs = [sched.submit_encode(d) for d in datas]
        time.sleep(0.05)  # every deadline has passed
        gate.set()
        first.result(timeout=30)
        for d, f in zip(datas, futs):
            assert np.array_equal(f.result(timeout=30), JCPU.encode_array(d))
        assert [s[0] for s in rec.shapes] == [1, 4, 2]
        assert sched.stats()["max_coalesced"] == 4
    finally:
        sched.stop()


def test_short_jobs_route_to_cpu_without_benching_the_mesh():
    """A rebuild job with fewer than k source rows is a routing decision:
    the CPU coder takes it and the mesh stays healthy."""
    rec = _Recorder()
    sched = EcBatchScheduler(mesh_coder=rec, window_s=0.005)
    try:
        rows = _batch(1, 64, seed=6)[0][:7]
        mat = np.random.default_rng(7).integers(0, 256, (2, 7), np.uint8)
        assert np.array_equal(sched.rebuild(rows, mat),
                              JCPU.reconstruct_rows(rows, mat))
        d = _batch(1, 64, seed=8)[0]
        assert np.array_equal(sched.encode(d), JCPU.encode_array(d))
        st = sched.stats()
        assert st["cpu_batches"] == 1 and st["mesh_batches"] == 1
        assert st["coder_fallbacks"] == 0 and st["mesh_healthy"]
    finally:
        sched.stop()


class _Boom:
    n_devices = 8

    def encode_batch(self, b):
        raise RuntimeError("device_put failed: relay vanished")

    def rebuild_batch(self, s, m):
        raise RuntimeError("device_put failed: relay vanished")


def test_mid_run_device_loss_drains_through_cpu():
    """The mesh raises on dispatch -> every queued job drains through the
    CPU fallback bit-identically, coder_fallbacks increments, the reason
    is classified, the on_fallback observer fires, and the mesh is benched
    for the cooldown."""
    reasons = []
    sched = EcBatchScheduler(mesh_coder=_Boom(), window_s=0.02,
                             cooldown_s=60.0, on_fallback=reasons.append)
    try:
        datas = [_batch(1, 1000, seed=10 + i)[0] for i in range(6)]
        futs = [sched.submit_encode(d) for d in datas]
        for d, f in zip(datas, futs):
            assert np.array_equal(f.result(timeout=30), JCPU.encode_array(d))
        assert sched.coder_fallbacks >= 1
        assert sched.fallback_reason == "device_put"
        assert reasons and reasons[0] == "device_put"
        # benched: later work routes straight to CPU without re-raising
        d = _batch(1, 512, seed=20)[0]
        assert np.array_equal(sched.encode(d), JCPU.encode_array(d))
        st = sched.stats()
        assert st["mesh_healthy"] is False
        assert st["cpu_batches"] >= 2
        # rebuild drains too
        full = np.concatenate([d, JCPU.encode_array(d)])
        present = [j for j in range(TOTAL) if j != 0]
        mat = JCPU.rebuild_matrix(present, [0])
        assert np.array_equal(sched.rebuild(full[present[:K]], mat),
                              full[[0]])
    finally:
        sched.stop()


def test_benched_mesh_returns_after_the_cooldown_on_a_virtual_clock(
        capfd):
    """The cooldown runs on utils/clockctl: under an installed virtual
    clock the mesh stays benched until the clock passes the cooldown,
    then takes work again; the fallback is logged."""
    from seaweedfs_tpu_torch.utils import clockctl

    class _Flaky(_Recorder):
        fail = True

        def encode_batch(self, b):
            if self.fail:
                self.fail = False
                raise RuntimeError("DeadlineExceeded: timeout")
            return super().encode_batch(b)

    now = [1000.0]
    rec = _Flaky()
    with clockctl.install(lambda: now[0]):
        sched = EcBatchScheduler(mesh_coder=rec, window_s=0.0,
                                 cooldown_s=30.0)
        try:
            d = _batch(1, 64, seed=40)[0]
            assert np.array_equal(sched.encode(d), JCPU.encode_array(d))
            assert sched.stats()["fallback_reason"] == "relay_timeout"
            now[0] += 29.0
            assert sched.encode(d) is not None and rec.shapes == []
            assert not sched.stats()["mesh_healthy"]
            now[0] += 2.0
            assert sched.stats()["mesh_healthy"]
            assert np.array_equal(sched.encode(d), JCPU.encode_array(d))
            assert len(rec.shapes) == 1
            st = sched.stats()
            assert (st["coder_fallbacks"], st["cpu_batches"],
                    st["mesh_batches"]) == (1, 2, 1)
        finally:
            sched.stop()
    assert "mesh dispatch failed" in capfd.readouterr().err


def test_stop_drains_queued_jobs_through_cpu():
    """No submitted future is ever abandoned: jobs still queued at stop()
    complete via the CPU path."""
    gate = threading.Event()

    class _Slow(_Recorder):
        def encode_batch(self, b):
            gate.wait(5)
            return super().encode_batch(b)

    sched = EcBatchScheduler(mesh_coder=_Slow(), window_s=0.0)
    d1, d2 = _batch(2, 256, seed=6)
    f1 = sched.submit_encode(d1)
    time.sleep(0.05)  # dispatcher now blocked inside _Slow on f1
    f2 = sched.submit_encode(d2)
    gate.set()
    sched.stop()
    assert np.array_equal(f1.result(timeout=10), JCPU.encode_array(d1))
    assert np.array_equal(f2.result(timeout=10), JCPU.encode_array(d2))
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit_encode(d1)


def test_batch_coder_facade_is_a_drop_in_coder():
    sched = _cpu_scheduler(window_s=0.005)
    try:
        bc = BatchCoder(sched)
        rng = np.random.default_rng(8)
        shards = [rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
                  for _ in range(K)]
        full = bc.encode(shards)
        assert full == JCPU.encode(shards)
        holes = [s if i not in (1, 11) else None for i, s in enumerate(full)]
        assert bc.reconstruct(holes) == full
        assert bc.reconstruct_data(holes)[1] == full[1]
        assert bc.verify(full)
    finally:
        sched.stop()


def test_batch_coder_other_rs_scheme_rides_the_per_job_matrix_path():
    """A facade for RS(10,2) on an RS(10,4) scheduler: its encodes carry
    their own parity matrix and coalesce with the scheduler's own."""
    sched = _cpu_scheduler(window_s=0.005)
    try:
        bc = BatchCoder(sched, RSScheme(10, 2))
        d = _batch(1, 1000, seed=9)[0]
        want = JCpuCoder(JRSScheme(10, 2)).encode_array(d)
        assert np.array_equal(bc.encode_array(d), want)
        assert sched.stats()["mesh_batches"] == 1
        assert sched.stats()["cpu_batches"] == 0
        # an LRC facade on the same scheduler rides the same path
        lbc = BatchCoder(sched, LrcScheme())
        assert np.array_equal(lbc.encode_array(d),
                              JLrcCoder().encode_array(d))
        assert sched.stats()["mesh_batches"] == 2
    finally:
        sched.stop()


# ------------------------------------------- the LRC facade (ported from
# tests/test_mesh_batcher.py:269-356)

def test_mixed_rs_lrc_batch_drain_matches_jax():
    """RS and LRC jobs in one coalescing window on a mesh of CPU lanes:
    every future demuxes exactly its own rows, an RS and an LRC encode of
    one shape share one launch with a matrix per job, and an LRC
    group-local rebuild (5 source rows, not k) routes to the CPU coder
    without benching the mesh."""
    jlrc = JLrcCoder()
    launches = []
    real = rs_cuda.gf_apply_batch

    def recorded(mats, data, out=None):
        launches.append(mats)
        return real(mats, data, out)

    sched = _cpu_scheduler(window_s=0.3)
    try:
        rs_data = [_batch(1, 1024, seed=30 + i)[0] for i in range(3)]
        lrc_data = [_batch(1, 1024, seed=40 + i)[0] for i in range(3)]
        shards = jlrc.encode([lrc_data[0][i].tobytes() for i in range(K)])
        full = [np.frombuffer(s, dtype=np.uint8) for s in shards]
        src_sids, mat = jlrc.plan_rebuild(
            [s for s in range(TOTAL) if s != 2], [2])
        assert len(src_sids) == 5  # group-local: 5 reads, not k=10
        rs_cuda.gf_apply_batch = recorded
        try:
            futs = []
            for rd, ld in zip(rs_data, lrc_data):
                futs.append(("rs", rd, sched.submit_encode(rd)))
                futs.append(("lrc", ld,
                             sched.submit_encode(ld, mat=jlrc._parity)))
            rf = sched.submit_rebuild(
                np.stack([full[s] for s in src_sids]), mat)
            for fam, d, f in futs:
                want = JCPU.encode_array(d) if fam == "rs" \
                    else jlrc.encode_array(d)
                assert np.array_equal(f.result(timeout=30), want), fam
            assert np.array_equal(rf.result(timeout=30)[0], full[2])
        finally:
            rs_cuda.gf_apply_batch = real
        st = sched.stats()
        assert st["jobs_total"] == 7
        assert st["mesh_batches"] == 1 and st["cpu_batches"] == 1
        assert st["coder_fallbacks"] == 0  # narrow rebuild != mesh fault
        assert st["mesh_healthy"] is True
        # one launch per lane, each carrying a matrix per job
        assert len(launches) == 2
        rs_par = JCPU.encode_array(np.eye(K, dtype=np.uint8))
        seen = {bytes(np.ascontiguousarray(m).tobytes())
                for mats in launches for m in mats}
        assert bytes(np.ascontiguousarray(rs_par).tobytes()) in seen
        assert bytes(np.ascontiguousarray(jlrc._parity).tobytes()) in seen
    finally:
        sched.stop()


def test_mixed_drain_survives_mesh_loss_via_cpu():
    """Mixed batch + mesh failure: both families drain through the CPU
    fallback byte-identically."""
    jlrc = JLrcCoder()
    sched = EcBatchScheduler(mesh_coder=_Boom(), window_s=0.02)
    try:
        rd = _batch(1, 776, seed=50)[0]
        ld = _batch(1, 776, seed=51)[0]
        f1 = sched.submit_encode(rd)
        f2 = sched.submit_encode(ld, mat=jlrc._parity)
        assert np.array_equal(f1.result(timeout=30), JCPU.encode_array(rd))
        assert np.array_equal(f2.result(timeout=30), jlrc.encode_array(ld))
        assert sched.coder_fallbacks >= 1
    finally:
        sched.stop()


@pytest.mark.parametrize("lost", [(7,), (2, 12), (0, 5, 11, 13)])
def test_lrc_batch_coder_facade_shares_scheduler(lost):
    """One scheduler serves two facades, RS and LRC, each encoding under
    its own code and reconstructing through its own plan (a plan's
    sources, not the first k present), against the JAX LrcCoder."""
    jlrc = JLrcCoder()
    sched = _cpu_scheduler(window_s=0.005)
    try:
        rs_bc = BatchCoder(sched)
        lrc_bc = BatchCoder(sched, LrcScheme())
        assert lrc_bc.scheme.total_shards == TOTAL
        rng = np.random.default_rng(52)
        shards = [rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
                  for _ in range(K)]
        assert [bytes(s) for s in rs_bc.encode(shards)] == \
            [bytes(s) for s in JCPU.encode(shards)]
        full = lrc_bc.encode(shards)
        assert [bytes(s) for s in full] == \
            [bytes(s) for s in jlrc.encode(shards)]
        holes = [s if i not in lost else None for i, s in enumerate(full)]
        assert [bytes(s) for s in lrc_bc.reconstruct(holes)] == \
            [bytes(s) for s in jlrc.reconstruct(holes)]
        got = lrc_bc.reconstruct_data(holes)
        want = jlrc.reconstruct_data(holes)
        assert [None if s is None else bytes(s) for s in got] == \
            [None if s is None else bytes(s) for s in want]
        st = sched.stats()
        assert st["coder_fallbacks"] == 0
        # a plan that reads fewer than k sources (a single-group loss reads
        # 5) is a cpu batch, not a fallback
        present = [i for i in range(TOTAL) if i not in lost]
        plans = [jlrc.plan_rebuild(present, list(lost)),
                 jlrc.plan_rebuild(present, [i for i in lost if i < K])]
        assert st["cpu_batches"] == sum(len(p[0]) < K for p in plans)
    finally:
        sched.stop()


# ------------------------------- the facade through the pipelines

LB, SB = 4096, 1024
VID = 7


def _jax_volume(d, seed: int) -> None:
    rng = np.random.default_rng(seed)
    v = jvol.Volume(str(d), "", VID)
    for i in range(40):
        v.write_needle(jneedle.Needle(
            id=int(rng.integers(1, 1 << 40)),
            cookie=int(rng.integers(0, 1 << 32)),
            data=rng.bytes(int(rng.integers(1, 3000))),
            append_at_ns=10**18 + i))
    v.close()


def _shards(base):
    return [open(base + layout.shard_ext(i), "rb").read()
            for i in range(TOTAL)]


@pytest.fixture(scope="module")
def jax_volumes(tmp_path_factory):
    """Three JAX-written volumes encoded and rebuilt by the JAX pipelines
    with the JAX BatchCoder (its scheduler on the virtual mesh)."""
    root = tmp_path_factory.mktemp("batch")
    sched = jbatcher.EcBatchScheduler(window_s=0.005)
    bc = jbatcher.BatchCoder(sched)
    out = []
    try:
        for seed in range(3):
            d = root / f"v{seed}"
            d.mkdir()
            _jax_volume(d, seed)
            jbase = str(d / str(VID))
            jstreaming.pipelined_encode_file(jbase, large_block=LB,
                                             small_block=SB, batch_size=SB,
                                             coder=bc)
            shards = _shards(jbase)
            drop = [(0, 5, 11, 13), (9,), (10, 11, 12, 13)][seed]
            for i in drop:
                os.remove(jbase + layout.shard_ext(i))
            jstreaming.pipelined_rebuild_files(jbase, bc, batch_size=SB)
            assert _shards(jbase) == shards
            out.append((d, shards, drop))
        assert sched.stats()["cpu_batches"] == 0
    finally:
        sched.stop()
    return out


def test_facade_pipelines_match_the_jax_pipelines(jax_volumes, tmp_path):
    """Three volumes encoded concurrently through one port scheduler, then
    each rebuilt after its own loss pattern, concurrently: every shard
    equals the JAX pipeline's with the JAX BatchCoder."""
    sched = _cpu_scheduler(window_s=0.02)
    bc = BatchCoder(sched)
    bases = []
    for d, _, _ in jax_volumes:
        t = tmp_path / d.name
        t.mkdir()
        shutil.copy(d / f"{VID}.dat", t / f"{VID}.dat")
        bases.append(str(t / str(VID)))
    errors = []

    def run(fn, *args, **kw):
        try:
            fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    try:
        threads = [threading.Thread(
            target=run, args=(streaming.pipelined_encode_file, b),
            kwargs=dict(large_block=LB, small_block=SB, batch_size=SB,
                        coder=bc)) for b in bases]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors and not any(t.is_alive() for t in threads)
        for base, (_, shards, drop) in zip(bases, jax_volumes):
            assert _shards(base) == shards
            for i in drop:
                os.remove(base + layout.shard_ext(i))
        threads = [threading.Thread(
            target=run, args=(streaming.pipelined_rebuild_files, b, bc),
            kwargs=dict(batch_size=SB)) for b in bases]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors and not any(t.is_alive() for t in threads)
        for base, (_, shards, _) in zip(bases, jax_volumes):
            assert _shards(base) == shards
        st = sched.stats()
        assert st["cpu_batches"] == 0 and st["coder_fallbacks"] == 0
        assert st["jobs_total"] > st["batches_total"]  # jobs coalesced
    finally:
        sched.stop()


def test_scheduler_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EcBatchScheduler()
    sched = EcBatchScheduler(device="cpu")
    try:
        assert sched.stats()["mesh_devices"] == 1
        d = _batch(1, 64, seed=11)[0]
        assert np.array_equal(sched.encode(d), JCPU.encode_array(d))
        assert sched.stats()["cpu_batches"] == 0
    finally:
        sched.stop()
    assert DEFAULT_SCHEME == RSScheme(10, 4)
