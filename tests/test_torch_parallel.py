"""The port's distributed EC compute (parallel/distributed.py) and
streaming.batch_encode_volumes against seaweedfs_tpu's, byte for byte,
at the mesh shapes of tests/test_parallel.py over 8 CPU lanes
(torch.device("cpu") repeated; the JAX package runs on the 8-device
virtual CPU mesh tests/conftest.py forces). One process drives every lane,
as one JAX controller drives its mesh. Tolerance: byte-exact.
"""

import numpy as np
import pytest

from seaweedfs_tpu.models.coder import RSScheme as JRSScheme
from seaweedfs_tpu.ops.rs_cpu import CpuCoder as JCpuCoder
from seaweedfs_tpu.parallel import distributed as jdist
from seaweedfs_tpu.parallel import mesh as jmesh
from seaweedfs_tpu.parallel import streaming as jstreaming
from seaweedfs_tpu_torch.models.coder import RSScheme
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.parallel import distributed, streaming
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

SCHEME, JSCHEME = RSScheme(10, 4), JRSScheme(10, 4)
JCPU = JCpuCoder(JSCHEME)
N = 64 << 10
DROPS = [(0, 3, 7, 9), (10, 11, 12, 13), (0, 5, 11, 13), (9,)]


def _lanes(shape):
    return mesh_mod.make_mesh(8, shape=shape, device="cpu")


def test_mesh_axes_and_default_shape_match_jax():
    m, jm = mesh_mod.make_mesh(8, device="cpu"), jmesh.make_mesh(8)
    assert m.axis_names == tuple(jm.axis_names)
    assert m.shape == dict(jm.shape)
    assert m.devices.size == jm.devices.size == 8
    for n in (1, 2, 6, 12):
        assert mesh_mod._default_shape(n, 3) == jmesh._default_shape(n, 3)


@pytest.mark.parametrize("shape", [(2, 1, 4), (1, 2, 4), (2, 2, 2)])
def test_distributed_encode_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    batch = rng.integers(0, 256, (4, 10, N), dtype=np.uint8)
    got = distributed.distributed_encode(SCHEME, _lanes(shape), batch)
    want = jdist.distributed_encode(JSCHEME, jmesh.make_mesh(8, shape=shape),
                                    batch)
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def survivors():
    """Seeded shard rows and the JAX package's distributed rebuild of
    each loss pattern on its (1, 2, 4) mesh."""
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (10, N), dtype=np.uint8)
    full = np.concatenate([data, JCPU.encode_array(data)])
    jm = jmesh.make_mesh(8, shape=(1, 2, 4))
    want = {}
    for drop in DROPS:
        shards = {i: full[i] for i in range(14) if i not in drop}
        want[drop] = jdist.distributed_rebuild(JSCHEME, jm, shards, drop)
    return full, want


@pytest.mark.parametrize("shape", [(1, 2, 4), (2, 2, 2)])
@pytest.mark.parametrize("drop", DROPS)
def test_distributed_rebuild_matches_jax(survivors, shape, drop,
                                         monkeypatch):
    """Partial products on every ('shard', 'seq') lane, folded on the
    first: the JAX package's bytes, and the lost rows themselves."""
    full, want = survivors
    calls = []
    real = rs_cuda.gf_apply

    def counted(mat, data, out=None):
        calls.append(np.asarray(mat).shape)
        return real(mat, data, out)

    monkeypatch.setattr(rs_cuda, "gf_apply", counted)
    shards = {i: full[i] for i in range(14) if i not in drop}
    got = distributed.distributed_rebuild(SCHEME, _lanes(shape), shards, drop)
    assert np.array_equal(got, want[drop])
    assert np.array_equal(got, full[list(drop)])
    # one K1 launch per ('shard', 'seq') lane of the first 'data' row
    assert len(calls) == shape[1] * shape[2]
    assert {c[0] for c in calls} == {len(drop)}


@pytest.mark.parametrize("drop", DROPS)
@pytest.mark.parametrize("padded_s", [14, 16])
def test_make_rebuild_coeff_matches_jax(drop, padded_s):
    present = tuple(i for i in range(14) if i not in drop)
    got = distributed.make_rebuild_coeff(SCHEME, present, drop, padded_s)
    want = jdist.make_rebuild_coeff(JSCHEME, present, drop, padded_s)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [None, (2, 1, 4), (4,)])
def test_batch_encode_volumes_matches_jax(shape):
    """Without a mesh one launch of K1's batch entry (here its plain
    version on the CPU); with a ('data', 'shard', 'seq') mesh,
    distributed_encode; with a 1-D batch mesh, MeshCoder (held against
    the JAX package's one-chip result). Column chunks streamed through it
    reassemble to the one-shot result."""
    rng = np.random.default_rng(9)
    vols = rng.integers(0, 256, (4, 10, N), dtype=np.uint8)
    mesh = jm = None
    if shape == (4,):
        mesh = mesh_mod.batch_mesh(4, device="cpu")
    elif shape is not None:
        mesh, jm = _lanes(shape), jmesh.make_mesh(8, shape=shape)
    whole = streaming.batch_encode_volumes(vols, SCHEME, mesh=mesh,
                                           device="cpu")
    assert np.array_equal(whole, jstreaming.batch_encode_volumes(
        vols, JSCHEME, mesh=jm))
    chunk = N // 4
    streamed = np.concatenate(
        [streaming.batch_encode_volumes(
            np.ascontiguousarray(vols[:, :, off:off + chunk]), SCHEME,
            mesh=mesh, device="cpu")
         for off in range(0, N, chunk)], axis=2)
    assert np.array_equal(whole, streamed)


def test_distributed_checks_its_input():
    m = _lanes((2, 1, 4))
    with pytest.raises(ValueError, match="multiple of 4"):
        distributed.distributed_encode(SCHEME, m,
                                       np.zeros((2, 10, 6), np.uint8))
    with pytest.raises(ValueError, match="too few"):
        distributed.distributed_rebuild(
            SCHEME, m, {i: np.zeros(8, np.uint8) for i in range(9)}, (9,))
