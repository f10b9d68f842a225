"""The port's coder against seaweedfs_tpu's coders, byte for byte.

TorchCoder(device="cpu") and the kernel wrapper's CPU path run
rs_torch.gf_apply_reference, the plain PyTorch version the CUDA kernel is
held against on the card. Here it is held against JaxCoder, PallasCoder
(interpret mode, as tests/test_pallas.py runs it) and, for the exhaustive
loss sweep, the JAX package's numpy/native CpuCoder (itself bit-identical
to JaxCoder, so the sweep costs no JAX compiles).
"""

import itertools

import numpy as np
import pytest
import torch

from seaweedfs_tpu.models.coder import RSScheme as JRSScheme
from seaweedfs_tpu.models.coder import make_coder as jmake
from seaweedfs_tpu.models.coder import scheme_to_dict as jscheme_to_dict
from seaweedfs_tpu.ops import gf256 as jgf
from seaweedfs_tpu.ops import rs_cpu as jrs_cpu
from seaweedfs_tpu_torch.models.coder import RSScheme, make_coder
from seaweedfs_tpu_torch.ops import rs_cuda, rs_torch


def _bytes_rows(rng, k, n):
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for _ in range(k)]


def test_encode_array_matches_jax_and_pallas():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (10, 8192), dtype=np.uint8)
    got = make_coder(device="cpu").encode_array(data)
    assert np.array_equal(got, jmake("jax").encode_array(data))
    assert np.array_equal(got, jmake("pallas").encode_array(data))


def test_bytes_api_unaligned_matches_jax_and_pallas():
    rng = np.random.default_rng(1)
    data = _bytes_rows(rng, 10, 5001)
    got = make_coder(device="cpu").encode(data)
    assert got == jmake("jax").encode(data)
    assert got == jmake("pallas").encode(data)


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (12, 6)])
def test_other_schemes_match_jax(k, m):
    rng = np.random.default_rng(k * 31 + m)
    data = _bytes_rows(rng, k, 4096 + 52)
    assert make_coder(scheme=RSScheme(k, m), device="cpu").encode(data) \
        == jmake("jax", JRSScheme(k, m)).encode(data)


@pytest.mark.parametrize("drop", [[0, 5, 11, 13], [9], [10, 11, 12, 13],
                                  [2, 3, 4, 5], [0, 13]])
def test_reconstruct_matches_jax(drop):
    rng = np.random.default_rng(6)
    jax_coder = jmake("jax")
    full = jax_coder.encode(_bytes_rows(rng, 10, 2048))
    shards = [None if i in drop else full[i] for i in range(14)]
    port = make_coder(device="cpu")
    got = port.reconstruct(list(shards))
    assert got == jax_coder.reconstruct(list(shards)) == full
    got_data = port.reconstruct_data(list(shards))
    want_data = jax_coder.reconstruct_data(list(shards))
    assert got_data[:10] == want_data[:10] == full[:10]
    assert got_data[10:] == [None if i in drop else full[i]
                             for i in range(10, 14)]


def test_pallas_reconstruct_matches():
    rng = np.random.default_rng(7)
    pal = jmake("pallas")
    full = pal.encode(_bytes_rows(rng, 10, 5001))
    shards = [None if i in (0, 13) else full[i] for i in range(14)]
    assert make_coder(device="cpu").reconstruct(list(shards)) \
        == pal.reconstruct(list(shards))


def test_all_1470_loss_patterns_match_cpu_coder():
    rng = np.random.default_rng(8)
    ref = jmake("cpu")
    port = make_coder(device="cpu")
    full = ref.encode(_bytes_rows(rng, 10, 37))
    patterns = [p for r in range(1, 5)
                for p in itertools.combinations(range(14), r)]
    assert len(patterns) == 1470
    for drop in patterns:
        shards = [None if i in drop else full[i] for i in range(14)]
        assert port.reconstruct(shards) == ref.reconstruct(list(shards)), drop


def test_rebuild_matrix_and_rows_match_cpu_coder():
    rng = np.random.default_rng(9)
    ref = jmake("cpu")
    port = make_coder(device="cpu")
    data = rng.integers(0, 256, (10, 777), dtype=np.uint8)
    full = np.concatenate([data, ref.encode_array(data)])
    for present, missing in [((1, 2, 3, 4, 6, 7, 8, 9, 10, 12), (0, 5, 11)),
                             (tuple(range(4, 14)), (0, 1, 2, 3)),
                             (tuple(range(10)), (10, 11, 12, 13))]:
        rmat = port.rebuild_matrix(present, missing)
        assert np.array_equal(rmat, ref.rebuild_matrix(present, missing))
        out = np.full((len(missing), 777), 0xAA, dtype=np.uint8)
        rec = port.reconstruct_rows(full[list(present)], rmat, out)
        assert rec is out
        assert np.array_equal(out, full[list(missing)])
    parity = np.empty((4, 777), dtype=np.uint8)
    assert port.encode_into(data, parity) is parity
    assert np.array_equal(parity, full[10:])


def test_too_few_shards_raises():
    port = make_coder(device="cpu")
    shards = [b"\x00" * 8] * 9 + [None] * 5
    with pytest.raises(ValueError):
        port.reconstruct(shards)


@pytest.mark.parametrize("m,k,n", [(4, 10, 1), (4, 10, 17), (1, 1, 100),
                                   (16, 32, 300), (3, 7, 4097)])
def test_kernel_wrapper_cpu_path_matches_numpy_coder(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
    # rows with a padded row stride, as a pipeline's column slice has
    wide = rng.integers(0, 256, (k, n + 5), dtype=np.uint8)
    data = torch.from_numpy(wide)[:, :n]
    want = jrs_cpu._gf_apply(mat, np.ascontiguousarray(wide[:, :n]))
    assert np.array_equal(rs_cuda.gf_apply(mat, data).numpy(), want)
    out = torch.empty((m, n), dtype=torch.uint8)
    assert rs_cuda.gf_apply(torch.from_numpy(mat), data, out) is out
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(rs_torch.gf_apply_reference(mat, data).numpy(),
                          want)


def test_selection_masks_encode_every_matrix_bit():
    rng = np.random.default_rng(10)
    for m, k in [(4, 10), (16, 32), (1, 1), (7, 13)]:
        mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
        masks = rs_cuda.selection_masks(mat).reshape(m, 8)
        assert masks.dtype == np.uint32
        back = np.zeros((m, k), dtype=np.uint8)
        for i in range(m):
            for b in range(8):
                for j in range(k):
                    back[i, j] |= ((int(masks[i, b]) >> j) & 1) << b
        assert np.array_equal(back, mat)


def test_wrapper_rejects_bad_inputs():
    data = torch.zeros((10, 8), dtype=torch.uint8)
    mat = np.ones((4, 10), dtype=np.uint8)
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(mat, data.to(torch.int32))
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(mat, data[:9])
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(mat, torch.zeros((8, 10), dtype=torch.uint8).t())
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(mat, data, torch.empty((4, 7), dtype=torch.uint8))
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(np.full((4, 10), 300), data)


def test_coder_from_numpy_round_trip():
    scheme = JRSScheme(10, 4)
    spec = jscheme_to_dict(scheme)
    pm = np.asarray(jgf.parity_matrix(10, 4))
    coder = rs_torch.coder_from_numpy(spec, pm, device="cpu")
    assert isinstance(coder, rs_torch.TorchCoder)
    assert coder.scheme == RSScheme(10, 4)
    rng = np.random.default_rng(11)
    data = _bytes_rows(rng, 10, 999)
    assert coder.encode(data) == jmake("cpu", scheme).encode(data)
    six = rs_torch.coder_from_numpy(
        jscheme_to_dict(JRSScheme(6, 3)),
        np.asarray(jgf.parity_matrix(6, 3)), device="cpu")
    assert six.scheme == RSScheme(6, 3)
    bad = pm.copy()
    bad[0, 0] ^= 1
    with pytest.raises(ValueError):
        rs_torch.coder_from_numpy(spec, bad, device="cpu")
    with pytest.raises(ValueError):
        rs_torch.coder_from_numpy(spec, pm[:3], device="cpu")
    with pytest.raises(ValueError):
        rs_torch.coder_from_numpy({"family": "lrc"}, pm, device="cpu")
