"""The port's host coder (ops/rs_cpu.py, native/rs_native.py over
csrc/rs_cpu.cpp) against seaweedfs_tpu's CpuCoder, byte for byte.

Both the native path (the C++ codec built with g++ at first use) and the
numpy path (use_native=False), single-threaded ("cpu") and column-sharded
("cpu-mt"), on the same seeded numpy inputs: encode, every loss pattern of
1-4 shards of RS(10,4) through rebuild_matrix and reconstruct_rows, the
bytes API, and gf_partial_product. Tolerance: byte-exact.
"""

import itertools

import numpy as np
import pytest

from seaweedfs_tpu.models.coder import RSScheme as JRSScheme
from seaweedfs_tpu.ops import rs_cpu as jrs_cpu
from seaweedfs_tpu_torch.models.coder import RSScheme, make_coder
from seaweedfs_tpu_torch.native import rs_native
from seaweedfs_tpu_torch.ops import rs_cpu

JCPU = jrs_cpu.CpuCoder(JRSScheme(10, 4))


def _coder(name, native, scheme=RSScheme(10, 4)):
    cls = rs_cpu.CpuCoderMT if name == "cpu-mt" else rs_cpu.CpuCoder
    return cls(scheme, use_native=native)


def test_native_codec_builds_and_loads():
    assert rs_native.available()
    assert rs_native.impl_name() in ("scalar", "avx2", "gfni-512")


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", ["cpu", "cpu-mt"])
@pytest.mark.parametrize("n", [1, 997, 70001])
def test_encode_array_matches_jax(name, native, n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (10, n), dtype=np.uint8)
    coder = _coder(name, native)
    got = coder.encode_array(data)
    assert np.array_equal(got, JCPU.encode_array(data))
    out = np.full((4, n), 0xAB, dtype=np.uint8)  # encode_into zero-fills
    assert coder.encode_into(data, out) is out
    assert np.array_equal(out, got)


@pytest.mark.parametrize("k,m", [(6, 3), (12, 6)])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_other_schemes_encode_matches_jax(k, m, native):
    rng = np.random.default_rng(k * 7 + m)
    shards = [rng.integers(0, 256, 4099, dtype=np.uint8).tobytes()
              for _ in range(k)]
    got = _coder("cpu", native, RSScheme(k, m)).encode(shards)
    assert got == jrs_cpu.CpuCoder(JRSScheme(k, m)).encode(shards)


@pytest.mark.parametrize("lost", [1, 2, 3, 4])
def test_every_loss_pattern_matches_jax(lost):
    """rebuild_matrix for every pattern of `lost` shards (data, parity and
    mixed), and its rows applied by the native and numpy paths."""
    rng = np.random.default_rng(lost)
    data = rng.integers(0, 256, (10, 61), dtype=np.uint8)
    full = np.concatenate([data, JCPU.encode_array(data)])
    native, plain = _coder("cpu", True), _coder("cpu", False)
    patterns = 0
    for drop in itertools.combinations(range(14), lost):
        present = [i for i in range(14) if i not in drop]
        mat = native.rebuild_matrix(present, drop)
        assert np.array_equal(mat, JCPU.rebuild_matrix(present, drop))
        src = full[present[:10]]
        for coder in (native, plain):
            assert np.array_equal(coder.reconstruct_rows(src, mat),
                                  full[list(drop)])
        patterns += 1
    assert patterns == len(list(itertools.combinations(range(14), lost)))


@pytest.mark.parametrize("drop", [(0, 5, 11, 13), (9,), (10, 11, 12, 13),
                                  (2, 3, 4, 5), (0, 13)])
@pytest.mark.parametrize("name", ["cpu", "cpu-mt"])
def test_bytes_api_matches_jax(name, drop):
    rng = np.random.default_rng(sum(drop))
    shards = [rng.integers(0, 256, 70001, dtype=np.uint8).tobytes()
              for _ in range(10)]
    coder = make_coder(name)
    full = coder.encode(shards)
    assert full == JCPU.encode(shards)
    holes = [None if i in drop else s for i, s in enumerate(full)]
    assert coder.reconstruct(holes) == JCPU.reconstruct(holes)
    assert coder.reconstruct_data(holes) == JCPU.reconstruct_data(holes)
    assert coder.verify(full)


def test_make_coder_names_the_host_coders():
    assert type(make_coder("cpu")) is rs_cpu.CpuCoder
    mt = make_coder("cpu-mt", RSScheme(6, 3))
    assert type(mt) is rs_cpu.CpuCoderMT and mt.workers >= 1
    assert mt.scheme == RSScheme(6, 3)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("workers", [1, 3])
def test_gf_partial_product_matches_jax(native, workers):
    """A holder's columns of a rebuild matrix over its rows, 1-D and 2-D
    coefficients, folded into a caller's zero-filled output in two
    halves: the XOR fold of the partials equals the whole product."""
    rng = np.random.default_rng(workers)
    coeffs = rng.integers(0, 256, (3, 7), dtype=np.uint8)
    rows = rng.integers(0, 256, (7, 70001), dtype=np.uint8)
    want = jrs_cpu.gf_partial_product(coeffs, rows)
    got = rs_cpu.gf_partial_product(coeffs, rows, use_native=native,
                                    workers=workers)
    assert np.array_equal(got, want)
    acc = np.zeros((3, rows.shape[1]), dtype=np.uint8)
    rs_cpu.gf_partial_product(coeffs[:, :4], rows[:4], acc, native, workers)
    rs_cpu.gf_partial_product(coeffs[:, 4:], rows[4:], acc, native, workers)
    assert np.array_equal(acc, want)
    one = rs_cpu.gf_partial_product(coeffs[1], rows[:, :99],
                                    use_native=native)
    assert np.array_equal(one, jrs_cpu.gf_partial_product(coeffs[1],
                                                          rows[:, :99]))


def test_native_tiers_agree():
    """Every SIMD tier the host has gives the scalar tier's bytes."""
    rng = np.random.default_rng(5)
    mat = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    data = rng.integers(0, 256, (10, 4099), dtype=np.uint8)
    want = jrs_cpu._gf_apply(mat, data, use_native=False)
    try:
        for tier in (rs_native.IMPL_SCALAR, rs_native.IMPL_AVX2,
                     rs_native.IMPL_GFNI):
            rs_native.force_impl(tier)
            assert np.array_equal(rs_native.gf_apply(mat, data), want)
    finally:
        rs_native.force_impl(rs_native.IMPL_AUTO)


def test_lrc_scheme_is_refused():
    from seaweedfs_tpu_torch.models.coder import LrcScheme
    with pytest.raises(ValueError, match="LRC"):
        rs_cpu.CpuCoder(LrcScheme())
