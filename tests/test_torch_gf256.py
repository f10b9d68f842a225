"""The port's GF(2^8) field and RS matrices against seaweedfs_tpu's.

Byte-exact: GF(256) arithmetic has no rounding, so the port's tables,
encoding, parity and decode matrices must equal the JAX package's
(which in turn match the reference codec's Vandermonde construction).
"""

import itertools

import numpy as np
import pytest

from seaweedfs_tpu.ops import gf256 as jgf
from seaweedfs_tpu_torch.ops import gf256 as tgf


def test_field_tables_identical():
    assert np.array_equal(tgf.GF_EXP, jgf.GF_EXP)
    assert np.array_equal(tgf.GF_LOG, jgf.GF_LOG)
    assert np.array_equal(tgf.MUL_TABLE, jgf.MUL_TABLE)
    assert tgf.GF_POLY == jgf.GF_POLY == 0x11D


def test_scalar_ops_identical():
    rng = np.random.default_rng(0)
    for a, b in rng.integers(0, 256, (500, 2)).tolist():
        assert tgf.gf_mul(a, b) == jgf.gf_mul(a, b)
        assert tgf.gf_exp_pow(a, b) == jgf.gf_exp_pow(a, b)
        if b:
            assert tgf.gf_div(a, b) == jgf.gf_div(a, b)
            assert tgf.gf_inv(b) == jgf.gf_inv(b)
    with pytest.raises(ZeroDivisionError):
        tgf.gf_div(3, 0)


@pytest.mark.parametrize("k,total", [(10, 14), (6, 9), (12, 18), (4, 6),
                                     (20, 24), (1, 2)])
def test_rs_and_parity_matrix_identical(k, total):
    assert np.array_equal(tgf.rs_matrix(k, total), jgf.rs_matrix(k, total))
    assert np.array_equal(tgf.parity_matrix(k, total - k),
                          jgf.parity_matrix(k, total - k))
    assert np.array_equal(tgf.rs_matrix(k, total)[:k],
                          np.eye(k, dtype=np.uint8))


def test_decode_matrix_all_1001_survivor_sets():
    sets = list(itertools.combinations(range(14), 10))
    assert len(sets) == 1001
    for present in sets:
        assert np.array_equal(tgf.decode_matrix(10, 14, present),
                              jgf.decode_matrix(10, 14, present)), present


def test_decode_matrix_uses_first_k_of_longer_present():
    present = (0, 2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13)
    assert np.array_equal(tgf.decode_matrix(10, 14, present),
                          jgf.decode_matrix(10, 14, present))
    with pytest.raises(ValueError):
        tgf.decode_matrix(10, 14, present[:9])


def test_matmul_and_invert_identical():
    rng = np.random.default_rng(1)
    for n in (1, 2, 5, 10, 16):
        a = rng.integers(0, 256, (n, n), dtype=np.uint8)
        b = rng.integers(0, 256, (n, 7), dtype=np.uint8)
        assert np.array_equal(tgf.gf_matmul(a, b), jgf.gf_matmul(a, b))
        try:
            want = jgf.gf_mat_invert(a)
        except np.linalg.LinAlgError:
            with pytest.raises(np.linalg.LinAlgError):
                tgf.gf_mat_invert(a)
            continue
        got = tgf.gf_mat_invert(a)
        assert np.array_equal(got, want)
        assert np.array_equal(tgf.gf_matmul(a, got),
                              np.eye(n, dtype=np.uint8))


def test_singular_matrix_raises():
    sing = np.array([[1, 2], [1, 2]], dtype=np.uint8)
    with pytest.raises(np.linalg.LinAlgError):
        tgf.gf_mat_invert(sing)
    with pytest.raises(ValueError):
        tgf.gf_matmul(np.zeros((2, 3), np.uint8), np.zeros((2, 3), np.uint8))
