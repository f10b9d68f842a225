"""The port's LRC(10,2,2) (ops/lrc.py) against seaweedfs_tpu's, byte for
byte, after tests/test_lrc.py.

1. the code: generator and parity matrices equal; for every erasure
   pattern of size <= 4 (1470 of them) the port's plan_rebuild and
   rebuild_matrix return exactly the JAX package's sources and matrices,
   or raise exactly where it raises (rebuild_matrix's first-k subset is
   rank-deficient for some recoverable patterns, in both packages); and
   reconstruct / reconstruct_data return the same bytes or raise alike;
2. the planner: repair_strategy and encoder.plan_rebuild_sources agree;
3. the seam: "lrc" / "lrc-mt" are host coders that force an LrcScheme;
4. the mixed RS + LRC store: the port's Store (card coder, run as its
   plain version with device="cpu") and the JAX package's Store (host
   coder) read the same shard files, degrade the same shards and must
   return equal needles, equal recovery-strategy counts and equal rebuilt
   shard files.

GF(256) has no rounding: every comparison is exact.
"""

import itertools
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.models.coder import make_coder as jmake
from seaweedfs_tpu.ops.lrc import LrcCoder as JLrcCoder
from seaweedfs_tpu.ops.lrc import generator_matrix as jgenerator
from seaweedfs_tpu.storage.erasure_coding import encoder as jenc
from seaweedfs_tpu.storage.store import Store as JStore
from seaweedfs_tpu_torch.models.coder import (HOST_CODERS, LrcScheme,
                                              RSScheme, make_coder)
from seaweedfs_tpu_torch.ops import lrc
from seaweedfs_tpu_torch.ops.lrc import LrcCoder, LrcCoderMT
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as tenc
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store

SPEC = LrcScheme()
K, TOTAL = SPEC.data_shards, SPEC.total_shards
GROUPS = [set(SPEC.group_members(g)) for g in range(SPEC.local_groups)]
GLOBALS = set(SPEC.global_parity_ids())
PATTERNS = [p for size in (1, 2, 3, 4)
            for p in itertools.combinations(range(TOTAL), size)]


def _mr_recoverable(erased: set) -> bool:
    """Maximal recoverability of a basic pyramid LRC(k, l, g): each local
    parity absorbs one loss of its group; the rest must fit g globals."""
    need = sum(max(0, len(erased & grp) - 1) for grp in GROUPS)
    return need + len(erased & GLOBALS) <= SPEC.global_parities


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return "raises"


def _same(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def _shards(coder, n=64, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(K, n), dtype=np.uint8)
    return coder.encode([data[i].tobytes() for i in range(K)])


# ------------------------------------------------------------ the code

@pytest.mark.parametrize("spec", [(10, 2, 2), (12, 3, 2), (6, 2, 1)])
def test_generator_and_parity_match_jax(spec):
    from seaweedfs_tpu.models.coder import LrcScheme as JLrcScheme
    mine = lrc.generator_matrix(LrcScheme(*spec))
    assert np.array_equal(mine, jgenerator(JLrcScheme(*spec)))
    assert np.array_equal(LrcCoder(LrcScheme(*spec))._parity,
                          JLrcCoder(JLrcScheme(*spec))._parity)


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_every_small_erasure_pattern_plans_as_jax(size):
    """plan_rebuild agrees with the JAX package on every pattern of this
    size (sources and matrix, or a raise), and succeeds exactly on the
    information-theoretically recoverable ones."""
    mine, ref = LrcCoder(), JLrcCoder()
    for erased in itertools.combinations(range(TOTAL), size):
        present = [s for s in range(TOTAL) if s not in erased]
        got = _outcome(lambda: mine.plan_rebuild(present, list(erased)))
        want = _outcome(lambda: ref.plan_rebuild(present, list(erased)))
        assert _same(got, want), erased
        assert (got != "raises") == _mr_recoverable(set(erased)), erased


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_rebuild_matrix_raises_where_jax_raises(size):
    """rebuild_matrix keeps the CpuCoder contract (the first k of
    sorted(present)); that subset can be singular for a recoverable
    pattern (losing shard 7 alone: 0-6, 8, 9, 10 span 9 dims). The port
    raises in exactly the JAX package's cases."""
    mine, ref = LrcCoder(), JLrcCoder()
    singular = 0
    for erased in itertools.combinations(range(TOTAL), size):
        present = [s for s in range(TOTAL) if s not in erased]
        got = _outcome(lambda: mine.rebuild_matrix(present, list(erased)))
        want = _outcome(lambda: ref.rebuild_matrix(present, list(erased)))
        assert _same([got], [want]), erased
        singular += isinstance(got, str)
    if size == 1:
        assert _outcome(lambda: mine.rebuild_matrix(
            [s for s in range(TOTAL) if s != 7], [7])) == "raises"
        assert singular > 0


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_every_small_erasure_pattern_reconstructs_as_jax(size):
    """Every pattern of this size: reconstruct and reconstruct_data
    return the JAX package's bytes (the originals) where it recovers, and
    raise where it raises."""
    mine, ref = LrcCoder(), JLrcCoder()
    full = [bytes(s) for s in _shards(ref, n=77, seed=size)]
    assert [bytes(s) for s in _shards(mine, n=77, seed=size)] == full
    for erased in itertools.combinations(range(TOTAL), size):
        holes = [None if i in erased else s for i, s in enumerate(full)]
        got = _outcome(lambda: [bytes(s) for s in mine.reconstruct(holes)])
        want = _outcome(lambda: [bytes(s) for s in ref.reconstruct(holes)])
        assert got == want, erased
        assert (got == full) == _mr_recoverable(set(erased)), erased
        got = _outcome(lambda: [None if s is None else bytes(s)
                                for s in mine.reconstruct_data(holes)])
        want = _outcome(lambda: [None if s is None else bytes(s)
                                 for s in ref.reconstruct_data(holes)])
        assert got == want, erased


@pytest.mark.parametrize("n", [1, 63, 4096 + 3])
def test_encode_paths_match_jax(n):
    """encode, encode_array and encode_into, single- and multi-threaded."""
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, size=(K, n), dtype=np.uint8)
    want = JLrcCoder().encode_array(data)
    for coder in (LrcCoder(), LrcCoderMT(), LrcCoder(workers=3)):
        assert np.array_equal(coder.encode_array(data), want)
        out = np.full((SPEC.parity_shards, n), 0xAA, dtype=np.uint8)
        assert np.array_equal(coder.encode_into(data, out), want)
        shards = coder.encode([data[i].tobytes() for i in range(K)])
        assert [bytes(s) for s in shards[K:]] == \
            [bytes(r) for r in want]


# --------------------------------------------------------- the planner

def test_repair_strategy_matches_jax():
    mine, ref = LrcCoder(), JLrcCoder()
    for erased in [p for p in PATTERNS if len(p) <= 2]:
        present = [s for s in range(TOTAL) if s not in erased]
        if not _mr_recoverable(set(erased)):
            continue
        got = mine.repair_strategy(present, list(erased))
        want = ref.repair_strategy(present, list(erased))
        assert {k: v for k, v in got.items() if k != "mat"} == \
            {k: v for k, v in want.items() if k != "mat"}, erased
        assert np.array_equal(got["mat"], want["mat"]), erased
    # every group member repairs locally from its 5 surviving members
    for sid in range(TOTAL):
        st = mine.repair_strategy([s for s in range(TOTAL) if s != sid],
                                  [sid])
        assert st["strategy"] == ("global" if sid in GLOBALS else "local")
        assert st["reads"] == (K if sid in GLOBALS else SPEC.group_size)


@pytest.mark.parametrize("lost", [3, 7, 10, 12])
def test_plan_rebuild_sources_prefers_the_plan(lost):
    present = [s for s in range(TOTAL) if s != lost]
    for port, ref in ((LrcCoder(), JLrcCoder()),
                      (make_coder("cpu"), jmake("cpu"))):
        src, mat = tenc.plan_rebuild_sources(port, present, [lost])
        jsrc, jmat = jenc.plan_rebuild_sources(ref, present, [lost])
        assert src == jsrc and np.array_equal(mat, jmat)


# ------------------------------------------------------------ the seam

def test_lrc_coders_are_host_coders_that_force_the_scheme():
    assert "lrc" in HOST_CODERS and "lrc-mt" in HOST_CODERS
    for name, cls in (("lrc", LrcCoder), ("lrc-mt", LrcCoderMT)):
        # no device is taken: this runs on a machine without a card
        c = make_coder(name, RSScheme(10, 4))
        assert type(c) is cls and c.scheme == LrcScheme()
        assert c.workers >= 1
    assert LrcCoder(RSScheme(6, 3)).scheme == LrcScheme()


# --------------------------------------------- the mixed RS + LRC store

def _fill(store, vid, seed, n_files=12):
    rng = np.random.default_rng(seed)
    payloads = {}
    store.add_volume(vid)
    for i in range(n_files):
        data = rng.integers(0, 256, int(rng.integers(100, 4000)),
                            dtype=np.uint8).tobytes()
        n = Needle(id=i + 1, cookie=0xC0DE + i, data=data,
                   name=f"f{i}.bin".encode(), append_at_ns=10**18 + i)
        n.set_flags_from_fields()
        store.write_volume_needle(vid, n)
        payloads[i + 1] = data
    return payloads


def test_mixed_code_store_matches_jax(tmp_path):
    """RS(10,4) and LRC(10,2,2) volumes written and encoded by the port's
    Store; the JAX Store mounts a copy of the same files. Both degrade
    shard 0 of each volume and must read the same needles, count the same
    recovery strategies, and rebuild the same bytes."""
    store = Store([str(tmp_path / "t")], device="cpu")
    pay = {1: _fill(store, 1, seed=1), 2: _fill(store, 2, seed=2)}
    bases = {1: store.generate_ec_shards(1),
             2: store.generate_ec_shards(2, code="lrc")}
    store.delete_volume(1)
    store.delete_volume(2)
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    jstore = JStore([str(tmp_path / "j")], coder=jmake("cpu"))
    for s in (store, jstore):
        for vid in (1, 2):
            s.mount_ec_shards("", vid, list(range(TOTAL)))
    assert isinstance(store.coder_for(store.find_ec_volume(2)), LrcCoder)
    assert not isinstance(store.coder_for(store.find_ec_volume(1)),
                          LrcCoder)
    for vid in (1, 2):
        base = bases[vid]
        jbase = str(tmp_path / "j" / os.path.basename(base))
        for s, b in ((store, base), (jstore, jbase)):
            s.unmount_ec_shards(vid, [0])
            os.remove(b + layout.shard_ext(0))
        for nid, data in pay[vid].items():
            got = store.read_ec_shard_needle(vid, nid)
            want = jstore.read_ec_shard_needle(vid, nid)
            assert got.data == want.data == data
            assert (got.name, got.cookie, got.checksum) == \
                (want.name, want.cookie, want.checksum)
    assert store.ec_recover_stats == jstore.ec_recover_stats
    assert store.ec_recover_stats["local"] == len(pay[2])
    for vid in (1, 2):
        base = bases[vid]
        jbase = str(tmp_path / "j" / os.path.basename(base))
        stats, jstats = {}, {}
        assert tenc.rebuild_ec_files(
            base, store.coder_for(store.find_ec_volume(vid)),
            stats=stats) == [0]
        jenc.rebuild_ec_files(
            jbase, jstore.coder_for(jstore.find_ec_volume(vid)),
            stats=jstats)
        assert stats["sources"] == jstats["sources"]
        assert open(base + ".ec00", "rb").read() == \
            open(jbase + ".ec00", "rb").read()
    assert len(stats["sources"]) == SPEC.group_size  # the LRC volume
    store.close()
    jstore.close()
