"""The port's volume EC path against seaweedfs_tpu's, byte for byte.

A .dat written by the JAX package's Volume is encoded by both packages,
serially and pipelined, at scaled-down block sizes (as
tests/test_ec_pipeline.py picks them) so that large rows, small rows and a
partial tail all occur. Shards, .ecx and .vif must be identical; rebuilds
of mixed 4-loss patterns must restore the originals; write_dat_file must
round-trip; the port must read every needle from shards the JAX package
wrote. The port's coder runs with device="cpu" (the plain version).

Also held against the JAX package: a coder that defines only encode and
reconstruct (the seam's defaults and the encoder's fallbacks), .ecj
deletes and rebuild_ecx_file, ShardBits and the EC volume's lifecycle, the
layout helpers, the partial-repair chain planner, and the pipelines'
clock (utils/clockctl).
"""

import glob
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.models.coder import ErasureCoder as JErasureCoder
from seaweedfs_tpu.models.coder import make_coder as jmake
from seaweedfs_tpu.ops.rs_cpu import CpuCoder as JCpuCoder
from seaweedfs_tpu.storage import needle as jneedle
from seaweedfs_tpu.storage import volume as jvol
from seaweedfs_tpu.storage.erasure_coding import decoder as jdec
from seaweedfs_tpu.storage.erasure_coding import ec_volume as jecv
from seaweedfs_tpu.storage.erasure_coding import encoder as jenc
from seaweedfs_tpu_torch.models.coder import ErasureCoder, make_coder
from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoder
from seaweedfs_tpu_torch.parallel import streaming
from seaweedfs_tpu_torch.storage import needle as tneedle
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.erasure_coding import decoder as tdec
from seaweedfs_tpu_torch.storage.erasure_coding import ec_volume as tecv
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as tenc
from seaweedfs_tpu_torch.storage.erasure_coding import layout

LB, SB = 4096, 1024
K, TOTAL = 10, 14
VID = 7


def _jax_volume(d, n_needles: int, seed: int) -> dict:
    """Write a volume with the JAX package; returns {id: (cookie, data)}."""
    rng = np.random.default_rng(seed)
    v = jvol.Volume(str(d), "", VID)
    payloads = {}
    for i in range(n_needles):
        nid = int(rng.integers(1, 1 << 40))
        cookie = int(rng.integers(0, 1 << 32))
        data = rng.bytes(int(rng.integers(1, 3000)))
        v.write_needle(jneedle.Needle(id=nid, cookie=cookie, data=data,
                                      append_at_ns=10**18 + i))
        payloads[nid] = (cookie, data)
    v.close()
    return payloads


def _clone(src, dst):
    dst.mkdir()
    for ext in (".dat", ".idx"):
        shutil.copy(src / f"{VID}{ext}", dst / f"{VID}{ext}")
    return str(dst / str(VID))


def _files(base: str, exts) -> list[bytes]:
    return [open(base + e, "rb").read() for e in exts]


SHARDS = [layout.shard_ext(i) for i in range(TOTAL)]


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """One JAX-written volume (two large rows, small rows and a partial
    tail at LB/SB) encoded by the JAX package's CPU coders, serially and
    pipelined."""
    root = tmp_path_factory.mktemp("ec")
    src = root / "src"
    src.mkdir()
    payloads = _jax_volume(src, 70, seed=1)
    dat_size = os.path.getsize(src / f"{VID}.dat")
    assert dat_size > 2 * LB * K and dat_size % (SB * K) != 0
    jbase = _clone(src, root / "jax")
    jenc.write_sorted_ecx(jbase)
    jenc.write_ec_files(jbase, jmake("cpu"), LB, SB, batch_size=SB)
    jecv.write_volume_info(jbase, 3, jmake("cpu").scheme)
    # the JAX package's pipelined encode of the same volume
    jpbase = _clone(src, root / "jax_pipelined")
    jenc.write_ec_files(jpbase, jmake("cpu-mt"), LB, SB, batch_size=SB,
                        pipelined=True)
    return root, payloads, jbase


@pytest.mark.parametrize("pipelined,batch", [(False, SB), (True, SB),
                                             (True, 77), (False, LB)])
def test_encode_matches_jax(encoded, tmp_path, pipelined, batch):
    root, _, jbase = encoded
    tbase = _clone(root / "src", tmp_path / "t")
    coder = make_coder(device="cpu")
    tenc.write_sorted_ecx(tbase)
    tenc.write_ec_files(tbase, coder, LB, SB, batch_size=batch,
                        pipelined=pipelined)
    tecv.write_volume_info(tbase, 3, coder.scheme)
    exts = SHARDS + [".ecx", ".vif"]
    assert _files(tbase, exts) == _files(jbase, exts)
    assert _files(tbase, SHARDS) == \
        _files(str(root / "jax_pipelined" / str(VID)), SHARDS)
    assert not glob.glob(str(tmp_path / "t" / "*.tmp"))


def test_pipelined_multi_reader_matches_jax(encoded, tmp_path):
    root, _, jbase = encoded
    tbase = _clone(root / "src", tmp_path / "t")
    stats = {}
    streaming.pipelined_encode_file(tbase, large_block=LB, small_block=SB,
                                    batch_size=SB,
                                    coder=make_coder(device="cpu"),
                                    readers=2, stats=stats)
    assert _files(tbase, SHARDS) == _files(jbase, SHARDS)
    assert stats["batches"] == len(list(layout.iter_encode_batches(
        os.path.getsize(tbase + ".dat"), LB, SB, SB, K)))


@pytest.mark.parametrize("drop", [[0, 5, 11, 13], [1, 2, 3, 4],
                                  [10, 11, 12, 13], [0, 9, 12], [7]])
@pytest.mark.parametrize("pipelined", [False, True])
def test_rebuild_of_jax_shards_matches(encoded, tmp_path, drop, pipelined):
    root, _, jbase = encoded
    d = tmp_path / "r"
    d.mkdir()
    for e in SHARDS:
        shutil.copy(jbase + e, d / f"{VID}{e}")
    base = str(d / str(VID))
    want = _files(jbase, SHARDS)
    for i in drop:
        os.remove(base + layout.shard_ext(i))
    stats = {}
    got = tenc.rebuild_ec_files(base, make_coder(device="cpu"),
                                batch_size=3 * SB, pipelined=pipelined,
                                stats=stats)
    assert sorted(got) == sorted(drop)
    assert _files(base, SHARDS) == want
    # the JAX package plans the same loss from the same survivors
    present = [i for i in range(TOTAL) if i not in drop]
    assert stats["sources"] == jenc.plan_rebuild_sources(
        jmake("cpu"), present, drop)[0]


def test_decode_jax_shards_to_dat(encoded, tmp_path):
    root, _, jbase = encoded
    d = tmp_path / "d"
    d.mkdir()
    for e in SHARDS[:K] + [".ecx", ".vif"]:
        shutil.copy(jbase + e, d / f"{VID}{e}")
    base = str(d / str(VID))
    size = tdec.find_dat_file_size(base, base)
    assert size == jdec.find_dat_file_size(jbase, jbase) \
        == os.path.getsize(root / "src" / f"{VID}.dat")
    for pipelined in (False, True):
        tdec.write_dat_file(base, size, LB, SB, pipelined=pipelined)
        assert open(base + ".dat", "rb").read() == \
            (root / "src" / f"{VID}.dat").read_bytes()
    tdec.write_idx_file_from_ec_index(base)
    assert open(base + ".idx", "rb").read() == open(jbase + ".ecx", "rb").read()


def test_read_needles_from_jax_shards(encoded):
    _, payloads, jbase = encoded
    d = os.path.dirname(jbase)
    ev = tecv.EcVolume(d, "", VID)
    for sid in range(TOTAL):
        ev.add_shard(tecv.EcVolumeShard(d, "", VID, sid))
    try:
        assert ev.scheme.total_shards == TOTAL and ev.version == 3
        for nid, (cookie, data) in payloads.items():
            intervals, _, size = ev.locate_needle(nid, LB, SB)
            blob = b"".join(ev.read_interval(iv, LB, SB)[0]
                            for iv in intervals)
            n = tneedle.Needle.from_bytes(blob, size, ev.version)
            assert (n.id, n.cookie, n.data) == (nid, cookie, data)
        with pytest.raises(tecv.NotFoundError):
            ev.locate_needle(0, LB, SB)
    finally:
        ev.close()


class _BoomCoder:
    """A CPU coder that fails on its Nth batch."""

    def __init__(self, blow_at: int):
        self._inner = make_coder(device="cpu")
        self.scheme = self._inner.scheme
        self.calls = 0
        self.blow_at = blow_at

    def encode_into(self, data, out):
        self.calls += 1
        if self.calls >= self.blow_at:
            raise RuntimeError("disk on fire")
        return self._inner.encode_into(data, out)


def test_pipelined_encode_crash_leaves_nothing(encoded, tmp_path):
    root, _, _ = encoded
    base = _clone(root / "src", tmp_path / "c")
    with pytest.raises(RuntimeError, match="disk on fire"):
        streaming.pipelined_encode_file(base, large_block=LB, small_block=SB,
                                        batch_size=SB,
                                        coder=_BoomCoder(blow_at=3))
    assert sorted(os.listdir(tmp_path / "c")) == [f"{VID}.dat", f"{VID}.idx"]


# ------------------------------------------------ a bytes-only coder

class _PortPlain(ErasureCoder):
    """An ErasureCoder that defines only encode and reconstruct (the
    coder seam's minimum), delegating to the port's host coder."""

    def __init__(self):
        super().__init__()
        self._inner = CpuCoder()

    def encode(self, shards):
        return self._inner.encode(shards)

    def reconstruct(self, shards):
        return self._inner.reconstruct(shards)


class _JaxPlain(JErasureCoder):
    def __init__(self):
        super().__init__()
        self._inner = JCpuCoder()

    def encode(self, shards):
        return self._inner.encode(shards)

    def reconstruct(self, shards):
        return self._inner.reconstruct(shards)


@pytest.fixture(scope="module")
def one_needle(tmp_path_factory):
    """The smallest input that showed the seam's gap: one needle of
    30,000 bytes, encoded and .ec02-rebuilt by the JAX package through a
    bytes-only coder."""
    root = tmp_path_factory.mktemp("plain")
    src = root / "src"
    src.mkdir()
    v = jvol.Volume(str(src), "", VID)
    rng = np.random.default_rng(30000)
    v.write_needle(jneedle.Needle(id=1, cookie=7, data=rng.bytes(30000),
                                  append_at_ns=10**18))
    v.close()
    jbase = _clone(src, root / "jax")
    jenc.write_ec_files(jbase, _JaxPlain(), LB, SB, batch_size=SB)
    shards = _files(jbase, SHARDS)
    os.remove(jbase + ".ec02")
    jenc.rebuild_ec_files(jbase, _JaxPlain(), batch_size=SB)
    assert _files(jbase, [".ec02"]) == [shards[2]]
    return root, shards


@pytest.mark.parametrize("pipelined", [False, True])
def test_bytes_only_coder_encodes_as_jax(one_needle, tmp_path, pipelined):
    root, shards = one_needle
    tbase = _clone(root / "src", tmp_path / "t")
    tenc.write_ec_files(tbase, _PortPlain(), LB, SB, batch_size=SB,
                        pipelined=pipelined)
    assert _files(tbase, SHARDS) == shards


@pytest.mark.parametrize("pipelined", [False, True])
def test_bytes_only_coder_rebuilds_as_jax(one_needle, tmp_path, pipelined):
    """The serial rebuild takes reconstruct_arrays (the seam's default);
    the pipelined one rebuilds on the host coder, as the JAX package's
    does. Both give the JAX package's .ec02."""
    root, shards = one_needle
    d = tmp_path / "t"
    d.mkdir()
    tbase = str(d / str(VID))
    for i, b in enumerate(shards):
        if i != 2:
            open(tbase + layout.shard_ext(i), "wb").write(b)
    stats = {}
    got = tenc.rebuild_ec_files(tbase, _PortPlain(), batch_size=SB,
                                pipelined=pipelined, stats=stats)
    assert got == [2]
    assert _files(tbase, [".ec02"]) == [shards[2]]
    # the serial path read every survivor; the pipelined one the first k
    assert len(stats["sources"]) == (K if pipelined else TOTAL - 1)


def test_seam_defaults_match_jax():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(K, 333), dtype=np.uint8)
    mine, ref = _PortPlain(), _JaxPlain()
    assert np.array_equal(mine.encode_array(data), ref.encode_array(data))
    full = np.concatenate([data, ref.encode_array(data)])
    present = {i: full[i] for i in range(TOTAL) if i not in (0, 5, 11, 13)}
    got = mine.reconstruct_arrays(present, 333)
    want = ref.reconstruct_arrays(present, 333)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


# ----------------------------------------- .ecj deletes, .ecx rebuild

def _ecx_files(d, entries):
    base = str(d / "7")
    with open(base + ".idx", "wb") as f:
        for key, off, size in entries:
            f.write(t.pack_entry(key, off, size))
    return base


def test_ecx_sort_search_delete_journal_matches_jax(tmp_path):
    """ref tests/test_ec_layout.py:141 on both packages: the sorted .ecx,
    its search, an EcVolume delete (.ecx tombstone + .ecj journal), the
    .idx regenerated from them, and rebuild_ecx_file re-applying a journal
    are byte-identical."""
    entries = [(50, 8, 100), (3, 16, 10), (99, 24, 7), (7, 32, 42),
               (3, 40, 11), (99, 0, t.TOMBSTONE_FILE_SIZE)]
    out = {}
    for name, enc, dec, ecv in (("t", tenc, tdec, tecv),
                                ("j", jenc, jdec, jecv)):
        d = tmp_path / name
        d.mkdir()
        base = _ecx_files(d, entries)
        enc.write_sorted_ecx(base)
        with open(base + ".ecx", "r+b") as ecx:
            sz = os.path.getsize(base + ".ecx")
            found = ecv.search_needle_from_sorted_index(ecx, sz, 7)
            with pytest.raises(ecv.NotFoundError):
                ecv.search_needle_from_sorted_index(ecx, sz, 12345)
        ev = ecv.EcVolume(str(d), "", 7)
        ev.delete_needle(7)
        ev.delete_needle(4242)  # absent: no journal entry
        ev.close()
        journal = list(ecv.iterate_ecj_file(base))
        files = _files(base, [".ecx", ".ecj"])
        dec.write_idx_file_from_ec_index(base)
        idx = _files(base, [".idx"])
        enc.write_sorted_ecx(base)
        with open(base + ".ecj", "wb") as f:
            f.write((50).to_bytes(8, "big"))
            f.write((7).to_bytes(8, "big"))
        enc.rebuild_ecx_file(base)
        out[name] = (found, journal, files, idx,
                     os.path.exists(base + ".ecj"),
                     _files(base, [".ecx"]))
    assert out["t"] == out["j"]
    found, journal, _, _, ecj_left, _ = out["t"]
    assert found == (32, 42) and journal == [7] and not ecj_left


def test_shard_bits_and_ec_volume_lifecycle_match_jax(tmp_path):
    from seaweedfs_tpu.storage.erasure_coding.ec_volume import \
        ShardBits as JShardBits
    b = tecv.ShardBits().add_shard_id(0).add_shard_id(5).add_shard_id(13)
    jb = JShardBits().add_shard_id(0).add_shard_id(5).add_shard_id(13)
    for f in (lambda x: x.shard_ids(), lambda x: x.shard_id_count(),
              lambda x: x.minus_parity_shards().shard_ids(),
              lambda x: x.remove_shard_id(5).shard_ids(),
              lambda x: x.plus(type(x)().add_shard_id(1)).shard_ids(),
              lambda x: x.minus(type(x)().add_shard_id(5)).bits):
        assert f(b) == f(jb)
    # mount two shards, drop one, destroy: every file of the EC volume goes
    base = _ecx_files(tmp_path, [(1, 1, 10)])
    tenc.write_sorted_ecx(base)
    for sid in (0, 3):
        open(base + layout.shard_ext(sid), "wb").write(b"\0" * 64)
    tecv.write_volume_info(base, 3, make_coder("cpu").scheme)
    ev = tecv.EcVolume(str(tmp_path), "", 7)
    for sid in (0, 3):
        ev.add_shard(tecv.EcVolumeShard(str(tmp_path), "", 7, sid))
    assert ev.shard_bits().shard_ids() == [0, 3]
    ev.delete_needle(1)
    ev.delete_shard(3).close()
    assert ev.shard_bits().shard_ids() == [0]
    ev.destroy()
    assert sorted(os.listdir(tmp_path)) == ["7.ec03", "7.idx"]


# ------------------------------------------------ small layout helpers

@pytest.mark.parametrize("dat_size", [0, 1, SB * K, LB * K + 1,
                                      3 * LB * K + SB * 7 + 5])
def test_shard_file_size_and_index_count_match_jax(tmp_path, dat_size):
    from seaweedfs_tpu.storage import idx as jidx
    from seaweedfs_tpu.storage.erasure_coding import layout as jlayout
    from seaweedfs_tpu_torch.storage import idx as tidx
    for data_shards in (6, 10, 12):
        assert layout.shard_file_size(dat_size, LB, SB, data_shards) == \
            jlayout.shard_file_size(dat_size, LB, SB, data_shards)
    p = str(tmp_path / "x.idx")
    open(p, "wb").write(b"\0" * (16 * (dat_size % 50)))
    assert tidx.index_entry_count(p) == jidx.index_entry_count(p)


# ------------------------------------------ the partial-chain planner

@pytest.mark.parametrize("case", range(4))
def test_plan_chain_matches_jax(case):
    """ref tests/test_partial_repair.py:27 and seeded variants: the port's
    planner groups by holder, excludes and orders exactly as the JAX
    package's."""
    from seaweedfs_tpu.storage.erasure_coding import partial as jpart
    from seaweedfs_tpu_torch.storage.erasure_coding import partial as tpart
    rng = np.random.default_rng(case)
    urls = ["a:1", "b:1", "c:1", "d:1"]
    if case == 0:
        sources = {5: ["b:1"], 6: ["b:1", "c:1"], 7: ["c:1"]}
        coeffs = {5: [1, 2], 6: [3, 4], 7: [5, 6]}
        pressure = None
    else:
        sids = sorted(rng.choice(14, size=6, replace=False).tolist())
        sources = {s: list(rng.choice(urls, size=int(rng.integers(1, 4)),
                                      replace=False)) for s in sids}
        coeffs = {s: rng.integers(0, 256, 2).tolist() for s in sids}
        pressure = {u: float(rng.random()) for u in urls} \
            if case > 1 else None
    for excl in ((), ("a:1",)):
        got = tpart.plan_chain(sources, coeffs, exclude_urls=excl,
                               pressure=pressure)
        want = jpart.plan_chain(sources, coeffs, exclude_urls=excl,
                                pressure=pressure)
        assert got == want
        if got is not None:
            assert tpart.chain_shard_ids(got) == \
                jpart.chain_shard_ids(want)
    assert tpart.plan_chain({5: []}, {5: [1]}) is None
    assert tpart.SHARDS_HEADER == jpart.SHARDS_HEADER


# -------------------------------------------- the pipeline's clock

def test_frozen_clock_freezes_the_stage_seconds(encoded, tmp_path):
    """The pipelines time themselves through utils/clockctl: under a
    frozen clock every stage's seconds are 0 (the bytes are unchanged)."""
    from seaweedfs_tpu_torch.utils import clockctl
    root, _, jbase = encoded
    tbase = _clone(root / "src", tmp_path / "t")
    stats = {}
    with clockctl.install(lambda: 1234.5):
        streaming.pipelined_encode_file(tbase, large_block=LB,
                                        small_block=SB, batch_size=SB,
                                        coder=make_coder(device="cpu"),
                                        stats=stats)
        for i in (0, 5, 11, 13):
            os.remove(tbase + layout.shard_ext(i))
        rstats = {}
        streaming.pipelined_rebuild_files(tbase, make_coder(device="cpu"),
                                          batch_size=SB, stats=rstats)
    assert _files(tbase, SHARDS) == _files(jbase, SHARDS)
    for st in (stats, rstats):
        for key in ("read_s", "encode_s", "write_s", "device_wait_s",
                    "wall_s"):
            assert st[key] == 0.0, (key, st)
