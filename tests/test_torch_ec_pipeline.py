"""The port's volume EC path against seaweedfs_tpu's, byte for byte.

A .dat written by the JAX package's Volume is encoded by both packages,
serially and pipelined, at scaled-down block sizes (as
tests/test_ec_pipeline.py picks them) so that large rows, small rows and a
partial tail all occur. Shards, .ecx and .vif must be identical; rebuilds
of mixed 4-loss patterns must restore the originals; write_dat_file must
round-trip; the port must read every needle from shards the JAX package
wrote. The port's coder runs with device="cpu" (the plain version).
"""

import glob
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.models.coder import make_coder as jmake
from seaweedfs_tpu.storage import needle as jneedle
from seaweedfs_tpu.storage import volume as jvol
from seaweedfs_tpu.storage.erasure_coding import decoder as jdec
from seaweedfs_tpu.storage.erasure_coding import ec_volume as jecv
from seaweedfs_tpu.storage.erasure_coding import encoder as jenc
from seaweedfs_tpu_torch.models.coder import make_coder
from seaweedfs_tpu_torch.parallel import streaming
from seaweedfs_tpu_torch.storage import needle as tneedle
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
