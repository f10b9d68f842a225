"""The port's Store and its EC read path against seaweedfs_tpu's, after
tests/test_store_ec.py.

The JAX package's Store runs on its host coder; the port's runs on its
card coder as the plain version (device="cpu"), or on a BatchCoder over a
scheduler on a mesh of CPU lanes. Both stores are filled with the same
needles (fixed timestamps, so the .dat/.idx files are byte-identical),
encode them, and read the same shard files: needles, metadata, ranges,
recovery counts and rebuilt shards must be equal. Covered: the local ->
remote -> degraded ladder, the concurrent first-k remote fetch with a
wedged peer, the heartbeat and its deltas, subrange reads, EC deletes,
one K1 launch per recovered interval, and RS(6,3) / RS(12,6) degraded
reads held against the port's own decode (the JAX package maps those
volumes' intervals as if they had 10 data shards).

GF(256) has no rounding: every comparison is exact.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.models.coder import make_coder as jmake
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu.storage.store import Store as JStore
from seaweedfs_tpu_torch.models.coder import RSScheme, make_coder
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.ops.rs_torch import TorchCoder
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
from seaweedfs_tpu_torch.parallel.batcher import BatchCoder, EcBatchScheduler
from seaweedfs_tpu_torch.storage.erasure_coding import decoder as tdec
from seaweedfs_tpu_torch.storage.erasure_coding import ec_volume as tecv
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as tenc
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import (DeletedError, NotFoundError,
                                                Volume)

TOTAL = 14


def _needles(n_files, seed, lo=10, hi=5000):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_files):
        data = rng.integers(0, 256, int(rng.integers(lo, hi)),
                            dtype=np.uint8).tobytes()
        out.append((i + 1, 0xABC0 + i, data, f"f{i}.bin".encode()))
    return out


def _fill(store, vid, needles, needle_cls):
    store.add_volume(vid)
    for nid, cookie, data, name in needles:
        n = needle_cls(id=nid, cookie=cookie, data=data, name=name,
                       append_at_ns=10**18 + nid)
        n.set_flags_from_fields()
        store.write_volume_needle(vid, n)
    return {nid: data for nid, _, data, _ in needles}


def _pair(tmp_path, vid, needles, **kw):
    """The port's Store and the JAX package's, each with `vid` written and
    EC-encoded; the normal volume is deleted and all 14 shards mounted.
    Returns (store, jstore, base, jbase, payloads)."""
    store = Store([str(tmp_path / "t")], device="cpu", **kw)
    jstore = JStore([str(tmp_path / "j")], coder=jmake("cpu"))
    pay = _fill(store, vid, needles, Needle)
    _fill(jstore, vid, needles, JNeedle)
    vb = store.find_volume(vid).file_name()
    jvb = jstore.find_volume(vid).file_name()
    for ext in (".dat", ".idx"):
        assert open(vb + ext, "rb").read() == open(jvb + ext, "rb").read()
    base = store.generate_ec_shards(vid)
    jbase = jstore.generate_ec_shards(vid)
    for ext in [layout.shard_ext(i) for i in range(TOTAL)] + [".ecx"]:
        assert open(base + ext, "rb").read() == \
            open(jbase + ext, "rb").read(), ext
    for s in (store, jstore):
        s.delete_volume(vid)
        s.mount_ec_shards("", vid, list(range(TOTAL)))
    return store, jstore, base, jbase, pay


def _drop(store, base, vid, sids):
    store.unmount_ec_shards(vid, sids)
    for sid in sids:
        os.remove(base + layout.shard_ext(sid))


def _same_needle(a, b):
    assert (a.id, a.cookie, a.data, a.name, a.checksum, a.flags) == \
        (b.id, b.cookie, b.data, b.name, b.checksum, b.flags)


@pytest.fixture
def k1_calls(monkeypatch):
    """Counts calls of K1's single entry (one call is one launch on a
    card; CPU tensors run the plain version and count nothing)."""
    calls = []
    real = rs_cuda.gf_apply

    def counted(mat, data, out=None):
        calls.append(data.shape)
        return real(mat, data, out)

    monkeypatch.setattr(rs_cuda, "gf_apply", counted)
    return calls


def test_store_ec_end_to_end_matches_jax(tmp_path, k1_calls):
    store, jstore, base, jbase, pay = _pair(tmp_path, 1, _needles(40, 0))
    assert isinstance(store.coder, TorchCoder)
    for nid in pay:
        _same_needle(store.read_ec_shard_needle(1, nid, cookie=0xABBF + nid),
                     jstore.read_ec_shard_needle(1, nid))
    del k1_calls[:]
    victims = [0, 3, 7, 11]
    orig = {sid: open(base + layout.shard_ext(sid), "rb").read()
            for sid in victims}
    _drop(store, base, 1, victims)
    _drop(jstore, jbase, 1, victims)
    for nid, data in pay.items():
        got = store.read_ec_shard_needle(1, nid)
        _same_needle(got, jstore.read_ec_shard_needle(1, nid))
        assert got.data == data
    assert store.ec_recover_stats == jstore.ec_recover_stats
    # one K1 launch per recovered interval
    assert len(k1_calls) == store.ec_recover_stats["generic"] > 0
    assert tenc.rebuild_ec_files(base, store.coder) == victims
    for sid in victims:
        assert open(base + layout.shard_ext(sid), "rb").read() == orig[sid]
    store.mount_ec_shards("", 1, victims)
    assert store.find_ec_volume(1).shard_bits().shard_id_count() == TOTAL
    for nid, data in pay.items():
        assert store.read_ec_shard_needle(1, nid).data == data
    # delete through the EC path: equal tombstones and journals
    assert store.delete_ec_shard_needle(1, 1, cookie=0xABC0) == \
        jstore.delete_ec_shard_needle(1, 1, cookie=0xABC0)
    with pytest.raises(DeletedError):
        store.read_ec_shard_needle(1, 1)
    for ext in (".ecx", ".ecj"):
        assert open(base + ext, "rb").read() == \
            open(jbase + ext, "rb").read()
    store.close()
    jstore.close()


def test_rebuilt_shards_equal_the_originals(tmp_path):
    store, jstore, base, jbase, _ = _pair(tmp_path, 4, _needles(30, 4))
    victims = [1, 2, 12, 13]
    orig = {s: open(base + layout.shard_ext(s), "rb").read()
            for s in victims}
    _drop(store, base, 4, victims)
    assert tenc.rebuild_ec_files(base, store.coder) == victims
    assert tenc.rebuild_ec_files(base, store.coder) == []
    for s in victims:
        assert open(base + layout.shard_ext(s), "rb").read() == orig[s]
        assert open(jbase + layout.shard_ext(s), "rb").read() == orig[s]
    store.close()
    jstore.close()


def _split(tmp_path, store, base, vid, name, remote_sids):
    """Move `remote_sids` of a mounted EC volume into a second store's
    directory (the .ecx is copied); returns that store."""
    d = tmp_path / name
    d.mkdir()
    store.unmount_ec_shards(vid, remote_sids)
    for sid in remote_sids:
        shutil.move(base + layout.shard_ext(sid),
                    str(d / f"{vid}{layout.shard_ext(sid)}"))
    shutil.copy(base + ".ecx", str(d / f"{vid}.ecx"))
    return d


def _reader(other):
    def read(vid, shard_id, offset, size):
        ev = other.find_ec_volume(vid)
        if ev is None or shard_id not in ev.shards:
            return None
        return ev.shards[shard_id].read_at(offset, size)
    return read


def test_store_ec_remote_reader_matches_jax(tmp_path):
    """Shards 5..13 live on a second store; reads fall back to the remote
    reader wired to it (the volume-server RPC stand-in)."""
    store, jstore, base, jbase, pay = _pair(tmp_path, 2, _needles(10, 3))
    remote = list(range(5, TOTAL))
    bdir = _split(tmp_path, store, base, 2, "tb", remote)
    jbdir = _split(tmp_path, jstore, jbase, 2, "jb", remote)
    b = Store([str(bdir)], device="cpu")
    jb = JStore([str(jbdir)], coder=jmake("cpu"))
    b.mount_ec_shards("", 2, remote)
    jb.mount_ec_shards("", 2, remote)
    store.remote_shard_reader = _reader(b)
    jstore.remote_shard_reader = _reader(jb)
    for nid, data in pay.items():
        got = store.read_ec_shard_needle(2, nid)
        _same_needle(got, jstore.read_ec_shard_needle(2, nid))
        assert got.data == data
    assert store.ec_recover_stats == jstore.ec_recover_stats
    for s in (store, jstore, b, jb):
        s.close()


class _Breaker:
    def __init__(self, state, score):
        self.state, self._score = state, score

    def score(self):
        return self._score

    def probe_ripe(self):
        return False


class _Health:
    """A peer-health stand-in: the holders of shards 1 and 2 have open
    circuits, the rest are closed with distinct scores."""

    def rank(self, urls, pressure=None):
        return sorted(urls, key=lambda u: self.breaker(u).score())

    def breaker(self, url):
        sid = int(url[1:])
        return _Breaker("open" if sid in (1, 2) else "closed", 1.0 + sid)


def test_health_ranked_remote_fetch_matches_jax(tmp_path):
    """With a peer-health registry and a shard locator injected (the
    volume server's set-up), degraded recovery asks the healthy holders
    first, over-requests one column while a straggler is predicted, and
    leaves the open circuits for last: the port asks for the same shards
    as the JAX Store, never the open ones."""
    store, jstore, base, jbase, pay = _pair(tmp_path, 5, _needles(6, 21))
    remote = list(range(1, 13))  # shard 0 is lost, 13 stays local
    asked = {}
    peers = []
    for name, s, b in (("t", store, base), ("j", jstore, jbase)):
        os.remove(b + layout.shard_ext(0))
        s.unmount_ec_shards(5, [0])
        d = _split(tmp_path, s, b, 5, name + "b", remote)
        peer = Store([str(d)], device="cpu") if name == "t" else \
            JStore([str(d)], coder=jmake("cpu"))
        peer.mount_ec_shards("", 5, remote)
        peers.append(peer)
        log = asked.setdefault(name, [])
        inner = _reader(peer)

        def reader(vid, sid, offset, size, _log=log, _inner=inner):
            _log.append(sid)
            return _inner(vid, sid, offset, size)

        s.remote_shard_reader = reader
        s.peer_health = _Health()
        s.shard_locations = lambda vid: {sid: [f"p{sid}"] for sid in remote}
    for nid, data in pay.items():
        got = store.read_ec_shard_needle(5, nid)
        _same_needle(got, jstore.read_ec_shard_needle(5, nid))
        assert got.data == data
    # the wanted shard itself first (the remote rung of the ladder), then
    # the healthy holders; the fetch order within a wave is the pool's
    assert set(asked["t"]) == set(asked["j"]) == {0, *range(3, 13)}
    for s in (store, jstore, *peers):
        s.close()


def test_degraded_recovery_survives_a_wedged_peer(tmp_path):
    """Recovery fetches peer shards concurrently, first k wins: two
    wedged peers must not serialize or block the read when enough fast
    shards exist. The wedged readers wait on an event (bounded at 20 s)
    that the test sets once the reads are done, so no thread outlives it."""
    store, jstore, base, jbase, pay = _pair(tmp_path, 3, _needles(4, 7))
    os.remove(base + layout.shard_ext(0))
    store.unmount_ec_shards(3, [0])
    bdir = _split(tmp_path, store, base, 3, "b", list(range(1, 13)))
    b = Store([str(bdir)], device="cpu")
    b.mount_ec_shards("", 3, list(range(1, 13)))
    release = threading.Event()
    wedged = []
    inner = _reader(b)

    def reader(vid, shard_id, offset, size):
        if shard_id in (1, 2):
            wedged.append(shard_id)
            release.wait(20.0)
            return None
        return inner(vid, shard_id, offset, size)

    store.remote_shard_reader = reader
    t0 = time.perf_counter()
    try:
        for nid, data in pay.items():
            assert store.read_ec_shard_needle(3, nid).data == data
        elapsed = time.perf_counter() - t0
    finally:
        release.set()
    assert wedged, "the wedged peers were never asked"
    assert elapsed < 10.0, f"a wedged peer serialized recovery: {elapsed}"
    for s in (store, jstore, b):
        s.close()


def test_store_heartbeat_matches_jax(tmp_path):
    kw = dict(ip="10.0.0.1", port=9000, rack="r1", data_center="dc1")
    store = Store([str(tmp_path / "t")], device="cpu", **kw)
    jstore = JStore([str(tmp_path / "j")], coder=jmake("cpu"), **kw)
    needles = _needles(3, 9)
    _fill(store, 5, needles, Needle)
    _fill(jstore, 5, needles, JNeedle)
    store.add_volume(6, collection="c", replica_placement="010", ttl="3d")
    jstore.add_volume(6, collection="c", replica_placement="010", ttl="3d")
    hb, jhb = store.collect_heartbeat(), jstore.collect_heartbeat()
    assert hb == jhb
    assert hb["ip"] == "10.0.0.1" and hb["volumes"][0]["file_count"] == 3
    assert store.drain_deltas() == jstore.drain_deltas()
    assert store.drain_deltas()["new_volumes"] == []
    store.delete_volume(6)
    jstore.delete_volume(6)
    assert store.drain_deltas() == jstore.drain_deltas()
    store.close()
    jstore.close()


def _big(n_files=3, kb=700, seed=5):
    rng = np.random.default_rng(seed)
    return [(i + 1, 0xBEE0 + i,
             rng.integers(0, 256, kb * 1024, dtype=np.uint8).tobytes(),
             f"big{i}.bin".encode()) for i in range(n_files)]


@pytest.mark.parametrize("victim", [None, 1])
def test_ec_subrange_meta_and_range_reads_match_jax(tmp_path, victim):
    """ec_needle_meta reads only the record's head and tail; range reads
    return exact slices at block boundaries, healthy and degraded."""
    store, jstore, base, jbase, pay = _pair(tmp_path, 7, _big())
    if victim is not None:
        _drop(store, base, 7, [victim])
        _drop(jstore, jbase, 7, [victim])
    for nid, data in pay.items():
        n, size = store.ec_needle_meta(7, nid, cookie=0xBEDF + nid)
        jn, jsize = jstore.ec_needle_meta(7, nid)
        assert size == jsize == len(data)
        assert (n.name, n.mime, n.data, n.append_at_ns) == \
            (jn.name, jn.mime, jn.data, jn.append_at_ns)
        assert n.data == b""
        total = len(data)
        for lo, ln in [(0, 16), (total - 13, 13), (1234, 4096),
                       (0, total), (total // 2 - 100, 200)]:
            got = store.read_ec_needle_data_range(7, nid, lo, ln)
            assert bytes(got) == data[lo:lo + ln] == \
                bytes(jstore.read_ec_needle_data_range(7, nid, lo, ln))
    with pytest.raises(NotFoundError):
        store.ec_needle_meta(7, 1, cookie=0xDEAD)
    store.close()
    jstore.close()


def test_ec_subrange_degraded_read_is_frugal(tmp_path):
    """With a shard missing, a small range read reconstructs about k
    copies of that range, not the 700 KB record."""
    store, jstore, base, _, pay = _pair(tmp_path, 8, _big())
    jstore.close()
    ev = store.find_ec_volume(8)
    _drop(store, base, 8, [1])
    counted = {"bytes": 0}
    for shard in ev.shards.values():
        orig = shard.read_at

        def wrap(offset, length, _orig=orig):
            counted["bytes"] += length
            return _orig(offset, length)

        shard.read_at = wrap
    data = pay[2]
    lo, ln = len(data) - 4096, 2048
    assert store.read_ec_needle_data_range(8, 2, lo, ln) == \
        data[lo:lo + ln]
    assert counted["bytes"] < 120 * 1024, counted["bytes"]
    counted["bytes"] = 0
    assert store.ec_needle_meta(8, 2)[1] == len(data)
    assert counted["bytes"] < 80 * 1024, counted["bytes"]
    store.close()


@pytest.mark.parametrize("scheme,lost", [((6, 3), [0, 4, 7]),
                                         ((12, 6), [0, 3, 11, 12, 14, 17])])
def test_other_rs_schemes_read_degraded_as_the_port_decodes(
        tmp_path, scheme, lost, k1_calls):
    """RS(6,3) and RS(12,6) volumes big enough for a second row of 1 MiB
    small blocks (block k is shard 0 of row 1): the Store's degraded reads
    equal the payloads and the needles of the .dat the port's decoder
    rebuilds from the same shards. Each volume decodes on a card coder of
    its own shape, one K1 launch per recovered interval."""
    k, m = scheme
    sch = RSScheme(k, m)
    coder = make_coder("torch", sch, device="cpu")
    d = tmp_path / "t"
    d.mkdir()
    v = Volume(str(d), "", 9)
    rng = np.random.default_rng(k)
    pay = {}
    for i in range(2 * k):
        data = rng.integers(0, 256, int(rng.integers(400, 1000)) * 1024,
                            dtype=np.uint8).tobytes()
        v.write_needle(Needle(id=i + 1, cookie=i, data=data,
                              append_at_ns=10**18 + i))
        pay[i + 1] = data
    v.close()
    base = str(d / "9")
    dat_size = os.path.getsize(base + ".dat")
    assert dat_size > layout.SMALL_BLOCK_SIZE * k
    tenc.write_sorted_ecx(base)
    tenc.write_ec_files(base, coder)
    tecv.write_volume_info(base, 3, sch)
    os.rename(base + ".dat", base + ".dat.orig")
    store = Store([str(d)], device="cpu")
    store.mount_ec_shards("", 9, [s for s in range(k + m) if s not in lost])
    ev = store.find_ec_volume(9)
    assert ev.data_shards == k and store.coder_for(ev).scheme == sch
    for sid in lost:
        os.remove(base + layout.shard_ext(sid))
    del k1_calls[:]
    for nid, data in pay.items():
        assert store.read_ec_shard_needle(9, nid).data == data
    assert len(k1_calls) == store.ec_recover_stats["generic"] > 0
    store.close()
    # the port's own decode of the same shards
    tenc.rebuild_ec_files(base, coder)
    tdec.write_dat_file(base, dat_size, data_shards=k)
    assert open(base + ".dat", "rb").read() == \
        open(base + ".dat.orig", "rb").read()
    os.remove(base + ".dat.orig")
    dv = Volume(str(d), "", 9)
    for nid, data in pay.items():
        assert dv.read_needle(nid).data == data
    dv.close()


def test_batch_coder_store_reads_degraded_as_jax(tmp_path):
    """A Store whose coder is a BatchCoder over one scheduler (the volume
    server's -ecBatcher set-up), read by 8 threads at once: the same
    needles as the JAX Store, every degraded interval through the
    scheduler, no fallback, and one batch-entry call per mesh batch."""
    calls = []
    real = rs_cuda.gf_apply_batch

    def counted(mats, data, out=None):
        calls.append(data.shape[0])
        return real(mats, data, out)

    sched = EcBatchScheduler(mesh=mesh_mod.batch_mesh(1, device="cpu"),
                             window_s=0.01)
    try:
        store, jstore, base, jbase, pay = _pair(
            tmp_path, 11, _needles(24, 11), coder=BatchCoder(sched))
        _drop(store, base, 11, [0, 5, 11, 13])
        _drop(jstore, jbase, 11, [0, 5, 11, 13])
        jobs0 = sched.stats()["jobs_total"]  # the encode's
        mesh0 = sched.stats()["mesh_batches"]
        rs_cuda.gf_apply_batch = counted
        errors = []

        def read(nids):
            try:
                for nid in nids:
                    _same_needle(store.read_ec_shard_needle(11, nid),
                                 jstore.read_ec_shard_needle(11, nid))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=read, args=(list(pay)[i::8],))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        rs_cuda.gf_apply_batch = real
        assert not errors, errors
        st = sched.stats()
        assert st["coder_fallbacks"] == 0
        assert st["jobs_total"] - jobs0 == \
            store.ec_recover_stats["generic"] > 0
        assert len(calls) == st["mesh_batches"] - mesh0
        assert store.ec_recover_stats == jstore.ec_recover_stats
        store.close()
        jstore.close()
    finally:
        rs_cuda.gf_apply_batch = real
        sched.stop()


def test_store_volumes_and_disks_match_jax(tmp_path):
    """The normal-volume surface: typed disks, read-only marks, moves
    between disks, TTL volumes and unmount/mount, with the same deltas as
    the JAX Store."""
    kw = dict(disk_types=["hdd", "ssd"])
    store = Store([str(tmp_path / "t0"), str(tmp_path / "t1")],
                  device="cpu", **kw)
    jstore = JStore([str(tmp_path / "j0"), str(tmp_path / "j1")],
                    coder=jmake("cpu"), **kw)
    needles = _needles(5, 13)
    for s, cls in ((store, Needle), (jstore, JNeedle)):
        _fill(s, 1, needles, cls)
        s.add_volume(2, disk_type="ssd")
        with pytest.raises(ValueError):
            s.add_volume(3, disk_type="nvme")
        assert s.mark_volume_readonly(2)
        assert s.move_volume_disk(1, "ssd")
        assert s.unmount_volume(1) and s.find_volume(1) is None
        assert s.mount_volume(1)
        assert s.delete_volume_needle(1, 2) > 0
        with pytest.raises(Exception):
            s.read_volume_needle(1, 2)
    for nid in (1, 3, 4, 5):
        _same_needle(store.read_volume_needle(1, nid),
                     jstore.read_volume_needle(1, nid))
    assert store.drain_deltas() == jstore.drain_deltas()
    assert store.collect_heartbeat() == jstore.collect_heartbeat()
    store.close()
    jstore.close()
