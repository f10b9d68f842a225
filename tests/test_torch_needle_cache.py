"""The port's hot-needle cache (storage/needle_cache.py) and its Store
wiring against seaweedfs_tpu's, after tests/test_needle_cache.py (all of
it but the volume-server vacuum case, which waits for the server's port).

The deterministic unit cases run the same operations on both packages'
caches and compare every answer and the final stats. The Store cases run
the port's Store on its card coder as the plain version (device="cpu"):
records equal the payloads and the JAX Store's, a warm pass decodes
nothing (no K1 call), 32 concurrent cold readers of one degraded needle
cost one load, and deletes and overwrites invalidate.
"""

import os
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.models.coder import make_coder as jmake
from seaweedfs_tpu.storage import needle_cache as jcache
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu.storage.store import Store as JStore
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.storage import needle_cache as tcache
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.needle_cache import NeedleCache
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import (CookieMismatchError,
                                                DeletedError, NotFoundError)
from seaweedfs_tpu_torch.utils import resilience

BOTH = [pytest.param(tcache, id="port"), pytest.param(jcache, id="jax")]


def _fill(store, vid, needle_cls, n_files=12, seed=0, size=2000):
    rng = np.random.default_rng(seed)
    payloads = {}
    store.add_volume(vid)
    for i in range(n_files):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        nid = i + 1
        payloads[nid] = data
        n = needle_cls(id=nid, cookie=0xABC0 + i, data=data,
                       name=f"f{i}.bin".encode(), append_at_ns=10**18 + i)
        n.set_flags_from_fields()
        store.write_volume_needle(vid, n)
    return payloads


def _degraded(store, needle_cls, n_files=8, victims=(0, 3, 7, 11)):
    payloads = _fill(store, 1, needle_cls, n_files=n_files, seed=7)
    base = store.generate_ec_shards(1)
    store.delete_volume(1)
    store.mount_ec_shards("", 1, list(range(14)))
    store.unmount_ec_shards(1, list(victims))
    for sid in victims:
        os.remove(base + layout.shard_ext(sid))
    return payloads


def _port_store(tmp_path, **kw):
    return Store([str(tmp_path / "t")], device="cpu", **kw)


def _counting(store, delay=0.0):
    """Wrap the store coder's reconstruct; returns the call counter."""
    n = {"n": 0}
    real = store.coder.reconstruct

    def counted(shards):
        n["n"] += 1
        if delay:
            time.sleep(delay)  # hold the flight open so waiters pile up
        return real(shards)

    store.coder.reconstruct = counted
    return n


@pytest.fixture
def k1_calls(monkeypatch):
    calls = []
    real = rs_cuda.gf_apply

    def counted(mat, data, out=None):
        calls.append(data.shape)
        return real(mat, data, out)

    monkeypatch.setattr(rs_cuda, "gf_apply", counted)
    return calls


# ------------------------------------------------------ the cache alone

def _eviction_script(mod):
    blob = b"x" * 1000
    cost = len(blob) + mod._ENTRY_OVERHEAD
    cache = mod.NeedleCache(capacity_bytes=3 * cost, max_item_frac=1)
    out = [cache.offer(1, nid, blob, 1000, 2) for nid in (1, 2, 3)]
    out.append(cache.get(1, 1) is not None)  # LRU order now 2, 3, 1
    out.append(cache.offer(1, 4, blob, 1000, 2))
    out += [cache.get(1, nid) is not None for nid in (2, 1, 3, 4)]
    return out, cache.stats(), cache.capacity_bytes


def test_byte_budget_eviction_order_matches_jax():
    got, st, cap = _eviction_script(tcache)
    assert (got, st) == _eviction_script(jcache)[:2]
    assert got == [True] * 5 + [False, True, True, True]
    assert st["evictions"] == 1 and st["bytes"] <= cap


def _admission_script(mod):
    blob = b"y" * 1000
    cost = len(blob) + mod._ENTRY_OVERHEAD
    hot = {"est": (0, 0)}
    cache = mod.NeedleCache(capacity_bytes=2 * cost, max_item_frac=1,
                            hot_fn=lambda vid, nid: hot["est"],
                            admit_min=2)
    out = [cache.offer(1, 9, b"z" * (2 * cost + 1), 1, 2),  # over the cap
           cache.offer(1, 1, blob, 1000, 2),
           cache.offer(1, 2, blob, 1000, 2),
           cache.offer(1, 3, blob, 1000, 2)]  # full + cold: rejected
    out.append(cache.stats()["evictions"])
    hot["est"] = (5, 1)
    out.append(cache.offer(1, 4, blob, 1000, 2))  # hot: evicts the LRU
    out.append(cache.get(1, 1) is None)
    hot["est"] = (0, 0)
    out.append(cache.offer(1, 5, blob, 1000, 2, force=True))
    return out, cache.stats()


def test_item_cap_and_sketch_admission_match_jax():
    got, st = _admission_script(tcache)
    assert (got, st) == _admission_script(jcache)
    assert got == [False, True, True, False, 0, True, True, True]


def test_invalidation_and_reconfigure_match_jax():
    out = {}
    for mod in (tcache, jcache):
        cache = mod.NeedleCache(capacity_bytes=1 << 20)
        for nid in range(1, 6):
            cache.offer(2, nid, bytes([nid]) * 100, 100, 3, force=True)
        cache.offer(3, 1, b"q" * 100, 100, 3, force=True)
        cache.invalidate(2, 3)
        cache.invalidate_volume(3)
        res = [cache.contains(2, 3), cache.contains(2, 4),
               cache.contains(3, 1), cache.max_item_bytes()]
        cache.configure(capacity_bytes=0)
        res.append(cache.stats())
        out[mod] = res
    assert out[tcache] == out[jcache]
    assert out[tcache][:3] == [False, True, False]


@pytest.mark.parametrize("mod", BOTH)
def test_flight_exception_propagates_to_waiters(mod):
    cache = mod.NeedleCache(capacity_bytes=1 << 20)
    gate = threading.Event()
    errors = []

    def loader():
        gate.wait(5.0)
        raise NotFoundError("boom")

    def read():
        try:
            cache.get_or_load(1, 1, loader)
        except NotFoundError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=read) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    gate.set()
    for t in threads:
        t.join(5.0)
    assert errors == ["boom"] * 4
    # a failed flight leaves nothing behind: the next reader reloads
    assert cache.get_or_load(1, 1, lambda: (b"ok", 2, 2, False)) \
        == (b"ok", 2, 2)


@pytest.mark.parametrize("mod", BOTH)
def test_invalidation_blocks_stale_admission(mod):
    """A load in flight across an invalidation must not re-admit the
    bytes it read before the delete landed."""
    cache = mod.NeedleCache(capacity_bytes=1 << 20)
    loaded = threading.Event()
    release = threading.Event()

    def loader():
        loaded.set()
        release.wait(5.0)
        return b"stale", 5, 2, False

    t = threading.Thread(target=lambda: cache.get_or_load(1, 7, loader))
    t.start()
    assert loaded.wait(5.0)
    cache.invalidate(1, 7)  # delete lands mid-load
    release.set()
    t.join(5.0)
    assert cache.get(1, 7) is None
    assert cache.stats()["items"] == 0


def test_waiters_honour_the_ambient_deadline():
    """A waiter on another reader's flight gives up when its request
    deadline runs out (resilience.deadline_scope), with DeadlineExceeded."""
    cache = NeedleCache(capacity_bytes=1 << 20)
    release = threading.Event()
    started = threading.Event()

    def loader():
        started.set()
        release.wait(10.0)
        return b"late", 4, 2, False

    leader = threading.Thread(target=lambda: cache.get_or_load(1, 1, loader))
    leader.start()
    try:
        assert started.wait(5.0)
        with resilience.deadline_scope(resilience.Deadline.after(0.05)):
            with pytest.raises(resilience.DeadlineExceeded):
                cache.get_or_load(1, 1, loader)
    finally:
        release.set()
        leader.join(10.0)


# -------------------------------------------- the healthy read path

def test_healthy_bit_identity_and_mutation_safety(tmp_path):
    store = _port_store(tmp_path)
    jstore = JStore([str(tmp_path / "j")], coder=jmake("cpu"))
    payloads = _fill(store, 3, Needle, n_files=6, seed=1)
    _fill(jstore, 3, JNeedle, n_files=6, seed=1)
    store.needle_cache = NeedleCache(capacity_bytes=8 << 20)
    jstore.needle_cache = jcache.NeedleCache(capacity_bytes=8 << 20)
    v = store.find_volume(3)
    for nid, data in payloads.items():
        n1 = store.read_volume_needle(3, nid, cookie=0xABC0 + nid - 1)
        j1 = jstore.read_volume_needle(3, nid, cookie=0xABC0 + nid - 1)
        assert n1.data == j1.data == data and n1.checksum == j1.checksum
        # handler-style in-place mutation must not leak into the cache
        n1.data = b"mutated"
        n2 = store.read_volume_needle(3, nid)
        jstore.read_volume_needle(3, nid)
        assert n2.data == data == v.read_needle(nid).data
    assert store.needle_cache.stats() == jstore.needle_cache.stats()
    st = store.needle_cache.stats()
    assert st["hits"] >= len(payloads) and st["misses"] == len(payloads)
    with pytest.raises(CookieMismatchError):
        store.read_volume_needle(3, 1, cookie=0xDEAD)
    store.close()
    jstore.close()


def test_invalidate_on_delete_and_overwrite(tmp_path):
    store = _port_store(tmp_path)
    payloads = _fill(store, 4, Needle, n_files=3, seed=2)
    store.needle_cache = NeedleCache(capacity_bytes=8 << 20)
    for nid in payloads:
        store.read_volume_needle(4, nid)  # warm the cache
    store.delete_volume_needle(4, 1)
    with pytest.raises((NotFoundError, DeletedError)):
        store.read_volume_needle(4, 1)
    n = Needle(id=2, cookie=0xABC1, data=b"generation-two")
    n.set_flags_from_fields()
    store.write_volume_needle(4, n)
    assert store.read_volume_needle(4, 2).data == b"generation-two"
    assert store.read_volume_needle(4, 2).data == b"generation-two"
    store.close()


# ------------------------------------------------ the degraded EC path

def test_degraded_bit_identity_and_warm_hits(tmp_path, k1_calls):
    store = _port_store(tmp_path)
    jstore = JStore([str(tmp_path / "j")], coder=jmake("cpu"))
    payloads = _degraded(store, Needle)
    _degraded(jstore, JNeedle)
    store.needle_cache = NeedleCache(capacity_bytes=8 << 20)
    jstore.needle_cache = jcache.NeedleCache(capacity_bytes=8 << 20)
    reconstructs = _counting(store)
    del k1_calls[:]
    for nid, data in payloads.items():
        got = store.read_ec_shard_needle(1, nid)
        want = jstore.read_ec_shard_needle(1, nid)
        assert got.data == want.data == data
        assert got.checksum == want.checksum
    cold = reconstructs["n"]
    assert cold > 0 and len(k1_calls) == cold
    for nid, data in payloads.items():
        assert store.read_ec_shard_needle(1, nid).data == data
        jstore.read_ec_shard_needle(1, nid)
    assert reconstructs["n"] == cold and len(k1_calls) == cold
    assert store.needle_cache.stats() == jstore.needle_cache.stats()
    assert store.needle_cache.stats()["hits"] >= len(payloads)
    store.close()
    jstore.close()


def test_single_flight_32_concurrent_cold_readers(tmp_path):
    store = _port_store(tmp_path)
    payloads = _degraded(store, Needle, n_files=4)
    store.needle_cache = NeedleCache(capacity_bytes=8 << 20)
    nid, data = 2, payloads[2]
    decodes = _counting(store, delay=0.2)
    start = threading.Barrier(32)
    results, errors = [], []

    def read():
        try:
            start.wait(10.0)
            results.append(store.read_ec_shard_needle(1, nid).data)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=read) for _ in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert results == [data] * 32
    st = store.needle_cache.stats()
    assert st["misses"] == 1                   # one leader loaded
    assert st["hits"] + st["coalesced"] == 31  # nobody else decoded
    assert st["coalesced"] > 0                 # waiters really parked
    assert decodes["n"] <= 2  # one load's worth of interval decodes
    store.close()


def test_ec_range_read_caches_reconstruction(tmp_path):
    store = _port_store(tmp_path)
    jstore = JStore([str(tmp_path / "j")], coder=jmake("cpu"))
    payloads = _degraded(store, Needle, n_files=6)
    _degraded(jstore, JNeedle, n_files=6)
    store.needle_cache = NeedleCache(capacity_bytes=8 << 20)
    jstore.needle_cache = jcache.NeedleCache(capacity_bytes=8 << 20)
    reconstructs = _counting(store)
    for nid, data in payloads.items():
        got = store.read_ec_needle_data_range(1, nid, 10, 100)
        assert bytes(got) == data[10:110] == \
            bytes(jstore.read_ec_needle_data_range(1, nid, 10, 100))
    cold = reconstructs["n"]
    assert cold > 0  # shard 0 is lost and holds these small needles
    for nid, data in payloads.items():
        assert bytes(store.read_ec_needle_data_range(1, nid, 500, 64)) \
            == data[500:564]
    # every range that decoded once now slices the cached record
    assert reconstructs["n"] == cold
    store.close()
    jstore.close()


def test_ec_delete_invalidates(tmp_path):
    store = _port_store(tmp_path)
    payloads = _degraded(store, Needle, n_files=4)
    store.needle_cache = NeedleCache(capacity_bytes=8 << 20)
    assert store.read_ec_shard_needle(1, 3).data == payloads[3]
    store.delete_ec_shard_needle(1, 3)
    with pytest.raises(DeletedError):
        store.read_ec_shard_needle(1, 3)
    with pytest.raises(DeletedError):
        store.read_ec_needle_data_range(1, 3, 0, 10)
    store.close()
