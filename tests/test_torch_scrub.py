"""The port's integrity scrubber (scrub/scrubber.py) and its token bucket
(utils/limiter.py) against seaweedfs_tpu's, after tests/test_scrub.py:48-184
and the scrub half of tests/test_lrc.py:229.

The port's Store runs the card coder's plain version (device="cpu"); the
JAX package's Store runs its host coder. Both scrub copies of the same
files and must report the same corruptions, byte ranges and strategies.
K1 launches are counted by wrapping rs_cuda.gf_apply: a clean pass over an
RS volume is one call per row group (coder.encode_array).
"""

import os
import shutil
import threading

import numpy as np
import pytest

from seaweedfs_tpu.models.coder import make_coder as jmake
from seaweedfs_tpu.ops.rs_cpu import gf_partial_product as jpartial
from seaweedfs_tpu.scrub import Scrubber as JScrubber
from seaweedfs_tpu.storage.store import Store as JStore
from seaweedfs_tpu.utils import clockctl as jclock
from seaweedfs_tpu.utils.limiter import InFlightLimiter as JInFlight
from seaweedfs_tpu.utils.limiter import TokenBucket as JTokenBucket
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.ops.rs_cpu import gf_partial_product
from seaweedfs_tpu_torch.ops.rs_torch import TorchCoder
from seaweedfs_tpu_torch.scrub import Scrubber
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.utils.limiter import InFlightLimiter, TokenBucket
from tools import corrupt

KB = 1024
TOTAL = layout.TOTAL_SHARDS_COUNT


class _Clock:
    """A virtual monotonic clock; sleeping advances it, by at least a
    microsecond as a real sleep would (a bucket's last sub-ulp wait
    would otherwise never move it)."""

    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t

    def sleep(self, s):
        self.t += max(s, 1e-6)


# ------------------------------------------------------- rate limiting

BUCKET_SCRIPTS = [
    # (rate B/s, capacity, consumes)
    (1024 * KB, 64 * KB, [64 * KB] * 8),
    (100.0, 50.0, [10, 200, 5, 5, 300, 1]),
    (1.0, None, [1, 2, 3]),
    (0.0, None, [10 ** 12, 1]),
]


def _bucket_trace(clock_mod, bucket_cls, rate, cap, consumes, set_rate):
    clk = _Clock()
    out = []
    with clock_mod.install(clk.now, sleep_fn=clk.sleep):
        b = bucket_cls(rate, capacity=cap)
        for i, n in enumerate(consumes):
            assert b.consume(n)
            out.append((round(clk.t, 9), round(b.peek(), 6)))
            if i == 1 and set_rate is not None:
                b.set_rate(set_rate)
    return out


@pytest.mark.parametrize("script", range(len(BUCKET_SCRIPTS)))
@pytest.mark.parametrize("set_rate", [None, 2048.0])
def test_token_bucket_matches_jax_under_a_frozen_clock(script, set_rate):
    rate, cap, consumes = BUCKET_SCRIPTS[script]
    got = _bucket_trace(clockctl, TokenBucket, rate, cap, consumes,
                        set_rate)
    want = _bucket_trace(jclock, JTokenBucket, rate, cap, consumes,
                         set_rate)
    assert got == want
    if rate > 0 and set_rate is None:
        # the bucket starts empty and earns tokens only at `rate`: what
        # was taken, plus what is left, less one burst of its capacity
        capacity = cap if cap is not None else max(rate, 1.0)
        t_end, left = got[-1]
        assert t_end * rate >= sum(consumes) + left - capacity - 1e-6


def test_token_bucket_stop_event_aborts_as_jax():
    for cls in (TokenBucket, JTokenBucket):
        ev = threading.Event()
        ev.set()
        assert not cls(1).consume(10 ** 9, ev)


def _inflight_trace(clock_mod, cls):
    clk = _Clock()
    out = []
    with clock_mod.install(clk.now, sleep_fn=clk.sleep):
        lim = cls(100, timeout=0.0)
        for op, n in [("a", 60), ("a", 30), ("a", 20), ("r", 30),
                      ("a", 20), ("a", 500), ("r", 60), ("r", 20),
                      ("a", 500), ("a", 1), ("r", 500), ("a", 0)]:
            if op == "a":
                out.append(lim.try_acquire(n, timeout=0.0))
            else:
                lim.release(n)
            out.append(lim.in_flight)
        out.append(cls(0).try_acquire(10 ** 12))
    return out


def test_inflight_limiter_matches_jax_under_a_frozen_clock():
    assert _inflight_trace(clockctl, InFlightLimiter) == \
        _inflight_trace(jclock, JInFlight)


# ------------------------------------------------- scrubbing a bare Store

def _fill(store, vid, n_needles, needle_bytes, needle_cls, seed=11):
    rng = np.random.default_rng(seed)
    store.add_volume(vid)
    for i in range(n_needles):
        data = rng.integers(0, 256, needle_bytes, dtype=np.uint8).tobytes()
        store.write_volume_needle(
            vid, needle_cls(id=i + 1, cookie=7, data=data,
                            append_at_ns=10 ** 18 + i))
    v = store.find_volume(vid)
    v.sync()
    return v


def _pair(tmp_path, n_needles, needle_bytes, ec=False):
    """A port Store (card coder, plain version) holding a volume, and a
    JAX Store (host coder) over a copy of the same files."""
    store = Store([str(tmp_path / "t")], device="cpu")
    v = _fill(store, 1, n_needles, needle_bytes, Needle)
    base = v.file_name()
    if ec:
        store.generate_ec_shards(1)
        store.delete_volume(1)
    store.close()
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    store = Store([str(tmp_path / "t")], device="cpu")
    jstore = JStore([str(tmp_path / "j")], coder=jmake("cpu"))
    for s in (store, jstore):
        if ec:
            s.mount_ec_shards("", 1, list(range(TOTAL)))
        else:
            s.load_existing_volumes()
    return store, jstore, base, str(tmp_path / "j" / os.path.basename(base))


def _strip(out):
    """A scrub result without its timings."""
    return {"bytes": out["bytes"], "corruptions": out["corruptions"],
            "volumes": [{k: v for k, v in r.items() if k != "seconds"}
                        for r in out["volumes"]]}


@pytest.fixture
def k1_calls(monkeypatch):
    calls = []
    real = rs_cuda.gf_apply

    def counted(mat, data, out=None):
        calls.append(tuple(data.shape))
        return real(mat, data, out)

    monkeypatch.setattr(rs_cuda, "gf_apply", counted)
    return calls


def test_scrub_pass_is_rate_limited_as_jax(tmp_path):
    store, jstore, _, _ = _pair(tmp_path, 4, 32 * KB)
    outs = []
    for s, cls in ((store, Scrubber), (jstore, JScrubber)):
        clk = _Clock()
        mod = clockctl if cls is Scrubber else jclock
        with mod.install(clk.now, sleep_fn=clk.sleep):
            scrub = cls(s, rate_bytes_per_sec=512 * KB)
            scrub.bucket.consume = _virtual_consume(scrub.bucket)
            out = scrub.run_once()
        outs.append((_strip(out), round(clk.t, 6)))
        s.close()
    assert outs[0] == outs[1]
    (out, waited), _ = outs
    assert out["bytes"] >= 4 * 32 * KB and not out["corruptions"]
    assert waited >= out["bytes"] / (512 * KB) - 1e-6


def _virtual_consume(bucket):
    """consume() without the stop event, so its waits go through the
    installed clock's sleep instead of Event.wait."""
    real = type(bucket).consume

    def consume(n, stop=None):
        return real(bucket, n, None)

    return consume


def test_scrub_detects_needle_crc_as_jax(tmp_path):
    store, jstore, base, jbase = _pair(tmp_path, 5, 8 * KB)
    store.close()
    jstore.close()
    damage = corrupt.corrupt_needle(base + ".dat", index=2, seed=5)
    jdamage = corrupt.corrupt_needle(jbase + ".dat", index=2, seed=5)
    assert {**jdamage, "path": damage["path"]} == damage
    store = Store([os.path.dirname(base)], device="cpu")
    jstore = JStore([os.path.dirname(jbase)], coder=jmake("cpu"))
    store.load_existing_volumes()
    jstore.load_existing_volumes()
    scrub, jscrub = (Scrubber(store, rate_bytes_per_sec=0),
                     JScrubber(jstore, rate_bytes_per_sec=0))
    out, jout = scrub.run_once(), jscrub.run_once()
    assert _strip(out) == _strip(jout)
    assert [(c["type"], c.get("needle_id")) for c in out["corruptions"]] \
        == [("needle_crc", damage["needle_id"])]
    assert scrub.status()["corruptions_found"] == \
        jscrub.status()["corruptions_found"] == 1
    store.close()
    jstore.close()


def test_scrub_cursor_resumes_as_jax(tmp_path):
    """A pass stopped part-way leaves a cursor; a fresh scrubber resumes
    from it, scrubs the remainder and clears it, in both packages."""
    store, jstore, base, _ = _pair(tmp_path, 16, 64 * KB)
    results = []
    for s, cls in ((store, Scrubber), (jstore, JScrubber)):
        first = cls(s, rate_bytes_per_sec=0, cursor_flush_bytes=256 * KB)
        calls = {"n": 0}
        real = first._account

        def account(n, first=first, calls=calls, real=real):
            real(n)
            calls["n"] += 1
            if calls["n"] == 7:  # stop mid-volume, after a cursor flush
                first._stop.set()

        first._account = account
        out1 = first.run_once()
        d = s.locations[0].directory
        cursor = first._load_cursors(d)
        second = cls(s, rate_bytes_per_sec=0)
        out2 = second.run_once()
        rep = next(r for r in out2["volumes"] if r["volume_id"] == 1)
        results.append((_strip(out1), cursor, rep["start_offset"],
                        rep["complete"], second._load_cursors(d)))
        s.close()
    assert results[0] == results[1]
    _, cursor, start, complete, after = results[0]
    assert int(cursor["volumes"]["1"]) == start > 0
    assert complete and "1" not in after["volumes"]


@pytest.mark.parametrize("victim,seed", [(3, 9), (12, 4), (0, 1), (9, 2)])
def test_scrub_identifies_corrupt_ec_shard_as_jax(tmp_path, k1_calls,
                                                  victim, seed):
    store, jstore, base, jbase = _pair(tmp_path, 4, 256 * KB, ec=True)
    assert isinstance(store.coder, TorchCoder)
    del k1_calls[:]  # the encode's
    scrub = Scrubber(store, rate_bytes_per_sec=0, ec_chunk_bytes=256 * KB)
    jscrub = JScrubber(jstore, rate_bytes_per_sec=0,
                       ec_chunk_bytes=256 * KB)
    clean = scrub.run_once(volume_id=1)
    assert _strip(clean) == _strip(jscrub.run_once(volume_id=1))
    rep = next(r for r in clean["volumes"] if r.get("ec"))
    assert rep.get("complete") and not clean["corruptions"]
    groups = -(-store.find_ec_volume(1).shard_size() // (256 * KB))
    # a clean pass: one K1 call (encode_array) per row group
    assert len(k1_calls) == groups > 1
    for b in (base, jbase):
        corrupt.flip_bits(b + layout.shard_ext(victim), seed=seed)
    del k1_calls[:]
    out = scrub.run_once(volume_id=1)
    assert _strip(out) == _strip(jscrub.run_once(volume_id=1))
    evs = [c for c in out["corruptions"] if c["type"] == "ec_shard"]
    assert evs and all(c["shard_ids"] == [victim] for c in evs), out
    assert len(k1_calls) >= groups
    store.close()
    jstore.close()


def test_scrub_remote_assisted_ec_as_jax(tmp_path):
    """Data shards 5..9 held by another store: their parity contribution
    arrives pre-reduced (the partial-read chain); the port uses its own
    gf_partial_product, the JAX package its own."""
    store, jstore, base, jbase = _pair(tmp_path, 4, 256 * KB, ec=True)
    outs = []
    for s, b, partial, cls, sub in (
            (store, base, gf_partial_product, Scrubber, "tb"),
            (jstore, jbase, jpartial, JScrubber, "jb")):
        s.unmount_ec_shards(1, list(range(5, 10)))
        other = tmp_path / sub
        other.mkdir()
        for sid in range(5, 10):
            shutil.move(b + layout.shard_ext(sid),
                        str(other / f"1{layout.shard_ext(sid)}"))
        holder = (Store([str(other)], device="cpu") if cls is Scrubber
                  else JStore([str(other)], coder=jmake("cpu")))
        holder.mount_ec_shards("", 1, list(range(5, 10)))

        def remote(vid, coeff_by_sid, offset, size, n_rows,
                   holder=holder, partial=partial):
            ev = holder.find_ec_volume(vid)
            acc = np.zeros((n_rows, size), dtype=np.uint8)
            for sid, coeffs in coeff_by_sid.items():
                data = ev.shards[sid].read_at(offset, size)
                partial(np.asarray(coeffs, dtype=np.uint8)[:, None],
                        np.frombuffer(data, dtype=np.uint8)[None, :],
                        out=acc)
            return acc

        s.remote_partial_reader = remote
        scrub = cls(s, rate_bytes_per_sec=0)
        run = [_strip(scrub.run_once(volume_id=1))]
        corrupt.flip_bits(b + layout.shard_ext(12), seed=4)
        run.append(_strip(scrub.run_once(volume_id=1)))
        corrupt.flip_bits(b + layout.shard_ext(12), seed=4)  # undo
        s.remote_partial_reader = lambda *a: None
        run.append(_strip(scrub.run_once(volume_id=1)))
        outs.append(run)
        holder.close()
        s.close()
    assert outs[0] == outs[1]
    clean, dirty, skipped = outs[0]
    assert clean["volumes"][0].get("remote_assisted")
    assert not clean["corruptions"]
    assert 12 in dirty["corruptions"][0]["shard_ids"]
    assert "remote-assisted" in dirty["corruptions"][0]["detail"]
    assert skipped["volumes"][0]["skipped"] == "remote partial unavailable"


def _fill_named(store, vid, seed, needle_cls, n_files=12):
    rng = np.random.default_rng(seed)
    store.add_volume(vid)
    for i in range(n_files):
        data = rng.integers(0, 256, int(rng.integers(100, 4000)),
                            dtype=np.uint8).tobytes()
        n = needle_cls(id=i + 1, cookie=0xC0DE + i, data=data,
                       name=f"f{i}.bin".encode(), append_at_ns=10**18 + i)
        n.set_flags_from_fields()
        store.write_volume_needle(vid, n)


def test_mixed_code_store_scrubs_as_jax(tmp_path):
    """The scrub half of tests/test_lrc.py:229: an RS(10,4) and an
    LRC(10,2,2) volume on one store each verify against their own
    generator; a flipped local-parity byte is named in the LRC volume."""
    store = Store([str(tmp_path / "t")], device="cpu")
    _fill_named(store, 1, 1, Needle)
    _fill_named(store, 2, 2, Needle)
    bases = {1: store.generate_ec_shards(1),
             2: store.generate_ec_shards(2, code="lrc")}
    store.delete_volume(1)
    store.delete_volume(2)
    store.close()
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    store = Store([str(tmp_path / "t")], device="cpu")
    jstore = JStore([str(tmp_path / "j")], coder=jmake("cpu"))
    for s in (store, jstore):
        for vid in (1, 2):
            s.mount_ec_shards("", vid, list(range(TOTAL)))
    scrub = Scrubber(store, rate_bytes_per_sec=0)
    jscrub = JScrubber(jstore, rate_bytes_per_sec=0)
    out = scrub.run_once()
    assert _strip(out) == _strip(jscrub.run_once())
    assert out["corruptions"] == []
    codes = {r["volume_id"]: r.get("code") for r in out["volumes"]
             if r.get("ec")}
    assert codes == {1: "RSScheme", 2: "LrcScheme"}
    for b in (bases[2], str(tmp_path / "j" / os.path.basename(bases[2]))):
        corrupt.flip_bits(b + layout.shard_ext(10), seed=3)
    out = scrub.run_once()
    assert _strip(out) == _strip(jscrub.run_once())
    assert [c["volume_id"] for c in out["corruptions"]] == [2]
    store.close()
    jstore.close()
