"""The port's storage layer against seaweedfs_tpu's, byte for byte, after
tests/test_storage.py, tests/test_storage_variants.py (:27-214),
tests/test_ttl_expiry.py and the group commit of tests/test_write_path.py.

Each scripted case runs the same writes, deletes, compactions and reopens
on both packages' Volume (the wall clock that stamps deletion records is
pinned), compares every answer, and requires the .dat/.idx (and .sdx)
files to be byte-identical afterwards. Covered: the memory, ldb (LSM) and
sorted needle maps, 4- and 5-byte offsets, compaction with a tail delta,
blobs and descriptors, integrity checks, replication rewrite, TTL expiry
through the Store, the group commit under concurrent writers, the LSM
engine on its own, and disk locations.
"""

import os
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.models.coder import make_coder as jmake
from seaweedfs_tpu.storage import needle as jneedle
from seaweedfs_tpu.storage import volume as jvolume
from seaweedfs_tpu.storage.store import Store as JStore
from seaweedfs_tpu.utils import lsm as jlsm
from seaweedfs_tpu_torch.storage import needle as tneedle
from seaweedfs_tpu_torch.storage import volume as tvolume
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle_map import MemDb
from seaweedfs_tpu_torch.storage.needle_map_disk import (LdbNeedleMap,
                                                         SortedFileNeedleMap)
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.super_block import TTL, ReplicaPlacement
from seaweedfs_tpu_torch.utils import lsm as tlsm

PKGS = {"port": (tvolume, tneedle), "jax": (jvolume, jneedle)}
FIXED_NS = 1_700_000_000_123_456_789


@pytest.fixture
def pinned_clock(monkeypatch):
    """Deletion records carry time.time_ns(); pin it so both packages
    write the same bytes."""
    monkeypatch.setattr(time, "time_ns", lambda: FIXED_NS)


def _put(vmod, nmod, vol, key, data, cookie=7, name=b""):
    n = nmod.Needle(id=key, cookie=cookie, data=data, name=name,
                    append_at_ns=10**18 + key)
    n.set_flags_from_fields()
    return vol.write_needle(n)


def _files(base, exts=(".dat", ".idx")):
    return [open(base + e, "rb").read() if os.path.exists(base + e)
            else None for e in exts]


def _errname(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__


def _lifecycle(vmod, nmod, d, kind, offset_bytes):
    """Writes, an overwrite, deletes, a compaction with changes replayed
    as a tail delta, a reopen: returns every answer along the way."""
    out = []
    vol = vmod.Volume(d, "", 1, needle_map_kind=kind,
                      offset_bytes=offset_bytes)
    rng = np.random.default_rng(11)
    for k in (9, 3, 127, 45, 2, 88, 1000, 17):
        out.append(_put(vmod, nmod, vol, k, rng.bytes(int(rng.integers(
            1, 700))), name=f"n{k}".encode()))
    out.append(_put(vmod, nmod, vol, 45, b"second generation"))
    out += [vol.delete_needle(k) for k in (3, 88, 4242)]
    out.append(_errname(lambda: vol.delete_needle(9, cookie=1)))
    out.append(_errname(lambda: vol.read_needle(3).data))
    out += [vol.has_needle(k) for k in (9, 3, 4242)]
    blob, size = vol.read_needle_blob(127)
    out += [blob, size, vol.file_count(), vol.deleted_count(),
            vol.deleted_bytes(), round(vol.garbage_level(), 12),
            vol.content_size(), vol.check_integrity(), vol.live_entries()]
    meta, fd, off, dsize = vol.read_needle_descriptor(45)
    os.lseek(fd, off, os.SEEK_SET)
    out += [os.read(fd, dsize), meta.name, meta.checksum, dsize]
    os.close(fd)
    # a change that lands during compaction's copy is replayed as a delta
    real_append = vol._append_compact_record
    hooked = {"done": False}

    def racing_append(dat, idxf, key, size, blob_):
        real_append(dat, idxf, key, size, blob_)
        if not hooked["done"]:
            hooked["done"] = True
            _put(vmod, nmod, vol, 555, b"landed mid-compaction")
            vol.delete_needle(1000)

    vol._append_compact_record = racing_append
    vol.compact()
    vol._append_compact_record = real_append
    out += [vol.super_block.compaction_revision, vol.file_count(),
            vol.read_needle(555).data,
            _errname(lambda: vol.read_needle(1000).data)]
    vol.write_needle_blob(blob, size)  # a replica-repair copy of 127
    vol.configure_replication("010")
    vol.close()
    vol2 = vmod.Volume(d, "", 1, needle_map_kind=kind)
    out += [vol2.offset_bytes, vol2.super_block.replica_placement.to_byte(),
            sorted(k for k, _ in vol2.live_entries()),
            [vol2.read_needle(k).data for k in (9, 45, 127, 555)]]
    vol2.close()
    return out


@pytest.mark.parametrize("kind", ["memory", "ldb"])
@pytest.mark.parametrize("offset_bytes", [4, 5])
def test_volume_lifecycle_matches_jax(tmp_path, pinned_clock, kind,
                                      offset_bytes):
    got = {}
    for name, (vmod, nmod) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = (_lifecycle(vmod, nmod, str(d), kind, offset_bytes),
                     _files(str(d / "1")))
    assert got["port"] == got["jax"]


def test_sorted_map_serves_a_sealed_volume_as_jax(tmp_path, pinned_clock):
    got = {}
    for name, (vmod, nmod) in PKGS.items():
        d = str(tmp_path / name)
        os.mkdir(d)
        vol = vmod.Volume(d, "", 4)
        for k in (9, 3, 127, 45, 2, 88):
            _put(vmod, nmod, vol, k, f"n{k}".encode())
        vol.delete_needle(45)
        vol.close()
        svol = vmod.Volume(d, "", 4, needle_map_kind="sorted")
        out = [svol.read_only,
               [svol.read_needle(k).data for k in (2, 3, 9, 88, 127)],
               svol.nm.get(45), svol.nm.get(999),
               _errname(lambda: _put(vmod, nmod, svol, 1000, b"no")),
               svol.nm.delete(88), svol.nm.get(88)]
        svol.close()
        # reopen keeps the in-place tombstone (no rebuild from .idx)
        svol = vmod.Volume(d, "", 4, needle_map_kind="sorted")
        out.append(svol.nm.get(88))
        svol.close()
        got[name] = (out, _files(os.path.join(d, "4"),
                                 (".dat", ".idx", ".sdx")))
    assert got["port"] == got["jax"]
    assert got["port"][0][4] == "PermissionError"


def test_ldb_crash_recovery_replays_the_idx_tail(tmp_path):
    d = str(tmp_path)
    vol = tvolume.Volume(d, "", 3, needle_map_kind="ldb")
    _put(tvolume, tneedle, vol, 1, b"first")
    vol.nm.mark_watermark(vol.file_name() + ".idx")
    _put(tvolume, tneedle, vol, 2, b"second")
    _put(tvolume, tneedle, vol, 3, b"third")
    vol._dat.flush()
    vol._idx.flush()  # a crash: no close
    vol2 = tvolume.Volume(d, "", 3, needle_map_kind="ldb")
    assert [vol2.read_needle(k).data for k in (1, 2, 3)] == \
        [b"first", b"second", b"third"]
    vol2.close()
    # the JAX package's memory map reads the same volume
    jv = jvolume.Volume(d, "", 3)
    assert jv.read_needle(3).data == b"third"
    jv.close()


def test_wide_offsets_past_32gb_and_superblock_width(tmp_path):
    d = str(tmp_path)
    vol = tvolume.Volume(d, "", 5, offset_bytes=5)
    _put(tvolume, tneedle, vol, 1, b"early")
    vol._dat.seek(33 * (1 << 30) - 8)  # sparse-extend past 4-byte reach
    vol._dat.write(b"\0" * 8)
    _put(tvolume, tneedle, vol, 2, b"beyond 32GB")
    vol.close()
    for vmod in (tvolume, jvolume):
        v2 = vmod.Volume(d, "", 5)  # the superblock marker wins
        assert v2.offset_bytes == 5
        assert v2.read_needle(2).data == b"beyond 32GB"
        v2.close()
    narrow = tvolume.Volume(d, "", 6)
    narrow._dat.seek(33 * (1 << 30) - 8)
    narrow._dat.write(b"\0" * 8)
    with pytest.raises(IOError):
        _put(tvolume, tneedle, narrow, 1, b"too far")
    narrow.close()
    liar = tvolume.Volume(d, "", 6, offset_bytes=5)
    assert liar.offset_bytes == 4
    liar.close()


def test_tiering_is_not_ported_and_says_so(tmp_path):
    """The cloud tier, once NotImplementedError here, is ported: both
    packages tier the same volume to an in-test S3 endpoint, write the
    same .vif, read every needle through it, open each other's .vif-only
    volume (and a DiskLocation scan finds it), and untier to the same
    .dat. A volume is refused a second tier_to in both, and an untier of
    a local one."""
    import http.server
    import json as _json
    objects = {}

    class S3(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_PUT(self):
            n = int(self.headers.get("Content-Length", 0))
            objects[self.path] = self.rfile.read(n)
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def _body(self, head):
            data = objects.get(self.path)
            if data is None:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            rng = self.headers.get("Range")
            if rng:
                lo, hi = (int(x) for x in rng[6:].split("-"))
                data = data[lo:hi + 1]
                self.send_response(206)
            else:
                self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            if not head:
                self.wfile.write(data)

        def do_GET(self):
            self._body(False)

        def do_HEAD(self):
            self._body(True)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), S3)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    endpoint = f"http://127.0.0.1:{srv.server_address[1]}"
    rng = np.random.default_rng(8)
    payloads = {k: rng.bytes(int(rng.integers(1, 5000)))
                for k in range(1, 21)}
    out = {}
    try:
        for name, mod, nmod in (("p", tvolume, tneedle),
                                ("j", jvolume, jneedle)):
            d = tmp_path / name
            d.mkdir()
            vol = mod.Volume(str(d), "", 8)
            assert vol.is_tiered is False
            with pytest.raises(ValueError):
                vol.untier()
            for k, data in payloads.items():
                vol.write_needle(nmod.Needle(
                    id=k, cookie=k, data=data,
                    append_at_ns=1_700_000_000_000_000_000 + k))
            dat = (d / "8.dat").read_bytes()
            info = vol.tier_to(endpoint, "tier", key=f"{name}_8.dat")
            assert vol.is_tiered and not (d / "8.dat").exists()
            with pytest.raises(ValueError):
                vol.tier_to(endpoint, "tier", key=f"{name}_8.dat")
            reads = [vol.read_needle(k).data for k in payloads]
            vol.close()
            out[name] = (info["remote"]["size"], info["remote"]["crc32c"],
                         dat, reads)
        assert out["p"][:3] == out["j"][:3]
        assert out["p"][3] == out["j"][3] == list(payloads.values())
        for name, reader in (("j", tvolume), ("p", jvolume)):
            d = tmp_path / name
            vif = _json.loads((d / "8.vif").read_text())
            assert vif["remote"]["key"] == f"{name}_8.dat"
            vol = reader.Volume(str(d), "", 8)
            assert vol.is_tiered and vol.read_only
            assert [vol.read_needle(k).data for k in payloads] == \
                list(payloads.values())
            vol.close()
        loc = DiskLocation(str(tmp_path / "j"))
        loc.load_existing_volumes()
        assert loc.volumes[8].is_tiered
        loc.volumes[8].untier()
        assert (tmp_path / "j" / "8.dat").read_bytes() == out["j"][2]
        loc.volumes[8].close()
    finally:
        srv.shutdown()


# ----------------------------------------------------------- group commit

def test_group_commit_durable_and_coalesced(tmp_path):
    """K threads x M rounds: in each round every thread appends, then all
    of them commit at once (a barrier between the append and the commit),
    so one leader's flush covers the K appends and the other K-1 ride it.
    Every needle survives a reopen by the JAX package."""
    vol = tvolume.Volume(str(tmp_path), "", 1, fsync=True)
    K, M = 8, 5
    gate = threading.Barrier(K)
    real_commit = vol._group_commit

    def commit_after_every_append(seq):
        gate.wait(30.0)
        real_commit(seq)

    vol._group_commit = commit_after_every_append
    errs = []

    def writer(tid):
        try:
            for i in range(M):
                vol.write_needle(tneedle.Needle(id=tid * 1000 + i + 1,
                                                cookie=9, data=b"gc" * 64))
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(K)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not errs, errs
    assert vol.file_count() == K * M
    assert vol.flush_count == M
    assert vol.commit_waits == (K - 1) * M
    vol.close()
    jv = jvolume.Volume(str(tmp_path), "", 1)
    assert jv.file_count() == K * M
    assert all(jv.read_needle(tid * 1000 + i + 1).data == b"gc" * 64
               for tid in range(K) for i in range(M))
    jv.close()


# --------------------------------------------------------------- TTL

def _hours_ago(h: float) -> int:
    return int((time.time() - h * 3600) * 1e9)


@pytest.mark.parametrize("ttl,age_h,expired,reaped", [
    ("1m", 2.0, True, True),     # long past a 1-minute TTL
    ("1h", 1.05, True, False),   # expired, inside the 6 min grace
    ("1h", 1.2, True, True),     # past the grace
    ("", 1000.0, False, False),  # no TTL: never
])
def test_ttl_expiry_matches_jax(tmp_path, ttl, age_h, expired, reaped):
    got = {}
    for name, store in (
            ("port", Store([str(tmp_path / "t")], device="cpu")),
            ("jax", JStore([str(tmp_path / "j")], coder=jmake("cpu")))):
        nmod = tneedle if name == "port" else jneedle
        v = store.add_volume(1, ttl=ttl)
        store.write_volume_needle(1, nmod.Needle(id=7, cookie=0xAB,
                                                 data=b"brief"))
        fresh = v.is_expired()
        v.last_append_at_ns = _hours_ago(age_h)
        out = [fresh, v.is_expired(), v.is_expired_long_enough(),
               _errname(lambda: store.read_volume_needle(1, 7, 0xAB).data)]
        store.drain_deltas()
        v.is_compacting = True  # a vacuum in progress stops the reaper
        out.append(store.delete_expired_ttl_volumes())
        v.is_compacting = False
        out.append(store.delete_expired_ttl_volumes())
        out.append([x["id"] for x in store.drain_deltas()["deleted_volumes"]])
        got[name] = out
        store.close()
    assert got["port"] == got["jax"]
    assert got["port"][1] is expired
    assert got["port"][5] == ([1] if reaped else [])


def test_a_fresh_write_resets_the_ttl_clock(tmp_path):
    store = Store([str(tmp_path)], device="cpu")
    v = store.add_volume(2, ttl="1h")
    store.write_volume_needle(2, tneedle.Needle(id=1, cookie=1, data=b"x"))
    v.last_append_at_ns = _hours_ago(1.05)
    assert v.is_expired()
    store.write_volume_needle(2, tneedle.Needle(id=2, cookie=1, data=b"y"))
    assert not v.is_expired()
    assert store.read_volume_needle(2, 2, 1).data == b"y"
    store.close()


# ------------------------------------------------- the small extras

def test_small_extras_match_jax():
    from seaweedfs_tpu.storage.super_block import TTL as JTTL
    from seaweedfs_tpu.storage.super_block import \
        ReplicaPlacement as JReplicaPlacement
    for s in ("", "3m", "4h", "5d", "6w", "7M", "8y"):
        assert (TTL.parse(s).to_uint32(), TTL.parse(s).minutes) == \
            (JTTL.parse(s).to_uint32(), JTTL.parse(s).minutes)
    for s in ("000", "001", "010", "100", "210"):
        assert ReplicaPlacement.parse(s).copy_count == \
            JReplicaPlacement.parse(s).copy_count
    for version in (1, 2, 3):
        n = tneedle.Needle(id=5, cookie=6, data=b"z" * 77, name=b"n")
        n.set_flags_from_fields()
        jn = jneedle.Needle(id=5, cookie=6, data=b"z" * 77, name=b"n")
        jn.set_flags_from_fields()
        assert n.disk_size(version) == jn.disk_size(version)
        blob = n.to_bytes(version)
        assert tneedle.payload_crc_stored(blob, n.size) == \
            jneedle.payload_crc_stored(blob, n.size)
    n = tneedle.Needle(id=1)
    n.stamp()
    assert n.append_at_ns > 0


def test_memdb_items_and_save_to_idx_match_jax(tmp_path):
    from seaweedfs_tpu.storage.needle_map import MemDb as JMemDb
    dbs = (MemDb(), JMemDb())
    for db in dbs:
        for key, off, size in ((50, 8, 100), (3, 16, 10), (99, 24, 7)):
            db.set(key, off, size)
        db.delete(99)
    assert list(dbs[0].items_ascending()) == list(dbs[1].items_ascending())
    dbs[0].save_to_idx(str(tmp_path / "t.idx"), offset_bytes=5)
    dbs[1].save_to_idx(str(tmp_path / "j.idx"), offset_bytes=5)
    assert open(tmp_path / "t.idx", "rb").read() == \
        open(tmp_path / "j.idx", "rb").read()


# ---------------------------------------------------- the LSM engine

def _lsm_script(mod, d):
    kv = mod.LsmKv(d, fsync=False, flush_keys=16, compact_at=3)
    rng = np.random.default_rng(3)
    keys = [rng.bytes(int(rng.integers(1, 12))) for _ in range(120)]
    for i, k in enumerate(keys):
        kv.put(k, None if i % 7 == 0 else bytes([i % 256]) * (i % 9))
    out = [kv.get(k) for k in keys[::5]]
    out.append(list(kv.scan(keys[3], keys[50])))
    out.append(len(kv))
    kv.close()
    kv = mod.LsmKv(d, fsync=False, flush_keys=16, compact_at=3)
    out.append(list(kv.scan()))
    kv.close()
    files = {name: open(os.path.join(d, name), "rb").read()
             for name in sorted(os.listdir(d))}
    return out, files


def test_lsm_engine_matches_jax(tmp_path):
    assert _lsm_script(tlsm, str(tmp_path / "t")) == \
        _lsm_script(jlsm, str(tmp_path / "j"))


def test_disk_maps_answer_as_the_memory_map(tmp_path):
    from seaweedfs_tpu.storage.needle_map_disk import LdbNeedleMap as JLdb
    entries = [(k, 8 * k, 10 + k) for k in (5, 3, 9, 1, 7)]
    idx = str(tmp_path / "x.idx")
    db = MemDb()
    for e in entries:
        db.set(*e)
    db.save_to_idx(idx)
    t = LdbNeedleMap(str(tmp_path / "t.ldb"), idx_path=idx)
    j = JLdb(str(tmp_path / "j.ldb"), idx_path=idx)
    s = SortedFileNeedleMap.build_from_idx(idx, str(tmp_path / "x.sdx"))
    for m in (t, j, s):
        m.delete(9)
    seen = {}
    for name, m in (("t", t), ("j", j), ("s", s)):
        got = []
        m.ascending_visit(lambda k, o, z: got.append((k, o, z)))
        seen[name] = (got, [m.get(k) for k in (1, 3, 5, 7, 9, 11)], len(m))
        m.close()
    assert seen["t"] == seen["j"]
    assert seen["t"][1] == seen["s"][1]


# ------------------------------------------------------- disk locations

def test_disk_location_loads_volumes_and_ec_shards(tmp_path):
    d = tmp_path / "loc"
    d.mkdir()
    for col, vid in (("", 1), ("pics", 2)):
        v = tvolume.Volume(str(d), col, vid)
        _put(tvolume, tneedle, v, 1, b"x" * 10)
        v.close()
    open(d / "3.dat", "wb").write(b"")  # no .idx: skipped
    loc = DiskLocation(str(d), max_volume_count=4, disk_type="ssd")
    loc.load_existing_volumes()
    assert sorted(loc.volumes) == [1, 2]
    assert loc.volumes[2].collection == "pics"
    assert loc.volumes_len() == 2 and loc.disk_type == "ssd"
    assert loc.delete_volume(1) and not os.path.exists(d / "1.dat")
    assert not loc.delete_volume(1)
    loc.close()
