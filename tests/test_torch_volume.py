"""The port's needle / superblock / index / volume bytes against
seaweedfs_tpu's, both ways: each package writes, the other reads."""

import numpy as np
import pytest

from seaweedfs_tpu.storage import idx as jidx
from seaweedfs_tpu.storage import needle as jneedle
from seaweedfs_tpu.storage import needle_map as jnm
from seaweedfs_tpu.storage import super_block as jsb
from seaweedfs_tpu.storage import types as jt
from seaweedfs_tpu.storage import volume as jvol
from seaweedfs_tpu.utils import crc as jcrc
from seaweedfs_tpu_torch.storage import idx as tidx
from seaweedfs_tpu_torch.storage import needle as tneedle
from seaweedfs_tpu_torch.storage import needle_map as tnm
from seaweedfs_tpu_torch.storage import super_block as tsb
from seaweedfs_tpu_torch.storage import types as tt
from seaweedfs_tpu_torch.storage import volume as tvol
from seaweedfs_tpu_torch.utils import crc as tcrc

_FIELDS = ("id", "cookie", "data", "name", "mime", "pairs", "flags",
           "last_modified", "ttl", "append_at_ns", "checksum", "size")


def _needle_kwargs(rng, i):
    kw = dict(id=int(rng.integers(1, 1 << 62)),
              cookie=int(rng.integers(0, 1 << 32)),
              data=rng.bytes(int(rng.integers(0, 3000))),
              append_at_ns=1_700_000_000_000_000_000 + i)
    if i % 2:
        kw.update(name=b"file%d.bin" % i, mime=b"application/octet-stream")
    if i % 3 == 0:
        kw.update(pairs=b'{"k":"v"}', last_modified=1_700_000_000 + i,
                  ttl=b"\x05\x03")
    return kw


def _pair(kw):
    tn, jn = tneedle.Needle(**kw), jneedle.Needle(**kw)
    tn.set_flags_from_fields()
    jn.set_flags_from_fields()
    return tn, jn


@pytest.mark.parametrize("version", [1, 2, 3])
def test_needle_bytes_identical_both_ways(version):
    rng = np.random.default_rng(version)
    for i in range(40):
        tn, jn = _pair(_needle_kwargs(rng, i))
        blob = tn.to_bytes(version)
        assert blob == jn.to_bytes(version)
        size = tn.size
        back_t = tneedle.Needle.from_bytes(blob, size, version)
        back_j = jneedle.Needle.from_bytes(blob, size, version)
        for f in _FIELDS:
            assert getattr(back_t, f) == getattr(back_j, f), f
        assert tt.get_actual_size(size, version) == len(blob) \
            == jt.get_actual_size(size, version)


def test_needle_crc_checked_on_read():
    tn, _ = _pair(_needle_kwargs(np.random.default_rng(4), 1))
    blob = bytearray(tn.to_bytes(3))
    blob[tt.NEEDLE_HEADER_SIZE + 6] ^= 0xFF
    with pytest.raises(tneedle.CrcError):
        tneedle.Needle.from_bytes(bytes(blob), tn.size, 3)
    assert tneedle.verify_record_crc(tn.to_bytes(3), tn.size) \
        == jneedle.verify_record_crc(tn.to_bytes(3), tn.size)


def test_superblock_bytes_identical_both_ways():
    cases = [dict(), dict(version=2), dict(compaction_revision=513),
             dict(extra=b"5BO")]
    for kw in cases:
        tkw, jkw = dict(kw), dict(kw)
        tkw["replica_placement"] = tsb.ReplicaPlacement.parse("012")
        jkw["replica_placement"] = jsb.ReplicaPlacement.parse("012")
        tkw["ttl"], jkw["ttl"] = tsb.TTL.parse("3d"), jsb.TTL.parse("3d")
        tb = tsb.SuperBlock(**tkw).to_bytes()
        assert tb == jsb.SuperBlock(**jkw).to_bytes()
        a, b = tsb.SuperBlock.parse(tb), jsb.SuperBlock.parse(tb)
        assert (a.version, str(a.replica_placement), str(a.ttl),
                a.compaction_revision, a.extra, a.block_size) == \
            (b.version, str(b.replica_placement), str(b.ttl),
             b.compaction_revision, b.extra, b.block_size)


@pytest.mark.parametrize("width", [4, 5])
def test_index_entries_identical_both_ways(width):
    rng = np.random.default_rng(width)
    entries = [(int(rng.integers(0, 1 << 63)), int(rng.integers(0, 1 << 32)),
                int(rng.integers(-1, 1 << 20))) for _ in range(300)]
    tblob = b"".join(tt.pack_entry(*e, offset_bytes=width) for e in entries)
    jblob = b"".join(jt.pack_entry(*e, offset_bytes=width) for e in entries)
    assert tblob == jblob
    assert list(tidx.iter_index(tblob, width)) == \
        list(jidx.iter_index(tblob, width)) == entries


def test_crc32c_matches_jax_package():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 8, 9, 4096, 100_003):
        b = rng.bytes(n)
        assert tcrc.crc32c(b) == jcrc.crc32c(b)
        assert tcrc.crc32c(b, 12345) == jcrc.crc32c(b, 12345)
        assert tcrc._crc32c_py(b[:2000], 7) == jcrc.crc32c(b[:2000], 7)
    b = rng.bytes(5000)
    assert tcrc.crc32c(memoryview(b)[2000:], tcrc.crc32c(b[:2000])) \
        == tcrc.crc32c(b)
    assert tcrc.crc32c(np.frombuffer(b, np.uint8)) == jcrc.crc32c(b)


def test_memdb_and_compact_map_match():
    rng = np.random.default_rng(6)
    ops = [(int(rng.integers(1, 200)), int(rng.integers(0, 1 << 20)),
            int(rng.integers(1, 1000)), bool(rng.integers(0, 5) == 0))
           for _ in range(6000)]
    seen = {}
    for mk in ((tnm.MemDb, jnm.MemDb), (tnm.CompactMap, jnm.CompactMap)):
        a, b = mk[0](), mk[1]()
        for key, off, size, dele in ops:
            for mp in (a, b):
                mp.delete(key) if dele else mp.set(key, off, size)
        got = []
        want = []
        a.ascending_visit(lambda *e: got.append(e))
        b.ascending_visit(lambda *e: want.append(e))
        assert got == want
        seen[mk[0].__name__] = [a.get(k) for k in range(200)] == \
            [b.get(k) for k in range(200)]
    assert all(seen.values())


@pytest.mark.parametrize("width", [4, 5])
def test_volume_files_identical_both_ways(tmp_path, width):
    rng = np.random.default_rng(7 + width)
    kws = [_needle_kwargs(rng, i) for i in range(30)]
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tdir.mkdir()
    jdir.mkdir()
    tv = tvol.Volume(str(tdir), "", 3, offset_bytes=width)
    jv = jvol.Volume(str(jdir), "", 3, offset_bytes=width)
    for kw in kws:
        tn, jn = _pair(kw)
        assert tv.write_needle(tn) == jv.write_needle(jn)
    tv.sync()
    tv.close()
    jv.close()
    for ext in (".dat", ".idx"):
        assert (tdir / f"3{ext}").read_bytes() == (jdir / f"3{ext}").read_bytes()
    # each package loads the other's volume and reads every needle back
    t_on_j = tvol.Volume(str(jdir), "", 3)
    j_on_t = jvol.Volume(str(tdir), "", 3)
    assert t_on_j.offset_bytes == width
    for kw in kws:
        assert t_on_j.read_needle(kw["id"], kw["cookie"]).data == kw["data"]
        assert j_on_t.read_needle(kw["id"]).data == kw["data"]
    with pytest.raises(tvol.CookieMismatchError):
        t_on_j.read_needle(kws[0]["id"], kws[0]["cookie"] ^ 1)
    with pytest.raises(tvol.NotFoundError):
        t_on_j.read_needle(0)
    assert t_on_j.file_count() == len({kw["id"] for kw in kws})
    t_on_j.close()
    j_on_t.close()
