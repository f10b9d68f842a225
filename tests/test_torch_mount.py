"""The port's mount/ (fuse_kernel.py, meta_cache.py, page_writer.py,
weedfs.py, mount_grpc.py) held against the JAX package's: WeedFS's
operations directly (and through a real kernel mount where mount(2) is
allowed), the dirty-page IntervalSet, the swap file, the UploadPipeline
against a fake uploader, WeedFS over a filer of its own and over the
cluster's filer through the remote store (writes visible over HTTP, HTTP
writes visible through the change-log subscription, a second mount), the
meta cache, sequential reads prefetching into the filer's reader cache,
the gRPC admin plane with the REPL's mount.configure; across the
packages: one script of WeedFS operations through each package with equal
answers and bytes, and equal IntervalSet spans and UploadPipeline chunk
lists on seeded writes. WeedFS.close() (the port's addition) is pinned
here too. The port's volume servers run with device="cpu".
(ref tests/test_mount.py, test_page_writer.py, test_mount_remote_filer.py,
test_proto_planes.py's mount admin plane, test_reader_cache.py's mount
case.)
"""

import errno
import hashlib
import json
import os
import random
import stat
import threading
import time
import types

import numpy as np
import pytest

import seaweedfs_tpu.mount.page_writer as j_page_writer
import seaweedfs_tpu.mount.weedfs as j_weedfs
from seaweedfs_tpu.filer.entry import FileChunk as JFileChunk
from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu.server.master import MasterServer as JMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
import seaweedfs_tpu_torch.mount.page_writer as p_page_writer
import seaweedfs_tpu_torch.mount.weedfs as p_weedfs
from seaweedfs_tpu_torch.filer.entry import FileChunk
from seaweedfs_tpu_torch.mount.fuse_kernel import ROOT_ID, FuseError
from seaweedfs_tpu_torch.mount.meta_cache import MetaCache, is_negative
from seaweedfs_tpu_torch.mount.page_writer import (IntervalSet, SwapFile,
                                                   UploadPipeline)
from seaweedfs_tpu_torch.mount.weedfs import WeedFS
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils.httpd import http_call


def _port_vs(dirs, master_url, **kw):
    return VolumeServer(dirs, master_url, device="cpu", **kw)


PORT = types.SimpleNamespace(Master=MasterServer, VS=_port_vs,
                             Filer=FilerServer, weedfs=p_weedfs,
                             pw=p_page_writer, FileChunk=FileChunk)
JAX = types.SimpleNamespace(Master=JMaster, VS=JVolumeServer,
                            Filer=JFilerServer, weedfs=j_weedfs,
                            pw=j_page_writer, FileChunk=JFileChunk)


def _stack(pkg, root, **master_kw):
    master = pkg.Master(**master_kw)
    master.start()
    vs = pkg.VS([str(root / "v")], master.url)
    vs.start()
    fs = pkg.Filer(master.url)
    fs.start()
    time.sleep(0.1)
    return master, vs, fs


@pytest.fixture
def stack(tmp_path):
    master, vs, fs = _stack(PORT, tmp_path)
    yield master, vs, fs
    fs.stop()
    vs.stop()
    master.stop()


# ---------------- WeedFS operations ----------------


def test_weedfs_operations(stack):
    master, vs, fs = stack
    w = WeedFS(fs)
    attr, fh = w.create(ROOT_ID, "hello.txt", 0o644)
    assert w.write(attr.ino, fh, 0, b"hello ") == 6
    assert w.write(attr.ino, fh, 6, b"world") == 5
    w.release(attr.ino, fh)
    got = w.lookup(ROOT_ID, "hello.txt")
    assert got is not None and got.size == 11
    fh2 = w.open(got.ino)
    assert w.read(got.ino, fh2, 0, 100) == b"hello world"
    w.release(got.ino, fh2)
    dattr = w.mkdir(ROOT_ID, "sub", 0o755)
    assert stat.S_ISDIR(dattr.mode)
    assert w.rename(ROOT_ID, "hello.txt", dattr.ino, "moved.txt") == 0
    assert w.lookup(ROOT_ID, "hello.txt") is None
    assert w.lookup(dattr.ino, "moved.txt").size == 11
    names = [n for n, _ in w.readdir(ROOT_ID)]
    assert "sub" in names and "." in names
    m = w.lookup(dattr.ino, "moved.txt")
    fh3 = w.open(m.ino)
    w.setattr(m.ino, 1 << 3, size=5, mode=0, mtime=0, fh=fh3)
    w.release(m.ino, fh3)
    assert w.lookup(dattr.ino, "moved.txt").size == 5
    s = w.symlink(ROOT_ID, "lnk", "sub/moved.txt")
    assert s is not None and stat.S_ISLNK(s.mode)
    assert w.readlink(s.ino) == "sub/moved.txt"
    assert w.symlink(ROOT_ID, "lnk", "x") is None  # EEXIST
    m2 = w.lookup(dattr.ino, "moved.txt")
    h = w.link(m2.ino, ROOT_ID, "hard.txt")
    assert h is not None
    with pytest.raises(FileExistsError):
        w.link(m2.ino, ROOT_ID, "hard.txt")
    fh4 = w.open(h.ino)
    assert w.read(h.ino, fh4, 0, 100) == b"hello"
    w.release(h.ino, fh4)
    assert w.unlink(ROOT_ID, "hard.txt") == 0
    assert w.unlink(ROOT_ID, "lnk") == 0
    st = w.statfs()
    assert st is not None and st[0] > 0
    assert w.unlink(dattr.ino, "moved.txt") == 0
    assert w.rmdir(ROOT_ID, "sub") == 0
    assert w.unlink(ROOT_ID, "nope") == errno.ENOENT


def test_real_kernel_mount(stack, tmp_path):
    """Mount through /dev/fuse and use plain file-system calls; skipped
    where mount(2) is refused, as the reference's is."""
    master, vs, fs = stack
    from seaweedfs_tpu_torch.mount.fuse_kernel import FuseConnection
    mnt = tmp_path / "mnt"
    mnt.mkdir()
    w = WeedFS(fs)
    try:
        conn = FuseConnection(w, str(mnt))
    except (FuseError, PermissionError, OSError) as e:
        pytest.skip(f"cannot mount fuse here: {e}")
    conn.serve_forever(background=True)
    try:
        p = mnt / "kernel.txt"
        p.write_bytes(b"written through the kernel")
        assert p.read_bytes() == b"written through the kernel"
        (mnt / "d").mkdir()
        (mnt / "d" / "nested.bin").write_bytes(b"x" * 5000)
        assert sorted(os.listdir(mnt)) == ["d", "kernel.txt"]
        os.rename(mnt / "kernel.txt", mnt / "d" / "renamed.txt")
        status, body, _ = http_call("GET", f"http://{fs.url}/d/renamed.txt")
        assert status == 200 and body == b"written through the kernel"
        os.symlink("d/renamed.txt", mnt / "alias")
        assert os.readlink(mnt / "alias") == "d/renamed.txt"
        os.link(mnt / "d" / "nested.bin", mnt / "hard.bin")
        os.remove(mnt / "d" / "nested.bin")
        assert (mnt / "hard.bin").read_bytes() == b"x" * 5000
        target = str(mnt / "d" / "renamed.txt")
        os.setxattr(target, "user.color", b"blue")
        assert os.getxattr(target, "user.color") == b"blue"
        assert fs.filer.find_entry("/d/renamed.txt").extended == {
            "user.color": b"blue"}
        for name in ("alias", "hard.bin", "d/renamed.txt"):
            os.remove(mnt / name)
        os.rmdir(mnt / "d")
        assert os.listdir(mnt) == []
    finally:
        conn.close()


# ---------------- IntervalSet, SwapFile ----------------


def test_interval_set_coalesce():
    s = IntervalSet()
    s.add(10, 20)
    s.add(30, 40)
    assert s.spans == [(10, 20), (30, 40)]
    s.add(20, 30)
    assert s.spans == [(10, 40)]
    s.add(0, 5)
    s.add(50, 60)
    s.add(4, 51)
    assert s.spans == [(0, 60)] and s.covered() == 60
    s.truncate(25)
    assert s.spans == [(0, 25)]
    assert s.overlaps(20, 30) == [(20, 25)]


def test_interval_set_out_of_order():
    s = IntervalSet()
    spans = [(i * 10, i * 10 + 10) for i in range(20)]
    random.Random(7).shuffle(spans)
    for a, b in spans:
        s.add(a, b)
    assert s.spans == [(0, 200)]


def test_swap_file_slots(tmp_path):
    sw = SwapFile(str(tmp_path / "swap"), chunk_size=64)
    a, b = sw.alloc(), sw.alloc()
    assert (a, b) == (0, 1)
    sw.pwrite(a, 0, b"A" * 64)
    sw.pwrite(b, 10, b"B" * 10)
    assert sw.pread(a, 0, 64) == b"A" * 64
    assert sw.pread(b, 10, 10) == b"B" * 10
    assert sw.pread(b, 0, 10) == b"\x00" * 10
    sw.free(a)
    assert sw.alloc() == a
    sw.close()


# ---------------- UploadPipeline against a fake uploader ----------------


class FakeUploader:
    """Captures uploads (fids in upload order); replays them."""

    def __init__(self, chunk_cls=FileChunk, fail_after=None, delay=0.0):
        self.blobs: dict[str, bytes] = {}
        self.lock = threading.Lock()
        self.n = 0
        self.chunk_cls = chunk_cls
        self.fail_after = fail_after
        self.delay = delay
        self.concurrent = 0
        self.max_concurrent = 0

    def __call__(self, data, offset, mtime_ns):
        with self.lock:
            self.n += 1
            self.concurrent += 1
            self.max_concurrent = max(self.max_concurrent, self.concurrent)
            if self.fail_after is not None and self.n > self.fail_after:
                self.concurrent -= 1
                raise ConnectionError("volume server down")
            fid = f"f{self.n}"
        if self.delay:
            time.sleep(self.delay)
        with self.lock:
            self.blobs[fid] = bytes(data)
            self.concurrent -= 1
        return self.chunk_cls(fid=fid, offset=offset, size=len(data),
                              mtime_ns=mtime_ns)

    def materialize(self, chunks, size):
        from seaweedfs_tpu_torch.filer.filechunks import (
            non_overlapping_visible_intervals, view_from_visibles)
        buf = bytearray(size)
        for v in view_from_visibles(
                non_overlapping_visible_intervals(chunks), 0, size):
            blob = self.blobs[v.fid]
            buf[v.logic_offset:v.logic_offset + v.size] = \
                blob[v.offset_in_chunk:v.offset_in_chunk + v.size]
        return bytes(buf)


def test_pipeline_sequential_spill(tmp_path):
    up = FakeUploader()
    p = UploadPipeline(up, chunk_size=1024, mem_chunks=2, concurrency=2,
                       swap_dir=str(tmp_path))
    rng = random.Random(1)
    data = bytes(rng.randrange(256) for _ in range(16 * 1024 + 123))
    for off in range(0, len(data), 700):
        p.write(off, data[off:off + 700])
    chunks = p.flush()
    p.close()
    assert p.mem_peak <= 2
    assert up.materialize(chunks, len(data)) == data


def test_pipeline_out_of_order_writes(tmp_path):
    up = FakeUploader()
    p = UploadPipeline(up, chunk_size=512, mem_chunks=2, concurrency=3,
                       swap_dir=str(tmp_path))
    data = bytearray(8 * 512)
    writes = [(off, bytes([off % 251] * 100))
              for off in range(0, len(data) - 100, 37)]
    random.Random(3).shuffle(writes)
    for off, blob in writes:
        data[off:off + len(blob)] = blob
        p.write(off, blob)
    chunks = p.flush()
    p.close()
    assert up.materialize(chunks, len(data)) == bytes(data)


def test_pipeline_rewrite_shadows(tmp_path):
    up = FakeUploader()
    p = UploadPipeline(up, chunk_size=256, mem_chunks=1, concurrency=2,
                       swap_dir=str(tmp_path))
    p.write(0, b"A" * 256)
    p.write(256, b"B" * 256)
    p.write(512, b"C" * 256)
    p.wait_for_inflight(0, 1 << 32)
    p.write(100, b"X" * 56)
    chunks = p.flush()
    p.close()
    assert up.materialize(chunks, 768) == (b"A" * 100 + b"X" * 56 +
                                           b"A" * 100 + b"B" * 256 +
                                           b"C" * 256)


def test_pipeline_read_your_writes_overlay(tmp_path):
    up = FakeUploader()
    p = UploadPipeline(up, chunk_size=256, mem_chunks=4, concurrency=2,
                       swap_dir=str(tmp_path))
    p.write(10, b"hello")
    buf = bytearray(b"." * 20)
    p.overlay(buf, 0)
    assert bytes(buf) == b"." * 10 + b"hello" + b"." * 5
    p.write(250, b"0123456789ab")
    buf = bytearray(20)
    p.overlay(buf, 248)
    assert bytes(buf[2:14]) == b"0123456789ab"
    p.flush()
    p.close()


def test_pipeline_upload_error_surfaces_on_flush(tmp_path):
    up = FakeUploader(fail_after=1)
    p = UploadPipeline(up, chunk_size=128, mem_chunks=1, concurrency=2,
                       swap_dir=str(tmp_path))
    for i in range(6):
        p.write(i * 128, bytes([i]) * 128)
    with pytest.raises(ConnectionError):
        p.flush()
    p.close()


def test_pipeline_bounded_upload_concurrency(tmp_path):
    up = FakeUploader(delay=0.05)
    p = UploadPipeline(up, chunk_size=128, mem_chunks=2, concurrency=2,
                       swap_dir=str(tmp_path))
    for i in range(10):
        p.write(i * 128, bytes([i]) * 128)
    p.flush()
    p.close()
    assert up.max_concurrent <= 2


def test_pipeline_truncate(tmp_path):
    up = FakeUploader()
    p = UploadPipeline(up, chunk_size=128, mem_chunks=8, concurrency=2,
                       swap_dir=str(tmp_path))
    p.write(0, b"Z" * 1000)
    p.truncate(500)
    chunks = p.flush()
    p.close()
    assert up.materialize(chunks, 500) == b"Z" * 500
    assert max(c.offset + c.size for c in chunks) == 500


# ---------------- WeedFS over a filer ----------------


def test_mount_large_file_bounded_memory(stack, tmp_path):
    _, _, fs = stack
    chunk = 64 * 1024
    w = WeedFS(fs, swap_dir=str(tmp_path), chunk_size=chunk, mem_chunks=2,
               upload_concurrency=2)
    total = 16 * chunk
    data = bytearray(random.Random(42).getrandbits(8) for _ in range(total))
    attr, fh = w.create(ROOT_ID, "big.bin", 0o644)
    step = 50_000
    order = list(range(0, total, step))
    for i in range(0, len(order) - 2, 5):
        order[i], order[i + 2] = order[i + 2], order[i]
    for off in order:
        w.write(attr.ino, fh, off, bytes(data[off:off + step]))
    assert w.read(attr.ino, fh, 12345, 999) == bytes(data[12345:13344])
    peak = w._handles[fh].pipeline.mem_peak
    w.release(attr.ino, fh)
    got = w.lookup(ROOT_ID, "big.bin")
    assert got.size == total
    fh2 = w.open(got.ino)
    digest = hashlib.sha256()
    for off in range(0, total, 130_001):
        digest.update(w.read(got.ino, fh2, off, 130_001))
    w.release(got.ino, fh2)
    assert digest.hexdigest() == hashlib.sha256(bytes(data)).hexdigest()
    assert peak <= 2


def test_mount_survives_filer_restart(stack, tmp_path):
    master, vs, _ = stack
    chunk = 32 * 1024
    fs = FilerServer(master.url, store="sqlite", store_dir=str(tmp_path))
    fs.start()
    w = WeedFS(fs, swap_dir=str(tmp_path), chunk_size=chunk, mem_chunks=2,
               upload_concurrency=2)
    data = bytes(random.Random(9).getrandbits(8)
                 for _ in range(10 * chunk + 17))
    attr, fh = w.create(ROOT_ID, "durable.bin", 0o644)
    w.write(attr.ino, fh, 0, data)
    w.release(attr.ino, fh)
    fs.stop()
    fs2 = FilerServer(master.url, store="sqlite", store_dir=str(tmp_path))
    fs2.start()
    try:
        w2 = WeedFS(fs2, swap_dir=str(tmp_path))
        got = w2.lookup(ROOT_ID, "durable.bin")
        assert got is not None and got.size == len(data)
        fh2 = w2.open(got.ino)
        assert w2.read(got.ino, fh2, 0, len(data)) == data
        w2.release(got.ino, fh2)
    finally:
        fs2.stop()


def test_mount_truncate_and_sparse(stack, tmp_path):
    _, _, fs = stack
    w = WeedFS(fs, swap_dir=str(tmp_path), chunk_size=4096, mem_chunks=2)
    attr, fh = w.create(ROOT_ID, "t.bin", 0o644)
    w.write(attr.ino, fh, 0, b"M" * 10000)
    w.setattr(attr.ino, 1 << 3, size=6000, mode=0, mtime=0, fh=fh)
    assert w.getattr(attr.ino).size == 6000
    w.release(attr.ino, fh)
    got = w.lookup(ROOT_ID, "t.bin")
    assert got.size == 6000
    fh2 = w.open(got.ino)
    w.setattr(got.ino, 1 << 3, size=9000, mode=0, mtime=0, fh=fh2)
    data = w.read(got.ino, fh2, 0, 9000)
    w.release(got.ino, fh2)
    assert data == b"M" * 6000 + b"\x00" * 3000
    assert w.lookup(ROOT_ID, "t.bin").size == 9000


def test_mount_small_file_stays_inline(stack, tmp_path):
    _, _, fs = stack
    w = WeedFS(fs, swap_dir=str(tmp_path))
    attr, fh = w.create(ROOT_ID, "tiny.txt", 0o644)
    w.write(attr.ino, fh, 0, b"tiny payload")
    w.release(attr.ino, fh)
    entry = fs.filer.find_entry("/tiny.txt")
    assert entry.content == b"tiny payload" and not entry.chunks


def test_meta_cache_event_coherence(stack, tmp_path):
    _, _, fs = stack
    w = WeedFS(fs, swap_dir=str(tmp_path))
    w.readdir(ROOT_ID)
    assert w.lookup(ROOT_ID, "ghost.txt") is None
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    fs.filer.create_entry(Entry(full_path="/ghost.txt",
                                attr=Attr(mtime=time.time(),
                                          crtime=time.time(), mode=0o644),
                                content=b"boo"))
    got = w.lookup(ROOT_ID, "ghost.txt")
    assert got is not None and got.size == 3
    assert not is_negative(w.meta_cache.get("/ghost.txt"))
    assert w.meta_cache.events_applied >= 1
    fs.filer.delete_entry("/ghost.txt")
    assert w.lookup(ROOT_ID, "ghost.txt") is None


def test_mount_small_file_rewrite_keeps_old_bytes(stack, tmp_path):
    _, _, fs = stack
    w = WeedFS(fs, swap_dir=str(tmp_path))
    attr, fh = w.create(ROOT_ID, "re.txt", 0o644)
    w.write(attr.ino, fh, 0, b"A" * 100)
    w.flush(attr.ino, fh)
    w.write(attr.ino, fh, 50, b"B")
    w.flush(attr.ino, fh)
    w.release(attr.ino, fh)
    want = b"A" * 50 + b"B" + b"A" * 49
    assert fs.filer.find_entry("/re.txt").content == want
    fh2 = w.open(attr.ino)
    assert w.read(attr.ino, fh2, 0, 100) == want
    w.release(attr.ino, fh2)


def test_mkdir_visible_after_parent_listed(stack, tmp_path):
    _, _, fs = stack
    w = WeedFS(fs, swap_dir=str(tmp_path))
    w.readdir(ROOT_ID)
    w.mkdir(ROOT_ID, "newdir", 0o755)
    assert w.lookup(ROOT_ID, "newdir") is not None
    assert "newdir" in [n for n, _ in w.readdir(ROOT_ID)]
    fs.filer.mkdirs("/a/b/c")
    got = w.lookup(ROOT_ID, "a")
    assert got is not None and stat.S_ISDIR(got.mode)


def test_truncate_does_not_corrupt_cached_entry(stack, tmp_path):
    _, _, fs = stack
    w = WeedFS(fs, swap_dir=str(tmp_path), chunk_size=4096)
    data = bytes(range(256)) * 64
    attr, fh = w.create(ROOT_ID, "shared.bin", 0o644)
    w.write(attr.ino, fh, 0, data)
    w.release(attr.ino, fh)
    got = w.lookup(ROOT_ID, "shared.bin")
    fh_a = w.open(got.ino)
    w.setattr(got.ino, 1 << 3, size=100, mode=0, mtime=0, fh=fh_a)
    fh_b = w.open(got.ino)
    assert w.read(got.ino, fh_b, 0, len(data)) == data
    w.release(got.ino, fh_b)
    with w._lock:
        h = w._handles.pop(fh_a)
    h.close()
    assert fs.filer.find_entry("/shared.bin").file_size() == len(data)


def test_gc_preserves_shared_manifest_leaves():
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    from seaweedfs_tpu_torch.filer.filer import Filer
    blobs, deleted = {}, []
    f = Filer(delete_chunks_fn=deleted.extend,
              read_chunk_fn=lambda c: blobs[c.fid])
    leaves = [FileChunk(fid=f"L{i}", offset=i * 10, size=10, mtime_ns=1)
              for i in range(8)]
    for c in leaves:
        blobs[c.fid] = b"x" * 10

    def manifest(fid, chunks):
        blobs[fid] = json.dumps(
            {"chunks": [c.to_dict() for c in chunks]}).encode()
        return FileChunk(fid=fid, offset=0, size=80, mtime_ns=2,
                         is_chunk_manifest=True)
    f.create_entry(Entry(full_path="/m.bin", attr=Attr(mode=0o644),
                         chunks=[manifest("M1", leaves)]))
    f.create_entry(Entry(full_path="/m.bin", attr=Attr(mode=0o644),
                         chunks=[manifest("M2", leaves)]))
    assert "M1" in deleted
    assert not any(d.startswith("L") for d in deleted)


def test_rename_dir_with_open_dirty_handle(stack, tmp_path):
    _, _, fs = stack
    w = WeedFS(fs, swap_dir=str(tmp_path))
    d = w.mkdir(ROOT_ID, "d", 0o755)
    attr, fh = w.create(d.ino, "f.txt", 0o644)
    w.write(attr.ino, fh, 0, b"hello rename")
    assert w.rename(ROOT_ID, "d", ROOT_ID, "d2") == 0
    w.release(attr.ino, fh)
    assert fs.filer.find_entry("/d") is None
    assert fs.filer.find_entry("/d2/f.txt").file_size() == 12
    got = w.lookup(w.lookup(ROOT_ID, "d2").ino, "f.txt")
    fh2 = w.open(got.ino)
    assert w.read(got.ino, fh2, 0, 100) == b"hello rename"
    w.release(got.ino, fh2)


def test_meta_cache_negative_and_listing():
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    mc = MetaCache()
    mc.seed_listing("/d", [Entry(full_path="/d/a", attr=Attr(mode=0o644)),
                           Entry(full_path="/d/b", attr=Attr(mode=0o644))])
    assert [e.name for e in mc.listing("/d")] == ["a", "b"]
    assert is_negative(mc.get("/d/zzz"))
    assert mc.get("/other/x") is None
    mc.invalidate("/d/a")
    assert [e.name for e in mc.listing("/d")] == ["b"]


def test_mount_sequential_read_prefetches_and_hits_cache(stack, tmp_path):
    _, _, fs = stack
    w = WeedFS(fs, swap_dir=str(tmp_path), chunk_size=8 * 1024)
    payload = bytes([i % 251 for i in range(64 * 1024)])
    attr, fh = w.create(ROOT_ID, "seq.bin", 0o644)
    assert w.write(attr.ino, fh, 0, payload) == len(payload)
    w.release(attr.ino, fh)
    rc = fs.reader_cache
    got = w.lookup(ROOT_ID, "seq.bin")
    base = rc.prefetches
    fh = w.open(got.ino)
    out = bytearray()
    for off in range(0, len(payload), 16 * 1024):
        out += w.read(got.ino, fh, off, 16 * 1024)
    w.release(got.ino, fh)
    assert bytes(out) == payload and rc.prefetches > base
    time.sleep(0.3)
    before = rc.misses
    fh = w.open(got.ino)
    for off in range(0, len(payload), 16 * 1024):
        w.read(got.ino, fh, off, 16 * 1024)
    w.release(got.ino, fh)
    assert rc.misses == before


# ---------------- over the cluster's filer (remote store) ----------------


@pytest.fixture
def remote_stack(tmp_path):
    master, vs, real_filer = _stack(PORT, tmp_path, volume_size_limit_mb=64)
    mount_fs = FilerServer(master.url, store="remote",
                           store_dir=real_filer.url, announce=False)
    w = WeedFS(mount_fs, swap_dir=str(tmp_path))
    w.meta_cache.attach_http(real_filer.url)
    yield master, vs, real_filer, w
    w.close()
    real_filer.stop()
    vs.stop()
    master.stop()


def test_mount_writes_visible_to_http_clients(remote_stack):
    master, vs, real_filer, w = remote_stack
    attr, fh = w.create(ROOT_ID, "shared.txt", 0o644)
    w.write(attr.ino, fh, 0, b"written through the mount" * 300)
    w.release(attr.ino, fh)
    status, body, _ = http_call("GET", f"http://{real_filer.url}/shared.txt")
    assert status == 200 and body == b"written through the mount" * 300


def test_http_writes_visible_to_mount_via_subscription(remote_stack):
    master, vs, real_filer, w = remote_stack
    w.readdir(ROOT_ID)
    assert w.lookup(ROOT_ID, "pushed.txt") is None
    assert http_call("POST", f"http://{real_filer.url}/pushed.txt",
                     body=b"from an http client")[0] < 300
    deadline = time.time() + 10
    got = None
    while time.time() < deadline and got is None:
        got = w.lookup(ROOT_ID, "pushed.txt")
        time.sleep(0.2)
    assert got is not None and got.size == len(b"from an http client")
    fh = w.open(got.ino)
    assert w.read(got.ino, fh, 0, 100) == b"from an http client"
    w.release(got.ino, fh)


def test_mount_namespace_survives_mount_restart(remote_stack, tmp_path):
    master, vs, real_filer, w = remote_stack
    attr, fh = w.create(ROOT_ID, "durable.txt", 0o644)
    w.write(attr.ino, fh, 0, b"outlives the mount")
    w.release(attr.ino, fh)
    w2 = WeedFS(FilerServer(master.url, store="remote",
                            store_dir=real_filer.url, announce=False),
                swap_dir=str(tmp_path))
    got = w2.lookup(ROOT_ID, "durable.txt")
    fh2 = w2.open(got.ino)
    assert w2.read(got.ino, fh2, 0, 100) == b"outlives the mount"
    w2.release(got.ino, fh2)


def test_mount_admin_plane(stack):
    from seaweedfs_tpu_torch.mount.mount_grpc import (MountAdminClient,
                                                      start_mount_grpc)
    from seaweedfs_tpu_torch.shell.commands import ShellContext
    from seaweedfs_tpu_torch.shell.repl import run_command
    master, vs, fs = stack
    w = WeedFS(fs)
    server, port, stop = start_mount_grpc(w, master_url=master.url)
    try:
        assert w.statfs() is not None
        client = MountAdminClient(f"127.0.0.1:{port}", tls=None)
        quota = 1 << 30
        assert client.configure(quota) == quota
        assert w.statfs()[0] == quota // 4096
        assert client.configure(-1) == quota  # a query leaves it alone
        deadline = time.time() + 5
        out = {"mounts": {}}
        while time.time() < deadline and not out["mounts"]:
            out = run_command(ShellContext(master.url),
                              "mount.configure -collectionCapacity "
                              "2147483648")
            time.sleep(0.2)
        assert out["mounts"] == {f"127.0.0.1:{port}": 2 << 30}
        w._statfs_cache = None
        assert w.statfs()[0] == (2 << 30) // 4096
        client.close()
    finally:
        stop.set()
        server.stop(grace=None)


def test_weedfs_close_ends_handles_and_subscription(remote_stack):
    """WeedFS.close() (the port's): an open dirty handle is flushed (its
    bytes reach the filer), every handle's pipeline is shut down, and
    the meta cache stops following the filer."""
    master, vs, real_filer, w = remote_stack
    attr, fh = w.create(ROOT_ID, "open.bin", 0o644)
    w.write(attr.ino, fh, 0, b"O" * 300_000)
    pipeline = w._handles[fh].pipeline
    w.close()
    assert w._handles == {} and pipeline._pool._shutdown
    assert http_call("GET", f"http://{real_filer.url}/open.bin")[1] == \
        b"O" * 300_000
    assert w.meta_cache._detach is None
    assert w.swap_dir and os.path.isdir(w.swap_dir)


# ---------------- across the packages ----------------


def _weedfs_script(pkg, root):
    """One script of WeedFS operations on a fresh stack of `pkg`; what
    every operation answered and every read returned."""
    master, vs, fs = _stack(pkg, root)
    out = []
    try:
        w = pkg.weedfs.WeedFS(fs, swap_dir=str(root), chunk_size=16 * 1024,
                              mem_chunks=2, upload_concurrency=2)
        rng = np.random.default_rng(5)
        blobs = {f"f{i}.bin": rng.bytes(int(rng.integers(1, 90_000)))
                 for i in range(5)}
        d = w.mkdir(ROOT_ID, "dir", 0o755)
        for name, data in blobs.items():
            attr, fh = w.create(d.ino, name, 0o644)
            for off in range(0, len(data), 7000):
                out.append(w.write(attr.ino, fh, off, data[off:off + 7000]))
            w.release(attr.ino, fh)
        for name in blobs:
            a = w.lookup(d.ino, name)
            fh = w.open(a.ino)
            out.append((name, a.size, stat.S_IFMT(a.mode),
                        hashlib.sha256(w.read(a.ino, fh, 0, a.size))
                        .hexdigest(), w.read(a.ino, fh, 1000, 77)))
            w.release(a.ino, fh)
        out.append(w.rename(d.ino, "f0.bin", ROOT_ID, "moved.bin"))
        a = w.lookup(ROOT_ID, "moved.bin")
        fh = w.open(a.ino)
        w.setattr(a.ino, 1 << 3, size=100, mode=0, mtime=0, fh=fh)
        w.release(a.ino, fh)
        out.append(w.lookup(ROOT_ID, "moved.bin").size)
        out.append(sorted(n for n, _ in w.readdir(d.ino)))
        out.append(w.symlink(ROOT_ID, "ln", "dir/f1.bin") is not None)
        out.append(w.readlink(w.lookup(ROOT_ID, "ln").ino))
        out.append(w.unlink(d.ino, "f2.bin"))
        out.append(w.unlink(d.ino, "missing"))
        out.append(w.rmdir(ROOT_ID, "dir"))  # not empty
        out.append(sorted(n for n, _ in w.readdir(ROOT_ID)))
    finally:
        fs.stop()
        vs.stop()
        master.stop()
    return out


def test_weedfs_script_matches_jax(tmp_path):
    got = _weedfs_script(PORT, tmp_path / "port")
    want = _weedfs_script(JAX, tmp_path / "jax")
    assert got == want
    assert got[-1] == [".", "..", "dir", "ln", "moved.bin"]


def _pipeline_script(pkg, root):
    rng = np.random.default_rng(9)
    up = FakeUploader(chunk_cls=pkg.FileChunk)
    p = pkg.pw.UploadPipeline(up, chunk_size=512, mem_chunks=2,
                              concurrency=1, swap_dir=str(root))
    s = pkg.pw.IntervalSet()
    spans = []
    for _ in range(60):
        off = int(rng.integers(0, 6000))
        n = int(rng.integers(1, 700))
        s.add(off, off + n)
        spans.append(list(s.spans))
        p.write(off, rng.bytes(n))
    p.truncate(5000)
    chunks = [(c.fid, c.offset, c.size) for c in p.flush()]
    p.close()
    return spans, s.covered(), chunks, sorted(up.blobs.items())


def test_interval_set_and_pipeline_match_jax(tmp_path):
    """Seeded writes through each package's IntervalSet and
    UploadPipeline (one upload at a time, so fids come in order): equal
    spans, chunk lists and uploaded bytes."""
    got = _pipeline_script(PORT, tmp_path)
    want = _pipeline_script(JAX, tmp_path)
    assert got == want
    assert got[2]
