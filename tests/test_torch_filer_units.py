"""The port's filer modules held against the JAX package, unit by unit, on
inputs drawn from a numpy seed: entry encodings, visible intervals and
chunk views, manifests (MANIFEST_BATCH patched small), filer.conf
matching, the MetaLog and its persisted segments, hard links, the entry
cache, the three embedded stores under one operation script, an LSM
directory written by each package opened by the other, the reader and
chunk caches, the cipher, the ledger auto-capper, the notification queues
and remote mounts over a local remote. Each case runs the same script on
both packages and compares what they return; the wire stores' names and
aliases resolve through make_store, notification.toml makes each package
the same external queue and the azure remote type the same Azure client.
(ref tests/test_filer.py, test_filer_depth.py, test_metalog_persist.py,
test_reader_cache.py, test_shard_scaleout.py's autocap cases,
test_cipher_ftp.py's cipher cases, test_remote_storage.py.)
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest

import seaweedfs_tpu.filer.abstract_sql as j_sql
import seaweedfs_tpu.filer.entry as j_entry
import seaweedfs_tpu.filer.entry_cache as j_entry_cache
import seaweedfs_tpu.filer.filechunk_manifest as j_manifest
import seaweedfs_tpu.filer.filechunks as j_chunks
import seaweedfs_tpu.filer.filer as j_filer
import seaweedfs_tpu.filer.filer_conf as j_conf
import seaweedfs_tpu.filer.filerstore as j_store
import seaweedfs_tpu.filer.lsm_store as j_lsm
import seaweedfs_tpu.filer.reader_cache as j_reader
import seaweedfs_tpu.filer.remote_mount as j_remote_mount
import seaweedfs_tpu.notification.queue as j_queue
import seaweedfs_tpu.qos.governor as j_governor
import seaweedfs_tpu.remote_storage.remote_storage as j_remote
import seaweedfs_tpu.stats.autocap as j_autocap
import seaweedfs_tpu.stats.ledger as j_ledger
import seaweedfs_tpu.utils.chunk_cache as j_chunk_cache
import seaweedfs_tpu.utils.cipher as j_cipher
import seaweedfs_tpu_torch.filer.abstract_sql as p_sql
import seaweedfs_tpu_torch.filer.entry as p_entry
import seaweedfs_tpu_torch.filer.entry_cache as p_entry_cache
import seaweedfs_tpu_torch.filer.filechunk_manifest as p_manifest
import seaweedfs_tpu_torch.filer.filechunks as p_chunks
import seaweedfs_tpu_torch.filer.filer as p_filer
import seaweedfs_tpu_torch.filer.filer_conf as p_conf
import seaweedfs_tpu_torch.filer.filerstore as p_store
import seaweedfs_tpu_torch.filer.lsm_store as p_lsm
import seaweedfs_tpu_torch.filer.reader_cache as p_reader
import seaweedfs_tpu_torch.filer.remote_mount as p_remote_mount
import seaweedfs_tpu_torch.notification.queue as p_queue
import seaweedfs_tpu_torch.qos.governor as p_governor
import seaweedfs_tpu_torch.remote_storage.remote_storage as p_remote
import seaweedfs_tpu_torch.stats.autocap as p_autocap
import seaweedfs_tpu_torch.stats.ledger as p_ledger
import seaweedfs_tpu_torch.utils.chunk_cache as p_chunk_cache
import seaweedfs_tpu_torch.utils.cipher as p_cipher

JAX = types.SimpleNamespace(
    entry=j_entry, chunks=j_chunks, manifest=j_manifest, filer=j_filer,
    conf=j_conf, store=j_store, sql=j_sql, lsm=j_lsm, cache=j_entry_cache,
    reader=j_reader, chunk_cache=j_chunk_cache, cipher=j_cipher,
    autocap=j_autocap, ledger=j_ledger, governor=j_governor, queue=j_queue,
    remote=j_remote, remote_mount=j_remote_mount)
PORT = types.SimpleNamespace(
    entry=p_entry, chunks=p_chunks, manifest=p_manifest, filer=p_filer,
    conf=p_conf, store=p_store, sql=p_sql, lsm=p_lsm, cache=p_entry_cache,
    reader=p_reader, chunk_cache=p_chunk_cache, cipher=p_cipher,
    autocap=p_autocap, ledger=p_ledger, governor=p_governor, queue=p_queue,
    remote=p_remote, remote_mount=p_remote_mount)
SEEDS = [0, 1, 2, 3]


def _both(fn, *args):
    """fn run on the port and on the JAX package; both results."""
    return fn(PORT, *args), fn(JAX, *args)


# ---------------- entry encodings ----------------


def _random_entry(pkg, rng, path):
    e = pkg.entry
    chunks = [e.FileChunk(
        fid=f"{int(rng.integers(1, 99))},{int(rng.integers(1, 1 << 40)):x}"
            f"{int(rng.integers(0, 1 << 32)):08x}",
        offset=int(rng.integers(0, 1 << 30)),
        size=int(rng.integers(1, 1 << 22)),
        mtime_ns=int(rng.integers(0, 1 << 62)),
        etag=rng.bytes(8).hex(),
        cipher_key=rng.bytes(32) if rng.random() < 0.5 else b"",
        is_compressed=bool(rng.random() < 0.3),
        is_chunk_manifest=bool(rng.random() < 0.2))
        for _ in range(int(rng.integers(0, 5)))]
    attr = e.Attr(mtime=float(rng.integers(0, 1 << 31)),
                  crtime=float(rng.integers(0, 1 << 31)),
                  mode=int(rng.integers(0, 0o7777)),
                  uid=int(rng.integers(0, 65535)),
                  gid=int(rng.integers(0, 65535)),
                  mime=["", "text/plain", "image/png"][int(rng.integers(3))],
                  ttl_sec=int(rng.integers(0, 86400)),
                  user_name="u", group_names=("g1", "g2"),
                  md5=rng.bytes(16), file_size=int(rng.integers(0, 1 << 33)),
                  is_directory=bool(rng.random() < 0.2),
                  collection="c", replication="001")
    remote = (e.RemoteEntry(storage_name="r", last_local_sync_ts=3,
                            remote_etag="x", remote_mtime=4, remote_size=5)
              if rng.random() < 0.5 else None)
    return e.Entry(full_path=path, attr=attr, chunks=chunks,
                   extended={"k": rng.bytes(4), "s": "v"},
                   content=rng.bytes(int(rng.integers(0, 64))),
                   hard_link_id=rng.bytes(8).hex() if rng.random() < 0.3
                   else "", remote=remote)


@pytest.mark.parametrize("seed", SEEDS)
def test_entry_encodings_byte_equal(seed):
    def run(pkg):
        rng = np.random.default_rng(seed)
        out = []
        for i in range(20):
            ent = _random_entry(pkg, rng, f"/d{i % 3}/f{i}")
            d = ent.to_dict()
            back = pkg.entry.Entry.from_dict(json.loads(json.dumps(d)))
            assert back == ent
            out.append((json.dumps(d, sort_keys=True), ent.file_size(),
                        ent.name, ent.dir_path, ent.is_directory))
        return out
    got, want = _both(run)
    assert got == want


# ---------------- visible intervals and chunk views ----------------


def _random_chunks(pkg, rng, n, span):
    out = []
    for i in range(n):
        off = int(rng.integers(0, span))
        size = int(rng.integers(1, span // 4 + 2))
        out.append(pkg.entry.FileChunk(
            fid=f"{i % 7 + 1},{i:x}00000000", offset=off, size=size,
            mtime_ns=int(rng.integers(0, 50))))  # ties on purpose
    return out


@pytest.mark.parametrize("seed", SEEDS + [4, 5])
def test_visible_intervals_and_views_match(seed):
    def run(pkg):
        rng = np.random.default_rng(seed)
        out = []
        for n in (1, 2, 5, 17, 40):
            chunks = _random_chunks(pkg, rng, n, 1 << 16)
            vis = pkg.chunks.non_overlapping_visible_intervals(chunks)
            out.append([(v.start, v.stop, v.fid, v.mtime_ns)
                        for v in vis])
            for _ in range(5):
                lo = int(rng.integers(0, 1 << 16))
                size = int(rng.integers(1, 1 << 15))
                views = pkg.chunks.view_from_visibles(vis, lo, size)
                out.append([(v.logic_offset, v.size, v.fid,
                             v.offset_in_chunk) for v in views])
        return out
    got, want = _both(run)
    assert got == want


# ---------------- manifests ----------------


@pytest.mark.parametrize("batch,n", [(3, 2), (3, 10), (4, 70), (5, 5)])
def test_manifestize_and_resolve_match(batch, n, monkeypatch):
    """maybe_manifestize collapses a wide chunk list recursively and
    resolve_chunk_manifest expands it back, with MANIFEST_BATCH patched
    small; the packed lists and blobs are equal across packages."""
    def run(pkg):
        monkeypatch.setattr(pkg.manifest, "MANIFEST_BATCH", batch)
        rng = np.random.default_rng(n)
        chunks = [pkg.entry.FileChunk(fid=f"1,{i:x}00000000", offset=i * 10,
                                      size=10, mtime_ns=int(rng.integers(99)))
                  for i in range(n)]
        blobs = {}

        def save(blob):
            fid = f"9,{len(blobs):x}00000000"
            blobs[fid] = blob
            return pkg.entry.FileChunk(fid=fid, offset=0, size=len(blob))

        packed = pkg.manifest.maybe_manifestize(
            save, list(chunks), batch=pkg.manifest.MANIFEST_BATCH)
        assert len(packed) <= batch
        assert pkg.manifest.has_chunk_manifest(packed) == (n > batch)
        leaves = pkg.manifest.resolve_chunk_manifest(
            lambda c: blobs[c.fid], packed)
        assert sorted(leaves, key=lambda c: c.offset) == chunks
        return [c.to_dict() for c in packed], blobs
    got, want = _both(run)
    assert got == want


# ---------------- filer.conf ----------------


@pytest.mark.parametrize("seed", SEEDS)
def test_filer_conf_matching(seed):
    def run(pkg):
        rng = np.random.default_rng(seed)
        store = pkg.store.MemoryStore()
        conf = pkg.conf.FilerConf()
        prefixes = ["/", "/data/", "/data/a/", "/data/a/b/", "/tmp/",
                    "/data/ab/"]
        for p in prefixes:
            conf.set_rule(pkg.conf.PathConf(
                location_prefix=p,
                collection=["", f"c{p.count('/')}"][int(rng.integers(2))],
                replication=["", "001", "010"][int(rng.integers(3))],
                ttl=["", "3d"][int(rng.integers(2))],
                read_only=bool(rng.random() < 0.3),
                fsync=bool(rng.random() < 0.3)))
        conf.delete_rule("/tmp/")
        conf.save(store)
        loaded = pkg.conf.FilerConf.load(store)
        paths = ["/x", "/data/f", "/data/a/f", "/data/ab/f", "/data/a/b/c/d",
                 "/tmp/f", "/data/abc"]
        return (conf.to_json(), loaded.to_json(),
                [loaded.match_storage_rule(p).to_dict() for p in paths])
    got, want = _both(run)
    assert got == want


# ---------------- MetaLog and the Filer core ----------------


def test_metalog_replays_persisted_segments(tmp_path):
    def run(pkg, d):
        log = pkg.filer.MetaLog(capacity=10, persist_dir=str(d))
        log.SEGMENT_EVENTS = 5
        for i in range(50):
            log.append(pkg.filer.MetaLogEvent(
                f"/d{i % 3}", None, {"full_path": f"/d{i % 3}/f{i}"},
                tsns=1000 + i))
        log.flush()
        out = [[e.to_dict() for e in log.read_since(t, p, limit=1000)]
               for t, p in ((0, "/"), (0, "/d1"), (1039, "/"))]
        # a fresh process replays the persisted segments
        log2 = pkg.filer.MetaLog(capacity=4, persist_dir=str(d))
        out.append([e.tsns for e in log2.read_since(0, "/", limit=100)])
        return out
    got = run(PORT, tmp_path / "port")
    want = run(JAX, tmp_path / "jax")
    assert got == want
    assert len(got[0]) == 50 and got[3] == list(range(1000, 1050))
    # each package replays the other's segments
    for pkg, d in ((PORT, "jax"), (JAX, "port")):
        log = pkg.filer.MetaLog(capacity=4, persist_dir=str(tmp_path / d))
        assert [e.to_dict() for e in log.read_since(0, "/", limit=100)] \
            == got[0]


def _durable_log(d, capacity=10):
    log = PORT.filer.MetaLog(capacity=capacity, persist_dir=str(d),
                             durable=True)
    log.SEGMENT_EVENTS = 5
    return log


def test_durable_metalog_writes_every_event_through(tmp_path):
    """A durable log loses no event to a kill: with nothing flushed or
    closed, a second log on the directory replays every event, in the
    same dicts the buffered log of either package persists, and a
    reader of it neither waits nor skips past them."""
    log = _durable_log(tmp_path / "durable")
    evs = [PORT.filer.MetaLogEvent(f"/d{i % 3}", None,
                                   {"full_path": f"/d{i % 3}/f{i}"},
                                   tsns=1000 + i) for i in range(12)]
    for ev in evs:
        log.append(ev)
    fresh = _durable_log(tmp_path / "durable", capacity=100)
    assert fresh.latest_tsns() == 1011
    t0 = time.monotonic()
    assert fresh.wait_for_events(0, timeout=5.0)
    assert time.monotonic() - t0 < 1.0
    got = [e.to_dict() for e in fresh.read_since(0, "/", limit=100)]
    assert got == [e.to_dict() for e in evs]
    # the JAX package's log replays the durable segments as its own
    jlog = JAX.filer.MetaLog(capacity=4, persist_dir=str(tmp_path / "durable"))
    assert [e.to_dict() for e in jlog.read_since(0, "/", limit=100)] == got


@pytest.mark.parametrize("restarts", [0, 3])
def test_durable_metalog_directory_stays_bounded(tmp_path, restarts):
    """Past `capacity` events a durable log drops its oldest segments:
    capacity // SEGMENT_EVENTS + 1 of them stay (3 here), so the
    directory holds at most 15 events after 200, and a fresh log replays
    the newest of them in order (restarts: logs opened one after another
    on the directory, each starting its own segment)."""
    d = tmp_path / "bounded"
    n, per = 200, 200 // (restarts + 1)
    log = None
    for i in range(n):
        if i % per == 0:
            if log is not None:
                log.flush()
            log = _durable_log(d)
        log.append(PORT.filer.MetaLogEvent("/b", None, {"i": i},
                                           tsns=10_000 + i))
        assert len(os.listdir(d)) <= 3
    kept = [e.tsns for e in _durable_log(d, 100).read_since(0, "/",
                                                            limit=1000)]
    assert kept == list(range(10_000 + n - 15, 10_000 + n))


def _namespace_script(pkg, f):
    """A fixed sequence of Filer operations; what the namespace and the
    meta log show afterwards, times and link ids left out."""
    e = pkg.entry
    f.create_entry(e.Entry("/docs/readme.md", e.Attr(mtime=1.0,
                                                    file_size=3),
                           content=b"abc"))
    with pytest.raises(FileExistsError):
        f.create_entry(e.Entry("/docs/readme.md"), o_excl=True)
    f.rename_entry("/docs/readme.md", "/docs/intro.md")
    f.mkdirs("/a/b/c")
    f.create_entry(e.Entry("/a/b/c/x", e.Attr(file_size=10),
                           chunks=[e.FileChunk("3,01", 0, 10)]))
    f.add_hard_link("/a/b/c/x", "/a/link")
    f.add_hard_link("/a/link", "/docs/link2")
    linked = f.find_entry("/docs/link2")
    with pytest.raises(OSError):
        f.delete_entry("/docs")
    f.delete_entry("/a/b/c/x")
    count = f.store.link_count(linked.hard_link_id)
    f.delete_entry("/docs", recursive=True)
    listing = []
    stack = ["/"]
    while stack:
        d = stack.pop()
        for ent in f.list_entries(d, limit=1000):
            listing.append((ent.full_path, ent.is_directory,
                            ent.file_size(),
                            [c.fid for c in ent.chunks]))
            if ent.is_directory:
                stack.append(ent.full_path)
    events = [(ev.directory,
               (ev.old_entry or {}).get("full_path"),
               (ev.new_entry or {}).get("full_path"))
              for ev in f.meta_log.read_since(0, "/", limit=1000)]
    return sorted(listing), events, count, linked.chunks[0].fid


@pytest.mark.parametrize("entry_cache", [True, False])
def test_filer_namespace_hardlinks_and_meta_log(entry_cache):
    def run(pkg):
        gc = []
        f = pkg.filer.Filer(delete_chunks_fn=gc.extend,
                            entry_cache=entry_cache)
        out = _namespace_script(pkg, f)
        snap = f.entry_cache.snapshot() if entry_cache else None
        f.close()
        return out, sorted(gc), snap
    got, want = _both(run)
    assert got == want
    (listing, _events, count, fid), gc, _ = got
    assert ("/a/link", False, 10, ["3,01"]) in listing
    assert count == 2 and fid == "3,01" and gc == []


def test_entry_cache_fences_stale_fills():
    def run(pkg):
        c = pkg.cache.EntryCache(capacity=4, neg_capacity=2)
        out = []
        tok = c.begin("/a")
        c.invalidate("/a")  # a mutation raced the fill
        out.append(c.put("/a", {"full_path": "/a"}, tok))
        tok = c.begin("/a")
        out.append(c.put("/a", {"full_path": "/a", "v": 1}, tok))
        out.append(c.get("/a"))
        for i in range(6):
            c.put(f"/p{i}", {"full_path": f"/p{i}"}, c.begin(f"/p{i}"))
        for i in range(3):
            c.put_negative(f"/n{i}", c.begin(f"/n{i}"))
        out += [c.get("/a"), c.get("/p5"), c.get("/n0"), c.get("/n2")]
        c.clear()
        out.append(c.get("/p5"))
        out.append(c.snapshot())
        return out
    got, want = _both(run)
    assert got == want
    assert got[0] is False and got[1] is True


# ---------------- the embedded stores ----------------


def _make_store(pkg, kind, d):
    if kind == "memory":
        return pkg.store.make_store("memory")
    if kind == "sqlite":
        return pkg.store.make_store("sqlite", path=str(d / "filer.db"))
    return pkg.store.make_store("lsm", path=str(d / "filer_lsm"))


def _store_script(pkg, store, seed):
    """Seeded inserts, updates, deletes, folder deletes and kv ops; the
    listings (whole, by prefix, paged) and lookups they leave."""
    rng = np.random.default_rng(seed)
    e = pkg.entry
    dirs = ["/a", "/a/b", "/c", "/c/d/e"]
    names = [f"n{i:02d}" for i in range(12)] + ["z", "a.b", "a-b", "é"]
    for i in range(120):
        d = dirs[int(rng.integers(len(dirs)))]
        name = names[int(rng.integers(len(names)))]
        op = rng.random()
        ent = e.Entry(f"{d}/{name}", e.Attr(file_size=i, mtime=float(i)),
                      chunks=[e.FileChunk(f"1,{i:x}", 0, i)])
        if op < 0.6:
            store.insert_entry(ent)
        elif op < 0.8:
            if store.find_entry(ent.full_path) is not None:
                store.update_entry(ent)
        elif op < 0.95:
            store.delete_entry(ent.full_path)
        else:
            store.kv_put(f"k{i % 5}".encode(), rng.bytes(8))
    store.delete_folder_children("/c/d")
    store.kv_delete(b"k1")
    out = []
    for d in dirs + ["/c/d", "/nope"]:
        out.append([x.to_dict() for x in store.list_directory_entries(
            d, limit=1000)])
        out.append([x.name for x in store.list_directory_entries(
            d, prefix="n0", limit=1000)])
        out.append([x.name for x in store.list_directory_entries(
            d, start_name="n05", include_start=False, limit=3)])
        out.append([x.name for x in store.list_directory_entries(
            d, start_name="n05", include_start=True, limit=3)])
    for d in dirs:
        for name in names:
            got = store.find_entry(f"{d}/{name}")
            out.append(got.to_dict() if got else None)
    out.append([store.kv_get(f"k{i}".encode()) for i in range(5)])
    return out


@pytest.mark.parametrize("kind", ["memory", "sqlite", "lsm"])
@pytest.mark.parametrize("seed", [0, 1])
def test_stores_give_equal_listings(kind, seed, tmp_path):
    """The same operations on the same store kind leave the same listings
    in both packages, and every kind leaves the port's memory store's."""
    def run(pkg, d):
        d.mkdir()
        s = _make_store(pkg, kind, d)
        try:
            return _store_script(pkg, s, seed)
        finally:
            s.close()
    got = run(PORT, tmp_path / "port")
    assert got == run(JAX, tmp_path / "jax")
    assert got == run(PORT, tmp_path / "memory_ref") if kind == "memory" \
        else got == _store_script(PORT, p_store.MemoryStore(), seed)


def test_lsm_directory_opens_in_either_package(tmp_path):
    """An LSM store written and closed by the JAX package opens in the
    port with the same tree, and the other way round."""
    def write(pkg, d):
        s = pkg.lsm.LsmStore(str(d))
        _store_script(pkg, s, 5)
        return s

    def read(pkg, d):
        s = pkg.lsm.LsmStore(str(d))
        try:
            return [[x.to_dict() for x in s.list_directory_entries(
                dd, limit=1000)] for dd in ("/", "/a", "/a/b", "/c")] + \
                [s.kv_get(f"k{i}".encode()) for i in range(5)]
        finally:
            s.close()
    for src, dst, name in ((JAX, PORT, "j"), (PORT, JAX, "p")):
        d = tmp_path / name
        write(src, d).close()
        assert read(dst, d) == read(src, d)
        assert read(dst, d)[1]  # /a holds entries


@pytest.mark.parametrize("name,cls", [
    ("redis", "RedisFilerStore"), ("mysql", "MysqlFilerStore"),
    ("postgres2", "PostgresFilerStore"), ("mongodb", "MongoFilerStore"),
    ("cassandra", "CassandraFilerStore"), ("elastic7", "ElasticFilerStore"),
    ("redis2", "RedisFilerStore")])
def test_unported_stores_raise_naming_their_slice(name, cls):
    """The wire stores came with the filer-stores slice: each name and
    alias resolves through make_store to the port's class, which talks to
    the port's mini server of its family."""
    import importlib
    family = p_store._ALIASES.get(name, name)
    mod = importlib.import_module(
        f"seaweedfs_tpu_torch.filer.{family}_store")
    mini = {"redis": "MiniRedisServer", "mysql": "MiniMysqlServer",
            "postgres": "MiniPostgresServer", "mongodb": "MiniMongoServer",
            "cassandra": "MiniCassandraServer",
            "elastic": "MiniElasticServer"}[family]
    srv = getattr(mod, mini)().start()
    try:
        s = p_store.make_store(name, host="127.0.0.1", port=srv.port)
        try:
            assert type(s) is getattr(mod, cls)
            s.kv_put(b"k", b"v")
            assert s.kv_get(b"k") == b"v"
        finally:
            s.close()
    finally:
        srv.stop()


# ---------------- reader and chunk caches ----------------


def test_reader_cache_single_flight_and_prefetch():
    def run(pkg):
        calls = []
        gate = threading.Event()

        def slow_fetch(fid):
            calls.append(fid)
            gate.wait(5)
            return b"blob-" + fid.encode()

        rc = pkg.reader.ReaderCache(slow_fetch,
                                    pkg.chunk_cache.MemChunkCache())
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(rc.get("3,abc")))
            for _ in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while not calls and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(10)
        rc.maybe_prefetch(["3,abc", "4,d", "5,e"])
        deadline = time.monotonic() + 10
        while len(calls) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        before = rc.misses
        got = rc.get("4,d")
        rc.close()
        return (results, sorted(calls), rc.misses + rc.joins, got,
                rc.misses == before, rc.prefetches)
    got, want = _both(run)
    assert got == want
    assert got[0] == [b"blob-3,abc"] * 8 and got[1] == ["3,abc", "4,d",
                                                        "5,e"]


def test_tiered_chunk_cache_spills_to_disk(tmp_path):
    def run(pkg, d):
        c = pkg.chunk_cache.TieredChunkCache(mem_bytes=5000,
                                             disk_dir=str(d),
                                             disk_bytes=1 << 20)
        rng = np.random.default_rng(9)
        blobs = {f"1,{i:x}": rng.bytes(2000) for i in range(8)}
        for k, v in blobs.items():
            c.put(k, v)
        return [(c.get(k) == v, c.contains(k)) for k, v in blobs.items()]
    got = run(PORT, tmp_path / "p")
    assert got == run(JAX, tmp_path / "j")
    assert all(hit for hit, _ in got)


# ---------------- cipher ----------------


@pytest.mark.parametrize("size", [0, 1, 4095, 1 << 20])
def test_cipher_round_trips_across_packages(size):
    data = np.random.default_rng(size).bytes(size)
    for enc, dec in ((p_cipher, j_cipher), (j_cipher, p_cipher)):
        blob, key = enc.encrypt(data)
        assert len(key) == 32 and blob != data or size == 0
        assert dec.decrypt(blob, key) == data
        with pytest.raises(Exception):
            dec.decrypt(blob, bytes(32))


def test_aesgcm_compat_matches_cryptography():
    from seaweedfs_tpu_torch.utils import aesgcm_compat
    AESGCM = pytest.importorskip(
        "cryptography.hazmat.primitives.ciphers.aead").AESGCM
    rng = np.random.default_rng(3)
    key, nonce = rng.bytes(32), rng.bytes(12)
    for n in (0, 15, 16, 1000):
        data = rng.bytes(n)
        want = AESGCM(key).encrypt(nonce, data, None)
        assert aesgcm_compat.AESGCM(key).encrypt(nonce, data, None) == want
        assert aesgcm_compat.AESGCM(key).decrypt(nonce, want, None) == data


# ---------------- the ledger auto-capper ----------------


def test_autocap_clips_flood_tenant_and_forgives():
    def run(pkg):
        ledger = pkg.ledger.ResourceLedger()
        gov = pkg.governor.QosGovernor(enabled=True)
        ac = pkg.autocap.LedgerAutoCapper(ledger, gov, interval_s=1.0,
                                          min_requests=50, release_ticks=2)
        ac.tick()
        for _ in range(500):
            ledger.observe_request("interactive", "flood")
        for _ in range(10):
            ledger.observe_request("interactive", "quiet")
        for _ in range(100):
            ledger.observe_request("interactive", pkg.ledger.OTHER_TENANT)
        out = ac.tick()
        caps = sorted(gov.tenant_caps)
        released = []
        for _ in range(3):
            released += ac.tick()["released"]
        return ([c["tenant"] for c in out["installed"]], caps,
                [c["tenant"] for c in released], sorted(gov.tenant_caps),
                {k: v for k, v in ac.snapshot().items()
                 if k.startswith("caps_")})
    got, want = _both(run)
    assert got == want
    assert got[0] == ["flood"] and got[2] == ["flood"] and got[3] == []


def test_autocap_leaves_a_lone_tenant_alone():
    """One tenant flooding a class with no other tenant in it is not
    capped by the port (seaweedfs_tpu's capper clips it to a tenth of its
    rate); once a second tenant burns beside it, it is, and the cap lifts
    when the other tenant leaves."""
    def flood(pkg, tenants):
        ledger = pkg.ledger.ResourceLedger()
        gov = pkg.governor.QosGovernor(enabled=True)
        ac = pkg.autocap.LedgerAutoCapper(ledger, gov, interval_s=1.0,
                                          min_requests=50, release_ticks=2)
        ac.tick()
        out = []
        for others in tenants:
            for _ in range(500):
                ledger.observe_request("interactive", "lone")
            for t in others:
                for _ in range(10):
                    ledger.observe_request("interactive", t)
            ac.tick()
            out.append(sorted(gov.tenant_caps))
        return out
    script = [[], [], ["other"], [], [], []]
    got = flood(PORT, script)
    assert got[:2] == [[], []]
    assert got[2] == [("interactive", "lone")]
    assert got[-1] == []
    assert flood(JAX, script)[0] == [("interactive", "lone")]


# ---------------- notification queues ----------------


def test_notification_queues_and_attach_to_filer(tmp_path, monkeypatch):
    def run(pkg, d):
        d.mkdir()
        f = pkg.filer.Filer()
        mem = pkg.queue.InMemoryQueue()
        pkg.queue.attach_to_filer(f, mem)
        fq = pkg.queue.FileQueue(str(d / "q.jsonl"))
        pkg.queue.attach_to_filer(f, fq)
        f.create_entry(pkg.entry.Entry("/n/a", pkg.entry.Attr(mtime=1.0)))
        f.delete_entry("/n/a")
        seen = []
        while not mem.q.empty():
            key, msg = mem.receive(timeout=1)
            seen.append((key, msg["directory"],
                         (msg["new_entry"] or {}).get("full_path")))
        lines = [json.loads(x)["key"]
                 for x in (d / "q.jsonl").read_text().splitlines()]
        return seen, lines
    got = run(PORT, tmp_path / "p")
    assert got == run(JAX, tmp_path / "j")
    assert ("/n/a", "/n", "/n/a") in got[0]
    # notification.toml makes the log and file queues and, for the
    # external ones, the same client in both packages (kafka dials at
    # once: a listener stands in for the broker)
    import socket
    monkeypatch.chdir(tmp_path)
    for section, cls in (("log", p_queue.LogQueue),
                         ("file", p_queue.FileQueue)):
        (tmp_path / "notification.toml").write_text(
            f"[notification.{section}]\nenabled = true\n")
        assert isinstance(p_queue.make_queue_from_config(), cls)
    with socket.socket() as lsn:
        lsn.bind(("127.0.0.1", 0))
        lsn.listen(4)
        kafka = f'address = "127.0.0.1:{lsn.getsockname()[1]}"\n'
        for section, extra, cls in (
                ("kafka", kafka, "KafkaQueue"),
                ("aws_sqs", 'sqs_queue_url = "http://127.0.0.1:1/q/e"\n',
                 "SqsQueue"),
                ("google_pub_sub", 'project_id = "p"\ntopic = "t"\n',
                 "PubSubQueue")):
            (tmp_path / "notification.toml").write_text(
                f"[notification.{section}]\nenabled = true\n{extra}")
            got = p_queue.make_queue_from_config()
            want = j_queue.make_queue_from_config()
            try:
                assert type(got).__name__ == type(want).__name__ == cls
                assert sorted(vars(got)) == sorted(vars(want))
            finally:
                got.close()
                want.close()


# ---------------- remote mounts ----------------


def test_remote_mount_over_a_local_remote(tmp_path):
    """remote.configure / mount / meta.sync / cache / uncache / write-back
    over a "local" remote, the same in both packages; the persisted
    configuration reads across packages; the S3-dialect types make the
    same S3Remote in both packages, and the azure type the same
    AzureRemote."""
    def run(pkg, name):
        root = tmp_path / f"remote_{name}"
        (root / "sub").mkdir(parents=True)
        (root / "a.txt").write_bytes(b"alpha")
        (root / "sub" / "b.bin").write_bytes(bytes(range(256)) * 4)
        store = pkg.store.MemoryStore()
        f = pkg.filer.Filer(store)
        rm = pkg.remote_mount.RemoteMounts(f)
        rm.configure(pkg.remote.RemoteConf(name="loc", type="local",
                                           root=str(root)))
        rm.mount("/m", "loc")
        pulled = rm.pull_metadata("/m")
        ent = f.find_entry("/m/sub/b.bin")
        body = rm.read_through(ent)
        blobs = {}

        def upload(data):
            fid = f"5,{len(blobs):x}"
            blobs[fid] = data
            return [pkg.entry.FileChunk(fid, 0, len(data))]
        cached = rm.cache_entry(ent, upload)
        uncached = rm.uncache_entry(f.find_entry("/m/sub/b.bin"))
        rm.write_back(f.find_entry("/m/a.txt"), b"ALPHA!")
        listing = sorted(e.full_path for e in f.list_entries("/m"))
        return (pulled, len(body), body == (root / "sub" / "b.bin")
                .read_bytes(), len(cached.chunks), len(uncached.chunks),
                (root / "a.txt").read_bytes(), listing,
                store.kv_get(pkg.remote_mount.REMOTE_CONF_KV_KEY),
                sorted(rm.list_mappings().items()),
                {k: v.to_public_dict() for k, v in rm.list_confs().items()})
    got, want = run(PORT, "p"), run(JAX, "j")
    # the only difference is the remote's root directory
    got_conf, want_conf = got[7], want[7]
    assert got[:7] == want[:7] and got[8] == want[8]
    assert got_conf.replace(b"remote_p", b"remote_j") == want_conf
    assert got[0] == 2 and got[5] == b"ALPHA!"
    # the port reads the JAX package's persisted conf and back
    js = j_store.MemoryStore()
    js.kv_put(j_remote_mount.REMOTE_CONF_KV_KEY, want_conf)
    ps = p_store.MemoryStore()
    ps.kv_put(p_remote_mount.REMOTE_CONF_KV_KEY, want_conf)
    assert {k: v.to_public_dict() for k, v in p_remote_mount.RemoteMounts(
        p_filer.Filer(ps)).list_confs().items()} == {
        k: v.to_public_dict() for k, v in j_remote_mount.RemoteMounts(
            j_filer.Filer(js)).list_confs().items()}
    for kind in ("s3", "gcs", "b2", "wasabi"):
        kw = dict(name="x", type=kind, endpoint="http://127.0.0.1:1",
                  bucket="b", access_key="a", secret_key="s")
        got = p_remote.make_remote_client(p_remote.RemoteConf(**kw))
        want = j_remote.make_remote_client(j_remote.RemoteConf(**kw))
        assert type(got).__name__ == type(want).__name__ == "S3Remote"
        assert (got.endpoint, got.bucket, got.host) == \
            (want.endpoint, want.bucket, want.host)
        assert vars(got.signer) == vars(want.signer)
    kw = dict(name="x", type="azure", endpoint="http://127.0.0.1:1",
              bucket="b", access_key="a", secret_key="czNjcmV0")
    got = p_remote.make_remote_client(p_remote.RemoteConf(**kw))
    want = j_remote.make_remote_client(j_remote.RemoteConf(**kw))
    assert type(got).__name__ == type(want).__name__ == "AzureRemote"
    assert vars(got) == vars(want)
