"""The port's filer stores held against the JAX package's.

Three parts:
- the FilerStore contract, one body over every family of the port's
  registry (memory, sqlite, lsm and the wire families redis RESP2, etcd
  gRPC, mysql, postgres, mongodb OP_MSG, cassandra CQL v4, elasticsearch
  REST), each wire store against the port's own in-process mini server,
  and the RESP2 client and the redis store on their own;
- cross-package runs for each of the six wire families the port took
  from the reference last (redis, mysql, postgres, mongodb, cassandra,
  elastic): one seeded operation script gives the same results through
  the JAX store and the port's; the wire works both ways (the port's
  client against the JAX package's mini server and the JAX client
  against the port's); entries one package writes, the other reads back
  equal by their Entry encoding;
- a port FilerServer on each wire family over CPU volume servers, which
  writes, restarts on the same database and lists.
(ref tests/test_filer_stores_contract.py and tests/test_redis_store.py.)
"""

import functools
import importlib
import json
import statistics
import time

import numpy as np
import pytest

from seaweedfs_tpu.filer import entry as jentry
from seaweedfs_tpu.filer import filerstore as jfilerstore
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.filer.filerstore import STORES, make_store
from seaweedfs_tpu_torch.filer.redis_store import (MiniRedisServer,
                                                   RedisFilerStore,
                                                   RespClient)
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils.httpd import http_call

FAMILIES = ["memory", "sqlite", "lsm", "redis", "etcd", "mysql",
            "postgres", "mongodb", "cassandra", "elastic"]
# family -> (module, store class, mini server class)
WIRE = {
    "redis": ("redis_store", "RedisFilerStore", "MiniRedisServer"),
    "etcd": ("etcd_store", "EtcdFilerStore", "MiniEtcdServer"),
    "mysql": ("mysql_store", "MysqlFilerStore", "MiniMysqlServer"),
    "postgres": ("postgres_store", "PostgresFilerStore",
                 "MiniPostgresServer"),
    "mongodb": ("mongodb_store", "MongoFilerStore", "MiniMongoServer"),
    "cassandra": ("cassandra_store", "CassandraFilerStore",
                  "MiniCassandraServer"),
    "elastic": ("elastic_store", "ElasticFilerStore", "MiniElasticServer"),
}
SIX = ["redis", "mysql", "postgres", "mongodb", "cassandra", "elastic"]
PKGS = {"jax": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}


def _mod(pkg: str, family: str):
    return importlib.import_module(f"{PKGS[pkg]}.filer.{WIRE[family][0]}")


def _server(pkg: str, family: str):
    return getattr(_mod(pkg, family), WIRE[family][2])().start()


def _client(pkg: str, family: str, server):
    return getattr(_mod(pkg, family), WIRE[family][1])(
        host="127.0.0.1", port=server.port)


# ---------------- the contract, every family of the port ----------------


@pytest.fixture(params=FAMILIES)
def store(request, tmp_path):
    kind = request.param
    server = None
    if kind == "sqlite":
        s = make_store(kind, path=str(tmp_path / "filer.db"))
    elif kind == "lsm":
        s = make_store(kind, path=str(tmp_path / "lsm"))
    elif kind in WIRE:
        server = _server("port", kind)
        s = make_store(kind, port=server.port)
    else:
        s = make_store(kind)
    yield s
    s.close()
    if server is not None:
        server.stop()


def test_registry_has_ten_families():
    assert len([k for k in STORES if k != "remote"]) >= 10
    assert sorted(STORES) == sorted(jfilerstore.STORES)


def test_insert_find_update_delete(store):
    e = Entry("/d/f.txt", Attr(mtime=1.0, file_size=5))
    store.insert_entry(e)
    got = store.find_entry("/d/f.txt")
    assert got is not None and got.attr.file_size == 5
    e2 = Entry("/d/f.txt", Attr(mtime=2.0, file_size=9))
    store.update_entry(e2)
    assert store.find_entry("/d/f.txt").attr.file_size == 9
    store.delete_entry("/d/f.txt")
    assert store.find_entry("/d/f.txt") is None
    # deleting a missing entry is a no-op, not an error
    store.delete_entry("/d/f.txt")


def test_directory_listing_semantics(store):
    for name in ["b.txt", "a.txt", "c.txt", "ab.txt"]:
        store.insert_entry(Entry(f"/dir/{name}"))
    store.insert_entry(Entry("/dir/sub", Attr(is_directory=True)))
    store.insert_entry(Entry("/dir/sub/deep.txt"))
    store.insert_entry(Entry("/dirx/cousin.txt"))  # sibling prefix

    names = [e.name for e in store.list_directory_entries("/dir")]
    assert names == ["a.txt", "ab.txt", "b.txt", "c.txt", "sub"]
    # pagination: strictly-after vs include_start
    names = [e.name for e in
             store.list_directory_entries("/dir", start_name="ab.txt")]
    assert names == ["b.txt", "c.txt", "sub"]
    names = [e.name for e in
             store.list_directory_entries("/dir", start_name="ab.txt",
                                          include_start=True)]
    assert names == ["ab.txt", "b.txt", "c.txt", "sub"]
    # prefix filter + limit
    names = [e.name for e in
             store.list_directory_entries("/dir", prefix="a")]
    assert names == ["a.txt", "ab.txt"]
    names = [e.name for e in
             store.list_directory_entries("/dir", limit=2)]
    assert names == ["a.txt", "ab.txt"]
    # prefix resuming from a start_name inside the prefix range
    names = [e.name for e in
             store.list_directory_entries("/dir", start_name="a.txt",
                                          prefix="a")]
    assert names == ["ab.txt"]


def test_delete_folder_children_recursive(store):
    store.insert_entry(Entry("/p", Attr(is_directory=True)))
    store.insert_entry(Entry("/p/x.txt"))
    store.insert_entry(Entry("/p/q", Attr(is_directory=True)))
    store.insert_entry(Entry("/p/q/deep.txt"))
    store.insert_entry(Entry("/pq/survivor.txt"))  # shares prefix
    store.delete_folder_children("/p")
    assert store.find_entry("/p/x.txt") is None
    assert store.find_entry("/p/q/deep.txt") is None
    assert store.find_entry("/p") is not None  # the dir itself stays
    assert store.find_entry("/pq/survivor.txt") is not None


def test_hostile_names_round_trip(store):
    # quoting/wildcard/escape hazards for SQL and key-range backends
    names = ["it's.txt", 'quo"te.txt', "100%.txt", "under_score.txt",
             "bang!.txt", "sp ace.txt", "uni-号.txt",
             # names shaped like qualified table references must not be
             # rewritten by any SQL/CQL translation layer
             "backup.kv", "from x.filemeta"]
    for n in names:
        store.insert_entry(Entry(f"/h/{n}", Attr(file_size=1)))
    listed = sorted(e.name for e in store.list_directory_entries("/h"))
    assert listed == sorted(names)
    for n in names:
        assert store.find_entry(f"/h/{n}") is not None
    # LIKE-wildcard names must not over-match as prefixes
    assert [e.name for e in
            store.list_directory_entries("/h", prefix="100%")] \
        == ["100%.txt"]
    assert [e.name for e in
            store.list_directory_entries("/h", prefix="under_")] \
        == ["under_score.txt"]


def test_kv_cells(store):
    assert store.kv_get(b"missing") is None
    store.kv_put(b"\x00bin\xffkey", b"\x00\x01\x02value")
    assert store.kv_get(b"\x00bin\xffkey") == b"\x00\x01\x02value"
    store.kv_put(b"\x00bin\xffkey", b"")  # empty value is a value
    assert store.kv_get(b"\x00bin\xffkey") == b""
    store.kv_delete(b"\x00bin\xffkey")
    assert store.kv_get(b"\x00bin\xffkey") is None


def test_root_listing_and_entry(store):
    store.insert_entry(Entry("/", Attr(is_directory=True)))
    store.insert_entry(Entry("/top.txt"))
    store.insert_entry(Entry("/child", Attr(is_directory=True)))
    store.insert_entry(Entry("/child/in.txt"))
    names = [e.name for e in store.list_directory_entries("/")]
    assert names == ["child", "top.txt"]
    store.delete_folder_children("/")
    assert store.find_entry("/top.txt") is None
    assert store.find_entry("/child/in.txt") is None
    # the root entry itself survives a recursive clear
    assert store.find_entry("/") is not None


def test_sqlite_kv_blob_backcompat(tmp_path):
    # filer.db files that hold kv cells as raw BLOBs keep reading and
    # writing them that way
    import sqlite3
    path = str(tmp_path / "old.db")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE kv (k BLOB PRIMARY KEY, v BLOB)")
    conn.execute("INSERT INTO kv (k, v) VALUES (?, ?)",
                 (b"/etc/seaweedfs/filer.conf", b"\x01old-bytes"))
    conn.commit()
    conn.close()
    s = make_store("sqlite", path=path)
    assert s.kv_get(b"/etc/seaweedfs/filer.conf") == b"\x01old-bytes"
    s.kv_put(b"new", b"\x00\xffv")
    assert s.kv_get(b"new") == b"\x00\xffv"
    s.close()


# ---------------- the redis store on its own ----------------


@pytest.fixture
def redis():
    srv = MiniRedisServer().start()
    yield srv
    srv.stop()


def test_resp_client_protocol(redis):
    c = RespClient(redis.host, redis.port)
    assert c.command("PING") == "PONG"
    assert c.command("SET", "k1", b"\x00binary\r\nsafe") == "OK"
    assert c.command("GET", "k1") == b"\x00binary\r\nsafe"
    assert c.command("GET", "nope") is None
    assert c.command("DEL", "k1") == 1
    assert c.command("ZADD", "z", 0, "alpha") == 1
    c.command("ZADD", "z", 0, "beta")
    c.command("ZADD", "z", 0, "gamma")
    assert c.command("ZRANGEBYLEX", "z", "-", "+") == \
        [b"alpha", b"beta", b"gamma"]
    assert c.command("ZRANGEBYLEX", "z", "(alpha", "+") == \
        [b"beta", b"gamma"]
    assert c.command("ZRANGEBYLEX", "z", "[beta", "[beta") == [b"beta"]
    assert c.command("ZREM", "z", "beta") == 1
    with pytest.raises(RuntimeError):
        c.command("NOSUCH")
    c.close()


def test_redis_store_contract(redis):
    """The contract the embedded stores pass, over the wire."""
    s = make_store("redis", host=redis.host, port=redis.port)
    assert isinstance(s, RedisFilerStore)
    e = Entry("/a/b/file.txt", Attr(mtime=1.0, file_size=5))
    s.insert_entry(e)
    got = s.find_entry("/a/b/file.txt")
    assert got is not None and got.attr.file_size == 5

    s.insert_entry(Entry("/a/b/other.txt"))
    s.insert_entry(Entry("/a/b/sub", Attr(is_directory=True)))
    s.insert_entry(Entry("/a/b/sub/deep.txt"))
    names = [x.name for x in s.list_directory_entries("/a/b")]
    assert names == ["file.txt", "other.txt", "sub"]
    names = [x.name for x in s.list_directory_entries("/a/b", prefix="o")]
    assert names == ["other.txt"]
    names = [x.name for x in s.list_directory_entries(
        "/a/b", start_name="file.txt")]
    assert names == ["other.txt", "sub"]
    names = [x.name for x in s.list_directory_entries(
        "/a/b", start_name="file.txt", include_start=True)]
    assert names == ["file.txt", "other.txt", "sub"]

    s.delete_folder_children("/a/b")
    assert s.list_directory_entries("/a/b") == []
    # recursive: the nested child went too
    assert s.find_entry("/a/b/sub/deep.txt") is None

    s.kv_put(b"conf", b"xyz")
    assert s.kv_get(b"conf") == b"xyz"
    assert s.kv_get(b"missing") is None
    s.kv_delete(b"conf")
    assert s.kv_get(b"conf") is None
    s.close()


def test_filer_server_on_redis_store(redis, tmp_path):
    """A full filer (HTTP plane + chunking) with redis metadata: write,
    list, read, rename, delete — and the metadata actually lives in the
    redis server (a second store sees it)."""
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, device="cpu")
    vs.start()
    fs = FilerServer(master.url, store="redis",
                     store_dir=f"{redis.host}:{redis.port}")
    fs.start()
    time.sleep(0.1)
    try:
        payload = b"stored through redis metadata" * 300
        status, _, _ = http_call("POST", f"http://{fs.url}/dir/doc.bin",
                                 body=payload)
        assert status < 300
        status, body, _ = http_call("GET", f"http://{fs.url}/dir/doc.bin")
        assert status == 200 and body == payload

        # independent client sees the same metadata over the wire
        other = RedisFilerStore(redis.host, redis.port)
        e = other.find_entry("/dir/doc.bin")
        assert e is not None and e.file_size() == len(payload)
        assert e.chunks  # chunked through the volume layer
        other.close()

        status, _, _ = http_call(
            "POST", f"http://{fs.url}/__api/rename",
            json_body={"from": "/dir/doc.bin", "to": "/dir/doc2.bin"})
        assert status == 200
        status, body, _ = http_call("GET",
                                    f"http://{fs.url}/dir/doc2.bin")
        assert status == 200 and body == payload
        status, _, _ = http_call("DELETE", f"http://{fs.url}/dir/doc2.bin")
        assert status < 300
        status, _, _ = http_call("GET", f"http://{fs.url}/dir/doc2.bin")
        assert status == 404
    finally:
        fs.stop()
        vs.stop()
        master.stop()


# ---------------- cross-package: the six wire families ----------------

NAMES = ["a.txt", "ab.txt", "b.bin", "it's.txt", 'quo"te', "100%.txt",
         "under_score", "sp ace", "uni-号", "backup.kv", "from x.filemeta",
         "z"]


def _script(seed: int) -> list:
    """A seeded list of store operations: inserts and updates of entries
    with chunks, attributes, extended attributes and inline content;
    finds, deletes, listings with start / prefix / limit, recursive
    folder deletes and kv cells."""
    rng = np.random.default_rng(seed)
    dirs = ["/", "/d", "/d/e", "/dx", "/h"]
    ops = []
    for i in range(80):
        d = dirs[int(rng.integers(len(dirs)))]
        name = NAMES[int(rng.integers(len(NAMES)))]
        path = (d.rstrip("/") + "/" + name)
        r = int(rng.integers(100))
        if r < 40:
            n_chunks = int(rng.integers(0, 3))
            ops.append(("insert" if r < 30 else "update", {
                "full_path": path,
                "attr": {"mtime": float(rng.integers(1 << 30)),
                         "crtime": float(rng.integers(1 << 30)),
                         "mode": int(rng.integers(0o777)),
                         "mime": ["", "text/plain"][int(rng.integers(2))],
                         "file_size": int(rng.integers(1 << 20)),
                         "is_directory": bool(r % 7 == 0),
                         "collection": ["", "stores"][int(rng.integers(2))],
                         "ttl_sec": int(rng.integers(3))},
                "chunks": [{"fid": f"{int(rng.integers(1, 9))},"
                                   f"{int(rng.integers(1 << 20)):x}"
                                   f"{int(rng.integers(1 << 16)):08x}",
                            "offset": c << 16, "size": 1 << 16,
                            "mtime_ns": int(rng.integers(1 << 40)),
                            "etag": f"{int(rng.integers(1 << 31)):x}"}
                           for c in range(n_chunks)],
                "extended": {"k": f"v{i}"} if r % 5 == 0 else {},
                "content": (b"inline-%d" % i) if n_chunks == 0 else b""}))
        elif r < 55:
            ops.append(("find", path))
        elif r < 62:
            ops.append(("delete", path))
        elif r < 82:
            ops.append(("list", d, {
                "start_name": ["", NAMES[int(rng.integers(len(NAMES)))]][
                    int(rng.integers(2))],
                "include_start": bool(rng.integers(2)),
                "limit": [1000, 3][int(rng.integers(2))],
                "prefix": ["", "a", "10", "under_", "u"][
                    int(rng.integers(5))]}))
        elif r < 85:
            ops.append(("delete_folder_children",
                        ["/d/e", "/dx", "/h"][int(rng.integers(3))]))
        else:
            key = b"\x00k%d\xff" % int(rng.integers(6))
            kind = ["kv_put", "kv_get", "kv_delete"][int(rng.integers(3))]
            ops.append((kind, key, bytes(rng.integers(
                0, 256, int(rng.integers(0, 40)), dtype=np.uint8))))
    for d in dirs:
        ops.append(("list", d, {}))
    return ops


def _entry(pkg: str, d: dict):
    emod = jentry if pkg == "jax" else importlib.import_module(
        "seaweedfs_tpu_torch.filer.entry")
    d = dict(d)
    content = d.pop("content")
    e = emod.Entry.from_dict(d)
    e.content = content
    return e


def _enc(e) -> object:
    return None if e is None else (e.to_dict(), e.content)


def _run(pkg: str, store, ops) -> list:
    out = []
    for op in ops:
        kind = op[0]
        if kind in ("insert", "update"):
            getattr(store, kind + "_entry")(_entry(pkg, op[1]))
            out.append(None)
        elif kind == "find":
            out.append(_enc(store.find_entry(op[1])))
        elif kind == "delete":
            out.append(store.delete_entry(op[1]))
        elif kind == "list":
            out.append([_enc(e) for e in
                        store.list_directory_entries(op[1], **op[2])])
        elif kind == "delete_folder_children":
            out.append(store.delete_folder_children(op[1]))
        elif kind == "kv_put":
            out.append(store.kv_put(op[1], op[2]))
        elif kind == "kv_get":
            out.append(store.kv_get(op[1]))
        else:
            out.append(store.kv_delete(op[1]))
    return out


def _run_pair(server_pkg, client_pkg, family, ops):
    srv = _server(server_pkg, family)
    try:
        s = _client(client_pkg, family, srv)
        try:
            return _run(client_pkg, s, ops)
        finally:
            s.close()
    finally:
        srv.stop()


@functools.lru_cache(maxsize=None)
def _reference(family: str, seed: int) -> list:
    """What the JAX client gives against the JAX mini server."""
    return _run_pair("jax", "jax", family, _script(seed))


@pytest.mark.parametrize("family", SIX)
def test_same_script_same_results_in_both_packages(family):
    """One seeded script through the JAX store on the JAX mini server and
    through the port's store on the port's: every find, listing and kv
    read is equal, entry by entry."""
    want = _reference(family, 13)
    assert _run_pair("port", "port", family, _script(13)) == want
    assert any(isinstance(r, list) and r for r in want)  # listings hit


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("family", SIX)
def test_wire_works_both_ways(family, server_pkg, client_pkg):
    """The port's client against the JAX package's mini server, and the
    JAX client against the port's, give what the JAX client gives
    against the JAX server."""
    assert _run_pair(server_pkg, client_pkg, family, _script(13)) == \
        _reference(family, 13)


@pytest.mark.parametrize("family", ["mysql", "postgres"])
def test_sql_mini_servers_answer_without_the_delayed_ack(family):
    """The port's MiniMysqlServer and MiniPostgresServer set TCP_NODELAY
    on each connection: a reply of several writes (a result set) no
    longer waits out the client's delayed ACK, about 40 ms a query on
    Linux, which the reference's servers pay on every SELECT."""
    srv = _server("port", family)
    try:
        s = _client("port", family, srv)
        try:
            s.insert_entry(Entry("/d/f", Attr(file_size=1)))
            took = []
            for _ in range(21):
                t0 = time.perf_counter()
                assert s.find_entry("/d/f") is not None
                took.append(time.perf_counter() - t0)
        finally:
            s.close()
    finally:
        srv.stop()
    assert statistics.median(took) < 0.02, took


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
@pytest.mark.parametrize("family", SIX)
def test_entries_written_by_one_package_read_back_in_the_other(
        family, writer, reader):
    ops = [op for op in _script(41) if op[0] in ("insert", "kv_put")]
    srv = _server(writer, family)
    try:
        w = _client(writer, family, srv)
        _run(writer, w, ops)
        r = _client(reader, family, srv)
        try:
            for d in ("/", "/d", "/d/e", "/dx", "/h"):
                listed = [_enc(e) for e in w.list_directory_entries(d)]
                assert [_enc(e) for e in r.list_directory_entries(d)] \
                    == listed
                for e in w.list_directory_entries(d):
                    assert _enc(r.find_entry(e.full_path)) == _enc(e)
            for op in ops:
                if op[0] == "kv_put":
                    assert r.kv_get(op[1]) == w.kv_get(op[1])
        finally:
            r.close()
            w.close()
    finally:
        srv.stop()


# ---------------- a port filer on each wire family ----------------


@pytest.fixture(scope="module")
def cpu_cluster(tmp_path_factory):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path_factory.mktemp("v"))], master.url,
                      device="cpu")
    vs.start()
    yield master
    vs.stop()
    master.stop()


@pytest.mark.parametrize("family", sorted(WIRE))
def test_filer_on_wire_store_writes_restarts_and_lists(family, cpu_cluster):
    """`FilerServer(store=<family>, store_dir="host:port")`: files written
    through it read back, and a new filer on the same database lists and
    serves them."""
    srv = _server("port", family)
    addr = f"127.0.0.1:{srv.port}"
    files = {f"/w/{d}/f{i}.bin": bytes([i]) * (1000 * (i + 1))
             for d in ("a", "b") for i in range(3)}
    try:
        fs = FilerServer(cpu_cluster.url, store=family, store_dir=addr)
        fs.start()
        try:
            assert type(fs.filer.store.inner).__name__ == WIRE[family][1]
            for path, body in files.items():
                status, _, _ = http_call("POST", f"http://{fs.url}{path}",
                                         body=body)
                assert status < 300
        finally:
            fs.stop()
        fs = FilerServer(cpu_cluster.url, store=family, store_dir=addr)
        fs.start()
        try:
            for d in ("a", "b"):
                status, out, _ = http_call(
                    "GET", f"http://{fs.url}/w/{d}/",
                    headers={"Accept": "application/json"})
                assert status == 200
                names = [e["FullPath"] for e in json.loads(out)["Entries"]]
                assert names == sorted(p for p in files
                                       if p.startswith(f"/w/{d}/"))
            for path, body in files.items():
                status, got, _ = http_call("GET", f"http://{fs.url}{path}")
                assert status == 200 and got == body
        finally:
            fs.stop()
    finally:
        srv.stop()
