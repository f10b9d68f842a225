"""The port's etcd filer store (filer/etcd_store.py: etcdserverpb.KV
Range / Put / DeleteRange spoken directly over gRPC, and its in-process
MiniEtcdServer) held against the JAX package's: the same wire answers,
either package's client against either package's server, the same keys
and values on the server for the same store script, and a port filer
on etcd whose entries a JAX store reads back over the wire.
(ref tests/test_etcd_store.py.)"""

import time

import numpy as np
import pytest

from seaweedfs_tpu.filer import etcd_store as jetcd
from seaweedfs_tpu.filer.entry import Attr as JAttr
from seaweedfs_tpu.filer.entry import Entry as JEntry
from seaweedfs_tpu.filer.filerstore import make_store as jmake_store
from seaweedfs_tpu_torch.filer import etcd_store as tetcd
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.filer.filerstore import make_store
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils.httpd import http_call

PKGS = {"port": (tetcd, Entry, Attr, make_store),
        "jax": (jetcd, JEntry, JAttr, jmake_store)}


@pytest.fixture
def etcd():
    srv = tetcd.MiniEtcdServer().start()
    yield srv
    srv.stop()


def _wire_script(client) -> list:
    out = []
    for k, v in ((b"/k1", b"v1"), (b"/k2", b"v2"), (b"/k3", b"v3")):
        client.put(k, v)
    out.append(client.range(b"/k1"))
    out.append(client.range(b"/nope"))
    out.append(client.range(b"/k1", b"/k3"))
    out.append(client.range(b"/k1", b"/k9", limit=2))
    out.append(client.delete_range(b"/k1", b"/k3"))
    out.append(client.range(b"/k1", b"/k9"))
    return out


WANT_WIRE = [[(b"/k1", b"v1")], [], [(b"/k1", b"v1"), (b"/k2", b"v2")],
             [(b"/k1", b"v1"), (b"/k2", b"v2")], 2, [(b"/k3", b"v3")]]


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_kv_wire_protocol(client_pkg, server_pkg):
    srv = PKGS[server_pkg][0].MiniEtcdServer().start()
    try:
        c = PKGS[client_pkg][0].EtcdClient(f"127.0.0.1:{srv.port}",
                                           timeout=10.0)
        try:
            assert _wire_script(c) == WANT_WIRE
        finally:
            c.close()
    finally:
        srv.stop()


def _store_script(pkg: str, port: int) -> list:
    """The ref's store contract, recorded: what each call returned."""
    _, E, A, mk = PKGS[pkg]
    s = mk("etcd", host="127.0.0.1", port=port)
    out = []
    try:
        s.insert_entry(E("/a/b/file.txt", A(mtime=1.0, crtime=1.0,
                                           file_size=5)))
        got = s.find_entry("/a/b/file.txt")
        out.append(got.to_dict())
        for path, attr in (("/a/b/other.txt", A(mtime=2.0, crtime=2.0)),
                           ("/a/b/sub", A(mtime=3.0, crtime=3.0,
                                          is_directory=True)),
                           ("/a/b/sub/deep.txt", A(mtime=4.0, crtime=4.0)),
                           ("/a/bb/cousin.txt", A(mtime=5.0, crtime=5.0))):
            s.insert_entry(E(path, attr))

        def names(**kw):
            return [x.name for x in s.list_directory_entries("/a/b", **kw)]
        out += [names(), names(prefix="o"), names(start_name="file.txt"),
                names(start_name="file.txt", include_start=True),
                names(limit=2)]
        s.delete_folder_children("/a/b")
        out += [names(), s.find_entry("/a/b/sub/deep.txt"),
                s.find_entry("/a/bb/cousin.txt").to_dict()]
        s.kv_put(b"conf", b"xyz")
        out.append(s.kv_get(b"conf"))
        out.append(s.kv_get(b"missing"))
        s.kv_delete(b"conf")
        out.append(s.kv_get(b"conf"))
    finally:
        s.close()
    return out


def test_etcd_store_contract(etcd):
    """The ref's contract on the port's store; the same script on the JAX
    store against the JAX server returns the same, and leaves the same
    keys and values on it."""
    got = _store_script("port", etcd.port)
    assert isinstance(make_store("etcd", host="127.0.0.1", port=etcd.port),
                      tetcd.EtcdFilerStore)
    assert got[1:6] == [["file.txt", "other.txt", "sub"], ["other.txt"],
                        ["other.txt", "sub"],
                        ["file.txt", "other.txt", "sub"],
                        ["file.txt", "other.txt"]]
    assert got[6:8] == [[], None]
    assert got[-3:] == [b"xyz", None, None]
    jsrv = jetcd.MiniEtcdServer().start()
    try:
        assert _store_script("jax", jsrv.port) == got
        assert jsrv._kv == etcd._kv and jsrv._keys == etcd._keys
    finally:
        jsrv.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_store_scripts_leave_equal_keyspaces(seed):
    """Seeded inserts, overwrites and deletes through the port's store on
    the JAX server and through the JAX store on the port's server: equal
    keyspaces, equal listings."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(120):
        d = f"/d{int(rng.integers(0, 4))}"
        name = f"f{int(rng.integers(0, 30)):02d}"
        ops.append((["ins", "ins", "del"][int(rng.integers(0, 3))],
                    f"{d}/{name}", int(rng.integers(0, 1 << 20))))
    servers = {"jax": jetcd.MiniEtcdServer().start(),
               "port": tetcd.MiniEtcdServer().start()}
    try:
        listings = {}
        for store_pkg, server_pkg in (("port", "jax"), ("jax", "port")):
            _, E, A, mk = PKGS[store_pkg]
            s = mk("etcd", host="127.0.0.1", port=servers[server_pkg].port)
            try:
                for op, path, size in ops:
                    if op == "ins":
                        s.insert_entry(E(path, A(mtime=float(size),
                                                 crtime=1.0,
                                                 file_size=size)))
                    else:
                        s.delete_entry(path)
                listings[store_pkg] = [
                    [(e.name, e.attr.file_size)
                     for e in s.list_directory_entries(f"/d{i}",
                                                       limit=1 << 20)]
                    for i in range(4)]
            finally:
                s.close()
        assert listings["port"] == listings["jax"]
        assert servers["jax"]._kv == servers["port"]._kv
    finally:
        for srv in servers.values():
            srv.stop()


def test_filer_server_on_etcd_store(etcd, tmp_path):
    """A port filer (HTTP plane + chunking) with etcd metadata; a JAX etcd
    store reads the same entries over the wire."""
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, device="cpu")
    vs.start()
    fs = FilerServer(master.url, store="etcd",
                     store_dir=f"127.0.0.1:{etcd.port}")
    fs.start()
    time.sleep(0.1)
    try:
        payload = b"stored through etcd metadata" * 300
        status, _, _ = http_call("POST", f"http://{fs.url}/dir/doc.bin",
                                 body=payload)
        assert status < 300
        status, body, _ = http_call("GET", f"http://{fs.url}/dir/doc.bin")
        assert status == 200 and body == payload

        other = jetcd.EtcdFilerStore("127.0.0.1", etcd.port)
        e = other.find_entry("/dir/doc.bin")
        assert e is not None and e.file_size() == len(payload)
        assert e.chunks
        assert e.to_dict() == fs.filer.find_entry("/dir/doc.bin").to_dict()
        other.close()

        status, _, _ = http_call(
            "POST", f"http://{fs.url}/__api/rename",
            json_body={"from": "/dir/doc.bin", "to": "/dir/doc2.bin"})
        assert status == 200
        status, body, _ = http_call("GET",
                                    f"http://{fs.url}/dir/doc2.bin")
        assert status == 200 and body == payload
        status, _, _ = http_call("DELETE",
                                 f"http://{fs.url}/dir/doc2.bin")
        assert status < 300
        status, _, _ = http_call("GET", f"http://{fs.url}/dir/doc2.bin")
        assert status == 404
    finally:
        fs.stop()
        vs.stop()
        master.stop()


def test_mesh_mtls_does_not_leak_onto_etcd_channel(etcd, tmp_path,
                                                   monkeypatch):
    """etcd is an external system: the cluster's [grpc] mesh certs must
    not be presented to it. Only a dedicated [grpc.etcd] section opts
    in."""
    from seaweedfs_tpu_torch.utils import config as _cfg
    (tmp_path / "security.toml").write_text(
        '[grpc]\nca = "/no/ca.pem"\ncert = "/no/c.pem"\n'
        'key = "/no/k.pem"\n')
    monkeypatch.setattr(_cfg, "SEARCH_PATHS", [str(tmp_path)])
    c = tetcd.EtcdClient(f"127.0.0.1:{etcd.port}")  # reads no cert
    try:
        c.put(b"/x", b"1")
        assert c.range(b"/x") == [(b"/x", b"1")]
    finally:
        c.close()


def test_large_directory_pagination(etcd):
    """Listing pages through the range API in batches (the client asks
    for at most 1024 keys per Range)."""
    s = make_store("etcd", host="127.0.0.1", port=etcd.port)
    try:
        for i in range(1500):
            s.insert_entry(Entry(f"/big/f{i:05d}"))
        names = [x.name for x in s.list_directory_entries("/big",
                                                          limit=1 << 20)]
        assert len(names) == 1500
        assert names == sorted(names)
        page = [x.name for x in s.list_directory_entries(
            "/big", start_name="f01000", limit=10)]
        assert page == [f"f{i:05d}" for i in range(1001, 1011)]
    finally:
        s.close()
