"""The port's filer server held against the JAX package's over HTTP.

Each stack is a master, two volume servers on racks r0 / r1 and a filer on
the lsm store (the port's volume servers with device="cpu"); the packages
meet only over sockets and files. One seeded script runs through each
stack: small, inline, single-chunk and multi-chunk writes, streaming and
buffered ingest of one body, GETs following and not following the 302 to
a volume server, Range GETs on both read routes, listings and entry
metadata, rename (file and directory), hard links, fs.configure's
collection, TTL and readOnly, delete with chunk GC, the meta event log,
manifests (MANIFEST_BATCH patched small), a cipher filer whose volume
servers hold only ciphertext, and a restart of the filer from its lsm
directory. Held equal: listings, each entry's size, mime, md5, chunk
offsets and sizes (not fids or times), every body, the status codes and
the 302 decisions. Also here: the metadata aggregator between two filers
(port + port, and port + JAX on one master), the shell's fs.* family and
volume.fsck through the REPL, and a wire store whose database does not
answer failing before the filer binds a socket.
(ref tests/test_filer.py, test_filer_depth.py, test_shell_fs.py,
test_meta_aggregator.py, test_streaming_ingest.py, the filer parts of
test_write_path.py, test_zero_copy.py and test_cipher_ftp.py.)
"""

import hashlib
import socket
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.server import filer_server as jfiler_server
from seaweedfs_tpu.server.master import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.utils import httpd as jhttpd
from seaweedfs_tpu_torch.server import filer_server
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import ShellContext
from seaweedfs_tpu_torch.shell.repl import run_command
from seaweedfs_tpu_torch.utils import httpd


def _port_vs(dirs, master_url, **kw):
    return VolumeServer(dirs, master_url, device="cpu", **kw)


PORT = types.SimpleNamespace(Master=MasterServer, VS=_port_vs,
                             fmod=filer_server, http=httpd)
JAX = types.SimpleNamespace(Master=JMasterServer, VS=JVolumeServer,
                            fmod=jfiler_server, http=jhttpd)
MB = 1 << 20


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return sorted(s.getsockname()[1] for s in socks)
    finally:
        for s in socks:
            s.close()


def _wait(cond, what, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _norm_entry(d):
    """An entry dict without what differs from run to run: fids, times,
    cipher keys, link ids."""
    d = dict(d)
    attr = dict(d["attr"])
    for k in ("mtime", "crtime"):
        attr.pop(k, None)
    d["attr"] = attr
    d.pop("hard_link_id", None)
    d["chunks"] = [{k: v for k, v in c.items()
                    if k not in ("fid", "mtime_ns", "cipher_key")}
                   | {"encrypted": bool(c.get("cipher_key"))}
                   for c in d["chunks"]]
    return d


def _norm_listing(out):
    return [{k: v for k, v in e.items()
             if k not in ("Mtime", "Crtime", "chunks")}
            | {"chunks": [(c["offset"], c["size"]) for c in e["chunks"]]}
            for e in out["Entries"]]


class _Stack:
    """A master, two volume servers and a filer of one package."""

    def __init__(self, pkg, root, **filer_kw):
        self.pkg, self.root = pkg, root
        self.master = pkg.Master(volume_size_limit_mb=64)
        self.master.start()
        self.servers = []
        for i, port in enumerate(_free_ports(2)):
            vs = pkg.VS([str(root / f"v{i}")], self.master.url, port=port,
                        rack=f"r{i}", data_center="dc1")
            vs.start()
            self.servers.append(vs)
        self.filer = None
        self.start_filer(**filer_kw)

    def start_filer(self, **kw):
        kw = {"store": "lsm", "store_dir": str(self.root / "filer"), **kw}
        self.filer = self.pkg.fmod.FilerServer(self.master.url, **kw)
        self.filer.start()
        self.base = f"http://{self.filer.url}"
        _wait(lambda: self.call("GET", "/")[0] == 200, "the filer")

    def call(self, method, path, **kw):
        return self.pkg.http.http_call(method, self.base + path, **kw)

    def json(self, method, path, body=None):
        return self.pkg.http.http_json(method, self.base + path, body)

    def entry(self, path):
        return self.json("GET", f"/__api/entry?path={path}")["entry"]

    def volume_urls(self):
        return [vs.url for vs in self.servers]

    def stop(self):
        for srv in [self.filer, *self.servers, self.master]:
            if srv is not None:
                srv.stop()


def _script(pkg, root):
    """The seeded filer script; what a client sees, run-independent."""
    st = _Stack(pkg, root)
    obs = {}
    try:
        files = {"/t/tiny.txt": b"tiny content",
                 "/t/small.bin": _payload(64 * 1024, 1),
                 "/t/one.bin": _payload(3 * MB, 2),
                 "/t/big.bin": _payload(9_000_000, 3),
                 "/t/d/e/deep.bin": _payload(300_000, 4),
                 "/t/edge.bin": _payload(2 * 4 * MB, 5)}
        obs["writes"] = [
            st.call("POST", p, body=b,
                    headers={"Content-Type": "text/plain"}
                    if p.endswith(".txt") else None)[0]
            for p, b in files.items()]
        # streaming and buffered ingest of one body: the same chunk grid
        body = _payload(5 * MB + 17, 6)
        st.call("PUT", "/s/stream.bin", body=body)
        st.filer.streaming_ingest = False
        st.call("PUT", "/s/buffered.bin", body=body)
        st.filer.streaming_ingest = True
        files["/s/stream.bin"] = files["/s/buffered.bin"] = body
        obs["stream_vs_buffered"] = (
            _norm_entry(st.entry("/s/stream.bin"))["chunks"] ==
            _norm_entry(st.entry("/s/buffered.bin"))["chunks"])
        obs["bodies"] = {p: hashlib.sha256(st.call("GET", p)[1]).hexdigest()
                         for p in files}
        obs["bodies_ok"] = all(
            st.call("GET", p)[1] == b for p, b in files.items())
        # the 302 decision: whether, and to how many of the volume
        # servers (which one holds the chunk is the master's draw)
        decisions = {}
        for p in files:
            status, body_, h = st.call("GET", p, follow_redirects=False)
            loc = h.get("Location", "")
            decisions[p] = (status, sum(u in loc for u in st.volume_urls())
                            if status == 302 else None, len(body_))
        obs["redirects"] = decisions
        obs["proxied"] = all(
            st.call("GET", p + "?proxy=1")[1] == b for p, b in files.items())
        ranges = {}
        for p in ("/t/one.bin", "/t/big.bin", "/t/tiny.txt"):
            data = files[p]
            for spec in ("bytes=100-999", "bytes=-4096",
                         f"bytes={len(data) - 5}-", "bytes=4000000-8500000",
                         "bytes=99999999-"):
                status, piece, h = st.call("GET", p,
                                           headers={"Range": spec})
                ranges[(p, spec)] = (status, hashlib.sha256(piece)
                                     .hexdigest(), h.get("Content-Range"))
        obs["ranges"] = ranges
        obs["listing_t"] = _norm_listing(st.json("GET", "/t"))
        obs["listing_s"] = _norm_listing(st.json("GET", "/s"))
        obs["paged"] = [e["FullPath"] for e in st.json(
            "GET", "/t?limit=2&lastFileName=big.bin")["Entries"]]
        obs["entries"] = {p: _norm_entry(st.entry(p)) for p in files}
        # rename: a file, then a directory with children
        obs["rename"] = [
            st.json("POST", "/__api/rename",
                    {"from": "/t/small.bin", "to": "/u/small2.bin"}),
            st.json("POST", "/__api/rename", {"from": "/t/d", "to": "/u/d"}),
            st.call("GET", "/t/small.bin")[0],
            st.call("GET", "/u/small2.bin")[1] == files["/t/small.bin"],
            st.call("GET", "/u/d/e/deep.bin")[1] == files["/t/d/e/deep.bin"]]
        # hard links share data until the last name goes
        link = st.json("POST", "/__api/hardlink",
                       {"from": "/t/one.bin", "to": "/h/link.bin"})
        st.call("DELETE", "/t/one.bin")
        obs["hardlink"] = (link["path"], bool(link["hard_link_id"]),
                           st.call("GET", "/h/link.bin")[1]
                           == files["/t/one.bin"],
                           st.call("GET", "/t/one.bin")[0])
        # fs.configure: collection + TTL under a prefix, then readOnly
        st.json("POST", "/__api/filer_conf",
                {"location_prefix": "/cfg/", "collection": "coll_a",
                 "ttl": "3d"})
        st.call("POST", "/cfg/x.bin", body=_payload(70_000, 7))
        e = st.entry("/cfg/x.bin")
        vid = int(e["chunks"][0]["fid"].split(",")[0])
        vols = [v for vs in st.servers
                for v in pkg.http.http_json(
                    "GET", f"http://{vs.url}/status")["volumes"]
                if v["id"] == vid]
        obs["configure"] = (e["attr"]["collection"], e["attr"]["ttl_sec"],
                            sorted({v["collection"] for v in vols}))
        st.json("POST", "/__api/filer_conf",
                {"location_prefix": "/cfg/", "read_only": True})
        obs["read_only"] = [
            st.call("POST", "/cfg/y.bin", body=b"no")[0],
            st.call("DELETE", "/cfg/x.bin")[0],
            st.call("POST", "/__api/rename",
                    body=b'{"from": "/cfg/x.bin", "to": "/z/x.bin"}')[0],
            st.call("GET", "/cfg/x.bin")[0]]
        st.json("POST", "/__api/filer_conf",
                {"location_prefix": "/cfg/", "delete": True})
        obs["conf"] = st.json("GET", "/__api/filer_conf")
        # delete: 204, then 404, and the chunks leave the volume servers
        big = st.entry("/t/big.bin")
        obs["delete"] = [st.call("DELETE", "/t/big.bin")[0],
                         st.call("GET", "/t/big.bin")[0],
                         st.call("DELETE", "/t?recursive=true")[0],
                         st.call("GET", "/t/tiny.txt")[0]]
        fid = big["chunks"][0]["fid"]
        _wait(lambda: all(pkg.http.http_call(
            "GET", f"http://{u}/{fid}")[0] == 404
            for u in st.volume_urls()), "chunk GC")
        # meta events: (directory, old path, new path), in order
        ev = st.json("GET", "/__api/meta_events?since_ns=0")["events"]
        obs["events"] = [(x["directory"],
                          (x["old_entry"] or {}).get("full_path"),
                          (x["new_entry"] or {}).get("full_path"))
                         for x in ev]
        # restart from the lsm directory: the namespace survives
        st.filer.stop()
        st.start_filer()
        obs["restart"] = (
            {d: _norm_listing(st.json("GET", d))
             for d in ("/", "/s", "/u", "/u/d/e", "/h", "/cfg")},
            st.call("GET", "/s/stream.bin")[1] == body,
            st.call("GET", "/h/link.bin")[1] == files["/t/one.bin"])
    finally:
        st.stop()
    return obs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {"port": _script(PORT, tmp_path_factory.mktemp("port")),
            "jax": _script(JAX, tmp_path_factory.mktemp("jax"))}


@pytest.mark.parametrize("key", [
    "writes", "stream_vs_buffered", "bodies", "bodies_ok", "redirects",
    "proxied", "ranges", "listing_t", "listing_s", "paged", "entries",
    "rename", "hardlink", "configure", "read_only", "conf", "delete",
    "events", "restart"])
def test_filer_script_matches_jax(runs, key):
    assert runs["port"][key] == runs["jax"][key]


def test_filer_script_outcomes(runs):
    """What the script must show on its own, beyond agreeing."""
    got = runs["port"]
    assert got["writes"] == [201] * 6
    assert got["stream_vs_buffered"] and got["bodies_ok"] and got["proxied"]
    r = got["redirects"]
    # inline and sub-256 KiB single chunks proxy; a 3 MiB single chunk
    # 302s to a volume server; multi-chunk files proxy
    assert r["/t/tiny.txt"][0] == 200 and r["/t/small.bin"][0] == 200
    assert r["/t/one.bin"][:2] == (302, 1)
    assert r["/t/big.bin"][0] == 200 and r["/t/edge.bin"][0] == 200
    ent = got["entries"]
    assert [(c["offset"], c["size"]) for c in ent["/t/big.bin"]["chunks"]] \
        == [(0, 4 * MB), (4 * MB, 4 * MB), (8 * MB, 9_000_000 - 8 * MB)]
    assert len(ent["/t/edge.bin"]["chunks"]) == 2
    assert ent["/t/tiny.txt"]["content"] and not ent["/t/tiny.txt"]["chunks"]
    assert ent["/t/tiny.txt"]["attr"]["mime"] == "text/plain"
    assert got["ranges"][("/t/big.bin", "bytes=99999999-")][0] == 416
    assert got["ranges"][("/t/big.bin", "bytes=4000000-8500000")][2] == \
        "bytes 4000000-8500000/9000000"
    assert got["rename"][2:] == [404, True, True]
    assert got["hardlink"][1:] == (True, True, 404)
    assert got["configure"] == ("coll_a", 3 * 86400, ["coll_a"])
    assert got["read_only"] == [403, 403, 403, 200]
    assert got["conf"] == {"locations": []}
    assert got["delete"] == [204, 404, 204, 404]
    assert got["restart"][1:] == (True, True)


# ---------------- manifests and cipher ----------------


def _manifest_and_cipher(pkg, root, monkeypatch):
    """A wide file collapsed into manifest chunks, and a cipher filer:
    bodies back, what the volume servers hold, fsck of the tree."""
    monkeypatch.setattr(pkg.fmod, "CHUNK_SIZE", 1024)
    monkeypatch.setattr(pkg.fmod, "INLINE_LIMIT", 16)
    orig = pkg.fmod.maybe_manifestize
    monkeypatch.setattr(pkg.fmod, "maybe_manifestize",
                        lambda save, chunks, batch=4: orig(save, chunks, 4))
    st = _Stack(pkg, root, cipher=True)
    try:
        data = bytes(range(256)) * 64  # 16 KiB: 16 chunks -> manifests
        st.call("POST", "/m/wide.bin", body=data)
        e = st.entry("/m/wide.bin")
        plain = _payload(3000, 8)  # 3 chunks: no manifest
        st.call("POST", "/c/secret.bin", body=plain)
        c = st.entry("/c/secret.bin")
        stored = [pkg.http.http_call(
            "GET", f"http://{u}/{ch['fid']}")[1]
            for ch in c["chunks"] for u in st.volume_urls()]
        stored = [b for b in stored if b and not b.startswith(b"{")]
        return (len(e["chunks"]) <= 4,
                any(ch.get("is_chunk_manifest") for ch in e["chunks"]),
                st.call("GET", "/m/wide.bin")[1] == data,
                st.call("GET", "/c/secret.bin")[1] == plain,
                all(ch.get("cipher_key") for ch in c["chunks"]),
                bool(stored) and all(plain[:64] not in b for b in stored),
                _norm_entry(c)["chunks"] == [
                    {"offset": i * 1024, "size": min(1024, 3000 - i * 1024),
                     "etag": ch["etag"], "is_compressed": False,
                     "encrypted": True}
                    for i, ch in enumerate(c["chunks"])])
    finally:
        st.stop()


def test_manifests_and_cipher_match_jax(tmp_path, monkeypatch):
    got = _manifest_and_cipher(PORT, tmp_path / "p", monkeypatch)
    assert got == _manifest_and_cipher(JAX, tmp_path / "j", monkeypatch)
    assert all(got)


# ---------------- the metadata aggregator ----------------


def _aggregated_paths(http, filer_url):
    out = http.http_json("GET", f"http://{filer_url}/__api/meta_events"
                                "?since_ns=0&aggregated=true")
    return out["events"]


@pytest.mark.parametrize("second", ["port", "jax"])
def test_meta_aggregator_between_two_filers(tmp_path, second):
    """Two filers on one port master each see the other's writes in their
    aggregated stream, each event naming its source; the local stream
    stays local. The second filer is the port's or the JAX package's."""
    st = _Stack(PORT, tmp_path, store="memory")
    other_mod = filer_server if second == "port" else jfiler_server
    f2 = other_mod.FilerServer(st.master.url)
    f2.start()
    f1 = st.filer
    try:
        _wait(lambda: f2.url in f1.meta_aggregator._followers
              and f1.url in f2.meta_aggregator._followers,
              "the filers to follow each other", timeout=20)
        httpd.http_call("POST", f"http://{f1.url}/a/on1.txt", body=b"one")
        httpd.http_call("POST", f"http://{f2.url}/a/on2.txt", body=b"two")
        want = {"/a/on1.txt", "/a/on2.txt"}
        for f in (f1, f2):
            ev = _wait(lambda: (lambda e: e if want <= {
                (x["new_entry"] or {}).get("full_path") for x in e}
                else None)(_aggregated_paths(httpd, f.url)),
                f"{f.url} to aggregate both writes", timeout=20)
            src = {x["source"] for x in ev
                   if (x["new_entry"] or {}).get("full_path") in want}
            assert src == {f1.url, f2.url}
        local = httpd.http_json(
            "GET", f"http://{f1.url}/__api/meta_events?since_ns=0")
        assert "/a/on2.txt" not in {(x["new_entry"] or {}).get("full_path")
                                    for x in local["events"]}
    finally:
        f2.stop()
        st.stop()


# ---------------- the shell's fs.* family ----------------


def test_repl_fs_commands_and_volume_fsck(tmp_path, capsys):
    """fs.configure / ls / cd / pwd / cat / du / tree / mkdir / mv / rm /
    meta.cat / meta.save / meta.load and volume.fsck through the port's
    REPL against its filer (ref tests/test_shell_fs.py)."""
    st = _Stack(PORT, tmp_path, store="memory")
    sh = ShellContext(st.master.url)
    try:
        _wait(lambda: httpd.http_json(
            "GET", f"http://{st.master.url}/cluster/nodes?type=filer")
            .get("cluster_nodes"), "the filer to register")
        assert run_command(sh, "fs.configure -locationPrefix /data "
                               "-collection fsc")["locations"][0][
            "collection"] == "fsc"
        st.call("POST", "/data/a/one.txt", body=b"hello")
        st.call("POST", "/data/a/two.bin", body=_payload(300_000, 9))
        assert run_command(sh, "fs.mkdir /data/empty") == {
            "created": "/data/empty"}
        assert sorted(e["FullPath"] for e in run_command(
            sh, "fs.ls /data")) == ["/data/a", "/data/empty"]
        assert run_command(sh, "fs.cd /data/a") == {"cwd": "/data/a"}
        assert run_command(sh, "fs.pwd") == {"cwd": "/data/a"}
        assert run_command(sh, "fs.cat one.txt") is None
        assert "hello" in capsys.readouterr().out
        assert run_command(sh, "fs.du /data") == {"files": 2,
                                                  "bytes": 300_005}
        run_command(sh, "fs.tree /data")
        assert "two.bin" in capsys.readouterr().out
        meta = run_command(sh, "fs.meta.cat /data/a/two.bin")
        assert meta["entry"]["attr"]["collection"] == "fsc"
        assert run_command(sh, "fs.mv one.txt /data/one.txt")["moved"] == [
            "/data/a/one.txt", "/data/one.txt"]
        dump = tmp_path / "meta.jsonl"
        assert run_command(sh, f"fs.meta.save -root /data -o {dump}")[
            "saved"] == 4
        fsck = run_command(sh, "volume.fsck")
        assert fsck["missing_count"] == 0 and fsck["orphan_count"] == 0
        assert fsck["entries_referencing"] == 1
        assert run_command(sh, "fs.rm -r /data/a") == {"removed": "/data/a"}
        assert run_command(sh, "fs.du /data") == {"files": 1, "bytes": 5}
        assert run_command(sh, f"fs.meta.load -i {dump}") == {"loaded": 4}
        assert run_command(sh, "fs.du /data")["files"] == 2
        assert run_command(sh, "fs.cd /") == {"cwd": "/"}
    finally:
        st.stop()


# ---------------- wire stores and the remote routes ----------------


@pytest.mark.parametrize("kw", [
    {"store": "redis"}, {"store": "mysql"}, {"store": "postgres"},
    {"store": "mongodb"}, {"store": "cassandra"}, {"store": "elastic"}])
def test_unported_filer_options_raise_before_binding(kw, monkeypatch):
    """Every store family is ported now. A wire store dials its database
    where it is made, so a filer whose database does not answer at
    store_dir raises before it binds a socket, as the reference's does
    (tests/test_torch_filer_stores.py runs them against their servers)."""
    bound = []
    monkeypatch.setattr(filer_server, "HttpServer",
                        lambda *a, **k: bound.append(a))
    dead = _free_ports(1)[0]  # closed again: nothing listens there
    with pytest.raises(OSError):
        filer_server.FilerServer("127.0.0.1:1", store_dir=f"127.0.0.1:{dead}",
                                 **kw)
    assert bound == []


def test_remote_routes_answer_501_for_cloud_clients(tmp_path):
    """/__api/remote/* work over a local remote, over an S3 remote (the
    port's own gateway on the same filer) and over an Azure remote (the
    port's MiniAzureServer, SharedKey-signed), which answered 501 until
    the Azure client was ported."""
    from seaweedfs_tpu_torch.gateway.s3_server import S3Server
    st = _Stack(PORT, tmp_path, store="memory")
    gw = S3Server(st.filer)
    gw.start()
    try:
        root = tmp_path / "remote"
        root.mkdir()
        (root / "f.txt").write_bytes(b"remote bytes")
        st.json("POST", "/__api/remote/configure",
                {"name": "loc", "type": "local", "root": str(root)})
        st.json("POST", "/__api/remote/mount",
                {"dir": "/rm", "remote_name": "loc"})
        assert st.json("POST", "/__api/remote/pull",
                       {"dir": "/rm"}) == {"pulled": 1}
        assert st.call("GET", "/rm/f.txt")[1] == b"remote bytes"
        for bucket, key, body in (("rb", "x/one.bin", b"1" * 3000),
                                  ("rb", "two.txt", b"two"),
                                  ("other", "o.txt", b"o")):
            httpd.http_call("PUT", f"http://{gw.url}/{bucket}")
            assert httpd.http_call("PUT", f"http://{gw.url}/{bucket}/{key}",
                                   body=body)[0] == 200
        st.json("POST", "/__api/remote/configure",
                {"name": "cloud", "type": "s3", "endpoint":
                 f"http://{gw.url}", "bucket": "rb"})
        st.json("POST", "/__api/remote/mount",
                {"dir": "/cm", "remote_name": "cloud"})
        assert st.json("POST", "/__api/remote/pull",
                       {"dir": "/cm"}) == {"pulled": 2}
        assert st.call("GET", "/cm/x/one.bin")[1] == b"1" * 3000
        out = st.json("POST", "/__api/remote/mount_buckets",
                      {"remote_name": "cloud"})
        assert sorted(out["mounted"]) == ["other", "rb"]
        import base64

        from seaweedfs_tpu_torch.remote_storage.azure_client import (
            AzureRemote, MiniAzureServer)
        key = base64.b64encode(b"blob-account-key").decode()
        az = MiniAzureServer(account="acct", key_b64=key).start()
        try:
            AzureRemote(az.url, "b", "acct", key).write_file(
                "dir/blob.bin", b"azure bytes")
            st.json("POST", "/__api/remote/configure",
                    {"name": "blob", "type": "azure", "endpoint": az.url,
                     "bucket": "b", "access_key": "acct",
                     "secret_key": key})
            st.json("POST", "/__api/remote/mount",
                    {"dir": "/am", "remote_name": "blob"})
            assert st.json("POST", "/__api/remote/pull",
                           {"dir": "/am"}) == {"pulled": 1}
            assert st.call("GET", "/am/dir/blob.bin")[1] == b"azure bytes"
        finally:
            az.stop()
    finally:
        gw.stop()
        st.stop()


# ---------------- the command line ----------------


class _CliStack:
    """Servers started through one package's cli.main, each handed back
    by a patched _serve_until_signal instead of blocking."""

    def __init__(self, cli, monkeypatch):
        self.cli, self.servers = cli, []
        monkeypatch.setattr(cli, "_serve_until_signal",
                            lambda *srv, ready="": self.servers.extend(srv))

    def start(self, *argv):
        n = len(self.servers)
        self.cli.main(list(argv))
        return self.servers[n:]

    def stop(self):
        for srv in self.servers:
            srv.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_cli_filer_copy_and_cat(pkg, tmp_path, monkeypatch, capsysbinary):
    """`weed master`, `weed volume`, `weed filer -store lsm`, `weed
    filer.copy` of a seeded tree and `weed filer.cat` of each file, through
    either package's command line; the port's servers run -device cpu.
    Both give the same copy report and listing."""
    from seaweedfs_tpu import cli as jcli
    from seaweedfs_tpu_torch import cli
    mod = cli if pkg == "port" else jcli
    st = _CliStack(mod, monkeypatch)
    mport, vport, fport = _free_ports(3)
    tree = tmp_path / "tree"
    files = {"a/x.bin": _payload(70_000, 1), "a/b/y.bin": _payload(5, 2),
             "z.bin": _payload(5 * MB, 3)}
    for rel, data in files.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_bytes(data)
    try:
        st.start("master", "-port", str(mport), "-volumeSizeLimitMB", "64")
        st.start("volume", "-port", str(vport), "-dir",
                 str(tmp_path / "v"), "-mserver", f"127.0.0.1:{mport}",
                 *(["-device", "cpu"] if pkg == "port" else []))
        (fs,) = st.start("filer", "-port", str(fport), "-master",
                         f"127.0.0.1:{mport}", "-store", "lsm", "-dir",
                         str(tmp_path / "f"))
        capsysbinary.readouterr()
        mod.main(["filer.copy", "-filer", fs.url, str(tree), "/dst/"])
        report = capsysbinary.readouterr().out
        cats = {}
        for rel in files:
            mod.main(["filer.cat", "-filer", fs.url, f"/dst/tree/{rel}"])
            cats[rel] = capsysbinary.readouterr().out
        assert cats == files
        with pytest.raises(SystemExit, match="HTTP 404"):
            mod.main(["filer.cat", "-filer", fs.url, "/dst/nope"])
        listing = httpd.http_json("GET", f"http://{fs.url}/dst/tree/a")
        assert report == b'{"copied": 3, "dest": "/dst/"}\n'
        assert [(e["FullPath"], e["FileSize"]) for e in
                listing["Entries"]] == [("/dst/tree/a/b", 0),
                                        ("/dst/tree/a/x.bin", 70_000)]
    finally:
        st.stop()


def test_cli_server_with_filer(tmp_path, monkeypatch):
    """`weed server -filer -device cpu`: a master, a volume server and a
    filer in one process; a file written through the filer reads back."""
    from seaweedfs_tpu_torch import cli
    st = _CliStack(cli, monkeypatch)
    mport, vport, fport = _free_ports(3)
    try:
        srv = st.start("server", "-device", "cpu", "-filer",
                       "-masterPort", str(mport), "-port", str(vport),
                       "-filerPort", str(fport), "-dir",
                       str(tmp_path / "d"))
        assert [type(s).__name__ for s in srv] == [
            "VolumeServer", "FilerServer", "MasterServer"]
        base = f"http://127.0.0.1:{fport}"
        data = _payload(300_000, 4)
        _wait(lambda: httpd.http_call("POST", f"{base}/s/f.bin",
                                      body=data)[0] == 201,
              "the filer to take a write")
        assert httpd.http_call("GET", f"{base}/s/f.bin")[1] == data
    finally:
        st.stop()


def _gc_counts(filer):
    """The filer's chunk_gc_total by outcome, from its /metrics."""
    import re
    status, body, _ = httpd.http_call(
        "GET", f"http://{filer.metrics_url}/metrics")
    assert status == 200
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r'filer_chunk_gc_total\{outcome="(\w+)"\} (\S+)', body.decode())}


@pytest.mark.parametrize("fails,want", [
    (0, {"deleted": 3.0}),
    (1, {"deleted": 3.0, "retried": 3.0}),
    (9, {"retried": 3.0, "abandoned": 3.0})])
def test_chunk_gc_counts_every_outcome(tmp_path, monkeypatch, fails,
                                       want):
    """A deleted file's chunks go through the GC queue: a delete that
    fails is retried with backoff, and one still failing after
    GC_ATTEMPTS is abandoned; /metrics counts each outcome, so a chunk
    left behind shows. Chunks deleted are gone from the volume server."""
    monkeypatch.setattr(filer_server, "CHUNK_SIZE", 64 * 1024)
    st = _Stack(PORT, tmp_path, store="memory")
    try:
        fs = st.filer
        fs.GC_ATTEMPTS = 2
        tries: dict = {}
        real = fs._delete_chunk

        def flaky(fid):
            tries[fid] = tries.get(fid, 0) + 1
            return tries[fid] > fails and real(fid)

        fs._delete_chunk = flaky
        body = _payload(3 * 64 * 1024, 7)
        assert st.call("PUT", "/gc/f.bin", body=body)[0] in (200, 201)
        fids = [c["fid"] for c in st.entry("/gc/f.bin")["chunks"]]
        assert len(fids) == 3
        assert st.call("DELETE", "/gc/f.bin")[0] in (200, 202, 204)
        _wait(lambda: _gc_counts(fs) == want, f"gc outcomes {want}")
        gone = [all(httpd.http_call("GET", f"http://{u}/{fid}")[0] == 404
                    for u in st.volume_urls()) for fid in fids]
        assert gone == [fails < 2] * 3
    finally:
        st.stop()
