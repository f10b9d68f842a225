"""The filer slice end to end at a small size, beside the same script on an
all-JAX stack: a master, four volume servers on racks r0 / r1 (the port's
with device="cpu", the plain version of K1) and a filer on the lsm store.

fs.configure puts /data in the collection filer_smoke; `weed filer.copy`
(through cli.main) copies a seeded tree of small, single-chunk (some past
the filer's 256 KiB redirect size) and multi-chunk files; volume.fsck is
clean; ec.encode turns every volume of the collection into 14 spread
shards; the server holding the most shards is stopped and pruned; the
filer restarts from its lsm directory (a cold chunk cache), and every file
is read back through it, following 302s, so that each read of a lost
interval is a degraded read on a live volume server: the calls to
rs_cuda.gf_apply are counted and equal the live servers' reconstructs.
Then ec.rebuild, fs.du against the tree, volume.fsck, fs.rm -r of one
directory and volume.fsck again. The two stacks must show the same
listing, sizes, bodies, du and fsck counts. (ref tests/test_shell_fs.py,
tests/test_shell_ec.py; the chip_smoke.py phase `filer` at full size.)
"""

import hashlib
import os
import socket
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu import cli as jcli
from seaweedfs_tpu.cluster import topology as jtopology
from seaweedfs_tpu.server import volume_server as jvolume_server
from seaweedfs_tpu.storage import disk_location as jdisk_location
from seaweedfs_tpu.storage.erasure_coding import ec_volume as jec_volume
from seaweedfs_tpu.server import filer_server as jfiler_server
from seaweedfs_tpu.server.master import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.shell import repl as jrepl
from seaweedfs_tpu.shell.commands import ShellContext as JShellContext
from seaweedfs_tpu.utils import httpd as jhttpd
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.cluster import topology
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.server import filer_server
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import repl
from seaweedfs_tpu_torch.shell.commands import ShellContext
from seaweedfs_tpu_torch.utils import httpd

PRUNE_AFTER_S = 4.0  # two volume-server pulses (2 s) without a heartbeat


def _port_vs(dirs, master_url, **kw):
    return VolumeServer(dirs, master_url, device="cpu", **kw)


PORT = types.SimpleNamespace(
    Master=MasterServer, VS=_port_vs, fmod=filer_server, http=httpd,
    Shell=ShellContext, repl=repl, cli=cli)
JAX = types.SimpleNamespace(
    Master=JMasterServer, VS=JVolumeServer, fmod=jfiler_server, http=jhttpd,
    Shell=JShellContext, repl=jrepl, cli=jcli)


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


def make_tree(root, seed=0):
    """A seeded three-level tree: {relative path: bytes}."""
    rng = np.random.default_rng(seed)
    sizes = ([int(rng.integers(1024, 128 * 1024)) for _ in range(24)]
             + [300_000, 900_000]                    # one chunk, 302
             + [4 * 1024 * 1024 + 1, 6_500_000])     # multi-chunk
    tree = {}
    for i, n in enumerate(sizes):
        rel = f"d{i % 2}/s{i % 3}/f{i:03d}.bin"
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        tree[rel] = data
    return tree


def _node_count(sh):
    topo = sh.topology()
    return sum(len(r["nodes"]) for dc in topo["data_centers"]
               for r in dc["racks"])


def _shards_per_vid(sh):
    """{vid: shards registered with the master}."""
    out = {}
    for dc in sh.topology()["data_centers"]:
        for rack in dc["racks"]:
            for n in rack["nodes"]:
                for s in n.get("ec_shards", []):
                    out[s["id"]] = out.get(s["id"], 0) + \
                        bin(s["ec_index_bits"]).count("1")
    return out


def _recovered(pkg, servers, vids):
    total = 0
    for vs in servers:
        for vid in vids:
            try:
                st = pkg.http.http_json(
                    "GET", f"http://{vs.url}/admin/ec/shard_stat"
                           f"?volumeId={vid}&collection=filer_smoke")
            except Exception:
                continue
            total += sum(st.get("recover_stats", {}).values())
    return total


def _read_all(pkg, filer_url, tree):
    """GET every file through the filer (following 302s): how many came
    back byte-equal, and how many were redirected."""
    ok = redirected = 0
    for rel, data in tree.items():
        url = f"http://{filer_url}/data/tree/{rel}"
        status, _, _ = pkg.http.http_call("GET", url,
                                          follow_redirects=False)
        redirected += status == 302
        status, body, _ = pkg.http.http_call("GET", url)
        ok += status == 200 and hashlib.sha256(body).digest() == \
            hashlib.sha256(data).digest()
    return ok, redirected


def _lifecycle(pkg, root, capsys, calls):
    tree = make_tree(root / "tree")
    master = pkg.Master(volume_size_limit_mb=64)
    master.start()
    servers, live, filer = [], [], None
    out = {}
    try:
        for i, port in enumerate(_free_ports(4)):
            vs = pkg.VS([str(root / f"v{i}")], master.url, port=port,
                        rack=f"r{i % 2}", data_center="dc1")
            vs.start()
            servers.append(vs)
        live = list(servers)
        sh = pkg.Shell(master.url)
        _wait(lambda: _node_count(sh) == 4, "four volume servers")

        filer_port = _free_ports(1)[0]

        def start_filer():
            # the same port on restart: the master keeps a filer
            # registered for a while after it stops
            f = pkg.fmod.FilerServer(master.url, port=filer_port,
                                     store="lsm",
                                     store_dir=str(root / "filer"))
            f.start()
            _wait(lambda: any(n["url"] == f.url for n in pkg.http.http_json(
                "GET", f"http://{master.url}/cluster/nodes?type=filer")
                .get("cluster_nodes", [])), "the filer to register")
            return f

        filer = start_filer()
        run = lambda line: pkg.repl.run_command(sh, line)  # noqa: E731
        run("fs.configure -locationPrefix /data -collection filer_smoke")
        pkg.cli.main(["filer.copy", "-filer", filer.url,
                      str(root / "tree"), "/data/"])
        out["copy"] = capsys.readouterr().out.strip().splitlines()[-1]
        out["du"] = run("fs.du /data")
        out["fsck_copied"] = run("volume.fsck")
        vids = sorted({v["id"] for dc in sh.topology()["data_centers"]
                       for r in dc["racks"] for n in r["nodes"]
                       for v in n["volumes"]
                       if v.get("collection") == "filer_smoke"})
        run("lock")
        enc = run("ec.encode -collection filer_smoke")
        run("unlock")
        out["encoded"] = len(enc) == len(vids) > 0
        _wait(lambda: all(_shards_per_vid(sh).get(v) == 14 for v in vids),
              "every shard to register")
        held = {}
        for r in enc:
            for url, sids in r["placement"].items():
                held[url] = held.get(url, 0) + len(sids)
        victim = max(servers, key=lambda vs: (held.get(vs.url, 0), vs.url))
        victim.stop()
        live.remove(victim)

        def pruned():
            master.topo.prune_dead_nodes(timeout=PRUNE_AFTER_S)
            return _node_count(sh) == 3

        _wait(pruned, "the stopped server to be pruned",
              timeout=PRUNE_AFTER_S + 6)
        # every volume keeps at least 10 shards
        per_vid = _shards_per_vid(sh)
        out["min_shards"] = min(per_vid[v] for v in vids) >= 10
        # a cold filer: restarted from its lsm directory
        filer.stop()
        filer = start_filer()
        before, k1_before = _recovered(pkg, live, vids), len(calls)
        out["degraded"] = _read_all(pkg, filer.url, tree)

        def settled():
            # a hedged fetch the filer gave up on may still be
            # reconstructing on a server: read once both counts agree
            rec = _recovered(pkg, live, vids) - before
            k1 = len(calls) - k1_before
            return (rec, k1) if pkg is not PORT or rec == k1 else None

        out["reconstructs"], out["k1_degraded"] = _wait(
            settled, "the degraded reads to settle", timeout=30.0)
        run("lock")
        plans = run("ec.rebuild")
        run("unlock")
        out["rebuilt"] = sorted(len(p.get("rebuilt", [])) for p in plans)
        out["after_rebuild"] = _read_all(pkg, filer.url, tree)
        out["du_after"] = run("fs.du /data")
        listing = run("fs.ls /data/tree/d0/s0")
        out["listing"] = [(e["FullPath"], e["FileSize"],
                           [(c["offset"], c["size"]) for c in e["chunks"]])
                          for e in listing]
        fsck = run("volume.fsck")
        out["fsck_ec"] = {k: fsck[k] for k in ("missing_count",
                                              "orphan_count", "purged")}
        run("fs.rm -r /data/tree/d1")
        out["du_rm"] = run("fs.du /data")
        fsck = run("volume.fsck -fix")
        out["fsck_rm"] = {k: fsck[k] for k in ("missing_count",
                                              "orphan_count",
                                              "purge_refused")}
        out["tree"] = {"files": len(tree),
                       "bytes": sum(map(len, tree.values())),
                       "d0": sum(len(v) for k, v in tree.items()
                                 if k.startswith("d0/")),
                       "d0_files": sum(k.startswith("d0/") for k in tree)}
        return out
    finally:
        for srv in [filer, *live, master]:
            if srv is not None:
                srv.stop()


def _upstream_lookup(real):
    """Topology.lookup with the reference's EC fallback (topology.go
    Lookup): the shard holders of an EC volume, in shard order."""
    def lookup(self, collection, vid):
        nodes = real(self, collection, vid)
        if nodes:
            return nodes
        holders = {}
        for shard_nodes in self.ec_shard_map.get(vid) or []:
            for n in shard_nodes:
                holders.setdefault(n.url, n)
        return list(holders.values())
    return lookup


def test_lookup_finds_ec_volumes_as_the_reference_does():
    """The port's master answers /dir/lookup for an EC volume with its
    shard holders, as the reference's Topology.Lookup does, so a filer
    holding a fid of an encoded volume can read it. seaweedfs_tpu's
    lookup returns nothing there (its filer cannot read a file once its
    volume is EC-encoded); the lifecycle test below gives the JAX stack
    the reference's lookup for that reason."""
    hbs = [{"ip": "10.0.0.1", "port": 8080 + i, "rack": f"r{i % 2}",
            "volumes": [{"id": 3, "size": 10, "collection": "c"}]
            if i == 0 else [],
            "ec_shards": [{"id": 7, "collection": "c",
                           "ec_index_bits": bits}]}
           for i, bits in enumerate((0b11, 0b1100, 0b110000, 0))]
    want_ec = ["10.0.0.1:8080", "10.0.0.1:8081", "10.0.0.1:8082"]
    for mod, ec in ((topology, want_ec), (jtopology, [])):
        topo = mod.Topology()
        for hb in hbs:
            topo.sync_data_node_registration(hb)
        assert [n.url for n in topo.lookup("c", 3)] == ["10.0.0.1:8080"]
        assert [n.url for n in topo.lookup("", 7)] == ec
        assert [n.url for n in topo.lookup("c", 8)] == []
        fixed = _upstream_lookup(mod.Topology.lookup)
        assert [n.url for n in fixed(topo, "", 7)] == want_ec


def _collection_ec_volumes(monkeypatch):
    """Let seaweedfs_tpu's volume servers keep an EC volume of a named
    collection, as the port's do: EcVolume / EcVolumeShard open the
    reference's <collection>_<vid>.* files (the names its encoder writes;
    as shipped they open <vid>.* and mount nothing), and a shard or EC
    request naming the volume without its collection finds the files of
    that id on disk (seaweedfs_tpu's shell sends no collection with its
    rebuild, copy and mount requests; the port's sends it)."""
    def named(init):
        def wrapped(self, directory, collection, volume_id, *a, **kw):
            name = f"{collection}_{volume_id}" if collection else volume_id
            init(self, directory, collection, name, *a, **kw)
            self.volume_id = volume_id
        return wrapped
    for cls in (jec_volume.EcVolume, jec_volume.EcVolumeShard):
        monkeypatch.setattr(cls, "__init__", named(cls.__init__))

    def collection_of(directory, vid):
        for name in sorted(os.listdir(directory)):
            stem, _, ext = name.rpartition(".")
            col, _, v = stem.rpartition("_")
            if v == str(vid) and (ext == "ecx" or ext.startswith("ec")):
                return col
        return None

    load = jdisk_location.DiskLocation.load_ec_shard

    def load_ec_shard(self, collection, vid, shard_id):
        ev = self.ec_volumes.get(vid)
        collection = collection or (ev.collection if ev else
                                    collection_of(self.directory, vid)
                                    or "")
        return load(self, collection, vid, shard_id)

    base_name = jvolume_server.VolumeServer._ec_base_name

    def _ec_base_name(self, vid, collection=""):
        for loc in self.store.locations:
            if collection:
                break
            ev = loc.ec_volumes.get(vid)
            collection = ev.collection if ev else \
                collection_of(loc.directory, vid) or ""
        return base_name(self, vid, collection)
    monkeypatch.setattr(jdisk_location.DiskLocation, "load_ec_shard",
                        load_ec_shard)
    monkeypatch.setattr(jvolume_server.VolumeServer, "_ec_base_name",
                        _ec_base_name)


def test_ec_volume_in_a_collection_mounts_as_the_reference_names_it(
        tmp_path):
    """An EC volume of collection c lives in c_<vid>.ecNN / .ecx (what the
    encoder writes): the port's EcVolume and EcVolumeShard open those;
    seaweedfs_tpu's look for <vid>.* and find nothing."""
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_volume
    for ext in (".ecx", ".vif", ".ec03"):
        (tmp_path / f"c_7{ext}").write_bytes(b"\0" * 40)
    ev = ec_volume.EcVolume(str(tmp_path), "c", 7)
    assert ev.ecx_file is not None and ev.volume_id == 7
    assert ev.add_shard(ec_volume.EcVolumeShard(str(tmp_path), "c", 7, 3))
    assert ev.shard_bits().bits == 1 << 3
    ev.close()
    jev = jec_volume.EcVolume(str(tmp_path), "c", 7)
    assert jev.ecx_file is None
    with pytest.raises(FileNotFoundError):
        jec_volume.EcVolumeShard(str(tmp_path), "c", 7, 3)


@pytest.mark.parametrize("collection", ["", "c"])
def test_ec_collection_rides_from_heartbeat_to_repair(collection):
    """The collection a volume server's heartbeat names for an EC volume
    reaches the master's /dir/status (as the reference's
    EcShardInformationMessage carries it) and the repair queue's degraded
    scan, which submits the volume with it: the port's EC files of a named
    collection are <collection>_<vid>.*. The default collection shows as
    seaweedfs_tpu's does, and its queue submits "" for both."""
    hb = {"ip": "10.0.0.1", "port": 8080, "volumes": [],
          "ec_shards": [{"id": 7, "collection": collection,
                         "ec_index_bits": (1 << 13) - 1}]}
    tasks = {}
    for mod, Master in (("port", MasterServer), ("jax", JMasterServer)):
        m = Master()
        m.repair_queue.scan_grace_s = 0.0
        m.repair_queue._dispatch = lambda: None  # keep what is submitted
        node = m.topo.sync_data_node_registration(hb)
        info = node.to_info()["ec_shards"]
        m.repair_queue._scan()
        tasks[mod] = (info, m.repair_queue._tasks[7].collection)
        m.repair_queue._tasks.clear()
    named = {"collection": collection} if collection else {}
    assert tasks["port"] == ([{"id": 7, "ec_index_bits": (1 << 13) - 1,
                               **named}], collection)
    assert tasks["jax"] == ([{"id": 7, "ec_index_bits": (1 << 13) - 1}], "")
    t = topology.Topology()
    t.sync_data_node_registration(hb)
    assert t.ec_collection(7) == collection and t.ec_collection(8) == ""
    t.incremental_sync(t.find_node("10.0.0.1:8080"), {
        "deleted_ec_shards": [{"id": 7, "ec_index_bits": (1 << 13) - 1}]})
    assert t.ec_collection(7) == ""


def test_filer_ec_lifecycle_matches_jax(tmp_path, monkeypatch, capsys):
    # the JAX stack gets the reference's EC lookup and keeps EC volumes
    # of a named collection: as shipped, its filer finds no encoded
    # volume and its servers mount none of the filer's collection (the
    # two cases above)
    monkeypatch.setattr(jtopology.Topology, "lookup",
                        _upstream_lookup(jtopology.Topology.lookup))
    _collection_ec_volumes(monkeypatch)
    calls = []
    real = rs_cuda.gf_apply

    def counted(mat, data, out=None):
        calls.append(tuple(data.shape))
        return real(mat, data, out)

    monkeypatch.setattr(rs_cuda, "gf_apply", counted)
    want = _lifecycle(JAX, tmp_path / "jax", capsys, calls)
    assert calls == []  # the JAX stack never reaches the port's kernel
    got = _lifecycle(PORT, tmp_path / "port", capsys, calls)
    for key in ("copy", "du", "encoded", "min_shards", "degraded",
                "rebuilt", "after_rebuild", "du_after", "listing",
                "fsck_ec", "du_rm", "fsck_rm"):
        assert got[key] == want[key], key
    tree = got["tree"]
    assert got["du"] == {"files": tree["files"], "bytes": tree["bytes"]}
    assert got["du_after"] == got["du"]
    assert got["du_rm"] == {"files": tree["d0_files"], "bytes": tree["d0"]}
    assert got["fsck_copied"]["volumes_checked"] > 0
    assert got["fsck_copied"]["missing_count"] == 0
    assert got["fsck_copied"]["orphan_count"] == 0
    assert got["encoded"] and got["min_shards"]
    n = tree["files"]
    assert got["degraded"] == (n, 2) and got["after_rebuild"] == (n, 2)
    assert got["fsck_ec"]["missing_count"] == 0
    assert got["fsck_rm"]["missing_count"] == 0
    assert got["rebuilt"] and all(got["rebuilt"])
    # K1 ran on the degraded pass: one call per reconstructed interval
    assert got["k1_degraded"] == got["reconstructs"] > 0
    assert want["reconstructs"] > 0 and want["k1_degraded"] == 0
