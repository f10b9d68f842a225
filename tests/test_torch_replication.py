"""The port's replication/ (sink.py, sync.py, remote_sync.py) held against
the JAX package's: filer -> filer sync one way and both ways with no echo,
the local sink, meta.backup / meta.tail, the gRPC subscription and its
idle ticks, the pump's back-pressure, filer.remote.sync's write-back, and
across the packages: the change events of a JAX filer and of a port filer
converted by either package's _pb_event_to_dict to equal dicts, a sync and
a backup from a filer of one package into a filer (or a mirror) of the
other with equal replicas. Differences on purpose are pinned here: a
source read that fails is retried, where the JAX Replicator writes an empty
replica; a port filer on a local store keeps its change log across a
restart, where the JAX filer starts with an empty one; a failed probe of a
filer's gRPC plane leaves no polling thread; the REPL's fs.meta.tail -n
takes its count. The port's volume servers run with device="cpu".
(ref tests/test_replication.py, test_bidir_sync_cli.py,
test_grpc_planes.py's sync cases, test_invariant_fixes.py's pump case,
test_remote_storage.py's filer.remote.sync cases.)
"""

import json
import os
import time
import types

import numpy as np
import pytest

import seaweedfs_tpu.replication.sink as j_sink
import seaweedfs_tpu.replication.sync as j_sync
from seaweedfs_tpu.server import filer_server as j_filer_server
from seaweedfs_tpu.server.master import MasterServer as JMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.utils import httpd as j_httpd
import seaweedfs_tpu_torch.replication.sink as p_sink
import seaweedfs_tpu_torch.replication.sync as p_sync
from seaweedfs_tpu_torch.notification.queue import (InMemoryQueue,
                                                    attach_to_filer)
from seaweedfs_tpu_torch.replication.remote_sync import FilerRemoteSync
from seaweedfs_tpu_torch.replication.sink import FilerSink, LocalSink
from seaweedfs_tpu_torch.replication.sync import (BidirectionalSync,
                                                  FilerSync, meta_backup)
from seaweedfs_tpu_torch.server import filer_server as p_filer_server
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils import httpd as p_httpd
from seaweedfs_tpu_torch.utils.httpd import http_call, http_json
from torch_ports import free_grpc_ports


def _port_vs(dirs, master_url, **kw):
    return VolumeServer(dirs, master_url, device="cpu", **kw)


PORT = types.SimpleNamespace(Master=MasterServer, VS=_port_vs,
                             Filer=p_filer_server.FilerServer, sink=p_sink,
                             sync=p_sync, http=p_httpd)
JAX = types.SimpleNamespace(Master=JMaster, VS=JVolumeServer,
                            Filer=j_filer_server.FilerServer, sink=j_sink,
                            sync=j_sync, http=j_httpd)


def _wait_for(fn, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.05)
    return False


class _Cluster:
    """A master and a volume server of `pkg`, and filers on them."""

    def __init__(self, pkg, root):
        self.master = pkg.Master(volume_size_limit_mb=64)
        self.master.start()
        self.vs = pkg.VS([str(root / "v")], self.master.url)
        self.vs.start()
        self.filers = []

    def filer(self, pkg, **kw):
        fs = pkg.Filer(self.master.url, **kw)
        fs.start()
        self.filers.append(fs)
        return fs

    def stop(self):
        for srv in [*reversed(self.filers), self.vs, self.master]:
            srv.stop()


@pytest.fixture
def two_filers(tmp_path):
    cl = _Cluster(PORT, tmp_path)
    try:
        src, dst = cl.filer(PORT), cl.filer(PORT)
        time.sleep(0.15)
        yield cl.master, src, dst, tmp_path
    finally:
        cl.stop()


# ---------------- twins of the reference's cases ----------------


def test_filer_to_filer_sync(two_filers):
    master, src, dst, tmp_path = two_filers
    sync = FilerSync(src.url, FilerSink(dst.url))
    sync.start()
    try:
        http_call("POST", f"http://{src.url}/docs/a.txt", body=b"hello sync")
        big = b"B" * 100_000
        http_call("POST", f"http://{src.url}/docs/big.bin", body=big)
        assert _wait_for(lambda: http_call(
            "GET", f"http://{dst.url}/docs/big.bin")[0] == 200)
        status, body, _ = http_call("GET", f"http://{dst.url}/docs/a.txt")
        assert status == 200 and body == b"hello sync"
        status, body, _ = http_call("GET", f"http://{dst.url}/docs/big.bin")
        assert status == 200 and body == big
        # deletes propagate
        http_call("DELETE", f"http://{src.url}/docs/a.txt")
        assert _wait_for(lambda: http_call(
            "GET", f"http://{dst.url}/docs/a.txt")[0] == 404)
    finally:
        sync.stop()


def test_local_sink_replication(two_filers):
    master, src, dst, tmp_path = two_filers
    out = tmp_path / "mirror"
    sync = FilerSync(src.url, LocalSink(str(out)))
    http_call("POST", f"http://{src.url}/m/x/file.bin", body=b"mirror me")
    sync.run_once(0)
    assert (out / "m" / "x" / "file.bin").read_bytes() == b"mirror me"


def test_meta_backup(two_filers):
    master, src, dst, tmp_path = two_filers
    http_call("POST", f"http://{src.url}/b/one.txt", body=b"1")
    http_call("POST", f"http://{src.url}/b/two.txt", body=b"2")
    backup = tmp_path / "meta.jsonl"
    assert meta_backup(src.url, str(backup), max_events=2) == 2
    lines = [json.loads(ln) for ln in backup.read_text().splitlines()]
    assert len(lines) == 2 and all("directory" in ln for ln in lines)


def test_notification_queue_attach():
    from seaweedfs_tpu_torch.filer.entry import Entry
    from seaweedfs_tpu_torch.filer.filer import Filer
    f = Filer()
    mq = InMemoryQueue()
    attach_to_filer(f, mq)
    f.create_entry(Entry("/q/file.txt"))
    key, msg = mq.receive(timeout=1)
    while "/q/file.txt" not in key:  # the parent directory comes first
        key, msg = mq.receive(timeout=1)
    assert msg["new_entry"]["full_path"] == "/q/file.txt"


def test_bidirectional_sync_no_echo(two_filers):
    master, a, b, _ = two_filers
    sync = BidirectionalSync(a.url, b.url)
    sync.start()
    try:
        http_call("POST", f"http://{a.url}/docs/from_a.txt", body=b"AAA")
        assert _wait_for(lambda: http_call(
            "GET", f"http://{b.url}/docs/from_a.txt")[0] == 200)
        http_call("POST", f"http://{b.url}/docs/from_b.txt", body=b"BBB")
        assert _wait_for(lambda: http_call(
            "GET", f"http://{a.url}/docs/from_b.txt")[0] == 200)
        # no echo: the event logs stop growing once both sides settle
        time.sleep(1.0)
        counts = (len(a.filer.meta_log.events), len(b.filer.meta_log.events))
        time.sleep(1.5)
        assert (len(a.filer.meta_log.events),
                len(b.filer.meta_log.events)) == counts
        http_call("POST", f"http://{a.url}/docs/from_a.txt", body=b"A2")
        assert _wait_for(lambda: http_call(
            "GET", f"http://{b.url}/docs/from_a.txt")[1] == b"A2")
        http_call("DELETE", f"http://{b.url}/docs/from_a.txt")
        assert _wait_for(lambda: http_call(
            "GET", f"http://{a.url}/docs/from_a.txt")[0] == 404)
    finally:
        sync.stop()


def test_sync_signature_tagging(two_filers):
    master, a, b, _ = two_filers
    http_call("POST", f"http://{a.url}/p/mine.txt", body=b"x")
    http_call("POST", f"http://{a.url}/p/theirs.txt", body=b"y",
              headers={"X-Weed-Sync-Signature": "777"})
    out = http_json("GET", f"http://{a.url}/__api/meta_events?since_ns=0")
    sigs = {e["new_entry"]["full_path"]: e.get("signature", 0)
            for e in out["events"] if e.get("new_entry")}
    assert sigs["/p/mine.txt"] == 0 and sigs["/p/theirs.txt"] == 777
    out = http_json("GET", f"http://{a.url}/__api/meta_events?since_ns=0"
                           f"&exclude_signature=777")
    paths = [e["new_entry"]["full_path"] for e in out["events"]
             if e.get("new_entry")]
    assert "/p/mine.txt" in paths and "/p/theirs.txt" not in paths


def test_excluded_burst_does_not_starve_reader(two_filers):
    master, a, b2, _ = two_filers
    for i in range(1100):
        http_call("POST", f"http://{b2.url}/bulk/g{i:04d}", body=b"y",
                  headers={"X-Weed-Sync-Signature": "555"})
    http_call("POST", f"http://{b2.url}/bulk/native.txt", body=b"mine")
    out = http_json("GET", f"http://{b2.url}/__api/meta_events"
                           f"?since_ns=0&exclude_signature=555")
    paths = [(e.get("new_entry") or {}).get("full_path")
             for e in out["events"]]
    assert "/bulk/native.txt" in paths
    assert not any(p and p.startswith("/bulk/g") for p in paths)
    native_ts = next(e["tsns"] for e in out["events"]
                     if (e.get("new_entry") or {}).get("full_path")
                     == "/bulk/native.txt")
    out2 = http_json("GET", f"http://{b2.url}/__api/meta_events"
                            f"?since_ns={native_ts}&exclude_signature=555")
    assert out2["events"] == [] and out2["cursor"] >= native_ts


def test_aggregated_stream_keeps_signature(two_filers):
    master, a, b, _ = two_filers
    assert a.meta_aggregator is not None
    http_call("POST", f"http://{a.url}/agg/tagged.txt", body=b"t",
              headers={"X-Weed-Sync-Signature": "909"})
    evs = []
    assert _wait_for(lambda: evs.extend(
        a.meta_aggregator.log.read_since(0, "/agg")) or evs, timeout=5)
    assert evs[-1].get("signature") == 909
    assert a.meta_aggregator.log.read_since(
        0, "/agg", exclude_signature=909) == []


def test_cli_version(capsys):
    from seaweedfs_tpu_torch.cli import main
    main(["version"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out["version"] and out["python"]


def test_cli_filer_cat_copy_meta_backup(two_filers, tmp_path, capsys):
    from seaweedfs_tpu_torch.cli import main
    master, a, b, _ = two_filers
    src = tmp_path / "local"
    (src / "sub").mkdir(parents=True)
    (src / "one.txt").write_bytes(b"first")
    (src / "sub" / "two.txt").write_bytes(b"second")
    main(["filer.copy", "-filer", a.url, str(src / "one.txt"),
          str(src / "sub"), "/in/"])
    assert json.loads(capsys.readouterr().out.strip())["copied"] == 2
    main(["filer.cat", "-filer", a.url, "/in/one.txt"])
    assert capsys.readouterr().out.encode().strip() == b"first"
    dump = tmp_path / "meta.jsonl"
    main(["filer.meta.backup", "-filer", a.url, "-o", str(dump)])
    assert json.loads(capsys.readouterr().out.strip())["events"] >= 2
    lines = [json.loads(ln) for ln in dump.read_text().splitlines()]
    assert any((ln.get("new_entry") or {}).get("full_path") == "/in/one.txt"
               for ln in lines)


@pytest.fixture
def grpc_filer(tmp_path):
    """A port filer with its gRPC plane on port + 10000 (its ports drawn
    once the master and the volume server hold theirs)."""
    cl = _Cluster(PORT, tmp_path)
    try:
        port = free_grpc_ports(1)[0]
        yield cl.filer(PORT, store="memory", port=port,
                       grpc_port=port + 10000)
    finally:
        cl.stop()


def test_filer_sync_subscription_over_grpc(grpc_filer):
    fs = grpc_filer
    assert p_sync._probe_filer_grpc(fs.url) is not None
    http_call("POST", f"http://{fs.url}/g/x.txt", body=b"gsync")
    gen = p_sync.subscribe_meta_events(fs.url, since_ns=0, path_prefix="/g")
    ev = next(e for e in gen if e is not None)
    gen.close()
    assert ev["new_entry"]["full_path"] == "/g/x.txt" and ev["tsns"] > 0


def test_failed_grpc_probe_leaves_no_poller():
    """A probe of a filer without a gRPC plane answers None and closes its
    channel: no connectivity-polling thread is left behind (the JAX
    probe leaves one per call, for the life of the process)."""
    import sys
    import traceback

    def pollers():
        return sum(1 for f in sys._current_frames().values() if any(
            fr.f_code.co_name == "_poll_connectivity"
            for fr, _ in traceback.walk_stack(f)))
    before = pollers()
    for _ in range(3):
        assert p_sync._probe_filer_grpc("127.0.0.1:1") is None
    time.sleep(0.5)
    assert pollers() <= before


def test_grpc_subscribe_idle_ticks_and_prefix_no_spin(grpc_filer):
    fs = grpc_filer
    http_call("POST", f"http://{fs.url}/other/a.txt", body=b"x")
    gen = p_sync.subscribe_meta_events(fs.url, since_ns=0,
                                       path_prefix="/nevermatches")
    t0 = time.time()
    assert next(gen) is None  # an idle tick, not a spin
    assert time.time() - t0 < 30
    gen.close()


class _StubCall:
    """An endless SubscribeMetadata stream that counts what was read."""

    def __init__(self):
        self.pulled = 0
        self.cancelled = False

    def __iter__(self):
        while not self.cancelled:
            self.pulled += 1
            yield self.pulled

    def cancel(self):
        self.cancelled = True


def test_sync_pump_backpressures_instead_of_buffering(monkeypatch):
    monkeypatch.setattr(p_sync, "_pb_event_to_dict", lambda resp: resp)
    call = _StubCall()
    client = types.SimpleNamespace(
        subscribe_metadata=lambda since_ns, path_prefix: call)
    gen = p_sync._grpc_event_stream(client, 0, "/")
    assert next(gen) is not None
    deadline = time.monotonic() + 2.0
    while call.pulled < 100 and time.monotonic() < deadline:
        time.sleep(0.01)
    high = call.pulled
    time.sleep(0.3)  # a stalled consumer parks the pump
    assert call.pulled <= high + 1 <= 260
    gen.close()
    assert call.cancelled


@pytest.fixture
def remote_mount(tmp_path):
    cl = _Cluster(PORT, tmp_path)
    try:
        fs = cl.filer(PORT)
        cloud = tmp_path / "cloud"
        cloud.mkdir()
        base = f"http://{fs.url}"
        http_json("POST", f"{base}/__api/remote/configure",
                  {"name": "cloud", "type": "local", "root": str(cloud)})
        http_json("POST", f"{base}/__api/remote/mount",
                  {"dir": "/cloud", "remote_name": "cloud"})
        yield fs, base, cloud
    finally:
        cl.stop()


def test_remote_sync_pushes_local_writes(remote_mount):
    fs, base, cloud = remote_mount
    sync = FilerRemoteSync(fs.url, "/cloud")
    cursor = sync.run_once(0)
    http_call("POST", f"{base}/cloud/new.txt", body=b"fresh local data")
    cursor = sync.run_once(cursor)
    assert sync.synced == 1
    assert (cloud / "new.txt").read_bytes() == b"fresh local data"
    entry = fs.filer.find_entry("/cloud/new.txt")
    assert entry.remote is not None and entry.remote.last_local_sync_ts > 0
    cursor = sync.run_once(cursor)  # no echo
    assert sync.synced == 1
    http_call("DELETE", f"{base}/cloud/new.txt")
    sync.run_once(cursor)
    assert sync.removed == 1 and not (cloud / "new.txt").exists()


def test_remote_sync_rename_removes_old_object(remote_mount):
    fs, base, cloud = remote_mount
    sync = FilerRemoteSync(fs.url, "/cloud")
    cursor = sync.run_once(0)
    http_call("POST", f"{base}/cloud/old.txt", body=b"data")
    cursor = sync.run_once(cursor)
    assert (cloud / "old.txt").exists()
    http_json("POST", f"{base}/__api/rename",
              {"from": "/cloud/old.txt", "to": "/cloud/new_name.txt"})
    cursor = sync.run_once(cursor)
    assert not (cloud / "old.txt").exists()
    assert (cloud / "new_name.txt").exists()
    http_json("POST", f"{base}/__api/rename",
              {"from": "/cloud/new_name.txt", "to": "/elsewhere/x.txt"})
    sync.run_once(cursor)
    assert not (cloud / "new_name.txt").exists()


# ---------------- across the packages ----------------


def _seeded_files(seed, n=6):
    rng = np.random.default_rng(seed)
    return {f"/x/d{i % 2}/f{i}.bin": rng.bytes(int(rng.integers(1, 300_000)))
            for i in range(n)}


def _norm_event(ev):
    """An event dict without what differs between two filers: times,
    chunk ids and chunk times."""
    out = {"directory": ev["directory"]}
    for side in ("old_entry", "new_entry"):
        e = ev.get(side)
        if e is not None:
            e = dict(e)
            e["attr"] = {k: v for k, v in e["attr"].items()
                         if k not in ("mtime", "crtime")}
            e["chunks"] = [(c["offset"], c["size"]) for c in e["chunks"]]
        out[side] = e
    return out


def _grpc_responses(pkg_filer, tmp_path, files):
    """The SubscribeMetadata responses of a filer of one package after the
    seeded writes, as the port's client reads them."""
    from seaweedfs_tpu_torch.server.filer_grpc import GrpcFilerClient
    pkg = PORT if pkg_filer == "port" else JAX
    cl = _Cluster(pkg, tmp_path / pkg_filer)
    try:
        port = free_grpc_ports(1)[0]
        fs = cl.filer(pkg, store="memory", port=port,
                      grpc_port=port + 10000)
        for path, data in files.items():
            assert http_call("POST", f"http://{fs.url}{path}",
                             body=data)[0] < 300
        client = GrpcFilerClient(f"127.0.0.1:{port + 10000}", tls=None)
        call = client.subscribe_metadata(since_ns=0, path_prefix="/x")
        out = []
        for resp in call:
            out.append(resp)
            if len(out) == len(files) + 2:  # /x/d0, /x/d1 and the files
                break
        call.cancel()
        client.close()
        return out
    finally:
        cl.stop()


@pytest.mark.parametrize("source", ["port", "jax"])
def test_event_dicts_equal_across_packages(source, tmp_path):
    """The change events of a filer of either package convert to equal
    dicts through either package's _pb_event_to_dict, and the two
    filers' events agree but for times and chunk ids."""
    files = _seeded_files(7)
    resps = _grpc_responses(source, tmp_path, files)
    got = [p_sync._pb_event_to_dict(r) for r in resps]
    want = [j_sync._pb_event_to_dict(r) for r in resps]
    assert got == want
    assert sorted(ev["new_entry"]["full_path"] for ev in got) == sorted(
        [*files, "/x/d0", "/x/d1"])


def test_filer_events_agree_across_packages(tmp_path):
    """One seeded script through a port filer and a JAX filer: their
    /__api/meta_events dicts agree but for times and chunk ids."""
    files = _seeded_files(11)
    events = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        cl = _Cluster(pkg, tmp_path / name)
        fs = cl.filer(pkg, store="memory")
        try:
            for path, data in files.items():
                http_call("POST", f"http://{fs.url}{path}", body=data)
            http_json("POST", f"http://{fs.url}/__api/rename",
                      {"from": "/x/d0/f0.bin", "to": "/x/d1/moved.bin"})
            http_call("DELETE", f"http://{fs.url}/x/d1/f1.bin")
            out = http_json("GET", f"http://{fs.url}/__api/meta_events"
                                   f"?since_ns=0&prefix=/x")
            events[name] = [_norm_event(e) for e in out["events"]]
        finally:
            cl.stop()
    assert events["port"] == events["jax"]
    assert len(events["port"]) == len(files) + 4


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_sync_and_backup_across_packages(src, dst, tmp_path):
    """A filer of one package synced into a filer of the other (each
    package's FilerSync and FilerSink, on one master of the source's
    package) and backed up by each package's LocalSink: every replica's
    bytes equal the source's, both mirrors equal."""
    pkgs = {"port": PORT, "jax": JAX}
    s, d = pkgs[src], pkgs[dst]
    cl = _Cluster(s, tmp_path / "c")
    a = cl.filer(s, store="memory")
    b = cl.filer(d, store="memory")
    files = _seeded_files(3)
    try:
        for path, data in files.items():
            http_call("POST", f"http://{a.url}{path}", body=data)
        for pkg in (PORT, JAX):
            mirror = tmp_path / f"mirror_{pkg is PORT}"
            pkg.sync.FilerSync(a.url, pkg.sink.LocalSink(str(mirror))) \
                .run_once(0)
            for path, data in files.items():
                assert (mirror / path.lstrip("/")).read_bytes() == data
        d.sync.FilerSync(a.url, d.sink.FilerSink(b.url)).run_once(0)
        for path, data in files.items():
            assert http_call("GET", f"http://{b.url}{path}")[1] == data
        # and back with the source package's sync, under a prefix
        s.sync.FilerSync(b.url, s.sink.FilerSink(a.url, path_prefix="/back"),
                         path_prefix="/x").run_once(0)
        for path, data in files.items():
            assert http_call("GET", f"http://{a.url}/back{path}")[1] == data
    finally:
        cl.stop()


# ---------------- differences on purpose ----------------


def test_failed_source_read_is_retried_not_skipped(two_filers, monkeypatch):
    """A source GET that fails (a volume server down mid-read) makes the
    port's Replicator raise, so FilerSync holds its cursor and the next
    pass writes the right bytes; the JAX Replicator writes an empty
    replica and its cursor moves on."""
    master, src, dst, tmp_path = two_filers
    http_call("POST", f"http://{src.url}/r/file.bin", body=b"the bytes")
    for name, pkg in (("port", PORT), ("jax", JAX)):
        real = pkg.http.http_call
        failed = []

        def flaky(method, url, *a, _real=real, _failed=failed, **kw):
            if url.endswith("/r/file.bin") and not _failed:
                _failed.append(url)
                return 500, b"volume server down", {}
            return _real(method, url, *a, **kw)
        monkeypatch.setattr(pkg.http, "http_call", flaky)
        mirror = tmp_path / f"mirror_{name}"
        sync = pkg.sync.FilerSync(src.url, pkg.sink.LocalSink(str(mirror)))
        if pkg is PORT:
            with pytest.raises(p_httpd.HttpError):
                sync.run_once(0)
            sync.run_once(0)  # the same events again
            assert (mirror / "r/file.bin").read_bytes() == b"the bytes"
        else:
            cursor = sync.run_once(0)
            assert (mirror / "r/file.bin").read_bytes() == b""
            assert sync.run_once(cursor) == cursor  # skipped for good
        monkeypatch.setattr(pkg.http, "http_call", real)


def test_filer_restart_keeps_change_log(tmp_path):
    """A port filer on the lsm store persists its change log in
    <store_dir>/filer_meta_log (MetaLog durable: every event written
    through, so a kill loses none) and replays it after a restart, so a
    subscriber that starts after the restart sees what was written before
    it; a JAX filer starts with an empty log."""
    got = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        cl = _Cluster(pkg, tmp_path / name)
        store = str(tmp_path / name / "filer")
        first = cl.filer(pkg, store="lsm", store_dir=store)
        for i in range(3):
            http_call("POST", f"http://{first.url}/j/f{i}.txt", body=b"j")
        # a second filer on the same directory while the first still
        # runs: what it finds is what a kill would leave
        second = cl.filer(pkg, store="lsm", store_dir=store)
        out = http_json("GET", f"http://{second.url}/__api/meta_events"
                               f"?since_ns=0&prefix=/j")
        got[name] = [e["new_entry"]["full_path"] for e in out["events"]]
        cl.stop()
    assert got["port"] == [f"/j/f{i}.txt" for i in range(3)]
    assert got["jax"] == []
    assert os.listdir(tmp_path / "port" / "filer" / "filer_meta_log")


def test_fs_meta_tail_reads_its_count(two_filers):
    """The REPL's fs.meta.tail -n N tails N events in the port; the JAX
    REPL's flag parser takes -n for its dry-run switch, so it always
    tails 16."""
    from seaweedfs_tpu.shell.commands import ShellContext as JShell
    from seaweedfs_tpu.shell.repl import run_command as jrun
    from seaweedfs_tpu_torch.shell.commands import ShellContext
    from seaweedfs_tpu_torch.shell.repl import run_command
    master, a, _, _ = two_filers
    for i in range(20):
        http_call("POST", f"http://{a.url}/t/f{i}.txt", body=b"t")
    line = "fs.meta.tail -n 4 -pathPrefix /t"
    assert run_command(ShellContext(master.url), line) == {"events": 4}
    assert jrun(JShell(master.url), line) == {"events": 16}
    assert run_command(ShellContext(master.url),
                       "fs.meta.tail -pathPrefix /t") == {"events": 16}
