"""The port's command line (cli.py), REPL (shell/repl.py), volume tools
(storage/maintenance.py) and glog flag surface, held against the JAX
package's: the same subcommands and output shapes, sha256-equal EC shards
through `ec encode|rebuild|decode`, equal REPL JSON, byte-equal fix /
export / compact / backup outputs, the same glog lines. The servers run
with -device cpu (the kernels' plain versions). Servers that a test starts
through cli.main run on the test's thread: `_serve_until_signal` is
patched to hand them back instead of blocking, and the test stops them.
One test runs `python -m seaweedfs_tpu_torch.cli volume` as a process and
drains it with SIGTERM.
"""

import hashlib
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu import cli as jcli
from seaweedfs_tpu.cluster import topology as jtopology
from seaweedfs_tpu.cluster import volume_growth as jgrowth
from seaweedfs_tpu.server import master as jmaster
from seaweedfs_tpu.shell.commands import ShellContext as JShellContext
from seaweedfs_tpu.shell.repl import run_command as jrun_command
from seaweedfs_tpu.storage import maintenance as jmaint
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu.storage.volume import Volume as JVolume
from seaweedfs_tpu.utils import glog as jglog
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.cluster import topology
from seaweedfs_tpu_torch.cluster import volume_growth
from seaweedfs_tpu_torch.server import master
from seaweedfs_tpu_torch.shell.commands import ShellContext
from seaweedfs_tpu_torch.shell.repl import run_command
from seaweedfs_tpu_torch.storage import maintenance
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.utils import glog
from seaweedfs_tpu_torch.utils.httpd import http_call, http_json
from torch_ports import free_grpc_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL = layout.TOTAL_SHARDS_COUNT
FIXED_NS = 1_700_000_000_123_456_789
PRUNE_AFTER_S = 4.0  # two volume-server pulses (2 s) without a heartbeat

PORT = types.SimpleNamespace(
    cli=cli, run_command=run_command, Shell=ShellContext,
    random_mods=(master, topology, volume_growth), volume_args=[
        "-device", "cpu"])
JAX = types.SimpleNamespace(
    cli=jcli, run_command=jrun_command, Shell=JShellContext,
    random_mods=(jmaster, jtopology, jgrowth), volume_args=[])


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return sorted(s.getsockname()[1] for s in socks)
    finally:
        for s in socks:
            s.close()


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class Stack:
    """A master and volume servers started through one package's cli.main,
    each handed back by the patched _serve_until_signal."""

    def __init__(self, pkg, monkeypatch, tmp_path):
        self.pkg = pkg
        self.tmp = tmp_path
        self.servers: list = []
        monkeypatch.setattr(pkg.cli, "_serve_until_signal",
                            lambda *srv, ready="": self.servers.extend(srv))

    def master(self, *extra):
        port = _free_ports(1)[0]
        self.pkg.cli.main(["master", "-port", str(port),
                           "-volumeSizeLimitMB", "64", *extra])
        self.m = self.servers[-1]
        return self.m

    def volumes(self, n):
        for i, port in enumerate(_free_ports(n)):
            self.pkg.cli.main(["volume", "-port", str(port), "-dir",
                               str(self.tmp / f"v{i}"), "-mserver",
                               self.m.url, "-rack", f"r{i % 2}",
                               "-dataCenter", "dc1", *self.pkg.volume_args])
            _wait(lambda: len(self.m.topo.all_nodes()) == i + 1,
                  f"volume server {i} to register")
        return self.servers[1:]

    def stop(self):
        for srv in reversed(self.servers):
            try:
                srv.stop()
            except Exception:
                pass


@pytest.fixture
def stacks(monkeypatch, tmp_path):
    made = []

    def make(pkg, name):
        s = Stack(pkg, monkeypatch, tmp_path / name)
        made.append(s)
        return s
    yield make
    for s in made:
        s.stop()


def _out(capsys):
    return capsys.readouterr().out.strip().splitlines()


# ---------------- the subcommand surface ----------------


def test_same_subcommands_as_jax(capsys):
    cli.main(["autocomplete"])
    got = _out(capsys)
    jcli.main(["autocomplete"])
    want = _out(capsys)
    assert got[:2] == want[:2]
    assert got[2] == want[2].replace("seaweedfs_tpu.cli",
                                     "seaweedfs_tpu_torch.cli")
    words = got[1].split("'")[1].split()
    assert {"master", "volume", "server", "shell", "ec", "benchmark",
            "master.follower", "filer", "s3", "mount"} <= set(words)
    helps = []
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit):
            main(["-h"])
        helps.append(capsys.readouterr().out)
    assert helps[0] == helps[1]  # the same usage, subcommands and help
    with pytest.raises(SystemExit):
        cli.main(["volume", "-h"])
    vol = capsys.readouterr().out
    assert "{torch,mxu,mesh,cpu,cpu-mt}" in vol and "{cuda,cpu}" in vol


@pytest.fixture(scope="module")
def gateway_stack(tmp_path_factory):
    """A port master, a volume server (-device cpu) and two filers on it
    (memory stores), for the commands of the gateway slice."""
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    root = tmp_path_factory.mktemp("gateway_cli")
    m = master.MasterServer(volume_size_limit_mb=64)
    m.start()
    vs = VolumeServer([str(root / "v")], m.url, device="cpu")
    vs.start()
    f, g = FilerServer(m.url), FilerServer(m.url)
    f.start()
    g.start()
    try:
        _wait(lambda: m.topo.find_node(vs.url) is not None, "the server")
        yield types.SimpleNamespace(master=m.url, f=f.url, g=g.url,
                                    filer=f, root=root)
    finally:
        for srv in (g, f, vs, m):
            srv.stop()


class _Started:
    """Records the sync daemons a command starts, to stop them after."""

    def __init__(self, monkeypatch):
        from seaweedfs_tpu_torch.replication import remote_sync, sync
        self.daemons = []
        for cls in (sync.FilerSync, remote_sync.FilerRemoteSync):
            real = cls.start

            def start(obj, *a, _real=real, **kw):
                self.daemons.append(obj)
                return _real(obj, *a, **kw)
            monkeypatch.setattr(cls, "start", start)

    def stop(self):
        for d in self.daemons:
            d.stop()


def _ended_after(n, monkeypatch):
    """subscribe_meta_events ending after n events: the endless loops of
    filer.replicate and filer.remote.gateway return once they have
    applied them."""
    from seaweedfs_tpu_torch.replication import sync
    real = sync.subscribe_meta_events

    def limited(*a, **kw):
        seen = 0
        for ev in real(*a, **kw):
            yield ev
            if ev is not None:
                seen += 1
                if seen >= n:
                    return
    monkeypatch.setattr(sync, "subscribe_meta_events", limited)


def _gw_put(filer, path, body):
    assert http_call("POST", f"http://{filer}{path}", body=body)[0] < 300


def _gw_get(filer, path):
    return http_call("GET", f"http://{filer}{path}")


def _run_gateway_case(argv, st, tmp, monkeypatch, capsys):
    """Runs one command of the gateway slice through cli.main against the
    stack and checks what it did."""
    from seaweedfs_tpu_torch.mount import fuse_kernel
    from seaweedfs_tpu_torch.mq.broker_grpc import MqClient
    from seaweedfs_tpu_torch.utils import config as cfg
    cmd = argv[0]
    started = _Started(monkeypatch)
    served = []
    monkeypatch.setattr(cli, "_serve_until_signal",
                        lambda *srv, ready="": served.extend(srv))
    try:
        if cmd == "filer":  # -mq, beside a wire store or the default
            extra = []
            if "-store" in argv:
                import importlib
                family = argv[argv.index("-store") + 1]
                mod = importlib.import_module(
                    f"seaweedfs_tpu_torch.filer.{family}_store")
                db = getattr(mod, {"redis": "MiniRedisServer",
                                   "mongodb": "MiniMongoServer"}[family])()
                db.start()
                served.append(db)
                extra = ["-dir", f"127.0.0.1:{db.port}"]
            cli.main([*argv, *extra, "-master", st.master, "-port",
                      str(_free_ports(1)[0]), "-mqPort", "0"])
            plane = next(s for s in served if type(s).__name__ == "_MqPlane")
            client = MqClient(f"127.0.0.1:{plane.port}", tls=None)
            try:
                assert client.configure_topic("ns", "t", 2) == 2
                acks = client.publish("ns", "t", [(f"k{i}", bytes([i]) * 9)
                                                  for i in range(6)])
                assert len(acks) == 6
                got = sorted(r["value"] for r in client.subscribe("ns", "t"))
                assert got == [bytes([i]) * 9 for i in range(6)]
            finally:
                client.close()
            return
        if cmd in ("mount", "fuse"):
            seen = []

            class Fuse:
                def __init__(self, ops, mountpoint):
                    self.ops, self.mountpoint = ops, mountpoint

                def serve_forever(self, background=False):
                    ino = fuse_kernel.ROOT_ID
                    for name in ("gw", "mount.txt"):
                        attr = self.ops.lookup(ino, name)
                        ino = attr.ino
                    fh = self.ops.open(ino)
                    seen.append(self.ops.read(ino, fh, 0, 100))
                    self.ops.release(ino, fh)
                    nodes = http_json("GET", f"http://{st.master}/cluster/"
                                             f"nodes?type=mount")
                    seen.append(len(nodes["cluster_nodes"]) >= 1)
                    raise KeyboardInterrupt  # as Ctrl-C ends a mount

                def close(self):
                    seen.append("closed")
            monkeypatch.setattr(fuse_kernel, "FuseConnection", Fuse)
            _gw_put(st.f, "/gw/mount.txt", b"read through the mount")
            opts = (["-o", f"filer={st.f},master={st.master}"]
                    if cmd == "fuse" else
                    ["-filer", st.f, "-master", st.master])
            cli.main([*argv, *opts])
            assert seen == [b"read through the mount", True, "closed"]
            return
        if cmd == "filer.sync":
            def both_ways():
                _gw_put(st.f, "/sy/a.txt", b"from f")
                _wait(lambda: _gw_get(st.g, "/sy/a.txt")[1] == b"from f",
                      "f -> g")
                _gw_put(st.g, "/sy/b.txt", b"from g")
                _wait(lambda: _gw_get(st.f, "/sy/b.txt")[1] == b"from g",
                      "g -> f")
            monkeypatch.setattr(cli, "_wait_forever", both_ways)
            cli.main(["filer.sync", "-a", st.f, "-b", st.g])
            assert len(started.daemons) == 2
            return
        if cmd == "filer.backup":
            mirror = tmp / "mirror"
            _gw_put(st.f, "/bk/x/one.bin", b"backed up")
            monkeypatch.setattr(cli, "_wait_forever", lambda: _wait(
                lambda: (mirror / "bk/x/one.bin").exists() and
                (mirror / "bk/x/one.bin").read_bytes() == b"backed up",
                "the mirror"))
            cli.main([*argv, "-filer", st.f, "-filerPath", "/bk",
                      "-dir", str(mirror)])
            return
        if cmd == "filer.replicate":
            out = tmp / "replica"
            (tmp / "replication.toml").write_text(
                f'[sink.local]\nenabled = true\ndirectory = "{out}"\n')
            monkeypatch.setattr(cfg, "SEARCH_PATHS", [str(tmp)])
            for i in range(3):
                _gw_put(st.f, f"/rep/f{i}.txt", b"r" * i)
            _ended_after(3, monkeypatch)  # the three files under /rep
            cli.main([*argv, "-filer", st.f, "-path", "/rep"])
            assert sorted(os.listdir(out / "rep")) == [
                "f0.txt", "f1.txt", "f2.txt"]
            assert (out / "rep" / "f2.txt").read_bytes() == b"rr"
            return
        if cmd == "filer.remote.sync":
            cloud = tmp / "cloud"
            cloud.mkdir()
            base = f"http://{st.f}/__api/remote"
            http_json("POST", f"{base}/configure",
                      {"name": "rs", "type": "local", "root": str(cloud)})
            http_json("POST", f"{base}/mount",
                      {"dir": "/m", "remote_name": "rs"})

            def pushed():
                _gw_put(st.f, "/m/new.txt", b"write back")
                _wait(lambda: (cloud / "new.txt").exists(), "the push")
            monkeypatch.setattr(cli, "_wait_forever", pushed)
            cli.main([*argv, "-filer", st.f])
            assert (cloud / "new.txt").read_bytes() == b"write back"
            return
        if cmd == "filer.remote.gateway":
            cloud = tmp / "gwcloud"
            cloud.mkdir()
            http_json("POST", f"http://{st.f}/__api/remote/configure",
                      {"name": "r", "type": "local", "root": str(cloud)})
            # the bucket created after the gateway starts is the event
            # that ends the patched subscription
            from seaweedfs_tpu_torch.replication import sync
            real_sub = sync.subscribe_meta_events

            def after_start(*a, **kw):
                gen = real_sub(*a, **kw)
                http_call("POST", f"http://{st.f}/buckets/fresh?mkdir=true",
                          body=b"")
                for ev in gen:
                    yield ev
                    if ev and (ev.get("new_entry") or {}).get(
                            "full_path") == "/buckets/fresh":
                        return
            monkeypatch.setattr(sync, "subscribe_meta_events", after_start)
            cli.main([*argv, "-filer", st.f])
            status = http_json("GET", f"http://{st.f}/__api/remote/status")
            assert "/buckets/fresh" in json.dumps(status)
            return
        if cmd == "filer.meta.backup":
            for i in range(3):
                _gw_put(st.f, f"/mb/f{i}.txt", b"m")
            dump = tmp / "meta.jsonl"
            cli.main([*argv, "-filer", st.f, "-filerPath", "/mb",
                      "-o", str(dump)])
            out = json.loads(capsys.readouterr().out.strip())
            assert out == {"events": 3, "file": str(dump)}
            paths = [json.loads(ln)["new_entry"]["full_path"]
                     for ln in dump.read_text().splitlines()]
            assert paths == [f"/mb/f{i}.txt" for i in range(3)]
            return
        assert cmd == "filer.meta.tail", argv
        for i in range(3):
            _gw_put(st.f, f"/mt/f{i}.txt", b"t")
        cli.main([*argv, "-filer", st.f, "-pathPrefix", "/mt", "-n", "3"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert json.loads(lines[-1]) == {"events": 3}
        assert [json.loads(ln)["new_entry"]["full_path"]
                for ln in lines[:-1]] == [f"/mt/f{i}.txt" for i in range(3)]
    finally:
        started.stop()
        for srv in reversed(served):
            srv.stop()


@pytest.mark.parametrize("argv,slice_", [
    # the wire stores with the mq broker in the filer's process
    (["filer", "-store", "redis", "-mq"], "gateway"),
    (["filer", "-store", "mongodb", "-mq"], "gateway"),
    (["filer.meta.tail"], "gateway"),
    (["filer", "-mq"], "gateway"),
    (["mount", "/mnt/x"], "gateway"),
    (["fuse", "/mnt/x"], "gateway"),
    (["filer.sync", "-a", "x", "-b", "y"], "gateway"),
    (["filer.replicate"], "gateway"), (["filer.backup"], "gateway"),
    (["filer.remote.sync", "-dir", "/m"], "gateway"),
    (["filer.remote.gateway", "-remote", "r"], "gateway"),
    (["filer.meta.backup"], "gateway"),
])
def test_what_is_not_ported_raises_before_binding(argv, slice_, gateway_stack,
                                                  tmp_path, monkeypatch,
                                                  capsys):
    """The commands of the gateway slice, which raised NotImplementedError
    before binding until the slice was ported, each run through cli.main
    against a port stack and do their work: the mq broker's gRPC plane in
    the filer's process (beside a wire store too), filer.meta.tail /
    meta.backup of a path's events, a mount and a fuse mount (the kernel
    side stubbed) reading a file of the filer with their admin plane
    announced, filer.sync both ways, filer.backup to a mirror,
    filer.replicate to replication.toml's local sink, filer.remote.sync
    writing back, filer.remote.gateway mounting a new bucket."""
    _run_gateway_case(argv, gateway_stack, tmp_path, monkeypatch, capsys)


def _follower_answers(url, vid, want, timeout=20.0):
    def answered():
        try:
            status, body, _ = http_call(
                "GET", f"http://{url}/dir/lookup?volumeId={vid}", timeout=2)
        except ConnectionError:
            return False
        return status == 200 and [
            loc["url"] for loc in json.loads(body)["locations"]] == want
    _wait(answered, "the follower to answer from its vidMap", timeout)


@pytest.mark.parametrize("argv", [
    ["master", "-grpc"], ["volume", "-grpc", "-device", "cpu"],
    ["server", "-grpc", "-device", "cpu"],
    ["master.follower", "-grpcAddresses"], ["filer", "-grpc"],
    ["filer", "-store", "etcd"]])
def test_grpc_flags_serve_the_grpc_plane(argv, stacks, monkeypatch,
                                         tmp_path):
    """What needed the gRPC plane works: `-grpc` serves each process's
    plane on its port + 10000 (and the volume server advertises it in its
    heartbeat), `master.follower -grpcAddresses` answers lookups from the
    vidMap the masters' KeepConnected stream pushes (its -masters an
    address where nothing listens), and `filer -store etcd` keeps its
    entries in etcd."""
    from seaweedfs_tpu_torch.filer.etcd_store import MiniEtcdServer
    from seaweedfs_tpu_torch.server.filer_grpc import GrpcFilerClient
    from seaweedfs_tpu_torch.server.master_grpc import GrpcMasterClient
    from seaweedfs_tpu_torch.server.volume_grpc import GrpcVolumeClient
    from seaweedfs_tpu_torch.utils import httpd
    s = stacks(PORT, "grpc")
    port, port2 = free_grpc_ports(2)
    cmd = argv[0]
    if cmd == "master":
        cli.main(["master", "-port", str(port), "-grpc"])
        m = s.servers[-1]
        assert m.grpc_port == port + 10000
        client = GrpcMasterClient(f"127.0.0.1:{m.grpc_port}", tls=None)
        try:
            assert client.assign(count=1).error  # no volume server yet
        finally:
            client.close()
        return
    if cmd == "server":
        cli.main(["server", "-masterPort", str(port), "-port", str(port2),
                  "-dir", str(tmp_path / "sv"), "-filer", "-filerPort",
                  str(free_grpc_ports(1)[0]), *argv[1:]])
        vs, fs, m = s.servers
        assert vs.grpc_port == port2 + 10000
        assert fs.grpc_port == fs.http.port + 10000
        return
    m = s.master()
    if cmd == "volume":
        cli.main(["volume", "-port", str(port), "-dir", str(tmp_path / "v"),
                  "-mserver", m.url, *argv[1:]])
        vs = s.servers[-1]
        assert vs.grpc_port == port + 10000
        node = _wait(lambda: m.topo.find_node(vs.url), "the registration")
        assert node.grpc_port == vs.grpc_port
        client = GrpcVolumeClient(f"127.0.0.1:{vs.grpc_port}", tls=None)
        try:
            assert client.ping().stop_time_ns > 0
        finally:
            client.close()
    elif cmd == "master.follower":
        s.volumes(1)
        a = http_json("GET", f"http://{m.url}/dir/assign")
        vid = int(a["fid"].split(",")[0])
        from seaweedfs_tpu_torch.server.master_grpc import start_master_grpc
        server, gport = start_master_grpc(m, tls=None)
        servers, release = [], threading.Event()

        class Recorded(httpd.HttpServer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                servers.append(self)

        monkeypatch.setattr(httpd, "HttpServer", Recorded)
        monkeypatch.setattr(cli, "_wait_forever", lambda: release.wait(60))
        t = threading.Thread(target=cli.main, args=(
            ["master.follower", "-port", str(port), "-masters",
             f"127.0.0.1:{_free_ports(1)[0]}", "-grpcAddresses",
             f"127.0.0.1:{gport}"],))
        t.start()
        try:
            _follower_answers(f"127.0.0.1:{port}", vid, [a["url"]])
        finally:
            release.set()
            t.join(timeout=20)
            for srv in servers:
                srv.stop()
            server.stop(0)
        assert not t.is_alive()
    elif cmd == "filer" and argv[1] == "-grpc":
        cli.main(["filer", "-port", str(port), "-master", m.url, "-grpc"])
        fs = s.servers[-1]
        assert fs.grpc_port == port + 10000
        client = GrpcFilerClient(f"127.0.0.1:{fs.grpc_port}", tls=None)
        try:
            client.kv_put(b"k", b"v")
            assert client.kv_get(b"k") == b"v"
        finally:
            client.close()
    else:
        etcd = MiniEtcdServer().start()
        s.volumes(1)
        try:
            cli.main(["filer", "-port", str(port), "-master", m.url,
                      "-store", "etcd", "-dir", f"127.0.0.1:{etcd.port}"])
            fs = s.servers[-1]
            assert fs.filer.store.name == "etcd"
            status, _, _ = http_call("POST", f"http://{fs.url}/e/f.txt",
                                     body=b"in etcd")
            assert status < 300
            assert any(k.endswith(b"\x00f.txt") for k in etcd._kv)
            assert http_call("GET", f"http://{fs.url}/e/f.txt")[1] == \
                b"in etcd"
        finally:
            s.stop()  # the filer before its etcd
            s.servers.clear()
            etcd.stop()


def test_version_and_scaffold_match_jax(capsys, tmp_path):
    cli.main(["version"])
    jcli.main(["version"])
    got, want = _out(capsys)
    assert json.loads(got) == json.loads(want)
    for name in ("security", "master", "shell"):
        cli.main(["scaffold", "-config", name])
        got = capsys.readouterr().out
        jcli.main(["scaffold", "-config", name])
        assert got == capsys.readouterr().out
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    cli.main(["scaffold", "-config", "master", "-output",
              str(tmp_path / "p")])
    jcli.main(["scaffold", "-config", "master", "-output",
               str(tmp_path / "j")])
    capsys.readouterr()
    assert (tmp_path / "p" / "master.toml").read_bytes() == \
        (tmp_path / "j" / "master.toml").read_bytes()


# ---------------- glog's flag surface ----------------


@pytest.fixture
def clean_glog():
    yield
    glog.reset()
    jglog.reset()


def _log_lines(mod, tmp_path, name, capsys):
    """Drive a package's glog through its cli's flags, then log a line at
    each level from a module named like a server module; return the
    file's lines with the time and thread id cut."""
    logfile = tmp_path / f"{name}.log"
    main = cli.main if mod is glog else jcli.main
    main(["-v", "1", "-vmodule", "volume_*=3", "-logfile", str(logfile),
          "version"])
    capsys.readouterr()
    code = compile(
        "mod.info('info %d', 1)\n"
        "mod.warning('warn %s', 'x')\n"
        "mod.error('err')\n"
        "mod.vlog(1, 'v1 shown')\n"
        "mod.vlog(3, 'v3 shown by -vmodule')\n"
        "mod.vlog(4, 'v4 dropped')\n",
        "volume_server.py", "exec")
    exec(code, {"mod": mod})
    mod.vlog(2, "v2 dropped outside volume_*")
    lines = logfile.read_text().splitlines()
    return [ln[0] + " " + ln.split("] ", 1)[0].rsplit(" ", 1)[1] + "] "
            + ln.split("] ", 1)[1] for ln in lines]


def test_glog_flags_match_jax(tmp_path, capsys, clean_glog):
    got = _log_lines(glog, tmp_path, "port", capsys)
    want = _log_lines(jglog, tmp_path, "jax", capsys)
    assert got == want
    assert [ln.split("] ", 1)[1] for ln in got] == [
        "info 1", "warn x", "err", "v1 shown", "v3 shown by -vmodule"]
    assert got[0].startswith("I volume_server.py:1]")
    assert (glog._verbosity, glog._vmodule) == (1, {"volume_*": 3})


def test_glog_rotation_matches_jax(tmp_path, clean_glog):
    for mod, name in ((glog, "p"), (jglog, "j")):
        path = tmp_path / name / "weed.log"
        path.parent.mkdir()
        mod.set_log_file(str(path), max_bytes=300, also_stderr=False)
        for i in range(13):  # rotates after every third line
            mod.info("line %03d %s", i, "x" * 40)
        mod.reset()
    rotated = {n: sorted(os.listdir(tmp_path / n)) for n in ("p", "j")}
    assert len(rotated["p"]) == len(rotated["j"]) >= 2
    sizes = {n: os.path.getsize(tmp_path / n / "weed.log")
             for n in ("p", "j")}
    assert sizes["p"] == sizes["j"] > 0
    with pytest.raises(SystemExit, match="fatal 7"):
        glog.fatal("fatal %d", 7)


# ---------------- upload / download / delete / benchmark ----------------


def _cli_client_run(pkg, stack, tmp_path, capsys):
    m = stack.master()
    stack.volumes(2)
    src = tmp_path / "hello.txt"
    src.write_bytes(b"cli payload")
    pkg.cli.main(["upload", "-master", m.url, str(src)])
    up = json.loads(_out(capsys)[-1])
    dst = tmp_path / "out.bin"
    pkg.cli.main(["download", "-master", m.url, "-output", str(dst),
                  up["fid"]])
    down = _out(capsys)[-1]
    assert dst.read_bytes() == b"cli payload"
    pkg.cli.main(["delete", "-master", m.url, up["fid"]])
    dele = json.loads(_out(capsys)[-1])
    pkg.cli.main(["benchmark", "-master", m.url, "-n", "20", "-size",
                  "256", "-concurrency", "4"])
    bench = [json.loads(ln) for ln in _out(capsys)]
    return up, down, dele, bench


def test_client_commands_match_jax(stacks, tmp_path, capsys):
    got = _cli_client_run(PORT, stacks(PORT, "port"), tmp_path, capsys)
    want = _cli_client_run(JAX, stacks(JAX, "jax"), tmp_path, capsys)
    (up, down, dele, bench), (jup, jdown, jdele, jbench) = got, want
    assert sorted(up) == sorted(jup) == ["fid", "file", "size"]
    assert up["size"] == jup["size"] == 11
    assert down.replace(up["fid"], "F") == jdown.replace(jup["fid"], "F")
    assert dele == {"fid": up["fid"], "deleted": True}
    assert jdele == {"fid": jup["fid"], "deleted": True}
    assert [b["op"] for b in bench] == [b["op"] for b in jbench] == \
        ["write", "read"]
    for b, jb in zip(bench, jbench):
        assert sorted(b) == sorted(jb)
        assert b["requests_per_sec"] > 0


def test_benchmark_over_tcp(stacks, monkeypatch, tmp_path, capsys):
    s = stacks(PORT, "tcp")
    s.pkg = types.SimpleNamespace(**vars(PORT))
    s.pkg.volume_args = ["-device", "cpu", "-tcp"]
    m = s.master()
    s.volumes(1)
    capsys.readouterr()
    cli.main(["benchmark", "-master", m.url, "-n", "16", "-size", "512",
              "-concurrency", "2", "-useTcp"])
    w, r = [json.loads(ln) for ln in _out(capsys)]
    assert (w["op"], r["op"]) == ("write", "read")
    assert w["transfer_mb_per_sec"] > 0 and r["p99_ms"] >= r["p50_ms"]


# ---------------- ec encode / rebuild / decode ----------------


def _ec_run(pkg, stack, monkeypatch, capsys):
    """Four servers; 24 seeded needles under fixed fids in the one volume
    the master grows; `ec encode`; the server holding the most shards
    stopped and pruned; `ec rebuild`; `ec decode`."""
    for i, mod in enumerate(pkg.random_mods):
        monkeypatch.setattr(mod, "random", random.Random(3 + i))
    m = stack.master()
    servers = stack.volumes(4)
    idx = {vs.url: i for i, vs in enumerate(servers)}
    a = http_json("GET", f"http://{m.url}/dir/assign")
    vid = int(a["fid"].split(",")[0])
    rng = np.random.default_rng(9)
    files = []
    for key in range(1, 25):
        data = rng.integers(0, 256, int(rng.integers(500, 120_000)),
                            dtype=np.uint8).tobytes()
        fid = f"{vid},{key:x}{0x5eed5eed:08x}"
        assert http_call("POST", f"http://{a['url']}/{fid}",
                         body=data)[0] == 201
        files.append((fid, data))
    capsys.readouterr()
    pkg.cli.main(["ec", "encode", "-master", m.url, "-volumeId", str(vid)])
    enc = json.loads(capsys.readouterr().out)
    placement = {idx[t]: s for t, s in enc[0]["placement"].items()}
    root = stack.tmp
    shards = {sid: [(i, _sha(root / f"v{i}" / f"{vid}{layout.shard_ext(sid)}"))
                    for i in range(4)
                    if (root / f"v{i}" / f"{vid}{layout.shard_ext(sid)}")
                    .exists()]
              for sid in range(TOTAL)}
    held = {i: (len(s), 0 in s) for i, s in placement.items()}
    victim = servers[max(held, key=held.get)]
    victim.stop()
    stack.servers.remove(victim)
    live = [vs for vs in servers if vs is not victim]

    def pruned():
        m.topo.prune_dead_nodes(timeout=PRUNE_AFTER_S)
        return len(m.topo.all_nodes()) == len(live)

    _wait(pruned, "the stopped server to be pruned", timeout=PRUNE_AFTER_S + 8)
    pkg.cli.main(["ec", "rebuild", "-master", m.url])
    plans = json.loads(capsys.readouterr().out)
    rb = idx[plans[0]["rebuilder"]]
    rebuilt = {sid: _sha(root / f"v{rb}" / f"{vid}{layout.shard_ext(sid)}")
               for sid in plans[0]["rebuilt"]}
    pkg.cli.main(["ec", "decode", "-master", m.url, "-volumeId", str(vid)])
    dec = json.loads(capsys.readouterr().out)
    col = idx[dec["collector"]]
    bodies = [http_call("GET", f"http://{dec['collector']}/{fid}")[1] == data
              for fid, data in files]
    return {"placement": placement, "shards": shards,
            "victim": idx[victim.url], "rebuilder": rb, "rebuilt": rebuilt,
            "decode": (col, dec["dat_size"]),
            "dat_sha": _sha(root / f"v{col}" / f"{vid}.dat"),
            "bodies": bodies}


def test_ec_commands_match_jax(stacks, monkeypatch, capsys):
    monkeypatch.setattr(time, "time_ns", lambda: FIXED_NS)
    want = _ec_run(JAX, stacks(JAX, "jax"), monkeypatch, capsys)
    got = _ec_run(PORT, stacks(PORT, "port"), monkeypatch, capsys)
    assert got == want
    assert got["bodies"] == [True] * 24
    assert len(got["placement"]) == 4
    original = {sid: v[0][1] for sid, v in got["shards"].items()}
    assert sorted(got["rebuilt"]) == sorted(got["placement"][got["victim"]])
    assert all(original[s] == h for s, h in got["rebuilt"].items())


# ---------------- the REPL ----------------

REPL_SCRIPT = ["lock", "volume.list", "ec.rebuild -n", "ec.balance -n",
               "volume.balance -n", "volume.fix.replication -n",
               "collection.list", "cluster.raft.ps", "ec.repair.status",
               "unlock"]


def _normalise(obj, names):
    """Every url of the stack replaced by its role; the ephemeral ports
    and the fields a clock drives dropped."""
    if isinstance(obj, dict):
        return {names.get(k, k): _normalise(v, names)
                for k, v in obj.items()
                if k not in ("port", "last_seen", "uptime_s",
                             "enqueued_at", "next_attempt", "age_s",
                             "last_heartbeat")}
    if isinstance(obj, list):
        return [_normalise(v, names) for v in obj]
    if isinstance(obj, str):
        for url, role in names.items():
            obj = obj.replace(url, role)
        return obj
    return obj


def _repl_run(pkg, stack, capsys):
    m = stack.master()
    servers = stack.volumes(2)
    names = {m.url: "master"}
    names.update({vs.url: f"vs{i}" for i, vs in enumerate(servers)})
    sh = pkg.Shell(m.url)
    out = [_normalise(pkg.run_command(sh, line), names)
           for line in REPL_SCRIPT]
    with pytest.raises(ValueError):
        pkg.run_command(sh, "bogus.command")
    capsys.readouterr()
    return out


def test_repl_json_matches_jax(stacks, capsys):
    got = _repl_run(PORT, stacks(PORT, "port"), capsys)
    want = _repl_run(JAX, stacks(JAX, "jax"), capsys)
    assert got == want
    assert got[0] == {"locked": True} and got[-1] == {"locked": False}
    assert got[2] == []  # nothing to rebuild


def test_repl_loop_reports_errors_and_continues(monkeypatch, capsys):
    """run_repl prints `error:` for a command that raises and goes on:
    fs.meta.tail with no master to find a filer through, an unknown
    command."""
    from seaweedfs_tpu_torch.shell import repl
    lines = iter(["fs.meta.tail", "bogus.command", "help", "exit"])
    monkeypatch.setattr("builtins.input", lambda prompt: next(lines))
    repl.run_repl("127.0.0.1:1")
    out = capsys.readouterr().out
    assert "error: ConnectionError: GET http://127.0.0.1:1/cluster/nodes" \
        "?type=filer" in out
    assert "error: ValueError: unknown command 'bogus.command'" in out
    assert "ec.rebuild [-n]" in out  # the help text


# ---------------- fix / export / compact / backup ----------------


def _make_volume(directory, vid=1, n=20):
    """The JAX package's Volume writes the files both packages read."""
    v = JVolume(str(directory), "", vid)
    for i in range(n):
        nd = JNeedle(id=i + 1, cookie=5, data=bytes([i % 256]) * (i * 7 + 3),
                     name=f"n{i}.bin".encode())
        nd.set_flags_from_fields()
        v.write_needle(nd)
    v.delete_needle(3)
    v.close()


def _tree(d):
    return {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}


def test_fix_export_compact_match_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(time, "time_ns", lambda: FIXED_NS)
    src = tmp_path / "src"
    src.mkdir()
    _make_volume(src)
    with open(src / "1.dat", "ab") as f:
        f.write(b"\xff" * 10)  # a garbage tail the scan stops at
    for name in ("port", "jax"):
        shutil.copytree(src, tmp_path / name)
        os.remove(tmp_path / name / "1.idx")
    cli.main(["fix", str(tmp_path / "port" / "1")])
    got_fix = json.loads(_out(capsys)[-1])
    jcli.main(["fix", str(tmp_path / "jax" / "1")])
    want_fix = json.loads(_out(capsys)[-1])
    assert got_fix["live_entries"] == want_fix["live_entries"] == 19
    assert got_fix["crc_errors"] == want_fix["crc_errors"] == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    # the rebuilt index is the one the volume wrote
    assert (tmp_path / "port" / "1.idx").read_bytes() != b""

    cli.main(["export", str(tmp_path / "port" / "1"), "-output",
              str(tmp_path / "port_export")])
    jcli.main(["export", str(tmp_path / "jax" / "1"), "-output",
               str(tmp_path / "jax_export")])
    assert [json.loads(ln)["exported"] for ln in _out(capsys)] == [19, 19]
    assert _tree(tmp_path / "port_export") == _tree(tmp_path / "jax_export")

    cli.main(["compact", str(tmp_path / "port" / "1")])
    jcli.main(["compact", str(tmp_path / "jax" / "1")])
    got, want = [json.loads(ln) for ln in _out(capsys)]
    assert got == want and got["after_bytes"] < got["before_bytes"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")

    # a flipped needle body: counted, dropped from the rebuilt index
    for name in ("port", "jax"):
        path = tmp_path / name / "1.dat"
        raw = bytearray(path.read_bytes())
        raw[-40] ^= 0xFF
        path.write_bytes(bytes(raw))
    stats, jstats = {}, {}
    assert maintenance.fix_volume(str(tmp_path / "port" / "1"), stats) == \
        jmaint.fix_volume(str(tmp_path / "jax" / "1"), jstats)
    assert stats == jstats and stats["crc_errors"] == 1
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert [o for o, _ in maintenance.scan_volume_file(
        str(tmp_path / "port" / "1.dat"))] == \
        [o for o, _ in jmaint.scan_volume_file(
            str(tmp_path / "jax" / "1.dat"))]


def test_backup_matches_jax_and_incremental_raises(stacks, tmp_path, capsys):
    s = stacks(PORT, "cluster")
    m = s.master()
    (vs,) = s.volumes(1)
    up = tmp_path / "payload.bin"
    up.write_bytes(os.urandom(50_000))
    cli.main(["upload", "-master", m.url, str(up)])
    vid = int(json.loads(_out(capsys)[-1])["fid"].split(",")[0])
    cli.main(["backup", "-master", m.url, "-volumeId", str(vid), "-output",
              str(tmp_path / "port_bak")])
    jcli.main(["backup", "-master", m.url, "-volumeId", str(vid),
               "-output", str(tmp_path / "jax_bak")])
    got, want = [json.loads(ln) for ln in _out(capsys)]
    assert got["backed_up"] == str(tmp_path / "port_bak" / str(vid))
    assert want["backed_up"] == str(tmp_path / "jax_bak" / str(vid))
    assert _tree(tmp_path / "port_bak") == _tree(tmp_path / "jax_bak")
    vol = vs.store.find_volume(vid)
    vol.sync()
    assert (tmp_path / "port_bak" / f"{vid}.dat").read_bytes() == \
        open(vol.file_name() + ".dat", "rb").read()
    # a second run: this server runs without -grpc and advertises no gRPC
    # port, so it is a full copy again
    assert maintenance.backup_volume(m.url, vid,
                                     str(tmp_path / "port_bak")) == \
        got["backed_up"]
    # the incremental catch-up tails over gRPC: where no plane listens it
    # fails, and backup_volume then copies in full, as the reference does
    # (tests/test_torch_grpc_planes.py runs it against -grpc servers)
    import grpc
    with pytest.raises(grpc.RpcError) as ei:
        maintenance._backup_incremental(str(tmp_path / "port_bak"), "", vid,
                                        got["backed_up"], vs.url,
                                        _free_ports(1)[0])
    assert ei.value.code() == grpc.StatusCode.UNAVAILABLE


# ---------------- master.follower ----------------


def test_master_follower_pull_mode(stacks, monkeypatch, tmp_path, capsys):
    from seaweedfs_tpu_torch.utils import httpd
    s = stacks(PORT, "follower")
    m = s.master()
    s.volumes(1)
    a = http_json("GET", f"http://{m.url}/dir/assign")
    vid = int(a["fid"].split(",")[0])
    servers, release = [], threading.Event()

    class Recorded(httpd.HttpServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(httpd, "HttpServer", Recorded)
    monkeypatch.setattr(cli, "_wait_forever", lambda: release.wait(60))
    port = _free_ports(1)[0]
    t = threading.Thread(target=cli.main, args=(
        ["master.follower", "-port", str(port), "-masters", m.url],))
    t.start()
    try:
        url = f"127.0.0.1:{port}"

        def up():
            try:
                return http_call("GET", f"http://{url}/cluster/status",
                                 timeout=2)[0] == 200
            except ConnectionError:
                return False

        _wait(up, "the follower to serve")
        out = http_json("GET", f"http://{url}/dir/lookup?volumeId={vid}")
        assert [loc["url"] for loc in out["locations"]] == [a["url"]]
        st = http_json("GET", f"http://{url}/cluster/status")
        assert st == {"IsLeader": False, "Leader": m.url, "Peers": []}
        status, body, _ = http_call("GET", f"http://{url}/dir/assign")
        assert status == 409 and json.loads(body)["leader"] == m.url
        status, _, _ = http_call("GET",
                                 f"http://{url}/dir/lookup?volumeId=999")
        assert status == 404
    finally:
        release.set()
        t.join(timeout=20)
        for srv in servers:
            srv.stop()
    assert not t.is_alive()


# ---------------- a `weed volume` process ----------------


def test_volume_process_registers_and_drains_on_sigterm(tmp_path):
    """`python -m seaweedfs_tpu_torch.cli volume -device cpu` starts,
    registers with the master, and on SIGTERM announces its drain and
    exits 0."""
    m = master.MasterServer()
    m.start()
    port = _free_ports(1)[0]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "volume",
         "-device", "cpu", "-port", str(port), "-dir", str(tmp_path / "v"),
         "-mserver", m.url], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout))
    reader.start()
    ready = f"volume server listening on 127.0.0.1:{port}"
    try:
        node = _wait(lambda: next(iter(m.topo.all_nodes()), None),
                     "the volume process to register", timeout=60)
        assert node.url == f"127.0.0.1:{port}"
        assert not node.draining
        # the line comes once its SIGTERM hook is in place
        _wait(lambda: any(ln.startswith(ready) for ln in lines),
              "the volume process's ready line", timeout=60)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, "".join(lines)
        assert node.draining  # the final heartbeat announced the drain
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(timeout=10)
        m.stop()
    assert not reader.is_alive()
