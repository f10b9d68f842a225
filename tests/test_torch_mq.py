"""The port's mq broker (mq/broker.py, mq/broker_grpc.py) held against the
JAX package's: topic configure / list, streamed publish acks, replay and
live tail, binary values, segment overflow and flush order, the tail's
overflow and its per-topic eviction, broker load, the shell's
mq.topic.list and `filer -mq`'s plane stopping with its segments flushed;
across the packages: each package's MqClient against the other's broker,
with equal acks and records, and a topic's filer segments written by one
package's broker replayed by the other's. The port's volume servers run
with device="cpu".
(ref tests/test_mq_grpc.py, test_misc_parity.py's mq case,
test_proto_planes.py's proto count.)
"""

import collections
import threading
import time
import types

import numpy as np
import pytest

import seaweedfs_tpu.mq.broker as j_broker
import seaweedfs_tpu.mq.broker_grpc as j_broker_grpc
from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu.server.master import MasterServer as JMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
import seaweedfs_tpu_torch.mq.broker as broker_mod
import seaweedfs_tpu_torch.mq.broker_grpc as p_broker_grpc
from seaweedfs_tpu_torch.mq.broker import Broker, MqTailOverflow
from seaweedfs_tpu_torch.mq.broker_grpc import MqClient, start_broker_grpc
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer


def _port_vs(dirs, master_url, **kw):
    return VolumeServer(dirs, master_url, device="cpu", **kw)


PORT = types.SimpleNamespace(Master=MasterServer, VS=_port_vs,
                             Filer=FilerServer, broker=broker_mod,
                             grpc=p_broker_grpc)
JAX = types.SimpleNamespace(Master=JMaster, VS=JVolumeServer,
                            Filer=JFilerServer, broker=j_broker,
                            grpc=j_broker_grpc)


class _MqStack:
    """A master, a volume server and a filer of `pkg`, and its broker
    serving the gRPC plane on a free port."""

    def __init__(self, pkg, root):
        self.master = pkg.Master(volume_size_limit_mb=64)
        self.master.start()
        self.vs = pkg.VS([str(root / "v")], self.master.url)
        self.vs.start()
        self.fs = pkg.Filer(self.master.url)
        self.fs.start()
        time.sleep(0.1)
        self.broker = pkg.broker.Broker(self.fs)
        self.server, self.port = pkg.grpc.start_broker_grpc(
            self.broker, port=0, tls=None)

    def stop(self):
        self.server.stop(grace=None)
        for srv in (self.fs, self.vs, self.master):
            srv.stop()


@pytest.fixture
def mq(tmp_path):
    st = _MqStack(PORT, tmp_path)
    client = MqClient(f"127.0.0.1:{st.port}", tls=None)
    yield st.broker, client
    client.close()
    st.stop()


def test_configure_publish_subscribe(mq):
    broker, client = mq
    assert client.configure_topic("chat", "events", 2) == 2
    assert client.configure_topic("chat", "events", 8) == 2  # idempotent
    acks = client.publish("chat", "events",
                          [(f"k{i}", f"v{i}".encode()) for i in range(20)])
    assert len(acks) == 20 and acks == sorted(acks) and len(set(acks)) == 20
    records = list(client.subscribe("chat", "events"))
    assert sorted(r["value"] for r in records) == sorted(
        f"v{i}".encode() for i in range(20))
    parts = {r["key"]: r["partition"] for r in records}
    assert len(client.publish("chat", "events", [("k3", b"again")])) == 1
    again = [r for r in client.subscribe("chat", "events")
             if r["value"] == b"again"]
    assert again[0]["partition"] == parts["k3"]
    load = client.broker_load()
    assert load["message_count"] == 21 and load["bytes_count"] > 21 * 30
    assert client.list_topics() == [
        {"namespace": "chat", "topic": "events", "partition_count": 2}]


def test_empty_record_first_in_stream_is_published(mq):
    broker, client = mq
    client.configure_topic("e", "t", 1)
    assert len(client.publish("e", "t", [("", b"")])) == 1
    [rec] = list(client.subscribe("e", "t"))
    assert rec["key"] == "" and rec["value"] == b""


def test_publish_unknown_topic_errors(mq):
    broker, client = mq
    with pytest.raises(RuntimeError, match="not found"):
        client.publish("nope", "missing", [("k", b"v")])


def test_binary_values_roundtrip(mq):
    broker, client = mq
    client.configure_topic("bin", "blobs", 1)
    payload = bytes(range(256))
    client.publish("bin", "blobs", [("k", payload)])
    broker.flush()  # the JSONL segment path, not the live ring
    [rec] = list(client.subscribe("bin", "blobs"))
    assert rec["value"] == payload


def test_segment_overflow_autoflush(mq, monkeypatch):
    broker, client = mq
    monkeypatch.setattr(broker_mod, "SEGMENT_MAX_BYTES", 8 * 1024)
    client.configure_topic("big", "stream", 1)
    payload = b"x" * 1024
    acks = client.publish("big", "stream",
                          [(f"k{i}", payload) for i in range(40)])
    assert len(acks) == 40
    segs = broker.filer.list_entries("/topics/big/stream/p00", limit=100)
    assert len(segs) >= 2
    recs = list(client.subscribe("big", "stream"))
    assert sorted(r["key"] for r in recs) == sorted(
        f"k{i}" for i in range(40))
    assert all(r["value"] == payload for r in recs)


def test_live_tail_sees_replay_then_new_records(mq):
    broker, client = mq
    client.configure_topic("t", "tail", 1)
    client.publish("t", "tail", [("a", b"old1"), ("a", b"old2")])
    broker.flush()
    client.publish("t", "tail", [("a", b"old3")])
    got, done = [], threading.Event()

    def consume():
        for rec in client.subscribe("t", "tail", tail=True, timeout=30):
            got.append(rec)
            if len(got) == 5:
                break
        done.set()

    threading.Thread(target=consume, daemon=True).start()
    deadline = time.time() + 10
    while len(got) < 3 and time.time() < deadline:
        time.sleep(0.05)
    assert [r["value"] for r in got] == [b"old1", b"old2", b"old3"]
    assert all(r["seq"] == 0 for r in got)
    client.publish("t", "tail", [("a", b"new1"), ("a", b"new2")])
    assert done.wait(10)
    assert [r["value"] for r in got[3:]] == [b"new1", b"new2"]
    assert all(r["seq"] > 0 for r in got[3:])


def test_flush_names_assigned_at_pop_order(mq):
    broker, client = mq
    client.configure_topic("o", "t", 1)
    broker.publish("o", "t", "k", "first")
    a = broker._begin_flush("o/t", 0)
    broker.publish("o", "t", "k", "second")
    b = broker._begin_flush("o/t", 0)
    assert a[0] < b[0]
    broker._complete_flush("o", "t", 0, *b)
    broker._complete_flush("o", "t", 0, *a)
    assert [r["value"] for r in broker.subscribe("o", "t")] == [
        "first", "second"]


def test_tail_overflow_raises_not_skips(mq):
    broker, client = mq
    client.configure_topic("lag", "t", 1)
    broker._recent = collections.deque(broker._recent, maxlen=8)
    gen = broker.subscribe("lag", "t", tail=True)
    broker.publish("lag", "t", "k", "v0")
    assert next(gen)["value"] == "v0"
    for _ in range(12):
        broker.publish("lag", "t", "k", "v")
    with pytest.raises(MqTailOverflow):
        next(gen)


def test_tail_survives_foreign_topic_churn(mq):
    broker, client = mq
    client.configure_topic("quiet", "t", 1)
    client.configure_topic("busy", "t", 1)
    broker._recent = collections.deque(broker._recent, maxlen=8)
    gen = broker.subscribe("quiet", "t", tail=True)
    broker.publish("quiet", "t", "k", "q0")
    assert next(gen)["value"] == "q0"
    for _ in range(20):
        broker.publish("busy", "t", "k", "noise")
    broker.publish("quiet", "t", "k", "q1")
    assert next(gen)["value"] == "q1"


def test_shell_mq_topic_list(mq):
    from seaweedfs_tpu_torch.shell.commands import ShellContext
    from seaweedfs_tpu_torch.shell.repl import run_command
    broker, client = mq
    client.configure_topic("ns1", "orders", 4)
    out = run_command(ShellContext(broker.fs.master_url), "mq.topic.list")
    assert {"namespace": "ns1", "topic": "orders",
            "partition_count": 4} in out["topics"]


def test_mq_broker(tmp_path):
    st = _MqStack(PORT, tmp_path)
    try:
        b = Broker(st.fs)
        b.create_topic("chat", "events", partition_count=2)
        for i in range(10):
            b.publish("chat", "events", key=f"user{i % 3}", value={"seq": i})
        b.flush()
        records = list(b.read_topic("chat", "events"))
        assert sorted(r["value"]["seq"] for r in records) == list(range(10))
        assert b.publish("chat", "events", "stable-key", "x") == \
            b.publish("chat", "events", "stable-key", "y")
    finally:
        st.stop()


def test_proto_planes_all_present():
    """Every reference proto surface has its stub in the port (master,
    volume_server, filer, remote, iam, s3, mount, mq, etcdkv)."""
    import pathlib

    import seaweedfs_tpu_torch.pb as pb_pkg
    pb_dir = pathlib.Path(pb_pkg.__file__).parent
    protos = {p.stem for p in pb_dir.glob("*.proto")}
    assert {"master", "volume_server", "filer", "remote", "iam", "s3",
            "mount", "mq", "etcdkv"} == protos
    for name in protos:
        assert (pb_dir / f"{name}_pb2.py").exists()


def test_filer_mq_plane_flushes_on_stop(tmp_path, monkeypatch):
    """`filer -mq` stops its broker plane before the filer and flushes
    the open segments into it (the reference's process exits with them
    in memory): a broker started again over the same filer replays
    every record."""
    from seaweedfs_tpu_torch import cli
    from torch_ports import free_grpc_ports
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _port_vs([str(tmp_path / "v")], master.url)
    vs.start()
    served = []
    monkeypatch.setattr(cli, "_serve_until_signal",
                        lambda *srv, ready="": served.extend(srv))
    try:
        cli.main(["filer", "-mq", "-mqPort", "0", "-master", master.url,
                  "-port", str(free_grpc_ports(1)[0]), "-store", "lsm",
                  "-dir", str(tmp_path / "f")])
        plane, fs = served
        client = MqClient(f"127.0.0.1:{plane.port}", tls=None)
        client.configure_topic("keep", "t", 2)
        client.publish("keep", "t", [(f"k{i}", b"kept") for i in range(9)])
        client.close()
        plane.stop()
        assert len(list(Broker(fs).subscribe("keep", "t"))) == 9
    finally:
        for srv in served[1:]:
            srv.stop()
        vs.stop()
        master.stop()


# ---------------- across the packages ----------------


def _records(seed, n=60):
    rng = np.random.default_rng(seed)
    return [(f"key{int(rng.integers(5))}", rng.bytes(int(rng.integers(0,
                                                                      300))))
            for _ in range(n)]


@pytest.mark.parametrize("client_pkg,broker_pkg", [("port", "jax"),
                                                   ("jax", "port")])
def test_clients_and_brokers_across_packages(client_pkg, broker_pkg,
                                             tmp_path):
    """Each package's MqClient against the other's broker: the same
    partition count, acks, per-partition replay and load as against a
    broker of its own package."""
    pkgs = {"port": PORT, "jax": JAX}
    recs = _records(3)
    seen = {}
    for bp in (broker_pkg, client_pkg):
        st = _MqStack(pkgs[bp], tmp_path / bp)
        client = pkgs[client_pkg].grpc.MqClient(f"127.0.0.1:{st.port}",
                                                tls=None)
        try:
            parts = client.configure_topic("x", "y", 3)
            acks = client.publish("x", "y", recs)
            replay = {p: [(r["key"], r["value"]) for r in
                          client.subscribe("x", "y", partition=p)]
                      for p in range(parts)}
            seen[bp] = (parts, acks, replay, client.broker_load(),
                        client.list_topics())
        finally:
            client.close()
            st.stop()
    assert seen[broker_pkg] == seen[client_pkg]
    parts, acks, replay, _, _ = seen[broker_pkg]
    assert acks == list(range(1, len(recs) + 1))
    assert sorted(sum(replay.values(), [])) == sorted(recs)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_segments_replay_across_packages(writer, reader, tmp_path):
    """Segments one package's broker flushed into a filer replay through
    the other package's broker over the same filer, record for record."""
    pkgs = {"port": PORT, "jax": JAX}
    st = _MqStack(pkgs[writer], tmp_path)
    try:
        recs = _records(5, 40)
        for key, value in recs:
            st.broker.ensure_topic("s", "t", 2)
            st.broker.publish("s", "t", key, value)
        st.broker.flush()
        want = [(r["partition"], r["key"], r["value"])
                for r in st.broker.subscribe("s", "t")]
        other = pkgs[reader].broker.Broker(st.fs)
        got = [(r["partition"], r["key"], r["value"])
               for r in other.subscribe("s", "t")]
        assert got == want and len(got) == len(recs)
    finally:
        st.stop()
