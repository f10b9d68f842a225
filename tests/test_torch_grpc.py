"""The port's master gRPC plane (server/master_grpc.py, client/wdclient.py's
push mode) held against the JAX package's: the streaming heartbeat
registers and unregisters a node, assign and the lookups answer, the
KeepConnected stream carries a snapshot and then deltas, and a
MasterClient in push mode serves lookups from its vidMap. One scripted
sequence of RPCs gets equal responses from a port stack and an all-JAX
stack (addresses and file-id cookies aside), and each package's clients
work against the other package's master. Servers listen on ports the OS
picks; every RPC and wait carries its own timeout.
(ref tests/test_grpc.py.)"""

import queue
import threading
import time

import grpc
import pytest

from seaweedfs_tpu.client.wdclient import MasterClient as JMasterClient
from seaweedfs_tpu.pb import master_pb2 as jpb
from seaweedfs_tpu.server import master_grpc as jmgrpc
from seaweedfs_tpu.server.master import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu_torch.client.wdclient import MasterClient
from seaweedfs_tpu_torch.pb import master_pb2 as pb
from seaweedfs_tpu_torch.server import master_grpc as mgrpc
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

PKG = {
    "port": dict(master=MasterServer, grpc=mgrpc, pb=pb,
                 volume=lambda d, m: VolumeServer(d, m, device="cpu"),
                 client=MasterClient),
    "jax": dict(master=JMasterServer, grpc=jmgrpc, pb=jpb,
                volume=JVolumeServer, client=JMasterClient),
}


def _wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class _Stack:
    """A master with its gRPC plane on an OS-picked port and one volume
    server, both of one package."""

    def __init__(self, pkg, tmp_path):
        p = PKG[pkg]
        self.master = p["master"]()
        self.master.start()
        self.vs = p["volume"]([str(tmp_path / f"v_{pkg}")], self.master.url)
        self.vs.start()
        self.server, self.grpc_port = p["grpc"].start_master_grpc(
            self.master)
        self.master.grpc_port = self.grpc_port
        self.addr = f"127.0.0.1:{self.grpc_port}"

    def stop(self):
        self.server.stop(0)
        self.vs.stop()
        self.master.stop()


@pytest.fixture
def stacks(tmp_path):
    made = {}

    def make(pkg):
        made[pkg] = _Stack(pkg, tmp_path)
        return made[pkg]
    yield make
    for s in made.values():
        s.stop()


@pytest.fixture
def grpc_master(stacks):
    s = stacks("port")
    client = mgrpc.GrpcMasterClient(s.addr)
    yield s.master, s.vs, client
    client.close()


def test_grpc_assign_and_lookup(grpc_master):
    master, vs, client = grpc_master
    res = client.assign(count=1)
    assert res.fid and not res.error
    assert res.location.url == vs.url
    vid = res.fid.split(",")[0]
    lk = client.lookup_volume([vid])
    assert lk.volume_id_locations[0].locations[0].url == vs.url
    lk2 = client.lookup_volume(["9999"])
    assert lk2.volume_id_locations[0].error


def _bounded(call, timeout=30.0):
    """Cancel the streaming call after `timeout` seconds: a stream that
    stops answering fails the test instead of hanging it."""
    timer = threading.Timer(timeout, call.cancel)
    timer.daemon = True
    timer.start()
    return call


def _beats(q):
    while True:
        item = q.get(timeout=30)
        if item is None:
            return
        yield item


def test_grpc_streaming_heartbeat_registers_and_unregisters(grpc_master):
    master, vs, client = grpc_master
    q: "queue.Queue" = queue.Queue()
    hb = pb.Heartbeat(ip="10.9.9.9", port=7777, rack="rz",
                      data_center="dcz", max_volume_count=5)
    hb.volumes.add(id=77, size=100, version=3)
    responses = _bounded(client.heartbeat_stream(_beats(q)))
    q.put(hb)
    first = next(responses)
    assert first.volume_size_limit > 0 and first.leader == master.url
    assert master.topo.find_node("10.9.9.9:7777") is not None
    assert [n.id for n in master.topo.lookup("", 77)] == ["10.9.9.9:7777"]

    delta = pb.Heartbeat(ip="10.9.9.9", port=7777, is_delta=True)
    delta.new_ec_shards.add(id=88, ec_index_bits=0b11)
    q.put(delta)
    next(responses)
    shards = master.topo.lookup_ec_shards(88)
    assert [n.id for n in shards[0]] == ["10.9.9.9:7777"]

    q.put(None)  # closing the stream unregisters the node
    _wait(lambda: master.topo.find_node("10.9.9.9:7777") is None,
          "the node to be unregistered", timeout=5)
    assert master.topo.lookup("", 77) == []


def _drain_until(stream, pred, timeout=5.0):
    resps = []
    deadline = time.monotonic() + timeout
    it = iter(stream)
    while time.monotonic() < deadline:
        try:
            resps.append(next(it))
        except (StopIteration, grpc.RpcError):
            break
        if pred(resps):
            return resps
    return resps


def _has(field, vid):
    return lambda resps: any(
        vid in getattr(r.volume_location, field) for r in resps
        if r.HasField("volume_location"))


def test_keep_connected_snapshot_and_deltas(grpc_master):
    master, vs, client = grpc_master
    vid = int(client.assign(count=1).fid.split(",")[0])
    stream = _bounded(client.keep_connected("filer", "127.0.0.1:8888"))
    try:
        assert _has("new_vids", vid)(_drain_until(stream,
                                                  _has("new_vids", vid)))
        _wait(lambda: ("filer", "127.0.0.1:8888") in master._cluster_nodes,
              "the filer's membership")
        node = master.topo.sync_data_node_registration({
            "ip": "10.1.1.1", "port": 8080, "public_url": "10.1.1.1:8080",
            "max_volume_count": 5,
            "volumes": [{"id": 4242, "size": 10, "version": 3}],
            "ec_shards": []})
        assert _has("new_vids", 4242)(_drain_until(stream,
                                                   _has("new_vids", 4242)))
        master.topo.unregister_data_node(node)
        assert _has("deleted_vids", 4242)(
            _drain_until(stream, _has("deleted_vids", 4242)))
    finally:
        stream.cancel()


@pytest.mark.parametrize("client_pkg,master_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_wdclient_push_mode_vidmap(stacks, client_pkg, master_pkg):
    """A MasterClient in push mode fills its vidMap from KeepConnected and
    serves lookups from it, across packages both ways."""
    s = stacks(master_pkg)
    res = PKG[master_pkg]["grpc"].GrpcMasterClient(s.addr)
    try:
        vid = int(res.assign(count=1).fid.split(",")[0])
    finally:
        res.close()
    mc = PKG[client_pkg]["client"](s.master.url, grpc_address=s.addr)
    try:
        _wait(lambda: vid in mc._vidmap, "the pushed vidMap")
        locs = mc.lookup_volume(vid)
        assert locs and locs[0]["url"] == s.vs.url
    finally:
        mc.stop()


def test_push_mode_moves_past_a_dead_master(stacks):
    """Given a dead address first, the push loop moves on to the next and
    fills the map; stop() ends the loop."""
    s = stacks("port")
    vid = int(s.master.assign_fid()["fid"].split(",")[0])
    import socket
    with socket.socket() as sock:  # a port where nothing listens
        sock.bind(("127.0.0.1", 0))
        dead_port = sock.getsockname()[1]
    mc = MasterClient(s.master.url, grpc_address=[
        f"127.0.0.1:{dead_port}", s.addr])
    try:
        _wait(lambda: vid in mc._vidmap, "the vidMap from the live master",
              timeout=15)
    finally:
        mc.stop()
    assert not mc._kc_thread.is_alive()


def _script(pkg: str, s: _Stack) -> list:
    """One sequence of RPCs on a fresh stack; addresses replaced by roles,
    file ids cut to their volume id."""
    p = PKG[pkg]
    client = p["grpc"].GrpcMasterClient(s.addr)
    names = {s.master.url: "<master>", s.vs.url: "<volume>"}

    def norm(msg) -> str:
        text = str(msg)
        for url, role in names.items():
            text = text.replace(url, role)
        return text

    out = []
    try:
        a = client.assign(count=3)
        out.append((a.fid.split(",")[0], a.count, norm(a.location),
                    [norm(r) for r in a.replicas], a.error))
        vid = a.fid.split(",")[0]
        out.append(norm(client.lookup_volume([vid, "9999",
                                              f"{vid},1deadbeef"])))
        with pytest.raises(grpc.RpcError) as ei:
            client.lookup_ec_volume(4242)
        out.append((ei.value.code(), ei.value.details()))
        q: "queue.Queue" = queue.Queue()
        hb = p["pb"].Heartbeat(ip="10.9.9.9", port=7777, rack="rz",
                               data_center="dcz", max_volume_count=5)
        hb.volumes.add(id=77, size=100, version=3, collection="c")
        responses = _bounded(client.heartbeat_stream(_beats(q)))
        q.put(hb)
        out.append(norm(next(responses)))
        delta = p["pb"].Heartbeat(ip="10.9.9.9", port=7777, is_delta=True)
        delta.new_ec_shards.add(id=88, ec_index_bits=0b101, collection="c")
        q.put(delta)
        out.append(norm(next(responses)))
        out.append(norm(client.lookup_ec_volume(88)))
        out.append(norm(client.lookup_volume(["77"], collection="c")))
        for method, req, resp in (
                ("Statistics", "StatisticsRequest", "StatisticsResponse"),
                ("CollectionList", "CollectionListRequest",
                 "CollectionListResponse"),
                ("GetMasterConfiguration", "GetMasterConfigurationRequest",
                 "GetMasterConfigurationResponse")):
            out.append((method, norm(client._call(
                method, getattr(p["pb"], req)(), getattr(p["pb"], resp)))))
        out.append(client.ec_repair_status()["queue"])
        q.put(None)
        _wait(lambda: s.master.topo.find_node("10.9.9.9:7777") is None,
              "the streamed node to leave")
    finally:
        client.close()
    return out


def test_responses_match_jax(stacks):
    """The same RPC script against a port stack and a JAX stack: equal
    responses, field by field."""
    got = _script("port", stacks("port"))
    want = _script("jax", stacks("jax"))
    assert got == want


@pytest.mark.parametrize("client_pkg,master_pkg", [("jax", "port"),
                                                   ("port", "jax")])
def test_clients_interoperate(stacks, client_pkg, master_pkg):
    """Each package's GrpcMasterClient against the other's master: assign,
    lookups, a heartbeat stream and the JSON repair RPCs."""
    s = stacks(master_pkg)
    p = PKG[client_pkg]
    client = p["grpc"].GrpcMasterClient(s.addr)
    try:
        res = client.assign(count=1)
        assert res.fid and res.location.url == s.vs.url
        vid = res.fid.split(",")[0]
        lk = client.lookup_volume([vid])
        assert lk.volume_id_locations[0].locations[0].url == s.vs.url
        q: "queue.Queue" = queue.Queue()
        responses = _bounded(client.heartbeat_stream(_beats(q)))
        q.put(p["pb"].Heartbeat(ip="10.7.7.7", port=7000,
                                max_volume_count=3))
        assert next(responses).leader == s.master.url
        assert s.master.topo.find_node("10.7.7.7:7000") is not None
        q.put(None)
        assert "queue" in client.ec_repair_status()
    finally:
        client.close()
