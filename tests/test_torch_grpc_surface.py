"""The rest of the port's gRPC surface held against the JAX package's:
the vendored protos and their descriptors (byte-identical, the same
weedtpu_* packages, so one process loads both packages' stubs and the
two stacks speak one wire protocol), the filer's pure-gRPC write path
(AssignVolume → HTTP data POST → CreateEntry → LookupVolume), filer
Statistics / configuration / AppendToEntry / collections / Ping /
SubscribeLocalMetadata, the volume server's file and needle status,
Ping, VolumeTailSender, VolumeIncrementalCopy, replica catch-up through
VolumeTailReceiver (from a port and from a JAX peer), the master's admin
RPCs, the Query RPC, and the remote-storage protos a filer with a gRPC
plane persists. Every RPC and wait carries its own timeout.
(ref tests/test_grpc_surface.py, the cases of tests/test_proto_planes.py
that need no gateway module.)"""

import hashlib
import json
import pathlib
import time

import pytest

import seaweedfs_tpu.pb as jpb_pkg
import seaweedfs_tpu_torch.pb as pb_pkg
from seaweedfs_tpu.pb import filer_pb2 as jfpb
from seaweedfs_tpu.pb import master_pb2 as jmpb
from seaweedfs_tpu.pb import volume_server_pb2 as jvpb
from seaweedfs_tpu.server.master import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu_torch.pb import etcdkv_pb2, remote_pb2
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.pb import master_pb2 as mpb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
from seaweedfs_tpu_torch.server.filer_grpc import GrpcFilerClient
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_grpc import GrpcVolumeClient
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils.httpd import http_call, http_json

PORTED_PROTOS = ("master", "volume_server", "filer", "etcdkv", "remote",
                 "s3", "iam", "mount", "mq")


@pytest.fixture
def stack(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, grpc_port=0,
                      device="cpu")
    vs.start()
    fs = FilerServer(master.url, grpc_port=0)
    fs.start()
    time.sleep(0.1)
    fclient = GrpcFilerClient(f"127.0.0.1:{fs.grpc_port}")
    vclient = GrpcVolumeClient(f"127.0.0.1:{vs.grpc_port}")
    yield master, vs, fs, fclient, vclient
    fclient.close()
    vclient.close()
    fs.stop()
    vs.stop()
    master.stop()


def test_proto_packages_renamed():
    assert fpb.DESCRIPTOR.package == "weedtpu_filer_pb"
    assert mpb.DESCRIPTOR.package == "weedtpu_master_pb"
    assert vpb.DESCRIPTOR.package == "weedtpu_volume_server_pb"
    assert etcdkv_pb2.DESCRIPTOR.package == "etcdserverpb"


@pytest.mark.parametrize("name", PORTED_PROTOS)
def test_protos_and_stubs_are_the_jax_packages(name):
    """Each ported .proto and _pb2.py is the JAX package's byte for byte,
    and both packages' modules describe one file in protobuf's pool."""
    import importlib
    port_dir = pathlib.Path(pb_pkg.__file__).parent
    jax_dir = pathlib.Path(jpb_pkg.__file__).parent
    for ext in (".proto", "_pb2.py"):
        assert (port_dir / f"{name}{ext}").read_bytes() == \
            (jax_dir / f"{name}{ext}").read_bytes()
    mine = importlib.import_module(f"seaweedfs_tpu_torch.pb.{name}_pb2")
    theirs = importlib.import_module(f"seaweedfs_tpu.pb.{name}_pb2")
    assert mine.DESCRIPTOR.serialized_pb == theirs.DESCRIPTOR.serialized_pb
    assert mine.DESCRIPTOR.name == theirs.DESCRIPTOR.name


def test_messages_cross_the_packages():
    """A message serialized by one package's stubs parses in the other's
    to the same fields."""
    hb = mpb.Heartbeat(ip="10.0.0.1", port=8080, rack="r1",
                       max_volume_count=7, is_delta=True)
    hb.volumes.add(id=3, size=99, collection="c", version=3)
    hb.new_ec_shards.add(id=4, ec_index_bits=0b1011)
    back = jmpb.Heartbeat.FromString(hb.SerializeToString())
    assert str(back) == str(hb)
    req = jvpb.VolumeEcShardsCopyRequest(volume_id=9, shard_ids=[1, 12],
                                         copy_ecx_file=True,
                                         source_data_node="a:1")
    assert str(vpb.VolumeEcShardsCopyRequest.FromString(
        req.SerializeToString())) == str(req)
    e = fpb.Entry(name="n", content=b"c")
    e.chunks.add(file_id="1,ab", size=3)
    back = jfpb.Entry.FromString(e.SerializeToString())
    assert str(back) == str(e)
    assert back.SerializeToString() == e.SerializeToString()


def test_pure_grpc_write_path(stack):
    """A client that speaks only gRPC for metadata: AssignVolume → HTTP
    data POST → CreateEntry → LookupDirectoryEntry + LookupVolume."""
    master, vs, fs, fc, vc = stack
    a = fc.assign_volume(count=1, path="/docs/hello.txt")
    assert a.file_id and a.url
    payload = b"written through the grpc metadata plane"
    status, _, _ = http_call("POST", f"http://{a.url}/{a.file_id}",
                             body=payload)
    assert status == 201
    entry = fpb.Entry(name="hello.txt")
    entry.chunks.append(fpb.FileChunk(
        file_id=a.file_id, offset=0, size=len(payload),
        mtime=time.time_ns()))
    entry.attributes.file_size = len(payload)
    entry.attributes.file_mode = 0o644
    entry.attributes.mtime = int(time.time())
    fc.create_entry("/docs", entry)
    got = fc.lookup("/docs", "hello.txt")
    assert got.name == "hello.txt" and got.chunks[0].file_id == a.file_id
    vid = a.file_id.split(",")[0]
    locs = fc.lookup_volume([vid])
    assert vid in locs and locs[vid]
    status, body, _ = http_call("GET", f"http://{locs[vid][0]}/{a.file_id}")
    assert status == 200 and body == payload
    status, body, _ = http_call("GET", f"http://{fs.url}/docs/hello.txt")
    assert status == 200 and body == payload


def test_filer_statistics_and_configuration(stack):
    master, vs, fs, fc, vc = stack
    a = fc.assign_volume()
    http_call("POST", f"http://{a.url}/{a.file_id}", body=b"x" * 4096)
    vs.heartbeat_once()
    st = fc.statistics()
    assert st.total_size > 0
    conf = fc.get_configuration()
    assert list(conf.masters) == [master.url]


def _put(master, data):
    a = http_json("GET", f"http://{master.url}/dir/assign")
    status, _, _ = http_call("POST", f"http://{a['url']}/{a['fid']}",
                             body=data)
    assert status == 201
    return a["fid"]


def test_volume_file_and_needle_status(stack):
    master, vs, fs, fc, vc = stack
    fid = _put(master, b"status-check-payload")
    vid = int(fid.split(",")[0])
    st = vc.read_volume_file_status(vid)
    assert st.volume_id == vid and st.file_count == 1
    assert st.dat_file_size > 0 and st.idx_file_size > 0
    assert st.last_append_at_ns > 0
    key = int(fid.split(",")[1][:-8], 16)
    ns = vc.volume_needle_status(vid, key)
    assert ns.needle_id == key and ns.size == len(b"status-check-payload")
    with pytest.raises(Exception):
        vc.volume_needle_status(vid, 0xDEAD)


def test_ping(stack):
    master, vs, fs, fc, vc = stack
    p = vc.ping()
    assert p.stop_time_ns >= p.start_time_ns
    p2 = vc.ping(target=master.url, target_type="master")
    assert p2.remote_time_ns >= p2.start_time_ns


def test_tail_sender_and_incremental_copy(stack):
    master, vs, fs, fc, vc = stack
    t0 = time.time_ns()
    fids = [_put(master, f"tail-{i}".encode() * 10) for i in range(5)]
    vid = int(fids[0].split(",")[0])
    needles = list(vc.volume_tail_needles(vid, since_ns=0))
    assert len(needles) == 5
    assert all(n.append_at_ns > t0 for n in needles)
    datas = {bytes(n.data) for n in needles}
    assert b"tail-0" * 10 in datas and b"tail-4" * 10 in datas
    last = max(n.append_at_ns for n in needles)
    assert list(vc.volume_tail_needles(vid, since_ns=last)) == []
    raw = vc.volume_incremental_copy(vid, since_ns=0)
    assert len(raw) > sum(len(f"tail-{i}".encode() * 10) for i in range(5))
    assert raw == vc.volume_incremental_copy(vid, since_ns=0)
    v = vs.store.find_volume(vid)
    v.sync()
    with open(v.file_name() + ".dat", "rb") as f:
        assert f.read().endswith(raw)


@pytest.mark.parametrize("source_pkg", ["port", "jax"])
def test_replica_catch_up_via_tail_receiver(stack, tmp_path, source_pkg):
    """A lagging port replica catches up from its peer through
    VolumeTailReceiver, the peer a port or a JAX volume server; deletes
    replicate too."""
    master, vs, fs, fc, vc = stack
    if source_pkg == "port":
        src_master, src = master, vs
    else:
        src_master = JMasterServer(volume_size_limit_mb=64)
        src_master.start()
        src = JVolumeServer([str(tmp_path / "jsrc")], src_master.url,
                            grpc_port=0)
        src.start()
    fids = [_put(src_master, f"replica-{i}".encode()) for i in range(3)]
    vid = int(fids[0].split(",")[0])
    vs2 = VolumeServer([str(tmp_path / "v2")], master.url, grpc_port=0,
                       device="cpu")
    vs2.start()
    try:
        v_src = src.store.find_volume(vid)
        vs2.store.add_volume(vid, v_src.collection)
        vc2 = GrpcVolumeClient(f"127.0.0.1:{vs2.grpc_port}")
        try:
            vc2.volume_tail_receiver(vid, since_ns=0,
                                     source=f"127.0.0.1:{src.grpc_port}")
        finally:
            vc2.close()
        v_dst = vs2.store.find_volume(vid)
        assert v_dst.file_count() == 3
        for fid in fids:
            key = int(fid.split(",")[1][:-8], 16)
            assert bytes(v_dst.read_needle(key).data) == \
                bytes(v_src.read_needle(key).data)
        key0 = int(fids[0].split(",")[1][:-8], 16)
        cursor = v_dst.last_append_at_ns
        v_src.delete_needle(key0)
        vc2 = GrpcVolumeClient(f"127.0.0.1:{vs2.grpc_port}")
        try:
            vc2.volume_tail_receiver(vid, since_ns=cursor,
                                     source=f"127.0.0.1:{src.grpc_port}")
        finally:
            vc2.close()
        assert not v_dst.has_needle(key0)
    finally:
        vs2.stop()
        if source_pkg == "jax":
            src.stop()
            src_master.stop()


def test_filer_misc_rpcs(stack):
    """AppendToEntry / CollectionList / DeleteCollection / Ping /
    SubscribeLocalMetadata."""
    master, vs, fs, fc, vc = stack
    pieces = []
    for i in range(3):
        a = fc.assign_volume()
        blob = f"segment-{i}|".encode()
        http_call("POST", f"http://{a.url}/{a.file_id}", body=blob)
        pieces.append((a.file_id, blob))
    for fid, blob in pieces:
        fc.append_to_entry("/logs", "app.log",
                           [fpb.FileChunk(file_id=fid, size=len(blob),
                                          mtime=time.time_ns())])
    status, body, _ = http_call("GET", f"http://{fs.url}/logs/app.log")
    assert status == 200 and body == b"segment-0|segment-1|segment-2|"

    http_call("POST", f"http://{fs.url}/logs/tiny.log", body=b"head|")
    a = fc.assign_volume()
    http_call("POST", f"http://{a.url}/{a.file_id}", body=b"tail")
    r = fc._unary("AppendToEntry", fpb.AppendToEntryRequest(
        directory="/logs", entry_name="tiny.log",
        chunks=[fpb.FileChunk(file_id=a.file_id, size=4,
                              mtime=time.time_ns())]),
        fpb.AppendToEntryResponse)
    assert not r.error
    status, body, _ = http_call("GET", f"http://{fs.url}/logs/tiny.log")
    assert status == 200 and body == b"head|tail"

    a = fc.assign_volume(collection="grpccol")
    http_call("POST", f"http://{a.url}/{a.file_id}", body=b"c")
    vs.heartbeat_once()
    assert "grpccol" in fc.collection_list()
    fc.delete_collection("grpccol")
    vs.heartbeat_once()
    assert "grpccol" not in fc.collection_list()

    p = fc.ping()
    assert p.stop_time_ns >= p.start_time_ns

    ch = fc.channel.unary_stream(
        "/weedtpu_filer_pb.SeaweedFiler/SubscribeLocalMetadata",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=fpb.SubscribeMetadataResponse.FromString)
    call = ch(fpb.SubscribeMetadataRequest(client_name="t",
                                           path_prefix="/logs", since_ns=0),
              timeout=30)
    first = next(iter(call))
    assert first.directory.startswith("/logs")
    call.cancel()


def test_master_admin_rpcs(tmp_path):
    """Statistics / CollectionList / CollectionDelete /
    GetMasterConfiguration on the port master's gRPC plane."""
    from seaweedfs_tpu_torch.server.master_grpc import GrpcMasterClient
    master = MasterServer(volume_size_limit_mb=64, grpc_port=0)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, device="cpu")
    vs.start()
    time.sleep(0.1)
    client = GrpcMasterClient(f"127.0.0.1:{master.grpc_port}")
    try:
        a = http_json("GET", f"http://{master.url}/dir/assign"
                             "?collection=mcol")
        http_call("POST", f"http://{a['url']}/{a['fid']}", body=b"zz")
        vs.heartbeat_once()
        st = client._call("Statistics", mpb.StatisticsRequest(),
                          mpb.StatisticsResponse)
        assert st.total_size > 0 and st.used_size > 0
        cl = client._call("CollectionList", mpb.CollectionListRequest(),
                          mpb.CollectionListResponse)
        assert any(c.name == "mcol" for c in cl.collections)
        client._call("CollectionDelete",
                     mpb.CollectionDeleteRequest(name="mcol"),
                     mpb.CollectionDeleteResponse)
        vs.heartbeat_once()
        cl = client._call("CollectionList", mpb.CollectionListRequest(),
                          mpb.CollectionListResponse)
        assert not any(c.name == "mcol" for c in cl.collections)
        conf = client._call("GetMasterConfiguration",
                            mpb.GetMasterConfigurationRequest(),
                            mpb.GetMasterConfigurationResponse)
        assert conf.volume_size_limit_m_b == 64
        assert conf.leader == master.url
        assert client.ec_repair_status()["queue"] == []
    finally:
        client.close()
        vs.stop()
        master.stop()


def test_query_rpc(stack):
    master, vs, fs, fc, vc = stack
    rows = [{"name": "ada", "age": 36}, {"name": "grace", "age": 45},
            {"name": "alan", "age": 41}]
    payload = "\n".join(json.dumps(r) for r in rows).encode()
    fid = _put(master, payload)
    out = vc.query([fid], selections=["name"],
                   filter_field="age", filter_op=">", filter_value="40")
    got = [json.loads(line) for line in out.decode().splitlines() if line]
    assert sorted(g["name"] for g in got) == ["alan", "grace"]
    assert vc.query([fid, "77,deadbeef01"]) == payload + b"\n"


def test_remote_conf_proto_persistence_and_json_fallback(stack):
    """A filer with a gRPC plane keeps remote confs and mappings as
    weedtpu_remote_pb bytes, reads a legacy JSON blob and migrates it on
    the next save."""
    from seaweedfs_tpu_torch.filer.remote_mount import (REMOTE_CONF_KV_KEY,
                                                        RemoteMounts)
    from seaweedfs_tpu_torch.remote_storage.remote_storage import RemoteConf
    master, vs, fs, fc, vc = stack
    rm = RemoteMounts(fs.filer)
    rm.configure(RemoteConf(name="cloud", type="s3", endpoint="http://e",
                            access_key="AK", secret_key="SK", bucket="b"))
    blob = fs.filer.store.kv_get(REMOTE_CONF_KV_KEY)
    lst = remote_pb2.RemoteConfList.FromString(blob)
    assert lst.remotes[0].name == "cloud" and lst.remotes[0].secret_key == "SK"
    assert rm.list_confs()["cloud"].endpoint == "http://e"
    assert fc.kv_get(REMOTE_CONF_KV_KEY) == blob  # the same bytes over gRPC
    fs.filer.store.kv_put(REMOTE_CONF_KV_KEY, json.dumps(
        {"remotes": [{"name": "old", "type": "local",
                      "root": "/tmp/x"}]}).encode())
    assert rm.list_confs()["old"].root == "/tmp/x"
    rm.configure(RemoteConf(name="extra"))
    lst = remote_pb2.RemoteConfList.FromString(
        fs.filer.store.kv_get(REMOTE_CONF_KV_KEY))
    assert sorted(c.name for c in lst.remotes) == ["extra", "old"]
    rm.mount("/m", "old")
    m = remote_pb2.RemoteStorageMapping.FromString(
        fs.filer.store.kv_get(b"/etc/remote.mapping"))
    assert m.mappings["/m"].name == "old"
    assert rm.list_mappings()["/m"]["remote_name"] == "old"


def test_proto_file_count():
    """The port carries the protos of every plane, each beside its stub:
    all nine of the JAX package's."""
    port_dir = pathlib.Path(pb_pkg.__file__).parent
    protos = {p.stem for p in port_dir.glob("*.proto")}
    assert protos == set(PORTED_PROTOS)
    for name in protos:
        assert (port_dir / f"{name}_pb2.py").exists()
    digest = {name: hashlib.sha256(
        (port_dir / f"{name}.proto").read_bytes()).hexdigest()
        for name in protos}
    assert len(set(digest.values())) == len(protos)
