"""Guards on the port's boundaries.

- The port and chip_smoke.py import neither jax nor seaweedfs_tpu.
- Entry points run on the card unless the caller asks for the CPU: with no
  CUDA device they raise rather than carry on on the CPU.
- The kernel wrappers take their plain versions only for CPU tensors, and
  such calls do not count as kernel launches.
- The kernels' build directory is git-ignored.
- The pipelines reach a kernel only through the coder (apply_rows), never
  by naming a kernel module themselves.
"""

import ast
import os
import pathlib
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.models.coder import make_coder
from seaweedfs_tpu_torch.ops import rs_cuda, rs_mxu, rs_torch
from seaweedfs_tpu_torch.parallel import streaming
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as tenc
from seaweedfs_tpu_torch.utils import native_build
from torch_ports import free_grpc_ports

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "seaweedfs_tpu_torch"


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "seaweedfs_tpu")


def test_port_and_smoke_never_import_jax_or_reference():
    files = sorted(f for f in PORT.rglob("*.py")  # build/ is generated
                   if "build" not in f.relative_to(PORT).parts)
    # the card scripts beside the package too
    files += [REPO / "chip_smoke.py", REPO / "k1_ab.py",
              REPO / "meta_log_ab.py"]
    assert len(files) > 17
    assert PORT / "ops" / "rs_mxu.py" in files
    # the serving plane: the server, the scrubber, stats, qos, httpd
    for rel in ("server/volume_server.py", "server/volume_tcp.py",
                "scrub/scrubber.py", "stats/hotkeys.py", "stats/ledger.py",
                "qos/governor.py", "qos/limiter.py", "utils/httpd.py",
                "utils/tracing.py", "utils/limiter.py",
                # the control plane: master, repair queue, client, shell
                "cluster/sequence.py", "cluster/topology.py",
                "cluster/volume_growth.py", "stats/slo.py",
                "stats/telemetry.py", "filer/shard_ring.py",
                "filer/rebalance.py", "storage/tiering.py",
                "scrub/repair_queue.py", "server/master.py",
                "client/wdclient.py", "client/operation.py",
                "shell/ec_plan.py", "shell/commands.py",
                # the command line and master HA
                "cli.py", "shell/repl.py", "cluster/raft.py",
                "storage/maintenance.py",
                # the filer, its stores, caches and shell commands
                "filer/entry.py", "filer/filechunks.py",
                "filer/filechunk_manifest.py", "filer/filerstore.py",
                "filer/abstract_sql.py", "filer/lsm_store.py",
                "filer/filerstore_hardlink.py", "filer/entry_cache.py",
                "filer/filer.py", "filer/filer_conf.py",
                "filer/meta_aggregator.py", "filer/reader_cache.py",
                "filer/remote_mount.py", "server/filer_server.py",
                "shell/fs_commands.py", "shell/fsck.py",
                "utils/chunk_cache.py", "utils/cipher.py",
                "utils/aesgcm_compat.py", "stats/autocap.py",
                "notification/queue.py", "remote_storage/remote_storage.py",
                "pb/remote_pb2.py",
                # the gRPC plane
                "pb/master_pb2.py", "pb/volume_server_pb2.py",
                "pb/filer_pb2.py", "pb/etcdkv_pb2.py", "utils/tls.py",
                "query/json_query.py", "server/master_grpc.py",
                "server/volume_grpc.py", "server/filer_grpc.py",
                "filer/etcd_store.py",
                # the cloud tier and the gateways
                "storage/backend.py", "utils/sigv4.py",
                "remote_storage/s3_client.py", "pb/s3_pb2.py",
                "pb/iam_pb2.py", "gateway/__init__.py",
                "gateway/iam_server.py", "gateway/s3_server.py",
                "filer/remote_store.py", "gateway/webdav_server.py",
                "gateway/ftp_server.py",
                # the macro simulator and the wire-protocol stores
                "sim/__init__.py", "sim/__main__.py", "sim/kernel.py",
                "sim/faults.py", "sim/workload.py", "sim/actors.py",
                "sim/harness.py", "sim/incidents.py",
                "filer/redis_store.py", "filer/mysql_store.py",
                "filer/postgres_store.py", "filer/mongodb_store.py",
                "filer/cassandra_store.py", "filer/elastic_store.py",
                # replication, mount, the mq broker, the external
                # notification queues and the Azure client
                "replication/__init__.py", "replication/sink.py",
                "replication/sync.py", "replication/remote_sync.py",
                "mount/__init__.py", "mount/fuse_kernel.py",
                "mount/meta_cache.py", "mount/page_writer.py",
                "mount/weedfs.py", "mount/mount_grpc.py",
                "pb/mount_pb2.py", "mq/__init__.py", "mq/broker.py",
                "mq/broker_grpc.py", "pb/mq_pb2.py",
                "notification/kafka_queue.py", "notification/sqs_queue.py",
                "notification/pubsub_queue.py",
                "remote_storage/azure_client.py"):
        assert PORT / rel in files, rel
    assert not (PORT / "utils" / "unported.py").exists()
    bad = {str(f.relative_to(REPO)): [n for n in _imported_modules(f)
                                      if _forbidden(n)]
           for f in files}
    assert {f: n for f, n in bad.items() if n} == {}


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from seaweedfs_tpu.ops import gf256\n"
                     "import jax.numpy as jnp\n")
    assert [n for n in _imported_modules(probe) if _forbidden(n)] == \
        ["jax.numpy", "seaweedfs_tpu.ops"]
    assert not _forbidden("seaweedfs_tpu_torch.ops")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs_torch.TorchCoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_coder()
    base = str(tmp_path / "1")
    with open(base + ".dat", "wb") as f:
        f.write(b"\x03" + b"\x00" * 1000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.pipelined_encode_file(base, coder=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.write_ec_files(base, coder=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.rebuild_ec_files(base, coder=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs_torch.coder_from_numpy({}, np.zeros((4, 10), np.uint8),
                                  device="cuda")
    assert not [p for p in os.listdir(tmp_path) if p.startswith("1.ec")]
    # asked for explicitly, the CPU runs
    assert make_coder(device="cpu").device == torch.device("cpu")


def test_cpu_tensors_take_plain_version_and_do_not_count():
    rng = np.random.default_rng(0)
    mat = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (10, 333), dtype=np.uint8))
    before = rs_cuda.launches
    got = rs_cuda.gf_apply(mat, data)
    assert rs_cuda.launches == before
    assert torch.equal(got, rs_torch.gf_apply_reference(mat, data))
    assert rs_cuda._lib is None  # nothing was built or loaded for it


def test_other_devices_raise_instead_of_falling_back():
    data = torch.zeros((10, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rs_cuda.gf_apply(np.ones((4, 10), np.uint8), data)
    with pytest.raises(ValueError):
        rs_torch.resolve_device("meta")


def test_build_directory_is_git_ignored():
    ignored = [ln.strip().rstrip("/") for ln in
               (REPO / ".gitignore").read_text().splitlines()]
    rel = os.path.relpath(native_build.BUILD_DIR, REPO)
    assert rel == os.path.join("seaweedfs_tpu_torch", "build")
    assert rel in ignored
    assert os.path.dirname(native_build.CSRC_DIR) == str(PORT)


def test_mxu_cpu_tensors_take_plain_version_and_do_not_count():
    rng = np.random.default_rng(1)
    mat = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (10, 333), dtype=np.uint8))
    before = rs_mxu.launches
    got = rs_mxu.mxu_apply(mat, data)
    assert rs_mxu.launches == before
    assert torch.equal(got, rs_mxu.mxu_apply_reference(mat, data))
    assert rs_mxu._lib is None
    meta = torch.zeros((10, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rs_mxu.mxu_apply(mat, meta)


def test_kernel_sources_build_into_the_ignored_directory():
    ignored = [ln.strip().rstrip("/") for ln in
               (REPO / ".gitignore").read_text().splitlines()]
    assert os.path.relpath(native_build.BUILD_DIR, REPO) in ignored
    for mod, name in ((rs_cuda, "gf_apply.cu"), (rs_mxu, "mxu_apply.cu")):
        assert mod._SRC == os.path.join(native_build.CSRC_DIR, name)
        assert os.path.isfile(mod._SRC)


def test_pipelines_never_name_a_kernel_module():
    src = PORT / "parallel" / "streaming.py"
    names = _imported_modules(src)
    assert not [n for n in names if n.endswith(("rs_cuda", "rs_mxu"))]
    assert "rs_cuda" not in src.read_text()
    assert "rs_mxu" not in src.read_text()


def test_mesh_entry_points_raise_without_cuda(no_cuda):
    """The batch path's entry points run on the card unless asked for the
    CPU: make_coder("mesh"), MeshCoder(), EcBatchScheduler() (which, unlike
    the JAX package's, does not quietly take the CPU coder) and
    batch_encode_volumes raise; device="cpu" runs."""
    from seaweedfs_tpu_torch.ops.rs_mesh import MeshCoder
    from seaweedfs_tpu_torch.parallel.batcher import EcBatchScheduler
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_coder("mesh")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshCoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EcBatchScheduler()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.batch_encode_volumes(np.zeros((2, 10, 16), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_mesh()
    assert mesh_mod.device_count() == 0
    assert mesh_mod.default_backend() == "cpu"
    assert make_coder("mesh", device="cpu").n_devices == 1
    sched = EcBatchScheduler(device="cpu")
    sched.stop()


def test_batch_wrapper_cpu_tensors_take_plain_version_and_do_not_count():
    rng = np.random.default_rng(2)
    data = torch.from_numpy(rng.integers(0, 256, (3, 10, 333), np.uint8))
    mats = [rng.integers(0, 256, (r, 10), np.uint8) for r in (1, 4, 2)]
    before = (rs_cuda.batch_launches, rs_cuda.launches)
    got = rs_cuda.gf_apply_batch(mats, data)
    assert (rs_cuda.batch_launches, rs_cuda.launches) == before
    assert torch.equal(got, rs_cuda.gf_apply_batch_reference(mats, data))
    for b, mat in enumerate(mats):  # zero rows pad each job to m = 4
        r = mat.shape[0]
        assert torch.equal(got[b, :r],
                           rs_torch.gf_apply_reference(mat, data[b]))
        assert not got[b, r:].any()
    assert rs_cuda._lib is None
    meta = torch.zeros((2, 10, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rs_cuda.gf_apply_batch(mats[1], meta)


def test_batch_wrapper_checks_inputs():
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 256, (4, 10), np.uint8)
    data = torch.zeros((2, 10, 16), dtype=torch.uint8)
    strided = torch.zeros((2, 10, 32), dtype=torch.uint8)[:, :, ::2]
    with pytest.raises(ValueError, match="matrices for a batch"):
        rs_cuda.gf_apply_batch([mat], data)
    with pytest.raises(ValueError, match=r"\(B, 10, n\) uint8"):
        rs_cuda.gf_apply_batch(mat, data[:, :9])
    with pytest.raises(ValueError, match="contiguous"):
        rs_cuda.gf_apply_batch(mat, strided)
    with pytest.raises(ValueError, match="out must be"):
        rs_cuda.gf_apply_batch(mat, data, data[:, :3])
    with pytest.raises(ValueError, match="share their column count"):
        rs_cuda.gf_apply_batch([mat, mat[:, :9]], data)


def test_store_raises_without_cuda_and_lrc_takes_no_device(no_cuda,
                                                           tmp_path):
    """Store() and Store(coder=None) take the card coder, so they raise
    here (the JAX package's Store quietly takes the host coder); with
    device="cpu" they run the plain version. The LRC coders are host
    coders: make_coder("lrc") takes no device and runs without a card."""
    from seaweedfs_tpu_torch.ops.lrc import LrcCoder
    from seaweedfs_tpu_torch.storage.store import Store
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Store([str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Store([str(tmp_path / "b")], coder=None)
    store = Store([str(tmp_path / "c")], device="cpu")
    assert store.coder.device == torch.device("cpu")
    store.close()
    for name in ("lrc", "lrc-mt"):
        coder = make_coder(name)
        assert isinstance(coder, LrcCoder)
        assert not hasattr(coder, "device")
        rng = np.random.default_rng(4)
        data = rng.integers(0, 256, (10, 64), np.uint8)
        assert coder.encode_array(data).shape == (4, 64)


def test_volume_server_raises_without_cuda_before_binding(no_cuda,
                                                          monkeypatch,
                                                          tmp_path):
    """VolumeServer takes the card unless asked for the CPU: without a
    CUDA device its constructor raises before any socket is bound (the
    JAX package's server quietly takes the host coder)."""
    from seaweedfs_tpu_torch.server import volume_server
    bound = []
    monkeypatch.setattr(volume_server, "HttpServer",
                        lambda *a, **kw: bound.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        volume_server.VolumeServer([str(tmp_path / "v")], "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        volume_server.VolumeServer([str(tmp_path / "v")], "127.0.0.1:1",
                                   ec_batcher=True)
    assert bound == []
    assert not (tmp_path / "v").exists()


def test_scrubber_on_a_cpu_store_takes_no_cuda_path(no_cuda, tmp_path):
    """A scrub of a CPU store's EC volume runs K1's plain version: every
    wrapper call gets CPU tensors, nothing is built and nothing counts as
    a launch."""
    from seaweedfs_tpu_torch.scrub import Scrubber
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store
    store = Store([str(tmp_path)], device="cpu")
    store.add_volume(1)
    rng = np.random.default_rng(5)
    for i in range(3):
        store.write_volume_needle(1, Needle(
            id=i + 1, cookie=7,
            data=rng.integers(0, 256, 50_000, np.uint8).tobytes()))
    store.generate_ec_shards(1)
    store.delete_volume(1)
    store.mount_ec_shards("", 1, list(range(14)))
    devices = []
    real = rs_cuda.gf_apply

    def spy(mat, data, out=None):
        devices.append(data.device.type)
        return real(mat, data, out)

    before = rs_cuda.launches
    rs_cuda.gf_apply = spy
    try:
        out = Scrubber(store, rate_bytes_per_sec=0).run_once()
    finally:
        rs_cuda.gf_apply = real
        store.close()
    assert not out["corruptions"]
    assert devices and set(devices) == {"cpu"}
    assert rs_cuda.launches == before
    assert rs_cuda._lib is None


def test_control_plane_raises_for_what_is_not_ported(monkeypatch):
    """The master, client and shell take no device. Their gRPC planes are
    ported: the master serves one on grpc_port (also as `master -grpc` on
    the command line), the client's push mode starts its KeepConnected
    loop, and the shell probes each volume server's plane once, caching a
    miss. `filer.sync` between two filers (replication/), once raising
    NotImplementedError, starts its two one-way syncs, each excluding
    the other's signature, and opens no device."""
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    from seaweedfs_tpu_torch.server import master
    from seaweedfs_tpu_torch.shell.commands import ShellContext
    m = master.MasterServer(grpc_port=0)
    m.start()
    try:
        assert m.grpc_port and m._grpc_server is not None
    finally:
        m.stop()
    served = []
    monkeypatch.setattr(cli, "_serve_until_signal",
                        lambda *srv, ready="": served.extend(srv))
    port = free_grpc_ports(1)[0]
    cli.main(["master", "-port", str(port), "-grpc"])
    try:
        assert served[0].grpc_port == port + 10000  # as upstream
    finally:
        for srv in served:
            srv.stop()
    mc = MasterClient("127.0.0.1:1", grpc_address="127.0.0.1:2")
    try:
        assert mc._kc_thread.is_alive()
    finally:
        mc.stop()
    from seaweedfs_tpu_torch.replication import sync
    started = []
    monkeypatch.setattr(sync.FilerSync, "start",
                        lambda self, since_ns=0: started.append(self))
    monkeypatch.setattr(cli, "_wait_forever", lambda: None)
    cli.main(["filer.sync", "-a", "127.0.0.1:1", "-b", "127.0.0.1:2"])
    assert [(s.source, s.replicator.sink.filer_url) for s in started] == [
        ("127.0.0.1:1", "127.0.0.1:2"), ("127.0.0.1:2", "127.0.0.1:1")]
    a_to_b, b_to_a = started
    assert a_to_b.exclude_signature == b_to_a.replicator.sink.signature
    assert b_to_a.exclude_signature == a_to_b.replicator.sink.signature
    assert not torch.cuda.is_initialized()
    sh = ShellContext("127.0.0.1:1")
    assert sh._grpc_client("127.0.0.1:2") is None
    assert sh._grpc_clients == {"127.0.0.1:2": None}


def test_volume_command_raises_without_cuda_before_binding(no_cuda,
                                                           monkeypatch,
                                                           tmp_path):
    """`weed volume` and `weed server` take the card unless given -device
    cpu: without a CUDA device they raise before any socket is bound,
    whatever -coder names (a host coder too)."""
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.server import master, volume_server
    from seaweedfs_tpu_torch.utils import httpd
    bound = []
    for mod in (httpd, master, volume_server):
        monkeypatch.setattr(mod, "HttpServer",
                            lambda *a, **kw: bound.append(a))
    for argv in (["volume", "-dir", str(tmp_path / "v")],
                 ["volume", "-dir", str(tmp_path / "v"), "-coder", "cpu"],
                 ["volume", "-dir", str(tmp_path / "v"), "-ecBatcher"],
                 ["server", "-dir", str(tmp_path / "v")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert bound == []
    assert not (tmp_path / "v").exists()


class _FakeFuse:
    """FuseConnection's stand-in: no kernel mount. serve_forever drives
    the WeedFS it was given (a file created, written, read back), then
    ends as Ctrl-C ends a mount."""

    served: list = []

    def __init__(self, ops, mountpoint):
        self.ops, self.mountpoint = ops, mountpoint

    def serve_forever(self, background=False):
        from seaweedfs_tpu_torch.mount.fuse_kernel import ROOT_ID
        attr, fh = self.ops.create(ROOT_ID, "probe.txt", 0o644)
        self.ops.write(attr.ino, fh, 0, b"no device")
        self.ops.release(attr.ino, fh)
        got = self.ops.lookup(ROOT_ID, "probe.txt")
        fh = self.ops.open(got.ino)
        _FakeFuse.served.append(self.ops.read(got.ino, fh, 0, 64))
        self.ops.release(got.ino, fh)
        raise KeyboardInterrupt

    def close(self):
        pass


@pytest.mark.parametrize("argv,slice_", [
    (["filer", "-ftp", "-mq"], "the gateway slice"),
    (["fuse", "/mnt/weed"], "the gateway slice"),
    (["mount", "/mnt/weed"], "the gateway slice"),
])
def test_filer_gateways_and_mount_raise_naming_their_slice(argv, slice_,
                                                           no_cuda,
                                                           monkeypatch):
    """`filer -ftp -mq`, `fuse` and `mount` (the gateway slice, once
    raising NotImplementedError) run in the port and take no device:
    with no CUDA device the filer serves its FTP gateway and its mq
    broker's gRPC plane, and a mount (here over a private memory store,
    with FuseConnection's stand-in in place of the kernel) writes and
    reads a file; the card is never opened."""
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.mount import fuse_kernel
    from seaweedfs_tpu_torch.mq.broker_grpc import MqClient
    served = []
    monkeypatch.setattr(cli, "_serve_until_signal",
                        lambda *srv, ready="": served.extend(srv))
    monkeypatch.setattr(fuse_kernel, "FuseConnection", _FakeFuse)
    _FakeFuse.served = []
    dead = "127.0.0.1:1"  # nothing listens: announces retry quietly
    if argv[0] == "filer":
        port, ftp = free_grpc_ports(2)
        cli.main([*argv, "-port", str(port), "-ftpPort", str(ftp),
                  "-mqPort", "0", "-master", dead])
        try:
            assert [type(s).__name__ for s in served] == [
                "_MqPlane", "FtpServer", "FilerServer"]
            client = MqClient(f"127.0.0.1:{served[0].port}", tls=None)
            try:
                assert client.configure_topic("g", "t", 2) == 2
                assert client.list_topics() == [
                    {"namespace": "g", "topic": "t", "partition_count": 2}]
            finally:
                client.close()
        finally:
            for srv in served:
                srv.stop()
    elif argv[0] == "fuse":
        cli.main([*argv, "-o", f"store=memory,master={dead}"])
    else:
        cli.main([*argv, "-store", "memory", "-master", dead])
    if argv[0] != "filer":
        assert _FakeFuse.served == [b"no device"]
    assert not torch.cuda.is_initialized()


@pytest.fixture(scope="module")
def filer_on_master():
    """A port master and a port filer (memory store, small files inline)
    registered with it, 20 files under /tail written through the filer."""
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.utils.httpd import http_call, http_json
    m = MasterServer()
    m.start()
    fs = FilerServer(m.url)
    fs.start()
    try:
        deadline = time.monotonic() + 20
        while not http_json("GET", f"http://{m.url}/cluster/nodes"
                                   f"?type=filer")["cluster_nodes"]:
            assert time.monotonic() < deadline, "the filer to register"
            time.sleep(0.05)
        for i in range(20):
            assert http_call("POST", f"http://{fs.url}/tail/f{i}.txt",
                             body=b"x" * i)[0] < 300
        yield m, fs
    finally:
        fs.stop()
        m.stop()


@pytest.mark.parametrize("line", ["fs.meta.tail", "fs.meta.tail -n 4",
                                  "mount.configure -collectionCapacity 1",
                                  "mq.topic.list"])
def test_repl_filer_commands_raise(line, filer_on_master, no_cuda):
    """What the REPL's filer families reach (replication/sync.py behind
    fs.meta.tail, the mq broker's topics, mount's admin plane), once
    raising NotImplementedError, answers from a port master and filer,
    with no device: fs.meta.tail the events it read (16 by default),
    mount.configure the mounts it reached (none here), mq.topic.list the
    topics under /topics (none here). The fs.* family and volume.fsck run
    against the port's filer (tests/test_torch_filer_server.py), the
    s3.* and remote.* families too (tests/test_torch_gateway_cross.py)."""
    from seaweedfs_tpu_torch.shell.commands import ShellContext
    from seaweedfs_tpu_torch.shell.repl import run_command
    m, _ = filer_on_master
    out = run_command(ShellContext(m.url), line + " -pathPrefix /tail"
                      if line.startswith("fs.meta.tail") else line)
    assert out == {"fs.meta.tail": {"events": 16},
                   "fs.meta.tail -n 4": {"events": 4},
                   "mount.configure -collectionCapacity 1": {"mounts": {}},
                   "mq.topic.list": {"topics": []}}[line]
    assert not torch.cuda.is_initialized()
