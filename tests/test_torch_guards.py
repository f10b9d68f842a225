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
    files.append(REPO / "chip_smoke.py")
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
                "pb/remote_pb2.py", "utils/unported.py",
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
                "filer/cassandra_store.py", "filer/elastic_store.py"):
        assert PORT / rel in files, rel
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
    miss. What stays unported raises where it is reached: filer.sync
    between two filers (replication/), before it dials either."""
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
    with pytest.raises(NotImplementedError, match="gateway slice"):
        cli.main(["filer.sync", "-a", "127.0.0.1:1", "-b", "127.0.0.1:2"])
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


@pytest.mark.parametrize("argv,slice_", [
    (["filer", "-ftp", "-mq"], "the gateway slice"),
    (["fuse", "/mnt/weed"], "the gateway slice"),
    (["mount", "/mnt/weed"], "the gateway slice"),
])
def test_filer_gateways_and_mount_raise_naming_their_slice(argv, slice_,
                                                           monkeypatch):
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.server import filer_server
    from seaweedfs_tpu_torch.utils import httpd
    bound = []
    for mod in (httpd, filer_server):
        monkeypatch.setattr(mod, "HttpServer",
                            lambda *a, **kw: bound.append(a))
    with pytest.raises(NotImplementedError, match=slice_):
        cli.main(argv)
    assert bound == []


@pytest.mark.parametrize("line", ["fs.meta.tail", "fs.meta.tail -n 4",
                                  "mount.configure -collectionCapacity 1",
                                  "mq.topic.list"])
def test_repl_filer_commands_raise(line):
    """What the REPL's filer families reach and the port does not have
    yet (replication/sync.py behind fs.meta.tail, the mq broker, mount's
    admin plane) raises NotImplementedError naming the rest of the
    gateway slice; nothing is sent anywhere. The fs.* family and
    volume.fsck run against the port's filer
    (tests/test_torch_filer_server.py), the s3.* and remote.* families
    too (tests/test_torch_gateway_cross.py)."""
    from seaweedfs_tpu_torch.shell.commands import ShellContext
    from seaweedfs_tpu_torch.shell.repl import run_command
    with pytest.raises(NotImplementedError, match="gateway slice"):
        run_command(ShellContext("127.0.0.1:1"), line)
