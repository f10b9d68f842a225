"""Guards on the port's boundaries.

- The port and chip_smoke.py import neither jax nor seaweedfs_tpu.
- Entry points run on the card unless the caller asks for the CPU: with no
  CUDA device they raise rather than carry on on the CPU.
- The kernel wrapper takes its plain version only for CPU tensors, and
  such calls do not count as kernel launches.
- The kernels' build directory is git-ignored.
"""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.models.coder import make_coder
from seaweedfs_tpu_torch.ops import rs_cuda, rs_torch
from seaweedfs_tpu_torch.parallel import streaming
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as tenc
from seaweedfs_tpu_torch.utils import native_build

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
    assert len(files) > 16
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
