"""Device discovery and mesh construction for the EC engine (the port of
seaweedfs_tpu/parallel/mesh.py).

This module is the port's one discovery site for the mesh modules
(ops/rs_mesh.py, parallel/distributed.py, parallel/batcher.py): every list
of cards they use comes from :func:`devices`, and :func:`probe` caches one
round trip to the first card with its classified failure, which the batch
scheduler's ``stats()`` exposes.

A :class:`Mesh` is a named grid of ``torch.device`` s. Nothing in it is
sharded by a framework: the mesh modules split their batches over its
devices themselves, one kernel launch per device on that device's current
stream. A mesh of CPU lanes (``device="cpu"``: ``torch.device("cpu")``
repeated) runs the same splitting with the kernels' plain versions; it is
the counterpart of the JAX tests' 8-device virtual CPU mesh.

Axis vocabulary (the storage-system analogue of dp/tp/sp):
  - 'data'  : batch of independent volumes (data parallel)
  - 'shard' : the shards of one volume (the axis a degraded rebuild's
              partial products are folded over)
  - 'seq'   : position along the stripe (EC columns are independent, so
              this axis never needs a fold on encode)
  - 'batch' : the 1-D cross-volume job axis MeshCoder and the batch
              scheduler split over (one block-group of work per job)
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

AXES = ("data", "shard", "seq")

_probe_lock = threading.Lock()
_probe_cache: Optional[dict] = None


class Mesh:
    """Devices on a named grid: ``devices`` is an object ndarray of
    ``torch.device`` (``devices.size`` of them), ``axis_names`` names its
    axes and ``shape[axis]`` gives an axis's size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def devices(n: Optional[int] = None) -> list[torch.device]:
    """The process's CUDA devices (the first ``n`` when given). Raises
    when there is none: the mesh modules never carry on on the CPU unless
    asked to."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for a mesh; pass device='cpu' "
                           "for a mesh of CPU lanes")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs if n is None else devs[:n]


def cpu_lanes(n: int) -> list[torch.device]:
    """n CPU lanes: the same device n times, so a mesh over them runs the
    mesh modules' splitting with the kernels' plain versions."""
    return [torch.device("cpu")] * n


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def classify_failure(err: Optional[str]) -> Optional[str]:
    """Map a device/probe failure string onto a stable fallback reason:
    'device_put' (the host-to-device transfer was rejected),
    'relay_timeout' (a timeout), else 'probe_error' — the JAX package's
    vocabulary, which the batch scheduler's stats() carries."""
    if not err:
        return None
    low = err.lower()
    if "device_put" in low:
        return "device_put"
    if "timeout" in low:
        return "relay_timeout"
    return "probe_error"


def probe(force: bool = False) -> dict:
    """In-process device probe, cached for the life of the process.
    Returns::

        {"ok": bool, "backend": str|None, "n_devices": int,
         "error": str|None, "fallback_reason": None|"device_put"|
         "relay_timeout"|"probe_error"}

    It enumerates the devices and round-trips a tiny tensor through the
    first one."""
    global _probe_cache
    with _probe_lock:
        if _probe_cache is not None and not force:
            return dict(_probe_cache)
    out: dict = {"ok": False, "backend": None, "n_devices": 0,
                 "error": None, "fallback_reason": None}
    try:
        devs = devices()
        out["backend"] = default_backend()
        out["n_devices"] = len(devs)
        x = torch.arange(8, dtype=torch.int32)
        if not torch.equal(x.to(devs[0]).cpu(), x):
            raise RuntimeError("device_put round-trip mismatch")
        out["ok"] = True
    except Exception as e:  # noqa: BLE001 — classified, not swallowed
        out["error"] = f"{type(e).__name__}: {e}"[:500]
        out["fallback_reason"] = classify_failure(out["error"])
    with _probe_lock:
        _probe_cache = dict(out)
    return dict(out)


DeviceSpec = Union[str, torch.device, Sequence[torch.device]]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: tuple[str, ...] = AXES,
              shape: Optional[tuple[int, ...]] = None,
              device: DeviceSpec = "cuda") -> Mesh:
    """A mesh over `device`: "cuda" takes the first `n_devices` cards (all
    of them by default), "cpu" `n_devices` CPU lanes (default 1), and a
    list of devices takes those. `shape` defaults to _default_shape."""
    if isinstance(device, (str, torch.device)):
        kind = torch.device(device).type
        if kind == "cuda":
            devs = devices(n_devices)
        elif kind == "cpu":
            devs = cpu_lanes(n_devices or 1)
        else:
            raise ValueError(f"unsupported device {device}")
    else:
        devs = list(device)
    if n_devices is not None and len(devs) != n_devices:
        raise ValueError(f"asked for {n_devices} devices, have {len(devs)}")
    n = len(devs)
    if shape is None:
        shape = _default_shape(n, len(axis_names))
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def batch_mesh(n_devices: Optional[int] = None,
               device: DeviceSpec = "cuda") -> Mesh:
    """1-D mesh over the cross-volume 'batch' axis — the MeshCoder /
    batch-scheduler topology: independent block-groups of work, one
    slice per device, no folds."""
    return make_mesh(n_devices, axis_names=("batch",), device=device)


def _default_shape(n: int, naxes: int) -> tuple[int, ...]:
    """Factor n into naxes dims, biasing size toward the trailing ('seq')
    axis, then 'shard', keeping 'data' smallest."""
    dims = [1] * naxes
    i = naxes - 1
    while n > 1:
        f = 2  # peel the smallest prime factor
        while n % f:
            f += 1
        dims[i] *= f
        n //= f
        i = (i - 1) if i > 0 else naxes - 1
    return tuple(dims)
