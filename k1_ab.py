#!/usr/bin/env python3
"""Time K1's single entry from this checkout against another version of
its source, on one NVIDIA card, in turns.

    git show <commit>:seaweedfs_tpu_torch/csrc/gf_apply.cu > other.cu
    python3 k1_ab.py other.cu [--rounds 3]

Builds seaweedfs_tpu_torch/csrc/gf_apply.cu and OTHER with the same nvcc
command (in parallel, into the package's git-ignored build/), checks that
both give the same bytes, then times both at the six single-entry shapes
of chip_smoke.py's timing phase, in rounds of other, this, this, other
(each reading the CUDA-event median of 30 launches behind a spin kernel,
chip_smoke._device_ms). Prints the card's `nvidia-smi` name and power
limit, the ptxas registers of both builds, and one JSON line per shape
with every reading. Both versions must export gf_apply_launch with the
same C signature. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import threading


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="another version of csrc/gf_apply.cu")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda
    from seaweedfs_tpu_torch.utils import native_build

    print(cs.smi_line(), flush=True)
    command = [rs_cuda.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC"]
    built: dict[str, object] = {}

    def build(name, src):
        try:
            built[name] = native_build.build_shared(src, command)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            built[name] = e

    threads = [threading.Thread(target=build, args=(name, src)) for name, src
               in (("other", args.other), ("this", rs_cuda._SRC))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {}
    for name in ("other", "this"):
        if isinstance(built[name], BaseException):
            raise built[name]
        path, report = built[name]
        lib = ctypes.CDLL(path)
        lib.gf_apply_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.gf_apply_launch.restype = ctypes.c_int
        libs[name] = lib
        print(json.dumps({"build": name, "ptxas": cs._ptxas_lines(report)}),
              flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, m in ((10, 4), (6, 3), (12, 6)):
        mat = gf256.parity_matrix(k, m)
        masks = rs_cuda.selection_masks(mat)
        for n in (1 << 20, 16 << 20):
            sets = 8 if n == 1 << 20 else 2  # past the 50 MB L2
            ins = [torch.randint(0, 256, (k, n), dtype=torch.uint8,
                                 device=dev, generator=gen)
                   for _ in range(sets)]
            outs = [torch.empty((m, n), dtype=torch.uint8, device=dev)
                    for _ in range(sets)]
            rows, grid = rs_cuda.launch_shape(m, k, n)

            def launcher(lib):
                def call(r):
                    x, o = ins[r % sets], outs[r % sets]
                    rc = lib.gf_apply_launch(
                        masks.ctypes.data, m, k, x.data_ptr(), x.stride(0),
                        o.data_ptr(), o.stride(0), n, 1, rows, grid,
                        torch.cuda.current_stream(dev).cuda_stream)
                    if rc:
                        raise RuntimeError(f"launch failed: CUDA error {rc}")
                return call

            results = {}
            for name, lib in libs.items():
                launcher(lib)(0)
                torch.cuda.synchronize()
                results[name] = outs[0].clone()
            if not torch.equal(results["other"], results["this"]):
                raise AssertionError(f"{k}x{n}->{m}: the versions differ")
            readings: dict[str, list[float]] = {"other": [], "this": []}
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    readings[name].append(cs._device_ms(launcher(libs[name]),
                                                        30))
            print(json.dumps({
                "shape": f"{k}x{n >> 20}MiB->{m}", **readings,
                "median_other_ms": statistics.median(readings["other"]),
                "median_this_ms": statistics.median(readings["this"])}),
                flush=True)
            del ins, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
