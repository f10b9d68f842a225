#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--volume-mb 1024] [--seed 0]

Phases, each printing one JSON line:
  1. device   card name and `nvidia-smi` name / power limit
  2. build    compiles csrc/gf_apply.cu (nvcc, sm_90a) and csrc/crc32c.cpp
              (g++) from this checkout, in parallel
  3. kernel   the gf_apply kernel against its plain PyTorch version
              (rs_torch.gf_apply_reference) on the same CUDA tensors, byte for
              byte, over ragged sizes, both row layouts, the parity matrix,
              every 1-loss rebuild matrix and 32 seeded 2-4-loss ones
  4. timing   CUDA-event medians at the two shapes the EC path launches, with
              the plain version's time and the HBM bound
  5-8.        the main path: write a volume of random needles, .ecx, pipelined
              RS(10,4) encode on the card, drop shards {0,5,11,13}, pipelined
              rebuild on the card, decode to .dat, read every needle back with
              its CRC checked
Then the kernel summary line, the `nvidia-smi` line, and the result line
{"ok": true, "device": {...}} last. Any failure raises: the exit code is then
not 0 and no result line is printed. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing anything.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT8_TC_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
LOSS = (0, 5, 11, 13)
K1_REPLACES = "seaweedfs_tpu/ops/rs_pallas.py:56"  # pallas_apply_fn; body _make_kernel :42


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(16 << 20):
            h.update(chunk)
    return h.hexdigest()


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for out = M (m,k) x data (k,n) over GF(2^8): the larger of
    (k+m)*n bytes over HBM bandwidth and the bit-plane product's
    2*(8m)*(8k)*n int8 operations over the tensor-core peak."""
    t_bytes = (k + m) * n / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 64 * m * k * n / INT8_TC_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build() -> None:
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.utils import crc

    results: dict[str, object] = {}

    def run(name, fn):
        t0 = time.monotonic()
        try:
            results[name] = (fn(), time.monotonic() - t0)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            results[name] = e

    threads = [threading.Thread(target=run, args=("gf_apply", rs_cuda.build)),
               threading.Thread(target=run, args=("crc32c", crc.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in results.values():
        if isinstance(r, BaseException):
            raise r
    (gf_lib, ptxas), gf_s = results["gf_apply"]
    crc_lib, crc_s = results["crc32c"]
    if crc._native() is None:
        raise RuntimeError("crc32c library did not load")
    emit("build", gf_apply_s=round(gf_s, 3), crc32c_s=round(crc_s, 3),
         gf_apply_lib=os.path.relpath(gf_lib), crc32c_lib=os.path.relpath(crc_lib),
         ptxas=[ln for ln in ptxas.splitlines() if "registers" in ln
                or "Compiling entry" in ln])


def check_matrices(seed: int):
    """(name, matrix) pairs the EC path gives the kernel: the parity
    matrix, every 1-loss rebuild matrix and 32 seeded 2-4-loss ones that
    mix data and parity, each as plan_rebuild_sources trims it."""
    import numpy as np
    from seaweedfs_tpu_torch.models.coder import make_coder
    from seaweedfs_tpu_torch.storage.erasure_coding.encoder import \
        plan_rebuild_sources
    coder = make_coder()
    mats = [("parity", np.asarray(coder.parity))]
    for s in range(14):
        present = [i for i in range(14) if i != s]
        mats.append((f"lose{s}", plan_rebuild_sources(coder, present, [s])[1]))
    rng = np.random.default_rng(seed)
    while len(mats) < 15 + 32:
        r = int(rng.integers(2, 5))
        lost = sorted(int(x) for x in rng.choice(14, r, replace=False))
        if not (any(i < 10 for i in lost) and any(i >= 10 for i in lost)):
            continue
        present = [i for i in range(14) if i not in lost]
        mats.append((f"lose{lost}", plan_rebuild_sources(coder, present, lost)[1]))
    return mats


def phase_kernel(seed: int) -> int:
    import torch
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.rs_torch import gf_apply_reference
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mats = check_matrices(seed)
    sizes = [1, 3, 15, 17, 4097, (1 << 20) + 5, 16 << 20]
    checks = worst = 0
    before = rs_cuda.launches
    for n in sizes:
        pitch = -(-n // 16) * 16
        for layout in ("contiguous", "aligned_rows"):
            width = n if layout == "contiguous" else pitch
            base = torch.randint(0, 256, (10, width), dtype=torch.uint8,
                                 device=dev, generator=gen)
            data = base[:, :n]
            for name, mat in mats:
                src = data[:mat.shape[1]]
                got = rs_cuda.gf_apply(mat, src)
                want = gf_apply_reference(mat, src)
                torch.cuda.synchronize()
                err = int((got.to(torch.int16) - want.to(torch.int16))
                          .abs().max().item())
                worst = max(worst, err)
                checks += 1
                if err or not torch.equal(got, want):
                    raise AssertionError(
                        f"gf_apply differs from its plain version: n={n} "
                        f"{layout} matrix {name} max_abs_err={err}")
    emit("kernel", checks=checks, matrices=len(mats), sizes=sizes,
         layouts=["contiguous", "aligned_rows"], max_abs_err=worst,
         launches=rs_cuda.launches - before)
    return worst


def _device_ms(fn, reps: int) -> float:
    """Median device time of one call of fn(r). Each call is enqueued
    behind a spin kernel (torch.cuda._sleep) and bracketed by an event
    pair, so host enqueue time is left out; the spin doubles until the
    call's whole enqueue (the plain version issues hundreds of kernels)
    finishes inside it."""
    import torch
    cycles = 1 << 25
    times = []
    while len(times) < reps:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn(len(times))
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead:
            times.append(a.elapsed_time(b))
        elif cycles >= 1 << 33:
            raise RuntimeError("could not enqueue ahead of the card")
        else:
            cycles *= 2
    return statistics.median(times)


def phase_timing(seed: int) -> list[dict]:
    """Median kernel and plain-version device times at the path's two
    shapes. Inputs rotate over enough buffers (80 MiB, 320 MiB) to exceed
    the 50 MB L2, so every launch reads its inputs from HBM."""
    import torch
    from seaweedfs_tpu_torch.models.coder import make_coder
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.rs_torch import gf_apply_reference
    from seaweedfs_tpu_torch.storage.erasure_coding.encoder import \
        plan_rebuild_sources
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    coder = make_coder()
    rmat = plan_rebuild_sources(
        coder, [i for i in range(14) if i not in LOSS], list(LOSS))[1]
    shapes = [("encode 10x1MiB->4 (small-block tier)", coder.parity, 1 << 20, 8),
              ("rebuild 10x16MiB->4 (pipeline batch)", rmat, 16 << 20, 2)]
    rows = []
    before = rs_cuda.launches
    for label, mat, n, sets in shapes:
        m, k = mat.shape
        ins = [torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                             generator=gen) for _ in range(sets)]
        outs = [torch.empty((m, n), dtype=torch.uint8, device=dev)
                for _ in range(sets)]
        for r in range(3):
            rs_cuda.gf_apply(mat, ins[r % sets], outs[r % sets])
            gf_apply_reference(mat, ins[r % sets])
        ms = _device_ms(lambda r: rs_cuda.gf_apply(
            mat, ins[r % sets], outs[r % sets]), 30)
        plain = _device_ms(lambda r: gf_apply_reference(mat, ins[r % sets]), 7)
        bms, by = bound_ms(m, k, n)
        rows.append({"shape": label, "m": m, "k": k, "n": n, "ms": ms,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                     "input_GBps": k * n / ms / 1e6,
                     "bound_us": bms * 1e3})
    emit("timing", shapes=rows, launches=rs_cuda.launches - before)
    return rows


def make_volume(work: str, volume_mb: int, seed: int):
    import numpy as np
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    rng = np.random.default_rng(seed)
    target = volume_mb << 20
    sizes = []
    while sum(sizes) < target:
        sizes.append(int(rng.integers(1 << 10, (4 << 20) + 1)))
    blob = rng.bytes(sum(sizes))
    ids = (rng.permutation(len(sizes)) + 1).tolist()
    cookies = rng.integers(0, 1 << 32, len(sizes)).tolist()
    vol = Volume(work, "", 1)
    payloads = {}
    off = 0
    mv = memoryview(blob)
    for nid, cookie, size in zip(ids, cookies, sizes):
        data = mv[off:off + size]
        off += size
        vol.write_needle(Needle(id=nid, cookie=cookie, data=data))
        payloads[nid] = (cookie, data)
    vol.sync()
    version = vol.version
    vol.close()
    return vol.file_name(), payloads, version


def main_path(work: str, volume_mb: int, seed: int) -> dict:
    import numpy as np
    import torch
    from seaweedfs_tpu_torch.models.coder import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda
    from seaweedfs_tpu_torch.ops.rs_torch import gf_apply_reference
    from seaweedfs_tpu_torch.parallel import streaming
    from seaweedfs_tpu_torch.storage.erasure_coding import (decoder,
                                                            ec_volume,
                                                            encoder, layout)
    from seaweedfs_tpu_torch.storage.needle import Needle

    # 5. volume + .ecx + .vif
    t0 = time.monotonic()
    base, payloads, version = make_volume(work, volume_mb, seed)
    dat_size = os.path.getsize(base + ".dat")
    dat_sha = sha256_file(base + ".dat")
    encoder.write_sorted_ecx(base)
    ec_volume.write_volume_info(base, version, DEFAULT_SCHEME)
    emit("volume", needles=len(payloads), payload_bytes=sum(
        len(d) for _, d in payloads.values()), dat_bytes=dat_size,
        ecx_bytes=os.path.getsize(base + ".ecx"),
        seconds=time.monotonic() - t0,
        reduced="BASELINE config 2's 30 GB volume cut to this size for the "
                "smoke's time limit; config 1's 1024 MiB is the default")

    # 6. pipelined encode on the card
    launches0 = rs_cuda.launches
    stats: dict = {}
    t0 = time.monotonic()
    streaming.pipelined_encode_file(base, stats=stats)
    wall = time.monotonic() - t0
    enc_launches = rs_cuda.launches - launches0
    if enc_launches != stats["batches"] or enc_launches == 0:
        raise AssertionError(f"encode launched gf_apply {enc_launches} times "
                             f"for {stats['batches']} batches")
    parity = gf256.parity_matrix(10, 4)
    files = [open(base + layout.shard_ext(i), "rb") for i in range(14)]
    checked = 0
    try:
        shard_off = 0
        for _, _, _, step in layout.iter_encode_batches(
                dat_size, layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE,
                streaming.DEFAULT_PIPE_BATCH, 10):
            rows = np.empty((14, step), dtype=np.uint8)
            for i, f in enumerate(files):
                f.seek(shard_off)
                if f.readinto(memoryview(rows[i])) != step:
                    raise AssertionError(f"short shard {i} at {shard_off}")
            dev_rows = torch.from_numpy(rows).cuda()
            if not torch.equal(gf_apply_reference(parity, dev_rows[:10]),
                               dev_rows[10:]):
                raise AssertionError(f"parity batch at {shard_off} differs "
                                     "from the plain version")
            shard_off += step
            checked += 1
    finally:
        for f in files:
            f.close()
    if checked != stats["batches"]:
        raise AssertionError(f"checked {checked} of {stats['batches']} batches")
    emit("encode", launches=enc_launches, batches=stats["batches"],
         parity_batches_checked=checked, MBps=dat_size / wall / 1e6,
         wall_s=wall, stages={k: stats[k] for k in (
             "read_s", "encode_s", "write_s", "device_wait_s") if k in stats})

    # 7. lose 4 shards, pipelined rebuild on the card
    shard_sha = {i: sha256_file(base + layout.shard_ext(i)) for i in LOSS}
    for i in LOSS:
        os.remove(base + layout.shard_ext(i))
    launches0 = rs_cuda.launches
    stats = {}
    t0 = time.monotonic()
    rebuilt = streaming.pipelined_rebuild_files(base, stats=stats)
    wall = time.monotonic() - t0
    reb_launches = rs_cuda.launches - launches0
    if sorted(rebuilt) != list(LOSS):
        raise AssertionError(f"rebuilt {rebuilt}, lost {LOSS}")
    if reb_launches != stats["batches"] or reb_launches == 0:
        raise AssertionError(f"rebuild launched gf_apply {reb_launches} "
                             f"times for {stats['batches']} batches")
    for i in LOSS:
        if sha256_file(base + layout.shard_ext(i)) != shard_sha[i]:
            raise AssertionError(f"rebuilt shard {i} differs")
    emit("rebuild", lost=list(LOSS), sources=stats["sources"],
         launches=reb_launches, batches=stats["batches"], sha256_equal=True,
         MBps=stats["rebuilt_bytes"] / wall / 1e6,
         read_MBps=stats["bytes_in"] / wall / 1e6, wall_s=wall,
         stages={k: stats[k] for k in (
             "read_s", "encode_s", "write_s", "device_wait_s") if k in stats})

    # 8. decode to .dat and read every needle back through the shards
    t0 = time.monotonic()
    os.remove(base + ".dat")
    size = decoder.find_dat_file_size(base, base)
    decoder.write_dat_file(base, size)
    if size != dat_size or sha256_file(base + ".dat") != dat_sha:
        raise AssertionError("decoded .dat differs from the original")
    decode_s = time.monotonic() - t0
    t0 = time.monotonic()
    ev = ec_volume.EcVolume(work, "", 1)
    try:
        for sid in range(14):
            ev.add_shard(ec_volume.EcVolumeShard(work, "", 1, sid))
        for nid, (cookie, data) in payloads.items():
            intervals, _, nsize = ev.locate_needle(nid)
            blob = b"".join(ev.read_interval(iv)[0] for iv in intervals)
            n = Needle.from_bytes(blob, nsize, ev.version)  # CRC checked
            if n.id != nid or n.cookie != cookie or n.data != data:
                raise AssertionError(f"needle {nid:x} read back wrong")
    finally:
        ev.close()
    emit("decode", dat_sha256_equal=True, decode_s=decode_s,
         needles_read_back=len(payloads), crc_checked=True,
         read_back_s=time.monotonic() - t0)
    return {"encode": enc_launches, "rebuild": reb_launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--volume-mb", type=int, default=1024,
                    help="MiB of needle payload in the volume (default 1024)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from seaweedfs_tpu_torch.ops import rs_cuda

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    phase_build()
    worst = phase_kernel(args.seed)
    timing = phase_timing(args.seed)

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        rs_cuda.launches = 0
        per_phase = main_path(work, args.volume_mb, args.seed)
        path_launches = rs_cuda.launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if path_launches == 0:
        raise AssertionError("the main path never launched gf_apply")

    rebuild_row = timing[1]
    print(json.dumps({"kernels": [{
        "name": "gf_apply", "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf_apply.cu",
        "replaces": K1_REPLACES, "launches": path_launches,
        "launches_by_phase": per_phase, "max_abs_err": worst,
        "ms": rebuild_row["ms"], "plain_ms": rebuild_row["plain_ms"],
        "bound_ms": rebuild_row["bound_ms"],
        "bound_by": rebuild_row["bound_by"], "library_ms": None,
        "shape": rebuild_row["shape"], "by_shape": timing}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
