#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--volume-mb 1024] [--alt-volume-mb 256]
                          [--batch-volumes 64] [--batch-volume-mb 32]
                          [--cluster-volume-mb 256] [--cli-volume-mb 512]
                          [--filer-mb 1000] [--s3-mb 1024] [--seed 0]

Phases, each printing one JSON line:
  1. device      card name and `nvidia-smi` name / power limit; then the
                 `packages` line: whether grpc, google.protobuf and
                 cryptography import on this machine, and their versions;
                 then `sim`: the port's macro simulator on the host, in this
                 process (no kernel runs: its one coder, LrcCoder, is a host
                 coder in both packages): all ten incidents at 100 actors,
                 seed 0, every invariant passing; rolling_restart at seed 42
                 twice with equal event-log hashes; all ten at 16 actors,
                 each hash equal to the reference's (SIM_REFERENCE_HASHES,
                 held against the JAX package by tests/test_torch_sim.py);
                 per incident passed, log_hash, events and wall seconds
  2. build       compiles csrc/gf_apply.cu and csrc/mxu_apply.cu (nvcc,
                 sm_90a), csrc/crc32c.cpp and csrc/rs_cpu.cpp (g++, the host
                 coder) from this checkout, in parallel; prints the ptxas
                 register lines and the count of int8 tensor-core
                 instructions in mxu_apply's SASS (IGMMA, the warpgroup
                 products; IMMA, the warp ones)
  3. kernel      K1 (gf_apply) against its plain PyTorch version
                 (rs_torch.gf_apply_reference) on the same CUDA tensors, byte
                 for byte, over ragged sizes (both sides of the column count
                 where its launch shape changes), both row layouts, the
                 parity matrix, every 1-loss rebuild matrix and 32 seeded
                 2-4-loss ones
  4. kernel_mxu  K2 (mxu_apply) against its plain version
                 (rs_mxu.mxu_apply_reference) and against K1, byte for byte,
                 at the same sizes and layouts plus the edges of its ring
                 (one to three 1024-position stages, +-1) and of its 64- and
                 256-position tiles, over those matrices plus the RS(6,3) and
                 RS(12,6) parity matrices, seeded rebuild matrices of both
                 and one 16x32 random matrix
  5. kernel_batch  K1's batch entry (gf_apply_batch) against its plain
                 version and against per-job gf_apply, byte for byte:
                 batches of 1, 2, 3 and 64 jobs, ragged and 1 MiB columns,
                 contiguous, 16-byte-pitched and unaligned row and job
                 strides, shared matrices (RS(10,4), RS(6,3), RS(12,6)
                 parity, 16x32) and per-job matrices with fewer rows than
                 the batch's (zero rows)
  6. timing      CUDA-event medians of K1, K2, their plain versions,
                 torch._int_mm on the bit-plane product alone and a device
                 copy of the same byte count (a yardstick), with the bound,
                 at the shapes the EC paths launch; then K1's batch entry
                 at (64,10,1 MiB)->4 (shared matrix) and (8,10,16 MiB)->4
                 (a rebuild matrix per job) beside 64 (8) single launches
                 of the same work
  7-11.          the main path: write a volume of random needles, .ecx,
                 pipelined RS(10,4) encode on K2 (mxu_encode), the same encode
                 on K1 with every shard sha256-equal to K2's, drop shards
                 {0,5,11,13}, pipelined rebuild on K1, decode to .dat, read
                 every needle back with its CRC checked
  12. alt_scheme for RS(6,3) and RS(12,6): a volume of --alt-volume-mb, .ecx,
                 .vif naming the scheme, pipelined encode on K2, drop m
                 shards mixing data and parity, pipelined rebuild on K1
                 (sha256-equal), decode to .dat (sha256-equal), every needle
                 read back with its CRC checked
  13. batch_volumes  BASELINE config 4, the cross-volume batch path:
                 --batch-volumes volumes of --batch-volume-mb, each encoded
                 by its own pipelined_encode_file thread, all at once,
                 through one EcBatchScheduler (5 ms window, batches of up
                 to 64) and one BatchCoder: every shard sha256-equal to
                 CpuCoderMT's encode_array of the same rows, no CPU batch,
                 no fallback, one launch of K1's batch entry per mesh
                 batch; the same volumes encoded one after another with
                 TorchCoder for comparison; then 8 volumes lose 1-4 shards
                 (data, parity, mixed), are rebuilt concurrently through
                 the same BatchCoder (sha256-equal, at least one launch
                 carrying different matrices), decoded and read back
  14. batch_encode_volumes  streaming.batch_encode_volumes at
                 (64,10,1 MiB) without a mesh, on batch_mesh() and on a
                 one-card ('data', 'shard', 'seq') mesh, against CpuCoderMT;
                 distributed_rebuild on that mesh for three loss patterns
  15. degraded_reads  the main volume's 10 surviving shards (a hard-linked
                 copy taken before the rebuild) mounted in a Store with
                 coder=None, the card coder: every needle read whole
                 (CRC-checked, byte-equal), one K1 launch per interval of
                 a lost shard; again with a NeedleCache, cold then warm
                 (no launch); 64 seeded ranges crossing a lost shard with
                 ec_needle_meta + read_ec_needle_data_range; wall time and
                 MB/s per pass, per-interval reconstruct median and p99
  16. degraded_reads_batched  the same volume read by 32 threads through a
                 Store whose coder is a BatchCoder over one scheduler: same
                 bytes, no fallback, a batch-entry launch per mesh batch
  17. ec_delete  16 needles deleted through the Store: reads refused, also
                 through the cache; rebuild_ecx_file folds the .ecj into
                 .ecx tombstones
  18. lrc_volume  LRC(10,2,2) and RS(10,4) volumes of --alt-volume-mb
                 encoded at once through one scheduler (launches carrying
                 both parity matrices), sha256-equal to the host coders;
                 shard 7 lost: Store reads plan group-local (5 sources) on
                 the host for LRC and recover on K1 for RS; one block
                 through the LRC facade (a CPU batch, no fallback); {2,12}
                 lost and rebuilt on the facade through K1's batch entry
  19. server     the volume server's EC plane over HTTP (the port's
                 http_call; the master an address where nothing listens):
                 a VolumeServer on the card allocates a volume, takes
                 --volume-mb of seeded needles as raw POSTs and serves
                 every one back (zero-copy GETs); mark_readonly,
                 /admin/ec/generate (K1, one launch per batch; the 14
                 shards sha256-equal to CpuCoderMT's), mount, delete the
                 volume; every needle GET from the EC volume; shards
                 {0,5,11,13} unmounted and deleted; every needle GET again
                 on 1 and on 16 client threads (one K1 launch per
                 recovered interval) and 64 seeded Range GETs across a lost
                 shard; /admin/ec/rebuild (sha256-equal); a data and a
                 parity shard byte flipped in two row groups, /admin/scrub
                 names exactly those (K1: one encode per row group plus the
                 leave-one-out search), undone, a clean scrub; /metrics and
                 /admin/cache. Then server_batcher: a second server with
                 ec_batcher=True generates and rebuilds a volume of
                 --alt-volume-mb on K1's batch entry (no CPU batch, no
                 fallback, sha256-equal)
  20. cluster    the port's own cluster: its MasterServer (1024 MiB volume
                 size limit, default repair settings), four of its
                 VolumeServers on the card on racks r0 / r1 of dc1, its
                 MasterClient and ShellContext, all in this process.
                 --cluster-volume-mb (256; the filer phase runs 1000) of
                 seeded needles uploaded through client.operation into the
                 one volume the master grows; ec.encode (K1 on the source,
                 one launch per batch; the 14 spread shards sha256-equal to
                 CpuCoderMT's); every needle GET from the holders on 1 and
                 16 client threads; the server holding the most shards
                 stopped and pruned; every needle GET again (one K1 launch
                 per interval a server reconstructs); ec.rebuild (K1 on the
                 rebuilder, sha256-equal) and a GET pass; a holder's parity
                 shard flipped, its /admin/scrub (remote-assisted, on the
                 host) reports it and the master's repair queue restores it
                 (partial chain, sha256-equal); ec.decode and every needle
                 read back through client.operation. Per step: wall time,
                 MB/s, GET p50 / p99, remote interval reads, master lookups
                 and reconstructs
  21. cli        the port from its command line, each server in its own
                 process: three `python -m seaweedfs_tpu_torch.cli master
                 -peers A,B,C -volumeSizeLimitMB 1024 -grpc` (Raft) and
                 four `... volume -mserver A,B,C -rack r0|r1 -grpc` on the
                 card (the default coder, K1), each with its gRPC plane on
                 its port + 10000, the servers started through this
                 script's `volume-child` entry, which reports each
                 process's kernel launch counts in a JSON file (reset with
                 SIGUSR1). The shell and backup commands run through its
                 `cli-child` entry, which counts the HTTP requests and
                 volume-server RPCs each sends. One
                 leader elected and every server registered with it;
                 `benchmark -n 4096 -size 1024 -concurrency 16`;
                 --cli-volume-mb (512) of seeded needles uploaded through
                 client.operation; `fix` on a copy of the sealed .dat,
                 held against the server's .idx; `ec encode` over gRPC
                 (K1 on the source, one launch per batch; shards
                 sha256-equal to CpuCoderMT's; VolumeEcShardsGenerate
                 once, no admin request over HTTP); GETs on 1 and 16
                 threads; the server
                 holding the most shards SIGKILLed; degraded GETs on 1 and
                 16 threads (one K1 launch per interval, counted on each
                 server); the Raft leader SIGKILLed, a new leader elected
                 and the live servers re-registered (the failover time);
                 one more upload, its volume id and key never minted
                 before; `backup` of that volume (a full copy), one more
                 needle, `backup` again (an incremental catch-up over the
                 VolumeTailSender stream, no HTTP copy); from this process
                 VolumeEcShardsGenerate of that volume through the port's
                 GrpcVolumeClient (K1 on its server, sha256-equal to
                 CpuCoderMT's) and VolumeEcShardsDelete, then two more
                 volumes of --cli-volume-mb / 4 allocated on that server
                 and generated at once from two threads (K1 launches =
                 both volumes' batches, each sha256-equal); `master.follower
                 -grpcAddresses` over the masters' gRPC planes with a dead
                 -masters address answering /dir/lookup as the leader does
                 from its pushed vidMap; `lock` / `ec.rebuild` / `unlock`
                 piped into `weed shell` over gRPC (K1 on the rebuilder,
                 sha256-equal; VolumeEcShardsRebuild once, no admin
                 request over HTTP; any `error:` fails); GETs; `ec decode`
                 (the .dat sha256-equal to the
                 source's); every needle read back and four through `weed
                 download`. Each server holds a CUDA context (nvidia-smi
                 lists one compute app per process; its /dev/nvidiaN is
                 open). Any nonzero exit of a CLI process fails the phase
  22. filer      the filer in front of the card's volume servers, each a
                 process of its own: one `... master -volumeSizeLimitMB
                 1024`, four `... volume` on the card (racks r0 / r1,
                 through `volume-child`) and `... filer -store lsm -dir D
                 -grpc`.
                 A seeded tree of --filer-mb (1000) MiB in 64 directories
                 three levels deep: 3900 files of 1-128 KiB, 40 of 256
                 KiB-4 MiB (one chunk: the filer answers them with a 302 to
                 a volume server) and files of 4-16 MiB (several 4 MiB
                 chunks, proxied by the filer). `weed shell` fs.configure
                 puts /data in the collection filer_smoke; `filer.copy`
                 copies the tree; fs.du and volume.fsck hold the namespace
                 against the tree and the volumes; every file GET through
                 the filer on 1 and 16 threads, following 302s, sha256-
                 equal; `lock` / `ec.encode -collection filer_smoke` /
                 `unlock` (K1 on each source, one launch per batch); the
                 server holding the most shards SIGKILLed (every volume
                 keeps at least 10) and dropped by the master; the filer
                 SIGKILLed and restarted from its lsm directory (a cold
                 chunk cache; fs.du unchanged); degraded GETs through it,
                 1 thread over the redirected then the proxied files, and
                 16 threads (one K1 launch per interval each live server
                 reconstructs, above 0 on both routes); the rebuild, by
                 the master's repair queue where its 60 s grace ran out
                 first (its partial chain: GF partial products on the
                 host, no K1 launch, a fallback to copy + rebuild fails
                 the step) and by `ec.rebuild` for the rest (K1 on the
                 rebuilders, one launch per batch); where the queue came
                 first, the shards it rebuilt are unmounted and deleted
                 from their holder and `ec.rebuild` rebuilds them at once
                 on the card. Every rebuilt shard sha256-equal to the one
                 the killed server held, every shard registered once; volume.fsck (no missing chunk), fs.du,
                 fs.ls; one leaf directory listed through the port's
                 GrpcFilerClient equal to its HTTP listing (names, sizes,
                 chunk file ids); `fs.rm -r` of one top directory,
                 `volume.fsck -fix` (any orphan one of the removed
                 chunks), the removed chunks gone from the EC volumes and
                 the filer's chunk GC
                 counting each deleted, none abandoned. nvidia-smi lists
                 the smoke and the live volume servers only; the filer
                 holds no /dev/nvidiaN.
                 The S3 route in the same process layout (the `s3` line):
                 `... s3 -filer F -master M` beside the filer (its view
                 of the filer through filer/remote_store.py; no
                 /dev/nvidiaN either). First the cloud tier, unsigned as
                 storage/backend.py is: a bucket `cold` of --s3-mb / 4
                 MiB written through the gateway into volumes of its own,
                 each marked read-only and moved by `volume.tier.upload`
                 to the gateway's bucket `tier`, every cold object read
                 back through the gateway (volume server ->
                 S3BackendFile range reads -> the gateway -> the other
                 servers; the tier reads counted from the gateway's
                 metrics), /admin/tier, `volume.tier.download` (each
                 .dat sha256-equal to the tiered one), every object read
                 again, both buckets deleted (the gateway's chunk GC
                 counting every chunk). Then `s3.configure` through the
                 REPL and SigV4-signed traffic through the port's
                 S3Remote: --s3-mb (1024) MiB of seeded objects of 1 KiB
                 to 64 MiB in the bucket `bkt`, four of them multipart
                 in 8 MiB parts, PUT on 1 and 16 threads, GET on 1 and
                 16 threads sha256-equal, ListObjectsV2 by prefix and
                 delimiter, a presigned GET, unsigned requests refused.
                 `ec.encode -collection bkt` runs right after that
                 traffic, the tree's right after its GETs (each volume
                 younger than the tiering autopilot's 120 s); the
                 gateway restarts with the filer (a cold chunk cache); at
                 the same SIGKILL every object and 64 Range GETs through the
                 gateway on one thread as soon as the master has dropped
                 the server (before the filer's passes, so well inside the
                 repair queue's grace), and on 16 threads after the
                 filer's passes (K1 launches = the live
                 servers' reconstructs, above 0 over both); after the
                 rebuild every object once more; last the bucket deleted
                 through S3 and its chunks counted by the gateway's GC.
                 The route's K1 launches count under the path key `s3`.
                 The stores route in the same process layout (the `stores`
                 line), after the tree's `ec.encode` and before the kill:
                 the port's servers of the seven wire families (redis,
                 mysql, postgres, mongodb, cassandra, elastic, etcd) in one
                 process of their own (`db-child`), and for each a `...
                 filer -store <family> -dir 127.0.0.1:<port>` against the
                 phase's master, /stores/ sent to the collection `stores`
                 on it, `filer.copy` of a seeded tree of 256 files of 1-256
                 KiB in 4 directories and one of 8-12 MiB (three chunks),
                 every file GET through its filer sha256-equal, the filer
                 SIGKILLed and restarted on the same database (its time to
                 a first answer), fs.du and the listing equal to the tree;
                 then `ec.encode -collection stores` at once (K1 on its
                 source). Each volume is encoded
                 while younger than 120 s: the master's tiering autopilot
                 moves an older volume by itself once `ec.encode` seals it
                 (hot to EC when its reads have gone quiet, EC back to hot
                 when they have not), and the phase fails by name if it
                 moved one being encoded. The stores volume loses shards
                 with the killed server and is rebuilt with the others (K1
                 on the rebuilder); after the rebuild every file of every
                 family GET again through its filer, sha256-equal. Its K1
                 launches count under the path key `stores` and equal the
                 stores volume's encode and rebuild batches.
                 The replication and mount routes in the same process
                 layout (the `replication` line), the filer started with
                 `-mq -mqPort P` from its first start on: right after the
                 one-thread degraded S3 pass, while the volumes are
                 degraded, `... filer.backup -filer F -filerPath
                 /data/tree/<dir> -dir <mirror>` (through `cli-child`) on
                 the largest second-level directory of at most 64 MiB,
                 done when every file is in the mirror sha256-equal (it
                 replays F's change log, which F journals beside its lsm
                 store across the restart), then `mount-child`: what `...
                 mount -filer F` serves short of the kernel
                 (cli.open_mount: WeedFS over F's remote store view, its
                 gRPC admin plane announced to the master) reads every
                 file of a second such directory through lookup / open /
                 read / release sha256-equal, writes four seeded files
                 under /mount_rw, renames and reads them back, and the
                 REPL's `mount.configure -collectionCapacity 3 GiB`
                 changes what its statfs reports. K1 launches = the live
                 servers' reconstructs, under the path keys `sync` and
                 `mount` (above 0 together). After the rebuild and the
                 bucket's deletion, on healthy volumes: a second `...
                 filer -store lsm` B and `... filer.sync -a F -b B
                 -aPrefix /data/tree/<dir> -bPrefix /sync_b` (the
                 directory on B sha256-equal, a file written on B under
                 /sync_b on F, neither change log growing after: no
                 echo); `... filer.meta.tail -pathPrefix /data` and `...
                 filer.meta.backup -filerPath /data`, each counting one
                 create per directory and file of the tree and one delete
                 per entry `fs.rm -r` removed; 4096 seeded records of
                 1-16 KiB on 16 keys published to F's mq broker through
                 the port's MqClient, each partition replayed in publish
                 order, its segments filer files with chunks on the volume
                 servers, `mq.topic.list` naming the topic. No volume
                 written since the kill is moved by the tiering
                 autopilot; no route's process holds /dev/nvidiaN
Then the memory line, the kernel summary line, the `nvidia-smi` line, and
the result line {"ok": true, "device": {...}} last. Each path phase is
driven with every kernel entry's launch counter set to 0 just before it
and read just after. Any failure raises: the exit code is then not 0 and
no result line is printed.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing anything.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT8_TC_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
LOSS = (0, 5, 11, 13)
ALT_SCHEMES = ((6, 3), (12, 6))  # BASELINE.json config 5
K1_REPLACES = "seaweedfs_tpu/ops/rs_pallas.py:56"  # pallas_apply_fn; body _make_kernel :42
K2_REPLACES = "seaweedfs_tpu/ops/rs_mxu.py:88"  # mxu_apply_fn; body _make_kernel :65
# K1's batch entry replaces K1 on the batch path; the JAX package runs that
# path as XLA programs, not Pallas kernels
K1_BATCH_COUNTERPART = ("seaweedfs_tpu/ops/rs_mesh.py:46 batch_encode_fn, "
                        ":63 batch_apply_fn (XLA, not Pallas)")
BATCH_LOSSES = ((3,), (12,), (0, 7), (10, 13), (2, 9, 10), (0, 3, 7, 9),
                (10, 11, 12, 13), (0, 5, 11, 13))
BATCH_ENCODE_SHAPE = (64, 10, 1 << 20)  # volumes, k, columns (config 4)


# run_incident(name, seed=0, n_actors=16)["log_hash"] of the reference
# package (seaweedfs_tpu/sim); tests/test_torch_sim.py recomputes it there
SIM_REFERENCE_HASHES = {
    "az_loss":
        "7d97cbf9e6d1a28171cb0ef2b66eeed1f9f7d1cc34ee466edc530a219a6eb6ac",
    "diurnal_sweep":
        "559bf54ca49524a866fc621be1370b4ec9bbc0fadff936b259b0c42277c812e6",
    "ec_single_shard_loss":
        "634b1dfa9cacd46efcbce08685886d124deb90e609ae0a5a562103fbfe4b30ad",
    "herd_repair":
        "c57e029cf864bfa0c509c6a9ceaa853ea0d919470fecb9c3ada8ebff6f4c0a4f",
    "hot_shard_migration":
        "622da30fc1f8b9301b2213183905c2fe6cd6720461747aad23571189c60d7c55",
    "master_failover_mid_repair":
        "423e6009d96935ff1b55cb40af3c9e2efa3b091f90af13f3628c13f4f026f0c9",
    "master_failover_mid_write":
        "69f14ba5ea33390766b08d4b6bfed2dc2aefa6f7f639d136e087dc1ac40d5601",
    "partition_heal_mid_repair":
        "8b1a979f202de58f3ae290ea9d6b378531d49fe300b1bb94ea16320ed809ff27",
    "rolling_restart":
        "f77ab22e342e86b0e33196d83ddc49d122a6bbd3916ea9804890c26fd7c7e85f",
    "tenant_flood":
        "8fc8af3187fd5166251f0964681617fd3a9d812e9ff7755fcef5122845c422bf",
}
SIM_ACTORS = 100            # the reference's acceptance size


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def packages() -> dict:
    """Whether the gRPC plane's packages import here, and their versions
    (the port's gRPC slice needs them; nothing else imports them)."""
    import importlib
    out = {}
    for mod in ("grpc", "google.protobuf", "cryptography"):
        try:
            out[mod] = getattr(importlib.import_module(mod), "__version__",
                               "unknown version")
        except ImportError as e:
            out[mod] = f"not importable: {e}"
    return out


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


def _ptxas_lines(out: str) -> dict[str, str]:
    """ptxas -v per kernel instantiation, compactly: template arguments ->
    "registers, spill stores/loads" (the full report runs to hundreds of
    lines and would push the result lines out of a capped log)."""
    import re
    report, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            args = re.findall(r"(?:Li|Lb)(\d+)E", m.group(1))
            name = "/".join(args) or m.group(1)[-40:]
            if "batch" in m.group(1):
                name = "batch " + name
        elif name and "Used" in ln and "registers" in ln:
            report[name] = re.search(r"Used (\d+) registers", ln).group(1)
        elif name and "spill stores" in ln:
            sp = re.findall(r"(\d+) bytes spill", ln)
            if any(int(x) for x in sp):
                report[name + " spill"] = "/".join(sp)
    return report


def imma_count(lib: str) -> dict[str, int]:
    """int8 tensor-core instructions in the library's SASS: IGMMA (the
    warpgroup products, wgmma) and IMMA (the warp ones, mma.sync)."""
    from seaweedfs_tpu_torch.ops import rs_cuda
    cuobjdump = os.path.join(os.path.dirname(rs_cuda.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    lines = sass.splitlines()
    return {op: sum(1 for ln in lines if op in ln) for op in ("IGMMA", "IMMA")}


def phase_build() -> None:
    from seaweedfs_tpu_torch.native import rs_native
    from seaweedfs_tpu_torch.ops import rs_cuda, rs_mxu
    from seaweedfs_tpu_torch.utils import crc

    results: dict[str, object] = {}

    def run(name, fn):
        t0 = time.monotonic()
        try:
            results[name] = (fn(), time.monotonic() - t0)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            results[name] = e

    threads = [threading.Thread(target=run, args=("gf_apply", rs_cuda.build)),
               threading.Thread(target=run, args=("mxu_apply", rs_mxu.build)),
               threading.Thread(target=run, args=("crc32c", crc.build)),
               threading.Thread(target=run, args=("rs_cpu", rs_native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in results.values():
        if isinstance(r, BaseException):
            raise r
    (gf_lib, gf_ptxas), gf_s = results["gf_apply"]
    (mxu_lib, mxu_ptxas), mxu_s = results["mxu_apply"]
    crc_lib, crc_s = results["crc32c"]
    rs_cpu_lib, rs_cpu_s = results["rs_cpu"]
    if crc._native() is None:
        raise RuntimeError("crc32c library did not load")
    if not rs_native.available():
        raise RuntimeError("the host coder's library did not load")
    tc = imma_count(mxu_lib)
    if tc["IGMMA"] == 0:
        raise AssertionError("mxu_apply's SASS holds no IGMMA instruction: "
                             "the product is not on the warpgroup tensor "
                             "cores")
    emit("build", gf_apply_s=round(gf_s, 3), mxu_apply_s=round(mxu_s, 3),
         crc32c_s=round(crc_s, 3), gf_apply_lib=os.path.relpath(gf_lib),
         mxu_apply_lib=os.path.relpath(mxu_lib),
         crc32c_lib=os.path.relpath(crc_lib), rs_cpu_s=round(rs_cpu_s, 3),
         rs_cpu_lib=os.path.relpath(rs_cpu_lib),
         rs_cpu_tier=rs_native.impl_name(),
         ptxas=_ptxas_lines(gf_ptxas), mxu_ptxas=_ptxas_lines(mxu_ptxas),
         mxu_igmma_instructions=tc["IGMMA"],
         mxu_imma_instructions=tc["IMMA"])


def phase_sim() -> None:
    """The port's macro simulator on the host, in this process: every
    incident at SIM_ACTORS actors, seed 0, with every invariant passing;
    rolling_restart at seed 42 twice, the two event-log hashes equal; every
    incident at 16 actors, seed 0, its hash equal to the reference's
    (SIM_REFERENCE_HASHES). No kernel runs: the one coder the simulator
    calls, LrcCoder, is a host coder in both packages."""
    from seaweedfs_tpu_torch.sim.incidents import INCIDENTS, run_incident
    if sorted(INCIDENTS) != sorted(SIM_REFERENCE_HASHES):
        raise AssertionError(f"incidents {sorted(INCIDENTS)}")
    t_all = time.monotonic()
    matrix = {}
    for name in sorted(INCIDENTS):
        t0 = time.monotonic()
        r = run_incident(name, seed=0, n_actors=SIM_ACTORS)
        matrix[name] = {"passed": r["passed"], "log_hash": r["log_hash"],
                        "events": r["events"],
                        "wall_s": time.monotonic() - t0}
        if not r["passed"]:
            failed = [c for c in r["invariants"] if not c["ok"]]
            raise AssertionError(f"sim {name} at {SIM_ACTORS} actors: "
                                 f"{failed}")
    t0 = time.monotonic()
    twice = [run_incident("rolling_restart", seed=42,
                          n_actors=SIM_ACTORS)["log_hash"] for _ in range(2)]
    twice_s = time.monotonic() - t0
    if twice[0] != twice[1]:
        raise AssertionError(f"rolling_restart seed 42: hashes {twice}")
    t0 = time.monotonic()
    small = {name: run_incident(name, seed=0, n_actors=16)["log_hash"]
             for name in sorted(INCIDENTS)}
    small_s = time.monotonic() - t0
    wrong = {n: h for n, h in small.items() if h != SIM_REFERENCE_HASHES[n]}
    if wrong:
        raise AssertionError(f"sim hashes at 16 actors differ from the "
                             f"reference's: {wrong}")
    emit("sim", actors=SIM_ACTORS, seed=0, incidents=matrix,
         seed42_rolling_restart={"log_hash": twice[0], "equal": True,
                                 "wall_s": twice_s},
         reference_hashes_16_actors={"equal": True, "incidents": len(small),
                                     "wall_s": small_s},
         wall_s=time.monotonic() - t_all,
         kernels="none: LrcCoder, the simulator's one coder, is a host "
                 "coder in both packages")


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
    # what a degraded read of the main volume launches: every lost shard
    # from the first k survivors (Store -> TorchCoder.reconstruct)
    present = [i for i in range(14) if i not in LOSS]
    mats.append(("degraded read", coder.rebuild_matrix(present, LOSS)))
    return mats


def phase_kernel(seed: int) -> int:
    import torch
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.rs_torch import gf_apply_reference
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mats = check_matrices(seed)
    # ragged sizes, and both sides of rs_cuda.SMALL_N_LIMIT
    sizes = [1, 3, 15, 17, 4097, (1 << 20) + 5, rs_cuda.SMALL_N_LIMIT - 1,
             rs_cuda.SMALL_N_LIMIT, 16 << 20]
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


def alt_loss(scheme, seed: int) -> list[int]:
    """m seeded shard ids of `scheme` to drop, data and parity mixed."""
    import numpy as np
    k, total = scheme.data_shards, scheme.total_shards
    rng = np.random.default_rng(seed * 1000 + k)
    while True:
        lost = sorted(int(x) for x in rng.choice(
            total, scheme.parity_shards, replace=False))
        if any(i < k for i in lost) and any(i >= k for i in lost):
            return lost


def alt_matrices(seed: int, per_scheme: int = 6):
    """(name, matrix) pairs of the alternate schemes: each parity matrix,
    the rebuild matrix of its alt_loss and seeded 1..m-loss ones."""
    import numpy as np
    from seaweedfs_tpu_torch.models.coder import RSScheme, make_coder
    from seaweedfs_tpu_torch.storage.erasure_coding.encoder import \
        plan_rebuild_sources
    mats = []
    rng = np.random.default_rng(seed + 7)
    for k, m in ALT_SCHEMES:
        scheme = RSScheme(k, m)
        coder = make_coder(scheme=scheme)
        mats.append((f"RS({k},{m}) parity", np.asarray(coder.parity)))
        losses = [alt_loss(scheme, seed)]
        while len(losses) < per_scheme:
            r = int(rng.integers(1, m + 1))
            losses.append(sorted(int(x) for x in rng.choice(
                k + m, r, replace=False)))
        for lost in losses:
            present = [i for i in range(k + m) if i not in lost]
            mats.append((f"RS({k},{m}) lose{lost}",
                         plan_rebuild_sources(coder, present, lost)[1]))
    return mats


def phase_kernel_mxu(seed: int) -> int:
    """K2 against its plain version and against K1 on the same CUDA
    tensors, byte for byte."""
    import numpy as np
    import torch
    from seaweedfs_tpu_torch.ops import rs_cuda, rs_mxu
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    rng = np.random.default_rng(seed + 3)
    mats = check_matrices(seed) + alt_matrices(seed) + [
        ("random 16x32", rng.integers(0, 256, (16, 32), dtype=np.uint8))]
    # phase_kernel's sizes plus the edges of the kernel's ring: 1, 2 and 3
    # stages of 1024 positions +-1, a 64-position tile and a 256-position
    # super-tile with a tail
    sizes = [1, 3, 15, 17, 65, 127, 257, 1023, 1024, 1025, 2047, 2048, 2049,
             3071, 3072, 3073, 4097, (1 << 20) + 5, 16 << 20]
    checks = worst = 0
    before = rs_mxu.launches
    for n in sizes:
        pitch = -(-n // 16) * 16
        for layout in ("contiguous", "aligned_rows"):
            width = n if layout == "contiguous" else pitch
            base = torch.randint(0, 256, (32, width), dtype=torch.uint8,
                                 device=dev, generator=gen)
            data = base[:, :n]
            for name, mat in mats:
                src = data[:mat.shape[1]]
                got = rs_mxu.mxu_apply(mat, src)
                plain = rs_mxu.mxu_apply_reference(mat, src)
                k1 = rs_cuda.gf_apply(mat, src)
                torch.cuda.synchronize()
                for other, what in ((plain, "its plain version"), (k1, "K1")):
                    err = int((got.to(torch.int16) - other.to(torch.int16))
                              .abs().max().item())
                    worst = max(worst, err)
                    checks += 1
                    if err or not torch.equal(got, other):
                        raise AssertionError(
                            f"mxu_apply differs from {what}: n={n} {layout} "
                            f"matrix {name} max_abs_err={err}")
    emit("kernel_mxu", checks=checks, matrices=len(mats), sizes=sizes,
         layouts=["contiguous", "aligned_rows"], against=["plain", "K1"],
         max_abs_err=worst, launches=rs_mxu.launches - before)
    return worst


def _batch_layouts(B: int, n: int, dev, gen):
    """(name, (B, 32, n) uint8 CUDA tensor) pairs: contiguous; rows on a
    16-byte pitch; and odd row and job strides from an odd offset (the
    byte path)."""
    import torch
    pitch = -(-n // 16) * 16
    rs, js = n + 3, 32 * (n + 3) + 5
    yield "contiguous", torch.randint(0, 256, (B, 32, n), dtype=torch.uint8,
                                      device=dev, generator=gen)
    yield "aligned_rows", torch.randint(
        0, 256, (B, 32, pitch), dtype=torch.uint8, device=dev,
        generator=gen)[:, :, :n]
    flat = torch.randint(0, 256, (B * js + 1,), dtype=torch.uint8,
                         device=dev, generator=gen)
    yield "unaligned", flat.as_strided((B, 32, n), (js, rs, 1), 1)


def batch_matrix_sets(seed: int, B: int):
    """(name, matrices) pairs for a batch of B jobs: shared parity
    matrices of the three schemes and a random 16x32 matrix; per-job
    rebuild matrices of each scheme (1..m rows, so most jobs have fewer
    rows than the batch and zero rows pad them) and random per-job ones
    (1..16 rows over 32 inputs)."""
    import numpy as np
    rng = np.random.default_rng(seed + B)
    from seaweedfs_tpu_torch.ops.lrc import LrcCoder
    rs104 = [m for _, m in check_matrices(seed)[1:]]
    rs104_parity = check_matrices(seed)[0][1]
    alt = alt_matrices(seed)
    sets = [("RS(10,4) parity", rs104_parity)]
    sets += [(name, mat) for name, mat in alt if "parity" in name]
    sets.append(("random 16x32", rng.integers(0, 256, (16, 32),
                                             dtype=np.uint8)))
    sets.append(("per-job RS(10,4) rebuild",
                 [rs104[int(i)] for i in rng.integers(0, len(rs104), B)]))
    for k, m in ALT_SCHEMES:
        mats = [mat for name, mat in alt
                if name.startswith(f"RS({k},{m}) lose")]
        sets.append((f"per-job RS({k},{m}) rebuild",
                     [mats[int(i)] for i in rng.integers(0, len(mats), B)]))
    # the LRC facade's encodes beside RS encodes in one launch
    lrc_parity = LrcCoder()._parity
    sets.append(("per-job RS(10,4) / LRC(10,2,2) parity",
                 [lrc_parity if i % 2 else rs104_parity
                  for i in range(B)]))
    sets.append(("per-job random up to 16x32",
                 [rng.integers(0, 256, (int(rng.integers(1, 17)), 32),
                               dtype=np.uint8) for _ in range(B)]))
    return sets


def phase_kernel_batch(seed: int) -> int:
    """K1's batch entry against its plain version and against per-job
    gf_apply launches on the same CUDA tensors, byte for byte."""
    import torch
    from seaweedfs_tpu_torch.ops import rs_cuda
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    small = [4, 16, 4097, 4100, 1 << 20, (1 << 20) + 4]
    cases = [(B, n) for B in (1, 2, 3) for n in small] + \
        [(64, n) for n in (4, 4100, (1 << 20) + 4)]
    checks = worst = 0
    before = (rs_cuda.batch_launches, rs_cuda.launches)
    for B, n in cases:
        sets = batch_matrix_sets(seed, B)
        for layout, base in _batch_layouts(B, n, dev, gen):
            for name, mats in sets:
                mat, per_job = rs_cuda.batch_matrices(mats, B)
                src = base[:, :mat.shape[-1]]
                got = rs_cuda.gf_apply_batch(mats, src)
                plain = rs_cuda.gf_apply_batch_reference(mats, src)
                single = torch.zeros_like(got)
                for b in range(B):  # a per-job matrix without its zero rows
                    jm = mats[b] if per_job else mat
                    rs_cuda.gf_apply(jm, src[b], single[b, :len(jm)])
                torch.cuda.synchronize()
                for other, what in ((plain, "its plain version"),
                                    (single, "per-job gf_apply")):
                    err = int((got.to(torch.int16) - other.to(torch.int16))
                              .abs().max().item())
                    worst = max(worst, err)
                    checks += 1
                    if err or not torch.equal(got, other):
                        raise AssertionError(
                            f"gf_apply_batch differs from {what}: B={B} "
                            f"n={n} {layout} {name} max_abs_err={err}")
        del base
    emit("kernel_batch", checks=checks, cases=[list(c) for c in cases],
         layouts=["contiguous", "aligned_rows", "unaligned"],
         matrix_sets=[name for name, _ in batch_matrix_sets(seed, 2)],
         against=["plain", "per-job gf_apply"], max_abs_err=worst,
         launches=rs_cuda.batch_launches - before[0],
         single_launches=rs_cuda.launches - before[1])
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
    """Median device times of K1, K2 and their plain versions at the
    shapes the EC paths launch: the encode batch (one small-block row) and
    the rebuild batch (16 MiB) of each scheme. At the RS(10,4) shapes also
    torch._int_mm on the bit-plane product alone (product only: no unpack,
    no mod 2, no repack, so not the same function; cuBLASLt refuses the
    product's shape for RS(6,3)). copy_floor_ms is a yardstick, not a
    library call for the same function and never called by the port: the
    device time of one torch.Tensor.copy_ that moves (k+m)*n/2 bytes each
    way, as many bytes as the kernels move, which says what one launch of
    that size gets from the card. Inputs rotate over enough buffers
    (>= 48 MiB, >= 192 MiB) to exceed the 50 MB L2, so every launch reads
    its inputs from HBM."""
    import torch
    from seaweedfs_tpu_torch.models.coder import RSScheme, make_coder
    from seaweedfs_tpu_torch.ops import rs_cuda, rs_mxu
    from seaweedfs_tpu_torch.ops.rs_torch import gf_apply_reference
    from seaweedfs_tpu_torch.storage.erasure_coding.encoder import \
        plan_rebuild_sources
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    shapes = []
    for k, m in ((10, 4),) + ALT_SCHEMES:
        scheme = RSScheme(k, m)
        coder = make_coder(scheme=scheme)
        lost = list(LOSS) if (k, m) == (10, 4) else alt_loss(scheme, seed)
        rmat = plan_rebuild_sources(
            coder, [i for i in range(k + m) if i not in lost], lost)[1]
        int_mm = (k, m) == (10, 4)
        shapes += [(f"encode {k}x1MiB->{m} (small-block tier)", coder.parity,
                    1 << 20, 8, int_mm),
                   (f"rebuild {rmat.shape[1]}x16MiB->{rmat.shape[0]} "
                    "(pipeline batch)", rmat, 16 << 20, 2, int_mm)]
    rows = []
    before = (rs_cuda.launches, rs_mxu.launches)
    for label, mat, n, sets, with_int_mm in shapes:
        m, k = mat.shape
        ins = [torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                             generator=gen) for _ in range(sets)]
        outs = [torch.empty((m, n), dtype=torch.uint8, device=dev)
                for _ in range(sets)]
        bmat = torch.from_numpy(rs_mxu.bitplane_matrix(mat)).to(dev)
        planes = [rs_mxu._unpack_planes(x).to(torch.int8) for x in ins] \
            if with_int_mm else []
        for r in range(3):
            rs_cuda.gf_apply(mat, ins[r % sets], outs[r % sets])
            rs_mxu.mxu_apply(mat, ins[r % sets], outs[r % sets])
            gf_apply_reference(mat, ins[r % sets])
            rs_mxu.mxu_apply_reference(mat, ins[r % sets])
            if with_int_mm:
                torch._int_mm(bmat, planes[r % sets])
        gf_ms = _device_ms(lambda r: rs_cuda.gf_apply(
            mat, ins[r % sets], outs[r % sets]), 30)
        mxu_ms = _device_ms(lambda r: rs_mxu.mxu_apply(
            mat, ins[r % sets], outs[r % sets]), 30)
        gf_plain = _device_ms(
            lambda r: gf_apply_reference(mat, ins[r % sets]), 7)
        mxu_plain = _device_ms(
            lambda r: rs_mxu.mxu_apply_reference(mat, ins[r % sets]), 7)
        int_mm = _device_ms(
            lambda r: torch._int_mm(bmat, planes[r % sets]), 15) \
            if with_int_mm else None
        half = (k + m) * n // 2
        csrc = [torch.randint(0, 256, (half,), dtype=torch.uint8, device=dev,
                              generator=gen) for _ in range(sets)]
        cdst = [torch.empty_like(c) for c in csrc]
        for r in range(3):
            cdst[r % sets].copy_(csrc[r % sets])
        copy_ms = _device_ms(
            lambda r: cdst[r % sets].copy_(csrc[r % sets]), 30)
        del csrc, cdst
        bms, by = bound_ms(m, k, n)
        rows.append({"shape": label, "m": m, "k": k, "n": n,
                     "gf_apply_ms": gf_ms, "gf_apply_plain_ms": gf_plain,
                     "mxu_apply_ms": mxu_ms, "mxu_apply_plain_ms": mxu_plain,
                     "int_mm_product_only_ms": int_mm,
                     "copy_floor_ms": copy_ms,
                     "bound_ms": bms, "bound_by": by,
                     "gf_apply_input_GBps": k * n / gf_ms / 1e6,
                     "mxu_apply_input_GBps": k * n / mxu_ms / 1e6})
        del ins, outs, planes
    emit("timing", shapes=rows, launches={
        "gf_apply": rs_cuda.launches - before[0],
        "mxu_apply": rs_mxu.launches - before[1]})
    return rows


def phase_timing_batch(seed: int) -> list[dict]:
    """K1's batch entry at the shapes of the batch path, each beside the
    same jobs as single gf_apply launches (one after another on the
    stream), the plain version (job by job, summed), copy_floor_ms (one
    device copy of the batch's bytes) and the bound: 64 encode jobs of 10x1 MiB -> 4 with the
    shared parity matrix, and 8 rebuild jobs of 10x16 MiB -> 4 with 8
    different rebuild matrices. Two input sets (>= 1.3 GB) rotate, well
    past the 50 MB L2."""
    import numpy as np
    import torch
    from seaweedfs_tpu_torch.models.coder import make_coder
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.rs_torch import gf_apply_reference
    from seaweedfs_tpu_torch.storage.erasure_coding.encoder import \
        plan_rebuild_sources
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    coder = make_coder()
    rng = np.random.default_rng(seed + 6)
    rebuild = []
    while len(rebuild) < 8:
        lost = sorted(int(x) for x in rng.choice(14, 4, replace=False))
        mat = plan_rebuild_sources(
            coder, [i for i in range(14) if i not in lost], lost)[1]
        if not any(np.array_equal(mat, r) for r in rebuild):
            rebuild.append(mat)
    shapes = [("batch encode 64x10x1MiB->4 (shared matrix)", coder.parity,
               64, 1 << 20),
              ("batch rebuild 8x10x16MiB->4 (a matrix per job)", rebuild,
               8, 16 << 20)]
    rows = []
    before = (rs_cuda.launches, rs_cuda.batch_launches)
    for label, mats, B, n in shapes:
        mat, per_job = rs_cuda.batch_matrices(mats, B)
        m, k = mat.shape[-2:]
        ins = [torch.randint(0, 256, (B, k, n), dtype=torch.uint8,
                             device=dev, generator=gen) for _ in range(2)]
        outs = [torch.empty((B, m, n), dtype=torch.uint8, device=dev)
                for _ in range(2)]

        def singles(r):
            for b in range(B):
                rs_cuda.gf_apply(mat[b] if per_job else mat, ins[r % 2][b],
                                 outs[r % 2][b])

        for r in range(3):
            rs_cuda.gf_apply_batch(mats, ins[r % 2], outs[r % 2])
            singles(r)
            gf_apply_reference(mat[0] if per_job else mat, ins[r % 2][0])
        batch_ms = _device_ms(lambda r: rs_cuda.gf_apply_batch(
            mats, ins[r % 2], outs[r % 2]), 30)
        singles_ms = _device_ms(singles, 15)
        # the plain version job by job, summed: a whole batch of its
        # small kernels overflows the launch queue, so it cannot be
        # enqueued ahead of the card in one piece
        plain_ms = sum(_device_ms(lambda r, b=b: gf_apply_reference(
            mat[b] if per_job else mat, ins[r % 2][b]), 3) for b in range(B))
        half = B * (k + m) * n // 2
        del outs
        csrc = [torch.randint(0, 256, (half,), dtype=torch.uint8, device=dev,
                              generator=gen) for _ in range(2)]
        cdst = [torch.empty_like(c) for c in csrc]
        for r in range(3):
            cdst[r % 2].copy_(csrc[r % 2])
        copy_ms = _device_ms(lambda r: cdst[r % 2].copy_(csrc[r % 2]), 30)
        del csrc, cdst, ins
        bms, by = bound_ms(m, k, B * n)
        rows.append({"shape": label, "B": B, "m": m, "k": k, "n": n,
                     "gf_apply_batch_ms": batch_ms,
                     "gf_apply_batch_plain_ms": plain_ms,
                     "single_launches": B, "singles_ms": singles_ms,
                     "copy_floor_ms": copy_ms, "bound_ms": bms,
                     "bound_by": by,
                     "input_GBps": B * k * n / batch_ms / 1e6})
    emit("timing_batch", shapes=rows, launches={
        "gf_apply": rs_cuda.launches - before[0],
        "gf_apply_batch": rs_cuda.batch_launches - before[1]})
    return rows


def make_volume(work: str, volume_mb: int, seed: int, vid: int = 1):
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
    vol = Volume(work, "", vid)
    payloads = {}
    off = 0
    mv = memoryview(blob)
    for nid, cookie, size in zip(ids, cookies, sizes):
        # bytes, not a memoryview slice: a read-back check against a
        # memoryview compares element by element, several ms a needle
        data = bytes(mv[off:off + size])
        off += size
        vol.write_needle(Needle(id=nid, cookie=cookie, data=data))
        payloads[nid] = (cookie, data)
    vol.sync()
    version = vol.version
    vol.close()
    return vol.file_name(), payloads, version


class PathCounts:
    """The kernel entries' launches on the paths, phase by phase: each
    phase is driven with every counter set to 0 just before it (start) and
    read just after (read)."""

    KERNELS = ("gf_apply", "mxu_apply", "gf_apply_batch")

    def __init__(self):
        self.by_phase: dict[str, dict[str, int]] = {}

    @staticmethod
    def start() -> None:
        from seaweedfs_tpu_torch.ops import rs_cuda, rs_mxu
        rs_cuda.launches = 0
        rs_cuda.batch_launches = 0
        rs_mxu.launches = 0

    @staticmethod
    def now() -> dict[str, int]:
        from seaweedfs_tpu_torch.ops import rs_cuda, rs_mxu
        return {"gf_apply": rs_cuda.launches, "mxu_apply": rs_mxu.launches,
                "gf_apply_batch": rs_cuda.batch_launches}

    def read(self, phase: str, kernel: str, batches: int) -> dict:
        """Record the phase's counts (a phase driven in several steps adds
        them up); the step must have launched `kernel` once per batch and
        the other entries never."""
        return self.add(phase, kernel, batches, self.now())

    def add(self, phase: str, kernel: str, batches: int,
            got: dict[str, int]) -> dict:
        """`read` of counts `got` that were taken elsewhere (the cli
        phase's server processes)."""
        prev = self.by_phase.get(phase, dict.fromkeys(self.KERNELS, 0))
        self.by_phase[phase] = {k: prev[k] + got[k] for k in self.KERNELS}
        others = [k for k in self.KERNELS if k != kernel]
        if got[kernel] != batches or batches == 0 or \
                any(got[o] for o in others):
            raise AssertionError(
                f"{phase}: launches {got} for {batches} batches; expected "
                f"{kernel} once per batch and {others} never")
        return got

    def of(self, kernel: str) -> dict[str, int]:
        return {p: c[kernel] for p, c in self.by_phase.items()}

    def total(self, kernel: str) -> int:
        return sum(self.of(kernel).values())


def _stages(stats: dict) -> dict:
    return {k: stats[k] for k in ("read_s", "encode_s", "write_s",
                                  "device_wait_s") if k in stats}


def check_parity(base: str, dat_size: int, scheme) -> int:
    """Every parity batch of the shards on disk against the plain version
    of K1 on the card; returns the batches checked."""
    import numpy as np
    import torch
    from seaweedfs_tpu_torch.ops import gf256
    from seaweedfs_tpu_torch.ops.rs_torch import gf_apply_reference
    from seaweedfs_tpu_torch.parallel import streaming
    from seaweedfs_tpu_torch.storage.erasure_coding import layout
    k, total = scheme.data_shards, scheme.total_shards
    parity = gf256.parity_matrix(k, scheme.parity_shards)
    files = [open(base + layout.shard_ext(i), "rb") for i in range(total)]
    checked = 0
    try:
        shard_off = 0
        for _, _, _, step in layout.iter_encode_batches(
                dat_size, layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE,
                streaming.DEFAULT_PIPE_BATCH, k):
            rows = np.empty((total, step), dtype=np.uint8)
            for i, f in enumerate(files):
                f.seek(shard_off)
                if f.readinto(memoryview(rows[i])) != step:
                    raise AssertionError(f"short shard {i} at {shard_off}")
            dev_rows = torch.from_numpy(rows).cuda()
            if not torch.equal(gf_apply_reference(parity, dev_rows[:k]),
                               dev_rows[k:]):
                raise AssertionError(f"parity batch at {shard_off} differs "
                                     "from the plain version")
            shard_off += step
            checked += 1
    finally:
        for f in files:
            f.close()
    return checked


def read_back(work: str, vid: int, payloads: dict, total: int) -> None:
    """Every needle through EcVolume's shards, CRC checked."""
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_volume
    from seaweedfs_tpu_torch.storage.needle import Needle
    ev = ec_volume.EcVolume(work, "", vid)
    try:
        if ev.total_shards != total:
            raise AssertionError(f".vif names {ev.scheme}, not {total} shards")
        for sid in range(total):
            ev.add_shard(ec_volume.EcVolumeShard(work, "", vid, sid))
        for nid, (cookie, data) in payloads.items():
            intervals, _, nsize = ev.locate_needle(nid)
            blob = b"".join(ev.read_interval(iv)[0] for iv in intervals)
            n = Needle.from_bytes(blob, nsize, ev.version)  # CRC checked
            if n.id != nid or n.cookie != cookie or n.data != data:
                raise AssertionError(f"needle {nid:x} read back wrong")
    finally:
        ev.close()


def main_path(work: str, volume_mb: int, seed: int,
              counts: PathCounts) -> tuple[str, dict]:
    from seaweedfs_tpu_torch.models.coder import DEFAULT_SCHEME, make_coder
    from seaweedfs_tpu_torch.parallel import streaming
    from seaweedfs_tpu_torch.storage.erasure_coding import (decoder,
                                                            ec_volume,
                                                            encoder, layout)
    total = DEFAULT_SCHEME.total_shards

    # 6. volume + .ecx + .vif
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

    # 7. pipelined encode on K1
    stats: dict = {}
    counts.start()
    t0 = time.monotonic()
    streaming.pipelined_encode_file(base, stats=stats)
    wall = time.monotonic() - t0
    got = counts.read("encode", "gf_apply", stats["batches"])
    checked = check_parity(base, dat_size, DEFAULT_SCHEME)
    if checked != stats["batches"]:
        raise AssertionError(f"checked {checked} of {stats['batches']} batches")
    emit("encode", launches=got, batches=stats["batches"],
         parity_batches_checked=checked, MBps=dat_size / wall / 1e6,
         wall_s=wall, stages=_stages(stats))
    shard_sha = {i: sha256_file(base + layout.shard_ext(i))
                 for i in range(total)}

    # 8. the same .dat (a hard link) through the mxu coder: parity on K2
    base2 = os.path.join(work, "2")
    os.link(base + ".dat", base2 + ".dat")
    stats = {}
    coder = make_coder("mxu")
    counts.start()
    t0 = time.monotonic()
    streaming.pipelined_encode_file(base2, coder=coder, stats=stats)
    wall = time.monotonic() - t0
    got = counts.read("mxu_encode", "mxu_apply", stats["batches"])
    for i in range(total):
        if sha256_file(base2 + layout.shard_ext(i)) != shard_sha[i]:
            raise AssertionError(f"mxu encode's shard {i} differs from K1's")
    for i in range(total):
        os.remove(base2 + layout.shard_ext(i))
    os.remove(base2 + ".dat")
    emit("mxu_encode", coder=type(coder).__name__, launches=got,
         batches=stats["batches"], shards_sha256_equal_to_encode=total,
         MBps=dat_size / wall / 1e6, wall_s=wall, stages=_stages(stats))

    # 9. lose 4 shards, pipelined rebuild on K1
    for i in LOSS:
        os.remove(base + layout.shard_ext(i))
    # the degraded shard set, for the degraded-read phases: hard links of
    # the survivors (nothing rewrites them), copies of .ecx (EC deletes
    # tombstone it in place) and .vif
    deg = os.path.join(work, "degraded")
    os.makedirs(deg)
    for i in range(total):
        if i not in LOSS:
            os.link(base + layout.shard_ext(i),
                    os.path.join(deg, "1" + layout.shard_ext(i)))
    for ext in (".ecx", ".vif"):
        shutil.copy(base + ext, os.path.join(deg, "1" + ext))
    stats = {}
    counts.start()
    t0 = time.monotonic()
    rebuilt = streaming.pipelined_rebuild_files(base, stats=stats)
    wall = time.monotonic() - t0
    got = counts.read("rebuild", "gf_apply", stats["batches"])
    if sorted(rebuilt) != list(LOSS):
        raise AssertionError(f"rebuilt {rebuilt}, lost {LOSS}")
    for i in LOSS:
        if sha256_file(base + layout.shard_ext(i)) != shard_sha[i]:
            raise AssertionError(f"rebuilt shard {i} differs")
    emit("rebuild", lost=list(LOSS), sources=stats["sources"],
         launches=got, batches=stats["batches"], sha256_equal=True,
         MBps=stats["rebuilt_bytes"] / wall / 1e6,
         read_MBps=stats["bytes_in"] / wall / 1e6, wall_s=wall,
         stages=_stages(stats))

    # 10. decode to .dat and read every needle back through the shards
    t0 = time.monotonic()
    os.remove(base + ".dat")
    size = decoder.find_dat_file_size(base, base)
    decoder.write_dat_file(base, size)
    if size != dat_size or sha256_file(base + ".dat") != dat_sha:
        raise AssertionError("decoded .dat differs from the original")
    decode_s = time.monotonic() - t0
    t0 = time.monotonic()
    read_back(work, 1, payloads, total)
    emit("decode", dat_sha256_equal=True, decode_s=decode_s,
         needles_read_back=len(payloads), crc_checked=True,
         read_back_s=time.monotonic() - t0)
    return deg, payloads


def alt_scheme(work: str, k: int, m: int, volume_mb: int, seed: int,
               counts: PathCounts) -> None:
    """11. One alternate scheme's cycle: volume, .ecx, .vif, encode on K2,
    lose m shards, rebuild on K1, decode, read back."""
    from seaweedfs_tpu_torch.models.coder import RSScheme, make_coder
    from seaweedfs_tpu_torch.parallel import streaming
    from seaweedfs_tpu_torch.storage.erasure_coding import (decoder,
                                                            ec_volume,
                                                            encoder, layout)
    scheme = RSScheme(k, m)
    tag = f"rs{k}_{m}"
    d = os.path.join(work, tag)
    os.makedirs(d)
    seconds = {}
    t0 = time.monotonic()
    base, payloads, version = make_volume(d, volume_mb, seed + k)
    dat_size = os.path.getsize(base + ".dat")
    dat_sha = sha256_file(base + ".dat")
    encoder.write_sorted_ecx(base)
    ec_volume.write_volume_info(base, version, scheme)
    seconds["volume"] = time.monotonic() - t0

    enc_stats: dict = {}
    counts.start()
    t0 = time.monotonic()
    streaming.pipelined_encode_file(
        base, coder=make_coder("mxu", scheme), stats=enc_stats)
    seconds["encode"] = time.monotonic() - t0
    enc = counts.read(f"{tag}_encode", "mxu_apply", enc_stats["batches"])
    checked = check_parity(base, dat_size, scheme)
    if checked != enc_stats["batches"]:
        raise AssertionError(f"checked {checked} of {enc_stats['batches']}")

    lost = alt_loss(scheme, seed)
    lost_sha = {i: sha256_file(base + layout.shard_ext(i)) for i in lost}
    for i in lost:
        os.remove(base + layout.shard_ext(i))
    reb_stats: dict = {}
    counts.start()
    t0 = time.monotonic()
    rebuilt = streaming.pipelined_rebuild_files(
        base, coder=make_coder("torch", scheme), stats=reb_stats)
    seconds["rebuild"] = time.monotonic() - t0
    reb = counts.read(f"{tag}_rebuild", "gf_apply", reb_stats["batches"])
    if sorted(rebuilt) != lost:
        raise AssertionError(f"{scheme}: rebuilt {rebuilt}, lost {lost}")
    for i in lost:
        if sha256_file(base + layout.shard_ext(i)) != lost_sha[i]:
            raise AssertionError(f"{scheme}: rebuilt shard {i} differs")

    t0 = time.monotonic()
    os.remove(base + ".dat")
    size = decoder.find_dat_file_size(base, base)
    decoder.write_dat_file(base, size)
    if size != dat_size or sha256_file(base + ".dat") != dat_sha:
        raise AssertionError(f"{scheme}: decoded .dat differs")
    seconds["decode"] = time.monotonic() - t0
    t0 = time.monotonic()
    read_back(d, 1, payloads, scheme.total_shards)
    seconds["read_back"] = time.monotonic() - t0
    shutil.rmtree(d)
    emit("alt_scheme", scheme=repr(scheme), needles=len(payloads),
         dat_bytes=dat_size, lost=lost, sources=reb_stats["sources"],
         launches={"encode": enc, "rebuild": reb},
         batches={"encode": enc_stats["batches"],
                  "rebuild": reb_stats["batches"]},
         parity_batches_checked=checked, rebuilt_sha256_equal=True,
         dat_sha256_equal=True, needles_read_back=len(payloads),
         crc_checked=True, seconds=seconds,
         encode_MBps=dat_size / seconds["encode"] / 1e6,
         encode_stages=_stages(enc_stats), rebuild_stages=_stages(reb_stats),
         reduced="BASELINE config 5 (RS(6,3) and RS(12,6) at 64KB/256KB/1MB "
                 "blocks) cut to the layout's 1 MiB small block and a "
                 f"{volume_mb} MiB volume for the smoke's time limit")


def _run_threads(calls) -> None:
    """Run each (fn, args, kwargs) in its own thread, all at once; re-raise
    the first failure after every thread has ended."""
    errors = []

    def run(fn, args, kwargs):
        try:
            fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=c) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def cpu_shard_sha(base: str, dat_size: int, cpu) -> list[str]:
    """sha256 of every shard as CpuCoderMT's encode_array of the .dat's
    rows gives them: the independent host check of a volume's shards."""
    import numpy as np
    from seaweedfs_tpu_torch.parallel import streaming
    from seaweedfs_tpu_torch.storage.erasure_coding import layout
    k, m = cpu.scheme.data_shards, cpu.scheme.parity_shards
    digests = [hashlib.sha256() for _ in range(k + m)]
    with open(base + ".dat", "rb") as f:
        for row_off, block, b, step in layout.iter_encode_batches(
                dat_size, layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE,
                streaming.DEFAULT_PIPE_BATCH, k):
            rows = np.zeros((k, step), dtype=np.uint8)  # zero past EOF
            for i in range(k):
                f.seek(row_off + i * block + b)
                f.readinto(memoryview(rows[i]))
            for h, row in zip(digests, [*rows, *cpu.encode_array(rows)]):
                h.update(row)
    return [h.hexdigest() for h in digests]


def _hist(snap: dict) -> dict:
    """A histogram snapshot, compactly: bucket bounds and per-bucket
    counts (the last bucket is +Inf) by label."""
    return {"buckets": snap["buckets"],
            "counts": {"/".join(lbl) or "-": c
                       for lbl, c, _, _ in snap["series"]}}


def batch_volumes(work: str, n_vol: int, volume_mb: int, seed: int,
                  counts: PathCounts) -> dict:
    """13. BASELINE config 4 through the batch scheduler: concurrent
    encodes of n_vol volumes, the check against CpuCoderMT, the same
    volumes on TorchCoder one after another, concurrent rebuilds of 8 of
    them, decode and read-back."""
    import numpy as np
    from seaweedfs_tpu_torch.models.coder import DEFAULT_SCHEME, make_coder
    from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoderMT
    from seaweedfs_tpu_torch.ops.rs_mesh import MeshCoder
    from seaweedfs_tpu_torch.parallel import streaming
    from seaweedfs_tpu_torch.parallel.batcher import (BatchCoder,
                                                      EcBatchScheduler)
    from seaweedfs_tpu_torch.storage.erasure_coding import (decoder,
                                                            ec_volume,
                                                            encoder, layout)
    total = DEFAULT_SCHEME.total_shards
    root = os.path.join(work, "batch")
    seconds = {}
    t0 = time.monotonic()
    vols = []
    for v in range(n_vol):
        d = os.path.join(root, f"v{v}")
        os.makedirs(d)
        base, payloads, version = make_volume(d, volume_mb,
                                              seed * 1000 + 100 + v)
        encoder.write_sorted_ecx(base)
        ec_volume.write_volume_info(base, version, DEFAULT_SCHEME)
        # the needles of the volumes that are rebuilt are read back
        vols.append((d, base, payloads if v < len(BATCH_LOSSES) else None,
                     os.path.getsize(base + ".dat")))
    seconds["volumes"] = time.monotonic() - t0
    dat_bytes = sum(v[3] for v in vols)
    dat_sha = [sha256_file(base + ".dat")
               for _, base, _, _ in vols[:len(BATCH_LOSSES)]]

    mesh_coder = MeshCoder(n_devices=1)  # one launch per mesh batch
    mixed = []  # distinct matrices in each rebuild launch
    dispatch_s = [0.0]  # the dispatcher's time inside MeshCoder calls
    encode_batch, rebuild_batch = mesh_coder.encode_batch, \
        mesh_coder.rebuild_batch

    def timed_encode(jobs):
        t0 = time.monotonic()
        try:
            return encode_batch(jobs)
        finally:
            dispatch_s[0] += time.monotonic() - t0

    def timed_rebuild(src, mats):
        mixed.append(len({(m.shape, m.tobytes()) for m in map(np.asarray,
                                                               mats)}))
        t0 = time.monotonic()
        try:
            return rebuild_batch(src, mats)
        finally:
            dispatch_s[0] += time.monotonic() - t0

    mesh_coder.encode_batch = timed_encode
    mesh_coder.rebuild_batch = timed_rebuild
    sched = EcBatchScheduler(mesh_coder=mesh_coder, window_s=0.005,
                             max_batch=64)
    bc = BatchCoder(sched)
    try:
        enc_stats = [{} for _ in vols]
        counts.start()
        t0 = time.monotonic()
        _run_threads([(streaming.pipelined_encode_file, (base,),
                       {"coder": bc, "stats": st})
                      for (_, base, _, _), st in zip(vols, enc_stats)])
        enc_wall = time.monotonic() - t0
        enc_dispatch_s = dispatch_s[0]
        enc = sched.stats()
        enc_launches = counts.read("batch_volumes_encode", "gf_apply_batch",
                                   enc["mesh_batches"])
        jobs = sum(st["batches"] for st in enc_stats)
        if enc["cpu_batches"] or enc["coder_fallbacks"] or \
                enc["jobs_total"] != jobs:
            raise AssertionError(f"batch encode: {jobs} jobs, stats {enc}")

        t0 = time.monotonic()
        cpu = CpuCoderMT()
        shard_sha = []
        for d, base, _, size in vols:
            have = [sha256_file(base + layout.shard_ext(i))
                    for i in range(total)]
            if have != cpu_shard_sha(base, size, cpu):
                raise AssertionError(f"{d}: shards differ from CpuCoderMT's")
            shard_sha.append(have)
        seconds["check_against_cpu"] = time.monotonic() - t0

        # the same volumes one after another on TorchCoder (information)
        torch_coder = make_coder()
        seq_s = 0.0
        for (d, base, _, _), sha in zip(vols, shard_sha):
            base2 = os.path.join(d, "2")
            os.link(base + ".dat", base2 + ".dat")
            t0 = time.monotonic()
            streaming.pipelined_encode_file(base2, coder=torch_coder)
            seq_s += time.monotonic() - t0
            for i in range(total):
                if sha256_file(base2 + layout.shard_ext(i)) != sha[i]:
                    raise AssertionError(f"{d}: TorchCoder's shard {i} "
                                         "differs")
                os.remove(base2 + layout.shard_ext(i))
            os.remove(base2 + ".dat")

        # 8 volumes lose 1-4 shards each, rebuilt concurrently
        chosen = vols[:len(BATCH_LOSSES)]
        for (_, base, _, _), lost in zip(chosen, BATCH_LOSSES):
            for i in lost:
                os.remove(base + layout.shard_ext(i))
        mesh_before = sched.mesh_batches
        mixed.clear()
        dispatch_s[0] = 0.0
        reb_stats = [{} for _ in chosen]
        rebuilt = [None] * len(chosen)

        def rebuild(j, base):
            rebuilt[j] = streaming.pipelined_rebuild_files(
                base, coder=bc, batch_size=layout.SMALL_BLOCK_SIZE,
                stats=reb_stats[j])

        counts.start()
        t0 = time.monotonic()
        _run_threads([(rebuild, (j, base), {})
                      for j, (_, base, _, _) in enumerate(chosen)])
        reb_wall = time.monotonic() - t0
        reb = sched.stats()
        reb_launches = counts.read("batch_volumes_rebuild", "gf_apply_batch",
                                   reb["mesh_batches"] - mesh_before)
        if reb["cpu_batches"] or reb["coder_fallbacks"]:
            raise AssertionError(f"batch rebuild: stats {reb}")
        if max(mixed) < 2:
            raise AssertionError(f"no rebuild launch carried two different "
                                 f"matrices: {mixed}")
        for (d, base, _, _), lost, got, sha in zip(chosen, BATCH_LOSSES,
                                                   rebuilt, shard_sha):
            if sorted(got) != list(lost):
                raise AssertionError(f"{d}: rebuilt {got}, lost {lost}")
            for i in lost:
                if sha256_file(base + layout.shard_ext(i)) != sha[i]:
                    raise AssertionError(f"{d}: rebuilt shard {i} differs")

        t0 = time.monotonic()
        needles = 0
        for (d, base, payloads, size), sha in zip(chosen, dat_sha):
            os.remove(base + ".dat")
            if decoder.find_dat_file_size(base, base) != size:
                raise AssertionError(f"{d}: decoded size differs")
            decoder.write_dat_file(base, size)
            if sha256_file(base + ".dat") != sha:
                raise AssertionError(f"{d}: decoded .dat differs")
            read_back(d, 1, payloads, total)
            needles += len(payloads)
        seconds["decode_and_read_back"] = time.monotonic() - t0
    finally:
        sched.stop()
        shutil.rmtree(root, ignore_errors=True)
    rebuilt_bytes = sum(st["rebuilt_bytes"] for st in reb_stats)

    def stage_sums(stats):  # busy seconds summed over the pipelines
        return {k: sum(st.get(k, 0.0) for st in stats)
                for k in ("read_s", "encode_s", "write_s")}

    result = {
        "volumes": n_vol, "volume_mb": volume_mb, "dat_bytes": dat_bytes,
        "encode": {
            "wall_s": enc_wall, "MBps": dat_bytes / enc_wall / 1e6,
            "launches": enc_launches, "jobs": enc["jobs_total"],
            "batches": enc["batches_total"],
            "mesh_batches": enc["mesh_batches"],
            "cpu_batches": enc["cpu_batches"],
            "coder_fallbacks": enc["coder_fallbacks"],
            "max_coalesced": enc["max_coalesced"],
            "size_hist": _hist(enc["size_hist"]),
            "wait_hist": _hist(enc["wait_hist"]),
            "dispatch_s": enc_dispatch_s,
            "stages_summed": stage_sums(enc_stats),
            "shards_sha256_equal_to_cpu_mt": n_vol * total},
        "torch_coder_one_after_another": {
            "wall_s": seq_s, "MBps": dat_bytes / seq_s / 1e6,
            "shards_sha256_equal": True},
        "rebuild": {
            "lost": [list(x) for x in BATCH_LOSSES], "wall_s": reb_wall,
            "MBps": rebuilt_bytes / reb_wall / 1e6,
            "launches": reb_launches,
            "jobs": reb["jobs_total"] - enc["jobs_total"],
            "mesh_batches": reb["mesh_batches"] - mesh_before,
            "cpu_batches": reb["cpu_batches"],
            "coder_fallbacks": reb["coder_fallbacks"],
            "distinct_matrices_per_launch": mixed,
            "dispatch_s": dispatch_s[0],
            "stages_summed": stage_sums(reb_stats),
            "rebuilt_sha256_equal": True},
        "decoded_dat_sha256_equal": len(chosen),
        "needles_read_back": needles, "crc_checked": True,
        "seconds": seconds,
        "reduced": "BASELINE config 4 (64 volumes of 30 GB) cut to "
                   f"{n_vol} volumes of {volume_mb} MiB for the smoke's "
                   "time limit"}
    emit("batch_volumes", **result)
    return result


def batch_encode_phase(seed: int, counts: PathCounts,
                       kernel_ms: float) -> None:
    """14. streaming.batch_encode_volumes at BATCH_ENCODE_SHAPE without a mesh,
    on batch_mesh() and on a one-card ('data', 'shard', 'seq') mesh,
    against CpuCoderMT; distributed_rebuild on that mesh for three loss
    patterns. The host-copy share of an encode_batch is 1 - the batch
    kernel's device time over the call's wall time (warm)."""
    import numpy as np
    import torch
    from seaweedfs_tpu_torch.models.coder import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoderMT
    from seaweedfs_tpu_torch.parallel import distributed
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
    from seaweedfs_tpu_torch.parallel import streaming
    rng = np.random.default_rng(seed + 9)
    vols = rng.integers(0, 256, BATCH_ENCODE_SHAPE, dtype=np.uint8)
    cpu = CpuCoderMT()
    want = np.stack([cpu.encode_array(v) for v in vols])
    meshes = [("no mesh", None), ("batch_mesh()", mesh_mod.batch_mesh()),
              ("make_mesh(1)", mesh_mod.make_mesh(1))]
    # one launch per device that has volumes
    expected = sum(min(len(vols), 1 if m is None else m.devices.size)
                   for _, m in meshes)
    wall_ms = {}
    counts.start()
    for name, mesh in meshes:
        t0 = time.monotonic()
        got = streaming.batch_encode_volumes(vols, mesh=mesh)
        wall_ms[name] = (time.monotonic() - t0) * 1e3
        if not np.array_equal(got, want):
            raise AssertionError(f"batch_encode_volumes ({name}) differs "
                                 "from CpuCoderMT")
    enc = counts.read("batch_encode_volumes", "gf_apply_batch", expected)
    # staging alone: the batch copied into a pinned buffer (warm)
    pinned = torch.empty(vols.shape, dtype=torch.uint8, pin_memory=True)
    np.copyto(pinned.numpy(), vols)
    t0 = time.monotonic()
    np.copyto(pinned.numpy(), vols)
    stage_ms = (time.monotonic() - t0) * 1e3
    del pinned

    data = vols[0]
    full = np.concatenate([data, want[0]])
    one_card = meshes[2][1]
    drops = ((0, 3, 7, 9), (10, 11, 12, 13), (0, 5, 11, 13))
    counts.start()
    for drop in drops:
        out = distributed.distributed_rebuild(
            DEFAULT_SCHEME, one_card,
            {i: full[i] for i in range(14) if i not in drop}, drop)
        if not np.array_equal(out, full[list(drop)]):
            raise AssertionError(f"distributed_rebuild of {drop} differs")
    reb = counts.read("distributed_rebuild", "gf_apply", len(drops))
    warm = wall_ms["batch_mesh()"]
    emit("batch_encode_volumes", shape=list(BATCH_ENCODE_SHAPE),
         meshes=[name for name, _ in meshes], parity_equal_to_cpu_mt=True,
         launches=enc, wall_ms=wall_ms, kernel_ms=kernel_ms,
         stage_into_pinned_ms=stage_ms,
         host_copy_share_of_encode_batch=1 - kernel_ms / warm,
         distributed_rebuild={"drops": [list(d) for d in drops],
                              "n": 1 << 20, "equal": True,
                              "launches": reb})


def _ms_stats(seconds: list[float]) -> dict:
    ms = sorted(x * 1e3 for x in seconds)
    if not ms:
        return {"n": 0}
    return {"n": len(ms), "median_ms": statistics.median(ms),
            "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
            "max_ms": ms[-1]}


def _lost_intervals(ev, payloads: dict, lost) -> int:
    """Intervals of the volume's needles that lie in a lost shard: the
    reconstructions a read of every needle must make."""
    from seaweedfs_tpu_torch.storage.erasure_coding import layout
    n = 0
    for nid in payloads:
        for iv in ev.locate_needle(nid)[0]:
            sid = iv.to_shard_id_and_offset(layout.LARGE_BLOCK_SIZE,
                                            layout.SMALL_BLOCK_SIZE,
                                            ev.data_shards)[0]
            n += sid in lost
    return n


def _read_all(store, vid: int, payloads: dict, threads: int = 1) -> float:
    """Read every needle of `vid` through store.read_ec_shard_needle
    (CRC checked) on `threads` threads and check it against its payload;
    returns the wall seconds."""
    nids = sorted(payloads)

    def read(part):
        for nid in part:
            cookie, data = payloads[nid]
            n = store.read_ec_shard_needle(vid, nid, cookie)
            if n.id != nid or n.data != data:
                raise AssertionError(f"needle {nid:x} of volume {vid} "
                                     "read back wrong")

    t0 = time.monotonic()
    if threads == 1:
        read(nids)
    else:
        _run_threads([(read, (nids[i::threads],), {})
                      for i in range(threads)])
    return time.monotonic() - t0


def degraded_reads(deg: str, payloads: dict, seed: int,
                   counts: PathCounts):
    """15. The degraded-read path on the card: a Store over the main
    volume's 10 surviving shards with coder=None (TorchCoder, K1's single
    entry). Every needle read whole, with and without the NeedleCache, and
    64 seeded ranges that cross a lost shard. Returns the store (cache
    wired) for the EC-delete phase."""
    import numpy as np
    from seaweedfs_tpu_torch.ops.rs_torch import TorchCoder
    from seaweedfs_tpu_torch.storage.erasure_coding import layout
    from seaweedfs_tpu_torch.storage.needle_cache import NeedleCache
    from seaweedfs_tpu_torch.storage.store import Store
    store = Store([deg])
    if not isinstance(store.coder, TorchCoder) or \
            store.coder.device.type != "cuda":
        raise AssertionError(f"Store() took {store.coder}, not the card")
    store.mount_ec_shards("", 1, [i for i in range(14) if i not in LOSS])
    ev = store.find_ec_volume(1)
    expect = _lost_intervals(ev, payloads, LOSS)
    payload_bytes = sum(len(d) for _, d in payloads.values())
    took: list[float] = []
    real = store.coder.reconstruct

    def timed(shards):
        t0 = time.perf_counter()
        try:
            return real(shards)
        finally:
            took.append(time.perf_counter() - t0)

    store.coder.reconstruct = timed
    passes = {}

    def one_pass(name: str, launches: bool, **kw):
        before = store.ec_recover_stats["generic"]
        counts.start()
        wall = _read_all(store, 1, payloads, **kw)
        recovered = store.ec_recover_stats["generic"] - before
        if launches:
            got = counts.read("degraded_reads", "gf_apply", recovered)
        else:
            got = counts.now()
            if any(got.values()) or recovered:
                raise AssertionError(f"{name}: launches {got}, "
                                     f"{recovered} recoveries")
        passes[name] = {"wall_s": wall, "MBps": payload_bytes / wall / 1e6,
                        "recovered_intervals": recovered, "launches": got}
        return recovered

    # the plain pass: one K1 launch per interval of a lost shard
    if one_pass("no_cache", True) != expect:
        raise AssertionError(f"recovered {passes['no_cache']} intervals, "
                             f"{expect} lie in lost shards")
    per_interval = _ms_stats(took)
    sizes = []  # interval sizes (the kernel's n) of the plain pass
    for nid in payloads:
        for iv in ev.locate_needle(nid)[0]:
            if iv.to_shard_id_and_offset()[0] in LOSS:
                sizes.append(iv.size)
    # with the cache: a cold pass decodes each interval once, a warm one
    # serves every record from memory (no launch)
    store.needle_cache = NeedleCache(capacity_bytes=4 << 30)
    if one_pass("cache_cold", True) != expect:
        raise AssertionError("the cold cache pass recovered "
                             f"{passes['cache_cold']}, not {expect}")
    one_pass("cache_warm", False)
    cache_stats = store.needle_cache.stats()
    if cache_stats["hits"] < len(payloads):
        raise AssertionError(f"warm pass: cache {cache_stats}")

    # ranges that cross a lost shard, read without the cache (only the
    # covering intervals are reconstructed)
    cache, store.needle_cache = store.needle_cache, None
    rng = np.random.default_rng(seed + 15)
    crossing = []
    for nid in sorted(payloads):
        for iv in ev.locate_needle(nid)[0]:
            if iv.to_shard_id_and_offset()[0] in LOSS:
                crossing.append(nid)
                break
    picks = [crossing[int(i)] for i in rng.integers(0, len(crossing), 64)]
    before = store.ec_recover_stats["generic"]
    counts.start()
    t0 = time.monotonic()
    range_bytes = 0
    for nid in picks:
        cookie, data = payloads[nid]
        meta, size = store.ec_needle_meta(1, nid, cookie)
        if size != len(data) or meta.cookie != cookie:
            raise AssertionError(f"needle {nid:x}: meta {size} bytes")
        lo = int(rng.integers(0, size))
        ln = int(rng.integers(1, size - lo + 1))
        got = store.read_ec_needle_data_range(1, nid, lo, ln)
        if bytes(got) != bytes(data[lo:lo + ln]):
            raise AssertionError(f"needle {nid:x}: range {lo}+{ln} wrong")
        range_bytes += ln
    wall = time.monotonic() - t0
    recovered = store.ec_recover_stats["generic"] - before
    if recovered == 0:
        raise AssertionError("no range read crossed a lost shard")
    got = counts.read("degraded_reads", "gf_apply", recovered)
    passes["ranges"] = {"wall_s": wall, "ranges": len(picks),
                        "range_bytes": range_bytes,
                        "recovered_intervals": recovered, "launches": got}
    store.needle_cache = cache
    store.coder.reconstruct = real
    emit("degraded_reads", volume="main (RS(10,4))", lost=list(LOSS),
         needles=len(payloads), payload_bytes=payload_bytes,
         coder=type(store.coder).__name__, passes=passes,
         recovered_intervals=expect,
         launches=counts.by_phase["degraded_reads"],
         reconstruct_per_interval=per_interval,
         interval_bytes={"median": statistics.median(sizes),
                         "min": min(sizes), "max": max(sizes)},
         cache=cache_stats, bytes_equal=True, crc_checked=True)
    return store


def degraded_reads_batched(deg: str, payloads: dict, counts: PathCounts,
                           threads: int = 32) -> None:
    """16. The same degraded volume read by `threads` readers at once
    through a Store whose coder is a BatchCoder over one EcBatchScheduler
    (the volume server's -ecBatcher set-up): K1's batch entry, one launch
    per mesh batch."""
    from seaweedfs_tpu_torch.ops.rs_mesh import MeshCoder
    from seaweedfs_tpu_torch.parallel.batcher import (BatchCoder,
                                                      EcBatchScheduler)
    from seaweedfs_tpu_torch.storage.store import Store
    sched = EcBatchScheduler(mesh_coder=MeshCoder(n_devices=1),
                             window_s=0.005, max_batch=64)
    try:
        store = Store([deg], coder=BatchCoder(sched))
        store.mount_ec_shards("", 1, [i for i in range(14) if i not in LOSS])
        expect = _lost_intervals(store.find_ec_volume(1), payloads, LOSS)
        counts.start()
        wall = _read_all(store, 1, payloads, threads=threads)
        st = sched.stats()
        got = counts.read("degraded_reads_batched", "gf_apply_batch",
                          st["mesh_batches"])
        store.close()
    finally:
        sched.stop()
    if st["coder_fallbacks"] or st["cpu_batches"] or \
            st["jobs_total"] != expect or \
            store.ec_recover_stats["generic"] != expect:
        raise AssertionError(f"batched degraded reads: {expect} intervals "
                             f"to recover, stats {st}")
    payload_bytes = sum(len(d) for _, d in payloads.values())
    emit("degraded_reads_batched", threads=threads, wall_s=wall,
         MBps=payload_bytes / wall / 1e6, launches=got,
         jobs=st["jobs_total"], mesh_batches=st["mesh_batches"],
         cpu_batches=st["cpu_batches"], fallbacks=st["coder_fallbacks"],
         max_coalesced=st["max_coalesced"],
         size_hist=_hist(st["size_hist"]), wait_hist=_hist(st["wait_hist"]),
         bytes_equal=True, crc_checked=True,
         note="jobs coalesce only at equal interval sizes")


def ec_delete(store, deg: str, payloads: dict, seed: int) -> None:
    """17. EC deletes through the store (its NeedleCache wired and warm):
    16 needles tombstoned in .ecx and journalled in .ecj, reads refused
    through the cache, then rebuild_ecx_file folds the journal in."""
    import numpy as np
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_volume
    from seaweedfs_tpu_torch.storage.erasure_coding.encoder import \
        rebuild_ecx_file
    from seaweedfs_tpu_torch.storage.volume import DeletedError
    rng = np.random.default_rng(seed + 17)
    victims = sorted(int(x) for x in rng.choice(
        sorted(payloads), min(16, len(payloads)), replace=False))
    counts = PathCounts()
    counts.start()
    t0 = time.monotonic()
    freed = 0
    for nid in victims:
        freed += store.delete_ec_shard_needle(1, nid, payloads[nid][0])
    for nid in victims:
        for read in (lambda: store.read_ec_shard_needle(1, nid),
                     lambda: store.read_ec_needle_data_range(1, nid, 0, 1)):
            try:
                read()
            except DeletedError:
                continue
            raise AssertionError(f"deleted needle {nid:x} still reads")
    launches = counts.now()
    base = os.path.join(deg, "1")
    journal = list(ec_volume.iterate_ecj_file(base))
    if sorted(journal) != victims:
        raise AssertionError(f".ecj holds {journal}")
    store.close()
    rebuild_ecx_file(base)
    if os.path.exists(base + ".ecj"):
        raise AssertionError("rebuild_ecx_file left the .ecj")
    size = os.path.getsize(base + ".ecx")
    live = 0
    with open(base + ".ecx", "rb") as ecx:
        for nid in sorted(payloads):
            _, nsize = ec_volume.search_needle_from_sorted_index(
                ecx, size, nid)
            if (nsize == t.TOMBSTONE_FILE_SIZE) != (nid in victims):
                raise AssertionError(f"needle {nid:x}: .ecx size {nsize}")
            live += nsize != t.TOMBSTONE_FILE_SIZE
    emit("ec_delete", deleted=len(victims), freed_bytes=freed,
         reads_refused=2 * len(victims), through_cache=True,
         journal_entries=len(journal), ecx_tombstones=len(victims),
         ecx_live=live, ecj_removed=True, launches=launches,
         seconds=time.monotonic() - t0)


def lrc_volume(work: str, volume_mb: int, seed: int, counts: PathCounts,
               batch_counts: PathCounts) -> None:
    """18. LRC(10,2,2) through the batch path: an LRC volume encoded by
    pipelined_encode_file through BatchCoder(sched, LrcScheme()) while an
    RS(10,4) volume encodes through the same scheduler (launches carrying
    both parity matrices); shards against the host LrcCoderMT and
    CpuCoderMT; shard 7 lost on both and every needle read through a
    Store on the card (the LRC volume plans group-local from 5 sources on
    the host coder, the RS one recovers on K1); one block reconstructed
    by the facade (5 sources: a CPU batch); {2,12} lost and rebuilt by
    rebuild_ec_files on the facade (K1's batch entry)."""
    import numpy as np
    from seaweedfs_tpu_torch.models.coder import DEFAULT_SCHEME, LrcScheme
    from seaweedfs_tpu_torch.ops.lrc import LrcCoder, LrcCoderMT
    from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoderMT
    from seaweedfs_tpu_torch.ops.rs_mesh import MeshCoder
    from seaweedfs_tpu_torch.parallel import streaming
    from seaweedfs_tpu_torch.parallel.batcher import (BatchCoder,
                                                      EcBatchScheduler)
    from seaweedfs_tpu_torch.storage.erasure_coding import (ec_volume,
                                                            encoder, layout)
    from seaweedfs_tpu_torch.storage.store import Store
    lrc = LrcScheme()
    d = os.path.join(work, "lrc")
    os.makedirs(d)
    seconds = {}
    t0 = time.monotonic()
    vols = {}
    for vid, scheme in ((21, lrc), (22, DEFAULT_SCHEME)):
        base, payloads, version = make_volume(d, volume_mb, seed + vid, vid)
        encoder.write_sorted_ecx(base)
        ec_volume.write_volume_info(base, version, scheme)
        vols[vid] = (base, payloads, os.path.getsize(base + ".dat"))
    seconds["volumes"] = time.monotonic() - t0

    mesh_coder = MeshCoder(n_devices=1)
    rs_parity, lrc_parity = mesh_coder.parity, LrcCoder()._parity
    carried = []  # per rebuild_batch launch: (RS parity?, LRC parity?)
    real_rebuild = mesh_coder.rebuild_batch

    def recorded(src, mats):
        mats = [np.asarray(m) for m in mats]
        carried.append((any(np.array_equal(m, rs_parity) for m in mats),
                        any(np.array_equal(m, lrc_parity) for m in mats)))
        return real_rebuild(src, mats)

    mesh_coder.rebuild_batch = recorded
    sched = EcBatchScheduler(mesh_coder=mesh_coder, window_s=0.02,
                             max_batch=64)
    lrc_bc, rs_bc = BatchCoder(sched, lrc), BatchCoder(sched)
    try:
        # encode both at once through the one scheduler
        batch_counts.start()
        t0 = time.monotonic()
        _run_threads([(streaming.pipelined_encode_file, (vols[vid][0],),
                       {"coder": bc, "batch_size": layout.SMALL_BLOCK_SIZE})
                      for vid, bc in ((21, lrc_bc), (22, rs_bc))])
        seconds["encode"] = time.monotonic() - t0
        enc = sched.stats()
        enc_launches = batch_counts.read("lrc_volume", "gf_apply_batch",
                                         enc["mesh_batches"])
        mixed = sum(1 for rs, lr in carried if rs and lr)
        if enc["cpu_batches"] or enc["coder_fallbacks"] or not mixed:
            raise AssertionError(f"LRC + RS encode: {mixed} launches carried "
                                 f"both parity matrices, stats {enc}")
        t0 = time.monotonic()
        sha = {}
        for vid, host in ((21, LrcCoderMT()), (22, CpuCoderMT())):
            base, _, size = vols[vid]
            sha[vid] = [sha256_file(base + layout.shard_ext(i))
                        for i in range(14)]
            if sha[vid] != cpu_shard_sha(base, size, host):
                raise AssertionError(f"volume {vid}: shards differ from "
                                     f"{type(host).__name__}'s")
        seconds["check_against_host"] = time.monotonic() - t0

        # lose shard 7 on both; read every needle through a card Store
        for vid in vols:
            base = vols[vid][0]
            os.rename(base + ".ec07", base + ".ec07.lost")
        store = Store([d])
        for vid in vols:
            store.mount_ec_shards("", vid, [i for i in range(14) if i != 7])
        lrc_coder = store.coder_for(store.find_ec_volume(21))
        if not isinstance(lrc_coder, LrcCoder):
            raise AssertionError(f"the LRC volume decodes on {lrc_coder}")
        expect = {vid: _lost_intervals(store.find_ec_volume(vid),
                                       vols[vid][1], (7,)) for vid in vols}
        counts.start()
        reads = {}
        for vid in vols:
            reads[vid] = _read_all(store, vid, vols[vid][1])
        rec = dict(store.ec_recover_stats)
        read_launches = counts.read("lrc_volume", "gf_apply", rec["generic"])
        store.close()
        if rec != {"local": expect[21], "global": 0, "generic": expect[22]}:
            raise AssertionError(f"recoveries {rec}, expected {expect}")

        # one block through the facade: a 5-source plan, a CPU batch
        base = vols[21][0]
        n = layout.SMALL_BLOCK_SIZE
        block = {}
        for i in range(14):
            path = base + layout.shard_ext(i) + (".lost" if i == 7 else "")
            with open(path, "rb") as f:
                block[i] = f.read(n)
        cpu_before = sched.stats()["cpu_batches"]
        batch_counts.start()
        full = lrc_bc.reconstruct([None if i == 7 else block[i]
                                   for i in range(14)])
        facade = {"launches": batch_counts.now(),
                  "cpu_batches": sched.stats()["cpu_batches"] - cpu_before,
                  "fallbacks": sched.stats()["coder_fallbacks"]}
        if full[7] != block[7] or facade["cpu_batches"] != 1 or \
                facade["fallbacks"] or any(facade["launches"].values()):
            raise AssertionError(f"facade reconstruct of shard 7: {facade}")
        os.rename(base + ".ec07.lost", base + ".ec07")

        # lose {2,12}, rebuild on the facade through K1's batch entry
        for i in (2, 12):
            os.remove(base + layout.shard_ext(i))
        mesh_before = sched.stats()["mesh_batches"]
        stats: dict = {}
        batch_counts.start()
        t0 = time.monotonic()
        rebuilt = encoder.rebuild_ec_files(base, lrc_bc, pipelined=True,
                                           stats=stats)
        seconds["rebuild"] = time.monotonic() - t0
        st = sched.stats()
        reb_launches = batch_counts.read("lrc_volume", "gf_apply_batch",
                                         st["mesh_batches"] - mesh_before)
        if sorted(rebuilt) != [2, 12] or st["coder_fallbacks"] or \
                st["cpu_batches"] != enc["cpu_batches"] + 1:
            raise AssertionError(f"facade rebuild {rebuilt}, stats {st}")
        for i in (2, 12):
            if sha256_file(base + layout.shard_ext(i)) != sha[21][i]:
                raise AssertionError(f"rebuilt LRC shard {i} differs")
    finally:
        sched.stop()
        shutil.rmtree(d, ignore_errors=True)
    dat = sum(size for _, _, size in vols.values())
    emit("lrc_volume", schemes={"21": "LRC(10,2,2)", "22": "RS(10,4)"},
         volume_mb=volume_mb, dat_bytes=dat,
         encode={"MBps": dat / seconds["encode"] / 1e6,
                 "launches": enc_launches, "jobs": enc["jobs_total"],
                 "mesh_batches": enc["mesh_batches"],
                 "launches_with_both_parities": mixed,
                 "max_coalesced": enc["max_coalesced"],
                 "shards_sha256_equal_to_host": 28},
         reads={"lost": [7], "needles": {v: len(vols[v][1]) for v in vols},
                "wall_s": reads, "recoveries": rec,
                "lrc_local_from_sources": len(
                    lrc_coder.plan_rebuild([i for i in range(14) if i != 7],
                                           [7])[0]),
                "launches": read_launches, "bytes_equal": True},
         facade_block=facade,
         rebuild={"lost": [2, 12], "sources": stats["sources"],
                  "launches": reb_launches, "sha256_equal": True},
         seconds=seconds,
         reduced=f"two volumes of {volume_mb} MiB (--alt-volume-mb) for the "
                 "smoke's time limit")


def _dead_master() -> str:
    """host:port of a local port that nothing listens on (bound, then
    closed): the server's master calls fail at once with a refusal."""
    return f"127.0.0.1:{_free_ports(1)[0]}"


def _vs_json(url: str, path: str, body=None, method: str = "POST"):
    from seaweedfs_tpu_torch.utils.httpd import http_json
    return http_json(method, f"http://{url}{path}", body, timeout=600)


def _upload_volume(url: str, vid: int, volume_mb: int, seed: int):
    """Allocate volume `vid` on the server at `url` and upload needles of
    1 KiB-4 MiB seeded random payload, each one raw POST /<vid>,<fid>,
    until the payload reaches `volume_mb` MiB. Returns ({nid: (cookie,
    data)}, wall seconds of the uploads); each payload is its own bytes
    object, so checking a body against it is one memcmp (a memoryview
    slice compares element by element)."""
    import numpy as np
    from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
    from seaweedfs_tpu_torch.utils.httpd import http_call
    _vs_json(url, "/admin/allocate_volume", {"volume_id": vid})
    rng = np.random.default_rng(seed)
    target = volume_mb << 20
    sizes = []
    while sum(sizes) < target:
        sizes.append(int(rng.integers(1 << 10, (4 << 20) + 1)))
    blob = rng.bytes(sum(sizes))
    ids = (rng.permutation(len(sizes)) + 1).tolist()
    cookies = rng.integers(0, 1 << 32, len(sizes)).tolist()
    payloads = {}
    mv = memoryview(blob)
    off = 0
    t0 = time.monotonic()
    for nid, cookie, size in zip(ids, cookies, sizes):
        data = bytes(mv[off:off + size])
        off += size
        status, body, _ = http_call(
            "POST", f"http://{url}/{vid},"
            f"{format_needle_id_cookie(nid, cookie)}", body=data,
            timeout=120)
        if status >= 300:
            raise AssertionError(f"upload of {nid:x}: {status} {body[:200]}")
        payloads[nid] = (cookie, data)
    return payloads, time.monotonic() - t0


def _get_all(url: str, vid: int, payloads: dict, threads: int = 1,
             nids=None) -> tuple[float, list[float]]:
    """GET every needle (or `nids`) on `threads` client threads and check
    each body against its payload; returns (wall seconds, per-GET
    seconds)."""
    from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
    from seaweedfs_tpu_torch.utils.httpd import http_call
    nids = sorted(payloads) if nids is None else nids
    took: list[float] = []

    def get(part):
        for nid in part:
            cookie, data = payloads[nid]
            t0 = time.perf_counter()
            status, body, _ = http_call(
                "GET", f"http://{url}/{vid},"
                f"{format_needle_id_cookie(nid, cookie)}", timeout=120)
            took.append(time.perf_counter() - t0)
            if status != 200 or body != data:
                raise AssertionError(f"GET {vid},{nid:x}: {status}, "
                                     f"{len(body)} of {len(data)} bytes")

    t0 = time.monotonic()
    if threads == 1:
        get(nids)
    else:
        _run_threads([(get, (nids[i::threads],), {})
                      for i in range(threads)])
    return time.monotonic() - t0, took


def _encode_batches(dat_size: int, k: int) -> int:
    """Batches (one coder call each) of the server's EC encode of a .dat
    of `dat_size` bytes."""
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder, layout
    return sum(1 for _ in layout.iter_encode_batches(
        dat_size, layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE,
        encoder.DEFAULT_BATCH_SIZE, k))


def _flip(path: str, offset: int) -> None:
    """Invert one byte of a file in place (twice restores it)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


_TIMED_LOCK = threading.Lock()


def _timed_attrs(obj, names, stats=None, when=None) -> dict:
    """Wrap each callable attribute `name` of `obj` to add up its calls
    and seconds into stats[name] (a fresh {"calls", "seconds"} unless
    `stats` already holds one, so several objects can share it); with
    `when`, only calls whose positional arguments satisfy it count.
    Returns `stats` (live)."""
    stats = {} if stats is None else stats
    for name in names:
        fn = getattr(obj, name)
        st = stats.setdefault(name, {"calls": 0, "seconds": 0.0})

        def timed(*a, fn=fn, st=st, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if when is None or when(*a):
                    with _TIMED_LOCK:
                        st["calls"] += 1
                        st["seconds"] += time.perf_counter() - t0

        setattr(obj, name, timed)
    return stats


def _step(nbytes: int, wall: float, **extra) -> dict:
    """One server step: wall seconds and MB/s of `nbytes`."""
    return {"seconds": wall, "MBps": nbytes / wall / 1e6, **extra}


def server_phase(work: str, volume_mb: int, batch_volume_mb: int,
                 seed: int, counts: PathCounts,
                 batch_counts: PathCounts) -> None:
    """19. The volume server's EC plane on the card, driven over HTTP with
    the port's own http_call, the way the shell's ec.encode and a client
    call it. The master is an address where nothing listens."""
    import numpy as np
    from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoderMT
    from seaweedfs_tpu_torch.ops.rs_torch import TorchCoder
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder, layout
    from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
    from seaweedfs_tpu_torch.utils.httpd import http_call
    vid, total = 7, layout.TOTAL_SHARDS_COUNT
    d = os.path.join(work, "server")
    os.makedirs(d)
    vs = VolumeServer([d], _dead_master(), scrub_rate_mbps=0,
                      scrub_interval_s=0)
    steps: dict = {}
    launches: dict = {}
    try:
        vs.start()
        if not isinstance(vs.store.coder, TorchCoder) or \
                vs.store.coder.device.type != "cuda":
            raise AssertionError(f"the server took {vs.store.coder}")
        url = vs.url
        # 1. upload, then GET every needle from the healthy volume
        payloads, up_s = _upload_volume(url, vid, volume_mb, seed + 19)
        payload_bytes = sum(len(v) for _, v in payloads.values())
        steps["upload"] = _step(payload_bytes, up_s,
                                needles=len(payloads))
        counts.start()
        wall, took = _get_all(url, vid, payloads)
        if any(counts.now().values()):
            raise AssertionError(f"healthy GETs launched {counts.now()}")
        steps["get_healthy"] = _step(payload_bytes, wall,
                                     **_ms_stats(took))
        # 2. mark_readonly, generate, check the 14 shards, mount, delete
        _vs_json(url, "/admin/mark_readonly",
                 {"volume_id": vid, "read_only": True})
        base = os.path.join(d, str(vid))
        dat_size = os.path.getsize(base + ".dat")
        counts.start()
        t0 = time.monotonic()
        _vs_json(url, "/admin/ec/generate",
                 {"volume_id": vid, "collection": "", "pipelined": True})
        wall = time.monotonic() - t0
        batches = _encode_batches(dat_size, 10)
        launches["generate"] = counts.read("server", "gf_apply", batches)
        steps["generate"] = _step(dat_size, wall,
                                  batches=batches)
        shard_sha = [sha256_file(base + layout.shard_ext(i))
                     for i in range(total)]
        if shard_sha != cpu_shard_sha(base, dat_size, CpuCoderMT()):
            raise AssertionError("generated shards differ from CpuCoderMT's")
        _vs_json(url, "/admin/ec/mount", {"volume_id": vid, "collection": "",
                                          "shard_ids": list(range(total))})
        _vs_json(url, "/admin/delete_volume", {"volume_id": vid})
        if os.path.exists(base + ".dat"):
            raise AssertionError("delete_volume left the .dat")
        # 3. GETs from the EC volume: whole, then with 4 shards lost
        counts.start()
        wall, took = _get_all(url, vid, payloads)
        if any(counts.now().values()):
            raise AssertionError(f"EC GETs launched {counts.now()}")
        steps["get_ec"] = _step(payload_bytes, wall,
                                **_ms_stats(took))
        _vs_json(url, "/admin/ec/unmount",
                 {"volume_id": vid, "shard_ids": list(LOSS)})
        _vs_json(url, "/admin/ec/delete_shards",
                 {"volume_id": vid, "collection": "",
                  "shard_ids": list(LOSS)})
        ev = vs.store.find_ec_volume(vid)
        lost_iv = _lost_intervals(ev, payloads, LOSS)
        # what the dead master costs: each lost interval first asks it
        # where the shard lives (refused) before reconstructing
        lookups = _timed_attrs(vs.store, ("remote_shard_reader",
                                          "shard_locations"))
        for name, threads in (("get_degraded_1", 1),
                              ("get_degraded_16", 16)):
            before = vs.store.ec_recover_stats["generic"]
            for v in lookups.values():
                v.update(calls=0, seconds=0.0)
            counts.start()
            wall, took = _get_all(url, vid, payloads, threads=threads)
            recovered = vs.store.ec_recover_stats["generic"] - before
            launches[name] = counts.read("server", "gf_apply", recovered)
            steps[name] = _step(payload_bytes, wall,
                                recovered_intervals=recovered,
                                lost_intervals=lost_iv,
                                dead_master_lookups={
                                    k: dict(v) for k, v in lookups.items()},
                                **_ms_stats(took))
        # seeded Range GETs of needles that cross a lost shard
        rng = np.random.default_rng(seed + 19)
        crossing = sorted(
            nid for nid in payloads
            if any(iv.to_shard_id_and_offset(
                layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE,
                ev.data_shards)[0] in LOSS
                for iv in ev.locate_needle(nid)[0]))
        before = vs.store.ec_recover_stats["generic"]
        counts.start()
        t0 = time.monotonic()
        range_bytes = 0
        for i in rng.integers(0, len(crossing), 64):
            nid = crossing[int(i)]
            cookie, data = payloads[nid]
            lo = int(rng.integers(0, len(data)))
            ln = int(rng.integers(1, len(data) - lo + 1))
            status, body, _ = http_call(
                "GET", f"http://{url}/{vid},"
                f"{format_needle_id_cookie(nid, cookie)}",
                headers={"Range": f"bytes={lo}-{lo + ln - 1}"}, timeout=120)
            if status != 206 or body != data[lo:lo + ln]:
                raise AssertionError(f"Range GET {nid:x} {lo}+{ln}: "
                                     f"{status}, {len(body)} bytes")
            range_bytes += ln
        wall = time.monotonic() - t0
        recovered = vs.store.ec_recover_stats["generic"] - before
        if recovered == 0:
            raise AssertionError("no Range GET reconstructed an interval")
        launches["get_ranges"] = counts.read("server", "gf_apply", recovered)
        steps["get_ranges"] = _step(range_bytes, wall, ranges=64,
                                    recovered_intervals=recovered)
        # 4. rebuild the lost shards, check and mount them
        shard_size = os.path.getsize(base + layout.shard_ext(1))
        counts.start()
        t0 = time.monotonic()
        out = _vs_json(url, "/admin/ec/rebuild", {"volume_id": vid})
        wall = time.monotonic() - t0
        batches = -(-shard_size // encoder.DEFAULT_BATCH_SIZE)
        launches["rebuild"] = counts.read("server", "gf_apply", batches)
        if sorted(out["rebuilt_shard_ids"]) != list(LOSS):
            raise AssertionError(f"rebuild answered {out}")
        for i in LOSS:
            if sha256_file(base + layout.shard_ext(i)) != shard_sha[i]:
                raise AssertionError(f"rebuilt shard {i} differs")
        steps["rebuild"] = _step(shard_size * len(LOSS), wall,
                                 batches=batches)
        _vs_json(url, "/admin/ec/mount", {"volume_id": vid, "collection": "",
                                          "shard_ids": list(LOSS)})
        # 5. scrub: a data shard and, in another row group, a parity shard
        # flipped; exactly those named; after the undo, a clean pass
        chunk = vs.scrubber.ec_chunk_bytes
        groups = -(-shard_size // chunk)
        g_data, g_par = (int(g) for g in rng.choice(groups, 2, replace=False))
        data_sid, parity_sid = 2, 12
        flips = {(data_sid, g_data * chunk), (parity_sid, g_par * chunk)}
        flipped = [(sid, off + int(rng.integers(
            0, min(chunk, shard_size - off)))) for sid, off in sorted(flips)]
        for sid, at in flipped:
            _flip(base + layout.shard_ext(sid), at)
        counts.start()
        t0 = time.monotonic()
        dirty = _vs_json(url, "/admin/scrub", {"volume_id": vid})
        wall = time.monotonic() - t0
        named = {(c["shard_ids"][0], c["offset"])
                 for c in dirty["corruptions"] if c["type"] == "ec_shard"}
        if named != flips or len(dirty["corruptions"]) != 2:
            raise AssertionError(f"scrub named {dirty['corruptions']}, "
                                 f"flipped {sorted(flips)}")
        # one encode per group; in the data shard's group the leave-one-out
        # search tries shards 0..data_sid, a reconstruct and an encode each
        launches["scrub_dirty"] = counts.read(
            "server", "gf_apply", groups + 2 * (data_sid + 1))
        steps["scrub_dirty"] = _step(dirty["bytes"], wall,
                                     groups=groups)
        for sid, at in flipped:  # undo
            _flip(base + layout.shard_ext(sid), at)
        counts.start()
        t0 = time.monotonic()
        clean = _vs_json(url, "/admin/scrub", {"volume_id": vid})
        wall = time.monotonic() - t0
        if clean["corruptions"]:
            raise AssertionError(f"clean scrub: {clean['corruptions']}")
        launches["scrub_clean"] = counts.read("server", "gf_apply", groups)
        steps["scrub_clean"] = _step(clean["bytes"], wall,
                                     groups=groups)
        status, metrics, _ = http_call("GET", f"http://{url}/metrics")
        text = metrics.decode()
        if status != 200 or "volumeServer_request_total" not in text:
            raise AssertionError("/metrics lacks volumeServer_request_total")
        requests = {ln.split('type="', 1)[1].split('"', 1)[0]:
                    float(ln.rsplit(" ", 1)[1])
                    for ln in text.splitlines()
                    if "volumeServer_request_total{" in ln}
        zero_copy = requests.get("read_zero_copy", 0)
        eligible = sum(len(v) >= vs.zero_copy_min
                       for _, v in payloads.values())
        if zero_copy != eligible:
            raise AssertionError(f"{zero_copy} zero-copy GETs, {eligible} "
                                 "needles eligible")
        cache = _vs_json(url, "/admin/cache", method="GET")
    finally:
        vs.stop()
    emit("server", volume_mb=volume_mb, needles=len(payloads),
         payload_bytes=payload_bytes, dat_bytes=dat_size, lost=list(LOSS),
         master="nothing listening", steps=steps, launches=launches,
         scrub_corruptions=dirty["corruptions"],
         cache={k: cache.get(k) for k in ("hits", "misses", "inserts",
                                          "rejects", "items", "bytes")},
         metrics_request_total=requests, zero_copy_gets=zero_copy,
         shards_sha256_equal_to_cpu=total, rebuilt_sha256_equal=True,
         bodies_equal=True)
    server_batcher(work, batch_volume_mb, seed, batch_counts)


def server_batcher(work: str, volume_mb: int, seed: int,
                   counts: PathCounts) -> None:
    """19b. A second server with ec_batcher=True: a volume of `volume_mb`
    generated and, with shards {0,5,11,13} lost, rebuilt through its
    EcBatchScheduler on the card (K1's batch entry, one launch per mesh
    batch, no CPU batch, no fallback)."""
    from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoderMT
    from seaweedfs_tpu_torch.parallel.batcher import BatchCoder
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.erasure_coding import layout
    vid, total = 8, layout.TOTAL_SHARDS_COUNT
    d = os.path.join(work, "server_batcher")
    os.makedirs(d)
    vs = VolumeServer([d], _dead_master(), ec_batcher=True,
                      scrub_rate_mbps=0, scrub_interval_s=0)
    steps: dict = {}
    launches: dict = {}
    try:
        vs.start()
        if not isinstance(vs.store.coder, BatchCoder):
            raise AssertionError(f"ec_batcher server took {vs.store.coder}")
        url = vs.url
        payloads, up_s = _upload_volume(url, vid, volume_mb, seed + 20)
        del payloads
        _vs_json(url, "/admin/mark_readonly",
                 {"volume_id": vid, "read_only": True})
        base = os.path.join(d, str(vid))
        dat_size = os.path.getsize(base + ".dat")
        for name, path, body in (
                ("generate", "/admin/ec/generate",
                 {"volume_id": vid, "collection": "", "pipelined": True}),
                ("rebuild", "/admin/ec/rebuild", {"volume_id": vid})):
            # MB/s of .dat in (generate), of shards rebuilt (rebuild)
            if name == "rebuild":
                shard_sha = [sha256_file(base + layout.shard_ext(i))
                             for i in range(total)]
                if shard_sha != cpu_shard_sha(base, dat_size, CpuCoderMT()):
                    raise AssertionError("ec_batcher shards differ from "
                                         "CpuCoderMT's")
                _vs_json(url, "/admin/ec/mount",
                         {"volume_id": vid, "collection": "",
                          "shard_ids": list(range(total))})
                _vs_json(url, "/admin/delete_volume", {"volume_id": vid})
                _vs_json(url, "/admin/ec/unmount",
                         {"volume_id": vid, "shard_ids": list(LOSS)})
                _vs_json(url, "/admin/ec/delete_shards",
                         {"volume_id": vid, "collection": "",
                          "shard_ids": list(LOSS)})
            before = _vs_json(url, "/admin/ec/batcher", method="GET")
            counts.start()
            t0 = time.monotonic()
            out = _vs_json(url, path, body)
            wall = time.monotonic() - t0
            st = _vs_json(url, "/admin/ec/batcher", method="GET")
            batches = st["mesh_batches"] - before["mesh_batches"]
            launches[name] = counts.read("server_batcher", "gf_apply_batch",
                                         batches)
            nbytes = dat_size if name == "generate" else len(LOSS) * \
                os.path.getsize(base + layout.shard_ext(1))
            steps[name] = _step(nbytes, wall, mesh_batches=batches,
                                jobs=st["jobs_total"] - before["jobs_total"])
        if sorted(out["rebuilt_shard_ids"]) != list(LOSS):
            raise AssertionError(f"rebuild answered {out}")
        for i in LOSS:
            if sha256_file(base + layout.shard_ext(i)) != shard_sha[i]:
                raise AssertionError(f"rebuilt shard {i} differs")
    finally:
        vs.stop()
    if not st["enabled"] or st["jobs_total"] == 0 or \
            st["coder_fallbacks"] or st["cpu_batches"]:
        raise AssertionError(f"/admin/ec/batcher: {st}")
    emit("server_batcher", volume_mb=volume_mb, dat_bytes=dat_size,
         upload_MBps=dat_size / up_s / 1e6, steps=steps, launches=launches,
         jobs=st["jobs_total"], mesh_batches=st["mesh_batches"],
         cpu_batches=st["cpu_batches"], coder_fallbacks=st["coder_fallbacks"],
         max_coalesced=st["max_coalesced"],
         shards_sha256_equal_to_cpu=total, rebuilt_sha256_equal=True)


CLUSTER_SERVERS = 4
PRUNE_AFTER_S = 4.0  # two volume-server pulses (2 s) without a heartbeat


def _wait_for(cond, what: str, timeout: float = 10.0):
    """Poll `cond` until it returns something true; fail after
    `timeout` seconds naming `what`."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"cluster: timed out after {timeout} s "
                                 f"waiting for {what}")
        time.sleep(0.05)


def _ec_holders(mc, vid: int) -> dict[int, list[str]]:
    """{shard id: [holder urls]} from the master's /dir/lookup_ec."""
    mc.invalidate(vid)
    return {e["shard_id"]: [loc["url"] for loc in e["locations"]]
            for e in mc.lookup_ec_volume(vid)}


class _ServerMeters:
    """Per-step meters over the cluster's live volume servers: remote
    interval reads (the store's remote_shard_reader: direct reads and the
    columns a reconstruct fetches), master lookups (/dir/lookup_ec round
    trips behind the 5 s shard-location cache) and reconstructs (the
    store's recovered-interval counter, one K1 launch each)."""

    def __init__(self, servers):
        self.servers = list(servers)
        self.stats: dict = {}
        for vs in self.servers:
            _timed_attrs(vs.store, ("remote_shard_reader",), self.stats)
            _timed_attrs(vs, ("_master_json",), self.stats,
                         lambda method, path, *a:
                         path.startswith("/dir/lookup_ec"))

    def drop(self, vs) -> None:
        self.servers.remove(vs)

    def recovered(self) -> int:
        return sum(vs.store.ec_recover_stats["generic"]
                   for vs in self.servers)

    def start(self) -> None:
        for st in self.stats.values():
            st.update(calls=0, seconds=0.0)
        self._recovered0 = self.recovered()

    def read(self) -> dict:
        return {"remote_interval_reads":
                dict(self.stats["remote_shard_reader"]),
                "master_lookups": dict(self.stats["_master_json"]),
                "reconstructs": self.recovered() - self._recovered0}


def _launched_per_reconstruct(counts: PathCounts, name: str,
                               reconstructs: int) -> dict:
    """A GET step's K1 launches: one per interval the servers
    reconstructed (none on a healthy volume), and no other entry."""
    if reconstructs:
        return counts.read("cluster", "gf_apply", reconstructs)
    if any(counts.now().values()):
        raise AssertionError(f"{name}: launches {counts.now()} without "
                             "a reconstruct")
    return counts.now()


def _cluster_gets(files: list, urls: list[str], threads: int = 1):
    """GET every needle over HTTP, needle i from urls[i % len(urls)] (a
    client spreads its reads over the volume's holders), on `threads`
    client threads; every body is checked byte for byte. Returns (wall
    seconds, per-GET seconds)."""
    from seaweedfs_tpu_torch.utils.httpd import http_call
    took: list[float] = []
    jobs = [(fid, data, urls[i % len(urls)])
            for i, (fid, data) in enumerate(files)]

    def get(part):
        for fid, data, url in part:
            t0 = time.perf_counter()
            status, body, _ = http_call("GET", f"http://{url}/{fid}",
                                        timeout=120)
            took.append(time.perf_counter() - t0)
            if status != 200 or body != data:
                raise AssertionError(f"GET {fid} from {url}: {status}, "
                                     f"{len(body)} of {len(data)} bytes")

    t0 = time.monotonic()
    if threads == 1:
        get(jobs)
    else:
        _run_threads([(get, (jobs[i::threads],), {})
                      for i in range(threads)])
    return time.monotonic() - t0, took


def cluster_phase(work: str, volume_mb: int, seed: int,
                  counts: PathCounts) -> None:
    """20. The port's own cluster on the card: its MasterServer (default
    repair settings) and four of its VolumeServers on the card, on racks
    r0 / r1 of dc1, driven through its MasterClient, client.operation and
    ShellContext as `weed upload`, `ec.encode`, `ec.rebuild` and
    `ec.decode` drive them."""
    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoderMT
    from seaweedfs_tpu_torch.ops.rs_torch import TorchCoder
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.shell.commands import ShellContext
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder, layout
    from seaweedfs_tpu_torch.utils.httpd import http_json
    import numpy as np
    total = layout.TOTAL_SHARDS_COUNT
    root = os.path.join(work, "cluster")
    master = MasterServer(volume_size_limit_mb=1024)
    master.start()
    servers: list = []
    live: list = []
    steps: dict = {}
    launches: dict = {}
    mc = None
    try:
        sh = ShellContext(master.url)

        def n_nodes():
            topo = sh.topology()
            return sum(len(r["nodes"]) for dc in topo["data_centers"]
                       for r in dc["racks"])

        for i in range(CLUSTER_SERVERS):
            vs = VolumeServer([os.path.join(root, f"v{i}")], master.url,
                              rack=f"r{i % 2}", data_center="dc1",
                              scrub_interval_s=0, scrub_rate_mbps=0)
            vs.start()
            servers.append(vs)
            live.append(vs)
            if not isinstance(vs.store.coder, TorchCoder) or \
                    vs.store.coder.device.type != "cuda":
                raise AssertionError(f"server {i} took {vs.store.coder}")
            _wait_for(lambda: n_nodes() == i + 1,
                      f"volume server {i} to register")
        index = {vs.url: i for i, vs in enumerate(servers)}
        meters = _ServerMeters(servers)
        mc = MasterClient(master.url)

        # 1. upload config 1's needle mix through client.operation
        rng = np.random.default_rng(seed + 20)
        sizes = []
        while sum(sizes) < volume_mb << 20:
            sizes.append(int(rng.integers(1 << 10, (4 << 20) + 1)))
        blob = rng.bytes(sum(sizes))
        mv = memoryview(blob)
        files: list = []
        off = 0
        counts.start()
        t0 = time.monotonic()
        for size in sizes:
            data = bytes(mv[off:off + size])
            off += size
            files.append((operation.upload_data(mc, data).fid, data))
        wall = time.monotonic() - t0
        del blob, mv
        payload = sum(len(d) for _, d in files)
        if any(counts.now().values()):
            raise AssertionError(f"uploads launched {counts.now()}")
        vids = sorted({int(fid.split(",")[0]) for fid, _ in files})
        if len(vids) != 1:
            raise AssertionError(f"the master grew volumes {vids}, not one")
        vid = vids[0]
        steps["upload"] = _step(payload, wall, needles=len(files),
                                assigns_from_leases=mc.lease_assigns,
                                assigns_from_master=mc.lease_fallbacks)

        # 2. ec.encode: generate on the source (K1), spread by ec_plan;
        # the source .dat hard-linked first, for the host coder's check
        src = next(vs for vs in servers if vs.store.find_volume(vid))
        base = os.path.join(root, f"v{index[src.url]}", str(vid))
        dat_size = os.path.getsize(base + ".dat")
        keep = os.path.join(root, "source")
        os.makedirs(keep)
        os.link(base + ".dat", os.path.join(keep, f"{vid}.dat"))
        sh.lock()
        counts.start()
        meters.start()
        t0 = time.monotonic()
        enc = sh.ec_encode()
        wall = time.monotonic() - t0
        batches = _encode_batches(dat_size, layout.DATA_SHARDS_COUNT)
        launches["encode"] = counts.read("cluster", "gf_apply", batches)
        if [r["vid"] for r in enc] != [vid] or \
                enc[0]["source"] != src.url:
            raise AssertionError(f"ec.encode answered {enc}")
        placement = {index[u]: s for u, s in enc[0]["placement"].items()}
        holders = _ec_holders(mc, vid)
        shard_sha = {}
        for sid in range(total):
            if len(holders.get(sid, [])) != 1:
                raise AssertionError(f"shard {sid} held by {holders}")
            i = index[holders[sid][0]]
            if sid not in placement[i]:
                raise AssertionError(f"shard {sid} on {i}, not {placement}")
            shard_sha[sid] = sha256_file(os.path.join(
                root, f"v{i}", f"{vid}{layout.shard_ext(sid)}"))
        cpu_sha = cpu_shard_sha(os.path.join(keep, str(vid)), dat_size,
                                CpuCoderMT())
        if [shard_sha[s] for s in range(total)] != cpu_sha:
            raise AssertionError("spread shards differ from CpuCoderMT's")
        shutil.rmtree(keep)
        if os.path.exists(base + ".dat"):
            raise AssertionError("ec.encode left the source .dat")
        steps["encode"] = _step(dat_size, wall, batches=batches,
                                **meters.read())

        # 3. every needle from the spread volume, 1 and 16 client threads
        urls = sorted({u for us in holders.values() for u in us})
        for name, threads in (("get_1", 1), ("get_16", 16)):
            counts.start()
            meters.start()
            wall, took = _cluster_gets(files, urls, threads)
            got = meters.read()
            if got["reconstructs"]:
                raise AssertionError(f"{name}: {got} on a healthy volume")
            launches[name] = _launched_per_reconstruct(counts, name, 0)
            steps[name] = _step(payload, wall, **got, **_ms_stats(took))

        # 4. lose the server holding the most shards; prune it
        held = {i: (len(s), 0 in s) for i, s in placement.items()}
        victim = servers[max(held, key=held.get)]
        victim.stop()
        live.remove(victim)
        meters.drop(victim)

        def pruned():
            master.topo.prune_dead_nodes(timeout=PRUNE_AFTER_S)
            return n_nodes() == len(live)

        t0 = time.monotonic()
        _wait_for(pruned, "the master to prune the stopped server")
        prune_s = time.monotonic() - t0
        lost = sorted(placement[index[victim.url]])
        urls = sorted(vs.url for vs in live)
        for name, threads in (("get_degraded_1", 1),
                              ("get_degraded_16", 16)):
            counts.start()
            meters.start()
            wall, took = _cluster_gets(files, urls, threads)
            got = meters.read()
            # the first pass after the loss must reconstruct; the second
            # may find the needle caches warm (all of them at a small size)
            if threads == 1 and not got["reconstructs"]:
                raise AssertionError(f"{name}: no interval reconstructed")
            launches[name] = _launched_per_reconstruct(
                counts, name, got["reconstructs"])
            steps[name] = _step(payload, wall, **got, **_ms_stats(took))

        # 5. ec.rebuild: survivors copied to the rebuilder, K1, mount
        status = sh.ec_repair_status()
        queued = [t for t in status["queue"] + status["in_flight"]
                  if t["volume_id"] == vid]
        if queued:
            raise AssertionError(f"the repair queue raced ec.rebuild: "
                                 f"{queued}")
        counts.start()
        meters.start()
        t0 = time.monotonic()
        plans = sh.ec_rebuild()
        rebuilt_at = time.monotonic()
        wall = rebuilt_at - t0
        if len(plans) != 1 or sorted(plans[0].get("rebuilt", [])) != lost:
            raise AssertionError(f"ec.rebuild answered {plans}, lost {lost}")
        rebuilder = next(vs for vs in live
                         if vs.url == plans[0]["rebuilder"])
        rdir = os.path.join(root, f"v{index[rebuilder.url]}")
        shard_size = os.path.getsize(
            os.path.join(rdir, f"{vid}{layout.shard_ext(lost[0])}"))
        batches = -(-shard_size // encoder.DEFAULT_BATCH_SIZE)
        launches["rebuild"] = counts.read("cluster", "gf_apply", batches)
        for sid in lost:
            path = os.path.join(rdir, f"{vid}{layout.shard_ext(sid)}")
            if sha256_file(path) != shard_sha[sid]:
                raise AssertionError(f"rebuilt shard {sid} differs")
        holders = _ec_holders(mc, vid)
        if sorted(s for s, us in holders.items() if us) != \
                list(range(total)):
            raise AssertionError(f"after ec.rebuild: {holders}")
        steps["rebuild"] = _step(shard_size * len(lost), wall,
                                 batches=batches,
                                 copies=len(plans[0]["copies"]),
                                 **meters.read())
        counts.start()
        meters.start()
        urls = sorted({u for us in holders.values() for u in us})
        wall, took = _cluster_gets(files, urls)
        # a server's 5 s shard-location cache may still list a rebuilt
        # shard as lost: such an interval is reconstructed, not fetched
        got = meters.read()
        launches["get_rebuilt"] = _launched_per_reconstruct(
            counts, "get_rebuilt", got["reconstructs"])
        steps["get_rebuilt"] = _step(payload, wall, **got,
                                     **_ms_stats(took))

        # 6. the repair queue: a holder's parity shard flipped; its
        # /admin/scrub (remote-assisted: it holds fewer than k shards)
        # reports it, the master's queue repairs it (partial chain)
        holder = next(vs for vs in live if vs is not rebuilder)
        hidx = index[holder.url]
        parity = [s for s in placement[hidx]
                  if s >= layout.DATA_SHARDS_COUNT]
        if len(parity) != 1:
            raise AssertionError(f"server {hidx} holds {placement[hidx]}")
        psid = parity[0]
        # in the last row group: the queue unmounts a reported shard at
        # once, and a pass still reading it fails on the next group (as
        # the JAX package's scrubber does)
        chunk = holder.scrubber.ec_chunk_bytes
        group = -(-shard_size // chunk) - 1
        at = group * chunk + int(rng.integers(
            0, min(chunk, shard_size - group * chunk)))
        _flip(os.path.join(root, f"v{hidx}",
                           f"{vid}{layout.shard_ext(psid)}"), at)
        # the holder's shard-location cache must have seen the rebuilt
        # shards, else the remote-assisted check finds a column without a
        # holder and skips the volume
        time.sleep(max(0.0, rebuilt_at + VolumeServer.SHARD_LOC_TTL + 0.5
                       - time.monotonic()))
        before = sh.ec_repair_status()
        counts.start()
        meters.start()
        t0 = time.monotonic()
        scrub = _vs_json(holder.url, "/admin/scrub", {"volume_id": vid})
        scrub_wall = time.monotonic() - t0
        named = [(c["shard_ids"], c["offset"]) for c in scrub["corruptions"]]
        if named != [([psid], group * chunk)]:
            raise AssertionError(f"scrub named {scrub['corruptions']}, "
                                 f"flipped shard {psid} at {at}: "
                                 f"{scrub['volumes']}")
        if any(counts.now().values()):
            raise AssertionError(f"the remote-assisted scrub launched "
                                 f"{counts.now()}")
        scrub_meters = meters.read()

        def repaired():
            st = sh.ec_repair_status()
            return st["repaired_total"] > before["repaired_total"] and \
                not st["in_flight"] and not st["queue"] and st

        status = _wait_for(repaired, "the repair queue's repair",
                           timeout=120.0)
        wall = time.monotonic() - t0
        if any(counts.now().values()):
            raise AssertionError(f"the repair launched {counts.now()}")
        holders = _ec_holders(mc, vid)
        if len(holders.get(psid, [])) != 1:
            raise AssertionError(f"shard {psid} after repair: {holders}")
        new_holder = holders[psid][0]
        repaired_sha = sha256_file(os.path.join(
            root, f"v{index[new_holder]}", f"{vid}{layout.shard_ext(psid)}"))
        if repaired_sha != shard_sha[psid]:
            raise AssertionError(f"repaired shard {psid} differs")
        steps["scrub"] = _step(scrub["bytes"], scrub_wall,
                               remote_assisted=True, **scrub_meters)
        steps["repair"] = {
            "seconds": wall, "shard": psid,
            "strategy": status.get("last_strategy"),
            "partial_repairs": status["partial_repairs"],
            "partial_fallbacks": status["partial_fallbacks"],
            "bytes_moved": status["bytes_moved"] - before["bytes_moved"],
            "network_bytes_per_mb":
                status["last_repair_network_bytes_per_mb"],
            "from_server": hidx, "to_server": index[new_holder]}
        if status["partial_repairs"] != before["partial_repairs"] + 1:
            raise AssertionError(f"not the partial chain: {status}")

        # 7. ec.decode onto one server; read every needle back
        counts.start()
        meters.start()
        t0 = time.monotonic()
        dec = sh.ec_decode(vid)
        wall = time.monotonic() - t0
        if any(counts.now().values()):
            raise AssertionError(f"ec.decode launched {counts.now()}")
        steps["decode"] = _step(dat_size, wall,
                                collector=index[dec["collector"]],
                                dat_bytes=dec["dat_size"], **meters.read())
        sh.unlock()

        def readable():
            mc.invalidate(vid)
            try:
                return mc.lookup_volume(vid)
            except Exception:
                return None

        _wait_for(readable, "the decoded volume to be looked up")
        t0 = time.monotonic()
        for fid, data in files:
            if operation.read_data(mc, fid) != data:
                raise AssertionError(f"read_data {fid} after ec.decode")
        steps["read_decoded"] = _step(payload, time.monotonic() - t0)
    finally:
        if mc is not None:
            mc.stop()
        for vs in live:
            vs.stop()
        master.stop()
    emit("cluster", volume_mb=volume_mb, servers=CLUSTER_SERVERS,
         racks={i: f"r{i % 2}" for i in range(CLUSTER_SERVERS)},
         needles=len(files), payload_bytes=payload, dat_bytes=dat_size,
         volume_id=vid, placement=placement, victim=index[victim.url],
         lost=lost, prune_s=prune_s,
         rebuilder=index[rebuilder.url], steps=steps, launches=launches,
         shards_sha256_equal_to_cpu=total, rebuilt_sha256_equal=True,
         repaired_sha256_equal=True, bodies_equal=True)


CLI_MASTERS = 3
CLI_SERVERS = 4


def volume_child(counts_path: str, argv: list[str]) -> int:
    """The entry that `cli_phase` starts each `weed volume` process
    through: it reports the process's kernel launch counts (the wrappers'
    own counters, as PathCounts reads them in this process) into the JSON
    file `counts_path`, rewritten after every wrapper call and on SIGUSR1,
    which sets the counts to 0; then it runs
    seaweedfs_tpu_torch.cli.main(argv). The server's code keeps no count
    of its own, and a SIGKILLed server leaves its last report."""
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.ops import rs_cuda, rs_mxu
    lock = threading.RLock()
    resets = [0]

    def report():
        with lock:
            _write_json(counts_path, {**PathCounts.now(),
                                      "resets": resets[0]})

    def reported(fn):
        def call(*a, **kw):
            try:
                return fn(*a, **kw)
            finally:
                report()
        return call

    def reset(signum, frame):
        with lock:
            PathCounts.start()
            resets[0] += 1
            report()

    rs_cuda.gf_apply = reported(rs_cuda.gf_apply)
    rs_cuda.gf_apply_batch = reported(rs_cuda.gf_apply_batch)
    rs_mxu.mxu_apply = reported(rs_mxu.mxu_apply)
    signal.signal(signal.SIGUSR1, reset)
    report()
    cli.main(argv)
    return 0


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def cli_child(routes_path: str, argv: list[str]) -> int:
    """The entry that `cli_phase` runs a shell or backup command through:
    it counts, in this process, every HTTP request the port's http_call
    sends ("METHOD /path") and every RPC the port's GrpcVolumeClient
    issues (by method), runs seaweedfs_tpu_torch.cli.main(argv), and
    writes the counts into the JSON file `routes_path` when it ends, with
    the seconds spent importing the CLI, importing the gRPC client (which
    the counting needs even where the command sends no RPC), in cli.main,
    in the shell's per-node gRPC probes (`_grpc_client`), in the
    replication commands' probe of the filer's gRPC plane
    (`_probe_filer_grpc`), in unary RPCs and in HTTP requests. A daemon
    (filer.backup, filer.sync) writes them when SIGINT ends it. The
    commands' code keeps no count of its own."""
    import collections
    import urllib.parse
    t0 = time.monotonic()
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.utils import httpd
    t1 = time.monotonic()
    from seaweedfs_tpu_torch.server import volume_grpc
    routes = {"http": collections.Counter(), "grpc": collections.Counter()}
    seconds = collections.Counter(import_s=t1 - t0,
                                  grpc_import_s=time.monotonic() - t1)
    lock = threading.Lock()

    def count(kind: str, key: str) -> None:
        with lock:
            routes[kind][key] += 1

    def timed(fn, what: str):
        def call(*a, **kw):
            t = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    seconds[what] += time.monotonic() - t
        return call

    def counted_http(fn):
        def call(method, url, *a, **kw):
            count("http", f"{method} {urllib.parse.urlsplit(url).path}")
            return fn(method, url, *a, **kw)
        return timed(call, "http_s")

    def counted_rpc(fn, method=None):
        def call(self, *a, **kw):
            count("grpc", method or a[0])
            return fn(self, *a, **kw)
        return call

    httpd.http_call = counted_http(httpd.http_call)
    client = volume_grpc.GrpcVolumeClient
    client._unary = timed(counted_rpc(client._unary), "rpc_s")
    client._json_unary = timed(counted_rpc(client._json_unary), "rpc_s")
    for attr, method in (("copy_file", "CopyFile"),
                         ("ec_shard_read", "VolumeEcShardRead"),
                         ("volume_tail_needles", "VolumeTailSender"),
                         ("volume_incremental_copy",
                          "VolumeIncrementalCopy")):
        setattr(client, attr, counted_rpc(getattr(client, attr), method))
    commands.ShellContext._grpc_client = timed(
        commands.ShellContext._grpc_client, "probe_s")
    # the replication commands' probe of a filer's gRPC plane (it waits
    # up to 0.5 s for the channel, as the reference's does)
    from seaweedfs_tpu_torch.replication import sync
    sync._probe_filer_grpc = timed(sync._probe_filer_grpc, "filer_probe_s")
    t1 = time.monotonic()
    try:
        cli.main(argv)
    finally:
        seconds["main_s"] = time.monotonic() - t1
        with open(routes_path, "w") as f:
            json.dump({**{k: dict(v) for k, v in routes.items()},
                       "seconds": dict(seconds)}, f)
    return 0


# the stores route's wire families: (module, the in-process server that
# speaks the family's protocol); the filer's -store name is the key
STORE_DBS = {
    "redis": ("redis_store", "MiniRedisServer"),
    "mysql": ("mysql_store", "MiniMysqlServer"),
    "postgres": ("postgres_store", "MiniPostgresServer"),
    "mongodb": ("mongodb_store", "MiniMongoServer"),
    "cassandra": ("cassandra_store", "MiniCassandraServer"),
    "elastic": ("elastic_store", "MiniElasticServer"),
    "etcd": ("etcd_store", "MiniEtcdServer"),
}


def db_child(ports_path: str) -> int:
    """The entry that the `filer` phase starts the stores route's databases
    through: the port's servers of the seven wire families (STORE_DBS), in
    a process of their own as a database is in a deployment. It writes
    {family: port} into the JSON file `ports_path`, prints it, and serves
    until SIGTERM."""
    import importlib
    servers = {}
    for family, (module, cls) in STORE_DBS.items():
        mod = importlib.import_module(f"seaweedfs_tpu_torch.filer.{module}")
        servers[family] = getattr(mod, cls)().start()
    ports = {family: srv.port for family, srv in servers.items()}
    _write_json(ports_path, ports)
    print(json.dumps({"db_ports": ports}), flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    while not stop.wait(0.5):
        pass
    for srv in servers.values():
        srv.stop()
    return 0


def mount_child(spec_path: str, out_path: str) -> int:
    """The entry that the `filer` phase's mount route runs in a process of
    its own: what `weed mount -master M -filer F` serves
    (seaweedfs_tpu_torch.cli.open_mount: WeedFS over the filer's remote
    store view, its gRPC admin plane announced to the master), driven
    through WeedFS's operations instead of a kernel mount. It reads every
    file of the spec's directory through lookup / open / read / release,
    checking each sha256, writes the spec's seeded files in 1 MiB pieces,
    renames each into a subdirectory and reads it back, and writes what
    it saw to `out_path` ("done"). It then waits for the admin plane's
    Configure (the REPL's mount.configure) to set a quota, writes the
    statfs it reports ("configured"), and closes the mount on SIGTERM or
    SIGINT."""
    import numpy as np

    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.mount.fuse_kernel import ROOT_ID
    with open(spec_path) as f:
        spec = json.load(f)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    t0 = time.monotonic()
    w, admin_port, close = cli.open_mount(spec["master"], spec["filer"])
    out: dict = {"admin_port": admin_port,
                 "open_s": time.monotonic() - t0}

    def resolve(path: str):
        attr = None
        ino = ROOT_ID
        for name in path.strip("/").split("/"):
            attr = w.lookup(ino, name)
            if attr is None:
                raise FileNotFoundError(path)
            ino = attr.ino
        return attr

    def read_all(attr) -> bytes:
        fh = w.open(attr.ino)
        try:
            return b"".join(w.read(attr.ino, fh, off, 1 << 20)
                            for off in range(0, attr.size, 1 << 20))
        finally:
            w.release(attr.ino, fh)

    try:
        took = []
        t0 = time.monotonic()
        for rel, size, digest in spec["files"]:
            t = time.perf_counter()
            attr = resolve(f"{spec['read_dir']}/{rel}")
            body = read_all(attr)
            took.append(time.perf_counter() - t)
            if attr.size != size or len(body) != size or \
                    hashlib.sha256(body).hexdigest() != digest:
                raise AssertionError(f"mount read {rel}: {attr.size} / "
                                     f"{len(body)} of {size} bytes")
        out["read"] = {"seconds": time.monotonic() - t0, "files": len(took),
                       "bytes": sum(size for _, size, _ in spec["files"]),
                       "per_file_s": took}
        rng = np.random.default_rng(spec["seed"])
        wdir = spec["write_dir"]
        d = w.mkdir(ROOT_ID, wdir.strip("/"), 0o755)
        moved = w.mkdir(d.ino, "moved", 0o755)
        written = {}
        t0 = time.monotonic()
        for name, size in spec["writes"]:
            data = rng.bytes(size)
            attr, fh = w.create(d.ino, name, 0o644)
            for off in range(0, size, 1 << 20):
                w.write(attr.ino, fh, off, data[off:off + (1 << 20)])
            w.release(attr.ino, fh)
            if w.rename(d.ino, name, moved.ino, name) != 0:
                raise AssertionError(f"mount rename {name}")
            if w.lookup(d.ino, name) is not None:
                raise AssertionError(f"mount: {name} still at its old name")
            back = read_all(resolve(f"{wdir}/moved/{name}"))
            if back != data:
                raise AssertionError(f"mount read-back {name}: {len(back)} "
                                     f"of {size} bytes differ")
            written[name] = hashlib.sha256(data).hexdigest()
        out["write"] = {"seconds": time.monotonic() - t0,
                        "files": written,
                        "bytes": sum(size for _, size in spec["writes"])}
        out["statfs"] = list(w.statfs() or ())
        out["phase"] = "done"
        _write_json(out_path, out)
        while not w.collection_capacity:
            if stop.wait(0.05):
                return 1
        out["capacity"] = w.collection_capacity
        out["statfs_configured"] = list(w.statfs() or ())
        out["phase"] = "configured"
        _write_json(out_path, out)
        stop.wait()
    except BaseException as e:
        out["error"] = f"{type(e).__name__}: {e}"
        _write_json(out_path, out)
        raise
    finally:
        close()
    return 0


GRPC_OFFSET = 10000  # `-grpc` serves a process's gRPC plane on port + this


def _free_ports(n: int, grpc: bool = False) -> list[int]:
    """n local ports that were free a moment ago (bound, then closed), in
    ascending order; with grpc=True each port's gRPC twin, port +
    GRPC_OFFSET, was free too."""
    import socket
    socks: list = []
    ports: list[int] = []
    try:
        while len(ports) < n:
            s = socket.socket()
            socks.append(s)
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            if grpc:
                if port + GRPC_OFFSET > 65535:
                    continue
                twin = socket.socket()
                socks.append(twin)
                try:
                    twin.bind(("127.0.0.1", port + GRPC_OFFSET))
                except OSError:
                    continue
            ports.append(port)
        return sorted(ports)
    finally:
        for s in socks:
            s.close()


def _smi_apps() -> list[str]:
    """`nvidia-smi --query-compute-apps=pid,used_memory`: one line per
    process holding a CUDA context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _holds_card(pid: int) -> bool:
    """Whether process `pid` has a CUDA device node (/dev/nvidiaN) open,
    which its CUDA context keeps open."""
    import re
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if re.fullmatch(r"/dev/nvidia\d+",
                            os.readlink(os.path.join(fd_dir, fd))):
                return True
        except OSError:
            continue
    return False


class _CliCluster:
    """The `cli` and `filer` phases' processes: `weed master` processes
    (with -peers when there are several), CLI_SERVERS `weed volume`
    processes (through volume_child), `weed filer` processes and the
    stores route's databases (through db_child), their logs under `root`,
    each volume server's launch counts in a JSON file there."""

    def __init__(self, root: str):
        self.root = root
        self.repo = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=self.repo)
        self.masters: dict[str, subprocess.Popen] = {}
        self.servers: dict[str, subprocess.Popen] = {}
        self.filers: dict[str, subprocess.Popen] = {}
        self.gateways: dict[str, subprocess.Popen] = {}
        self.followers: dict[str, subprocess.Popen] = {}
        self.dbs: dict[str, subprocess.Popen] = {}
        # cli-child daemons (filer.backup, filer.sync) and mount-child
        self.daemons: dict[str, subprocess.Popen] = {}
        self.filer_starts = 0
        self.filer_start_of: dict[str, int] = {}
        self.counted = 0
        self.rack: dict[str, str] = {}
        self.killed: set[str] = set()
        self.resets: dict[str, int] = {}
        self.start_s: dict[str, float] = {}

    def _spawn(self, name: str, argv: list[str]) -> subprocess.Popen:
        log = open(os.path.join(self.root, f"{name}.log"), "w")
        try:
            p = subprocess.Popen(argv, cwd=self.repo, env=self.env,
                                 stdout=log, stderr=subprocess.STDOUT,
                                 stdin=subprocess.DEVNULL)
        finally:
            log.close()
        p.log_path = log.name
        return p

    def cli(self, *args: str, stdin: str = "", timeout: float = 600.0):
        """Run one `python -m seaweedfs_tpu_torch.cli` command to its end;
        a nonzero exit fails the phase. Returns (stdout, seconds)."""
        t0 = time.monotonic()
        p = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.cli",
                            *args], cwd=self.repo, env=self.env,
                           input=stdin, capture_output=True, text=True,
                           timeout=timeout)
        if p.returncode != 0:
            raise AssertionError(f"cli {args[0]} exited {p.returncode}: "
                                 f"{p.stderr[-2000:]}")
        return p.stdout, time.monotonic() - t0

    def cli_counted(self, *args: str, stdin: str = "",
                    timeout: float = 600.0):
        """`cli` through this script's `cli-child` entry: returns (stdout,
        seconds, routes), routes being the HTTP requests ("METHOD /path")
        and volume-server RPCs the command sent, each with its count. A
        command that sent no RPC would not have imported the gRPC client
        run plainly, so its seconds leave out that import, which
        `cli-child` makes to count."""
        self.counted += 1
        path = os.path.join(self.root, f"routes_{self.counted}.json")
        t0 = time.monotonic()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "cli-child", path, *args], cwd=self.repo,
                           env=self.env, input=stdin, capture_output=True,
                           text=True, timeout=timeout)
        if p.returncode != 0:
            raise AssertionError(f"cli {args[0]} exited {p.returncode}: "
                                 f"{p.stderr[-2000:]}")
        wall = time.monotonic() - t0
        with open(path) as f:
            routes = json.load(f)
        if not routes["grpc"]:
            wall -= routes["seconds"]["grpc_import_s"]
        return p.stdout, wall, routes

    def start_daemon(self, name: str, *args: str) -> str:
        """A long-running `weed` command (filer.backup, filer.sync)
        through `cli-child`, its routes written to routes_<name>.json
        when stop_daemon ends it."""
        self.start_s[name] = time.monotonic()
        self.daemons[name] = self._spawn(name, [
            sys.executable, os.path.abspath(__file__), "cli-child",
            os.path.join(self.root, f"routes_{name}.json"), *args])
        return name

    def start_mount(self, name: str, spec: dict) -> str:
        """`mount-child` with `spec`; its report goes to <name>.json."""
        path = os.path.join(self.root, f"{name}_spec.json")
        _write_json(path, spec)
        self.start_s[name] = time.monotonic()
        self.daemons[name] = self._spawn(name, [
            sys.executable, os.path.abspath(__file__), "mount-child", path,
            os.path.join(self.root, f"{name}.json")])
        return name

    def daemon_report(self, name: str, file: str = "") -> dict | None:
        """What a daemon wrote into root/<file or name>.json, or None."""
        try:
            with open(os.path.join(self.root,
                                   (file or name) + ".json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def stop_daemon(self, name: str) -> float:
        """SIGINT (a daemon's clean stop: `weed`'s wait ends, mount-child
        closes its mount), then its exit, which must be 0; returns the
        seconds the stop took."""
        t0 = time.monotonic()
        p = self.daemons[name]
        p.send_signal(signal.SIGINT)
        code = p.wait(timeout=60)
        self.killed.add(name)  # ended on purpose: check_running skips it
        if code != 0:
            with open(p.log_path, errors="replace") as f:
                tail = f.read()[-1500:]
            raise AssertionError(f"{name} exited {code}; its log ends: "
                                 f"{tail}")
        return time.monotonic() - t0

    def start_masters(self, volume_limit_mb: int,
                      count: int = CLI_MASTERS,
                      grpc: bool = False) -> list[str]:
        ports = _free_ports(count, grpc=grpc)
        urls = [f"127.0.0.1:{p}" for p in ports]
        for url, port in zip(urls, ports):
            mdir = os.path.join(self.root, f"m{port}")
            os.makedirs(mdir)
            self.start_s[url] = time.monotonic()
            peers = ["-peers", ",".join(urls)] if count > 1 else []
            self.masters[url] = self._spawn(f"master_{port}", [
                sys.executable, "-m", "seaweedfs_tpu_torch.cli", "master",
                "-port", str(port), "-mdir", mdir, *peers,
                "-volumeSizeLimitMB", str(volume_limit_mb),
                *(["-grpc"] if grpc else [])])
        return urls

    def start_filer(self, master: str, port: int, store_dir: str,
                    grpc: bool = False, store: str = "lsm",
                    mq_port: int = 0) -> str:
        """`weed filer -store <store> -dir store_dir` on `port` (again after
        a kill: the same port, as the master still lists it), with -grpc
        its gRPC plane on port + GRPC_OFFSET, with mq_port the mq broker's
        gRPC plane there (-mq -mqPort). A wire store's store_dir is its
        database's host:port."""
        url = f"127.0.0.1:{port}"
        self.killed.discard(url)
        self.start_s[url] = time.monotonic()
        self.filer_starts += 1
        self.filer_start_of[url] = self.filer_starts
        self.filers[url] = self._spawn(
            f"filer_{port}_{self.filer_starts}", [
                sys.executable, "-m", "seaweedfs_tpu_torch.cli", "filer",
                "-port", str(port), "-master", master, "-store", store,
                "-dir", store_dir, *(["-grpc"] if grpc else []),
                *(["-mq", "-mqPort", str(mq_port)] if mq_port else [])])
        return url

    def start_dbs(self) -> dict[str, int]:
        """The stores route's databases, one process through db_child;
        returns {family: port} once it has written them."""
        path = os.path.join(self.root, "db_ports.json")
        self.start_s["db"] = time.monotonic()
        self.dbs["db"] = self._spawn("db", [
            sys.executable, os.path.abspath(__file__), "db-child", path])

        def ports():
            self.check_running()
            try:
                with open(path) as f:
                    return json.load(f)
            except (OSError, ValueError):
                return None
        return _wait_for(ports, "the databases to start", timeout=180.0)

    def start_gateway(self, master: str, filer: str, port: int) -> str:
        """`weed s3 -filer filer -master master` on `port`: the S3 gateway
        as a process of its own over the filer (filer/remote_store.py),
        its chunks read and written on the volume servers."""
        url = f"127.0.0.1:{port}"
        self.killed.discard(url)
        self.start_s[url] = time.monotonic()
        self.gateways[url] = self._spawn(f"s3_{port}", [
            sys.executable, "-m", "seaweedfs_tpu_torch.cli", "s3",
            "-port", str(port), "-filer", filer, "-master", master])
        return url

    def start_follower(self, port: int, masters: str, grpc: str) -> str:
        """`weed master.follower -masters masters -grpcAddresses grpc` on
        `port`."""
        url = f"127.0.0.1:{port}"
        self.start_s[url] = time.monotonic()
        self.followers[url] = self._spawn(f"follower_{port}", [
            sys.executable, "-m", "seaweedfs_tpu_torch.cli",
            "master.follower", "-port", str(port), "-masters", masters,
            "-grpcAddresses", grpc])
        return url

    def start_servers(self, masters: list[str],
                      grpc: bool = False) -> list[str]:
        ports = _free_ports(CLI_SERVERS, grpc=grpc)
        urls = []
        for i, port in enumerate(ports):
            url = f"127.0.0.1:{port}"
            urls.append(url)
            self.rack[url] = f"r{i % 2}"
            self.resets[url] = 0
            self.start_s[url] = time.monotonic()
            self.servers[url] = self._spawn(f"volume_{port}", [
                sys.executable, os.path.abspath(__file__), "volume-child",
                self.counts_path(url), "volume", "-port", str(port),
                "-dir", os.path.join(self.root, f"v{port}"),
                "-mserver", ",".join(masters), "-rack", self.rack[url],
                "-dataCenter", "dc1", *(["-grpc"] if grpc else [])])
        return urls

    def counts_path(self, url: str) -> str:
        return os.path.join(self.root,
                            f"counts_{url.rsplit(':', 1)[1]}.json")

    def vdir(self, url: str) -> str:
        return os.path.join(self.root, f"v{url.rsplit(':', 1)[1]}")

    def live_servers(self) -> list[str]:
        return [u for u in self.servers if u not in self.killed]

    def check_running(self) -> None:
        for url, p in {**self.masters, **self.servers, **self.filers,
                       **self.gateways, **self.followers,
                       **self.dbs, **self.daemons}.items():
            if url not in self.killed and p.poll() is not None:
                with open(p.log_path, errors="replace") as f:
                    tail = f.read()[-1500:]
                raise AssertionError(f"{url} exited {p.returncode}; its "
                                     f"log ends: {tail}")

    def wait_up(self, urls: list[str], path: str) -> dict[str, float]:
        """Wait for each process to answer `path`; returns its start-up
        seconds (spawn to first answer: the interpreter, torch and the
        package imported, the card opened, the socket bound)."""
        from seaweedfs_tpu_torch.utils.httpd import http_call
        took = {}
        for url in urls:
            def up():
                self.check_running()
                try:
                    return http_call("GET", f"http://{url}{path}",
                                     timeout=2)[0] == 200
                except (ConnectionError, OSError):
                    return False
            _wait_for(up, f"{url} to answer {path}", timeout=180.0)
            took[url] = time.monotonic() - self.start_s[url]
        return took

    def leader(self) -> str:
        """The one master that every live master names as leader and that
        says it leads."""
        from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json

        def agreed():
            self.check_running()
            seen = set()
            for url in self.masters:
                if url in self.killed:
                    continue
                try:
                    st = http_json("GET", f"http://{url}/cluster/status",
                                   timeout=2)
                except (ConnectionError, OSError, HttpError):
                    return None
                seen.add((st.get("Leader"), st.get("IsLeader")
                          and st.get("Leader") == url))
            leaders = {ld for ld, _ in seen}
            if len(leaders) == 1 and any(me for _, me in seen):
                return leaders.pop()
            return None

        return _wait_for(agreed, "one Raft leader", timeout=60.0)

    def registered(self, leader: str) -> set[str]:
        from seaweedfs_tpu_torch.utils.httpd import http_json
        topo = http_json("GET", f"http://{leader}/dir/status",
                         timeout=5)["Topology"]
        return {n["id"] for dc in topo["data_centers"]
                for r in dc["racks"] for n in r["nodes"]}

    def reset_counts(self) -> None:
        """Every live server's launch counts set to 0 (SIGUSR1), and
        wait until each has reported it."""
        for url in self.live_servers():
            self.resets[url] += 1
            self.servers[url].send_signal(signal.SIGUSR1)
        for url in self.live_servers():
            _wait_for(lambda: self.counts(url).get("resets") ==
                      self.resets[url], f"{url} to reset its counts")

    def counts(self, url: str) -> dict:
        try:
            with open(self.counts_path(url)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def recovered(self, url: str, vid: int, collection: str = "") -> int:
        from seaweedfs_tpu_torch.utils.httpd import http_json
        st = http_json("GET", f"http://{url}/admin/ec/shard_stat"
                              f"?volumeId={vid}&collection={collection}",
                       timeout=30)
        return sum(st["recover_stats"].values())

    def launched(self, step: str, expect: dict[str, int],
                 counts: PathCounts, phase: str, name: dict) -> dict:
        """Each live server's K1 launches in the step, exactly `expect`
        (url -> launches; 0 where absent), and no other kernel entry; the
        total joins `phase`'s count. Keyed by the server's index in
        `name`."""
        got = {u: self.counts(u) for u in self.live_servers()}
        per = {name[u]: c.get("gf_apply") for u, c in got.items()}
        want = {name[u]: expect.get(u, 0) for u in got}
        others = {name[u]: (c.get("mxu_apply"), c.get("gf_apply_batch"))
                  for u, c in got.items()}
        if per != want or any(any(o) for o in others.values()):
            raise AssertionError(f"{phase} {step}: K1 launches {per}, "
                                 f"expected {want}; other entries {others}")
        n = sum(want.values())
        if n:
            counts.add(phase, "gf_apply", n, {
                "gf_apply": n, "mxu_apply": 0, "gf_apply_batch": 0})
        return per

    def kill(self, url: str) -> None:
        procs = next(g for g in (self.servers, self.filers, self.masters,
                                 self.gateways, self.followers) if url in g)
        procs[url].kill()
        procs[url].wait(timeout=60)
        self.killed.add(url)

    def stop(self) -> dict[str, int]:
        """SIGINT the daemons, then SIGTERM the gateways, the filers,
        their databases, the volume servers, then the masters (a server's
        drain announcement needs a master); kill what outlives 60 s.
        Returns each process's exit code."""
        codes = {}
        for group in (self.daemons, self.followers, self.gateways,
                      self.filers, self.dbs, self.servers, self.masters):
            for p in group.values():
                if p.poll() is None:
                    # a daemon stops cleanly on SIGINT (stop_daemon)
                    p.send_signal(signal.SIGINT if group is self.daemons
                                  else signal.SIGTERM)
            for url, p in group.items():
                try:
                    codes[url] = p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    codes[url] = p.wait(timeout=60)
                    codes[url] = f"killed after SIGTERM ({codes[url]})"
        return codes


def _repl_outputs(out: str) -> list:
    """The JSON each command printed in a piped `weed shell` run (the
    text after each "> " prompt); any `error:` line fails the phase (the
    REPL prints it and carries on)."""
    chunks = out.split("> ")[1:]
    for chunk in chunks:
        if chunk.lstrip().startswith("error:"):
            raise AssertionError(f"weed shell: {chunk.strip()[:2000]}")
    return [json.loads(c) for c in chunks if c.strip()]


def _live_index(idx_path: str) -> dict:
    """{key: (offset, size)} of the live entries of a .idx, replayed in
    order (a tombstone removes its key)."""
    from seaweedfs_tpu_torch.storage import idx as idxmod
    from seaweedfs_tpu_torch.storage import types as t
    live = {}
    for key, off, size in idxmod.iter_index(idx_path):
        if off != 0 and t.size_is_valid(size):
            live[key] = (off, size)
        else:
            live.pop(key, None)
    return live


def grpc_steps(cl: "_CliCluster", root: str, leader: str,
               masters: list[str], mc, vid: int, vid2: int, key2: int,
               after: tuple, rng, launched, steps: dict,
               pair_mb: int) -> None:
    """The `cli` phase's gRPC-only routes, on the volume `vid2` that one
    `weed upload` made after the failover (`after` is its needle) and on
    the EC volume `vid`:
      - `weed backup` of vid2 (a full copy over HTTP), one more needle
        POSTed to vid2, `weed backup` again: an incremental catch-up over
        the VolumeTailSender stream, no HTTP copy;
      - VolumeEcShardsGenerate of vid2 issued from this process through
        the port's GrpcVolumeClient (K1 on vid2's server, one launch per
        batch; the shards sha256-equal to CpuCoderMT's), then
        VolumeEcShardsDelete of them;
      - two volumes of `pair_mb` MiB of seeded needles allocated on that
        server and generated at once, two VolumeEcShardsGenerate calls
        from two threads through one GrpcVolumeClient (K1 launches = the
        batches of both; each volume's shards sha256-equal to
        CpuCoderMT's), then their shards and volumes deleted;
      - `weed master.follower -grpcAddresses` over the three masters' gRPC
        planes, its -masters an address where nothing listens: it answers
        /dir/lookup of vid2 and vid from the vidMap the leader's
        KeepConnected stream pushed, as the leader does."""
    from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoderMT
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.server.volume_grpc import GrpcVolumeClient
    from seaweedfs_tpu_torch.storage.erasure_coding import layout
    from seaweedfs_tpu_torch.storage.volume import Volume
    from seaweedfs_tpu_torch.utils.httpd import http_call
    total = layout.TOTAL_SHARDS_COUNT
    mc.invalidate(vid2)
    (holder,) = [loc["url"] for loc in mc.lookup_volume(vid2)]
    bak = os.path.join(root, "backup")
    argv = ("backup", "-master", leader, "-volumeId", str(vid2),
            "-output", bak)

    # weed backup twice: a full copy, then the tail since it
    cl.reset_counts()
    out, wall_full, full = cl.cli_counted(*argv)
    if full["http"].get("GET /admin/volume_file") != 2 or full["grpc"]:
        raise AssertionError(f"first weed backup: {full}")
    size_full = os.path.getsize(os.path.join(bak, f"{vid2}.dat"))
    data = rng.bytes(50_000)
    key3 = key2 + 1
    status, body, _ = http_call(
        "POST", f"http://{holder}/{vid2},{key3:x}{0x5eed:08x}", body=data)
    if status >= 300:
        raise AssertionError(f"POST to volume {vid2}: {status} {body[:200]}")
    out, wall_inc, inc = cl.cli_counted(*argv)
    if inc["http"].get("GET /admin/volume_file") or \
            inc["grpc"].get("VolumeTailSender") != 1:
        raise AssertionError(f"second weed backup took no tail: {inc}")
    grown = os.path.getsize(os.path.join(bak, f"{vid2}.dat")) > size_full
    v = Volume(bak, "", vid2)
    try:
        if not grown or bytes(v.read_needle(key3).data) != data or \
                bytes(v.read_needle(key2).data) != after[1]:
            raise AssertionError("the incremental backup lacks a needle")
    finally:
        v.close()
    launched("backup", {})
    steps["backup"] = {"full_s": wall_full, "incremental_s": wall_inc,
                       "full_routes": full, "incremental_routes": inc}

    # VolumeEcShardsGenerate from this process, over gRPC
    base = os.path.join(cl.vdir(holder), str(vid2))
    gaddr = f"127.0.0.1:{int(holder.rsplit(':', 1)[1]) + GRPC_OFFSET}"
    cl.reset_counts()
    client = GrpcVolumeClient(gaddr)
    try:
        t0 = time.monotonic()
        client._unary("VolumeEcShardsGenerate",
                      vpb.VolumeEcShardsGenerateRequest(volume_id=vid2),
                      vpb.VolumeEcShardsGenerateResponse)
        wall = time.monotonic() - t0
        dat_size = os.path.getsize(base + ".dat")
        batches = _encode_batches(dat_size, layout.DATA_SHARDS_COUNT)
        per = launched("grpc_generate", {holder: batches})
        sha = [sha256_file(base + layout.shard_ext(i)) for i in range(total)]
        if sha != cpu_shard_sha(base, dat_size, CpuCoderMT()):
            raise AssertionError("gRPC-generated shards differ from "
                                 "CpuCoderMT's")
        client._unary("VolumeEcShardsDelete",
                      vpb.VolumeEcShardsDeleteRequest(
                          volume_id=vid2, shard_ids=list(range(total))),
                      vpb.VolumeEcShardsDeleteResponse)
    finally:
        client.close()
    if any(os.path.exists(base + layout.shard_ext(i)) for i in range(total)):
        raise AssertionError("VolumeEcShardsDelete left shard files")
    steps["grpc_generate"] = _step(dat_size, wall, batches=batches,
                                   launches=per,
                                   shards_sha256_equal_to_cpu=total)

    # two VolumeEcShardsGenerate at once on that server: each call's
    # pipelined encode builds its own device lane (side stream, pinned
    # buffers) on the server's one coder
    pair = [vid2 + 100, vid2 + 101]
    for v in pair:
        _upload_volume(holder, v, pair_mb, int(rng.integers(1 << 31)))
    spans: dict = {}
    cl.reset_counts()
    client = GrpcVolumeClient(gaddr)

    def generate(v: int) -> None:
        t = time.monotonic()
        client._unary("VolumeEcShardsGenerate",
                      vpb.VolumeEcShardsGenerateRequest(volume_id=v),
                      vpb.VolumeEcShardsGenerateResponse)
        spans[v] = (t, time.monotonic())

    try:
        t0 = time.monotonic()
        _run_threads([(generate, (v,), {}) for v in pair])
        wall = time.monotonic() - t0
        sizes = {v: os.path.getsize(os.path.join(cl.vdir(holder),
                                                 f"{v}.dat")) for v in pair}
        batches = sum(_encode_batches(n, layout.DATA_SHARDS_COUNT)
                      for n in sizes.values())
        per = launched("grpc_generate_pair", {holder: batches})
        for v in pair:
            b = os.path.join(cl.vdir(holder), str(v))
            if [sha256_file(b + layout.shard_ext(i)) for i in range(total)] \
                    != cpu_shard_sha(b, sizes[v], CpuCoderMT()):
                raise AssertionError(f"volume {v}'s shards, generated beside "
                                     f"another, differ from CpuCoderMT's")
            client._unary("VolumeEcShardsDelete",
                          vpb.VolumeEcShardsDeleteRequest(
                              volume_id=v, shard_ids=list(range(total))),
                          vpb.VolumeEcShardsDeleteResponse)
    finally:
        client.close()
    for v in pair:
        _vs_json(holder, "/admin/delete_volume", {"volume_id": v})
    steps["grpc_generate_pair"] = _step(
        sum(sizes.values()), wall, batches=batches, launches=per,
        call_s={v: e - t for v, (t, e) in spans.items()},
        overlap_s=min(e for _, e in spans.values()) -
        max(t for t, _ in spans.values()),
        shards_sha256_equal_to_cpu=total * len(pair))

    # master.follower fed by KeepConnected
    dead, port = _free_ports(2)
    grpc_addrs = ",".join(f"127.0.0.1:{int(m.rsplit(':', 1)[1]) + GRPC_OFFSET}"
                          for m in masters)
    follower = cl.start_follower(port, f"127.0.0.1:{dead}", grpc_addrs)
    up = cl.wait_up([follower], "/cluster/status")[follower]

    def urls(where: str, v: int) -> set:
        st, body, _ = http_call("GET", f"http://{where}/dir/lookup"
                                       f"?volumeId={v}", timeout=10)
        return {loc["url"] for loc in json.loads(body)["locations"]} \
            if st == 200 else set()

    want = {v: urls(leader, v) for v in (vid2, vid)}
    if not all(want.values()):
        raise AssertionError(f"the leader's lookups: {want}")
    t0 = time.monotonic()
    _wait_for(lambda: all(urls(follower, v) == want[v] for v in want),
              "master.follower to answer from its pushed vidMap",
              timeout=60.0)
    steps["follower"] = {"startup_s": up,
                         "answered_s": time.monotonic() - t0,
                         "lookups": {v: sorted(u) for v, u in want.items()}}
    cl.kill(follower)


def cli_phase(work: str, volume_mb: int, seed: int,
              counts: PathCounts) -> None:
    """21. The port from its command line, each server in its own process:
    three `weed master -peers` (Raft), four `weed volume` on the card
    (default coder, K1), driven by `weed benchmark`, client.operation,
    `weed fix`, `weed ec`, `weed shell` and `weed download`, through the
    loss of the server holding the most shards and a SIGKILL of the Raft
    leader."""
    import numpy as np
    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoderMT
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder, layout
    from seaweedfs_tpu_torch.utils.httpd import http_json
    total = layout.TOTAL_SHARDS_COUNT
    root = os.path.join(work, "cli")
    os.makedirs(root)
    cl = _CliCluster(root)
    steps: dict = {}
    launches: dict = {}
    contexts: dict = {}
    mc = None
    try:
        # 1. three masters with -peers, four volume servers on the card,
        # each with -grpc
        masters = cl.start_masters(1024, grpc=True)
        servers = cl.start_servers(masters, grpc=True)
        startup = cl.wait_up(masters, "/cluster/status")
        startup.update(cl.wait_up(servers, "/status"))
        t0 = time.monotonic()
        leader = cl.leader()
        _wait_for(lambda: cl.registered(leader) == set(servers),
                  "the volume servers to register with the leader",
                  timeout=60.0)
        steps["elect_and_register_s"] = time.monotonic() - t0
        name = {u: i for i, u in enumerate(servers)}

        def on_card(step: str) -> None:
            """Each live `weed volume` process holds the card: one
            compute app per process with a CUDA context (this one and
            the live servers), each server with /dev/nvidiaN open."""
            apps = _smi_apps()
            live = cl.live_servers()
            holding = {name[u]: _holds_card(cl.servers[u].pid)
                       for u in live}
            contexts[step] = {"compute_apps": apps, "servers": holding}
            if len(apps) != 1 + len(live) or not all(holding.values()):
                raise AssertionError(f"{step}: compute apps {apps}, "
                                     f"servers holding the card {holding}")

        on_card("started")

        def launched(step: str, expect: dict[str, int]) -> dict:
            return cl.launched(step, expect, counts, "cli", name)

        def over_grpc(step: str, routes: dict, rpcs: dict) -> dict:
            """The shell's volume-server calls in `step` went over gRPC:
            each RPC of `rpcs` issued (as often as its count; None: at
            least once) and no admin request sent over HTTP (the master's
            lock and unlock are HTTP in the reference too)."""
            http = {k: n for k, n in routes["http"].items()
                    if k.startswith("POST /admin/") and k not in (
                        "POST /admin/lock", "POST /admin/unlock")}
            bad = {r: routes["grpc"].get(r) for r, n in rpcs.items()
                   if (routes["grpc"].get(r) or 0) != n
                   and not (n is None and routes["grpc"].get(r))}
            if http or bad:
                raise AssertionError(f"{step}: HTTP admin calls {http}, "
                                     f"RPCs {bad} of {routes['grpc']}")
            return routes

        # 2. weed benchmark
        cl.reset_counts()
        out, wall = cl.cli("benchmark", "-master", leader, "-n", "4096",
                           "-size", "1024", "-concurrency", "16")
        bench = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        if [b["op"] for b in bench] != ["write", "read"]:
            raise AssertionError(f"weed benchmark printed {out[-2000:]}")
        launched("benchmark", {})
        steps["benchmark"] = {"seconds": wall, **{
            b["op"]: {k: b[k] for k in ("requests_per_sec",
                                        "transfer_mb_per_sec", "p50_ms",
                                        "p99_ms")} for b in bench}}

        # 3. config 1's needle mix through client.operation
        mc = MasterClient(masters)
        rng = np.random.default_rng(seed + 21)
        sizes = []
        while sum(sizes) < volume_mb << 20:
            sizes.append(int(rng.integers(1 << 10, (4 << 20) + 1)))
        blob = rng.bytes(sum(sizes))
        mv = memoryview(blob)
        files: list = []
        off = 0
        cl.reset_counts()
        t0 = time.monotonic()
        for size in sizes:
            data = bytes(mv[off:off + size])
            off += size
            files.append((operation.upload_data(mc, data).fid, data))
        wall = time.monotonic() - t0
        del blob, mv
        payload = sum(len(d) for _, d in files)
        launched("upload", {})
        vids = sorted({int(fid.split(",")[0]) for fid, _ in files})
        if len(vids) != 1:
            raise AssertionError(f"the leader grew volumes {vids}, not one")
        vid = vids[0]
        steps["upload"] = _step(payload, wall, needles=len(files))

        # 4. weed fix on a copy of the source's sealed .dat, held against
        # the server's .idx
        src = next(u for u in servers
                   if os.path.exists(os.path.join(cl.vdir(u), f"{vid}.dat")))
        http_json("POST", f"http://{src}/admin/mark_readonly",
                  {"volume_id": vid, "read_only": True})
        base = os.path.join(cl.vdir(src), str(vid))
        dat_size = os.path.getsize(base + ".dat")
        keep = os.path.join(root, "source")
        os.makedirs(keep)
        os.link(base + ".dat", os.path.join(keep, f"{vid}.dat"))
        fixdir = os.path.join(root, "fix")
        os.makedirs(fixdir)
        os.link(base + ".dat", os.path.join(fixdir, f"{vid}.dat"))
        out, wall = cl.cli("fix", os.path.join(fixdir, str(vid)))
        fixed = json.loads(out.splitlines()[-1])
        live = _live_index(base + ".idx")
        if fixed["crc_errors"] or fixed["live_entries"] != len(live) or \
                _live_index(os.path.join(fixdir, f"{vid}.idx")) != live:
            raise AssertionError(f"weed fix: {fixed}, the server's .idx has "
                                 f"{len(live)} live entries")
        steps["fix"] = _step(dat_size, wall, live_entries=len(live))

        # 5. weed ec encode over gRPC: generate on the source (K1), spread
        cl.reset_counts()
        out, wall, routes = cl.cli_counted("ec", "encode", "-master", leader,
                                           "-volumeId", str(vid))
        enc = json.loads(out)
        batches = _encode_batches(dat_size, layout.DATA_SHARDS_COUNT)
        launches["encode"] = launched("encode", {src: batches})
        over_grpc("encode", routes, {
            "VolumeMarkReadonly": None, "VolumeEcShardsGenerate": 1,
            "VolumeEcShardsCopy": None, "VolumeEcShardsMount": None,
            "VolumeEcShardsUnmount": 1, "VolumeEcShardsDelete": 1,
            "VolumeDelete": 1})
        if [r["vid"] for r in enc] != [vid] or enc[0]["source"] != src:
            raise AssertionError(f"weed ec encode printed {enc}")
        placement = {name[u]: s for u, s in enc[0]["placement"].items()}
        holders = _ec_holders(mc, vid)
        shard_sha = {}
        for sid in range(total):
            if len(holders.get(sid, [])) != 1 or \
                    sid not in placement[name[holders[sid][0]]]:
                raise AssertionError(f"shard {sid}: {holders}, {placement}")
            shard_sha[sid] = sha256_file(os.path.join(
                cl.vdir(holders[sid][0]), f"{vid}{layout.shard_ext(sid)}"))
        cpu_sha = cpu_shard_sha(os.path.join(keep, str(vid)), dat_size,
                                CpuCoderMT())
        if [shard_sha[s] for s in range(total)] != cpu_sha:
            raise AssertionError("spread shards differ from CpuCoderMT's")
        dat_sha = sha256_file(os.path.join(keep, f"{vid}.dat"))
        shutil.rmtree(keep)
        steps["encode"] = _step(dat_size, wall, batches=batches,
                                rpcs=routes["grpc"],
                                split=routes["seconds"])

        def gets(step: str, urls: list[str], threads: int) -> dict:
            """GET every needle on `threads` threads; K1 launched once per
            interval each server reconstructs."""
            before = {u: cl.recovered(u, vid) for u in cl.live_servers()}
            cl.reset_counts()
            wall, took = _cluster_gets(files, urls, threads)
            rec = {u: cl.recovered(u, vid) - before[u]
                   for u in cl.live_servers()}
            launches[step] = launched(step, rec)
            steps[step] = _step(payload, wall, reconstructs=sum(rec.values()),
                                **_ms_stats(took))
            return rec

        # 6. GETs from the spread volume, 1 and 16 client threads
        urls = sorted({u for us in holders.values() for u in us})
        for step, threads in (("get_1", 1), ("get_16", 16)):
            if sum(gets(step, urls, threads).values()):
                raise AssertionError(f"{step}: a reconstruct on a healthy "
                                     "volume")
        on_card("before_loss")

        # 7. SIGKILL the server holding the most shards
        held = {i: (len(s), 0 in s) for i, s in placement.items()}
        victim = servers[max(held, key=held.get)]
        cl.kill(victim)
        lost = sorted(placement[name[victim]])

        # 8. degraded GETs, 1 and 16 client threads
        urls = sorted(cl.live_servers())
        for step, threads in (("get_degraded_1", 1),
                              ("get_degraded_16", 16)):
            rec = gets(step, urls, threads)
            if threads == 1 and not sum(rec.values()):
                raise AssertionError(f"{step}: nothing reconstructed")

        # 9. SIGKILL the Raft leader: a new leader, the servers back
        keys = {int(fid.split(",")[1][:-8], 16) for fid, _ in files}
        old_leader = leader
        t0 = time.monotonic()
        cl.kill(old_leader)
        leader = cl.leader()
        elected = time.monotonic()
        _wait_for(lambda: cl.registered(leader) == set(cl.live_servers()),
                  "the live servers to re-register with the new leader",
                  timeout=60.0)
        steps["failover"] = {
            "old_leader": old_leader, "new_leader": leader,
            "elected_s": elected - t0,
            "servers_registered_s": time.monotonic() - t0}

        # 10. one more needle through `weed upload` (a fresh client: this
        # process's MasterClient still pools fids of the encoded volume
        # for its 10 s pool TTL): no volume id or key minted before
        data = rng.bytes(100_000)
        path = os.path.join(root, "after_failover.bin")
        with open(path, "wb") as f:
            f.write(data)
        cl.reset_counts()
        out, _ = cl.cli("upload", "-master", leader, path)
        fid = json.loads(out.splitlines()[-1])["fid"]
        launched("upload_after_failover", {})
        vid2, key2 = int(fid.split(",")[0]), int(fid.split(",")[1][:-8], 16)
        if vid2 <= vid or key2 in keys:
            raise AssertionError(f"{fid} after the failover: volume {vid} "
                                 f"and {len(keys)} keys were minted before")
        after = (fid, data)
        steps["upload_after_failover"] = {"fid": fid,
                                          "key_above_every_earlier": key2 >
                                          max(keys)}
        grpc_steps(cl, root, leader, masters, mc, vid, vid2, key2, after,
                   rng, launched, steps, volume_mb // 4)

        # 11. lock / ec.rebuild / unlock piped into weed shell, over gRPC
        cl.reset_counts()
        out, wall, routes = cl.cli_counted(
            "shell", "-master", leader, stdin="lock\nec.rebuild\nunlock\n")
        replies = _repl_outputs(out)
        plans = replies[1] if len(replies) == 3 else None
        if replies[0] != {"locked": True} or replies[-1] != {
                "locked": False} or not plans or len(plans) != 1 or \
                sorted(plans[0].get("rebuilt", [])) != lost:
            raise AssertionError(f"weed shell printed {out[-3000:]}")
        rebuilder = plans[0]["rebuilder"]
        shard_size = os.path.getsize(os.path.join(
            cl.vdir(rebuilder), f"{vid}{layout.shard_ext(lost[0])}"))
        batches = -(-shard_size // encoder.DEFAULT_BATCH_SIZE)
        launches["rebuild"] = launched("rebuild", {rebuilder: batches})
        over_grpc("rebuild", routes, {"VolumeEcShardsCopy": None,
                                      "VolumeEcShardsRebuild": 1,
                                      "VolumeEcShardsMount": 1})
        for sid in lost:
            if sha256_file(os.path.join(
                    cl.vdir(rebuilder),
                    f"{vid}{layout.shard_ext(sid)}")) != shard_sha[sid]:
                raise AssertionError(f"rebuilt shard {sid} differs")
        steps["rebuild"] = _step(shard_size * len(lost), wall,
                                 batches=batches, rebuilder=name[rebuilder],
                                 rpcs=routes["grpc"],
                                 split=routes["seconds"])

        # 12. GETs after the rebuild
        holders = _ec_holders(mc, vid)
        if sorted(s for s, us in holders.items() if us) != list(range(total)):
            raise AssertionError(f"after ec.rebuild: {holders}")
        gets("get_rebuilt", sorted({u for us in holders.values()
                                    for u in us}), 1)
        on_card("after_rebuild")

        # 13. weed ec decode, over gRPC
        cl.reset_counts()
        out, wall, routes = cl.cli_counted("ec", "decode", "-master", leader,
                                           "-volumeId", str(vid))
        dec = json.loads(out)
        launched("decode", {})
        over_grpc("decode", routes, {"VolumeEcShardsToVolume": 1})
        if sha256_file(os.path.join(cl.vdir(dec["collector"]),
                                    f"{vid}.dat")) != dat_sha:
            raise AssertionError("the decoded .dat differs from the source's")
        steps["decode"] = _step(dat_size, wall,
                                collector=name[dec["collector"]],
                                rpcs=routes["grpc"],
                                split=routes["seconds"])

        # 14. every needle read back; a sample through weed download
        def readable():
            mc.invalidate(vid)
            try:
                return mc.lookup_volume(vid)
            except Exception:
                return None

        _wait_for(readable, "the decoded volume to be looked up")
        cl.reset_counts()
        t0 = time.monotonic()
        for fid, data in files + [after]:
            if operation.read_data(mc, fid) != data:
                raise AssertionError(f"read_data {fid} after ec.decode")
        steps["read_back"] = _step(payload, time.monotonic() - t0)
        by_size = sorted(files, key=lambda f: len(f[1]))
        dl_s = []
        for fid, data in (by_size[0], by_size[len(by_size) // 2],
                          by_size[-1], after):
            path = os.path.join(root, "download.bin")
            _, wall = cl.cli("download", "-master", leader, "-output", path,
                             fid)
            dl_s.append(wall)
            with open(path, "rb") as f:
                if f.read() != data:
                    raise AssertionError(f"weed download {fid} differs")
        launched("read_back", {})
        steps["download_s"] = dl_s
    finally:
        if mc is not None:
            mc.stop()
        codes = cl.stop()
    bad = {u: c for u, c in codes.items()
           if u not in cl.killed and c != 0}
    if bad:
        raise AssertionError(f"CLI processes exited {bad}")
    emit("cli", volume_mb=volume_mb, masters=len(masters),
         servers=len(servers), racks={name[u]: cl.rack[u] for u in servers},
         needles=len(files), payload_bytes=payload, dat_bytes=dat_size,
         volume_id=vid, placement=placement, victim=name[victim], lost=lost,
         startup_s={(f"master{masters.index(u)}" if u in cl.masters
                     else f"volume{name[u]}"): s
                    for u, s in startup.items()},
         steps=steps, launches=launches, cuda_contexts=contexts,
         shards_sha256_equal_to_cpu=total, rebuilt_sha256_equal=True,
         decoded_dat_sha256_equal=True, bodies_equal=True)


FILER_SMALL = 3900            # files of 1-128 KiB
FILER_MID = 40                # one chunk of 256 KiB-4 MiB: the 302 route
FILER_LEAVES = (4, 4, 4)      # 64 directories in three levels
FILER_COLLECTION = "filer_smoke"
QUEUE_GRACE_S = 60.0          # the master repair queue's scan_grace_s
MASTER_PULSE_S = 5.0          # the master's pulse: one repair-queue scan each


def make_filer_tree(root: str, total_mb: int, seed: int) -> list:
    """A seeded tree of about `total_mb` MiB under `root`: FILER_SMALL
    files of 1-128 KiB, FILER_MID single-chunk files of 256 KiB-4 MiB
    (past the filer's 256 KiB volume-redirect size) and files of 4-16 MiB
    (multi-chunk at the filer's 4 MiB chunks) until the total is reached,
    spread over 64 directories three levels deep. Returns [(relative
    path, size, sha256 digest)] in a seeded order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(1 << 10, (128 << 10) + 1,
                                           FILER_SMALL)]
    sizes += [int(x) for x in rng.integers(256 << 10, (4 << 20) + 1,
                                            FILER_MID)]
    while sum(sizes) < total_mb << 20:
        sizes.append(int(rng.integers((4 << 20) + 1, (16 << 20) + 1)))
    a, b, c = FILER_LEAVES
    leaves = [f"a{i}/b{j}/c{k}" for i in range(a) for j in range(b)
              for k in range(c)]
    order = rng.permutation(len(sizes))
    files = []
    for n, i in enumerate(order):
        rel = f"{leaves[int(rng.integers(len(leaves)))]}/f{n:05d}.bin"
        data = rng.bytes(sizes[i])
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        files.append((rel, len(data), hashlib.sha256(data).digest()))
    return files


ROUTE_MAX_MB = 64             # the sync and mount routes' directories
MOUNT_WRITE_DIR = "/mount_rw"  # where the mount route writes (no collection)
MOUNT_WRITES = (("w1k.bin", 1 << 10), ("w300k.bin", 300 << 10),
                ("w5m.bin", 5 << 20), ("w12m.bin", 12 << 20))
MOUNT_QUOTA = 3 << 30         # mount.configure -collectionCapacity
SYNC_B_DIR = "/sync_b"        # filer.sync's B-side source directory
MQ_TOPIC = ("smoke", "events")
MQ_PARTITIONS = 4
MQ_KEYS = 16
MQ_RECORDS = 4096             # values of 1-16 KiB: about 34 MiB
ROUTE_STEPS = ("sync_backup", "mount_read", "sync_both_ways")


def route_dirs(files: list, limit: int) -> list[str]:
    """The two largest second-level directories of the tree (aI/bJ) of
    at most `limit` bytes, for the sync and mount routes; leaves
    (aI/bJ/cK) where fewer than two second-level ones are that small."""
    for depth in (2, 3):
        size: dict[str, int] = {}
        for rel, n, _ in files:
            d = "/".join(rel.split("/")[:depth])
            size[d] = size.get(d, 0) + n
        fit = sorted((n, d) for d, n in size.items() if n <= limit)
        if len(fit) >= 2:
            return [fit[-1][1], fit[-2][1]]
    raise AssertionError(f"no two tree directories of <= {limit} bytes")


def tree_dirs(files: list) -> set[str]:
    """Every directory of the tree (relative paths, the root as "")."""
    out = {""}
    for rel, _, _ in files:
        parts = rel.split("/")[:-1]
        out.update("/".join(parts[:i]) for i in range(1, len(parts) + 1))
    return out


def _settled(read, what: str, timeout: float = 30.0):
    """`read()` once two reads 0.5 s apart agree (a request a stopped
    client left in flight has been served)."""
    last = read()
    deadline = time.monotonic() + timeout
    while True:
        time.sleep(0.5)
        now = read()
        if now == last:
            return now
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} still changing after {timeout} s")
        last = now


STORES_COLLECTION = "stores"  # the stores route's collection
STORES_PREFIX = "/stores/"    # each store filer's tree lands under it
STORES_FILES = 256            # files of 1-256 KiB per family
STORES_DIRS = 4


def make_stores_tree(root: str, seed: int) -> list:
    """A seeded tree for one store family under `root`: STORES_FILES files
    of 1-256 KiB (log-uniform sizes) spread over STORES_DIRS directories,
    and one file of 8-12 MiB (three of the filer's 4 MiB chunks). Returns
    [(relative path, size, sha256 digest)]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in np.exp(rng.uniform(
        np.log(1 << 10), np.log(256 << 10), STORES_FILES))]
    sizes.append(int(rng.integers((8 << 20) + 1, (12 << 20) + 1)))
    files = []
    for n, size in enumerate(sizes):
        rel = f"d{n % STORES_DIRS}/f{n:03d}.bin"
        data = rng.bytes(size)
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        files.append((rel, size, hashlib.sha256(data).digest()))
    return files


def stores_listing(filer: str, family: str, files: list) -> int:
    """The family's tree as its filer lists it: fs.du of /stores/<family>
    and each directory's names equal to `files`. Returns the entries
    listed."""
    from seaweedfs_tpu_torch.shell.fs_commands import FsContext
    fsc = FsContext(filer)
    base = f"{STORES_PREFIX}{family}"
    du = fsc.du(base)
    if du != (len(files), sum(size for _, size, _ in files)):
        raise AssertionError(f"stores {family}: du {du}, tree "
                             f"{len(files)} files")
    listed = 0
    for d in range(STORES_DIRS):
        names = sorted(e["FullPath"].rsplit("/", 1)[1]
                       for e in fsc.ls(f"{base}/d{d}", limit=1 << 20))
        want = sorted(rel.split("/", 1)[1] for rel, _, _ in files
                      if rel.startswith(f"d{d}/"))
        if names != want:
            raise AssertionError(f"stores {family}: d{d} lists "
                                 f"{len(names)} names, the tree {len(want)}")
        listed += len(names)
    return listed


def filer_gc(cl: "_CliCluster", filer: str) -> dict:
    """The filer's chunk_gc_total by outcome (deleted, retried, abandoned),
    from its /metrics listener, whose address its start-up line names."""
    import re

    from seaweedfs_tpu_torch.utils.httpd import http_call
    port = filer.rsplit(":", 1)[1]
    with open(os.path.join(cl.root,
                           f"filer_{port}_{cl.filer_start_of[filer]}.log"),
              encoding="utf-8", errors="replace") as f:
        metrics = re.search(r"metrics=([\d.]+:\d+)", f.read()).group(1)
    status, body, _ = http_call("GET", f"http://{metrics}/metrics",
                                timeout=10)
    if status != 200:
        raise AssertionError(f"the filer's /metrics answered {status}")
    return {m.group(1): int(float(m.group(2))) for m in re.finditer(
        r'filer_chunk_gc_total\{outcome="(\w+)"\} (\S+)',
        body.decode())}


def _filer_gets(filer: str, files: list, threads: int = 1,
                prefix: str = "/data/tree/"):
    """GET every file of `files` (paths relative to `prefix`) through the
    filer, as a client that follows redirects does: a 302 is followed to
    the volume server it names. Every body is checked against its sha256.
    Returns (wall seconds, per-GET seconds, {route: files}, the paths
    redirected)."""
    import urllib.parse

    from seaweedfs_tpu_torch.utils.httpd import http_call
    took: list[float] = []
    redirected: list[str] = []
    proxied: list[str] = []

    def get(part):
        for rel, size, digest in part:
            url = f"http://{filer}{prefix}{urllib.parse.quote(rel)}"
            t0 = time.perf_counter()
            status, body, hdrs = http_call("GET", url, timeout=120,
                                           follow_redirects=False)
            if status == 302:
                status, body, _ = http_call("GET", hdrs.get("Location"),
                                            timeout=120)
                redirected.append(rel)
            else:
                proxied.append(rel)
            took.append(time.perf_counter() - t0)
            if status != 200 or len(body) != size or \
                    hashlib.sha256(body).digest() != digest:
                raise AssertionError(f"GET {rel}: {status}, {len(body)} of "
                                     f"{size} bytes")

    t0 = time.monotonic()
    if threads == 1:
        get(files)
    else:
        _run_threads([(get, (files[i::threads],), {})
                      for i in range(threads)])
    wall = time.monotonic() - t0
    return wall, took, {"proxied": len(proxied),
                        "redirected": len(redirected)}, set(redirected)


def grpc_listing(filer: str) -> dict:
    """One leaf directory of the filer phase's tree listed through the
    port's GrpcFilerClient (ListEntries on the filer's gRPC plane) and
    through the filer's HTTP listing: the same entries (name, directory
    flag, size, chunk file ids), in the same order."""
    from seaweedfs_tpu_torch.server.filer_grpc import GrpcFilerClient
    from seaweedfs_tpu_torch.shell.fs_commands import FsContext
    path = "/data/tree/a1/b2/c3"
    http = [(e["FullPath"].rsplit("/", 1)[1], e["IsDirectory"],
             e["FileSize"], [c["fid"] for c in e["chunks"]])
            for e in FsContext(filer).ls(path, limit=1 << 20)]
    port = int(filer.rsplit(":", 1)[1]) + GRPC_OFFSET
    client = GrpcFilerClient(f"127.0.0.1:{port}")
    try:
        t0 = time.monotonic()
        entries = client.list_entries(path, limit=1 << 20)
        wall = time.monotonic() - t0
    finally:
        client.close()
    grpc = [(e.name, e.is_directory, e.attributes.file_size,
             [c.file_id for c in e.chunks]) for e in entries]
    if not http or grpc != http:
        raise AssertionError(f"{path}: gRPC listing {grpc[:5]}..., HTTP "
                             f"listing {http[:5]}...")
    return {"path": path, "entries": len(grpc), "seconds": wall}


S3_BUCKET = "bkt"          # the signed route's bucket, and its collection
S3_COLD = "cold"           # the tier round trip's bucket
S3_TIER = "tier"           # the bucket the cold volumes are tiered into
S3_KEYS = ("SMOKEACCESSKEY0", "smoke/secret/KEY0")
S3_PART = 8 << 20          # the multipart objects' part size
S3_MULTIPART = 4           # multipart objects in the signed set
S3_RANGES = 64             # random Range GETs per degraded pass


def make_s3_objects(total_mb: int, seed: int, multipart: int = 0) -> list:
    """A seeded set of about `total_mb` MiB of objects: `multipart`
    objects of 2-4 S3_PART parts and a short one, then objects of 1-256
    KiB (six in ten), 256 KiB-4 MiB (three) and 4-64 MiB (one) until the
    total is reached, keyed p<i>/obj<n> and p<i>/q<j>/obj<n>. Returns
    [(key, data, sha256 digest, multipart)]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = [(int(rng.integers(2, 5)) * S3_PART
              + int(rng.integers(1, S3_PART)), True)
             for _ in range(multipart)]
    bands = ((1 << 10, 256 << 10), (256 << 10, 4 << 20),
             ((4 << 20) + 1, 64 << 20))
    budget = total_mb << 20
    n = 0
    while sum(sz for sz, _ in sizes) < budget or n < 3:
        lo, hi = bands[n % 3] if n < 3 else bands[
            int(rng.choice(3, p=[0.6, 0.3, 0.1]))]
        sizes.append((int(rng.integers(lo, hi + 1)), False))
        n += 1
    objs = []
    for i, (size, mp) in enumerate(sizes):
        p = int(rng.integers(8))
        key = (f"p{p}/obj{i:05d}" if rng.random() < 0.25
               else f"p{p}/q{int(rng.integers(4))}/obj{i:05d}")
        data = rng.bytes(size)
        objs.append((key, data, hashlib.sha256(data).digest(), mp))
    order = rng.permutation(len(objs))
    return [objs[i] for i in order]


def _s3_put(client, key: str, data: bytes, multipart: bool) -> None:
    """One object through the port's S3 client, SigV4-signed: a PUT, or
    init / S3_PART parts / complete."""
    import xml.etree.ElementTree as ET
    if not multipart:
        client.write_file(key, data)
        return
    status, body, _ = client._call("POST", key, {"uploads": ""})
    if status != 200:
        raise AssertionError(f"multipart init {key}: HTTP {status}")
    upload = ET.fromstring(body).findtext("UploadId")
    parts = []
    for i, off in enumerate(range(0, len(data), S3_PART), 1):
        status, _, headers = client._call(
            "PUT", key, {"partNumber": str(i), "uploadId": upload},
            data[off:off + S3_PART])
        if status != 200:
            raise AssertionError(f"part {i} of {key}: HTTP {status}")
        etag = {k.lower(): v for k, v in headers.items()}["etag"]
        parts.append(f"<Part><PartNumber>{i}</PartNumber><ETag>{etag}"
                     "</ETag></Part>")
    status, body, _ = client._call(
        "POST", key, {"uploadId": upload},
        ("<CompleteMultipartUpload>" + "".join(parts)
         + "</CompleteMultipartUpload>").encode())
    if status != 200:
        raise AssertionError(f"multipart complete {key}: HTTP {status} "
                             f"{body[:200]!r}")


def _s3_puts(client, objs: list, threads: int):
    """PUT `objs` on `threads` client threads; returns (wall, per-PUT
    seconds)."""
    took: list[float] = []

    def put(part):
        for key, data, _, mp in part:
            t0 = time.perf_counter()
            _s3_put(client, key, data, mp)
            took.append(time.perf_counter() - t0)

    t0 = time.monotonic()
    _run_threads([(put, (objs[i::threads],), {}) for i in range(threads)])
    return time.monotonic() - t0, took


def _s3_gets(client, objs: list, threads: int):
    """GET every object through the gateway on `threads` client threads,
    each body held against its sha256; returns (wall, per-GET seconds)."""
    took: list[float] = []

    def get(part):
        for key, data, digest, _ in part:
            t0 = time.perf_counter()
            body = client.read_file(key)
            took.append(time.perf_counter() - t0)
            if len(body) != len(data) or \
                    hashlib.sha256(body).digest() != digest:
                raise AssertionError(f"S3 GET {key}: {len(body)} of "
                                     f"{len(data)} bytes, or not equal")

    t0 = time.monotonic()
    _run_threads([(get, (objs[i::threads],), {}) for i in range(threads)])
    return time.monotonic() - t0, took


def _s3_ranges(client, objs: list, seed: int, threads: int):
    """S3_RANGES seeded Range GETs over the objects, each held against
    the slice it names; returns (bytes, wall, per-GET seconds)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    picks = []
    for i in rng.integers(len(objs), size=S3_RANGES):
        key, data, _, _ = objs[int(i)]
        off = int(rng.integers(len(data)))
        picks.append((key, data, off,
                      int(rng.integers(1, len(data) - off + 1))))
    took: list[float] = []

    def get(part):
        for key, data, off, n in part:
            t0 = time.perf_counter()
            body = client.read_file(key, off, n)
            took.append(time.perf_counter() - t0)
            if body != data[off:off + n]:
                raise AssertionError(f"S3 Range GET {key} [{off}, "
                                     f"{off + n}): not equal")

    t0 = time.monotonic()
    _run_threads([(get, (picks[i::threads],), {}) for i in range(threads)])
    return sum(p[3] for p in picks), time.monotonic() - t0, took


def _s3_presigned_get(endpoint: str, key: str, data: bytes) -> int:
    """A presigned GET of `key` (X-Amz-* query, no Authorization header)
    through the port's sigv4; returns the status after checking the
    body."""
    import urllib.parse

    from seaweedfs_tpu_torch.utils import sigv4
    from seaweedfs_tpu_torch.utils.httpd import http_call
    ak, sk = S3_KEYS
    host = endpoint.split("//", 1)[1]
    amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    path = "/" + urllib.parse.quote(f"{S3_BUCKET}/{key}", safe="/~")
    query = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256",
             "X-Amz-Credential": f"{ak}/{amz[:8]}/us-east-1/s3/"
                                 "aws4_request",
             "X-Amz-Date": amz, "X-Amz-Expires": "300",
             "X-Amz-SignedHeaders": "host"}
    query["X-Amz-Signature"] = sigv4.signature(
        sk, amz[:8], "us-east-1", "s3", amz, "GET", path, query,
        {"host": host}, ["host"], "UNSIGNED-PAYLOAD")
    status, body, _ = http_call(
        "GET", f"{endpoint}{path}?" + urllib.parse.urlencode(
            query, quote_via=urllib.parse.quote), timeout=120)
    if status != 200 or body != data:
        raise AssertionError(f"presigned GET {key}: HTTP {status}")
    return status


def _s3_list(client, prefix: str, objs: list) -> dict:
    """ListObjectsV2 of `prefix` with delimiter "/": exactly the keys
    directly under it and one common prefix per subdirectory."""
    import xml.etree.ElementTree as ET
    status, body, _ = client._call("GET", "", {
        "list-type": "2", "prefix": prefix, "delimiter": "/"})
    if status != 200:
        raise AssertionError(f"ListObjectsV2 {prefix}: HTTP {status}")
    root = ET.fromstring(body)
    keys = [c.findtext("Key") for c in root.findall("Contents")]
    prefixes = [c.findtext("Prefix") for c in
                root.findall("CommonPrefixes")]
    under = [k for k, _, _, _ in objs if k.startswith(prefix)]
    want_keys = sorted(k for k in under if "/" not in k[len(prefix):])
    want_prefixes = sorted({prefix + k[len(prefix):].split("/")[0] + "/"
                            for k in under if "/" in k[len(prefix):]})
    if keys != want_keys or prefixes != want_prefixes:
        raise AssertionError(f"ListObjectsV2 {prefix}: {len(keys)} keys, "
                             f"prefixes {prefixes}; expected "
                             f"{len(want_keys)}, {want_prefixes}")
    return {"prefix": prefix, "keys": len(keys), "common_prefixes":
            len(prefixes)}


def s3_gateway_metrics(cl: "_CliCluster", gateway: str) -> dict:
    """From the gateway process: its S3 request counts by (action,
    bucket) and its filer view's chunk_gc_total by outcome, read off the
    two metrics listeners its start-up lines name."""
    import re

    from seaweedfs_tpu_torch.utils.httpd import http_call
    with open(cl.gateways[gateway].log_path, encoding="utf-8",
              errors="replace") as f:
        log = f.read()
    out = {}
    for kind, pattern in (("s3", r"s3 gateway up at \S+ \(metrics="
                                 r"([\d.]+:\d+)\)"),
                          ("filer", r"filer server up at \S+ \(store="
                                    r"remote, metrics=([\d.]+:\d+)\)")):
        addr = re.search(pattern, log).group(1)
        status, body, _ = http_call("GET", f"http://{addr}/metrics",
                                    timeout=10)
        if status != 200:
            raise AssertionError(f"{gateway}'s {kind} /metrics: {status}")
        out[kind] = body.decode()
    requests = {(m.group(1), m.group(2)): int(float(m.group(3)))
                for m in re.finditer(
                    r's3_request_total\{action="(\w+)",bucket="([^"]*)"\} '
                    r'(\S+)', out["s3"])}
    gc = {m.group(1): int(float(m.group(2))) for m in re.finditer(
        r'filer_chunk_gc_total\{outcome="(\w+)"\} (\S+)', out["filer"])}
    return {"requests": requests, "chunk_gc": gc}


def _bucket_chunks(filer: str, bucket: str) -> int:
    """The chunks of every object of `bucket`, from the filer's listing
    (what deleting the bucket hands to the chunk GC)."""
    from seaweedfs_tpu_torch.shell.fs_commands import FsContext
    fsc = FsContext(filer)
    n = 0
    stack = [f"/buckets/{bucket}"]
    while stack:
        for e in fsc.ls(stack.pop(), limit=1 << 20):
            if e["IsDirectory"]:
                stack.append(e["FullPath"])
            else:
                n += len(e["chunks"])
    return n


def filer_phase(work: str, total_mb: int, seed: int,
                counts: PathCounts, s3_mb: int = 1024) -> None:
    """22. The filer in front of the card's volume servers, each server a
    process of its own: `weed master`, four `weed volume` on the card and
    `weed filer -store lsm`; `weed shell` fs.configure, `weed filer.copy`
    of a seeded tree, GETs through the filer (proxied and 302 routes),
    ec.encode of the collection, the server holding the most shards
    SIGKILLed, the filer SIGKILLed and restarted from its lsm directory,
    degraded GETs through it (K1 in the live servers), ec.rebuild,
    volume.fsck, fs.du, fs.ls, fs.rm -r and volume.fsck again. Beside
    the filer, `weed s3` over it: a bucket tiered to the gateway itself
    and back, `s3_mb` MiB of SigV4-signed objects in the bucket `bkt`
    encoded after the tree, degraded S3 GETs at the same SIGKILL, GETs
    after the rebuild and the bucket deleted (see s3_route). Beside them
    seven filers on the wire stores, one per family, over their databases
    in a process of their own: ingest, GETs, a restart and the collection
    `stores` encoded after the tree's encode, lost and rebuilt with the
    others, every file read back after the rebuild (stores_route,
    stores_get). While the volumes are degraded `weed filer.backup` and
    WeedFS of `weed mount` read a directory each (sync_route,
    mount_route); after the rebuild a second filer with `weed
    filer.sync`, the meta routes and the filer's mq broker
    (sync_both_ways, meta_route, mq_route)."""
    import urllib.parse

    from seaweedfs_tpu_torch.storage.erasure_coding import encoder, layout
    from seaweedfs_tpu_torch.utils.httpd import (HttpError, http_call,
                                                 http_json)
    total = layout.TOTAL_SHARDS_COUNT
    root = os.path.join(work, "filer")
    tree = os.path.join(root, "tree")
    os.makedirs(tree)
    t0 = time.monotonic()
    files = make_filer_tree(tree, total_mb, seed + 22)
    tree_s = time.monotonic() - t0
    tree_bytes = sum(size for _, size, _ in files)
    objs = make_s3_objects(s3_mb, seed + 23, multipart=S3_MULTIPART)
    cold = make_s3_objects(max(s3_mb // 4, 8), seed + 24)
    s3_bytes = sum(len(d) for _, d, _, _ in objs)
    stores_root = os.path.join(root, "stores")
    trees = {family: make_stores_tree(os.path.join(stores_root, family),
                                      seed + 25 + i)
             for i, family in enumerate(STORE_DBS)}
    cl = _CliCluster(root)
    steps: dict = {}
    s3: dict = {}
    stores: dict = {}
    stores_steps: dict = {}
    store_filers: dict[str, str] = {}
    stores_vols: dict = {}
    stores_placement: dict = {}
    stores_k1 = {"encode_batches": 0, "rebuild_batches": 0}
    launches: dict = {}
    contexts: dict = {}
    # the replication, mount and mq routes (the `replication` line)
    repl: dict = {}
    sync_dir, mount_dir = route_dirs(files, ROUTE_MAX_MB << 20)
    filer_b = ""
    route_of = {FILER_COLLECTION: "filer", S3_BUCKET: "s3",
                STORES_COLLECTION: "stores"}
    try:
        # 1. a master, four volume servers on the card, a filer on lsm
        (master,) = cl.start_masters(1024, count=1)
        servers = cl.start_servers([master])
        startup = cl.wait_up([master], "/cluster/status")
        # the filer announces itself to the master as it starts
        store_dir = os.path.join(root, "filer_store")
        # the mq broker rides the filer (-mq) from its first start on
        mq_port = _free_ports(1)[0]
        filer = cl.start_filer(master, _free_ports(1, grpc=True)[0],
                               store_dir, grpc=True, mq_port=mq_port)
        startup.update(cl.wait_up(servers, "/status"))
        startup.update(cl.wait_up([filer], "/"))
        _wait_for(lambda: cl.registered(master) == set(servers),
                  "the volume servers to register", timeout=60.0)
        _wait_for(lambda: [n["url"] for n in http_json(
            "GET", f"http://{master}/cluster/nodes?type=filer",
            timeout=10)["cluster_nodes"]] == [filer],
            "the filer to register", timeout=60.0)
        gateway = cl.start_gateway(master, filer, _free_ports(1)[0])
        startup.update(cl.wait_up([gateway], "/"))
        endpoint = f"http://{gateway}"
        name = {u: i for i, u in enumerate(servers)}

        def launched(step: str, expect: dict[str, int]) -> dict:
            return cl.launched(step, expect, counts, "filer", name)

        def s3_launched(step: str, expect: dict[str, int]) -> dict:
            """launched() of the S3 route: its K1 launches under the path
            key `s3`."""
            return cl.launched(step, expect, counts, "s3", name)

        def stores_launched(step: str, expect: dict[str, int]) -> dict:
            """launched() of the stores route, under the path key
            `stores`."""
            return cl.launched(step, expect, counts, "stores", name)

        def launched_split(step: str, by_route: dict) -> dict:
            """launched() of a step that serves both routes (route ->
            {server: launches}): each server checked against the sum,
            each route's part recorded under its own path key."""
            total: dict[str, int] = {}
            for part in by_route.values():
                for u, n in part.items():
                    total[u] = total.get(u, 0) + n
            per = cl.launched(step, total, PathCounts(), "filer", name)
            for route, part in by_route.items():
                n = sum(part.values())
                if n:
                    counts.add(route, "gf_apply", n, {
                        "gf_apply": n, "mxu_apply": 0, "gf_apply_batch": 0})
            return per

        def on_card(step: str) -> None:
            """One compute app per process with a CUDA context (this one
            and the live volume servers), each volume server with its
            /dev/nvidiaN open, the filer and the S3 gateway without."""
            apps = _smi_apps()
            live = cl.live_servers()
            holding = {name[u]: _holds_card(cl.servers[u].pid)
                       for u in live}
            filer_holds = _holds_card(cl.filers[filer].pid)
            gateway_holds = _holds_card(cl.gateways[gateway].pid)
            # the stores route's filers and their databases' process
            others = {f"filer_{family}": _holds_card(cl.filers[sf].pid)
                      for family, sf in store_filers.items()}
            others.update({u: _holds_card(p.pid)
                           for u, p in cl.dbs.items()})
            # the replication and mount routes' processes while they run
            others.update({n: _holds_card(p.pid)
                           for n, p in cl.daemons.items() if p.poll() is None})
            if filer_b:
                others["filer_b"] = _holds_card(cl.filers[filer_b].pid)
            contexts[step] = {"compute_apps": apps, "servers": holding,
                              "filer": filer_holds,
                              "s3_gateway": gateway_holds,
                              "stores": others}
            if len(apps) != 1 + len(live) or not all(holding.values()) \
                    or filer_holds or gateway_holds or any(others.values()):
                raise AssertionError(f"{step}: compute apps {apps}, "
                                     f"servers holding the card {holding}, "
                                     f"the filer {filer_holds}, the S3 "
                                     f"gateway {gateway_holds}, the stores "
                                     f"route {others}")

        def shell(*lines: str):
            out, wall, routes = cl.cli_counted(
                "shell", "-master", master,
                stdin="".join(ln + "\n" for ln in lines))
            shell.routes = routes
            return _repl_outputs(out), wall

        def vol_stats(collection: str = FILER_COLLECTION) -> dict:
            """{vid: (server, .dat bytes)} of the collection's volumes."""
            topo = http_json("GET", f"http://{master}/dir/status",
                             timeout=10)["Topology"]
            out = {}
            for dc in topo["data_centers"]:
                for r in dc["racks"]:
                    for n in r["nodes"]:
                        for v in n["volumes"]:
                            if v.get("collection") == collection:
                                out[v["id"]] = (n["id"], os.path.getsize(
                                    os.path.join(cl.vdir(n["id"]),
                                                 f"{collection}_"
                                                 f"{v['id']}.dat")))
            return out

        def all_vids() -> set[int]:
            """Every plain volume the master lists."""
            topo = http_json("GET", f"http://{master}/dir/status",
                             timeout=10)["Topology"]
            return {v["id"] for dc in topo["data_centers"]
                    for r in dc["racks"] for n in r["nodes"]
                    for v in n["volumes"]}

        def repair_status() -> dict:
            return http_json("GET", f"http://{master}/ec/repair/status",
                             timeout=10)

        def queue_busy() -> list:
            st = repair_status()
            return [t["volume_id"] for t in st["queue"] + st["in_flight"]]

        def no_queue_fallback(step: str, since: dict) -> dict:
            """The master's repair queue rebuilds a volume by itself once
            it has stayed degraded for its grace (60 s), so from the drop
            on it may act in any step. Its partial chain folds the GF
            partial products on the host and adds no K1 launch to a
            step's count; a fallback to copy + rebuild (K1 on its
            rebuilder) would, and fails the step here by name."""
            now = repair_status()
            if now["partial_fallbacks"] != since["partial_fallbacks"]:
                raise AssertionError(f"{step}: the repair queue fell back "
                                     f"to copy + rebuild: {now}")
            return now

        def ec_shards() -> dict:
            """{vid: {server: [shard ids]}} as the master has them."""
            topo = http_json("GET", f"http://{master}/dir/status",
                             timeout=10)["Topology"]
            out: dict = {}
            for dc in topo["data_centers"]:
                for r in dc["racks"]:
                    for n in r["nodes"]:
                        for e in n.get("ec_shards", []):
                            ids = [i for i in range(total)
                                   if e["ec_index_bits"] >> i & 1]
                            if ids:
                                out.setdefault(e["id"], {})[n["id"]] = ids
            return out

        from seaweedfs_tpu_torch.remote_storage.s3_client import S3Remote
        signed = S3Remote(endpoint, S3_BUCKET, access_key=S3_KEYS[0],
                          secret_key=S3_KEYS[1])

        def s3_gc_settled(before: dict, chunks: int) -> dict:
            """The gateway's filer view deleted `chunks` chunks since
            `before` (its chunk_gc_total), none abandoned."""
            def settled():
                g = s3_gateway_metrics(cl, gateway)["chunk_gc"]
                got = {k: g.get(k, 0) - before.get(k, 0)
                       for k in ("deleted", "retried", "abandoned")}
                return got if got["deleted"] + got["abandoned"] >= chunks \
                    else None
            got = _wait_for(settled, "the gateway's chunk GC to account "
                                     "for every chunk", timeout=120.0)
            if got["abandoned"] or got["deleted"] != chunks:
                raise AssertionError(f"S3 chunk GC {got}, {chunks} chunks")
            return got

        def s3_tier_round_trip() -> None:
            """The cloud tier, unsigned as the backend is, so before any
            identity exists: the bucket `cold` written through the
            gateway into volumes of its own, each marked read-only and
            tiered with `volume.tier.upload` to the gateway's bucket
            `tier`; every cold object read back through the gateway (the
            tiered volumes' reads go gateway -> filer -> volume server ->
            S3BackendFile -> the gateway again -> the other servers);
            `volume.tier.download`, the .dat back sha256-equal, every
            object read again; both buckets deleted through S3."""
            from seaweedfs_tpu_torch.remote_storage.s3_client import \
                S3Remote as Client
            cl.reset_counts()
            for b in (S3_COLD, S3_TIER):
                status = http_call("PUT", f"{endpoint}/{b}")[0]
                if status != 200:
                    raise AssertionError(f"PUT bucket {b}: HTTP {status}")
            anon = Client(endpoint, S3_COLD)
            cold_bytes = sum(len(d) for _, d, _, _ in cold)
            wall, took = _s3_puts(anon, cold, 8)
            s3["cold_put_8"] = _step(cold_bytes, wall, objects=len(cold),
                                     **_ms_stats(took))
            tiered = {v: st for v, st in vol_stats(S3_COLD).items()
                      if st[1] > 8}
            if not tiered:
                raise AssertionError("the cold bucket filled no volume")
            dats = {v: sha256_file(os.path.join(
                cl.vdir(u), f"{S3_COLD}_{v}.dat"))
                for v, (u, _) in tiered.items()}
            lines = []
            for v, (u, _) in sorted(tiered.items()):
                lines += [f"volume.mark -volumeId {v} -node {u}",
                          f"volume.tier.upload -volumeId {v} -endpoint "
                          f"{endpoint} -bucket {S3_TIER}"]
            replies, wall = shell(*lines)
            for (v, (u, _)), up in zip(sorted(tiered.items()),
                                       replies[1::2]):
                base = os.path.join(cl.vdir(u), f"{S3_COLD}_{v}")
                vif = json.load(open(base + ".vif"))
                if os.path.exists(base + ".dat") or \
                        up[u].get("tiered") != v or \
                        vif["remote"]["bucket"] != S3_TIER:
                    raise AssertionError(f"volume.tier.upload {v}: {up}, "
                                         f"{vif}")
            tier_bytes = sum(d for _, d in tiered.values())
            s3["tier_upload"] = _step(tier_bytes, wall,
                                      volumes=len(tiered))
            before = s3_gateway_metrics(cl, gateway)["requests"]
            wall, took = _s3_gets(anon, cold, 1)
            after = s3_gateway_metrics(cl, gateway)["requests"]
            ranged = after.get(("Read", S3_TIER), 0) - before.get(
                ("Read", S3_TIER), 0)
            if not ranged:
                raise AssertionError("no read reached the tier bucket")
            s3["cold_get_tiered_1"] = _step(cold_bytes, wall,
                                            tier_reads=ranged,
                                            **_ms_stats(took))
            admin = {name[u]: http_json("GET", f"http://{u}/admin/tier",
                                        timeout=30)
                     for u in {u for u, _ in tiered.values()}}
            s3["tier_status"] = {i: {"rungs": a.get("rungs"),
                                     "stats": a.get("stats")}
                                 for i, a in admin.items()}
            replies, wall = shell(*[f"volume.tier.download -volumeId {v}"
                                    for v in sorted(tiered)])
            for v, (u, _) in tiered.items():
                got = sha256_file(os.path.join(cl.vdir(u),
                                               f"{S3_COLD}_{v}.dat"))
                if got != dats[v]:
                    raise AssertionError(f"volume {v}: the downloaded .dat "
                                         "differs from the tiered one")
            s3["tier_download"] = _step(tier_bytes, wall)
            wall, took = _s3_gets(anon, cold, 1)
            s3["cold_get_local_1"] = _step(cold_bytes, wall,
                                           **_ms_stats(took))
            s3_launched("s3_tier", {})
            gc0 = s3_gateway_metrics(cl, gateway)["chunk_gc"]
            chunks = sum(_bucket_chunks(filer, b)
                         for b in (S3_COLD, S3_TIER))
            for b in (S3_COLD, S3_TIER):
                status = http_call("DELETE", f"{endpoint}/{b}")[0]
                if status != 204:
                    raise AssertionError(f"DELETE bucket {b}: {status}")
            s3["cold_deleted"] = {"chunks": chunks,
                                  "chunk_gc": s3_gc_settled(gc0, chunks)}

        def s3_signed() -> None:
            """`s3.configure` through the REPL, then SigV4-signed PUTs of
            the bucket `bkt` on 1 and 16 threads (four multipart
            objects), GETs on 1 and 16 threads, ListObjectsV2 by prefix
            and delimiter, a presigned GET; unsigned requests refused."""
            cl.reset_counts()
            (conf,), wall = shell(f"s3.configure -user smoke -access "
                                  f"{S3_KEYS[0]} -secret {S3_KEYS[1]} "
                                  f"-actions Admin")
            if conf != {"identities": ["smoke"]}:
                raise AssertionError(f"s3.configure: {conf}")
            s3["configure_s"] = wall
            # the gateway's filer view sees the identity file once the
            # filer's change log reaches it (its meta aggregator): from
            # then on an unsigned request is refused
            t0 = time.monotonic()
            _wait_for(lambda: http_call("GET", f"{endpoint}/")[0] == 403,
                      "the gateway to refuse unsigned requests",
                      timeout=60.0)
            s3["identity_visible_s"] = time.monotonic() - t0
            status = signed._call("PUT", "")[0]
            if status != 200:
                raise AssertionError(f"PUT bucket {S3_BUCKET}: {status}")
            # half the objects on each PUT pass, multipart ones too
            halves = [[o for o in objs if o[3]][i::2]
                      + [o for o in objs if not o[3]][i::2]
                      for i in (0, 1)]
            for step, part, threads in (("put_1", halves[0], 1),
                                        ("put_16", halves[1], 16)):
                wall, took = _s3_puts(signed, part, threads)
                s3[step] = _step(sum(len(d) for _, d, _, _ in part), wall,
                                 objects=len(part),
                                 multipart=sum(m for *_, m in part),
                                 **_ms_stats(took))
            for step, threads in (("get_1", 1), ("get_16", 16)):
                wall, took = _s3_gets(signed, objs, threads)
                s3[step] = _step(s3_bytes, wall, **_ms_stats(took))
            key = next(k for k, *_ in objs if k.count("/") == 2)
            s3["list_v2"] = [_s3_list(signed, p, objs) for p in (
                key.split("/")[0] + "/", key.rsplit("/", 1)[0] + "/")]
            key, data, _, _ = objs[0]
            s3["presigned_get"] = _s3_presigned_get(endpoint, key, data)
            s3_launched("s3_signed", {})

        def s3_degraded(step: str, threads: int) -> int:
            """Every object of `bkt` and S3_RANGES Range GETs through the
            gateway with a server lost; K1 launches = the live servers'
            reconstructs."""
            before = {u: recovered_all(u) for u in cl.live_servers()}
            cl.reset_counts()
            wall, took = _s3_gets(signed, objs, threads)
            nbytes, rwall, rtook = _s3_ranges(signed, objs, seed + threads,
                                              threads)
            rec = {u: recovered_all(u) - before[u]
                   for u in cl.live_servers()}
            launches[f"s3_{step}"] = s3_launched(f"s3_{step}", rec)
            s3[step] = _step(s3_bytes, wall, objects=len(objs),
                             reconstructs=sum(rec.values()),
                             k1_per_object=sum(rec.values()) / len(objs),
                             ranges=_step(nbytes, rwall, **_ms_stats(rtook)),
                             **_ms_stats(took))
            return sum(rec.values())

        def no_tier_move(step: str, vids) -> None:
            """Fail the step where the master's tiering autopilot moved one
            of `vids`: it moves a volume older than 120 s by itself once
            `ec.encode` seals it, and would generate its shards a second
            time (or decode them)."""
            moved = [m for m in http_json(
                "GET", f"http://{master}/cluster/tiering",
                timeout=10)["dispatched"] if m["vid"] in vids]
            if moved:
                raise AssertionError(f"{step}: the tiering autopilot moved "
                                     f"{moved}")

        def encode_collection(step: str, collection: str, route: str,
                              record: dict, key: str):
            """`lock` / `ec.encode -collection <collection>` / `unlock`:
            every volume of the collection encoded on its source, K1 one
            launch per batch there (under the path key `route`), none of
            them moved by the tiering autopilot, every shard registered
            once; the step goes into record[key]. Returns ({vid: (source,
            .dat bytes)}, the shell's encode replies)."""
            cl.reset_counts()
            cvols = vol_stats(collection)
            replies, wall = shell("lock", f"ec.encode -collection "
                                          f"{collection}", "unlock")
            enc = replies[1]
            if sorted(r["vid"] for r in enc) != sorted(cvols):
                raise AssertionError(f"{step}: ec.encode {enc}, volumes "
                                     f"{cvols}")
            no_tier_move(step, cvols)
            expect: dict[str, int] = {}
            for r in enc:
                src, dat = cvols[r["vid"]]
                if r["source"] != src:
                    raise AssertionError(f"{step}: ec.encode source {r}")
                expect[src] = expect.get(src, 0) + _encode_batches(
                    dat, layout.DATA_SHARDS_COUNT)
            launches[step] = cl.launched(step, expect, counts, route, name)
            _wait_for(lambda: all(sum(map(len, ec_shards().get(v, {})
                                          .values())) == total
                                  for v in cvols),
                      f"every {collection} shard to register", timeout=60.0)
            record[key] = _step(sum(d for _, d in cvols.values()), wall,
                                volumes=len(cvols),
                                batches=sum(expect.values()),
                                http_admin_posts=sum(
                                    n for k, n in
                                    shell.routes["http"].items()
                                    if k.startswith("POST /admin/")),
                                split=shell.routes["seconds"])
            return cvols, enc

        def stores_get(family: str, step: str) -> None:
            """Every file of the family through its filer on one thread,
            sha256-equal, with no K1 launch."""
            files = trees[family]
            cl.reset_counts()
            wall, took, routes, _ = _filer_gets(
                store_filers[family], files, 1,
                prefix=f"{STORES_PREFIX}{family}/")
            stores_launched(f"stores_{family}_{step}", {})
            stores[family][step] = _step(stores[family]["bytes"], wall,
                                         **routes, **_ms_stats(took))
            stores[family][f"{step}_sha256_equal"] = len(files)

        def stores_route() -> None:
            """The stores route, after the tree's encode: the seven wire
            families' databases in one process (db_child); for each, `weed
            filer -store <family> -dir 127.0.0.1:<port>` against the
            phase's master, /stores/ sent to the collection `stores` on
            that filer (the request fs.configure makes), `weed filer.copy`
            of the
            family's tree, every file GET through the filer, the filer
            SIGKILLed and restarted on the same database (its time to a
            first answer), fs.du and the listing equal to the tree. Then
            `lock` / `ec.encode -collection stores` / `unlock` at once,
            while the volume is younger than the tiering autopilot's
            120 s: K1 on its source, one launch per batch, under the path
            key `stores`. The volume is lost and rebuilt with the
            others."""
            db_ports = cl.start_dbs()
            addr = {family: f"127.0.0.1:{db_ports[family]}"
                    for family in STORE_DBS}
            for family, port in zip(STORE_DBS, _free_ports(len(STORE_DBS))):
                store_filers[family] = cl.start_filer(
                    master, port, addr[family], store=family)
            up = cl.wait_up(list(store_filers.values()), "/")
            for family, sf in store_filers.items():
                files = trees[family]
                nbytes = sum(size for _, size, _ in files)
                rec = stores[family] = {"files": len(files),
                                        "bytes": nbytes,
                                        "startup_s": up[sf]}
                conf = http_json("POST", f"http://{sf}/__api/filer_conf",
                                 {"location_prefix": STORES_PREFIX,
                                  "collection": STORES_COLLECTION})
                if [r["collection"] for r in conf["locations"]] != [
                        STORES_COLLECTION]:
                    raise AssertionError(f"stores {family}: filer.conf "
                                         f"{conf}")
                cl.reset_counts()
                out, wall = cl.cli("filer.copy", "-filer", sf,
                                   os.path.join(stores_root, family),
                                   STORES_PREFIX)
                if json.loads(out.splitlines()[-1]) != {
                        "copied": len(files), "dest": STORES_PREFIX}:
                    raise AssertionError(f"stores {family}: weed "
                                         f"filer.copy printed {out[-2000:]}")
                rec["ingest"] = _step(nbytes, wall)
                stores_launched(f"stores_{family}_ingest", {})
                stores_get(family, "get_1")
                t0 = time.monotonic()
                cl.kill(sf)
                cl.start_filer(master, int(sf.rsplit(":", 1)[1]),
                               addr[family], store=family)
                rec["restart"] = {
                    "first_answer_s": cl.wait_up([sf], "/")[sf],
                    "since_kill_s": time.monotonic() - t0}
                rec["entries_listed"] = stores_listing(sf, family, files)
            cl.reset_counts()
            svols = vol_stats(STORES_COLLECTION)
            if not svols:
                raise AssertionError("the stores route filled no volume")
            replies, wall = shell("lock", f"ec.encode -collection "
                                          f"{STORES_COLLECTION}", "unlock")
            enc = replies[1]
            if sorted(r["vid"] for r in enc) != sorted(svols):
                raise AssertionError(f"stores ec.encode {enc}, volumes "
                                     f"{svols}")
            no_tier_move("stores_encode", svols)
            expect: dict[str, int] = {}
            for r in enc:
                src, dat = svols[r["vid"]]
                if r["source"] != src:
                    raise AssertionError(f"stores ec.encode source {r}")
                expect[src] = expect.get(src, 0) + _encode_batches(
                    dat, layout.DATA_SHARDS_COUNT)
            stores_k1["encode_batches"] = sum(expect.values())
            stores_steps["encode"] = _step(
                sum(d for _, d in svols.values()), wall, volumes=len(svols),
                batches=sum(expect.values()),
                launches=stores_launched("stores_encode", expect))
            _wait_for(lambda: all(sum(map(len, ec_shards().get(v, {})
                                          .values())) == total
                                  for v in svols),
                      "every stores shard to register", timeout=60.0)
            stores_vols.update(svols)
            stores_placement.update({r["vid"]: r["placement"] for r in enc})

        on_card("started")

        # 2. fs.configure: /data in the collection filer_smoke
        replies, wall = shell(f"fs.configure -locationPrefix /data "
                              f"-collection {FILER_COLLECTION}")
        if [r["collection"] for r in replies[0]["locations"]] != [
                FILER_COLLECTION]:
            raise AssertionError(f"fs.configure: {replies}")
        steps["fs_configure_s"] = wall

        # 3. weed filer.copy of the tree
        cl.reset_counts()
        out, wall = cl.cli("filer.copy", "-filer", filer, tree, "/data/")
        if json.loads(out.splitlines()[-1]) != {"copied": len(files),
                                                 "dest": "/data/"}:
            raise AssertionError(f"weed filer.copy printed {out[-2000:]}")
        launched("filer_copy", {})
        steps["filer_copy"] = _step(tree_bytes, wall, files=len(files))
        vols = vol_stats()
        (du, fsck), wall = shell("fs.du /data", "volume.fsck")
        if du != {"files": len(files), "bytes": tree_bytes} or \
                not fsck["volumes_checked"] or fsck["missing_count"] or \
                fsck["orphan_count"] or fsck["walk_errors"]:
            raise AssertionError(f"after filer.copy: du {du}, fsck {fsck}")
        steps["fsck_copied"] = {"seconds": wall, **{
            k: fsck[k] for k in ("volumes_checked", "entries_referencing",
                                 "missing_count", "orphan_count")}}

        # 4. GETs through the filer, 1 and 16 client threads
        for step, threads in (("get_1", 1), ("get_16", 16)):
            cl.reset_counts()
            wall, took, routes, redirected = _filer_gets(filer, files,
                                                         threads)
            launched(step, {})
            steps[step] = _step(tree_bytes, wall, **routes, **_ms_stats(took))
            if not routes["proxied"] or not routes["redirected"]:
                raise AssertionError(f"{step}: routes {routes}")

        # 5. lock / ec.encode -collection filer_smoke / unlock right after
        # the tree's GETs: the tiering autopilot moves a sealed volume
        # older than 120 s by itself, and the tree's filer.copy and GETs
        # take 45-80 s on the card's host
        tree_vols, tree_enc = encode_collection("encode", FILER_COLLECTION,
                                                "filer", steps, "ec_encode")

        # 5a. the S3 gateway: the cloud tier round trip, then signed
        # traffic into the bucket `bkt` (s3_tier_round_trip, s3_signed),
        # then lock / ec.encode -collection bkt / unlock
        s3_tier_round_trip()
        s3_signed()
        on_card("before_encode")
        s3_vols, s3_enc = encode_collection("s3_encode", S3_BUCKET, "s3", s3,
                                            "ec_encode")
        vols = {**tree_vols, **s3_vols}
        coll = {**{v: FILER_COLLECTION for v in tree_vols},
                **{v: S3_BUCKET for v in s3_vols}}
        placement = {r["vid"]: r["placement"] for r in tree_enc + s3_enc}

        # 5b. the stores route: seven wire-store filers, their trees copied
        # in, read, each filer restarted on its database, their volume
        # encoded; after the tree's encode (a running filer slows the
        # tree's filer.copy by following its change log, and the tree's
        # volume must reach its encode younger than 120 s) and before the
        # kill, so that its volume is lost and rebuilt with the others
        stores_route()
        on_card("stores")
        vols.update(stores_vols)
        coll.update({v: STORES_COLLECTION for v in stores_vols})
        placement.update(stores_placement)

        def recovered_all(url: str) -> int:
            """The server's reconstructs so far: its store counts them
            for all its EC volumes together, and shard_stat answers
            for a volume it holds shards of."""
            for v in vols:
                try:
                    return cl.recovered(url, v, coll[v])
                except HttpError:  # holds no shard of v
                    continue
            return 0

        def settled_recovered() -> dict[str, int]:
            """Each live server's reconstructs once they stop moving (a
            client's read-ahead may still be served after it exits)."""
            return _settled(lambda: {u: recovered_all(u)
                                     for u in cl.live_servers()},
                            "the live servers' reconstructs")

        def routes_of(name: str) -> dict:
            """A cli-child daemon's requests: HTTP by route, gRPC by
            method, seconds."""
            r = cl.daemon_report(name, f"routes_{name}") or {}
            return {"http": r.get("http", {}), "grpc": r.get("grpc", {}),
                    "seconds": r.get("seconds", {})}

        def sync_route() -> int:
            """`weed filer.backup -filer F -filerPath /data/tree/<sync_dir>
            -dir <mirror>` (cli-child) while the volumes are degraded: it
            replays F's change log (journalled across F's restart) and
            fetches each file through F, whose chunk reads make the live
            servers reconstruct. Done when every file of the directory is
            in the mirror, sha256-equal; then the process is stopped. K1
            launches = the live servers' reconstructs, under `sync`."""
            part = [f for f in files if f[0].startswith(sync_dir + "/")]
            nbytes = sum(size for _, size, _ in part)
            mirror = os.path.join(root, "backup")
            queue = repair_status()
            before = {u: recovered_all(u) for u in cl.live_servers()}
            cl.reset_counts()
            t0 = time.monotonic()
            cl.start_daemon("backup", "filer.backup", "-filer", filer,
                            "-filerPath", f"/data/tree/{sync_dir}",
                            "-dir", mirror)
            pending = {rel: (size, digest) for rel, size, digest in part}
            first = []

            def mirrored() -> bool:
                cl.check_running()
                for rel, (size, digest) in list(pending.items()):
                    path = os.path.join(mirror, "data", "tree", rel)
                    try:
                        if os.path.getsize(path) != size:
                            continue
                    except OSError:
                        continue
                    with open(path, "rb") as f:
                        if hashlib.sha256(f.read()).digest() == digest:
                            del pending[rel]
                            if not first:
                                first.append(time.monotonic() - t0)
                return not pending

            _wait_for(mirrored, "filer.backup to mirror every file",
                      timeout=240.0)
            wall = time.monotonic() - t0
            on_card("sync")
            stop_s = cl.stop_daemon("backup")
            rec = {u: n - before[u] for u, n in settled_recovered().items()}
            no_queue_fallback("sync_backup", queue)
            launches["sync_backup"] = cl.launched("sync_backup", rec, counts,
                                                  "sync", name)
            repl["sync_backup"] = _step(
                nbytes, wall, dir=f"/data/tree/{sync_dir}", files=len(part),
                first_file_s=first[0], stop_s=stop_s,
                reconstructs=sum(rec.values()), routes=routes_of("backup"))
            return sum(rec.values())

        def mount_route() -> int:
            """`mount-child`: WeedFS of `weed mount` over F (cli.open_mount,
            no kernel mount) reads every file of /data/tree/<mount_dir>
            through lookup / open / read / release while the volumes are
            degraded (its chunk reads go straight to the volume servers),
            writes, renames and reads back MOUNT_WRITES under
            MOUNT_WRITE_DIR; the REPL's mount.configure reaches its admin
            plane through the master and changes what its statfs reports;
            the written files read back through F. K1 launches = the live
            servers' reconstructs, under `mount`."""
            part = [f for f in files if f[0].startswith(mount_dir + "/")]
            nbytes = sum(size for _, size, _ in part)
            queue = repair_status()
            before = {u: recovered_all(u) for u in cl.live_servers()}
            cl.reset_counts()
            t0 = time.monotonic()
            cl.start_mount("mount", {
                "master": master, "filer": filer,
                "read_dir": f"/data/tree/{mount_dir}",
                "files": [[rel[len(mount_dir) + 1:], size, digest.hex()]
                          for rel, size, digest in part],
                "write_dir": MOUNT_WRITE_DIR,
                "writes": [list(w) for w in MOUNT_WRITES],
                "seed": seed + 26})

            def report(phase: str):
                def got():
                    rep = cl.daemon_report("mount")
                    if rep and rep.get("error"):
                        raise AssertionError(f"mount-child: {rep['error']}")
                    cl.check_running()
                    return rep if rep and rep.get("phase") == phase else None
                return got

            rep = _wait_for(report("done"), "the mount's reads and writes",
                            timeout=300.0)
            wall = time.monotonic() - t0
            on_card("mount")
            (conf,), conf_s = shell(f"mount.configure -collectionCapacity "
                                    f"{MOUNT_QUOTA}")
            admin = f"127.0.0.1:{rep['admin_port']}"
            if conf != {"mounts": {admin: MOUNT_QUOTA}}:
                raise AssertionError(f"mount.configure: {conf}, the mount's "
                                     f"admin plane {admin}")
            rep = _wait_for(report("configured"), "the mount's quota",
                            timeout=60.0)
            if rep["statfs_configured"][0] != MOUNT_QUOTA // 4096 or \
                    rep["statfs"][0] == rep["statfs_configured"][0]:
                raise AssertionError(f"statfs {rep['statfs']} -> "
                                     f"{rep['statfs_configured']}")
            stop_s = cl.stop_daemon("mount")
            rec = {u: n - before[u] for u, n in settled_recovered().items()}
            no_queue_fallback("mount_read", queue)
            launches["mount_read"] = cl.launched("mount_read", rec, counts,
                                                 "mount", name)
            # what the mount wrote, read through F by an HTTP client
            for fname, digest in rep["write"]["files"].items():
                status, body, _ = http_call(
                    "GET", f"http://{filer}{MOUNT_WRITE_DIR}/moved/{fname}",
                    timeout=120)
                if status != 200 or hashlib.sha256(body).hexdigest() != \
                        digest:
                    raise AssertionError(f"GET {MOUNT_WRITE_DIR}/moved/"
                                         f"{fname} through the filer: "
                                         f"{status}, {len(body)} bytes")
            read = rep["read"]
            repl["mount"] = {
                "read": _step(nbytes, read["seconds"],
                              dir=f"/data/tree/{mount_dir}", files=len(part),
                              reconstructs=sum(rec.values()),
                              **_ms_stats(read["per_file_s"])),
                "write": _step(rep["write"]["bytes"],
                               rep["write"]["seconds"],
                               files=len(rep["write"]["files"])),
                "wall_s": wall, "open_s": rep["open_s"], "stop_s": stop_s,
                "configure_s": conf_s, "statfs_blocks": [
                    rep["statfs"][0], rep["statfs_configured"][0]]}
            return sum(rec.values())

        def sync_both_ways() -> str:
            """On healthy volumes: a second `weed filer -store lsm` B on the
            phase's master and `weed filer.sync -a F -b B -aPrefix
            /data/tree/<sync_dir> -bPrefix SYNC_B_DIR` (cli-child). Every
            file of the directory reaches B and reads back through B
            sha256-equal; a file written on B under SYNC_B_DIR reaches F;
            then neither change log grows (no echo). No K1 launch."""
            part = [f for f in files if f[0].startswith(sync_dir + "/")]
            nbytes = sum(size for _, size, _ in part)
            fb = cl.start_filer(master, _free_ports(1)[0],
                                os.path.join(root, "filer_b_store"))
            up = cl.wait_up([fb], "/")[fb]
            cl.reset_counts()
            since = time.time_ns()
            t0 = time.monotonic()
            cl.start_daemon("sync", "filer.sync", "-a", filer, "-b", fb,
                            "-aPrefix", f"/data/tree/{sync_dir}",
                            "-bPrefix", SYNC_B_DIR)
            pending = {rel for rel, _, _ in part}

            def arrived() -> bool:
                cl.check_running()
                for rel in list(pending):
                    q = urllib.parse.quote(f"/data/tree/{rel}", safe="")
                    if http_call("GET", f"http://{fb}/__api/entry?path={q}",
                                 timeout=30)[0] == 200:
                        pending.discard(rel)
                return not pending

            _wait_for(arrived, "filer.sync to copy the directory to B",
                      timeout=240.0)
            a_to_b = time.monotonic() - t0
            wall, took, routes, _ = _filer_gets(fb, part, 1)
            import numpy as np
            data = np.random.default_rng(seed + 28).bytes(1 << 20)
            t0 = time.monotonic()
            status = http_call("POST", f"http://{fb}{SYNC_B_DIR}/from_b.bin",
                               body=data, timeout=60)[0]
            if status >= 300:
                raise AssertionError(f"POST to B: HTTP {status}")

            def reached_f() -> bool:
                cl.check_running()
                st, body, _ = http_call(
                    "GET", f"http://{filer}{SYNC_B_DIR}/from_b.bin",
                    timeout=60)
                return st == 200 and body == data

            _wait_for(reached_f, "B's file to reach F", timeout=60.0)
            b_to_a = time.monotonic() - t0

            def logged() -> tuple[int, int]:
                return tuple(len(http_json(
                    "GET", f"http://{u}/__api/meta_events?since_ns={since}",
                    timeout=30)["events"]) for u in (filer, fb))
            # one sync pass each way is a 2 s long poll: two of them
            # without a new event on either side show there is no echo
            settled = logged()
            time.sleep(4.5)
            if logged() != settled:
                raise AssertionError(f"filer.sync echoes: events "
                                     f"{settled} -> {logged()}")
            on_card("sync_both_ways")
            stop_s = cl.stop_daemon("sync")
            launches["sync_both_ways"] = cl.launched("sync_both_ways", {},
                                                     counts, "sync", name)
            repl["sync_both_ways"] = {
                "b_startup_s": up, "a_to_b": _step(nbytes, a_to_b,
                                                   files=len(part)),
                "get_from_b_1": _step(nbytes, wall, **routes,
                                      **_ms_stats(took)),
                "b_to_a_s": b_to_a, "events_since_start": settled,
                "stop_s": stop_s, "routes": routes_of("sync")}
            return fb

        def meta_route(removed: list) -> None:
            """`weed filer.meta.tail -pathPrefix /data -n <events + 1>` and
            `weed filer.meta.backup -filerPath /data`: each reads every
            event of /data from F's change log, journalled across its
            restart: one create for each directory and file the tree made,
            one delete for each `fs.rm -r` removed, nothing else."""
            creates = len(files) + len(tree_dirs(files))
            deletes = len(removed) + len({d for d in tree_dirs(files)
                                          if d.split("/")[0] == "a0"})
            cl.reset_counts()
            out, wall, routes = cl.cli_counted(
                "filer.meta.tail", "-filer", filer, "-pathPrefix", "/data",
                "-n", str(creates + deletes + 1))
            lines = out.splitlines()

            def kinds(events: list) -> tuple[int, int]:
                return (sum(1 for e in events if e["old_entry"] is None
                            and e["new_entry"] is not None),
                        sum(1 for e in events if e["new_entry"] is None
                            and e["old_entry"] is not None))

            events = [json.loads(ln) for ln in lines[:-1]]
            if json.loads(lines[-1]) != {"events": creates + deletes} or \
                    kinds(events) != (creates, deletes):
                raise AssertionError(f"filer.meta.tail: {lines[-1]}, "
                                     f"(creates, deletes) {kinds(events)} "
                                     f"of {(creates, deletes)}")
            dump = os.path.join(root, "meta_backup.jsonl")
            out, bwall = cl.cli("filer.meta.backup", "-filer", filer,
                                "-filerPath", "/data", "-o", dump)
            with open(dump) as f:
                backed = [json.loads(ln) for ln in f]
            if json.loads(out.splitlines()[-1]) != {
                    "events": creates + deletes, "file": dump} or \
                    kinds(backed) != (creates, deletes):
                raise AssertionError(f"filer.meta.backup: {out[-500:]}, "
                                     f"(creates, deletes) {kinds(backed)}")
            launched("meta", {})
            repl["meta"] = {"creates": creates, "deletes": deletes,
                            "tail_s": wall, "tail_split": routes["seconds"],
                            "backup_s": bwall}

        def mq_route() -> None:
            """The mq broker in F (`-mq -mqPort`): MQ_RECORDS seeded records
            of 1-16 KiB on MQ_KEYS keys published through the port's
            MqClient in one stream, then each partition replayed in publish
            order (every record once, in its key's partition); its
            segments past SEGMENT_MAX_BYTES are filer files whose chunks
            are on the volume servers; `mq.topic.list` names the topic."""
            import numpy as np

            from seaweedfs_tpu_torch.mq.broker_grpc import MqClient
            rng = np.random.default_rng(seed + 27)
            recs = [(f"key{int(rng.integers(MQ_KEYS)):02d}",
                     rng.bytes(int(rng.integers(1 << 10, (16 << 10) + 1))))
                    for _ in range(MQ_RECORDS)]
            nbytes = sum(len(v) for _, v in recs)
            cl.reset_counts()
            client = MqClient(f"127.0.0.1:{mq_port}", tls=None)
            try:
                parts = client.configure_topic(*MQ_TOPIC, MQ_PARTITIONS)
                t0 = time.monotonic()
                acks = client.publish(*MQ_TOPIC, recs)
                pub = time.monotonic() - t0
                if len(acks) != len(recs) or acks != sorted(set(acks)):
                    raise AssertionError(f"mq publish: {len(acks)} acks "
                                         f"for {len(recs)} records")
                t0 = time.monotonic()
                got = {p: list(client.subscribe(*MQ_TOPIC, partition=p))
                       for p in range(parts)}
                sub = time.monotonic() - t0
            finally:
                client.close()
            part_of = {r["key"]: p for p, rs in got.items() for r in rs}
            for p, rs in got.items():
                want = [v for k, v in recs if part_of.get(k) == p]
                if [r["value"] for r in rs] != want or \
                        any(part_of[r["key"]] != p for r in rs):
                    raise AssertionError(f"mq partition {p}: {len(rs)} "
                                         f"records replayed, {len(want)} "
                                         f"published")
            if sum(map(len, got.values())) != len(recs):
                raise AssertionError("mq: records lost or repeated")
            segs = chunked = 0
            for p in range(parts):
                out = http_json("GET", f"http://{filer}/topics/"
                                f"{MQ_TOPIC[0]}/{MQ_TOPIC[1]}/p{p:02d}/",
                                timeout=30)
                for e in out.get("Entries", []):
                    segs += 1
                    chunked += bool(e.get("chunks"))
            if not chunked:
                raise AssertionError("mq: no segment reached the volume "
                                     "servers")
            (topics,), list_s = shell("mq.topic.list")
            want_topic = {"namespace": MQ_TOPIC[0], "topic": MQ_TOPIC[1],
                          "partition_count": parts}
            if want_topic not in topics["topics"]:
                raise AssertionError(f"mq.topic.list: {topics}")
            launched("mq", {})
            repl["mq"] = {"records": len(recs), "keys": MQ_KEYS,
                          "partitions": parts,
                          "publish": _step(nbytes, pub),
                          "replay": _step(nbytes, sub),
                          "segments": segs, "chunked_segments": chunked,
                          "topic_list_s": list_s}

        # 6. SIGKILL the server holding the most shards
        queue_at_drop = repair_status()
        vids_at_kill = all_vids()
        held = {u: sum(len(p.get(u, [])) for p in placement.values())
                for u in servers}
        victim = max(servers, key=lambda u: (held[u], u))
        cl.kill(victim)
        lost = {v: sorted(p.get(victim, [])) for v, p in placement.items()}
        if any(total - len(ids) < layout.DATA_SHARDS_COUNT
               for ids in lost.values()):
            raise AssertionError(f"losing {victim} leaves < k: {lost}")
        if not all(lost[v] for v in stores_vols):
            raise AssertionError(f"{victim} held no shard of the stores "
                                 f"volumes: {lost}")

        # 7. restart the filer from its lsm directory (SIGKILL first): its
        # chunk cache is cold, its namespace comes back from the store
        t0 = time.monotonic()
        cl.kill(filer)
        cl.start_filer(master, int(filer.rsplit(":", 1)[1]), store_dir,
                       grpc=True, mq_port=mq_port)
        steps["filer_restart"] = {
            "first_answer_s": cl.wait_up([filer], "/")[filer],
            "since_kill_s": time.monotonic() - t0}
        (du,), _ = shell("fs.du /data")
        if du != {"files": len(files), "bytes": tree_bytes}:
            raise AssertionError(f"after the filer restart: du {du}")
        # the S3 gateway too, so that its filer view's chunk cache is as
        # cold as the filer's; it answers 403 to an unsigned request
        t0 = time.monotonic()
        cl.kill(gateway)
        cl.start_gateway(master, filer, int(gateway.rsplit(":", 1)[1]))

        def refuses() -> bool:
            cl.check_running()
            try:
                return http_call("GET", f"{endpoint}/", timeout=2)[0] == 403
            except (ConnectionError, OSError):
                return False
        _wait_for(refuses, "the restarted S3 gateway", timeout=180.0)
        s3["gateway_restart_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        _wait_for(lambda: victim not in cl.registered(master),
                  "the master to drop the killed server", timeout=90.0)
        pruned = time.monotonic()
        steps["prune_wait_s"] = pruned - t0

        # 8. degraded GETs through the filer: 1 thread, redirected files
        # then proxied ones, then 16 threads over all; K1 launches = each
        # live server's reconstructs
        def degraded(step: str, part: list, threads: int) -> dict:
            queue = repair_status()
            before = {u: recovered_all(u) for u in cl.live_servers()}
            cl.reset_counts()
            wall, took, routes, _ = _filer_gets(filer, part, threads)
            rec = {u: recovered_all(u) - before[u]
                   for u in cl.live_servers()}
            no_queue_fallback(step, queue)
            launches[step] = launched(step, rec)
            steps[step] = _step(sum(s for _, s, _ in part), wall, **routes,
                                reconstructs=sum(rec.values()),
                                **_ms_stats(took))
            return rec

        # 8a. first the S3 route's one-thread pass (until the drop the
        # gateway may 302 a GET to the killed server, which the master
        # still lists), then the filer's, its short redirected pass
        # first: each must find the volumes still degraded, and the
        # master's repair queue rebuilds them once its 60 s grace from
        # the drop has run out
        s3_k1 = s3_degraded("get_degraded_1", 1)
        # 8a'. the sync and mount routes, each on a directory of the tree
        # of <= ROUTE_MAX_MB MiB: `weed filer.backup`, then WeedFS of
        # `weed mount` (sync_route, mount_route)
        route_k1 = sync_route() + mount_route()
        if not route_k1:
            raise AssertionError("the sync and mount routes reconstructed "
                                 "nothing")
        for step, part in (
                ("get_degraded_1_redirected",
                 [f for f in files if f[0] in redirected]),
                ("get_degraded_1_proxied",
                 [f for f in files if f[0] not in redirected])):
            if not sum(degraded(step, part, 1).values()):
                raise AssertionError(f"{step}: nothing reconstructed")
        # 8b. the 16-thread passes of both routes
        degraded("get_degraded_16", files, 16)
        s3_k1 += s3_degraded("get_degraded_16", 16)
        if not s3_k1:
            raise AssertionError("the degraded S3 GETs reconstructed "
                                 "nothing")
        on_card("degraded")

        def shell_rebuild(step: str, want: dict) -> dict:
            """`lock` / `ec.rebuild` / `unlock`: it must plan exactly the
            volumes of `want` (vid -> lost shard ids) and rebuild those
            shards, with K1 on each rebuilder, one launch per batch, and
            the rebuilt shards sha256-equal to the ones the killed server
            held."""
            cl.reset_counts()
            replies, wall = shell("lock", "ec.rebuild", "unlock")
            plans = replies[1]
            if sorted(p["vid"] for p in plans) != sorted(want) or any(
                    sorted(p.get("rebuilt", [])) != want[p["vid"]]
                    for p in plans):
                raise AssertionError(f"{step}: ec.rebuild planned {plans}, "
                                     f"expected {want}")
            expect: dict = {"filer": {}, "s3": {}, "stores": {}}
            rebuilt_bytes = 0
            for plan in plans:
                v, rb = plan["vid"], plan["rebuilder"]
                for sid in want[v]:
                    shard = f"{coll[v]}_{v}{layout.shard_ext(sid)}"
                    if sha256_file(os.path.join(cl.vdir(rb), shard)) != \
                            sha256_file(os.path.join(cl.vdir(victim),
                                                     shard)):
                        raise AssertionError(f"{step}: rebuilt {shard} on "
                                             f"{rb} differs from the lost one")
                size = os.path.getsize(os.path.join(
                    cl.vdir(rb), f"{coll[v]}_{v}"
                                 f"{layout.shard_ext(want[v][0])}"))
                rebuilt_bytes += size * len(want[v])
                part = expect[route_of[coll[v]]]
                part[rb] = part.get(rb, 0) + \
                    -(-size // encoder.DEFAULT_BATCH_SIZE)
            no_queue_fallback(step, queue_at_drop)
            stores_k1["rebuild_batches"] += sum(expect["stores"].values())
            launches[step] = launched_split(step, expect)
            _wait_for(lambda: not queue_busy() and all(
                sum(map(len, ec_shards().get(v, {}).values())) == total
                for v in vols), "the rebuilt shards to register once each",
                timeout=60.0)
            return _step(rebuilt_bytes, wall, volumes=len(plans),
                         batches={r: sum(p.values())
                                  for r, p in expect.items()},
                         rebuilders=sorted({name[p["rebuilder"]]
                                            for p in plans}))

        # 9. the rebuild, by whichever comes first: the master's repair
        # queue (its partial chain, once the volume has been degraded
        # for its grace) or `lock` / `ec.rebuild` / `unlock`, which
        # rebuilds what the queue has not
        steps["dropped_to_rebuild_s"] = time.monotonic() - pruned
        # the queue's grace runs from the master's first scan after the
        # drop (within a pulse of `pruned`): an ec.rebuild started just
        # before it runs out overlaps the queue's own rebuild, and the
        # lost shards then register twice. Not then: wait it out.
        since_drop = time.monotonic() - pruned
        if QUEUE_GRACE_S - 15.0 <= since_drop < QUEUE_GRACE_S + 10.0:
            time.sleep(QUEUE_GRACE_S + 10.0 - since_drop)
            steps["waited_out_queue_grace"] = True
        _wait_for(lambda: not queue_busy(), "the repair queue to settle",
                  timeout=300.0)
        shards_now = ec_shards()
        by_queue = sorted(v for v, ids in lost.items() if ids and sum(
            map(len, shards_now.get(v, {}).values())) == total)
        # what the queue rebuilt: on a server that now holds the lost
        # shards, by the partial chain (no K1 launch: checked step by
        # step, a copy + rebuild fails no_queue_fallback), sha256-equal
        # to the lost shards
        queued: dict = {}
        for v in by_queue:
            rb = next(u for u, ids in shards_now[v].items()
                      if set(lost[v]) <= set(ids))
            last = http_json(
                "GET", f"http://{rb}/admin/ec/shard_stat?volumeId={v}"
                       f"&collection={coll[v]}",
                timeout=30).get("last_repair", {})
            if not last.get("mode", "").startswith("partial"):
                raise AssertionError(f"the repair queue rebuilt {v} on {rb} "
                                     f"by {last}")
            for sid in lost[v]:
                shard = f"{coll[v]}_{v}{layout.shard_ext(sid)}"
                if sha256_file(os.path.join(cl.vdir(rb), shard)) != \
                        sha256_file(os.path.join(cl.vdir(victim), shard)):
                    raise AssertionError(f"the repair queue's {shard} on "
                                         f"{rb} differs from the lost one")
            queued[v] = (rb, {"rebuilder": name[rb], **last,
                              "k1_launches": 0})
        rest = {v: ids for v, ids in lost.items()
                if ids and v not in by_queue}
        if rest:
            steps["ec_rebuild"] = shell_rebuild("rebuild", rest)
        status = repair_status()
        steps["repair_queue"] = {
            "by_queue": {v: q for v, (_, q) in queued.items()}, **{
                k: status[k] - queue_at_drop[k] for k in (
                    "repaired_total", "failed_total", "partial_repairs",
                    "partial_fallbacks", "bytes_moved")}}
        if queued:
            # 9b. the queue came first, so the operator's route runs on a
            # fresh loss: the shards it rebuilt unmounted and deleted from
            # their holder, and at once (well inside the queue's grace)
            # `lock` / `ec.rebuild` / `unlock` rebuilds them on the card.
            # The queue's scan forgets when a volume became degraded only
            # at a tick (one each master pulse) that sees it whole: shards
            # deleted before that tick leave the old time standing, the
            # queue resubmits at once and its rebuild overlaps the one
            # below. Two pulses after the shards registered whole, a tick
            # has seen them.
            time.sleep(2 * MASTER_PULSE_S + 1.0)
            for v, (rb, _) in queued.items():
                http_json("POST", f"http://{rb}/admin/ec/unmount",
                          {"volume_id": v, "collection": coll[v],
                           "shard_ids": lost[v]}, timeout=60)
                http_json("POST", f"http://{rb}/admin/ec/delete_shards",
                          {"volume_id": v, "collection": coll[v],
                           "shard_ids": lost[v]}, timeout=60)
            _wait_for(lambda: all(
                not set(lost[v]) & {s for ids in ec_shards().get(v, {})
                                    .values() for s in ids}
                for v in queued), "the master to drop the deleted shards",
                timeout=60.0)
            steps["ec_rebuild_after_queue"] = shell_rebuild(
                "rebuild_after_queue", {v: lost[v] for v in queued})

        # 9c. every object of `bkt` once more through the gateway
        before = {u: recovered_all(u) for u in cl.live_servers()}
        cl.reset_counts()
        wall, took = _s3_gets(signed, objs, 16)
        launches["s3_get_rebuilt_16"] = s3_launched("s3_get_rebuilt_16", {
            u: recovered_all(u) - before[u] for u in cl.live_servers()})
        s3["get_rebuilt_16"] = _step(s3_bytes, wall, **_ms_stats(took))

        # 9d. every file of the seven store families once more, each
        # through its own filer
        for family in store_filers:
            stores_get(family, "get_rebuilt_1")

        # 10. volume.fsck, fs.du, fs.ls
        cl.reset_counts()
        (fsck, du, ls), wall = shell("volume.fsck", "fs.du /data",
                                     "fs.ls /data/tree")
        top = sorted(f"/data/tree/a{i}" for i in range(FILER_LEAVES[0]))
        if fsck["missing_count"] or fsck["walk_errors"] or \
                du != {"files": len(files), "bytes": tree_bytes} or \
                sorted(e["FullPath"] for e in ls) != top:
            raise AssertionError(f"after ec.rebuild: fsck {fsck}, du {du}, "
                                 f"ls {[e['FullPath'] for e in ls]}")
        launched("fsck", {})
        steps["fsck_ec"] = {"seconds": wall, **{
            k: fsck[k] for k in ("volumes_checked", "entries_referencing",
                                 "missing_count", "orphan_count")}}
        steps["grpc_listing"] = grpc_listing(filer)

        # 11. fs.rm -r of one top directory, then volume.fsck again; the
        # removed files' chunks leave the EC volumes (a delete reads the
        # needle first: K1 where it crosses the lost shards)
        gone = [f for f in files if f[0].startswith("a0/")]
        fids = []
        for rel, _, _ in gone:
            e = http_json("GET", f"http://{filer}/__api/entry?path="
                                 f"{urllib.parse.quote('/data/tree/' + rel)}")
            fids += [c["fid"] for c in e["entry"]["chunks"]]
        before = {u: recovered_all(u) for u in cl.live_servers()}
        cl.reset_counts()
        (rm, du, fsck), wall = shell("fs.rm -r /data/tree/a0",
                                     "fs.du /data", "volume.fsck -fix")
        left = [f for f in files if not f[0].startswith("a0/")]
        removed_keys = {fid.split(",")[1][:-8].lstrip("0") for fid in fids}
        if du != {"files": len(left),
                  "bytes": sum(s for _, s, _ in left)} or \
                fsck["missing_count"] or fsck["purge_refused"] or any(
                    o["needle"] not in removed_keys
                    for o in fsck["orphans"]):
            raise AssertionError(f"after fs.rm: {rm}, du {du}, fsck {fsck}")
        holders = sorted(cl.live_servers())
        remaining = set(fids)

        def deleted():
            for fid in sorted(remaining):
                if http_call("GET", f"http://{holders[0]}/{fid}",
                             timeout=30)[0] != 404:
                    return False
                remaining.discard(fid)
            return True

        _wait_for(deleted, "the removed files' chunks to be deleted",
                  timeout=120.0)
        # the filer's chunk GC: every removed chunk deleted, none left
        # behind after its retries
        def gc_settled():
            g = filer_gc(cl, filer)
            done = g.get("deleted", 0) + g.get("abandoned", 0)
            return g if done == len(fids) else None

        gc = _wait_for(gc_settled, "the filer's chunk GC to account for "
                                   "every chunk", timeout=60.0)
        if gc.get("abandoned", 0) or gc.get("deleted") != len(fids):
            raise AssertionError(f"chunk GC {gc}, {len(fids)} chunks")
        launches["fs_rm"] = launched("fs_rm", {
            u: recovered_all(u) - before[u] for u in cl.live_servers()})
        steps["fs_rm"] = {"seconds": wall, "files": len(gone),
                          "chunks_deleted": len(fids), "chunk_gc": gc,
                          **{k: fsck[k] for k in (
                              "volumes_checked", "missing_count",
                              "orphan_count", "purged")}}

        # 12. the bucket `bkt` deleted through S3: its chunks leave the
        # EC volumes through the gateway's chunk GC, none abandoned
        gc0 = s3_gateway_metrics(cl, gateway)["chunk_gc"]
        chunks = _bucket_chunks(filer, S3_BUCKET)
        before = {u: recovered_all(u) for u in cl.live_servers()}
        cl.reset_counts()
        t0 = time.monotonic()
        status = signed._call("DELETE", "")[0]
        if status != 204:
            raise AssertionError(f"DELETE bucket {S3_BUCKET}: {status}")
        s3["bucket_deleted"] = {"chunks": chunks,
                                "chunk_gc": s3_gc_settled(gc0, chunks),
                                "seconds": time.monotonic() - t0}
        s3_launched("s3_delete", {u: recovered_all(u) - before[u]
                                  for u in cl.live_servers()})

        # 13. on healthy volumes, after the last volume.fsck (which walks
        # F alone, so B's chunks would be its orphans): a second filer B
        # and `weed filer.sync` both ways, `weed filer.meta.tail` /
        # `filer.meta.backup` of /data, the mq broker in F; nothing
        # written since the kill moved by the tiering autopilot
        filer_b = sync_both_ways()
        meta_route(gone)
        mq_route()
        no_tier_move("routes", all_vids() - vids_at_kill)
        on_card("end")
    except BaseException:
        # what the phase measured before it failed, for the log
        emit("filer_failed", steps=steps, launches=launches)
        emit("s3_failed", steps=s3)
        emit("stores_failed", families=stores, steps=stores_steps,
             k1=stores_k1)
        emit("replication_failed", steps=repl)
        raise
    finally:
        codes = cl.stop()
    bad = {u: c for u, c in codes.items() if u not in cl.killed and c != 0}
    if bad:
        raise AssertionError(f"filer phase processes exited {bad}")
    emit("filer", tree_mb=total_mb, files=len(files),
         tree_bytes=tree_bytes, tree_s=tree_s,
         leaves=FILER_LEAVES[0] * FILER_LEAVES[1] * FILER_LEAVES[2],
         volumes={v: {"server": name[u], "dat_bytes": d}
                  for v, (u, d) in vols.items()},
         victim=name[victim], lost=lost,
         startup_s={("master" if u == master else "filer" if u == filer
                     else "s3" if u == gateway else f"volume{name[u]}"): t
                    for u, t in startup.items()},
         steps=steps, launches={k: v for k, v in launches.items()
                                if not k.startswith("s3_")
                                and k not in ROUTE_STEPS},
         cuda_contexts=contexts, bodies_sha256_equal=True)
    emit("s3", s3_mb=s3_mb, objects=len(objs), bytes=s3_bytes,
         cold_objects=len(cold),
         cold_bytes=sum(len(d) for _, d, _, _ in cold), steps=s3,
         launches={k: v for k, v in launches.items()
                   if k.startswith("s3_")},
         bodies_sha256_equal=True)
    k1_stores = counts.of("gf_apply").get("stores", 0)
    if k1_stores != stores_k1["encode_batches"] + \
            stores_k1["rebuild_batches"] or not stores_k1["rebuild_batches"]:
        raise AssertionError(f"stores: {k1_stores} K1 launches, batches "
                             f"{stores_k1}")
    emit("stores", families=stores, steps=stores_steps,
         collection=STORES_COLLECTION,
         volumes={v: {"server": name[vols[v][0]], "dat_bytes": vols[v][1],
                      "lost": lost[v]} for v in stores_vols},
         k1={**stores_k1, "launches": k1_stores},
         bodies_sha256_equal=True)
    k1_routes = {r: counts.of("gf_apply").get(r, 0) for r in ("sync", "mount")}
    if not sum(k1_routes.values()):
        raise AssertionError(f"sync and mount: K1 launches {k1_routes}")
    emit("replication", sync_dir=f"/data/tree/{sync_dir}",
         mount_dir=f"/data/tree/{mount_dir}", steps=repl, k1=k1_routes,
         launches={k: launches[k] for k in ROUTE_STEPS if k in launches},
         bodies_sha256_equal=True)


def kernel_entry(name: str, source: str, replaces: str, counts: PathCounts,
                 worst: int, row: dict, timing: list[dict]) -> dict:
    launches = counts.total(name)
    if launches == 0:
        raise AssertionError(f"no path launched {name}")
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "launches_by_phase": counts.of(name), "max_abs_err": worst,
             "ms": row[f"{name}_ms"], "plain_ms": row[f"{name}_plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": None, "shape": row["shape"],
             "by_shape": [{"shape": r["shape"], "ms": r[f"{name}_ms"],
                           "plain_ms": r[f"{name}_plain_ms"],
                           "bound_ms": r["bound_ms"],
                           "copy_floor_ms": r["copy_floor_ms"]}
                          for r in timing]}
    if name == "mxu_apply":
        entry["int_mm_product_only_ms"] = row["int_mm_product_only_ms"]
    return entry


def batch_kernel_entry(counts: PathCounts, worst: int,
                       rows: list[dict]) -> dict:
    """K1's batch entry in the kernels line, at its encode shape."""
    launches = counts.total("gf_apply_batch")
    if launches == 0:
        raise AssertionError("no path launched gf_apply_batch")
    row = rows[0]
    return {"name": "gf_apply_batch", "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/gf_apply.cu",
            "replaces": K1_REPLACES, "counterpart": K1_BATCH_COUNTERPART,
            "launches": launches,
            "launches_by_phase": counts.of("gf_apply_batch"),
            "max_abs_err": worst, "ms": row["gf_apply_batch_ms"],
            "plain_ms": row["gf_apply_batch_plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"],
            "by_shape": [{"shape": r["shape"], "ms": r["gf_apply_batch_ms"],
                          "plain_ms": r["gf_apply_batch_plain_ms"],
                          "singles_ms": r["singles_ms"],
                          "bound_ms": r["bound_ms"],
                          "copy_floor_ms": r["copy_floor_ms"]}
                         for r in rows]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--volume-mb", type=int, default=1024,
                    help="MiB of needle payload in the volume (default 1024)")
    ap.add_argument("--alt-volume-mb", type=int, default=256,
                    help="MiB of needle payload in each RS(6,3) / RS(12,6) "
                         "volume (default 256)")
    ap.add_argument("--batch-volumes", type=int, default=64,
                    help="volumes encoded at once through the batch "
                         "scheduler (default 64, BASELINE config 4)")
    ap.add_argument("--batch-volume-mb", type=int, default=32,
                    help="MiB of needle payload in each of them "
                         "(default 32)")
    ap.add_argument("--cluster-volume-mb", type=int, default=256,
                    help="MiB of needle payload uploaded to the cluster "
                         "phase's one volume (default 256; the filer phase "
                         "carries the full width)")
    ap.add_argument("--cli-volume-mb", type=int, default=512,
                    help="MiB of needle payload uploaded to the cli "
                         "phase's one volume (default 512, for the time "
                         "limit; the filer phase carries the full width)")
    ap.add_argument("--filer-mb", type=int, default=1000,
                    help="MiB of the seeded tree the filer phase copies "
                         "into the filer (default 1000)")
    ap.add_argument("--s3-mb", type=int, default=1024,
                    help="MiB of signed objects the filer phase's S3 route "
                         "writes into the bucket bkt (default 1024; the "
                         "tiered bucket is a quarter of it)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.batch_volumes < len(BATCH_LOSSES):
        ap.error(f"--batch-volumes must be at least {len(BATCH_LOSSES)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    emit("packages", **packages())
    phase_sim()
    phase_build()
    worst_gf = phase_kernel(args.seed)
    worst_mxu = phase_kernel_mxu(args.seed)
    worst_batch = phase_kernel_batch(args.seed)
    timing = phase_timing(args.seed)
    timing_batch = phase_timing_batch(args.seed)

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counts = PathCounts()
    # the batch path's own counts, so K1's single entry keeps the count of
    # the volume paths above
    batch_counts = PathCounts()
    try:
        deg, payloads = main_path(work, args.volume_mb, args.seed, counts)
        store = degraded_reads(deg, payloads, args.seed, counts)
        degraded_reads_batched(deg, payloads, batch_counts)
        ec_delete(store, deg, payloads, args.seed)
        del payloads
        shutil.rmtree(deg)
        for k, m in ALT_SCHEMES:
            alt_scheme(work, k, m, args.alt_volume_mb, args.seed, counts)
        lrc_volume(work, args.alt_volume_mb, args.seed, counts,
                   batch_counts)
        batch_volumes(work, args.batch_volumes, args.batch_volume_mb,
                      args.seed, batch_counts)
        batch_encode_phase(args.seed, batch_counts,
                           timing_batch[0]["gf_apply_batch_ms"])
        server_phase(work, args.volume_mb, args.alt_volume_mb, args.seed,
                     counts, batch_counts)
        cluster_phase(work, args.cluster_volume_mb, args.seed, counts)
        cli_phase(work, args.cli_volume_mb, args.seed, counts)
        filer_phase(work, args.filer_mb, args.seed, counts, args.s3_mb)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("memory", max_memory_allocated=torch.cuda.max_memory_allocated(0),
         nvidia_smi=smi)

    # K1's headline shape is the RS(10,4) rebuild batch, K2's the RS(10,4)
    # encode batch: the shape each runs on the main path
    rows = {r["shape"]: r for r in timing}
    k1 = kernel_entry("gf_apply", "seaweedfs_tpu_torch/csrc/gf_apply.cu",
                      K1_REPLACES, counts, worst_gf,
                      rows["rebuild 10x16MiB->4 (pipeline batch)"], timing)
    k1["launches_batch_paths"] = {p: c for p, c in
                                  batch_counts.of("gf_apply").items() if c}
    print(json.dumps({"kernels": [
        k1,
        kernel_entry("mxu_apply", "seaweedfs_tpu_torch/csrc/mxu_apply.cu",
                     K2_REPLACES, counts, worst_mxu,
                     rows["encode 10x1MiB->4 (small-block tier)"], timing),
        batch_kernel_entry(batch_counts, worst_batch, timing_batch)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["volume-child"]:  # a cli-phase server process
        sys.exit(volume_child(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["cli-child"]:  # a cli-phase shell or backup
        sys.exit(cli_child(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["db-child"]:  # the stores route's databases
        sys.exit(db_child(sys.argv[2]))
    if sys.argv[1:2] == ["mount-child"]:  # the filer phase's mount route
        sys.exit(mount_child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
