#!/usr/bin/env python3
"""Time `weed filer.copy` of chip_smoke.py's filer tree into an lsm filer
with its change log written through to disk and with it in memory only,
in turns, on one cluster.

    python3 meta_log_ab.py [--mb 1000] [--rounds 2] [--device cpu]

Starts `weed master` and four `weed volume` processes (`--device`, the
card by default), builds chip_smoke.make_filer_tree at `--mb` MiB (seed
22, the smoke's), then for each round in the order on, off, off, on
(`--rounds` pairs) starts a FilerServer on the lsm store in this process,
in a fresh directory: "on" as `weed filer -store lsm` runs it (MetaLog
durable: every event written and flushed to <dir>/filer_meta_log), "off"
with its log kept in memory only, as the JAX filer keeps it. Each round
runs `weed filer.copy -filer F <tree> /r<i>/` to its end and reads its
seconds. Then it times MetaLog.append alone over the last round's events,
durable and in memory, in a scratch directory. Prints the card's
`nvidia-smi` name and power limit where there is one, and one JSON line
with every reading.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, what: str, timeout: float = 180.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            got = cond()
        except (ConnectionError, OSError):
            got = None
        if got:
            return got
        if time.monotonic() > deadline:
            raise SystemExit(f"meta_log_ab: timed out waiting for {what}")
        time.sleep(0.1)


def _append_us(events, d: str, durable: bool) -> float:
    """Microseconds per MetaLog.append of `events`, durable in `d` or in
    memory only."""
    from seaweedfs_tpu_torch.filer.filer import MetaLog
    log = MetaLog(persist_dir=d if durable else None, durable=durable)
    t0 = time.perf_counter()
    for ev in events:
        log.append(ev)
    took = time.perf_counter() - t0
    log.flush()
    return took / max(len(events), 1) * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=2,
                    help="pairs of rounds, run on, off, off, on")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--work", default="",
                    help="working directory (default: a new temp dir)")
    args = ap.parse_args()

    import chip_smoke as cs
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.utils.httpd import http_json

    repo = os.path.dirname(os.path.abspath(__file__))
    work = args.work or tempfile.mkdtemp(prefix="meta_log_ab_")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=repo)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "no nvidia-smi: host only"
    print(smi, flush=True)

    procs = []

    def spawn(name, argv):
        log = open(os.path.join(work, f"{name}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", *argv],
            cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL))
        log.close()

    rounds = []
    try:
        mport = _free_port()
        master = f"127.0.0.1:{mport}"
        spawn("master", ["master", "-port", str(mport), "-mdir",
                         os.path.join(work, "m"), "-volumeSizeLimitMB",
                         "1024"])
        vols = []
        for i in range(4):
            port = _free_port()
            vols.append(f"127.0.0.1:{port}")
            spawn(f"volume_{i}", [
                "volume", "-port", str(port), "-dir",
                os.path.join(work, f"v{i}"), "-mserver", master,
                "-rack", f"r{i % 2}", "-dataCenter", "dc1",
                "-device", args.device])
        tree = os.path.join(work, "tree")
        os.makedirs(tree, exist_ok=True)
        files = cs.make_filer_tree(tree, args.mb, 22)
        tree_bytes = sum(size for _, size, _ in files)

        def registered():
            topo = http_json("GET", f"http://{master}/dir/status",
                             timeout=5)["Topology"]
            return {n["id"] for dc in topo["data_centers"]
                    for r in dc["racks"] for n in r["nodes"]} == set(vols)
        _wait(registered, "the volume servers to register")

        order = ["on", "off", "off", "on"] * (args.rounds // 2)
        if args.rounds % 2:
            order += ["on", "off"]
        events = []
        for i, mode in enumerate(order):
            store_dir = os.path.join(work, f"filer_{i}")
            fs = FilerServer(master, host="127.0.0.1", port=_free_port(),
                             store="lsm", store_dir=store_dir)
            if mode == "off":
                fs.filer.meta_log.persist_dir = None
            fs.start()
            try:
                t0 = time.monotonic()
                p = subprocess.run(
                    [sys.executable, "-m", "seaweedfs_tpu_torch.cli",
                     "filer.copy", "-filer", fs.url, tree, f"/r{i}/"],
                    cwd=repo, env=env, capture_output=True, text=True,
                    timeout=1800)
                wall = time.monotonic() - t0
                if p.returncode != 0:
                    raise SystemExit(f"filer.copy exited {p.returncode}: "
                                     f"{p.stderr[-2000:]}")
                log_dir = os.path.join(store_dir, "filer_meta_log")
                journal = sum(os.path.getsize(os.path.join(log_dir, n))
                              for n in os.listdir(log_dir)) \
                    if os.path.isdir(log_dir) else 0
                events = list(fs.filer.meta_log.events)
                rounds.append({"mode": mode, "seconds": wall,
                               "MBps": tree_bytes / wall / 1e6,
                               "events": len(events),
                               "journal_bytes": journal})
                print(json.dumps(rounds[-1]), flush=True)
            finally:
                fs.stop()
        scratch = os.path.join(work, "append")
        micro = {}
        for durable in (True, False, False, True):
            shutil.rmtree(scratch, ignore_errors=True)
            micro.setdefault("durable_us" if durable else "memory_us",
                             []).append(_append_us(events, scratch, durable))
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        if not args.work:
            shutil.rmtree(work, ignore_errors=True)
    med = {m: statistics.median(r["seconds"] for r in rounds
                                if r["mode"] == m) for m in ("on", "off")}
    print(json.dumps({"device": smi, "files": len(files),
                      "tree_bytes": tree_bytes, "rounds": rounds,
                      "median_s": med, "append": micro}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
