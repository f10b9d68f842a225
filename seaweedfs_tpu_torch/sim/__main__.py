"""Run a scripted macro-simulation incident and check its invariants.

Thin CLI over seaweedfs_tpu_torch/sim (the port of tools/macro_sim.py):
builds an N-actor cluster on the virtual clock, replays one incident from
the library (az_loss, rolling_restart, herd_repair, tenant_flood, ... —
or `all`), and prints the JSON report with per-invariant verdicts, the
event-log hash (same seed => same hash, byte-for-byte), and throughput
(simulated events and client ops per wall second). Exits nonzero if any
invariant fails, so it slots into CI as-is.

Usage:
  python -m seaweedfs_tpu_torch.sim --incident rolling_restart \\
      [--seed 42] [--actors 100] [--filers 4] [--rate 240] [--compact]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from seaweedfs_tpu_torch.sim.incidents import INCIDENTS, run_incident


def run_one(name: str, args) -> dict:
    t0 = time.perf_counter()
    report = run_incident(name, seed=args.seed, n_actors=args.actors,
                          n_filers=args.filers, rate=args.rate)
    wall = time.perf_counter() - t0
    report["wall_s"] = round(wall, 3)
    report["events_per_wall_s"] = round(report["events"] / wall)
    report["sim_ops_per_wall_s"] = round(
        report["client"]["ops"] / wall) if wall else 0
    return report


def compact(report: dict) -> dict:
    return {
        "incident": report["incident"], "seed": report["seed"],
        "actors": report["actors"], "passed": report["passed"],
        "invariants": {c["name"]: ("ok" if c["ok"] else c["detail"])
                       for c in report["invariants"]},
        "log_hash": report["log_hash"][:16],
        "virtual_s": report["virtual_s"], "wall_s": report["wall_s"],
        "events_per_wall_s": report["events_per_wall_s"],
        "ops": report["client"]["ops"],
        "failed_ops": report["client"]["failed"],
        "interactive_p99_ms":
            report["client"]["latency_ms"]["interactive"]["p99"],
        "repairs": report["repair"]["done"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m seaweedfs_tpu_torch.sim",
                                description=__doc__)
    p.add_argument("--incident", default="all",
                   choices=sorted(INCIDENTS) + ["all"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--actors", type=int, default=100,
                   help="volume-server actor count (>= 64 for the "
                        "acceptance matrix; 16 for a fast smoke)")
    p.add_argument("--filers", type=int, default=4)
    p.add_argument("--rate", type=float, default=0.0,
                   help="total offered ops/s (0 = 2.4 per actor)")
    p.add_argument("--compact", action="store_true",
                   help="one summary object per incident instead of "
                        "the full report")
    args = p.parse_args(argv)

    names = sorted(INCIDENTS) if args.incident == "all" \
        else [args.incident]
    ok = True
    for name in names:
        report = run_one(name, args)
        ok = ok and report["passed"]
        print(json.dumps(compact(report) if args.compact else report,
                         indent=None if args.compact else 2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
