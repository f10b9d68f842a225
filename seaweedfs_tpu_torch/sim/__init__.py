"""Macro-scale incident simulation: the cluster we can't rent.

All acceptance benches in this repo run 2-4 real processes on one vCPU;
the failure modes that actually threaten a fleet — correlated AZ loss,
repair storms, degraded-read amplification under load, tenant floods —
are emergent at O(100) nodes (the warehouse-scale failure literature:
arXiv:1309.0186, arXiv:2306.10528).  This package stands up O(100)
lightweight in-process volume-server actors (plus a master and N
filers) on one deterministic virtual clock with an in-memory loopback
transport, replays scripted fault schedules against them, and checks
machine-readable invariants: zero acked-write loss, repair convergence
within the pacing budget, bounded interactive p99, breaker recovery,
no tenant starvation.

The actors are behavioral models of the real servers, but the control
policies under test are the REAL classes: per-peer CircuitBreaker /
PeerHealth ranking (utils/resilience.py), the QosGovernor with its
AdaptiveLimiter and tenant buckets (qos/), and a repair pacer with the
same grace/backoff/budget semantics as scrub/repair_queue.py — all
running on virtual time via utils/clockctl.py.  Same seed, same event
log, bit for bit.

Modules:
  kernel     deterministic discrete-event loop + coroutine effects
  faults     scripted fault-schedule schema (shared with tools/netchaos)
  workload   seeded zipf multi-tenant open-loop workload generator
  actors     master / filer / volume actor state machines
  incidents  scripted incident library + invariant checkers
  harness    SimCluster: wire everything, run, report

Entry points: ``python -m seaweedfs_tpu_torch.sim --incident <name>
--seed <n>`` and ``tests/test_torch_sim.py`` (16-actor smoke in tier-1,
the 100-actor matrix slow-marked).

The port's copy of seaweedfs_tpu/sim, over the port's own qos, resilience,
slo, lrc, rebalance and tiering modules. It imports nothing of that
package, and runs no kernel: ``LrcCoder`` is a host coder in both
packages. Same seed, same event log as the reference's, bit for bit.
"""

from seaweedfs_tpu_torch.sim.harness import SimCluster  # noqa: F401
from seaweedfs_tpu_torch.sim.incidents import INCIDENTS, run_incident  # noqa: F401
