"""Seeded zipf multi-tenant workload for the macro simulation.

Open-loop arrivals: each tenant emits operations at a configured rate
on the virtual clock, so a slow cluster does NOT slow the offered load
— queues build, pressure mounts, and the QoS machinery has something
real to govern (closed-loop generators hide overload by construction).

Key popularity is zipf(s≈1.1) over a ~10^6 keyspace, sampled by
inverse-CDF over the truncated zeta distribution (numpy searchsorted
on the cumulative weights), which matches the hot-spot skew of CDN /
blob traces.  Every draw comes from one seeded Generator so the whole
arrival sequence is a pure function of (seed, config).

The port's copy of seaweedfs_tpu/sim/workload.py. It imports nothing of that
package.
"""

from __future__ import annotations

import numpy as np

from seaweedfs_tpu_torch.qos.classes import BACKGROUND, INTERACTIVE, WRITE


class TenantSpec:
    __slots__ = ("name", "rate", "mix", "weight")

    def __init__(self, name: str, rate: float,
                 mix: tuple[float, float, float] = (0.70, 0.25, 0.05),
                 weight: float = 1.0):
        """rate: ops/virtual-second.  mix: (interactive read, write,
        background) fractions.  weight: relative fair-share weight."""
        self.name = name
        self.rate = rate
        self.mix = mix
        self.weight = weight


class Op:
    __slots__ = ("t", "tenant", "klass", "kind", "key", "size")

    def __init__(self, t, tenant, klass, kind, key, size):
        self.t = t              # virtual arrival time
        self.tenant = tenant
        self.klass = klass      # qos class name
        self.kind = kind        # "read" | "write" | "scan"
        self.key = key          # int in [0, keyspace)
        self.size = size        # payload bytes (writes)


class ZipfWorkload:
    def __init__(self, tenants: list[TenantSpec], seed: int,
                 keyspace: int = 1_000_000, zipf_s: float = 1.1,
                 write_size: int = 16 * 1024):
        self.tenants = tenants
        self.keyspace = keyspace
        self.write_size = write_size
        self._rng = np.random.default_rng(seed)
        # Truncated-zeta inverse CDF: ranks 1..K with weight rank^-s.
        ranks = np.arange(1, keyspace + 1, dtype=np.float64)
        weights = ranks ** -zipf_s
        self._cdf = np.cumsum(weights)
        self._cdf /= self._cdf[-1]
        # Random permutation so "popular" keys are scattered over the
        # id space instead of clustered at low ids (and therefore over
        # volumes, since placement hashes the key).
        self._perm = self._rng.permutation(keyspace)

    def _draw_key(self) -> int:
        u = self._rng.random()
        rank = int(np.searchsorted(self._cdf, u))
        return int(self._perm[min(rank, self.keyspace - 1)])

    def generate(self, duration: float) -> list[Op]:
        """Materialize every arrival in [0, duration), sorted by time.
        Open-loop: timestamps are drawn up front from Poisson gaps and
        never shifted by simulated service times."""
        ops: list[Op] = []
        for spec in self.tenants:
            if spec.rate <= 0:
                continue
            n_expected = spec.rate * duration
            # Poisson process: exponential inter-arrival gaps.
            gaps = self._rng.exponential(
                1.0 / spec.rate, size=int(n_expected * 1.3) + 16)
            times = np.cumsum(gaps)
            times = times[times < duration]
            p_i, p_w, _ = spec.mix
            kinds = self._rng.random(times.shape[0])
            for t, u in zip(times.tolist(), kinds.tolist()):
                if u < p_i:
                    klass, kind, size = INTERACTIVE, "read", 0
                elif u < p_i + p_w:
                    klass, kind, size = WRITE, "write", self.write_size
                else:
                    klass, kind, size = BACKGROUND, "scan", 0
                ops.append(Op(t, spec.name, klass, kind,
                              self._draw_key(), size))
        ops.sort(key=lambda o: (o.t, o.tenant, o.key))
        return ops


def namespace_path(key: int, tenant: str = "zipf",
                   fanout: int = 256) -> str:
    """Map a workload key onto a filer namespace path.

    Keys land in ``/<tenant>/<bucket>/k<key>`` where bucket =
    key % fanout — a two-level tree whose ~fanout directories spread
    across a shard ring (ownership hashes the DIRECTORY), while each
    key keeps a stable home so replaying the same op log against two
    clusters touches identical paths.  This is the bridge between the
    seeded zipf op log and the filer-namespace benchmarks."""
    return f"/{tenant}/b{key % fanout:03d}/k{key}"


def default_tenants(n_tenants: int = 4, total_rate: float = 400.0,
                    flood_tenant: str | None = None,
                    flood_rate: float = 0.0) -> list[TenantSpec]:
    """Even split of total_rate across tenants; optionally one tenant
    gets an extra flood_rate of pure background scans (the tenant-flood
    incident)."""
    base = total_rate / max(1, n_tenants)
    tenants = [TenantSpec(f"tenant-{i}", base) for i in range(n_tenants)]
    if flood_tenant is not None and flood_rate > 0:
        tenants.append(TenantSpec(flood_tenant, flood_rate,
                                  mix=(0.0, 0.0, 1.0)))
    return tenants
