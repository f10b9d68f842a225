"""Master-side telemetry aggregation: merge per-node RED histogram
and hot-key snapshots into cluster-wide per-class quantiles, top-k
keys, and exemplar trace ids, and judge them against SLO objectives.

Transport: volume servers piggyback their snapshot on heartbeats
(next to qos_pressure); filer/S3 snapshots are pulled through the
/cluster/register membership table. Histogram merging is exact
(bucket counts add); quantiles are computed once, after the merge —
never averaged across nodes.

The port's copy of seaweedfs_tpu/stats/telemetry.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

from typing import Optional

from seaweedfs_tpu_torch.stats.hotkeys import HotKeys
from seaweedfs_tpu_torch.stats.ledger import ResourceLedger
from seaweedfs_tpu_torch.stats.slo import SloEvaluator
from seaweedfs_tpu_torch.utils.metrics import RED_BUCKETS, Histogram

# label order of the RED histogram: see metrics.RedRecorder
_L_SERVER, _L_ROUTE, _L_CLASS, _L_STATUS = range(4)

# hint-journal staleness thresholds (SloEvaluator-adjacent: a simple
# level alert, not a burn rate — journal debt is a stock, not a flow).
# Either condition on ANY node fires `hints_stale` in alerts_firing.
HINTS_PENDING_MAX = 1024
HINTS_AGE_MAX_S = 60.0


def red_class_rollup(snapshot: dict, latency_targets: dict) -> dict:
    """Collapse a (merged) RED snapshot to per-class totals:
    {cls: {total, errors, slow, bad, sum}}. bad = 5xx + over-target
    among non-5xx — the SLO evaluator's numerator."""
    buckets = list(snapshot.get("buckets", RED_BUCKETS))
    out: dict[str, dict] = {}
    for labels, counts, total_sum, _ex in snapshot.get("series", ()):
        cls = labels[_L_CLASS]
        st = out.setdefault(cls, {"total": 0, "errors": 0, "slow": 0,
                                  "bad": 0, "sum": 0.0})
        n = sum(counts)
        st["total"] += n
        st["sum"] += total_sum
        if labels[_L_STATUS] == "5xx":
            st["errors"] += n
            st["bad"] += n
            continue
        target = latency_targets.get(cls)
        if target is None:
            continue
        fast = sum(c for b, c in zip(buckets, counts) if b <= target)
        slow = n - fast
        st["slow"] += slow
        st["bad"] += slow
    return out


class ClusterTelemetry:
    """Stateless merge + stateful judgement. ``rollup()`` rebuilds
    the merged view from scratch each call (node sets change); the
    SLO evaluator underneath accumulates the cumulative samples the
    burn-rate windows diff."""

    def __init__(self, objectives: Optional[dict] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 on_transition=None):
        kwargs = {}
        if fast_window_s is not None:
            kwargs["fast_window_s"] = fast_window_s
        if slow_window_s is not None:
            kwargs["slow_window_s"] = slow_window_s
        self.slo = SloEvaluator(objectives=objectives,
                                on_transition=on_transition, **kwargs)

    @staticmethod
    def merge(node_snaps: list) -> tuple:
        """Merge node telemetry snapshots ({"node", "server", "red",
        "hotkeys", "ledger"?, "hints"?}) into (red Histogram, HotKeys,
        ResourceLedger, per-node hint-journal rows, contributing node
        urls)."""
        red = Histogram(
            "cluster_red", "merged RED",
            label_names=("server", "route_family", "class",
                         "status_family"),
            buckets=RED_BUCKETS)
        hot = HotKeys(dims=())
        ledger = ResourceLedger()
        hints = []
        nodes = []
        for snap in node_snaps:
            if not snap:
                continue
            if snap.get("red"):
                red.merge_from(snap["red"])
            if snap.get("hotkeys"):
                hot.merge_from(snap["hotkeys"])
            if snap.get("ledger"):
                ledger.merge_from(snap["ledger"])
            if snap.get("hints"):
                hints.append({"node": snap.get("node", ""),
                              **snap["hints"]})
            if snap.get("node"):
                nodes.append(snap["node"])
        return red, hot, ledger, hints, nodes

    def rollup(self, now: float, node_snaps: list,
               top_k: int = 10) -> dict:
        """The /cluster/telemetry body: merged per-class quantiles +
        error rates, cluster top-k hot keys, bucket exemplars, and
        the SLO judgement (feeding the burn-rate windows as a side
        effect)."""
        red, hot, ledger, hints, nodes = self.merge(node_snaps)
        targets = {c: o["latency_s"]
                   for c, o in self.slo.objectives.items()}
        merged_snap = red.snapshot()
        per_class_totals = red_class_rollup(merged_snap, targets)
        per_class = {}
        for cls, st in sorted(per_class_totals.items()):
            self.slo.feed(now, cls, st["total"], st["bad"])
            exemplars = _class_exemplars(merged_snap, cls)
            per_class[cls] = {
                "count": st["total"],
                "errors": st["errors"],
                "error_rate": round(st["errors"] / st["total"], 6)
                if st["total"] else 0.0,
                "slow": st["slow"],
                "p50": red.quantile(
                    0.5, label_filter=lambda l: l[_L_CLASS] == cls),
                "p99": red.quantile(
                    0.99, label_filter=lambda l: l[_L_CLASS] == cls),
                "exemplars": exemplars,
            }
        slo_view = self.slo.evaluate(now)
        for cls, judged in slo_view.items():
            if cls in per_class:
                per_class[cls]["slo"] = judged
        alerts = list(self.slo.firing())
        stale = [h for h in hints
                 if h.get("pending_rows", 0) > HINTS_PENDING_MAX
                 or h.get("oldest_debt_age_s", 0.0) > HINTS_AGE_MAX_S]
        if stale:
            alerts.append("hints_stale")
        return {
            "per_class": per_class,
            "top_keys": hot.top(top_k),
            "key_totals": {d: sk.total
                           for d, sk in hot.sketches.items()},
            # per-(class, tenant) chargeback: cluster-merged CPU-ms,
            # wire bytes, disk reads — hottest tenants first
            "ledger": {"fields": ["class", "tenant", "requests",
                                  "cpu_ms", "bytes_in", "bytes_out",
                                  "disk_bytes_read"],
                       "rows": ledger.snapshot()["rows"][:max(top_k, 20)]},
            "hints": hints,
            "nodes": sorted(nodes),
            "slo": slo_view,
            "alerts_firing": alerts,
        }


def _class_exemplars(snapshot: dict, cls: str) -> list:
    """[{le, trace_id}] for one class across the merged series (last
    series wins per bucket — exemplars are samples, any one will do)."""
    buckets = [str(b) for b in snapshot.get("buckets", ())] + ["+Inf"]
    by_bucket: dict[str, str] = {}
    for labels, _counts, _sum, exemplars in snapshot.get("series", ()):
        if labels[_L_CLASS] != cls or not exemplars:
            continue
        for i, e in enumerate(exemplars):
            if e:
                by_bucket[buckets[i]] = e
    return [{"le": le, "trace_id": tid}
            for le, tid in sorted(by_bucket.items())]
