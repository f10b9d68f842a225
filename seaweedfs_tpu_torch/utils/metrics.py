"""Mergeable histograms (the port of seaweedfs_tpu/utils/metrics.py's
``Histogram`` and ``RED_BUCKETS``; its registry, text exposition and push
client are not ported).

``snapshot()`` returns per-bucket (not cumulative) counts in the JAX
package's transport format, ``{"name", "buckets", "label_names",
"series": [[labels, counts, sum, exemplars], ...]}``, so snapshots from
either package merge by elementwise addition.
"""

from __future__ import annotations

import bisect
import threading

# RED (rate/errors/duration) latency buckets, in seconds
RED_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
               1.0, 2.5, 5.0, 10.0)


class Histogram:
    DEFAULT_BUCKETS = (0.0001, 0.001, 0.01, 0.1, 1, 10)

    def __init__(self, name: str, help_: str, label_names: tuple = (),
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.buckets = sorted(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, *labels) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.setdefault(
                labels, [0] * (len(self.buckets) + 1))
            counts[idx] += 1
            self._sums[labels] = self._sums.get(labels, 0.0) + value

    def snapshot(self) -> dict:
        """JSON-safe copy of every series; the last bucket is +Inf. The
        exemplar slot of each series is always empty here (trace
        exemplars are not ported)."""
        n = len(self.buckets) + 1
        with self._lock:
            series = [[list(labels), list(counts), self._sums[labels],
                       [None] * n]
                      for labels, counts in self._counts.items()]
        series.sort(key=lambda s: s[0])
        return {"name": self.name, "buckets": list(self.buckets),
                "label_names": list(self.label_names), "series": series}
