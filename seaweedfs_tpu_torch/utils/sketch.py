"""Space-Saving top-k sketch: bounded-memory hot-key detection.

Metwally/Agrawal/El Abbadi's Space-Saving algorithm (the standard
heavy-hitters sketch; also the one the Facebook warehouse-cluster
study's hot-block analysis presumes): track at most ``capacity``
counters; an untracked key evicts the minimum counter and inherits
its count as its error bound.  Guarantees, with N total offers:

  * every key with true count > N / capacity is tracked
  * for a tracked key:  estimate - error <= true <= estimate
  * error <= N / capacity

Sketches are mergeable (Agarwal et al., "Mergeable Summaries"): for
each key in the union, sum the per-sketch estimates, counting a key
missing from one sketch at that sketch's minimum counter value (its
mass could hide below the eviction floor — charging the floor keeps
the estimate an upper bound), then truncate back to ``capacity``.
Merging is commutative: the combine step is symmetric and the
truncation tie-breaks on the key itself.

Volume servers feed needle fids through this; filer/S3 feed paths and
tenants (stats/hotkeys.py) — the measurement prerequisite for the
hot-needle cache and filer shard routing on the roadmap.

The port's copy of seaweedfs_tpu/utils/sketch.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import threading


class SpaceSaving:
    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        # key -> [count, error]; lists so offer() mutates in place
        self._entries: dict[str, list] = {}
        self._total = 0
        self._lock = threading.Lock()

    def offer(self, key: str, count: int = 1) -> None:
        with self._lock:
            self._total += count
            e = self._entries.get(key)
            if e is not None:
                e[0] += count
                return
            if len(self._entries) < self.capacity:
                self._entries[key] = [count, 0]
                return
            # evict the minimum counter; deterministic tie-break on the
            # key keeps replays bit-reproducible
            victim = min(self._entries.items(),
                         key=lambda kv: (kv[1][0], kv[0]))
            vmin = victim[1][0]
            del self._entries[victim[0]]
            self._entries[key] = [vmin + count, vmin]

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    def _min_count(self) -> int:
        # lock held by caller
        if len(self._entries) < self.capacity:
            return 0
        return min(e[0] for e in self._entries.values())

    def top(self, k: int = 0) -> list:
        """[(key, estimate, error)] sorted by estimate desc (key as
        the deterministic tie-break), at most k entries (0 = all)."""
        with self._lock:
            items = [(key, e[0], e[1])
                     for key, e in self._entries.items()]
        items.sort(key=lambda t: (-t[1], t[0]))
        return items[:k] if k else items

    def estimate(self, key: str) -> tuple:
        """(estimate, error) for one key; an untracked key reports the
        eviction floor as both (its true count is at most that)."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                return e[0], e[1]
            floor = self._min_count()
            return floor, floor

    # ---- mergeable transport ----
    def snapshot(self) -> dict:
        with self._lock:
            entries = sorted(
                [k, e[0], e[1]] for k, e in self._entries.items())
            return {"capacity": self.capacity, "total": self._total,
                    "entries": entries,
                    "min_count": self._min_count()}

    def merge_from(self, snap: dict) -> None:
        """Fold another sketch's ``snapshot()`` into this one. The
        other sketch's eviction floor is charged to keys it is missing
        (count AND error), preserving the upper-bound property."""
        with self._lock:
            other = {k: (c, err) for k, c, err in snap["entries"]}
            floor_other = int(snap.get("min_count", 0))
            floor_mine = self._min_count()
            merged: dict[str, list] = {}
            for key in set(self._entries) | set(other):
                mc, me = (self._entries[key]
                          if key in self._entries
                          else (floor_mine, floor_mine))
                oc, oe = other.get(key, (floor_other, floor_other))
                merged[key] = [mc + oc, me + oe]
            ranked = sorted(merged.items(),
                            key=lambda kv: (-kv[1][0], kv[0]))
            self._entries = dict(ranked[:self.capacity])
            self._total += int(snap.get("total", 0))

    @classmethod
    def from_snapshot(cls, snap: dict) -> "SpaceSaving":
        s = cls(capacity=int(snap.get("capacity", 64)) or 64)
        s.merge_from(snap)
        return s
