"""Bounded hot-entry + negative-lookup cache in front of a FilerStore.

Two LRU maps: ``hot`` (path -> entry dict) for entries that exist and
``neg`` (path -> miss) for paths known NOT to exist — under S3
HEAD-heavy traffic the absent path is the common case, and a cached
miss saves the same store round trip a cached hit does.

Correctness hinges on one invariant: **a cached miss must not outlive
the entry's creation** (and a cached entry must not outlive its
update/delete).  Fills are therefore fence-guarded: a reader takes a
token (``begin``) BEFORE its store read, and ``put``/``put_negative``
reject the fill if an invalidation of THAT PATH landed in between.
The writer's order is store-write THEN invalidate, so for any racing
fill either

  - the invalidation ran first -> the token is stale, the fill is
    rejected (the reader just misses again next time), or
  - the fill landed first -> the subsequent invalidation removes it.

Either way no stale fact survives the write.  Fences are PER-PATH — a
fill of ``/a`` is only endangered by a mutation of ``/a``, so an
unrelated write must not reject it (a global epoch keeps the cache
permanently cold under any steady write load).  The fence map is
bounded: when an old fence is evicted, its sequence number becomes the
conservative floor — any fill begun before the floor is rejected
regardless of path.  A fill is therefore only ever wrongly rejected,
never wrongly accepted.

The cache stores entry DICTS, not Entry objects: every store returns
by value (callers may mutate what they get back), and the cache must
not become a mutable alias shared across requests.

The port's copy of seaweedfs_tpu/filer/entry_cache.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

FENCE_CAP = 4096  # invalidations remembered per-path before flooring


class EntryCache:
    def __init__(self, capacity: int = 8192, neg_capacity: int = 8192):
        self.capacity = capacity
        self.neg_capacity = neg_capacity
        self._lock = threading.Lock()
        self._hot: OrderedDict[str, dict] = OrderedDict()
        self._neg: OrderedDict[str, bool] = OrderedDict()
        self._seq = 0  # mutation sequence, bumped by every invalidation
        # path -> seq of its latest invalidation (bounded; see floor)
        self._fences: OrderedDict[str, int] = OrderedDict()
        self._fence_floor = 0  # fences <= floor have been evicted
        self.hits = 0
        self.neg_hits = 0
        self.misses = 0
        self.fills = 0
        self.neg_fills = 0
        self.invalidations = 0
        self.stale_fills = 0  # fills rejected by the fence guard

    # ---- read side ----
    def begin(self, path: str) -> int:
        """Fill token: take BEFORE the store read, hand to put*()."""
        return self._seq

    def get(self, path: str) -> tuple[bool, Optional[dict]]:
        """(cached, entry_dict_or_None).  (True, None) is a cached
        miss; (False, None) means ask the store."""
        with self._lock:
            d = self._hot.get(path)
            if d is not None:
                self._hot.move_to_end(path)
                self.hits += 1
                return True, d
            if path in self._neg:
                self._neg.move_to_end(path)
                self.neg_hits += 1
                return True, None
            self.misses += 1
            return False, None

    def _fenced(self, path: str, token: int) -> bool:
        return (self._fences.get(path, 0) > token
                or self._fence_floor > token)

    def put(self, path: str, entry_dict: dict, token: int) -> bool:
        with self._lock:
            if self._fenced(path, token):
                self.stale_fills += 1
                return False
            self._neg.pop(path, None)
            self._hot[path] = entry_dict
            self._hot.move_to_end(path)
            self.fills += 1
            while len(self._hot) > self.capacity:
                self._hot.popitem(last=False)
            return True

    def put_negative(self, path: str, token: int) -> bool:
        with self._lock:
            if self._fenced(path, token):
                self.stale_fills += 1
                return False
            self._hot.pop(path, None)
            self._neg[path] = True
            self._neg.move_to_end(path)
            self.neg_fills += 1
            while len(self._neg) > self.neg_capacity:
                self._neg.popitem(last=False)
            return True

    # ---- write side ----
    def invalidate(self, path: str) -> None:
        """Drop whatever is cached for `path` and fence any fill of it
        currently in flight."""
        with self._lock:
            self._seq += 1
            self.invalidations += 1
            self._fences[path] = self._seq
            self._fences.move_to_end(path)
            while len(self._fences) > FENCE_CAP:
                _, evicted = self._fences.popitem(last=False)
                if evicted > self._fence_floor:
                    self._fence_floor = evicted
            self._hot.pop(path, None)
            self._neg.pop(path, None)

    def clear(self) -> None:
        with self._lock:
            self._seq += 1
            self._fence_floor = self._seq  # fence everything in flight
            self._fences.clear()
            self._hot.clear()
            self._neg.clear()

    # ---- observability ----
    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.neg_hits + self.misses
            return {
                "entries": len(self._hot), "negatives": len(self._neg),
                "capacity": self.capacity,
                "hits": self.hits, "neg_hits": self.neg_hits,
                "misses": self.misses,
                "hit_rate": round((self.hits + self.neg_hits)
                                  / total, 4) if total else 0.0,
                "fills": self.fills, "neg_fills": self.neg_fills,
                "stale_fills": self.stale_fills,
                "invalidations": self.invalidations,
            }
