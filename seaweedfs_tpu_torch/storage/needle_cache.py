"""Byte-budgeted LRU of hot needle records at the volume server (the
port of seaweedfs_tpu/storage/needle_cache.py).

Caches RAW on-disk record blobs (the same bytes ``read_needle_blob``
returns), never parsed Needle objects.  CRC is verified ONCE, at
admission: every loader runs ``needle.verify_record_crc`` over the
blob (chained crc32c over memoryview windows — no payload copy)
before the blob enters the cache, so a corrupt record can never be
admitted.  Hits then parse with ``check_crc=False`` and restore the
stored checksum via ``needle.payload_crc_stored`` — a cached read
stays bit-identical to a disk read (the blob is immutable in the
cache; handlers that mutate ``n.data`` after parse — gzip
decompress, image resize — mutate their own parsed copy, never the
cached bytes) without re-hashing the payload on every hit. The zipf head in real
traffic makes this the common-read fast path; per the degraded-read boosting
line of arXiv 2306.10528, the biggest win is on degraded EC volumes,
where a miss pays a k-column decode — reconstructed records are
admitted eagerly (``force``) while healthy records pass through the
HotKeys Space-Saving sketch so one-hit wonders don't churn the budget.

Concurrency contract:
- ``get_or_load`` is single-flight per key: one leader runs the loader
  (outside the lock), concurrent readers of the same cold needle wait
  on its flight and are served the same result — 32 concurrent readers
  of a cold degraded needle cost ONE reconstruction. Waiters honor the
  ambient request deadline.
- Invalidation (delete/overwrite/vacuum/unmount) is strict: it drops
  cached entries AND bumps the volume's epoch so a load that was in
  flight across the invalidation cannot re-admit stale bytes (its
  waiters still get the pre-invalidation result — they raced the
  delete, which is ordinary read/delete semantics).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional

from seaweedfs_tpu_torch.utils import resilience

# accounting overhead per entry (key tuple, OrderedDict node, blob
# header) — keeps thousands of tiny needles from blowing the budget
_ENTRY_OVERHEAD = 256

# a waiter with no ambient deadline still must not hang on a wedged
# leader forever
_DEFAULT_WAIT_S = 30.0


class _Flight:
    __slots__ = ("event", "result", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None


class NeedleCache:
    """LRU over (vid, needle_id) -> (record_blob, size, version).

    ``hot_fn(vid, nid) -> (estimate, error)`` is the HotKeys sketch
    probe; admission of a NON-forced entry into a full cache requires
    the sketch's guaranteed lower bound (estimate - error) to reach
    ``admit_min`` observations. A cache with free space admits freely
    (cold-start fill), and reconstructed/degraded records are always
    admitted (``force=True``) — that decode is the cost being saved.
    """

    def __init__(self, capacity_bytes: int = 64 << 20,
                 hot_fn: Optional[Callable] = None,
                 admit_min: int = 2, max_item_frac: int = 8):
        self.capacity_bytes = int(capacity_bytes)
        self.hot_fn = hot_fn
        self.admit_min = int(admit_min)
        self.max_item_frac = max(1, int(max_item_frac))
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._flights: dict = {}
        self._vol_epoch: dict[int, int] = {}
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.rejects = 0
        self.coalesced = 0       # waiters served by another's flight
        self.invalidations = 0

    # ---- sizing -------------------------------------------------------

    def max_item_bytes(self) -> int:
        return self.capacity_bytes // self.max_item_frac

    # ---- read side ----------------------------------------------------

    def get(self, vid: int, needle_id: int):
        """(blob, size, version) on a hit (LRU-refreshed), else None."""
        key = (vid, needle_id)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return ent
            self.misses += 1
            return None

    def contains(self, vid: int, needle_id: int) -> bool:
        """Non-mutating membership probe — no LRU touch, no hit/miss
        accounting. Feeds the cache-hot response header for
        cache-aware read routing; a probe must not make an entry look
        hotter or skew the stats the admission policy reads."""
        with self._lock:
            return (vid, needle_id) in self._entries

    def get_or_load(self, vid: int, needle_id: int, loader):
        """Single-flight read-through. ``loader() -> (blob, size,
        version, force_admit)`` runs at most once per concurrent cold
        key; its exception propagates to every waiter of that flight.
        Returns (blob, size, version)."""
        key = (vid, needle_id)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return ent
            fl = self._flights.get(key)
            if fl is None:
                fl = _Flight()
                self._flights[key] = fl
                leader = True
                self.misses += 1
                epoch0 = self._vol_epoch.get(vid, 0)
            else:
                leader = False
                self.coalesced += 1
        if leader:
            try:
                blob, size, version, force = loader()
                fl.result = (blob, size, version)
            except BaseException as e:
                fl.exc = e
                raise
            finally:
                with self._lock:
                    if self._flights.get(key) is fl:
                        del self._flights[key]
                fl.event.set()
            with self._lock:
                # an invalidation while we were loading means these
                # bytes may predate a delete/overwrite: serve them to
                # this flight's waiters but never admit them
                if self._vol_epoch.get(vid, 0) == epoch0:
                    self._admit_locked(key, blob, size, version, force)
            return fl.result
        dl = resilience.current_deadline()
        timeout = _DEFAULT_WAIT_S if dl is None \
            else max(0.0, dl.remaining())
        if not fl.event.wait(timeout):
            raise resilience.DeadlineExceeded(
                f"needle cache: timed out waiting on load of "
                f"{vid},{needle_id:x}")
        if fl.exc is not None:
            raise fl.exc
        return fl.result

    # ---- write side ---------------------------------------------------

    def offer(self, vid: int, needle_id: int, blob: bytes, size: int,
              version: int, force: bool = False) -> bool:
        with self._lock:
            return self._admit_locked((vid, needle_id), blob, size,
                                      version, force)

    def _admit_locked(self, key, blob, size, version,
                      force: bool) -> bool:
        cost = len(blob) + _ENTRY_OVERHEAD
        if cost > self.max_item_bytes():
            self.rejects += 1
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes_used -= len(old[0]) + _ENTRY_OVERHEAD
        if not force and self.hot_fn is not None \
                and self.bytes_used + cost > self.capacity_bytes:
            # full cache: a newcomer must have proven itself hot —
            # the sketch's guaranteed lower bound on its access count
            # (Space-Saving: estimate minus max overestimation error)
            est, err = self.hot_fn(*key)
            if est - err < self.admit_min:
                self.rejects += 1
                return False
        while self.bytes_used + cost > self.capacity_bytes \
                and self._entries:
            _, (eblob, _, _) = self._entries.popitem(last=False)
            self.bytes_used -= len(eblob) + _ENTRY_OVERHEAD
            self.evictions += 1
        if self.bytes_used + cost > self.capacity_bytes:
            self.rejects += 1
            return False
        self._entries[key] = (blob, size, version)
        self.bytes_used += cost
        self.inserts += 1
        return True

    # ---- invalidation -------------------------------------------------

    def invalidate(self, vid: int, needle_id: int) -> None:
        """Strict per-needle invalidation (delete / overwrite): drops
        the entry, cuts any in-flight load loose (future readers start
        fresh), and bumps the volume epoch so a load racing this call
        cannot re-admit pre-invalidation bytes."""
        key = (vid, needle_id)
        with self._lock:
            self._vol_epoch[vid] = self._vol_epoch.get(vid, 0) + 1
            self._flights.pop(key, None)
            ent = self._entries.pop(key, None)
            if ent is not None:
                self.bytes_used -= len(ent[0]) + _ENTRY_OVERHEAD
            self.invalidations += 1

    def invalidate_volume(self, vid: int) -> None:
        """Whole-volume invalidation (vacuum / unmount / delete /
        ec-conversion)."""
        with self._lock:
            self._vol_epoch[vid] = self._vol_epoch.get(vid, 0) + 1
            for key in [k for k in self._flights if k[0] == vid]:
                del self._flights[key]
            doomed = [k for k in self._entries if k[0] == vid]
            for key in doomed:
                blob, _, _ = self._entries.pop(key)
                self.bytes_used -= len(blob) + _ENTRY_OVERHEAD
            self.invalidations += 1

    # ---- observability / control --------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity_bytes": self.capacity_bytes,
                "bytes": self.bytes_used,
                "items": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "rejects": self.rejects,
                "coalesced": self.coalesced,
                "invalidations": self.invalidations,
                "admit_min": self.admit_min,
                "inflight_loads": len(self._flights),
            }

    def configure(self, capacity_bytes: Optional[int] = None,
                  admit_min: Optional[int] = None) -> dict:
        """Operator resize (the /admin/cache POST). Shrinking evicts
        LRU-first down to the new budget."""
        with self._lock:
            if admit_min is not None:
                self.admit_min = max(0, int(admit_min))
            if capacity_bytes is not None:
                self.capacity_bytes = max(0, int(capacity_bytes))
                while self.bytes_used > self.capacity_bytes \
                        and self._entries:
                    _, (blob, _, _) = self._entries.popitem(last=False)
                    self.bytes_used -= len(blob) + _ENTRY_OVERHEAD
                    self.evictions += 1
        return self.stats()
