"""ReaderCache: single-flight chunk fetch + sequential prefetch.

Functional equivalent of reference weed/filer/reader_cache.go (one
in-flight download per chunk no matter how many concurrent readers
want it, downloaded chunks parked in the tiered chunk cache,
MaybeCache prefetch of upcoming chunks on sequential reads) backing
weed/filer/reader_at.go's ChunkReadAt. Used by both the filer's
read/stream path and the FUSE mount (weed/mount/weedfs_file_read.go
reads through the same cache in the reference).

The port's copy of seaweedfs_tpu/filer/reader_cache.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional


class _Flight:
    __slots__ = ("event", "value", "err")

    def __init__(self):
        self.event = threading.Event()
        self.value: Optional[bytes] = None
        self.err: Optional[BaseException] = None


class ReaderCache:
    def __init__(self, fetch_fn: Callable[[str], bytes], cache,
                 prefetch_workers: int = 4):
        """fetch_fn(fid) -> bytes does the real network fetch; cache is
        a TieredChunkCache (or anything with get/put)."""
        self.fetch = fetch_fn
        self.cache = cache
        self._lock = threading.Lock()
        self._inflight: dict[str, _Flight] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_workers = prefetch_workers
        self._closed = False
        # observability counters (cache-hit tests assert on these)
        self.hits = 0
        self.misses = 0
        self.joins = 0       # waiters coalesced onto another's fetch
        self.prefetches = 0  # background warms actually issued

    # ---- read path ----
    def get(self, fid: str) -> bytes:
        hit = self.cache.get(fid)
        if hit is not None:
            with self._lock:
                self.hits += 1
            return hit
        leader = False
        with self._lock:
            fl = self._inflight.get(fid)
            if fl is None:
                fl = _Flight()
                self._inflight[fid] = fl
                leader = True
                self.misses += 1
            else:
                self.joins += 1
        if leader:
            try:
                fl.value = self.fetch(fid)
                self.cache.put(fid, fl.value)
            except BaseException as e:
                fl.err = e
            finally:
                with self._lock:
                    self._inflight.pop(fid, None)
                fl.event.set()
            if fl.err is not None:
                raise fl.err
            return fl.value
        # join the in-flight download instead of fetching again
        if not fl.event.wait(timeout=60.0):
            # leader wedged: fetch independently, but park the result so
            # simultaneous timed-out waiters don't keep re-fetching
            value = self.fetch(fid)
            self.cache.put(fid, value)
            return value
        if fl.err is not None:
            raise fl.err
        return fl.value

    # ---- prefetch (reference reader_cache.go MaybeCache) ----
    def maybe_prefetch(self, fids: list[str]) -> None:
        """Queue background warms for upcoming chunks. Misses dedupe
        through the same single-flight table, so a prefetch racing a
        real read costs one download, not two."""
        for fid in fids:
            if self._cached_or_inflight(fid):
                continue
            with self._lock:
                if self._closed:
                    return
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=self._pool_workers,
                        thread_name_prefix="chunk-prefetch")
                self.prefetches += 1
                pool = self._pool  # submit under the lock: close()
                try:               # must not swap the pool mid-call
                    pool.submit(self._swallow, fid)
                except RuntimeError:
                    return  # pool shut down concurrently

    def _cached_or_inflight(self, fid: str) -> bool:
        with self._lock:
            if fid in self._inflight:
                return True
        contains = getattr(self.cache, "contains", None)
        if contains is not None:
            return contains(fid)
        return False

    def _swallow(self, fid: str) -> None:
        try:
            self.get(fid)
        except Exception:
            pass  # the foreground read will surface real errors

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
