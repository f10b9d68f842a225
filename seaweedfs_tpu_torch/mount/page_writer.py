"""Dirty-page write-back pipeline for the mount layer.

Redesign of reference weed/mount/page_writer (upload_pipeline.go:44-57,
dirty_pages_chunked.go, page_chunk_mem.go, page_chunk_swapfile.go):
the file is cut into fixed-size write chunks; each chunk tracks the
byte-ranges actually written in a sorted interval list; when the writer
moves on (or the handle is flushed) a chunk is *sealed* and each of its
contiguous dirty ranges is uploaded by a bounded worker pool. Only a
small number of chunks are RAM-backed — beyond that budget new chunks
are backed by slots in a per-handle swap file on local disk — so a file
of any size streams through a fixed memory footprint instead of being
buffered whole (the pre-round-4 behavior this replaces).

Coherency rules (mirroring upload_pipeline.go MaybeWaitForSealed):
- un-sealed dirty ranges overlay whatever the caller read from the
  filer (read-your-writes);
- a read that touches a range currently being uploaded waits for that
  upload, then sees it through the uploaded FileChunk list;
- re-writing a chunk index whose previous generation is still uploading
  waits for it, so chunk mtimes always increase in write order and the
  filer's newest-shadows-oldest rule (filechunks.go) stays correct.

The port's copy of seaweedfs_tpu/mount/page_writer.py; its swap files go
to the process's temp directory ($TMPDIR) unless given one. It imports
nothing of that package.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from seaweedfs_tpu_torch.filer.entry import FileChunk

# logical chunk written per upload; matches the filer's auto-chunk size
DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024
# chunks allowed to live in RAM per open handle before spilling
DEFAULT_MEM_CHUNKS = 4
# concurrent sealed-chunk uploads per handle
DEFAULT_CONCURRENCY = 4


class IntervalSet:
    """Sorted, coalesced set of written [start, stop) byte ranges inside
    one chunk (reference page_writer/chunk_interval_list.go)."""

    __slots__ = ("spans",)

    def __init__(self):
        self.spans: list[tuple[int, int]] = []

    def add(self, start: int, stop: int) -> None:
        if stop <= start:
            return
        out: list[tuple[int, int]] = []
        placed = False
        for s, e in self.spans:
            if e < start or s > stop:  # disjoint (touching ranges merge)
                if not placed and s > stop:
                    out.append((start, stop))
                    placed = True
                out.append((s, e))
            else:
                start, stop = min(s, start), max(e, stop)
        if not placed:
            out.append((start, stop))
            out.sort()
        self.spans = out

    def truncate(self, stop: int) -> None:
        self.spans = [(s, min(e, stop)) for s, e in self.spans if s < stop]

    def covered(self) -> int:
        return sum(e - s for s, e in self.spans)

    def overlaps(self, start: int, stop: int) -> list[tuple[int, int]]:
        return [(max(s, start), min(e, stop))
                for s, e in self.spans if e > start and s < stop]


class MemPageChunk:
    """RAM-backed page chunk."""

    def __init__(self, index: int, chunk_size: int):
        self.index = index
        self.chunk_size = chunk_size
        self.buf = bytearray(chunk_size)
        self.intervals = IntervalSet()
        self.last_write = 0.0
        self.in_ram = True

    def write(self, inner_off: int, data: bytes) -> None:
        self.buf[inner_off:inner_off + len(data)] = data
        self.intervals.add(inner_off, inner_off + len(data))
        self.last_write = time.monotonic()

    def read(self, inner_off: int, size: int) -> bytes:
        return bytes(self.buf[inner_off:inner_off + size])

    def release(self) -> None:
        self.buf = bytearray()


class SwapFile:
    """Slot allocator over one spill file shared by a pipeline
    (reference page_writer/page_chunk_swapfile.go). Slots are
    chunk_size-aligned and recycled when their chunk finishes
    uploading."""

    def __init__(self, path: str, chunk_size: int):
        self.path = path
        self.chunk_size = chunk_size
        self._free: list[int] = []
        self._next_slot = 0
        self._lock = threading.Lock()
        self._f = open(path, "w+b", buffering=0)
        # the file exists only as backing store for this handle
        try:
            os.unlink(path)
        except OSError:
            pass

    def alloc(self) -> int:
        with self._lock:
            if self._free:
                return self._free.pop()
            slot = self._next_slot
            self._next_slot += 1
            return slot

    def free(self, slot: int) -> None:
        with self._lock:
            self._free.append(slot)

    def pwrite(self, slot: int, inner_off: int, data: bytes) -> None:
        os.pwrite(self._f.fileno(), data,
                  slot * self.chunk_size + inner_off)

    def pread(self, slot: int, inner_off: int, size: int) -> bytes:
        got = os.pread(self._f.fileno(), size,
                       slot * self.chunk_size + inner_off)
        return got + b"\x00" * (size - len(got))

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class SwapPageChunk:
    """Disk-backed page chunk: same interface as MemPageChunk but the
    bytes live in a SwapFile slot, not RAM."""

    def __init__(self, index: int, swap: SwapFile):
        self.index = index
        self.chunk_size = swap.chunk_size
        self.swap = swap
        self.slot = swap.alloc()
        self.intervals = IntervalSet()
        self.last_write = 0.0
        self.in_ram = False

    def write(self, inner_off: int, data: bytes) -> None:
        self.swap.pwrite(self.slot, inner_off, data)
        self.intervals.add(inner_off, inner_off + len(data))
        self.last_write = time.monotonic()

    def read(self, inner_off: int, size: int) -> bytes:
        return self.swap.pread(self.slot, inner_off, size)

    def release(self) -> None:
        self.swap.free(self.slot)


class UploadPipeline:
    """Write-back pipeline for one open file handle.

    upload_fn(data, logical_offset, mtime_ns) -> FileChunk is supplied
    by the mount layer (it assigns a fid from the master and posts the
    payload to a volume server). Uploads run on a bounded executor; at
    most `concurrency` sealed chunks are in flight at once, so peak RAM
    is about (mem_chunks + concurrency) * chunk_size per handle.
    """

    def __init__(self, upload_fn: Callable[[bytes, int, int], FileChunk],
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 mem_chunks: int = DEFAULT_MEM_CHUNKS,
                 concurrency: int = DEFAULT_CONCURRENCY,
                 swap_dir: Optional[str] = None):
        self.upload_fn = upload_fn
        self.chunk_size = chunk_size
        self.mem_chunks = mem_chunks
        self.swap_dir = swap_dir or tempfile.gettempdir()
        self._swap: Optional[SwapFile] = None
        self._chunks: dict[int, object] = {}  # active: index -> chunk
        self._sealed: dict[int, object] = {}  # uploading: index -> chunk
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pool = ThreadPoolExecutor(max_workers=concurrency)
        self._inflight = threading.Semaphore(concurrency)
        self._futures: list = []
        self.uploaded: list[FileChunk] = []
        self._mtime_ns = 0
        self.mem_peak = 0  # high-water mark of RAM-backed active chunks

    # ---- write path ----
    def write(self, offset: int, data: bytes) -> int:
        n = len(data)
        pos = 0
        while pos < n:
            off = offset + pos
            idx, inner = divmod(off, self.chunk_size)
            take = min(n - pos, self.chunk_size - inner)
            self._chunk_for(idx).write(inner, data[pos:pos + take])
            pos += take
        self._maybe_seal_back()
        return n

    def _chunk_for(self, idx: int):
        with self._cond:
            # a previous generation of this index still uploading would
            # break mtime ordering — wait it out (rare: random re-write
            # of a range that just got sealed)
            while idx in self._sealed:
                self._cond.wait()
            ch = self._chunks.get(idx)
            if ch is None:
                in_ram = sum(1 for c in self._chunks.values() if c.in_ram)
                if in_ram < self.mem_chunks:
                    ch = MemPageChunk(idx, self.chunk_size)
                    self.mem_peak = max(self.mem_peak, in_ram + 1)
                else:
                    if self._swap is None:
                        self._swap = SwapFile(
                            os.path.join(self.swap_dir,
                                         f".weed-swap-{id(self)}-"
                                         f"{os.getpid()}"),
                            self.chunk_size)
                    ch = SwapPageChunk(idx, self._swap)
                self._chunks[idx] = ch
            return ch

    def _maybe_seal_back(self) -> None:
        """Seal every fully-written chunk and, past the active-chunk
        budget, the least-recently-written partial ones too (reference
        upload_pipeline.go SaveDataAt -> MoveToSealed)."""
        to_seal = []
        with self._lock:
            live = sorted(self._chunks.values(),
                          key=lambda c: c.last_write)
            hottest = live[-1] if live else None
            keep = []
            for ch in live:
                full = ch.intervals.covered() == ch.chunk_size
                if full and ch is not hottest:
                    to_seal.append(ch)
                else:
                    keep.append(ch)
            # too many actives: seal coldest partial chunks as well
            budget = self.mem_chunks + 2
            while len(keep) > budget and keep[0] is not hottest:
                to_seal.append(keep.pop(0))
            for ch in to_seal:
                del self._chunks[ch.index]
                self._sealed[ch.index] = ch
        for ch in to_seal:
            self._seal(ch)

    def _seal(self, ch) -> None:
        """Queue each contiguous dirty range of a chunk for upload.
        Caller must already have moved `ch` from _chunks to _sealed."""
        base = ch.index * self.chunk_size
        with self._lock:
            self._mtime_ns = max(self._mtime_ns + 1, time.time_ns())
            mtime = self._mtime_ns
        spans = list(ch.intervals.spans)

        def job():
            try:
                done = []
                for s, e in spans:
                    payload = ch.read(s, e - s)
                    fc = self.upload_fn(payload, base + s, mtime)
                    if fc.mtime_ns == 0:
                        fc.mtime_ns = mtime
                    done.append(fc)
                with self._cond:
                    self.uploaded.extend(done)
                    self._sealed.pop(ch.index, None)
                    self._cond.notify_all()
            except BaseException:
                with self._cond:
                    self._sealed.pop(ch.index, None)
                    self._cond.notify_all()
                raise
            finally:
                ch.release()
                self._inflight.release()

        self._inflight.acquire()
        self._futures.append(self._pool.submit(job))

    # ---- read-your-writes ----
    def wait_for_inflight(self, offset: int, stop: int) -> None:
        """Block until no in-flight upload overlaps [offset, stop) —
        afterwards that data is visible via `uploaded`."""
        with self._cond:
            def clear():
                for ch in self._sealed.values():
                    base = ch.index * self.chunk_size
                    if base < stop and base + ch.chunk_size > offset:
                        return False
                return True
            while not clear():
                self._cond.wait()

    def uploaded_snapshot(self) -> list[FileChunk]:
        with self._lock:
            return list(self.uploaded)

    def has_uploads(self) -> bool:
        """True once anything was sealed or uploaded — i.e. the file's
        bytes no longer live wholly in the active dirty pages."""
        with self._lock:
            return bool(self.uploaded or self._sealed or self._futures)

    def overlay(self, buf: bytearray, offset: int) -> None:
        """Patch active (un-sealed) dirty ranges over `buf`, which the
        caller filled from the filer view of [offset, offset+len(buf))."""
        stop = offset + len(buf)
        with self._lock:
            chunks = list(self._chunks.values())
        for ch in chunks:
            base = ch.index * self.chunk_size
            if base >= stop or base + ch.chunk_size <= offset:
                continue
            lo = max(offset, base) - base
            hi = min(stop, base + ch.chunk_size) - base
            for s, e in ch.intervals.overlaps(lo, hi):
                buf[base + s - offset:base + e - offset] = ch.read(s, e - s)

    def truncate(self, size: int) -> None:
        """Drop dirty data beyond `size`; already-uploaded chunks are
        clamped (the entry's file_size clamps reads as well)."""
        self.wait_for_inflight(0, 1 << 62)
        with self._lock:
            for idx in list(self._chunks):
                ch = self._chunks[idx]
                base = idx * self.chunk_size
                if base >= size:
                    ch.release()
                    del self._chunks[idx]
                else:
                    ch.intervals.truncate(size - base)
            for fc in self.uploaded:
                if fc.offset + fc.size > size:
                    fc.size = max(0, size - fc.offset)
            self.uploaded = [fc for fc in self.uploaded if fc.size > 0]

    # ---- flush / close ----
    def flush(self) -> list[FileChunk]:
        """Seal everything, wait for all uploads, return (and clear) the
        uploaded chunk list."""
        with self._lock:
            pending = []
            for i in sorted(self._chunks):
                ch = self._chunks.pop(i)
                self._sealed[i] = ch
                pending.append(ch)
        for ch in pending:
            self._seal(ch)
        futures, self._futures = self._futures, []
        err = None
        for f in futures:
            try:
                f.result()  # surface upload errors on the flushing thread
            except BaseException as e:  # keep draining, then re-raise
                err = err or e
        if err is not None:
            raise err
        with self._lock:
            out, self.uploaded = self.uploaded, []
        return out

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        with self._lock:
            for ch in self._chunks.values():
                ch.release()
            self._chunks.clear()
        if self._swap is not None:
            self._swap.close()
            self._swap = None
