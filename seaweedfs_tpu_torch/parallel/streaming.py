"""Staged EC pipelines: overlapped read -> code -> write for whole volumes.

The port of seaweedfs_tpu/parallel/streaming.py. ec.encode streams
column-aligned batches disk -> host -> card with reader threads prefetching
batch N+1 while the coder works on batch N and a writer thread drains batch
N-1 to the shard files; ec.rebuild streams survivor batches the same way.

On a CUDA coder each batch goes through the device lane: its host buffers
are pinned, so the copy to the card, the kernel and the copy back are all
enqueued on a side CUDA stream without blocking the coder stage, and a CUDA
event recorded after the copy back is what the writer waits on before it
touches the output. An input buffer goes back to the pool only after that
event, i.e. after its copy to the card has completed — recycling it earlier
would let the reader overwrite bytes the copy has not read yet. A coder on
the CPU encodes in the coder stage itself.

Stage plumbing invariants:
  - every inter-stage queue is BOUNDED (maxsize=prefetch): a slow writer
    backpressures the coder, a slow coder backpressures the readers, so
    peak memory is O(prefetch * batch) regardless of volume size;
  - a failing stage records its exception in the _Pipeline and trips the
    shared abort event; every blocking put/get polls that event, so all
    threads unwind promptly and the first error is re-raised to the caller;
  - shard outputs go to `.tmp` names and are renamed into place only after
    every stage has finished cleanly — an interrupted pipeline never
    leaves a truncated file under a final shard name;
  - buffers are pooled and recycled writer -> reader, so steady-state
    allocation is zero.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from seaweedfs_tpu_torch.models.coder import (DEFAULT_SCHEME, ErasureCoder,
                                              RSScheme, make_coder)
from seaweedfs_tpu_torch.storage.erasure_coding import layout

DEFAULT_PIPE_BATCH = 16 * 1024 * 1024


class PipelineError(RuntimeError):
    """A pipeline stage failed; the original exception is the __cause__."""


class _Aborted(Exception):
    """Internal control flow: the shared abort event tripped."""


class _Pipeline:
    """Shared failure state for one pipeline run: first-error capture plus
    an abort event that every blocking queue operation polls."""

    _POLL = 0.05

    def __init__(self):
        self.abort = threading.Event()
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._threads: list[threading.Thread] = []

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = exc
        self.abort.set()

    def check(self) -> None:
        if self._error is not None:
            raise PipelineError(
                f"pipeline stage failed: {self._error!r}") from self._error

    def put(self, q: "queue.Queue", item) -> None:
        while True:
            if self.abort.is_set():
                raise _Aborted()
            try:
                q.put(item, timeout=self._POLL)
                return
            except queue.Full:
                continue

    def get(self, q: "queue.Queue"):
        while True:
            if self.abort.is_set():
                raise _Aborted()
            try:
                return q.get(timeout=self._POLL)
            except queue.Empty:
                continue

    def spawn(self, fn, *args) -> threading.Thread:
        """Run fn(*args) in a daemon thread; any exception trips abort."""
        def run():
            try:
                fn(*args)
            except _Aborted:
                pass
            except BaseException as e:  # noqa: BLE001 — must reach caller
                self.fail(e)
        t = threading.Thread(target=run, daemon=True, name="ec-stream")
        t.start()
        self._threads.append(t)
        return t

    def join(self) -> None:
        for t in self._threads:
            t.join()
        self.check()


class _BufferPool:
    """Recycles equal-shaped uint8 host arrays writer -> reader. get()
    allocates on a shape change (large rows -> small-row tail). With
    pin=True new arrays are views of page-locked torch tensors (the
    array keeps its tensor alive), so copies to and from the card run
    asynchronously."""

    def __init__(self, pin: bool = False):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.pin = pin

    def get(self, shape: tuple[int, ...]) -> np.ndarray:
        try:
            while True:
                buf = self._q.get_nowait()
                if buf.shape == shape:
                    return buf
                # stale shape from a previous block tier — drop it
        except queue.Empty:
            if self.pin:
                return torch.empty(shape, dtype=torch.uint8,
                                   pin_memory=True).numpy()
            return np.empty(shape, dtype=np.uint8)

    def put(self, buf: np.ndarray) -> None:
        self._q.put(buf)


class _DeviceLane:
    """One batch through the card: copy in, gf_apply kernel, copy out, all
    on a side CUDA stream. run() returns the event recorded after the copy
    out; until it completes neither host buffer may be touched."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def run(self, mat: np.ndarray, host_in: np.ndarray,
            host_out: np.ndarray) -> torch.cuda.Event:
        from seaweedfs_tpu_torch.ops import rs_cuda
        with torch.cuda.stream(self.stream):
            src = torch.from_numpy(host_in).to(self.device, non_blocking=True)
            res = rs_cuda.gf_apply(mat, src)
            torch.from_numpy(host_out).copy_(res, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return done


def _device_lane(coder: ErasureCoder) -> Optional[_DeviceLane]:
    device = getattr(coder, "device", None)
    if isinstance(device, torch.device) and device.type == "cuda":
        return _DeviceLane(device)
    return None


class AtomicFileGroup:
    """A set of output files written under `.tmp` names and renamed into
    place together on commit(). discard() removes the temporaries; either
    way no truncated file is ever visible under a final name."""

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)
        self._tmps = [p + ".tmp" for p in self.paths]
        self.files = [open(t, "wb") for t in self._tmps]
        self._open = True

    def _close(self) -> None:
        if self._open:
            for f in self.files:
                f.close()
            self._open = False

    def commit(self) -> None:
        self._close()
        for tmp, final in zip(self._tmps, self.paths):
            os.replace(tmp, final)

    def discard(self) -> None:
        self._close()
        for tmp in self._tmps:
            try:
                os.remove(tmp)
            except OSError:
                pass


def _merge_stats(stats: Optional[dict], lock: threading.Lock,
                 **deltas) -> None:
    if stats is None:
        return
    with lock:
        for key, v in deltas.items():
            stats[key] = stats.get(key, 0) + v


def _read_rows(f, buf: np.ndarray, desc, k: int) -> None:
    """Fill buf (k, step) with the descriptor's per-shard slices of the
    .dat, zero-filling past EOF (encodeDataOneBatch semantics)."""
    row_off, block, b, step = desc
    for i in range(k):
        f.seek(row_off + i * block + b)
        got = f.readinto(memoryview(buf[i]))
        if got < step:
            buf[i, got:] = 0


def _writer_stage(pl: _Pipeline, write_q: "queue.Queue", files: list,
                  in_pool: _BufferPool, out_pool: _BufferPool,
                  write_inputs: bool, stats: Optional[dict],
                  slock: threading.Lock) -> None:
    """Drain (inputs, outputs, event) items: wait for the batch's event,
    write (the inputs, when encoding, then) the outputs in shard order,
    then recycle both buffers."""
    busy = wait = 0.0
    while True:
        item = pl.get(write_q)
        if item is None:
            break
        data, out, done = item
        t0 = time.monotonic()
        if done is not None:
            done.synchronize()
        t1 = time.monotonic()
        rows = [*data, *out] if write_inputs else list(out)
        for f, row in zip(files, rows):
            f.write(row)
        busy += time.monotonic() - t1
        wait += t1 - t0
        in_pool.put(data)
        out_pool.put(out)
    _merge_stats(stats, slock, write_s=busy, device_wait_s=wait)


def pipelined_encode_file(base_file_name: str,
                          scheme: RSScheme = DEFAULT_SCHEME,
                          large_block: int = layout.LARGE_BLOCK_SIZE,
                          small_block: int = layout.SMALL_BLOCK_SIZE,
                          batch_size: int = DEFAULT_PIPE_BATCH,
                          prefetch: int = 2,
                          coder: Optional[ErasureCoder] = None,
                          readers: int = 1,
                          stats: Optional[dict] = None) -> None:
    """write_ec_files as a staged pipeline; identical on-disk output.

    coder=None takes the card coder (make_coder(), which raises when no
    CUDA device is present). `stats`, when a dict, receives per-stage busy
    seconds (read_s / encode_s / write_s / device_wait_s), wall_s,
    bytes_in and batches."""
    if coder is None:
        coder = make_coder(scheme=scheme)
    scheme = coder.scheme
    k = scheme.data_shards
    total = scheme.total_shards
    m = total - k
    dat_path = base_file_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    descs = list(layout.iter_encode_batches(dat_size, large_block,
                                            small_block, batch_size, k))
    readers = max(1, min(readers, len(descs) or 1))
    lane = _device_lane(coder)

    pl = _Pipeline()
    read_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    write_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    data_pool = _BufferPool(pin=lane is not None)
    parity_pool = _BufferPool(pin=lane is not None)
    slock = threading.Lock()
    wall0 = time.monotonic()

    def reader_stage(rid: int):
        busy = 0.0
        with open(dat_path, "rb") as f:
            for seq in range(rid, len(descs), readers):
                t0 = time.monotonic()
                buf = data_pool.get((k, descs[seq][3]))
                _read_rows(f, buf, descs[seq], k)
                busy += time.monotonic() - t0
                pl.put(read_q, (seq, buf))
        _merge_stats(stats, slock, read_s=busy)

    outs = AtomicFileGroup([base_file_name + layout.shard_ext(i)
                            for i in range(total)])
    try:
        writer_t = pl.spawn(_writer_stage, pl, write_q, outs.files,
                            data_pool, parity_pool, True, stats, slock)
        for rid in range(readers):
            pl.spawn(reader_stage, rid)

        encode_busy = 0.0
        stash: dict[int, np.ndarray] = {}
        for expected in range(len(descs)):
            while expected not in stash:
                seq, buf = pl.get(read_q)
                stash[seq] = buf
            data = stash.pop(expected)
            t0 = time.monotonic()
            pbuf = parity_pool.get((m, data.shape[1]))
            done = None
            if lane is not None:
                done = lane.run(coder.parity, data, pbuf)
            else:
                coder.encode_into(data, pbuf)
            encode_busy += time.monotonic() - t0
            pl.put(write_q, (data, pbuf, done))
        pl.put(write_q, None)
        writer_t.join()
        pl.join()
        _merge_stats(stats, slock, encode_s=encode_busy,
                     wall_s=time.monotonic() - wall0,
                     bytes_in=dat_size, batches=len(descs))
        outs.commit()
    except _Aborted:
        # a stage failed and tripped abort while the main thread blocked;
        # surface the stage's exception, not the control-flow marker
        _unwind(pl, outs)
    except BaseException:
        pl.abort.set()
        _unwind(pl, outs, reraise=False)
        raise


def _unwind(pl: _Pipeline, outs: "AtomicFileGroup",
            reraise: bool = True) -> None:
    for t in pl._threads:
        t.join(timeout=5)
    outs.discard()
    if reraise:
        pl.check()
        raise PipelineError("pipeline aborted without a recorded error")


def pipelined_rebuild_files(base_file_name: str,
                            coder: Optional[ErasureCoder] = None,
                            batch_size: int = DEFAULT_PIPE_BATCH,
                            prefetch: int = 2,
                            stats: Optional[dict] = None) -> list[int]:
    """Regenerate missing .ecNN files from survivors with overlapped
    shard reads, GF reconstruction and writes. Returns generated ids.

    coder=None takes the card coder. The coefficient matrix mapping the
    first k surviving shards to every missing shard is computed ONCE
    (rebuild_matrix) and streamed over the batches."""
    from seaweedfs_tpu_torch.storage.erasure_coding.encoder import \
        plan_rebuild_sources
    if coder is None:
        coder = make_coder()
    k = coder.scheme.data_shards
    total = coder.scheme.total_shards
    present = [i for i in range(total)
               if os.path.exists(base_file_name + layout.shard_ext(i))]
    missing = [i for i in range(total) if i not in present]
    if not missing:
        return []
    if len(present) < k:
        raise ValueError(f"need {k} shards, have {len(present)}")
    src, rmat = plan_rebuild_sources(coder, present, missing)
    n_src = len(src)

    shard_size = os.path.getsize(base_file_name + layout.shard_ext(src[0]))
    offs = list(range(0, shard_size, batch_size))
    lane = _device_lane(coder)

    pl = _Pipeline()
    read_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    write_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    data_pool = _BufferPool(pin=lane is not None)
    out_pool = _BufferPool(pin=lane is not None)
    slock = threading.Lock()
    wall0 = time.monotonic()

    def reader_stage():
        busy = 0.0
        ins = [open(base_file_name + layout.shard_ext(i), "rb") for i in src]
        try:
            for off in offs:
                n = min(batch_size, shard_size - off)
                t0 = time.monotonic()
                buf = data_pool.get((n_src, n))
                for r, f in enumerate(ins):
                    f.seek(off)
                    got = f.readinto(memoryview(buf[r]))
                    if got < n:
                        raise IOError(
                            f"short read on {base_file_name}"
                            f"{layout.shard_ext(src[r])} at {off}")
                busy += time.monotonic() - t0
                pl.put(read_q, buf)
            pl.put(read_q, None)
        finally:
            for f in ins:
                f.close()
        _merge_stats(stats, slock, read_s=busy)

    outs = AtomicFileGroup([base_file_name + layout.shard_ext(i)
                            for i in missing])
    try:
        writer_t = pl.spawn(_writer_stage, pl, write_q, outs.files,
                            data_pool, out_pool, False, stats, slock)
        pl.spawn(reader_stage)
        busy = 0.0
        while True:
            buf = pl.get(read_q)
            if buf is None:
                break
            t0 = time.monotonic()
            rec = out_pool.get((len(missing), buf.shape[1]))
            done = None
            if lane is not None:
                done = lane.run(rmat, buf, rec)
            else:
                coder.reconstruct_rows(buf, rmat, rec)
            busy += time.monotonic() - t0
            pl.put(write_q, (buf, rec, done))
        pl.put(write_q, None)
        writer_t.join()
        pl.join()
        _merge_stats(stats, slock, encode_s=busy,
                     wall_s=time.monotonic() - wall0,
                     bytes_in=shard_size * n_src, batches=len(offs),
                     rebuilt_bytes=shard_size * len(missing))
        if stats is not None:
            with slock:
                stats["sources"] = list(src)
        outs.commit()
    except _Aborted:
        _unwind(pl, outs)
    except BaseException:
        pl.abort.set()
        _unwind(pl, outs, reraise=False)
        raise
    return missing
