"""Chunk overlap resolution: chunks -> visible intervals -> read views.

Functional equivalent of reference weed/filer/filechunks.go: when a file is
overwritten at arbitrary offsets, newer chunks (by mtime) shadow older
ones; readers resolve the chunk list into non-overlapping VisibleIntervals
and then into per-request ChunkViews.

The port's copy of seaweedfs_tpu/filer/filechunks.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import dataclasses

from seaweedfs_tpu_torch.filer.entry import FileChunk


@dataclasses.dataclass
class VisibleInterval:
    start: int
    stop: int
    fid: str
    mtime_ns: int
    chunk_offset: int  # offset of `start` within the chunk
    chunk_size: int


@dataclasses.dataclass
class ChunkView:
    fid: str
    offset_in_chunk: int  # where to start reading inside the chunk data
    size: int
    logic_offset: int  # where this lands in the file


def non_overlapping_visible_intervals(chunks: list[FileChunk]
                                      ) -> list[VisibleInterval]:
    """Sort by mtime ascending and layer newer chunks over older ones."""
    visibles: list[VisibleInterval] = []
    for chunk in sorted(chunks, key=lambda c: (c.mtime_ns, c.fid)):
        visibles = _merge_into_visibles(visibles, chunk)
    return visibles


def _merge_into_visibles(visibles: list[VisibleInterval],
                         chunk: FileChunk) -> list[VisibleInterval]:
    new_v = VisibleInterval(
        start=chunk.offset, stop=chunk.offset + chunk.size, fid=chunk.fid,
        mtime_ns=chunk.mtime_ns, chunk_offset=0, chunk_size=chunk.size)
    out: list[VisibleInterval] = []
    for v in visibles:
        if v.stop <= new_v.start or v.start >= new_v.stop:
            out.append(v)
            continue
        # left remnant
        if v.start < new_v.start:
            out.append(VisibleInterval(
                start=v.start, stop=new_v.start, fid=v.fid,
                mtime_ns=v.mtime_ns, chunk_offset=v.chunk_offset,
                chunk_size=v.chunk_size))
        # right remnant
        if v.stop > new_v.stop:
            out.append(VisibleInterval(
                start=new_v.stop, stop=v.stop, fid=v.fid,
                mtime_ns=v.mtime_ns,
                chunk_offset=v.chunk_offset + (new_v.stop - v.start),
                chunk_size=v.chunk_size))
    out.append(new_v)
    out.sort(key=lambda v: v.start)
    return out


def view_from_visibles(visibles: list[VisibleInterval], offset: int,
                       size: int) -> list[ChunkView]:
    """Slice the visible intervals to a read range."""
    stop = offset + size
    views: list[ChunkView] = []
    for v in visibles:
        if v.stop <= offset or v.start >= stop:
            continue
        lo = max(offset, v.start)
        hi = min(stop, v.stop)
        views.append(ChunkView(
            fid=v.fid,
            offset_in_chunk=v.chunk_offset + (lo - v.start),
            size=hi - lo,
            logic_offset=lo))
    return views


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)
