""".idx / .ecx index-file walking (16-byte entries).

Matches reference weed/storage/idx/walk.go — an index file is a flat
sequence of (needle_id u64, offset u32 in 8-byte units, size i32) entries,
big-endian. The same format is used sorted-by-id for .ecx files.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Callable, Iterator

from seaweedfs_tpu_torch.storage import types as t


def iter_index(f: BinaryIO | bytes | str,
               offset_bytes: int = 4) -> Iterator[tuple[int, int, int]]:
    """Yield (key, offset_units, size) for every entry."""
    if isinstance(f, str):
        with open(f, "rb") as fh:
            yield from iter_index(fh, offset_bytes)
        return
    if isinstance(f, (bytes, bytearray)):
        f = io.BytesIO(f)
    esize = t.entry_size(offset_bytes)
    while True:
        buf = f.read(esize * 1024)
        if not buf:
            return
        for off in range(0, len(buf) - esize + 1, esize):
            yield t.unpack_entry(buf, off, offset_bytes)


def walk_index_file(path: str, fn: Callable[[int, int, int], None],
                    start_from: int = 0, offset_bytes: int = 4) -> None:
    with open(path, "rb") as f:
        f.seek(start_from * t.entry_size(offset_bytes))
        for key, off, size in iter_index(f, offset_bytes):
            fn(key, off, size)


