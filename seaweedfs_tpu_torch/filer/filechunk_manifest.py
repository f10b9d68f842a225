"""Manifest chunks: metadata for very-wide files.

Functional equivalent of reference weed/filer/filechunk_manifest.go: when
a file accumulates more than ManifestBatch chunks, the chunk list itself
is packed into batches, each batch serialized and stored as a regular
blob on the volume servers, and the entry keeps only the small manifest
chunks (recursively — a manifest of manifests for truly huge files).
Readers expand manifests back into the leaf chunk list before resolving
visible intervals.

The port's copy of seaweedfs_tpu/filer/filechunk_manifest.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import json
import time
from typing import Callable

from seaweedfs_tpu_torch.filer.entry import FileChunk

# reference filechunk_manifest.go: const ManifestBatch = 10000; kept
# smaller here — each of our chunk records is a few hundred JSON bytes.
MANIFEST_BATCH = 1000

# stores a blob, returns the saved chunk (fid + cipher_key if encrypted)
SaveFn = Callable[[bytes], FileChunk]
ReadFn = Callable[[FileChunk], bytes]  # chunk -> plaintext blob


def has_chunk_manifest(chunks: list[FileChunk]) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def maybe_manifestize(save_fn: SaveFn, chunks: list[FileChunk],
                      batch: int = MANIFEST_BATCH) -> list[FileChunk]:
    """Collapse wide chunk lists into manifest chunks, recursively, until
    the entry-level list is at most `batch` long (reference
    MaybeManifestize / doMaybeManifestize)."""
    while len(chunks) > batch:
        chunks = sorted(chunks, key=lambda c: c.offset)
        packed: list[FileChunk] = []
        for i in range(0, len(chunks), batch):
            group = chunks[i:i + batch]
            if len(group) == 1:
                packed.append(group[0])
                continue
            blob = json.dumps(
                {"chunks": [c.to_dict() for c in group]}).encode()
            saved = save_fn(blob)
            offset = min(c.offset for c in group)
            stop = max(c.offset + c.size for c in group)
            packed.append(FileChunk(
                fid=saved.fid, offset=offset, size=stop - offset,
                cipher_key=saved.cipher_key,
                mtime_ns=max(c.mtime_ns for c in group),
                is_chunk_manifest=True))
        chunks = packed
    return chunks


def resolve_chunk_manifest(read_fn: ReadFn,
                           chunks: list[FileChunk]) -> list[FileChunk]:
    """Expand manifest chunks (recursively) into the leaf chunk list
    (reference ResolveChunkManifest)."""
    out: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        blob = read_fn(c)
        nested = [FileChunk.from_dict(d)
                  for d in json.loads(blob)["chunks"]]
        out.extend(resolve_chunk_manifest(read_fn, nested))
    return out
