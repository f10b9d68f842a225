"""EC encode/rebuild: .dat -> .ec00...ec13, .idx -> .ecx.

Functional equivalent of reference weed/storage/erasure_coding/ec_encoder.go
and of seaweedfs_tpu's encoder: multi-megabyte column-aligned batches
stream through an ErasureCoder (by default the card coder). The on-disk
layout is bit-identical (see layout.py).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from seaweedfs_tpu_torch.models.coder import ErasureCoder, make_coder
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.storage.needle_map import MemDb
from seaweedfs_tpu_torch.storage.super_block import SuperBlock

# Batch of bytes PER SHARD pushed through the coder in one serial step.
DEFAULT_BATCH_SIZE = 4 * 1024 * 1024


def detect_offset_bytes(base_path: str) -> int:
    """Offset width of a volume from its superblock marker (volumes
    created with offset_bytes=5 carry b"5BO" in the extra field)."""
    from seaweedfs_tpu_torch.storage.volume import Volume
    try:
        with open(base_path + ".dat", "rb") as f:
            sb = SuperBlock.parse(f.read(8 + 65536))
        return 5 if sb.extra == Volume._WIDE_OFFSET_MARKER else 4
    except (OSError, ValueError):
        return 4


def write_sorted_ecx(base_file_name: str, ext: str = ".ecx") -> None:
    """Generate .ecx (entries ascending by needle id) from .idx
    (reference ec_encoder.go:27-54). The .ecx format is fixed at 16-byte
    entries, so a wide-offset (5-byte) volume's .idx is parsed at its own
    stride and rejected if any offset cannot fit 4 bytes."""
    width = detect_offset_bytes(base_file_name)
    db = MemDb.load_from_idx(base_file_name + ".idx", width)
    with open(base_file_name + ext, "wb") as f:
        def emit(key, off, size):
            if off >= 1 << 32:
                raise ValueError(
                    f"needle {key:x} offset {off} exceeds the 4-byte .ecx "
                    "entry format; volume too large to EC-encode")
            f.write(t.pack_entry(key, off, size))
        db.ascending_visit(emit)


def plan_rebuild_sources(coder: ErasureCoder, present, missing):
    """(src_sids, rebuild_mat) for a local rebuild, or (None, None) when
    the coder only speaks the bytes API. Coders with plan_rebuild (LRC)
    choose the cheapest source set — a single-group loss reads the ~5
    surviving group members; rebuild_matrix coders (RS) read the first
    data_shards survivors after dropping all-zero matrix columns."""
    if hasattr(coder, "plan_rebuild"):
        return coder.plan_rebuild(present, missing)
    if hasattr(coder, "rebuild_matrix"):
        k = coder.scheme.data_shards
        src = sorted(present)[:k]
        rmat = np.asarray(coder.rebuild_matrix(present, missing))
        used = [j for j in range(len(src)) if rmat[:, j].any()] or [0]
        return ([src[j] for j in used],
                np.ascontiguousarray(rmat[:, used]))
    return None, None


def _read_block(f, offset: int, length: int) -> np.ndarray:
    """ReadAt with implicit zero-fill past EOF (encodeDataOneBatch
    semantics, ec_encoder.go:172-176)."""
    f.seek(offset)
    buf = f.read(length)
    out = np.zeros(length, dtype=np.uint8)
    if buf:
        out[:len(buf)] = np.frombuffer(buf, dtype=np.uint8)
    return out


def write_ec_files(base_file_name: str, coder: Optional[ErasureCoder] = None,
                   large_block: int = layout.LARGE_BLOCK_SIZE,
                   small_block: int = layout.SMALL_BLOCK_SIZE,
                   batch_size: int = DEFAULT_BATCH_SIZE,
                   pipelined: bool = False,
                   readers: int = 1,
                   stats: Optional[dict] = None) -> None:
    """Encode <base>.dat into <base>.ec00 .. .ec13 (WriteEcFiles
    equivalent, reference ec_encoder.go:56-59,194-231). coder=None takes
    the card coder. pipelined=True runs parallel/streaming.py's staged
    pipeline (same bits on disk — both walk layout.iter_encode_batches).
    Shards are written to .tmp names and renamed into place."""
    coder = coder or make_coder()
    if pipelined:
        from seaweedfs_tpu_torch.parallel import streaming
        streaming.pipelined_encode_file(
            base_file_name, coder.scheme, large_block, small_block,
            batch_size, coder=coder, readers=readers, stats=stats)
        return
    from seaweedfs_tpu_torch.parallel.streaming import AtomicFileGroup
    k = coder.scheme.data_shards
    total = coder.scheme.total_shards
    dat_path = base_file_name + ".dat"
    dat_size = os.path.getsize(dat_path)

    outs = AtomicFileGroup([base_file_name + layout.shard_ext(i)
                            for i in range(total)])
    try:
        with open(dat_path, "rb") as f:
            for row_off, block, b, step in layout.iter_encode_batches(
                    dat_size, large_block, small_block, batch_size, k):
                data = np.stack([
                    _read_block(f, row_off + i * block + b, step)
                    for i in range(k)])
                parity = np.asarray(coder.encode_array(data))
                for i in range(k):
                    outs.files[i].write(data[i].tobytes())
                for i in range(parity.shape[0]):
                    outs.files[k + i].write(parity[i].tobytes())
    except BaseException:
        outs.discard()
        raise
    outs.commit()


def rebuild_ec_files(base_file_name: str, coder: Optional[ErasureCoder] = None,
                     batch_size: int = DEFAULT_BATCH_SIZE,
                     pipelined: bool = False,
                     stats: Optional[dict] = None) -> list[int]:
    """Regenerate missing .ecNN files from the survivors (RebuildEcFiles
    equivalent, reference ec_encoder.go:61-63,233-287). Returns generated
    shard ids. coder=None takes the card coder. Requires >= data_shards
    survivors; all shard files have equal size by construction."""
    coder = coder or make_coder()
    if pipelined:
        from seaweedfs_tpu_torch.parallel import streaming
        return streaming.pipelined_rebuild_files(
            base_file_name, coder, batch_size, stats=stats)
    total = coder.scheme.total_shards
    k = coder.scheme.data_shards

    present = [i for i in range(total)
               if os.path.exists(base_file_name + layout.shard_ext(i))]
    missing = [i for i in range(total) if i not in present]
    if not missing:
        return []
    if len(present) < k and not hasattr(coder, "plan_rebuild"):
        # a plan-capable coder (LRC) may repair a group loss from fewer
        # than k survivors; its plan raises if truly unrecoverable
        raise ValueError(f"need {k} shards, have {len(present)}")

    src, rmat = plan_rebuild_sources(coder, present, missing)
    shard_size = os.path.getsize(base_file_name + layout.shard_ext(present[0]))
    read_ids = src if src is not None else present
    ins = {i: open(base_file_name + layout.shard_ext(i), "rb")
           for i in read_ids}
    outs = {i: open(base_file_name + layout.shard_ext(i), "wb")
            for i in missing}
    read_bytes = 0
    try:
        for off in range(0, shard_size, batch_size):
            n = min(batch_size, shard_size - off)
            if src is not None:
                rows = np.empty((len(src), n), dtype=np.uint8)
                for r, i in enumerate(src):
                    ins[i].seek(off)
                    rows[r] = np.frombuffer(ins[i].read(n), dtype=np.uint8)
                read_bytes += n * len(src)
                rec = coder.reconstruct_rows(rows, rmat)
                for r, i in enumerate(missing):
                    outs[i].write(rec[r].tobytes())
            else:
                # a bytes-only coder: reconstruct_arrays' seam default
                have = {}
                for i in present:
                    ins[i].seek(off)
                    have[i] = np.frombuffer(ins[i].read(n), dtype=np.uint8)
                read_bytes += n * len(present)
                full = coder.reconstruct_arrays(have, n)
                for i in missing:
                    outs[i].write(np.asarray(full[i]).tobytes())
    finally:
        for fh in ins.values():
            fh.close()
        for fh in outs.values():
            fh.close()
    if stats is not None:
        stats["read_bytes"] = stats.get("read_bytes", 0) + read_bytes
        stats["rebuilt_bytes"] = stats.get("rebuilt_bytes", 0) \
            + shard_size * len(missing)
        stats["sources"] = list(read_ids)
    return missing


def rebuild_ecx_file(base_file_name: str) -> None:
    """Re-apply .ecj tombstones to .ecx then remove the journal
    (reference ec_volume_delete.go:51-98 RebuildEcxFile)."""
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import (
        NotFoundError, iterate_ecj_file, mark_needle_deleted,
        search_needle_from_sorted_index)
    ecj = base_file_name + ".ecj"
    if not os.path.exists(ecj):
        return
    with open(base_file_name + ".ecx", "r+b") as ecx:
        ecx_size = os.path.getsize(base_file_name + ".ecx")
        for needle_id in iterate_ecj_file(base_file_name):
            try:
                search_needle_from_sorted_index(ecx, ecx_size, needle_id,
                                                mark_needle_deleted)
            except NotFoundError:
                pass
    os.remove(ecj)
