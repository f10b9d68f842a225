"""EC decode: .ec00-.ec09 -> .dat, .ecx/.ecj -> .idx.

Functional equivalent of reference weed/storage/erasure_coding/ec_decoder.go.
"""

from __future__ import annotations

import os
import shutil

from seaweedfs_tpu_torch.storage import idx as idxmod
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.erasure_coding import layout

_COPY_CHUNK = 8 * 1024 * 1024


def write_idx_file_from_ec_index(base_file_name: str) -> None:
    """.idx = copy of .ecx + a tombstone entry per .ecj journal id
    (reference ec_decoder.go:18-43)."""
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import iterate_ecj_file
    shutil.copyfile(base_file_name + ".ecx", base_file_name + ".idx")
    with open(base_file_name + ".idx", "ab") as f:
        for key in iterate_ecj_file(base_file_name):
            f.write(t.pack_entry(key, 0, t.TOMBSTONE_FILE_SIZE))


def find_dat_file_size(data_base_file_name: str,
                       index_base_file_name: str) -> int:
    """Derive original .dat size from the max live .ecx entry
    (reference ec_decoder.go:48-70)."""
    version = read_ec_volume_version(data_base_file_name)
    dat_size = 0
    for key, off, size in idxmod.iter_index(index_base_file_name + ".ecx"):
        if t.size_is_deleted(size):
            continue
        stop = t.offset_to_actual(off) + t.get_actual_size(size, version)
        dat_size = max(dat_size, stop)
    return dat_size


def read_ec_volume_version(base_file_name: str) -> int:
    """Volume version from the superblock at the head of .ec00 (the first
    bytes of the .dat are the superblock and land in shard 0)."""
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock
    with open(base_file_name + layout.shard_ext(0), "rb") as f:
        sb = SuperBlock.parse(f.read(8))
    return sb.version


def _iter_dat_pieces(dat_file_size: int, large_block: int,
                     small_block: int, k: int):
    """Yield (shard_id, take) pieces reassembling the .dat in order.

    Row split comes from layout.row_counts — the ENCODER-consistent rule
    (large rows while remaining > large_row, strictly). The old loop here
    used `>=`, so a .dat of exactly k*large_block bytes (which the encoder
    writes as small rows) was misread as one large row, scrambling the
    reassembly. The final partial small row stops as soon as the size is
    exhausted; trailing shard padding is never read."""
    n_large, n_small = layout.row_counts(dat_file_size, large_block,
                                         small_block, k)
    remaining = dat_file_size
    for block, rows in ((large_block, n_large), (small_block, n_small)):
        for _ in range(rows):
            for i in range(k):
                take = min(remaining, block)
                if take <= 0:
                    return
                yield i, take
                remaining -= take


def write_dat_file(base_file_name: str, dat_file_size: int,
                   large_block: int = layout.LARGE_BLOCK_SIZE,
                   small_block: int = layout.SMALL_BLOCK_SIZE,
                   pipelined: bool = True,
                   data_shards: int = 0) -> None:
    """Reassemble .dat from the data shards by walking rows
    (reference ec_decoder.go:154-195). Note the reference reads shards
    sequentially, so the per-shard read cursor advances across rows.
    The data-shard count comes from the volume's .vif CodeSpec unless
    overridden, so mixed-code stores decode each volume correctly.

    The output goes to .dat.tmp and is renamed into place on success, so
    an interrupted decode never leaves a truncated .dat. With
    pipelined=True a reader thread prefetches shard chunks through a
    bounded queue while the main thread writes (overlapped I/O)."""
    if data_shards <= 0:
        from seaweedfs_tpu_torch.models.coder import scheme_from_dict
        from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import \
            read_volume_info
        data_shards = scheme_from_dict(
            read_volume_info(base_file_name).get("code")).data_shards
    k = data_shards
    ins = [open(base_file_name + layout.shard_ext(i), "rb") for i in range(k)]
    tmp = base_file_name + ".dat.tmp"
    try:
        with open(tmp, "wb") as out:
            if pipelined:
                _pipelined_reassemble(ins, out, dat_file_size, large_block,
                                      small_block, k)
            else:
                for i, take in _iter_dat_pieces(dat_file_size, large_block,
                                                small_block, k):
                    _copy_n(ins[i], out, take)
        os.replace(tmp, base_file_name + ".dat")
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    finally:
        for f in ins:
            f.close()


def _pipelined_reassemble(ins, out, dat_file_size: int, large_block: int,
                          small_block: int, k: int,
                          prefetch: int = 4) -> None:
    """Reader thread pulls _COPY_CHUNK-sized pieces off the shard files
    into a bounded queue; the caller's thread drains it to the output."""
    from seaweedfs_tpu_torch.parallel.streaming import _Aborted, _Pipeline
    import queue as _q

    pl = _Pipeline()
    work: "_q.Queue" = _q.Queue(maxsize=prefetch)

    def reader():
        for i, take in _iter_dat_pieces(dat_file_size, large_block,
                                        small_block, k):
            left = take
            while left > 0:
                chunk = ins[i].read(min(left, _COPY_CHUNK))
                if not chunk:
                    raise IOError(f"unexpected EOF with {left} bytes left")
                left -= len(chunk)
                pl.put(work, chunk)
        pl.put(work, None)

    pl.spawn(reader)
    try:
        while True:
            chunk = pl.get(work)
            if chunk is None:
                break
            out.write(chunk)
    except _Aborted:
        pass
    pl.join()


def _copy_n(src, dst, n: int) -> None:
    left = n
    while left > 0:
        chunk = src.read(min(left, _COPY_CHUNK))
        if not chunk:
            raise IOError(f"unexpected EOF with {left} bytes left")
        dst.write(chunk)
        left -= len(chunk)
