"""EC shard layout math — the bit-level contract the coders preserve.

Mirrors the reference's two-tier block interleave exactly
(weed/storage/erasure_coding/ec_encoder.go:17-23, ec_locate.go):

A volume's .dat is consumed in "rows" of data_shards blocks. While more than
`large_block * data_shards` bytes remain, rows use 1GB blocks; the tail uses
1MB blocks. Data shard i's file is the concatenation, over rows, of block i
of each row; parity shards hold the RS parity column-wise. Every row writes
a FULL block to every shard (the final partial row is zero-padded), so all
14 shard files always have equal size:

    shard_size = n_large_rows * large_block + n_small_rows * small_block
"""

from __future__ import annotations

import dataclasses

DATA_SHARDS_COUNT = 10
PARITY_SHARDS_COUNT = 4
TOTAL_SHARDS_COUNT = DATA_SHARDS_COUNT + PARITY_SHARDS_COUNT
LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1GB
SMALL_BLOCK_SIZE = 1024 * 1024  # 1MB


def shard_ext(shard_id: int) -> str:
    return f".ec{shard_id:02d}"


def row_counts(dat_size: int, large_block: int = LARGE_BLOCK_SIZE,
               small_block: int = SMALL_BLOCK_SIZE,
               data_shards: int = DATA_SHARDS_COUNT) -> tuple[int, int]:
    """(n_large_rows, n_small_rows) for a .dat of dat_size bytes.

    Reproduces the encodeDatFile loop conditions: large rows while
    remaining > large_row_size (strict), then small rows while remaining > 0.
    """
    large_row = large_block * data_shards
    small_row = small_block * data_shards
    n_large = 0
    remaining = dat_size
    while remaining > large_row:
        n_large += 1
        remaining -= large_row
    n_small = (remaining + small_row - 1) // small_row if remaining > 0 else 0
    return n_large, n_small


def shard_file_size(dat_size: int, large_block: int = LARGE_BLOCK_SIZE,
                    small_block: int = SMALL_BLOCK_SIZE,
                    data_shards: int = DATA_SHARDS_COUNT) -> int:
    nl, ns = row_counts(dat_size, large_block, small_block, data_shards)
    return nl * large_block + ns * small_block


def iter_encode_batches(dat_size: int, large_block: int = LARGE_BLOCK_SIZE,
                        small_block: int = SMALL_BLOCK_SIZE,
                        batch_size: int = 0,
                        data_shards: int = DATA_SHARDS_COUNT):
    """The encoder's traversal plan: yields (row_offset, block_size,
    batch_offset, batch_len) descriptors in on-disk order. Data shard i's
    bytes for a descriptor live at row_offset + i*block_size + batch_offset
    in the .dat (zero-filled past EOF); each descriptor appends batch_len
    bytes to every shard file.

    Both the serial encoder (encoder.write_ec_files) and the pipelined one
    (parallel/streaming.py) iterate THIS plan, which is what makes their
    shard output bit-identical: same row split (strict `>` large-row rule,
    see row_counts), same batch boundaries, same zero padding.

    batch_size <= 0 means one batch per block."""
    if batch_size <= 0:
        batch_size = large_block
    remaining = dat_size
    processed = 0
    while remaining > 0:
        block = large_block if remaining > large_block * data_shards \
            else small_block
        step = min(batch_size, block)
        if block % step:
            step = block
        for b in range(0, block, step):
            yield processed, block, b, step
        processed += block * data_shards
        remaining -= block * data_shards


@dataclasses.dataclass
class Interval:
    """One contiguous piece of a logical [offset, offset+size) range, local
    to a single block (reference ec_locate.go:8-13)."""
    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int

    def to_shard_id_and_offset(self, large_block: int = LARGE_BLOCK_SIZE,
                               small_block: int = SMALL_BLOCK_SIZE,
                               data_shards: int = DATA_SHARDS_COUNT
                               ) -> tuple[int, int]:
        """(shard_id, offset within the shard file)
        (reference ec_locate.go:77-87)."""
        off = self.inner_block_offset
        row_index = self.block_index // data_shards
        if self.is_large_block:
            off += row_index * large_block
        else:
            off += (self.large_block_rows_count * large_block
                    + row_index * small_block)
        return self.block_index % data_shards, off


def large_row_count(dat_size: int, large_block: int = LARGE_BLOCK_SIZE,
                    data_shards: int = DATA_SHARDS_COUNT) -> int:
    """Number of large rows the encoder actually wrote: the strict-> loop
    means the final large-row-sized chunk always goes to small blocks, i.e.
    ceil(dat/large_row) - 1 (0 for dat <= one large row).

    NOTE: the reference derives this two different ways on the read path —
    `(datSize + 10*small) / (10*large)` in LocateData (ec_locate.go:20) and
    `datSize / (10*large)` in locateOffset (ec_locate.go:60) — both of which
    disagree with its own encoder for dat sizes within 10*small below a
    large-row multiple (resp. at exact multiples). Those windows would
    mis-map reads by a whole large block. We use the encoder-consistent
    count everywhere; outside those measure-zero windows all three agree.
    """
    large_row = large_block * data_shards
    if dat_size <= large_row:
        return 0
    return (dat_size + large_row - 1) // large_row - 1


def locate_data(large_block: int, small_block: int, dat_size: int,
                offset: int, size: int,
                data_shards: int = DATA_SHARDS_COUNT) -> list[Interval]:
    """Split logical [offset, offset+size) into per-block intervals
    (reference ec_locate.go:16-52)."""
    block_index, is_large, inner = _locate_offset(
        large_block, small_block, dat_size, offset, data_shards)
    n_large_rows = large_row_count(dat_size, large_block, data_shards)

    intervals: list[Interval] = []
    while size > 0:
        block_remaining = (large_block if is_large else small_block) - inner
        take = min(size, block_remaining)
        intervals.append(Interval(block_index, inner, take, is_large,
                                  n_large_rows))
        size -= take
        if size <= 0:
            break
        block_index += 1
        if is_large and block_index == n_large_rows * data_shards:
            is_large = False
            block_index = 0
        inner = 0
    return intervals


def _locate_offset(large_block: int, small_block: int, dat_size: int,
                   offset: int, data_shards: int) -> tuple[int, bool, int]:
    large_row = large_block * data_shards
    n_large_rows = large_row_count(dat_size, large_block, data_shards)
    if offset < n_large_rows * large_row:
        return (int(offset // large_block), True, int(offset % large_block))
    offset -= n_large_rows * large_row
    return (int(offset // small_block), False, int(offset % small_block))
