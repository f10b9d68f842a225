"""On-disk scalar types for the needle store.

Byte-compatible with the reference formats (all big-endian):
  - NeedleId: uint64, 8 bytes (reference weed/storage/types/needle_id_type.go)
  - Offset: 4 bytes, stored in units of 8 (NeedlePaddingSize), so a volume
    can address 32GB (reference weed/storage/types/offset_4bytes.go:15-18)
  - Size: int32; -1 is the tombstone (reference needle_types.go:33-41)
  - Cookie: uint32
  - Needle map entry: id(8) + offset(4) + size(4) = 16 bytes
"""

from __future__ import annotations

import struct

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4
SIZE_SIZE = 4
COOKIE_SIZE = 4
NEEDLE_PADDING_SIZE = 8
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
TOMBSTONE_FILE_SIZE = -1
MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8  # 32GB
TTL_BYTES_LENGTH = 2
LAST_MODIFIED_BYTES_LENGTH = 5

_ENTRY = struct.Struct(">QIi")
# 5-byte offset, matching the reference's offset_5bytes.go OffsetToBytes:
# bytes[0..3] hold the low 32 bits big-endian (b3..b0), bytes[4] the high
# byte (b4) — i.e. low uint32 first, then the 5th (high) byte.
_ENTRY5 = struct.Struct(">QIBi")


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


def offset_to_actual(offset_units: int) -> int:
    """Stored offset (units of 8) -> byte offset."""
    return offset_units * NEEDLE_PADDING_SIZE


def actual_to_offset(actual: int) -> int:
    assert actual % NEEDLE_PADDING_SIZE == 0, actual
    return actual // NEEDLE_PADDING_SIZE


def entry_size(offset_bytes: int = 4) -> int:
    """Index entry width: 16 bytes with 4-byte offsets, 17 with 5-byte
    (reference build tag 5BytesOffset, offset_5bytes.go:15)."""
    return NEEDLE_ID_SIZE + offset_bytes + SIZE_SIZE


def max_volume_size(offset_bytes: int = 4) -> int:
    """4-byte offsets address 32GB (units of 8); 5-byte address 8TB."""
    return NEEDLE_PADDING_SIZE * (1 << (8 * offset_bytes))


def pack_entry(key: int, offset_units: int, size: int,
               offset_bytes: int = 4) -> bytes:
    """Needle-map/index entry (16B or, for 5-byte offsets, 17B)."""
    if offset_bytes == 5:
        return _ENTRY5.pack(key, offset_units & 0xFFFFFFFF,
                            (offset_units >> 32) & 0xFF, size)
    return _ENTRY.pack(key, offset_units & 0xFFFFFFFF, size)


def unpack_entry(buf: bytes, off: int = 0,
                 offset_bytes: int = 4) -> tuple[int, int, int]:
    if offset_bytes == 5:
        key, lo, hi, size = _ENTRY5.unpack_from(buf, off)
        return key, (hi << 32) | lo, size
    return _ENTRY.unpack_from(buf, off)


def padding_length(needle_size: int, version: int) -> int:
    """Pad the whole record to an 8-byte boundary
    (reference weed/storage/needle/needle_read_write... GetActualSize)."""
    if version == 3:
        used = NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE
    else:
        used = NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE
    return (-used) % NEEDLE_PADDING_SIZE


def get_actual_size(needle_size: int, version: int) -> int:
    if version == 3:
        return (NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE
                + TIMESTAMP_SIZE + padding_length(needle_size, version))
    return (NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE
            + padding_length(needle_size, version))
