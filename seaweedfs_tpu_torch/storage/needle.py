"""Needle record codec — byte-compatible with the reference on-disk format.

Record layout (reference weed/storage/needle/needle.go:25-45,
needle_write.go prepareWriteBuffer, needle_read.go):

  header: cookie(4) id(8) size(4)                       [big-endian]
  v1 body: data[size]
  v2/3 body (`size` covers): data_size(4) data flags(1)
      [name_size(1) name] [mime_size(1) mime] [last_modified(5)]
      [ttl(2)] [pairs_size(2) pairs]
  tail: crc32c(4) [v3: append_at_ns(8)] padding to 8B boundary

An empty-data needle (size==0) is a deletion record.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.utils.crc import crc32c

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED_DATE = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

VERSION1, VERSION2, VERSION3 = 1, 2, 3
CURRENT_VERSION = VERSION3


class CrcError(Exception):
    pass


class SizeMismatchError(Exception):
    pass


@dataclasses.dataclass
class Needle:
    id: int = 0
    cookie: int = 0
    data: bytes = b""
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    flags: int = 0
    last_modified: int = 0
    ttl: Optional[bytes] = None  # 2 raw bytes or None
    append_at_ns: int = 0
    checksum: int = 0
    size: int = 0  # body size as stored in the header (v2/3)

    # ---- flags ----
    def _flag(self, bit: int) -> bool:
        return bool(self.flags & bit)

    @property
    def has_name(self):
        return self._flag(FLAG_HAS_NAME)

    @property
    def has_mime(self):
        return self._flag(FLAG_HAS_MIME)

    @property
    def has_ttl(self):
        return self._flag(FLAG_HAS_TTL)

    @property
    def has_pairs(self):
        return self._flag(FLAG_HAS_PAIRS)

    @property
    def has_last_modified(self):
        return self._flag(FLAG_HAS_LAST_MODIFIED_DATE)

    @property
    def is_compressed(self):
        return self._flag(FLAG_IS_COMPRESSED)

    @property
    def is_chunk_manifest(self):
        return self._flag(FLAG_IS_CHUNK_MANIFEST)

    def set_flags_from_fields(self) -> None:
        if self.name:
            self.flags |= FLAG_HAS_NAME
        if self.mime:
            self.flags |= FLAG_HAS_MIME
        if self.pairs:
            self.flags |= FLAG_HAS_PAIRS
        if self.last_modified:
            self.flags |= FLAG_HAS_LAST_MODIFIED_DATE
        if self.ttl and self.ttl != b"\x00\x00":
            self.flags |= FLAG_HAS_TTL

    # ---- write ----
    def to_bytes(self, version: int = CURRENT_VERSION) -> bytes:
        """Full on-disk record, 8-byte padded."""
        self.checksum = crc32c(self.data)
        if version == VERSION1:
            self.size = len(self.data)
            buf = bytearray()
            buf += struct.pack(">IQi", self.cookie, self.id, self.size)
            buf += self.data
            tail = struct.pack(">I", self.checksum)
            buf += tail + b"\x00" * t.padding_length(self.size, version)
            return bytes(buf)

        assert version in (VERSION2, VERSION3)
        body = bytearray()
        if len(self.data) > 0:
            body += struct.pack(">I", len(self.data))
            body += self.data
            body += bytes([self.flags & 0xFF])
            if self.has_name:
                name = self.name[:255]
                body += bytes([len(name)]) + name
            if self.has_mime:
                mime = self.mime[:255]
                body += bytes([len(mime)]) + mime
            if self.has_last_modified:
                body += struct.pack(">Q", self.last_modified)[
                    8 - t.LAST_MODIFIED_BYTES_LENGTH:]
            if self.has_ttl:
                body += (self.ttl or b"\x00\x00")[:2]
            if self.has_pairs:
                body += struct.pack(">H", len(self.pairs)) + self.pairs
        self.size = len(body)
        buf = bytearray()
        buf += struct.pack(">IQi", self.cookie, self.id, self.size)
        buf += body
        buf += struct.pack(">I", self.checksum)
        if version == VERSION3:
            buf += struct.pack(">Q", self.append_at_ns)
        buf += b"\x00" * t.padding_length(self.size, version)
        return bytes(buf)

    # ---- read ----
    @classmethod
    def parse_header(cls, buf: bytes) -> "Needle":
        cookie, nid, size = struct.unpack_from(">IQi", buf, 0)
        return cls(id=nid, cookie=cookie, size=size)

    @classmethod
    def from_bytes(cls, buf: bytes, size: int,
                   version: int = CURRENT_VERSION,
                   check_crc: bool = True) -> "Needle":
        """Parse a full record blob previously located via the needle map
        (reference needle_read.go ReadBytes)."""
        n = cls.parse_header(buf)
        if n.size != size:
            raise SizeMismatchError(
                f"found size {n.size}, expected {size} (id {n.id:x})")
        h = t.NEEDLE_HEADER_SIZE
        if version == VERSION1:
            n.data = bytes(buf[h:h + size])
        else:
            n._parse_body_v2(buf[h:h + n.size])
        if size > 0 and check_crc:
            stored, = struct.unpack_from(">I", buf, h + size)
            # checksum over a memoryview WINDOW of the record, not a
            # re-slice: verification adds zero copies on top of the
            # parse (and callers that skip the parse entirely use
            # verify_record_crc on the raw blob)
            actual = crc32c(payload_window(buf, size, version))
            if stored != actual and stored != _legacy_crc_value(actual):
                raise CrcError("CRC error! Data On Disk Corrupted")
            n.checksum = actual
        if version == VERSION3:
            n.append_at_ns, = struct.unpack_from(
                ">Q", buf, h + size + t.NEEDLE_CHECKSUM_SIZE)
        return n

    def _parse_body_v2(self, body: bytes) -> None:
        if not body:
            return
        data_size, = struct.unpack_from(">I", body, 0)
        if data_size + 4 > len(body):
            raise ValueError("index out of range")
        self.data = bytes(body[4:4 + data_size])
        self.parse_body_tail(body[4 + data_size:])

    def parse_body_tail(self, tail: bytes) -> None:
        """Parse flags + optional metadata from the bytes that FOLLOW
        the data payload in a v2/3 body. Subrange reads fetch the head
        and tail of a record without the (possibly large) data between,
        so this must be callable on the tail slice alone."""
        idx = 0
        self.flags = tail[idx]
        idx += 1
        if self.has_name:
            ln = tail[idx]
            idx += 1
            self.name = bytes(tail[idx:idx + ln])
            idx += ln
        if self.has_mime:
            ln = tail[idx]
            idx += 1
            self.mime = bytes(tail[idx:idx + ln])
            idx += ln
        if self.has_last_modified:
            raw = b"\x00" * (8 - t.LAST_MODIFIED_BYTES_LENGTH) + \
                tail[idx:idx + t.LAST_MODIFIED_BYTES_LENGTH]
            self.last_modified, = struct.unpack(">Q", raw)
            idx += t.LAST_MODIFIED_BYTES_LENGTH
        if self.has_ttl:
            self.ttl = bytes(tail[idx:idx + 2])
            idx += 2
        if self.has_pairs:
            ln, = struct.unpack_from(">H", tail, idx)
            idx += 2
            self.pairs = bytes(tail[idx:idx + ln])
            idx += ln

def payload_window(buf, size: int,
                   version: int = CURRENT_VERSION) -> memoryview:
    """The data payload of a raw record blob as a zero-copy
    ``memoryview`` window — the region the stored CRC covers. For v2/3
    that is ``data_size`` bytes starting right after the 4-byte
    data_size field; for v1 the whole body IS the payload."""
    mv = memoryview(buf) if not isinstance(buf, memoryview) else buf
    h = t.NEEDLE_HEADER_SIZE
    if version == VERSION1 or size == 0:
        return mv[h:h + size]
    data_size, = struct.unpack_from(">I", buf, h)
    if data_size + 4 > size:
        raise ValueError("index out of range")
    return mv[h + 4:h + 4 + data_size]


def verify_record_crc(buf, size: int, version: int = CURRENT_VERSION,
                      window: int = 1 << 20) -> int:
    """Verify a raw record blob's stored CRC against its payload
    without parsing the record or copying the payload: the checksum
    runs over ``window``-sized memoryview slices chained through
    ``crc32c(crc=...)``. Returns the (canonical) checksum; raises
    CrcError on mismatch. This is the cache-admission check — once a
    blob passes here, hits can re-parse with ``check_crc=False`` and
    range reads can serve memoryview slices of it directly."""
    if size <= 0:
        return 0
    payload = payload_window(buf, size, version)
    c = 0
    for off in range(0, len(payload), window):
        c = crc32c(payload[off:off + window], c)
    stored, = struct.unpack_from(">I", buf,
                                 t.NEEDLE_HEADER_SIZE + size)
    if stored != c and stored != _legacy_crc_value(c):
        raise CrcError("CRC error! Data On Disk Corrupted")
    return c


def _legacy_crc_value(c: int) -> int:
    """Go crc.Value(): rotated+offset form kept for backward compat
    (reference weed/storage/needle/crc.go:26)."""
    c &= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF
