"""Volume superblock + replica placement + TTL.

Byte-compatible with reference weed/storage/super_block/super_block.go:16-31:
8 bytes = version | replica placement | ttl(2) | compaction revision(2) |
extra size(2).
"""

from __future__ import annotations

import dataclasses
import struct

SUPER_BLOCK_SIZE = 8

CURRENT_VERSION = 3

# TTL stored units (reference weed/storage/needle/volume_ttl.go)
TTL_UNITS = {"m": 1, "h": 2, "d": 3, "w": 4, "M": 5, "y": 6}
TTL_UNIT_NAMES = {v: k for k, v in TTL_UNITS.items()}
_UNIT_MINUTES = {1: 1, 2: 60, 3: 1440, 4: 10080, 5: 43200, 6: 525600}


@dataclasses.dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = 0

    @classmethod
    def parse(cls, s: str) -> "TTL":
        if not s:
            return cls()
        if s[-1].isdigit():
            return cls(int(s), TTL_UNITS["m"])
        return cls(int(s[:-1]), TTL_UNITS[s[-1]])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if b[0] == 0 and b[1] == 0:
            return cls()
        return cls(b[0], b[1])

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def to_uint32(self) -> int:
        if self.count == 0:
            return 0
        return (self.count << 8) | self.unit

    @property
    def minutes(self) -> int:
        return self.count * _UNIT_MINUTES.get(self.unit, 0)

    def __str__(self):
        if self.count == 0 or self.unit == 0:
            return ""
        return f"{self.count}{TTL_UNIT_NAMES[self.unit]}"


@dataclasses.dataclass(frozen=True)
class ReplicaPlacement:
    """xyz digits: x=other DCs, y=other racks same DC, z=other servers same
    rack (reference weed/storage/super_block/replica_placement.go)."""
    same_rack_count: int = 0
    diff_rack_count: int = 0
    diff_dc_count: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        s = (s or "000").zfill(3)
        return cls(diff_dc_count=int(s[0]), diff_rack_count=int(s[1]),
                   same_rack_count=int(s[2]))

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls(diff_dc_count=b // 100, diff_rack_count=(b // 10) % 10,
                   same_rack_count=b % 10)

    def to_byte(self) -> int:
        return (self.diff_dc_count * 100 + self.diff_rack_count * 10
                + self.same_rack_count)

    @property
    def copy_count(self) -> int:
        return self.same_rack_count + self.diff_rack_count + self.diff_dc_count + 1

    def __str__(self):
        return f"{self.diff_dc_count}{self.diff_rack_count}{self.same_rack_count}"


@dataclasses.dataclass
class SuperBlock:
    version: int = CURRENT_VERSION
    replica_placement: ReplicaPlacement = dataclasses.field(
        default_factory=ReplicaPlacement)
    ttl: TTL = dataclasses.field(default_factory=TTL)
    compaction_revision: int = 0
    extra: bytes = b""

    def to_bytes(self) -> bytes:
        header = bytearray(SUPER_BLOCK_SIZE)
        header[0] = self.version
        header[1] = self.replica_placement.to_byte()
        header[2:4] = self.ttl.to_bytes()
        struct.pack_into(">H", header, 4, self.compaction_revision)
        if self.extra:
            struct.pack_into(">H", header, 6, len(self.extra))
            return bytes(header) + self.extra
        return bytes(header)

    @classmethod
    def parse(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("superblock too short")
        version = b[0]
        if version not in (1, 2, 3):
            raise ValueError(f"unsupported volume version {version}")
        extra_size = struct.unpack_from(">H", b, 6)[0]
        return cls(
            version=version,
            replica_placement=ReplicaPlacement.from_byte(b[1]),
            ttl=TTL.from_bytes(b[2:4]),
            compaction_revision=struct.unpack_from(">H", b, 4)[0],
            extra=bytes(b[8:8 + extra_size]) if extra_size else b"",
        )

    @property
    def block_size(self) -> int:
        if self.version in (2, 3):
            return SUPER_BLOCK_SIZE + len(self.extra)
        return SUPER_BLOCK_SIZE
