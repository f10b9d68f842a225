"""File id parsing/formatting: "<vid>,<key_hex><cookie_hex8>" with optional
"_<delta>" suffix (reference weed/storage/needle/file_id.go and
needle.go ParsePath).

The port's copy of seaweedfs_tpu/storage/file_id.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    def __str__(self) -> str:
        return f"{self.volume_id},{format_needle_id_cookie(self.key, self.cookie)}"

    @classmethod
    def parse(cls, fid: str) -> "FileId":
        comma = fid.find(",")
        if comma <= 0:
            raise ValueError(f"invalid fid {fid!r}")
        vid = int(fid[:comma])
        key, cookie = parse_needle_id_cookie(fid[comma + 1:])
        return cls(vid, key, cookie)


def format_needle_id_cookie(key: int, cookie: int) -> str:
    # needle id in minimal hex (no leading zeros), cookie fixed 8 hex chars
    return f"{key:x}{cookie:08x}"


def parse_needle_id_cookie(s: str) -> tuple[int, int]:
    delta = 0
    if "_" in s:
        s, d = s.rsplit("_", 1)
        delta = int(d)
    # strip .ext if present
    dot = s.find(".")
    if dot > 0:
        s = s[:dot]
    if len(s) <= 8:
        raise ValueError(f"invalid needle id+cookie {s!r}")
    key = int(s[:-8], 16) + delta
    cookie = int(s[-8:], 16)
    return key, cookie
