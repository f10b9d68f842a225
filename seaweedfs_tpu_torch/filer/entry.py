"""Filer entry model (reference weed/filer/entry.go): a namespace node is
a directory or a file; files reference volume-server chunks.

The port's copy of seaweedfs_tpu/filer/entry.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class FileChunk:
    """One chunk of a file (reference filer_pb FileChunk)."""
    fid: str
    offset: int  # logical offset within the file
    size: int
    mtime_ns: int = 0
    etag: str = ""
    cipher_key: bytes = b""
    is_compressed: bool = False
    is_chunk_manifest: bool = False  # reference filer_pb FileChunk.is_chunk_manifest

    def to_dict(self) -> dict:
        d = {"fid": self.fid, "offset": self.offset, "size": self.size,
             "mtime_ns": self.mtime_ns, "etag": self.etag,
             "is_compressed": self.is_compressed}
        if self.is_chunk_manifest:
            d["is_chunk_manifest"] = True
        if self.cipher_key:
            d["cipher_key"] = self.cipher_key.hex()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(fid=d["fid"], offset=d["offset"], size=d["size"],
                   mtime_ns=d.get("mtime_ns", 0), etag=d.get("etag", ""),
                   is_compressed=d.get("is_compressed", False),
                   is_chunk_manifest=d.get("is_chunk_manifest", False),
                   cipher_key=bytes.fromhex(d.get("cipher_key", "")))


@dataclasses.dataclass
class Attr:
    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    user_name: str = ""
    group_names: tuple = ()
    symlink_target: str = ""
    md5: bytes = b""
    file_size: int = 0
    is_directory: bool = False
    collection: str = ""
    replication: str = ""

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["group_names"] = list(self.group_names)
        d["md5"] = self.md5.hex()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Attr":
        d = dict(d)
        d["group_names"] = tuple(d.get("group_names", ()))
        d["md5"] = bytes.fromhex(d.get("md5", ""))
        return cls(**d)


@dataclasses.dataclass
class RemoteEntry:
    """Cloud-sync state for a remote-mounted file (reference
    filer_pb RemoteEntry, weed/filer/entry.go Remote field)."""
    storage_name: str = ""
    last_local_sync_ts: int = 0
    remote_etag: str = ""
    remote_mtime: int = 0
    remote_size: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RemoteEntry":
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


@dataclasses.dataclass
class Entry:
    full_path: str
    attr: Attr = dataclasses.field(default_factory=Attr)
    chunks: list[FileChunk] = dataclasses.field(default_factory=list)
    extended: dict = dataclasses.field(default_factory=dict)
    content: bytes = b""  # small files inlined
    hard_link_id: str = ""
    remote: Optional[RemoteEntry] = None  # set when under a remote mount

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    @property
    def name(self) -> str:
        return self.full_path.rsplit("/", 1)[-1]

    @property
    def dir_path(self) -> str:
        d = self.full_path.rsplit("/", 1)[0]
        return d or "/"

    def file_size(self) -> int:
        if self.content:
            return max(len(self.content), self.attr.file_size)
        if not self.chunks:
            return self.attr.file_size
        # attr.file_size can exceed the chunk extent for sparse tails
        # (truncate-up); truncate-down clamps chunks so max() is right
        return max(self.attr.file_size,
                   max((c.offset + c.size for c in self.chunks), default=0))

    def to_dict(self) -> dict:
        return {
            "full_path": self.full_path,
            "attr": self.attr.to_dict(),
            "chunks": [c.to_dict() for c in self.chunks],
            "extended": {k: ({"__bytes__": v.hex()}
                             if isinstance(v, bytes) else v)
                         for k, v in self.extended.items()},
            "content": self.content.hex(),
            "hard_link_id": self.hard_link_id,
            **({"remote": self.remote.to_dict()} if self.remote else {}),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        extended = {k: (bytes.fromhex(v["__bytes__"])
                        if isinstance(v, dict) and "__bytes__" in v else v)
                    for k, v in d.get("extended", {}).items()}
        return cls(
            full_path=d["full_path"],
            attr=Attr.from_dict(d.get("attr", {})),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=extended,
            content=bytes.fromhex(d.get("content", "")),
            hard_link_id=d.get("hard_link_id", ""),
            remote=(RemoteEntry.from_dict(d["remote"])
                    if d.get("remote") else None),
        )


def new_directory_entry(path: str) -> Entry:
    now = time.time()
    return Entry(full_path=path,
                 attr=Attr(mtime=now, crtime=now, mode=0o770,
                           is_directory=True))
