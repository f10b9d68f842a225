"""Remote storage SPI: cloud buckets mountable into the filer namespace.

Functional equivalent of reference weed/remote_storage/remote_storage.go:
a provider-neutral client interface (traverse/read/write/delete/stat) plus
a registry keyed by configuration. The reference ships s3/gcs/azure
implementations over their SDKs; this environment has no cloud SDKs or
egress, so the shipped backends are:

  - LocalDirRemote ("local" type): a directory tree as the remote —
    the gocdk/local-equivalent backend, and what the tests use
  - S3Remote ("s3" type): the volume layer already speaks the S3 REST
    dialect (storage/backend.py S3BackendFile); this client is a plug
    point that raises until an SDK/endpoint is wired

A remote location is written "name/bucket/path" (reference
remote_storage.ParseLocation / RemoteStorageLocation proto).

The port's copy of seaweedfs_tpu/remote_storage/remote_storage.py: the
SPI, RemoteConf, the "local" backend, the S3-dialect client
(remote_storage/s3_client.py) and the Azure Blob client
(remote_storage/azure_client.py). It imports nothing of that package.
"""

from __future__ import annotations

import abc
import dataclasses
import json
import os
from typing import Callable, Iterator, Optional


@dataclasses.dataclass
class RemoteFile:
    """One object listed from the remote (reference traverse callback)."""
    path: str  # relative to the mounted bucket/prefix, "/"-separated
    size: int
    mtime: int  # unix seconds
    etag: str = ""
    is_directory: bool = False


@dataclasses.dataclass
class RemoteConf:
    """One configured remote storage (reference remote_pb.RemoteConf,
    persisted under /etc/remote.conf in the filer store)."""
    name: str
    type: str = "local"
    # local backend
    root: str = ""
    # s3 backend (any S3-compatible endpoint, incl. our own gateway)
    endpoint: str = ""
    access_key: str = ""
    secret_key: str = ""
    bucket: str = ""
    region: str = "us-east-1"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_public_dict(self) -> dict:
        """Listing form: credentials masked (the reference never echoes
        secrets back from remote.configure listings)."""
        d = self.to_dict()
        for secret in ("access_key", "secret_key"):
            if d.get(secret):
                d[secret] = "***"
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RemoteConf":
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


class RemoteStorageClient(abc.ABC):
    """Provider-neutral operations (reference RemoteStorageClient)."""

    @abc.abstractmethod
    def traverse(self, prefix: str = "") -> Iterator[RemoteFile]: ...

    @abc.abstractmethod
    def read_file(self, path: str, offset: int = 0,
                  size: int = -1) -> bytes: ...

    @abc.abstractmethod
    def write_file(self, path: str, data: bytes) -> RemoteFile: ...

    @abc.abstractmethod
    def remove_file(self, path: str) -> None: ...

    @abc.abstractmethod
    def stat(self, path: str) -> Optional[RemoteFile]: ...


class LocalDirRemote(RemoteStorageClient):
    """A plain directory tree as the remote store."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _abs(self, path: str) -> str:
        path = path.lstrip("/")
        rootn = os.path.normpath(self.root)
        full = os.path.normpath(os.path.join(rootn, path))
        if full != rootn and not full.startswith(rootn + os.sep):
            raise ValueError(f"path escapes remote root: {path}")
        return full

    @staticmethod
    def _etag(st: os.stat_result) -> str:
        return f"{st.st_mtime_ns:x}-{st.st_size:x}"

    def traverse(self, prefix: str = "") -> Iterator[RemoteFile]:
        base = self._abs(prefix)
        if not os.path.isdir(base):
            return
        for dirpath, dirnames, filenames in os.walk(base):
            rel_dir = os.path.relpath(dirpath, self.root)
            rel_dir = "" if rel_dir == "." else rel_dir.replace(os.sep, "/")
            for name in sorted(dirnames):
                yield RemoteFile(
                    path=(rel_dir + "/" if rel_dir else "") + name,
                    size=0, mtime=0, is_directory=True)
            for name in sorted(filenames):
                st = os.stat(os.path.join(dirpath, name))
                yield RemoteFile(
                    path=(rel_dir + "/" if rel_dir else "") + name,
                    size=st.st_size, mtime=int(st.st_mtime),
                    etag=self._etag(st))

    def read_file(self, path: str, offset: int = 0, size: int = -1) -> bytes:
        with open(self._abs(path), "rb") as f:
            f.seek(offset)
            return f.read() if size < 0 else f.read(size)

    def write_file(self, path: str, data: bytes) -> RemoteFile:
        full = self._abs(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(data)
        st = os.stat(full)
        return RemoteFile(path=path.lstrip("/"), size=st.st_size,
                          mtime=int(st.st_mtime), etag=self._etag(st))

    def remove_file(self, path: str) -> None:
        try:
            os.remove(self._abs(path))
        except FileNotFoundError:
            pass

    def stat(self, path: str) -> Optional[RemoteFile]:
        try:
            st = os.stat(self._abs(path))
        except OSError:
            return None
        return RemoteFile(path=path.lstrip("/"), size=st.st_size,
                          mtime=int(st.st_mtime), etag=self._etag(st),
                          is_directory=os.path.isdir(self._abs(path)))


def make_remote_client(conf: RemoteConf) -> RemoteStorageClient:
    """Registry (reference RemoteStorageClientMakers)."""
    if conf.type == "local":
        if not conf.root:
            raise ValueError("local remote needs a root directory")
        return LocalDirRemote(conf.root)
    if conf.type in ("s3", "gcs", "b2", "wasabi"):
        # gcs (XML interop mode with HMAC keys), backblaze b2, and
        # wasabi all serve the S3 dialect — one client covers them
        # (reference ships separate SDK wrappers per provider; the
        # wire protocol is the same)
        from seaweedfs_tpu_torch.remote_storage.s3_client import S3Remote
        endpoint = conf.endpoint or {
            "gcs": "https://storage.googleapis.com",
            "b2": "https://s3.us-west-004.backblazeb2.com",
            "wasabi": "https://s3.wasabisys.com",
        }.get(conf.type, "")
        if not endpoint or not conf.bucket:
            raise ValueError(f"{conf.type} remote needs endpoint and "
                             "bucket")
        return S3Remote(endpoint, conf.bucket,
                        access_key=conf.access_key,
                        secret_key=conf.secret_key, region=conf.region)
    if conf.type == "azure":
        # Blob REST protocol with SharedKey signing, spoken directly
        # (reference wraps the Azure SDK): access_key = account name,
        # secret_key = base64 account key, bucket = container
        from seaweedfs_tpu_torch.remote_storage.azure_client import AzureRemote
        endpoint = conf.endpoint or \
            f"https://{conf.access_key}.blob.core.windows.net"
        if not conf.bucket:
            raise ValueError("azure remote needs a container (bucket)")
        return AzureRemote(endpoint, conf.bucket, conf.access_key,
                           conf.secret_key)
    raise NotImplementedError(
        f"remote type {conf.type!r}: no S3-compatible dialect and no "
        "cloud SDK in this environment; "
        "implement a RemoteStorageClient and register it here")
