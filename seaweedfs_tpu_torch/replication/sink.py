"""Replication sinks + the Replicator.

Functional equivalent of reference weed/replication: a ReplicationSink
receives filer meta events (create/update/delete) and applies them to a
destination — another filer, a local directory, or a cloud bucket. The
reference ships filer/s3/gcs/azure/b2/local sinks (sink SPI at
replication/sink/replication_sink.go); we ship the SPI plus filer,
local, s3 (which also covers the gcs-interop/b2/wasabi S3-dialect
endpoints), and azure (SharedKey Blob REST) sinks.

The port's copy of seaweedfs_tpu/replication/sink.py. One difference on
purpose: Replicator._fetch raises when the source answers neither 200 nor
404, so the event is retried; the JAX Replicator writes an empty replica
and moves on. It imports nothing of that package.
"""

from __future__ import annotations

import abc
import os
import urllib.parse
from typing import Optional

from seaweedfs_tpu_torch.utils import headers as weed_headers


class ReplicationSink(abc.ABC):
    name = "abstract"

    @abc.abstractmethod
    def create_entry(self, path: str, entry: dict, data: Optional[bytes]) -> None: ...

    @abc.abstractmethod
    def delete_entry(self, path: str, is_directory: bool) -> None: ...

    def update_entry(self, path: str, entry: dict,
                     data: Optional[bytes]) -> None:
        self.create_entry(path, entry, data)


class FilerSink(ReplicationSink):
    """Replicate into another filer over HTTP. When `signature` is set,
    every write carries X-Weed-Sync-Signature so the destination tags
    the resulting events — the reverse sync direction excludes them
    (reference filer.sync signatures)."""

    name = "filer"

    def __init__(self, filer_url: str, path_prefix: str = "/",
                 signature: int = 0):
        self.filer_url = filer_url
        self.path_prefix = path_prefix.rstrip("/")
        self.signature = signature

    def _url(self, path: str) -> str:
        return (f"http://{self.filer_url}{self.path_prefix}"
                f"{urllib.parse.quote(path)}")

    def _headers(self) -> Optional[dict]:
        if not self.signature:
            return None
        return {weed_headers.SYNC_SIGNATURE: str(self.signature)}

    def create_entry(self, path: str, entry: dict,
                     data: Optional[bytes]) -> None:
        from seaweedfs_tpu_torch.utils.httpd import http_call
        attr = entry.get("attr", {})
        if attr.get("is_directory"):
            http_call("POST", self._url(path) + "?mkdir=true", body=b"",
                      headers=self._headers())
            return
        http_call("POST", self._url(path), body=data or b"",
                  headers=self._headers())

    def delete_entry(self, path: str, is_directory: bool) -> None:
        from seaweedfs_tpu_torch.utils.httpd import http_call
        url = self._url(path)
        if is_directory:
            url += "?recursive=true"
        http_call("DELETE", url, headers=self._headers())


class LocalSink(ReplicationSink):
    """Replicate into a local directory (reference sink/localsink)."""

    name = "local"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, path: str) -> str:
        return os.path.join(self.root, path.lstrip("/"))

    def create_entry(self, path: str, entry: dict,
                     data: Optional[bytes]) -> None:
        p = self._path(path)
        if entry.get("attr", {}).get("is_directory"):
            os.makedirs(p, exist_ok=True)
            return
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data or b"")

    def delete_entry(self, path: str, is_directory: bool) -> None:
        p = self._path(path)
        try:
            if is_directory:
                import shutil
                shutil.rmtree(p)
            else:
                os.remove(p)
        except FileNotFoundError:
            pass


class S3Sink(ReplicationSink):
    """Replicate objects into an S3-compatible bucket (reference
    replication/sink/s3sink — and, via the shared SigV4 client, the
    gcs-interop/b2/wasabi endpoints the reference covers with separate
    SDK sinks). Anonymous when no access key is given."""

    name = "s3"

    def __init__(self, endpoint: str, bucket: str, prefix: str = "",
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1"):
        from seaweedfs_tpu_torch.remote_storage.s3_client import S3Remote
        self.client = S3Remote(endpoint, bucket, access_key=access_key,
                               secret_key=secret_key, region=region)
        self.prefix = prefix.strip("/")

    def _key(self, path: str) -> str:
        return (self.prefix + "/" if self.prefix else "") \
            + path.lstrip("/")

    def create_entry(self, path: str, entry: dict,
                     data: Optional[bytes]) -> None:
        if entry.get("attr", {}).get("is_directory"):
            return
        self.client.write_file(self._key(path), data or b"")

    def delete_entry(self, path: str, is_directory: bool) -> None:
        if is_directory:
            return
        self.client.remove_file(self._key(path))


class AzureSink(ReplicationSink):
    """Replicate objects into an Azure Blob container (reference
    replication/sink/azuresink/azure_sink.go) over the SharedKey REST
    client — no SDK."""

    name = "azure"

    def __init__(self, endpoint: str, container: str, account: str,
                 key_b64: str, prefix: str = ""):
        from seaweedfs_tpu_torch.remote_storage.azure_client import AzureRemote
        self.client = AzureRemote(endpoint, container, account, key_b64)
        self.prefix = prefix.strip("/")

    def _key(self, path: str) -> str:
        return (self.prefix + "/" if self.prefix else "") \
            + path.lstrip("/")

    def create_entry(self, path: str, entry: dict,
                     data: Optional[bytes]) -> None:
        if entry.get("attr", {}).get("is_directory"):
            return
        self.client.write_file(self._key(path), data or b"")

    def delete_entry(self, path: str, is_directory: bool) -> None:
        if is_directory:
            return
        self.client.remove_file(self._key(path))


def make_sink_from_config(conf: dict):
    """First enabled sink in replication.toml (reference
    replication/sink/*.go registration through sub_config)."""
    from seaweedfs_tpu_torch.utils import config as cfg
    if cfg.get(conf, "sink.filer.enabled"):
        return FilerSink(
            cfg.get(conf, "sink.filer.url", "localhost:8888"),
            path_prefix=cfg.get(conf, "sink.filer.directory", "") or "")
    if cfg.get(conf, "sink.local.enabled"):
        return LocalSink(cfg.get(conf, "sink.local.directory",
                                 "/data/backup"))
    if cfg.get(conf, "sink.s3.enabled"):
        return S3Sink(
            cfg.get(conf, "sink.s3.endpoint", "http://localhost:8333"),
            cfg.get(conf, "sink.s3.bucket", "backup"),
            prefix=cfg.get(conf, "sink.s3.directory", "") or "",
            access_key=cfg.get(conf, "sink.s3.aws_access_key_id", ""),
            secret_key=cfg.get(conf, "sink.s3.aws_secret_access_key",
                               ""),
            region=cfg.get(conf, "sink.s3.region", "us-east-1"))
    if cfg.get(conf, "sink.azure.enabled"):
        return AzureSink(
            cfg.get(conf, "sink.azure.endpoint", ""),
            cfg.get(conf, "sink.azure.container", "backup"),
            cfg.get(conf, "sink.azure.account_name", ""),
            cfg.get(conf, "sink.azure.account_key", ""),
            prefix=cfg.get(conf, "sink.azure.directory", "") or "")
    return None


class Replicator:
    """Apply a stream of filer meta events to a sink
    (reference replication/replicator.go)."""

    def __init__(self, sink: ReplicationSink, source_filer_url: str,
                 path_prefix: str = "/"):
        self.sink = sink
        self.source_filer_url = source_filer_url
        self.path_prefix = path_prefix.rstrip("/") or "/"

    def _in_scope(self, path: str) -> bool:
        return path.startswith(self.path_prefix)

    def _fetch(self, path: str) -> Optional[bytes]:
        """The file's bytes at the source; None when it is gone there
        (404: a later event deletes or moves it). Any other failure
        raises, so the caller retries this event (FilerSync holds its
        cursor) instead of writing an empty replica and moving on."""
        from seaweedfs_tpu_torch.utils.httpd import HttpError, http_call
        status, body, _ = http_call(
            "GET",
            f"http://{self.source_filer_url}{urllib.parse.quote(path)}")
        if status == 404:
            return None
        if status != 200:
            raise HttpError(status, body)
        return body

    def apply_event(self, event: dict) -> None:
        old, new = event.get("old_entry"), event.get("new_entry")
        if new is not None:
            path = new["full_path"]
            if not self._in_scope(path):
                return
            if old is not None and old["full_path"] != path:
                self.sink.delete_entry(
                    old["full_path"],
                    old.get("attr", {}).get("is_directory", False))
            data = None
            if not new.get("attr", {}).get("is_directory"):
                data = self._fetch(path)
            self.sink.create_entry(path, new, data)
        elif old is not None:
            path = old["full_path"]
            if not self._in_scope(path):
                return
            self.sink.delete_entry(
                path, old.get("attr", {}).get("is_directory", False))
