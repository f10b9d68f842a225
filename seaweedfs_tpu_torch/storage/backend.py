"""Backend storage SPI + volume tiering.

Functional equivalent of reference weed/storage/backend/backend.go:16-35:
a sealed volume's .dat can live on something other than the local disk —
a memory-mapped buffer or a cloud (S3) tier. The .vif sidecar records
where the bytes went (reference volume_tier.go + volume_info pb).

The port's copy of seaweedfs_tpu/storage/backend.py, the same code with
its imports pointed at the port; it imports nothing of that package.
"""

from __future__ import annotations

import abc
import io
import json
import os
from typing import Optional

from seaweedfs_tpu_torch.utils import resilience
from seaweedfs_tpu_torch.utils.crc import crc32c
from seaweedfs_tpu_torch.utils.resilience import Deadline, RetryPolicy

# Bounded-memory unit for tier uploads and readback verification: the
# largest contiguous piece of a .dat ever held in memory, regardless of
# volume size (the streaming-ingest contract applied to tiering).
TIER_CHUNK_BYTES = 4 * 1024 * 1024
# Fallback total budgets when no ambient request deadline is in scope
# (tier moves usually run from a background mover thread, not a request
# handler — they still must not hang forever on a dead endpoint).
TIER_READ_BUDGET_S = 60.0
TIER_UPLOAD_BUDGET_S = 600.0

# Jittered, budget-gated retries for every cross-node tier op. All the
# HTTP verbs used here are idempotent against an S3 endpoint (range
# GET, HEAD, object/part PUT re-put the same bytes), so replay is safe.
_RETRY = RetryPolicy(attempts=3, base=0.2, cap=2.0)


def _tier_deadline(budget_s: float) -> Deadline:
    """Ambient request deadline when one is in scope, else a fresh
    budget: tier ops inherit their caller's budget like every other
    cross-node call, but never run unbounded."""
    d = resilience.current_deadline()
    return d if d is not None else Deadline.after(budget_s)


class BackendStorageFile(abc.ABC):
    """ReadAt/WriteAt/Truncate/Sync over some storage medium."""

    @abc.abstractmethod
    def read_at(self, offset: int, length: int) -> bytes: ...

    @abc.abstractmethod
    def write_at(self, offset: int, data: bytes) -> int: ...

    @abc.abstractmethod
    def size(self) -> int: ...

    def truncate(self, size: int) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass


class DiskFile(BackendStorageFile):
    def __init__(self, path: str, create: bool = False):
        mode = "r+b" if os.path.exists(path) else "w+b"
        if not create and not os.path.exists(path):
            raise FileNotFoundError(path)
        self._f = open(path, mode)
        self.path = path

    def read_at(self, offset: int, length: int) -> bytes:
        self._f.seek(offset)
        return self._f.read(length)

    def write_at(self, offset: int, data: bytes) -> int:
        self._f.seek(offset)
        return self._f.write(data)

    def size(self) -> int:
        self._f.seek(0, os.SEEK_END)
        return self._f.tell()

    def truncate(self, size: int) -> None:
        self._f.truncate(size)

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


class MemoryFile(BackendStorageFile):
    """In-memory backend (the reference's memory_map analogue)."""

    def __init__(self, data: bytes = b""):
        self._buf = io.BytesIO(data)

    def read_at(self, offset: int, length: int) -> bytes:
        self._buf.seek(offset)
        return self._buf.read(length)

    def write_at(self, offset: int, data: bytes) -> int:
        self._buf.seek(offset)
        return self._buf.write(data)

    def size(self) -> int:
        self._buf.seek(0, os.SEEK_END)
        return self._buf.tell()

    def truncate(self, size: int) -> None:
        self._buf.truncate(size)


class S3BackendFile(BackendStorageFile):
    """Read-only cloud-tier file served over an S3-compatible endpoint
    (including our own gateway). Range reads map to HTTP Range requests
    (reference storage/backend/s3_backend)."""

    def __init__(self, endpoint: str, bucket: str, key: str):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.key = key
        self._size: Optional[int] = None

    def _url(self) -> str:
        return f"{self.endpoint}/{self.bucket}/{self.key}"

    def _call(self, method: str, url: str, deadline: Deadline,
              body: Optional[bytes] = None,
              headers: Optional[dict] = None) -> tuple:
        """One retried HTTP round trip under the op deadline. 5xx from
        the endpoint is surfaced as ConnectionError so the RetryPolicy
        treats it like any other transient transport failure; 4xx is
        the caller's problem and never replayed."""
        from seaweedfs_tpu_torch.utils.httpd import http_call

        def attempt():
            status, data, resp = http_call(method, url, body=body,
                                           headers=headers, timeout=30.0,
                                           deadline=deadline)
            if status >= 500:
                raise ConnectionError(f"s3 {method}: HTTP {status}")
            return status, data, resp

        return _RETRY.call(attempt, dest=self.endpoint, deadline=deadline)

    def read_at(self, offset: int, length: int) -> bytes:
        deadline = _tier_deadline(TIER_READ_BUDGET_S)
        status, body, _ = self._call(
            "GET", self._url(), deadline,
            headers={"Range": f"bytes={offset}-{offset + length - 1}"})
        if status not in (200, 206):
            raise IOError(f"s3 read: HTTP {status}")
        if status == 200:  # endpoint ignored Range: slice the full body
            body = body[offset:offset + length]
        return body

    def write_at(self, offset: int, data: bytes) -> int:
        raise PermissionError("cloud-tier volumes are read-only")

    def size(self) -> int:
        if self._size is None:
            deadline = _tier_deadline(TIER_READ_BUDGET_S)
            status, _, headers = self._call("HEAD", self._url(), deadline)
            length = headers.get("Content-Length") if status < 400 else None
            if length is not None:
                self._size = int(length)
            else:  # endpoint without HEAD support: fall back to a GET
                status, body, _ = self._call("GET", self._url(), deadline)
                if status >= 400:
                    raise IOError(f"s3 stat: HTTP {status}")
                self._size = len(body)
        return self._size

    def upload(self, local_path: str) -> None:
        """Stream the file to the endpoint holding at most
        TIER_CHUNK_BYTES in memory: small files go up as one object
        PUT, anything larger rides S3 multipart (init / part-per-chunk
        / complete), so a multi-GB .dat never materializes in RSS."""
        total = os.path.getsize(local_path)
        deadline = _tier_deadline(TIER_UPLOAD_BUDGET_S)
        with open(local_path, "rb") as f:
            if total <= TIER_CHUNK_BYTES:
                status, _, _ = self._call("PUT", self._url(), deadline,
                                          body=f.read(TIER_CHUNK_BYTES))
                if status >= 400:
                    raise IOError(f"s3 upload: HTTP {status}")
                return
            upload_id = self._initiate_multipart(deadline)
            try:
                part = 1
                while True:
                    piece = f.read(TIER_CHUNK_BYTES)
                    if not piece:
                        break
                    status, _, _ = self._call(
                        "PUT",
                        f"{self._url()}?uploadId={upload_id}"
                        f"&partNumber={part}",
                        deadline, body=piece)
                    if status >= 400:
                        raise IOError(
                            f"s3 upload part {part}: HTTP {status}")
                    part += 1
                status, _, _ = self._call(
                    "POST", f"{self._url()}?uploadId={upload_id}",
                    deadline)
                if status >= 400:
                    raise IOError(f"s3 upload complete: HTTP {status}")
            except BaseException:
                self._abort_multipart(upload_id)
                raise

    def _initiate_multipart(self, deadline: Deadline) -> str:
        status, body, _ = self._call(
            "POST", f"{self._url()}?uploads", deadline)
        if status >= 400:
            raise IOError(f"s3 multipart init: HTTP {status}")
        import xml.etree.ElementTree as ET
        upload_id = ET.fromstring(body).findtext("UploadId")
        if not upload_id:
            raise IOError("s3 multipart init: no UploadId in response")
        return upload_id

    def _abort_multipart(self, upload_id: str) -> None:
        """Best-effort cleanup of a failed multipart upload — the
        original failure is the one worth surfacing."""
        from seaweedfs_tpu_torch.utils.httpd import http_call
        try:
            http_call("DELETE", f"{self._url()}?uploadId={upload_id}",
                      timeout=10.0)
        except (ConnectionError, OSError):
            pass


# ---- .vif sidecar (volume info) ----

def save_volume_info(base_path: str, info: dict) -> None:
    with open(base_path + ".vif", "w") as f:
        json.dump(info, f)


def load_volume_info(base_path: str) -> dict:
    path = base_path + ".vif"
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def file_crc32c(path: str, chunk_bytes: int = TIER_CHUNK_BYTES) -> int:
    """Chained crc32c of a whole file, read in bounded chunks."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            piece = f.read(chunk_bytes)
            if not piece:
                return crc
            crc = crc32c(piece, crc)


def verify_tiered_copy(remote: S3BackendFile, expect_size: int,
                       expect_crc: int,
                       chunk_bytes: int = TIER_CHUNK_BYTES) -> None:
    """Read the uploaded object back through the backend SPI in bounded
    chunks and check size + chained crc32c against the local file.
    Raises IOError on any mismatch — the demotion contract is that the
    local .dat is only deleted after the remote copy proved
    bit-identical through the same path reads will later take."""
    remote_size = remote.size()
    if remote_size != expect_size:
        raise IOError(f"tier verify: remote size {remote_size} != "
                      f"local {expect_size}")
    crc = 0
    offset = 0
    while offset < expect_size:
        n = min(chunk_bytes, expect_size - offset)
        piece = remote.read_at(offset, n)
        if len(piece) != n:
            raise IOError(f"tier verify: short read at {offset} "
                          f"({len(piece)} of {n})")
        crc = crc32c(piece, crc)
        offset += n
    if crc != expect_crc:
        raise IOError(f"tier verify: crc32c {crc:#010x} != "
                      f"local {expect_crc:#010x}")


def tier_volume_to_s3(base_path: str, endpoint: str, bucket: str,
                      keep_local: bool = False,
                      key: Optional[str] = None) -> dict:
    """Move a sealed volume's .dat to an S3 tier; record in .vif
    (reference volume_tier.go + volume_grpc_tier_upload.go).

    Verified demotion: the local file is removed only after a full
    readback through S3BackendFile matches its size and chained
    crc32c. On verify failure the local .dat stays, the .vif is left
    untouched, and the error surfaces to the caller.

    ``key`` overrides the default object key. Callers demoting
    replicated volumes must pass a replica-unique key (e.g. prefixed
    with the serving node's url): replicas compact independently, so
    a shared key would let replica B's upload overwrite replica A's
    already-verified object and break A's recorded size/crc."""
    if key is None:
        key = os.path.basename(base_path) + ".dat"
    local = base_path + ".dat"
    local_size = os.path.getsize(local)
    local_crc = file_crc32c(local)
    remote = S3BackendFile(endpoint, bucket, key)
    remote.upload(local)
    verify_tiered_copy(remote, local_size, local_crc)
    info = load_volume_info(base_path)
    info.update({"version": info.get("version", 3),
                 "remote": {"backend": "s3", "endpoint": endpoint,
                            "bucket": bucket, "key": key,
                            "size": local_size, "crc32c": local_crc}})
    save_volume_info(base_path, info)
    if not keep_local:
        os.remove(local)
    return info


def open_backend_for_volume(base_path: str) -> BackendStorageFile:
    """Open local .dat, or the remote tier recorded in .vif."""
    if os.path.exists(base_path + ".dat"):
        return DiskFile(base_path + ".dat")
    info = load_volume_info(base_path)
    remote = info.get("remote")
    if remote and remote.get("backend") == "s3":
        return S3BackendFile(remote["endpoint"], remote["bucket"],
                             remote["key"])
    raise FileNotFoundError(base_path + ".dat")
