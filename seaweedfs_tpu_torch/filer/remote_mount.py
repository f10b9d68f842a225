"""Remote mounts: a cloud bucket grafted into the filer namespace.

Functional equivalent of reference weed/filer/remote_storage.go +
remote_mapping.go + read_remote.go: remote storage configurations and the
dir→remote mappings are persisted inside the filer's own store (the
reference uses /etc/remote.conf + /etc/remote.mapping entries); mounting
pulls the remote listing in as entries that carry a RemoteEntry sync
record and no chunks; reads fall through to the remote until the object
is cached locally (shell remote.cache), and uncache drops the local
chunks again.

The port's copy of seaweedfs_tpu/filer/remote_mount.py, with its own copy
of the remote.proto messages (pb/remote_pb2.py); ``mount_buckets`` lists
through the port's S3-dialect client. It imports nothing of that
package.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

from seaweedfs_tpu_torch.filer.entry import (
    Attr, Entry, FileChunk, RemoteEntry, new_directory_entry)
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.remote_storage.remote_storage import (
    RemoteConf, RemoteStorageClient, make_remote_client)

REMOTE_CONF_KV_KEY = b"/etc/remote.conf"
REMOTE_MAPPING_KV_KEY = b"/etc/remote.mapping"


class RemoteMounts:
    """Manages remote configurations + mount mappings for one filer."""

    def __init__(self, filer: Filer):
        self.filer = filer

    # ---- configuration (reference shell command_remote_configure.go) ----
    # Persisted as weedtpu_remote_pb proto bytes (the reference keeps
    # proto-marshalled RemoteConf/RemoteStorageMapping in the same KV
    # spots); older JSON blobs still parse via fallback.
    def list_confs(self) -> dict[str, RemoteConf]:
        blob = self.filer.store.kv_get(REMOTE_CONF_KV_KEY)
        if not blob:
            return {}
        try:
            data = json.loads(blob)
        except (UnicodeDecodeError, json.JSONDecodeError):
            from seaweedfs_tpu_torch.pb import remote_pb2
            lst = remote_pb2.RemoteConfList.FromString(blob)
            return {c.name: RemoteConf(
                name=c.name, type=c.type, root=c.root,
                endpoint=c.endpoint, access_key=c.access_key,
                secret_key=c.secret_key, bucket=c.bucket,
                region=c.region or "us-east-1")
                for c in lst.remotes}
        return {d["name"]: RemoteConf.from_dict(d)
                for d in data["remotes"]}

    def configure(self, conf: RemoteConf) -> None:
        confs = self.list_confs()
        confs[conf.name] = conf
        self._save_confs(confs)

    def delete_conf(self, name: str) -> None:
        confs = self.list_confs()
        confs.pop(name, None)
        self._save_confs(confs)

    def _save_confs(self, confs: dict[str, RemoteConf]) -> None:
        from seaweedfs_tpu_torch.pb import remote_pb2
        lst = remote_pb2.RemoteConfList(remotes=[
            remote_pb2.RemoteConf(
                name=c.name, type=c.type, root=c.root,
                endpoint=c.endpoint, access_key=c.access_key,
                secret_key=c.secret_key, bucket=c.bucket, region=c.region)
            for c in confs.values()])
        self.filer.store.kv_put(REMOTE_CONF_KV_KEY, lst.SerializeToString())

    # ---- mappings (reference remote_mapping.go) ----
    def list_mappings(self) -> dict[str, dict]:
        blob = self.filer.store.kv_get(REMOTE_MAPPING_KV_KEY)
        if not blob:
            return {}
        try:
            return json.loads(blob)["mappings"]
        except (UnicodeDecodeError, json.JSONDecodeError):
            from seaweedfs_tpu_torch.pb import remote_pb2
            m = remote_pb2.RemoteStorageMapping.FromString(blob)
            return {d: {"remote_name": loc.name,
                        "remote_path": loc.remote_path}
                    for d, loc in m.mappings.items()}

    def mount(self, dir_path: str, remote_name: str,
              remote_path: str = "") -> None:
        if remote_name not in self.list_confs():
            raise KeyError(f"remote {remote_name!r} not configured")
        mappings = self.list_mappings()
        mappings[dir_path] = {"remote_name": remote_name,
                              "remote_path": remote_path.strip("/")}
        self._save_mappings(mappings)
        self.filer.mkdirs(dir_path)

    def mount_buckets(self, remote_name: str,
                      bucket_pattern: str = "") -> list[str]:
        """Mount every bucket of an S3-dialect remote under
        /buckets/<name> (reference command_remote_mount_buckets.go).
        Each bucket gets a derived conf `<remote>.<bucket>` so the
        existing conf->client machinery addresses it directly."""
        import dataclasses
        import fnmatch
        confs = self.list_confs()
        if remote_name not in confs:
            raise KeyError(f"remote {remote_name!r} not configured")
        conf = confs[remote_name]
        if conf.type not in ("s3", "gcs", "b2", "wasabi"):
            raise ValueError("remote.mount.buckets needs an S3-dialect "
                             f"remote, not {conf.type!r}")
        if not conf.endpoint:
            raise ValueError("remote conf has no endpoint")
        from seaweedfs_tpu_torch.remote_storage.s3_client import S3Remote
        lister = S3Remote(conf.endpoint, "", access_key=conf.access_key,
                          secret_key=conf.secret_key, region=conf.region)
        mounted = []
        for b in lister.list_buckets():
            if bucket_pattern and not fnmatch.fnmatch(b, bucket_pattern):
                continue
            sub = dataclasses.replace(conf, name=f"{remote_name}.{b}",
                                      bucket=b)
            self.configure(sub)
            self.mount(f"/buckets/{b}", sub.name)
            mounted.append(b)
        return mounted

    def unmount(self, dir_path: str) -> None:
        mappings = self.list_mappings()
        mappings.pop(dir_path, None)
        self._save_mappings(mappings)

    def _save_mappings(self, mappings: dict) -> None:
        from seaweedfs_tpu_torch.pb import remote_pb2
        m = remote_pb2.RemoteStorageMapping()
        for d, loc in mappings.items():
            m.mappings[d].name = loc["remote_name"]
            m.mappings[d].remote_path = loc["remote_path"]
        self.filer.store.kv_put(REMOTE_MAPPING_KV_KEY,
                                m.SerializeToString())

    def mapping_for(self, path: str) -> Optional[tuple[str, dict]]:
        """Longest mount-dir prefix covering `path`."""
        best = None
        for mdir, mapping in self.list_mappings().items():
            base = mdir.rstrip("/")
            if path == base or path.startswith(base + "/"):
                if best is None or len(base) > len(best[0]):
                    best = (base, mapping)
        return best

    def client_for(self, mapping: dict) -> RemoteStorageClient:
        conf = self.list_confs()[mapping["remote_name"]]
        return make_remote_client(conf)

    def _remote_rel(self, mount_dir: str, mapping: dict, path: str) -> str:
        rel = path[len(mount_dir):].lstrip("/")
        prefix = mapping.get("remote_path", "")
        return f"{prefix}/{rel}".strip("/") if prefix else rel

    # ---- metadata pull (reference shell remote.meta.sync /
    #      filer_remote_sync pull direction) ----
    def pull_metadata(self, mount_dir: str) -> int:
        """Walk the remote listing into filer entries carrying RemoteEntry
        records (and no local chunks). Returns entries written."""
        hit = self.mapping_for(mount_dir)
        if hit is None:
            raise KeyError(f"{mount_dir} is not a remote mount")
        base, mapping = hit
        client = self.client_for(mapping)
        prefix = mapping.get("remote_path", "")
        count = 0
        for rf in client.traverse(prefix):
            rel = rf.path[len(prefix):].lstrip("/") if prefix else rf.path
            if not rel:
                continue
            full = f"{base}/{rel}"
            if rf.is_directory:
                self.filer.mkdirs(full)
                continue
            existing = self.filer.find_entry(full)
            if existing is not None:
                if (existing.remote is not None
                        and existing.remote.remote_etag == rf.etag):
                    continue  # unchanged on the remote
                if (existing.chunks or existing.content) and (
                        existing.remote is None
                        or existing.remote.last_local_sync_ts
                        < int(existing.attr.mtime)):
                    # local write not yet pushed to the remote: never
                    # clobber it with a chunkless remote stub (the sync
                    # process will push it; the next pull reconciles)
                    continue
            entry = Entry(
                full_path=full,
                attr=Attr(mtime=float(rf.mtime), crtime=float(rf.mtime),
                          file_size=rf.size),
                remote=RemoteEntry(
                    storage_name=mapping["remote_name"],
                    remote_etag=rf.etag, remote_mtime=rf.mtime,
                    remote_size=rf.size))
            self.filer.create_entry(entry)
            count += 1
        return count

    # ---- data plane ----
    def read_through(self, entry: Entry) -> bytes:
        """Fetch a remote-mounted, not-locally-cached file's bytes
        (reference filer/read_remote.go ReadRemote)."""
        hit = self.mapping_for(entry.full_path)
        if hit is None:
            raise FileNotFoundError(
                f"{entry.full_path}: remote entry outside any mount")
        base, mapping = hit
        client = self.client_for(mapping)
        return client.read_file(self._remote_rel(base, mapping,
                                                 entry.full_path))

    def cache_entry(self, entry: Entry,
                    save_chunks_fn: Callable[[bytes], list[FileChunk]]
                    ) -> Entry:
        """Materialize a remote file into local chunks (shell
        remote.cache / command_remote_cache.go)."""
        data = self.read_through(entry)
        entry.chunks = save_chunks_fn(data)
        entry.attr.file_size = len(data)
        if entry.remote:
            entry.remote.last_local_sync_ts = int(time.time())
        self.filer.update_entry(entry)
        return entry

    def uncache_entry(self, entry: Entry) -> Entry:
        """Drop the local chunk copy, keep the remote record (shell
        remote.uncache)."""
        doomed = [c.fid for c in entry.chunks]
        entry.chunks = []
        self.filer.update_entry(entry)
        if doomed and self.filer.delete_chunks_fn:
            self.filer.delete_chunks_fn(doomed)
        return entry

    def write_back(self, entry: Entry, data: bytes) -> None:
        """Push a locally-written file under a mount to the remote
        (the apply step of filer.remote.sync)."""
        hit = self.mapping_for(entry.full_path)
        if hit is None:
            return
        base, mapping = hit
        client = self.client_for(mapping)
        rf = client.write_file(
            self._remote_rel(base, mapping, entry.full_path), data)
        entry.remote = RemoteEntry(
            storage_name=mapping["remote_name"],
            last_local_sync_ts=int(time.time()),
            remote_etag=rf.etag, remote_mtime=rf.mtime,
            remote_size=rf.size)
        self.filer.update_entry(entry)

    def delete_remote(self, full_path: str) -> None:
        hit = self.mapping_for(full_path)
        if hit is None:
            return
        base, mapping = hit
        client = self.client_for(mapping)
        client.remove_file(self._remote_rel(base, mapping, full_path))
