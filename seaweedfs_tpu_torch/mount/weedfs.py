"""WeedFS: the mount filesystem over the filer namespace.

Functional equivalent of reference weed/mount/weedfs.go + inode_to_path.go:
an inode<->path registry, attribute translation, and per-handle
write-back state. Unlike the pre-round-4 design (whole-file RAM buffer
per handle), writes stream through a dirty-page UploadPipeline
(page_writer.py — reference weed/mount/page_writer/upload_pipeline.go)
with bounded memory and swap-file spill, and reads fetch only the chunk
views they need; metadata lookups are served from a MetaCache
subscribed to the filer change log (meta_cache.py — reference
weed/mount/meta_cache/meta_cache_subscribe.go:14-45).

The port's copy of seaweedfs_tpu/mount/weedfs.py, plus WeedFS.close(),
which flushes and closes every open handle (their upload pipelines and
swap files) and ends the meta cache's subscription; swap files go to
$TMPDIR unless given a directory. It imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import errno
import stat as statmod
import threading
import time
from typing import Optional

from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk
from seaweedfs_tpu_torch.filer.filechunk_manifest import (
    has_chunk_manifest, maybe_manifestize, resolve_chunk_manifest)
from seaweedfs_tpu_torch.filer.filechunks import (
    non_overlapping_visible_intervals, view_from_visibles)
from seaweedfs_tpu_torch.mount.fuse_kernel import ROOT_ID, FileAttr
from seaweedfs_tpu_torch.mount.meta_cache import MetaCache, is_negative
from seaweedfs_tpu_torch.mount.page_writer import UploadPipeline

# files at or below this size are stored inline in the entry, matching
# the filer server's small-content threshold
INLINE_LIMIT = 2048


class InodeToPath:
    """Bidirectional inode<->path map (reference mount/inode_to_path.go)."""

    def __init__(self):
        self._path_to_inode: dict[str, int] = {"/": ROOT_ID}
        self._inode_to_path: dict[int, str] = {ROOT_ID: "/"}
        self._next = ROOT_ID + 1
        self._lock = threading.Lock()

    def lookup(self, path: str) -> int:
        with self._lock:
            ino = self._path_to_inode.get(path)
            if ino is None:
                ino = self._next
                self._next += 1
                self._path_to_inode[path] = ino
                self._inode_to_path[ino] = path
            return ino

    def path(self, ino: int) -> Optional[str]:
        return self._inode_to_path.get(ino)

    def move(self, old: str, new: str) -> None:
        """Repoint old -> new, including every path UNDER old when a
        directory moves (children keep their inodes, like the kernel)."""
        prefix = old.rstrip("/") + "/"
        with self._lock:
            for path in [p for p in self._path_to_inode
                         if p == old or p.startswith(prefix)]:
                ino = self._path_to_inode.pop(path)
                moved = new + path[len(old):]
                self._path_to_inode[moved] = ino
                self._inode_to_path[ino] = moved

    def forget(self, path: str) -> None:
        with self._lock:
            ino = self._path_to_inode.pop(path, None)
            if ino is not None:
                self._inode_to_path.pop(ino, None)


class FileHandle:
    """State of one open file (reference mount/filehandle.go): a
    snapshot of the entry's chunks at open time plus a lazily-created
    write-back pipeline. Nothing is buffered whole."""

    def __init__(self, path: str, entry: Optional[Entry], weedfs):
        self.path = path
        self.w = weedfs
        self.lock = threading.RLock()
        self.dirty = False
        self.pipeline: Optional[UploadPipeline] = None
        # resolved base state (manifests expanded once); chunk objects
        # are COPIED — truncate mutates sizes in place and the originals
        # are shared with the meta cache and other handles
        self.content = entry.content if entry else b""
        chunks = list(entry.chunks) if entry else []
        if has_chunk_manifest(chunks):
            chunks = resolve_chunk_manifest(weedfs.fs._read_chunk, chunks)
        self.base_chunks = [dataclasses.replace(c) for c in chunks]
        # chunks flushed during this handle's lifetime
        self.flushed_chunks: list[FileChunk] = []
        self.size = entry.file_size() if entry else 0
        self.attr = entry.attr if entry else Attr()
        self._vis_cache = None  # (key, visibles) for read-path reuse
        self._gen = 0  # bumped whenever chunk lists mutate
        self._last_read_end = -1  # sequential-read detection (prefetch)

    # ---- write ----
    def _ensure_pipeline(self) -> UploadPipeline:
        if self.pipeline is None:
            self.pipeline = UploadPipeline(
                self.w._upload_one, swap_dir=self.w.swap_dir,
                chunk_size=self.w.chunk_size,
                mem_chunks=self.w.mem_chunks,
                concurrency=self.w.upload_concurrency)
            if self.content:
                # inline content becomes dirty page 0 so the flushed
                # entry is a consistent chunked (or re-inlined) file
                self.pipeline.write(0, self.content)
                self.content = b""
        return self.pipeline

    def write(self, offset: int, data: bytes) -> int:
        with self.lock:
            p = self._ensure_pipeline()
            n = p.write(offset, data)
            self.size = max(self.size, offset + n)
            self.dirty = True
            return n

    # ---- read ----
    def read(self, offset: int, size: int) -> bytes:
        with self.lock:
            limit = self.size
            if offset >= limit:
                return b""
            size = min(size, limit - offset)
            if self.pipeline is not None:
                self.pipeline.wait_for_inflight(offset, offset + size)
                uploaded = self.pipeline.uploaded_snapshot()
            else:
                uploaded = []
            if self.content and not uploaded:
                buf = bytearray(self.content[offset:offset + size])
                buf.extend(b"\x00" * (size - len(buf)))
            else:
                chunks = self.base_chunks + self.flushed_chunks + uploaded
                visibles = self._visibles(chunks)
                buf = self.w._read_chunks_range(
                    chunks, offset, size, visibles=visibles)
                if offset == self._last_read_end:
                    # sequential stream: warm the chunks the next reads
                    # will want (reference reader_cache.go MaybeCache
                    # via reader_at.go on consecutive offsets)
                    self.w._prefetch_ahead(chunks, visibles, offset + size)
            self._last_read_end = offset + size
            if self.pipeline is not None:
                self.pipeline.overlay(buf, offset)
            return bytes(buf)

    def _visibles(self, chunks: list[FileChunk]):
        """Visible-interval view of the handle's chunk list, cached
        between reads (the interval build is O(n log n) and a 128KB
        FUSE read stream would otherwise redo it thousands of times;
        the reference caches per file too, filehandle_read.go)."""
        key = (self._gen, len(chunks))
        if self._vis_cache is not None and self._vis_cache[0] == key:
            return self._vis_cache[1]
        vis = non_overlapping_visible_intervals(chunks)
        self._vis_cache = (key, vis)
        return vis

    # ---- truncate ----
    def truncate(self, new_size: int) -> None:
        with self.lock:
            if self.content and new_size > len(self.content):
                # extending an inline file: content becomes page 0 so
                # the hole past it reads as zeros
                self._ensure_pipeline()
            if self.pipeline is not None:
                self.pipeline.truncate(new_size)
            if new_size < self.size:
                self.content = self.content[:new_size]
                for group in (self.base_chunks, self.flushed_chunks):
                    for fc in group:
                        if fc.offset + fc.size > new_size:
                            fc.size = max(0, new_size - fc.offset)
                self.base_chunks = [c for c in self.base_chunks if c.size]
                self.flushed_chunks = [c for c in self.flushed_chunks
                                       if c.size]
            self._gen += 1
            self.size = new_size
            self.dirty = True

    # ---- flush ----
    def flush(self) -> None:
        with self.lock:
            if not self.dirty:
                return
            now = time.time()
            entry = Entry(
                full_path=self.path,
                attr=Attr(mtime=now, crtime=self.attr.crtime or now,
                          mode=self.attr.mode or 0o644,
                          mime=self.attr.mime, uid=self.attr.uid,
                          gid=self.attr.gid, file_size=self.size))
            if self.size <= INLINE_LIMIT and not self.base_chunks \
                    and not self.flushed_chunks \
                    and (self.pipeline is None
                         or not self.pipeline.has_uploads()):
                # tiny file: persist inline, upload NOTHING. The dirty
                # pages stay live in the pipeline so later writes keep
                # layering on them (no orphaned needles, no lost base).
                buf = bytearray(self.content.ljust(self.size, b"\x00")
                                [:self.size])
                if self.pipeline is not None:
                    self.pipeline.overlay(buf, 0)
                entry.content = bytes(buf)
            else:
                uploaded = self.pipeline.flush() if self.pipeline else []
                chunks = self.base_chunks + self.flushed_chunks + uploaded
                entry.chunks = maybe_manifestize(
                    lambda blob: self.w.fs._save_chunk(blob, 0, "", ""),
                    chunks)
                self.flushed_chunks = self.flushed_chunks + uploaded
                self._gen += 1
            self.w.filer.create_entry(entry)
            self.attr = entry.attr
            self.dirty = False

    def close(self) -> None:
        if self.pipeline is not None:
            self.pipeline.close()
            self.pipeline = None


class WeedFS:
    """Operations implementation over a filer."""

    def __init__(self, filer_server, swap_dir: Optional[str] = None,
                 chunk_size: int = None, mem_chunks: int = None,
                 upload_concurrency: int = None):
        import tempfile

        from seaweedfs_tpu_torch.mount import page_writer as _pw
        self.fs = filer_server
        self.filer = filer_server.filer
        self.inodes = InodeToPath()
        self._handles: dict[int, FileHandle] = {}
        self._next_fh = 1
        self._lock = threading.Lock()
        # spill files go where the process's temp files go ($TMPDIR)
        self.swap_dir = swap_dir or tempfile.gettempdir()
        self.chunk_size = chunk_size or _pw.DEFAULT_CHUNK_SIZE
        self.mem_chunks = mem_chunks or _pw.DEFAULT_MEM_CHUNKS
        self.upload_concurrency = (upload_concurrency
                                   or _pw.DEFAULT_CONCURRENCY)
        # statfs quota override, set live via the mount admin plane
        # (mount_grpc Configure / shell mount.configure); 0 = report
        # the cluster's aggregate capacity
        self.collection_capacity = 0
        self.meta_cache = MetaCache()
        self.meta_cache.attach(self.filer.meta_log)

    def close(self) -> None:
        """What the mount does as it goes away: every open handle
        flushed and closed (its upload pipeline's threads stopped, its
        swap file closed), and the meta cache's subscription ended."""
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
        for h in handles:
            try:
                h.flush()
            finally:
                h.close()
        self.meta_cache.detach()

    # ---- helpers ----
    def _upload_one(self, data: bytes, logical_offset: int,
                    mtime_ns: int) -> FileChunk:
        fc = self.fs._save_chunk(data, logical_offset, "", "")
        fc.mtime_ns = mtime_ns
        return fc

    PREFETCH_BYTES = 2 * 4 * 1024 * 1024  # two default chunks ahead

    def _prefetch_ahead(self, chunks: list[FileChunk], visibles,
                        from_offset: int) -> None:
        """Background-warm the chunks covering the next PREFETCH_BYTES
        of a sequential stream (skips fids already cached/in flight)."""
        rc = getattr(self.fs, "reader_cache", None)
        if rc is None:
            return
        fids = []
        for view in view_from_visibles(visibles, from_offset,
                                       self.PREFETCH_BYTES):
            if view.fid not in fids:
                fids.append(view.fid)
        if fids:
            rc.maybe_prefetch(fids)

    def _read_chunks_range(self, chunks: list[FileChunk], offset: int,
                           size: int, visibles=None) -> bytearray:
        """Materialize [offset, offset+size) from a chunk list, reading
        only the chunks that intersect the range (holes read as zeros)."""
        buf = bytearray(size)
        if visibles is None:
            visibles = non_overlapping_visible_intervals(chunks)
        chunk_by_fid = {c.fid: c for c in chunks}
        for view in view_from_visibles(visibles, offset, size):
            blob = self.fs._read_chunk(chunk_by_fid[view.fid])
            piece = blob[view.offset_in_chunk:view.offset_in_chunk
                         + view.size]
            buf[view.logic_offset - offset:
                view.logic_offset - offset + view.size] = piece
        return buf

    def _find_entry(self, path: str) -> Optional[Entry]:
        cached = self.meta_cache.get(path)
        if cached is not None:
            return None if is_negative(cached) else cached
        seq = self.meta_cache.event_seq
        entry = self.filer.find_entry(path)
        if entry is not None:
            self.meta_cache.seed(entry, as_of=seq)
        return entry

    def _entry_attr(self, entry: Entry) -> FileAttr:
        ino = self.inodes.lookup(entry.full_path)
        size = entry.file_size()
        # an open dirty handle knows the freshest size (it may also be
        # SMALLER than the entry's after an un-flushed truncate)
        dirty_sizes = [h.size for h in self._handles_for(entry.full_path)
                       if h.dirty]
        if dirty_sizes:
            size = max(dirty_sizes)
        if entry.is_directory:
            mode = statmod.S_IFDIR | 0o755
        elif entry.attr.symlink_target:
            mode = statmod.S_IFLNK | 0o777
            size = len(entry.attr.symlink_target)
        else:
            mode = statmod.S_IFREG | (entry.attr.mode & 0o777 or 0o644)
        return FileAttr(ino=ino, size=size,
                        mtime=entry.attr.mtime or time.time(),
                        mode=mode, is_dir=entry.is_directory,
                        uid=entry.attr.uid, gid=entry.attr.gid)

    def _handles_for(self, path: str) -> list[FileHandle]:
        with self._lock:
            return [h for h in self._handles.values() if h.path == path]

    def _child_path(self, parent_ino: int, name: str) -> Optional[str]:
        parent = self.inodes.path(parent_ino)
        if parent is None:
            return None
        return (parent.rstrip("/") + "/" + name) if parent != "/" \
            else "/" + name

    # ---- operations ----
    def lookup(self, parent_ino: int, name: str) -> Optional[FileAttr]:
        path = self._child_path(parent_ino, name)
        if path is None:
            return None
        entry = self._find_entry(path)
        if entry is None:
            return None
        return self._entry_attr(entry)

    def getattr(self, ino: int) -> Optional[FileAttr]:
        path = self.inodes.path(ino)
        if path is None:
            return None
        entry = self._find_entry(path)
        if entry is None:
            return None
        return self._entry_attr(entry)

    def setattr(self, ino: int, valid: int, size: int, mode: int,
                mtime: int, fh: int) -> Optional[FileAttr]:
        path = self.inodes.path(ino)
        if path is None:
            return None
        entry = self._find_entry(path)
        if entry is None:
            return None
        FATTR_SIZE = 1 << 3
        if valid & FATTR_SIZE:
            h = self._handles.get(fh)
            if h is None:
                handles = self._handles_for(path)
                h = handles[0] if handles else None
            if h is not None:
                h.truncate(size)
            else:
                # no open handle: rewrite the entry truncated
                h = FileHandle(path, entry, self)
                h.truncate(size)
                h.flush()
                h.close()
                entry = self.filer.find_entry(path)
        return self._entry_attr(entry)

    # ---- xattrs (reference weedfs_xattr.go: Entry.Extended map) ----
    XATTR_CREATE, XATTR_REPLACE = 1, 2

    def _xattr_entry(self, ino: int) -> Optional[Entry]:
        path = self.inodes.path(ino)
        return None if path is None else self._find_entry(path)

    def setxattr(self, ino: int, name: str, value: bytes,
                 flags: int) -> int:
        entry = self._xattr_entry(ino)
        if entry is None:
            return errno.ENOENT
        if flags & self.XATTR_CREATE and name in entry.extended:
            return errno.EEXIST
        if flags & self.XATTR_REPLACE and name not in entry.extended:
            return errno.ENODATA
        entry.extended[name] = value
        self.filer.update_entry(entry)
        return 0

    def getxattr(self, ino: int, name: str) -> Optional[bytes]:
        entry = self._xattr_entry(ino)
        if entry is None:
            return None
        return entry.extended.get(name)

    def listxattr(self, ino: int) -> list[str]:
        entry = self._xattr_entry(ino)
        return sorted(entry.extended) if entry is not None else []

    def removexattr(self, ino: int, name: str) -> int:
        entry = self._xattr_entry(ino)
        if entry is None:
            return errno.ENOENT
        if name not in entry.extended:
            return errno.ENODATA
        del entry.extended[name]
        self.filer.update_entry(entry)
        return 0

    def mkdir(self, parent_ino: int, name: str, mode: int) -> FileAttr:
        path = self._child_path(parent_ino, name)
        self.filer.mkdirs(path)
        return self._entry_attr(self.filer.find_entry(path))

    def unlink(self, parent_ino: int, name: str) -> int:
        path = self._child_path(parent_ino, name)
        try:
            self.filer.delete_entry(path)
        except FileNotFoundError:
            return errno.ENOENT
        except OSError:
            return errno.ENOTEMPTY
        self.inodes.forget(path)
        return 0

    def rmdir(self, parent_ino: int, name: str) -> int:
        path = self._child_path(parent_ino, name)
        entry = self._find_entry(path)
        if entry is None:
            return errno.ENOENT
        if not entry.is_directory:
            return errno.ENOTDIR
        try:
            self.filer.delete_entry(path)
        except OSError:
            return errno.ENOTEMPTY
        self.inodes.forget(path)
        return 0

    def rename(self, parent_ino: int, oldname: str, newdir_ino: int,
               newname: str) -> int:
        old = self._child_path(parent_ino, oldname)
        new = self._child_path(newdir_ino, newname)
        if old is None or new is None:
            return errno.ENOENT
        try:
            self.filer.rename_entry(old, new)
        except FileNotFoundError:
            return errno.ENOENT
        self.inodes.move(old, new)
        # repoint open handles on the file AND under a renamed directory
        # so un-flushed writes land at the new path
        prefix = old.rstrip("/") + "/"
        with self._lock:
            for h in self._handles.values():
                if h.path == old:
                    h.path = new
                elif h.path.startswith(prefix):
                    h.path = new + h.path[len(old):]
        return 0

    def open(self, ino: int) -> Optional[int]:
        path = self.inodes.path(ino)
        if path is None:
            return None
        entry = self._find_entry(path)
        if entry is None or entry.is_directory:
            return None
        h = FileHandle(path, entry, self)
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = h
        return fh

    def create(self, parent_ino: int, name: str,
               mode: int) -> tuple[FileAttr, int]:
        path = self._child_path(parent_ino, name)
        now = time.time()
        entry = Entry(full_path=path,
                      attr=Attr(mtime=now, crtime=now,
                                mode=mode & 0o777, file_size=0))
        self.filer.create_entry(entry)
        h = FileHandle(path, entry, self)
        h.dirty = True
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = h
        return self._entry_attr(entry), fh

    def read(self, ino: int, fh: int, offset: int,
             size: int) -> Optional[bytes]:
        h = self._handles.get(fh)
        if h is None:
            return None
        return h.read(offset, size)

    def write(self, ino: int, fh: int, offset: int,
              data: bytes) -> Optional[int]:
        h = self._handles.get(fh)
        if h is None:
            return None
        return h.write(offset, data)

    def flush(self, ino: int, fh: int) -> None:
        h = self._handles.get(fh)
        if h is not None:
            h.flush()

    def release(self, ino: int, fh: int) -> None:
        h = self._handles.get(fh)
        try:
            if h is not None:
                try:
                    h.flush()
                finally:
                    h.close()
        finally:
            # always drop the handle — a failed flush must not leave a
            # dead dirty handle pinning stale sizes in _entry_attr
            with self._lock:
                self._handles.pop(fh, None)

    def symlink(self, parent_ino: int, name: str,
                target: str) -> Optional[FileAttr]:
        """reference weedfs_symlink.go: the target rides the entry's
        attributes, no data chunks."""
        path = self._child_path(parent_ino, name)
        if path is None or self._find_entry(path) is not None:
            return None
        now = time.time()
        entry = Entry(full_path=path,
                      attr=Attr(mtime=now, crtime=now, mode=0o777,
                                symlink_target=target))
        self.filer.create_entry(entry)
        return self._entry_attr(entry)

    def readlink(self, ino: int) -> Optional[str]:
        path = self.inodes.path(ino)
        entry = self._find_entry(path) if path else None
        if entry is None or not entry.attr.symlink_target:
            return None
        return entry.attr.symlink_target

    def link(self, old_ino: int, newparent_ino: int,
             newname: str) -> Optional[FileAttr]:
        """Hard link (reference weedfs_link.go): both names share the
        data through the filer's hard-link id. POSIX link(2): an
        existing destination is EEXIST, never a silent replace."""
        src = self.inodes.path(old_ino)
        dst = self._child_path(newparent_ino, newname)
        if src is None or dst is None:
            return None
        if self._find_entry(dst) is not None:
            raise FileExistsError(dst)  # fuse maps to EEXIST
        try:
            entry = self.filer.add_hard_link(src, dst)
        except (FileNotFoundError, IsADirectoryError):
            return None
        return self._entry_attr(entry)

    STATFS_TTL = 10.0

    def statfs(self):
        """(blocks, bfree, bavail, files, ffree) in 4096-byte units from
        the master topology (reference weedfs_statfs.go -> filer
        Statistics). Cached on a TTL with a SHORT timeout: this runs in
        the single-threaded FUSE loop, so a slow master must degrade to
        stale/static numbers, never stall the whole mount."""
        now = time.time()
        cached = getattr(self, "_statfs_cache", None)
        if cached is not None and cached[0] > now:
            return cached[1]
        from seaweedfs_tpu_torch.cluster.topology import \
            aggregate_topology_info
        from seaweedfs_tpu_torch.utils.httpd import http_json
        master = self.fs.mc.leader or self.fs.mc.master_urls[0]
        try:
            topo = http_json("GET", f"http://{master}/dir/status",
                             timeout=2.0)
        except Exception:
            # re-arm the TTL with the stale value: a down master must
            # not cost 2s PER statfs once the cache expires
            stale = cached[1] if cached else None
            self._statfs_cache = (now + self.STATFS_TTL, stale)
            return stale
        agg = aggregate_topology_info(topo.get("Topology", topo))
        if agg["slots"] == 0 and not self.collection_capacity:
            # no volume servers registered (yet): report the static
            # defaults rather than a 0-bytes-free filesystem
            result = None
        else:
            limit_mb = topo.get("VolumeSizeLimitMB", 1024)
            total = agg["slots"] * limit_mb * 1024 * 1024
            if self.collection_capacity:
                # admin-set quota wins over cluster capacity (used
                # bytes remain the cluster aggregate — a per-mount
                # byte meter would need per-collection accounting)
                total = self.collection_capacity
            bsize = 4096
            blocks = max(total // bsize, 1)
            bfree = max((total - agg["used_bytes"]) // bsize, 0)
            files = agg["file_count"]
            f_files = max(files * 2, 1 << 20)
            result = (blocks, bfree, bfree, f_files,
                      max(f_files - files, 1 << 19))
        self._statfs_cache = (now + self.STATFS_TTL, result)
        return result

    def readdir(self, ino: int) -> list[tuple[str, FileAttr]]:
        path = self.inodes.path(ino)
        if path is None:
            return []
        out = [(".", FileAttr(ino=ino, is_dir=True,
                              mode=statmod.S_IFDIR | 0o755)),
               ("..", FileAttr(ino=ROOT_ID, is_dir=True,
                               mode=statmod.S_IFDIR | 0o755))]
        entries = self.meta_cache.listing(path)
        if entries is None:
            seq = self.meta_cache.event_seq
            entries = self.filer.list_entries(path, limit=1 << 20)
            self.meta_cache.seed_listing(path, entries, as_of=seq)
        for e in entries:
            out.append((e.name, self._entry_attr(e)))
        return out
