"""Filer core: namespace operations over a FilerStore + meta change log.

Functional equivalent of reference weed/filer/filer.go: create/find/delete/
list entries with automatic parent-directory creation, rename, chunk
garbage collection on delete/overwrite, and a metadata change log feeding
subscriptions (the CDC backbone of filer.sync / meta.backup / mount cache
invalidation — reference filer_notify.go + util/log_buffer).

The port's copy of seaweedfs_tpu/filer/filer.py, the same code, plus
a durable mode of the persisted MetaLog (``durable=True``, which a Filer
given a ``meta_log_dir`` uses): every event written through to its
segment as it is logged, and only the newest segments kept, so a filer
server on a local store keeps its change log across a kill without the
directory growing for ever. It imports nothing of that package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterator, Optional

from seaweedfs_tpu_torch.filer.entry import (
    Attr, Entry, FileChunk, new_directory_entry)
from seaweedfs_tpu_torch.filer.entry_cache import EntryCache
from seaweedfs_tpu_torch.filer.filerstore import FilerStore, MemoryStore
from seaweedfs_tpu_torch.filer.filerstore_hardlink import (
    HardLinkStore, new_hard_link_id)


class MetaLogEvent:
    __slots__ = ("tsns", "directory", "old_entry", "new_entry",
                 "signature")

    def __init__(self, directory: str, old_entry: Optional[dict],
                 new_entry: Optional[dict], tsns: Optional[int] = None,
                 signature: int = 0):
        self.tsns = tsns or time.time_ns()
        self.directory = directory
        self.old_entry = old_entry
        self.new_entry = new_entry
        # originator tag (reference filer.sync signatures): writes
        # applied by a replicator carry its signature so the reverse
        # direction can exclude them instead of echoing forever
        self.signature = signature

    def to_dict(self) -> dict:
        return {"tsns": self.tsns, "directory": self.directory,
                "old_entry": self.old_entry, "new_entry": self.new_entry,
                "signature": self.signature}


class MetaLog:
    """Meta event log: in-memory ring for hot subscriptions + optional
    persistence of every event as JSONL segments in a directory (the
    reference persists to /topics/.system/log files inside the filer,
    filer_notify_append.go; readers replay persisted segments when their
    cursor predates the ring, filer_notify.go ReadPersistedLogBuffer).

    durable=True (the port's filer server on a local store): each event is
    written and flushed to the open segment as it is logged, so a killed
    process loses none; a segment holds SEGMENT_EVENTS events and only
    the newest ``capacity // SEGMENT_EVENTS + 1`` segments are kept."""

    SEGMENT_EVENTS = 4096

    def __init__(self, capacity: int = 65536,
                 persist_dir: "Optional[str]" = None, durable: bool = False):
        self.capacity = capacity
        self.events: list[MetaLogEvent] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.persist_dir = persist_dir
        self._seg_buf: list[str] = []
        self.listeners: list[Callable[[MetaLogEvent], None]] = []
        self.durable = durable
        self._seg_file = None
        self._seg_count = 0
        # newest persisted event when the log opened: a reader behind it
        # has events to replay although the ring is still empty
        self._persisted_tsns = 0
        if persist_dir:
            import os
            os.makedirs(persist_dir, exist_ok=True)
            if durable:
                self._persisted_tsns = self._newest_persisted_tsns()

    def append(self, ev: MetaLogEvent) -> None:
        with self._cond:
            self.events.append(ev)
            if len(self.events) > self.capacity:
                self.events = self.events[-self.capacity:]
            if self.persist_dir:
                import json
                line = json.dumps(ev.to_dict())
                if self.durable:
                    self._write_through_locked(ev.tsns, line)
                else:
                    self._seg_buf.append(line)
                    if len(self._seg_buf) >= self.SEGMENT_EVENTS:
                        self._flush_segment_locked()
            self._cond.notify_all()
        for listener in list(self.listeners):
            try:
                listener(ev)
            except Exception:
                pass

    def _flush_segment_locked(self) -> None:
        import os
        if not self._seg_buf:
            return
        path = os.path.join(self.persist_dir,
                            f"{self.events[-1].tsns}.jsonl")
        with open(path, "a") as f:
            f.write("\n".join(self._seg_buf) + "\n")
        self._seg_buf = []

    def _segments(self) -> list[str]:
        import os
        return sorted(n for n in os.listdir(self.persist_dir)
                      if n.endswith(".jsonl"))

    def _write_through_locked(self, tsns: int, line: str) -> None:
        import os
        if self._seg_file is None or self._seg_count >= self.SEGMENT_EVENTS:
            if self._seg_file is not None:
                self._seg_file.close()
            keep = self.capacity // self.SEGMENT_EVENTS + 1
            for name in self._segments()[:-(keep - 1) or None]:
                try:
                    os.remove(os.path.join(self.persist_dir, name))
                except OSError:
                    pass
            self._seg_file = open(
                os.path.join(self.persist_dir, f"{tsns}.jsonl"), "a")
            self._seg_count = 0
        self._seg_file.write(line + "\n")
        self._seg_file.flush()
        self._seg_count += 1

    def _newest_persisted_tsns(self) -> int:
        import json
        import os
        for name in reversed(self._segments()):
            with open(os.path.join(self.persist_dir, name)) as f:
                lines = f.read().splitlines()
            for line in reversed(lines):
                try:
                    return json.loads(line)["tsns"]
                except (ValueError, KeyError):
                    continue  # a line torn by a kill mid-write
        return 0

    def flush(self) -> None:
        with self._lock:
            if self.persist_dir:
                self._flush_segment_locked()
                if self._seg_file is not None:
                    self._seg_file.close()
                    self._seg_file = None

    def read_since(self, tsns: int, path_prefix: str = "/",
                   limit: int = 1024,
                   exclude_signature: int = 0) -> list[MetaLogEvent]:
        # signature exclusion happens BEFORE the limit (like the prefix
        # filter): >= limit consecutive replicated events must not
        # starve a reverse-sync reader of the native events after them
        prefix = path_prefix.rstrip("/") or "/"
        with self._lock:
            ring_start = self.events[0].tsns if self.events else None
        out: list[MetaLogEvent] = []
        # cursor predates the ring: replay persisted segments first
        if self.persist_dir and (ring_start is None or tsns < ring_start - 1):
            out.extend(self._read_persisted(tsns, prefix, limit, ring_start,
                                            exclude_signature))
        with self._lock:
            for e in self.events:
                if len(out) >= limit:
                    break
                if e.tsns <= tsns or not e.directory.startswith(prefix):
                    continue
                if exclude_signature and e.signature == exclude_signature:
                    continue
                out.append(e)
        return out[:limit]

    def _read_persisted(self, tsns: int, prefix: str, limit: int,
                        ring_start,
                        exclude_signature: int = 0) -> list[MetaLogEvent]:
        import json
        import os
        out: list[MetaLogEvent] = []
        try:
            names = sorted(os.listdir(self.persist_dir))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".jsonl"):
                continue
            try:
                with open(os.path.join(self.persist_dir, name)) as f:
                    for line in f:
                        if not line.strip():
                            continue
                        d = json.loads(line)
                        if d["tsns"] <= tsns:
                            continue
                        if ring_start is not None and d["tsns"] >= ring_start:
                            return out
                        if d["directory"].startswith(prefix) and not (
                                exclude_signature and
                                d.get("signature", 0)
                                == exclude_signature):
                            out.append(MetaLogEvent(
                                d["directory"], d.get("old_entry"),
                                d.get("new_entry"), d["tsns"],
                                signature=d.get("signature", 0)))
                        if len(out) >= limit:
                            return out
            except (OSError, ValueError):
                continue
        return out

    def latest_tsns(self) -> int:
        """Newest event timestamp in the ring (0 when empty) — lets
        prefix-filtered subscribers advance their cursor past
        non-matching events instead of re-scanning them forever."""
        with self._lock:
            return self.events[-1].tsns if self.events \
                else self._persisted_tsns

    def wait_for_events(self, tsns: int, timeout: float = 10.0) -> bool:
        with self._cond:
            if tsns < self._persisted_tsns or \
                    any(e.tsns > tsns for e in self.events):
                return True
            return self._cond.wait(timeout)


class Filer:
    def __init__(self, store: Optional[FilerStore] = None,
                 delete_chunks_fn: Optional[Callable[[list[str]], None]] = None,
                 meta_log_dir: Optional[str] = None,
                 read_chunk_fn: "Optional[Callable[[FileChunk], bytes]]"
                 = None, entry_cache: bool = True):
        # read_chunk_fn takes a FileChunk and returns its PLAINTEXT bytes
        # (filechunk_manifest.ReadFn) — used to expand manifests on GC
        # every store is wrapped for hard-link resolution (reference
        # filer.go always wraps in FilerStoreWrapper + hardlink layer)
        self.store = HardLinkStore(store or MemoryStore())
        # hot-entry + negative-lookup cache over the store; every
        # mutation funnels through _notify, which invalidates.
        # entry_cache=False is the bit-for-bit comparator switch (same
        # convention as parallel_uploads / qos).
        self.entry_cache: Optional[EntryCache] = \
            EntryCache() if entry_cache else None
        if self.entry_cache is not None:
            # store-level hook: even out-of-band mutations through
            # filer.store (tools, tests, replication shims) invalidate;
            # store-write-then-invalidate keeps the fence proof intact.
            cache = self.entry_cache
            self.store.invalidate_fn = (
                lambda p: cache.invalidate(p) if p is not None
                else cache.clear())
        # a persisted log is a server's: durable (written through, bounded)
        self.meta_log = MetaLog(persist_dir=meta_log_dir, durable=True)
        self.delete_chunks_fn = delete_chunks_fn
        self.read_chunk_fn = read_chunk_fn  # to expand manifest chunks on GC
        self._lock = threading.RLock()
        self._sig = threading.local()  # per-request originator tag
        root = self.store.find_entry("/")
        if root is None:
            self.store.insert_entry(new_directory_entry("/"))

    def set_signature(self, signature: int) -> None:
        """Tag this thread's subsequent mutations with a replicator
        signature (reference filer.sync signatures); 0 clears it."""
        self._sig.value = signature

    # ---- entry ops ----
    def create_entry(self, entry: Entry, o_excl: bool = False) -> Entry:
        with self._lock:
            self._ensure_parents(entry.dir_path)
            old = self.store.find_entry(entry.full_path)
            if old is not None:
                if o_excl:
                    raise FileExistsError(entry.full_path)
                if not old.is_directory:
                    self._gc_replaced_entry(old, entry)
            if old is not None and old.is_directory and not entry.is_directory:
                raise IsADirectoryError(entry.full_path)
            self.store.insert_entry(entry)
        self._notify(entry.dir_path,
                     old.to_dict() if old else None, entry.to_dict())
        return entry

    def find_entry(self, full_path: str) -> Optional[Entry]:
        full_path = _norm(full_path)
        cache = self.entry_cache
        if cache is None:
            return self.store.find_entry(full_path)
        cached, d = cache.get(full_path)
        if cached:
            return Entry.from_dict(d) if d is not None else None
        token = cache.begin(full_path)
        entry = self.store.find_entry(full_path)
        if entry is None:
            cache.put_negative(full_path, token)
        elif not entry.hard_link_id:
            # hard-linked names alias one shared KV record: an update
            # through a sibling name would not invalidate this one, so
            # linked entries are never cached
            cache.put(full_path, entry.to_dict(), token)
        return entry

    def update_entry(self, entry: Entry) -> None:
        old = self.store.find_entry(entry.full_path)
        self.store.update_entry(entry)
        self._notify(entry.dir_path,
                     old.to_dict() if old else None, entry.to_dict())

    def delete_entry(self, full_path: str, recursive: bool = False,
                     ignore_recursive_error: bool = False) -> None:
        full_path = _norm(full_path)
        entry = self.store.find_entry(full_path)
        if entry is None:
            raise FileNotFoundError(full_path)
        if entry.is_directory:
            children = self.store.list_directory_entries(full_path, limit=1)
            if children and not recursive:
                raise OSError(f"directory {full_path} not empty")
            if children:
                self._delete_children(full_path)
        self.store.delete_entry(full_path)
        self._gc_entry_chunks(entry)
        self._notify(entry.dir_path, entry.to_dict(), None)

    def _gc_entry_chunks(self, entry: Entry) -> None:
        """GC an unlinked entry's chunks; a hard-linked entry's chunks
        survive until the last name is removed."""
        if entry.hard_link_id:
            if self.store.unlink(entry.hard_link_id) > 0:
                return
        if entry.chunks and self.delete_chunks_fn:
            self.delete_chunks_fn(self._collect_gc_fids(entry.chunks))

    def _collect_gc_fids(self, chunks: list) -> list[str]:
        """Fids to free for a chunk list: manifest blobs AND the leaf
        chunks they reference (reference filer_delete_entry.go expands
        manifests before queueing deletions)."""
        import json as _json

        from seaweedfs_tpu_torch.filer.entry import FileChunk
        fids: list[str] = []
        for c in chunks:
            fids.append(c.fid)
            if c.is_chunk_manifest and self.read_chunk_fn is not None:
                try:
                    blob = self.read_chunk_fn(c)
                    nested = [FileChunk.from_dict(d)
                              for d in _json.loads(blob)["chunks"]]
                except Exception:
                    continue  # manifest unreadable: free what we can
                fids.extend(self._collect_gc_fids(nested))
        return fids

    def _collect_fids_strict(self, chunks: list) -> list[str]:
        """Like _collect_gc_fids but RAISES on an unreadable manifest —
        for computing keep-sets, where an incomplete answer would let
        live leaf chunks be deleted."""
        import json as _json

        from seaweedfs_tpu_torch.filer.entry import FileChunk
        fids: list[str] = []
        for c in chunks:
            fids.append(c.fid)
            if c.is_chunk_manifest:
                if self.read_chunk_fn is None:
                    raise RuntimeError("no read_chunk_fn to expand "
                                       "manifest")
                blob = self.read_chunk_fn(c)
                nested = [FileChunk.from_dict(d)
                          for d in _json.loads(blob)["chunks"]]
                fids.extend(self._collect_fids_strict(nested))
        return fids

    def _delete_children(self, dir_path: str) -> None:
        while True:
            children = self.store.list_directory_entries(dir_path, limit=256)
            if not children:
                break
            for child in children:
                if child.is_directory:
                    self._delete_children(child.full_path)
                self.store.delete_entry(child.full_path)
                self._gc_entry_chunks(child)
                self._notify(dir_path, child.to_dict(), None)

    def list_entries(self, dir_path: str, start_name: str = "",
                     include_start: bool = False, limit: int = 1024,
                     prefix: str = "") -> list[Entry]:
        return self.store.list_directory_entries(
            _norm(dir_path), start_name, include_start, limit, prefix)

    def rename_entry(self, old_path: str, new_path: str) -> Entry:
        """AtomicRenameEntry (files and whole directories)."""
        old_path, new_path = _norm(old_path), _norm(new_path)
        with self._lock:
            entry = self.store.find_entry(old_path)
            if entry is None:
                raise FileNotFoundError(old_path)
            if entry.is_directory:
                children = self.store.list_directory_entries(
                    old_path, limit=1 << 30)
                for child in children:
                    self.rename_entry(
                        child.full_path,
                        new_path + child.full_path[len(old_path):])
            entry_dict_old = entry.to_dict()
            self.store.delete_entry(old_path)
            entry.full_path = new_path
            self._ensure_parents(entry.dir_path)
            # a rename moves an existing name: no link-count change
            self.store.insert_entry(entry, count_link=False)
        self._notify(entry.dir_path, entry_dict_old, entry.to_dict())
        return entry

    def mkdirs(self, dir_path: str) -> None:
        with self._lock:
            self._ensure_parents(_norm(dir_path))

    def add_hard_link(self, src_path: str, dst_path: str) -> Entry:
        """Create dst as another name for src's data (reference
        weedfs_link.go Link: assigns a HardLinkId on first link, then
        inserts a pointer entry sharing the KV metadata record)."""
        src_path, dst_path = _norm(src_path), _norm(dst_path)
        with self._lock:
            src = self.store.find_entry(src_path)
            if src is None:
                raise FileNotFoundError(src_path)
            if src.is_directory:
                raise IsADirectoryError(src_path)
            if not src.hard_link_id:
                # rebuild (never mutate the store's object) and re-save as
                # a linked entry; its own name counts as link #1
                src = Entry(full_path=src.full_path, attr=src.attr,
                            chunks=list(src.chunks), content=src.content,
                            extended=dict(src.extended),
                            hard_link_id=new_hard_link_id())
                self.store.insert_entry(src)
            self._ensure_parents(dst_path.rsplit("/", 1)[0] or "/")
            dst = Entry(full_path=dst_path, attr=src.attr,
                        chunks=list(src.chunks), content=src.content,
                        extended=dict(src.extended),
                        hard_link_id=src.hard_link_id)
            existing_dst = self.store.find_entry(dst_path)
            if existing_dst is not None:
                if existing_dst.is_directory:
                    raise IsADirectoryError(dst_path)
                self._gc_replaced_entry(existing_dst, dst)
            self.store.insert_entry(dst)
        self._notify(dst.dir_path, None, dst.to_dict())
        return dst

    # ---- helpers ----
    def _ensure_parents(self, dir_path: str) -> None:
        dir_path = _norm(dir_path)
        if dir_path == "/" or self.store.find_entry(dir_path) is not None:
            return
        self._ensure_parents(dir_path.rsplit("/", 1)[0] or "/")
        entry = new_directory_entry(dir_path)
        self.store.insert_entry(entry)
        # announce the new directory so subscribers (mount meta caches,
        # filer.sync peers) see implicitly-created parents too
        self._notify(entry.dir_path, None, entry.to_dict())

    def _gc_replaced_entry(self, old: Entry, new: Entry) -> None:
        """Overwriting a name: free the old data — unless other hard
        links still reference it (then just drop this name's link).
        When manifests are involved, compare the fully-expanded fid
        sets: a new manifest may reference leaf chunks that the old
        entry's manifests also referenced, and those must survive."""
        if old.hard_link_id and old.hard_link_id != new.hard_link_id:
            if self.store.unlink(old.hard_link_id) > 0:
                return  # data lives on under other names
        has_manifest = any(c.is_chunk_manifest
                           for c in (*old.chunks, *new.chunks))
        if has_manifest:
            # the keep-set must FAIL CLOSED: if the new entry's manifest
            # can't be read we cannot know which leaves are live, so we
            # skip GC entirely (leaking until vacuum beats deleting data
            # the new entry still references)
            try:
                keep = set(self._collect_fids_strict(new.chunks))
            except Exception:
                return
        else:
            keep = {c.fid for c in new.chunks}
        doomed = [c for c in old.chunks if c.fid not in keep]
        if not doomed or not self.delete_chunks_fn:
            return
        fids = (self._collect_gc_fids(doomed) if has_manifest
                else [c.fid for c in doomed])
        fids = [f for f in fids if f not in keep]
        if fids:
            self.delete_chunks_fn(fids)

    def _notify(self, directory: str, old_entry: Optional[dict],
                new_entry: Optional[dict]) -> None:
        # invalidate BEFORE publishing: once a subscriber sees the
        # event, this filer must already answer with the new state
        if self.entry_cache is not None:
            for d in (old_entry, new_entry):
                if d is not None:
                    self.entry_cache.invalidate(d["full_path"])
        self.meta_log.append(MetaLogEvent(
            directory, old_entry, new_entry,
            signature=getattr(self._sig, "value", 0)))

    def close(self) -> None:
        self.meta_log.flush()
        self.store.close()


def _norm(p: str) -> str:
    p = "/" + p.strip("/")
    return p if p != "//" else "/"
