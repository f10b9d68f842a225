"""Local metadata cache for the mount, kept coherent by subscribing to
the filer's metadata change log.

Redesign of reference weed/mount/meta_cache (meta_cache.go,
meta_cache_init.go, meta_cache_subscribe.go:14-45): lookups and
directory listings are served from a local entry cache; a subscription
to the filer meta log applies create/update/rename/delete events from
ANY writer (other mounts, HTTP clients, S3 gateway) so the cache never
goes stale. Directories are cached whole on first listing ("visited"
in the reference); lookups inside an un-visited directory fall through
to the filer and seed the cache.

The port's copy of seaweedfs_tpu/mount/meta_cache.py. It imports nothing
of that package.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from seaweedfs_tpu_torch.filer.entry import Entry


class MetaCache:
    def __init__(self, max_entries: int = 1 << 17):
        self._entries: dict[str, Entry] = {}
        self._listed: set[str] = set()  # dirs whose full listing is cached
        self._children: dict[str, set[str]] = {}  # dir -> child names
        self._lock = threading.RLock()
        self.max_entries = max_entries
        self._detach: Optional[Callable[[], None]] = None
        self.events_applied = 0
        # bumped on every applied event; seeds taken from a filer read
        # that STARTED before an event landed are dropped instead of
        # cached (fill/invalidate race — the reference serializes fills
        # against the subscription the same way)
        self.event_seq = 0

    # ---- subscription ----
    def attach(self, meta_log) -> None:
        """Subscribe to a filer MetaLog; events keep this cache fresh
        (reference meta_cache_subscribe.go SubscribeMetaEvents)."""
        listener = self._apply_event
        meta_log.listeners.append(listener)
        self._detach = lambda: (meta_log.listeners.remove(listener)
                                if listener in meta_log.listeners else None)

    def detach(self) -> None:
        if self._detach:
            self._detach()
            self._detach = None

    def attach_http(self, filer_addr: str) -> None:
        """Subscribe to a REMOTE filer's metadata change log by
        long-polling its /__api/meta_events endpoint — the HTTP twin of
        the gRPC SubscribeMetadata stream the reference mount uses.
        Events from other writers (HTTP clients, S3 gateway, other
        mounts) reach this cache with at most one poll of latency."""
        import threading as _th

        from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json
        stop = _th.Event()

        class _Ev:
            __slots__ = ("tsns", "directory", "old_entry", "new_entry")

        def loop():
            cursor = 0
            while not stop.is_set():
                try:
                    out = http_json(
                        "GET", f"http://{filer_addr}/__api/meta_events"
                               f"?since_ns={cursor}&wait=25",
                        timeout=40)
                except (ConnectionError, HttpError):
                    if stop.wait(1.0):
                        return
                    continue
                for d in out.get("events", []):
                    ev = _Ev()
                    ev.tsns = d.get("tsns", 0)
                    ev.directory = d.get("directory", "/")
                    ev.old_entry = d.get("old_entry")
                    ev.new_entry = d.get("new_entry")
                    self._apply_event(ev)
                    cursor = max(cursor, ev.tsns)

        t = _th.Thread(target=loop, daemon=True,
                       name="meta-cache-subscribe")
        t.start()
        prev = self._detach
        self._detach = lambda: (stop.set(),
                                prev() if prev else None) and None

    def _apply_event(self, ev) -> None:
        """MetaLogEvent -> cache mutation. old+new = update/rename,
        old only = delete, new only = create."""
        try:
            old_path = ev.old_entry["full_path"] if ev.old_entry else None
            new = Entry.from_dict(ev.new_entry) if ev.new_entry else None
        except (KeyError, ValueError, TypeError):
            return
        with self._lock:
            self.events_applied += 1
            self.event_seq += 1
            if old_path and (new is None or new.full_path != old_path):
                self._drop(old_path)
            if new is not None:
                self._insert_if_relevant(new)

    # ---- cache ops ----
    def _drop(self, path: str) -> None:
        self._entries.pop(path, None)
        parent, name = _split(path)
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(name)
        # a dropped directory invalidates its cached listing subtree
        if path in self._listed:
            self._listed.discard(path)
            self._children.pop(path, None)

    def _insert_if_relevant(self, entry: Entry) -> None:
        """Cache an event's entry only when we track its directory —
        otherwise ignore it (the reference only applies events under
        visited paths, meta_cache_subscribe.go:30-40)."""
        parent, name = _split(entry.full_path)
        if parent in self._listed or entry.full_path in self._entries:
            self._entries[entry.full_path] = entry
            if parent in self._listed:
                self._children.setdefault(parent, set()).add(name)

    def seed(self, entry: Entry, as_of: Optional[int] = None) -> None:
        """Cache a single entry fetched from the filer. `as_of` is the
        event_seq read BEFORE the filer round-trip: if events landed in
        between, the fetched snapshot may be stale — drop it."""
        with self._lock:
            if as_of is not None and as_of != self.event_seq:
                return
            if len(self._entries) >= self.max_entries:
                self._evict()
            self._entries[entry.full_path] = entry

    def seed_listing(self, dir_path: str, entries: list[Entry],
                     as_of: Optional[int] = None) -> None:
        with self._lock:
            if as_of is not None and as_of != self.event_seq:
                return
            if len(self._entries) + len(entries) >= self.max_entries:
                self._evict()
            self._listed.add(dir_path)
            self._children[dir_path] = {e.name for e in entries}
            for e in entries:
                self._entries[e.full_path] = e

    def _evict(self) -> None:
        """Simple full reset on overflow — correctness first; the next
        lookups re-seed hot paths."""
        self._entries.clear()
        self._listed.clear()
        self._children.clear()

    def get(self, path: str) -> Optional[Entry]:
        with self._lock:
            e = self._entries.get(path)
            if e is not None:
                return e
            # inside a fully-listed dir, absence is authoritative
            parent, name = _split(path)
            if parent in self._listed:
                return _NEGATIVE
            return None

    def listing(self, dir_path: str) -> Optional[list[Entry]]:
        with self._lock:
            if dir_path not in self._listed:
                return None
            names = sorted(self._children.get(dir_path, ()))
            out = []
            for n in names:
                e = self._entries.get(_join(dir_path, n))
                if e is not None:
                    out.append(e)
            return out

    def invalidate(self, path: str) -> None:
        with self._lock:
            self._drop(path)


# sentinel: "known not to exist" (negative cache hit)
_NEGATIVE = Entry(full_path="\x00negative\x00")


def is_negative(e: Optional[Entry]) -> bool:
    return e is _NEGATIVE


def _split(path: str) -> tuple[str, str]:
    d, _, n = path.rpartition("/")
    return d or "/", n


def _join(dir_path: str, name: str) -> str:
    return ("/" + name) if dir_path == "/" else f"{dir_path}/{name}"
