"""MetaAggregator: one filer's merged view of every filer's change log.

Functional equivalent of reference weed/filer/meta_aggregator.go: each
filer subscribes to its peer filers' metadata change streams and merges
them — with its own local events — into an in-memory ring that is NOT
re-persisted (peers own their durable logs; the merge is a serving
convenience). Consumers (filer.meta.tail, filer.sync across a filer
group, mount cache invalidation) read one aggregated stream instead of
N per-filer streams.

Merged events are re-stamped on the aggregator's own clock (arrival
order) and carry `source` (peer url) + `source_tsns` (the event's
timestamp on its origin filer), mirroring how the reference's
MetaAggregator buffers peer events into its own LogBuffer with local
timestamps (meta_aggregator.go:93-230).

The port's copy of seaweedfs_tpu/filer/meta_aggregator.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class AggregatedLog:
    """In-memory merged ring with blocking reads (never persisted)."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def append(self, source: str, ev: dict) -> None:
        merged = {
            "tsns": time.time_ns(),
            "source": source,
            "source_tsns": ev.get("tsns", 0),
            "directory": ev.get("directory", "/"),
            "old_entry": ev.get("old_entry"),
            "new_entry": ev.get("new_entry"),
            # replicator tag must survive the merge or the aggregated
            # stream's exclude_signature filter silently no-ops and
            # bidirectional sync over it echoes forever
            "signature": ev.get("signature", 0),
        }
        with self._cond:
            # the local clock can tie under coarse timers; keep strictly
            # increasing so cursors never skip or re-read
            if self.events and merged["tsns"] <= self.events[-1]["tsns"]:
                merged["tsns"] = self.events[-1]["tsns"] + 1
            self.events.append(merged)
            if len(self.events) > self.capacity:
                self.events = self.events[-self.capacity:]
            self._cond.notify_all()

    def read_since(self, tsns: int, path_prefix: str = "/",
                   limit: int = 1024,
                   exclude_signature: int = 0) -> list[dict]:
        # exclusion BEFORE the limit: a run of >= limit replicated
        # events must not starve the reader of what follows them
        prefix = path_prefix.rstrip("/") or "/"
        with self._lock:
            return [e for e in self.events
                    if e["tsns"] > tsns
                    and e["directory"].startswith(prefix)
                    and not (exclude_signature and
                             e.get("signature", 0) == exclude_signature)
                    ][:limit]

    def latest_tsns(self) -> int:
        with self._lock:
            return self.events[-1]["tsns"] if self.events else 0

    def wait_for_events(self, tsns: int, timeout: float = 10.0) -> bool:
        with self._cond:
            if any(e["tsns"] > tsns for e in self.events):
                return True
            return self._cond.wait(timeout)


class MetaAggregator:
    """Follows peer filers' change streams into an AggregatedLog.

    Peers are discovered through `get_peers_fn` (normally the master's
    cluster membership list, reference filer.go MetaAggregator wiring);
    a follower thread per peer resumes from its last seen cursor and
    survives peer restarts. Local events arrive synchronously via the
    local MetaLog's listener hook (no self-HTTP loop)."""

    POLL_WAIT = 2.0

    def __init__(self, self_url: str,
                 get_peers_fn: Callable[[], list[str]],
                 local_meta_log=None):
        self.self_url = self_url
        self.get_peers_fn = get_peers_fn
        self.log = AggregatedLog()
        # called with (peer_url, event_dict) for every PEER event as it
        # arrives (local events already flow through the local MetaLog's
        # own listeners) — the filer server hooks shard-cache
        # invalidation for remote-owned parents here
        self.listeners: list[Callable[[str, dict], None]] = []
        self._stop = threading.Event()
        self._followers: dict[str, threading.Thread] = {}
        self._lock = threading.Lock()
        if local_meta_log is not None:
            local_meta_log.listeners.append(
                lambda ev: self.log.append(self.self_url, ev.to_dict()))

    def start(self) -> None:
        threading.Thread(target=self._discovery_loop, daemon=True,
                         name="meta-discovery").start()

    def stop(self) -> None:
        self._stop.set()

    def _discovery_loop(self) -> None:
        while not self._stop.is_set():
            try:
                peers = self.get_peers_fn()
            except Exception:
                peers = []
            with self._lock:
                for peer in peers:
                    if peer == self.self_url or peer in self._followers:
                        continue
                    t = threading.Thread(target=self._follow_peer,
                                         args=(peer,), daemon=True,
                                         name="meta-follow")
                    self._followers[peer] = t
                    t.start()
            self._stop.wait(3.0)

    def _follow_peer(self, peer: str) -> None:
        from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json
        cursor = 0
        while not self._stop.is_set():
            try:
                out = http_json(
                    "GET",
                    f"http://{peer}/__api/meta_events?since_ns={cursor}"
                    f"&wait={self.POLL_WAIT}",
                    timeout=self.POLL_WAIT + 30)
            except (ConnectionError, HttpError, OSError):
                self._stop.wait(1.0)
                continue
            for ev in out.get("events", []):
                cursor = max(cursor, ev["tsns"])
                self.log.append(peer, ev)
                for listener in list(self.listeners):
                    try:
                        listener(peer, ev)
                    except Exception:
                        pass
