"""filer.sync / filer.meta.tail / filer.meta.backup — meta-event consumers.

Functional equivalents of reference weed/command/filer_sync.go,
filer_meta_tail.go, filer_meta_backup.go: subscribe to a filer's metadata
change stream (our /__api/meta_events long-poll) and apply/print/persist
the events.

The port's copy of seaweedfs_tpu/replication/sync.py, reading the port's
filer_pb stream. One difference on purpose: a failed probe of a filer's
gRPC plane closes its channel, where the JAX one leaves it open with a
polling thread. It imports nothing of that package.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional

from seaweedfs_tpu_torch.replication.sink import Replicator, ReplicationSink
from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json


def _probe_filer_grpc(filer_url: str):
    """GrpcFilerClient if the filer serves its gRPC plane (port+10000
    convention), else None. A failed probe closes its channel: left
    open, the channel's connectivity poller (a thread) would go on
    polling for the life of the process."""
    ch = None
    try:
        import grpc as _grpc

        from seaweedfs_tpu_torch.server.filer_grpc import GrpcFilerClient
        from seaweedfs_tpu_torch.utils.tls import make_channel
        ip, port = filer_url.rsplit(":", 1)
        addr = f"{ip}:{int(port) + 10000}"
        ch = make_channel(addr)  # honors security.toml mTLS
        _grpc.channel_ready_future(ch).result(timeout=0.5)
        ch.close()
        return GrpcFilerClient(addr)
    except Exception:
        if ch is not None:
            ch.close()
        return None


def _pb_event_to_dict(resp) -> dict:
    from seaweedfs_tpu_torch.server.filer_grpc import _entry_from_pb
    ev = {"tsns": resp.ts_ns, "directory": resp.directory}
    en = resp.event_notification
    ev["old_entry"] = (_entry_from_pb(resp.directory,
                                      en.old_entry).to_dict()
                       if en.HasField("old_entry") else None)
    ev["new_entry"] = (_entry_from_pb(resp.directory,
                                      en.new_entry).to_dict()
                       if en.HasField("new_entry") else None)
    return ev


def _grpc_event_stream(client, since_ns: int, path_prefix: str,
                       idle_tick: float = 5.0):
    """Adapt the filer_pb SubscribeMetadata stream to the event-dict shape
    the HTTP long-poll yields — including the None idle ticks consumers
    use to stop cleanly. A pump thread feeds a queue; stream errors
    re-raise in the consumer."""
    import queue as _queue

    call = client.subscribe_metadata(since_ns=since_ns,
                                     path_prefix=path_prefix)
    # bounded: a slow consumer backpressures the pump (put blocks),
    # which stops reading the gRPC stream instead of buffering the
    # whole event backlog in memory (weedlint unbounded-pool)
    q: "_queue.Queue" = _queue.Queue(maxsize=256)

    def pump():
        try:
            for resp in call:
                q.put(("ev", resp))
            q.put(("end", None))
        except Exception as e:
            q.put(("err", e))

    threading.Thread(target=pump, daemon=True,
                     name="sync-pump").start()
    try:
        while True:
            try:
                kind, item = q.get(timeout=idle_tick)
            except _queue.Empty:
                yield None  # idle tick (parity with the HTTP long-poll)
                continue
            if kind == "ev":
                yield _pb_event_to_dict(item)
            elif kind == "err":
                raise item
            else:
                return
    finally:
        call.cancel()


def subscribe_meta_events(filer_url: str, since_ns: int = 0,
                          path_prefix: str = "/",
                          poll_wait: float = 5.0,
                          aggregated: bool = False,
                          use_grpc: bool = True):
    """Generator of meta events from a filer, resuming from since_ns.
    Speaks the filer's gRPC SubscribeMetadata stream when it is up
    (local-log subscription), else the HTTP long-poll. With
    aggregated=True the filer serves its MetaAggregator's merged
    cluster-wide stream (reference SubscribeMetadata) instead of its
    local log (SubscribeLocalMetadata) — HTTP only."""
    cursor = since_ns
    while use_grpc and not aggregated:
        client = _probe_filer_grpc(filer_url)
        if client is None:
            break  # no gRPC plane: fall through to the HTTP long-poll
        try:
            for ev in _grpc_event_stream(client, cursor, path_prefix):
                if ev is not None:
                    cursor = max(cursor, ev["tsns"])
                yield ev
            return  # server closed the stream cleanly
        except Exception:
            # mid-stream failure (e.g. filer restart): resume from the
            # cursor — re-probe gRPC, or drop to HTTP if it stays gone
            time.sleep(1.0)
        finally:
            client.close()
    since_ns = cursor if use_grpc and not aggregated else since_ns
    agg = "&aggregated=true" if aggregated else ""
    while True:
        try:
            out = http_json(
                "GET",
                f"http://{filer_url}/__api/meta_events?since_ns={since_ns}"
                f"&prefix={path_prefix}&wait={poll_wait}{agg}",
                timeout=poll_wait + 30)
        except (ConnectionError, HttpError):
            time.sleep(1.0)
            continue
        events = out.get("events", [])
        if not events:
            # the server cursor skips past non-matching/excluded
            # events, so an idle subscriber doesn't re-scan them on
            # every poll
            since_ns = max(since_ns, out.get("cursor", since_ns))
            yield None  # idle tick (lets callers stop cleanly)
            continue
        for ev in events:
            since_ns = max(since_ns, ev["tsns"])
            yield ev


class FilerSync:
    """Continuous one-way sync source-filer -> sink (half of the
    reference's bidirectional filer.sync; BidirectionalSync pairs two
    of these with signature exclusion so they never echo)."""

    def __init__(self, source_filer_url: str, sink: ReplicationSink,
                 path_prefix: str = "/", exclude_signature: int = 0):
        self.source = source_filer_url
        self.replicator = Replicator(sink, source_filer_url, path_prefix)
        self.path_prefix = path_prefix
        self.exclude_signature = exclude_signature
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.applied = 0

    def run_once(self, since_ns: int = 0, wait: float = 0) -> int:
        """Apply all currently-available events; returns last tsns.
        wait > 0 long-polls server-side instead of returning empty."""
        url = (f"http://{self.source}/__api/meta_events"
               f"?since_ns={since_ns}&prefix={self.path_prefix}")
        if self.exclude_signature:
            url += f"&exclude_signature={self.exclude_signature}"
        if wait > 0:
            url += f"&wait={wait}"
        out = http_json("GET", url)
        last = since_ns
        for ev in out.get("events", []):
            self.replicator.apply_event(ev)
            self.applied += 1
            last = max(last, ev["tsns"])
        # the server's cursor also advances past trailing excluded /
        # non-matching events so they aren't re-scanned every poll
        return max(last, out.get("cursor", last))

    def start(self, since_ns: int = 0) -> None:
        def loop():
            import logging
            log = logging.getLogger("seaweedfs_tpu_torch.sync")
            cursor = since_ns
            while not self._stop.is_set():
                try:
                    # 2s server-side long poll: an idle pair costs one
                    # blocked request per direction instead of 5
                    # scans/sec (remote_sync.py uses the same wait=)
                    cursor = self.run_once(cursor, wait=2.0)
                except (ConnectionError, HttpError, OSError) as e:
                    # transient sink/source failures (incl. the S3
                    # sink's IOError on non-2xx) must not kill the
                    # daemon — log and retry from the same cursor
                    log.warning("sync pass failed, retrying: %s", e)
                    self._stop.wait(0.5)
                self._stop.wait(0.05)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="filer-sync")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class BidirectionalSync:
    """Active-active filer.sync (reference command/filer_sync.go): two
    one-way FilerSync daemons whose sinks tag writes with per-direction
    signatures, each excluding the other's signature from its event
    stream so replicated writes are never echoed back."""

    def __init__(self, filer_a: str, filer_b: str,
                 a_prefix: str = "/", b_prefix: str = "/"):
        import zlib
        from seaweedfs_tpu_torch.replication.sink import FilerSink
        sig_ab = zlib.crc32(f"{filer_a}=>{filer_b}".encode()) or 1
        sig_ba = zlib.crc32(f"{filer_b}=>{filer_a}".encode()) or 1
        self.a_to_b = FilerSync(
            filer_a, FilerSink(filer_b, signature=sig_ab),
            path_prefix=a_prefix, exclude_signature=sig_ba)
        self.b_to_a = FilerSync(
            filer_b, FilerSink(filer_a, signature=sig_ba),
            path_prefix=b_prefix, exclude_signature=sig_ab)

    def start(self, since_ns: int = 0) -> None:
        self.a_to_b.start(since_ns)
        self.b_to_a.start(since_ns)

    def stop(self) -> None:
        self.a_to_b.stop()
        self.b_to_a.stop()


def meta_tail(filer_url: str, path_prefix: str = "/", since_ns: int = 0,
              emit: Callable[[dict], None] = None,
              max_events: Optional[int] = None,
              aggregated: bool = False,
              stop_on_idle: bool = False) -> int:
    """Print (or hand to `emit`) meta events as they happen
    (reference filer_meta_tail.go). Returns events seen.
    stop_on_idle: return at the first idle tick — "drain what exists
    now" semantics for one-shot dumps instead of tailing forever."""
    emit = emit or (lambda ev: print(json.dumps(ev)))
    seen = 0
    # one-shot drains skip the gRPC stream and use a sub-second poll so
    # the trailing idle tick costs ~0.2s, not the 5s long-poll timeout
    kwargs = ({"poll_wait": 0.2, "use_grpc": False}
              if stop_on_idle else {})
    for ev in subscribe_meta_events(filer_url, since_ns, path_prefix,
                                    aggregated=aggregated, **kwargs):
        if ev is None:
            if stop_on_idle or max_events is not None:
                break
            continue
        emit(ev)
        seen += 1
        if max_events is not None and seen >= max_events:
            break
    return seen


def meta_backup(filer_url: str, backup_path: str, path_prefix: str = "/",
                since_ns: int = 0, max_events: Optional[int] = None,
                stop_on_idle: bool = False) -> int:
    """Append meta events to a JSONL file (reference filer_meta_backup.go
    with the file 'store')."""
    count = 0
    with open(backup_path, "a") as f:
        def emit(ev):
            f.write(json.dumps(ev) + "\n")
        count = meta_tail(filer_url, path_prefix, since_ns, emit,
                          max_events, stop_on_idle=stop_on_idle)
    return count
