"""Filer HTTP server: a file-system namespace over the object store.

Functional equivalent of reference weed/server/filer_server*.go:

  POST/PUT <path>      upload: body is split into chunks, each assigned +
                       uploaded to volume servers (auto-chunking,
                       reference filer_server_handlers_write_autochunk.go);
                       small files are inlined in the entry
  GET  <path>          file -> stream assembled chunks; dir -> JSON listing
  DELETE <path>        delete entry (+ ?recursive=true), chunks GC'd
  POST /__api/rename   {"from":..., "to":...}
  GET  /__api/meta_events?since_ns=N&prefix=/  meta change log (CDC)

The port's copy of seaweedfs_tpu/server/filer_server.py: every route, on
the port's filer, client and HTTP core. It takes no device: the card is
reached through the volume servers that hold the chunks. ``grpc_port``
starts the filer_pb gRPC plane (server/filer_grpc.py) with its S3
``Configure`` service. Two differences on purpose: chunk GC is one worker
draining a queue, which retries a shed or failed delete with backoff
(``GC_ATTEMPTS``) and counts every outcome in ``chunk_gc_total``
(``abandoned``: a chunk left behind), where the JAX filer starts a thread
per deleted entry and tries each fid once; and a filer on a local store
(lsm, sqlite) persists its change log in ``<store_dir>/filer_meta_log``,
every event written through (filer/filer.py MetaLog ``durable``), and
replays it to a reader after a restart, where the JAX filer starts with
an empty log. It imports nothing of that package.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import (FIRST_COMPLETED, CancelledError,
                                ThreadPoolExecutor, as_completed, wait)
from typing import Optional

from seaweedfs_tpu_torch.client import operation
from seaweedfs_tpu_torch.client.wdclient import MasterClient
from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk
from seaweedfs_tpu_torch.filer.filechunk_manifest import (
    MANIFEST_BATCH, has_chunk_manifest, maybe_manifestize,
    resolve_chunk_manifest)
from seaweedfs_tpu_torch.filer.filechunks import (
    non_overlapping_visible_intervals, view_from_visibles)
from seaweedfs_tpu_torch.filer.entry_cache import EntryCache
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filer_conf import FilerConf, PathConf
from seaweedfs_tpu_torch.filer.filerstore import make_store
from seaweedfs_tpu_torch.filer.shard_ring import (
    ShardRing, format_shard_header, parent_dir)
from seaweedfs_tpu_torch.qos import (
    BACKGROUND, QosGovernor, class_scope, classify, current_class,
    from_headers)
from seaweedfs_tpu_torch.utils import headers as weed_headers
from seaweedfs_tpu_torch.utils import clockctl, glog, profiler, tracing
from seaweedfs_tpu_torch.utils.httpd import (
    HttpError, HttpServer, RangeNotSatisfiable, Request, Response, http_call,
    parse_byte_range)
from seaweedfs_tpu_torch.utils.resilience import (
    Deadline, PeerHealth, current_deadline, deadline_scope, hedged)

CHUNK_SIZE = 4 * 1024 * 1024
INLINE_LIMIT = 2048  # small content stored in the entry itself
READ_DEADLINE_S = 30.0  # edge deadline for a filer GET without one
# Concurrent chunk uploads per filer process (reference
# filer_server_handlers_write_upload.go uploads via a bounded
# goroutine pool); shared across requests so a burst of PUTs can't
# multiply into unbounded sockets/threads.
UPLOAD_WORKERS = int(os.environ.get("SEAWEEDFS_TPU_FILER_UPLOAD_WORKERS",
                                    "8"))
# streaming ingest memory cap: at most this many chunk uploads in
# flight while the NEXT chunk buffer fills — peak body memory is
# (STREAM_INFLIGHT + 1) * CHUNK_SIZE regardless of object size
STREAM_INFLIGHT = 2
# fids are pre-minted in waves this big while streaming (the object's
# total chunk count is unknown until EOF); unwritten leftovers are
# just unused fids
STREAM_ASSIGN_WAVE = 8


def _read_full(stream, n: int) -> bytes:
    """Read exactly n bytes from a BodyStream (short only at end of
    body): chunked transfer encoding hands out one wire chunk per
    read, so a single read() can come up short mid-body."""
    out = stream.read(n)
    if len(out) >= n or not out:
        return out
    parts = [out]
    got = len(out)
    while got < n:
        piece = stream.read(n - got)
        if not piece:
            break
        parts.append(piece)
        got += len(piece)
    return b"".join(parts)


def _ttl_seconds(ttl: str) -> int:
    """Parse '3m'/'4h'/'5d'/'6w'-style TTLs (reference needle/volume_ttl.go)."""
    if not ttl:
        return 0
    units = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800}
    if ttl[-1] in units:
        try:
            return int(ttl[:-1]) * units[ttl[-1]]
        except ValueError:
            return 0
    try:
        return int(ttl) * 60
    except ValueError:
        return 0


class FilerServer:
    def __init__(self, master_url: str, host: str = "127.0.0.1",
                 port: int = 0, store: str = "memory",
                 store_dir: Optional[str] = None,
                 default_replication: str = "", cipher: bool = False,
                 announce: bool = True, grpc_port: Optional[int] = None,
                 qos: bool = True,
                 tracing_enabled: bool = True,
                 trace_sample: float = 0.01,
                 profile_hz: float = profiler.DEFAULT_HZ,
                 sharding: bool = False,
                 entry_cache: bool = True,
                 assign_leases: bool = True):
        # qos=False disables admission control entirely (the
        # bit-for-bit comparator, same convention as parallel_uploads)
        # cipher=True encrypts every chunk (AES-256-GCM, per-chunk key in
        # the chunk metadata) so volume servers hold only ciphertext
        # (reference `weed filer -encryptVolumeData`)
        # assign_leases routes _upload_chunks/_stream_chunks fid
        # assigns through the direct-to-volume lease lane inside
        # MasterClient.assign (fallback: master /dir/assign) — writes
        # keep flowing through a master leader outage while volume
        # servers hold valid leases. False = every assign round-trips
        # the master, the comparator.
        self.cipher = cipher
        # announce=False: gateway mode (remote metadata store) — don't
        # register as a filer or aggregate peers
        self.announce = announce
        # announce cadence doubles as the rebalance-telemetry cadence;
        # callers shorten it to speed planner convergence
        self.announce_interval_s = 15.0
        self._grpc_port_arg = grpc_port
        self._grpc_server = None
        self.grpc_port: Optional[int] = None
        self.master_url = master_url
        self.assign_leases = assign_leases
        self.mc = MasterClient(master_url, assign_leases=assign_leases)
        kwargs = {}
        if store == "sqlite":
            kwargs["path"] = (store_dir or ".") + "/filer.db"
        elif store == "lsm":
            kwargs["path"] = (store_dir or ".") + "/filer_lsm"
        elif store == "remote":
            # gateway mode: metadata lives on another filer
            # (filer/remote_store.py); store_dir carries its address
            kwargs["filer_addr"] = store_dir
        elif store in ("redis", "etcd", "mysql", "postgres", "mongodb",
                       "cassandra", "elastic"):
            # store_dir carries the database address "host:port"
            # (reference filer.toml [redis2] address / [etcd] servers /
            # [mysql]/[postgres] hostname+port / [mongodb] uri); a
            # non-address value (e.g. the CLI's default -dir ".")
            # means localhost on the protocol's standard port
            default_port = {"redis": 6379, "etcd": 2379, "mysql": 3306,
                            "postgres": 5432, "mongodb": 27017,
                            "cassandra": 9042, "elastic": 9200}[store]
            addr = store_dir if store_dir and ":" in store_dir \
                else f"127.0.0.1:{default_port}"
            db_host, _, db_port = addr.rpartition(":")
            kwargs["host"] = db_host or "127.0.0.1"
            kwargs["port"] = int(db_port)
        # a local store keeps the change log beside it across restarts
        # (the JAX filer loses it)
        self.filer = Filer(make_store(store, **kwargs),
                           delete_chunks_fn=self._delete_chunks,
                           read_chunk_fn=self._read_chunk,
                           entry_cache=entry_cache,
                           meta_log_dir=os.path.join(
                               store_dir or ".", "filer_meta_log")
                           if store in ("lsm", "sqlite") else None)
        # horizontal metadata scale-out: when sharding=True this filer
        # is one member of a consistent-hash ring over DIRECTORIES
        # (filer/shard_ring.py) — it serves only the namespace slices
        # it owns and 307-redirects (or forwards) the rest.  Opt-in:
        # plain multi-filer deployments (meta aggregation, sync)
        # replicate the whole namespace everywhere and must not start
        # bouncing requests just because several filers registered.
        self.sharding = sharding
        self.shard_ring: Optional[ShardRing] = None
        self._ring_pinned = False
        # positive facts about CANONICAL ancestor rows this shard has
        # already ensured on their owners; invalidated by peer meta
        # events so a remote delete re-triggers the ensure walk
        self._remote_parents = EntryCache(capacity=4096, neg_capacity=0)
        # live rebalancing executor: streams one directory's rows to a
        # new owner in the background on master move orders, then the
        # ring flips at commit (filer/rebalance.py)
        from seaweedfs_tpu_torch.filer.rebalance import DirectoryMover
        self.mover = DirectoryMover(self)
        self.filer_conf = FilerConf.load(self.filer.store)
        self._filer_conf_loaded = clockctl.now()
        self._filer_conf_write_lock = threading.Lock()
        from seaweedfs_tpu_torch.filer.remote_mount import RemoteMounts
        self.remote_mounts = RemoteMounts(self.filer)
        self.default_replication = default_replication
        from seaweedfs_tpu_torch.filer.reader_cache import ReaderCache
        from seaweedfs_tpu_torch.utils.chunk_cache import TieredChunkCache
        self.chunk_cache = TieredChunkCache()
        # single-flight + prefetch in front of volume fetches
        # (reference filer/reader_cache.go backing reader_at.go)
        self.reader_cache = ReaderCache(self._fetch_chunk_remote,
                                        self.chunk_cache)
        # reference stats/metrics.go filer subsystem: request counter +
        # latency histogram per handler type
        from seaweedfs_tpu_torch.utils.metrics import Registry
        self.metrics = Registry()
        self._m_req = self.metrics.counter(
            "filer", "request_total", "filer requests", ("type",))
        self._m_lat = self.metrics.histogram(
            "filer", "request_seconds", "filer request latency", ("type",))
        self._m_shard = self.metrics.counter(
            "filer", "shard_route_total", "sharded routing outcomes",
            ("outcome",))
        self._m_gc = self.metrics.counter(
            "filer", "chunk_gc_total", "chunk deletes: deleted, retried, "
            "abandoned (still there after GC_ATTEMPTS)", ("outcome",))
        # parallel_uploads=False keeps the serial per-chunk
        # assign+upload loop as the comparator
        self.parallel_uploads = True
        # streaming_ingest=False buffers whole bodies before chunking
        # — the bit-for-bit comparator for the streaming path (same
        # convention as parallel_uploads/qos)
        self.streaming_ingest = True
        # volume_redirect=False proxies every GET through this filer —
        # the bit-identity comparator for the 302 volume-direct path
        # (eligible single-chunk entries answer with a JWT-stamped
        # volume URL instead of relaying the payload)
        self.volume_redirect = True
        # below this size the proxy hop is cheaper than a client
        # round-trip + new connection, and the filer's reader cache /
        # deadline-bounded hedged fetches keep serving the hot small
        # tail — only bulk reads skip the filer
        self.volume_redirect_min = 256 * 1024
        self._upload_pool: Optional[ThreadPoolExecutor] = None
        self._upload_pool_lock = threading.Lock()
        # chunk GC: one worker drains a queue of (fid, attempt, not
        # before) — see _delete_chunks
        self._gc_cond = threading.Condition()
        self._gc_queue: list[tuple[str, int, float]] = []
        self._gc_thread: Optional[threading.Thread] = None
        self._gc_stop = False
        # per-volume-server breakers/latency for hedged chunk fetches
        self.peer_health = PeerHealth(metrics=self.metrics)
        # admission control at the filer edge: class-weighted adaptive
        # concurrency + per-tenant buckets keyed by client IP
        self.qos = QosGovernor(metrics=self.metrics, enabled=qos)
        self.http = HttpServer(host, port)
        self.http.admission_gate = self._admission_gate
        # metrics ride their own listener (reference filer -metricsPort):
        # every path on the main port is user namespace, so a /metrics
        # route there would shadow a stored file of that name
        self.metrics_http = HttpServer(host, 0)
        self.metrics_http.add("GET", "/metrics", self._handle_metrics)
        # tracing: spans are minted on the MAIN port's dispatch, but the
        # flight recorder is served from the metrics listener (the main
        # port is user namespace — /debug/traces there would shadow a
        # stored file of that name, same reason as /metrics above)
        self.tracer = tracing.Tracer(
            node=f"filer@{host}:{port}", enabled=tracing_enabled,
            sample_rate=trace_sample)
        self.http.tracer = self.tracer
        self.metrics_http.tracer = self.tracer
        # cluster telemetry plane: RED histogram at the dispatch edge +
        # hot path/tenant sketches, both served from the metrics
        # listener (main port is user namespace) and merged master-side
        from seaweedfs_tpu_torch.stats.hotkeys import HotKeys
        from seaweedfs_tpu_torch.utils.metrics import RedRecorder
        self.red = RedRecorder(self.metrics, "filer")
        self.http.red = self.red
        # "dir" feeds the master's RebalancePlanner: per-directory
        # temperature rides the announce piggyback (filer/rebalance.py)
        self.hotkeys = HotKeys(dims=("path", "tenant", "dir"))
        self.metrics_http.add("GET", "/admin/hotkeys",
                              self.hotkeys.handler(self.url))
        self.metrics_http.add("GET", "/admin/telemetry",
                              self._handle_telemetry)
        # continuous profiling + per-(class, tenant) ledger; tenant at
        # the filer edge = client IP, matching the governor's buckets.
        # /admin/profile serves from the metrics listener (main port
        # is user namespace), but tagging happens on the MAIN port's
        # dispatch — same split as tracing.
        from seaweedfs_tpu_torch.stats.ledger import ResourceLedger
        self.sampler = profiler.WallSampler(hz=profile_hz)
        self.ledger = ResourceLedger()
        self.http.ledger = self.ledger
        # ledger -> governor feedback: a tenant dominating the window's
        # burn gets a per-tenant rate cap without operator action
        # (stats/autocap.py); ticked from the announce loop
        from seaweedfs_tpu_torch.stats.autocap import LedgerAutoCapper
        self.autocap = LedgerAutoCapper(self.ledger, self.qos)
        self.metrics_http.add("GET", "/admin/profile",
                              profiler.make_profile_handler(
                                  self.sampler, lambda: self.url,
                                  "filer"))
        from seaweedfs_tpu_torch.utils.debug import install_debug_routes
        install_debug_routes(self.metrics_http)
        self._register_routes()

    def start(self) -> None:
        self.http.start()
        self.metrics_http.start()
        self.sampler.start()
        self.tracer.node = f"filer@{self.http.host}:{self.http.port}"
        glog.info("filer server up at %s (store=%s, metrics=%s)",
                  self.url, self.filer.store.name, self.metrics_url)
        if self._grpc_port_arg is not None:
            from seaweedfs_tpu_torch.server.filer_grpc import start_filer_grpc
            self._grpc_server, self.grpc_port = start_filer_grpc(
                self, self.http.host, self._grpc_port_arg)
        # external event publishing when notification.toml enables a
        # backend (reference filer.go NotifyUpdateEvent)
        from seaweedfs_tpu_torch.notification.queue import (attach_to_filer,
                                                      make_queue_from_config)
        self._notify_queue = make_queue_from_config()
        if self._notify_queue is not None:
            attach_to_filer(self.filer, self._notify_queue)
        if not self.announce:
            return
        self._announce_stop = threading.Event()
        threading.Thread(target=self._announce_loop,
                         name="filer-announce", daemon=True).start()
        # merged view of every peer filer's change log (reference
        # filer/meta_aggregator.go; peers from master cluster membership)
        from seaweedfs_tpu_torch.filer.meta_aggregator import MetaAggregator
        self.meta_aggregator = MetaAggregator(
            self.url, self._list_peer_filers, self.filer.meta_log)
        # peer mutations invalidate OUR caches: a remote create/delete
        # must kill any local hot/negative fact about that path
        self.meta_aggregator.listeners.append(self._on_peer_meta_event)
        self.meta_aggregator.start()

    def _list_peer_filers(self) -> list[str]:
        from seaweedfs_tpu_torch.utils.httpd import http_json
        out = http_json(
            "GET", f"http://{self.master_url}/cluster/nodes?type=filer",
            timeout=5)
        return [n["url"] for n in out.get("cluster_nodes", [])]

    def _announce_loop(self) -> None:
        from seaweedfs_tpu_torch.utils.httpd import http_json

        def announce():
            body = {"type": "filer", "url": self.url,
                    "metrics_url": self.metrics_url}
            if self.sharding:
                # temperature piggyback for the master's rebalance
                # planner: cumulative op count (the planner diffs
                # successive reports into a rate) + hottest directories
                body["shard_load"] = {
                    "ops": self.hotkeys.sketches["dir"].total,
                    "dirs": self.hotkeys.top(8).get("dir", [])}
            try:
                http_json("POST",
                          f"http://{self.master_url}/cluster/register",
                          body, timeout=5)
            except Exception as e:
                glog.vlog(1, "filer announce to master %s failed: %s",
                          self.master_url, e)

        announce()
        self._adopt_ring()
        while not self._announce_stop.wait(self.announce_interval_s):
            announce()
            self._adopt_ring()
            self.autocap.maybe_tick()

    # ------------------------------------------------------------------
    # namespace sharding (filer/shard_ring.py)

    def set_shard_ring(self, ring: Optional[ShardRing],
                       pin: bool = False) -> None:
        """Install the filer ring.  pin=True stops the announce loop
        from adopting master-published rings (the caller drives the
        topology by hand)."""
        self.shard_ring = ring
        if pin:
            self._ring_pinned = True
        # new epoch, new ownership: every "I already ensured this
        # ancestor on its owner" fact may now point at the wrong shard
        self._remote_parents.clear()

    def _adopt_ring(self) -> None:
        """Pull the master's filer ring; install only forward epochs."""
        if not self.sharding or self._ring_pinned:
            return
        from seaweedfs_tpu_torch.utils.httpd import http_json
        try:
            out = http_json(
                "GET", f"http://{self.master_url}/cluster/filers",
                timeout=5)
            ring = ShardRing.from_dict(out)
        except Exception as e:
            glog.vlog(1, "filer ring pull from master failed: %s", e)
            return
        cur = self.shard_ring
        if cur is None or ring.epoch > cur.epoch:
            self.set_shard_ring(ring)
            glog.info("filer %s adopted ring epoch %d (%d members)",
                      self.url, ring.epoch, len(ring))

    def _shard_active(self) -> bool:
        # a member not (yet) in the ring serves everything locally —
        # redirecting by a ring that excludes us would bounce forever
        ring = self.shard_ring
        return (self.sharding and ring is not None and len(ring) > 1
                and self.url in ring)

    def _shard_redirect(self, req: Request,
                        path: str) -> Optional[Response]:
        """None when this shard should serve `path`; otherwise the
        response that moves the request to the owner.

        GET/HEAD/PUT/POST are 307-redirected (bodies are streamed, so
        the filer can't replay them to a peer); DELETE is forwarded
        in-place so dumb clients still work.  Redirects carry
        ``X-Weed-Shard: <epoch>:<owner>`` so shard-aware clients
        (wdclient.filer_call) detect ring drift and re-resolve.  The
        ``X-Weed-Shard-Forwarded`` loop guard forces local service:
        during an epoch change two shards may briefly disagree about
        ownership, and serving the forwarder's view beats bouncing."""
        if not self._shard_active():
            return None
        ring = self.shard_ring
        owner = ring.owner_for_path(path)
        if not owner or owner == self.url:
            self._m_shard.inc("local")
            return None
        if req.headers.get(weed_headers.SHARD_FORWARDED):
            self._m_shard.inc("forced_local")
            return None
        from urllib.parse import quote, urlencode
        qs = urlencode(req.query)
        loc = f"http://{owner}{quote(path)}" + (f"?{qs}" if qs else "")
        hdr = format_shard_header(ring.epoch, owner)
        if req.method == "DELETE":
            self._m_shard.inc("forward")
            status, body, hdrs = http_call(
                "DELETE", loc,
                headers={weed_headers.SHARD_FORWARDED: "1"}, timeout=60)
            return Response(
                body, status=status,
                content_type=hdrs.get("Content-Type")
                or "application/json",
                headers={weed_headers.SHARD: hdr})
        self._m_shard.inc("redirect")
        return Response(
            {"error": "wrong shard", "owner": owner,
             "ring_epoch": ring.epoch},
            status=307,
            headers={weed_headers.SHARD: hdr, "Location": loc})

    def _on_peer_meta_event(self, peer: str, ev: dict) -> None:
        """MetaAggregator listener: a peer's mutation invalidates our
        hot/negative entries AND our remote-parent facts for the
        touched paths (a peer deleting a directory we 'ensured' means
        the next local create must re-run the ensure walk)."""
        cache = self.filer.entry_cache
        for d in (ev.get("old_entry"), ev.get("new_entry")):
            if not d:
                continue
            p = d.get("full_path", "")
            if not p:
                continue
            if cache is not None:
                cache.invalidate(p)
            self._remote_parents.invalidate(p)

    def _ensure_parents_remote(self, dir_path: str) -> None:
        """After a local create: make sure every ancestor directory's
        CANONICAL row exists on the shard owning its parent, else the
        new subtree is invisible to listings walking down from the
        root.  Positive facts are cached (_remote_parents, invalidated
        by peer meta events), so the warm-path cost is one dict hit.
        Failures are logged, not raised — the entry itself is durable,
        and the next write under the same directory retries."""
        if not self._shard_active():
            return
        from urllib.parse import quote
        ring = self.shard_ring
        d = dir_path if dir_path.startswith("/") else "/" + dir_path
        try:
            while d and d != "/":
                cached, fact = self._remote_parents.get(d)
                if cached and fact is not None:
                    # inductively, everything above was ensured too
                    break
                token = self._remote_parents.begin(d)
                owner = ring.owner_for_path(d)
                if owner == self.url:
                    if self.filer.find_entry(d) is None:
                        self.filer.mkdirs(d)
                else:
                    status, body, _ = http_call(
                        "POST", f"http://{owner}{quote(d)}?mkdir=true",
                        headers={weed_headers.SHARD_FORWARDED: "1"},
                        timeout=30)
                    if status >= 400:
                        raise HttpError(status, body)
                self._remote_parents.put(d, {"full_path": d}, token)
                d = parent_dir(d)
        except Exception as e:
            glog.warning("ensure-parents for %s failed: %s", dir_path, e)

    def _list_entries_routed(self, dir_path: str, start_name: str = "",
                             limit: int = 1024) -> list[Entry]:
        """Listing of dir_path from the shard that owns it (children
        rows live on owner(dir), so a listing is always single-shard);
        local when unsharded or self-owned."""
        if self._shard_active():
            owner = self.shard_ring.owner(dir_path)
            if owner and owner != self.url:
                from urllib.parse import urlencode
                qs = urlencode({"dir": dir_path, "start": start_name,
                                "limit": limit, "resolved": "true"})
                status, body, _ = http_call(
                    "GET", f"http://{owner}/__api/list?{qs}",
                    headers={weed_headers.SHARD_FORWARDED: "1"},
                    timeout=30)
                if status != 200:
                    raise HttpError(status, body)
                return [Entry.from_dict(d)
                        for d in json.loads(body).get("entries", [])]
        return self.filer.list_entries(dir_path, start_name=start_name,
                                       limit=limit)

    def _delete_entry_sharded(self, path: str, recursive: bool) -> None:
        """Recursive delete across shards: the canonical children of
        `path` live on owner(path); each child's delete is routed to
        ITS row's owner (which recurses the same way).  The final
        local sweep removes this shard's canonical row plus any
        skeleton remnants beneath it — those are directories only, so
        chunk GC is untouched."""
        entry = self.filer.find_entry(path)
        if entry is None:
            # creates racing a concurrent sweep can strand child rows
            # beneath a directory row the sweep already removed (a
            # peer's stale positive parent-cache skips re-creating the
            # ancestor row): clear them anyway, so a repeat recursive
            # delete converges to empty instead of 404-ing past the
            # orphans forever
            if recursive:
                self._sweep_children(path, True)
            raise FileNotFoundError(path)
        if entry.is_directory:
            self._sweep_children(path, recursive)
        self.filer.delete_entry(path, recursive=True)

    def _sweep_children(self, path: str, recursive: bool) -> None:
        """Delete every canonical child of `path`, each routed to its
        row's owner, until a listing comes back empty."""
        from urllib.parse import quote
        child_owner = self.shard_ring.owner(path)
        while True:
            children = self._list_entries_routed(path, limit=256)
            if not children:
                return
            if not recursive:
                raise OSError(f"directory {path} not empty")
            for child in children:
                if child_owner == self.url:
                    try:
                        self._delete_entry_sharded(child.full_path, True)
                    except FileNotFoundError:
                        pass  # raced another deleter: already gone
                else:
                    status, body, _ = http_call(
                        "DELETE",
                        f"http://{child_owner}"
                        f"{quote(child.full_path)}?recursive=true",
                        headers={weed_headers.SHARD_FORWARDED: "1"},
                        timeout=60)
                    if status >= 400 and status != 404:
                        raise HttpError(status, body)

    def _rename_sharded(self, frm: str, to: str) -> None:
        """Cross-shard rename: children first (a reader never sees the
        new tree without its leaves), then the row itself moves — a
        meta-only insert at the destination's owner (chunks ride
        along verbatim) followed by a LOCAL row delete without chunk
        GC.  Runs on owner(parent(frm)), i.e. where frm's row lives."""
        entry = self.filer.find_entry(frm)
        if entry is None:
            raise FileNotFoundError(frm)
        ring = self.shard_ring
        if entry.is_directory:
            child_owner = ring.owner(frm)
            children = self._list_entries_routed(frm, limit=1 << 20)
            for child in children:
                c_to = to + child.full_path[len(frm):]
                if child_owner == self.url:
                    self._rename_sharded(child.full_path, c_to)
                else:
                    status, body, _ = http_call(
                        "POST", f"http://{child_owner}/__api/rename",
                        json_body={"from": child.full_path, "to": c_to},
                        headers={weed_headers.SHARD_FORWARDED: "1"},
                        timeout=60)
                    if status >= 400:
                        raise HttpError(status, body)
        row = entry.to_dict()
        row["full_path"] = to
        self._ensure_parents_remote(parent_dir(to))
        to_owner = ring.owner_for_path(to)
        if to_owner == self.url:
            self.filer.mkdirs(parent_dir(to))
            old = self.filer.store.inner.find_entry(to)
            self.filer.store.inner.insert_entry(Entry.from_dict(row))
            self.filer._notify(parent_dir(to),
                               old.to_dict() if old else None, row)
        else:
            status, body, _ = http_call(
                "POST", f"http://{to_owner}/__api/entry",
                json_body={"entry": row, "meta_only": True},
                headers={weed_headers.SHARD_FORWARDED: "1"}, timeout=60)
            if status >= 400:
                raise HttpError(status, body)
        # drop the source ROW only — its chunks now belong to `to`
        self.filer.store.inner.delete_entry(frm)
        self.filer._notify(parent_dir(frm), entry.to_dict(), None)

    def _shard_status(self) -> dict:
        ring = self.shard_ring
        out = {
            "url": self.url,
            "sharding": self.sharding,
            "active": self._shard_active(),
            "ring": ring.to_dict() if ring is not None else None,
            "routing": {k[0]: v
                        for k, v in self._m_shard._values.items()},
            "remote_parents": self._remote_parents.snapshot(),
            "autocap": self.autocap.snapshot(),
            "mover": self.mover.status(),
        }
        if self.filer.entry_cache is not None:
            out["entry_cache"] = self.filer.entry_cache.snapshot()
        return out

    def _api_shard_status(self, req: Request) -> Response:
        return Response(self._shard_status())

    def _api_shard_ring_set(self, req: Request) -> Response:
        b = req.json()
        ring = ShardRing.from_dict(b)
        self.set_shard_ring(ring, pin=bool(b.get("pin")))
        return Response({"epoch": ring.epoch, "members": len(ring)})

    def _api_shard_migrate(self, req: Request) -> Response:
        """Master move order: migrate `dir`'s child rows to filer `to`
        in the background (filer/rebalance.py DirectoryMover).  Only
        the current owner may execute — rows move FROM here."""
        b = req.json() or {}
        directory, dest = b.get("dir", ""), b.get("to", "")
        if not directory or not dest:
            return Response({"error": "dir and to required"}, status=400)
        ring = self.shard_ring
        if not self._shard_active() or dest not in ring:
            return Response({"error": "not an active shard member"},
                            status=409)
        if ring.owner(directory) != self.url:
            return Response({"error": "not the owner",
                             "owner": ring.owner(directory)}, status=409)
        started = self.mover.start(directory, dest)
        return Response({"started": started,
                         "status": self.mover.status()})

    def stop(self) -> None:
        self.sampler.stop()
        if hasattr(self, "_announce_stop"):
            self._announce_stop.set()
        if hasattr(self, "meta_aggregator"):
            self.meta_aggregator.stop()
        if self._grpc_server is not None:
            self._grpc_server.stop(0).wait()
        self.http.stop()
        self.metrics_http.stop()
        self.metrics.stop_push()
        # only after the HTTP plane is down: in-flight mutations must
        # not hit a closed notification socket
        if getattr(self, "_notify_queue", None) is not None:
            self._notify_queue.close()
        if self._upload_pool is not None:
            self._upload_pool.shutdown(wait=False)
        with self._gc_cond:
            self._gc_stop = True
            self._gc_cond.notify_all()
        self.reader_cache.close()
        self.filer.close()

    @property
    def url(self) -> str:
        return f"{self.http.host}:{self.http.port}"

    @property
    def metrics_url(self) -> str:
        return f"{self.metrics_http.host}:{self.metrics_http.port}"

    # ---- chunk GC ----
    GC_ATTEMPTS = 8  # per fid, backing off from 0.25 s to 4 s

    def _delete_chunk(self, fid: str) -> bool:
        """One delete of a chunk at the first holder that answers; True
        when it is gone (deleted now, or already: 404)."""
        vid = int(fid.split(",")[0])
        for loc in self.mc.lookup_volume(vid):
            try:
                status, _, _ = http_call("DELETE",
                                         f"http://{loc['url']}/{fid}")
            except ConnectionError:
                continue
            return status < 400 or status == 404
        return False

    def _delete_chunks(self, fids: list[str]) -> None:
        """Queue chunks for deletion. GC is background traffic that
        volume servers may shed, and a delete an EC volume serves reads
        the needle first: one worker drains the queue, and a shed or
        failed delete goes back in with backoff, GC_ATTEMPTS times
        (seaweedfs_tpu's filer starts a thread per deleted entry and
        tries each fid once, so removing a large directory floods the
        servers and leaks what they shed; the reference queues
        deletions and retries them)."""
        with self._gc_cond:
            self._gc_queue.extend((fid, 0, 0.0) for fid in fids)
            if self._gc_thread is None:
                self._gc_thread = threading.Thread(
                    target=self._gc_loop, name="chunk-gc", daemon=True)
                self._gc_thread.start()
            self._gc_cond.notify_all()

    def _gc_loop(self) -> None:
        with class_scope(BACKGROUND):
            while True:
                with self._gc_cond:
                    while not self._gc_stop:
                        now = clockctl.monotonic()
                        ready = [t for t in self._gc_queue if t[2] <= now]
                        if ready:
                            break
                        wait = min((t[2] for t in self._gc_queue),
                                   default=now + 60.0) - now
                        self._gc_cond.wait(max(0.01, wait))
                    if self._gc_stop:
                        return
                    self._gc_queue = [t for t in self._gc_queue
                                      if t[2] > now]
                for fid, attempt, _ in ready:
                    try:
                        done = self._delete_chunk(fid)
                    except Exception as e:
                        glog.vlog(1, "chunk gc: delete %s: %s", fid, e)
                        done = False
                    if done:
                        self._m_gc.inc("deleted")
                        continue
                    self.mc.invalidate(int(fid.split(",")[0]))
                    if attempt + 1 >= self.GC_ATTEMPTS:
                        self._m_gc.inc("abandoned")
                        glog.warning("chunk gc: delete %s failed %d times",
                                     fid, self.GC_ATTEMPTS)
                        continue
                    self._m_gc.inc("retried")
                    delay = min(0.25 * 2 ** attempt, 4.0)
                    with self._gc_cond:
                        self._gc_queue.append(
                            (fid, attempt + 1,
                             clockctl.monotonic() + delay))

    # ---- routes ----
    def _register_routes(self) -> None:
        r = self.http.add
        r("GET", "/__api/qos", self._api_qos)
        r("POST", "/__api/qos", self._api_qos_configure)
        r("POST", "/__api/rename", self._api_rename)
        r("POST", "/__api/entry", self._api_put_entry)
        r("GET", "/__api/entry", self._api_get_entry)
        r("DELETE", "/__api/entry", self._api_delete_entry_row)
        r("GET", "/__api/list", self._api_list_entries)
        r("GET", "/__api/kv", self._api_kv_get)
        r("POST", "/__api/kv", self._api_kv_put)
        r("POST", "/__api/hardlink", self._api_hardlink)
        r("GET", "/__api/filer_conf", self._api_filer_conf_get)
        r("POST", "/__api/filer_conf", self._api_filer_conf_set)
        r("GET", "/__api/meta_events", self._api_meta_events)
        r("GET", "/__api/shard/status", self._api_shard_status)
        r("POST", "/__api/shard/ring", self._api_shard_ring_set)
        r("POST", "/__api/shard/migrate", self._api_shard_migrate)
        r("GET", r"/__api/chunk/(\S+)", self._api_chunk_blob)
        for method, op, handler in (
                ("GET", "status", self._api_remote_status),
                ("POST", "configure", self._api_remote_configure),
                ("POST", "mount", self._api_remote_mount),
                ("POST", "mount_buckets", self._api_remote_mount_buckets),
                ("POST", "unmount", self._api_remote_unmount),
                ("POST", "pull", self._api_remote_pull),
                ("POST", "cache", self._api_remote_cache),
                ("POST", "uncache", self._api_remote_uncache),
                ("POST", "writeback", self._api_remote_writeback),
                ("POST", "rm", self._api_remote_rm)):
            r(method, f"/__api/remote/{op}", handler)
        for method in ("POST", "PUT"):
            r(method, "/.*", self._timed(
                "write", self._signed(self._handle_write)))
        r("GET", "/.*", self._timed("read", self._handle_read))
        r("HEAD", "/.*", self._timed("head", self._handle_read))
        r("DELETE", "/.*", self._timed(
            "delete", self._signed(self._handle_delete)))

    def _handle_metrics(self, req: Request) -> Response:
        return Response(self.metrics.expose_text(),
                        content_type="text/plain; version=0.0.4")

    def telemetry_snapshot(self) -> dict:
        snap = {"node": self.url, "server": "filer",
                "red": self.red.snapshot(),
                "hotkeys": self.hotkeys.snapshot(),
                "ledger": self.ledger.snapshot(),
                "autocap": self.autocap.snapshot()}
        if self.filer.entry_cache is not None:
            snap["entry_cache"] = self.filer.entry_cache.snapshot()
        if self.shard_ring is not None:
            snap["shard"] = self._shard_status()
        return snap

    def _handle_telemetry(self, req: Request) -> Response:
        return Response(self.telemetry_snapshot())

    # ---- QoS admission ----
    # exempt: the operator's escape hatch plus long-polls, whose
    # held-open slots would both exhaust the limit and poison the
    # adaptive limiter's latency estimate with 30s samples
    QOS_EXEMPT = ("/__api/qos", "/__api/meta_events", "/__api/shard")

    def _admission_gate(self, method, path, headers, client):
        if not self.qos.enabled:
            return None
        for prefix in self.QOS_EXEMPT:
            if path.startswith(prefix):
                return None
        cls = from_headers(headers) or classify(method, path)
        grant = self.qos.admit(cls, tenant=client)
        if not grant.ok:
            self._m_req.inc("qos_shed")
            return Response(
                {"error": "overloaded", "class": cls,
                 "reason": grant.reason},
                status=503,
                headers={"Retry-After": f"{grant.retry_after:.2f}"})
        return grant.release

    def _api_qos(self, req: Request) -> Response:
        return Response({"url": self.url, **self.qos.snapshot()})

    def _api_qos_configure(self, req: Request) -> Response:
        return Response({"url": self.url,
                         **self.qos.configure(**(req.json() or {}))})

    def _timed(self, kind: str, handler):
        def wrapped(req: Request) -> Response:
            self._m_req.inc(kind)
            # hot-key sketches: which paths are hammered and by whom
            # (tenant = client IP, the same key the QoS buckets use)
            self.hotkeys.record("path", req.path.rstrip("/") or "/")
            # the dir sketch is CLIENT temperature — the rebalance
            # planner's input.  Forwarded requests are internal
            # plumbing (peer parent-ensures, mover pushes); counting
            # them would mark namespace-interior directories hot and
            # invite the planner to migrate them
            if not req.headers.get(weed_headers.SHARD_FORWARDED):
                self.hotkeys.record("dir",
                                    parent_dir(req.path.rstrip("/")
                                               or "/"))
            h = getattr(req, "handler", None)
            if h is not None:
                self.hotkeys.record("tenant", h.client_address[0])
            with self._m_lat.time(kind):
                return handler(req)
        return wrapped

    def _signed(self, handler):
        """A replicator identifies its writes with
        X-Weed-Sync-Signature so the reverse sync direction can exclude
        them from the event stream (reference filer.sync signatures)."""
        def wrapped(req: Request) -> Response:
            sig = req.headers.get(weed_headers.SYNC_SIGNATURE)
            if not sig:
                return handler(req)
            try:
                self.filer.set_signature(int(sig))
            except ValueError:
                return handler(req)
            try:
                return handler(req)
            finally:
                self.filer.set_signature(0)
        return wrapped

    # ---- write ----
    def _handle_write(self, req: Request) -> Response:
        path = req.path.rstrip("/") or "/"
        misroute = self._shard_redirect(req, path)
        if misroute is not None:
            return misroute
        if req.query.get("mkdir") == "true":
            self.filer.mkdirs(path)
            self._ensure_parents_remote(path)
            return Response({"path": path}, status=201)
        # per-path rules from filer.conf fill in what the request omits
        rule = self._current_filer_conf().match_storage_rule(path)
        if rule.read_only:
            return Response({"error": f"{rule.location_prefix} is read-only"},
                            status=403)
        collection = req.query.get("collection", "") or rule.collection
        replication = (req.query.get("replication", "")
                       or rule.replication or self.default_replication)
        ttl = req.query.get("ttl", "") or rule.ttl
        mime = (req.headers.get("Content-Type")
                or "application/octet-stream")
        content, chunks, size = self._ingest_body(
            req, collection, replication, ttl, disk_type=rule.disk_type)
        now = clockctl.now()
        entry = Entry(full_path=path,
                      attr=Attr(mtime=now, crtime=now, mime=mime,
                                file_size=size,
                                collection=collection,
                                ttl_sec=_ttl_seconds(ttl),
                                replication=replication))
        entry.content = content
        entry.chunks = chunks
        try:
            self.filer.create_entry(entry)
        except IsADirectoryError:
            # the chunks just uploaded have no owning entry: GC them
            self._delete_chunks([c.fid for c in chunks])
            return Response({"error": "is a directory"}, status=409)
        # make the new subtree reachable from listings on other shards
        self._ensure_parents_remote(entry.dir_path)
        return Response({"name": entry.name, "size": size}, status=201)

    def _ingest_body(self, req: Request, collection: str,
                     replication: str, ttl: str = "",
                     disk_type: str = "", hasher=None
                     ) -> tuple[bytes, list[FileChunk], int]:
        """Consume one request body into ``(inline_content, chunks,
        size)`` — the single ingest point the filer PUT, S3 PUT/part,
        and WebDAV PUT all ride. With a live ``req.stream`` (and
        streaming_ingest on) the body is chunked AS IT ARRIVES under
        the STREAM_INFLIGHT buffer cap; otherwise the buffered
        comparator path. ``hasher`` (e.g. hashlib.md5) is fed every
        body byte in order — the S3 ETag without a second pass."""
        stream = getattr(req, "stream", None)
        if stream is None or not self.streaming_ingest:
            data = req.body
            if hasher is not None:
                hasher.update(data)
            if len(data) <= INLINE_LIMIT and not self.cipher:
                return data, [], len(data)
            return b"", self._upload_chunks(
                data, collection, replication, ttl,
                disk_type=disk_type), len(data)
        head = _read_full(stream, INLINE_LIMIT + 1)
        if hasher is not None:
            hasher.update(head)
        if len(head) <= INLINE_LIMIT and not self.cipher:
            return head, [], len(head)
        chunks, size = self._stream_chunks(head, stream, collection,
                                           replication, ttl, disk_type,
                                           hasher=hasher)
        return b"", chunks, size

    def _get_upload_pool(self) -> ThreadPoolExecutor:
        if self._upload_pool is None:
            with self._upload_pool_lock:
                if self._upload_pool is None:
                    self._upload_pool = ThreadPoolExecutor(
                        max_workers=UPLOAD_WORKERS,
                        thread_name_prefix="chunk-upload")
        return self._upload_pool

    def _upload_chunks(self, data: bytes, collection: str,
                       replication: str, ttl: str = "",
                       disk_type: str = "") -> list[FileChunk]:
        """Split into CHUNK_SIZE pieces, assign + upload each
        (reference filer_server_handlers_write_upload.go:32-140). Wide
        chunk lists collapse into manifest chunks (filechunk_manifest.go).
        disk_type routes the assigns to that storage tier (per-path
        filer.conf rule, reference -disk).

        Multi-chunk uploads run concurrently: fids are minted in
        batches (master assign count=N), the pieces go through the
        shared bounded pool, and the chunk list is assembled by index
        so offsets/ordering are identical to the serial loop. On the
        first error the remaining uploads are cancelled, every chunk
        that already landed is deleted (no orphans), and the error
        propagates. The S3 gateway PUT/multipart and WebDAV paths ride
        this same code."""
        offsets = list(range(0, len(data), CHUNK_SIZE))
        save_one = lambda blob: self._save_chunk(  # noqa: E731
            blob, 0, collection, replication, ttl, disk_type)
        if len(offsets) <= 1 or not self.parallel_uploads:
            chunks = [self._save_chunk(data[off:off + CHUNK_SIZE], off,
                                       collection, replication, ttl,
                                       disk_type)
                      for off in offsets]
            return maybe_manifestize(save_one, chunks)
        assigns = self.mc.assign_many(len(offsets), collection=collection,
                                      replication=replication, ttl=ttl,
                                      disk=disk_type)
        if assigns and assigns[0].get("error"):
            raise HttpError(500, assigns[0]["error"].encode())
        if len(assigns) < len(offsets) or any(a.get("error")
                                              for a in assigns):
            # partial batch (JWT-mode flip mid-call or master error
            # tail): the serial path handles its own assigns fine
            chunks = [self._save_chunk(data[off:off + CHUNK_SIZE], off,
                                       collection, replication, ttl,
                                       disk_type)
                      for off in offsets]
            return maybe_manifestize(save_one, chunks)
        pool = self._get_upload_pool()
        chunks: list[Optional[FileChunk]] = [None] * len(offsets)
        # contextvars don't cross the pool: capture the request's QoS
        # class AND trace span here and re-enter both in each worker so
        # the chunk PUTs carry the same X-Weed-Class / X-Weed-Trace as
        # their parent (the deadline header rides the same pattern via
        # Deadline propagation)
        upload_cls = current_class()
        upload_span = tracing.current_span()
        if upload_span is not None:
            upload_span.annotate("chunks.fanout", len(offsets))

        def upload_in_class(a, piece, off):
            with class_scope(upload_cls), tracing.span_scope(upload_span):
                return self._upload_one_chunk(a, piece, off)

        futures = {
            pool.submit(upload_in_class, assigns[i],
                        data[off:off + CHUNK_SIZE], off): i
            for i, off in enumerate(offsets)}
        first_err: Optional[Exception] = None
        for fut in as_completed(futures):
            try:
                chunks[futures[fut]] = fut.result()
            except CancelledError:
                pass
            except Exception as e:
                if first_err is None:
                    first_err = e
                    for g in futures:
                        g.cancel()
        if first_err is not None:
            # as_completed drained every future, so `chunks` now holds
            # exactly the uploads that landed — GC them
            self._delete_chunks([c.fid for c in chunks if c is not None])
            if isinstance(first_err, HttpError):
                raise first_err
            raise HttpError(500, f"chunk upload failed: "
                                 f"{first_err}".encode())
        return maybe_manifestize(save_one, chunks)

    def _stream_chunks(self, prefix: bytes, stream, collection: str,
                       replication: str, ttl: str = "",
                       disk_type: str = "", hasher=None
                       ) -> tuple[list[FileChunk], int]:
        """Bounded-memory streaming twin of _upload_chunks: chunk i+1
        fills from the socket while chunks i and i-1 upload through
        the shared pool — at most STREAM_INFLIGHT uploads in flight,
        so peak body memory is ~3 chunk buffers for a 5GB PUT and a
        5KB one alike. fids are pre-minted in STREAM_ASSIGN_WAVE
        batches (total chunk count is unknown until EOF). Chunk
        boundaries are the same CHUNK_SIZE grid as the buffered path,
        so the stored object is bit-identical. On the first upload
        error OR a client disconnect mid-stream, outstanding uploads
        are cancelled, every chunk that already landed is deleted (no
        orphans), and the error propagates."""
        save_one = lambda blob: self._save_chunk(  # noqa: E731
            blob, 0, collection, replication, ttl, disk_type)
        upload_cls = current_class()
        upload_span = tracing.current_span()

        def upload_in_class(a, piece, off):
            with class_scope(upload_cls), tracing.span_scope(upload_span):
                return self._upload_one_chunk(a, piece, off)

        def next_piece(lead: bytes) -> bytes:
            want = CHUNK_SIZE - len(lead)
            more = _read_full(stream, want) if want > 0 else b""
            if hasher is not None and more:
                hasher.update(more)
            return (lead + more) if lead else more

        assigns: list[dict] = []

        def next_assign() -> dict:
            if not assigns:
                wave = self.mc.assign_many(
                    STREAM_ASSIGN_WAVE, collection=collection,
                    replication=replication, ttl=ttl, disk=disk_type)
                assigns.extend(a for a in wave if not a.get("error"))
            if assigns:
                return assigns.pop(0)
            # batch minting degraded (JWT-mode flip, master error
            # tail): fall back to a single assign, which raises its
            # own error if the master really is down
            a = self.mc.assign(collection=collection,
                               replication=replication, ttl=ttl,
                               disk=disk_type)
            if a.get("error"):
                raise HttpError(500, a["error"].encode())
            return a

        pool = self._get_upload_pool() if self.parallel_uploads else None
        chunks: list[Optional[FileChunk]] = []
        futures: dict = {}  # future -> chunk index
        first_err: Optional[Exception] = None
        size = 0

        def harvest(done) -> None:
            nonlocal first_err
            for fut in done:
                i = futures.pop(fut)
                try:
                    chunks[i] = fut.result()
                except CancelledError:
                    pass
                except Exception as e:
                    if first_err is None:
                        first_err = e

        try:
            piece = next_piece(prefix)
            while piece and first_err is None:
                off = size
                size += len(piece)
                if pool is None:
                    chunks.append(self._save_chunk(
                        piece, off, collection, replication, ttl,
                        disk_type))
                else:
                    chunks.append(None)
                    futures[pool.submit(upload_in_class, next_assign(),
                                        piece, off)] = len(chunks) - 1
                    while len(futures) >= STREAM_INFLIGHT:
                        done, _ = wait(list(futures),
                                       return_when=FIRST_COMPLETED)
                        harvest(done)
                        if first_err is not None:
                            break
                if first_err is not None:
                    break
                piece = next_piece(b"")
        except Exception as e:
            # the socket died mid-stream (client disconnect, lying
            # Content-Length) or a serial upload failed
            if first_err is None:
                first_err = e
        if first_err is not None:
            for fut in futures:
                fut.cancel()
        if futures:
            # normal EOF: the last ≤STREAM_INFLIGHT uploads are still
            # in flight — wait them out (cancel only on error above)
            wait(list(futures))
            harvest(list(futures))
        if first_err is not None:
            self._delete_chunks([c.fid for c in chunks if c is not None])
            if isinstance(first_err, (HttpError, ConnectionError)):
                raise first_err
            raise HttpError(500, f"chunk upload failed: "
                                 f"{first_err}".encode())
        return maybe_manifestize(save_one, chunks), size

    def _upload_one_chunk(self, a: dict, piece: bytes,
                          offset: int) -> FileChunk:
        """Encrypt (when enabled) + upload one piece against an
        already-minted assignment."""
        key = b""
        if self.cipher:
            from seaweedfs_tpu_torch.utils import cipher as _cipher
            blob, key = _cipher.encrypt(piece)
        else:
            blob = piece
        operation.upload_to(a["fid"], a["url"], blob,
                            auth=a.get("auth", ""))
        return FileChunk(fid=a["fid"], offset=offset, size=len(piece),
                         cipher_key=key, mtime_ns=time.time_ns())

    def _save_chunk(self, piece: bytes, offset: int, collection: str,
                    replication: str, ttl: str = "",
                    disk_type: str = "") -> FileChunk:
        a = self.mc.assign(collection=collection, replication=replication,
                           ttl=ttl, disk=disk_type)
        if a.get("error"):
            raise HttpError(500, a["error"].encode())
        return self._upload_one_chunk(a, piece, offset)

    # ---- read ----
    def _handle_read(self, req: Request) -> Response:
        path = req.path.rstrip("/") or "/"
        misroute = self._shard_redirect(req, path)
        if misroute is not None:
            return misroute
        entry = self.filer.find_entry(path)
        if entry is None:
            return Response({"error": "not found"}, status=404)
        if entry.is_directory:
            limit = int(req.query.get("limit", 1024))
            last = req.query.get("lastFileName", "")
            entries = self._list_entries_routed(path, start_name=last,
                                                limit=limit)
            return Response({
                "Path": path,
                "Entries": [self._entry_json(e) for e in entries],
                "ShouldDisplayLoadMore": len(entries) == limit,
            })
        # zero-copy read plane: an eligible single-chunk entry's
        # payload never relays through this filer — the client is
        # pointed straight at a volume replica (which serves it via
        # sendfile). ?proxy=1 forces the relay (comparator/debug).
        if req.method == "GET" and self.volume_redirect \
                and req.query.get("proxy") != "1":
            loc = self.volume_direct_url(entry)
            if loc is not None:
                self._m_req.inc("read_redirect")
                return Response(b"", status=302,
                                content_type="text/plain",
                                headers={"Location": loc})
        mime = entry.attr.mime or "application/octet-stream"
        headers = {"Content-Disposition":
                   f'inline; filename="{entry.name}"'}
        # edge deadline: honors an inbound X-Weed-Deadline (propagated
        # budget) or mints the default; every chunk fetch below inherits
        # the remaining time instead of its own full 30s
        with deadline_scope(Deadline.from_headers(req.headers,
                                                  default=READ_DEADLINE_S)):
            if req.method == "GET" and req.headers.get("Range"):
                total = entry.file_size()
                try:
                    rng = parse_byte_range(req.headers["Range"], total)
                except RangeNotSatisfiable:
                    headers["Content-Range"] = f"bytes */{total}"
                    return Response(b"", status=416, content_type=mime,
                                    headers=headers)
                if rng is not None:
                    lo, hi = rng
                    piece = self._read_entry_range(entry, lo,
                                                   hi - lo + 1)
                    headers["Content-Range"] = \
                        f"bytes {lo}-{hi}/{total}"
                    return Response(piece, status=206,
                                    content_type=mime, headers=headers)
            data = self._read_entry_bytes(entry)
        return Response(data, content_type=mime, headers=headers)

    def volume_direct_url(self, entry: Entry) -> Optional[str]:
        """The JWT-stamped volume URL an entry's payload can be GET
        directly from, or None when the read must proxy. Eligibility —
        the payload must be ONE plaintext stored chunk that IS the
        whole file: no inline content, exactly one chunk covering
        [0, file_size), no per-chunk cipher key, no manifest
        indirection, no remote mount, and at least volume_redirect_min
        bytes (smaller reads stay on the proxy where the reader cache
        and deadline-bounded hedged fetches serve the hot tail). The
        replica choice follows this filer's learned peer health, and a
        failed lookup falls back to the proxy path rather than
        redirecting into the void."""
        if entry.content or entry.remote or not entry.chunks:
            return None
        if entry.file_size() < self.volume_redirect_min:
            return None
        if len(entry.chunks) != 1 or has_chunk_manifest(entry.chunks):
            return None
        c = entry.chunks[0]
        if c.cipher_key or c.offset != 0 \
                or c.size != entry.file_size():
            return None
        try:
            vid = int(c.fid.split(",")[0])
            peers = [l["url"] for l in self.mc.lookup_volume(vid)]
        except Exception:
            return None
        if not peers:
            return None
        peer = self.peer_health.rank(peers)[0]
        jwt = self._read_jwt_for(c.fid)
        return f"http://{peer}/{c.fid}" + (f"?jwt={jwt}" if jwt else "")

    def _read_jwt_for(self, fid: str) -> str:
        """Sign a read token with the shared jwt.signing.read key when
        configured (reference security.toml; volume servers verify)."""
        if not hasattr(self, "_jwt_read_key"):
            from seaweedfs_tpu_torch.utils import config as _cfg
            conf = _cfg.load_configuration("security")
            self._jwt_read_key = _cfg.get(conf, "jwt.signing.read.key",
                                          "") or ""
        if not self._jwt_read_key:
            return ""
        from seaweedfs_tpu_torch.utils.security import gen_jwt
        return gen_jwt(self._jwt_read_key, fid)

    def _fetch_chunk_remote(self, fid: str) -> bytes:
        """One real network fetch of a chunk's stored bytes (the
        ReaderCache guarantees a single flight per fid).

        Replica holders are breaker-ranked (learned per-peer health
        fronts the fastest live server) and straggler-hedged: if the
        first pick stalls past the adaptive hedge delay, a backup
        fetch races it on the next-ranked peer — same machinery the
        volume servers use for degraded EC reads."""
        jwt = self._read_jwt_for(fid)
        dl = current_deadline() or Deadline.after(READ_DEADLINE_S)
        vid = int(fid.split(",")[0])
        peers = [l["url"] for l in self.mc.lookup_volume(vid)]

        def fetch(peer: str) -> Optional[bytes]:
            target = (f"http://{peer}/{fid}"
                      + (f"?jwt={jwt}" if jwt else ""))
            status, body, _ = http_call("GET", target, deadline=dl)
            return body if status == 200 else None

        out = hedged(fetch, self.peer_health.rank(peers),
                     health=self.peer_health, deadline=dl)
        if out is None:
            # the holder set may have changed (moved/grown volume):
            # don't let a stale lookup cache pin the failure
            self.mc.invalidate(vid)
            raise HttpError(500, f"chunk {fid} unreachable".encode())
        return out

    def _read_chunk_blob(self, fid: str) -> bytes:
        """Raw stored bytes of a chunk (ciphertext when encrypted);
        cached as stored, fetched single-flight."""
        return self.reader_cache.get(fid)

    def _read_chunk(self, chunk: FileChunk) -> bytes:
        """Plaintext bytes of a chunk (decrypts with the per-chunk key
        from the metadata — reference util/cipher.go Decrypt)."""
        blob = self._read_chunk_blob(chunk.fid)
        if chunk.cipher_key:
            from seaweedfs_tpu_torch.utils import cipher as _cipher
            blob = _cipher.decrypt(blob, chunk.cipher_key)
        return blob

    def _read_entry_bytes(self, entry: Entry) -> bytes:
        if not entry.content and not entry.chunks and entry.remote:
            # remote-mounted, not cached locally: read through
            # (reference filer/read_remote.go)
            return self.remote_mounts.read_through(entry)
        if entry.content or not entry.chunks:
            return entry.content
        chunks = entry.chunks
        if has_chunk_manifest(chunks):
            chunks = resolve_chunk_manifest(self._read_chunk, chunks)
        size = entry.file_size()
        visibles = non_overlapping_visible_intervals(chunks)
        views = view_from_visibles(visibles, 0, size)
        chunk_by_fid = {c.fid: c for c in chunks}
        out = bytearray(size)
        for view in views:
            blob = self._read_chunk(chunk_by_fid[view.fid])
            piece = blob[view.offset_in_chunk:
                         view.offset_in_chunk + view.size]
            out[view.logic_offset:view.logic_offset + view.size] = piece
        return bytes(out)

    def _read_entry_range(self, entry: Entry, lo: int,
                          length: int) -> bytes:
        """``entry`` bytes [lo, lo+length) fetching ONLY the chunks
        that overlap the window — a Range GET of one 4MB chunk out of
        a multi-GB file costs one chunk fetch, not an assembly of the
        whole object."""
        if length <= 0:
            return b""
        if not entry.content and not entry.chunks and entry.remote:
            return self.remote_mounts.read_through(entry)[lo:lo + length]
        if entry.content or not entry.chunks:
            return entry.content[lo:lo + length]
        chunks = entry.chunks
        if has_chunk_manifest(chunks):
            chunks = resolve_chunk_manifest(self._read_chunk, chunks)
        visibles = non_overlapping_visible_intervals(chunks)
        views = view_from_visibles(visibles, lo, length)
        chunk_by_fid = {c.fid: c for c in chunks}
        out = bytearray(length)
        for view in views:
            blob = self._read_chunk(chunk_by_fid[view.fid])
            piece = blob[view.offset_in_chunk:
                         view.offset_in_chunk + view.size]
            out[view.logic_offset - lo:
                view.logic_offset - lo + view.size] = piece
        return bytes(out)

    @staticmethod
    def _entry_json(e: Entry) -> dict:
        return {
            "FullPath": e.full_path,
            "Mtime": e.attr.mtime,
            "Crtime": e.attr.crtime,
            "Mode": e.attr.mode,
            "Mime": e.attr.mime,
            "IsDirectory": e.is_directory,
            "FileSize": e.file_size(),
            "chunks": [c.to_dict() for c in e.chunks],
        }

    # ---- delete ----
    FILER_CONF_TTL = 5.0

    def _current_filer_conf(self) -> FilerConf:
        """Rules are shared multi-process state (KV in the store, which
        may itself be remote); re-read on a short TTL so gateways and
        peers observe fs.configure changes."""
        now = clockctl.now()
        if now - self._filer_conf_loaded > self.FILER_CONF_TTL:
            try:
                self.filer_conf = FilerConf.load(self.filer.store)
            except Exception:
                pass  # keep the last-known rules on transient errors
            self._filer_conf_loaded = now
        return self.filer_conf

    def _check_writable(self, path: str) -> Optional[Response]:
        rule = self._current_filer_conf().match_storage_rule(path)
        if rule.read_only:
            return Response(
                {"error": f"{rule.location_prefix} is read-only"},
                status=403)
        return None

    def _handle_delete(self, req: Request) -> Response:
        path = req.path.rstrip("/") or "/"
        misroute = self._shard_redirect(req, path)
        if misroute is not None:
            return misroute
        denied = self._check_writable(path)
        if denied:
            return denied
        recursive = req.query.get("recursive") == "true"
        try:
            if self._shard_active():
                self._delete_entry_sharded(path, recursive)
            else:
                self.filer.delete_entry(path, recursive=recursive)
        except FileNotFoundError:
            return Response({"error": "not found"}, status=404)
        except OSError as e:
            return Response({"error": str(e)}, status=409)
        return Response(b"", status=204, content_type="text/plain")

    # ---- api ----
    def _api_rename(self, req: Request) -> Response:
        b = req.json()
        denied = (self._check_writable(b["from"])
                  or self._check_writable(b["to"]))
        if denied:
            return denied
        if self._shard_active():
            frm, to = b["from"], b["to"]
            # the rename runs where frm's ROW lives: owner(parent(frm))
            owner = self.shard_ring.owner_for_path(frm)
            if (owner and owner != self.url
                    and not req.headers.get(weed_headers.SHARD_FORWARDED)):
                self._m_shard.inc("forward")
                status, body, hdrs = http_call(
                    "POST", f"http://{owner}/__api/rename", json_body=b,
                    headers={weed_headers.SHARD_FORWARDED: "1"},
                    timeout=60)
                return Response(
                    body, status=status,
                    content_type=hdrs.get("Content-Type")
                    or "application/json",
                    headers={weed_headers.SHARD: format_shard_header(
                        self.shard_ring.epoch, owner)})
            try:
                self._rename_sharded(frm, to)
            except FileNotFoundError:
                return Response({"error": "not found"}, status=404)
            return Response({"path": to})
        try:
            entry = self.filer.rename_entry(b["from"], b["to"])
        except FileNotFoundError:
            return Response({"error": "not found"}, status=404)
        return Response({"path": entry.full_path})

    def _api_put_entry(self, req: Request) -> Response:
        """Write an entry record (metadata import: fs.meta.load,
        filer.sync sinks — reference filer_pb CreateEntry). meta_only
        writes the row verbatim at the store level, bypassing chunk GC
        and hard-link accounting (remote store adapters own those)."""
        b = req.json()
        entry = Entry.from_dict(b["entry"])
        denied = self._check_writable(entry.full_path)
        if denied:
            return denied
        if b.get("meta_only"):
            # row-level write, but STILL logged: sync/backup/mount
            # subscribers must see gateway-written entries (reference
            # CreateEntry always notifies)
            old = self.filer.store.inner.find_entry(entry.full_path)
            self.filer.store.inner.insert_entry(entry)
            self.filer._notify(entry.dir_path,
                               old.to_dict() if old else None,
                               entry.to_dict())
        else:
            self.filer.create_entry(entry)
        return Response({"path": entry.full_path}, status=201)

    def _api_get_entry(self, req: Request) -> Response:
        """Full entry metadata incl. chunks (reference
        LookupDirectoryEntry). raw=true returns the unresolved store row."""
        if req.query.get("raw") == "true":
            entry = self.filer.store.inner.find_entry(req.query["path"])
        else:
            entry = self.filer.find_entry(req.query["path"])
        if entry is None:
            return Response({"error": "not found"}, status=404)
        return Response({"entry": entry.to_dict()})

    def _api_delete_entry_row(self, req: Request) -> Response:
        """Metadata-row delete (no chunk GC — the caller owns it). The
        surface a remote FilerStore adapter needs (filer/remote_store.py).
        Deletions are logged so subscribers see them."""
        path = req.query["path"]
        denied = self._check_writable(path)
        if denied:
            return denied
        inner = self.filer.store.inner
        if req.query.get("children") == "true":
            doomed = inner.list_directory_entries(path, limit=1 << 20)
            inner.delete_folder_children(path)
            for child in doomed:
                self.filer._notify(path, child.to_dict(), None)
        else:
            old = inner.find_entry(path)
            inner.delete_entry(path)
            if old is not None:
                self.filer._notify(old.dir_path, old.to_dict(), None)
        return Response({})

    def _api_list_entries(self, req: Request) -> Response:
        """Full RAW entry rows of one directory (listing JSON on GET
        <dir> is trimmed for humans; store adapters resolve hard links
        themselves — same contract as entry?raw=true). resolved=true
        serves the RESOLVED view instead (hard links followed, through
        the entry cache) — what a peer shard wants for cross-shard
        listings."""
        if req.query.get("resolved") == "true":
            entries = self.filer.list_entries(
                req.query["dir"],
                start_name=req.query.get("start", ""),
                limit=int(req.query.get("limit", 1024)))
        else:
            entries = self.filer.store.inner.list_directory_entries(
                req.query["dir"],
                start_name=req.query.get("start", ""),
                include_start=req.query.get("include_start") == "true",
                limit=int(req.query.get("limit", 1024)),
                prefix=req.query.get("prefix", ""))
        return Response({"entries": [e.to_dict() for e in entries]})

    def _api_kv_get(self, req: Request) -> Response:
        val = self.filer.store.kv_get(req.query["key"].encode())
        if val is None:
            return Response({"error": "not found"}, status=404)
        return Response({"value": val.hex()})

    def _api_kv_put(self, req: Request) -> Response:
        b = req.json()
        if b.get("delete"):
            self.filer.store.kv_delete(b["key"].encode())
        else:
            self.filer.store.kv_put(b["key"].encode(),
                                    bytes.fromhex(b["value"]))
        return Response({})

    def _api_hardlink(self, req: Request) -> Response:
        b = req.json()
        denied = self._check_writable(b["to"])
        if denied:
            return denied
        try:
            entry = self.filer.add_hard_link(b["from"], b["to"])
        except FileNotFoundError:
            return Response({"error": "not found"}, status=404)
        except IsADirectoryError:
            return Response({"error": "is a directory"}, status=409)
        return Response({"path": entry.full_path,
                         "hard_link_id": entry.hard_link_id})

    def _api_filer_conf_get(self, req: Request) -> Response:
        return Response({"locations": [r.to_dict()
                                       for r in self._current_filer_conf().rules]})

    def _api_filer_conf_set(self, req: Request) -> Response:
        b = req.json()
        # serialize load->mutate->save per process, and mutate a
        # freshly-loaded conf so we never clobber rules a peer wrote
        # since our last TTL refresh (cross-process races remain, as in
        # the reference's read-modify-write of /etc/seaweedfs/filer.conf)
        with self._filer_conf_write_lock:
            conf = FilerConf.load(self.filer.store)
            if b.get("delete"):
                conf.delete_rule(b["location_prefix"])
            else:
                conf.set_rule(PathConf.from_dict(b))
            conf.save(self.filer.store)
            self.filer_conf = conf
            self._filer_conf_loaded = clockctl.now()
        return Response({"locations": [r.to_dict()
                                       for r in self.filer_conf.rules]})

    # ---- remote mounts (reference weed/filer remote_storage +
    #      shell remote.* + command/filer_remote_sync.go) ----
    def _api_remote_status(self, req: Request) -> Response:
        return Response({
            "remotes": [c.to_public_dict()
                        for c in self.remote_mounts.list_confs().values()],
            "mappings": self.remote_mounts.list_mappings()})

    def _api_remote_configure(self, req: Request) -> Response:
        from seaweedfs_tpu_torch.remote_storage.remote_storage import RemoteConf
        b = req.json()
        if b.get("delete"):
            self.remote_mounts.delete_conf(b["name"])
        else:
            self.remote_mounts.configure(RemoteConf.from_dict(b))
        return self._api_remote_status(req)

    def _api_remote_mount(self, req: Request) -> Response:
        b = req.json()
        try:
            self.remote_mounts.mount(b["dir"], b["remote_name"],
                                     b.get("remote_path", ""))
        except KeyError as e:
            return Response({"error": str(e)}, status=404)
        return self._api_remote_status(req)

    def _api_remote_mount_buckets(self, req: Request) -> Response:
        b = req.json()
        try:
            mounted = self.remote_mounts.mount_buckets(
                b["remote_name"], b.get("bucket_pattern", ""))
        except KeyError as e:
            return Response({"error": str(e)}, status=404)
        except (ValueError, ConnectionError) as e:
            return Response({"error": str(e)}, status=400)
        return Response({"mounted": mounted})

    def _api_remote_unmount(self, req: Request) -> Response:
        self.remote_mounts.unmount(req.json()["dir"])
        return self._api_remote_status(req)

    def _api_remote_pull(self, req: Request) -> Response:
        try:
            n = self.remote_mounts.pull_metadata(req.json()["dir"])
        except KeyError as e:
            return Response({"error": str(e)}, status=404)
        return Response({"pulled": n})

    def _remote_entry_or_error(self, req: Request):
        path = req.json()["path"]
        entry = self.filer.find_entry(path)
        if entry is None:
            return None, Response({"error": "not found"}, status=404)
        return entry, None

    def _api_remote_cache(self, req: Request) -> Response:
        entry, err = self._remote_entry_or_error(req)
        if err:
            return err
        # same placement rules as a normal write to this path
        rule = self._current_filer_conf().match_storage_rule(entry.full_path)
        replication = rule.replication or self.default_replication
        entry = self.remote_mounts.cache_entry(
            entry, lambda data: self._upload_chunks(
                data, rule.collection, replication, rule.ttl))
        return Response({"cached": entry.full_path,
                         "chunks": len(entry.chunks)})

    def _api_remote_uncache(self, req: Request) -> Response:
        entry, err = self._remote_entry_or_error(req)
        if err:
            return err
        self.remote_mounts.uncache_entry(entry)
        return Response({"uncached": entry.full_path})

    def _api_remote_writeback(self, req: Request) -> Response:
        entry, err = self._remote_entry_or_error(req)
        if err:
            return err
        data = self._read_entry_bytes(entry)
        self.remote_mounts.write_back(entry, data)
        return Response({"synced": entry.full_path, "size": len(data)})

    def _api_remote_rm(self, req: Request) -> Response:
        self.remote_mounts.delete_remote(req.json()["path"])
        return Response({})

    def _api_chunk_blob(self, req: Request) -> Response:
        """Plaintext bytes of one chunk by fid — lets admin tools
        (volume.fsck) expand manifest chunks without reimplementing the
        decrypt/cache path."""
        from seaweedfs_tpu_torch.filer.entry import FileChunk
        fid = req.match.group(1)
        key = bytes.fromhex(req.query.get("cipher_key", ""))
        try:
            blob = self._read_chunk(FileChunk(fid=fid, offset=0, size=0,
                                              cipher_key=key))
        except (ConnectionError, HttpError) as e:
            return Response({"error": str(e)}, status=502)
        return Response(blob, content_type="application/octet-stream")

    def _api_meta_events(self, req: Request) -> Response:
        since = int(req.query.get("since_ns", 0))
        prefix = req.query.get("prefix", "/")
        wait = float(req.query.get("wait", 0))
        # a sync direction excludes events its PEER direction wrote
        # (reference filer.sync signature exclusion — without it, a
        # bidirectional pair echoes every write forever)
        exclude = int(req.query.get("exclude_signature", 0))
        if req.query.get("aggregated") == "true":
            # reference SubscribeMetadata (cluster-wide) vs
            # SubscribeLocalMetadata (this filer only)
            log = getattr(self, "meta_aggregator", None)
            if log is None:
                return Response({"error": "aggregator not running"},
                                status=503)
            if wait > 0:
                log.log.wait_for_events(since, timeout=min(wait, 30))
            # snapshot BEFORE reading (same ordering as the gRPC
            # subscribe path): an event appended between read and
            # snapshot would be jumped by the cursor and lost
            latest = log.log.latest_tsns()
            events = log.log.read_since(since, prefix,
                                        exclude_signature=exclude)
            cursor = (events[-1]["tsns"] if events
                      else max(since, latest))
            return Response({"events": events, "cursor": cursor})
        if wait > 0:
            self.filer.meta_log.wait_for_events(since, timeout=min(wait, 30))
        # cursor: where the NEXT poll should resume. With results, the
        # last returned event (more may wait beyond the limit); with
        # none, the whole scanned range was excluded/non-matching, so
        # skip past it instead of re-scanning it every poll. The
        # latest-snapshot happens BEFORE the read so a concurrent
        # append can never land inside the skipped range.
        latest = self.filer.meta_log.latest_tsns()
        events = self.filer.meta_log.read_since(
            since, prefix, exclude_signature=exclude)
        cursor = (events[-1].tsns if events else max(since, latest))
        return Response({"events": [e.to_dict() for e in events],
                         "cursor": cursor})
