"""Master server: topology bookkeeping, assignment, lookup, growth.

Functional equivalent of reference weed/server/master_server.go +
master_grpc_server*.go over HTTP/JSON:

  POST /heartbeat        full or delta heartbeat from a volume server
  GET  /dir/assign       pick/grow a writable volume, mint a fid
  GET  /dir/lookup       vid -> locations
  GET  /dir/lookup_ec    vid -> per-shard locations
  GET  /dir/status       topology dump (shell planners' input)
  POST /vol/grow         explicit growth
  POST /vol/vacuum       trigger vacuum check on all nodes
  GET  /cluster/status   leader info
  GET  /cluster/leases   assign-lease table (holder/epoch/range/expiry)
  POST /admin/lock, /admin/unlock   exclusive shell lock

Assign leases: the master grants volume servers epoch-stamped
fid-range leases ({vid, key_lo, key_hi, epoch, expires_at}) riding the
heartbeat reply, Raft-proposed before they are handed out so a grant
survives leader failover and a fresh leader resumes the sequence past
the high-water mark instead of double-granting. Holders mint fids
locally from their range; the master only re-enters the per-PUT path
when no leased holder is reachable.

The port's copy of seaweedfs_tpu/server/master.py, the same code, Raft HA
(``set_peers``, cluster/raft.py) and the gRPC plane
(server/master_grpc.py, started by ``grpc_port``) included. Like the
reference's master it takes no device: repairs run on the volume servers,
whose coder is the card's. It imports nothing of that package.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from seaweedfs_tpu_torch.cluster.sequence import MemorySequencer
from seaweedfs_tpu_torch.cluster.topology import Topology
from seaweedfs_tpu_torch.qos import (BACKGROUND, INTERACTIVE, WRITE, QosGovernor,
                               class_scope, classify, from_headers)
from seaweedfs_tpu_torch.cluster.volume_growth import (NoFreeSpaceError,
                                                 grow_by_type)
from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
from seaweedfs_tpu_torch.utils import headers as weed_headers
from seaweedfs_tpu_torch.utils import clockctl, glog, profiler, tracing
from seaweedfs_tpu_torch.utils.httpd import (HttpServer, Request, Response,
                                       http_json)
from seaweedfs_tpu_torch.utils.resilience import Deadline, PeerHealth
import random

# ---- assign-lease protocol knobs ----
# How long a fid-range lease stays valid. Long relative to the
# heartbeat pulse (2s) so a leader election (sub-second to a few
# seconds) never outlives the leases already in holders' hands.
LEASE_TTL_S = 30.0
# Keys per grant. 4096 fids per (vid, holder) per grant keeps renewal
# traffic to ~1 raft proposal per volume per TTL under realistic
# floods; abandoned remainders just burn cheap sequence ids.
LEASE_RANGE = 4096
# Renew when remaining lifetime falls below this fraction of the TTL
# or remaining range below this fraction of LEASE_RANGE.
LEASE_RENEW_FRACTION = 0.5
LEASE_RANGE_REFILL_FRACTION = 0.25
# Cap raft proposals per heartbeat so one node with many volumes
# can't stall the heartbeat handler; the rest renew next pulse.
LEASE_GRANTS_PER_PULSE = 8


class MasterServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 volume_size_limit_mb: int = 1024,
                 default_replication: str = "000",
                 garbage_threshold: float = 0.3,
                 jwt_signing_key: str = "",
                 whitelist: Optional[list] = None,
                 meta_dir: str = "", grpc_port: Optional[int] = None,
                 repair_rate_mbps: float = 0.0,
                 partial_repair: bool = True,
                 repair_coalesce_window_s: float = 0.0,
                 qos: bool = True,
                 tracing_enabled: bool = True,
                 trace_sample: float = 0.01,
                 profile_hz: float = profiler.DEFAULT_HZ,
                 tier_endpoint: str = "", tier_bucket: str = "tier"):
        self.topo = Topology(volume_size_limit=volume_size_limit_mb * 1024 * 1024)
        self.jwt_signing_key = jwt_signing_key
        from seaweedfs_tpu_torch.utils.metrics import Registry
        from seaweedfs_tpu_torch.utils.security import Guard
        self.metrics = Registry()
        self.guard = Guard(whitelist)
        self._m_assign = self.metrics.counter(
            "master", "assign_total", "assign requests")
        self._m_lookup = self.metrics.counter(
            "master", "lookup_total", "lookup requests")
        self._m_heartbeat = self.metrics.counter(
            "master", "received_heartbeats", "heartbeats received")
        # topology gauges refreshed at scrape time (reference
        # stats/metrics.go MasterVolumeLayout / data-node gauges)
        self._m_nodes = self.metrics.gauge(
            "master", "data_nodes", "registered volume servers")
        self._m_volumes = self.metrics.gauge(
            "master", "volumes", "volumes known to the topology")
        self._m_ec_shards = self.metrics.gauge(
            "master", "ec_shards", "ec shards known to the topology")
        self._m_is_leader = self.metrics.gauge(
            "master", "is_leader", "1 when this master leads")
        self.metrics.on_expose(self._refresh_gauges)
        # breaker/health table for the nodes this master dials
        # (vacuum, repair dispatch, collection delete, leader proxy)
        self.peer_health = PeerHealth(metrics=self.metrics)
        self.sequencer = MemorySequencer()
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        self.http = HttpServer(host, port)
        self._grow_lock = threading.Lock()
        self._admin_lock_holder: Optional[str] = None
        self._admin_lock_ts = 0.0
        from seaweedfs_tpu_torch.scrub import RepairQueue
        self.repair_queue = RepairQueue(
            self, repair_rate_mbps=repair_rate_mbps,
            partial_repair=partial_repair,
            coalesce_window_s=repair_coalesce_window_s)
        # the master's serving edge (lookups/assigns) gets the same
        # adaptive-concurrency governor as the volume servers' data
        # edges; cluster-control traffic is exempt (see QOS_EXEMPT)
        self.qos = QosGovernor(metrics=self.metrics, enabled=qos)
        self._m_qos_shed = self.metrics.counter(
            "master", "qos_shed_total", "requests shed at the master edge")
        self.http.admission_gate = self._admission_gate
        # distributed-tracing flight recorder; served at /debug/traces
        self.tracer = tracing.Tracer(
            node=f"master@{host}:{port}", enabled=tracing_enabled,
            sample_rate=trace_sample)
        self.http.tracer = self.tracer
        # RED edge histogram (one observation site in HttpServer) +
        # the cluster-wide aggregation/judgement it feeds
        from seaweedfs_tpu_torch.stats.telemetry import ClusterTelemetry
        from seaweedfs_tpu_torch.utils.metrics import RedRecorder
        self.red = RedRecorder(self.metrics, "master")
        self.http.red = self.red
        # wall-stack sampler + per-(class, tenant) resource ledger:
        # the master's own burn joins the cluster rollup it serves
        from seaweedfs_tpu_torch.stats.ledger import ResourceLedger
        self.sampler = profiler.WallSampler(hz=profile_hz)
        self.ledger = ResourceLedger()
        self.http.ledger = self.ledger
        self.telemetry = ClusterTelemetry(
            on_transition=self._on_slo_transition)
        self._m_slo_burn = self.metrics.gauge(
            "master", "slo_burn_rate",
            "SLO error-budget burn rate", ("class", "window"))
        self._m_slo_alert = self.metrics.gauge(
            "master", "slo_alert",
            "1=fast_burn firing, 0.5=slow_burn, 0=ok", ("class",))
        self._register_routes()
        self._stop = threading.Event()
        self._pruner: Optional[threading.Thread] = None
        # ---- HA: raft consensus (reference weed/server/raft_server.go;
        # MaxVolumeId commands replicate like
        # topology/cluster_commands.go, sequence checkpoints ride the
        # snapshot). Single-master mode (no peers) has no raft node and
        # is trivially leader.
        self.peers: list[str] = []
        self.raft = None
        self._seq_ckpt = 0  # highest committed sequence checkpoint
        self._seq_synced_term = -1  # raft term our sequencer is synced to
        # ---- assign-lease table (replicated) ----
        # vid -> {vid, holder, key_lo, key_hi, epoch, expires_at, ...};
        # every entry was a committed raft "lease" command (or arrived
        # in a snapshot), so the table survives leader failover and a
        # fresh leader can honor — and avoid double-granting over —
        # ranges its predecessor handed out.
        self.leases: dict[int, dict] = {}
        self._lease_epoch = 0           # replicated grant counter
        self._lease_lock = threading.Lock()   # table/epoch mutations
        self._grant_lock = threading.Lock()   # serializes grant checks
        # leader-local: holder-reported mint cursor per vid, for the
        # /cluster/leases "remaining range" view (not replicated)
        self._lease_progress: dict[int, int] = {}
        self.lease_counters = {"grant": 0, "renew": 0, "expire": 0}
        self._m_lease = self.metrics.counter(
            "master", "lease_total", "assign-lease operations", ("op",))
        # ---- durable state (reference checkpoints MaxVolumeId + sequence
        # through raft snapshots, topology/cluster_commands.go) ----
        self.meta_dir = meta_dir
        self._load_state()
        self._grpc_port = grpc_port
        self._cluster_nodes: dict = {}
        # (type, url) -> {"metrics_url": ...}; separate from the
        # liveness map above because the gRPC plane also writes that
        # one with bare timestamps
        self._cluster_node_meta: dict = {}
        # epoch-stamped filer shard ring (filer/shard_ring.py): the
        # epoch bumps exactly when the live filer set changes, so
        # clients can detect drift from one integer compare
        self._filer_ring = None
        self._filer_ring_lock = threading.Lock()
        # live rebalancing (filer/rebalance.py): announce piggybacks
        # feed the planner; a plan dispatches move orders to the
        # source filer, and the ring only flips at commit time — after
        # the mover has the rows at the destination
        from seaweedfs_tpu_torch.filer.rebalance import RebalancePlanner
        self.rebalance = RebalancePlanner()
        self.rebalance_dispatched: list[dict] = []
        # tiering autopilot (storage/tiering.py): heartbeat-piggybacked
        # read counters feed the planner; the mover executes rung
        # transitions as BACKGROUND token-bucketed jobs. Without a
        # tier_endpoint the cloud rung stays disabled (hot<->ec only).
        from seaweedfs_tpu_torch.storage.tiering import TieringPlanner, TierMover
        self.tiering = TieringPlanner(cloud_enabled=bool(tier_endpoint))
        self.tier_mover = TierMover(self.tiering, endpoint=tier_endpoint,
                                    bucket=tier_bucket)
        self.tiering_dispatched: list[dict] = []
        self._grpc_server = None
        self.grpc_port: Optional[int] = None

    # ---- lifecycle ----
    def start(self) -> None:
        self.http.start()
        self.sampler.start()
        self.tracer.node = f"master@{self.http.host}:{self.http.port}"
        if self._grpc_port is not None:
            from seaweedfs_tpu_torch.server.master_grpc import start_master_grpc
            self._grpc_server, self.grpc_port = start_master_grpc(
                self, self.http.host, self._grpc_port)
        self._pruner = threading.Thread(target=self._prune_loop, daemon=True,
                                        name="master-prune")
        self._pruner.start()
        glog.info("master server up at %s (peers=%s)", self.url,
                  ",".join(self.peers) if self.peers else "-")

    def stop(self) -> None:
        self._stop.set()
        self.sampler.stop()
        self.repair_queue.stop()
        self.metrics.stop_push()
        self._save_state()
        if self.raft is not None:
            self.raft.stop()
        if self._grpc_server is not None:
            self._grpc_server.stop(0)
        self.http.stop()

    @property
    def url(self) -> str:
        return f"{self.http.host}:{self.http.port}"

    def _prune_loop(self):
        ticks = 0
        while not self._stop.wait(self.topo.pulse_seconds):
            ticks += 1
            self.topo.prune_dead_nodes()
            self._expire_leases()
            self._save_state()
            self._feed_slo()
            if self.is_leader():
                # profiler scope: repair waves sample as background
                # work under route "repair", not anonymous thread time
                with profiler.scope(cls=BACKGROUND, route="repair"):
                    self.repair_queue.tick()
            if ticks % 12 == 0 and self.is_leader():
                self._auto_vacuum()

    def _auto_vacuum(self) -> None:
        """Compact garbage-heavy volumes cluster-wide (reference master
        vacuum loop, topology_vacuum.go). Vacuum is background traffic:
        a loaded node may shed it and the next pass retries."""
        with class_scope(BACKGROUND):
            self._auto_vacuum_inner()

    def _auto_vacuum_inner(self) -> None:
        for node in self.topo.all_nodes():
            for vid in list(node.volumes):
                try:
                    check = http_json(
                        "POST", f"http://{node.url}/admin/vacuum",
                        {"volume_id": vid, "check_only": True},
                        deadline=Deadline.after(10.0))
                    if check.get("garbage_ratio", 0) > self.garbage_threshold:
                        http_json("POST", f"http://{node.url}/admin/vacuum",
                                  {"volume_id": vid},
                                  timeout=600,
                                  deadline=Deadline.after(600.0))
                    self.peer_health.record(node.url, True)
                except ConnectionError as e:
                    self.peer_health.record(node.url, False)
                    glog.warning("auto-vacuum of %d on %s failed: %s",
                                 vid, node.url, e)
                    continue
                except Exception as e:
                    glog.warning("auto-vacuum of %d on %s failed: %s",
                                 vid, node.url, e)
                    continue

    def _state_path(self) -> str:
        import os
        return os.path.join(self.meta_dir, "master_state.json")

    def _load_state(self) -> None:
        if not self.meta_dir:
            return
        import json, os
        os.makedirs(self.meta_dir, exist_ok=True)
        try:
            with open(self._state_path()) as f:
                st = json.load(f)
            self.topo.max_volume_id = st.get("max_volume_id", 0)
            self.sequencer.set_max(st.get("sequence", 0))
            for vid_s, l in (st.get("leases") or {}).items():
                self.leases[int(vid_s)] = l
            self._lease_epoch = st.get("lease_epoch", 0)
        except (OSError, ValueError):
            pass

    def _save_state(self) -> None:
        if not self.meta_dir:
            return
        import json, os
        tmp = self._state_path() + ".tmp"
        try:
            with self._lease_lock:
                leases = {str(vid): l for vid, l in self.leases.items()}
                epoch = self._lease_epoch
            with open(tmp, "w") as f:
                json.dump({"max_volume_id": self.topo.max_volume_id,
                           "sequence": self.sequencer.peek(),
                           "leases": leases, "lease_epoch": epoch}, f)
            os.replace(tmp, self._state_path())
        except OSError:
            pass

    # ---- HA ----
    def set_peers(self, peers: list[str]) -> None:
        """Configure the master group (urls incl. self) and start raft."""
        from seaweedfs_tpu_torch.cluster.raft import RaftNode
        self.peers = sorted(set(peers) | {self.url})
        if self.raft is not None:
            self.raft.stop()
        import os
        state_path = (os.path.join(self.meta_dir, "raft_state.json")
                      if self.meta_dir else "")
        self.raft = RaftNode(
            self.url, self.peers,
            apply_fn=self._apply_raft_command,
            snapshot_fn=self._raft_snapshot_state,
            restore_fn=self._restore_raft_snapshot,
            state_path=state_path)
        self.raft.start()

    def _raft_snapshot_state(self) -> dict:
        with self._lease_lock:
            leases = {str(vid): dict(l) for vid, l in self.leases.items()}
            epoch = self._lease_epoch
        return {"max_volume_id": self.topo.max_volume_id,
                # followers never mint ids, so their live counter is
                # stale — the committed checkpoint is the durable floor
                "sequence": max(self._seq_ckpt, self.sequencer.peek()),
                "leases": leases,
                "lease_epoch": epoch}

    def _apply_raft_command(self, cmd: dict) -> None:
        """State machine: committed log entries (every master applies)."""
        if cmd.get("type") == "max_volume_id":
            with self.topo.lock:
                self.topo.max_volume_id = max(self.topo.max_volume_id,
                                              cmd["value"])
        elif cmd.get("type") == "sequence":
            # record only; the live counter fast-forwards to the
            # checkpoint once per leadership change (assign_fid) so a
            # continuing leader doesn't burn a batch per checkpoint
            self._seq_ckpt = max(self._seq_ckpt, cmd["value"])
        elif cmd.get("type") == "lease":
            self._apply_lease(cmd["lease"])
        elif cmd.get("type") == "raft_config":
            # membership change committed through the log, so every
            # master (and a restarted one replaying it) converges on
            # the same peer set (reference cluster.raft.add/remove)
            if self.raft is not None:
                if cmd["op"] == "add":
                    self.raft.add_peer(cmd["peer"])
                elif cmd["op"] == "remove":
                    self.raft.remove_peer(cmd["peer"])

    def _restore_raft_snapshot(self, state: dict) -> None:
        with self.topo.lock:
            self.topo.max_volume_id = max(self.topo.max_volume_id,
                                          state.get("max_volume_id", 0))
        self._seq_ckpt = max(self._seq_ckpt, state.get("sequence", 0))
        with self._lease_lock:
            for vid_s, l in (state.get("leases") or {}).items():
                vid = int(vid_s)
                cur = self.leases.get(vid)
                if cur is None or l["epoch"] >= cur["epoch"]:
                    self.leases[vid] = dict(l)
            self._lease_epoch = max(self._lease_epoch,
                                    state.get("lease_epoch", 0))

    def _apply_lease(self, lease: dict) -> None:
        """State-machine apply of a committed lease grant: install the
        entry (newest epoch wins per vid) and floor the sequence
        checkpoint past its range, so a failed-over leader resumes
        minting beyond every key any predecessor leased out."""
        vid = int(lease["vid"])
        with self._lease_lock:
            cur = self.leases.get(vid)
            if cur is None or lease["epoch"] >= cur["epoch"]:
                self.leases[vid] = dict(lease)
            self._lease_epoch = max(self._lease_epoch, lease["epoch"])
            self._seq_ckpt = max(self._seq_ckpt, lease["key_hi"] + 1)

    def _raft_propose(self, cmd: dict) -> bool:
        """Replicate a command; returns True once committed. Callers
        minting ids/vids MUST fail when this fails — handing out an
        uncommitted id invites reuse after failover."""
        if self.raft is None:
            return True
        try:
            return self.raft.propose(cmd, timeout=5.0)
        except Exception:
            return False

    def _handle_raft(self, method: str):
        def handler(req: Request) -> Response:
            if self.raft is None:
                return Response({"error": "raft not configured"},
                                status=503)
            return Response(getattr(self.raft, method)(req.json()))
        return handler

    @property
    def leader(self) -> str:
        if self.raft is not None:
            return self.raft.leader_id or self.url
        return self.url

    def is_leader(self) -> bool:
        if self.raft is not None:
            from seaweedfs_tpu_torch.cluster.raft import LEADER
            return self.raft.state == LEADER
        return True

    def _not_leader(self) -> Response:
        return Response({"error": "not leader", "leader": self.leader},
                        status=409)

    def _handle_raft_ps(self, req: Request) -> Response:
        """Raft membership view (reference shell cluster.raft.ps)."""
        if self.raft is None:
            return Response({"id": self.url, "peers": [],
                             "leader": self.url, "term": 0,
                             "state": "single"})
        return Response(self.raft.membership())

    def _handle_raft_change(self, op: str):
        """cluster.raft.add/remove: commit a membership change through
        the log (leader-only; followers 409 to the leader)."""
        def handler(req: Request) -> Response:
            if self.raft is None:
                return Response({"error": "raft not configured"},
                                status=503)
            if not self.is_leader():
                return self._not_leader()
            peer = (req.json() or {}).get("peer", "")
            if not peer:
                return Response({"error": "missing peer"}, status=400)
            if op == "remove" and peer == self.raft.id:
                return Response(
                    {"error": "cannot remove the leader; transfer "
                     "leadership first (stop this master)"}, status=400)
            ok = self._raft_propose(
                {"type": "raft_config", "op": op, "peer": peer})
            if not ok:
                return Response({"error": "config change not committed"},
                                status=503)
            return Response(self.raft.membership())
        return handler

    # ---- routes ----
    def _register_routes(self) -> None:
        r = self.http.add
        r("POST", "/heartbeat", self._handle_heartbeat)
        r("GET", "/dir/assign", self._handle_assign)
        r("POST", "/dir/assign", self._handle_assign)
        r("GET", "/dir/lookup", self._handle_lookup)
        r("GET", "/dir/lookup_ec", self._handle_lookup_ec)
        r("GET", "/dir/status", self._handle_dir_status)
        r("POST", "/vol/grow", self._handle_grow)
        r("GET", "/cluster/status", self._handle_cluster_status)
        r("GET", "/cluster/leases", self._handle_cluster_leases)
        r("GET", "/cluster/health", self._handle_cluster_health)
        r("GET", "/cluster/qos", self._handle_cluster_qos)
        r("GET", "/cluster/telemetry", self._handle_cluster_telemetry)
        r("GET", "/cluster/raft/ps", self._handle_raft_ps)
        r("POST", "/cluster/raft/add", self._handle_raft_change("add"))
        r("POST", "/cluster/raft/remove",
          self._handle_raft_change("remove"))
        r("POST", "/admin/lock", self._handle_lock)
        r("POST", "/admin/unlock", self._handle_unlock)
        r("GET", "/metrics", self._handle_metrics)
        r("GET", "/col/list", self._handle_col_list)
        r("POST", "/cluster/register", self._handle_cluster_register)
        r("POST", "/dir/leave", self._handle_dir_leave)
        r("GET", "/cluster/nodes", self._handle_cluster_nodes)
        r("GET", "/cluster/filers", self._handle_cluster_filers)
        r("GET", "/cluster/rebalance", self._handle_rebalance_status)
        r("POST", "/cluster/rebalance/kick", self._handle_rebalance_kick)
        r("POST", "/cluster/rebalance/commit",
          self._handle_rebalance_commit)
        r("GET", "/cluster/tiering", self._handle_tiering_status)
        r("POST", "/cluster/tiering/kick", self._handle_tiering_kick)
        r("POST", "/col/delete", self._handle_col_delete)
        r("GET", "/ui", self._handle_ui)
        r("GET", "/", self._handle_ui)
        r("POST", "/scrub/report", self._handle_scrub_report)
        r("GET", "/ec/repair/status", self._handle_repair_status)
        r("POST", "/ec/repair/kick", self._handle_repair_kick)
        r("GET", "/admin/qos", self._admin_qos)
        r("POST", "/admin/qos", self._admin_qos_configure)
        # folded-stack window from the wall sampler (prof_collect)
        r("GET", "/admin/profile", profiler.make_profile_handler(
            self.sampler, lambda: self.url, "master"))
        r("POST", "/raft/vote", self._handle_raft("on_request_vote"))
        r("POST", "/raft/append", self._handle_raft("on_append_entries"))
        r("POST", "/raft/snapshot", self._handle_raft("on_install_snapshot"))
        from seaweedfs_tpu_torch.utils.debug import install_debug_routes
        install_debug_routes(self.http)

    # Shedding cluster-control traffic would destabilize the cluster
    # the governor is trying to protect: heartbeats/raft keep liveness,
    # scrub reports and repair control keep integrity moving, and the
    # observability/registration endpoints must answer while degraded.
    # The governed edge is the SERVING one: lookups, assigns, growth,
    # directory status.
    QOS_EXEMPT = ("/heartbeat", "/raft/", "/cluster/", "/metrics", "/ui",
                  "/debug", "/scrub/report", "/ec/repair/", "/admin/lock",
                  "/admin/unlock", "/admin/qos", "/admin/profile",
                  "/dir/leave", "/col/")

    def _admission_gate(self, method: str, path: str, headers, client):
        """HttpServer admission hook for the master's serving edge —
        same contract as the volume server's: classify (propagated
        header wins), ask the governor, shed with 503 + Retry-After."""
        if not self.qos.enabled or path == "/":
            return None
        for p in self.QOS_EXEMPT:
            if path.startswith(p):
                return None
        cls = from_headers(headers) or self._classify_master(method, path)
        grant = self.qos.admit(cls)
        if not grant.ok:
            self._m_qos_shed.inc()
            return Response(
                {"error": "overloaded", "class": cls}, status=503,
                headers={"Retry-After": f"{grant.retry_after:.2f}"})
        return grant.release

    @staticmethod
    def _classify_master(method: str, path: str) -> str:
        # assigns and growth consume topology capacity like writes;
        # lookups sit on every read path and stay interactive
        if path.startswith(("/dir/assign", "/vol/")):
            return WRITE
        if path.startswith("/dir/"):
            return INTERACTIVE
        return classify(method, path)

    def _admin_qos(self, req: Request) -> Response:
        return Response({"url": self.url, **self.qos.snapshot()})

    def _admin_qos_configure(self, req: Request) -> Response:
        if not self.is_leader():
            return self._not_leader()
        return Response({"url": self.url,
                         **self.qos.configure(**(req.json() or {}))})

    def _refresh_gauges(self) -> None:
        # runs before every exposition (scrape AND push-gateway loop)
        with self.topo.lock:
            nodes = self.topo.all_nodes()
            self._m_nodes.set(value=len(nodes))
            self._m_volumes.set(
                value=sum(len(n.volumes) for n in nodes))
            self._m_ec_shards.set(
                value=sum(n.ec_shard_count() for n in nodes))
        self._m_is_leader.set(value=1.0 if self.is_leader() else 0.0)

    def _handle_metrics(self, req: Request) -> Response:
        return Response(self.metrics.expose_text(),
                        content_type="text/plain; version=0.0.4")

    # ---- integrity & repair (scrub reports feed the repair queue) ----
    def _handle_scrub_report(self, req: Request) -> Response:
        """A volume server found corruption. Leader-only: the queue
        lives with the leader; followers redirect like /heartbeat."""
        if not self.is_leader():
            return self._not_leader()
        return Response(self.repair_queue.report(req.json() or {}))

    def _handle_repair_status(self, req: Request) -> Response:
        return Response(self.repair_queue.status())

    def _handle_repair_kick(self, req: Request) -> Response:
        if not self.is_leader():
            return self._not_leader()
        return Response(self.repair_queue.kick())

    def _handle_dir_leave(self, req: Request) -> Response:
        """A volume server announcing a graceful exit: drop its volumes
        from the topology immediately instead of waiting out the
        liveness window (reference master_grpc_server.go UnRegister)."""
        url = req.json().get("url", "")
        for node in self.topo.all_nodes():
            if node.url == url or node.id == url:
                self.topo.unregister_data_node(node)
                return Response({"unregistered": url})
        return Response({"error": f"unknown volume server {url}"},
                        status=404)

    def _handle_cluster_register(self, req: Request) -> Response:
        """Filer/broker membership announcements (reference
        weed/cluster/cluster.go + master ListClusterNodes). A node
        that announces a metrics_url makes its telemetry/hotkeys
        endpoints pullable (filer/S3 serve those on the private
        metrics listener, which the topology doesn't know)."""
        b = req.json()
        ntype, url = b.get("type", "filer"), b["url"]
        self._cluster_nodes[(ntype, url)] = clockctl.now()
        if b.get("metrics_url"):
            self._cluster_node_meta[(ntype, url)] = {
                "metrics_url": b["metrics_url"]}
        if ntype == "filer":
            # bump the ring epoch NOW rather than lazily at read time,
            # so a client pulling right after a membership change can't
            # observe new members under the old epoch
            self._current_filer_ring()
            if b.get("shard_load"):
                self.rebalance.observe(url, b["shard_load"])
                self._maybe_rebalance()
        return Response({})

    # ---- live shard rebalancing (filer/rebalance.py) ----
    def _maybe_rebalance(self, force: bool = False) -> Optional[dict]:
        """Ask the planner for a plan against the current ring; when
        one emits, dispatch move orders to each source filer in a
        short-lived thread (the mover runs there; announce handling
        must not block on a migration).  Leader-only, like repair."""
        if not self.is_leader():
            return None
        with self._filer_ring_lock:
            ring = self._filer_ring
        plan = self.rebalance.plan(ring, force=force)
        if plan is None:
            return None
        glog.info("rebalance plan: hot=%s (%.1fx mean) -> %s: %s",
                  plan["hot"], plan["imbalance"], plan["cold"],
                  [m["dir"] for m in plan["moves"]])
        threading.Thread(target=self._dispatch_moves,
                         args=(plan["moves"],),
                         name="rebalance-dispatch", daemon=True).start()
        return plan

    def _dispatch_moves(self, moves: list[dict]) -> None:
        from seaweedfs_tpu_torch.utils.httpd import http_json
        for mv in moves:
            try:
                out = http_json(
                    "POST",
                    f"http://{mv['from']}/__api/shard/migrate",
                    {"dir": mv["dir"], "to": mv["to"]}, timeout=10)
                self.rebalance_dispatched.append(
                    {**mv, "accepted": bool(out.get("started"))})
                if not out.get("started"):
                    # mover busy: let the next planner round retry
                    self.rebalance.note_failed(mv["dir"])
            except Exception as e:
                glog.warning("rebalance dispatch %s -> %s failed: %s",
                             mv["dir"], mv["to"], e)
                self.rebalance.note_failed(mv["dir"])

    def _handle_rebalance_status(self, req: Request) -> Response:
        with self._filer_ring_lock:
            ring = self._filer_ring
        return Response({
            "planner": self.rebalance.status(),
            "dispatched": self.rebalance_dispatched[-16:],
            "overrides": dict(ring.overrides) if ring else {},
            "ring_epoch": ring.epoch if ring else 0,
        })

    def _handle_rebalance_kick(self, req: Request) -> Response:
        if not self.is_leader():
            return self._not_leader()
        plan = self._maybe_rebalance(force=True)
        return Response({"plan": plan})

    def _handle_rebalance_commit(self, req: Request) -> Response:
        """The mover finished copying: flip ownership.  Layer the
        {dir: dest} override over the ring under the ring lock — a
        forward-only epoch bump — and return the new ring so the
        caller can adopt it without a second round-trip."""
        if not self.is_leader():
            return self._not_leader()
        b = req.json() or {}
        directory, dest = b.get("dir", ""), b.get("to", "")
        if not directory or not dest:
            return Response({"error": "dir and to required"}, status=400)
        with self._filer_ring_lock:
            ring = self._filer_ring
            if ring is None or dest not in ring:
                return Response(
                    {"error": f"{dest} not a ring member"}, status=409)
            self._filer_ring = ring.with_overrides({directory: dest})
            out = self._filer_ring.to_dict()
        self.rebalance.note_committed(directory)
        glog.info("rebalance commit: %s -> %s (ring epoch %d)",
                  directory, dest, out["epoch"])
        return Response(out)

    # ---- tiering autopilot (storage/tiering.py) ----
    def _maybe_tier(self, force: bool = False) -> Optional[dict]:
        """Leader-gated: ask the planner for rung transitions and hand
        them to the mover. One plan in flight at a time — the mover
        refuses a start while busy, and un-dispatched moves just wait
        for the next heartbeat round."""
        if not self.is_leader() or self.tier_mover.busy:
            return None
        plan = self.tiering.plan()
        if plan is None:
            return None
        glog.info("tiering plan: %s",
                  [(m["vid"], m["from"], m["to"]) for m in plan["moves"]])
        self.tiering_dispatched.extend(plan["moves"])
        if not self.tier_mover.start(plan):
            for mv in plan["moves"]:
                self.tiering.note_failed(mv["vid"])
            return None
        return plan

    def _handle_tiering_status(self, req: Request) -> Response:
        return Response({
            "planner": self.tiering.status(),
            "mover": self.tier_mover.status(),
            "dispatched": self.tiering_dispatched[-16:],
        })

    def _handle_tiering_kick(self, req: Request) -> Response:
        if not self.is_leader():
            return self._not_leader()
        plan = self._maybe_tier(force=True)
        return Response({"plan": plan})

    def _handle_cluster_nodes(self, req: Request) -> Response:
        ntype = req.query.get("type", "")
        now = clockctl.now()
        nodes = [{"type": t, "url": u}
                 for (t, u), seen in self._cluster_nodes.items()
                 if now - seen < 60 and (not ntype or t == ntype)]
        return Response({"cluster_nodes": nodes})

    def _live_filers(self) -> list[str]:
        now = clockctl.now()
        return sorted(u for (t, u), seen in self._cluster_nodes.items()
                      if t == "filer" and now - seen < 60)

    def _current_filer_ring(self):
        from seaweedfs_tpu_torch.filer.shard_ring import ring_if_changed
        with self._filer_ring_lock:
            new = ring_if_changed(self._filer_ring, self._live_filers())
            if new is not None:
                self._filer_ring = new
            return self._filer_ring

    def _handle_cluster_filers(self, req: Request) -> Response:
        """The filer shard ring: {"epoch": N, "filers": [...]}.
        wdclient pulls this once and re-pulls on X-Weed-Shard epoch
        mismatch; filer servers pull it to learn their own ring."""
        return Response(self._current_filer_ring().to_dict())

    def _handle_col_list(self, req: Request) -> Response:
        # only collections that still HOLD volumes: stale delta
        # processing can re-create an empty layout key after a
        # collection delete (get_layout is get-or-create)
        cols = sorted({c for (c, _, _, _), lo in self.topo.layouts.items()
                       if c and lo.locations})
        return Response({"collections": [{"name": c} for c in cols]})

    def _handle_col_delete(self, req: Request) -> Response:
        collection = req.query.get("collection", "")
        if not collection:
            return Response({"error": "collection required"}, status=400)
        with self.topo.lock:
            doomed = []
            for node in self.topo.all_nodes():
                for vid, v in list(node.volumes.items()):
                    if v.get("collection", "") == collection:
                        doomed.append((node, vid, v))
        # the HTTP deletes run OUTSIDE the topology lock: the volume
        # server's delete handler pushes a delta heartbeat back at this
        # master, which needs the same lock (holding it here deadlocks
        # until the pusher's timeout)
        deleted = []
        for node, vid, v in doomed:
            try:
                http_json("POST",
                          f"http://{node.url}/admin/delete_volume",
                          {"volume_id": vid},
                          deadline=Deadline.after(30.0))
            except Exception as e:
                glog.warning("collection delete: volume %d on %s: %s",
                             vid, node.url, e)
            deleted.append(vid)
        with self.topo.lock:
            for node, vid, v in doomed:
                if node.volumes.pop(vid, None) is not None:
                    self.topo._unregister_volume(v, node)
            for key in [k for k in self.topo.layouts
                        if k[0] == collection]:
                del self.topo.layouts[key]
        return Response({"deleted_volume_ids": sorted(set(deleted))})

    def _handle_ui(self, req: Request) -> Response:
        rows = []
        for node in self.topo.all_nodes():
            rows.append(
                f"<tr><td>{node.id}</td><td>{len(node.volumes)}</td>"
                f"<td>{node.ec_shard_count()}</td>"
                f"<td>{node.max_volume_count}</td></tr>")
        html = (
            "<html><head><title>seaweedfs-tpu master</title></head><body>"
            f"<h1>Master {self.url}</h1>"
            f"<p>leader: {self.leader} | max volume id: "
            f"{self.topo.max_volume_id}</p>"
            "<table border=1><tr><th>node</th><th>volumes</th>"
            "<th>ec shards</th><th>capacity</th></tr>"
            + "".join(rows) + "</table></body></html>")
        return Response(html, content_type="text/html")

    def _handle_heartbeat(self, req: Request) -> Response:
        if not self.is_leader():
            return self._not_leader()
        hb = req.json()
        self._m_heartbeat.inc()
        if hb.get("is_delta"):
            node = self.topo.find_node(f"{hb['ip']}:{hb['port']}")
            if node is None:
                return Response({"error": "unknown node, send full"},
                                status=409)
            self.topo.incremental_sync(node, hb)
        else:
            node = self.topo.sync_data_node_registration(hb)
        # tiering telemetry piggyback: per-volume read counters + rung
        # state feed the planner; a plan (if any) dispatches off-thread
        tiering = (hb.get("telemetry") or {}).get("tiering")
        if tiering and node is not None:
            self.tiering.observe(f"{hb['ip']}:{hb['port']}", tiering)
            self._maybe_tier()
        if node is not None and node.draining:
            # graceful drain announced: exempt the node's volumes from
            # the degraded repair scan so a rolling restart never looks
            # like a failure (refreshed on every draining heartbeat)
            vids = set(node.volumes) | set(node.ec_shards)
            if vids:
                self.repair_queue.note_drain(vids)
        # mirror reference reply: volume size limit + leader
        reply = {
            "volume_size_limit": self.topo.volume_size_limit,
            "leader": self.url,
            "metrics_address": "",
            "jwt_signing_key": self.jwt_signing_key,
        }
        # assign-lease piggyback: grants/renewals owed to this holder
        # ride the reply (a draining node gets none — its leases lapse
        # and writes fall back to healthy holders or the master)
        if node is not None and not node.draining:
            grants = self._lease_grants_for(node, hb.get("lease_req"))
            if grants:
                reply["leases"] = grants
        return Response(reply)

    def _sync_sequence(self, timeout: float = 2.0) -> Optional[dict]:
        """Fast-forward the live sequencer past the committed
        checkpoint once per leadership term (a fresh leader must never
        re-mint ids its predecessor handed out or leased away).
        Returns an assign-shaped error dict when raft leadership isn't
        ready, else None. timeout<=0 makes the check non-blocking for
        callers that must not stall (heartbeat grant path)."""
        if self.raft is None:
            return None
        if not self.raft.is_ready():
            # a fresh leader must commit its no-op barrier first so
            # inherited checkpoints are applied before minting ids
            if timeout <= 0 or not self.raft.wait_ready(timeout=timeout):
                return {"error": "raft leader not ready",
                        "leader": self.leader}
        term = self.raft.current_term
        if self._seq_synced_term != term:
            # once per leadership change: jump past every id any
            # previous leader may have handed out
            self.sequencer.set_max(self._seq_ckpt)
            self._seq_synced_term = term
        return None

    # ---- assign leases (grant/renew ride the heartbeat reply) ----
    def _commit_lease(self, lease: dict) -> bool:
        """Replicate a grant before handing it out; a lease the log
        didn't commit must never reach a holder (it would vanish on
        failover and the new leader could re-grant the same range)."""
        if not self._raft_propose({"type": "lease", "lease": lease}):
            return False
        if self.raft is None:
            # single-master mode: no log to apply from, install directly
            self._apply_lease(lease)
        return True

    def _lease_grants_for(self, node, lease_req) -> list:
        """Grants/renewals owed to one heartbeating holder. lease_req
        is the holder's per-vid lease view ({vid: {"next_key": n,
        "epoch": e}}, {} when it holds none) — None means the node
        doesn't speak leases and gets nothing."""
        if lease_req is None or not isinstance(lease_req, dict):
            return []
        if self._sync_sequence(timeout=0.0) is not None:
            return []  # mid-election: grant on a later pulse
        out = []
        now = clockctl.now()
        with self._grant_lock:
            for vid_s, want in lease_req.items():
                if len(out) >= LEASE_GRANTS_PER_PULSE:
                    break
                vid = int(vid_s)
                want = want if isinstance(want, dict) else {}
                vinfo = node.volumes.get(vid)
                if vinfo is None or vinfo.get("read_only"):
                    continue
                if vinfo.get("ttl"):
                    continue  # TTL volumes keep master-routed assigns
                if vinfo.get("size", 0) >= self.topo.volume_size_limit:
                    continue
                cur = self.leases.get(vid)
                if cur is not None and cur["expires_at"] > now \
                        and cur["holder"] != node.url:
                    continue  # another holder's live lease on this vid
                renewing = (cur is not None and cur["holder"] == node.url
                            and cur["expires_at"] > now)
                if renewing:
                    next_key = int(want.get("next_key", cur["key_lo"]))
                    self._lease_progress[vid] = next_key
                    left = cur["key_hi"] - next_key + 1
                    if (cur["expires_at"] - now
                            > LEASE_TTL_S * LEASE_RENEW_FRACTION
                            and left > LEASE_RANGE
                            * LEASE_RANGE_REFILL_FRACTION):
                        continue  # healthy lease: nothing owed
                key_lo = self.sequencer.next_file_id(LEASE_RANGE)
                with self.topo.lock:
                    replicas = [
                        {"url": n.url, "publicUrl": n.public_url}
                        for n in self.topo.lookup(
                            vinfo.get("collection", ""), vid)
                        if n.url != node.url]
                from seaweedfs_tpu_torch.storage.super_block import \
                    ReplicaPlacement
                lease = {"vid": vid, "holder": node.url,
                         "holder_public": node.public_url,
                         "key_lo": key_lo,
                         "key_hi": key_lo + LEASE_RANGE - 1,
                         "epoch": self._lease_epoch + 1,
                         "expires_at": now + LEASE_TTL_S,
                         "collection": vinfo.get("collection", ""),
                         "replication": str(ReplicaPlacement.from_byte(
                             vinfo.get("replica_placement", 0))),
                         "replicas": replicas}
                if not self._commit_lease(lease):
                    break  # raft can't commit: no grants this pulse
                self._lease_progress[vid] = key_lo
                op = "renew" if renewing else "grant"
                self.lease_counters[op] += 1
                self._m_lease.inc(op)
                out.append(lease)
        return out

    def _expire_leases(self) -> None:
        """Drop lapsed entries (pulse cadence). Expiry is the only
        revocation: the master never claws a live range back, it just
        stops renewing, and the holder's own clockctl check refuses to
        mint past expires_at."""
        now = clockctl.now()
        with self._lease_lock:
            dead = [vid for vid, l in self.leases.items()
                    if l["expires_at"] <= now]
            for vid in dead:
                del self.leases[vid]
        for vid in dead:
            self._lease_progress.pop(vid, None)
            self.lease_counters["expire"] += 1
            self._m_lease.inc("expire")

    def _handle_cluster_leases(self, req: Request) -> Response:
        """The assign-lease table: per-vid holder, epoch, remaining
        range (from the holder's last-reported mint cursor) and expiry.
        Served from the replicated table, so followers answer too —
        clients refresh their lease directory from here even while the
        leader is dark."""
        now = clockctl.now()
        with self._lease_lock:
            leases = [dict(l) for _, l in sorted(self.leases.items())]
        for l in leases:
            nxt = self._lease_progress.get(l["vid"], l["key_lo"])
            l["remaining_keys"] = max(0, l["key_hi"] - nxt + 1)
            l["remaining_s"] = round(l["expires_at"] - now, 3)
        return Response({
            "master": self.url,
            "leader": self.leader,
            "is_leader": self.is_leader(),
            "lease_ttl_s": LEASE_TTL_S,
            "default_replication": self.default_replication,
            "counters": dict(self.lease_counters),
            "leases": leases,
        })

    def assign_fid(self, count: int = 1, collection: str = "",
                   replication: str = "", ttl: str = "",
                   data_center: str = "", disk_type: str = "") -> dict:
        """Core assignment: pick/grow a writable volume, mint a fid.
        Returns the reply dict or {"error": ...} (used by both the HTTP
        and gRPC planes)."""
        err = self._sync_sequence()
        if err is not None:
            return err
        replication = replication or self.default_replication
        layout = self.topo.get_layout(collection, replication, ttl,
                                      disk_type)
        with self._grow_lock:
            # grow when there is nothing writable, and ALSO when every
            # writable volume touches a draining node: a rolling
            # restart must not funnel new writes onto the server that
            # is about to close its listener
            if layout.clean_volume_count() == 0:
                try:
                    grow_by_type(self.topo, collection, replication, ttl,
                                 self._allocate_rpc, count=1,
                                 preferred_dc=data_center, disk=disk_type)
                except NoFreeSpaceError as e:
                    if layout.active_volume_count() == 0:
                        return {"error": str(e)}
                    # no room to grow but draining copies still serve:
                    # pick_for_write's fallback takes the slow path
                # replicate the new MaxVolumeId so a failed-over leader
                # never re-issues a vid (cluster_commands.go)
                if not self._raft_propose({"type": "max_volume_id",
                                           "value":
                                           self.topo.max_volume_id}):
                    return {"error": "raft: volume id not committed",
                            "leader": self.leader}
        try:
            vid, nodes = layout.pick_for_write()
        except LookupError as e:
            return {"error": str(e)}
        key = self.sequencer.next_file_id(count)
        if self.raft is not None and key + count >= self._seq_ckpt:
            # checkpoint the sequence ahead of use so a failed-over
            # leader resumes past every id this one may have handed
            # out; minting beyond an uncommitted checkpoint is unsafe,
            # so the assign fails if the commit does
            new_ckpt = key + count + 1000
            if not self._raft_propose({"type": "sequence",
                                       "value": new_ckpt}):
                return {"error": "raft: sequence checkpoint not committed",
                        "leader": self.leader}
            self._seq_ckpt = max(self._seq_ckpt, new_ckpt)
        cookie = random.getrandbits(32)
        fid = f"{vid},{format_needle_id_cookie(key, cookie)}"
        node = nodes[0]
        self._m_assign.inc()
        reply = {
            "fid": fid,
            "url": node.url,
            "publicUrl": node.public_url,
            "count": count,
            "replicas": [{"url": n.url, "publicUrl": n.public_url}
                         for n in nodes[1:]],
        }
        if self.jwt_signing_key:
            from seaweedfs_tpu_torch.utils.security import gen_jwt
            reply["auth"] = gen_jwt(self.jwt_signing_key, fid)
        return reply

    def _handle_assign(self, req: Request) -> Response:
        if not self.is_leader():
            return self._not_leader()
        reply = self.assign_fid(
            count=int(req.query.get("count") or 1),
            collection=req.query.get("collection", ""),
            replication=req.query.get("replication", ""),
            ttl=req.query.get("ttl", ""),
            data_center=req.query.get("dataCenter", ""),
            disk_type=req.query.get("disk", ""))
        if "error" in reply:
            # a not-ready fresh leader answers 503 + its leader hint so
            # clients re-resolve and retry instead of treating it as a
            # hard failure (wdclient._call follows the hint)
            return Response(reply,
                            status=503 if "leader" in reply else 500)
        return Response(reply)

    def _allocate_rpc(self, node, vid, collection, rp, ttl,
                      disk: str = "") -> bool:
        from seaweedfs_tpu_torch.storage.super_block import (ReplicaPlacement,
                                                       TTL)
        try:
            # growth rides the assign path: write class, not the
            # background that classify() would infer from /admin
            with class_scope(WRITE):
                http_json("POST",
                          f"http://{node.url}/admin/allocate_volume",
                          {"volume_id": vid, "collection": collection,
                           "replication": rp, "ttl": ttl,
                           "disk_type": disk},
                          deadline=Deadline.after(30.0))
            self.peer_health.record(node.url, True)
        except Exception as e:
            if isinstance(e, ConnectionError):
                self.peer_health.record(node.url, False)
            glog.error("volume growth: allocate %d on %s failed: %s",
                       vid, node.url, e)
            return False
        # register immediately (like the reference's RegisterVolumeLayout
        # after AllocateVolume) instead of waiting for the next heartbeat
        vinfo = {"id": vid, "size": 0, "collection": collection,
                 "replica_placement": ReplicaPlacement.parse(rp).to_byte(),
                 "read_only": False, "file_count": 0, "delete_count": 0,
                 "deleted_byte_count": 0, "disk_type": disk or "hdd",
                 "ttl": TTL.parse(ttl).to_uint32(), "version": 3}
        with self.topo.lock:
            node.volumes[vid] = vinfo
            self.topo._register_volume(vinfo, node)
        return True

    def _proxy_to_leader(self, req: Request) -> Optional[Response]:
        """Followers answer read endpoints by proxying to the leader
        (reference master.follower / master proxy-to-leader): volume
        servers heartbeat only to the leader, so a follower's topology
        is empty — serving it locally would 404 every lookup. The
        X-Weed-Proxied guard stops loops during elections."""
        if self.is_leader():
            return None
        if req.headers.get(weed_headers.PROXIED):
            return None  # second hop: answer locally rather than loop
        leader = self.leader
        if not leader or leader == self.url:
            return None
        import json
        import urllib.parse

        from seaweedfs_tpu_torch.utils.httpd import http_call
        qs = urllib.parse.urlencode(req.query)
        try:
            status, body, _ = http_call(
                "GET", f"http://{leader}{req.path}?{qs}",
                headers={weed_headers.PROXIED: "1"},
                deadline=Deadline.after(10.0))
            parsed = json.loads(body) if body else {}
        except (ConnectionError, ValueError):
            # leader unreachable or spoke garbage (e.g. a stale
            # leader_id now pointing at something else): best-effort
            # local answer instead of a 500
            return None
        return Response(parsed, status=status)

    def _handle_lookup(self, req: Request) -> Response:
        proxied = self._proxy_to_leader(req)
        if proxied is not None:
            return proxied
        vid_str = req.query.get("volumeId", "")
        vid = int(vid_str.split(",")[0]) if vid_str else 0
        collection = req.query.get("collection", "")
        nodes = self.topo.lookup(collection, vid)
        self._m_lookup.inc()
        if not nodes:
            return Response(
                {"volumeId": vid_str, "error": "volume id not found"},
                status=404)
        return Response({
            "volumeId": vid_str,
            "locations": [{"url": n.url, "publicUrl": n.public_url}
                          for n in nodes],
        })

    def _handle_lookup_ec(self, req: Request) -> Response:
        proxied = self._proxy_to_leader(req)
        if proxied is not None:
            return proxied
        vid = int(req.query.get("volumeId", 0))
        shards = self.topo.lookup_ec_shards(vid)
        if shards is None:
            return Response({"error": "ec volume not found"}, status=404)
        # each location carries its holder's heartbeat-reported QoS
        # pressure so chain planners can tie-break away from loaded
        # holders without extra round trips
        return Response({
            "volumeId": vid,
            "shards": [
                {"shard_id": sid,
                 "locations": [
                     {"url": n.url, "publicUrl": n.public_url,
                      "qos_pressure": round(
                          getattr(n, "qos_pressure", 0.0), 4)}
                     for n in nodes]}
                for sid, nodes in enumerate(shards)],
        })

    def _handle_dir_status(self, req: Request) -> Response:
        proxied = self._proxy_to_leader(req)
        if proxied is not None:
            return proxied
        return Response({"Topology": self.topo.to_info(),
                         "VolumeSizeLimitMB":
                         self.topo.volume_size_limit // (1024 * 1024),
                         "Version": "seaweedfs-tpu 0.1"})

    def _handle_grow(self, req: Request) -> Response:
        if not self.is_leader():
            return self._not_leader()
        if self.raft is not None and not self.raft.is_ready():
            # same barrier as assign_fid: a fresh leader must apply
            # inherited max_volume_id commits before minting new vids
            if not self.raft.wait_ready(timeout=2.0):
                return Response({"error": "raft leader not ready"},
                                status=503)
        count = int(req.query.get("count") or 1)
        collection = req.query.get("collection", "")
        replication = (req.query.get("replication")
                       or self.default_replication)
        ttl = req.query.get("ttl", "")
        try:
            vids = grow_by_type(self.topo, collection, replication, ttl,
                                self._allocate_rpc, count=count,
                                disk=req.query.get("disk", ""))
        except NoFreeSpaceError as e:
            return Response({"error": str(e)}, status=500)
        if not self._raft_propose({"type": "max_volume_id",
                                   "value": self.topo.max_volume_id}):
            return Response({"error": "raft: volume id not committed",
                             "leader": self.leader}, status=500)
        return Response({"count": len(vids), "volume_ids": vids})

    def _handle_cluster_status(self, req: Request) -> Response:
        return Response({
            "IsLeader": self.is_leader(),
            "Leader": self.leader,
            "Peers": self.peers,
            "MaxVolumeId": self.topo.max_volume_id,
        })

    def _handle_cluster_health(self, req: Request) -> Response:
        """Resilience rollup for the cluster.health shell command: per
        registered node (liveness, scrub state, load), this master's
        breaker/health table, and the repair bandwidth budget."""
        now = clockctl.now()
        with self.topo.lock:
            nodes = [{
                "url": n.url,
                "last_seen_s": round(now - n.last_seen, 1),
                "scrubbing": bool(getattr(n, "scrubbing", False)),
                "qos_pressure": round(getattr(n, "qos_pressure", 0.0), 4),
                "volumes": len(n.volumes),
                "ec_shards": n.ec_shard_count(),
            } for n in self.topo.all_nodes()]
        st = self.repair_queue.status()
        return Response({
            "master": self.url,
            "leader": self.leader,
            "is_leader": self.is_leader(),
            "nodes": nodes,
            "peers": self.peer_health.snapshot(),
            "repair": {
                "rate_bytes_per_sec":
                    st.get("repair_rate_bytes_per_sec", 0),
                "budget_remaining_bytes":
                    st.get("budget_remaining_bytes"),
                "active": st.get("active", 0),
                "queued": st.get("queued", 0),
            },
        })

    def _handle_cluster_qos(self, req: Request) -> Response:
        """Cluster QoS rollup for the cluster.qos shell command:
        per-node overload pressure (from heartbeats) and how far the
        repair budget has backed off in response."""
        now = clockctl.now()
        with self.topo.lock:
            nodes = [{
                "url": n.url,
                "last_seen_s": round(now - n.last_seen, 1),
                "qos_pressure": round(getattr(n, "qos_pressure", 0.0), 4),
            } for n in self.topo.all_nodes()]
        st = self.repair_queue.status()
        return Response({
            "master": self.url,
            "is_leader": self.is_leader(),
            "cluster_pressure": max(
                (n["qos_pressure"] for n in nodes), default=0.0),
            "master_edge": self.qos.snapshot(),
            "nodes": nodes,
            "repair": {
                "base_rate_bytes_per_sec":
                    st.get("base_rate_bytes_per_sec", 0),
                "rate_bytes_per_sec":
                    st.get("repair_rate_bytes_per_sec", 0),
                "cluster_qos_pressure":
                    st.get("cluster_qos_pressure", 0.0),
            },
        })

    # ---- cluster telemetry plane (RED quantiles, hot keys, SLO) ----
    def telemetry_snapshot(self) -> dict:
        """This master's own edge contribution to the merged view."""
        return {"node": self.url, "server": "master",
                "red": self.red.snapshot(),
                "ledger": self.ledger.snapshot()}

    def _on_slo_transition(self, t, cls, old, new, detail) -> None:
        glog.info("slo: class=%s %s -> %s (%s)", cls, old, new, detail)

    def _telemetry_node_snaps(self) -> list:
        """Everything reachable without network: our own edge plus
        the per-volume-server snapshots riding heartbeats."""
        snaps = [self.telemetry_snapshot()]
        with self.topo.lock:
            for n in self.topo.all_nodes():
                t = getattr(n, "telemetry", None)
                if t:
                    snaps.append(t)
        return snaps

    def _pull_peer_telemetry(self, unreachable: list) -> list:
        """Filer/S3 snapshots via the /cluster/register membership
        table (they announce a metrics_url; /admin/telemetry lives
        there because their main ports are user namespace)."""
        snaps = []
        now = clockctl.now()
        for (ntype, url), seen in list(self._cluster_nodes.items()):
            if now - seen >= 60:
                continue
            meta = self._cluster_node_meta.get((ntype, url)) or {}
            target = meta.get("metrics_url")
            if not target:
                continue
            try:
                snaps.append(http_json(
                    "GET", f"http://{target}/admin/telemetry",
                    deadline=Deadline.after(3.0)))
            except Exception as e:
                unreachable.append({"node": url, "type": ntype,
                                    "error": type(e).__name__})
        return snaps

    def _refresh_slo_gauges(self, slo_view: dict) -> None:
        for cls, judged in slo_view.items():
            self._m_slo_burn.set(cls, "fast",
                                 value=judged["fast_burn"])
            self._m_slo_burn.set(cls, "slow",
                                 value=judged["slow_burn"])
            self._m_slo_alert.set(cls, value={
                "ok": 0.0, "slow_burn": 0.5,
                "fast_burn": 1.0}[judged["state"]])

    def _feed_slo(self) -> None:
        """Pulse-cadence SLO evaluation from heartbeat-held snapshots
        only (no network) — burn-rate windows accumulate even when
        nobody scrapes /cluster/telemetry."""
        try:
            view = self.telemetry.rollup(clockctl.monotonic(),
                                         self._telemetry_node_snaps())
            self._refresh_slo_gauges(view["slo"])
        except Exception as e:
            glog.vlog(1, "slo feed failed: %s", e)

    def _handle_cluster_telemetry(self, req: Request) -> Response:
        """Merged cluster view: per-class p50/p99 + error rates from
        exact histogram merging, cluster top-k hot keys, bucket
        exemplar trace ids, and the SLO burn-rate judgement."""
        unreachable: list = []
        snaps = self._telemetry_node_snaps()
        if req.query.get("peers", "true") != "false":
            snaps += self._pull_peer_telemetry(unreachable)
        view = self.telemetry.rollup(
            clockctl.monotonic(), snaps,
            top_k=int(req.query.get("k", 10)))
        self._refresh_slo_gauges(view["slo"])
        view.update({"master": self.url,
                     "is_leader": self.is_leader(),
                     "unreachable": unreachable})
        return Response(view)

    def _handle_lock(self, req: Request) -> Response:
        body = req.json() or {}
        client = body.get("client", "unknown")
        now = clockctl.now()
        if (self._admin_lock_holder
                and self._admin_lock_holder != client
                and now - self._admin_lock_ts < 60):
            return Response({"error":
                             f"locked by {self._admin_lock_holder}"},
                            status=409)
        self._admin_lock_holder = client
        self._admin_lock_ts = now
        return Response({"holder": client})

    def _handle_unlock(self, req: Request) -> Response:
        self._admin_lock_holder = None
        return Response({})
