"""Shell command appliers: execute EC/volume plans via server RPCs.

The workflow sequences mirror the reference shell commands
(weed/shell/command_ec_encode.go:57-123, command_ec_rebuild.go,
command_ec_balance.go, command_ec_decode.go, command_volume_fix_replication.go):
planning is delegated to shell/ec_plan.py pure functions; this module owns
the RPC choreography.

The port's copy of seaweedfs_tpu/shell/commands.py. Like the reference's
shell it is gRPC-first: each volume server's gRPC admin plane
(server/volume_grpc.py) is probed once, and a node without one, an RPC
that is not mapped, or a plane that went UNAVAILABLE takes HTTP. Unlike
the reference's probe, a node whose heartbeat advertises grpc_port 0 is
not dialled at all. Its
ec.rebuild, ec.balance and ec.decode requests name the volume's
collection, from the master's EC shard map (the reference's shell sends
it; seaweedfs_tpu's sends none), so the volume servers open
``<collection>_<vid>.*``. It takes no device: EC work runs on the volume
servers. It imports nothing of that package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

from seaweedfs_tpu_torch.shell import ec_plan
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json


class ShellContext:
    def __init__(self, master_url: str, use_grpc: bool = True):
        self.master_url = master_url
        self.cwd = "/"  # fs.cd state; relative fs.* paths resolve here
        # volume-server gRPC admin plane: probed per node (port+10000
        # convention, like the master), HTTP fallback kept — the
        # reference's shell is gRPC-first the same way
        self.use_grpc = use_grpc
        self._grpc_clients: dict = {}

    # ---- helpers ----
    def topology(self) -> dict:
        return http_json(
            "GET", f"http://{self.master_url}/dir/status")["Topology"]

    @staticmethod
    def _ec_collections(topo: dict) -> dict[int, str]:
        """vid -> collection of each EC volume of a named collection in a
        /dir/status topology dump."""
        return {e["id"]: e["collection"]
                for dc in topo.get("data_centers", [])
                for rack in dc.get("racks", [])
                for n in rack.get("nodes", [])
                for e in n.get("ec_shards", []) if e.get("collection")}

    def _grpc_client(self, node: str):
        """GrpcVolumeClient for node 'ip:port', or None (probed once). A
        node whose heartbeat advertises grpc_port 0 serves no plane and is
        not dialled."""
        if node in self._grpc_clients:
            return self._grpc_clients[node]
        client = None
        try:
            from seaweedfs_tpu_torch.cluster.topology import find_node_info
            ip, port = node.rsplit(":", 1)
            # the node advertises its gRPC port in heartbeats; where the
            # master names none, the reference's port+10000 convention
            info = find_node_info(self.topology(), node) or {}
            gport = info.get("grpc_port")
            if gport == 0:
                raise LookupError(f"{node} serves no gRPC plane")
            import grpc as _grpc

            from seaweedfs_tpu_torch.server.volume_grpc import GrpcVolumeClient
            from seaweedfs_tpu_torch.utils.tls import make_channel
            addr = f"{ip}:{gport or int(port) + 10000}"
            ch = make_channel(addr)  # honors security.toml mTLS
            _grpc.channel_ready_future(ch).result(timeout=0.5)
            ch.close()
            client = GrpcVolumeClient(addr)
        except Exception:
            client = None
        self._grpc_clients[node] = client
        return client

    def _vs(self, node: str, path: str, body: dict, timeout: float = 300):
        if self.use_grpc:
            client = self._grpc_client(node)
            if client is not None:
                import grpc as _grpc
                try:
                    return client.call(path, body, timeout=timeout)
                except KeyError:
                    pass  # RPC not mapped -> HTTP
                except _grpc.RpcError as e:
                    code = e.code()
                    if code == _grpc.StatusCode.UNAVAILABLE:
                        self._grpc_clients[node] = None  # node plane gone
                    else:
                        status = {
                            _grpc.StatusCode.NOT_FOUND: 404,
                            _grpc.StatusCode.INVALID_ARGUMENT: 400,
                        }.get(code, 500)
                        raise HttpError(
                            status, (e.details() or "").encode()) from e
        return http_json("POST", f"http://{node}{path}", body,
                         timeout=timeout)

    def lock(self, client: str = "shell") -> None:
        http_json("POST", f"http://{self.master_url}/admin/lock",
                  {"client": client})

    def unlock(self) -> None:
        http_json("POST", f"http://{self.master_url}/admin/unlock", {})

    # ---- volume commands ----
    def volume_list(self) -> dict:
        return self.topology()

    def volume_fix_replication(self, apply: bool = True) -> list[dict]:
        """Re-replicate under-replicated volumes (reference
        command_volume_fix_replication.go). Returns the fixes planned."""
        topo = self.topology()
        replicas: dict[int, list[str]] = defaultdict(list)
        vinfos: dict[int, dict] = {}
        all_nodes = []
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for n in rack.get("nodes", []):
                    all_nodes.append(n)
                    for v in n.get("volumes", []):
                        replicas[v["id"]].append(n["id"])
                        vinfos[v["id"]] = v
        from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement
        fixes = []
        for vid, owners in sorted(replicas.items()):
            rp = ReplicaPlacement.from_byte(
                vinfos[vid].get("replica_placement", 0))
            need = rp.copy_count - len(owners)
            if need <= 0:
                continue
            candidates = [n for n in all_nodes if n["id"] not in owners
                          and len(n.get("volumes", []))
                          < n.get("max_volume_count", 8)]
            candidates.sort(key=lambda n: len(n.get("volumes", [])))
            for target in candidates[:need]:
                fixes.append({"vid": vid, "source": owners[0],
                              "target": target["id"],
                              "collection": vinfos[vid].get("collection", ""),
                              "disk_type": vinfos[vid].get("disk_type",
                                                           "")})
        if apply:
            for fix in fixes:
                self._vs(fix["target"], "/admin/copy_volume",
                         {"volume_id": fix["vid"],
                          "collection": fix["collection"],
                          "source_data_node": fix["source"],
                          "disk_type": fix["disk_type"]})
        return fixes

    def volume_vacuum(self, garbage_threshold: float = 0.3) -> list[int]:
        """Compact volumes whose garbage ratio exceeds the threshold
        (reference shell `volume.vacuum`)."""
        topo = self.topology()
        compacted = []
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for n in rack.get("nodes", []):
                    for v in n.get("volumes", []):
                        check = self._vs(n["id"], "/admin/vacuum",
                                         {"volume_id": v["id"],
                                          "check_only": True})
                        if check.get("garbage_ratio", 0) > garbage_threshold:
                            self._vs(n["id"], "/admin/vacuum",
                                     {"volume_id": v["id"]})
                            compacted.append(v["id"])
        return compacted

    def _volume_locations(self) -> tuple[dict, dict]:
        """vid -> [node urls], vid -> volume info, from the topology."""
        topo = self.topology()
        replicas: dict[int, list[str]] = defaultdict(list)
        vinfos: dict[int, dict] = {}
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for n in rack.get("nodes", []):
                    for v in n.get("volumes", []):
                        replicas[v["id"]].append(n["id"])
                        vinfos[v["id"]] = v
        return replicas, vinfos

    def volume_check_disk(self, vid: Optional[int] = None,
                          fix: bool = False) -> list[dict]:
        """Compare replicas of each volume by live needle inventory; with
        fix=True, copy missing needles from the replica that has them
        (reference command_volume_check_disk.go)."""
        replicas, _ = self._volume_locations()
        reports = []
        for v, owners in sorted(replicas.items()):
            if vid is not None and v != vid:
                continue
            if len(owners) < 2:
                continue  # nothing to cross-check
            digests = {}
            for node in owners:
                digests[node] = http_json(
                    "GET",
                    f"http://{node}/admin/volume_digest?volumeId={v}")
            if len({d["digest"] for d in digests.values()}) == 1:
                continue  # replicas agree
            keysets = {node: {k: s for k, s in d["keys"]}
                       for node, d in digests.items()}
            report = {"vid": v, "nodes": {n: d["file_count"]
                                          for n, d in digests.items()},
                      "fixed": 0}
            if fix:
                union: dict[int, str] = {}
                for node, ks in keysets.items():
                    for k in ks:
                        union.setdefault(k, node)
                for node, ks in keysets.items():
                    for k, src in union.items():
                        if k in ks or src == node:
                            continue
                        # copy the raw record so every field (name, mime,
                        # flags, ttl, cookie) survives the repair
                        blob = http_json(
                            "GET", f"http://{src}/admin/needle_blob"
                                   f"?volumeId={v}&key={k}")
                        out = self._vs(node, "/admin/write_needle_blob",
                                       {"volume_id": v,
                                        "size": blob["size"],
                                        "blob": blob["blob"]})
                        if "error" not in out:
                            report["fixed"] += 1
            reports.append(report)
        return reports

    def volume_tier_upload(self, vid: int, endpoint: str, bucket: str,
                           keep_local: bool = False) -> dict:
        """Move a volume's .dat to an S3-compatible tier (reference shell
        volume.tier.upload); the volume keeps serving reads through it."""
        replicas, vinfos = self._volume_locations()
        if vid not in replicas:
            raise LookupError(f"volume {vid} not found")
        out = {}
        for node in replicas[vid]:
            out[node] = self._vs(node, "/admin/tier_upload",
                                 {"volume_id": vid, "endpoint": endpoint,
                                  "bucket": bucket,
                                  "keep_local": keep_local})
        return out

    def volume_tier_download(self, vid: int) -> dict:
        """Pull a tiered volume's .dat back (reference shell
        volume.tier.download)."""
        replicas, _ = self._volume_locations()
        if vid not in replicas:
            raise LookupError(f"volume {vid} not found")
        return {node: self._vs(node, "/admin/tier_download",
                               {"volume_id": vid})
                for node in replicas[vid]}

    def volume_tier_status(self, vid: Optional[int] = None) -> dict:
        """Tiering-autopilot view: the master planner's per-volume
        temperatures/rungs/bands + mover state, enriched with each
        volume server's own /admin/tier census (rung counts, move
        counters). An unreachable server is reported, not fatal."""
        out = http_json("GET",
                        f"http://{self.master_url}/cluster/tiering")
        if vid is not None:
            vols = out.get("planner", {}).get("volumes", {})
            out["volume"] = vols.get(str(vid), vols.get(vid))
        servers: dict[str, dict] = {}
        for vol in out.get("planner", {}).get("volumes", {}).values():
            for url in vol.get("urls", []):
                if url in servers:
                    continue
                try:
                    st = http_json("GET", f"http://{url}/admin/tier")
                    servers[url] = {"rungs": st.get("rungs", {}),
                                    "stats": st.get("stats", {})}
                except Exception as e:
                    servers[url] = {"error": type(e).__name__}
        out["servers"] = servers
        return out

    def volume_tier_rung_move(self, vid: int, to_rung: str,
                              endpoint: str = "",
                              bucket: str = "tier") -> dict:
        """Operator-forced rung transition on every replica, through
        the same BACKGROUND-classed endpoints the autopilot's mover
        uses (the volume server enters the scope)."""
        replicas, _ = self._volume_locations()
        if vid not in replicas:
            raise LookupError(f"volume {vid} not found")
        from seaweedfs_tpu_torch.storage.erasure_coding import layout
        out = {}
        for node in replicas[vid]:
            if to_rung == "cloud":
                out[node] = self._vs(node, "/admin/tier/demote",
                                     {"volume_id": vid,
                                      "endpoint": endpoint,
                                      "bucket": bucket}, timeout=600)
            elif to_rung == "ec":
                out[node] = self._vs(node, "/admin/ec/generate",
                                     {"volume_id": vid}, timeout=600)
                # the rung census reads MOUNTED shards: an unmounted
                # encode still reports "hot" (and the autopilot would
                # plan the demotion again)
                self._vs(node, "/admin/ec/mount",
                         {"volume_id": vid,
                          "shard_ids":
                          list(range(layout.TOTAL_SHARDS_COUNT))},
                         timeout=600)
            elif to_rung in ("hot", "local"):
                # the way up depends on where the volume is now:
                # cloud -> untier the .dat, ec -> decode the shards
                try:
                    cur = http_json(
                        "GET", f"http://{node}/admin/tier"
                    ).get("volumes", {}).get(str(vid), {}).get("rung")
                except Exception:
                    cur = None
                if cur == "ec":
                    out[node] = self._vs(node, "/admin/ec/to_volume",
                                         {"volume_id": vid}, timeout=600)
                else:
                    out[node] = self._vs(node, "/admin/tier/promote",
                                         {"volume_id": vid}, timeout=600)
            else:
                raise ValueError(f"unknown rung {to_rung!r} "
                                 "(hot|ec|cloud)")
        return out

    def volume_move(self, vid: int, source: str, target: str,
                    collection: str = "", disk_type: str = "") -> None:
        """Move a volume: copy to target then delete on source
        (reference shell `volume.move`); disk_type lands the copy on
        that tier of the target."""
        self._vs(target, "/admin/copy_volume",
                 {"volume_id": vid, "collection": collection,
                  "source_data_node": source, "disk_type": disk_type})
        self._vs(source, "/admin/delete_volume", {"volume_id": vid})

    def volume_copy(self, vid: int, source: str, target: str,
                    collection: str = "") -> None:
        """Add a replica: copy WITHOUT deleting the source (reference
        shell `volume.copy`)."""
        self._vs(target, "/admin/copy_volume",
                 {"volume_id": vid, "collection": collection,
                  "source_data_node": source})

    def volume_mount(self, vid: int, node: str) -> dict:
        return self._vs(node, "/admin/mount_volume", {"volume_id": vid})

    def volume_unmount(self, vid: int, node: str) -> dict:
        return self._vs(node, "/admin/unmount_volume", {"volume_id": vid})

    def volume_delete(self, vid: int, node: str) -> dict:
        return self._vs(node, "/admin/delete_volume", {"volume_id": vid})

    def volume_mark(self, vid: int, node: str,
                    readonly: bool = True) -> dict:
        """volume.mark -readonly / -writable (reference
        command_volume_mark.go)."""
        return self._vs(node, "/admin/mark_readonly",
                        {"volume_id": vid, "read_only": readonly})

    def volume_configure_replication(self, vid: int,
                                     replication: str) -> list[dict]:
        """Rewrite replica placement on every copy of the volume
        (reference command_volume_configure_replication.go)."""
        homes, _ = self._volume_locations()
        out = []
        for node in homes.get(vid, []):
            out.append(self._vs(node, "/admin/configure_replication",
                                {"volume_id": vid,
                                 "replication": replication}))
        if not out:
            raise ValueError(f"volume {vid} not found on any server")
        return out

    def volume_delete_empty(self, apply: bool = True,
                            quiet_for: float = 3600.0) -> list[dict]:
        """Delete volumes holding zero live files AND untouched for
        quiet_for seconds (reference command_volume_delete_empty.go
        -quietFor: without the age gate, freshly grown writable volumes
        the master is still assigning into would be destroyed)."""
        import time as _time

        from seaweedfs_tpu_torch.utils.httpd import http_json
        topo = self.topology()
        now = _time.time()
        doomed = []
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for node in rack.get("nodes", []):
                    for v in node.get("volumes", []):
                        # file_count counts LIVE needles (the map drops
                        # deleted ones), so 0 == nothing readable
                        if v.get("file_count", 0) != 0:
                            continue
                        try:
                            st = http_json(
                                "GET", f"http://{node['id']}"
                                       "/admin/volume_file_status"
                                       f"?volumeId={v['id']}")
                        except (ConnectionError, HttpError):
                            continue
                        age = now - st.get(
                            "dat_file_timestamp_seconds", now)
                        if age < quiet_for:
                            continue
                        doomed.append({"vid": v["id"],
                                       "node": node["id"],
                                       "quiet_seconds": int(age)})
        if apply:
            for d in doomed:
                self._vs(d["node"], "/admin/delete_volume",
                         {"volume_id": d["vid"]})
        return doomed

    def volume_tier_move(self, to_node: str = "", to_disk: str = "",
                         full_percent: float = 95.0,
                         quiet_for: float = 0.0, collection: str = "",
                         apply: bool = True) -> list[dict]:
        """Move full + quiet volumes to a cold tier (reference
        command_volume_tier_move.go): the destination is a disk TYPE
        (-toDiskType ssd/hdd — any node with free slots of that type
        qualifies), a node (-toNode), or both. A volume qualifies when
        its content is >= full_percent of the volume size limit, its
        .dat has been untouched for quiet_for seconds, and (for a disk
        destination) it is not already on that tier."""
        import time as _time

        from seaweedfs_tpu_torch.cluster.topology import norm_disk
        from seaweedfs_tpu_torch.utils.httpd import http_json
        if not to_node and not to_disk:
            raise ValueError("need -toNode and/or -toDiskType")
        status = http_json("GET",
                           f"http://{self.master_url}/dir/status")
        topo = status["Topology"]
        limit = status.get("VolumeSizeLimitMB", 1024) * 1024 * 1024
        threshold = limit * full_percent / 100.0
        now = _time.time()
        moved = []
        all_nodes = {}
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for node in rack.get("nodes", []):
                    all_nodes[node["id"]] = node
        if to_node and to_node not in all_nodes:
            raise ValueError(f"unknown volume server {to_node!r} "
                             f"(known: {sorted(all_nodes)})")

        holders: dict[int, set] = {}
        for node in all_nodes.values():
            for v in node.get("volumes", []):
                holders.setdefault(v["id"], set()).add(node["id"])
        planned_onto: dict[str, int] = {}

        def free_of(node: dict, disk: str) -> float:
            # topology serializes tiers NORMALIZED ('' is the hdd tier)
            slots = node.get("disk_slots") or {
                "": node.get("max_volume_count", 0)}
            d = norm_disk(disk)
            used = sum(1 for v in node.get("volumes", [])
                       if norm_disk(v.get("disk_type", "")) == d)
            return (slots.get(d, 0) - used
                    - planned_onto.get((node["id"], d), 0))

        def pick_target(source: str, vid: int) -> str:
            if to_node:
                return to_node if (not to_disk or
                                   free_of(all_nodes[to_node],
                                           to_disk) >= 1) else ""
            # disk-type mode: the SOURCE node's own tier counts too —
            # an hdd->ssd move on one server is an intra-node relocate.
            # Nodes already holding a replica of this vid (other than
            # the source itself) can't receive a copy.
            best, best_free = "", 0.0
            for nid, node in all_nodes.items():
                if nid != source and nid in holders.get(vid, ()):
                    continue
                f = free_of(node, to_disk)
                if f > best_free:
                    best, best_free = nid, f
            return best

        vids_on_target: set = set()
        if to_node:
            vids_on_target = {v["id"] for v in
                              all_nodes[to_node].get("volumes", [])}
        planned_vids: set = set()
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for node in rack.get("nodes", []):
                    if node["id"] == to_node:
                        continue
                    for v in node.get("volumes", []):
                        if collection and \
                                v.get("collection", "") != collection:
                            continue
                        if to_disk and norm_disk(
                                v.get("disk_type", "")) \
                                == norm_disk(to_disk):
                            continue  # already on the target tier
                        if v.get("size", 0) < threshold:
                            continue
                        # one replica per volume moves; a second move
                        # would collapse the replica set onto to_node,
                        # and a vid already on to_node can't land again
                        if v["id"] in planned_vids or \
                                v["id"] in vids_on_target:
                            continue
                        if quiet_for:
                            try:
                                st = http_json(
                                    "GET", f"http://{node['id']}"
                                           "/admin/volume_file_status"
                                           f"?volumeId={v['id']}")
                            except (ConnectionError, HttpError):
                                continue
                            age = now - st.get(
                                "dat_file_timestamp_seconds", now)
                            if age < quiet_for:
                                continue
                        target = pick_target(node["id"], v["id"])
                        if not target:
                            continue  # no tier capacity anywhere
                        planned_vids.add(v["id"])
                        key = (target, norm_disk(to_disk))
                        planned_onto[key] = planned_onto.get(key, 0) + 1
                        moved.append({"vid": v["id"],
                                      "from": node["id"],
                                      "to": target,
                                      "to_disk": to_disk,
                                      "collection": v.get(
                                          "collection", ""),
                                      "size": v.get("size", 0)})
        if apply:
            for m in moved:
                try:
                    if m["to"] == m["from"]:
                        # same server, different tier: relocate in place
                        self._vs(m["from"], "/admin/move_volume_disk",
                                 {"volume_id": m["vid"],
                                  "disk_type": to_disk})
                    else:
                        self.volume_move(m["vid"], m["from"], m["to"],
                                         m["collection"],
                                         disk_type=to_disk)
                except (ConnectionError, HttpError) as e:
                    # one failed move must not abandon the rest
                    m["error"] = str(e)
        return moved

    def volume_server_evacuate(self, node: str,
                               apply: bool = True) -> list[dict]:
        """Move every volume off a node before decommissioning it
        (reference command_volume_server_evacuate.go). EC shards are
        re-balanced separately by ec.balance."""
        topo = self.topology()
        all_nodes = []
        source = None
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for n in rack.get("nodes", []):
                    if n["id"] == node:
                        source = n
                    else:
                        all_nodes.append(n)
        if source is None:
            raise ValueError(f"unknown volume server {node!r}")
        if not all_nodes:
            raise ValueError("no other volume servers to evacuate to")
        moves = []
        targets = sorted(all_nodes,
                         key=lambda n: len(n.get("volumes", [])))
        for v in source.get("volumes", []):
            # skip targets that already hold a replica of this volume
            ok = [t for t in targets
                  if all(x["id"] != v["id"]
                         for x in t.get("volumes", []))]
            if not ok:
                moves.append({"vid": v["id"], "source": node,
                              "target": None, "blocked": True})
                continue
            tgt = ok[0]
            moves.append({"vid": v["id"], "source": node,
                          "target": tgt["id"],
                          "collection": v.get("collection", ""),
                          "disk_type": v.get("disk_type", "")})
            tgt.setdefault("volumes", []).append(v)
            targets.sort(key=lambda n: len(n.get("volumes", [])))
        if apply:
            for mv in moves:
                if mv.get("target"):
                    self.volume_move(mv["vid"], mv["source"],
                                     mv["target"],
                                     mv.get("collection", ""),
                                     disk_type=mv.get("disk_type", ""))
        return moves

    def volume_tail(self, vid: int, since_ns: int = 0,
                    limit: int = 256) -> list[dict]:
        """Stream needles appended after since_ns (reference
        command_volume_tail.go) — rides the VolumeTailSender gRPC."""
        replicas, _ = self._volume_locations()
        nodes = replicas.get(vid)
        if not nodes:
            raise ValueError(f"volume {vid} not found")
        client = self._grpc_client(nodes[0])
        if client is None:
            raise RuntimeError(f"{nodes[0]} has no gRPC plane "
                               "(start volume with -grpc)")
        out = []
        for n in client.volume_tail_needles(vid, since_ns):
            out.append({"needle_id": f"{n.id:x}",
                        "size": len(n.data),
                        "append_at_ns": n.append_at_ns,
                        "deleted": n.size == 0 and not n.data})
            if len(out) >= limit:
                break
        return out

    def volume_server_leave(self, node: str) -> dict:
        """Graceful drain: the server stops heartbeating and the master
        drops it (reference command_volume_server_leave.go)."""
        return self._vs(node, "/admin/leave", {})

    def volume_fsck(self, filer_url: str, fix: bool = False,
                    collection: str = "") -> dict:
        from seaweedfs_tpu_torch.shell.fsck import volume_fsck
        return volume_fsck(self, filer_url, fix=fix,
                           collection=collection or None)

    def cluster_ps(self) -> dict:
        """Every known cluster process (reference command_cluster_ps.go):
        masters from raft status, volume servers from the topology,
        filers/brokers from the registry."""
        from seaweedfs_tpu_torch.utils.httpd import http_json
        status = http_json("GET",
                           f"http://{self.master_url}/cluster/status")
        topo = self.topology()
        volume_servers = []
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for n in rack.get("nodes", []):
                    volume_servers.append({
                        "url": n["id"], "data_center": dc["id"],
                        "rack": rack["id"],
                        "volumes": len(n.get("volumes", [])),
                        "ec_shards": sum(
                            bin(s.get("ec_index_bits", 0)).count("1")
                            for s in n.get("ec_shards", []))})
        others = {}
        for ntype in ("filer", "broker"):
            out = http_json(
                "GET",
                f"http://{self.master_url}/cluster/nodes?type={ntype}")
            others[ntype + "s"] = out.get("cluster_nodes", [])
        return {"masters": [status.get("Leader", "")]
                + list(status.get("Peers", [])),
                "leader": status.get("Leader", ""),
                "volume_servers": volume_servers, **others}

    def volume_balance(self, apply: bool = True) -> list[dict]:
        """Even volume counts across nodes (reference
        command_volume_balance.go, simplified to count balancing)."""
        topo = self.topology()
        nodes = []
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for n in rack.get("nodes", []):
                    nodes.append(n)
        if not nodes:
            return []
        total = sum(len(n.get("volumes", [])) for n in nodes)
        avg = total / len(nodes)
        moves = []
        donors = sorted(nodes, key=lambda n: -len(n.get("volumes", [])))
        receivers = sorted(nodes, key=lambda n: len(n.get("volumes", [])))
        for donor in donors:
            vols = list(donor.get("volumes", []))
            while len(vols) > avg + 0.5:
                target = receivers[0]
                if len(target.get("volumes", [])) >= avg:
                    break
                v = vols.pop()
                moves.append({"vid": v["id"], "source": donor["id"],
                              "target": target["id"],
                              "collection": v.get("collection", ""),
                              "disk_type": v.get("disk_type", "")})
                target.setdefault("volumes", []).append(v)
                receivers.sort(key=lambda n: len(n.get("volumes", [])))
        if apply:
            for mv in moves:
                self.volume_move(mv["vid"], mv["source"], mv["target"],
                                 mv["collection"],
                                 disk_type=mv.get("disk_type", ""))
        return moves

    # ---- ec.encode (reference command_ec_encode.go doEcEncode) ----
    def ec_encode(self, vid: Optional[int] = None, collection: str = "",
                  delete_source: bool = True,
                  pipelined: bool = True, code: str = "") -> list[dict]:
        topo = self.topology()
        vids = [vid] if vid is not None else \
            ec_plan.collect_volume_ids_for_ec_encode(topo, collection)
        results = []
        for v in vids:
            results.append(self._ec_encode_one(topo, v, delete_source,
                                               pipelined, code))
            topo = self.topology()  # refresh between volumes
        return results

    def _ec_encode_one(self, topo: dict, vid: int, delete_source: bool,
                       pipelined: bool = True, code: str = "") -> dict:
        scheme = None
        if code.startswith("lrc"):
            from seaweedfs_tpu_torch.models.coder import LrcScheme
            scheme = LrcScheme()
        plan = ec_plan.plan_ec_encode(topo, vid, scheme=scheme)
        source = plan["source"]
        collection = ""
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for n in rack.get("nodes", []):
                    for v in n.get("volumes", []):
                        if v["id"] == vid:
                            collection = v.get("collection", "")

        # 1. mark every replica readonly
        for replica in plan["replicas"]:
            self._vs(replica, "/admin/mark_readonly",
                     {"volume_id": vid, "read_only": True})
        # 2. generate shards on the source
        # pipelined=False forces the server's serial encoder (benchmark
        # comparator / minimal path); default overlaps I/O with compute
        self._vs(source, "/admin/ec/generate",
                 {"volume_id": vid, "collection": collection,
                  "pipelined": pipelined, "code": code})
        # 3. spread: copy to targets, mount
        by_target: dict[str, list[int]] = defaultdict(list)
        for mv in plan["moves"]:
            by_target[mv.target].append(mv.shard_id)
        for target, sids in by_target.items():
            if target != source:
                self._vs(target, "/admin/ec/copy",
                         {"volume_id": vid, "collection": collection,
                          "shard_ids": sids, "source_data_node": source})
            self._vs(target, "/admin/ec/mount",
                     {"volume_id": vid, "collection": collection,
                      "shard_ids": sids})
        # 4. delete the shard files that moved away from the source
        moved = [sid for t, sids in by_target.items() if t != source
                 for sid in sids]
        if moved:
            self._vs(source, "/admin/ec/unmount",
                     {"volume_id": vid, "shard_ids": moved})
            self._vs(source, "/admin/ec/delete_shards",
                     {"volume_id": vid, "collection": collection,
                      "shard_ids": moved})
        # 5. delete the original volume replicas
        if delete_source:
            for replica in plan["replicas"]:
                self._vs(replica, "/admin/delete_volume",
                         {"volume_id": vid})
        return {"vid": vid, "source": source,
                "code": code or "rs",
                "rack_aligned": plan.get("rack_aligned", False),
                "placement": {t: sorted(s) for t, s in by_target.items()}}

    # ---- ec.rebuild (reference command_ec_rebuild.go) ----
    def ec_rebuild(self, apply: bool = True,
                   pipelined: bool = True) -> list[dict]:
        topo = self.topology()
        plans = ec_plan.plan_ec_rebuild(topo)
        if not apply:
            return plans
        collections = self._ec_collections(topo)
        for plan in plans:
            if "error" in plan:
                continue
            rebuilder = plan["rebuilder"]
            col = collections.get(plan["vid"], "")
            by_source: dict[str, list[int]] = defaultdict(list)
            for mv in plan["copies"]:
                by_source[mv.source].append(mv.shard_id)
            for source, sids in by_source.items():
                self._vs(rebuilder, "/admin/ec/copy",
                         {"volume_id": plan["vid"], "collection": col,
                          "shard_ids": sids,
                          "source_data_node": source, "copy_ecx_file": True})
            out = self._vs(rebuilder, "/admin/ec/rebuild",
                           {"volume_id": plan["vid"], "collection": col,
                            "pipelined": pipelined})
            plan["rebuilt"] = out.get("rebuilt_shard_ids", [])
            self._vs(rebuilder, "/admin/ec/mount",
                     {"volume_id": plan["vid"], "collection": col,
                      "shard_ids": plan["rebuilt"]})
        return plans

    # ---- integrity scrub & repair ----
    def volume_scrub(self, node: str = "",
                     volume_id: Optional[int] = None) -> list[dict]:
        """Trigger a synchronous scrub pass on one node (or every node)
        and collect the per-node results. Corruption found here flows to
        the master's repair queue exactly as a background pass would."""
        if node:
            targets = [node]
        else:
            topo = self.topology()
            targets = [n["id"]
                       for dc in topo.get("data_centers", [])
                       for rack in dc.get("racks", [])
                       for n in rack.get("nodes", [])]
        body: dict = {}
        if volume_id is not None:
            body["volume_id"] = int(volume_id)
        out = []
        for nd in targets:
            try:
                res = self._vs(nd, "/admin/scrub", body, timeout=3600)
            except Exception as e:
                res = {"error": str(e)}
            out.append({"node": nd, **res})
        return out

    def ec_scheme_status(self, vid: Optional[int] = None) -> dict:
        """Per-EC-volume code-family report: the CodeSpec each holder
        persisted in its .vif, shard spread, LRC group rack alignment,
        the last repair strategy the rebuilder executed, and the
        master planner's strategy tallies."""
        topo = self.topology()
        owners: dict[int, dict[int, list[str]]] = defaultdict(
            lambda: defaultdict(list))
        rack_of: dict[str, str] = {}
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for n in rack.get("nodes", []):
                    rack_of[n["id"]] = \
                        f"{dc.get('id', '')}/{rack.get('id', '')}"
                    for e in n.get("ec_shards", []):
                        bits = e["ec_index_bits"]
                        for sid in range(layout.TOTAL_SHARDS_COUNT):
                            if bits & (1 << sid):
                                owners[e["id"]][sid].append(n["id"])
        try:
            repair = self.ec_repair_status()
        except Exception:
            repair = {}
        volumes = []
        collections = self._ec_collections(topo)
        for v, shard_map in sorted(owners.items()):
            if vid is not None and v != vid:
                continue
            holder = next(iter(sorted(shard_map.values())))[0]
            try:
                stat = http_json(
                    "GET",
                    f"http://{holder}/admin/ec/shard_stat?volumeId={v}"
                    f"&collection={collections.get(v, '')}")
            except Exception as e:
                stat = {"error": str(e)}
            code = stat.get("code") or {}
            entry = {"vid": v, "code": code,
                     "shards_present": sorted(shard_map),
                     "last_repair": stat.get("last_repair"),
                     "recover_stats": stat.get("recover_stats")}
            if code.get("family") == "lrc":
                from seaweedfs_tpu_torch.models.coder import scheme_from_dict
                scheme = scheme_from_dict(code)
                groups = {}
                for g in range(scheme.local_groups):
                    racks = sorted(
                        {rack_of.get(u, "")
                         for sid in scheme.group_members(g)
                         for u in shard_map.get(sid, [])} - {""})
                    groups[g] = {"racks": racks,
                                 "aligned": len(racks) <= 1}
                entry["groups"] = groups
            volumes.append(entry)
        return {"volumes": volumes,
                "planner": {
                    "last_strategy": repair.get("last_strategy", ""),
                    "strategy_counts": repair.get("strategy_counts", {}),
                    "partial_repairs": repair.get("partial_repairs", 0)}}

    def ec_repair_status(self) -> dict:
        return http_json(
            "GET", f"http://{self.master_url}/ec/repair/status")

    def ec_repair_kick(self) -> dict:
        return http_json(
            "POST", f"http://{self.master_url}/ec/repair/kick", {})

    def cluster_health(self) -> dict:
        """Resilience view of the cluster: master's per-peer breaker
        snapshot + repair budget, enriched with each volume server's own
        /admin/health (its breakers toward its peers and scrub state).
        A node that can't answer is reported, not fatal — this command
        exists precisely for partially-broken clusters."""
        out = http_json("GET",
                        f"http://{self.master_url}/cluster/health")
        for node in out.get("nodes", []):
            try:
                node["health"] = http_json(
                    "GET", f"http://{node['url']}/admin/health")
            except Exception as e:
                node["health"] = {"error": type(e).__name__}
        return out

    def cluster_leases(self) -> dict:
        """Assign-lease view: the master's grant table (holder, range,
        epoch, remaining keys/seconds) + grant/renew/expire counters,
        enriched with each holder's own mint/refuse stats from /status.
        Served by followers too — the table is Raft-replicated — so it
        keeps answering through a leader outage, which is exactly when
        an operator wants it. An unreachable holder is reported, not
        fatal."""
        out = http_json("GET",
                        f"http://{self.master_url}/cluster/leases")
        holders: dict[str, dict] = {}
        for lease in out.get("leases", []):
            url = lease.get("holder", "")
            if not url or url in holders:
                continue
            try:
                status = http_json("GET", f"http://{url}/status")
                holders[url] = status.get("Leases",
                                          {"error": "no lease stats"})
            except Exception as e:
                holders[url] = {"error": type(e).__name__}
        out["holders"] = holders
        return out

    def cluster_shards(self) -> dict:
        """Namespace-sharding view: the master's filer ring (members +
        epoch) enriched with each filer's /__api/shard/status — routing
        outcome counters (local/redirect/forward/forced_local), entry
        cache + negative-lookup hit rates, autocap state — plus the
        rebalancer's placement view: the override table, spread() of
        the overridden directories across members, and the planner's
        windowed per-shard rates with the resulting max/mean imbalance.
        Unreachable filers (and a master without the rebalance
        endpoint) are reported, not fatal."""
        try:
            ring = http_json("GET",
                             f"http://{self.master_url}/cluster/filers")
        except Exception as e:
            ring = {"error": type(e).__name__}
        shards = []
        for url in ring.get("filers", []):
            try:
                shards.append(http_json(
                    "GET", f"http://{url}/__api/shard/status"))
            except Exception as e:
                shards.append({"url": url, "error": type(e).__name__})
        out = {"ring": ring, "shards": shards}
        try:
            reb = http_json(
                "GET", f"http://{self.master_url}/cluster/rebalance")
        except Exception as e:
            reb = {"error": type(e).__name__}
        out["rebalance"] = reb
        if ring.get("filers"):
            from seaweedfs_tpu_torch.filer.shard_ring import ShardRing

            r = ShardRing.from_dict(ring)
            rates = {u: v for u, v in
                     ((reb.get("planner") or {}).get("rates")
                      or {}).items() if v is not None}
            mean = (sum(rates.values()) / len(rates)) if rates else 0.0
            out["placement"] = {
                "overrides": dict(r.overrides),
                # where the moved directories landed, per member — the
                # "did the hot set actually spread" answer
                "override_spread": r.spread(list(r.overrides)),
                "rates": rates,
                "imbalance": round(max(rates.values()) / mean, 3)
                if mean > 0 else None,
            }
        return out

    def cluster_qos(self, configure: Optional[dict] = None,
                    node: str = "") -> dict:
        """QoS view of the cluster: the master's per-node pressure
        rollup + repair-budget backoff, enriched with each volume
        server's /admin/qos snapshot (limit, per-class inflight/shed,
        tenant buckets). With `configure`, POSTs those settings to
        every node's /admin/qos (or just `node`) and reports the
        post-change snapshots. Unreachable nodes are reported, not
        fatal — same contract as cluster.health."""
        out = http_json("GET", f"http://{self.master_url}/cluster/qos")
        nodes = out.get("nodes", [])
        if node:
            nodes = [n for n in nodes if n["url"] == node] \
                or [{"url": node}]
            out["nodes"] = nodes
        for nd in nodes:
            try:
                if configure:
                    nd["qos"] = http_json(
                        "POST", f"http://{nd['url']}/admin/qos",
                        configure)
                else:
                    nd["qos"] = http_json(
                        "GET", f"http://{nd['url']}/admin/qos")
            except Exception as e:
                nd["qos"] = {"error": type(e).__name__}
        return out

    def cluster_trace(self, trace_id: str = "", min_ms: float = 0.0,
                      limit: int = 64) -> dict:
        """Trace view of the cluster: pull the master's and every
        volume server's /debug/traces flight recorder and group the
        spans by trace id, slowest trace first — the cross-node answer
        to "which request was slow, and where did the time go". With
        `trace_id`, returns just that trace's spans (sorted by start)
        for stitching. Filers and S3 gateways expose the same endpoint
        on their metrics port, which the master's topology doesn't
        know, so they are not included here. Unreachable nodes are reported, not fatal — same contract as
        cluster.health."""
        qs = f"?trace={trace_id}&min_ms={min_ms}&limit={limit}"
        targets = [self.master_url]
        try:
            out = http_json("GET",
                            f"http://{self.master_url}/cluster/qos")
            targets += [n["url"] for n in out.get("nodes", [])
                        if n.get("url") and n["url"] not in targets]
        except Exception:
            pass
        spans: list[dict] = []
        unreachable = []
        for url in targets:
            try:
                snap = http_json(
                    "GET", f"http://{url}/debug/traces{qs}")
            except Exception as e:
                unreachable.append({"node": url,
                                    "error": type(e).__name__})
                continue
            spans.extend(snap.get("spans", []))
        if trace_id:
            spans.sort(key=lambda s: s["start"])
            return {"trace_id": trace_id, "spans": spans,
                    "unreachable": unreachable}
        by_trace: dict[str, list[dict]] = defaultdict(list)
        for s in spans:
            by_trace[s["trace_id"]].append(s)
        traces = []
        for tid, group in by_trace.items():
            roots = [s for s in group if not s.get("parent_id")]
            root = roots[0] if roots else \
                max(group, key=lambda s: s["duration_ms"])
            t0 = min(s["start"] for s in group)
            t1 = max(s["start"] + s["duration_ms"] / 1000.0
                     for s in group)
            traces.append({
                "trace_id": tid, "root": root["name"],
                "duration_ms": round((t1 - t0) * 1000.0, 3),
                "spans": len(group),
                "nodes": sorted({s["node"] for s in group}),
                "errors": sum(1 for s in group
                              if s.get("error") or s["status"] >= 500),
            })
        traces.sort(key=lambda t: -t["duration_ms"])
        return {"traces": traces, "unreachable": unreachable}

    def cluster_profile(self, seconds: float = 5.0,
                        top_k: int = 20) -> dict:
        """Cluster CPU-profile view: pull a `seconds`-long wall-stack
        window from the master's and every volume server's always-on
        sampler (/admin/profile) and merge the folded tables — "where
        is the cluster spending its wall time, by QoS class and route,
        right now". Returns the top stacks by sample count plus the
        per-class share split. Filers and S3 gateways serve the
        endpoint on their metrics port, which the master's topology
        doesn't know, so they are not included here."""
        from seaweedfs_tpu_torch.utils import profiler
        targets = [self.master_url]
        try:
            out = http_json("GET",
                            f"http://{self.master_url}/cluster/qos")
            targets += [n["url"] for n in out.get("nodes", [])
                        if n.get("url") and n["url"] not in targets]
        except Exception:
            pass
        tables = []
        nodes = []
        unreachable = []
        for url in targets:
            try:
                snap = http_json(
                    "GET",
                    f"http://{url}/admin/profile?seconds={seconds:g}",
                    timeout=seconds + 10.0)
            except Exception as e:
                unreachable.append({"node": url,
                                    "error": type(e).__name__})
                continue
            tables.append(snap.get("folded", {}))
            nodes.append({"node": snap.get("node", url),
                          "server": snap.get("server", "?"),
                          "samples": snap.get("samples", 0)})
        merged = profiler.merge_folded(tables)
        total = sum(merged.values())
        by_class: dict[str, int] = defaultdict(int)
        for stack, n in merged.items():
            head = stack.split(";", 1)[0]
            key = head.split(":", 1)[1] if head.startswith("class:") \
                else "(untagged)"
            by_class[key] += n
        top = sorted(merged.items(), key=lambda kv: -kv[1])[:top_k]
        return {
            "seconds": seconds, "samples": total, "nodes": nodes,
            "per_class": {c: {"samples": n,
                              "share": round(n / total, 4) if total
                              else 0.0}
                          for c, n in sorted(by_class.items(),
                                             key=lambda kv: -kv[1])},
            "top_stacks": [{"stack": s, "samples": n} for s, n in top],
            "unreachable": unreachable,
        }

    def cluster_telemetry(self, top_k: int = 10,
                          peers: bool = True) -> dict:
        """Cluster RED/SLO view: the master's merged telemetry rollup —
        per-class rate/errors/p50/p99 with trace exemplars, the
        cluster-wide hot-key leaderboard, and per-class SLO burn-rate
        alert state. Volume snapshots ride heartbeats; filer/S3
        snapshots are pulled from their registered metrics listeners
        (peers=False skips those pulls for a heartbeat-only view)."""
        qs = f"?k={top_k}" + ("" if peers else "&peers=false")
        return http_json(
            "GET", f"http://{self.master_url}/cluster/telemetry{qs}")

    # ---- ec.balance (reference command_ec_balance.go) ----
    def ec_balance(self, apply: bool = True) -> list[ec_plan.ShardMove]:
        topo = self.topology()
        moves = ec_plan.plan_ec_balance(topo)
        if not apply:
            return moves
        collections = self._ec_collections(topo)
        for mv in moves:
            one = {"volume_id": mv.vid,
                   "collection": collections.get(mv.vid, ""),
                   "shard_ids": [mv.shard_id]}
            if mv.target == "":  # duplicate copy: drop it
                self._vs(mv.source, "/admin/ec/unmount", one)
                self._vs(mv.source, "/admin/ec/delete_shards", one)
                continue
            self._vs(mv.target, "/admin/ec/copy",
                     {**one, "source_data_node": mv.source,
                      "copy_ecx_file": True})
            self._vs(mv.target, "/admin/ec/mount", one)
            self._vs(mv.source, "/admin/ec/unmount", one)
            self._vs(mv.source, "/admin/ec/delete_shards", one)
        return moves

    # ---- ec.decode (reference command_ec_decode.go) ----
    def ec_decode(self, vid: int, pipelined: bool = True) -> dict:
        topo = self.topology()
        plan = ec_plan.plan_ec_decode(topo, vid)
        collector = plan["collector"]
        col = self._ec_collections(topo).get(vid, "")
        by_source: dict[str, list[int]] = defaultdict(list)
        for mv in plan["copies"]:
            by_source[mv.source].append(mv.shard_id)
        for source, sids in by_source.items():
            self._vs(collector, "/admin/ec/copy",
                     {"volume_id": vid, "collection": col,
                      "shard_ids": sids,
                      "source_data_node": source, "copy_ecx_file": True})
            self._vs(collector, "/admin/ec/mount",
                     {"volume_id": vid, "collection": col,
                      "shard_ids": sids})
        out = self._vs(collector, "/admin/ec/to_volume",
                       {"volume_id": vid, "collection": col,
                        "pipelined": pipelined})
        # clean up shards everywhere else
        for sid, owner_list in plan["all_owners"].items():
            for owner in owner_list:
                if owner == collector:
                    continue
                try:
                    self._vs(owner, "/admin/ec/unmount",
                             {"volume_id": vid, "shard_ids": [sid]})
                    self._vs(owner, "/admin/ec/delete_shards",
                             {"volume_id": vid, "collection": col,
                              "shard_ids": [sid]})
                except (ConnectionError, HttpError):
                    pass
        return {"vid": vid, "collector": collector,
                "dat_size": out.get("dat_size")}
