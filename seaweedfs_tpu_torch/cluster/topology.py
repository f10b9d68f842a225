"""Cluster topology tree: Topology -> DataCenter -> Rack -> DataNode.

Functional equivalent of reference weed/topology (topology.go, node.go,
data_center.go, rack.go, data_node.go, topology_ec.go): slot counting,
volume location registry, per-(collection, rp, ttl) volume layouts, and the
EC shard map. All pure in-memory logic — the master server wires heartbeats
into it; planners (shell) run against its read API.

The port's copy of seaweedfs_tpu/cluster/topology.py, the same code but for
two things the reference's topology has and seaweedfs_tpu's lacks:
``lookup`` falls back to an EC volume's shard holders, and a node keeps
the collection its heartbeats name for each EC volume (``to_info`` shows
a named one, ``ec_collection`` answers it), so the shell and the repair
queue can address the volume's ``<collection>_<vid>.*`` files. It imports
nothing of that package.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.storage.erasure_coding import layout as ec_layout
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement, TTL


def norm_disk(disk: str) -> str:
    """'' and 'hdd' are the same default tier (reference types.DiskType:
    the empty disk type IS hdd)."""
    return "" if disk in ("", "hdd") else disk


class DataNode:
    def __init__(self, ip: str, port: int, public_url: str = "",
                 max_volume_count: int = 8):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.max_volume_count = max_volume_count
        # slots per disk type (reference DiskInfo map); default: all
        # slots on the hdd tier
        self.disk_slots: dict[str, int] = {"": max_volume_count}
        self.volumes: dict[int, dict] = {}
        self.ec_shards: dict[int, int] = {}  # vid -> shard bits
        # vid -> collection, for EC volumes of a named collection
        self.ec_collections: dict[int, str] = {}
        self.rack: Optional["Rack"] = None
        self.last_seen = clockctl.now()
        # mid-scrub-pass right now (rides heartbeats): repair dispatch
        # avoids piling rebuild I/O onto a disk being swept
        self.scrubbing = False
        # local QoS overload pressure [0,1] (rides heartbeats): the
        # repair scheduler backs its bandwidth budget off when serving
        # nodes are shedding interactive load
        self.qos_pressure = 0.0
        # graceful-drain announcement (rides heartbeats): a draining
        # node takes no new assignments or volume growth, and its
        # departure must not trigger rebuilds (repair drain grace)
        self.draining = False
        # last telemetry snapshot (RED histogram + hot-key sketches,
        # rides heartbeats next to qos_pressure); merged cluster-wide
        # by the master's ClusterTelemetry
        self.telemetry: Optional[dict] = None

    @property
    def id(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def ec_shard_count(self) -> int:
        return sum(bin(bits).count("1") for bits in self.ec_shards.values())

    def free_space(self, disk: Optional[str] = None) -> float:
        """Free volume slots; EC shards consume fractional slots
        (reference counts 1 slot per TotalShardsCount shards).
        disk=None: all tiers; otherwise that tier only (EC shards
        count against the default tier)."""
        if disk is None:
            used = len(self.volumes) + \
                self.ec_shard_count() / ec_layout.TOTAL_SHARDS_COUNT
            return self.max_volume_count - used
        d = norm_disk(disk)
        used = sum(1 for v in self.volumes.values()
                   if norm_disk(v.get("disk_type", "")) == d)
        if d == "":
            used += self.ec_shard_count() / ec_layout.TOTAL_SHARDS_COUNT
        return self.disk_slots.get(d, 0) - used

    def to_info(self) -> dict:
        return {
            "id": self.id, "ip": self.ip, "port": self.port,
            "public_url": self.public_url,
            "grpc_port": getattr(self, "grpc_port", 0),
            "max_volume_count": self.max_volume_count,
            "disk_slots": dict(self.disk_slots),
            "volumes": list(self.volumes.values()),
            "ec_shards": [
                {"id": vid, "ec_index_bits": bits,
                 **({"collection": self.ec_collections[vid]}
                    if vid in self.ec_collections else {})}
                for vid, bits in self.ec_shards.items()],
            "rack": self.rack.id if self.rack else "",
            "data_center": self.rack.data_center.id
            if self.rack and self.rack.data_center else "",
        }


class Rack:
    def __init__(self, rack_id: str):
        self.id = rack_id
        self.nodes: dict[str, DataNode] = {}
        self.data_center: Optional["DataCenter"] = None

    def get_or_create_node(self, ip: str, port: int, public_url: str = "",
                           max_volume_count: int = 8) -> DataNode:
        key = f"{ip}:{port}"
        n = self.nodes.get(key)
        if n is None:
            n = DataNode(ip, port, public_url, max_volume_count)
            n.rack = self
            self.nodes[key] = n
        return n

    def free_space(self, disk: Optional[str] = None) -> float:
        return sum(n.free_space(disk) for n in self.nodes.values())


class DataCenter:
    def __init__(self, dc_id: str):
        self.id = dc_id
        self.racks: dict[str, Rack] = {}

    def get_or_create_rack(self, rack_id: str) -> Rack:
        r = self.racks.get(rack_id)
        if r is None:
            r = Rack(rack_id)
            r.data_center = self
            self.racks[rack_id] = r
        return r

    def free_space(self, disk: Optional[str] = None) -> float:
        return sum(r.free_space(disk) for r in self.racks.values())


class VolumeLayout:
    """Writable-volume bookkeeping per (collection, rp, ttl)
    (reference weed/topology/volume_layout.go)."""

    def __init__(self, rp: ReplicaPlacement, ttl: TTL,
                 volume_size_limit: int):
        self.rp = rp
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.locations: dict[int, list[DataNode]] = {}
        self.writable: set[int] = set()
        self.readonly: set[int] = set()

    def register_volume(self, vinfo: dict, node: DataNode) -> None:
        vid = vinfo["id"]
        locs = self.locations.setdefault(vid, [])
        if node not in locs:
            locs.append(node)
        enough_copies = len(locs) >= self.rp.copy_count
        if vinfo.get("read_only"):
            self.readonly.add(vid)
            self.writable.discard(vid)
        elif vinfo.get("size", 0) >= self.volume_size_limit:
            self.writable.discard(vid)
        elif enough_copies and vid not in self.readonly:
            self.writable.add(vid)

    def unregister_volume(self, vid: int, node: DataNode) -> None:
        locs = self.locations.get(vid)
        if not locs:
            return
        if node in locs:
            locs.remove(node)
        if len(locs) < self.rp.copy_count:
            self.writable.discard(vid)
        if not locs:
            self.locations.pop(vid, None)
            self.readonly.discard(vid)

    def pick_for_write(self) -> tuple[int, list[DataNode]]:
        if not self.writable:
            raise LookupError("no writable volumes")
        # a write lands on EVERY replica, so a volume with any draining
        # holder is not assignable (the drained node 503s new work);
        # when every writable volume touches a draining node, fall back
        # to the full set — a maybe-slow write beats no write at all
        fresh = [vid for vid in sorted(self.writable)
                 if not any(n.draining for n in self.locations.get(vid, []))]
        vid = random.choice(fresh or sorted(self.writable))
        return vid, self.locations[vid]

    def set_volume_unavailable(self, vid: int) -> None:
        self.writable.discard(vid)

    def active_volume_count(self) -> int:
        return len(self.writable)

    def clean_volume_count(self) -> int:
        """Writable volumes with no draining holder — the set
        pick_for_write prefers. Zero while volumes exist means every
        assignment would land on a node that is shutting down, which
        the master treats as a grow trigger."""
        return sum(1 for vid in self.writable
                   if not any(n.draining
                              for n in self.locations.get(vid, [])))


class Topology:
    def __init__(self, volume_size_limit: int = 30 * 1024 ** 3,
                 pulse_seconds: float = 5.0):
        self.data_centers: dict[str, DataCenter] = {}
        self.layouts: dict[tuple[str, str, str], VolumeLayout] = {}
        self.ec_shard_map: dict[int, list[list[DataNode]]] = {}
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self.max_volume_id = 0
        self.lock = threading.RLock()
        # VolumeLocation delta subscribers (reference
        # master_grpc_server.go broadcastToClients for KeepConnected)
        self.listeners: list = []

    def _notify(self, node: "DataNode", new_vids=(), deleted_vids=(),
                new_ec_vids=(), deleted_ec_vids=()) -> None:
        if not (new_vids or deleted_vids or new_ec_vids or deleted_ec_vids):
            return
        ev = {"url": node.url, "public_url": node.public_url,
              "new_vids": sorted(new_vids),
              "deleted_vids": sorted(deleted_vids),
              "new_ec_vids": sorted(new_ec_vids),
              "deleted_ec_vids": sorted(deleted_ec_vids)}
        for fn in list(self.listeners):
            try:
                fn(ev)
            except Exception:
                pass

    # ---- tree ----
    def get_or_create_data_center(self, dc_id: str) -> DataCenter:
        dc = self.data_centers.get(dc_id)
        if dc is None:
            dc = DataCenter(dc_id)
            self.data_centers[dc_id] = dc
        return dc

    def all_nodes(self) -> list[DataNode]:
        out = []
        for dc in self.data_centers.values():
            for rack in dc.racks.values():
                out.extend(rack.nodes.values())
        return out

    def find_node(self, node_id: str) -> Optional[DataNode]:
        for n in self.all_nodes():
            if n.id == node_id:
                return n
        return None

    # ---- layouts ----
    def get_layout(self, collection: str, rp: str, ttl: str,
                   disk: str = "") -> VolumeLayout:
        key = (collection, rp, ttl, norm_disk(disk))
        lo = self.layouts.get(key)
        if lo is None:
            lo = VolumeLayout(ReplicaPlacement.parse(rp), TTL.parse(ttl),
                              self.volume_size_limit)
            self.layouts[key] = lo
        return lo

    # ---- heartbeat intake ----
    def sync_data_node_registration(self, hb: dict, dc: str = "",
                                    rack: str = "") -> DataNode:
        """Full heartbeat: (re)register the node and its volumes/EC shards
        (reference master_grpc_server.go:61-234 + topology_ec.go:16)."""
        with self.lock:
            dcn = self.get_or_create_data_center(
                dc or hb.get("data_center") or "DefaultDataCenter")
            rk = dcn.get_or_create_rack(
                rack or hb.get("rack") or "DefaultRack")
            node = rk.get_or_create_node(
                hb["ip"], hb["port"], hb.get("public_url", ""),
                hb.get("max_volume_count", 8))
            node.last_seen = clockctl.now()
            node.scrubbing = bool(hb.get("scrubbing", False))
            node.qos_pressure = float(hb.get("qos_pressure", 0.0))
            node.draining = bool(hb.get("draining", False))
            if hb.get("telemetry"):
                node.telemetry = hb["telemetry"]
            node.grpc_port = hb.get("grpc_port", 0)
            node.max_volume_count = hb.get("max_volume_count",
                                           node.max_volume_count)
            node.disk_slots = {
                norm_disk(d): c
                for d, c in (hb.get("disk_slots")
                             or {"": node.max_volume_count}).items()}
            prev_vids = set(node.volumes)
            prev_ec_vids = set(node.ec_shards)

            # volumes: full sync (replace set)
            new_vols = {v["id"]: v for v in hb.get("volumes", [])}
            for vid in list(node.volumes):
                if vid not in new_vols:
                    self._unregister_volume(node.volumes[vid], node)
                    del node.volumes[vid]
            for vid, v in new_vols.items():
                node.volumes[vid] = v
                self._register_volume(v, node)
                self.max_volume_id = max(self.max_volume_id, vid)

            # EC shards: full sync
            new_ec = {e["id"]: e["ec_index_bits"]
                      for e in hb.get("ec_shards", [])}
            node.ec_collections = {e["id"]: e["collection"]
                                   for e in hb.get("ec_shards", [])
                                   if e.get("collection")}
            for vid in list(node.ec_shards):
                if vid not in new_ec:
                    self._unregister_ec_shards(vid, node, node.ec_shards[vid])
                    del node.ec_shards[vid]
            for vid, bits in new_ec.items():
                old = node.ec_shards.get(vid, 0)
                node.ec_shards[vid] = bits
                self._register_ec_shards(vid, node, bits, old)
                self.max_volume_id = max(self.max_volume_id, vid)
            self._notify(
                node,
                new_vids=set(new_vols) - prev_vids,
                deleted_vids=prev_vids - set(new_vols),
                new_ec_vids=set(new_ec) - prev_ec_vids,
                deleted_ec_vids=prev_ec_vids - set(new_ec))
            return node

    def incremental_sync(self, node: DataNode, deltas: dict) -> None:
        with self.lock:
            node.last_seen = clockctl.now()
            if "scrubbing" in deltas:
                node.scrubbing = bool(deltas["scrubbing"])
            if "qos_pressure" in deltas:
                node.qos_pressure = float(deltas["qos_pressure"])
            if "draining" in deltas:
                node.draining = bool(deltas["draining"])
            if deltas.get("telemetry"):
                node.telemetry = deltas["telemetry"]
            new_vids, deleted_vids = set(), set()
            new_ec_vids, deleted_ec_vids = set(), set()
            # deletes BEFORE adds: a disk-tier move reports the same
            # vid in both lists (old tier deleted, new tier added) and
            # must net out to "present on the new tier", not "gone"
            for v in deltas.get("deleted_volumes", []):
                node.volumes.pop(v["id"], None)
                self._unregister_volume(v, node)
                deleted_vids.add(v["id"])
            for v in deltas.get("new_volumes", []):
                node.volumes[v["id"]] = v
                self._register_volume(v, node)
                self.max_volume_id = max(self.max_volume_id, v["id"])
                new_vids.add(v["id"])
                deleted_vids.discard(v["id"])
            for e in deltas.get("new_ec_shards", []):
                vid, bits = e["id"], e["ec_index_bits"]
                old = node.ec_shards.get(vid, 0)
                node.ec_shards[vid] = old | bits
                if e.get("collection"):
                    node.ec_collections[vid] = e["collection"]
                self._register_ec_shards(vid, node, bits, 0)
                new_ec_vids.add(vid)
            for e in deltas.get("deleted_ec_shards", []):
                vid, bits = e["id"], e["ec_index_bits"]
                old = node.ec_shards.get(vid, 0)
                remaining = old & ~bits
                if remaining:
                    node.ec_shards[vid] = remaining
                else:
                    node.ec_shards.pop(vid, None)
                    node.ec_collections.pop(vid, None)
                    deleted_ec_vids.add(vid)
                self._unregister_ec_shards(vid, node, bits)
            self._notify(node, new_vids=new_vids, deleted_vids=deleted_vids,
                         new_ec_vids=new_ec_vids,
                         deleted_ec_vids=deleted_ec_vids)

    def unregister_data_node(self, node: DataNode) -> None:
        """Stream dropped: remove everything the node served
        (reference master_grpc_server.go:63-91)."""
        with self.lock:
            for v in node.volumes.values():
                self._unregister_volume(v, node)
            for vid, bits in node.ec_shards.items():
                self._unregister_ec_shards(vid, node, bits)
            self._notify(node, deleted_vids=set(node.volumes),
                         deleted_ec_vids=set(node.ec_shards))
            node.volumes.clear()
            node.ec_shards.clear()
            node.ec_collections.clear()
            if node.rack:
                node.rack.nodes.pop(node.id, None)

    # ---- volume registry ----
    def _register_volume(self, v: dict, node: DataNode) -> None:
        rp = ReplicaPlacement.from_byte(v.get("replica_placement", 0))
        ttl = TTL.from_bytes(
            v.get("ttl", 0).to_bytes(2, "big")) if v.get("ttl") else TTL()
        lo = self.get_layout(v.get("collection", ""), str(rp), str(ttl),
                             v.get("disk_type", ""))
        lo.register_volume(v, node)

    def _unregister_volume(self, v: dict, node: DataNode) -> None:
        rp = ReplicaPlacement.from_byte(v.get("replica_placement", 0))
        ttl = TTL.from_bytes(
            v.get("ttl", 0).to_bytes(2, "big")) if v.get("ttl") else TTL()
        lo = self.get_layout(v.get("collection", ""), str(rp), str(ttl),
                             v.get("disk_type", ""))
        lo.unregister_volume(v["id"], node)

    # ---- EC registry ----
    def _register_ec_shards(self, vid: int, node: DataNode, bits: int,
                            old_bits: int = 0) -> None:
        shards = self.ec_shard_map.setdefault(
            vid, [[] for _ in range(ec_layout.TOTAL_SHARDS_COUNT)])
        for sid in range(ec_layout.TOTAL_SHARDS_COUNT):
            if bits & (1 << sid) and node not in shards[sid]:
                shards[sid].append(node)

    def _unregister_ec_shards(self, vid: int, node: DataNode,
                              bits: int) -> None:
        shards = self.ec_shard_map.get(vid)
        if not shards:
            return
        for sid in range(ec_layout.TOTAL_SHARDS_COUNT):
            if bits & (1 << sid) and node in shards[sid]:
                shards[sid].remove(node)
        if all(not s for s in shards):
            self.ec_shard_map.pop(vid, None)

    # ---- lookup ----
    def lookup(self, collection: str, vid: int) -> list[DataNode]:
        for (col, _, _, _), lo in self.layouts.items():
            if collection and col != collection:
                continue
            locs = lo.locations.get(vid)
            if locs:
                return list(locs)
        # an EC volume is served by every node holding one of its shards
        # (reference topology.go Lookup falls back to LookupEcShards), so
        # a client or filer holding a fid of an encoded volume still
        # finds it; seaweedfs_tpu's Topology.lookup has no such fallback
        holders: dict[str, DataNode] = {}
        for nodes in self.ec_shard_map.get(vid) or []:
            for n in nodes:
                holders.setdefault(n.url, n)
        return list(holders.values())

    def lookup_ec_shards(self, vid: int) -> Optional[list[list[DataNode]]]:
        return self.ec_shard_map.get(vid)

    def ec_collection(self, vid: int) -> str:
        """The collection EC volume `vid`'s holders report ("" for the
        default collection or an unknown volume)."""
        for nodes in self.ec_shard_map.get(vid) or []:
            for n in nodes:
                if vid in n.ec_collections:
                    return n.ec_collections[vid]
        return ""

    def nodes_by_rack(self) -> dict[str, list[DataNode]]:
        """{'dc/rack': [nodes]} — the failure-domain view that
        group-aligned EC placement plans against."""
        out: dict[str, list[DataNode]] = {}
        for dc in self.data_centers.values():
            for rack in dc.racks.values():
                out[f"{dc.id}/{rack.id}"] = list(rack.nodes.values())
        return out

    def ec_group_alignment(self, vid: int, scheme) -> dict:
        """Per-local-group rack footprint of an EC volume:
        {group: sorted racks holding any member shard}. A group whose
        footprint is ONE rack repairs single-shard losses without
        crossing rack boundaries."""
        owners = self.lookup_ec_shards(vid)
        if owners is None:
            return {}
        rack_of: dict[str, str] = {}
        for rk, nodes in self.nodes_by_rack().items():
            for n in nodes:
                rack_of[n.id] = rk
        out: dict[int, list[str]] = {}
        for g in range(getattr(scheme, "local_groups", 0)):
            racks = {rack_of.get(n.id, "") for sid in
                     scheme.group_members(g) if sid < len(owners)
                     for n in owners[sid]}
            out[g] = sorted(r for r in racks if r)
        return out

    def next_volume_id(self) -> int:
        with self.lock:
            self.max_volume_id += 1
            return self.max_volume_id

    def prune_dead_nodes(self, timeout: Optional[float] = None) -> list[DataNode]:
        timeout = timeout or self.pulse_seconds * 5
        dead = [n for n in self.all_nodes()
                if clockctl.now() - n.last_seen > timeout]
        for n in dead:
            self.unregister_data_node(n)
        return dead

    def to_info(self) -> dict:
        """Serializable topology dump (the shell planners' input, like
        master_pb.TopologyInfo)."""
        with self.lock:
            return {
                "max_volume_id": self.max_volume_id,
                "data_centers": [{
                    "id": dc.id,
                    "racks": [{
                        "id": r.id,
                        "nodes": [n.to_info() for n in r.nodes.values()],
                    } for r in dc.racks.values()],
                } for dc in self.data_centers.values()],
            }


def aggregate_topology_info(topo: dict) -> dict:
    """Sum capacity/usage over a serialized topology dump (the
    /dir/status shape): {'slots', 'used_bytes', 'file_count'}. Shared
    by filer Statistics and mount statfs so the walk can't drift."""
    used = files = slots = 0
    for dc in topo.get("data_centers", []):
        for rack in dc.get("racks", []):
            for dn in rack.get("nodes", []):
                for v in dn.get("volumes", []):
                    used += v.get("size", 0)
                    files += v.get("file_count", 0)
                slots += dn.get("max_volume_count", 0)
    return {"slots": slots, "used_bytes": used, "file_count": files}


def find_node_info(topo: dict, node_url: str) -> Optional[dict]:
    """Locate one node's info dict in a serialized topology dump by its
    'ip:port' id (shared by shell gRPC-client resolution and backup)."""
    for dc in topo.get("data_centers", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                if n["id"] == node_url:
                    return n
    return None
