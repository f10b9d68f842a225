"""Pure planning functions for the EC admin commands.

Mirrors the reference's design (weed/shell/command_ec_encode.go,
command_ec_rebuild.go, command_ec_balance.go): planners are pure functions
over a serializable topology dump, so all multi-node placement logic is
unit-testable without a cluster; appliers (shell/commands.py) execute the
returned plans via volume-server RPCs.

Topology input is the master's /dir/status "Topology" dict.

The port's copy of seaweedfs_tpu/shell/ec_plan.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

from seaweedfs_tpu_torch.storage.erasure_coding import layout


@dataclasses.dataclass
class EcNode:
    node_id: str  # "ip:port"
    free_ec_slots: int
    rack: str = ""
    data_center: str = ""
    # vid -> set of shard ids held
    shards: dict[int, set[int]] = dataclasses.field(default_factory=dict)

    def shard_count(self) -> int:
        return sum(len(s) for s in self.shards.values())

    def add(self, vid: int, sid: int) -> None:
        self.shards.setdefault(vid, set()).add(sid)
        self.free_ec_slots -= 1

    def remove(self, vid: int, sid: int) -> None:
        if sid in self.shards.get(vid, ()):  # pragma: no branch
            self.shards[vid].discard(sid)
            if not self.shards[vid]:
                del self.shards[vid]
            self.free_ec_slots += 1


def collect_ec_nodes(topology: dict) -> list[EcNode]:
    """EcNodes sorted by free slots descending (reference
    command_ec_common.go collectEcVolumeServersByDc / sortEcNodesByFreeslotsDescending).
    Free EC slots = free volume slots * TotalShardsCount."""
    out = []
    for dc in topology.get("data_centers", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                used = len(n.get("volumes", []))
                shard_total = sum(
                    bin(e["ec_index_bits"]).count("1")
                    for e in n.get("ec_shards", []))
                free_slots = (n.get("max_volume_count", 8) - used) * \
                    layout.TOTAL_SHARDS_COUNT - shard_total
                node = EcNode(
                    node_id=n["id"],
                    free_ec_slots=free_slots,
                    rack=n.get("rack", rack.get("id", "")),
                    data_center=n.get("data_center", dc.get("id", "")))
                for e in n.get("ec_shards", []):
                    bits = e["ec_index_bits"]
                    node.shards[e["id"]] = {
                        sid for sid in range(layout.TOTAL_SHARDS_COUNT)
                        if bits & (1 << sid)}
                out.append(node)
    out.sort(key=lambda n: -n.free_ec_slots)
    return out


def collect_volume_ids_for_ec_encode(topology: dict, collection: str = "",
                                     quiet_seconds: float = 0,
                                     full_percent: float = 0.0,
                                     size_limit: int = 0) -> list[int]:
    """Volumes eligible for EC encoding: in the collection, and (when
    size_limit > 0) at least full_percent% full (reference
    command_ec_encode.go:267-298)."""
    vids = set()
    for dc in topology.get("data_centers", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                for v in n.get("volumes", []):
                    if collection and v.get("collection", "") != collection:
                        continue
                    if not collection and v.get("collection"):
                        continue
                    if size_limit and full_percent and \
                            v.get("size", 0) < size_limit * full_percent / 100:
                        continue
                    vids.add(v["id"])
    return sorted(vids)


@dataclasses.dataclass
class ShardMove:
    vid: int
    shard_id: int
    source: str  # node id, "" when the shard is newly generated
    target: str


def balanced_ec_distribution(nodes: list[EcNode],
                             total: int = layout.TOTAL_SHARDS_COUNT
                             ) -> list[str]:
    """Round-robin shard spread by free slots (reference
    command_ec_encode.go balancedEcDistribution:249-265). Returns the
    target node id for each shard 0..total-1."""
    if not nodes:
        raise ValueError("no ec nodes")
    # strict round-robin over servers (sorted by free slots descending),
    # skipping full ones — matches the reference exactly
    pool = sorted(nodes, key=lambda n: -n.free_ec_slots)
    free = {n.node_id: n.free_ec_slots for n in pool}
    if sum(max(0, f) for f in free.values()) < total:
        raise ValueError("not enough free ec slots")
    picked: list[str] = []
    i = 0
    while len(picked) < total:
        n = pool[i % len(pool)]
        if free[n.node_id] > 0:
            picked.append(n.node_id)
            free[n.node_id] -= 1
        i += 1
    return picked


def grouped_ec_distribution(nodes: list[EcNode],
                            scheme) -> Optional[list[str]]:
    """Rack-aligned placement for LRC: every member of a local group
    (its data shards + the group's local parity) lands in ONE rack, so
    a single-shard repair — which reads only surviving group members —
    never crosses rack boundaries; each group takes its own rack and
    the global parities go to racks outside every group (independent
    failure domains) when the topology has them. Returns the target
    node id per shard 0..total-1, or None when the topology cannot
    align (fewer than two racks with slots, or a group does not fit) —
    callers fall back to balanced_ec_distribution."""
    by_rack: dict[str, list[EcNode]] = defaultdict(list)
    for n in nodes:
        # a rack-less node is its own failure domain
        by_rack[n.rack or n.node_id].append(n)
    free = {n.node_id: max(0, n.free_ec_slots) for n in nodes}
    racks = sorted(by_rack, key=lambda r: -sum(free[n.node_id]
                                               for n in by_rack[r]))
    if len(racks) < 2:
        return None
    targets: list[Optional[str]] = [None] * scheme.total_shards

    def place(sids: list[int], rack_names: list[str]) -> bool:
        pool = sorted((n for r in rack_names for n in by_rack[r]),
                      key=lambda n: -free[n.node_id])
        i = 0
        for sid in sids:
            for _ in range(len(pool) or 1):
                if not pool:
                    return False
                n = pool[i % len(pool)]
                i += 1
                if free[n.node_id] > 0:
                    free[n.node_id] -= 1
                    targets[sid] = n.node_id
                    break
            else:
                return False
        return True

    group_racks: list[str] = []
    for g in range(scheme.local_groups):
        rack = racks[g % len(racks)]
        group_racks.append(rack)
        if not place(scheme.group_members(g), [rack]):
            return None
    others = [r for r in racks if r not in group_racks] or racks
    if not place(scheme.global_parity_ids(), others):
        return None
    return targets


def plan_ec_encode(topology: dict, vid: int,
                   source_node: Optional[str] = None,
                   scheme=None) -> dict:
    """Plan: where the volume lives, and where each generated shard
    goes. An LRC `scheme` asks for rack-aligned local groups first
    (grouped_ec_distribution), falling back to the balanced round-robin
    when the topology cannot align."""
    replicas = []
    for dc in topology.get("data_centers", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                for v in n.get("volumes", []):
                    if v["id"] == vid:
                        replicas.append(n["id"])
    if not replicas:
        raise LookupError(f"volume {vid} not found in topology")
    source = source_node or replicas[0]
    nodes = collect_ec_nodes(topology)
    targets = None
    if scheme is not None and getattr(scheme, "local_groups", 0):
        targets = grouped_ec_distribution(nodes, scheme)
    rack_aligned = targets is not None
    if targets is None:
        targets = balanced_ec_distribution(nodes)
    moves = [ShardMove(vid, sid, source, target)
             for sid, target in enumerate(targets)]
    return {"vid": vid, "source": source, "replicas": replicas,
            "moves": moves, "rack_aligned": rack_aligned}


def plan_ec_rebuild(topology: dict) -> list[dict]:
    """Find EC volumes missing shards but still recoverable; choose the
    rebuilder (most free slots) (reference command_ec_rebuild.go)."""
    shard_owners: dict[int, dict[int, list[str]]] = defaultdict(
        lambda: defaultdict(list))
    for dc in topology.get("data_centers", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                for e in n.get("ec_shards", []):
                    bits = e["ec_index_bits"]
                    for sid in range(layout.TOTAL_SHARDS_COUNT):
                        if bits & (1 << sid):
                            shard_owners[e["id"]][sid].append(n["id"])
    nodes = collect_ec_nodes(topology)
    plans = []
    for vid, owners in sorted(shard_owners.items()):
        present = sorted(owners)
        if len(present) >= layout.TOTAL_SHARDS_COUNT:
            continue
        if len(present) < layout.DATA_SHARDS_COUNT:
            plans.append({"vid": vid, "error":
                          f"unrepairable: only {len(present)} shards"})
            continue
        rebuilder = max(nodes, key=lambda n: n.free_ec_slots)
        missing = [sid for sid in range(layout.TOTAL_SHARDS_COUNT)
                   if sid not in owners]
        copies = [ShardMove(vid, sid, owners[sid][0], rebuilder.node_id)
                  for sid in present
                  if rebuilder.node_id not in owners[sid]]
        plans.append({"vid": vid, "rebuilder": rebuilder.node_id,
                      "missing": missing, "copies": copies})
    return plans


def plan_ec_balance(topology: dict, collection: str = "") -> list[ShardMove]:
    """Balance EC shards: (1) drop duplicate replicas of the same shard,
    (2) spread shards of each volume across racks, (3) even out per-node
    counts (reference command_ec_balance.go's three phases, simplified to
    the same outcomes)."""
    nodes = collect_ec_nodes(topology)
    by_id = {n.node_id: n for n in nodes}
    moves: list[ShardMove] = []

    # phase 1+2: per volume, ensure each shard exists once, spread by rack
    owners: dict[int, dict[int, list[str]]] = defaultdict(
        lambda: defaultdict(list))
    for n in nodes:
        for vid, sids in n.shards.items():
            for sid in sids:
                owners[vid][sid].append(n.node_id)

    for vid, shard_map in sorted(owners.items()):
        rack_load: dict[str, int] = defaultdict(int)
        for sid, owner_list in shard_map.items():
            for o in owner_list:
                rack_load[by_id[o].rack] += 1
        for sid, owner_list in sorted(shard_map.items()):
            # duplicates: keep the copy on the least-loaded rack
            while len(owner_list) > 1:
                owner_list.sort(key=lambda o: rack_load[by_id[o].rack])
                drop = owner_list.pop()  # most loaded rack
                rack_load[by_id[drop].rack] -= 1
                moves.append(ShardMove(vid, sid, drop, ""))  # "" = delete

    # phase 3: even per-node shard counts with capacity-aware moves
    for vid, shard_map in sorted(owners.items()):
        flat = [(sid, owner_list[0]) for sid, owner_list in
                sorted(shard_map.items()) if owner_list]
        avg = len(flat) / max(1, len(nodes))
        counts: dict[str, int] = defaultdict(int)
        for sid, o in flat:
            counts[o] += 1
        for sid, o in flat:
            if counts[o] > avg + 1:
                target = min(
                    (n for n in nodes
                     if n.free_ec_slots > 0 and counts[n.node_id] < avg),
                    key=lambda n: counts[n.node_id], default=None)
                if target is None or target.node_id == o:
                    continue
                counts[o] -= 1
                counts[target.node_id] += 1
                moves.append(ShardMove(vid, sid, o, target.node_id))
    return moves


def plan_ec_decode(topology: dict, vid: int) -> dict:
    """Collect all shards onto the owner with the most shards, then convert
    (reference command_ec_decode.go)."""
    owners: dict[int, list[str]] = defaultdict(list)
    node_shards: dict[str, set[int]] = defaultdict(set)
    for dc in topology.get("data_centers", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                for e in n.get("ec_shards", []):
                    if e["id"] != vid:
                        continue
                    bits = e["ec_index_bits"]
                    for sid in range(layout.TOTAL_SHARDS_COUNT):
                        if bits & (1 << sid):
                            owners[sid].append(n["id"])
                            node_shards[n["id"]].add(sid)
    if not owners:
        raise LookupError(f"ec volume {vid} not found")
    collector = max(node_shards, key=lambda k: len(node_shards[k]))
    copies = [ShardMove(vid, sid, owner_list[0], collector)
              for sid, owner_list in sorted(owners.items())
              if collector not in owner_list]
    return {"vid": vid, "collector": collector, "copies": copies,
            "all_owners": {sid: sorted(v) for sid, v in owners.items()}}
