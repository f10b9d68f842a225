"""Volume growth: choose servers honoring replica placement, then allocate.

Functional equivalent of reference weed/topology/volume_growth.go:46-259
(findEmptySlotsForOneVolume): pick a main datacenter/rack/server weighted by
free slots, satisfying the xyz placement (x other DCs, y other racks in the
main DC, z other servers in the main rack), then allocate the volume on all
chosen nodes via a callback RPC.

The port's copy of seaweedfs_tpu/cluster/volume_growth.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

from seaweedfs_tpu_torch.cluster.topology import DataCenter, DataNode, Rack, Topology
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement


class NoFreeSpaceError(Exception):
    pass


def _weighted_pick(candidates, weight_fn):
    weights = [max(0.0, weight_fn(c)) for c in candidates]
    total = sum(weights)
    if total <= 0:
        raise NoFreeSpaceError("no candidates with free space")
    r = random.random() * total
    acc = 0.0
    for c, w in zip(candidates, weights):
        acc += w
        if r <= acc:
            return c
    return candidates[-1]


def find_empty_slots(topo: Topology, rp: ReplicaPlacement,
                     preferred_dc: str = "",
                     disk: str = "") -> list[DataNode]:
    """Choose rp.copy_count nodes for one volume's replicas. Every
    free-space check is tier-scoped: the empty disk type IS the hdd
    tier (reference types.DiskType), so untyped growth never lands on
    a node that only has ssd slots."""
    def fs(obj) -> float:
        # a draining node takes no new volumes (graceful-drain
        # contract); dc/rack aggregates still count it, but the
        # node-level weighted pick zeroes it out
        if getattr(obj, "draining", False):
            return 0.0
        return obj.free_space(disk or "")

    dcs = [dc for dc in topo.data_centers.values() if fs(dc) >= 1]
    if preferred_dc:
        dcs = [dc for dc in dcs if dc.id == preferred_dc]
    # main DC must fit 1 + same_rack + diff_rack copies; need diff_dc_count
    # other DCs with >= 1 slot
    main_needed = 1 + rp.same_rack_count + rp.diff_rack_count
    viable = [dc for dc in dcs if fs(dc) >= main_needed]
    if not viable or len(topo.data_centers) < rp.diff_dc_count + 1:
        raise NoFreeSpaceError(
            f"not enough data centers for placement {rp}"
            + (f" on disk type {disk!r}" if disk else ""))
    main_dc = _weighted_pick(viable, fs)

    # main rack must fit 1 + same_rack copies; need diff_rack_count other
    # racks in main DC
    racks = [r for r in main_dc.racks.values()
             if fs(r) >= 1 + rp.same_rack_count
             and len([n for n in r.nodes.values() if fs(n) >= 1])
             >= 1 + rp.same_rack_count]
    racks = [r for r in racks
             if len([x for x in main_dc.racks.values()
                     if x is not r and fs(x) >= 1])
             >= rp.diff_rack_count]
    if not racks:
        raise NoFreeSpaceError(f"not enough racks in {main_dc.id} for {rp}")
    main_rack = _weighted_pick(racks, fs)

    nodes = [n for n in main_rack.nodes.values() if fs(n) >= 1]
    if len(nodes) < 1 + rp.same_rack_count:
        raise NoFreeSpaceError(f"not enough servers in rack {main_rack.id}")
    main_node = _weighted_pick(nodes, fs)

    chosen = [main_node]
    # z: other servers in the same rack
    others = [n for n in nodes if n is not main_node]
    random.shuffle(others)
    chosen += others[:rp.same_rack_count]
    if len(chosen) < 1 + rp.same_rack_count:
        raise NoFreeSpaceError("not enough same-rack servers")
    # y: other racks in main DC
    other_racks = [r for r in main_dc.racks.values()
                   if r is not main_rack and fs(r) >= 1]
    random.shuffle(other_racks)
    for r in other_racks[:rp.diff_rack_count]:
        rnodes = [n for n in r.nodes.values() if fs(n) >= 1]
        chosen.append(_weighted_pick(rnodes, fs))
    if len(chosen) < 1 + rp.same_rack_count + rp.diff_rack_count:
        raise NoFreeSpaceError("not enough diff-rack servers")
    # x: other data centers
    other_dcs = [dc for dc in topo.data_centers.values()
                 if dc is not main_dc and fs(dc) >= 1]
    random.shuffle(other_dcs)
    for dc in other_dcs[:rp.diff_dc_count]:
        all_nodes = [n for r in dc.racks.values()
                     for n in r.nodes.values() if fs(n) >= 1]
        chosen.append(_weighted_pick(all_nodes, fs))
    if len(chosen) != rp.copy_count:
        raise NoFreeSpaceError(
            f"found {len(chosen)} slots, need {rp.copy_count}")
    return chosen


def find_ec_group_slots(topo: Topology, scheme,
                        disk: str = "") -> list[DataNode]:
    """Choose a target node per EC shard 0..total-1 with LRC group
    alignment: every member of a local group (its data shards + the
    group's local parity) lands in one rack, each group on a different
    rack when the topology has enough, and the global parities on racks
    outside every group's. A group-local repair then never crosses rack
    boundaries. Raises NoFreeSpaceError when fewer than two racks have
    free space or a group does not fit its rack — callers fall back to
    the balanced spread (shell/ec_plan.balanced_ec_distribution)."""
    def fs(n) -> float:
        if getattr(n, "draining", False):
            return 0.0
        return n.free_space(disk or "")

    by_rack = {rk: [n for n in ns if fs(n) >= 1]
               for rk, ns in topo.nodes_by_rack().items()}
    by_rack = {rk: ns for rk, ns in by_rack.items() if ns}
    racks = sorted(by_rack,
                   key=lambda rk: -sum(fs(n) for n in by_rack[rk]))
    if len(racks) < 2:
        raise NoFreeSpaceError(
            "group-aligned EC placement needs >= 2 racks with free space")
    targets: list[Optional[DataNode]] = [None] * scheme.total_shards
    budget = {n.id: int(fs(n)) for ns in by_rack.values() for n in ns}

    def place(sids: list[int], rack_names: list[str]) -> None:
        pool = sorted((n for rk in rack_names for n in by_rack[rk]),
                      key=lambda n: -budget[n.id])
        i = 0
        for sid in sids:
            for _ in range(len(pool)):
                n = pool[i % len(pool)]
                i += 1
                if budget[n.id] > 0:
                    budget[n.id] -= 1
                    targets[sid] = n
                    break
            else:
                raise NoFreeSpaceError(
                    f"no free slot for shard {sid} in racks {rack_names}")

    group_racks: list[str] = []
    for g in range(scheme.local_groups):
        rk = racks[g % len(racks)]
        group_racks.append(rk)
        place(scheme.group_members(g), [rk])
    others = [rk for rk in racks if rk not in group_racks] or racks
    place(scheme.global_parity_ids(), others)
    return targets


# (node, vid, collection, rp, ttl, disk) -> success
AllocateFn = Callable[[DataNode, int, str, str, str, str], bool]


def grow_by_type(topo: Topology, collection: str, rp_str: str, ttl: str,
                 allocate: AllocateFn, count: int = 1,
                 preferred_dc: str = "", disk: str = "") -> list[int]:
    """Grow `count` volumes; `allocate(node, vid, collection, rp, ttl,
    disk)` is the AllocateVolume RPC (reference volume_growth.go
    AutomaticGrowByType). Returns the new volume ids."""
    rp = ReplicaPlacement.parse(rp_str)
    grown = []
    for _ in range(count):
        nodes = find_empty_slots(topo, rp, preferred_dc, disk)
        vid = topo.next_volume_id()
        ok = all(allocate(n, vid, collection, rp_str, ttl, disk)
                 for n in nodes)
        if ok:
            grown.append(vid)
    return grown
