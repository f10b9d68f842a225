"""The port's cluster bookkeeping (cluster/sequence.py, cluster/topology.py,
cluster/volume_growth.py) and the shell's planners (shell/ec_plan.py)
against the JAX package's, on the same seeded inputs. Held exactly: the
same heartbeat stream fed to both Topologys gives equal /dir/status dumps,
layouts, lookups, EC shard maps and prunes; growth under the same seeded
generator picks the same nodes and volume ids; the four EC planners give
equal plans over seeded random topology dumps. Modelled on
tests/test_topology.py, tests/test_cluster.py and
tests/test_shell_ec.py:36-100."""

import dataclasses
import random

import numpy as np
import pytest

from seaweedfs_tpu.cluster import sequence as jseq
from seaweedfs_tpu.cluster import topology as jtopo
from seaweedfs_tpu.cluster import volume_growth as jgrowth
from seaweedfs_tpu.models.coder import LrcScheme as JLrcScheme
from seaweedfs_tpu.shell import ec_plan as jplan
from seaweedfs_tpu.storage.super_block import \
    ReplicaPlacement as JReplicaPlacement
from seaweedfs_tpu_torch.cluster import sequence as tseq
from seaweedfs_tpu_torch.cluster import topology as ttopo
from seaweedfs_tpu_torch.cluster import volume_growth as tgrowth
from seaweedfs_tpu_torch.models.coder import LrcScheme
from seaweedfs_tpu_torch.shell import ec_plan as tplan
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement

SEEDS = range(6)
PLACEMENTS = ("000", "001", "010", "100", "011", "110", "200")


def _vol(rng, vid, collections=("", "", "photos")):
    rp = ReplicaPlacement.parse(
        str(rng.choice(["000", "001", "010"]))).to_byte()
    return {"id": vid, "size": int(rng.integers(0, 2000)),
            "collection": str(rng.choice(collections)),
            "replica_placement": rp,
            "read_only": bool(rng.random() < 0.2),
            "file_count": int(rng.integers(0, 50)), "delete_count": 0,
            "deleted_byte_count": 0, "ttl": 0, "version": 3,
            "disk_type": str(rng.choice(["", "", "ssd"]))}


def _heartbeats(seed, n_nodes=7, n_vids=12):
    """A seeded stream of full and delta heartbeats over two DCs of two
    racks: [("full", hb) | ("delta", node_id, deltas)]."""
    rng = np.random.default_rng(seed)
    nodes = [{"ip": f"10.0.{i // 4}.{i}", "port": 8080 + i,
              "data_center": f"dc{i % 2}", "rack": f"r{(i // 2) % 2}",
              "max_volume_count": int(rng.integers(4, 12))}
             for i in range(n_nodes)]
    stream = []
    for n in nodes:
        vids = rng.choice(np.arange(1, n_vids + 1),
                          int(rng.integers(0, 5)), replace=False)
        ec = [{"id": int(v), "ec_index_bits": int(rng.integers(1, 1 << 14))}
              for v in rng.choice(np.arange(20, 24), int(rng.integers(0, 3)),
                                  replace=False)]
        stream.append(("full", {**n, "volumes": [_vol(rng, int(v))
                                                 for v in vids],
                                "ec_shards": ec,
                                "qos_pressure": float(rng.random())}))
    for _ in range(10):
        n = nodes[int(rng.integers(0, n_nodes))]
        nid = f"{n['ip']}:{n['port']}"
        deltas = {}
        if rng.random() < 0.5:
            deltas["new_volumes"] = [_vol(rng, int(rng.integers(1, 30)))]
        if rng.random() < 0.4:
            deltas["deleted_volumes"] = [
                {"id": int(rng.integers(1, n_vids)), "replica_placement": 0,
                 "collection": ""}]
        if rng.random() < 0.5:
            deltas["new_ec_shards"] = [{"id": int(rng.integers(20, 25)),
                                        "ec_index_bits":
                                        int(rng.integers(1, 1 << 14))}]
        if rng.random() < 0.4:
            deltas["deleted_ec_shards"] = [{"id": int(rng.integers(20, 25)),
                                            "ec_index_bits":
                                            int(rng.integers(1, 1 << 14))}]
        if rng.random() < 0.3:
            deltas["draining"] = bool(rng.random() < 0.5)
        stream.append(("delta", nid, deltas))
    # one node re-registers without its volumes (full sync drops them)
    n = nodes[int(rng.integers(0, n_nodes))]
    stream.append(("full", {**n, "volumes": [], "ec_shards": []}))
    return stream


def _feed(mod, stream, limit=4000):
    topo = mod.Topology(volume_size_limit=limit)
    for ev in stream:
        if ev[0] == "full":
            topo.sync_data_node_registration(ev[1])
        else:
            topo.incremental_sync(topo.find_node(ev[1]), ev[2])
    return topo


def _ec_holders(stream, vid, dead=()):
    """The nodes that hold a shard of EC volume `vid` once `stream` is
    applied, from the heartbeats alone (a full heartbeat replaces a
    node's shard bits, a delta adds or clears bits), each with the
    lowest shard id it holds; nodes in `dead` are left out."""
    bits: dict[str, dict[int, int]] = {}
    for ev in stream:
        if ev[0] == "full":
            hb = ev[1]
            bits[f"{hb['ip']}:{hb['port']}"] = {
                e["id"]: e["ec_index_bits"] for e in hb["ec_shards"]}
            continue
        held = bits[ev[1]]
        for e in ev[2].get("new_ec_shards", []):
            held[e["id"]] = held.get(e["id"], 0) | e["ec_index_bits"]
        for e in ev[2].get("deleted_ec_shards", []):
            left = held.get(e["id"], 0) & ~e["ec_index_bits"]
            if left:
                held[e["id"]] = left
            else:
                held.pop(e["id"], None)
    return {nid: (held[vid] & -held[vid]).bit_length() - 1
            for nid, held in bits.items()
            if held.get(vid) and nid not in dead}


def _check_lookup(t, j, stream, dead=()):
    """The port's lookup equals the JAX package's wherever that answers.
    Where it does not (an EC volume: seaweedfs_tpu's lookup has no EC
    fallback), the port answers every holder of a shard of the volume,
    each once, in shard order (reference topology.go Lookup falls back to
    LookupEcShards); the holders come from the heartbeat stream."""
    fallbacks = 0
    for c in ("", "photos"):
        for v in range(1, 31):
            got = [n.id for n in t.lookup(c, v)]
            want = [n.id for n in j.lookup(c, v)]
            if want:
                assert got == want, (c, v)
                continue
            holders = _ec_holders(stream, v, dead)
            assert sorted(got) == sorted(holders), (c, v)
            first = [holders[nid] for nid in got]
            assert first == sorted(first), (c, v)
            fallbacks += bool(got)
    return fallbacks


def _view(topo):
    """Everything a master answers from its topology, by node id, but
    lookups (_check_lookup)."""
    ids = lambda nodes: [n.id for n in nodes]  # noqa: E731
    return {
        "info": topo.to_info(),
        "layouts": {k: (sorted(lo.writable), sorted(lo.readonly),
                        {v: ids(ns) for v, ns in lo.locations.items()},
                        lo.active_volume_count(), lo.clean_volume_count())
                    for k, lo in topo.layouts.items()},
        "ec": {v: [ids(ns) for ns in topo.lookup_ec_shards(v)]
               for v in sorted(topo.ec_shard_map)},
        "by_rack": {k: ids(ns) for k, ns in topo.nodes_by_rack().items()},
        "free": [(n.id, n.free_space(), n.free_space(""),
                  n.free_space("ssd"), n.ec_shard_count())
                 for n in topo.all_nodes()],
        "max_volume_id": topo.max_volume_id,
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_heartbeat_stream_matches_jax(seed):
    stream = _heartbeats(seed)
    t, j = _feed(ttopo, stream), _feed(jtopo, stream)
    assert _view(t) == _view(j)
    # the EC fallback is exercised where the stream holds EC volumes
    assert _check_lookup(t, j, stream) > 0
    scheme = (LrcScheme(), JLrcScheme())
    for v in sorted(t.ec_shard_map):
        assert t.ec_group_alignment(v, scheme[0]) == \
            j.ec_group_alignment(v, scheme[1])
    info = t.to_info()
    assert ttopo.aggregate_topology_info(info) == \
        jtopo.aggregate_topology_info(info)
    for n in t.all_nodes():
        assert ttopo.find_node_info(info, n.id) == \
            jtopo.find_node_info(info, n.id)
    assert ttopo.find_node_info(info, "nowhere:1") is None
    # pick_for_write under the same seeded generator
    for (key, lo), (_, jlo) in zip(sorted(t.layouts.items()),
                                   sorted(j.layouts.items())):
        if not lo.writable:
            with pytest.raises(LookupError):
                lo.pick_for_write()
            continue
        got, want = [], []
        for mod, layout, out in ((ttopo, lo, got), (jtopo, jlo, want)):
            saved, mod.random = mod.random, random.Random(seed)
            try:
                for _ in range(5):
                    vid, nodes = layout.pick_for_write()
                    out.append((vid, [n.id for n in nodes]))
            finally:
                mod.random = saved
        assert got == want, key
    # prune: the same nodes die when their heartbeats stop
    dead_ids = [n.id for n in t.all_nodes()][::3]
    for topo in (t, j):
        for n in topo.all_nodes():
            if n.id in dead_ids:
                n.last_seen -= 60
    assert [n.id for n in t.prune_dead_nodes(timeout=30)] == \
        [n.id for n in j.prune_dead_nodes(timeout=30)] == dead_ids
    assert _view(t) == _view(j)
    _check_lookup(t, j, stream, dead=set(dead_ids))


def test_norm_disk_matches_jax():
    for d in ("", "hdd", "ssd", "nvme"):
        assert ttopo.norm_disk(d) == jtopo.norm_disk(d)


def test_sequencers_match_jax():
    t, j = tseq.MemorySequencer(), jseq.MemorySequencer()
    for count in (1, 3, 1, 16, 4096):
        assert t.next_file_id(count) == j.next_file_id(count)
    for seen in (100, 10_000):  # set_max only ever raises the counter
        t.set_max(seen)
        j.set_max(seen)
        assert t.peek() == j.peek()
        assert t.next_file_id() == j.next_file_id()
    assert t.peek() == 10_002
    sf = tseq.SnowflakeSequencer(node_id=5)
    ids = [sf.next_file_id() for _ in range(5000)]
    assert len(set(ids)) == len(ids) and ids == sorted(ids)
    assert all((i >> 12) & 1023 == 5 for i in ids)


def _grow_topos(seed):
    """The same nodes registered in both packages: 2 DCs x 3 racks."""
    rng = np.random.default_rng(seed)
    hbs = [{"ip": f"n{dc}{rk}{i}", "port": 80, "data_center": f"dc{dc}",
            "rack": f"r{rk}", "max_volume_count": int(rng.integers(1, 6)),
            "volumes": [], "ec_shards": []}
           for dc in range(2) for rk in range(3)
           for i in range(int(rng.integers(1, 4)))]
    return [_feed(mod, [("full", hb) for hb in hbs], limit=1000)
            for mod in (ttopo, jtopo)]


def _pick(mod_growth, topo, rp, seed):
    saved, mod_growth.random = mod_growth.random, random.Random(seed)
    try:
        return [n.id for n in mod_growth.find_empty_slots(topo, rp)]
    except mod_growth.NoFreeSpaceError as e:
        return ("NoFreeSpaceError", str(e))
    finally:
        mod_growth.random = saved


@pytest.mark.parametrize("rp", PLACEMENTS)
def test_find_empty_slots_matches_jax(rp):
    for seed in range(8):
        t, j = _grow_topos(seed)
        assert _pick(tgrowth, t, ReplicaPlacement.parse(rp), seed) == \
            _pick(jgrowth, j, JReplicaPlacement.parse(rp), seed)


@pytest.mark.parametrize("rp", ("000", "001", "010", "100"))
def test_grow_by_type_matches_jax(rp):
    """grow_by_type with a seeded allocator that refuses some nodes."""
    for seed in range(4):
        t, j = _grow_topos(seed)
        runs = []
        for mod_growth, topo in ((tgrowth, t), (jgrowth, j)):
            refuse = random.Random(seed + 100)
            allocated = []

            def alloc(node, vid, collection, rp_s, ttl, disk="",
                      topo=topo, allocated=allocated, refuse=refuse):
                ok = refuse.random() > 0.15
                allocated.append((node.id, vid, collection, rp_s, ok))
                if ok:
                    v = {"id": vid, "size": 0, "collection": collection,
                         "replica_placement":
                         ReplicaPlacement.parse(rp_s).to_byte()}
                    node.volumes[vid] = v
                    topo._register_volume(v, node)
                return ok

            saved = mod_growth.random
            mod_growth.random = random.Random(seed)
            try:
                vids = mod_growth.grow_by_type(topo, "c", rp, "", alloc,
                                               count=3)
                err = None
            except mod_growth.NoFreeSpaceError as e:
                vids, err = None, str(e)
            finally:
                mod_growth.random = saved
            runs.append((vids, err, allocated, topo.max_volume_id,
                         _view(topo)))
        assert runs[0] == runs[1]


def test_find_ec_group_slots_matches_jax():
    for seed in range(6):
        t, j = _grow_topos(seed)
        out = []
        for mod_growth, topo, scheme in ((tgrowth, t, LrcScheme()),
                                         (jgrowth, j, JLrcScheme())):
            try:
                out.append([n.id for n in
                            mod_growth.find_ec_group_slots(topo, scheme)])
            except mod_growth.NoFreeSpaceError as e:
                out.append(str(e))
        assert out[0] == out[1]


# ---------------- the shell's EC planners ----------------


def _ec_topology(seed):
    """A seeded /dir/status topology dump: nodes over 1-3 racks with
    volumes and EC shards, some volumes missing shards, some
    duplicated."""
    rng = np.random.default_rng(seed)
    racks = {}
    holders = {}
    for i in range(int(rng.integers(2, 7))):
        rack = f"r{int(rng.integers(0, 3))}"
        node = {"id": f"10.1.0.{i}:8080", "rack": rack, "data_center": "dc1",
                "max_volume_count": int(rng.integers(2, 10)),
                "volumes": [{"id": int(v), "collection":
                             str(rng.choice(["", "photos"])),
                             "size": int(rng.integers(0, 2000))}
                            for v in rng.choice(np.arange(1, 6),
                                                int(rng.integers(0, 3)),
                                                replace=False)],
                "ec_shards": []}
        racks.setdefault(rack, []).append(node)
        holders[node["id"]] = node
    nodes = list(holders.values())
    for vid in (10, 11, 12):
        keep = int(rng.choice([14, 13, 11, 10, 8]))
        for sid in rng.permutation(14)[:keep]:
            copies = 2 if rng.random() < 0.1 else 1
            for n in rng.choice(len(nodes), copies, replace=False):
                ent = next((e for e in nodes[n]["ec_shards"]
                            if e["id"] == vid), None)
                if ent is None:
                    ent = {"id": vid, "ec_index_bits": 0}
                    nodes[n]["ec_shards"].append(ent)
                ent["ec_index_bits"] |= 1 << int(sid)
    return {"data_centers": [{"id": "dc1", "racks": [
        {"id": r, "nodes": ns} for r, ns in sorted(racks.items())]}]}


def _plain(x):
    """Dataclass plans as tuples, so the two packages' compare."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(v) for v in dataclasses.astuple(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, set):
        return sorted(x)
    return x


def _both(fn_name, *args, **kw):
    out = []
    for mod in (tplan, jplan):
        try:
            out.append(_plain(getattr(mod, fn_name)(*args, **kw)))
        except (LookupError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_ec_planners_match_jax(seed):
    topo = _ec_topology(seed)
    for name, args, kw in (
            ("collect_ec_nodes", (topo,), {}),
            ("collect_volume_ids_for_ec_encode", (topo,), {}),
            ("collect_volume_ids_for_ec_encode", (topo, "photos"), {}),
            ("collect_volume_ids_for_ec_encode", (topo, ""),
             {"size_limit": 2000, "full_percent": 50}),
            ("plan_ec_rebuild", (topo,), {}),
            ("plan_ec_balance", (topo,), {})):
        got, want = _both(name, *args, **kw)
        assert got == want, name
    for vid in range(1, 6):
        got, want = _both("plan_ec_encode", topo, vid)
        assert got == want, ("plan_ec_encode", vid)
    t_lrc = tplan.plan_ec_encode
    for vid in range(1, 6):  # rack-aligned LRC placement, or its fallback
        try:
            got = _plain(t_lrc(topo, vid, scheme=LrcScheme()))
        except LookupError as e:
            got = str(e)
        try:
            want = _plain(jplan.plan_ec_encode(topo, vid,
                                               scheme=JLrcScheme()))
        except LookupError as e:
            want = str(e)
        assert got == want, ("plan_ec_encode lrc", vid)
    for vid in (10, 11, 12, 99):
        got, want = _both("plan_ec_decode", topo, vid)
        assert got == want, ("plan_ec_decode", vid)
    nodes = (tplan.collect_ec_nodes(topo), jplan.collect_ec_nodes(topo))
    got, want = (_both("balanced_ec_distribution", n)[i]
                 for i, n in enumerate(nodes))
    assert got == want
    assert _plain(tplan.grouped_ec_distribution(nodes[0], LrcScheme())) == \
        _plain(jplan.grouped_ec_distribution(nodes[1], JLrcScheme()))


def test_ec_planner_units():
    """tests/test_shell_ec.py's planner units on the port."""
    n = [tplan.EcNode("a", 100), tplan.EcNode("b", 100),
         tplan.EcNode("c", 100)]
    targets = tplan.balanced_ec_distribution(n)
    assert len(targets) == 14
    counts = {t: targets.count(t) for t in set(targets)}
    assert max(counts.values()) - min(counts.values()) <= 1
    small = tplan.balanced_ec_distribution([tplan.EcNode("big", 100),
                                            tplan.EcNode("small", 2)])
    assert small.count("small") <= 3
    with pytest.raises(ValueError):
        tplan.balanced_ec_distribution([])
    bits = sum(1 << s for s in range(12))
    topo = {"data_centers": [{"id": "dc1", "racks": [{"id": "r1", "nodes": [
        {"id": "a:1", "max_volume_count": 8, "volumes": [],
         "ec_shards": [{"id": 7, "ec_index_bits": bits & 0x3F}]},
        {"id": "b:1", "max_volume_count": 8, "volumes": [],
         "ec_shards": [{"id": 7, "ec_index_bits": bits & ~0x3F}]},
        {"id": "c:1", "max_volume_count": 8, "volumes": [],
         "ec_shards": []}]}]}]}
    plans = tplan.plan_ec_rebuild(topo)
    assert plans[0]["missing"] == [12, 13]
    assert plans[0]["rebuilder"] == "c:1"
