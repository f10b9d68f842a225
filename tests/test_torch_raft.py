"""The port's Raft (cluster/raft.py) and master HA (MasterServer.set_peers)
held against the JAX package.

- Handler parity: a JAX RaftNode and a port RaftNode, tickers not started,
  fed one scripted sequence of RequestVote / AppendEntries /
  InstallSnapshot bodies, give equal responses, apply equal commands and
  persist equal state.
- The reference's Raft cases (tests/test_raft.py) on port nodes, over an
  in-process transport with partitions.
- One protocol: a group of two port nodes and one JAX node elects one
  leader and replicates, through a failover.
- Master HA on port masters: the reference's churn cases
  (tests/test_raft_churn.py), the Raft cases of tests/test_shell_sweep2.py
  and the failover of tests/test_ha_query_cache.py, extended with an EC
  volume (ec.encode, a server lost, the leader killed, ec.rebuild through
  the new leader's shell) whose shards are sha256-equal to the same script
  on an all-JAX stack.

Every wait has a deadline and every thread the test starts is joined with
a timeout.
"""

import hashlib
import json
import random
import socket
import threading
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.cluster import raft as jraft
from seaweedfs_tpu.cluster import topology as jtopology
from seaweedfs_tpu.cluster import volume_growth as jgrowth
from seaweedfs_tpu.server import master as jmaster
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.shell.commands import ShellContext as JShellContext
from seaweedfs_tpu_torch.cluster import topology
from seaweedfs_tpu_torch.cluster import volume_growth
from seaweedfs_tpu_torch.cluster.raft import LEADER, NotLeaderError, RaftNode
from seaweedfs_tpu_torch.server import master
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import ShellContext
from seaweedfs_tpu_torch.shell.repl import run_command
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.utils.httpd import HttpError, http_call, http_json

TOTAL = layout.TOTAL_SHARDS_COUNT
FIXED_NS = 1_700_000_000_123_456_789


def _port_vs(dirs, master_url, **kw):
    return VolumeServer(dirs, master_url, device="cpu", **kw)


# ---------------- handler parity ----------------


def _scripted_node(cls, tmp_path, name):
    applied, restored = [], []
    node = cls("m0", ["m0", "m1", "m2"],
               apply_fn=applied.append,
               snapshot_fn=lambda: {"applied": list(applied)},
               restore_fn=restored.append,
               state_path=str(tmp_path / f"{name}.json"),
               send_fn=lambda *a: pytest.fail("a ticker-less node sent"),
               compact_threshold=4)
    return node, applied, restored


def _entry(term, op):
    return {"term": term, "command": {"op": op}}


# (handler, body): votes, appends with conflicts and truncation, a commit
# that compacts the log, stale and newer terms, snapshots, membership
SCRIPT = [
    ("vote", {"term": 1, "candidate_id": "m1", "last_log_index": 0,
              "last_log_term": 0}),
    ("vote", {"term": 1, "candidate_id": "m2", "last_log_index": 5,
              "last_log_term": 1}),
    ("vote", {"term": 9, "candidate_id": "mx", "last_log_index": 0,
              "last_log_term": 0}),
    ("append", {"term": 1, "leader_id": "m1", "prev_log_index": 0,
                "prev_log_term": 0, "leader_commit": 0,
                "entries": [_entry(1, "a"), _entry(1, "b"),
                            _entry(1, "c")]}),
    ("append", {"term": 1, "leader_id": "m1", "prev_log_index": 3,
                "prev_log_term": 2, "leader_commit": 0, "entries": []}),
    ("append", {"term": 1, "leader_id": "m1", "prev_log_index": 7,
                "prev_log_term": 1, "leader_commit": 0, "entries": []}),
    ("append", {"term": 0, "leader_id": "m2", "prev_log_index": 0,
                "prev_log_term": 0, "leader_commit": 0, "entries": []}),
    ("append", {"term": 1, "leader_id": "m1", "prev_log_index": 3,
                "prev_log_term": 1, "leader_commit": 2,
                "entries": [_entry(1, "d"), _entry(1, "e")]}),
    # a new leader overwrites the uncommitted suffix from index 4
    ("append", {"term": 2, "leader_id": "m2", "prev_log_index": 3,
                "prev_log_term": 1, "leader_commit": 3,
                "entries": [_entry(2, "D"), _entry(2, "E"),
                            _entry(2, "F")]}),
    ("append", {"term": 2, "leader_id": "m2", "prev_log_index": 6,
                "prev_log_term": 2, "leader_commit": 6,
                "entries": [{"term": 2, "command": {"type": "noop"}}]}),
    ("vote", {"term": 3, "candidate_id": "m1", "last_log_index": 2,
              "last_log_term": 1}),
    ("snapshot", {"term": 3, "leader_id": "m2", "last_included_index": 12,
                  "last_included_term": 3,
                  "state": {"applied": ["snap"],
                            "_raft_members": ["m0", "m1", "m2", "m3"]}}),
    ("snapshot", {"term": 3, "leader_id": "m2", "last_included_index": 10,
                  "last_included_term": 3, "state": {}}),
    ("snapshot", {"term": 2, "leader_id": "m1", "last_included_index": 20,
                  "last_included_term": 2, "state": {}}),
    ("append", {"term": 3, "leader_id": "m2", "prev_log_index": 12,
                "prev_log_term": 3, "leader_commit": 14,
                "entries": [_entry(3, "g"), _entry(3, "h")]}),
    ("vote", {"term": 4, "candidate_id": "m3", "last_log_index": 14,
              "last_log_term": 3}),
    ("vote", {"term": 4, "candidate_id": "m1", "last_log_index": 14,
              "last_log_term": 3}),
]


def _run_script(cls, tmp_path, name):
    node, applied, restored = _scripted_node(cls, tmp_path, name)
    handlers = {"vote": node.on_request_vote,
                "append": node.on_append_entries,
                "snapshot": node.on_install_snapshot}
    responses = [handlers[h](json.loads(json.dumps(body)))
                 for h, body in SCRIPT]
    node.add_peer("m4")
    node.remove_peer("m1")
    node.stop()
    with open(tmp_path / f"{name}.json") as f:
        persisted = json.load(f)
    reloaded = cls("m0", ["m0"], apply_fn=lambda c: None,
                   state_path=str(tmp_path / f"{name}.json"))
    return {"responses": responses, "applied": applied,
            "restored": restored, "persisted": persisted,
            "membership": node.membership(),
            "reloaded": (reloaded.current_term, reloaded.voted_for,
                         reloaded.peers, reloaded.snap_index,
                         reloaded.commit_index, len(reloaded.log))}


def test_handlers_match_jax(tmp_path):
    want = _run_script(jraft.RaftNode, tmp_path, "jax")
    got = _run_script(RaftNode, tmp_path, "port")
    assert got == want
    # the script reached every branch it was written for
    assert [r.get("vote_granted") for r in want["responses"]
            if "vote_granted" in r] == [True, False, False, False, True,
                                        False]
    assert want["applied"] == [{"op": "a"}, {"op": "b"}, {"op": "c"},
                               {"op": "D"}, {"op": "E"}, {"op": "F"},
                               {"op": "g"}, {"op": "h"}]
    assert want["persisted"]["snap_index"] == 12
    assert want["persisted"]["peers"] == ["m2", "m3", "m4"]
    assert want["restored"][-1]["applied"] == ["snap"]


# ---------------- the reference's Raft cases on port nodes ----------------


class Net:
    """In-process message fabric with partitions."""

    def __init__(self):
        self.nodes: dict = {}
        self.down: set[str] = set()

    def send(self, sender: str, peer: str, path: str, body: dict,
             timeout: float) -> dict:
        if sender in self.down or peer in self.down or peer not in self.nodes:
            raise ConnectionError(f"{sender}->{peer} unreachable")
        node = self.nodes[peer]
        if path == "/raft/vote":
            return node.on_request_vote(body)
        if path == "/raft/append":
            return node.on_append_entries(body)
        if path == "/raft/snapshot":
            return node.on_install_snapshot(body)
        raise ValueError(path)


def make_cluster(n, tmp_path=None, compact_threshold=10 ** 9,
                 classes=None):
    net = Net()
    ids = [f"m{i}" for i in range(n)]
    classes = classes or [RaftNode] * n
    applied = {i: [] for i in ids}
    nodes = []
    for i, cls in zip(ids, classes):
        node = cls(
            i, ids,
            apply_fn=lambda cmd, i=i: applied[i].append(cmd),
            snapshot_fn=lambda i=i: {"applied": list(applied[i])},
            restore_fn=lambda st, i=i: applied[i].extend(
                c for c in st.get("applied", []) if c not in applied[i]),
            state_path=str(tmp_path / f"{i}.json") if tmp_path else "",
            send_fn=lambda peer, path, body, timeout, i=i:
                net.send(i, peer, path, body, timeout),
            election_timeout=(0.15, 0.4), heartbeat_interval=0.05,
            compact_threshold=compact_threshold)
        net.nodes[i] = node
        nodes.append(node)
    return net, nodes, applied


def wait_leader(nodes, net=None, timeout=90.0):
    # generous: sub-second election timeouts flap for a while when the
    # machine is saturated by the rest of the suite
    deadline = time.time() + timeout
    while time.time() < deadline:
        alive = [n for n in nodes
                 if net is None or n.id not in net.down]
        leaders = [n for n in alive if n.state in (LEADER, jraft.LEADER)]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.02)
    raise AssertionError("no unique leader elected")


def _wait_applied(applied, ids, want, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(applied[i] == want for i in ids):
            return
        time.sleep(0.02)


def test_election_and_replication():
    net, nodes, applied = make_cluster(3)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        for k in range(5):
            assert leader.propose({"op": k}, timeout=5)
        _wait_applied(applied, [n.id for n in nodes],
                      [{"op": k} for k in range(5)])
        for n in nodes:
            assert applied[n.id] == [{"op": k} for k in range(5)]
    finally:
        for n in nodes:
            n.stop()


def test_follower_rejects_propose():
    net, nodes, _ = make_cluster(3)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        follower = next(n for n in nodes if n is not leader)
        with pytest.raises(NotLeaderError):
            follower.propose({"op": 1})
    finally:
        for n in nodes:
            n.stop()


def test_leader_failover_preserves_log():
    net, nodes, applied = make_cluster(3)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        assert leader.propose({"op": "before"}, timeout=5)
        # partition the leader away; a new leader emerges with the entry
        net.down.add(leader.id)
        survivors = [n for n in nodes if n is not leader]
        new_leader = wait_leader(survivors, net)
        assert new_leader is not leader
        assert new_leader.propose({"op": "after"}, timeout=5)
        both = [{"op": "before"}, {"op": "after"}]
        _wait_applied(applied, [n.id for n in survivors], both)
        for n in survivors:
            assert applied[n.id] == both
        # healed old leader catches up and steps down
        net.down.discard(leader.id)
        deadline = time.time() + 5
        while time.time() < deadline:
            if applied[leader.id] == both and leader.state != LEADER:
                break
            time.sleep(0.02)
        assert applied[leader.id] == both
        assert leader.state != LEADER
    finally:
        for n in nodes:
            n.stop()


def test_partitioned_leader_steps_down():
    """Check-quorum: a leader cut off from the majority stops claiming
    leadership while partitioned, not merely after healing."""
    net, nodes, _ = make_cluster(3)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        net.down.add(leader.id)
        deadline = time.time() + 5
        while time.time() < deadline and leader.state == LEADER:
            time.sleep(0.02)
        assert leader.state != LEADER, \
            "partitioned leader kept serving (split-brain)"
        with pytest.raises(NotLeaderError):
            leader.propose({"op": "zombie write"})
    finally:
        for n in nodes:
            n.stop()


def _propose_committed(nodes, command, timeout=90.0):
    """Commit `command` exactly once through whichever node leads, and
    return that leader. Under load the leader can change between
    wait_leader and the commit: a proposal that raises NotLeaderError or
    times out is retried only once a ready leader (its election no-op
    committed) does not hold it, since only then can it never commit; a
    ready leader that holds it has committed it already."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        leader = wait_leader(nodes)
        try:
            if leader.propose(command, timeout=5):
                return leader
        except NotLeaderError:
            pass
        while time.time() < deadline:
            leader = wait_leader(nodes)
            if leader.wait_ready(timeout=5):
                break
        with leader.lock:
            held = any(e["command"] == command for e in leader.log)
        if held:
            return leader
    raise AssertionError(f"{command} not committed in {timeout} s")


def test_persistence_across_restart(tmp_path):
    net, nodes, applied = make_cluster(3, tmp_path)
    for n in nodes:
        n.start()
    try:
        for k in range(3):
            leader = _propose_committed(nodes, {"op": k})
        term_before = leader.current_term
        # every node holds the three entries before it stops (a follower
        # learns the last commit a heartbeat later)
        _wait_applied(applied, [n.id for n in nodes],
                      [{"op": 0}, {"op": 1}, {"op": 2}], timeout=30.0)
    finally:
        for n in nodes:
            n.stop()

    # restart from disk: term + log survive
    net2, nodes2, applied2 = make_cluster(3, tmp_path)
    for n in nodes2:
        assert n.current_term >= term_before
        assert len(n.log) + n.snap_index >= 3
    for n in nodes2:
        n.start()
    try:
        leader2 = _propose_committed(nodes2, {"op": "post-restart"})
        # committed entries re-applied in order after restart
        assert applied2[leader2.id] == [{"op": 0}, {"op": 1}, {"op": 2},
                                        {"op": "post-restart"}]
    finally:
        for n in nodes2:
            n.stop()


def test_snapshot_compaction_and_install():
    net, nodes, applied = make_cluster(3, compact_threshold=8)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        # take a follower down; write enough to force compaction past it
        straggler = next(n for n in nodes if n is not leader)
        net.down.add(straggler.id)
        for k in range(20):
            assert leader.propose({"op": k}, timeout=5)
        deadline = time.time() + 5
        while time.time() < deadline and leader.snap_index == 0:
            time.sleep(0.02)
        assert leader.snap_index > 0, "leader should have compacted"
        # heal: the straggler is behind the snapshot -> InstallSnapshot
        net.down.discard(straggler.id)
        deadline = time.time() + 5
        while time.time() < deadline:
            if len(applied[straggler.id]) == 20:
                break
            time.sleep(0.02)
        assert applied[straggler.id] == [{"op": k} for k in range(20)]
    finally:
        for n in nodes:
            n.stop()


def test_restart_keeps_membership_change_after_snapshot(tmp_path):
    """A membership change committed after the last compaction survives
    a restart: the persisted peer list wins over the older member set in
    the snapshot; a state file without 'peers' adopts the snapshot's."""
    path = str(tmp_path / "m0.json")
    node = RaftNode("m0", ["m0", "m1", "m2"], apply_fn=lambda c: None,
                    state_path=path)
    node.snap_index = 5
    node.snap_term = 1
    node.snap_state = {"_raft_members": ["m0", "m1", "m2"]}
    node.remove_peer("m2")  # committed after the snapshot; persists
    node._persist()

    node2 = RaftNode("m0", ["m0", "m1", "m2"], apply_fn=lambda c: None,
                     state_path=path)
    assert node2.peers == ["m1"]

    with open(path) as f:
        st = json.load(f)
    del st["peers"]
    with open(path, "w") as f:
        json.dump(st, f)
    node3 = RaftNode("m0", ["m0"], apply_fn=lambda c: None,
                     state_path=path)
    assert sorted(node3.peers) == ["m1", "m2"]


# ---------------- one protocol: a mixed group ----------------


def test_mixed_group_elects_and_replicates():
    """Two port nodes and one JAX node: one leader, every command applied
    on all three, through a failover of the first leader."""
    net, nodes, applied = make_cluster(
        3, classes=[RaftNode, RaftNode, jraft.RaftNode])
    ids = [n.id for n in nodes]
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        for k in range(3):
            assert leader.propose({"op": k}, timeout=5)
        first = [{"op": k} for k in range(3)]
        _wait_applied(applied, ids, first)
        assert all(applied[i] == first for i in ids)
        net.down.add(leader.id)
        survivors = [n for n in nodes if n is not leader]
        new_leader = wait_leader(survivors, net)
        assert new_leader.propose({"op": "after"}, timeout=5)
        net.down.discard(leader.id)
        _wait_applied(applied, ids, first + [{"op": "after"}], timeout=10)
        assert all(applied[i] == first + [{"op": "after"}] for i in ids)
        # the logs agree entry by entry, election no-ops included
        logs = [[e["command"] for e in n.log] for n in nodes]
        assert logs[0] == logs[1] == logs[2]
    finally:
        for n in nodes:
            n.stop()


# ---------------- master HA on port masters ----------------


def _wait_unique_leader(masters, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        leaders = [m for m in masters if m.is_leader()]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.05)
    raise AssertionError("no unique leader")


def _partition(m):
    """Cut the master's raft plane both ways (a network partition, not a
    crash: it thinks it leads until its quorum check fires)."""
    r = m.raft
    saved = (r.send, r.on_request_vote, r.on_append_entries,
             r.on_install_snapshot)

    def dead_send(peer, path, body, timeout):
        raise ConnectionError("partitioned")

    def dead_recv(body):
        raise ConnectionError("partitioned")

    r.send = dead_send
    r.on_request_vote = dead_recv
    r.on_append_entries = dead_recv
    r.on_install_snapshot = dead_recv

    def heal():
        (r.send, r.on_request_vote, r.on_append_entries,
         r.on_install_snapshot) = saved
    return heal


def _group(n=3):
    masters = [MasterServer() for _ in range(n)]
    for m in masters:
        m.start()
    urls = [m.url for m in masters]
    for m in masters:
        m.set_peers(urls)
    return masters, urls


@pytest.fixture
def trio(tmp_path):
    masters, urls = _group()
    vs = None
    try:
        leader = _wait_unique_leader(masters)
        vs = _port_vs([str(tmp_path / "v")], urls)
        vs.start()
        deadline = time.time() + 15
        while time.time() < deadline and not leader.topo.all_nodes():
            time.sleep(0.1)
        assert leader.topo.all_nodes()
        yield masters, vs
    finally:
        if vs is not None:
            vs.stop()
        for m in masters:
            m.stop()


def _assign(url: str):
    return http_json("GET", f"http://{url}/dir/assign", timeout=3)


def test_partition_leader_mid_assign_no_duplicate_fids(trio):
    masters, vs = trio
    urls = [m.url for m in masters]
    old_leader = _wait_unique_leader(masters)
    fids: list[str] = []
    lock = threading.Lock()
    stop = threading.Event()

    def assign_loop():
        """A client hammering assigns through the churn, retrying against
        every master like wdclient does."""
        while not stop.is_set():
            for url in urls:
                try:
                    out = _assign(url)
                except (ConnectionError, HttpError):
                    continue
                if out.get("fid"):
                    with lock:
                        fids.append(out["fid"])
                    break
            time.sleep(0.005)

    threads = [threading.Thread(target=assign_loop) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.4)  # assigns flowing against the old leader
        heal = _partition(old_leader)
        survivors = [m for m in masters if m is not old_leader]
        new_leader = _wait_unique_leader(survivors, timeout=30)
        assert new_leader is not old_leader
        # the partitioned ex-leader steps down on its own (quorum check)
        deadline = time.time() + 10
        while time.time() < deadline and old_leader.is_leader():
            time.sleep(0.05)
        assert not old_leader.is_leader()
        time.sleep(0.6)  # assigns flowing against the new leader
        heal()
        time.sleep(0.6)  # the old leader rejoins as a follower
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)

    # every fid handed out during the churn is unique
    assert len(fids) > 20, f"too few assigns went through ({len(fids)})"
    assert len(set(fids)) == len(fids), "duplicate fids across failover"
    final_leader = _wait_unique_leader(masters, timeout=30)
    deadline = time.time() + 10
    while time.time() < deadline:
        if len({m.topo.max_volume_id for m in masters}) == 1:
            break
        time.sleep(0.1)
    assert len({m.topo.max_volume_id for m in masters}) == 1
    deadline = time.time() + 20
    out = {}
    while time.time() < deadline:
        try:
            if final_leader.topo.all_nodes():
                out = _assign(final_leader.url)
                if out.get("fid"):
                    break
        except (ConnectionError, HttpError):
            pass
        time.sleep(0.2)
    assert out.get("fid") and out["fid"] not in fids


def test_lagging_follower_converges_after_heal(trio):
    masters, vs = trio
    leader = _wait_unique_leader(masters)
    follower = next(m for m in masters if m is not leader)
    heal = _partition(follower)
    try:
        # state changes while the follower is dark: each new collection
        # grows a volume, so max_volume_id commits
        for i in range(4):
            out = http_json("GET", f"http://{leader.url}/dir/assign"
                                   f"?collection=churn{i}")
            assert out.get("fid"), out
        vid_now = leader.topo.max_volume_id
        assert vid_now > follower.topo.max_volume_id
    finally:
        heal()
    deadline = time.time() + 20
    while time.time() < deadline and \
            follower.topo.max_volume_id < vid_now:
        time.sleep(0.1)
    assert follower.topo.max_volume_id >= vid_now
    # the follower's committed sequence floor advanced too
    assert follower._seq_ckpt >= leader.sequencer.peek() or \
        follower._seq_ckpt >= leader._seq_ckpt


def _wait_leases(url: str, pred, timeout: float = 25.0) -> dict:
    deadline = time.time() + timeout
    reply: dict = {}
    while time.time() < deadline:
        try:
            reply = http_json("GET", f"http://{url}/cluster/leases",
                              timeout=3)
            if pred(reply):
                return reply
        except (ConnectionError, HttpError):
            pass
        time.sleep(0.2)
    raise AssertionError(f"lease predicate never held: {reply}")


def test_lease_grants_survive_failover_without_overlap(trio):
    """A term-N lease grant is committed before it reaches the holder: the
    term-N+1 leader serves it, and its own grants start past it."""
    masters, vs = trio
    old_leader = _wait_unique_leader(masters)
    assert _assign(old_leader.url).get("fid")
    before = _wait_leases(old_leader.url, lambda r: r["leases"])
    old = {l["vid"]: l for l in before["leases"]}
    assert old and before["counters"]["grant"] >= 1
    deadline = time.time() + 15
    while time.time() < deadline and not vs._leases:
        time.sleep(0.1)
    assert vs._leases, "holder never installed the granted lease"
    max_epoch = max(l["epoch"] for l in old.values())
    high_water = max(l["key_hi"] for l in old.values())

    heal = _partition(old_leader)
    try:
        survivors = [m for m in masters if m is not old_leader]
        new_leader = _wait_unique_leader(survivors, timeout=30)
        assert new_leader is not old_leader
        after = {l["vid"]: l for l in _wait_leases(
            new_leader.url,
            lambda r: {l["vid"] for l in r["leases"]} >= set(old))["leases"]}
        for vid, l in old.items():
            assert (after[vid]["key_lo"], after[vid]["key_hi"],
                    after[vid]["epoch"]) == \
                (l["key_lo"], l["key_hi"], l["epoch"])
        # the holder chases the 409s to the new leader
        deadline = time.time() + 20
        while time.time() < deadline and not new_leader.topo.all_nodes():
            time.sleep(0.1)
        assert new_leader.topo.all_nodes(), \
            "holder never re-registered with the new leader"
        out = http_json("GET", f"http://{new_leader.url}/dir/assign"
                               f"?collection=leasechurn", timeout=5)
        assert out.get("fid"), out
        fresh = _wait_leases(
            new_leader.url,
            lambda r: any(l["epoch"] > max_epoch for l in r["leases"]))
        for l in fresh["leases"]:
            if l["epoch"] > max_epoch:
                assert l["key_lo"] > high_water, (l, high_water)
    finally:
        heal()


def test_lease_snapshot_roundtrip_floors_sequence():
    """A compacted follower restoring from a snapshot ends with the full
    grant table and a sequence floor past every leased range."""
    a = MasterServer()
    lease = {"vid": 7, "holder": "h:1", "holder_public": "h:1",
             "key_lo": 5000, "key_hi": 9095, "epoch": 3,
             "expires_at": time.time() + 30, "collection": "",
             "replication": "000", "replicas": []}
    a._apply_lease(lease)
    snap = a._raft_snapshot_state()
    assert snap["leases"]["7"]["epoch"] == 3
    assert snap["sequence"] >= 9096
    b = MasterServer()
    b._apply_lease(dict(lease, vid=9, epoch=5, key_lo=20000,
                        key_hi=24095))
    b._restore_raft_snapshot(snap)
    assert b.leases[7]["key_lo"] == 5000
    assert b.leases[9]["epoch"] == 5
    assert b._seq_ckpt >= 9096
    assert b._lease_epoch >= 3
    b._apply_lease(dict(lease, epoch=2, key_lo=1, key_hi=4096))
    assert b.leases[7]["epoch"] == 3 and b.leases[7]["key_lo"] == 5000
    for m in (a, b):
        m.http.stop()


def test_follower_proxies_read_endpoints(tmp_path):
    """Volume servers heartbeat only to the leader, so /dir/lookup and
    /dir/status on a follower proxy to the leader."""
    masters, urls = _group()
    vs = None
    try:
        leader = _wait_unique_leader(masters)
        vs = _port_vs([str(tmp_path / "v")], urls)
        vs.start()
        deadline = time.time() + 15
        while time.time() < deadline and not leader.topo.all_nodes():
            time.sleep(0.1)
        a = _assign(leader.url)
        vid = int(a["fid"].split(",")[0])
        follower = next(m for m in masters if m is not leader)
        out = http_json(
            "GET", f"http://{follower.url}/dir/lookup?volumeId={vid}")
        assert [l["url"] for l in out["locations"]] == [vs.url]
        topo = http_json("GET", f"http://{follower.url}/dir/status")
        assert topo["Topology"]["data_centers"]
        # writes on a follower answer 409 with the leader's url
        status, body, _ = http_call(
            "POST", f"http://{follower.url}/cluster/raft/add",
            json_body={"peer": "127.0.0.1:1"})
        assert status == 409 and json.loads(body)["leader"] == leader.url
    finally:
        if vs is not None:
            vs.stop()
        for m in masters:
            m.stop()


def test_removed_peer_cannot_depose_leader():
    """A removed node's election loop neither walks the cluster's term up
    nor wins votes."""
    masters, urls = _group()
    try:
        leader = _wait_unique_leader(masters)
        follower = next(m for m in masters if m is not leader)
        run_command(ShellContext(leader.url),
                    f"cluster.raft.remove -peer {follower.url}")
        others = [m for m in masters if m is not follower]
        deadline = time.time() + 5
        while time.time() < deadline:
            if all(follower.url not in m.raft.peers for m in others):
                break
            time.sleep(0.1)
        term_before = leader.raft.current_term
        time.sleep(3.5)  # several election timeouts for a coup
        assert leader.is_leader()
        assert leader.raft.current_term == term_before
        assert not follower.is_leader() or follower.raft.peers == []
    finally:
        for m in masters:
            m.stop()


def test_membership_survives_restart(tmp_path):
    """Committed membership outlives a restart even when the boot -peers
    list is stale (the persisted peers win)."""
    dirs = [tmp_path / f"m{i}" for i in range(3)]
    for d in dirs:
        d.mkdir()
    masters = [MasterServer(meta_dir=str(d)) for d in dirs]
    for m in masters:
        m.start()
    urls = [m.url for m in masters]
    try:
        for m in masters:
            m.set_peers(urls)
        leader = _wait_unique_leader(masters)
        victim = next(m for m in masters if m is not leader)
        run_command(ShellContext(leader.url),
                    f"cluster.raft.remove -peer {victim.url}")
        survivor = next(m for m in masters
                        if m is not leader and m is not victim)
        deadline = time.time() + 5
        while time.time() < deadline and \
                victim.url in survivor.raft.peers:
            time.sleep(0.1)
        assert victim.url not in survivor.raft.peers
        si = masters.index(survivor)
        survivor.stop()
        restarted = MasterServer(meta_dir=str(dirs[si]))
        restarted.start()
        restarted.set_peers(urls)  # stale boot list includes the victim
        try:
            assert victim.url not in restarted.raft.peers
        finally:
            restarted.stop()
    finally:
        for m in masters:
            m.stop()


def test_cluster_raft_ps_add_remove():
    masters, urls = _group()
    try:
        leader = _wait_unique_leader(masters)
        sh = ShellContext(masters[0].url)  # may or may not be the leader
        ps = run_command(sh, "cluster.raft.ps")
        assert set(ps["peers"]) | {ps["id"]} == set(urls)
        follower = next(m for m in masters if m is not leader)
        out = run_command(sh, f"cluster.raft.remove -peer {follower.url}")
        assert follower.url not in out["peers"]
        others = [m for m in masters if m is not follower]
        deadline = time.time() + 5
        while time.time() < deadline:
            if all(follower.url not in m.raft.peers for m in others):
                break
            time.sleep(0.1)
        assert all(follower.url not in m.raft.peers for m in others)
        leader2 = _wait_unique_leader(others)
        run_command(sh, f"cluster.raft.add -peer {follower.url}")
        deadline = time.time() + 5
        while time.time() < deadline:
            if all(follower.url in m.raft.peers for m in others):
                break
            time.sleep(0.1)
        assert all(follower.url in m.raft.peers for m in others)
        with pytest.raises(RuntimeError, match="cannot remove"):
            run_command(ShellContext(leader2.url),
                        f"cluster.raft.remove -peer {leader2.url}")
    finally:
        for m in masters:
            m.stop()


# ---------------- failover with an EC volume, against an all-JAX stack ----


PORT = types.SimpleNamespace(
    Master=master.MasterServer, VS=_port_vs, Shell=ShellContext,
    random_mods=(master, topology, volume_growth))
JAX = types.SimpleNamespace(
    Master=jmaster.MasterServer, VS=JVolumeServer, Shell=JShellContext,
    random_mods=(jmaster, jtopology, jgrowth))


def _free_ports(n):
    """n free loopback ports in ascending order, so the servers' urls sort
    in the order they start in both stacks."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return sorted(s.getsockname()[1] for s in socks)
    finally:
        for s in socks:
            s.close()


def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _nodes(m):
    return {n.url for n in m.topo.all_nodes()}


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _ha_ec_script(stack, tmp_path, monkeypatch):
    """Three masters with peers, four servers on racks r0 / r1; 24 seeded
    needles written under fixed fids into the one volume the leader grows;
    ec.encode; the server holding the most shards stopped, then the leader
    killed; the three live servers re-register with the new leader; one
    upload; ec.rebuild through the new leader's shell; every needle read.
    Returns what is compared, by server index."""
    for i, mod in enumerate(stack.random_mods):
        monkeypatch.setattr(mod, "random", random.Random(11 + i))
    masters = [stack.Master(volume_size_limit_mb=64) for _ in range(3)]
    for m in masters:
        m.start()
    urls = [m.url for m in masters]
    servers, live = [], []
    out = {}
    try:
        for m in masters:
            m.set_peers(urls)
        leader = _wait_unique_leader(masters)
        for i, port in enumerate(_free_ports(4)):
            vs = stack.VS([str(tmp_path / f"v{i}")], urls, port=port,
                          rack=f"r{i % 2}", data_center="dc1",
                          assign_leases=False)
            vs.start()
            servers.append(vs)
            live.append(vs)
            _wait(lambda: len(_nodes(leader)) == i + 1,
                  f"volume server {i} to reach the leader")
        idx = {vs.url: i for i, vs in enumerate(servers)}
        a = http_json("GET", f"http://{leader.url}/dir/assign")
        vid = int(a["fid"].split(",")[0])
        holder = a["url"]
        rng = np.random.default_rng(5)
        files = []
        for key in range(1, 25):
            data = rng.integers(0, 256, int(rng.integers(500, 150_000)),
                                dtype=np.uint8).tobytes()
            fid = f"{vid},{key:x}{0x1234abcd:08x}"
            status, _, _ = http_call("POST", f"http://{holder}/{fid}",
                                     body=data)
            assert status == 201, status
            files.append((fid, data))
        sh = stack.Shell(leader.url)
        sh.lock()
        enc = sh.ec_encode(vid=vid)
        sh.unlock()
        out["placement"] = {idx[t]: s
                            for t, s in enc[0]["placement"].items()}
        out["source"] = idx[enc[0]["source"]]
        out["shards"] = {sid: [(i, _sha(tmp_path / f"v{i}" /
                                        f"{vid}{layout.shard_ext(sid)}"))
                               for i in range(4)
                               if (tmp_path / f"v{i}" /
                                   f"{vid}{layout.shard_ext(sid)}").exists()]
                         for sid in range(TOTAL)}
        held = {i: (len(s), 0 in s) for i, s in out["placement"].items()}
        victim = servers[max(held, key=held.get)]
        victim.stop()
        live.remove(victim)
        out["victim"] = idx[victim.url]
        max_vid = leader.topo.max_volume_id
        leader.stop()
        followers = [m for m in masters if m is not leader]
        new_leader = _wait_unique_leader(followers, timeout=60)
        assert new_leader.topo.max_volume_id >= max_vid
        _wait(lambda: _nodes(new_leader) == {vs.url for vs in live},
              "the live servers to re-register with the new leader",
              timeout=60)
        # a fid minted after the failover reuses no volume id or key
        # minted before it
        a2 = http_json("GET", f"http://{new_leader.url}/dir/assign")
        vid2, rest2 = a2["fid"].split(",")
        assert int(vid2) > max_vid
        assert int(rest2[:-8], 16) > int(a["fid"].split(",")[1][:-8], 16)
        sh2 = stack.Shell(new_leader.url)
        sh2.lock()
        plans = sh2.ec_rebuild()
        sh2.unlock()
        assert len(plans) == 1 and "rebuilt" in plans[0], plans
        rb = idx[plans[0]["rebuilder"]]
        out["rebuild"] = {"rebuilder": rb,
                          "rebuilt": sorted(plans[0]["rebuilt"])}
        out["rebuilt_sha"] = {
            sid: _sha(tmp_path / f"v{rb}" / f"{vid}{layout.shard_ext(sid)}")
            for sid in out["rebuild"]["rebuilt"]}
        urls_live = sorted(vs.url for vs in live)
        out["gets"] = []
        for i, (fid, data) in enumerate(files):
            status, body, _ = http_call(
                "GET", f"http://{urls_live[i % len(urls_live)]}/{fid}")
            out["gets"].append((status, body == data))
        return out
    finally:
        for vs in live:
            vs.stop()
        for m in masters:
            m.stop()


def test_failover_with_ec_volume_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: FIXED_NS)
    want = _ha_ec_script(JAX, tmp_path / "jax", monkeypatch)
    got = _ha_ec_script(PORT, tmp_path / "port", monkeypatch)
    assert got == want
    assert got["gets"] == [(200, True)] * 24
    assert len(got["placement"]) == 4
    assert all(len(v) == 1 for v in got["shards"].values())
    assert got["rebuild"]["rebuilt"] == \
        sorted(got["placement"][got["victim"]])
    original = {sid: v[0][1] for sid, v in got["shards"].items()}
    assert got["rebuilt_sha"] == {sid: original[sid]
                                  for sid in got["rebuild"]["rebuilt"]}
