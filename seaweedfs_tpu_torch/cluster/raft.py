"""Raft consensus for the master group.

The reference runs raft for master HA (weed/server/raft_server.go — a
goraft fork — and raft_hashicorp.go), replicating MaxVolumeId commands
(weed/topology/cluster_commands.go) and snapshotting topology state.
This is a from-scratch implementation of the same protocol over the
masters' HTTP/JSON plane:

- leader election with randomized timeouts, persisted term + vote
- replicated log with the standard AppendEntries consistency check
- commit on majority match, entries applied in order via ``apply_fn``
- log compaction: snapshot of the applied state (``snapshot_fn`` /
  ``restore_fn``) + InstallSnapshot for lagging followers

Node ids are the masters' "host:port" HTTP urls; RPCs travel as JSON
POSTs to /raft/vote, /raft/append, /raft/snapshot on the peer masters.

The port's copy of seaweedfs_tpu/cluster/raft.py, the same code over the
port's utils.httpd and utils.clockctl: a group may mix nodes of both
packages, since the messages are the same JSON. It takes no device and
imports nothing of that package.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable, Optional

from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.utils.httpd import http_json

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

COMPACT_THRESHOLD = 4096  # applied entries kept before snapshotting


def _default_send(peer: str, path: str, body: dict, timeout: float) -> dict:
    return http_json("POST", f"http://{peer}{path}", body, timeout=timeout)


class RaftNode:
    def __init__(self, node_id: str, peers: list[str],
                 apply_fn: Callable[[dict], None],
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 restore_fn: Optional[Callable[[dict], None]] = None,
                 state_path: str = "",
                 send_fn: Callable = _default_send,
                 election_timeout: tuple[float, float] = (0.8, 1.6),
                 heartbeat_interval: float = 0.25,
                 compact_threshold: int = COMPACT_THRESHOLD):
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn or (lambda: {})
        self.restore_fn = restore_fn or (lambda s: None)
        self.state_path = state_path
        self.send = send_fn
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.compact_threshold = compact_threshold

        # persistent state
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self.log: list[dict] = []  # {"term": int, "command": dict}
        # snapshot covers log indices 1..snap_index (1-based, inclusive)
        self.snap_index = 0
        self.snap_term = 0
        self.snap_state: dict = {}

        # volatile state
        self.state = FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}

        self.lock = threading.RLock()
        self._commit_cond = threading.Condition(self.lock)
        self._last_heartbeat = clockctl.monotonic()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # check-quorum state: last successful round-trip per peer, and
        # one in-flight append per peer so slow peers don't pile threads
        self._peer_acked: dict[str, float] = {}
        self._inflight: set[str] = set()
        # index of the no-op barrier appended on election; the leader is
        # not "ready" (safe to serve) until it commits, which also
        # commits every inherited prior-term entry
        self._noop_index = 0
        self._load()

    # ---- index helpers (log is 1-based through the snapshot) ----
    def _last_index(self) -> int:
        return self.snap_index + len(self.log)

    def _term_at(self, index: int) -> int:
        if index == self.snap_index:
            return self.snap_term
        if index == 0:
            return 0
        return self.log[index - self.snap_index - 1]["term"]

    def _entry_at(self, index: int) -> dict:
        return self.log[index - self.snap_index - 1]

    # ---- persistence ----
    def _load(self) -> None:
        if not self.state_path or not os.path.exists(self.state_path):
            return
        try:
            with open(self.state_path) as f:
                st = json.load(f)
        except (OSError, ValueError):
            return
        self.current_term = st.get("term", 0)
        self.voted_for = st.get("voted_for")
        self.log = st.get("log", [])
        self.snap_index = st.get("snap_index", 0)
        self.snap_term = st.get("snap_term", 0)
        self.snap_state = st.get("snap_state", {})
        if "peers" in st:
            # committed membership changes override the boot -peers
            # list (the operator's flag predates them)
            self.peers = [p for p in st["peers"] if p != self.id]
        if self.snap_state:
            self.restore_fn(self.snap_state)
            if "peers" not in st:
                # fallback for pre-membership state files only: the
                # persisted peer list is written on every _persist and is
                # therefore always >= the snapshot's age — letting the
                # snapshot's member set win here would revert a
                # membership change committed after the last compaction
                self._apply_snapshot_membership(self.snap_state)
        self.commit_index = self.last_applied = self.snap_index
        # re-apply entries that were committed before shutdown is not
        # possible to know — raft re-commits them once a leader emerges

    def _persist(self) -> None:
        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"term": self.current_term,
                           "voted_for": self.voted_for,
                           "log": self.log,
                           "peers": self.peers,
                           "snap_index": self.snap_index,
                           "snap_term": self.snap_term,
                           "snap_state": self.snap_state}, f)
            os.replace(tmp, self.state_path)
        except OSError:
            pass

    # ---- lifecycle ----
    def start(self) -> None:
        t = threading.Thread(target=self._ticker, daemon=True,
                             name="raft-ticker")
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        with self.lock:
            self._persist()

    def _ticker(self) -> None:
        while not self._stop.wait(0.05):
            with self.lock:
                state = self.state
                elapsed = clockctl.monotonic() - self._last_heartbeat
                timeout = self._current_timeout
            if state == LEADER:
                self._check_quorum()
                self._broadcast_append()
                self._stop.wait(self.heartbeat_interval)
            elif elapsed >= timeout:
                self._start_election()

    def _check_quorum(self) -> None:
        """Step down if a majority of peers has been unreachable for a
        full election timeout — a partitioned leader must stop serving
        (prevents split-brain writes on the minority side)."""
        with self.lock:
            if self.state != LEADER or not self.peers:
                return
            lease = self.election_timeout[1]
            now = clockctl.monotonic()
            fresh = sum(1 for p in self.peers
                        if now - self._peer_acked.get(p, 0) < lease)
            # self counts toward the majority
            if (fresh + 1) * 2 <= len(self.peers) + 1:
                self.state = FOLLOWER
                self.leader_id = None
                self._reset_election_timer()
                self._commit_cond.notify_all()

    @property
    def _current_timeout(self) -> float:
        # randomized per-node, re-rolled on each reset
        if not hasattr(self, "_timeout_roll"):
            self._timeout_roll = random.uniform(*self.election_timeout)
        return self._timeout_roll

    def _reset_election_timer(self) -> None:
        self._last_heartbeat = clockctl.monotonic()
        self._timeout_roll = random.uniform(*self.election_timeout)

    # ---- election ----
    def _start_election(self) -> None:
        with self.lock:
            if not self.peers:
                # single-node group: self-elect immediately
                self.current_term += 1
                self._become_leader_locked()
                return
            self.state = CANDIDATE
            self.current_term += 1
            self.voted_for = self.id
            self._persist()
            term = self.current_term
            self._reset_election_timer()
            last_idx = self._last_index()
            last_term = self._term_at(last_idx)
        votes = [self.id]
        votes_lock = threading.Lock()
        done = threading.Event()

        def ask(peer: str):
            try:
                resp = self.send(peer, "/raft/vote", {
                    "term": term, "candidate_id": self.id,
                    "last_log_index": last_idx,
                    "last_log_term": last_term}, 1.0)
            except Exception:
                return
            with self.lock:
                if resp.get("term", 0) > self.current_term:
                    self._step_down(resp["term"])
                    done.set()
                    return
            if resp.get("vote_granted"):
                with votes_lock:
                    votes.append(peer)
                    if len(votes) * 2 > len(self.peers) + 1:
                        done.set()

        threads = [threading.Thread(target=ask, args=(p,), daemon=True,
                                    name="raft-vote")
                   for p in self.peers]
        for t in threads:
            t.start()
        done.wait(timeout=1.0)
        with self.lock:
            if (self.state == CANDIDATE and self.current_term == term
                    and len(votes) * 2 > len(self.peers) + 1):
                self._become_leader_locked()

    def _become_leader_locked(self) -> None:
        self.state = LEADER
        self.leader_id = self.id
        nxt = self._last_index() + 1
        self.next_index = {p: nxt for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        now = clockctl.monotonic()
        self._peer_acked = {p: now for p in self.peers}  # quorum grace
        # no-op barrier: committing it commits every inherited
        # prior-term entry (raft §8); is_ready() gates on it
        self.log.append({"term": self.current_term,
                         "command": {"type": "noop"}})
        self._noop_index = self._last_index()
        self._persist()

    def is_ready(self) -> bool:
        """Leader with its election no-op committed — all prior-term
        entries are applied, so the state machine is current."""
        with self.lock:
            return (self.state == LEADER
                    and self.commit_index >= self._noop_index)

    def wait_ready(self, timeout: float = 5.0) -> bool:
        deadline = clockctl.monotonic() + timeout
        with self._commit_cond:
            while not (self.state == LEADER
                       and self.commit_index >= self._noop_index):
                if self.state != LEADER:
                    return False
                remaining = deadline - clockctl.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return False
                self._commit_cond.wait(min(remaining, 0.1))
        return True

    def _step_down(self, term: int) -> None:
        self.current_term = term
        self.state = FOLLOWER
        self.voted_for = None
        self._persist()
        self._reset_election_timer()

    # ---- leader replication ----
    def _broadcast_append(self) -> None:
        with self.lock:
            if self.state != LEADER:
                return
            # one in-flight append per peer; a slow peer must not
            # accumulate a backlog of threads and stale responses
            peers = [p for p in self.peers if p not in self._inflight]
            self._inflight.update(peers)
        for peer in peers:
            threading.Thread(target=self._replicate_to, args=(peer,),
                             daemon=True, name="raft-replicate").start()
        if not self.peers:
            # single-node: everything is instantly committed
            with self._commit_cond:
                self._advance_commit_locked()

    def _replicate_to(self, peer: str) -> None:
        try:
            self._replicate_to_inner(peer)
        finally:
            with self.lock:
                self._inflight.discard(peer)

    def _replicate_to_inner(self, peer: str) -> None:
        with self.lock:
            if self.state != LEADER:
                return
            term = self.current_term
            nxt = self.next_index.get(peer, self._last_index() + 1)
            need_snapshot = nxt <= self.snap_index
            if not need_snapshot:
                prev_idx = nxt - 1
                prev_term = self._term_at(prev_idx)
                entries = [self._entry_at(i)
                           for i in range(nxt, self._last_index() + 1)]
                commit = self.commit_index
        if need_snapshot:
            self._send_snapshot(peer, term)
            return
        try:
            resp = self.send(peer, "/raft/append", {
                "term": term, "leader_id": self.id,
                "prev_log_index": prev_idx, "prev_log_term": prev_term,
                "entries": entries, "leader_commit": commit}, 2.0)
        except Exception:
            return
        with self._commit_cond:
            if resp.get("term", 0) > self.current_term:
                self._step_down(resp["term"])
                return
            if self.state != LEADER or self.current_term != term:
                return
            self._peer_acked[peer] = clockctl.monotonic()
            if resp.get("success"):
                # max(): a stale response must never regress the indices
                m = max(self.match_index.get(peer, 0),
                        prev_idx + len(entries))
                self.match_index[peer] = m
                self.next_index[peer] = max(self.next_index.get(peer, 1),
                                            m + 1)
                self._advance_commit_locked()
            else:
                # consistency check failed: back off
                hint = resp.get("conflict_index")
                self.next_index[peer] = max(
                    1, hint if hint else self.next_index.get(peer, 2) - 1)

    def _send_snapshot(self, peer: str, term: int) -> None:
        with self.lock:
            body = {"term": term, "leader_id": self.id,
                    "last_included_index": self.snap_index,
                    "last_included_term": self.snap_term,
                    "state": self.snap_state}
            snap_index = self.snap_index
        try:
            resp = self.send(peer, "/raft/snapshot", body, 5.0)
        except Exception:
            return
        with self.lock:
            if resp.get("term", 0) > self.current_term:
                self._step_down(resp["term"])
                return
            self._peer_acked[peer] = clockctl.monotonic()
            self.match_index[peer] = max(self.match_index.get(peer, 0),
                                         snap_index)
            self.next_index[peer] = max(self.next_index.get(peer, 1),
                                        snap_index + 1)

    def _advance_commit_locked(self) -> None:
        """Commit the highest index replicated on a majority whose entry
        is from the current term, then apply."""
        for n in range(self._last_index(), self.commit_index, -1):
            if self._term_at(n) != self.current_term:
                break
            count = 1 + sum(1 for p in self.peers
                            if self.match_index.get(p, 0) >= n)
            if count * 2 > len(self.peers) + 1:
                self.commit_index = n
                break
        self._apply_committed_locked()
        self._commit_cond.notify_all()

    def _apply_committed_locked(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self._entry_at(self.last_applied)
            cmd = entry["command"]
            if cmd.get("type") == "noop":  # internal election barrier
                continue
            try:
                self.apply_fn(cmd)
            except Exception:
                pass
        self._maybe_compact_locked()

    def _maybe_compact_locked(self) -> None:
        applied_in_log = self.last_applied - self.snap_index
        if applied_in_log < self.compact_threshold:
            return
        # carry the member set inside the snapshot: compaction may drop
        # raft_config entries from the log, and a follower caught up
        # via snapshot must still learn the committed membership
        self.snap_state = {**self.snapshot_fn(),
                           "_raft_members": sorted(self.peers + [self.id])}
        self.snap_term = self._term_at(self.last_applied)
        self.log = self.log[applied_in_log:]
        self.snap_index = self.last_applied
        self._persist()

    # ---- client API ----
    # ---- membership (reference raft AddServer/RemoveServer, shell
    # cluster.raft.add/remove). Single-step changes: safe when applied
    # one at a time through the log, which is how the shell drives it.
    def add_peer(self, peer: str) -> None:
        with self.lock:
            if peer == self.id or peer in self.peers:
                return
            self.peers.append(peer)
            if self.state == LEADER:
                self.next_index[peer] = self._last_index() + 1
                self.match_index[peer] = 0
                self._peer_acked[peer] = clockctl.monotonic()
            self._persist()

    def remove_peer(self, peer: str) -> None:
        with self.lock:
            if peer not in self.peers:
                return
            self.peers.remove(peer)
            self.next_index.pop(peer, None)
            self.match_index.pop(peer, None)
            self._peer_acked.pop(peer, None)
            self._persist()

    def membership(self) -> dict:
        with self.lock:
            return {"id": self.id, "peers": list(self.peers),
                    "leader": self.leader_id, "term": self.current_term,
                    "state": self.state,
                    "commit_index": self.commit_index}

    def propose(self, command: dict, timeout: float = 5.0) -> bool:
        """Leader-only: append, replicate, wait for commit."""
        with self._commit_cond:
            if self.state != LEADER:
                raise NotLeaderError(self.leader_id)
            self.log.append({"term": self.current_term, "command": command})
            index = self._last_index()
            self._persist()
        self._broadcast_append()
        deadline = clockctl.monotonic() + timeout
        with self._commit_cond:
            while self.commit_index < index:
                remaining = deadline - clockctl.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return False
                if self.state != LEADER:
                    raise NotLeaderError(self.leader_id)
                self._commit_cond.wait(min(remaining, 0.1))
        return True

    # ---- RPC handlers (wired to HTTP routes by the master) ----
    def _apply_snapshot_membership(self, state: dict) -> None:
        members = state.get("_raft_members")
        if members:
            self.peers = [p for p in members if p != self.id]

    def on_request_vote(self, body: dict) -> dict:
        with self.lock:
            term = body["term"]
            candidate = body["candidate_id"]
            if candidate not in self.peers and candidate != self.id:
                # a removed (or not-yet-added) node must not depose the
                # leader or win votes — reject WITHOUT adopting its
                # term, or its election loop walks our term forever
                return {"term": self.current_term, "vote_granted": False}
            if term > self.current_term:
                self._step_down(term)
            granted = False
            if term == self.current_term and self.voted_for in (
                    None, body["candidate_id"]):
                last_idx = self._last_index()
                last_term = self._term_at(last_idx)
                up_to_date = (body["last_log_term"], body["last_log_index"]) \
                    >= (last_term, last_idx)
                if up_to_date:
                    granted = True
                    self.voted_for = body["candidate_id"]
                    self._persist()
                    self._reset_election_timer()
            return {"term": self.current_term, "vote_granted": granted}

    def on_append_entries(self, body: dict) -> dict:
        with self._commit_cond:
            term = body["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term:
                self._step_down(term)
            self.state = FOLLOWER
            self.leader_id = body["leader_id"]
            self._reset_election_timer()

            prev_idx = body["prev_log_index"]
            if prev_idx > self._last_index():
                return {"term": self.current_term, "success": False,
                        "conflict_index": self._last_index() + 1}
            if prev_idx >= self.snap_index and \
                    self._term_at(prev_idx) != body["prev_log_term"]:
                # find first index of the conflicting term
                conflict_term = self._term_at(prev_idx)
                ci = prev_idx
                while ci > self.snap_index + 1 and \
                        self._term_at(ci - 1) == conflict_term:
                    ci -= 1
                return {"term": self.current_term, "success": False,
                        "conflict_index": ci}
            # append, truncating any conflicting suffix
            idx = prev_idx
            for entry in body["entries"]:
                idx += 1
                if idx <= self.snap_index:
                    continue
                pos = idx - self.snap_index - 1
                if pos < len(self.log):
                    if self.log[pos]["term"] != entry["term"]:
                        del self.log[pos:]
                        self.log.append(entry)
                else:
                    self.log.append(entry)
            if body["entries"]:
                self._persist()
            if body["leader_commit"] > self.commit_index:
                self.commit_index = min(body["leader_commit"],
                                        self._last_index())
                self._apply_committed_locked()
                self._commit_cond.notify_all()
            return {"term": self.current_term, "success": True}

    def on_install_snapshot(self, body: dict) -> dict:
        with self._commit_cond:
            term = body["term"]
            if term < self.current_term:
                return {"term": self.current_term}
            if term > self.current_term:
                self._step_down(term)
            self.state = FOLLOWER
            self.leader_id = body["leader_id"]
            self._reset_election_timer()
            idx = body["last_included_index"]
            if idx <= self.snap_index:
                return {"term": self.current_term}
            # discard covered log; keep any suffix past the snapshot
            if idx <= self._last_index() and \
                    self._term_at(idx) == body["last_included_term"]:
                self.log = self.log[idx - self.snap_index:]
            else:
                self.log = []
            self.snap_index = idx
            self.snap_term = body["last_included_term"]
            self.snap_state = body["state"]
            self.restore_fn(self.snap_state)
            self._apply_snapshot_membership(self.snap_state)
            self.commit_index = max(self.commit_index, idx)
            self.last_applied = max(self.last_applied, idx)
            self._persist()
            return {"term": self.current_term}


class NotLeaderError(RuntimeError):
    def __init__(self, leader: Optional[str]):
        super().__init__(f"not the raft leader (leader: {leader})")
        self.leader = leader
