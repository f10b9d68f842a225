"""Hinted-handoff journal: persisted per-(vid, needle) replica debts.

When a replicated write (or delete) reaches the primary plus a quorum
of its replica legs but misses a peer, the volume server records a
HINT — "peer P still owes needle (vid, key) op X" — and acks the
client instead of failing the whole fan-out (the Dynamo sloppy-quorum
contract; the Facebook warehouse study arXiv:1309.0186 shows transient
single-node unavailability dominates production faults, so
divergence-then-repair beats fail-the-write). A background drain on
the volume server replays pending hints through the raw needle-blob
transfer once the peer heals.

Format: append-only JSONL, one record per line.

    {"seq": 7, "op": "write", "vid": 3, "key": 23, "cookie": 9,
     "peer": "127.0.0.1:8081", "fid": "17c0b2a9", "ts": 1754000000.0}
    {"ack": 7}

Appends are the only hot-path writes (one line per missed leg, only
while a peer is down). Ack records accumulate until compaction
rewrites the file with just the still-pending hints. A torn tail line
from a crash mid-append is skipped on load — losing the newest hint
is recoverable (read-repair catches the divergence on the next read);
corrupting the journal is not.

Replay always reads the CURRENT local record for the key (not a
captured payload), so duplicate hints for one (op, vid, key, peer)
are folded into the earliest pending one.

The port's copy of seaweedfs_tpu/storage/hinted_handoff.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from seaweedfs_tpu_torch.utils import clockctl

# rewrite the file once this many ack rows accumulate — bounds journal
# growth at ~2x the peak pending set between compactions
COMPACT_ACKED_ROWS = 256


class HintJournal:
    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        # seq -> hint record (the pending set; acked rows are dropped)
        self._pending: dict[int, dict] = {}
        # (op, vid, key, peer) -> seq, for duplicate folding
        self._index: dict[tuple, int] = {}
        self._next_seq = 1
        self._acked_rows = 0
        self._fh = None
        self._load()

    # ---- persistence ----
    def _load(self) -> None:
        if os.path.exists(self.path):
            with open(self.path, "r") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail write from a crash
                    if "ack" in rec:
                        self._forget_locked(rec["ack"])
                        self._acked_rows += 1
                    elif "seq" in rec:
                        seq = int(rec["seq"])
                        # journals written before debts carried
                        # timestamps: age from load, not epoch zero
                        rec.setdefault("ts", clockctl.now())
                        self._pending[seq] = rec
                        self._index[self._key_of(rec)] = seq
                        self._next_seq = max(self._next_seq, seq + 1)
        self._fh = open(self.path, "a")

    @staticmethod
    def _key_of(rec: dict) -> tuple:
        return (rec.get("op"), rec.get("vid"), rec.get("key"),
                rec.get("peer"))

    def _forget_locked(self, seq: int) -> Optional[dict]:
        rec = self._pending.pop(seq, None)
        if rec is not None and self._index.get(self._key_of(rec)) == seq:
            del self._index[self._key_of(rec)]
        return rec

    def _append_locked(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    # ---- hint lifecycle ----
    def record(self, op: str, vid: int, key: int, cookie: int,
               peer: str, fid: str = "") -> int:
        """Persist one owed operation; returns its seq. A hint already
        pending for the same (op, vid, key, peer) is reused — replay
        reads the current local record, so one hint covers any number
        of missed overwrites."""
        with self._lock:
            existing = self._index.get((op, int(vid), int(key), peer))
            if existing is not None:
                return existing
            seq = self._next_seq
            self._next_seq += 1
            rec = {"seq": seq, "op": op, "vid": int(vid),
                   "key": int(key), "cookie": int(cookie),
                   "peer": peer, "fid": fid, "ts": clockctl.now()}
            self._pending[seq] = rec
            self._index[self._key_of(rec)] = seq
            self._append_locked(rec)
            return seq

    def ack(self, seq: int) -> None:
        """Mark one hint repaid. Compaction fires once enough ack rows
        pile up."""
        with self._lock:
            if self._forget_locked(seq) is None:
                return
            self._append_locked({"ack": seq})
            self._acked_rows += 1
            if self._acked_rows >= COMPACT_ACKED_ROWS:
                self._compact_locked()

    def pending(self) -> list[dict]:
        """Snapshot of unpaid hints in seq (arrival) order."""
        with self._lock:
            return sorted(self._pending.values(),
                          key=lambda r: r["seq"])

    def pending_for(self, peer: str) -> list[dict]:
        with self._lock:
            return sorted((r for r in self._pending.values()
                           if r["peer"] == peer),
                          key=lambda r: r["seq"])

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    # ---- maintenance ----
    def _compact_locked(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for rec in sorted(self._pending.values(),
                              key=lambda r: r["seq"]):
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a")
        self._acked_rows = 0

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def stats(self) -> dict:
        """Journal size and staleness, piggybacked on volume
        heartbeats so the telemetry plane can alert (hints_stale) on a
        wedged drain: oldest_debt_age_s is how long the OLDEST unpaid
        hint has been waiting — a healthy drain keeps it near zero
        once the peer heals."""
        with self._lock:
            oldest = min((r.get("ts", 0.0)
                          for r in self._pending.values()),
                         default=None)
            return {"path": self.path, "pending": len(self._pending),
                    "pending_rows": len(self._pending),
                    "oldest_debt_age_s": (
                        max(0.0, clockctl.now() - oldest)
                        if oldest is not None else 0.0),
                    "next_seq": self._next_seq,
                    "acked_rows": self._acked_rows}

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
