"""Live shard rebalancing: temperature-driven directory migration.

Two halves of one closed loop:

``RebalancePlanner`` lives on the MASTER.  Filer announce piggybacks
carry a ``shard_load`` blob (cumulative namespace-op count + the
Space-Saving top directories); the planner diffs successive cumulative
reports into windowed per-shard rates, and when the hottest shard's
rate exceeds ``threshold`` x the mean it emits a plan: move that
shard's hottest directories to the coolest shard.  A plan becomes real
only at COMMIT time — the master layers ``{dir: owner}`` overrides
over the consistent-hash ring (``ShardRing.with_overrides``, a
forward-only epoch bump) *after* the mover reports the rows copied, so
routing never names a shard that lacks the data.

``DirectoryMover`` lives on the SOURCE filer.  It is the
cross-shard-rename machinery re-aimed at bulk migration:

  1. record a meta-log cursor, then page the directory's child rows to
     the destination via ``/__api/entry`` (meta_only — chunks ride
     along verbatim, no data-plane copies), BACKGROUND-classed and
     token-bucketed like repair traffic;
  2. replay meta-log deltas (writes that landed during the copy)
     until a pass comes back empty;
  3. POST the master's ``/cluster/rebalance/commit`` — the ring flips,
     the source adopts the new epoch, and from here the 307 ladder
     moves clients to the new owner (dual-serve window: the source
     still HOLDS the rows, so a stale-ringed client reading through it
     pre-redirect still succeeds);
  4. a few post-flip delta passes catch requests that raced the flip,
     guarded by row mtime so a replay never clobbers a newer write
     that already landed at the destination;
  5. local rows are purged at the STORE level with explicit cache
     invalidation and NO meta-log notify — a migration is a change of
     address, not a delete, and sync sinks must not replicate it.

Zero client ops fail mid-migration: before the flip the source owns
and serves; after the flip it redirects while the delta/purge tail
runs.

The port's copy of seaweedfs_tpu/filer/rebalance.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Callable, Optional

from seaweedfs_tpu_torch.filer.shard_ring import ShardRing, _norm_dir
from seaweedfs_tpu_torch.utils import clockctl, glog
from seaweedfs_tpu_torch.utils import headers as weed_headers
from seaweedfs_tpu_torch.utils.limiter import TokenBucket
from seaweedfs_tpu_torch.qos import BACKGROUND, class_scope


class RebalancePlanner:
    """Windowed per-shard load rollup -> directory-move plans.

    Pure bookkeeping — it never talks HTTP.  The master feeds it
    ``observe()`` from announce piggybacks and asks ``plan()`` under
    its own cadence; dispatching move orders and applying overrides
    stay with the master (which owns the ring lock and leadership)."""

    def __init__(self, window_s: float = 60.0, threshold: float = 1.5,
                 min_rate: float = 5.0, max_moves_per_plan: int = 2,
                 cooldown_s: float = 120.0, min_share: float = 0.05):
        self.window_s = window_s
        # imbalance trigger: hottest shard rate / mean rate.  Below
        # min_rate ops/s total nothing moves — rebalancing an idle
        # cluster is pure churn
        self.threshold = threshold
        self.min_rate = min_rate
        self.max_moves_per_plan = max_moves_per_plan
        # a directory below this share of its shard's traffic is not
        # worth a migration: after the dominant directory moves, the
        # destination shard IS the new hottest — without this gate the
        # planner would keep shuffling its crumbs forever
        self.min_share = min_share
        # per-directory cooldown: a freshly moved directory is immune
        # so two planner rounds can't ping-pong it between shards
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        # url -> deque[(now, ops_cumulative, {dir: count})]
        self._samples: dict[str, deque] = {}
        # dir -> state: "moving" while a move order is in flight,
        # else the commit time (float) starting the cooldown clock
        self._moved: dict[str, object] = {}
        self.plans_emitted = 0
        self.commits = 0

    # ---- ingest ----
    def observe(self, url: str, report: dict,
                now: Optional[float] = None) -> None:
        """One announce piggyback: {"ops": <cumulative>, "dirs":
        [{"key": dir, "count": n}, ...]}."""
        if now is None:
            now = clockctl.now()
        try:
            ops = float(report.get("ops", 0))
        except (TypeError, ValueError):
            return
        dirs = {d.get("key", ""): float(d.get("count", 0))
                for d in report.get("dirs", []) if d.get("key")}
        with self._lock:
            q = self._samples.setdefault(url, deque(maxlen=64))
            q.append((now, ops, dirs))
            horizon = now - 2 * self.window_s
            while q and q[0][0] < horizon:
                q.popleft()

    def forget(self, url: str) -> None:
        with self._lock:
            self._samples.pop(url, None)

    # ---- planning ----
    def _rate(self, url: str, now: float) -> Optional[float]:
        """Windowed ops/s from the cumulative counter, None without
        two samples inside the window (a brand-new or silent shard
        must gate planning, not read as zero-load)."""
        q = self._samples.get(url)
        if not q:
            return None
        lo = None
        for t, ops, _ in q:
            if t >= now - self.window_s:
                lo = (t, ops)
                break
        hi = q[-1]
        if lo is None or hi[0] - lo[0] <= 0:
            return None
        # counter reset (filer restart) shows as a negative diff
        return max(0.0, (hi[1] - lo[1]) / (hi[0] - lo[0]))

    def plan(self, ring: Optional[ShardRing],
             now: Optional[float] = None,
             force: bool = False) -> Optional[dict]:
        """A move plan {"moves": [{"dir", "from", "to"}], ...} or None.
        Requires every ring member to have a computable rate — planning
        from a partial view would mistake silence for idleness."""
        if ring is None or len(ring) < 2:
            return None
        if now is None:
            now = clockctl.now()
        with self._lock:
            rates = {}
            for m in ring.members:
                r = self._rate(m, now)
                if r is None:
                    return None
                rates[m] = r
            mean = sum(rates.values()) / len(rates)
            hot = max(rates, key=lambda m: rates[m])
            cold = min(rates, key=lambda m: rates[m])
            if mean <= 0 or rates[hot] < self.min_rate:
                return None
            if rates[hot] / mean < self.threshold or hot == cold:
                return None
            # hottest directories the hot shard actually OWNS (the
            # sketch also sees directories it merely redirects for)
            _, _, dirs = self._samples[hot][-1]
            total_cnt = sum(dirs.values()) or 1.0
            candidates = []
            for d, cnt in sorted(dirs.items(),
                                 key=lambda kv: (-kv[1], kv[0])):
                d = _norm_dir(d)
                if d == "/" or ring.owner(d) != hot:
                    continue
                if cnt / total_cnt < self.min_share:
                    continue
                st = self._moved.get(d)
                if st == "moving":
                    continue
                if (not force and isinstance(st, float)
                        and now - st < self.cooldown_s):
                    continue
                candidates.append((d, cnt))
            if not candidates:
                return None
            moves, shed = [], 0.0
            for d, cnt in candidates[:self.max_moves_per_plan]:
                moves.append({"dir": d, "from": hot, "to": cold,
                              "share": cnt / total_cnt})
                self._moved[d] = "moving"
                shed += rates[hot] * (cnt / total_cnt)
                if rates[hot] - shed <= mean:
                    break
            self.plans_emitted += 1
            return {"moves": moves, "hot": hot, "cold": cold,
                    "rates": rates, "mean": mean,
                    "imbalance": rates[hot] / mean}

    def note_committed(self, directory: str,
                       now: Optional[float] = None) -> None:
        """The ring flipped for `directory`: start its cooldown."""
        with self._lock:
            self._moved[_norm_dir(directory)] = (
                now if now is not None else clockctl.now())
            self.commits += 1

    def note_failed(self, directory: str) -> None:
        """Move order died before commit: make the dir plannable again."""
        with self._lock:
            self._moved.pop(_norm_dir(directory), None)

    def status(self, now: Optional[float] = None) -> dict:
        if now is None:
            now = clockctl.now()
        with self._lock:
            return {
                "window_s": self.window_s,
                "threshold": self.threshold,
                "rates": {u: self._rate(u, now)
                          for u in sorted(self._samples)},
                "moving": sorted(d for d, s in self._moved.items()
                                 if s == "moving"),
                "cooldown": {d: round(now - s, 1)
                             for d, s in self._moved.items()
                             if isinstance(s, float)},
                "plans_emitted": self.plans_emitted,
                "commits": self.commits,
            }


class DirectoryMover:
    """Background executor of one-directory-at-a-time migrations on
    the source filer (the shard that owns the rows today)."""

    #: delta passes after the ring flip — the first catches requests
    #: that raced the flip, the second proves quiescence
    POST_FLIP_PASSES = 2

    def __init__(self, server,
                 rate_bytes_per_sec: float = 32e6,
                 commit: Optional[Callable[[str, str], dict]] = None,
                 linger_s: Optional[float] = None):
        self.server = server
        # migration is repair-shaped traffic: BACKGROUND class plus a
        # token bucket so a big directory can't starve foreground ops
        self.bucket = TokenBucket(rate_bytes_per_sec)
        # dual-serve linger between flip and purge: peers adopt the
        # new ring on their announce cadence, and a stale-ringed
        # peer's forwarded lookup must still find the rows here until
        # every peer has had a cycle to catch up
        self.linger_s = linger_s
        self._commit_fn = commit
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._state: dict = {"state": "idle", "dir": None, "to": None,
                             "rows_moved": 0, "rows_purged": 0,
                             "deltas_applied": 0, "moves_done": 0,
                             "error": None}

    # ---- public surface ----
    def start(self, directory: str, dest: str) -> bool:
        """Kick a migration; False when one is already running."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self._state.update({"state": "copy", "dir": directory,
                                "to": dest, "rows_moved": 0,
                                "rows_purged": 0, "deltas_applied": 0,
                                "error": None})
            self._thread = threading.Thread(
                target=self._run, args=(directory, dest),
                name="shard-mover", daemon=True)
            self._thread.start()
            return True

    def join(self, timeout: float = 60.0) -> bool:
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def status(self) -> dict:
        with self._lock:
            return dict(self._state)

    def _set(self, **kv) -> None:
        with self._lock:
            self._state.update(kv)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._state[key] += n

    # ---- protocol ----
    def _run(self, directory: str, dest: str) -> None:
        try:
            with class_scope(BACKGROUND):
                self._migrate(directory, dest)
            self._set(state="done")
            self._bump("moves_done")
        except Exception as e:
            glog.warning("shard mover %s -> %s failed: %s",
                         directory, dest, e)
            self._set(state="failed", error=str(e))

    def _migrate(self, directory: str, dest: str) -> None:
        from seaweedfs_tpu_torch.utils.httpd import HttpError, http_call
        srv = self.server
        filer = srv.filer
        directory = _norm_dir(directory)
        fwd = {weed_headers.SHARD_FORWARDED: "1"}

        def push_row(row: dict) -> None:
            body = {"entry": row, "meta_only": True}
            self.bucket.consume(len(json.dumps(body)))
            status, resp, _ = http_call(
                "POST", f"http://{dest}/__api/entry", json_body=body,
                headers=fwd, timeout=60)
            if status >= 400:
                raise HttpError(status, resp)

        # 1. cursor BEFORE the copy: every mutation that lands during
        # the page-through is replayed by a delta pass
        cursor = filer.meta_log.latest_tsns()
        self._set(state="copy")
        last = ""
        while True:
            rows = filer.store.inner.list_directory_entries(
                directory, start_name=last, limit=256)
            if not rows:
                break
            for e in rows:
                push_row(e.to_dict())
                self._bump("rows_moved")
            last = rows[-1].name

        # 2. drain deltas until quiet; the source still owns the
        # directory, so this converges as soon as writers pause for
        # one pass (and the flip below closes the window for good)
        self._set(state="delta")
        for _ in range(64):
            cursor, n = self._delta_pass(directory, dest, cursor,
                                         mtime_guard=False)
            if n == 0:
                break

        # 3. commit: the master layers {directory: dest} over the ring
        # and bumps the epoch; adopt it here so this filer's very next
        # request 307s to the new owner
        self._set(state="commit")
        ring_dict = self._commit(directory, dest)
        ring = ShardRing.from_dict(ring_dict)
        # destination FIRST, then self: once the source redirects, the
        # destination must already be serving the directory locally —
        # the reverse order opens a redirect-bounce window.  (It would
        # adopt on its next announce anyway; this closes the gap.)
        try:
            http_call("POST", f"http://{dest}/__api/shard/ring",
                      json_body=ring_dict, headers=fwd, timeout=10)
        except Exception as e:
            glog.vlog(1, "ring push to %s failed: %s", dest, e)
        cur = srv.shard_ring
        if cur is None or ring.epoch > cur.epoch:
            srv.set_shard_ring(ring)

        # 4. post-flip deltas: requests that raced the flip landed
        # here under the old epoch.  mtime guard — a replay must not
        # clobber a newer write already at the destination
        self._set(state="post_flip")
        linger = self.linger_s
        if linger is None:
            linger = 1.5 * getattr(srv, "announce_interval_s", 15.0)
        clockctl.sleep(min(linger, 30.0))
        for _ in range(self.POST_FLIP_PASSES):
            cursor, _ = self._delta_pass(directory, dest, cursor,
                                         mtime_guard=True)

        # 5. push-and-purge until quiet, at the STORE level with
        # explicit cache invalidation and NO meta-log notify — sync
        # sinks replaying a migration as deletes would destroy the
        # replica (contrast _rename_sharded, which notifies because
        # the path itself changes).  A request admitted under the old
        # epoch can still land a row HERE after the flip (it passed
        # routing before the adopt, then waited on the store lock);
        # re-pushing each row before deleting it — skipped when the
        # destination already holds a copy at least as fresh — turns
        # that race into a late arrival instead of a lost row, and the
        # quiet-twice loop outlasts the stragglers
        self._set(state="cleanup")
        cache = filer.entry_cache
        quiet = 0
        for _ in range(256):
            rows = filer.store.inner.list_directory_entries(
                directory, limit=256)
            if not rows:
                quiet += 1
                if quiet >= 2:
                    break
                clockctl.sleep(0.05)
                continue
            quiet = 0
            for e in rows:
                row = e.to_dict()
                if not self._dest_is_newer(dest, row):
                    push_row(row)
                filer.store.inner.delete_entry(e.full_path)
                if cache is not None:
                    cache.invalidate(e.full_path)
                self._bump("rows_purged")
        if cache is not None:
            cache.invalidate(directory)

    def _commit(self, directory: str, dest: str) -> dict:
        if self._commit_fn is not None:
            return self._commit_fn(directory, dest)
        from seaweedfs_tpu_torch.utils.httpd import http_json
        return http_json(
            "POST",
            f"http://{self.server.master_url}/cluster/rebalance/commit",
            {"dir": directory, "to": dest, "from": self.server.url},
            timeout=10)

    def _delta_pass(self, directory: str, dest: str, cursor: int,
                    mtime_guard: bool) -> tuple[int, int]:
        """Replay meta-log events for `directory` after `cursor` at the
        destination; -> (new_cursor, events_applied)."""
        from seaweedfs_tpu_torch.utils.httpd import HttpError, http_call
        from urllib.parse import quote
        filer = self.server.filer
        fwd = {weed_headers.SHARD_FORWARDED: "1"}
        events = filer.meta_log.read_since(cursor, path_prefix=directory)
        applied = 0
        for ev in events:
            cursor = max(cursor, ev.tsns)
            # read_since prefix-matches, so /hot also surfaces /hotel;
            # migration scope is exactly ONE directory's child rows
            if _norm_dir(ev.directory) != directory:
                continue
            row = ev.new_entry
            if row is not None:
                if mtime_guard and self._dest_is_newer(dest, row):
                    continue
                body = {"entry": row, "meta_only": True}
                self.bucket.consume(len(json.dumps(body)))
                status, resp, _ = http_call(
                    "POST", f"http://{dest}/__api/entry",
                    json_body=body, headers=fwd, timeout=60)
                if status >= 400:
                    raise HttpError(status, resp)
            elif ev.old_entry is not None:
                path = ev.old_entry.get("full_path", "")
                if path:
                    status, resp, _ = http_call(
                        "DELETE",
                        f"http://{dest}/__api/entry?path={quote(path)}",
                        headers=fwd, timeout=60)
                    if status >= 400 and status != 404:
                        raise HttpError(status, resp)
            applied += 1
        return cursor, applied

    def _dest_is_newer(self, dest: str, row: dict) -> bool:
        """True when the destination already holds a row at least as
        fresh as the event's — the replay must stand down."""
        from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json
        from urllib.parse import quote
        path = row.get("full_path", "")
        try:
            out = http_json(
                "GET",
                f"http://{dest}/__api/entry?path={quote(path)}&raw=true",
                timeout=10)
        except HttpError as e:
            if e.status == 404:
                return False
            raise
        except Exception:
            return False
        have = (out.get("entry") or {}).get("attr", {}).get("mtime", 0)
        want = (row.get("attr") or {}).get("mtime", 0)
        return have >= want
