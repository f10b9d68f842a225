"""Always-on wall-stack sampling profiler + thread->scope registry.

Third leg of the observability stool: RED histograms say *what* is
slow, traces say *where in the request path*, this says *which code*.
A WallSampler is one dedicated daemon thread that walks
``sys._current_frames()`` at a low prime rate (default 19Hz — prime so
the sampler can't phase-lock with periodic work) and folds every
thread's stack into a bounded ``stack -> sample count`` table in the
standard folded format (``frame;frame;frame count``), directly
consumable by flamegraph tooling.

Attribution by construction: sampled stacks alone can't tell an
interactive read from a background scrub once both sit in the same
socket write.  So dispatch sites register the calling thread's ambient
scope — QoS class, route family, sampled trace id — in a process-wide
thread->scope registry (``tag()``/``untag()``; ``HttpServer._dispatch``
and the batcher/scrubber/repair workers re-enter it per unit of work),
and the sampler prefixes each folded stack with synthetic
``class:``/``route:`` root frames.  Untagged threads fold under their
``thread:<name>`` instead, so every long-lived thread is named.

Disabled path is ``_PASS``-grade, like NOOP spans: with no sampler
running, ``tag()`` is one module-global truthiness check and an
immediate return — no dict write, no allocation — and a sampler
constructed with ``hz=0`` never starts a thread.

The registry is a plain dict keyed by thread ident: each thread writes
only its own key and the sampler thread only reads, so the GIL's
per-op atomicity is the only synchronization needed (same reasoning as
``sys._current_frames()`` itself, which snapshots under the GIL).

The port's copy of seaweedfs_tpu/utils/profiler.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import sys
import threading
from contextlib import contextmanager
from typing import Iterable, Optional

DEFAULT_HZ = 19.0
# distinct folded stacks kept per sampler; the long tail lands in one
# overflow bucket so a pathological workload can't grow the table
DEFAULT_MAX_STACKS = 2048
MAX_DEPTH = 64
OVERFLOW_KEY = "(stack-table-overflow)"

# ---- thread -> ambient-scope registry (process-wide) -----------------

# ident -> (cls, route, trace_id); written by the owning thread only
_scopes: dict[int, tuple] = {}
# count of running samplers: the zero-cost gate for tag()
_active = 0


def tag(cls: Optional[str], route: Optional[str] = None,
        trace_id: Optional[str] = None):
    """Register the calling thread's ambient scope for the sampler.
    Returns a token for ``untag()``.  With no sampler running this is
    one global check and return — the zero-cost disabled path."""
    if not _active:
        return None
    ident = threading.get_ident()
    prev = _scopes.get(ident)
    _scopes[ident] = (cls, route, trace_id)
    return (ident, prev)


def untag(token) -> None:
    if token is None:
        return
    ident, prev = token
    if prev is None:
        _scopes.pop(ident, None)
    else:
        _scopes[ident] = prev


@contextmanager
def scope(cls: Optional[str] = None, route: Optional[str] = None,
          trace_id: Optional[str] = None):
    """Tag the calling thread for the duration of a with-block — the
    re-entry helper for worker loops (batcher dispatch, scrub passes,
    repair waves) that aren't HTTP requests."""
    token = tag(cls, route, trace_id)
    try:
        yield
    finally:
        untag(token)


# ---- folding ---------------------------------------------------------

def _frame_label(code) -> str:
    base = code.co_filename.rsplit("/", 1)[-1]
    if base.endswith(".py"):
        base = base[:-3]
    name = getattr(code, "co_qualname", code.co_name)
    # the folded format reserves ';' (frame separator) and ' ' (count
    # separator); qualnames like '<listcomp>' are fine
    return f"{base}.{name}".replace(";", ",").replace(" ", "_")


def _fold_stack(frame, prefix: list) -> str:
    parts = []
    depth = 0
    while frame is not None and depth < MAX_DEPTH:
        parts.append(_frame_label(frame.f_code))
        frame = frame.f_back
        depth += 1
    parts.reverse()  # folded format is root-first
    return ";".join(prefix + parts)


class WallSampler:
    """One sampling thread, one bounded folded-stack table.

    ``hz=0`` is the disabled sampler: ``start()`` is a no-op and
    ``window()`` returns an empty table — servers construct it
    unconditionally and the config decides whether it costs anything.
    """

    def __init__(self, hz: float = DEFAULT_HZ,
                 max_stacks: int = DEFAULT_MAX_STACKS):
        self.hz = float(hz)
        self.max_stacks = max_stacks
        self._counts: dict[str, int] = {}
        # folded stack -> last sampled trace id seen there (bounded by
        # the counts table: only admitted stacks get an exemplar)
        self._exemplars: dict[str, str] = {}
        self._total = 0
        self._ticks = 0
        self._errors = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ----
    def start(self) -> None:
        global _active
        if self.hz <= 0 or self._thread is not None:
            return
        _active += 1
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="wall-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        global _active
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None
        _active = max(0, _active - 1)

    @property
    def running(self) -> bool:
        return self._thread is not None

    # ---- sampling loop (dedicated thread) ----
    def _loop(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 — a torn frame walk
                self._errors += 1  # must never kill the sampler

    def _sample_once(self) -> None:
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        folded: list[tuple[str, Optional[str]]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue
            sc = _scopes.get(ident)
            if sc is not None:
                cls, route, tid = sc
                prefix = []
                if cls:
                    prefix.append(f"class:{cls}")
                if route:
                    prefix.append(f"route:{route}")
                if not prefix:
                    prefix = [f"thread:{names.get(ident, ident)}"]
            else:
                tid = None
                prefix = [f"thread:{names.get(ident, ident)}"]
            folded.append((_fold_stack(frame, prefix), tid))
        del frames  # drop frame refs before taking the lock
        with self._lock:
            for key, tid in folded:
                if key in self._counts \
                        or len(self._counts) < self.max_stacks:
                    self._counts[key] = self._counts.get(key, 0) + 1
                    if tid:
                        self._exemplars[key] = tid
                else:
                    self._counts[OVERFLOW_KEY] = \
                        self._counts.get(OVERFLOW_KEY, 0) + 1
            self._total += len(folded)
            self._ticks += 1

    # ---- export ----
    def snapshot(self) -> dict:
        """Cumulative folded table since start (mergeable: counts sum)."""
        with self._lock:
            return {"rate_hz": self.hz, "samples": self._total,
                    "ticks": self._ticks, "errors": self._errors,
                    "folded": dict(self._counts),
                    "exemplars": dict(self._exemplars)}

    def window(self, seconds: float) -> dict:
        """Folded-stack delta over the NEXT `seconds` (blocks the
        caller, not the sampler).  seconds<=0 returns the cumulative
        table — the no-wait form collectors use for quick sweeps."""
        if seconds <= 0 or not self.running:
            return self.snapshot()
        before = self.snapshot()
        self._stop.wait(seconds)  # stop() aborts the window early
        after = self.snapshot()
        base = before["folded"]
        folded = {}
        for key, count in after["folded"].items():
            d = count - base.get(key, 0)
            if d > 0:
                folded[key] = d
        return {"rate_hz": self.hz,
                "samples": after["samples"] - before["samples"],
                "ticks": after["ticks"] - before["ticks"],
                "errors": after["errors"], "seconds": seconds,
                "folded": folded,
                "exemplars": {k: v for k, v in
                              after["exemplars"].items() if k in folded}}


# ---- folded-table algebra (shared by /admin/profile consumers) -------

def merge_folded(tables: Iterable[dict]) -> dict:
    """Sum stack->count tables — node windows into a cluster profile."""
    out: dict[str, int] = {}
    for table in tables:
        for key, count in table.items():
            out[key] = out.get(key, 0) + count
    return out


def to_folded_text(table: dict) -> str:
    return "\n".join(f"{k} {v}"
                     for k, v in sorted(table.items())) + "\n" \
        if table else ""


def parse_folded(text: str) -> dict:
    """Inverse of to_folded_text; tolerates blank and comment lines."""
    out: dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        stack, _, count = line.rpartition(" ")
        try:
            out[stack] = out.get(stack, 0) + int(count)
        except ValueError:
            continue
    return out


def frame_shares(table: dict) -> dict:
    """Per-frame INCLUSIVE share of total samples: the fraction of
    samples whose stack contains the frame anywhere.  The unit of
    profile diffing — stable across refactors that merely re-shuffle
    callers, unlike per-stack counts."""
    total = sum(table.values())
    if not total:
        return {}
    by_frame: dict[str, int] = {}
    for stack, count in table.items():
        for frame in set(stack.split(";")):
            by_frame[frame] = by_frame.get(frame, 0) + count
    return {f: c / total for f, c in by_frame.items()}


def diff_folded(baseline: dict, current: dict, top_n: int = 10,
                min_share: float = 0.005) -> list[dict]:
    """Top-N frame-share regressions of `current` vs `baseline`:
    frames whose inclusive share grew, largest growth first.  Frames
    below `min_share` in both profiles are noise and skipped."""
    base = frame_shares(baseline)
    cur = frame_shares(current)
    rows = []
    for frame, share in cur.items():
        b = base.get(frame, 0.0)
        if share < min_share and b < min_share:
            continue
        if share > b:
            rows.append({"frame": frame, "base_share": round(b, 4),
                         "cur_share": round(share, 4),
                         "delta": round(share - b, 4)})
    rows.sort(key=lambda r: -r["delta"])
    return rows[:top_n]


def make_profile_handler(sampler: WallSampler, node_of,
                         server_kind: str):
    """Build the GET /admin/profile route body shared by all four
    server types: ?seconds=N (clamped to [0, 60]) blocks for one
    window; ?format=folded returns the raw text a flamegraph script
    eats, default JSON wraps it with node identity for prof_collect.
    `node_of` is a callable — servers learn their port at start()."""
    from seaweedfs_tpu_torch.utils.httpd import Response

    def handle(req) -> "Response":
        try:
            seconds = float(req.query.get("seconds", "0") or 0)
        except ValueError:
            return Response({"error": "bad seconds"}, status=400)
        seconds = max(0.0, min(seconds, 60.0))
        win = sampler.window(seconds)
        if req.query.get("format") == "folded":
            return Response(to_folded_text(win["folded"]),
                            content_type="text/plain")
        win["node"] = node_of()
        win["server"] = server_kind
        return Response(win)

    return handle
