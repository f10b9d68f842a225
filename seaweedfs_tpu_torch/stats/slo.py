"""SLO objectives + multi-window burn-rate alerting (the Google SRE
workbook shape): per traffic class, an objective like "99% of
requests are good", where good = completed without a 5xx AND under
the class's latency target. Burn rate over a window = observed bad
fraction / error budget; 1.0 means exactly spending the budget.

Two windows: a fast one (~5m production) that pages quickly on a
cliff, and a slow one (~1h) that catches slow leaks. Both elapse on
``clockctl`` time, so a virtual clock installed there compresses them
to virtual seconds.

The evaluator is pure bookkeeping over cumulative (total, bad)
samples — callers decide where those come from (the master feeds it
merged RED histogram rollups).

The port's copy of seaweedfs_tpu/stats/slo.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

# defaults; per-class overrides ride the objectives dict
DEFAULT_OBJECTIVES = {
    "interactive": {"latency_s": 0.5, "goal": 0.99},
    "write": {"latency_s": 1.0, "goal": 0.99},
    "background": {"latency_s": 10.0, "goal": 0.95},
    "none": {"latency_s": 1.0, "goal": 0.99},
}
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0
# burn thresholds: fast window pages, slow window tickets
FAST_BURN_THRESHOLD = 10.0
SLOW_BURN_THRESHOLD = 2.0

OK = "ok"
FAST_BURN = "fast_burn"
SLOW_BURN = "slow_burn"


class SloEvaluator:
    def __init__(self, objectives: Optional[dict] = None,
                 fast_window_s: float = FAST_WINDOW_S,
                 slow_window_s: float = SLOW_WINDOW_S,
                 fast_burn_threshold: float = FAST_BURN_THRESHOLD,
                 slow_burn_threshold: float = SLOW_BURN_THRESHOLD,
                 on_transition: Optional[Callable] = None):
        self.objectives = dict(DEFAULT_OBJECTIVES)
        if objectives:
            self.objectives.update(objectives)
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.fast_burn_threshold = fast_burn_threshold
        self.slow_burn_threshold = slow_burn_threshold
        # on_transition(t, cls, old_state, new_state, detail) — the
        # master routes it into glog
        self.on_transition = on_transition
        # cls -> deque[(t, cumulative_total, cumulative_bad)]
        self._hist: dict[str, deque] = {}
        self._state: dict[str, str] = {}
        # [(t, cls, old, new)] — the full alert timeline
        self.transitions: list = []

    def feed(self, now: float, cls: str, total: float,
             bad: float) -> None:
        """Record a cumulative (total, bad) sample for one class.
        Counter resets (a node restart shrinking the merged totals)
        are tolerated by clamping window deltas at zero."""
        dq = self._hist.setdefault(cls, deque())
        dq.append((now, total, bad))
        horizon = now - self.slow_window_s - 1.0
        while len(dq) > 2 and dq[1][0] <= horizon:
            dq.popleft()

    def _burn(self, cls: str, now: float, window: float) -> float:
        dq = self._hist.get(cls)
        if not dq:
            return 0.0
        t1, total1, bad1 = dq[-1]
        # the newest sample at or before the window start; fall back
        # to the oldest (partial coverage while the window fills)
        t0, total0, bad0 = dq[0]
        boundary = now - window
        for t, total, bad in dq:
            if t > boundary:
                break
            t0, total0, bad0 = t, total, bad
        d_total = max(total1 - total0, 0.0)
        d_bad = max(bad1 - bad0, 0.0)
        if d_total <= 0:
            return 0.0
        goal = self.objectives.get(
            cls, DEFAULT_OBJECTIVES["none"])["goal"]
        budget = max(1.0 - goal, 1e-9)
        return (d_bad / d_total) / budget

    def evaluate(self, now: float) -> dict:
        """Per-class burn rates + alert state; records (and reports)
        state transitions. Deterministic given the feed history."""
        out = {}
        for cls in sorted(self._hist):
            fast = self._burn(cls, now, self.fast_window_s)
            slow = self._burn(cls, now, self.slow_window_s)
            if fast >= self.fast_burn_threshold:
                state = FAST_BURN
            elif slow >= self.slow_burn_threshold:
                state = SLOW_BURN
            else:
                state = OK
            old = self._state.get(cls, OK)
            if state != old:
                self._state[cls] = state
                self.transitions.append((now, cls, old, state))
                if self.on_transition is not None:
                    self.on_transition(
                        now, cls, old, state,
                        f"fast={fast:.2f} slow={slow:.2f}")
            out[cls] = {"fast_burn": round(fast, 4),
                        "slow_burn": round(slow, 4),
                        "state": state,
                        "objective": self.objectives.get(
                            cls, DEFAULT_OBJECTIVES["none"])}
        return out

    def state(self, cls: str) -> str:
        return self._state.get(cls, OK)

    def firing(self) -> list:
        """Classes whose alert is currently not ok."""
        return sorted(c for c, s in self._state.items() if s != OK)

    def timeline(self) -> list:
        """[(t, cls, old, new)] — compare across runs for
        bit-reproducibility."""
        return list(self.transitions)
