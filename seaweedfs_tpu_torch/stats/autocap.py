"""Ledger-driven tenant capping: close the loop from measurement to
enforcement.

The ResourceLedger (stats/ledger.py) names the top CPU/byte consumers per
(class, tenant); this module feeds that into QosGovernor per-tenant rate caps
on a slow loop, so a flood tenant gets clipped WITHOUT operator
action.  The loop is deliberately conservative:

- decisions use windowed DELTAS (this tick minus last tick), not
  lifetime totals — an old burst can't cap a now-quiet tenant;
- a tenant is capped only when it holds more than ``share_threshold``
  of the window's burn in its class AND the class burned at least
  ``min_cpu_ms`` (or ``min_requests``) — idle clusters never cap;
- the cap is derived from the aggressor's own observed rate
  (``clip_factor`` of it, floored at ``min_rate``), so enforcement
  bites immediately but never zeroes a tenant;
- caps LIFT automatically after ``release_ticks`` consecutive windows
  below half the threshold — a reformed tenant is forgiven without a
  human in the loop.

The aggregate rows the ledger folds small tenants into ("(other)") and
the unattributed row ("-") are never capped.

The port's copy of seaweedfs_tpu/stats/autocap.py, the same code but for one
rule: a tenant is capped only when another cappable tenant burned in its
class in the same window. It imports nothing of that package.
"""

from __future__ import annotations

import threading
from typing import Optional

from seaweedfs_tpu_torch.stats.ledger import OTHER_TENANT, ResourceLedger
from seaweedfs_tpu_torch.utils import clockctl, glog

_UNCAPPABLE = (OTHER_TENANT, "-", "")


class LedgerAutoCapper:
    def __init__(self, ledger: ResourceLedger, governor,
                 interval_s: float = 15.0,
                 share_threshold: float = 0.5,
                 min_cpu_ms: float = 200.0,
                 min_requests: int = 200,
                 clip_factor: float = 0.1,
                 min_rate: float = 1.0,
                 release_ticks: int = 2):
        self.ledger = ledger
        self.governor = governor
        self.interval_s = interval_s
        self.share_threshold = share_threshold
        self.min_cpu_ms = min_cpu_ms
        self.min_requests = min_requests
        self.clip_factor = clip_factor
        self.min_rate = min_rate
        self.release_ticks = release_ticks
        self._lock = threading.Lock()
        self._last_rows: dict = {}
        self._last_tick = 0.0
        # (cls, tenant) -> consecutive quiet windows while capped
        self._capped: dict[tuple, int] = {}
        self.caps_installed = 0
        self.caps_released = 0

    def maybe_tick(self) -> None:
        """Tick if interval_s elapsed — piggybacks on an existing slow
        loop (the filer's announce loop) instead of owning a thread."""
        now = clockctl.monotonic()
        with self._lock:
            if now - self._last_tick < self.interval_s:
                return
            self._last_tick = now
        self.tick()

    def tick(self) -> dict:
        """One capping decision over the window since the last tick.
        Returns {installed: [...], released: [...]} for callers that watch it."""
        rows = self.ledger.rows()
        with self._lock:
            last = self._last_rows
            self._last_rows = rows
        window = max(self.interval_s, 1e-6)
        # per-class window totals + per-row deltas
        deltas: dict[tuple, dict] = {}
        cls_cpu: dict[str, float] = {}
        cls_req: dict[str, float] = {}
        for key, f in rows.items():
            prev = last.get(key, {})
            d = {"cpu_ms": f["cpu_ms"] - prev.get("cpu_ms", 0.0),
                 "requests": f["requests"] - prev.get("requests", 0)}
            deltas[key] = d
            cls_cpu[key[0]] = cls_cpu.get(key[0], 0.0) + max(0.0, d["cpu_ms"])
            cls_req[key[0]] = cls_req.get(key[0], 0.0) + max(0, d["requests"])
        # a tenant dominates only where another cappable tenant burned in
        # the class this window: a lone client is not an aggressor, and
        # capping it at clip_factor of its own rate throttles the whole
        # deployment (seaweedfs_tpu's capper does, and clips a one-client
        # filer to a tenth of its rate fifteen seconds into any load)
        active: dict[str, int] = {}
        for (cls, tenant), d in deltas.items():
            if tenant not in _UNCAPPABLE and (d["requests"] > 0
                                              or d["cpu_ms"] > 0):
                active[cls] = active.get(cls, 0) + 1
        installed, released = [], []
        for (cls, tenant), d in deltas.items():
            if tenant in _UNCAPPABLE:
                continue
            total_cpu = cls_cpu.get(cls, 0.0)
            total_req = cls_req.get(cls, 0.0)
            # two aggressor signatures: CPU hog, or pure request flood
            # (cheap requests barely register CPU but still saturate)
            contended = active.get(cls, 0) > 1
            hot = contended and (
                (total_cpu >= self.min_cpu_ms
                 and d["cpu_ms"] > self.share_threshold * total_cpu)
                or (total_req >= self.min_requests
                    and d["requests"] > self.share_threshold * total_req))
            key = (cls, tenant)
            if hot:
                rate = max(self.min_rate,
                           self.clip_factor * d["requests"] / window)
                self.governor.set_tenant_cap(cls, tenant, rate)
                if key not in self._capped:
                    self.caps_installed += 1
                    glog.warning(
                        "autocap: tenant %s capped at %.1f req/s in "
                        "class %s (%.0f%% of window cpu)", tenant, rate,
                        cls, 100.0 * d["cpu_ms"] / max(total_cpu, 1e-9))
                    installed.append({"class": cls, "tenant": tenant,
                                      "rate": rate})
                self._capped[key] = 0
                continue
            if key in self._capped:
                quiet = (not contended or total_cpu < self.min_cpu_ms
                         or d["cpu_ms"] < 0.5 * self.share_threshold
                         * total_cpu)
                if quiet:
                    self._capped[key] += 1
                    if self._capped[key] >= self.release_ticks:
                        del self._capped[key]
                        self.governor.clear_tenant_cap(cls, tenant)
                        self.caps_released += 1
                        glog.info("autocap: cap on %s/%s released",
                                  cls, tenant)
                        released.append({"class": cls, "tenant": tenant})
                else:
                    self._capped[key] = 0
        return {"installed": installed, "released": released}

    def snapshot(self) -> dict:
        with self._lock:
            capped = [{"class": c, "tenant": t, "quiet_ticks": q}
                      for (c, t), q in sorted(self._capped.items(),
                                              key=lambda kv: str(kv[0]))]
        return {"interval_s": self.interval_s, "capped": capped,
                "caps_installed": self.caps_installed,
                "caps_released": self.caps_released}
