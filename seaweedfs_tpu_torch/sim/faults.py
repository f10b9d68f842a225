"""Scripted fault schedules: one schema for sim and real chaos drills.

A schedule is a JSON document (or the equivalent list of dicts):

    {"events": [
      {"link": "filer-0->vol-3", "fault": "latency",
       "start": 5.0, "duration": 10.0, "latency_ms": 250},
      {"link": "*->vol-7", "fault": "blackhole", "start": 8, "duration": 6},
      {"link": "vol-1->*", "fault": "reset", "start": 2, "duration": 4},
      {"link": "*->vol-2", "fault": "http_error",
       "start": 1, "duration": 3, "status": 503}
    ]}

``link`` is "src->dst" with "*" wildcards on either side.  ``fault`` is
one of latency / blackhole / reset / http_error — deliberately the same
four modes ``tools/netchaos.py`` implements, so a schedule exercised
against the 100-actor sim can be replayed byte-identically against real
processes behind chaos proxies (netchaos grew a ``--schedule`` flag for
exactly this).  Times are seconds on whichever clock is driving: the
sim's virtual clock, or wall time since proxy start for netchaos.

``FaultScheduler.active(src, dst)`` returns the list of fault events
covering that link at the current time; later events win where they
conflict (e.g. a targeted blackhole overrides an earlier broad latency
band), which the transport implements by applying them in order.

The port's copy of seaweedfs_tpu/sim/faults.py. It imports nothing of that
package.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

FAULT_KINDS = ("latency", "blackhole", "reset", "http_error")


class FaultEvent:
    __slots__ = ("src", "dst", "fault", "start", "duration",
                 "latency_ms", "status")

    def __init__(self, link: str, fault: str, start: float, duration: float,
                 latency_ms: float = 0.0, status: int = 503):
        if fault not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {fault!r} "
                             f"(want one of {FAULT_KINDS})")
        if "->" not in link:
            raise ValueError(f"link {link!r} must be 'src->dst'")
        self.src, self.dst = (part.strip() for part in link.split("->", 1))
        self.fault = fault
        self.start = float(start)
        self.duration = float(duration)
        self.latency_ms = float(latency_ms)
        self.status = int(status)

    @property
    def end(self) -> float:
        return self.start + self.duration

    def matches(self, src: str, dst: str) -> bool:
        return ((self.src == "*" or self.src == src)
                and (self.dst == "*" or self.dst == dst))

    def covers(self, t: float) -> bool:
        return self.start <= t < self.end

    def to_dict(self) -> dict:
        d = {"link": f"{self.src}->{self.dst}", "fault": self.fault,
             "start": self.start, "duration": self.duration}
        if self.fault == "latency":
            d["latency_ms"] = self.latency_ms
        if self.fault == "http_error":
            d["status"] = self.status
        return d


def parse_schedule(doc) -> list[FaultEvent]:
    """Accepts the JSON document form ({"events": [...]}) or a bare
    list of event dicts; returns events sorted by start time."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    if isinstance(doc, dict):
        doc = doc.get("events", [])
    events = [FaultEvent(**{k: v for k, v in e.items()}) for e in doc]
    events.sort(key=lambda e: (e.start, e.end))
    return events


class FaultScheduler:
    """Time-indexed view over a parsed schedule.  The sim transport
    asks ``active(src, dst)`` on every message; netchaos instead walks
    the timeline with ``apply_at`` to flip its proxies."""

    def __init__(self, events: list[FaultEvent],
                 now_fn: Callable[[], float]):
        self.events = events
        self._now = now_fn

    def active(self, src: str, dst: str) -> list[FaultEvent]:
        t = self._now()
        return [e for e in self.events if e.matches(src, dst) and e.covers(t)]

    def horizon(self) -> float:
        """Virtual time at which the last fault has cleared."""
        return max((e.end for e in self.events), default=0.0)

    def decide(self, src: str, dst: str):
        """Collapse active faults on a link into one transport decision:
        (mode, extra_latency_s, status).  Later schedule entries win on
        mode conflicts; latency bands stack additively."""
        mode: Optional[str] = None
        extra = 0.0
        status = 503
        for e in self.active(src, dst):
            if e.fault == "latency":
                extra += e.latency_ms / 1000.0
            else:
                mode = e.fault
                status = e.status
        return mode, extra, status
