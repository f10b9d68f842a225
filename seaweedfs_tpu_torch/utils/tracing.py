"""Distributed request tracing — trace/span ids riding X-Weed-Trace.

The design is the Dapper/Zipkin shape scaled down to this cluster's
existing ambient-context machinery: a trace id is minted at the first
serving edge a request hits (S3 gateway, filer, volume server, master),
the active span rides a ContextVar exactly like the ambient deadline
(X-Weed-Deadline) and traffic class (X-Weed-Class), `http_call` injects
the header on every outbound RPC, and `HttpServer._dispatch` re-enters
the scope on the far side — so replica fan-out, chunk uploads, hedged
reads and partial-repair chain hops nest as child spans with zero
per-call-site plumbing.

Each node keeps a bounded in-memory flight recorder (ring buffer):
head sampling decides at the edge whether a trace is *guaranteed*
retention, but slow and error spans are always kept (tail-based keep),
so the recorder catches the outliers even at a 1% head rate. The
recorder is served at /debug/traces (the port has no cross-node
collector yet).

Zero-cost-when-disabled contract (same as the QoS governor's `_PASS`
path): with the tracer disabled — or no tracer wired at all — the hot
path allocates no span objects; every helper returns the shared NOOP
span whose methods are empty.

Header format: ``X-Weed-Trace: <trace_id>:<span_id>:<flags>`` with
trace_id 16 hex chars, span_id 8 hex chars, flags bit 0 = sampled.

Stdlib-only on purpose: httpd, resilience and the QoS governor all
import this module, so it must sit below them in the import DAG
(it only imports glog, which imports nothing).

The port's copy of seaweedfs_tpu/utils/tracing.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import collections
import contextlib
import os
import random
import threading
import time
from contextvars import ContextVar
from typing import Optional

from seaweedfs_tpu_torch.utils import glog

from seaweedfs_tpu_torch.utils import headers
TRACE_HEADER = headers.TRACE

# ring-buffer + keep-policy defaults; Tracer() callers can override
DEFAULT_CAPACITY = 2048
DEFAULT_SAMPLE_RATE = 0.01
DEFAULT_SLOW_MS = 500.0

_HEX = set("0123456789abcdef")


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class _NoopSpan:
    """Shared do-nothing span — the `_PASS` of tracing. Returned
    whenever tracing is off so hot paths never allocate."""
    __slots__ = ()
    sampled = False
    trace_id = ""
    span_id = ""

    def annotate(self, key, value):
        pass

    def finish(self, status=200, error=""):
        pass

    def child(self, name, kind="client"):
        return self

    def header_value(self):
        return None

    def __bool__(self):
        return False


NOOP = _NoopSpan()

# the ambient span: set at the serving edge by HttpServer._dispatch,
# re-entered across thread pools by fan-out sites (which capture it
# alongside the deadline/class, since ContextVars don't cross pools)
_current: ContextVar[Optional["Span"]] = ContextVar("weed_span",
                                                    default=None)


class Span:
    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "kind", "start", "duration_ms", "status", "error",
                 "sampled", "annotations")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: str, name: str, kind: str, sampled: bool):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.sampled = sampled
        self.start = time.time()
        self.duration_ms = 0.0
        self.status = 0
        self.error = ""
        self.annotations: Optional[dict] = None  # lazy — most spans bare

    def annotate(self, key, value) -> None:
        if self.annotations is None:
            self.annotations = {}
        self.annotations[key] = value

    def child(self, name: str, kind: str = "client") -> "Span":
        return Span(self.tracer, self.trace_id, _new_id(4), self.span_id,
                    name, kind, self.sampled)

    def finish(self, status: int = 200, error: str = "") -> None:
        self.duration_ms = (time.time() - self.start) * 1000.0
        self.status = status
        self.error = error
        self.tracer._record(self)

    def header_value(self) -> str:
        return f"{self.trace_id}:{self.span_id}:{1 if self.sampled else 0}"

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "node": self.tracer.node,
            "start": self.start,
            "duration_ms": round(self.duration_ms, 3),
            "status": self.status,
            "sampled": self.sampled,
        }
        if self.error:
            d["error"] = self.error
        if self.annotations:
            d["annotations"] = self.annotations
        return d


def parse_header(value: str) -> Optional[tuple[str, str, bool]]:
    """``trace:span:flags`` -> (trace_id, parent_span_id, sampled), or
    None on anything malformed (a bad header must never 500 a request)."""
    parts = value.split(":")
    if len(parts) != 3:
        return None
    tid, sid, flags = parts
    if not tid or not sid or set(tid) - _HEX or set(sid) - _HEX:
        return None
    try:
        sampled = bool(int(flags) & 1)
    except ValueError:
        return None
    return tid, sid, sampled


class Tracer:
    """Per-server trace recorder: mints edge spans, applies the
    head-sampling decision, and keeps a bounded ring of finished spans
    (sampled ones always; unsampled ones only when slow or errored)."""

    def __init__(self, node: str = "", enabled: bool = True,
                 sample_rate: float = DEFAULT_SAMPLE_RATE,
                 capacity: int = DEFAULT_CAPACITY,
                 slow_ms: float = DEFAULT_SLOW_MS):
        self.node = node
        self.enabled = enabled
        self.sample_rate = float(sample_rate)
        self.slow_ms = float(slow_ms)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._started = 0
        self._kept = 0

    # ---- edge ----
    def server_span(self, name: str, headers) -> Span:
        """Continue an inbound trace or mint a fresh one. Returns NOOP
        when disabled — callers pay one attribute check, nothing more."""
        if not self.enabled:
            return NOOP
        hdr = headers.get(TRACE_HEADER) if headers is not None else None
        parsed = parse_header(hdr) if hdr else None
        if parsed is not None:
            tid, parent, sampled = parsed
        else:
            tid, parent = _new_id(8), ""
            sampled = random.random() < self.sample_rate
        return Span(self, tid, _new_id(4), parent, name, "server", sampled)

    def root_span(self, name: str, sampled: Optional[bool] = None) -> Span:
        """Fresh root for work with no inbound request (repair jobs,
        daemons). `sampled=None` applies the head rate."""
        if not self.enabled:
            return NOOP
        if sampled is None:
            sampled = random.random() < self.sample_rate
        return Span(self, _new_id(8), _new_id(4), "", name, "internal",
                    sampled)

    # ---- recorder ----
    def _record(self, span: Span) -> None:
        self._started += 1
        if not (span.sampled or span.error or span.status >= 500
                or span.duration_ms >= self.slow_ms):
            return
        with self._lock:
            self._ring.append(span.to_dict())
            self._kept += 1

    def snapshot(self, trace_id: str = "", min_ms: float = 0.0,
                 limit: int = 512) -> dict:
        with self._lock:
            spans = list(self._ring)
        if trace_id:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        if min_ms > 0:
            spans = [s for s in spans if s["duration_ms"] >= min_ms]
        if limit and len(spans) > limit:
            spans = spans[-limit:]
        return {
            "node": self.node,
            "enabled": self.enabled,
            "sample_rate": self.sample_rate,
            "slow_ms": self.slow_ms,
            "started": self._started,
            "kept": self._kept,
            "spans": spans,
        }

    def configure(self, **kw) -> dict:
        if "enabled" in kw:
            self.enabled = bool(kw["enabled"])
        if "sample_rate" in kw:
            self.sample_rate = max(0.0, min(1.0, float(kw["sample_rate"])))
        if "slow_ms" in kw:
            self.slow_ms = float(kw["slow_ms"])
        return {"enabled": self.enabled, "sample_rate": self.sample_rate,
                "slow_ms": self.slow_ms}


# ---- ambient-scope helpers (the class_scope/deadline_scope analogues) ----

def current_span() -> Optional[Span]:
    return _current.get()


@contextlib.contextmanager
def span_scope(span):
    """Make `span` ambient. None / NOOP -> plain yield, so fan-out
    workers can re-enter unconditionally like class_scope(None)."""
    if span is None or span is NOOP:
        yield span
        return
    tok = _current.set(span)
    try:
        yield span
    finally:
        _current.reset(tok)


def attach(span):
    """Low-level scope enter for code that can't afford a context
    manager on the disabled path (HttpServer._dispatch): returns a
    reset token, or None for NOOP/None spans (nothing to undo)."""
    if span is None or span is NOOP:
        return None
    return _current.set(span)


def detach(token) -> None:
    if token is not None:
        _current.reset(token)


@contextlib.contextmanager
def child_scope(name: str, kind: str = "internal"):
    """Open a finished-on-exit child of the ambient span (NOOP when no
    trace is active). The one-liner for annotating a nested stage."""
    parent = _current.get()
    if parent is None:
        yield NOOP
        return
    span = parent.child(name, kind)
    tok = _current.set(span)
    status, error = 200, ""
    try:
        yield span
    except BaseException as e:
        status, error = 500, f"{type(e).__name__}: {e}"
        raise
    finally:
        _current.reset(tok)
        span.finish(status=status, error=error)


def annotate(key, value) -> None:
    """Attach key=value to the ambient span; free when no trace."""
    s = _current.get()
    if s is not None:
        s.annotate(key, value)


def current_trace_id() -> str:
    s = _current.get()
    return s.trace_id if s is not None else ""


# ---- glog cross-referencing (satellite: `[t=abcd1234]` in log lines).
# glog stays import-clean (it cannot import us back), so we register a
# provider it calls per line; "" when no sampled trace is ambient keeps
# the historical line format byte-identical outside traces.

def _log_context() -> str:
    s = _current.get()
    if s is not None and s.sampled:
        return f"[t={s.trace_id[:8]}] "
    return ""


glog.set_context_provider(_log_context)
