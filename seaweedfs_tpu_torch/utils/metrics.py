"""Prometheus-style metrics registry + text exposition.

Functional equivalent of reference weed/stats/metrics.go (Namespace
"SeaweedFS", per-subsystem counters/gauges/histograms exposed on
/metrics). Stdlib-only implementation of the text format.

Histograms are the cluster telemetry plane's building block: they are
*mergeable* (``snapshot()``/``merge_from()`` move per-node series to
the master, which sums bucket counts — histogram merging is exact,
unlike quantile merging) and carry OpenMetrics-style trace exemplars
(each bucket remembers the last sampled ``X-Weed-Trace`` id that
landed in it, closing the metrics->trace loop). All histogram timing
goes through ``clockctl`` so timed sections elapse in virtual time
under the deterministic sim.

The port's copy of seaweedfs_tpu/utils/metrics.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import bisect
import threading
import urllib.parse
from typing import Optional

from seaweedfs_tpu_torch.utils import clockctl


class Counter:
    def __init__(self, name: str, help_: str, label_names: tuple = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, *labels, amount: float = 1.0):
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + amount

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with self._lock:  # inc() can add a label key mid-scrape
            items = sorted(self._values.items())
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(self.label_names, labels)} {v}")
        return out


class Gauge(Counter):
    def set(self, *labels, value: float = 0.0):
        with self._lock:
            self._values[labels] = value

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(self.label_names, labels)} {v}")
        return out


class Histogram:
    DEFAULT_BUCKETS = (0.0001, 0.001, 0.01, 0.1, 1, 10)

    def __init__(self, name: str, help_: str, label_names: tuple = (),
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.buckets = sorted(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        # labels -> per-bucket [exemplar trace id or None]; only
        # written when observe() is handed a sampled trace, so the
        # common unsampled path costs nothing extra
        self._exemplars: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, *labels,
                exemplar: Optional[str] = None):
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.setdefault(
                labels, [0] * (len(self.buckets) + 1))
            counts[idx] += 1
            self._sums[labels] = self._sums.get(labels, 0.0) + value
            if exemplar:
                ex = self._exemplars.setdefault(
                    labels, [None] * (len(self.buckets) + 1))
                ex[idx] = exemplar

    def time(self, *labels):
        return _Timer(self, labels)

    # ---- mergeable snapshots (the telemetry plane's transport) ----
    def snapshot(self) -> dict:
        """JSON-safe copy of every series. Bucket counts are
        per-bucket (NOT cumulative) so merging is plain elementwise
        addition."""
        with self._lock:
            series = [[list(labels), list(counts),
                       self._sums[labels],
                       list(self._exemplars.get(labels, ()) or
                            [None] * (len(self.buckets) + 1))]
                      for labels, counts in self._counts.items()]
        series.sort(key=lambda s: s[0])
        return {"name": self.name, "buckets": list(self.buckets),
                "label_names": list(self.label_names), "series": series}

    def merge_from(self, snap: dict) -> None:
        """Fold another node's ``snapshot()`` into this histogram.
        Bucket layouts must match (all RED histograms share one
        compile-time layout); incoming exemplars win — they are
        samples, not aggregates, so last-writer-wins keeps merging
        commutative enough for a debugging hook."""
        if list(snap.get("buckets", ())) != list(self.buckets):
            raise ValueError(
                f"{self.name}: bucket layout mismatch in merge")
        n = len(self.buckets) + 1
        for raw_labels, counts, total, exemplars in snap["series"]:
            labels = tuple(raw_labels)
            with self._lock:
                mine = self._counts.setdefault(labels, [0] * n)
                for i, c in enumerate(counts):
                    mine[i] += c
                self._sums[labels] = self._sums.get(labels, 0.0) + total
                if exemplars and any(exemplars):
                    ex = self._exemplars.setdefault(labels, [None] * n)
                    for i, e in enumerate(exemplars):
                        if e:
                            ex[i] = e

    def quantile(self, q: float, *labels,
                 label_filter=None) -> Optional[float]:
        """Estimated q-quantile (0..1) from bucket counts, linearly
        interpolated inside the winning bucket. With ``labels`` uses
        that one series; with ``label_filter`` (a predicate over the
        label tuple) sums the matching series; otherwise sums all.
        Returns None with no observations."""
        n = len(self.buckets) + 1
        merged = [0] * n
        with self._lock:
            if labels:
                merged = list(self._counts.get(labels, merged))
            else:
                for lbl, counts in self._counts.items():
                    if label_filter is not None and not label_filter(lbl):
                        continue
                    for i, c in enumerate(counts):
                        merged[i] += c
        total = sum(merged)
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(merged):
            if cum + c >= rank and c > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) \
                    else self.buckets[-1]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.buckets[-1]

    def exemplar_for(self, *labels) -> list:
        """[(bucket upper bound, trace id)] for every bucket of one
        series that has captured an exemplar."""
        with self._lock:
            ex = list(self._exemplars.get(labels, ()))
        bounds = [str(b) for b in self.buckets] + ["+Inf"]
        return [(bounds[i], e) for i, e in enumerate(ex) if e]

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            snapshot = sorted(
                (labels, list(counts), self._sums[labels],
                 list(self._exemplars.get(labels, ())))
                for labels, counts in self._counts.items())
        for labels, counts, total, exemplars in snapshot:
            cum = 0
            bounds = [str(b) for b in self.buckets] + ["+Inf"]
            for i, b in enumerate(bounds):
                cum += counts[i]
                lbl = _fmt_labels(self.label_names + ("le",),
                                  labels + (b,))
                line = f"{self.name}_bucket{lbl} {cum}"
                # OpenMetrics exemplar suffix: the last sampled trace
                # that landed in this bucket
                if i < len(exemplars) and exemplars[i]:
                    line += f' # {{trace_id="{exemplars[i]}"}} 1'
                out.append(line)
            base = _fmt_labels(self.label_names, labels)
            out.append(f"{self.name}_sum{base} {total}")
            out.append(f"{self.name}_count{base} {cum}")
        return out


class _Timer:
    def __init__(self, hist, labels):
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self.t0 = clockctl.monotonic()
        return self

    def __exit__(self, *exc):
        self.hist.observe(clockctl.monotonic() - self.t0, *self.labels)


def _fmt_labels(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + pairs + "}"


# RED (rate/errors/duration) edge instrumentation. One histogram,
# one observation site (HttpServer._dispatch), every serving edge —
# master, volume, filer, S3, WebDAV, IAM — covered by construction.
RED_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
               1.0, 2.5, 5.0, 10.0)


class RedRecorder:
    """Owns the per-server RED histogram and adapts it to the
    HttpServer hook: ``http.red = RedRecorder(registry, "filer")``.
    Labels: (server, route_family, class, status_family) — low
    cardinality by construction (route families are a closed set,
    see httpd.route_family)."""

    def __init__(self, registry: "Registry", server: str):
        self.server = server
        self.hist = registry.histogram(
            "http", "red_request_seconds",
            "request duration by edge/route-family/class/status",
            labels=("server", "route_family", "class", "status_family"),
            buckets=RED_BUCKETS)

    def observe(self, route_family: str, cls: str, status: int,
                seconds: float, exemplar: Optional[str] = None) -> None:
        self.hist.observe(seconds, self.server, route_family,
                          cls or "none", f"{status // 100}xx",
                          exemplar=exemplar)

    def snapshot(self) -> dict:
        return self.hist.snapshot()


class Registry:
    def __init__(self, namespace: str = "SeaweedFS_TPU"):
        self.namespace = namespace
        self._metrics: list = []
        self._refreshers: list = []
        self._lock = threading.Lock()

    def on_expose(self, fn) -> None:
        """Register a hook run before every exposition — servers
        refresh scrape-time gauges here so the push-gateway loop and
        /metrics handlers share identical, fresh samples."""
        self._refreshers.append(fn)

    def counter(self, subsystem: str, name: str, help_: str,
                labels: tuple = ()) -> Counter:
        return self._add(Counter(
            f"{self.namespace}_{subsystem}_{name}", help_, labels))

    def gauge(self, subsystem: str, name: str, help_: str,
              labels: tuple = ()) -> Gauge:
        return self._add(Gauge(
            f"{self.namespace}_{subsystem}_{name}", help_, labels))

    def histogram(self, subsystem: str, name: str, help_: str,
                  labels: tuple = (),
                  buckets: tuple = Histogram.DEFAULT_BUCKETS) -> Histogram:
        return self._add(Histogram(
            f"{self.namespace}_{subsystem}_{name}", help_, labels,
            buckets=buckets))

    def _add(self, m):
        # Idempotent by metric name: a component rebuilt mid-process (a
        # comparator bench swapping in a fresh PeerHealth, a reloaded
        # subsystem) gets the already-registered collector back instead
        # of appending a duplicate series to every exposition. A name
        # collision with a different type or label set is a programming
        # error and fails loudly.
        with self._lock:
            for existing in self._metrics:
                if existing.name == m.name:
                    if (type(existing) is not type(m)
                            or existing.label_names != m.label_names):
                        raise ValueError(
                            f"metric {m.name} re-registered with a "
                            f"different type or label set")
                    return existing
            self._metrics.append(m)
        return m

    def expose_text(self) -> str:
        from seaweedfs_tpu_torch.utils import glog
        for fn in list(self._refreshers):
            try:
                fn()
            except Exception as e:
                # a broken refresher must not kill the scrape, but it
                # must not fail silently either — stale gauges look
                # exactly like a healthy idle server
                glog.vlog(1, "metrics refresher %r failed: %s",
                          getattr(fn, "__name__", fn), e)
        lines = []
        with self._lock:
            for m in self._metrics:
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    # ---- push gateway (reference stats/metrics.go:226-247 LoopPushingMetric:
    # each process PUTs its whole registry to
    # {addr}/metrics/job/{job}/instance/{instance} every interval) ----
    def start_push(self, address: str, job: str, instance: str,
                   interval_sec: float = 15.0) -> None:
        if not address:
            return
        from seaweedfs_tpu_torch.utils import glog
        from seaweedfs_tpu_torch.utils.httpd import http_call
        # re-pointing the push target mid-process must not orphan the
        # previous loop: stop it (and wait briefly) before replacing
        # the stop event it watches
        self.stop_push()
        old = getattr(self, "_push_thread", None)
        if old is not None and old.is_alive():
            old.join(timeout=1.0)
        self._push_stop = threading.Event()
        stop = self._push_stop
        url = (f"http://{address}/metrics/job/{job}"
               f"/instance/{urllib.parse.quote(instance, safe='')}")

        def loop():
            while not stop.wait(interval_sec):
                try:
                    http_call("PUT", url,
                              body=self.expose_text().encode(),
                              timeout=10,
                              headers={"Content-Type": "text/plain"})
                except Exception as e:
                    glog.vlog(1, "metrics push to %s failed: %s", url, e)

        self._push_thread = threading.Thread(target=loop, daemon=True,
                                             name="metrics-push")
        self._push_thread.start()

    def stop_push(self) -> None:
        if hasattr(self, "_push_stop"):
            self._push_stop.set()
