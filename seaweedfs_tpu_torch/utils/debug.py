"""Debug/profiling endpoints (reference util/grace/pprof.go +
net/http/pprof wired into every server): thread stack dumps and on-demand
CPU profiles, mounted under /debug/ on our HTTP servers.

The port's copy of seaweedfs_tpu/utils/debug.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import cProfile
import io
import pstats
import sys
import threading
import traceback

from seaweedfs_tpu_torch.utils.httpd import HttpServer, Request, Response


def install_debug_routes(http: HttpServer) -> None:
    http.add("GET", "/debug/stacks", _handle_stacks)
    http.add("GET", "/debug/profile", _handle_profile)
    http.add("GET", "/debug/vars", _handle_vars)
    # flight recorder: reads whatever tracer is wired onto this server
    # at request time (servers set http.tracer after construction)
    http.add("GET", "/debug/traces", lambda req: _handle_traces(req, http))


def _handle_traces(req: Request, http: HttpServer) -> Response:
    """Dump the node's span flight recorder. Filters: ?trace=<id>,
    ?min_ms=<float>, ?limit=<n>. The JAX package's trace collector
    stitches these across nodes; the port has none yet."""
    tracer = http.tracer
    if tracer is None:
        return Response({"enabled": False, "spans": []})
    return Response(tracer.snapshot(
        trace_id=req.query.get("trace", ""),
        min_ms=float(req.query.get("min_ms", 0) or 0),
        limit=int(req.query.get("limit", 512) or 512)))


def _handle_stacks(req: Request) -> Response:
    """All thread stacks (the goroutine-dump analogue)."""
    out = io.StringIO()
    frames = sys._current_frames()
    for t in threading.enumerate():
        out.write(f"--- thread {t.name} (daemon={t.daemon}) ---\n")
        frame = frames.get(t.ident)
        if frame is not None:
            traceback.print_stack(frame, file=out)
        out.write("\n")
    return Response(out.getvalue(), content_type="text/plain")


def _handle_profile(req: Request) -> Response:
    """CPU-profile the process for ?seconds=N (default 2)."""
    seconds = float(req.query.get("seconds", 2))
    prof = cProfile.Profile()
    prof.enable()
    threading.Event().wait(min(seconds, 30))
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(50)
    return Response(out.getvalue(), content_type="text/plain")


def _handle_vars(req: Request) -> Response:
    import gc
    return Response({
        "threads": len(threading.enumerate()),
        "gc_counts": gc.get_count(),
    })
