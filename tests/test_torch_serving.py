"""The port's serving pieces against seaweedfs_tpu's, on seeded inputs:
the QoS limiter and governor (qos/), the HTTP core (utils/httpd.py: range
parsing, route families, the zero-copy descriptor path, the client),
the hot-key sketch (utils/sketch.py), JWTs (utils/security.py), file ids
(storage/file_id.py), the hinted-handoff journal, tracing headers and the
metrics text exposition.

The two packages keep their own context variables and global state, so
they meet only over sockets and files, never by passing one package's
objects to the other.
"""

import threading

import numpy as np
import pytest

from seaweedfs_tpu.qos import classes as jclasses
from seaweedfs_tpu.qos.governor import QosGovernor as JGovernor
from seaweedfs_tpu.qos.limiter import AdaptiveLimiter as JAdaptive
from seaweedfs_tpu.storage import file_id as jfid
from seaweedfs_tpu.storage.hinted_handoff import HintJournal as JJournal
from seaweedfs_tpu.utils import clockctl as jclock
from seaweedfs_tpu.utils import httpd as jhttpd
from seaweedfs_tpu.utils import security as jsec
from seaweedfs_tpu.utils import tracing as jtracing
from seaweedfs_tpu.utils.metrics import Registry as JRegistry
from seaweedfs_tpu.utils.sketch import SpaceSaving as JSpaceSaving
from seaweedfs_tpu_torch.qos import classes
from seaweedfs_tpu_torch.qos.governor import QosGovernor
from seaweedfs_tpu_torch.qos.limiter import AdaptiveLimiter
from seaweedfs_tpu_torch.storage import file_id
from seaweedfs_tpu_torch.storage.hinted_handoff import HintJournal
from seaweedfs_tpu_torch.utils import clockctl, httpd, security, tracing
from seaweedfs_tpu_torch.utils.metrics import Registry
from seaweedfs_tpu_torch.utils.sketch import SpaceSaving


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 — compared by type name
        return type(e).__name__


class _Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t

    def sleep(self, s):
        self.t += max(s, 1e-6)


# ------------------------------------------------------------- qos

def _latencies(seed, n=400):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.001, 0.004, n)
    base[n // 3: n // 2] *= 8  # a congested stretch
    return base.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_limiter_matches_jax(seed):
    ours, theirs = AdaptiveLimiter(), JAdaptive()
    trace = []
    for i, lat in enumerate(_latencies(seed)):
        ours.observe(lat)
        theirs.observe(lat)
        trace.append((ours.limit, theirs.limit))
        if i == 300:
            ours.set_limit(500)
            theirs.set_limit(500)
    assert [a for a, _ in trace] == [b for _, b in trace]
    assert ours.snapshot() == theirs.snapshot()
    assert ours.queue_delay() == theirs.queue_delay()
    assert len(set(a for a, _ in trace)) > 3  # the limit moved


def _governor_run(clock_mod, gov_cls, seed):
    """A seeded stream of admits, releases and clock steps; returns every
    verdict and the final snapshot."""
    rng = np.random.default_rng(seed)
    clk = _Clock()
    out = []
    with clock_mod.install(clk.now, sleep_fn=clk.sleep):
        gov = gov_cls(initial_limit=12, min_limit=4, max_limit=32)
        gov.set_tenant_cap("background", "noisy", rate=2.0, burst=2.0)
        held = []
        for _ in range(300):
            r = rng.random()
            if r < 0.55:
                cls = ("interactive", "write", "background")[
                    int(rng.integers(0, 3))]
                tenant = ("a", "b", "noisy", None)[int(rng.integers(0, 4))]
                g = gov.admit(cls, tenant=tenant)
                out.append((g.ok, round(g.retry_after, 9), g.reason))
                if g.ok:
                    held.append(g)
            elif r < 0.9 and held:
                held.pop(int(rng.integers(0, len(held)))).release()
            clk.t += float(rng.uniform(0.0, 0.01))
            out.append(round(gov.pressure(), 9))
        snap = gov.snapshot()
    return out, snap


@pytest.mark.parametrize("seed", [0, 1])
def test_governor_decisions_match_jax(seed):
    got, snap = _governor_run(clockctl, QosGovernor, seed)
    want, jsnap = _governor_run(jclock, JGovernor, seed)
    assert got == want
    assert snap == jsnap
    verdicts = [v for v in got if isinstance(v, tuple)]
    assert any(not ok for ok, _, _ in verdicts)  # some were shed
    assert any(ok for ok, _, _ in verdicts)


@pytest.mark.parametrize("method,path", [
    ("GET", "/3,01637037d6"), ("HEAD", "/3,01637037d6"),
    ("POST", "/3,01637037d6"), ("DELETE", "/3,01637037d6"),
    ("POST", "/admin/ec/rebuild"), ("POST", "/admin/scrub"),
    ("POST", "/admin/ec/generate"), ("GET", "/admin/ec/shard_read"),
    ("POST", "/admin/replica_repair"), ("GET", "/status"),
    ("PUT", "/buckets/b/key"), ("GET", "/metrics")])
def test_classify_matches_jax(method, path):
    assert classes.classify(method, path) == jclasses.classify(method, path)


@pytest.mark.parametrize("headers,default", [
    ({"X-Weed-Class": "background"}, None), ({"X-Weed-Class": "bogus"}, None),
    ({}, "write"), ({"x-weed-class": "interactive"}, None), (None, "write")])
def test_class_from_headers_matches_jax(headers, default):
    assert classes.from_headers(headers, default) == \
        jclasses.from_headers(headers, default)


# ----------------------------------------------------------- httpd

@pytest.mark.parametrize("spec", [
    "bytes=0-99", "bytes=100-", "bytes=-100", "bytes=-5000",
    "bytes=999-999", "bytes=1000-", "bytes=1500-1600", "bytes=50-10",
    "bytes=abc", "bytes=0-99,200-299", "", None, "items=0-1",
    "bytes=0-5000", "bytes=-0"])
def test_parse_byte_range_matches_jax(spec):
    assert _outcome(httpd.parse_byte_range, spec, 1000) == \
        _outcome(jhttpd.parse_byte_range, spec, 1000)


@pytest.mark.parametrize("path", [
    "/", "", "/3,01637037d6", "/3,01637037d6.jpg", "/admin/ec/rebuild",
    "/admin", "/status", "/dir/assign", "/buckets/b/k", "/debug/traces",
    "/3", "/metrics"])
def test_route_family_matches_jax(path):
    assert httpd.route_family(path) == jhttpd.route_family(path)


def _serve(mod, blob_path):
    srv = mod.HttpServer("127.0.0.1", 0)

    def blob(req):
        with open(blob_path, "rb") as f:
            size = f.seek(0, 2)
            try:
                rng = mod.parse_byte_range(req.headers.get("Range", ""),
                                           size)
            except mod.RangeNotSatisfiable:
                return mod.Response(b"", status=416, headers={
                    "Content-Range": f"bytes */{size}"})
            if rng is None:
                return mod.send_file(f.fileno(), 0, size)
            lo, hi = rng
            return mod.send_file(f.fileno(), lo, hi - lo + 1, status=206,
                                 headers={"Content-Range":
                                          f"bytes {lo}-{hi}/{size}"})

    srv.add("GET", "/blob", blob)
    srv.add("POST", "/echo", lambda req: mod.Response(
        {"n": len(req.body), "sum": int(sum(req.body[:4096]))}))
    srv.start()
    return srv


@pytest.mark.parametrize("server_mod,client_mod", [
    (httpd, jhttpd), (jhttpd, httpd)], ids=["port-server", "jax-server"])
def test_http_core_across_packages(tmp_path, server_mod, client_mod):
    """One package's HttpServer (zero-copy descriptor bodies) answers the
    other's http_call, whole, ranged and past the end; and a POST body
    round-trips."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 300_001, dtype=np.uint8).tobytes()
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    srv = _serve(server_mod, str(path))
    try:
        url = f"http://127.0.0.1:{srv.port}"
        status, body, _ = client_mod.http_call("GET", url + "/blob")
        assert status == 200 and body == data
        for lo, hi in [(0, 0), (5, 70_000), (299_000, 300_000)]:
            status, body, hdrs = client_mod.http_call(
                "GET", url + "/blob", headers={"Range": f"bytes={lo}-{hi}"})
            assert status == 206 and body == data[lo:hi + 1]
            assert hdrs.get("Content-Range") == f"bytes {lo}-{hi}/{len(data)}"
        status, _, _ = client_mod.http_call(
            "GET", url + "/blob", headers={"Range": "bytes=400000-"})
        assert status == 416
        out = client_mod.http_json("POST", url + "/echo", {"k": "v" * 100})
        assert out["n"] == len(b'{"k": "' + b"v" * 100 + b'"}')
        status, _, _ = client_mod.http_call("GET", url + "/nope")
        assert status == 404
    finally:
        srv.stop()


# ----------------------------------------- sketch, jwt, fid, journal

@pytest.mark.parametrize("capacity,seed", [(8, 0), (16, 1), (64, 2)])
def test_space_saving_top_k_matches_jax(capacity, seed):
    rng = np.random.default_rng(seed)
    keys = [f"7,{int(k):x}" for k in rng.zipf(1.3, 3000) % 500]
    ours, theirs = SpaceSaving(capacity), JSpaceSaving(capacity)
    for k in keys:
        ours.offer(k)
        theirs.offer(k)
    assert ours.top(capacity // 2) == theirs.top(capacity // 2)
    assert ours.snapshot() == theirs.snapshot()
    for k in keys[:50]:
        assert ours.estimate(k) == theirs.estimate(k)
    # merging each other's snapshots gives the same sketch
    ours.merge_from(theirs.snapshot())
    theirs.merge_from(ours.snapshot())
    assert SpaceSaving.from_snapshot(theirs.snapshot()).top() == \
        JSpaceSaving.from_snapshot(theirs.snapshot()).top()


@pytest.mark.parametrize("gen,verify", [
    (security.gen_jwt, jsec.verify_jwt), (jsec.gen_jwt, security.verify_jwt)])
def test_jwt_round_trips_across_packages(gen, verify):
    token = gen("secret", "3,01637037d6", expires_seconds=60)
    assert verify("secret", token, "3,01637037d6")
    assert not verify("secret", token, "3,01637037d7")
    assert not verify("other", token, "3,01637037d6")
    assert not verify("secret", token[:-2] + "xx", "3,01637037d6")
    assert not verify("secret", gen("secret", "3,1", expires_seconds=-5),
                      "3,1")


@pytest.mark.parametrize("fid", [
    "3,01637037d6", "3,1637037d6", "3,01637037d6_2", "3,01637037d6.jpg",
    "12345,ffffffffffffffff12345678", "3,37d6", ",01637037d6", "3",
    "x,01637037d6"])
def test_file_id_parse_and_format_match_jax(fid):
    got = _outcome(file_id.FileId.parse, fid)
    want = _outcome(jfid.FileId.parse, fid)
    if isinstance(got, str):
        assert got == want
        return
    assert (got.volume_id, got.key, got.cookie) == \
        (want.volume_id, want.key, want.cookie)
    assert str(got) == str(want)
    assert file_id.format_needle_id_cookie(got.key, got.cookie) == \
        jfid.format_needle_id_cookie(want.key, want.cookie)


@pytest.mark.parametrize("writer,reader", [
    (HintJournal, JJournal), (JJournal, HintJournal)],
    ids=["port-writes", "jax-writes"])
def test_hint_journal_round_trips_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "hints.journal")
    w = writer(path)
    seqs = [w.record("write", 3, k, 0xC0DE, f"127.0.0.1:{9000 + k % 3}",
                     fid=f"3,{k:x}0000c0de") for k in range(1, 40)]
    assert w.record("write", 3, 1, 0xC0DE, "127.0.0.1:9001") == seqs[0]
    for s in seqs[::3]:
        w.ack(s)
    w.record("delete", 3, 5, 0, "127.0.0.1:9002")
    pending = w.pending()
    w.close()
    r = reader(path)
    assert r.pending() == pending
    assert r.pending_for("127.0.0.1:9002") == w.pending_for("127.0.0.1:9002")
    assert len(r) == len(pending) == 39 - len(seqs[::3]) + 1
    r.close()


# ----------------------------------------------- tracing and metrics

def test_trace_header_round_trips_across_packages():
    ours = tracing.Tracer(node="port", sample_rate=1.0)
    theirs = jtracing.Tracer(node="jax", sample_rate=1.0)
    span = ours.root_span("GET /x", sampled=True)
    parsed = jtracing.parse_header(span.header_value())
    assert parsed == tracing.parse_header(span.header_value())
    assert parsed[0] == span.trace_id
    child = theirs.server_span("GET /y",
                               {tracing.TRACE_HEADER: span.header_value()})
    assert child.trace_id == span.trace_id
    assert tracing.parse_header(child.header_value())[0] == span.trace_id
    for bad in ("", "zz", "a-b-c-d"):
        assert tracing.parse_header(bad) == jtracing.parse_header(bad)


def _metrics_run(reg_cls, clock_mod):
    clk = _Clock()
    with clock_mod.install(clk.now, sleep_fn=clk.sleep):
        reg = reg_cls()
        c = reg.counter("volumeServer", "request_total", "requests",
                        ("type",))
        g = reg.gauge("volumeServer", "volumes", "mounted volumes")
        h = reg.histogram("volumeServer", "request_seconds", "latency",
                          ("type",))
        for i in range(50):
            c.inc("read" if i % 3 else "write")
            h.observe(0.0005 * i, "read")
        g.set(value=7)
        with h.time("write"):
            clk.t += 0.003
        return reg.expose_text()


def test_metrics_exposition_matches_jax():
    text = _metrics_run(Registry, clockctl)
    assert text == _metrics_run(JRegistry, jclock)
    assert "volumeServer_request_total" in text


def _sampled_scopes(profiler):
    """Run a busy thread tagged (background, scrub) under a 200 Hz
    WallSampler; returns the folded stacks' scope prefixes."""
    stop = threading.Event()
    ready = threading.Event()

    def busy():
        with profiler.scope(cls="background", route="scrub"):
            ready.set()
            while not stop.is_set():
                sum(range(1000))

    s = profiler.WallSampler(hz=200)
    s.start()
    t = threading.Thread(target=busy)
    t.start()
    prefixes = set()
    try:
        assert ready.wait(5)
        deadline = clockctl.monotonic() + 5
        while clockctl.monotonic() < deadline and \
                "class:background;route:scrub" not in prefixes:
            stop.wait(0.05)
            prefixes = {";".join(k.split(";")[:2])
                        for k in s.snapshot()["folded"]}
    finally:
        stop.set()
        t.join(timeout=5)
        s.stop()
    assert not t.is_alive()
    return prefixes


@pytest.mark.parametrize("which", ["port", "jax"])
def test_profiler_sampler_attributes_tagged_threads(which):
    """The port's WallSampler (utils/profiler.py) folds a tagged thread's
    samples under its class and route, as the JAX package's does."""
    from seaweedfs_tpu.utils import profiler as jprofiler
    from seaweedfs_tpu_torch.utils import profiler
    mod = profiler if which == "port" else jprofiler
    assert "class:background;route:scrub" in _sampled_scopes(mod)
