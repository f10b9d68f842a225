"""S3 gateway drills under injected network faults.

The gateway composes chunk lists in-process with the filer, so the
network edge under test is the filer <-> volume data path: the volume
server advertises a ChaosProxy address and every chunk PUT/GET rides
the lossy link. The drills assert the resilience contract end to end
from the S3 API surface: added latency is survived, 5xx bursts fail
cleanly and recover, a blackholed volume server is escaped inside the
propagated deadline instead of hanging the S3 caller, and the
gateway's own QoS tenant buckets shed with Retry-After.

The port's copy of ref tests/test_s3_chaos.py: the same cases on the port's
gateway, filer and master, its volume servers on device="cpu"."""

import socket
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.gateway.s3_server import S3Server
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils.httpd import http_call, retry_after_hint
from tools.netchaos import ChaosProxy


def _cpu_vs(dirs, master_url, **kw):
    """The port's volume server on the kernels' plain versions (the
    tests run without a card)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(dirs, master_url, device="cpu", **kw)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def chaos_stack(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs_port = _free_port()
    proxy = ChaosProxy("127.0.0.1", vs_port).start()
    vs = _cpu_vs([str(tmp_path / "v0")], master.url,
                      port=vs_port, advertise=proxy.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    s3 = S3Server(fs)
    s3.start()
    time.sleep(0.2)
    base = f"http://{s3.url}"
    http_call("PUT", f"{base}/drill")
    yield base, proxy, s3
    s3.stop()
    fs.stop()
    vs.stop()
    proxy.stop()
    master.stop()


def test_s3_roundtrip_survives_added_latency(chaos_stack):
    base, proxy, _s3 = chaos_stack
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    proxy.set_fault(latency_s=0.08)
    status, _, _ = http_call("PUT", f"{base}/drill/slow.bin", body=data)
    assert status == 200
    status, body, _ = http_call("GET", f"{base}/drill/slow.bin")
    assert status == 200 and body == data


def test_s3_put_fails_cleanly_on_5xx_and_recovers(chaos_stack):
    base, proxy, _s3 = chaos_stack
    data = b"q" * 50_000
    proxy.set_fault(mode="http_error", http_status=503)
    status, _, _ = http_call("PUT", f"{base}/drill/flaky.bin", body=data)
    assert status >= 500  # surfaced, not swallowed or hung
    # nothing half-written: the key must not exist
    status, _, _ = http_call("GET", f"{base}/drill/flaky.bin")
    assert status in (404, 500)
    proxy.set_fault(mode="pass")
    status, _, _ = http_call("PUT", f"{base}/drill/flaky.bin", body=data)
    assert status == 200
    status, body, _ = http_call("GET", f"{base}/drill/flaky.bin")
    assert status == 200 and body == data


def test_s3_get_escapes_blackhole_within_deadline(chaos_stack):
    """A dead volume server must cost the S3 caller its deadline, not a
    full per-hop timeout: the gateway propagates X-Weed-Deadline into
    the chunk fetches (same contract as the filer edge)."""
    base, proxy, _s3 = chaos_stack
    data = b"h" * 80_000
    status, _, _ = http_call("PUT", f"{base}/drill/hole.bin", body=data)
    assert status == 200
    proxy.set_fault(mode="blackhole")
    t0 = time.perf_counter()
    status, _, _ = http_call("GET", f"{base}/drill/hole.bin",
                             headers={"X-Weed-Deadline": "1.5"},
                             timeout=20.0)
    elapsed = time.perf_counter() - t0
    assert status >= 500
    assert elapsed < 8.0, f"blackholed GET took {elapsed:.1f}s"
    # link heals -> same key serves again (breaker stayed closed: the
    # drill burned far fewer than failure_threshold consecutive calls)
    proxy.set_fault(mode="pass")
    status, body, _ = http_call("GET", f"{base}/drill/hole.bin")
    assert status == 200 and body == data


def test_s3_gateway_tenant_shed_sends_retry_after(chaos_stack):
    """Gateway-edge QoS: per-tenant token buckets shed with SlowDown +
    Retry-After before any data-path work happens (the volume link is
    blackholed to prove the shed never touches it)."""
    base, proxy, s3 = chaos_stack
    data = b"t" * 10_000
    status, _, _ = http_call("PUT", f"{base}/drill/tenant.bin", body=data)
    assert status == 200
    s3.qos.configure(tenant_rate=0.001, tenant_burst=1.0)
    proxy.set_fault(mode="blackhole")
    try:
        # anonymous traffic bills the client-IP bucket: one token, then shed
        status1, _, _ = http_call("GET", f"{base}/drill/tenant.bin",
                                  headers={"X-Weed-Deadline": "1.5"},
                                  timeout=20.0)
        status2, body2, hdrs2 = http_call("GET", f"{base}/drill/tenant.bin")
        assert status2 == 503
        assert b"SlowDown" in body2
        ra = retry_after_hint(status2, hdrs2)
        assert ra is not None and ra > 0
        snap = s3.qos.snapshot()
        assert snap["shed_tenant"] >= 1
    finally:
        proxy.set_fault(mode="pass")
        s3.qos.configure(tenant_rate=0.0)
    status, body, _ = http_call("GET", f"{base}/drill/tenant.bin")
    assert status == 200 and body == data
