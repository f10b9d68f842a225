"""Tiering autopilot: planner bands/gates + cloud-tier backend seam, and
the backend SPI with a volume tiered to the S3 gateway and read back.

The port's copy of ref tests/test_tiering.py and the backend and S3-tier
cases of tests/test_maintenance.py (test_backend_spi,
test_tier_volume_to_s3_and_read_back), on the port's storage engine,
gateway, filer and master, its volume servers on device="cpu"."""

import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from seaweedfs_tpu_torch.storage.backend import (DiskFile, MemoryFile,
                                                 S3BackendFile,
                                                 open_backend_for_volume,
                                                 tier_volume_to_s3)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.tiering import (RUNG_CLOUD, RUNG_EC, RUNG_HOT,
                                           TieringPlanner)
from seaweedfs_tpu_torch.storage.volume import Volume


def _cpu_vs(dirs, master_url, **kw):
    """The port's volume server on the kernels' plain versions (the
    tests run without a card)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(dirs, master_url, device="cpu", **kw)


def _report(reads, rung="hot", read_only=True, shards=False, size=1000):
    return {"volumes": {1: {"reads": reads, "rung": rung,
                            "size": size, "read_only": read_only,
                            "has_ec_shards": shards}}}


def _planner(**kw):
    """Bands sized for hand-computed rates; ewma_alpha=1.0 makes the
    temperature equal the current windowed rate (no smoothing lag to
    account for in the arithmetic)."""
    args = dict(window_s=10.0, ewma_alpha=1.0, cool_max=1.0,
                cold_max=0.1, heat_min=5.0, min_age_s=0.0,
                cooldown_s=0.0, max_moves_per_plan=8,
                cloud_enabled=True)
    args.update(kw)
    return TieringPlanner(**args)


def _one_move(plan):
    assert plan is not None and len(plan["moves"]) == 1, plan
    return plan["moves"][0]


def test_cooling_volume_demotes_to_ec():
    p = _planner()
    p.observe("vs1", _report(0), now=0.0)
    p.observe("vs1", _report(2), now=4.0)  # 0.5/s: inside (0.1, 1.0]
    mv = _one_move(p.plan(now=4.0))
    assert (mv["vid"], mv["from"], mv["to"]) == (1, RUNG_HOT, RUNG_EC)
    assert mv["urls"] == ["vs1"]


def test_cold_volume_demotes_straight_to_cloud():
    p = _planner()
    p.observe("vs1", _report(7), now=0.0)
    p.observe("vs1", _report(7), now=4.0)  # 0/s <= cold_max
    assert _one_move(p.plan(now=4.0))["to"] == RUNG_CLOUD


def test_cloud_rung_disabled_stops_at_ec():
    p = _planner(cloud_enabled=False)
    p.observe("vs1", _report(7), now=0.0)
    p.observe("vs1", _report(7), now=4.0)
    assert _one_move(p.plan(now=4.0))["to"] == RUNG_EC


def test_in_band_volume_stays_put():
    p = _planner()
    p.observe("vs1", _report(0), now=0.0)
    p.observe("vs1", _report(10), now=4.0)  # 2.5/s: above cool_max
    assert p.plan(now=4.0) is None


def test_writable_volume_never_demotes():
    p = _planner()
    p.observe("vs1", _report(0, read_only=False), now=0.0)
    p.observe("vs1", _report(0, read_only=False), now=4.0)
    assert p.plan(now=4.0) is None


def test_reheat_promotes_cloud_volume_home():
    p = _planner()
    p.observe("vs1", _report(0, rung="cloud"), now=0.0)
    p.observe("vs1", _report(100, rung="cloud"), now=4.0)  # 25/s
    assert _one_move(p.plan(now=4.0))["to"] == RUNG_HOT


def test_reheat_lands_on_ec_when_shards_survive():
    p = _planner()
    p.observe("vs1", _report(0, rung="cloud", shards=True), now=0.0)
    p.observe("vs1", _report(100, rung="cloud", shards=True), now=4.0)
    assert _one_move(p.plan(now=4.0))["to"] == RUNG_EC


def test_ec_rung_moves_both_directions():
    p = _planner()
    p.observe("vs1", _report(0, rung="ec"), now=0.0)
    p.observe("vs1", _report(100, rung="ec"), now=4.0)  # hot again
    assert _one_move(p.plan(now=4.0))["to"] == RUNG_HOT

    p2 = _planner()
    p2.observe("vs1", _report(5, rung="ec"), now=0.0)
    p2.observe("vs1", _report(5, rung="ec"), now=4.0)  # fully cold
    assert _one_move(p2.plan(now=4.0))["to"] == RUNG_CLOUD


def test_min_age_gates_young_volumes():
    p = _planner(min_age_s=100.0)
    p.observe("vs1", _report(0), now=0.0)
    p.observe("vs1", _report(0), now=4.0)
    assert p.plan(now=4.0) is None


def test_moving_state_and_cooldown_gate_redispatch():
    p = _planner(cooldown_s=50.0)
    p.observe("vs1", _report(0), now=0.0)
    p.observe("vs1", _report(0), now=4.0)
    assert p.plan(now=4.0) is not None
    # marked "moving": the same volume must not be re-planned
    assert p.plan(now=4.0) is None
    p.note_committed(1, now=4.0)
    p.observe("vs1", _report(0, rung="ec"), now=8.0)
    assert p.plan(now=8.0) is None          # inside cooldown
    p.observe("vs1", _report(0, rung="ec"), now=60.0)
    p.observe("vs1", _report(0, rung="ec"), now=64.0)
    assert _one_move(p.plan(now=64.0))["to"] == RUNG_CLOUD

    # a failed move clears the gate entirely: retry next plan
    p.note_failed(1)
    p.observe("vs1", _report(0, rung="ec"), now=68.0)
    assert p.plan(now=68.0) is not None


def test_silence_pauses_planning():
    p = _planner()
    p.observe("vs1", _report(0), now=0.0)
    p.observe("vs1", _report(0), now=4.0)
    p.observe("vs2", {"volumes": {2: {"reads": 0, "rung": "hot",
                                      "size": 9, "read_only": True}}},
              now=0.0)  # vs2 then goes dark
    assert p.plan(now=14.0) is None
    assert p.paused_on_silence == 1
    assert p.status(now=14.0)["silent"] is True


def test_counter_reset_clamps_to_zero():
    # a restarted server reports a smaller cumulative counter; the
    # rate must clamp to 0 (cold), never go negative
    p = _planner()
    p.observe("vs1", _report(1000), now=0.0)
    p.observe("vs1", _report(3), now=4.0)
    assert p.temperature(1, now=4.0) == 0.0
    assert _one_move(p.plan(now=4.0))["to"] == RUNG_CLOUD


def test_single_sample_gives_no_temperature():
    # insufficient telemetry gates planning rather than reading as
    # zero load (which would demote everything on startup)
    p = _planner()
    p.observe("vs1", _report(0), now=0.0)
    assert p.temperature(1, now=0.0) is None
    assert p.plan(now=0.0) is None


def test_temperature_is_a_pure_read():
    # polling temperature()/status() (GET /cluster/tiering,
    # tier_profile --watch) must not re-apply the EWMA blend — the
    # smoothing advances only at observe() heartbeats
    p = _planner(ewma_alpha=0.5)
    p.observe("vs1", _report(0), now=0.0)
    p.observe("vs1", _report(10), now=4.0)
    p.observe("vs1", _report(30), now=8.0)
    t1 = p.temperature(1, now=8.0)
    for _ in range(5):
        p.status(now=8.0)
        assert p.temperature(1, now=8.0) == t1


def test_decommissioned_member_ages_out():
    # short silence pauses planning; silence past stale_after_s
    # forgets the member so it cannot pause the autopilot forever
    p = _planner(stale_after_s=50.0)
    p.observe("vs1", _report(0), now=0.0)
    p.observe("vs2", {"volumes": {2: {"reads": 0, "rung": "hot",
                                      "size": 9, "read_only": True}}},
              now=0.0)  # vs2 is then decommissioned
    p.observe("vs1", _report(0), now=4.0)
    assert p.plan(now=14.0) is None          # short silence: pause
    p.observe("vs1", _report(0), now=101.0)
    p.observe("vs1", _report(0), now=105.0)
    plan = p.plan(now=105.0)                 # vs2 forgotten: resume
    assert plan is not None
    assert "vs2" not in p._members
    assert 2 not in p._meta                  # its volume went with it


def test_migrated_replica_ages_out_of_urls():
    # a volume that moved off a server must not stay unplannable via
    # the old (url, vid) key never getting in-window samples again
    p = _planner(stale_after_s=50.0)
    for t in (0.0, 4.0):
        p.observe("vs1", _report(0), now=t)
        p.observe("vs2", _report(0), now=t)
    # vid 1 leaves vs1; both servers keep heartbeating
    for t in (60.0, 64.0, 100.0, 104.0):
        p.observe("vs1", {"volumes": {}}, now=t)
        p.observe("vs2", _report(0), now=t)
    assert p._meta[1]["urls"] == ["vs2"]
    assert p.temperature(1, now=104.0) is not None
    assert p.plan(now=104.0) is not None


def test_max_moves_per_plan_caps_batch():
    p = _planner(max_moves_per_plan=2)
    vols = {vid: {"reads": 0, "rung": "hot", "size": 10,
                  "read_only": True} for vid in (1, 2, 3, 4, 5)}
    p.observe("vs1", {"volumes": vols}, now=0.0)
    p.observe("vs1", {"volumes": vols}, now=4.0)
    plan = p.plan(now=4.0)
    assert len(plan["moves"]) == 2
    # the rest follow once the first batch commits
    for mv in plan["moves"]:
        p.note_committed(mv["vid"], now=4.0)
    assert len(p.plan(now=4.0)["moves"]) == 2


# ---- cloud-tier backend seam ----------------------------------------

_STUB_BODY = bytes(range(256)) * 5  # 1280 bytes


class _NoHeadStub(BaseHTTPRequestHandler):
    """An S3-ish endpoint with two common real-world quirks: HEAD is
    not supported (405) and Range is ignored (always 200 + full
    body)."""
    protocol_version = "HTTP/1.1"

    def do_HEAD(self):
        self.send_response(405)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(_STUB_BODY)))
        self.end_headers()
        self.wfile.write(_STUB_BODY)

    def log_message(self, *a):
        pass


@pytest.fixture
def stub_endpoint():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _NoHeadStub)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_size_falls_back_to_get_without_head(stub_endpoint):
    b = S3BackendFile(stub_endpoint, "bkt", "k")
    assert b.size() == len(_STUB_BODY)
    assert b.size() == len(_STUB_BODY)  # cached: no second round trip


def test_read_at_slices_a_200_full_body(stub_endpoint):
    # an endpoint that ignores Range answers 200 + everything; read_at
    # must hand back exactly the requested slice anyway
    b = S3BackendFile(stub_endpoint, "bkt", "k")
    assert b.read_at(37, 100) == _STUB_BODY[37:137]
    assert b.read_at(0, 1) == _STUB_BODY[:1]
    assert b.read_at(len(_STUB_BODY) - 5, 5) == _STUB_BODY[-5:]


def test_tier_to_failure_reopens_local_dat(tmp_path, monkeypatch):
    # a transient tier-endpoint outage mid-demotion must leave the
    # volume exactly as it was: local .dat reopened, writability
    # restored, every read served — never a closed-handle zombie
    import seaweedfs_tpu_torch.storage.backend as backend_mod

    v = Volume(str(tmp_path), "", 11)
    data = b"y" * 64
    n = Needle(id=1, cookie=5, data=data)
    n.set_flags_from_fields()
    v.write_needle(n)
    v.sync()

    def boom(*a, **kw):
        raise ConnectionError("tier endpoint down")

    monkeypatch.setattr(backend_mod, "tier_volume_to_s3", boom)
    with pytest.raises(ConnectionError):
        v.tier_to("http://127.0.0.1:1", "tier")
    assert not v.is_tiered
    assert v.read_only is False
    assert v.read_needle(1).data == data
    assert v.content_size() > 0
    n2 = Needle(id=2, cookie=5, data=b"z" * 16)
    n2.set_flags_from_fields()
    v.write_needle(n2)                       # still writable
    assert v.read_needle(2).data == b"z" * 16
    v.close()


def test_untier_download_error_cleans_tmp(tmp_path):
    # a failed promotion download must remove .dat.tmp and leave the
    # volume serving from the tier (only the verify path did before)
    v = Volume(str(tmp_path), "", 9)
    n = Needle(id=1, cookie=5, data=b"q" * 32)
    n.set_flags_from_fields()
    v.write_needle(n)
    v.sync()

    class _DownBackend:
        def size(self):
            return 1000

        def read_at(self, offset, length):
            raise ConnectionError("tier endpoint down")

    v._dat.close()
    v._dat = None
    v._backend = _DownBackend()
    v.read_only = True
    with pytest.raises(ConnectionError):
        v.untier()
    assert not os.path.exists(str(tmp_path / "9.dat.tmp"))
    assert v.is_tiered                       # still on the cloud rung
    assert not v._untiering                  # a retry is admissible


def test_gateway_roundtrip_demote_promote_bit_identical(tmp_path):
    """Full rung cycle against our own S3 gateway: seal -> tier_to
    (verified demotion) -> serve needles from the cloud rung (206
    range path) -> untier (verified promotion) -> byte-identical
    .dat and identical needle reads at every step."""
    from seaweedfs_tpu_torch.gateway.s3_server import S3Server
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.backend import S3BackendFile as SBF
    from seaweedfs_tpu_torch.utils.httpd import http_call

    master = MasterServer()
    master.start()
    vs = _cpu_vs([str(tmp_path / "vols")], master.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    s3 = S3Server(fs)
    s3.start()
    time.sleep(0.1)
    try:
        http_call("PUT", f"http://{s3.url}/tier")
        vdir = tmp_path / "data"
        vdir.mkdir()
        v = Volume(str(vdir), "", 7)
        payloads = {}
        for i in range(10):
            data = bytes([i]) * (100 + i * 37)
            payloads[i + 1] = data
            n = Needle(id=i + 1, cookie=5, data=data,
                       name=f"n{i}.bin".encode())
            n.set_flags_from_fields()
            v.write_needle(n)
        v.sync()
        base = str(vdir / "7")
        with open(base + ".dat", "rb") as f:
            original = f.read()

        # node-unique key, as the volume server passes in production
        # (replicas must never share one object)
        v.tier_to(f"http://{s3.url}", "tier", key="nodeA_7.dat")
        assert v.is_tiered
        assert not os.path.exists(base + ".dat")
        for nid, data in payloads.items():
            assert v.read_needle(nid).data == data
        backend = v._backend
        assert isinstance(backend, SBF)
        assert backend.key == "nodeA_7.dat"
        assert backend.size() == len(original)
        assert backend.read_at(17, 31) == original[17:48]  # 206 path

        v.untier()
        assert not v.is_tiered
        with open(base + ".dat", "rb") as f:
            assert f.read() == original
        for nid, data in payloads.items():
            assert v.read_needle(nid).data == data
        v.close()
    finally:
        s3.stop()
        fs.stop()
        vs.stop()
        master.stop()


def _make_volume(tmp_path, vid=1, n=20):
    v = Volume(str(tmp_path), "", vid)
    payloads = {}
    for i in range(n):
        data = bytes([i % 256]) * (i * 7 + 3)
        payloads[i + 1] = data
        n = Needle(id=i + 1, cookie=5, data=data,
                   name=f"n{i}.bin".encode())
        n.set_flags_from_fields()
        v.write_needle(n)
    return v, payloads


def test_backend_spi(tmp_path):
    d = DiskFile(str(tmp_path / "x.bin"), create=True)
    d.write_at(0, b"hello")
    d.write_at(5, b"world")
    assert d.read_at(0, 10) == b"helloworld"
    assert d.size() == 10
    d.truncate(5)
    assert d.size() == 5
    d.close()

    m = MemoryFile(b"abc")
    assert m.read_at(1, 2) == b"bc"
    m.write_at(3, b"def")
    assert m.size() == 6


def test_tier_volume_to_s3_and_read_back(tmp_path):
    """Tier a sealed .dat into our own S3 gateway, then range-read it."""
    from seaweedfs_tpu_torch.gateway.s3_server import S3Server
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.utils.httpd import http_call

    master = MasterServer()
    master.start()
    vs = _cpu_vs([str(tmp_path / "vols")], master.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    s3 = S3Server(fs)
    s3.start()
    time.sleep(0.1)
    try:
        http_call("PUT", f"http://{s3.url}/tier")
        v, payloads = _make_volume(tmp_path, vid=9, n=8)
        v.close()
        base = str(tmp_path / "9")
        with open(base + ".dat", "rb") as f:
            original = f.read()
        info = tier_volume_to_s3(base, f"http://{s3.url}", "tier")
        assert not os.path.exists(base + ".dat")
        assert info["remote"]["bucket"] == "tier"

        backend = open_backend_for_volume(base)
        assert isinstance(backend, S3BackendFile)
        assert backend.read_at(0, 8) == original[:8]
        assert backend.read_at(100, 50) == original[100:150]
    finally:
        s3.stop()
        fs.stop()
        vs.stop()
        master.stop()
