"""Standalone gateways over a remote filer via RemoteFilerStore
(reference weed/command/s3.go — gateways dial a filer they don't host).

The port's copy of ref tests/test_remote_gateway.py: the same cases on the port's
gateway, filer and master, its volume servers on device="cpu"."""

import time

import pytest

from seaweedfs_tpu_torch.filer.remote_store import RemoteFilerStore
from seaweedfs_tpu_torch.gateway.s3_server import S3Server
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils.httpd import http_call, http_json


def _cpu_vs(dirs, master_url, **kw):
    """The port's volume server on the kernels' plain versions (the
    tests run without a card)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(dirs, master_url, device="cpu", **kw)


@pytest.fixture
def stack(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _cpu_vs([str(tmp_path / "v0")], master.url)
    vs.start()
    home_filer = FilerServer(master.url)  # owns the metadata
    home_filer.start()
    # the gateway process: remote metadata, local chunk plumbing
    gw_fs = FilerServer(master.url, store="remote",
                        store_dir=home_filer.url, announce=False)
    gw_fs.start()
    s3 = S3Server(gw_fs)
    s3.start()
    time.sleep(0.2)
    yield master, vs, home_filer, gw_fs, s3
    s3.stop()
    gw_fs.stop()
    home_filer.stop()
    vs.stop()
    master.stop()


def test_remote_store_contract(stack):
    _, _, home, gw_fs, _ = stack
    store = RemoteFilerStore(home.url)
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    store.insert_entry(Entry("/rc/x.txt", Attr(file_size=3)))
    assert store.find_entry("/rc/x.txt").attr.file_size == 3
    assert store.find_entry("/rc/missing") is None
    store.insert_entry(Entry("/rc/y.txt"))
    names = [e.name for e in store.list_directory_entries("/rc")]
    assert names == ["x.txt", "y.txt"]
    names = [e.name for e in store.list_directory_entries(
        "/rc", prefix="y")]
    assert names == ["y.txt"]
    store.delete_entry("/rc/y.txt")
    assert store.find_entry("/rc/y.txt") is None
    store.kv_put(b"gwconf", b"\x01\x02")
    assert store.kv_get(b"gwconf") == b"\x01\x02"
    store.kv_delete(b"gwconf")
    assert store.kv_get(b"gwconf") is None


def test_s3_gateway_over_remote_filer(stack):
    _, _, home, gw_fs, s3 = stack
    base = f"http://{s3.url}"
    status, _, _ = http_call("PUT", f"{base}/remote-bucket")
    assert status < 400
    payload = b"object through a detached gateway" * 500
    status, _, _ = http_call("PUT", f"{base}/remote-bucket/obj.bin",
                             body=payload)
    assert status < 400

    # the object's metadata lives on the HOME filer, chunks on volumes
    entry = home.filer.find_entry("/buckets/remote-bucket/obj.bin")
    assert entry is not None and (entry.chunks or entry.content)
    # readable via the home filer's own HTTP surface too
    status, body, _ = http_call(
        "GET", f"http://{home.url}/buckets/remote-bucket/obj.bin")
    assert status == 200 and body == payload

    # and back out through the gateway
    status, body, _ = http_call("GET", f"{base}/remote-bucket/obj.bin")
    assert status == 200 and body == payload

    # listing + delete through the gateway
    status, body, _ = http_call("GET", f"{base}/remote-bucket?list-type=2")
    assert b"obj.bin" in body
    status, _, _ = http_call("DELETE", f"{base}/remote-bucket/obj.bin")
    assert status < 400
    assert home.filer.find_entry("/buckets/remote-bucket/obj.bin") is None


def test_gateway_writes_visible_to_home_meta_log(stack):
    _, _, home, gw_fs, s3 = stack
    before = len(home.filer.meta_log.read_since(0, limit=1 << 16))
    http_call("PUT", f"http://{s3.url}/evbucket")
    http_call("PUT", f"http://{s3.url}/evbucket/e.txt", body=b"ev")
    # row-level writes still reach the home filer's store; the home
    # filer can serve them (sync/backup tools read the aggregated view)
    assert home.filer.find_entry("/buckets/evbucket/e.txt") is not None
