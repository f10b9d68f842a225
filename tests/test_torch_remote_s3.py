"""S3-protocol remote storage client:
an S3Remote speaks SigV4 to any S3-compatible endpoint — here the
repo's OWN gateway, standing in for a cloud bucket. Covers the SPI,
remote mount + metadata pull + cache/uncache/writeback through the
filer, exactly like the local backend tests but across the wire.
Reference: weed/remote_storage/s3/s3_storage_client.go.

The port's copy of ref tests/test_remote_s3.py: the same cases on the port's
gateway, filer and master, its volume servers on device="cpu"."""

import time

import pytest

from seaweedfs_tpu_torch.gateway.s3_server import S3Server
from seaweedfs_tpu_torch.remote_storage.remote_storage import (RemoteConf,
                                                         make_remote_client)
from seaweedfs_tpu_torch.remote_storage.s3_client import S3Remote
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.utils.httpd import http_call


def _cpu_vs(dirs, master_url, **kw):
    """The port's volume server on the kernels' plain versions (the
    tests run without a card)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(dirs, master_url, device="cpu", **kw)


@pytest.fixture
def cloud(tmp_path):
    """A full 'cloud': master + volume + filer + SigV4-authenticated S3
    gateway, plus a LOCAL cluster (second filer) that mounts it."""
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _cpu_vs([str(tmp_path / "v0")], master.url)
    vs.start()
    cloud_fs = FilerServer(master.url)
    cloud_fs.start()
    s3 = S3Server(cloud_fs, access_key="AKIDEXAMPLE",
                  secret_key="wJalrXUtnFEMI")
    s3.start()
    local_fs = FilerServer(master.url)
    local_fs.start()
    time.sleep(0.2)
    yield s3, local_fs
    local_fs.stop()
    s3.stop()
    cloud_fs.stop()
    vs.stop()
    master.stop()


def _mk_bucket(s3, name: str):
    from seaweedfs_tpu_torch.remote_storage.s3_client import SigV4Signer
    signer = SigV4Signer("AKIDEXAMPLE", "wJalrXUtnFEMI")
    headers = signer.signed_headers(
        "PUT", f"127.0.0.1:{s3.http.port}", f"/{name}", {}, b"")
    status, body, _ = http_call(
        "PUT", f"http://127.0.0.1:{s3.http.port}/{name}", headers=headers)
    assert status < 300, body


def test_s3_remote_client_spi(cloud):
    s3, _ = cloud
    _mk_bucket(s3, "cloudbucket")
    c = make_remote_client(RemoteConf(
        name="aws", type="s3", endpoint=f"127.0.0.1:{s3.http.port}",
        bucket="cloudbucket", access_key="AKIDEXAMPLE",
        secret_key="wJalrXUtnFEMI"))
    assert isinstance(c, S3Remote)

    c.write_file("docs/a.txt", b"alpha")
    c.write_file("docs/deep/b.bin", b"B" * 5000)
    c.write_file("top.txt", b"top")

    assert c.read_file("docs/a.txt") == b"alpha"
    assert c.read_file("docs/deep/b.bin", offset=10, size=20) == b"B" * 20

    st = c.stat("docs/a.txt")
    assert st is not None and st.size == 5 and st.etag
    assert c.stat("missing.txt") is None

    listing = list(c.traverse())
    files = {f.path: f for f in listing if not f.is_directory}
    dirs = {f.path for f in listing if f.is_directory}
    assert set(files) == {"docs/a.txt", "docs/deep/b.bin", "top.txt"}
    assert {"docs", "docs/deep"} <= dirs
    assert files["docs/deep/b.bin"].size == 5000
    assert files["docs/a.txt"].etag == st.etag

    # prefix traverse
    sub = {f.path for f in c.traverse("docs/deep") if not f.is_directory}
    assert sub == {"docs/deep/b.bin"}

    c.remove_file("top.txt")
    assert c.stat("top.txt") is None


def test_gcs_b2_types_ride_the_s3_dialect(cloud):
    """gcs/b2/wasabi are S3-dialect endpoints: the same client serves
    them, pointed at the provider's interop endpoint (here the local
    gateway stands in)."""
    s3, _ = cloud
    _mk_bucket(s3, "interop")
    for t in ("gcs", "b2", "wasabi"):
        c = make_remote_client(RemoteConf(
            name=t, type=t, endpoint=f"127.0.0.1:{s3.http.port}",
            bucket="interop", access_key="AKIDEXAMPLE",
            secret_key="wJalrXUtnFEMI"))
        assert isinstance(c, S3Remote)
        c.write_file(f"{t}.txt", t.encode())
        assert c.read_file(f"{t}.txt") == t.encode()
    # azure speaks its own wire protocol via the SharedKey REST client
    # (tests/test_azure_remote.py); a truly unknown type stays a plug
    # point
    with pytest.raises(NotImplementedError):
        make_remote_client(RemoteConf(name="x", type="hdfs"))


def test_s3_remote_bad_credentials_rejected(cloud):
    s3, _ = cloud
    _mk_bucket(s3, "lockedbucket")
    bad = S3Remote(f"127.0.0.1:{s3.http.port}", "lockedbucket",
                   access_key="AKIDEXAMPLE", secret_key="WRONG")
    with pytest.raises(IOError):
        bad.write_file("x.txt", b"nope")


def test_s3_remote_mount_pull_cache_writeback(cloud, tmp_path):
    """The full remote-mount lifecycle against the S3 remote: configure
    + mount + meta pull + read-through + cache + writeback (reference
    shell remote.mount/remote.cache + filer.remote.sync)."""
    s3, local_fs = cloud
    _mk_bucket(s3, "mnt")
    conf = RemoteConf(name="cloudy", type="s3",
                      endpoint=f"127.0.0.1:{s3.http.port}", bucket="mnt",
                      access_key="AKIDEXAMPLE",
                      secret_key="wJalrXUtnFEMI")
    # seed the "cloud"
    seed = make_remote_client(conf)
    seed.write_file("photos/cat.jpg", b"\xff\xd8meow" * 100)
    seed.write_file("notes.md", b"# hello from the cloud")

    rm = local_fs.remote_mounts
    rm.configure(conf)
    rm.mount("/clouddata", "cloudy")
    n = rm.pull_metadata("/clouddata")
    assert n >= 2

    # metadata only: entries carry RemoteEntry, no chunks yet
    e = local_fs.filer.find_entry("/clouddata/notes.md")
    assert e is not None and e.remote is not None and not e.chunks
    assert e.file_size() == len(b"# hello from the cloud")

    # read-through via the filer HTTP plane fetches from the S3 remote
    status, body, _ = http_call(
        "GET", f"http://{local_fs.url}/clouddata/notes.md")
    assert status == 200 and body == b"# hello from the cloud"

    # cache materializes local chunks
    status, body, _ = http_call(
        "POST", f"http://{local_fs.url}/__api/remote/cache",
        json_body={"path": "/clouddata/photos/cat.jpg"})
    assert status == 200, body
    e = local_fs.filer.find_entry("/clouddata/photos/cat.jpg")
    assert e.chunks
    status, body, _ = http_call(
        "GET", f"http://{local_fs.url}/clouddata/photos/cat.jpg")
    assert status == 200 and body == b"\xff\xd8meow" * 100

    # uncache drops the local copy, keeps the remote pointer
    status, _, _ = http_call(
        "POST", f"http://{local_fs.url}/__api/remote/uncache",
        json_body={"path": "/clouddata/photos/cat.jpg"})
    assert status == 200
    e = local_fs.filer.find_entry("/clouddata/photos/cat.jpg")
    assert not e.chunks and e.remote is not None

    # local write + writeback pushes to the cloud
    status, _, _ = http_call(
        "POST", f"http://{local_fs.url}/clouddata/new.txt",
        body=b"written locally")
    assert status < 300
    status, body, _ = http_call(
        "POST", f"http://{local_fs.url}/__api/remote/writeback",
        json_body={"path": "/clouddata/new.txt"})
    assert status == 200, body
    assert seed.read_file("new.txt") == b"written locally"
