"""The port's Azure Blob client (remote_storage/azure_client.py) held
against the JAX package's: blob CRUD, ranged reads and listing against
MiniAzureServer (which checks every SharedKey signature), a bad key
refused, make_remote_client's azure type, the replication AzureSink fed
by FilerSync, and the remote registry's plug point for an unknown type;
across the packages: shared_key_signature byte-equal on seeded requests,
and each package's client against the other's server with equal answers.
The port's volume servers run with device="cpu".
(ref tests/test_azure_remote.py, test_remote_storage.py's registry case.)
"""

import base64
import time

import numpy as np
import pytest

import seaweedfs_tpu.remote_storage.azure_client as j_azure
import seaweedfs_tpu_torch.remote_storage.azure_client as p_azure
from seaweedfs_tpu_torch.remote_storage.azure_client import (AzureRemote,
                                                             MiniAzureServer)
from seaweedfs_tpu_torch.remote_storage.remote_storage import (
    RemoteConf, make_remote_client)

KEY = base64.b64encode(b"super-secret-account-key").decode()
PKG = {"port": p_azure, "jax": j_azure}


@pytest.fixture
def azure():
    srv = MiniAzureServer(account="acct", key_b64=KEY).start()
    yield srv, AzureRemote(srv.url, "box", "acct", KEY)
    srv.stop()


def test_blob_crud_and_list(azure):
    srv, c = azure
    c.write_file("docs/a.txt", b"alpha")
    c.write_file("docs/b.txt", b"bravo-bravo")
    c.write_file("other/c.txt", b"charlie")
    assert c.read_file("docs/a.txt") == b"alpha"
    assert c.read_file("docs/b.txt", offset=6, size=5) == b"bravo"
    st = c.stat("docs/b.txt")
    assert st is not None and st.size == 11
    assert c.stat("missing.txt") is None
    assert sorted(f.path for f in c.traverse()) == [
        "docs/a.txt", "docs/b.txt", "other/c.txt"]
    assert [f.path for f in c.traverse(prefix="docs/")] == [
        "docs/a.txt", "docs/b.txt"]
    c.remove_file("docs/a.txt")
    assert c.stat("docs/a.txt") is None
    c.remove_file("docs/a.txt")  # idempotent


def test_bad_key_rejected(azure):
    srv, _ = azure
    bad = AzureRemote(srv.url, "box", "acct",
                      base64.b64encode(b"wrong").decode())
    with pytest.raises(ConnectionError, match="403"):
        bad.write_file("x", b"data")
    assert not srv.blobs


def test_registry_builds_azure_client(azure):
    srv, _ = azure
    client = make_remote_client(RemoteConf(
        name="az", type="azure", endpoint=srv.url, bucket="box",
        access_key="acct", secret_key=KEY))
    client.write_file("via-registry.txt", b"hello")
    assert srv.blobs["box"]["via-registry.txt"] == b"hello"


def test_azure_sink_replication(azure, tmp_path):
    from seaweedfs_tpu_torch.replication.sink import AzureSink
    from seaweedfs_tpu_torch.replication.sync import FilerSync
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.utils.httpd import http_call
    srv, _ = azure
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, device="cpu")
    vs.start()
    src = FilerServer(master.url)
    src.start()
    time.sleep(0.1)
    try:
        sync = FilerSync(src.url, AzureSink(srv.url, "box", "acct", KEY,
                                            prefix="backup"))
        http_call("POST", f"http://{src.url}/m/doc.txt", body=b"payload")
        sync.run_once(0)
        assert srv.blobs["box"]["backup/m/doc.txt"] == b"payload"
        http_call("DELETE", f"http://{src.url}/m/doc.txt")
        sync.run_once(0)
        assert "backup/m/doc.txt" not in srv.blobs["box"]
    finally:
        src.stop()
        vs.stop()
        master.stop()


def test_unknown_remote_type_is_plug_point():
    with pytest.raises(ValueError):  # azure without a container
        make_remote_client(RemoteConf(name="x", type="azure"))
    with pytest.raises(NotImplementedError):
        make_remote_client(RemoteConf(name="x", type="hdfs"))
    with pytest.raises(ValueError):
        make_remote_client(RemoteConf(name="x", type="s3"))


# ---------------- across the packages ----------------


def test_shared_key_signature_matches_jax():
    """The StringToSign and its HMAC, byte for byte, on seeded requests:
    every method, with and without a body, range and x-ms headers, query
    parameters in any order."""
    rng = np.random.default_rng(17)
    for i in range(64):
        key = base64.b64encode(rng.bytes(int(rng.integers(8, 64)))).decode()
        method = ["GET", "PUT", "DELETE", "HEAD"][i % 4]
        headers = {"x-ms-version": "2020-10-02",
                   "x-ms-date": f"Mon, {i:02d} Jan 2024 00:00:00 GMT",
                   "content-length": str(int(rng.integers(0, 3)) * i)}
        if i % 3 == 0:
            headers["range"] = f"bytes={i}-{i * 7}"
        if i % 5 == 0:
            headers["x-ms-blob-type"] = "BlockBlob"
            headers["content-type"] = "application/octet-stream"
        query = {k: str(int(rng.integers(100))) for k in
                 rng.choice(["restype", "comp", "prefix", "marker"],
                            int(rng.integers(0, 4)), replace=False)}
        path = f"/box/dir{i}/blob-{rng.bytes(4).hex()}"
        args = ("acct", key, method, path, query, headers)
        assert p_azure.shared_key_signature(*args) == \
            j_azure.shared_key_signature(*args)


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_clients_and_servers_across_packages(client, server):
    """Each package's AzureRemote against the other's MiniAzureServer
    (which verifies its SharedKey signatures): the same answers and the
    same stored blobs as against a server of its own package."""
    rng = np.random.default_rng(4)
    blobs = {f"d{i % 2}/b{i}.bin": rng.bytes(int(rng.integers(0, 5000)))
             for i in range(8)}
    seen = {}
    for sp in (server, client):
        srv = PKG[sp].MiniAzureServer(account="acct", key_b64=KEY).start()
        try:
            c = PKG[client].AzureRemote(srv.url, "box", "acct", KEY)
            for path, data in blobs.items():
                c.write_file(path, data)
            out = [sorted((f.path, f.size) for f in c.traverse()),
                   [(f.path, f.size) for f in c.traverse(prefix="d1/")],
                   [c.read_file(p) for p in blobs],
                   [c.read_file(p, offset=3, size=20) for p in blobs],
                   [(s.size if (s := c.stat(p)) else None)
                    for p in [*blobs, "nope"]]]
            c.remove_file("d0/b0.bin")
            out.append(sorted(srv.blobs["box"]))
            seen[sp] = out
        finally:
            srv.stop()
    assert seen[server] == seen[client]
    assert seen[server][2] == list(blobs.values())
