"""WebDAV gateway + fs shell commands + filer.copy, and the FTP gateway.

The port's copy of ref tests/test_webdav_fs.py and the FTP half of
tests/test_cipher_ftp.py (test_ftp_full_session, test_ftp_auth_required),
on the port's gateways, filer and master, its volume servers on
device="cpu"."""

import ftplib
import io
import time
import urllib.request
import xml.etree.ElementTree as ET

import pytest

from seaweedfs_tpu_torch.gateway.ftp_server import FtpServer
from seaweedfs_tpu_torch.gateway.webdav_server import WebDavServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.fs_commands import (FsContext, filer_copy,
                                             filer_download)
from seaweedfs_tpu_torch.utils.httpd import http_call


def _cpu_vs(dirs, master_url, **kw):
    """The port's volume server on the kernels' plain versions (the
    tests run without a card)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(dirs, master_url, device="cpu", **kw)


@pytest.fixture
def stack(tmp_path):
    master = MasterServer()
    master.start()
    vs = _cpu_vs([str(tmp_path / "v")], master.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    dav = WebDavServer(fs)
    dav.start()
    time.sleep(0.1)
    yield master, vs, fs, dav, tmp_path
    dav.stop()
    fs.stop()
    vs.stop()
    master.stop()


def _dav(method, url, body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_webdav_lifecycle(stack):
    master, vs, fs, dav, tmp = stack
    base = f"http://{dav.url}"

    status, _, headers = _dav("OPTIONS", base + "/")
    assert status == 200 and "PROPFIND" in headers["Allow"]

    status, _, _ = _dav("MKCOL", base + "/www")
    assert status == 201

    status, _, _ = _dav("PUT", base + "/www/index.html",
                        body=b"<html>hi</html>",
                        headers={"Content-Type": "text/html"})
    assert status == 201

    status, body, _ = _dav("GET", base + "/www/index.html")
    assert status == 200 and body == b"<html>hi</html>"

    status, body, _ = _dav("PROPFIND", base + "/www",
                           headers={"Depth": "1"})
    assert status == 207
    ms = ET.fromstring(body)
    hrefs = [h.text for h in ms.iter("{DAV:}href")]
    assert any("index.html" in h for h in hrefs)
    lengths = [c.text for c in ms.iter("{DAV:}getcontentlength")]
    assert "15" in lengths

    status, _, _ = _dav("MOVE", base + "/www/index.html",
                        headers={"Destination": base + "/www/home.html"})
    assert status == 201
    status, body, _ = _dav("GET", base + "/www/home.html")
    assert status == 200 and body == b"<html>hi</html>"
    assert _dav("GET", base + "/www/index.html")[0] == 404

    status, _, _ = _dav("COPY", base + "/www/home.html",
                        headers={"Destination": base + "/www/copy.html"})
    assert status == 201
    assert _dav("GET", base + "/www/copy.html")[1] == b"<html>hi</html>"

    status, _, _ = _dav("DELETE", base + "/www/home.html")
    assert status == 204
    assert _dav("GET", base + "/www/home.html")[0] == 404


def test_fs_commands_and_filer_copy(stack):
    master, vs, fs, dav, tmp = stack
    ctx = FsContext(fs.url)

    src = tmp / "local"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"AAA")
    (src / "sub" / "b.txt").write_bytes(b"BBB" * 2000)
    copied = filer_copy(fs.url, [str(src)], "/import")
    assert copied == 2

    assert ctx.cat("/import/local/a.txt") == b"AAA"
    assert ctx.cat("/import/local/sub/b.txt") == b"BBB" * 2000
    names = sorted(e["FullPath"] for e in ctx.ls("/import/local"))
    assert names == ["/import/local/a.txt", "/import/local/sub"]

    files, size = ctx.du("/import")
    assert files == 2 and size == 3 + 6000

    tree = ctx.tree("/import")
    assert any("b.txt" in line for line in tree)

    out = tmp / "download"
    n = filer_download(fs.url, "/import/local", str(out))
    assert n == 2
    assert (out / "sub" / "b.txt").read_bytes() == b"BBB" * 2000

    ctx.mv("/import/local/a.txt", "/import/renamed.txt")
    assert ctx.cat("/import/renamed.txt") == b"AAA"
    ctx.rm("/import", recursive=True)
    with pytest.raises(FileNotFoundError):
        ctx.cat("/import/renamed.txt")


@pytest.fixture
def ftp_stack(tmp_path):
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = _cpu_vs([str(tmp_path / "v0")], master.url)
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    ftp = FtpServer(fs)
    ftp.start()
    time.sleep(0.2)
    yield master, vs, fs, ftp
    ftp.stop()
    fs.stop()
    vs.stop()
    master.stop()


def test_ftp_full_session(ftp_stack):
    _, _, fs, ftp = ftp_stack
    c = ftplib.FTP()
    c.connect(ftp.host, ftp.port, timeout=10)
    c.login()  # anonymous
    assert c.pwd() == "/"

    c.mkd("/docs")
    c.cwd("/docs")
    payload = b"hello from ftp" * 1000
    c.storbinary("STOR report.bin", io.BytesIO(payload))

    assert c.size("report.bin") == len(payload)
    names = c.nlst()
    assert "report.bin" in names
    lines = []
    c.retrlines("LIST", lines.append)
    assert any("report.bin" in l for l in lines)

    got = io.BytesIO()
    c.retrbinary("RETR report.bin", got.write)
    assert got.getvalue() == payload

    # the file is a real filer entry, visible over HTTP too
    status, body, _ = http_call("GET", f"http://{fs.url}/docs/report.bin")
    assert status == 200 and body == payload

    # filenames with spaces survive the loopback store path
    c.storbinary("STOR my report.txt", io.BytesIO(b"spaced"))
    got2 = io.BytesIO()
    c.retrbinary("RETR my report.txt", got2.write)
    assert got2.getvalue() == b"spaced"
    c.delete("my report.txt")

    c.rename("report.bin", "final.bin")
    assert "final.bin" in c.nlst()
    c.delete("final.bin")
    assert "final.bin" not in c.nlst()
    c.cwd("/")
    c.rmd("/docs")
    c.quit()


def test_ftp_auth_required(tmp_path):
    master = MasterServer()
    master.start()
    fs = FilerServer(master.url)
    fs.start()
    ftp = FtpServer(fs, user="admin", password="hunter2")
    ftp.start()
    try:
        c = ftplib.FTP()
        c.connect(ftp.host, ftp.port, timeout=10)
        with pytest.raises(ftplib.error_perm):
            c.login("admin", "wrong")
        c2 = ftplib.FTP()
        c2.connect(ftp.host, ftp.port, timeout=10)
        c2.login("admin", "hunter2")
        assert c2.pwd() == "/"
        c2.quit()
    finally:
        ftp.stop()
        fs.stop()
        master.stop()
