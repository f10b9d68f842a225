"""fs.* shell commands + filer.copy: filer namespace operations from the
admin shell / CLI (reference weed/shell/command_fs_*.go and
weed/command/filer_copy.go).

The port's copy of seaweedfs_tpu/shell/fs_commands.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import os
import urllib.parse

from seaweedfs_tpu_torch.utils.httpd import HttpError, http_call, http_json


class FsContext:
    def __init__(self, filer_url: str):
        self.filer_url = filer_url

    def _url(self, path: str) -> str:
        return f"http://{self.filer_url}{urllib.parse.quote(path)}"

    def ls(self, path: str = "/", limit: int = 1024) -> list[dict]:
        out = http_json("GET", self._url(path) + f"?limit={limit}")
        if "Entries" in out:
            return out["Entries"]
        raise NotADirectoryError(path)

    def cat(self, path: str) -> bytes:
        status, body, _ = http_call("GET", self._url(path))
        if status >= 400:
            raise FileNotFoundError(path)
        return body

    def put(self, path: str, data: bytes) -> None:
        status, body, _ = http_call("POST", self._url(path), body=data)
        if status >= 400:
            raise IOError(f"put {path}: HTTP {status}")

    def rm(self, path: str, recursive: bool = False) -> None:
        url = self._url(path)
        if recursive:
            url += "?recursive=true"
        status, body, _ = http_call("DELETE", url)
        if status >= 400 and status != 404:
            raise IOError(f"rm {path}: HTTP {status}")

    def mkdir(self, path: str) -> None:
        http_call("POST", self._url(path) + "?mkdir=true", body=b"")

    def mv(self, src: str, dst: str) -> None:
        http_json("POST", f"http://{self.filer_url}/__api/rename",
                  {"from": src, "to": dst})

    def du(self, path: str = "/") -> tuple[int, int]:
        """(file_count, byte_count) below path."""
        files = 0
        size = 0
        stack = [path]
        while stack:
            p = stack.pop()
            try:
                entries = self.ls(p, limit=1 << 20)
            except NotADirectoryError:
                continue
            for e in entries:
                if e["IsDirectory"]:
                    stack.append(e["FullPath"])
                else:
                    files += 1
                    size += e["FileSize"]
        return files, size

    def tree(self, path: str = "/", depth: int = 10) -> list[str]:
        out = []

        def walk(p, d):
            if d > depth:
                return
            try:
                entries = self.ls(p, limit=1 << 20)
            except NotADirectoryError:
                return
            for e in entries:
                name = e["FullPath"].rsplit("/", 1)[-1]
                out.append("  " * d + name + ("/" if e["IsDirectory"] else ""))
                if e["IsDirectory"]:
                    walk(e["FullPath"], d + 1)
        walk(path, 0)
        return out


def filer_copy(filer_url: str, local_paths: list[str],
               dest_dir: str) -> int:
    """Copy local files/directories into the filer
    (reference command/filer_copy.go). Returns files copied."""
    fs = FsContext(filer_url)
    dest_dir = "/" + dest_dir.strip("/")
    count = 0
    for local in local_paths:
        if os.path.isdir(local):
            base = os.path.basename(os.path.abspath(local))
            for root, _dirs, files in os.walk(local):
                rel = os.path.relpath(root, local)
                for fname in files:
                    sub = "" if rel == "." else rel + "/"
                    with open(os.path.join(root, fname), "rb") as f:
                        fs.put(f"{dest_dir}/{base}/{sub}{fname}", f.read())
                    count += 1
        else:
            with open(local, "rb") as f:
                fs.put(f"{dest_dir}/{os.path.basename(local)}", f.read())
            count += 1
    return count


def filer_download(filer_url: str, filer_path: str, local_dir: str) -> int:
    """Inverse of filer_copy: download a filer subtree to local disk."""
    fs = FsContext(filer_url)
    os.makedirs(local_dir, exist_ok=True)
    count = 0
    try:
        entries = fs.ls(filer_path, limit=1 << 20)
    except NotADirectoryError:
        data = fs.cat(filer_path)
        with open(os.path.join(local_dir,
                               filer_path.rsplit("/", 1)[-1]), "wb") as f:
            f.write(data)
        return 1
    for e in entries:
        name = e["FullPath"].rsplit("/", 1)[-1]
        if e["IsDirectory"]:
            count += filer_download(filer_url, e["FullPath"],
                                    os.path.join(local_dir, name))
        else:
            with open(os.path.join(local_dir, name), "wb") as f:
                f.write(fs.cat(e["FullPath"]))
            count += 1
    return count


def fs_meta_save(filer_url: str, root: str, out_path: str) -> int:
    """Dump the filer metadata tree below `root` to a JSONL file
    (reference shell fs.meta.save / command_fs_meta_save.go; entries
    carry their chunk lists, not the data). Returns entries written."""
    import json

    fs = FsContext(filer_url)
    count = 0
    with open(out_path, "w") as out:
        stack = [("/" + root.strip("/")) or "/"]
        while stack:
            path = stack.pop()
            try:
                entries = fs.ls(path, limit=1 << 20)
            except NotADirectoryError:
                entries = []
            for e in entries:
                full = http_json(
                    "GET", f"http://{filer_url}/__api/entry"
                           f"?path={urllib.parse.quote(e['FullPath'])}")
                out.write(json.dumps(full["entry"]) + "\n")
                count += 1
                if e["IsDirectory"]:
                    stack.append(e["FullPath"])
    return count


def fs_meta_load(filer_url: str, in_path: str) -> int:
    """Recreate entries from an fs.meta.save dump (reference shell
    fs.meta.load). Chunk fids must still resolve in the target cluster
    (same semantics as the reference: metadata only)."""
    import json

    count = 0
    with open(in_path) as f:
        for line in f:
            if not line.strip():
                continue
            http_json("POST", f"http://{filer_url}/__api/entry",
                      {"entry": json.loads(line)})
            count += 1
    return count
