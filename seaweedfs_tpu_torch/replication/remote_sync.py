"""filer.remote.sync: continuously push local writes under a remote
mount back to the cloud remote.

Functional equivalent of reference weed/command/filer_remote_sync.go +
filer_remote_gateway.go: subscribe to the filer's metadata change stream
filtered to the mount directory and mirror creates/updates/deletes to the
remote store. The data/credential plane stays inside the filer (the
/__api/remote/writeback and /__api/remote/rm endpoints), so this process
needs only the filer address — like the reference, which runs
`weed filer.remote.sync -filer=...` as a sidecar process.

The port's copy of seaweedfs_tpu/replication/remote_sync.py. It imports
nothing of that package.
"""

from __future__ import annotations

import threading
from typing import Optional

from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json


class FilerRemoteSync:
    def __init__(self, filer_url: str, mount_dir: str):
        self.filer_url = filer_url
        self.mount_dir = mount_dir.rstrip("/")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.synced = 0
        self.removed = 0

    def _should_push(self, new_entry: dict) -> bool:
        if new_entry.get("attr", {}).get("is_directory"):
            return False
        remote = new_entry.get("remote")
        if remote is None:
            return True  # fresh local write, never synced
        if not new_entry.get("chunks") and not new_entry.get("content"):
            return False  # metadata-only record pulled from the remote
        # already pushed at (or after) this local mtime? (unix-seconds
        # granularity, like the reference's RemoteEntry timestamps)
        return remote.get("last_local_sync_ts", 0) < \
            int(new_entry.get("attr", {}).get("mtime", 0))

    def _under_mount(self, path: Optional[str]) -> bool:
        return bool(path) and (path == self.mount_dir
                               or path.startswith(self.mount_dir + "/"))

    def apply_event(self, ev: dict) -> None:
        old, new = ev.get("old_entry"), ev.get("new_entry")
        old_path = old.get("full_path") if old else None
        new_path = new.get("full_path") if new else None
        # a rename (old and new both set, different paths) must remove
        # the old remote object — including renames that leave the mount
        if (old is not None and old_path != new_path
                and self._under_mount(old_path)
                and not old.get("attr", {}).get("is_directory")):
            http_json("POST", f"http://{self.filer_url}/__api/remote/rm",
                      {"path": old_path})
            self.removed += 1
        # a renamed entry keeps its old sync record, so _should_push
        # would skip it — but the object must exist under the NEW name
        renamed_in = (old is not None and new is not None
                      and old_path != new_path
                      and not new.get("attr", {}).get("is_directory")
                      and (new.get("chunks") or new.get("content")))
        if (new is not None and self._under_mount(new_path)
                and (renamed_in or self._should_push(new))):
            http_json("POST",
                      f"http://{self.filer_url}/__api/remote/writeback",
                      {"path": new_path})
            self.synced += 1

    def run_once(self, since_ns: int = 0, wait: float = 0) -> int:
        """Apply all currently-available events; returns the new cursor.
        Subscribes at "/" (not the mount prefix) because rename events
        are logged under the destination directory — the mount filter is
        applied per-path in apply_event."""
        qs = f"?since_ns={since_ns}&prefix=/"
        if wait > 0:
            qs += f"&wait={wait}"  # server-side long poll, no busy loop
        out = http_json(
            "GET", f"http://{self.filer_url}/__api/meta_events{qs}",
            timeout=wait + 30)
        cursor = since_ns
        for ev in out.get("events", []):
            try:
                self.apply_event(ev)
            except (ConnectionError, HttpError):
                return cursor  # retry this event next round
            cursor = max(cursor, ev["tsns"])
        return cursor

    def start(self, since_ns: int = 0) -> None:
        def loop():
            cursor = since_ns
            while not self._stop.is_set():
                try:
                    cursor = self.run_once(cursor, wait=5.0)
                except (ConnectionError, HttpError):
                    self._stop.wait(1.0)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="remote-sync")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
