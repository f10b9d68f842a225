"""Per-node hot-key recording: Space-Saving sketches by dimension.

Volume servers track hot *needles*; filer and S3 edges track hot
*paths* and *tenants*. Every server exposes its sketches at
``/admin/hotkeys`` (on the metrics listener where the main port is
user namespace) and ships them to the master inside its telemetry
snapshot, where ClusterTelemetry merges them cluster-wide — the
measurement the roadmap's hot-needle cache and filer shard routing
depend on.

The port's copy of seaweedfs_tpu/stats/hotkeys.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.utils.sketch import SpaceSaving

DEFAULT_CAPACITY = 64


class HotKeys:
    """A bundle of named Space-Saving sketches ("needle", "path",
    "tenant", ...). Thread-safety lives in the sketches themselves;
    the dimension map is fixed at construction."""

    def __init__(self, dims: tuple, capacity: int = DEFAULT_CAPACITY):
        self.sketches = {d: SpaceSaving(capacity) for d in dims}

    def record(self, dim: str, key: str, count: int = 1) -> None:
        sk = self.sketches.get(dim)
        if sk is not None and key:
            sk.offer(key, count)

    def top(self, k: int = 10) -> dict:
        return {d: [{"key": key, "count": c, "error": e}
                    for key, c, e in sk.top(k)]
                for d, sk in self.sketches.items()}

    def snapshot(self) -> dict:
        return {d: sk.snapshot() for d, sk in self.sketches.items()}

    def merge_from(self, snap: dict) -> None:
        """Fold another node's ``snapshot()`` in, growing dimensions
        as needed (the master's merged view spans dimensions no single
        node records)."""
        for dim, sk_snap in (snap or {}).items():
            sk = self.sketches.get(dim)
            if sk is None:
                sk = self.sketches[dim] = SpaceSaving(
                    int(sk_snap.get("capacity", DEFAULT_CAPACITY))
                    or DEFAULT_CAPACITY)
            sk.merge_from(sk_snap)

    def handler(self, url: str = ""):
        """An HttpServer handler serving this bundle at
        /admin/hotkeys?k=N."""
        from seaweedfs_tpu_torch.utils.httpd import Request, Response

        def handle(req: Request) -> Response:
            k = int(req.query.get("k", 10))
            return Response({"url": url, "hotkeys": self.top(k),
                             "totals": {d: sk.total
                                        for d, sk in
                                        self.sketches.items()}})
        return handle
