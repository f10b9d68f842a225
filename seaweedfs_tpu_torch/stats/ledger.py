"""Per-(class, tenant) resource ledger: who is burning the cluster.

RED histograms and hot-key sketches say what is slow and which keys
are hot; the ledger answers the chargeback question — which tenant's
traffic, in which QoS class, consumed the CPU, moved the bytes, and
read the disk.  The Facebook warehouse-cluster study (1309.0186)
frames incident analysis as exactly this attribution problem.

Accounting sites:

- ``HttpServer._dispatch_inner`` brackets every request with a
  ``clockctl.thread_time()`` delta (the handler runs on the dispatch
  thread, so per-thread CPU clock deltas are exact) plus wire bytes in
  (``BodyStream.consumed``) and out (response body length).  Tenant
  identity comes from the owning server's ``tenant_fn`` — client IP at
  the filer/volume tier, S3 access key at the gateway — matching the
  QoS governor's per-tenant bucket keys.
- Storage read paths call ``charge_disk()`` with the bytes a request
  pulled off disk, attributed to the ambient QoS class.

Rows are bounded: past ``max_rows`` distinct (class, tenant) pairs,
new tenants fold into a per-class ``(other)`` row — an aggregate that
still sums correctly, the same spirit as the hot-key sketch's bounded
counters.  Snapshots are plain mergeable dicts (elementwise row sums)
so they ride the telemetry piggyback — volume heartbeats, filer/S3
``/admin/telemetry`` pulls — into the master's cluster rollup.

The port's copy of seaweedfs_tpu/stats/ledger.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import threading
from typing import Optional

from seaweedfs_tpu_torch.qos import classes as qos_classes

FIELDS = ("requests", "cpu_ms", "bytes_in", "bytes_out",
          "disk_bytes_read")
OTHER_TENANT = "(other)"


class ResourceLedger:
    def __init__(self, max_rows: int = 512):
        self.max_rows = max_rows
        # (cls, tenant) -> [requests, cpu_ms, bytes_in, bytes_out,
        #                   disk_bytes_read]
        self._rows: dict[tuple, list] = {}
        self._lock = threading.Lock()

    # ---- accounting ----
    def _row_locked(self, cls: str, tenant: str) -> list:
        key = (cls or "-", tenant or "-")
        row = self._rows.get(key)
        if row is None:
            if len(self._rows) >= self.max_rows \
                    and key[1] != OTHER_TENANT:
                return self._row_locked(cls, OTHER_TENANT)
            row = self._rows[key] = [0, 0.0, 0, 0, 0]
        return row

    def observe_request(self, cls: str, tenant: str, *,
                        cpu_s: float = 0.0, bytes_in: int = 0,
                        bytes_out: int = 0) -> None:
        """One dispatched request's bill.  cpu_s is the dispatch
        thread's thread-CPU delta across the handler."""
        with self._lock:
            row = self._row_locked(cls, tenant)
            row[0] += 1
            row[1] += cpu_s * 1000.0
            row[2] += bytes_in
            row[3] += bytes_out

    def charge_disk(self, nbytes: int, cls: Optional[str] = None,
                    tenant: str = "-") -> None:
        """Bytes a storage read pulled off disk.  Class defaults to
        the caller's ambient QoS scope (storage reads run inside the
        request's class_scope), so degraded-read reconstruction and
        scrub I/O land under background, not interactive."""
        if nbytes <= 0:
            return
        cls = cls or qos_classes.current_class() or "-"
        with self._lock:
            self._row_locked(cls, tenant)[4] += nbytes

    # ---- mergeable snapshots ----
    def snapshot(self) -> dict:
        with self._lock:
            rows = [[k[0], k[1]] + list(v)
                    for k, v in self._rows.items()]
        rows.sort(key=lambda r: -r[3])  # cpu_ms desc
        return {"fields": list(FIELDS), "rows": rows}

    def merge_from(self, snap: dict) -> None:
        """Fold another ledger's snapshot in (exact elementwise sums;
        the master's cluster rollup over node snapshots)."""
        for row in (snap or {}).get("rows", []):
            cls, tenant, values = row[0], row[1], row[2:]
            with self._lock:
                mine = self._row_locked(cls, tenant)
                for i, v in enumerate(values[:len(FIELDS)]):
                    mine[i] += v

    def rows(self) -> dict:
        """(cls, tenant) -> field dict, for tests and shell views."""
        with self._lock:
            return {k: dict(zip(FIELDS, v))
                    for k, v in self._rows.items()}

    def top(self, n: int = 20, field: str = "cpu_ms") -> list[dict]:
        idx = FIELDS.index(field)
        with self._lock:
            items = sorted(self._rows.items(),
                           key=lambda kv: -kv[1][idx])[:n]
        return [{"class": k[0], "tenant": k[1],
                 **dict(zip(FIELDS, v))} for k, v in items]
