"""Cluster-wide QoS & admission control.

Three pieces, each usable alone, wired together by the servers:

- classes.py: the traffic classes (interactive > write > background)
  and their propagation — an ``X-Weed-Class`` header that rides every
  internal hop exactly like ``X-Weed-Deadline``.
- limiter.py: an adaptive concurrency limit derived from observed
  service latency (gradient on a fast vs. slow EWMA).
- governor.py: the per-node admission controller — class-weighted
  slots under the adaptive limit, per-tenant token buckets, and a
  ``pressure()`` signal that background work (scrubber, repair queue)
  subscribes to.

Shed requests get ``503 + Retry-After`` instead of queueing into
deadline expiry; RetryPolicy honors the hint (utils/resilience.py).

The port's copy of seaweedfs_tpu/qos/__init__.py, the same code; it imports
nothing of that package.
"""

from seaweedfs_tpu_torch.qos.classes import (BACKGROUND, CLASS_HEADER, CLASSES,
                                       INTERACTIVE, WRITE, class_scope,
                                       classify, current_class,
                                       from_headers)
from seaweedfs_tpu_torch.qos.governor import Grant, QosGovernor, TenantBuckets
from seaweedfs_tpu_torch.qos.limiter import AdaptiveLimiter

__all__ = [
    "AdaptiveLimiter", "BACKGROUND", "CLASS_HEADER", "CLASSES", "Grant",
    "INTERACTIVE", "QosGovernor", "TenantBuckets", "WRITE",
    "class_scope", "classify", "current_class", "from_headers",
]
