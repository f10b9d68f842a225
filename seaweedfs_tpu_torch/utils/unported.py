"""The slices of ROADMAP.md queue 1 that the port has not taken yet.

What needs one of them raises NotImplementedError where it is reached,
before any socket is bound, and names the slice it comes with. Nothing of
the port quietly does less in its place.

Where nothing of the port is reached, the error comes from elsewhere: the
filer's gRPC plane serves no S3 ``Configure`` service (it needs
gateway/iam_server.py and pb/{s3,iam}_pb2.py of the gateway slice), so a
call to it gets ``UNIMPLEMENTED`` from gRPC itself.
"""

from __future__ import annotations

CLOUD_TIER_SLICE = ("the cloud-tier slice of ROADMAP.md queue 1 "
                    "(storage/backend.py)")
FILER_STORES_SLICE = ("the filer-stores slice of ROADMAP.md queue 1 "
                      "(filer/{redis,mysql,postgres,mongodb,cassandra,"
                      "elastic,remote}_store.py)")
GATEWAY_SLICE = ("the gateway slice of ROADMAP.md queue 1 (gateway/, "
                 "mount/, mq/, replication/, remote_storage/'s cloud "
                 "clients, notification/'s external queues)")


def not_ported(what: str, slice_: str) -> NotImplementedError:
    """The error for `what`, which comes with `slice_`."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {slice_}")
