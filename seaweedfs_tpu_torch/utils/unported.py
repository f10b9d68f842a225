"""The slices of ROADMAP.md queue 1 that the port has not taken yet.

What needs one of them raises NotImplementedError where it is reached,
before any socket is bound, and names the slice it comes with. Nothing of
the port quietly does less in its place.

What is left is the rest of the gateway slice (GATEWAY_SLICE):
``mount/``, ``mq/``, ``replication/``, the Azure remote-storage client
and ``notification/``'s external queues. The cloud tier, the S3 / IAM /
WebDAV / FTP gateways, the S3-dialect remote client, the macro simulator
and every filer store family are ported.
"""

from __future__ import annotations

GATEWAY_SLICE = ("the rest of the gateway slice of ROADMAP.md queue 1 "
                 "(mount/, mq/, replication/, "
                 "remote_storage/azure_client.py, notification/'s "
                 "external queues)")


def not_ported(what: str, slice_: str) -> NotImplementedError:
    """The error for `what`, which comes with `slice_`."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {slice_}")
