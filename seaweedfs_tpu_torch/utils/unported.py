"""The slices of ROADMAP.md queue 1 that the port has not taken yet.

What needs one of them raises NotImplementedError where it is reached,
before any socket is bound, and names the slice it comes with. Nothing of
the port quietly does less in its place.

What is left: the wire-protocol filer stores but etcd and ``remote``
(FILER_STORES_SLICE), and the rest of the gateway slice (GATEWAY_SLICE):
``mount/``, ``mq/``, ``replication/``, the Azure remote-storage client
and ``notification/``'s external queues. The cloud tier, the S3 / IAM /
WebDAV / FTP gateways, the S3-dialect remote client and the ``remote``
filer store are ported.
"""

from __future__ import annotations

FILER_STORES_SLICE = ("the filer-stores slice of ROADMAP.md queue 1 "
                      "(filer/{redis,mysql,postgres,mongodb,cassandra,"
                      "elastic}_store.py)")
GATEWAY_SLICE = ("the rest of the gateway slice of ROADMAP.md queue 1 "
                 "(mount/, mq/, replication/, "
                 "remote_storage/azure_client.py, notification/'s "
                 "external queues)")


def not_ported(what: str, slice_: str) -> NotImplementedError:
    """The error for `what`, which comes with `slice_`."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {slice_}")
