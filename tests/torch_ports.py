"""Local ports for the port's tests that start a `-grpc` server on a
fixed port: the server binds its HTTP port and, for its gRPC plane, that
port + 10000."""

import socket

GRPC_OFFSET = 10000


def free_grpc_ports(n: int) -> list[int]:
    """n local ports that were free a moment ago, each with its gRPC
    twin, port + GRPC_OFFSET, free too."""
    out: list[int] = []
    while len(out) < n:
        with socket.socket() as s, socket.socket() as twin:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            if port + GRPC_OFFSET > 65535 or port in out:
                continue
            try:
                twin.bind(("127.0.0.1", port + GRPC_OFFSET))
            except OSError:
                continue
            out.append(port)
    return out
