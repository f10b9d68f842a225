"""Mount admin gRPC plane (reference weed/pb/mount.proto + its
mount_server Configure handler, driven by shell command_mount_configure.go).

The running mount serves weedtpu_mount_pb.SeaweedTpuMount.Configure and
announces itself to the master as a cluster node of type "mount" whose
URL is this gRPC address — that is how the shell finds live mounts
(reference mounts announce through the filer's cluster membership).

The port's copy of seaweedfs_tpu/mount/mount_grpc.py over the same
weedtpu_mount_pb service (pb/mount_pb2.py, byte-identical). It imports
nothing of that package.
"""

from __future__ import annotations

import threading
from concurrent import futures

import grpc

from seaweedfs_tpu_torch.pb import mount_pb2 as pb

SERVICE = "weedtpu_mount_pb.SeaweedTpuMount"


class MountGrpc:
    def __init__(self, weedfs):
        self.weedfs = weedfs

    def configure(self, request, context):
        if request.collection_capacity >= 0:
            self.weedfs.collection_capacity = request.collection_capacity
            # next statfs must reflect the new quota immediately
            self.weedfs._statfs_cache = None
        return pb.ConfigureResponse(
            collection_capacity=self.weedfs.collection_capacity)

    def handlers(self):
        rpcs = {
            "Configure": grpc.unary_unary_rpc_method_handler(
                self.configure,
                request_deserializer=pb.ConfigureRequest.FromString,
                response_serializer=pb.ConfigureResponse.SerializeToString),
        }
        return grpc.method_handlers_generic_handler(SERVICE, rpcs)


def start_mount_grpc(weedfs, master_url: str = "", host: str = "127.0.0.1",
                     port: int = 0, tls="auto"):
    """Serve the mount admin plane; announce to the master while alive.
    Returns (server, port, stop_announce)."""
    from seaweedfs_tpu_torch.utils import tls as tlsmod
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((MountGrpc(weedfs).handlers(),))
    cfg = tlsmod.load_tls_config("mount") if tls == "auto" else tls
    if cfg is not None:
        bound = server.add_secure_port(
            f"{host}:{port}", tlsmod.server_credentials(cfg))
    else:
        bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    stop = threading.Event()
    if master_url:
        from seaweedfs_tpu_torch.utils.httpd import http_json

        def announce():
            while True:
                try:
                    http_json(
                        "POST", f"http://{master_url}/cluster/register",
                        {"type": "mount", "url": f"{host}:{bound}"},
                        timeout=5)
                except Exception:
                    pass  # master down: retry on the next beat
                if stop.wait(15.0):
                    return

        threading.Thread(target=announce, daemon=True,
                         name="mount-announce").start()
    return server, bound, stop


class MountAdminClient:
    def __init__(self, address: str, tls="auto"):
        from seaweedfs_tpu_torch.utils.tls import make_channel
        self.channel = make_channel(address, role="client", tls=tls)

    def configure(self, collection_capacity: int = -1) -> int:
        fn = self.channel.unary_unary(
            f"/{SERVICE}/Configure",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.ConfigureResponse.FromString)
        resp = fn(pb.ConfigureRequest(
            collection_capacity=collection_capacity), timeout=10)
        return resp.collection_capacity

    def close(self):
        self.channel.close()
