"""gRPC plane for the master (reference weed/pb/master.proto service).

Serves the reference's core master RPCs — streaming SendHeartbeat,
Assign, LookupVolume, LookupEcVolume — over grpc using generic method
handlers (no codegen plugin needed; messages come from
pb/master_pb2.py generated by protoc). The HTTP/JSON plane remains
canonical; this runs alongside it so gRPC-speaking clients and
long-lived heartbeat streams work like the reference's.

The port's copy of seaweedfs_tpu/server/master_grpc.py, over its own
copy of pb/master_pb2.py (same proto package and descriptors, so either
package's clients and servers talk to each other). It takes no device and
imports nothing of that package.
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
from typing import Iterator, Optional

import grpc

from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.pb import master_pb2 as pb

SERVICE = "weedtpu_master_pb.Seaweed"


def _vinfo_to_dict(v: pb.VolumeInformationMessage) -> dict:
    return {"id": v.id, "size": v.size, "collection": v.collection,
            "file_count": v.file_count, "delete_count": v.delete_count,
            "deleted_byte_count": v.deleted_byte_count,
            "read_only": v.read_only,
            "replica_placement": v.replica_placement,
            "ttl": v.ttl, "version": v.version or 3}


def _ec_to_dict(e: pb.VolumeEcShardInformationMessage) -> dict:
    return {"id": e.id, "collection": e.collection,
            "ec_index_bits": e.ec_index_bits}


# outbound depth per KeepConnected subscriber; overflow sheds the
# oldest delta instead of growing without bound — the client rebuilds from a full snapshot on
# reconnect, so a shed delta degrades to one stale lookup, not a leak
SUB_QUEUE_DEPTH = 256


class MasterGrpc:
    def __init__(self, master):
        self.master = master
        # KeepConnected subscribers: sub id -> outbound queue
        # (reference MasterServer.clientChans, master_grpc_server.go:236+)
        self._subs: dict[int, queue.Queue] = {}
        self._subs_lock = threading.Lock()
        self._sub_ids = itertools.count()
        # (client_type, address) -> owning sub id, so a stale handler's
        # cleanup can't evict the same client's newer stream
        self._ckey_owner: dict[tuple, int] = {}
        master.topo.listeners.append(self._on_volume_location_change)

    def _broadcast(self, resp: pb.KeepConnectedResponse) -> None:
        with self._subs_lock:
            for q in self._subs.values():
                try:
                    q.put_nowait(resp)
                except queue.Full:
                    # a blocking put here would wedge every subscriber
                    # (and the topology listener) behind one stalled
                    # stream; shed the oldest delta for the slow one
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    try:
                        q.put_nowait(resp)
                    except queue.Full:
                        pass

    def _on_volume_location_change(self, ev: dict) -> None:
        resp = pb.KeepConnectedResponse()
        vl = resp.volume_location
        vl.url = ev["url"]
        vl.public_url = ev["public_url"]
        vl.new_vids.extend(ev["new_vids"])
        vl.deleted_vids.extend(ev["deleted_vids"])
        vl.new_ec_vids.extend(ev["new_ec_vids"])
        vl.deleted_ec_vids.extend(ev["deleted_ec_vids"])
        vl.leader = self.master.leader
        self._broadcast(resp)

    # ---- rpc impls ----
    def send_heartbeat(self, request_iterator: Iterator[pb.Heartbeat],
                       context) -> Iterator[pb.HeartbeatResponse]:
        node = None
        for hb in request_iterator:
            if hb.is_delta and node is not None:
                self.master.topo.incremental_sync(node, {
                    "new_volumes": [_vinfo_to_dict(v)
                                    for v in hb.new_volumes],
                    "deleted_volumes": [_vinfo_to_dict(v)
                                        for v in hb.deleted_volumes],
                    "new_ec_shards": [_ec_to_dict(e)
                                      for e in hb.new_ec_shards],
                    "deleted_ec_shards": [_ec_to_dict(e)
                                          for e in hb.deleted_ec_shards],
                })
            else:
                node = self.master.topo.sync_data_node_registration({
                    "ip": hb.ip, "port": hb.port,
                    "public_url": hb.public_url,
                    "data_center": hb.data_center, "rack": hb.rack,
                    "max_volume_count": hb.max_volume_count or 8,
                    "volumes": [_vinfo_to_dict(v) for v in hb.volumes],
                    "ec_shards": [_ec_to_dict(e) for e in hb.ec_shards],
                })
            yield pb.HeartbeatResponse(
                volume_size_limit=self.master.topo.volume_size_limit,
                leader=self.master.leader,
                jwt_signing_key=self.master.jwt_signing_key)
        # stream closed: like the reference, the node is unregistered
        if node is not None:
            self.master.topo.unregister_data_node(node)

    def keep_connected(self, request_iterator: Iterator[pb.KeepConnectedRequest],
                       context) -> Iterator[pb.KeepConnectedResponse]:
        """Subscription stream: full vid snapshot, then VolumeLocation
        deltas + cluster node updates (reference master_grpc_server.go
        KeepConnected; client side wdclient/masterclient.go:148-240)."""
        try:
            first = next(request_iterator)
        except StopIteration:
            return
        if not self.master.is_leader():
            resp = pb.KeepConnectedResponse()
            resp.volume_location.leader = self.master.leader
            yield resp
            return
        q: queue.Queue = queue.Queue(maxsize=SUB_QUEUE_DEPTH)
        sub_id = next(self._sub_ids)
        with self._subs_lock:
            self._subs[sub_id] = q
        # register non-shell clients in cluster membership (cluster.Cluster)
        ckey = None
        if first.client_type and first.client_type not in ("shell", "client"):
            ckey = (first.client_type, first.client_address)
            with self._subs_lock:
                self._ckey_owner[ckey] = sub_id
            self.master._cluster_nodes[ckey] = clockctl.now()
            upd = pb.KeepConnectedResponse()
            upd.cluster_node_update.node_type = first.client_type
            upd.cluster_node_update.address = first.client_address
            upd.cluster_node_update.is_add = True
            self._broadcast(upd)
        try:
            # full snapshot, one VolumeLocation per node
            with self.master.topo.lock:
                snapshots = []
                for node in self.master.topo.all_nodes():
                    resp = pb.KeepConnectedResponse()
                    vl = resp.volume_location
                    vl.url = node.url
                    vl.public_url = node.public_url
                    vl.new_vids.extend(sorted(node.volumes))
                    vl.new_ec_vids.extend(sorted(node.ec_shards))
                    vl.leader = self.master.leader
                    snapshots.append(resp)
            for resp in snapshots:
                yield resp
            while context.is_active():
                if ckey is not None:
                    # keep the membership entry fresh while connected
                    self.master._cluster_nodes[ckey] = clockctl.now()
                try:
                    yield q.get(timeout=0.5)
                except queue.Empty:
                    continue
        finally:
            with self._subs_lock:
                self._subs.pop(sub_id, None)
                still_owner = (ckey is not None
                               and self._ckey_owner.get(ckey) == sub_id)
                if still_owner:
                    self._ckey_owner.pop(ckey, None)
            if ckey is not None and still_owner:
                self.master._cluster_nodes.pop(ckey, None)
                upd = pb.KeepConnectedResponse()
                upd.cluster_node_update.node_type = ckey[0]
                upd.cluster_node_update.address = ckey[1]
                upd.cluster_node_update.is_add = False
                self._broadcast(upd)

    def assign(self, request: pb.AssignRequest, context) -> pb.AssignResponse:
        if not self.master.is_leader():
            return pb.AssignResponse(
                error=f"not leader, leader: {self.master.leader}")
        reply = self.master.assign_fid(
            count=int(request.count or 1),
            collection=request.collection,
            replication=request.replication,
            ttl=request.ttl, data_center=request.data_center)
        if "error" in reply:
            return pb.AssignResponse(error=reply["error"])
        return pb.AssignResponse(
            fid=reply["fid"], count=reply["count"],
            auth=reply.get("auth", ""),
            location=pb.Location(url=reply["url"],
                                 public_url=reply["publicUrl"]),
            replicas=[pb.Location(url=r["url"], public_url=r["publicUrl"])
                      for r in reply["replicas"]])

    def lookup_volume(self, request: pb.LookupVolumeRequest,
                      context) -> pb.LookupVolumeResponse:
        out = pb.LookupVolumeResponse()
        for vof in request.volume_or_file_ids:
            vid = int(str(vof).split(",")[0])
            entry = out.volume_id_locations.add(volume_or_file_id=vof)
            nodes = self.master.topo.lookup(request.collection, vid)
            if not nodes:
                entry.error = "volume id not found"
                continue
            for n in nodes:
                entry.locations.add(url=n.url, public_url=n.public_url)
        return out

    def lookup_ec_volume(self, request: pb.LookupEcVolumeRequest,
                         context) -> pb.LookupEcVolumeResponse:
        out = pb.LookupEcVolumeResponse(volume_id=request.volume_id)
        shards = self.master.topo.lookup_ec_shards(request.volume_id)
        if shards is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "ec volume not found")
        for sid, nodes in enumerate(shards):
            entry = out.shard_id_locations.add(shard_id=sid)
            for n in nodes:
                entry.locations.add(url=n.url, public_url=n.public_url)
        return out

    def statistics(self, request, context) -> "pb.StatisticsResponse":
        from seaweedfs_tpu_torch.cluster.topology import aggregate_topology_info
        topo_info = self.master.topo.to_info()
        if request.collection:
            # per-collection view (the reference resolves the layout):
            # keep only this collection's volumes before summing
            for dc in topo_info.get("data_centers", []):
                for rack in dc.get("racks", []):
                    for dn in rack.get("nodes", []):
                        dn["volumes"] = [
                            v for v in dn.get("volumes", [])
                            if v.get("collection", "")
                            == request.collection]
        agg = aggregate_topology_info(topo_info)
        return pb.StatisticsResponse(
            total_size=agg["slots"] * self.master.topo.volume_size_limit,
            used_size=agg["used_bytes"], file_count=agg["file_count"])

    def collection_list(self, request, context
                        ) -> "pb.CollectionListResponse":
        topo = self.master.topo
        with topo.lock:
            cols = sorted({c for (c, _, _, _), lo in topo.layouts.items()
                           if c and lo.locations})
        return pb.CollectionListResponse(
            collections=[pb.Collection(name=c) for c in cols])

    def collection_delete(self, request, context
                          ) -> "pb.CollectionDeleteResponse":
        from seaweedfs_tpu_torch.utils.httpd import LocalRequest
        req = LocalRequest(query={"collection": request.name})
        resp = self.master._handle_col_delete(req)
        if resp.status >= 400:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          resp.body.decode(errors="replace"))
        return pb.CollectionDeleteResponse()

    def get_configuration(self, request, context
                          ) -> "pb.GetMasterConfigurationResponse":
        return pb.GetMasterConfigurationResponse(
            volume_size_limit_m_b=self.master.topo.volume_size_limit
            // (1024 * 1024),
            leader=self.master.leader or self.master.url,
            default_replication=self.master.default_replication)

    # ---- integrity & repair (JSON codec: these RPCs postdate the
    # vendored pb modules, which are not regenerated) ----
    def _require_leader(self, context) -> None:
        if not self.master.is_leader():
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"not leader; leader is {self.master.leader}")

    def scrub_report(self, request, context):
        self._require_leader(context)
        return self.master.repair_queue.report(request or {})

    def ec_repair_status(self, request, context):
        return self.master.repair_queue.status()

    def ec_repair_kick(self, request, context):
        self._require_leader(context)
        return self.master.repair_queue.kick()

    # ---- wiring ----
    def handlers(self) -> grpc.GenericRpcHandler:
        def junary(fn):
            return grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=lambda raw:
                    json.loads(raw.decode()) if raw else {},
                response_serializer=lambda d: json.dumps(d).encode())

        rpcs = {
            "ScrubReport": junary(self.scrub_report),
            "EcRepairStatus": junary(self.ec_repair_status),
            "EcRepairKick": junary(self.ec_repair_kick),
            "SendHeartbeat": grpc.stream_stream_rpc_method_handler(
                self.send_heartbeat,
                request_deserializer=pb.Heartbeat.FromString,
                response_serializer=pb.HeartbeatResponse.SerializeToString),
            "KeepConnected": grpc.stream_stream_rpc_method_handler(
                self.keep_connected,
                request_deserializer=pb.KeepConnectedRequest.FromString,
                response_serializer=(
                    pb.KeepConnectedResponse.SerializeToString)),
            "Assign": grpc.unary_unary_rpc_method_handler(
                self.assign,
                request_deserializer=pb.AssignRequest.FromString,
                response_serializer=pb.AssignResponse.SerializeToString),
            "LookupVolume": grpc.unary_unary_rpc_method_handler(
                self.lookup_volume,
                request_deserializer=pb.LookupVolumeRequest.FromString,
                response_serializer=pb.LookupVolumeResponse.SerializeToString),
            "LookupEcVolume": grpc.unary_unary_rpc_method_handler(
                self.lookup_ec_volume,
                request_deserializer=pb.LookupEcVolumeRequest.FromString,
                response_serializer=(
                    pb.LookupEcVolumeResponse.SerializeToString)),
            "Statistics": grpc.unary_unary_rpc_method_handler(
                self.statistics,
                request_deserializer=pb.StatisticsRequest.FromString,
                response_serializer=pb.StatisticsResponse.SerializeToString),
            "CollectionList": grpc.unary_unary_rpc_method_handler(
                self.collection_list,
                request_deserializer=pb.CollectionListRequest.FromString,
                response_serializer=(
                    pb.CollectionListResponse.SerializeToString)),
            "CollectionDelete": grpc.unary_unary_rpc_method_handler(
                self.collection_delete,
                request_deserializer=pb.CollectionDeleteRequest.FromString,
                response_serializer=(
                    pb.CollectionDeleteResponse.SerializeToString)),
            "GetMasterConfiguration": grpc.unary_unary_rpc_method_handler(
                self.get_configuration,
                request_deserializer=(
                    pb.GetMasterConfigurationRequest.FromString),
                response_serializer=(
                    pb.GetMasterConfigurationResponse.SerializeToString)),
        }
        return grpc.method_handlers_generic_handler(SERVICE, rpcs)


def start_master_grpc(master, host: str = "127.0.0.1",
                      port: int = 0, tls="auto") -> tuple[grpc.Server, int]:
    # long-lived streams (SendHeartbeat, KeepConnected) each pin a worker
    # for their whole lifetime, so the pool must comfortably exceed the
    # expected stream count or unary RPCs starve
    from seaweedfs_tpu_torch.utils import tls as tlsmod
    server = grpc.server(
        __import__("concurrent.futures", fromlist=["ThreadPoolExecutor"])
        .ThreadPoolExecutor(max_workers=64))
    server.add_generic_rpc_handlers((MasterGrpc(master).handlers(),))
    cfg = tlsmod.load_tls_config("master") if tls == "auto" else tls
    if cfg is not None:
        bound = server.add_secure_port(
            f"{host}:{port}", tlsmod.server_credentials(cfg))
    else:
        bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, bound


class GrpcMasterClient:
    """Client-side helper mirroring wdclient's lookups over gRPC."""

    def __init__(self, address: str, tls="auto"):
        from seaweedfs_tpu_torch.utils.tls import make_channel
        self.channel = make_channel(address, role="client", tls=tls)

    def _call(self, method: str, request, response_cls):
        fn = self.channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=response_cls.FromString)
        return fn(request, timeout=30)

    def assign(self, **kw) -> pb.AssignResponse:
        return self._call("Assign", pb.AssignRequest(**kw),
                          pb.AssignResponse)

    def lookup_volume(self, vids: list[str],
                      collection: str = "") -> pb.LookupVolumeResponse:
        return self._call(
            "LookupVolume",
            pb.LookupVolumeRequest(volume_or_file_ids=vids,
                                   collection=collection),
            pb.LookupVolumeResponse)

    def lookup_ec_volume(self, vid: int) -> pb.LookupEcVolumeResponse:
        return self._call("LookupEcVolume",
                          pb.LookupEcVolumeRequest(volume_id=vid),
                          pb.LookupEcVolumeResponse)

    def heartbeat_stream(self, heartbeats):
        fn = self.channel.stream_stream(
            f"/{SERVICE}/SendHeartbeat",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.HeartbeatResponse.FromString)
        return fn(heartbeats)

    def _json_call(self, method: str, body: dict,
                   timeout: float = 30) -> dict:
        fn = self.channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda d: json.dumps(d or {}).encode(),
            response_deserializer=lambda raw:
                json.loads(raw.decode()) if raw else {})
        return fn(body or {}, timeout=timeout)

    def scrub_report(self, report: dict) -> dict:
        return self._json_call("ScrubReport", report)

    def ec_repair_status(self) -> dict:
        return self._json_call("EcRepairStatus", {})

    def ec_repair_kick(self) -> dict:
        return self._json_call("EcRepairKick", {})

    def keep_connected(self, client_type: str = "client",
                       client_address: str = ""):
        """Open the KeepConnected stream; returns the response iterator."""
        def requests():
            # single announce then half-close; the server streams until
            # the call is cancelled
            yield pb.KeepConnectedRequest(client_type=client_type,
                                          client_address=client_address)

        fn = self.channel.stream_stream(
            f"/{SERVICE}/KeepConnected",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.KeepConnectedResponse.FromString)
        return fn(requests())

    def close(self):
        self.channel.close()
