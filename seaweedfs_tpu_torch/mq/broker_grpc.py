"""gRPC plane for the mq broker (reference weed/mq/broker served over
weed/pb/mq.proto: control plane FindBrokerLeader/CheckBrokerLoad plus a
streaming Publish data plane — reference mq.proto:11-26). Redesigned
for this broker: topics/partitions instead of ring segments, and a
first-class Subscribe stream (segment replay + live tail) so a
pure-gRPC consumer needs no filer access.

Same transport conventions as the other three planes: generic method
handlers over protoc messages, mTLS via utils/tls when configured.

The port's copy of seaweedfs_tpu/mq/broker_grpc.py over the same
weedtpu_mq_pb service (pb/mq_pb2.py, byte-identical). It imports nothing
of that package.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Iterable, Iterator, Optional

import grpc

from seaweedfs_tpu_torch.pb import mq_pb2 as pb

SERVICE = "weedtpu_mq_pb.SeaweedTpuMessaging"


MAX_TAIL_STREAMS = 48  # of the 64-worker pool: 16 workers always stay
# free for unary RPCs and Publish streams, since each tailing Subscribe
# pins its worker for the life of the stream


class BrokerGrpc:
    def __init__(self, broker, address: str = ""):
        self.broker = broker
        self.address = address
        self._tails = threading.BoundedSemaphore(MAX_TAIL_STREAMS)

    # ---- control plane ----
    def find_broker_leader(self, request, context):
        # single-broker deployments: this broker is the leader
        return pb.FindBrokerLeaderResponse(broker=self.address)

    def configure_topic(self, request, context):
        n = self.broker.ensure_topic(request.namespace, request.topic,
                                     request.partition_count or 4)
        return pb.ConfigureTopicResponse(partition_count=n)

    def list_topics(self, request, context):
        topics = self.broker.list_topics(request.namespace)
        return pb.ListTopicsResponse(topics=[
            pb.TopicInfo(namespace=t["namespace"], topic=t["topic"],
                         partition_count=t["partition_count"])
            for t in topics])

    def check_broker_load(self, request, context):
        return pb.CheckBrokerLoadResponse(
            message_count=self.broker.message_count,
            bytes_count=self.broker.bytes_count)

    # ---- data plane ----
    def publish(self, request_iterator, context
                ) -> Iterator["pb.PublishResponse"]:
        ns = topic = None
        for req in request_iterator:
            if req.HasField("init"):
                # an init frame carries no record (see mq.proto) — a
                # data-bearing heuristic here would silently drop a
                # legitimate empty-key/empty-value record
                ns, topic = req.init.namespace, req.init.topic
                continue
            if ns is None:
                yield pb.PublishResponse(error="first frame must carry init")
                return
            try:
                partition, seq = self.broker.publish_record(
                    ns, topic, req.key, req.value)
                yield pb.PublishResponse(ack_sequence=seq,
                                         partition=partition)
            except LookupError as e:
                yield pb.PublishResponse(error=str(e))
                return

    def subscribe(self, request, context
                  ) -> Iterator["pb.SubscribeResponse"]:
        from seaweedfs_tpu_torch.mq.broker import MqTailOverflow
        part = None if request.partition < 0 else request.partition
        acquired = False
        if request.tail:
            # each tailing stream pins an executor worker until the
            # client disconnects — cap them so unary RPCs and Publish
            # streams always have free workers
            acquired = self._tails.acquire(blocking=False)
            if not acquired:
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              f"too many tail subscribers "
                              f"(max {MAX_TAIL_STREAMS})")
        try:
            for rec in self.broker.subscribe(
                    request.namespace, request.topic, partition=part,
                    tail=request.tail, since_ns=request.since_ns,
                    is_active=context.is_active):
                yield pb.SubscribeResponse(
                    ts_ns=rec["ts"], key=rec["key"],
                    value=_to_bytes(rec["value"]),
                    partition=rec["partition"], sequence=rec["seq"])
        except LookupError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except MqTailOverflow as e:
            context.abort(grpc.StatusCode.ABORTED, str(e))
        finally:
            if acquired:
                self._tails.release()

    def handlers(self):
        u, s = (grpc.unary_unary_rpc_method_handler,
                grpc.unary_stream_rpc_method_handler)
        rpcs = {
            "FindBrokerLeader": u(
                self.find_broker_leader,
                request_deserializer=pb.FindBrokerLeaderRequest.FromString,
                response_serializer=(
                    pb.FindBrokerLeaderResponse.SerializeToString)),
            "ConfigureTopic": u(
                self.configure_topic,
                request_deserializer=pb.ConfigureTopicRequest.FromString,
                response_serializer=(
                    pb.ConfigureTopicResponse.SerializeToString)),
            "ListTopics": u(
                self.list_topics,
                request_deserializer=pb.ListTopicsRequest.FromString,
                response_serializer=pb.ListTopicsResponse.SerializeToString),
            "CheckBrokerLoad": u(
                self.check_broker_load,
                request_deserializer=pb.CheckBrokerLoadRequest.FromString,
                response_serializer=(
                    pb.CheckBrokerLoadResponse.SerializeToString)),
            "Publish": grpc.stream_stream_rpc_method_handler(
                self.publish,
                request_deserializer=pb.PublishRequest.FromString,
                response_serializer=pb.PublishResponse.SerializeToString),
            "Subscribe": s(
                self.subscribe,
                request_deserializer=pb.SubscribeRequest.FromString,
                response_serializer=pb.SubscribeResponse.SerializeToString),
        }
        return grpc.method_handlers_generic_handler(SERVICE, rpcs)


def _to_bytes(value) -> bytes:
    if isinstance(value, str):
        return value.encode("utf-8", "surrogateescape")
    import json
    return json.dumps(value).encode()


def start_broker_grpc(broker, host: str = "127.0.0.1", port: int = 0,
                      tls="auto") -> tuple[grpc.Server, int]:
    from seaweedfs_tpu_torch.utils import tls as tlsmod
    # 64 workers: long-lived tail Subscribe streams each pin one (capped
    # at MAX_TAIL_STREAMS=48), leaving headroom for unary + Publish
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=64))
    cfg = tlsmod.load_tls_config("mq") if tls == "auto" else tls
    if cfg is not None:
        bound = server.add_secure_port(
            f"{host}:{port}", tlsmod.server_credentials(cfg))
    else:
        bound = server.add_insecure_port(f"{host}:{port}")
    server.add_generic_rpc_handlers(
        (BrokerGrpc(broker, f"{host}:{bound}").handlers(),))
    server.start()
    return server, bound


class MqClient:
    """Pure-gRPC producer/consumer for the broker plane."""

    def __init__(self, address: str, tls="auto"):
        from seaweedfs_tpu_torch.utils.tls import make_channel
        self.channel = make_channel(address, role="client", tls=tls)

    def _unary(self, method: str, request, resp_cls, timeout: float = 30):
        fn = self.channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)
        return fn(request, timeout=timeout)

    def configure_topic(self, namespace: str, topic: str,
                        partition_count: int = 4) -> int:
        return self._unary("ConfigureTopic", pb.ConfigureTopicRequest(
            namespace=namespace, topic=topic,
            partition_count=partition_count),
            pb.ConfigureTopicResponse).partition_count

    def list_topics(self, namespace: str = "") -> list[dict]:
        resp = self._unary("ListTopics",
                           pb.ListTopicsRequest(namespace=namespace),
                           pb.ListTopicsResponse)
        return [{"namespace": t.namespace, "topic": t.topic,
                 "partition_count": t.partition_count}
                for t in resp.topics]

    def broker_load(self) -> dict:
        resp = self._unary("CheckBrokerLoad", pb.CheckBrokerLoadRequest(),
                           pb.CheckBrokerLoadResponse)
        return {"message_count": resp.message_count,
                "bytes_count": resp.bytes_count}

    def publish(self, namespace: str, topic: str,
                records: Iterable[tuple[str, bytes]]) -> list[int]:
        """Stream (key, value) pairs; returns the ack sequences."""
        def frames():
            yield pb.PublishRequest(init=pb.PublishRequest.InitMessage(
                namespace=namespace, topic=topic))
            for key, value in records:
                if isinstance(value, str):
                    value = value.encode()
                yield pb.PublishRequest(key=key, value=value)
        fn = self.channel.stream_stream(
            f"/{SERVICE}/Publish",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.PublishResponse.FromString)
        acks = []
        for resp in fn(frames(), timeout=60):
            if resp.error:
                raise RuntimeError(resp.error)
            acks.append(resp.ack_sequence)
        return acks

    def subscribe(self, namespace: str, topic: str,
                  partition: Optional[int] = None, tail: bool = False,
                  since_ns: int = 0, timeout: float = 3600
                  ) -> Iterator[dict]:
        fn = self.channel.unary_stream(
            f"/{SERVICE}/Subscribe",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.SubscribeResponse.FromString)
        stream = fn(pb.SubscribeRequest(
            namespace=namespace, topic=topic,
            partition=-1 if partition is None else partition,
            tail=tail, since_ns=since_ns), timeout=timeout)
        for resp in stream:
            yield {"ts": resp.ts_ns, "key": resp.key, "value": resp.value,
                   "partition": resp.partition, "seq": resp.sequence}

    def close(self):
        self.channel.close()
