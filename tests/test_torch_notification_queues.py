"""The port's external notification queues (notification/kafka_queue.py,
sqs_queue.py, pubsub_queue.py) held against the JAX package's: the Kafka
Produce-v0 wire through MiniKafkaBroker (framing, CRC, offsets), the
producer's explicit I/O timeout, SigV4-signed SQS SendMessage and
Bearer-authenticated Pub/Sub publishes through their mini servers (bad
credentials refused), and notification.toml wiring a filer server's
events to Kafka and to SQS; across the packages: each package's producer
against the other's mini server, with what the server recorded equal.
The port's volume servers run with device="cpu".
(ref tests/test_kafka_queue.py, test_sqs_pubsub_queues.py,
test_invariant_fixes.py's Kafka timeout case.)
"""

import json
import socket
import time
import types

import numpy as np
import pytest

import seaweedfs_tpu.notification.kafka_queue as j_kafka
import seaweedfs_tpu.notification.pubsub_queue as j_pubsub
import seaweedfs_tpu.notification.sqs_queue as j_sqs
import seaweedfs_tpu_torch.notification.kafka_queue as p_kafka
import seaweedfs_tpu_torch.notification.pubsub_queue as p_pubsub
import seaweedfs_tpu_torch.notification.sqs_queue as p_sqs
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.notification.kafka_queue import (KafkaProducer,
                                                          KafkaQueue,
                                                          MiniKafkaBroker)
from seaweedfs_tpu_torch.notification.pubsub_queue import (MiniPubSubServer,
                                                           PubSubQueue)
from seaweedfs_tpu_torch.notification.queue import attach_to_filer
from seaweedfs_tpu_torch.notification.sqs_queue import MiniSqsServer, SqsQueue

PKG = {"port": types.SimpleNamespace(kafka=p_kafka, sqs=p_sqs,
                                     pubsub=p_pubsub),
       "jax": types.SimpleNamespace(kafka=j_kafka, sqs=j_sqs,
                                    pubsub=j_pubsub)}


@pytest.fixture
def broker():
    b = MiniKafkaBroker().start()
    yield b
    b.stop()


def test_producer_wire_roundtrip(broker):
    p = KafkaProducer(broker.host, broker.port)
    assert p.produce("t1", b"k1", b"v1") == 0
    assert p.produce("t1", b"k2", b"v2" * 1000) == 1
    assert p.produce("other", b"", b"solo") == 0
    p.close()
    assert broker.messages("t1") == [(b"k1", b"v1"), (b"k2", b"v2" * 1000)]
    assert broker.messages("other") == [(b"", b"solo")]


def _filer_stack(tmp_path):
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    master = MasterServer(volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.url, device="cpu")
    vs.start()
    fs = FilerServer(master.url)
    fs.start()
    time.sleep(0.1)
    return [fs, vs, master]


def test_filer_server_publishes_via_notification_toml(broker, tmp_path,
                                                      monkeypatch):
    from seaweedfs_tpu_torch.utils import config as cfg
    from seaweedfs_tpu_torch.utils.httpd import http_call
    (tmp_path / "notification.toml").write_text(
        "[notification.kafka]\nenabled = true\n"
        f'address = "{broker.host}:{broker.port}"\n'
        'topic = "filer_events"\n')
    monkeypatch.setattr(cfg, "SEARCH_PATHS", [str(tmp_path)])
    servers = _filer_stack(tmp_path)
    try:
        assert http_call("POST", f"http://{servers[0].url}/evt.txt",
                         body=b"notify me")[0] < 300
        deadline = time.time() + 5
        while time.time() < deadline and \
                not broker.messages("filer_events"):
            time.sleep(0.05)
        keys = [k.decode() for k, _ in broker.messages("filer_events")]
        assert "/evt.txt" in keys
    finally:
        for srv in servers:
            srv.stop()


def test_filer_events_flow_to_kafka(broker):
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    mq = KafkaQueue(broker.host, broker.port, topic="meta")
    f = Filer()
    attach_to_filer(f, mq)
    f.create_entry(Entry(full_path="/docs/note.txt",
                         attr=Attr(mtime=1.0, mode=0o644), content=b"hello"))
    f.delete_entry("/docs/note.txt")
    mq.close()
    msgs = broker.messages("meta")
    assert [k for k, _ in msgs].count(b"/docs/note.txt") == 2
    create = json.loads(next(v for k, v in msgs if k == b"/docs/note.txt"))
    assert create["new_entry"]["full_path"] == "/docs/note.txt"
    delete = json.loads([v for k, v in msgs if k == b"/docs/note.txt"][-1])
    assert delete["new_entry"] is None
    assert delete["old_entry"]["full_path"] == "/docs/note.txt"


def test_kafka_producer_sets_explicit_io_timeout():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    try:
        host, port = srv.getsockname()
        p = KafkaProducer(host, port)
        try:
            assert p.sock.gettimeout() == p.timeout
        finally:
            p.sock.close()
    finally:
        srv.close()


def test_sqs_sendmessage_signed():
    srv = MiniSqsServer(access_key="AKX", secret_key="SKY").start()
    try:
        q = SqsQueue(f"{srv.url}/queue/weed-events", access_key="AKX",
                     secret_key="SKY")
        q.send_message("/buckets/a.txt", {"event": "create", "size": 3})
        q.send_message("/buckets/b.txt", {"event": "delete"})
        assert len(srv.messages) == 2
        assert srv.messages[0]["queue"] == "weed-events"
        assert srv.messages[0]["key"] == "/buckets/a.txt"
        assert srv.messages[0]["body"]["message"]["event"] == "create"
    finally:
        srv.stop()


def test_sqs_bad_signature_rejected():
    srv = MiniSqsServer(access_key="AKX", secret_key="SKY").start()
    try:
        q = SqsQueue(f"{srv.url}/queue/weed-events", access_key="AKX",
                     secret_key="WRONG")
        with pytest.raises(ConnectionError, match="403"):
            q.send_message("k", {"event": "create"})
        assert not srv.messages
    finally:
        srv.stop()


def test_pubsub_publish_with_token():
    srv = MiniPubSubServer(token="tok123").start()
    try:
        q = PubSubQueue(srv.url, "proj", "events", token="tok123")
        q.send_message("/x", {"event": "rename"})
        assert srv.messages == [{"project": "proj", "topic": "events",
                                 "key": "/x", "message": {"event": "rename"}}]
        bad = PubSubQueue(srv.url, "proj", "events", token="nope")
        with pytest.raises(ConnectionError, match="401"):
            bad.send_message("/y", {"event": "create"})
        assert len(srv.messages) == 1
    finally:
        srv.stop()


def test_filer_publishes_via_sqs_toml(tmp_path, monkeypatch):
    from seaweedfs_tpu_torch.utils import config as cfg
    from seaweedfs_tpu_torch.utils.httpd import http_call
    srv = MiniSqsServer().start()
    (tmp_path / "notification.toml").write_text(
        "[notification.aws_sqs]\nenabled = true\n"
        f'sqs_queue_url = "{srv.url}/queue/filer-events"\n'
        'access_key = "AK"\nsecret_key = "SK"\n')
    monkeypatch.setattr(cfg, "SEARCH_PATHS", [str(tmp_path)])
    servers = _filer_stack(tmp_path)
    try:
        assert http_call("POST", f"http://{servers[0].url}/notified.txt",
                         body=b"payload")[0] < 300
        deadline = time.time() + 5
        while not srv.messages and time.time() < deadline:
            time.sleep(0.05)
        assert any(m["key"] == "/notified.txt" for m in srv.messages)
    finally:
        for s in servers:
            s.stop()
        srv.stop()


# ---------------- across the packages ----------------


def _messages(seed, n=12):
    rng = np.random.default_rng(seed)
    return [(f"/d/f{i}.bin", {"event": ["create", "delete"][i % 2],
                              "size": int(rng.integers(1 << 20)),
                              "blob": rng.bytes(8).hex()})
            for i in range(n)]


@pytest.mark.parametrize("producer,server", [("port", "jax"),
                                             ("jax", "port")])
def test_kafka_across_packages(producer, server):
    """Each package's producer against the other's MiniKafkaBroker: the
    same offsets and the same logged (key, value) pairs as against its
    own package's broker."""
    msgs = _messages(1)
    seen = {}
    for sp in (server, producer):
        b = PKG[sp].kafka.MiniKafkaBroker().start()
        try:
            q = PKG[producer].kafka.KafkaQueue(b.host, b.port, topic="m")
            offsets = [q.producer.produce("m", k.encode(),
                                          json.dumps(v).encode())
                       for k, v in msgs]
            q.close()
            seen[sp] = (offsets, b.messages("m"))
        finally:
            b.stop()
    assert seen[server] == seen[producer]
    assert seen[server][0] == list(range(len(msgs)))


@pytest.mark.parametrize("producer,server", [("port", "jax"),
                                             ("jax", "port")])
def test_sqs_across_packages(producer, server):
    """Each package's SigV4-signed SqsQueue against the other's
    MiniSqsServer, which verifies every signature: the same recorded
    messages; a wrong secret refused by both."""
    msgs = _messages(2)
    seen = {}
    for sp in (server, producer):
        srv = PKG[sp].sqs.MiniSqsServer(access_key="AKX",
                                        secret_key="SKY").start()
        try:
            q = PKG[producer].sqs.SqsQueue(f"{srv.url}/queue/ev",
                                           access_key="AKX",
                                           secret_key="SKY")
            for k, v in msgs:
                q.send_message(k, v)
            bad = PKG[producer].sqs.SqsQueue(f"{srv.url}/queue/ev",
                                             access_key="AKX",
                                             secret_key="no")
            with pytest.raises(ConnectionError, match="403"):
                bad.send_message("k", {})
            seen[sp] = [(m["queue"], m["key"], m["body"])
                        for m in srv.messages]
        finally:
            srv.stop()
    assert seen[server] == seen[producer]
    assert len(seen[server]) == len(msgs)


@pytest.mark.parametrize("producer,server", [("port", "jax"),
                                             ("jax", "port")])
def test_pubsub_across_packages(producer, server):
    """Each package's PubSubQueue against the other's MiniPubSubServer:
    the same recorded messages; a wrong token refused by both."""
    msgs = _messages(3)
    seen = {}
    for sp in (server, producer):
        srv = PKG[sp].pubsub.MiniPubSubServer(token="tok").start()
        try:
            q = PKG[producer].pubsub.PubSubQueue(srv.url, "p", "t",
                                                 token="tok")
            for k, v in msgs:
                q.send_message(k, v)
            with pytest.raises(ConnectionError, match="401"):
                PKG[producer].pubsub.PubSubQueue(
                    srv.url, "p", "t", token="x").send_message("k", {})
            seen[sp] = list(srv.messages)
        finally:
            srv.stop()
    assert seen[server] == seen[producer]
    assert [m["key"] for m in seen[server]] == [k for k, _ in msgs]
