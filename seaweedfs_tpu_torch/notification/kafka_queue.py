"""Kafka-wire notification queue: publish filer meta events to a real
Kafka-protocol broker over a raw socket.

Redesign of reference weed/notification/kafka/kafka_queue.go — there
the Shopify/sarama client does the lifting; here a dependency-free
implementation of the Kafka wire protocol's Produce API v0 (the
simplest stable version every broker still accepts) speaks to ANY
Kafka-compatible broker. Same playbook as the RESP filer store
(filer/redis_store.py): the client implements the public wire protocol,
MiniKafkaBroker is an in-process stub implementing the server half so
tests exercise the full framing without a JVM.

Wire format (Kafka protocol guide, Produce v0):
  request  = INT32 size | INT16 api_key=0 | INT16 version=0
             | INT32 correlation | STRING client_id
             | INT16 acks | INT32 timeout
             | ARRAY topics { STRING name
                 ARRAY partitions { INT32 id | INT32 set_size
                                    | MESSAGE_SET } }
  message  = INT64 offset | INT32 size | INT32 crc32(payload)
             | INT8 magic=0 | INT8 attrs=0 | BYTES key | BYTES value
  response = INT32 size | INT32 correlation
             | ARRAY topics { STRING name
                 ARRAY partitions { INT32 id | INT16 error
                                    | INT64 base_offset } }

The port's copy of seaweedfs_tpu/notification/kafka_queue.py. It imports
nothing of that package.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from typing import Optional

from seaweedfs_tpu_torch.notification.queue import MessageQueue


def _str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _message(key: bytes, value: bytes) -> bytes:
    payload = struct.pack(">bb", 0, 0) + _bytes(key) + _bytes(value)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    msg = struct.pack(">I", crc) + payload
    # offset is assigned broker-side; producers send 0
    return struct.pack(">qi", 0, len(msg)) + msg


class KafkaProducer:
    """Minimal Produce-v0 client: one partition-0 topic, acks=1."""

    def __init__(self, host: str, port: int, client_id: str = "weed-tpu",
                 timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self.client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()
        self.sock: Optional[socket.socket] = None
        self._connect()

    def _connect(self) -> None:
        self.sock = socket.create_connection((self.host, self.port),
                                             timeout=self.timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # explicit per-op deadline: produce() reconnects on a timed-out
        # socket, so a finite I/O timeout is the retry trigger, but it
        # must be a deliberate choice, not the connect budget leaking
        self.sock.settimeout(self.timeout)

    def produce(self, topic: str, key: bytes, value: bytes) -> int:
        """Send one message; returns the broker-assigned base offset.
        Reconnects once on a dead socket (broker restarts must not
        permanently kill the notification path)."""
        mset = _message(key, value)
        body = (struct.pack(">hi", 1, 10000)          # acks=1, timeout
                + struct.pack(">i", 1) + _str(topic)  # 1 topic
                + struct.pack(">i", 1)                # 1 partition
                + struct.pack(">i", 0)                # partition 0
                + struct.pack(">i", len(mset)) + mset)
        with self._lock:
            self._corr += 1
            corr = self._corr
            header = (struct.pack(">hhi", 0, 0, corr)  # Produce v0
                      + _str(self.client_id))
            frame = header + body
            wire = struct.pack(">i", len(frame)) + frame
            try:
                if self.sock is None:
                    self._connect()
                self.sock.sendall(wire)
                resp = self._read_frame()
            except (OSError, ConnectionError):
                try:
                    if self.sock is not None:
                        self.sock.close()
                finally:
                    self.sock = None
                self._connect()
                self.sock.sendall(wire)
                resp = self._read_frame()
        rcorr, = struct.unpack_from(">i", resp, 0)
        if rcorr != corr:
            raise RuntimeError(f"correlation mismatch {rcorr} != {corr}")
        # parse: topic array -> partition array -> error/base_offset
        off = 4
        ntopics, = struct.unpack_from(">i", resp, off)
        off += 4
        tlen, = struct.unpack_from(">h", resp, off)
        off += 2 + tlen
        nparts, = struct.unpack_from(">i", resp, off)
        off += 4
        _pid, err, base = struct.unpack_from(">ihq", resp, off)
        if err:
            raise RuntimeError(f"kafka produce error code {err}")
        return base

    def _read_frame(self) -> bytes:
        hdr = self._recv_exact(4)
        size, = struct.unpack(">i", hdr)
        return self._recv_exact(size)

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            got = self.sock.recv(n - len(buf))
            if not got:
                raise ConnectionError("kafka broker closed connection")
            buf += got
        return bytes(buf)

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class KafkaQueue(MessageQueue):
    """notification SPI backend over the Kafka wire protocol
    (reference notification.toml [notification.kafka])."""

    name = "kafka"

    def __init__(self, host: str = "127.0.0.1", port: int = 9092,
                 topic: str = "seaweedfs_meta"):
        self.producer = KafkaProducer(host, port)
        self.topic = topic

    def send_message(self, key: str, message: dict) -> None:
        self.producer.produce(self.topic, key.encode(),
                              json.dumps(message).encode())

    def close(self) -> None:
        self.producer.close()


class MiniKafkaBroker:
    """In-process stub implementing the server half of Produce v0:
    parses the request (CRC-checked), appends messages to per-topic
    logs, replies with base offsets. The test double AND a dev sink —
    point KafkaQueue at a real broker and the same bytes flow."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.logs: dict[str, list[tuple[bytes, bytes]]] = {}
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="kafka-accept")

    def start(self) -> "MiniKafkaBroker":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def messages(self, topic: str) -> list[tuple[bytes, bytes]]:
        with self._lock:
            return list(self.logs.get(topic, []))

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True, name="kafka-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                hdr = self._recv_exact(conn, 4)
                if hdr is None:
                    return
                size, = struct.unpack(">i", hdr)
                frame = self._recv_exact(conn, size)
                if frame is None:
                    return
                resp = self._handle(frame)
                if resp is not None:
                    conn.sendall(struct.pack(">i", len(resp)) + resp)
        except (OSError, struct.error, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _recv_exact(conn, n) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            got = conn.recv(n - len(buf))
            if not got:
                return None
            buf += got
        return bytes(buf)

    def _handle(self, frame: bytes) -> Optional[bytes]:
        off = 0
        api_key, api_ver, corr = struct.unpack_from(">hhi", frame, off)
        off += 8
        cid_len, = struct.unpack_from(">h", frame, off)
        off += 2 + max(cid_len, 0)
        if api_key != 0 or api_ver != 0:
            raise ValueError(f"unsupported api {api_key} v{api_ver}")
        _acks, _timeout = struct.unpack_from(">hi", frame, off)
        off += 6
        ntopics, = struct.unpack_from(">i", frame, off)
        off += 4
        out_topics = []
        for _ in range(ntopics):
            tlen, = struct.unpack_from(">h", frame, off)
            off += 2
            topic = frame[off:off + tlen].decode()
            off += tlen
            nparts, = struct.unpack_from(">i", frame, off)
            off += 4
            parts = []
            for _ in range(nparts):
                pid, set_size = struct.unpack_from(">ii", frame, off)
                off += 8
                mset = frame[off:off + set_size]
                off += set_size
                base = self._append(topic, mset)
                parts.append((pid, 0, base))
            out_topics.append((topic, parts))
        resp = bytearray(struct.pack(">i", corr))
        resp += struct.pack(">i", len(out_topics))
        for topic, parts in out_topics:
            resp += _str(topic)
            resp += struct.pack(">i", len(parts))
            for pid, err, base in parts:
                resp += struct.pack(">ihq", pid, err, base)
        return bytes(resp)

    def _append(self, topic: str, mset: bytes) -> int:
        off = 0
        with self._lock:
            log = self.logs.setdefault(topic, [])
            base = len(log)
            while off + 12 <= len(mset):
                _offset, msize = struct.unpack_from(">qi", mset, off)
                off += 12
                msg = mset[off:off + msize]
                off += msize
                crc, = struct.unpack_from(">I", msg, 0)
                payload = msg[4:]
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    raise ValueError("bad message crc")
                p = 2  # skip magic + attrs
                klen, = struct.unpack_from(">i", payload, p)
                p += 4
                key = payload[p:p + klen] if klen >= 0 else b""
                p += max(klen, 0)
                vlen, = struct.unpack_from(">i", payload, p)
                p += 4
                value = payload[p:p + vlen] if vlen >= 0 else b""
                log.append((key, value))
            return base
