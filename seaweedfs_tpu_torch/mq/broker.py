"""Message queue broker over the filer (reference weed/mq — embryonic
there too: topics live under /topics, segments are filer files).

Topics partition by key hash; publish appends JSONL records to the
active segment file in the filer; subscribe replays segments then tails
the live feed. The gRPC plane (mq/broker_grpc.py) serves the same
broker over streaming Publish/Subscribe RPCs (reference weed/pb/mq.proto).

Values are arbitrary bytes: they ride JSONL via utf-8 surrogateescape,
which is lossless (json escapes lone surrogates as \\udcXX) and keeps
segments greppable for text payloads.

The port's copy of seaweedfs_tpu/mq/broker.py. It imports nothing of that
package.
"""

from __future__ import annotations

import collections
import hashlib
import json
import threading
import time
from typing import Callable, Iterator, Optional

TOPICS_ROOT = "/topics"
SEGMENT_MAX_BYTES = 4 * 1024 * 1024
# live-tail ring: a subscriber that lags more than this many records
# behind the head gets MqTailOverflow (re-attach and replay)
RECENT_MAX = 65536


class MqTailOverflow(RuntimeError):
    """A tail subscriber fell further behind than the live ring holds;
    records were evicted unseen. Re-attach and replay."""


class Broker:
    def __init__(self, filer_server):
        self.fs = filer_server
        self.filer = filer_server.filer
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._segments: dict[tuple[str, int], bytearray] = {}
        # popped segments whose filer upload is still in flight, keyed
        # by their final segment filename (assigned at pop time, under
        # the lock, so two racing flushes of one partition can never
        # complete with inverted names) — kept visible so a subscriber
        # attaching mid-flush misses nothing
        self._flushing: dict[tuple[str, int], list[tuple[str, bytes]]] = {}
        self._flush_no = 0
        self._topic_lock = threading.Lock()
        self._conf_cache: dict[tuple[str, str], dict] = {}
        self._seq = 0  # broker-global publish sequence (per process)
        self._recent: collections.deque = collections.deque(maxlen=RECENT_MAX)
        # highest ring-evicted seq per (topic, partition): a slow tailer
        # overflows only when an evicted record could actually have
        # matched its subscription, not whenever busy foreign topics
        # churn the shared ring
        self._evict_high: dict[tuple[str, int], int] = {}
        self.message_count = 0
        self.bytes_count = 0

    # ---- topics ----
    def create_topic(self, namespace: str, topic: str,
                     partition_count: int = 4) -> None:
        base = f"{TOPICS_ROOT}/{namespace}/{topic}"
        self.filer.mkdirs(base)
        from seaweedfs_tpu_torch.filer.entry import Attr, Entry
        conf = Entry(full_path=f"{base}/.conf",
                     attr=Attr(mtime=time.time()),
                     content=json.dumps(
                         {"partition_count": partition_count}).encode())
        self.filer.create_entry(conf)

    def ensure_topic(self, namespace: str, topic: str,
                     partition_count: int = 4) -> int:
        """Create-if-absent under a lock (two racing creates must not
        disagree on partition_count — keys would rehash differently).
        Returns the authoritative partition count."""
        with self._topic_lock:
            try:
                return self.topic_conf(namespace, topic)["partition_count"]
            except LookupError:
                self.create_topic(namespace, topic, partition_count)
                return partition_count

    def topic_conf(self, namespace: str, topic: str) -> dict:
        # cached: topic configuration is immutable after creation
        # (ensure_topic never reconfigures), and publish resolves it
        # per record — a filer lookup + JSON parse per message would
        # dominate the streamed-Publish hot path
        conf = self._conf_cache.get((namespace, topic))
        if conf is not None:
            return conf
        e = self.filer.find_entry(
            f"{TOPICS_ROOT}/{namespace}/{topic}/.conf")
        if e is None:
            raise LookupError(f"topic {namespace}/{topic} not found")
        conf = json.loads(e.content)
        self._conf_cache[(namespace, topic)] = conf
        return conf

    def list_topics(self, namespace: str = "") -> list[dict]:
        """All configured topics: [{namespace, topic, partition_count}]."""
        out = []
        namespaces = ([namespace] if namespace else
                      [e.name for e in self.filer.list_entries(
                          TOPICS_ROOT, limit=1 << 20)])
        for ns in namespaces:
            for e in self.filer.list_entries(
                    f"{TOPICS_ROOT}/{ns}", limit=1 << 20):
                if not e.is_directory:
                    continue
                try:
                    conf = self.topic_conf(ns, e.name)
                except LookupError:
                    continue
                out.append({"namespace": ns, "topic": e.name,
                            "partition_count": conf["partition_count"]})
        return out

    # ---- publish ----
    def publish(self, namespace: str, topic: str, key: str,
                value) -> int:
        return self.publish_record(namespace, topic, key, value)[0]

    def publish_record(self, namespace: str, topic: str, key: str,
                       value: "dict | bytes | str") -> tuple[int, int]:
        """Returns (partition, ack_sequence)."""
        conf = self.topic_conf(namespace, topic)
        partition = int(hashlib.sha1(key.encode()).hexdigest(), 16) \
            % conf["partition_count"]
        if isinstance(value, bytes):
            value = value.decode("utf-8", "surrogateescape")
        record = {"ts": time.time_ns(), "key": key, "value": value}
        line = (json.dumps(record) + "\n").encode()
        nt = f"{namespace}/{topic}"
        to_flush = None
        with self._cond:
            self._seq += 1
            seq = self._seq
            seg = self._segments.setdefault((nt, partition), bytearray())
            seg += line
            self.message_count += 1
            self.bytes_count += len(line)
            if len(self._recent) == self._recent.maxlen:
                es, et, ep, _ = self._recent[0]  # about to fall off
                self._evict_high[(et, ep)] = es
            self._recent.append((seq, nt, partition, record))
            if len(seg) >= SEGMENT_MAX_BYTES:
                to_flush = self._begin_flush(nt, partition)
            self._cond.notify_all()
        if to_flush is not None:
            self._complete_flush(namespace, topic, partition, *to_flush)
        return partition, seq

    def _begin_flush(self, nt: str, partition: int
                     ) -> Optional[tuple[str, bytes]]:
        """Pop the active segment into the in-flight set and assign its
        FINAL filename now, under the broker lock — two racing flushes
        of one partition then sort correctly by name no matter which
        upload finishes first. The upload itself runs OUTSIDE the lock
        (a 4MB chunk upload must not stall every publisher and tail)."""
        seg = self._segments.pop((nt, partition), None)
        if not seg:
            return None
        self._flush_no += 1
        name = f"{time.time_ns():019d}-{self._flush_no:06d}.seg"
        data = bytes(seg)
        self._flushing.setdefault((nt, partition), []).append((name, data))
        return name, data

    def _complete_flush(self, namespace: str, topic: str, partition: int,
                        name: str, data: bytes) -> None:
        from seaweedfs_tpu_torch.filer.entry import Attr, Entry
        path = (f"{TOPICS_ROOT}/{namespace}/{topic}/p{partition:02d}"
                f"/{name}")
        entry = Entry(full_path=path,
                      attr=Attr(mtime=time.time(), file_size=len(data)))
        if len(data) <= 2048:
            entry.content = data
        else:
            # chunk upload (HTTP to volume servers) runs lock-free
            entry.chunks = self.fs._upload_chunks(data, "", "")
        key = (f"{namespace}/{topic}", partition)
        with self._lock:
            # entry creation is an in-process store insert — cheap, and
            # doing it under the lock keeps "every record is in exactly
            # one of {filer segments, in-flight, active segment}" true
            # for subscriber attach snapshots
            self.filer.create_entry(entry)
            lst = self._flushing.get(key, [])
            if (name, data) in lst:
                lst.remove((name, data))
            if not lst:
                self._flushing.pop(key, None)

    def flush(self) -> None:
        with self._lock:
            pending = [(nt, p, self._begin_flush(nt, p))
                       for (nt, p) in list(self._segments)]
        for nt, p, item in pending:
            if item is not None:
                ns, topic = nt.split("/", 1)
                self._complete_flush(ns, topic, p, *item)

    # ---- subscribe ----
    @staticmethod
    def _parse(data: bytes) -> Iterator[dict]:
        for line in data.decode().splitlines():
            if line:
                yield json.loads(line)

    def read_topic(self, namespace: str, topic: str,
                   partition: Optional[int] = None) -> Iterator[dict]:
        """Replay all flushed segments (+ any in-memory tail) in order."""
        for rec in self.subscribe(namespace, topic, partition):
            yield {k: rec[k] for k in ("ts", "key", "value")}

    def subscribe(self, namespace: str, topic: str,
                  partition: Optional[int] = None, tail: bool = False,
                  since_ns: int = 0,
                  is_active: Callable[[], bool] = lambda: True,
                  ) -> Iterator[dict]:
        """Replay then (optionally) tail. Yields
        {ts, key, value, partition, seq} — seq==0 for replayed records.

        The attach point is taken under the broker lock: the flushed
        segment list, in-flight flushes, the in-memory tails, and the
        current sequence are snapshotted atomically, so replay + tail
        together see every record exactly once — UNLESS the tail
        consumer lags more than RECENT_MAX records behind the broker,
        in which case the overflow is detected and raised as
        MqTailOverflow (the consumer re-attaches and replays) rather
        than silently skipped.
        """
        conf = self.topic_conf(namespace, topic)
        parts = ([partition] if partition is not None
                 else list(range(conf["partition_count"])))
        nt = f"{namespace}/{topic}"
        with self._cond:
            # cheap snapshots only under the lock: byte copies + the
            # in-process segment listing; JSON parsing happens after
            attach = self._seq
            inflight = {p: list(self._flushing.get((nt, p), ()))
                        for p in parts}
            active = {p: bytes(self._segments.get((nt, p), b""))
                      for p in parts}
            flushed = {}
            for p in parts:
                pdir = f"{TOPICS_ROOT}/{namespace}/{topic}/p{p:02d}"
                flushed[p] = list(self.filer.list_entries(
                    pdir, limit=1 << 20))
        for p in parts:
            # completed and in-flight segments merge by filename — the
            # name is assigned at pop time under the lock, so name
            # order IS record order even when an in-flight upload
            # finishes after a younger one
            segs = ([(e.name, None, e) for e in flushed[p]] +
                    [(name, data, None) for name, data in inflight[p]])
            segs.sort(key=lambda s: s[0])
            for _, data, entry in segs:
                if data is None:
                    data = self.fs._read_entry_bytes(entry)
                for rec in self._parse(data):
                    if rec["ts"] >= since_ns:
                        yield {**rec, "partition": p, "seq": 0}
            for rec in self._parse(active[p]):
                if rec["ts"] >= since_ns:
                    yield {**rec, "partition": p, "seq": 0}
        if not tail:
            return
        last = attach
        want = set(parts)
        while is_active():
            with self._cond:
                if self._seq <= last:
                    self._cond.wait(timeout=0.25)
                # scan only entries newer than `last` (right end of the
                # ring), then advance past everything seen — a busy
                # foreign topic must not make this O(ring) per wakeup
                cur = self._seq
                batch = []
                hit_last = False
                for s, t, part, rec in reversed(self._recent):
                    if s <= last:
                        hit_last = True
                        break
                    if t == nt and part in want:
                        batch.append((s, part, rec))
                if (not hit_last and self._recent
                        and self._recent[0][0] > last + 1
                        and any(self._evict_high.get((nt, p), 0) > last
                                for p in want)):
                    # entries in (last, oldest) were evicted before we
                    # scanned them AND at least one evicted record
                    # belonged to a subscribed (topic, partition) — fail
                    # loudly, never skip silently. Foreign-topic churn
                    # alone does not abort a quiet topic's tail.
                    raise MqTailOverflow(
                        f"tail lagged past the {RECENT_MAX}-record live "
                        f"ring (behind by {cur - last}); re-attach and "
                        f"replay")
                batch.reverse()
                last = cur
            for s, part, rec in batch:
                if rec["ts"] >= since_ns:
                    yield {**rec, "partition": part, "seq": s}
