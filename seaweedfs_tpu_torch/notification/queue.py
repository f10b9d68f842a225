"""Notification queue SPI: publish filer meta events to a message queue.

Functional equivalent of reference weed/notification (kafka/aws_sqs/
gcp_pub_sub/gocdk/log backends behind a MessageQueue interface). The
cloud SDKs aren't available here, so we ship the SPI plus in-memory,
log, and JSONL-file queues; external-broker backends implement the same
two methods.

The port's copy of seaweedfs_tpu/notification/queue.py: the SPI, the
in-memory, log and file queues, ``attach_to_filer``, and
``make_queue_from_config`` over them and the Kafka, SQS and Pub/Sub
queues (notification/{kafka,sqs,pubsub}_queue.py). It imports nothing of
that package.
"""

from __future__ import annotations

import abc
import json
import queue
import threading
from typing import Optional


class MessageQueue(abc.ABC):
    name = "abstract"

    @abc.abstractmethod
    def send_message(self, key: str, message: dict) -> None: ...

    def close(self) -> None:
        pass


class InMemoryQueue(MessageQueue):
    name = "memory"

    def __init__(self, maxsize: int = 65536):
        self.q: queue.Queue = queue.Queue(maxsize)

    def send_message(self, key: str, message: dict) -> None:
        self.q.put((key, message))

    def receive(self, timeout: Optional[float] = None):
        return self.q.get(timeout=timeout)


class LogQueue(MessageQueue):
    """Log-only backend (reference notification/log)."""

    name = "log"

    def __init__(self, logger=None):
        import logging
        self.logger = logger or logging.getLogger("seaweedfs_tpu_torch.notify")

    def send_message(self, key: str, message: dict) -> None:
        self.logger.info("notification %s: %s", key, json.dumps(message))


class FileQueue(MessageQueue):
    """Durable JSONL file queue."""

    name = "file"

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def send_message(self, key: str, message: dict) -> None:
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps({"key": key, "message": message}) + "\n")


def make_queue_from_config() -> Optional[MessageQueue]:
    """Build the enabled backend from notification.toml (reference
    weed/notification/configuration.go LoadConfiguration): the first
    section with enabled=true wins."""
    from seaweedfs_tpu_torch.utils import config as _cfg
    conf = _cfg.load_configuration("notification")
    if not conf:
        return None
    root = conf.get("notification", conf)
    if root.get("log", {}).get("enabled"):
        return LogQueue()
    if root.get("file", {}).get("enabled"):
        return FileQueue(root["file"].get("path", "./notifications.jsonl"))
    if root.get("kafka", {}).get("enabled"):
        from seaweedfs_tpu_torch.notification.kafka_queue import KafkaQueue
        k = root["kafka"]
        addr = k.get("address", "127.0.0.1:9092")
        if ":" in addr:
            host, _, port_s = addr.rpartition(":")
            port = int(port_s)
        else:
            host, port = addr, 9092
        return KafkaQueue(host or "127.0.0.1", port,
                          topic=k.get("topic", "seaweedfs_meta"))
    if root.get("aws_sqs", {}).get("enabled"):
        from seaweedfs_tpu_torch.notification.sqs_queue import SqsQueue
        s = root["aws_sqs"]
        return SqsQueue(s["sqs_queue_url"],
                        access_key=s.get("access_key", ""),
                        secret_key=s.get("secret_key", ""),
                        region=s.get("region", "us-east-1"))
    if root.get("google_pub_sub", {}).get("enabled"):
        from seaweedfs_tpu_torch.notification.pubsub_queue import PubSubQueue
        g = root["google_pub_sub"]
        return PubSubQueue(
            g.get("endpoint", "https://pubsub.googleapis.com"),
            g["project_id"], g["topic"], token=g.get("token", ""))
    return None


def attach_to_filer(filer, mq: MessageQueue) -> None:
    """Forward every filer meta event to the queue (the reference wires
    this inside Filer.NotifyUpdateEvent). Queue errors are LOGGED, not
    raised — the mutation already persisted, and a broker hiccup must
    not fail filer writes (reference filer_notify.go does the same)."""
    import logging
    original = filer._notify
    log = logging.getLogger("seaweedfs_tpu_torch.notify")

    def notify(directory, old_entry, new_entry):
        original(directory, old_entry, new_entry)
        path = (new_entry or old_entry or {}).get("full_path", directory)
        try:
            mq.send_message(path, {"directory": directory,
                                   "old_entry": old_entry,
                                   "new_entry": new_entry})
        except Exception as e:
            log.warning("notification for %s failed: %s", path, e)
    filer._notify = notify
