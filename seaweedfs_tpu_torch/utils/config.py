"""TOML configuration loading + scaffold defaults.

Functional equivalent of reference weed/util/config.go (viper search in
./, ~/.seaweedfs, /etc/seaweedfs) and weed/command/scaffold (embedded
default tomls). tomllib reads; scaffold emits the defaults. The port of
seaweedfs_tpu/utils/config.py, which falls back to its own TOML reader
before Python 3.11; the port needs 3.11 or later.
"""

from __future__ import annotations

import os
from typing import Any

import tomllib

SEARCH_PATHS = [".", os.path.expanduser("~/.seaweedfs-tpu"),
                "/etc/seaweedfs-tpu"]

DEFAULTS = {
    "security": """\
# security.toml — JWT signing + TLS + whitelists
[jwt.signing]
key = ""
expires_after_seconds = 10

[access]
ui = false
# ip whitelist, e.g. ["10.0.0.0/8", "127.0.0.1"]
white_list = []

# Mutual TLS for every gRPC plane + HTTP admin (reference security/tls.go).
# Set all three to enable; per-role sections ([grpc.master], [grpc.volume],
# [grpc.filer], [grpc.client]) override.
[grpc]
ca = ""
cert = ""
key = ""
""",
    "master": """\
# master.toml
[master.volume_growth]
copy_1 = 7
copy_2 = 6
copy_3 = 3
copy_other = 1

[master.maintenance]
garbage_threshold = 0.3
""",
    "filer": """\
# filer.toml — filer store selection
[memory]
enabled = true

[sqlite]
enabled = false
dbFile = "./filer.db"
""",
    "replication": """\
# replication.toml — sink for filer.sync / filer.replicate
[sink.filer]
enabled = false
url = "localhost:8888"
directory = ""            # destination path prefix

[sink.local]
enabled = false
directory = "/data/backup"

[sink.s3]
enabled = false
endpoint = "http://localhost:8333"
bucket = "backup"
directory = ""            # key prefix
aws_access_key_id = ""
aws_secret_access_key = ""
region = "us-east-1"

[sink.azure]
enabled = false
endpoint = ""             # https://<account>.blob.core.windows.net
container = "backup"
account_name = ""
account_key = ""          # base64 SharedKey
directory = ""
""",
    "notification": """\
# notification.toml — filer event publishing
[notification.log]
enabled = false

[notification.file]
enabled = false
path = "./notifications.jsonl"

[notification.kafka]
enabled = false
address = "127.0.0.1:9092"   # any Kafka-wire broker
topic = "seaweedfs_meta"

[notification.aws_sqs]
enabled = false
sqs_queue_url = ""           # any SQS-wire endpoint (AWS/localstack/elasticmq)
access_key = ""
secret_key = ""
region = "us-east-1"

[notification.google_pub_sub]
enabled = false
endpoint = "https://pubsub.googleapis.com"   # or an emulator
project_id = ""
topic = "seaweedfs_meta"
token = ""                   # static bearer token (emulators accept any)
""",
    "shell": """\
# shell.toml
[cluster]
default = "default"

[cluster.default]
master = "localhost:9333"
filer = "localhost:8888"
""",
}


def load_configuration(name: str, required: bool = False) -> dict[str, Any]:
    """Find <name>.toml in the search paths (reference LoadConfiguration)."""
    for base in SEARCH_PATHS:
        path = os.path.join(base, f"{name}.toml")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return tomllib.load(f)
    if required:
        raise FileNotFoundError(
            f"{name}.toml not found in {SEARCH_PATHS}; "
            f"run `weed-tpu scaffold -config {name}` to generate one")
    return {}


def get(conf: dict, dotted: str, default: Any = None) -> Any:
    cur: Any = conf
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def scaffold(name: str) -> str:
    if name not in DEFAULTS:
        raise KeyError(f"unknown config {name!r}; have {sorted(DEFAULTS)}")
    return DEFAULTS[name]
