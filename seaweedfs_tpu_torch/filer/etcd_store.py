"""etcd-protocol filer store (reference weed/filer/etcd/etcd_store.go,
which uses the etcd client SDK; here the public etcdserverpb.KV gRPC
API is spoken directly — Range/Put/DeleteRange against any stock etcd,
the same dependency-free approach as the redis RESP2 store).

Key scheme (differs from the reference's dir+"/"+name: a "\\x00"
separator makes "direct children of D" a clean key range that can
never swallow deeper descendants or sibling directories):

  entry:  b"e" + dir + b"\\x00" + name     value = entry JSON
  kv:     b"k" + key

Direct children of D therefore live in [e D \\x00, e D \\x01) and
deeper descendants in [e D /, e D 0) — two exact ranges, used by both
listing and delete_folder_children.

Tests run against MiniEtcdServer (same wire surface, in memory).

The port's copy of seaweedfs_tpu/filer/etcd_store.py, over its own copy of
pb/etcdkv_pb2.py. It imports nothing of that package.
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Optional

import grpc

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore
from seaweedfs_tpu_torch.pb import etcdkv_pb2 as pb

SERVICE = "etcdserverpb.KV"


class EtcdClient:
    """Thin typed client for the KV subset."""

    def __init__(self, address: str, timeout: float = 10.0):
        # etcd is an EXTERNAL system: the cluster's mesh mTLS
        # (security.toml [grpc]) must not leak onto this channel — a
        # stock etcd would reject the mesh client cert. Plaintext by
        # default; a dedicated [grpc.etcd] section with its own
        # ca/cert/key (reference filer.toml [etcd] tls keys) opts in.
        from seaweedfs_tpu_torch.utils import config as config_mod
        from seaweedfs_tpu_torch.utils import tls as tlsmod
        conf = config_mod.load_configuration("security") or {}
        etcd_conf = (conf.get("grpc", {}) or {}).get("etcd", {})
        cfg = None
        if isinstance(etcd_conf, dict) and etcd_conf.get("ca") \
                and etcd_conf.get("cert") and etcd_conf.get("key"):
            cfg = tlsmod.TlsConfig(ca_file=etcd_conf["ca"],
                                   cert_file=etcd_conf["cert"],
                                   key_file=etcd_conf["key"])
        self.channel = tlsmod.make_channel(address, tls=cfg)
        self.timeout = timeout

    def _call(self, method: str, request, resp_cls):
        fn = self.channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)
        return fn(request, timeout=self.timeout)

    def put(self, key: bytes, value: bytes) -> None:
        self._call("Put", pb.PutRequest(key=key, value=value),
                   pb.PutResponse)

    def range(self, key: bytes, range_end: bytes = b"",
              limit: int = 0) -> list[tuple[bytes, bytes]]:
        resp = self._call("Range", pb.RangeRequest(
            key=key, range_end=range_end, limit=limit), pb.RangeResponse)
        return [(kv.key, kv.value) for kv in resp.kvs]

    def delete_range(self, key: bytes, range_end: bytes = b"") -> int:
        resp = self._call("DeleteRange", pb.DeleteRangeRequest(
            key=key, range_end=range_end), pb.DeleteRangeResponse)
        return resp.deleted

    def close(self) -> None:
        self.channel.close()


def _entry_key(full_path: str) -> bytes:
    d, _, n = full_path.rpartition("/")
    return b"e" + (d or "/").encode() + b"\x00" + n.encode()


class EtcdFilerStore(FilerStore):
    name = "etcd"

    def __init__(self, host: str = "127.0.0.1", port: int = 2379):
        self.client = EtcdClient(f"{host}:{port}")

    def insert_entry(self, entry: Entry) -> None:
        self.client.put(_entry_key(entry.full_path),
                        json.dumps(entry.to_dict()).encode())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Optional[Entry]:
        kvs = self.client.range(_entry_key(full_path))
        if not kvs:
            return None
        return Entry.from_dict(json.loads(kvs[0][1]))

    def delete_entry(self, full_path: str) -> None:
        self.client.delete_range(_entry_key(full_path))

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/")
        if not base:  # root: every entry key EXCEPT the root's own
            # (b"e/\x00") — other stores keep the root entry when
            # clearing its children, so find_entry('/') must survive
            # every key is b"e/" + ... and the smallest is the root key
            # itself, so one range starting just past it covers all
            root_key = _entry_key("/")
            self.client.delete_range(root_key + b"\x00", b"f")
            return
        enc = base.encode()
        # direct children, then deeper descendants — two exact ranges
        self.client.delete_range(b"e" + enc + b"\x00",
                                 b"e" + enc + b"\x01")
        self.client.delete_range(b"e" + enc + b"/", b"e" + enc + b"0")

    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        base = (dir_path.rstrip("/") or "/").encode()
        lo = b"e" + base + b"\x00" + (start_name or prefix).encode()
        if prefix:
            hi = b"e" + base + b"\x00" + prefix.encode() + b"\xff" * 8
        else:
            hi = b"e" + base + b"\x01"
        out = []
        while len(out) < limit:
            # +1 covers a possible skipped start_name; asking for only
            # what's still needed keeps the final batch small, and a
            # short reply means the range is exhausted — no extra RPC
            ask = min(limit - len(out) + 1, 1024)
            batch = self.client.range(lo, hi, limit=ask)
            for k, v in batch:
                name = k.split(b"\x00", 1)[1].decode()
                if name == start_name and not include_start:
                    continue
                if prefix and not name.startswith(prefix):
                    continue
                out.append(Entry.from_dict(json.loads(v)))
                if len(out) >= limit:
                    break
            if len(batch) < ask:
                break
            lo = batch[-1][0] + b"\x00"  # next key after the last seen
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.client.put(b"k" + key, value)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        kvs = self.client.range(b"k" + key)
        return kvs[0][1] if kvs else None

    def kv_delete(self, key: bytes) -> None:
        self.client.delete_range(b"k" + key)

    def close(self) -> None:
        self.client.close()


class MiniEtcdServer:
    """In-process etcdserverpb.KV endpoint for tests: a sorted
    in-memory keyspace behind the real wire surface."""

    def __init__(self):
        self._kv: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []
        self._rev = 0
        self._lock = threading.Lock()
        self._server = None
        self.port = 0

    # ---- RPC handlers ----
    def _select(self, key: bytes, range_end: bytes) -> list[bytes]:
        if not range_end:
            return [key] if key in self._kv else []
        lo = bisect.bisect_left(self._keys, key)
        hi = bisect.bisect_left(self._keys, range_end)
        return self._keys[lo:hi]

    def range(self, request, context):
        with self._lock:
            self._rev += 1
            keys = self._select(request.key, request.range_end)
            if request.limit:
                more = len(keys) > request.limit
                keys = keys[:request.limit]
            else:
                more = False
            kvs = [pb.KeyValue(key=k, value=b"" if request.keys_only
                               else self._kv[k]) for k in keys]
        return pb.RangeResponse(
            header=pb.ResponseHeader(revision=self._rev),
            kvs=[] if request.count_only else kvs,
            more=more, count=len(keys))

    def put(self, request, context):
        with self._lock:
            self._rev += 1
            if request.key not in self._kv:
                bisect.insort(self._keys, request.key)
            self._kv[request.key] = request.value
        return pb.PutResponse(
            header=pb.ResponseHeader(revision=self._rev))

    def delete_range(self, request, context):
        with self._lock:
            self._rev += 1
            doomed = self._select(request.key, request.range_end)
            for k in doomed:
                del self._kv[k]
                i = bisect.bisect_left(self._keys, k)
                self._keys.pop(i)
        return pb.DeleteRangeResponse(
            header=pb.ResponseHeader(revision=self._rev),
            deleted=len(doomed))

    # ---- lifecycle ----
    def start(self):
        from concurrent import futures
        u = grpc.unary_unary_rpc_method_handler
        rpcs = {
            "Range": u(self.range,
                       request_deserializer=pb.RangeRequest.FromString,
                       response_serializer=(
                           pb.RangeResponse.SerializeToString)),
            "Put": u(self.put,
                     request_deserializer=pb.PutRequest.FromString,
                     response_serializer=pb.PutResponse.SerializeToString),
            "DeleteRange": u(
                self.delete_range,
                request_deserializer=pb.DeleteRangeRequest.FromString,
                response_serializer=(
                    pb.DeleteRangeResponse.SerializeToString)),
        }
        self._server = grpc.server(futures.ThreadPoolExecutor(8))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, rpcs),))
        self.port = self._server.add_insecure_port("127.0.0.1:0")
        self._server.start()
        return self

    def stop(self):
        if self._server is not None:
            self._server.stop(grace=None)
