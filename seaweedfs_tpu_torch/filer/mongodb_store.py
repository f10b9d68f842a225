"""MongoDB-protocol FilerStore: filer metadata over the MongoDB wire
protocol (OP_MSG, opcode 2013) with a built-in BSON codec — no driver.

Redesign of reference weed/filer/mongodb/mongodb_store.go — there the
official mongo-driver with a `filemeta` collection
{directory, name, meta}; here the same document model is spoken
directly: update-with-upsert for writes, `find` with filter/sort/limit
for lookups and listings, `delete` for removals. A `kv` collection
keyed by _id (hex) carries the filer KV cells.

MiniMongoServer implements the command subset over in-memory dicts —
the test double AND an embedded dev backend; point MongoFilerStore at a
real mongod and the same bytes flow.

The port's copy of seaweedfs_tpu/filer/mongodb_store.py. It imports nothing
of that package.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any, Optional

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore

OP_MSG = 2013


# ------------------------------------------------------------------ BSON

def bson_encode(doc: dict) -> bytes:
    body = bytearray()
    for k, v in doc.items():
        body += _bson_element(k, v)
    return struct.pack("<i", len(body) + 5) + bytes(body) + b"\x00"


def _bson_element(key: str, v) -> bytes:
    kb = key.encode() + b"\x00"
    if isinstance(v, bool):  # before int: bool is an int subclass
        return b"\x08" + kb + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + kb + struct.pack("<i", v)
        return b"\x12" + kb + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + kb + struct.pack("<d", v)
    if isinstance(v, str):
        vb = v.encode()
        return b"\x02" + kb + struct.pack("<i", len(vb) + 1) + vb + b"\x00"
    if isinstance(v, bytes):
        return b"\x05" + kb + struct.pack("<i", len(v)) + b"\x00" + v
    if v is None:
        return b"\x0a" + kb
    if isinstance(v, dict):
        return b"\x03" + kb + bson_encode(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + kb + bson_encode(
            {str(i): x for i, x in enumerate(v)})
    raise TypeError(f"bson: unsupported type {type(v)}")


def bson_decode(data: bytes, pos: int = 0) -> tuple[dict, int]:
    total = struct.unpack_from("<i", data, pos)[0]
    end = pos + total - 1  # excluding trailing NUL
    pos += 4
    doc: dict = {}
    while pos < end:
        t = data[pos]
        pos += 1
        z = data.index(b"\x00", pos)
        key = data[pos:z].decode()
        pos = z + 1
        if t == 0x01:
            doc[key] = struct.unpack_from("<d", data, pos)[0]
            pos += 8
        elif t == 0x02:
            n = struct.unpack_from("<i", data, pos)[0]
            doc[key] = data[pos + 4:pos + 4 + n - 1].decode()
            pos += 4 + n
        elif t in (0x03, 0x04):
            sub, pos = bson_decode(data, pos)
            doc[key] = (list(sub.values()) if t == 0x04 else sub)
        elif t == 0x05:
            n = struct.unpack_from("<i", data, pos)[0]
            doc[key] = data[pos + 5:pos + 5 + n]
            pos += 5 + n
        elif t == 0x08:
            doc[key] = data[pos] == 1
            pos += 1
        elif t == 0x0a:
            doc[key] = None
        elif t == 0x10:
            doc[key] = struct.unpack_from("<i", data, pos)[0]
            pos += 4
        elif t == 0x12:
            doc[key] = struct.unpack_from("<q", data, pos)[0]
            pos += 8
        else:
            raise ValueError(f"bson: unsupported element type 0x{t:02x}")
    return doc, end + 1


# ---------------------------------------------------------------- client

class MongoError(RuntimeError):
    pass


class MongoClient:
    """Minimal OP_MSG client (section kind 0 only)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the connect timeout would otherwise persist as the I/O
        # timeout; make the per-op deadline explicit so an idle
        # keepalive connection isn't killed by the connect budget
        self.sock.settimeout(timeout)
        self._rfile = self.sock.makefile("rb")
        self._lock = threading.Lock()
        self._req = 0

    def command(self, db: str, cmd: dict) -> dict:
        body = bson_encode({**cmd, "$db": db})
        with self._lock:
            self._req += 1
            msg = (struct.pack("<iiii", 16 + 4 + 1 + len(body),
                               self._req, 0, OP_MSG)
                   + struct.pack("<I", 0) + b"\x00" + body)
            self.sock.sendall(msg)
            hdr = self._rfile.read(16)
            if len(hdr) < 16:
                raise ConnectionError("mongo connection closed")
            total, _, _, opcode = struct.unpack("<iiii", hdr)
            payload = self._rfile.read(total - 16)
        if opcode != OP_MSG:
            raise MongoError(f"unexpected reply opcode {opcode}")
        # flags(4) + kind byte; kind-1 sections never sent by servers
        reply, _ = bson_decode(payload, 5)
        if not reply.get("ok"):
            raise MongoError(str(reply.get("errmsg", reply)))
        return reply

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ----------------------------------------------------------------- store

class MongoFilerStore(FilerStore):
    name = "mongodb"

    COLL = "filemeta"

    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 database: str = "seaweedfs"):
        self.client = MongoClient(host, port)
        self.db = database

    @staticmethod
    def _split(full_path: str) -> tuple[str, str]:
        full_path = full_path.rstrip("/") or "/"
        if full_path == "/":
            return "", "/"
        d, _, n = full_path.rpartition("/")
        return d or "/", n

    def insert_entry(self, entry: Entry) -> None:
        import json
        d, n = self._split(entry.full_path)
        self.client.command(self.db, {
            "update": self.COLL,
            "updates": [{"q": {"directory": d, "name": n},
                         "u": {"$set": {
                             "meta": json.dumps(entry.to_dict())}},
                         "upsert": True}]})

    update_entry = insert_entry

    def _find(self, filter_doc: dict, limit: int = 1) -> list[dict]:
        reply = self.client.command(self.db, {
            "find": self.COLL, "filter": filter_doc,
            "sort": {"name": 1}, "limit": limit, "batchSize": limit})
        return reply["cursor"]["firstBatch"]

    def find_entry(self, full_path: str) -> Optional[Entry]:
        import json
        d, n = self._split(full_path)
        docs = self._find({"directory": d, "name": n})
        if not docs:
            return None
        return Entry.from_dict(json.loads(docs[0]["meta"]))

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        self.client.command(self.db, {
            "delete": self.COLL,
            "deletes": [{"q": {"directory": d, "name": n}, "limit": 0}]})

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/")
        self.client.command(self.db, {
            "delete": self.COLL,
            "deletes": [
                {"q": {"directory": base or "/"}, "limit": 0},
                # all deeper descendants: dir in [base+"/", base+"0")
                # ("0" is "/"+1 bytewise)
                {"q": {"directory": {"$gte": base + "/",
                                     "$lt": base + "0"}}, "limit": 0}]})

    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        import json
        d = dir_path.rstrip("/") or "/"
        name_cond: dict[str, Any] = {}
        if start_name:
            name_cond["$gte" if include_start else "$gt"] = start_name
        if prefix and name_cond.get("$gte", "") < prefix:
            # every prefixed name sorts >= the prefix itself; $gt and
            # $gte may coexist (both conditions apply)
            name_cond["$gte"] = prefix
        filter_doc: dict[str, Any] = {"directory": d}
        if name_cond:
            filter_doc["name"] = name_cond
        out = []
        # no upper bound in the filter: names sharing the prefix are a
        # contiguous range in sorted order, so the first non-matching
        # name ends it (an explicit prefix+"￿" bound would wrongly
        # exclude names continuing with non-BMP code points)
        for doc in self._find(filter_doc, limit=limit):
            name = doc["name"]
            if prefix and not name.startswith(prefix):
                if name >= prefix:
                    break
                continue
            out.append(Entry.from_dict(json.loads(doc["meta"])))
        return out

    # ---- kv (collection keyed by _id) ----
    def kv_put(self, key: bytes, value: bytes) -> None:
        self.client.command(self.db, {
            "update": "kv",
            "updates": [{"q": {"_id": key.hex()},
                         "u": {"$set": {"v": value.hex()}},
                         "upsert": True}]})

    def kv_get(self, key: bytes) -> Optional[bytes]:
        reply = self.client.command(self.db, {
            "find": "kv", "filter": {"_id": key.hex()},
            "limit": 1, "batchSize": 1})
        docs = reply["cursor"]["firstBatch"]
        return bytes.fromhex(docs[0]["v"]) if docs else None

    def kv_delete(self, key: bytes) -> None:
        self.client.command(self.db, {
            "delete": "kv",
            "deletes": [{"q": {"_id": key.hex()}, "limit": 0}]})

    def close(self) -> None:
        self.client.close()


# ------------------------------------------------------------ dev server

class MiniMongoServer:
    """In-process OP_MSG server implementing the command subset the
    store uses: insert/update(upsert)/find(filter+sort+limit)/delete,
    plus ping/hello. Filters support equality and $gt/$gte/$lt/$lte
    on string fields. One thread per connection; dict storage."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        # {(db, coll): list[doc]}
        self._colls: dict[tuple[str, str], list[dict]] = {}
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="mongodb-accept")

    def start(self) -> "MiniMongoServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="mongodb-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        f = conn.makefile("rb")
        try:
            while not self._stop.is_set():
                hdr = f.read(16)
                if len(hdr) < 16:
                    return
                total, req, _, opcode = struct.unpack("<iiii", hdr)
                payload = f.read(total - 16)
                if opcode != OP_MSG:
                    return
                cmd, _ = bson_decode(payload, 5)
                try:
                    reply = self._execute(cmd)
                except Exception as e:
                    reply = {"ok": 0, "errmsg": str(e)}
                body = bson_encode(reply)
                conn.sendall(struct.pack("<iiii", 21 + len(body), req,
                                         req, OP_MSG)
                             + struct.pack("<I", 0) + b"\x00" + body)
        except (OSError, ValueError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # ---- command execution ----
    def _execute(self, cmd: dict) -> dict:
        db = cmd.get("$db", "test")
        op = next(iter(cmd))
        if op in ("ping", "hello", "isMaster", "ismaster"):
            return {"ok": 1, "maxWireVersion": 17, "minWireVersion": 0}
        coll = (db, cmd[op]) if isinstance(cmd[op], str) else (db, "")
        if op == "insert":
            with self._lock:
                docs = self._colls.setdefault(coll, [])
                docs.extend(cmd.get("documents", []))
            return {"ok": 1, "n": len(cmd.get("documents", []))}
        if op == "update":
            n = 0
            with self._lock:
                docs = self._colls.setdefault(coll, [])
                for u in cmd.get("updates", []):
                    matched = [d for d in docs
                               if self._matches(d, u.get("q", {}))]
                    if matched:
                        for d in matched:
                            for k, v in u.get("u", {}).get(
                                    "$set", {}).items():
                                d[k] = v
                            n += 1
                    elif u.get("upsert"):
                        new = dict(u.get("q", {}))
                        new = {k: v for k, v in new.items()
                               if not isinstance(v, dict)}
                        new.update(u.get("u", {}).get("$set", {}))
                        docs.append(new)
                        n += 1
            return {"ok": 1, "n": n}
        if op == "delete":
            n = 0
            with self._lock:
                docs = self._colls.setdefault(coll, [])
                for spec in cmd.get("deletes", []):
                    q = spec.get("q", {})
                    keep = [d for d in docs if not self._matches(d, q)]
                    n += len(docs) - len(keep)
                    docs[:] = keep
            return {"ok": 1, "n": n}
        if op == "find":
            with self._lock:
                docs = [dict(d) for d in self._colls.get(coll, [])
                        if self._matches(d, cmd.get("filter", {}))]
            for key, direction in reversed(
                    list(cmd.get("sort", {}).items())):
                docs.sort(key=lambda d: d.get(key),
                          reverse=direction < 0)
            limit = cmd.get("limit", 0)
            if limit:
                docs = docs[:limit]
            return {"ok": 1, "cursor": {"id": 0,
                                        "ns": f"{db}.{coll[1]}",
                                        "firstBatch": docs}}
        raise ValueError(f"unsupported command {op!r}")

    @staticmethod
    def _matches(doc: dict, q: dict) -> bool:
        for k, cond in q.items():
            have = doc.get(k)
            if isinstance(cond, dict):
                for o, rv in cond.items():
                    if have is None:
                        return False
                    if o == "$gt" and not have > rv:
                        return False
                    if o == "$gte" and not have >= rv:
                        return False
                    if o == "$lt" and not have < rv:
                        return False
                    if o == "$lte" and not have <= rv:
                        return False
                    if o not in ("$gt", "$gte", "$lt", "$lte"):
                        raise ValueError(f"unsupported operator {o}")
            elif have != cond:
                return False
        return True
