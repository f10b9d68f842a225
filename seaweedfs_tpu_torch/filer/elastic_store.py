"""Elasticsearch FilerStore: filer metadata over the ES REST/JSON API.

Redesign of reference weed/filer/elastic/v7/elastic_store.go — there
the olivere/elastic client with an index of entries keyed by the
url-encoded path; here the same REST surface spoken through the
repo's pooled HTTP client: _doc PUT/GET/DELETE for point ops,
_search with term/range/sort for listings, _delete_by_query with a
directory prefix for recursive deletes, refresh=true on mutations so
reads are immediately consistent (the reference sets Refresh the same
way — a filer cannot serve stale listings).

Doc model:
  filer_entries/_doc/<quote(path)> = {directory, name, meta-json}
  filer_kv/_doc/<hex(key)>         = {v: hex(value)}

MiniElasticServer implements the endpoint subset over in-memory dicts
— the test double AND an embedded dev backend; point ElasticFilerStore
at a real Elasticsearch/OpenSearch and the same requests flow.

The port's copy of seaweedfs_tpu/filer/elastic_store.py. It imports nothing
of that package.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore
from seaweedfs_tpu_torch.utils.httpd import (HttpError, HttpServer, Request,
                                       Response, http_call)

ENTRY_INDEX = "filer_entries"
KV_INDEX = "filer_kv"


class ElasticFilerStore(FilerStore):
    name = "elastic"

    # one _search page (real ES caps result windows at 10k; listings
    # larger than a page continue via search_after)
    PAGE = 1000

    def __init__(self, host: str = "127.0.0.1", port: int = 9200):
        self.base = f"http://{host}:{port}"
        # explicit keyword mappings: dynamic mapping would analyze
        # directory/name as text, breaking term/prefix queries and
        # sorts on a real Elasticsearch
        for index, props in (
                # meta/v also disable doc_values: Lucene caps
                # doc_values terms at 32KB and chunky entry meta (or
                # hex-doubled kv blobs) legitimately exceeds that
                (ENTRY_INDEX, {"directory": {"type": "keyword"},
                               "name": {"type": "keyword"},
                               "meta": {"type": "keyword",
                                        "index": False,
                                        "doc_values": False}}),
                (KV_INDEX, {"v": {"type": "keyword", "index": False,
                                  "doc_values": False}})):
            try:
                self._call("PUT", f"/{index}",
                           {"mappings": {"properties": props}})
            except HttpError as e:
                if b"resource_already_exists" not in e.body:
                    raise

    # ---- REST helpers ----
    def _call(self, method: str, path: str, body: Optional[dict] = None,
              ok_missing: bool = False) -> Optional[dict]:
        status, data, _ = http_call(
            method, self.base + path,
            body=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        if status == 404 and ok_missing:
            return None
        if status >= 400:
            raise HttpError(status, data)
        return json.loads(data) if data else None

    @staticmethod
    def _split(full_path: str) -> tuple[str, str]:
        full_path = full_path.rstrip("/") or "/"
        if full_path == "/":
            return "", "/"
        d, _, n = full_path.rpartition("/")
        return d or "/", n

    @staticmethod
    def _doc_id(full_path: str) -> str:
        # url-quote like the reference store: near 1:1 for ASCII, so
        # paths stay inside ES's 512-byte _id limit (hex would halve
        # the maximum path length). Normalized here so insert/find/
        # delete agree on trailing slashes.
        import urllib.parse
        return urllib.parse.quote(full_path.rstrip("/") or "/", safe="")

    # ---- entry ops ----
    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        self._call(
            "PUT",
            f"/{ENTRY_INDEX}/_doc/{self._doc_id(entry.full_path)}"
            "?refresh=true",
            {"directory": d, "name": n,
             "meta": json.dumps(entry.to_dict())})

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Optional[Entry]:
        full_path = full_path.rstrip("/") or "/"
        out = self._call(
            "GET", f"/{ENTRY_INDEX}/_doc/{self._doc_id(full_path)}",
            ok_missing=True)
        if out is None or not out.get("found"):
            return None
        return Entry.from_dict(json.loads(out["_source"]["meta"]))

    def delete_entry(self, full_path: str) -> None:
        full_path = full_path.rstrip("/") or "/"
        self._call(
            "DELETE",
            f"/{ENTRY_INDEX}/_doc/{self._doc_id(full_path)}"
            "?refresh=true", ok_missing=True)

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/")
        self._call(
            "POST", f"/{ENTRY_INDEX}/_delete_by_query?refresh=true",
            {"query": {"bool": {"should": [
                {"term": {"directory": base or "/"}},
                {"prefix": {"directory": (base or "") + "/"}},
            ]}}})

    def list_directory_entries(self, dir_path: str, start_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        # lower bound = the stricter of the start cursor and the prefix
        # (every prefixed name sorts >= the prefix itself)
        lo, incl = "", True
        if start_name:
            lo, incl = start_name, include_start
        if prefix and prefix > lo:
            lo, incl = prefix, True
        entries: list[Entry] = []
        while len(entries) < limit:
            must: list[dict] = [{"term": {"directory": d}}]
            if lo:
                must.append({"range": {
                    "name": {"gte" if incl else "gt": lo}}})
            page = min(limit - len(entries), self.PAGE)
            out = self._call(
                "POST", f"/{ENTRY_INDEX}/_search",
                {"query": {"bool": {"must": must}},
                 "sort": [{"name": "asc"}], "size": page})
            hits = out["hits"]["hits"]
            for hit in hits:
                name = hit["_source"]["name"]
                if prefix and not name.startswith(prefix):
                    # sorted + lower-bounded at prefix: past the range
                    return entries
                entries.append(Entry.from_dict(
                    json.loads(hit["_source"]["meta"])))
                if len(entries) >= limit:
                    return entries
            if len(hits) < page:
                break  # drained
            lo, incl = hits[-1]["_source"]["name"], False
        return entries

    # ---- kv ----
    def kv_put(self, key: bytes, value: bytes) -> None:
        self._call("PUT",
                   f"/{KV_INDEX}/_doc/{key.hex()}?refresh=true",
                   {"v": value.hex()})

    def kv_get(self, key: bytes) -> Optional[bytes]:
        out = self._call("GET", f"/{KV_INDEX}/_doc/{key.hex()}",
                         ok_missing=True)
        if out is None or not out.get("found"):
            return None
        return bytes.fromhex(out["_source"]["v"])

    def kv_delete(self, key: bytes) -> None:
        self._call("DELETE", f"/{KV_INDEX}/_doc/{key.hex()}"
                   "?refresh=true", ok_missing=True)


# ------------------------------------------------------------ dev server

class MiniElasticServer:
    """In-process server for the REST subset the store uses: _doc
    PUT/GET/DELETE, _search (bool term/range/prefix + sort + size),
    _delete_by_query. Keyword (exact, bytewise-ordered) semantics."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        # {index: {doc_id: source_dict}}
        self._indices: dict[str, dict[str, dict]] = {}
        self._created: set[str] = set()
        self._lock = threading.Lock()
        self.http = HttpServer(host, port)
        r = self.http.add
        # the HTTP layer percent-decodes paths before routing (like a
        # real ES does for _id), so a quoted id may contain slashes —
        # match the id greedily and use the decoded form as the key
        r("PUT", r"/([a-z_]+)", self._create_index)
        r("PUT", r"/([a-z_]+)/_doc/(.+)", self._put_doc)
        r("GET", r"/([a-z_]+)/_doc/(.+)", self._get_doc)
        r("DELETE", r"/([a-z_]+)/_doc/(.+)", self._delete_doc)
        r("POST", r"/([a-z_]+)/_search", self._search)
        r("POST", r"/([a-z_]+)/_delete_by_query", self._delete_by_query)

    def start(self) -> "MiniElasticServer":
        self.http.start()
        self.host, self.port = self.http.host, self.http.port
        return self

    def stop(self) -> None:
        self.http.stop()

    # ---- handlers ----
    def _create_index(self, req: Request) -> Response:
        index = req.match.group(1)
        with self._lock:
            if index in self._created:
                return Response(
                    {"error": {"type": "resource_already_exists_"
                               "exception"}}, status=400)
            self._created.add(index)
        return Response({"acknowledged": True})

    def _put_doc(self, req: Request) -> Response:
        index, doc_id = req.match.group(1), req.match.group(2)
        with self._lock:
            docs = self._indices.setdefault(index, {})
            created = doc_id not in docs
            docs[doc_id] = req.json()
        return Response({"_id": doc_id,
                         "result": "created" if created else "updated"},
                        status=201 if created else 200)

    def _get_doc(self, req: Request) -> Response:
        index, doc_id = req.match.group(1), req.match.group(2)
        with self._lock:
            doc = self._indices.get(index, {}).get(doc_id)
        if doc is None:
            return Response({"_id": doc_id, "found": False}, status=404)
        return Response({"_id": doc_id, "found": True, "_source": doc})

    def _delete_doc(self, req: Request) -> Response:
        index, doc_id = req.match.group(1), req.match.group(2)
        with self._lock:
            existed = self._indices.get(index, {}).pop(doc_id, None)
        if existed is None:
            return Response({"result": "not_found"}, status=404)
        return Response({"result": "deleted"})

    @staticmethod
    def _matches(doc: dict, query: dict) -> bool:
        b = query.get("bool", {})
        for clause in b.get("must", []):
            if not MiniElasticServer._clause(doc, clause):
                return False
        should = b.get("should", [])
        if should and not any(MiniElasticServer._clause(doc, c)
                              for c in should):
            return False
        if not b and query:  # bare term/range/prefix query
            return MiniElasticServer._clause(doc, query)
        return True

    @staticmethod
    def _clause(doc: dict, clause: dict) -> bool:
        if "term" in clause:
            ((field, want),) = clause["term"].items()
            return doc.get(field) == want
        if "prefix" in clause:
            ((field, pre),) = clause["prefix"].items()
            return str(doc.get(field, "")).startswith(pre)
        if "range" in clause:
            ((field, conds),) = clause["range"].items()
            have = doc.get(field)
            if have is None:
                return False
            for op, rv in conds.items():
                if op == "gt" and not have > rv:
                    return False
                if op == "gte" and not have >= rv:
                    return False
                if op == "lt" and not have < rv:
                    return False
                if op == "lte" and not have <= rv:
                    return False
            return True
        raise ValueError(f"unsupported clause {clause}")

    def _search(self, req: Request) -> Response:
        index = req.match.group(1)
        body = req.json() or {}
        query = body.get("query", {})
        with self._lock:
            docs = [dict(d) for d in self._indices.get(index, {}).values()
                    if self._matches(d, query)]
        for spec in reversed(body.get("sort", [])):
            ((field, order),) = spec.items()
            if isinstance(order, dict):
                order = order.get("order", "asc")
            docs.sort(key=lambda d: d.get(field),
                      reverse=order == "desc")
        size = body.get("size", 10)
        docs = docs[:size]
        return Response({"hits": {
            "total": {"value": len(docs)},
            "hits": [{"_source": d} for d in docs]}})

    def _delete_by_query(self, req: Request) -> Response:
        index = req.match.group(1)
        query = (req.json() or {}).get("query", {})
        with self._lock:
            docs = self._indices.get(index, {})
            doomed = [i for i, d in docs.items()
                      if self._matches(d, query)]
            for i in doomed:
                del docs[i]
        return Response({"deleted": len(doomed)})
