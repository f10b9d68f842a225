"""S3-select-style JSON scan (reference weed/query/json/query_json.go —
experimental there, functional here): run projections + predicates over
JSON-lines data stored in the object store.

The port's copy of seaweedfs_tpu/query/json_query.py (host code only)."""

from __future__ import annotations

import json
import operator
from typing import Any, Callable, Iterator, Optional

_OPS = {
    "=": operator.eq, "==": operator.eq, "!=": operator.ne,
    ">": operator.gt, ">=": operator.ge, "<": operator.lt,
    "<=": operator.le,
}


def _get_path(doc: dict, path: str) -> Any:
    cur: Any = doc
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur


class Predicate:
    def __init__(self, path: str, op: str, value: Any):
        self.path = path
        self.op = _OPS[op]
        self.value = value

    def __call__(self, doc: dict) -> bool:
        got = _get_path(doc, self.path)
        if got is None:
            return False
        try:
            return self.op(got, self.value)
        except TypeError:
            return False


def query_json_lines(data: bytes | str,
                     select: Optional[list[str]] = None,
                     where: Optional[list[Predicate]] = None,
                     limit: Optional[int] = None) -> Iterator[dict]:
    """Scan JSONL content: keep docs matching every predicate, project the
    selected dotted paths ('*' or None keeps the whole doc)."""
    if isinstance(data, bytes):
        data = data.decode()
    out_count = 0
    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            continue
        if where and not all(p(doc) for p in where):
            continue
        if select and select != ["*"]:
            doc = {path: _get_path(doc, path) for path in select}
        yield doc
        out_count += 1
        if limit is not None and out_count >= limit:
            return


def parse_where(clause: str) -> list[Predicate]:
    """Parse 'a.b >= 3 AND name = "x"' into predicates."""
    preds = []
    for part in clause.split(" AND "):
        part = part.strip()
        if not part:
            continue
        for op in ("<=", ">=", "!=", "==", "=", "<", ">"):
            if op in part:
                path, _, raw = part.partition(op)
                raw = raw.strip()
                try:
                    value = json.loads(raw)
                except json.JSONDecodeError:
                    value = raw.strip('"\'')
                preds.append(Predicate(path.strip(), op, value))
                break
        else:
            raise ValueError(f"cannot parse predicate {part!r}")
    return preds
