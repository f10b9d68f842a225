"""The port's query/json_query.py (the predicate engine behind the volume
server's Query RPC) held against the JAX package's: the same documents,
projections and predicates drawn from a numpy seed give the same rows.
(ref tests/test_ha_query_cache.py::test_json_query.)"""

import json

import numpy as np
import pytest

from seaweedfs_tpu.query import json_query as jq
from seaweedfs_tpu_torch.query import json_query as tq

DOCS = b"""
{"name": "a", "size": 10, "meta": {"type": "jpg"}}
{"name": "b", "size": 99, "meta": {"type": "png"}}
{"name": "c", "size": 5, "meta": {"type": "jpg"}}
not json
"""


def test_json_query():
    out = list(tq.query_json_lines(DOCS, select=["name"],
                                   where=tq.parse_where('meta.type = "jpg"')))
    assert out == [{"name": "a"}, {"name": "c"}]
    out = list(tq.query_json_lines(DOCS, where=tq.parse_where("size >= 10")))
    assert [d["name"] for d in out] == ["a", "b"]
    out = list(tq.query_json_lines(
        DOCS, where=tq.parse_where('size > 1 AND meta.type = "jpg"'),
        limit=1))
    assert len(out) == 1


def _seeded_docs(seed: int, n: int = 200) -> bytes:
    rng = np.random.default_rng(seed)
    kinds = ["jpg", "png", "gif", None]
    lines = []
    for i in range(n):
        doc = {"name": f"f{i:03d}", "size": int(rng.integers(0, 1000)),
               "score": float(np.round(rng.random() * 10, 3)),
               "tags": [int(t) for t in rng.integers(0, 5, 2)]}
        kind = kinds[int(rng.integers(0, len(kinds)))]
        if kind is not None:
            doc["meta"] = {"type": kind, "w": int(rng.integers(1, 64))}
        lines.append(json.dumps(doc))
        if rng.random() < 0.05:
            lines.append("{broken")
        if rng.random() < 0.05:
            lines.append("")
    return "\n".join(lines).encode()


CLAUSES = ['meta.type = "jpg"', "size >= 500", "size < 100 AND score > 5",
           'meta.type != "png"', "meta.w <= 8", "score == 3.5",
           "name = f010", 'tags = [1, 2]', "size > 100 AND size < 200 AND "
           'meta.type = "gif"']
SELECTS = [None, ["*"], ["name"], ["name", "meta.type"], ["missing.path"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_scans_match_jax(seed):
    data = _seeded_docs(seed)
    for clause in CLAUSES:
        for select in SELECTS:
            for limit in (None, 1, 7):
                got = list(tq.query_json_lines(
                    data, select, tq.parse_where(clause), limit))
                want = list(jq.query_json_lines(
                    data, select, jq.parse_where(clause), limit))
                assert got == want, (clause, select, limit)
    # str input and no predicate at all
    assert list(tq.query_json_lines(data.decode())) == \
        list(jq.query_json_lines(data.decode()))


def test_predicates_and_parse_errors_match_jax():
    docs = [{"a": {"b": 3}}, {"a": 1}, {"a": {"b": "x"}}, {}]
    for op in ("=", "==", "!=", ">", ">=", "<", "<="):
        tp, jp = tq.Predicate("a.b", op, 3), jq.Predicate("a.b", op, 3)
        assert [tp(d) for d in docs] == [jp(d) for d in docs], op
    for bad in ("no operator here", "a ~ 3"):
        with pytest.raises(ValueError):
            tq.parse_where(bad)
        with pytest.raises(ValueError):
            jq.parse_where(bad)
    with pytest.raises(KeyError):
        tq.Predicate("a", "~", 1)
