"""Per-path storage rules (filer.conf).

Functional equivalent of reference weed/filer/filer_conf.go: the filer
keeps a rule table at /etc/seaweedfs/filer.conf *inside its own store*;
each rule binds a location prefix to storage options (collection,
replication, ttl, disk type, fsync, read-only). Writes under a prefix
inherit the longest matching rule unless the request overrides it.

The port's copy of seaweedfs_tpu/filer/filer_conf.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from seaweedfs_tpu_torch.filer.filerstore import FilerStore

FILER_CONF_KV_KEY = b"/etc/seaweedfs/filer.conf"


@dataclasses.dataclass
class PathConf:
    location_prefix: str = "/"
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    disk_type: str = ""
    fsync: bool = False
    read_only: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PathConf":
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


class FilerConf:
    def __init__(self, rules: Optional[list[PathConf]] = None):
        self.rules = rules or []

    def set_rule(self, rule: PathConf) -> None:
        self.rules = [r for r in self.rules
                      if r.location_prefix != rule.location_prefix]
        self.rules.append(rule)

    def delete_rule(self, location_prefix: str) -> None:
        self.rules = [r for r in self.rules
                      if r.location_prefix != location_prefix]

    def match_storage_rule(self, path: str) -> PathConf:
        """Longest-prefix match, merged over shorter matches (a deeper
        rule only overrides the fields it sets — reference
        filer_conf.go MatchStorageRule). location_prefix reports the
        deepest rule that matched ("/" when none did)."""
        merged = PathConf(location_prefix="/")
        for rule in sorted(self.rules,
                           key=lambda r: len(r.location_prefix)):
            if path.startswith(rule.location_prefix):
                merged.location_prefix = rule.location_prefix
                for field in ("collection", "replication", "ttl",
                              "disk_type"):
                    val = getattr(rule, field)
                    if val:
                        setattr(merged, field, val)
                if rule.fsync:
                    merged.fsync = True
                if rule.read_only:
                    merged.read_only = True
        return merged

    # ---- persistence in the filer's own store ----
    def to_json(self) -> str:
        return json.dumps({"locations": [r.to_dict() for r in self.rules]},
                          indent=2)

    @classmethod
    def from_json(cls, blob: str) -> "FilerConf":
        d = json.loads(blob or "{}")
        return cls([PathConf.from_dict(r) for r in d.get("locations", [])])

    def save(self, store: FilerStore) -> None:
        store.kv_put(FILER_CONF_KV_KEY, self.to_json().encode())

    @classmethod
    def load(cls, store: FilerStore) -> "FilerConf":
        blob = store.kv_get(FILER_CONF_KV_KEY)
        return cls.from_json(blob.decode()) if blob else cls()
