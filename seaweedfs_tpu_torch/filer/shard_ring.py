"""Consistent-hash ring over filer peers: directory -> owning shard.

The filer namespace shards by DIRECTORY, not by file: every child of a
directory D (files and the subdirectory rows whose parent is D) lives
on ``owner(D)``, so listing a directory is always a single-shard
operation and the namespace's lexicographic listing contract survives
sharding.  An entry at path p therefore lives on ``owner(dirname(p))``
— the shard you ask for p is the shard that can also enumerate p's
siblings.

The ring is epoch-stamped: the master bumps the epoch whenever the
live filer set changes (see master `/cluster/filers`), and every
shard-aware response/redirect carries ``X-Weed-Shard: <epoch>:<owner>``
so a client holding a stale ring detects drift and re-pulls instead of
chasing redirects forever.  Membership hashes onto the ring through
VNODES virtual points per filer (classic consistent hashing: adding a
shard moves ~1/N of the directory space, not a full reshuffle).

The port's copy of seaweedfs_tpu/filer/shard_ring.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Optional

# virtual points per member: enough to keep the directory-space split
# within a few percent of even at 3-16 shards, cheap to build
VNODES = 64


def _point(s: str) -> int:
    """Stable 64-bit ring position (md5 — NOT Python hash(), which is
    per-process salted and would give every process its own ring)."""
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


def _norm_dir(p: str) -> str:
    p = "/" + (p or "").strip("/")
    return p if p != "//" else "/"


def parent_dir(path: str) -> str:
    """The directory whose listing contains `path` ("/" is its own
    parent — the root row exists on every shard)."""
    path = _norm_dir(path)
    if path == "/":
        return "/"
    return path.rsplit("/", 1)[0] or "/"


def format_shard_header(epoch: int, owner: str) -> str:
    return f"{epoch}:{owner}"


def parse_shard_header(value: str) -> tuple[int, str]:
    """-> (epoch, owner_url); epoch 0 on garbage (treated as stale).
    Negative epochs clamp to 0 too — epochs are forward-only, so a
    negative value is garbage with a sign bit, and letting it through
    would poison every `held >= seen` comparison downstream."""
    try:
        epoch_s, _, owner = value.partition(":")
        return max(0, int(epoch_s)), owner
    except (ValueError, AttributeError):
        return 0, ""


class ShardRing:
    def __init__(self, members: list[str], epoch: int = 1,
                 vnodes: int = VNODES,
                 overrides: Optional[dict] = None):
        self.members: list[str] = sorted(set(members))
        self.epoch = int(epoch)
        self.vnodes = vnodes
        # rebalancer override table layered over the hash ring: an
        # exact-directory entry {dir: owner} wins over the consistent
        # hash (filer/rebalance.py emits these; the master bumps the
        # epoch per applied plan).  Overrides naming a departed member
        # are dropped — routing to a dead shard is worse than routing
        # to the hash owner.
        self.overrides: dict = {
            _norm_dir(d): o for d, o in (overrides or {}).items()
            if o in self.members}
        pts = sorted((_point(f"{m}#{i}"), m)
                     for m in self.members for i in range(vnodes))
        self._keys = [p[0] for p in pts]
        self._owners = [p[1] for p in pts]

    def owner(self, directory: str) -> str:
        """The shard that owns directory `directory` (holds its child
        rows and serves its listings). "" when the ring is empty."""
        if not self._keys:
            return ""
        d = _norm_dir(directory)
        if self.overrides:
            o = self.overrides.get(d)
            if o is not None:
                return o
        if len(self.members) == 1:
            return self.members[0]
        i = bisect.bisect(self._keys, _point(d))
        if i == len(self._keys):
            i = 0
        return self._owners[i]

    def hash_owner(self, directory: str) -> str:
        """The consistent-hash owner, ignoring the override table —
        what `owner()` falls back to when an override is retired."""
        if not self._keys:
            return ""
        if len(self.members) == 1:
            return self.members[0]
        i = bisect.bisect(self._keys, _point(_norm_dir(directory)))
        if i == len(self._keys):
            i = 0
        return self._owners[i]

    def with_overrides(self, overrides: dict) -> "ShardRing":
        """A new ring at epoch+1 with `overrides` merged over the
        current table (None values retire entries).  Same members —
        this is the rebalancer's epoch bump, not a membership change."""
        merged = dict(self.overrides)
        for d, o in overrides.items():
            d = _norm_dir(d)
            if o is None:
                merged.pop(d, None)
            else:
                merged[d] = o
        return ShardRing(self.members, epoch=self.epoch + 1,
                         vnodes=self.vnodes, overrides=merged)

    def owner_for_path(self, path: str) -> str:
        """The shard holding the entry ROW at `path` = the owner of
        its parent directory."""
        return self.owner(parent_dir(path))

    def __len__(self) -> int:
        return len(self.members)

    def __contains__(self, url: str) -> bool:
        return url in self.members

    def to_dict(self) -> dict:
        out = {"epoch": self.epoch, "filers": list(self.members),
               "vnodes": self.vnodes}
        if self.overrides:
            out["overrides"] = dict(self.overrides)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "ShardRing":
        return cls(d.get("filers", []), epoch=d.get("epoch", 1),
                   vnodes=d.get("vnodes", VNODES),
                   overrides=d.get("overrides"))

    def spread(self, directories: list[str]) -> dict:
        """member -> owned count over a directory sample (shard_profile
        uses this to show balance)."""
        out = {m: 0 for m in self.members}
        for d in directories:
            o = self.owner(d)
            if o:
                out[o] += 1
        return out


def ring_if_changed(ring: Optional[ShardRing],
                    members: list[str]) -> Optional[ShardRing]:
    """A new ring at epoch+1 when `members` differs from `ring`'s,
    else None — the master's epoch-bump helper.  Overrides survive a
    membership change (the rebalanced placement outlives a restart of
    an unrelated shard); entries pointing at a departed member are
    dropped by the ShardRing constructor."""
    new = sorted(set(members))
    if ring is not None and ring.members == new:
        return None
    return ShardRing(new, epoch=(ring.epoch + 1 if ring else 1),
                     overrides=(ring.overrides if ring else None))
