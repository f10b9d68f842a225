"""Partial-column repair planning: who computes what, in which order.

The GF(256) decode matmul splits cleanly by column, so a shard holder
can apply its columns of the rebuild matrix to its local shard ranges
and ship the pre-reduced (n_rows, n) partial instead of the raw shards
(ops/rs_cpu.gf_partial_product). Folding partials is XOR — associative
and commutative — so the holders are arranged in a REDUCTION CHAIN:

    rebuilder -> hop0 -> hop1 -> ... -> hopN

Each hop recursively requests the accumulated column from the rest of
the chain (1 shard-width on its ingress), XORs in its own local
partials, and returns 1 shard-width upstream. The rebuilder therefore
receives ~1 shard-width per lost shard instead of the k full shards the
copy+rebuild choreography streams (regenerating-code bandwidth argument,
arXiv:1412.3022; recovery-traffic-at-scale motivation, arXiv:1309.0186).

Fallback ladder (each rung preserves bit-identical output):
  1. a hop's downstream peer fails mid-chain -> that hop raw-streams
     the remaining members' shard ranges itself and reduces locally
     (the extra width lands on the HOP, not the rebuilder);
  2. a chain request fails entirely at the rebuilder -> the rebuilder
     raw-streams and reduces locally (~k widths, still no staging
     copies on disk);
  3. the partial rebuild RPC fails wholesale (old peer, no route) ->
     the master's repair queue falls back to the legacy
     /admin/ec/copy + /admin/ec/rebuild choreography.
"""

from __future__ import annotations

from typing import Optional, Sequence

from seaweedfs_tpu_torch.utils import headers

PARTIAL_READ_PATH = "/admin/ec/partial_read"
REBUILD_PARTIAL_PATH = "/admin/ec/rebuild_partial"
SHARD_STAT_PATH = "/admin/ec/shard_stat"

# response headers the chain hops use to report downstream state
SHARDS_HEADER = headers.PARTIAL_SHARDS
FALLBACK_HEADER = headers.PARTIAL_FALLBACK


def plan_chain(sources: dict[int, Sequence[str]],
               coeff_by_sid: dict[int, Sequence[int]],
               health=None,
               exclude_urls: Sequence[str] = (),
               pressure: Optional[dict] = None) -> Optional[list[dict]]:
    """Group the remote shards of one reduction by holder and order the
    holders into a chain. Returns [{"url": u, "members": [[sid,
    [coeffs...]], ...]}, ...] or None when some shard has no usable
    holder (caller falls back to full streaming).

    Placement: each shard goes to one holder; holders already carrying
    another member are preferred (fewer hops = fewer serial RTTs), then
    breaker-ranked health with heartbeat-reported `pressure` ({url:
    qos_pressure}) breaking ties among similarly-healthy holders — a
    repair chain routed through a holder that is actively shedding
    client traffic makes the overload worse for no repair speedup.
    Hops are ordered most-members-first so the longest local compute
    overlaps the deepest downstream wait."""
    excluded = set(exclude_urls)
    members: dict[str, list] = {}
    for sid, coeffs in coeff_by_sid.items():
        urls = [u for u in (sources.get(sid) or []) if u not in excluded]
        if not urls:
            return None
        if health is not None:
            try:
                urls = health.rank(urls, pressure=pressure) \
                    if pressure else health.rank(urls)
            except Exception:
                pass
        elif pressure:
            urls = sorted(urls, key=lambda u: pressure.get(u, 0.0))
        chosen = next((u for u in urls if u in members), urls[0])
        members.setdefault(chosen, []).append(
            [int(sid), [int(c) for c in coeffs]])
    hops = [{"url": u, "members": sorted(m)}
            for u, m in members.items()]
    # most-members-first; among equal-width hops, the less-pressured
    # holder goes earlier (its reply unblocks the chain sooner)
    hops.sort(key=lambda h: (-len(h["members"]),
                             (pressure or {}).get(h["url"], 0.0)))
    return hops


def chain_shard_ids(chain: Sequence[dict]) -> list[int]:
    """Every shard id a chain is expected to fold, in plan order."""
    return [int(sid) for hop in chain for sid, _ in hop["members"]]
