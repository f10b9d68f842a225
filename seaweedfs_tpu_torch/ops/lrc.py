"""Locally-repairable code LRC(k, l, g) on the rs_cpu GF(2^8) substrate.

Pyramid-style construction (Huang et al., "Pyramid Codes"; the Facebook
warehouse study arXiv:1309.0186 measures why): take the systematic
RS(k, k+g+1) generator, split its first parity row into `l` group-local
rows (coefficients zeroed outside the group), keep the remaining `g`
rows as global parities. Basic pyramid codes are *maximally
recoverable*: an erasure pattern decodes iff it is information-
theoretically decodable for the (k, l, g) topology — one erasure per
local group absorbed by that group's parity plus up to g more anywhere
(tests/test_torch_lrc.py holds every <=4-erasure pattern against the
reference package's LrcCoder).

Shard id layout matches RS(10,4)'s so every byte of plumbing (.ec00-
.ec13 files, ecx indexes, layout constants) carries over: [0..k) data,
[k..k+l) local parities, [k+l..k+l+g) globals — 14 shards total for the
default LRC(10,2,2).

What the family buys: a single lost shard inside a group rebuilds from
the 5 surviving group members instead of k=10 columns — half the bytes
read per rebuilt MB — and degraded reads prefer the same 5-shard set
(arXiv:2306.10528). plan_rebuild() returns the cheapest (sources,
matrix) pair per failure pattern; its matrices are ordinary GF(256)
matmuls, so encode/rebuild ride the same _gf_apply kernels as
Reed-Solomon on the host, and K1's batch entry on the card through
BatchCoder's LRC facade (parallel/batcher.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from seaweedfs_tpu_torch.models.coder import LrcScheme, register_coder
from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.ops.rs_cpu import CpuCoder, auto_workers

DEFAULT_LRC_SCHEME = LrcScheme(10, 2, 2)


def generator_matrix(spec: LrcScheme) -> np.ndarray:
    """(total, k) uint8 generator: identity over data rows, then l local
    rows (the first RS parity row masked to each group), then g globals."""
    k = spec.data_shards
    base = np.asarray(gf256.rs_matrix(k, k + spec.global_parities + 1))
    split_row = base[k]
    rows = [np.eye(k, dtype=np.uint8)]
    gs = spec.group_size
    for g in range(spec.local_groups):
        local = np.zeros(k, dtype=np.uint8)
        local[g * gs:(g + 1) * gs] = split_row[g * gs:(g + 1) * gs]
        rows.append(local[None, :])
    rows.append(base[k + 1:k + 1 + spec.global_parities])
    return np.ascontiguousarray(np.vstack(rows), dtype=np.uint8)


def _gf_rref_pick(rows: np.ndarray, order: Sequence[int]) -> list[int]:
    """Greedy row selection: walk `order`, keep each row that raises the
    GF(256) rank, stop at full rank. Returns the kept indices (into the
    original row set) or all kept rows if rank stays short."""
    k = rows.shape[1]
    basis = np.zeros((0, k), dtype=np.uint8)
    pivots: list[int] = []
    kept: list[int] = []
    for idx in order:
        r = rows[idx].astype(np.uint8).copy()
        for b, p in zip(basis, pivots):
            if r[p]:
                r ^= gf256.MUL_TABLE[int(r[p])][b]
        nz = np.flatnonzero(r)
        if nz.size == 0:
            continue
        p = int(nz[0])
        r = gf256.MUL_TABLE[gf256.gf_inv(int(r[p]))][r]
        basis = np.vstack([basis, r[None, :]]) if basis.size else r[None, :]
        pivots.append(p)
        kept.append(idx)
        if len(kept) == k:
            break
    return kept


@register_coder("lrc")
class LrcCoder(CpuCoder):
    """LRC coder with the CpuCoder surface (encode/encode_array/
    encode_into/reconstruct/rebuild_matrix/reconstruct_rows/_parity/
    _apply) so every RS consumer — scrubber, partial-column chain,
    EcBatchScheduler, streaming encoder — works unchanged, plus
    plan_rebuild()/repair_strategy() for cheapest-repair planning."""

    def __init__(self, scheme: Optional[LrcScheme] = None,
                 use_native: bool = True, workers: int | str = 1):
        if scheme is None or not isinstance(scheme, LrcScheme):
            scheme = DEFAULT_LRC_SCHEME
        # skip CpuCoder.__init__'s RS parity_matrix: build the LRC one
        super(CpuCoder, self).__init__(scheme)
        self.use_native = use_native
        self.workers = auto_workers() if workers == "auto" else max(1, workers)
        self._gen = generator_matrix(scheme)
        self._parity = np.ascontiguousarray(
            self._gen[scheme.data_shards:])

    # ---- decode machinery (generator-matrix based, not Vandermonde) ----

    def _source_order(self, present: Sequence[int],
                      prefer_groups: Sequence[int] = ()) -> list[int]:
        """Row-selection preference: shards of the groups we are repairing
        first (data before local parity), then remaining data, remaining
        local parities, globals last — so single-group failures resolve
        group-locally and the zero-column filter strips the rest."""
        spec: LrcScheme = self.scheme
        prefer = set()
        for g in prefer_groups:
            prefer.update(spec.group_members(g))

        def key(sid: int) -> tuple:
            in_group = 0 if sid in prefer else 1
            if sid < spec.data_shards:
                tier = 0
            elif sid < spec.data_shards + spec.local_groups:
                tier = 1
            else:
                tier = 2
            return (in_group, tier, sid)

        return sorted(present, key=key)

    def _decode_rows(self, present: Sequence[int],
                     missing: Sequence[int],
                     prefer_groups: Sequence[int] = ()
                     ) -> tuple[list[int], np.ndarray]:
        """(src_sids, mat): mat rows express each `missing` shard as a
        GF(256) combination of the chosen source shards. Raises
        ValueError when the pattern is not recoverable (present rows of
        the generator do not span the data space)."""
        spec: LrcScheme = self.scheme
        k = spec.data_shards
        order = self._source_order(present, prefer_groups)
        kept = _gf_rref_pick(self._gen[order], list(range(len(order))))
        if len(kept) < k:
            raise ValueError(
                f"unrecoverable erasure pattern: missing={sorted(missing)} "
                f"(present rows span only {len(kept)}/{k} dims)")
        src = [order[i] for i in kept]
        gsub = np.ascontiguousarray(self._gen[src])
        dec = np.asarray(gf256.gf_mat_invert(gsub))  # data = dec @ src rows
        rows = []
        for sid in missing:
            rows.append(np.asarray(
                gf256.gf_matmul(self._gen[sid][None, :], dec))[0])
        return src, np.stack(rows).astype(np.uint8)

    def plan_rebuild(self, present: Sequence[int],
                     missing: Sequence[int]
                     ) -> tuple[list[int], np.ndarray]:
        """Cheapest repair plan: (src_sids, mat) with all-zero source
        columns already dropped, so len(src_sids) IS the read cost. A
        single shard lost inside a group plans to its 5 surviving group
        members; anything wider falls back to a global decode."""
        spec: LrcScheme = self.scheme
        present = sorted(set(present) - set(missing))
        missing = sorted(missing)
        groups = sorted({g for g in (spec.group_of(s) for s in missing)
                         if g is not None})
        src, mat = self._decode_rows(present, missing, prefer_groups=groups)
        used = [j for j in range(len(src)) if mat[:, j].any()]
        if not used:  # all-zero shards still need one source row to size by
            used = [0]
        return [src[j] for j in used], np.ascontiguousarray(mat[:, used])

    def repair_strategy(self, present: Sequence[int],
                        missing: Sequence[int]) -> dict:
        """Classify the cheapest repair: 'local' when every source the
        plan reads sits inside the damaged shards' own local groups,
        'global' otherwise. Returns the plan alongside for callers."""
        spec: LrcScheme = self.scheme
        src, mat = self.plan_rebuild(present, missing)
        groups = {g for g in (spec.group_of(s) for s in missing)
                  if g is not None}
        members = set()
        for g in groups:
            members.update(spec.group_members(g))
        local = bool(groups) and set(src) <= members
        return {"strategy": "local" if local else "global",
                "sources": src, "mat": mat,
                "reads": len(src), "groups": sorted(groups)}

    def rebuild_matrix(self, present: Sequence[int],
                       missing: Sequence[int]) -> np.ndarray:
        """CpuCoder contract: coefficient rows over the FIRST k of
        sorted(present). For LRC that subset can be rank-deficient even
        when the pattern is recoverable — callers that can honor
        arbitrary sources should use plan_rebuild() instead (the volume
        server's partial rebuild does)."""
        k = self.scheme.data_shards
        present = sorted(set(present) - set(missing))
        src = present[:k]
        gsub = np.ascontiguousarray(self._gen[src])
        dec = np.asarray(gf256.gf_mat_invert(gsub))
        rows = [np.asarray(gf256.gf_matmul(
            self._gen[sid][None, :], dec))[0] for sid in missing]
        return np.stack(rows).astype(np.uint8)

    def reconstruct(self, shards: Sequence[Optional[bytes]]) -> list[bytes]:
        spec: LrcScheme = self.scheme
        total = spec.total_shards
        assert len(shards) == total
        present = [i for i in range(total) if shards[i] is not None]
        missing = [i for i in range(total) if shards[i] is None]
        if not missing:
            return [bytes(s) for s in shards]
        src, mat = self.plan_rebuild(present, missing)
        srcdata = np.stack([np.frombuffer(shards[i], dtype=np.uint8)
                            for i in src])
        rec = self._apply(mat, srcdata)
        out = [bytes(s) if s is not None else None for s in shards]
        for r, i in enumerate(missing):
            out[i] = rec[r].tobytes()
        return out

    def reconstruct_data(self, shards: Sequence[Optional[bytes]]
                         ) -> list[Optional[bytes]]:
        spec: LrcScheme = self.scheme
        k, total = spec.data_shards, spec.total_shards
        present = [i for i in range(total) if shards[i] is not None]
        missing_data = [i for i in range(k) if shards[i] is None]
        out = [bytes(s) if s is not None else None for s in shards]
        if missing_data:
            src, mat = self.plan_rebuild(present, missing_data)
            srcdata = np.stack([np.frombuffer(shards[i], dtype=np.uint8)
                                for i in src])
            rec = self._apply(mat, srcdata)
            for r, i in enumerate(missing_data):
                out[i] = rec[r].tobytes()
        return out


@register_coder("lrc-mt")
class LrcCoderMT(LrcCoder):
    """LrcCoder with workers='auto' — the per-volume default the store
    builds for LRC volumes (mirrors cpu vs cpu-mt)."""

    def __init__(self, scheme: Optional[LrcScheme] = None,
                 use_native: bool = True):
        super().__init__(scheme, use_native=use_native, workers="auto")
