"""ErasureCoder interface — the pluggable codec seam.

The reference hard-wires klauspost/reedsolomon (`reedsolomon.New(10, 4)` at
reference weed/storage/erasure_coding/ec_encoder.go:199); every encode and
reconstruct here goes through an `ErasureCoder` instead. In this package
the default coder is ``"torch"`` (ops/rs_torch.TorchCoder), which runs on
the CUDA card unless the caller asks for ``device="cpu"``.

Semantics mirror the reference codec's contract:
  - encode(shards): shards is a list of `total` equal-length byte buffers;
    the first `data` ones are inputs; parity buffers are recomputed.
  - reconstruct(shards): missing entries are None; all missing shards are
    recomputed (requires >= data present).
  - reconstruct_data(shards): only the first `data` entries are guaranteed
    to be filled afterwards (the degraded-read case, reference
    weed/storage/store_ec.go:328-382).
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence


class RSScheme:
    """An (data, parity) Reed-Solomon scheme. Default RS(10,4) like the
    reference (weed/storage/erasure_coding/ec_encoder.go:17-23)."""

    __slots__ = ("data_shards", "parity_shards")

    def __init__(self, data_shards: int = 10, parity_shards: int = 4):
        if not (0 < data_shards and 0 < parity_shards
                and data_shards + parity_shards <= 256):
            raise ValueError(f"invalid RS scheme ({data_shards},{parity_shards})")
        self.data_shards = data_shards
        self.parity_shards = parity_shards

    @property
    def total_shards(self) -> int:
        return self.data_shards + self.parity_shards

    def __repr__(self):
        return f"RS({self.data_shards},{self.parity_shards})"

    def __eq__(self, other):
        # type identity, not isinstance: an LrcScheme with the same
        # (data, parity) counts is a DIFFERENT code family
        return (type(other) is type(self)
                and other.data_shards == self.data_shards
                and other.parity_shards == self.parity_shards)

    def __hash__(self):
        return hash((self.data_shards, self.parity_shards))


DEFAULT_SCHEME = RSScheme(10, 4)


class LrcScheme(RSScheme):
    """LRC(k, l, g): k data shards split into l local groups, one local
    (XOR) parity per group, g global RS parities. Shard ids are laid out
    data-first: [0..k) data, [k..k+l) local parities (group i's parity is
    shard k+i), [k+l..k+l+g) global parities. Default LRC(10,2,2) keeps
    total_shards == 14 == RS(10,4)'s. This package reads and writes the
    scheme in .vif files; LRC coding itself is not ported yet."""

    __slots__ = ("local_groups", "global_parities")

    def __init__(self, data_shards: int = 10, local_groups: int = 2,
                 global_parities: int = 2):
        if local_groups <= 0 or data_shards % local_groups:
            raise ValueError(
                f"LRC: {local_groups} groups must evenly divide "
                f"{data_shards} data shards")
        super().__init__(data_shards, local_groups + global_parities)
        self.local_groups = local_groups
        self.global_parities = global_parities

    def __repr__(self):
        return (f"LRC({self.data_shards},{self.local_groups},"
                f"{self.global_parities})")

    def __eq__(self, other):
        return (type(other) is type(self)
                and other.data_shards == self.data_shards
                and other.local_groups == self.local_groups
                and other.global_parities == self.global_parities)

    def __hash__(self):
        return hash((self.data_shards, self.local_groups,
                     self.global_parities, "lrc"))


def scheme_to_dict(scheme: RSScheme) -> dict:
    """Serializable CodeSpec for volume metadata (.vif)."""
    if isinstance(scheme, LrcScheme):
        return {"family": "lrc", "data_shards": scheme.data_shards,
                "local_groups": scheme.local_groups,
                "global_parities": scheme.global_parities}
    return {"family": "rs", "data_shards": scheme.data_shards,
            "parity_shards": scheme.parity_shards}


def scheme_from_dict(d: Optional[dict]) -> RSScheme:
    """Inverse of scheme_to_dict; None / empty -> the RS default (volumes
    encoded before CodeSpec persistence are RS(10,4))."""
    if not d:
        return DEFAULT_SCHEME
    if d.get("family") == "lrc":
        return LrcScheme(int(d.get("data_shards", 10)),
                         int(d.get("local_groups", 2)),
                         int(d.get("global_parities", 2)))
    return RSScheme(int(d.get("data_shards", 10)),
                    int(d.get("parity_shards", 4)))


class ErasureCoder(abc.ABC):
    """Codec over byte buffers. Implementation here: TorchCoder."""

    def __init__(self, scheme: RSScheme = DEFAULT_SCHEME):
        self.scheme = scheme

    @abc.abstractmethod
    def encode(self, shards: Sequence[bytearray | bytes | memoryview]) -> list[bytes]:
        """Compute parity. Returns the full list of `total` shard buffers
        (data shards passed through, parity freshly computed)."""

    @abc.abstractmethod
    def reconstruct(self, shards: Sequence[Optional[bytes]]) -> list[bytes]:
        """Fill in every None shard. Returns complete shard list."""

    def reconstruct_data(self, shards: Sequence[Optional[bytes]]) -> list[Optional[bytes]]:
        """Fill in only missing *data* shards (parity may remain None)."""
        full = self.reconstruct(shards)
        k = self.scheme.data_shards
        return list(full[:k]) + [
            full[i] if shards[i] is not None else None
            for i in range(k, self.scheme.total_shards)
        ]


_REGISTRY: dict[str, type] = {}


def register_coder(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def make_coder(name: str = "torch", scheme: RSScheme = DEFAULT_SCHEME,
               device: str = "cuda") -> ErasureCoder:
    """Factory. 'torch' (the default) is the card coder; it raises when
    `device` is a CUDA device and none is present, and runs the plain
    PyTorch version only when the caller passes device='cpu'."""
    # import for registration side effects
    from seaweedfs_tpu_torch.ops import rs_torch  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown coder {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](scheme, device=device)
