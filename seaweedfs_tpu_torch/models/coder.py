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
    total_shards == 14 == RS(10,4)'s. Its coders are ops/lrc.py's
    LrcCoder / LrcCoderMT (host) and BatchCoder's LRC facade (the card)."""

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

    @property
    def group_size(self) -> int:
        return self.data_shards // self.local_groups

    def group_of(self, sid: int) -> Optional[int]:
        """Local group index of a shard id, or None for global parities."""
        if sid < self.data_shards:
            return sid // self.group_size
        if sid < self.data_shards + self.local_groups:
            return sid - self.data_shards
        return None

    def group_members(self, g: int) -> list[int]:
        """Data shard ids + the local parity id of group g."""
        lo = g * self.group_size
        return list(range(lo, lo + self.group_size)) + [self.data_shards + g]

    def local_parity_ids(self) -> list[int]:
        return list(range(self.data_shards,
                          self.data_shards + self.local_groups))

    def global_parity_ids(self) -> list[int]:
        return list(range(self.data_shards + self.local_groups,
                          self.total_shards))

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


def coder_name_for_scheme(scheme: RSScheme, fallback: str = "cpu-mt") -> str:
    """The registry name that matches a scheme's code family; `fallback`
    names the RS coder to use (its -mt suffix carries over to LRC)."""
    if isinstance(scheme, LrcScheme):
        return "lrc-mt" if fallback.endswith("-mt") else "lrc"
    return fallback


class ErasureCoder(abc.ABC):
    """Codec over byte buffers. Implementations here: TorchCoder (the
    card), MxuCoder (its parity on the tensor cores), CpuCoder (the host),
    MeshCoder (batches over a mesh of cards), BatchCoder (the batch
    scheduler's facade) and LrcCoder (the host's LRC)."""

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

    def encode_array(self, data) -> "np.ndarray":
        """(k, n) uint8 -> (m, n) uint8 parity. Default goes through the
        bytes API; coders override with a zero-copy path."""
        import numpy as np
        full = self.encode([np.ascontiguousarray(row).tobytes() for row in data])
        k = self.scheme.data_shards
        return np.stack([np.frombuffer(full[k + i], dtype=np.uint8)
                         for i in range(self.scheme.parity_shards)])

    def reconstruct_arrays(self, present: dict, n: int) -> list:
        """present: {shard_id: (n,) uint8 array}. Returns all `total` shards
        as uint8 arrays (missing ones reconstructed)."""
        import numpy as np
        shards = [None] * self.scheme.total_shards
        for i, a in present.items():
            shards[i] = np.ascontiguousarray(a).tobytes()
        full = self.reconstruct(shards)
        return [np.frombuffer(s, dtype=np.uint8) for s in full]

    def verify(self, shards: Sequence[bytes]) -> bool:
        """True iff parity shards are consistent with data shards."""
        redone = self.encode([bytes(s) for s in shards])
        k = self.scheme.data_shards
        return all(bytes(redone[i]) == bytes(shards[i])
                   for i in range(k, self.scheme.total_shards))


_REGISTRY: dict[str, type] = {}


def register_coder(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


# coders of the host: they take no device
HOST_CODERS = ("cpu", "cpu-mt", "lrc", "lrc-mt")


def make_coder(name: str = "torch", scheme: RSScheme = DEFAULT_SCHEME,
               device: str = "cuda") -> ErasureCoder:
    """Factory. 'torch' (the default) is the card coder on K1; 'mxu' is
    the same coder with its parity on K2, the tensor-core bit-plane
    kernel (ops/rs_mxu.py); 'mesh' (ops/rs_mesh.py) codes batches of
    block-groups over a mesh of cards. These raise when `device` is a CUDA
    device and none is present, and run the plain PyTorch versions only
    when the caller passes device='cpu'. 'cpu' and 'cpu-mt'
    (ops/rs_cpu.py) are the host coder, single- and multi-threaded, and
    'lrc' / 'lrc-mt' (ops/lrc.py) the host's locally repairable code
    (any non-LRC scheme becomes LrcScheme()); they ignore `device`."""
    # import for registration side effects
    from seaweedfs_tpu_torch.ops import rs_torch  # noqa: F401
    if name in HOST_CODERS:
        from seaweedfs_tpu_torch.ops import rs_cpu  # noqa: F401
    if name in ("lrc", "lrc-mt"):
        from seaweedfs_tpu_torch.ops import lrc  # noqa: F401
        if not isinstance(scheme, LrcScheme):
            scheme = LrcScheme()
    if name == "mxu":
        from seaweedfs_tpu_torch.ops import rs_mxu  # noqa: F401
    if name == "mesh":
        from seaweedfs_tpu_torch.ops import rs_mesh  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown coder {name!r}; known: {sorted(_REGISTRY)}")
    if name in HOST_CODERS:
        return _REGISTRY[name](scheme)
    return _REGISTRY[name](scheme, device=device)
