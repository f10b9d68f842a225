"""Store: a volume server's set of disk locations + the EC read path.

The port of seaweedfs_tpu/storage/store.py (reference
weed/storage/store.go:43-61 and store_ec.go). The EC needle read walks
intervals; each interval is served from a local shard, else via the
injected remote reader, else degraded-reconstructed from >= k other shards
through the ErasureCoder (reference store_ec.go:125-163,328-382). That
coder is the card's: ``coder=None`` takes make_coder("torch") on
``device``, so every degraded RS interval is one launch of K1
(csrc/gf_apply.cu). A BatchCoder over an EcBatchScheduler (the volume
server's -ecBatcher set-up) coalesces the degraded intervals of concurrent
readers into launches of K1's batch entry instead.

Differences from the JAX package, on purpose:
  - its Store defaults to the host coder "cpu-mt"; this one defaults to
    the card, and raises without a CUDA device unless the caller passes
    device="cpu" (the plain PyTorch version, as the tests run it);
  - volumes of other RS shapes decode on a card coder of their own shape
    when the store's coder is a card coder; LRC volumes decode on the
    host's LrcCoderMT in both packages;
  - every interval is mapped to its shard with the volume's own
    data-shard count, where the JAX package assumes 10 in four places and
    misreads RS(6,3) and RS(12,6) volumes.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from seaweedfs_tpu_torch.models.coder import (ErasureCoder, LrcScheme,
                                              coder_name_for_scheme,
                                              make_coder)
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.erasure_coding import layout
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement, TTL
from seaweedfs_tpu_torch.storage.volume import (CookieMismatchError, DeletedError,
                                                NotFoundError, Volume)

# remote_shard_reader(vid, shard_id, offset, size) -> bytes | None
RemoteShardReader = Callable[[int, int, int, int], Optional[bytes]]


def _shard_and_offset(ev: EcVolume, iv: layout.Interval) -> tuple[int, int]:
    """(shard_id, offset in the shard file) of an interval, under the
    volume's own data-shard count."""
    return iv.to_shard_id_and_offset(layout.LARGE_BLOCK_SIZE,
                                     layout.SMALL_BLOCK_SIZE,
                                     ev.data_shards)


class Store:
    def __init__(self, directories: list[str],
                 max_volume_counts: Optional[list[int]] = None,
                 ip: str = "localhost", port: int = 8080,
                 public_url: str = "", rack: str = "", data_center: str = "",
                 coder: Optional[ErasureCoder] = None,
                 needle_map_kind: str = "memory",
                 disk_types: Optional[list[str]] = None,
                 fsync: bool = False, device="cuda"):
        self.ip = ip
        self.needle_map_kind = needle_map_kind
        # fsync per commit batch on every volume (reference -fsync);
        # group commit in volume.py amortizes it across writers
        self.fsync = fsync
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.rack = rack
        self.data_center = data_center
        # per-dir disk type (reference -disk flag, one entry per -dir;
        # short lists pad with the last value, default hdd)
        types = list(disk_types or ["hdd"])
        types += [types[-1]] * (len(directories) - len(types))
        self.locations = [
            DiskLocation(d, (max_volume_counts or [8] * len(directories))[i],
                         disk_type=types[i] or "hdd",
                         needle_map_kind=needle_map_kind, fsync=fsync)
            for i, d in enumerate(directories)]
        # the card coder by default (K1); raises without a CUDA device
        # unless device="cpu"
        self.coder = coder or make_coder("torch", device=device)
        # per-CodeSpec coder cache for mixed-code stores: RS and LRC
        # volumes on the same disks each decode with their own family
        self._coder_cache: dict = {self.coder.scheme: self.coder}
        self.remote_shard_reader: Optional[RemoteShardReader] = None
        # Injected by the volume server (optional): per-peer breaker
        # registry, a vid -> {shard_id: [urls]} locator, and the switch
        # that turns on health-ranked + straggler-hedged recovery.
        # Without them the degraded path keeps its original
        # fan-out-everything behavior (tests inject bare readers).
        self.peer_health = None
        self.shard_locations: Optional[Callable[[int], dict]] = None
        # shard_pressure(vid) -> {url: pressure 0..1}: peers' advertised
        # QoS backlog, folded into holder ranking as a tiebreak between
        # similarly-healthy candidates (injected by the volume server)
        self.shard_pressure: Optional[Callable[[int], dict]] = None
        self.resilient_reads = True
        # remote_partial_reader(vid, {sid: [coeffs]}, offset, size,
        # n_rows) -> (n_rows, size) uint8 array | None. Injected by the
        # volume server; lets the scrubber check parity on volumes whose
        # data shards are spread across peers by pulling pre-reduced
        # partial columns instead of k raw shard streams.
        self.remote_partial_reader = None
        # Hot-needle record cache (storage/needle_cache.py), injected
        # by the volume server; None keeps every read on the raw path.
        self.needle_cache = None
        self._lock = threading.RLock()
        # delta channels to master (drained by the heartbeat loop)
        self.new_volumes: list[dict] = []
        self.deleted_volumes: list[dict] = []
        self.new_ec_shards: list[dict] = []
        self.deleted_ec_shards: list[dict] = []
        # degraded-read repair-strategy tallies (exposed via shard_stat):
        # "local" = planned group-local recovery, "global" = planned
        # full-width recovery, "generic" = unplanned collect-k fallback
        self.ec_recover_stats = {"local": 0, "global": 0, "generic": 0}

    def load_existing_volumes(self) -> None:
        for loc in self.locations:
            loc.load_existing_volumes()

    # ---- normal volumes ----
    def add_volume(self, vid: int, collection: str = "",
                   replica_placement: str = "000", ttl: str = "",
                   disk_type: str = "") -> Volume:
        with self._lock:
            if self.find_volume(vid) is not None:
                raise ValueError(f"volume {vid} already exists")
            # "" IS the hdd tier (reference types.DiskType): an untyped
            # allocation must not consume an ssd slot
            want = disk_type or "hdd"
            candidates = [l for l in self.locations
                          if l.disk_type == want]
            if not candidates:
                raise ValueError(
                    f"no {want!r} disk on this server (have "
                    f"{sorted({l.disk_type for l in self.locations})})")
            loc = min(candidates, key=lambda l: l.volumes_len())
            vol = Volume(loc.directory, collection, vid,
                         ReplicaPlacement.parse(replica_placement),
                         TTL.parse(ttl),
                         needle_map_kind=self.needle_map_kind,
                         fsync=self.fsync)
            loc.add_volume(vol)
            self.new_volumes.append(self.volume_info(vol))
            return vol

    def find_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            v = loc.find_volume(vid)
            if v is not None:
                return v
        return None

    def delete_volume(self, vid: int) -> bool:
        with self._lock:
            for loc in self.locations:
                v = loc.find_volume(vid)
                if v is not None:
                    info = self.volume_info(v)
                    loc.delete_volume(vid)
                    self.deleted_volumes.append(info)
                    if self.needle_cache is not None:
                        self.needle_cache.invalidate_volume(vid)
                    return True
            return False

    def unmount_volume(self, vid: int) -> bool:
        """Detach a volume WITHOUT deleting its files (reference
        volume_grpc_admin.go VolumeUnmount) — the .dat/.idx stay on disk
        for a later mount or an off-node move."""
        with self._lock:
            for loc in self.locations:
                v = loc.find_volume(vid)
                if v is not None:
                    info = self.volume_info(v)
                    v.close()
                    with loc._lock:
                        loc.volumes.pop(vid, None)
                    self.deleted_volumes.append(info)  # delta: gone here
                    if self.needle_cache is not None:
                        self.needle_cache.invalidate_volume(vid)
                    return True
            return False

    def mount_volume(self, vid: int) -> bool:
        """(Re)attach a volume whose files already sit in a location's
        directory (reference VolumeMount). Uses the same filename
        grammar and .idx requirement as the startup scan."""
        from seaweedfs_tpu_torch.storage.disk_location import _DAT_RE
        with self._lock:
            if self.find_volume(vid) is not None:
                return True
            for loc in self.locations:
                for name in os.listdir(loc.directory):
                    m = _DAT_RE.match(name)
                    if not m or int(m.group("vid")) != vid:
                        continue
                    col = m.group("col") or ""
                    base = os.path.join(loc.directory,
                                        f"{col}_{vid}" if col else str(vid))
                    if not os.path.exists(base + ".idx"):
                        continue
                    vol = Volume(loc.directory, col, vid,
                                 needle_map_kind=self.needle_map_kind,
                                 fsync=self.fsync)
                    loc.add_volume(vol)
                    self.new_volumes.append(self.volume_info(vol))
                    return True
            return False

    def delete_expired_ttl_volumes(self) -> list[int]:
        """Drop TTL volumes whose newest write is older than ttl+grace
        (reference topology_event_handling / volume_checking: TTL
        volumes are removed whole, not needle-by-needle)."""
        with self._lock:
            doomed = [v.id for loc in self.locations
                      for v in list(loc.volumes.values())
                      if v.is_expired_long_enough()
                      and not v.is_compacting]
        reaped = []
        for vid in doomed:
            with self._lock:
                v = self.find_volume(vid)
                # re-check at the moment of deletion: a write acked
                # between the scan and here resets the clock, and a
                # vacuum may have started — never destroy either
                if v is None or v.is_compacting \
                        or not v.is_expired_long_enough():
                    continue
            if self.delete_volume(vid):
                reaped.append(vid)
        return reaped

    def move_volume_disk(self, vid: int, disk_type: str) -> bool:
        """Move a volume's files to a location of another disk type on
        THIS server (intra-node half of volume.tier.move; the
        cross-node half is copy+delete). No-op when already there."""
        want = disk_type or "hdd"
        with self._lock:
            src_loc = None
            for loc in self.locations:
                if vid in loc.volumes:
                    src_loc = loc
                    break
            if src_loc is None:
                return False
            if src_loc.disk_type == want:
                return True
            candidates = [l for l in self.locations
                          if l.disk_type == want]
            if not candidates:
                raise ValueError(f"no {want!r} disk on this server")
            dst_loc = min(candidates, key=lambda l: l.volumes_len())
            v = src_loc.volumes[vid]
            old_info = self.volume_info(v)
            collection = v.collection
            v.close()
            with src_loc._lock:
                src_loc.volumes.pop(vid, None)
            name = (f"{collection}_{vid}" if collection else str(vid))
            for fname in sorted(os.listdir(src_loc.directory)):
                base, dot, _ext = fname.partition(".")
                if dot and base == name:
                    os.rename(os.path.join(src_loc.directory, fname),
                              os.path.join(dst_loc.directory, fname))
            vol = Volume(dst_loc.directory, collection, vid,
                         needle_map_kind=self.needle_map_kind,
                         fsync=self.fsync)
            dst_loc.add_volume(vol)
            # delta: the volume's disk_type changed
            self.deleted_volumes.append(old_info)
            self.new_volumes.append(self.volume_info(vol))
            return True

    def write_volume_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        if self.needle_cache is not None:
            # overwrite: invalidate BEFORE (no cache hit serves the old
            # generation while the write is landing) and again AFTER
            # (a load that read the old bytes off disk mid-write holds
            # a stale epoch and cannot be admitted)
            self.needle_cache.invalidate(vid, n.id)
        try:
            return v.write_needle(n)
        finally:
            if self.needle_cache is not None:
                self.needle_cache.invalidate(vid, n.id)

    def read_volume_needle(self, vid: int, needle_id: int,
                           cookie: Optional[int] = None) -> Needle:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        if v.is_expired():
            # past-TTL data is gone to readers even before the removal
            # grace deletes the files (reference store read path)
            raise NotFoundError(f"volume {vid} expired")
        cache = self.needle_cache
        if cache is None:
            return v.read_needle(needle_id, cookie)

        def load():
            blob, size = v.read_needle_blob(needle_id)
            # CRC verified ONCE at admission, over memoryview windows
            # (no payload copy); hits below skip the re-check
            needle.verify_record_crc(blob, size, v.version)
            return blob, size, v.version, False

        blob, size, version = cache.get_or_load(vid, needle_id, load)
        # re-parse per hit (handler-side mutation of n.data — gzip
        # decompress, resize — can't touch the cache) but WITHOUT the
        # per-hit CRC walk: the blob was verified at admission
        n = Needle.from_bytes(blob, size, version, check_crc=False)
        n.checksum = needle.payload_crc_stored(blob, size)
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatchError(
                f"cookie mismatch for needle {needle_id:x}")
        return n

    def read_volume_needle_descriptor(self, vid: int, needle_id: int,
                                      cookie: Optional[int] = None):
        """Zero-copy read plane: ``(needle_meta, fd, payload_offset,
        data_size)`` for the volume server to sendfile, or None when
        the read belongs on the buffered ladder — volume missing or
        expired (caller re-drives the buffered path for its richer
        repair/404 handling), needle cached (served from memory), or
        the volume refuses (tiered/v1). NotFound/Deleted/Cookie errors
        are NOT raised here: they return None so the buffered path
        stays the single authority on read-repair and error shape."""
        v = self.find_volume(vid)
        if v is None or v.is_expired():
            return None
        cache = self.needle_cache
        if cache is not None and cache.contains(vid, needle_id):
            return None  # memory beats disk: cache path serves it
        try:
            return v.read_needle_descriptor(needle_id, cookie)
        except (NotFoundError, DeletedError, CookieMismatchError):
            return None

    def delete_volume_needle(self, vid: int, needle_id: int,
                             cookie: Optional[int] = None) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        if self.needle_cache is not None:
            self.needle_cache.invalidate(vid, needle_id)
        try:
            return v.delete_needle(needle_id, cookie)
        finally:
            if self.needle_cache is not None:
                self.needle_cache.invalidate(vid, needle_id)

    def mark_volume_readonly(self, vid: int, read_only: bool = True) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.read_only = read_only
        return True

    # ---- EC shards ----
    def mount_ec_shards(self, collection: str, vid: int,
                        shard_ids: list[int]) -> None:
        for sid in shard_ids:
            for loc in self.locations:
                try:
                    if loc.load_ec_shard(collection, vid, sid):
                        self.new_ec_shards.append(
                            {"id": vid, "collection": collection,
                             "ec_index_bits": 1 << sid})
                        break
                except FileNotFoundError:
                    continue

    def coder_for(self, ev: EcVolume) -> ErasureCoder:
        """The coder matching a volume's persisted CodeSpec — self.coder
        for plain RS volumes, a cached family-specific coder otherwise.
        This is the per-volume dispatch that lets RS and LRC volumes
        coexist on one store."""
        return self.coder_for_scheme(getattr(ev, "scheme", None))

    def coder_for_scheme(self, scheme) -> ErasureCoder:
        if scheme is None or scheme == self.coder.scheme:
            return self.coder
        c = self._coder_cache.get(scheme)
        if c is None:
            device = getattr(self.coder, "device", None)
            if device is not None and not isinstance(scheme, LrcScheme):
                # another RS shape next to a card coder: the card too
                c = make_coder("torch", scheme, device=device)
            else:
                c = make_coder(coder_name_for_scheme(scheme), scheme)
            self._coder_cache[scheme] = c
        return c

    def generate_ec_shards(self, vid: int, pipelined: bool = True,
                           stats: Optional[dict] = None,
                           code: str = "") -> str:
        """VolumeEcShardsGenerate equivalent: write .ec00-.ec13 + .ecx +
        .vif next to the volume's files (reference
        server/volume_grpc_erasure_coding.go:38-81). Returns the base file
        name. The volume must exist locally; it is marked readonly first.
        `code` picks the family ('' / 'rs' -> the store coder, 'lrc' ->
        LRC(10,2,2)); the chosen CodeSpec is persisted in the .vif."""
        from seaweedfs_tpu_torch.storage.erasure_coding import encoder as ecenc
        from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import \
            write_volume_info
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        if code and code != "rs":
            coder = make_coder(code)
            coder = self._coder_cache.setdefault(coder.scheme, coder)
        else:
            coder = self.coder
        v.read_only = True
        v.sync()
        base = v.file_name()
        ecenc.write_sorted_ecx(base)
        ecenc.write_ec_files(base, coder, pipelined=pipelined,
                             stats=stats)
        write_volume_info(base, v.version, coder.scheme)
        return base

    def unmount_ec_shards(self, vid: int, shard_ids: list[int]) -> None:
        for sid in shard_ids:
            for loc in self.locations:
                if loc.unload_ec_shard(vid, sid):
                    self.deleted_ec_shards.append(
                        {"id": vid, "ec_index_bits": 1 << sid})
                    break
        if self.needle_cache is not None:
            # shard topology changed under the volume; cached records
            # themselves are still valid bytes, but ec-to-volume
            # conversion reuses the vid — stay strict
            self.needle_cache.invalidate_volume(vid)

    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        for loc in self.locations:
            ev = loc.find_ec_volume(vid)
            if ev is not None:
                return ev
        return None

    def has_ec_volume(self, vid: int) -> bool:
        return self.find_ec_volume(vid) is not None

    def read_ec_shard_needle(self, vid: int, needle_id: int,
                             cookie: Optional[int] = None) -> Needle:
        """Locate via .ecx, then read intervals with local -> remote ->
        degraded-reconstruction fallback (reference store_ec.go:125-163).
        With a needle cache wired, the full record blob is read through
        it single-flight, so a hot degraded needle pays its k-column
        decode once and serves every later (and concurrent) reader from
        memory."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise NotFoundError(f"ec volume {vid} not found")
        cache = self.needle_cache
        if cache is None:
            intervals, offset, size = ev.locate_needle(needle_id)
            if t.size_is_deleted(size):
                raise DeletedError(f"needle {needle_id:x} deleted")
            blob = b"".join(
                self._read_one_interval(ev, iv) for iv in intervals)
            n = Needle.from_bytes(blob, size, ev.version)
        else:
            blob, size, version = cache.get_or_load(
                vid, needle_id,
                lambda: self._load_ec_record(ev, needle_id))
            # admission verified the blob's CRC; hits skip the re-walk
            n = Needle.from_bytes(blob, size, version, check_crc=False)
            n.checksum = needle.payload_crc_stored(blob, size)
        if cookie is not None and n.cookie != cookie:
            raise NotFoundError(f"cookie mismatch for needle {needle_id:x}")
        return n

    def _load_ec_record(self, ev: EcVolume,
                        needle_id: int) -> tuple[bytes, int, int, bool]:
        """Cache loader: the needle's full record blob via the interval
        ladder. Flags whether any interval was degraded-reconstructed,
        so the cache force-admits records that cost a decode."""
        intervals, _offset, size = ev.locate_needle(needle_id)
        if t.size_is_deleted(size):
            raise DeletedError(f"needle {needle_id:x} deleted")
        meter = {"recovered": 0}
        blob = b"".join(
            self._read_one_interval(ev, iv, meter) for iv in intervals)
        # the one CRC walk this blob ever pays: admission-time, over
        # memoryview windows — hits re-parse with check_crc=False and
        # range reads serve memoryview slices of the verified bytes
        needle.verify_record_crc(blob, size, ev.version)
        return blob, size, ev.version, meter["recovered"] > 0

    def _read_record_range(self, ev: EcVolume, rec_offset: int,
                           rel_off: int, length: int) -> bytes:
        """Read `length` bytes starting `rel_off` into the record at
        `rec_offset`, touching only the intervals that cover the range.
        Each interval rides the full local -> remote -> degraded ladder,
        so a missing shard costs one reconstruction of THIS range, not
        of the whole record (let alone the whole large-block)."""
        if length <= 0:
            return b""
        intervals = layout.locate_data(
            layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE,
            ev.data_shards * ev.shard_size(),
            rec_offset + rel_off, length, ev.data_shards)
        return b"".join(
            self._read_one_interval(ev, iv) for iv in intervals)

    def ec_needle_meta(self, vid: int, needle_id: int,
                       cookie: Optional[int] = None
                       ) -> tuple[Needle, int]:
        """(needle-with-empty-data, data_size) by reading only the
        record's head (header + data_size field) and tail (flags +
        optional name/mime/lm/ttl/pairs) — the payload between is never
        touched. Serves subrange degraded reads: the caller learns the
        payload length and metadata for the price of a few dozen bytes,
        then fetches just the requested slice. v2/3 only (a v1 record
        has no data_size prefix); CRC is not checkable without the full
        payload, so `checksum` stays 0."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise NotFoundError(f"ec volume {vid} not found")
        if ev.version == 1:
            raise ValueError("v1 records have no subrange layout")
        offset, size = ev.find_needle_from_ecx(needle_id)
        if t.size_is_deleted(size):
            raise DeletedError(f"needle {needle_id:x} deleted")
        head_len = t.NEEDLE_HEADER_SIZE + 4
        head = self._read_record_range(ev, offset, 0, head_len)
        n = Needle.parse_header(head)
        if n.size != size:
            raise NotFoundError(
                f"needle {needle_id:x}: header size {n.size} != ecx {size}")
        if cookie is not None and n.cookie != cookie:
            raise NotFoundError(f"cookie mismatch for needle {needle_id:x}")
        if size == 0:
            return n, 0
        data_size = int.from_bytes(head[t.NEEDLE_HEADER_SIZE:head_len],
                                   "big")
        # tail: [flags ... optional fields] up to the end of the body,
        # plus crc (+ v3 timestamp) for completeness of append_at_ns
        tail_off = head_len + data_size
        tail_len = t.NEEDLE_HEADER_SIZE + size - tail_off \
            + t.NEEDLE_CHECKSUM_SIZE \
            + (t.TIMESTAMP_SIZE if ev.version == 3 else 0)
        tail = self._read_record_range(ev, offset, tail_off, tail_len)
        body_tail_len = t.NEEDLE_HEADER_SIZE + size - tail_off
        if body_tail_len > 0:
            n.parse_body_tail(tail[:body_tail_len])
        if ev.version == 3 and len(tail) >= body_tail_len + 12:
            n.append_at_ns = int.from_bytes(
                tail[body_tail_len + 4:body_tail_len + 12], "big")
        return n, data_size

    def read_ec_needle_data_range(self, vid: int, needle_id: int,
                                  lo: int, length: int) -> bytes:
        """data[lo:lo+length] of an EC needle, reading (and on degraded
        paths reconstructing) only the covering byte ranges. A cached
        full record serves any slice from memory; when the requested
        range would need reconstruction and the record fits the cache's
        item cap, the whole record is reconstructed ONCE (single-flight)
        and every range read after — concurrent waiters included —
        slices the cached blob instead of paying its own decode."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise NotFoundError(f"ec volume {vid} not found")
        if ev.version == 1:
            raise ValueError("v1 records have no subrange layout")
        offset, size = ev.find_needle_from_ecx(needle_id)
        if t.size_is_deleted(size):
            raise DeletedError(f"needle {needle_id:x} deleted")
        data_off = t.NEEDLE_HEADER_SIZE + 4
        cache = self.needle_cache
        if cache is not None:
            hit = cache.get(vid, needle_id)
            if hit is not None:
                # memoryview WINDOW of the cached record, not a bytes
                # copy: CRC was verified at admission, and epoch
                # invalidation guarantees the underlying blob is
                # immutable for as long as this view can be reachable
                return memoryview(hit[0])[data_off + lo:
                                          data_off + lo + length]
            if (t.get_actual_size(size, ev.version)
                    <= cache.max_item_bytes()
                    and self._range_needs_recovery(
                        ev, offset, data_off + lo, length)):
                blob, _, _ = cache.get_or_load(
                    vid, needle_id,
                    lambda: self._load_ec_record(ev, needle_id))
                return memoryview(blob)[data_off + lo:
                                        data_off + lo + length]
        return self._read_record_range(
            ev, offset, data_off + lo, length)

    def _range_needs_recovery(self, ev: EcVolume, rec_offset: int,
                              rel_off: int, length: int) -> bool:
        """Would reading this range hit the reconstruction ladder? True
        when a covering interval's shard is neither local nor (as far
        as the shard locator knows) held by any reachable peer. Without
        a locator, missing-local plus no remote reader means recovery."""
        if length <= 0:
            return False
        intervals = layout.locate_data(
            layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE,
            ev.data_shards * ev.shard_size(),
            rec_offset + rel_off, length, ev.data_shards)
        locs = None
        for iv in intervals:
            sid = _shard_and_offset(ev, iv)[0]
            if sid in ev.shards:
                continue
            if self.remote_shard_reader is None:
                return True
            if self.shard_locations is None:
                # remote reader but no topology view: assume the peer
                # will serve it (tests inject bare readers)
                continue
            if locs is None:
                try:
                    locs = self.shard_locations(ev.volume_id) or {}
                except Exception:
                    return True
            if not locs.get(sid):
                return True
        return False

    def _read_one_interval(self, ev: EcVolume, iv: layout.Interval,
                           meter: Optional[dict] = None) -> bytes:
        data, shard_id = ev.read_interval(iv)
        if data is not None:
            return data
        # remote shard
        if self.remote_shard_reader is not None:
            shard_off = _shard_and_offset(ev, iv)[1]
            data = self.remote_shard_reader(ev.volume_id, shard_id, shard_off,
                                            iv.size)
            if data is not None and len(data) == iv.size:
                return data
        # degraded: fetch the same range of >= k other shards and reconstruct
        if meter is not None:
            meter["recovered"] = meter.get("recovered", 0) + 1
        return self._recover_one_interval(ev, iv, shard_id)

    RECOVER_POOL_WORKERS = 32  # > 2x total shards: room for concurrent
    #                            degraded reads even with wedged peers

    _recover_pool_init_lock = threading.Lock()  # class-wide is fine:
    #                                             held only at first use

    def _recover_pool(self):
        pool = getattr(self, "_recover_pool_obj", None)
        if pool is None:
            with self._recover_pool_init_lock:
                pool = getattr(self, "_recover_pool_obj", None)
                if pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    pool = ThreadPoolExecutor(
                        max_workers=self.RECOVER_POOL_WORKERS,
                        thread_name_prefix="ec-recover")
                    self._recover_pool_obj = pool
        return pool

    def _recover_one_interval(self, ev: EcVolume, iv: layout.Interval,
                              wanted_shard: int) -> bytes:
        """Degraded read: collect sibling-shard ranges and reconstruct.
        Local shards read inline; remote peers are fetched CONCURRENTLY
        with first-k-wins — one slow peer must not serialize recovery
        (reference store_ec.go:328-382 fans out a goroutine per source
        shard the same way). Coders that plan their sources (LRC) get a
        plan-first pass: a lost group member reads only its surviving
        local group (~k/l columns) instead of k."""
        coder = self.coder_for(ev)
        k = coder.scheme.data_shards
        total = coder.scheme.total_shards
        shard_off = _shard_and_offset(ev, iv)[1]
        plan_capable = hasattr(coder, "plan_rebuild")
        if plan_capable:
            got = self._recover_via_plan(ev, iv, shard_off, coder,
                                         wanted_shard)
            if got is not None:
                return got
        bufs: dict[int, bytes] = {}
        remote_sids: list[int] = []
        for sid in range(total):
            if sid == wanted_shard:
                continue
            local = ev.shards.get(sid)
            if local is not None:
                bufs[sid] = local.read_at(shard_off, iv.size)
                # a plan-capable coder may find an arbitrary k-subset
                # rank-deficient, so keep every local column for it
                if len(bufs) >= k and not plan_capable:
                    break
            elif self.remote_shard_reader is not None:
                remote_sids.append(sid)
        # same reasoning remotely: the fallback is rare (a planned
        # source was unreachable), so over-collect for plan coders
        need = k if not plan_capable \
            else min(total - 1, len(bufs) + len(remote_sids))
        if len(bufs) < need and remote_sids:
            self._fetch_remote_shards(ev, iv, shard_off, bufs,
                                      remote_sids, need)
        if len(bufs) < k:
            raise NotFoundError(
                f"ec volume {ev.volume_id}: only {len(bufs)} shards "
                f"reachable, need {k}")
        shards: list[Optional[bytes]] = [None] * total
        for sid, b in bufs.items():
            shards[sid] = b
        try:
            full = coder.reconstruct(shards)
        except ValueError as e:
            raise NotFoundError(
                f"ec volume {ev.volume_id}: {len(bufs)} shards reachable "
                f"but pattern unrecoverable: {e}")
        self.ec_recover_stats["generic"] += 1
        return full[wanted_shard]

    def _recover_via_plan(self, ev: EcVolume, iv: layout.Interval,
                          shard_off: int, coder: ErasureCoder,
                          wanted_shard: int) -> Optional[bytes]:
        """Try the coder's cheapest-source repair plan. Returns the
        recovered range, or None when a planned source is unreachable
        (the caller then falls back to the generic collect-k ladder)."""
        import numpy as np
        total = coder.scheme.total_shards
        try:
            src, mat = coder.plan_rebuild(
                [s for s in range(total) if s != wanted_shard],
                [wanted_shard])
        except ValueError:
            return None
        if src is None:
            return None
        bufs: dict[int, bytes] = {}
        remote: list[int] = []
        for sid in src:
            local = ev.shards.get(sid)
            if local is not None:
                bufs[sid] = local.read_at(shard_off, iv.size)
            elif self.remote_shard_reader is not None:
                remote.append(sid)
            else:
                return None
        if remote:
            self._fetch_remote_shards(ev, iv, shard_off, bufs, remote,
                                      len(src))
        if len(bufs) != len(src):
            return None
        rows = np.empty((len(src), iv.size), dtype=np.uint8)
        for r, sid in enumerate(src):
            rows[r] = np.frombuffer(bufs[sid], dtype=np.uint8)
        strat = "local" if len(src) < coder.scheme.data_shards \
            else "global"
        self.ec_recover_stats[strat] += 1
        return coder.reconstruct_rows(rows, mat)[0].tobytes()

    def _rank_remote_sids(self, vid: int,
                          sids: list[int]) -> tuple[list[int], int]:
        """Order remote shard candidates by the health of their BEST
        holder (closed circuits first, open last) and decide how many
        extra columns to over-request. Returns (ordered_sids, extra):
        legacy mode (no health/locator, or resilient_reads off) keeps
        the original fan-out-everything behavior via extra=len(sids);
        resilient mode over-requests one column only when a straggler
        is predicted among the holders it is about to use."""
        health, locator = self.peer_health, self.shard_locations
        if health is None or locator is None or not self.resilient_reads:
            return list(sids), len(sids)
        try:
            locs = locator(vid) or {}
        except Exception:
            return list(sids), len(sids)
        from seaweedfs_tpu_torch.utils.resilience import CLOSED
        try:
            pres = self.shard_pressure(vid) if self.shard_pressure \
                else None
        except Exception:
            pres = None

        def sid_key(sid: int) -> tuple[int, float]:
            urls = locs.get(sid) or []
            if not urls:
                return (3, float("inf"))  # no known holder: try last
            br = health.breaker(health.rank(urls, pressure=pres)[0])
            if br.state == CLOSED:
                return (0, br.score())
            if br.probe_ripe():
                return (1, br.score())
            return (2, br.score())

        keys = {sid: sid_key(sid) for sid in sids}
        ordered = sorted(sids, key=lambda s: keys[s])
        # straggler predicted: any holder we are about to lean on is
        # not healthy-closed, or is far slower than the best candidate
        head = ordered[:max(1, len(ordered))]
        best_score = keys[ordered[0]][1] if ordered else 0.0
        predicted = any(
            keys[s][0] > 0
            or (best_score > 0 and keys[s][1] > 3.0 * best_score)
            for s in head)
        return ordered, 1 if predicted else 0

    def _fetch_remote_shards(self, ev: EcVolume, iv: layout.Interval,
                             shard_off: int, bufs: dict,
                             remote_sids: list[int], k: int) -> None:
        """Concurrent first-k-wins fetch into `bufs`, via the shared
        bounded pool: per-read fan-out (like the reference's
        goroutine-per-source-shard) without letting a wedged peer
        accumulate unbounded abandoned threads across many degraded
        reads — stragglers occupy pool slots until their own network
        timeout, which is the backpressure. In resilient mode the
        initial wave is only (needed + predicted-straggler hedge) of
        the HEALTH-RANKED candidates; failures backfill from the
        ranked queue, and the ambient deadline bounds the whole wait."""
        from concurrent.futures import FIRST_COMPLETED, wait

        from seaweedfs_tpu_torch.utils import resilience

        pool = self._recover_pool()
        dl = resilience.current_deadline()
        queue, extra = self._rank_remote_sids(ev.volume_id, remote_sids)
        need = k - len(bufs)
        inflight: dict = {}

        def submit(sid: int) -> None:
            def run():
                # contextvars don't cross into pool threads on their
                # own: re-enter the caller's deadline scope
                with resilience.deadline_scope(dl):
                    return self.remote_shard_reader(
                        ev.volume_id, sid, shard_off, iv.size)
            inflight[pool.submit(run)] = sid

        for _ in range(min(len(queue), need + extra)):
            submit(queue.pop(0))
        while inflight and len(bufs) < k:
            timeout = None
            if dl is not None:
                timeout = dl.remaining()
                if timeout <= 0:
                    break
            done, _ = wait(inflight, timeout=timeout,
                           return_when=FIRST_COMPLETED)
            if not done:
                break  # deadline expired mid-wait
            for fut in done:
                sid = inflight.pop(fut)
                try:
                    got = fut.result()
                except Exception:
                    got = None
                if got is not None and len(got) == iv.size:
                    bufs[sid] = got
                elif queue:
                    submit(queue.pop(0))  # backfill the failure
        for fut in inflight:
            fut.cancel()  # losers/stragglers are abandoned

    def delete_ec_shard_needle(self, vid: int, needle_id: int,
                               cookie: Optional[int] = None) -> int:
        """Cookie-check then tombstone locally (the server layer fans the
        delete to peer shard owners, reference store_ec_delete.go)."""
        n = self.read_ec_shard_needle(vid, needle_id, cookie)
        ev = self.find_ec_volume(vid)
        if self.needle_cache is not None:
            self.needle_cache.invalidate(vid, needle_id)
        try:
            ev.delete_needle(needle_id)
        finally:
            if self.needle_cache is not None:
                self.needle_cache.invalidate(vid, needle_id)
        return len(n.data)

    # ---- heartbeat ----
    def _disk_type_of(self, v: Volume) -> str:
        for loc in self.locations:
            if v.id in loc.volumes:
                return loc.disk_type
        return "hdd"

    def volume_info(self, v: Volume) -> dict:
        return {
            "id": v.id,
            "collection": v.collection,
            "size": v.content_size(),
            "file_count": v.file_count(),
            "delete_count": v.deleted_count(),
            "deleted_byte_count": v.deleted_bytes(),
            "read_only": v.read_only,
            "replica_placement": v.super_block.replica_placement.to_byte(),
            "ttl": v.super_block.ttl.to_uint32(),
            "version": v.version,
            "disk_type": self._disk_type_of(v),
            "tiered": v.is_tiered,
        }

    def collect_heartbeat(self) -> dict:
        volumes = []
        ec_shards = []
        max_volume_count = 0
        for loc in self.locations:
            max_volume_count += loc.max_volume_count
            for v in loc.volumes.values():
                volumes.append(self.volume_info(v))
            for ev in loc.ec_volumes.values():
                ec_shards.append({
                    "id": ev.volume_id,
                    "collection": ev.collection,
                    "ec_index_bits": ev.shard_bits().bits,
                })
        disk_slots: dict[str, int] = {}
        for loc in self.locations:
            disk_slots[loc.disk_type] = (disk_slots.get(loc.disk_type, 0)
                                         + loc.max_volume_count)
        return {
            "ip": self.ip, "port": self.port, "public_url": self.public_url,
            "rack": self.rack, "data_center": self.data_center,
            "max_volume_count": max_volume_count,
            "disk_slots": disk_slots,
            "volumes": volumes,
            "ec_shards": ec_shards,
            "has_no_volumes": not volumes and not ec_shards,
        }

    def drain_deltas(self) -> dict:
        with self._lock:
            out = {
                "new_volumes": self.new_volumes,
                "deleted_volumes": self.deleted_volumes,
                "new_ec_shards": self.new_ec_shards,
                "deleted_ec_shards": self.deleted_ec_shards,
            }
            self.new_volumes = []
            self.deleted_volumes = []
            self.new_ec_shards = []
            self.deleted_ec_shards = []
            return out

    def close(self) -> None:
        pool = getattr(self, "_recover_pool_obj", None)
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
            self._recover_pool_obj = None
        for loc in self.locations:
            loc.close()
