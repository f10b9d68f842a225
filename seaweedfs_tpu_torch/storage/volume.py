"""Volume: append-only needle log (.dat) + index log (.idx).

The port of seaweedfs_tpu/storage/volume.py (reference
weed/storage/volume.go, volume_write.go, volume_read.go, volume_loading.go,
volume_vacuum.go, volume_checking.go). The .dat begins with an 8-byte superblock; every write
appends a padded needle record to .dat and a 16-byte entry to .idx; deletes
append an empty needle to .dat and a tombstone entry to .idx; vacuum
rewrites live needles into a fresh pair of files and bumps the superblock's
compaction revision. The files are byte-identical to the JAX package's
for the same sequence of writes, deletes and compactions.

The cloud tier (tier_to / untier, and volumes whose .dat lives on a
remote tier) runs through storage/backend.py, as in the JAX package.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Optional

from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import (CURRENT_VERSION, Needle,
                                          SizeMismatchError)
from seaweedfs_tpu_torch.storage.needle_map import CompactMap
from seaweedfs_tpu_torch.storage import idx as idxmod
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement, SuperBlock, TTL


class NotFoundError(Exception):
    pass


class DeletedError(Exception):
    pass


class CookieMismatchError(Exception):
    pass


class Volume:
    # superblock `extra` marker for wide-offset volumes (the reference
    # fixes offset width at compile time via the 5BytesOffset build tag,
    # offset_5bytes.go:15; we record it per volume so both widths coexist)
    _WIDE_OFFSET_MARKER = b"5BO"

    def __init__(self, directory: str, collection: str, volume_id: int,
                 replica_placement: Optional[ReplicaPlacement] = None,
                 ttl: Optional[TTL] = None, version: int = CURRENT_VERSION,
                 needle_map_kind: str = "memory", offset_bytes: int = 4,
                 fsync: bool = False):
        """needle_map_kind selects the index structure (reference
        NeedleMapKind, weed/storage/needle_map.go:13-19):
        "memory" = CompactMap, "ldb" = disk-backed LSM map (the LevelDB
        analogue), "sorted" = readonly sorted-file map.
        offset_bytes=5 gives 8TB volumes (17-byte index entries).
        fsync=True forces an fsync of .dat/.idx per commit batch
        (reference `weed volume -fsync`); the group-commit protocol
        below amortizes it across concurrent writers."""
        self.directory = directory
        self.collection = collection
        self.id = volume_id
        self.read_only = needle_map_kind == "sorted"
        self.needle_map_kind = needle_map_kind
        self.offset_bytes = offset_bytes
        self._lock = threading.RLock()
        self.last_append_at_ns = 0
        self.is_compacting = False
        self._untiering = False
        # group-commit state: appends take a sequence number under
        # _lock; durability (flush/fsync) is settled afterwards under
        # _flush_cond so one leader's flush covers every append that
        # landed before it (reference topology/store_replicate.go keeps
        # one flush per write; coalescing is this port's concession to
        # Python's buffered file objects + thread-per-request server)
        self._fsync = fsync
        self._flush_cond = threading.Condition()
        self._appended_seq = 0   # last sequence handed to an append
        self._flushed_seq = 0    # highest sequence known durable
        self._flush_leader = False
        self.flush_count = 0     # flush batches actually performed
        self.flush_s = 0.0       # wall seconds inside those batches
        self.commit_waits = 0    # appends that rode another's flush

        base = self.file_name()
        exists = (os.path.exists(base + ".dat")
                  or os.path.exists(base + ".vif"))  # tiered: .vif only
        if exists:
            self._load()
        else:
            self._backend = None
            if needle_map_kind == "sorted":
                raise ValueError("sorted needle map requires an existing "
                                 "volume (it serves sealed volumes)")
            assert offset_bytes in (4, 5), offset_bytes
            self.super_block = SuperBlock(
                version=version,
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl or TTL(),
                extra=(self._WIDE_OFFSET_MARKER if offset_bytes == 5
                       else b""))
            self._dat = open(base + ".dat", "w+b")
            self._dat.write(self.super_block.to_bytes())
            self._dat.flush()
            self._idx = open(base + ".idx", "a+b")
            self.nm = self._fresh_nm()

    def _fresh_nm(self):
        if self.needle_map_kind == "ldb":
            from seaweedfs_tpu_torch.storage.needle_map_disk import LdbNeedleMap
            return LdbNeedleMap(self.file_name() + ".ldb",
                                offset_bytes=self.offset_bytes)
        return CompactMap()

    # ---- naming ----
    def file_name(self) -> str:
        name = str(self.id) if not self.collection else \
            f"{self.collection}_{self.id}"
        return os.path.join(self.directory, name)

    @property
    def version(self) -> int:
        return self.super_block.version

    # ---- load ----
    def _load(self):
        base = self.file_name()
        self._backend = None
        if not os.path.exists(base + ".dat"):
            # cloud-tiered: the .dat lives on a remote tier recorded in
            # the .vif sidecar (reference volume_tier.go LoadedVolume)
            from seaweedfs_tpu_torch.storage.backend import open_backend_for_volume
            self._backend = open_backend_for_volume(base)
            self._dat = None
            self.read_only = True
            head = self._backend.read_at(0, super_block_probe_len())
        else:
            self._dat = open(base + ".dat", "r+b")
            self._dat.seek(0)
            head = self._dat.read(super_block_probe_len())
            from seaweedfs_tpu_torch.storage.backend import load_volume_info
            if "remote" in load_volume_info(base):
                # tiered with keep_local: the remote copy would silently
                # go stale if this replica kept accepting writes
                self.read_only = True
        self.super_block = SuperBlock.parse(head)
        # the superblock marker is authoritative for offset width — a
        # caller-supplied width that disagrees would mis-stride the .idx
        self.offset_bytes = (5 if self.super_block.extra
                             == self._WIDE_OFFSET_MARKER else 4)
        self._idx = open(base + ".idx", "a+b")
        if self.needle_map_kind == "ldb":
            from seaweedfs_tpu_torch.storage.needle_map_disk import LdbNeedleMap
            self.nm = LdbNeedleMap(base + ".ldb", idx_path=base + ".idx",
                                   offset_bytes=self.offset_bytes)
        elif self.needle_map_kind == "sorted":
            from seaweedfs_tpu_torch.storage.needle_map_disk import \
                SortedFileNeedleMap
            # reuse an up-to-date .sdx: rebuilding would both redo O(n)
            # work and resurrect needles tombstoned in-place in the .sdx
            sdx, idxp = base + ".sdx", base + ".idx"
            if os.path.exists(sdx) and \
                    os.path.getmtime(sdx) >= os.path.getmtime(idxp):
                self.nm = SortedFileNeedleMap(
                    sdx, offset_bytes=self.offset_bytes)
            else:
                self.nm = SortedFileNeedleMap.build_from_idx(
                    idxp, sdx, offset_bytes=self.offset_bytes)
        else:
            self.nm = CompactMap()
            if os.path.exists(base + ".idx"):
                def visit(key, off, size):
                    if off != 0 and size != t.TOMBSTONE_FILE_SIZE:
                        self.nm.set(key, off, size)
                        self.nm.file_count += 1
                    elif self.nm.delete(key):
                        self.nm.deleted_count += 1
                idxmod.walk_index_file(base + ".idx", visit,
                                       offset_bytes=self.offset_bytes)

    def live_entries(self) -> list[tuple[int, int]]:
        """Thread-safe (key, size) snapshot of live needles, sorted by
        key — the comparison unit of volume.check.disk."""
        entries: list[tuple[int, int]] = []
        with self._lock:
            self.nm.ascending_visit(
                lambda k, o, s: entries.append((k, s)) if s > 0 else None)
        entries.sort()
        return entries

    # ---- write ----
    def write_needle(self, n: Needle) -> int:
        """Append; returns stored size (reference volume_write.go:109-162).
        """
        with self._lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read only")
            if not n.append_at_ns:
                n.append_at_ns = time.time_ns()
            self._dat.seek(0, os.SEEK_END)
            offset = self._dat.tell()
            if offset % t.NEEDLE_PADDING_SIZE != 0:
                offset += (-offset) % t.NEEDLE_PADDING_SIZE
                self._dat.seek(offset)
            if offset >= t.max_volume_size(self.offset_bytes):
                raise IOError(f"volume {self.id} exceeds max size")
            rec = n.to_bytes(self.version)
            self._dat.write(rec)
            self.last_append_at_ns = n.append_at_ns
            off_units = t.actual_to_offset(offset)
            self.nm.set(n.id, off_units, n.size)
            self._idx.write(t.pack_entry(n.id, off_units, n.size,
                                         self.offset_bytes))
            self._appended_seq += 1
            seq = self._appended_seq
        # push both appends to the OS page cache so they survive
        # process death (the Go reference's unbuffered writes do —
        # Python's buffered writers would silently drop them). Done
        # OUTSIDE the append lock via group commit: N concurrent
        # writers share ~1 flush instead of paying one each.
        self._group_commit(seq)
        return n.size

    def _group_commit(self, seq: int) -> None:
        """Make the append with sequence `seq` durable, coalescing with
        concurrent appends. A writer returns once a flush covering its
        sequence has completed; it either (a) finds one already done,
        (b) waits for the in-progress flush if that flush will cover it
        (the leader flushes everything appended before it starts), or
        (c) becomes the leader itself. The leader re-takes the append
        lock for the flush so a flush never runs concurrently with a
        buffered write (BufferedRandom is not thread-safe), but waiters
        never hold it — so appends keep landing while a flush is in
        flight, which is exactly what the next batch coalesces."""
        with self._flush_cond:
            while True:
                if self._flushed_seq >= seq:
                    self.commit_waits += 1
                    return
                if not self._flush_leader:
                    self._flush_leader = True
                    break
                # a flush is in flight; it may or may not cover seq —
                # re-check when it finishes
                self._flush_cond.wait()
        covered = None
        try:
            t0 = clockctl.monotonic()
            with self._lock:
                high = self._appended_seq
                self._dat.flush()
                self._idx.flush()
                if self._fsync:
                    os.fsync(self._dat.fileno())
                    os.fsync(self._idx.fileno())
                covered = high  # only on flush success
            self.flush_s += clockctl.monotonic() - t0
        finally:
            with self._flush_cond:
                self._flush_leader = False
                if covered is not None:
                    self._flushed_seq = max(self._flushed_seq, covered)
                    self.flush_count += 1
                self._flush_cond.notify_all()

    # ---- read ----
    def read_needle(self, needle_id: int, cookie: Optional[int] = None,
                    check_crc: bool = True) -> Needle:
        with self._lock:
            nv = self.nm.get(needle_id)
            if nv is None:
                raise NotFoundError(f"needle {needle_id:x} not found")
            off_units, size = nv
            if not t.size_is_valid(size):
                raise DeletedError(f"needle {needle_id:x} deleted")
            blob = self._read_at(t.offset_to_actual(off_units),
                                 t.get_actual_size(size, self.version))
        n = Needle.from_bytes(blob, size, self.version, check_crc)
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatchError(
                f"cookie mismatch for needle {needle_id:x}")
        return n

    def read_needle_descriptor(self, needle_id: int,
                               cookie: Optional[int] = None):
        """Zero-copy read: locate the needle and hand back
        ``(needle_meta, fd, payload_offset, data_size)`` instead of
        materialized bytes — the payload stays on disk for the caller
        to ``os.sendfile``. Only the record's head (header + data_size)
        and tail (flags/metadata + crc [+ append_at_ns]) are read; the
        needle_meta carries every field EXCEPT ``data``, with
        ``checksum`` set to the STORED crc (identical to the computed
        one for locally written records).

        The fd is ``os.dup``'d from the volume's .dat under the volume
        lock — the caller owns it and must close it (a compaction
        that replaces the .dat mid-send leaves the dup pinned to the
        pre-compaction inode: a consistent snapshot). Returns None when
        this volume can't serve descriptors (tiered backend, v1
        records) so callers fall back to the buffered path; raises the
        same NotFound/Deleted/CookieMismatch errors as read_needle."""
        with self._lock:
            nv = self.nm.get(needle_id)
            if nv is None:
                raise NotFoundError(f"needle {needle_id:x} not found")
            off_units, size = nv
            if not t.size_is_valid(size):
                raise DeletedError(f"needle {needle_id:x} deleted")
            if self._backend is not None or self.version == 1 \
                    or size <= 0:
                return None
            actual_off = t.offset_to_actual(off_units)
            # pending buffered appends are invisible to the raw fd
            # until flushed; reads through self._dat don't need this
            # (seek flushes), sendfile does
            self._dat.flush()
            head = self._read_at(actual_off, t.NEEDLE_HEADER_SIZE + 4)
            n = Needle.parse_header(head)
            if n.size != size:
                raise SizeMismatchError(
                    f"found size {n.size}, expected {size} "
                    f"(id {needle_id:x})")
            data_size, = struct.unpack_from(">I", head,
                                            t.NEEDLE_HEADER_SIZE)
            if data_size + 4 > size:
                return None  # malformed body: buffered path reports it
            tail_rel = t.NEEDLE_HEADER_SIZE + 4 + data_size
            body_tail_len = size - 4 - data_size
            tail_len = body_tail_len + t.NEEDLE_CHECKSUM_SIZE + \
                (8 if self.version == 3 else 0)
            tail = self._read_at(actual_off + tail_rel, tail_len)
            n.parse_body_tail(tail[:body_tail_len])
            n.checksum, = struct.unpack_from(">I", tail, body_tail_len)
            if self.version == 3:
                n.append_at_ns, = struct.unpack_from(
                    ">Q", tail, body_tail_len + t.NEEDLE_CHECKSUM_SIZE)
            fd = os.dup(self._dat.fileno())
        if cookie is not None and n.cookie != cookie:
            os.close(fd)
            raise CookieMismatchError(
                f"cookie mismatch for needle {needle_id:x}")
        payload_off = actual_off + t.NEEDLE_HEADER_SIZE + 4
        return n, fd, payload_off, data_size

    def read_needle_blob(self, needle_id: int) -> tuple[bytes, int]:
        """Raw on-disk record bytes + stored size — the lossless transfer
        unit for replica repair (reference readSourceNeedleBlob,
        command_volume_check_disk.go)."""
        with self._lock:
            nv = self.nm.get(needle_id)
            if nv is None:
                raise NotFoundError(f"needle {needle_id:x} not found")
            off_units, size = nv
            if not t.size_is_valid(size):
                raise DeletedError(f"needle {needle_id:x} deleted")
            return self._read_at(
                t.offset_to_actual(off_units),
                t.get_actual_size(size, self.version)), size

    def write_needle_blob(self, blob: bytes, size: int) -> None:
        """Append a record copied verbatim from a peer replica (every
        field — name/mime/flags/ttl/cookie — preserved)."""
        n = Needle.from_bytes(blob, size, self.version)
        self.write_needle(n)

    def _read_at(self, offset: int, length: int) -> bytes:
        if self._backend is not None:
            return self._backend.read_at(offset, length)
        self._dat.seek(offset)
        return self._dat.read(length)

    def has_needle(self, needle_id: int) -> bool:
        return self.nm.get(needle_id) is not None

    # ---- delete ----
    def delete_needle(self, needle_id: int, cookie: Optional[int] = None) -> int:
        """Append a deletion record + tombstone the index
        (reference volume_write.go doDeleteRequest:211-231). Returns the
        freed size (0 if absent)."""
        with self._lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read only")
            nv = self.nm.get(needle_id)
            if nv is None or not t.size_is_valid(nv[1]):
                return 0
            if cookie is not None:
                existing = self.read_needle(needle_id, cookie)
                del existing
            size = nv[1]
            n = Needle(id=needle_id, cookie=cookie or 0)
            n.append_at_ns = time.time_ns()
            self._dat.seek(0, os.SEEK_END)
            self._dat.write(n.to_bytes(self.version))
            self.nm.delete(needle_id)
            self.nm.deleted_count += 1
            self.nm.deleted_bytes += size
            self._idx.write(t.pack_entry(needle_id, 0, t.TOMBSTONE_FILE_SIZE,
                                         self.offset_bytes))
            self._appended_seq += 1
            seq = self._appended_seq
        self._group_commit(seq)
        return size

    # ---- stats ----
    def content_size(self) -> int:
        # MUST hold the lock: the heartbeat thread calls this while
        # readers seek the same shared handle — an unlocked seek here
        # lands a concurrent read at EOF (observed as empty-buffer
        # parse failures under benchmark load)
        with self._lock:
            if self._backend is not None:
                return self._backend.size()
            self._dat.seek(0, os.SEEK_END)
            return self._dat.tell()

    @property
    def is_tiered(self) -> bool:
        return self._backend is not None

    # ---- cloud tier (reference volume_tier.go, volume_grpc_tier_*.go) --
    def tier_to(self, endpoint: str, bucket: str,
                keep_local: bool = False,
                key: Optional[str] = None) -> dict:
        """Seal and move the .dat to an S3-compatible tier; keep serving
        reads through it. ``key`` overrides the object key — replicas of
        the same volume MUST use distinct keys (they compact
        independently, so their .dat files need not be byte-identical;
        a shared key would let one replica's upload invalidate
        another's verified copy)."""
        from seaweedfs_tpu_torch.storage.backend import tier_volume_to_s3
        with self._lock:
            if self._backend is not None:
                raise ValueError(f"volume {self.id} is already tiered")
            if self.is_compacting:
                # tiering closes/replaces the .dat the copy phase is
                # reading from
                raise RuntimeError(
                    f"volume {self.id} is compacting; retry later")
            prev_read_only = self.read_only
            self.read_only = True
            self.sync()
            self._dat.close()
            try:
                info = tier_volume_to_s3(self.file_name(), endpoint,
                                         bucket, keep_local=keep_local,
                                         key=key)
            except BaseException:
                # a failed upload/verify leaves the local .dat intact
                # (tier_volume_to_s3 only removes it post-verify) —
                # reopen it so a transient tier-endpoint outage never
                # turns a healthy local volume unreadable
                self._dat = open(self.file_name() + ".dat", "r+b")
                self.read_only = prev_read_only
                raise
            if keep_local:
                self._dat = open(self.file_name() + ".dat", "r+b")
            else:
                from seaweedfs_tpu_torch.storage.backend import \
                    open_backend_for_volume
                self._dat = None
                self._backend = open_backend_for_volume(self.file_name())
            return info

    def untier(self) -> None:
        """Pull the .dat back from the tier, verify it against the
        size + chained crc32c recorded at demotion, then serve locally
        again (reference volume_grpc_tier_download.go). A failed
        verify leaves the volume tiered and the remote copy intact —
        promotion never installs corrupt bytes.

        The download streams to .dat.tmp WITHOUT the volume lock —
        reads keep serving through the cloud backend while gigabytes
        come down; the lock is only taken for the verify-passed
        rename + state swap. .dat.tmp is removed on any failure."""
        from seaweedfs_tpu_torch.storage.backend import (file_crc32c,
                                                   load_volume_info,
                                                   save_volume_info)
        with self._lock:
            if self._backend is None:
                raise ValueError(f"volume {self.id} is not tiered")
            if self._untiering:
                raise RuntimeError(
                    f"volume {self.id} is already untiering")
            self._untiering = True
            backend = self._backend
        base = self.file_name()
        tmp = base + ".dat.tmp"
        try:
            size = backend.size()
            with open(tmp, "wb") as f:
                step = 64 * 1024 * 1024
                for off in range(0, size, step):
                    f.write(backend.read_at(off, min(step, size - off)))
            remote = load_volume_info(base).get("remote", {})
            if "size" in remote and \
                    os.path.getsize(tmp) != remote["size"]:
                raise IOError(
                    f"untier verify: size mismatch on volume {self.id}")
            if "crc32c" in remote and \
                    file_crc32c(tmp) != remote["crc32c"]:
                raise IOError(
                    f"untier verify: crc mismatch on volume {self.id}")
            with self._lock:
                os.rename(tmp, base + ".dat")
                info = load_volume_info(base)
                info.pop("remote", None)
                save_volume_info(base, info)
                self._backend = None
                self._dat = open(base + ".dat", "r+b")
                self.read_only = self.needle_map_kind == "sorted"
        finally:
            self._untiering = False
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def file_count(self) -> int:
        return len(self.nm)

    def deleted_count(self) -> int:
        return self.nm.deleted_count

    def deleted_bytes(self) -> int:
        return self.nm.deleted_bytes

    # ---- vacuum (Compact2-style: copy live needles) ----
    def garbage_level(self) -> float:
        size = self.content_size()
        if size <= 8:
            return 0.0
        return self.nm.deleted_bytes / size

    def compact(self) -> None:
        """Rewrite live needles to .cpd/.cpx then atomically commit
        (reference volume_vacuum.go Compact2/CommitCompact).

        The bulk copy runs WITHOUT the volume lock — reads and writes
        keep serving while gigabytes stream to the compact files (the
        lock is taken per-snapshot and per-record-read only). Changes
        that land during the copy are replayed as a tail delta inside
        the brief commit lock (the reference's makeupDiff)."""
        with self._lock:
            if self._backend is not None:
                raise ValueError(
                    f"volume {self.id} is cloud-tiered; download it first")
            if self.is_compacting:
                # two interleaved compactions would truncate each
                # other's .cpd mid-copy and commit a corrupt volume
                raise RuntimeError(
                    f"volume {self.id} is already compacting")
            self.is_compacting = True
        try:
            base = self.file_name()
            new_sb = SuperBlock(
                version=self.super_block.version,
                replica_placement=self.super_block.replica_placement,
                ttl=self.super_block.ttl,
                compaction_revision=self.super_block.compaction_revision + 1,
                extra=self.super_block.extra)
            with open(base + ".cpd", "wb") as dat, \
                    open(base + ".cpx", "wb") as idxf:
                dat.write(new_sb.to_bytes())
                # snapshot the live map, then copy WITHOUT the lock
                # held across the loop: each record read re-takes it
                # briefly (concurrent writers/readers interleave)
                snapshot: dict[int, tuple[int, int]] = {}
                with self._lock:
                    self.nm.ascending_visit(
                        lambda k, o, s: snapshot.__setitem__(k, (o, s))
                        if t.size_is_valid(s) else None)
                for key, (off_units, size) in snapshot.items():
                    with self._lock:
                        blob = self._read_at(
                            t.offset_to_actual(off_units),
                            t.get_actual_size(size, self.version))
                    self._append_compact_record(dat, idxf, key, size,
                                                blob)
            with self._lock:
                if self._dat is None:
                    raise RuntimeError(
                        f"volume {self.id} was closed during compact")
                # tail delta: anything created/changed/deleted since
                # the snapshot gets replayed onto the compact files
                self._replay_compact_delta(base, snapshot)
                self._dat.close()
                self._idx.close()
                self._close_nm()
                if self.needle_map_kind == "ldb":
                    # compaction permutes offsets even when the new .idx
                    # is the same size — a stale watermark would keep
                    # pre-compact offsets; force a full rebuild
                    import shutil
                    shutil.rmtree(base + ".ldb", ignore_errors=True)
                os.replace(base + ".cpd", base + ".dat")
                os.replace(base + ".cpx", base + ".idx")
                self._load()
                # the delta may have replayed duplicate keys /
                # tombstones into the new .idx; the map resolved them,
                # so re-derive the stats from the resolved state
                self.nm.file_count = len(self.nm)
        except BaseException:
            for ext in (".cpd", ".cpx"):
                try:
                    os.remove(base + ext)
                except OSError:
                    pass
            raise
        finally:
            self.is_compacting = False

    def _append_compact_record(self, dat, idxf, key: int, size: int,
                               blob: bytes) -> None:
        # records are 8-byte aligned; the superblock may end unaligned
        # (wide-offset marker extra bytes)
        pad = (-dat.tell()) % t.NEEDLE_PADDING_SIZE
        if pad:
            dat.write(b"\0" * pad)
        new_off = dat.tell()
        dat.write(blob)
        idxf.write(t.pack_entry(key, t.actual_to_offset(new_off), size,
                                self.offset_bytes))

    def _replay_compact_delta(self, base: str,
                              snapshot: dict[int, tuple[int, int]]
                              ) -> None:
        """Called under the lock at commit time: diff the LIVE needle
        map against the copy-phase snapshot and append the difference
        to .cpd/.cpx — new/overwritten needles copied, deletions
        tombstoned (reference volume_vacuum.go makeupDiff)."""
        live: dict[int, tuple[int, int]] = {}
        self.nm.ascending_visit(
            lambda k, o, s: live.__setitem__(k, (o, s)))
        changed = [(k, os_) for k, os_ in live.items()
                   if t.size_is_valid(os_[1]) and snapshot.get(k) != os_]
        deleted = [k for k in snapshot if k not in live
                   or not t.size_is_valid(live[k][1])]
        if not changed and not deleted:
            return
        with open(base + ".cpd", "ab") as dat, \
                open(base + ".cpx", "ab") as idxf:
            for key, (off_units, size) in sorted(changed):
                blob = self._read_at(t.offset_to_actual(off_units),
                                     t.get_actual_size(size,
                                                       self.version))
                self._append_compact_record(dat, idxf, key, size, blob)
            for key in sorted(deleted):
                # idx replay treats a tombstone entry as a delete
                idxf.write(t.pack_entry(key, 0, t.TOMBSTONE_FILE_SIZE,
                                        self.offset_bytes))

    # ---- integrity ----
    # reference volume_checking.go expired()/expiredLongEnough(): a TTL
    # volume dies WHOLE once its newest write is older than the TTL
    MAX_TTL_REMOVAL_DELAY_SEC = 10 * 60

    def _last_activity_sec(self) -> float:
        if self.last_append_at_ns:
            return self.last_append_at_ns / 1e9
        # no in-process write yet: the .dat mtime (replica copies
        # preserve the source's, see _admin_copy_volume), else the
        # .vif for cloud-tiered volumes (tiering was the last
        # activity), else now (brand-new empty volume)
        for ext in (".dat", ".vif"):
            try:
                return os.stat(self.file_name() + ext).st_mtime
            except OSError:
                continue
        return time.time()  # an absolute epoch, like st_mtime

    def is_expired(self) -> bool:
        ttl_sec = self.super_block.ttl.minutes * 60
        if ttl_sec == 0:
            return False
        # absolute epochs (st_mtime), not a behavioural clock
        return time.time() > self._last_activity_sec() + ttl_sec

    def is_expired_long_enough(self) -> bool:
        """Expired plus a removal grace of 10% of the TTL capped at
        10min (reference volume.go expiredLongEnough: ttl/10, max
        MAX_TTL_VOLUME_REMOVAL_DELAY) so replicas converge before any
        copy disappears."""
        ttl_sec = self.super_block.ttl.minutes * 60
        if ttl_sec == 0:
            return False
        grace = min(ttl_sec // 10, self.MAX_TTL_REMOVAL_DELAY_SEC)
        # absolute epochs (st_mtime), not a behavioural clock
        return time.time() > self._last_activity_sec() + ttl_sec + grace

    def check_integrity(self) -> bool:
        """Verify the last index entry points at a well-formed needle
        (reference volume_checking.go CheckAndFixVolumeDataIntegrity)."""
        base = self.file_name()
        idx_size = os.path.getsize(base + ".idx")
        if idx_size == 0:
            return True
        esize = t.entry_size(self.offset_bytes)
        with open(base + ".idx", "rb") as f:
            f.seek(idx_size - esize)
            key, off, size = t.unpack_entry(f.read(esize), 0,
                                            self.offset_bytes)
        if off == 0 or size == t.TOMBSTONE_FILE_SIZE:
            return True
        try:
            blob = self._read_at(t.offset_to_actual(off),
                                 t.get_actual_size(size, self.version))
            n = Needle.from_bytes(blob, size, self.version)
            return n.id == key
        except Exception:
            return False

    def sync(self) -> None:
        with self._lock:
            if self._dat is not None:
                self._dat.flush()
                os.fsync(self._dat.fileno())
            self._idx.flush()
            os.fsync(self._idx.fileno())

    def configure_replication(self, replication: str) -> None:
        """Rewrite the superblock's replica placement in place
        (reference volume_super_block.go MaybeWriteSuperBlock /
        shell command_volume_configure_replication.go): only byte 1 of
        the 8-byte header changes."""
        with self._lock:
            if self._backend is not None:
                raise PermissionError("tiered volume is read-only")
            self.super_block.replica_placement = \
                ReplicaPlacement.parse(replication)
            self._dat.flush()
            pos = self._dat.tell()
            self._dat.seek(0)
            self._dat.write(self.super_block.to_bytes()
                            [:8])  # fixed header only, extra untouched
            self._dat.flush()
            self._dat.seek(pos)

    def _close_nm(self) -> None:
        close = getattr(self.nm, "close", None)
        if close is not None:
            if hasattr(self.nm, "mark_watermark") and \
                    os.path.exists(self.file_name() + ".idx"):
                self.nm.mark_watermark(self.file_name() + ".idx")
            close()

    def close(self) -> None:
        with self._lock:
            try:
                if self._dat is not None:
                    self._dat.flush()
                self._idx.flush()
            finally:
                if self._dat is not None:
                    self._dat.close()
                self._idx.close()
                self._close_nm()

    def destroy(self) -> None:
        self.close()
        base = self.file_name()
        exts = [".dat", ".idx", ".vif", ".note", ".sdx"]
        if os.path.exists(base + ".ecx"):
            # the volume was EC-encoded: the .vif now belongs to the EC
            # volume — it persists the CodeSpec that picks the coder for
            # a mixed-code store, so deleting the source .dat must not
            # take it along
            exts.remove(".vif")
        for ext in exts:
            if os.path.exists(base + ext):
                os.remove(base + ext)
        if os.path.isdir(base + ".ldb"):
            import shutil
            shutil.rmtree(base + ".ldb", ignore_errors=True)


def super_block_probe_len() -> int:
    return 8 + 65536  # superblock + max extra
