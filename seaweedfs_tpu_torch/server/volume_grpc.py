"""gRPC plane for the volume server (reference weed/pb/volume_server.proto).

Serves the admin RPC surface — allocation, vacuum, copy, tiering, the nine
EC RPCs, streaming CopyFile/VolumeEcShardRead, and BatchDelete — over
grpc generic method handlers (same pattern as server/master_grpc.py). The
unary RPCs dispatch in-process to the SAME handler bodies the HTTP admin
plane uses (via LocalRequest), so both wires share one implementation;
streams read files/shards in chunks directly.

Runs next to the HTTP plane: the public data path (GET/POST /fid) stays
HTTP like the reference, the control plane can speak either.

The port's copy of seaweedfs_tpu/server/volume_grpc.py, over its own copy
of pb/volume_server_pb2.py. VolumeEcShardsGenerate and
VolumeEcShardsRebuild run the volume server's own handlers, so they reach
the server's coder on the card (the pipelined encoder, K1) from a gRPC
worker thread. It imports nothing of that package.
"""

from __future__ import annotations

import json
import os
from concurrent import futures
from typing import Iterator

import grpc

from seaweedfs_tpu_torch.pb import volume_server_pb2 as pb
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.volume import DeletedError, NotFoundError
from seaweedfs_tpu_torch.utils.httpd import LocalRequest

SERVICE = "weedtpu_volume_server_pb.VolumeServer"
STREAM_CHUNK = 256 * 1024


class _RpcError(Exception):
    def __init__(self, code: grpc.StatusCode, msg: str):
        super().__init__(msg)
        self.code = code
        self.msg = msg


def _check(resp) -> dict:
    """Unwrap a handler Response; map HTTP-ish errors to grpc codes."""
    body = json.loads(resp.body) if resp.body else {}
    if resp.status >= 400:
        code = (grpc.StatusCode.NOT_FOUND if resp.status == 404
                else grpc.StatusCode.INVALID_ARGUMENT if resp.status == 400
                else grpc.StatusCode.INTERNAL)
        raise _RpcError(code, body.get("error", f"status {resp.status}"))
    return body


def _guard(fn):
    def wrapped(self, request, context):
        try:
            return fn(self, request, context)
        except _RpcError as e:
            context.abort(e.code, e.msg)
        except FileNotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:  # surface the message, not a hung stream
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
    return wrapped


class VolumeGrpc:
    def __init__(self, vs):
        self.vs = vs

    # ---- unary RPCs via the shared handler bodies ----
    @_guard
    def allocate_volume(self, request, context):
        _check(self.vs._admin_allocate_volume(LocalRequest({
            "volume_id": request.volume_id,
            "collection": request.collection,
            "replication": request.replication or "000",
            "ttl": request.ttl})))
        return pb.AllocateVolumeResponse()

    @_guard
    def volume_delete(self, request, context):
        body = _check(self.vs._admin_delete_volume(
            LocalRequest({"volume_id": request.volume_id})))
        return pb.VolumeDeleteResponse(deleted=bool(body.get("deleted")))

    @_guard
    def volume_mark_readonly(self, request, context):
        _check(self.vs._admin_mark_readonly(LocalRequest(
            {"volume_id": request.volume_id,
             "read_only": request.read_only})))
        return pb.VolumeMarkReadonlyResponse()

    @_guard
    def volume_mount(self, request, context):
        _check(self.vs._admin_mount_volume(
            LocalRequest({"volume_id": request.volume_id})))
        return pb.VolumeMountResponse()

    @_guard
    def volume_unmount(self, request, context):
        _check(self.vs._admin_unmount_volume(
            LocalRequest({"volume_id": request.volume_id})))
        return pb.VolumeUnmountResponse()

    @_guard
    def volume_configure(self, request, context):
        _check(self.vs._admin_configure_replication(
            LocalRequest({"volume_id": request.volume_id,
                          "replication": request.replication})))
        return pb.VolumeConfigureResponse()

    @_guard
    def vacuum_volume_check(self, request, context):
        body = _check(self.vs._admin_vacuum(LocalRequest(
            {"volume_id": request.volume_id, "check_only": True})))
        return pb.VacuumVolumeCheckResponse(
            garbage_ratio=body.get("garbage_ratio", 0.0))

    @_guard
    def vacuum_volume_compact(self, request, context):
        body = _check(self.vs._admin_vacuum(LocalRequest(
            {"volume_id": request.volume_id})))
        return pb.VacuumVolumeCompactResponse(
            garbage_ratio=body.get("garbage_ratio", 0.0),
            compacted=bool(body.get("compacted")))

    @_guard
    def volume_sync(self, request, context):
        _check(self.vs._admin_sync(LocalRequest(
            {"volume_id": request.volume_id})))
        return pb.VolumeSyncResponse()

    @_guard
    def volume_copy(self, request, context):
        _check(self.vs._admin_copy_volume(LocalRequest(
            {"volume_id": request.volume_id,
             "source_data_node": request.source_data_node,
             "collection": request.collection})))
        return pb.VolumeCopyResponse()

    @_guard
    def volume_tier_to_remote(self, request, context):
        body = _check(self.vs._admin_tier_upload(LocalRequest(
            {"volume_id": request.volume_id,
             "endpoint": request.destination_backend_name,
             "bucket": request.bucket,
             "keep_local": request.keep_local_dat_file})))
        return pb.VolumeTierMoveDatToRemoteResponse(
            remote_key=str(body.get("remote", "")))

    @_guard
    def volume_tier_from_remote(self, request, context):
        _check(self.vs._admin_tier_download(LocalRequest(
            {"volume_id": request.volume_id})))
        return pb.VolumeTierMoveDatFromRemoteResponse()

    @_guard
    def volume_digest(self, request, context):
        body = _check(self.vs._admin_volume_digest(LocalRequest(
            query={"volumeId": str(request.volume_id)}, method="GET")))
        resp = pb.VolumeDigestResponse(file_count=body["file_count"],
                                       digest=body["digest"])
        for key, size in body.get("keys", []):
            resp.keys.add(key=key, size=size)
        return resp

    @_guard
    def read_needle_blob(self, request, context):
        v = self.vs.store.find_volume(request.volume_id)
        if v is None:
            raise _RpcError(grpc.StatusCode.NOT_FOUND, "volume not found")
        blob, size = v.read_needle_blob(request.needle_id)
        return pb.ReadNeedleBlobResponse(needle_blob=blob, size=size)

    @_guard
    def write_needle_blob(self, request, context):
        _check(self.vs._admin_write_needle_blob(LocalRequest(
            {"volume_id": request.volume_id, "key": request.needle_id,
             "size": request.size,
             "blob": request.needle_blob.hex()})))
        return pb.WriteNeedleBlobResponse()

    @_guard
    def batch_delete(self, request, context):
        """Reference volume_grpc_batch_delete.go: local deletes only (no
        replica fan-out — the caller addresses each replica)."""
        resp = pb.BatchDeleteResponse()
        for fid in request.file_ids:
            r = resp.results.add(file_id=fid)
            try:
                f = FileId.parse(fid)
            except (ValueError, KeyError):
                r.status, r.error = 400, "malformed file id"
                continue
            try:
                cookie = None if request.skip_cookie_check else f.cookie
                size = self.vs.store.delete_volume_needle(
                    f.volume_id, f.key, cookie)
                r.status, r.size = 202, size
            except (NotFoundError, DeletedError) as e:
                r.status, r.error = 404, str(e) or "not found"
            except PermissionError as e:
                r.status, r.error = 403, str(e)
            except Exception as e:
                r.status, r.error = 500, f"{type(e).__name__}: {e}"
        return resp

    @_guard
    def volume_server_status(self, request, context):
        resp = pb.VolumeServerStatusResponse(version="seaweedfs-tpu")
        for loc in self.vs.store.locations:
            for v in loc.volumes.values():
                resp.volumes.add(id=v.id, collection=v.collection,
                                 file_count=v.nm.file_count,
                                 size=v.content_size(),
                                 read_only=v.read_only)
        return resp

    # ---- EC unary RPCs ----
    @_guard
    def ec_generate(self, request, context):
        # gRPC plane always takes the pipelined encoder (overlapped
        # I/O + compute; serial is reachable via the HTTP admin flag)
        body = _check(self.vs._ec_generate(LocalRequest(
            {"volume_id": request.volume_id,
             "collection": request.collection,
             "pipelined": True})))
        return pb.VolumeEcShardsGenerateResponse(base=body.get("base", ""))

    @_guard
    def ec_rebuild(self, request, context):
        body = _check(self.vs._ec_rebuild(LocalRequest(
            {"volume_id": request.volume_id,
             "collection": request.collection,
             "pipelined": True})))
        return pb.VolumeEcShardsRebuildResponse(
            rebuilt_shard_ids=body.get("rebuilt_shard_ids", []))

    @_guard
    def ec_copy(self, request, context):
        _check(self.vs._ec_copy(LocalRequest(
            {"volume_id": request.volume_id,
             "collection": request.collection,
             "shard_ids": list(request.shard_ids),
             "copy_ecx_file": request.copy_ecx_file,
             "source_data_node": request.source_data_node})))
        return pb.VolumeEcShardsCopyResponse()

    @_guard
    def ec_delete(self, request, context):
        _check(self.vs._ec_delete_shards(LocalRequest(
            {"volume_id": request.volume_id,
             "collection": request.collection,
             "shard_ids": list(request.shard_ids)})))
        return pb.VolumeEcShardsDeleteResponse()

    @_guard
    def ec_mount(self, request, context):
        _check(self.vs._ec_mount(LocalRequest(
            {"volume_id": request.volume_id,
             "collection": request.collection,
             "shard_ids": list(request.shard_ids)})))
        return pb.VolumeEcShardsMountResponse()

    @_guard
    def ec_unmount(self, request, context):
        _check(self.vs._ec_unmount(LocalRequest(
            {"volume_id": request.volume_id,
             "shard_ids": list(request.shard_ids)})))
        return pb.VolumeEcShardsUnmountResponse()

    @_guard
    def ec_blob_delete(self, request, context):
        _check(self.vs._ec_blob_delete(LocalRequest(
            {"volume_id": request.volume_id,
             "collection": request.collection,
             "needle_id": request.file_key})))
        return pb.VolumeEcBlobDeleteResponse()

    @_guard
    def ec_to_volume(self, request, context):
        _check(self.vs._ec_to_volume(LocalRequest(
            {"volume_id": request.volume_id,
             "collection": request.collection})))
        return pb.VolumeEcShardsToVolumeResponse()

    # ---- streams ----
    @_guard
    def copy_file(self, request, context) -> Iterator[pb.CopyFileResponse]:
        """Streaming file pull (reference CopyFile): volume .dat/.idx or
        EC shard/index files."""
        if request.is_ec_volume:
            base = self.vs._ec_base_name(request.volume_id,
                                         request.collection)
            path = base + request.ext
        else:
            v = self.vs.store.find_volume(request.volume_id)
            if v is None:
                raise _RpcError(grpc.StatusCode.NOT_FOUND,
                                "volume not found")
            if request.ext not in (".dat", ".idx"):
                raise _RpcError(grpc.StatusCode.INVALID_ARGUMENT, "bad ext")
            v.sync()
            path = v.file_name() + request.ext
        if not os.path.exists(path):
            raise _RpcError(grpc.StatusCode.NOT_FOUND, path)
        with open(path, "rb") as f:
            while chunk := f.read(STREAM_CHUNK):
                yield pb.CopyFileResponse(file_content=chunk)

    @_guard
    def ec_shard_read(self, request, context
                      ) -> Iterator[pb.VolumeEcShardReadResponse]:
        ev = self.vs.store.find_ec_volume(request.volume_id)
        if ev is None or request.shard_id not in ev.shards:
            raise _RpcError(grpc.StatusCode.NOT_FOUND, "shard not found")
        if request.file_key and ev.is_deleted(request.file_key):
            yield pb.VolumeEcShardReadResponse(is_deleted=True)
            return
        shard = ev.shards[request.shard_id]
        off, remaining = request.offset, request.size
        while remaining > 0:
            n = min(STREAM_CHUNK, remaining)
            data = shard.read_at(off, n)
            if not data:
                break
            yield pb.VolumeEcShardReadResponse(data=data)
            off += len(data)
            remaining -= len(data)

    # ---- replica catch-up (reference volume_server.proto:31,64;
    # volume_grpc_tail.go) ----
    def _records_since(self, volume_id: int, since_ns: int,
                       normalize_v3: bool = False):
        """Yield (needle, raw_record) for every record appended after
        since_ns, in log order. Deletion records are included — a
        catching-up replica must replay those too.

        The scan is header-only until a record qualifies: for v3 the
        append_at_ns rides at a fixed position (header + size + crc),
        so old records cost one 8-byte pread each instead of a full
        body read — a periodic tail poll is O(records), not O(bytes)
        (the reference seeks from a known offset, volume_grpc_tail.go;
        without one this is the next best).

        normalize_v3 re-serializes v1/v2 records as v3 so the receiving
        side can parse one wire version."""
        from seaweedfs_tpu_torch.storage import types as t
        from seaweedfs_tpu_torch.storage.needle import Needle
        from seaweedfs_tpu_torch.storage.super_block import SuperBlock
        v = self.vs.store.find_volume(volume_id)
        if v is None:
            raise _RpcError(grpc.StatusCode.NOT_FOUND, "volume not found")
        v.sync()
        path = v.file_name() + ".dat"
        size_total = os.path.getsize(path)
        with open(path, "rb") as f:
            import struct
            sb = SuperBlock.parse(f.read(8 + 65536)[:8 + 65536])
            offset = (sb.block_size + t.NEEDLE_PADDING_SIZE - 1) \
                // t.NEEDLE_PADDING_SIZE * t.NEEDLE_PADDING_SIZE
            version = sb.version
            if version < 3 and since_ns > 0:
                # v1/v2 records carry no append timestamp; a cursor'd
                # tail CANNOT be answered — failing loudly beats
                # returning an empty stream the caller reads as
                # "in sync" (use a full VolumeCopy instead)
                raise _RpcError(
                    grpc.StatusCode.FAILED_PRECONDITION,
                    f"volume version {version} has no append_at_ns; "
                    "tail requires since_ns=0 or a full copy")
            fd = f.fileno()
            while offset + t.NEEDLE_HEADER_SIZE <= size_total:
                header = os.pread(fd, t.NEEDLE_HEADER_SIZE, offset)
                if len(header) < t.NEEDLE_HEADER_SIZE:
                    break
                hn = Needle.parse_header(header)
                if hn.size < 0:
                    break
                record_len = t.get_actual_size(hn.size, version)
                if offset + record_len > size_total:
                    break
                ts = 0
                if version == 3:
                    raw_ts = os.pread(
                        fd, t.TIMESTAMP_SIZE,
                        offset + t.NEEDLE_HEADER_SIZE + hn.size
                        + t.NEEDLE_CHECKSUM_SIZE)
                    if len(raw_ts) == t.TIMESTAMP_SIZE:
                        ts, = struct.unpack(">Q", raw_ts)
                if ts > since_ns or (version < 3 and since_ns == 0):
                    blob = os.pread(fd, record_len, offset)
                    try:
                        n = Needle.from_bytes(blob, hn.size, version,
                                              check_crc=False)
                    except Exception:
                        break
                    if normalize_v3 and version != 3:
                        blob = n.to_bytes(3)
                    yield n, blob
                offset += record_len

    @_guard
    def volume_incremental_copy(self, request, context
                                ) -> Iterator["pb.VolumeIncrementalCopyResponse"]:
        buf = bytearray()
        for _, raw in self._records_since(request.volume_id,
                                          request.since_ns):
            buf.extend(raw)
            while len(buf) >= STREAM_CHUNK:
                yield pb.VolumeIncrementalCopyResponse(
                    file_content=bytes(buf[:STREAM_CHUNK]))
                del buf[:STREAM_CHUNK]
        if buf:
            yield pb.VolumeIncrementalCopyResponse(file_content=bytes(buf))

    @_guard
    def volume_tail_sender(self, request, context
                           ) -> Iterator["pb.VolumeTailSenderResponse"]:
        from seaweedfs_tpu_torch.storage import types as t
        for _, raw in self._records_since(request.volume_id,
                                          request.since_ns,
                                          normalize_v3=True):
            header = raw[:t.NEEDLE_HEADER_SIZE]
            body = raw[t.NEEDLE_HEADER_SIZE:]
            # large needles stream in body pieces; the header rides the
            # first message, is_last_chunk closes the record
            first = True
            pos = 0
            while True:
                piece = body[pos:pos + STREAM_CHUNK]
                pos += len(piece)
                last = pos >= len(body)
                yield pb.VolumeTailSenderResponse(
                    needle_header=header if first else b"",
                    needle_body=piece, is_last_chunk=last)
                first = False
                if last:
                    break

    @_guard
    def volume_tail_receiver(self, request, context):
        """Pull a tail FROM a peer and apply it locally — the replica
        catch-up entry point (reference volume_grpc_tail.go
        VolumeTailReceiver)."""
        v = self.vs.store.find_volume(request.volume_id)
        if v is None:
            raise _RpcError(grpc.StatusCode.NOT_FOUND, "volume not found")
        client = GrpcVolumeClient(request.source_volume_server)
        try:
            applied = 0
            for n in client.volume_tail_needles(request.volume_id,
                                                request.since_ns):
                if n.size == 0 and not n.data:
                    v.delete_needle(n.id)
                else:
                    v.write_needle(n)
                applied += 1
            return pb.VolumeTailReceiverResponse()
        finally:
            client.close()

    @_guard
    def read_volume_file_status(self, request, context):
        v = self.vs.store.find_volume(request.volume_id)
        if v is None:
            raise _RpcError(grpc.StatusCode.NOT_FOUND, "volume not found")
        v.sync()
        base = v.file_name()
        resp = pb.ReadVolumeFileStatusResponse(
            volume_id=request.volume_id,
            collection=v.collection,
            file_count=v.file_count(),
            compaction_revision=getattr(v.super_block,
                                        "compaction_revision", 0),
            last_append_at_ns=v.last_append_at_ns)
        for ext, ts_field, size_field in (
                (".idx", "idx_file_timestamp_seconds", "idx_file_size"),
                (".dat", "dat_file_timestamp_seconds", "dat_file_size")):
            try:
                st = os.stat(base + ext)
                setattr(resp, ts_field, int(st.st_mtime))
                setattr(resp, size_field, st.st_size)
            except OSError:
                pass
        return resp

    @_guard
    def volume_needle_status(self, request, context):
        try:
            n = self.vs.store.read_volume_needle(request.volume_id,
                                                 request.needle_id, None)
        except (NotFoundError, DeletedError) as e:
            raise _RpcError(grpc.StatusCode.NOT_FOUND, str(e))
        return pb.VolumeNeedleStatusResponse(
            needle_id=n.id, cookie=n.cookie, size=len(n.data),
            last_modified=n.last_modified, crc=n.checksum,
            ttl=n.ttl.hex() if n.ttl else "")

    def ping(self, request, context):
        import time as _time
        start = _time.time_ns()
        remote = start
        if request.target:
            from seaweedfs_tpu_torch.utils.httpd import http_call
            try:
                http_call("GET", f"http://{request.target}/status",
                          timeout=5)
                remote = _time.time_ns()
            except Exception as e:
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        return pb.PingResponse(start_time_ns=start,
                               remote_time_ns=remote,
                               stop_time_ns=_time.time_ns())

    @_guard
    def query(self, request, context) -> Iterator["pb.QueriedStripe"]:
        """Server-side JSON scan over needles (reference Query rpc +
        weed/query/json): projections/filter run where the data lives,
        only matching rows cross the wire."""
        from seaweedfs_tpu_torch.query.json_query import (Predicate,
                                                    query_json_lines)
        preds = []
        if request.HasField("filter") and request.filter.field:
            val = request.filter.value
            for cast in (int, float):
                try:
                    val = cast(request.filter.value)
                    break
                except ValueError:
                    continue
            preds = [Predicate(request.filter.field,
                               request.filter.operand or "=", val)]
        selections = list(request.selections)
        for fid in request.from_file_ids:
            f = FileId.parse(fid)
            try:
                n = self.vs.store.read_volume_needle(f.volume_id, f.key,
                                                     f.cookie)
            except (NotFoundError, DeletedError):
                continue
            out = []
            for doc in query_json_lines(n.data, selections or None, preds):
                out.append(json.dumps(doc))
            if out:
                yield pb.QueriedStripe(
                    records=("\n".join(out) + "\n").encode())

    # ---- integrity scrub (JSON codec: these RPCs postdate the vendored
    # pb modules, which are not regenerated) ----
    @_guard
    def volume_scrub(self, request, context):
        return _check(self.vs._admin_scrub(LocalRequest(request or {})))

    @_guard
    def scrub_status(self, request, context):
        return _check(self.vs._admin_scrub_status(
            LocalRequest(method="GET", path="/admin/scrub/status")))

    # ---- registration ----
    def handlers(self) -> grpc.GenericRpcHandler:
        def unary(fn, req_cls, resp_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)

        def ustream(fn, req_cls, resp_cls):
            return grpc.unary_stream_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)

        def junary(fn):
            # JSON-bytes codec for RPCs without vendored pb messages
            return grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=lambda raw:
                    json.loads(raw.decode()) if raw else {},
                response_serializer=lambda d: json.dumps(d).encode())

        rpcs = {
            "AllocateVolume": unary(self.allocate_volume,
                                    pb.AllocateVolumeRequest,
                                    pb.AllocateVolumeResponse),
            "VolumeDelete": unary(self.volume_delete,
                                  pb.VolumeDeleteRequest,
                                  pb.VolumeDeleteResponse),
            "VolumeMarkReadonly": unary(self.volume_mark_readonly,
                                        pb.VolumeMarkReadonlyRequest,
                                        pb.VolumeMarkReadonlyResponse),
            "VolumeMount": unary(self.volume_mount,
                                 pb.VolumeMountRequest,
                                 pb.VolumeMountResponse),
            "VolumeUnmount": unary(self.volume_unmount,
                                   pb.VolumeUnmountRequest,
                                   pb.VolumeUnmountResponse),
            "VolumeConfigure": unary(self.volume_configure,
                                     pb.VolumeConfigureRequest,
                                     pb.VolumeConfigureResponse),
            "VacuumVolumeCheck": unary(self.vacuum_volume_check,
                                       pb.VacuumVolumeCheckRequest,
                                       pb.VacuumVolumeCheckResponse),
            "VacuumVolumeCompact": unary(self.vacuum_volume_compact,
                                         pb.VacuumVolumeCompactRequest,
                                         pb.VacuumVolumeCompactResponse),
            "VolumeSync": unary(self.volume_sync, pb.VolumeSyncRequest,
                                pb.VolumeSyncResponse),
            "VolumeCopy": unary(self.volume_copy, pb.VolumeCopyRequest,
                                pb.VolumeCopyResponse),
            "CopyFile": ustream(self.copy_file, pb.CopyFileRequest,
                                pb.CopyFileResponse),
            "VolumeTierMoveDatToRemote": unary(
                self.volume_tier_to_remote,
                pb.VolumeTierMoveDatToRemoteRequest,
                pb.VolumeTierMoveDatToRemoteResponse),
            "VolumeTierMoveDatFromRemote": unary(
                self.volume_tier_from_remote,
                pb.VolumeTierMoveDatFromRemoteRequest,
                pb.VolumeTierMoveDatFromRemoteResponse),
            "VolumeDigest": unary(self.volume_digest,
                                  pb.VolumeDigestRequest,
                                  pb.VolumeDigestResponse),
            "ReadNeedleBlob": unary(self.read_needle_blob,
                                    pb.ReadNeedleBlobRequest,
                                    pb.ReadNeedleBlobResponse),
            "WriteNeedleBlob": unary(self.write_needle_blob,
                                     pb.WriteNeedleBlobRequest,
                                     pb.WriteNeedleBlobResponse),
            "BatchDelete": unary(self.batch_delete, pb.BatchDeleteRequest,
                                 pb.BatchDeleteResponse),
            "VolumeServerStatus": unary(self.volume_server_status,
                                        pb.VolumeServerStatusRequest,
                                        pb.VolumeServerStatusResponse),
            "VolumeEcShardsGenerate": unary(
                self.ec_generate, pb.VolumeEcShardsGenerateRequest,
                pb.VolumeEcShardsGenerateResponse),
            "VolumeEcShardsRebuild": unary(
                self.ec_rebuild, pb.VolumeEcShardsRebuildRequest,
                pb.VolumeEcShardsRebuildResponse),
            "VolumeEcShardsCopy": unary(
                self.ec_copy, pb.VolumeEcShardsCopyRequest,
                pb.VolumeEcShardsCopyResponse),
            "VolumeEcShardsDelete": unary(
                self.ec_delete, pb.VolumeEcShardsDeleteRequest,
                pb.VolumeEcShardsDeleteResponse),
            "VolumeEcShardsMount": unary(
                self.ec_mount, pb.VolumeEcShardsMountRequest,
                pb.VolumeEcShardsMountResponse),
            "VolumeEcShardsUnmount": unary(
                self.ec_unmount, pb.VolumeEcShardsUnmountRequest,
                pb.VolumeEcShardsUnmountResponse),
            "VolumeEcShardRead": ustream(
                self.ec_shard_read, pb.VolumeEcShardReadRequest,
                pb.VolumeEcShardReadResponse),
            "VolumeEcBlobDelete": unary(
                self.ec_blob_delete, pb.VolumeEcBlobDeleteRequest,
                pb.VolumeEcBlobDeleteResponse),
            "VolumeEcShardsToVolume": unary(
                self.ec_to_volume, pb.VolumeEcShardsToVolumeRequest,
                pb.VolumeEcShardsToVolumeResponse),
            "VolumeIncrementalCopy": ustream(
                self.volume_incremental_copy,
                pb.VolumeIncrementalCopyRequest,
                pb.VolumeIncrementalCopyResponse),
            "VolumeTailSender": ustream(
                self.volume_tail_sender, pb.VolumeTailSenderRequest,
                pb.VolumeTailSenderResponse),
            "VolumeTailReceiver": unary(
                self.volume_tail_receiver, pb.VolumeTailReceiverRequest,
                pb.VolumeTailReceiverResponse),
            "ReadVolumeFileStatus": unary(
                self.read_volume_file_status,
                pb.ReadVolumeFileStatusRequest,
                pb.ReadVolumeFileStatusResponse),
            "VolumeNeedleStatus": unary(
                self.volume_needle_status, pb.VolumeNeedleStatusRequest,
                pb.VolumeNeedleStatusResponse),
            "Ping": unary(self.ping, pb.PingRequest, pb.PingResponse),
            "Query": ustream(self.query, pb.QueryRequest,
                             pb.QueriedStripe),
            "VolumeScrub": junary(self.volume_scrub),
            "ScrubStatus": junary(self.scrub_status),
        }
        return grpc.method_handlers_generic_handler(SERVICE, rpcs)


def start_volume_grpc(vs, host: str = "127.0.0.1",
                      port: int = 0, tls="auto") -> tuple[grpc.Server, int]:
    from seaweedfs_tpu_torch.utils import tls as tlsmod
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=32))
    server.add_generic_rpc_handlers((VolumeGrpc(vs).handlers(),))
    cfg = tlsmod.load_tls_config("volume") if tls == "auto" else tls
    if cfg is not None:
        bound = server.add_secure_port(
            f"{host}:{port}", tlsmod.server_credentials(cfg))
    else:
        bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, bound


class GrpcVolumeClient:
    """Typed client for the volume admin plane; also exposes call(path,
    body) with the HTTP-admin path names so the shell applier can use one
    transport-neutral call site."""

    def __init__(self, address: str, tls="auto"):
        from seaweedfs_tpu_torch.utils.tls import make_channel
        self.channel = make_channel(address, role="client", tls=tls)

    def _unary(self, method: str, request, resp_cls,
               timeout: float = 300):
        fn = self.channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)
        return fn(request, timeout=timeout)

    def copy_file(self, volume_id: int, ext: str, collection: str = "",
                  is_ec: bool = False) -> bytes:
        fn = self.channel.unary_stream(
            f"/{SERVICE}/CopyFile",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.CopyFileResponse.FromString)
        out = bytearray()
        for chunk in fn(pb.CopyFileRequest(volume_id=volume_id, ext=ext,
                                           collection=collection,
                                           is_ec_volume=is_ec),
                        timeout=600):
            out += chunk.file_content
        return bytes(out)

    def ec_shard_read(self, volume_id: int, shard_id: int, offset: int,
                      size: int, file_key: int = 0) -> tuple[bytes, bool]:
        fn = self.channel.unary_stream(
            f"/{SERVICE}/VolumeEcShardRead",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.VolumeEcShardReadResponse.FromString)
        out = bytearray()
        for chunk in fn(pb.VolumeEcShardReadRequest(
                volume_id=volume_id, shard_id=shard_id, offset=offset,
                size=size, file_key=file_key), timeout=120):
            if chunk.is_deleted:
                return b"", True
            out += chunk.data
        return bytes(out), False

    def batch_delete(self, file_ids: list[str],
                     skip_cookie_check: bool = False) -> pb.BatchDeleteResponse:
        return self._unary("BatchDelete",
                           pb.BatchDeleteRequest(
                               file_ids=file_ids,
                               skip_cookie_check=skip_cookie_check),
                           pb.BatchDeleteResponse)

    # ---- replica catch-up ----
    def volume_tail_needles(self, volume_id: int, since_ns: int = 0):
        """Iterate needles a peer appended after since_ns (reassembled
        from the VolumeTailSender stream)."""
        from seaweedfs_tpu_torch.storage.needle import Needle
        fn = self.channel.unary_stream(
            f"/{SERVICE}/VolumeTailSender",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.VolumeTailSenderResponse.FromString)
        header = b""
        body = bytearray()
        for msg in fn(pb.VolumeTailSenderRequest(
                volume_id=volume_id, since_ns=since_ns), timeout=600):
            if msg.needle_header:
                header, body = bytes(msg.needle_header), bytearray()
            body += msg.needle_body
            if msg.is_last_chunk:
                raw = header + bytes(body)
                n = Needle.parse_header(header)
                yield Needle.from_bytes(raw, n.size, 3, check_crc=False)
                header, body = b"", bytearray()

    def volume_incremental_copy(self, volume_id: int,
                                since_ns: int = 0) -> bytes:
        """Raw appended record bytes since a timestamp (reference
        VolumeIncrementalCopy: the caller appends them to its .dat)."""
        fn = self.channel.unary_stream(
            f"/{SERVICE}/VolumeIncrementalCopy",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.VolumeIncrementalCopyResponse.FromString)
        out = bytearray()
        for msg in fn(pb.VolumeIncrementalCopyRequest(
                volume_id=volume_id, since_ns=since_ns), timeout=600):
            out += msg.file_content
        return bytes(out)

    def volume_tail_receiver(self, volume_id: int, since_ns: int,
                             source: str) -> None:
        self._unary("VolumeTailReceiver", pb.VolumeTailReceiverRequest(
            volume_id=volume_id, since_ns=since_ns,
            source_volume_server=source), pb.VolumeTailReceiverResponse)

    def read_volume_file_status(self, volume_id: int
                                ) -> pb.ReadVolumeFileStatusResponse:
        return self._unary("ReadVolumeFileStatus",
                           pb.ReadVolumeFileStatusRequest(
                               volume_id=volume_id),
                           pb.ReadVolumeFileStatusResponse)

    def volume_needle_status(self, volume_id: int, needle_id: int
                             ) -> pb.VolumeNeedleStatusResponse:
        return self._unary("VolumeNeedleStatus",
                           pb.VolumeNeedleStatusRequest(
                               volume_id=volume_id, needle_id=needle_id),
                           pb.VolumeNeedleStatusResponse)

    def ping(self, target: str = "", target_type: str = ""
             ) -> pb.PingResponse:
        return self._unary("Ping", pb.PingRequest(
            target=target, target_type=target_type), pb.PingResponse,
            timeout=10)

    def query(self, file_ids: list[str], selections: list[str] = (),
              filter_field: str = "", filter_op: str = "=",
              filter_value: str = "") -> bytes:
        fn = self.channel.unary_stream(
            f"/{SERVICE}/Query",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.QueriedStripe.FromString)
        req = pb.QueryRequest(selections=list(selections),
                              from_file_ids=list(file_ids))
        if filter_field:
            req.filter.field = filter_field
            req.filter.operand = filter_op
            req.filter.value = filter_value
        out = bytearray()
        for stripe in fn(req, timeout=300):
            out += stripe.records
        return bytes(out)

    # HTTP-admin-path compatible dispatch used by the shell applier.
    # Returns a dict shaped like the HTTP JSON body.
    def call(self, path: str, body: dict, timeout: float = 300) -> dict:
        def un(method, request, resp_cls):
            return self._unary(method, request, resp_cls, timeout=timeout)
        return self._call_mapped(path, body or {}, un)

    def _call_mapped(self, path: str, b: dict, un) -> dict:
        if path == "/admin/allocate_volume":
            un("AllocateVolume", pb.AllocateVolumeRequest(
                volume_id=b["volume_id"],
                collection=b.get("collection", ""),
                replication=b.get("replication", "000"),
                ttl=b.get("ttl", "")), pb.AllocateVolumeResponse)
            return {}
        if path == "/admin/delete_volume":
            r = un("VolumeDelete", pb.VolumeDeleteRequest(
                volume_id=b["volume_id"]), pb.VolumeDeleteResponse)
            return {"deleted": r.deleted}
        if path == "/admin/mark_readonly":
            un("VolumeMarkReadonly", pb.VolumeMarkReadonlyRequest(
                volume_id=b["volume_id"],
                read_only=b.get("read_only", True)),
                pb.VolumeMarkReadonlyResponse)
            return {}
        if path == "/admin/vacuum":
            if b.get("check_only"):
                r = un("VacuumVolumeCheck",
                                pb.VacuumVolumeCheckRequest(
                                    volume_id=b["volume_id"]),
                                pb.VacuumVolumeCheckResponse)
                return {"garbage_ratio": r.garbage_ratio}
            r = un("VacuumVolumeCompact",
                            pb.VacuumVolumeCompactRequest(
                                volume_id=b["volume_id"]),
                            pb.VacuumVolumeCompactResponse)
            return {"garbage_ratio": r.garbage_ratio,
                    "compacted": r.compacted}
        if path == "/admin/sync":
            un("VolumeSync", pb.VolumeSyncRequest(
                volume_id=b.get("volume_id", 0)), pb.VolumeSyncResponse)
            return {}
        if path == "/admin/copy_volume":
            un("VolumeCopy", pb.VolumeCopyRequest(
                volume_id=b["volume_id"],
                source_data_node=b["source_data_node"],
                collection=b.get("collection", "")), pb.VolumeCopyResponse)
            return {}
        if path == "/admin/tier_upload":
            r = un("VolumeTierMoveDatToRemote",
                            pb.VolumeTierMoveDatToRemoteRequest(
                                volume_id=b["volume_id"],
                                destination_backend_name=b["endpoint"],
                                bucket=b["bucket"],
                                keep_local_dat_file=b.get("keep_local",
                                                          False)),
                            pb.VolumeTierMoveDatToRemoteResponse)
            return {"tiered": b["volume_id"], "remote": r.remote_key}
        if path == "/admin/tier_download":
            un("VolumeTierMoveDatFromRemote",
                        pb.VolumeTierMoveDatFromRemoteRequest(
                            volume_id=b["volume_id"]),
                        pb.VolumeTierMoveDatFromRemoteResponse)
            return {}
        if path == "/admin/write_needle_blob":
            un("WriteNeedleBlob", pb.WriteNeedleBlobRequest(
                volume_id=b["volume_id"], needle_id=b["key"],
                size=b["size"], needle_blob=bytes.fromhex(b["blob"])),
                pb.WriteNeedleBlobResponse)
            return {}
        if path == "/admin/mount_volume":
            un("VolumeMount",
               pb.VolumeMountRequest(volume_id=b["volume_id"]),
               pb.VolumeMountResponse)
            return {"mounted": True}
        if path == "/admin/unmount_volume":
            un("VolumeUnmount",
               pb.VolumeUnmountRequest(volume_id=b["volume_id"]),
               pb.VolumeUnmountResponse)
            return {"unmounted": True}
        if path == "/admin/configure_replication":
            un("VolumeConfigure",
               pb.VolumeConfigureRequest(volume_id=b["volume_id"],
                                         replication=b["replication"]),
               pb.VolumeConfigureResponse)
            return {"replication": b["replication"]}
        if path == "/admin/batch_delete":
            r = un("BatchDelete", pb.BatchDeleteRequest(
                file_ids=b.get("file_ids", []),
                skip_cookie_check=b.get("skip_cookie_check", False)),
                pb.BatchDeleteResponse)
            return {"results": [
                {"file_id": x.file_id, "status": x.status,
                 "error": x.error, "size": x.size} for x in r.results]}
        if path == "/admin/ec/generate":
            r = un("VolumeEcShardsGenerate",
                            pb.VolumeEcShardsGenerateRequest(
                                volume_id=b["volume_id"],
                                collection=b.get("collection", "")),
                            pb.VolumeEcShardsGenerateResponse)
            return {"base": r.base}
        if path == "/admin/ec/rebuild":
            r = un("VolumeEcShardsRebuild",
                            pb.VolumeEcShardsRebuildRequest(
                                volume_id=b["volume_id"],
                                collection=b.get("collection", "")),
                            pb.VolumeEcShardsRebuildResponse)
            return {"rebuilt_shard_ids": list(r.rebuilt_shard_ids)}
        if path == "/admin/ec/copy":
            un("VolumeEcShardsCopy", pb.VolumeEcShardsCopyRequest(
                volume_id=b["volume_id"], collection=b.get("collection", ""),
                shard_ids=b.get("shard_ids", []),
                copy_ecx_file=b.get("copy_ecx_file", True),
                source_data_node=b["source_data_node"]),
                pb.VolumeEcShardsCopyResponse)
            return {}
        if path == "/admin/ec/delete_shards":
            un("VolumeEcShardsDelete",
                        pb.VolumeEcShardsDeleteRequest(
                            volume_id=b["volume_id"],
                            collection=b.get("collection", ""),
                            shard_ids=b.get("shard_ids", [])),
                        pb.VolumeEcShardsDeleteResponse)
            return {}
        if path == "/admin/ec/mount":
            un("VolumeEcShardsMount", pb.VolumeEcShardsMountRequest(
                volume_id=b["volume_id"], collection=b.get("collection", ""),
                shard_ids=b.get("shard_ids", [])),
                pb.VolumeEcShardsMountResponse)
            return {}
        if path == "/admin/ec/unmount":
            un("VolumeEcShardsUnmount",
                        pb.VolumeEcShardsUnmountRequest(
                            volume_id=b["volume_id"],
                            shard_ids=b.get("shard_ids", [])),
                        pb.VolumeEcShardsUnmountResponse)
            return {}
        if path == "/admin/ec/blob_delete":
            un("VolumeEcBlobDelete", pb.VolumeEcBlobDeleteRequest(
                volume_id=b["volume_id"], collection=b.get("collection", ""),
                file_key=b["needle_id"]), pb.VolumeEcBlobDeleteResponse)
            return {}
        if path == "/admin/ec/to_volume":
            un("VolumeEcShardsToVolume",
                        pb.VolumeEcShardsToVolumeRequest(
                            volume_id=b["volume_id"],
                            collection=b.get("collection", "")),
                        pb.VolumeEcShardsToVolumeResponse)
            return {}
        if path == "/admin/scrub":
            return self._json_unary("VolumeScrub", b)
        if path == "/admin/scrub/status":
            return self._json_unary("ScrubStatus", b)
        raise KeyError(f"no gRPC mapping for {path}")

    def _json_unary(self, method: str, body: dict,
                    timeout: float = 300) -> dict:
        fn = self.channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda d: json.dumps(d or {}).encode(),
            response_deserializer=lambda raw:
                json.loads(raw.decode()) if raw else {})
        return fn(body or {}, timeout=timeout)

    def close(self):
        self.channel.close()
