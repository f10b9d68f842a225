"""gRPC plane for the filer (reference weed/pb/filer.proto).

Serves the filer_pb.SeaweedFiler RPCs — entry CRUD, streaming
ListEntries, AtomicRenameEntry, KV, and the streaming SubscribeMetadata
CDC feed — over grpc generic method handlers, dispatching to the same
Filer core the HTTP plane uses. filer.sync and the mount meta cache
consume SubscribeMetadata when the peer speaks gRPC (HTTP long-poll
remains as fallback).

The port's copy of seaweedfs_tpu/server/filer_grpc.py, the same code,
with the S3 admin service (weedtpu_s3_pb.SeaweedTpuS3 ``Configure``)
writing the IAM identity file through gateway/iam_server.py. It takes no
device and imports nothing of that package.
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Iterator, Optional

import grpc

from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk
from seaweedfs_tpu_torch.pb import filer_pb2 as pb

SERVICE = "weedtpu_filer_pb.SeaweedFiler"


def _entry_to_pb(e: Entry) -> pb.Entry:
    out = pb.Entry(name=e.name, is_directory=e.is_directory)
    a = e.attr
    out.attributes.file_size = a.file_size
    out.attributes.mtime = int(a.mtime)
    out.attributes.file_mode = a.mode
    out.attributes.uid = a.uid
    out.attributes.gid = a.gid
    out.attributes.crtime = int(a.crtime)
    out.attributes.mime = a.mime
    out.attributes.replication = a.replication
    out.attributes.collection = a.collection
    out.attributes.ttl_sec = a.ttl_sec
    out.attributes.user_name = a.user_name
    out.attributes.symlink_target = a.symlink_target
    for c in e.chunks:
        out.chunks.add(file_id=c.fid, offset=c.offset, size=c.size,
                       mtime=c.mtime_ns, e_tag=c.etag,
                       is_chunk_manifest=c.is_chunk_manifest,
                       cipher_key=c.cipher_key.hex())
    for k, v in (e.extended or {}).items():
        out.extended[k] = v if isinstance(v, bytes) else str(v).encode()
    if e.content:
        out.content = e.content
    if e.hard_link_id:
        out.hard_link_id = e.hard_link_id.encode()
    return out


def _chunk_from_pb(c: "pb.FileChunk") -> FileChunk:
    return FileChunk(
        fid=c.file_id, offset=c.offset, size=c.size, mtime_ns=c.mtime,
        etag=c.e_tag, is_chunk_manifest=c.is_chunk_manifest,
        cipher_key=bytes.fromhex(c.cipher_key) if c.cipher_key else b"")


def _entry_from_pb(directory: str, p: pb.Entry) -> Entry:
    full = directory.rstrip("/") + "/" + p.name if p.name else directory
    a = p.attributes
    entry = Entry(
        full_path=full or "/",
        attr=Attr(mtime=float(a.mtime), crtime=float(a.crtime),
                  mode=a.file_mode or 0o660, uid=a.uid, gid=a.gid,
                  mime=a.mime, ttl_sec=a.ttl_sec, user_name=a.user_name,
                  symlink_target=a.symlink_target,
                  file_size=a.file_size, is_directory=p.is_directory,
                  collection=a.collection, replication=a.replication),
        content=bytes(p.content),
        hard_link_id=p.hard_link_id.decode() if p.hard_link_id else "")
    for c in p.chunks:
        entry.chunks.append(_chunk_from_pb(c))
    entry.extended = {k: bytes(v) for k, v in p.extended.items()}
    return entry


def _event_entry_to_pb(d: Optional[dict]) -> Optional[pb.Entry]:
    if not d:
        return None
    e = Entry.from_dict(d)
    return _entry_to_pb(e)


class FilerGrpc:
    def __init__(self, filer_server):
        self.fs = filer_server
        self.filer = filer_server.filer

    # ---- entry CRUD ----
    def lookup(self, request, context):
        path = request.directory.rstrip("/") + "/" + request.name
        e = self.filer.find_entry(path)
        if e is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "not found")
        return pb.LookupDirectoryEntryResponse(entry=_entry_to_pb(e))

    def list_entries(self, request, context
                     ) -> Iterator[pb.ListEntriesResponse]:
        limit = request.limit or 1024
        entries = self.filer.list_entries(
            request.directory or "/",
            start_name=request.start_from_file_name,
            include_start=request.inclusive_start_from,
            limit=limit, prefix=request.prefix)
        for e in entries:
            yield pb.ListEntriesResponse(entry=_entry_to_pb(e))

    def create_entry(self, request, context):
        try:
            self.filer.create_entry(
                _entry_from_pb(request.directory, request.entry))
        except IsADirectoryError as e:
            return pb.CreateEntryResponse(error=str(e) or "is a directory")
        return pb.CreateEntryResponse()

    def update_entry(self, request, context):
        self.filer.update_entry(
            _entry_from_pb(request.directory, request.entry))
        return pb.UpdateEntryResponse()

    def delete_entry(self, request, context):
        path = request.directory.rstrip("/") + "/" + request.name
        try:
            self.filer.delete_entry(
                path, recursive=request.is_recursive,
                ignore_recursive_error=request.ignore_recursive_error)
        except FileNotFoundError:
            return pb.DeleteEntryResponse(error="not found")
        except OSError as e:  # non-empty without recursive
            return pb.DeleteEntryResponse(error=str(e))
        return pb.DeleteEntryResponse()

    def atomic_rename(self, request, context):
        old = request.old_directory.rstrip("/") + "/" + request.old_name
        new = request.new_directory.rstrip("/") + "/" + request.new_name
        try:
            self.filer.rename_entry(old, new)
        except FileNotFoundError:
            context.abort(grpc.StatusCode.NOT_FOUND, "not found")
        return pb.AtomicRenameEntryResponse()

    # ---- KV ----
    def kv_get(self, request, context):
        val = self.filer.store.kv_get(bytes(request.key))
        if val is None:
            return pb.KvGetResponse(error="not found")
        return pb.KvGetResponse(value=val)

    def kv_put(self, request, context):
        if request.delete:
            self.filer.store.kv_delete(bytes(request.key))
        else:
            self.filer.store.kv_put(bytes(request.key),
                                    bytes(request.value))
        return pb.KvPutResponse()

    # ---- meta subscription (CDC) ----
    def subscribe_metadata(self, request, context
                           ) -> Iterator[pb.SubscribeMetadataResponse]:
        """Streaming CDC feed (reference filer_grpc_server_sub_meta.go):
        replays persisted events since since_ns, then follows the live
        log until the client disconnects."""
        since = request.since_ns
        prefix = request.path_prefix or "/"
        log = self.filer.meta_log
        while context.is_active():
            # snapshot BEFORE reading: everything <= latest that read_since
            # omits is prefix-filtered, so the cursor may skip it — without
            # this, a subscriber whose prefix never matches busy-spins
            latest = log.latest_tsns()
            events = log.read_since(since, path_prefix=prefix, limit=1024)
            for ev in events:
                d = ev if isinstance(ev, dict) else ev.to_dict()
                resp = pb.SubscribeMetadataResponse(
                    directory=d.get("directory", ""),
                    ts_ns=d.get("tsns", 0))
                old_pb = _event_entry_to_pb(d.get("old_entry"))
                new_pb = _event_entry_to_pb(d.get("new_entry"))
                if old_pb is not None:
                    resp.event_notification.old_entry.CopyFrom(old_pb)
                if new_pb is not None:
                    resp.event_notification.new_entry.CopyFrom(new_pb)
                since = max(since, d.get("tsns", 0))
                yield resp
            if not events:
                since = max(since, latest)
                # block until new events or a short timeout, then re-check
                log.wait_for_events(since, timeout=1.0)
        return

    # ---- volume plane proxies (the pure-gRPC write path: reference
    # filer.proto:36 AssignVolume + LookupVolume; a client assigns
    # here, POSTs the payload to the returned url, then CreateEntry) ----
    def assign_volume(self, request, context):
        rule = None
        if request.path:
            try:
                # _current_filer_conf reloads per-path rules on a TTL so
                # fs.configure changes reach the gRPC path too
                rule = self.fs._current_filer_conf().match_storage_rule(
                    request.path)
            except Exception:
                rule = None
        collection = request.collection or (rule.collection if rule else "")
        replication = request.replication or \
            (rule.replication if rule else "")
        # TTL grammar has no seconds unit (reference needle.TTL:
        # m/h/d/w/M/y) — round seconds up to whole minutes
        ttl = f"{-(-request.ttl_sec // 60)}m" if request.ttl_sec else \
            (rule.ttl if rule else "")
        try:
            a = self.fs.mc.assign(count=max(request.count, 1),
                                  collection=collection,
                                  replication=replication, ttl=ttl,
                                  data_center=request.data_center)
        except Exception as e:
            return pb.AssignVolumeResponse(error=str(e))
        if a.get("error"):
            return pb.AssignVolumeResponse(error=a["error"])
        return pb.AssignVolumeResponse(
            file_id=a["fid"], url=a["url"],
            public_url=a.get("publicUrl", a["url"]),
            count=a.get("count", 1), collection=collection,
            replication=replication)

    def lookup_volume(self, request, context):
        resp = pb.LookupVolumeResponse()
        for vid_str in request.volume_ids:
            try:
                vid = int(vid_str.split(",")[0])
            except ValueError:
                continue
            locs = pb.Locations()
            for loc in self.fs.mc.lookup_volume(vid):
                locs.locations.append(pb.Location(
                    url=loc.get("url", ""),
                    public_url=loc.get("publicUrl", loc.get("url", ""))))
            resp.locations_map[vid_str].CopyFrom(locs)
        return resp

    def append_to_entry(self, request, context):
        """reference filer_grpc_server.go AppendToEntry: extend an
        entry's chunk list at its current tail (log-style appends; the
        mq broker writes segments this way). The read-modify-write runs
        under the filer lock so concurrent appenders can't compute the
        same tail offset."""
        import time as _time

        from seaweedfs_tpu_torch.filer.entry import Attr
        path = request.directory.rstrip("/") + "/" + request.entry_name
        with self.fs.filer._lock:
            entry = self.fs.filer.find_entry(path)
            if entry is None:
                entry = Entry(full_path=path,
                              attr=Attr(mtime=clockctl.now(),
                                        crtime=clockctl.now(), mode=0o644))
            elif entry.content:
                # inline content can't coexist with chunks (the read
                # path prefers content): spill it to a chunk first
                fc = self.fs._save_chunk(entry.content, 0, "", "")
                entry.chunks = [fc]
                entry.content = b""
            offset = entry.file_size()
            for c in request.chunks:
                fc = _chunk_from_pb(c)
                fc.offset = offset
                if not fc.mtime_ns:
                    fc.mtime_ns = _time.time_ns()
                offset += fc.size
                entry.chunks.append(fc)
            entry.attr.file_size = offset
            try:
                self.fs.filer.create_entry(entry)
            except Exception as e:
                return pb.AppendToEntryResponse(error=str(e))
        return pb.AppendToEntryResponse()

    def collection_list(self, request, context):
        from seaweedfs_tpu_torch.utils.httpd import http_json
        try:
            out = http_json("GET",
                            f"http://{self.fs.master_url}/col/list")
        except ConnectionError as e:
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        return pb.CollectionListResponse(
            collections=[c["name"] if isinstance(c, dict) else c
                         for c in out.get("collections", [])])

    def delete_collection(self, request, context):
        from seaweedfs_tpu_torch.utils.httpd import http_json
        try:
            http_json("POST", f"http://{self.fs.master_url}/col/delete"
                              f"?collection={request.collection}")
        except ConnectionError as e:
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        return pb.DeleteCollectionResponse()

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

    def cache_remote_object(self, request, context):
        """reference filer_grpc_server_remote.go: materialize a
        remote-mounted entry's bytes as local chunks."""
        path = request.directory.rstrip("/") + "/" + request.name
        entry = self.fs.filer.find_entry(path)
        if entry is None:
            context.abort(grpc.StatusCode.NOT_FOUND, path)
        if entry.remote is not None and not entry.chunks \
                and not entry.content:
            try:
                rule = self.fs._current_filer_conf().match_storage_rule(
                    path)
                self.fs.remote_mounts.cache_entry(
                    entry, lambda data: self.fs._upload_chunks(
                        data, rule.collection, rule.replication,
                        rule.ttl))
                entry = self.fs.filer.find_entry(path)
            except Exception as e:
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        return pb.CacheRemoteObjectToLocalClusterResponse(
            entry=_entry_to_pb(entry))

    # ---- misc ----
    def statistics(self, request, context):
        """Aggregate capacity from the master topology (reference
        filer_grpc_server.go Statistics proxies to the master)."""
        try:
            topo = self.fs.mc.topology()
        except Exception:
            return pb.StatisticsResponse()
        from seaweedfs_tpu_torch.cluster.topology import aggregate_topology_info
        agg = aggregate_topology_info(topo.get("Topology", topo))
        limit = topo.get("VolumeSizeLimitMB", 0) * 1024 * 1024
        return pb.StatisticsResponse(total_size=agg["slots"] * limit,
                                     used_size=agg["used_bytes"],
                                     file_count=agg["file_count"])

    def get_configuration(self, request, context):
        return pb.GetFilerConfigurationResponse(
            masters=[self.fs.master_url] if getattr(self.fs, "master_url",
                                                    "") else [],
            version="seaweedfs-tpu")

    def handlers(self) -> grpc.GenericRpcHandler:
        def unary(fn, req_cls, resp_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)

        def ustream(fn, req_cls, resp_cls):
            return grpc.unary_stream_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)

        rpcs = {
            "LookupDirectoryEntry": unary(
                self.lookup, pb.LookupDirectoryEntryRequest,
                pb.LookupDirectoryEntryResponse),
            "ListEntries": ustream(self.list_entries, pb.ListEntriesRequest,
                                   pb.ListEntriesResponse),
            "CreateEntry": unary(self.create_entry, pb.CreateEntryRequest,
                                 pb.CreateEntryResponse),
            "UpdateEntry": unary(self.update_entry, pb.UpdateEntryRequest,
                                 pb.UpdateEntryResponse),
            "DeleteEntry": unary(self.delete_entry, pb.DeleteEntryRequest,
                                 pb.DeleteEntryResponse),
            "AtomicRenameEntry": unary(self.atomic_rename,
                                       pb.AtomicRenameEntryRequest,
                                       pb.AtomicRenameEntryResponse),
            "SubscribeMetadata": ustream(self.subscribe_metadata,
                                         pb.SubscribeMetadataRequest,
                                         pb.SubscribeMetadataResponse),
            "SubscribeLocalMetadata": ustream(
                self.subscribe_metadata, pb.SubscribeMetadataRequest,
                pb.SubscribeMetadataResponse),
            "AppendToEntry": unary(self.append_to_entry,
                                   pb.AppendToEntryRequest,
                                   pb.AppendToEntryResponse),
            "CollectionList": unary(self.collection_list,
                                    pb.CollectionListRequest,
                                    pb.CollectionListResponse),
            "DeleteCollection": unary(self.delete_collection,
                                      pb.DeleteCollectionRequest,
                                      pb.DeleteCollectionResponse),
            "Ping": unary(self.ping, pb.PingRequest, pb.PingResponse),
            "CacheRemoteObjectToLocalCluster": unary(
                self.cache_remote_object,
                pb.CacheRemoteObjectToLocalClusterRequest,
                pb.CacheRemoteObjectToLocalClusterResponse),
            "AssignVolume": unary(self.assign_volume,
                                  pb.AssignVolumeRequest,
                                  pb.AssignVolumeResponse),
            "LookupVolume": unary(self.lookup_volume,
                                  pb.LookupVolumeRequest,
                                  pb.LookupVolumeResponse),
            "KvGet": unary(self.kv_get, pb.KvGetRequest, pb.KvGetResponse),
            "KvPut": unary(self.kv_put, pb.KvPutRequest, pb.KvPutResponse),
            "Statistics": unary(self.statistics, pb.StatisticsRequest,
                                pb.StatisticsResponse),
            "GetFilerConfiguration": unary(
                self.get_configuration, pb.GetFilerConfigurationRequest,
                pb.GetFilerConfigurationResponse),
        }
        return grpc.method_handlers_generic_handler(SERVICE, rpcs)


class S3ConfigGrpc:
    """weedtpu_s3_pb.SeaweedTpuS3 — the S3 admin Configure RPC
    (reference weed/pb/s3.proto), registered on the filer gRPC server:
    the S3 gateway and IAM server read identity config from the filer
    (/etc/iam/identity.json), so configuring it IS a filer write.

    Accepts either a binary weedtpu_iam_pb.S3ApiConfiguration or the
    legacy JSON identity file, persists canonical JSON."""

    def __init__(self, filer_server):
        self.fs = filer_server

    def configure(self, request, context):
        from seaweedfs_tpu_torch.gateway.iam_server import IdentityStore
        from seaweedfs_tpu_torch.pb import iam_pb2, s3_pb2
        content = request.s3_configuration_file_content
        try:
            conf = json.loads(content)
            if not isinstance(conf, dict) or "identities" not in conf:
                raise ValueError("missing identities")
        except (UnicodeDecodeError, ValueError):
            try:
                api = iam_pb2.S3ApiConfiguration.FromString(content)
            except Exception:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "neither S3ApiConfiguration proto nor "
                              "identity JSON")
            conf = {"identities": [
                {"name": i.name,
                 "credentials": [{"accessKey": c.access_key,
                                  "secretKey": c.secret_key}
                                 for c in i.credentials],
                 "actions": list(i.actions)} for i in api.identities]}
        IdentityStore(self.fs.filer).save(conf)
        return s3_pb2.S3ConfigureResponse()

    def handlers(self):
        from seaweedfs_tpu_torch.pb import s3_pb2
        rpcs = {
            "Configure": grpc.unary_unary_rpc_method_handler(
                self.configure,
                request_deserializer=s3_pb2.S3ConfigureRequest.FromString,
                response_serializer=(
                    s3_pb2.S3ConfigureResponse.SerializeToString)),
        }
        return grpc.method_handlers_generic_handler(
            "weedtpu_s3_pb.SeaweedTpuS3", rpcs)


def start_filer_grpc(filer_server, host: str = "127.0.0.1",
                     port: int = 0, tls="auto") -> tuple[grpc.Server, int]:
    from seaweedfs_tpu_torch.utils import tls as tlsmod
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=32))
    server.add_generic_rpc_handlers((FilerGrpc(filer_server).handlers(),
                                     S3ConfigGrpc(filer_server).handlers()))
    cfg = tlsmod.load_tls_config("filer") if tls == "auto" else tls
    if cfg is not None:
        bound = server.add_secure_port(
            f"{host}:{port}", tlsmod.server_credentials(cfg))
    else:
        bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, bound


class GrpcFilerClient:
    """Client for the filer gRPC plane (filer.sync, mount meta cache)."""

    def __init__(self, address: str, tls="auto"):
        from seaweedfs_tpu_torch.utils.tls import make_channel
        self.channel = make_channel(address, role="client", tls=tls)

    def _unary(self, method: str, request, resp_cls, timeout: float = 30):
        fn = self.channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)
        return fn(request, timeout=timeout)

    def lookup(self, directory: str, name: str) -> pb.Entry:
        return self._unary("LookupDirectoryEntry",
                           pb.LookupDirectoryEntryRequest(
                               directory=directory, name=name),
                           pb.LookupDirectoryEntryResponse).entry

    def list_entries(self, directory: str, prefix: str = "",
                     limit: int = 1024) -> list[pb.Entry]:
        fn = self.channel.unary_stream(
            f"/{SERVICE}/ListEntries",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.ListEntriesResponse.FromString)
        return [r.entry for r in fn(pb.ListEntriesRequest(
            directory=directory, prefix=prefix, limit=limit), timeout=60)]

    def create_entry(self, directory: str, entry: pb.Entry) -> None:
        r = self._unary("CreateEntry", pb.CreateEntryRequest(
            directory=directory, entry=entry), pb.CreateEntryResponse)
        if r.error:
            raise RuntimeError(r.error)

    def delete_entry(self, directory: str, name: str,
                     recursive: bool = False,
                     delete_data: bool = True) -> None:
        self._unary("DeleteEntry", pb.DeleteEntryRequest(
            directory=directory, name=name, is_recursive=recursive,
            is_delete_data=delete_data), pb.DeleteEntryResponse)

    def rename(self, old_dir: str, old_name: str, new_dir: str,
               new_name: str) -> None:
        self._unary("AtomicRenameEntry", pb.AtomicRenameEntryRequest(
            old_directory=old_dir, old_name=old_name,
            new_directory=new_dir, new_name=new_name),
            pb.AtomicRenameEntryResponse)

    def assign_volume(self, count: int = 1, collection: str = "",
                      replication: str = "", ttl_sec: int = 0,
                      path: str = "") -> pb.AssignVolumeResponse:
        r = self._unary("AssignVolume", pb.AssignVolumeRequest(
            count=count, collection=collection, replication=replication,
            ttl_sec=ttl_sec, path=path), pb.AssignVolumeResponse)
        if r.error:
            raise RuntimeError(r.error)
        return r

    def lookup_volume(self, volume_ids: list[str]
                      ) -> dict[str, list[str]]:
        r = self._unary("LookupVolume", pb.LookupVolumeRequest(
            volume_ids=volume_ids), pb.LookupVolumeResponse)
        return {vid: [l.url for l in locs.locations]
                for vid, locs in r.locations_map.items()}

    def statistics(self) -> pb.StatisticsResponse:
        return self._unary("Statistics", pb.StatisticsRequest(),
                           pb.StatisticsResponse)

    def append_to_entry(self, directory: str, name: str,
                        chunks: list) -> None:
        r = self._unary("AppendToEntry", pb.AppendToEntryRequest(
            directory=directory, entry_name=name, chunks=chunks),
            pb.AppendToEntryResponse)
        if r.error:
            raise RuntimeError(r.error)

    def collection_list(self) -> list[str]:
        r = self._unary("CollectionList", pb.CollectionListRequest(),
                        pb.CollectionListResponse)
        return list(r.collections)

    def delete_collection(self, name: str) -> None:
        self._unary("DeleteCollection",
                    pb.DeleteCollectionRequest(collection=name),
                    pb.DeleteCollectionResponse)

    def ping(self, target: str = "", target_type: str = ""
             ) -> pb.PingResponse:
        return self._unary("Ping", pb.PingRequest(
            target=target, target_type=target_type), pb.PingResponse,
            timeout=10)

    def get_configuration(self) -> pb.GetFilerConfigurationResponse:
        return self._unary("GetFilerConfiguration",
                           pb.GetFilerConfigurationRequest(),
                           pb.GetFilerConfigurationResponse)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        r = self._unary("KvGet", pb.KvGetRequest(key=key), pb.KvGetResponse)
        return None if r.error else bytes(r.value)

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._unary("KvPut", pb.KvPutRequest(key=key, value=value),
                    pb.KvPutResponse)

    def subscribe_metadata(self, since_ns: int = 0, path_prefix: str = "/",
                           client_name: str = "client"):
        """Returns the (blocking) response iterator; cancel() the returned
        call to stop."""
        fn = self.channel.unary_stream(
            f"/{SERVICE}/SubscribeMetadata",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.SubscribeMetadataResponse.FromString)
        return fn(pb.SubscribeMetadataRequest(
            client_name=client_name, path_prefix=path_prefix,
            since_ns=since_ns))

    def close(self):
        self.channel.close()
