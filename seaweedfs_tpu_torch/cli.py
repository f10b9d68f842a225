"""weed-tpu command line — the `weed` binary equivalent
(reference weed/command/command.go dispatch).

Subcommands: master, volume, server (all-in-one), shell, upload, download,
delete, benchmark, ec (one-shot admin ops), filer, filer.cat, filer.copy,
s3.

The port's copy of seaweedfs_tpu/cli.py, run as
``python -m seaweedfs_tpu_torch.cli``: the same subcommands, flags and
output, on the port's servers, with two changes for its explicit device:

- ``-coder`` takes the port's coder names: ``torch`` (the default, K1 on
  the card), ``mxu`` (K2), ``mesh``, and the host coders ``cpu`` and
  ``cpu-mt``;
- ``-device cuda|cpu`` (default ``cuda``) on ``volume`` and ``server`` is
  where the volume server's EC work runs. On ``cuda`` the process opens
  its CUDA context before it binds a socket, and without a card it raises
  there; ``cpu`` runs the kernels' plain versions.

``filer``, ``filer.cat``, ``filer.copy`` and ``server -filer`` run the
port's filer, which takes no device: the card is reached through the
volume servers that hold the chunks.

``-grpc`` on ``master``, ``volume``, ``server`` and ``filer`` starts the
process's gRPC plane on its port + 10000, as the reference does;
``master.follower -grpcAddresses`` feeds the follower's vidMap from the
masters' KeepConnected stream; ``filer -store etcd`` speaks etcd's gRPC KV
API, and ``filer -store redis|mysql|postgres|mongodb|cassandra|elastic`` the
other wire families.

``s3``, ``webdav``, ``ftp`` and ``iam`` run the port's gateways over a
remote filer (``filer/remote_store.py``), ``server -filer -s3`` the S3
gateway beside the embedded filer, and ``filer -ftp`` the FTP gateway in
the filer's process. None of them takes a device.

``filer -mq`` serves the mq broker's gRPC plane in the filer's process;
``filer.sync``, ``filer.replicate``, ``filer.backup``, ``filer.meta.*``
and ``filer.remote.*`` follow a filer's change log (replication/);
``mount`` and ``fuse`` serve WeedFS (mount/) over the kernel's FUSE
protocol, with its gRPC admin plane announced to the master. None of
them takes a device. It imports nothing of that package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from seaweedfs_tpu_torch.utils import clockctl

CODERS = ["torch", "mxu", "mesh", "cpu", "cpu-mt"]


def _open_device(device: str) -> None:
    """Take the card before anything is bound: without a CUDA device this
    raises, and with one the process's CUDA context exists before the
    first EC request."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device for the volume server ({dev}); pass "
                "-device cpu to run the plain versions on the host")
        torch.empty(1, device=dev)


def _add_common_volume_args(p):
    p.add_argument("-dir", default="./data", help="data directory (comma-separated)")
    p.add_argument("-max", type=int, default=8, help="max volumes per dir")
    p.add_argument("-disk", default="",
                   help="disk type per -dir entry, comma-separated "
                        "(hdd/ssd; short lists pad with the last value)")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-mserver", default="127.0.0.1:9333")
    p.add_argument("-rack", default="")
    p.add_argument("-dataCenter", default="")
    p.add_argument("-coder", default="torch", choices=CODERS,
                   help="erasure coder (torch = K1 on the card, mxu = K2, "
                        "mesh = multi-device batch, cpu / cpu-mt = host)")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="where the volume server's EC work runs (cpu = "
                        "the kernels' plain versions)")
    p.add_argument("-ecBatcher", action="store_true",
                   help="coalesce concurrent EC encode/rebuild jobs into "
                        "device-sized mesh batches (overrides -coder; "
                        "stats at /admin/ec/batcher)")
    p.add_argument("-ecBatchWindowMs", type=float, default=5.0,
                   help="batcher coalescing window in ms (with -ecBatcher)")
    p.add_argument("-index", default="memory", choices=["memory", "ldb"],
                   help="needle map kind (reference -index flag)")
    p.add_argument("-tcp", action="store_true",
                   help="serve the raw TCP data path (reference -useTcp)")
    p.add_argument("-concurrentUploadLimitMB", type=int, default=256,
                   help="in-flight upload byte cap, 0=unlimited "
                        "(reference -concurrentUploadLimitMB)")
    p.add_argument("-concurrentDownloadLimitMB", type=int, default=256,
                   help="in-flight download byte cap, 0=unlimited")
    p.add_argument("-fileSizeLimitMB", type=int, default=256,
                   help="reject single uploads over this size "
                        "(reference -fileSizeLimitMB)")
    p.add_argument("-advertise", default="",
                   help="host:port to register with the master instead of "
                        "ip:port (e.g. a tools/netchaos.py proxy, so peer "
                        "traffic routes through injected faults)")
    p.add_argument("-fsync", action="store_true",
                   help="fsync after every write before acking "
                        "(reference -fsync; default trusts the page cache)")
    p.add_argument("-grpc", action="store_true",
                   help="serve the volume_server_pb gRPC admin plane on "
                        "port+10000")


def _start_push(args, *servers):
    """Attach the push-gateway loop to each server's registry when
    -metricsAddress is set (reference stats/metrics.go
    LoopPushingMetric; job name matches the subsystem)."""
    addr = getattr(args, "metricsAddress", "")
    if not addr:
        return
    for job, srv in servers:
        reg = getattr(srv, "metrics", None)
        if reg is not None:
            reg.start_push(addr, job, srv.url,
                           getattr(args, "metricsIntervalSec", 15))


def cmd_master(args):
    from seaweedfs_tpu_torch.server.master import MasterServer
    ms = MasterServer(host=args.ip, port=args.port,
                      volume_size_limit_mb=args.volumeSizeLimitMB,
                      default_replication=args.defaultReplication,
                      meta_dir=args.mdir,
                      grpc_port=args.port + 10000 if args.grpc else None,
                      repair_rate_mbps=args.repairRateMBps,
                      tier_endpoint=args.tierEndpoint,
                      tier_bucket=args.tierBucket)
    ms.start()
    _start_push(args, ("master", ms))
    if args.peers:
        ms.set_peers(args.peers.split(","))
    extra = f", grpc {ms.grpc_port}" if ms.grpc_port else ""
    if args.peers:
        extra += f", raft peers {ms.peers}"
    _serve_until_signal(ms, ready=f"master listening on {ms.url}{extra}")


def _volume_server(args, master_url: str, **kw):
    """The volume server that `volume` and `server` start, its coder (or
    batch scheduler) on -device."""
    from seaweedfs_tpu_torch.models.coder import make_coder
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    dirs = args.dir.split(",")
    return VolumeServer(
        dirs, master_url, host=args.ip, port=args.port,
        coder=None if args.ecBatcher
        else make_coder(args.coder, device=args.device),
        ec_batcher=args.ecBatcher,
        ec_batch_window_s=args.ecBatchWindowMs / 1000.0,
        max_volume_counts=[args.max] * len(dirs),
        disk_types=[t.strip() for t in args.disk.split(",")
                    if t.strip()] if args.disk.strip() else None,
        needle_map_kind=args.index,
        tcp_port=0 if args.tcp else -1,
        concurrent_upload_limit_mb=args.concurrentUploadLimitMB,
        concurrent_download_limit_mb=args.concurrentDownloadLimitMB,
        file_size_limit_mb=args.fileSizeLimitMB,
        grpc_port=args.port + 10000 if args.grpc else None,
        fsync=args.fsync, device=args.device, **kw)


def cmd_volume(args):
    _open_device(args.device)
    vs = _volume_server(args, args.mserver, rack=args.rack,
                        data_center=args.dataCenter,
                        advertise=args.advertise)
    vs.start()
    _start_push(args, ("volumeServer", vs))
    tcp = f", tcp {vs.tcp_server.port}" if vs.tcp_server else ""
    g = f", grpc {vs.grpc_port}" if vs.grpc_port else ""
    _serve_until_signal(vs, ready=f"volume server listening on {vs.url}"
                        f"{tcp}{g}, master {args.mserver}")


def cmd_server(args):
    """All-in-one: master + volume (+ filer + s3 when asked)."""
    from seaweedfs_tpu_torch.server.master import MasterServer
    _open_device(args.device)
    ms = MasterServer(host=args.ip, port=args.masterPort,
                      volume_size_limit_mb=args.volumeSizeLimitMB)
    ms.start()
    started = [ms]
    try:
        vs = _volume_server(args, ms.url)
        vs.start()
        started.append(vs)
        ready = f"master {ms.url}; volume {vs.url}"
        push_targets = [("master", ms), ("volumeServer", vs)]
        if args.filer:
            from seaweedfs_tpu_torch.server.filer_server import FilerServer
            fs = FilerServer(ms.url, host=args.ip, port=args.filerPort,
                             store_dir=args.dir.split(",")[0],
                             grpc_port=(args.filerPort + 10000
                                        if args.grpc else None))
            fs.start()
            started.append(fs)
            ready += f"; filer {fs.url}" + (
                f" (grpc {fs.grpc_port})" if args.grpc else "")
            push_targets.append(("filer", fs))
            if args.s3:
                from seaweedfs_tpu_torch.gateway.s3_server import S3Server
                s3 = S3Server(fs, host=args.ip, port=args.s3Port)
                s3.start()
                started.append(s3)
                ready += f"; s3 {s3.url}"
                push_targets.append(("s3", s3))
    except BaseException:
        for srv in reversed(started):
            srv.stop()
        raise
    _start_push(args, *push_targets)
    # volume drains first (its draining heartbeat needs the master
    # still up), the gateway and filer next, master last
    _serve_until_signal(vs, *reversed(started[2:]), ms, ready=ready)


def cmd_filer(args):
    """Standalone filer server (reference command/filer.go). It takes no
    device: the chunks live on the volume servers."""
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    fs = FilerServer(args.master, host=args.ip, port=args.port,
                     store=args.store, store_dir=args.dir,
                     default_replication=args.defaultReplication,
                     cipher=args.encryptVolumeData,
                     grpc_port=args.port + 10000 if args.grpc else None,
                     sharding=args.sharding,
                     entry_cache=not args.noEntryCache)
    fs.start()
    _start_push(args, ("filer", fs))
    extra = " cipher" if args.encryptVolumeData else ""
    if fs.grpc_port:
        extra += f", grpc {fs.grpc_port}"
    servers = [fs]
    if args.ftp:
        from seaweedfs_tpu_torch.gateway.ftp_server import FtpServer
        ftp = FtpServer(fs, host=args.ip, port=args.ftpPort)
        ftp.start()
        servers.insert(0, ftp)
        extra += f", ftp {ftp.url}"
    if args.mq:
        # mq broker rides the filer process (reference runs a separate
        # `weed mq.broker` that dials the filer; this broker embeds it)
        mq = _MqPlane(fs, args.ip, args.mqPort)
        servers.insert(0, mq)
        extra += f", mq grpc {args.ip}:{mq.port}"
    _serve_until_signal(*servers, ready=f"filer {fs.url} "
                        f"(store={args.store}){extra}")


class _MqPlane:
    """The mq broker over a filer with its gRPC plane, as `filer -mq`
    serves it. Stopped before its filer: the plane stops taking
    requests, then the broker flushes its open segments into the filer
    (the reference's process exits with them in memory)."""

    def __init__(self, fs, host: str, port: int):
        from seaweedfs_tpu_torch.mq.broker import Broker
        from seaweedfs_tpu_torch.mq.broker_grpc import start_broker_grpc
        self.broker = Broker(fs)
        self.server, self.port = start_broker_grpc(self.broker, host=host,
                                                   port=port)

    def stop(self) -> None:
        self.server.stop(grace=None)
        self.broker.flush()


def cmd_gateway(args):
    """Standalone S3 / WebDAV / FTP gateway attached to a REMOTE filer
    (reference command/s3.go, webdav.go: gateways dial the filer; here
    metadata flows through filer/remote_store.py, data through the
    master/volume servers directly). Like the filer, it takes no device.

    The filer view runs without its entry cache (a divergence from the
    reference, whose view caches every lookup and never hears of a write
    made through another filer: an identity added by `s3.configure` or
    the filer's S3 Configure RPC would never reach its gateway)."""
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    fs = FilerServer(args.master, store="remote", store_dir=args.filer,
                     announce=False, entry_cache=False)
    fs.start()  # local HTTP surface (FTP STOR path rides it)
    try:
        if args.cmd == "s3":
            from seaweedfs_tpu_torch.gateway.s3_server import S3Server
            gw = S3Server(fs, host=args.ip, port=args.port)
        elif args.cmd == "webdav":
            from seaweedfs_tpu_torch.gateway.webdav_server import \
                WebDavServer
            gw = WebDavServer(fs, host=args.ip, port=args.port)
        else:
            from seaweedfs_tpu_torch.gateway.ftp_server import FtpServer
            gw = FtpServer(fs, host=args.ip, port=args.port)
        gw.start()
    except BaseException:
        fs.stop()
        raise
    _serve_until_signal(gw, fs, ready=f"filer-view {fs.url} -> "
                        f"{args.filer}; {args.cmd} {gw.url}")


def cmd_iam(args):
    """Standalone IAM API server over a remote filer (reference
    command/iam.go); its filer view runs without the entry cache, as the
    gateways' do (cmd_gateway)."""
    from seaweedfs_tpu_torch.gateway.iam_server import IamServer
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    fs = FilerServer(args.master, store="remote", store_dir=args.filer,
                     announce=False, entry_cache=False)
    fs.start()
    try:
        iam = IamServer(fs, host=args.ip, port=args.port)
        iam.start()
    except BaseException:
        fs.stop()
        raise
    _serve_until_signal(iam, fs, ready=f"iam {iam.url} (filer {args.filer})")


def cmd_filer_sync(args):
    """Active-active sync between two filers (reference
    command/filer_sync.go), or one-way with -oneWay."""
    from seaweedfs_tpu_torch.replication.sync import (BidirectionalSync,
                                                      FilerSync)
    if args.oneWay:
        from seaweedfs_tpu_torch.replication.sink import FilerSink
        # one-way: -bPrefix is the DESTINATION prefix on B (in
        # bidirectional mode it is B's source-path filter)
        sync = FilerSync(args.a,
                         FilerSink(args.b,
                                   path_prefix=args.bPrefix.rstrip("/")),
                         path_prefix=args.aPrefix)
        print(f"filer.sync {args.a} -> {args.b} (one-way)")
    else:
        sync = BidirectionalSync(args.a, args.b,
                                 a_prefix=args.aPrefix,
                                 b_prefix=args.bPrefix)
        print(f"filer.sync {args.a} <-> {args.b}")
    sync.start(args.since)
    _wait_forever()


def cmd_filer_backup(args):
    """Continuously back a filer subtree up to a sink (reference
    command/filer_backup.go): -dir for a local mirror, or -endpoint +
    -bucket for an S3-dialect target."""
    from seaweedfs_tpu_torch.replication.sync import FilerSync
    if args.endpoint:
        from seaweedfs_tpu_torch.replication.sink import S3Sink
        sink = S3Sink(args.endpoint, args.bucket, prefix=args.keyPrefix,
                      access_key=args.accessKey, secret_key=args.secretKey)
        target = f"s3 {args.endpoint}/{args.bucket}"
    else:
        from seaweedfs_tpu_torch.replication.sink import LocalSink
        sink = LocalSink(args.dir)
        target = args.dir
    sync = FilerSync(args.filer, sink, path_prefix=args.filerPath)
    print(f"filer.backup {args.filer}{args.filerPath} -> {target}")
    sync.start(args.since)
    _wait_forever()


def cmd_filer_meta_backup(args):
    from seaweedfs_tpu_torch.replication.sync import meta_backup
    # one-shot dump by default; -follow keeps tailing like the
    # reference's continuous backup daemon
    n = meta_backup(args.filer, args.output,
                    path_prefix=args.filerPath,
                    stop_on_idle=not args.follow)
    print(json.dumps({"events": n, "file": args.output}))


def cmd_filer_meta_tail(args):
    from seaweedfs_tpu_torch.replication.sync import meta_tail
    n = meta_tail(args.filer, path_prefix=args.pathPrefix,
                  max_events=args.n or None)
    print(json.dumps({"events": n}))


def cmd_filer_remote_sync(args):
    """Write-back daemon for a remote mount (reference
    command/filer_remote_sync.go)."""
    from seaweedfs_tpu_torch.replication.remote_sync import FilerRemoteSync
    sync = FilerRemoteSync(args.filer, args.dir)
    print(f"filer.remote.sync {args.filer}{args.dir}")
    sync.start()
    _wait_forever()


def cmd_filer_replicate(args):
    """One-way replication daemon: consume a filer's event stream and
    apply it to the sink enabled in replication.toml (reference
    command/filer_replicate.go wiring replication/replicator.go)."""
    import time as _time

    from seaweedfs_tpu_torch.replication.sink import (
        Replicator, make_sink_from_config)
    from seaweedfs_tpu_torch.replication.sync import subscribe_meta_events
    from seaweedfs_tpu_torch.utils import config as cfg
    from seaweedfs_tpu_torch.utils import glog
    conf = cfg.load_configuration("replication", required=True)
    sink = make_sink_from_config(conf)
    if sink is None:
        raise SystemExit("replication.toml enables no sink "
                         "(sink.filer/local/s3/azure)")
    from seaweedfs_tpu_torch.utils.httpd import HttpError
    rep = Replicator(sink, args.filer, path_prefix=args.path)
    since = int(_time.time() * 1e9) if args.fromNow else args.sinceNs
    print(f"filer.replicate {args.filer}{args.path} -> "
          f"{sink.name} sink")
    for ev in subscribe_meta_events(args.filer, since_ns=since,
                                    path_prefix=args.path):
        if ev is None:
            continue
        while True:
            try:
                rep.apply_event(ev)
                break
            except (ConnectionError, HttpError) as e:
                # transient sink failure: retry the SAME event rather
                # than silently diverging the replica (FilerSync holds
                # its cursor for exactly this reason)
                glog.warning("replicate: sink unavailable at %s, "
                             "retrying: %s", ev.get("tsns"), e)
                _time.sleep(2.0)
            except Exception as e:
                glog.error("replicate: event at %s failed "
                           "permanently, skipping: %s",
                           ev.get("tsns"), e)
                break


def cmd_filer_remote_gateway(args):
    """Bucket-aware remote mirror daemon (reference
    command/filer_remote_gateway.go): newly created buckets under
    /buckets auto-mount onto the configured remote, deleted buckets
    unmount, and local writes under /buckets continuously write back —
    the S3-gateway-to-cloud bridge. The data/credential plane stays in
    the filer (the /__api/remote endpoints), like filer.remote.sync."""
    import time as _time

    from seaweedfs_tpu_torch.replication.remote_sync import FilerRemoteSync
    from seaweedfs_tpu_torch.replication.sync import subscribe_meta_events
    from seaweedfs_tpu_torch.utils import glog
    from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json
    import fnmatch

    base = f"http://{args.filer}/__api/remote"

    def mount_bucket(bucket: str) -> None:
        if args.bucketPattern and not fnmatch.fnmatch(
                bucket, args.bucketPattern):
            return
        # each bucket dir maps to a same-named path on the remote —
        # works for any remote type (reference -createBucketAt keeps
        # local and remote bucket names 1:1 the same way)
        http_json("POST", f"{base}/mount",
                  {"dir": f"/buckets/{bucket}",
                   "remote_name": args.remote, "remote_path": bucket})

    # mount every pre-existing bucket first, then watch for churn
    try:
        listing = http_json("GET", f"http://{args.filer}/buckets/")
        existing = [e["FullPath"].rsplit("/", 1)[1]
                    for e in listing.get("Entries", [])
                    if e.get("IsDirectory")]
    except (ConnectionError, HttpError):
        existing = []
    for bucket in existing:
        try:
            mount_bucket(bucket)
        except (ConnectionError, HttpError) as e:
            raise SystemExit(f"mounting bucket {bucket} failed: {e}")
    print(f"filer.remote.gateway: mounted {existing}")
    sync = FilerRemoteSync(args.filer, "/buckets")
    sync.start(since_ns=int(_time.time() * 1e9))  # write-back plane
    for ev in subscribe_meta_events(args.filer,
                                    since_ns=int(_time.time() * 1e9),
                                    path_prefix="/buckets"):
        if ev is None:
            continue
        old, new = ev.get("old_entry"), ev.get("new_entry")

        def bucket_of(entry):
            if entry is None:
                return None
            p = entry["full_path"]
            if (p.startswith("/buckets/") and p.count("/") == 2
                    and entry.get("attr", {}).get("is_directory")):
                return p
            return None

        created, deleted = bucket_of(new), bucket_of(old)
        try:
            if created and not deleted:
                mount_bucket(created.rsplit("/", 1)[1])
                glog.info("gateway: mounted new bucket %s", created)
            elif deleted and new is None:
                http_json("POST", f"{base}/unmount", {"dir": deleted})
                glog.info("gateway: unmounted deleted bucket %s",
                          deleted)
        except (ConnectionError, HttpError) as e:
            glog.warning("gateway: bucket churn for %s failed: %s",
                         created or deleted, e)


def cmd_filer_cat(args):
    """Print a filer file to stdout (reference command/filer_cat.go)."""
    import urllib.parse

    from seaweedfs_tpu_torch.utils.httpd import http_call
    status, body, _ = http_call(
        "GET", f"http://{args.filer}{urllib.parse.quote(args.path)}")
    if status >= 400:
        raise SystemExit(f"HTTP {status}")
    sys.stdout.buffer.write(body)


def cmd_filer_copy(args):
    """Copy local files/dirs into the filer (reference
    command/filer_copy.go; `weed filer.copy file1 ... /dest/`)."""
    from seaweedfs_tpu_torch.shell.fs_commands import filer_copy
    n = filer_copy(args.filer, args.paths, args.dest)
    print(json.dumps({"copied": n, "dest": args.dest}))


def cmd_version(args):
    import platform
    print(json.dumps({
        "version": "0.1.0",
        "python": platform.python_version(),
        "platform": platform.platform(),
    }))


def cmd_master_follower(args):
    """Read-only follower master (reference command/master_follower.go):
    serves lookups from a vidMap — push-fed over the masters' gRPC
    KeepConnected stream when -grpcAddresses is given, else a TTL'd
    pull cache — and answers writes 409 with a leader hint so clients
    redirect."""
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    from seaweedfs_tpu_torch.utils.httpd import (HttpError, HttpServer,
                                                 Response, http_json)
    mc = MasterClient(args.masters.split(","),
                      grpc_address=(args.grpcAddresses.split(",")
                                    if args.grpcAddresses else None))
    srv = HttpServer(args.ip, args.port)

    def lookup(req):
        vid = int(req.query.get("volumeId", "0"))
        try:
            locs = mc.lookup_volume(vid, req.query.get("collection", ""))
        except HttpError:
            locs = []
        if not locs:
            return Response({"volumeId": vid, "locations": [],
                             "error": "volume not found"}, status=404)
        return Response({"volumeId": vid, "locations": locs})

    def lookup_ec(req):
        vid = int(req.query.get("volumeId", "0"))
        try:
            shards = mc.lookup_ec_volume(vid)
        except HttpError:
            shards = []
        return Response({"volumeId": vid, "shards": shards})

    def proxy_status(req):
        return Response(http_json(
            "GET", f"http://{mc.leader}/dir/status"))

    def not_leader(req):
        return Response({"error": "not leader", "leader": mc.leader},
                        status=409)

    srv.add("GET", "/dir/lookup", lookup)
    srv.add("GET", "/dir/lookup_ec", lookup_ec)
    srv.add("GET", "/dir/status", proxy_status)
    srv.add("GET", "/cluster/status", lambda req: Response(
        {"IsLeader": False, "Leader": mc.leader, "Peers": []}))
    for method, path in (("GET", "/dir/assign"), ("POST", "/dir/assign"),
                         ("POST", "/vol/grow")):
        srv.add(method, path, not_leader)
    srv.start()
    print(f"master.follower on {srv.host}:{srv.port}, "
          f"following {args.masters}", flush=True)
    _wait_forever()


def cmd_fuse(args):
    """fstab-style mount (reference command/fuse.go): options ride -o."""
    opts = dict(kv.split("=", 1) for kv in args.o.split(",")
                if "=" in kv)
    args.filer = opts.get("filer", "")
    args.master = opts.get("master", "127.0.0.1:9333")
    args.store = opts.get("store", "remote")
    cmd_mount(args)


def open_mount(master: str, filer: str = "", store: str = "remote"):
    """What `weed mount` serves, short of the kernel: WeedFS over the
    cluster's filer (its metadata through the remote store adapter, so
    the mount sees, and is seen by, every other client; other writers'
    changes reach its meta cache through the filer's change log), or over
    a private `store` when no filer is named or found through the master,
    and its gRPC admin plane (mount.proto Configure) announced to the
    master, where `mount.configure` finds it. Returns (WeedFS, the admin
    plane's port, close), close undoing all of it."""
    from seaweedfs_tpu_torch.mount.mount_grpc import start_mount_grpc
    from seaweedfs_tpu_torch.mount.weedfs import WeedFS
    from seaweedfs_tpu_torch.server.filer_server import FilerServer

    filer_addr = filer
    if not filer_addr and store == "remote":
        # discover a filer from the master's cluster registry
        from seaweedfs_tpu_torch.utils.httpd import http_json
        try:
            out = http_json(
                "GET", f"http://{master}/cluster/nodes?type=filer")
            nodes = out.get("cluster_nodes", [])
            filer_addr = nodes[0]["url"] if nodes else ""
        except ConnectionError:
            filer_addr = ""
    if filer_addr:
        fs = FilerServer(master, store="remote", store_dir=filer_addr,
                         announce=False)
    else:
        if store == "remote":
            raise SystemExit("no filer found via the master; pass "
                             "-filer host:port or -store memory/sqlite")
        # an embedded (HTTP-less) filer: private metadata
        fs = FilerServer(master, store=store)
    w = WeedFS(fs)
    if filer_addr:
        w.meta_cache.attach_http(filer_addr)
    # keep the server object referenced for the life of the mount — a
    # dropped grpc.Server is garbage-collected and stops listening
    admin_server, admin_port, announcing = start_mount_grpc(
        w, master_url=master)

    def close() -> None:
        announcing.set()
        admin_server.stop(grace=None)
        w.close()
        fs.reader_cache.close()
        fs.filer.close()
    return w, admin_port, close


def cmd_mount(args):
    """FUSE-mount a filer path (reference `weed mount -filer=...`): the
    kernel protocol served in-process (mount/fuse_kernel.py) over
    open_mount's WeedFS. Unmounting closes the mount's handles, its
    admin plane and its filer view."""
    from seaweedfs_tpu_torch.mount.fuse_kernel import FuseConnection
    w, admin_port, close = open_mount(args.master, args.filer, args.store)
    try:
        conn = FuseConnection(w, args.mountpoint)
    except BaseException:
        close()
        raise
    print(f"mounted seaweedfs-tpu at {args.mountpoint} "
          f"(admin grpc 127.0.0.1:{admin_port})", flush=True)
    try:
        conn.serve_forever(background=False)
    except KeyboardInterrupt:
        pass
    finally:
        conn.close()
        close()


def cmd_autocomplete(args):
    """Emit a bash completion script (reference command/autocomplete.go
    via posener/complete; here a plain `complete -W` wordlist)."""
    cmds = sorted(args._subcommands)
    wordlist = " ".join(cmds)
    print("# source this file, or add to ~/.bashrc:")
    print(f"complete -W '{wordlist}' weed-tpu")
    print(f"# complete -W '{wordlist}' python -m seaweedfs_tpu_torch.cli")


def cmd_upload(args):
    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    mc = MasterClient(args.master)
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        res = operation.upload_data(mc, data, name=path,
                                    collection=args.collection,
                                    replication=args.replication)
        print(json.dumps({"file": path, "fid": res.fid, "size": res.size}))


def cmd_download(args):
    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    mc = MasterClient(args.master)
    data = operation.read_data(mc, args.fid)
    out = args.output or args.fid.replace(",", "_")
    with open(out, "wb") as f:
        f.write(data)
    print(f"{args.fid} -> {out} ({len(data)} bytes)")


def cmd_delete(args):
    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    mc = MasterClient(args.master)
    for fid in args.fids:
        ok = operation.delete_file(mc, fid)
        print(json.dumps({"fid": fid, "deleted": ok}))


def cmd_shell(args):
    from seaweedfs_tpu_torch.shell.repl import run_repl
    run_repl(args.master)


def cmd_ec(args):
    from seaweedfs_tpu_torch.shell.commands import ShellContext
    sh = ShellContext(args.master)
    sh.lock()
    try:
        if args.op == "encode":
            out = sh.ec_encode(vid=args.volumeId,
                               collection=args.collection or "")
        elif args.op == "rebuild":
            out = sh.ec_rebuild()
        elif args.op == "balance":
            out = [vars(m) for m in sh.ec_balance()]
        elif args.op == "decode":
            out = sh.ec_decode(args.volumeId)
        else:
            raise SystemExit(f"unknown ec op {args.op}")
        print(json.dumps(out, default=str, indent=2))
    finally:
        sh.unlock()


def cmd_fix(args):
    from seaweedfs_tpu_torch.storage.maintenance import fix_volume
    stats = {}
    live = fix_volume(args.base, stats=stats)
    print(json.dumps({"base": args.base, "live_entries": live,
                      "crc_errors": stats.get("crc_errors", 0)}))


def cmd_export(args):
    from seaweedfs_tpu_torch.storage.maintenance import export_volume
    count = export_volume(args.base, args.output)
    print(json.dumps({"base": args.base, "exported": count}))


def cmd_backup(args):
    from seaweedfs_tpu_torch.storage.maintenance import backup_volume
    base = backup_volume(args.master, args.volumeId, args.output,
                         args.collection)
    print(json.dumps({"backed_up": base}))


def cmd_compact(args):
    from seaweedfs_tpu_torch.storage.maintenance import compact_volume
    before, after = compact_volume(args.base)
    print(json.dumps({"before_bytes": before, "after_bytes": after}))


def cmd_scaffold(args):
    from seaweedfs_tpu_torch.utils.config import scaffold
    text = scaffold(args.config)
    if args.output == "-":
        print(text)
    else:
        path = f"{args.output}/{args.config}.toml"
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path}")


def cmd_benchmark(args):
    """weed benchmark equivalent: write then randomly read N small files
    (reference weed/command/benchmark.go). A request that a server's
    admission control sheds (HTTP 503) is retried after a short capped
    backoff and counted as ``shed_retries`` in its line, where the
    reference's Python benchmark stops at the first; the line has that
    key only when something was shed."""
    import concurrent.futures
    import random

    import numpy as np

    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.client.wdclient import MasterClient
    mc = MasterClient(args.master)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, args.size, dtype=np.uint8).tobytes()

    tcp_clients = {}
    tcp_lock = __import__("threading").Lock()

    def tcp_client_for(url: str):
        """One persistent TCP connection per (volume server, thread)."""
        import threading as _th
        from seaweedfs_tpu_torch.server.volume_tcp import TcpClient
        from seaweedfs_tpu_torch.utils.httpd import http_json
        key = (url, _th.get_ident())
        with tcp_lock:
            c = tcp_clients.get(key)
        if c is None:
            # status probe outside the lock: the key is per-thread, so
            # no other thread can race this entry, and holding the lock
            # across the HTTP round-trip would serialize every bench
            # thread behind one slow volume server
            st = http_json("GET", f"http://{url}/status")
            if "TcpPort" not in st:
                raise SystemExit(
                    f"{url} has no TCP port; start volume with -tcp")
            host = url.rsplit(":", 1)[0]
            c = TcpClient(host, st["TcpPort"])
            with tcp_lock:
                tcp_clients[key] = c
        return c

    class FidDispenser:
        """Batch the assign plane: one master round-trip mints
        `batch` sequential keys (same cookie, key+i), the documented
        count=N semantics (reference operation/assign_file_id.go) —
        so the write loop measures the DATA path."""

        def __init__(self, mc, batch: int):
            import threading as _th
            self.mc = mc
            self.batch = max(1, batch)
            self.lock = _th.Lock()
            self.queue: list[tuple[str, str]] = []

        def next(self) -> tuple[str, str, str]:
            from seaweedfs_tpu_torch.storage.file_id import (
                format_needle_id_cookie, parse_needle_id_cookie)
            with self.lock:
                if not self.queue:
                    a = self.mc.assign(count=self.batch)
                    if a.get("error"):
                        raise SystemExit(a["error"])
                    if a.get("auth") and self.batch > 1:
                        # JWT-secured cluster: the token covers only the
                        # base fid, so batched key derivation can't be
                        # authorized — fall back to per-file assigns
                        self.batch = 1
                    vid, rest = a["fid"].split(",", 1)
                    key, cookie = parse_needle_id_cookie(rest)
                    count = 1 if a.get("auth") else a.get("count", 1)
                    self.queue = [
                        (f"{vid},{format_needle_id_cookie(key + i, cookie)}",
                         a["url"], a.get("auth", ""))
                        for i in range(count)]
                return self.queue.pop()

    from seaweedfs_tpu_torch.utils.httpd import HttpError
    shed = {"write": 0, "read": 0}

    def unshed(op, fn, attempts=20):
        for attempt in range(attempts):
            try:
                return fn()
            except HttpError as e:
                if e.status != 503 or attempt == attempts - 1:
                    raise
                with tcp_lock:
                    shed[op] += 1
                clockctl.sleep(min(0.5, 0.005 * 2 ** attempt))

    dispenser = FidDispenser(mc, args.assignBatch)
    fids = []
    t0 = clockctl.monotonic()
    lat = []

    def write_one(i):
        s = clockctl.monotonic()
        fid, url, auth = dispenser.next()
        if args.useTcp:
            tcp_client_for(url).write(fid, payload)
        else:
            unshed("write", lambda: operation.upload_to(fid, url, payload,
                                                        auth=auth))
        lat.append(clockctl.monotonic() - s)
        return fid

    with concurrent.futures.ThreadPoolExecutor(args.concurrency) as ex:
        fids = list(ex.map(write_one, range(args.n)))
    dt = clockctl.monotonic() - t0
    _report("write", args.n, args.size, dt, lat, shed["write"])

    lat = []
    t0 = clockctl.monotonic()

    def read_one(_):
        fid = random.choice(fids)
        s = clockctl.monotonic()
        if args.useTcp:
            vid = int(fid.split(",")[0])
            url = mc.lookup_volume(vid)[0]["url"]
            data = tcp_client_for(url).read(fid)
        else:
            data = unshed("read", lambda: operation.read_data(mc, fid))
        lat.append(clockctl.monotonic() - s)
        assert len(data) == args.size

    with concurrent.futures.ThreadPoolExecutor(args.concurrency) as ex:
        list(ex.map(read_one, range(args.n)))
    dt = clockctl.monotonic() - t0
    _report("read", args.n, args.size, dt, lat, shed["read"])
    for c in tcp_clients.values():
        c.close()


def _report(op, n, size, dt, lat, shed_retries=0):
    lat.sort()
    pct = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))] * 1000
    line = {
        "op": op, "requests_per_sec": round(n / dt, 2),
        "transfer_mb_per_sec": round(n * size / dt / 1e6, 2),
        "p50_ms": round(pct(0.5), 2), "p95_ms": round(pct(0.95), 2),
        "p99_ms": round(pct(0.99), 2), "max_ms": round(lat[-1] * 1000, 2),
    }
    if shed_retries:
        line["shed_retries"] = shed_retries
    print(json.dumps(line))


def _wait_forever():
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def _serve_until_signal(*servers, ready: str = ""):
    """Block until SIGTERM/SIGINT, then stop the given servers in
    order. Volume servers drain gracefully (their stop() finishes
    in-flight requests, flushes the group commit, and sends a final
    draining heartbeat) — list them BEFORE their master so the
    announcement still has someone to hear it. The `ready` line is
    printed once the signal hooks are in place (the reference prints it
    before them, so a SIGTERM right after it could kill the process
    undrained)."""
    import signal
    import threading
    stop_ev = threading.Event()
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda signum, frame: stop_ev.set())
    except ValueError:
        # not the main thread (embedded/test use): no signal hooks
        pass
    if ready:
        print(ready, flush=True)
    try:
        while not stop_ev.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    for srv in servers:
        try:
            srv.stop()
        except Exception as e:
            print(f"stop {type(srv).__name__}: {e}", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(prog="weed-tpu")
    # global logging/metrics surface (reference glog -v/-vmodule flags,
    # weed.go MaxSize; stats/metrics.go push gateway)
    p.add_argument("-v", type=int, default=0, dest="verbosity",
                   help="verbose log level (glog -v)")
    p.add_argument("-vmodule", default="",
                   help="per-module verbosity, e.g. volume_server=3")
    p.add_argument("-logfile", default="",
                   help="rotating log file (default: stderr only)")
    p.add_argument("-metricsAddress", default="",
                   help="Prometheus push gateway host:port")
    p.add_argument("-metricsIntervalSec", type=int, default=15)
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("master")
    m.add_argument("-ip", default="127.0.0.1")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    m.add_argument("-defaultReplication", default="000")
    m.add_argument("-mdir", default="", help="state persistence dir")
    m.add_argument("-grpc", action="store_true",
                   help="also serve the gRPC plane on port+10000")
    m.add_argument("-peers", default="",
                   help="comma-separated master group urls (raft HA)")
    m.add_argument("-repairRateMBps", type=float, default=0.0,
                   help="cluster-wide EC repair bandwidth budget shared "
                        "across concurrent rebuilds (0 = unlimited)")
    m.add_argument("-tierEndpoint", default="",
                   help="S3 endpoint URL for the tiering autopilot's "
                        "cloud rung (empty keeps cloud demotion off; "
                        "hot<->ec transitions still run)")
    m.add_argument("-tierBucket", default="tier",
                   help="bucket on -tierEndpoint holding demoted volumes")
    m.set_defaults(fn=cmd_master)

    v = sub.add_parser("volume")
    _add_common_volume_args(v)
    v.set_defaults(fn=cmd_volume)

    s = sub.add_parser("server")
    _add_common_volume_args(s)
    s.add_argument("-masterPort", type=int, default=9333)
    s.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    s.add_argument("-filer", action="store_true")
    s.add_argument("-filerPort", type=int, default=8888)
    s.add_argument("-s3", action="store_true")
    s.add_argument("-s3Port", type=int, default=8333)
    s.set_defaults(fn=cmd_server)

    fl = sub.add_parser("filer", help="standalone filer (reference `weed filer`)")
    fl.add_argument("-ip", default="127.0.0.1")
    fl.add_argument("-port", type=int, default=8888)
    fl.add_argument("-master", default="127.0.0.1:9333")
    fl.add_argument("-store", default="memory",
                    choices=["memory", "sqlite", "lsm", "redis", "etcd",
                             "mysql", "postgres", "mongodb", "cassandra",
                             "elastic"])
    fl.add_argument("-dir", default=".", help="store/state directory")
    fl.add_argument("-defaultReplication", default="")
    fl.add_argument("-encryptVolumeData", action="store_true",
                    help="AES-256-GCM encrypt chunks (reference flag)")
    fl.add_argument("-ftp", action="store_true", help="serve FTP gateway")
    fl.add_argument("-ftpPort", type=int, default=0)
    fl.add_argument("-sharding", action="store_true",
                    help="join the consistent-hash filer shard ring; "
                         "mis-routed ops 307 to the owning peer")
    fl.add_argument("-noEntryCache", action="store_true",
                    help="disable the hot-entry + negative-lookup cache "
                         "(bit-for-bit comparator mode)")
    fl.add_argument("-grpc", action="store_true",
                    help="serve the filer_pb gRPC plane on port+10000")
    fl.add_argument("-mq", action="store_true",
                    help="serve the mq broker gRPC plane (weed mq.broker)")
    fl.add_argument("-mqPort", type=int, default=0)
    fl.set_defaults(fn=cmd_filer)

    for gw_name, default_port in (("s3", 8333), ("webdav", 7333),
                                  ("ftp", 2121)):
        g = sub.add_parser(
            gw_name,
            help=f"standalone {gw_name} gateway over a remote filer")
        g.add_argument("-ip", default="127.0.0.1")
        g.add_argument("-port", type=int, default=default_port)
        g.add_argument("-filer", default="127.0.0.1:8888",
                       help="filer address holding the metadata")
        g.add_argument("-master", default="127.0.0.1:9333")
        g.set_defaults(fn=cmd_gateway)

    fsy = sub.add_parser("filer.sync",
                         help="active-active sync between two filers")
    fsy.add_argument("-a", required=True, help="filer A host:port")
    fsy.add_argument("-b", required=True, help="filer B host:port")
    fsy.add_argument("-aPrefix", default="/",
                     help="A-side source path filter")
    fsy.add_argument("-bPrefix", default="/",
                     help="B-side source path filter (bidirectional) "
                          "or destination prefix on B (-oneWay)")
    fsy.add_argument("-oneWay", action="store_true",
                     help="only replicate A -> B")
    fsy.add_argument("-since", type=int, default=0,
                     help="start cursor (ns); 0 = replay everything")
    fsy.set_defaults(fn=cmd_filer_sync)

    frp = sub.add_parser(
        "filer.replicate",
        help="apply a filer's event stream to the replication.toml sink")
    frp.add_argument("-filer", default="127.0.0.1:8888")
    frp.add_argument("-path", default="/", help="source path filter")
    frp.add_argument("-sinceNs", type=int, default=0,
                     help="start cursor (ns); 0 = replay everything")
    frp.add_argument("-fromNow", action="store_true",
                     help="skip history, replicate new events only")
    frp.set_defaults(fn=cmd_filer_replicate)

    frg = sub.add_parser(
        "filer.remote.gateway",
        help="auto-mount new buckets to the remote and write back "
             "(S3-gateway-to-cloud bridge)")
    frg.add_argument("-filer", default="127.0.0.1:8888")
    frg.add_argument("-remote", required=True,
                     help="configured remote name (remote.configure)")
    frg.add_argument("-bucketPattern", default="",
                     help="only bridge buckets matching this glob")
    frg.set_defaults(fn=cmd_filer_remote_gateway)

    mf = sub.add_parser(
        "master.follower",
        help="read-only master follower serving lookups from a "
             "push-fed vidMap")
    mf.add_argument("-ip", default="127.0.0.1")
    mf.add_argument("-port", type=int, default=9334)
    mf.add_argument("-masters", default="127.0.0.1:9333",
                    help="comma-separated master group urls")
    mf.add_argument("-grpcAddresses", default="",
                    help="masters' gRPC addresses (port+10000 when "
                         "started with -grpc): enables the push-fed "
                         "vidMap instead of cached pull lookups")
    mf.set_defaults(fn=cmd_master_follower)

    fbk = sub.add_parser("filer.backup",
                         help="continuous filer backup to a sink")
    fbk.add_argument("-filer", default="127.0.0.1:8888")
    fbk.add_argument("-filerPath", default="/")
    fbk.add_argument("-dir", default="./filer_backup",
                     help="local mirror directory sink")
    fbk.add_argument("-endpoint", default="",
                     help="S3-dialect endpoint sink (overrides -dir)")
    fbk.add_argument("-bucket", default="")
    fbk.add_argument("-keyPrefix", default="")
    fbk.add_argument("-accessKey", default="")
    fbk.add_argument("-secretKey", default="")
    fbk.add_argument("-since", type=int, default=0)
    fbk.set_defaults(fn=cmd_filer_backup)

    fct = sub.add_parser("filer.cat", help="print a filer file")
    fct.add_argument("-filer", default="127.0.0.1:8888")
    fct.add_argument("path")
    fct.set_defaults(fn=cmd_filer_cat)

    fcp = sub.add_parser("filer.copy",
                         help="copy local files into the filer")
    fcp.add_argument("-filer", default="127.0.0.1:8888")
    fcp.add_argument("paths", nargs="+")
    fcp.add_argument("dest")
    fcp.set_defaults(fn=cmd_filer_copy)

    fmb = sub.add_parser("filer.meta.backup",
                         help="dump the filer meta log to JSONL")
    fmb.add_argument("-filer", default="127.0.0.1:8888")
    fmb.add_argument("-filerPath", default="/")
    fmb.add_argument("-o", dest="output", default="filer_meta.jsonl")
    fmb.add_argument("-follow", action="store_true",
                     help="keep tailing instead of a one-shot dump")
    fmb.set_defaults(fn=cmd_filer_meta_backup)

    fmt_ = sub.add_parser("filer.meta.tail",
                          help="print filer meta events")
    fmt_.add_argument("-filer", default="127.0.0.1:8888")
    fmt_.add_argument("-pathPrefix", default="/")
    fmt_.add_argument("-n", type=int, default=16)
    fmt_.set_defaults(fn=cmd_filer_meta_tail)

    frs = sub.add_parser("filer.remote.sync",
                         help="write-back daemon for a remote mount")
    frs.add_argument("-filer", default="127.0.0.1:8888")
    frs.add_argument("-dir", required=True, help="mounted directory")
    frs.set_defaults(fn=cmd_filer_remote_sync)

    im = sub.add_parser("iam", help="standalone IAM API server")
    im.add_argument("-ip", default="127.0.0.1")
    im.add_argument("-port", type=int, default=8111)
    im.add_argument("-filer", default="127.0.0.1:8888")
    im.add_argument("-master", default="127.0.0.1:9333")
    im.set_defaults(fn=cmd_iam)

    ac = sub.add_parser("autocomplete",
                        help="emit a bash completion wordlist")
    ac.set_defaults(fn=cmd_autocomplete)

    ver = sub.add_parser("version", help="print version info")
    ver.set_defaults(fn=cmd_version)

    fu = sub.add_parser(
        "fuse", help="mount via fstab conventions (reference weed fuse: "
                     "`weed-tpu fuse /mnt -o filer=host:port`)")
    fu.add_argument("mountpoint")
    fu.add_argument("-o", default="", help="comma-separated options: "
                    "filer=,master=,store=")
    fu.set_defaults(fn=cmd_fuse)

    u = sub.add_parser("upload")
    u.add_argument("-master", default="127.0.0.1:9333")
    u.add_argument("-collection", default="")
    u.add_argument("-replication", default="")
    u.add_argument("files", nargs="+")
    u.set_defaults(fn=cmd_upload)

    d = sub.add_parser("download")
    d.add_argument("-master", default="127.0.0.1:9333")
    d.add_argument("-output", default="")
    d.add_argument("fid")
    d.set_defaults(fn=cmd_download)

    de = sub.add_parser("delete")
    de.add_argument("-master", default="127.0.0.1:9333")
    de.add_argument("fids", nargs="+")
    de.set_defaults(fn=cmd_delete)

    sh = sub.add_parser("shell")
    sh.add_argument("-master", default="127.0.0.1:9333")
    sh.set_defaults(fn=cmd_shell)

    ec = sub.add_parser("ec")
    ec.add_argument("op", choices=["encode", "rebuild", "balance", "decode"])
    ec.add_argument("-master", default="127.0.0.1:9333")
    ec.add_argument("-volumeId", type=int, default=None)
    ec.add_argument("-collection", default=None)
    ec.set_defaults(fn=cmd_ec)

    mt = sub.add_parser("mount")
    mt.add_argument("-master", default="127.0.0.1:9333")
    mt.add_argument("-filer", default="",
                    help="filer host:port holding the namespace "
                         "(default: discovered from the master)")
    mt.add_argument("-store", default="remote",
                    help="remote (cluster filer, default) or a private "
                         "memory/sqlite/lsm store")
    mt.add_argument("mountpoint")
    mt.set_defaults(fn=cmd_mount)

    fx = sub.add_parser("fix")
    fx.add_argument("base", help="volume base path (no extension)")
    fx.set_defaults(fn=cmd_fix)

    ex = sub.add_parser("export")
    ex.add_argument("base")
    ex.add_argument("-output", default="./export")
    ex.set_defaults(fn=cmd_export)

    bk = sub.add_parser("backup")
    bk.add_argument("-master", default="127.0.0.1:9333")
    bk.add_argument("-volumeId", type=int, required=True)
    bk.add_argument("-collection", default="")
    bk.add_argument("-output", default="./backup")
    bk.set_defaults(fn=cmd_backup)

    cp = sub.add_parser("compact")
    cp.add_argument("base")
    cp.set_defaults(fn=cmd_compact)

    sc = sub.add_parser("scaffold")
    sc.add_argument("-config", default="security",
                    choices=["security", "master", "filer", "replication",
                             "notification", "shell"])
    sc.add_argument("-output", default="-")
    sc.set_defaults(fn=cmd_scaffold)

    b = sub.add_parser("benchmark")
    b.add_argument("-master", default="127.0.0.1:9333")
    b.add_argument("-n", type=int, default=1000)
    b.add_argument("-size", type=int, default=1024)
    b.add_argument("-concurrency", type=int, default=16)
    b.add_argument("-assignBatch", type=int, default=16,
                   help="keys minted per master assign (count=N)")
    b.add_argument("-useTcp", action="store_true",
                   help="use the raw TCP data path (reference -useTcp)")
    b.set_defaults(fn=cmd_benchmark)

    args = p.parse_args(argv)
    args._subcommands = list(sub.choices)
    from seaweedfs_tpu_torch.utils import glog
    glog.set_verbosity(args.verbosity)
    if args.vmodule:
        glog.set_vmodule(args.vmodule)
    if args.logfile:
        glog.set_log_file(args.logfile)
    args.fn(args)


if __name__ == "__main__":
    main()
