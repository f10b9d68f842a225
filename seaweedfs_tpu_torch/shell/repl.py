"""Interactive admin shell (reference weed/shell/shell_liner.go).

The port's copy of seaweedfs_tpu/shell/repl.py: the same commands, help
text and output, run on the port's ShellContext, with the ``fs.*`` family
and ``volume.fsck`` on the port's filer, the ``remote.*`` family on the
filer's remote mounts and the ``s3.*`` family on the gateway's filer
entries; ``fs.meta.tail`` through replication/sync.py, ``mq.topic.list``
on the broker's topics in the filer, and ``mount.configure`` over each
mount's gRPC admin plane (mount/mount_grpc.py). It takes no device and
imports nothing of that package.
"""

from __future__ import annotations

import json
import shlex

from seaweedfs_tpu_torch.shell.commands import ShellContext

HELP = """commands:
  fs.ls/cat/rm/mkdir/mv/du/tree <path> [..]   filer namespace ops
  fs.cd <dir> / fs.pwd              relative paths resolve against cwd
  fs.meta.notify [-root /p]         resend subtree to notification queue
  fs.configure -locationPrefix /p [-collection C] [-ttl T] [-readOnly] [-delete]
  remote.configure -name N [-type local] [-root DIR] | -delete N
  remote.mount -dir /m -remote N [-path prefix]
  remote.mount.buckets -remote N [-bucketPattern G]
  remote.unmount -dir /m
  remote.meta.sync -dir /m          pull remote listing into the filer
  remote.cache/uncache -path /m/f   materialize / drop local chunk copy
  remote.status
  fs.meta.save [-root /p] [-o file] / fs.meta.load -i file / fs.meta.tail
  s3.bucket.list / s3.bucket.create -name B / s3.bucket.delete -name B
  s3.bucket.quota -name B -sizeMB N | -name B -disable
  s3.bucket.quota.check             usage vs quota per bucket
  volume.list                       show topology
  volume.fix.replication [-n]      re-replicate under-replicated volumes
  volume.check.disk [-volumeId N] [-fix]   cross-check replica contents
  volume.fsck [-fix] [-collection C]   cross filer<->volume orphan check
  volume.move -volumeId N -source HOST -target HOST
  volume.copy -volumeId N -source HOST -target HOST
  volume.mount/unmount/delete -volumeId N -node HOST
  volume.mark -volumeId N -node HOST [-readonly|-writable]
  volume.configure.replication -volumeId N -replication XYZ
  volume.delete_empty [-n]          drop volumes with zero live files
  volume.balance [-n]               even volume counts across nodes
  volume.server.evacuate -node HOST [-n]
  volume.server.leave -node HOST
  volume.tail -volumeId N [-since NS]   stream appended needles
  volume.tier.upload -volumeId N -endpoint URL -bucket B [-keepLocal]
  volume.tier.download -volumeId N
  volume.tier.status [-volumeId N]  tiering autopilot: temps, rungs, mover
  volume.tier.move -volumeId N -toRung hot|ec|cloud [-endpoint URL] [-bucket B]
  volume.tier.move [-toDiskType ssd] [-toNode HOST] [-fullPercent P] [-quietFor S] [-n]
  volume.vacuum [threshold]         compact garbage-heavy volumes
  cluster.ps                        list every cluster process
  cluster.raft.ps / cluster.raft.add -peer URL / cluster.raft.remove -peer URL
  mq.topic.list                     list broker topics (filer /topics tree)
  s3.configure -user U -access K -secret S [-actions a,b] | -delete U
  s3.clean.uploads [-timeAgo SECONDS]   purge stale multipart uploads
  s3.circuitbreaker [-bucket B] [-read N] [-write N] [-disable]
  mount.configure -collectionCapacity BYTES   statfs quota on live mounts
  fs.meta.cat <path>                one entry's raw metadata
  ec.encode [-volumeId N] [-collection C] [-code rs|lrc]
  ec.rebuild [-n]
  ec.balance [-n]
  ec.decode -volumeId N
  ec.scheme.status [-volumeId N]    per-volume code family (RS/LRC), group
                                    rack alignment, last repair strategy
  ec.repair.status                  master repair queue depth/lag/backoffs
  ec.repair.kick                    clear backoffs, dispatch queued repairs
  cluster.health                    per-peer circuit breakers, scrub state,
                                    repair bandwidth budget
  cluster.leases                    assign-lease grant table (holder, range,
                                    epoch, remaining) + mint/refuse stats
  cluster.qos [-node HOST:PORT] [-limit N] [-minLimit N] [-maxLimit N]
              [-tenantRate R] [-tenantBurst B] [-enable|-disable]
                                    per-node admission-control view; with
                                    flags, reconfigures the governors
  cluster.trace [-trace ID] [-minMs MS] [-limit N]
                                    recent slow traces cluster-wide; with
                                    -trace, that trace's stitched spans
  cluster.shards                    filer ring + per-shard routing/cache stats
  cluster.telemetry [-topK N] [-noPeers]
                                    merged RED quantiles + exemplars,
                                    hot-key leaderboard, SLO burn alerts
  cluster.profile [-seconds N] [-topK N]
                                    merged wall-stack window from every
                                    node's sampler: per-class CPU share
                                    + hottest stacks
  volume.scrub [-node HOST:PORT] [-volumeId N]   synchronous integrity pass
  lock / unlock
  help / exit
"""


def run_repl(master_url: str) -> None:
    sh = ShellContext(master_url)
    print(f"connected to master {master_url}; `help` for commands")
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return
        if not line:
            continue
        try:
            out = run_command(sh, line)
        except SystemExit:
            return
        except Exception as e:
            print(f"error: {type(e).__name__}: {e}")
            continue
        if out is not None:
            print(json.dumps(out, default=str, indent=2))


def _find_filer(sh: ShellContext) -> str:
    from seaweedfs_tpu_torch.utils.httpd import http_json
    out = http_json("GET",
                    f"http://{sh.master_url}/cluster/nodes?type=filer")
    nodes = out.get("cluster_nodes", [])
    if not nodes:
        raise RuntimeError("no filer registered with the master")
    return nodes[0]["url"]


def _fs_command(sh: ShellContext, cmd: str, args: list[str],
                flags: dict):
    import posixpath

    from seaweedfs_tpu_torch.shell.fs_commands import FsContext
    op = cmd[3:]
    fsc = FsContext(_find_filer(sh))
    cwd = getattr(sh, "cwd", "/")

    def rp(p: str) -> str:
        # relative paths resolve against the REPL's fs.cd state
        # (reference command_fs_cd.go / fs_pwd.go)
        return p if p.startswith("/") \
            else posixpath.normpath(posixpath.join(cwd, p))
    if op == "cd":
        target = rp(args[0]) if args else "/"
        fsc.ls(target)  # raises if not a directory
        sh.cwd = target
        return {"cwd": target}
    if op == "pwd":
        return {"cwd": cwd}
    if op == "ls":
        return fsc.ls(rp(args[0]) if args else cwd)
    if op == "cat":
        data = fsc.cat(rp(args[0]))
        print(data.decode(errors="replace"))
        return None
    if op == "rm":
        paths = [a for a in args if not a.startswith("-")]
        fsc.rm(rp(paths[0]), recursive="-r" in args)
        return {"removed": rp(paths[0])}
    if op == "mkdir":
        fsc.mkdir(rp(args[0]))
        return {"created": rp(args[0])}
    if op == "mv":
        fsc.mv(rp(args[0]), rp(args[1]))
        return {"moved": [rp(args[0]), rp(args[1])]}
    if op == "du":
        files, size = fsc.du(rp(args[0]) if args else cwd)
        return {"files": files, "bytes": size}
    if op == "tree":
        for line_ in fsc.tree(rp(args[0]) if args else cwd):
            print(line_)
        return None
    if op == "meta.notify":
        # resend a subtree's entries to the configured notification
        # queue (reference command_fs_meta_notify.go loads
        # notification.toml in the shell process the same way)
        from seaweedfs_tpu_torch.notification.queue import \
            make_queue_from_config
        mq = make_queue_from_config()
        if mq is None:
            raise RuntimeError(
                "no notification backend enabled in notification.toml")
        root = rp(flags.get("root", cwd))
        sent = 0

        def walk(d: str):
            nonlocal sent
            for e in fsc.ls(d, limit=1 << 20):
                if e.get("IsDirectory"):
                    walk(e["FullPath"])
                else:
                    mq.send_message(e["FullPath"], {
                        "event": "create", "new_entry": e})
                    sent += 1
        walk(root)
        mq.close()
        return {"notified": sent, "root": root}
    if op == "meta.save":
        from seaweedfs_tpu_torch.shell.fs_commands import fs_meta_save
        n = fs_meta_save(fsc.filer_url, flags.get("root", "/"),
                         flags.get("o", "filer_meta.jsonl"))
        return {"saved": n, "file": flags.get("o", "filer_meta.jsonl")}
    if op == "meta.load":
        from seaweedfs_tpu_torch.shell.fs_commands import fs_meta_load
        src = flags.get("i")
        if not src:
            raise ValueError("usage: fs.meta.load -i <dump.jsonl>")
        return {"loaded": fs_meta_load(fsc.filer_url, src)}
    if op == "meta.cat":
        # raw metadata of one entry (reference command_fs_meta_cat.go)
        import urllib.parse

        from seaweedfs_tpu_torch.utils.httpd import http_json
        return http_json(
            "GET", f"http://{fsc.filer_url}/__api/entry?path="
                   f"{urllib.parse.quote(args[-1], safe='')}")
    if op == "meta.tail":
        from seaweedfs_tpu_torch.replication.sync import meta_tail
        # `-n` is the dry-run switch to _parse_flags, which never gives
        # it a value (the JAX REPL so always tails 16): read it here
        i = args.index("-n") + 1 if "-n" in args else len(args)
        n = meta_tail(fsc.filer_url,
                      path_prefix=flags.get("pathPrefix", "/"),
                      max_events=int(args[i]) if i < len(args) else 16,
                      aggregated="-aggregated" in args)
        return {"events": n}
    if op == "configure":
        # per-path storage rules (reference command_fs_configure.go)
        from seaweedfs_tpu_torch.utils.httpd import http_json
        body = {"location_prefix": flags.get("locationPrefix", "/")}
        if "-delete" in args:
            body["delete"] = True
        for k_flag, k_body in (("collection", "collection"),
                               ("replication", "replication"),
                               ("ttl", "ttl"), ("disk", "disk_type")):
            if k_flag in flags:
                body[k_body] = flags[k_flag]
        if "-readOnly" in args:
            body["read_only"] = True
        return http_json(
            "POST", f"http://{fsc.filer_url}/__api/filer_conf", body)
    raise ValueError(f"unknown fs command {op!r}")


def run_command(sh: ShellContext, line: str):
    parts = shlex.split(line)
    cmd, args = parts[0], parts[1:]
    flags = _parse_flags(args)
    apply = "-n" not in args
    if cmd in ("exit", "quit"):
        raise SystemExit
    if cmd == "help":
        print(HELP)
        return None
    if cmd == "lock":
        sh.lock()
        return {"locked": True}
    if cmd == "unlock":
        sh.unlock()
        return {"locked": False}
    if cmd.startswith("fs."):
        return _fs_command(sh, cmd, args, flags)
    if cmd.startswith("remote."):
        # reference shell command_remote_*.go
        from seaweedfs_tpu_torch.utils.httpd import http_json
        filer = _find_filer(sh)
        base = f"http://{filer}/__api/remote"
        op = cmd[len("remote."):]
        if op == "configure":
            if "delete" in flags:
                return http_json("POST", f"{base}/configure",
                                 {"name": flags["delete"], "delete": True})
            return http_json("POST", f"{base}/configure", {
                "name": flags["name"],
                "type": flags.get("type", "local"),
                "root": flags.get("root", ""),
                "endpoint": flags.get("endpoint", ""),
                "bucket": flags.get("bucket", ""),
                "access_key": flags.get("accessKey", ""),
                "secret_key": flags.get("secretKey", ""),
                "region": flags.get("region", "us-east-1")})
        if op == "mount.buckets":
            return http_json("POST", f"{base}/mount_buckets", {
                "remote_name": flags["remote"],
                "bucket_pattern": flags.get("bucketPattern", "")})
        if op == "mount":
            return http_json("POST", f"{base}/mount", {
                "dir": flags["dir"], "remote_name": flags["remote"],
                "remote_path": flags.get("path", "")})
        if op == "unmount":
            return http_json("POST", f"{base}/unmount",
                             {"dir": flags["dir"]})
        if op == "meta.sync":
            return http_json("POST", f"{base}/pull", {"dir": flags["dir"]})
        if op == "cache":
            return http_json("POST", f"{base}/cache",
                             {"path": flags["path"]})
        if op == "uncache":
            return http_json("POST", f"{base}/uncache",
                             {"path": flags["path"]})
        if op == "status":
            return http_json("GET", f"{base}/status")
        raise ValueError(f"unknown remote command {op!r}")
    if cmd == "volume.list":
        return sh.volume_list()
    if cmd == "volume.check.disk":
        vid = int(flags["volumeId"]) if "volumeId" in flags else None
        return sh.volume_check_disk(vid=vid, fix="-fix" in args)
    if cmd == "volume.fsck":
        return sh.volume_fsck(_find_filer(sh), fix="-fix" in args,
                              collection=flags.get("collection", ""))
    if cmd == "volume.move":
        sh.volume_move(int(flags["volumeId"]), flags["source"],
                       flags["target"], flags.get("collection", ""))
        return {"moved": int(flags["volumeId"])}
    if cmd == "volume.copy":
        sh.volume_copy(int(flags["volumeId"]), flags["source"],
                       flags["target"], flags.get("collection", ""))
        return {"copied": int(flags["volumeId"])}
    if cmd == "volume.mount":
        return sh.volume_mount(int(flags["volumeId"]), flags["node"])
    if cmd == "volume.unmount":
        return sh.volume_unmount(int(flags["volumeId"]), flags["node"])
    if cmd == "volume.delete":
        return sh.volume_delete(int(flags["volumeId"]), flags["node"])
    if cmd == "volume.mark":
        return sh.volume_mark(int(flags["volumeId"]), flags["node"],
                              readonly="-writable" not in args)
    if cmd == "volume.configure.replication":
        return sh.volume_configure_replication(int(flags["volumeId"]),
                                               flags["replication"])
    if cmd == "volume.delete_empty":
        return sh.volume_delete_empty(
            apply=apply, quiet_for=float(flags.get("quietFor", 3600)))
    if cmd == "volume.server.evacuate":
        return sh.volume_server_evacuate(flags["node"], apply=apply)
    if cmd == "volume.server.leave":
        return sh.volume_server_leave(flags["node"])
    if cmd == "volume.tail":
        return sh.volume_tail(int(flags["volumeId"]),
                              since_ns=int(flags.get("since", 0)))
    if cmd == "mount.configure":
        # push a statfs quota to every live mount via its admin plane
        # (reference command_mount_configure.go -> mount_pb.Configure)
        from seaweedfs_tpu_torch.mount.mount_grpc import MountAdminClient
        from seaweedfs_tpu_torch.utils.httpd import http_json
        out = http_json(
            "GET", f"http://{sh.master_url}/cluster/nodes?type=mount")
        mounts = out.get("cluster_nodes", [])
        capacity = int(flags.get("collectionCapacity", -1))
        results = {}
        for node in mounts:
            # a mount that died within the registry's 60s TTL must not
            # abort configuring the live ones
            client = MountAdminClient(node["url"])
            try:
                results[node["url"]] = client.configure(capacity)
            except Exception as e:
                results[node["url"]] = f"unreachable: {e.__class__.__name__}"
            finally:
                client.close()
        return {"mounts": results}
    if cmd == "mq.topic.list":
        # topics live under /topics/<ns>/<topic>/.conf in the filer
        # (reference command_mq_topic_list.go asks the broker; the broker
        # state IS the filer tree, so the shell reads it directly)
        from seaweedfs_tpu_torch.shell.fs_commands import FsContext
        fsc = FsContext(_find_filer(sh))
        topics = []
        try:
            namespaces = fsc.ls("/topics")
        except Exception:
            namespaces = []
        for nse in namespaces:
            ns = nse["FullPath"].rsplit("/", 1)[-1]
            for te in fsc.ls(nse["FullPath"]):
                if not te.get("IsDirectory"):
                    continue
                try:
                    conf = json.loads(fsc.cat(te["FullPath"] + "/.conf"))
                except FileNotFoundError:
                    continue
                topics.append({
                    "namespace": ns,
                    "topic": te["FullPath"].rsplit("/", 1)[-1],
                    "partition_count": conf.get("partition_count", 0)})
        return {"topics": topics}
    if cmd == "cluster.raft.ps":
        from seaweedfs_tpu_torch.utils.httpd import http_json
        return http_json("GET",
                         f"http://{sh.master_url}/cluster/raft/ps")
    if cmd in ("cluster.raft.add", "cluster.raft.remove"):
        import time as _time

        from seaweedfs_tpu_torch.utils.httpd import http_call
        op = cmd.rsplit(".", 1)[1]
        # follow not-leader hops (the 409 body carries the leader) and
        # ride out an election in progress — membership commands often
        # run exactly when leadership is churning
        url = sh.master_url
        deadline = _time.time() + 10
        while True:
            try:
                status, body, _ = http_call(
                    "POST", f"http://{url}/cluster/raft/{op}",
                    json_body={"peer": flags["peer"]}, timeout=5)
            except ConnectionError:
                status, body = 0, b""
            out = json.loads(body) if body else {}
            if status and status < 300:
                return out
            if status not in (0, 409, 503):
                # permanent (e.g. 400 cannot-remove-leader): no retry
                raise RuntimeError(
                    f"raft {op} failed: HTTP {status} {out}")
            if _time.time() > deadline:
                raise RuntimeError(
                    f"raft {op} failed: HTTP {status} {out}")
            if status == 409 and out.get("leader"):
                url = out["leader"]
            else:
                url = sh.master_url  # re-resolve from scratch
                _time.sleep(0.3)
    if cmd == "volume.tier.status":
        vid = flags.get("volumeId")
        return sh.volume_tier_status(int(vid) if vid else None)
    if cmd == "volume.tier.move" and flags.get("toRung"):
        # autopilot-rung transition (hot|ec|cloud) on every replica —
        # distinct from the disk-type move below
        return sh.volume_tier_rung_move(
            int(flags["volumeId"]), flags["toRung"],
            endpoint=flags.get("endpoint", ""),
            bucket=flags.get("bucket", "tier"))
    if cmd == "volume.tier.move":
        # move full+quiet volumes to a cold tier: a disk type
        # (-toDiskType ssd), a node (-toNode), or both (reference
        # command_volume_tier_move.go)
        return sh.volume_tier_move(
            to_node=flags.get("toNode", ""),
            to_disk=flags.get("toDiskType", ""),
            full_percent=float(flags.get("fullPercent", 95)),
            quiet_for=float(flags.get("quietFor", 0)),
            collection=flags.get("collection", ""),
            apply=apply)
    if cmd == "cluster.ps":
        return sh.cluster_ps()
    if cmd == "volume.tier.upload":
        return sh.volume_tier_upload(
            int(flags["volumeId"]), flags["endpoint"], flags["bucket"],
            keep_local="-keepLocal" in args)
    if cmd == "volume.tier.download":
        return sh.volume_tier_download(int(flags["volumeId"]))
    if cmd == "s3.configure":
        # manage S3 identities in /etc/iam/identity.json (reference
        # command_s3_configure.go; the gateway reads the same file)
        import json as _json

        from seaweedfs_tpu_torch.utils.httpd import http_call, http_json
        filer = _find_filer(sh)
        ident_url = f"http://{filer}/etc/iam/identity.json"
        status, body, _ = http_call("GET", ident_url)
        if status == 200 and body:
            conf = _json.loads(body)
        elif status == 404:
            conf = {"identities": []}
        else:
            # NEVER treat a transient error as "no identities" — the
            # save below would wipe every existing access key
            raise RuntimeError(f"cannot load identities: HTTP {status}")
        idents = conf["identities"]
        if "delete" in flags:
            idents[:] = [x for x in idents if x["name"] != flags["delete"]]
        elif "user" in flags:
            ident = next((x for x in idents
                          if x["name"] == flags["user"]), None)
            if ident is None:
                ident = {"name": flags["user"], "credentials": [],
                         "actions": []}
                idents.append(ident)
            if "access" in flags:
                ident["credentials"] = [{"accessKey": flags["access"],
                                         "secretKey":
                                         flags.get("secret", "")}]
            if "actions" in flags:
                ident["actions"] = flags["actions"].split(",")
        status, body, _ = http_call(
            "POST", ident_url, body=_json.dumps(conf, indent=2).encode())
        if status >= 300:
            raise RuntimeError(f"save failed: HTTP {status}")
        return {"identities": [x["name"] for x in idents]}
    if cmd == "s3.circuitbreaker":
        # concurrent-request limits, hot-reloaded by the gateway from
        # /etc/s3/circuit_breaker proto bytes (reference
        # command_s3_circuitbreaker.go edits the same config)
        from seaweedfs_tpu_torch.pb import s3_pb2
        from seaweedfs_tpu_torch.utils.httpd import http_call
        filer = _find_filer(sh)
        cb_url = f"http://{filer}/etc/s3/circuit_breaker"
        status, body, _ = http_call("GET", cb_url)
        if status == 200 and body:
            conf = s3_pb2.S3CircuitBreakerConfig.FromString(body)
        elif status == 404:
            conf = s3_pb2.S3CircuitBreakerConfig()
        else:
            raise RuntimeError(f"cannot load config: HTTP {status}")
        mutating = ("-disable" in args or "read" in flags
                    or "write" in flags)
        if "bucket" in flags and not mutating \
                and flags["bucket"] not in conf.buckets:
            # query-only: indexing the proto map would auto-vivify a
            # phantom "configured" bucket in the display
            opts = None
        else:
            opts = (conf.buckets[flags["bucket"]] if "bucket" in flags
                    else conf.global_options)
        changed = False
        if opts is not None:
            if "-disable" in args:
                opts.enabled = False
                changed = True
            for action in ("read", "write"):
                if action in flags:
                    opts.enabled = True
                    opts.actions[action.capitalize()] = int(flags[action])
                    changed = True
        if changed:
            status, body, _ = http_call(
                "POST", cb_url, body=conf.SerializeToString())
            if status >= 300:
                raise RuntimeError(f"save failed: HTTP {status}")
        def show(o):
            return {"enabled": o.enabled, "actions": dict(o.actions)}
        return {"global": show(conf.global_options),
                "buckets": {b: show(o) for b, o in conf.buckets.items()}}
    if cmd == "s3.clean.uploads":
        # purge stale multipart uploads (reference
        # command_s3_clean_uploads.go); default cutoff 24h
        import time as _time

        from seaweedfs_tpu_torch.shell.fs_commands import FsContext
        fsc = FsContext(_find_filer(sh))
        cutoff = _time.time() - float(flags.get("timeAgo", 86400))
        removed = []
        try:
            uploads = fsc.ls("/buckets/.uploads", limit=100000)
        except NotADirectoryError:
            uploads = []
        for e in uploads:
            if e.get("Mtime", 0) < cutoff:
                fsc.rm(e["FullPath"], recursive=True)
                removed.append(e["FullPath"])
        return {"removed": removed}
    if cmd.startswith("s3.bucket."):
        # reference shell command_s3_bucket_*.go: buckets are dirs under
        # /buckets with collection=<bucket>
        from seaweedfs_tpu_torch.shell.fs_commands import FsContext
        from seaweedfs_tpu_torch.utils.httpd import http_json
        fsc = FsContext(_find_filer(sh))
        op = cmd[len("s3.bucket."):]
        if op == "quota":
            # size quota on the bucket entry (reference
            # command_s3_bucket_quota.go; the gateway enforces it)
            path = f"/buckets/{flags['name']}"
            out = http_json("GET", f"http://{fsc.filer_url}/__api/entry"
                                   f"?path={path}")
            entry = out["entry"]
            if "-disable" in args:
                entry.setdefault("extended", {}).pop("quota_bytes", None)
                quota = 0
            else:
                quota = int(float(flags["sizeMB"]) * 1024 * 1024)
                entry.setdefault("extended", {})["quota_bytes"] = \
                    str(quota)
            http_json("POST", f"http://{fsc.filer_url}/__api/entry",
                      {"entry": entry, "meta_only": True})
            return {"bucket": flags["name"], "quota_bytes": quota}
        if op == "quota.check":
            # usage vs quota per bucket (reference
            # command_s3_bucket_quota_check.go; enforcement itself is
            # live in the gateway's write path, so this reports)
            from seaweedfs_tpu_torch.utils.httpd import HttpError as _HErr
            report = []
            try:
                buckets = fsc.ls("/buckets")
            except (NotADirectoryError, _HErr):
                buckets = []  # no bucket ever created: /buckets absent
            for be in buckets:
                name = be["FullPath"].rsplit("/", 1)[-1]
                if name.startswith(".") or not be.get("IsDirectory"):
                    continue
                out = http_json(
                    "GET", f"http://{fsc.filer_url}/__api/entry"
                           f"?path=/buckets/{name}")
                ext = out["entry"].get("extended") or {}
                q = ext.get("quota_bytes")
                if isinstance(q, dict):  # bytes-valued xattr encoding
                    q = bytes.fromhex(q["__bytes__"]).decode()
                quota = int(q) if q else 0
                _files, used = fsc.du(f"/buckets/{name}")
                report.append({"bucket": name, "quota_bytes": quota,
                               "used_bytes": used,
                               "over": bool(quota) and used > quota})
            return {"buckets": report}
        if op == "list":
            try:
                return [e["FullPath"].rsplit("/", 1)[-1]
                        for e in fsc.ls("/buckets")]
            except NotADirectoryError:
                return []
        if op == "create":
            fsc.mkdir(f"/buckets/{flags['name']}")
            return {"created": flags["name"]}
        if op == "delete":
            fsc.rm(f"/buckets/{flags['name']}", recursive=True)
            # drop the bucket's collection so volumes are reclaimed
            try:
                http_json("POST", f"http://{sh.master_url}/col/delete"
                                  f"?collection={flags['name']}")
            except Exception:
                pass
            return {"deleted": flags["name"]}
        raise ValueError(f"unknown s3.bucket command {op!r}")
    if cmd == "volume.fix.replication":
        return sh.volume_fix_replication(apply=apply)
    if cmd == "volume.balance":
        return sh.volume_balance(apply=apply)
    if cmd == "collection.list":
        from seaweedfs_tpu_torch.utils.httpd import http_json
        return http_json("GET", f"http://{sh.master_url}/col/list")
    if cmd == "collection.delete":
        from seaweedfs_tpu_torch.utils.httpd import http_json
        return http_json(
            "POST",
            f"http://{sh.master_url}/col/delete?collection={args[0]}")
    if cmd == "cluster.check":
        from seaweedfs_tpu_torch.utils.httpd import http_json
        return http_json("GET", f"http://{sh.master_url}/cluster/status")
    if cmd == "volume.vacuum":
        thr = float(args[0]) if args and not args[0].startswith("-") else 0.3
        return sh.volume_vacuum(thr)
    if cmd == "ec.encode":
        vid = int(flags["volumeId"]) if "volumeId" in flags else None
        return sh.ec_encode(vid=vid, collection=flags.get("collection", ""),
                            code=flags.get("code", ""))
    if cmd == "ec.scheme.status":
        vid = int(flags["volumeId"]) if "volumeId" in flags else None
        return sh.ec_scheme_status(vid=vid)
    if cmd == "ec.rebuild":
        return sh.ec_rebuild(apply=apply)
    if cmd == "ec.balance":
        return [vars(m) for m in sh.ec_balance(apply=apply)]
    if cmd == "ec.decode":
        return sh.ec_decode(int(flags["volumeId"]))
    if cmd == "ec.repair.status":
        return sh.ec_repair_status()
    if cmd == "cluster.health":
        return sh.cluster_health()
    if cmd == "cluster.leases":
        return sh.cluster_leases()
    if cmd == "cluster.shards":
        return sh.cluster_shards()
    if cmd == "cluster.qos":
        conf = {}
        for flag, key, cast in (("limit", "limit", int),
                                ("minLimit", "min_limit", int),
                                ("maxLimit", "max_limit", int),
                                ("tenantRate", "tenant_rate", float),
                                ("tenantBurst", "tenant_burst", float)):
            if flag in flags:
                conf[key] = cast(flags[flag])
        if "enable" in flags:
            conf["enabled"] = True
        if "disable" in flags:
            conf["enabled"] = False
        return sh.cluster_qos(configure=conf or None,
                              node=flags.get("node", ""))
    if cmd == "cluster.trace":
        return sh.cluster_trace(
            trace_id=flags.get("trace", ""),
            min_ms=float(flags.get("minMs", 0) or 0),
            limit=int(flags.get("limit", 64) or 64))
    if cmd == "cluster.telemetry":
        return sh.cluster_telemetry(
            top_k=int(flags.get("topK", 10) or 10),
            peers="noPeers" not in flags)
    if cmd == "cluster.profile":
        return sh.cluster_profile(
            seconds=float(flags.get("seconds", 5) or 5),
            top_k=int(flags.get("topK", 20) or 20))
    if cmd == "ec.repair.kick":
        return sh.ec_repair_kick()
    if cmd == "volume.scrub":
        vid = int(flags["volumeId"]) if "volumeId" in flags else None
        return sh.volume_scrub(node=flags.get("node", ""), volume_id=vid)
    raise ValueError(f"unknown command {cmd!r}; `help` lists commands")


def _parse_flags(args: list[str]) -> dict:
    out = {}
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-") and a != "-n":
            key = a.lstrip("-")
            if i + 1 < len(args) and not args[i + 1].startswith("-"):
                out[key] = args[i + 1]
                i += 1
            else:
                out[key] = "true"
        i += 1
    return out
