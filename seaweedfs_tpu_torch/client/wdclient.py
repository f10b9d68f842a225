"""Client-side master access: vid -> locations cache + lookup fallback.

Functional equivalent of reference weed/wdclient/masterclient.go. Two
modes, matching the reference's design:

- push mode (``grpc_address`` given): a background KeepConnected stream
  feeds a vidMap from VolumeLocation deltas — the reference's
  ``KeepConnectedToMaster`` loop (masterclient.go:148-240); lookups hit
  the map first and fall back to a LookupVolume call for unknown vids
  (``LookupFileIdWithFallback``).
- pull mode: TTL'd lookup cache over the HTTP plane.

The port's copy of seaweedfs_tpu/client/wdclient.py. It takes no device
and imports nothing of that package.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from seaweedfs_tpu_torch.utils import clockctl
from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json
from seaweedfs_tpu_torch.utils.resilience import (Deadline, RetryPolicy,
                                            current_deadline)


class MasterClient:
    def __init__(self, master_urls: list[str] | str, cache_ttl: float = 10.0,
                 grpc_address: Optional[str] = None,
                 client_type: str = "client", client_address: str = "",
                 assign_leases: bool = True):
        """assign_leases routes assigns through the direct-to-volume
        lease lane first (volume servers mint fids locally from
        master-granted fid-range leases; see /admin/lease_assign),
        falling back to the master's /dir/assign when no leased holder
        answers. Off = every assign is a master round trip, kept as
        the comparator (assign_leases=False)."""
        if isinstance(master_urls, str):
            master_urls = [master_urls]
        self.master_urls = master_urls
        self._leader = master_urls[0]
        # full-jitter backoff + per-master retry budget: after a master
        # restart, a fleet of clients must NOT reconnect in lockstep
        self.retry = RetryPolicy(attempts=3, base=0.2, cap=2.0)
        self.cache_ttl = cache_ttl
        self._cache: dict[int, tuple[float, list[dict]]] = {}
        self._ec_cache: dict[int, tuple[float, list[dict]]] = {}
        # singleflight guards for cache refreshes: key -> Event held by
        # the one caller doing the master round trip; concurrent
        # readers of an EXPIRED entry serve the stale value while the
        # refresh flies, readers of a cold miss wait on the Event
        self._sf: dict = {}
        # every master round trip counts here — the master-free warm
        # path is asserted by watching this stay flat
        self.master_calls = 0
        # filer shard ring (filer/shard_ring.py), pulled once from
        # /cluster/filers and refreshed on X-Weed-Shard epoch mismatch
        self._filer_ring = None
        # (collection, replication, ttl, disk) -> (expires, [fid dicts])
        self._assign_pools: dict[tuple, tuple[float, list[dict]]] = {}
        self._assign_jwt_mode = False  # JWT replies disable pooling
        # assign-lease lane: cached /cluster/leases directory
        # (fetched_at_monotonic, [lease dicts]) + outcome counters.
        # Followers serve the directory too, so it refreshes even
        # while the leader is dark.
        self.assign_leases = assign_leases
        self._lease_dir: tuple[float, dict] = (0.0, {})
        self.lease_assigns = 0
        self.lease_fallbacks = 0
        self._peer_health = None  # lazy; see peer_health
        # cache-aware routing: (vid, key) -> [replica url, use count]
        # for needles some replica advertised as cache-hot (bounded LRU)
        self._affinity: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        # push-mode state
        self._vidmap: dict[int, list[dict]] = {}
        self._vidmap_ready = threading.Event()
        self._stop = threading.Event()
        self._kc_thread: Optional[threading.Thread] = None
        self._kc_stream = None
        if grpc_address:
            addrs = ([grpc_address] if isinstance(grpc_address, str)
                     else list(grpc_address))
            self._kc_thread = threading.Thread(
                target=self._keep_connected_loop,
                args=(addrs, client_type, client_address), daemon=True,
                name="grpc-keepalive")
            self._kc_thread.start()

    # ---- KeepConnected push stream ----
    def _keep_connected_loop(self, addresses: list[str], client_type: str,
                             client_address: str) -> None:
        from seaweedfs_tpu_torch.server.master_grpc import GrpcMasterClient
        failures = 0
        idx = 0
        while not self._stop.is_set():
            address = addresses[idx % len(addresses)]
            client = GrpcMasterClient(address)
            got_data = False
            try:
                stream = client.keep_connected(client_type, client_address)
                self._kc_stream = stream
                for resp in stream:
                    if self._stop.is_set():
                        stream.cancel()
                        break
                    if resp.HasField("volume_location"):
                        vl = resp.volume_location
                        if not vl.url and vl.leader:
                            # follower redirect: note the hint and rotate
                            with self._lock:
                                self._leader = vl.leader
                                if vl.leader not in self.master_urls:
                                    self.master_urls.append(vl.leader)
                            continue
                        if not got_data:
                            # working stream established: the incoming
                            # snapshot supersedes the old map — deletions
                            # missed while disconnected must not linger.
                            # (Cleared only now, so a dead master doesn't
                            # wipe a still-useful map.)
                            with self._lock:
                                self._vidmap.clear()
                        got_data = True
                        failures = 0
                        self._apply_volume_location(vl)
            except Exception:
                pass
            finally:
                self._kc_stream = None
                client.close()
            if not self._stop.is_set():
                self._vidmap_ready.clear()
                if not got_data:
                    # dead or follower master: try the next address
                    idx += 1
                    failures += 1
                # FULL-JITTER backoff, uniform(0, min(cap, base*2^n)):
                # the old fixed 0.2*2^n doubling resynchronized every
                # disconnected client onto the same retry instants
                # after a master restart (thundering herd)
                clockctl.sleep(self.retry.backoff(failures))

    def _apply_volume_location(self, vl) -> None:
        loc = {"url": vl.url, "publicUrl": vl.public_url or vl.url}
        with self._lock:
            for vid in list(vl.new_vids) + list(vl.new_ec_vids):
                locs = self._vidmap.setdefault(vid, [])
                if not any(l["url"] == loc["url"] for l in locs):
                    locs.append(dict(loc))
            for vid in list(vl.deleted_vids) + list(vl.deleted_ec_vids):
                locs = self._vidmap.get(vid)
                if locs is not None:
                    locs[:] = [l for l in locs if l["url"] != loc["url"]]
                    if not locs:
                        del self._vidmap[vid]
            if vl.leader:
                hint = vl.leader
                if hint and hint not in self.master_urls:
                    self.master_urls.append(hint)
        self._vidmap_ready.set()

    def stop(self) -> None:
        self._stop.set()
        stream = self._kc_stream
        if stream is not None:
            try:
                stream.cancel()
            except Exception:
                pass
        if self._kc_thread is not None:
            self._kc_thread.join(timeout=2)

    @property
    def leader(self) -> str:
        return self._leader

    def _resolve_leader(self) -> Optional[str]:
        """Probe every known master's /cluster/status and adopt the
        leader it reports. Used after a 503 without a usable hint: the
        node we asked is alive but mid-election or not-yet-ready, and
        some peer usually already knows who won."""
        for url in list(self.master_urls):
            try:
                st = http_json("GET", f"http://{url}/cluster/status",
                               deadline=Deadline.after(1.0))
            except (ConnectionError, HttpError):
                continue
            leader = st.get("Leader") or st.get("leader")
            if leader:
                with self._lock:
                    self._leader = leader
                    if leader not in self.master_urls:
                        self.master_urls.append(leader)
                return leader
        return None

    def _call(self, method: str, path: str, body=None, rounds: int = 3):
        """Try the believed leader, then every master, following 409
        leader hints; several rounds with backoff ride out an election
        in progress (reference wdclient retries until a leader answers,
        masterclient.go:135-146). A 503 (not-ready fresh leader, or a
        shedding master) re-resolves the leader from the peer list and
        keeps retrying; an ambient deadline (resilience.current_deadline)
        bounds the whole dance instead of the fixed round count."""
        with self._lock:
            self.master_calls += 1
        dl = current_deadline()
        last_err: Exception = RuntimeError("no masters")
        for attempt in range(rounds):
            candidates = [self._leader] + [u for u in self.master_urls
                                           if u != self._leader]
            for url in candidates:
                if dl is not None and dl.expired():
                    raise last_err
                try:
                    self.retry.record_call(url)
                    out = http_json(method, f"http://{url}{path}", body,
                                    deadline=dl)
                    self._leader = url
                    return out
                except HttpError as e:
                    # follower redirect {"error": "not leader",
                    # "leader": u} or a 503 carrying the same hint
                    if e.status in (409, 503):
                        import json as _json
                        try:
                            hint = _json.loads(e.body).get("leader")
                        except Exception:
                            hint = None
                        if e.status == 503 and (not hint or hint == url):
                            hint = self._resolve_leader()
                        if hint and hint not in candidates:
                            candidates.append(hint)
                        if hint:
                            self._leader = hint
                    elif e.status < 500:
                        # a definitive client-error answer (404 unknown
                        # volume, 400 bad request) — retrying other
                        # masters/rounds would just repeat it slowly
                        raise
                    last_err = e
                except ConnectionError as e:
                    last_err = e
            if attempt + 1 < rounds:
                # retry budget: a cluster-wide master outage drains the
                # per-destination tokens and stops the retry storm early
                if not self.retry.allow_retry(self._leader):
                    break
                pause = self.retry.backoff(attempt)
                if dl is not None:
                    if dl.remaining() <= 0:
                        break
                    pause = min(pause, dl.remaining())
                clockctl.sleep(pause)
        raise last_err

    @property
    def peer_health(self):
        """Learned per-volume-server breakers/latency, shared across
        this client's reads (ranks replica holders, feeds hedging).
        Lazy: most client uses (assign/upload) never dial replicas."""
        if self._peer_health is None:
            from seaweedfs_tpu_torch.utils.resilience import PeerHealth
            with self._lock:
                if self._peer_health is None:
                    self._peer_health = PeerHealth()
        return self._peer_health

    def _lookup_singleflight(self, cache: dict, vid: int, kind: str,
                             fetch) -> list[dict]:
        """TTL'd cache read with SINGLEFLIGHT refresh: one master
        round trip per expiry, not one per concurrent reader.
        Readers that find an EXPIRED entry serve the stale locations
        while the one refresher flies (locations drift slowly, and a
        wrong read self-corrects through invalidate()); readers of a
        cold miss wait for the refresher and make their own call only
        if it failed."""
        with self._lock:
            hit = cache.get(vid)
            if hit and clockctl.now() - hit[0] < self.cache_ttl:
                return hit[1]
            sf_key = (kind, vid)
            ev = self._sf.get(sf_key)
            refresher = ev is None
            if refresher:
                ev = self._sf[sf_key] = threading.Event()
        if not refresher:
            if hit is not None:
                return hit[1]  # stale-while-revalidate
            ev.wait(15.0)
            with self._lock:
                hit = cache.get(vid)
            if hit is not None:
                return hit[1]
        try:
            locs = fetch()
            with self._lock:
                cache[vid] = (clockctl.now(), locs)
            return locs
        finally:
            if refresher:
                with self._lock:
                    self._sf.pop(sf_key, None)
                ev.set()

    def lookup_volume(self, vid: int, collection: str = "") -> list[dict]:
        with self._lock:
            # push-fed vidMap first (LookupFileIdWithFallback)
            locs = self._vidmap.get(vid)
            if locs:
                return list(locs)
        return self._lookup_singleflight(
            self._cache, vid, "vol",
            lambda: self._call(
                "GET",
                f"/dir/lookup?volumeId={vid}&collection={collection}"
            ).get("locations", []))

    def lookup_file_id(self, fid: str) -> list[str]:
        vid = int(fid.split(",")[0])
        return [f"http://{l['url']}/{fid}" for l in self.lookup_volume(vid)]

    def lookup_ec_volume(self, vid: int) -> list[dict]:
        return self._lookup_singleflight(
            self._ec_cache, vid, "ec",
            lambda: self._call(
                "GET", f"/dir/lookup_ec?volumeId={vid}"
            ).get("shards", []))

    def invalidate(self, vid: int) -> None:
        with self._lock:
            self._cache.pop(vid, None)
            self._ec_cache.pop(vid, None)

    # ---- filer shard ring (master-free namespace warm path) ----
    def filer_ring(self, refresh: bool = False):
        """The filer shard ring, pulled from the master's
        /cluster/filers once and cached forever — refreshed only on
        explicit request (an X-Weed-Shard epoch mismatch). Warm
        namespace ops therefore cost ZERO master round trips."""
        with self._lock:
            ring = self._filer_ring
        if ring is not None and not refresh:
            return ring
        from seaweedfs_tpu_torch.filer.shard_ring import ShardRing
        out = self._call("GET", "/cluster/filers")
        ring = ShardRing.from_dict(out)
        with self._lock:
            # epochs only move forward: a concurrent refresh may have
            # already installed a newer ring
            if (self._filer_ring is None
                    or ring.epoch >= self._filer_ring.epoch):
                self._filer_ring = ring
            return self._filer_ring

    def note_shard_epoch(self, epoch: int) -> None:
        """A response carried X-Weed-Shard with this ring epoch; if
        it is ahead of ours, our ring has drifted — re-pull."""
        ring = self._filer_ring
        if ring is None or epoch > ring.epoch:
            try:
                self.filer_ring(refresh=True)
            except Exception:
                pass  # keep routing on the stale ring; redirects still work

    def filer_url_for(self, path: str) -> str:
        """The filer shard owning `path` ("" when none registered)."""
        ring = self.filer_ring()
        return ring.owner_for_path(path) if len(ring) else ""

    def filer_call(self, method: str, path: str, body=None,
                   json_body=None, query: str = "", headers=None,
                   deadline=None, follow_redirects: bool = True
                   ) -> tuple[int, bytes, dict]:
        """One namespace op routed DIRECTLY to the owning shard — the
        master-free warm path. A 307 shard redirect (stale ring) is
        followed once, after refreshing the ring from the epoch in the
        X-Weed-Shard header. A 302 volume-direct redirect (the filer's
        zero-copy read plane pointing a GET at a volume replica's
        JWT-stamped URL) is honored transparently inside http_call;
        follow_redirects=False surfaces the raw 302 instead."""
        from urllib.parse import quote

        from seaweedfs_tpu_torch.filer.shard_ring import parse_shard_header
        from seaweedfs_tpu_torch.utils import headers as weed_headers
        from seaweedfs_tpu_torch.utils.httpd import http_call
        target = self.filer_url_for(path)
        if not target:
            raise ConnectionError("no filer shards registered")
        qs = f"?{query}" if query else ""
        status, out, hdrs = http_call(
            method, f"http://{target}{quote(path)}{qs}", body=body,
            json_body=json_body, headers=headers, deadline=deadline,
            follow_redirects=follow_redirects)
        if status == 307:
            epoch, owner = parse_shard_header(
                hdrs.get(weed_headers.SHARD, ""))
            if epoch:
                self.note_shard_epoch(epoch)
            retry_at = owner or self.filer_url_for(path)
            if retry_at and retry_at != target:
                status, out, hdrs = http_call(
                    method, f"http://{retry_at}{quote(path)}{qs}",
                    body=body, json_body=json_body, headers=headers,
                    deadline=deadline,
                    follow_redirects=follow_redirects)
        return status, out, hdrs

    # ---- cache-aware read routing ----
    # A replica that served a read out of its hot-needle record cache
    # says so via the X-Weed-Cache-Hot response header; read_data notes
    # it here and prefers that replica on the next read of the same
    # needle, so repeat reads of a hot needle stop spraying across
    # replicas (each miss on a cold sibling pays a disk read AND warms
    # a duplicate cache entry). Fairness guard: every Nth affinity hit
    # deliberately falls back to normal health ranking so the sibling
    # caches still see a trickle of the hot key and a single replica
    # can't become the sole owner of the working set.

    AFFINITY_CAP = 4096     # bounded: ~100 bytes/entry worst case
    AFFINITY_FAIRNESS = 8   # every Nth hit re-ranks instead

    def affinity_get(self, vid: int, key: int) -> Optional[str]:
        """Preferred replica url for this needle, or None (unknown, or
        this hit is the fairness guard's turn to re-rank)."""
        with self._lock:
            ent = self._affinity.get((vid, key))
            if ent is None:
                return None
            self._affinity.move_to_end((vid, key))
            ent[1] += 1
            if ent[1] % self.AFFINITY_FAIRNESS == 0:
                return None
            return ent[0]

    def affinity_note(self, vid: int, key: int, url: str) -> None:
        """Record that `url` served (vid, key) cache-hot."""
        with self._lock:
            ent = self._affinity.get((vid, key))
            if ent is not None:
                if ent[0] != url:
                    ent[0] = url
                    ent[1] = 0
                self._affinity.move_to_end((vid, key))
                return
            self._affinity[(vid, key)] = [url, 0]
            while len(self._affinity) > self.AFFINITY_CAP:
                self._affinity.popitem(last=False)

    def affinity_drop(self, vid: int, key: int) -> None:
        with self._lock:
            self._affinity.pop((vid, key), None)

    # assign-lease lane: how long a pulled /cluster/leases directory
    # serves before re-pull. Holders renew every heartbeat (2s pulse,
    # 30s TTL), so a directory this stale still names live leases.
    LEASE_DIR_TTL = 15.0

    def _lease_directory(self, refresh: bool = False) -> dict:
        """The master's /cluster/leases reply, TTL-cached. Any master
        answers (followers serve the replicated table), so the
        directory keeps refreshing while the leader is dark. Never
        raises: on total master darkness the stale directory keeps
        serving — its holders' own expiry checks are the real gate."""
        now = clockctl.monotonic()
        with self._lock:
            ts, cached = self._lease_dir
            # an empty table re-polls at heartbeat cadence: right after
            # growth the first grants land within one pulse, and a
            # 15s-stale "no leases" copy would pin every assign to the
            # master for that long
            ttl = self.LEASE_DIR_TTL if cached.get("leases") else 2.0
            if cached and not refresh and now - ts < ttl:
                return cached
            self.master_calls += 1
        for url in [self._leader] + [u for u in self.master_urls
                                     if u != self._leader]:
            try:
                out = http_json("GET", f"http://{url}/cluster/leases",
                                deadline=Deadline.after(2.0))
            except (ConnectionError, HttpError):
                continue
            with self._lock:
                self._lease_dir = (now, out)
            return out
        with self._lock:
            # re-arm the TTL on the stale copy so a dark cluster isn't
            # re-probed on every single assign
            self._lease_dir = (now, cached)
        return cached

    def assign_from_lease(self, count: int = 1, collection: str = "",
                          replication: str = "") -> Optional[dict]:
        """One assign minted DIRECTLY by a leased volume server —
        zero master involvement on the warm path. Holders are tried
        health-ranked and breaker-gated; a 503 refusal (lease lapsed
        or exhausted) moves to the next holder. None = no leased
        holder could mint; the caller falls back to /dir/assign."""
        if not self.assign_leases:
            return None
        directory = self._lease_directory()
        want_rp = (replication or directory.get("default_replication")
                   or "000").zfill(3)
        now = clockctl.now()
        holders: list[str] = []
        for l in directory.get("leases", []):
            if l.get("collection", "") != collection:
                continue
            if (l.get("replication") or "000") != want_rp:
                continue
            if l.get("expires_at", 0) <= now:
                continue
            h = l.get("holder")
            if h and h not in holders:
                holders.append(h)
        ranked = self.peer_health.rank(holders)
        for url in ranked:
            if not self.peer_health.allow(url) and url != ranked[-1]:
                continue
            t0 = clockctl.monotonic()
            try:
                out = http_json(
                    "POST",
                    f"http://{url}/admin/lease_assign?count={count}"
                    f"&collection={collection}",
                    deadline=Deadline.after(2.0))
            except HttpError:
                # a refusal is still a healthy transport answer
                self.peer_health.record(url, True,
                                        clockctl.monotonic() - t0)
                continue
            except ConnectionError:
                self.peer_health.record(url, False)
                continue
            self.peer_health.record(url, True, clockctl.monotonic() - t0)
            with self._lock:
                self.lease_assigns += 1
            return out
        return None

    def assign(self, count: int = 1, collection: str = "",
               replication: str = "", ttl: str = "",
               data_center: str = "", disk: str = "") -> dict:
        # direct-to-volume lane first: leases carry the leased volume's
        # own placement, so only constraint-free assigns (no ttl/disk/
        # dc pin) are eligible; anything else goes straight to the
        # master, as does any assign the lane couldn't serve
        if self.assign_leases and not ttl and not disk \
                and not data_center:
            out = self.assign_from_lease(count=count,
                                         collection=collection,
                                         replication=replication)
            if out is not None:
                return out
            with self._lock:
                self.lease_fallbacks += 1
        qs = (f"count={count}&collection={collection}"
              f"&replication={replication}&ttl={ttl}&dataCenter={data_center}"
              f"&disk={disk}")
        return self._call("POST", f"/dir/assign?{qs}")

    ASSIGN_BATCH = 16
    ASSIGN_POOL_TTL = 10.0

    def assign_batched(self, collection: str = "", replication: str = "",
                       ttl: str = "", disk: str = "") -> dict:
        """One fid from a client-side pool: a single master round trip
        mints ASSIGN_BATCH sequential keys (the documented count=N
        semantics, reference operation/assign_file_id.go), so the hot
        write path pays ~1/16th of an assign instead of a full master
        round trip per file. Pools are per parameter tuple and expire
        quickly so growth/readonly transitions are picked up. JWT
        clusters fall back to per-file assigns (the token covers only
        the base fid)."""
        from seaweedfs_tpu_torch.storage.file_id import (
            format_needle_id_cookie, parse_needle_id_cookie)
        key = (collection, replication, ttl, disk)
        now = clockctl.monotonic()
        with self._lock:
            pool = self._assign_pools.get(key)
            if pool and pool[0] > now and pool[1]:
                return pool[1].pop()
            batch = 1 if self._assign_jwt_mode else self.ASSIGN_BATCH
        a = self.assign(count=batch, collection=collection,
                        replication=replication, ttl=ttl, disk=disk)
        if a.get("error"):
            return a
        if a.get("auth"):
            # JWT cluster: the token covers only the base fid, so
            # batched key derivation can't be authorized — remember and
            # stop burning 15 unused sequence ids per upload
            self._assign_jwt_mode = True
            return a
        vid, rest = a["fid"].split(",", 1)
        nkey, cookie = parse_needle_id_cookie(rest)
        fids = [dict(a, fid=f"{vid},"
                     f"{format_needle_id_cookie(nkey + i, cookie)}")
                for i in range(a.get("count", 1))]
        first = fids.pop(0)
        with self._lock:
            self._assign_pools[key] = (now + self.ASSIGN_POOL_TTL, fids)
        return first

    # One multi-chunk upload maps to one volume at most this many
    # sequential keys per master round trip; wider uploads assign in
    # waves so a huge PUT doesn't pin hundreds of ids to one volume.
    ASSIGN_MANY_MAX = 64

    def assign_many(self, n: int, collection: str = "",
                    replication: str = "", ttl: str = "",
                    disk: str = "") -> list[dict]:
        """Exactly `n` assign results in as few master round trips as
        possible (count=N key derivation, same contract as
        assign_batched but returning the whole batch — the filer's
        parallel chunk uploader needs all fids up front). Each element
        is a normal assign dict; an element with "error" set means the
        remainder was not assigned. JWT clusters fall back to per-fid
        assigns (a minted token covers only the base fid)."""
        from seaweedfs_tpu_torch.storage.file_id import (
            format_needle_id_cookie, parse_needle_id_cookie)
        out: list[dict] = []
        while len(out) < n:
            want = min(n - len(out), self.ASSIGN_MANY_MAX)
            if self._assign_jwt_mode:
                want = 1
            a = self.assign(count=want, collection=collection,
                            replication=replication, ttl=ttl, disk=disk)
            if a.get("error"):
                out.append(a)
                return out
            if a.get("auth"):
                self._assign_jwt_mode = True
                out.append(a)
                continue
            vid, rest = a["fid"].split(",", 1)
            nkey, cookie = parse_needle_id_cookie(rest)
            got = max(1, min(int(a.get("count", 1)), want))
            out.extend(dict(a, fid=f"{vid},"
                            f"{format_needle_id_cookie(nkey + i, cookie)}")
                       for i in range(got))
        return out[:n]

    def cluster_status(self) -> dict:
        return self._call("GET", "/cluster/status")

    def topology(self) -> dict:
        return self._call("GET", "/dir/status")
