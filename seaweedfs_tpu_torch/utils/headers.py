"""The X-Weed-* header namespace — every cross-node protocol header,
in one place (the port's copy of seaweedfs_tpu/utils/headers.py: the
same names, so the two packages speak one wire protocol).

These names ARE the wire protocol for the cluster's ambient request
scope (deadline budget, QoS class, trace context) and its side-channel
metadata (replica mtimes, sync signatures, partial-repair state).  A
typo in an inline literal fails open — the header silently doesn't
match and the contract quietly stops propagating at that hop — so code
imports the constant instead of spelling ``"X-Weed-*"`` inline.

Adding a header: define it here with a comment naming its
producer/consumer pair, then use it via this module.
"""

from __future__ import annotations

# ---- ambient request scope (injected by http_call, re-entered by
#      HttpServer._dispatch on the far side) ----

# remaining deadline budget, decimal seconds (utils/resilience.py)
DEADLINE = "X-Weed-Deadline"
# traffic class: interactive | write | background (qos/classes.py)
CLASS = "X-Weed-Class"
# trace context: <trace_id>:<span_id>:<flags> (utils/tracing.py)
TRACE = "X-Weed-Trace"

# ---- replication & sync ----

# replica-copy source mtime: a copy must not restart a TTL volume's
# expiry clock (volume server /admin/copy)
FILE_MTIME = "X-Weed-File-Mtime"
# replicator signature so the reverse sync direction can exclude its
# own writes from the event stream (replication/sink.py <-> filer)
SYNC_SIGNATURE = "X-Weed-Sync-Signature"

# ---- control plane ----

# loop guard on follower->leader proxying during elections (master)
PROXIED = "X-Weed-Proxied"
# filer namespace sharding: "<ring_epoch>:<owner_url>" on 307
# redirects / forwarded responses for mis-routed namespace ops
# (server/filer_server.py); clients compare the epoch against their
# cached ring and re-pull /cluster/filers on drift
# (client/wdclient.py, filer/shard_ring.py owns the format)
SHARD = "X-Weed-Shard"
# loop guard on shard-to-shard forwarding of mis-routed mutations: a
# forwarded op that still looks mis-routed (ring disagreement between
# shards mid-epoch-change) is served locally instead of bouncing
SHARD_FORWARDED = "X-Weed-Shard-Forwarded"

# ---- cache-aware read routing ----

# set "1" on a volume read served while the needle sits in that
# replica's hot-needle record cache (server/volume_server.py); clients
# (client/operation.read_data) note the advertising replica and prefer
# it on subsequent reads of the same needle, with a fairness guard so
# affinity can't starve the other replicas of cache warmth
CACHE_HOT = "X-Weed-Cache-Hot"

# set "1" on a volume GET whose payload was served by the zero-copy
# descriptor path (sendfile off the .dat fd, server/volume_server.py);
# tests and the read-plane bench use it to prove which path ran, and
# operators can spot a fleet that silently fell back to buffered serving
ZERO_COPY = "X-Weed-Zero-Copy"

# ---- partial-parallel EC repair (storage/erasure_coding/partial.py) ----

# shard ids folded into a chain hop's pre-reduced column
PARTIAL_SHARDS = "X-Weed-Partial-Shards"
# set when a hop fell back to raw-streaming its members locally
PARTIAL_FALLBACK = "X-Weed-Partial-Fallback"
