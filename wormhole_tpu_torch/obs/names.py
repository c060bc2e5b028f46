"""Registry of every metric, span, and event name the port emits.

The port's copy of the JAX package's obs/names.py, with its convention:
names follow the dotted-namespace form ``<subsystem>.<thing>[_<unit>]``
(lowercase, segments separated by dots, underscores within a segment);
dynamic names built with f-strings are declared with a ``*`` wildcard
per interpolated field, e.g. ``ps.server.op.*_s`` covers
``f"ps.server.op.{op}_s"``.

The JAX package's lint (``tools/wormlint`` metric-names) reads these
dict literals statically and holds them against every
``REGISTRY.counter/gauge/histogram("...")``, ``trace.span("...")`` and
``trace.event("...")`` call site of the port
(tests/test_torch_obs_names.py): every emitted name must be registered
and every registered name emitted. So the registry is the JAX one less
what the port does not emit, and plus what only the port emits:

- left out: the hot plane's ``ps.hot.*`` (ROADMAP.md item 5.5), the
  kvstore jit timers ``kv.*`` (the port's stores are torch tensors, no
  jit cache), the runtime sanitizer's ``san.*`` (not ported) and the
  ``solver.*_pass`` span (the port's solver does not trace its passes);
- the port's own: ``kvstore.d2h_copies`` / ``kvstore.h2d_copies`` (row
  copies between the card and the host, the PS worker's ``[ps-wire]``
  line) and ``serve.score.h2d_s`` (the fetch scorer's copies to the
  card).
"""

from __future__ import annotations

# fmt: off
COUNTERS: dict[str, str] = {
    "ps.server.num_push": "pushes applied by a PS shard",
    "ps.server.num_pull": "pulls served by a PS shard",
    "ps.server.dedup_hits": "replayed pushes dropped by seq dedup",
    "ps.server.snapshots": "shard snapshots written",
    "ps.server.restores": "shard restores performed",
    "ps.client.bytes_push": "payload bytes pushed to servers",
    "ps.client.bytes_pull": "payload bytes pulled from servers",
    "ps.client.retries": "client RPC retries after socket errors",
    "ps.client.replays": "journal replays sent after reconnect",
    "ps.client.replay_dedup": "replays the server acked as duplicates",
    "ps.client.rollback_repulls": "full re-pulls forced by epoch rollback",
    "ps.client.syncs": "SyncedStore sync() rounds",
    "ps.keycache.hits": "key-list digests accepted by the server",
    "ps.keycache.misses": "digest misses forcing a full key resend",
    "ps.keycache.invalidations": "key caches dropped on restore/reconnect",
    "sched.liveness_evictions": "nodes evicted by the liveness loop",
    "sched.server_recoveries": "server re-registrations after death",
    "sched.recoveries": "scheduler restarts resumed from the journal",
    "sched.rpc.dedup_hits": "retried scheduler RPCs answered from the reply cache",
    "sched.journal.appends": "records appended to the scheduler journal",
    "sched.journal.bytes": "bytes fsync'd into the scheduler journal",
    "sched.journal.replays": "journal records replayed at scheduler start",
    "sched.journal.compactions": "journal compactions into a state snapshot",
    "bsp.rounds": "BSP collective rounds completed (allreduce+broadcast)",
    "bsp.recoveries": "BSP worker re-registrations after death",
    "bsp.ring_retries": "ring rounds aborted and replayed on a gen bump",
    "bsp.result_fetches": "cached reduced results served to peers",
    "bsp.checkpoints": "BSP version checkpoints written",
    "bsp.checkpoint_bytes": "bytes written by BSP checkpoints",
    "serve.requests": "predict/fetch RPCs served by a serving shard",
    "serve.rows": "weight rows gathered for predict batches",
    "serve.swaps": "hot snapshot swaps performed by a serving shard",
    "serve.dedup_hits": "retried fetches answered from the reply cache",
    "serve.router.requests": "predict batches scored through the router",
    "serve.batch.rounds": "micro-batch fan-out rounds executed in score mode",
    "serve.batch.coalesced": "predict requests that shared another request's round",
    "serve.batch.flush_full": "micro-batch rounds flushed at WH_SERVE_BATCH_MAX",
    "serve.batch.flush_timeout": "micro-batch rounds flushed by the linger budget",
    "serve.router.retries": "router shard-RPC retries after socket errors",
    "serve.router.epoch_retries": "fan-outs replayed for epoch consistency",
    "serve.router.failures": "predict batches the router gave up on",
    "sched.serve_recoveries": "serving shards that re-registered after death",
    "net.busy.rejections": "frames bounced by the max-in-flight gate",
    "net.busy.retries": "client resends after a busy reply",
    "net.deadline.shed": "frames shed because their deadline expired in transit",
    "admit.sheds": "bulk requests bounced by the admission controller",
    "serve.shed.deadline": "serving requests shed for an expired deadline",
    "serve.shed.busy": "serving requests bounced busy by the admission gate",
    "serve.hedge.issued": "backup fan-out RPCs issued to slow shards",
    "serve.hedge.wins": "fan-out legs where the hedge answered first",
    "serve.hedge.suppressed": "hedge firings denied by the hedge budget",
    "serve.degraded.replies": "predict replies served in degraded mode",
    "serve.degraded.enters": "transitions into degraded-mode serving",
    "serve.degraded.exits": "recoveries out of degraded-mode serving",
    "net.frames_sent": "frames written to sockets",
    "net.frames_recv": "frames read from sockets",
    "net.bytes_sent": "bytes written to sockets",
    "net.bytes_recv": "bytes read from sockets",
    "net.connect_retries": "connect() attempts that needed a retry",
    "net.compress.bytes_in": "compressed payload bytes received",
    "net.compress.bytes_out": "compressed payload bytes sent",
    "net.bshuf.bytes_in": "byte-shuffle-compressed payload bytes received",
    "net.bshuf.bytes_out": "byte-shuffle-compressed payload bytes sent",
    "wire.codec.bytes_raw": "f32-equivalent bytes of quantized float payloads",
    "wire.codec.bytes_wire": "actual wire bytes of quantized float payloads",
    "kvstore.d2h_copies": "row gathers copied from the device to the host (port only)",
    "kvstore.h2d_copies": "row scatters copied from the host to the device (port only)",
    "pack_cache.hits": "memory-tier pack cache hits",
    "pack_cache.misses": "pack cache misses (batch re-packed)",
    "pack_cache.disk_hits": "disk-tier pack cache hits",
    "pack_cache.evictions": "LRU evictions from the memory tier",
    "pack_cache.corrupt": "disk entries dropped after checksum failure",
    "obs.scrape.requests": "Prometheus /metrics scrapes served",
    "retry.attempts": "retried attempts under a deadline-budgeted policy",
    "retry.give_ups": "retry budgets exhausted (the op failed for good)",
    "retry.successes": "ops that succeeded after at least one retry",
    "sched.membership_epochs": "membership epoch bumps (join/leave/eviction)",
    "sched.joins": "workers admitted into a running job",
    "sched.leaves": "workers that left a running job cleanly",
    "elastic.spawns": "worker processes spawned by the elastic supervisor",
    "elastic.retires": "worker processes retired by the elastic supervisor",
    "ps.client.rehellos": "PSClient re-hello rounds after a membership bump",
    "flight.records": "records accepted into the flight-recorder rings",
    "flight.dumps": "flight-recorder dump files written",
    "flight.dump_errors": "flight dumps that failed to write",
    "flight.suppressed": "flight dumps suppressed by the rate limit",
    "prof.samples": "stack sweeps taken by the sampling profiler",
    "prof.throttled": "profiler sweeps skipped to stay under budget",
}

GAUGES: dict[str, str] = {
    "ps.server.restore_epoch": "epoch a shard last restored from",
    "serve.model_epoch": "active snapshot version on a serving shard",
    "ps.sync.inflight": "async sync rounds currently in flight (0/1)",
    "ps.sync.overlap_frac": "fraction of sync wall time hidden by compute",
    "queue.depth": "loader output queue depth",
    "loader.stall_s": "main-thread queue-wait total for the pass",
    "loader.pool_size": "current loader thread-pool size",
    "pack_cache.bytes": "bytes held by the pack cache memory tier",
    "obs.ring.depth": "snapshots held by the scheduler's telemetry ring",
    "sched.incarnation": "scheduler incarnation number (0 = never restarted)",
    "slo.*_burn": "error-budget burn rate per declared SLO (>1 = violated)",
    "admit.limit": "current AIMD concurrency limit of the admission gate",
    "admit.inflight": "bulk requests currently admitted into handlers",
    "serve.hedge.delay_ms": "rolling-quantile hedge delay currently in force",
    "serve.degraded.active": "1 while the router serves degraded replies",
    "prof.overhead_frac": "measured profiler overhead as a fraction of wall",
    "wire.codec.ef_resid_norm": "L2 norm of the error-feedback residual store",
}

HISTOGRAMS: dict[str, str] = {
    "ps.server.snapshot_s": "shard snapshot write duration",
    "serve.op.*_s": "per-op serving-shard handler duration",
    "serve.latency_s": "router-side end-to-end predict batch latency",
    "serve.stage.pack_s": "router pack stage (RowBlock -> device batch + keys)",
    "serve.stage.fanout_s": "fan-out wall: RPCs issued to all replies in",
    "serve.stage.wire_s": "fan-out wall minus slowest shard's own time",
    "serve.stage.queue_s": "slowest shard's recv-to-dispatch queue wait",
    "serve.stage.score_s": "jitted margin compute over compact tables",
    "serve.stage.sum_s": "shard-piece reassembly into compact tables",
    "serve.stage.batch_wait_s": "queue wait from coalescer admit to round start",
    "serve.stage.partial_s": "slowest shard's own score-kernel time in a round",
    "serve.score.h2d_s": "fetch scorer's host-to-device copies per batch (port only)",
    "serve.batch.size": "predict requests coalesced per score-mode round",
    "serve.swap_stall_s": "request-visible pause while flipping snapshots",
    "ps.server.op.*_s": "per-op PS server handler duration",
    "ps.client.rpc_s": "single client RPC round-trip",
    "ps.client.sync_push_s": "push half of a sync round",
    "ps.client.sync_pull_s": "pull half of a sync round",
    "ps.client.sync_wait_s": "train-thread wait for the async comms thread",
    "sched.barrier_wait_s": "scheduler-side barrier hold time",
    "bsp.allreduce_s": "one BSP allreduce round, wall time",
    "bsp.checkpoint_s": "one BSP checkpoint (write + cache prune)",
    "sched.op.*_s": "per-op scheduler handler duration",
    "net.encode_s": "wire message encode duration",
    "net.decode_s": "wire message decode duration",
    "perf.*_s": "utils.perf mirror of ad-hoc timed ops",
    "retry.backoff_s": "sleep durations taken between retry attempts",
    "train.stage.load_s": "train-thread wait for the next packed batch",
    "train.stage.pack_s": "loader-side prepare (parse + pack) per batch",
    "train.stage.h2d_s": "loader-side host-to-device staging per batch",
    "train.stage.step_s": "jitted train/eval step call per batch",
    "train.stage.sync_s": "PS sync wall attributable to the train step",
    "train.stage.metrics_s": "progress merge + printing per batch",
    "train.stage.total_s": "train-thread wall per batch (load+step+metrics)",
}

SPANS: dict[str, str] = {
    "ps.snapshot": "server-side shard snapshot",
    "ps.sync.snapshot": "client-side delta snapshot under the store lock",
    "ps.sync.push": "push half of a sync round",
    "ps.sync.pull": "pull half of a sync round",
    "rpc.*": "one client RPC, named by op",
    "barrier.*": "scheduler barrier, named by barrier",
    "solver.part": "one data part processed by a worker",
    "solver.*_step": "one train/eval minibatch step",
    "serve.request": "root span of a sampled router predict request",
    "serve.rpc.*": "router-side shard RPC within a fan-out, named by op",
    "serve.stage.pack": "pack stage of a sampled predict request",
    "serve.stage.fanout": "fan-out stage of a sampled predict request",
    "serve.stage.score": "score stage of a sampled predict request",
    "serve.stage.sum": "piece-reassembly stage of a sampled request",
    "serve.shard.*": "serving-shard handler work, named by op",
    "ps.shard.*": "PS-shard handler work under a sampled round, by op",
    "ps.sync.round": "root span of a sampled PS sync round",
    "bsp.round": "root span of a sampled BSP collective round",
    "bsp.peer.*": "BSP peer handler work under a sampled round, by op",
}

EVENTS: dict[str, str] = {
    "ps.restore": "server shard restored from snapshot",
    "serve.swap": "serving shard flipped to a newer snapshot version",
    "ps.rollback": "client detected server epoch rollback",
    "ps.reconnect": "client reconnected to a respawned server",
    "sched.server_recovered": "scheduler accepted a server re-registration",
    "sched.serve_recovered": "scheduler accepted a serving-shard re-registration",
    "sched.bsp_recovered": "scheduler accepted a BSP worker re-registration",
    "sched.liveness_evict": "scheduler evicted an unresponsive node",
    "sched.resumed": "respawned scheduler resumed state from its journal",
    "sched.member_join": "scheduler admitted a worker into a running job",
    "sched.member_leave": "scheduler processed a worker's clean leave",
}
# fmt: on

ALL_METRICS: dict[str, dict[str, str]] = {
    "counter": COUNTERS,
    "gauge": GAUGES,
    "histogram": HISTOGRAMS,
}

ALL_TRACE: dict[str, dict[str, str]] = {
    "span": SPANS,
    "event": EVENTS,
}
