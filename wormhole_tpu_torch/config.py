"""Config system: `key = value` text files with CLI override merge.

Parity with the reference's config path (learn/base/arg_parser.h:36-60):
a conf file of `key = value` lines merged with later `key=value` CLI
args, args winning. Values are typed by the dataclass schema each learner
declares. Repeated keys accumulate into lists (protobuf repeated-field
semantics). The same conf files drive the JAX package and this port.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, get_args, get_origin


def parse_conf_text(text: str) -> dict[str, list[str]]:
    """Parse `key = value` lines; '#' comments; repeated keys accumulate."""
    out: dict[str, list[str]] = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" in line:
            k, v = line.split("=", 1)
        elif ":" in line:
            k, v = line.split(":", 1)
        else:
            raise ValueError(f"bad config line: {raw!r}")
        v = v.strip()
        if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
            v = v[1:-1]
        out.setdefault(k.strip(), []).append(v)
    return out


def parse_argv(argv: list[str]) -> dict[str, list[str]]:
    """Parse `key=value` CLI tokens (reference rabit-style SetParam args and
    the PS apps' trailing-arg merge, arg_parser.h:41-44)."""
    out: dict[str, list[str]] = {}
    for tok in argv:
        if "=" not in tok:
            raise ValueError(f"expected key=value, got {tok!r}")
        k, v = tok.split("=", 1)
        out.setdefault(k.strip().lstrip("-"), []).append(v.strip())
    return out


def _convert(val: str, typ) -> Any:
    if typ is bool:
        return val.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    return val


def load_config(cls, conf_file: Optional[str] = None, argv: Optional[list[str]] = None):
    """Build a dataclass config: defaults <- conf file <- CLI args."""
    merged: dict[str, list[str]] = {}
    if conf_file:
        with open(conf_file) as f:
            for k, vs in parse_conf_text(f.read()).items():
                merged[k] = vs
    if argv:
        for k, vs in parse_argv(argv).items():
            merged.setdefault(k, [])
            merged[k] = merged[k] + vs if _is_repeated(cls, k) else vs
    return apply_config(cls, merged)


def _resolve_type(typ):
    if isinstance(typ, str):  # from __future__ annotations
        typ = eval(typ, {"Optional": Optional, "list": list, "str": str,
                         "int": int, "float": float, "bool": bool})
    return typ


def _is_repeated(cls, key: str) -> bool:
    for f in dataclasses.fields(cls):
        if f.name == key:
            return get_origin(_resolve_type(f.type)) is list
    return False


def apply_config(cls, kv: dict[str, list[str]]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    unknown = []
    for k, vs in kv.items():
        f = fields.get(k)
        if f is None:
            unknown.append(k)
            continue
        typ = _resolve_type(f.type)
        origin = get_origin(typ)
        if origin is list:
            (elem,) = get_args(typ)
            kwargs[k] = [_convert(v, elem) for v in vs]
        elif origin is not None and type(None) in get_args(typ):  # Optional[T]
            elem = [a for a in get_args(typ) if a is not type(None)][0]
            kwargs[k] = _convert(vs[-1], elem)
        else:
            kwargs[k] = _convert(vs[-1], typ)
    if unknown:
        raise ValueError(f"unknown config keys: {unknown} for {cls.__name__}")
    return cls(**kwargs)

# ---------------------------------------------------------------------------
# Environment-knob registry: the port's copy of the JAX package's, with the
# same names, types, defaults and docs for every knob the port reads.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnvKnob:
    """One declared environment knob."""

    name: str
    type: type
    default: Any
    doc: str
    group: str = "runtime"


KNOBS: dict[str, EnvKnob] = {}


def declare_knob(name: str, type: type, default: Any, doc: str,
                 group: str = "runtime") -> EnvKnob:
    """Register an env knob. Idempotent for identical re-declarations;
    conflicting re-declaration is a bug and raises."""
    knob = EnvKnob(name, type, default, doc, group)
    prev = KNOBS.get(name)
    if prev is not None and prev != knob:
        raise ValueError(f"env knob {name} re-declared with a different spec: "
                         f"{prev} vs {knob}")
    KNOBS[name] = knob
    return knob


def env_flag(name: str, default: bool = False) -> bool:
    """Truthy-string env read shared by the boolean knobs."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("", "0", "false", "off")


def knob_value(name: str) -> Any:
    """Typed read of a declared knob: env value converted to the declared
    type, or the declared default when unset/empty."""
    knob = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return knob.default
    if knob.type is bool:
        return raw.lower() not in ("", "0", "false", "off")
    return knob.type(raw)


def _fmt_default(knob: EnvKnob) -> str:
    if knob.default is None:
        return "(unset)"
    if knob.type is str and knob.default == "":
        return '`""`'
    return f"`{knob.default}`"


def knob_table_markdown(group: Optional[str] = None) -> str:
    """Render the declared knobs (optionally one group) as a Markdown table."""
    rows = sorted((k for k in KNOBS.values()
                   if group is None or k.group == group),
                  key=lambda k: k.name)
    lines = ["| Knob | Type | Default | Description |",
             "| --- | --- | --- | --- |"]
    for k in rows:
        lines.append(f"| `{k.name}` | {k.type.__name__} | {_fmt_default(k)} "
                     f"| {k.doc} |")
    return "\n".join(lines)


declare_knob("WH_FAULT_SPEC", str, "",
             "Fault-injection spec (`kind:role:rank:when`, see "
             "runtime/faults.py); empty disables injection.", group="faults")

declare_knob("WH_RETRY_BASE_SEC", float, 0.05,
             "Initial backoff step of the unified retry policy "
             "(runtime/retry.py); each retry doubles it up to "
             "WH_RETRY_CAP_SEC, with full jitter.", group="faults")

declare_knob("WH_RETRY_CAP_SEC", float, 1.0,
             "Backoff ceiling of the unified retry policy; sleeps never "
             "exceed this (or the budget's remaining deadline).",
             group="faults")

declare_knob("WH_OBS_DIR", str, "",
             "Directory for trace-span JSONL and run_report.json; empty "
             "disables file output.", group="obs")

declare_knob("WH_RUN_ID", str, None,
             "Run identifier stamped into traces/reports; generated by the "
             "launcher when unset.", group="obs")

declare_knob("WH_TRACE_SAMPLE", int, 0,
             "Cross-node request-trace sampling: every Nth request / PS sync "
             "round / BSP round carries a trace context over the wire "
             "(1 = every request, 0 = off). Needs WH_OBS_DIR.", group="obs")

declare_knob("WH_SLO_SERVE_P99_MS", float, 500.0,
             "Serving latency SLO: p99 of serve.latency_s must stay under "
             "this many milliseconds.", group="obs")

declare_knob("WH_PROF", bool, False,
             "Continuous sampling profiler (obs/pyprof.py): a daemon "
             "thread samples every thread's stack at WH_PROF_HZ into "
             "folded-stack tallies. Off = no sampler thread exists.",
             group="obs")

declare_knob("WH_PROF_HZ", float, 29.0,
             "Profiler sampling rate in Hz. A prime-ish default avoids "
             "lockstep with periodic loops.", group="obs")

declare_knob("WH_PROF_BUDGET_PCT", float, 2.0,
             "Profiler overhead budget as a percent of wall time; the "
             "sampler throttles itself (skips samples) above it.",
             group="obs")

declare_knob("WH_FLIGHT", bool, False,
             "Per-node flight recorder (obs/flight.py): fixed-size rings "
             "of recent spans, overload decisions, metric snapshots, and "
             "sampled stacks, dumped to JSONL on anomaly triggers. Off = "
             "every hook is one None check.", group="obs")

declare_knob("WH_FLIGHT_RING", int, 512,
             "Flight-recorder span/hop ring capacity (records kept).",
             group="obs")

declare_knob("WH_FLIGHT_DECISIONS", int, 256,
             "Flight-recorder overload-decision ring capacity.",
             group="obs")

declare_knob("WH_FLIGHT_SNAPS", int, 16,
             "Flight-recorder metric-snapshot ring capacity (snapshots "
             "sampled at most every ~5s while records flow).", group="obs")

declare_knob("WH_FLIGHT_DIR", str, "",
             "Directory for flight-*.jsonl dumps; empty falls back to "
             "WH_OBS_DIR.", group="obs")

declare_knob("WH_FLIGHT_MIN_SEC", float, 10.0,
             "Minimum seconds between unforced flight dumps on one node "
             "(dump storms from repeated triggers are suppressed).",
             group="obs")
declare_knob("WH_SAN", bool, False,
             "Runtime concurrency sanitizer (tools/wormsan): wraps every "
             "Lock/RLock to detect lock-order cycles, blocking calls "
             "under registry-known locks, and sampled lockset races over "
             "wormlint's shared-state model. Off = nothing is patched.",
             group="obs")
declare_knob("WH_SAN_SAMPLE", int, 1,
             "Sanitizer race-detector sampling: check 1-in-N instrumented "
             "attribute writes (1 = every write; raise to cut overhead "
             "under load).", group="obs")
declare_knob("WH_SAN_DUMP_DIR", str, "",
             "Directory for san-<pid>.jsonl finding dumps; replay with "
             "`python -m tools.wormsan <dir>`. Empty = in-process and "
             "stderr reporting only.", group="obs")

declare_knob("WH_WIRE_DEBUG", str, "",
             "Wire-codec diagnostics to stderr: '1' prints each EFQuant "
             "residual-store merge, '2' additionally prints a per-array "
             "accounting line per sent frame (name, encoding, framing, "
             "post-compression bytes) — the breakdown that attributes "
             "bytes_per_sync to individual tables.", group="ps")

declare_knob("WH_NET_MAX_INFLIGHT", int, 0,
             "Max requests a frame server (PS shard / serving shard) admits "
             "concurrently; overflow gets a structured `busy` reply the "
             "client backs off on and retries (0 = unlimited).",
             group="ps")

declare_knob("WH_DEADLINE_SHED", bool, True,
             "Shed frames whose propagated deadline expired before dispatch "
             "(the `dl` header field); off = deadlines still ride the wire "
             "but every frame is dispatched.", group="ps")

declare_knob("WH_ADMIT_AIMD", bool, False,
             "Adaptive (AIMD) admission control on frame servers: the "
             "in-flight limit walks between WH_ADMIT_MIN and WH_ADMIT_MAX "
             "driven by measured handler latency and SLO burn, instead of "
             "the fixed WH_NET_MAX_INFLIGHT bound.", group="ps")

declare_knob("WH_ADMIT_MIN", int, 4,
             "Floor of the AIMD admission limit.", group="ps")

declare_knob("WH_ADMIT_MAX", int, 256,
             "Ceiling of the AIMD admission limit (also the adaptive "
             "starting limit when WH_NET_MAX_INFLIGHT is 0).", group="ps")

declare_knob("WH_ADMIT_LATENCY_MS", float, 50.0,
             "Service-latency target of the AIMD controller: a completion "
             "window whose EWMA handler latency exceeds this multiplies "
             "the limit by WH_ADMIT_BACKOFF.", group="ps")

declare_knob("WH_ADMIT_BACKOFF", float, 0.7,
             "Multiplicative-decrease factor of the AIMD admission "
             "controller.", group="ps")


declare_knob("WH_SERVE_POLL_SEC", float, 1.0,
             "Hot-swap watcher poll interval: how often a serving shard "
             "checks the snapshot manifest for a newer model version.",
             group="serve")

declare_knob("WH_SERVE_RETRY_SEC", float, 30.0,
             "Router-side retry window for a dead serving shard: how long "
             "predict fan-outs re-resolve and redial before a batch fails.",
             group="serve")

declare_knob("WH_SERVE_WIRE", str, "raw",
             "Serving reply encoding: 'raw' keeps the bit-identity "
             "contract vs the trainer's predict_batch; 'bf16' truncates "
             "fetch/score reply values (round-to-nearest-even) for half "
             "the reply bytes, relaxing scores to a documented ulp "
             "contract. Request-stamped, so retried frames replay "
             "byte-identically either way.", group="serve")

declare_knob("WH_SERVE_MODE", str, "auto",
             "Serving dataflow: 'fetch' ships weight rows to the router, "
             "'score' runs the shard-local fast path (partial margins "
             "summed router-side), 'auto' picks score whenever the "
             "scorer supports it.", group="serve")

declare_knob("WH_SERVE_BATCH_MAX", int, 64,
             "Micro-batcher round size cap: at most this many concurrent "
             "predict requests coalesce into one score fan-out.",
             group="serve")

declare_knob("WH_SERVE_BATCH_WAIT_MS", float, 0.0,
             "Micro-batcher linger: how long a round holds for more "
             "arrivals before flushing (0 = flush immediately; batching "
             "still emerges from arrivals during an executing round). "
             "Ignored while degraded mode is active.", group="serve")

declare_knob("WH_DEADLINE_MS", float, 0.0,
             "Per-request deadline the router binds around each predict "
             "batch, propagated to shards in frame headers; expired work "
             "is shed instead of computed (0 = no implicit deadline).",
             group="serve")

declare_knob("WH_HEDGE", bool, False,
             "Hedged fan-out: a shard RPC still unanswered after the "
             "rolling WH_HEDGE_QUANTILE latency gets ONE backup request "
             "on a fresh connection; the shard reply cache keeps the "
             "duplicate exactly-once.", group="serve")

declare_knob("WH_HEDGE_QUANTILE", float, 0.95,
             "Latency quantile of recent primary RPCs after which a hedge "
             "fires.", group="serve")

declare_knob("WH_HEDGE_BUDGET_PCT", float, 5.0,
             "Hedge budget: backups may add at most this percent to the "
             "primary RPC count.", group="serve")

declare_knob("WH_HEDGE_MIN_MS", float, 5.0,
             "Floor of the hedge delay, so a fast window cannot hedge "
             "aggressively enough to double load.", group="serve")

declare_knob("WH_DEGRADE", bool, True,
             "Degraded-mode serving: under sustained SLO burn the router "
             "stops the mixed-version fan-out replay and serves bounded-"
             "staleness replies stamped degraded=1, recovering when burn "
             "clears.", group="serve")

declare_knob("WH_DEGRADE_BURN", float, 5.0,
             "Burn-rate threshold (violating fraction over the SLO "
             "allowance) that arms degraded mode.", group="serve")

declare_knob("WH_DEGRADE_AFTER_SEC", float, 2.0,
             "Seconds the burn must stay above WH_DEGRADE_BURN before "
             "degraded mode activates.", group="serve")

declare_knob("WH_DEGRADE_CLEAR_SEC", float, 5.0,
             "Seconds the burn must stay clear before degraded mode "
             "deactivates.", group="serve")


# -- the parameter-server plane: launcher, scheduler, servers, workers
declare_knob("WH_ROLE", str, None,
             "Node role (`scheduler`/`server`/`worker`); set by the launcher.",
             group="runtime")
declare_knob("WH_RANK", int, 0,
             "Rank of this node within its role group.", group="runtime")
declare_knob("WH_NUM_WORKERS", int, 1,
             "Worker count the scheduler waits for.", group="runtime")
declare_knob("WH_NUM_SERVERS", int, 1,
             "Server count the scheduler waits for.", group="runtime")
declare_knob("WH_SCHEDULER_URI", str, "",
             "host:port of the scheduler RPC endpoint.", group="runtime")
declare_knob("WH_COORD_URI", str, "",
             "host:port of the coordination endpoint handed to nodes.",
             group="runtime")
declare_knob("WH_NODE_TIMEOUT", float, 30.0,
             "Seconds without a heartbeat before the scheduler evicts a node.",
             group="runtime")
declare_knob("WH_RESTORE_EPOCH", int, 0,
             "Epoch to restore server shards from after a respawn.",
             group="faults")
declare_knob("WH_SNAPSHOT_DIR", str, "",
             "Directory for epoch-stamped PS shard snapshots; empty disables.",
             group="faults")
declare_knob("WH_PS_RETRY_SEC", float, 0.0,
             "Client-side PS reconnect window in seconds (0 = fail fast).",
             group="faults")
declare_knob("WH_SCHED_RETRY_SEC", float, 0.0,
             "Client-side scheduler RPC retry window in seconds (0 = fail "
             "fast). Retried mutating ops carry a per-sender seq the "
             "scheduler's journaled reply cache deduplicates, so retries "
             "stay exactly-once across a scheduler restart. Exported "
             "automatically by the launcher when --max-scheduler-restarts "
             "is set.", group="faults")
declare_knob("WH_SCHED_JOURNAL", bool, True,
             "Write-ahead journal for the scheduler control plane under "
             "WH_SNAPSHOT_DIR (sched.journal + sched.snapshot): every "
             "state-mutating op is fsync'd before the reply is sent, and "
             "a respawned scheduler replays it to resume the job. Only "
             "active when WH_SNAPSHOT_DIR is set.", group="faults")
declare_knob("WH_SCHED_JOURNAL_COMPACT", int, 512,
             "Compact the scheduler journal into an atomic snapshot once "
             "this many records accumulated (checked at round starts, the "
             "quiescent point). 0 disables compaction.", group="faults")
declare_knob("WH_OBS_SCRAPE_SEC", float, 0.0,
             "Scheduler telemetry sampler period in seconds: each tick "
             "appends the aggregated cluster snapshot to an in-memory ring "
             "(the `metrics` verb's history=1 view). 0 = off.", group="obs")
declare_knob("WH_OBS_RING", int, 120,
             "Capacity of the scheduler's metrics-snapshot ring buffer.",
             group="obs")
declare_knob("WH_OBS_SCRAPE_PORT", int, 0,
             "Prometheus text-exposition HTTP port on the scheduler "
             "(GET /metrics). 0 = off.", group="obs")
declare_knob("WH_SLO_SERVE_ERR_BUDGET", float, 0.001,
             "Serving error SLO: failed fraction of router requests allowed "
             "before the error budget is burned.", group="obs")
declare_knob("WH_SLO_PS_RPC_P99_MS", float, 250.0,
             "PS RPC latency SLO: p99 of ps.client.rpc_s must stay under "
             "this many milliseconds.", group="obs")
declare_knob("WH_ASYNC_SYNC", bool, False,
             "Overlap PS push/pull with compute on a background comms thread.",
             group="ps")
declare_knob("WH_KEYCACHE", bool, False,
             "Key-list digest caching on the PS wire (resend on miss).",
             group="ps")
# In the port a worker's "devices" are torch.cuda.device_count(): 'auto'
# is hot for -n 1 with two or more cards, tcp on one card and on the CPU
# (apps/_runner.py _pick_plane). The help text stays the JAX registry's.
declare_knob("WH_PS_PLANE", str, "auto",
             "Parameter plane: 'tcp' = SyncedStore push/pull RPCs every "
             "max_delay steps, 'hot' = device-resident sharded tables with "
             "in-jit collective aggregation and the TCP servers demoted to "
             "a cold tier synced at flush barriers, 'auto' = hot when the "
             "job's workers share one process with >=2 devices.",
             group="ps")
declare_knob("WH_NET_COMPRESS", bool, False,
             "zlib-compress every PS wire frame (negotiated in hello; both "
             "ends must enable it). Meant for the hot plane's cold-tier/"
             "snapshot path and cross-pod sync, where flush frames are "
             "large and rare.", group="ps")
declare_knob("WH_WIRE", str, "raw",
             "Value encoding on the parameter wire: 'raw' f32, 'bf16' "
             "truncation, 'int8' / 'int4' absmax quantization (per-row "
             "scales for 2-D tables, per-64-element group scales for "
             "1-D). Applies to SyncedStore pushes (accumulator tables "
             "with TableSpec.wire_cap floor at bf16), PS pull replies "
             "(capped at bf16 — absolute-state refreshes need "
             "per-element relative precision — and derived tables skip "
             "the wire: the client recomputes w from the pulled z/n), "
             "and BSP allreduce chunks; negotiated in hello with "
             "legacy-bf16 fallback for old peers.", group="ps")
declare_knob("WH_WIRE_EF", bool, True,
             "Error feedback for quantized wire values: re-inject each "
             "row's quantization error the next time it ships, making "
             "int8/int4 streams unbiased over time. PS pushes get it via "
             "the SyncedStore base algebra, pulls via server-side "
             "per-sender residuals; the BSP plane quantizes statelessly "
             "regardless (cross-round residuals would break replay "
             "bit-identity). No effect under WH_WIRE=raw.", group="ps")
declare_knob("WH_WIRE_COMP", str, "",
             "Frame compression mode: '' off, 'zlib' (the WH_NET_COMPRESS "
             "codec), 'bshuf' = byte-plane shuffle + zlib-6 (groups "
             "same-significance bytes; wins on ratio and speed for float "
             "tables, and sorted index vectors additionally ship "
             "delta-encoded). Hello-negotiated: an old peer that only "
             "acks zlib gets zlib, one that acks nothing gets raw "
             "frames.",
             group="ps")
declare_knob("WH_NUM_SERVE", int, 0,
             "Serving-shard count the launcher's --serve role group exports.",
             group="serve")
declare_knob("WH_BSP_STEP_TIMEOUT", float, 2.0,
             "Seconds a BSP worker blocks on one ring step before "
             "re-polling the tracker for a membership change.",
             group="bsp")
declare_knob("WH_BSP_RETRY_SEC", float, 120.0,
             "Total seconds a blocked BSP collective waits for a dead "
             "peer's respawn before failing the job.",
             group="bsp")
declare_knob("WH_ELASTIC", bool, False,
             "Elastic worker membership: the launcher supervises the worker "
             "set and spawns/retires workers on scheduler decisions "
             "(MembershipController or WH_ELASTIC_PLAN).", group="elastic")
declare_knob("WH_ELASTIC_SEC", float, 5.0,
             "Cadence of the scheduler's membership-controller loop (and "
             "the launcher's elastic-decision poll).", group="elastic")
declare_knob("WH_ELASTIC_MIN", int, 1,
             "Floor of the elastic worker count; the controller never "
             "shrinks below it.", group="elastic")
declare_knob("WH_ELASTIC_MAX", int, 0,
             "Ceiling of the elastic worker count (0 = twice the launch "
             "size).", group="elastic")
declare_knob("WH_ELASTIC_JOIN", bool, False,
             "Set by the launcher's elastic supervisor on workers it spawns "
             "mid-job: announce a `join` to the scheduler before taking "
             "work (internal handshake, not user-facing).", group="elastic")
declare_knob("WH_ELASTIC_PLAN", str, "",
             "Scripted membership plan `join@<sec>,leave@<sec>,...` "
             "(seconds from job start): deterministic churn for drills; "
             "empty = gauge-driven controller decisions.", group="elastic")
declare_knob("WH_SERVE_SNAPSHOT", str, "",
             "Snapshot base path the serving shards load and watch "
             "(default: <WH_SNAPSHOT_DIR>/srv — the trainer's PS shard "
             "snapshots).", group="serve")

# -- the launcher's scheduler port
declare_knob("WH_SCHED_PORT", int, 0,
             "Pin the launcher's scheduler RPC port so outside tooling "
             "(chaos_lab serve driver, obs_top) can dial the job; 0 = "
             "ephemeral.", group="runtime")

# -- the loader plane
declare_knob("WH_PACK_CACHE", bool, False,
             "Enable the packed-batch epoch cache.", group="data")
declare_knob("WH_PACK_CACHE_DIR", str, None,
             "Disk tier directory for the pack cache; unset = memory only.",
             group="data")
declare_knob("WH_PACK_CACHE_MB", int, 512,
             "Memory-tier byte budget for the pack cache, in MiB.",
             group="data")
declare_knob("WH_NUM_LOADERS", int, None,
             "Pin the loader thread-pool size (disables adaptive sizing "
             "unless WH_ADAPTIVE_LOADERS overrides).", group="data")
declare_knob("WH_ADAPTIVE_LOADERS", bool, True,
             "Stall-driven loader pool resizing between passes (defaults on "
             "unless WH_NUM_LOADERS pins the size).", group="data")
declare_knob("WH_DEVICE_FEED", bool, True,
             "Loader-side device staging (double-buffered feed).",
             group="data")

# -- debugging
declare_knob("WORMHOLE_STACKDUMP", bool, False,
             "Install a SIGUSR1 stack-dump handler at import.", group="debug")
declare_knob("WORMHOLE_DEBUG", bool, False,
             "Verbose debug printing in the GBDT trainer.", group="debug")
declare_knob("WORMHOLE_PROFILE_DIR", str, None,
             "Directory for utils/perf.py profile dumps.", group="debug")


def config_to_text(cfg) -> str:
    """A config dataclass as `key = value` lines (None fields left out,
    a list one line per element): what `load_config` reads back."""
    lines = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if v is None:
            continue
        if isinstance(v, list):
            lines += [f"{f.name} = {x}" for x in v]
        else:
            lines.append(f"{f.name} = {v}")
    return "\n".join(lines) + "\n"
