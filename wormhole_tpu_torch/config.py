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
# same names, types, defaults and docs for the knobs the port reads (the
# serving tier and the wire, retry, overload, fault and obs layers beneath
# it). The loader plane's WH_PACK_CACHE* and WH_NUM_LOADERS are still read
# straight from the environment.
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
