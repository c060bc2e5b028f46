"""The port's request tracing against the JAX package's
(tests/test_obs_trace.py's cases over the port): the trace context riding
the port's frame header across a real socket (and read by the JAX
package's frame reader), deterministic sampling, the null span with
tracing off, rebinding into worker threads, the tracer's lifecycle, the
snapshot ring, and the Prometheus text.

The same requests, spans and snapshots go through both packages' modules.
Tolerance: none. Trace records are compared exactly, apart from the clock
fields (``ts``, ``dur``, ``wall``, ``mono``); trace and span ids, the
sampled ordinals, ring contents and the Prometheus text are compared
exactly (the text byte for byte)."""

import json
import os
import socket
import threading

import pytest

from wormhole_tpu.obs import metrics as jax_metrics
from wormhole_tpu.obs import prom as jax_prom
from wormhole_tpu.obs import trace as jax_trace
from wormhole_tpu.runtime import net as jax_net
from wormhole_tpu_torch.obs import metrics as obs_metrics
from wormhole_tpu_torch.obs import prom as obs_prom
from wormhole_tpu_torch.obs import trace as obs_trace
from wormhole_tpu_torch.runtime.net import recv_frame, send_frame

CLOCK = ("ts", "dur", "wall", "mono")


@pytest.fixture
def retrace(monkeypatch):
    """Re-init both packages' tracing around a test and make sure both
    end disabled (each module inits from the env at import)."""
    yield monkeypatch
    monkeypatch.delenv("WH_OBS_DIR", raising=False)
    monkeypatch.delenv("WH_TRACE_SAMPLE", raising=False)
    for mod in (obs_trace, jax_trace):
        mod.init_from_env()
        assert mod.ACTIVE is None and mod.SAMPLE_N == 0


def _trace_lines(tracer) -> list[dict]:
    tracer.close()
    return [json.loads(l) for l in open(tracer.path)]


def _spans(lines: list[dict]) -> list[dict]:
    return [l for l in lines if l.get("ph") == "X"]


def _unclocked(lines: list[dict]) -> list[dict]:
    return [{k: v for k, v in l.items() if k not in CLOCK} for l in lines]


def _socket_files():
    a, b = socket.socketpair()
    return a, b, a.makefile("rwb"), b.makefile("rwb")


def _close(*objs):
    for o in objs:
        o.close()


# ------------------------------------------------------------ propagation
def test_trace_context_rides_the_frame_header(tmp_path, retrace):
    """A bound context crosses a real socket as header['tctx'] in the
    port's frame, and bind_wire on the receiver parents the handler span
    to the sender's span. The JAX package's frame reader sees the same
    header."""
    retrace.setenv("WH_OBS_DIR", str(tmp_path))
    retrace.setenv("WH_TRACE_SAMPLE", "1")
    tracer = obs_trace.init_from_env()
    a, b, fa, fb = _socket_files()
    try:
        with obs_trace.bind(obs_trace.start_request()):
            with obs_trace.request_span("serve.request", cat="serve"):
                sender = obs_trace.current_ctx()
                assert sender is not None
                send_frame(fa, {"op": "fetch"})
                send_frame(fa, {"op": "fetch"})
        header, arrays, _ = recv_frame(fb)
        assert header["tctx"] == {"t": sender[0], "s": sender[1]}
        jheader, _, _ = jax_net.recv_frame(fb)
        assert jheader == header
        with obs_trace.bind_wire(header):
            with obs_trace.request_span("serve.shard.fetch", cat="serve"):
                pass
    finally:
        _close(fa, fb, a, b)
    spans = _spans(_trace_lines(tracer))
    shard = next(s for s in spans if s["name"] == "serve.shard.fetch")
    root = next(s for s in spans if s["name"] == "serve.request")
    assert root["trace"] == sender[0] and "psid" not in root
    assert shard["trace"] == sender[0]  # the same request
    assert shard["psid"] == sender[1]  # parented across the wire
    assert shard["sid"] != root["sid"]


def _nested(mod, env, out_dir):
    env.setenv("WH_OBS_DIR", str(out_dir))
    env.setenv("WH_TRACE_SAMPLE", "1")
    tracer = mod.init_from_env()
    ctx = mod.start_request()
    assert ctx is not None and ctx[1] is None  # a root binds its trace only
    with mod.bind(ctx):
        with mod.request_span("serve.request", cat="serve"):
            with mod.request_span("serve.stage.pack", cat="serve"):
                pass
            mod.event("mid", cat="serve")
    assert mod.current_ctx() is None  # bind restored
    return ctx, _trace_lines(tracer)


def test_request_span_nesting_builds_psid_chain(tmp_path, retrace):
    ctx, lines = _nested(obs_trace, retrace, tmp_path / "port")
    spans = _spans(lines)
    pack = next(s for s in spans if s["name"] == "serve.stage.pack")
    root = next(s for s in spans if s["name"] == "serve.request")
    assert root["trace"] == pack["trace"] == ctx[0]
    assert "psid" not in root  # the root has no parent
    assert pack["psid"] == root["sid"]  # child -> parent
    ev = next(l for l in lines if l.get("ph") == "i")
    assert ev["trace"] == ctx[0] and ev["psid"] == root["sid"]
    # the JAX tracer writes the same records, ids included
    jctx, jlines = _nested(jax_trace, retrace, tmp_path / "jax")
    assert jctx == ctx
    assert _unclocked(jlines) == _unclocked(lines)


def test_ctx_rebinds_into_worker_threads(tmp_path, retrace):
    """Threads do not inherit thread-locals: a captured current_ctx()
    rebound in a pool thread restores the link."""
    retrace.setenv("WH_OBS_DIR", str(tmp_path))
    retrace.setenv("WH_TRACE_SAMPLE", "1")
    tracer = obs_trace.init_from_env()
    got = {}

    def worker(ctx):
        got["inherited"] = obs_trace.current_ctx()
        with obs_trace.bind(ctx):
            with obs_trace.request_span("serve.rpc.fetch", cat="serve"):
                got["wire"] = obs_trace.wire_ctx()

    with obs_trace.bind(obs_trace.start_request()):
        with obs_trace.request_span("serve.request", cat="serve"):
            t = threading.Thread(target=worker,
                                 args=(obs_trace.current_ctx(),))
            t.start()
            t.join()
    assert got["inherited"] is None  # thread-locals are not inherited
    assert got["wire"] is not None  # rebinding restores the link
    spans = _spans(_trace_lines(tracer))
    rpc = next(s for s in spans if s["name"] == "serve.rpc.fetch")
    root = next(s for s in spans if s["name"] == "serve.request")
    assert rpc["trace"] == root["trace"]
    assert rpc["psid"] == root["sid"]


# --------------------------------------------------------------- sampling
def _sampled(mod, env, out_dir) -> tuple:
    env.setenv("WH_OBS_DIR", str(out_dir))
    env.setenv("WH_TRACE_SAMPLE", "4")
    mod.init_from_env()
    pattern = [mod.start_request() is not None for _ in range(8)]
    mod.init_from_env()  # a fresh incarnation samples the same ordinals
    again = [mod.start_request() is not None for _ in range(8)]
    mod.init_from_env()
    ids = [mod.start_request() for _ in range(8)]
    return pattern, again, ids


def test_sampling_is_deterministic_and_counter_based(tmp_path, retrace):
    pattern, again, ids = _sampled(obs_trace, retrace, tmp_path / "port")
    assert pattern == [False, False, False, True,
                       False, False, False, True]
    assert again == pattern
    sampled = [c for c in ids if c is not None]
    assert len(sampled) == 2
    assert len({c[0] for c in sampled}) == 2
    assert all(c[0].endswith(("r4", "r8")) for c in sampled)
    # the JAX tracer samples the same ordinals under the same ids
    assert _sampled(jax_trace, retrace, tmp_path / "jax") == (
        pattern, again, ids)


def test_sample_zero_never_samples(tmp_path, retrace):
    retrace.setenv("WH_OBS_DIR", str(tmp_path))
    retrace.setenv("WH_TRACE_SAMPLE", "0")
    obs_trace.init_from_env()
    assert all(obs_trace.start_request() is None for _ in range(32))
    # with no bound context a request span is the shared no-op, even
    # with the tracer on
    assert obs_trace.request_span("a") is obs_trace.request_span("b")


def test_bad_sample_value_means_off(tmp_path, retrace):
    retrace.setenv("WH_OBS_DIR", str(tmp_path))
    retrace.setenv("WH_TRACE_SAMPLE", "banana")
    obs_trace.init_from_env()
    assert obs_trace.SAMPLE_N == 0
    assert obs_trace.start_request() is None


# --------------------------------------------------------- off = zero cost
def test_tracing_off_is_null_on_every_hook(retrace):
    retrace.delenv("WH_OBS_DIR", raising=False)
    retrace.delenv("WH_TRACE_SAMPLE", raising=False)
    assert obs_trace.init_from_env() is None
    s = obs_trace.span("a", x=1)
    assert s is obs_trace.span("b")
    assert s is obs_trace.request_span("c")
    assert obs_trace.start_request() is None
    assert obs_trace.wire_ctx() is None
    assert obs_trace.bind_wire({"op": "x"}) is s  # the shared null object
    with obs_trace.bind(None), obs_trace.request_span("d"):
        pass
    # a frame sent with tracing off grows no tctx, even under a stale
    # bound context
    a, b, fa, fb = _socket_files()
    try:
        with obs_trace.bind(("stale:1:r1", "stale:1:1")):
            send_frame(fa, {"op": "fetch"})
        header, _, _ = recv_frame(fb)
        assert "tctx" not in header
    finally:
        _close(fa, fb, a, b)


# ------------------------------------------------------------- lifecycle
def test_init_from_env_is_reentrant_and_closes_predecessor(tmp_path,
                                                           retrace):
    retrace.setenv("WH_OBS_DIR", str(tmp_path))
    first = obs_trace.init_from_env()
    second = obs_trace.init_from_env()
    assert second is obs_trace.ACTIVE and second is not first
    assert first._closed  # the replaced tracer was closed, not leaked
    second.close()  # close is idempotent, the atexit hook's too
    second.close()
    obs_trace._shutdown()
    obs_trace._shutdown()
    second.emit_span("late", "t", 0.0, 0.0)  # swallowed after close


def test_init_from_env_concurrent_reinit_is_safe(tmp_path, retrace):
    retrace.setenv("WH_OBS_DIR", str(tmp_path))
    barrier = threading.Barrier(8)

    def reinit():
        barrier.wait()
        obs_trace.init_from_env()

    ts = [threading.Thread(target=reinit) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    tracer = obs_trace.ACTIVE
    assert tracer is not None and not tracer._closed
    with obs_trace.span("after.reinit", cat="t"):
        pass
    assert any(s["name"] == "after.reinit"
               for s in _spans(_trace_lines(tracer)))


# ------------------------------------------------------------- ring + prom
def test_snapshot_ring_retains_newest_in_order():
    rings = (obs_metrics.SnapshotRing(4), jax_metrics.SnapshotRing(4))
    assert len(rings[0]) == 0 and rings[0].items() == []
    for ring in rings:
        for i in range(10):
            ring.add(float(i), {"counters": {"n": i}})
    ring = rings[0]
    assert len(ring) == 4
    got = ring.items()
    assert [ts for ts, _ in got] == [6.0, 7.0, 8.0, 9.0]
    assert [s["counters"]["n"] for _, s in got] == [6, 7, 8, 9]
    assert got == rings[1].items()
    got.clear()  # items() hands out a list of the caller's own
    assert len(ring) == 4


SNAP = {
    "counters": {"net.bytes_sent": 17, "serve.router.requests": 3,
                 "admit.sheds": 5, "flight.dumps": 2,
                 "serve.batch.rounds": 9, "net.bshuf.bytes_out": 7,
                 "wire.codec.bytes_raw": 400, "wire.codec.bytes_wire": 100},
    "gauges": {"slo.serve.latency_burn": 0.25, "prof.overhead_frac": 0.004,
               "wire.codec.ef_resid_norm": 0.125},
    "hists": {
        "serve.batch.size": {"count": 3, "sum": 12.0, "min": 1.0,
                             "max": 8.0, "res": [1.0, 3.0, 8.0]},
        "serve.latency_s": {"count": 4, "sum": 1.0, "min": 0.1,
                            "max": 0.4, "res": [0.1, 0.2, 0.3, 0.4]},
        "train.stage.step_s": {"count": 2, "sum": 0.5, "min": 0.2,
                               "max": 0.3, "res": [0.2, 0.3]},
        "never.observed_s": {"count": 0, "sum": 0.0, "res": []},
    },
}


def _summary(name: str) -> str:
    q = {p: repr(float(obs_metrics.hist_quantile(SNAP["hists"][name], p)))
         for p in (0.5, 0.9, 0.99)}
    metric = obs_prom.prom_name(name)
    h = SNAP["hists"][name]
    return (f"# TYPE {metric} summary\n"
            + "".join(f'{metric}{{quantile="{p}"}} {q[p]}\n'
                      for p in (0.5, 0.9, 0.99))
            + f"{metric}_sum {h['sum']!r}\n{metric}_count {h['count']}\n")


def test_prometheus_exposition_equals_the_jax_text():
    body = obs_prom.render_snapshot(SNAP)
    assert body == jax_prom.render_snapshot(SNAP)  # byte for byte
    counters = "".join(
        f"# TYPE wh_{k.replace('.', '_')}_total counter\n"
        f"wh_{k.replace('.', '_')}_total {SNAP['counters'][k]}\n"
        for k in sorted(SNAP["counters"]))
    gauges = "".join(
        f"# TYPE wh_{k.replace('.', '_')} gauge\n"
        f"wh_{k.replace('.', '_')} {SNAP['gauges'][k]!r}\n"
        for k in sorted(SNAP["gauges"]))
    assert body == counters + gauges + "".join(
        _summary(n) for n in ("serve.batch.size", "serve.latency_s",
                              "train.stage.step_s"))
    assert obs_prom.render_snapshot({}) == ""
    assert obs_prom.prom_name("serve.stage.pack_s") == \
        "wh_serve_stage_pack_s"
    # the port's registry renders as the JAX one for the same observations
    regs = (obs_metrics.Registry(), jax_metrics.Registry())
    for r in regs:
        r.counter("ps.client.replays").inc(4)
        r.gauge("queue.depth").set(3)
        for v in (0.002, 0.004, 0.008):
            r.histogram("train.stage.step_s").observe(v)
    assert obs_prom.render_snapshot(regs[0].snapshot()) == \
        jax_prom.render_snapshot(regs[1].snapshot())
