"""The port's flight recorder and sampling profiler against the JAX
package's (tests/test_obs_flight.py's cases over the port): the off-is-
free contracts, ring retention and the dump format, the dump rate limit,
spans fed to the recorder without a file tracer, tools/blackbox.py over a
port node's dump and a JAX node's, the scheduler's `flight` verb with its
cluster-wide piggyback, the profiler's roles (the solver's `train` and
`loader` threads among them) and its overhead budget, and the train-stage
table.

The same records go through both packages' recorders, and the same
snapshot through both stage tables. Tolerance: none. Dumps and tables are
compared exactly, apart from the clock fields (``ts``, ``wall``, ``mono``,
``generated_unix``) and the metric snapshot a dump carries (each package
has a registry of its own)."""

import importlib.util
import json
import os
import threading
import time

import pytest

from wormhole_tpu.obs import flight as jax_flight
from wormhole_tpu.obs import metrics as jax_metrics
from wormhole_tpu.obs import report as jax_report
from wormhole_tpu.obs import trace as jax_trace
from wormhole_tpu_torch.obs import flight as obs_flight
from wormhole_tpu_torch.obs import metrics as obs_metrics
from wormhole_tpu_torch.obs import pyprof as obs_pyprof
from wormhole_tpu_torch.obs import report as obs_report
from wormhole_tpu_torch.obs import trace as obs_trace
from wormhole_tpu_torch.runtime.tracker import Scheduler, SchedulerClient

from conftest import synth_libsvm_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK = ("ts", "wall", "mono", "generated_unix")
KNOBS = ("WH_FLIGHT", "WH_FLIGHT_DIR", "WH_FLIGHT_RING",
         "WH_FLIGHT_DECISIONS", "WH_FLIGHT_SNAPS", "WH_FLIGHT_MIN_SEC",
         "WH_PROF", "WH_PROF_HZ", "WH_PROF_BUDGET_PCT", "WH_OBS_DIR",
         "WH_RUN_ID")


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def reflight(monkeypatch):
    """Re-init flight, prof and trace of both packages around a test and
    make sure all end disabled (the modules init from env at import)."""
    yield monkeypatch
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for mods in ((obs_flight, obs_pyprof, obs_trace),
                 (jax_flight, jax_trace)):
        for mod in mods:
            mod.init_from_env()
            assert mod.ACTIVE is None


def _dump_lines(path: str) -> list[dict]:
    return [json.loads(l) for l in open(path)]


def _records(path: str) -> list[dict]:
    """A dump's lines without clock fields or the registry snapshot."""
    return [{k: v for k, v in rec.items() if k not in CLOCK}
            for rec in _dump_lines(path)
            if rec.get("name") != "flight.snapshot"]


# ------------------------------------------------------- off = zero cost
def test_flight_off_every_hook_is_noop(reflight):
    reflight.delenv("WH_FLIGHT", raising=False)
    assert obs_flight.init_from_env() is None
    obs_flight.record_decision("shed", "nope", op="fetch")
    obs_flight.record_hop("push", 0.125)
    obs_flight.record_stack(["main;x 1"])
    assert obs_flight.dump("nothing", force=True) is None
    # with trace AND flight off, span() stays the shared null object
    reflight.delenv("WH_OBS_DIR", raising=False)
    obs_trace.init_from_env()
    assert obs_trace.span("a") is obs_trace.span("b")


def test_pyprof_off_no_thread_and_tag_is_cheap(reflight):
    reflight.delenv("WH_PROF", raising=False)
    assert obs_pyprof.init_from_env() is None
    assert obs_pyprof.ACTIVE is None
    assert not [t for t in threading.enumerate() if t.name == "wh-pyprof"]
    obs_pyprof.tag_thread("train")  # always on, one dict write
    assert obs_pyprof._role_of(threading.get_ident(), "x") == "train"
    del obs_pyprof._ROLES[threading.get_ident()]


# ----------------------------------------------------- rings + dump file
def _ring_dump(mod, env, out_dir) -> str:
    env.setenv("WH_FLIGHT", "1")
    env.setenv("WH_FLIGHT_DIR", str(out_dir))
    env.setenv("WH_FLIGHT_RING", "4")
    env.setenv("WH_FLIGHT_DECISIONS", "2")
    env.setenv("WH_RUN_ID", "fl-run")
    fr = mod.init_from_env()
    assert fr is not None and mod.ACTIVE is fr
    t0 = time.monotonic()
    for i in range(10):
        fr.record_span(f"span.{i}", "t", t0 + i * 1e-3, 0.001)
    for i in range(5):
        mod.record_decision("shed", f"reason-{i}", op="fetch",
                            budget_ms=1.5)
    mod.record_hop("push", 0.125)
    path = mod.dump("unit-test", force=True)
    assert path and os.path.basename(path).startswith(
        f"flight-{fr.node}-{fr.pid}-")
    return path


def test_flight_rings_bound_and_dump_format(tmp_path, reflight):
    path = _ring_dump(obs_flight, reflight, tmp_path / "port")
    jpath = _ring_dump(jax_flight, reflight, tmp_path / "jax")
    lines = _dump_lines(path)
    anchor = lines[0]
    assert anchor["ph"] == "M" and anchor["kind"] == "flight"
    assert anchor["run"] == "fl-run" and anchor["reason"] == "unit-test"
    assert "wall" in anchor and "mono" in anchor
    records = lines[1:]
    # the rings kept the newest: 4 spans of 10, 2 decisions of 5
    spans = [r for r in records if r["name"].startswith("span.")]
    assert [r["name"] for r in spans] == [f"span.{i}" for i in (6, 7, 8, 9)]
    decisions = [r for r in records if r["cat"] == "overload"
                 and r["name"] != "net.hop"]
    assert [d["args"]["reason"] for d in decisions] == ["reason-3",
                                                        "reason-4"]
    assert decisions[0]["name"] == "overload.shed"
    assert decisions[0]["args"]["verdict"] == "shed"
    assert decisions[0]["args"]["budget_ms"] == 1.5
    hop = next(r for r in records if r["name"] == "net.hop")
    assert hop["args"] == {"op": "push", "budget_ms": 125.0}
    ts = [r["ts"] for r in records]
    assert ts == sorted(ts)  # time-ordered for the timeline merge
    assert any(r["name"] == "flight.snapshot" for r in records)
    # the JAX recorder dumps the same records in the same order
    assert _records(path) == _records(jpath)


def test_flight_dump_rate_limit_and_force(tmp_path, reflight):
    reflight.setenv("WH_FLIGHT", "1")
    reflight.setenv("WH_FLIGHT_DIR", str(tmp_path))
    reflight.setenv("WH_FLIGHT_MIN_SEC", "60")
    fr = obs_flight.init_from_env()
    fr.record_span("s", "t", time.monotonic(), 0.001)
    suppressed = obs_metrics.REGISTRY.counter("flight.suppressed")
    before = suppressed.value()
    assert fr.dump("first") is not None
    assert fr.dump("storm") is None  # rate-limited
    assert suppressed.value() == before + 1
    assert fr.dump("forced", force=True) is not None
    assert len(os.listdir(tmp_path)) == 2


def _fed(flight, trace, env, out_dir) -> str:
    env.setenv("WH_FLIGHT", "1")
    env.setenv("WH_FLIGHT_DIR", str(out_dir))
    env.delenv("WH_OBS_DIR", raising=False)
    flight.init_from_env()
    assert trace.init_from_env() is None  # no file tracer
    with trace.span("flight.fed.span", cat="t", n=3):
        pass
    trace.event("flight.fed.event", cat="t")
    return flight.dump("feed-test", force=True)


def test_trace_spans_feed_flight_without_file_tracer(tmp_path, reflight):
    """The recorder is a second span sink: spans and events reach it
    with WH_OBS_DIR file tracing off."""
    path = _fed(obs_flight, obs_trace, reflight, tmp_path / "port")
    lines = _dump_lines(path)
    span = next(l for l in lines if l.get("name") == "flight.fed.span")
    assert span["ph"] == "X" and span["args"] == {"n": 3}
    assert span["dur"] >= 0
    assert any(l.get("name") == "flight.fed.event" for l in lines)
    jpath = _fed(jax_flight, jax_trace, reflight, tmp_path / "jax")
    strip = [{k: v for k, v in r.items() if k != "dur"}
             for r in _records(path)]
    assert strip == [{k: v for k, v in r.items() if k != "dur"}
                     for r in _records(jpath)]


# -------------------------------------------------------------- blackbox
def test_blackbox_merges_a_port_and_a_jax_node(tmp_path, reflight):
    """tools/blackbox.py reads the port's dumps as they are, beside a JAX
    node's, and names every decision with its reason."""
    a = obs_flight.FlightRecorder(str(tmp_path), "bb-run", "worker-0")
    b = jax_flight.FlightRecorder(str(tmp_path), "bb-run", "serve-1")
    a.record_span("solver.train_step", "solver", time.monotonic(), 0.01)
    a.record_decision("hedge", "delay quantile elapsed", op="fetch")
    b.record_decision("admit_shed", "inflight 8 >= limit 8", op="fetch")
    b.record_hop("fetch", 0.350)
    pa = a.dump("slo-burn: serve_latency", force=True)
    pb = b.dump("cluster: slo-burn: serve_latency", force=True)
    bb = _load_tool("blackbox")
    paths = bb.flight_paths(str(tmp_path))
    assert paths == sorted([pa, pb])
    merged = bb.merge_dumps(paths)
    names = {e["args"]["name"] for e in merged["traceEvents"]
             if e.get("name") == "process_name"}
    assert names == {f"worker-0/{a.pid}", f"serve-1/{b.pid}"}
    assert any(e["name"] == "overload.admit_shed"
               for e in merged["traceEvents"])
    assert any(e["name"] == "solver.train_step"
               for e in merged["traceEvents"])
    summary = "\n".join(bb.summarize(paths))
    assert "admit_shed" in summary
    assert "inflight 8 >= limit 8" in summary
    assert "hedge" in summary and "delay quantile elapsed" in summary
    assert "slo-burn: serve_latency" in summary


def test_blackbox_tolerates_truncated_and_anchorless_dumps(tmp_path,
                                                           reflight):
    fr = obs_flight.FlightRecorder(str(tmp_path), "bb-run", "worker-0")
    fr.record_decision("shed", "deadline expired in transit", op="push")
    path = fr.dump("fault: net:reset", force=True)
    with open(path, "a") as fh:  # a crash mid-write tears the last line
        fh.write('{"ph":"i","name":"torn","ts":')
    bad = os.path.join(tmp_path, "flight-dead-1-1.jsonl")
    with open(bad, "w") as fh:  # a file that lost its anchor is skipped
        fh.write('{"ph":"i","name":"orphan","ts":1.0}\n')
    bb = _load_tool("blackbox")
    paths = bb.flight_paths(str(tmp_path))
    assert len(paths) == 2
    merged = bb.merge_dumps(paths)
    assert not any(e["name"] == "torn" for e in merged["traceEvents"])
    assert any(e["name"] == "overload.shed" for e in merged["traceEvents"])
    summary = "\n".join(bb.summarize(paths))
    assert "deadline expired in transit" in summary


# ------------------------------------------- scheduler verb + piggyback
def test_scheduler_flight_verb_and_cluster_piggyback(tmp_path, reflight):
    reflight.setenv("WH_FLIGHT", "1")
    reflight.setenv("WH_FLIGHT_DIR", str(tmp_path))
    obs_flight.init_from_env()
    sched = Scheduler(node_timeout=10)
    sched.serve()
    try:
        c = SchedulerClient(sched.uri, "w0")
        got = c.call(op="flight", reason="operator pull")
        assert got["ok"] and got["enabled"]
        assert got["path"] and os.path.exists(got["path"])
        assert got["fgen"] == 1
        assert _dump_lines(got["path"])[0]["reason"] == "operator pull"
        # the client saw the generation move on the reply and dumped its
        # rings too (in one process, so both dumps share a node id)
        dumps = sorted(os.listdir(tmp_path))
        assert len(dumps) == 2
        reasons = {_dump_lines(os.path.join(tmp_path, d))[0]["reason"]
                   for d in dumps}
        assert "cluster: operator pull" in reasons
        c.call(op="epoch")  # an up-to-date client does not dump again
        assert len(os.listdir(tmp_path)) == 2
    finally:
        sched.stop()


def test_scheduler_flight_verb_disabled_is_clean(reflight):
    for k in ("WH_FLIGHT", "WH_FLIGHT_DIR"):
        reflight.delenv(k, raising=False)
    obs_flight.init_from_env()
    sched = Scheduler(node_timeout=10)
    sched.serve()
    try:
        c = SchedulerClient(sched.uri, "w0")
        got = c.call(op="flight", reason="x")
        assert got["ok"] and not got["enabled"]
        assert got["path"] is None and got["fgen"] == 0
        assert "fgen" not in c.call(op="epoch")
    finally:
        sched.stop()


# ------------------------------------------------------------- profiler
def test_pyprof_smoke_samples_roles_and_overhead(tmp_path, reflight):
    reflight.setenv("WH_PROF", "1")
    reflight.setenv("WH_PROF_HZ", "97")
    reflight.setenv("WH_OBS_DIR", str(tmp_path))
    p = obs_pyprof.init_from_env()
    assert p is not None and p._thread.is_alive()
    samples = obs_metrics.REGISTRY.counter("prof.samples")
    before = samples.value()
    stop = threading.Event()

    def spin():
        obs_pyprof.tag_thread("train")
        while not stop.is_set():
            sum(range(500))

    t = threading.Thread(target=spin, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        while samples.value() <= before + 3 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        stop.set()
        t.join()
    assert samples.value() > before + 3
    folded = p.folded()
    assert folded and all(" " in line for line in folded)
    assert any(line.startswith("train;") for line in folded), folded[:5]
    assert p.overhead_frac() < 5 * p.budget
    out = p.stop()
    assert out and os.path.exists(out)
    assert open(out).read().splitlines() == p.folded()
    assert not p._thread.is_alive()
    obs_pyprof.ACTIVE = None  # stopped by hand; no second stop at exit


def test_pyprof_sees_the_solvers_train_and_loader_threads(tmp_path,
                                                          reflight):
    """Under WH_PROF the port's solver tags its main thread `train` and
    its loaders `loader`, so both roles head folded lines; the thread-name
    fallback is off, so the roles come from the tags alone. Each pack
    sleeps 10 ms so the loaders live through many sweeps."""
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    reflight.setenv("WH_PROF", "1")
    reflight.setenv("WH_PROF_HZ", "97")
    reflight.setenv("WH_OBS_DIR", str(tmp_path / "obs"))
    reflight.setattr(obs_pyprof, "_NAME_ROLES", ())
    p = obs_pyprof.init_from_env()
    data = tmp_path / "train.libsvm"
    data.write_text(synth_libsvm_text(n_rows=2048, n_feat=100,
                                      nnz_per_row=8))
    cfg = LinearConfig(train_data=str(data), data_format="libsvm",
                       minibatch=64, num_buckets=1 << 9, nnz_per_row=8,
                       algo="ftrl", max_data_pass=1, max_concurrency=2)
    lrn = LinearLearner(cfg, device="cpu")
    pack = lrn.prepare_batch

    def slow_pack(*a, **kw):
        time.sleep(0.01)
        return pack(*a, **kw)

    lrn.prepare_batch = slow_pack
    MinibatchSolver(lrn, cfg, verbose=False).run()
    folded = p.folded()
    p.stop()
    obs_pyprof.ACTIVE = None
    roles = {line.split(";", 1)[0] for line in folded}
    assert {"train", "loader"} <= roles, sorted(roles)
    assert any(line.startswith("loader;") and "slow_pack" in line
               for line in folded)


# ------------------------------------------------------ train stage table
def _stage_snapshot(mod) -> dict:
    r = mod.Registry()
    stages = {"load": 0.010, "pack": 0.004, "h2d": 0.002, "step": 0.080,
              "sync": 0.009, "metrics": 0.010}
    for name, v in stages.items():
        for _ in range(8):
            r.histogram(f"train.stage.{name}_s").observe(v)
    for _ in range(8):
        r.histogram("train.stage.total_s").observe(0.100)
    return r.snapshot()


def test_train_stage_table_contract():
    snap = _stage_snapshot(obs_metrics)
    assert snap == _stage_snapshot(jax_metrics)
    table = obs_report.train_stage_table(snap)
    assert table == jax_report.train_stage_table(snap)
    assert set(table["stages"]) == {"load", "pack", "h2d", "step", "sync",
                                    "metrics"}
    assert table["stages"]["step"]["p50_ms"] == pytest.approx(80.0)
    assert table["stages"]["step"]["count"] == 8
    assert table["total_p50_ms"] == pytest.approx(100.0)
    # explained = load + step + metrics of a 100 ms batch
    assert table["explained_p50_ms"] == pytest.approx(100.0)
    assert table["explained_frac"] >= 0.9
    assert obs_report.train_stage_table({"hists": {}}) == {}
    report = obs_report.build(snap)
    assert report["train_stages"]["explained_frac"] >= 0.9
    txt = obs_report.format_lines(report)
    assert txt == jax_report.format_lines(jax_report.build(snap))
    assert "train stages (p50 ms)" in "\n".join(txt)
    assert "explained by load+step+metrics" in "\n".join(txt)
    empty = obs_report.build(obs_metrics.Registry().snapshot())
    assert "train_stages" not in empty
