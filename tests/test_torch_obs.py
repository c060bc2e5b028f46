"""The port's telemetry (wormhole_tpu_torch/obs) against the JAX
package's (tests/test_obs.py's cases over the port): the metrics
registry under thread contention and its snapshots and merges, the trace
JSONL through tools/trace_viewer.py, the scheduler's metrics verb, the
run report, the Progress row race, the solver's obs hooks over a linear
job, and the import that pulls no obs module.

Each case feeds the same observations, spans and snapshots to both
packages' modules. Tolerance: none. Snapshots, merges, reports and trace
records are compared exactly, apart from the clock fields (``ts``,
``dur``, ``wall``, ``mono``, ``generated_unix``) that no two runs share.
The solver's spans, report keys, counter names and train.stage.* counts
are compared exactly between the two packages' solvers, each run in a
process of its own (tests/torch_obs_solver_run.py): both packages' tracers
start at their import, and each registry is process-wide."""

import importlib.util
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from wormhole_tpu.obs import metrics as jax_metrics
from wormhole_tpu.obs import report as jax_report
from wormhole_tpu.obs import trace as jax_trace
from wormhole_tpu_torch.obs import metrics as obs_metrics
from wormhole_tpu_torch.obs import pyprof as obs_pyprof
from wormhole_tpu_torch.obs import report as obs_report
from wormhole_tpu_torch.obs import trace as obs_trace
from wormhole_tpu_torch.runtime.tracker import Scheduler, SchedulerClient
from wormhole_tpu_torch.solver.progress import Progress

from conftest import synth_libsvm_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK = ("ts", "dur", "wall", "mono", "generated_unix")

# the counters of one registry that the other lacks (the port's
# obs/names.py; tests/test_torch_obs_names.py holds the whole registry)
JAX_ONLY = {"kv.gather_rows", "kv.scatter_rows", "kv.jit_cache_misses"}
PORT_ONLY = {"kvstore.d2h_copies", "kvstore.h2d_copies"}


@pytest.fixture
def retrace(monkeypatch):
    """Re-init both packages' tracing around a test and make sure both
    end disabled (each module inits from the env at import)."""
    yield monkeypatch
    monkeypatch.delenv("WH_OBS_DIR", raising=False)
    for mod in (obs_trace, jax_trace):
        mod.init_from_env()
        assert mod.ACTIVE is None


def _unclocked(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in CLOCK}


def _load_trace_viewer():
    spec = importlib.util.spec_from_file_location(
        "trace_viewer", os.path.join(REPO, "tools", "trace_viewer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------- instruments
def _hammer(fn, threads=8, iters=2000):
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait()
        for i in range(iters):
            fn(i)

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return threads * iters


@pytest.mark.parametrize("mod", [obs_metrics, jax_metrics],
                         ids=["port", "jax"])
def test_counter_and_gauge_under_contention(mod):
    c = mod.Counter("t.contended_counter")
    g = mod.Gauge("t.contended_gauge")
    n = _hammer(lambda i: (c.inc(), g.set(i)))
    assert c.value() == n
    assert 0 <= g.value() <= 1999  # a value some thread set


def test_histogram_under_contention_as_the_jax_one():
    got = {}
    for name, mod in (("port", obs_metrics), ("jax", jax_metrics)):
        h = mod.Histogram("t.contended_hist", reservoir=64)
        n = _hammer(lambda i: h.observe(i), threads=8, iters=2000)
        snap = h.snapshot()
        assert h.count == snap["count"] == n
        assert len(snap["res"]) == 64  # bounded however many observed
        assert all(0.0 <= v <= 1999.0 for v in snap["res"])
        assert 0.0 <= h.quantile(0.5) <= 1999.0
        got[name] = {k: snap[k] for k in ("count", "sum", "min", "max")}
    assert got["port"] == got["jax"]


def test_histogram_snapshots_and_quantiles_equal_the_jax_ones():
    """Single-threaded, the reservoir is deterministic: the same
    observations give the JAX histogram's snapshot and quantiles."""
    vals = [float(v) for v in range(100)] + [0.5 * v for v in range(3000)]
    hs = {"port": obs_metrics.Histogram("t.small_hist"),
          "jax": jax_metrics.Histogram("t.small_hist")}
    for h in hs.values():
        for v in vals[:100]:
            h.observe(v)
    assert hs["port"].quantile(0.0) == 0.0
    assert hs["port"].quantile(0.5) == 50.0
    assert hs["port"].quantile(1.0) == 99.0
    for h in hs.values():
        for v in vals[100:]:
            h.observe(v)
    assert hs["port"].snapshot() == hs["jax"].snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert hs["port"].quantile(q) == hs["jax"].quantile(q)


def _fill(mod):
    r = mod.Registry()
    assert r.counter("a") is r.counter("a")
    assert r.histogram("h") is r.histogram("h")
    r.counter("a").inc(3)
    r.gauge("g").set(7)
    with r.timer("h"):
        pass
    return r


def test_registry_get_or_create_and_reset():
    snaps = {}
    for name, mod in (("port", obs_metrics), ("jax", jax_metrics)):
        r = _fill(mod)
        snap = r.snapshot()
        assert snap["counters"]["a"] == 3
        assert snap["gauges"]["g"] == 7.0
        assert snap["hists"]["h"]["count"] == 1
        snaps[name] = snap
        r.reset()
        assert r.snapshot() == {"counters": {}, "gauges": {}, "hists": {}}
    for snap in snaps.values():  # the timer's reading is a clock field
        snap["hists"]["h"] = {k: v for k, v in snap["hists"]["h"].items()
                              if k == "count"}
    assert snaps["port"] == snaps["jax"]


def _pair(mod):
    a, b = mod.Registry(), mod.Registry()
    a.counter("pushes").inc(10)
    b.counter("pushes").inc(5)
    b.counter("pulls").inc(2)
    a.gauge("epoch").set(1)
    b.gauge("epoch").set(3)
    for v in (0.1, 0.2):
        a.histogram("lat").observe(v)
    for v in (0.4, 0.8, 1.6):
        b.histogram("lat").observe(v)
    big = mod.Registry()
    for v in range(1000):
        big.histogram("lat").observe(float(v))
    return a.snapshot(), b.snapshot(), big.snapshot()


def test_merge_snapshots_as_the_jax_merge():
    pa, pb, pbig = _pair(obs_metrics)
    ja, jb, jbig = _pair(jax_metrics)
    assert (pa, pb, pbig) == (ja, jb, jbig)
    m = obs_metrics.merge_snapshots([pa, pb])
    assert m["counters"] == {"pushes": 15, "pulls": 2}
    assert m["gauges"]["epoch"] == 3.0  # max: the furthest-along node
    lat = m["hists"]["lat"]
    assert lat["count"] == 5
    assert lat["sum"] == pytest.approx(3.1)
    assert lat["min"] == 0.1 and lat["max"] == 1.6
    assert sorted(lat["res"]) == [0.1, 0.2, 0.4, 0.8, 1.6]
    stats = obs_metrics.hist_stats(lat)
    assert stats["mean"] == pytest.approx(3.1 / 5)
    assert stats["p99"] == 1.6
    assert stats == jax_metrics.hist_stats(lat)
    m2 = obs_metrics.merge_snapshots([m, pbig], reservoir=128)
    assert m2["hists"]["lat"]["count"] == 1005
    assert len(m2["hists"]["lat"]["res"]) == 128  # pooling stays bounded
    jm = jax_metrics.merge_snapshots([ja, jb])
    assert m == jm
    assert m2 == jax_metrics.merge_snapshots([jm, jbig], reservoir=128)
    # a port node's snapshot merges with a JAX node's
    assert obs_metrics.merge_snapshots([pa, jb]) == m


# ----------------------------------------------------------------- trace
def _emit(mod, env, tmp_path, sub: str):
    """The same spans and events through one package's tracer; returns
    its file's records."""
    env.setenv("WH_OBS_DIR", str(tmp_path / sub))
    tracer = mod.init_from_env()
    assert tracer is not None and mod.ACTIVE is tracer
    with mod.span("step", cat="solver", part=3):
        pass
    mod.event("recovered", cat="recovery", rank=1)
    with pytest.raises(ValueError):
        with mod.span("boom", cat="solver"):
            raise ValueError("x")  # the span records, not swallows
    tracer.close()
    assert os.path.basename(tracer.path).startswith("trace-")
    return tracer.path, [json.loads(l) for l in open(tracer.path)]


def test_trace_jsonl_roundtrip_through_viewer(tmp_path, retrace):
    retrace.setenv("WH_RUN_ID", "test-run")
    path, lines = _emit(obs_trace, retrace, tmp_path, "port")
    jpath, jlines = _emit(jax_trace, retrace, tmp_path, "jax")
    assert [_unclocked(l) for l in lines] == [_unclocked(l) for l in jlines]
    anchor = lines[0]
    assert anchor["ph"] == "M" and anchor["run"] == "test-run"
    assert {"wall", "mono", "node", "pid"} <= set(anchor)
    assert [l["ph"] for l in lines[1:]] == ["X", "i", "X"]
    assert lines[1]["name"] == "step" and lines[1]["args"]["part"] == 3
    assert lines[2]["args"]["rank"] == 1
    assert lines[3]["args"]["error"] == "ValueError"

    tv = _load_trace_viewer()
    evs = tv.merge_traces([path])["traceEvents"]
    assert {"process_name", "step", "recovered", "boom"} <= {
        e["name"] for e in evs}
    step = next(e for e in evs if e["name"] == "step")
    assert step["ph"] == "X" and step["ts"] >= 0 and step["dur"] >= 0
    inst = next(e for e in evs if e["name"] == "recovered")
    assert inst["ph"] == "i" and inst["s"] == "t"
    assert tv.merge_traces([path])["metadata"]["run_ids"] == ["test-run"]
    jevs = tv.merge_traces([jpath])["traceEvents"]
    assert [(e["name"], e["ph"]) for e in evs] == [
        (e["name"], e["ph"]) for e in jevs]
    # the viewer's CLI over the port's directory writes valid JSON
    out = tmp_path / "out.json"
    assert tv.main([str(tmp_path / "port"), "-o", str(out)]) == 0
    assert json.load(open(out))["traceEvents"]


def test_trace_viewer_merges_a_port_and_a_jax_node_on_one_axis(tmp_path):
    """A port node's file and a JAX node's, whose monotonic clocks
    disagree but whose anchors pin the same wall instant, line up."""
    anchors = {}
    for mod, node, mono0 in ((obs_trace, "worker-0", 5.0),
                             (jax_trace, "server-0", 900.0)):
        tr = mod.Tracer(str(tmp_path), "r", node)
        tr.close()
        anchors[node] = json.loads(open(tr.path).readline())
        with open(tr.path, "w") as fh:
            fh.write(json.dumps(dict(anchors[node], wall=1000.0,
                                     mono=mono0)) + "\n")
            fh.write(json.dumps({"ph": "X", "name": "op", "cat": "c",
                                 "ts": mono0 + 0.5, "dur": 0.1,
                                 "tid": 0}) + "\n")
    assert _unclocked(anchors["worker-0"]).keys() == _unclocked(
        anchors["server-0"]).keys()
    tv = _load_trace_viewer()
    evs = tv.merge_traces(sorted(str(tmp_path / f)
                                 for f in os.listdir(tmp_path)))
    spans = [e for e in evs["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == 2
    assert spans[0]["ts"] == pytest.approx(spans[1]["ts"], abs=1.0)
    pids = {e["pid"] for e in spans}
    named = {e["pid"] for e in evs["traceEvents"]
             if e.get("name") == "process_name"}
    assert len(pids) == 2 and pids <= named


def test_trace_disabled_is_noop(retrace):
    retrace.delenv("WH_OBS_DIR", raising=False)
    assert obs_trace.init_from_env() is None
    s1 = obs_trace.span("a", x=1)
    assert s1 is obs_trace.span("b")  # one null object: no allocation
    with s1:
        pass
    obs_trace.event("nothing")


# ------------------------------------------------- scheduler aggregation
def test_scheduler_metrics_verb_aggregates_nodes():
    sched = Scheduler(node_timeout=10)
    sched.serve()
    try:
        def snap(pushes, epoch, lat):
            r = obs_metrics.Registry()
            r.counter("t.sched_agg.pushes").inc(pushes)
            r.gauge("t.sched_agg.epoch").set(epoch)
            for v in lat:
                r.histogram("t.sched_agg.lat").observe(v)
            return r.snapshot()

        w0 = SchedulerClient(sched.uri, "worker-0")
        w1 = SchedulerClient(sched.uri, "worker-1")
        s0, s1 = snap(7, 1, [0.1]), snap(5, 2, [0.3, 0.5])
        w0.call(op="epoch", metrics=s0)
        w1.call(op="epoch", metrics=s1)
        got = w0.call(op="metrics")
        assert got["ok"]
        assert got["nodes"] == ["worker-0", "worker-1"]
        agg = got["aggregate"]
        assert agg["counters"]["t.sched_agg.pushes"] == 12
        assert agg["gauges"]["t.sched_agg.epoch"] == 2.0
        assert agg["hists"]["t.sched_agg.lat"]["count"] == 3
        assert agg["hists"]["sched.op.epoch_s"]["count"] >= 2
        # the nodes' part of the aggregate is the JAX merge of theirs
        want = jax_metrics.merge_snapshots([s0, s1])
        for kind in ("counters", "gauges"):
            for k, v in want[kind].items():
                assert agg[kind][k] == v
        lat = agg["hists"]["t.sched_agg.lat"]
        assert sorted(lat["res"]) == sorted(
            want["hists"]["t.sched_agg.lat"]["res"])
        # a later snapshot of the same node replaces its old one
        w0.call(op="epoch", metrics=snap(9, 1, []))
        agg = w0.call(op="metrics")["aggregate"]
        assert agg["counters"]["t.sched_agg.pushes"] == 14
    finally:
        sched.stop()


def _report_registry(mod):
    r = mod.Registry()
    r.counter("ps.client.bytes_push").inc(111)
    r.counter("ps.client.replays").inc(4)
    r.counter("ps.client.replay_dedup").inc(4)
    for v in (0.002, 0.004):
        r.histogram("ps.client.rpc_s").observe(v)
    for name, v in (("load", 0.01), ("step", 0.08), ("metrics", 0.01),
                    ("total", 0.1)):
        for _ in range(8):
            r.histogram(f"train.stage.{name}_s").observe(v)
    return r.snapshot()


def test_report_build_and_write_as_the_jax_report(tmp_path, retrace):
    kw = dict(nodes=["worker-0", "scheduler"], run_id="rid",
              ps_stats={0: {"num_push": 10, "num_pull": 20}})
    report = obs_report.build(_report_registry(obs_metrics), **kw)
    jreport = jax_report.build(_report_registry(jax_metrics), **kw)
    assert _unclocked(report) == _unclocked(jreport)
    assert obs_report.format_lines(report) == jax_report.format_lines(
        jreport)
    s = report["summary"]
    assert s["num_push"] == 10 and s["num_pull"] == 20  # stats() wins
    assert s["bytes_pushed"] == 111
    assert s["journal_replays"] == 4 and s["replay_dedup_hits"] == 4
    assert s["rpc_p99_ms"] == pytest.approx(4.0)
    assert report["nodes"] == ["scheduler", "worker-0"]
    assert report["train_stages"]["explained_frac"] >= 0.9
    line = obs_report.machine_line(report)
    assert line.startswith(obs_report.REPORT_PREFIX)
    assert json.loads(line[len(obs_report.REPORT_PREFIX):]) == json.loads(
        json.dumps(report, default=str))
    retrace.setenv("WH_OBS_DIR", str(tmp_path))
    path = obs_report.write(report)
    assert path == str(tmp_path / "run_report.json")
    assert json.load(open(path))["summary"]["num_push"] == 10


# ------------------------------------------------- progress row race fix
def test_progress_row_snapshot_consistent_under_merge():
    """Totals in a row snapshot are exactly the sum of the increments
    handed out so far, while other threads merge."""
    prog = Progress()
    stop = threading.Event()

    def merger():
        while not stop.is_set():
            prog.merge({"nex": 1.0})

    ts = [threading.Thread(target=merger) for _ in range(4)]
    for t in ts:
        t.start()
    try:
        seen = 0.0
        for _ in range(300):
            inc, tot = prog.take_row_snapshot()
            seen += inc.get("nex", 0.0)
            assert seen == tot.get("nex", 0.0)
    finally:
        stop.set()
        for t in ts:
            t.join()
    inc, tot = prog.take_row_snapshot()
    assert seen + inc.get("nex", 0.0) == tot.get("nex", 0.0)
    assert prog.row(0.0)


# ------------------------------------------------------ end-to-end smoke
# explained_frac is the stages' p50s summed over the p50 of their sum:
# it reaches 1 where one stage takes every batch's stalls. On a loaded
# worker, while the loaders still parse, a stall of the interpreter lands
# in one batch's queue wait or in the next one's step, so the sum falls
# short (0.67 in a run of the whole suite, six workers). A queue that
# holds the whole pass lets the loaders finish early, and the stalls then
# fall in the steps alone; 64 batches steady the p50s.
SMOKE_ROWS, SMOKE_MINIBATCH = 4096, 64


def test_obs_smoke_linear_job(tmp_path, retrace):
    """tests/test_obs.py's smoke over the port's solver: an in-process
    linear run with WH_OBS_DIR set writes the run report and one trace
    file with the solver's pass and step spans."""
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    data = tmp_path / "train.libsvm"
    data.write_text(synth_libsvm_text(n_rows=SMOKE_ROWS, n_feat=100,
                                      nnz_per_row=8))
    obs_dir = tmp_path / "obs"
    retrace.setenv("WH_OBS_DIR", str(obs_dir))
    retrace.setenv("WH_RUN_ID", "smoke-run")
    retrace.delenv("WH_ROLE", raising=False)
    obs_trace.init_from_env()
    # the registry is the process's: the stage table reads this pass
    # alone, not the passes of the tests before it in this process
    for k in ("load", "pack", "h2d", "step", "metrics", "total"):
        obs_metrics.REGISTRY.histogram(f"train.stage.{k}_s").reset()
    cfg = LinearConfig(train_data=str(data), data_format="libsvm",
                       minibatch=SMOKE_MINIBATCH, num_buckets=1 << 9,
                       nnz_per_row=8, algo="ftrl", max_data_pass=1)
    lrn = LinearLearner(cfg, device="cpu")
    sol = MinibatchSolver(lrn, cfg, verbose=False)
    sol.MAX_QUEUED = SMOKE_ROWS // SMOKE_MINIBATCH
    sol.run()
    obs_trace.ACTIVE.close()

    report = json.load(open(obs_dir / "run_report.json"))
    assert report["run_id"] == "smoke-run"
    assert set(report) >= {"summary", "counters", "gauges", "hists",
                           "nodes"}
    assert any(k.startswith("perf.") for k in report["hists"])
    tstages = report["train_stages"]
    assert {"load", "step", "metrics"} <= set(tstages["stages"])
    assert tstages["explained_frac"] >= 0.9
    traces = [f for f in os.listdir(obs_dir)
              if f.startswith("trace-") and f.endswith(".jsonl")]
    assert len(traces) == 1
    lines = [json.loads(l) for l in open(obs_dir / traces[0])]
    assert lines[0]["ph"] == "M" and lines[0]["run"] == "smoke-run"
    spans = [l for l in lines if l.get("ph") == "X"]
    # a span a step: the parts' last batches may be short, so a pass
    # takes at least rows / minibatch steps
    steps = sol.perf.count("train_step")
    assert steps >= SMOKE_ROWS // SMOKE_MINIBATCH
    assert report["hists"]["train.stage.step_s"]["count"] == steps
    assert [l["name"] for l in spans].count("solver.train_step") == steps
    passes = [l for l in spans if l["name"] == "solver.train_pass"]
    assert len(passes) == 1 and passes[0]["args"] == {"data_pass": 0}
    tv = _load_trace_viewer()
    assert tv.merge_traces([str(obs_dir / traces[0])])["traceEvents"]


def test_solver_obs_output_equals_the_jax_solvers(tmp_path):
    """One libsvm file through each package's MinibatchSolver under
    WH_OBS_DIR, each in a process of its own: the same span names with
    the same counts, the same report keys, the same counter names (less
    the registries' documented differences) and the same train.stage.*
    counts."""
    data = tmp_path / "train.libsvm"
    data.write_text(synth_libsvm_text(n_rows=256, n_feat=100,
                                      nnz_per_row=8))
    procs = {}
    for pkg in ("wormhole_tpu", "wormhole_tpu_torch"):
        obs_dir = tmp_path / pkg
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("WH_", "WORMHOLE_PROFILE"))}
        env.update(WH_OBS_DIR=str(obs_dir), WH_RUN_ID="parity",
                   JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        procs[pkg] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_obs_solver_run.py"),
             pkg, str(data), str(obs_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO)
    got = {}
    for pkg, p in procs.items():
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        got[pkg] = json.loads(out.strip().splitlines()[-1])
    jax, port = got["wormhole_tpu"], got["wormhole_tpu_torch"]
    assert port["traces"] == jax["traces"] == 1
    assert port["spans"] == jax["spans"] == {"solver.train_pass": 1,
                                             "solver.train_step": 4}
    assert port["report_keys"] == jax["report_keys"]
    assert "train_stages" in port["report_keys"]
    assert set(port["counters"]) - PORT_ONLY == set(jax["counters"]) - JAX_ONLY
    assert port["stage_counts"] == jax["stage_counts"]
    assert port["stage_counts"]["train.stage.step_s"] == 4


def test_solver_with_every_knob_off_costs_nothing(tmp_path, monkeypatch):
    """With every obs knob off the solver's hooks are the shared null
    span, no sampler thread starts, no torch.profiler session opens and
    no report is written."""
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver import minibatch_solver as ms

    for k in ("WH_OBS_DIR", "WH_FLIGHT", "WH_PROF", "WORMHOLE_PROFILE_DIR"):
        monkeypatch.delenv(k, raising=False)
    assert ms._trace.init_from_env() is None
    assert ms._pyprof.init_from_env() is None
    assert ms._pyprof._flight.init_from_env() is None

    def no_profiler(*a, **kw):
        raise AssertionError("a torch.profiler session was opened")

    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    spans = []
    real_span = ms._trace.span

    def kept_span(*a, **kw):
        spans.append(real_span(*a, **kw))
        return spans[-1]

    monkeypatch.setattr(ms._trace, "span", kept_span)
    data = tmp_path / "train.libsvm"
    data.write_text(synth_libsvm_text(n_rows=256, n_feat=100,
                                      nnz_per_row=8))
    cfg = LinearConfig(train_data=str(data), data_format="libsvm",
                       minibatch=64, num_buckets=1 << 9, nnz_per_row=8,
                       algo="ftrl", max_data_pass=1)
    ms.MinibatchSolver(LinearLearner(cfg, device="cpu"), cfg,
                       verbose=False).run()
    assert len(spans) == 5 and all(s is spans[0] for s in spans)
    assert obs_pyprof.ACTIVE is None
    assert not [t for t in threading.enumerate() if t.name == "wh-pyprof"]
    assert not list(tmp_path.glob("**/run_report.json"))


def test_package_import_pulls_no_obs():
    """`import wormhole_tpu_torch` with telemetry off imports no
    wormhole_tpu_torch.obs module."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WH_OBS_DIR", "WH_SAN")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; import wormhole_tpu_torch; "
         "mods = [m for m in sys.modules "
         "if m.startswith('wormhole_tpu_torch.obs')]; "
         "assert not mods, mods; print('clean')"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean" in r.stdout
