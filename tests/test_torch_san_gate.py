"""The port's sanitizer gate: its threaded planes run WH_SAN-clean.

The dynamic twin of tests/test_torch_lint_gate.py, as
tests/test_san_gate.py is the JAX package's. Each of the port's
threaded workloads (tests/torch_san_workloads.py) and the port-only
launches of tests/test_torch_ps_launch.py and
tests/test_torch_bsp_launch.py run in processes that import the port and
nothing of the JAX package, with WH_SAN=1 and a dump dir. The gate holds
zero findings in the dumps (no lock-order inversion, no blocking call
under a registry-known lock, no candidate lockset race), and each
process shows it was armed: a workload by its ``san.*`` counters and the
model classes it instrumented, a launch by the ``san.order.edges`` of its
run_report.json and by every process's ``[wormsan] exit`` line (the
launcher prefixes each role's), every role with lock-order edges above
zero and model classes instrumented. A seeded race in
a port class, run the same way, is found: the gate is not vacuous.
Anything benign by design is annotated ``# wormsan: allow=<detector>``
at its site.
"""

import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOADS = os.path.join(REPO, "tests", "torch_san_workloads.py")
TIMEOUT = 150


def _env(dump, extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("WH_") and k != "JAX_PLATFORMS"}
    env.update({"PYTHONPATH": REPO, "WH_SAN": "1",
                "WH_SAN_DUMP_DIR": str(dump)})
    env.update(extra or {})
    return env


def _run(argv, env):
    p = subprocess.Popen(argv, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=REPO, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        pytest.fail(f"timed out after {TIMEOUT}s:\n{out[-3000:]}")
    assert p.returncode == 0, out[-4000:]
    return out


def _findings(dump):
    out = []
    if dump.is_dir():
        for path in sorted(dump.glob("san-*.jsonl")):
            out += [json.loads(x) for x in path.read_text().splitlines()
                    if x.strip()]
    return out


def _clean(dump):
    fs = _findings(dump)
    assert fs == [], "\n".join(f"[{f['detector']}] {f['message']}"
                               for f in fs)


def _workload(name, tmp_path):
    dump = tmp_path / "san"
    out = _run([sys.executable, WORKLOADS, name, str(tmp_path)], _env(dump))
    res = json.loads(next(ln for ln in reversed(out.splitlines())
                          if ln.startswith('{"workload"')))
    assert res["armed"], out[-2000:]
    # the sanitizer's exit line agrees with what the workload read
    ex = json.loads(re.findall(r"^\[wormsan\] exit (\{.*\})$", out,
                               re.M)[-1])
    assert ex["findings"] == len(res["findings"])
    assert ex["instrumented"] == len(res["instrumented"])
    return res, dump


@pytest.mark.parametrize("name", ["obs", "overload", "serve", "async_sync",
                                  "solver"])
def test_threaded_workload_is_san_clean(name, tmp_path):
    res, dump = _workload(name, tmp_path)
    _clean(dump)
    assert res["findings"] == []
    assert res["counters"].get("san.order.edges", 0) > 0, res
    assert "wormhole_tpu_torch.obs.metrics:Registry" in res["instrumented"]
    want = {"serve": "wormhole_tpu_torch.serving.router:Router",
            "async_sync": "wormhole_tpu_torch.runtime.ps_server:PSClient",
            "solver": "wormhole_tpu_torch.solver.progress:Progress"}
    if name in want:
        assert want[name] in res["instrumented"]


def test_the_gate_finds_a_seeded_race(tmp_path):
    res, dump = _workload("seeded_race", tmp_path)
    assert res["findings"] == ["race:Progress.tot"]
    assert res["counters"]["san.race.candidates"] == 1
    fs = _findings(dump)
    assert [f["key"] for f in fs] == ["race:Progress.tot"]
    assert "the seeded bug" in fs[0]["stacks"]["write"]


# --- the port-only launches ---------------------------------------------------

def _synth(path, n_rows, seed, n_feat=1000, nnz=8, valued=False):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(1234).normal(size=n_feat)
    lines = []
    for _ in range(n_rows):
        idx = np.sort(rng.choice(n_feat, size=nnz, replace=False))
        val = (rng.random(nnz) + 0.5 if valued else np.ones(nnz))
        y = int(float((w[idx] * val).sum()) > 0)
        lines.append(f"{y} " + " ".join(
            f"{i}:{v:.4f}" for i, v in zip(idx, val)))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("sang")
    for i in range(2):
        _synth(d / f"train-{i}.libsvm", 256, seed=i)
    _synth(d / "val.libsvm", 256, seed=9)
    for i in range(3):
        _synth(d / f"gb-{i}.libsvm", 200, seed=i, n_feat=60, valued=True)
    _synth(d / "gbval.libsvm", 120, seed=9, n_feat=60, valued=True)
    return d


LINEAR = """algo = ftrl
lambda_l1 = 1
lr_eta = 0.2
minibatch = 128
num_buckets = 16384
max_data_pass = 2
max_delay = 1
print_sec = 3600
"""
DIFACTO = """algo = ftrl
dim = 4
threshold = 2
lambda_l1 = 0.5
minibatch = 256
num_buckets = 16384
v_buckets = 4096
max_data_pass = 2
max_delay = 1
print_sec = 3600
"""


def _launch(tmp_path, n, s, app, args, env_extra=None, launcher_args=()):
    dump, obs = tmp_path / "san", tmp_path / "obs"
    cmd = [sys.executable, "-m", "wormhole_tpu_torch.launcher.dmlc_tpu",
           "-n", str(n), "-s", str(s), *launcher_args, "--",
           sys.executable, "-m", f"wormhole_tpu_torch.apps.{app}", *args,
           "device=cpu"]
    out = _run(cmd, _env(dump, dict(env_extra or {},
                                    WH_OBS_DIR=str(obs))))
    _clean(dump)
    # every process's exit line, by the role prefix the launcher gives
    # its lines: the scheduler's, each server's and worker's (a killed
    # worker's respawn prints its own), and the launcher's own, bare
    exits = {}
    for role, rec in re.findall(
            r"^(?:\[([\w-]+)\] )?\[wormsan\] exit (\{.*\})$", out, re.M):
        exits.setdefault(role or "launcher", []).append(json.loads(rec))
    assert "launcher" in exits, out[-3000:]
    assert all(e["findings"] == 0 and e["instrumented"] > 0
               for es in exits.values() for e in es), exits
    report = json.loads((obs / "run_report.json").read_text())
    assert report["counters"].get("san.order.edges", 0) > 0
    return out, exits


def _every_role_armed(exits, workers, servers):
    want = {"launcher", "scheduler", *(f"worker-{r}" for r in range(workers)),
            *(f"server-{r}" for r in range(servers))}
    assert set(exits) == want, exits
    for role, es in exits.items():
        if role != "launcher":  # it takes no lock twice in a row
            assert all(e["edges"] > 0 for e in es), (role, exits)


def test_n2_s1_linear_launch_is_san_clean(data, tmp_path):
    conf = tmp_path / "n2.conf"
    conf.write_text(LINEAR + f"train_data = {data}/train-.*\n"
                    f"val_data = {data}/val.libsvm\n"
                    f"model_out = {tmp_path}/model\n")
    out, exits = _launch(tmp_path, 2, 1, "linear", [str(conf)])
    assert re.search(r"final val: logloss=", out)
    assert "[ps server 0] cuda context: none" in out
    assert "[scheduler] cuda context: none" in out
    _every_role_armed(exits, workers=2, servers=1)


def test_n2_s2_difacto_launch_is_san_clean(data, tmp_path):
    conf = tmp_path / "fm.conf"
    conf.write_text(DIFACTO + f"train_data = {data}/train-.*\n"
                    f"val_data = {data}/val.libsvm\n"
                    f"model_out = {tmp_path}/fm_model\n")
    out, exits = _launch(tmp_path, 2, 2, "difacto", [str(conf)],
                         env_extra={"WH_ASYNC_SYNC": "1"})
    assert re.search(r"final val: logloss=", out)
    _every_role_armed(exits, workers=2, servers=2)


def test_gbdt_bsp_kill_launch_is_san_clean(data, tmp_path):
    args = [f"train_data={data}/gb-.*", f"eval_data={data}/gbval.libsvm",
            "num_round=3", "max_depth=3", "max_bin=16", "minibatch=128",
            f"model_out={tmp_path}/gbdt.npz", "bsp=1"]
    out, exits = _launch(
        tmp_path, 3, 0, "gbdt", args,
        env_extra={"WH_FAULT_SPEC": "worker:1:kill@allreduce:6"},
        launcher_args=("--node-timeout", "10", "--max-worker-restarts",
                       "1"))
    assert "respawning with restore epoch 1" in out
    assert "[scheduler] cuda context: none" in out
    _every_role_armed(exits, workers=3, servers=0)
