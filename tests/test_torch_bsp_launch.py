"""The BSP allreduce plane through the launchers on the CPU:
`python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 3 -s 0 -- python -m
wormhole_tpu_torch.apps.{gbdt,lbfgs_linear} ... bsp=1 device=cpu`
against the JAX package's launcher on the same files, and the port's
kill launch against its fault-free launch.

Each launch runs in a session of its own under its own timeout, and the
whole process group is killed when it runs out. Bars: GBDT's edges and
tree structure equal to the JAX launch's and its leaves within atol
1e-5; a launch whose worker 1 is killed at its 6th allreduce (the first
histogram of round 1 at max_depth=3, tools/chaos_lab.py:159-165) and
respawned saves the fault-free launch's model bit for bit (on the CPU
every sum is the plain version's, in the ring's fixed order); L-BFGS's
objective history within rtol 1e-4 of the JAX launch's over the first 8
iterations (the bar of tests/test_torch_lbfgs.py)."""

import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 150


def run_group(argv, env_extra=None, timeout=LAUNCH_TIMEOUT):
    """Run a launch in a session of its own; on timeout kill the whole
    process group (the launcher's role processes with it) and fail."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for k in ("WH_FAULT_SPEC", "WH_OBS_DIR", "WH_WIRE"):
        env.pop(k, None)
    env.update(env_extra or {})
    p = subprocess.Popen(argv, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=REPO, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        pytest.fail(f"launch timed out after {timeout}s:\n{out[-3000:]}")
    assert p.returncode == 0, out[-4000:]
    return out


def launch(pkg, app, *args, env_extra=None):
    cmd = [sys.executable, "-m", f"{pkg}.launcher.dmlc_tpu", "-n", "3",
           "-s", "0", "--node-timeout", "10", "--max-worker-restarts", "1",
           "--", sys.executable, "-m", f"{pkg}.apps.{app}", *args, "bsp=1"]
    if pkg == "wormhole_tpu_torch":
        cmd.append("device=cpu")
    return run_group(cmd, env_extra)


def _synth(path, n_rows, seed, n_feat=60, nnz=8):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(1234).normal(size=n_feat)
    lines = []
    for _ in range(n_rows):
        idx = rng.choice(n_feat, size=nnz, replace=False)
        val = rng.random(nnz).astype(np.float32) + 0.5
        y = 1 if float((w[idx] * val).sum()) + rng.normal(scale=0.3) > 0 \
            else 0
        lines.append(f"{y} " + " ".join(
            f"{i}:{v:.4f}" for i, v in zip(idx, val)))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("bspl")
    for i in range(3):
        _synth(d / f"train-{i}.libsvm", 200, seed=i)
    _synth(d / "val.libsvm", 120, seed=9)
    return d


def gbdt_args(d, model):
    return [f"train_data={d}/train-.*", f"eval_data={d}/val.libsvm",
            "num_round=3", "max_depth=3", "max_bin=16", "minibatch=128",
            f"model_out={model}"]


def test_gbdt_bsp_launch_matches_the_jax_launch(data, tmp_path):
    port_m, jax_m = tmp_path / "port.npz", tmp_path / "jax.npz"
    out = launch("wormhole_tpu_torch", "gbdt", *gbdt_args(data, port_m))
    launch("wormhole_tpu", "gbdt", *gbdt_args(data, jax_m))
    assert "[scheduler] cuda context: none" in out
    assert len(re.findall(r"\[bsp-worker\] ", out)) == 3
    a, b = np.load(port_m), np.load(jax_m)
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(a["edges"], b["edges"])
    for k in ("split_feat", "split_bin", "is_split", "num_round", "dim"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["leaf_value"], b["leaf_value"], atol=1e-5)


def test_gbdt_kill_launch_equals_fault_free_bit_for_bit(data, tmp_path):
    base, kill = tmp_path / "base.npz", tmp_path / "kill.npz"
    launch("wormhole_tpu_torch", "gbdt", *gbdt_args(data, base))
    out = launch("wormhole_tpu_torch", "gbdt", *gbdt_args(data, kill),
                 env_extra={"WH_FAULT_SPEC": "worker:1:kill@allreduce:6",
                            "WH_OBS_DIR": str(tmp_path / "obs")})
    assert "respawning with restore epoch 1" in out
    assert "[gbdt-bsp] rank 1 resuming at round 1" in out
    # the kill lands on round 1's first collective, right after the
    # round-0 checkpoint: the respawn resumes there with nothing of its
    # version completed to fetch, and the survivors retry the round
    m = re.search(r"bsp: rounds=\d+ checkpoints=\d+ \(\d+B\) "
                  r"recoveries=(\d+) ring_retries=(\d+)", out)
    assert m and int(m.group(1)) >= 1 and int(m.group(2)) > 0, out[-3000:]
    assert os.path.exists(tmp_path / "obs" / "run_report.json")
    a, b = np.load(base), np.load(kill)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), f"array {k!r} diverged"


def _objv(out):
    return [float(x) for x in re.findall(
        r"lbfgs (?:init|iter \d+): objv ([-0-9.e+]+)", out)]


def test_lbfgs_linear_bsp_launch_matches_the_jax_launch(data, tmp_path):
    args = [f"data={data}/train-.*", "max_lbfgs_iter=8", "reg_L2=0.001",
            "minibatch=256", "nnz_per_row=16"]
    out_t = launch("wormhole_tpu_torch", "lbfgs_linear", *args,
                   f"model_out={tmp_path}/t.npz")
    out_j = launch("wormhole_tpu", "lbfgs_linear", *args,
                   f"model_out={tmp_path}/j.npz")
    ot, oj = _objv(out_t), _objv(out_j)
    assert len(ot) == len(oj) == 9, (ot, oj)
    np.testing.assert_allclose(ot, oj, rtol=1e-4)
    assert all(b <= a for a, b in zip(ot, ot[1:]))
    t, j = np.load(f"{tmp_path}/t.npz"), np.load(f"{tmp_path}/j.npz")
    nf = int(t["num_feature"])
    assert nf == int(j["num_feature"])
    np.testing.assert_allclose(t["w"], j["w"][: nf + 1], atol=1e-4)
