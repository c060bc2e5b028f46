"""The port's launcher end to end on the CPU: `python -m
wormhole_tpu_torch.launcher.dmlc_tpu -n N -s S -- python -m
wormhole_tpu_torch.apps.{linear,difacto} conf device=cpu` trains one
shared model that the server group saves, against the port's
single-process run and the JAX launcher's run on the same files.

Each launch runs in a session of its own under its own timeout, and the
whole process group is killed when it runs out. Bars: the `-n 1 -s 1`
launch with max_delay=1 holds z and n within rtol 1e-5 / atol 1e-6 of
the single-process run and its validation logloss within 1e-3; against
the JAX launcher's `-n 1 -s 1` run, the tables within rtol 1e-4 / atol
1e-6 and logloss and AUC within 1e-3 (the learner bar of
tests/test_linear.py); `-n 2` runs within 0.05 logloss of the
single-process run (the bar of tests/test_apps.py). The parity runs read
one file of one part: the JAX pool hands parts out at random, the port's
in file order."""

import glob
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

from conftest import synth_libsvm_text
from wormhole_tpu_torch.models.difacto import DifactoConfig, DifactoLearner
from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver
from wormhole_tpu_torch.utils.checkpoint import load_parts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 150


def run_group(argv, timeout=LAUNCH_TIMEOUT, env_extra=None):
    """Run a launch in a session of its own; on timeout kill the whole
    process group (the launcher's role processes with it) and fail."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
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


def launch(pkg, n, s, app, conf, *extra):
    cmd = [sys.executable, "-m", f"{pkg}.launcher.dmlc_tpu", "-n", str(n),
           "-s", str(s), "--", sys.executable, "-m", f"{pkg}.apps.{app}",
           str(conf), *extra]
    return run_group(cmd)


def final_val(out):
    m = re.search(r"final val: logloss=([0-9.]+) auc=([0-9.]+)", out)
    assert m, out[-3000:]
    return float(m.group(1)), float(m.group(2))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("psl")
    for i in range(2):
        (d / f"train-{i}.libsvm").write_text(
            synth_libsvm_text(n_rows=256, seed=i))
    (d / "one.libsvm").write_text(synth_libsvm_text(n_rows=512, seed=3))
    (d / "val.libsvm").write_text(synth_libsvm_text(n_rows=256, seed=9))
    return d


LINEAR = """
algo = ftrl
lambda_l1 = 1
lr_eta = 0.2
minibatch = 128
num_buckets = 16384
max_data_pass = 2
max_delay = 1
print_sec = 3600
"""


def _conf(path, body, **kv):
    path.write_text(body + "".join(f"{k} = {v}\n" for k, v in kv.items()))
    return path


def _single_linear(monkeypatch, **kv):
    """The port's single-process run (one loader: batches in file order)."""
    monkeypatch.setenv("WH_NUM_LOADERS", "1")
    cfg = LinearConfig(algo="ftrl", lambda_l1=1.0, lr_eta=0.2, minibatch=128,
                       num_buckets=16384, max_data_pass=2, **kv)
    lrn = LinearLearner(cfg, device="cpu")
    res = MinibatchSolver(lrn, cfg, verbose=False).run()
    return res, lrn.store.to_numpy()


@pytest.fixture(scope="module")
def port_n1(data, tmp_path_factory):
    """The port's `-n 1 -s 1` launch on the one-part parity file."""
    d = tmp_path_factory.mktemp("n1")
    conf = _conf(d / "n1.conf", LINEAR, train_data=f"{data}/one.libsvm",
                 val_data=f"{data}/val.libsvm", num_parts_per_file=1,
                 model_out=f"{d}/model")
    out = launch("wormhole_tpu_torch", 1, 1, "linear", conf, "device=cpu")
    return out, load_parts(f"{d}/model")


def test_n1_s1_launch_matches_single_process(port_n1, data, monkeypatch):
    out, saved = port_n1
    assert "[ps-plane] tcp (workers=1, device=cpu)" in out
    assert "training pass 1" in out
    res, single = _single_linear(
        monkeypatch, train_data=f"{data}/one.libsvm",
        val_data=f"{data}/val.libsvm", num_parts_per_file=1)
    for k in ("z", "n"):
        np.testing.assert_allclose(saved[k], single[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    logloss, _ = final_val(out)
    assert abs(logloss - res["val"].mean("logloss")) < 1e-3
    # the worker's [ps-wire] line: syncs, perf split, footprint
    wire = re.search(r"\[ps-wire\] (\{.*\})", out)
    assert wire, out[-2000:]
    import json

    w = json.loads(wire.group(1))
    assert w["num_syncs"] >= 8 and w["peak_rss_mb"] > 0
    assert {"ps_push", "ps_pull", "wait", "train_step"} <= set(w["perf_sec"])


def test_n1_s1_launch_matches_the_jax_launcher(port_n1, data, tmp_path):
    out, saved = port_n1
    conf = _conf(tmp_path / "jax.conf", LINEAR,
                 train_data=f"{data}/one.libsvm",
                 val_data=f"{data}/val.libsvm", num_parts_per_file=1,
                 model_out=f"{tmp_path}/model")
    jout = launch("wormhole_tpu", 1, 1, "linear", conf)
    jsaved = load_parts(f"{tmp_path}/model")
    assert set(saved) == set(jsaved) == {"w", "z", "n"}
    for k in saved:
        np.testing.assert_allclose(saved[k], jsaved[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    (ll, auc), (jll, jauc) = final_val(out), final_val(jout)
    assert abs(ll - jll) < 1e-3 and abs(auc - jauc) < 1e-3


def test_n2_s1_linear_trains_one_shared_model(data, tmp_path, monkeypatch):
    conf = _conf(tmp_path / "n2.conf", LINEAR,
                 train_data=f"{data}/train-.*", val_data=f"{data}/val.libsvm",
                 model_out=f"{tmp_path}/model")
    out = launch("wormhole_tpu_torch", 2, 1, "linear", conf, "device=cpu")
    assert os.path.exists(f"{tmp_path}/model.npz"), out[-2000:]
    assert out.count("[ps-wire]") == 2
    res, _ = _single_linear(monkeypatch, train_data=f"{data}/train-.*",
                            val_data=f"{data}/val.libsvm")
    logloss, _ = final_val(out)
    assert abs(logloss - res["val"].mean("logloss")) < 0.05


def test_n2_s2_difacto_trains_one_shared_model(data, tmp_path, monkeypatch):
    body = """
algo = ftrl
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
    conf = _conf(tmp_path / "fm.conf", body, train_data=f"{data}/train-.*",
                 val_data=f"{data}/val.libsvm",
                 model_out=f"{tmp_path}/fm_model")
    out = launch("wormhole_tpu_torch", 2, 2, "difacto", conf, "device=cpu")
    monkeypatch.setenv("WH_NUM_LOADERS", "1")
    cfg = DifactoConfig(train_data=f"{data}/train-.*",
                        val_data=f"{data}/val.libsvm", algo="ftrl", dim=4,
                        threshold=2, lambda_l1=0.5, minibatch=256,
                        num_buckets=16384, v_buckets=4096, max_data_pass=2)
    res = MinibatchSolver(DifactoLearner(cfg, device="cpu"), cfg,
                          verbose=False).run()
    logloss, _ = final_val(out)
    assert abs(logloss - res["val"].mean("logloss")) < 0.05
    # ONE model as the server group's shard files, both table groups
    assert len(glob.glob(f"{tmp_path}/fm_model_part-*.npz")) == 2
    saved = load_parts(f"{tmp_path}/fm_model")
    for k in ("w", "z", "n", "cnt", "V", "nV"):
        assert k in saved, sorted(saved)
    assert saved["V"].shape == (4096, 4) and saved["w"].shape == (16384,)


def test_save_iter_and_model_in_resume(data, tmp_path):
    conf = _conf(tmp_path / "a.conf", LINEAR,
                 train_data=f"{data}/train-.*", val_data=f"{data}/val.libsvm",
                 model_out=f"{tmp_path}/m", save_iter=1)
    out = launch("wormhole_tpu_torch", 1, 1, "linear", conf, "device=cpu")
    assert "model saved for iter 0" in out, out[-2000:]
    it0 = load_parts(f"{tmp_path}/m", 0)
    assert set(it0) == {"w", "z", "n"} and np.count_nonzero(it0["w"])
    # resume from the pass-0 snapshot: pass 1 only, on the loaded model
    conf2 = _conf(tmp_path / "b.conf", LINEAR,
                  train_data=f"{data}/train-.*",
                  val_data=f"{data}/val.libsvm", model_in=f"{tmp_path}/m",
                  load_iter=0, model_out=f"{tmp_path}/m2")
    out2 = launch("wormhole_tpu_torch", 1, 1, "linear", conf2, "device=cpu")
    assert "model loaded from" in out2 and "iter 0" in out2
    assert "training pass 1" in out2 and "training pass 0" not in out2
    logloss, _ = final_val(out2)
    want, _ = final_val(out)
    assert abs(logloss - want) < 0.05
    assert os.path.exists(f"{tmp_path}/m2.npz")


def test_other_apps_refuse_launcher_roles(data, tmp_path):
    """A batch app launched without bsp=1 has no role to play: the launch
    fails and says how to run it (here the gbdt app under -n 1 -s 0)."""
    cmd = [sys.executable, "-m", "wormhole_tpu_torch.launcher.dmlc_tpu",
           "-n", "1", "-s", "0", "--", sys.executable, "-m",
           "wormhole_tpu_torch.apps.gbdt", f"train_data={data}/one.libsvm",
           "device=cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=LAUNCH_TIMEOUT,
                       start_new_session=True)
    assert p.returncode != 0
    assert "run with bsp=1, or without the launcher" in p.stdout + p.stderr


def test_hot_plane_and_global_mesh_raise(data, tmp_path):
    """WH_PS_PLANE=hot still raises (ROADMAP item 5.5). global_mesh=1 now
    launches cleanly: with -s 1 the server idles and the one worker
    trains as a group of one rank."""
    conf = _conf(tmp_path / "h.conf", LINEAR,
                 train_data=f"{data}/one.libsvm", num_parts_per_file=1)
    out = launch("wormhole_tpu_torch", 1, 1, "linear", conf, "device=cpu",
                 "global_mesh=1")
    assert "[global-mesh] rank 0 of 1: backend gloo, device cpu" in out
    assert "[global-mesh] train pass 0" in out
    assert "[global server 0] cuda context: none" in out
    for extra, env, msg in (([], {"WH_PS_PLANE": "hot"}, "item 5.5"),):
        cmd = [sys.executable, "-m", "wormhole_tpu_torch.launcher.dmlc_tpu",
               "-n", "1", "-s", "1", "--", sys.executable, "-m",
               "wormhole_tpu_torch.apps.linear", str(conf), "device=cpu",
               *extra]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             env=dict(os.environ, PYTHONPATH=REPO, **env),
                             cwd=REPO, start_new_session=True)
        try:
            out, _ = p.communicate(timeout=LAUNCH_TIMEOUT)
        finally:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        assert p.returncode != 0 and msg in out, out[-2000:]
