"""The batch apps on the global mesh, on the CPU: `dmlc_tpu -n 2 -s 0 --
python -m wormhole_tpu_torch.apps.{kmeans,lbfgs_linear,gbdt} ...
global_mesh=1 device=cpu`, the workers the gloo ranks of one process
group, held against the JAX package's single-device learner on the same
rows (each test says how it is started), and global_mesh=1 without a
launcher role, which runs in one process as the JAX app does.

Bars, the port's learner bars: k-means cost within 1e-4 and centroids
atol 1e-5 (the model file's %.6g); L-BFGS objective rtol 1e-4; GBDT
edges equal byte for byte (every row of each rank sits in its
reservoir: the files hold fewer than _SKETCH_ROWS // 2 rows), trees
equal, leaves within 1e-5, train AUC within 1e-3. Each launch has a
timeout of its own (tests/torch_global_ref.py, 120 s).
"""

import re

import numpy as np
import pytest

import torch_global_ref as ref
from conftest import synth_libsvm_text
from wormhole_tpu.models.batch_objectives import LinearObjFunction as JObj
from wormhole_tpu.models.batch_objectives import load_batches as j_load
from wormhole_tpu.models.gbdt import GbdtConfig as JGConfig
from wormhole_tpu.models.gbdt import GbdtLearner as JGLearner
from wormhole_tpu.models.kmeans import KmeansConfig as JKConfig
from wormhole_tpu.models.kmeans import KmeansLearner as JKLearner
from wormhole_tpu.parallel.mesh import make_mesh as j_make_mesh
from wormhole_tpu.solver.lbfgs import LBFGSConfig as JLBConfig
from wormhole_tpu.solver.lbfgs import LBFGSSolver as JLBSolver
from wormhole_tpu_torch.apps import gbdt as t_gbdt
from wormhole_tpu_torch.apps import kmeans as t_kmeans
from wormhole_tpu_torch.apps import lbfgs_linear as t_lbfgs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gmb")
    for i in range(2):
        (d / f"km-{i}.libsvm").write_text(synth_libsvm_text(
            n_rows=300, n_feat=60, nnz_per_row=8, seed=40 + i))
        (d / f"lb-{i}.libsvm").write_text(synth_libsvm_text(
            n_rows=400, n_feat=120, nnz_per_row=10, seed=50 + i))
        (d / f"gb-{i}.libsvm").write_text(synth_libsvm_text(
            n_rows=1000, n_feat=40, nnz_per_row=12, seed=60 + i))
    return d


def _number(pattern: str, out: str) -> float:
    m = re.search(pattern, out)
    assert m, out[-3000:]
    return float(m.group(1))


def test_kmeans_global_launch_matches_jax(files, tmp_path):
    """Reference: the JAX learner on one device from the centroids the
    JAX global body draws (rank 0's first local rows, numpy's
    default_rng(seed)), over all the rows."""
    out = tmp_path / "centroids.txt"
    rec = ref.launch_global("kmeans", 2, [
        f"data={files}/km-.*", "num_clusters=4", "max_iter=4",
        "minibatch=256", f"model_out={out}"])
    cost = _number(r"final cosine objective: ([0-9.]+)", rec["out"])
    cfg = JKConfig(train_data=f"{files}/km-.*", num_clusters=4, max_iter=4,
                   minibatch=256, seed=0)
    jl = JKLearner(cfg, j_make_mesh(1, 1))
    rng = np.random.default_rng(cfg.seed)
    rows = []
    for blk in ref.rank_blocks(cfg.train_data, 1, 0, 2, 128):
        X = np.zeros((blk.size, cfg.dim), np.float32)
        r = np.repeat(np.arange(blk.size), np.diff(blk.offset))
        X[r, blk.index.astype(np.int64)] = blk.values_or_ones()
        rows.append(X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True),
                                   1e-12))
        if sum(len(x) for x in rows) >= 4 * 8:
            break
    cand = np.concatenate(rows)
    jl.centroids = cand[rng.choice(len(cand), size=4, replace=False)]
    want = jl.run(verbose=False)
    assert abs(cost - want) < 1e-4, (cost, want)
    np.testing.assert_allclose(np.loadtxt(out), np.asarray(jl.centroids),
                               atol=1e-5)
    assert len(rec["workers"]) == 2


def test_lbfgs_global_launch_matches_jax(files, tmp_path):
    """Reference: the JAX solver on one device over all the rows."""
    rec = ref.launch_global("lbfgs_linear", 2, [
        f"data={files}/lb-.*", "max_lbfgs_iter=15", "reg_L2=0.001",
        "minibatch=512", f"model_out={tmp_path}/lb_model.npz"])
    objv = _number(r"final objective: ([0-9.]+)", rec["out"])
    mesh = j_make_mesh(1, 1)
    batches, nf = j_load(f"{files}/lb-.*", mesh, minibatch=512,
                         nnz_per_row=64)
    _, want = JLBSolver(JObj(batches, nf, mesh), JLBConfig(
        max_iter=15, reg_l2=0.001)).run(verbose=False)
    assert abs(objv - want) / abs(want) < 1e-4, (objv, want)
    saved = np.load(f"{tmp_path}/lb_model.npz")
    assert int(saved["num_feature"]) == nf
    # every rank drove the same loop: one progress row stream (rank 0's)
    assert len(re.findall(r"\[worker-1\] lbfgs iter", rec["out"])) == 0


def test_gbdt_global_launch_matches_jax(files, tmp_path):
    """Reference: the JAX learner on one device over the union of the
    files (min_child_weight 16, as tests/test_torch_gbdt.py's parity)."""
    args = [f"train_data={files}/gb-.*", "num_round=4", "max_depth=3",
            "eval_train=1", "min_child_weight=16", "num_parts_per_file=1",
            f"model_out={tmp_path}/gb_model"]
    rec = ref.launch_global("gbdt", 2, args)
    auc = _number(r"final train: auc=([0-9.]+)", rec["out"])
    jl = JGLearner(JGConfig(train_data=f"{files}/gb-.*", num_round=4,
                            max_depth=3, eval_train=1, min_child_weight=16.0,
                            num_parts_per_file=1))
    last = jl.fit(verbose=False)
    got = np.load(f"{tmp_path}/gb_model.npz")
    assert got["edges"].dtype == jl.edges.dtype
    assert got["edges"].tobytes() == np.asarray(jl.edges).tobytes()
    for k in ("split_feat", "split_bin", "is_split"):
        np.testing.assert_array_equal(got[k], jl.trees[k], err_msg=k)
    np.testing.assert_allclose(got["leaf_value"], jl.trees["leaf_value"],
                               rtol=0, atol=1e-5)
    assert abs(auc - last["train"]["auc"]) < 1e-3
    assert re.search(r"\[gbdt-global\] round ms: \[", rec["out"])


@pytest.mark.parametrize("app", ["kmeans", "lbfgs_linear", "gbdt"])
def test_global_mesh_without_a_role_runs_in_one_process(app, files,
                                                        tmp_path, capsys):
    """global_mesh=1 with no launcher role: one process, as the JAX app
    (its maybe_run_global returns None without a role)."""
    mod = {"kmeans": t_kmeans, "lbfgs_linear": t_lbfgs, "gbdt": t_gbdt}[app]
    args = {"kmeans": [f"data={files}/km-.*", "num_clusters=3",
                       "max_iter=2", "minibatch=256"],
            "lbfgs_linear": [f"data={files}/lb-.*", "max_lbfgs_iter=3",
                             "minibatch=512"],
            "gbdt": [f"train_data={files}/gb-.*", "num_round=2",
                     "max_depth=2", "max_bin=16"]}[app]
    assert mod.main(args + ["global_mesh=1", "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "[global-mesh]" not in out and "[global-worker]" not in out
    if app != "gbdt":
        assert "final" in out


def test_a_failed_rank_fails_the_launch_at_once(files, tmp_path):
    """Rank 1's file holds a token the parser refuses: the rank raises,
    leaves the group without the exit barrier, and rank 0, waiting in
    the dimension's all_reduce, fails at once instead of waiting out
    the group's 120 s timeout; the launch exits non-zero."""
    import os
    import signal
    import subprocess
    import sys
    import time

    (tmp_path / "bad-0.libsvm").write_text(
        (files / "km-0.libsvm").read_text())
    (tmp_path / "bad-1.libsvm").write_text(
        (files / "km-1.libsvm").read_text() + "1 abc:x\n")
    cmd = [sys.executable, "-m", "wormhole_tpu_torch.launcher.dmlc_tpu",
           "-n", "2", "-s", "0", "--node-timeout", "10", "--",
           sys.executable, "-m", "wormhole_tpu_torch.apps.kmeans",
           f"data={tmp_path}/bad-.*", "num_clusters=3", "max_iter=2",
           "minibatch=256", "global_mesh=1", "device=cpu"]
    env = dict(os.environ, PYTHONPATH=ref.REPO, OMP_NUM_THREADS="1")
    t = time.perf_counter()
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=ref.REPO, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=100)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    assert p.returncode != 0, out[-3000:]
    assert time.perf_counter() - t < 90
    assert "Connection closed by peer" in out or "abc" in out, out[-3000:]
