"""The linear and DiFacto apps on the global mesh, on the CPU:
`dmlc_tpu -n 2 -s 0 -- python -m wormhole_tpu_torch.apps.{linear,difacto}
conf global_mesh=1 device=cpu`, the workers the gloo ranks of one process
group, held against the JAX package.

Reference (each test says which): the JAX package's single-device
learner stepped over the same global batches, the ranks' local blocks in
rank order as apps/_runner.py _global_train builds them
(tests/torch_global_ref.py), with kernel=xla, as the JAX package's own
global mesh forces it (wormhole_tpu/apps/_runner.py:226). The port runs
W1 and W2 on its cells (the kernels' plain versions on the CPU), or their
plain twins where the buckets do not split into whole tiles: a route that
differs, not a result. DiFacto's reference starts from the port's initial
tables (the two packages draw V from different generators).

Bars, the port's learner bars: linear final val logloss and AUC within
1e-3, w at rtol 1e-4 / atol 1e-6; DiFacto val logloss and AUC within
1e-4, tables at rtol 1e-4 / atol 1e-5; predictions (printed %.6g) at
rtol 1e-4 / atol 1e-5, rank by rank and part by part. Each launch has a
timeout of its own (tests/torch_global_ref.py, 120 s).
"""

import numpy as np
import pytest

import torch_global_ref as ref
from conftest import synth_libsvm_text
from wormhole_tpu.models.difacto import DifactoConfig as JDConfig
from wormhole_tpu.models.difacto import DifactoLearner as JDLearner
from wormhole_tpu.models.linear import LinearConfig as JLConfig
from wormhole_tpu.models.linear import LinearLearner as JLLearner
from wormhole_tpu.parallel.mesh import make_mesh as j_make_mesh
from wormhole_tpu.utils import checkpoint as j_ckpt
from wormhole_tpu_torch.models.difacto import DifactoConfig, DifactoLearner
from wormhole_tpu_torch.utils import checkpoint as t_ckpt

NB = 2 * 65536  # whole tiles: the launch's cells take W1 / W2
LIN = dict(algo="ftrl", lambda_l1=1.0, lr_eta=0.2, minibatch=256,
           num_buckets=NB, max_data_pass=2, num_parts_per_file=2)
FM = dict(algo="ftrl", dim=4, threshold=2, lambda_l1=0.5, minibatch=256,
          num_buckets=NB, v_buckets=4096, max_data_pass=2,
          num_parts_per_file=2, V_init_scale=0.05, kernel_dtype="f32")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gm")
    for i in range(2):
        (d / f"train-{i}.libsvm").write_text(
            synth_libsvm_text(n_rows=320, seed=i))
    (d / "val.libsvm").write_text(synth_libsvm_text(n_rows=256, seed=9))
    return d


def _conf(path, files, body: dict, **extra):
    keys = dict(body, train_data=f'"{files}/train-.*"',
                val_data=f'"{files}/val.libsvm"', **extra)
    path.write_text("".join(f"{k} = {v}\n" for k, v in keys.items()))
    return path


@pytest.fixture(scope="module")
def linear_run(files, tmp_path_factory):
    """The linear launch: 2 passes with a val file, model_out and
    predict_out; and the JAX learner over the same global batches."""
    wd = tmp_path_factory.mktemp("gm_linear")
    conf = _conf(wd / "gm.conf", files, LIN, model_out=wd / "m",
                 predict_out=wd / "pred")
    rec = ref.launch_global("linear", 2, [conf])
    jl = JLLearner(JLConfig(**dict(LIN, kernel="xla")))
    want = ref.step_passes(jl, f"{files}/train-.*", f"{files}/val.libsvm",
                           2, 2, 128, 2)
    return {"wd": wd, "conf": conf, "rec": rec, "jl": jl, "want": want}


def test_linear_global_launch_matches_jax(linear_run, files):
    """Reference: the JAX learner stepped over the same global batches."""
    r = linear_run
    ll, auc = ref.final_val(r["rec"]["out"])
    assert abs(ll - r["want"]["logloss"]) < 1e-3
    assert abs(auc - r["want"]["auc"]) < 1e-3
    saved = t_ckpt.load_parts(str(r["wd"] / "m"))
    want = {k: np.asarray(v) for k, v in r["jl"].store.to_numpy().items()}
    for k in ("w", "z", "n"):
        np.testing.assert_allclose(saved[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # rank 0 alone prints the progress rows
    out = r["rec"]["out"]
    assert out.count("[global-mesh] train pass 1") == 1
    assert "[worker-1] [global-mesh] train" not in out


def test_linear_global_predict_writes_rank_files(linear_run, files):
    """Reference: the JAX learner's margins on each rank's rows of each of
    its parts, from the trained model."""
    want = ref.predict_files(linear_run["jl"], f"{files}/val.libsvm", 2, 2,
                             128)
    assert sorted(want) == [(0, 0), (1, 0)]
    ref.check_predict_files(str(linear_run["wd"] / "pred"), want)


def test_linear_global_warm_start(linear_run, files, tmp_path):
    """model_in: the saved model loaded on every rank, one more pass.
    Reference: the JAX learner loaded from the same file, stepped over
    the same global batches."""
    conf = _conf(tmp_path / "warm.conf", files, dict(LIN, max_data_pass=1),
                 model_in=linear_run["wd"] / "m", model_out=tmp_path / "m2")
    rec = ref.launch_global("linear", 2, [conf])
    jl = JLLearner(JLConfig(**dict(LIN, kernel="xla")))
    j_ckpt.load_model(jl.store, str(linear_run["wd"] / "m"))
    want = ref.step_passes(jl, f"{files}/train-.*", f"{files}/val.libsvm",
                           2, 2, 128, 1)
    ll, auc = ref.final_val(rec["out"])
    assert abs(ll - want["logloss"]) < 1e-3 and abs(auc - want["auc"]) < 1e-3
    assert ll < ref.final_val(linear_run["rec"]["out"])[0] + 0.02
    saved = t_ckpt.load_parts(str(tmp_path / "m2"))
    np.testing.assert_allclose(saved["w"], np.asarray(
        jl.store.to_numpy()["w"]), rtol=1e-4, atol=1e-6)


def test_linear_drained_rank_finishes(files, tmp_path):
    """-n 3 over 2 files of one part: rank 2 holds no part and feeds
    empty blocks in every step. 16,384 buckets do not split into whole
    tiles, so the cells take W1 / W2's plain twins. Reference: the JAX
    learner over the 3 ranks' global batches."""
    body = dict(LIN, num_buckets=16384, minibatch=384, num_parts_per_file=1)
    conf = _conf(tmp_path / "n3.conf", files, body,
                 model_out=tmp_path / "m")
    rec = ref.launch_global("linear", 3, [conf])
    jl = JLLearner(JLConfig(**dict(body, kernel="xla")))
    want = ref.step_passes(jl, f"{files}/train-.*", f"{files}/val.libsvm",
                           1, 3, 128, 2)
    ll, auc = ref.final_val(rec["out"])
    assert abs(ll - want["logloss"]) < 1e-3 and abs(auc - want["auc"]) < 1e-3
    np.testing.assert_allclose(
        t_ckpt.load_parts(str(tmp_path / "m"))["w"],
        np.asarray(jl.store.to_numpy()["w"]), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def difacto_run(files, tmp_path_factory):
    wd = tmp_path_factory.mktemp("gm_difacto")
    conf = _conf(wd / "gfm.conf", files, FM, model_out=wd / "m",
                 predict_out=wd / "pred")
    rec = ref.launch_global("difacto", 2, [conf])
    # the port's initial tables (the app's seed 0), into the JAX learner
    init = DifactoLearner(DifactoConfig(**FM), device="cpu")
    jl = JDLearner(JDConfig(**dict(FM, kernel="xla")), j_make_mesh(1, 1))
    jl.ckpt_store.from_numpy(init.ckpt_store.to_numpy())
    want = ref.step_passes(jl, f"{files}/train-.*", f"{files}/val.libsvm",
                           2, 2, 128, 2)
    return {"wd": wd, "rec": rec, "jl": jl, "want": want}


def test_difacto_global_launch_matches_jax(difacto_run):
    """Reference: the JAX learner (its XLA path) from the port's initial
    tables, stepped over the same global batches."""
    r = difacto_run
    ll, auc = ref.final_val(r["rec"]["out"])
    assert abs(ll - r["want"]["logloss"]) < 1e-4
    assert abs(auc - r["want"]["auc"]) < 1e-4
    saved = t_ckpt.load_parts(str(r["wd"] / "m"))
    want = {k: np.asarray(v) for k, v in r["jl"].ckpt_store.to_numpy().items()}
    assert set(saved) == set(want) == {"w", "z", "n", "cnt", "V", "nV"}
    for k, v in want.items():
        np.testing.assert_allclose(saved[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_difacto_global_predict_writes_rank_files(difacto_run, files):
    """Reference: the JAX learner's margins on each rank's rows."""
    want = ref.predict_files(difacto_run["jl"], f"{files}/val.libsvm", 2, 2,
                             128)
    ref.check_predict_files(str(difacto_run["wd"] / "pred"), want)
