"""The port's DiFacto learner, app, solver hooks and checkpoints against
the JAX package.

The port runs on the CPU (its kernel wrappers take the plain versions);
the JAX learner runs its Pallas kernels in interpret mode. The two draw
V's random init from different generators, so every comparison starts
the port from the JAX learner's tables (interop.load_difacto_state) or
from a model file the JAX learner wrote. Bars: per-pass logloss and AUC
within 1e-4 per example, tables within rtol 1e-4 / atol 1e-5 (sums are
taken in another order: index_add_ against segment_sum and the one-hot
matmuls), predictions within rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

from test_difacto import fm_synth_text
from wormhole_tpu.data.minibatch import MinibatchIter as JIter
from wormhole_tpu.models.difacto import DifactoConfig as JConfig
from wormhole_tpu.models.difacto import DifactoLearner as JLearner
from wormhole_tpu.parallel.mesh import make_mesh
from wormhole_tpu.utils import checkpoint as j_ckpt
from wormhole_tpu_torch import interop
from wormhole_tpu_torch.data.minibatch import MinibatchIter as TIter
from wormhole_tpu_torch.models.difacto import (DifactoConfig,
                                               DifactoLearner,
                                               make_early_stop_hook)
from wormhole_tpu_torch.ops import coo_kernels as t_ck
from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver
from wormhole_tpu_torch.utils import checkpoint as t_ckpt

TILE = t_ck.TILE
TABLES = ("w", "z", "n", "cnt", "V", "nV")


@pytest.fixture(scope="module")
def fm_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("tfm") / "fm.libsvm"
    p.write_text(fm_synth_text())
    return str(p)


def _kw(**over):
    """The compact-path fixture of tests/test_difacto.py:183-233."""
    kw = dict(minibatch=256, num_buckets=2 * TILE, v_buckets=TILE,
              nnz_per_row=8, dim=4, threshold=0, lr_eta=0.3, V_lr_eta=0.1,
              kernel="pallas", kernel_dtype="f32")
    kw.update(over)
    return kw


def _pair(**over):
    """A JAX learner and a port learner started from the same tables."""
    kw = _kw(**over)
    j = JLearner(JConfig(**kw), make_mesh(1, 1))
    t = DifactoLearner(DifactoConfig(**kw), device="cpu")
    interop.load_difacto_state(t, j.ckpt_store.to_numpy())
    return j, t


def _passes(lrn, it_cls, path, passes=2, mb=256):
    out = []
    for ep in range(passes):
        tot = {}
        for blk in it_cls(path, fmt="libsvm", minibatch_size=mb, seed=ep):
            for k, v in lrn.train_batch(blk).items():
                tot[k] = tot.get(k, 0.0) + v
        out.append({k: v / tot["nex"] for k, v in tot.items()})
    return out


def _same_run(j, t, path, passes=2):
    pj, pt = _passes(j, JIter, path, passes), _passes(t, TIter, path, passes)
    for a, b in zip(pj, pt):
        for k in ("logloss", "auc", "objv_w"):
            assert abs(a[k] - b[k]) < 1e-4, (k, a[k], b[k])
        assert a["new_w"] == b["new_w"]
    sj, st = j.ckpt_store.to_numpy(), t.ckpt_store.to_numpy()
    assert set(st) == set(TABLES)
    for k in TABLES:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"table {k}")
    return pt


@pytest.mark.parametrize("threshold", [0, 3])
@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_learner_matches_jax(fm_file, kernel, threshold):
    j, t = _pair(kernel=kernel, threshold=threshold)
    assert t._use_fm_pallas == j._use_fm_pallas == (kernel == "pallas")
    _same_run(j, t, fm_file)
    assert t.nnz() == j.nnz()
    assert t.num_admitted() == j.num_admitted() > 0
    assert t.v_collision_rate() == j.v_collision_rate()
    if kernel == "pallas":
        assert t._fm_caps == j._fm_caps
        # the host count mirror tracks the device table
        np.testing.assert_array_equal(t._cnt_host,
                                      t.store.state["cnt"].numpy())
        assert t.dropped_slot_nnz == t.dropped_row_nnz == 0
    # eval and predict run the same forward as training
    bt = next(iter(TIter(fm_file, minibatch_size=128)))
    bj = next(iter(JIter(fm_file, minibatch_size=128)))
    np.testing.assert_allclose(t.predict_batch(bt), j.predict_batch(bj),
                               rtol=1e-4, atol=1e-5)
    ev_t, ev_j = t.eval_batch(bt), j.eval_batch(bj)
    assert abs(ev_t["logloss"] - ev_j["logloss"]) / ev_j["nex"] < 1e-4


KNOBS = [dict(grad_clipping=0.01), dict(grad_normalization=True),
         dict(fixed_bytes=2)]


@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: next(iter(k)))
@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_grad_knobs_match_jax(fm_file, kernel, knob):
    # kernel_dtype=auto: f32 unless fixed_bytes, then the kernel default,
    # which is f32 on the CPU for both packages
    j, t = _pair(kernel=kernel, threshold=1, kernel_dtype="auto", **knob)
    _same_run(j, t, fm_file, passes=1)


def test_dropout_keeps_its_fraction_under_a_seeded_generator():
    """The two packages' RNGs differ, so dropout is held to its kept
    fraction and to the same draws from the same seed."""
    cfg = DifactoConfig(**_kw(kernel="xla", dropout=0.3))
    mask = torch.ones(256)
    keeps = []
    for _ in range(2):
        lrn = DifactoLearner(cfg, device="cpu", seed=5)
        keeps.append(lrn._grad_filters(torch.ones(20000, 8), mask) != 0)
    assert torch.equal(keeps[0], keeps[1])
    assert abs(float(keeps[0].float().mean()) - 0.7) < 0.01


def test_pack_matches_jax_and_row_overflow_drops_from_both_layouts():
    """_pack_fm gives the JAX learner's arrays; a row with more live
    nonzeros than nnz_per_row drops its overflow from the row-major
    layout AND the slot-sorted COOs (tests/test_difacto.py:269-307)."""
    import types

    W = 4
    # minibatch 8 is below the kernels' 128-row granule: the learners
    # take the xla kind, and the pack is called directly
    kw = _kw(minibatch=8, nnz_per_row=W, kernel="auto")
    j = JLearner(JConfig(**kw), make_mesh(1, 1))
    t = DifactoLearner(DifactoConfig(**kw), device="cpu")
    segs, idxs, vals = [], [], []
    for k in range(7):  # row 0: 7 live nonzeros (> W)
        segs.append(0); idxs.append(11 + k); vals.append(1.0 + k)
    for r in range(1, 8):  # rows 1..7: 2 each
        for k in range(2):
            segs.append(r); idxs.append(100 + 10 * r + k); vals.append(1.0)
    db = types.SimpleNamespace(seg=np.array(segs, np.int32),
                               idx=np.array(idxs, np.int64),
                               val=np.array(vals, np.float32))
    pj, pt = j._pack_fm(db, train=True), t._pack_fm(db, train=True)
    flat_j = JLearner._fm_args(j, pj, np.zeros(8), np.ones(8), True)
    flat_t = DifactoLearner._fm_args(pt, np.zeros(8), np.ones(8), True)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert t.dropped_row_nnz == 3 and t.dropped_slot_nnz == 0
    (_, _, wcoo, _, _, vcoo, _, rm_wval, rm_vval, _) = pt
    rm_w2 = rm_wval.reshape(8, W)
    rm_v2 = rm_vval.reshape(8, W)
    assert np.count_nonzero(rm_w2[0]) == np.count_nonzero(rm_v2[0]) == W
    live = vcoo.val != 0
    np.testing.assert_array_equal(np.sort(vcoo.val[live & (vcoo.seg == 0)]),
                                  np.sort(rm_v2[0]))
    livew = wcoo.val != 0
    np.testing.assert_array_equal(np.sort(wcoo.val[livew & (wcoo.seg == 0)]),
                                  np.sort(rm_w2[0]))
    for r in range(1, 8):
        assert np.count_nonzero(rm_v2[r]) == 2
        assert np.count_nonzero(vcoo.val[live & (vcoo.seg == r)]) == 2


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_app_matches_jax_app(tmp_path, kernel):
    """Both apps from the same model_in, written by the JAX learner before
    any step."""
    from wormhole_tpu.apps import difacto as j_app
    from wormhole_tpu_torch.apps import difacto as t_app

    (tmp_path / "train.libsvm").write_text(fm_synth_text(n_rows=1024,
                                                         seed=1))
    (tmp_path / "val.libsvm").write_text(fm_synth_text(n_rows=512, seed=2))
    kw = _kw(kernel=kernel, threshold=2)
    j_ckpt.save_model(JLearner(JConfig(**kw), make_mesh(1, 1)).ckpt_store,
                      str(tmp_path / "init"))
    conf = tmp_path / "fm.conf"
    conf.write_text(f"""
train_data = "{tmp_path}/train.libsvm"
val_data = "{tmp_path}/val.libsvm"
model_in = "{tmp_path}/init"
minibatch = 256
num_buckets = {2 * TILE}
v_buckets = {TILE}
nnz_per_row = 8
dim = 4
threshold = 2
lr_eta = 0.3
V_lr_eta = 0.1
kernel = {kernel}
kernel_dtype = f32
max_data_pass = 2
num_parts_per_file = 1
max_concurrency = 1
""")
    outs = {}
    for name, app, extra in (("jax", j_app, []),
                             ("port", t_app, ["device=cpu"])):
        assert app.main([str(conf), f"model_out={tmp_path}/{name}_model",
                         f"predict_out={tmp_path}/{name}_pred",
                         *extra]) == 0
        outs[name] = (np.loadtxt(f"{tmp_path}/{name}_pred_part-0"),
                      t_ckpt.load_parts(f"{tmp_path}/{name}_model"))
    (pj, mj), (pt, mt) = outs["jax"], outs["port"]
    assert pt.shape == (512,) and np.isfinite(pt).all()
    # the app writes margins with 6 significant digits
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-5)
    assert set(mt) == set(mj) == set(TABLES)
    for k in TABLES:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"table {k}")


def test_jax_model_out_loads_into_port(fm_file, tmp_path):
    j = JLearner(JConfig(**_kw(threshold=2)), make_mesh(1, 1))
    for blk in JIter(fm_file, minibatch_size=256):
        j.train_batch(blk)
    base = str(tmp_path / "model")
    j_ckpt.save_model(j.ckpt_store, base)
    t = DifactoLearner(DifactoConfig(**_kw(threshold=2)), device="cpu")
    t_ckpt.load_model(t.ckpt_store, base)
    for k, v in j.ckpt_store.to_numpy().items():
        np.testing.assert_array_equal(t.ckpt_store.to_numpy()[k], v)
    # loading fired the count-mirror resync
    np.testing.assert_array_equal(t._cnt_host, t.store.state["cnt"].numpy())
    bt = next(iter(TIter(fm_file, minibatch_size=128)))
    bj = next(iter(JIter(fm_file, minibatch_size=128)))
    np.testing.assert_allclose(t.predict_batch(bt), j.predict_batch(bj),
                               rtol=1e-4, atol=1e-5)
    # and the port's save reads back through the JAX loader
    t_ckpt.save_model(t.ckpt_store, str(tmp_path / "port"))
    back = j_ckpt.load_parts(str(tmp_path / "port"))
    np.testing.assert_array_equal(back["V"], j.ckpt_store.to_numpy()["V"])


def test_interop_rejects_wrong_tables():
    cfg = DifactoConfig(**_kw())
    good = {k: np.zeros(cfg.num_buckets, np.float32) for k in "wzn"}
    good["cnt"] = np.zeros(cfg.num_buckets, np.float32)
    good["V"] = np.zeros((cfg.vb, cfg.dim), np.float32)
    good["nV"] = np.zeros((cfg.vb, cfg.dim), np.float32)
    state = interop.difacto_state_from_numpy(good, cfg, "cpu")
    assert set(state) == set(TABLES) and state["V"].shape == (TILE, 4)
    with pytest.raises(ValueError):  # a table missing
        interop.difacto_state_from_numpy(
            {k: v for k, v in good.items() if k != "nV"}, cfg, "cpu")
    with pytest.raises(ValueError):  # a table too many
        interop.difacto_state_from_numpy(dict(good, extra=good["w"]), cfg,
                                         "cpu")
    with pytest.raises(ValueError):  # V over num_buckets, not v_buckets
        interop.difacto_state_from_numpy(
            dict(good, V=np.zeros((cfg.num_buckets, 4), np.float32)), cfg,
            "cpu")
    with pytest.raises(ValueError):  # V of another dim
        interop.difacto_state_from_numpy(
            dict(good, V=np.zeros((cfg.vb, 8), np.float32)), cfg, "cpu")


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DifactoLearner(DifactoConfig(**_kw()))
    t = DifactoLearner(DifactoConfig(**_kw()), device="cpu")
    assert t.device.type == "cpu"
    assert {v.device.type for v in t.ckpt_store.state.values()} == {"cpu"}
    # kernel=pallas never drops to xla where its shapes do not fit
    with pytest.raises(ValueError):
        DifactoLearner(DifactoConfig(**_kw(l1_shrk=True)), device="cpu")


# ------------------------------------------------------------ solver
def _solver_cfg(fm_file, tmp_path, **over):
    kw = _kw(threshold=3, train_data=fm_file.replace(".libsvm", r"\.libsvm"),
             num_parts_per_file=2, max_concurrency=2,
             model_out=str(tmp_path / "m/fm"))
    kw.update(over)
    return DifactoConfig(**kw)


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_solver_checkpoint_holds_v_tables(fm_file, tmp_path, kernel):
    cfg = _solver_cfg(fm_file, tmp_path, kernel=kernel, max_data_pass=1)
    lrn = DifactoLearner(cfg, device="cpu")
    MinibatchSolver(lrn, cfg, verbose=False).run()
    saved = t_ckpt.load_parts(cfg.model_out)
    assert set(saved) == set(TABLES)
    assert saved["V"].shape == saved["nV"].shape == (TILE, 4)
    np.testing.assert_array_equal(saved["V"],
                                  lrn.vstore.state["V"].numpy())
    # a model_in round trip through the solver gives the same predictions
    cfg2 = DifactoConfig(**{**cfg.__dict__, "model_in": cfg.model_out,
                            "model_out": None, "max_data_pass": 0})
    lrn2 = DifactoLearner(cfg2, device="cpu")
    MinibatchSolver(lrn2, cfg2, verbose=False).run()
    blk = next(iter(TIter(fm_file, minibatch_size=256)))
    np.testing.assert_array_equal(lrn.predict_batch(blk),
                                  lrn2.predict_batch(blk))


def test_solver_resyncs_count_mirror_each_pass(fm_file, tmp_path):
    cfg = _solver_cfg(fm_file, tmp_path, max_data_pass=2,
                      val_data=fm_file.replace(".libsvm", r"\.libsvm"))
    lrn = DifactoLearner(cfg, device="cpu")
    calls = []
    hook = lrn.on_pass_start
    lrn.on_pass_start = lambda: (calls.append(1), hook())
    # drift the mirror: the first pass start must put it right
    lrn._cnt_host += 5.0
    MinibatchSolver(lrn, cfg, verbose=False).run()
    assert len(calls) == 4  # train and val, two passes
    cnt = lrn.store.state["cnt"].numpy()
    assert cnt.sum() > 0
    np.testing.assert_array_equal(lrn._cnt_host, cnt)


@pytest.mark.parametrize("how", ["early-stop", "always"])
def test_stop_hook_ends_the_run_early(fm_file, tmp_path, how):
    cfg = _solver_cfg(fm_file, tmp_path, max_data_pass=50,
                      early_stop_epsilon=0.5,
                      val_data=fm_file.replace(".libsvm", r"\.libsvm"))
    lrn = DifactoLearner(cfg, device="cpu")
    solver = MinibatchSolver(lrn, cfg, verbose=False)
    solver.stop_hook = (make_early_stop_hook(cfg) if how == "early-stop"
                        else lambda prog, dp, key: key == "val")
    solver.run()
    steps_per_pass = -(-3000 // cfg.minibatch) + 1  # two parts per file
    passes = 2 if how == "early-stop" else 1
    assert lrn._step_count <= passes * steps_per_pass
    assert lrn._step_count >= passes * (3000 // cfg.minibatch)
