"""The port's linear learner, app and checkpoints against the JAX package.

The port runs on the CPU (its kernel wrappers take the plain versions);
the JAX learner runs its Pallas kernels in interpret mode. Bars of
tests/test_linear.py: per-pass logloss and AUC within 1e-3, the final w
within rtol 1e-4 / atol 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from conftest import synth_libsvm_text
from wormhole_tpu.data.minibatch import MinibatchIter as JIter
from wormhole_tpu.models.linear import LinearConfig as JConfig
from wormhole_tpu.models.linear import LinearLearner as JLearner
from wormhole_tpu.parallel.mesh import make_mesh
from wormhole_tpu.utils import checkpoint as j_ckpt
from wormhole_tpu_torch import interop
from wormhole_tpu_torch.data.minibatch import MinibatchIter as TIter
from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
from wormhole_tpu_torch.ops import coo_kernels as t_ck
from wormhole_tpu_torch.utils import checkpoint as t_ckpt

TILE = t_ck.TILE


@pytest.fixture(scope="module")
def synth_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("tlin") / "synth.libsvm"
    p.write_text(synth_libsvm_text(n_rows=1000, n_feat=300, nnz_per_row=12,
                                   seed=5))
    return str(p)


def _passes(lrn, it_cls, path, passes=2, mb=128):
    out = []
    for ep in range(passes):
        tot = {}
        for blk in it_cls(path, fmt="libsvm", minibatch_size=mb, seed=ep):
            for k, v in lrn.train_batch(blk).items():
                tot[k] = tot.get(k, 0.0) + v
        out.append({k: v / tot["nex"] for k, v in tot.items()})
    return out


def _kw(**over):
    kw = dict(minibatch=128, num_buckets=8 * TILE, nnz_per_row=16,
              algo="ftrl", lr_eta=0.5, lambda_l1=0.5, kernel="pallas",
              compact_cap=0, kernel_dtype="f32")
    kw.update(over)
    return kw


CASES = [dict(algo=a, compact_cap=c) for c in (0, TILE)
         for a in ("ftrl", "adagrad", "sgd")] + [
    dict(algo="ftrl", compact_cap=TILE, fixed_bytes=1),
    dict(algo="adagrad", kernel="xla", fixed_bytes=2),
    dict(algo="adagrad", kernel="xla", loss="square_hinge", lr_eta=0.3),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_learner_matches_jax(synth_file, case):
    kw = _kw(**case)
    j = JLearner(JConfig(**kw), make_mesh(1, 1))
    t = LinearLearner(LinearConfig(**kw), device="cpu")
    pj = _passes(j, JIter, synth_file)
    pt = _passes(t, TIter, synth_file)
    want_kind = ("xla" if kw["kernel"] == "xla"
                 else "tcoo" if kw["compact_cap"] else "coo")
    blk = next(iter(TIter(synth_file, minibatch_size=128)))
    assert t.prepare_batch(blk)[0] == want_kind
    assert t._compact_cap == j._compact_cap
    for a, b in zip(pj, pt):
        assert abs(a["logloss"] - b["logloss"]) < 1e-3
        assert abs(a["auc"] - b["auc"]) < 1e-3
        assert a["new_w"] == b["new_w"]
    for k, v in j.store.to_numpy().items():
        np.testing.assert_allclose(t.store.to_numpy()[k], v, rtol=1e-4,
                                   atol=1e-6)
    assert t.nnz() == j.nnz()


def test_decide_compact_cap_matches_jax():
    rng = np.random.default_rng(0)
    for nb in (64 * TILE, 1024 * TILE):
        idx = rng.integers(0, nb, size=20000)
        kw = _kw(num_buckets=nb, compact_cap=-1)
        j = JLearner(JConfig(**kw), make_mesh(1, 1))
        t = LinearLearner(LinearConfig(**kw), device="cpu")
        assert t.ensure_compact(idx) == j.ensure_compact(idx)
    assert t._compact_cap > 0  # the larger table engages the compact path


@pytest.mark.parametrize("compact_cap", [0, TILE])
def test_interop_state_gives_equal_margins(synth_file, compact_cap):
    kw = _kw(compact_cap=compact_cap)
    j = JLearner(JConfig(**kw), make_mesh(1, 1))
    for blk in JIter(synth_file, minibatch_size=128):
        j.train_batch(blk)
    t = LinearLearner(LinearConfig(**kw), device="cpu")
    interop.load_linear_state(t, j.store.to_numpy())
    bt = next(iter(TIter(synth_file, minibatch_size=128)))
    bj = next(iter(JIter(synth_file, minibatch_size=128)))
    np.testing.assert_allclose(t.predict_batch(bt), j.predict_batch(bj),
                               rtol=1e-5, atol=1e-5)
    ev_t, ev_j = t.eval_batch(bt), j.eval_batch(bj)
    assert abs(ev_t["logloss"] - ev_j["logloss"]) / ev_j["nex"] < 1e-5


def test_interop_rejects_wrong_tables():
    cfg = LinearConfig(**_kw())
    good = {k: np.zeros(cfg.num_buckets, np.float32) for k in "wzn"}
    state = interop.linear_state_from_numpy(good, cfg, "cpu")
    assert set(state) == {"w", "z", "n"}
    with pytest.raises(ValueError):
        interop.linear_state_from_numpy({"w": good["w"]}, cfg, "cpu")
    with pytest.raises(ValueError):
        interop.linear_state_from_numpy(
            dict(good, w=np.zeros(7, np.float32)), cfg, "cpu")


@pytest.mark.parametrize("shards", [1, 2])
def test_jax_model_out_loads_into_port(tmp_path, shards):
    kw = _kw(kernel="xla")
    j = JLearner(JConfig(**kw), make_mesh(1, shards))
    rng = np.random.default_rng(1)
    j.store.from_numpy({k: rng.normal(size=kw["num_buckets"]).astype(
        np.float32) for k in "wzn"})
    base = str(tmp_path / "model")
    files = j_ckpt.save_model(j.store, base)
    assert len(files) == shards
    t = LinearLearner(LinearConfig(**kw), device="cpu")
    t_ckpt.load_model(t.store, base)
    for k, v in j.store.to_numpy().items():
        np.testing.assert_array_equal(t.store.to_numpy()[k], v)
    # and the port's own save round-trips through the JAX loader
    t_ckpt.save_model(t.store, str(tmp_path / "port"))
    back = j_ckpt.load_parts(str(tmp_path / "port"))
    np.testing.assert_array_equal(back["w"], j.store.to_numpy()["w"])


def test_app_matches_jax_app(tmp_path):
    from wormhole_tpu.apps import linear as j_app
    from wormhole_tpu_torch.apps import linear as t_app

    (tmp_path / "train.libsvm").write_text(
        synth_libsvm_text(n_rows=512, seed=1))
    (tmp_path / "val.libsvm").write_text(synth_libsvm_text(n_rows=256,
                                                           seed=9))
    conf = tmp_path / "demo.conf"
    conf.write_text(f"""
train_data = "{tmp_path}/train.libsvm"
val_data = "{tmp_path}/val.libsvm"
algo = ftrl
lambda_l1 = 1
minibatch = 128
num_buckets = 16384
max_data_pass = 2
num_parts_per_file = 1
max_concurrency = 1
""")
    outs = {}
    for name, app, extra in (("jax", j_app, []),
                             ("port", t_app, ["device=cpu"])):
        rc = app.main([str(conf), "lr_eta=0.2",
                       f"model_out={tmp_path}/{name}_model",
                       f"predict_out={tmp_path}/{name}_pred", *extra])
        assert rc == 0
        preds = np.loadtxt(f"{tmp_path}/{name}_pred_part-0")
        outs[name] = (preds, t_ckpt.load_parts(f"{tmp_path}/{name}_model"))
    (pj, mj), (pt, mt) = outs["jax"], outs["port"]
    assert pt.shape == (256,) and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-4)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4, atol=1e-6)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LinearLearner(LinearConfig(**_kw()))
    assert LinearLearner(LinearConfig(**_kw()), device="cpu").device.type \
        == "cpu"


def test_new_w_tracks_nnz_and_prob_predict(synth_file):
    t = LinearLearner(LinearConfig(**_kw(compact_cap=TILE, lambda_l1=2.0)),
                      device="cpu")
    total = sum(t.train_batch(b)["new_w"]
                for b in TIter(synth_file, minibatch_size=128))
    assert int(total) == t.nnz() > 0
    blk = next(iter(TIter(synth_file, minibatch_size=64)))
    margins = t.predict_batch(blk)
    assert margins.shape == (64,)
    t.cfg.prob_predict = True
    np.testing.assert_allclose(t.predict_batch(blk),
                               1 / (1 + np.exp(-margins)), rtol=1e-6)


def test_staged_batches_and_touched_ids(synth_file):
    t = LinearLearner(LinearConfig(**_kw(compact_cap=TILE)), device="cpu")
    t.track_touched = True
    blks = list(TIter(synth_file, minibatch_size=128))[:3]
    for b in blks:
        staged = t.stage_batch(t.prepare_batch(b), train=True)
        assert staged[0] == "staged" and staged[1] == "tcoo"
        t.train_batch(staged)
    touched = t.collect_touched()
    want = np.unique(np.concatenate(
        [t.make_device_batch(b).idx for b in blks]))
    np.testing.assert_array_equal(touched["w"], want)
    assert t.collect_touched()["w"].size == 0
    with pytest.raises(ValueError):
        t.eval_batch(t.stage_batch(t.prepare_batch(blks[0]), train=True))
    assert t.derived_tables()["w"]["kind"] == "ftrl_prox"
    assert t.pack_cache_token()[3] == TILE
    assert os.path.basename(t_ckpt.save_prefix("a/m", 3)) == "m_iter-3"
