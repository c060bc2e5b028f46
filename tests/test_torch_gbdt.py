"""The port's GBDT learner, app, data path and model files against the JAX
package, on the CPU (the port's level_hist wrapper takes its plain
version; the JAX learner runs hist_kernel="xla", the scatter, or "mxu",
its Pallas kernel in interpret mode).

Bars: host binning byte-identical; tree structure equal; leaf_value atol
1e-5 (the JAX package's own bar for continuation, tests/test_gbdt.py);
every printed metric within 1e-4; predict_margin rtol 1e-4 / atol 1e-5.
The learner parity runs use min_child_weight=16: a last-level leaf is its
parent's total minus its sibling's, so on a leaf of a few rows the JAX
package's two histogram paths differ from each other by more than 1e-5
(up to 2.3e-5 at min_child_weight=1 on this data; its kernel splits g and
h into bf16 pairs), which no port can match both of.
"""

import os

import numpy as np
import pytest
import torch

from conftest import synth_libsvm_text
from torch_bsp_role import bsp_worker_role
from wormhole_tpu.apps import gbdt as j_app
from wormhole_tpu.data.minibatch import MinibatchIter as JIter
from wormhole_tpu.data.rowblock import RowBlock as JRowBlock
from wormhole_tpu.models import gbdt as j_gbdt
from wormhole_tpu.solver.workload import iter_rowblocks as j_iter_rowblocks
from wormhole_tpu_torch import interop
from wormhole_tpu_torch.apps import gbdt as t_app
from wormhole_tpu_torch.data.minibatch import MinibatchIter as TIter
from wormhole_tpu_torch.data.rowblock import RowBlock as TRowBlock
from wormhole_tpu_torch.data.synth import synth_higgs
from wormhole_tpu_torch.models import gbdt as t_gbdt
from wormhole_tpu_torch.ops import hist as t_hist
from wormhole_tpu_torch.solver.workload import iter_parts, iter_rowblocks

STRUCT = ("split_feat", "split_bin", "is_split")


def _dense_text(X, y):
    return "\n".join(
        f"{y[i]:.5f} " + " ".join(f"{f}:{X[i, f]:.5f}"
                                  for f in range(X.shape[1]))
        for i in range(X.shape[0])) + "\n"


def _dense_file(path, objective, seed, n=4096, F=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F)).astype(np.float32)
    t = X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
    y = (t > 0).astype(np.float32) if objective == "binary:logistic" else t
    path.write_text(_dense_text(X, y))
    return str(path)


@pytest.fixture(scope="module")
def sparse_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tgbdt")
    tr, va = d / "tr.libsvm", d / "va.libsvm"
    tr.write_text(synth_libsvm_text(n_rows=800, n_feat=40, seed=0))
    va.write_text(synth_libsvm_text(n_rows=400, n_feat=40, seed=1))
    return str(tr), str(va)


def _rows(out: str) -> list:
    """The `[r] name-metric:value ...` rows a fit printed, as ordered
    (name, value) lists."""
    rows = []
    for line in out.splitlines():
        if line.startswith("["):
            cells = line.split("\t")[1:]
            rows.append([(c.rsplit(":", 1)[0], float(c.rsplit(":", 1)[1]))
                         for c in cells])
    return rows


def _assert_rows_close(got, want, tol=1e-4):
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        assert [k for k, _ in a] == [k for k, _ in b]
        for (k, x), (_, y) in zip(a, b):
            assert abs(x - y) <= tol, (k, x, y)


def _assert_trees_close(t_trees, j_trees):
    for k in STRUCT:
        np.testing.assert_array_equal(t_trees[k], j_trees[k])
    np.testing.assert_allclose(t_trees["leaf_value"], j_trees["leaf_value"],
                               rtol=0, atol=1e-5)


# ------------------------------------------------------------ host code
@pytest.mark.parametrize("case", ["few", "many", "constant", "mixed"])
def test_binning_is_byte_identical(case):
    rng = np.random.default_rng(1)
    if case == "few":
        X = rng.integers(0, 3, (500, 4)).astype(np.float32)
    elif case == "many":
        X = rng.standard_normal((5000, 3)).astype(np.float32)
    elif case == "constant":
        X = np.ones((100, 2), np.float32)
    else:
        X = np.concatenate([rng.standard_normal((3000, 2)),
                            rng.integers(0, 2, (3000, 2)),
                            np.zeros((3000, 1))], 1).astype(np.float32)
    for max_bin in (16, 256):
        e_t, e_j = (m.quantile_edges(X, max_bin) for m in (t_gbdt, j_gbdt))
        assert e_t.dtype == e_j.dtype and e_t.shape == e_j.shape
        assert e_t.tobytes() == e_j.tobytes()
        b_t, b_j = t_gbdt.bin_matrix(X, e_t), j_gbdt.bin_matrix(X, e_j)
        assert b_t.dtype == np.uint8 and b_t.tobytes() == b_j.tobytes()
        assert b_t.max() < max_bin


def test_reservoir_is_identical(sparse_files):
    tr, _ = sparse_files
    res_t, res_j = t_gbdt.Reservoir(100, 7), j_gbdt.Reservoir(100, 7)
    for bt, bj in zip(TIter(tr, minibatch_size=128),
                      JIter(tr, minibatch_size=128)):
        res_t.add_block(bt)
        res_j.add_block(bj)
    assert res_t.n_seen == res_j.n_seen == 800
    assert res_t.max_feat == res_j.max_feat
    assert len(res_t.sample) == len(res_j.sample) == 100
    for (i1, v1), (i2, v2) in zip(res_t.sample, res_j.sample):
        assert i1.tobytes() == i2.tobytes() and v1.tobytes() == v2.tobytes()


@pytest.mark.parametrize("cap", [100, 1000])
def test_reservoir_sample_is_identical(sparse_files, cap):
    tr, _ = sparse_files
    s_t, n_t, m_t = t_gbdt._reservoir_sample(tr, "libsvm", 1, 128, seed=3,
                                             cap=cap)
    s_j, n_j, m_j = j_gbdt._reservoir_sample(tr, "libsvm", 1, 128, seed=3,
                                             cap=cap)
    assert (n_t, m_t) == (n_j, m_j) and len(s_t) == len(s_j) == min(cap, 800)
    for (i1, v1), (i2, v2) in zip(s_t, s_j):
        assert i1.tobytes() == i2.tobytes() and v1.tobytes() == v2.tobytes()
    np.testing.assert_array_equal(t_gbdt._densify_sample(s_t, m_t + 1),
                                  j_gbdt._densify_sample(s_j, m_j + 1))


def test_densify_is_identical(sparse_files):
    tr, _ = sparse_files
    bt = next(iter(TIter(tr, minibatch_size=300)))
    bj = next(iter(JIter(tr, minibatch_size=300)))
    for dim in (40, 25):   # 25: features at or above dim are dropped
        np.testing.assert_array_equal(t_gbdt._densify(bt, dim),
                                      j_gbdt._densify(bj, dim))


def test_iter_rowblocks_matches_jax_on_one_part(sparse_files):
    tr, _ = sparse_files
    got = list(iter_rowblocks(tr, 1, "libsvm", 300))
    want = list(j_iter_rowblocks(tr, 1, "libsvm", 300))
    assert [b.size for b in got] == [b.size for b in want] == [300, 300, 200]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.index, b.index)
        np.testing.assert_array_equal(a.offset, b.offset)


def test_iter_parts_takes_parts_in_file_order(tmp_path):
    for name in ("b.libsvm", "a.libsvm"):
        (tmp_path / name).write_text(synth_libsvm_text(n_rows=50, seed=1))
    pattern = str(tmp_path / r".*\.libsvm")
    parts = [(os.path.basename(f.filename), f.part, f.num_parts, f.format)
             for f in iter_parts(pattern, 2, "libsvm")]
    assert parts == [("a.libsvm", 0, 2, "libsvm"), ("a.libsvm", 1, 2, "libsvm"),
                     ("b.libsvm", 0, 2, "libsvm"), ("b.libsvm", 1, 2, "libsvm")]
    runs = [np.concatenate([b.label for b in iter_rowblocks(pattern, 2)])
            for _ in range(2)]
    assert runs[0].size == 100
    np.testing.assert_array_equal(runs[0], runs[1])
    with pytest.raises(FileNotFoundError):
        list(iter_parts(str(tmp_path / "none"), 1))


def test_load_dataset_matches_jax(sparse_files):
    tr, va = sparse_files
    lt = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(max_bin=32, minibatch=256),
                            device="cpu")
    lj = j_gbdt.GbdtLearner(j_gbdt.GbdtConfig(max_bin=32, minibatch=256))
    for path in (tr, va):   # the second load reuses the first's edges
        dt, dj = lt.load_dataset(path), lj.load_dataset(path)
        assert dt.num_real == dj.num_real
        n = dt.num_real
        assert dt.binned.dtype == torch.uint8 and dt.binned.shape[0] == n
        np.testing.assert_array_equal(dt.binned.numpy(),
                                      np.asarray(dj.binned)[:n])
        np.testing.assert_array_equal(dt.label.numpy(),
                                      np.asarray(dj.label)[:n])
        assert dt.mask.numpy().all()
    assert lt.cfg.dim == lj.cfg.dim
    assert lt.edges.tobytes() == lj.edges.tobytes()


def test_synth_higgs_is_the_bench_recipe():
    X, y = synth_higgs(np.random.default_rng(3), 1000, 28)
    rng = np.random.default_rng(3)
    Xb = rng.standard_normal((1000, 28)).astype(np.float32)
    yb = (Xb[:, :4].sum(axis=1) + 0.5 * rng.standard_normal(1000) > 0)
    np.testing.assert_array_equal(X, Xb)
    np.testing.assert_array_equal(y, yb.astype(np.float32))
    assert X.dtype == y.dtype == np.float32


# ------------------------------------------------------ learner vs JAX
@pytest.mark.parametrize("j_hist", ["xla", "mxu"])
@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_learner_matches_jax(tmp_path, capsys, objective, j_hist):
    train = _dense_file(tmp_path / "tr.libsvm", objective, seed=11)
    val = _dense_file(tmp_path / "va.libsvm", objective, seed=12, n=1024)
    kw = dict(train_data=train, eval_data=val, eval_train=1, max_depth=4,
              num_round=3, eta=0.3, max_bin=32, min_child_weight=16.0,
              objective=objective,
              base_score=0.5 if objective == "binary:logistic" else 0.0)
    lt = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(**kw), device="cpu")
    last_t = lt.fit()
    rows_t = _rows(capsys.readouterr().out)
    lj = j_gbdt.GbdtLearner(j_gbdt.GbdtConfig(hist_kernel=j_hist, **kw))
    last_j = lj.fit()
    rows_j = _rows(capsys.readouterr().out)
    assert lt.trees["is_split"].sum() > 20   # real trees, not stumps
    _assert_trees_close(lt.trees, lj.trees)
    _assert_rows_close(rows_t, rows_j)
    assert len(rows_t) == 3
    assert list(last_t) == list(last_j) == ["test", "train"]
    for name in last_t:
        assert list(last_t[name]) == list(last_j[name])
        for k in last_t[name]:
            assert abs(last_t[name][k] - last_j[name][k]) <= 1e-4
    mt = lt.predict_margin(lt.load_dataset(val))
    mj = lj.predict_margin(lj.load_dataset(val))
    assert mt.shape == mj.shape == (1024,)
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lt.predict_margin(lt.load_dataset(val), 1),
                               lj.predict_margin(lj.load_dataset(val), 1),
                               rtol=1e-4, atol=1e-5)


def test_learner_matches_jax_on_sparse_rows(sparse_files, capsys):
    """Sparse 0-filled rows, default min_child_weight: structure and
    metric rows; leaf values to the looser atol 1e-4 (small leaves, see
    the module docstring)."""
    tr, va = sparse_files
    kw = dict(train_data=tr, eval_data=va, max_depth=4, num_round=5,
              eta=0.3, max_bin=32)
    lt = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(**kw), device="cpu")
    lt.fit()
    rows_t = _rows(capsys.readouterr().out)
    lj = j_gbdt.GbdtLearner(j_gbdt.GbdtConfig(hist_kernel="xla", **kw))
    lj.fit()
    _assert_rows_close(rows_t, _rows(capsys.readouterr().out))
    for k in STRUCT:
        np.testing.assert_array_equal(lt.trees[k], lj.trees[k])
    np.testing.assert_allclose(lt.trees["leaf_value"], lj.trees["leaf_value"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("hist_kernel", ["auto", "mxu", "xla"])
def test_hist_kernel_values_agree_on_cpu(sparse_files, hist_kernel):
    """On the CPU every value reaches the plain version: `xla` and `auto`
    by choice, `mxu` through the wrapper, which runs its plain version
    for CPU tensors."""
    tr, _ = sparse_files
    kw = dict(train_data=tr, max_depth=3, num_round=2, max_bin=32)
    ref = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(hist_kernel="xla", **kw),
                             device="cpu")
    ref.fit(verbose=False)
    lrn = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(hist_kernel=hist_kernel, **kw),
                             device="cpu")
    assert lrn._use_kernel() == (hist_kernel == "mxu")
    lrn.fit(verbose=False)
    for k in ref.trees:
        np.testing.assert_array_equal(lrn.trees[k], ref.trees[k])


def test_config_matches_jax_fields_and_defaults():
    import dataclasses

    ft = {f.name: f.default for f in dataclasses.fields(t_gbdt.GbdtConfig)}
    fj = {f.name: f.default for f in dataclasses.fields(j_gbdt.GbdtConfig)}
    assert ft == fj
    with pytest.raises(ValueError, match="hist_kernel"):
        t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(hist_kernel="pallas"),
                           device="cpu")
    with pytest.raises(NotImplementedError):
        t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(booster="gblinear"),
                           device="cpu")
    with pytest.raises(NotImplementedError):
        t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(dsplit="col"), device="cpu")


# ------------------------------------------- split math on its own feet
def _brute_force_stump(binned, g, h, lam, gamma, mcw, max_bin):
    G, H = g.sum(), h.sum()
    best = (-np.inf, 0, 0)
    for f in range(binned.shape[1]):
        for b in range(max_bin - 1):
            left = binned[:, f] <= b
            GL, HL = g[left].sum(), h[left].sum()
            GR, HR = G - GL, H - HL
            if HL < mcw or HR < mcw:
                continue
            gain = 0.5 * (GL * GL / (HL + lam) + GR * GR / (HR + lam)
                          - G * G / (H + lam)) - gamma
            if gain > best[0]:
                best = (gain, f, b)
    return best


def test_stump_matches_brute_force(tmp_path):
    rng = np.random.default_rng(3)
    n, F = 512, 6
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 2] + 0.3 * X[:, 4] + 0.1 * rng.normal(size=n) > 0).astype(int)
    train = tmp_path / "t.libsvm"
    train.write_text(_dense_text(X, y.astype(np.float32)))
    cfg = t_gbdt.GbdtConfig(train_data=str(train), max_depth=1, num_round=1,
                            eta=1.0, gamma=0.0, min_child_weight=1.0,
                            reg_lambda=1.0, max_bin=32)
    lrn = t_gbdt.GbdtLearner(cfg, device="cpu")
    lrn.fit(verbose=False)
    binned = lrn.load_dataset(str(train)).binned.numpy()
    g = 0.5 - y.astype(np.float64)   # base margin 0 -> g = 0.5 - y, h = .25
    h = np.full(n, 0.25)
    gain, bf, bb = _brute_force_stump(binned, g, h, 1.0, 0.0, 1.0, 32)
    assert gain > 0
    assert int(lrn.trees["split_feat"][0][0]) == bf
    assert int(lrn.trees["split_bin"][0][0]) == bb
    left = binned[:, bf] <= bb
    for node, m in ((1, left), (2, ~left)):
        expect = -g[m].sum() / (h[m].sum() + 1.0)
        assert lrn.trees["leaf_value"][0][node] == pytest.approx(expect,
                                                                 rel=1e-4)


def test_pure_leaf_when_no_gain(tmp_path):
    train = tmp_path / "c.libsvm"
    train.write_text("\n".join("1 0:1 1:2" for _ in range(64)) + "\n")
    cfg = t_gbdt.GbdtConfig(train_data=str(train), max_depth=3, num_round=1,
                            eta=1.0, gamma=0.0)
    lrn = t_gbdt.GbdtLearner(cfg, device="cpu")
    lrn.fit(verbose=False)
    assert not lrn.trees["is_split"][0].any()
    assert lrn.trees["leaf_value"][0][0] != 0.0


def test_zero_lambda_and_child_weight_mask_before_argmax(tmp_path):
    """reg_lambda=0 and min_child_weight=0 put 0/0 into the gains of empty
    sides (masked before the argmax) and into the leaf of an empty node.
    The first tree matches the JAX learner's. Only the first: the JAX
    package's one-hot leaf lookup multiplies that NaN leaf, which no row
    reaches, into every row's margin, so its second round is all NaN; the
    port's gather reads only the leaf a row is in and stays finite."""
    train = _dense_file(tmp_path / "z.libsvm", "binary:logistic", seed=5,
                        n=512, F=3)
    kw = dict(train_data=train, max_depth=2, max_bin=16, reg_lambda=0.0,
              min_child_weight=0.0)
    lt = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(num_round=2, **kw),
                            device="cpu")
    lt.fit(verbose=False)
    lj = j_gbdt.GbdtLearner(j_gbdt.GbdtConfig(num_round=1, hist_kernel="xla",
                                              **kw))
    lj.fit(verbose=False)
    assert np.isnan(lj.trees["leaf_value"][0]).any()   # the case is live
    for k in STRUCT:
        np.testing.assert_array_equal(lt.trees[k][0], lj.trees[k][0])
    np.testing.assert_allclose(lt.trees["leaf_value"][0],
                               lj.trees["leaf_value"][0], rtol=0, atol=1e-5,
                               equal_nan=True)
    assert lt.trees["is_split"][1].any()
    assert np.isfinite(lt.predict_margin(lt.load_dataset(train))).all()


def test_routing_invariant_validator(sparse_files, monkeypatch):
    tr, _ = sparse_files
    monkeypatch.setenv("WORMHOLE_DEBUG", "1")
    calls = []
    real = t_gbdt.validate_routing
    monkeypatch.setattr(t_gbdt, "validate_routing",
                        lambda tree, node: (calls.append(1),
                                            real(tree, node)))
    cfg = t_gbdt.GbdtConfig(train_data=tr, max_depth=3, num_round=3, eta=0.5,
                            max_bin=32)
    t_gbdt.GbdtLearner(cfg, device="cpu").fit(verbose=False)
    assert len(calls) == 3   # once a round, and it did not trip
    # adversarial: node 2 did NOT split, yet a row lands in its child 5
    tree = {"is_split": torch.zeros(15, dtype=torch.bool)}
    tree["is_split"][0] = tree["is_split"][1] = True
    node = torch.tensor([3, 4, 5], dtype=torch.int32)
    with pytest.raises(AssertionError, match="non-split"):
        real(tree, node)
    tree["is_split"][2] = True
    real(tree, node)
    real({"is_split": tree["is_split"].numpy()}, node.numpy())


# ----------------------------------------------- persistence, both ways
def test_model_in_continuation(sparse_files, tmp_path):
    tr, _ = sparse_files
    m1, m2 = str(tmp_path / "m1"), str(tmp_path / "m2")
    base = dict(train_data=tr, max_depth=3, eta=0.5, max_bin=32)
    C, L = t_gbdt.GbdtConfig, t_gbdt.GbdtLearner
    L(C(num_round=2, model_out=m1, **base), device="cpu").fit(verbose=False)
    L(C(num_round=2, model_in=m1, model_out=m2, **base),
      device="cpu").fit(verbose=False)
    ref = L(C(num_round=4, **base), device="cpu")
    ref.fit(verbose=False)
    cont = L(C(), device="cpu")
    cont.load(m2)
    assert cont.cfg.num_round == 4
    for k in ref.trees:
        np.testing.assert_allclose(cont.trees[k], ref.trees[k], atol=1e-5)


def test_save_period_writes_intermediate(sparse_files, tmp_path):
    tr, _ = sparse_files
    model = str(tmp_path / "m")
    cfg = t_gbdt.GbdtConfig(train_data=tr, max_depth=2, num_round=4,
                            save_period=2, model_out=model, max_bin=32)
    t_gbdt.GbdtLearner(cfg, device="cpu").fit(verbose=False)
    assert os.path.exists(model + ".0002.npz")
    assert os.path.exists(model + ".0004.npz")
    assert os.path.exists(model + ".npz")
    with np.load(model + ".0002.npz") as z:
        assert int(z["num_round"]) == 2 and z["leaf_value"].shape[0] == 2


def _blocks(path):
    bt = TRowBlock.concat(list(TIter(path, minibatch_size=10000)))
    bj = JRowBlock.concat(list(JIter(path, 0, 1, "libsvm",
                                     minibatch_size=10000)))
    return bt, bj


@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_jax_model_file_loads_in_port(sparse_files, tmp_path, objective):
    tr, va = sparse_files
    model = str(tmp_path / "jm")
    lj = j_gbdt.GbdtLearner(j_gbdt.GbdtConfig(
        train_data=tr, max_depth=3, num_round=3, eta=0.5, max_bin=32,
        objective=objective, base_score=0.3, model_out=model,
        hist_kernel="xla"))
    lj.fit(verbose=False)
    lt = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(), device="cpu")
    lt.load(model)
    assert (lt.cfg.dim, lt.cfg.max_depth, lt.cfg.num_round) == (
        lj.cfg.dim, 3, 3)
    assert lt.cfg.objective == objective and lt.cfg.base_score == 0.3
    for k in lj.trees:
        np.testing.assert_array_equal(lt.trees[k], lj.trees[k])
    bt, bj = _blocks(va)
    np.testing.assert_allclose(lt.predict_blk(bt), lj.predict_blk(bj),
                               rtol=1e-4, atol=1e-5)


def test_port_model_file_loads_in_jax(sparse_files, tmp_path):
    tr, va = sparse_files
    model = str(tmp_path / "tm")
    lt = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(
        train_data=tr, max_depth=3, num_round=3, eta=0.5, max_bin=32,
        model_out=model), device="cpu")
    lt.fit(verbose=False)
    with np.load(model + ".npz") as z:
        assert sorted(z.files) == sorted(
            ["edges", "num_round", "dim", "max_depth", "objective",
             "base_score", "split_feat", "split_bin", "is_split",
             "leaf_value"])
    lj = j_gbdt.GbdtLearner(j_gbdt.GbdtConfig())
    lj.load(model)
    for k in lt.trees:
        np.testing.assert_array_equal(lj.trees[k], lt.trees[k])
    bt, bj = _blocks(va)
    p_t, p_j = lt.predict_blk(bt), lj.predict_blk(bj)
    assert p_t.shape == (400,) and ((p_t > 0) & (p_t < 1)).all()
    np.testing.assert_allclose(p_t, p_j, rtol=1e-4, atol=1e-5)


def _model_arrays(sparse_files, tmp_path):
    tr, _ = sparse_files
    model = str(tmp_path / "m")
    t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(
        train_data=tr, max_depth=2, num_round=2, max_bin=32,
        model_out=model), device="cpu").fit(verbose=False)
    with np.load(model + ".npz") as z:
        return {k: z[k] for k in z.files}


def test_interop_loads_model_arrays(sparse_files, tmp_path):
    arrays = _model_arrays(sparse_files, tmp_path)
    st = interop.gbdt_state_from_numpy(arrays)
    assert st["num_round"] == 2 and st["max_depth"] == 2
    assert st["objective"] == "binary:logistic"
    assert st["trees"]["leaf_value"].shape == (2, 7)
    lrn = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(), device="cpu")
    interop.load_gbdt_state(lrn, arrays)
    assert lrn.cfg.dim == int(arrays["dim"]) and lrn.cfg.num_round == 2
    np.testing.assert_array_equal(lrn.edges, arrays["edges"])


@pytest.mark.parametrize("fault", ["missing", "extra", "tree_shape",
                                   "tree_dtype", "edges_rows", "edges_dtype",
                                   "feat_range"])
def test_interop_rejects(sparse_files, tmp_path, fault):
    a = _model_arrays(sparse_files, tmp_path)
    if fault == "missing":
        del a["is_split"]
    elif fault == "extra":
        a["w"] = np.zeros(3, np.float32)
    elif fault == "tree_shape":
        a["leaf_value"] = a["leaf_value"][:, :-1]
    elif fault == "tree_dtype":
        a["split_feat"] = a["split_feat"].astype(np.int64)
    elif fault == "edges_rows":
        a["edges"] = a["edges"][:-1]
    elif fault == "edges_dtype":
        a["edges"] = a["edges"].astype(np.float64)
    else:
        a["split_feat"] = a["split_feat"] + int(a["dim"])
    with pytest.raises(ValueError):
        interop.gbdt_state_from_numpy(a)
    lrn = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(), device="cpu")
    with pytest.raises(ValueError):
        interop.load_gbdt_state(lrn, a)
    assert lrn.edges is None   # nothing was half loaded


# ------------------------------------------------------------- reducer
@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_identity_reducer_gives_the_same_trees(sparse_files, capsys,
                                               objective):
    tr, va = sparse_files
    kw = dict(train_data=tr, eval_data=va, eval_train=1, max_depth=3,
              num_round=3, max_bin=32, objective=objective)
    ref = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(**kw), device="cpu")
    last_ref = ref.fit()
    rows_ref = _rows(capsys.readouterr().out)
    seen = []

    def identity(a):
        assert isinstance(a, np.ndarray)
        seen.append(a.shape)
        return a.copy()

    lrn = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(**kw), device="cpu")
    lrn.reducer = identity
    last = lrn.fit()
    rows = _rows(capsys.readouterr().out)
    for k in ref.trees:
        np.testing.assert_array_equal(lrn.trees[k], ref.trees[k])
    F, B = lrn.cfg.dim, 32
    n_metric = 3 if objective == "binary:logistic" else 2
    per_round = [(2, 1, F, B), (2, 1, F, B), (2, 2, F, B), (2, 4),
                 (n_metric,), (n_metric,)]
    assert seen == per_round * 3
    # the reduced metrics have no AUC; the others match the local ones
    want = (["error", "logloss"] if objective == "binary:logistic"
            else ["rmse"])
    for name in ("test", "train"):
        assert list(last[name]) == want
        for k in want:
            assert abs(last[name][k] - last_ref[name][k]) <= 1e-6
    assert all("auc" not in k for row in rows for k, _ in row)
    assert len(rows) == len(rows_ref) == 3


def test_on_round_and_r0_replay(sparse_files):
    """fit_prepared with r0: the first r0 trees are kept and replayed into
    the margins, later rounds grow as in one straight run; on_round fires
    once per grown round."""
    tr, va = sparse_files
    kw = dict(train_data=tr, max_depth=3, num_round=4, max_bin=32)
    ref = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(**kw), device="cpu")
    ref.fit(verbose=False)
    lrn = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(**kw), device="cpu")
    lrn.edges = ref.edges
    lrn.cfg.dim = ref.cfg.dim
    train, held = lrn.load_dataset(tr), lrn.load_dataset(va)
    for k in lrn.trees:
        lrn.trees[k][:2] = ref.trees[k][:2]
    fired = []
    last = lrn.fit_prepared(train, [("test", held), ("train", train)], r0=2,
                            verbose=False, on_round=fired.append)
    assert fired == [2, 3]
    for k in ref.trees:
        np.testing.assert_allclose(lrn.trees[k], ref.trees[k], atol=1e-6)
    want = ref._metrics(torch.from_numpy(ref.predict_margin(held)), held)
    for k, v in want.items():
        assert abs(last["test"][k] - v) <= 1e-6


# ----------------------------------------------------------------- app
def test_app_matches_jax_app(sparse_files, tmp_path, capsys):
    tr, va = sparse_files
    args = [f"train_data={tr}", f"eval_data={va}", "eval_train=1",
            "max_depth=3", "num_round=3", "eta=0.5", "max_bin=32",
            "hist_kernel=xla"]
    mt, mj = str(tmp_path / "mt"), str(tmp_path / "mj")
    assert t_app.main(args + [f"model_out={mt}", "device=cpu"]) == 0
    out_t = capsys.readouterr().out
    assert j_app.main(args + [f"model_out={mj}"]) == 0
    out_j = capsys.readouterr().out
    _assert_rows_close(_rows(out_t), _rows(out_j))
    assert f"saved model to {mt}" in out_t
    pt, pj = str(tmp_path / "pt.txt"), str(tmp_path / "pj.txt")
    assert t_app.main(["task=pred", f"model_in={mt}", f"test_data={va}",
                       f"pred_out={pt}", "device=cpu"]) == 0
    assert "wrote 400 predictions" in capsys.readouterr().out
    assert j_app.main(["task=pred", f"model_in={mj}", f"test_data={va}",
                       f"pred_out={pj}"]) == 0
    lines_t, lines_j = (open(p).read().split() for p in (pt, pj))
    assert len(lines_t) == len(lines_j) == 400
    np.testing.assert_allclose(np.array(lines_t, float),
                               np.array(lines_j, float), rtol=1e-4, atol=1e-5)


def test_app_reads_a_conf_file(sparse_files, tmp_path, capsys):
    tr, _ = sparse_files
    conf = tmp_path / "gbdt.conf"
    conf.write_text(f"train_data = {tr}\nmax_depth = 2\nnum_round = 1\n"
                    "max_bin = 32\neval_train = 1\n")
    assert t_app.main([str(conf), "num_round=2", "device=cpu"]) == 0
    assert len(_rows(capsys.readouterr().out)) == 2


@pytest.mark.parametrize("key", ["global_mesh", "bsp"])
def test_app_refuses_multi_process_modes(sparse_files, key, monkeypatch,
                                         tmp_path):
    """global_mesh=1 without a launcher role runs in one process, as the
    JAX app does (its maybe_run_global returns None without a role); a
    bsp=1 worker refuses what the JAX app's refuses: a warm start and
    task=pred."""
    tr, _ = sparse_files
    if key == "global_mesh":
        out = tmp_path / "gm.npz"
        assert t_app.main([f"train_data={tr}", f"{key}=1", "device=cpu",
                           "num_round=1", "max_depth=2",
                           f"model_out={out}"]) == 0
        assert out.exists()
        return
    with bsp_worker_role(monkeypatch):
        with pytest.raises(NotImplementedError, match="model_in"):
            t_app.main([f"train_data={tr}", "bsp=1", "device=cpu",
                        f"model_in={tmp_path}/m.npz"])
    with bsp_worker_role(monkeypatch):
        with pytest.raises(ValueError, match="task=train"):
            t_app.main([f"train_data={tr}", "bsp=1", "device=cpu",
                        "task=pred"])


def test_bsp_worker_of_one_rank_trains_as_one_process(sparse_files,
                                                      monkeypatch, tmp_path,
                                                      capsys):
    """The app's bsp=1 worker body under a launcher role, a ring of one
    rank: the sketch through the blob channel, the rank's parts parsed
    into its dataset, every level's block and the metric sums through
    the ring, a version checkpoint a round. One rank's ring returns its
    own sums, so the model equals the single-process app's bit for bit,
    and the checkpoint holds every round's trees."""
    tr, va = sparse_files
    args = [f"train_data={tr}", f"eval_data={va}", "max_depth=3",
            "num_round=3", "max_bin=32", "device=cpu", "bsp=1"]
    one, bsp = tmp_path / "one.npz", tmp_path / "bsp.npz"
    assert t_app.main(args + [f"model_out={one}"]) == 0
    with bsp_worker_role(monkeypatch) as sched:
        monkeypatch.setenv("WH_SNAPSHOT_DIR", str(tmp_path))
        assert t_app.main(args + [f"model_out={bsp}"]) == 0
        assert sched.has_blob("gbdt_bsp_meta")
    out = capsys.readouterr().out
    assert "[bsp-worker] " in out and "final test: error=" in out
    a, b = np.load(one), np.load(bsp)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k
    st = np.load(tmp_path / "bsp_rank0.npz")
    assert int(st["round"]) == 3 and int(st["__version"]) == 3
    np.testing.assert_array_equal(st["split_feat"], a["split_feat"])


def test_default_device_is_cuda(sparse_files):
    tr, _ = sparse_files
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_gbdt.GbdtLearner(t_gbdt.GbdtConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        t_app.main([f"train_data={tr}", "num_round=1"])


# --------------------------------------- the card's fixed-point sums
# On the card level_hist sums in 64-bit fixed point (csrc/hist.cu), and
# the learner's last-level totals sum the same way (ops/hist.py
# level_totals) on every device. level_hist_fixed_plain is the kernel's
# rule in plain ops; with it under the learner the CPU grows the trees
# the card grows.
@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_learner_with_the_kernels_fixed_point_matches_jax(tmp_path,
                                                          monkeypatch,
                                                          objective):
    monkeypatch.setattr(t_gbdt, "level_hist", t_hist.level_hist_fixed_plain)
    train = _dense_file(tmp_path / "tr.libsvm", objective, seed=11)
    kw = dict(train_data=train, max_depth=4, num_round=3, eta=0.3,
              max_bin=32, min_child_weight=16.0, objective=objective,
              base_score=0.5 if objective == "binary:logistic" else 0.0)
    lt = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(hist_kernel="mxu", **kw),
                            device="cpu")
    assert lt._use_kernel()
    lt.fit(verbose=False)
    lj = j_gbdt.GbdtLearner(j_gbdt.GbdtConfig(hist_kernel="xla", **kw))
    lj.fit(verbose=False)
    assert lt.trees["is_split"].sum() > 20
    _assert_trees_close(lt.trees, lj.trees)


def test_learner_with_the_kernels_fixed_point_is_order_free(monkeypatch):
    """Every sum of a round is then an exact integer sum (the level
    histograms and the last level's totals): the same rows in another
    order grow the same trees bit for bit, as the card does from call to
    call and a respawned BSP worker does."""
    monkeypatch.setattr(t_gbdt, "level_hist", t_hist.level_hist_fixed_plain)
    rng = np.random.default_rng(17)
    X, y = synth_higgs(rng, 6000, 8)
    edges = t_gbdt.quantile_edges(X, 32)
    binned = t_gbdt.bin_matrix(X, edges)
    trees = []
    for p in (np.arange(6000), rng.permutation(6000), rng.permutation(6000)):
        lrn = t_gbdt.GbdtLearner(t_gbdt.GbdtConfig(
            dim=8, max_depth=5, num_round=3, eta=0.3, max_bin=32,
            hist_kernel="mxu"), device="cpu")
        lrn.edges = edges
        lrn.fit_prepared(t_gbdt.BinnedDataset(
            binned=torch.from_numpy(np.ascontiguousarray(binned[p])),
            label=torch.from_numpy(np.ascontiguousarray(y[p])),
            mask=torch.ones(6000), num_real=6000), [], verbose=False)
        trees.append(lrn.trees)
    assert trees[0]["is_split"].sum() > 20
    for other in trees[1:]:
        for k in trees[0]:
            assert np.array_equal(other[k], trees[0][k]), k
