"""The port's device mesh against the JAX package's, on the CPU.

The JAX side runs here on conftest.py's 8 host devices, its COO kernels
in Pallas interpret mode (kernel="pallas", kernel_dtype="f32"), as
tests/test_coo_mesh.py runs them. The port's side runs as gloo ranks in
separate processes (tests/torch_mesh_ranks.py, which imports no JAX); the
inputs reach them as files. Each launch has its own timeout (120 s, the
app under torch.distributed.run 180 s), so a hung rank fails its test.

Bars, the JAX package's own: pack_mesh_coo array for array with equal
dropped_nnz; the mesh products at rtol 2e-5 / atol 1e-5
(tests/test_coo_mesh.py); linear FTRL on 2x2 per-batch logloss at rtol
1e-4, tables at rtol 1e-4 / atol 1e-6, predict at rtol 1e-4 / atol 1e-5,
and a data rank's copy of a model shard equal to the other's bit for bit;
the port's 2x2 against its own 1x1 as tests/test_linear.py holds the JAX
mesh (logloss and AUC within 1e-3, w at rtol 1e-3 / atol 1e-5); GBDT on
4x1 with the JAX package's trees, leaves within 1e-5 and train AUC within
1e-6.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_mesh_ranks as ranks
from conftest import synth_libsvm_text
from wormhole_tpu.data.minibatch import MinibatchIter as JIter
from wormhole_tpu.models.gbdt import GbdtConfig as JGConfig
from wormhole_tpu.models.gbdt import GbdtLearner as JGLearner
from wormhole_tpu.models.linear import LinearConfig as JLConfig
from wormhole_tpu.models.linear import LinearLearner as JLLearner
from wormhole_tpu.ops import coo_kernels as jck
from wormhole_tpu.parallel.mesh import make_mesh as j_make_mesh
from wormhole_tpu.utils import checkpoint as j_ckpt
from wormhole_tpu_torch.apps import lbfgs_fm as t_lbfgs_fm_app
from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
from wormhole_tpu_torch.ops import coo_kernels as ck
from wormhole_tpu_torch.parallel import collectives
from wormhole_tpu_torch.parallel import mesh as tmesh
from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver
from wormhole_tpu_torch.utils import checkpoint as t_ckpt

NB = 2 * ck.TILE  # one tile per model shard on a 2-wide model axis
ROWS = 256
MESHES = [(2, 2), (2, 1), (1, 2)]
LIN = dict(minibatch=ROWS, num_buckets=NB, nnz_per_row=16, algo="ftrl",
           lr_eta=0.5, lambda_l1=0.5, kernel="pallas", kernel_dtype="f32")


def _random_coo(rng, nnz, num_rows, num_buckets):
    idx = rng.integers(0, num_buckets, size=nnz).astype(np.int32)
    seg = np.sort(rng.integers(0, num_rows, size=nnz)).astype(np.int32)
    val = rng.normal(size=nnz).astype(np.float32)
    val[::17] = 0.0  # padding-like zeros, dropped before the split
    return idx, seg, val


def _mesh_file(workdir, job, shape):
    (workdir / f"{job}.mesh").write_text(json.dumps(list(shape)))


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("D,M", MESHES)
def test_pack_mesh_coo_matches_jax(D, M, overflow):
    rng = np.random.default_rng(7)
    nnz = 40000 if overflow else 3000
    idx, seg, val = _random_coo(rng, nnz, ROWS, NB)
    cap = ck.mesh_capacity(4096 if overflow else 8192, D, M)
    assert cap == jck.mesh_capacity(4096 if overflow else 8192, D, M)
    got = ck.pack_mesh_coo(idx, seg, val, NB, ROWS, D, M, cap)
    want = jck.pack_mesh_coo(idx, seg, val, NB, ROWS, D, M, cap)
    assert (got.dropped_nnz > 0) == overflow
    assert got.dropped_nnz == want.dropped_nnz
    for k in ("sidx", "sseg", "sval", "tmap", "first"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("D,M", MESHES)
def test_mesh_spmv_matches_jax(D, M, tmp_path):
    rng = np.random.default_rng(1)
    idx, seg, val = _random_coo(rng, 2000, ROWS, NB)
    w = rng.normal(size=NB).astype(np.float32)
    d = rng.normal(size=ROWS).astype(np.float32)
    cap = ck.mesh_capacity(4096, D, M)
    mc = jck.pack_mesh_coo(idx, seg, val, NB, ROWS, D, M, cap)
    args = tuple(jnp.asarray(x) for x in
                 (mc.sidx, mc.sseg, mc.sval, mc.tmap, mc.first))
    mesh = j_make_mesh(D, M)
    j_xw = np.asarray(jck.mesh_coo_spmv(mesh, jnp.asarray(w), *args, ROWS))
    j_g = np.asarray(jck.mesh_coo_spmv_t(mesh, jnp.asarray(d), *args, NB))

    np.savez(tmp_path / "spmv.npz", idx=idx, seg=seg, val=val, w=w, d=d,
             num_buckets=NB, num_rows=ROWS, cap=cap)
    _mesh_file(tmp_path, "spmv", (D, M))
    outs = ranks.launch("spmv", D * M, tmp_path)
    # rank (d, m) holds rows of data shard d and buckets of model shard m
    xw = np.concatenate([outs[d * M]["xw"] for d in range(D)])
    g = np.concatenate([outs[m]["g"] for m in range(M)])
    for r, o in enumerate(outs):
        dd, mm = divmod(r, M)
        np.testing.assert_array_equal(o["xw"], outs[dd * M]["xw"])
        np.testing.assert_array_equal(o["g"], outs[mm]["g"])
        np.testing.assert_array_equal(o["xw"], o["xw_plain"])
        np.testing.assert_array_equal(o["g"], o["g_plain"])
        assert int(o["dropped"]) == 0
        # the collectives over one axis: rank r = d * M + m
        assert float(o["max_data"][0]) == (D - 1) * M + mm
        assert float(o["min_model"][0]) == dd * M
        assert float(o["bcast_data"][0]) == 10 * ((D - 1) * M + mm)
        np.testing.assert_array_equal(
            o["shards"], np.arange(D * 3, dtype=np.float32).reshape(D, 3)
            .sum(0))
    np.testing.assert_allclose(xw, j_xw, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(g, j_g, rtol=2e-5, atol=1e-5)
    want = np.zeros(ROWS, np.float32)
    np.add.at(want, seg, val * w[idx])
    np.testing.assert_allclose(xw, want, rtol=2e-5, atol=1e-5)


def _conf(path, train, extra=""):
    path.write_text(
        f"train_data = {train}\nminibatch = {ROWS}\nnum_buckets = {NB}\n"
        "nnz_per_row = 16\nalgo = ftrl\nlr_eta = 0.5\nlambda_l1 = 0.5\n"
        "kernel_dtype = f32\nmax_data_pass = 2\nnum_parts_per_file = 4\n"
        "max_concurrency = 3\n" + extra)
    return str(path)


@pytest.fixture(scope="module")
def linear_run(tmp_path_factory):
    """The JAX learner on a 2x2 mesh and the port's ranks on theirs, over
    the same batches; a checkpoint from each; the port's solver run."""
    wd = tmp_path_factory.mktemp("mesh_linear")
    path = wd / "t.libsvm"
    path.write_text(synth_libsvm_text(n_rows=512, n_feat=200, nnz_per_row=10,
                                      seed=3))
    solver_data = wd / "s.libsvm"
    solver_data.write_text(synth_libsvm_text(n_rows=2000, n_feat=300,
                                             nnz_per_row=12, seed=5))
    jl = JLLearner(JLConfig(**LIN), j_make_mesh(2, 2))
    assert jl.use_pallas and jl._mesh_coo
    j_progs = [jl.train_batch(b) for b in JIter(str(path), minibatch_size=ROWS)]
    j_pred = jl.predict_batch(next(iter(JIter(str(path),
                                              minibatch_size=ROWS))))
    j_ckpt.save_model(jl.store, str(wd / "jax_ckpt" / "m"))
    conf = _conf(wd / "lin.conf", solver_data)
    (wd / "linear.json").write_text(json.dumps(
        {"cfg": LIN, "path": str(path), "conf": conf}))
    _mesh_file(wd, "linear", (2, 2))
    outs = ranks.launch("linear", 4, wd)
    return {"wd": wd, "conf": conf, "solver_data": str(solver_data),
            "j_progs": j_progs, "j_tables": jl.store.to_numpy(),
            "j_pred": j_pred, "outs": outs}


def test_linear_2x2_matches_jax(linear_run):
    j, outs = linear_run, linear_run["outs"]
    o = outs[0]
    np.testing.assert_allclose(
        o["prog_logloss"], [p["logloss"] for p in j["j_progs"]], rtol=1e-4)
    np.testing.assert_allclose(o["prog_nex"], [p["nex"] for p in j["j_progs"]])
    np.testing.assert_allclose(
        o["prog_new_w"], [p["new_w"] for p in j["j_progs"]])
    for k, v in j["j_tables"].items():
        np.testing.assert_allclose(o[f"table_{k}"], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(o["predict"], j["j_pred"], rtol=1e-4,
                               atol=1e-5)


def test_linear_2x2_ranks_agree_bit_for_bit(linear_run):
    """Every rank reports the same progress, tables and predictions; the
    two data ranks' copies of each model shard are equal bit for bit and
    are the whole table's slice; the pack token names the rank's cell."""
    outs = linear_run["outs"]
    for r, o in enumerate(outs):
        d, m = divmod(r, 2)
        for k in o:
            if not k.startswith(("shard_", "interop_", "token")):
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
        for k in ("w", "z", "n"):
            np.testing.assert_array_equal(o[f"shard_{k}"],
                                          outs[m][f"shard_{k}"])
            np.testing.assert_array_equal(
                o[f"shard_{k}"], o[f"table_{k}"][m * ck.TILE:(m + 1) * ck.TILE])
        np.testing.assert_array_equal(o["token_mesh"], [2, 2, d, m])
    assert int(outs[0]["nnz"]) == int(np.count_nonzero(outs[0]["table_w"]))


def test_linear_2x2_matches_port_1x1(linear_run, monkeypatch):
    """The solver on the 2x2 mesh (4 parts, 3 loaders a rank, taken in
    part order) against the port on one device with one loader."""
    monkeypatch.setenv("WH_NUM_LOADERS", "1")
    from wormhole_tpu_torch.config import load_config

    cfg = load_config(LinearConfig, conf_file=linear_run["conf"], argv=[])
    one = LinearLearner(cfg, device="cpu")
    assert not one._mesh_coo
    res = MinibatchSolver(one, cfg, verbose=False).run()["train"]
    o = linear_run["outs"][0]
    assert abs(res.mean("logloss") - float(o["solver_logloss"])) < 1e-3
    assert abs(res.mean("auc") - float(o["solver_auc"])) < 1e-3
    mesh_w = t_ckpt.load_parts(str(linear_run["wd"] / "lib" / "m"))["w"]
    np.testing.assert_allclose(mesh_w, one.store.state["w"].numpy(),
                               rtol=1e-3, atol=1e-5)


def test_checkpoint_parts_read_across_packages(linear_run):
    """M = 2: the port's `_part-R` files, read by the JAX package's
    load_parts, give the port's tables; the JAX package's parts, loaded
    into the port's 2x2 learner, give the JAX tables."""
    wd, o = linear_run["wd"], linear_run["outs"][0]
    assert sorted(os.listdir(wd / "port_ckpt")) == ["m_part-0.npz",
                                                    "m_part-1.npz"]
    got = j_ckpt.load_parts(str(wd / "port_ckpt" / "m"))
    for k in ("w", "z", "n"):
        np.testing.assert_array_equal(got[k], o[f"table_{k}"])
        np.testing.assert_array_equal(o[f"loaded_{k}"],
                                      linear_run["j_tables"][k])
        # interop slices the JAX tables to each rank's model shard
        for r, orank in enumerate(linear_run["outs"]):
            m = r % 2
            np.testing.assert_array_equal(
                orank[f"interop_{k}"],
                linear_run["j_tables"][k][m * ck.TILE:(m + 1) * ck.TILE])
    assert sorted(os.listdir(wd / "lib")) == ["m_part-0.npz", "m_part-1.npz"]


def test_linear_app_under_torch_distributed_run(linear_run, tmp_path):
    """The linear app as four ranks of torch.distributed.run on the CPU,
    model_shards=2, writes the model parts of the library run on a
    spawned 2x2 mesh, bit for bit; only rank 0 prints progress rows."""
    conf = _conf(tmp_path / "app.conf", linear_run["solver_data"],
                 f"model_out = {tmp_path / 'app' / 'm'}\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ranks.ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "wormhole_tpu_torch.apps.linear",
         conf, "device=cpu", "model_shards=2"],
        capture_output=True, text=True, env=env, cwd=str(ranks.ROOT),
        timeout=180)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    app = t_ckpt.load_parts(str(tmp_path / "app" / "m"))
    lib = t_ckpt.load_parts(str(linear_run["wd"] / "lib" / "m"))
    assert sorted(os.listdir(tmp_path / "app")) == ["m_part-0.npz",
                                                    "m_part-1.npz"]
    for k in ("w", "z", "n"):
        np.testing.assert_array_equal(app[k], lib[k])
    # the progress header prints once a pass (rank 0 only), the pass line
    # on every rank
    assert out.stdout.count("#total_ex") == 2
    for r in range(4):
        assert f"[rank {r}] train pass 1:" in out.stdout


@pytest.fixture(scope="module")
def gbdt_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh_gbdt")
    tr, va = wd / "tr.libsvm", wd / "va.libsvm"
    tr.write_text(synth_libsvm_text(n_rows=4002, n_feat=40, nnz_per_row=12,
                                    seed=11))
    va.write_text(synth_libsvm_text(n_rows=999, n_feat=40, nnz_per_row=12,
                                    seed=12))
    # min_child_weight=16, as tests/test_torch_gbdt.py runs its parity:
    # a last-level leaf is its parent's total minus its sibling's, which
    # the JAX package sums in f32 and the port in f64, so on a leaf of a
    # few rows the two differ by more than 1e-5 (2.2e-5 here at 1)
    cfg = dict(train_data=str(tr), num_round=4, max_depth=3, minibatch=1024,
               eval_train=1, seed=3, num_parts_per_file=1,
               min_child_weight=16.0)
    jl = JGLearner(JGConfig(**cfg), j_make_mesh(4, 1))
    last = jl.fit(verbose=False)
    j_pred = jl.predict_margin(jl.load_dataset(str(va)))
    jl.save(str(wd / "jax_model"))
    (wd / "gbdt.json").write_text(json.dumps(
        {"cfg": cfg, "val": str(va), "jax_model": str(wd / "jax_model")}))
    _mesh_file(wd, "gbdt", (4, 1))
    return {"jl": jl, "last": last, "j_pred": j_pred,
            "outs": ranks.launch("gbdt", 4, wd)}


def test_gbdt_4x1_matches_jax(gbdt_run):
    """Rows sharded over 4 data ranks (4002 rows: the last rank's pad
    rows carry mask 0): the JAX package's trees, leaves within 1e-5,
    train AUC within 1e-6, predictions on held-out rows; every rank holds
    the same model."""
    jl, outs = gbdt_run["jl"], gbdt_run["outs"]
    o = outs[0]
    np.testing.assert_array_equal(o["edges"], jl.edges)
    for k in ("split_feat", "split_bin", "is_split"):
        np.testing.assert_array_equal(o[k], jl.trees[k], err_msg=k)
    np.testing.assert_allclose(o["leaf_value"], jl.trees["leaf_value"],
                               rtol=0, atol=1e-5)
    assert abs(float(o["train_auc"]) - gbdt_run["last"]["train"]["auc"]) \
        < 1e-6
    for k in ("error", "logloss"):
        assert abs(float(o[f"train_{k}"])
                   - gbdt_run["last"]["train"][k]) < 1e-5
    np.testing.assert_allclose(o["pred"], gbdt_run["j_pred"], rtol=1e-4,
                               atol=1e-5)
    # the JAX package's model file, read by the port's mesh learner
    np.testing.assert_allclose(o["jax_model_pred"], gbdt_run["j_pred"],
                               rtol=1e-5, atol=1e-6)
    assert o["pred"].shape == (999,)
    for other in outs[1:]:
        for k in o:
            np.testing.assert_array_equal(other[k], o[k], err_msg=k)


def test_make_mesh_needs_a_group_of_its_size():
    """A mesh of D*M > 1 never quietly becomes one device; 1x1 needs no
    group and keeps the single-device path."""
    with pytest.raises(AssertionError, match="needs 4 devices, have 1"):
        tmesh.make_mesh(2, 2, device="cpu")
    with pytest.raises(AssertionError, match="empty axis"):
        tmesh.make_mesh(num_model=2, device="cpu")
    one = tmesh.make_mesh(device="cpu")
    assert (one.shape, one.device_mesh, one.group("data")) == (
        {"data": 1, "model": 1}, None, None)
    assert tmesh.table_range(one, NB) == (0, NB)
    assert not LinearLearner(LinearConfig(**LIN), mesh=one)._mesh_coo


def test_make_mesh_backend_rules(tmp_path):
    """NCCL refuses two ranks on one GPU; a group whose backend is not the
    device's own must be asked for by name."""
    tmesh.check_distinct_devices("nccl", [0, 1, 2, 3])
    tmesh.check_distinct_devices("gloo", [0, 0, 0, 0])
    with pytest.raises(ValueError, match="ranks 0 and 2 are both on cuda:0"):
        tmesh.check_distinct_devices("nccl", [0, 1, 0, 1])
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="backend is gloo"):
            tmesh.make_mesh(device="cpu", backend="nccl")
        m = tmesh.make_mesh(device="cpu")
        assert m.backend == "gloo" and m.group("model") is not None
        x = torch.arange(3.0)
        assert torch.equal(collectives.gather_rows(x, m), x)
    finally:
        dist.destroy_process_group()


def test_xla_kind_on_a_mesh_raises(linear_run):
    """kernel=xla on the 2x2 mesh runs the same cells through the plain
    twins (it no longer raises) and equals the kernel route's run on the
    same batches (both f32: the cells' sums in another order, rtol 1e-5
    / atol 1e-6); kernel=pallas still refuses buckets that do not split
    into whole tiles."""
    o = linear_run["outs"][0]
    for k in ("w", "z", "n"):
        np.testing.assert_allclose(o[f"xla_table_{k}"], o[f"table_{k}"],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(o["xla_prog_logloss"], o["prog_logloss"],
                               rtol=1e-5)
    mesh = tmesh.Mesh(2, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="num_buckets % 131072"):
        LinearLearner(LinearConfig(**dict(LIN, num_buckets=ck.TILE)),
                      mesh=mesh)


def test_apps_without_a_mesh_refuse_ranks(monkeypatch, tmp_path):
    """lbfgs_fm takes no ranks of torch.distributed.run: the JAX app has
    no mesh or global body."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="takes no ranks"):
        t_lbfgs_fm_app.main([f"data={tmp_path / 'x'}", "device=cpu"])
