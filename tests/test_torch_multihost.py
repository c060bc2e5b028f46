"""The port's process-group layer (parallel/multihost.py, GroupComm) and
DiFacto on a (data x model) mesh, on the CPU.

The port's side runs as gloo ranks in separate processes
(tests/torch_mesh_ranks.py, which imports no JAX), each launch with its
own timeout (120 s). The JAX side runs here on conftest.py's 8 host
devices.

Bars: the scalars, seg offsets, replicated tables and GroupComm results
exactly; rank_parts and empty_rowblock equal to the JAX package's;
DiFacto 2x2 against the JAX DifactoLearner on make_mesh(2, 2) (its XLA
path, from the same tables) per batch logloss, AUC and objv_w within
1e-4 of the batch's rows, new_w and the admitted count equal, tables at
rtol 1e-4 / atol 1e-5 (tighter than tests/test_difacto.py:105-122's 1x1
against 4x2 bar, w rtol 1e-3 / atol 1e-4), predict at rtol 1e-4 / atol
1e-5, and each model shard equal bit for bit on its two data ranks;
kernel=xla on the 2x2 mesh against the kernels' route at rtol 1e-5 /
atol 1e-6;
k-means on 2 ranks against the port on one device from the same
centroids, cost within 1e-4 and centroids atol 1e-5 (the model file's
%.6g); L-BFGS linear on 2 ranks against one device, objective rtol 1e-4
and w rtol 1e-4 / atol 1e-6; the difacto app under torch.distributed.run
(4 ranks, model_shards=2) against the port's one-device solver run,
tables at rtol 1e-4 / atol 1e-5.
"""

import json
import os
import re
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from conftest import synth_libsvm_text
from wormhole_tpu.data.minibatch import MinibatchIter as JIter
from wormhole_tpu.models.difacto import DifactoConfig as JDConfig
from wormhole_tpu.models.difacto import DifactoLearner as JDLearner
from wormhole_tpu.parallel import multihost as jmh
from wormhole_tpu.parallel.mesh import make_mesh as j_make_mesh
from wormhole_tpu_torch.apps import kmeans as t_kmeans
from wormhole_tpu_torch.data.minibatch import MinibatchIter as TIter
from wormhole_tpu_torch.models.batch_objectives import (LinearObjFunction,
                                                        load_batches)
from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner
from wormhole_tpu_torch.ops import coo_kernels as ck
from wormhole_tpu_torch.parallel import multihost as mh
from wormhole_tpu_torch.runtime.tracker import Scheduler, SchedulerClient
from wormhole_tpu_torch.solver.lbfgs import LBFGSConfig, LBFGSSolver

DFM = dict(minibatch=256, num_buckets=2 * ck.TILE, v_buckets=4096,
           nnz_per_row=8, dim=4, threshold=2, lr_eta=0.5, V_lr_eta=0.2,
           V_init_scale=0.05, kernel_dtype="f32")


def _mesh_file(workdir, job, shape):
    (workdir / f"{job}.mesh").write_text(json.dumps(list(shape)))


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """k-means and L-BFGS linear on a 2-rank group, and multihost's
    collectives."""
    wd = tmp_path_factory.mktemp("group")
    for i in range(2):
        (wd / f"km-{i}.libsvm").write_text(synth_libsvm_text(
            n_rows=300, n_feat=60, nnz_per_row=8, seed=40 + i))
        (wd / f"lb-{i}.libsvm").write_text(synth_libsvm_text(
            n_rows=400, n_feat=120, nnz_per_row=10, seed=50 + i))
    spec = {"kmeans": dict(train_data=str(wd / "km-.*"), num_clusters=4,
                           max_iter=4, minibatch=256, nnz_per_row=16,
                           model_out=str(wd / "centroids.txt")),
            "lbfgs": dict(data=str(wd / "lb-.*"), max_lbfgs_iter=15,
                          reg_L2=0.001, minibatch=512,
                          model_out=str(wd / "lb_model.npz"))}
    (wd / "group.json").write_text(json.dumps(spec))
    _mesh_file(wd, "group", (2, 1))
    return {"wd": wd, "spec": spec, "outs": ranks.launch("group", 2, wd)}


def test_global_scalars_and_coo_batch(group_run):
    """global_scalar_sum / _max over the group; global_coo_batch moves a
    rank's seg into its row range and keeps idx, val, label and mask."""
    outs = group_run["outs"]
    for r, o in enumerate(outs):
        assert int(o["sum"]) == 30 and int(o["max"]) == -4
        np.testing.assert_array_equal(o["seg"][:4], np.array([0, 1, 1, 2])
                                      + 4 * r)
        np.testing.assert_array_equal(o["idx"][:4], [5, 6, 7, 8])
        np.testing.assert_array_equal(o["val"][:4], np.full(4, r + 1.0))
        assert (o["val"][4:] == 0).all()  # padding entries stay inert
        np.testing.assert_array_equal(o["label"], [1, 1, 1, 0])
        np.testing.assert_array_equal(o["mask"], [1, 1, 1, 0])


def test_replicated_tables_and_group_comm(group_run):
    """load_replicated installs whole tables on every rank (and refuses an
    unknown one), fetch_replicated and fetch_local_rows read them back;
    GroupComm sums and maxes host arrays over the group, shapes kept."""
    for o in group_run["outs"]:
        np.testing.assert_array_equal(o["w"], np.arange(16))
        np.testing.assert_array_equal(o["rows"], [2, 3, 4])
        assert int(o["refused"]) == 1
        np.testing.assert_array_equal(o["comm_sum"], [1.0, 3.0])
        assert float(o["comm_max"]) == 1.0 and o["comm_max"].shape == ()


def test_rank_parts_and_empty_block_match_jax(tmp_path):
    for i in range(3):
        (tmp_path / f"p-{i}.libsvm").write_text("1 1:1\n")
    pattern = str(tmp_path / "p-.*")
    for world in (1, 2, 3, 4):
        for nparts in (1, 2, 3):
            for rank in range(world):
                env = types.SimpleNamespace(rank=rank, num_workers=world)
                assert mh.rank_parts(pattern, nparts, env) == \
                    jmh.rank_parts(pattern, nparts, env)
    t, j = mh.empty_rowblock(), jmh.empty_rowblock()
    for k in ("label", "offset", "index"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype and a.shape == b.shape
    assert t.size == j.size == 0


def test_kmeans_on_two_ranks_matches_one_device(group_run):
    """The group's Lloyd iterations (each step's sums all-reduced) against
    the port on one device from the same initial centroids: rank 0's
    first local rows, drawn as the JAX global body draws them."""
    spec = group_run["spec"]["kmeans"]
    printed = str(group_run["outs"][0]["printed"])
    cost = float(re.search(r"final cosine objective: ([0-9.]+)",
                           printed).group(1))
    cfg = KmeansConfig(**{**spec, "model_out": None})
    lrn = KmeansLearner(cfg, device="cpu")
    env = types.SimpleNamespace(rank=0, num_workers=2)
    local = (blk for f, k in mh.rank_parts(cfg.train_data, 1, env)
             for blk in TIter(f, k, 1, minibatch_size=128, device="cpu"))
    lrn.centroids = torch.from_numpy(t_kmeans.init_rows(
        local, cfg.num_clusters, cfg.dim, cfg.seed))
    one = lrn.run(verbose=False)
    assert abs(cost - one) < 1e-4, (cost, one)
    np.testing.assert_allclose(np.loadtxt(spec["model_out"]),
                               lrn.centroids.numpy(), atol=1e-5)


def test_lbfgs_on_two_ranks_matches_one_device(group_run):
    spec = group_run["spec"]["lbfgs"]
    printed = str(group_run["outs"][0]["printed"])
    objv = float(re.search(r"final objective: ([0-9.]+)", printed).group(1))
    batches, nf = load_batches(spec["data"], minibatch=512, nnz_per_row=64,
                               device="cpu")
    obj = LinearObjFunction(batches, nf, "cpu")
    w, one = LBFGSSolver(obj, LBFGSConfig(max_iter=15, reg_l2=0.001)).run(
        verbose=False)
    assert abs(objv - one) / abs(one) < 1e-4, (objv, one)
    saved = np.load(spec["model_out"])
    assert int(saved["num_feature"]) == nf
    np.testing.assert_allclose(saved["w"], w.numpy(), rtol=1e-4, atol=1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_from_env_joins_a_tcp_group(tmp_path):
    """Two workers meet at tcp://WH_COORD_URI on gloo with device=cpu."""
    (tmp_path / "coord").write_text(f"127.0.0.1:{_free_port()}")
    _mesh_file(tmp_path, "init", (2, 1))
    outs = ranks.launch("init", 2, tmp_path)
    for r, o in enumerate(outs):
        assert (str(o["backend"]), str(o["device"])) == ("gloo", "cpu")
        assert (int(o["world"]), int(o["rank"])) == (2, r)


def test_init_from_env_needs_a_coordinator():
    env = types.SimpleNamespace(rank=0, num_workers=2, coord_uri="")
    with pytest.raises(RuntimeError, match="WH_COORD_URI"):
        mh.init_from_env(env, "cpu")
    assert mh.group_backend("cpu", 4) == ("gloo", torch.device("cpu"))


def test_exit_barrier_returns_when_a_peer_never_arrives():
    """Bounded: the survivor leaves the barrier at its timeout."""
    sched = Scheduler("127.0.0.1", 0, node_timeout=30.0)
    sched.serve()
    try:
        client = SchedulerClient(sched.uri, "worker-0")
        client.register()
        t = time.perf_counter()
        done = threading.Event()

        def leave():
            mh.exit_barrier(client, world=2, timeout=1.0)
            done.set()

        th = threading.Thread(target=leave, daemon=True)
        th.start()
        th.join(30)
        assert done.is_set() and time.perf_counter() - t < 20
    finally:
        sched.stop()


@pytest.fixture(scope="module")
def difacto_run(tmp_path_factory):
    """The JAX DifactoLearner on make_mesh(2, 2) (its XLA path) and the
    port's 2x2 ranks, from the JAX learner's initial tables, over the
    same batches for two passes."""
    wd = tmp_path_factory.mktemp("mesh_difacto")
    path = wd / "fm.libsvm"
    path.write_text(synth_libsvm_text(n_rows=768, n_feat=300, nnz_per_row=6,
                                      seed=21))
    jl = JDLearner(JDConfig(**DFM), j_make_mesh(2, 2), seed=3)
    np.savez(wd / "init.npz", **jl.ckpt_store.to_numpy())
    j_progs = []
    for ep in range(2):
        j_progs += [jl.train_batch(b) for b in JIter(
            str(path), minibatch_size=DFM["minibatch"], seed=ep)]
    blk = next(iter(JIter(str(path), minibatch_size=DFM["minibatch"])))
    (wd / "difacto.json").write_text(json.dumps(
        {"cfg": DFM, "path": str(path), "passes": 2}))
    _mesh_file(wd, "difacto", (2, 2))
    return {"j_progs": j_progs, "j_tables": jl.ckpt_store.to_numpy(),
            "j_pred": jl.predict_batch(blk), "j_eval": jl.eval_batch(blk),
            "j_nnz": jl.nnz(), "j_admitted": jl.num_admitted(),
            "outs": ranks.launch("difacto", 4, wd)}


def test_difacto_2x2_matches_jax(difacto_run):
    j, o = difacto_run, difacto_run["outs"][0]
    n = np.array([p["nex"] for p in j["j_progs"]])
    np.testing.assert_array_equal(o["prog_nex"], n)
    for k in ("logloss", "auc", "objv_w"):
        want = np.array([p[k] for p in j["j_progs"]])
        np.testing.assert_allclose(o[f"prog_{k}"] / n, want / n, rtol=0,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(o["prog_new_w"],
                                  [p["new_w"] for p in j["j_progs"]])
    for k, v in j["j_tables"].items():
        np.testing.assert_allclose(o[f"table_{k}"], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(o["predict"], j["j_pred"], rtol=1e-4,
                               atol=1e-5)
    assert abs(float(o["eval_logloss"]) - j["j_eval"]["logloss"]) \
        / j["j_eval"]["nex"] < 1e-4
    assert int(o["nnz"]) == j["j_nnz"]
    assert int(o["admitted"]) == j["j_admitted"] > 0


def test_difacto_2x2_shards_agree_bit_for_bit(difacto_run):
    """Every rank reports the same progress and tables; the two data
    ranks' copies of each model shard are equal bit for bit and are the
    whole table's slice (w tables over num_buckets, V over v_buckets)."""
    outs = difacto_run["outs"]
    rows = {"w": DFM["num_buckets"] // 2, "V": DFM["v_buckets"] // 2}
    for r, o in enumerate(outs):
        m = r % 2
        for k in o:
            if not k.startswith("shard_"):
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
        for k in ("w", "z", "n", "cnt", "V", "nV"):
            np.testing.assert_array_equal(o[f"shard_{k}"],
                                          outs[m][f"shard_{k}"])
            h = rows["V" if k in ("V", "nV") else "w"]
            np.testing.assert_array_equal(
                o[f"shard_{k}"], o[f"table_{k}"][m * h:(m + 1) * h])


def test_difacto_app_under_torch_distributed_run(tmp_path, monkeypatch):
    """The difacto app as four ranks of torch.distributed.run on the CPU,
    model_shards=2 (a 2x2 mesh: both table groups range-sharded), saves
    `_part-R` files that reassemble into the port's one-device solver run
    on the same conf (one loader), tables at rtol 1e-4 / atol 1e-5."""
    import subprocess
    import sys

    from wormhole_tpu_torch.config import load_config
    from wormhole_tpu_torch.models.difacto import (DifactoConfig,
                                                   DifactoLearner)
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver
    from wormhole_tpu_torch.utils import checkpoint as t_ckpt

    data = tmp_path / "fm.libsvm"
    data.write_text(synth_libsvm_text(n_rows=768, n_feat=300, nnz_per_row=6,
                                      seed=23))
    conf = tmp_path / "fm.conf"
    conf.write_text("".join(f"{k} = {v}\n" for k, v in dict(
        DFM, train_data=data, max_data_pass=2, num_parts_per_file=1,
        max_concurrency=1).items()))
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ranks.ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "wormhole_tpu_torch.apps.difacto",
         str(conf), "device=cpu", "model_shards=2",
         f"model_out={tmp_path / 'app' / 'm'}"],
        capture_output=True, text=True, env=env, cwd=str(ranks.ROOT),
        timeout=180)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert sorted(os.listdir(tmp_path / "app")) == ["m_part-0.npz",
                                                    "m_part-1.npz"]
    got = t_ckpt.load_parts(str(tmp_path / "app" / "m"))
    monkeypatch.setenv("WH_NUM_LOADERS", "1")
    cfg = load_config(DifactoConfig, conf_file=str(conf), argv=[])
    one = DifactoLearner(cfg, device="cpu")
    MinibatchSolver(one, cfg, verbose=False).run()
    for k, v in one.ckpt_store.to_numpy().items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_difacto_2x2_xla_equals_kernels(difacto_run):
    """kernel=xla on the 2x2 mesh (W1 and W2's plain twins over unsorted
    cells) gives the kernel route's tables (both f32: the cells' sums in
    another order, rtol 1e-5 / atol 1e-6)."""
    o = difacto_run["outs"][0]
    for k in ("w", "z", "n", "cnt", "V", "nV"):
        np.testing.assert_allclose(o[f"xla_table_{k}"], o[f"table_{k}"],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
