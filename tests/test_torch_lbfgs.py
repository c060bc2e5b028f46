"""The port's L-BFGS/OWL-QN solver, batch objectives and apps against the
JAX package.

The same libsvm files go through both packages, the port on the CPU.
Bars: eval and grad at a random point rtol 1e-5 / atol 1e-6; a whole
run from the same start, objv_history within rtol 1e-4 over the first 8
iterations and the final w within atol 1e-4; OWL-QN's exact zeros the
same set. The line search accepts a trial on a host comparison of f32
objectives, so a last-bit difference could change a trial count: the
runs use the well-conditioned data of tests/test_bsp.py (1,500 rows,
120 features, reg_L2 1e-3), where the two histories stay within the
bar. The whole runs stop at 8 iterations, where the bar is set: f32 sums
in another order drift further with every iteration (the FM's w, near
4.6 in its largest entries, was 1.6e-4 off after 12).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_libsvm_text
from test_difacto import fm_synth_text
from torch_bsp_role import bsp_worker_role
from wormhole_tpu.apps import lbfgs_linear as j_app
from wormhole_tpu.models import batch_objectives as jb
from wormhole_tpu.parallel.mesh import make_mesh
from wormhole_tpu.solver.lbfgs import LBFGSConfig as JConfig
from wormhole_tpu.solver.lbfgs import LBFGSSolver as JSolver
from wormhole_tpu_torch import interop
from wormhole_tpu_torch.apps import lbfgs_fm as t_fm_app
from wormhole_tpu_torch.apps import lbfgs_linear as t_app
from wormhole_tpu_torch.models import batch_objectives as tb
from wormhole_tpu_torch.solver.lbfgs import LBFGSConfig, LBFGSSolver


@pytest.fixture(scope="module")
def lin_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("tlb") / "lin.libsvm"
    p.write_text(synth_libsvm_text(n_rows=1500, n_feat=120, nnz_per_row=10,
                                   seed=11))
    return str(p)


@pytest.fixture(scope="module")
def fm_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("tlbfm") / "fm.libsvm"
    p.write_text(fm_synth_text(n_rows=2000))
    return str(p)


def _objs(kind, path, mesh=None, nnz_per_row=16):
    """The JAX and port objectives over the same file."""
    mesh = mesh or make_mesh(1, 1)
    bj, nj = jb.load_batches(path, mesh, minibatch=512,
                             nnz_per_row=nnz_per_row)
    bt, nt = tb.load_batches(path, minibatch=512, nnz_per_row=nnz_per_row,
                             device="cpu")
    assert nj == nt
    if kind == "linear":
        return (jb.LinearObjFunction(bj, nj, mesh),
                tb.LinearObjFunction(bt, nt, "cpu"))
    return (jb.FmObjFunction(bj, nj, dim_k=6, mesh=mesh, init_scale=0.1),
            tb.FmObjFunction(bt, nt, 6, "cpu", init_scale=0.1))


def _file(kind, lin_file, fm_file):
    return lin_file if kind == "linear" else fm_file


def _port_vec(v, obj):
    """A JAX vector as the port's, padding stripped."""
    return interop.lbfgs_state_from_numpy({"w": np.asarray(v)}, obj.num_dim,
                                          "cpu")["w"]


@pytest.mark.parametrize("kind", ["linear", "fm"])
def test_eval_and_grad_match_jax(kind, lin_file, fm_file):
    jo, to = _objs(kind, _file(kind, lin_file, fm_file),
                   nnz_per_row=16 if kind == "linear" else 8)
    assert to.num_dim == jo.num_dim == to.num_dim_padded
    p = (0.3 * np.random.default_rng(3).standard_normal(jo.num_dim)
         ).astype(np.float32)
    np.testing.assert_allclose(to.eval(torch.from_numpy(p)),
                               jo.eval(jnp.asarray(p)), rtol=1e-5)
    np.testing.assert_allclose(to.grad(torch.from_numpy(p)).numpy(),
                               np.asarray(jo.grad(jnp.asarray(p))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(to.l1_mask().numpy(),
                                  np.asarray(jo.l1_mask()))


def test_grad_matches_autograd_in_float64(lin_file, fm_file):
    """The written-out gradients equal torch.autograd's of the same loss,
    in float64 on the port's own batches."""
    for kind in ("linear", "fm"):
        _, to = _objs(kind, _file(kind, lin_file, fm_file),
                      nnz_per_row=16 if kind == "linear" else 8)
        p = torch.from_numpy(0.3 * np.random.default_rng(4).standard_normal(
            to.num_dim)).requires_grad_(True)
        loss = sum(to._batch_loss(p, *b) for b in to.batches)
        (want,) = torch.autograd.grad(loss, p)
        torch.testing.assert_close(to.grad(p.detach()), want, rtol=1e-10,
                                   atol=1e-10)


RUNS = [dict(kind="linear", reg_l2=1e-3), dict(kind="linear", reg_l1=5.0,
                                                reg_l2=1e-3),
        dict(kind="fm", reg_l2=1e-4)]


@pytest.mark.parametrize("case", RUNS, ids=["linear", "owlqn", "fm"])
def test_whole_run_matches_jax(case, lin_file, fm_file):
    """Both solvers from the same start (the FM's V as JAX drew it)."""
    case = dict(case)
    kind = case.pop("kind")
    jo, to = _objs(kind, _file(kind, lin_file, fm_file),
                   nnz_per_row=16 if kind == "linear" else 8)
    w0 = _port_vec(jo.init_model(), to)
    to.init_model = lambda: w0.clone()
    js = JSolver(jo, JConfig(max_iter=8, m=8, **case))
    ts = LBFGSSolver(to, LBFGSConfig(max_iter=8, m=8, **case))
    wj, oj = js.run(verbose=False)
    wt, ot = ts.run(verbose=False)
    n = min(9, len(js.objv_history))  # init + the first 8 iterations
    assert len(ts.objv_history) >= n
    np.testing.assert_allclose(ts.objv_history[:n], js.objv_history[:n],
                               rtol=1e-4)
    assert ts.iter == js.iter
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-4)
    if case.get("reg_l1"):
        zj, zt = np.asarray(wj) == 0, wt.numpy() == 0
        assert zt[: to.num_feature].any()  # L1 made exact zeros
        np.testing.assert_array_equal(zt, zj)


def test_jax_mesh_checkpoint_resumes_in_port(lin_file, tmp_path):
    """A JAX lbfgs_state.npz written under a (4, 2) CPU mesh, its vectors
    padded from 121 to 128, resumes in the port; the port's next
    iterations follow JAX's own resume of the same file."""
    cdir = tmp_path / "mesh"
    jo8, _ = _objs("linear", lin_file, mesh=make_mesh(4, 2))
    JSolver(jo8, JConfig(max_iter=4, m=4, reg_l2=1e-3,
                         checkpoint_dir=str(cdir))).run(verbose=False)
    st = np.load(cdir / "lbfgs_state.npz")
    assert st["w"].shape[0] == 128 and jo8.num_dim == 121
    shutil.copytree(cdir, tmp_path / "copy")
    jo, to = _objs("linear", lin_file)
    ts = LBFGSSolver(to, LBFGSConfig(max_iter=8, m=4, reg_l2=1e-3,
                                     checkpoint_dir=str(cdir)))
    js = JSolver(jo, JConfig(max_iter=8, m=4, reg_l2=1e-3,
                             checkpoint_dir=str(tmp_path / "copy")))
    wt, _ = ts.run(verbose=False)
    wj, _ = js.run(verbose=False)
    assert ts.iter == js.iter == 8
    assert len(ts.S) == 4 and ts.S[0].shape == (121,)
    np.testing.assert_allclose(ts.objv_history, js.objv_history, rtol=1e-4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj)[:121], atol=1e-4)
    # the port's own checkpoint has the unpadded layout and resumes
    assert np.load(cdir / "lbfgs_state.npz")["w"].shape == (121,)
    again = LBFGSSolver(to, LBFGSConfig(max_iter=8,
                                        checkpoint_dir=str(cdir)))
    w2, _ = again.run(verbose=False)
    torch.testing.assert_close(w2, wt, rtol=0, atol=0)


def test_state_from_numpy_checks_padding_and_pairs():
    w = np.arange(8, dtype=np.float32)
    got = interop.lbfgs_state_from_numpy(
        {"w": np.r_[w, 0, 0], "iter": np.int64(3),
         "objv": np.array([2.0, 1.0]), "S": np.zeros((1, 10)),
         "Y": np.ones((1, 10)) * np.r_[np.ones(8), 0, 0]}, 8, "cpu")
    np.testing.assert_array_equal(got["w"].numpy(), w)
    assert got["iter"] == 3 and got["objv"] == [2.0, 1.0]
    assert len(got["S"]) == len(got["Y"]) == 1 and "g" not in got
    with pytest.raises(ValueError, match="nonzero past"):
        interop.lbfgs_state_from_numpy({"w": np.r_[w, 1.0]}, 8, "cpu")
    with pytest.raises(ValueError, match="at least"):
        interop.lbfgs_state_from_numpy({"w": w[:5]}, 8, "cpu")
    with pytest.raises(ValueError, match="pairs"):
        interop.lbfgs_state_from_numpy(
            {"w": w, "S": np.zeros((2, 8)), "Y": np.zeros((1, 8))}, 8,
            "cpu")


def test_jax_model_predicts_in_port(lin_file, tmp_path, capsys):
    """The JAX app's model_out (trained on its default mesh, so padded)
    predicts in the port's task=pred: margins within atol 1e-5 of the
    JAX app's own pred file."""
    model = str(tmp_path / "model.npz")
    common = [f"data={lin_file}", "max_lbfgs_iter=6", "reg_L2=0.01",
              "minibatch=512", "nnz_per_row=16"]
    assert j_app.main([*common, f"model_out={model}"]) == 0
    pj, pt = str(tmp_path / "pj.txt"), str(tmp_path / "pt.txt")
    assert j_app.main([*common, "task=pred", f"model_in={model}",
                       f"pred_out={pj}"]) == 0
    assert t_app.main([*common, "task=pred", f"model_in={model}",
                       f"pred_out={pt}", "device=cpu"]) == 0
    capsys.readouterr()
    mj, mt = np.loadtxt(pj), np.loadtxt(pt)
    assert mt.shape == (1500,)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-5)


def test_host_syncs_stay_under_the_jax_budget(lin_file):
    """tests/test_bsp.py:196-213's budget: about one Gram fetch a
    direction, not 4m dot fetches."""
    _, to = _objs("linear", lin_file)
    solver = LBFGSSolver(to, LBFGSConfig(max_iter=20, m=8, reg_l2=1e-3))
    solver.run(verbose=False)
    iters = solver.iter
    assert iters >= 10
    assert solver.host_syncs < iters * 4 * 4 / 2, solver.host_syncs
    assert solver.host_syncs / iters < 8


def test_apps_run_on_cpu(lin_file, fm_file, tmp_path, capsys):
    """lbfgs_linear train and pred, and lbfgs_fm, end to end on the CPU;
    the objective falls, and pred writes one margin a row."""
    model, pred = str(tmp_path / "lin.npz"), str(tmp_path / "pred.txt")
    assert t_app.main([f"data={lin_file}", "max_lbfgs_iter=10",
                       "reg_L2=0.01", "minibatch=512", "nnz_per_row=16",
                       f"model_out={model}", "device=cpu"]) == 0
    st = np.load(model)
    assert st["w"].shape == (121,) and int(st["num_feature"]) == 120
    assert t_app.main([f"data={lin_file}", "task=pred", f"model_in={model}",
                       f"pred_out={pred}", "minibatch=512",
                       "nnz_per_row=16", "device=cpu"]) == 0
    margins = np.loadtxt(pred)
    assert margins.shape == (1500,) and np.isfinite(margins).all()
    fm_model = str(tmp_path / "fm.npz")
    assert t_fm_app.main([f"data={fm_file}", "nfactor=4",
                          "max_lbfgs_iter=8", "minibatch=512",
                          "nnz_per_row=8", f"model_out={fm_model}",
                          "device=cpu"]) == 0
    out = capsys.readouterr().out
    objv = [float(line.split()[-1]) for line in out.splitlines()
            if line.startswith("final objective")]
    assert len(objv) == 2
    st = np.load(fm_model)
    nf = int(st["num_feature"])
    assert st["w"].shape == (nf * 5 + 1,) and int(st["nfactor"]) == 4


@pytest.mark.parametrize("what", ["linear-bsp", "fm-bsp", "comm"])
def test_bsp_paths_run(what, lin_file, tmp_path, monkeypatch, capsys):
    """bsp=1 under a launcher's worker role runs the app's BSP worker
    body (load_batches_bsp, the solver with `comm`, a version checkpoint
    an iteration), and the solver takes a ring worker as `comm`. A ring
    of one rank returns its own sums, so each equals the single process
    bit for bit."""
    if what == "comm":
        from wormhole_tpu_torch.runtime.allreduce import BspWorker
        from wormhole_tpu_torch.runtime.tracker import SchedulerClient

        _, to = _objs("linear", lin_file)
        cfg = LBFGSConfig(max_iter=5, reg_l2=1e-3)
        w1, o1 = LBFGSSolver(to, cfg).run(verbose=False)
        with bsp_worker_role(monkeypatch) as sched:
            client = SchedulerClient(sched.uri, "worker-0")
            client.register()
            comm = BspWorker(0, 1, client, snapshot_dir=str(tmp_path))
            try:
                s = LBFGSSolver(to, cfg, comm=comm)
                w2, o2 = s.run(verbose=False)
            finally:
                comm.close()
        assert torch.equal(w1, w2) and o1 == o2
        assert comm.version == s.iter == 5
        st = np.load(tmp_path / "bsp_rank0.npz")
        assert set(st.files) == {"__version", "w", "g", "iter", "objv", "S",
                                 "Y"}
        np.testing.assert_array_equal(st["w"], w2.numpy())
        return
    app = t_app if what == "linear-bsp" else t_fm_app
    args = [f"data={lin_file}", "max_lbfgs_iter=5", "reg_L2=0.001",
            "minibatch=512", "nnz_per_row=16", "device=cpu", "bsp=1"]
    if what == "fm-bsp":
        args.append("nfactor=4")
    one, bsp = tmp_path / "one.npz", tmp_path / "bsp.npz"
    assert app.main(args + [f"model_out={one}"]) == 0
    with bsp_worker_role(monkeypatch) as sched:
        assert app.main(args + [f"model_out={bsp}"]) == 0
        key = "lbfgs_dim" if what == "linear-bsp" else "lbfgs_fm_dim"
        assert sched.has_blob(key) and sched.has_blob(f"{key}_0")
    out = capsys.readouterr().out
    objv = [line for line in out.splitlines()
            if line.startswith("final objective")]
    assert len(objv) == 2 and objv[0] == objv[1]
    assert "[bsp-worker] " in out
    a, b = np.load(one), np.load(bsp)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("what", ["linear-global_mesh", "unseen-feature"])
def test_what_waits_raises(what, lin_file, tmp_path):
    if what == "unseen-feature":
        model = str(tmp_path / "small.npz")
        np.savez(model, w=np.zeros(11, np.float32), num_feature=10)
        with pytest.raises(ValueError, match="feature id"):
            t_app.main([f"data={lin_file}", "task=pred",
                        f"model_in={model}", "device=cpu"])
        return
    # global_mesh=1 without a launcher role runs in one process, as the
    # JAX app does: the model of the run without the key
    models = []
    for extra in (["global_mesh=1"], []):
        out = str(tmp_path / f"m{len(models)}.npz")
        assert t_app.main([f"data={lin_file}", "max_lbfgs_iter=3",
                           f"model_out={out}", "device=cpu", *extra]) == 0
        models.append(np.load(out)["w"])
    np.testing.assert_array_equal(models[0], models[1])
