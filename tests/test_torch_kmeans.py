"""The port's k-means learner, app and state files against the JAX package.

The same libsvm files go through both packages; the port runs on the CPU
(its coo_spmv_t wrapper takes the plain version), the JAX learner's
packed path runs the Pallas kernel in interpret mode. Bars: per batch,
for fixed centroids, counts equal, sums rtol 1e-5 / atol 1e-6 (bf16:
atol 1e-4, tests/test_torch_kernels.py's bar) and cost rtol 1e-5; a
whole run from the same initial centroids, the centroids after 5
iterations within atol 1e-5. The whole-run cases use well-separated
clusters, where a last-bit difference in a similarity cannot flip an
assignment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bsp import _cluster_data
from wormhole_tpu.apps import kmeans as j_app
from wormhole_tpu.models.kmeans import KmeansConfig as JConfig
from wormhole_tpu.models.kmeans import KmeansLearner as JLearner
from wormhole_tpu.parallel.mesh import make_mesh
from wormhole_tpu_torch import interop
from wormhole_tpu_torch.apps import kmeans as t_app
from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner
from wormhole_tpu_torch.models.kmeans import discover_dim


def _mnist_text(rows, dim, nnz, seed):
    """MNIST-shaped rows in miniature: `nnz` uniform column draws a row
    (so a row repeats some columns, as the bench's rows do), values
    U[0, 1)."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        idx = rng.integers(0, dim, size=nnz)
        val = rng.random(nnz)
        lines.append("0 " + " ".join(f"{i}:{v:.5f}" for i, v in
                                     zip(idx, val)))
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def mnist_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("tkm") / "mnist.libsvm"
    p.write_text(_mnist_text(600, 60, 24, seed=3))
    return str(p)


def _pair(**kw):
    return (JLearner(JConfig(**kw), make_mesh(1, 1)),
            KmeansLearner(KmeansConfig(**kw), device="cpu"))


PATHS = ["dense", "sparse", "packed-f32", "packed-bf16"]


@pytest.mark.parametrize("path", PATHS)
def test_assignment_matches_jax(mnist_file, path):
    """Each assignment path on the same batches and fixed centroids; the
    packed path's pack equal to the JAX pack, array for array."""
    kdt = path.split("-")[1] if "-" in path else "f32"
    j, t = _pair(train_data=mnist_file, num_clusters=5, dim=60,
                 minibatch=256, nnz_per_row=32, kernel_dtype=kdt)
    assert t._use_packed and t._num_flat == j._num_flat
    C = np.random.default_rng(0).standard_normal((5, 60)).astype(np.float32)
    Cj, Ct = jnp.asarray(C), torch.from_numpy(C)
    if path.startswith("packed"):
        pairs = [((*pj, mj), (*pt, mt)) for (pj, mj), (pt, mt) in
                 zip(j._batches_packed(), t._batches_packed())]
        for bj, bt in pairs:
            for a, b in zip(bj, bt):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        fj, ft = j._assign_packed, t._assign_packed
    else:
        pairs = list(zip(j._batches(), t._batches()))
        fj, ft = ((j._assign_dense, t._assign_dense) if path == "dense"
                  else (j._assign_sparse, t._assign_sparse))
    assert len(pairs) == 3  # 256 + 256 + a masked 88-row batch
    atol = 1e-4 if kdt == "bf16" else 1e-6
    for bj, bt in pairs:
        sj, cj, coj = fj(Cj, *bj)
        st, ct, cot = ft(Ct, *bt)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                                   atol=atol)
        np.testing.assert_allclose(float(cot), float(coj), rtol=1e-5)


def test_packed_densify_matches_scatter(mnist_file):
    """The flat-bucket densify through coo_spmv_t gives the scatter's
    rows: repeated (row, col) entries summed, masked rows zero."""
    t = KmeansLearner(KmeansConfig(train_data=mnist_file, num_clusters=5,
                                   dim=60, minibatch=256, nnz_per_row=32),
                      device="cpu")
    C = torch.randn(5, 60, generator=torch.Generator().manual_seed(1))
    for (seg, idx, val, mask), (pk, mask2) in zip(t._batches(),
                                                  t._batches_packed()):
        torch.testing.assert_close(mask, mask2, rtol=0, atol=0)
        want = t._assign_dense(C, seg, idx, val, mask)
        got = t._assign_packed(C, *pk, mask)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


RUNS = [dict(assign_kernel="dense", minibatch=256),    # packed
        dict(assign_kernel="dense", minibatch=200),    # scatter densify
        dict(assign_kernel="sparse", minibatch=256)]


@pytest.mark.parametrize("case", RUNS, ids=["packed", "dense", "sparse"])
def test_whole_run_matches_jax(tmp_path, case):
    path, _, _ = _cluster_data(tmp_path, seed=7)
    kw = dict(train_data=path, num_clusters=3, dim=16, max_iter=5,
              nnz_per_row=16, seed=2, **case)
    j, t = _pair(**kw)
    assert t._use_packed == (case["minibatch"] == 256
                             and case["assign_kernel"] == "dense")
    j.init_centroids()
    t.init_centroids()
    # the same rows drawn (their norms rounded in another order), then
    # both start from the JAX package's
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=0, atol=1e-6)
    t.centroids = interop.kmeans_state_from_numpy(
        np.asarray(j.centroids), t.cfg, "cpu")
    cj, ct = j.run(verbose=False), t.run(verbose=False)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=0, atol=1e-5)
    assert abs(ct - cj) < 1e-5


def test_more_clusters_than_rows_and_empty_clusters(tmp_path):
    """k above the candidate rows: the jittered init draws as JAX's, the
    empty clusters keep their centroids, and the 4 distinct rows are
    covered exactly (tests/test_bsp.py:74)."""
    p = tmp_path / "tiny.libsvm"
    p.write_text("\n".join(f"0 {i % 4}:1" for i in range(40)) + "\n")
    j, t = _pair(train_data=str(p), num_clusters=50, dim=8, max_iter=2,
                 minibatch=64, nnz_per_row=4)
    j.init_centroids()
    t.init_centroids()
    C0 = t.centroids.clone()
    np.testing.assert_array_equal(C0.numpy(), np.asarray(j.centroids))
    cj, ct = j.run(verbose=False), t.run(verbose=False)
    C = t.centroids.numpy()
    assert C.shape == (50, 8) and np.isfinite(C).all()
    assert ct < 1e-6 and cj < 1e-6
    np.testing.assert_allclose(C, np.asarray(j.centroids), atol=1e-5)
    # at most 4 clusters took rows; every other one kept its start
    kept = (C == C0.numpy()).all(axis=1)
    assert kept.sum() >= 46


@pytest.mark.parametrize("first", ["jax", "port"])
def test_state_resumes_across_packages(tmp_path, first):
    """3 iterations in one package write state.npz; the other package
    resumes a copy of it to 5 and lands where the first package lands
    resuming its own."""
    import shutil

    path, _, _ = _cluster_data(tmp_path, seed=5)
    kw = dict(train_data=path, num_clusters=3, dim=16, minibatch=256,
              nnz_per_row=16)
    make = {"jax": lambda it, cdir: JLearner(
                JConfig(max_iter=it, checkpoint_dir=cdir, **kw),
                make_mesh(1, 1)),
            "port": lambda it, cdir: KmeansLearner(
                KmeansConfig(max_iter=it, checkpoint_dir=cdir, **kw),
                device="cpu")}
    second = "port" if first == "jax" else "jax"
    own, other = str(tmp_path / "own"), str(tmp_path / "other")
    make[first](3, own).run(verbose=False)
    shutil.copytree(own, other)
    runs = {}
    for who, cdir in ((second, other), (first, own)):
        lrn = make[who](5, cdir)
        assert lrn._try_resume() and lrn.start_iter == 3
        lrn.run(verbose=False)
        runs[who] = np.asarray(lrn.centroids)
    np.testing.assert_allclose(runs[second], runs[first], rtol=0,
                               atol=1e-5)


def test_text_model_format(tmp_path):
    """save writes the JAX package's text (%.6g, one row a line), and
    kmeans_state_from_numpy reads it and state.npz back."""
    cfg = KmeansConfig(num_clusters=3, dim=4, train_data="unused")
    t = KmeansLearner(cfg, device="cpu")
    C = np.random.default_rng(4).standard_normal((3, 4)).astype(np.float32)
    t.centroids = torch.from_numpy(C)
    j = JLearner(JConfig(num_clusters=3, dim=4), make_mesh(1, 1))
    j.centroids = jnp.asarray(C)
    t.save(str(tmp_path / "t.txt"))
    j.save(str(tmp_path / "j.txt"))
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text()
    assert len(text.splitlines()) == 3
    back = interop.kmeans_state_from_numpy(
        np.loadtxt(tmp_path / "t.txt", ndmin=2), cfg, "cpu")
    np.testing.assert_allclose(back.numpy(), C, rtol=1e-5)
    got = interop.kmeans_state_from_numpy({"centroids": C}, cfg, "cpu")
    np.testing.assert_array_equal(got.numpy(), C)
    with pytest.raises(ValueError, match="expected"):
        interop.kmeans_state_from_numpy({"centroids": C[:2]}, cfg, "cpu")


def test_discover_dim_matches_jax(mnist_file):
    from wormhole_tpu.models.kmeans import discover_dim as j_discover

    assert discover_dim(mnist_file) == j_discover(mnist_file) == 60


def test_app_runs_on_cpu_like_jax(tmp_path, capsys):
    """The app with the reference's data= alias, dim discovered, and
    model_out, against the JAX app on the same file."""
    path, _, _ = _cluster_data(tmp_path, seed=9)
    outs = {}
    for name, app, extra in (("port", t_app, ["device=cpu"]),
                             ("jax", j_app, [])):
        out = str(tmp_path / f"{name}.txt")
        assert app.main([f"data={path}", "num_clusters=3", "max_iter=4",
                         "minibatch=256", "nnz_per_row=16", "seed=3",
                         f"model_out={out}", *extra]) == 0
        assert "final cosine objective" in capsys.readouterr().out
        outs[name] = np.loadtxt(out)
    assert outs["port"].shape == (3, 16)
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=1e-5)


def test_app_global_mesh_raises(tmp_path, capsys):
    """global_mesh=1 without a launcher role runs in one process, as the
    JAX app does (it no longer raises): the same centroids as without
    the key."""
    path, _, _ = _cluster_data(tmp_path, n=30, seed=1)
    outs = []
    for extra in (["global_mesh=1"], []):
        out = tmp_path / f"c{len(outs)}.txt"
        assert t_app.main([f"data={path}", "num_clusters=3", "max_iter=2",
                           "minibatch=256", f"model_out={out}",
                           "device=cpu", *extra]) == 0
        outs.append(np.loadtxt(out))
    assert "final cosine objective" in capsys.readouterr().out
    np.testing.assert_array_equal(outs[0], outs[1])


def test_config_keys_match_jax():
    import dataclasses

    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t = {f.name: f.default for f in dataclasses.fields(KmeansConfig)}
    assert j == t


def test_bad_kernel_dtype_and_ids_raise(mnist_file):
    with pytest.raises(ValueError, match="kernel_dtype"):
        KmeansLearner(KmeansConfig(train_data=mnist_file, dim=60,
                                   kernel_dtype="f16"), device="cpu")
    t = KmeansLearner(KmeansConfig(train_data=mnist_file, dim=30,
                                   minibatch=256, nnz_per_row=32),
                      device="cpu")
    with pytest.raises(ValueError, match="dim=0"):
        next(t._batches())
