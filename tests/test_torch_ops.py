"""The port's plain torch ops against the JAX package's, on shared numpy
inputs: penalty, spmv, metrics, the push filter and the loss dual."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wormhole_tpu.models import linear as j_lin
from wormhole_tpu.ops import metrics as j_m
from wormhole_tpu.ops import penalty as j_pen
from wormhole_tpu.ops import spmv as j_spmv
from wormhole_tpu.parallel import kvstore as j_kv
from wormhole_tpu_torch.models import linear as t_lin
from wormhole_tpu_torch.ops import metrics as t_m
from wormhole_tpu_torch.ops import penalty as t_pen
from wormhole_tpu_torch.ops import spmv as t_spmv
from wormhole_tpu_torch.parallel import kvstore as t_kv

T = torch.from_numpy


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.5, 0.0), (1.0, 2.0)])
def test_l1l2_solve(l1, l2):
    rng = np.random.default_rng(0)
    z = rng.normal(size=1000).astype(np.float32) * 2
    eta = rng.random(1000).astype(np.float32) + 0.5
    z[:10] = 0.0
    _close(t_pen.l1l2_solve(T(z), T(eta), l1, l2),
           j_pen.l1l2_solve(jnp.asarray(z), jnp.asarray(eta), l1, l2))


def test_spmv_and_spmv_t():
    rng = np.random.default_rng(1)
    n_rows, cap, nb = 64, 640, 200
    seg = np.sort(rng.integers(0, n_rows, size=cap)).astype(np.int32)
    idx = rng.integers(0, nb, size=cap).astype(np.int32)
    val = rng.normal(size=cap).astype(np.float32)
    w = rng.normal(size=nb).astype(np.float32)
    d = rng.normal(size=n_rows).astype(np.float32)
    # summation order differs between index_add_ and segment_sum
    _close(t_spmv.spmv(T(seg), T(idx), T(val), T(w), n_rows),
           j_spmv.spmv(jnp.asarray(seg), jnp.asarray(idx), jnp.asarray(val),
                       jnp.asarray(w), n_rows), rtol=1e-5, atol=1e-5)
    _close(t_spmv.spmv_t(T(seg), T(idx), T(val), T(d), nb),
           j_spmv.spmv_t(jnp.asarray(seg), jnp.asarray(idx),
                         jnp.asarray(val), jnp.asarray(d), nb),
           rtol=1e-5, atol=1e-5)


def _scores(kind, n=500, seed=2):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float32)
    if kind == "ties":
        s = rng.integers(-3, 4, size=n).astype(np.float32)
    else:
        s = (rng.normal(size=n) + y).astype(np.float32)
    mask = (rng.random(n) < 0.85).astype(np.float32)
    if kind == "one_class":
        y[:] = 1.0
    return y, s, mask


@pytest.mark.parametrize("kind", ["ties", "distinct", "one_class"])
@pytest.mark.parametrize("metric", ["auc", "accuracy", "logloss",
                                    "logit_objv", "copc"])
def test_metrics(kind, metric):
    y, s, mask = _scores(kind)
    got = getattr(t_m, metric)(T(y), T(s), T(mask))
    want = getattr(j_m, metric)(jnp.asarray(y), jnp.asarray(s),
                                jnp.asarray(mask))
    _close(float(got), float(want), rtol=1e-5, atol=1e-6)


def test_auc_ignores_masked_rows():
    y, s, mask = _scores("ties")
    keep = mask > 0
    full = float(t_m.auc(T(y), T(s), T(mask)))
    sub = float(t_m.auc(T(y[keep]), T(s[keep]),
                        T(np.ones(keep.sum(), np.float32))))
    assert full == pytest.approx(sub, abs=1e-6)


@pytest.mark.parametrize("nbytes", [0, 1, 2])
def test_quantize_push(nbytes):
    rng = np.random.default_rng(3)
    g = np.clip(rng.normal(size=4096) * 1e-2, -0.1, 0.1).astype(np.float32)
    g[:50] = 0.0
    # absmax 127/1024 makes the int8 scale exactly 1/1024, so these sit
    # exactly half-way between steps: half to even gives 2, -4 and 0
    g[50:54] = np.array([127, 2.5, -3.5, 0.5], np.float32) / 1024
    got = t_kv.quantize_push(T(g), nbytes)
    want = j_kv.quantize_push(jnp.asarray(g), nbytes)
    _close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("loss", ["logit", "square_hinge"])
def test_loss_dual(loss):
    rng = np.random.default_rng(4)
    y = (rng.random(300) < 0.5).astype(np.float32)
    xw = (rng.normal(size=300) * 5).astype(np.float32)
    xw[:3] = [40.0, -40.0, 0.0]
    o_t, d_t = t_lin._loss_dual(loss, T(y), T(xw))
    o_j, d_j = j_lin._loss_dual(loss, jnp.asarray(y), jnp.asarray(xw))
    _close(o_t, o_j, rtol=1e-6, atol=1e-6)
    _close(d_t, d_j, rtol=1e-6, atol=1e-6)
