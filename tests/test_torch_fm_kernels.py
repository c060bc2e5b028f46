"""The port's three FM kernels (row_tile_gather, fm_push_contrib,
v_scatter_update).

On the CPU the wrappers run the kernels' plain PyTorch versions; these
are held against the JAX package's Pallas kernels in interpret mode, on
packs made by the JAX host functions (assign_tile_slots, and
pack_sorted_coo with tile=TILE_HI, blk=FM_BLK), at the bar of
tests/test_coo_kernels.py: rtol 1e-5, atol 1e-4, in f32 and in bf16 (both
packages round the same operands: the gathered V value, the a and b
contributions, the V gradient). The CUDA kernels themselves run only on
the card (see tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wormhole_tpu.ops import coo_kernels as j_ck
from wormhole_tpu.ops import fused_update as j_fu
from wormhole_tpu_torch.ops import coo_kernels as t_ck
from wormhole_tpu_torch.ops import fused_update as t_fu

RTOL, ATOL = 1e-5, 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
T = torch.from_numpy
J = jnp.asarray
HYPER = dict(V_lr_eta=0.1, V_lr_beta=1.0, lambda_V=0.05)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _row_slots(vb, dim, n_rows, u_blocks, seed):
    """Tile-aligned compact row slots of n_rows random V rows: sentinel
    holes inside each tile's run and trailing spare blocks."""
    rng = np.random.default_rng(seed)
    rows = np.unique(rng.integers(0, vb, size=n_rows))
    return j_ck.assign_tile_slots(rows, j_ck.TILE // dim,
                                  u_blocks * j_ck.BLK_U, vb)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("dim", [4, 8])
def test_row_tile_gather_plain_matches_pallas(dim, dt):
    vb = 4 * j_ck.TILE // dim
    ts = _row_slots(vb, dim, 3000, 8, seed=dim)
    assert (ts.uniq == vb).any()  # sentinel slots present
    V = np.random.default_rng(1).normal(size=(vb, dim)).astype(np.float32)
    jd, td = DTYPES[dt]
    want = j_fu.row_tile_gather(J(V).reshape(-1, 128), J(ts.uniq),
                                J(ts.tmap_u), dim, dtype=jd)
    got = t_fu.row_tile_gather(T(V).view(-1, 128), T(ts.uniq),
                               T(ts.tmap_u), dim, dtype=td)
    assert got.shape == (ts.uniq.size, dim)
    _close(got, want)
    assert not got.numpy()[ts.uniq == vb].any()


def _fm_inputs(rows, dim, seed, hot=0, n_other=3000, spare_blocks=2,
               one_tile=False):
    """A slot-sorted V-side stream packed by the JAX host function, with
    a and b zero at the pad entries, as the learner builds them."""
    rng = np.random.default_rng(seed)
    hi = j_ck.TILE_HI if one_tile else rows
    slots = np.concatenate([np.full(hot, 5, np.int64),
                            rng.integers(0, hi, size=n_other)])
    seg = rng.integers(0, 128, size=slots.size).astype(np.int32)
    val = rng.normal(size=slots.size).astype(np.float32)
    p = j_ck.pack_sorted_coo(slots, seg, val, rows,
                             capacity=slots.size + spare_blocks * j_ck.FM_BLK,
                             tile=j_ck.TILE_HI, blk=j_ck.FM_BLK)
    live = p.val != 0
    a = (rng.normal(size=(p.idx.size, dim)) * live[:, None]).astype(np.float32)
    b = (rng.normal(size=p.idx.size) * live).astype(np.float32)
    Vc = rng.normal(size=(rows, dim)).astype(np.float32)
    return p, a, b, Vc


CASES = {
    "spread": dict(),
    # one row's run crosses three FM_BLK blocks (the Zipf head)
    "skewed": dict(hot=3 * j_ck.FM_BLK + 11),
    # every entry in tile 0: the other tiles' blocks are all pads
    "empty-tiles": dict(one_tile=True),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_fm_push_contrib_plain_matches_pallas(case, dt):
    rows, dim = 4 * j_ck.TILE_HI, 8
    p, a, b, Vc = _fm_inputs(rows, dim, seed=len(case), **CASES[case])
    jd, td = DTYPES[dt]
    want = j_ck.fm_push_contrib(J(Vc), J(a), J(b), J(p.idx), J(p.tmap),
                                J(p.first), dtype=jd)
    got = t_ck.fm_push_contrib(T(Vc), T(a), T(b), T(p.idx), T(p.tmap),
                               T(p.first), dtype=td)
    assert got.shape == (rows, dim)
    _close(got, want)
    # rows with no live entry come out exactly 0
    touched = np.zeros(rows, bool)
    touched[p.idx[p.val != 0]] = True
    assert not got.numpy()[~touched].any()
    if case == "empty-tiles":
        assert not got.numpy()[j_ck.TILE_HI:].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_v_scatter_update_plain_matches_pallas(dt):
    dim = 8
    vb = 4 * j_ck.TILE // dim
    ts = _row_slots(vb, dim, 3000, 8, seed=3)
    rng = np.random.default_rng(4)
    live = ts.uniq < vb
    gV = rng.normal(size=(ts.uniq.size, dim)).astype(np.float32)
    vtouched = (live & (rng.random(ts.uniq.size) < 0.8)).astype(np.float32)
    V = rng.normal(size=(vb, dim)).astype(np.float32)
    nV = (rng.random((vb, dim)) * 2).astype(np.float32)
    jd, td = DTYPES[dt]
    blocks = (ts.uniq, ts.tmap_u, ts.first_u, ts.last_u)
    Vj, nVj = j_fu.v_scatter_update(J(V), J(nV), J(gV), J(vtouched),
                                    *map(J, blocks), dim=dim, dtype=jd,
                                    **HYPER)
    Vt, nVt = T(V.copy()), T(nV.copy())
    out = t_fu.v_scatter_update(Vt, nVt, T(gV), T(vtouched),
                                *map(T, blocks), dim=dim, dtype=td, **HYPER)
    assert out[0] is Vt and out[1] is nVt  # updated in place
    _close(Vt, np.asarray(Vj).reshape(vb, dim))
    _close(nVt, np.asarray(nVj).reshape(vb, dim))
    # untouched and sentinel slots change nothing
    hit = ts.uniq[vtouched > 0]
    rest = np.setdiff1d(np.arange(vb), hit)
    np.testing.assert_array_equal(Vt.numpy()[rest], V[rest])
    np.testing.assert_array_equal(nVt.numpy()[rest], nV[rest])
    assert (Vt.numpy()[hit] != V[hit]).any(1).all()


def test_fm_wrappers_reject_bad_arguments():
    V = torch.zeros(j_ck.TILE_HI, 8)
    sidx = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):  # rows not a multiple of TILE_HI
        t_ck.fm_push_contrib(torch.zeros(100, 8), torch.zeros(64, 8),
                             torch.zeros(64), sidx, None, None)
    with pytest.raises(ValueError):  # a not (P, dim)
        t_ck.fm_push_contrib(V, torch.zeros(64, 4), torch.zeros(64), sidx,
                             None, None)
    with pytest.raises(ValueError):  # dim not a power of two
        t_fu.row_tile_gather(torch.zeros(24, 128), sidx, None, 6)
    with pytest.raises(ValueError):  # gV not (u_cap, dim)
        t_fu.v_scatter_update(V, V.clone(), torch.zeros(64, 4),
                              torch.zeros(64), sidx, None, None, None,
                              dim=8, **HYPER)
