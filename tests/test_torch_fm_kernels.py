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
@pytest.mark.parametrize("dim", [1, 4, 8, 16])
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
@pytest.mark.parametrize("dim", [2, 8, 32])
def test_v_scatter_update_plain_matches_pallas(dim, dt):
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


@pytest.mark.parametrize("u_cap", [128, 8 * j_ck.BLK_U - 1037, 8 * j_ck.BLK_U])
@pytest.mark.parametrize("dim", [1, 2, 8, 128])
def test_row_walk_covers_each_entry_once(dim, u_cap):
    """The row kernels' split of the slots (ops.fused_update.row_walk, the
    mirror of csrc/fused_update.cu's walk) on a grid of 2 SMs, so warps
    take several chunks: each (slot, channel) once, a lane's vector in one
    row, neighbouring lanes on neighbouring vectors, each chunk in one
    warp; a gather through it is the plain version's."""
    width = min(dim, 4)
    walk = t_fu.row_walk(u_cap, dim, sms=2)
    warp, chunk, it, lane, slot, chan = walk.T
    warps = t_fu.row_grid(u_cap, 2) * t_fu.ROW_WARPS
    assert warps < -(-u_cap // t_fu.ROW_CHUNK) or u_cap <= 128
    flat = slot * dim + chan
    np.testing.assert_array_equal(
        flat, chunk * t_fu.ROW_CHUNK * dim + (32 * it + lane) * width)
    assert (chan % width == 0).all() and (chan + width <= dim).all()
    assert (slot // t_fu.ROW_CHUNK == chunk).all()
    np.testing.assert_array_equal(warp, chunk % warps)
    cover = np.zeros(u_cap * dim, np.int64)
    np.add.at(cover, (flat[:, None] + np.arange(width)).ravel(), 1)
    assert (cover == 1).all()
    rng = np.random.default_rng(dim)
    rows = 3 * u_cap
    uniq = rng.integers(0, rows + 1, size=u_cap).astype(np.int32)
    V = rng.normal(size=(rows, dim)).astype(np.float32)
    Vs = np.vstack([V, np.zeros((1, dim), np.float32)])  # sentinel -> 0
    got = np.zeros(u_cap * dim, np.float32)
    for j in range(width):
        got[flat + j] = Vs[uniq[slot], chan + j]
    want = t_fu.row_tile_gather(T(V), T(uniq), None, dim, torch.float32)
    np.testing.assert_array_equal(got.reshape(u_cap, dim), want.numpy())


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


def _edge_stream(case, rows, dim, seed):
    """A slot-sorted V-side stream at one of the FM push's edges, packed
    by the JAX host function, with a and b zero at the pad entries."""
    rng = np.random.default_rng(seed)
    chunk = t_ck._FM_CHUNK
    if case == "long-run":     # one run over more than 40 chunks
        slots = np.concatenate([np.full(41 * chunk + 5, 3),
                                rng.integers(0, rows, size=2000)])
    elif case == "cta-edge":   # runs end on chunk edges and a thread edge
        slots = np.concatenate([np.full(2 * chunk, 1), np.full(chunk, 2),
                                np.full(24, 4),
                                rng.integers(5, rows, size=3000)])
    elif case == "zero-sum-pads":  # tile 0's last live run sums to 0
        slots = np.concatenate([rng.integers(0, j_ck.TILE_HI - 1, size=900),
                                [j_ck.TILE_HI - 1] * 2,
                                rng.integers(j_ck.TILE_HI, rows, size=900)])
    elif case == "singletons":  # only one-entry runs
        slots = rng.permutation(rows)[:rows // 2]
    else:                       # "empty": pads only
        slots = np.zeros(0, np.int64)
    seg = rng.integers(0, 128, size=slots.size).astype(np.int32)
    val = rng.normal(size=slots.size).astype(np.float32)
    val[val == 0] = 1.0
    p = j_ck.pack_sorted_coo(slots, seg, val, rows,
                             capacity=slots.size + 2 * j_ck.FM_BLK,
                             tile=j_ck.TILE_HI, blk=j_ck.FM_BLK)
    live = p.val != 0
    a = (rng.normal(size=(p.idx.size, dim)) * live[:, None]).astype(np.float32)
    b = (rng.normal(size=p.idx.size) * live).astype(np.float32)
    if case == "zero-sum-pads":
        e0, e1 = np.flatnonzero(live & (p.idx == j_ck.TILE_HI - 1))
        a[e1], b[e1] = -a[e0], -b[e0]
        assert p.idx[e1 + 1] == 0 and p.val[e1 + 1] == 0  # pads follow
    Vc = rng.normal(size=(rows, dim)).astype(np.float32)
    return p, a, b, Vc


def _sum_close(got, want, mag):
    """atol 1e-4 + rtol 1e-5 * the sum of the terms' magnitudes: the
    kernels sum a row's terms in another order than index_add_."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= 1e-4 + 1e-5 * np.asarray(mag)).all(), float(err.max())


@pytest.mark.parametrize("dim", [1, 8, 128])
@pytest.mark.parametrize("case", ["long-run", "cta-edge", "zero-sum-pads",
                                  "singletons", "empty"])
def test_fm_push_mirror_matches_plain_and_pallas(case, dim):
    """The numpy mirror of the card's FM push bookkeeping (chunks, thread
    slices, run heads, the carries' scan, the combine's chunk windows)
    against the plain version and the JAX Pallas kernel."""
    rows = 4 * j_ck.TILE_HI
    p, a, b, Vc = _edge_stream(case, rows, dim, seed=dim + len(case))
    touched = np.zeros(rows, bool)
    touched[p.idx[p.val != 0]] = True
    mag = t_ck.fm_push_contrib_plain(T(np.abs(Vc)), T(np.abs(a)),
                                     T(-np.abs(b)), T(p.idx).long(),
                                     torch.float32)
    for dt, bf16 in (("f32", False), ("bf16", True)):
        got = t_ck.fm_push_mirror(Vc, a, b, p.idx, bf16=bf16)
        want = t_ck.fm_push_contrib(T(Vc), T(a), T(b), T(p.idx), None, None,
                                    dtype=DTYPES[dt][1])
        _sum_close(got, want, mag)
        assert not got[~touched].any()  # rows with no live entry exactly 0
    want_j = j_ck.fm_push_contrib(J(Vc), J(a), J(b), J(p.idx), J(p.tmap),
                                  J(p.first), dtype=jnp.float32)
    _sum_close(t_ck.fm_push_mirror(Vc, a, b, p.idx), want_j, mag)
    if case == "zero-sum-pads":
        assert not t_ck.fm_push_mirror(Vc, a, b, p.idx)[j_ck.TILE_HI - 1].any()
    if case == "empty":  # and a stream of no entries at all
        assert not t_ck.fm_push_mirror(Vc, a[:0], b[:0], p.idx[:0]).any()
