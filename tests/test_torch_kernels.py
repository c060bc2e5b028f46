"""The port's four kernels.

On the CPU the wrappers run the kernels' plain PyTorch versions; these
are held against the JAX package's Pallas kernels in interpret mode, at
the bar of tests/test_coo_kernels.py (rtol 1e-5, atol 1e-4), for f32 and
for bf16. In bf16 both packages round at the same points (the gathered
table value, then its product with val; the scattered gradient), so the
same bar holds. The CUDA kernels themselves run only on the card (see
tests/test_torch_cuda.py).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wormhole_tpu.ops import coo_kernels as j_ck
from wormhole_tpu.ops import fused_update as j_fu
from wormhole_tpu.ops import penalty as j_pen
from wormhole_tpu_torch.ops import _cuda
from wormhole_tpu_torch.ops import coo_kernels as t_ck
from wormhole_tpu_torch.ops import fused_update as t_fu

RTOL, ATOL = 1e-5, 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
T = torch.from_numpy


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _batch(num_rows, nnz, nb, seed, skew):
    rng = np.random.default_rng(seed)
    cap = num_rows * nnz
    raw = rng.zipf(1.3, size=cap) if skew else rng.integers(0, nb, size=cap)
    idx = (raw % nb).astype(np.int32)
    seg = np.repeat(np.arange(num_rows, dtype=np.int32), nnz)
    val = rng.normal(size=cap).astype(np.float32)
    val[rng.random(cap) < 0.1] = 0.0  # padding-like entries
    return seg, idx, val


def _packed(p):
    return [p.idx, p.seg, p.val, p.tmap, p.first]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("skew", [False, True])
def test_coo_spmv_plain_matches_pallas(skew, dt):
    num_rows, nb = 256, 2 * t_ck.TILE
    seg, idx, val = _batch(num_rows, 13, nb, seed=1, skew=skew)
    w = np.random.default_rng(2).normal(size=nb).astype(np.float32)
    p = t_ck.pack_sorted_coo(idx, seg, val, nb)
    jd, td = DTYPES[dt]
    want = j_ck.coo_spmv(jnp.asarray(w), *map(jnp.asarray, _packed(p)),
                         num_rows, dtype=jd)
    got = t_ck.coo_spmv(T(w), *map(T, _packed(p)), num_rows, dtype=td)
    _close(got, want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("skew", [False, True])
def test_coo_spmv_t_plain_matches_pallas(skew, dt):
    num_rows, nb = 256, 2 * t_ck.TILE
    seg, idx, val = _batch(num_rows, 13, nb, seed=3, skew=skew)
    d = np.random.default_rng(4).normal(size=num_rows).astype(np.float32)
    p = t_ck.pack_sorted_coo(idx, seg, val, nb)
    jd, td = DTYPES[dt]
    want = j_ck.coo_spmv_t(jnp.asarray(d), *map(jnp.asarray, _packed(p)),
                           nb, dtype=jd)
    got = t_ck.coo_spmv_t(T(d), *map(T, _packed(p)), nb, dtype=td)
    _close(got, want)


def test_coo_spmv_t_empty_tiles_exactly_zero():
    """All keys in tile 0, including key 0 itself, which the other tiles'
    pad entries (idx = tile base, val 0) must not overwrite."""
    nb, num_rows = 4 * t_ck.TILE, 128
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 64, size=num_rows * 5).astype(np.int32)
    seg = np.repeat(np.arange(num_rows, dtype=np.int32), 5)
    val = rng.normal(size=len(idx)).astype(np.float32)
    d = rng.normal(size=num_rows).astype(np.float32)
    p = t_ck.pack_sorted_coo(idx, seg, val, nb)
    got = t_ck.coo_spmv_t(T(d), *map(T, _packed(p)), nb).numpy()
    want = j_ck.coo_spmv_t(jnp.asarray(d), *map(jnp.asarray, _packed(p)),
                           nb)
    _close(got, want)
    assert not got[t_ck.TILE:].any()
    assert got[0] != 0.0


def _slots(nb, n_keys, u_blocks, seed):
    rng = np.random.default_rng(seed)
    uniq = np.unique(rng.integers(0, nb, size=n_keys))
    return t_ck.assign_tile_slots(uniq, t_ck.TILE, u_blocks * t_ck.BLK_U,
                                  nb)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tile_gather_plain_matches_pallas(dt):
    nb = 4 * t_ck.TILE
    ts = _slots(nb, 3000, 8, seed=5)
    assert (ts.uniq == nb).any()  # sentinel slots present
    table = np.random.default_rng(6).normal(size=nb).astype(np.float32)
    jd, td = DTYPES[dt]
    want = j_ck.tile_gather(jnp.asarray(table).reshape(-1, 128),
                            jnp.asarray(ts.uniq), jnp.asarray(ts.tmap_u),
                            dtype=jd)
    got = t_ck.tile_gather(T(table).view(-1, 128), T(ts.uniq),
                           T(ts.tmap_u), dtype=td)
    _close(got, want)
    assert not got.numpy()[ts.uniq == nb].any()


HYPER = dict(lr_eta=0.5, lr_beta=1.0, lambda_l1=0.3, lambda_l2=0.1)


def _update_inputs(algo, nb, seed):
    """Slots over 4 tiles with sentinels, a compact gradient with some
    exact zeros at live slots, and state tables where FTRL's w is the
    pure function of (z, n) that the reference keeps."""
    rng = np.random.default_rng(seed)
    ts = _slots(nb, 3000, 8, seed)
    live = ts.uniq < nb
    g = np.where(live, rng.normal(size=ts.uniq.size), 0).astype(np.float32)
    g[np.flatnonzero(live)[::7]] = 0.0
    z = rng.normal(size=nb).astype(np.float32)
    n = (rng.random(nb) * 3).astype(np.float32)
    if algo == "ftrl":
        eta = (HYPER["lr_beta"] + jnp.sqrt(n)) / HYPER["lr_eta"]
        w = np.asarray(j_pen.l1l2_solve(-jnp.asarray(z), eta,
                                        HYPER["lambda_l1"],
                                        HYPER["lambda_l2"]))
    else:
        w = rng.normal(size=nb).astype(np.float32)
        w[::5] = 0.0
    names = {"ftrl": ("w", "z", "n"), "adagrad": ("w", "n"),
             "sgd": ("w",)}[algo]
    state = {k: v for k, v in (("w", w), ("z", z), ("n", n)) if k in names}
    return ts, g, state


@pytest.mark.parametrize("fixed_bytes", [0, 1, 2])
@pytest.mark.parametrize("algo", ["ftrl", "adagrad", "sgd"])
def test_scatter_update_plain_matches_pallas(algo, fixed_bytes):
    nb = 4 * t_ck.TILE
    ts, g, state = _update_inputs(algo, nb, seed=10 + fixed_bytes)
    blocks = (ts.uniq, ts.tmap_u, ts.first_u, ts.last_u)
    j_state, nw_j = j_fu.scatter_update(
        algo, {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(g), *map(jnp.asarray, blocks), fixed_bytes=fixed_bytes,
        dtype=jnp.float32, **HYPER)
    t_state = {k: T(v.copy()) for k, v in state.items()}
    out, nw_t = t_fu.scatter_update(algo, t_state, T(g), *map(T, blocks),
                                    fixed_bytes=fixed_bytes,
                                    dtype=torch.float32, **HYPER)
    assert out is t_state  # updated in place
    for k in state:
        _close(t_state[k], j_state[k])
    assert int(nw_t) == int(nw_j)
    # only live slots move
    moved = t_state["w"].numpy() != state["w"]
    assert not moved[np.setdiff1d(np.arange(nb), ts.uniq)].any()


def test_scatter_update_additive_table_and_bf16():
    nb = 4 * t_ck.TILE
    ts, g, state = _update_inputs("ftrl", nb, seed=20)
    cnt = np.random.default_rng(21).integers(0, 5, nb).astype(np.float32)
    add = np.where(ts.uniq < nb, 3.0, 0.0).astype(np.float32)
    state["cnt"] = cnt
    blocks = (ts.uniq, ts.tmap_u, ts.first_u, ts.last_u)
    j_state, nw_j = j_fu.scatter_update(
        "ftrl", {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(g), *map(jnp.asarray, blocks), dtype=jnp.bfloat16,
        add_table="cnt", add_values=jnp.asarray(add), **HYPER)
    t_state = {k: T(v.copy()) for k, v in state.items()}
    _, nw_t = t_fu.scatter_update("ftrl", t_state, T(g), *map(T, blocks),
                                  dtype=torch.bfloat16, add_table="cnt",
                                  add_values=T(add), **HYPER)
    for k in state:
        _close(t_state[k], j_state[k])
    assert int(nw_t) == int(nw_j)
    live = ts.uniq[ts.uniq < nb]
    np.testing.assert_array_equal(t_state["cnt"].numpy()[live],
                                  cnt[live] + 3.0)


def test_wrappers_reject_bad_arguments():
    w = torch.zeros(2 * t_ck.TILE)
    z = torch.zeros(4096, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_ck.coo_spmv(w, z, z, torch.zeros(4096), None, None, 100)
    with pytest.raises(ValueError):
        t_ck.coo_spmv(w, z, z, torch.zeros(4096), None, None, 128,
                      dtype=torch.float16)
    with pytest.raises(ValueError):
        t_fu.scatter_update("ftrl", {"w": w, "z": w, "n": w},
                            torch.zeros(8), z, None, None, None,
                            fixed_bytes=3, **HYPER)


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed: this checks the error without it")
    missing = [n for n in _cuda.SOURCES if not _cuda.lib_path(n).exists()]
    if not missing:
        pytest.skip("kernel libraries are already built")
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build(missing)


@pytest.mark.parametrize("nb", [1 << 22, 1 << 26])
def test_both_packs_put_live_slots_first_in_each_block(nb):
    """The card's scatter_update skips all-sentinel warp chunks; it is
    fast because both packages' packs put each tile's keys at the front
    of its BLK_U blocks (and right for any layout, see below)."""
    from wormhole_tpu_torch.data.synth import synth_criteo_batch

    seg, idx, val, _, _ = synth_criteo_batch(np.random.default_rng(30),
                                             2048, nb)
    u_cap = -(-t_ck.tile_blocks_needed(np.unique(idx), t_ck.TILE)
              * t_ck.BLK_U // t_ck.TILE) * t_ck.TILE
    tt = t_ck.pack_tile_coo(idx, seg, val, nb, u_cap)
    tj = j_ck.pack_tile_coo(idx, seg, val, nb, u_cap)
    np.testing.assert_array_equal(tt.uniq, tj.uniq)
    assert tt.num_uniq == np.unique(idx).size and tt.dropped_uniq == 0
    live = (tt.uniq < nb).reshape(-1, t_ck.BLK_U)
    # within a block, no live slot follows a sentinel
    assert not (live[:, 1:] & ~live[:, :-1]).any()
    assert (tt.uniq == nb).mean() > 0.5  # the holes the kernel skips


@pytest.mark.parametrize("algo", ["ftrl", "adagrad", "sgd"])
def test_scatter_update_plain_matches_pallas_with_mid_block_sentinels(algo):
    """Sentinels in the middle of blocks, live keys in any order within
    their block: the JAX kernel and the plain version still agree."""
    nb = 4 * t_ck.TILE
    ts, g, state = _update_inputs(algo, nb, seed=40)
    rng = np.random.default_rng(41)
    perm = np.concatenate([b * t_ck.BLK_U + rng.permutation(t_ck.BLK_U)
                           for b in range(ts.uniq.size // t_ck.BLK_U)])
    uniq, gp = ts.uniq[perm], g[perm]
    assert ((uniq.reshape(-1, t_ck.BLK_U)[:, :8] == nb).any()
            and (uniq.reshape(-1, t_ck.BLK_U)[:, -8:] < nb).any())
    blocks = (uniq, ts.tmap_u, ts.first_u, ts.last_u)
    j_state, nw_j = j_fu.scatter_update(
        algo, {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(gp), *map(jnp.asarray, blocks), dtype=jnp.float32,
        **HYPER)
    t_state = {k: T(v.copy()) for k, v in state.items()}
    _, nw_t = t_fu.scatter_update(algo, t_state, T(gp), *map(T, blocks),
                                  dtype=torch.float32, **HYPER)
    for k in state:
        _close(t_state[k], j_state[k])
    assert int(nw_t) == int(nw_j)


def _push_edge_stream(case, seed):
    """(idx, seg, val, num_buckets) of a batch at one of the push's edges,
    over num_buckets 4 * TILE: a hot run over BLK edges, runs ending on
    BLK edges, tiles of pads only, live runs at tile bases, far-apart keys
    before a tile's pads, live entries with val 0, the table's corners."""
    nb, tile, blk = 4 * t_ck.TILE, t_ck.TILE, t_ck.BLK
    rng = np.random.default_rng(seed)
    spread = rng.integers(0, nb, size=3000)
    if case == "hot-run":        # one run over BLK edges and many chunks
        idx = np.concatenate([np.full(3 * blk + 100, 7), spread])
    elif case == "chunk-edge":   # runs end exactly on chunk edges
        idx = np.concatenate([np.full(blk, 1), np.full(blk - 5, 2),
                              np.full(5, 3), spread[:500] % tile + tile])
    elif case == "pads-only-tile":  # tiles 1 and 3 hold pads only
        idx = np.concatenate([spread[:800] % tile,
                              2 * tile + spread[800:1600] % tile])
    elif case == "base-then-pads":  # live runs at tile bases, pads behind
        idx = np.concatenate([np.full(5, tile), np.full(3, 2 * tile),
                              np.full(2, 2 * tile + 9), spread[:200] % tile])
    elif case == "sparse-then-pads":  # far-apart keys, then pads, in a warp
        idx = np.concatenate([np.arange(1, 301) * 211, spread[:400] % tile
                              + tile])
    elif case == "zero-val":     # live entries with val 0
        idx = np.concatenate([np.full(6, 11), [12], spread[:900]])
    else:                        # "edges": tile base, tile end - 1, last
        idx = np.concatenate([[0, tile - 1, tile, 2 * tile - 1, nb - 1] * 3,
                              spread[:700]])
    idx = idx.astype(np.int32)
    seg = rng.integers(0, 256, size=idx.size).astype(np.int32)
    val = rng.normal(size=idx.size).astype(np.float32)
    val[val == 0] = 1.0
    if case == "zero-val":
        val[[2, 6]] = 0.0  # one inside key 11's run, key 12's only entry
    return idx, seg, val, nb


PUSH_CASES = ["hot-run", "chunk-edge", "pads-only-tile", "base-then-pads",
              "sparse-then-pads", "zero-val", "edges", "compact"]


def _push_case(case):
    """A packed stream at one push edge: (idx, seg, val, num_buckets)."""
    if case == "compact":  # pack_tile_coo's compact stream at 2^22
        from wormhole_tpu_torch.data.synth import synth_criteo_batch

        seg, idx, val, _, _ = synth_criteo_batch(np.random.default_rng(31),
                                                 1024, 1 << 22)
        u_cap = 4 * t_ck.TILE
        p = t_ck.pack_tile_coo(idx, seg, val, 1 << 22, u_cap).coo
        assert (p.val == 0).any() and p.idx.size > u_cap // t_ck.TILE
        return p, u_cap
    idx, seg, val, nb = _push_edge_stream(case, seed=len(case))
    return t_ck.pack_sorted_coo(idx, seg, val, nb), nb


def _sum_close(got, want, mag):
    """atol 1e-4 + rtol 1e-5 * the sum of the terms' magnitudes: the
    kernels sum a bucket's terms in another order than index_add_."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= ATOL + RTOL * np.asarray(mag)).all(), float(err.max())


@pytest.mark.parametrize("case", PUSH_CASES)
def test_coo_spmv_t_matches_pallas_on_edge_streams(case):
    """The push (its plain version, which the wrapper runs on the CPU)
    against the JAX Pallas kernel on streams at the push's edges, in f32
    and bf16; every untouched bucket exactly 0."""
    p, nb = _push_case(case)
    d = np.random.default_rng(5).normal(size=1024).astype(np.float32)
    mag = t_ck.coo_spmv_t_plain(T(np.abs(d)), T(p.idx).long(),
                                T(p.seg).long(), T(np.abs(p.val)), nb,
                                torch.float32).numpy()
    touched = np.zeros(nb, bool)
    touched[p.idx[p.val != 0]] = True
    for dt in ("f32", "bf16"):
        jd, td = DTYPES[dt]
        got = t_ck.coo_spmv_t(T(d), *map(T, _packed(p)), nb,
                              dtype=td).numpy()
        assert not got[~touched].any()
        want = j_ck.coo_spmv_t(jnp.asarray(d), *map(jnp.asarray, _packed(p)),
                               nb, dtype=jd)
        _sum_close(got, want, mag)


def _layout_facts(p, nb):
    """The packed stream's tile layout: each tile in at least one block,
    blocks of a tile consecutive, a block's tile its first entry's, live
    keys ascending in a tile, pads (val 0, tile base) after them."""
    tiles = nb // t_ck.TILE
    block_tile = p.idx[::t_ck.BLK] // t_ck.TILE
    np.testing.assert_array_equal(block_tile, p.tmap)
    assert (np.diff(block_tile) >= 0).all()
    assert set(block_tile.tolist()) == set(range(tiles))
    tile_of = np.repeat(block_tile, t_ck.BLK)
    for t in range(tiles):
        ent = np.flatnonzero(tile_of == t)
        live = p.val[ent] != 0
        n_live = int(live.sum())
        assert live[:n_live].all()  # pads last
        assert (p.idx[ent[n_live:]] == t * t_ck.TILE).all()
        keys = p.idx[ent[:n_live]]
        assert (np.diff(keys) >= 0).all()
        assert ((keys // t_ck.TILE) == t).all()


@pytest.mark.parametrize("nb", [1 << 22, 1 << 26])
def test_both_packs_give_the_tile_layout(nb):
    """Both packages' packs, dense at 2^22 and compact at 2^26, give the
    same stream, in the tile layout the kernels read (tmap, pads)."""
    from wormhole_tpu_torch.data.synth import synth_criteo_batch

    seg, idx, val, _, _ = synth_criteo_batch(np.random.default_rng(32),
                                             2048, nb)
    if nb == 1 << 22:
        packs = [t_ck.pack_sorted_coo(idx, seg, val, nb),
                 j_ck.pack_sorted_coo(idx, seg, val, nb)]
        dom = nb
    else:
        dom = -(-t_ck.tile_blocks_needed(np.unique(idx), t_ck.TILE)
                * t_ck.BLK_U // t_ck.TILE) * t_ck.TILE
        packs = [t_ck.pack_tile_coo(idx, seg, val, nb, dom).coo,
                 j_ck.pack_tile_coo(idx, seg, val, nb, dom).coo]
    for p in packs:
        _layout_facts(p, dom)
    np.testing.assert_array_equal(packs[0].idx, packs[1].idx)
