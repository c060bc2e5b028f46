"""The port's host pack is byte-identical to the JAX package's: the same
numpy inputs give the same arrays to both packages' kernels, through
numpy's sorts and through torch's (the card's route, run on the CPU)."""

import numpy as np
import pytest

import bench
from wormhole_tpu.data import rowblock as j_rb
from wormhole_tpu.ops import coo_kernels as j_ck
from wormhole_tpu.ops import localizer as j_loc
from wormhole_tpu_torch import native
from wormhole_tpu_torch.data import rowblock as t_rb
from wormhole_tpu_torch.data import synth as t_synth
from wormhole_tpu_torch.ops import coo_kernels as t_ck
from wormhole_tpu_torch.ops import localizer as t_loc


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _assert_same_fields(x, y, fields):
    for f in fields:
        _assert_same(getattr(x, f), getattr(y, f))


def _coo(n_rows, nnz, nb, seed, skew):
    rng = np.random.default_rng(seed)
    cap = n_rows * nnz
    raw = rng.zipf(1.3, size=cap) if skew else rng.integers(0, nb, size=cap)
    idx = (raw % nb).astype(np.int32)
    seg = np.repeat(np.arange(n_rows, dtype=np.int32), nnz)
    val = rng.normal(size=cap).astype(np.float32)
    val[rng.random(cap) < 0.1] = 0.0
    return seg, idx, val


def test_geometry_constants_equal():
    for name in ("TILE_HI", "LANES", "TILE", "BLK", "BLK_U", "FM_BLK"):
        assert getattr(t_ck, name) == getattr(j_ck, name), name
    assert t_ck.TILE == 512 * 128 and t_ck.BLK == 4096 and t_ck.BLK_U == 1024
    assert t_ck.FM_BLK == 1024


@pytest.mark.parametrize("weighted", [False, True])
def test_to_device_batch_identical(weighted):
    rng = np.random.default_rng(0)
    lens = rng.integers(1, 9, size=300)
    offset = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    index = rng.integers(0, 2**63, size=offset[-1], dtype=np.uint64)
    value = rng.random(offset[-1]).astype(np.float32)
    label = (rng.random(300) < 0.4).astype(np.float32)
    weight = rng.random(300).astype(np.float32) if weighted else None
    # capacity cuts the batch mid-row and rows overflow num_rows
    args = (256, 1000, 1 << 12)
    a = j_rb.to_device_batch(j_rb.RowBlock(label, offset, index, value,
                                           weight), *args)
    b = t_rb.to_device_batch(t_rb.RowBlock(label, offset, index, value,
                                           weight), *args)
    _assert_same_fields(a, b, ("seg", "idx", "val", "label", "row_mask"))
    assert a.dropped_rows == b.dropped_rows > 0


def test_localize_identical():
    keys = np.random.default_rng(1).integers(0, 5000, size=20000,
                                             dtype=np.uint64) * 977
    a, b = j_loc.localize(keys), t_loc.localize(keys)
    _assert_same_fields(a, b, ("uniq_keys", "counts", "local_index"))


@pytest.mark.parametrize("skew", [False, True])
def test_pack_sorted_coo_identical(skew):
    nb = 4 * t_ck.TILE
    seg, idx, val = _coo(256, 13, nb, seed=2, skew=skew)
    a = j_ck.pack_sorted_coo(idx, seg, val, nb, capacity=len(idx) + 100)
    b = t_ck.pack_sorted_coo(idx, seg, val, nb, capacity=len(idx) + 100)
    _assert_same_fields(a, b, ("idx", "seg", "val", "tmap", "first"))
    assert t_ck.packed_size(999, nb) == j_ck.packed_size(999, nb)


@pytest.mark.parametrize("u_blocks", [64, 3])  # roomy, and the overflow cut
def test_assign_tile_slots_identical(u_blocks):
    rng = np.random.default_rng(3)
    nb = 16 * t_ck.TILE
    uniq = np.unique(rng.integers(0, nb, size=6000)).astype(np.uint64)
    u_cap = u_blocks * t_ck.BLK_U
    a = j_ck.assign_tile_slots(uniq, j_ck.TILE, u_cap, nb)
    b = t_ck.assign_tile_slots(uniq, t_ck.TILE, u_cap, nb)
    _assert_same_fields(a, b, ("uniq", "tmap_u", "first_u", "last_u",
                               "slot_of_uniq"))
    assert (a.num_uniq, a.dropped_uniq) == (b.num_uniq, b.dropped_uniq)
    assert (b.dropped_uniq > 0) == (u_blocks == 3)
    assert (t_ck.tile_blocks_needed(uniq, t_ck.TILE)
            == j_ck.tile_blocks_needed(uniq, j_ck.TILE))


@pytest.mark.parametrize("u_tiles,fast", [(4, True), (4, False), (1, False)])
def test_pack_tile_coo_identical(u_tiles, fast):
    """With the row-major companion layout: the fixed-width fast path,
    the general path (ragged rows, one row over the width), and the
    overflow cut."""
    nb = 32 * t_ck.TILE
    rng = np.random.default_rng(4)
    if fast:
        seg, idx, val = _coo(128, 16, nb, seed=5, skew=True)
        val[:] = 1.0
    else:
        lens = rng.integers(1, 16, size=128)
        lens[7] = 20  # overflows rm_width: dropped from both streams
        seg = np.repeat(np.arange(128, dtype=np.int32), lens)
        idx = rng.integers(0, nb, size=seg.size).astype(np.int32)
        val = rng.normal(size=seg.size).astype(np.float32)
    kw = dict(capacity=128 * 16 + 64, rm_rows=128, rm_width=16)
    if u_tiles == 1:  # keys over 128 tiles need 128 blocks: 64 fit
        nb = 128 * t_ck.TILE
        idx = rng.integers(0, nb, size=seg.size).astype(np.int32)
    a = j_ck.pack_tile_coo(idx, seg, val, nb, u_tiles * j_ck.TILE, **kw)
    b = t_ck.pack_tile_coo(idx, seg, val, nb, u_tiles * t_ck.TILE, **kw)
    _assert_same_fields(a, b, ("uniq", "tmap_u", "first_u", "last_u",
                               "rm_slot", "rm_val"))
    _assert_same_fields(a.coo, b.coo, ("idx", "seg", "val", "tmap", "first"))
    assert ((a.num_uniq, a.dropped_uniq, a.dropped_nnz)
            == (b.num_uniq, b.dropped_uniq, b.dropped_nnz))
    assert (b.dropped_nnz > 0) == (u_tiles == 1)


def test_synth_criteo_batch_matches_bench():
    a = bench.synth_criteo_batch(np.random.default_rng(7), 512, 1 << 20)
    b = t_synth.synth_criteo_batch(np.random.default_rng(7), 512, 1 << 20)
    for x, y in zip(a, b):
        _assert_same(x, y)


# --------------------------------------- the pack's sorts through torch
# native's torch route (the card's) runs on the CPU too; routing the
# pack's sorts and uniques through it holds it against numpy's route and
# the JAX pack.
@pytest.fixture
def torch_route(monkeypatch):
    monkeypatch.setattr(native, "unique", lambda keys, device=None:
                        native.torch_unique(keys, "cpu"))
    monkeypatch.setattr(native, "sort_by_key",
                        lambda keys, payloads, device=None:
                        native.torch_sort_by_key(keys, payloads, "cpu"))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint64])
@pytest.mark.parametrize("n", [0, 1, 5000])
def test_native_torch_route_equals_numpy(dtype, n):
    """torch_unique is np.unique, and torch_sort_by_key the stable
    argsort (an arange payload) and the gathers, byte for byte."""
    rng = np.random.default_rng(n)
    keys = (rng.zipf(1.3, size=n) % 3000).astype(dtype)
    for a, b in zip(native.torch_unique(keys, "cpu"),
                    np.unique(keys, return_inverse=True, return_counts=True)):
        _assert_same(a, b)
    o = np.argsort(keys, kind="stable")
    payloads = (np.arange(n), keys, rng.normal(size=n).astype(np.float32),
                rng.integers(0, 9, size=n).astype(np.int32))
    sk, got = native.torch_sort_by_key(keys, payloads, "cpu")
    _assert_same(sk, keys[o])
    for g, p in zip(got, payloads):
        _assert_same(g, p[o])


def test_native_public_calls_take_the_route_of_their_device():
    """On the CPU (None or "cpu") unique and sort_by_key are numpy's."""
    keys = np.array([5, 3, 5, 1], np.int64)
    o = np.argsort(keys, kind="stable")
    for dev in (None, "cpu"):
        sk, (sp,) = native.sort_by_key(keys, (np.arange(4),), dev)
        _assert_same(sk, keys[o])
        _assert_same(sp, o)
        for a, b in zip(native.unique(keys, dev),
                        np.unique(keys, return_inverse=True,
                                  return_counts=True)):
            _assert_same(a, b)


@pytest.mark.parametrize("keys", [
    np.array([1, 2**63], np.uint64), np.array([2**64 - 1], np.uint64),
    np.array([3, -1], np.int64), np.array([-5], np.int32)])
def test_native_torch_route_refuses_keys_outside_int64(keys):
    for call in (lambda: native.torch_unique(keys, "cpu"),
                 lambda: native.torch_sort_by_key(keys, (), "cpu")):
        with pytest.raises(ValueError, match="2\\^63"):
            call()


def test_localize_through_torch_matches_jax(torch_route):
    keys = np.random.default_rng(1).integers(0, 5000, size=20000,
                                             dtype=np.uint64) * 977
    a, b = j_loc.localize(keys), t_loc.localize(keys, "cpu")
    _assert_same_fields(a, b, ("uniq_keys", "counts", "local_index"))


@pytest.mark.parametrize("skew", [False, True])
def test_pack_sorted_coo_through_torch_matches_jax(torch_route, skew):
    nb = 4 * t_ck.TILE
    seg, idx, val = _coo(256, 13, nb, seed=2, skew=skew)
    a = j_ck.pack_sorted_coo(idx, seg, val, nb, capacity=len(idx) + 100)
    b = t_ck.pack_sorted_coo(idx, seg, val, nb, capacity=len(idx) + 100,
                             device="cpu")
    _assert_same_fields(a, b, ("idx", "seg", "val", "tmap", "first"))


@pytest.mark.parametrize("u_tiles", [4, 1])
def test_pack_tile_coo_through_torch_matches_jax(torch_route, u_tiles):
    nb = 128 * t_ck.TILE if u_tiles == 1 else 32 * t_ck.TILE
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 16, size=128)
    lens[7] = 20  # overflows rm_width: dropped from both streams
    seg = np.repeat(np.arange(128, dtype=np.int32), lens)
    idx = rng.integers(0, nb, size=seg.size).astype(np.int32)
    val = rng.normal(size=seg.size).astype(np.float32)
    kw = dict(capacity=128 * 16 + 64, rm_rows=128, rm_width=16)
    a = j_ck.pack_tile_coo(idx, seg, val, nb, u_tiles * j_ck.TILE, **kw)
    b = t_ck.pack_tile_coo(idx, seg, val, nb, u_tiles * t_ck.TILE,
                           device="cpu", **kw)
    _assert_same_fields(a, b, ("uniq", "tmap_u", "first_u", "last_u",
                               "rm_slot", "rm_val"))
    _assert_same_fields(a.coo, b.coo, ("idx", "seg", "val", "tmap", "first"))
    assert ((a.num_uniq, a.dropped_uniq, a.dropped_nnz)
            == (b.num_uniq, b.dropped_uniq, b.dropped_nnz))


def test_pack_fm_through_torch_matches_jax(torch_route):
    """DiFacto's pack, train then eval (the count mirror advances in
    between), through the torch route against the JAX learner's."""
    import types

    from wormhole_tpu.models.difacto import DifactoConfig as JConfig
    from wormhole_tpu.models.difacto import DifactoLearner as JLearner
    from wormhole_tpu.parallel.mesh import make_mesh
    from wormhole_tpu_torch.models.difacto import (DifactoConfig,
                                                   DifactoLearner)

    kw = dict(minibatch=256, num_buckets=2 * t_ck.TILE, v_buckets=t_ck.TILE,
              nnz_per_row=13, dim=4, threshold=2, kernel="pallas",
              kernel_dtype="f32")
    seg, idx, val = _coo(256, 13, 2 * t_ck.TILE, seed=6, skew=True)
    db = types.SimpleNamespace(seg=seg, idx=idx.astype(np.int64), val=val)
    j = JLearner(JConfig(**kw), make_mesh(1, 1))
    t = DifactoLearner(DifactoConfig(**kw), device="cpu")
    for train in (True, False):
        pj, pt = j._pack_fm(db, train=train), t._pack_fm(db, train=train)
        flat_j = JLearner._fm_args(j, pj, np.zeros(256), np.ones(256), train)
        flat_t = DifactoLearner._fm_args(pt, np.zeros(256), np.ones(256),
                                         train)
        assert len(flat_j) == len(flat_t)
        for a, b in zip(flat_j, flat_t):
            _assert_same(np.asarray(a).astype(b.dtype, copy=False), b)


def test_solver_keeps_the_loader_stall_beside_the_wall(tmp_path):
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    rng = np.random.default_rng(0)
    path = tmp_path / "train.libsvm"
    path.write_text("".join(
        f"{r % 2} " + " ".join(str(k) for k in rng.integers(0, 4096, 9))
        + "\n" for r in range(1000)))
    cfg = LinearConfig(train_data=str(path), minibatch=128, nnz_per_row=9,
                       num_buckets=1 << 12, max_data_pass=1,
                       num_parts_per_file=3, max_concurrency=2)
    solver = MinibatchSolver(LinearLearner(cfg, device="cpu"), cfg,
                             verbose=False)
    solver.iterate(cfg.train_data, True)
    assert solver.last_pass_wall_s > 0
    assert 0.0 <= solver.last_pass_stall_s <= solver.last_pass_wall_s
