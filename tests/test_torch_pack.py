"""The port's host pack is byte-identical to the JAX package's: the same
numpy inputs give the same arrays to both packages' kernels."""

import numpy as np
import pytest

import bench
from wormhole_tpu.data import rowblock as j_rb
from wormhole_tpu.ops import coo_kernels as j_ck
from wormhole_tpu.ops import localizer as j_loc
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
    for name in ("TILE_HI", "LANES", "TILE", "BLK", "BLK_U"):
        assert getattr(t_ck, name) == getattr(j_ck, name), name
    assert t_ck.TILE == 512 * 128 and t_ck.BLK == 4096 and t_ck.BLK_U == 1024


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
