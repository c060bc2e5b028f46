"""Sparse COO products against a large hashed table, and their host pack.

Host side (numpy, loader threads): the same bucket-sorted, BLK-padded
layout as the JAX package (``SortedCOO``, ``pack_sorted_coo``) and the
same tile-aligned compact slot space (``TileCOO``, ``pack_tile_coo``),
with the same geometry constants, so both packages feed identical arrays
to their kernels.

Device side: four kernels written by hand in CUDA
(``csrc/coo_kernels.cu``), each beside a plain PyTorch version:

- ``coo_spmv``        xw = X w      (pull)
- ``coo_spmv_t``      g = Xᵀ d      (push, in table layout)
- ``tile_gather``     w at the compact slots
- ``fm_push_contrib`` the FM embedding gradient at the compact V rows

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises. ``dtype`` is the kernel's
compute type: ``torch.float32`` (nothing rounds) or ``torch.bfloat16``
(rounds where the TPU kernels' MXU operands round). ``None`` is bf16 on
CUDA and f32 on the CPU, as the JAX kernels default to bf16 on the TPU
and f32 in interpret mode.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from wormhole_tpu_torch.ops import _cuda
from wormhole_tpu_torch.ops.localizer import localize

TILE_HI = 512  # sublanes per tile of the TPU layout
LANES = 128
TILE = TILE_HI * LANES  # buckets per table tile
BLK = 4096  # packed entries per block
BLK_U = 1024  # compact slots per update block
FM_BLK = 1024  # packed entries per block of the FM (V-side) stream
assert TILE % BLK_U == 0, "BLK_U must divide TILE (block map alignment)"


@dataclasses.dataclass
class SortedCOO:
    """A minibatch's COO triples sorted by bucket id and padded into
    BLK-aligned per-tile runs (see pack_sorted_coo)."""

    idx: np.ndarray    # (P,) int32 bucket ids, sorted, pad = tile base
    seg: np.ndarray    # (P,) int32 row ids (arbitrary order within tile)
    val: np.ndarray    # (P,) f32 values, pad = 0
    tmap: np.ndarray   # (P/BLK,) int32: table tile of each block
    first: np.ndarray  # (P/BLK,) int32: 1 iff block is its tile's first

    @property
    def num_blocks(self) -> int:
        return self.tmap.shape[0]


def build_rm(seg, slot, val, num_rows: int, width: int,
             sentinel: int, extra: tuple = ()
             ) -> tuple[np.ndarray, tuple, np.ndarray]:
    """Row-major (num_rows x width) padded companion layout of a
    CSR-ordered COO batch: rm_slot[r*width + j] = slot of row r's j-th
    live nonzero (sentinel in padding), rm_val likewise (0.0 padding).
    The compact pull xw = X w is then one row gather from the compact
    table and a dense reshape-reduce. Fast path: when the batch is
    exactly width-per-row in row order, the layout IS the input.

    Returns (rm_slot, rm_vals, overflow_pos): rm_vals is the rm image of
    val followed by one image per extra channel; overflow_pos are input
    positions of live entries beyond `width` per row, which the CALLER
    must zero in the scatter-side stream so pull and push agree."""
    seg = np.asarray(seg, np.int32)
    slot = np.asarray(slot)
    vals = [np.asarray(val, np.float32)] + [np.asarray(x, np.float32)
                                            for x in extra]
    empty = np.empty(0, np.int64)
    n = num_rows * width
    if len(seg) == n:
        expect = np.repeat(np.arange(num_rows, dtype=np.int32), width)
        if np.array_equal(seg, expect):
            return slot.astype(np.int32, copy=False), tuple(vals), empty
    rm_slot = np.full(n, sentinel, np.int32)
    rm_vals = [np.zeros(n, np.float32) for _ in vals]
    live = vals[0] != 0
    seg_nz, slot_nz = seg[live], slot[live]
    if seg_nz.size and not (np.diff(seg_nz) >= 0).all():
        raise ValueError("build_rm expects row-grouped (CSR order) input")
    pos = (np.arange(seg_nz.shape[0])
           - np.searchsorted(seg_nz, seg_nz, side="left"))
    fit = pos < width
    over = empty
    if not fit.all():
        over = np.flatnonzero(live)[~fit]
        logging.getLogger(__name__).warning(
            "row-major pack: dropped %d nonzeros from rows with more "
            "than %d live entries", len(over), width)
    rm_index = seg_nz[fit] * width + pos[fit]
    rm_slot[rm_index] = slot_nz[fit]
    for rv, v in zip(rm_vals, vals):
        rv[rm_index] = v[live][fit]
    return rm_slot, tuple(rm_vals), over


def packed_size(capacity: int, num_buckets: int,
                tile: int | None = None, blk: int | None = None) -> int:
    """Static padded nnz capacity: every tile may waste up to one block,
    and every tile gets at least one block."""
    num_tiles = num_buckets // (tile or TILE)
    blk = blk or BLK
    return (capacity // blk + num_tiles) * blk


def pack_sorted_coo(idx, seg, val, num_buckets: int,
                    capacity: int | None = None,
                    tile: int | None = None,
                    blk: int | None = None) -> SortedCOO:
    """Sort COO triples by bucket id (stable) and lay them out in
    BLK-padded per-tile runs. Shapes are static given (capacity,
    num_buckets)."""
    tile = tile or TILE
    blk = blk or BLK
    if num_buckets % tile:
        raise ValueError(f"num_buckets must be a multiple of {tile}")
    num_tiles = num_buckets // tile
    if capacity is None:
        capacity = len(idx)
    P = packed_size(capacity, num_buckets, tile, blk)
    nblk = P // blk

    order = np.argsort(np.asarray(idx), kind="stable")
    sidx = np.asarray(idx, np.int32)[order]
    sseg = np.asarray(seg, np.int32)[order]
    sval = np.asarray(val, np.float32)[order]

    tile_of = sidx // tile
    n_t = np.bincount(tile_of, minlength=num_tiles)
    blocks_t = np.maximum((n_t + blk - 1) // blk, 1)
    # trailing spare blocks belong to the last tile (keeps runs contiguous)
    spare = nblk - int(blocks_t.sum())
    if spare < 0:
        raise ValueError(f"{len(idx)} entries overflow packed capacity "
                         f"{capacity}")
    blocks_t[num_tiles - 1] += spare

    out_idx = np.empty(P, np.int32)
    out_seg = np.zeros(P, np.int32)
    out_val = np.zeros(P, np.float32)
    tmap = np.repeat(np.arange(num_tiles, dtype=np.int32), blocks_t)
    first = np.zeros(nblk, np.int32)

    src_off = np.concatenate([[0], np.cumsum(n_t)])
    dst_off = np.concatenate([[0], np.cumsum(blocks_t)]) * blk
    for t in range(num_tiles):
        n = n_t[t]
        d0 = dst_off[t]
        first[d0 // blk] = 1
        out_idx[d0:dst_off[t + 1]] = t * tile  # pad default
        if n:
            s0 = src_off[t]
            out_idx[d0:d0 + n] = sidx[s0:s0 + n]
            out_seg[d0:d0 + n] = sseg[s0:s0 + n]
            out_val[d0:d0 + n] = sval[s0:s0 + n]
    return SortedCOO(out_idx, out_seg, out_val, tmap, first)


# ------------------------------------------- tile-aligned compaction
# At Criteo-1TB table sizes (2^26 buckets) a minibatch touches a small,
# hash-spread fraction of the table. The compacted path maps the batch's
# unique bucket ids to a compact [0, u_cap) slot space, grouped so each
# touched table tile's keys occupy a BLK_U-aligned contiguous slot run,
# and runs the push over the compact domain; the update then touches only
# the batch's keys (ops/fused_update.py).


@dataclasses.dataclass
class TileCOO:
    """A minibatch localized into a tile-aligned compact slot space."""

    uniq: np.ndarray    # (u_cap,) int32 full-table ids per slot, sorted;
    #                     sentinel num_buckets in alignment holes
    coo: SortedCOO      # the batch packed over the compact domain
    tmap_u: np.ndarray  # (u_cap/BLK_U,) int32 full-table tile per block
    first_u: np.ndarray  # (u_cap/BLK_U,) 1 iff block starts its tile's run
    last_u: np.ndarray  # (u_cap/BLK_U,) 1 iff block ends its tile's run
    num_uniq: int
    dropped_uniq: int   # unique keys cut on u_cap overflow
    dropped_nnz: int    # their nonzeros, dropped with them
    rm_slot: np.ndarray | None = None
    rm_val: np.ndarray | None = None


@dataclasses.dataclass
class TileSlots:
    """Tile-run-aligned compact slot assignment for a set of unique ids."""

    uniq: np.ndarray      # (u_cap,) int32 id per slot; sentinel in holes
    tmap_u: np.ndarray    # (u_cap/BLK_U,) int32 table tile per block
    first_u: np.ndarray   # (u_cap/BLK_U,)
    last_u: np.ndarray    # (u_cap/BLK_U,)
    slot_of_uniq: np.ndarray  # (n_uniq,) int64 slot per unique (u_cap = cut)
    num_uniq: int
    dropped_uniq: int


def tile_blocks_needed(ids, rows_per_tile: int) -> int:
    """How many BLK_U update blocks assign_tile_slots allocates for these
    unique ids: the ceil-div per touched tile."""
    n_t = np.bincount(np.asarray(ids, np.int64) // rows_per_tile)
    n_t = n_t[n_t > 0]
    if len(n_t) == 0:
        return 1
    return int(np.sum(-(-n_t // BLK_U)))


def assign_tile_slots(uniq, rows_per_tile: int, u_cap: int,
                      sentinel: int) -> TileSlots:
    """Group sorted unique ids by home table tile and give each tile's run
    a BLK_U-aligned contiguous slot range. On overflow, whole tiles (plus
    a truncated boundary tile) are kept in id order and the rest cut."""
    if u_cap % BLK_U:
        raise ValueError(f"u_cap must be a multiple of {BLK_U}")
    uniq = np.asarray(uniq, np.int64)
    nb = u_cap // BLK_U

    tile_of = uniq // rows_per_tile
    t_ids, n_t = np.unique(tile_of, return_counts=True)
    b_t = np.maximum((n_t + BLK_U - 1) // BLK_U, 1)
    cum_b = np.cumsum(b_t)
    n_keep_tiles = int(np.searchsorted(cum_b, nb, side="right"))
    dropped_uniq = 0
    if n_keep_tiles < len(t_ids):
        blocks_left = nb - (cum_b[n_keep_tiles - 1] if n_keep_tiles else 0)
        if blocks_left > 0:
            b_t[n_keep_tiles] = blocks_left
            n_t[n_keep_tiles] = min(n_t[n_keep_tiles],
                                    blocks_left * BLK_U)
            n_keep_tiles += 1
        kept_uniq = int(np.sum(n_t[:n_keep_tiles]))
        dropped_uniq = len(uniq) - kept_uniq
        t_ids, n_t, b_t = (t_ids[:n_keep_tiles], n_t[:n_keep_tiles],
                           b_t[:n_keep_tiles])
    else:
        kept_uniq = len(uniq)

    dst_base = np.concatenate([[0], np.cumsum(b_t)[:-1]]) * BLK_U
    src_base = np.concatenate([[0], np.cumsum(n_t)[:-1]])
    rank = np.arange(len(uniq), dtype=np.int64)
    tile_rank = np.searchsorted(t_ids, tile_of[:kept_uniq])
    slot_of_uniq = np.full(len(uniq), u_cap, np.int64)  # dropped -> u_cap
    slot_of_uniq[:kept_uniq] = (dst_base[tile_rank]
                                + rank[:kept_uniq] - src_base[tile_rank])

    out_uniq = np.full(u_cap, sentinel, np.int32)
    out_uniq[slot_of_uniq[:kept_uniq]] = uniq[:kept_uniq]

    tmap_u = np.zeros(nb, np.int32)
    first_u = np.zeros(nb, np.int32)
    last_u = np.zeros(nb, np.int32)
    used = int(np.sum(b_t))
    tmap_u[:used] = np.repeat(t_ids, b_t)
    if used:
        tmap_u[used:] = t_ids[-1]  # trailing spare blocks
        ends = np.cumsum(b_t)
        first_u[ends - b_t] = 1
        last_u[ends - 1] = 1
    else:  # degenerate empty batch
        first_u[0] = 1
        last_u[0] = 1
    return TileSlots(out_uniq, tmap_u, first_u, last_u, slot_of_uniq,
                     kept_uniq, dropped_uniq)


def pack_tile_coo(idx, seg, val, num_buckets: int, u_cap: int,
                  capacity: int | None = None,
                  rm_rows: int | None = None,
                  rm_width: int | None = None) -> TileCOO:
    """Localize bucket ids (sort + unique + remap) into tile-run-aligned
    compact slots and pack the COO triples over that domain. With
    rm_rows/rm_width, also emit the row-major companion layout (see
    build_rm) over the compact slot domain, with u_cap as sentinel."""
    if u_cap % TILE:
        raise ValueError(f"u_cap must be a multiple of {TILE}")
    if num_buckets >= 2**31:
        raise ValueError("sentinel id must fit int32")
    idx = np.asarray(idx, np.int64)
    seg = np.asarray(seg, np.int32)
    val = np.asarray(val, np.float32)
    loc = localize(idx.astype(np.uint64))
    ts = assign_tile_slots(loc.uniq_keys, TILE, u_cap, num_buckets)

    new_slot = ts.slot_of_uniq[loc.local_index]
    keep = new_slot < u_cap
    # only real (nonzero-valued) dropped entries count: padding is free
    dropped_nnz = int(np.count_nonzero(~keep & (val != 0)))
    seg_k, val_k, slot_k = seg[keep], val[keep], new_slot[keep]
    rm_slot = rm_val = None
    if rm_rows is not None:
        rm_slot, (rm_val,), over = build_rm(seg_k, slot_k, val_k,
                                            rm_rows, rm_width, u_cap)
        if len(over):
            val_k = val_k.copy()
            val_k[over] = 0.0  # pull/push must agree on the nnz set
    p = pack_sorted_coo(slot_k, seg_k, val_k, u_cap, capacity=capacity)
    return TileCOO(ts.uniq, p, ts.tmap_u, ts.first_u, ts.last_u,
                   ts.num_uniq, ts.dropped_uniq, dropped_nnz,
                   rm_slot, rm_val)


# ------------------------------------------------------------- kernels
def kernel_dtype(dtype, t: torch.Tensor) -> torch.dtype:
    """Resolve a kernel compute dtype: None -> bf16 on CUDA, f32 on CPU."""
    if dtype is None:
        return torch.bfloat16 if t.is_cuda else torch.float32
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    return dtype


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to dtype (half to even) and back to f32."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


def coo_spmv_plain(w, sidx, sseg, sval, num_rows: int, dtype):
    """Plain version of coo_spmv: gather, product, index_add_."""
    p = round_to(round_to(w.index_select(0, sidx), dtype) * sval, dtype)
    out = torch.zeros(num_rows, dtype=torch.float32, device=w.device)
    return out.index_add_(0, sseg, p)


def coo_spmv(w, sidx, sseg, sval, tmap, first, num_rows: int, dtype=None):
    """xw = X w over the sorted/padded COO batch; returns (num_rows,) f32.
    num_rows must be a multiple of 128. tmap/first are the TPU layout's
    block maps, kept for signature parity; the CUDA kernel reads each
    entry's bucket directly and needs neither.

    Replaces wormhole_tpu/ops/coo_kernels.py coo_spmv (_pull_kernel).
    Kernel: csrc/coo_kernels.cu pull_kernel."""
    dtype = kernel_dtype(dtype, w)
    if num_rows % LANES:
        raise ValueError(f"num_rows must be a multiple of {LANES}")
    if not w.is_cuda:
        return coo_spmv_plain(w, sidx, sseg, sval, num_rows, dtype)
    _cuda.require("coo_spmv", w.device, w=w, sidx=sidx, sseg=sseg,
                  sval=sval)
    out = torch.empty(num_rows, dtype=torch.float32, device=w.device)
    rc = _cuda.lib("coo_kernels").wh_coo_spmv(
        w.data_ptr(), sidx.data_ptr(), sseg.data_ptr(), sval.data_ptr(),
        out.data_ptr(), sidx.numel(), w.numel(), num_rows,
        int(dtype == torch.bfloat16), _cuda.stream(w))
    _cuda.check("coo_kernels", rc, "coo_spmv")
    _cuda.LAUNCHES["coo_spmv"] += 1
    return out


def coo_spmv_t_plain(d, sidx, sseg, sval, num_buckets: int, dtype):
    """Plain version of coo_spmv_t: gather, product, index_add_."""
    c = round_to(round_to(d.index_select(0, sseg), dtype) * sval, dtype)
    out = torch.zeros(num_buckets, dtype=torch.float32, device=d.device)
    return out.index_add_(0, sidx, c)


def coo_spmv_t(d, sidx, sseg, sval, tmap, first, num_buckets: int,
               dtype=None):
    """g = Xᵀ d in table layout; returns (num_buckets,) f32, exactly 0 at
    buckets with no live entry. d is the per-row dual vector, len(d) a
    multiple of 128; num_buckets a multiple of TILE.

    Replaces wormhole_tpu/ops/coo_kernels.py coo_spmv_t (_push_kernel).
    Kernel: csrc/coo_kernels.cu push_kernel."""
    dtype = kernel_dtype(dtype, d)
    if d.shape[0] % LANES or num_buckets % TILE:
        raise ValueError(f"len(d) must be a multiple of {LANES} and "
                         f"num_buckets of {TILE}")
    if not d.is_cuda:
        return coo_spmv_t_plain(d, sidx, sseg, sval, num_buckets, dtype)
    _cuda.require("coo_spmv_t", d.device, d=d, sidx=sidx, sseg=sseg,
                  sval=sval)
    out = torch.empty(num_buckets, dtype=torch.float32, device=d.device)
    rc = _cuda.lib("coo_kernels").wh_coo_spmv_t(
        d.data_ptr(), sidx.data_ptr(), sseg.data_ptr(), sval.data_ptr(),
        out.data_ptr(), sidx.numel(), num_buckets, d.shape[0],
        int(dtype == torch.bfloat16), _cuda.stream(d))
    _cuda.check("coo_kernels", rc, "coo_spmv_t")
    _cuda.LAUNCHES["coo_spmv_t"] += 1
    return out


def tile_gather_plain(table, uniq, dtype):
    """Plain version of tile_gather: masked advanced indexing."""
    nb = table.numel()
    flat = table.reshape(-1)
    live = uniq < nb
    got = flat[torch.where(live, uniq, torch.zeros_like(uniq))]
    return torch.where(live, round_to(got, dtype), torch.zeros_like(got))


def tile_gather(table2, uniq, tmap_u, dtype=None):
    """Gather table entries at the tile-aligned compact slots: returns
    (u_cap,) f32 with out[s] = table[uniq[s]] (0.0 at sentinel slots,
    uniq == num_buckets). table2 is the table viewed
    (num_buckets // 128, 128); tmap_u is kept for signature parity.

    Replaces wormhole_tpu/ops/coo_kernels.py tile_gather
    (_tile_gather_kernel). Kernel: csrc/coo_kernels.cu tile_gather_kernel."""
    dtype = kernel_dtype(dtype, table2)
    if not table2.is_cuda:
        return tile_gather_plain(table2, uniq, dtype)
    _cuda.require("tile_gather", table2.device, table2=table2, uniq=uniq)
    out = torch.empty(uniq.numel(), dtype=torch.float32,
                      device=table2.device)
    rc = _cuda.lib("coo_kernels").wh_tile_gather(
        table2.data_ptr(), uniq.data_ptr(), out.data_ptr(), uniq.numel(),
        table2.numel(), int(dtype == torch.bfloat16), _cuda.stream(table2))
    _cuda.check("coo_kernels", rc, "tile_gather")
    _cuda.LAUNCHES["tile_gather"] += 1
    return out


def check_dim(dim: int) -> None:
    """The embedding kernels take dim a power of two dividing 128."""
    if dim <= 0 or dim & (dim - 1) or LANES % dim:
        raise ValueError(f"dim must be a power of two dividing {LANES}, "
                         f"got {dim}")


def fm_push_contrib_plain(V, a, b, sidx, dtype):
    """Plain version of fm_push_contrib: index_add_ of [a | b] into
    (rows, dim + 1), then the epilogue."""
    rows, dim = V.shape
    ab = round_to(torch.cat([a, b[:, None]], dim=1), dtype)
    acc = torch.zeros(rows, dim + 1, dtype=torch.float32, device=V.device)
    acc.index_add_(0, sidx, ab)
    return acc[:, :dim] - acc[:, dim:] * V


# stream entries per CTA of csrc/coo_kernels.cu fm_push_local_kernel; the
# wrapper sizes the per-chunk scratch with it
_FM_CHUNK = 1024


def fm_push_contrib(V, a, b, sidx, tmap, first, dtype=None):
    """FM embedding gradient from precomputed per-entry contributions:
    returns (rows, dim) f32 with out[j] = sum a[e] - (sum b[e]) * V[j],
    both sums over the entries e with sidx[e] == j; exactly 0 at rows
    with no entry. V is the compact (rows, dim) embedding block (rows a
    multiple of TILE_HI); a (P, dim) and b (P,) are f32, sidx (P,) int32
    the slot-sorted COO of pack_sorted_coo(tile=TILE_HI, blk=FM_BLK),
    whose pad entries carry a = b = 0. tmap and first are the TPU
    layout's block maps, kept for signature parity.

    Replaces wormhole_tpu/ops/coo_kernels.py fm_push_contrib
    (_fm_push_contrib_kernel). Kernel: csrc/coo_kernels.cu
    fm_push_local_kernel + fm_push_combine_kernel."""
    dtype = kernel_dtype(dtype, V)
    rows, dim = V.shape
    check_dim(dim)
    if rows % TILE_HI:
        raise ValueError(f"V must have a multiple of {TILE_HI} rows; got "
                         f"{rows}")
    if a.shape != (sidx.shape[0], dim) or b.shape != sidx.shape:
        raise ValueError("fm_push_contrib: a must be (P, dim) and b (P,) "
                         "for P = len(sidx)")
    if not V.is_cuda:
        return fm_push_contrib_plain(V, a, b, sidx, dtype)
    _cuda.require("fm_push_contrib", V.device, V=V, a=a, b=b, sidx=sidx)
    n = sidx.numel()
    nchunks = -(-n // _FM_CHUNK)
    out = torch.empty(rows, dim, dtype=torch.float32, device=V.device)
    part = torch.empty(2, max(nchunks, 1), dim + 1, dtype=torch.float32,
                       device=V.device)
    flags = torch.empty(max(nchunks, 1), dtype=torch.int32, device=V.device)
    rc = _cuda.lib("coo_kernels").wh_fm_push_contrib(
        V.data_ptr(), a.data_ptr(), b.data_ptr(), sidx.data_ptr(),
        out.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        flags.data_ptr(), n, rows, dim, _FM_CHUNK,
        int(dtype == torch.bfloat16), _cuda.stream(V))
    _cuda.check("coo_kernels", rc, "fm_push_contrib")
    _cuda.LAUNCHES["fm_push_contrib"] += 1
    return out
