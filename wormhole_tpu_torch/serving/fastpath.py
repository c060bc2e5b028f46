"""Serving fast path: shard-local scoring over compact wire payloads.

The port's copy of the JAX package's serving/fastpath.py, renamed to
this package and sharing nothing with it.

The fetch plane ships every unique row of every table back to the
router per request — two ~32k-row round-trips for the 64M-bucket
benchmark — and then scores centrally. The fast path inverts that
dataflow: the router partitions a batch's COO entries by the owning
shard's key range and each shard scores ITS entries against its
resident rows, returning per-nonzero partial products (8 bytes each)
instead of weight slices. The router scatters the partials back into
the batch's original nonzero order and folds them per row.

Bit-identity contract (tests/test_torch_serving.py):

* linear — ``np.add.at(out, seg, val * w[idx])`` over the live
  nonzeros in their original order is bitwise the trainer's plain
  ``spmv`` on the CPU (torch's CPU ``index_add_`` accumulates in
  nonzero order and does not fuse the multiply into an FMA), so
  fast-path margins equal ``predict_batch`` exactly, up to the sign of
  a zero margin: the trainer's padded COO tail adds ``±0`` terms the
  live-only fold never sees, which can flip a ``-0.0`` margin to
  ``+0.0`` (``np.array_equal`` treats them as equal). On the card the
  trainer's kernels add with f32 atomics, in no fixed order, and the
  fold holds to their bar instead.
* difacto — the linear term ``xw`` follows the same exact fold, but
  the quadratic term's per-row k-vectors ``xv``/``x2`` are summed
  per shard and then ACROSS shards, reassociating the reduction the
  trainer performs in one pass; the final k-axis reduction runs in
  numpy rather than torch. Margins agree to a few ulp — the
  cross-shard reassociation contract, asserted with a tight relative
  tolerance instead of equality.

Everything here is numpy on the host, as in the JAX package: the
per-shard kernels are pure gathers and scatter-adds over at most a few
hundred thousand entries, and the shards hold their tables in host
memory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from wormhole_tpu_torch.data.rowblock import RowBlock, bucketize
from wormhole_tpu_torch.utils.manifest import shard_range


@dataclasses.dataclass
class ScorePack:
    """One RowBlock packed for shard-local scoring: the LIVE COO
    entries only — no padded capacity buffers, because the fold target
    is allocated per round and padding contributes nothing but the
    sign of a zero (see module docstring)."""

    seg: np.ndarray                    # int32[nnz] row id per nonzero
    idx: np.ndarray                    # int32[nnz] global bucket id
    val: np.ndarray                    # float32[nnz]
    rows: int                          # live rows (scores returned)
    dropped_rows: int = 0


def pack_score(blk: RowBlock, num_rows: int, capacity: int,
               num_buckets: int) -> ScorePack:
    """Pack a RowBlock for the score op, mirroring ``to_device_batch``
    drop semantics EXACTLY (rows beyond ``num_rows`` dropped; a
    capacity overflow drops the partially-represented row and
    everything after it) so both modes score the same examples."""
    dropped = max(blk.size - num_rows, 0)
    n = min(blk.size, num_rows)
    if blk.size > num_rows:
        blk = blk.slice(0, num_rows)
    nnz = int(blk.nnz)
    if nnz > capacity:
        cut = int(np.searchsorted(blk.offset, capacity,
                                  side="right")) - 1
        dropped += n - cut
        n = cut
        blk = blk.slice(0, cut)
        nnz = int(blk.nnz)
    seg = np.repeat(np.arange(n, dtype=np.int32),
                    np.diff(blk.offset[: n + 1]).astype(np.int64))
    idx = bucketize(blk.index, num_buckets)
    val = blk.values_or_ones()
    if blk.weight is not None:
        # same float32 fold as to_device_batch, into a fresh array so
        # the caller's value buffer is never mutated
        val = (val * blk.weight[seg]).astype(np.float32, copy=False)
    return ScorePack(seg=seg, idx=idx,
                     val=np.asarray(val, np.float32),
                     rows=n, dropped_rows=dropped)


def concat_packs(packs: List[ScorePack]) -> Tuple[ScorePack, List[int]]:
    """Concatenate micro-batch member packs into one round pack, each
    member's seg rebased by the running row total. Returns the round
    pack and the row cuts: member m's rows are ``[cuts[m], cuts[m+1])``
    of the round's fold target."""
    if len(packs) == 1:
        p = packs[0]
        return p, [0, p.rows]
    cuts = [0]
    segs: List[np.ndarray] = []
    base = 0
    for p in packs:
        segs.append(p.seg + np.int32(base))
        base += p.rows
        cuts.append(base)
    return ScorePack(
        seg=np.concatenate(segs),
        idx=np.concatenate([p.idx for p in packs]),
        val=np.concatenate([p.val for p in packs]),
        rows=base), cuts


def shard_edges(rows: int, world: int) -> np.ndarray:
    """Interior boundaries of the even ``shard_range`` split: shard r
    owns bucket ids in ``[edges[r-1], edges[r])`` (with edges[-1]=0 and
    edges[world-1]=rows implied). Length ``world - 1``."""
    return np.asarray([shard_range(rows, r, world)[0]
                       for r in range(1, world)], np.int64)


def partition(idx: np.ndarray,
              edges: np.ndarray) -> Tuple[Optional[np.ndarray],
                                          np.ndarray]:
    """Order per-nonzero entries by owning shard. Returns ``(order,
    counts)``: ``order`` is a STABLE permutation (shard-major, original
    nonzero order preserved within each shard — the scatter back is
    ``restored[order] = concat(shard slices)``) and ``counts[r]`` is
    shard r's entry count. ``order is None`` for a single-shard world
    (the reassembly is then the identity)."""
    if len(edges) == 0:
        return None, np.asarray([len(idx)], np.int64)
    if len(edges) <= 8:
        # small worlds: one >= pass per boundary beats the per-element
        # binary search ~10x (the serving fan-out is 2-8 shards; this
        # is the hot path of every score round)
        sid = (idx >= edges[0]).astype(np.int8)
        for e in edges[1:]:
            sid += idx >= e
    else:
        sid = np.searchsorted(edges, idx, side="right")
        # a narrow sort key: stable argsort over int8/int16 is
        # measurably faster than over the int64 searchsorted output
        sid = sid.astype(np.int8 if len(edges) < 127 else np.int16)
    order = np.argsort(sid, kind="stable")
    counts = np.bincount(sid, minlength=len(edges) + 1).astype(np.int64)
    return order, counts


def restore_order(nnz: int, order: Optional[np.ndarray],
                  parts: List[np.ndarray]) -> np.ndarray:
    """Scatter the per-shard product slices (rank order) back into the
    batch's original nonzero order."""
    flat = parts[0] if len(parts) == 1 else np.concatenate(parts)
    if order is None:
        return flat
    out = np.empty(nnz, np.float32)
    out[order] = flat
    return out


# -- shard-side kernel ------------------------------------------------------

def shard_score(header: dict, arrays: dict, model) -> Dict[str, np.ndarray]:
    """Server-side ``score`` kernel: partial products over this shard's
    resident rows. Pure numpy — every elementwise product is bitwise
    the trainer's plain version's (see module docstring).

    linear:  reply ``p[nnz]`` = ``v * w[i]``.
    difacto: reply adds the per-row quadratic partials ``xv``/``x2``
    of shape ``[rows, k]``, folded over this shard's entries only; the
    ``V`` table is gathered from a full replica (the embedding space is
    hashed mod ``vb``, so a w-range partition scatters V rows across
    every shard — replicating the small V table beats a second
    partition axis)."""
    kind = header.get("kind", "linear")
    i = np.asarray(arrays["i"])
    v = np.asarray(arrays["v"], np.float32)
    lo, hi = model.ranges["w"]
    if len(i) and (int(i.min()) < lo or int(i.max()) >= hi):
        raise KeyError(
            f"score entries outside shard range [{lo}, {hi}) of 'w'")
    local = i.astype(np.int64) - lo
    w_rows = model.tables["w"][local]
    p = v * w_rows
    if kind == "linear":
        return {"p": p}
    if kind != "difacto":
        raise ValueError(f"unknown score kind {kind!r}")
    rows = int(header["rows"])
    seg = np.asarray(arrays["s"]).astype(np.int64, copy=False)
    cnt_rows = model.tables["cnt"][local]
    # trainer's admission over the compact domain, commuted through the
    # gather: (cnt >= threshold)[idxc] == gathered_cnt >= threshold
    admit = cnt_rows >= int(header["threshold"])
    if header.get("l1_shrk"):
        admit = admit & (w_rows != 0)
    vv = v * admit.astype(np.float32)
    V = model.replicated("V")
    vi = (i.astype(np.int32) % np.int32(header["vb"])).astype(np.int64)
    Vg = V[vi]
    k = V.shape[1]
    xv = np.zeros((rows, k), np.float32)
    np.add.at(xv, seg, vv[:, None] * Vg)
    x2 = np.zeros((rows, k), np.float32)
    np.add.at(x2, seg, (vv ** 2)[:, None] * Vg ** 2)
    return {"p": p, "xv": xv, "x2": x2}


# -- router-side finalize ---------------------------------------------------

def finalize_linear(pack: ScorePack, prod: np.ndarray,
                    prob: bool) -> np.ndarray:
    """Fold restored per-nonzero products into per-row margins — the
    bitwise mirror of the trainer's segment_sum over live entries."""
    out = np.zeros(pack.rows, np.float32)
    np.add.at(out, pack.seg, prod)
    if prob:
        out = 1.0 / (1.0 + np.exp(-out))
    return out


def finalize_difacto(pack: ScorePack, prod: np.ndarray,
                     xv: np.ndarray, x2: np.ndarray,
                     prob: bool) -> np.ndarray:
    """xw by the exact linear fold, plus the quadratic term from the
    cross-shard-summed partials (the documented ulp contract)."""
    xw = np.zeros(pack.rows, np.float32)
    np.add.at(xw, pack.seg, prod)
    out = xw + 0.5 * np.sum(xv * xv - x2, axis=-1)
    if prob:
        out = 1.0 / (1.0 + np.exp(-out))
    return out
