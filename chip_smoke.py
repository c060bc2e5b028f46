#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

  python3 chip_smoke.py        (from the repo root; needs one CUDA card)

Drives the port (wormhole_tpu_torch) through its two main paths at the
bench's full width, over 65,536-row minibatches of 39 Criteo-shaped
features: linear FTRL logistic regression, and the DiFacto factorization
machine (dim 8, w over 2^22 buckets, V over 2^20 rows, threshold 2; the
reference's learn/difacto/guide/criteo.conf, as bench.py runs it):

0. builds the hand-written CUDA kernels from csrc/, one nvcc each, at once;
1. holds every kernel of both paths against its plain PyTorch version on
   the card at the paths' shapes, in f32 and bf16, and times kernel,
   plain version and one PyTorch library call (CUDA events); the DiFacto
   half runs on a full-width batch packed by the learner's own pack;
2. runs LinearLearner on the card at 2^22 buckets (dense tables, kernels
   coo_spmv + coo_spmv_t) and 2^26 buckets (compacted path, tile_gather +
   coo_spmv_t + scatter_update): train steps, eval, predict, each against
   the same batches through kernel=xla (plain torch ops) on the card, with
   the kernels' launch counts taken over this run, the step time, and a
   torch.profiler pass over each learner's steps (device time per step by
   operation, the device's idle share);
3. the same for DifactoLearner (compacted path: tile_gather,
   row_tile_gather, coo_spmv_t, scatter_update with the additive count
   table, fm_push_contrib, v_scatter_update), with its launch counts
   taken over its own run;
4. runs the linear app at 2^26 buckets and the difacto app at the
   DiFacto width in-process on synthetic libsvm files, with validation,
   predict_out and model_out.

Every check raises on failure, so any failed phase exits non-zero. The
last two lines are one JSON object of per-kernel numbers and the result
line {"ok": true, "device": {...}}. Without CUDA, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MINIBATCH = 1 << 16
NNZ_PER_ROW = 39
DENSE_BUCKETS = 1 << 22
COMPACT_BUCKETS = 1 << 26
V_BUCKETS = 1 << 20
FM_DIM = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12          # H100 SXM data sheet, f32 outside tensor cores
TRAIN_STEPS = 4
TIMED_STEPS = 10
TIMED_WINDOWS = 5

KERNELS = {
    "coo_spmv": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                 "wormhole_tpu/ops/coo_kernels.py:308"),
    "coo_spmv_t": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                   "wormhole_tpu/ops/coo_kernels.py:370"),
    "tile_gather": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                    "wormhole_tpu/ops/coo_kernels.py:590"),
    "scatter_update": ("wormhole_tpu_torch/csrc/fused_update.cu",
                       "wormhole_tpu/ops/fused_update.py:329"),
    "row_tile_gather": ("wormhole_tpu_torch/csrc/fused_update.cu",
                        "wormhole_tpu/ops/fused_update.py:196"),
    "fm_push_contrib": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                        "wormhole_tpu/ops/coo_kernels.py:674"),
    "v_scatter_update": ("wormhole_tpu_torch/csrc/fused_update.cu",
                         "wormhole_tpu/ops/fused_update.py:279"),
}
LINEAR_KERNELS = ("coo_spmv", "coo_spmv_t", "tile_gather", "scatter_update")
FM_KERNELS = ("tile_gather", "row_tile_gather", "coo_spmv_t",
              "fm_push_contrib", "scatter_update", "v_scatter_update")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over iters calls (CUDA events, after
    warmup); None off the card."""
    import torch

    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work on the card: the larger of bytes over the
    memory rate and operations over the f32 rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def compare(name: str, got, want, rtol: float, atol: float,
            scale=None) -> float:
    """Max abs error of got against want; raises beyond atol + rtol *
    scale. scale defaults to |want|; for a sum, pass the sum of the
    terms' magnitudes, which bounds its rounding error in any order."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * (want.abs() if scale is None else scale)
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {got.numel()} entries beyond "
            f"atol {atol} + rtol {rtol}; max abs err {float(err.max())}")
    m = float(err.max()) if err.numel() else 0.0
    log(f"[kernel] {name}: max abs err {m:.3g} "
        f"(tolerance atol {atol} + rtol {rtol}) ok")
    return m


def ftrl_z_terms(base: dict, g, uniq, dtype, lr_eta: float):
    """|z0| + |g| + |sigma * w0| per bucket: the magnitudes of the terms
    of FTRL's z update, which bound its rounding error when they cancel
    (the plain version divides by lr_eta as a multiply by its reciprocal
    on CUDA, so sigma differs by an ulp)."""
    import torch

    from wormhole_tpu_torch.ops.coo_kernels import round_to

    z = base["z"]
    live = uniq < z.numel()
    k = uniq[live].long()
    gq = round_to(g[live], dtype)
    n0 = base["n"][k]
    sigma = (torch.sqrt(n0 + gq * gq) - torch.sqrt(n0)) / lr_eta
    out = z.abs()
    out[k] += gq.abs() + (sigma * base["w"][k]).abs()
    return out


def batches(num_buckets: int, n: int, seed: int):
    from wormhole_tpu_torch.data.synth import synth_criteo_batch

    rng = np.random.default_rng(seed)
    return [synth_criteo_batch(rng, MINIBATCH, num_buckets) for _ in range(n)]


def to_rowblock(seg, idx, val, label):
    """A synthetic COO batch as the CSR RowBlock a parser would emit."""
    from wormhole_tpu_torch.data.rowblock import RowBlock

    rows = label.shape[0]
    offset = np.arange(0, rows * NNZ_PER_ROW + 1, NNZ_PER_ROW,
                       dtype=np.int64)
    return RowBlock(label=label, offset=offset,
                    index=idx.astype(np.uint64), value=None)


# ------------------------------------------------------------- phase 1
def check_kernels(device, dense_buckets=DENSE_BUCKETS,
                  compact_buckets=COMPACT_BUCKETS) -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns per-kernel numbers (max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by)."""
    import torch

    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.ops import coo_kernels as ck
    from wormhole_tpu_torch.ops import fused_update as fu

    f32, bf16 = torch.float32, torch.bfloat16
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    gen = np.random.default_rng(11)
    out: dict = {}

    # dense regime: the bucket-sorted batch at 2^22 buckets
    seg, idx, val, _, _ = batches(dense_buckets, 1, seed=1)[0]
    p = ck.pack_sorted_coo(idx, seg, val, dense_buckets,
                           capacity=MINIBATCH * NNZ_PER_ROW)
    sidx, sseg, sval, tmap, first = (dev(p.idx), dev(p.seg), dev(p.val),
                                     dev(p.tmap), dev(p.first))
    P = p.idx.shape[0]
    live = p.val != 0
    n_live_buckets = int(np.unique(p.idx[live]).size)
    hot = int(np.bincount(p.idx[live]).max())
    n_live = int(live.sum())
    log(f"[kernel] dense batch: P={P} packed entries, {n_live} "
        f"live, {n_live_buckets} unique buckets, longest key run {hot}")
    # least stream traffic: (idx, seg, val) of each live entry and val
    # alone of each pad entry, which the kernels skip after reading val
    stream_b = n_live * 12 + (P - n_live) * 4
    w = dev(gen.standard_normal(dense_buckets).astype(np.float32))
    d = dev(gen.standard_normal(MINIBATCH).astype(np.float32))

    # sums are taken in another order (float atomics): the tolerance is
    # atol 1e-4 + rtol 1e-5 * sum of the terms' magnitudes
    errs = []
    mag = ck.coo_spmv_plain(w.abs(), sidx, sseg, sval.abs(), MINIBATCH, f32)
    for dt in (f32, bf16):
        got = ck.coo_spmv(w, sidx, sseg, sval, tmap, first, MINIBATCH, dt)
        want = ck.coo_spmv_plain(w, sidx, sseg, sval, MINIBATCH, dt)
        errs.append(compare(f"coo_spmv {dt}", got, want, 1e-5, 1e-4, mag))
    # plus one table read per live bucket and the output written once
    nb, fl = stream_b + n_live_buckets * 4 + MINIBATCH * 4, 2 * n_live
    out["coo_spmv"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, fl))),
        ms=time_ms(lambda: ck.coo_spmv(w, sidx, sseg, sval, tmap, first,
                                       MINIBATCH, f32), device),
        plain_ms=time_ms(lambda: ck.coo_spmv_plain(
            w, sidx, sseg, sval, MINIBATCH, f32), device),
        library_ms=time_ms(lambda: torch.zeros(
            MINIBATCH, device=device).index_add_(
            0, sseg, w.index_select(0, sidx) * sval), device))

    errs = []
    mag = ck.coo_spmv_t_plain(d.abs(), sidx, sseg, sval.abs(),
                              dense_buckets, f32)
    for dt in (f32, bf16):
        got = ck.coo_spmv_t(d, sidx, sseg, sval, tmap, first,
                            dense_buckets, dt)
        want = ck.coo_spmv_t_plain(d, sidx, sseg, sval, dense_buckets, dt)
        errs.append(compare(f"coo_spmv_t {dt}", got, want, 1e-5, 1e-4,
                            mag))
        untouched = torch.ones(dense_buckets, dtype=torch.bool,
                               device=device)
        untouched[sidx[sval != 0].long()] = False
        if (got[untouched] != 0).any():
            raise AssertionError("coo_spmv_t: untouched bucket not exactly 0")
    # empty tiles come out exactly zero: a batch held in table tile 0
    cidx = (idx % ck.TILE).astype(np.int32)
    pc = ck.pack_sorted_coo(cidx, seg, val, dense_buckets,
                            capacity=MINIBATCH * NNZ_PER_ROW)
    gc = ck.coo_spmv_t(d, dev(pc.idx), dev(pc.seg), dev(pc.val),
                       dev(pc.tmap), dev(pc.first), dense_buckets, f32)
    if (gc[ck.TILE:] != 0).any():
        raise AssertionError("coo_spmv_t: empty tile not exactly 0")
    # plus d read once and the table-sized g written once
    nb = stream_b + MINIBATCH * 4 + dense_buckets * 4
    out["coo_spmv_t"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, 2 * n_live))),
        ms=time_ms(lambda: ck.coo_spmv_t(d, sidx, sseg, sval, tmap, first,
                                         dense_buckets, f32), device),
        plain_ms=time_ms(lambda: ck.coo_spmv_t_plain(
            d, sidx, sseg, sval, dense_buckets, f32), device),
        library_ms=time_ms(lambda: torch.zeros(
            dense_buckets, device=device).index_add_(
            0, sidx, d.index_select(0, sseg) * sval), device))

    # compacted regime: the compact domain of a 2^26-bucket batch, sized
    # by the learner's own rule
    seg, idx, val, _, _ = batches(compact_buckets, 1, seed=2)[0]
    lrn = LinearLearner(LinearConfig(
        minibatch=MINIBATCH, nnz_per_row=NNZ_PER_ROW,
        num_buckets=compact_buckets, kernel="pallas"), device=device)
    u_cap = lrn.ensure_compact(idx)
    del lrn
    if not u_cap:
        raise AssertionError("2^26 buckets did not engage the compact path")
    tc = ck.pack_tile_coo(idx, seg, val, compact_buckets, u_cap,
                          capacity=MINIBATCH * NNZ_PER_ROW,
                          rm_rows=MINIBATCH, rm_width=NNZ_PER_ROW)
    uniq, tmap_u = dev(tc.uniq), dev(tc.tmap_u)
    n_live = tc.num_uniq
    log(f"[kernel] compact batch: {n_live} unique keys in u_cap={u_cap} "
        f"slots at {compact_buckets} buckets")
    table = dev(gen.standard_normal(compact_buckets).astype(np.float32))
    t2 = table.view(-1, ck.LANES)
    errs = []
    for dt in (f32, bf16):
        got = ck.tile_gather(t2, uniq, tmap_u, dt)
        want = ck.tile_gather_plain(t2, uniq, dt)
        errs.append(compare(f"tile_gather {dt}", got, want, 0.0, 0.0))
    nb = u_cap * 8 + n_live * 4
    uniq_c = uniq.clamp(max=compact_buckets - 1)
    out["tile_gather"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, 0))),
        ms=time_ms(lambda: ck.tile_gather(t2, uniq, tmap_u, f32), device),
        plain_ms=time_ms(lambda: ck.tile_gather_plain(t2, uniq, f32),
                         device),
        library_ms=time_ms(lambda: table[uniq_c], device))

    # the compact push gives the gradient scatter_update consumes
    pc = tc.coo
    csidx, csseg, csval = dev(pc.idx), dev(pc.seg), dev(pc.val)
    g = ck.coo_spmv_t(d, csidx, csseg, csval, dev(pc.tmap), dev(pc.first),
                      u_cap, f32)
    gp = ck.coo_spmv_t_plain(d, csidx, csseg, csval, u_cap, f32)
    compare("coo_spmv_t compact f32", g, gp, 1e-5, 1e-4,
            ck.coo_spmv_t_plain(d.abs(), csidx, csseg, csval.abs(), u_cap,
                                f32))
    log(f"[kernel] coo_spmv_t compact: "
        f"{time_ms(lambda: ck.coo_spmv_t(d, csidx, csseg, csval, None, None, u_cap, f32), device)} ms")
    hyper = dict(lr_eta=0.1, lr_beta=1.0, lambda_l1=1.0, lambda_l2=0.1)
    errs, times = [], {}
    tg = torch.Generator(device=device).manual_seed(12)
    base = {"w": torch.randn(compact_buckets, generator=tg, device=device),
            "z": torch.randn(compact_buckets, generator=tg, device=device),
            "n": 4 * torch.rand(compact_buckets, generator=tg,
                                device=device)}
    for algo, names in (("ftrl", ("z", "n", "w")), ("adagrad", ("n", "w")),
                        ("sgd", ("w",))):
        for fb in (0, 1):
            for dt in (f32, bf16):
                sk = {k: base[k].clone() for k in names}
                sp = {k: base[k].clone() for k in names}
                _, nw_k = fu.scatter_update(
                    algo, sk, g, uniq, tmap_u, None, None, fixed_bytes=fb,
                    dtype=dt, **hyper)
                nw_p = fu.scatter_update_plain(
                    algo, sp, g, uniq, fixed_bytes=fb, dtype=dt, **hyper)
                tag = f"scatter_update {algo} fixed_bytes={fb} {dt}"
                for k in names:
                    errs.append(compare(f"{tag} {k}", sk[k], sp[k],
                                        1e-5, 1e-6))
                slack = 1 + n_live // 100000
                if abs(int(nw_k) - int(nw_p)) > slack:
                    raise AssertionError(f"{tag}: |w|_0 delta {int(nw_k)} "
                                         f"vs plain {int(nw_p)}")
                if algo == "ftrl" and fb == 0 and dt == f32:
                    times["ms"] = time_ms(lambda: fu.scatter_update(
                        algo, sk, g, uniq, tmap_u, None, None, dtype=f32,
                        **hyper), device)
                    times["plain_ms"] = time_ms(
                        lambda: fu.scatter_update_plain(
                            algo, sp, g, uniq, dtype=f32, **hyper), device)
    # FTRL: uniq read at every slot; g read and z, n, w read and written
    # at each live slot only (sentinel slots stop after uniq)
    nb, fl = u_cap * 4 + n_live * (4 + 24), n_live * 20
    out["scatter_update"] = dict(
        max_abs_err=max(errs), library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), bound_ms(nb, fl))), **times)
    for k, v in out.items():
        log(f"[kernel] {k}: {v}")
    return out


def difacto_config(kernel: str, num_buckets=DENSE_BUCKETS,
                   v_buckets=V_BUCKETS, **over):
    """The bench's DiFacto configuration (bench.py bench_difacto, from the
    reference's learn/difacto/guide/criteo.conf) at kernel_dtype f32."""
    from wormhole_tpu_torch.models.difacto import DifactoConfig

    kw = dict(minibatch=MINIBATCH, nnz_per_row=NNZ_PER_ROW,
              num_buckets=num_buckets, v_buckets=v_buckets, dim=FM_DIM,
              threshold=2, lr_eta=0.1, lambda_l1=1.0, kernel=kernel,
              kernel_dtype="f32")
    kw.update(over)
    return DifactoConfig(**kw)


def check_fm_kernels(device, num_buckets=DENSE_BUCKETS,
                     v_buckets=V_BUCKETS) -> dict:
    """The DiFacto path's kernels against their plain versions on one
    full-width batch packed by the learner's own pack (the second batch
    of a pass, so the count threshold admits part of the V rows).
    Returns per-kernel numbers, as check_kernels does; scatter_update's
    entry is the additive-table (cnt) variant."""
    import torch

    from wormhole_tpu_torch.models.difacto import DifactoLearner
    from wormhole_tpu_torch.ops import coo_kernels as ck
    from wormhole_tpu_torch.ops import fused_update as fu

    f32, bf16 = torch.float32, torch.bfloat16
    dim = FM_DIM
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    lrn = DifactoLearner(difacto_config("pallas", num_buckets, v_buckets),
                         device=device)
    data = batches(num_buckets, 2, seed=7)
    t0 = time.perf_counter()
    for seg, idx, val, label, _ in data:
        db = lrn.make_device_batch(to_rowblock(seg, idx, val, label))
        pk = lrn._pack_fm(db, train=True)
    pack_s = (time.perf_counter() - t0) / len(data)
    (ts_w, wcnts, wcoo, ts_v, vtouched, vcoo, *_rest) = pk
    uw_cap, uv_cap = lrn._fm_caps
    if lrn.dropped_slot_nnz or lrn.dropped_row_nnz:
        raise AssertionError("the pack dropped nonzeros")
    P = vcoo.idx.shape[0]
    vlive = vcoo.val != 0
    n_vlive = int(vlive.sum())
    n_rows = int((ts_v.uniq < v_buckets).sum())
    n_touched = int(vtouched.sum())
    n_w = int((ts_w.uniq < num_buckets).sum())
    hot = int(np.bincount(vcoo.idx[vlive]).max())
    tiles = np.unique(ts_v.uniq[ts_v.uniq < v_buckets].astype(np.int64)
                      * dim // ck.TILE).size
    log(f"[fm-kernel] batch: caps (uw_cap, uv_cap) = {(uw_cap, uv_cap)}, "
        f"{n_w} unique w keys, {n_rows} V rows ({n_touched} admitted), "
        f"V-side P={P} in {vcoo.tmap.shape[0]} blocks, {n_vlive} live, "
        f"hottest row {hot} entries, {tiles} V tiles touched, w-side "
        f"P={wcoo.idx.shape[0]}; host pack {pack_s:.3f} s/batch")
    del lrn
    gen = torch.Generator(device=device).manual_seed(13)
    out: dict = {}

    # row_tile_gather at the compact V rows
    uniq_v, vtm = dev(ts_v.uniq), dev(ts_v.tmap_u)
    V = 0.01 * torch.randn(v_buckets, dim, generator=gen, device=device)
    V2 = V.view(-1, ck.LANES)
    errs = []
    for dt in (f32, bf16):
        got = fu.row_tile_gather(V2, uniq_v, vtm, dim, dt)
        want = fu.row_tile_gather_plain(V2, uniq_v, dim, dt)
        errs.append(compare(f"row_tile_gather {dt}", got, want, 0.0, 0.0))
    # uniq at every slot, V at each live row, the whole output
    nb = uv_cap * 4 + n_rows * dim * 4 + uv_cap * dim * 4
    uniq_c = uniq_v.clamp(max=v_buckets - 1)
    out["row_tile_gather"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, 0))),
        ms=time_ms(lambda: fu.row_tile_gather(V2, uniq_v, vtm, dim, f32),
                   device),
        plain_ms=time_ms(lambda: fu.row_tile_gather_plain(
            V2, uniq_v, dim, f32), device),
        library_ms=time_ms(lambda: V[uniq_c], device))

    # fm_push_contrib on the learner's operands: a = c * xv[seg],
    # b = c * val, c = d[seg] * val, from random xv and d
    Vc = fu.row_tile_gather(V2, uniq_v, vtm, dim, f32)
    sidx, vseg, vval = dev(vcoo.idx), dev(vcoo.seg), dev(vcoo.val)
    xvd = torch.randn(MINIBATCH, dim + 1, generator=gen, device=device)
    G = xvd.index_select(0, vseg)
    c = G[:, dim] * vval
    a = (c[:, None] * G[:, :dim]).contiguous()
    b = (c * vval).contiguous()
    errs = []
    mag = ck.fm_push_contrib_plain(Vc.abs(), a.abs(), -b.abs(), sidx, f32)
    for dt in (f32, bf16):
        got = ck.fm_push_contrib(Vc, a, b, sidx, None, None, dt)
        if not torch.equal(got, ck.fm_push_contrib(Vc, a, b, sidx, None,
                                                   None, dt)):
            raise AssertionError("fm_push_contrib: differs from run to run")
        want = ck.fm_push_contrib_plain(Vc, a, b, sidx, dt)
        # sums in another (fixed) order: atol 1e-4 + rtol 1e-5 * the sum
        # of the terms' magnitudes
        errs.append(compare(f"fm_push_contrib {dt}", got, want, 1e-5, 1e-4,
                            mag))
        touched = torch.zeros(uv_cap, dtype=torch.bool, device=device)
        touched[sidx[vval != 0].long()] = True
        if got[~touched].any():
            raise AssertionError("fm_push_contrib: a row with no entry is "
                                 "not exactly 0")
    # sidx, a, b of each live entry, b of each pad, V at the live rows,
    # the output; one add per term and the epilogue
    nb = (n_vlive * (8 + dim * 4) + (P - n_vlive) * 4 + n_rows * dim * 4
          + uv_cap * dim * 4)
    fl = n_vlive * (dim + 1) + 2 * uv_cap * dim
    ab = torch.cat([a, b[:, None]], dim=1)
    sidx_l = sidx.long()

    def library():
        acc = torch.zeros(uv_cap, dim + 1, device=device).index_add_(
            0, sidx_l, ab)
        return acc[:, :dim] - acc[:, dim:] * Vc

    out["fm_push_contrib"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, fl))),
        ms=time_ms(lambda: ck.fm_push_contrib(Vc, a, b, sidx, None, None,
                                              f32), device),
        plain_ms=time_ms(lambda: ck.fm_push_contrib_plain(Vc, a, b, sidx,
                                                          f32), device),
        library_ms=time_ms(library, device))

    # v_scatter_update with that gradient at the admitted rows
    gV = ck.fm_push_contrib(Vc, a, b, sidx, None, None, f32)
    vt = dev(vtouched)
    nV = torch.rand(v_buckets, dim, generator=gen, device=device)
    hyper = dict(V_lr_eta=0.01, V_lr_beta=1.0, lambda_V=0.01)
    errs = []
    for dt in (f32, bf16):
        Vk, nVk, Vp, nVp = V.clone(), nV.clone(), V.clone(), nV.clone()
        fu.v_scatter_update(Vk, nVk, gV, vt, uniq_v, vtm, None, None,
                            dim=dim, dtype=dt, **hyper)
        fu.v_scatter_update_plain(Vp, nVp, gV, vt, uniq_v, dim=dim,
                                  dtype=dt, **hyper)
        errs.append(compare(f"v_scatter_update {dt} V", Vk, Vp, 1e-5, 1e-6))
        errs.append(compare(f"v_scatter_update {dt} nV", nVk, nVp, 1e-5,
                            1e-6))
        moved = (Vk != V).any(1)
        moved[uniq_v[(uniq_v < v_buckets) & (vt > 0)].long()] = False
        if moved.any():
            raise AssertionError("v_scatter_update: an untouched row moved")
    # uniq and vtouched at every slot; gV read, V and nV read and
    # written at each admitted row; about 8 operations per entry
    nb = uv_cap * 8 + n_touched * dim * 4 * 5
    Vk, nVk = V.clone(), nV.clone()
    out["v_scatter_update"] = dict(
        max_abs_err=max(errs), library_ms=None,
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(nb, 8 * n_touched * dim))),
        ms=time_ms(lambda: fu.v_scatter_update(
            Vk, nVk, gV, vt, uniq_v, vtm, None, None, dim=dim, dtype=f32,
            **hyper), device),
        plain_ms=time_ms(lambda: fu.v_scatter_update_plain(
            Vk, nVk, gV, vt, uniq_v, dim=dim, dtype=f32, **hyper), device))

    # scatter_update with the additive count table at uw_cap
    uniq_w = dev(ts_w.uniq)
    g = ck.coo_spmv_t(torch.randn(MINIBATCH, generator=gen, device=device),
                      dev(wcoo.idx), dev(wcoo.seg), dev(wcoo.val), None,
                      None, uw_cap, f32)
    add = dev(wcnts)
    base = {"w": torch.randn(num_buckets, generator=gen, device=device),
            "z": torch.randn(num_buckets, generator=gen, device=device),
            "n": 4 * torch.rand(num_buckets, generator=gen, device=device),
            "cnt": torch.randint(0, 4, (num_buckets,), generator=gen,
                                 device=device).float()}
    hyper = dict(lr_eta=0.1, lr_beta=1.0, lambda_l1=1.0, lambda_l2=0.0)
    errs = []
    for dt in (f32, bf16):
        sk = {k: v.clone() for k, v in base.items()}
        sp = {k: v.clone() for k, v in base.items()}
        _, nw_k = fu.scatter_update("ftrl", sk, g, uniq_w, None, None, None,
                                    dtype=dt, add_table="cnt",
                                    add_values=add, **hyper)
        nw_p = fu.scatter_update_plain("ftrl", sp, g, uniq_w, dtype=dt,
                                       add_table="cnt", add_values=add,
                                       **hyper)
        for k in base:
            errs.append(compare(f"scatter_update add=cnt {dt} {k}", sk[k],
                                sp[k], 1e-5, 1e-6,
                                ftrl_z_terms(base, g, uniq_w, dt, 0.1)
                                if k == "z" else None))
        if not torch.equal(sk["cnt"], sp["cnt"]):
            raise AssertionError("scatter_update: counts differ")
        if abs(int(nw_k) - int(nw_p)) > 1 + n_w // 100000:
            raise AssertionError(f"scatter_update add=cnt: |w|_0 delta "
                                 f"{int(nw_k)} vs plain {int(nw_p)}")
    sk = {k: v.clone() for k, v in base.items()}
    # FTRL: uniq at every slot; g, the count, z, n, w read and the four
    # tables written at each live slot
    nb, fl = uw_cap * 4 + n_w * (4 + 4 + 2 * 16), n_w * 21
    out["scatter_update"] = dict(
        max_abs_err=max(errs), library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), bound_ms(nb, fl))),
        ms=time_ms(lambda: fu.scatter_update(
            "ftrl", sk, g, uniq_w, None, None, None, dtype=f32,
            add_table="cnt", add_values=add, **hyper), device),
        plain_ms=time_ms(lambda: fu.scatter_update_plain(
            "ftrl", sk, g, uniq_w, dtype=f32, add_table="cnt",
            add_values=add, **hyper), device))
    for k, v in out.items():
        log(f"[fm-kernel] {k}: {v}")
    return out


# ------------------------------------------------------------- phase 2
def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_steps(lrn, staged, steps: int) -> dict:
    """torch.profiler over `steps` train steps on staged batches: device
    time per step, its largest operations, and the device's idle share
    of the window (the profiler slows the host, so an upper estimate)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            lrn.train_batch(staged[i % len(staged)])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels and memsets): the CPU ops that
    # launched them carry the same time again
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and _device_us(e) > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows) / 1e3 / steps
    return {"profiled_step_ms": window_ms / steps,
            "device_ms_per_step": device_ms,
            "device_idle_share": max(0.0, 1 - device_ms * steps / window_ms),
            "top": [{"op": k[:90], "calls_per_step": c / steps,
                     "us_per_step": us / steps} for k, c, us in rows[:12]]}


def time_steps(lrn, staged, timed: int, windows: int, tag: str) -> float:
    """Median seconds per train step over `windows` host-timed windows of
    `timed` steps on pre-staged batches, logged with its range."""
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(timed):
            lrn.train_batch(staged[i % len(staged)])
        sync(lrn.device)
        per.append((time.perf_counter() - t0) / timed)
    dt = statistics.median(per)
    log(f"[{tag}] {1e3 * dt:.3f} ms/step median of {windows} windows of "
        f"{timed} steps (range {1e3 * min(per):.3f}-{1e3 * max(per):.3f}), "
        f"{MINIBATCH / dt:.0f} examples/sec (staged batches)")
    return dt


def run_learners(device, dense_buckets=DENSE_BUCKETS,
                 compact_buckets=COMPACT_BUCKETS, steps=TRAIN_STEPS,
                 timed=TIMED_STEPS, windows=TIMED_WINDOWS) -> dict:
    """The learner on the card through its entry points, kernel path
    against kernel=xla on the same batches. Returns examples/sec, the
    median over `windows` host-timed windows of `timed` steps each."""
    import torch

    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner

    rates = {}
    for nbk, kind, seed in ((dense_buckets, "coo", 3),
                            (compact_buckets, "tcoo", 4)):
        data = batches(nbk, steps + 2, seed)
        blks = [to_rowblock(s, i, v, y) for s, i, v, y, _ in data]
        train, held = blks[:steps], blks[steps:]
        runs = {}
        for kernel in ("pallas", "xla"):
            cfg = LinearConfig(minibatch=MINIBATCH, nnz_per_row=NNZ_PER_ROW,
                               num_buckets=nbk, algo="ftrl", lr_eta=0.1,
                               lambda_l1=1.0, kernel=kernel,
                               kernel_dtype="f32")
            lrn = LinearLearner(cfg, device=device)
            staged = [lrn.stage_batch(lrn.prepare_batch(b), train=True)
                      for b in train]
            if kernel == "pallas" and staged[0][1] != kind:
                raise AssertionError(f"{nbk} buckets: kind {staged[0][1]}, "
                                     f"expected {kind}")
            progs = [lrn.train_batch(b) for b in staged]
            ev = lrn.eval_batch(held[0])
            pred = lrn.predict_batch(held[1])
            if kernel == "pallas":
                # small-input reference: margins of 128 rows from the
                # host copy of the weights they read
                s, i, v, _, _ = data[-1]
                k = 128 * NNZ_PER_ROW
                wsub = lrn.store.state["w"][
                    torch.from_numpy(i[:k]).long().to(device)].cpu().numpy()
                want = np.zeros(128, np.float32)
                np.add.at(want, s[:k], v[:k] * wsub)
                np.testing.assert_allclose(pred[:128], want, rtol=1e-5,
                                           atol=1e-5)
            runs[kernel] = (lrn, progs, ev, pred)
            log(f"[learner] {nbk} buckets kernel={kernel}: train logloss "
                f"{[round(p['logloss'] / p['nex'], 6) for p in progs]}, "
                f"eval logloss {ev['logloss'] / ev['nex']:.6f} auc "
                f"{ev['auc'] / ev['nex']:.6f}")
            if device.type == "cuda":
                dt = time_steps(lrn, staged, timed, windows,
                                f"learner {nbk} buckets kernel={kernel}")
                rates[f"{kind if kernel == 'pallas' else 'xla'}_{nbk}"] = (
                    MINIBATCH / dt)
                prof = profile_steps(lrn, staged, 2 * timed)
                log(f"[profile] {nbk} buckets kernel={kernel}: "
                    f"{json.dumps(prof)}")
        (lk, pk, ek, yk), (lx, px, ex, yx) = runs["pallas"], runs["xla"]
        for a, b in zip(pk, px):
            if abs(a["logloss"] - b["logloss"]) / a["nex"] > 1e-3:
                raise AssertionError("train logloss differs from xla")
        if abs(ek["logloss"] - ex["logloss"]) / ek["nex"] > 1e-3:
            raise AssertionError("eval logloss differs from xla")
        if not (np.isfinite(yk).all() and yk.shape == (MINIBATCH,)):
            raise AssertionError("predict margins not finite / wrong shape")
        np.testing.assert_allclose(yk, yx, rtol=1e-4, atol=1e-5)
        # the timed steps trained both learners on the same batches too
        wk, wx = lk.store.state["w"], lx.store.state["w"]
        if not torch.allclose(wk, wx, rtol=1e-4, atol=1e-6):
            raise AssertionError(
                f"{nbk} buckets: w differs from kernel=xla, max abs "
                f"{float((wk - wx).abs().max())}")
        log(f"[learner] {nbk} buckets: kernel path matches kernel=xla "
            f"(w max abs diff {float((wk - wx).abs().max()):.3g}, "
            f"|w|_0 {lk.nnz()} vs {lx.nnz()})")
        del runs, lk, lx
    return rates


def run_difacto(device, num_buckets=DENSE_BUCKETS, v_buckets=V_BUCKETS,
                steps=TRAIN_STEPS, timed=TIMED_STEPS,
                windows=TIMED_WINDOWS) -> dict:
    """DifactoLearner on the card through its entry points, the compacted
    kernel path against kernel=xla on the same batches: train steps, one
    eval, one predict, then the six tables. Then the step time and a
    profiler pass (repeating staged train batches advances the device
    count table past the host mirror, so the comparison comes first)."""
    import torch

    from wormhole_tpu_torch.models.difacto import DifactoLearner

    data = batches(num_buckets, steps + 2, seed=8)
    blks = [to_rowblock(s, i, v, y) for s, i, v, y, _ in data]
    train, held = blks[:steps], blks[steps:]
    runs, rates = {}, {}
    for kernel in ("pallas", "xla"):
        lrn = DifactoLearner(difacto_config(kernel, num_buckets, v_buckets),
                             device=device)
        if kernel == "pallas":
            init = {k: v.clone() for k, v in lrn.ckpt_store.state.items()}
        else:  # both start from the same tables
            for k, v in init.items():
                lrn.ckpt_store.state[k].copy_(v)
            lrn.refresh_count_mirror()
        t0 = time.perf_counter()
        staged = [lrn.stage_batch(lrn.prepare_batch(b), train=True)
                  for b in train]
        prep_s = (time.perf_counter() - t0) / steps
        if staged[0][1] != ("fm" if kernel == "pallas" else "xla"):
            raise AssertionError(f"kernel={kernel}: kind {staged[0][1]}")
        progs = [lrn.train_batch(b) for b in staged]
        ev = lrn.eval_batch(held[0])
        pred = lrn.predict_batch(held[1])
        if lrn.dropped_slot_nnz or lrn.dropped_row_nnz:
            raise AssertionError(
                f"kernel={kernel}: dropped {lrn.dropped_slot_nnz} nonzeros "
                f"to the slot caps, {lrn.dropped_row_nnz} to the row cap")
        tables = {k: v.clone() for k, v in lrn.ckpt_store.state.items()}
        log(f"[difacto] kernel={kernel}: prepare+stage {prep_s:.3f} "
            f"s/batch, caps {lrn._fm_caps}, train logloss "
            f"{[round(p['logloss'] / p['nex'], 6) for p in progs]}, eval "
            f"logloss {ev['logloss'] / ev['nex']:.6f} auc "
            f"{ev['auc'] / ev['nex']:.6f}, admitted {lrn.num_admitted()}")
        runs[kernel] = (progs, ev, pred, tables)
        if device.type == "cuda":
            dt = time_steps(lrn, staged, timed, windows,
                            f"difacto kernel={kernel}")
            rates[f"difacto_{kernel}"] = MINIBATCH / dt
            prof = profile_steps(lrn, staged, 2 * timed)
            log(f"[profile] difacto kernel={kernel}: {json.dumps(prof)}")
        del lrn, staged
    (pk, ek, yk, tk), (px, ex, yx, tx) = runs["pallas"], runs["xla"]
    for a, b in zip(pk, px):
        if abs(a["logloss"] - b["logloss"]) / a["nex"] > 1e-3:
            raise AssertionError("difacto train logloss differs from xla")
    if abs(ek["logloss"] - ex["logloss"]) / ek["nex"] > 1e-3:
        raise AssertionError("difacto eval logloss differs from xla")
    if not (np.isfinite(yk).all() and yk.shape == (MINIBATCH,)):
        raise AssertionError("difacto predictions not finite / wrong shape")
    np.testing.assert_allclose(yk, yx, rtol=1e-4, atol=1e-5)
    diffs = {}
    for k in tk:
        # the JAX package's bar between these two paths
        # (tests/test_difacto.py:205-206)
        if not torch.allclose(tk[k], tx[k], rtol=2e-3, atol=2e-5):
            raise AssertionError(
                f"difacto table {k} differs from kernel=xla, max abs "
                f"{float((tk[k] - tx[k]).abs().max())}")
        diffs[k] = float((tk[k] - tx[k]).abs().max())
    log(f"[difacto] kernel path matches kernel=xla: table max abs diffs "
        f"{json.dumps(diffs)}, predictions max abs diff "
        f"{float(np.abs(yk - yx).max()):.3g}")
    return rates


# ------------------------------------------------------------- phase 3
def write_libsvm(path: str, num_buckets: int, rows: int, seed: int) -> None:
    from wormhole_tpu_torch.data.synth import synth_criteo_batch

    rng = np.random.default_rng(seed)
    _, idx, _, label, _ = synth_criteo_batch(rng, rows, num_buckets)
    keys = idx.reshape(rows, NNZ_PER_ROW).astype(str)
    lines = [f"{int(y)} " + " ".join(k) for y, k in zip(label, keys)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def drive_app(app, args: list, num_buckets: int, train_rows: int,
              val_rows: int, seed: int):
    """An app's main() in-process on synthetic libsvm train and val files,
    with predict_out and model_out. Checks one finite prediction per val
    row; returns (val logloss from the predictions, the saved tables)."""
    from wormhole_tpu_torch.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        tr, va = (os.path.join(tmp, "train.libsvm"),
                  os.path.join(tmp, "val.libsvm"))
        write_libsvm(tr, num_buckets, train_rows, seed=seed)
        write_libsvm(va, num_buckets, val_rows, seed=seed + 1)
        pred, model = os.path.join(tmp, "pred"), os.path.join(tmp, "model")
        rc = app.main([f"train_data={tr}", f"val_data={va}",
                       f"nnz_per_row={NNZ_PER_ROW}",
                       f"num_buckets={num_buckets}", "lr_eta=0.1",
                       "lambda_l1=1", "max_data_pass=1",
                       "num_parts_per_file=1", "max_concurrency=2",
                       f"predict_out={pred}", f"model_out={model}", *args])
        if rc != 0:
            raise AssertionError(f"{app.__name__} returned {rc}")
        margins = np.loadtxt(pred + "_part-0", dtype=np.float64, ndmin=1)
        labels = np.array([float(l.split(" ", 1)[0])
                           for l in open(va).read().splitlines()])
        if margins.shape != (val_rows,) or not np.isfinite(margins).all():
            raise AssertionError(f"{app.__name__} predictions: shape "
                                 f"{margins.shape}, finite "
                                 f"{np.isfinite(margins).all()}")
        ll = float(np.mean(np.logaddexp(0.0, margins) - labels * margins))
        if not math.isfinite(ll):
            raise AssertionError(f"{app.__name__}: val logloss {ll}")
        return ll, ckpt.load_parts(model)


def run_app(device, num_buckets=COMPACT_BUCKETS, minibatch=MINIBATCH,
            train_rows=2 * MINIBATCH, val_rows=MINIBATCH) -> float:
    """The linear app at 2^26 buckets."""
    from wormhole_tpu_torch.apps import linear as app

    ll, saved = drive_app(app, [f"minibatch={minibatch}", "algo=ftrl",
                                f"device={device}"],
                          num_buckets, train_rows, val_rows, seed=5)
    w = saved["w"]
    if w.shape != (num_buckets,):
        raise AssertionError(f"model w {w.shape}")
    log(f"[app] {val_rows} predictions, val logloss from predictions "
        f"{ll:.6f}, model |w|_0 {int(np.count_nonzero(w))}")
    return ll


def run_difacto_app(device, num_buckets=DENSE_BUCKETS, v_buckets=V_BUCKETS,
                    minibatch=MINIBATCH, train_rows=2 * MINIBATCH,
                    val_rows=MINIBATCH) -> float:
    """The difacto app at the DiFacto width; model_out must hold both
    table groups."""
    from wormhole_tpu_torch.apps import difacto as app

    ll, saved = drive_app(app, [f"minibatch={minibatch}",
                                f"v_buckets={v_buckets}", f"dim={FM_DIM}",
                                "threshold=2", "kernel=pallas",
                                f"device={device}"],
                          num_buckets, train_rows, val_rows, seed=9)
    shapes = {k: v.shape for k, v in saved.items()}
    want = {"w": (num_buckets,), "z": (num_buckets,), "n": (num_buckets,),
            "cnt": (num_buckets,), "V": (v_buckets, FM_DIM),
            "nV": (v_buckets, FM_DIM)}
    if shapes != want:
        raise AssertionError(f"difacto model tables {shapes}")
    log(f"[difacto-app] {val_rows} predictions, val logloss from "
        f"predictions {ll:.6f}, model tables {shapes}, admitted "
        f"{int((saved['cnt'] >= 2).sum())}")
    return ll


# ---------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "wormhole_tpu_torch")):
        print("chip_smoke: the wormhole_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from wormhole_tpu_torch.ops import _cuda

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    secs = _cuda.build()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")

    t = time.perf_counter()
    knums = check_kernels(device)
    fm_nums = check_fm_kernels(device)
    # scatter_update's row keeps the linear path's numbers; the
    # additive-table variant's error counts against it too
    fm_nums["scatter_update"] = dict(
        knums["scatter_update"],
        max_abs_err=max(knums["scatter_update"]["max_abs_err"],
                        fm_nums["scatter_update"]["max_abs_err"]))
    knums.update(fm_nums)
    log(f"[phase] kernels {time.perf_counter() - t:.1f}s")

    # each main path is driven with the counts set to 0 just before it
    # and read just after
    launches = dict.fromkeys(KERNELS, 0)
    paths = {"linear": (run_learners, LINEAR_KERNELS),
             "difacto": (run_difacto, FM_KERNELS)}
    for name, (run, path_kernels) in paths.items():
        t = time.perf_counter()
        _cuda.reset_launches()
        rates = run(device)
        counts = dict(_cuda.LAUNCHES)
        log(f"[{name}] launches on the main path: {counts}")
        missing = [k for k in path_kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {name} "
                                 f"path: {missing}")
        for k in KERNELS:
            launches[k] += counts[k]
        log(f"[{name}] examples/sec on {smi}: "
            f"{json.dumps({k: round(v) for k, v in rates.items()})}")
        log(f"[phase] {name} learner {time.perf_counter() - t:.1f}s")

    for name, run, want in (
            ("app", run_app, ("tile_gather", "coo_spmv_t",
                              "scatter_update")),
            ("difacto-app", run_difacto_app, FM_KERNELS)):
        t = time.perf_counter()
        _cuda.reset_launches()
        run(device)
        app_launches = dict(_cuda.LAUNCHES)
        log(f"[{name}] launches: {app_launches}")
        for k in want:
            if app_launches[k] == 0:
                raise AssertionError(f"{name} run launched no {k}")
        log(f"[phase] {name} {time.perf_counter() - t:.1f}s")

    rows = []
    for name, (src, repl) in KERNELS.items():
        k = knums[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
