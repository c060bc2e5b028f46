"""Optimizer update at the batch's unique keys, in place.

The reference's server applies the update rule at the key's storage when
a push arrives (learn/linear/async_sgd.h:160-180). ``scatter_update``
does the same on the card: driven by the compact gradient of the
tile-aligned slot space (ops/coo_kernels.pack_tile_coo), it applies the
FTRL / AdaGrad / SGD handle to each key named by ``uniq`` and writes the
state tables IN PLACE (the JAX package donates and aliases them instead).

Semantics match models/linear._update:
- FTRL updates every live slot; a zero gradient there is an exact no-op.
- AdaGrad/SGD update only where the raw (unfiltered) gradient is nonzero,
  so L1 shrinkage hits only pushed keys.
- fixed_bytes: the push filter applies to the gradient before the update;
  the int8 mode's absmax scale is taken over the whole compact gradient
  outside the kernel, so it equals parallel.kvstore.quantize_push's.
- An optional additive table (difacto's cnt) gets table[uniq] += values.

The DiFacto embedding table V (rows, dim) gets the same treatment at its
compact row slots: ``row_tile_gather`` reads the rows, and
``v_scatter_update`` applies the AdaGrad V handle to the touched rows in
place.

Kernels: csrc/fused_update.cu, each beside its plain version below;
``row_grid`` and ``row_walk`` mirror how the row kernels split the slots
among warps and lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from wormhole_tpu_torch.ops import _cuda
from wormhole_tpu_torch.ops.coo_kernels import check_dim, kernel_dtype, round_to
from wormhole_tpu_torch.ops.penalty import l1l2_solve

_ORDER = {"ftrl": ("z", "n", "w"), "adagrad": ("n", "w"), "sgd": ("w",)}
_ALGO_ID = {"ftrl": 0, "adagrad": 1, "sgd": 2}


def _quantize(g, fixed_bytes: int, qscale):
    """parallel.kvstore.quantize_push with a given int8 scale."""
    if fixed_bytes == 0:
        return g
    if fixed_bytes >= 2:
        return g.to(torch.bfloat16).to(g.dtype)
    return torch.clamp(torch.round(g / qscale), -127, 127) * qscale


def _apply(algo: str, z, n, w, g, touched, *, lr_eta, lr_beta,
           lambda_l1, lambda_l2):
    """The per-entry handle math of models/linear._update."""
    if algo == "ftrl":
        sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / lr_eta
        z2 = z + touched * (g - sigma * w)
        n2 = n + touched * g * g
        eta = (lr_beta + torch.sqrt(n2)) / lr_eta
        w2 = l1l2_solve(-z2, eta, lambda_l1, lambda_l2)
        return z2, n2, torch.where(touched > 0, w2, w)
    if algo == "adagrad":
        n2 = n + touched * g * g
        eta = (lr_beta + torch.sqrt(n2)) / lr_eta
        w2 = l1l2_solve(eta * w - g, eta, lambda_l1, lambda_l2)
        return None, n2, torch.where(touched > 0, w2, w)
    if algo == "sgd":
        eta = 1.0 / lr_eta
        w2 = l1l2_solve(eta * w - g, eta, lambda_l1, lambda_l2)
        return None, None, torch.where(touched > 0, w2, w)
    raise ValueError(f"unknown algo {algo!r}")


def _qscale(g, fixed_bytes: int):
    if fixed_bytes == 1:
        return torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    return torch.ones((), dtype=torch.float32, device=g.device)


# scatter_update's kernel keeps a ticket counter and per-CTA counts here
# (csrc/fused_update.cu): one zeroed buffer per device and stream, which
# each launch leaves zero; 4,097 ints cover 1,365 SMs at 3 CTAs each.
_SCRATCH: dict = {}
_SCRATCH_INTS = 4097


def _scratch(device, stream: int):
    key = (device, stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(_SCRATCH_INTS, dtype=torch.int32,
                                    device=device)
    return _SCRATCH[key]


def scatter_update_plain(algo: str, state: dict, g, uniq, *, lr_eta,
                         lr_beta, lambda_l1, lambda_l2, fixed_bytes=0,
                         dtype=torch.float32, add_table=None,
                         add_values=None):
    """Plain version of scatter_update: gather the live slots' state,
    apply the handle with torch ops, write back with index_put_."""
    w_tab = state["w"]
    live = uniq < w_tab.numel()
    keys = uniq[live].long()
    raw = round_to(g[live], dtype)
    gq = _quantize(raw, fixed_bytes, _qscale(g, fixed_bytes))
    touched = (torch.ones_like(raw) if algo == "ftrl"
               else (raw != 0).to(torch.float32))
    w0 = w_tab[keys]
    z0 = state["z"][keys] if algo == "ftrl" else None
    n0 = state["n"][keys] if algo in ("ftrl", "adagrad") else None
    z2, n2, w2 = _apply(algo, z0, n0, w0, gq, touched, lr_eta=lr_eta,
                        lr_beta=lr_beta, lambda_l1=lambda_l1,
                        lambda_l2=lambda_l2)
    for name, v in (("z", z2), ("n", n2), ("w", w2)):
        if v is not None:
            state[name][keys] = v
    if add_table is not None:
        state[add_table][keys] += add_values[live]
    return ((w2 != 0).sum() - (w0 != 0).sum()).to(torch.int32)


def scatter_update(algo: str, state: dict, g, uniq, tmap_u, first_u,
                   last_u, *, lr_eta, lr_beta, lambda_l1, lambda_l2,
                   fixed_bytes: int = 0, dtype=None, add_table=None,
                   add_values=None):
    """Apply the algo's handle update IN PLACE to the state tables at the
    keys named by uniq, driven by the compact gradient g. Returns (state,
    new_w): the same dict, and the |w|_0 delta of this step as a 0-d
    int32 tensor on the state's device.

    state holds flat (num_buckets,) f32 tables: ftrl {w,z,n}, adagrad
    {w,n}, sgd {w}. g/uniq are (u_cap,) from coo_spmv_t / pack_tile_coo;
    sentinel slots (uniq == num_buckets) are skipped. tmap_u, first_u and
    last_u are the TPU layout's block maps, kept for signature parity.
    On the card: one kernel launch, no host sync (with fixed_bytes=1 the
    int8 scale's torch reduction comes first).

    Replaces wormhole_tpu/ops/fused_update.py scatter_update (_kernel).
    Kernel: csrc/fused_update.cu scatter_update_kernel."""
    if algo not in _ORDER:
        raise ValueError(f"unknown algo {algo!r}")
    if fixed_bytes not in (0, 1, 2):
        raise ValueError(f"fixed_bytes must be 0, 1 or 2, got {fixed_bytes}")
    if g.shape != uniq.shape or (
            add_values is not None and add_values.shape != uniq.shape):
        raise ValueError("scatter_update: g, uniq and add_values must "
                         "have one entry per compact slot")
    w = state["w"]
    dtype = kernel_dtype(dtype, w)
    hyper = dict(lr_eta=lr_eta, lr_beta=lr_beta, lambda_l1=lambda_l1,
                 lambda_l2=lambda_l2)
    if not w.is_cuda:
        nw = scatter_update_plain(algo, state, g, uniq, fixed_bytes=fixed_bytes,
                                  dtype=dtype, add_table=add_table,
                                  add_values=add_values, **hyper)
        return state, nw
    tabs = {k: state[k] for k in _ORDER[algo]}
    add_tab = state[add_table] if add_table is not None else None
    _cuda.require("scatter_update", w.device, g=g, uniq=uniq,
                  add_table=add_tab, add_values=add_values, **tabs)
    for k, t in tabs.items():
        if t.numel() != w.numel():
            raise ValueError(f"scatter_update: table {k} has {t.numel()} "
                             f"entries, w has {w.numel()}")
    # only the int8 filter reads the scale: no device work otherwise
    qscale = _qscale(g, fixed_bytes) if fixed_bytes == 1 else None
    nw = torch.empty((), dtype=torch.int32, device=w.device)
    st = _cuda.stream(w)
    scratch = _scratch(w.device, st)
    rc = _cuda.lib("fused_update").wh_scatter_update(
        _ALGO_ID[algo], fixed_bytes, int(dtype == torch.bfloat16),
        _cuda.ptr(tabs.get("z")), _cuda.ptr(tabs.get("n")), w.data_ptr(),
        _cuda.ptr(add_tab), _cuda.ptr(add_values), g.data_ptr(),
        uniq.data_ptr(), _cuda.ptr(qscale), uniq.numel(), w.numel(),
        lr_eta, lr_beta, lambda_l1, lambda_l2, 1.0 / lr_eta,
        nw.data_ptr(), scratch.data_ptr(), scratch.numel(), st)
    _cuda.check("fused_update", rc, "scatter_update")
    _cuda.LAUNCHES["scatter_update"] += 1
    return state, nw


# ---------------------------------------------- embedding-row variants
# The row kernels' walk (csrc/fused_update.cu): each warp owns chunks of
# ROW_CHUNK slots, 4 a lane, and walks them by a grid stride over a grid
# of at most ROW_CTAS_PER_SM CTAs of ROW_WARPS warps an SM. The gather
# splits a chunk's rows among the lanes as row_walk says; the update
# first queues the chunk's admitted rows and splits those the same way.
# The kernel's kRowChunk, kRowWarps and kRowCtasPerSm:
ROW_CHUNK, ROW_WARPS, ROW_CTAS_PER_SM = 128, 8, 3


def row_grid(u_cap: int, sms: int) -> int:
    """CTAs of a row kernel's launch over u_cap slots on sms SMs: enough
    warps for the chunks, at most ROW_CTAS_PER_SM an SM."""
    chunks = -(-u_cap // ROW_CHUNK)
    return min(-(-chunks // ROW_WARPS), sms * ROW_CTAS_PER_SM)


def row_walk(u_cap: int, dim: int, sms: int):
    """The gather's split of the (u_cap, dim) slot rows, as (warp, chunk,
    it, lane, slot, channel) int64 columns, one line a vector: warp w
    takes chunks w, w + warps, ... of the grid; in a chunk, lane l's
    vector it is the chunk's vector 32 it + l of min(dim, 4) floats,
    at slot 32 (it // epr) + (32 (it % epr) + l) // epr of the chunk and
    channel (32 (it % epr) + l) % epr * min(dim, 4), epr = dim //
    min(dim, 4). Vectors past u_cap are left out."""
    width = min(dim, 4)
    epr = dim // width
    warps = row_grid(u_cap, sms) * ROW_WARPS
    chunks = np.arange(-(-u_cap // ROW_CHUNK))
    it, lane = np.meshgrid(np.arange(4 * epr), np.arange(32), indexing="ij")
    f = (it % epr) * 32 + lane
    slot = 32 * (it // epr) + f // epr
    chan = f % epr * width
    cols = [np.broadcast_to(a.ravel(), (chunks.size, a.size))
            for a in (it, lane, slot, chan)]
    c = np.broadcast_to(chunks[:, None], cols[0].shape)
    out = np.stack([c % warps, c, cols[0], cols[1],
                    c * ROW_CHUNK + cols[2], cols[3]], -1).reshape(-1, 6)
    return out[out[:, 4] < u_cap]


def row_tile_gather_plain(flat2, uniq_rows, dim: int, dtype):
    """Plain version of row_tile_gather: masked row indexing."""
    V = flat2.reshape(-1, dim)
    live = uniq_rows < V.shape[0]
    got = V.index_select(0, torch.where(live, uniq_rows,
                                        torch.zeros_like(uniq_rows)))
    return torch.where(live[:, None], round_to(got, dtype),
                       torch.zeros_like(got))


def row_tile_gather(flat2, uniq_rows, tmap_u, dim: int, dtype=None):
    """Gather (rows, dim) table rows at the tile-aligned compact row slots
    from the flat row-major table viewed (rows * dim // 128, 128): returns
    (u_cap, dim) f32 with out[s] = V[uniq_rows[s]] (0.0 at sentinel
    slots, uniq_rows == rows). tmap_u is kept for signature parity.

    Replaces wormhole_tpu/ops/fused_update.py row_tile_gather
    (_row_gather_kernel). Kernel: csrc/fused_update.cu row_gather_kernel."""
    check_dim(dim)
    dtype = kernel_dtype(dtype, flat2)
    if not flat2.is_cuda:
        return row_tile_gather_plain(flat2, uniq_rows, dim, dtype)
    _cuda.require("row_tile_gather", flat2.device, flat2=flat2,
                  uniq=uniq_rows)
    out = torch.empty(uniq_rows.numel(), dim, dtype=torch.float32,
                      device=flat2.device)
    rc = _cuda.lib("fused_update").wh_row_tile_gather(
        flat2.data_ptr(), uniq_rows.data_ptr(), out.data_ptr(),
        uniq_rows.numel(), flat2.numel() // dim, dim.bit_length() - 1,
        int(dtype == torch.bfloat16), _cuda.stream(flat2))
    _cuda.check("fused_update", rc, "row_tile_gather")
    if uniq_rows.numel():  # no slots: no launch
        _cuda.LAUNCHES["row_tile_gather"] += 1
    return out


def v_scatter_update_plain(V, nV, gV, vtouched, uniq_rows, *, dim: int,
                           V_lr_eta, V_lr_beta, lambda_V, dtype):
    """Plain version of v_scatter_update: gather the touched rows, apply
    the handle with torch ops, write back with index_put_."""
    V2, nV2 = V.view(-1, dim), nV.view(-1, dim)
    sel = (uniq_rows < V2.shape[0]) & (vtouched > 0)
    rows = uniq_rows[sel].long()
    g = round_to(gV[sel], dtype)
    v0 = V2[rows]
    n2 = nV2[rows] + g * g
    eta = (V_lr_beta + torch.sqrt(n2)) / V_lr_eta
    V2[rows] = v0 - (g + lambda_V * v0) / eta
    nV2[rows] = n2
    return V, nV


def v_scatter_update(Vflat, nVflat, gV, vtouched, uniq_rows, tmap_u,
                     first_u, last_u, *, dim: int, V_lr_eta, V_lr_beta,
                     lambda_V, dtype=None):
    """AdaGrad update of the embedding table at the touched compact rows,
    IN PLACE (difacto AdaGradHandle V branch, async_sgd.h:289-296): for
    each slot s with r = uniq_rows[s] a real row and vtouched[s] > 0,
    nV[r] += g * g, then V[r] -= (g + lambda_V * V[r]) / eta with
    eta = (V_lr_beta + sqrt(nV[r])) / V_lr_eta, g = gV[s]. Other rows
    are not touched. Returns (Vflat, nVflat), the same tensors.

    Vflat, nVflat hold rows * dim f32 (any shape); gV is (u_cap, dim),
    vtouched (u_cap,) f32, uniq_rows (u_cap,) int32 with sentinel rows.
    tmap_u, first_u and last_u are the TPU layout's block maps, kept for
    signature parity.

    Replaces wormhole_tpu/ops/fused_update.py v_scatter_update
    (_v_update_kernel). Kernel: csrc/fused_update.cu v_update_kernel."""
    check_dim(dim)
    dtype = kernel_dtype(dtype, Vflat)
    if gV.shape != (uniq_rows.shape[0], dim) or \
            vtouched.shape != uniq_rows.shape:
        raise ValueError("v_scatter_update: gV must be (u_cap, dim) and "
                         "vtouched (u_cap,)")
    if nVflat.numel() != Vflat.numel():
        raise ValueError("v_scatter_update: V and nV differ in size")
    hyper = dict(V_lr_eta=V_lr_eta, V_lr_beta=V_lr_beta, lambda_V=lambda_V)
    if not Vflat.is_cuda:
        return v_scatter_update_plain(Vflat, nVflat, gV, vtouched,
                                      uniq_rows, dim=dim, dtype=dtype,
                                      **hyper)
    _cuda.require("v_scatter_update", Vflat.device, Vflat=Vflat,
                  nVflat=nVflat, gV=gV, vtouched=vtouched, uniq=uniq_rows)
    rc = _cuda.lib("fused_update").wh_v_scatter_update(
        Vflat.data_ptr(), nVflat.data_ptr(), gV.data_ptr(),
        vtouched.data_ptr(), uniq_rows.data_ptr(), uniq_rows.numel(),
        Vflat.numel() // dim, dim.bit_length() - 1,
        int(dtype == torch.bfloat16), V_lr_eta, V_lr_beta, lambda_V,
        _cuda.stream(Vflat))
    _cuda.check("fused_update", rc, "v_scatter_update")
    if uniq_rows.numel():  # no slots: no launch
        _cuda.LAUNCHES["v_scatter_update"] += 1
    return Vflat, nVflat
