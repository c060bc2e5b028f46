"""DiFacto: the asynchronous factorization machine, on one device or a
(data x model) mesh of ranks.

Parity target: the reference's difacto.dmlc app (learn/difacto:
async_sgd.h, loss.h, config.proto; doc/learn/difacto.rst) and the JAX
package's models/difacto.py, with the same config surface, prepared-batch
kinds and step math. The FM model is

    f(x) = <w, x> + 1/2 sum_k [ (Xv)_k^2 - (X^2)(V^2)_k ]

with adaptive embedding memory: a key's V row takes part only once its
occurrence count reaches `threshold` (and, with `l1_shrk`, only while
w != 0). w trains with FTRL, V with AdaGrad (async_sgd.h:262-296).

Tables: `w`, `z`, `n` and the occurrence count `cnt` over `num_buckets`,
and `V`, `nV` (rows, dim) over their own `v_buckets` rows (bucket % vb);
two KVStores, checkpointed together through `_CombinedStore`. A train
step updates them IN PLACE (the JAX learner donates them to jitted steps
instead).

A step runs one of two prepared-batch kinds:
- ``xla`` (kernel=xla): plain torch gathers and index_add_ over the padded
  COO batch, and dense table updates;
- ``fm`` (kernel=pallas): the compacted path. The host localizes both key
  spaces into tile-aligned compact slots and decides admission from a
  host mirror of the count table; on the device, tile_gather and
  row_tile_gather read w and V at those slots, the forward is one row
  gather from the unified compact table U = [V row | w], coo_spmv_t and
  scatter_update (with `cnt` as its additive table) push and update w,
  and fm_push_contrib and v_scatter_update push and update V;
- ``dmesh`` on a mesh (parallel/mesh.py; the JAX package's sharded XLA
  step): w, z, n and cnt are range-sharded over the model axis, V and nV
  over the `v_buckets` rows, as KVStore shards linear's tables. Rank
  (d, m) packs two cells of the global batch's data shard d: the w cell
  (its model shard's buckets, mesh_coo_spmv's cell) and the V cell (the
  nonzeros whose V row is its model shard's). The count push is summed
  over the data axis before the forward, so admission reads the global
  batch's counts; the admission of each nonzero of the data shard is
  summed over the model axis (its bucket may live on any shard). xw goes
  through W1 (mesh_coo_spmv) and gw through W2 (mesh_coo_spmv_t), the
  hand kernels, or their plain twins with kernel=xla; xv and the x2 term
  (torch ops on the V cell) sum over the model axis, gV and the V rows'
  touches over the data axis; FTRL and AdaGrad run on each rank's
  shards. The compact kernels stay single-device, as the JAX package
  turns Pallas off on a mesh. On the global mesh (`global_step_protocol`)
  each rank's data shard is its own rows.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading

import numpy as np
import torch

from wormhole_tpu_torch import native
from wormhole_tpu_torch.data.rowblock import DeviceBatch, RowBlock, to_device_batch
from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.models.linear import (GlobalMeshSteps, LinearConfig,
                                              _loss_dual, _progress,
                                              _to_floats, _update)
from wormhole_tpu_torch.ops import coo_kernels as ck
from wormhole_tpu_torch.ops.fused_update import (row_tile_gather,
                                                 scatter_update,
                                                 v_scatter_update)
from wormhole_tpu_torch.ops.localizer import localize
from wormhole_tpu_torch.ops.spmv import row_squares, spmm, spmv, spmv_t
from wormhole_tpu_torch.parallel import collectives
from wormhole_tpu_torch.parallel.kvstore import KVStore, TableSpec, quantize_push
from wormhole_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                              batch_range, single_device_mesh)

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class DifactoConfig(LinearConfig):
    """The linear config surface plus the embedding block of reference
    difacto config.proto (dim/threshold/lambda/init_scale/dropout/
    grad_clipping/grad_normalization), with the JAX package's keys and
    defaults."""

    dim: int = 8                 # embedding dimension V_k
    threshold: int = 2           # occurrence count to admit an embedding
    l1_shrk: bool = False        # require w != 0 for admission
    lambda_V: float = 0.01       # l2 on V (AdaGrad update)
    V_init_scale: float = 0.01   # N(0, scale) init
    V_lr_eta: float = 0.01
    V_lr_beta: float = 1.0
    grad_clipping: float = 0.0   # clip each V grad entry to [-c, c]; 0=off
    grad_normalization: bool = False  # scale V grad by 1/|batch|
    dropout: float = 0.0         # zero a fraction of V grads
    v_buckets: int = 0           # embedding table size; 0 = num_buckets
    # early stop when val objv improves less than this (async_sgd.h:31-49)
    early_stop_epsilon: float = 0.0

    @property
    def vb(self) -> int:
        return self.v_buckets or self.num_buckets


def _fm_forward(cfg: DifactoConfig, w, V, cnt, seg, idx, vidx, val,
                num_rows: int):
    """Admission mask + FM margin, shared by the train and eval steps of
    the xla kind. Returns (margin, xw, xv, vval)."""
    admit = cnt >= cfg.threshold
    if cfg.l1_shrk:
        admit = admit & (w != 0)
    admit_nz = admit.to(torch.float32).index_select(0, idx)
    xw = spmv(seg, idx, val, w, num_rows)
    vval = val * admit_nz  # un-admitted keys contribute no V terms
    xv = spmm(seg, vidx, vval, V, num_rows)           # [B, k]
    x2v2 = row_squares(seg, vidx, vval, V, num_rows)  # [B, k]
    margin = xw + 0.5 * torch.sum(xv * xv - x2v2, dim=-1)
    return margin, xw, xv, vval


def _tables_for(cfg: DifactoConfig) -> dict[str, TableSpec]:
    def v_init(gen, shape, dtype, device):
        return (cfg.V_init_scale
                * torch.randn(shape, generator=gen, dtype=dtype)).to(device)

    return {
        "w": TableSpec(),
        "z": TableSpec(),
        # second-moment / count accumulators floor at bf16 on the push
        # wire (huge-dynamic-range nonnegative deltas: see TableSpec)
        "n": TableSpec(wire_cap="bf16"),
        "cnt": TableSpec(wire_cap="bf16"),
        "V": TableSpec(tail=(cfg.dim,), init=v_init),
        "nV": TableSpec(tail=(cfg.dim,), wire_cap="bf16"),
    }


class _CombinedStore:
    """Adapter presenting the w-tables and the V-tables as one store: to
    utils/checkpoint.py (to_numpy / from_numpy) and to the PS plane's
    SyncedStore (row gathers and scatters by table name, the zero-init
    and wire-floor table sets)."""

    on_load = None  # callback fired after from_numpy (count-mirror sync)
    on_sparse_pull = None  # callback fired with {table: (idx, rows)}

    def __init__(self, *stores):
        self.stores = stores
        self.mesh = stores[0].mesh

    def to_numpy(self):
        out = {}
        for s in self.stores:
            out.update(s.to_numpy())
        return out

    def from_numpy(self, arrays):
        known = set().union(*(s.state for s in self.stores))
        unknown = set(arrays) - known
        if unknown:
            raise ValueError(f"unknown tables {sorted(unknown)}")
        for s in self.stores:
            s.from_numpy({k: v for k, v in arrays.items() if k in s.state})
        if self.on_load is not None:
            self.on_load()

    def _sub(self, name):
        for s in self.stores:
            if name in s.state:
                return s
        raise KeyError(name)

    def gather_rows(self, name, idx):
        return self._sub(name).gather_rows(name, idx)

    def gather_rows_multi(self, names, idx):
        """gather_rows_multi of each sub-store over its share of
        `names` (one index transfer a sub-store)."""
        by_store = {}
        for k in names:
            sub = self._sub(k)
            by_store.setdefault(id(sub), (sub, []))[1].append(k)
        out = {}
        for sub, ks in by_store.values():
            out.update(sub.gather_rows_multi(ks, idx))
        return out

    def scatter_rows(self, name, idx, vals):
        self._sub(name).scatter_rows(name, idx, vals)

    def zero_init_names(self):
        out = set()
        for s in self.stores:
            out |= s.zero_init_names()
        return out

    def wire_cap_names(self):
        out = set()
        for s in self.stores:
            out |= s.wire_cap_names()
        return out

    @property
    def state(self):
        """Merged read view over both table groups (assign into the
        sub-stores, not into it)."""
        out = {}
        for s in self.stores:
            out.update(s.state)
        return out

    def nnz(self, name="w"):
        return self._sub(name).nnz(name)


class DifactoLearner(GlobalMeshSteps):
    """FM train/eval/predict steps over one device's w and V tables, or
    over this rank's shards of them on a mesh."""

    #: bump when prepare_batch's output changes for identical input
    _PACK_VERSION = 1

    def __init__(self, cfg: DifactoConfig, device=None, seed: int = 0,
                 mesh: Mesh = None):
        if not 0 < cfg.vb <= cfg.num_buckets:
            raise ValueError(f"v_buckets must be in (0, num_buckets]; got "
                             f"{cfg.vb}")
        if cfg.algo != "ftrl":
            raise ValueError("difacto trains w with FTRL (reference "
                             f"async_sgd.h:262-286); algo={cfg.algo!r}")
        if cfg.kernel not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown kernel {cfg.kernel!r}")
        self.cfg = cfg
        if mesh is not None and device is not None and \
                torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh if mesh is not None else single_device_mesh(device)
        self.device = resolve_device(self.mesh.device)
        D, M = self.mesh.num_data, self.mesh.num_model
        # a mesh larger than 1x1, or one rank of a process group (a global
        # mesh of one worker): the dmesh kind
        self._mesh_layout = (D > 1 or M > 1
                             or self.mesh.device_mesh is not None)
        # the mesh the tables shard over (None: whole on one device)
        self._shard_mesh = self.mesh if self._mesh_layout else None
        specs = _tables_for(cfg)
        self.store = KVStore(cfg.num_buckets,
                             {k: v for k, v in specs.items() if v.tail == ()},
                             self.device, seed=seed, mesh=self._shard_mesh)
        # the V tables have their own (smaller) bucket space
        self.vstore = KVStore(cfg.vb,
                              {k: v for k, v in specs.items() if v.tail != ()},
                              self.device, seed=seed + 1,
                              mesh=self._shard_mesh)
        self.ckpt_store = _CombinedStore(self.store, self.vstore)
        self.ckpt_store.on_load = self.refresh_count_mirror
        self.ckpt_store.on_sparse_pull = self._on_sparse_pull
        # sparse PS wire hints: unique w keys and V rows touched by
        # trained batches since the last collect_touched() drain
        self.track_touched = False
        self._touched_lock = threading.Lock()
        self._touched_w: list = []
        self._touched_v: list = []
        self._dropped_rows = 0
        self._step_count = 0
        # nonzeros the compact pack dropped: to the slot caps, and to the
        # nnz_per_row row cap of the row-major forward
        self.dropped_slot_nnz = 0
        self.dropped_row_nnz = 0
        dim = cfg.dim
        shapes_ok = (not cfg.l1_shrk  # needs w on the device at pack time
                     and cfg.minibatch % ck.LANES == 0
                     # V rows tile cleanly: dim a power of two dividing
                     # 128, V a whole number of (TILE_HI, 128) flat tiles
                     and dim > 0 and dim & (dim - 1) == 0
                     and ck.LANES % dim == 0
                     and (cfg.vb * dim) % ck.TILE == 0
                     and cfg.num_buckets % ck.TILE == 0
                     and cfg.vb * dim < 2**31)
        self._use_fm_pallas = not self._mesh_layout and (
            cfg.kernel == "pallas" or (cfg.kernel == "auto"
                                       and self.device.type == "cuda"
                                       and shapes_ok))
        # the mesh's W1 and W2: the hand kernels unless kernel=xla or the
        # cells do not split into whole tiles and lane groups
        cells_ok = (cfg.num_buckets % (M * ck.TILE) == 0
                    and cfg.minibatch % (D * ck.LANES) == 0)
        self._mesh_kernels = self._mesh_layout and (
            cfg.kernel == "pallas" or (cfg.kernel == "auto" and cells_ok))
        if self._mesh_kernels and not cells_ok:
            raise ValueError(
                f"the mesh's COO kernels need num_buckets % {M * ck.TILE} "
                f"== 0 and minibatch % {D * ck.LANES} == 0")
        if self._mesh_layout and cfg.vb % M:
            raise ValueError(f"v_buckets {cfg.vb} must divide over {M} "
                             f"model shards")
        self._shard_cap = ck.mesh_capacity(cfg.row_capacity, D, M)
        if self._use_fm_pallas and not shapes_ok:
            raise ValueError(
                "the compacted FM path needs l1_shrk off, minibatch % "
                f"{ck.LANES} == 0, dim a power of two dividing {ck.LANES}, "
                f"num_buckets and v_buckets * dim multiples of {ck.TILE}")
        # kernel compute dtype: None defers to the kernel default (bf16 on
        # CUDA, f32 on the CPU); "auto" keeps f32 when fixed_bytes == 0
        if cfg.kernel_dtype == "f32" or (cfg.kernel_dtype == "auto"
                                         and cfg.fixed_bytes == 0):
            self._fm_dtype = torch.float32
        else:
            self._fm_dtype = None
        self._fm_caps = None
        self._fm_lock = threading.Lock()
        self._cnt_host = np.zeros(cfg.num_buckets, np.float32)
        # gradient dropout draws from its own generator on the device
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 17)

    def derived_tables(self) -> dict:
        """w trains by FTRL (async_sgd.h:262-286): the non-additive prox
        of the additive (z, n), recomputed server-side in a PS plane
        (see LinearLearner.derived_tables)."""
        cfg = self.cfg
        return {"w": {"kind": "ftrl_prox", "lr_eta": cfg.lr_eta,
                      "lr_beta": cfg.lr_beta, "lambda_l1": cfg.lambda_l1,
                      "lambda_l2": cfg.lambda_l2}}

    # -- xla kind ------------------------------------------------------------
    def _grad_filters(self, gV, mask):
        """The V-gradient knobs of reference loss.h:145-155, then the push
        filter. On a mesh gV is this rank's V shard and mask this data
        shard's rows: the batch's row count sums over the data axis, the
        dropout draws the whole table's mask (every rank the same stream)
        and keeps its rows, and the int8 filter's scale is the whole
        table's."""
        cfg = self.cfg
        mesh = self._mesh_layout
        if cfg.grad_normalization:
            n = torch.sum(mask).reshape(1)
            if mesh:
                collectives.allreduce_sum(n, self.mesh, DATA_AXIS)
            gV = gV / torch.clamp(n[0], min=1.0)
        if cfg.grad_clipping > 0:
            gV = torch.clamp(gV, -cfg.grad_clipping, cfg.grad_clipping)
        if cfg.dropout > 0:
            shape = (cfg.vb, cfg.dim) if mesh else gV.shape
            keep = torch.rand(shape, generator=self._gen,
                              device=gV.device) < 1.0 - cfg.dropout
            if mesh:
                keep = keep[self.vstore.lo:self.vstore.hi]
            gV = gV * keep
        return quantize_push(gV, cfg.fixed_bytes, self._shard_mesh)

    def _train_step_xla(self, seg, idx, vidx, val, label, mask):
        cfg = self.cfg
        st, vst = self.store.state, self.vstore.state
        nb, vb = cfg.num_buckets, cfg.vb

        # count push + admission (kPushFeaCnt parity)
        live = (val != 0).to(torch.float32)
        push_cnt = torch.zeros(nb, device=val.device).index_add_(0, idx, live)
        st["cnt"].add_(push_cnt)

        w, V = st["w"], vst["V"]
        margin, xw, xv, vval = _fm_forward(cfg, w, V, st["cnt"], seg, idx,
                                           vidx, val, label.shape[0])
        obj, d = _loss_dual(cfg.loss, label, margin)
        d = d * mask

        gw = quantize_push(spmv_t(seg, idx, val, d, nb), cfg.fixed_bytes)
        touched_w = (push_cnt > 0).to(torch.float32)

        # dV_j = sum_i d_i x_ij (Xv_i - x_ij V_j)   (loss.h:183-279)
        d_nz = d.index_select(0, seg) * vval
        contrib = d_nz[:, None] * (xv.index_select(0, seg)
                                   - vval[:, None] * V.index_select(0, vidx))
        gV = torch.zeros(vb, cfg.dim, device=V.device).index_add_(
            0, vidx, contrib)
        gV = self._grad_filters(gV, mask)
        touched_v = (torch.zeros(vb, device=V.device).index_add_(
            0, vidx, (vval != 0).to(torch.float32)) > 0
        ).to(torch.float32)[:, None]

        # updates: w by FTRL, V by AdaGrad, in place
        old_nnz = torch.count_nonzero(w)
        lin = {k: st[k] for k in ("w", "z", "n")}
        for k, v in _update("ftrl", lin, gw, touched_w, cfg).items():
            st[k].copy_(v)
        nV = vst["nV"]
        nV.add_(touched_v * gV * gV)
        eta = (cfg.V_lr_beta + torch.sqrt(nV)) / cfg.V_lr_eta
        V_new = V - touched_v * (gV + cfg.lambda_V * V) / eta
        V.copy_(torch.where(touched_v > 0, V_new, V))

        prog = _progress(obj, margin, label, mask,
                         torch.count_nonzero(w) - old_nnz)
        prog["objv_w"] = torch.sum(_loss_dual(cfg.loss, label, xw)[0] * mask)
        return prog

    def _fwd_xla(self, seg, idx, vidx, val, label, mask):
        st = self.store.state
        margin, _, _, _ = _fm_forward(self.cfg, st["w"], self.vstore.state["V"],
                                      st["cnt"], seg, idx, vidx, val,
                                      label.shape[0])
        obj, _ = _loss_dual(self.cfg.loss, label, margin)
        return margin, _progress(obj, margin, label, mask)

    # -- dmesh kind (see the module docstring) -------------------------------
    def _mesh_prepared(self, seg, idx, val, label, mask, size: int):
        """The dmesh kind of a global batch's COO triples (seg in the
        global batch's rows) and this data shard's label and mask: the w
        cell (pack_mesh_cell, tile-packed for the kernels), the data
        shard's live nonzeros (bucket, local row, value) and, of them, the
        positions and local V rows of this rank's V cell."""
        cfg = self.cfg
        D, M = self.mesh.num_data, self.mesh.num_model
        d, m = self.mesh.coords
        cell, dropped = ck.pack_mesh_cell(
            idx, seg, val, cfg.num_buckets, cfg.minibatch, D, M, d, m,
            self._shard_cap, device=self.device, tiled=self._mesh_kernels)
        if dropped:
            _log.warning("mesh cell (%d, %d) overflow: dropped %d nonzeros "
                         "— raise nnz_per_row or mesh_capacity slack", d, m,
                         dropped)
        rows_d = cfg.minibatch // D
        seg = np.asarray(seg, np.int64)
        val = np.asarray(val, np.float32)
        sel = (val != 0) & (seg // rows_d == d)
        r_idx = np.asarray(idx, np.int64)[sel]
        vb_m = cfg.vb // M
        vrow = r_idx % cfg.vb
        vpos = np.flatnonzero(vrow // vb_m == m)
        return ("dmesh", (cell, r_idx.astype(np.int32),
                          (seg[sel] - d * rows_d).astype(np.int32), val[sel],
                          vpos, (vrow[vpos] - m * vb_m).astype(np.int32)),
                label, mask, size)

    def _mesh_admission(self, r_idx):
        """1.0 where the nonzero's bucket is admitted (cnt >= threshold,
        and w != 0 with l1_shrk), for every live nonzero of the data
        shard: each model shard answers for its own buckets, the answers
        sum over the model axis."""
        cfg = self.cfg
        st = self.store.state
        lo, hi = self.store.lo, self.store.hi
        own = (r_idx >= lo) & (r_idx < hi)
        at = torch.where(own, r_idx - lo, torch.zeros_like(r_idx)).long()
        adm = st["cnt"].index_select(0, at) >= cfg.threshold
        if cfg.l1_shrk:
            adm = adm & (st["w"].index_select(0, at) != 0)
        adm = (adm & own).to(torch.float32)
        return collectives.allreduce_sum(adm, self.mesh, MODEL_AXIS)

    def _mesh_forward(self, cell, r_idx, r_seg, r_val, vpos, vloc):
        """(margin, xw, xv) of this data shard's rows and (the local rows,
        the admitted values) of the V cell's nonzeros: xw by W1, xv and
        the x2 term over the V cell summed over the model axis."""
        cfg = self.cfg
        rows_d = cfg.minibatch // self.mesh.num_data
        pull = (ck.mesh_coo_spmv if self._mesh_kernels
                else ck.mesh_coo_spmv_plain)
        xw = pull(self.mesh, self.store.state["w"], *cell, cfg.minibatch,
                  dtype=self._fm_dtype)
        vval = (r_val * self._mesh_admission(r_idx)).index_select(0, vpos)
        vs = r_seg.index_select(0, vpos)
        V = self.vstore.state["V"]
        parts = torch.cat([spmm(vs, vloc, vval, V, rows_d),
                           row_squares(vs, vloc, vval, V, rows_d)], 1)
        collectives.allreduce_sum(parts, self.mesh, MODEL_AXIS)
        xv, x2v2 = parts[:, :cfg.dim], parts[:, cfg.dim:]
        margin = xw + 0.5 * torch.sum(xv * xv - x2v2, dim=-1)
        return margin, xw, xv, vs, vval

    def _mesh_progress(self, margin, xw, label, mask, new_w=None):
        """(the global batch's progress, the same on every rank, and its
        margins): margin, xw, label and mask gathered over the data axis
        in one all_reduce, the |w|_0 delta summed over the model axis."""
        cfg = self.cfg
        margin, xw, label, mask = collectives.gather_rows(
            torch.stack([margin, xw, label, mask], 1), self.mesh,
            DATA_AXIS).unbind(1)
        if new_w is not None:
            new_w = collectives.allreduce_sum(new_w.reshape(1), self.mesh,
                                              MODEL_AXIS)[0]
        obj, _ = _loss_dual(cfg.loss, label, margin)
        prog = _progress(obj, margin, label, mask, new_w)
        if new_w is not None:
            prog["objv_w"] = torch.sum(
                _loss_dual(cfg.loss, label, xw)[0] * mask)
        return prog, margin

    def _train_step_dmesh(self, cidx, cseg, cval, ctmap, cfirst, r_idx,
                          r_seg, r_val, vpos, vloc, label, mask):
        cfg = self.cfg
        st, vst = self.store.state, self.vstore.state
        cell = (cidx, cseg, cval, ctmap, cfirst)
        # count push of the global batch, before the forward (kPushFeaCnt
        # parity: admission sees this batch's counts)
        push_cnt = torch.zeros_like(st["cnt"]).index_add_(
            0, cidx, (cval != 0).to(torch.float32))
        collectives.allreduce_sum(push_cnt, self.mesh, DATA_AXIS)
        st["cnt"].add_(push_cnt)

        margin, xw, xv, vs, vval = self._mesh_forward(cell, r_idx, r_seg,
                                                      r_val, vpos, vloc)
        obj, d = _loss_dual(cfg.loss, label, margin)
        d = d * mask
        push = (ck.mesh_coo_spmv_t if self._mesh_kernels
                else ck.mesh_coo_spmv_t_plain)
        gw = quantize_push(push(self.mesh, d, *cell, cfg.num_buckets,
                                dtype=self._fm_dtype), cfg.fixed_bytes,
                           self.mesh)
        touched_w = (push_cnt > 0).to(torch.float32)

        # dV_j = sum_i d_i x_ij (Xv_i - x_ij V_j) over the V cell, and the
        # rows it touches, summed over the data axis in one block
        V = vst["V"]
        contrib = (d.index_select(0, vs) * vval)[:, None] * (
            xv.index_select(0, vs) - vval[:, None] * V.index_select(0, vloc))
        block = torch.zeros(V.shape[0], cfg.dim + 1, device=V.device)
        block[:, :cfg.dim].index_add_(0, vloc, contrib)
        block[:, cfg.dim].index_add_(0, vloc, (vval != 0).to(torch.float32))
        collectives.allreduce_sum(block, self.mesh, DATA_AXIS)
        gV = self._grad_filters(block[:, :cfg.dim], mask)
        touched_v = (block[:, cfg.dim:] > 0).to(torch.float32)

        w = st["w"]
        old_nnz = torch.count_nonzero(w)
        lin = {k: st[k] for k in ("w", "z", "n")}
        for k, v in _update("ftrl", lin, gw, touched_w, cfg).items():
            st[k].copy_(v)
        nV = vst["nV"]
        nV.add_(touched_v * gV * gV)
        eta = (cfg.V_lr_beta + torch.sqrt(nV)) / cfg.V_lr_eta
        V_new = V - touched_v * (gV + cfg.lambda_V * V) / eta
        V.copy_(torch.where(touched_v > 0, V_new, V))
        return self._mesh_progress(margin, xw, label, mask,
                                   torch.count_nonzero(w) - old_nnz)[0]

    def _fwd_dmesh(self, cidx, cseg, cval, ctmap, cfirst, r_idx, r_seg,
                   r_val, vpos, vloc, label, mask):
        """(the global batch's margins, its progress)."""
        margin, xw = self._mesh_forward((cidx, cseg, cval, ctmap, cfirst),
                                        r_idx, r_seg, r_val, vpos, vloc)[:2]
        prog, margin = self._mesh_progress(margin, xw, label, mask)
        return margin, prog

    def _mesh_margins(self, args):
        return self._fwd_dmesh(*args)[0]

    # -- compacted fm kind ---------------------------------------------------
    # Admission (cnt >= threshold) is decided at pack time from a HOST
    # mirror of the count table: counts are pure data statistics the host
    # can track exactly, and the mirror resyncs from the device table
    # after loads and at every pass start. l1_shrk needs w at pack time,
    # so it stays on the xla kind.

    def refresh_count_mirror(self) -> None:
        """Resync the host count mirror. Only the fm kind's pack reads
        it; the dmesh kind admits from the device table, which holds the
        global batch's counts (summed over the data axis)."""
        if self._use_fm_pallas:
            self._cnt_host = self.store.state["cnt"].cpu().numpy().copy()

    def on_pass_start(self) -> None:
        """Solver hook: resync the count mirror from the device table so
        any drift (e.g. batches packed but never consumed after an
        aborted pass) is bounded to one pass."""
        with self._fm_lock:
            self.refresh_count_mirror()

    @property
    def _v_rows_per_tile(self) -> int:
        return ck.TILE // self.cfg.dim

    def _pack_fm(self, db: DeviceBatch, train: bool):
        """Host pack (loader threads; the count mirror's read-modify-write
        is serialized by _fm_lock so it sees batches in order): localize w
        keys and V rows into tile-run-aligned compact slots
        (coo_kernels.assign_tile_slots), apply admission to the V values,
        and lay both out for the kernels. The sorts and uniques run on the
        learner's device (native), the layout around them on the host.
        Same arrays as the JAX learner's _pack_fm."""
        cfg = self.cfg
        dev = self.device
        idx64 = db.idx.astype(np.int64)
        live = db.val != 0
        loc = localize(idx64.astype(np.uint64), dev)
        uniq = loc.uniq_keys.astype(np.int64)
        inv = loc.local_index
        live_counts = np.bincount(
            inv[live], minlength=len(uniq)).astype(np.float32)
        with self._fm_lock:
            if self._fm_caps is None:
                # the first batch to pack may be a short tail part: scale
                # its unique counts up to a full minibatch's worth (capped
                # at 4x) so the permanent capacities are not sized from a
                # fragment
                fill = cfg.row_capacity / max(int(live.sum()), 1)
                scale = 1.5 * min(max(fill, 1.0), 4.0)
                blocks_w = ck.tile_blocks_needed(uniq, ck.TILE)
                uw = (-(-int(scale * blocks_w) * ck.BLK_U // ck.TILE)
                      * ck.TILE)
                vuniq0 = (native.unique(idx64[live] % cfg.vb, dev)[0]
                          if live.any() else np.zeros(1, np.int64))
                blocks_v = ck.tile_blocks_needed(vuniq0,
                                                 self._v_rows_per_tile)
                uv = int(scale * blocks_v + 1) * ck.BLK_U
                self._fm_caps = (uw, uv)
        uw_cap, uv_cap = self._fm_caps

        ts_w = ck.assign_tile_slots(uniq, ck.TILE, uw_cap, cfg.num_buckets,
                                    dev)
        slot_nz = ts_w.slot_of_uniq[inv]
        keep = slot_nz < uw_cap
        dropped = int(np.count_nonzero(~keep & live))
        idx64, seg, val, slot_nz = (idx64[keep], db.seg[keep],
                                    db.val[keep], slot_nz[keep])
        kept_r = ts_w.slot_of_uniq < uw_cap
        wcnts = np.zeros(uw_cap, np.float32)
        wcnts[ts_w.slot_of_uniq[kept_r]] = live_counts[kept_r]

        # admission per key from the mirror; training includes this
        # batch's own counts (the reference makes the weight pull depend
        # on the count push of the same minibatch, async_sgd.h:374-381)
        with self._fm_lock:
            cnt_key = self._cnt_host[uniq]
            if train:
                cnt_key = cnt_key + live_counts
                self._cnt_host[uniq[kept_r]] += live_counts[kept_r]
        adm_nz = (cnt_key >= cfg.threshold)[inv][keep] & (val != 0)

        # V domain: localize the (bucket % vb) rows of the kept nonzeros
        vidx = (idx64 % cfg.vb).astype(np.uint64)
        loc_v = localize(vidx, dev)
        ts_v = ck.assign_tile_slots(loc_v.uniq_keys, self._v_rows_per_tile,
                                    uv_cap, cfg.vb, dev)
        vslot_nz = ts_v.slot_of_uniq[loc_v.local_index]
        vval = np.where(adm_nz, val, 0.0).astype(np.float32)
        keepv = vslot_nz < uv_cap
        dropped += int(np.count_nonzero(~keepv & (vval != 0)))
        segv, vvalv, vslotv = seg[keepv], vval[keepv], vslot_nz[keepv]
        # row-major padded view (minibatch x nnz_per_row) of the live
        # nonzeros over the w-slot domain (ck.build_rm), with three
        # channels: the w slot, the w value, and the ADMITTED value (zero
        # where the threshold or a uv_cap overflow masks the embedding).
        # Slot uw_cap is the appended zero row.
        W = cfg.nnz_per_row
        rm_slot, (rm_wval, rm_vval), over = ck.build_rm(
            seg, slot_nz, val, cfg.minibatch, W, uw_cap,
            extra=(np.where(keepv, vval, 0.0),))
        rm_dropped = 0
        if len(over):
            # a row's nonzeros past nnz_per_row drop from EVERY layout (rm
            # forward, w COO, V COO) so pull and push agree on which
            # nonzeros exist
            rm_dropped = int(np.count_nonzero(val[over]))
            val = val.copy()
            val[over] = 0.0
            mask_src = np.ones(len(seg), bool)
            mask_src[over] = False
            vvalv[~mask_src[keepv]] = 0.0
        # per-w-slot V row for the unified table: the slot's key -> its V
        # bucket's compact slot (uv_cap sentinel -> the zero V row, for
        # alignment holes and uv_cap-overflowed keys)
        vslot_w = np.full(uw_cap, uv_cap, np.int32)
        w_slots_valid = np.flatnonzero(ts_w.uniq < cfg.num_buckets)
        vkeys = (ts_w.uniq[w_slots_valid].astype(np.int64)
                 % cfg.vb).astype(np.uint64)
        li = np.searchsorted(loc_v.uniq_keys, vkeys)
        li = np.clip(li, 0, max(len(loc_v.uniq_keys) - 1, 0))
        ok = loc_v.uniq_keys[li] == vkeys
        vs = np.minimum(ts_v.slot_of_uniq[li], uv_cap).astype(np.int32)
        vslot_w[w_slots_valid] = np.where(ok, vs, uv_cap)
        if dropped or rm_dropped:
            with self._fm_lock:
                self.dropped_slot_nnz += dropped
                self.dropped_row_nnz += rm_dropped
            _log.warning(
                "fm compaction overflow: dropped %d nonzeros to the slot "
                "caps (caps %s — raise key diversity of the first batch) "
                "and %d to the nnz_per_row row cap (%d — raise "
                "nnz_per_row; the row-major forward caps xw too)",
                dropped, self._fm_caps, rm_dropped, W)
        if not train:
            # eval/predict never scatter: the sorted COO streams are a
            # train-only cost
            return (ts_w, wcnts, None, ts_v, None, None,
                    rm_slot, rm_wval, rm_vval, vslot_w)
        wcoo = ck.pack_sorted_coo(slot_nz, seg, val, uw_cap,
                                  capacity=cfg.row_capacity, device=dev)
        vtouched = np.zeros(uv_cap, np.float32)
        vtouched[native.unique(vslotv[vvalv != 0], dev)[0]] = 1.0
        vcoo = ck.pack_sorted_coo(vslotv, segv, vvalv, uv_cap,
                                  capacity=cfg.row_capacity,
                                  tile=ck.TILE_HI, blk=ck.FM_BLK, device=dev)
        return (ts_w, wcnts, wcoo, ts_v, vtouched, vcoo,
                rm_slot, rm_wval, rm_vval, vslot_w)

    @staticmethod
    def _fm_args(pk, label, mask, train: bool) -> list:
        """The pack's arrays in the order the fm steps take them."""
        (ts_w, wcnts, wcoo, ts_v, vtouched, vcoo,
         rm_slot, rm_wval, rm_vval, vslot_w) = pk
        rm_parts = [rm_slot, rm_wval, rm_vval, vslot_w]
        if not train:
            return ([ts_w.uniq, ts_w.tmap_u, ts_v.uniq, ts_v.tmap_u]
                    + rm_parts + [label, mask])
        return ([ts_w.uniq, ts_w.tmap_u, ts_w.first_u, ts_w.last_u, wcnts,
                 wcoo.idx, wcoo.seg, wcoo.val, wcoo.tmap, wcoo.first,
                 ts_v.uniq, ts_v.tmap_u, ts_v.first_u, ts_v.last_u, vtouched,
                 vcoo.idx, vcoo.seg, vcoo.val, vcoo.tmap, vcoo.first]
                + rm_parts + [label, mask])

    def _gather_compact(self, uniq_w, wtm, uniq_v, vtm):
        dt = self._fm_dtype
        wc = ck.tile_gather(self.store.state["w"].view(-1, ck.LANES),
                            uniq_w, wtm, dtype=dt)
        Vc = row_tile_gather(self.vstore.state["V"].view(-1, ck.LANES),
                             uniq_v, vtm, self.cfg.dim, dtype=dt)
        return wc, Vc

    def _wire(self, t) -> torch.dtype:
        """Dtype the forward's row gathers move at: the kernel dtype
        (bf16 halves the bytes of U and xvd; sums stay f32)."""
        return ck.kernel_dtype(self._fm_dtype, t)

    def _forward_rm(self, wc, Vc, rm_slot, rm_wval, rm_vval, vslot_w):
        """Row-major forward over the unified compact table
        U[s] = [V row of slot s's key | w[s]]: one row gather and a dense
        reshape-reduce give xw, xv and the x2 term together."""
        cfg = self.cfg
        dim, wire = cfg.dim, self._wire(wc)
        Vcz = torch.cat([Vc.to(wire), Vc.new_zeros(1, dim, dtype=wire)])
        U = torch.cat([Vcz.index_select(0, vslot_w),
                       wc.to(wire)[:, None]], dim=1)      # [uw_cap, dim+1]
        Uz = torch.cat([U, U.new_zeros(1, dim + 1)])
        U_nnz = Uz.index_select(0, rm_slot).to(torch.float32)
        xw = (rm_wval * U_nnz[:, dim]).reshape(cfg.minibatch, -1).sum(1)
        p = rm_vval[:, None] * U_nnz[:, :dim]
        xv = p.reshape(cfg.minibatch, -1, dim).sum(1)
        x2 = (p * p).reshape(cfg.minibatch, -1, dim).sum(1)
        margin = xw + 0.5 * torch.sum(xv * xv - x2, dim=-1)
        return xw, xv, margin

    def _train_step_fm(self, uniq_w, wtm, wfi, wla, wcnts,
                       widx, wseg, wval, wtmap, wfirst,
                       uniq_v, vtm, vfi, vla, vtouched,
                       vidx, vseg, vval, vtmap, vfirst,
                       rm_slot, rm_wval, rm_vval, vslot_w, label, mask):
        cfg = self.cfg
        dt, dim = self._fm_dtype, cfg.dim
        wc, Vc = self._gather_compact(uniq_w, wtm, uniq_v, vtm)
        xw, xv, margin = self._forward_rm(wc, Vc, rm_slot, rm_wval,
                                          rm_vval, vslot_w)
        obj, d = _loss_dual(cfg.loss, label, margin)
        d = d * mask

        # w: FTRL at the keys' storage, in place; cnt rides the same
        # update as its additive table
        gw = ck.coo_spmv_t(d, widx, wseg, wval, wtmap, wfirst,
                           self._fm_caps[0], dtype=dt)
        _, new_w = scatter_update(
            "ftrl", self.store.state, gw, uniq_w, wtm, wfi, wla,
            lr_eta=cfg.lr_eta, lr_beta=cfg.lr_beta, lambda_l1=cfg.lambda_l1,
            lambda_l2=cfg.lambda_l2, fixed_bytes=cfg.fixed_bytes, dtype=dt,
            add_table="cnt", add_values=wcnts)

        # V: dV_j = sum c * (xv_i - val * V_j), c = d_i * val. The xv and d
        # factors ride one row gather from the [mb, dim+1] layout (pad
        # entries carry val = 0 and vanish); the kernel sums per row and
        # applies the V_j term from the compact rows it is given.
        wire = self._wire(wc)
        G = torch.cat([xv, d[:, None]], dim=1).to(wire).index_select(0, vseg)
        c = G[:, dim].to(torch.float32) * vval
        a = (c[:, None] * G[:, :dim].to(torch.float32)).to(wire).float()
        b = (c * vval).to(wire).float()
        gV = ck.fm_push_contrib(Vc, a, b, vidx, vtmap, vfirst, dtype=dt)
        gV = self._grad_filters(gV, mask)
        vst = self.vstore.state
        v_scatter_update(vst["V"], vst["nV"], gV, vtouched, uniq_v, vtm,
                         vfi, vla, dim=dim, V_lr_eta=cfg.V_lr_eta,
                         V_lr_beta=cfg.V_lr_beta, lambda_V=cfg.lambda_V,
                         dtype=dt)

        prog = _progress(obj, margin, label, mask, new_w)
        prog["objv_w"] = torch.sum(_loss_dual(cfg.loss, label, xw)[0] * mask)
        return prog

    def _fwd_fm(self, uniq_w, wtm, uniq_v, vtm, rm_slot, rm_wval, rm_vval,
                vslot_w, label, mask):
        wc, Vc = self._gather_compact(uniq_w, wtm, uniq_v, vtm)
        margin = self._forward_rm(wc, Vc, rm_slot, rm_wval, rm_vval,
                                  vslot_w)[2]
        obj, _ = _loss_dual(self.cfg.loss, label, margin)
        return margin, _progress(obj, margin, label, mask)

    # -- batch plumbing ------------------------------------------------------
    def make_device_batch(self, blk: RowBlock) -> DeviceBatch:
        db = to_device_batch(blk, self.cfg.minibatch, self.cfg.row_capacity,
                             self.cfg.num_buckets)
        if db.dropped_rows:
            self._dropped_rows += db.dropped_rows
            _log.warning("minibatch overflow: dropped %d rows (total %d) — "
                         "raise nnz_per_row or minibatch capacity",
                         db.dropped_rows, self._dropped_rows)
        return db

    def prepare_batch(self, blk: RowBlock, train: bool = True):
        """Host-side batch prep for the solver's loader threads. A train
        pack of the fm kind advances the count mirror, so it must be
        consumed by a train step."""
        db = self.make_device_batch(blk)
        if self._mesh_layout:
            lo, hi = batch_range(self.mesh, self.cfg.minibatch)
            return self._mesh_prepared(db.seg, db.idx, db.val,
                                       db.label[lo:hi], db.row_mask[lo:hi],
                                       blk.size)
        if not self._use_fm_pallas:
            return ("xla", db, blk.size)
        return ("fm", self._pack_fm(db, train), db.label, db.row_mask,
                blk.size, train)

    def pack_cache_token(self, train: bool = True):
        """Everything (beyond the raw batch bytes) that decides what
        prepare_batch emits, or None where a pack cannot be replayed. The
        compact train pack reads the count mirror and moves it (_pack_fm),
        so a replayed one would be stale and skip its count push: None.
        An eval pack is pure given the mirror, keyed by a digest of the
        mirror's bytes once the slot caps are sized: a counter local to the
        process
        would let a run that shares the disk tier replay another run's
        admissions. The digest reads the whole mirror, once a pass. The
        xla kind packs with no host state and caches for both."""
        cfg = self.cfg
        base = ("difacto", self._PACK_VERSION, self._use_fm_pallas,
                cfg.minibatch, cfg.nnz_per_row, cfg.num_buckets, cfg.vb,
                cfg.dim, cfg.threshold, cfg.l1_shrk)
        if self._mesh_layout:  # the cells hold no host state
            return base + ("dmesh", self._mesh_kernels, self._shard_cap,
                           self.mesh.num_data, self.mesh.num_model,
                           ck.TILE, ck.BLK, ck.LANES, *self.mesh.coords)
        if not self._use_fm_pallas:
            return base
        if train or self._fm_caps is None:
            return None
        with self._fm_lock:
            mirror = hashlib.blake2b(self._cnt_host.data,
                                     digest_size=16).hexdigest()
        return base + (self._fm_caps, mirror, ck.TILE, ck.BLK_U,
                       ck.TILE_HI, ck.FM_BLK, ck.LANES)

    def _prepared(self, x, train: bool):
        # prepared and staged batches are tuples; anything else is a
        # RowBlock-like CSR batch
        return x if isinstance(x, tuple) else self.prepare_batch(x, train)

    def _dev(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def stage_batch(self, b, train: bool = True):
        """Move a prepared batch's arrays to the device (from a loader
        thread, overlapping the main thread's step)."""
        b = self._prepared(b, train)
        if b[0] == "staged":
            return b
        cfg = self.cfg
        ids = None
        if b[0] == "dmesh":
            _, (cell, *rest), label, mask, size = b
            arrays = [cell.idx, cell.seg, cell.val, cell.tmap, cell.first,
                      *rest, label, mask]
        elif b[0] == "xla":
            db, size = b[1], b[2]
            vidx = (db.idx % np.int32(cfg.vb)).astype(np.int32)
            arrays = [db.seg, db.idx, vidx, db.val, db.label, db.row_mask]
            if train and self.track_touched:
                ids_w = np.unique(db.idx[db.val != 0]).astype(np.int64)
                ids = (ids_w, ids_w % cfg.vb)
        else:
            _, pk, label, mask, size, packed_for_train = b
            if packed_for_train != train:
                raise ValueError("batch was packed for "
                                 f"{'train' if packed_for_train else 'eval'}")
            arrays = self._fm_args(pk, label, mask, train)
            if train and self.track_touched:
                # the pack's host uniques, sentinel slots filtered
                ts_w, ts_v = pk[0], pk[3]
                ids = (ts_w.uniq[ts_w.uniq < cfg.num_buckets]
                       .astype(np.int64),
                       ts_v.uniq[ts_v.uniq < cfg.vb].astype(np.int64))
        return ("staged", b[0], tuple(self._dev(*arrays)), size, train, ids)

    # -- entry points --------------------------------------------------------
    def train_batch(self, blk) -> dict:
        """One training step on a RowBlock, a prepared or a staged batch;
        updates the tables in place and returns the progress dict."""
        _, kind, args, _, st_train, ids = self.stage_batch(
            self._prepared(blk, True), train=True)
        if not st_train:
            raise ValueError("batch was staged for eval, not train")
        step = {"fm": self._train_step_fm, "xla": self._train_step_xla,
                "dmesh": self._train_step_dmesh}[kind]
        prog = _to_floats(step(*args))
        if self.track_touched:
            self._note_touched(ids)
        self._step_count += 1
        return prog

    # -- sparse PS wire hints ------------------------------------------------
    def _note_touched(self, ids) -> None:
        if ids is None:
            ids = (None, None)
        with self._touched_lock:
            self._touched_w.append(ids[0])
            self._touched_v.append(ids[1])

    def collect_touched(self):
        """Sorted-unique global rows touched since the last call, per
        table (the sparse PS push set; reference ZPush of the
        minibatch's keys, async_sgd.h:270-287), or None if a trained
        batch lacked a hint (SyncedStore then scans the whole delta)."""
        with self._touched_lock:
            tw, tv = self._touched_w, self._touched_v
            self._touched_w, self._touched_v = [], []
        if any(a is None for a in tw):
            return None
        uw = (np.unique(np.concatenate(tw)) if tw
              else np.empty(0, np.int64))
        uv = (np.unique(np.concatenate(tv)) if tv
              else np.empty(0, np.int64))
        out = {k: uw for k in self.store.state}
        out.update({k: uv for k in self.vstore.state})
        return out

    def _on_sparse_pull(self, updates) -> None:
        """Keep the host count mirror coherent with sparse PS pulls (the
        dense path refreshes it through on_load / from_numpy)."""
        got = updates.get("cnt")
        if got is None:
            return
        idx, rows = got
        with self._fm_lock:
            self._cnt_host[idx] = rows

    def _fwd_any(self, blk):
        _, kind, args, size, st_train, _ = self.stage_batch(
            self._prepared(blk, False), train=False)
        if st_train:
            raise ValueError("batch was staged for train, not eval")
        margin, prog = {"fm": self._fwd_fm, "xla": self._fwd_xla,
                        "dmesh": self._fwd_dmesh}[kind](*args)
        return margin, prog, size

    def eval_batch(self, blk) -> dict:
        return _to_floats(self._fwd_any(blk)[1])

    def predict_batch(self, blk) -> np.ndarray:
        """Margins (or probabilities with prob_predict) of the batch's
        real rows."""
        margin, _, size = self._fwd_any(blk)
        out = margin.cpu().numpy()[:size]
        if self.cfg.prob_predict:
            out = 1.0 / (1.0 + np.exp(-out))
        return out

    def nnz(self) -> int:
        return self.store.nnz("w")

    def _admitted(self) -> np.ndarray:
        """Admission of every bucket (on a mesh a collective: the shards
        gathered into the whole table on every rank)."""
        st = self.store.to_numpy()
        admit = st["cnt"] >= self.cfg.threshold
        if self.cfg.l1_shrk:
            admit &= st["w"] != 0
        return admit

    def num_admitted(self) -> int:
        return int(self._admitted().sum())

    def v_collision_rate(self) -> float:
        """Fraction of ADMITTED keys whose V bucket (key % v_buckets) is
        shared with another admitted key: the aliasing the fixed-capacity
        V table adds over the reference's exact per-key embeddings
        (async_sgd.h:135-209); rate ~ n_admitted / v_buckets for a
        uniform hash."""
        keys = np.flatnonzero(self._admitted())
        if len(keys) == 0:
            return 0.0
        counts = native.unique(keys % self.cfg.vb, self.device)[2]
        return int(np.sum(counts[counts > 1])) / len(keys)


def make_early_stop_hook(cfg: DifactoConfig):
    """Early stop when the validation objective stops improving by epsilon
    (reference AsyncScheduler::Stop, difacto async_sgd.h:31-49)."""
    best = {"objv": None}

    def hook(prog, dp, key) -> bool:
        if cfg.early_stop_epsilon <= 0 or key != "val":
            return False
        objv = prog.mean("objv")  # the trained objective, loss-agnostic
        if best["objv"] is not None and (
            best["objv"] - objv < cfg.early_stop_epsilon
        ):
            return True
        if best["objv"] is None or objv < best["objv"]:
            best["objv"] = objv
        return False

    return hook
