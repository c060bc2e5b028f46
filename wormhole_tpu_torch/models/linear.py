"""Sparse linear learner: async-SGD logistic regression, on one device or
a (data x model) mesh of ranks.

Parity target: the reference's flagship `linear.dmlc` app
(learn/linear/async_sgd.h, loss.h, penalty.h, config.proto) — logistic /
squared-hinge loss over hashed sparse features, with per-key SGD /
AdaGrad / FTRL update rules and elastic-net regularization. Same config
surface, prepared-batch kinds and step math as the JAX package's
models/linear.py.

A training step runs pull -> loss dual -> push -> handle update. The
prepared batch picks the ops:
- ``xla``: plain torch gather / index_add_ over the padded COO batch
  (ops/spmv.py), then the dense handle update (``kernel=xla``);
- ``coo``: the hand kernels coo_spmv / coo_spmv_t over the bucket-sorted
  batch, then the dense handle update (``kernel=pallas``, dense table);
- ``tcoo``: the compacted path for Criteo-1TB-sized tables: tile_gather
  of w at the batch's unique keys, a row-major pull over the compact w,
  coo_spmv_t over the compact domain, and scatter_update at those keys;
- ``mcoo``: on a mesh larger than 1x1, each rank packs its (data shard x
  model shard) cell of the global batch, runs mesh_coo_spmv (all_reduce
  over the model axis) and mesh_coo_spmv_t (all_reduce over the data
  axis), W1 and W2 with the hand kernels, and updates its model shard;
  with ``kernel=xla`` the same cells, unsorted, go through the plain
  twins mesh_coo_spmv_plain / mesh_coo_spmv_t_plain instead. Every rank
  steps through the same global batches, or, on the global mesh
  (`global_step_protocol`), feeds its own rows of each; the progress of
  each is that of the whole batch (xw, label and mask gathered over the
  data axis).

The state tables are torch tensors updated IN PLACE by every train step
(the JAX learner donates them to jitted steps instead).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

import numpy as np
import torch

from wormhole_tpu_torch import native
from wormhole_tpu_torch.data.rowblock import DeviceBatch, RowBlock, to_device_batch
from wormhole_tpu_torch.ops import coo_kernels as ck
from wormhole_tpu_torch.ops import metrics as M
from wormhole_tpu_torch.ops.fused_update import scatter_update
from wormhole_tpu_torch.ops.penalty import l1l2_solve
from wormhole_tpu_torch.ops.spmv import spmv, spmv_t
from wormhole_tpu_torch.parallel import collectives
from wormhole_tpu_torch.parallel.kvstore import KVStore, TableSpec, quantize_push
from wormhole_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                              batch_range, single_device_mesh)

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class LinearConfig:
    """Config surface of reference learn/linear/config.proto, with the same
    keys and defaults as the JAX package's LinearConfig, so one conf file
    drives both. The PS plane's keys feed apps/_runner.py, global_mesh
    its global mesh; model_shards sizes the app's mesh (apps/linear.py)."""

    train_data: str = ""
    val_data: Optional[str] = None
    model_out: Optional[str] = None
    model_in: Optional[str] = None
    predict_out: Optional[str] = None
    data_format: str = "libsvm"
    max_data_pass: int = 1

    loss: str = "logit"  # logit | square_hinge
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    prob_predict: bool = False  # predict probabilities, not margins

    algo: str = "ftrl"  # ftrl | adagrad | sgd
    lr_eta: float = 0.1
    lr_beta: float = 1.0

    minibatch: int = 1000
    num_parts_per_file: int = 2
    rand_shuffle: int = 0  # shuffle buffer in minibatches (0 = off)
    neg_sampling: float = 1.0
    fixed_bytes: int = 0  # gradient-push quantization filter
    msg_compression: int = 0
    max_delay: int = 16
    # loader threads preparing batches while the device steps
    max_concurrency: int = 4
    dispatch: str = "online"
    local_data: bool = False
    server_snapshot_sec: float = 5.0
    ps_retry_sec: float = 0.0
    global_mesh: bool = False
    print_sec: int = 1
    save_iter: int = -1
    load_iter: int = -1

    # table size = hash-kernel bucket count; row capacity = minibatch x
    # nnz_per_row nonzeros per batch
    num_buckets: int = 1 << 20
    nnz_per_row: int = 64
    model_shards: int = 1

    # pallas = the hand CUDA kernels (coo / tcoo / mcoo) | xla = plain
    # torch ops | auto = the kernels on a CUDA device or on a mesh larger
    # than 1x1 when the shapes allow, else xla
    kernel: str = "auto"
    # compacted path: -1 = auto (sized from the first batch), 0 = off,
    # > 0 = explicit slot capacity (rounded up to a whole tile)
    compact_cap: int = -1
    # kernel compute dtype: f32 | bf16 | auto (f32 when fixed_bytes == 0,
    # else the kernel default: bf16 on CUDA, f32 on the CPU)
    kernel_dtype: str = "auto"

    @property
    def row_capacity(self) -> int:
        return self.minibatch * self.nnz_per_row


def _loss_dual(loss: str, y01, xw):
    """Per-example objective and gradient dual d = dObj/dXw.

    logit (reference linear/loss.h:93-130): obj = softplus(xw) - y*xw,
    d = sigmoid(xw) - y    (y in {0,1})
    square_hinge (loss.h:132-157): obj = max(0, 1 - ys*xw)^2,
    d = -2 ys max(0, 1 - ys*xw)   (ys in {-1,+1})
    """
    if loss == "logit":
        obj = M.softplus(xw) - y01 * xw
        d = torch.sigmoid(xw) - y01
    elif loss == "square_hinge":
        ys = 2.0 * y01 - 1.0
        m = torch.clamp(1.0 - ys * xw, min=0.0)
        obj = m * m
        d = -2.0 * ys * m
    else:
        raise ValueError(f"unknown loss {loss!r}")
    return obj, d


def _where(touched, a, b):
    """jnp.where(touched > 0, a, b) for a tensor or scalar mask."""
    if torch.is_tensor(touched):
        return torch.where(touched > 0, a, b)
    return a if touched > 0 else b


def _update(algo: str, state, g, touched, cfg: LinearConfig):
    """Per-bucket update rules (reference async_sgd.h:71-180 handles).
    Returns the new tables; touched masks buckets that received a push
    this step, so shrinkage applies exactly when the reference's per-key
    Push would run."""
    out = dict(state)
    if algo == "ftrl":
        w, z, n = state["w"], state["z"], state["n"]
        sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / cfg.lr_eta
        z = z + touched * (g - sigma * w)
        n = n + touched * g * g
        eta = (cfg.lr_beta + torch.sqrt(n)) / cfg.lr_eta
        w_new = l1l2_solve(-z, eta, cfg.lambda_l1, cfg.lambda_l2)
        out["w"] = _where(touched, w_new, w)
        out["z"], out["n"] = z, n
    elif algo == "adagrad":
        w, n = state["w"], state["n"]
        n = n + touched * g * g
        eta = (cfg.lr_beta + torch.sqrt(n)) / cfg.lr_eta
        w_new = l1l2_solve(eta * w - g, eta, cfg.lambda_l1, cfg.lambda_l2)
        out["w"] = _where(touched, w_new, w)
        out["n"] = n
    elif algo == "sgd":
        w = state["w"]
        eta = 1.0 / cfg.lr_eta  # constant step size lr_eta
        w_new = l1l2_solve(eta * w - g, eta, cfg.lambda_l1, cfg.lambda_l2)
        out["w"] = _where(touched, w_new, w)
    else:
        raise ValueError(f"unknown algo {algo!r}")
    return out


def _tables_for(algo: str) -> dict[str, TableSpec]:
    t = {"w": TableSpec()}
    if algo == "ftrl":
        t["z"] = TableSpec()
        t["n"] = TableSpec(wire_cap="bf16")  # second moment: see TableSpec
    elif algo == "adagrad":
        t["n"] = TableSpec(wire_cap="bf16")
    return t


def _progress(obj, xw, label, mask, new_w=None):
    """Per-batch mergeable progress vector (reference linear/progress.h:
    objv, auc, acc, #ex, new_w). clk/pclk feed the COPC column; new_w is
    the |w|_0 delta the train step computed on the device."""
    n = torch.sum(mask)
    p = {
        "objv": torch.sum(obj * mask),
        "auc": M.auc(label, xw, mask) * n,
        "acc": M.accuracy(label, xw, mask) * n,
        "logloss": M.logloss(label, xw, mask) * n,
        "nex": n,
        "clk": torch.sum(label * mask),
        "pclk": torch.sum(torch.sigmoid(xw) * mask),
    }
    if new_w is not None:
        p["new_w"] = new_w
    return p


def _to_floats(p: dict) -> dict:
    """One device-to-host transfer for the whole progress vector."""
    vals = torch.stack([v.to(torch.float32) for v in p.values()]).tolist()
    return dict(zip(p, vals))


class GlobalMeshSteps:
    """The global-mesh protocol (apps/_runner.py _global_train) of a
    learner with a mesh layout: `_mesh_prepared(seg, idx, val, label,
    mask, size)` makes the prepared batch of global-batch COO triples and
    this data shard's label and mask, `_mesh_margins(args)` the global
    batch's margins from a staged one's arrays (label and mask last)."""

    def _global_prepared(self, blk, rank: int):
        """The mesh kind of this rank's own rows of a global step: its
        block is rows [rank * local_rows, (rank + 1) * local_rows) of the
        global batch (parallel/multihost.py global_coo_batch), exactly
        its data shard on the (num_workers x 1) mesh."""
        from wormhole_tpu_torch.parallel import multihost as mh

        cfg = self.cfg
        local_rows = cfg.minibatch // self.mesh.num_data
        db = to_device_batch(blk, local_rows, local_rows * cfg.nnz_per_row,
                             cfg.num_buckets)
        seg, idx, val, label, mask = mh.global_coo_batch(db, rank,
                                                         local_rows)
        return self._mesh_prepared(seg, idx, val, label, mask, blk.size)

    def _check_global(self) -> None:
        if not (self.mesh.device_mesh is not None
                and self.mesh.num_model == 1
                and self.cfg.minibatch % self.mesh.num_data == 0):
            raise ValueError(
                "the global mesh needs a (num_workers x 1) mesh over a "
                "process group and minibatch % num_workers == 0; have "
                f"{self.mesh.num_data}x{self.mesh.num_model}, minibatch "
                f"{self.cfg.minibatch}")

    def global_step_protocol(self):
        """(train_fn, eval_fn) of the global mesh: each takes this rank's
        RowBlock of a global step (an empty one once it has drained) and
        returns the global batch's progress, the same on every rank. The
        rng argument keeps the JAX package's signature: the ranks draw
        from generators seeded alike, in lockstep."""
        self._check_global()
        rank = self.mesh.rank

        def train_fn(blk, rng=None):
            return self.train_batch(self._global_prepared(blk, rank))

        def eval_fn(blk):
            return self.eval_batch(self._global_prepared(blk, rank))

        return train_fn, eval_fn

    def global_predict_protocol(self):
        """pred_fn(blk) -> (the global batch's margins, which every rank
        holds whole, and the global live-row count that drives the
        lockstep drain)."""
        self._check_global()
        rank = self.mesh.rank

        def pred_fn(blk):
            args = self.stage_batch(self._global_prepared(blk, rank),
                                    train=False)[2]
            nex = collectives.allreduce_sum(args[-1].sum().reshape(1),
                                            self.mesh, DATA_AXIS)
            return self._mesh_margins(args), float(nex[0])

        return pred_fn


class LinearLearner(GlobalMeshSteps):
    """Train/eval/predict steps over one device's weight table, or over
    this rank's shard of it on a mesh."""

    #: bump when prepare_batch's output layout changes for identical input
    _PACK_VERSION = 1
    #: the same for the mcoo kind (2: the cell's own rows of label, mask)
    _MESH_PACK_VERSION = 2

    def __init__(self, cfg: LinearConfig, device=None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        if mesh is not None and device is not None and \
                torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh if mesh is not None else single_device_mesh(device)
        self.device = self.mesh.device
        self._dropped_rows = 0
        if cfg.kernel not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown kernel {cfg.kernel!r}")
        D, M = self.mesh.num_data, self.mesh.num_model
        # a mesh larger than 1x1, or one rank of a process group (a
        # global mesh of one worker): the collective layout
        on_mesh = D > 1 or M > 1 or self.mesh.device_mesh is not None
        # per-cell kernel constraints: each model shard owns whole tiles,
        # each data shard whole lane groups
        shapes_ok = (cfg.num_buckets % (M * ck.TILE) == 0
                     and cfg.minibatch % (D * ck.LANES) == 0)
        self.use_pallas = cfg.kernel == "pallas" or (
            cfg.kernel == "auto" and shapes_ok
            and (self.device.type == "cuda" or on_mesh))
        if self.use_pallas and not shapes_ok:
            raise ValueError(
                f"the COO kernels need num_buckets % {M * ck.TILE} == 0 and "
                f"minibatch % {D * ck.LANES} == 0")
        # the mesh layout (per-cell products + all_reduce) whenever an
        # axis is larger than 1: W1/W2 on the hand kernels, or with
        # kernel=xla (or shapes the kernels refuse) their plain twins
        self._mesh_coo = on_mesh
        self._mesh_pull = (ck.mesh_coo_spmv if self.use_pallas
                           else ck.mesh_coo_spmv_plain)
        self._mesh_push = (ck.mesh_coo_spmv_t if self.use_pallas
                           else ck.mesh_coo_spmv_t_plain)
        self._shard_cap = ck.mesh_capacity(cfg.row_capacity, D, M)
        self.store = KVStore(cfg.num_buckets, _tables_for(cfg.algo),
                             self.device, mesh=self.mesh)
        # kernel compute dtype; None defers to the kernel default (bf16
        # on CUDA, f32 on the CPU); "auto" keeps f32 whenever
        # fixed_bytes == 0 so disabling gradient quantization also
        # disables the kernels' bf16 rounding
        if cfg.kernel_dtype == "f32" or (cfg.kernel_dtype == "auto"
                                         and cfg.fixed_bytes == 0):
            self._coo_dtype = torch.float32
        else:
            self._coo_dtype = None
        # the compacted path's slot capacity, decided from the first batch
        # (ensure_compact); the lock serializes that against loader threads
        self._compact_cap: Optional[int] = None
        self._compact_lock = threading.Lock()
        if self._mesh_coo or not self.use_pallas or cfg.compact_cap == 0:
            self._compact_cap = 0
        # sparse PS wire hints: unique buckets touched by trained batches
        # since the last collect_touched() drain
        self.track_touched = False
        self._touched_lock = threading.Lock()
        self._touched: list[Optional[np.ndarray]] = []

    def derived_tables(self) -> dict:
        """Tables that are non-additive pure functions of additive ones,
        for server-side recomputation in a PS data plane."""
        cfg = self.cfg
        if cfg.algo != "ftrl":
            return {}
        return {"w": {"kind": "ftrl_prox", "lr_eta": cfg.lr_eta,
                      "lr_beta": cfg.lr_beta, "lambda_l1": cfg.lambda_l1,
                      "lambda_l2": cfg.lambda_l2}}

    # -- steps -------------------------------------------------------------
    def _dense_update(self, g):
        """Filter, touched mask and handle update over the whole table,
        in place; returns the |w|_0 delta."""
        cfg = self.cfg
        st = self.store.state
        # touched comes from the unquantized gradient, so values the
        # filter rounds to zero still count as pushed. FTRL needs no
        # mask: g == 0 leaves z and n unchanged and w is a pure function
        # of (z, n).
        touched = (1.0 if cfg.algo == "ftrl"
                   else (g != 0).to(torch.float32))
        g = quantize_push(g, cfg.fixed_bytes,
                          self.mesh if self._mesh_coo else None)
        old_nnz = torch.count_nonzero(st["w"])
        for k, v in _update(cfg.algo, st, g, touched, cfg).items():
            if v is not st[k]:
                st[k].copy_(v)
        return torch.count_nonzero(st["w"]) - old_nnz

    def _train_step_xla(self, seg, idx, val, label, mask):
        cfg = self.cfg
        xw = spmv(seg, idx, val, self.store.state["w"], label.shape[0])
        obj, d = _loss_dual(cfg.loss, label, xw)
        g = spmv_t(seg, idx, val, d * mask, cfg.num_buckets)
        return _progress(obj, xw, label, mask, self._dense_update(g))

    def _eval_step_xla(self, seg, idx, val, label, mask):
        xw = spmv(seg, idx, val, self.store.state["w"], label.shape[0])
        obj, _ = _loss_dual(self.cfg.loss, label, xw)
        return _progress(obj, xw, label, mask)

    def _predict_step_xla(self, seg, idx, val):
        return spmv(seg, idx, val, self.store.state["w"], self.cfg.minibatch)

    def _train_step_coo(self, sidx, sseg, sval, tmap, first, label, mask):
        cfg = self.cfg
        xw = ck.coo_spmv(self.store.state["w"], sidx, sseg, sval, tmap,
                         first, cfg.minibatch, dtype=self._coo_dtype)
        obj, d = _loss_dual(cfg.loss, label, xw)
        g = ck.coo_spmv_t(d * mask, sidx, sseg, sval, tmap, first,
                          cfg.num_buckets, dtype=self._coo_dtype)
        return _progress(obj, xw, label, mask, self._dense_update(g))

    def _eval_step_coo(self, sidx, sseg, sval, tmap, first, label, mask):
        xw = self._predict_step_coo(sidx, sseg, sval, tmap, first)
        obj, _ = _loss_dual(self.cfg.loss, label, xw)
        return _progress(obj, xw, label, mask)

    def _predict_step_coo(self, sidx, sseg, sval, tmap, first):
        return ck.coo_spmv(self.store.state["w"], sidx, sseg, sval, tmap,
                           first, self.cfg.minibatch, dtype=self._coo_dtype)

    def _xw_mcoo(self, sidx, sseg, sval, tmap, first):
        """This rank's rows of xw (W1 over its cell)."""
        return self._mesh_pull(self.mesh, self.store.state["w"], sidx, sseg,
                               sval, tmap, first, self.cfg.minibatch,
                               dtype=self._coo_dtype)

    def _global_progress(self, xw, label, mask, new_w=None):
        """The progress of the whole global batch, the same on every rank:
        this data shard's xw, label and mask gathered over the data axis
        (one all_reduce), the |w|_0 delta summed over the model axis."""
        xw, label, mask = collectives.gather_rows(
            torch.stack([xw, label, mask], 1), self.mesh,
            DATA_AXIS).unbind(1)
        obj, _ = _loss_dual(self.cfg.loss, label, xw)
        if new_w is not None:
            new_w = collectives.allreduce_sum(new_w.reshape(1), self.mesh,
                                              MODEL_AXIS)[0]
        return _progress(obj, xw, label, mask, new_w)

    def _train_step_mcoo(self, sidx, sseg, sval, tmap, first, label, mask):
        """label and mask: this data shard's rows."""
        cfg = self.cfg
        xw = self._xw_mcoo(sidx, sseg, sval, tmap, first)
        _, d = _loss_dual(cfg.loss, label, xw)
        g = self._mesh_push(self.mesh, d * mask, sidx, sseg, sval, tmap,
                            first, cfg.num_buckets, dtype=self._coo_dtype)
        return self._global_progress(xw, label, mask, self._dense_update(g))

    def _eval_step_mcoo(self, sidx, sseg, sval, tmap, first, label, mask):
        return self._global_progress(
            self._xw_mcoo(sidx, sseg, sval, tmap, first), label, mask)

    def _mesh_margins(self, args):
        return self._predict_step_mcoo(*args[:-2])

    def _predict_step_mcoo(self, sidx, sseg, sval, tmap, first):
        return collectives.gather_rows(
            self._xw_mcoo(sidx, sseg, sval, tmap, first), self.mesh,
            DATA_AXIS)

    def _xw_tcoo(self, uniq, tmap_u, rm_slot, rm_val):
        """Pull over the compact domain: tile_gather of w at the batch's
        unique keys, then a row gather from the compact w (the sentinel
        slot u_cap reads an appended 0.0) and a dense per-row sum."""
        w2 = self.store.state["w"].view(-1, ck.LANES)
        wc = ck.tile_gather(w2, uniq, tmap_u, dtype=self._coo_dtype)
        wz = torch.cat([wc, wc.new_zeros(1)])
        got = wz.index_select(0, rm_slot)
        return (rm_val * got).reshape(self.cfg.minibatch, -1).sum(1)

    def _train_step_tcoo(self, uniq, tmap_u, first_u, last_u, sidx, sseg,
                         sval, tmap, first, rm_slot, rm_val, label, mask):
        cfg = self.cfg
        xw = self._xw_tcoo(uniq, tmap_u, rm_slot, rm_val)
        obj, d = _loss_dual(cfg.loss, label, xw)
        g = ck.coo_spmv_t(d * mask, sidx, sseg, sval, tmap, first,
                          self._compact_cap, dtype=self._coo_dtype)
        # the filter, touched masking and the handle update happen in the
        # kernel, in place at the batch's keys
        _, new_w = scatter_update(
            cfg.algo, self.store.state, g, uniq, tmap_u, first_u, last_u,
            lr_eta=cfg.lr_eta, lr_beta=cfg.lr_beta,
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            fixed_bytes=cfg.fixed_bytes, dtype=self._coo_dtype)
        return _progress(obj, xw, label, mask, new_w)

    def _eval_step_tcoo(self, uniq, tmap_u, rm_slot, rm_val, label, mask):
        xw = self._xw_tcoo(uniq, tmap_u, rm_slot, rm_val)
        obj, _ = _loss_dual(self.cfg.loss, label, xw)
        return _progress(obj, xw, label, mask)

    # -- unique-key compaction ---------------------------------------------
    def ensure_compact(self, idx) -> int:
        """Decide (once, from the first batch) whether the compacted path
        engages. Returns the compact capacity (0 = dense path)."""
        with self._compact_lock:
            if self._compact_cap is None:
                self._compact_cap = self._decide_compact_cap(idx)
        return self._compact_cap

    def _decide_compact_cap(self, idx) -> int:
        """Pick the compact slot capacity from the first batch: 1.5x
        headroom in update blocks over what the batch needs, rounded to
        whole tiles. Engaged only when the compact domain is well under
        the table size (the same rule as the JAX learner)."""
        cfg = self.cfg
        if cfg.compact_cap > 0:
            return -(-cfg.compact_cap // ck.TILE) * ck.TILE
        ids = native.unique(np.asarray(idx, np.int64), self.device)[0]
        blocks = ck.tile_blocks_needed(ids, ck.TILE)
        cand = -(-int(1.5 * blocks) * ck.BLK_U // ck.TILE) * ck.TILE
        if cfg.num_buckets >= 32 * cand:
            return cand
        return 0

    # -- batch plumbing ----------------------------------------------------
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
        """Host-side batch prep (runs in loader threads): pad to the fixed
        shape and, for the kernel paths, sort the COO triples by bucket
        (the Localizer role; the sorts and uniques run on the learner's
        device, the layout around them on the host). Returns an opaque
        prepared batch accepted by stage_batch and
        train/eval/predict_batch."""
        db = self.make_device_batch(blk)
        if self._mesh_coo:
            lo, hi = batch_range(self.mesh, self.cfg.minibatch)
            return self._mesh_prepared(db.seg, db.idx, db.val,
                                       db.label[lo:hi], db.row_mask[lo:hi],
                                       blk.size)
        if not self.use_pallas:
            return ("xla", db, blk.size)
        if self.ensure_compact(db.idx):
            tc = ck.pack_tile_coo(db.idx, db.seg, db.val,
                                  self.cfg.num_buckets, self._compact_cap,
                                  capacity=self.cfg.row_capacity,
                                  rm_rows=self.cfg.minibatch,
                                  rm_width=self.cfg.nnz_per_row,
                                  device=self.device)
            if tc.dropped_nnz:
                _log.warning("compaction overflow: dropped %d unique keys "
                             "(%d nonzeros) — raise compact_cap (currently "
                             "%d)", tc.dropped_uniq, tc.dropped_nnz,
                             self._compact_cap)
            return ("tcoo", tc, db.label, db.row_mask, blk.size)
        p = ck.pack_sorted_coo(db.idx, db.seg, db.val, self.cfg.num_buckets,
                               capacity=self.cfg.row_capacity,
                               device=self.device)
        return ("coo", p, db.label, db.row_mask, blk.size)

    def _mesh_prepared(self, seg, idx, val, label, mask, size: int):
        """The mcoo kind of a global batch's COO triples (seg in the global
        batch's rows) and this data shard's label and mask: this rank's
        cell, tile-packed for the kernels or, for the plain twins, its
        live entries in input order."""
        d, m = self.mesh.coords
        cell, dropped = ck.pack_mesh_cell(
            idx, seg, val, self.cfg.num_buckets, self.cfg.minibatch,
            self.mesh.num_data, self.mesh.num_model, d, m, self._shard_cap,
            device=self.device, tiled=self.use_pallas)
        if dropped:
            _log.warning("mesh cell (%d, %d) overflow: dropped %d "
                         "nonzeros — raise nnz_per_row or mesh_capacity "
                         "slack", d, m, dropped)
        return ("mcoo", cell, label, mask, size)

    def _prepared(self, x):
        # prepared and staged batches are tuples; anything else is a
        # RowBlock-like CSR batch
        if not isinstance(x, tuple):
            x = self.prepare_batch(x)
        return x

    def pack_cache_token(self, train: bool = True):
        """Everything (beyond the raw batch bytes) that decides what
        prepare_batch emits, or None while the compact-path decision is
        still open."""
        if self._compact_cap is None:
            return None
        cfg = self.cfg
        if self._mesh_coo:
            # the JAX package's token, and the cell this rank packs
            return ("linear", self._MESH_PACK_VERSION, self.use_pallas,
                    self._mesh_coo, self._compact_cap, self._shard_cap,
                    cfg.minibatch, cfg.nnz_per_row, cfg.num_buckets,
                    self.mesh.num_data, self.mesh.num_model, ck.TILE,
                    ck.BLK, ck.BLK_U, ck.LANES, *self.mesh.coords)
        return ("linear", self._PACK_VERSION, self.use_pallas,
                self._compact_cap, cfg.minibatch, cfg.nnz_per_row,
                cfg.num_buckets, ck.TILE, ck.BLK, ck.BLK_U, ck.LANES)

    def _dev(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def stage_batch(self, b, train: bool = True):
        """Move a prepared batch's arrays to the device (from a loader
        thread, overlapping the main thread's step). The `train` flag must
        match the consuming step: tcoo ships the COO stream and the
        update-block maps only for training."""
        b = self._prepared(b)
        if b[0] == "staged":
            return b
        kind, size = b[0], b[-1]
        ids = self._touched_ids(b) if (train and self.track_touched) \
            else None
        if kind == "tcoo":
            _, tc, label, mask, _ = b
            arrays = [tc.uniq, tc.tmap_u]
            if train:
                p = tc.coo
                arrays += [tc.first_u, tc.last_u, p.idx, p.seg, p.val,
                           p.tmap, p.first]
            arrays += [tc.rm_slot, tc.rm_val, label, mask]
        elif kind in ("coo", "mcoo"):
            _, p, label, mask, _ = b
            arrays = [p.idx, p.seg, p.val, p.tmap, p.first, label, mask]
        else:
            db = b[1]
            arrays = [db.seg, db.idx, db.val, db.label, db.row_mask]
        return ("staged", kind, tuple(self._dev(*arrays)), size, ids, train)

    # -- sparse PS wire hints ------------------------------------------------
    def _touched_ids(self, b) -> Optional[np.ndarray]:
        """Unique buckets a prepared batch touches, from its host arrays."""
        kind = b[0]
        if kind == "staged":
            return b[4]
        if kind == "xla":
            db = b[1]
            ids = np.unique(db.idx[db.val != 0])
        elif kind == "coo":
            p = b[1]
            ids = np.unique(p.idx[p.val != 0])
        elif kind == "tcoo":
            u = b[1].uniq
            ids = u[u < self.cfg.num_buckets]
        else:  # mcoo holds a cell's local ids; the PS falls back to a scan
            return None
        return ids.astype(np.int64)

    def _note_touched(self, b) -> None:
        with self._touched_lock:
            self._touched.append(self._touched_ids(b))

    def collect_touched(self):
        """Sorted-unique buckets touched since the last call, per table,
        or None if any batch lacked a hint."""
        with self._touched_lock:
            acc = self._touched
            self._touched = []
        if any(a is None for a in acc):
            return None
        u = (np.unique(np.concatenate(acc)) if acc
             else np.empty(0, np.int64))
        return {k: u for k in self.store.state}

    # -- entry points --------------------------------------------------------
    def train_batch(self, blk) -> dict:
        """One training step on a RowBlock, a prepared or a staged batch;
        updates the state tables in place and returns the progress dict."""
        b = self._prepared(blk)
        if self.track_touched:
            self._note_touched(b)
        _, kind, args, _, _, st_train = self.stage_batch(b, train=True)
        if not st_train:
            raise ValueError("batch was staged for eval, not train")
        step = {"xla": self._train_step_xla, "coo": self._train_step_coo,
                "tcoo": self._train_step_tcoo,
                "mcoo": self._train_step_mcoo}[kind]
        return _to_floats(step(*args))

    def eval_batch(self, blk) -> dict:
        _, kind, args, _, _, st_train = self.stage_batch(
            self._prepared(blk), train=False)
        if st_train:
            raise ValueError("batch was staged for train, not eval")
        step = {"xla": self._eval_step_xla, "coo": self._eval_step_coo,
                "tcoo": self._eval_step_tcoo,
                "mcoo": self._eval_step_mcoo}[kind]
        return _to_floats(step(*args))

    def predict_batch(self, blk) -> np.ndarray:
        """Margins (or probabilities with prob_predict) of the batch's
        real rows (all of them, on every rank of a mesh)."""
        _, kind, args, size, _, st_train = self.stage_batch(
            self._prepared(blk), train=False)
        if st_train:
            raise ValueError("batch was staged for train, not predict")
        args = args[:-2]  # no label / mask
        if kind == "tcoo":
            xw = self._xw_tcoo(*args)
        elif kind == "mcoo":
            xw = self._predict_step_mcoo(*args)
        elif kind == "coo":
            xw = self._predict_step_coo(*args)
        else:
            xw = self._predict_step_xla(*args)
        out = xw.cpu().numpy()[:size]
        if self.cfg.prob_predict:
            out = 1.0 / (1.0 + np.exp(-out))
        return out

    def nnz(self) -> int:
        return self.store.nnz("w")
