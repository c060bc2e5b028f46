"""Spherical k-means on one device.

Parity target: reference learn/kmeans/kmeans.cc — Lloyd iterations with
cosine distance: rows are unit-normalized, the assigned points are summed
into a (k x d) matrix with a count per cluster, and centroids are
recomputed by dividing by the counts (kmeans.cc:169-208); init picks k
random rows (:89-106); per-iteration checkpoints bound lost work on
failure (:204). Same config surface, assignment paths and init draws as
the JAX package's models/kmeans.py, so both start from the same
centroids.

An assignment pass takes one minibatch and returns ([k, d] sums, [k]
counts, cost), by one of three paths:
- dense: densify the COO batch into [B, d] with a scatter (index_add_),
  then two products, similarities X_hat C_hat^T and the accumulation
  onehot(assign)^T X_hat (torch.matmul, full f32);
- sparse: per-nonzero gathers of the centroid columns and index_add_,
  never building [B, d] (hashed feature spaces, kmeans.cc:119-130). A
  row's norm sums val^2 over its nonzeros, as the JAX package's does, so
  it equals the dense path's only where a row names each column once;
- packed: the dense path with the densify done by the hand kernel
  coo_spmv_t (csrc/coo_kernels.cu) over a flat (row * stride + col)
  bucket space, d = ones: the batch is packed by bucket on the learner's
  device (pack_batch) and the kernel sums each (row, col)'s values.
The loop takes the packed path for the dense assignment when the
minibatch is a multiple of 128 (the kernel's dual vector), else dense.

Every Lloyd iteration reads the same batches, so with the epoch pack cache
on (data/pack_cache.py: WH_PACK_CACHE, WH_PACK_CACHE_DIR) iterations 2 on
replay each part's prepared batches (the raw DeviceBatch, or the packed
batch and its row mask) instead of parsing and packing them again; with no
knob set every iteration parses and packs, as the JAX package does by
default.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from wormhole_tpu_torch.data import pack_cache as _pc
from wormhole_tpu_torch.data.minibatch import MinibatchIter
from wormhole_tpu_torch.data.rowblock import RowBlock, to_device_batch
from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.ops import coo_kernels as ck
from wormhole_tpu_torch.solver.workload import iter_parts, iter_rowblocks


@dataclasses.dataclass
class KmeansConfig:
    """The JAX package's KmeansConfig: the same keys and defaults."""

    train_data: str = ""
    data_format: str = "libsvm"
    num_clusters: int = 10
    dim: int = 0               # feature-space dim; 0 = discover from data
    max_iter: int = 10
    minibatch: int = 4096
    nnz_per_row: int = 64
    num_parts_per_file: int = 1
    model_out: Optional[str] = None
    checkpoint_dir: Optional[str] = None  # per-iter state for resume
    seed: int = 0
    # the launcher's workers as the ranks of one process group
    # (apps/kmeans.py's global body)
    global_mesh: bool = False
    # assignment: dense ([B, d] densify + two products, for small or
    # moderate d like MNIST-784) | sparse (per-nonzero gathers and
    # scatter-adds, never [B, d]: hashed feature spaces) | auto (sparse
    # when d > 16384)
    assign_kernel: str = "auto"
    # the packed densify's compute type: f32 (nothing rounds) | bf16
    # (values round to bfloat16 on input; sums accumulate in f32)
    kernel_dtype: str = "f32"


def discover_dim(pattern: str, fmt: str = "libsvm",
                 num_parts_per_file: int = 1, device=None) -> int:
    """Max feature id + 1 over all files, parsed on `device` (None: the
    CPU's parser): the Allreduce<Max> dimension discovery of the
    reference BSP apps (kmeans.cc:160, lbfgs.cc:107-113)."""
    max_id = -1
    for blk in iter_rowblocks(pattern, num_parts_per_file, fmt,
                              node="dim-scan", device=device):
        if blk.nnz:
            max_id = max(max_id, int(blk.index.max()))
    return max_id + 1


def _unit_rows(X):
    """Rows scaled to unit norm (zero rows stay zero)."""
    return X / torch.linalg.norm(X, dim=1, keepdim=True).clamp_min(1e-12)


class KmeansLearner:
    #: bump when _prep_db's or pack_batch's output changes for one input
    _PACK_VERSION = 1

    def __init__(self, cfg: KmeansConfig, device=None):
        self.device = resolve_device(device)
        if cfg.dim == 0:
            cfg.dim = discover_dim(cfg.train_data, cfg.data_format,
                                   cfg.num_parts_per_file, self.device)
        if cfg.dim <= 0:
            raise ValueError("empty data: could not discover dim")
        if cfg.assign_kernel not in ("auto", "dense", "sparse"):
            raise ValueError(f"assign_kernel must be auto, dense or sparse, "
                             f"got {cfg.assign_kernel!r}")
        if cfg.kernel_dtype not in ("f32", "bf16"):
            raise ValueError(f"kernel_dtype must be 'f32' or 'bf16', got "
                             f"{cfg.kernel_dtype!r}")
        self.cfg = cfg
        self.centroids: Optional[torch.Tensor] = None  # [k, d]
        self.start_iter = 0

        d, B = cfg.dim, cfg.minibatch
        self._use_sparse = cfg.assign_kernel == "sparse" or (
            cfg.assign_kernel == "auto" and d > 16384)
        # the packed densify's flat bucket space: row r, column c at
        # r * stride + c, rounded up to whole table tiles
        self._flat_stride = -(-d // ck.LANES) * ck.LANES
        self._num_flat = -(-(B * self._flat_stride) // ck.TILE) * ck.TILE
        # the kernel takes a dual vector of a multiple of 128 rows; other
        # batch sizes keep the scatter densify
        self._use_packed = not self._use_sparse and B % ck.LANES == 0
        self._kdt = (torch.bfloat16 if cfg.kernel_dtype == "bf16"
                     else torch.float32)
        self.pack_cache = _pc.from_env()

    # -- assignment -----------------------------------------------------------
    def densify(self, seg, idx, val, mask):
        """COO batch -> row-normalized dense [B, d] (the scatter)."""
        B, d = self.cfg.minibatch, self.cfg.dim
        X = torch.zeros(B * d, dtype=torch.float32, device=val.device)
        X.index_add_(0, seg.long() * d + idx.long(), val)
        return _unit_rows(X.view(B, d) * mask[:, None])

    def _assign_from_dense(self, C, X, mask):
        """([k, d] sums, [k] counts, batch cost) given row-normalized X;
        cosine distance is 1 - X_hat.C_hat."""
        k = self.cfg.num_clusters
        sim = X @ _unit_rows(C).T                          # [B, k]
        best, assign = sim.max(dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)
        onehot = onehot * mask[:, None]
        sums = onehot.T @ X                                # [k, d]
        counts = onehot.sum(dim=0)
        cost = ((1.0 - best) * mask).sum()
        return sums, counts, cost

    def _assign_dense(self, C, seg, idx, val, mask):
        """One assignment pass over a raw COO batch: densify, then the
        two products."""
        return self._assign_from_dense(C, self.densify(seg, idx, val, mask),
                                       mask)

    def _assign_sparse(self, C, seg, idx, val, mask):
        """The same contract without [B, d]: similarities by gathering
        centroid columns per nonzero and summing them per row, sums by
        adding the normalized values into the assigned centroid's row.
        Work O(nnz * k), memory O(k * d)."""
        B, k, d = self.cfg.minibatch, self.cfg.num_clusters, self.cfg.dim
        seg, idx = seg.long(), idx.long()
        Cn = _unit_rows(C)
        sq = torch.zeros(B, dtype=val.dtype, device=val.device)
        sq.index_add_(0, seg, val * val)
        inv_norm = 1.0 / torch.sqrt(sq).clamp_min(1e-12)
        # sim[i, c] = sum_nz val * Cn[c, idx] / ||x_i||
        sim = torch.zeros(B, k, dtype=val.dtype, device=val.device)
        sim.index_add_(0, seg, val[:, None] * Cn.T.index_select(0, idx))
        # padding rows (mask 0) must not attract real similarity
        sim = sim * inv_norm[:, None] * mask[:, None]
        best, assign = sim.max(dim=1)
        xhat_nz = val * (inv_norm * mask).index_select(0, seg)
        sums = torch.zeros(k * d, dtype=val.dtype, device=val.device)
        sums.index_add_(0, assign.index_select(0, seg) * d + idx, xhat_nz)
        counts = torch.zeros(k, dtype=mask.dtype, device=mask.device)
        counts.index_add_(0, assign, mask)
        cost = ((1.0 - best) * mask).sum()
        return sums.view(k, d), counts, cost

    def _assign_packed(self, C, sidx, sseg, sval, tmap, first, mask):
        """The dense path with the densify by coo_spmv_t over the flat
        bucket space of pack_batch (d = ones: each bucket sums its
        (row, col)'s values)."""
        B, d = self.cfg.minibatch, self.cfg.dim
        ones = torch.ones(B, dtype=torch.float32, device=sval.device)
        Xf = ck.coo_spmv_t(ones, sidx, sseg, sval, tmap, first,
                           self._num_flat, dtype=self._kdt)
        X = Xf[: B * self._flat_stride].view(B, self._flat_stride)[:, :d]
        return self._assign_from_dense(C, _unit_rows(X * mask[:, None]),
                                       mask)

    def pack_batch(self, seg, idx, val):
        """The batch packed for the flat-bucket densify, its sorts on the
        learner's device: (idx, seg, val, tmap, first) numpy arrays."""
        flat = (np.asarray(seg, np.int64) * self._flat_stride
                + np.asarray(idx, np.int64))
        cap = self.cfg.minibatch * self.cfg.nnz_per_row
        p = ck.pack_sorted_coo(flat, seg, val, self._num_flat, capacity=cap,
                               device=self.device)
        return (p.idx, p.seg, p.val, p.tmap, p.first)

    # -- data -----------------------------------------------------------------
    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prep_db(self, blk: RowBlock):
        cfg = self.cfg
        if blk.nnz and int(blk.index.max()) >= cfg.dim:
            raise ValueError(
                f"feature id {int(blk.index.max())} >= dim "
                f"{cfg.dim}; set dim=0 to auto-discover")
        return to_device_batch(blk, cfg.minibatch,
                               cfg.minibatch * cfg.nnz_per_row, cfg.dim)

    def _part_key(self, f, mode: str):
        """Every input of a part's prepared batches, beside its bytes."""
        cfg = self.cfg
        return ("kmeans", self._PACK_VERSION, mode, cfg.dim,
                cfg.minibatch, cfg.nnz_per_row, self._flat_stride,
                self._num_flat, ck.TILE, ck.BLK, ck.LANES,
                f.filename, f.part, f.num_parts, cfg.data_format,
                _pc.file_stamp(f.filename))

    def _host_dbs(self, mode: str, prep):
        """`prep` of every minibatch of every part in file order, parsed on
        the learner's device, through the pack cache part by part (the
        plain loop when it is off)."""
        cfg = self.cfg
        for f in iter_parts(cfg.train_data, cfg.num_parts_per_file,
                            cfg.data_format, node="kmeans"):
            def raw(f=f):
                return MinibatchIter(f.filename, f.part, f.num_parts,
                                     f.format, minibatch_size=cfg.minibatch,
                                     device=self.device)
            key = (self._part_key(f, mode)
                   if self.pack_cache is not None else None)
            yield from _pc.iter_part_cached(self.pack_cache, key, raw, prep)

    def _batches(self):
        """(seg, idx, val, mask) of each minibatch, on the device."""
        for db in self._host_dbs("raw", self._prep_db):
            yield (self._put(db.seg), self._put(db.idx), self._put(db.val),
                   self._put(db.row_mask))

    def _batches_packed(self):
        """(packed flat-bucket COO, mask) of each minibatch, on the
        device, for the packed path."""
        def prep(blk):
            db = self._prep_db(blk)
            return (self.pack_batch(db.seg, db.idx, db.val), db.row_mask)

        for pk, mask in self._host_dbs("packed", prep):
            yield tuple(self._put(a) for a in pk), self._put(mask)

    # -- init: random rows (kmeans.cc:89-106) ---------------------------------
    def init_centroids(self) -> None:
        """k rows drawn from the first batches, with the JAX package's
        numpy draws in the same order."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        rows = []
        for b in self._batches():
            seg, idx, val, mask = b
            n_real = int(mask.sum())
            take = min(cfg.num_clusters * 4, n_real)
            if self._use_sparse:
                # huge d: densify only the sampled rows, on the host
                seg, idx, val = (x.cpu().numpy() for x in (seg, idx, val))
                pick = rng.choice(n_real, size=take, replace=False)
                slot = np.full(len(mask), -1, np.int64)
                slot[pick] = np.arange(take)
                keep = (slot[seg] >= 0) & (val != 0)
                X = np.zeros((take, cfg.dim), np.float32)
                X[slot[seg[keep]], idx[keep].astype(np.int64)] = val[keep]
                norm = np.maximum(
                    np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
                rows.append(X / norm)
            else:
                X = self.densify(seg, idx, val, mask).cpu().numpy()
                rows.append(X[rng.choice(n_real, size=take, replace=False)])
            if sum(len(r) for r in rows) >= cfg.num_clusters * 8:
                break
        cand = np.concatenate(rows)
        if len(cand) < cfg.num_clusters:
            # fewer rows than clusters: reuse rows with jitter so every
            # centroid is initialized (empty clusters keep theirs)
            extra = cand[rng.integers(0, len(cand),
                                      cfg.num_clusters - len(cand))]
            extra = extra + 0.01 * rng.standard_normal(extra.shape)
            cand = np.concatenate([cand, extra.astype(cand.dtype)])
        pick = rng.choice(len(cand), size=cfg.num_clusters, replace=False)
        self.centroids = self._put(cand[pick])

    # -- Lloyd loop (kmeans.cc:169-208) ---------------------------------------
    def run(self, verbose: bool = True) -> float:
        """Lloyd iterations from start_iter to max_iter; returns the last
        iteration's mean cosine distance."""
        cfg = self.cfg
        if self.centroids is None and not self._try_resume():
            self.init_centroids()
        k, d = cfg.num_clusters, cfg.dim
        cost = float("nan")
        for it in range(self.start_iter, cfg.max_iter):
            sums = torch.zeros(k, d, dtype=torch.float32, device=self.device)
            counts = torch.zeros(k, dtype=torch.float32, device=self.device)
            cost_acc = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            if self._use_packed:
                batches = ((self._assign_packed, (*pk, mask))
                           for pk, mask in self._batches_packed())
            else:
                fn = (self._assign_sparse if self._use_sparse
                      else self._assign_dense)
                batches = ((fn, b) for b in self._batches())
            for fn, b in batches:
                s, c, co = fn(self.centroids, *b)
                sums, counts = sums + s, counts + c
                cost_acc = cost_acc + co
            # an empty cluster keeps its previous centroid
            self.centroids = torch.where(
                counts[:, None] > 0,
                sums / counts[:, None].clamp_min(1.0), self.centroids)
            cost = float(cost_acc) / max(float(counts.sum()), 1.0)
            if verbose:
                print(f"kmeans iter {it}: mean cosine distance {cost:.6f}",
                      flush=True)
            if cfg.checkpoint_dir:
                self._checkpoint(it)
        if cfg.model_out:
            self.save(cfg.model_out)
        return cost

    # -- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        """Text centroids, one row a line, %.6g (kmeans.cc:212-217)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        C = self.centroids.cpu().numpy()
        with open(path, "w") as f:
            for row in C:
                f.write(" ".join(f"{v:.6g}" for v in row) + "\n")

    def _checkpoint(self, it: int) -> None:
        from wormhole_tpu_torch.utils.checkpoint import atomic_savez

        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        atomic_savez(os.path.join(self.cfg.checkpoint_dir, "state.npz"),
                     centroids=self.centroids.cpu().numpy(),
                     next_iter=it + 1)

    def _try_resume(self) -> bool:
        """LoadCheckPoint parity (kmeans.cc:157-164): resume from the
        checkpoint dir's state.npz (the JAX package's or the port's)."""
        from wormhole_tpu_torch.interop import kmeans_state_from_numpy

        cdir = self.cfg.checkpoint_dir
        if not cdir or not os.path.exists(os.path.join(cdir, "state.npz")):
            return False
        with np.load(os.path.join(cdir, "state.npz")) as st:
            arrays = {k: st[k] for k in st.files}
        self.centroids = kmeans_state_from_numpy(arrays, self.cfg,
                                                 self.device)
        self.start_iter = int(arrays["next_iter"])
        return True
