"""Batch objectives for the L-BFGS solver: linear and FM, on one device
(one rank of a BSP ring holds its own rows' batches, load_batches_bsp; a
rank of a process group its share of every global batch,
load_batches_global).

Parity targets:
- learn/lbfgs-linear (lbfgs.cc, linear.h): logistic regression with the
  bias stored at w[num_feature] (linear.h:91-99), the feature count
  discovered as the max column id over all data (lbfgs.cc:107-113), and
  L1 through the solver's OWL-QN path.
- learn/lbfgs-fm (fm.cc, fm.h): factorization machine with the flat
  parameter layout [w(d); V(d x k); bias] (fm.cc:133-140), V drawn
  N(0, sigma) (fm.cc:141-156), the FM margin (fm.h:84-107).

The dataset is loaded once into fixed-shape batches on the device (the
reference's per-rank RowBlockIter cache). Each objective sums a masked
logistic loss over the batches with plain torch ops (gathers and
index_add_, as the JAX package's XLA segment sums), and writes its
gradient out: the logistic dual r = (softplus'(m) - y) * mask, where
softplus'(m) = exp(m - softplus(m)) as jax.grad takes it, pushed back
through the margin's terms. On one device there is no padding:
num_dim_padded == num_dim, and place() and pad_mask() keep a vector as
it is.

The FM's V is drawn from numpy's default_rng(seed); the JAX package draws
it from jax.random, so the two start from different V unless one is given
the other's (interop.lbfgs_state_from_numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from wormhole_tpu_torch.data.rowblock import to_device_batch
from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.ops.metrics import softplus
from wormhole_tpu_torch.ops.spmv import row_squares, spmm, spmv
from wormhole_tpu_torch.solver.workload import iter_rowblocks

_MAX_ID = 2 ** 31 - 1  # ids index int32 device arrays


def load_batches(pattern: str, fmt: str = "libsvm", minibatch: int = 4096,
                 nnz_per_row: int = 64, num_parts_per_file: int = 1,
                 device=None):
    """Read all data, parsed on `device`, into fixed-shape batches on
    it: returns (batches, num_feature), each batch (seg, idx, val,
    label, mask), with num_feature = max id + 1 over all files
    (the Allreduce<Max> of lbfgs.cc:107-113)."""
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    batches = []
    max_id = -1
    for blk in iter_rowblocks(pattern, num_parts_per_file, fmt, minibatch,
                              device=dev):
        if blk.nnz:
            max_id = max(max_id, int(blk.index.max()))
        # raw column ids, no hash kernel: the batch solvers use the true
        # feature space, as the reference's RowBlockIter path does
        if max_id >= _MAX_ID:
            raise ValueError(f"feature id {max_id}: the batch objectives "
                             f"take ids below 2^31 - 1")
        db = to_device_batch(blk, minibatch, minibatch * nnz_per_row,
                             _MAX_ID)
        batches.append((put(db.seg), put(db.idx), put(db.val),
                        put(db.label), put(db.row_mask)))
    return batches, max_id + 1


def load_batches_bsp(pattern: str, env, client, fmt: str = "libsvm",
                     minibatch: int = 4096, nnz_per_row: int = 64,
                     num_parts_per_file: int = 1, key: str = "lbfgs_dim",
                     device=None):
    """The BSP-ring variant of load_batches: this rank's stable slice of
    the file parts (parallel/multihost.py rank_parts), parsed on `device`
    into batches on it. Parameters are replicated per rank and the solver
    reduces gradients and losses over the ring. The global feature count
    (the Allreduce<Max> of lbfgs.cc:107-113) is agreed through the
    scheduler's blob channel (`{key}_{rank}`, then `key`): blobs persist,
    so a respawned worker re-reads the same value without consuming a
    collective counter, and its (version, seq) sequence stays aligned
    with the survivors'. A rank with no parts holds no batches."""
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.parallel import multihost as mh

    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    batches, max_id = [], -1
    for f, k in mh.rank_parts(pattern, num_parts_per_file, env):
        for blk in MinibatchIter(f, k, num_parts_per_file, fmt,
                                 minibatch_size=minibatch, device=dev):
            if blk.nnz:
                max_id = max(max_id, int(blk.index.max()))
            if max_id >= _MAX_ID:
                raise ValueError(f"feature id {max_id}: the batch "
                                 f"objectives take ids below 2^31 - 1")
            db = to_device_batch(blk, minibatch, minibatch * nnz_per_row,
                                 _MAX_ID)
            batches.append((put(db.seg), put(db.idx), put(db.val),
                            put(db.label), put(db.row_mask)))
    client.blob_put(f"{key}_{env.rank}", np.int64(max_id))
    if env.rank == 0 and not client.call(op="blob_get", key=key)["ok"]:
        dims = [int(client.blob_get(f"{key}_{r}", timeout=120))
                for r in range(env.num_workers)]
        client.blob_put(key, np.int64(max(dims)))
    return batches, int(client.blob_get(key, timeout=120)) + 1


def load_batches_global(pattern: str, env, fmt: str = "libsvm",
                        minibatch: int = 4096, nnz_per_row: int = 64,
                        num_parts_per_file: int = 1, device=None):
    """The process-group variant of load_batches (the global mesh's, or
    torch.distributed.run's; the group must be up): each rank reads its
    rank slice of the file parts (the reference RowBlockIter(rank, world)
    split, lbfgs.cc:229-234) in minibatch / num_workers rows a batch, the
    rows it contributes to each global batch, and pads with masked empty
    batches to the global batch count, so every rank evaluates the same
    number of batches in lockstep. num_feature is the global max id + 1
    (global_scalar_max, the Allreduce<Max> of lbfgs.cc:107-113)."""
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.parallel import multihost as mh

    nproc = env.num_workers
    if minibatch % nproc:
        raise ValueError(f"minibatch {minibatch} must divide over {nproc} "
                         f"ranks")
    local_rows = minibatch // nproc
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    local, max_id = [], -1
    for f, k in mh.rank_parts(pattern, num_parts_per_file, env):
        for blk in MinibatchIter(f, k, num_parts_per_file, fmt,
                                 minibatch_size=local_rows, device=dev):
            if blk.nnz:
                max_id = max(max_id, int(blk.index.max()))
            local.append(blk)
    if max_id >= _MAX_ID:
        raise ValueError(f"feature id {max_id}: the batch objectives take "
                         f"ids below 2^31 - 1")
    n_batches = mh.global_scalar_max(len(local))
    num_feature = mh.global_scalar_max(max_id) + 1
    empty = mh.empty_rowblock()
    out = []
    for i in range(n_batches):
        db = to_device_batch(local[i] if i < len(local) else empty,
                             local_rows, local_rows * nnz_per_row, _MAX_ID)
        # local row ids: a rank evaluates its own rows of each global
        # batch, and the solver sums the ranks' losses and gradients
        out.append((put(db.seg), put(db.idx), put(db.val), put(db.label),
                    put(db.row_mask)))
    return out, num_feature


def _dual(margin, label, mask):
    """(masked logistic loss summed, d loss / d margin)."""
    sp = softplus(margin)
    loss = ((sp - label * margin) * mask).sum()
    return loss, (torch.exp(margin - sp) - label) * mask


class _BatchObjBase:
    """Accumulate-over-batches eval and grad on one device. A subclass
    gives num_dim, _margin and _batch_grad."""

    def __init__(self, batches, device=None):
        self.batches = batches
        self.device = (batches[0][0].device if batches
                       else resolve_device(device))
        self.num_dim_padded = self.num_dim

    def _batch_loss(self, p, seg, idx, val, label, mask):
        margin = self._margin(p, seg, idx, val, label.shape[0])
        return _dual(margin, label, mask)[0]

    def eval(self, p) -> float:
        """Sum of the data loss over all batches (one host sync)."""
        tot = torch.zeros((), dtype=p.dtype, device=p.device)
        for b in self.batches:
            tot = tot + self._batch_loss(p, *b)
        return float(tot)

    def grad(self, p):
        """Gradient of the data loss, on the device."""
        g = torch.zeros_like(p)
        for b in self.batches:
            g += self._batch_grad(p, *b)
        return g

    def place(self, p):
        """A parameter vector as this objective's f32 tensor."""
        if isinstance(p, torch.Tensor):
            return p.to(self.device, torch.float32)
        return torch.from_numpy(np.array(p, dtype=np.float32)).to(
            self.device)

    def pad_mask(self, m):
        """A logical-length mask; one device adds no padding."""
        return m


class LinearObjFunction(_BatchObjBase):
    """Logistic regression, layout [w(d); bias]."""

    def __init__(self, batches, num_feature: int, device=None):
        self.num_feature = num_feature
        self.num_dim = num_feature + 1
        super().__init__(batches, device)

    def _margin(self, p, seg, idx, val, num_rows: int):
        w, bias = p[: self.num_feature], p[self.num_feature]
        return spmv(seg, idx, val.to(p.dtype), w, num_rows) + bias

    def _batch_grad(self, p, seg, idx, val, label, mask):
        val = val.to(p.dtype)
        margin = self._margin(p, seg, idx, val, label.shape[0])
        _, r = _dual(margin, label.to(p.dtype), mask.to(p.dtype))
        g = torch.zeros_like(p)
        g[: self.num_feature].index_add_(0, idx, val * r.index_select(0, seg))
        g[self.num_feature] = r.sum()
        return g

    def init_model(self):
        return torch.zeros(self.num_dim, dtype=torch.float32,
                           device=self.device)

    def l1_mask(self):
        m = torch.ones(self.num_dim, dtype=torch.float32, device=self.device)
        m[self.num_feature] = 0.0  # no L1 on the bias
        return self.pad_mask(m)

    def predict(self, p, seg, idx, val, num_rows: int):
        return self._margin(p, seg, idx, val, num_rows)


class FmObjFunction(_BatchObjBase):
    """FM, flat layout [w(d); V(d x k); bias] (fm.cc:133-140)."""

    def __init__(self, batches, num_feature: int, dim_k: int, device=None,
                 init_scale: float = 0.01, seed: int = 0):
        self.num_feature = num_feature
        self.k = dim_k
        self.num_dim = num_feature * (1 + dim_k) + 1
        self.init_scale = init_scale
        self.seed = seed
        super().__init__(batches, device)

    def _split(self, p):
        d, k = self.num_feature, self.k
        # the bias lives at its layout slot, not p[-1]
        return p[:d], p[d: d + d * k].view(d, k), p[d + d * k]

    def _parts(self, p, seg, idx, val, num_rows: int):
        """(margin, xv): xv = X V, kept for the gradient."""
        w, V, bias = self._split(p)
        xw = spmv(seg, idx, val, w, num_rows)
        xv = spmm(seg, idx, val, V, num_rows)
        x2v2 = row_squares(seg, idx, val, V, num_rows)
        return xw + 0.5 * (xv * xv - x2v2).sum(dim=-1) + bias, xv

    def _margin(self, p, seg, idx, val, num_rows: int):
        return self._parts(p, seg, idx, val.to(p.dtype), num_rows)[0]

    def _batch_grad(self, p, seg, idx, val, label, mask):
        d, k = self.num_feature, self.k
        val = val.to(p.dtype)
        margin, xv = self._parts(p, seg, idx, val, label.shape[0])
        _, r = _dual(margin, label.to(p.dtype), mask.to(p.dtype))
        V = self._split(p)[1]
        rs = r.index_select(0, seg)
        g = torch.zeros_like(p)
        g[:d].index_add_(0, idx, val * rs)
        # d margin / d V[j] = val (xv_row - val V[j])
        dV = (rs * val)[:, None] * (xv.index_select(0, seg)
                                    - val[:, None] * V.index_select(0, idx))
        g[d: d + d * k].view(d, k).index_add_(0, idx, dV)
        g[d + d * k] = r.sum()
        return g

    def init_model(self):
        d, k = self.num_feature, self.k
        V = self.init_scale * np.random.default_rng(self.seed).standard_normal(
            d * k)
        p = np.concatenate([np.zeros(d), V, np.zeros(1)]).astype(np.float32)
        return self.place(p)

    def l1_mask(self):
        # L1 only on the linear weights; V and the bias take L2 alone
        m = torch.zeros(self.num_dim, dtype=torch.float32, device=self.device)
        m[: self.num_feature] = 1.0
        return self.pad_mask(m)

    def predict(self, p, seg, idx, val, num_rows: int):
        return self._margin(p, seg, idx, val, num_rows)
