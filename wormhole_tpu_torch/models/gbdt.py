"""Histogram gradient-boosted decision trees, on one device or with rows
sharded over the data axis of a mesh.

Parity target: the reference's distributed xgboost build (`bin/xgboost.dmlc`
run over rabit with row-split data, learn/xgboost/mushroom.hadoop.conf)
and the JAX package's models/gbdt.py, whose conf surface, tree layout and
model file this module keeps: booster=gbtree, objective=binary:logistic
(or reg:squarederror), eta, gamma, min_child_weight, max_depth, num_round,
save_period, eval_train, dsplit=row, plus lambda (leaf L2) and max_bin.

Design:
- features are quantile-binned once on the host into a dense uint8 matrix
  [rows, features], which lives on the learner's device;
- tree growth is depth-wise: each level builds the (node, feature, bin)
  gradient/hessian histograms (`ops/hist.level_hist`: the hand-written
  kernel on the card), scans cumulative G/H over bins to score every
  candidate split at once (gain = 1/2[GL^2/(HL+l) + GR^2/(HR+l) -
  G^2/(H+l)] - gamma) and routes rows to children, all with fixed shapes;
- trees are heap-indexed arrays (split_feat/split_bin/is_split/leaf_value);
  prediction walks them with gathers, round by round.

What the JAX package fuses into one program per round runs here as plain
torch ops around the kernel, level by level. Its one-hot matmul lookups
(`_tree_lookup`, `_binned_at`) are plain gathers here: `table[node]` and
`binned.gather(1, ...)`. On one device rows need no padding and a level's
statistics are already those of all the data unless `reducer` is set. On a
mesh (parallel/mesh.py; data axis only) every rank reads all the data and
keeps its own rows, padded to a multiple of the data axis as the JAX
package pads them; each level's statistics block is summed over the data
axis by `mesh_level_hist` (the last level's totals in f64, before they
round), so every rank grows the same trees; metrics and predictions gather
the margins of all rows.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch

from wormhole_tpu_torch.data.rowblock import RowBlock
from wormhole_tpu_torch.ops import metrics as M
from wormhole_tpu_torch.ops.hist import (level_hist, level_hist_plain,
                                         level_totals, mesh_level_hist,
                                         mesh_level_hist_plain)
from wormhole_tpu_torch.parallel import collectives
from wormhole_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, batch_range,
                                              single_device_mesh)
from wormhole_tpu_torch.solver.workload import iter_rowblocks
from wormhole_tpu_torch.utils.checkpoint import atomic_savez


@dataclasses.dataclass
class GbdtConfig:
    """mushroom.hadoop.conf surface (names kept; `lambda` -> reg_lambda)."""

    train_data: str = ""
    eval_data: Optional[str] = None   # conf key eval[<name>] = path
    eval_name: str = "test"
    data_format: str = "libsvm"
    model_out: Optional[str] = None
    model_in: Optional[str] = None
    # xgboost CLI task surface: task=pred + test:data + name_pred
    task: str = "train"
    test_data: Optional[str] = None
    pred_out: str = "pred.txt"

    booster: str = "gbtree"
    objective: str = "binary:logistic"   # or reg:squarederror
    eta: float = 0.3
    gamma: float = 0.0
    min_child_weight: float = 1.0
    max_depth: int = 6
    reg_lambda: float = 1.0              # xgboost `lambda`
    num_round: int = 10
    save_period: int = 0
    eval_train: int = 0
    dsplit: str = "row"                  # only row split is supported
    base_score: float = 0.5

    # the global mesh (the launcher's workers as the ranks of one
    # process group) and BSP mode (apps/gbdt.py, bsp=1 or global_mesh=1
    # under the launcher)
    global_mesh: bool = False
    bsp: bool = False
    max_bin: int = 256
    dim: int = 0        # feature count; 0 = discover from data
    minibatch: int = 65536  # streaming-load chunk size
    num_parts_per_file: int = 1
    seed: int = 0
    # histogram path: mxu (the hand-written kernel, ops/hist.py; the name
    # is the JAX package's conf value and names the kernel path, not the
    # hardware) | xla (the plain scatter, index_add_) | auto (the kernel
    # for a learner on CUDA, the plain path on the CPU)
    hist_kernel: str = "auto"


# ---------------------------------------------------------------------------
# host-side dataset loading + quantile binning
# ---------------------------------------------------------------------------

_SKETCH_ROWS = 1 << 17  # quantile-sketch sample cap (approx sketch parity)
_TOTALS_WAYS = 64       # accumulators per node of the last level's totals


class Reservoir:
    """Uniform reservoir of sparse rows over any RowBlock stream (rows
    kept as (index, value) pairs so no dense matrix exists before the
    feature count is known); tracks the running max feature id."""

    def __init__(self, cap: int, seed: int):
        self.cap = max(int(cap), 1)
        self.rng = np.random.default_rng(seed)
        self.sample: list = []
        self.n_seen = 0
        self.max_feat = -1

    def add_block(self, blk: RowBlock) -> None:
        if blk.nnz:
            self.max_feat = max(self.max_feat, int(blk.index.max()))
        vals = blk.values_or_ones()
        for r in range(blk.size):
            lo, hi = blk.offset[r], blk.offset[r + 1]
            row = (blk.index[lo:hi].copy(), vals[lo:hi].copy())
            if len(self.sample) < self.cap:
                self.sample.append(row)
            else:
                # classic reservoir: keep each new row with prob cap/n
                j = self.rng.integers(0, self.n_seen + 1)
                if j < self.cap:
                    self.sample[j] = row
            self.n_seen += 1


def _reservoir_sample(pattern: str, fmt: str, num_parts_per_file: int,
                      minibatch: int, seed: int,
                      cap: int = _SKETCH_ROWS, device=None):
    """One streaming pass: reservoir-sample up to `cap` rows and discover
    the feature dimension, without materializing the dataset. The text
    is parsed on `device`."""
    res = Reservoir(cap, seed)
    for blk in iter_rowblocks(pattern, num_parts_per_file, fmt,
                              minibatch, node="gbdt-sketch", seed=seed,
                              device=device):
        res.add_block(blk)
    if res.n_seen == 0:
        raise ValueError(f"no rows in {pattern}")
    return res.sample, res.n_seen, res.max_feat


def _densify_sample(sample, dim: int) -> np.ndarray:
    X = np.zeros((len(sample), dim), np.float32)
    for r, (idx, val) in enumerate(sample):
        keep = idx < dim
        X[r, idx[keep].astype(np.int64)] = val[keep]
    return X


def _densify(blk: RowBlock, dim: int) -> np.ndarray:
    """Sparse CSR rows -> dense [n, dim] float32 (absent feature = 0,
    matching xgboost's default missing=0 treatment for libsvm data)."""
    n = blk.size
    X = np.zeros((n, dim), np.float32)
    rows = np.repeat(np.arange(n), np.diff(blk.offset).astype(np.int64))
    cols = blk.index.astype(np.int64)
    keep = cols < dim
    X[rows[keep], cols[keep]] = blk.values_or_ones()[keep]
    return X


def quantile_edges(X: np.ndarray, max_bin: int) -> np.ndarray:
    """Per-feature cut points, [dim, max_bin-1], padded with +inf.

    bin(x) = searchsorted(edges, x, 'right'); few distinct values get
    midpoint cuts, many get quantile cuts (the histogram/approx sketch of
    xgboost, computed on a host sample)."""
    dim = X.shape[1]
    edges = np.full((dim, max_bin - 1), np.inf, np.float32)
    for f in range(dim):
        col = X[:, f]
        uniq = np.unique(col)
        if len(uniq) <= 1:
            continue
        if len(uniq) <= max_bin:
            cuts = (uniq[:-1] + uniq[1:]) / 2.0
        else:
            qs = np.quantile(col, np.linspace(0, 1, max_bin + 1)[1:-1])
            cuts = np.unique(qs.astype(np.float32))
        edges[f, : len(cuts)] = cuts
    return edges


def bin_matrix(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Apply cut points -> uint8 bins [n, dim]."""
    n, dim = X.shape
    out = np.empty((n, dim), np.uint8)
    for f in range(dim):
        e = edges[f]
        e = e[np.isfinite(e)]
        out[:, f] = np.searchsorted(e, X[:, f], side="right").astype(np.uint8)
    return out


@dataclasses.dataclass
class BinnedDataset:
    """Binned dataset on the learner's device."""

    binned: torch.Tensor   # uint8 [N, dim]  (this rank's rows on a mesh)
    label: torch.Tensor    # float32 [N]
    mask: torch.Tensor     # float32 [N]  (0 for rows that do not count)
    num_real: int          # real rows of the whole dataset
    sharded: bool = False  # rows split over the data axis of a mesh


# ---------------------------------------------------------------------------
# learner
# ---------------------------------------------------------------------------


class GbdtLearner:
    """Depth-wise histogram GBDT over a row matrix on one device, or over
    row shards on the data axis of a mesh."""

    def __init__(self, cfg: GbdtConfig, device=None,
                 mesh: Optional[Mesh] = None):
        if cfg.booster != "gbtree":
            raise NotImplementedError(
                f"booster={cfg.booster!r}: only gbtree; for gblinear use "
                "wormhole_tpu_torch.models.linear (the reference's gblinear "
                "is a distributed linear model)")
        if cfg.dsplit != "row":
            raise NotImplementedError("only dsplit=row (the reference "
                                      "mushroom.hadoop.conf:36 setting)")
        if cfg.hist_kernel not in ("auto", "mxu", "xla"):
            raise ValueError(f"hist_kernel={cfg.hist_kernel!r}: expected "
                             "auto, mxu or xla")
        if not 2 <= cfg.max_bin <= 256:
            raise ValueError(f"max_bin={cfg.max_bin}: bins are uint8, so "
                             "2 <= max_bin <= 256")
        self.cfg = cfg
        if mesh is not None and mesh.num_model != 1:
            raise ValueError("GBDT shards rows only: the mesh needs a model "
                             "axis of 1")
        if mesh is not None and device is not None and \
                torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh if mesh is not None else single_device_mesh(device)
        self.device = self.mesh.device
        # collectives run wherever the mesh has a process group
        self._on_mesh = self.mesh.device_mesh is not None
        # the user-requested boosting rounds; cfg.num_round later becomes
        # the running total when continuing from model_in, so repeated
        # fit() calls must not compound it
        self._requested_rounds = cfg.num_round
        self.edges: Optional[np.ndarray] = None   # [dim, max_bin-1]
        # stacked per-round trees, each [T] where T = 2^(max_depth+1)-1
        self.trees: dict[str, np.ndarray] = _empty_trees(cfg)
        # optional host allreduce over a worker ring (BSP mode): a
        # callable f(np.ndarray) -> np.ndarray summing over all ranks.
        # When set, fit_prepared passes every level's statistics block
        # and the eval metric sums through it, as numpy arrays, instead
        # of assuming this device holds all the data.
        self.reducer = None

    # -- data ---------------------------------------------------------------
    def _dataset(self, binned: np.ndarray, label: np.ndarray,
                 shard: bool = True) -> BinnedDataset:
        """The dataset of all rows `binned`, `label` on the device; on a
        mesh (with `shard`) only this rank's rows, after padding the rows
        to a multiple of the data axis with zero rows of mask 0."""
        n = binned.shape[0]
        mask = np.ones(n, np.float32)
        label = np.asarray(label, np.float32)
        shard = shard and self._on_mesh
        if shard:
            pad = (-n) % self.mesh.num_data
            if pad:
                binned = np.concatenate(
                    [binned, np.zeros((pad, binned.shape[1]), np.uint8)])
                label = np.concatenate([label, np.zeros(pad, np.float32)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            lo, hi = batch_range(self.mesh, n + pad)
            binned, label, mask = (np.array(a[lo:hi])
                                   for a in (binned, label, mask))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return BinnedDataset(binned=dev(binned), label=dev(label),
                             mask=dev(mask), num_real=n, sharded=shard)

    def load_dataset(self, pattern: str, fit_bins: bool = False) -> BinnedDataset:
        """Stream the dataset into uint8 bins on the device in bounded
        host memory: a sketch pass (reservoir sample -> quantile edges,
        discovering dim by running max) followed by a binning pass that
        densifies one chunk at a time. The full dataset never exists on
        the host as either CSR or float, only as the uint8 bin matrix
        that goes to the device. Both passes parse on the learner's
        device. On a mesh every rank reads all rows (so every rank draws
        the same sketch and the same bin edges) and keeps its own."""
        cfg = self.cfg
        if fit_bins or self.edges is None:
            sample, _, max_feat = _reservoir_sample(
                pattern, cfg.data_format, cfg.num_parts_per_file,
                cfg.minibatch, cfg.seed, device=self.device)
            if cfg.dim == 0:
                cfg.dim = max(max_feat + 1, 1)
            self.edges = quantile_edges(_densify_sample(sample, cfg.dim),
                                        cfg.max_bin)
            del sample
        # binning pass: one float chunk at a time
        chunks, labels = [], []
        for blk in iter_rowblocks(pattern, cfg.num_parts_per_file,
                                  cfg.data_format, cfg.minibatch,
                                  node="gbdt-load", device=self.device):
            chunks.append(bin_matrix(_densify(blk, cfg.dim), self.edges))
            labels.append(blk.label.astype(np.float32))
        if not chunks:
            raise ValueError(f"no rows in {pattern}")
        return self._dataset(np.concatenate(chunks), np.concatenate(labels))

    # -- objective ----------------------------------------------------------
    def _grad_hess(self, margin, label, mask):
        obj = self.cfg.objective
        if obj == "binary:logistic":
            p = torch.sigmoid(margin)
            return ((p - label) * mask,
                    torch.clamp(p * (1 - p), min=1e-16) * mask)
        if obj in ("reg:squarederror", "reg:linear"):
            return (margin - label) * mask, mask
        raise NotImplementedError(f"objective={obj!r}")

    def _base_margin(self):
        if self.cfg.objective == "binary:logistic":
            s = min(max(self.cfg.base_score, 1e-6), 1 - 1e-6)
            return float(np.log(s / (1 - s)))
        return float(self.cfg.base_score)

    # -- one tree level -----------------------------------------------------
    def _use_kernel(self) -> bool:
        hk = self.cfg.hist_kernel
        return hk == "mxu" or (hk == "auto" and self.device.type == "cuda")

    def _level_parts(self, num_nodes: int, offset: int, last: bool):
        """The two halves of one tree level.

        `hist_part` produces the level's stacked [G, H] statistics block
        of this device's rows and `apply_part` consumes such a block to
        subtract siblings, score splits and route rows. `_round` calls
        one after the other; with `reducer` set the block passes through
        it in between (the rabit::Allreduce of gradient histograms)."""
        cfg = self.cfg
        F, B = cfg.dim, cfg.max_bin
        lam, gam, mcw, eta = (cfg.reg_lambda, cfg.gamma,
                              cfg.min_child_weight, cfg.eta)
        if self._on_mesh:
            hist = (mesh_level_hist if self._use_kernel()
                    else mesh_level_hist_plain)
            hist = functools.partial(hist, self.mesh)
        else:
            hist = level_hist if self._use_kernel() else level_hist_plain
        # sibling subtraction (xgboost's classic halving): levels past
        # the root accumulate only the LEFT child of every split pair and
        # derive the right child as parent - left. Rows of a NON-splitting
        # parent are active in neither child, so its "right child" slot
        # derives to the parent's own histogram: garbage, but unreachable,
        # because routing only ever descends into children of split nodes.
        sibling = num_nodes > 1
        hist_nodes = num_nodes // 2 if sibling else num_nodes

        def totals(g, h, relh):
            """Per-pair (sum g, sum h): the LAST level needs only node
            totals for leaf values, so the full (F, B) histogram pass is
            skipped. Rows outside the level carry relh == hist_nodes. The
            sums are taken as ops/hist.py level_totals takes them: exact
            int64 sums in the level_hist kernel's fixed point, to f64,
            rounded to f32 once, so they have the same bits in any order
            of the rows, on the card too. The right child's total is
            parent - left, and an f32 running sum over a node's rows would
            leave that difference a few 1e-5 off. On a mesh the f64 sums
            are summed over the data axis before they round."""
            acc = level_totals(g, h, relh, hist_nodes, ways=_TOTALS_WAYS)
            if self._on_mesh:
                collectives.allreduce_sum(acc, self.mesh, DATA_AXIS)
            return acc.t().float().contiguous()  # [2, hist_nodes]

        def hist_part(binned, g, h, node, active):
            """This device's [2, ...] stacked G/H statistics for the
            level: the unit a worker ring sums. Its shape depends only on
            (num_nodes, F, B), never on the row count."""
            rel = torch.where(active, node - offset,
                              torch.full_like(node, num_nodes))
            if sibling:
                # accumulate left children only (even rel -> pair id)
                relh = torch.where(
                    active & (rel % 2 == 0),
                    torch.div(rel, 2, rounding_mode="floor"),
                    torch.full_like(rel, hist_nodes))
                if last:
                    return totals(g, h, relh)           # [2, hist_nodes]
                return torch.stack(hist(binned, g, h, relh, hist_nodes, B))
            return torch.stack(hist(binned, g, h, rel, num_nodes, B))

        def apply_part(stat, binned, node, active, trees, Gp, Hp):
            """Consume the (summed) statistics block: sibling subtraction,
            split scoring, row routing. Writes the level's slice of
            `trees` in place."""
            sl = slice(offset, offset + num_nodes)
            if sibling and last:
                Gt_l, Ht_l = stat[0], stat[1]
                Gt_p = Gp[:, 0, :].sum(-1)
                Ht_p = Hp[:, 0, :].sum(-1)
                Gt = torch.stack([Gt_l, Gt_p - Gt_l], 1).reshape(num_nodes)
                Ht = torch.stack([Ht_l, Ht_p - Ht_l], 1).reshape(num_nodes)
                trees["leaf_value"][sl] = -Gt / (Ht + lam) * eta
                return node, torch.zeros_like(active), Gp, Hp
            if sibling:
                Gl, Hl = stat[0], stat[1]
                G = torch.stack([Gl, Gp - Gl], dim=1).reshape(num_nodes, F, B)
                H = torch.stack([Hl, Hp - Hl], dim=1).reshape(num_nodes, F, B)
            else:
                G, H = stat[0], stat[1]
            Gt, Ht = G[:, 0, :].sum(-1), H[:, 0, :].sum(-1)   # node totals
            leaf = -Gt / (Ht + lam) * eta
            if last:
                trees["leaf_value"][sl] = leaf
                return node, torch.zeros_like(active), G, H
            # candidate splits: left = bins <= b (cumulative), right = rest
            GL = torch.cumsum(G, dim=2)
            HL = torch.cumsum(H, dim=2)
            GR, HR = Gt[:, None, None] - GL, Ht[:, None, None] - HL
            gain = 0.5 * (GL * GL / (HL + lam) + GR * GR / (HR + lam)
                          - (Gt * Gt / (Ht + lam))[:, None, None]) - gam
            ok = (HL >= mcw) & (HR >= mcw)
            ok = ok & (torch.arange(B, device=G.device) < B - 1)[None, None, :]
            gain = torch.where(ok, gain, torch.full_like(gain, -torch.inf))
            flat_gain = gain.reshape(num_nodes, F * B)
            best = torch.argmax(flat_gain, dim=1)
            best_gain = flat_gain.gather(1, best[:, None])[:, 0]
            do_split = best_gain > 0.0
            trees["split_feat"][sl] = torch.div(
                best, B, rounding_mode="floor").to(torch.int32)
            trees["split_bin"][sl] = (best % B).to(torch.int32)
            trees["is_split"][sl] = do_split
            trees["leaf_value"][sl] = torch.where(
                do_split, torch.zeros_like(leaf), leaf)
            # route rows into children
            isp = trees["is_split"].index_select(0, node)
            bv = _binned_at(binned, trees["split_feat"].index_select(0, node))
            thr = trees["split_bin"].index_select(0, node)
            splitting = isp & active
            node = torch.where(splitting,
                               2 * node + 1 + (bv > thr).to(torch.int32),
                               node)
            return node, splitting, G, H

        return hist_part, apply_part

    # -- boosting -----------------------------------------------------------
    def _round(self, train: BinnedDataset, margin):
        """One boosting round: grad/hess, every tree level, the margin
        update. Returns (tree, node, margin): the round's tree as device
        tensors, each row's final node, and the updated margins. With
        `reducer` set, each level's statistics block hops to the host and
        sums over all ranks in between its halves; the ring fixes its
        accumulation order, so every rank consumes identical blocks and
        grows identical trees."""
        cfg = self.cfg
        T = 2 ** (cfg.max_depth + 1) - 1
        dev = train.label.device
        g, h = self._grad_hess(margin, train.label, train.mask)
        trees = {
            "split_feat": torch.zeros(T, dtype=torch.int32, device=dev),
            "split_bin": torch.zeros(T, dtype=torch.int32, device=dev),
            "is_split": torch.zeros(T, dtype=torch.bool, device=dev),
            "leaf_value": torch.zeros(T, dtype=torch.float32, device=dev),
        }
        node = torch.zeros(train.label.shape, dtype=torch.int32, device=dev)
        active = train.mask > 0
        # parent histograms thread level-to-level for the sibling
        # subtraction (level 0 ignores the zero placeholder)
        F, B = cfg.dim, cfg.max_bin
        Gp = torch.zeros(1, F, B, dtype=torch.float32, device=dev)
        Hp = torch.zeros(1, F, B, dtype=torch.float32, device=dev)
        for d in range(cfg.max_depth + 1):
            hp, ap = self._level_parts(2 ** d, 2 ** d - 1,
                                       last=(d == cfg.max_depth))
            stat = hp(train.binned, g, h, node, active)
            if self.reducer is not None:
                stat = torch.from_numpy(np.ascontiguousarray(
                    self.reducer(stat.cpu().numpy()))).to(dev)
            node, active, Gp, Hp = ap(stat, train.binned, node, active,
                                      trees, Gp, Hp)
        margin2 = margin + trees["leaf_value"].index_select(0, node)
        return trees, node, margin2

    def _metric_sums(self, margin, label, mask):
        """Metric SUM vector of this device's rows: the sum-decomposable
        form that can ride the same allreduce as the histograms."""
        if self.cfg.objective == "binary:logistic":
            pred = (margin > 0).to(torch.float32)
            err = torch.sum(mask * torch.abs(pred - label))
            ll = torch.sum(mask * (label * M.softplus(-margin)
                                   + (1.0 - label) * M.softplus(margin)))
            return torch.stack([err, ll, torch.sum(mask)])
        sq = torch.sum(mask * (margin - label) ** 2)
        return torch.stack([sq, torch.sum(mask)])

    def _metrics_reduced(self, margin, ds: BinnedDataset) -> dict:
        """Distributed eval metrics: reduce per-rank sum vectors through
        `reducer`, finish the division on the host. AUC is skipped: it
        needs a global rank ordering of predictions and is not
        sum-decomposable over row shards."""
        s = self.reducer(
            self._metric_sums(margin, ds.label, ds.mask).cpu().numpy())
        if self.cfg.objective == "binary:logistic":
            n = max(float(s[2]), 1.0)
            return {"error": float(s[0]) / n, "logloss": float(s[1]) / n}
        n = max(float(s[1]), 1.0)
        return {"rmse": float(np.sqrt(float(s[0]) / n))}

    def _base_margins(self, ds: BinnedDataset):
        return torch.full(ds.label.shape, self._base_margin(),
                          dtype=torch.float32, device=ds.label.device)

    def fit(self, verbose: bool = True) -> dict:
        """The boosting loop; prints `[round] name-metric:value` rows like
        the reference xgboost CLI. With model_in, continues boosting on
        top of the loaded trees (cfg.num_round more rounds), replaying
        the prior trees into the margins first."""
        cfg = self.cfg
        extra = self._requested_rounds
        r0 = 0
        if cfg.model_in:
            self.load(cfg.model_in)  # sets edges/dim/max_depth/objective
            r0 = cfg.num_round
            cfg.num_round = r0 + extra
        train = self.load_dataset(cfg.train_data, fit_bins=(r0 == 0))
        evals = []
        if cfg.eval_data:
            evals.append((cfg.eval_name, self.load_dataset(cfg.eval_data)))
        if cfg.eval_train:
            evals.append(("train", train))
        return self.fit_prepared(train, evals, r0=r0, verbose=verbose)

    def fit_prepared(self, train: BinnedDataset, evals, r0: int = 0,
                     verbose: bool = True, on_round=None) -> dict:
        """The boosting loop over already-loaded datasets. Rounds below
        `r0` are replayed from `self.trees` into the margins (warm start).
        With `self.reducer` set the per-level blocks and metric sums
        reduce through it; `on_round(r)` fires after round r's trees and
        metrics land (a BSP app's checkpoint hook: every collective of
        round r completes before it)."""
        cfg = self.cfg
        prior = self.trees
        self.trees = _empty_trees(cfg)
        for k in self.trees:
            self.trees[k][:r0] = prior[k][:r0]
        margin = self._base_margins(train)
        margins = {name: self._base_margins(ds)
                   for name, ds in evals if ds is not train}
        for r in range(r0):  # replay loaded trees (warm start)
            tree = self._tree_tensors(r)
            margin = margin + tree["leaf_value"].index_select(
                0, self._route(train, tree))
            for name, ds in evals:
                if ds is not train:
                    margins[name] = margins[name] + tree[
                        "leaf_value"].index_select(0, self._route(ds, tree))
        last = {}
        for r in range(r0, cfg.num_round):
            tree, node, margin = self._round(train, margin)
            if os.environ.get("WORMHOLE_DEBUG", "") not in ("", "0"):
                validate_routing(tree, node)
            for k in self.trees:
                self.trees[k][r] = tree[k].cpu().numpy()
            msgs = []
            for name, ds in evals:
                if ds is train:
                    em = margin
                else:
                    em = margins[name] = margins[name] + tree[
                        "leaf_value"].index_select(0, self._route(ds, tree))
                last[name] = m = (self._metrics_reduced(em, ds)
                                  if self.reducer is not None
                                  else self._metrics(em, ds))
                msgs += [f"{name}-{k}:{v:.6f}" for k, v in m.items()]
            if verbose and self.mesh.rank == 0:
                print(f"[{r}]\t" + "\t".join(msgs), flush=True)
            if on_round is not None:
                on_round(r)
            if cfg.save_period and cfg.model_out and (r + 1) % cfg.save_period == 0:
                self.save(f"{cfg.model_out}.{r + 1:04d}", rounds=r + 1)
        if cfg.model_out:
            self.save(cfg.model_out)
        return last

    # -- eval / predict -----------------------------------------------------
    def _tree_tensors(self, r: int) -> dict:
        """Round r's tree as tensors on the learner's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v[r])).to(self.device)
                for k, v in self.trees.items()}

    def _route(self, ds: BinnedDataset, tree):
        """The node each row of ds ends in under one tree."""
        binned = ds.binned
        sf, sb, isp = tree["split_feat"], tree["split_bin"], tree["is_split"]
        node = torch.zeros(binned.shape[0], dtype=torch.int32,
                           device=binned.device)
        for _ in range(self.cfg.max_depth + 1):
            bv = _binned_at(binned, sf.index_select(0, node))
            child = 2 * node + 1 + (bv > sb.index_select(0, node)).to(
                torch.int32)
            node = torch.where(isp.index_select(0, node), child, node)
        return node

    def _gathered(self, ds: BinnedDataset, *rows):
        """Per-row tensors of ds over all its rows: on a sharded ds,
        gathered from every rank of the data axis."""
        if not ds.sharded:
            return rows
        return collectives.gather_rows(torch.stack(rows, 1), self.mesh,
                                       DATA_AXIS).unbind(1)

    def _metrics(self, margin, ds: BinnedDataset) -> dict:
        margin, label, mask = self._gathered(ds, margin, ds.label, ds.mask)
        if self.cfg.objective == "binary:logistic":
            # in the order the JAX learner prints them (its jitted dict
            # comes back sorted by key)
            names = ("auc", "error", "logloss")
            vals = torch.stack([M.auc(label, margin, mask),
                                1.0 - M.accuracy(label, margin, mask),
                                M.logloss(label, margin, mask)])
        else:
            names = ("rmse",)
            n = torch.clamp(torch.sum(mask), min=1.0)
            vals = torch.sqrt(
                torch.sum(mask * (margin - label) ** 2) / n)[None]
        return dict(zip(names, vals.tolist()))

    def predict_margin(self, ds: BinnedDataset, num_round: Optional[int] = None
                       ) -> np.ndarray:
        R = num_round if num_round is not None else self.cfg.num_round
        m = self._base_margins(ds)
        for r in range(R):
            tree = self._tree_tensors(r)
            m = m + tree["leaf_value"].index_select(0, self._route(ds, tree))
        (m,) = self._gathered(ds, m)
        return m.cpu().numpy()[: ds.num_real]

    def predict_blk(self, blk: RowBlock) -> np.ndarray:
        """Predict probabilities (binary:logistic) / values on raw rows."""
        if self.edges is None:
            raise RuntimeError("predict_blk: the model is not fit or loaded")
        binned = bin_matrix(_densify(blk, self.cfg.dim), self.edges)
        m = self.predict_margin(
            self._dataset(binned, np.zeros(blk.size, np.float32),
                          shard=False))
        if self.cfg.objective == "binary:logistic":
            return 1.0 / (1.0 + np.exp(-m))
        return m

    # -- persistence --------------------------------------------------------
    def save(self, path: str, rounds: Optional[int] = None) -> None:
        """Write the model as one .npz with the JAX package's keys, so
        either package loads the other's file. On a mesh only rank 0
        writes: every rank holds the same trees."""
        if self.mesh.rank != 0:
            return
        R = rounds if rounds is not None else self.cfg.num_round
        R = min(R, len(self.trees["leaf_value"]))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        atomic_savez(
            path,
            edges=self.edges,
            num_round=R,
            dim=self.cfg.dim,
            max_depth=self.cfg.max_depth,
            objective=np.bytes_(self.cfg.objective.encode()),
            base_score=self.cfg.base_score,
            **{k: v[:R] for k, v in self.trees.items()},
        )

    def load(self, path: str) -> None:
        from wormhole_tpu_torch.interop import load_gbdt_state

        if not os.path.exists(path) and not path.endswith(".npz"):
            path += ".npz"  # atomic_savez appends the suffix
        with np.load(path) as st:
            load_gbdt_state(self, {k: st[k] for k in st.files})


def _binned_at(binned, nf):
    """binned[i, nf[i]] as int32."""
    return binned.gather(1, nf.long()[:, None])[:, 0].to(torch.int32)


def validate_routing(tree, node) -> None:
    """Machine check for the sibling-subtraction invariant (the prose in
    `_level_parts`): the derived right-child histogram of a NON-splitting
    parent is garbage, which is safe only because routing never descends
    past a non-split node. This verifies exactly that: every node a row
    actually landed in must have an all-split ancestor chain, so a routing
    edit that lets rows leak into a non-splitting parent's children trips
    here instead of silently training on garbage histograms. Enabled per
    round via WORMHOLE_DEBUG=1 (host-side walk over the unique landing
    nodes)."""
    isp = _to_numpy(tree["is_split"])
    for t in np.unique(_to_numpy(node)):
        path = []
        while t > 0:
            t = (t - 1) // 2
            path.append(t)
        bad = [p for p in path if not isp[p]]
        if bad:
            raise AssertionError(
                f"sibling-subtraction invariant violated: a row landed "
                f"in a descendant of non-split node(s) {bad}: routing "
                f"descended past a non-splitting parent, so derived "
                f"right-child histograms were trained on garbage")


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _empty_trees(cfg: GbdtConfig) -> dict[str, np.ndarray]:
    T = 2 ** (cfg.max_depth + 1) - 1
    R = cfg.num_round
    return {
        "split_feat": np.zeros((R, T), np.int32),
        "split_bin": np.zeros((R, T), np.int32),
        "is_split": np.zeros((R, T), np.bool_),
        "leaf_value": np.zeros((R, T), np.float32),
    }
