"""Model scorers: predict math over compact row sets, bit-matched to
training.

A serving shard holds only its row range, so the router cannot run the
learner's full-table predict step. Instead each scorer packs a RowBlock
exactly the way the trainer's plain (``kernel=xla``) path does
(``to_device_batch`` — identical seg/val arrays, identical padding),
collects the batch's sorted-unique keys per table, and scores over a
COMPACT table whose rows were gathered from the shards. Because the
compact remap satisfies ``compact[remap[j]] == full[idx[j]]`` row for
row, every elementwise product and the ``index_add_`` fold see the SAME
float operands in the SAME order as the trainer's ``spmv`` /
``_fm_forward`` (models/linear.py, models/difacto.py) — so on the CPU
the margins are bit-identical to the model owner's own
``predict_batch`` (tests/test_torch_serving.py asserts equality, not
closeness). On the card the margin runs as the same torch ops; there
the trainer's hand kernels and a CUDA ``index_add_`` both add with f32
atomics, and the two agree within the kernels' bar (rtol 1e-5, atol
1e-4).

The port's counterpart of the JAX package's serving/scoring.py. The JAX
scorer pads its compact tables to a power of two to bound its jit
cache; the port has no jit and its remap never reads a padded row, so
it ships the fetched rows as they are. ``_linear_margin`` and
``_fm_margin`` are plain functions of tensors, on whatever device the
scorer was given: the card unless the caller names the CPU
(``device.resolve_device`` — no fallback). No hand kernel replaces
them: the JAX margins are ``segment_sum`` programs, not Pallas kernels.
The score-mode fast path (serving/fastpath.py) stays numpy on the
host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from wormhole_tpu_torch.data.rowblock import RowBlock, to_device_batch
from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.obs import trace as _trace
from wormhole_tpu_torch.ops.spmv import row_squares, spmm, spmv
import wormhole_tpu_torch.serving.fastpath as _fastpath

# host-to-device copies of one fetch-mode score (part of serve.stage.score)
_H2D_S = _obs.REGISTRY.histogram("serve.score.h2d_s")


@dataclasses.dataclass
class PackedBatch:
    """One RowBlock, packed for sharded scoring: the fixed-shape COO
    arrays (trainer-identical), the sorted-unique key list each table's
    rows must be fetched for, and the compact remaps per key space."""

    seg: np.ndarray                    # int32[capacity]
    val: np.ndarray                    # float32[capacity]
    size: int                          # live rows (score rows returned)
    keys: Dict[str, np.ndarray]        # table -> sorted-unique int64 keys
    remap: Dict[str, np.ndarray]       # key space -> int32[capacity]
    dropped_rows: int = 0


def _linear_margin(seg, idxc, val, w, num_rows: int):
    return spmv(seg, idxc, val, w, num_rows)


def _fm_margin(seg, idxc, vidxc, val, w, cnt, V, num_rows: int,
               threshold: int, l1_shrk: bool):
    # models/difacto._fm_forward over the compact domain: the admission
    # mask, both quadratic terms and the reduction order are operand for
    # operand the trainer's
    admit = cnt >= threshold
    if l1_shrk:
        admit = admit & (w != 0)
    admit_nz = admit.to(torch.float32).index_select(0, idxc)
    xw = spmv(seg, idxc, val, w, num_rows)
    vval = val * admit_nz
    xv = spmm(seg, vidxc, vval, V, num_rows)
    x2v2 = row_squares(seg, vidxc, vval, V, num_rows)
    return xw + 0.5 * torch.sum(xv * xv - x2v2, dim=-1)


def _to(device: torch.device, a: np.ndarray) -> torch.Tensor:
    # decoded wire arrays are read-only views of the frame buffer
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


class _Scorer:
    """What both scorers share: the config, the device, and the
    score-mode pack."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def pack_score(self, blk: RowBlock) -> _fastpath.ScorePack:
        cfg = self.cfg
        with _trace.request_span("serve.stage.pack", cat="serve",
                                 rows=blk.size):
            return _fastpath.pack_score(blk, cfg.minibatch,
                                        cfg.row_capacity,
                                        cfg.num_buckets)

    def _pack(self, blk: RowBlock):
        cfg = self.cfg
        db = to_device_batch(blk, cfg.minibatch, cfg.row_capacity,
                             cfg.num_buckets)
        uniq, idxc = np.unique(db.idx, return_inverse=True)
        return db, uniq, idxc

    def _run(self, packed: PackedBatch, arrays: dict, margin_fn, **kw):
        """Move the batch and its compact rows to the device, compute
        the margin there, and bring back the live rows."""
        t0 = time.perf_counter()
        dev = {k: _to(self.device, a) for k, a in arrays.items()}
        _H2D_S.observe(time.perf_counter() - t0)
        margin = margin_fn(**dev, num_rows=self.cfg.minibatch, **kw)
        out = margin[: packed.size].cpu().numpy()
        if getattr(self.cfg, "prob_predict", False):
            out = 1.0 / (1.0 + np.exp(-out))
        return out


class LinearScorer(_Scorer):
    """Margins for the linear apps: serves ``w`` only. ``cfg`` is a
    LinearConfig (or anything with minibatch/row_capacity/num_buckets/
    prob_predict)."""

    #: tables fetched from the shards, and the key space each indexes
    tables = ("w",)
    #: shard-local scoring kernel (serving/fastpath.py); routers in
    #: WH_SERVE_MODE=auto take the fast path when this is set
    score_kind = "linear"

    def score_header(self) -> dict:
        return {}

    def finalize(self, pack: _fastpath.ScorePack, prod: np.ndarray,
                 extras: Dict[str, np.ndarray]) -> np.ndarray:
        return _fastpath.finalize_linear(
            pack, prod, getattr(self.cfg, "prob_predict", False))

    def pack(self, blk: RowBlock) -> PackedBatch:
        cfg = self.cfg
        with _trace.request_span("serve.stage.pack", cat="serve",
                                 rows=blk.size):
            db, uniq, idxc = self._pack(blk)
            return PackedBatch(
                seg=db.seg, val=db.val,
                size=min(blk.size, cfg.minibatch) - db.dropped_rows,
                keys={"w": uniq.astype(np.int64)},
                remap={"w": idxc.astype(np.int32)},
                dropped_rows=db.dropped_rows)

    def score(self, packed: PackedBatch,
              rows: Dict[str, np.ndarray]) -> np.ndarray:
        with _trace.request_span("serve.stage.score", cat="serve",
                                 keys=len(packed.keys["w"])):
            return self._run(
                packed, {"seg": packed.seg, "idxc": packed.remap["w"],
                         "val": packed.val, "w": rows["w"]},
                _linear_margin)


class DifactoScorer(_Scorer):
    """FM margins for the difacto app: serves ``w``/``cnt`` (bucket key
    space) and ``V`` (embedding key space, ``key % vb``). Admission is
    recomputed from the served ``cnt`` rows exactly as the trainer's
    forward does, so a never-admitted bucket scores as unallocated."""

    tables = ("w", "cnt", "V")
    score_kind = "difacto"

    def pack(self, blk: RowBlock) -> PackedBatch:
        cfg = self.cfg
        with _trace.request_span("serve.stage.pack", cat="serve",
                                 rows=blk.size):
            db, uniq_w, idxc = self._pack(blk)
            # the V key space is uniq_w folded mod vb: unique over the
            # (already deduplicated) uniq_w is the same sorted key set
            # and inverse as unique over the full per-nonzero vidx
            uniq_v, inv_small = np.unique(
                (uniq_w % np.int32(cfg.vb)).astype(np.int32),
                return_inverse=True)
            vidxc = inv_small[idxc]
            uniq_w = uniq_w.astype(np.int64)
            return PackedBatch(
                seg=db.seg, val=db.val,
                size=min(blk.size, cfg.minibatch) - db.dropped_rows,
                keys={"w": uniq_w, "cnt": uniq_w,
                      "V": uniq_v.astype(np.int64)},
                remap={"w": idxc.astype(np.int32),
                       "V": vidxc.astype(np.int32)},
                dropped_rows=db.dropped_rows)

    def score_header(self) -> dict:
        cfg = self.cfg
        return {"threshold": int(cfg.threshold),
                "l1_shrk": int(bool(cfg.l1_shrk)),
                "vb": int(cfg.vb), "rep": ["V"]}

    def finalize(self, pack: _fastpath.ScorePack, prod: np.ndarray,
                 extras: Dict[str, np.ndarray]) -> np.ndarray:
        return _fastpath.finalize_difacto(
            pack, prod, extras["xv"], extras["x2"],
            getattr(self.cfg, "prob_predict", False))

    def score(self, packed: PackedBatch,
              rows: Dict[str, np.ndarray]) -> np.ndarray:
        cfg = self.cfg
        with _trace.request_span("serve.stage.score", cat="serve",
                                 keys=len(packed.keys["w"])):
            return self._run(
                packed, {"seg": packed.seg, "idxc": packed.remap["w"],
                         "vidxc": packed.remap["V"], "val": packed.val,
                         "w": rows["w"], "cnt": rows["cnt"],
                         "V": rows["V"]},
                _fm_margin, threshold=int(cfg.threshold),
                l1_shrk=bool(cfg.l1_shrk))
