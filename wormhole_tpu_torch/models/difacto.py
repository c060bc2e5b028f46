"""DiFacto: the asynchronous factorization machine, on one device.

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
  and fm_push_contrib and v_scatter_update push and update V.
"""

from __future__ import annotations

import dataclasses
import logging
import threading

import numpy as np
import torch

from wormhole_tpu_torch.data.rowblock import DeviceBatch, RowBlock, to_device_batch
from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.models.linear import (LinearConfig, _loss_dual,
                                              _progress, _to_floats, _update)
from wormhole_tpu_torch.ops import coo_kernels as ck
from wormhole_tpu_torch.ops.fused_update import (row_tile_gather,
                                                 scatter_update,
                                                 v_scatter_update)
from wormhole_tpu_torch.ops.localizer import localize
from wormhole_tpu_torch.ops.spmv import row_squares, spmm, spmv, spmv_t
from wormhole_tpu_torch.parallel.kvstore import KVStore, TableSpec, quantize_push

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
    """Checkpoint adapter presenting the w-tables and the V-tables as one
    store (utils/checkpoint.py needs only to_numpy / from_numpy)."""

    on_load = None  # callback fired after from_numpy (count-mirror sync)

    def __init__(self, *stores):
        self.stores = stores

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

    @property
    def state(self):
        """Merged read view over both table groups (assign into the
        sub-stores, not into it)."""
        out = {}
        for s in self.stores:
            out.update(s.state)
        return out


class DifactoLearner:
    """FM train/eval/predict steps over one device's w and V tables."""

    def __init__(self, cfg: DifactoConfig, device=None, seed: int = 0):
        if not 0 < cfg.vb <= cfg.num_buckets:
            raise ValueError(f"v_buckets must be in (0, num_buckets]; got "
                             f"{cfg.vb}")
        if cfg.algo != "ftrl":
            raise ValueError("difacto trains w with FTRL (reference "
                             f"async_sgd.h:262-286); algo={cfg.algo!r}")
        if cfg.kernel not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown kernel {cfg.kernel!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        specs = _tables_for(cfg)
        self.store = KVStore(cfg.num_buckets,
                             {k: v for k, v in specs.items() if v.tail == ()},
                             self.device, seed=seed)
        # the V tables have their own (smaller) bucket space
        self.vstore = KVStore(cfg.vb,
                              {k: v for k, v in specs.items() if v.tail != ()},
                              self.device, seed=seed + 1)
        self.ckpt_store = _CombinedStore(self.store, self.vstore)
        self.ckpt_store.on_load = self.refresh_count_mirror
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
        self._use_fm_pallas = cfg.kernel == "pallas" or (
            cfg.kernel == "auto" and self.device.type == "cuda"
            and shapes_ok)
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

    # -- xla kind ------------------------------------------------------------
    def _grad_filters(self, gV, mask):
        """The V-gradient knobs of reference loss.h:145-155, then the push
        filter."""
        cfg = self.cfg
        if cfg.grad_normalization:
            gV = gV / torch.clamp(torch.sum(mask), min=1.0)
        if cfg.grad_clipping > 0:
            gV = torch.clamp(gV, -cfg.grad_clipping, cfg.grad_clipping)
        if cfg.dropout > 0:
            keep = torch.rand(gV.shape, generator=self._gen,
                              device=gV.device) < 1.0 - cfg.dropout
            gV = gV * keep
        return quantize_push(gV, cfg.fixed_bytes)

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

    # -- compacted fm kind ---------------------------------------------------
    # Admission (cnt >= threshold) is decided at pack time from a HOST
    # mirror of the count table: counts are pure data statistics the host
    # can track exactly, and the mirror resyncs from the device table
    # after loads and at every pass start. l1_shrk needs w at pack time,
    # so it stays on the xla kind.

    def refresh_count_mirror(self) -> None:
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
        and lay both out for the kernels. Same arrays as the JAX
        learner's _pack_fm."""
        cfg = self.cfg
        idx64 = db.idx.astype(np.int64)
        live = db.val != 0
        loc = localize(idx64.astype(np.uint64))
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
                vuniq0 = (np.unique(idx64[live] % cfg.vb)
                          if live.any() else np.zeros(1, np.int64))
                blocks_v = ck.tile_blocks_needed(vuniq0,
                                                 self._v_rows_per_tile)
                uv = int(scale * blocks_v + 1) * ck.BLK_U
                self._fm_caps = (uw, uv)
        uw_cap, uv_cap = self._fm_caps

        ts_w = ck.assign_tile_slots(uniq, ck.TILE, uw_cap, cfg.num_buckets)
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
        loc_v = localize(vidx)
        ts_v = ck.assign_tile_slots(loc_v.uniq_keys, self._v_rows_per_tile,
                                    uv_cap, cfg.vb)
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
                                  capacity=cfg.row_capacity)
        vtouched = np.zeros(uv_cap, np.float32)
        vtouched[np.unique(vslotv[vvalv != 0])] = 1.0
        vcoo = ck.pack_sorted_coo(vslotv, segv, vvalv, uv_cap,
                                  capacity=cfg.row_capacity,
                                  tile=ck.TILE_HI, blk=ck.FM_BLK)
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
        if not self._use_fm_pallas:
            return ("xla", db, blk.size)
        return ("fm", self._pack_fm(db, train), db.label, db.row_mask,
                blk.size, train)

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
        if b[0] == "xla":
            db, size = b[1], b[2]
            vidx = (db.idx % np.int32(self.cfg.vb)).astype(np.int32)
            arrays = [db.seg, db.idx, vidx, db.val, db.label, db.row_mask]
        else:
            _, pk, label, mask, size, packed_for_train = b
            if packed_for_train != train:
                raise ValueError("batch was packed for "
                                 f"{'train' if packed_for_train else 'eval'}")
            arrays = self._fm_args(pk, label, mask, train)
        return ("staged", b[0], tuple(self._dev(*arrays)), size, train)

    # -- entry points --------------------------------------------------------
    def train_batch(self, blk) -> dict:
        """One training step on a RowBlock, a prepared or a staged batch;
        updates the tables in place and returns the progress dict."""
        _, kind, args, _, st_train = self.stage_batch(
            self._prepared(blk, True), train=True)
        if not st_train:
            raise ValueError("batch was staged for eval, not train")
        step = self._train_step_fm if kind == "fm" else self._train_step_xla
        prog = _to_floats(step(*args))
        self._step_count += 1
        return prog

    def _fwd_any(self, blk):
        _, kind, args, size, st_train = self.stage_batch(
            self._prepared(blk, False), train=False)
        if st_train:
            raise ValueError("batch was staged for train, not eval")
        margin, prog = (self._fwd_fm if kind == "fm" else self._fwd_xla)(*args)
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
        st = self.store.state
        admit = st["cnt"].cpu().numpy() >= self.cfg.threshold
        if self.cfg.l1_shrk:
            admit &= st["w"].cpu().numpy() != 0
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
        _, counts = np.unique(keys % self.cfg.vb, return_counts=True)
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
