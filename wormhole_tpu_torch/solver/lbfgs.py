"""Batch L-BFGS / OWL-QN solver on one device, or replicated on each rank
of a BSP allreduce ring.

Parity target: reference learn/solver/lbfgs.h — vector-free L-BFGS with
backtracking line search and OWL-QN L1 handling: global quantities are
rebuilt from dot products (:235-303), the line search evaluates the
objective once a trial (:321-356), checkpoints make iterations resumable
(:120,194). The same iteration as the JAX package's solver/lbfgs.py.

Each iteration fetches ONE Gram matrix of the [S..., Y..., pg] basis
(the reference's single Allreduce<Sum> of its dot products,
lbfgs.h:235-252), runs the two-loop recursion on (2m+1)-sized float64
host vectors, and forms the direction as one device linear combination
of the basis. The host drives the outer iteration and the line search;
``host_syncs`` counts the device-to-host fetches the solver makes.

OWL-QN (lbfgs.h:358-407): pseudo-gradient at w = 0, direction sign fix
against the pseudo-gradient, orthant projection of each trial point.

With ``comm`` (a runtime/allreduce.py BspWorker) the solver runs the
reference's distributed layout: parameters and history replicated per
rank, data partitioned, and the two data-dependent quantities, the
gradient and the raw objective, summed over the worker ring
(lbfgs.h:235-303, 321-356). They cross to the host as numpy (the ring is
host code) and come back to the objective's device as f32. Every other
scalar is computed from those reduced values, identical on every rank,
so all ranks drive the same host loop in lockstep. Checkpoints go
through the ring's version protocol (rabit CheckPoint) with the JAX
package's state keys; the state holds g and the objective history, so a
resumed rank skips the initial grad and eval, which keeps its collective
counters aligned with the survivors'.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Protocol

import numpy as np
import torch


class ObjFunction(Protocol):
    """The IObjFunction surface (reference lbfgs.h:23-52)."""

    num_dim: int

    def init_model(self) -> torch.Tensor: ...
    def eval(self, w: torch.Tensor) -> float: ...   # sum loss over data
    def grad(self, w: torch.Tensor) -> torch.Tensor: ...
    def l1_mask(self) -> torch.Tensor: ...  # 1 where L1 applies


@dataclasses.dataclass
class LBFGSConfig:
    max_iter: int = 30
    m: int = 10                 # history pairs
    reg_l1: float = 0.0         # OWL-QN when > 0
    reg_l2: float = 0.0
    c1: float = 1e-4            # sufficient-decrease constant
    rho: float = 0.5            # backtracking factor
    alpha0: float = 1.0
    max_linesearch: int = 20
    min_rel_decrease: float = 1e-7  # convergence: relative objv decrease
    checkpoint_dir: Optional[str] = None


class LBFGSSolver:
    """Host-driven L-BFGS over vectors on the objective's device; with
    `comm`, one rank of a BSP ring (see the module docstring)."""

    def __init__(self, obj: ObjFunction, cfg: LBFGSConfig, comm=None):
        self.obj = obj
        self.cfg = cfg
        self.comm = comm
        self.S: list[torch.Tensor] = []   # s_k = w_{k+1} - w_k
        self.Y: list[torch.Tensor] = []   # y_k = g_{k+1} - g_k
        self.iter = 0
        self.objv_history: list[float] = []
        self._l1_mask = obj.l1_mask() if cfg.reg_l1 > 0 else None
        # device-to-host fetches the solver makes (the quantity the
        # reference keeps down by batching dots into one allreduce)
        self.host_syncs = 0

    def _fetch(self, x) -> float:
        self.host_syncs += 1
        return float(x)

    # -- device pieces --------------------------------------------------------
    def _full_obj(self, w, raw_loss: float):
        """Data loss plus the regularizers, as a device scalar."""
        o = raw_loss + 0.5 * self.cfg.reg_l2 * torch.dot(w, w)
        if self.cfg.reg_l1 > 0:
            o = o + self.cfg.reg_l1 * (w.abs() * self._l1_mask).sum()
        return o

    def _pseudo_gradient(self, w, g):
        """OWL-QN pseudo-gradient of reg_l1*|w| at w (SetL1Dir parity,
        lbfgs.h:358-378): at w = 0 the subgradient closest to zero."""
        g = g + self.cfg.reg_l2 * w
        if self.cfg.reg_l1 <= 0:
            return g
        m_, l1 = self._l1_mask, self.cfg.reg_l1
        gp = g + l1 * m_
        gm = g - l1 * m_
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        pg_zero = torch.where(gm > 0, gm, torch.where(gp < 0, gp, zero))
        return torch.where((w == 0) & (m_ > 0), pg_zero,
                           g + l1 * torch.sign(w) * m_)

    def _fix_dir_sign(self, d, pg):
        """Restrict the direction to the descent orthant (FixDirL1Sign,
        lbfgs.h:380-389)."""
        if self.cfg.reg_l1 <= 0:
            return d
        return torch.where(d * -pg > 0, d, torch.zeros_like(d))

    def _orthant_project(self, w_new, orthant):
        """Clip the trial point to the chosen orthant (FixWeightL1Sign,
        lbfgs.h:391-407)."""
        if self.cfg.reg_l1 <= 0:
            return w_new
        keep = (w_new * orthant >= 0) | (self._l1_mask == 0)
        return torch.where(keep, w_new, torch.zeros_like(w_new))

    # -- two-loop recursion in basis coordinates (lbfgs.h:216-318) -----------
    def _direction(self, pg):
        """(d, pg.d or None). One Gram matrix of the [S..., Y..., pg]
        basis comes to the host (one sync an iteration instead of about
        4m), the two-loop recursion runs on its (2m+1)-sized coordinates,
        and d is one device linear combination of the basis."""
        if not self.S:
            return -pg, None
        k = len(self.S)
        B = torch.stack(self.S + self.Y + [pg])
        G = (B @ B.T).cpu().numpy()
        self.host_syncs += 1
        coef = np.zeros(2 * k + 1)
        coef[2 * k] = -1.0  # q = -pg
        alphas = np.zeros(k)
        rhos = np.zeros(k)
        for i in range(k - 1, -1, -1):
            rhos[i] = 1.0 / G[i, k + i]                # 1 / (s_i . y_i)
            alphas[i] = rhos[i] * float(G[i] @ coef)   # rho (s_i . q)
            coef[k + i] -= alphas[i]                   # q -= a y_i
        gamma = G[k - 1, 2 * k - 1] / G[2 * k - 1, 2 * k - 1]
        coef *= gamma
        for i in range(k):
            b = rhos[i] * float(G[k + i] @ coef)       # rho (y_i . q)
            coef[i] += alphas[i] - b                   # q += (a - b) s_i
        d = torch.from_numpy(coef.astype(np.float32)).to(B.device) @ B
        # pg . d comes free from the same Gram: d = sum coef_i B_i
        return d, float(G[2 * k] @ coef)

    # -- one iteration (UpdateOneIter, lbfgs.h:168-196) -----------------------
    def _eval_full(self, w) -> float:
        """Full objective at w. Over a ring the RAW data loss is summed
        before the regularizers: they are functions of the replicated w
        and are added once, not once a rank (lbfgs.h:321-340)."""
        raw = self.obj.eval(w)
        if self.comm is not None:
            raw = float(self.comm.allreduce(np.float32(raw)))
        return self._fetch(self._full_obj(w, raw))

    def _grad(self, w):
        """Gradient of the data loss: this rank's sum, then over a ring
        one allreduce (the single Allreduce<Sum> an iteration of
        lbfgs.h:194), back on the objective's device as f32."""
        g = self.obj.grad(w)
        if self.comm is not None:
            # a copy: the ring keeps its result cached for replays
            g = torch.from_numpy(np.array(
                self.comm.allreduce(g.cpu().numpy()), np.float32)).to(
                    g.device)
        return g

    def run(self, verbose: bool = True) -> tuple[torch.Tensor, float]:
        cfg = self.cfg
        w, g, objv = self._try_resume()
        resumed = w is not None
        if not resumed:
            w = self.obj.init_model()
        # a checkpoint with g and the objective history skips both
        # recomputes; one without them recomputes
        if g is None:
            g = self._grad(w)
        if objv is None:
            objv = self._eval_full(w)
        if not resumed:  # a resumed history already ends with this objv
            self.objv_history.append(objv)
        if verbose:
            print(f"lbfgs {'resume' if resumed else 'init'}: "
                  f"objv {objv:.6f}", flush=True)

        while self.iter < cfg.max_iter:
            # convergence is judged from the history at the loop top, so
            # a run resumed after its last iteration stops here too
            if len(self.objv_history) >= 2:
                prev, cur = self.objv_history[-2], self.objv_history[-1]
                rel = (prev - cur) / max(abs(prev), 1e-12)
                if 0 <= rel < cfg.min_rel_decrease:
                    if verbose:
                        print("lbfgs: converged", flush=True)
                    break
            pg = self._pseudo_gradient(w, g)
            d_raw, gd_raw = self._direction(pg)
            d = self._fix_dir_sign(d_raw, pg)

            # orthant for this step: sign(w), or -sign(pg) where w == 0
            orthant = torch.where(w != 0, torch.sign(w), -torch.sign(pg))

            # backtracking line search (lbfgs.h:321-356); pg.d falls out
            # of the Gram matrix unless the OWL-QN sign fix altered d
            if cfg.reg_l1 > 0 or gd_raw is None:
                gd = self._fetch(torch.dot(pg, d))
            else:
                gd = gd_raw
            if gd >= 0:  # not a descent direction: reset the history
                self.S.clear()
                self.Y.clear()
                d = -pg
                gd = self._fetch(torch.dot(pg, d))
            alpha = cfg.alpha0
            w_new, objv_new, ok = w, objv, False
            for _ in range(cfg.max_linesearch):
                trial = self._orthant_project(w + alpha * d, orthant)
                o = self._eval_full(trial)
                if o <= objv + cfg.c1 * alpha * gd:
                    w_new, objv_new, ok = trial, o, True
                    break
                alpha *= cfg.rho
            if not ok:
                if verbose:
                    print("lbfgs: line search failed, stopping", flush=True)
                break

            g_new = self._grad(w_new)
            s = w_new - w
            y = (g_new + cfg.reg_l2 * w_new) - (g + cfg.reg_l2 * w)
            if self._fetch(torch.dot(s, y)) > 1e-10:
                self.S.append(s)
                self.Y.append(y)
                if len(self.S) > cfg.m:
                    self.S.pop(0)
                    self.Y.pop(0)
            w, g, objv = w_new, g_new, objv_new
            self.iter += 1
            self.objv_history.append(objv)
            if verbose:
                print(f"lbfgs iter {self.iter}: objv {objv:.6f} "
                      f"alpha {alpha:.3g}", flush=True)
            self._checkpoint(w, g)
        return w, objv

    # -- checkpoint (rabit CheckPoint parity, lbfgs.h:120,194) ----------------
    def _state(self, w, g) -> dict:
        """The JAX package's lbfgs_state.npz arrays."""
        dim = self.obj.num_dim_padded

        def stack(vs):
            return (torch.stack(vs).cpu().numpy() if vs
                    else np.zeros((0, dim)))

        return dict(w=w.cpu().numpy(), g=g.cpu().numpy(),
                    iter=np.int64(self.iter),
                    objv=np.asarray(self.objv_history, dtype=np.float64),
                    S=stack(self.S), Y=stack(self.Y))

    def _checkpoint(self, w, g) -> None:
        if self.comm is not None:
            # version-stamped ring checkpoint: bumps (version, seq) on
            # every rank in lockstep and persists under the launcher's
            # snapshot dir for a respawned incarnation
            self.comm.checkpoint(self._state(w, g))
            return
        cdir = self.cfg.checkpoint_dir
        if not cdir:
            return
        from wormhole_tpu_torch.utils.checkpoint import atomic_savez

        os.makedirs(cdir, exist_ok=True)
        atomic_savez(os.path.join(cdir, "lbfgs_state.npz"),
                     **self._state(w, g))

    def _try_resume(self):
        """(w, g, objv) from the ring's checkpoint (with ``comm``) or the
        checkpoint dir's lbfgs_state.npz (the JAX package's or the
        port's; a mesh's padding stripped by
        interop.lbfgs_state_from_numpy), or Nones. g and objv are None
        when the file predates them and must be recomputed."""
        from wormhole_tpu_torch.interop import lbfgs_state_from_numpy

        if self.comm is not None:
            arrays = self.comm.load_checkpoint()
        else:
            cdir = self.cfg.checkpoint_dir
            path = os.path.join(cdir, "lbfgs_state.npz") if cdir else None
            arrays = None
            if path is not None and os.path.exists(path):
                with np.load(path) as f:
                    arrays = {k: f[k] for k in f.files}
        if arrays is None:
            return None, None, None
        st = lbfgs_state_from_numpy(arrays, self.obj.num_dim,
                                    getattr(self.obj, "device", None))
        self.iter = st["iter"]
        self.objv_history = st["objv"]
        self.S, self.Y = st["S"], st["Y"]
        g = st.get("g")
        objv = self.objv_history[-1] if (
            g is not None and self.objv_history) else None
        return st["w"], g, objv
