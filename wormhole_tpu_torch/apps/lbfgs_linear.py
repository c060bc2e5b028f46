"""lbfgs linear.dmlc: batch logistic regression trained by L-BFGS/OWL-QN
(reference learn/lbfgs-linear/lbfgs.cc), on one device; with bsp=1 under
the launcher on several worker processes whose gradients and losses sum
over the BSP allreduce ring (runtime/allreduce.py); or on the ranks of
one process group (global_mesh=1 under the launcher, or
torch.distributed.run), the same sums by all_reduce over the group
(parallel/collectives.py GroupComm). Rabit-style key=value args:

  python -m wormhole_tpu_torch.apps.lbfgs_linear data=train.libsvm \
      reg_L1=1 max_lbfgs_iter=30 model_out=model.npz device=cuda \
      task=train|pred [test_data=... pred_out=...]
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 3 -s 0 -- \
      python -m wormhole_tpu_torch.apps.lbfgs_linear data=train.libsvm \
      num_parts_per_file=3 bsp=1
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 2 -s 0 -- \
      python -m wormhole_tpu_torch.apps.lbfgs_linear data=train.libsvm \
      global_mesh=1

task=pred reads model_in (an .npz of w and num_feature, the JAX app's
or this one's) and writes one margin a row, %.6g. A test row with a
feature id the model does not have raises. On several ranks w stays
replicated (every rank applies the same reduced values) and rank 0 saves
it; global_mesh=1 without a launcher role runs in one process, as the
JAX app does.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import types
from typing import Optional

import numpy as np

from wormhole_tpu_torch.apps._runner import (maybe_run_bsp,
                                              maybe_run_global, parse_cli,
                                              ranks_of_launch, refuse_roles)
from wormhole_tpu_torch.interop import lbfgs_state_from_numpy
from wormhole_tpu_torch.models.batch_objectives import (
    LinearObjFunction, load_batches, load_batches_bsp, load_batches_global,
)
from wormhole_tpu_torch.solver.lbfgs import LBFGSConfig, LBFGSSolver


@dataclasses.dataclass
class LbfgsLinearConfig:
    """Key surface of the reference lbfgs.cc SetParam loop (:236-241):
    reg_L1, max_lbfgs_iter, lbfgs_stop_tol, model_in/out, task. The same
    keys and defaults as the JAX app's."""

    data: str = ""
    test_data: Optional[str] = None
    data_format: str = "libsvm"
    task: str = "train"         # train | pred  (lbfgs.cc:55-69)
    model_in: Optional[str] = None
    model_out: Optional[str] = None
    pred_out: str = "pred.txt"
    reg_L1: float = 0.0
    reg_L2: float = 0.0
    max_lbfgs_iter: int = 30
    lbfgs_stop_tol: float = 1e-7
    m: int = 10
    minibatch: int = 4096
    nnz_per_row: int = 64
    num_parts_per_file: int = 1
    # the launcher's workers as the ranks of one process group: data
    # partitioned, w replicated, gradient and loss all-reduced
    global_mesh: bool = False
    # several processes over the BSP allreduce ring: parameters
    # replicated per rank, data partitioned, gradient and loss summed
    # over the ring, fault-tolerant through version checkpoints
    bsp: bool = False


def solver_config(cfg) -> LBFGSConfig:
    return LBFGSConfig(max_iter=cfg.max_lbfgs_iter, m=cfg.m,
                       reg_l1=cfg.reg_L1, reg_l2=cfg.reg_L2,
                       min_rel_decrease=cfg.lbfgs_stop_tol)


def check_single_process(cfg) -> None:
    """Refuse a launcher role that no mode of this launch takes."""
    refuse_roles("L-BFGS", "run with bsp=1, or without the launcher" + (
        " (global_mesh=1 runs under it too)"
        if hasattr(cfg, "global_mesh") else ""))


def _global_worker_body(cfg, env, client, device) -> int:
    """L-BFGS on the ranks of one process group (the JAX package's global
    body): each rank loads its rows of every global batch, padded to the
    global batch count (load_batches_global), and the solver sums the
    gradient and the raw loss over the group through GroupComm, the
    BspWorker interface. Every rank drives the same host loop on the same
    reduced values; w is replicated, so rank 0 alone saves it."""
    from wormhole_tpu_torch.parallel.collectives import GroupComm

    if cfg.task != "train":
        raise ValueError(f"several ranks run task=train, not {cfg.task!r}")
    batches, num_feature = load_batches_global(
        cfg.data, env, cfg.data_format, cfg.minibatch, cfg.nnz_per_row,
        cfg.num_parts_per_file, device=device)
    obj = LinearObjFunction(batches, num_feature, device)
    solver = LBFGSSolver(obj, solver_config(cfg), comm=GroupComm())
    t0 = time.perf_counter()
    w, objv = solver.run(verbose=(env.rank == 0))
    wall = time.perf_counter() - t0
    if env.rank == 0:
        if cfg.model_out:
            np.savez(cfg.model_out, w=w.cpu().numpy(),
                     num_feature=num_feature)
            print(f"saved model to {cfg.model_out}", flush=True)
        print(f"final objective: {objv:.6f}", flush=True)
        # host-clock ms of the solve over its iterations
        print(f"[lbfgs-global] iterations {solver.iter} ms_per_iter "
              f"{wall * 1e3 / max(solver.iter, 1):.3f}", flush=True)
    return 0


def run_bsp_rank(cfg, env, client, comm, device, make_obj,
                 key: str = "lbfgs_dim", **saved) -> int:
    """One rank of L-BFGS over the BSP allreduce ring: this rank loads
    its part slice, the solver sums the gradient and the raw loss over
    the ring, and every iteration ends in a version checkpoint, so a
    killed worker respawns, reloads (w, g, history, S, Y) and replays
    the collectives it missed from its peers' result caches. Every rank
    drives the same host loop on the same reduced values; w is
    replicated, so rank 0 alone saves it (with num_feature and `saved`)
    and prints the final objective."""
    if getattr(cfg, "task", "train") != "train":
        raise ValueError(f"bsp=1 runs task=train, not {cfg.task!r}")
    batches, num_feature = load_batches_bsp(
        cfg.data, env, client, cfg.data_format, cfg.minibatch,
        cfg.nnz_per_row, cfg.num_parts_per_file, key=key, device=device)
    obj = make_obj(batches, num_feature)
    w, objv = LBFGSSolver(obj, solver_config(cfg), comm=comm).run(
        verbose=(env.rank == 0))
    if env.rank == 0:
        if cfg.model_out:
            np.savez(cfg.model_out, w=w.cpu().numpy(),
                     num_feature=num_feature, **saved)
            print(f"saved model to {cfg.model_out}", flush=True)
        print(f"final objective: {objv:.6f}", flush=True)
    return 0


def _bsp_worker_body(cfg, env, client, comm, device) -> int:
    return run_bsp_rank(cfg, env, client, comm, device,
                        lambda b, nf: LinearObjFunction(b, nf, device))


def predict(cfg, device) -> int:
    """The reference's TaskPred: load the model, write one margin a row
    (lbfgs.cc:70-85)."""
    if not cfg.model_in:
        raise ValueError("task=pred needs model_in")
    path = cfg.model_in if cfg.model_in.endswith(".npz") else (
        cfg.model_in + ".npz")
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    # a file without num_feature holds [w; bias] and nothing past it
    nf = int(arrays.get("num_feature", len(arrays["w"]) - 1))
    batches, data_nf = load_batches(
        cfg.test_data or cfg.data, cfg.data_format, cfg.minibatch,
        cfg.nnz_per_row, cfg.num_parts_per_file, device)
    if data_nf > nf:
        raise ValueError(f"test data has feature id {data_nf - 1}; the "
                         f"model has {nf} features")
    obj = LinearObjFunction(batches, nf, device)
    w = lbfgs_state_from_numpy({"w": arrays["w"]}, obj.num_dim,
                               obj.device)["w"]
    n = 0
    with open(cfg.pred_out, "w") as f:
        for seg, idx, val, _, mask in batches:
            margins = obj.predict(w, seg, idx, val, cfg.minibatch)
            for m in margins[mask > 0].cpu().numpy():
                f.write(f"{m:.6g}\n")
            n += int((mask > 0).sum())
    print(f"wrote {n} predictions to {cfg.pred_out}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_cli(LbfgsLinearConfig, argv, ranks=True)
    rc = maybe_run_bsp(cfg, _bsp_worker_body, device)
    if rc is None:
        rc = maybe_run_global(cfg, _global_worker_body, device)
    if rc is not None:
        return rc
    check_single_process(cfg)
    with ranks_of_launch(device) as device:
        import torch.distributed as dist

        if dist.is_initialized():  # the ranks of torch.distributed.run
            env = types.SimpleNamespace(rank=dist.get_rank(),
                                        num_workers=dist.get_world_size())
            return _global_worker_body(cfg, env, None, device)
        return _single(cfg, device)


def _single(cfg, device) -> int:
    if cfg.task == "pred":
        return predict(cfg, device)
    if cfg.task != "train":
        raise ValueError(f"task must be train or pred, got {cfg.task!r}")
    batches, num_feature = load_batches(
        cfg.data, cfg.data_format, cfg.minibatch, cfg.nnz_per_row,
        cfg.num_parts_per_file, device)
    obj = LinearObjFunction(batches, num_feature, device)
    w, objv = LBFGSSolver(obj, solver_config(cfg)).run()
    print(f"final objective: {objv:.6f}")
    if cfg.model_out:
        np.savez(cfg.model_out, w=w.cpu().numpy(), num_feature=num_feature)
        print(f"saved model to {cfg.model_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
