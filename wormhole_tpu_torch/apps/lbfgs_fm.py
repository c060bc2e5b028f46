"""fm.dmlc: batch factorization machine trained by L-BFGS (reference
learn/lbfgs-fm/fm.cc), on one device, or with bsp=1 under the launcher
on several worker processes whose gradients and losses sum over the BSP
allreduce ring (runtime/allreduce.py; the feature count is agreed under
the blob key lbfgs_fm_dim). Rabit-style key=value args:

  python -m wormhole_tpu_torch.apps.lbfgs_fm data=train.libsvm nfactor=8 \
      reg_L2=0.1 max_lbfgs_iter=30 model_out=fm.npz device=cuda
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np

from wormhole_tpu_torch.apps._runner import maybe_run_bsp, parse_cli
from wormhole_tpu_torch.apps.lbfgs_linear import (
    check_single_process, run_bsp_rank, solver_config,
)
from wormhole_tpu_torch.models.batch_objectives import FmObjFunction, load_batches
from wormhole_tpu_torch.solver.lbfgs import LBFGSSolver


@dataclasses.dataclass
class LbfgsFmConfig:
    """Key surface of the reference fm.cc SetParam loop: nfactor (the
    embedding dim k), init_sigma (fm.cc:141-156), regularizers, iters.
    The same keys and defaults as the JAX app's."""

    data: str = ""
    data_format: str = "libsvm"
    model_out: Optional[str] = None
    nfactor: int = 8
    init_sigma: float = 0.01
    reg_L1: float = 0.0
    reg_L2: float = 0.0
    max_lbfgs_iter: int = 30
    lbfgs_stop_tol: float = 1e-7
    m: int = 10
    minibatch: int = 4096
    nnz_per_row: int = 64
    num_parts_per_file: int = 1
    seed: int = 0
    # several processes over the BSP allreduce ring (parameters
    # replicated per rank, data partitioned, gradient and loss summed
    # over the ring; fault-tolerant through version checkpoints)
    bsp: bool = False


def _bsp_worker_body(cfg, env, client, comm, device) -> int:
    return run_bsp_rank(
        cfg, env, client, comm, device,
        lambda b, nf: FmObjFunction(b, nf, cfg.nfactor, device,
                                    init_scale=cfg.init_sigma,
                                    seed=cfg.seed),
        key="lbfgs_fm_dim", nfactor=cfg.nfactor)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_cli(LbfgsFmConfig, argv)
    rc = maybe_run_bsp(cfg, _bsp_worker_body, device)
    if rc is not None:
        return rc
    check_single_process(cfg)
    batches, num_feature = load_batches(
        cfg.data, cfg.data_format, cfg.minibatch, cfg.nnz_per_row,
        cfg.num_parts_per_file, device)
    obj = FmObjFunction(batches, num_feature, cfg.nfactor, device,
                        init_scale=cfg.init_sigma, seed=cfg.seed)
    w, objv = LBFGSSolver(obj, solver_config(cfg)).run()
    print(f"final objective: {objv:.6f}")
    if cfg.model_out:
        np.savez(cfg.model_out, w=w.cpu().numpy(), nfactor=cfg.nfactor,
                 num_feature=num_feature)
        print(f"saved model to {cfg.model_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
