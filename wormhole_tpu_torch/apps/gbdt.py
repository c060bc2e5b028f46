"""xgboost.dmlc: histogram GBDT (the reference builds the xgboost CLI over
rabit; conf surface of mushroom.hadoop.conf), on one device or, under
torch.distributed.run, with the rows sharded over the launch's ranks.

  python -m wormhole_tpu_torch.apps.gbdt mushroom.conf num_round=10 device=cuda
  python -m torch.distributed.run --nproc-per-node 4 \
      -m wormhole_tpu_torch.apps.gbdt mushroom.conf
"""

from __future__ import annotations

import sys

from wormhole_tpu_torch.apps._runner import (parse_cli, ranks_of_launch,
                                              refuse_roles)
from wormhole_tpu_torch.models.gbdt import GbdtConfig, GbdtLearner
from wormhole_tpu_torch.parallel.mesh import make_mesh
from wormhole_tpu_torch.solver.workload import iter_rowblocks


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_cli(GbdtConfig, argv, ranks=True)
    refuse_roles("gbdt", "4 (the BSP allreduce plane)")
    if cfg.bsp:
        raise NotImplementedError(
            "bsp=1 (GBDT over the BSP allreduce ring) waits for the port's "
            "BSP slice; run single-process")
    if cfg.global_mesh:
        raise NotImplementedError(
            "global_mesh=1 (one mesh over several hosts) waits for the "
            "port's multi-host slice; launch the ranks of one host with "
            "torch.distributed.run")
    with ranks_of_launch(device) as device:
        return _run(cfg, GbdtLearner(cfg, mesh=make_mesh(device=device)))


def _run(cfg: GbdtConfig, lrn: GbdtLearner) -> int:
    if cfg.task == "pred":
        # xgboost CLI task=pred: load model, write one probability/value
        # per test row to name_pred
        if not cfg.model_in:
            raise ValueError("task=pred needs model_in")
        lrn.load(cfg.model_in)
        if lrn.mesh.rank != 0:  # the prediction needs no other rank
            return 0
        n = 0
        with open(cfg.pred_out, "w") as f:
            for blk in iter_rowblocks(cfg.test_data or cfg.train_data,
                                      cfg.num_parts_per_file,
                                      cfg.data_format, cfg.minibatch,
                                      device=lrn.device):
                for p in lrn.predict_blk(blk):
                    f.write(f"{p:.6g}\n")
                    n += 1
        print(f"wrote {n} predictions to {cfg.pred_out}")
        return 0
    lrn.fit()
    if cfg.model_out and lrn.mesh.rank == 0:
        lrn.save(cfg.model_out)
        print(f"saved model to {cfg.model_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
