"""xgboost.dmlc: histogram GBDT (the reference builds the xgboost CLI over
rabit; conf surface of mushroom.hadoop.conf), on one device.

  python -m wormhole_tpu_torch.apps.gbdt mushroom.conf num_round=10 device=cuda
"""

from __future__ import annotations

import sys

from wormhole_tpu_torch.apps._runner import parse_cli
from wormhole_tpu_torch.models.gbdt import GbdtConfig, GbdtLearner
from wormhole_tpu_torch.solver.workload import iter_rowblocks


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_cli(GbdtConfig, argv)
    if cfg.bsp:
        raise NotImplementedError(
            "bsp=1 (GBDT over the BSP allreduce ring) waits for the port's "
            "BSP slice; run single-process")
    if cfg.global_mesh:
        raise NotImplementedError(
            "global_mesh=1 (GBDT with rows sharded over several devices) "
            "waits for the port's multi-GPU slice; run single-process")
    lrn = GbdtLearner(cfg, device=device)
    if cfg.task == "pred":
        # xgboost CLI task=pred: load model, write one probability/value
        # per test row to name_pred
        if not cfg.model_in:
            raise ValueError("task=pred needs model_in")
        lrn.load(cfg.model_in)
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
    if cfg.model_out:
        lrn.save(cfg.model_out)
        print(f"saved model to {cfg.model_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
