"""difacto.dmlc: the asynchronous factorization machine (reference
learn/difacto/difacto.cc + config.proto surface), on one device.

  python -m wormhole_tpu_torch.apps.difacto guide/demo.conf dim=8 device=cuda
"""

from __future__ import annotations

import sys

from wormhole_tpu_torch.apps._runner import app_main
from wormhole_tpu_torch.models.difacto import DifactoConfig, DifactoLearner


def make_learner(cfg: DifactoConfig, device="cuda"):
    return DifactoLearner(cfg, device=device)


def main(argv=None) -> int:
    return app_main(DifactoConfig, make_learner, argv)


if __name__ == "__main__":
    sys.exit(main())
