"""linear.dmlc: async-SGD sparse logistic regression (reference
learn/linear/linear.cc + config.proto surface), on one device.

  python -m wormhole_tpu_torch.apps.linear guide/demo.conf lambda_l1=4 device=cuda
"""

from __future__ import annotations

import sys

from wormhole_tpu_torch.apps._runner import app_main
from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner


def make_learner(cfg: LinearConfig, device="cuda"):
    return LinearLearner(cfg, device=device)


def main(argv=None) -> int:
    return app_main(LinearConfig, make_learner, argv)


if __name__ == "__main__":
    sys.exit(main())
