"""linear.dmlc: async-SGD sparse logistic regression (reference
learn/linear/linear.cc + config.proto surface), on one device, under
torch.distributed.run on a (data x model) mesh of the launch's ranks, as
a role of the PS launcher (workers training one shared model through the
server group), or with global_mesh=1 under the launcher (the workers as
the ranks of one process group, apps/_runner.py _global_train).

  python -m wormhole_tpu_torch.apps.linear guide/demo.conf lambda_l1=4 device=cuda
  python -m torch.distributed.run --nproc-per-node 4 \
      -m wormhole_tpu_torch.apps.linear guide/demo.conf model_shards=2
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 2 -s 1 -- \
      python -m wormhole_tpu_torch.apps.linear guide/demo.conf device=cuda
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 2 -s 0 -- \
      python -m wormhole_tpu_torch.apps.linear guide/demo.conf global_mesh=1
"""

from __future__ import annotations

import sys

import torch.distributed as dist

from wormhole_tpu_torch.apps._runner import app_main
from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
from wormhole_tpu_torch.parallel.mesh import make_mesh


def make_learner(cfg: LinearConfig, device="cuda", mesh=None):
    """The learner on `mesh` (the global mesh's), else on the launch's
    ranks as a mesh; model_shards > 1 splits the state tables over the
    mesh "model" axis."""
    if mesh is not None:
        return LinearLearner(cfg, mesh=mesh)
    shards = max(int(cfg.model_shards), 1)
    ndev = dist.get_world_size() if dist.is_initialized() else 1
    if shards > ndev:
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"[linear] model_shards={shards} > {ndev} devices; "
                  f"clamping to {ndev}", flush=True)
        shards = ndev
    return LinearLearner(cfg, mesh=make_mesh(num_model=shards,
                                             device=device))


def main(argv=None) -> int:
    return app_main(LinearConfig, make_learner, argv, ranks=True)


if __name__ == "__main__":
    sys.exit(main())
