"""difacto.dmlc: the asynchronous factorization machine (reference
learn/difacto/difacto.cc + config.proto surface), on one device, under
torch.distributed.run on a (data x model) mesh of the launch's ranks, as
a role of the PS launcher, or with global_mesh=1 under the launcher (the
workers as the ranks of one process group).

  python -m wormhole_tpu_torch.apps.difacto guide/demo.conf dim=8 device=cuda
  python -m torch.distributed.run --nproc-per-node 4 \
      -m wormhole_tpu_torch.apps.difacto guide/demo.conf model_shards=2
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 2 -s 2 -- \
      python -m wormhole_tpu_torch.apps.difacto guide/demo.conf device=cuda
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 2 -s 0 -- \
      python -m wormhole_tpu_torch.apps.difacto guide/demo.conf global_mesh=1
"""

from __future__ import annotations

import sys

import torch.distributed as dist

from wormhole_tpu_torch.apps._runner import app_main
from wormhole_tpu_torch.models.difacto import DifactoConfig, DifactoLearner
from wormhole_tpu_torch.parallel.mesh import make_mesh


def make_learner(cfg: DifactoConfig, device="cuda", mesh=None):
    """The learner on `mesh` (the global mesh's), else on the launch's
    ranks as a mesh (one device without a group); model_shards > 1
    splits both table groups over the mesh "model" axis."""
    if mesh is not None:
        return DifactoLearner(cfg, mesh=mesh)
    shards = max(int(cfg.model_shards), 1)
    ndev = dist.get_world_size() if dist.is_initialized() else 1
    if shards > ndev:
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"[difacto] model_shards={shards} > {ndev} devices; "
                  f"clamping to {ndev}", flush=True)
        shards = ndev
    return DifactoLearner(cfg, mesh=make_mesh(num_model=shards,
                                              device=device))


def main(argv=None) -> int:
    return app_main(DifactoConfig, make_learner, argv, ranks=True)


if __name__ == "__main__":
    sys.exit(main())
