"""kmeans.dmlc: spherical k-means (reference learn/kmeans/kmeans.cc), on
one device. Rabit-style key=value args:

  python -m wormhole_tpu_torch.apps.kmeans data=... num_clusters=16 \
      max_iter=10 model_out=centroids.txt device=cuda

Writes the centroids as text, one row a line. global_mesh=1 (several
processes over one device mesh) raises until the port's multi-GPU slice.
"""

from __future__ import annotations

import sys

from wormhole_tpu_torch.apps._runner import parse_cli, refuse_roles
from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # the reference kmeans takes data= (kmeans.cc SetParam); accept both
    argv = [a.replace("data=", "train_data=", 1)
            if a.startswith("data=") else a for a in argv]
    cfg, device = parse_cli(KmeansConfig, argv)
    refuse_roles("kmeans", "its multi-process mode, the global mesh, waits "
                 "for ROADMAP.md Queue A item 5.4; run without the launcher")
    if cfg.global_mesh:
        raise NotImplementedError(
            "global_mesh=1 (k-means with rows sharded over several "
            "devices) waits for the port's multi-GPU slice; run "
            "single-process")
    objv = KmeansLearner(cfg, device=device).run()  # run writes model_out
    print(f"final cosine objective: {objv:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
