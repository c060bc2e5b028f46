"""Work split of a multi-process launch: each rank's stable slice of the
file parts, and the empty block of a rank that holds none.

The host part of the JAX package's parallel/multihost.py, under its
module name: `rank_parts` and `empty_rowblock`, which the BSP apps
(runtime/allreduce.py rings) and the global mesh share. The rest of that
module (one SPMD program over every process's devices, its global
batches, scalars and exit barrier) needs `jax.distributed` and comes with
the port's global mesh (ROADMAP.md Queue A item 5.4).
"""

from __future__ import annotations

import numpy as np


def rank_parts(pattern: str, num_parts_per_file: int, env) -> list:
    """This rank's stable slice of (file, part) work items — the
    reference's RowBlockIter(rank, world) split (kmeans.cc:149-154)."""
    from wormhole_tpu_torch.solver.workload import match_file

    files = match_file(pattern)
    if not files:
        raise FileNotFoundError(f"no files match {pattern}")
    parts = [(f, k) for f in files for k in range(num_parts_per_file)]
    return parts[env.rank :: env.num_workers]


def empty_rowblock():
    """The masked-empty block a drained rank feeds into lockstep steps."""
    from wormhole_tpu_torch.data.rowblock import RowBlock

    return RowBlock(label=np.zeros(0, np.float32),
                    offset=np.zeros(1, np.int64),
                    index=np.zeros(0, np.uint64), value=None, weight=None)
