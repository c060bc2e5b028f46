"""File parts of a data pattern as a flat stream, for the batch learners.

The JAX package drains a one-shot WorkloadPool here (solver/workload.py
iter_parts, iter_rowblocks), which hands out its parts in random order.
One process needs no pool: the port takes the parts in file order, so a
run over several parts sees its rows in the same order every time.
"""

from __future__ import annotations

import dataclasses

from wormhole_tpu_torch.data.minibatch import MinibatchIter
from wormhole_tpu_torch.solver.minibatch_solver import list_parts


@dataclasses.dataclass
class File:
    """One virtual part of one file (workload.h File)."""

    filename: str
    format: str = "libsvm"
    part: int = 0
    num_parts: int = 1


def iter_parts(pattern: str, num_parts_per_file: int = 1,
               fmt: str = "libsvm", node: str = "loader"):
    """Yield the File parts `pattern` expands to, in file order. `node`
    names the consumer in the JAX package's pool and is kept for
    signature parity."""
    for filename, part, num_parts in list_parts(pattern, num_parts_per_file):
        yield File(filename, fmt, part, num_parts)


def iter_rowblocks(pattern: str, num_parts_per_file: int = 1,
                   fmt: str = "libsvm", minibatch_size: int = 65536,
                   node: str = "loader", seed: int = 0, device=None):
    """Yield the RowBlocks of every part of `pattern`, minibatch_size rows
    at a time (the reference's RowBlockIter(rank, world) path), parsed on
    `device` (None: the CPU's parser)."""
    for f in iter_parts(pattern, num_parts_per_file, fmt, node):
        yield from MinibatchIter(f.filename, f.part, f.num_parts, f.format,
                                 minibatch_size=minibatch_size, seed=seed,
                                 device=device)
