"""Collective primitives: rabit's API surface over torch.distributed.

The reference's BSP apps call rabit::Allreduce<Sum/Max>, Broadcast and
checkpoint primitives (reference learn/solver/lbfgs.h:172,252,302,
learn/kmeans/kmeans.cc:160-190). The JAX package runs them as lax
collectives under shard_map; here each is one torch.distributed call over
the process group of one mesh axis, made by every rank of that group.

Only all_reduce (sum, max, min) and broadcast are used: gloo, which runs
the CPU tests and the ranks that share one card, offers only those two for
CUDA tensors. A gather of rows is an all_reduce into a zero-filled buffer
that each rank fills at its own slot (x + 0.0 == x, so the rows come back
bit for bit). On a mesh without a process group every call returns its
input.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from wormhole_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def _allreduce(x: torch.Tensor, mesh: Mesh, axis: str, op) -> torch.Tensor:
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def allreduce_sum(x: torch.Tensor, mesh: Mesh,
                  axis: str = DATA_AXIS) -> torch.Tensor:
    """Sum x over the ranks along `axis`, in place; returns x."""
    return _allreduce(x, mesh, axis, dist.ReduceOp.SUM)


def allreduce_max(x: torch.Tensor, mesh: Mesh,
                  axis: str = DATA_AXIS) -> torch.Tensor:
    return _allreduce(x, mesh, axis, dist.ReduceOp.MAX)


def allreduce_min(x: torch.Tensor, mesh: Mesh,
                  axis: str = DATA_AXIS) -> torch.Tensor:
    return _allreduce(x, mesh, axis, dist.ReduceOp.MIN)


def broadcast(x: torch.Tensor, mesh: Mesh, root: int = 0,
              axis: str = DATA_AXIS) -> torch.Tensor:
    """Every rank along `axis` gets the value of the one at index `root`
    on it (rabit::Broadcast), in place; returns x."""
    group = mesh.group(axis)
    if group is not None:
        dist.broadcast(x, group=group,
                       src=dist.get_global_rank(group, root))
    return x


def gather_rows(x: torch.Tensor, mesh: Mesh,
                axis: str = DATA_AXIS) -> torch.Tensor:
    """The ranks' x concatenated on dim 0 in axis order, on every rank
    along `axis`: an all_reduce of a zero-filled (size, *x.shape) buffer
    that this rank fills at its own index."""
    size = mesh.shape[axis]
    if mesh.group(axis) is None:
        return x
    buf = x.new_zeros((size, *x.shape))
    buf[mesh.index(axis)] = x
    return allreduce_sum(buf, mesh, axis).reshape(size * x.shape[0],
                                                  *x.shape[1:])


class Communicator:
    """Host-level BSP collectives over one mesh axis: rabit's blocking
    Allreduce for host-orchestrated solver loops."""

    def __init__(self, mesh: Mesh, axis: str = DATA_AXIS):
        self.mesh = mesh
        self.axis = axis

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    def allreduce_shards(self, x: torch.Tensor) -> torch.Tensor:
        """Sum per-shard contributions: x's leading dim is the axis size,
        one slice a shard, and this rank contributes its own slice; returns
        the reduced (*tail) tensor on every rank (rabit::Allreduce<Sum>)."""
        if x.shape[0] != self.size:
            raise ValueError(f"leading dim {x.shape[0]} != axis size "
                             f"{self.size}")
        if self.mesh.group(self.axis) is None:
            return x.sum(0)
        mine = x[self.mesh.index(self.axis)].clone()
        return allreduce_sum(mine, self.mesh, self.axis)
