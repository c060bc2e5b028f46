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

`STATS` counts this process's all_reduce calls and their host-clock
seconds (gloo returns when the sum is back, so that is its cost; on NCCL
it is the enqueue only): the global mesh's workers print them at exit.
`GroupComm` gives the L-BFGS solver BspWorker.allreduce's interface over
the whole process group.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from wormhole_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

STATS = {"allreduce_calls": 0, "allreduce_s": 0.0}


def _timed_all_reduce(x: torch.Tensor, op, group=None) -> None:
    t = time.perf_counter()
    dist.all_reduce(x, op=op, group=group)
    STATS["allreduce_calls"] += 1
    STATS["allreduce_s"] += time.perf_counter() - t


def _allreduce(x: torch.Tensor, mesh: Mesh, axis: str, op) -> torch.Tensor:
    group = mesh.group(axis)
    if group is not None and mesh.shape[axis] > 1:
        _timed_all_reduce(x, op, group)
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


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class GroupComm:
    """runtime/allreduce.py BspWorker's allreduce interface over the
    default process group (the global mesh's, or torch.distributed.run's),
    for host-orchestrated solvers (solver/lbfgs.py `comm`): a host array
    reduced in float32, every rank returning the same array. The group
    has no respawn, so checkpoint() keeps nothing and load_checkpoint()
    finds nothing."""

    def __init__(self, device=None):
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl"
                      else torch.device("cpu"))
        self.device = torch.device(device)

    def allreduce(self, x, op: str = "sum") -> np.ndarray:
        a = np.asarray(x, np.float32)
        t = torch.from_numpy(np.array(a.ravel())).to(self.device)
        _timed_all_reduce(t, _OPS[op])
        return t.cpu().numpy().reshape(a.shape)

    def checkpoint(self, state: dict) -> None:
        pass

    def load_checkpoint(self):
        return None
