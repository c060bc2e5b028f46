"""The global mesh: every worker of a launch as one rank of one
torch.distributed process group.

The PS data plane (runtime/ps_server.py) shares a model across worker
processes through TCP push and pull, the reference's ps-lite
architecture. This module is the other composition, the JAX package's
parallel/multihost.py: the `-n` workers of a launch (launcher/dmlc_tpu.py,
`global_mesh=1`) join ONE process group at the coordinator address the
launcher exports (WH_COORD_URI) and build one (num_workers x 1) mesh over
it (parallel/mesh.py), so every train step is a collective program and
gradients sum by all_reduce instead of through the TCP servers. Where the
JAX package calls `jax.distributed.initialize` and assembles global
arrays, a rank here keeps its own rows as they are: no global array
exists, and the collectives of the learner's step (W1, W2, the level
histograms) sum over the group.

Every rank runs the same steps in lockstep; each feeds minibatch /
num_workers rows a step from its stable slice of the file parts
(`rank_parts`, the reference's RowBlockIter(rank, world) split,
kmeans.cc:149-154), and the end of a pass is itself a collective fact: a
step whose global example count is zero means every rank has drained
(apps/_runner.py `_global_train`).

Backend and device (`init_from_env`): NCCL when every rank has a card of
its own (`cuda:(rank mod device_count)`), gloo when ranks share a card
(NCCL refuses two ranks on one GPU) or run with device=cpu. Nothing falls
back: a group that fails to start fails the worker.
"""

from __future__ import annotations

import contextlib
import datetime

import numpy as np

# how long a rank waits for a peer at the rendezvous and, on gloo, in a
# collective: a rank that never arrives fails its peers instead of
# hanging them
GROUP_TIMEOUT_S = 120.0


def group_backend(device, num_workers: int) -> tuple[str, object]:
    """(backend, this rank's device) for a group of `num_workers` ranks
    whose workers asked for `device`, before the rank is known: NCCL when
    the host has a card for every rank, gloo when they would share one
    or run on the CPU. The device's index is filled in by init_from_env."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device=cpu to run "
                           "the global mesh on the CPU")
    return ("nccl" if torch.cuda.device_count() >= num_workers
            else "gloo"), dev


def init_from_env(env, device="cuda", timeout: float = GROUP_TIMEOUT_S):
    """Join the process group the launcher described (workers only): the
    `env.num_workers` ranks meet at tcp://{env.coord_uri}, rank
    `env.rank` (the JAX package's jax.distributed.initialize). Returns
    (backend, device): NCCL on `cuda:(rank mod device_count)` when every
    rank has a card of its own, else gloo (on that card, or on the CPU
    with device=cpu). Prints them as the worker's first line. A one-rank
    launch forms a group of one; the JAX package's runs without one."""
    import torch
    import torch.distributed as dist

    if not getattr(env, "coord_uri", ""):
        raise RuntimeError("global_mesh needs WH_COORD_URI (launch the "
                           "workers with launcher/dmlc_tpu.py)")
    backend, dev = group_backend(device, env.num_workers)
    if dev.type == "cuda":
        dev = torch.device("cuda", env.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    print(f"[global-mesh] rank {env.rank} of {env.num_workers}: backend "
          f"{backend}, device {dev}", flush=True)
    dist.init_process_group(
        backend, init_method=f"tcp://{env.coord_uri}",
        world_size=env.num_workers, rank=env.rank,
        timeout=datetime.timedelta(seconds=timeout))
    return backend, dev


def _group_device():
    """Where a host scalar goes for a collective: the current card on
    NCCL, the CPU on gloo."""
    import torch
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_batch(local_np: np.ndarray, rank: int, local_rows: int,
                 offset_rows: bool = False) -> np.ndarray:
    """This rank's local rows of a global batch, as they are (the JAX
    package assembles a global array from them; the port keeps each
    rank's rows on its own device). With `offset_rows` the values are
    row ids and move into the rank's row range of the global batch
    (rank-ordered concatenation: rank r holds rows [r * local_rows,
    (r + 1) * local_rows))."""
    a = np.ascontiguousarray(local_np)
    if offset_rows:
        a = a + a.dtype.type(rank * local_rows)
    return a


def global_coo_batch(db, rank: int, local_rows: int,
                     with_label: bool = True) -> tuple:
    """This rank's DeviceBatch as its part of the global batch: (seg, idx,
    val[, label], mask) numpy arrays, seg offset into the rank's global
    row range (padding entries carry val=0, so their offsets are inert)."""
    out = [global_batch(db.seg, rank, local_rows, offset_rows=True),
           global_batch(db.idx, rank, local_rows),
           global_batch(db.val, rank, local_rows)]
    if with_label:
        out.append(global_batch(db.label, rank, local_rows))
    out.append(global_batch(db.row_mask, rank, local_rows))
    return tuple(out)


def load_replicated(store, arrays: dict) -> None:
    """Install whole host tables into a store that every rank holds whole
    (its tables replicated over the global mesh; each rank passes the
    full arrays). A combined store (DiFacto's two table groups) routes
    each table to the sub-store that owns it, then fires its on_load."""
    subs = getattr(store, "stores", None)
    known = (set().union(*(s.state for s in subs)) if subs is not None
             else set(store.state))
    unknown = set(arrays) - known
    if unknown:
        raise ValueError(f"unknown tables {sorted(unknown)}")
    store.from_numpy(arrays)


def fetch_replicated(t) -> np.ndarray:
    """Host copy of a tensor every rank holds whole (a replicated table):
    purely local."""
    return t.detach().cpu().numpy()


def fetch_local_rows(t, lo: int, hi: int) -> np.ndarray:
    """Host copy of rows [lo, hi) of a per-row tensor that every rank
    holds whole (a batch's margins gathered over the data axis): the
    range a rank contributed through global_coo_batch."""
    return t[lo:hi].detach().cpu().numpy()


def exit_barrier(client=None, world: int = 0,
                 timeout: float = 120.0) -> None:
    """Rendezvous before process exit, then leave the group: a host-level
    barrier (the scheduler's TCP barrier; a collective cannot order the
    teardown) gets every worker to the same point, then each destroys
    its process group. Bounded: a peer that died before arriving must
    not hang the survivors."""
    import torch.distributed as dist

    if client is not None and world > 1:
        try:
            client.barrier("gm_exit", world, timeout=timeout)
        except Exception:
            pass
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:
            pass


@contextlib.contextmanager
def worker_session(env, device="cuda"):
    """The global-mesh worker frame shared by every app: register with
    the scheduler and start liveness pings before the blocking
    rendezvous (a slow peer must not get this worker swept as dead
    mid-start), join the group (init_from_env), and tear down on every
    exit path, exceptions included: exit barrier, group destroyed,
    deregistration. A worker that fails skips the barrier and leaves the
    group at once, so a peer waiting in a collective fails instead of
    waiting out the group's timeout. Yields (client, device)."""
    from wormhole_tpu_torch.runtime.tracker import (LivenessPinger,
                                                    SchedulerClient)

    client = SchedulerClient(env.scheduler_uri, f"worker-{env.rank}")
    client.register()
    pinger = LivenessPinger(client)
    failed = True
    try:
        _, dev = init_from_env(env, device)
        yield client, dev
        failed = False
    finally:
        exit_barrier(None if failed else client, env.num_workers)
        pinger.stop()
        try:
            client.call(op="bye")
        except Exception:
            pass


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


def _global_scalar(value: int, op) -> int:
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_group_device())
    dist.all_reduce(t, op=op)
    return int(t.item())


def global_scalar_sum(local_value: int) -> int:
    """Sum of a per-rank host integer over the group (all_reduce SUM)."""
    import torch.distributed as dist

    return _global_scalar(local_value, dist.ReduceOp.SUM)


def global_scalar_max(local_value: int) -> int:
    """Max of a per-rank host integer over the group (all_reduce MAX):
    the Allreduce<Max> of the reference BSP apps (lbfgs.cc:107-113)."""
    import torch.distributed as dist

    return _global_scalar(local_value, dist.ReduceOp.MAX)
