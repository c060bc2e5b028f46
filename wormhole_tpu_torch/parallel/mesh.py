"""Device mesh: Wormhole's worker/server topology over torch.distributed.

The reference launches `-n` worker and `-s` server processes (tracker,
reference doc/common/build.rst:57-71). The JAX package makes the two launch
dimensions the axes of one `jax.sharding.Mesh` of local devices, driven by
one controller. Here the idiom is one process (rank) per device, and the
same two axes are a 2-D `torch.distributed.device_mesh.DeviceMesh`:

- axis "data"  — data parallelism: a global minibatch's rows are split
  across it (the workers);
- axis "model" — parameter sharding: hashed tables are range-sharded
  across it (the servers' key shards).

Ranks are laid out data-major, as the JAX package reshapes its devices to
(D, M): rank r sits at (d, m) = divmod(r, M). Its model group is its row
of the mesh (the M ranks that share its rows), its data group its column
(the D ranks that share its table shard). The collectives that play ZPull
and ZPush are all_reduce calls over those groups (parallel/collectives.py).

A 1x1 mesh made without a process group holds no group at all: learners
take their single-device path on it, as the JAX learners do on a 1x1 mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from wormhole_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (data x model) mesh."""

    num_data: int
    num_model: int
    device: torch.device
    rank: int = 0                      # global rank, data-major
    backend: Optional[str] = None      # "nccl" | "gloo"; None: no group
    device_mesh: object = None         # torch DeviceMesh, None without a group

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.num_data, MODEL_AXIS: self.num_model}

    @property
    def size(self) -> int:
        return self.num_data * self.num_model

    @property
    def coords(self) -> tuple[int, int]:
        """(d, m): this rank's index on the data and the model axis."""
        return divmod(self.rank, self.num_model)

    def index(self, axis: str) -> int:
        return self.coords[0 if axis == DATA_AXIS else 1]

    def group(self, axis: str):
        """The process group of this rank's ranks along `axis`, or None on
        a mesh made without a process group."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def barrier(self) -> None:
        if self.device_mesh is not None:
            dist.barrier()


def check_distinct_devices(backend: str, device_indices) -> None:
    """NCCL refuses two ranks on one GPU. Raise when an NCCL group would
    place two ranks on the same card (`device_indices`: each rank's
    CUDA index, by rank); gloo must be asked for by name there."""
    seen: dict[int, int] = {}
    for r, i in enumerate(int(x) for x in device_indices):
        if backend == "nccl" and i in seen:
            raise ValueError(
                f"ranks {seen[i]} and {r} are both on cuda:{i}: NCCL needs "
                f"one GPU a rank; ask for backend='gloo' by name to share a "
                f"card")
        seen.setdefault(i, r)


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device=None, backend: Optional[str] = None) -> Mesh:
    """Build this rank's (data x model) mesh. Defaults to every rank of
    the process group on the data axis. With num_data * num_model > 1 the
    process group must be initialised with exactly that many ranks; it
    never falls back to one device. `backend` names the group's backend
    when it is not the device's own (gloo for CUDA tensors, as ranks that
    share one card need); otherwise it must be NCCL for CUDA and gloo for
    the CPU."""
    dev = resolve_device(device)
    grouped = dist.is_available() and dist.is_initialized()
    ndev = dist.get_world_size() if grouped else 1
    if num_data is None:
        num_data = ndev // num_model
    need = num_data * num_model
    assert need <= ndev, (
        f"mesh {num_data}x{num_model} needs {need} devices, have {ndev}"
    )
    assert num_data >= 1 and num_model >= 1, (
        f"mesh {num_data}x{num_model} has an empty axis "
        f"({ndev} devices can't fill {num_model} model shards)"
    )
    if not grouped:
        return Mesh(1, 1, dev)
    if need != ndev:
        raise ValueError(
            f"mesh {num_data}x{num_model} needs a process group of {need} "
            f"ranks; this one has {ndev}")
    have = dist.get_backend()
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if have != want:
        raise ValueError(
            f"the process group's backend is {have}, the mesh on {dev.type} "
            f"wants {want}" + ("" if backend else
                               " (pass backend= to ask for another by name)"))
    if dev.type == "cuda":
        # before the DeviceMesh, which otherwise picks rank % cards
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if want == "nccl":
        if dev.type != "cuda":
            raise ValueError("an NCCL mesh needs CUDA devices")
        idx = torch.zeros(ndev, dtype=torch.int64, device=dev)
        idx[dist.get_rank()] = dev.index
        dist.all_reduce(idx)
        check_distinct_devices(want, idx.tolist())
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (num_data, num_model),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(num_data, num_model, dev, dist.get_rank(), want, dm)


def single_device_mesh(device=None) -> Mesh:
    """1x1 mesh on one device with no process group: single-device paths."""
    return Mesh(1, 1, resolve_device(device))


def table_range(mesh: Mesh, num_buckets: int) -> tuple[int, int]:
    """[lo, hi): the buckets this rank's model shard holds (the JAX
    package's table_sharding, P(model))."""
    nb = num_buckets // mesh.num_model
    m = mesh.index(MODEL_AXIS)
    return m * nb, (m + 1) * nb


def batch_range(mesh: Mesh, num_rows: int) -> tuple[int, int]:
    """[lo, hi): the rows of a global batch this rank's data shard holds
    (the JAX package's batch_sharding, P(data))."""
    rows = num_rows // mesh.num_data
    d = mesh.index(DATA_AXIS)
    return d * rows, (d + 1) * rows
