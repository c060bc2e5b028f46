"""KVStore: the parameter server's state tables, on one device or sharded.

ps-lite's server group (reference OnlineServer + per-key Handle state,
learn/linear/async_sgd.h:200-226; key sharding across `-s` servers)
becomes a set of fixed-capacity hashed tables held as torch tensors. On a
mesh (parallel/mesh.py) each rank holds only its model shard's contiguous
bucket range, replicated over the data axis, as the JAX package's
P(model) sharding lays them out:

- ZPull -> a gather of bucket entries inside the learner's step;
- ZPush -> a scatter-add of per-nonzero contributions into table layout;
- server Handle -> the learner's update, applied to the tables IN PLACE
  (the JAX package threads immutable arrays through jitted steps);
- message filters (fixed-point/compressing transfer,
  async_sgd.h:290-301) -> quantize_push on the pushed gradient.

Save/load uses one npz per model shard with the reference's part naming
(see utils/checkpoint.py). `to_numpy` and `from_numpy` speak of the whole
table on every rank: the shards are summed into it on the way out (one
all_reduce over the model axis) and sliced from it on the way in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.parallel import collectives
from wormhole_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, table_range


# the PS plane's row traffic between the card and the host: one per
# gather (device -> host) and one per scatter (host -> device)
_D2H = _obs.REGISTRY.counter("kvstore.d2h_copies")
_H2D = _obs.REGISTRY.counter("kvstore.h2d_copies")


@dataclasses.dataclass
class TableSpec:
    """One named state table: shape = (num_buckets, *tail).

    `wire_cap` floors the wire encoding of this table's push deltas:
    "bf16" means an int8/int4 wire still ships this table at bf16. Second
    moment and count accumulators (FTRL n) need it: their deltas are
    nonnegative with a huge dynamic range, which an absmax group code
    would quantize at the hot neighbour's granularity."""

    tail: tuple = ()
    dtype: torch.dtype = torch.float32
    # (generator, shape, dtype, device) -> tensor; zeros if None
    init: Optional[Callable] = None
    wire_cap: str = ""  # "" (no floor) or "bf16"


class KVStore:
    """Hashed parameter/optimizer state tables: the whole table on one
    device, or this rank's model shard of it on a mesh."""

    def __init__(self, num_buckets: int, specs: dict[str, TableSpec],
                 device=None, seed: int = 0, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.mesh = mesh
        self.num_buckets = int(num_buckets)
        self.specs = dict(specs)
        M = 1 if mesh is None else mesh.num_model
        if self.num_buckets % M:
            raise ValueError(f"num_buckets {num_buckets} must divide over "
                             f"{M} model shards")
        # [lo, hi): the buckets this rank holds
        self.lo, self.hi = ((0, self.num_buckets) if mesh is None
                            else table_range(mesh, self.num_buckets))
        gen = torch.Generator(device="cpu").manual_seed(seed)
        self.state: dict[str, torch.Tensor] = {}
        for name, spec in self.specs.items():
            shape = (self.num_buckets, *spec.tail)
            if spec.init is None:
                arr = torch.zeros((self.hi - self.lo, *spec.tail),
                                  dtype=spec.dtype, device=self.device)
            else:  # drawn whole, so every shard count holds the same values
                arr = spec.init(gen, shape, spec.dtype, self.device)[
                    self.lo:self.hi].clone()
            self.state[name] = arr

    @property
    def sharded(self) -> bool:
        return self.hi - self.lo < self.num_buckets

    # -- sparse host<->device row access ------------------------------------
    def _index(self, idx) -> torch.Tensor:
        if self.sharded:
            raise NotImplementedError(
                "row access by global bucket id serves the PS plane, which "
                "runs unsharded stores")
        return torch.as_tensor(np.asarray(idx, np.int64), device=self.device)

    def gather_rows(self, name: str, idx: np.ndarray) -> np.ndarray:
        """Fetch rows `idx` of a table to host: a device gather plus an
        O(touched) transfer, never a full-table copy."""
        _D2H.inc()
        return self.state[name][self._index(idx)].cpu().numpy()

    def gather_rows_multi(self, names: list[str],
                          idx: np.ndarray) -> dict[str, np.ndarray]:
        """gather_rows for several same-height tables sharing one index
        set (FTRL's z and n always do), with one index transfer."""
        i = self._index(idx)
        _D2H.inc(len(names))
        return {k: self.state[k][i].cpu().numpy() for k in names}

    def scatter_rows(self, name: str, idx: np.ndarray,
                     vals: np.ndarray) -> None:
        """Overwrite rows `idx` with `vals`, in place on the device."""
        if np.asarray(idx).size == 0:
            return
        t = self.state[name]
        _H2D.inc()
        # torch.tensor copies, so a read-only array (a decoded wire
        # frame) is fine
        t[self._index(idx)] = torch.tensor(np.asarray(vals), dtype=t.dtype,
                                           device=self.device)

    def zero_init_names(self) -> set[str]:
        """Tables created as zeros (spec.init is None)."""
        return {k for k, s in self.specs.items() if s.init is None}

    def wire_cap_names(self) -> set[str]:
        """Tables whose push deltas must never drop below bf16 on the
        wire (see TableSpec.wire_cap)."""
        return {k for k, s in self.specs.items() if s.wire_cap}

    # -- host-side views ----------------------------------------------------
    def nnz(self, name: str = "w") -> int:
        """|w|_0 of the whole table — the model-sparsity column of the
        progress row."""
        n = torch.count_nonzero(self.state[name]).reshape(1)
        if self.mesh is not None:
            collectives.allreduce_sum(n, self.mesh, MODEL_AXIS)
        return int(n)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The whole tables, on every rank."""
        if not self.sharded:
            return {k: v.cpu().numpy() for k, v in self.state.items()}
        out = {}
        for k, v in self.state.items():
            full = v.new_zeros((self.num_buckets, *v.shape[1:]))
            full[self.lo:self.hi] = v
            out[k] = collectives.allreduce_sum(
                full, self.mesh, MODEL_AXIS).cpu().numpy()
        return out

    def from_numpy(self, arrays: dict[str, np.ndarray]) -> None:
        """Copy whole host tables into the tables (this rank's shard of
        them), in place."""
        for k, v in arrays.items():
            if k not in self.state:
                raise ValueError(f"unknown table {k}")
            want = (self.num_buckets, *self.state[k].shape[1:])
            if tuple(v.shape) != want:
                raise ValueError(f"table {k}: loaded shape {v.shape} != "
                                 f"{want}")
            self.state[k].copy_(torch.from_numpy(
                np.asarray(v)[self.lo:self.hi]))


def quantize_push(grad, nbytes: int = 0, mesh: Optional[Mesh] = None):
    """Transfer-filter parity (fixed_bytes knob, reference
    config.proto:126-133): round the pushed gradient to a lower precision
    before aggregation. 0 = off, 2 = bfloat16 (half to even), 1 = int8
    with a per-array absmax scale (torch.round is half to even too). With
    `mesh`, grad is this rank's model shard of the table and the scale is
    the whole table's (its absmax over the model axis), as the JAX
    package's sharded array takes it."""
    if nbytes == 0:
        return grad
    if nbytes >= 2:
        return grad.to(torch.bfloat16).to(grad.dtype)
    amax = torch.max(torch.abs(grad)).reshape(1)
    if mesh is not None:
        collectives.allreduce_max(amax, mesh, MODEL_AXIS)
    scale = torch.clamp(amax[0], min=1e-12) / 127.0
    q = torch.clamp(torch.round(grad / scale), -127, 127).to(torch.int8)
    return q.to(grad.dtype) * scale
