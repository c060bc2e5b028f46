"""Start the port from parameters of the JAX package's learner.

The JAX LinearLearner's state leaves it as numpy arrays (its
``KVStore.to_numpy()``: ``{"w", "z", "n"}`` for FTRL, ``{"w", "n"}`` for
AdaGrad, ``{"w"}`` for SGD). These functions check such a dict against
the port's tables for the config's algo and put it on a device, so both
packages can run from the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.models.linear import LinearConfig, _tables_for


def linear_state_from_numpy(arrays: dict, cfg: LinearConfig,
                            device=None) -> dict[str, torch.Tensor]:
    """The port's state tables for cfg.algo, made from numpy arrays.
    Raises unless the names are exactly the algo's tables and each shape
    is (num_buckets, *tail)."""
    dev = resolve_device(device)
    specs = _tables_for(cfg.algo)
    if set(arrays) != set(specs):
        raise ValueError(f"tables {sorted(arrays)} do not match "
                         f"{sorted(specs)} for algo {cfg.algo!r}")
    state = {}
    for name, spec in specs.items():
        a = np.asarray(arrays[name])
        shape = (cfg.num_buckets, *spec.tail)
        if a.shape != shape:
            raise ValueError(f"table {name}: shape {a.shape} != {shape}")
        state[name] = torch.from_numpy(
            np.array(a, dtype=np.float32)).to(dev, spec.dtype)
    return state


def load_linear_state(learner, arrays: dict) -> None:
    """Copy the JAX learner's parameters into a port LinearLearner's
    tables, in place, after the same checks."""
    state = linear_state_from_numpy(arrays, learner.cfg, learner.device)
    for name, t in state.items():
        learner.store.state[name].copy_(t)
