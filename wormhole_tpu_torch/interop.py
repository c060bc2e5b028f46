"""Start the port from parameters of the JAX package's learners.

The JAX LinearLearner's state leaves it as numpy arrays (its
``KVStore.to_numpy()``: ``{"w", "z", "n"}`` for FTRL, ``{"w", "n"}`` for
AdaGrad, ``{"w"}`` for SGD); the JAX DifactoLearner's as its
``ckpt_store.to_numpy()``: ``{"w", "z", "n", "cnt"}`` over num_buckets and
``{"V", "nV"}`` of shape (v_buckets, dim). These functions check such a
dict against the port's tables for the config and put it on a device, so
both packages can run from the same weights. The two packages draw V's
random init from different generators, so this is how a comparison
starts them equal.
"""

from __future__ import annotations

import numpy as np
import torch

from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.models import difacto, linear


def _state_from_numpy(arrays: dict, specs: dict, rows: dict, what: str,
                      device) -> dict[str, torch.Tensor]:
    """Tables named by specs, made from numpy arrays; table k must have
    shape (rows[k], *specs[k].tail)."""
    dev = resolve_device(device)
    if set(arrays) != set(specs):
        raise ValueError(f"tables {sorted(arrays)} do not match "
                         f"{sorted(specs)} for {what}")
    state = {}
    for name, spec in specs.items():
        a = np.asarray(arrays[name])
        shape = (rows[name], *spec.tail)
        if a.shape != shape:
            raise ValueError(f"table {name}: shape {a.shape} != {shape}")
        state[name] = torch.from_numpy(
            np.array(a, dtype=np.float32)).to(dev, spec.dtype)
    return state


def linear_state_from_numpy(arrays: dict, cfg: linear.LinearConfig,
                            device=None) -> dict[str, torch.Tensor]:
    """The port's state tables for cfg.algo, made from numpy arrays.
    Raises unless the names are exactly the algo's tables and each shape
    is (num_buckets, *tail)."""
    specs = linear._tables_for(cfg.algo)
    return _state_from_numpy(arrays, specs,
                             dict.fromkeys(specs, cfg.num_buckets),
                             f"algo {cfg.algo!r}", device)


def load_linear_state(learner, arrays: dict) -> None:
    """Copy the JAX learner's parameters into a port LinearLearner's
    tables, in place, after the same checks."""
    state = linear_state_from_numpy(arrays, learner.cfg, learner.device)
    for name, t in state.items():
        learner.store.state[name].copy_(t)


def difacto_state_from_numpy(arrays: dict, cfg: difacto.DifactoConfig,
                             device=None) -> dict[str, torch.Tensor]:
    """The port's DiFacto tables (w, z, n, cnt over num_buckets; V, nV of
    shape (v_buckets, dim)), made from numpy arrays. Raises unless the
    names are exactly those and each shape matches."""
    specs = difacto._tables_for(cfg)
    rows = {k: cfg.vb if s.tail else cfg.num_buckets
            for k, s in specs.items()}
    return _state_from_numpy(arrays, specs, rows, "difacto", device)


def load_difacto_state(learner, arrays: dict) -> None:
    """Copy the JAX DifactoLearner's tables into a port DifactoLearner's,
    in place, after the same checks, and resync its count mirror."""
    state = difacto_state_from_numpy(arrays, learner.cfg, learner.device)
    for name, t in state.items():
        learner.ckpt_store.state[name].copy_(t)
    learner.refresh_count_mirror()
