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

The GBDT model is host state: the arrays of the JAX learner's model file
(``edges``, ``dim``, ``max_depth``, ``num_round``, ``objective``,
``base_score`` and the four stacked tree arrays). ``gbdt_state_from_numpy``
checks them and ``load_gbdt_state`` puts them into a port GbdtLearner,
whose own ``save`` writes the same keys: each package loads the other's
file.
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


_GBDT_TREE_DTYPES = {"split_feat": np.int32, "split_bin": np.int32,
                     "is_split": np.bool_, "leaf_value": np.float32}
_GBDT_SCALARS = ("dim", "max_depth", "num_round", "objective", "base_score")


def gbdt_state_from_numpy(arrays: dict) -> dict:
    """The GBDT model held by a JAX model file's arrays, checked: scalars
    `dim`, `max_depth`, `num_round`, `base_score`, the `objective` string,
    `edges` as (dim, max_bin - 1) f32 and `trees`, the four arrays of
    shape (num_round, 2^(max_depth + 1) - 1). Raises unless the names are
    exactly the model file's and every shape and type fits."""
    want = {"edges", *_GBDT_SCALARS, *_GBDT_TREE_DTYPES}
    if set(arrays) != want:
        raise ValueError(f"arrays {sorted(arrays)} do not match a GBDT "
                         f"model's {sorted(want)}")
    dim, depth, rounds = (int(arrays[k]) for k in
                          ("dim", "max_depth", "num_round"))
    edges = np.asarray(arrays["edges"])
    if edges.ndim != 2 or edges.shape[0] != dim or edges.dtype != np.float32 \
            or not 1 <= edges.shape[1] <= 255:
        raise ValueError(f"edges: {edges.dtype} {edges.shape}, expected "
                         f"float32 ({dim}, max_bin - 1) with max_bin <= 256")
    trees = {}
    shape = (rounds, 2 ** (depth + 1) - 1)
    for name, dtype in _GBDT_TREE_DTYPES.items():
        a = np.asarray(arrays[name])
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(f"tree array {name}: {a.dtype} {a.shape}, "
                             f"expected {np.dtype(dtype)} {shape}")
        trees[name] = np.array(a)
    if trees["split_feat"].size and not (
            0 <= trees["split_feat"].min()
            and trees["split_feat"].max() < dim):
        raise ValueError("split_feat names a feature outside [0, dim)")
    return {"edges": np.array(edges), "dim": dim, "max_depth": depth,
            "num_round": rounds,
            "objective": bytes(arrays["objective"]).decode(),
            "base_score": float(arrays["base_score"]), "trees": trees}


def load_gbdt_state(learner, arrays: dict) -> None:
    """Put a GBDT model file's arrays (the JAX learner's or the port's)
    into a port GbdtLearner after the same checks: its bin edges, its
    trees, and the config fields the model fixes."""
    st = gbdt_state_from_numpy(arrays)
    learner.edges = st["edges"]
    for k in _GBDT_SCALARS:
        setattr(learner.cfg, k, st[k])
    learner.trees = st["trees"]
