"""Start the port from parameters of the JAX package's learners.

The JAX LinearLearner's state leaves it as numpy arrays (its
``KVStore.to_numpy()``: ``{"w", "z", "n"}`` for FTRL, ``{"w", "n"}`` for
AdaGrad, ``{"w"}`` for SGD); the JAX DifactoLearner's as its
``ckpt_store.to_numpy()``: ``{"w", "z", "n", "cnt"}`` over num_buckets and
``{"V", "nV"}`` of shape (v_buckets, dim). These functions check such a
dict against the port's tables for the config and put it on a device, so
both packages can run from the same weights. The two packages draw V's
random init from different generators, so this is how a comparison
starts them equal. A learner on a mesh takes the JAX package's whole
tables too: each rank keeps its model shard's rows of them.

The GBDT model is host state: the arrays of the JAX learner's model file
(``edges``, ``dim``, ``max_depth``, ``num_round``, ``objective``,
``base_score`` and the four stacked tree arrays). ``gbdt_state_from_numpy``
checks them and ``load_gbdt_state`` puts them into a port GbdtLearner,
whose own ``save`` writes the same keys: each package loads the other's
file. A GBDT learner on a mesh holds the same host state on every rank.

The batch learners' state is small and host-made: k-means' centroids
(``kmeans_state_from_numpy``, from a JAX ``state.npz`` or text model) and
L-BFGS's vectors (``lbfgs_state_from_numpy``, from a JAX
``lbfgs_state.npz`` or ``model_out``). A JAX vector may carry zero
padding past the objective's last slot, which a multi-device mesh left;
the port strips it.
"""

from __future__ import annotations

import numpy as np
import torch

from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.models import difacto, linear
from wormhole_tpu_torch.parallel.mesh import table_range


def _state_from_numpy(arrays: dict, specs: dict, rows: dict, what: str,
                      device, keep=slice(None)) -> dict[str, torch.Tensor]:
    """Tables named by specs, made from numpy arrays; table k must have
    shape (rows[k], *specs[k].tail). Only rows `keep` go to the device."""
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
            np.array(a[keep], dtype=np.float32)).to(dev, spec.dtype)
    return state


def linear_state_from_numpy(arrays: dict, cfg: linear.LinearConfig,
                            device=None, mesh=None) -> dict[str, torch.Tensor]:
    """The port's state tables for cfg.algo, made from numpy arrays (on a
    mesh, this rank's model shard of them). Raises unless the names are
    exactly the algo's tables and each shape is (num_buckets, *tail)."""
    specs = linear._tables_for(cfg.algo)
    keep = slice(None)
    if mesh is not None:
        keep = slice(*table_range(mesh, cfg.num_buckets))
        device = mesh.device
    return _state_from_numpy(arrays, specs,
                             dict.fromkeys(specs, cfg.num_buckets),
                             f"algo {cfg.algo!r}", device, keep)


def load_linear_state(learner, arrays: dict) -> None:
    """Copy the JAX learner's parameters into a port LinearLearner's
    tables (its model shard's rows on a mesh), in place, after the same
    checks."""
    state = linear_state_from_numpy(arrays, learner.cfg, learner.device,
                                    learner.mesh)
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
    """Copy the JAX DifactoLearner's tables into a port DifactoLearner's
    (on a mesh, this rank's shard of each), in place, after the same
    checks, and resync its count mirror."""
    state = difacto_state_from_numpy(arrays, learner.cfg, learner.device)
    for name, t in state.items():
        sub = learner.store if name in learner.store.state else \
            learner.vstore
        sub.state[name].copy_(t[sub.lo:sub.hi])
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


def kmeans_state_from_numpy(arrays, cfg, device=None) -> torch.Tensor:
    """The (num_clusters, dim) f32 centroids on `device`, from a k-means
    state file's arrays (a dict with ``centroids``, as ``state.npz``
    holds them) or from the rows of a text model (an array, as
    ``np.loadtxt`` reads it). Raises unless the shape fits cfg."""
    C = np.asarray(arrays["centroids"] if isinstance(arrays, dict)
                   else arrays)
    if C.ndim == 1:  # one centroid a line: a one-row text model
        C = C[None, :]
    want = (cfg.num_clusters, cfg.dim)
    if C.shape != want:
        raise ValueError(f"centroids of shape {C.shape}, expected {want} "
                         f"(num_clusters, dim)")
    return torch.from_numpy(np.array(C, dtype=np.float32)).to(
        resolve_device(device))


def lbfgs_state_from_numpy(arrays: dict, num_dim: int,
                           device=None) -> dict:
    """The L-BFGS state in a JAX ``lbfgs_state.npz`` or ``model_out``, for
    an objective of num_dim slots (a model_out's ``num_feature`` sizes
    it: the caller reads it): ``w`` (and ``g``, and the rows of ``S`` and
    ``Y`` as lists) as f32 tensors on `device` cut to num_dim, ``iter``
    an int and ``objv`` a list of floats, each where the arrays have it.
    Raises if a vector is shorter than num_dim, or nonzero past it (a
    mesh's padding is zero), or if S and Y differ in length."""
    dev = resolve_device(device)

    def vec(v, name):
        v = np.asarray(v, np.float32)
        if v.ndim != 1 or v.shape[0] < num_dim:
            raise ValueError(f"{name}: shape {v.shape}, expected at least "
                             f"({num_dim},)")
        if np.any(v[num_dim:]):
            raise ValueError(f"{name}: nonzero past slot {num_dim}; the "
                             f"file is for another objective")
        return torch.from_numpy(np.array(v[:num_dim])).to(dev)

    out = {"w": vec(arrays["w"], "w")}
    if "g" in arrays:
        out["g"] = vec(arrays["g"], "g")
    for name in ("S", "Y"):
        if name in arrays:
            out[name] = [vec(v, f"{name}[{i}]")
                         for i, v in enumerate(np.asarray(arrays[name]))]
    if len(out.get("S", ())) != len(out.get("Y", ())):
        raise ValueError("S and Y hold different numbers of pairs")
    if "iter" in arrays:
        out["iter"] = int(arrays["iter"])
    if "objv" in arrays:
        out["objv"] = [float(o) for o in np.asarray(arrays["objv"])]
    return out
