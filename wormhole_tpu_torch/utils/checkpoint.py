"""Model checkpoint save/load with the reference's part-file naming.

Parity with reference iter_solver.h:99-119 and the JAX package's
utils/checkpoint.py: a model is `<base>[_iter-K].npz` when written as one
part, or `<base>[_iter-K]_part-<rank>.npz` files concatenated on the
bucket axis. The port writes one part (one device); it reads either
form, so a `model_out` of the JAX app loads here. Local paths only.

`store` is anything with to_numpy / from_numpy: a KVStore, or DiFacto's
_CombinedStore, which saves both of its table groups and, after a load,
fires its on_load callback (the learner's count-mirror resync).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import numpy as np


def atomic_savez(path: str, compressed: bool = False, **arrays) -> None:
    """np.savez via a temp file + os.replace, so a crash mid-write never
    leaves a truncated checkpoint."""
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path[:-len(".npz")] + ".tmp.npz"
    (np.savez_compressed if compressed else np.savez)(tmp, **arrays)
    os.replace(tmp, path)


def part_name(base: str, it: Optional[int], rank: int) -> str:
    s = base
    if it is not None and it >= 0:
        s += f"_iter-{it}"
    return s + f"_part-{rank}"


def save_prefix(base: str, it: Optional[int]) -> str:
    """The `<base>[_iter-K]` prefix all part files of one save share."""
    return part_name(base, it, 0)[: -len("_part-0")]


def save_model(store, base: str, it: Optional[int] = None) -> list[str]:
    """Write the store's tables as `<base>[_iter-K].npz`, removing stale
    part files of an earlier save so a later load never mixes them."""
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    prefix = save_prefix(base, it)
    for old in glob.glob(prefix + "_part-*.npz") + glob.glob(prefix + ".npz"):
        os.remove(old)
    atomic_savez(prefix + ".npz", compressed=True, **store.to_numpy())
    return [prefix + ".npz"]


def load_parts(base: str, it: Optional[int] = None) -> dict[str, np.ndarray]:
    """Read a checkpoint written with any part count into full-model
    numpy arrays."""
    prefix = save_prefix(base, it)
    if os.path.exists(prefix + ".npz"):
        with np.load(prefix + ".npz") as z:
            return {k: z[k] for k in z.files if not k.startswith("__")}
    paths = sorted(
        glob.glob(prefix + "_part-*.npz"),
        key=lambda p: int(re.search(r"_part-(\d+)\.npz$", p).group(1)),
    )
    if not paths:
        raise FileNotFoundError(
            f"no checkpoint matches {prefix}.npz or {prefix}_part-*")
    parts = [dict(np.load(p)) for p in paths]
    # "__"-prefixed keys are per-part metadata, not model tables
    return {k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0] if not k.startswith("__")}


def load_model(store, base: str, it: Optional[int] = None) -> None:
    """Read a checkpoint (single file or parts) into the store."""
    store.from_numpy(load_parts(base, it))
