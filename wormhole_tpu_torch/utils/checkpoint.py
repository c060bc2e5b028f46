"""Model checkpoint save/load with the reference's part-file naming.

Parity with reference iter_solver.h:99-119 and the JAX package's
utils/checkpoint.py: a model is `<base>[_iter-K].npz` when written as one
part, or `<base>[_iter-K]_part-<rank>.npz` files concatenated on the
bucket axis, one a model shard. The port writes one part from one device
or a mesh of one model shard, and the `_part-R` fan-out from a mesh of
several, where data rank 0 of model shard R writes part R; it reads
either form under any shard count, as the JAX package does, so each
package loads the other's files. A base may be any URI data/filesys.py
binds: a remote part is written as one whole buffer and parts are found
with `filesys.list_dir`; the removal of an earlier save's stale parts
stays local, as in the JAX package.

`store` is anything with to_numpy / from_numpy: a KVStore, or DiFacto's
_CombinedStore, which saves both of its table groups and, after a load,
fires its on_load callback (the learner's count-mirror resync).
"""

from __future__ import annotations

import glob
import io
import os
import re
from typing import Optional

import numpy as np

from wormhole_tpu_torch.data import filesys as fsys


def _local(uri: str) -> Optional[str]:
    """The local path of a plain or file:// URI, else None."""
    scheme, path = fsys.split_scheme(uri)
    return uri if not scheme else path if scheme == "file" else None


def atomic_savez(path: str, compressed: bool = False, **arrays) -> None:
    """np.savez via a temp file + os.replace, so a crash mid-write never
    leaves a truncated checkpoint. Non-local URIs upload a complete
    buffer on close: object stores make whole-object writes atomic by
    nature (iter_solver.h writes model shards to HDFS/S3 the same way)."""
    save = np.savez_compressed if compressed else np.savez
    if not path.endswith(".npz"):
        path += ".npz"
    local = _local(path)
    if local is None:
        buf = io.BytesIO()
        save(buf, **arrays)
        with fsys.open_stream(path, "wb") as f:
            f.write(buf.getvalue())
        return
    tmp = local[:-len(".npz")] + ".tmp.npz"
    save(tmp, **arrays)
    os.replace(tmp, local)


def part_name(base: str, it: Optional[int], rank: int) -> str:
    s = base
    if it is not None and it >= 0:
        s += f"_iter-{it}"
    return s + f"_part-{rank}"


def save_prefix(base: str, it: Optional[int]) -> str:
    """The `<base>[_iter-K]` prefix all part files of one save share."""
    return part_name(base, it, 0)[: -len("_part-0")]


def save_model(store, base: str, it: Optional[int] = None) -> list[str]:
    """Write the store's tables: `<base>[_iter-K].npz` for one model
    shard, else one `_part-R` file a model shard. Stale files of an
    earlier save (of another shard count) are removed first, so a later
    load never mixes them. On a mesh every rank calls this together;
    rank 0 removes, the writers write, and all return once every file
    is in place. Returns the paths this rank wrote."""
    mesh = getattr(store, "mesh", None)
    grouped = mesh is not None and mesh.device_mesh is not None
    prefix = save_prefix(base, it)
    local = _local(prefix)
    if grouped:
        mesh.barrier()  # no rank still reads an earlier save
    if local is not None and (not grouped or mesh.rank == 0):
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        for old in (glob.glob(local + "_part-*.npz")
                    + glob.glob(local + ".npz")):
            os.remove(old)
    if grouped:
        mesh.barrier()
    out = []
    if not grouped or mesh.num_model == 1:
        arrays = store.to_numpy()
        if not grouped or mesh.rank == 0:
            atomic_savez(prefix + ".npz", compressed=True, **arrays)
            out.append(prefix + ".npz")
    else:
        d, m = mesh.coords
        if d == 0:  # the shard's rows are the same on every data rank
            path = part_name(base, it, m) + ".npz"
            atomic_savez(path, compressed=True,
                         **{k: v.cpu().numpy()
                            for k, v in store.state.items()})
            out.append(path)
    if grouped:
        mesh.barrier()
    return out


def load_parts(base: str, it: Optional[int] = None) -> dict[str, np.ndarray]:
    """Read a checkpoint written with any part count into full-model
    numpy arrays."""
    prefix = save_prefix(base, it)
    local = _local(prefix)
    if local is None:
        def load(uri):
            with fsys.open_stream(uri, "rb") as f:
                return dict(np.load(io.BytesIO(f.read())))

        if fsys.isfile(prefix + ".npz"):
            return {k: v for k, v in load(prefix + ".npz").items()
                    if not k.startswith("__")}
        d, b = fsys.dirname(prefix), fsys.basename(prefix)
        paths = [fsys.join(d, n) for n in fsys.list_dir(d)
                 if re.fullmatch(re.escape(b) + r"_part-\d+\.npz", n)]
    else:
        load = np.load
        prefix = local
        if os.path.exists(prefix + ".npz"):
            with np.load(prefix + ".npz") as z:
                return {k: z[k] for k in z.files if not k.startswith("__")}
        paths = glob.glob(prefix + "_part-*.npz")
    paths.sort(key=lambda p: int(re.search(r"_part-(\d+)\.npz$",
                                           p).group(1)))
    if not paths:
        raise FileNotFoundError(
            f"no checkpoint matches {prefix}.npz or {prefix}_part-*")
    parts = [dict(load(p)) for p in paths]
    # "__"-prefixed keys are per-part metadata, not model tables
    return {k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0] if not k.startswith("__")}


def load_model(store, base: str, it: Optional[int] = None) -> None:
    """Read a checkpoint (single file or parts) into the store."""
    store.from_numpy(load_parts(base, it))
