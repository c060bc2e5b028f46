"""Rank bodies of the port's mesh tests, one process a rank.

The test files import JAX; a rank must not (the port runs without it), so
the ranks are separate interpreters started on this file:

  python tests/torch_mesh_ranks.py JOB RANK WORLD WORKDIR

Each rank joins a gloo process group through a file under WORKDIR (no
port to collide with other test workers), reads its inputs from WORKDIR
(.npz and .json files the test wrote), runs JOB on its mesh and writes
`JOB-RANK.npz` back. `launch` starts the ranks of one job and waits for
them, with a timeout, so a hung rank fails the test instead of stalling
the suite. Imports only numpy, torch and the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def launch(job: str, world: int, workdir, timeout: float = 120.0) -> list:
    """Run `job` on `world` ranks; returns each rank's output arrays.
    Raises with the ranks' output if one fails or the job outlasts
    `timeout` seconds (every rank is killed then)."""
    workdir = Path(workdir).resolve()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(world), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(ROOT)) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"mesh job {job} on {world} ranks outlasted "
                             f"{timeout} s")
    if any(p.returncode for p in procs):
        raise AssertionError(f"mesh job {job} failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode})\n{o}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return [dict(np.load(workdir / f"{job}-{r}.npz"))
            for r in range(world)]


def _cell_args(cell):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (cell.idx, cell.seg, cell.val, cell.tmap, cell.first)]


def job_spmv(mesh, workdir: Path) -> dict:
    """mesh_coo_spmv and mesh_coo_spmv_t (wrapper and plain twin) on this
    rank's cell of the test's batch; and the other collectives, each over
    an axis, on values made from the rank."""
    import torch

    from wormhole_tpu_torch.ops import coo_kernels as ck
    from wormhole_tpu_torch.parallel import collectives as C
    from wormhole_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                  batch_range, table_range)

    x = np.load(workdir / "spmv.npz")
    nb, rows, cap = (int(x[k]) for k in ("num_buckets", "num_rows", "cap"))
    D, M = mesh.num_data, mesh.num_model
    cell, dropped = ck.pack_mesh_cell(x["idx"], x["seg"], x["val"], nb, rows,
                                      D, M, *mesh.coords, cap)
    args = _cell_args(cell)
    w = torch.from_numpy(x["w"][slice(*table_range(mesh, nb))].copy())
    d = torch.from_numpy(x["d"][slice(*batch_range(mesh, rows))].copy())
    f32 = torch.float32
    r = torch.tensor([float(mesh.rank)])
    stacked = torch.arange(D * 3, dtype=f32).reshape(D, 3)
    return {
        "max_data": C.allreduce_max(r.clone(), mesh, DATA_AXIS).numpy(),
        "min_model": C.allreduce_min(r.clone(), mesh, MODEL_AXIS).numpy(),
        "bcast_data": C.broadcast(10 * r, mesh, D - 1, DATA_AXIS).numpy(),
        "shards": C.Communicator(mesh, DATA_AXIS).allreduce_shards(
            stacked).numpy(),
        "xw": ck.mesh_coo_spmv(mesh, w, *args, rows, f32).numpy(),
        "xw_plain": ck.mesh_coo_spmv_plain(mesh, w, *args, rows, f32).numpy(),
        "g": ck.mesh_coo_spmv_t(mesh, d, *args, nb, f32).numpy(),
        "g_plain": ck.mesh_coo_spmv_t_plain(mesh, d, *args, nb, f32).numpy(),
        "dropped": dropped}


def job_linear(mesh, workdir: Path) -> dict:
    """The linear learner on this rank's cell: the JAX-parity batches
    (progress per batch, whole tables, this rank's shard, predict), a
    checkpoint written as parts and one read back from the JAX package's
    parts, and a run through the solver with several loaders and parts,
    saving model_out, as the app does."""
    from wormhole_tpu_torch import interop
    from wormhole_tpu_torch.config import load_config
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver
    from wormhole_tpu_torch.utils import checkpoint as ckpt

    spec = json.loads((workdir / "linear.json").read_text())
    cfg = LinearConfig(**spec["cfg"])
    lrn = LinearLearner(cfg, mesh=mesh)
    assert lrn._mesh_coo and lrn._compact_cap == 0
    progs = [lrn.train_batch(blk) for blk in MinibatchIter(
        spec["path"], minibatch_size=cfg.minibatch, device="cpu")]
    out = {f"prog_{k}": np.array([p[k] for p in progs]) for k in progs[0]}
    out.update({f"table_{k}": v for k, v in lrn.store.to_numpy().items()})
    out.update({f"shard_{k}": v.numpy().copy()
                for k, v in lrn.store.state.items()})
    blk = next(iter(MinibatchIter(spec["path"], minibatch_size=cfg.minibatch,
                                  device="cpu")))
    out["predict"] = lrn.predict_batch(blk)
    tok = lrn.pack_cache_token()
    out["token_mesh"] = np.array([tok[9], tok[10], tok[-2], tok[-1]])
    out["nnz"] = lrn.nnz()
    ckpt.save_model(lrn.store, str(workdir / "port_ckpt" / "m"))
    back = LinearLearner(cfg, mesh=mesh)
    ckpt.load_model(back.store, str(workdir / "jax_ckpt" / "m"))
    out.update({f"loaded_{k}": v for k, v in back.store.to_numpy().items()})
    # the JAX package's whole tables through interop: this rank's rows
    via = LinearLearner(cfg, mesh=mesh)
    interop.load_linear_state(via, ckpt.load_parts(
        str(workdir / "jax_ckpt" / "m")))
    out.update({f"interop_{k}": v.numpy().copy()
                for k, v in via.store.state.items()})

    scfg = load_config(LinearConfig, conf_file=spec["conf"],
                       argv=[f"model_out={workdir / 'lib' / 'm'}"])
    res = MinibatchSolver(LinearLearner(scfg, mesh=mesh), scfg,
                          verbose=mesh.rank == 0).run()["train"]
    out.update({f"solver_{k}": res.mean(k) for k in ("logloss", "auc")})
    return out


def job_gbdt(mesh, workdir: Path) -> dict:
    """GBDT with rows sharded over the data axis: fit with the training
    set as an eval set, then predictions on a held-out file."""
    from wormhole_tpu_torch.models.gbdt import GbdtConfig, GbdtLearner

    spec = json.loads((workdir / "gbdt.json").read_text())
    lrn = GbdtLearner(GbdtConfig(**spec["cfg"]), mesh=mesh)
    last = lrn.fit(verbose=False)
    out = {k: v for k, v in lrn.trees.items()}
    out.update({f"train_{k}": v for k, v in last["train"].items()})
    out["pred"] = lrn.predict_margin(lrn.load_dataset(spec["val"]))
    out["edges"] = lrn.edges
    # the JAX package's model file, loaded into a learner on this mesh
    jax_model = GbdtLearner(GbdtConfig(**spec["cfg"]), mesh=mesh)
    jax_model.load(spec["jax_model"])
    out["jax_model_pred"] = jax_model.predict_margin(
        jax_model.load_dataset(spec["val"]))
    return out


JOBS = {"spmv": job_spmv, "linear": job_linear, "gbdt": job_gbdt}


def main(argv) -> int:
    import torch.distributed as dist

    from wormhole_tpu_torch.parallel.mesh import make_mesh

    job, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), \
        Path(argv[3])
    shape = json.loads((workdir / f"{job}.mesh").read_text())
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir / (job + '.rendezvous')}",
        world_size=world, rank=rank)
    try:
        mesh = make_mesh(*shape, device="cpu")
        out = JOBS[job](mesh, workdir)
        np.savez(workdir / f"{job}-{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
