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

import contextlib
import dataclasses
import io
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
    # kernel=xla: the same cells through the plain twins
    xla = LinearLearner(dataclasses.replace(cfg, kernel="xla"), mesh=mesh)
    assert xla._mesh_coo and not xla.use_pallas
    xprogs = [xla.train_batch(blk) for blk in MinibatchIter(
        spec["path"], minibatch_size=cfg.minibatch, device="cpu")]
    out["xla_prog_logloss"] = np.array([p["logloss"] for p in xprogs])
    out.update({f"xla_table_{k}": v for k, v in xla.store.to_numpy().items()})
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


def job_difacto(mesh, workdir: Path) -> dict:
    """DiFacto on this rank's cells: started from the test's tables
    (the JAX learner's), trained on the test's batches (every rank reads
    all of them, as the solver's mesh does); the whole tables, this
    rank's shards, each batch's progress, an eval and a predict."""
    from wormhole_tpu_torch import interop
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.models.difacto import DifactoConfig, \
        DifactoLearner

    spec = json.loads((workdir / "difacto.json").read_text())
    lrn = DifactoLearner(DifactoConfig(**spec["cfg"]), mesh=mesh)
    assert lrn._mesh_layout and not lrn._use_fm_pallas
    interop.load_difacto_state(lrn, dict(np.load(workdir / "init.npz")))
    mb = spec["cfg"]["minibatch"]
    progs = []
    for ep in range(spec["passes"]):
        progs += [lrn.train_batch(blk) for blk in MinibatchIter(
            spec["path"], minibatch_size=mb, seed=ep, device="cpu")]
    out = {f"prog_{k}": np.array([p[k] for p in progs]) for k in progs[0]}
    out.update({f"table_{k}": v
                for k, v in lrn.ckpt_store.to_numpy().items()})
    out.update({f"shard_{k}": v.numpy().copy()
                for k, v in lrn.ckpt_store.state.items()})
    blk = next(iter(MinibatchIter(spec["path"], minibatch_size=mb,
                                  device="cpu")))
    out["predict"] = lrn.predict_batch(blk)
    out.update({f"eval_{k}": v for k, v in lrn.eval_batch(blk).items()})
    out["nnz"] = lrn.nnz()
    out["admitted"] = lrn.num_admitted()
    # kernel=xla: the same steps with the w cell unsorted, through W1 and
    # W2's plain twins
    xla = DifactoLearner(DifactoConfig(**dict(spec["cfg"], kernel="xla")),
                         mesh=mesh)
    assert xla._mesh_layout and not xla._mesh_kernels
    interop.load_difacto_state(xla, dict(np.load(workdir / "init.npz")))
    for ep in range(spec["passes"]):
        for b in MinibatchIter(spec["path"], minibatch_size=mb, seed=ep,
                               device="cpu"):
            xla.train_batch(b)
    out.update({f"xla_table_{k}": v
                for k, v in xla.ckpt_store.to_numpy().items()})
    return out


def job_group(mesh, workdir: Path) -> dict:
    """The process-group apps' bodies on this rank (the route of
    torch.distributed.run): k-means and L-BFGS linear over the group, the
    models written by rank 0; and multihost's collectives on values made
    from the rank."""
    import types

    import torch

    from wormhole_tpu_torch.apps import kmeans, lbfgs_linear
    from wormhole_tpu_torch.data.rowblock import RowBlock, to_device_batch
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.parallel import collectives
    from wormhole_tpu_torch.parallel import multihost as mh

    spec = json.loads((workdir / "group.json").read_text())
    env = types.SimpleNamespace(rank=mesh.rank, num_workers=mesh.size)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        km = kmeans.KmeansConfig(**spec["kmeans"])
        kmeans._global_worker_body(km, env, None, "cpu", verbose=False)
        lb = lbfgs_linear.LbfgsLinearConfig(**spec["lbfgs"])
        lbfgs_linear._global_worker_body(lb, env, None, "cpu")
    r = mesh.rank
    blk = RowBlock(label=np.ones(3, np.float32),
                   offset=np.array([0, 1, 3, 4]),
                   index=np.array([5, 6, 7, 8], np.uint64),
                   value=np.full(4, r + 1.0, np.float32), weight=None)
    db = to_device_batch(blk, 4, 8, 16)
    seg, idx, val, label, mask = mh.global_coo_batch(db, r, 4)
    lrn = LinearLearner(LinearConfig(num_buckets=16, minibatch=4 * mesh.size,
                                     kernel="xla"), mesh=mesh)
    whole = {"w": np.arange(16, dtype=np.float32), "z": np.ones(16,
             np.float32), "n": np.full(16, 2.0, np.float32)}
    mh.load_replicated(lrn.store, whole)
    try:
        mh.load_replicated(lrn.store, {"V": np.zeros(16, np.float32)})
        refused = 0
    except ValueError:
        refused = 1
    comm = collectives.GroupComm()
    return {
        "printed": np.array(printed.getvalue()),
        "sum": mh.global_scalar_sum(10 * (r + 1)),
        "max": mh.global_scalar_max(-5 + r),
        "seg": seg, "idx": idx, "val": val, "label": label, "mask": mask,
        "w": mh.fetch_replicated(lrn.store.state["w"]),
        "rows": mh.fetch_local_rows(torch.arange(8.0), 2, 5),
        "refused": refused,
        "comm_sum": comm.allreduce(np.array([r, 1.5], np.float32)),
        "comm_max": comm.allreduce(np.float32(r), op="max")}


def job_init(mesh, workdir: Path) -> dict:
    """multihost.init_from_env joined this group at a tcp:// address; the
    group's backend and this rank's device."""
    import torch.distributed as dist

    return {"backend": np.array(dist.get_backend()),
            "device": np.array(str(mesh.device)),
            "world": dist.get_world_size(), "rank": dist.get_rank()}


JOBS = {"spmv": job_spmv, "linear": job_linear, "gbdt": job_gbdt,
        "difacto": job_difacto, "group": job_group, "init": job_init}


def main(argv) -> int:
    import torch.distributed as dist

    from wormhole_tpu_torch.parallel import multihost as mh
    from wormhole_tpu_torch.parallel.mesh import make_mesh
    from wormhole_tpu_torch.runtime.tracker import NodeEnv

    job, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), \
        Path(argv[3])
    shape = json.loads((workdir / f"{job}.mesh").read_text())
    if job == "init":  # the global mesh's rendezvous, as a worker joins it
        env = NodeEnv(role=None, rank=rank, num_workers=world,
                      num_servers=0, scheduler_uri="",
                      coord_uri=(workdir / "coord").read_text().strip())
        mh.init_from_env(env, "cpu", timeout=60)
    else:
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
