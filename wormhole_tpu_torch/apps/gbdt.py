"""xgboost.dmlc: histogram GBDT (the reference builds the xgboost CLI over
rabit; conf surface of mushroom.hadoop.conf), on one device; under
torch.distributed.run with the rows sharded over the launch's ranks;
with bsp=1 under the launcher, one rank a worker process whose level
histograms sum over the BSP allreduce ring (runtime/allreduce.py), a
killed worker respawned and replaying what it missed; or with
global_mesh=1 under the launcher, the workers the ranks of one process
group, each holding its own rows, the level histograms summed by
mesh_level_hist over the group. global_mesh=1 without a launcher role
runs in one process, as the JAX app does.

  python -m wormhole_tpu_torch.apps.gbdt mushroom.conf num_round=10 device=cuda
  python -m torch.distributed.run --nproc-per-node 4 \
      -m wormhole_tpu_torch.apps.gbdt mushroom.conf
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 3 -s 0 \
      --max-worker-restarts 1 -- \
      python -m wormhole_tpu_torch.apps.gbdt mushroom.conf bsp=1
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 2 -s 0 -- \
      python -m wormhole_tpu_torch.apps.gbdt mushroom.conf global_mesh=1
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from wormhole_tpu_torch.apps._runner import (maybe_run_bsp,
                                              maybe_run_global, parse_cli,
                                              ranks_of_launch, refuse_roles)
from wormhole_tpu_torch.models.gbdt import GbdtConfig, GbdtLearner
from wormhole_tpu_torch.parallel.mesh import make_mesh
from wormhole_tpu_torch.solver.workload import iter_rowblocks


def _bsp_worker_body(cfg, env, client, comm, device) -> int:
    """GBDT over the BSP allreduce ring, the rabit layout of the
    reference: each rank keeps its own rows on its device (a one-device
    mesh; the ring spans the processes), each level's statistics block
    and the eval metric sums allreduce over the worker ring, and a
    version checkpoint after every boosting round makes a killed worker
    recoverable (the launcher respawns it; it reloads its trees and
    replays the missed collectives from its peers' result caches).

    All set-up before training (the quantile sketch, the feature count)
    goes through the scheduler's blob channel, never the ring: blobs
    persist, so a respawned worker re-reads identical values while
    consuming no collective counter, and its (version, seq) sequence
    stays aligned with the survivors'."""
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.models.gbdt import (_SKETCH_ROWS, Reservoir,
                                                _densify, _densify_sample,
                                                bin_matrix, quantile_edges)
    from wormhole_tpu_torch.parallel import multihost as mh

    if cfg.task != "train":
        raise ValueError(f"bsp=1 runs task=train, not {cfg.task!r}")
    if cfg.model_in:
        raise NotImplementedError(
            "model_in warm start is not supported in bsp mode (nor in the "
            "JAX package's)")
    rank, nproc = env.rank, env.num_workers
    lrn = GbdtLearner(cfg, mesh=make_mesh(device=device))

    def my_blocks(pattern):
        for f, k in mh.rank_parts(pattern, cfg.num_parts_per_file, env):
            yield from MinibatchIter(f, k, cfg.num_parts_per_file,
                                     cfg.data_format,
                                     minibatch_size=cfg.minibatch,
                                     device=lrn.device)

    # per-rank quantile sketch, merged by rank 0 over the blob channel.
    # Deterministic per rank (a seeded reservoir over a stable part
    # slice), so a respawned worker's re-publish is a no-op overwrite.
    res = Reservoir(_SKETCH_ROWS // max(nproc, 1), cfg.seed + rank)
    for blk in my_blocks(cfg.train_data):
        res.add_block(blk)
    sidx = (np.concatenate([r[0] for r in res.sample])
            if res.sample else np.zeros(0, np.uint64))
    sval = (np.concatenate([r[1] for r in res.sample])
            if res.sample else np.zeros(0, np.float32))
    soff = np.zeros(len(res.sample) + 1, np.int64)
    np.cumsum([len(r[0]) for r in res.sample], out=soff[1:])
    client.blob_put(f"gbdt_bsp_sketch_{rank}",
                    {"idx": sidx.astype(np.uint64), "val": sval,
                     "off": soff, "max_feat": np.int64(res.max_feat)})
    if rank == 0 and not client.call(op="blob_get",
                                     key="gbdt_bsp_meta")["ok"]:
        # merge (first incarnation only: a respawned rank 0 finds the
        # meta blob already published and must reuse it, and the
        # sketches are never deleted, for the same reason)
        rows, max_feat = [], res.max_feat
        for r in range(nproc):
            p = client.blob_get(f"gbdt_bsp_sketch_{r}", timeout=120)
            max_feat = max(max_feat, int(p["max_feat"]))
            rows.extend((p["idx"][lo:hi], p["val"][lo:hi])
                        for lo, hi in zip(p["off"], p["off"][1:]))
        dim = cfg.dim if cfg.dim else max(max_feat + 1, 1)
        edges = quantile_edges(_densify_sample(rows, dim), cfg.max_bin)
        client.blob_put("gbdt_bsp_meta",
                        {"edges": edges, "dim": np.int64(dim)})
    meta = client.blob_get("gbdt_bsp_meta", timeout=120)
    cfg.dim = int(meta["dim"])
    lrn.edges = meta["edges"]

    def load_local(pattern):
        """This rank's rows binned on its device. Ranks may hold skewed
        row counts: only the reduced blocks' shapes must agree, and those
        depend on (dim, max_bin, depth) alone. A rank with no rows holds
        one masked row, so it still joins every collective."""
        chunks, labels = [], []
        for blk in my_blocks(pattern):
            chunks.append(bin_matrix(_densify(blk, cfg.dim), lrn.edges))
            labels.append(blk.label.astype(np.float32))
        if not chunks:
            ds = lrn._dataset(np.zeros((1, cfg.dim), np.uint8),
                              np.zeros(1, np.float32))
            ds.mask.zero_()
            ds.num_real = 0
            return ds
        return lrn._dataset(np.concatenate(chunks), np.concatenate(labels))

    train = load_local(cfg.train_data)
    evals = []
    if cfg.eval_data:
        evals.append((cfg.eval_name, load_local(cfg.eval_data)))
    if cfg.eval_train:
        evals.append(("train", train))
    lrn.reducer = comm.allreduce

    # recovery: the respawn loads the version checkpoint (round count and
    # trees so far); fit_prepared's warm-start replay rebuilds the margins
    # locally, then the missed collectives of the current round come from
    # the peers' caches, bit for bit
    r0 = 0
    st = comm.load_checkpoint()
    if st is not None:
        r0 = int(st["round"])
        for k in lrn.trees:
            lrn.trees[k][:r0] = st[k]
        print(f"[gbdt-bsp] rank {rank} resuming at round {r0} "
              f"(version {comm.version})", flush=True)

    round_ms, t_round = [], [time.perf_counter()]

    def on_round(r):
        # AFTER every collective of round r (histograms and metric sums):
        # the version bump here keeps a resumed worker's counter
        # sequence aligned with the survivors'
        comm.checkpoint({"round": np.int64(r + 1),
                         **{k: v[: r + 1] for k, v in lrn.trees.items()}})
        now = time.perf_counter()
        round_ms.append(round((now - t_round[0]) * 1e3, 3))
        t_round[0] = now

    if rank != 0:
        cfg.model_out = None  # a single writer
    last = lrn.fit_prepared(train, evals, r0=r0, verbose=(rank == 0),
                            on_round=on_round)
    if rank == 0:
        for name, m in last.items():
            print("final " + name + ": "
                  + " ".join(f"{k}={v:.6f}" for k, v in m.items()),
                  flush=True)
        if cfg.model_out:
            print(f"saved model to {cfg.model_out}", flush=True)
        # host-clock ms of each round this incarnation ran, its
        # collectives and checkpoint included
        print(f"[gbdt-bsp] round ms: {round_ms}", flush=True)
    return 0


def _global_worker_body(cfg, env, client, device) -> int:
    """GBDT on the global mesh (the JAX package's global body; the
    reference runs the xgboost CLI over rabit with dsplit=row,
    mushroom.hadoop.conf:36): each rank keeps its own rows, padded to the
    largest rank's count with rows of mask 0, on a (num_workers x 1)
    mesh; the level histograms sum over the group (mesh_level_hist, the
    last level's totals in fixed point), and every rank grows the same
    trees in lockstep. The quantile edges come from one reservoir a rank
    (_SKETCH_ROWS // num_workers rows) merged by rank 0 through the
    scheduler's blobs; with every row of each rank in its reservoir they
    are one device's on the union of the files."""
    import torch.distributed as dist

    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.models.gbdt import (_SKETCH_ROWS, BinnedDataset,
                                                Reservoir, _densify,
                                                _densify_sample, bin_matrix,
                                                quantile_edges)
    from wormhole_tpu_torch.parallel import multihost as mh

    if cfg.model_in:
        raise NotImplementedError(
            "model_in warm start is not supported in global_mesh mode (nor "
            "in the JAX package's); warm-start single-process")
    if cfg.task != "train":
        raise ValueError(f"global_mesh=1 runs task=train, not {cfg.task!r}")
    rank, nproc = env.rank, env.num_workers
    lrn = GbdtLearner(cfg, mesh=make_mesh(nproc, 1, device=device,
                                          backend=dist.get_backend()))

    def my_blocks(pattern):
        for f, k in mh.rank_parts(pattern, cfg.num_parts_per_file, env):
            yield from MinibatchIter(f, k, cfg.num_parts_per_file,
                                     cfg.data_format,
                                     minibatch_size=cfg.minibatch,
                                     device=lrn.device)

    res = Reservoir(_SKETCH_ROWS // max(nproc, 1), cfg.seed + rank)
    for blk in my_blocks(cfg.train_data):
        res.add_block(blk)
    if cfg.dim == 0:
        cfg.dim = max(mh.global_scalar_max(res.max_feat) + 1, 1)
    sidx = (np.concatenate([r[0] for r in res.sample])
            if res.sample else np.zeros(0, np.uint64))
    sval = (np.concatenate([r[1] for r in res.sample])
            if res.sample else np.zeros(0, np.float32))
    soff = np.zeros(len(res.sample) + 1, np.int64)
    np.cumsum([len(r[0]) for r in res.sample], out=soff[1:])
    client.blob_put(f"gbdt_sketch_{rank}", {
        "idx": sidx.astype(np.uint64), "val": sval, "off": soff})
    if rank == 0:
        rows = []
        for r in range(nproc):
            p = client.blob_get(f"gbdt_sketch_{r}", timeout=120)
            rows.extend((p["idx"][lo:hi], p["val"][lo:hi])
                        for lo, hi in zip(p["off"], p["off"][1:]))
        client.blob_put("gbdt_edges", quantile_edges(
            _densify_sample(rows, cfg.dim), cfg.max_bin))
        for r in range(nproc):
            client.call(op="blob_del", key=f"gbdt_sketch_{r}")
    lrn.edges = client.blob_get("gbdt_edges", timeout=120)

    def load_global(pattern) -> BinnedDataset:
        """This rank's rows binned on its device, padded to the largest
        rank's row count (every rank then gathers the same shapes)."""
        chunks, labels = [], []
        for blk in my_blocks(pattern):
            chunks.append(bin_matrix(_densify(blk, cfg.dim), lrn.edges))
            labels.append(blk.label.astype(np.float32))
        n = sum(c.shape[0] for c in chunks)
        n_pad = max(mh.global_scalar_max(n), 1)
        binned = np.zeros((n_pad, cfg.dim), np.uint8)
        label = np.zeros(n_pad, np.float32)
        mask = np.zeros(n_pad, np.float32)
        if n:
            binned[:n] = np.concatenate(chunks)
            label[:n] = np.concatenate(labels)
            mask[:n] = 1.0
        ds = lrn._dataset(binned, label, shard=False)
        ds.mask.copy_(torch.from_numpy(mask))
        ds.num_real = mh.global_scalar_sum(n)
        ds.sharded = True
        return ds

    train = load_global(cfg.train_data)
    evals = []
    if cfg.eval_data:
        evals.append((cfg.eval_name, load_global(cfg.eval_data)))
    if cfg.eval_train:
        evals.append(("train", train))
    round_ms, t_round = [], [time.perf_counter()]

    def on_round(r):
        now = time.perf_counter()
        round_ms.append(round((now - t_round[0]) * 1e3, 3))
        t_round[0] = now

    # fit_prepared saves model_out on rank 0 alone (a mesh's save)
    last = lrn.fit_prepared(train, evals, verbose=(rank == 0),
                            on_round=on_round)
    if rank == 0:
        for name, m in last.items():
            print("final " + name + ": "
                  + " ".join(f"{k}={v:.6f}" for k, v in m.items()),
                  flush=True)
        if cfg.model_out:
            print(f"saved model to {cfg.model_out}", flush=True)
        # host-clock ms of each round, its collectives included
        print(f"[gbdt-global] round ms: {round_ms}", flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_cli(GbdtConfig, argv, ranks=True)
    rc = maybe_run_bsp(cfg, _bsp_worker_body, device)
    if rc is None:
        rc = maybe_run_global(cfg, _global_worker_body, device)
    if rc is not None:
        return rc
    refuse_roles("gbdt", "run with bsp=1, or without the launcher "
                 "(global_mesh=1 runs under it too)")
    with ranks_of_launch(device) as device:
        return _run(cfg, GbdtLearner(cfg, mesh=make_mesh(device=device)))


def _run(cfg: GbdtConfig, lrn: GbdtLearner) -> int:
    if cfg.task == "pred":
        # xgboost CLI task=pred: load model, write one probability/value
        # per test row to name_pred
        if not cfg.model_in:
            raise ValueError("task=pred needs model_in")
        lrn.load(cfg.model_in)
        if lrn.mesh.rank != 0:  # the prediction needs no other rank
            return 0
        n = 0
        with open(cfg.pred_out, "w") as f:
            for blk in iter_rowblocks(cfg.test_data or cfg.train_data,
                                      cfg.num_parts_per_file,
                                      cfg.data_format, cfg.minibatch,
                                      device=lrn.device):
                for p in lrn.predict_blk(blk):
                    f.write(f"{p:.6g}\n")
                    n += 1
        print(f"wrote {n} predictions to {cfg.pred_out}")
        return 0
    lrn.fit()
    if cfg.model_out and lrn.mesh.rank == 0:
        lrn.save(cfg.model_out)
        print(f"saved model to {cfg.model_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
