"""kmeans.dmlc: spherical k-means (reference learn/kmeans/kmeans.cc), on
one device, or on several ranks of one process group: the launcher's
workers with global_mesh=1, or the ranks of torch.distributed.run.
Rabit-style key=value args:

  python -m wormhole_tpu_torch.apps.kmeans data=... num_clusters=16 \
      max_iter=10 model_out=centroids.txt device=cuda
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 4 -s 0 -- \
      python -m wormhole_tpu_torch.apps.kmeans data=... global_mesh=1
  python -m torch.distributed.run --nproc-per-node 4 \
      -m wormhole_tpu_torch.apps.kmeans data=...

On several ranks each streams its rank slice of the file parts in
minibatch / ranks rows a step, and the step's (k x d) sums, k counts and
cost are all-reduced over the group (the rabit::Allreduce<Sum> of
kmeans.cc:190). Writes the centroids as text, one row a line (rank 0).
global_mesh=1 without a launcher role runs in one process, as the JAX
app does.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import types

import numpy as np

from wormhole_tpu_torch.apps._runner import (maybe_run_global, parse_cli,
                                              ranks_of_launch, refuse_roles)
from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner


def init_rows(blocks, k: int, dim: int, seed: int) -> np.ndarray:
    """k initial centroids from the first rows of `blocks` (the JAX
    global body's draw, kmeans.cc:89-106 with root 0): rows densified and
    unit-normalized on the host until k * 8 are in hand, padded with
    jittered copies when fewer than k, then k picked without
    replacement, by numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    rows = []
    for blk in blocks:
        X = np.zeros((blk.size, dim), np.float32)
        r = np.repeat(np.arange(blk.size),
                      np.diff(blk.offset).astype(np.int64))
        X[r, blk.index.astype(np.int64)] = blk.values_or_ones()
        X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
        rows.append(X)
        if sum(len(x) for x in rows) >= k * 8:
            break
    cand = np.concatenate(rows)
    if len(cand) < k:
        extra = cand[rng.integers(0, len(cand), k - len(cand))]
        cand = np.concatenate(
            [cand, extra + 0.01 * rng.standard_normal(extra.shape)
             .astype(np.float32)])
    return cand[rng.choice(len(cand), size=k, replace=False)].astype(
        np.float32)


def _global_worker_body(cfg, env, client, device,
                        verbose: bool = True) -> int:
    """Lockstep Lloyd iterations over the group (the JAX package's global
    body): dim by global_scalar_max, C0 from rank 0's local rows (through
    the scheduler's blob channel under the launcher, a broadcast over the
    group under torch.distributed.run), each step's statistics
    all-reduced, and an iteration's loop over the steps ends when a
    step's global count is 0."""
    import torch
    import torch.distributed as dist

    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.parallel import collectives
    from wormhole_tpu_torch.parallel import multihost as mh
    from wormhole_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

    rank, nproc = env.rank, env.num_workers
    if cfg.minibatch % nproc:
        raise ValueError(f"minibatch {cfg.minibatch} must divide over "
                         f"{nproc} ranks")
    local_rows = cfg.minibatch // nproc
    mine = mh.rank_parts(cfg.train_data, cfg.num_parts_per_file, env)
    mesh = make_mesh(nproc, 1, device=device, backend=dist.get_backend())

    def local_blocks(seed=0):
        for f, k in mine:
            yield from MinibatchIter(f, k, cfg.num_parts_per_file,
                                     cfg.data_format,
                                     minibatch_size=local_rows, seed=seed,
                                     device=mesh.device)

    # dim discovery: the local max, then the global Allreduce<Max>
    # (kmeans.cc:160)
    if cfg.dim == 0:
        local_max = -1
        for blk in local_blocks():
            if blk.nnz:
                local_max = max(local_max, int(blk.index.max()))
        cfg.dim = mh.global_scalar_max(local_max) + 1
    # the learner steps over this rank's local_rows-row blocks
    lrn = KmeansLearner(dataclasses.replace(cfg, minibatch=local_rows),
                        device=mesh.device)
    k, d = cfg.num_clusters, cfg.dim
    C0 = (init_rows(local_blocks(), k, d, cfg.seed) if rank == 0
          else np.zeros((k, d), np.float32))
    if client is not None:
        if rank == 0:
            client.blob_put("kmeans_init", C0)
        C0 = client.blob_get("kmeans_init", timeout=120)
        C = lrn._put(np.asarray(C0, np.float32))
    else:
        C = collectives.broadcast(lrn._put(C0), mesh, 0, DATA_AXIS)

    def assign(blk):
        db = lrn._prep_db(blk)
        if lrn._use_packed:
            pk = [lrn._put(a) for a in lrn.pack_batch(db.seg, db.idx,
                                                      db.val)]
            return lrn._assign_packed(C, *pk, lrn._put(db.row_mask))
        fn = lrn._assign_sparse if lrn._use_sparse else lrn._assign_dense
        return fn(C, *(lrn._put(a) for a in (db.seg, db.idx, db.val,
                                             db.row_mask)))

    empty = mh.empty_rowblock()
    cost = float("nan")
    iter_ms = []
    for it in range(cfg.max_iter):
        t0 = time.perf_counter()
        acc = torch.zeros(k * d + k + 1, dtype=torch.float32,
                          device=mesh.device)
        blocks = local_blocks(seed=it)
        while True:
            blk = next(blocks, None)
            s, c, co = assign(blk if blk is not None else empty)
            step = torch.cat([s.reshape(-1), c, co.reshape(1)])
            collectives.allreduce_sum(step, mesh, DATA_AXIS)
            # the step's global row count: the same on every rank
            if float(step[k * d:k * d + k].sum()) == 0:
                break
            acc += step
        sums, counts = acc[:k * d].view(k, d), acc[k * d:k * d + k]
        C = torch.where(counts[:, None] > 0,
                        sums / counts[:, None].clamp_min(1.0), C)
        cost = float(acc[-1]) / max(float(counts.sum()), 1.0)
        iter_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
        if rank == 0 and verbose:
            print(f"kmeans iter {it}: mean cosine distance {cost:.6f}",
                  flush=True)
    if rank == 0:
        print(f"final cosine objective: {cost:.6f}", flush=True)
        # host-clock ms of each iteration, its parse and collectives in
        print(f"[kmeans-global] iter ms: {iter_ms}", flush=True)
        if cfg.model_out:
            lrn.centroids = C
            lrn.save(cfg.model_out)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # the reference kmeans takes data= (kmeans.cc SetParam); accept both
    argv = [a.replace("data=", "train_data=", 1)
            if a.startswith("data=") else a for a in argv]
    cfg, device = parse_cli(KmeansConfig, argv, ranks=True)
    rc = maybe_run_global(cfg, _global_worker_body, device)
    if rc is not None:
        return rc
    refuse_roles("kmeans", "run with global_mesh=1, or without the launcher")
    with ranks_of_launch(device) as device:
        import torch.distributed as dist

        if dist.is_initialized():  # the ranks of torch.distributed.run
            env = types.SimpleNamespace(rank=dist.get_rank(),
                                        num_workers=dist.get_world_size())
            return _global_worker_body(cfg, env, None, device)
        objv = KmeansLearner(cfg, device=device).run()  # writes model_out
        print(f"final cosine objective: {objv:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
