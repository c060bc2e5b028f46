#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

  python3 chip_smoke.py        (from the repo root; needs one CUDA card)
  python3 chip_smoke.py --turns OTHER
      the kernel phases, step times and passes from a file of another
      checkout (e.g. the parent commit from git archive) against this
      one, in turns: other, this, this, other (a checkout that reads no
      Criteo TSV or crb skips those passes and says so)

Drives the port (wormhole_tpu_torch) through its main paths at the
bench's full width: three minibatch learners and the two BSP batch
learners, the linear, DiFacto and GBDT learners and k-means and L-BFGS
on a device mesh of four ranks, linear and DiFacto workers training one
shared model through the launcher's scheduler and PS servers, GBDT and
L-BFGS workers summing their statistics over the launcher's BSP
allreduce ring, and all five learners' workers as the ranks of one
process group (the global mesh). Two run over 65,536-row minibatches of 39
Criteo-shaped features: linear FTRL logistic regression, and the DiFacto
factorization machine (dim 8, w over 2^22 buckets, V over 2^20 rows,
threshold 2; the reference's learn/difacto/guide/criteo.conf, as bench.py
runs it). The third is the histogram GBDT at the bench's HIGGS shape
(2,000,000 dense rows of 28 features, 256 bins, depth 6):

0. builds the hand-written CUDA kernels from csrc/, one nvcc each, at once;
1. holds every kernel of the paths against its plain PyTorch version on
   the card at the paths' shapes (the COO and FM kernels in f32 and
   bf16), and times kernel, plain version and one PyTorch library call
   (CUDA events; for the kernel also the profiler's device time and the
   host's enqueue time per call, for scatter_update a probe that only
   reads and writes back its keys' state, for v_scatter_update one that
   does the same for V and nV at its admitted rows, and for coo_spmv two
   probes that read its stream, then also add one global f32 red per
   entry);
   coo_spmv_t must give exactly 0 at every untouched bucket, dense and
   compact; the DiFacto half runs on a
   full-width batch packed by the learner's own pack; level_hist runs on
   the inputs a real round gives it at each of its six levels, with
   quantile bins and with the same rows in 0/1 bins, two launches at
   each level must give equal bits, those of the fixed-point rule in
   plain ops, and its partition of the rows by node is held against a
   stable sort there; every library's ptxas figures and whether the
   integer atomics of level_hist (shared and global) and the f32
   atomics of coo_spmv (global) are native adds are printed;
2. runs LinearLearner on the card at 2^22 buckets (dense tables, kernels
   coo_spmv + coo_spmv_t) and 2^26 buckets (compacted path, tile_gather +
   coo_spmv_t + scatter_update): train steps, eval, predict, each against
   the same batches through kernel=xla (plain torch ops) on the card, with
   the kernels' launch counts taken over this run, the step time, and a
   torch.profiler pass over each learner's steps (device time per step by
   operation, the device's idle share);
3. the same for DifactoLearner (compacted path: tile_gather,
   row_tile_gather, coo_spmv_t, scatter_update with the additive count
   table, fm_push_contrib, v_scatter_update), with its launch counts
   taken over its own run;
4. the same for GbdtLearner: a few rounds through fit_prepared with an
   eval set, hist_kernel=mxu (the level_hist kernel) against
   hist_kernel=xla (the plain scatter) on the card, trees compared node
   by node, then margins, metrics and predict_margin, the time per
   round and the profiler pass;
5. runs the linear app at 2^26 buckets, the difacto app at the DiFacto
   width and the gbdt app (task=train, then task=pred) at 28 features,
   256 bins, depth 6, in-process on synthetic libsvm files, with
   validation data and model_out; the gbdt app's load (parse and bin)
   is timed;
6. the host data path ([parse], [pack]): the card's libsvm parser
   (csrc/parse.cu) against the plain parser on four 65,536-row chunks
   (Criteo keys, the same keys with k:v values, HIGGS rows, and HIGGS
   rows written %.17g, which take the kernel's exact path), and the
   card's criteo and adfea parsers (csrc/formats.cu, CityHash64 on the
   card) on a 65,536-row synthetic Criteo TSV chunk (~16 MB), the same
   rows as criteo_test, a chunk of one token of every length 0 to 300
   (every CityHash64 branch) and a 65,536-row adfea chunk (negative and
   22-digit fids, gids over 0-1023), and a tile-edge chunk of each
   format (its corpus at 15 shifts around the card's 16,384-byte tile
   edges): equal RowBlocks byte for byte, every token converted on the
   card, timed as the kernels are plus the whole call's wall and the
   plain parser's (one call a format), each chunk with the device ops a
   call split by kernel; and the
   pack with its sorts on the card against the numpy pack, byte for byte,
   at full width (pack_sorted_coo at 2^22, pack_tile_coo at 2^26,
   DiFacto's _pack_fm), in seconds a batch;
7. passes from a file ([e2e]): one train pass of the linear app at 2^26
   and 2^22 buckets and of the difacto app, each over a libsvm file of 8
   full minibatches read as 4 parts by 4 loaders, giving examples/s, the
   pass's wall, ms a step and the loader stall's share of the wall; then
   the same passes of linear at 2^26 and difacto from a Criteo TSV file
   of 8 full minibatches (~127 MB, data_format=criteo, parsed on the
   card), the convert app writing that file as crb on the card (its
   wall), the two passes again from the crb file (data_format=crb), every
   batch of the crb file, read by one reader, equal to the batch parsed
   from the text byte for byte, and a linear pass at 2^26 from a
   131,072-row adfea file;
8. k-means at the bench's MNIST-784 shape ([kmeans]; bench.py
   bench_kmeans: 16,384 rows of 160 uniform column ids of 784, values
   U[0, 1), k 10): the packed assignment (coo_spmv_t over 14,680,064
   flat (row, col) buckets), f32 and bf16, against the scatter densify
   for the same centroids, and the sparse assignment against the dense
   one on rows that name each column once; the assignment's ms on staged
   batches with the profiler's device ms and idle share; coo_spmv_t at
   this shape against its plain version, its bound and index_add_; the
   sparse path timed at a hashed 2^20 width; then the main path:
   KmeansLearner from a libsvm file of 4 minibatches (dim discovered),
   five Lloyd iterations each timed, and the app with model_out;
9. L-BFGS/OWL-QN ([lbfgs]): the lbfgs_linear app at the agaricus shape
   (6,513 rows, 22 one-hot groups over 126 ids; reg_L2 0.1, 30
   iterations, then task=pred), on phase 7's 524,288-row file at 2^22
   with L2 and with OWL-QN (exact zeros of w counted), and the lbfgs_fm
   app (nfactor 8) on its first 131,072 rows: each app's objective must
   never rise; then ms an iteration, of an eval and of a grad over all
   batches, host syncs an iteration and the profiler's idle share, and
   eval and grad at the initial point against the CPU in float64;
10. the loader plane ([cache]; the knobs set inside the phase and
   restored after it): k-means over phase 8's file with the epoch pack
   cache on (WH_PACK_CACHE=1), five Lloyd iterations each timed against
   the same iterations with the cache off from the same centroids
   (iterations 2-5 must miss nothing and launch no parse_libsvm; the
   replayed packs equal fresh packs of the same batches byte for byte;
   centroids within atol 1e-5), then the disk tier (WH_PACK_CACHE_DIR):
   one learner fills it, a second one's first iteration must find every
   batch there; the linear learner at 2^26 over phase 7's file, three
   train passes through the solver with the cache sized from nbytes_of a
   prepared batch and the loaders sized by the LoaderController
   (examples/s, wall, stall share, hits and misses, the median and p90
   of each train.stage.*_s timer, a pass at a time, and the
   controller's decisions), then one loader with the cache on and off,
   w within rtol 1e-4 / atol 1e-6 (the learner checks' bar), z and n
   within 4x the difference of two runs with the cache off (the float
   atomics' floor, measured in the same call) over a floor of 1e-5 of
   the table's largest magnitude, and every replayed pack of the cached
   one-loader run equal to a fresh pack of the same batch byte for byte;
   and a DiFacto train pass
   with the cache on, which must touch no entry, its tables within rtol
   2e-3 / atol 2e-5 of the pass with the cache off;
11. the device mesh ([mesh]): four ranks (this script with --mesh-rank,
   one process each, spawned after the build) join a gloo group, all on
   cuda:0, since NCCL will not put two ranks on one GPU. A 2x2 mesh runs
   the linear learner at 2^22 buckets, 65,536 rows a batch (kind mcoo:
   each rank packs its cell, mesh_coo_spmv = coo_spmv + all_reduce over
   the model axis, mesh_coo_spmv_t = coo_spmv_t + all_reduce over the
   data axis): the train steps, an eval and a predict against one device
   on the same batches (progress within 1e-3, w at rtol 1e-4 / atol
   1e-6, z and n within 4x two one-device runs' difference + 1e-5 of the
   table's largest magnitude), each model shard equal bit for bit on its
   two data ranks; a 4x1 mesh runs GBDT at the HIGGS shape, 500,000 rows
   a rank (mesh_level_hist = level_hist + all_reduce over the data axis):
   its trees against one device's (a split may differ only at a near
   tie), its leaves within 1e-5 of f64 sums; a 2x2 mesh runs DiFacto at
   the criteo.conf width (w 2^22, V 2^20 x 8, threshold 2; kind dmesh:
   W1 and W2 on each rank's w cell, the V cell's sums over the axes) for
   the same train steps, an eval and a predict against one device's
   kernel=xla run (progress within 1e-3, tables at rtol 2e-3 / atol
   2e-5, each model shard equal bit for bit on its two data ranks); and
   the four ranks run k-means at the [kmeans] MNIST-784 shape (k 10, 4
   iterations; the cost within 1e-4 of one device's from the same
   centroids, the centroids within 1e-5 plus what two rows moved at a
   near tie shift them: the densify's float atomics) and L-BFGS linear
   at the agaricus shape (its first 8 iterations within rtol 1e-4 of one
   device's) through the apps' global bodies. Each rank holds the
   wrappers against their plain twins on its cell or rows (every level
   of a round for the histogram), times its own kernel while the other
   ranks wait at a barrier, and times the all_reduce; the parent holds
   the 2x2 products against coo_spmv and coo_spmv_t on one device. Then a
   one-rank NCCL mesh on cuda:0 runs mesh_coo_spmv and mesh_coo_spmv_t
   through NCCL's all_reduce against kernels 1 and 2: the NCCL route
   starts; several cards are not checked;
12. the serving tier ([serve], after the apps; bench.py bench_serve's
   operating point): the linear learner trained on the card at 2^26
   buckets, its w (256 MB, uncompressed) written as a snapshot set of 2
   shards, ModelServers in this process, and Routers whose scorers take
   their default device, the card. 64 fixed predict batches (1,000 rows
   of 32-64 nonzeros, N(0, 1) values, ids the trainer saw) through fetch
   and score mode are held against the trainer's predict_batch (rtol
   1e-5, atol 1e-4), and score mode against a CPU scorer's fetch mode
   bit for bit; then each mode runs closed loop for 8 s (fetch at
   concurrency 4, score at 32) while a new version, w * 2^k, is written
   every 2 s: qps, p50/p99/p999 ms, swaps and their stall, and the p50
   and mean of each serve.stage.* histogram with the share of the
   request they explain; every response must be 2^k times its batch's
   first scores for the k of the version it carries (score mode
   exactly), so a response mixed from two versions fails the phase, as
   does a failed request or a window without a swap. Then DiFacto
   (trained at the bench's width) from 3 shards, 64 batches in each
   mode against its predict_batch. The tier launches no kernel; its
   trainers' launches count with the main paths'.
13. the parameter-server plane ([ps], after [cache];
   bench.py bench_linear_ps's operating point): `python -m
   wormhole_tpu_torch.launcher.dmlc_tpu -n N -s S -- python -m
   wormhole_tpu_torch.apps.{linear,difacto} conf device=cuda
   kernel=pallas`, each launch in a session of its own under a 240 s
   timeout, its group killed after it. Linear FTRL at 2^26 buckets,
   lambda_l1 1, 100,000 synthetic Criteo rows in 4 files (25,000 rows a
   batch, in a 25,088-row capacity: the kernels' 128-row lanes), a
   25,000-row val file, max_delay 2, 2 passes: -n 1 -s 1 with async
   sync and the key cache, synchronous, and int8 + error feedback +
   byte shuffle on the wire (WH_WIRE*), then -n 2 -s 2; DiFacto at its
   width at -n 2 -s 2 over the [e2e] 2^22 file (4 parts, 65,536 rows a
   batch, 1 pass) with a 65,536-row val file. Against the single-process
   card run on the same conf (in this process: one loader for the bar,
   the solver's own for examples/s): the -n 1 -s 1 sync model the
   servers saved scores the val file within 1e-3 logloss, every other
   launch within 0.05; DiFacto's shards carry w, z, n, cnt, V and nV and
   reassemble. Per launch from the workers' [ps-wire] lines: examples/s
   of the last train round (bench.py:400), wire bytes a sync against
   the dense 5 x 2^26 x 4, perf_sec (push, pull, wait, step), the key
   cache's hits, the peak RSS, the row copies between card and host,
   and each worker's kernel launches (each must have launched its
   path's kernels and parse_libsvm on cuda); the scheduler and the
   servers must report no CUDA context. The workers are child
   processes: their launches are not in the kernels line's counts.
   DiFacto's -n 1 -s 1 sync run is held within 1e-3 of the single
   process, its -n 2 -s 2 run's saved shards to the workers' own val
   logloss; that run's distance from the single process is reported
   beside the 0.05 bar, which the synthetic labels (no signal) do not let
   the JAX package's launcher hold either (tests/torch_ps_reference.py).
   [ps] takes ~160 s of command time;
14. the BSP allreduce plane ([bsp], after [ps]): `python -m
   wormhole_tpu_torch.launcher.dmlc_tpu -n 3 -s 0 --node-timeout 30
   --max-worker-restarts 1 -- python -m
   wormhole_tpu_torch.apps.{gbdt,lbfgs_linear,lbfgs_fm} ... bsp=1
   device=cuda`, each launch in a session of its own under a 240 s
   timeout, its group killed after it, WH_OBS_DIR set so the scheduler
   writes run_report.json. GBDT at the HIGGS widths (28 features, 256
   bins, depth 6, 4 rounds) over three 40,960-row train files, one a
   rank (every rank keeps all its rows in its sketch, so the edges are
   one device's on the union of the files, byte for byte), with a
   16,384-row eval file: the model rank 0 saves against a one-device
   run in this process on the union (splits equal except at a near tie,
   every reached leaf within 1e-5 of the f64 sums of its rows: the
   [mesh] bar); then the same launch with worker 1 killed at its 12th
   allreduce (round 1's fourth level: 8 collectives a round, checked
   from the counts), respawned by the launcher, whose run report must
   show a recovery and result fetches, its model held to the same bar
   against the fault-free one and bit-identical to it, and a second
   fault-free launch bit-identical to the first (the level sums are
   integer sums on the card).
   L-BFGS linear at the agaricus shape (6,513 rows, 126 ids) read as
   3 parts, reg_L2 0.1, 30 iterations: the objective never rises and its
   first 8 iterations are within rtol 1e-4 of the single process on the
   card; then killed at allreduce #4 (inside iteration 1), its final
   objective within the same bar of the fault-free launch's; the FM
   (nfactor 8) fault-free, held the same way. Every worker prints its
   kernel launches at exit ([bsp-worker]): each must have launched
   level_hist, level_partition and parse_libsvm (L-BFGS: parse_libsvm)
   on cuda, and the scheduler must report no CUDA context. Per launch,
   bench_bsp's numbers (bench.py:551-611): the wall, bsp.allreduce_s
   mean and p99, bsp.checkpoint_s mean and the bytes a checkpoint, the
   counts of collectives and checkpoints, a kill launch's recovery
   overhead, and GBDT's ms a round. [bsp] takes ~110 s of command time;
15. the global mesh ([global], after [bsp]): `python -m
   wormhole_tpu_torch.launcher.dmlc_tpu -n 2 -s 0 --node-timeout 30 --
   python -m wormhole_tpu_torch.apps.APP ... global_mesh=1 device=cuda`,
   each launch in a session of its own under a 240 s timeout, its group
   killed after it; the two workers share the card over gloo. Linear
   FTRL at 2^22 over the [e2e] file (65,536-row global minibatches,
   32,768 a rank), 1 pass with a 65,536-row val file, model_out and a
   predict to per-rank files, then a warm start from the saved model;
   DiFacto at its width over the same file; GBDT at the HIGGS widths
   (two 40,960-row files, a 16,384-row eval file, depth 6, 4 rounds);
   k-means at the MNIST shape (4 iterations); L-BFGS linear at the
   agaricus shape as two files. Each is held against one device in this
   process on the same global batches (the ranks' blocks joined in rank
   order): val logloss and AUC within 1e-3, linear's w at rtol 1e-4 /
   atol 1e-6 and its predictions at rtol 1e-4 / atol 1e-5, DiFacto's
   tables at rtol 2e-3 / atol 2e-5, GBDT's edges byte for byte and the
   [mesh] bar on its trees, k-means and L-BFGS at [mesh]'s bars. Every
   worker prints its kernel launches ([global-worker]): each must have
   launched its path's kernels and parse_libsvm on cuda, and the
   scheduler must report no CUDA context. Per launch: the wall, ms a
   step, round or iteration, each worker's all_reduce calls and ms (gloo
   over one card: host-staged, not a multi-GPU number), and examples/s
   against one device.

The [ps], [bsp] and [global] workers are child processes: their
launches are not in the kernels line's counts, and each launch checks
its workers' own.
The launches of parse_libsvm over the apps, the passes, the k-means run,
the L-BFGS apps and [cache] make its launch count; parse_criteo's are
the Criteo passes', the convert's and the one-reader check's text side,
parse_adfea's the adfea pass's; coo_spmv_t's count
includes the k-means run's and app's and [cache]'s, and its row carries
the k-means shape's numbers ("kmeans"); every kernel's count includes
[cache]'s. The rows mesh_coo_spmv, mesh_coo_spmv_t and mesh_level_hist
carry the [mesh] ranks' launches (summed, and per rank; W1 and W2 the
linear and DiFacto meshes'), the slowest
rank's kernel times, the bound of the largest cell, and the all_reduce's
ms (gloo over one card: host-staged, not a multi-GPU number).

Every check raises on failure, so any failed phase exits non-zero. The
last two lines are one JSON object of per-kernel numbers and the result
line {"ok": true, "device": {...}}. Without CUDA, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MINIBATCH = 1 << 16
NNZ_PER_ROW = 39
DENSE_BUCKETS = 1 << 22
COMPACT_BUCKETS = 1 << 26
V_BUCKETS = 1 << 20
FM_DIM = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12          # H100 SXM data sheet, f32 outside tensor cores
TRAIN_STEPS = 4
TIMED_STEPS = 10
TIMED_WINDOWS = 5
HIGGS_ROWS = 2_000_000
HIGGS_EVAL_ROWS = 200_000
HIGGS_DIM = 28
GBDT_BINS = 256
GBDT_DEPTH = 6
GBDT_ROUNDS = 4
GBDT_TIMED_ROUNDS = 3
LEAF_ATOL = 1e-5   # the kernel path's leaves against f64 sums of their rows
GBDT_APP_ROWS = (65_536, 16_384)  # train, eval rows of the app's files
PARSE_ROWS = 65_536  # rows of each [parse] chunk
PARSE_TILE = 16_384  # the parse kernels' tile (csrc/parse.cu, formats.cu)
# where the tile-edge chunks put each piece before a tile edge
TILE_EDGE_SHIFTS = (0, 1, 2, 3, 5, 8, 13, 21, 34, 64, 100, 255, 256, 257,
                    300)
E2E_BATCHES = 8      # full minibatches in each [e2e] file
E2E_PARTS = 4        # its num_parts_per_file, and max_concurrency
KM_MINIBATCH = 16_384  # k-means at bench.py bench_kmeans's MNIST-784 shape
KM_DIM = 784
KM_K = 10
KM_NNZ = 160
KM_FILE_BATCHES = 4    # minibatches in the [kmeans] libsvm file
KM_ITERS = 5
KM_SPARSE_DIM = 1 << 20  # the hashed width the sparse path is timed at
AGARICUS_ROWS = 6_513  # the agaricus shape: 126 ids, 22 one-hot groups
LBFGS_FM_ROWS = 131_072  # rows of the [e2e] 2^22 file the FM run takes
LBFGS_ITERS = 20       # iterations of the runs on the Criteo-shaped file

KERNELS = {
    "coo_spmv": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                 "wormhole_tpu/ops/coo_kernels.py:308"),
    "coo_spmv_t": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                   "wormhole_tpu/ops/coo_kernels.py:370"),
    "tile_gather": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                    "wormhole_tpu/ops/coo_kernels.py:590"),
    "scatter_update": ("wormhole_tpu_torch/csrc/fused_update.cu",
                       "wormhole_tpu/ops/fused_update.py:329"),
    "row_tile_gather": ("wormhole_tpu_torch/csrc/fused_update.cu",
                        "wormhole_tpu/ops/fused_update.py:196"),
    "fm_push_contrib": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                        "wormhole_tpu/ops/coo_kernels.py:674"),
    "v_scatter_update": ("wormhole_tpu_torch/csrc/fused_update.cu",
                         "wormhole_tpu/ops/fused_update.py:279"),
    "level_partition": ("wormhole_tpu_torch/csrc/hist.cu",
                        "wormhole_tpu/ops/hist.py:79"),
    "level_hist": ("wormhole_tpu_torch/csrc/hist.cu",
                   "wormhole_tpu/ops/hist.py:79"),
    "parse_libsvm": ("wormhole_tpu_torch/csrc/parse.cu",
                     "wormhole_tpu/native/src/parsers.cc:41 parse_libsvm "
                     "(host C++)"),
    "parse_criteo": ("wormhole_tpu_torch/csrc/formats.cu",
                     "wormhole_tpu/native/src/parsers.cc:101 parse_criteo "
                     "(host C++)"),
    "parse_adfea": ("wormhole_tpu_torch/csrc/formats.cu",
                    "wormhole_tpu/native/src/parsers.cc:171 parse_adfea "
                    "(host C++)"),
    # the mesh wrappers: kernel 1, 2 or 8 on each rank's shard, then an
    # all_reduce ([mesh])
    "mesh_coo_spmv": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                      "wormhole_tpu/ops/coo_kernels.py:787"),
    "mesh_coo_spmv_t": ("wormhole_tpu_torch/csrc/coo_kernels.cu",
                        "wormhole_tpu/ops/coo_kernels.py:813"),
    "mesh_level_hist": ("wormhole_tpu_torch/csrc/hist.cu",
                        "wormhole_tpu/models/gbdt.py:382"),
}
MESH_WRAPPERS = {"mesh_coo_spmv": "wormhole_tpu_torch/ops/coo_kernels.py",
                 "mesh_coo_spmv_t": "wormhole_tpu_torch/ops/coo_kernels.py",
                 "mesh_level_hist": "wormhole_tpu_torch/ops/hist.py"}
LINEAR_KERNELS = ("coo_spmv", "coo_spmv_t", "tile_gather", "scatter_update")
FM_KERNELS = ("tile_gather", "row_tile_gather", "coo_spmv_t",
              "fm_push_contrib", "scatter_update", "v_scatter_update")
GBDT_KERNELS = ("level_partition", "level_hist")
PARSE_KERNELS = ("parse_libsvm", "parse_criteo", "parse_adfea")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over iters calls (CUDA events, after
    warmup); None off the card."""
    import torch

    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1) / iters


def device_ms(fn, device, iters: int = 20) -> float:
    """Device time of one call of fn: the profiler's device time (every
    kernel and memset the call enqueues) over iters calls, after one
    warm-up call; None off the card."""
    import torch

    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    for _ in range(3):  # the profiler now and then records no device event
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(device)
        us = sum(_device_us(e) for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if us > 0:
            break
    return us / 1e3 / iters


def device_split(fn, device, iters: int = 10) -> list:
    """The device ops that one call of fn enqueues, by name in the order
    of the last call: [name, ops a call, device ms a call] (the
    profiler's events over iters calls, after a warm-up call; the ops a
    call are rounded, as the profiler may drop the first event); None
    off the card."""
    import torch

    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(device)
    split = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            k = split.setdefault(e.name, [0, 0.0, 0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
            k[2] = max(k[2], e.time_range.start)
    out = []
    for name, (n, us, _) in sorted(split.items(), key=lambda kv: kv[1][2]):
        per_call = max(1, round(n / iters))
        out.append([name[:70], per_call, us / n * per_call / 1e3])
    return out


def host_us(fn, device, iters: int = 50) -> float:
    """The host's time to enqueue one call of fn: a host clock around
    iters calls with no synchronize between them (the device queue stays
    far from full); None off the card."""
    import torch

    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    return dt / iters * 1e6


def timings(fn, device, iters: int = 20, warmup: int = 3) -> dict:
    """A kernel wrapper's three times: ms by CUDA events around
    back-to-back calls (whichever is slower, the device or the host's
    enqueue), device_ms from the profiler, host_us on the host clock."""
    return dict(ms=time_ms(fn, device, iters, warmup),
                device_ms=device_ms(fn, device, iters),
                host_us=host_us(fn, device, max(iters, 50)))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work on the card: the larger of bytes over the
    memory rate and operations over the f32 rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def compare(name: str, got, want, rtol: float, atol: float,
            scale=None) -> float:
    """Max abs error of got against want; raises beyond atol + rtol *
    scale. scale defaults to |want|; for a sum, pass the sum of the
    terms' magnitudes, which bounds its rounding error in any order."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * (want.abs() if scale is None else scale)
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {got.numel()} entries beyond "
            f"atol {atol} + rtol {rtol}; max abs err {float(err.max())}")
    m = float(err.max()) if err.numel() else 0.0
    log(f"[kernel] {name}: max abs err {m:.3g} "
        f"(tolerance atol {atol} + rtol {rtol}) ok")
    return m


def ftrl_z_terms(base: dict, g, uniq, dtype, lr_eta: float):
    """|z0| + |g| + |sigma * w0| per bucket: the magnitudes of the terms
    of FTRL's z update, which bound its rounding error when they cancel
    (the plain version divides by lr_eta as a multiply by its reciprocal
    on CUDA, so sigma differs by an ulp)."""
    import torch

    from wormhole_tpu_torch.ops.coo_kernels import round_to

    z = base["z"]
    live = uniq < z.numel()
    k = uniq[live].long()
    gq = round_to(g[live], dtype)
    n0 = base["n"][k]
    sigma = (torch.sqrt(n0 + gq * gq) - torch.sqrt(n0)) / lr_eta
    out = z.abs()
    out[k] += gq.abs() + (sigma * base["w"][k]).abs()
    return out


def batches(num_buckets: int, n: int, seed: int):
    from wormhole_tpu_torch.data.synth import synth_criteo_batch

    rng = np.random.default_rng(seed)
    return [synth_criteo_batch(rng, MINIBATCH, num_buckets) for _ in range(n)]


def to_rowblock(seg, idx, val, label):
    """A synthetic COO batch as the CSR RowBlock a parser would emit."""
    from wormhole_tpu_torch.data.rowblock import RowBlock

    rows = label.shape[0]
    offset = np.arange(0, rows * NNZ_PER_ROW + 1, NNZ_PER_ROW,
                       dtype=np.int64)
    return RowBlock(label=label, offset=offset,
                    index=idx.astype(np.uint64), value=None)


# ------------------------------------------------------------- phase 1
def check_kernels(device, dense_buckets=DENSE_BUCKETS,
                  compact_buckets=COMPACT_BUCKETS, probe=None) -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns per-kernel numbers (max_abs_err, ms, device_ms, host_us,
    plain_ms, library_ms, bound_ms, bound_by), and coo_spmv_t's times on
    the compact domain (coo_spmv_t_compact). With the probes
    (finish_probe_build),
    scatter_update's also has floor_ms, the touch probe's time at the same
    keys, and coo_spmv's the pull probes' times on the same stream
    (probe)."""
    import torch

    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.ops import coo_kernels as ck
    from wormhole_tpu_torch.ops import fused_update as fu

    f32, bf16 = torch.float32, torch.bfloat16
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    gen = np.random.default_rng(11)
    out: dict = {}

    # dense regime: the bucket-sorted batch at 2^22 buckets
    seg, idx, val, _, _ = batches(dense_buckets, 1, seed=1)[0]
    p = ck.pack_sorted_coo(idx, seg, val, dense_buckets,
                           capacity=MINIBATCH * NNZ_PER_ROW)
    sidx, sseg, sval, tmap, first = (dev(p.idx), dev(p.seg), dev(p.val),
                                     dev(p.tmap), dev(p.first))
    P = p.idx.shape[0]
    live = p.val != 0
    n_live_buckets = int(np.unique(p.idx[live]).size)
    hot = int(np.bincount(p.idx[live]).max())
    n_live = int(live.sum())
    log(f"[kernel] dense batch: P={P} packed entries, {n_live} "
        f"live, {n_live_buckets} unique buckets, longest key run {hot}")
    # least stream traffic: (idx, seg, val) of each live entry and val
    # alone of each pad entry, which the kernels skip after reading val
    stream_b = n_live * 12 + (P - n_live) * 4
    w = dev(gen.standard_normal(dense_buckets).astype(np.float32))
    d = dev(gen.standard_normal(MINIBATCH).astype(np.float32))

    # sums are taken in another order (float atomics): the tolerance is
    # atol 1e-4 + rtol 1e-5 * sum of the terms' magnitudes
    errs = []
    mag = ck.coo_spmv_plain(w.abs(), sidx, sseg, sval.abs(), MINIBATCH, f32)
    for dt in (f32, bf16):
        got = ck.coo_spmv(w, sidx, sseg, sval, tmap, first, MINIBATCH, dt)
        want = ck.coo_spmv_plain(w, sidx, sseg, sval, MINIBATCH, dt)
        errs.append(compare(f"coo_spmv {dt}", got, want, 1e-5, 1e-4, mag))
    # plus one table read per live bucket and the output written once
    nb, fl = stream_b + n_live_buckets * 4 + MINIBATCH * 4, 2 * n_live
    out["coo_spmv"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, fl))),
        **timings(lambda: ck.coo_spmv(w, sidx, sseg, sval, tmap, first,
                                      MINIBATCH, f32), device),
        plain_ms=time_ms(lambda: ck.coo_spmv_plain(
            w, sidx, sseg, sval, MINIBATCH, f32), device),
        library_ms=time_ms(lambda: torch.zeros(
            MINIBATCH, device=device).index_add_(
            0, sseg, w.index_select(0, sidx) * sval), device))
    if probe is not None:
        out["coo_spmv"]["probe"] = pull_probe_ms(probe, device, sidx, sseg,
                                                 sval, MINIBATCH)
        log(f"[probe] coo_spmv dense batch: " + json.dumps(dict(
            out["coo_spmv"]["probe"],
            kernel_device_ms=out["coo_spmv"]["device_ms"])))

    errs = []
    mag = ck.coo_spmv_t_plain(d.abs(), sidx, sseg, sval.abs(),
                              dense_buckets, f32)
    for dt in (f32, bf16):
        got = ck.coo_spmv_t(d, sidx, sseg, sval, tmap, first,
                            dense_buckets, dt)
        want = ck.coo_spmv_t_plain(d, sidx, sseg, sval, dense_buckets, dt)
        errs.append(compare(f"coo_spmv_t {dt}", got, want, 1e-5, 1e-4,
                            mag))
        untouched = torch.ones(dense_buckets, dtype=torch.bool,
                               device=device)
        untouched[sidx[sval != 0].long()] = False
        if (got[untouched] != 0).any():
            raise AssertionError("coo_spmv_t: untouched bucket not exactly 0")
    # empty tiles come out exactly zero: a batch held in table tile 0
    cidx = (idx % ck.TILE).astype(np.int32)
    pc = ck.pack_sorted_coo(cidx, seg, val, dense_buckets,
                            capacity=MINIBATCH * NNZ_PER_ROW)
    gc = ck.coo_spmv_t(d, dev(pc.idx), dev(pc.seg), dev(pc.val),
                       dev(pc.tmap), dev(pc.first), dense_buckets, f32)
    if (gc[ck.TILE:] != 0).any():
        raise AssertionError("coo_spmv_t: empty tile not exactly 0")
    # plus d read once and the table-sized g written once
    nb = stream_b + MINIBATCH * 4 + dense_buckets * 4
    out["coo_spmv_t"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, 2 * n_live))),
        **timings(lambda: ck.coo_spmv_t(d, sidx, sseg, sval, tmap, first,
                                        dense_buckets, f32), device),
        plain_ms=time_ms(lambda: ck.coo_spmv_t_plain(
            d, sidx, sseg, sval, dense_buckets, f32), device),
        library_ms=time_ms(lambda: torch.zeros(
            dense_buckets, device=device).index_add_(
            0, sidx, d.index_select(0, sseg) * sval), device))

    # compacted regime: the compact domain of a 2^26-bucket batch, sized
    # by the learner's own rule
    seg, idx, val, _, _ = batches(compact_buckets, 1, seed=2)[0]
    lrn = LinearLearner(LinearConfig(
        minibatch=MINIBATCH, nnz_per_row=NNZ_PER_ROW,
        num_buckets=compact_buckets, kernel="pallas"), device=device)
    u_cap = lrn.ensure_compact(idx)
    del lrn
    if not u_cap:
        raise AssertionError("2^26 buckets did not engage the compact path")
    tc = ck.pack_tile_coo(idx, seg, val, compact_buckets, u_cap,
                          capacity=MINIBATCH * NNZ_PER_ROW,
                          rm_rows=MINIBATCH, rm_width=NNZ_PER_ROW)
    uniq, tmap_u = dev(tc.uniq), dev(tc.tmap_u)
    n_live = tc.num_uniq
    log(f"[kernel] compact batch: {n_live} unique keys in u_cap={u_cap} "
        f"slots at {compact_buckets} buckets")
    table = dev(gen.standard_normal(compact_buckets).astype(np.float32))
    t2 = table.view(-1, ck.LANES)
    errs = []
    for dt in (f32, bf16):
        got = ck.tile_gather(t2, uniq, tmap_u, dt)
        want = ck.tile_gather_plain(t2, uniq, dt)
        errs.append(compare(f"tile_gather {dt}", got, want, 0.0, 0.0))
    nb = u_cap * 8 + n_live * 4
    uniq_c = uniq.clamp(max=compact_buckets - 1)
    out["tile_gather"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, 0))),
        **timings(lambda: ck.tile_gather(t2, uniq, tmap_u, f32), device),
        plain_ms=time_ms(lambda: ck.tile_gather_plain(t2, uniq, f32),
                         device),
        library_ms=time_ms(lambda: table[uniq_c], device))

    # the compact push gives the gradient scatter_update consumes
    pc = tc.coo
    csidx, csseg, csval = dev(pc.idx), dev(pc.seg), dev(pc.val)
    g = ck.coo_spmv_t(d, csidx, csseg, csval, dev(pc.tmap), dev(pc.first),
                      u_cap, f32)
    gp = ck.coo_spmv_t_plain(d, csidx, csseg, csval, u_cap, f32)
    compare("coo_spmv_t compact f32", g, gp, 1e-5, 1e-4,
            ck.coo_spmv_t_plain(d.abs(), csidx, csseg, csval.abs(), u_cap,
                                f32))
    untouched = torch.ones(u_cap, dtype=torch.bool, device=device)
    untouched[csidx[csval != 0].long()] = False
    if (g[untouched] != 0).any():
        raise AssertionError("coo_spmv_t compact: untouched slot not "
                             "exactly 0")
    # least traffic, as the dense push's: the stream, d, g written once
    c_live = int((pc.val != 0).sum())
    nb = c_live * 12 + (pc.idx.shape[0] - c_live) * 4 + MINIBATCH * 4 \
        + u_cap * 4
    out["coo_spmv_t_compact"] = dict(
        **timings(lambda: ck.coo_spmv_t(d, csidx, csseg, csval, None, None,
                                        u_cap, f32), device),
        **dict(zip(("bound_ms", "bound_by"), bound_ms(nb, 2 * c_live))))
    log(f"[kernel] coo_spmv_t compact: "
        + json.dumps(out["coo_spmv_t_compact"]))
    hyper = dict(lr_eta=0.1, lr_beta=1.0, lambda_l1=1.0, lambda_l2=0.1)
    errs, times = [], {}
    tg = torch.Generator(device=device).manual_seed(12)
    base = {"w": torch.randn(compact_buckets, generator=tg, device=device),
            "z": torch.randn(compact_buckets, generator=tg, device=device),
            "n": 4 * torch.rand(compact_buckets, generator=tg,
                                device=device)}
    for algo, names in (("ftrl", ("z", "n", "w")), ("adagrad", ("n", "w")),
                        ("sgd", ("w",))):
        for fb in (0, 1):
            for dt in (f32, bf16):
                sk = {k: base[k].clone() for k in names}
                sp = {k: base[k].clone() for k in names}
                _, nw_k = fu.scatter_update(
                    algo, sk, g, uniq, tmap_u, None, None, fixed_bytes=fb,
                    dtype=dt, **hyper)
                nw_p = fu.scatter_update_plain(
                    algo, sp, g, uniq, fixed_bytes=fb, dtype=dt, **hyper)
                tag = f"scatter_update {algo} fixed_bytes={fb} {dt}"
                for k in names:
                    errs.append(compare(f"{tag} {k}", sk[k], sp[k],
                                        1e-5, 1e-6))
                slack = 1 + n_live // 100000
                if abs(int(nw_k) - int(nw_p)) > slack:
                    raise AssertionError(f"{tag}: |w|_0 delta {int(nw_k)} "
                                         f"vs plain {int(nw_p)}")
                if algo == "ftrl" and fb == 0 and dt == f32:
                    times.update(timings(lambda: fu.scatter_update(
                        algo, sk, g, uniq, tmap_u, None, None, dtype=f32,
                        **hyper), device))
                    times["plain_ms"] = time_ms(
                        lambda: fu.scatter_update_plain(
                            algo, sp, g, uniq, dtype=f32, **hyper), device)
    # FTRL: uniq read at every slot; g read and z, n, w read and written
    # at each live slot only (sentinel slots stop after uniq)
    nb, fl = u_cap * 4 + n_live * (4 + 24), n_live * 20
    out["scatter_update"] = dict(
        max_abs_err=max(errs), library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), bound_ms(nb, fl))), **times)
    if probe is not None:
        keys = uniq[uniq < compact_buckets].contiguous()
        out["scatter_update"]["floor_ms"] = touch_ms(probe, device, base,
                                                     keys)
    for k, v in out.items():
        log(f"[kernel] {k}: {v}")
    return out


def difacto_config(kernel: str, num_buckets=DENSE_BUCKETS,
                   v_buckets=V_BUCKETS, **over):
    """The bench's DiFacto configuration (bench.py bench_difacto, from the
    reference's learn/difacto/guide/criteo.conf) at kernel_dtype f32."""
    from wormhole_tpu_torch.models.difacto import DifactoConfig

    kw = dict(minibatch=MINIBATCH, nnz_per_row=NNZ_PER_ROW,
              num_buckets=num_buckets, v_buckets=v_buckets, dim=FM_DIM,
              threshold=2, lr_eta=0.1, lambda_l1=1.0, kernel=kernel,
              kernel_dtype="f32")
    kw.update(over)
    return DifactoConfig(**kw)


def check_fm_kernels(device, num_buckets=DENSE_BUCKETS,
                     v_buckets=V_BUCKETS, probe=None) -> dict:
    """The DiFacto path's kernels against their plain versions on one
    full-width batch packed by the learner's own pack (the second batch
    of a pass, so the count threshold admits part of the V rows).
    Returns per-kernel numbers, as check_kernels does; scatter_update's
    entry is the additive-table (cnt) variant. With the probes
    (finish_probe_build), v_scatter_update's also has floor_ms, the row
    touch probe's device time at the admitted rows."""
    import torch

    from wormhole_tpu_torch.models.difacto import DifactoLearner
    from wormhole_tpu_torch.ops import coo_kernels as ck
    from wormhole_tpu_torch.ops import fused_update as fu

    f32, bf16 = torch.float32, torch.bfloat16
    dim = FM_DIM
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    lrn = DifactoLearner(difacto_config("pallas", num_buckets, v_buckets),
                         device=device)
    data = batches(num_buckets, 2, seed=7)
    t0 = time.perf_counter()
    for seg, idx, val, label, _ in data:
        db = lrn.make_device_batch(to_rowblock(seg, idx, val, label))
        pk = lrn._pack_fm(db, train=True)
    pack_s = (time.perf_counter() - t0) / len(data)
    (ts_w, wcnts, wcoo, ts_v, vtouched, vcoo, *_rest) = pk
    uw_cap, uv_cap = lrn._fm_caps
    if lrn.dropped_slot_nnz or lrn.dropped_row_nnz:
        raise AssertionError("the pack dropped nonzeros")
    P = vcoo.idx.shape[0]
    vlive = vcoo.val != 0
    n_vlive = int(vlive.sum())
    n_rows = int((ts_v.uniq < v_buckets).sum())
    n_touched = int(vtouched.sum())
    n_w = int((ts_w.uniq < num_buckets).sum())
    hot = int(np.bincount(vcoo.idx[vlive]).max())
    tiles = np.unique(ts_v.uniq[ts_v.uniq < v_buckets].astype(np.int64)
                      * dim // ck.TILE).size
    log(f"[fm-kernel] batch: caps (uw_cap, uv_cap) = {(uw_cap, uv_cap)}, "
        f"{n_w} unique w keys, {n_rows} V rows ({n_touched} admitted), "
        f"V-side P={P} in {vcoo.tmap.shape[0]} blocks, {n_vlive} live, "
        f"hottest row {hot} entries, {tiles} V tiles touched, w-side "
        f"P={wcoo.idx.shape[0]}; host pack {pack_s:.3f} s/batch")
    del lrn
    gen = torch.Generator(device=device).manual_seed(13)
    out: dict = {}

    # row_tile_gather at the compact V rows
    uniq_v, vtm = dev(ts_v.uniq), dev(ts_v.tmap_u)
    V = 0.01 * torch.randn(v_buckets, dim, generator=gen, device=device)
    V2 = V.view(-1, ck.LANES)
    errs = []
    for dt in (f32, bf16):
        got = fu.row_tile_gather(V2, uniq_v, vtm, dim, dt)
        want = fu.row_tile_gather_plain(V2, uniq_v, dim, dt)
        errs.append(compare(f"row_tile_gather {dt}", got, want, 0.0, 0.0))
        if not torch.equal(got, fu.row_tile_gather(V2, uniq_v, vtm, dim,
                                                   dt)):
            raise AssertionError("row_tile_gather: differs from run to run")
    # uniq at every slot, V at each live row, the whole output
    nb = uv_cap * 4 + n_rows * dim * 4 + uv_cap * dim * 4
    uniq_c = uniq_v.clamp(max=v_buckets - 1)
    out["row_tile_gather"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, 0))),
        **timings(lambda: fu.row_tile_gather(V2, uniq_v, vtm, dim, f32),
                  device),
        plain_ms=time_ms(lambda: fu.row_tile_gather_plain(
            V2, uniq_v, dim, f32), device),
        library_ms=time_ms(lambda: V[uniq_c], device))

    # fm_push_contrib on the learner's operands: a = c * xv[seg],
    # b = c * val, c = d[seg] * val, from random xv and d
    Vc = fu.row_tile_gather(V2, uniq_v, vtm, dim, f32)
    sidx, vseg, vval = dev(vcoo.idx), dev(vcoo.seg), dev(vcoo.val)
    xvd = torch.randn(MINIBATCH, dim + 1, generator=gen, device=device)
    G = xvd.index_select(0, vseg)
    c = G[:, dim] * vval
    a = (c[:, None] * G[:, :dim]).contiguous()
    b = (c * vval).contiguous()
    errs = []
    mag = ck.fm_push_contrib_plain(Vc.abs(), a.abs(), -b.abs(), sidx, f32)
    for dt in (f32, bf16):
        got = ck.fm_push_contrib(Vc, a, b, sidx, None, None, dt)
        if not torch.equal(got, ck.fm_push_contrib(Vc, a, b, sidx, None,
                                                   None, dt)):
            raise AssertionError("fm_push_contrib: differs from run to run")
        want = ck.fm_push_contrib_plain(Vc, a, b, sidx, dt)
        # sums in another (fixed) order: atol 1e-4 + rtol 1e-5 * the sum
        # of the terms' magnitudes
        errs.append(compare(f"fm_push_contrib {dt}", got, want, 1e-5, 1e-4,
                            mag))
        touched = torch.zeros(uv_cap, dtype=torch.bool, device=device)
        touched[sidx[vval != 0].long()] = True
        if got[~touched].any():
            raise AssertionError("fm_push_contrib: a row with no entry is "
                                 "not exactly 0")
    # sidx, a, b of each live entry, b of each pad, V at the live rows,
    # the output; one add per term and the epilogue
    nb = (n_vlive * (8 + dim * 4) + (P - n_vlive) * 4 + n_rows * dim * 4
          + uv_cap * dim * 4)
    fl = n_vlive * (dim + 1) + 2 * uv_cap * dim
    ab = torch.cat([a, b[:, None]], dim=1)
    sidx_l = sidx.long()

    def library():
        acc = torch.zeros(uv_cap, dim + 1, device=device).index_add_(
            0, sidx_l, ab)
        return acc[:, :dim] - acc[:, dim:] * Vc

    out["fm_push_contrib"] = dict(
        max_abs_err=max(errs), **dict(zip(("bound_ms", "bound_by"),
                                          bound_ms(nb, fl))),
        **timings(lambda: ck.fm_push_contrib(Vc, a, b, sidx, None, None,
                                             f32), device),
        plain_ms=time_ms(lambda: ck.fm_push_contrib_plain(Vc, a, b, sidx,
                                                          f32), device),
        library_ms=time_ms(library, device))

    # v_scatter_update with that gradient at the admitted rows
    gV = ck.fm_push_contrib(Vc, a, b, sidx, None, None, f32)
    vt = dev(vtouched)
    nV = torch.rand(v_buckets, dim, generator=gen, device=device)
    hyper = dict(V_lr_eta=0.01, V_lr_beta=1.0, lambda_V=0.01)
    errs, bit_equal = [], {}
    for dt in (f32, bf16):
        Vk, nVk, Vp, nVp = V.clone(), nV.clone(), V.clone(), nV.clone()
        fu.v_scatter_update(Vk, nVk, gV, vt, uniq_v, vtm, None, None,
                            dim=dim, dtype=dt, **hyper)
        fu.v_scatter_update_plain(Vp, nVp, gV, vt, uniq_v, dim=dim,
                                  dtype=dt, **hyper)
        errs.append(compare(f"v_scatter_update {dt} V", Vk, Vp, 1e-5, 1e-6))
        errs.append(compare(f"v_scatter_update {dt} nV", nVk, nVp, 1e-5,
                            1e-6))
        bit_equal[str(dt)] = bool(torch.equal(Vk, Vp)
                                  and torch.equal(nVk, nVp))
        moved = (Vk != V).any(1) | (nVk != nV).any(1)
        moved[uniq_v[(uniq_v < v_buckets) & (vt > 0)].long()] = False
        if moved.any():
            raise AssertionError("v_scatter_update: an untouched row moved")
        V3, nV3 = V.clone(), nV.clone()
        fu.v_scatter_update(V3, nV3, gV, vt, uniq_v, vtm, None, None,
                            dim=dim, dtype=dt, **hyper)
        if not (torch.equal(V3, Vk) and torch.equal(nV3, nVk)):
            raise AssertionError("v_scatter_update: differs from run to run")
    # the plain version divides by V_lr_eta as a multiply by its
    # reciprocal on CUDA, so its bits may differ from the kernel's
    log(f"[fm-kernel] v_scatter_update bit-equal to plain: "
        f"{json.dumps(bit_equal)}")
    # uniq and vtouched at every slot; gV read, V and nV read and
    # written at each admitted row; about 8 operations per entry
    nb = uv_cap * 8 + n_touched * dim * 4 * 5
    Vk, nVk = V.clone(), nV.clone()
    out["v_scatter_update"] = dict(
        max_abs_err=max(errs), library_ms=None,
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(nb, 8 * n_touched * dim))),
        **timings(lambda: fu.v_scatter_update(
            Vk, nVk, gV, vt, uniq_v, vtm, None, None, dim=dim, dtype=f32,
            **hyper), device),
        plain_ms=time_ms(lambda: fu.v_scatter_update_plain(
            Vk, nVk, gV, vt, uniq_v, dim=dim, dtype=f32, **hyper), device))
    if probe is not None:
        admitted = uniq_v[(uniq_v < v_buckets) & (vt > 0)].contiguous()
        out["v_scatter_update"]["floor_ms"] = touch_rows_ms(
            probe, device, Vk, nVk, admitted)

    # scatter_update with the additive count table at uw_cap
    uniq_w = dev(ts_w.uniq)
    g = ck.coo_spmv_t(torch.randn(MINIBATCH, generator=gen, device=device),
                      dev(wcoo.idx), dev(wcoo.seg), dev(wcoo.val), None,
                      None, uw_cap, f32)
    add = dev(wcnts)
    base = {"w": torch.randn(num_buckets, generator=gen, device=device),
            "z": torch.randn(num_buckets, generator=gen, device=device),
            "n": 4 * torch.rand(num_buckets, generator=gen, device=device),
            "cnt": torch.randint(0, 4, (num_buckets,), generator=gen,
                                 device=device).float()}
    hyper = dict(lr_eta=0.1, lr_beta=1.0, lambda_l1=1.0, lambda_l2=0.0)
    errs = []
    for dt in (f32, bf16):
        sk = {k: v.clone() for k, v in base.items()}
        sp = {k: v.clone() for k, v in base.items()}
        _, nw_k = fu.scatter_update("ftrl", sk, g, uniq_w, None, None, None,
                                    dtype=dt, add_table="cnt",
                                    add_values=add, **hyper)
        nw_p = fu.scatter_update_plain("ftrl", sp, g, uniq_w, dtype=dt,
                                       add_table="cnt", add_values=add,
                                       **hyper)
        for k in base:
            errs.append(compare(f"scatter_update add=cnt {dt} {k}", sk[k],
                                sp[k], 1e-5, 1e-6,
                                ftrl_z_terms(base, g, uniq_w, dt, 0.1)
                                if k == "z" else None))
        if not torch.equal(sk["cnt"], sp["cnt"]):
            raise AssertionError("scatter_update: counts differ")
        if abs(int(nw_k) - int(nw_p)) > 1 + n_w // 100000:
            raise AssertionError(f"scatter_update add=cnt: |w|_0 delta "
                                 f"{int(nw_k)} vs plain {int(nw_p)}")
    sk = {k: v.clone() for k, v in base.items()}
    # FTRL: uniq at every slot; g, the count, z, n, w read and the four
    # tables written at each live slot
    nb, fl = uw_cap * 4 + n_w * (4 + 4 + 2 * 16), n_w * 21
    out["scatter_update"] = dict(
        max_abs_err=max(errs), library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), bound_ms(nb, fl))),
        **timings(lambda: fu.scatter_update(
            "ftrl", sk, g, uniq_w, None, None, None, dtype=f32,
            add_table="cnt", add_values=add, **hyper), device),
        plain_ms=time_ms(lambda: fu.scatter_update_plain(
            "ftrl", sk, g, uniq_w, dtype=f32, add_table="cnt",
            add_values=add, **hyper), device))
    for k, v in out.items():
        log(f"[fm-kernel] {k}: {v}")
    return out


# ------------------------------------------------------------- phase 2
def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_steps(step, steps: int) -> dict:
    """torch.profiler over `steps` calls of step(i) (one train step on a
    staged batch, or one boosting round): device time per step, its
    largest operations, and the device's idle share of the window (the
    profiler slows the host, so an upper estimate)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels and memsets): the CPU ops that
    # launched them carry the same time again
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and _device_us(e) > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows) / 1e3 / steps
    return {"profiled_step_ms": window_ms / steps,
            "device_ms_per_step": device_ms,
            "device_idle_share": max(0.0, 1 - device_ms * steps / window_ms),
            "top": [{"op": k[:90], "calls_per_step": c / steps,
                     "us_per_step": us / steps} for k, c, us in rows[:12]]}


def time_steps(lrn, staged, timed: int, windows: int, tag: str) -> float:
    """Median seconds per train step over `windows` host-timed windows of
    `timed` steps on pre-staged batches, logged with its range."""
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(timed):
            lrn.train_batch(staged[i % len(staged)])
        sync(lrn.device)
        per.append((time.perf_counter() - t0) / timed)
    dt = statistics.median(per)
    log(f"[{tag}] {1e3 * dt:.3f} ms/step median of {windows} windows of "
        f"{timed} steps (range {1e3 * min(per):.3f}-{1e3 * max(per):.3f}), "
        f"{MINIBATCH / dt:.0f} examples/sec (staged batches)")
    return dt


def run_learners(device, dense_buckets=DENSE_BUCKETS,
                 compact_buckets=COMPACT_BUCKETS, steps=TRAIN_STEPS,
                 timed=TIMED_STEPS, windows=TIMED_WINDOWS) -> dict:
    """The learner on the card through its entry points, kernel path
    against kernel=xla on the same batches. Returns examples/sec, the
    median over `windows` host-timed windows of `timed` steps each."""
    import torch

    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner

    rates = {}
    for nbk, kind, seed in ((dense_buckets, "coo", 3),
                            (compact_buckets, "tcoo", 4)):
        data = batches(nbk, steps + 2, seed)
        blks = [to_rowblock(s, i, v, y) for s, i, v, y, _ in data]
        train, held = blks[:steps], blks[steps:]
        runs = {}
        for kernel in ("pallas", "xla"):
            cfg = LinearConfig(minibatch=MINIBATCH, nnz_per_row=NNZ_PER_ROW,
                               num_buckets=nbk, algo="ftrl", lr_eta=0.1,
                               lambda_l1=1.0, kernel=kernel,
                               kernel_dtype="f32")
            lrn = LinearLearner(cfg, device=device)
            staged = [lrn.stage_batch(lrn.prepare_batch(b), train=True)
                      for b in train]
            if kernel == "pallas" and staged[0][1] != kind:
                raise AssertionError(f"{nbk} buckets: kind {staged[0][1]}, "
                                     f"expected {kind}")
            progs = [lrn.train_batch(b) for b in staged]
            ev = lrn.eval_batch(held[0])
            pred = lrn.predict_batch(held[1])
            if kernel == "pallas":
                # small-input reference: margins of 128 rows from the
                # host copy of the weights they read
                s, i, v, _, _ = data[-1]
                k = 128 * NNZ_PER_ROW
                wsub = lrn.store.state["w"][
                    torch.from_numpy(i[:k]).long().to(device)].cpu().numpy()
                want = np.zeros(128, np.float32)
                np.add.at(want, s[:k], v[:k] * wsub)
                np.testing.assert_allclose(pred[:128], want, rtol=1e-5,
                                           atol=1e-5)
            runs[kernel] = (lrn, progs, ev, pred)
            log(f"[learner] {nbk} buckets kernel={kernel}: train logloss "
                f"{[round(p['logloss'] / p['nex'], 6) for p in progs]}, "
                f"eval logloss {ev['logloss'] / ev['nex']:.6f} auc "
                f"{ev['auc'] / ev['nex']:.6f}")
            if device.type == "cuda":
                dt = time_steps(lrn, staged, timed, windows,
                                f"learner {nbk} buckets kernel={kernel}")
                rates[f"{kind if kernel == 'pallas' else 'xla'}_{nbk}"] = (
                    MINIBATCH / dt)
                prof = profile_steps(
                    lambda i: lrn.train_batch(staged[i % len(staged)]),
                    2 * timed)
                log(f"[profile] {nbk} buckets kernel={kernel}: "
                    f"{json.dumps(prof)}")
        (lk, pk, ek, yk), (lx, px, ex, yx) = runs["pallas"], runs["xla"]
        for a, b in zip(pk, px):
            if abs(a["logloss"] - b["logloss"]) / a["nex"] > 1e-3:
                raise AssertionError("train logloss differs from xla")
        if abs(ek["logloss"] - ex["logloss"]) / ek["nex"] > 1e-3:
            raise AssertionError("eval logloss differs from xla")
        if not (np.isfinite(yk).all() and yk.shape == (MINIBATCH,)):
            raise AssertionError("predict margins not finite / wrong shape")
        np.testing.assert_allclose(yk, yx, rtol=1e-4, atol=1e-5)
        # the timed steps trained both learners on the same batches too
        wk, wx = lk.store.state["w"], lx.store.state["w"]
        if not torch.allclose(wk, wx, rtol=1e-4, atol=1e-6):
            raise AssertionError(
                f"{nbk} buckets: w differs from kernel=xla, max abs "
                f"{float((wk - wx).abs().max())}")
        log(f"[learner] {nbk} buckets: kernel path matches kernel=xla "
            f"(w max abs diff {float((wk - wx).abs().max()):.3g}, "
            f"|w|_0 {lk.nnz()} vs {lx.nnz()})")
        del runs, lk, lx
    return rates


def run_difacto(device, num_buckets=DENSE_BUCKETS, v_buckets=V_BUCKETS,
                steps=TRAIN_STEPS, timed=TIMED_STEPS,
                windows=TIMED_WINDOWS) -> dict:
    """DifactoLearner on the card through its entry points, the compacted
    kernel path against kernel=xla on the same batches: train steps, one
    eval, one predict, then the six tables. Then the step time and a
    profiler pass (repeating staged train batches advances the device
    count table past the host mirror, so the comparison comes first)."""
    import torch

    from wormhole_tpu_torch.models.difacto import DifactoLearner

    data = batches(num_buckets, steps + 2, seed=8)
    blks = [to_rowblock(s, i, v, y) for s, i, v, y, _ in data]
    train, held = blks[:steps], blks[steps:]
    runs, rates = {}, {}
    for kernel in ("pallas", "xla"):
        lrn = DifactoLearner(difacto_config(kernel, num_buckets, v_buckets),
                             device=device)
        if kernel == "pallas":
            init = {k: v.clone() for k, v in lrn.ckpt_store.state.items()}
        else:  # both start from the same tables
            for k, v in init.items():
                lrn.ckpt_store.state[k].copy_(v)
            lrn.refresh_count_mirror()
        t0 = time.perf_counter()
        staged = [lrn.stage_batch(lrn.prepare_batch(b), train=True)
                  for b in train]
        prep_s = (time.perf_counter() - t0) / steps
        if staged[0][1] != ("fm" if kernel == "pallas" else "xla"):
            raise AssertionError(f"kernel={kernel}: kind {staged[0][1]}")
        progs = [lrn.train_batch(b) for b in staged]
        ev = lrn.eval_batch(held[0])
        pred = lrn.predict_batch(held[1])
        if lrn.dropped_slot_nnz or lrn.dropped_row_nnz:
            raise AssertionError(
                f"kernel={kernel}: dropped {lrn.dropped_slot_nnz} nonzeros "
                f"to the slot caps, {lrn.dropped_row_nnz} to the row cap")
        tables = {k: v.clone() for k, v in lrn.ckpt_store.state.items()}
        log(f"[difacto] kernel={kernel}: prepare+stage {prep_s:.3f} "
            f"s/batch, caps {lrn._fm_caps}, train logloss "
            f"{[round(p['logloss'] / p['nex'], 6) for p in progs]}, eval "
            f"logloss {ev['logloss'] / ev['nex']:.6f} auc "
            f"{ev['auc'] / ev['nex']:.6f}, admitted {lrn.num_admitted()}")
        runs[kernel] = (progs, ev, pred, tables)
        if device.type == "cuda":
            dt = time_steps(lrn, staged, timed, windows,
                            f"difacto kernel={kernel}")
            rates[f"difacto_{kernel}"] = MINIBATCH / dt
            prof = profile_steps(
                lambda i: lrn.train_batch(staged[i % len(staged)]), 2 * timed)
            log(f"[profile] difacto kernel={kernel}: {json.dumps(prof)}")
        del lrn, staged
    (pk, ek, yk, tk), (px, ex, yx, tx) = runs["pallas"], runs["xla"]
    for a, b in zip(pk, px):
        if abs(a["logloss"] - b["logloss"]) / a["nex"] > 1e-3:
            raise AssertionError("difacto train logloss differs from xla")
    if abs(ek["logloss"] - ex["logloss"]) / ek["nex"] > 1e-3:
        raise AssertionError("difacto eval logloss differs from xla")
    if not (np.isfinite(yk).all() and yk.shape == (MINIBATCH,)):
        raise AssertionError("difacto predictions not finite / wrong shape")
    np.testing.assert_allclose(yk, yx, rtol=1e-4, atol=1e-5)
    diffs = {}
    for k in tk:
        # the JAX package's bar between these two paths
        # (tests/test_difacto.py:205-206)
        if not torch.allclose(tk[k], tx[k], rtol=2e-3, atol=2e-5):
            raise AssertionError(
                f"difacto table {k} differs from kernel=xla, max abs "
                f"{float((tk[k] - tx[k]).abs().max())}")
        diffs[k] = float((tk[k] - tx[k]).abs().max())
    log(f"[difacto] kernel path matches kernel=xla: table max abs diffs "
        f"{json.dumps(diffs)}, predictions max abs diff "
        f"{float(np.abs(yk - yx).max()):.3g}")
    return rates


# ------------------------------------------------------------- phase 3
def criteo_text(num_buckets: int, rows: int, seed: int,
                values: bool = False) -> str:
    """Synthetic Criteo-shaped libsvm rows: a 0/1 label and 39 bucket
    keys, bare (binary) or as k:v with a 3-decimal value."""
    from wormhole_tpu_torch.data.synth import synth_criteo_batch

    rng = np.random.default_rng(seed)
    _, idx, _, label, _ = synth_criteo_batch(rng, rows, num_buckets)
    toks = idx.reshape(rows, NNZ_PER_ROW).astype(str)
    if values:
        v = rng.integers(1, 100_000, size=toks.shape) / 1000
        toks = np.char.add(np.char.add(toks, ":"), np.char.mod("%.3f", v))
    return "\n".join(f"{int(y)} " + " ".join(k)
                     for y, k in zip(label, toks)) + "\n"


def write_libsvm(path: str, num_buckets: int, rows: int, seed: int) -> None:
    with open(path, "w") as f:
        f.write(criteo_text(num_buckets, rows, seed))


def drive_app(app, args: list, num_buckets: int, train_rows: int,
              val_rows: int, seed: int):
    """An app's main() in-process on synthetic libsvm train and val files,
    with predict_out and model_out. Checks one finite prediction per val
    row; returns (val logloss from the predictions, the saved tables)."""
    from wormhole_tpu_torch.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        tr, va = (os.path.join(tmp, "train.libsvm"),
                  os.path.join(tmp, "val.libsvm"))
        write_libsvm(tr, num_buckets, train_rows, seed=seed)
        write_libsvm(va, num_buckets, val_rows, seed=seed + 1)
        pred, model = os.path.join(tmp, "pred"), os.path.join(tmp, "model")
        rc = app.main([f"train_data={tr}", f"val_data={va}",
                       f"nnz_per_row={NNZ_PER_ROW}",
                       f"num_buckets={num_buckets}", "lr_eta=0.1",
                       "lambda_l1=1", "max_data_pass=1",
                       "num_parts_per_file=1", "max_concurrency=2",
                       f"predict_out={pred}", f"model_out={model}", *args])
        if rc != 0:
            raise AssertionError(f"{app.__name__} returned {rc}")
        margins = np.loadtxt(pred + "_part-0", dtype=np.float64, ndmin=1)
        labels = np.array([float(l.split(" ", 1)[0])
                           for l in open(va).read().splitlines()])
        if margins.shape != (val_rows,) or not np.isfinite(margins).all():
            raise AssertionError(f"{app.__name__} predictions: shape "
                                 f"{margins.shape}, finite "
                                 f"{np.isfinite(margins).all()}")
        ll = float(np.mean(np.logaddexp(0.0, margins) - labels * margins))
        if not math.isfinite(ll):
            raise AssertionError(f"{app.__name__}: val logloss {ll}")
        return ll, ckpt.load_parts(model)


def run_app(device, num_buckets=COMPACT_BUCKETS, minibatch=MINIBATCH,
            train_rows=2 * MINIBATCH, val_rows=MINIBATCH) -> float:
    """The linear app at 2^26 buckets."""
    from wormhole_tpu_torch.apps import linear as app

    ll, saved = drive_app(app, [f"minibatch={minibatch}", "algo=ftrl",
                                f"device={device}"],
                          num_buckets, train_rows, val_rows, seed=5)
    w = saved["w"]
    if w.shape != (num_buckets,):
        raise AssertionError(f"model w {w.shape}")
    log(f"[app] {val_rows} predictions, val logloss from predictions "
        f"{ll:.6f}, model |w|_0 {int(np.count_nonzero(w))}")
    return ll


def run_difacto_app(device, num_buckets=DENSE_BUCKETS, v_buckets=V_BUCKETS,
                    minibatch=MINIBATCH, train_rows=2 * MINIBATCH,
                    val_rows=MINIBATCH) -> float:
    """The difacto app at the DiFacto width; model_out must hold both
    table groups."""
    from wormhole_tpu_torch.apps import difacto as app

    ll, saved = drive_app(app, [f"minibatch={minibatch}",
                                f"v_buckets={v_buckets}", f"dim={FM_DIM}",
                                "threshold=2", "kernel=pallas",
                                f"device={device}"],
                          num_buckets, train_rows, val_rows, seed=9)
    shapes = {k: v.shape for k, v in saved.items()}
    want = {"w": (num_buckets,), "z": (num_buckets,), "n": (num_buckets,),
            "cnt": (num_buckets,), "V": (v_buckets, FM_DIM),
            "nV": (v_buckets, FM_DIM)}
    if shapes != want:
        raise AssertionError(f"difacto model tables {shapes}")
    log(f"[difacto-app] {val_rows} predictions, val logloss from "
        f"predictions {ll:.6f}, model tables {shapes}, admitted "
        f"{int((saved['cnt'] >= 2).sum())}")
    return ll


# ---------------------------------------------------------------- gbdt
def make_higgs(rows=HIGGS_ROWS, eval_rows=HIGGS_EVAL_ROWS, dim=HIGGS_DIM,
               max_bin=GBDT_BINS):
    """The bench's HIGGS-shaped data (bench.py bench_gbdt: seed 3, edges
    from the first 2^17 rows, binned on the host in chunks), plus
    eval_rows more rows from the same generator. Returns (edges, train
    bins, train labels, eval bins, eval labels) as numpy arrays."""
    from wormhole_tpu_torch.data.synth import synth_higgs
    from wormhole_tpu_torch.models.gbdt import bin_matrix, quantile_edges

    rng = np.random.default_rng(3)
    X, y = synth_higgs(rng, rows, dim)
    edges = quantile_edges(X[: 1 << 17], max_bin)

    def bins(X):
        out = np.empty(X.shape, np.uint8)
        for lo in range(0, X.shape[0], 1 << 18):
            out[lo:lo + (1 << 18)] = bin_matrix(X[lo:lo + (1 << 18)], edges)
        return out

    binned = bins(X)
    Xe, ye = synth_higgs(rng, eval_rows, dim)
    return edges, binned, y, bins(Xe), ye


def gbdt_learner(device, hist_kernel: str, edges, dim: int,
                 depth=GBDT_DEPTH, rounds=GBDT_ROUNDS, max_bin=GBDT_BINS):
    """The bench's GBDT configuration (bench.py bench_gbdt)."""
    from wormhole_tpu_torch.models.gbdt import GbdtConfig, GbdtLearner

    lrn = GbdtLearner(GbdtConfig(dim=dim, max_depth=depth, num_round=rounds,
                                 eta=0.3, max_bin=max_bin,
                                 hist_kernel=hist_kernel), device=device)
    lrn.edges = edges
    return lrn


def binned_dataset(device, binned, label):
    import torch

    from wormhole_tpu_torch.models.gbdt import BinnedDataset

    return BinnedDataset(
        binned=torch.from_numpy(binned).to(device),
        label=torch.from_numpy(label).to(device),
        mask=torch.ones(label.shape[0], device=device),
        num_real=label.shape[0])


def round_levels(device, higgs, depth=GBDT_DEPTH, max_bin=GBDT_BINS):
    """(dataset, [(g, h, rel, num_nodes)]): what level_hist takes at each
    level of a real boosting round (the second round of the learner, so g
    and h are not constant) on the HIGGS data."""
    from wormhole_tpu_torch.models import gbdt

    edges, binned_np, y, _, _ = higgs
    lrn = gbdt_learner(device, "mxu", edges, binned_np.shape[1], depth=depth,
                       rounds=2, max_bin=max_bin)
    ds = binned_dataset(device, binned_np, y)
    calls = []
    real = gbdt.level_hist

    def recording(binned, g, h, rel, num_nodes, B):
        calls.append((g, h, rel, num_nodes))
        return real(binned, g, h, rel, num_nodes, B)

    gbdt.level_hist = recording
    try:
        margin = lrn._base_margins(ds)
        _, _, margin = lrn._round(ds, margin)
        calls.clear()
        lrn._round(ds, margin)
    finally:
        gbdt.level_hist = real
    if [c[3] for c in calls] != [1] + [2 ** d for d in range(depth - 1)]:
        raise AssertionError(f"levels of a round: {[c[3] for c in calls]}")
    return ds, calls


def check_hist_kernel(device, higgs, depth=GBDT_DEPTH,
                      max_bin=GBDT_BINS) -> dict:
    """level_hist against its plain version (with f64 accumulators) on
    the inputs the main path gives it: the (g, h, rel, num_nodes) of every
    level of a real boosting round (the second round of the learner, so g
    and h are not constant), once with the quantile bins and once with the same rows in 0/1 bins
    (every row of a feature in one of two cells, the mushroom data's
    shape). Returns the kernel's numbers over the levels of a round with
    quantile bins (times and bound averaged, the largest error), and each
    level's, of both kinds of bins, under `per_level`; and the same for
    level_partition (the rows grouped by node, which level_hist launches
    first), held exactly against a stable sort at each level. Returns
    {"level_hist": ..., "level_partition": ...}."""
    import torch

    from wormhole_tpu_torch.ops import hist as hk

    rows, F = higgs[1].shape
    B = max_bin
    ds, calls = round_levels(device, higgs, depth, max_bin)

    binary = (ds.binned >= B // 2).to(torch.uint8)
    ones = torch.ones(rows, device=device)
    levels, parts = [], []
    # rtol 1e-5 with quantile bins (a cell sums a few thousand rows), 2e-4
    # with 0/1 bins (a cell sums up to a million rows): the bars of the
    # f32 kernel before the fixed point, kept. A fixed-point term is off
    # by at most 2^(r + e - 63) (max|g| < 2^e, rows <= 2^r), far within
    # both.
    for kind, bins, rtol in (("quantile", ds.binned, 1e-5),
                             ("binary", binary, 2e-4)):
        for d, (g, h, rel, nodes) in enumerate(calls):
            n_active = int(((rel >= 0) & (rel < nodes)).sum())
            if kind == "quantile":
                parts.append(check_partition(rel, nodes, n_active, d, device))
            tag = f"level_hist {kind} bins level {d} nodes {nodes}"
            G, H = hk.level_hist(bins, g, h, rel, nodes, B)
            G2, H2 = hk.level_hist(bins, g, h, rel, nodes, B)
            # the card's sums are integers: every launch gives the same
            # bits, those of the fixed-point rule in plain ops (off the
            # card level_hist is the plain f32 scatter)
            same_bits = bool(torch.equal(G, G2) and torch.equal(H, H2))
            rule_bits = True
            if device.type == "cuda":
                Gf, Hf = hk.level_hist_fixed_plain(bins, g, h, rel, nodes, B)
                rule_bits = bool(torch.equal(G, Gf) and torch.equal(H, Hf))
                del Gf, Hf
            del G2, H2
            if not (same_bits and rule_bits):
                raise AssertionError(
                    f"{tag}: two launches give equal bits {same_bits}, the "
                    f"fixed-point rule's bits {rule_bits}")
            # the plain version with f64 accumulators: atol 1e-4 + rtol *
            # the sum of the terms' magnitudes (h is not negative)
            Gp, Hp = hk.level_hist_plain(bins, g, h, rel, nodes, B,
                                         acc_dtype=torch.float64)
            Gmag, cnt = hk.level_hist_plain(bins, g.abs(), ones, rel, nodes,
                                            B, acc_dtype=torch.float64)
            share = max(float(((G - Gp).abs() / Gmag.clamp(min=1)).max()),
                        float(((H - Hp).abs() / Hp.clamp(min=1)).max()))
            log(f"[hist-kernel] {tag}: largest error over the sum of its "
                f"cell's magnitudes {share:.3g}")
            e = max(compare(f"{tag} G", G, Gp, rtol, 1e-4, Gmag),
                    compare(f"{tag} H", H, Hp, rtol, 1e-4, Hp))
            # the plain version as hist_kernel=xla runs it (f32 running
            # sums, the JAX package's scatter) drifts further
            G32, H32 = hk.level_hist_plain(bins, g, h, rel, nodes, B)
            drift = max(float((G32 - Gp).abs().max()),
                        float((H32 - Hp).abs().max()))
            del G32, H32
            if G[cnt == 0].any() or H[cnt == 0].any():
                raise AssertionError(f"{tag}: a cell no row reaches is not "
                                     f"exactly 0")
            # least traffic: rel of every row; g, h and the F bin bytes of
            # each row in the level; the output once. Two adds per (row,
            # feature).
            nb = rows * 4 + n_active * (8 + F) + 2 * nodes * F * B * 4
            flat = hk.hist_index(bins, rel, nodes, B)
            gsrc = g[:, None].expand(rows, F).reshape(-1)
            hsrc = h[:, None].expand(rows, F).reshape(-1)
            cells = (nodes + 1) * F * B

            def library():
                torch.zeros(cells, device=device).index_add_(0, flat, gsrc)
                torch.zeros(cells, device=device).index_add_(0, flat, hsrc)

            lv = dict(
                bins=kind, level=d, num_nodes=nodes, active_rows=n_active,
                max_abs_err=e, max_err_over_magnitudes=share,
                plain_f32_max_abs_err=drift,
                equal_bits_in_two_launches=same_bits,
                fixed_point_rule_bits=rule_bits,
                **dict(zip(("bound_ms", "bound_by"),
                           bound_ms(nb, 2 * n_active * F))),
                **timings(lambda: hk.level_hist(bins, g, h, rel, nodes, B),
                          device, iters=10),
                plain_ms=time_ms(lambda: hk.level_hist_plain(
                    bins, g, h, rel, nodes, B), device, iters=5, warmup=1),
                library_ms=time_ms(library, device, iters=5, warmup=1))
            log(f"[hist-kernel] {json.dumps(lv)}")
            levels.append(lv)
            del flat, gsrc, hsrc, Gp, Hp, Gmag, cnt
    q = [lv for lv in levels if lv["bins"] == "quantile"]
    out = {"level_hist": mean_over_levels(q), "level_partition":
           mean_over_levels(parts)}
    out["level_hist"]["per_level"] = levels
    for name, k in out.items():
        log(f"[hist-kernel] {name}, mean over the {len(q)} levels of a "
            f"round: " + json.dumps({a: v for a, v in k.items()
                                     if a != "per_level"}))
    return out


def mean_over_levels(levels: list) -> dict:
    """A kernel's row of the kernels line from its per-level numbers:
    times and bound averaged, the largest error."""
    mean = lambda k: (None if levels[0][k] is None  # noqa: E731
                      else sum(lv[k] for lv in levels) / len(levels))
    return dict(max_abs_err=max(lv["max_abs_err"] for lv in levels),
                ms=mean("ms"), device_ms=mean("device_ms"),
                host_us=mean("host_us"), plain_ms=mean("plain_ms"),
                library_ms=mean("library_ms"), bound_ms=mean("bound_ms"),
                bound_by=levels[0]["bound_by"], per_level=levels)


def check_partition(rel, nodes: int, n_active: int, level: int,
                    device) -> dict:
    """level_partition against its plain version: node_start and the
    first node_start[-1] entries of order equal, exactly. Its library call
    is one stable torch.sort of rel (all rows by node, those outside the
    level included); its bound reads rel once and writes order and
    node_start once."""
    import torch

    from wormhole_tpu_torch.ops import hist as hk

    order, start = hk.level_partition(rel, nodes)
    want_order, want_start = hk.level_partition_plain(rel, nodes)
    if not (torch.equal(start, want_start)
            and torch.equal(order[:n_active], want_order)):
        raise AssertionError(f"level_partition level {level} nodes {nodes}: "
                             f"differs from the stable sort")
    nb = 4 * (rel.shape[0] + n_active + nodes + 1)
    lv = dict(level=level, num_nodes=nodes, active_rows=n_active,
              max_abs_err=0.0,
              **dict(zip(("bound_ms", "bound_by"), bound_ms(nb, 0))),
              **timings(lambda: hk.level_partition(rel, nodes), device,
                        iters=10),
              plain_ms=time_ms(lambda: hk.level_partition_plain(rel, nodes),
                               device, iters=5, warmup=1),
              library_ms=time_ms(lambda: torch.sort(rel, stable=True),
                                 device, iters=5, warmup=1))
    log(f"[hist-kernel] level_partition {json.dumps(lv)}")
    return lv


# Probes, built beside the kernels. touch: the least time scatter_update's
# access pattern allows, one thread per live key that reads z, n and w at
# its key and writes them back, nothing else. touch_rows: the same for
# v_scatter_update, one thread per 16 bytes of each admitted row of V and
# of nV, read and written back, from a list of the rows. pull_read and pull_red: what
# bounds coo_spmv, one thread per stream entry that reads val, and idx and
# seg where val != 0 (read), then adds val at seg with one global f32 red
# (red), without the gather of w.
PROBE_CU = r"""
#include <cuda_runtime.h>
__global__ void touch(float* z, float* n, float* w, const int* keys, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int k = keys[i];
  const float a = z[k], b = n[k], c = w[k];
  z[k] = a + 1.0f;
  n[k] = b + 1.0f;
  w[k] = c + 1.0f;
}
__global__ void touch_rows(float4* V, float4* nV, const int* rows, int m,
                           int vecs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * vecs) return;
  const long k = (long)rows[i / vecs] * vecs + i % vecs;
  float4 a = V[k], b = nV[k];
  a.x += 1.0f;
  b.x += 1.0f;
  V[k] = a;
  nV[k] = b;
}
template <bool kRed>
__global__ void pull_probe(const int* idx, const int* seg, const float* val,
                           float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = val[i];
  if (v == 0.0f) return;
  const int k = idx[i], r = seg[i];
  if (kRed) {
    atomicAdd(&out[r], v);
  } else if (k == -1 && r == -1) {
    out[0] = v;  // never: keeps the loads
  }
}
extern "C" int wh_touch(void* z, void* n, void* w, const void* keys, int m,
                        void* stream) {
  touch<<<(m + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (float*)z, (float*)n, (float*)w, (const int*)keys, m);
  return (int)cudaGetLastError();
}
extern "C" int wh_touch_rows(void* V, void* nV, const void* rows, int m,
                             int vecs, void* stream) {
  const int n = m * vecs;
  if (n > 0) {
    touch_rows<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (float4*)V, (float4*)nV, (const int*)rows, m, vecs);
  }
  return (int)cudaGetLastError();
}
extern "C" int wh_pull_probe(const void* idx, const void* seg,
                             const void* val, void* out, int n, int red,
                             void* stream) {
  auto k = red ? pull_probe<true> : pull_probe<false>;
  k<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)seg, (const float*)val, (float*)out, n);
  return (int)cudaGetLastError();
}
"""


def start_probe_build():
    """nvcc of PROBE_CU into build/, started beside the kernels' build."""
    from wormhole_tpu_torch.ops import _cuda

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, so = _cuda.BUILD_DIR / "probe.cu", _cuda.BUILD_DIR / "libprobe.so"
    src.write_text(PROBE_CU)
    return subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def finish_probe_build(proc, so):
    import ctypes

    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of the probes failed:\n{text}")
    lib = ctypes.CDLL(str(so))
    lib.wh_touch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                     ctypes.c_void_p]
    lib.wh_pull_probe.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.wh_touch_rows.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def pull_probe_ms(probe, device, sidx, sseg, sval, num_rows: int) -> dict:
    """The pull probes' device times (profiler) on a stream: read reads it
    (pads: val only), red adds one global f32 red per live entry too. (A
    probe's enqueue through ctypes takes about as long as the probe, so
    CUDA events around back-to-back calls would time the host.)"""
    import torch

    out = torch.zeros(num_rows, device=device)

    def run(red):
        rc = probe.wh_pull_probe(sidx.data_ptr(), sseg.data_ptr(),
                                 sval.data_ptr(), out.data_ptr(),
                                 sidx.numel(), red, torch.cuda.current_stream(
                                     device).cuda_stream)
        if rc:
            raise RuntimeError(f"pull probe: CUDA error {rc}")

    return {"read_device_ms": device_ms(lambda: run(0), device),
            "red_device_ms": device_ms(lambda: run(1), device)}


def touch_ms(touch, device, state: dict, keys) -> float:
    """The touch probe's time (CUDA events) on the state tables at keys."""
    import torch

    def run():
        rc = touch.wh_touch(state["z"].data_ptr(), state["n"].data_ptr(),
                            state["w"].data_ptr(), keys.data_ptr(),
                            keys.numel(), torch.cuda.current_stream(
                                device).cuda_stream)
        if rc:
            raise RuntimeError(f"touch probe: CUDA error {rc}")

    return time_ms(run, device)


def touch_rows_ms(probe, device, V, nV, rows) -> float:
    """The row touch probe's device time (profiler) on (num_rows, dim) V
    and nV at rows (dim a multiple of 4)."""
    import torch

    vecs = V.shape[1] // 4

    def run():
        rc = probe.wh_touch_rows(V.data_ptr(), nV.data_ptr(), rows.data_ptr(),
                                 rows.numel(), vecs,
                                 torch.cuda.current_stream(device).cuda_stream)
        if rc:
            raise RuntimeError(f"touch_rows probe: CUDA error {rc}")

    return device_ms(run, device)


def start_ptxas_report() -> dict:
    """nvcc of every csrc/ source to a cubin with ptxas's report (one nvcc
    each), started beside the kernels' own build."""
    from wormhole_tpu_torch.ops import _cuda

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _cuda.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = {}
    for name in _cuda.SOURCES:
        cubin = _cuda.BUILD_DIR / f"{name}-report.cubin"
        cmd = [_cuda._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
               str(cubin), str(_cuda.CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       cubin)
    return procs


def finish_ptxas_report(procs: dict) -> None:
    """Prints ptxas's figures for each kernel of each source (over a
    kernel's template instances: the fewest and most registers, the most
    spilled bytes and shared memory), and which SASS the atomics of
    level_hist_kernel (integer adds, shared and device memory) and the
    f32 atomicAdd of pull_kernel (device memory) became: native adds, or
    a compare-and-swap loop (.CAS, .CAST.SPIN)."""
    import re
    import shutil

    for src, (proc, _) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -cubin of {src}.cu failed:\n{text}")
        figures, name = {}, None
        for line in text.splitlines():
            m = re.search(r"entry function '\w*?\d+([a-z_]+_kernel)[EI]", line)
            if m:
                name = m.group(1)
                figures.setdefault(name, {"regs": [], "spill": 0, "smem": 0})
                continue
            if name is None:
                continue
            f = figures[name]
            if m := re.search(r"(\d+) bytes spill stores", line):
                f["spill"] = max(f["spill"], int(m.group(1)))
            if m := re.search(r"Used (\d+) registers", line):
                f["regs"].append(int(m.group(1)))
            if m := re.search(r"(\d+) bytes smem", line):
                f["smem"] = max(f["smem"], int(m.group(1)))
        for k, f in figures.items():
            log(f"[ptxas] {src}.cu {k}: {min(f['regs'])}-{max(f['regs'])} "
                f"registers over {len(f['regs'])} instances, up to "
                f"{f['spill']} bytes spilled, {f['smem']} bytes static smem")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[sass] cuobjdump not found: the atomics' SASS was not read")
        return
    for tag, src, kernel, what in (
            ("hist-sass", "hist", "level_hist_kernel",
             "shared-memory and device-memory atomics (the 32-bit integer "
             "adds of the tile, the 64-bit adds of the merge)"),
            ("pull-sass", "coo_kernels", "pull_kernel",
             "global-memory atomics (its f32 atomicAdd)")):
        ops = sass_atomics(tool, procs[src][1], kernel)
        cas = any(".CAS" in k for k in ops)
        log(f"[{tag}] {kernel} {what} {ops}: "
            + ("a compare-and-swap loop, not a native add" if cas
               else "native adds"))


def sass_atomics(tool: str, cubin, kernel: str) -> dict:
    """The atomic and reduction instructions in the SASS of a kernel's
    instances in a cubin, counted by their full opcode."""
    import re

    sass = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    ops = {}
    for body in re.split(r"\n\s*Function : ", sass):
        if not re.match(rf"\S*{kernel}", body):
            continue
        for m in re.finditer(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)"
                             r"(?:\.[A-Z0-9_]+)+)", body):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return ops


def tree_walk(trees: dict, r: int, binned: np.ndarray) -> np.ndarray:
    """Leaf value of round r's tree for each row, walked on the host."""
    sf, sb, isp, lv = (trees[k][r] for k in ("split_feat", "split_bin",
                                             "is_split", "leaf_value"))
    node = np.zeros(binned.shape[0], np.int64)
    for _ in range(int(np.log2(sf.shape[0] + 1))):
        bv = binned[np.arange(binned.shape[0]), sf[node]]
        node = np.where(isp[node], 2 * node + 1 + (bv > sb[node]), node)
    return lv[node]


def split_gains(lrn, ds, r: int, t: int, candidates) -> list:
    """Gain of each (feature, bin) candidate at node t of round r of
    lrn's model, from the sums over the rows that reach t, in f64."""
    import torch

    cfg = lrn.cfg
    margin = torch.from_numpy(lrn.predict_margin(ds, num_round=r)).to(
        ds.label.device)
    g, h = lrn._grad_hess(margin, ds.label, ds.mask)
    path = [t]
    while path[-1] > 0:
        path.append((path[-1] - 1) // 2)
    tree = lrn._tree_tensors(r)
    here = torch.ones_like(ds.label, dtype=torch.bool)
    for child, parent in zip(path[:-1], path[1:]):   # root-ward pairs
        bv = ds.binned[:, int(tree["split_feat"][parent])]
        right = bv > int(tree["split_bin"][parent])
        here &= right if child == 2 * parent + 2 else ~right
    g, h = g[here].double(), h[here].double()
    Gt, Ht, lam = g.sum(), h.sum(), cfg.reg_lambda
    out = []
    for f, b in candidates:
        left = ds.binned[here, f] <= b
        GL, HL = g[left].sum(), h[left].sum()
        GR, HR = Gt - GL, Ht - HL
        out.append(float(0.5 * (GL * GL / (HL + lam) + GR * GR / (HR + lam)
                                - Gt * Gt / (Ht + lam)) - cfg.gamma))
    return out


def leaf_reference(lrn, ds, r: int):
    """Round r's leaf values recomputed from the rows that end in each
    node under lrn's own tree, with f64 sums: (values, reached), both
    over the heap's nodes."""
    import torch

    cfg = lrn.cfg
    margin = torch.from_numpy(lrn.predict_margin(ds, num_round=r)).to(
        ds.label.device)
    g, h = lrn._grad_hess(margin, ds.label, ds.mask)
    tree = lrn._tree_tensors(r)
    node = lrn._route(ds, tree).long()
    T = tree["leaf_value"].shape[0]
    G, H = (torch.zeros(T, dtype=torch.float64, device=node.device
                        ).index_add_(0, node, x.double()) for x in (g, h))
    reached = torch.bincount(node, minlength=T) > 0
    want = -G / (H + cfg.reg_lambda) * cfg.eta
    return want.cpu().numpy(), reached.cpu().numpy()


def time_rounds(lrn, train, timed: int, windows: int, tag: str):
    """Median seconds per boosting round over `windows` host-timed windows
    of `timed` rounds from the base margins, logged with its range.
    Returns it and the one-round step (for the profiler pass)."""
    state = [lrn._base_margins(train)]

    def one_round(_i):
        state[0] = lrn._round(train, state[0])[2]

    one_round(0)
    sync(lrn.device)
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(timed):
            one_round(i)
        sync(lrn.device)
        per.append((time.perf_counter() - t0) / timed)
    dt = statistics.median(per)
    rows = train.binned.shape[0]
    log(f"[{tag}] {1e3 * dt:.3f} ms/round median of {windows} windows of "
        f"{timed} rounds (range {1e3 * min(per):.3f}-{1e3 * max(per):.3f}), "
        f"{1 / dt:.2f} rounds/sec, {rows / dt:.0f} rows/sec ({rows} rows, "
        f"depth {lrn.cfg.max_depth})")
    return dt, one_round


def compare_trees(tag: str, la, lb, ds, rounds: int) -> tuple:
    """Trees of two GBDT learners, node by node: a split may differ only
    at a near tie (gains within 1e-4 relative, taken in f64 over lb's
    node's rows), after which the rounds are not comparable. Returns
    (splits that differ, the round of the near tie or None)."""
    differing, tie_round = 0, None
    for r in range(rounds):
        for t in np.nonzero(la.trees["is_split"][r]
                            | lb.trees["is_split"][r])[0]:
            a = tuple(int(la.trees[k][r][t])
                      for k in ("is_split", "split_feat", "split_bin"))
            b = tuple(int(lb.trees[k][r][t])
                      for k in ("is_split", "split_feat", "split_bin"))
            if a == b:
                continue
            differing += 1
            ga, gb = split_gains(lb, ds, r, int(t), [a[1:], b[1:]])
            log(f"[{tag}] round {r} node {t}: (split, feature, bin) {a} vs "
                f"{b}; gains in the second's node {ga!r} vs {gb!r}, gap "
                f"{abs(ga - gb):.3g}")
            if a[0] != b[0] or abs(ga - gb) > 1e-4 * max(abs(ga), abs(gb)):
                raise AssertionError(f"[{tag}] round {r} node {t}: the "
                                     f"splits differ and not at a near tie")
            tie_round = r
            break
        if tie_round is not None:
            break
    return differing, tie_round


def run_gbdt(device, higgs, depth=GBDT_DEPTH, rounds=GBDT_ROUNDS,
             timed=GBDT_TIMED_ROUNDS, windows=TIMED_WINDOWS,
             max_bin=GBDT_BINS) -> dict:
    """GbdtLearner on the card through fit_prepared with an eval set and
    the training set, hist_kernel=mxu (the level_hist kernel) against
    hist_kernel=xla (the plain scatter) on the same data: trees node by
    node, last-round metrics, predict_margin. A split may differ only at
    a near tie (gains within 1e-4 relative, taken in f64 from the rows of
    the node); the rounds after one are then not comparable. Then the
    time per round and a profiler pass, for each path. Returns rounds per
    second."""
    import torch

    edges, binned_np, y, ebinned_np, ye = higgs
    rows, F = binned_np.shape
    train = binned_dataset(device, binned_np, y)
    held = binned_dataset(device, ebinned_np, ye)
    runs, rates = {}, {}
    for hk in ("mxu", "xla"):
        lrn = gbdt_learner(device, hk, edges, F, depth, rounds, max_bin)
        t0 = time.perf_counter()
        last = lrn.fit_prepared(train, [("test", held), ("train", train)])
        sync(device)
        fit_s = time.perf_counter() - t0
        pred = lrn.predict_margin(held)
        log(f"[gbdt] hist_kernel={hk}: {rounds} rounds with 2 eval sets in "
            f"{fit_s:.3f} s, last {json.dumps(last)}")
        runs[hk] = (lrn, last, pred)
        if device.type == "cuda":
            dt, one_round = time_rounds(lrn, train, timed, windows,
                                        f"gbdt hist_kernel={hk}")
            rates[f"gbdt_{hk}_rounds_per_sec"] = 1 / dt
            prof = profile_steps(one_round, 2 * timed)
            log(f"[profile] gbdt hist_kernel={hk}: {json.dumps(prof)}")
    (lk, mk, pk), (lx, mx, px) = runs["mxu"], runs["xla"]

    # small-input reference: margins of 128 held rows from a host walk of
    # the kernel path's trees
    want = np.full(128, lk._base_margin(), np.float32)
    for r in range(rounds):
        want += tree_walk(lk.trees, r, ebinned_np[:128])
    np.testing.assert_allclose(pk[:128], want, rtol=1e-5, atol=1e-5)
    if not (np.isfinite(pk).all() and pk.shape == (ye.shape[0],)):
        raise AssertionError("gbdt predictions not finite / wrong shape")

    # the kernel path's splits against the xla path's
    differing, tie_round = compare_trees("gbdt", lk, lx, train, rounds)
    log(f"[gbdt] splits that differ between the kernel path and "
        f"hist_kernel=xla: {differing}"
        + ("" if tie_round is None else
           f" (a near tie in round {tie_round}; later rounds not compared)"))
    same_rounds = rounds if tie_round is None else tie_round
    leaf_diff = float(np.abs(lk.trees["leaf_value"][:same_rounds]
                             - lx.trees["leaf_value"][:same_rounds]).max()
                      ) if same_rounds else 0.0
    # the xla path's f32 running sums drift by up to 3e-5 of a cell
    # (plain_f32_max_abs_err above), and its leaves and margins with them
    if leaf_diff > 5e-4:
        raise AssertionError(f"leaf values differ by {leaf_diff}")
    # each path's leaves against f64 sums over the rows of its own leaves
    off = {}
    for hk, (lrn, _, _) in runs.items():
        off[hk] = 0.0
        for r in range(rounds):
            want, reached = leaf_reference(lrn, train, r)
            off[hk] = max(off[hk], float(np.abs(
                lrn.trees["leaf_value"][r] - want)[reached].max()))
    log(f"[gbdt] leaf_value max abs distance from f64 sums over each "
        f"leaf's rows: kernel path {off['mxu']:.3g}, hist_kernel=xla "
        f"{off['xla']:.3g}")
    if off["mxu"] > LEAF_ATOL:
        raise AssertionError(f"kernel path's leaf values are {off['mxu']} "
                             f"from the f64 sums")
    # metrics: within 1e-4 when the trees agree, 1e-3 after a near tie
    bar = 1e-4 if tie_round is None else 1e-3
    for name in mk:
        for k in mk[name]:
            if abs(mk[name][k] - mx[name][k]) > bar:
                raise AssertionError(
                    f"gbdt {name}-{k}: {mk[name][k]} vs xla {mx[name][k]}")
    if tie_round is None:
        np.testing.assert_allclose(pk, px, rtol=1e-4, atol=5e-4)
    log(f"[gbdt] kernel path matches hist_kernel=xla: leaf_value max abs "
        f"diff {leaf_diff:.3g} over {same_rounds} rounds, predictions max "
        f"abs diff {float(np.abs(pk - px).max()):.3g}, metrics within {bar}")
    return rates


def higgs_text(rows: int, dim: int, seed: int, fmt: str = "%.5f") -> str:
    """HIGGS-shaped libsvm rows: a 0/1 label and dim features f:<fmt>."""
    from wormhole_tpu_torch.data.synth import synth_higgs

    X, y = synth_higgs(np.random.default_rng(seed), rows, dim)
    cols = [np.char.add(f"{f}:", np.char.mod(fmt, X[:, f]))
            for f in range(dim)]
    lines = [f"{int(t)} " + " ".join(c) for t, c in zip(y, zip(*cols))]
    return "\n".join(lines) + "\n"


def write_higgs_libsvm(path: str, rows: int, dim: int, seed: int) -> None:
    with open(path, "w") as f:
        f.write(higgs_text(rows, dim, seed))


def run_gbdt_app(device, rows=GBDT_APP_ROWS, dim=HIGGS_DIM,
                 depth=GBDT_DEPTH, max_bin=GBDT_BINS, rounds=3) -> float:
    """The gbdt app in-process on synthetic HIGGS-shaped libsvm files:
    task=train with eval data and model_out, then task=pred from that
    model. Checks one probability per eval row; returns their logloss."""
    from wormhole_tpu_torch.apps import gbdt as app
    from wormhole_tpu_torch.models.gbdt import GbdtLearner

    train_rows, eval_rows = rows
    load = GbdtLearner.load_dataset
    loads = []

    def timed_load(self, *args, **kw):
        t = time.perf_counter()
        out = load(self, *args, **kw)
        sync(self.device)
        loads.append(time.perf_counter() - t)
        return out

    GbdtLearner.load_dataset = timed_load
    with tempfile.TemporaryDirectory() as tmp:
        tr, va = (os.path.join(tmp, "train.libsvm"),
                  os.path.join(tmp, "eval.libsvm"))
        write_higgs_libsvm(tr, train_rows, dim, seed=21)
        write_higgs_libsvm(va, eval_rows, dim, seed=22)
        model, pred = os.path.join(tmp, "model"), os.path.join(tmp, "pred")
        t0 = time.perf_counter()
        try:
            rc = app.main([f"train_data={tr}", f"eval_data={va}",
                           f"model_out={model}", f"max_depth={depth}",
                           f"max_bin={max_bin}", f"num_round={rounds}",
                           "hist_kernel=mxu", f"device={device}"])
        finally:
            GbdtLearner.load_dataset = load
        train_s = time.perf_counter() - t0
        if rc != 0 or not os.path.exists(model + ".npz"):
            raise AssertionError(f"gbdt app task=train returned {rc}")
        rc = app.main(["task=pred", f"model_in={model}", f"test_data={va}",
                       f"pred_out={pred}", f"device={device}"])
        if rc != 0:
            raise AssertionError(f"gbdt app task=pred returned {rc}")
        p = np.loadtxt(pred, dtype=np.float64, ndmin=1)
        labels = np.array([float(l.split(" ", 1)[0])
                           for l in open(va).read().splitlines()])
    if p.shape != (eval_rows,) or not ((p > 0) & (p < 1)).all():
        raise AssertionError(f"gbdt app predictions: shape {p.shape}, "
                             f"range {p.min()}..{p.max()}")
    ll = float(-np.mean(labels * np.log(p) + (1 - labels) * np.log1p(-p)))
    # the labels follow the first four features: three rounds must beat
    # the constant prediction's log 2
    if not ll < 0.6:
        raise AssertionError(f"gbdt app: eval logloss {ll}")
    log(f"[gbdt-app] {train_rows} train rows and {eval_rows} eval rows of "
        f"{dim} features through the libsvm parser, {rounds} rounds at "
        f"depth {depth}, {max_bin} bins: task=train {train_s:.1f} s, of "
        f"which loading (parse on the learner's device and bin) "
        f"{' + '.join(f'{x:.4f}' for x in loads)} s (train, eval), "
        f"{eval_rows} predictions, eval logloss from predictions {ll:.6f}")
    return ll


# ------------------------------------------------------ host data path
def same_arrays(name: str, got: dict, want: dict) -> None:
    """Raise unless two sets of arrays (name -> array or None) hold the
    same bytes."""
    for k, a in want.items():
        b = got[k]
        if a is None or b is None:
            same = a is None and b is None
        else:
            a, b = np.asarray(a), np.asarray(b)
            same = (a.dtype == b.dtype and a.shape == b.shape
                    and a.tobytes() == b.tobytes())
        if not same:
            raise AssertionError(f"{name}: {k} differs from the plain "
                                 f"route's")


def rowblock_arrays(blk) -> dict:
    return {f: getattr(blk, f) for f in ("label", "offset", "index", "value")}


def parse_chunk_row(name: str, kernel, raw: bytes, got, want, plain_s,
                    walls, device, extra: str = "") -> dict:
    """Hold a card parse's RowBlock against the plain parser's byte for
    byte, time `kernel` (the chain on the chunk's bytes on the card: ms,
    device ms, host us), log one [parse] line and return its numbers."""
    same_arrays(f"[parse] {name}", rowblock_arrays(got),
                rowblock_arrays(want))
    tm = timings(kernel, device)
    nnz = got.nnz
    nbytes = (len(raw) + 4 * got.size + 8 * (got.size + 1) + 8 * nnz
              + (4 * nnz if got.value is not None else 0))
    b, by = bound_ms(nbytes, 0.0)
    log(f"[parse] {name}: {len(raw) / 1e6:.3f} MB, {got.size} rows, "
        f"{nnz} features, values {'kept' if got.value is not None else 'binary'}: "
        f"kernel ms {tm['ms']}, dev ms {tm['device_ms']}, host us "
        f"{tm['host_us']}, bound {b:.5f} ms ({by}); the whole call "
        f"{1e3 * min(walls):.3f} ms (walls {', '.join(f'{1e3 * w:.3f}' for w in walls)}); "
        f"plain parser "
        + ("not timed" if plain_s is None else f"{plain_s:.4f} s")
        + f"{extra}; RowBlocks equal byte for byte")
    return dict(tm, max_abs_err=0.0, plain_ms=(None if plain_s is None
                                               else 1e3 * plain_s),
                bound_ms=b, bound_by=by, library_ms=None,
                call_ms=1e3 * min(walls), mb=len(raw) / 1e6)


def _card_walls(parse, device):
    """(the last result, three walls) of a whole card parse call."""
    walls, got = [], None
    for _ in range(3):
        sync(device)
        t = time.perf_counter()
        got = parse()
        walls.append(time.perf_counter() - t)
    return got, walls


def format_chunks(rows=PARSE_ROWS) -> tuple:
    """[parse]'s chunks of the other formats: (name, format, bytes), a
    synthetic Criteo TSV chunk (13 integer and 26 categorical fields,
    Zipf(1.2) a field, ~20% and ~10% of them empty), the same rows as
    criteo_test, one line a token length 0 to 300 (every CityHash64
    branch), and an adfea chunk (gids over 0-1023, negative and 22-digit
    fids)."""
    from wormhole_tpu_torch.data.synth import (synth_adfea_text,
                                               synth_criteo_tsv)
    tsv = synth_criteo_tsv(np.random.default_rng(33), rows)
    rng = np.random.default_rng(35)
    sweep = []
    for n in range(301):
        tok = bytes(rng.integers(0x20, 0x7F, size=n).astype(np.uint8))
        sweep.append(tok + b"\t" + tok[::-1] + b"x")
    return (("criteo", "criteo", tsv), ("criteo_test", "criteo_test", tsv),
            ("criteo-sweep", "criteo_test", b"\n".join(sweep) + b"\n"),
            ("adfea", "adfea", synth_adfea_text(np.random.default_rng(34),
                                                rows)))


def edge_chunk(fmt: str) -> bytes:
    """A tile-edge chunk of `fmt`: the format's tile-edge corpus
    (data/synth.py tile_edge_text) at each of TILE_EDGE_SHIFTS, each
    starting at a tile edge (blanks pad the one before)."""
    from wormhole_tpu_torch.data.synth import tile_edge_text

    out = ""
    for shift in TILE_EDGE_SHIFTS:
        out += " " * (-len(out) % PARSE_TILE)
        out += tile_edge_text(fmt, PARSE_TILE, shift) + "\n"
    return out.encode()


def check_parse(device, rows=PARSE_ROWS) -> dict:
    """[parse]: the card's parsers against the plain parsers. libsvm on
    four full-width chunks (Criteo keys at 2^26 as write_libsvm writes
    them, the same keys with k:v values, HIGGS rows as write_higgs_libsvm
    writes them, and the same rows with %.17g values, most of which take
    the kernel's exact path); then format_chunks' criteo, criteo_test,
    length-sweep and adfea chunks: equal RowBlocks byte for byte. Every
    token is converted and every field hashed on the card; the libsvm
    lines count the exact path's decimals. Times the kernel chain on the
    chunk's bytes on the card (ms, device ms, host us), the whole call
    (bytes over, parse, arrays back; best of three) and the plain parser
    (one call a format). Returns the parse_libsvm row, from the Criteo
    keys chunk (the passes' files hold such rows), and the parse_criteo
    and parse_adfea rows, from the criteo and adfea chunks (the others'
    numbers under "chunks"). Then a tile-edge chunk of each format
    (edge_chunk), held byte for byte against the plain parser."""
    from wormhole_tpu_torch import native
    from wormhole_tpu_torch.data.parsers import parse_libsvm, parse_text

    chunks = (("criteo-keys", criteo_text(COMPACT_BUCKETS, rows, 31)),
              ("criteo-values", criteo_text(COMPACT_BUCKETS, rows, 31,
                                            values=True)),
              ("higgs", higgs_text(rows, HIGGS_DIM, 32)),
              ("higgs-17g", higgs_text(rows, HIGGS_DIM, 32, "%.17g")))
    out = {}
    for name, text in chunks:
        t = time.perf_counter()
        want = parse_libsvm(text)
        plain_s = time.perf_counter() - t
        got, walls = _card_walls(lambda: native.parse_libsvm_cuda(text,
                                                                  device),
                                 device)
        raw = text.encode()
        buf = native.upload(raw, device)
        n_exact = int(native.parse_libsvm_kernel(buf).stats[native.EXACT])
        split = device_split(lambda: native.parse_libsvm_kernel(buf), device)
        ops = None if split is None else sum(k[1] for k in split)
        row = parse_chunk_row(
            name, lambda: native.parse_libsvm_kernel(buf), raw, got, want,
            plain_s, walls, device, f"; exact-path decimals {n_exact} "
            f"(every token converted on the card); device ops a call "
            f"{ops}, by kernel [name, a call, ms]: {json.dumps(split)}")
        row.update(device_ops_per_call=ops, device_split=split)
        out.setdefault("parse_libsvm", row)
        out["parse_libsvm"].setdefault("chunks", {})[name] = {
            k: row[k] for k in ("ms", "device_ms", "host_us", "bound_ms",
                                "call_ms", "mb", "device_split")}
    plain = {}
    for name, fmt, raw in format_chunks(rows):
        if fmt == "adfea":
            kernel = native.parse_adfea_kernel
        else:
            def kernel(buf, has_label=fmt == "criteo"):
                return native.parse_criteo_kernel(buf, has_label)
        t = time.perf_counter()
        want = parse_text(raw, fmt)  # the plain parser
        plain_s = time.perf_counter() - t
        timed = fmt not in plain and name != "criteo-sweep"
        plain.setdefault(fmt, plain_s)
        got, walls = _card_walls(lambda: parse_text(raw, fmt, device),
                                 device)
        buf = native.upload(raw, device)
        split = device_split(lambda: kernel(buf), device)
        ops = None if split is None else sum(k[1] for k in split)
        row = parse_chunk_row(name, lambda: kernel(buf), raw, got, want,
                              plain_s if timed else None, walls, device,
                              f" ({fmt}); device ops a call {ops}, by "
                              f"kernel [name, a call, ms]: "
                              f"{json.dumps(split)}")
        row.update(device_ops_per_call=ops, device_split=split)
        key = "parse_adfea" if fmt == "adfea" else "parse_criteo"
        if key in out:
            out[key]["chunks"][name] = {
                k: row[k] for k in ("ms", "device_ms", "host_us", "bound_ms",
                                    "call_ms", "mb", "device_split")}
        else:
            out[key] = dict(row, chunks={})
    for fmt in ("libsvm", "criteo", "criteo_test", "adfea"):
        raw = edge_chunk(fmt)
        want = parse_text(raw, fmt)
        got = parse_text(raw, fmt, device)
        same_arrays(f"[parse] {fmt}-edges", rowblock_arrays(got),
                    rowblock_arrays(want))
        log(f"[parse] {fmt}-edges: {len(raw) / 1e6:.3f} MB, {got.size} rows, "
            f"{got.nnz} features, {len(TILE_EDGE_SHIFTS)} shifts of the "
            f"tile-edge corpus around {PARSE_TILE}-byte tiles; RowBlocks "
            f"equal byte for byte")
    return out


def _median_s(fn, n: int = 3):
    """(median seconds of n calls of fn, the last call's result)."""
    secs, out = [], None
    for _ in range(n):
        t = time.perf_counter()
        out = fn()
        secs.append(time.perf_counter() - t)
    return statistics.median(secs), out


def check_pack(device) -> dict:
    """[pack]: the pack with its sorts and uniques on the card against the
    numpy pack at full width, byte for byte: the linear learner's batch
    through pack_sorted_coo at 2^22 and pack_tile_coo at 2^26 (its compact
    cap), and DifactoLearner._pack_fm on section 4's batch (a learner on
    the card against one on the CPU, the same batches in the same order:
    the count mirror advances alike). Seconds a batch, median of three."""
    from wormhole_tpu_torch.models.difacto import DifactoLearner
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.ops import coo_kernels as ck

    coo_f = ("idx", "seg", "val", "tmap", "first")
    out = {}
    for name, nb, seed in (("pack_sorted_coo 2^22", DENSE_BUCKETS, 41),
                           ("pack_tile_coo 2^26", COMPACT_BUCKETS, 42)):
        cfg = LinearConfig(minibatch=MINIBATCH, nnz_per_row=NNZ_PER_ROW,
                           num_buckets=nb, algo="ftrl", kernel="pallas")
        lrn = LinearLearner(cfg, device=device)
        seg, idx, val, y, _ = batches(nb, 1, seed)[0]
        db = lrn.make_device_batch(to_rowblock(seg, idx, val, y))
        if nb == DENSE_BUCKETS:
            def pack(dev):
                p = ck.pack_sorted_coo(db.idx, db.seg, db.val, nb,
                                       capacity=cfg.row_capacity,
                                       device=dev)
                return {f: getattr(p, f) for f in coo_f}
        else:
            cap = lrn.ensure_compact(db.idx)

            def pack(dev):
                t = ck.pack_tile_coo(db.idx, db.seg, db.val, nb, cap,
                                     capacity=cfg.row_capacity,
                                     rm_rows=MINIBATCH,
                                     rm_width=NNZ_PER_ROW, device=dev)
                arrays = {f: getattr(t, f) for f in (
                    "uniq", "tmap_u", "first_u", "last_u", "rm_slot",
                    "rm_val")}
                arrays.update({f"coo.{f}": getattr(t.coo, f)
                               for f in coo_f})
                return arrays
        del lrn
        pack(device)  # warm: the first call pays torch's own set-up
        host_s, want = _median_s(lambda: pack(None))
        card_s, got = _median_s(lambda: pack(device))
        same_arrays(f"[pack] {name}", got, want)
        out[name] = {"numpy_s": host_s, "card_s": card_s}
        log(f"[pack] {name}: card {card_s:.4f} s a batch, numpy "
            f"{host_s:.4f} s a batch ({host_s / card_s:.1f}x); arrays equal "
            f"byte for byte")
    seg, idx, val, y, _ = batches(DENSE_BUCKETS, 1, 8)[0]
    learners = {"card": DifactoLearner(difacto_config("pallas"),
                                       device=device),
                "numpy": DifactoLearner(difacto_config("pallas"),
                                        device="cpu")}
    db = learners["card"].make_device_batch(to_rowblock(seg, idx, val, y))
    secs = {k: [] for k in learners}
    for _ in range(3):
        packs = {}
        for k, lrn in learners.items():
            t = time.perf_counter()
            pk = lrn._pack_fm(db, train=True)
            secs[k].append(time.perf_counter() - t)
            packs[k] = dict(enumerate(DifactoLearner._fm_args(
                pk, db.label, db.row_mask, True)))
        same_arrays("[pack] _pack_fm", packs["card"], packs["numpy"])
    card_s, host_s = (statistics.median(secs[k]) for k in ("card", "numpy"))
    out["_pack_fm"] = {"numpy_s": host_s, "card_s": card_s}
    log(f"[pack] DifactoLearner._pack_fm: card {card_s:.4f} s a batch "
        f"({', '.join(f'{x:.4f}' for x in secs['card'])}), numpy "
        f"{host_s:.4f} s a batch ({', '.join(f'{x:.4f}' for x in secs['numpy'])}; "
        f"{host_s / card_s:.1f}x); three train packs, every array equal "
        f"byte for byte")
    return out


E2E_APPS = (("linear-2^26", "linear", COMPACT_BUCKETS, ["algo=ftrl"]),
            ("linear-2^22", "linear", DENSE_BUCKETS, ["algo=ftrl"]),
            ("difacto", "difacto", DENSE_BUCKETS,
             [f"v_buckets={V_BUCKETS}", f"dim={FM_DIM}", "threshold=2",
              "kernel=pallas"]))


def write_e2e_files(directory: str) -> dict:
    """The passes' libsvm files, E2E_BATCHES full minibatches each: bucket
    count -> path."""
    files = {}
    for nb, seed in ((COMPACT_BUCKETS, 61), (DENSE_BUCKETS, 62)):
        files[nb] = os.path.join(directory, f"e2e-{nb}.libsvm")
        write_libsvm(files[nb], nb, E2E_BATCHES * MINIBATCH, seed)
    return files


def run_e2e(device, files: dict, apps=E2E_APPS, fmt: str = "libsvm",
            rows: int = E2E_BATCHES * MINIBATCH) -> dict:
    """[e2e]: one train pass of each of `apps` from its file (`files` maps
    a bucket count to a path of `rows` rows in format `fmt`), through the
    app's main() as a user runs it (num_parts_per_file and
    max_concurrency E2E_PARTS): examples/s of the pass (the file's rows
    over the pass's wall), its wall, ms a step and, where the solver keeps
    it, the loader stall's share of the wall, from the solver's pass line;
    and the whole app call's seconds. Works with an older checkout's apps
    too (their pass line has no stall; a libsvm pass names no format).
    Each record carries the pass's kernel launches."""
    import contextlib
    import io
    import re

    from wormhole_tpu_torch.apps import difacto, linear
    from wormhole_tpu_torch.ops import _cuda

    mains = {"linear": linear, "difacto": difacto}
    line = re.compile(r"train pass 0: (\d+) minibatches, avg ([\d.]+)ms/step,"
                      r" wall ([\d.]+)s(?:, loader stall ([\d.]+)s)?")
    fmt_arg = [] if fmt == "libsvm" else [f"data_format={fmt}"]
    out = {}
    for name, app, nb, extra in apps:
        _cuda.reset_launches()
        text = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = mains[app].main([
                f"train_data={files[nb]}", f"num_buckets={nb}",
                f"minibatch={MINIBATCH}", f"nnz_per_row={NNZ_PER_ROW}",
                "lr_eta=0.1", "lambda_l1=1", "max_data_pass=1",
                f"num_parts_per_file={E2E_PARTS}",
                f"max_concurrency={E2E_PARTS}", f"device={device}",
                *fmt_arg, *extra])
        app_s = time.perf_counter() - t
        m = line.search(text.getvalue())
        if rc != 0 or m is None:
            raise AssertionError(f"[e2e] {name}: rc {rc}, no pass line in "
                                 f"{text.getvalue()[-2000:]!r}")
        steps, ms, wall = int(m.group(1)), float(m.group(2)), float(m.group(3))
        stall = float(m.group(4)) if m.group(4) else None
        rec = {"examples_per_s": rows / wall, "wall_s": wall,
               "ms_per_step": ms, "steps": steps,
               "stall_share": None if stall is None else stall / wall,
               "app_s": app_s, "launches": dict(_cuda.LAUNCHES)}
        log(f"[e2e] {name}: {rows} rows in {steps} minibatches from "
            f"{os.path.basename(files[nb])} ({fmt}): "
            f"{rec['examples_per_s']:.0f} examples/s, pass wall "
            f"{wall:.3f} s, {ms:.1f} ms a step, loader stall "
            + ("not kept" if stall is None else
               f"{stall:.3f} s ({100 * rec['stall_share']:.1f}% of the wall)")
            + f"; app call {app_s:.2f} s")
        out[name] = rec
    return out


# the formats' passes: the apps of E2E_APPS that hash (linear at 2^26,
# DiFacto), from a Criteo TSV file and from its crb
FORMAT_APPS = tuple(a for a in E2E_APPS if a[0] != "linear-2^22")
ADFEA_ROWS = 2 * MINIBATCH  # the adfea pass's file


def write_criteo_file(directory: str) -> str:
    """The formats' passes' Criteo TSV file (data/synth.py
    synth_criteo_tsv): E2E_BATCHES minibatches of rows, about 243 bytes a
    row."""
    from wormhole_tpu_torch.data.synth import synth_criteo_tsv

    path = os.path.join(directory, "e2e-criteo.tsv")
    with open(path, "wb") as f:
        f.write(synth_criteo_tsv(np.random.default_rng(63),
                                 E2E_BATCHES * MINIBATCH))
    return path


def same_batches(device, tsv: str, crb: str) -> int:
    """Every batch read from the crb file against the batch parsed from
    the text on the card, one reader each (one part, as one loader reads
    the file), byte for byte. Returns the batch count."""
    from wormhole_tpu_torch.data.minibatch import MinibatchIter

    text = MinibatchIter(tsv, 0, 1, "criteo", minibatch_size=MINIBATCH,
                         device=device)
    binary = MinibatchIter(crb, 0, 1, "crb", minibatch_size=MINIBATCH)
    n = 0
    for a, b in zip(text, binary, strict=True):
        same_arrays(f"[e2e] crb batch {n}", rowblock_arrays(b),
                    rowblock_arrays(a))
        n += 1
    return n


def run_format_passes(device, tsv: str, data_dir: str) -> dict:
    """[e2e]'s formats: FORMAT_APPS' passes from the Criteo TSV file
    (parse_criteo on the card), the convert app writing it as crb on the
    card (its wall), the same passes from the crb file, every one-reader
    batch of the crb equal to the text's, and a linear pass at 2^26 from
    an adfea file (parse_adfea). Records as run_e2e's, under "criteo",
    "crb" and "adfea", and the convert's under "convert"."""
    import contextlib
    import io

    from wormhole_tpu_torch.apps import convert
    from wormhole_tpu_torch.data.synth import synth_adfea_text
    from wormhole_tpu_torch.ops import _cuda

    files = {nb: tsv for _, _, nb, _ in FORMAT_APPS}
    out = {"criteo": run_e2e(device, files, FORMAT_APPS, "criteo")}
    crb = os.path.join(data_dir, "e2e-criteo.crb")
    _cuda.reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = convert.main([f"data_in={tsv}", "format_in=criteo",
                           f"data_out={crb}", "format_out=crb",
                           f"minibatch={MINIBATCH}", f"device={device}"])
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"[e2e] convert returned {rc}")
    out["convert"] = {"wall_s": wall, "mb_in": os.path.getsize(tsv) / 1e6,
                      "mb_out": os.path.getsize(crb) / 1e6,
                      "launches": dict(_cuda.LAUNCHES)}
    log(f"[e2e] convert: {out['convert']['mb_in']:.1f} MB of Criteo TSV "
        f"to {out['convert']['mb_out']:.1f} MB of crb on the card in "
        f"{wall:.3f} s")
    files = {nb: crb for _, _, nb, _ in FORMAT_APPS}
    out["crb"] = run_e2e(device, files, FORMAT_APPS, "crb")
    _cuda.reset_launches()
    n = same_batches(device, tsv, crb)
    out["same_batches"] = {"batches": n, "launches": dict(_cuda.LAUNCHES)}
    log(f"[e2e] crb: {n} batches read from the crb file equal the batches "
        f"parsed from the text byte for byte (one reader each)")
    path = os.path.join(data_dir, "e2e-adfea.txt")
    with open(path, "wb") as f:
        f.write(synth_adfea_text(np.random.default_rng(64), ADFEA_ROWS))
    out["adfea"] = run_e2e(device, {FORMAT_APPS[0][2]: path},
                           FORMAT_APPS[:1], "adfea", rows=ADFEA_ROWS)
    return out


# ---------------------------------------------------------- batch learners
def uniform_rows(rng, rows: int, dim: int, nnz: int, distinct: bool):
    """(seg, idx, val) of `rows` MNIST-shaped rows: `nnz` column ids
    each, uniform over `dim` (drawn with repeats, as the bench's rows
    are, or distinct within a row), values U[0, 1)."""
    seg = np.repeat(np.arange(rows, dtype=np.int32), nnz)
    if distinct:
        idx = np.argsort(rng.random((rows, dim)), axis=1)[:, :nnz]
        idx = idx.reshape(-1).astype(np.int32)
    else:
        idx = rng.integers(0, dim, size=rows * nnz).astype(np.int32)
    return seg, idx, rng.random(rows * nnz).astype(np.float32)


def mnist_text(rows: int, seed: int) -> str:
    """MNIST-shaped libsvm rows (label 0, KM_NNZ uniform ids of KM_DIM,
    3-decimal values)."""
    rng = np.random.default_rng(seed)
    _, idx, val = uniform_rows(rng, rows, KM_DIM, KM_NNZ, distinct=False)
    toks = np.char.add(np.char.add(idx.astype(str), ":"),
                       np.char.mod("%.3f", val)).reshape(rows, KM_NNZ)
    return "\n".join("0 " + " ".join(t) for t in toks) + "\n"


def check_assign(name: str, got, want, atol: float, ties: int = 0) -> None:
    """(sums, counts, cost) of two assignment paths on the same batch:
    counts equal, sums within rtol 1e-5 + atol, cost within rtol 1e-5.
    `ties` rows whose best two similarities lie within 1e-6 may change
    cluster between paths that sum in another order; each moves one row
    (a unit vector) between two clusters."""
    (s1, c1, o1), (s2, c2, o2) = got, want
    moved = float((c1 - c2).abs().sum())
    if moved > 2 * ties:
        raise AssertionError(f"{name}: counts differ by {moved} with "
                             f"{ties} near-tie rows")
    err = float((s1 - s2).abs().max())
    if not ((s1 - s2).abs() <= atol + 2 * ties + 1e-5 * s2.abs()).all():
        raise AssertionError(f"{name}: sums max abs err {err}")
    if abs(float(o1) - float(o2)) > 1e-5 * abs(float(o2)) + 2 * ties:
        raise AssertionError(f"{name}: cost {float(o1)} vs {float(o2)}")
    log(f"[kmeans] {name}: counts differ by {moved:g} ({ties} near-tie "
        f"rows), sums max abs err {err:.3g}, cost {float(o1):.6f} vs "
        f"{float(o2):.6f}")


def near_ties(lrn, C, X, mask) -> int:
    """Rows of a row-normalized batch X whose two best cosine
    similarities to C lie within 1e-6."""
    import torch

    Cn = C / torch.linalg.norm(C, dim=1, keepdim=True).clamp_min(1e-12)
    top = (X @ Cn.T).topk(2, dim=1).values
    return int((((top[:, 0] - top[:, 1]) < 1e-6) & (mask > 0)).sum())


def write_mnist(path: str, rows: int) -> None:
    t = time.perf_counter()
    with open(path, "w") as f:
        f.write(mnist_text(rows, seed=71))
    log(f"[kmeans] {rows}-row file written in "
        f"{time.perf_counter() - t:.1f}s")


def run_kmeans(device, path=None, minibatch=KM_MINIBATCH,
               file_batches=KM_FILE_BATCHES, iters=KM_ITERS,
               timed=TIMED_STEPS, windows=TIMED_WINDOWS,
               sparse_dim=KM_SPARSE_DIM) -> dict:
    """[kmeans] at the bench's MNIST-784 shape (bench.py bench_kmeans):
    the packed assignment (coo_spmv_t), f32 and bf16, and the sparse one,
    against the dense assignment (the scatter densify) for the same
    centroids; the assignment timed on staged batches; coo_spmv_t at this
    shape against its plain version, its bound and index_add_; then
    KmeansLearner.run and the app from a libsvm file of `file_batches`
    minibatches (`path`, else one written here) parsed on the card. Returns coo_spmv_t's row numbers at
    this shape ("kmeans") and the main path's launches."""
    import contextlib
    import io

    import torch

    from wormhole_tpu_torch.apps import kmeans as app
    from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner
    from wormhole_tpu_torch.ops import _cuda
    from wormhole_tpu_torch.ops import coo_kernels as ck

    f32, bf16 = torch.float32, torch.bfloat16
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    cfg = dict(num_clusters=KM_K, dim=KM_DIM, minibatch=minibatch,
               nnz_per_row=KM_NNZ)
    lrn = KmeansLearner(KmeansConfig(**cfg), device=device)
    if not lrn._use_packed:
        raise AssertionError("the MNIST shape did not take the packed path")
    rng = np.random.default_rng(2)  # bench.py bench_kmeans's seed
    mask = torch.ones(minibatch, device=device)
    staged, raw, pack_s = [], [], []
    for _ in range(4):
        seg, idx, val = uniform_rows(rng, minibatch, KM_DIM, KM_NNZ,
                                     distinct=False)
        t = time.perf_counter()
        pk = lrn.pack_batch(seg, idx, val)
        pack_s.append(time.perf_counter() - t)
        staged.append(tuple(put(a) for a in pk))
        raw.append((put(seg), put(idx), put(val)))
    C = put(rng.standard_normal((KM_K, KM_DIM)).astype(np.float32))
    sidx, sseg, sval, tmap, first = staged[0]
    P, n_live = sidx.numel(), int((sval != 0).sum())
    buckets = int(torch.unique(sidx[sval != 0]).numel())
    log(f"[kmeans] {minibatch} x {KM_DIM} rows, k {KM_K}, {KM_NNZ} nonzeros "
        f"a row: P={P} packed entries, {n_live} live, {buckets} distinct "
        f"(row, col) buckets of {lrn._num_flat}; pack (sorts on the "
        f"learner's device) "
        f"{statistics.median(pack_s):.4f} s a batch (median of 4: "
        f"{', '.join(f'{x:.4f}' for x in pack_s)})")

    # the packed densify against the scatter densify, same centroids
    for dt, tol in ((f32, 1e-6), (bf16, 1e-4)):
        lrn._kdt = dt
        for b, (seg, idx, val) in zip(staged, raw):
            got = lrn._assign_packed(C, *b, mask)
            want = lrn._assign_dense(C, seg, idx, ck.round_to(val, dt), mask)
            check_assign(f"packed {dt} vs scatter densify", got, want, tol)
    lrn._kdt = f32
    # the sparse path assumes a row names a column once (its norms sum
    # val^2 per nonzero, as the JAX package's do): rows of distinct ids
    for _ in range(2):
        seg, idx, val = (put(a) for a in uniform_rows(
            rng, minibatch, KM_DIM, KM_NNZ, distinct=True))
        X = lrn.densify(seg, idx, val, mask)
        check_assign("sparse vs dense", lrn._assign_sparse(
            C, seg, idx, val, mask), lrn._assign_from_dense(C, X, mask),
            1e-4, near_ties(lrn, C, X, mask))

    # the assignment on staged batches
    def chain(n):
        for i in range(n):
            lrn._assign_packed(C, *staged[i % 4], mask)

    per = []
    for _ in range(windows):
        t = time.perf_counter()
        chain(timed)
        sync(device)
        per.append((time.perf_counter() - t) / timed)
    dt_s = statistics.median(per)
    prof = profile_steps(lambda i: lrn._assign_packed(
        C, *staged[i % 4], mask), 2 * timed) if device.type == "cuda" else {}
    out = {"assign_ms": 1e3 * dt_s, "assign_examples_per_s": minibatch / dt_s,
           "assign_range_ms": [1e3 * min(per), 1e3 * max(per)],
           "assign_device_ms": prof.get("device_ms_per_step"),
           "assign_idle_share": prof.get("device_idle_share"),
           "pack_s": statistics.median(pack_s)}
    log(f"[kmeans] assignment (packed, f32) {1e3 * dt_s:.3f} ms a batch "
        f"median of {windows} windows of {timed} (range "
        f"{1e3 * min(per):.3f}-{1e3 * max(per):.3f}), "
        f"{minibatch / dt_s:.0f} examples/s (staged batches)")
    log(f"[profile] kmeans assignment: {json.dumps(prof)}")

    # coo_spmv_t at this shape: d = ones over the flat buckets
    ones = torch.ones(minibatch, device=device)
    nf = lrn._num_flat
    got = ck.coo_spmv_t(ones, sidx, sseg, sval, tmap, first, nf, f32)
    want = ck.coo_spmv_t_plain(ones, sidx, sseg, sval, nf, f32)
    err = compare("coo_spmv_t kmeans f32", got, want, 1e-5, 1e-4,
                  ck.coo_spmv_t_plain(ones, sidx, sseg, sval.abs(), nf,
                                      f32))
    # the table written once, each live entry's (idx, seg, val), each pad
    # entry's val, d read once
    nb = nf * 4 + n_live * 12 + (P - n_live) * 4 + minibatch * 4
    b_ms, b_by = bound_ms(nb, 2 * n_live)
    out["coo_spmv_t"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ck.coo_spmv_t(ones, sidx, sseg, sval, tmap, first,
                                        nf, f32), device),
        plain_ms=time_ms(lambda: ck.coo_spmv_t_plain(
            ones, sidx, sseg, sval, nf, f32), device),
        library_ms=time_ms(lambda: torch.zeros(nf, device=device).index_add_(
            0, sidx, ones.index_select(0, sseg) * sval), device))
    log(f"[kernel] coo_spmv_t at the k-means shape: "
        + json.dumps(out["coo_spmv_t"]))

    # the sparse path at a hashed width, timed only
    sp = KmeansLearner(KmeansConfig(num_clusters=KM_K, dim=sparse_dim,
                                    minibatch=minibatch, nnz_per_row=39),
                       device=device)
    from wormhole_tpu_torch.data.synth import synth_criteo_batch

    seg, idx, val, _, m = (put(a) for a in synth_criteo_batch(
        np.random.default_rng(5), minibatch, sparse_dim))
    Cs = torch.randn(KM_K, sparse_dim, device=device)
    out["sparse_hashed_ms"] = time_ms(
        lambda: sp._assign_sparse(Cs, seg, idx, val, m), device)
    log(f"[kmeans] sparse assignment at d = {sparse_dim}, {minibatch} "
        f"Criteo-shaped rows: {out['sparse_hashed_ms']} ms a batch")
    del sp, Cs, staged, raw

    # the main path: Lloyd iterations and the app from a libsvm file
    with tempfile.TemporaryDirectory() as tmp:
        if path is None:
            path = os.path.join(tmp, "mnist.libsvm")
            write_mnist(path, file_batches * minibatch)
        _cuda.reset_launches()
        t = time.perf_counter()
        km = KmeansLearner(KmeansConfig(train_data=path, max_iter=0,
                                        **dict(cfg, dim=0)), device=device)
        km.init_centroids()
        sync(device)
        init_s = time.perf_counter() - t
        costs, walls = [], []
        for it in range(iters):  # one iteration a call, each timed
            km.start_iter, km.cfg.max_iter = it, it + 1
            t = time.perf_counter()
            costs.append(km.run(verbose=False))
            sync(device)
            walls.append(time.perf_counter() - t)
        C_run = km.centroids
        if km.cfg.dim != KM_DIM or C_run.shape != (KM_K, KM_DIM) or \
                not torch.isfinite(C_run).all():
            raise AssertionError(f"kmeans run: dim {km.cfg.dim}, centroids "
                                 f"{tuple(C_run.shape)}")
        if any(b > a + 1e-6 for a, b in zip(costs, costs[1:])) or \
                not all(math.isfinite(c) for c in costs):
            raise AssertionError(f"kmeans cost not non-increasing: {costs}")
        model = os.path.join(tmp, "centroids.txt")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = app.main([f"data={path}", f"num_clusters={KM_K}",
                           "max_iter=1", f"minibatch={minibatch}",
                           f"nnz_per_row={KM_NNZ}", f"model_out={model}",
                           f"device={device}"])
        saved = np.loadtxt(model)
        if rc != 0 or saved.shape != (KM_K, KM_DIM) or \
                "final cosine objective" not in text.getvalue():
            raise AssertionError(f"kmeans app: rc {rc}, model {saved.shape}")
        out["launches"] = dict(_cuda.LAUNCHES)
    rows = file_batches * minibatch
    it_s = statistics.median(walls)
    out.update(iter_s=it_s, iter_examples_per_s=rows / it_s, init_s=init_s)
    log(f"[kmeans] Lloyd from the file ({rows} rows, {file_batches} "
        f"batches): dim discovery ({KM_DIM}) and init {init_s:.3f} s, "
        f"iterations {', '.join(f'{w:.3f}' for w in walls)} s (median "
        f"{it_s:.3f} s, {rows / it_s:.0f} examples/s), costs "
        f"{', '.join(f'{c:.6f}' for c in costs)}; app: one iteration, "
        f"model_out {saved.shape}")
    return out


def agaricus_text(rows: int, seed: int) -> str:
    """Agaricus-shaped libsvm rows: 22 one-hot groups over 126 feature
    ids (16 groups of 6 ids, 6 of 5), one id of each group a row as
    `id:1`, and a 0/1 label from a fixed linear rule plus noise."""
    rng = np.random.default_rng(seed)
    sizes = [6] * 16 + [5] * 6
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pick = base + (rng.random((rows, 22)) * sizes).astype(np.int64)
    w = np.random.default_rng(1234).normal(size=126)
    y = (w[pick].sum(axis=1) + rng.normal(scale=0.5, size=rows) > 0)
    return "".join(f"{int(l)} " + " ".join(f"{i}:1" for i in r) + "\n"
                   for l, r in zip(y, pick))


def f64_check(name: str, obj, p, make) -> None:
    """The card's eval and grad at p against the same objective on the
    CPU in float64 (`make(cpu_batches)` builds it): eval within rtol
    1e-5, grad within 1e-5 of its largest entry plus 1e-6."""
    cpu = [(s.cpu(), i.cpu(), v.cpu().double(), y.cpu().double(),
            m.cpu().double()) for s, i, v, y, m in obj.batches]
    ref = make(cpu)
    p64 = p.cpu().double()
    e32, e64 = obj.eval(p), ref.eval(p64)
    g32, g64 = obj.grad(p).cpu().double(), ref.grad(p64)
    gerr = float((g32 - g64).abs().max())
    gmax = float(g64.abs().max())
    if abs(e32 - e64) > 1e-5 * abs(e64) or gerr > 1e-5 * gmax + 1e-6:
        raise AssertionError(f"[lbfgs] {name}: eval {e32} vs f64 {e64}, "
                             f"grad max abs err {gerr} (largest {gmax})")
    log(f"[lbfgs] {name}: eval and grad at the initial point vs the CPU "
        f"in float64: eval {e32:.6f} vs {e64:.6f}, grad max abs err "
        f"{gerr:.3g} (largest entry {gmax:.4g})")


def measure_lbfgs(name: str, obj, solver_cfg, device, make_ref) -> dict:
    """The solver on an objective already loaded: ms of one eval and one
    grad over all batches, ms an iteration and host syncs an iteration of
    a run, and the profiler's idle share over a second, shorter run; the
    eval and grad at the initial point against the CPU in float64."""
    import dataclasses

    from wormhole_tpu_torch.solver.lbfgs import LBFGSSolver

    w0 = obj.init_model()
    f64_check(name, obj, w0, make_ref)
    eval_s, _ = _median_s(lambda: obj.eval(w0))

    def grad():
        g = obj.grad(w0)
        sync(device)
        return g

    grad_s, _ = _median_s(grad)
    # the runs below start from w0 without drawing it again (the FM's
    # draw of 33.5M normals on the host takes about half a second), and
    # the initial grad and eval (a run of 0 iterations) are taken off
    obj.init_model = lambda: w0.clone()
    t = time.perf_counter()
    LBFGSSolver(obj, dataclasses.replace(solver_cfg, max_iter=0)).run(
        verbose=False)
    sync(device)
    init_s = time.perf_counter() - t
    solver = LBFGSSolver(obj, solver_cfg)
    t = time.perf_counter()
    _, objv = solver.run(verbose=False)
    sync(device)
    wall = time.perf_counter() - t - init_s
    iters = max(solver.iter, 1)
    short = LBFGSSolver(obj, dataclasses.replace(solver_cfg, max_iter=5))
    prof = profile_steps(lambda i: short.run(verbose=False), 1) if (
        device.type == "cuda") else {}
    rec = {"eval_ms": 1e3 * eval_s, "grad_ms": 1e3 * grad_s,
           "iter_ms": 1e3 * wall / iters, "iters": solver.iter,
           "host_syncs_per_iter": solver.host_syncs / iters,
           "idle_share": prof.get("device_idle_share"), "objv": objv}
    log(f"[lbfgs] {name}: {solver.iter} iterations, "
        f"{rec['iter_ms']:.2f} ms an iteration, eval {rec['eval_ms']:.2f} "
        f"ms, grad {rec['grad_ms']:.2f} ms, {rec['host_syncs_per_iter']:.2f}"
        f" host syncs an iteration, idle share {rec['idle_share']} "
        f"(profiled over the initial grad and eval and 5 iterations), "
        f"final objective {objv:.6f}")
    return rec


def drive_lbfgs_app(app, args: list, device) -> tuple[list, str]:
    """An L-BFGS app's main() in-process: (the objective after init and
    each iteration, from its lines; its stdout). Raises unless it exits
    0 with a history that never rises."""
    import contextlib
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = app.main([*args, f"device={device}"])
    hist = [float(l.split("objv ")[1].split()[0])
            for l in text.getvalue().splitlines()
            if l.startswith("lbfgs ") and "objv " in l]
    if rc != 0 or len(hist) < 2 or any(
            b > a for a, b in zip(hist, hist[1:])):
        raise AssertionError(f"{app.__name__} {args}: rc {rc}, objective "
                             f"{hist}")
    return hist, text.getvalue()


def run_lbfgs(device, criteo_file: str, agaricus_rows=AGARICUS_ROWS,
              fm_rows=LBFGS_FM_ROWS, iters=LBFGS_ITERS, names=None) -> dict:
    """[lbfgs]: (a) the lbfgs_linear app at the agaricus shape (train
    reg_L2=0.1 for 30 iterations, then task=pred); (b) the lbfgs_linear
    app on the Criteo-shaped file of [e2e] (ids below 2^22), with L2 and
    with OWL-QN; (c) the lbfgs_fm app (nfactor 8) on its first `fm_rows`
    rows. Each also measured through the objective and solver (the
    apps' own classes) on the same data. `names` picks some of the four
    runs (None: all). Returns the records and the apps' parse_libsvm
    launches."""
    from wormhole_tpu_torch.apps import lbfgs_fm, lbfgs_linear
    from wormhole_tpu_torch.models.batch_objectives import (
        FmObjFunction, LinearObjFunction, load_batches)
    from wormhole_tpu_torch.ops import _cuda
    from wormhole_tpu_torch.solver.lbfgs import LBFGSConfig

    out, parses = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        aga = os.path.join(tmp, "agaricus.libsvm")
        with open(aga, "w") as f:
            f.write(agaricus_text(agaricus_rows, seed=81))
        fm_path = os.path.join(tmp, "fm.libsvm")
        with open(criteo_file) as src, open(fm_path, "w") as dst:
            for _, line in zip(range(fm_rows), src):
                dst.write(line)
        model, pred = os.path.join(tmp, "m.npz"), os.path.join(tmp, "p.txt")
        crit = [f"minibatch={MINIBATCH}", f"nnz_per_row={NNZ_PER_ROW}"]
        runs = (
            ("agaricus", lbfgs_linear, aga, ["reg_L2=0.1"], [], 0.1, 0.0),
            ("criteo-l2", lbfgs_linear, criteo_file, ["reg_L2=1"], crit,
             1.0, 0.0),
            ("criteo-owlqn", lbfgs_linear, criteo_file,
             ["reg_L2=1", "reg_L1=1"], crit, 1.0, 1.0),
            ("criteo-fm", lbfgs_fm, fm_path, ["reg_L2=1", "nfactor=8"], crit,
             1.0, 0.0))
        for name, app, path, reg, shape, l2, l1 in runs:
            if names is not None and name not in names:
                continue
            n_it = 30 if name == "agaricus" else iters
            _cuda.reset_launches()
            t = time.perf_counter()
            hist, _ = drive_lbfgs_app(app, [
                f"data={path}", f"max_lbfgs_iter={n_it}", f"model_out={model}",
                *reg, *shape], device)
            app_s = time.perf_counter() - t
            n = _cuda.LAUNCHES["parse_libsvm"]
            if n == 0 and device.type == "cuda":
                raise AssertionError(f"[lbfgs] {name}: no parse_libsvm")
            parses += n
            st = np.load(model)
            w, nf = st["w"], int(st["num_feature"])
            zeros = int((w[:nf] == 0).sum())
            log(f"[lbfgs] {name} app: {len(hist) - 1} iterations in "
                f"{app_s:.2f} s (load included), objective {hist[0]:.6f} -> "
                f"{hist[-1]:.6f}, never rising; num_feature {nf}, "
                f"{w.shape[0]} parameters, {zeros} exact zeros among w")
            if name == "agaricus":
                _cuda.reset_launches()
                lbfgs_linear.main([f"data={path}", "task=pred",
                                   f"model_in={model}", f"pred_out={pred}",
                                   f"device={device}"])
                parses += _cuda.LAUNCHES["parse_libsvm"]
                p = np.loadtxt(pred, ndmin=1)
                if p.shape != (agaricus_rows,) or not np.isfinite(p).all():
                    raise AssertionError(f"agaricus pred: {p.shape}")
                log(f"[lbfgs] agaricus pred: {p.shape[0]} margins, one a "
                    f"row")
            batches, nf = load_batches(path, minibatch=(
                MINIBATCH if shape else 4096), nnz_per_row=(
                NNZ_PER_ROW if shape else 64), device=device)
            if "fm" in name:
                obj = FmObjFunction(batches, nf, 8, device)
                make = lambda b, nf=nf: FmObjFunction(b, nf, 8, "cpu")  # noqa: E731
            else:
                obj = LinearObjFunction(batches, nf, device)
                make = lambda b, nf=nf: LinearObjFunction(b, nf, "cpu")  # noqa: E731
            rec = measure_lbfgs(name, obj, LBFGSConfig(
                max_iter=n_it, reg_l2=l2, reg_l1=l1), device, make)
            rec.update(app_s=app_s, app_iters=len(hist) - 1, zeros=zeros,
                       num_dim=obj.num_dim)
            out[name] = rec
            del obj, batches
    # absent features stay exactly 0 under L2 alone; L1 zeroes more
    if names is None and not (out["criteo-owlqn"]["zeros"]
                              > out["criteo-l2"]["zeros"]):
        raise AssertionError("OWL-QN zeroed no more of w than L2 alone")
    return out, parses


# --------------------------------------------------------------- turns
# ------------------------------------------------------------ [cache]
CACHE_KNOBS = ("WH_PACK_CACHE", "WH_PACK_CACHE_DIR", "WH_PACK_CACHE_MB",
               "WH_NUM_LOADERS")
CACHE_PASSES = 3  # linear train passes of [cache]
STAGES = ("load", "pack", "h2d", "step", "metrics")


@contextlib.contextmanager
def set_knobs(names, **env):
    """The knobs `names` for a block: those in `env` set, the rest unset;
    restored after, so the phases around it run unchanged."""
    old = {k: os.environ.get(k) for k in names}
    try:
        for k in names:
            os.environ.pop(k, None)
        os.environ.update(env)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cache_knobs(**env):
    """The loader plane's knobs for a block (see set_knobs)."""
    return set_knobs(CACHE_KNOBS, **env)


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside the block (a check's, not the main path's)
    leave the launch counts as they were."""
    from wormhole_tpu_torch.ops import _cuda

    before = dict(_cuda.LAUNCHES)
    try:
        yield
    finally:
        _cuda.LAUNCHES.update(before)


def same_leaves(name: str, got, want) -> None:
    """Two prepared batches: the same structure, every array leaf equal
    byte for byte."""
    from wormhole_tpu_torch.data import pack_cache as pc

    la, lb = [], []
    sa, sb = pc._flatten(got, la), pc._flatten(want, lb)
    if repr(sa) != repr(sb) or len(la) != len(lb):
        raise AssertionError(f"{name}: structures differ")
    for a, b in zip(la, lb):
        a, b = np.asarray(a), np.asarray(b)
        if (a.dtype, a.shape) != (b.dtype, b.shape) or \
                a.tobytes() != b.tobytes():
            raise AssertionError(f"{name}: a leaf differs")


def lloyd_iterations(km, n: int, device) -> list:
    """`n` Lloyd iterations of a KmeansLearner, one a call, each timed,
    with its cache counts and kernel launches."""
    from wormhole_tpu_torch.ops import _cuda

    recs = []
    for it in range(n):
        km.start_iter, km.cfg.max_iter = it, it + 1
        st0 = km.pack_cache.stats() if km.pack_cache else None
        l0 = dict(_cuda.LAUNCHES)
        t = time.perf_counter()
        cost = km.run(verbose=False)
        sync(device)
        rec = {"wall_s": time.perf_counter() - t, "cost": cost,
               "parse_libsvm": _cuda.LAUNCHES["parse_libsvm"]
               - l0["parse_libsvm"],
               "coo_spmv_t": _cuda.LAUNCHES["coo_spmv_t"] - l0["coo_spmv_t"]}
        if st0 is not None:
            st = km.pack_cache.stats()
            rec.update({k: st[k] - st0[k]
                        for k in ("hits", "misses", "disk_hits")})
        recs.append(rec)
    return recs


def cache_kmeans(device, path: str, data_dir: str, minibatch: int,
                 iters: int, file_batches: int) -> dict:
    """[cache] k-means: Lloyd iterations over the [kmeans] file, packed f32,
    with WH_PACK_CACHE=1 against the same iterations with the cache off
    from the same centroids; the replayed packs against fresh packs of
    the same batches; then the disk tier: one learner fills
    WH_PACK_CACHE_DIR, a second one's first iteration reads it."""
    from wormhole_tpu_torch.data import pack_cache as pc
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner
    from wormhole_tpu_torch.solver.workload import iter_parts

    cfg = dict(train_data=path, num_clusters=KM_K, dim=KM_DIM,
               minibatch=minibatch, nnz_per_row=KM_NNZ, max_iter=0)

    def learner(C):
        km = KmeansLearner(KmeansConfig(**cfg), device=device)
        km.centroids = C.clone()
        return km

    with cache_knobs():
        off = KmeansLearner(KmeansConfig(**cfg), device=device)
        if off.pack_cache is not None or not off._use_packed:
            raise AssertionError("[cache] k-means: a cache with no knob set, "
                                 "or not the packed path")
        off.init_centroids()
        C0 = off.centroids.clone()
        uncached = lloyd_iterations(off, iters, device)
    with cache_knobs(WH_PACK_CACHE="1"):
        on = learner(C0)
        cached = lloyd_iterations(on, iters, device)
        # every replayed pack against a fresh pack of the same batch
        (f,) = iter_parts(path)
        key = on._part_key(f, "packed")
        mem = on.pack_cache.stats()
        n = 0
        with uncounted():
            for i, blk in enumerate(MinibatchIter(
                    path, minibatch_size=minibatch, device=device)):
                db = on._prep_db(blk)
                same_leaves(f"[cache] k-means batch {i}",
                            on.pack_cache.get(pc.fingerprint(key, i)),
                            (on.pack_batch(db.seg, db.idx, db.val),
                             db.row_mask))
                n += 1
    if n != file_batches:
        raise AssertionError(f"[cache] k-means: {n} batches in the file")
    launches = file_batches if device.type == "cuda" else 0
    for it, r in enumerate(cached[1:], 2):
        if r["misses"] or r["parse_libsvm"] or \
                r["hits"] != file_batches + 1 or \
                r["coo_spmv_t"] != launches:
            raise AssertionError(f"[cache] k-means iteration {it}: {r}")
    err = float((on.centroids - off.centroids).abs().max())
    if err > 1e-5 or abs(cached[-1]["cost"] - uncached[-1]["cost"]) > 1e-5:
        raise AssertionError(f"[cache] k-means centroids off by {err}, "
                             f"costs {cached[-1]['cost']} {uncached[-1]['cost']}")
    log(f"[cache] k-means, {file_batches} batches of {minibatch} rows: "
        f"iterations cache off {[round(r['wall_s'], 4) for r in uncached]} s, "
        f"cache on {[round(r['wall_s'], 4) for r in cached]} s; hits/misses "
        f"{[(r['hits'], r['misses']) for r in cached]}, parse_libsvm launches "
        f"{[r['parse_libsvm'] for r in cached]}; {n} replayed packs equal "
        f"to fresh ones byte for byte; centroids max abs err {err:.3g} "
        f"(atol 1e-5); memory tier {mem['mem_bytes']} B in "
        f"{mem['mem_entries']} entries")
    del off, on
    with cache_knobs(WH_PACK_CACHE_DIR=os.path.join(data_dir, "pack-cache")):
        fill = lloyd_iterations(learner(C0), 1, device)
        again = learner(C0)
        disk = lloyd_iterations(again, 1, device)
    d = disk[0]
    if d["disk_hits"] != file_batches + 1 or d["misses"] or \
            d["parse_libsvm"]:
        raise AssertionError(f"[cache] k-means from disk: {d}")
    if abs(d["cost"] - uncached[0]["cost"]) > 1e-5:
        raise AssertionError(f"[cache] k-means from disk: cost {d['cost']} "
                             f"vs {uncached[0]['cost']}")
    log(f"[cache] k-means disk tier: a first learner's iteration "
        f"{fill[0]['wall_s']:.4f} s (fills the directory), a second's "
        f"{d['wall_s']:.4f} s with {d['disk_hits']} disk hits "
        f"({file_batches} batches and the part's count entry), "
        f"{d['misses']} misses")
    del again
    rows = file_batches * minibatch
    return {"uncached_iter_s": [r["wall_s"] for r in uncached],
            "cached_iter_s": [r["wall_s"] for r in cached],
            "cached_hits": [r["hits"] for r in cached],
            "cached_misses": [r["misses"] for r in cached],
            "warm_examples_per_s": rows / statistics.median(
                r["wall_s"] for r in cached[1:]),
            "disk_fill_s": fill[0]["wall_s"], "disk_iter_s": d["wall_s"],
            "disk_hits": d["disk_hits"], "centroid_err": err,
            "mem_bytes": mem["mem_bytes"]}


def tables_close(name: str, got: dict, want: dict, rtol: float,
                 atol: float) -> tuple:
    """(max abs err, largest share of the tolerance) over every table;
    raises where an entry is beyond atol + rtol * |want|."""
    err = share = 0.0
    for k in got:
        d = (got[k] - want[k]).abs()
        err = max(err, float(d.max()))
        share = max(share, float((d / (atol + rtol * want[k].abs())).max()))
        if not bool(d.le(atol + rtol * want[k].abs()).all()):
            raise AssertionError(f"{name} table {k}: max abs err {err}")
    return err, share


def stage_counts() -> dict:
    from wormhole_tpu_torch.obs.metrics import REGISTRY

    return {k: REGISTRY.histogram(f"train.stage.{k}_s").count
            for k in STAGES}


def stage_split(before: dict) -> dict:
    """Median and p90 (ms) of each train stage's observations since
    `before` (stage_counts()); the reservoir holds every observation
    while a stage has at most its 256."""
    from wormhole_tpu_torch.obs.metrics import REGISTRY

    out = {}
    for k in STAGES:
        h = REGISTRY.histogram(f"train.stage.{k}_s").snapshot()
        if h["count"] > len(h["res"]):
            raise AssertionError(f"train.stage.{k}_s outgrew its reservoir")
        xs = sorted(h["res"][before[k]:])
        out[k] = ([1e3 * xs[len(xs) // 2], 1e3 * xs[int(0.9 * len(xs))]]
                  if xs else None)
    return out


def solver_passes(device, cfg, passes: int) -> tuple:
    """`passes` train passes of a LinearLearner or DifactoLearner through
    MinibatchSolver.iterate, each with its wall, stall share, cache
    counts, parse launches and stage split."""
    from wormhole_tpu_torch.models.difacto import (DifactoConfig,
                                                   DifactoLearner)
    from wormhole_tpu_torch.models.linear import LinearLearner
    from wormhole_tpu_torch.ops import _cuda
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    lrn = (DifactoLearner if isinstance(cfg, DifactoConfig)
           else LinearLearner)(cfg, device=device)
    sol = MinibatchSolver(lrn, cfg, verbose=False)
    recs = []
    for dp in range(passes):
        st0 = sol.pack_cache.stats() if sol.pack_cache else None
        c0, p0 = stage_counts(), _cuda.LAUNCHES["parse_libsvm"]
        sol.iterate(cfg.train_data, True, dp)
        sync(device)
        wall = sol.last_pass_wall_s
        rec = {"wall_s": wall, "stall_share": sol.last_pass_stall_s / wall,
               "parse_libsvm": _cuda.LAUNCHES["parse_libsvm"] - p0,
               "stages_ms": stage_split(c0)}
        if st0 is not None:
            st = sol.pack_cache.stats()
            rec.update({k: st[k] - st0[k] for k in ("hits", "misses")})
        recs.append(rec)
    return lrn, sol, recs


def cache_linear(device, path: str, passes: int,
                 num_buckets=COMPACT_BUCKETS) -> dict:
    """[cache] linear: the [e2e] 2^26 file, `passes` train passes with the
    cache on and the loaders sized by the controller (budget from
    nbytes_of a prepared batch), per pass; then one loader with the cache
    on and off (and off again, the float atomics' floor), w held to
    each other at the learner checks' tolerance, z and n to 4x that
    floor; and every replayed pack of the cached run against a fresh pack
    of the same batch, byte for byte."""
    from wormhole_tpu_torch.data import pack_cache as pc
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner

    cfg = LinearConfig(train_data=path, minibatch=MINIBATCH,
                       nnz_per_row=NNZ_PER_ROW, num_buckets=num_buckets,
                       algo="ftrl", lr_eta=0.1, lambda_l1=1.0,
                       kernel="pallas", kernel_dtype="f32",
                       num_parts_per_file=E2E_PARTS,
                       max_concurrency=E2E_PARTS)
    with uncounted():
        probe = LinearLearner(cfg, device=device)
        blk = next(iter(MinibatchIter(path, 0, E2E_PARTS,
                                      minibatch_size=MINIBATCH,
                                      device=device)))
        nb = pc.nbytes_of(probe.prepare_batch(blk))
    del probe
    # every part's batches, a short tail each included, all padded to one
    # shape, with a tenth to spare
    budget_mb = -(-(E2E_BATCHES + E2E_PARTS) * nb * 11 // 10 >> 20)
    log(f"[cache] linear {num_buckets} buckets: a prepared batch is {nb} B "
        f"(nbytes_of); "
        f"WH_PACK_CACHE_MB={budget_mb}")
    rows = E2E_BATCHES * MINIBATCH
    with cache_knobs(WH_PACK_CACHE="1", WH_PACK_CACHE_MB=str(budget_mb)):
        lrn, sol, recs = solver_passes(device, cfg, passes)
        decisions = sol.controller.decisions
    del lrn, sol
    for dp, r in enumerate(recs):
        r["examples_per_s"] = rows / r["wall_s"]
        log(f"[cache] linear pass {dp + 1}: {r['examples_per_s']:.0f} "
            f"examples/s, wall {r['wall_s']:.3f} s, stall "
            f"{100 * r['stall_share']:.1f}%, hits/misses {r['hits']}/"
            f"{r['misses']}, parse_libsvm launches {r['parse_libsvm']}, "
            f"stages (median, p90 ms) {json.dumps(r['stages_ms'])}")
    log(f"[cache] linear controller (WH_NUM_LOADERS unset): "
        f"{json.dumps(decisions)}")
    if recs[-1]["misses"] or recs[-1]["parse_libsvm"] or \
            recs[-1]["hits"] == 0:
        raise AssertionError(f"[cache] linear: last pass {recs[-1]}")
    # one loader: the batches in file order, so two runs differ only by
    # the order of the float atomics in coo_spmv_t; a second run with the
    # cache off shows that floor
    runs = []
    for cache in ({"WH_PACK_CACHE": "1", "WH_PACK_CACHE_MB": str(budget_mb)},
                  {}, {}):
        with cache_knobs(WH_NUM_LOADERS="1", **cache):
            lrn, sol, one = solver_passes(device, cfg, passes)
            if cache:
                n_same = same_linear_packs(device, lrn, sol, path)
        runs.append((lrn.store.state, one))
        del lrn, sol
    (on, one), (off, _), (off2, _) = runs
    # held as the learner checks hold it: w at rtol 1e-4 / atol 1e-6
    err, share = tables_close("[cache] linear", {"w": on["w"]},
                              {"w": off["w"]}, 1e-4, 1e-6)
    # z and n, where sums cancel, against this run's own control: 4x what
    # two uncached runs differ by, over a floor of 1e-5 of the table's
    # largest magnitude
    diffs = {}
    for k in on:
        d_on = float((on[k] - off[k]).abs().max())
        d_off = float((off2[k] - off[k]).abs().max())
        bound = 4 * d_off + 1e-5 * float(off[k].abs().max()) + 1e-6
        diffs[k] = [d_on, d_off, bound]
        if k != "w" and not d_on <= bound:
            raise AssertionError(f"[cache] linear: {k} cache on vs off max "
                                 f"abs err {d_on:.4g} > {bound:.4g} (4x "
                                 f"the off-vs-off {d_off:.4g} + floor)")
    log(f"[cache] linear replay: {n_same} replayed packs of the cached "
        f"one-loader run equal to fresh packs of the same batches byte for "
        f"byte")
    log(f"[cache] linear, one loader, {passes} passes: w cache on vs off "
        f"max abs err {err:.3g}, {share:.3f} of the tolerance (rtol 1e-4, "
        f"atol 1e-6); every table's max abs err [on vs off, off vs off, "
        f"bound] {json.dumps(diffs)} (z, n held to their bound); the "
        f"cached run's passes {[round(r['wall_s'], 3) for r in one]} s")
    del runs, on, off, off2
    return {"passes": recs, "decisions": decisions, "batch_bytes": nb,
            "budget_mb": budget_mb, "w_err": err, "table_diffs": diffs,
            "replayed_packs_equal": n_same,
            "one_loader_cached_s": [r["wall_s"] for r in one]}


def same_linear_packs(device, lrn, sol, path: str) -> int:
    """Every batch of the file's parts: the prepared batch the solver's
    cache replays against a fresh pack of the same batch by the same
    learner, byte for byte. Returns the number of batches held."""
    from wormhole_tpu_torch.data import pack_cache as pc
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.solver.workload import list_parts

    token = sol._pass_cache_token(True)
    if token is None:
        raise AssertionError("[cache] linear: the learner gave no token")
    n = 0
    with uncounted():
        for fname, part, nparts in list_parts(path, sol.cfg.num_parts_per_file):
            key = sol.part_key(True, token, fname, part, nparts)
            for i, blk in enumerate(MinibatchIter(
                    fname, part, nparts, minibatch_size=sol.cfg.minibatch,
                    device=device)):
                got = sol.pack_cache.get(pc.fingerprint(key, i))
                if got is None:
                    raise AssertionError(f"[cache] linear part {part} batch "
                                         f"{i}: not in the cache")
                same_leaves(f"[cache] linear part {part} batch {i}", got,
                            lrn.prepare_batch(blk, True))
                n += 1
    if n < E2E_BATCHES:
        raise AssertionError(f"[cache] linear: {n} batches held, the file "
                             f"has {E2E_BATCHES} full ones")
    return n


def cache_difacto(device, path: str, num_buckets=DENSE_BUCKETS,
                  v_buckets=V_BUCKETS) -> dict:
    """[cache] DiFacto: one train pass (compact FM kind, one loader) with
    the cache on touches no entry, and its tables equal the pass with the
    cache off within the DiFacto checks' tolerance."""
    import dataclasses

    cfg = dataclasses.replace(
        difacto_config("pallas", num_buckets, v_buckets), train_data=path,
        num_parts_per_file=E2E_PARTS)
    out = []
    for cache in ({"WH_PACK_CACHE": "1"}, {}):
        with cache_knobs(WH_NUM_LOADERS="1", **cache):
            lrn, sol, recs = solver_passes(device, cfg, 1)
        st = sol.pack_cache.stats() if sol.pack_cache else None
        out.append((lrn.ckpt_store.state, st, recs[0]))
        del lrn, sol
    (on, st, rec), (off, _, _) = out
    if st["hits"] or st["misses"] or st["mem_entries"]:
        raise AssertionError(f"[cache] difacto train pass touched the "
                             f"cache: {st}")
    err, share = tables_close("[cache] difacto", on, off, 2e-3, 2e-5)
    log(f"[cache] difacto train pass, cache on: no entry ({st}); tables vs "
        f"cache off max abs err {err:.3g}, {share:.3f} of the tolerance "
        f"(rtol 2e-3, atol 2e-5); pass wall {rec['wall_s']:.3f} s")
    return {"table_err": err, "wall_s": rec["wall_s"]}


def run_cache(device, km_path: str, files: dict, data_dir: str,
              km_minibatch=KM_MINIBATCH, km_iters=KM_ITERS,
              km_batches=KM_FILE_BATCHES, passes=CACHE_PASSES,
              compact_buckets=COMPACT_BUCKETS, dense_buckets=DENSE_BUCKETS,
              v_buckets=V_BUCKETS) -> dict:
    """[cache]: the epoch pack cache and the loader plane on the card
    (k-means, linear, DiFacto; see the module docstring). `files` maps a
    bucket count to its [e2e] file."""
    return {"kmeans": cache_kmeans(device, km_path, data_dir, km_minibatch,
                                   km_iters, km_batches),
            "linear": cache_linear(device, files[compact_buckets], passes,
                                   compact_buckets),
            "difacto": cache_difacto(device, files[dense_buckets],
                                     dense_buckets, v_buckets)}


def learner_steps(device) -> dict:
    """The kernel path's step times, ms (medians of TIMED_WINDOWS windows
    on staged batches): the linear learner at 2^26 buckets, DiFacto, and
    a GBDT round at the HIGGS shape; and DiFacto's device time a step
    (profiler). For comparing checkouts in turns."""
    from wormhole_tpu_torch.models.difacto import DifactoLearner
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner

    out = {}
    learners = (
        ("linear_compact", COMPACT_BUCKETS, 4, lambda: LinearLearner(
            LinearConfig(minibatch=MINIBATCH, nnz_per_row=NNZ_PER_ROW,
                         num_buckets=COMPACT_BUCKETS, algo="ftrl",
                         lr_eta=0.1, lambda_l1=1.0, kernel="pallas",
                         kernel_dtype="f32"), device=device)),
        ("difacto", DENSE_BUCKETS, 8, lambda: DifactoLearner(
            difacto_config("pallas"), device=device)))
    for name, nbk, seed, make in learners:
        lrn = make()
        staged = [lrn.stage_batch(lrn.prepare_batch(to_rowblock(
            s, i, v, y)), train=True) for s, i, v, y, _ in batches(
            nbk, TRAIN_STEPS, seed)]
        for b in staged:
            lrn.train_batch(b)
        out[f"{name}_ms"] = 1e3 * time_steps(
            lrn, staged, TIMED_STEPS, TIMED_WINDOWS, f"turn {name}")
        if name == "difacto":  # the V kernels' share shows on the device
            out["difacto_device_ms"] = profile_steps(
                lambda i: lrn.train_batch(staged[i % len(staged)]),
                TIMED_STEPS)["device_ms_per_step"]
        del lrn, staged
    edges, binned, y, _, _ = make_higgs(eval_rows=1)
    lrn = gbdt_learner(device, "mxu", edges, binned.shape[1])
    out["gbdt_round_ms"] = 1e3 * time_rounds(
        lrn, binned_dataset(device, binned, y), GBDT_TIMED_ROUNDS,
        TIMED_WINDOWS, "turn gbdt")[0]
    return out


def kernel_turn(checkout: str, e2e_dir: str) -> int:
    """One turn of a comparison of two checkouts: the kernel phases
    (phase 1 above, minus level_hist, plus the parse chains on [parse]'s
    chunks), the learners' step times and the passes from the files in
    `e2e_dir` (phase 7; a checkout that lacks a format skips what needs
    it, and its JSON line's "skipped" says what), with the package of
    `checkout` on the path, its kernels built from its own csrc/, and,
    where the checkout has the batch learners, [kmeans] (two iterations)
    and [lbfgs]'s criteo-l2 run. Prints one JSON line of every kernel
    row's numbers, the step times, the passes' numbers and the batch
    learners' times."""
    import torch

    sys.path.insert(0, checkout)
    from wormhole_tpu_torch.ops import _cuda

    probe_build = start_probe_build()
    _cuda.build()
    device = torch.device("cuda", 0)
    probe = finish_probe_build(*probe_build)
    knums = check_kernels(device, probe=probe)
    fm = check_fm_kernels(device, probe=probe)
    knums["scatter_update_cnt"] = fm.pop("scatter_update")
    knums.update(fm)
    keep = ("ms", "device_ms", "host_us", "max_abs_err", "bound_ms",
            "floor_ms", "probe")
    # the parse chains on [parse]'s chunks: libsvm's Criteo keys, and the
    # Criteo TSV and adfea chunks where the checkout parses them
    from wormhole_tpu_torch import native

    skipped = []
    bufs = {"parse_libsvm": (native.parse_libsvm_kernel, criteo_text(
        COMPACT_BUCKETS, PARSE_ROWS, 31).encode())}
    if hasattr(native, "parse_criteo_kernel"):
        chunks = {name: raw for name, _, raw in format_chunks()}
        bufs["parse_criteo"] = (native.parse_criteo_kernel, chunks["criteo"])
        bufs["parse_adfea"] = (native.parse_adfea_kernel, chunks["adfea"])
    else:
        skipped.append("parse_criteo and parse_adfea: no such kernels")
    for name, (kernel, raw) in bufs.items():
        buf = native.upload(raw, device)
        knums[name] = timings(lambda: kernel(buf), device)
    steps = learner_steps(device)
    files = {nb: os.path.join(e2e_dir, f"e2e-{nb}.libsvm")
             for nb in (COMPACT_BUCKETS, DENSE_BUCKETS)}
    keep_e2e = ("examples_per_s", "wall_s", "ms_per_step", "stall_share",
                "app_s")
    e2e = {k: {a: v[a] for a in keep_e2e}
           for k, v in run_e2e(device, files).items()}
    # the formats' passes, where the checkout reads Criteo TSV and crb
    tsv = os.path.join(e2e_dir, "e2e-criteo.tsv")
    if importlib.util.find_spec("wormhole_tpu_torch.data.crb"):
        fp = run_format_passes(device, tsv, tempfile.mkdtemp(dir=e2e_dir))
        for src in ("criteo", "crb", "adfea"):
            e2e.update({f"{k} {src}": {a: v[a] for a in keep_e2e}
                        for k, v in fp[src].items()})
        e2e["convert"] = {"wall_s": fp["convert"]["wall_s"]}
    else:
        skipped.append("the formats' passes: the checkout reads no Criteo "
                       "TSV or crb")
    batch = {}  # a checkout without the batch learners has none
    if importlib.util.find_spec("wormhole_tpu_torch.models.kmeans"):
        km = run_kmeans(device, iters=2)
        knums["coo_spmv_t_kmeans"] = km.pop("coo_spmv_t")
        batch["kmeans"] = {a: km[a] for a in (
            "assign_ms", "assign_device_ms", "pack_s", "iter_s")}
        lb, _ = run_lbfgs(device, files[DENSE_BUCKETS],
                          names=("criteo-l2",))
        batch["lbfgs"] = {a: lb["criteo-l2"][a] for a in (
            "iter_ms", "eval_ms", "grad_ms", "idle_share")}
    print(json.dumps({"turn": checkout, "kernels": {
        k: {a: v[a] for a in keep if a in v} for k, v in knums.items()},
        "steps": steps, "e2e": e2e, "batch": batch, "skipped": skipped}),
        flush=True)
    return 0


def run_turns(other: str) -> int:
    """The kernel phases, step times and passes from a file of another
    checkout (e.g. the parent commit, unpacked with git archive) against
    this one on the same card, in turns: other, this, this, other, one
    process each, over the same files (written once, by this checkout).
    Prints a line per turn and one JSON summary of the turns' ms,
    device_ms and host_us for every kernel row, their step times and
    their passes."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    other = os.path.abspath(other)
    sys.path.insert(0, ROOT)
    e2e_dir = tempfile.mkdtemp(prefix="wh-e2e-")
    t = time.perf_counter()
    write_e2e_files(e2e_dir)
    write_criteo_file(e2e_dir)
    log(f"[turns] passes' files written in {time.perf_counter() - t:.1f}s")
    turns = []
    for checkout in (other, ROOT, ROOT, other):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", checkout, e2e_dir],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"turn {checkout} failed")
        got = json.loads([l for l in proc.stdout.splitlines()
                          if l.startswith('{"turn"')][-1])
        log(f"[turn] {'this' if checkout == ROOT else 'other'} "
            f"{time.perf_counter() - t:.1f}s {json.dumps(got)}")
        turns.append(("this" if checkout == ROOT else "other", got))
    summary = {name: {f"{who}{i}": {a: g["kernels"][name][a] for a in
                                    ("ms", "device_ms", "host_us")}
                      for i, (who, g) in enumerate(turns)
                      if name in g["kernels"]}
               for name in turns[1][1]["kernels"]}
    summary["batch"] = {f"{who}{i}": g.get("batch", {})
                        for i, (who, g) in enumerate(turns)}
    summary["steps"] = {f"{who}{i}": g["steps"]
                        for i, (who, g) in enumerate(turns)}
    summary["e2e"] = {f"{who}{i}": g["e2e"]
                      for i, (who, g) in enumerate(turns)}
    for i, (who, g) in enumerate(turns):
        for what in g.get("skipped", []):
            log(f"[turns] {who}{i} skipped {what}")
    shutil.rmtree(e2e_dir)
    log(f"[turns] {smi}: " + json.dumps(summary))
    return 0


# ---------------------------------------------------------------- main
# ------------------------------------------------------------- [mesh]
MESH_RANKS = 4       # ranks of [mesh]: a 2x2 mesh (linear), a 4x1 (GBDT)
MESH_SEED = 3        # the linear batches', as run_learners draws them
MESH_TIMEOUT_S = 600  # the ranks' wall; the kernels are built before
MESH_KM_ITERS = 4    # Lloyd iterations of the 4x1 k-means run
MESH_LBFGS_ITERS = 30  # L-BFGS iterations of the 4x1 run (as [bsp]'s)


def mesh_linear_config(minibatch: int, num_buckets: int):
    """The linear configuration of run_learners, on the kernel path."""
    from wormhole_tpu_torch.models.linear import LinearConfig

    return LinearConfig(minibatch=minibatch, nnz_per_row=NNZ_PER_ROW,
                        num_buckets=num_buckets, algo="ftrl", lr_eta=0.1,
                        lambda_l1=1.0, kernel="pallas", kernel_dtype="f32")


def mesh_batches(spec: dict) -> list:
    """The [mesh] linear batches: train steps, then one to evaluate and
    one to predict, made from MESH_SEED by every rank and the parent."""
    from wormhole_tpu_torch.data.synth import synth_criteo_batch

    rng = np.random.default_rng(MESH_SEED)
    return [synth_criteo_batch(rng, spec["minibatch"], spec["buckets"])
            for _ in range(spec["steps"] + 2)]


def mesh_wd(spec: dict) -> tuple:
    """w over the table and d over a batch's rows that the kernel checks
    read (seed 11), on every rank and in the parent."""
    gen = np.random.default_rng(11)
    return (gen.standard_normal(spec["buckets"]).astype(np.float32),
            gen.standard_normal(spec["minibatch"]).astype(np.float32))


def parked(fn):
    """fn() on each rank in turn while the others wait at a barrier, so
    a time taken inside is the rank's own. Returns this rank's result."""
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        dist.barrier()
        if dist.get_rank() == r:
            out = fn()
    dist.barrier()
    return out


def collective_ms(fn, device, iters: int = 10) -> float:
    """Host wall of one collective call, every rank calling together, the
    card synchronised after the calls (None off the card)."""
    import torch.distributed as dist

    if device.type != "cuda":
        return None
    fn()
    sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def mesh_rank_linear(device, spec: dict, out: dict, arrays: dict) -> None:
    """A rank of the 2x2 linear mesh: the main path (train steps, one
    eval, one predict through the learner's entry points), its launches;
    then mesh_coo_spmv and mesh_coo_spmv_t on this rank's cell of the
    first batch against their plain twins, and the cell kernels and the
    two all_reduce calls timed."""
    import torch

    from wormhole_tpu_torch.models.linear import LinearLearner
    from wormhole_tpu_torch.ops import _cuda
    from wormhole_tpu_torch.ops import coo_kernels as ck
    from wormhole_tpu_torch.parallel import collectives
    from wormhole_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                  batch_range, make_mesh,
                                                  table_range)

    rows, nb, steps = spec["minibatch"], spec["buckets"], spec["steps"]
    mesh = make_mesh(2, 2, device=device, backend="gloo")
    data = mesh_batches(spec)
    blks = [to_rowblock(s, i, v, y) for s, i, v, y, _ in data]
    lrn = LinearLearner(mesh_linear_config(rows, nb), mesh=mesh)
    if lrn.prepare_batch(blks[0])[0] != "mcoo":
        raise AssertionError("[mesh] the 2x2 learner is not on the mcoo kind")
    _cuda.reset_launches()
    progs = [lrn.train_batch(b) for b in blks[:steps]]
    ev = lrn.eval_batch(blks[steps])
    pred = lrn.predict_batch(blks[steps + 1])
    sync(device)
    counts = dict(_cuda.LAUNCHES)
    for k in ("mesh_coo_spmv", "mesh_coo_spmv_t", "coo_spmv", "coo_spmv_t"):
        if device.type == "cuda" and counts[k] == 0:
            raise AssertionError(f"[mesh] linear rank launched no {k}")
    out["linear"] = {"launches": counts, "progs": progs, "eval": ev}
    arrays["pred"] = pred
    arrays.update({f"shard_{k}": v.cpu().numpy()
                   for k, v in lrn.store.state.items()})
    cap = lrn._shard_cap
    del lrn

    f32 = torch.float32
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    seg, idx, val, _, _ = data[0]
    with uncounted():
        cell, dropped = ck.pack_mesh_cell(idx, seg, val, nb, rows, 2, 2,
                                          *mesh.coords, cap, device=device)
        args = [dev(a) for a in (cell.idx, cell.seg, cell.val, cell.tmap,
                                 cell.first)]
        sidx, sseg, sval = args[:3]
        w_np, d_np = mesh_wd(spec)
        w = dev(w_np[slice(*table_range(mesh, nb))])
        d = dev(d_np[slice(*batch_range(mesh, rows))])
        rank = mesh.rank
        xw = ck.mesh_coo_spmv(mesh, w, *args, rows, f32)
        mag = ck.mesh_coo_spmv_plain(mesh, w.abs(), sidx, sseg, sval.abs(),
                                     *args[3:], rows, f32)
        e1 = compare(f"mesh_coo_spmv rank {rank}", xw, ck.mesh_coo_spmv_plain(
            mesh, w, *args, rows, f32), 1e-5, 1e-4, mag)
        g = ck.mesh_coo_spmv_t(mesh, d, *args, nb, f32)
        mag = ck.mesh_coo_spmv_t_plain(mesh, d.abs(), sidx, sseg, sval.abs(),
                                       *args[3:], nb, f32)
        e2 = compare(f"mesh_coo_spmv_t rank {rank}", g,
                     ck.mesh_coo_spmv_t_plain(mesh, d, *args, nb, f32),
                     1e-5, 1e-4, mag)
        arrays.update(xw=xw.cpu().numpy(), g=g.cpu().numpy())
        rows_d, nb_m = rows // 2, nb // 2
        live = cell.val != 0
        n_live = int(live.sum())
        stream_b = n_live * 12 + (cell.idx.shape[0] - n_live) * 4
        n_lb = int(np.unique(cell.idx[live]).size)
        pull = dict(
            max_abs_err=e1, dropped=dropped, **dict(zip(
                ("bound_ms", "bound_by"),
                bound_ms(stream_b + n_lb * 4 + rows_d * 4, 2 * n_live))),
            **parked(lambda: dict(
                **timings(lambda: ck.coo_spmv(w, *args, rows_d, f32), device),
                plain_ms=time_ms(lambda: ck.coo_spmv_plain(
                    w, sidx, sseg, sval, rows_d, f32), device),
                library_ms=time_ms(lambda: torch.zeros(
                    rows_d, device=device).index_add_(
                    0, sseg, w.index_select(0, sidx) * sval), device))),
            collective_ms=collective_ms(lambda: collectives.allreduce_sum(
                torch.zeros_like(xw), mesh, MODEL_AXIS), device),
            launches=counts["mesh_coo_spmv"])
        push = dict(
            max_abs_err=e2, **dict(zip(
                ("bound_ms", "bound_by"),
                bound_ms(stream_b + rows_d * 4 + nb_m * 4, 2 * n_live))),
            **parked(lambda: dict(
                **timings(lambda: ck.coo_spmv_t(d, *args, nb_m, f32), device),
                plain_ms=time_ms(lambda: ck.coo_spmv_t_plain(
                    d, sidx, sseg, sval, nb_m, f32), device),
                library_ms=time_ms(lambda: torch.zeros(
                    nb_m, device=device).index_add_(
                    0, sidx, d.index_select(0, sseg) * sval), device))),
            collective_ms=collective_ms(lambda: collectives.allreduce_sum(
                torch.zeros_like(g), mesh, DATA_AXIS), device),
            launches=counts["mesh_coo_spmv_t"])
    out["mesh_coo_spmv"], out["mesh_coo_spmv_t"] = pull, push


def mesh_rank_gbdt(device, spec: dict, workdir: str, out: dict,
                   arrays: dict) -> None:
    """A rank of the 4x1 GBDT mesh: fit_prepared on its quarter of the
    rows (the main path), its launches; then mesh_level_hist at every
    level of one more round against its plain twin with f64
    accumulators, the shard's level_hist and the block's all_reduce
    timed."""
    import torch

    from wormhole_tpu_torch.models import gbdt as gb
    from wormhole_tpu_torch.ops import _cuda
    from wormhole_tpu_torch.ops import hist as hk
    from wormhole_tpu_torch.parallel import collectives
    from wormhole_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

    mesh = make_mesh(MESH_RANKS, 1, device=device, backend="gloo")
    edges = np.load(os.path.join(workdir, "edges.npy"))
    binned = np.load(os.path.join(workdir, "binned.npy"), mmap_mode="r")
    y = np.load(os.path.join(workdir, "y.npy"), mmap_mode="r")
    F, B = binned.shape[1], spec["max_bin"]
    lrn = gb.GbdtLearner(gb.GbdtConfig(
        dim=F, max_depth=spec["depth"], num_round=spec["rounds"], eta=0.3,
        max_bin=B, hist_kernel="mxu"), mesh=mesh)
    lrn.edges = edges
    train = lrn._dataset(binned, y)
    _cuda.reset_launches()
    last = lrn.fit_prepared(train, [("train", train)], verbose=False)
    sync(device)
    counts = dict(_cuda.LAUNCHES)
    for k in ("mesh_level_hist", *GBDT_KERNELS):
        if device.type == "cuda" and counts[k] == 0:
            raise AssertionError(f"[mesh] gbdt rank launched no {k}")
    out["gbdt"] = {"launches": counts, "last": last,
                   "rows": int(train.binned.shape[0])}
    arrays.update({f"tree_{k}": v for k, v in lrn.trees.items()})

    calls = []
    real = gb.mesh_level_hist

    def recording(mesh, binned, g, h, rel, num_nodes, B):
        calls.append((g, h, rel, num_nodes))
        return real(mesh, binned, g, h, rel, num_nodes, B)

    with uncounted():
        gb.mesh_level_hist = recording
        try:
            _, _, margin = lrn._round(train, lrn._base_margins(train))
            calls.clear()
            lrn._round(train, margin)
        finally:
            gb.mesh_level_hist = real
        bins = train.binned
        rows = bins.shape[0]
        ones = torch.ones(rows, device=device)
        levels = []
        for lv, (g, h, rel, nodes) in enumerate(calls):
            tag = f"mesh_level_hist rank {mesh.rank} level {lv} nodes {nodes}"
            G, H = hk.mesh_level_hist(mesh, bins, g, h, rel, nodes, B)
            Gp, Hp = hk.mesh_level_hist_plain(mesh, bins, g, h, rel, nodes, B,
                                              acc_dtype=torch.float64)
            Gmag, cnt = hk.mesh_level_hist_plain(
                mesh, bins, g.abs(), ones, rel, nodes, B,
                acc_dtype=torch.float64)
            e = max(compare(f"{tag} G", G, Gp, 1e-5, 1e-4, Gmag),
                    compare(f"{tag} H", H, Hp, 1e-5, 1e-4, Hp))
            if G[cnt == 0].any() or H[cnt == 0].any():
                raise AssertionError(f"{tag}: a cell no row reaches is not 0")
            n_active = int(((rel >= 0) & (rel < nodes)).sum())
            flat = hk.hist_index(bins, rel, nodes, B)
            gsrc = g[:, None].expand(rows, F).reshape(-1)
            hsrc = h[:, None].expand(rows, F).reshape(-1)
            cells = (nodes + 1) * F * B

            def library():
                for src in (gsrc, hsrc):
                    torch.zeros(cells, device=device).index_add_(0, flat, src)

            block = torch.zeros(2, nodes, F, B, device=device)
            levels.append(dict(
                level=lv, num_nodes=nodes, active_rows=n_active,
                max_abs_err=e, **dict(zip(
                    ("bound_ms", "bound_by"),
                    bound_ms(rows * 4 + n_active * (8 + F)
                             + 2 * nodes * F * B * 4, 2 * n_active * F))),
                **parked(lambda: dict(
                    **timings(lambda: hk.level_hist(bins, g, h, rel, nodes, B),
                              device, iters=10),
                    plain_ms=time_ms(lambda: hk.level_hist_plain(
                        bins, g, h, rel, nodes, B), device, iters=5,
                        warmup=1),
                    library_ms=time_ms(library, device, iters=5, warmup=1))),
                collective_ms=collective_ms(lambda: collectives.allreduce_sum(
                    block, mesh, DATA_AXIS), device)))
            del flat, gsrc, hsrc, Gp, Hp, Gmag, cnt
    row = mean_over_levels(levels)
    row["collective_ms"] = (None if levels[0]["collective_ms"] is None else
                            statistics.mean(lv["collective_ms"]
                                            for lv in levels))
    row["launches"] = counts["mesh_level_hist"]
    out["mesh_level_hist"] = row


def mesh_rank_difacto(device, spec: dict, out: dict, arrays: dict) -> None:
    """A rank of the 2x2 DiFacto mesh at the criteo.conf width (the dmesh
    kind: W1 and W2 on its w cell, the V cell's sums over the axes): the
    main path (train steps, one eval, one predict through the learner's
    entry points), its launches, its host-clock ms a step, its shards."""
    from wormhole_tpu_torch.models.difacto import DifactoLearner
    from wormhole_tpu_torch.ops import _cuda
    from wormhole_tpu_torch.parallel.mesh import make_mesh

    steps = spec["steps"]
    mesh = make_mesh(2, 2, device=device, backend="gloo")
    blks = [to_rowblock(s, i, v, y) for s, i, v, y, _ in mesh_batches(spec)]
    lrn = DifactoLearner(difacto_config(
        "pallas", spec["buckets"], spec["v_buckets"],
        minibatch=spec["minibatch"]), mesh=mesh)
    if lrn.prepare_batch(blks[0])[0] != "dmesh" or not lrn._mesh_kernels:
        raise AssertionError("[mesh] the 2x2 DiFacto learner is not on the "
                             "dmesh kind with its kernels")
    _cuda.reset_launches()
    progs, step_s = [], []
    for b in blks[:steps]:
        t = time.perf_counter()
        progs.append(lrn.train_batch(b))
        step_s.append(time.perf_counter() - t)
    ev = lrn.eval_batch(blks[steps])
    pred = lrn.predict_batch(blks[steps + 1])
    sync(device)
    counts = dict(_cuda.LAUNCHES)
    for k in ("mesh_coo_spmv", "mesh_coo_spmv_t", "coo_spmv", "coo_spmv_t"):
        if device.type == "cuda" and counts[k] == 0:
            raise AssertionError(f"[mesh] difacto rank launched no {k}")
    out["difacto"] = {"launches": counts, "progs": progs, "eval": ev,
                      "ms_per_step": statistics.median(step_s[1:] or step_s)
                      * 1e3}
    arrays["fm_pred"] = pred
    arrays.update({f"fm_shard_{k}": v.cpu().numpy()
                   for k, v in lrn.ckpt_store.state.items()})


def mesh_rank_batch(device, spec: dict, workdir: str, out: dict) -> None:
    """The batch learners on the 4x1 group, through the apps' global
    bodies (the route torch.distributed.run takes): k-means at the
    [kmeans] MNIST-784 shape, L-BFGS linear at the agaricus shape; their
    launches, output and host-clock ms."""
    import contextlib
    import io
    import re
    import types

    import torch.distributed as dist

    from wormhole_tpu_torch.apps import kmeans, lbfgs_linear
    from wormhole_tpu_torch.ops import _cuda

    env = types.SimpleNamespace(rank=dist.get_rank(),
                                num_workers=dist.get_world_size())
    runs = (("kmeans", ("coo_spmv_t", "parse_libsvm"),
             lambda: kmeans._global_worker_body(kmeans.KmeansConfig(
                 train_data=spec["km_path"], num_clusters=KM_K,
                 max_iter=spec["km_iters"], minibatch=spec["km_minibatch"],
                 nnz_per_row=KM_NNZ, num_parts_per_file=MESH_RANKS,
                 model_out=os.path.join(workdir, "km-centroids.txt")),
                 env, None, device)),
            ("lbfgs", ("parse_libsvm",),
             lambda: lbfgs_linear._global_worker_body(
                 lbfgs_linear.LbfgsLinearConfig(
                     data=spec["agaricus"], reg_L2=0.1,
                     max_lbfgs_iter=spec["iters"],
                     num_parts_per_file=MESH_RANKS), env, None, device)))
    for name, want, run in runs:
        text = io.StringIO()
        _cuda.reset_launches()
        t = time.perf_counter()
        with contextlib.redirect_stdout(text):
            run()
        sync(device)
        wall = time.perf_counter() - t
        counts = dict(_cuda.LAUNCHES)
        for k in want:
            if device.type == "cuda" and counts[k] == 0:
                raise AssertionError(f"[mesh] {name} rank launched no {k}")
        got = text.getvalue()
        rec = {"launches": counts, "wall_s": wall}
        if name == "kmeans" and env.rank == 0:
            rec["cost"] = float(re.search(
                r"final cosine objective: ([0-9.]+)", got).group(1))
            rec["iter_ms"] = json.loads(re.search(
                r"\[kmeans-global\] iter ms: (\[.*\])", got).group(1))
        if name == "lbfgs" and env.rank == 0:
            rec["objv"] = [float(l.split("objv ")[1].split()[0])
                           for l in got.splitlines()
                           if l.startswith("lbfgs ") and "objv " in l]
            rec["ms_per_iter"] = float(re.search(
                r"ms_per_iter ([0-9.]+)", got).group(1))
        out[name] = rec


def mesh_rank(rank: int, world: int, workdir: str) -> int:
    """One rank of the [mesh] phase (chip_smoke.py --mesh-rank R W DIR):
    joins the gloo group of the ranks through a file in DIR, runs the
    linear and DiFacto 2x2 meshes, the GBDT 4x1 mesh and k-means and
    L-BFGS on the 4 ranks, writes rank-R.json / .npz."""
    import torch
    import torch.distributed as dist

    spec = json.load(open(os.path.join(workdir, "spec.json")))
    device = torch.device(spec["device"])
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        world_size=world, rank=rank)
    out, arrays = {}, {}
    try:
        mesh_rank_linear(device, spec, out, arrays)
        mesh_rank_gbdt(device, spec, workdir, out, arrays)
        mesh_rank_difacto(device, spec, out, arrays)
        # W1 and W2's launches: the linear and the DiFacto main paths'
        for name in ("mesh_coo_spmv", "mesh_coo_spmv_t"):
            out[name]["launches"] += out["difacto"]["launches"][name]
        mesh_rank_batch(device, spec, workdir, out)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank-{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"rank-{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def launch_mesh_ranks(workdir: str, timeout: float) -> list:
    """Start the MESH_RANKS ranks, wait for all; print each rank's
    output. Raises if one fails or they outlast `timeout` (every rank is
    killed then). Returns each rank's (json, arrays)."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         str(MESH_RANKS), workdir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(MESH_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"[mesh] the ranks outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        for line in o.splitlines():
            log(f"[mesh rank {r}] {line}")
        if p.returncode:
            raise AssertionError(f"[mesh] rank {r} exited {p.returncode}")
    return [(json.load(open(os.path.join(workdir, f"rank-{r}.json"))),
             dict(np.load(os.path.join(workdir, f"rank-{r}.npz"))))
            for r in range(MESH_RANKS)]


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def mesh_row(per_rank: list) -> dict:
    """A W row of the kernels line from the ranks' numbers: the slowest
    rank's times (a step waits for it), the largest error and bound, the
    launches summed and per rank."""
    def worst(k):
        xs = [r[k] for r in per_rank]
        return None if xs[0] is None else max(xs)

    big = max(per_rank, key=lambda r: r["bound_ms"])
    row = {k: worst(k) for k in ("max_abs_err", "ms", "device_ms",
                                 "host_us", "plain_ms", "library_ms",
                                 "collective_ms")}
    row.update(bound_ms=big["bound_ms"], bound_by=big["bound_by"],
               launches=sum(r["launches"] for r in per_rank),
               launches_per_rank=[r["launches"] for r in per_rank],
               ms_per_rank=[r["ms"] for r in per_rank],
               backend=f"gloo, {len(per_rank)} ranks on one card")
    return row


def mesh_nccl_check(device, spec: dict, workdir: str) -> dict:
    """A one-rank NCCL mesh on the card: W1 and W2 through NCCL's
    all_reduce equal kernels 1 and 2 on the same cell (at their
    tolerance), and the all_reduce timed. It shows that the NCCL route
    starts; it says nothing of several cards."""
    import torch
    import torch.distributed as dist

    from wormhole_tpu_torch.ops import coo_kernels as ck
    from wormhole_tpu_torch.parallel import collectives
    from wormhole_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                  make_mesh)

    rows, nb = spec["minibatch"], spec["buckets"]
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(workdir, "nccl-rdv"),
        world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device=device)
        if mesh.backend != "nccl" or mesh.group(MODEL_AXIS) is None:
            raise AssertionError("[mesh] the one-rank mesh is not on NCCL")
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        seg, idx, val, _, _ = mesh_batches(spec)[0]
        cap = ck.mesh_capacity(rows * NNZ_PER_ROW, 1, 1)
        cell, _ = ck.pack_mesh_cell(idx, seg, val, nb, rows, 1, 1, 0, 0, cap,
                                    device=device)
        args = [dev(a) for a in (cell.idx, cell.seg, cell.val, cell.tmap,
                                 cell.first)]
        w_np, d_np = mesh_wd(spec)
        w, d = dev(w_np), dev(d_np)
        f32 = torch.float32
        with uncounted():
            mag = ck.coo_spmv_plain(w.abs(), args[0], args[1],
                                    args[2].abs(), rows, f32)
            e1 = compare("mesh_coo_spmv on one NCCL rank vs coo_spmv",
                         ck.mesh_coo_spmv(mesh, w, *args, rows, f32),
                         ck.coo_spmv(w, *args, rows, f32), 1e-5, 1e-4, mag)
            mag = ck.coo_spmv_t_plain(d.abs(), args[0], args[1],
                                      args[2].abs(), nb, f32)
            e2 = compare("mesh_coo_spmv_t on one NCCL rank vs coo_spmv_t",
                         ck.mesh_coo_spmv_t(mesh, d, *args, nb, f32),
                         ck.coo_spmv_t(d, *args, nb, f32), 1e-5, 1e-4, mag)
        xs, gs = torch.zeros(rows, device=device), torch.zeros(nb,
                                                               device=device)
        out = {"max_abs_err": [e1, e2], "allreduce_xw_ms": collective_ms(
            lambda: collectives.allreduce_sum(xs, mesh, MODEL_AXIS), device),
            "allreduce_g_ms": collective_ms(
            lambda: collectives.allreduce_sum(gs, mesh, DATA_AXIS), device)}
    finally:
        dist.destroy_process_group()
    return out


def run_mesh(device, higgs, data_dir: str, minibatch=MINIBATCH,
             dense_buckets=DENSE_BUCKETS, steps=TRAIN_STEPS,
             depth=GBDT_DEPTH, rounds=GBDT_ROUNDS, max_bin=GBDT_BINS,
             timeout=MESH_TIMEOUT_S, v_buckets=V_BUCKETS, km_path=None,
             km_minibatch=KM_MINIBATCH, km_iters=MESH_KM_ITERS,
             agaricus_rows=AGARICUS_ROWS, iters=MESH_LBFGS_ITERS) -> dict:
    """[mesh]: the device mesh on the one card (see the module docstring).
    Returns the W rows of the kernels line and the ranks' launches."""
    import torch

    from wormhole_tpu_torch.apps import kmeans as km_app
    from wormhole_tpu_torch.apps import lbfgs_linear
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.models.difacto import DifactoLearner
    from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner
    from wormhole_tpu_torch.models.linear import LinearLearner
    from wormhole_tpu_torch.ops import coo_kernels as ck
    from wormhole_tpu_torch.parallel import multihost as mh

    workdir = os.path.join(data_dir, "mesh")
    os.makedirs(workdir)
    if km_path is None:
        km_path = os.path.join(workdir, "mnist.libsvm")
        write_mnist(km_path, KM_FILE_BATCHES * km_minibatch)
    aga = os.path.join(workdir, "agaricus.libsvm")
    with open(aga, "w") as f:
        f.write(agaricus_text(agaricus_rows, seed=81))
    spec = {"device": str(device), "minibatch": minibatch,
            "buckets": dense_buckets, "steps": steps, "depth": depth,
            "rounds": rounds, "max_bin": max_bin, "v_buckets": v_buckets,
            "km_path": km_path, "km_minibatch": km_minibatch,
            "km_iters": km_iters, "agaricus": aga, "iters": iters}
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    edges, binned_np, y, _, _ = higgs
    for name, a in (("edges", edges), ("binned", binned_np), ("y", y)):
        np.save(os.path.join(workdir, f"{name}.npy"), a)
    log(f"[mesh] {MESH_RANKS} ranks on one card: a 2x2 mesh (linear, "
        f"{dense_buckets} buckets, {minibatch} rows a batch) and a "
        f"{MESH_RANKS}x1 mesh (GBDT, {binned_np.shape[0]} x "
        f"{binned_np.shape[1]}, depth {depth}), over gloo: the ranks share "
        f"one card, and NCCL will not put two ranks on one GPU. This holds "
        f"the kernels, the cells and the reductions on the card; it does "
        f"not check NCCL across GPUs")

    # the references on one device, before the ranks start (the card is
    # theirs while they time)
    cfg = mesh_linear_config(minibatch, dense_buckets)
    data = mesh_batches(spec)
    blks = [to_rowblock(s, i, v, yy) for s, i, v, yy, _ in data]
    refs = []
    with uncounted():
        for _ in range(2):  # the second is the float atomics' control
            lrn = LinearLearner(cfg, device=device)
            refs.append(([lrn.train_batch(b) for b in blks[:steps]],
                         lrn.eval_batch(blks[steps]),
                         lrn.predict_batch(blks[steps + 1]),
                         {k: v.clone() for k, v in lrn.store.state.items()}))
            del lrn
        seg, idx, val, _, _ = data[0]
        p = ck.pack_sorted_coo(idx, seg, val, dense_buckets,
                               capacity=minibatch * NNZ_PER_ROW, device=device)
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        args = [dev(a) for a in (p.idx, p.seg, p.val, p.tmap, p.first)]
        w_np, d_np = mesh_wd(spec)
        w, d = dev(w_np), dev(d_np)
        f32 = torch.float32
        xw1 = ck.coo_spmv(w, *args, minibatch, f32)
        xmag = ck.coo_spmv_plain(w.abs(), args[0], args[1], args[2].abs(),
                                 minibatch, f32)
        g1 = ck.coo_spmv_t(d, *args, dense_buckets, f32)
        gmag = ck.coo_spmv_t_plain(d.abs(), args[0], args[1], args[2].abs(),
                                   dense_buckets, f32)
        train = binned_dataset(device, binned_np, y)
        one = gbdt_learner(device, "mxu", edges, binned_np.shape[1], depth,
                           rounds, max_bin)
        one_last = one.fit_prepared(train, [("train", train)], verbose=False)
        # DiFacto on one device: kernel=xla (the dmesh kind's math), from
        # the same seeded tables
        fm = DifactoLearner(difacto_config("xla", dense_buckets, v_buckets,
                                           minibatch=minibatch),
                            device=device)
        fm_ref = ([fm.train_batch(b) for b in blks[:steps]],
                  fm.eval_batch(blks[steps]), fm.predict_batch(blks[steps + 1]),
                  {k: v.clone() for k, v in fm.ckpt_store.state.items()})
        del fm
    sync(device)

    t = time.perf_counter()
    ranks = launch_mesh_ranks(workdir, timeout)
    log(f"[mesh] the {MESH_RANKS} ranks took {time.perf_counter() - t:.1f}s")
    js = [r[0] for r in ranks]
    ar = [r[1] for r in ranks]

    # linear: every rank reports the global batch's progress; the data
    # ranks' copies of a model shard are equal bit for bit
    for r in range(1, MESH_RANKS):
        if js[r]["linear"]["progs"] != js[0]["linear"]["progs"] or \
                js[r]["linear"]["eval"] != js[0]["linear"]["eval"] or \
                not np.array_equal(ar[r]["pred"], ar[0]["pred"]):
            raise AssertionError(f"[mesh] rank {r}'s progress differs")
    for k in refs[0][3]:
        for m in (0, 1):
            if ar[m][f"shard_{k}"].tobytes() != \
                    ar[m + 2][f"shard_{k}"].tobytes():
                raise AssertionError(f"[mesh] table {k} shard {m}: the two "
                                     f"data ranks' copies differ")
    pk, ek, yk, tk = refs[0]
    for a, b in zip(js[0]["linear"]["progs"] + [js[0]["linear"]["eval"]],
                    pk + [ek]):
        for k in ("objv", "logloss", "auc", "acc"):
            if abs(a[k] / a["nex"] - b[k] / b["nex"]) > 1e-3:
                raise AssertionError(f"[mesh] linear {k}: {a} vs one "
                                     f"device {b}")
    np.testing.assert_allclose(ar[0]["pred"], yk, rtol=1e-4, atol=1e-5)
    if not (np.isfinite(ar[0]["pred"]).all()
            and ar[0]["pred"].shape == (minibatch,)):
        raise AssertionError("[mesh] predictions not finite / wrong shape")
    full = {k: torch.from_numpy(np.concatenate(
        [ar[0][f"shard_{k}"], ar[1][f"shard_{k}"]])).to(device) for k in tk}
    err, share = tables_close("[mesh] linear 2x2 vs one device",
                              {"w": full["w"]}, {"w": tk["w"]}, 1e-4, 1e-6)
    diffs = {}
    for k in ("z", "n"):
        d_mesh = float((full[k] - tk[k]).abs().max())
        d_ctrl = float((refs[1][3][k] - tk[k]).abs().max())
        bound = 4 * d_ctrl + 1e-5 * float(tk[k].abs().max()) + 1e-6
        diffs[k] = {"mesh_vs_one": d_mesh, "one_vs_one": d_ctrl,
                    "bound": bound}
        if d_mesh > bound:
            raise AssertionError(f"[mesh] linear {k}: 2x2 vs one device "
                                 f"{d_mesh:.4g} > bound {bound:.4g}")
    log(f"[mesh] linear 2x2 vs one device over {steps} steps, an eval and "
        f"a predict: progress within 1e-3, w max abs err {err:.3g} "
        f"({share:.3f} of rtol 1e-4 / atol 1e-6), z and n against the "
        f"control of two one-device runs (4x it + 1e-5 of the table's "
        f"largest value) {json.dumps(diffs)}; each model shard equal bit "
        f"for bit on its two data ranks; launches a rank "
        f"{[nonzero(j['linear']['launches']) for j in js]}")
    xw = torch.from_numpy(np.concatenate([ar[0]["xw"], ar[2]["xw"]]))
    g = torch.from_numpy(np.concatenate([ar[0]["g"], ar[1]["g"]]))
    e1 = compare("mesh_coo_spmv (2x2) vs coo_spmv on one device", xw.to(device),
                 xw1, 1e-5, 1e-4, xmag)
    e2 = compare("mesh_coo_spmv_t (2x2) vs coo_spmv_t on one device",
                 g.to(device), g1, 1e-5, 1e-4, gmag)

    # gbdt: every rank holds the same trees; they are the one-device
    # kernel run's, up to a near tie; the leaves are the f64 sums of
    # their rows
    tree_keys = ("split_feat", "split_bin", "is_split", "leaf_value")
    for r in range(1, MESH_RANKS):
        if any(not np.array_equal(ar[r][f"tree_{k}"], ar[0][f"tree_{k}"])
               for k in tree_keys):
            raise AssertionError(f"[mesh] rank {r}'s trees differ")
    mesh_lrn = gbdt_learner(device, "mxu", edges, binned_np.shape[1], depth,
                            rounds, max_bin)
    mesh_lrn.trees = {k: ar[0][f"tree_{k}"] for k in tree_keys}
    with uncounted():
        differing, tie = compare_trees("mesh gbdt", mesh_lrn, one, train,
                                       rounds)
        off = 0.0
        for r in range(rounds):
            want, reached = leaf_reference(mesh_lrn, train, r)
            off = max(off, float(np.abs(mesh_lrn.trees["leaf_value"][r]
                                        - want)[reached].max()))
    if off > LEAF_ATOL:
        raise AssertionError(f"[mesh] gbdt leaves {off} from the f64 sums")
    same = rounds if tie is None else tie
    leaf_diff = float(np.abs(mesh_lrn.trees["leaf_value"][:same]
                             - one.trees["leaf_value"][:same]).max()
                      ) if same else 0.0
    last = js[0]["gbdt"]["last"]["train"]
    bar = 1e-4 if tie is None else 1e-3
    for k, v in last.items():
        if abs(v - one_last["train"][k]) > bar:
            raise AssertionError(f"[mesh] gbdt train-{k} {v} vs one device "
                                 f"{one_last['train'][k]}")
    log(f"[mesh] gbdt {MESH_RANKS}x1 ({[j['gbdt']['rows'] for j in js]} rows "
        f"a rank) vs one device, {rounds} rounds: {differing} splits differ"
        + ("" if tie is None else f" (a near tie in round {tie})")
        + f", leaves {leaf_diff:.3g} apart over {same} rounds and {off:.3g} "
        f"from the f64 sums of their rows (atol {LEAF_ATOL}); train metrics "
        f"{json.dumps(last)} vs {json.dumps(one_last['train'])}; launches a "
        f"rank {[nonzero(j['gbdt']['launches']) for j in js]}")

    # difacto: every rank reports the global batch's progress; the data
    # ranks' copies of a model shard are equal bit for bit; against one
    # device (kernel=xla) at DiFacto's card bar
    for r in range(1, MESH_RANKS):
        if js[r]["difacto"]["progs"] != js[0]["difacto"]["progs"] or \
                js[r]["difacto"]["eval"] != js[0]["difacto"]["eval"] or \
                not np.array_equal(ar[r]["fm_pred"], ar[0]["fm_pred"]):
            raise AssertionError(f"[mesh] difacto rank {r}'s progress "
                                 f"differs")
    pk, ek, yk, tk = fm_ref
    for k in tk:
        for m in (0, 1):
            if ar[m][f"fm_shard_{k}"].tobytes() != \
                    ar[m + 2][f"fm_shard_{k}"].tobytes():
                raise AssertionError(f"[mesh] difacto table {k} shard {m}: "
                                     f"the two data ranks' copies differ")
    for a, b in zip(js[0]["difacto"]["progs"] + [js[0]["difacto"]["eval"]],
                    pk + [ek]):
        for k in ("logloss", "auc"):
            if abs(a[k] / a["nex"] - b[k] / b["nex"]) > 1e-3:
                raise AssertionError(f"[mesh] difacto {k}: {a} vs one "
                                     f"device {b}")
    np.testing.assert_allclose(ar[0]["fm_pred"], yk, rtol=1e-4, atol=1e-5)
    fm_full = {k: torch.from_numpy(np.concatenate(
        [ar[0][f"fm_shard_{k}"], ar[1][f"fm_shard_{k}"]])).to(device)
        for k in tk}
    fm_err, fm_share = tables_close("[mesh] difacto 2x2 vs one device",
                                    fm_full, tk, 2e-3, 2e-5)
    log(f"[mesh] difacto 2x2 (w {dense_buckets}, V {v_buckets} x {FM_DIM}, "
        f"threshold 2, {minibatch} rows a batch) vs one device kernel=xla "
        f"over {steps} steps, an eval and a predict: progress within 1e-3, "
        f"tables max abs err {fm_err:.3g} ({fm_share:.3f} of rtol 2e-3 / "
        f"atol 2e-5), each model shard equal bit for bit on its two data "
        f"ranks; ms a step a rank "
        f"{[round(j['difacto']['ms_per_step'], 3) for j in js]}; launches "
        f"a rank {[nonzero(j['difacto']['launches']) for j in js]}")

    # k-means and L-BFGS on the 4 ranks against one device
    with uncounted():
        env0 = types.SimpleNamespace(rank=0, num_workers=MESH_RANKS)
        local = (b for f, k in mh.rank_parts(km_path, MESH_RANKS, env0)
                 for b in MinibatchIter(f, k, MESH_RANKS,
                                        minibatch_size=km_minibatch
                                        // MESH_RANKS, device=device))
        km = KmeansLearner(KmeansConfig(
            train_data=km_path, num_clusters=KM_K, max_iter=km_iters,
            minibatch=km_minibatch, nnz_per_row=KM_NNZ), device=device)
        km.centroids = km._put(km_app.init_rows(local, KM_K, km.cfg.dim, 0))
        km_cost = km.run(verbose=False)
        lb_one, _ = drive_lbfgs_app(lbfgs_linear, [
            f"data={aga}", "reg_L2=0.1", f"max_lbfgs_iter={iters}"], device)
        km_rank = js[0]["kmeans"]
        km_held = kmeans_hold("[mesh] kmeans", km_rank["cost"], np.loadtxt(
            os.path.join(workdir, "km-centroids.txt")), km, km_cost)
    lb_rel = bsp_objv_hold("lbfgs 4x1 vs one device", js[0]["lbfgs"]["objv"],
                           lb_one, iters, phase="[mesh]")
    for name, want in (("kmeans", ("coo_spmv_t", "parse_libsvm")),
                       ("lbfgs", ("parse_libsvm",))):
        for r, j in enumerate(js):
            if device.type == "cuda" and not all(
                    j[name]["launches"][k] for k in want):
                raise AssertionError(f"[mesh] {name} rank {r} launched "
                                     f"{nonzero(j[name]['launches'])}")
    batch = {"kmeans": {**km_held, "iter_ms": km_rank["iter_ms"],
                        "wall_s": [j["kmeans"]["wall_s"] for j in js]},
             "lbfgs": {"objective": js[0]["lbfgs"]["objv"][-1],
                       "one_device": lb_one[-1], "vs_one_rel": lb_rel,
                       "iterations": len(js[0]["lbfgs"]["objv"]) - 1,
                       "ms_per_iter": js[0]["lbfgs"]["ms_per_iter"],
                       "wall_s": [j["lbfgs"]["wall_s"] for j in js]}}
    log(f"[mesh] k-means {MESH_RANKS}x1 at the MNIST-784 shape (k {KM_K}, "
        f"{km_minibatch} rows a global step) and L-BFGS linear "
        f"{MESH_RANKS}x1 at the agaricus shape vs one device: "
        f"{json.dumps(batch)}; launches a rank "
        f"{[{n: nonzero(j[n]['launches']) for n in ('kmeans', 'lbfgs')} for j in js]}")

    nccl = None
    if device.type == "cuda":
        nccl = mesh_nccl_check(device, spec, workdir)
        log(f"[mesh] one-rank NCCL mesh on {device}: {json.dumps(nccl)}")
    rows = {name: mesh_row([j[name] for j in js])
            for name in ("mesh_coo_spmv", "mesh_coo_spmv_t",
                         "mesh_level_hist")}
    rows["mesh_coo_spmv"]["vs_one_device_max_abs_err"] = e1
    rows["mesh_coo_spmv_t"]["vs_one_device_max_abs_err"] = e2
    if nccl is not None:
        rows["mesh_coo_spmv"]["nccl_one_rank"] = {
            "max_abs_err": nccl["max_abs_err"][0],
            "collective_ms": nccl["allreduce_xw_ms"]}
        rows["mesh_coo_spmv_t"]["nccl_one_rank"] = {
            "max_abs_err": nccl["max_abs_err"][1],
            "collective_ms": nccl["allreduce_g_ms"]}
    for name, row in rows.items():
        log(f"[mesh] {name}: {json.dumps(row)}")
    return {"rows": rows, "linear_z_n": diffs, "gbdt_differing": differing,
            "difacto_max_abs_err": fm_err, "batch": batch}


# ------------------------------------------------------------- [serve]
SERVE_MINIBATCH = 1000  # bench.py bench_serve's rows a predict batch
SERVE_NNZ = 64          # nonzeros a row: nnz/2..nnz (tools/serve_lab.py)
SERVE_SHARDS = 2        # linear: the bench's 2 shards of 2^26 buckets
FM_SERVE_SHARDS = 3
SERVE_SECONDS = 8.0     # each closed-loop window
SERVE_SWAP_S = 2.0      # a new snapshot version this often in a window
SERVE_CHECKS = 64       # fixed requests held outside the windows
SERVE_POOL = 8          # of them, the ones the windows send round robin
SERVE_MODES = (("fetch", 4), ("score", 32))  # mode, concurrency
SERVE_TOL = dict(rtol=1e-5, atol=1e-4)  # the kernels' bar
SERVE_STAGES = ("batch_wait", "pack", "fanout", "wire", "queue",
                "partial", "score", "sum")
# the stages a request's latency is the sum of (the JAX package's
# obs/report.py); wire, queue and partial lie inside fanout
SERVE_PIPELINE = ("batch_wait", "pack", "fanout", "sum", "score")


def serve_blocks(rng, keys, n: int, minibatch: int, nnz: int) -> list:
    """n predict batches of `minibatch` rows of nnz/2..nnz nonzeros with
    N(0, 1) values (tools/serve_lab.py's shape), their ids drawn from
    `keys`: the ids the trainer saw, so the margins read trained
    weights."""
    from wormhole_tpu_torch.data.rowblock import RowBlock

    out = []
    for _ in range(n):
        counts = rng.integers(nnz // 2, nnz + 1, size=minibatch)
        offset = np.zeros(minibatch + 1, np.int64)
        offset[1:] = np.cumsum(counts)
        out.append(RowBlock(
            label=np.zeros(minibatch, np.float32), offset=offset,
            index=rng.choice(keys, size=int(offset[-1])).astype(np.uint64),
            value=rng.normal(size=int(offset[-1])).astype(np.float32)))
    return out


def trainer_margins(lrn, blocks: list) -> list:
    """The trainer's predict_batch over the served batches, in as few
    calls as its minibatch allows, split back a batch at a time."""
    from wormhole_tpu_torch.data.rowblock import RowBlock

    out, group = [], []

    def flush():
        m = lrn.predict_batch(RowBlock.concat(group))
        cuts = np.cumsum([0] + [b.size for b in group])
        out.extend(m[a:b] for a, b in zip(cuts[:-1], cuts[1:]))
        group.clear()

    for b in blocks:
        if group and sum(g.size for g in group) + b.size > lrn.cfg.minibatch:
            flush()
        group.append(b)
    flush()
    return out


def scorer_device(device):
    """The scorers' device: their default, the card, on the card (a
    rehearsal on the CPU names the CPU)."""
    return None if device.type == "cuda" else device


def serve_group(base: str, world: int):
    from wormhole_tpu_torch.serving import ModelServer

    servers = [ModelServer(r, world, base, poll_sec=0.05)
               for r in range(world)]
    for s in servers:
        s.serve()
    return servers


def serve_hold(name: str, got, want, **tol) -> float:
    """Max abs error of served scores against the trainer's; raises past
    the bar (and on a margin that is not finite)."""
    err = np.abs(got - want)
    if not (np.isfinite(got).all()
            and np.allclose(got, want, **(tol or SERVE_TOL))):
        raise AssertionError(f"[serve] {name}: max abs err "
                             f"{float(err.max())} beyond {tol or SERVE_TOL}")
    return float(err.max())


def serve_stage_row(snap: dict) -> dict:
    """p50 and mean ms of each serve.stage.* histogram of the window, and
    the share of the request latency the pipeline stages explain: their
    means over the request mean (the JAX package's explained_frac, which
    bench.py holds to 0.90), and their p50s over the request p50."""
    def p50(h):
        res = sorted(h["res"])
        return res[len(res) // 2] * 1e3

    hists = snap["hists"]
    stages = {st: {"p50_ms": p50(h), "mean_ms": h["sum"] / h["count"] * 1e3}
              for st in SERVE_STAGES
              if (h := hists.get(f"serve.stage.{st}_s")) and h["count"]}
    lat = hists["serve.latency_s"]
    pipe = [s for s in SERVE_PIPELINE if s in stages]
    return {"stages": stages,
            "latency_p50_ms": p50(lat),
            "explained_frac": sum(stages[s]["mean_ms"] for s in pipe)
            / (lat["sum"] / lat["count"] * 1e3),
            "p50_share": sum(stages[s]["p50_ms"] for s in pipe) / p50(lat)}


def serve_window(router, blocks: list, concurrency: int, seconds: float,
                 swap) -> tuple:
    """`concurrency` threads send `blocks` round robin, closed loop, for
    `seconds`, while `swap()` writes a new snapshot version every
    SERVE_SWAP_S. Returns the window's row and every response as
    (block index, version, scores)."""
    import threading

    from wormhole_tpu_torch.obs import metrics as obs

    snap0 = obs.REGISTRY.snapshot()
    for name in snap0["hists"]:
        if name.startswith("serve."):
            obs.REGISTRY.histogram(name).reset()
    stop = threading.Event()
    lats, responses, errors = [], [], []
    lock = threading.Lock()

    def loop(tid: int):
        lat, got, i = [], [], tid
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                scores, ver = router.predict_block(blocks[i % len(blocks)])
            except Exception as e:  # counted, and the phase fails
                with lock:
                    errors.append(repr(e))
                break
            lat.append((time.perf_counter() - t0) * 1e3)
            got.append((i % len(blocks), ver, scores))
            i += concurrency
        with lock:
            lats.extend(lat)
            responses.extend(got)

    def swapper():
        while not stop.wait(SERVE_SWAP_S):
            swap()

    threads = [threading.Thread(target=loop, args=(t,), daemon=True)
               for t in range(concurrency)]
    sw = threading.Thread(target=swapper, daemon=True)
    t0 = time.perf_counter()
    for t in threads + [sw]:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads + [sw]:
        t.join(timeout=60)
        if t.is_alive():
            raise AssertionError("[serve] a load thread did not stop")
    elapsed = time.perf_counter() - t0
    snap = obs.REGISTRY.snapshot()
    lats.sort()

    def pct(q):
        return lats[min(len(lats) - 1, int(q * len(lats)))]

    def delta(name):
        return snap["counters"].get(name, 0) - snap0["counters"].get(
            name, 0)

    stall = snap["hists"].get("serve.swap_stall_s") or {}
    row = {"concurrency": concurrency, "seconds": elapsed,
           "requests": len(lats), "failed": len(errors),
           "qps": len(lats) / elapsed, "p50_ms": pct(0.5),
           "p99_ms": pct(0.99), "p999_ms": pct(0.999),
           "swaps": delta("serve.swaps"),
           "swap_stall_ms_sum": stall.get("sum", 0.0) * 1e3,
           "swap_stall_ms_max": (stall.get("max") or 0.0) * 1e3,
           "epoch_retries": delta("serve.router.epoch_retries"),
           "router_failures": delta("serve.router.failures"),
           "batch_rounds": delta("serve.batch.rounds"),
           **serve_stage_row(snap)}
    h2d = snap["hists"].get("serve.score.h2d_s")
    if h2d and h2d["count"]:
        row["h2d_p50_ms"] = sorted(h2d["res"])[len(h2d["res"]) // 2] * 1e3
    if errors:
        raise AssertionError(f"[serve] {len(errors)} failed requests, "
                             f"first {errors[0]}")
    return row, responses


def serve_linear(device, smi: str, workdir: str, num_buckets: int,
                 seconds: float, checks: int, minibatch: int,
                 nnz: int) -> dict:
    """The linear FTRL learner trained on `device` at `num_buckets`,
    snapshotted into SERVE_SHARDS shards and served in both modes: the
    fixed requests first, then each mode's window with hot swaps."""
    import torch

    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.serving import LinearScorer, Router
    from wormhole_tpu_torch.utils.manifest import write_snapshot_set

    data = batches(num_buckets, 2, seed=21)
    # the row cap covers the served rows, so its predict drops none
    cfg = LinearConfig(minibatch=MINIBATCH, nnz_per_row=max(NNZ_PER_ROW, nnz),
                       num_buckets=num_buckets, algo="ftrl", lr_eta=0.1,
                       lambda_l1=1.0, kernel_dtype="f32")
    t = time.perf_counter()
    lrn = LinearLearner(cfg, device=device)
    for s, i, v, y, _ in data:
        lrn.train_batch(to_rowblock(s, i, v, y))
    w = lrn.store.state["w"].cpu().numpy()
    train_s = time.perf_counter() - t
    rng = np.random.default_rng(22)
    blocks = serve_blocks(rng, np.concatenate([d[1] for d in data]),
                          checks, minibatch, nnz)
    want = trainer_margins(lrn, blocks)
    live = float(np.mean([np.count_nonzero(m) / m.size for m in want]))
    if live < 0.5:
        raise AssertionError(f"[serve] only {live:.2f} of the margins read "
                             "a trained weight")
    base = os.path.join(workdir, "serve-linear", "srv")
    t = time.perf_counter()
    versions = {write_snapshot_set(base, {"w": w}, world=SERVE_SHARDS,
                                   compressed=False): 0}
    write_s = time.perf_counter() - t
    scfg = LinearConfig(minibatch=minibatch, nnz_per_row=nnz,
                        num_buckets=num_buckets)
    sdev = scorer_device(device)
    servers = serve_group(base, SERVE_SHARDS)
    routers = {}
    try:
        uris = [s.uri for s in servers]
        for m, _ in SERVE_MODES:
            routers[m] = Router(uris, LinearScorer(scfg, device=sdev),
                                mode=m)
        routers["cpu"] = Router(uris, LinearScorer(scfg, device="cpu"),
                                mode="fetch")
        # the fixed requests, at the first version
        t = time.perf_counter()
        got = {m: [r.predict_block(b) for b in blocks]
               for m, r in routers.items()}
        fixed_s = time.perf_counter() - t
        v0 = next(iter(versions))
        if any(ver != v0 for g in got.values() for _, ver in g):
            raise AssertionError("[serve] a fixed request saw another "
                                 "version")
        fixed = {"requests": checks, "rows": checks * minibatch,
                 "nonzero_margin_share": live, "train_s": train_s,
                 "snapshot_write_s": write_s, "fixed_s": fixed_s}
        for m, _ in SERVE_MODES:
            fixed[f"{m}_vs_trainer_max_abs_err"] = max(
                serve_hold(f"linear {m}", s, y)
                for (s, _), y in zip(got[m], want))
        for (s, _), (c, _) in zip(got["score"], got["cpu"]):
            if not np.array_equal(s, c):
                raise AssertionError("[serve] score mode differs from the "
                                     "CPU scorer's fetch mode")
        fixed["score_equals_cpu_fetch"] = True
        log(f"[serve] linear {num_buckets} buckets, {SERVE_SHARDS} shards, "
            f"fixed requests on {smi}: {json.dumps(fixed)}")

        def swap():
            k = max(versions.values()) + 1
            v = write_snapshot_set(base, {"w": w * np.float32(2.0 ** k)},
                                   world=SERVE_SHARDS, compressed=False)
            versions[v] = k

        rows = {}
        for m, conc in SERVE_MODES:
            written = len(versions)
            row, responses = serve_window(
                routers[m], blocks[:SERVE_POOL], conc, seconds, swap)
            row["versions_written"] = len(versions) - written
            # every response is 2^k times the first version's scores for
            # the one k of the version it carries: a mix of two versions
            # matches neither (score mode folds on the host: exactly)
            seen = set()
            for bi, ver, scores in responses:
                if ver not in versions:
                    raise AssertionError(f"[serve] unknown version {ver}")
                k = versions[ver]
                seen.add(k)
                ref = got[m][bi][0] * np.float32(2.0 ** k)
                if m == "score":
                    if not np.array_equal(scores, ref):
                        raise AssertionError(
                            f"[serve] score response at version {ver} is "
                            f"not 2^{k} times the first version's")
                else:
                    serve_hold(f"fetch response at version {ver}", scores,
                               ref, rtol=1e-5, atol=1e-4 * 2.0 ** k)
            if row["swaps"] < SERVE_SHARDS or len(seen) < 2:
                raise AssertionError(
                    f"[serve] {m}: {row['swaps']} swaps, versions {seen}: "
                    "no hot swap landed in the window")
            row["versions_served"] = len(seen)
            rows[m] = row
            log(f"[serve] linear {num_buckets} buckets {m} mode on {smi}: "
                f"{json.dumps(row)}")
            if row["explained_frac"] < 0.9:
                log(f"[serve] linear {m}: the stages explain "
                    f"{row['explained_frac']:.3f} of the request mean, "
                    "under 0.90")
        return {"fixed": fixed, **rows}
    finally:
        for r in routers.values():
            r.close()
        for s in servers:
            s.stop()
        del lrn
        if device.type == "cuda":
            torch.cuda.empty_cache()


def serve_difacto(device, smi: str, workdir: str, num_buckets: int,
                  v_buckets: int, checks: int, minibatch: int,
                  nnz: int) -> dict:
    """The DiFacto learner trained on `device` (the bench's width),
    snapshotted into FM_SERVE_SHARDS shards, `checks` requests in each
    mode against its predict_batch, without load."""
    from wormhole_tpu_torch.models.difacto import DifactoLearner
    from wormhole_tpu_torch.serving import DifactoScorer, Router
    from wormhole_tpu_torch.utils.manifest import write_snapshot_set

    data = batches(num_buckets, 2, seed=23)
    lrn = DifactoLearner(difacto_config("auto", num_buckets, v_buckets,
                                        nnz_per_row=max(NNZ_PER_ROW, nnz)),
                         device=device)
    for s, i, v, y, _ in data:
        lrn.train_batch(to_rowblock(s, i, v, y))
    st = lrn.ckpt_store.state
    tables = {k: st[k].cpu().numpy() for k in ("w", "cnt", "V")}
    rng = np.random.default_rng(24)
    blocks = serve_blocks(rng, np.concatenate([d[1] for d in data]),
                          checks, minibatch, nnz)
    want = trainer_margins(lrn, blocks)
    if lrn.dropped_slot_nnz or lrn.dropped_row_nnz:
        raise AssertionError("[serve] the DiFacto trainer dropped nonzeros")
    base = os.path.join(workdir, "serve-difacto", "srv")
    write_snapshot_set(base, tables, world=FM_SERVE_SHARDS)
    scfg = difacto_config("auto", num_buckets, v_buckets,
                          minibatch=minibatch, nnz_per_row=nnz)
    servers = serve_group(base, FM_SERVE_SHARDS)
    routers = {}
    out = {"requests": checks, "admitted": lrn.num_admitted()}
    try:
        for m, _ in SERVE_MODES:
            routers[m] = Router([s.uri for s in servers],
                                DifactoScorer(scfg, scorer_device(device)),
                                mode=m)
            t = time.perf_counter()
            got = [routers[m].predict_block(b)[0] for b in blocks]
            out[f"{m}_ms_per_request"] = ((time.perf_counter() - t)
                                          / checks * 1e3)
            out[f"{m}_vs_trainer_max_abs_err"] = max(
                serve_hold(f"difacto {m}", s, y) for s, y in zip(got, want))
        log(f"[serve] difacto {num_buckets}/{v_buckets} buckets dim "
            f"{FM_DIM}, {FM_SERVE_SHARDS} shards on {smi}: "
            f"{json.dumps(out)}")
        return out
    finally:
        for r in routers.values():
            r.close()
        for s in servers:
            s.stop()


def run_serve(device, smi: str, workdir: str,
              compact_buckets=COMPACT_BUCKETS, fm_buckets=DENSE_BUCKETS,
              v_buckets=V_BUCKETS, seconds=SERVE_SECONDS,
              checks=SERVE_CHECKS, minibatch=SERVE_MINIBATCH,
              nnz=SERVE_NNZ) -> dict:
    """The serving tier ([serve]): models trained on `device`, served by
    in-process ModelServer groups through Routers whose scorers take the
    default device (the card), in fetch and score mode."""
    return {"linear": serve_linear(device, smi, workdir, compact_buckets,
                                   seconds, checks, minibatch, nnz),
            "difacto": serve_difacto(device, smi, workdir, fm_buckets,
                                     v_buckets, checks, minibatch, nnz)}


# ---------------------------------------------------------------- ps
# bench.py bench_linear_ps's operating point, nothing cut: linear FTRL at
# 2^26 buckets, lambda_l1 1, 100,000 synthetic Criteo rows in 4 files,
# minibatch 25,000, max_delay 2, 2 passes; -n 1 -s 1 in three planes and
# -n 2 -s 2 beside it; DiFacto at its width at -n 2 -s 2 on the [e2e]
# 2^22 file
PS_ROWS = 100_000
PS_FILES = 4
# bench_linear_ps's 25,000 rows a batch (a file's rows: one batch a
# part), in a capacity rounded up to the kernels' 128-row lanes
# (kernel=pallas needs minibatch % 128 == 0; the JAX bench's auto kernel
# takes its plain path at 25,000)
PS_MINIBATCH = 25_088
PS_VAL_ROWS = 25_000     # a val file of the same shape, for the bars
PS_PASSES = 2
PS_MAX_DELAY = 2
PS_LAUNCH_TIMEOUT_S = 240  # each launch's own; its group is killed after
PS_N1_BAR = 1e-3   # -n 1 -s 1 sync against the single-process card run
PS_N2_BAR = 0.05   # -n 2 runs (tests/test_apps.py:195, :253)
PS_PLANES = (("async+keycache", {"WH_ASYNC_SYNC": "1", "WH_KEYCACHE": "1"}),
             ("sync", {"WH_ASYNC_SYNC": "0", "WH_KEYCACHE": "0"}),
             ("int8+ef+bshuf", {"WH_ASYNC_SYNC": "1", "WH_KEYCACHE": "1",
                                "WH_WIRE": "int8", "WH_WIRE_EF": "1",
                                "WH_WIRE_COMP": "bshuf"}))
# the compact linear worker's kernels (and every worker parses on the card)
LINEAR_PS_KERNELS = ("tile_gather", "coo_spmv_t", "scatter_update",
                     "parse_libsvm")
PS_KNOBS = ("WH_ASYNC_SYNC", "WH_KEYCACHE", "WH_WIRE", "WH_WIRE_EF",
            "WH_WIRE_COMP", "WH_PS_PLANE", "WH_NUM_LOADERS", "WH_ROLE")


def ps_launch(tag: str, n: int, s: int, app: str, conf: str, device,
              env: dict, kernels=(), timeout=PS_LAUNCH_TIMEOUT_S) -> dict:
    """One launch as a user runs it: python -m
    wormhole_tpu_torch.launcher.dmlc_tpu -n N -s S -- python -m
    wormhole_tpu_torch.apps.APP conf device=... kernel=pallas, in a
    session of its own, the whole group killed on timeout. Returns the
    workers' [ps-wire] records, the scheduler's final val line and the
    launch's wall; fails unless it exited 0, every worker reported (on
    the card: and launched each of `kernels`), and no scheduler or
    server opened a CUDA context."""
    import re
    import signal

    import torch

    argv = [sys.executable, "-m", "wormhole_tpu_torch.launcher.dmlc_tpu",
            "-n", str(n), "-s", str(s), "--", sys.executable, "-m",
            f"wormhole_tpu_torch.apps.{app}", conf, f"device={device}",
            "kernel=pallas"]
    full = {k: v for k, v in os.environ.items() if k not in PS_KNOBS}
    full.update(env, PYTHONPATH=ROOT)
    t = time.perf_counter()
    p = subprocess.Popen(argv, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=full,
                         cwd=ROOT, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        raise AssertionError(f"[ps] {tag}: launch timed out after "
                             f"{timeout}s; its group was killed\n"
                             f"{out[-3000:]}")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    wall = time.perf_counter() - t
    if p.returncode != 0:
        raise AssertionError(f"[ps] {tag}: launch exited {p.returncode}\n"
                             f"{out[-4000:]}")
    wires = [json.loads(m) for m in re.findall(r"\[ps-wire\] (\{.*\})", out)]
    m = re.search(r"final val: logloss=([0-9.]+) auc=([0-9.]+)", out)
    ctx = re.findall(r"\[(scheduler|ps server \d+)\] cuda context: (.+)",
                     out)
    if len(wires) != n or m is None or len(ctx) != 1 + s:
        raise AssertionError(f"[ps] {tag}: {len(wires)} [ps-wire] lines of "
                             f"{n}, final val {m is not None}, {len(ctx)} "
                             f"cuda-context lines of {1 + s}\n"
                             f"{out[-3000:]}")
    opened = [r for r, c in ctx if not c.startswith("none")]
    if opened:
        raise AssertionError(f"[ps] {tag}: {opened} opened a CUDA context")
    if torch.device(device).type == "cuda":
        for w in wires:
            missing = [k for k in kernels
                       if not w.get("kernel_launches", {}).get(k)]
            if missing or w.get("device", "").split(":")[0] != "cuda":
                raise AssertionError(
                    f"[ps] {tag}: worker {w['rank']} on {w.get('device')} "
                    f"launched no {missing}")
    return {"wires": wires, "logloss": float(m.group(1)),
            "auc": float(m.group(2)), "wall_s": wall}


def ps_summary(rec: dict) -> dict:
    """bench_linear_ps's numbers of one launch: examples/s of the last
    train round (its examples over its slowest worker's seconds), wire
    bytes a sync, the perf split summed over the workers, the key cache's
    hits, each worker's peak RSS, the d2h and h2d row copies."""
    ws = rec["wires"]
    nex = sum(w["last_round_nex"] for w in ws)
    sec = max(w["last_round_sec"] for w in ws)
    perf: dict = {}
    for w in ws:
        for k, v in w.get("perf_sec", {}).items():
            perf[k] = round(perf.get(k, 0.0) + v, 3)
    return {"examples_per_s": nex / max(sec, 1e-9),
            "bytes_per_sync": [w["last_round_bytes_per_sync"] for w in ws],
            "syncs": [w["num_syncs"] for w in ws],
            "perf_sec": perf,
            "keycache_hits": [w["keycache_hits"] for w in ws],
            "keycache_hit_rate": [w["keycache_hit_rate"] for w in ws],
            "sync_overlap": [w["sync_overlap_frac"] for w in ws],
            "peak_rss_mb": [w["peak_rss_mb"] for w in ws],
            "d2h_copies": [w.get("d2h_copies") for w in ws],
            "h2d_copies": [w.get("h2d_copies") for w in ws],
            "kernel_launches": [w.get("kernel_launches") for w in ws],
            "val_logloss": rec["logloss"], "val_auc": rec["auc"],
            "launch_wall_s": rec["wall_s"]}


def ps_single(app: str, conf: str, device, loaders=None) -> dict:
    """The single-process run on the same conf in this process (the
    app's run_minibatch_app): examples/s of the last train pass (rows
    over its wall, as bench_linear_ps takes it) and the val logloss."""
    import contextlib as _cl
    import io
    import re

    from wormhole_tpu_torch.apps import _runner, difacto, linear
    from wormhole_tpu_torch.config import load_config

    mod = {"linear": linear, "difacto": difacto}[app]
    cls = mod.LinearConfig if app == "linear" else mod.DifactoConfig
    cfg = load_config(cls, conf_file=conf, argv=["kernel=pallas"])
    cfg.model_out = None  # the launches' model files stay theirs
    text = io.StringIO()
    env = {"WH_NUM_LOADERS": str(loaders)} if loaders else {}
    with set_knobs(PS_KNOBS, **env), _cl.redirect_stdout(text):
        res = _runner.run_minibatch_app(cfg, mod.make_learner, device)
    walls = re.findall(r"train pass \d+: \d+ minibatches, .* wall ([\d.]+)s",
                       text.getvalue())
    if not walls:
        raise AssertionError(f"[ps] single {app}: no pass line\n"
                             f"{text.getvalue()[-2000:]}")
    return {"walls": [float(w) for w in walls],
            "val_logloss": res["val"].mean("logloss"),
            "val_auc": res["val"].mean("auc")}


def ps_saved_logloss(app: str, conf: str, path: str, device) -> float:
    """The val logloss of the model a server group saved, scored on the
    card by a fresh learner of `app`."""
    from wormhole_tpu_torch.config import load_config
    from wormhole_tpu_torch.models.difacto import (DifactoConfig,
                                                   DifactoLearner)
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver
    from wormhole_tpu_torch.utils import checkpoint as ckpt

    cls, lcls = ((LinearConfig, LinearLearner) if app == "linear"
                 else (DifactoConfig, DifactoLearner))
    cfg = load_config(cls, conf_file=conf, argv=["kernel=pallas"])
    lrn = lcls(cfg, device=device)
    ckpt.load_model(getattr(lrn, "ckpt_store", None) or lrn.store, path)
    sol = MinibatchSolver(lrn, cfg, verbose=False)
    return sol.iterate(cfg.val_data, False).mean("logloss")


def write_ps_conf(path: str, body: dict) -> str:
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in body.items()))
    return path


def run_ps(device, smi: str, workdir: str, e2e_file: str,
           num_buckets=COMPACT_BUCKETS, rows=PS_ROWS, files=PS_FILES,
           minibatch=PS_MINIBATCH, val_rows=PS_VAL_ROWS, passes=PS_PASSES,
           fm_buckets=DENSE_BUCKETS, v_buckets=V_BUCKETS,
           fm_minibatch=MINIBATCH, fm_val_rows=MINIBATCH,
           fm_rows=E2E_BATCHES * MINIBATCH) -> dict:
    """[ps]: the parameter-server plane through the launcher (see the
    module docstring). Every launch's workers train on `device` with
    kernel=pallas, so a worker without its kernels fails the launch."""
    import torch

    from wormhole_tpu_torch.utils import checkpoint as ckpt

    d = os.path.join(workdir, "ps")
    os.makedirs(d)
    t = time.perf_counter()
    for p in range(files):
        write_libsvm(os.path.join(d, f"train-{p}.libsvm"), num_buckets,
                     rows // files, seed=70 + p)
    val = os.path.join(d, "val.libsvm")
    write_libsvm(val, num_buckets, val_rows, seed=79)
    fm_val = os.path.join(d, "fm-val.libsvm")
    write_libsvm(fm_val, fm_buckets, fm_val_rows, seed=63)
    log(f"[ps] files written in {time.perf_counter() - t:.1f}s")
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the workers' contexts share the card
    base = {"train_data": f"{d}/train-.*", "val_data": val, "algo": "ftrl",
            "lambda_l1": 1, "lr_eta": 0.1, "minibatch": minibatch,
            "nnz_per_row": NNZ_PER_ROW, "num_buckets": num_buckets,
            "num_parts_per_file": 1, "max_data_pass": passes,
            "max_delay": PS_MAX_DELAY, "print_sec": 3600}
    out = {}
    conf = write_ps_conf(os.path.join(d, "n1.conf"),
                         dict(base, model_out=f"{d}/model-n1"))
    # the single-process card run: one loader (the parts in file order,
    # as the -n 1 worker takes them) for the logloss bar, and the
    # solver's own loaders for the examples/s beside the launches
    one = ps_single("linear", conf, device, loaders=1)
    single = ps_single("linear", conf, device)
    out["single"] = {"examples_per_s": rows / single["walls"][-1],
                     "val_logloss": one["val_logloss"],
                     "val_auc": one["val_auc"]}
    log(f"[ps] single process: {json.dumps(out['single'])}")
    for tag, env in PS_PLANES:
        rec = ps_launch(f"n1s1 {tag}", 1, 1, "linear", conf, device, env,
                        LINEAR_PS_KERNELS)
        out[f"n1s1 {tag}"] = ps_summary(rec)
        saved = ps_saved_logloss("linear", conf, f"{d}/model-n1", device)
        out[f"n1s1 {tag}"]["saved_val_logloss"] = saved
        diff = abs(saved - one["val_logloss"])
        bar = PS_N1_BAR if tag == "sync" else PS_N2_BAR
        log(f"[ps] -n 1 -s 1 {tag}: {json.dumps(out[f'n1s1 {tag}'])}; the "
            f"servers' model scores val {saved:.6f} against the single "
            f"process's {one['val_logloss']:.6f} (|diff| {diff:.2e}, bar "
            f"{bar})")
        if not diff <= bar:
            raise AssertionError(f"[ps] n1s1 {tag}: val logloss {saved} "
                                 f"vs {one['val_logloss']}")
    conf2 = write_ps_conf(os.path.join(d, "n2.conf"),
                          dict(base, model_out=f"{d}/model-n2"))
    rec = ps_launch("n2s2 linear", 2, 2, "linear", conf2, device,
                    dict(PS_PLANES[0][1]), LINEAR_PS_KERNELS)
    out["n2s2 linear"] = ps_summary(rec)
    saved = ps_saved_logloss("linear", conf2, f"{d}/model-n2", device)
    out["n2s2 linear"]["saved_val_logloss"] = saved
    log(f"[ps] -n 2 -s 2 linear: {json.dumps(out['n2s2 linear'])}")
    if not abs(saved - one["val_logloss"]) <= PS_N2_BAR:
        raise AssertionError(f"[ps] n2s2 linear: val logloss {saved} vs "
                             f"{one['val_logloss']}")
    fm = {"train_data": e2e_file, "val_data": fm_val, "algo": "ftrl",
          "lambda_l1": 1, "lr_eta": 0.1, "minibatch": fm_minibatch,
          "nnz_per_row": NNZ_PER_ROW, "num_buckets": fm_buckets,
          "v_buckets": v_buckets, "dim": FM_DIM, "threshold": 2,
          "num_parts_per_file": E2E_PARTS, "max_data_pass": 1,
          "max_delay": PS_MAX_DELAY, "print_sec": 3600}
    fconf = write_ps_conf(os.path.join(d, "fm.conf"),
                          dict(fm, model_out=f"{d}/fm-model-n1"))
    fconf2 = write_ps_conf(os.path.join(d, "fm2.conf"),
                           dict(fm, model_out=f"{d}/fm-model"))
    fone = ps_single("difacto", fconf, device, loaders=1)
    fsingle = ps_single("difacto", fconf, device)
    out["difacto single"] = {"examples_per_s": fm_rows / fsingle["walls"][-1],
                             "val_logloss": fone["val_logloss"],
                             "val_auc": fone["val_auc"]}
    log(f"[ps] difacto single process: {json.dumps(out['difacto single'])}")
    # -n 1 -s 1 sync: the DiFacto plane's parity with the single process
    rec = ps_launch("n1s1 difacto", 1, 1, "difacto", fconf, device,
                    dict(PS_PLANES[1][1]), FM_KERNELS)
    out["n1s1 difacto sync"] = ps_summary(rec)
    diff = abs(rec["logloss"] - fone["val_logloss"])
    log(f"[ps] -n 1 -s 1 difacto sync: {json.dumps(out['n1s1 difacto sync'])}"
        f"; val {rec['logloss']:.6f} against the single process's "
        f"{fone['val_logloss']:.6f} (|diff| {diff:.2e}, bar {PS_N1_BAR})")
    if not diff <= PS_N1_BAR:
        raise AssertionError(f"[ps] n1s1 difacto: val logloss "
                             f"{rec['logloss']} vs {fone['val_logloss']}")
    # -n 2 -s 2: one shared model (its saved shards score val as the
    # scheduler's final line says); its distance from the single process
    # is reported beside the 0.05 bar, which this configuration's labels
    # (no signal: 30% positive at random) do not let either package hold
    # (PERF.md §6)
    rec = ps_launch("n2s2 difacto", 2, 2, "difacto", fconf2, device,
                    dict(PS_PLANES[0][1]), FM_KERNELS)
    out["n2s2 difacto"] = ps_summary(rec)
    saved = ps_saved_logloss("difacto", fconf2, f"{d}/fm-model", device)
    out["n2s2 difacto"]["saved_val_logloss"] = saved
    gap = abs(rec["logloss"] - fone["val_logloss"])
    out["n2s2 difacto"]["vs_single"] = gap
    log(f"[ps] -n 2 -s 2 difacto: {json.dumps(out['n2s2 difacto'])}; the "
        f"saved shards score val {saved:.6f} (the scheduler's line "
        f"{rec['logloss']:.6f}); against the single process "
        f"{fone['val_logloss']:.6f}: |diff| {gap:.4f} "
        f"({'within' if gap <= PS_N2_BAR else 'over'} {PS_N2_BAR})")
    if not (math.isfinite(saved) and abs(saved - rec["logloss"]) <= PS_N1_BAR):
        raise AssertionError(f"[ps] n2s2 difacto: the saved model scores "
                             f"{saved}, the workers {rec['logloss']}")
    shapes = {k: v.shape for k, v in ckpt.load_parts(f"{d}/fm-model").items()}
    want = {"w": (fm_buckets,), "z": (fm_buckets,), "n": (fm_buckets,),
            "cnt": (fm_buckets,), "V": (v_buckets, FM_DIM),
            "nV": (v_buckets, FM_DIM)}
    if shapes != want:
        raise AssertionError(f"[ps] difacto's saved shards: {shapes}")
    dense = 5 * num_buckets * 4
    log(f"[ps] dense wire at this width: {dense} bytes a sync (push z+n, "
        f"pull w+z+n)")
    out["dense_bytes_per_sync"] = dense
    return out


BSP_RANKS = 3
BSP_GBDT_ROWS = 40_960      # a rank's train file: at most 43,690 rows a
                            # rank keeps every row in both sketches
BSP_GBDT_EVAL_ROWS = 16_384
BSP_GBDT_ROUNDS = 4
# depth 6 with one eval set: 7 levels + the metric sums = 8 collectives a
# round, so #12 is round 1's fourth level (checked against the counts)
BSP_GBDT_KILL = "worker:1:kill@allreduce:12"
BSP_LBFGS_KILL = "worker:1:kill@allreduce:4"  # inside iteration 1
BSP_LBFGS_ITERS = 30
BSP_LBFGS_RTOL = 1e-4     # objv_history over the first 8 iterations
BSP_LAUNCH_TIMEOUT_S = 240  # each launch's own; its group is killed after
BSP_NODE_TIMEOUT_S = 30     # the launcher's; WH_BSP_RETRY_SEC follows it
BSP_KNOBS = ("WH_FAULT_SPEC", "WH_OBS_DIR", "WH_WIRE", "WH_SNAPSHOT_DIR",
             "WH_BSP_RETRY_SEC", "WH_BSP_STEP_TIMEOUT", "WH_ROLE",
             "WH_RESTORE_EPOCH")


def bsp_launch(tag: str, app: str, args: list, device, workdir: str,
               fault: str = "", kernels=(),
               timeout=BSP_LAUNCH_TIMEOUT_S, mode: str = "bsp") -> dict:
    """One BSP launch as a user runs it: python -m
    wormhole_tpu_torch.launcher.dmlc_tpu -n 3 -s 0 --node-timeout 30
    --max-worker-restarts 1 -- python -m wormhole_tpu_torch.apps.APP ...
    bsp=1 device=..., in a session of its own, the whole group killed on
    timeout, with WH_OBS_DIR set so the scheduler writes run_report.json.
    Fails unless it exited 0, each of the 3 ranks printed its
    [bsp-worker] line (on the card: having launched each of `kernels` on
    cuda), the scheduler opened no CUDA context, and a `fault` launch
    respawned its worker. Returns the output, wall, report and the
    workers' records. With mode="global" it is a global-mesh launch
    instead ([global]): -n 2, no restarts, global_mesh=1, the workers'
    [global-worker] lines, no run report."""
    import re
    import signal

    import torch

    glob_mode = mode == "global"
    ranks = GLOBAL_RANKS if glob_mode else BSP_RANKS
    obs = os.path.join(workdir, f"obs-{tag.replace(' ', '-')}")
    argv = [sys.executable, "-m", "wormhole_tpu_torch.launcher.dmlc_tpu",
            "-n", str(ranks), "-s", "0", "--node-timeout",
            str(BSP_NODE_TIMEOUT_S),
            *([] if glob_mode else ["--max-worker-restarts", "1"]), "--",
            sys.executable, "-m", f"wormhole_tpu_torch.apps.{app}", *args,
            "global_mesh=1" if glob_mode else "bsp=1", f"device={device}"]
    full = {k: v for k, v in os.environ.items()
            if k not in PS_KNOBS + BSP_KNOBS}
    full.update(PYTHONPATH=ROOT, WH_OBS_DIR=obs)
    if fault:
        full["WH_FAULT_SPEC"] = fault
    t = time.perf_counter()
    p = subprocess.Popen(argv, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=full,
                         cwd=ROOT, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        raise AssertionError(f"[{mode}] {tag}: launch timed out after "
                             f"{timeout}s; its group was killed\n"
                             f"{out[-3000:]}")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    wall = time.perf_counter() - t
    if p.returncode != 0:
        raise AssertionError(f"[{mode}] {tag}: launch exited "
                             f"{p.returncode}\n{out[-4000:]}")
    workers = [json.loads(m) for m in re.findall(
        rf"\[{mode}-worker\] (\{{.*\}})", out)]
    ctx = re.findall(r"\[scheduler\] cuda context: (.+)", out)
    if sorted(w["rank"] for w in workers) != list(range(ranks)) or \
            len(ctx) != 1:
        raise AssertionError(f"[{mode}] {tag}: [{mode}-worker] lines of "
                             f"ranks {[w['rank'] for w in workers]}, "
                             f"{len(ctx)} cuda-context lines\n"
                             f"{out[-3000:]}")
    if not ctx[0].startswith("none"):
        raise AssertionError(f"[{mode}] {tag}: the scheduler opened a CUDA "
                             f"context")
    if fault and "respawning with restore epoch 1" not in out:
        raise AssertionError(f"[bsp] {tag}: no respawn\n{out[-3000:]}")
    if torch.device(device).type == "cuda":
        for w in workers:
            missing = [k for k in kernels
                       if not w["kernel_launches"].get(k)]
            if missing or not w["device"].startswith("cuda"):
                raise AssertionError(
                    f"[{mode}] {tag}: worker {w['rank']} on {w['device']} "
                    f"launched no {missing}")
    report = None
    if not glob_mode:
        with open(os.path.join(obs, "run_report.json")) as f:
            report = json.load(f)
    objv = [float(x) for x in re.findall(
        r"\[worker-0\] lbfgs (?:init|iter \d+): objv ([-0-9.e+]+)", out)]
    m = re.search(rf"\[worker-0\] \[gbdt-{mode}\] round ms: (\[.*\])",
                  out)
    return {"out": out, "wall_s": wall, "report": report,
            "workers": workers, "objv": objv,
            "round_ms": json.loads(m.group(1)) if m else None}


def bsp_summary(rec: dict) -> dict:
    """bench_bsp's numbers of one launch (bench.py:551-611): the wall,
    bsp.allreduce_s mean and p99, bsp.checkpoint_s mean and the bytes a
    checkpoint, the counts of rounds and checkpoints, recoveries, fetches
    and ring retries from the run report, and each worker's launches."""
    s = rec["report"]["summary"]
    hists = rec["report"].get("hists") or {}
    ar = hists.get("bsp.allreduce_s") or {}
    ck = hists.get("bsp.checkpoint_s") or {}
    out = {"wall_s": rec["wall_s"],
           "allreduce_ms": (ar.get("mean") or 0.0) * 1e3,
           "allreduce_p99_ms": (ar.get("p99") or 0.0) * 1e3,
           "checkpoint_ms": (ck.get("mean") or 0.0) * 1e3,
           "checkpoint_bytes": int(s.get("bsp_checkpoint_bytes", 0))
           // max(int(s.get("bsp_checkpoints") or 0), 1),
           "bsp_rounds": int(s.get("bsp_rounds", 0)),
           "bsp_checkpoints": int(s.get("bsp_checkpoints", 0)),
           "bsp_recoveries": int(s.get("bsp_recoveries", 0)),
           "bsp_result_fetches": int(s.get("bsp_result_fetches", 0)),
           "bsp_ring_retries": int(s.get("bsp_ring_retries", 0)),
           "kernel_launches": {w["rank"]: w["kernel_launches"]
                               for w in rec["workers"]}}
    if rec["round_ms"]:
        out["round_ms"] = rec["round_ms"]
        out["round_ms_median_after_first"] = statistics.median(
            rec["round_ms"][1:] or rec["round_ms"])
    return out


def bsp_model(path: str, device):
    from wormhole_tpu_torch.models.gbdt import GbdtConfig, GbdtLearner

    lrn = GbdtLearner(GbdtConfig(), device=device)
    lrn.load(path)
    return lrn


def bsp_trees_hold(tag: str, got, want, ds, rounds: int) -> dict:
    """The [mesh] bar between two GBDT models on the rows of ds: splits
    equal except at a near tie, every reached leaf of `got` within
    LEAF_ATOL of the f64 sums of its rows; and whether they are equal bit
    for bit."""
    with uncounted():
        differing, tie = compare_trees(tag, got, want, ds, rounds)
        off = 0.0
        for r in range(rounds):
            ref, reached = leaf_reference(got, ds, r)
            off = max(off, float(np.abs(got.trees["leaf_value"][r]
                                        - ref)[reached].max()))
    if off > LEAF_ATOL:
        raise AssertionError(f"[bsp] {tag}: leaves {off} from the f64 sums")
    same = rounds if tie is None else tie
    return {"splits_differing": differing, "near_tie_round": tie,
            "leaf_diff": float(np.abs(got.trees["leaf_value"][:same]
                                      - want.trees["leaf_value"][:same]
                                      ).max()) if same else 0.0,
            "leaf_off_f64": off,
            "bit_identical": all(np.array_equal(got.trees[k], want.trees[k])
                                 for k in got.trees)}


def bsp_objv_hold(tag: str, got: list, want: list, iters: int,
                  phase: str = "[bsp]") -> float:
    """An L-BFGS history that never rises and stays within rtol
    BSP_LBFGS_RTOL of `want` over the first 8 iterations (the bar of
    tests/test_torch_lbfgs.py). Returns the largest relative gap."""
    n = min(9, len(want))
    if len(got) < n or any(b > a for a, b in zip(got, got[1:])):
        raise AssertionError(f"{phase} {tag}: objective {got}")
    rel = float(np.max(np.abs(np.subtract(got[:n], want[:n]))
                       / np.abs(want[:n])))
    if not rel <= BSP_LBFGS_RTOL:
        raise AssertionError(f"{phase} {tag}: objective {got[:n]} vs "
                             f"{want[:n]} (rtol {rel:.3g})")
    return rel


def run_bsp(device, smi: str, workdir: str, rows=BSP_GBDT_ROWS,
            eval_rows=BSP_GBDT_EVAL_ROWS, depth=GBDT_DEPTH,
            max_bin=GBDT_BINS, rounds=BSP_GBDT_ROUNDS,
            agaricus_rows=AGARICUS_ROWS, iters=BSP_LBFGS_ITERS,
            gbdt_kill=BSP_GBDT_KILL) -> dict:
    """[bsp]: the BSP allreduce plane through the launcher (see the
    module docstring). Each launch's workers run on `device`."""
    import torch

    from wormhole_tpu_torch.apps import lbfgs_fm, lbfgs_linear
    from wormhole_tpu_torch.models.gbdt import GbdtConfig, GbdtLearner

    d = os.path.join(workdir, "bsp")
    os.makedirs(d)
    t = time.perf_counter()
    for r in range(BSP_RANKS):
        write_higgs_libsvm(os.path.join(d, f"train-{r}.libsvm"), rows,
                           HIGGS_DIM, seed=90 + r)
    write_higgs_libsvm(os.path.join(d, "eval.libsvm"), eval_rows, HIGGS_DIM,
                       seed=93)
    aga = os.path.join(d, "agaricus.libsvm")
    with open(aga, "w") as f:
        f.write(agaricus_text(agaricus_rows, seed=81))
    log(f"[bsp] files written in {time.perf_counter() - t:.1f}s")
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the workers' contexts share the card
    out = {}

    # GBDT at the HIGGS widths: one device on the union of the files in
    # this process (not the main path: a reference), then the launches
    pattern = os.path.join(d, "train-.*")
    with uncounted():
        one = GbdtLearner(GbdtConfig(train_data=pattern, max_depth=depth,
                                     max_bin=max_bin, num_round=rounds),
                          device=device)
        train = one.load_dataset(pattern, fit_bins=True)
        one.fit_prepared(train, [], verbose=False)
    args = [f"train_data={pattern}",
            f"eval_data={os.path.join(d, 'eval.libsvm')}",
            f"max_depth={depth}", f"max_bin={max_bin}",
            f"num_round={rounds}"]
    models = {}
    for tag, fault in (("gbdt", ""), ("gbdt kill", gbdt_kill),
                       ("gbdt again", "")):
        models[tag] = os.path.join(d, f"{tag.replace(' ', '-')}.npz")
        rec = bsp_launch(tag, "gbdt", args + [f"model_out={models[tag]}"],
                         device, d, fault, (*GBDT_KERNELS, "parse_libsvm"))
        out[tag] = bsp_summary(rec)
    per_round = out["gbdt"]["bsp_rounds"] / (BSP_RANKS * rounds)
    if per_round != depth + 2:
        raise AssertionError(f"[bsp] gbdt: {per_round} collectives a round, "
                             f"not {depth + 2}")
    kill = out["gbdt kill"]
    if kill["bsp_recoveries"] < 1 or kill["bsp_result_fetches"] < 1:
        raise AssertionError(f"[bsp] gbdt kill: {json.dumps(kill)}")
    base, killed, again = (bsp_model(models[k], device)
                           for k in ("gbdt", "gbdt kill", "gbdt again"))
    if not (base.edges.dtype == one.edges.dtype
            and np.array_equal(base.edges, one.edges)):
        raise AssertionError("[bsp] gbdt: the edges differ from one "
                             "device's on the union of the files")
    out["gbdt"]["vs_one_device"] = bsp_trees_hold(
        "gbdt vs one device", base, one, train, rounds)
    out["gbdt kill"]["vs_fault_free"] = bsp_trees_hold(
        "gbdt kill vs fault-free", killed, base, train, rounds)
    out["gbdt again"]["vs_fault_free"] = bsp_trees_hold(
        "gbdt again vs fault-free", again, base, train, rounds)
    # the level sums are integer sums on the card too (csrc/hist.cu), so
    # a respawned worker's blocks, and a second launch's, have the bits
    # of the fault-free launch's
    for tag in ("gbdt kill", "gbdt again"):
        if not out[tag]["vs_fault_free"]["bit_identical"]:
            raise AssertionError(
                f"[bsp] {tag}: the model is not bit-identical to the "
                f"fault-free launch's: {json.dumps(out[tag]['vs_fault_free'])}")
    out["gbdt kill"]["recovery_overhead_s"] = (kill["wall_s"]
                                               - out["gbdt"]["wall_s"])
    log(f"[bsp] gbdt, {BSP_RANKS} x {rows} rows of {HIGGS_DIM} features, "
        f"{max_bin} bins, depth {depth}, {rounds} rounds ({per_round:.0f} "
        f"collectives a round, so {gbdt_kill} lands in round "
        f"{(int(gbdt_kill.rsplit(':', 1)[1]) - 1) // int(per_round)}); the "
        f"edges equal one device's on the union byte for byte; the killed "
        f"launch and a second fault-free one bit-identical to the first: "
        f"{json.dumps(out['gbdt'])}; {json.dumps(out['gbdt kill'])}; "
        f"{json.dumps(out['gbdt again'])}")
    del one, train, base, killed, again

    # L-BFGS at the agaricus shape: one file read as 3 parts
    lin = [f"data={aga}", "reg_L2=0.1", f"max_lbfgs_iter={iters}"]
    for tag, app, extra in (("lbfgs", lbfgs_linear, []),
                            ("lbfgs-fm", lbfgs_fm, ["nfactor=8"])):
        with uncounted():
            single, _ = drive_lbfgs_app(app, lin + extra, device)
        runs = [("", "")] if tag == "lbfgs-fm" else [("", ""),
                                                     (" kill", BSP_LBFGS_KILL)]
        for sfx, fault in runs:
            rec = bsp_launch(tag + sfx, app.__name__.rsplit(".", 1)[1],
                             lin + extra + ["num_parts_per_file=3"], device,
                             d, fault, ("parse_libsvm",))
            out[tag + sfx] = dict(bsp_summary(rec), iterations=len(
                rec["objv"]) - 1, objective=rec["objv"][-1])
            if fault:
                out[tag + sfx]["recovery_overhead_s"] = (
                    rec["wall_s"] - out[tag]["wall_s"])
                # the killed run's final objective against the fault-free
                # launch's, to the same bar
                gap = abs(rec["objv"][-1] - out[tag]["objective"]) / abs(
                    out[tag]["objective"])
                if not gap <= BSP_LBFGS_RTOL:
                    raise AssertionError(
                        f"[bsp] {tag}{sfx}: final objective "
                        f"{rec['objv'][-1]} vs {out[tag]['objective']}")
                out[tag + sfx]["vs_fault_free_rel"] = gap
            out[tag + sfx]["vs_single_rel"] = bsp_objv_hold(
                tag + sfx, rec["objv"], single, iters)
        out[tag]["single_objective"] = single[-1]
        log(f"[bsp] {tag}: " + json.dumps({k: v for k, v in out.items()
                                           if k.startswith(tag + " ")
                                           or k == tag}))
    return out


# ------------------------------------------------------------- [global]
GLOBAL_RANKS = 2          # -n of the [global] launches (one card: gloo)
GLOBAL_KM_ITERS = 4
GLOBAL_PASSES = 1
LINEAR_GLOBAL_KERNELS = ("mesh_coo_spmv", "mesh_coo_spmv_t", "coo_spmv",
                         "coo_spmv_t", "parse_libsvm")


def global_blocks(pattern: str, nparts: int, local_rows: int, device,
                  seed: int = 0) -> list:
    """The global batches the [global] ranks step through: step s joins
    each rank's s-th block (its rows of a global batch) in rank order,
    as one RowBlock (apps/_runner.py _global_train)."""
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.data.rowblock import RowBlock
    from wormhole_tpu_torch.parallel import multihost as mh

    per = [[b for f, k in mh.rank_parts(pattern, nparts,
                                        types.SimpleNamespace(
                                            rank=r, num_workers=GLOBAL_RANKS))
            for b in MinibatchIter(f, k, nparts, minibatch_size=local_rows,
                                   seed=seed, device=device)]
           for r in range(GLOBAL_RANKS)]
    out = []
    for st in range(max(len(p) for p in per)):
        bl = [p[st] for p in per if st < len(p)]
        offs, base = [np.zeros(1, np.int64)], 0
        for b in bl:
            offs.append(b.offset[1:].astype(np.int64) + base)
            base += int(b.offset[-1])
        out.append(RowBlock(
            label=np.concatenate([b.label for b in bl]),
            offset=np.concatenate(offs),
            index=np.concatenate([b.index for b in bl]),
            value=np.concatenate([b.values_or_ones() for b in bl]),
            weight=None))
    return out


def global_one_device(lrn, train: list, val: list, passes: int) -> dict:
    """One device stepped over the launch's global batches: each pass the
    train batches, then the val batches; the last val pass's means and
    the train steps' host-clock examples/s."""
    rows, t = 0, time.perf_counter()
    for _ in range(passes):
        for b in train:
            lrn.train_batch(b)
            rows += b.size
        tot = {}
        for b in val:
            for k, v in lrn.eval_batch(b).items():
                tot[k] = tot.get(k, 0.0) + v
    wall = time.perf_counter() - t
    n = max(tot["nex"], 1.0)
    return {"logloss": tot["logloss"] / n, "auc": tot["auc"] / n,
            "examples_per_s": rows / max(wall, 1e-9)}


def global_passes(rec: dict) -> dict:
    """The launch's rank-0 lines: each pass's ms a step and examples/s,
    its final val metrics, its workers' all_reduce calls and ms."""
    import re

    out = {}
    for tag, ms, eps in re.findall(
            r"\[global-mesh\] (train pass \d+|val pass \d+): .*?"
            r"ms_per_step=([0-9.]+) examples_per_s=([0-9.]+)", rec["out"]):
        out[tag] = {"ms_per_step": float(ms), "examples_per_s": float(eps)}
    m = re.search(r"final val: logloss=([0-9.]+) auc=([0-9.]+)", rec["out"])
    if m:
        out["val"] = {"logloss": float(m.group(1)), "auc": float(m.group(2))}
    out["allreduce"] = {w["rank"]: {"calls": w["allreduce_calls"],
                                    "ms": w["allreduce_ms"]}
                        for w in rec["workers"]}
    out["wall_s"] = rec["wall_s"]
    return out


def kmeans_hold(tag: str, got_cost: float, got_centroids: np.ndarray,
                km, km_cost: float) -> dict:
    """A k-means run on several ranks against one device (`km`, run from
    the same initial centroids): the cost within 1e-4; the centroids
    within atol 1e-5 plus what two rows assigned to another cluster at a
    near tie move them by (2 / the smallest cluster's count: the rows
    are unit vectors). The card's densify sums a bucket's values with
    float atomics, so two runs' sums differ in their last bits and a row
    at a near tie may land in the other cluster."""
    import torch

    counts = torch.zeros(km.cfg.num_clusters, device=km.centroids.device)
    for pk, mask in km._batches_packed():
        counts += km._assign_packed(km.centroids, *pk, mask)[1]
    floor = 2.0 / max(float(counts.min()), 1.0)
    err = float(np.abs(got_centroids - km.centroids.cpu().numpy()).max())
    if abs(got_cost - km_cost) > 1e-4 or err > 1e-5 + floor:
        raise AssertionError(f"{tag}: cost {got_cost} vs one device "
                             f"{km_cost}, centroids {err} apart (bar "
                             f"{1e-5 + floor:.3g})")
    return {"cost": got_cost, "one_device": km_cost,
            "centroid_max_abs_err": err, "centroid_bar": 1e-5 + floor}


def global_hold(tag: str, got: dict, want: dict, bar: float) -> None:
    for k in ("logloss", "auc"):
        if abs(got["val"][k] - want[k]) > bar:
            raise AssertionError(f"[global] {tag} val {k} {got['val'][k]} "
                                 f"vs one device {want[k]} (bar {bar})")


def run_global(device, smi: str, workdir: str, e2e_file: str,
               km_path: str, minibatch=MINIBATCH, num_buckets=DENSE_BUCKETS,
               v_buckets=V_BUCKETS, val_rows=MINIBATCH,
               gbdt_rows=BSP_GBDT_ROWS, gbdt_eval_rows=BSP_GBDT_EVAL_ROWS,
               depth=GBDT_DEPTH, max_bin=GBDT_BINS, rounds=BSP_GBDT_ROUNDS,
               km_minibatch=KM_MINIBATCH, km_iters=GLOBAL_KM_ITERS,
               agaricus_rows=AGARICUS_ROWS, iters=BSP_LBFGS_ITERS,
               apps=("linear", "difacto", "gbdt", "kmeans", "lbfgs")
               ) -> dict:
    """[global]: the five apps on the global mesh through the launcher
    (see the module docstring). Each launch's workers run on `device`;
    each is held against one device in this process on the same global
    batches. `apps` picks some of the launches."""
    import re

    import torch

    from wormhole_tpu_torch.apps import kmeans as km_app
    from wormhole_tpu_torch.apps import lbfgs_linear
    from wormhole_tpu_torch.models.difacto import DifactoLearner
    from wormhole_tpu_torch.models.gbdt import GbdtConfig, GbdtLearner
    from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner
    from wormhole_tpu_torch.models.linear import LinearLearner
    from wormhole_tpu_torch.utils import checkpoint as ckpt

    d = os.path.join(workdir, "global")
    os.makedirs(d)
    val = os.path.join(d, "val.libsvm")
    write_libsvm(val, num_buckets, val_rows, seed=64)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the workers' contexts share the card
    local = minibatch // GLOBAL_RANKS
    out = {}
    lin_cfg = mesh_linear_config(minibatch, num_buckets)
    lin = {"train_data": e2e_file, "val_data": val,
           "minibatch": minibatch, "num_buckets": num_buckets,
           "nnz_per_row": NNZ_PER_ROW, "algo": "ftrl", "lr_eta": 0.1,
           "lambda_l1": 1.0, "kernel": "pallas", "kernel_dtype": "f32",
           "num_parts_per_file": GLOBAL_RANKS,
           "max_data_pass": GLOBAL_PASSES}

    # linear FTRL at 2^22: train + predict, then a warm start
    if "linear" in apps:
        conf = write_ps_conf(os.path.join(d, "linear.conf"), dict(
            lin, model_out=os.path.join(d, "lin"),
            predict_out=os.path.join(d, "pred")))
        rec = bsp_launch("linear", "linear", [conf], device, d,
                         kernels=LINEAR_GLOBAL_KERNELS, mode="global")
        out["linear"] = global_passes(rec)
        with uncounted():
            train_b = global_blocks(e2e_file, GLOBAL_RANKS, local, device)
            val_b = global_blocks(val, GLOBAL_RANKS, local, device)
            one = LinearLearner(dataclasses.replace(lin_cfg, kernel="pallas"),
                                device=device)
            ref = global_one_device(one, train_b, val_b, GLOBAL_PASSES)
            saved = ckpt.load_parts(os.path.join(d, "lin"))
            err, share = tables_close(
                "[global] linear vs one device",
                {"w": torch.from_numpy(saved["w"]).to(device)},
                {"w": one.store.state["w"]}, 1e-4, 1e-6)
            global_hold("linear", out["linear"], ref, 1e-3)
            pred_err = 0.0
            for r in range(GLOBAL_RANKS):
                f = os.path.join(d, f"pred_rank-{r}_part-0")
                got = np.loadtxt(f, ndmin=1)
                want = np.concatenate([one.predict_batch(b) for b in
                                       global_blocks_rank(val, r, local, device)])
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
                pred_err = max(pred_err, float(np.abs(got - want).max()))
        out["linear"].update(one_device=ref, w_max_abs_err=err,
                             w_share_of_bar=share, pred_max_abs_err=pred_err)
        conf = write_ps_conf(os.path.join(d, "warm.conf"), dict(
            lin, model_in=os.path.join(d, "lin")))
        rec = bsp_launch("linear warm", "linear", [conf], device, d,
                         kernels=LINEAR_GLOBAL_KERNELS, mode="global")
        out["linear warm"] = global_passes(rec)
        with uncounted():
            ref2 = global_one_device(one, train_b, val_b, GLOBAL_PASSES)
        global_hold("linear warm", out["linear warm"], ref2, 1e-3)
        out["linear warm"]["one_device"] = ref2
        del one, train_b
        log(f"[global] linear: {json.dumps(out['linear'])}; warm start: "
            f"{json.dumps(out['linear warm'])}")

    # DiFacto at its width over the same file
    if "difacto" in apps:
        fm = dict(lin, v_buckets=v_buckets, dim=FM_DIM, threshold=2)
        conf = write_ps_conf(os.path.join(d, "difacto.conf"), dict(
            fm, model_out=os.path.join(d, "fm")))
        rec = bsp_launch("difacto", "difacto", [conf], device, d,
                         kernels=LINEAR_GLOBAL_KERNELS, mode="global")
        out["difacto"] = global_passes(rec)
        with uncounted():
            train_b = global_blocks(e2e_file, GLOBAL_RANKS, local, device)
            val_b = global_blocks(val, GLOBAL_RANKS, local, device)
            one = DifactoLearner(difacto_config("xla", num_buckets, v_buckets,
                                                minibatch=minibatch),
                                 device=device)
            ref = global_one_device(one, train_b, val_b, GLOBAL_PASSES)
            saved = ckpt.load_parts(os.path.join(d, "fm"))
            err, share = tables_close(
                "[global] difacto vs one device",
                {k: torch.from_numpy(v).to(device) for k, v in saved.items()},
                one.ckpt_store.state, 2e-3, 2e-5)
        global_hold("difacto", out["difacto"], ref, 1e-3)
        out["difacto"].update(one_device=ref, tables_max_abs_err=err,
                              tables_share_of_bar=share)
        del one, train_b, val_b
        log(f"[global] difacto: {json.dumps(out['difacto'])}")

    # GBDT at the HIGGS widths: two files, one a rank, and an eval file
    if "gbdt" in apps:
        for r in range(GLOBAL_RANKS):
            write_higgs_libsvm(os.path.join(d, f"gb-{r}.libsvm"), gbdt_rows,
                               HIGGS_DIM, seed=95 + r)
        write_higgs_libsvm(os.path.join(d, "gb-eval.libsvm"), gbdt_eval_rows,
                           HIGGS_DIM, seed=97)
        pattern = os.path.join(d, "gb-[0-9].*")
        model = os.path.join(d, "gbdt.npz")
        rec = bsp_launch("gbdt", "gbdt", [
            f"train_data={pattern}",
            f"eval_data={os.path.join(d, 'gb-eval.libsvm')}",
            f"max_depth={depth}", f"max_bin={max_bin}", f"num_round={rounds}",
            "num_parts_per_file=1", f"model_out={model}"], device, d,
            kernels=("mesh_level_hist", *GBDT_KERNELS, "parse_libsvm"),
            mode="global")
        with uncounted():
            one = GbdtLearner(GbdtConfig(train_data=pattern, max_depth=depth,
                                         max_bin=max_bin, num_round=rounds),
                              device=device)
            train = one.load_dataset(pattern, fit_bins=True)
            t = time.perf_counter()
            one.fit_prepared(train, [], verbose=False)
            one_s = time.perf_counter() - t
            got = bsp_model(model, device)
        if not (got.edges.dtype == one.edges.dtype
                and np.array_equal(got.edges, one.edges)):
            raise AssertionError("[global] gbdt: the edges differ from one "
                                 "device's on the union of the files")
        out["gbdt"] = {"wall_s": rec["wall_s"], "round_ms": rec["round_ms"],
                       "one_device_round_ms": one_s * 1e3 / rounds,
                       "allreduce": global_passes(rec)["allreduce"],
                       "vs_one_device": bsp_trees_hold(
                           "global gbdt vs one device", got, one, train,
                           rounds)}
        del one, train, got
        log(f"[global] gbdt: {json.dumps(out['gbdt'])}")

    # k-means at the MNIST shape
    if "kmeans" in apps:
        cents = os.path.join(d, "centroids.txt")
        rec = bsp_launch("kmeans", "kmeans", [
            f"data={km_path}", f"num_clusters={KM_K}", f"max_iter={km_iters}",
            f"minibatch={km_minibatch}", f"nnz_per_row={KM_NNZ}",
            f"num_parts_per_file={GLOBAL_RANKS}", f"model_out={cents}"],
            device, d, kernels=("coo_spmv_t", "parse_libsvm"), mode="global")
        cost = float(re.search(r"final cosine objective: ([0-9.]+)",
                               rec["out"]).group(1))
        iter_ms = json.loads(re.search(r"\[kmeans-global\] iter ms: (\[.*\])",
                                       rec["out"]).group(1))
        with uncounted():
            km = KmeansLearner(KmeansConfig(
                train_data=km_path, num_clusters=KM_K, max_iter=km_iters,
                minibatch=km_minibatch, nnz_per_row=KM_NNZ), device=device)
            km.centroids = km._put(km_app.init_rows(global_blocks_rank(
                km_path, 0, km_minibatch // GLOBAL_RANKS, device), KM_K,
                km.cfg.dim, 0))
            t = time.perf_counter()
            km_cost = km.run(verbose=False)
            km_s = time.perf_counter() - t
            held = kmeans_hold("[global] kmeans", cost, np.loadtxt(cents), km,
                               km_cost)
        out["kmeans"] = {"wall_s": rec["wall_s"], **held, "iter_ms": iter_ms,
                         "one_device_iter_ms": km_s * 1e3 / km_iters,
                         "allreduce": global_passes(rec)["allreduce"]}
        log(f"[global] kmeans: {json.dumps(out['kmeans'])}")

    # L-BFGS linear at the agaricus shape, as two files
    if "lbfgs" in apps:
        text = agaricus_text(agaricus_rows, seed=81).splitlines(keepends=True)
        half = len(text) // 2
        for r, part in enumerate((text[:half], text[half:])):
            with open(os.path.join(d, f"aga-{r}.libsvm"), "w") as f:
                f.writelines(part)
        aga = os.path.join(d, "aga-.*")
        args = [f"data={aga}", "reg_L2=0.1", f"max_lbfgs_iter={iters}"]
        rec = bsp_launch("lbfgs", "lbfgs_linear", args, device, d,
                         kernels=("parse_libsvm",), mode="global")
        with uncounted():
            single, _ = drive_lbfgs_app(lbfgs_linear, args, device)
        ms_iter = float(re.search(r"ms_per_iter ([0-9.]+)", rec["out"]).group(1))
        out["lbfgs"] = {"wall_s": rec["wall_s"], "iterations": len(rec["objv"])
                        - 1, "objective": rec["objv"][-1],
                        "one_device": single[-1], "ms_per_iter": ms_iter,
                        "vs_one_rel": bsp_objv_hold("lbfgs vs one device",
                                                    rec["objv"], single, iters,
                                                    phase="[global]"),
                        "allreduce": global_passes(rec)["allreduce"]}
        log(f"[global] lbfgs: {json.dumps(out['lbfgs'])}")
    out["kernel_launches"] = "checked per launch, per worker (child processes)"
    return out


def global_blocks_rank(pattern: str, rank: int, local_rows: int,
                       device) -> list:
    """Rank `rank`'s local blocks of a [global] launch, in its order."""
    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.parallel import multihost as mh

    env = types.SimpleNamespace(rank=rank, num_workers=GLOBAL_RANKS)
    return [b for f, k in mh.rank_parts(pattern, GLOBAL_RANKS, env)
            for b in MinibatchIter(f, k, GLOBAL_RANKS,
                                   minibatch_size=local_rows, device=device)]


def data_phases(device, smi: str, data_dir: str, knums: dict,
                launches: dict) -> None:
    """The phases over files in `data_dir`: [kmeans], the apps, [e2e],
    [lbfgs], [cache], [ps] and [bsp]. Adds their main paths' launches to
    `launches` (the [ps] and [bsp] workers check their own) and
    coo_spmv_t's k-means numbers to `knums`."""
    from wormhole_tpu_torch.ops import _cuda

    # k-means: its run and app are the main path (launch counts are taken
    # inside, over them alone); the staged checks before them are not
    km_path = os.path.join(data_dir, "mnist.libsvm")
    write_mnist(km_path, KM_FILE_BATCHES * KM_MINIBATCH)
    t = time.perf_counter()
    km = run_kmeans(device, km_path)
    counts = km.pop("launches")
    log(f"[kmeans] launches on the main path: {counts}")
    for k in ("coo_spmv_t", "parse_libsvm"):
        if counts[k] == 0:
            raise AssertionError(f"the kmeans path launched no {k}")
        launches[k] += counts[k]
    knums["coo_spmv_t"]["kmeans"] = km.pop("coo_spmv_t")
    log(f"[kmeans] {smi}: " + json.dumps(km))
    log(f"[phase] kmeans {time.perf_counter() - t:.1f}s")

    # the apps and the passes from a file parse on the card: they make
    # parse_libsvm's launch count
    for name, run, want in (
            ("app", run_app, ("tile_gather", "coo_spmv_t",
                              "scatter_update")),
            ("difacto-app", run_difacto_app, FM_KERNELS),
            ("gbdt-app", run_gbdt_app, GBDT_KERNELS)):
        t = time.perf_counter()
        _cuda.reset_launches()
        run(device)
        app_launches = dict(_cuda.LAUNCHES)
        log(f"[{name}] launches: {app_launches}")
        for k in (*want, "parse_libsvm"):
            if app_launches[k] == 0:
                raise AssertionError(f"{name} run launched no {k}")
        launches["parse_libsvm"] += app_launches["parse_libsvm"]
        log(f"[phase] {name} {time.perf_counter() - t:.1f}s")
    # the serving tier: its trainers' launches are the main path's; the
    # tier itself launches no kernel
    t = time.perf_counter()
    _cuda.reset_launches()
    run_serve(device, smi, data_dir)
    counts = dict(_cuda.LAUNCHES)
    log(f"[serve] launches (its trainers): {counts}")
    missing = [k for k in ("tile_gather", "coo_spmv_t", "scatter_update",
                           *FM_KERNELS) if counts[k] == 0]
    if missing:
        raise AssertionError(f"the [serve] trainers launched no {missing}")
    for k in KERNELS:
        launches[k] += counts[k]
    log(f"[phase] serve {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    files = write_e2e_files(data_dir)
    log(f"[e2e] files of {E2E_BATCHES} minibatches written in "
        f"{time.perf_counter() - t:.1f}s")
    passes = run_e2e(device, files)
    log(f"[phase] e2e {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    lbfgs, n_parse = run_lbfgs(device, files[DENSE_BUCKETS])
    launches["parse_libsvm"] += n_parse
    log(f"[lbfgs] {smi}: " + json.dumps(lbfgs))
    log(f"[phase] lbfgs {time.perf_counter() - t:.1f}s")
    for name, rec in passes.items():
        n = rec["launches"]["parse_libsvm"]
        if n == 0:
            raise AssertionError(f"[e2e] {name} launched no parse_libsvm")
        launches["parse_libsvm"] += n
    log(f"[e2e] {smi}: " + json.dumps(
        {k: {a: v for a, v in r.items() if a != "launches"}
         for k, r in passes.items()}))

    # the formats: Criteo TSV parsed on the card into the hashing apps,
    # its crb from the convert app, and an adfea pass; their parses make
    # parse_criteo's and parse_adfea's launch counts
    t = time.perf_counter()
    tsv = write_criteo_file(data_dir)
    log(f"[e2e] Criteo TSV file of {E2E_BATCHES} minibatches, "
        f"{os.path.getsize(tsv) / 1e6:.1f} MB, written in "
        f"{time.perf_counter() - t:.1f}s")
    fp = run_format_passes(device, tsv, data_dir)
    want = {"linear-2^26": ("tile_gather", "coo_spmv_t", "scatter_update"),
            "difacto": FM_KERNELS}
    for src, parse in (("criteo", "parse_criteo"), ("crb", None),
                       ("adfea", "parse_adfea")):
        for name, rec in fp[src].items():
            for k in want[name] + ((parse,) if parse else ()):
                if rec["launches"][k] == 0:
                    raise AssertionError(f"[e2e] {name} from {src} launched "
                                         f"no {k}")
            if parse:
                launches[parse] += rec["launches"][parse]
            elif any(rec["launches"][k] for k in PARSE_KERNELS):
                raise AssertionError(f"[e2e] {name} from crb parsed text")
    for src in ("convert", "same_batches"):
        n = fp[src]["launches"]["parse_criteo"]
        if n == 0:
            raise AssertionError(f"[e2e] {src} launched no parse_criteo")
        launches["parse_criteo"] += n
    log(f"[e2e] formats {smi}: " + json.dumps(
        {k: ({a: {b: x for b, x in v.items() if b != "launches"}
              for a, v in r.items()} if k in ("criteo", "crb", "adfea")
             else {a: v for a, v in r.items() if a != "launches"})
         for k, r in fp.items()}))
    log(f"[phase] formats {time.perf_counter() - t:.1f}s")

    # the loader plane: cached passes and Lloyd iterations are the main
    # path's too; a warm one launches no parse_libsvm
    t = time.perf_counter()
    _cuda.reset_launches()
    cache = run_cache(device, km_path, files, data_dir)
    counts = dict(_cuda.LAUNCHES)
    log(f"[cache] launches: {counts}")
    for k in ("coo_spmv_t", "tile_gather", "scatter_update",
              "parse_libsvm", *FM_KERNELS):
        if counts[k] == 0:
            raise AssertionError(f"the [cache] phase launched no {k}")
    for k in KERNELS:
        launches[k] += counts[k]
    log(f"[cache] {smi}: " + json.dumps(cache))
    log(f"[phase] cache {time.perf_counter() - t:.1f}s")

    # the PS plane: its workers are child processes, so their launches
    # are not in the kernels line's counts; each launch checks its
    # workers' own counts
    t = time.perf_counter()
    ps = run_ps(device, smi, data_dir, files[DENSE_BUCKETS])
    log(f"[ps] {smi}: " + json.dumps(ps))
    log(f"[phase] ps {time.perf_counter() - t:.1f}s")

    # the BSP plane: its workers are child processes as well, and each
    # launch checks their own counts
    t = time.perf_counter()
    bsp = run_bsp(device, smi, data_dir)
    log(f"[bsp] {smi}: " + json.dumps(bsp))
    log(f"[phase] bsp {time.perf_counter() - t:.1f}s")

    # the global mesh: the five apps' workers are child processes too;
    # each launch checks their own counts
    t = time.perf_counter()
    glob = run_global(device, smi, data_dir, files[DENSE_BUCKETS], km_path)
    log(f"[global] {smi} (gloo on one card: the all_reduce is "
        f"host-staged, not a multi-GPU number): " + json.dumps(glob))
    log(f"[phase] global {time.perf_counter() - t:.1f}s")



def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--mesh-rank"]:  # a rank of [mesh], on the spec's device
        sys.path.insert(0, ROOT)
        return mesh_rank(int(argv[1]), int(argv[2]), argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "wormhole_tpu_torch")):
        print("chip_smoke: the wormhole_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    if argv[:1] == ["--turn"]:
        return kernel_turn(argv[1], argv[2])
    if argv[:1] == ["--turns"]:
        return run_turns(argv[1])
    sys.path.insert(0, ROOT)
    from wormhole_tpu_torch.ops import _cuda

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    report, probe_build = start_ptxas_report(), start_probe_build()
    secs = _cuda.build()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")
    finish_ptxas_report(report)
    probe = finish_probe_build(*probe_build)

    t = time.perf_counter()
    knums = check_kernels(device, probe=probe)
    knums["coo_spmv_t"]["compact"] = knums.pop("coo_spmv_t_compact")
    fm_nums = check_fm_kernels(device, probe=probe)
    # scatter_update's row keeps the linear path's numbers; the
    # additive-table variant's error counts against it too
    fm_nums["scatter_update"] = dict(
        knums["scatter_update"],
        max_abs_err=max(knums["scatter_update"]["max_abs_err"],
                        fm_nums["scatter_update"]["max_abs_err"]))
    knums.update(fm_nums)
    log(f"[phase] kernels {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    higgs = make_higgs()
    log(f"[phase] HIGGS-shaped data {higgs[1].shape} + {higgs[3].shape} "
        f"on the host {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    knums.update(check_hist_kernel(device, higgs))
    log(f"[phase] level_hist kernel {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    knums.update(check_parse(device))
    log(f"[phase] parse {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    check_pack(device)
    log(f"[phase] pack {time.perf_counter() - t:.1f}s")

    # each main path is driven with the counts set to 0 just before it
    # and read just after
    launches = dict.fromkeys(KERNELS, 0)
    paths = {"linear": (run_learners, LINEAR_KERNELS),
             "difacto": (run_difacto, FM_KERNELS),
             "gbdt": (lambda dev: run_gbdt(dev, higgs), GBDT_KERNELS)}
    for name, (run, path_kernels) in paths.items():
        t = time.perf_counter()
        _cuda.reset_launches()
        rates = run(device)
        counts = dict(_cuda.LAUNCHES)
        log(f"[{name}] launches on the main path: {counts}")
        missing = [k for k in path_kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {name} "
                                 f"path: {missing}")
        for k in KERNELS:
            launches[k] += counts[k]
        log(f"[{name}] rates on {smi}: "
            f"{json.dumps({k: round(v, 2) for k, v in rates.items()})}")
        log(f"[phase] {name} learner {time.perf_counter() - t:.1f}s")

    data_dir = tempfile.mkdtemp(prefix="wh-smoke-")
    try:
        data_phases(device, smi, data_dir, knums, launches)
        # the mesh's main paths run in its ranks, each with its counts set
        # to 0 just before and read just after; a W row's launches are
        # theirs
        t = time.perf_counter()
        mesh = run_mesh(device, higgs, data_dir,
                        km_path=os.path.join(data_dir, "mnist.libsvm"))
        for name, row in mesh["rows"].items():
            knums[name] = dict(row, wrapper=MESH_WRAPPERS[name])
            launches[name] = row["launches"]
            if not all(row["launches_per_rank"]):
                raise AssertionError(f"a [mesh] rank launched no {name}")
        log(f"[mesh] {smi}")
        log(f"[phase] mesh {time.perf_counter() - t:.1f}s")
    finally:
        shutil.rmtree(data_dir)

    rows = []
    for name, (src, repl) in KERNELS.items():
        k = knums[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "device_ms": k["device_ms"], "host_us": k["host_us"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
        for extra in ("floor_ms", "per_level", "probe", "compact",
                      "kmeans", "call_ms", "mb", "chunks", "wrapper",
                      "backend",
                      "launches_per_rank", "ms_per_rank", "collective_ms",
                      "vs_one_device_max_abs_err", "nccl_one_rank"):
            if extra in k:
                rows[-1][extra] = k[extra]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
