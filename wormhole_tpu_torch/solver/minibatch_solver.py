"""The train/val/predict pass loop of one process.

Parity with reference learn/solver/minibatch_solver.h + iter_solver.h and
the JAX package's single-process MinibatchSolver:
- `run()` drives `max_data_pass` passes of TRAIN then VAL, with model
  load before (model_in / load_iter) and saves during (save_iter) and
  after (model_out), then the predict pass (predict_out); checkpoints go
  through the learner's `ckpt_store` where it has one (DiFacto keeps its
  w and V tables in two stores);
- the learner's `on_pass_start` hook, where it has one, runs at the start
  of every pass; `stop_hook(pass progress, data_pass, "val" | "train")`
  may end the run early after a pass;
- each pass splits the matched files into virtual parts, taken in file
  order; loader threads parse, pack and stage minibatches into a bounded
  queue while the main thread runs the device steps. They parse and pack
  on the learner's device; on CUDA each loader does so on a stream of its
  own, off the steps' stream, and stages the packed arrays on the steps'
  stream, as the steps read them;
- the loader pool has ``WH_NUM_LOADERS`` threads, else
  ``cfg.max_concurrency``; unless ``WH_NUM_LOADERS`` pinned that count, a
  LoaderController resizes it between passes from the pass's loader
  stall;
- with the epoch pack cache on (``WH_PACK_CACHE``, ``WH_PACK_CACHE_DIR``;
  data/pack_cache.py) the loaders replay a part's prepared batches from
  the second pass on, where the learner's ``pack_cache_token`` allows it;
- the main thread's wait for the queue is the pass's loader stall
  (``last_pass_stall_s``, beside ``last_pass_wall_s``), logged as a
  share of the pass's wall with the pass line; the gauges ``queue.depth``,
  ``loader.stall_s`` and ``loader.pool_size`` and the train-stage
  histograms ``train.stage.{load,pack,h2d,step,metrics,total}_s`` go to
  obs.metrics.REGISTRY, as the JAX solver's do;
- a progress row prints every print_sec;
- predict writes one output file per part (iter_solver.h:140-156).

On a mesh (a learner whose ``mesh`` has a process group; parallel/mesh.py)
every rank reads every part and steps through the same global batches in
the same order, the order of a run with one loader: part k goes to loader
k mod n, each loader has a queue of its own, and the main thread takes
the parts' batches queue by queue, in part order. The pool may still grow
or shrink between passes; the order does not change with it. The steps,
saves and predictions are collective, so every rank runs them; only rank
0 prints progress rows and writes prediction files, and each rank prints
its own pass line (its loader stall) and keeps its own stage timers.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Callable, Optional

import torch

from wormhole_tpu_torch.data import pack_cache as _pc
from wormhole_tpu_torch.data.minibatch import MinibatchIter
from wormhole_tpu_torch.obs.metrics import REGISTRY
from wormhole_tpu_torch.solver.progress import Progress
from wormhole_tpu_torch.solver.workload import list_parts
from wormhole_tpu_torch.utils import checkpoint as ckpt
from wormhole_tpu_torch.utils.perf import Perf


class LoaderController:
    """Stall-driven sizing of the loader thread pool, between passes (the
    JAX solver's policy, unchanged). Inputs a pass: the main thread's
    total queue wait (``loader.stall_s``) and how often it found the queue
    at least half full (``queue.depth``).

    - stall above ``grow_stall`` of the wall: the device out-ran the
      loaders; grow by 1 (by 2 when starved hard, over 3x the threshold);
    - stall under ``shrink_stall`` AND the queue at least half full on
      most gets: the loaders are over-provisioned; shrink by 1. The
      queue gate stops a shrink where the stall is low only because the
      pass was short.
    Passes under 4 steps change nothing. Every decision is recorded."""

    def __init__(self, initial: int, lo: int = 1, hi: int | None = None,
                 grow_stall: float = 0.15, shrink_stall: float = 0.02):
        self.n = max(int(initial), lo)
        self.lo = lo
        # loaders mostly wait on I/O, the card and GIL-free numpy: 2x the
        # cores is the ceiling
        self.hi = hi if hi is not None else max(2 * (os.cpu_count() or 2),
                                                self.n)
        self.grow_stall = grow_stall
        self.shrink_stall = shrink_stall
        self.decisions: list[dict] = []

    def record_pass(self, stall_s: float, wall_s: float, n_steps: int,
                    queue_high_frac: float) -> int:
        """Fold one pass's numbers in; returns the pool size for the next
        pass."""
        stall_frac = stall_s / max(wall_s, 1e-9)
        new = self.n
        why = "steady"
        if n_steps >= 4:
            if stall_frac > self.grow_stall:
                step = 2 if stall_frac > 3 * self.grow_stall else 1
                new = min(self.n + step, self.hi)
                why = "starved"
            elif stall_frac < self.shrink_stall and queue_high_frac > 0.5:
                new = max(self.n - 1, self.lo)
                why = "overfed"
        self.decisions.append({
            "from": self.n, "to": new, "why": why,
            "stall_frac": round(stall_frac, 4),
            "queue_high_frac": round(queue_high_frac, 3),
            "n_steps": n_steps,
        })
        self.n = new
        return new


class MembershipController:
    """Stall-driven sizing of the WORKER SET — LoaderController's policy
    one level up: where that one adds loader threads inside a process,
    this one asks the scheduler for whole worker processes. Inputs are
    the cluster-merged gauges the tracker already aggregates
    (``queue.depth``, ``loader.stall_s``); the output is a target worker
    count the scheduler publishes through its membership machinery
    (Scheduler.set_elastic_target -> retire flags / launcher spawns).

    Policy, deliberately conservative (a worker join costs a process
    spawn + PS init, so flapping is worse than lagging):
    - sustained stall (``grow_after`` consecutive starved observations)
      => grow by 1, up to ``hi``;
    - sustained idle (stall ~ 0 AND a well-stocked queue for
      ``shrink_after`` observations) => shrink by 1, down to ``lo``;
    - anything mixed resets the streaks (hysteresis).
    Every decision is recorded like LoaderController's, so the run
    report can show WHY the worker set moved."""

    def __init__(self, initial: int, lo: int = 1, hi: Optional[int] = None,
                 grow_stall: float = 0.5, shrink_stall: float = 0.05,
                 grow_after: int = 3, shrink_after: int = 6):
        self.target = max(int(initial), lo)
        self.lo = max(int(lo), 1)
        self.hi = hi if hi is not None else 2 * self.target
        self.grow_stall = grow_stall
        self.shrink_stall = shrink_stall
        self.grow_after = max(int(grow_after), 1)
        self.shrink_after = max(int(shrink_after), 1)
        self._starved = 0
        self._idle = 0
        self.decisions: list[dict] = []

    def record(self, queue_depth: float, stall_s: float,
               live: Optional[int] = None) -> int:
        """Fold one observation window in; returns the worker-count
        target. `live` (the currently registered worker count) re-bases
        the target so a crash-shrunk cluster is grown back toward the
        target rather than the controller shrinking to match it."""
        new = self.target
        why = "steady"
        if stall_s > self.grow_stall:
            self._starved += 1
            self._idle = 0
            if self._starved >= self.grow_after:
                new = min(self.target + 1, self.hi)
                why = "starved"
                self._starved = 0
        elif stall_s < self.shrink_stall and queue_depth >= 1.0:
            self._idle += 1
            self._starved = 0
            if self._idle >= self.shrink_after:
                new = max(self.target - 1, self.lo)
                why = "overfed"
                self._idle = 0
        else:
            self._starved = 0
            self._idle = 0
        if new != self.target or why != "steady":
            self.decisions.append({
                "from": self.target, "to": new, "why": why,
                "stall_s": round(float(stall_s), 3),
                "queue_depth": round(float(queue_depth), 1),
                "live": live,
            })
        self.target = new
        return new


_QDEPTH = REGISTRY.gauge("queue.depth")
_STALL = REGISTRY.gauge("loader.stall_s")
_POOL = REGISTRY.gauge("loader.pool_size")

# a train batch's stages: the main thread's wall a batch is load (queue
# wait) + step + metrics (merge, print); pack and h2d run in the loader
# threads, overlapped with the steps. All are host times: the pack's sorts
# on the card and the parse sync before they return, the staging copies
# from pageable memory on the steps' stream (so h2d also waits for the
# steps queued ahead of it), and a step reads its progress back.
_ST_LOAD = REGISTRY.histogram("train.stage.load_s")
_ST_PACK = REGISTRY.histogram("train.stage.pack_s")
_ST_H2D = REGISTRY.histogram("train.stage.h2d_s")
_ST_STEP = REGISTRY.histogram("train.stage.step_s")
_ST_METRICS = REGISTRY.histogram("train.stage.metrics_s")
_ST_TOTAL = REGISTRY.histogram("train.stage.total_s")


class MinibatchSolver:
    """Drives a learner (prepare_batch / stage_batch / train_batch /
    eval_batch / predict_batch / store) over files in one process."""

    #: prepared batches a pass may hold ahead of the device step
    MAX_QUEUED = 8

    def __init__(self, learner, cfg, verbose: bool = True):
        self.learner = learner
        self.cfg = cfg
        env = os.environ.get("WH_NUM_LOADERS")
        pinned = bool(env)
        if pinned:
            self.num_loaders, src = max(1, int(env)), "WH_NUM_LOADERS"
        else:
            self.num_loaders = max(1, int(cfg.max_concurrency))
            src = "cfg.max_concurrency"
        self.verbose = verbose
        mesh = getattr(learner, "mesh", None)
        # lockstep over the ranks of a mesh (see the module docstring)
        self._lockstep = mesh is not None and mesh.device_mesh is not None
        self._rank = mesh.rank if self._lockstep else 0
        self.t0 = time.time()
        # adaptive sizing is on unless the count was pinned
        self.controller: Optional[LoaderController] = (
            None if pinned else LoaderController(self.num_loaders))
        self.pack_cache = _pc.from_env()
        # early-stop hook: (pass progress, data_pass, key) -> bool
        self.stop_hook: Optional[Callable] = None
        # PS barrier hook (SyncedStore.flush): called at the pass
        # boundary and before checkpoint saves and predict, so an async
        # sync in flight cannot leave them reading a half-merged model;
        # None in single-process runs (the PS worker wires it up)
        self.sync_flush: Optional[Callable] = None
        # per-op wall sums (the reference's minibatch_solver.h:246-275
        # perf rows); the PS worker's SyncedStore adds its push and pull
        self.perf = Perf(log=self._log)
        # the last TRAIN/VAL pass: its wall, and the main thread's wait
        # for the loaders within it
        self.last_pass_wall_s = 0.0
        self.last_pass_stall_s = 0.0
        cache_desc = "off"
        if self.pack_cache is not None:
            cache_desc = f"mem={self.pack_cache.mem_bytes >> 20}MB"
            if self.pack_cache.disk_dir:
                cache_desc += f" disk={self.pack_cache.disk_dir}"
        self._log(f"[loader] {self.num_loaders} loader thread(s) ({src}), "
                  f"adaptive={'on' if self.controller else 'off'}, "
                  f"pack_cache={cache_desc}")

    @property
    def _device(self) -> Optional[torch.device]:
        return getattr(self.learner, "device", None)

    @property
    def _ckpt_store(self):
        # learners with several KV stores expose a combined adapter
        return getattr(self.learner, "ckpt_store", None) or self.learner.store

    def run(self) -> dict:
        cfg = self.cfg
        store = self._ckpt_store
        if cfg.model_in:
            ckpt.load_model(store, cfg.model_in,
                            cfg.load_iter if cfg.load_iter >= 0 else None)
        result: dict = {}
        for dp in range(cfg.max_data_pass):
            result["train"] = self.iterate(cfg.train_data, True, dp)
            self._flush()  # pass boundary: all of this pass is merged
            if cfg.val_data:
                result["val"] = self.iterate(cfg.val_data, False, dp)
            if cfg.model_out and cfg.save_iter > 0 and (
                (dp + 1) % cfg.save_iter == 0 and dp + 1 < cfg.max_data_pass
            ):
                self._flush()
                ckpt.save_model(store, cfg.model_out, dp)
            if self._should_stop(result, dp):
                self._log(f"early stop after pass {dp}")
                break
        self._flush()
        if cfg.model_out:
            ckpt.save_model(store, cfg.model_out)
        if cfg.predict_out:
            self.predict(cfg.val_data or cfg.train_data, cfg.predict_out)
        return result

    def _flush(self) -> None:
        if self.sync_flush is not None:
            self.sync_flush()

    def _should_stop(self, result: dict, dp: int) -> bool:
        if self.stop_hook is None:
            return False
        key = "val" if "val" in result else "train"
        return bool(self.stop_hook(result[key], dp, key))

    def _pass_cache_token(self, train: bool):
        """The learner's pack version for this pass, or None where the
        pass's batches cannot be replayed: shuffle and negative sampling
        draw from a seed that changes every pass."""
        if self.pack_cache is None:
            return None
        tok_fn = getattr(self.learner, "pack_cache_token", None)
        if tok_fn is None:
            return None
        if train and (self.cfg.rand_shuffle or self.cfg.neg_sampling < 1.0):
            return None
        return tok_fn(train=train)

    def part_key(self, train: bool, token, fname: str, part: int,
                 nparts: int) -> tuple:
        """The pack cache's key of one file part's prepared batches: the
        same (token, part, file bytes, batch geometry) packs the same
        batches; anything else misses."""
        cfg = self.cfg
        return ("train" if train else "eval", token, fname, part, nparts,
                cfg.data_format, cfg.minibatch, _pc.file_stamp(fname))

    def iterate(self, data: str, train: bool, data_pass: int = 0) -> Progress:
        """One TRAIN (train=True) or VAL pass over `data`."""
        cfg = self.cfg
        lrn = self.learner
        hook = getattr(lrn, "on_pass_start", None)
        if hook:
            hook()
        parts = list(enumerate(list_parts(data, cfg.num_parts_per_file)))
        num_parts = len(parts)
        prog = Progress()
        # seed the pass with the model's standing |w|_0 so the sparsity
        # column is cumulative across passes
        prog.merge({"new_w": float(lrn.nnz())})
        prog.take_increment()
        n_loaders = self.controller.n if self.controller else self.num_loaders
        _POOL.set(n_loaders)
        end, part_end = object(), object()
        errors: list[BaseException] = []
        stop = threading.Event()
        part_lock = threading.Lock()
        if self._lockstep:
            # loader i takes parts i, i + n, ... into a queue of its own
            queues = [queue.Queue(maxsize=max(1, self.MAX_QUEUED // n_loaders))
                      for _ in range(n_loaders)]
            own = [parts[i::n_loaders] for i in range(n_loaders)]
        else:
            queues = [queue.Queue(maxsize=self.MAX_QUEUED)]

        def put(q, item) -> bool:
            """Bounded put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def next_part(i):
            with part_lock:
                mine = own[i] if self._lockstep else parts
                return mine.pop(0) if mine else None

        dev = self._device
        on_card = dev is not None and dev.type == "cuda"

        token = self._pass_cache_token(train)

        def prep(blk):
            t0 = time.perf_counter()
            out = lrn.prepare_batch(blk, train)
            if train:
                _ST_PACK.observe(time.perf_counter() - t0)
            return out

        def loader(i):
            q = queues[i % len(queues)]
            try:
                # parse and pack on a stream of this loader's own (no-op
                # off CUDA); stage on the steps' stream
                pack_stream = torch.cuda.Stream(dev) if on_card else None
                while not stop.is_set():
                    nxt = next_part(i)
                    if nxt is None:
                        return
                    part_id, (fname, part, nparts) = nxt

                    def raw_iter(fname=fname, part=part, nparts=nparts,
                                 part_id=part_id):
                        return MinibatchIter(
                            fname, part, nparts, cfg.data_format,
                            minibatch_size=cfg.minibatch,
                            shuf_buf=(cfg.rand_shuffle * cfg.minibatch
                                      if train else 0),
                            neg_sampling=cfg.neg_sampling if train else 1.0,
                            seed=data_pass * 7919 + part_id, device=dev)

                    part_key = (None if token is None else self.part_key(
                        train, token, fname, part, nparts))
                    batches = _pc.iter_part_cached(self.pack_cache, part_key,
                                                   raw_iter, prep)
                    while True:
                        with torch.cuda.stream(pack_stream):
                            b = next(batches, None)
                        if b is None:
                            break
                        # staging in the loader: batch N+1's arrays go to
                        # the device while the main thread steps batch N
                        t0 = time.perf_counter()
                        b = lrn.stage_batch(b, train=train)
                        if train:
                            _ST_H2D.observe(time.perf_counter() - t0)
                        if not put(q, b):
                            return
                    if self._lockstep and not put(q, part_end):
                        return
            except Exception as e:  # relayed to the main thread
                errors.append(e)
            finally:
                put(q, end)

        threads = [threading.Thread(target=loader, args=(i,), daemon=True)
                   for i in range(n_loaders)]
        for t in threads:
            t.start()
        mode = "train" if train else "eval"
        step = lrn.train_batch if train else lrn.eval_batch
        self._log(f"{mode} pass {data_pass}: {data}")
        self._log(Progress.header())
        n_steps = 0
        t_step = 0.0
        # queue gets, gets that found a queue at least half full, and the
        # main thread's total wait
        waits = {"gets": 0, "high": 0, "stall": 0.0}

        def get(q):
            depth = q.qsize()
            _QDEPTH.set(depth)
            waits["gets"] += 1
            if depth >= max(1, q.maxsize // 2):
                waits["high"] += 1
            t_w = time.perf_counter()
            item = q.get()
            dw = time.perf_counter() - t_w
            self.perf.add("wait", dw)
            waits["stall"] += dw
            _STALL.set(waits["stall"])
            return item, dw

        def staged():
            """(queue wait, staged batch) in the order the steps take."""
            if not self._lockstep:
                done = 0
                while done < len(threads):
                    item, dw = get(queues[0])
                    if item is end:
                        done += 1
                    else:
                        yield dw, item
                return
            for k in range(num_parts):
                while True:
                    item, dw = get(queues[k % n_loaders])
                    if item is part_end:
                        break
                    if item is end:  # its loader stopped; errors follow
                        return
                    yield dw, item

        t_pass0 = time.perf_counter()
        last_print = time.time()
        try:
            for dw, item in staged():
                t_s = time.perf_counter()
                out = step(item)
                dt = time.perf_counter() - t_s
                self.perf.add(f"{mode}_step", dt)
                t_step += dt
                n_steps += 1
                t_m = time.perf_counter()
                prog.merge(out)
                if time.time() - last_print >= cfg.print_sec:
                    self._log(prog.row(self.t0))
                    last_print = time.time()
                if train:
                    dm = time.perf_counter() - t_m
                    _ST_LOAD.observe(dw)
                    _ST_STEP.observe(dt)
                    _ST_METRICS.observe(dm)
                    _ST_TOTAL.observe(dw + dt + dm)
        finally:
            stop.set()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        self._log(prog.row(self.t0))
        wall = time.perf_counter() - t_pass0
        stall = waits["stall"]
        self.last_pass_wall_s, self.last_pass_stall_s = wall, stall
        if n_steps:
            self._log_rank(f"{mode} pass {data_pass}: {n_steps} minibatches, "
                      f"avg {1e3 * t_step / n_steps:.1f}ms/step, "
                      f"wall {wall:.3f}s, loader stall {stall:.3f}s "
                      f"({100.0 * stall / max(wall, 1e-9):.1f}% of the "
                      f"wall)")
        if self.pack_cache is not None:
            st = self.pack_cache.stats()
            self._log(
                f"[loader] pack cache: {st['hits']} hits / "
                f"{st['misses']} misses ({100 * st['hit_rate']:.0f}%), "
                f"mem {st['mem_bytes'] >> 20}MB/{st['mem_entries']} entries")
        if self.controller is not None:
            self.controller.record_pass(stall, wall, n_steps,
                                        waits["high"] / max(waits["gets"], 1))
            d = self.controller.decisions[-1]
            if d["from"] != d["to"]:
                self._log(
                    f"[loader] controller: {d['from']} -> {d['to']} "
                    f"loaders ({d['why']}, stall "
                    f"{100 * d['stall_frac']:.0f}% of wall, queue "
                    f">=half-full {100 * d['queue_high_frac']:.0f}% "
                    f"of gets)")
        return prog

    def predict(self, data: str, out_base: str) -> list[str]:
        """One PRED pass; margins written one file per part (by rank 0 of
        a mesh; every rank runs the pass's collective steps)."""
        cfg = self.cfg
        write = self._rank == 0
        if write:
            os.makedirs(os.path.dirname(out_base) or ".", exist_ok=True)
        out_files = []
        for part_id, (fname, part, nparts) in enumerate(
                list_parts(data, cfg.num_parts_per_file)):
            path = f"{out_base}_part-{part_id}"
            with (open(path, "w") if write
                  else contextlib.nullcontext()) as fh:
                for blk in MinibatchIter(fname, part, nparts,
                                         cfg.data_format,
                                         minibatch_size=cfg.minibatch,
                                         device=self._device):
                    ms = self.learner.predict_batch(blk)
                    if write:
                        fh.writelines(f"{m:.6g}\n" for m in ms)
            out_files.append(path)
        return out_files

    def _log(self, msg: str) -> None:
        """Print (rank 0 of a mesh only)."""
        if self.verbose and self._rank == 0:
            print(msg, flush=True)

    def _log_rank(self, msg: str) -> None:
        """Print on every rank, tagged with the rank on a mesh."""
        if self.verbose:
            print(f"[rank {self._rank}] {msg}" if self._lockstep else msg,
                  flush=True)
