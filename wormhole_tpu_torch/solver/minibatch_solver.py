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
- each pass splits the matched files into virtual parts; loader threads
  (max_concurrency of them) parse, pack and stage minibatches into a
  bounded queue while the main thread runs the device steps;
- a progress row prints every print_sec;
- predict writes one output file per part (iter_solver.h:140-156).
"""

from __future__ import annotations

import os
import queue
import re
import threading
import time
from typing import Callable, Optional

from wormhole_tpu_torch.data.minibatch import MinibatchIter
from wormhole_tpu_torch.solver.progress import Progress
from wormhole_tpu_torch.utils import checkpoint as ckpt


def match_file(pattern: str) -> list[str]:
    """Sorted local files whose basename matches the regex ``pattern``'s
    basename, within its directory (reference match_file.h:12-45). A
    plain existing file matches itself."""
    if os.path.isfile(pattern):
        return [pattern]
    dirname = os.path.dirname(pattern) or "."
    rx = re.compile(os.path.basename(pattern))
    if not os.path.isdir(dirname):
        return []
    return sorted(os.path.join(dirname, n) for n in os.listdir(dirname)
                  if rx.search(n)
                  and os.path.isfile(os.path.join(dirname, n)))


def list_parts(pattern: str, num_parts_per_file: int) -> list[tuple]:
    """(filename, part, num_parts) of every virtual part of the matched
    files, in file order; the list index is the part id."""
    files = match_file(pattern)
    if not files:
        raise FileNotFoundError(f"no files match {pattern}")
    n = max(int(num_parts_per_file), 1)
    return [(f, k, n) for f in files for k in range(n)]


class MinibatchSolver:
    """Drives a learner (prepare_batch / stage_batch / train_batch /
    eval_batch / predict_batch / store) over files in one process."""

    #: prepared batches a pass may hold ahead of the device step
    MAX_QUEUED = 8

    def __init__(self, learner, cfg, verbose: bool = True):
        self.learner = learner
        self.cfg = cfg
        self.num_loaders = max(1, int(cfg.max_concurrency))
        self.verbose = verbose
        self.t0 = time.time()
        # early-stop hook: (pass progress, data_pass, key) -> bool
        self.stop_hook: Optional[Callable] = None

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
            if cfg.val_data:
                result["val"] = self.iterate(cfg.val_data, False, dp)
            if cfg.model_out and cfg.save_iter > 0 and (
                (dp + 1) % cfg.save_iter == 0 and dp + 1 < cfg.max_data_pass
            ):
                ckpt.save_model(store, cfg.model_out, dp)
            if self._should_stop(result, dp):
                self._log(f"early stop after pass {dp}")
                break
        if cfg.model_out:
            ckpt.save_model(store, cfg.model_out)
        if cfg.predict_out:
            self.predict(cfg.val_data or cfg.train_data, cfg.predict_out)
        return result

    def _should_stop(self, result: dict, dp: int) -> bool:
        if self.stop_hook is None:
            return False
        key = "val" if "val" in result else "train"
        return bool(self.stop_hook(result[key], dp, key))

    def iterate(self, data: str, train: bool, data_pass: int = 0) -> Progress:
        """One TRAIN (train=True) or VAL pass over `data`."""
        cfg = self.cfg
        lrn = self.learner
        hook = getattr(lrn, "on_pass_start", None)
        if hook:
            hook()
        parts = list(enumerate(list_parts(data, cfg.num_parts_per_file)))
        prog = Progress()
        # seed the pass with the model's standing |w|_0 so the sparsity
        # column is cumulative across passes
        prog.merge({"new_w": float(lrn.nnz())})
        prog.take_increment()
        q: queue.Queue = queue.Queue(maxsize=self.MAX_QUEUED)
        end = object()
        errors: list[BaseException] = []
        stop = threading.Event()
        part_lock = threading.Lock()

        def put(item) -> bool:
            """Bounded put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def loader():
            try:
                while not stop.is_set():
                    with part_lock:
                        if not parts:
                            return
                        part_id, (fname, part, nparts) = parts.pop(0)
                    for blk in MinibatchIter(
                            fname, part, nparts, cfg.data_format,
                            minibatch_size=cfg.minibatch,
                            shuf_buf=(cfg.rand_shuffle * cfg.minibatch
                                      if train else 0),
                            neg_sampling=cfg.neg_sampling if train else 1.0,
                            seed=data_pass * 7919 + part_id):
                        b = lrn.stage_batch(lrn.prepare_batch(blk, train),
                                            train=train)
                        if not put(b):
                            return
            except Exception as e:  # relayed to the main thread
                errors.append(e)
            finally:
                put(end)

        threads = [threading.Thread(target=loader, daemon=True)
                   for _ in range(self.num_loaders)]
        for t in threads:
            t.start()
        mode = "train" if train else "eval"
        step = lrn.train_batch if train else lrn.eval_batch
        self._log(f"{mode} pass {data_pass}: {data}")
        self._log(Progress.header())
        done = n_steps = 0
        t_step = 0.0
        t_pass0 = time.perf_counter()
        last_print = time.time()
        try:
            while done < len(threads):
                item = q.get()
                if item is end:
                    done += 1
                    continue
                t_s = time.perf_counter()
                prog.merge(step(item))
                t_step += time.perf_counter() - t_s
                n_steps += 1
                if time.time() - last_print >= cfg.print_sec:
                    self._log(prog.row(self.t0))
                    last_print = time.time()
        finally:
            stop.set()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        self._log(prog.row(self.t0))
        wall = time.perf_counter() - t_pass0
        if n_steps:
            self._log(f"{mode} pass {data_pass}: {n_steps} minibatches, "
                      f"avg {1e3 * t_step / n_steps:.1f}ms/step, "
                      f"wall {wall:.2f}s")
        return prog

    def predict(self, data: str, out_base: str) -> list[str]:
        """One PRED pass; margins written one file per part."""
        cfg = self.cfg
        os.makedirs(os.path.dirname(out_base) or ".", exist_ok=True)
        out_files = []
        for part_id, (fname, part, nparts) in enumerate(
                list_parts(data, cfg.num_parts_per_file)):
            path = f"{out_base}_part-{part_id}"
            with open(path, "w") as fh:
                for blk in MinibatchIter(fname, part, nparts,
                                         cfg.data_format,
                                         minibatch_size=cfg.minibatch):
                    for m in self.learner.predict_batch(blk):
                        fh.write(f"{m:.6g}\n")
            out_files.append(path)
        return out_files

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)
