"""Lightweight performance instrumentation.

The port's copy of the JAX package's utils/perf.py, renamed to this
package and sharing nothing with it.

Parity targets (SURVEY §5 tracing/profiling):
- the reference worker accumulates per-minibatch compute time and logs
  the average plus the share of time spent outside compute ("comm
  overhead") when a workload finishes (minibatch_solver.h:246-275);
- difacto's server classifies ops (push-count / push-grad / pull) and
  logs mean latencies every N ops (difacto async_sgd.h:108-127);
- beyond parity: `maybe_trace` hooks torch.profiler so a run can emit
  a Chrome trace by setting WORMHOLE_PROFILE_DIR (the JAX package's
  writes an XProf trace there).

Every Perf.add is mirrored into the process-wide metrics registry
(wormhole_tpu_torch/obs) as histogram `perf.<op>_s`, so Perf timings ride the
heartbeat-piggybacked snapshots and land in run_report.json without
callers changing anything. The local sums/counts (and their API:
snapshot/mean_ms/total/count/row) stay as the cheap in-object view the
solver and tests already use.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Optional

from wormhole_tpu_torch.obs import metrics as _obs


class Perf:
    """Per-op-class wall-time accounting (ISGDHandle::Perf parity).

    add(op, sec) accumulates; every `log_every` recorded ops the mean
    latency per class is logged, mirroring the reference's periodic
    perf rows. Thread-safe (loader threads record alongside the main
    thread)."""

    def __init__(self, log: Optional[Callable[[str], None]] = None,
                 log_every: int = 0):
        self._sum: dict[str, float] = {}
        self._cnt: dict[str, int] = {}
        self._hists: dict[str, _obs.Histogram] = {}  # registry mirrors
        self._lock = threading.Lock()
        self._log = log
        self._log_every = log_every
        self._since_log = 0

    def add(self, op: str, sec: float) -> None:  # wormlint: thread-entry
        h = self._hists.get(op)
        if h is None:
            # double-checked: the unlocked miss re-checks under the lock
            # so two threads racing a new op share one mirror handle
            with self._lock:
                h = self._hists.get(op)
                if h is None:
                    h = self._hists[op] = _obs.REGISTRY.histogram(
                        f"perf.{op}_s")
        h.observe(sec)
        with self._lock:
            self._sum[op] = self._sum.get(op, 0.0) + sec
            self._cnt[op] = self._cnt.get(op, 0) + 1
            self._since_log += 1
            due = self._log_every and self._since_log >= self._log_every
            if due:
                self._since_log = 0
                line = self._row_locked()
        if self._log and self._log_every and due:
            self._log(line)

    @contextlib.contextmanager
    def timer(self, op: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(op, time.perf_counter() - t0)

    def snapshot(self) -> tuple[dict, dict]:
        """Consistent (sums, counts) copies taken under the lock."""
        with self._lock:
            return dict(self._sum), dict(self._cnt)

    def mean_ms(self, op: str) -> float:
        with self._lock:
            c = self._cnt.get(op, 0)
            return 1e3 * self._sum.get(op, 0.0) / c if c else 0.0

    def total(self, op: str) -> float:
        with self._lock:
            return self._sum.get(op, 0.0)

    def count(self, op: str) -> int:
        with self._lock:
            return self._cnt.get(op, 0)

    def _row_locked(self) -> str:
        parts = [f"{op} {1e3 * self._sum[op] / self._cnt[op]:.2f}ms"
                 f"x{self._cnt[op]}"
                 for op in sorted(self._sum)]
        return "perf: " + "  ".join(parts)

    def row(self) -> str:
        with self._lock:
            return self._row_locked()


@contextlib.contextmanager
def maybe_trace(label: str = "run"):
    """Wrap a region in a torch.profiler trace (CPU and, where a card is
    present, CUDA activity) written to WORMHOLE_PROFILE_DIR/<label>-<pid>
    .json when that variable is set; no-op (and no profiler import)
    otherwise."""
    out = os.environ.get("WORMHOLE_PROFILE_DIR")
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(out, f"{label}-{os.getpid()}.json"))
