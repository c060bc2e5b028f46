"""Mergeable progress reporting.

The reference pushes std::vector<double> progress from workers/servers to
the scheduler's monitor channel, which sums them since the last read and
prints a row every print_sec (ps::Root/Slave, reference iter_solver.h:62,
120,164; minibatch_solver.h:169-192). Here the "channel" is in-process:
learner steps return per-batch metric dicts that merge by summation, and
the solver prints the same style of row.
"""

from __future__ import annotations

import threading
import time


class Progress:
    """Summed metric vector with reference-style row formatting
    (linear progress.h:10-35: #ex, logloss, acc, auc columns).

    Thread-safe: the scheduler merges from concurrent RPC handler threads
    while its main thread reads rows (ps::Root monitor parity)."""

    def __init__(self):
        self.tot: dict[str, float] = {}
        self._last: dict[str, float] = {}
        self._lock = threading.Lock()

    def merge(self, p: dict) -> None:
        with self._lock:
            for k, v in p.items():
                self.tot[k] = self.tot.get(k, 0.0) + float(v)

    def value(self, key: str) -> float:
        with self._lock:
            return self.tot.get(key, 0.0)

    def mean(self, key: str) -> float:
        with self._lock:
            n = self.tot.get("nex", 0.0)
            return self.tot.get(key, 0.0) / n if n else 0.0

    # incremental view: metrics since last row (the reference prints
    # per-interval increments, criteo_kaggle.rst:66-75)
    def take_increment(self) -> dict[str, float]:
        with self._lock:
            inc = {k: v - self._last.get(k, 0.0)
                   for k, v in self.tot.items()}
            self._last = dict(self.tot)
            return inc

    def take_row_snapshot(self) -> tuple[dict, dict]:
        """Consistent (increment, totals) pair under ONE lock hold.
        row() needs both; taking the increment and then reading
        self.tot unlocked let RPC handler threads merge in between, so
        a row could show totals that include examples its own increment
        did not — inc sums across rows would never reconcile with the
        final totals."""
        with self._lock:
            inc = {k: v - self._last.get(k, 0.0)
                   for k, v in self.tot.items()}
            self._last = dict(self.tot)
            return inc, dict(self.tot)

    @staticmethod
    def header() -> str:
        # column parity with the reference training log (linear
        # progress.h:10-35; criteo_kaggle.rst:66-75): |w|_0 is the running
        # model sparsity (cumulative new_w deltas the train step reports
        # device-side), COPC = clicks over expected clicks
        # (binary_class_evaluation.h:76-85)
        return (f"{'time':>8} {'#total_ex':>12} {'#inc_ex':>10} "
                f"{'|w|_0':>10} {'logloss':>9} {'accuracy':>9} "
                f"{'auc':>9} {'copc':>7}")

    def row(self, t0: float) -> str:
        inc, tot = self.take_row_snapshot()
        n = inc.get("nex", 0.0)
        def m(k):
            return inc.get(k, 0.0) / n if n else 0.0
        pclk = inc.get("pclk", 0.0)
        copc = inc.get("clk", 0.0) / pclk if pclk else 0.0
        return (f"{time.time() - t0:8.1f} {tot.get('nex', 0):12.0f} "
                f"{n:10.0f} {tot.get('new_w', 0):10.0f} "
                f"{m('logloss'):9.5f} {m('acc'):9.5f} "
                f"{m('auc'):9.5f} {copc:7.4f}")
