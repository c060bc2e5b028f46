"""Continuous sampling profiler: whole-process stack sweeps at WH_PROF_HZ.

The port's copy of the JAX package's obs/pyprof.py, renamed to this
package and sharing nothing with it.

Google-Wide-Profiling style always-on capture, scaled down to one
process: a single daemon thread calls ``sys._current_frames()`` at a
modest rate (default 29 Hz — prime-ish, so it cannot phase-lock with
periodic loops), folds every thread's stack into a
``role;file:func;file:func...`` line, and tallies the lines in a dict.
The output is the standard folded-stack format (one ``line count`` per
entry) consumed by flamegraph tooling, written to

    WH_OBS_DIR/prof-<node>-<pid>.folded

at stop/atexit, and periodically fed to the flight recorder
(``obs.flight``) so anomaly dumps carry recent stacks.

Role tagging: threads self-identify via ``tag_thread("train")`` (a
single dict write, always safe to call); untagged threads fall back to
a thread-name heuristic (``ps-sync-comms`` → comms, router pool
workers → router, ...). The role prefixes the folded line, so one
glance at the profile separates the train loop from the comms thread
from the router pool.

Overhead contract: ``WH_PROF_BUDGET_PCT`` (default 2%) bounds the
measured fraction of wall time the sampler itself spends sweeping;
above budget it skips sweeps (counted in ``prof.throttled``) until the
ratio recovers. The measured ratio is exported as
``prof.overhead_frac`` so the budget claim is checkable from metrics.

Off (the default) this module starts no thread and allocates nothing:
``ACTIVE`` is None and ``tag_thread`` is one dict write.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from typing import Optional

from wormhole_tpu_torch.config import knob_value
from wormhole_tpu_torch.obs import flight as _flight
from wormhole_tpu_torch.obs import metrics as _metrics

_SAMPLES = _metrics.REGISTRY.counter("prof.samples")
_THROTTLED = _metrics.REGISTRY.counter("prof.throttled")
_OVERHEAD = _metrics.REGISTRY.gauge("prof.overhead_frac")

_INIT_LOCK = threading.Lock()

#: thread ident -> role tag, written by tag_thread()
_ROLES: dict[int, str] = {}

#: (substring of thread name, role) fallbacks for untagged threads
_NAME_ROLES = (
    ("ps-sync-comms", "comms"),
    ("router", "router"),
    ("watcher", "watcher"),
    ("loader", "loader"),
    ("MainThread", "main"),
)

_MAX_DEPTH = 64
_FLIGHT_TOP = 20  # folded lines per flight-recorder feed
_SNAP_FEED_S = 5.0  # seconds between flight-recorder stack feeds


def tag_thread(role: str) -> None:
    """Tag the calling thread's samples with a role (train loop, comms
    thread, router pool, watcher...). Idempotent and always-on cheap —
    one dict write — so hot paths may call it unconditionally."""
    _ROLES[threading.get_ident()] = role


def _role_of(ident: int, name: str) -> str:
    role = _ROLES.get(ident)
    if role:
        return role
    for sub, r in _NAME_ROLES:
        if sub in name:
            return r
    return "other"


class Profiler:
    def __init__(self, hz: float, budget_frac: float, out_dir: str,
                 node: str):
        self.hz = max(float(hz), 0.1)
        self.budget = max(float(budget_frac), 1e-4)
        self.out_dir = out_dir
        self.node = node
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._folded: dict[str, int] = {}
        self._busy_s = 0.0
        self._t_start = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="wh-pyprof", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        period = 1.0 / self.hz
        feed_every = max(int(self.hz * _SNAP_FEED_S), 1)
        n = 0
        while not self._stop.wait(period):
            wall = time.monotonic() - self._t_start
            if wall > 0 and (self._busy_s / wall) > self.budget:
                _THROTTLED.inc()
                continue
            t0 = time.monotonic()
            self._sweep()
            with self._lock:
                self._busy_s += time.monotonic() - t0
            _SAMPLES.inc()
            wall = time.monotonic() - self._t_start
            if wall > 0:
                _OVERHEAD.set(self._busy_s / wall)
            n += 1
            if n % feed_every == 0:
                _flight.record_stack(self.folded(top=_FLIGHT_TOP))

    def _sweep(self) -> None:
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        for ident, frame in frames.items():
            if ident == me:
                continue
            parts = []
            f = frame
            while f is not None and len(parts) < _MAX_DEPTH:
                code = f.f_code
                parts.append(
                    f"{os.path.basename(code.co_filename)}:{code.co_name}")
                f = f.f_back
            parts.reverse()
            key = _role_of(ident, names.get(ident, ""))
            if parts:
                key += ";" + ";".join(parts)
            with self._lock:
                self._folded[key] = self._folded.get(key, 0) + 1

    def folded(self, top: Optional[int] = None) -> list:
        """Folded-stack lines ``stack count``, heaviest first."""
        with self._lock:
            items = sorted(self._folded.items(), key=lambda kv: -kv[1])
        if top is not None:
            items = items[:top]
        return [f"{k} {v}" for k, v in items]

    def overhead_frac(self) -> float:
        wall = time.monotonic() - self._t_start
        return (self._busy_s / wall) if wall > 0 else 0.0

    def write_folded(self) -> Optional[str]:
        if not self.out_dir:
            return None
        path = os.path.join(self.out_dir,
                            f"prof-{self.node}-{self.pid}.folded")
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(path, "w") as fh:
                for line in self.folded():
                    fh.write(line + "\n")
        except OSError:
            return None
        return path

    def stop(self) -> Optional[str]:
        self._stop.set()
        self._thread.join(timeout=2.0)
        return self.write_folded()


ACTIVE: Optional[Profiler] = None


def _shutdown() -> None:
    p = ACTIVE
    if p is not None:
        p.stop()


atexit.register(_shutdown)


def init_from_env() -> Optional[Profiler]:
    """(Re)read WH_PROF*; called once at import, again by tests after
    mutating the env. Stops any predecessor sampler first."""
    global ACTIVE
    with _INIT_LOCK:
        prev, ACTIVE = ACTIVE, None
        if prev is not None:
            prev.stop()
        if not knob_value("WH_PROF"):
            return None
        ACTIVE = Profiler(
            float(knob_value("WH_PROF_HZ")),
            float(knob_value("WH_PROF_BUDGET_PCT")) / 100.0,
            os.environ.get("WH_OBS_DIR", "").strip(),
            _flight.node_id())
        return ACTIVE


init_from_env()
