"""Per-node flight recorder: bounded rings of the recent past, dumped
to JSONL when something anomalous happens.

The port's copy of the JAX package's obs/flight.py, renamed to this
package and sharing nothing with it.

The black-box idea: tracing everything all the time is too expensive
and sampling misses exactly the requests you care about, so instead
every node keeps fixed-size in-memory rings of

- recent span records (fed by ``obs.trace`` even when file tracing is
  off — the recorder is a second, always-cheap span sink),
- overload decisions (admission verdict + reason, hedge outcome,
  brownout transitions, deadline budget observed at each hop),
- metric snapshots (a ``SnapshotRing`` sampled every ~5s while records
  flow),
- sampled stacks (fed by ``obs.pyprof`` when the profiler runs),

and writes them all out only when a trigger fires: an SLO burn
crossing, a scheduler/server recovery, a fault-injection arm, or the
explicit ``flight`` scheduler verb. The dump is one JSONL file per
trigger,

    <dir>/flight-<node>-<pid>-<seq>.jsonl

whose first line is the same clock anchor ``obs.trace`` writes (plus
``"kind": "flight"`` and the trigger ``"reason"``), and whose records
carry monotonic ``ts`` seconds — so ``tools/trace_viewer.py`` can
align multi-node dumps on a shared wall axis and ``tools/blackbox.py``
merges them into one Perfetto-compatible timeline.

Contract (same as runtime/faults.py and obs.trace): a module-level
``ACTIVE`` handle that is None when disabled, so every hook site is a
single None check and an un-instrumented process pays nothing — no
rings are even allocated. Enabled via ``WH_FLIGHT=1`` with the dump
directory from ``WH_FLIGHT_DIR`` (falling back to ``WH_OBS_DIR``).
Unforced dumps are rate-limited to one per ``WH_FLIGHT_MIN_SEC`` so a
flapping trigger cannot storm the disk; forced dumps (the scheduler
verb, cluster-wide dump requests) always write.

This module imports only config + obs.metrics, so obs.trace and
obs.pyprof may import it without cycles.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

from wormhole_tpu_torch.config import knob_value
from wormhole_tpu_torch.obs import metrics as _metrics

_RECORDS = _metrics.REGISTRY.counter("flight.records")
_DUMPS = _metrics.REGISTRY.counter("flight.dumps")
_DUMP_ERRORS = _metrics.REGISTRY.counter("flight.dump_errors")
_SUPPRESSED = _metrics.REGISTRY.counter("flight.suppressed")

_INIT_LOCK = threading.Lock()

#: seconds between automatic metric snapshots while records flow
_SNAP_EVERY_S = 5.0


def node_id() -> str:
    role = os.environ.get("WH_ROLE")
    if role:
        return f"{role}-{os.environ.get('WH_RANK', '0')}"
    return f"local-{os.getpid()}"


class FlightRecorder:
    def __init__(self, out_dir: str, run_id: str, node: str,
                 ring: int = 512, decisions: int = 256, snaps: int = 16,
                 min_dump_sec: float = 10.0):
        self.out_dir = out_dir
        self.run_id = run_id
        self.node = node
        self.pid = os.getpid()
        self.min_dump_sec = float(min_dump_sec)
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(
            maxlen=max(int(ring), 1))
        self._hops: collections.deque = collections.deque(
            maxlen=max(int(ring), 1))
        self._decisions: collections.deque = collections.deque(
            maxlen=max(int(decisions), 1))
        self._stacks: collections.deque = collections.deque(maxlen=8)
        self._snaps = _metrics.SnapshotRing(max(int(snaps), 1))
        self._last_snap = 0.0
        self._last_dump: Optional[float] = None
        self._seq = 0

    # -- record sinks (each: build dict, one lock'd append) ------------

    def record_span(self, name: str, cat: str, t0: float, dur: float,
                    args: Optional[dict] = None) -> None:
        rec = {"ph": "X", "name": name, "cat": cat,
               "ts": round(t0, 6), "dur": round(dur, 6)}
        if args:
            rec["args"] = dict(args)
        with self._lock:
            self._spans.append(rec)
        _RECORDS.inc()
        self._maybe_snapshot()

    def record_event(self, name: str, cat: str, args: Optional[dict] = None,
                     ) -> None:
        rec = {"ph": "i", "name": name, "cat": cat,
               "ts": round(time.monotonic(), 6)}
        if args:
            rec["args"] = dict(args)
        with self._lock:
            self._spans.append(rec)
        _RECORDS.inc()
        self._maybe_snapshot()

    def record_decision(self, verdict: str, reason: str,
                        op: Optional[str] = None, **extra) -> None:
        """One overload-plane decision: shed / admit_shed / hedge /
        hedge_win / hedge_suppressed / brownout_enter / brownout_exit,
        with the controller's recorded reason."""
        args = {"verdict": verdict, "reason": reason}
        if op is not None:
            args["op"] = op
        for k, v in extra.items():
            if v is not None:
                args[k] = v
        rec = {"ph": "i", "name": f"overload.{verdict}", "cat": "overload",
               "ts": round(time.monotonic(), 6), "args": args}
        with self._lock:
            self._decisions.append(rec)
        _RECORDS.inc()
        self._maybe_snapshot()

    def record_hop(self, op: Optional[str], budget_s: float) -> None:
        """Deadline budget observed when a frame arrived at this hop."""
        rec = {"ph": "i", "name": "net.hop", "cat": "overload",
               "ts": round(time.monotonic(), 6),
               "args": {"op": op, "budget_ms": round(budget_s * 1e3, 3)}}
        with self._lock:
            self._hops.append(rec)
        _RECORDS.inc()

    def record_stack(self, folded: list) -> None:
        """A profiler sweep's top folded-stack lines."""
        rec = {"ph": "i", "name": "prof.stacks", "cat": "prof",
               "ts": round(time.monotonic(), 6),
               "args": {"folded": list(folded)}}
        with self._lock:
            self._stacks.append(rec)
        _RECORDS.inc()

    def _maybe_snapshot(self) -> None:
        now = time.monotonic()
        with self._lock:
            if now - self._last_snap < _SNAP_EVERY_S:
                return
            self._last_snap = now
        # snapshot() outside the ring lock: it takes the registry lock
        self._snaps.add(now, _metrics.REGISTRY.snapshot())

    # -- dump ----------------------------------------------------------

    def dump(self, reason: str, force: bool = False) -> Optional[str]:
        """Write the rings out; returns the path, or None when the
        rate limit suppressed an unforced dump (or the write failed)."""
        now = time.monotonic()
        with self._lock:
            if (not force and self._last_dump is not None
                    and now - self._last_dump < self.min_dump_sec):
                _SUPPRESSED.inc()
                return None
            self._last_dump = now
            self._seq += 1
            seq = self._seq
            records = (list(self._spans) + list(self._hops)
                       + list(self._decisions) + list(self._stacks))
        for ts, snap in self._snaps.items():
            records.append({"ph": "i", "name": "flight.snapshot",
                            "cat": "flight", "ts": round(ts, 6),
                            "args": {"snap": snap}})
        records.sort(key=lambda r: r.get("ts", 0.0))
        anchor = {"ph": "M", "kind": "flight", "run": self.run_id,
                  "node": self.node, "pid": self.pid, "reason": reason,
                  "wall": time.time(), "mono": time.monotonic()}
        path = os.path.join(
            self.out_dir, f"flight-{self.node}-{self.pid}-{seq}.jsonl")
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(path, "w") as fh:
                fh.write(json.dumps(anchor, separators=(",", ":"),
                                    default=str) + "\n")
                for rec in records:
                    fh.write(json.dumps(rec, separators=(",", ":"),
                                        default=str) + "\n")
        except OSError:
            _DUMP_ERRORS.inc()
            return None
        _DUMPS.inc()
        return path


ACTIVE: Optional[FlightRecorder] = None


# -- module-level hooks: one None check each when disabled -------------

def record_decision(verdict: str, reason: str, op: Optional[str] = None,
                    **extra) -> None:
    r = ACTIVE
    if r is not None:
        r.record_decision(verdict, reason, op=op, **extra)


def record_hop(op: Optional[str], budget_s: float) -> None:
    r = ACTIVE
    if r is not None:
        r.record_hop(op, budget_s)


def record_stack(folded: list) -> None:
    r = ACTIVE
    if r is not None:
        r.record_stack(folded)


def dump(reason: str, force: bool = False) -> Optional[str]:
    r = ACTIVE
    if r is None:
        return None
    return r.dump(reason, force=force)


def init_from_env() -> Optional[FlightRecorder]:
    """(Re)read WH_FLIGHT*; called once at import, again by tests after
    mutating the env. Same serialization contract as obs.trace."""
    global ACTIVE
    with _INIT_LOCK:
        ACTIVE = None
        if not knob_value("WH_FLIGHT"):
            return None
        out_dir = (str(knob_value("WH_FLIGHT_DIR")).strip()
                   or os.environ.get("WH_OBS_DIR", "").strip())
        if not out_dir:
            return None
        run_id = os.environ.get("WH_RUN_ID") or f"run-{int(time.time())}"
        ACTIVE = FlightRecorder(
            out_dir, run_id, node_id(),
            ring=int(knob_value("WH_FLIGHT_RING")),
            decisions=int(knob_value("WH_FLIGHT_DECISIONS")),
            snaps=int(knob_value("WH_FLIGHT_SNAPS")),
            min_dump_sec=float(knob_value("WH_FLIGHT_MIN_SEC")))
        return ACTIVE


init_from_env()
