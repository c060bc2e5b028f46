"""Durable write-ahead journal for the scheduler control plane.

The port's copy of the JAX package's runtime/sched_journal.py, renamed to this
package and sharing nothing with it.

The scheduler keeps all control-plane state (workload assignments,
membership epoch, BSP generation, server/serve URIs, barriers, blobs)
in memory.  This module makes that state durable so a respawned
scheduler resumes with exactly-once workload accounting intact:

- ``sched.journal`` — append-only JSONL; every state-mutating op
  appends one fsync'd record *after* applying its effect and *before*
  the reply is sent (WAL order: effect -> journal -> reply, so a lost
  effect implies a lost reply and the client's retry re-executes it).
- ``sched.snapshot`` — periodic compaction target, written atomically
  (tmp + fsync + os.replace) so a crash mid-compaction leaves the
  previous snapshot + journal intact.

The reader tolerates a torn tail: a partially written final line (the
scheduler died mid-append) is dropped and the file is truncated back
to the last good record so subsequent appends do not follow garbage.

Record envelope: one JSON object per line with a ``"k"`` kind tag.
Kinds are interpreted by the scheduler's replay loop, not here; the
journal itself only knows about ``{"k": "inc", "inc": N}`` records and
the snapshot's ``"inc"`` field, which carry the incarnation number
used for restart fencing.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from wormhole_tpu_torch.obs import metrics as _obs

_APPENDS = _obs.REGISTRY.counter("sched.journal.appends")
_BYTES = _obs.REGISTRY.counter("sched.journal.bytes")
_REPLAYS = _obs.REGISTRY.counter("sched.journal.replays")
_COMPACTIONS = _obs.REGISTRY.counter("sched.journal.compactions")

JOURNAL_NAME = "sched.journal"
SNAPSHOT_NAME = "sched.snapshot"


class SchedulerJournal:
    """fsync'd JSONL journal + atomic snapshot for scheduler state.

    Thread-safe: ``record`` may be called from any dispatch thread;
    ``compact`` holds the same lock across the whole snapshot build so
    no record can land between the state capture and the truncation
    (callers pass a ``state_fn`` that is invoked *inside* the lock —
    the lock ordering is therefore journal -> scheduler/pool locks,
    and no caller may hold those locks while appending).
    """

    def __init__(self, dirpath: str):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.journal_path = os.path.join(dirpath, JOURNAL_NAME)
        self.snapshot_path = os.path.join(dirpath, SNAPSHOT_NAME)
        self._lock = threading.Lock()
        self._fh = None  # type: ignore[assignment]
        self._appends_since_compact = 0

    # -- load / replay ------------------------------------------------

    def load(self) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]], int]:
        """Read (snapshot, tail_records, max_incarnation_seen).

        Truncates a torn tail in place.  Returns ``(None, [], -1)``
        when neither file exists (fresh start — incarnation 0 with no
        recovery accounting).
        """
        snap: Optional[Dict[str, Any]] = None
        max_inc = -1
        if os.path.exists(self.snapshot_path):
            try:
                with open(self.snapshot_path, "r") as f:
                    snap = json.load(f)
                if snap is not None:
                    max_inc = max(max_inc, int(snap.get("inc", 0)))
            except (OSError, ValueError) as e:
                print(f"[sched-journal] unreadable snapshot "
                      f"{self.snapshot_path}: {e!r}; ignoring", flush=True)
                snap = None
        records: List[Dict[str, Any]] = []
        if os.path.exists(self.journal_path):
            good = 0
            with open(self.journal_path, "rb") as f:
                data = f.read()
            pos = 0
            while pos < len(data):
                nl = data.find(b"\n", pos)
                if nl < 0:
                    break  # torn tail: no terminating newline
                line = data[pos:nl]
                if line.strip():
                    try:
                        rec = json.loads(line.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        break  # torn/corrupt line: stop at good prefix
                    records.append(rec)
                    if rec.get("k") == "inc":
                        max_inc = max(max_inc, int(rec.get("inc", 0)))
                pos = nl + 1
                good = pos
            if good < len(data):
                print(f"[sched-journal] truncating torn tail: "
                      f"{len(data) - good} bytes after offset {good}",
                      flush=True)
                with open(self.journal_path, "r+b") as f:
                    f.truncate(good)
            _REPLAYS.inc(len(records))
        return snap, records, max_inc

    # -- append -------------------------------------------------------

    def record(self, rec: Dict[str, Any]) -> None:
        """Append one record and fsync it before returning."""
        line = (json.dumps(rec, separators=(",", ":"), sort_keys=True)
                + "\n").encode("utf-8")
        with self._lock:
            if self._fh is None:
                self._fh = open(self.journal_path, "ab")
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._appends_since_compact += 1
        _APPENDS.inc()
        _BYTES.inc(len(line))

    @property
    def appends_since_compact(self) -> int:
        with self._lock:
            return self._appends_since_compact

    # -- compaction ---------------------------------------------------

    def compact(self, state_fn) -> None:
        """Atomically replace snapshot+journal with ``state_fn()``.

        ``state_fn`` is called with the journal lock held, so no append
        can land between the state capture and the journal truncation.
        """
        with self._lock:
            state = state_fn()
            tmp = self.snapshot_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snapshot_path)
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            with open(self.journal_path, "wb") as f:
                f.flush()
                os.fsync(f.fileno())
            self._appends_since_compact = 0
        _COMPACTIONS.inc()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
