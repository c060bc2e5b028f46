"""Workload descriptors, the scheduler's work pool, and file parts.

The port's copy of the JAX package's solver/workload.py, renamed to this
package and sharing nothing with it, with one departure: the pool hands
out the lowest free part where the JAX pool picks one at random
(`random.choice`), so a run takes its parts in file order and a run
with one worker sees its rows in the same order every time. File
matching is local (`match_file`, the JAX package's data/match_file.py
without its URI schemes); `list_parts` lists a pattern's virtual parts.

Parity with reference learn/base/workload.h + workload_pool.h: a Workload
is a serializable list of (file, part k of n, format) with a pass number
and TRAIN/VAL/PRED type; the WorkloadPool is the scheduler's thread-safe
queue of virtual file parts with per-part state (available / assigned /
done), node affinity for worker-local data, failure re-queue, and a
straggler watchdog that re-assigns jobs running longer than
max(2 x mean, 5s) once enough samples exist (workload_pool.h:29-34,176-197).

This module imports neither torch nor numpy: the scheduler process,
which holds the pool, never touches the card.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import threading
import time
from enum import IntEnum
from typing import Callable, Optional


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


class WorkType(IntEnum):
    TRAIN = 1
    VAL = 2
    PRED = 3


@dataclasses.dataclass
class File:
    """One virtual part of one file (workload.h:40-52)."""

    filename: str
    format: str = "libsvm"
    part: int = 0
    num_parts: int = 1

    def __str__(self) -> str:  # debug parity with workload.h ShortDebugString
        return f"{self.filename} {self.part}/{self.num_parts} ({self.format})"


@dataclasses.dataclass
class Workload:
    """A unit of work sent to a worker (workload.h:15-38)."""

    files: list = dataclasses.field(default_factory=list)
    type: WorkType = WorkType.TRAIN
    data_pass: int = 0

    @property
    def empty(self) -> bool:
        return not self.files


_STRAGGLER_MIN_SAMPLES = 10
_STRAGGLER_FLOOR_SEC = 5.0


class WorkloadPool:
    """Thread-safe pool of file parts (workload_pool.h).

    States per part: 0 = available, 1 = assigned, 2 = done. Supports
    - Add(pattern/files, num_parts_per_file): regex-match + split
    - Get(node): hand one part to a node (the lowest available part)
    - Finish(part_id): mark done, record duration
    - Reset(node): re-queue everything a failed node held
      (the ps-lite node-failure hook path, data_parallel.h:131-135)
    - straggler watchdog thread (start_straggler_killer)
    """

    def __init__(self, straggler: bool = False):
        self._lock = threading.Lock()
        self._parts: list[dict] = []  # {file, state, node, t_start, time}
        self._durations: list[float] = []
        self._straggler = straggler
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.num_finished = 0
        # Journal hook: called with the list of part ids the straggler
        # watchdog just re-queued, OUTSIDE the pool lock (the callback
        # may take other locks — e.g. append to the scheduler journal).
        self.on_requeue: Optional[Callable[[list], None]] = None

    # -- filling ------------------------------------------------------------
    def add(self, pattern: str, num_parts_per_file: int, fmt: str = "libsvm",
            shuffle: bool = False, seed: int = 0,
            node: Optional[str] = None) -> int:
        return self.add_files(match_file(pattern), num_parts_per_file, fmt,
                              shuffle, seed, node)

    def add_files(self, files: list, num_parts_per_file: int,
                  fmt: str = "libsvm", shuffle: bool = False, seed: int = 0,
                  node: Optional[str] = None) -> int:
        """Add concrete files. With `node`, the parts get node affinity —
        only that node may be handed them; a file reported by several
        nodes accumulates all of them in its capable set (worker-local
        data, reference workload_pool.h:49-61 Add(id) + :141,155 Get
        filtering)."""
        with self._lock:
            existing = {(p["file"].filename, p["file"].part): p
                        for p in self._parts}
            for f in files:
                for k in range(num_parts_per_file):
                    p = existing.get((f, k))
                    if p is not None:
                        if node:
                            p["affinity"].add(node)
                        continue
                    self._parts.append(
                        dict(file=File(f, fmt, k, num_parts_per_file),
                             state=0, node=None, t_start=0.0,
                             affinity=({node} if node else set()),
                             pin=None, mepoch=None)
                    )
            if shuffle:
                random.Random(seed).shuffle(self._parts)
            return len(files)

    def assign_stable(self, nodes: list) -> None:
        """Batch dispatch mode (reference data_parallel.h:54-60): give
        every part a single fixed owner, round-robin over `nodes` in part
        order — the same stable n/num_workers assignment each pass. Pins
        are preferences (any node CAN read the data), so a dead owner's
        pins are cleared by drop_node rather than stranding the parts."""
        with self._lock:
            for i, p in enumerate(self._parts):
                p["pin"] = nodes[i % len(nodes)]

    def clear(self) -> None:
        with self._lock:
            self._parts.clear()
            self._durations.clear()
            self.num_finished = 0

    # -- dispatch -----------------------------------------------------------
    def get(self, node: str,
            mepoch: Optional[int] = None) -> Optional[tuple[int, File]]:
        """Assign one available part to `node`; None when nothing avail.
        Parts with a non-empty capable set only go to nodes in it
        (workload_pool.h:141,155). `mepoch` stamps the assignment with
        the membership epoch it was made under — the fence finish()
        checks."""
        with self._lock:
            avail = [i for i, p in enumerate(self._parts)
                     if p["state"] == 0
                     and (not p["affinity"] or node in p["affinity"])
                     and (p["pin"] is None or p["pin"] == node)]
            if not avail:
                return None
            # the lowest free part (the JAX pool picks at random)
            i = avail[0]
            p = self._parts[i]
            p.update(state=1, node=node, t_start=time.monotonic(),
                     mepoch=mepoch)
            return i, p["file"]

    def assign_part(self, part_id: int, node: str,
                    mepoch: Optional[int] = None) -> None:
        """Re-apply a journaled assignment during scheduler replay: the
        recorded choice is applied, not re-made (the JAX pool's `get`
        picks at random, and a journal either package wrote replays
        here). Idempotent: a part already done (the
        snapshot raced ahead of the journal record) is left alone."""
        with self._lock:
            p = self._parts[part_id]
            if p["state"] == 2:
                return
            p.update(state=1, node=node, t_start=time.monotonic(),
                     mepoch=mepoch)

    def requeue_parts(self, part_ids: list) -> None:
        """Re-apply a journaled straggler re-queue during replay: owner
        cleared but the membership stamp KEPT, so the slow owner's late
        finish can still land (mirrors remove_stragglers)."""
        with self._lock:
            for i in part_ids:
                p = self._parts[i]
                if p["state"] == 1:
                    p.update(state=0, node=None)

    def export_state(self) -> dict:
        """Serializable pool state for the scheduler journal/snapshot."""
        with self._lock:
            return {
                "parts": [
                    dict(file=dataclasses.asdict(p["file"]),
                         state=p["state"], node=p["node"],
                         affinity=sorted(p["affinity"]), pin=p["pin"],
                         mepoch=p["mepoch"])
                    for p in self._parts
                ],
                "durations": list(self._durations),
                "num_finished": self.num_finished,
                "num_skipped": getattr(self, "num_skipped", 0),
            }

    def load_state(self, state: dict) -> None:
        """Restore export_state() output. Assigned parts get a fresh
        t_start so a long scheduler outage does not trip the straggler
        watchdog the instant the pool comes back."""
        now = time.monotonic()
        with self._lock:
            self._parts = [
                dict(file=File(**p["file"]), state=p["state"],
                     node=p["node"], t_start=now,
                     affinity=set(p["affinity"]), pin=p["pin"],
                     mepoch=p["mepoch"])
                for p in state.get("parts", [])
            ]
            self._durations = [float(d) for d in state.get("durations", [])]
            self.num_finished = int(state.get("num_finished", 0))
            if state.get("num_skipped"):
                self.num_skipped = int(state["num_skipped"])

    def finish(self, part_id: int, node: Optional[str] = None,
               mepoch: Optional[int] = None) -> bool:
        """Mark done; False if a straggler twin already finished it (the
        caller must not double-count its progress).

        With `node`, the completion is FENCED: it only counts if the
        part still belongs to this node — or was merely re-queued by
        the straggler watchdog (owner cleared but the membership stamp
        intact, in which case the original owner's late finish is the
        work arriving). A node declared DEAD had its parts reset with
        the stamp cleared, so its late completions are rejected even
        though the part sits unassigned — the double-apply hole the
        membership epoch closes. Callers without node/mepoch keep the
        legacy accept-any semantics (in-process pools)."""
        with self._lock:
            p = self._parts[part_id]
            if p["state"] == 2:
                return False
            if node is not None:
                owned = p["node"] == node
                requeued_twin = (p["node"] is None
                                 and p["mepoch"] is not None
                                 and p["mepoch"] == mepoch)
                if not (owned or requeued_twin):
                    return False
            p["state"] = 2
            self._durations.append(time.monotonic() - p["t_start"])
            self.num_finished += 1
            return True

    def reset(self, node: str) -> int:
        """Re-queue parts assigned to a dead node; returns count. The
        membership stamp is cleared: a reset part's original assignment
        is fenced for good (unlike a straggler re-queue, which keeps
        the stamp so the slow owner's work can still land)."""
        n = 0
        with self._lock:
            for p in self._parts:
                if p["state"] == 1 and p["node"] == node:
                    p.update(state=0, node=None, mepoch=None)
                    n += 1
        return n

    def repin(self, nodes: list) -> int:
        """Membership changed: re-pin batch-mode pinned parts round-robin
        over the surviving/new node set. Idempotent — pin follows part
        order, so a repeat call with the same set changes nothing.
        Online-mode pools (no pins) are untouched. Returns the number of
        pins that moved."""
        if not nodes:
            return 0
        moved = 0
        with self._lock:
            k = 0
            for p in self._parts:
                if p["pin"] is None:
                    continue
                want = nodes[k % len(nodes)]
                k += 1
                if p["pin"] != want:
                    p["pin"] = want
                    moved += 1
        return moved

    def drop_node(self, node: str) -> tuple[int, int]:
        """A node left for good: release its batch-mode pins (anyone can
        take those parts) and remove it from capability sets; parts ONLY
        it could read become unreachable and are marked skipped so the
        round can still end — the reference loses a dead node's local
        disk the same way. Returns (pins_released, parts_skipped)."""
        released = skipped = 0
        with self._lock:
            for p in self._parts:
                if p["pin"] == node:
                    p["pin"] = None
                    released += 1
                if node in p["affinity"]:
                    p["affinity"].discard(node)
                    if not p["affinity"] and p["state"] != 2:
                        p.update(state=2, node=None)
                        skipped += 1
            self.num_skipped = getattr(self, "num_skipped", 0) + skipped
        return released, skipped

    def is_finished(self) -> bool:
        """An empty pool is NOT finished — it is a pool that has not been
        filled (or was just cleared mid-round-change); callers polling it
        must keep waiting rather than conclude the round is over."""
        with self._lock:
            return bool(self._parts) and all(
                p["state"] == 2 for p in self._parts)

    def size(self) -> int:
        with self._lock:
            return len(self._parts)

    def pending(self) -> int:
        with self._lock:
            return sum(1 for p in self._parts if p["state"] != 2)

    # -- straggler watchdog -------------------------------------------------
    def remove_stragglers(self) -> int:
        """Re-queue assigned parts running > max(2 x mean, 5s); only when
        >= 10 finished samples exist (workload_pool.h:176-197)."""
        requeued: list[int] = []
        with self._lock:
            if len(self._durations) < _STRAGGLER_MIN_SAMPLES:
                return 0
            mean = sum(self._durations) / len(self._durations)
            limit = max(2 * mean, _STRAGGLER_FLOOR_SEC)
            now = time.monotonic()
            for i, p in enumerate(self._parts):
                if p["state"] == 1 and now - p["t_start"] > limit:
                    p.update(state=0, node=None)
                    requeued.append(i)
        if requeued and self.on_requeue is not None:
            self.on_requeue(requeued)
        return len(requeued)

    def start_straggler_killer(self, interval: float = 2.0) -> None:
        if self._watchdog is not None:
            return

        def loop():
            while not self._stop.wait(interval):
                self.remove_stragglers()

        self._watchdog = threading.Thread(target=loop, daemon=True)
        self._watchdog.start()

    def stop_straggler_killer(self) -> None:
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
            self._watchdog = None
        self._stop = threading.Event()


def iter_parts(pattern: str, num_parts_per_file: int = 1,
               fmt: str = "libsvm", node: str = "loader"):
    """Yield the File parts `pattern` expands to, in file order. `node`
    names the consumer in the JAX package's pool and is kept for
    signature parity."""
    for filename, part, num_parts in list_parts(pattern, num_parts_per_file):
        yield File(filename, fmt, part, num_parts)


def iter_rowblocks(pattern: str, num_parts_per_file: int = 1,
                   fmt: str = "libsvm", minibatch_size: int = 65536,
                   node: str = "loader", seed: int = 0, device=None):
    """Yield the RowBlocks of every part of `pattern`, minibatch_size rows
    at a time (the reference's RowBlockIter(rank, world) path), parsed on
    `device` (None: the CPU's parser)."""
    from wormhole_tpu_torch.data.minibatch import MinibatchIter

    for f in iter_parts(pattern, num_parts_per_file, fmt, node):
        yield from MinibatchIter(f.filename, f.part, f.num_parts, f.format,
                                 minibatch_size=minibatch_size, seed=seed,
                                 device=device)
