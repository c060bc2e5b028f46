"""Process-wide metrics registry: counters, gauges, histograms.

The port's copy of the JAX package's obs/metrics.py, with its snapshot
format, so a snapshot of either merges with the other's:

- thread-safe: every instrument carries its own lock; the registry lock
  is only taken on get-or-create, so hot paths that cache their handles
  at import never touch it again;
- near-zero cost: an increment is one lock acquire and an integer add;
  nothing here writes a file or opens a socket;
- bounded memory: a histogram keeps count/sum/min/max exactly plus a
  fixed-size reservoir (Vitter's algorithm R, its PRNG seeded per name
  with zlib.crc32, so single-threaded snapshots are deterministic and
  equal to the JAX registry's for the same observations).

Snapshots are plain JSON-able dicts:

    {"counters": {name: int}, "gauges": {name: float},
     "hists": {name: {"count": n, "sum": s, "min": lo, "max": hi,
                      "res": [float, ...]}}}
"""

from __future__ import annotations

import contextlib
import random
import sys
import threading
import time
import zlib

DEFAULT_RESERVOIR = 256


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:  # wormlint: thread-entry
        with self._lock:
            self._value += n

    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (queue depth, loader stall, ...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:  # wormlint: thread-entry
        with self._lock:
            self._value = float(v)

    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Exact moments + a bounded reservoir for quantile estimates."""

    __slots__ = ("name", "reservoir", "count", "sum", "min", "max",
                 "_res", "_rng", "_lock")

    def __init__(self, name: str, reservoir: int = DEFAULT_RESERVOIR):
        self.name = name
        self.reservoir = int(reservoir)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._res: list[float] = []
        self._rng = random.Random(zlib.crc32(name.encode()))
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:  # wormlint: thread-entry
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if len(self._res) < self.reservoir:
                self._res.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.reservoir:
                    self._res[j] = v

    def quantile(self, q: float) -> float | None:
        with self._lock:
            res = sorted(self._res)
        return _quantile_sorted(res, q)

    def reset(self) -> None:
        """Forget every observation: a new measurement window (the
        handles cached at import keep working)."""
        with self._lock:
            self.count = 0
            self.sum = 0.0
            self.min = self.max = None
            self._res = []
            self._rng = random.Random(zlib.crc32(self.name.encode()))

    def snapshot(self) -> dict:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max,
                    "res": list(self._res)}


class Registry:
    """Get-or-create home for named instruments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:  # wormlint: thread-entry
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:  # wormlint: thread-entry
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,  # wormlint: thread-entry
                  reservoir: int = DEFAULT_RESERVOIR) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, reservoir)
            return h

    @contextlib.contextmanager
    def timer(self, name: str):
        """Time a block into histogram `name` (seconds)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.histogram(name).observe(time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._hists.values())
        return {
            "counters": {c.name: c.value() for c in counters},
            "gauges": {g.name: g.value() for g in gauges},
            "hists": {h.name: h.snapshot() for h in hists},
        }

    def reset(self) -> None:
        """Drop every instrument (tests and respawned incarnations).
        Handles cached at import keep working but leave the snapshots."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


#: The process-wide registry. Hot paths fetch a handle once at import
#: and call it per event.
REGISTRY = Registry()


def san_counters() -> dict | None:
    """This process's ``san.*`` counters when WH_SAN armed the port's
    sanitizer (wormhole_tpu_torch/wormsan), else None."""
    san = sys.modules.get("wormhole_tpu_torch.wormsan")
    if san is None or not san.enabled():
        return None
    san.summary()  # drains counts deferred under an obs lock
    return {k: v for k, v in REGISTRY.snapshot()["counters"].items()
            if k.startswith("san.")}


def merge_snapshots(snaps, reservoir: int = DEFAULT_RESERVOIR) -> dict:
    """Fold snapshot dicts into one: counters sum, gauges max,
    histogram moments merge and reservoirs pool then downsample."""
    counters: dict[str, int] = {}
    gauges: dict[str, float] = {}
    hists: dict[str, dict] = {}
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        for k, v in (snap.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        for k, v in (snap.get("gauges") or {}).items():
            gauges[k] = max(gauges.get(k, float(v)), float(v))
        for k, h in (snap.get("hists") or {}).items():
            if not isinstance(h, dict):
                continue
            m = hists.get(k)
            if m is None:
                m = hists[k] = {"count": 0, "sum": 0.0,
                                "min": None, "max": None, "res": []}
            m["count"] += int(h.get("count") or 0)
            m["sum"] += float(h.get("sum") or 0.0)
            for key, pick in (("min", min), ("max", max)):
                v = h.get(key)
                if v is not None:
                    m[key] = v if m[key] is None else pick(m[key], v)
            m["res"].extend(float(x) for x in (h.get("res") or ()))
    rng = random.Random(0)
    for m in hists.values():
        if len(m["res"]) > reservoir:
            m["res"] = rng.sample(m["res"], reservoir)
    return {"counters": counters, "gauges": gauges, "hists": hists}


class SnapshotRing:
    """Bounded ring of timestamped metrics snapshots (the flight
    recorder's metric history). ``add`` evicts the oldest entry past
    capacity; ``items`` hands back oldest-first copies."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._entries: list[tuple[float, dict]] = []

    def add(self, ts: float, snap: dict) -> None:
        with self._lock:
            self._entries.append((float(ts), snap))
            if len(self._entries) > self.capacity:
                del self._entries[: len(self._entries) - self.capacity]

    def items(self) -> list[tuple[float, dict]]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def _quantile_sorted(res: list[float], q: float) -> float | None:
    if not res:
        return None
    q = min(1.0, max(0.0, float(q)))
    return res[min(len(res) - 1, int(q * len(res)))]


def hist_quantile(h: dict | None, q: float) -> float | None:
    """Quantile of a snapshot-form histogram dict (or None)."""
    if not h:
        return None
    return _quantile_sorted(sorted(h.get("res") or ()), q)


def hist_stats(h: dict | None) -> dict | None:
    """Reduce a snapshot-form histogram to derived stats (drops the raw
    reservoir: this is what lands in run_report.json)."""
    if not h or not h.get("count"):
        return None
    res = sorted(h.get("res") or ())
    return {
        "count": h["count"],
        "sum": h["sum"],
        "mean": h["sum"] / h["count"],
        "min": h.get("min"),
        "max": h.get("max"),
        "p50": _quantile_sorted(res, 0.50),
        "p90": _quantile_sorted(res, 0.90),
        "p99": _quantile_sorted(res, 0.99),
    }
