"""Overload protection: deadlines, adaptive admission, hedging, degrade.

The port's copy of the JAX package's runtime/overload.py, renamed to
this package and sharing nothing with it.

Four cooperating mechanisms keep the serving/PS planes useful when
offered load exceeds capacity (docs/serving.md "Overload protection"):

**Deadline propagation.** A client operation binds its remaining budget
into a thread-local (``bind()``, the trace-context pattern of
obs/trace.py); every ``net.send_frame`` under the binding stamps the
remaining seconds onto the frame header as ``dl`` and ``recv_frame``
anchors it to the receiver's monotonic clock (``dl_mono``). Handlers
call ``should_shed(header)`` BEFORE dispatch: a frame whose budget is
already spent is answered with a structured shed reply instead of
computing a result nobody is waiting for (``net.deadline.shed``).
Deadlines ride relative (remaining seconds, the gRPC convention) so
cross-process clock skew cannot corrupt them; a nested ``bind`` can
only tighten the ambient deadline, never extend it.

**Adaptive admission (AIMD).** ``AdmissionController`` subsumes the
fixed ``WH_NET_MAX_INFLIGHT`` gate of runtime/net.py. With
``WH_ADMIT_AIMD`` on, the concurrency limit walks between
``WH_ADMIT_MIN`` and ``WH_ADMIT_MAX`` by the classic AIMD law driven by
measured handler latency (and, when published, the ``slo.*_burn``
gauges of obs/slo.py): sustained service latency above
``WH_ADMIT_LATENCY_MS`` multiplies the limit by ``WH_ADMIT_BACKOFF``;
a window that ran at the limit without violating adds one. Ops in
``CONTROL_OPS`` (hellos, inits, membership/manifest/control traffic)
are NEVER shed — only bulk push/pull/fetch work is gated — and the
busy-reply hint scales with the observed reject pressure so retries
from many clients spread out instead of synchronizing.

**Hedged fan-out.** ``HedgeTracker`` owns the rolling-quantile hedge
delay and the hedge budget: a fan-out leg still unanswered after the
``WH_HEDGE_QUANTILE`` of recent latencies may issue ONE backup request,
provided total hedges stay under ``WH_HEDGE_BUDGET_PCT`` percent of
primaries. The duplicate reuses the primary's (sender, seq), so the
receiving shard's reply cache keeps it exactly-once — pure tail
insurance, bounded extra load (``serve.hedge.*``).

**Degraded mode.** ``DegradeController`` watches per-request latency
against the serving SLO; when the violation fraction burns past
``WH_DEGRADE_BURN`` times the SLO allowance for ``WH_DEGRADE_AFTER_SEC``
straight, it flips active and the router stops paying for strict
version consistency (serving bounded-staleness mixed-version replies
stamped ``degraded=1``), flipping back once the burn stays clear for
``WH_DEGRADE_CLEAR_SEC`` (``serve.degraded.*``).

This module sits below runtime/net.py and runtime/retry.py in the
import graph (it imports neither), so every wire/retry layer can use it.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from wormhole_tpu_torch.config import knob_value
from wormhole_tpu_torch.obs import flight as _flight
from wormhole_tpu_torch.obs import metrics as _obs

_DEADLINE_SHED = _obs.REGISTRY.counter("net.deadline.shed")
_ADMIT_SHEDS = _obs.REGISTRY.counter("admit.sheds")
_ADMIT_LIMIT = _obs.REGISTRY.gauge("admit.limit")
_ADMIT_INFLIGHT = _obs.REGISTRY.gauge("admit.inflight")
_HEDGE_ISSUED = _obs.REGISTRY.counter("serve.hedge.issued")
_HEDGE_WINS = _obs.REGISTRY.counter("serve.hedge.wins")
_HEDGE_SUPPRESSED = _obs.REGISTRY.counter("serve.hedge.suppressed")
_HEDGE_DELAY_MS = _obs.REGISTRY.gauge("serve.hedge.delay_ms")
_DEGRADED_ACTIVE = _obs.REGISTRY.gauge("serve.degraded.active")
_DEGRADED_REPLIES = _obs.REGISTRY.counter("serve.degraded.replies")
_DEGRADED_ENTERS = _obs.REGISTRY.counter("serve.degraded.enters")
_DEGRADED_EXITS = _obs.REGISTRY.counter("serve.degraded.exits")

#: Ops that may never be shed — liveness, membership, handshake,
#: manifest/control and snapshot traffic. Shedding a heartbeat or a
#: hello under load converts an overload into a spurious eviction /
#: failed recovery, the exact spiral admission control exists to stop.
#: Bulk data ops (push / pull / fetch) are the ONLY sheddable class.
CONTROL_OPS = frozenset({
    "hello", "init", "init_spec", "init_arrays", "stats", "shutdown",
    "save", "load", "epoch", "register", "register_serve",
})

# ------------------------------------------------------------ deadlines

_TLS = threading.local()  # .deadline = absolute monotonic deadline


class _BindDeadline:
    """Install an absolute (monotonic) deadline on this thread for a
    block. Nesting only tightens: an inner bind past the ambient
    deadline keeps the ambient one, so a sub-operation can never grant
    itself more budget than its caller holds. ``bind(None)`` is a
    no-op that still restores, mirroring trace.bind()."""

    __slots__ = ("deadline", "_saved")

    def __init__(self, deadline: Optional[float]):
        self.deadline = deadline

    def __enter__(self):
        self._saved = getattr(_TLS, "deadline", None)
        if self.deadline is not None:
            cur = self._saved
            _TLS.deadline = (self.deadline if cur is None
                             else min(cur, self.deadline))
        return self

    def __exit__(self, *exc):
        _TLS.deadline = self._saved
        return False


def bind(deadline: Optional[float]) -> _BindDeadline:
    """Bind an absolute ``time.monotonic()`` deadline (or None: no-op)."""
    return _BindDeadline(deadline)


def bind_in(remaining_s: float) -> _BindDeadline:
    """Bind a deadline ``remaining_s`` seconds from now."""
    return _BindDeadline(time.monotonic() + float(remaining_s))


def current() -> Optional[float]:
    """The ambient absolute deadline on this thread, if any — hand it
    to a worker thread's ``bind()`` (pools don't inherit thread-locals,
    the trace ``current_ctx`` pattern)."""
    return getattr(_TLS, "deadline", None)


def remaining() -> Optional[float]:
    """Seconds left in the ambient budget (may be negative); None when
    no deadline is bound."""
    d = getattr(_TLS, "deadline", None)
    return None if d is None else d - time.monotonic()


def wire_deadline() -> Optional[float]:
    """The ambient budget as a frame-header field: remaining seconds,
    floored at 0 so an already-expired budget still travels (and is
    shed at the far end rather than silently dropped here)."""
    d = getattr(_TLS, "deadline", None)
    if d is None:
        return None
    return round(max(d - time.monotonic(), 0.0), 6)


def arm(header: dict) -> None:
    """Receiver side: anchor a frame's relative ``dl`` to this
    process's monotonic clock (``dl_mono``). Called by
    ``net.recv_frame`` on every frame that carries a deadline; transit
    time is not charged (the sender stamped REMAINING budget at send)."""
    dl = header.get("dl")
    if dl is not None:
        header["dl_mono"] = time.monotonic() + float(dl)


def header_deadline(header: dict) -> Optional[float]:
    """The anchored monotonic deadline a received frame carried."""
    return header.get("dl_mono")


def should_shed(header: dict) -> bool:
    """True when this frame's budget is already spent and the server
    should answer ``shed_reply()`` instead of dispatching. Control ops
    are never shed regardless of their deadline; WH_DEADLINE_SHED=0
    disables shedding entirely (the deadline still rides the wire for
    observability)."""
    d = header.get("dl_mono")
    if d is None or time.monotonic() < d:
        return False
    if header.get("op") in CONTROL_OPS:
        return False
    if not knob_value("WH_DEADLINE_SHED"):
        return False
    _DEADLINE_SHED.inc()
    _flight.record_decision(
        "shed", "deadline expired in transit", op=header.get("op"),
        budget_ms=round((d - time.monotonic()) * 1e3, 3))
    return True


class Shed(TimeoutError):
    """A request bounced by overload protection BEFORE any work was
    done on it — an expired budget caught at the client edge, or a
    saturated admission gate. Subclasses TimeoutError so every caller
    that already classifies deadline misses (labs, chaos runs)
    handles a shed the same way without new plumbing."""


def shed_reply(header: dict) -> dict:
    """Header of the structured shed reply. Carries ``error`` so every
    existing client raises instead of mis-parsing, and ``shed=1`` so
    callers that care (labs, tests) can tell a shed from a real
    failure. Nothing was dispatched: a seq-stamped frame's fence was
    not consumed, so a (hypothetical) retry under a fresh budget would
    still apply exactly once."""
    op = header.get("op", "?")
    return {"shed": 1,
            "error": f"deadline expired before dispatch of {op!r}"}


# ------------------------------------------------------------ admission


class AdmissionController:
    """Server-side admission gate, subsuming net.InflightGate.

    Fixed mode (default): identical contract to the historical gate —
    at most ``WH_NET_MAX_INFLIGHT`` bulk requests in their handlers
    concurrently, overflow bounced with a busy reply, 0 admits all.

    Adaptive mode (``WH_ADMIT_AIMD``): the limit walks between
    ``WH_ADMIT_MIN`` and ``WH_ADMIT_MAX`` under the AIMD law, driven by
    the measured per-request service latency the handler reports to
    ``leave()`` (queue wait + dispatch) against ``WH_ADMIT_LATENCY_MS``
    — and, when some plane published SLO burn gauges into this
    process's registry, a burning ``slo.serve.latency_burn`` /
    ``slo.ps.rpc.latency_burn`` also counts as a violation. Every
    ``_ADJUST_EVERY`` completions: latency over target multiplies the
    limit by ``WH_ADMIT_BACKOFF``; a full window at the limit without
    violation adds 1.

    Priority classes: ``CONTROL_OPS`` bypass the gate entirely (never
    shed, not counted against the limit) — under overload the bulk
    plane starves before a heartbeat or hello does."""

    _ADJUST_EVERY = 16

    def __init__(self, limit: Optional[int] = None,
                 adaptive: Optional[bool] = None,
                 target_ms: Optional[float] = None):
        if limit is None:
            limit = int(knob_value("WH_NET_MAX_INFLIGHT"))
        self.adaptive = (bool(knob_value("WH_ADMIT_AIMD"))
                         if adaptive is None else bool(adaptive))
        self.lo = max(int(knob_value("WH_ADMIT_MIN")), 1)
        self.hi = max(int(knob_value("WH_ADMIT_MAX")), self.lo)
        self.target_ms = (float(knob_value("WH_ADMIT_LATENCY_MS"))
                          if target_ms is None else float(target_ms))
        self.backoff = min(max(float(knob_value("WH_ADMIT_BACKOFF")),
                               0.1), 0.99)
        if self.adaptive:
            # start from the fixed knob when set (operator intent),
            # else from the ceiling and let violations walk it down
            limit = min(max(limit or self.hi, self.lo), self.hi)
        self.limit = max(int(limit), 0)
        self.enabled = self.limit > 0
        self._lock = threading.Lock()
        self._inflight = 0
        self._ewma_ms: Optional[float] = None
        self._completions = 0
        self._hit_limit = False   # window saw a reject/full admit
        self._violated = False    # window saw latency over target
        self._reject_streak = 0   # consecutive bounces since last admit
        if self.enabled:
            _ADMIT_LIMIT.set(float(self.limit))

    # the historical counter rides along so dashboards and existing
    # drills keep one continuous series across the gate upgrade
    _BUSY_REJECTIONS = _obs.REGISTRY.counter("net.busy.rejections")

    def try_enter(self, op: Optional[str] = None) -> bool:
        """Admit one request; False means the caller must answer
        ``busy_reply(self.busy_hint_ms())`` and NOT dispatch (and must
        not ``leave()``). Control ops are always admitted."""
        if not self.enabled or (op is not None and op in CONTROL_OPS):
            return True
        with self._lock:
            if self._inflight >= self.limit:
                self._reject_streak += 1
                self._hit_limit = True
                self._BUSY_REJECTIONS.inc()
                _ADMIT_SHEDS.inc()
                _flight.record_decision(
                    "admit_shed",
                    f"inflight {self._inflight} >= limit {self.limit}",
                    op=op)
                return False
            self._inflight += 1
            self._reject_streak = 0
            if self._inflight >= self.limit:
                self._hit_limit = True
            _ADMIT_INFLIGHT.set(float(self._inflight))
        return True

    def leave(self, op: Optional[str] = None,
              service_s: Optional[float] = None) -> None:
        """Release one admitted request; ``service_s`` (recv-to-reply
        wall) feeds the AIMD controller."""
        if not self.enabled or (op is not None and op in CONTROL_OPS):
            return
        with self._lock:
            self._inflight = max(self._inflight - 1, 0)
            _ADMIT_INFLIGHT.set(float(self._inflight))
            if not self.adaptive or service_s is None:
                return
            ms = service_s * 1e3
            self._ewma_ms = (ms if self._ewma_ms is None
                             else 0.8 * self._ewma_ms + 0.2 * ms)
            if self._ewma_ms > self.target_ms:
                self._violated = True
            self._completions += 1
            if self._completions < self._ADJUST_EVERY:
                return
            self._completions = 0
            # the SLO-burn check snapshots the whole metric registry —
            # far too heavy per completion, cheap once per window
            if not self._violated and self._burning():
                self._violated = True
            if self._violated:
                self.limit = max(self.lo,
                                 int(self.limit * self.backoff))
            elif self._hit_limit:
                self.limit = min(self.hi, self.limit + 1)
            self._violated = False
            self._hit_limit = False
            _ADMIT_LIMIT.set(float(self.limit))

    @staticmethod
    def _burning() -> float:
        """Max published SLO latency burn in this process's registry
        (0.0 when none published — the gauges appear only where
        obs/slo.evaluate ran with publish=True)."""
        gauges = _obs.REGISTRY.snapshot().get("gauges", {})
        return max((v for k, v in gauges.items()
                    if k.startswith("slo.") and k.endswith("_burn")
                    and v > 1.0), default=0.0)

    def busy_hint_ms(self, base_ms: float = 25.0) -> float:
        """Load-aware retry hint for the busy reply: grows with the
        reject streak per unit of limit, so the backoff clients take
        scales with how oversubscribed the gate actually is instead of
        every bounced client re-arriving 25 ms later in lockstep."""
        with self._lock:
            streak, limit = self._reject_streak, max(self.limit, 1)
        return min(base_ms * (1.0 + streak / limit), 250.0)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight


def router_gate() -> Optional["AdmissionController"]:
    """The CLIENT-edge admission gate for a serving router, iff
    WH_ADMIT_AIMD is on (None keeps the ungated hot path one attribute
    check). Overload queues form at the router — its fan-out slots
    serialize ahead of any shard gate — so a saturated FIFO there turns
    every request into a doomed one that expires mid-queue and sheds at
    dispatch (goodput -> 0 under sustained overload, the classic
    collapse). Bouncing at ENTRY instead keeps admitted queueing
    bounded. The gate adapts on whole-request latency against the
    shared WH_ADMIT_LATENCY_MS target — deliberately TIGHT (well under
    the request deadline): past the efficient concurrency the service
    rate FALLS with queue depth (lock/scheduler thrash), so a loose
    target would converge on a deep, slow, low-goodput equilibrium
    that still technically meets the deadline."""
    if not knob_value("WH_ADMIT_AIMD"):
        return None
    return AdmissionController(limit=0, adaptive=True)


# -------------------------------------------------------------- hedging


class HedgeTracker:
    """Rolling-quantile hedge delay + hedge budget for tail-tolerant
    fan-out. ``observe()`` records primary-request latencies;
    ``delay_s()`` is the WH_HEDGE_QUANTILE of the last window (floored
    at WH_HEDGE_MIN_MS), None until ``warmup`` samples exist so cold
    caches never trigger a hedge storm. ``try_issue()`` enforces the
    budget: issued hedges stay under WH_HEDGE_BUDGET_PCT percent of
    primaries (a delay that fires but finds the budget spent counts
    ``serve.hedge.suppressed``)."""

    def __init__(self, quantile: Optional[float] = None,
                 budget_pct: Optional[float] = None,
                 min_ms: Optional[float] = None,
                 warmup: int = 32, window: int = 256):
        self.quantile = (float(knob_value("WH_HEDGE_QUANTILE"))
                         if quantile is None else float(quantile))
        self.budget_pct = (float(knob_value("WH_HEDGE_BUDGET_PCT"))
                           if budget_pct is None else float(budget_pct))
        self.min_s = (float(knob_value("WH_HEDGE_MIN_MS"))
                      if min_ms is None else float(min_ms)) / 1e3
        self.warmup = int(warmup)
        self._lock = threading.Lock()
        self._lat: list[float] = []
        self._window = int(window)
        self._pos = 0
        self._primaries = 0
        self._issued = 0
        self._cached: Optional[float] = None  # quantile of the window
        self._since_sort = 0

    def observe(self, latency_s: float) -> None:
        with self._lock:
            self._primaries += 1
            self._since_sort += 1
            if len(self._lat) < self._window:
                self._lat.append(latency_s)
            else:  # ring overwrite: O(1), no deque churn on the hot path
                self._lat[self._pos] = latency_s
                self._pos = (self._pos + 1) % self._window

    def delay_s(self) -> Optional[float]:
        with self._lock:
            if len(self._lat) < self.warmup:
                return None
            # delay_s runs per fetch: re-sorting the window every call
            # is measurable at serving rates, and the quantile moves
            # slowly — recompute every 16 observations
            if self._cached is None or self._since_sort >= 16:
                s = sorted(self._lat)
                self._cached = max(
                    s[min(len(s) - 1, int(self.quantile * len(s)))],
                    self.min_s)
                self._since_sort = 0
                _HEDGE_DELAY_MS.set(self._cached * 1e3)
            return self._cached

    def try_issue(self) -> bool:
        """Claim budget for one hedge; False counts a suppression."""
        with self._lock:
            allowed = (self._issued + 1) <= (
                self.budget_pct / 100.0 * max(self._primaries, 1))
            if allowed:
                self._issued += 1
        if allowed:
            _HEDGE_ISSUED.inc()
            _flight.record_decision("hedge", "delay quantile elapsed")
        else:
            _HEDGE_SUPPRESSED.inc()
            _flight.record_decision("hedge_suppressed",
                                    "hedge budget spent")
        return allowed

    @staticmethod
    def won() -> None:
        """The backup answered first (the shard reply cache absorbed
        the duplicate — see router._attempt)."""
        _HEDGE_WINS.inc()
        _flight.record_decision("hedge_win", "backup answered first")


def hedge_tracker() -> Optional[HedgeTracker]:
    """A HedgeTracker iff WH_HEDGE is on (None keeps every hedge hook
    a single attribute check)."""
    return HedgeTracker() if knob_value("WH_HEDGE") else None


# -------------------------------------------------------------- degrade


class DegradeController:
    """Sustained-burn detector behind degraded-mode serving.

    ``observe(latency_s)`` classifies each request against
    ``target_ms`` (the serving latency SLO); the violation fraction
    over the last ``window`` requests, divided by the SLO allowance
    (obs/slo.py's 1%), is the burn rate. Burn above WH_DEGRADE_BURN
    continuously for WH_DEGRADE_AFTER_SEC activates degraded mode;
    burn clear for WH_DEGRADE_CLEAR_SEC deactivates it. Mixed-version
    fan-out replays (``observe_replay``) count as violations too —
    replay storms under a swap are precisely the consistency cost
    degraded mode sheds."""

    _ALLOWANCE = 0.01  # mirrors obs/slo.py's latency allowance

    def __init__(self, target_ms: Optional[float] = None,
                 window: int = 128):
        self.enabled = bool(knob_value("WH_DEGRADE"))
        self.target_ms = (float(knob_value("WH_SLO_SERVE_P99_MS"))
                          if target_ms is None else float(target_ms))
        self.burn_thr = float(knob_value("WH_DEGRADE_BURN"))
        self.after_s = float(knob_value("WH_DEGRADE_AFTER_SEC"))
        self.clear_s = float(knob_value("WH_DEGRADE_CLEAR_SEC"))
        self._lock = threading.Lock()
        self._window = int(window)
        self._hits: list[bool] = []
        self._pos = 0
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None
        self._active = False

    def _record(self, violated: bool) -> None:
        now = time.monotonic()
        with self._lock:
            if len(self._hits) < self._window:
                self._hits.append(violated)
            else:
                self._hits[self._pos] = violated
                self._pos = (self._pos + 1) % self._window
            frac = sum(self._hits) / len(self._hits)
            burn = frac / self._ALLOWANCE
            if burn > self.burn_thr:
                self._under_since = None
                if self._over_since is None:
                    self._over_since = now
                if (not self._active
                        and now - self._over_since >= self.after_s):
                    self._active = True
                    _DEGRADED_ENTERS.inc()
                    _DEGRADED_ACTIVE.set(1.0)
                    _flight.record_decision(
                        "brownout_enter",
                        f"burn {burn:.1f} > {self.burn_thr:.1f} "
                        f"for {self.after_s:.0f}s")
            else:
                self._over_since = None
                if self._under_since is None:
                    self._under_since = now
                if (self._active
                        and now - self._under_since >= self.clear_s):
                    self._active = False
                    _DEGRADED_EXITS.inc()
                    _DEGRADED_ACTIVE.set(0.0)
                    _flight.record_decision(
                        "brownout_exit",
                        f"burn clear for {self.clear_s:.0f}s")

    def observe(self, latency_s: float) -> None:
        if self.enabled:
            self._record(latency_s * 1e3 > self.target_ms)

    def observe_replay(self) -> None:
        """A mixed-version fan-out replay burned budget."""
        if self.enabled:
            self._record(True)

    def active(self) -> bool:
        """Serve bounded-staleness (mixed-version) replies right now?"""
        if not self.enabled:
            return False
        with self._lock:
            return self._active

    def served_degraded(self) -> None:
        _DEGRADED_REPLIES.inc()
