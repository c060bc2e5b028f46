"""Unified deadline-budgeted retry policy for every dial/redial loop.

The port's copy of the JAX package's runtime/retry.py, renamed to this
package and sharing nothing with it.

Before this module each retrying subsystem hand-rolled its own loop:
`net.connect_with_retry` (jittered exponential dial backoff),
`PSClient._recover` (0.25s-doubling reconnect), the serving Router's
fast-dial `_rpc` loop (fixed 0.1s), and the tracker client's `blob_get`
busy-poll (fixed 0.1s).  They disagreed on jitter, caps, and — worse —
on whether a deadline bounded the loop at all, so a partitioned peer
could spin one plane while hanging another.  This module is the single
policy: every retry loop draws sleeps from a `RetryBudget` whose
deadline is fixed at construction, backs off exponentially with full
jitter, and either succeeds or *gives up* at the deadline with the
failure counted (`retry.give_ups`) — bounded degradation instead of a
hang, which is what lets a partitioned node resign from the job cleanly
(see docs/distributed.md, elasticity section).
"""

from __future__ import annotations

import dataclasses
import random
import socket
import time
from typing import Optional

from wormhole_tpu_torch.config import knob_value
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.runtime import overload as _overload

_ATTEMPTS = _obs.REGISTRY.counter("retry.attempts")
_GIVE_UPS = _obs.REGISTRY.counter("retry.give_ups")
_SUCCESSES = _obs.REGISTRY.counter("retry.successes")
_BACKOFF_S = _obs.REGISTRY.histogram("retry.backoff_s")


def _default_base() -> float:
    return float(knob_value("WH_RETRY_BASE_SEC"))


def _default_cap() -> float:
    return float(knob_value("WH_RETRY_CAP_SEC"))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a class of operations retries: a total deadline plus backoff
    shape.  Policies are cheap immutable descriptions; each *use* mints a
    `RetryBudget` whose clock starts then."""

    deadline_s: float
    base_s: float = 0.0  # 0 = WH_RETRY_BASE_SEC
    cap_s: float = 0.0  # 0 = WH_RETRY_CAP_SEC
    op: str = ""

    def budget(self, deadline_s: Optional[float] = None) -> "RetryBudget":
        return RetryBudget(
            deadline_s=self.deadline_s if deadline_s is None else deadline_s,
            base_s=self.base_s or _default_base(),
            cap_s=self.cap_s or _default_cap(),
            op=self.op)


class RetryBudget:
    """One operation's live retry state: a monotonic deadline set at
    construction and an exponentially growing, fully jittered backoff.
    The contract every converted loop follows:

        budget = policy.budget()
        while True:
            try:
                return attempt()
            except OSError as e:
                if budget.expired:
                    budget.give_up(e)   # counts retry.give_ups, raises
                budget.sleep()          # jittered, capped to remaining
    """

    def __init__(self, deadline_s: float, base_s: float = 0.0,
                 cap_s: float = 0.0, op: str = ""):
        self.op = op
        self.deadline = time.monotonic() + max(float(deadline_s), 0.0)
        self._base = base_s or _default_base()
        self._cap = cap_s or _default_cap()
        self._backoff = self._base
        self.attempts = 0

    @property
    def remaining(self) -> float:
        return self.deadline - time.monotonic()

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.deadline

    def sleep(self, hint_s: Optional[float] = None) -> float:
        """Back off before the next attempt: full jitter over the current
        exponential step (or the caller's `hint_s`, e.g. a busy reply's
        retry_ms), never sleeping past the deadline.  Returns the actual
        sleep taken.  Jitter matters here for the same reason it does in
        connect_with_retry: synchronized retries from every peer of a
        respawned/healed node arrive as a thundering herd."""
        self.attempts += 1
        _ATTEMPTS.inc()
        step = self._backoff if hint_s is None else hint_s
        dur = min(step * (0.5 + random.random()), max(self.remaining, 0.0))
        self._backoff = min(self._backoff * 2, self._cap)
        if dur > 0:
            _BACKOFF_S.observe(dur)
            time.sleep(dur)
        return dur

    def bind(self):
        """Bind this budget's deadline as the thread's ambient deadline
        for a block: every frame sent inside it carries the remaining
        budget on the wire, and servers shed the work if it expires in
        transit (runtime/overload.py). This is how budgets MINT the
        propagated deadline — the op's retry window and its wire
        deadline are one number."""
        return _overload.bind(self.deadline)

    def succeeded(self) -> None:
        """Record a success that needed at least one retry (callers that
        succeed first try never touch the budget's counters)."""
        if self.attempts:
            _SUCCESSES.inc()

    def give_up(self, err: Optional[BaseException] = None) -> None:
        """The deadline is spent: count the give-up and re-raise `err`
        (or a TimeoutError naming the op).  Give-ups are the metric the
        chaos drills pin to zero — a healed partition must never have
        pushed any plane past its budget."""
        _GIVE_UPS.inc()
        if err is not None:
            raise err
        raise TimeoutError(
            f"retry budget exhausted after {self.attempts} attempts"
            + (f" ({self.op})" if self.op else ""))


def jitter_sleep(hint_s: float) -> float:
    """One full-jitter backoff sleep for paths that carry no
    RetryBudget (e.g. a busy-reply hint on a first-try RPC).  Same
    jitter law and `retry.*` accounting as `RetryBudget.sleep`, and
    still capped to the thread's ambient deadline so a budgeted caller
    higher up the stack can't be slept past its own deadline."""
    _ATTEMPTS.inc()
    dur = hint_s * (0.5 + random.random())
    rem = _overload.remaining()
    if rem is not None:
        dur = min(dur, max(rem, 0.0))
    if dur > 0:
        _BACKOFF_S.observe(dur)
        time.sleep(dur)
    return dur


def connect(addr: tuple[str, int], deadline_s: float = 30.0,
            timeout: float = 60.0, op: str = "connect",
            on_retry=None) -> socket.socket:
    """Dial `addr` under the unified policy: refused/unreachable
    connections retry with jittered exponential backoff until
    `deadline_s` elapses, then the last OSError propagates (counted as a
    give-up).  `timeout` is the established socket's I/O timeout;
    `on_retry` lets a caller keep its own per-failure counter (net.py's
    `net.connect_retries`) next to the policy-wide `retry.*` ones.

    Both windows are clamped to the thread's ambient propagated
    deadline when one is bound: a dial may never outlive the budget of
    the operation it serves (a caller with 2s left must not sit in a
    30s dial loop or a 60s blocking connect)."""
    rem = _overload.remaining()
    if rem is not None:
        # expired: one fast attempt, then give up.  The floor must
        # still cover a localhost round-trip — the shed reply ("deadline
        # expired before dispatch") travels back over this same socket,
        # and a sub-millisecond I/O timeout turns every expired-budget
        # call into an opaque socket timeout instead of the typed shed
        # error the caller is supposed to see
        rem = max(rem, 0.05)
        deadline_s = min(deadline_s, rem)
        timeout = min(timeout, rem)
    budget = RetryBudget(deadline_s, op=op)
    while True:
        try:
            sock = socket.create_connection(addr, timeout=timeout)
            # request/response framing on a Nagle'd socket interacts
            # with delayed ACK: the tail segment of every frame can sit
            # ~40ms waiting for the peer's ACK, which dwarfs the actual
            # PS sync work (tools/ps_lab.py measures the difference)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            budget.succeeded()
            return sock
        except OSError as e:
            if on_retry is not None:
                on_retry()
            if budget.expired:
                budget.give_up(e)
            budget.sleep()
