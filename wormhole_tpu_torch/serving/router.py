"""Predict router: fan a batch's unique keys out over the serving shards.

The port's copy of the JAX package's serving/router.py, renamed to this
package and sharing nothing with it.

The router is the client half of the serving tier: it packs a RowBlock
with a scorer (serving/scoring.py), splits each table's sorted-unique
key list into the per-shard contiguous ranges of the same even
``shard_range`` split the shards loaded, fetches every shard's rows in
parallel, and scores on the reassembled compact tables — bit-identical
to the trainer's own predict (the scorer's contract).

Consistency: every shard reply carries the model ``version`` its rows
came from. A hot swap landing mid-fan-out can hand back a mixed set;
the router detects the mismatch and replays the whole fan-out
(serve.router.epoch_retries) until the versions agree — a scored batch
is always computed from ONE snapshot version, which rides back to the
caller.

Fault tolerance: shard RPCs ride stable per-connection sender ids with
monotone sequence numbers. A socket error inside the retry window
(WH_SERVE_RETRY_SEC) re-resolves the shard's uri (a respawned shard
re-registers with the scheduler; the resolver picks the new address
up), redials, and resends the SAME seq — the shard's reply cache
returns the original reply when the first send actually landed, so a
retried fetch can never straddle two versions. Busy bounces
(WH_NET_MAX_INFLIGHT) back off and resend on the same connection.
"""

from __future__ import annotations

import contextlib
import heapq
import socket as _socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

import wormhole_tpu_torch.serving.fastpath as _fastpath
from wormhole_tpu_torch.config import knob_value
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.obs import trace as _trace
from wormhole_tpu_torch.runtime import overload as _overload
from wormhole_tpu_torch.runtime import retry as _retrylib
from wormhole_tpu_torch.runtime.net import (
    busy_backoff, connect_with_retry, recv_frame, send_frame,
)
from wormhole_tpu_torch.utils.manifest import shard_range

_ROUTER_REQUESTS = _obs.REGISTRY.counter("serve.router.requests")
_ROUTER_RETRIES = _obs.REGISTRY.counter("serve.router.retries")
_EPOCH_RETRIES = _obs.REGISTRY.counter("serve.router.epoch_retries")
_FAILURES = _obs.REGISTRY.counter("serve.router.failures")
# same series the shard's pre-dispatch shed uses: "requests shed on an
# expired deadline", wherever in the stack the expiry was caught
_SHED_DEADLINE = _obs.REGISTRY.counter("serve.shed.deadline")
_LATENCY_S = _obs.REGISTRY.histogram("serve.latency_s")

# stage decomposition of one predict request (docs/serving.md): the
# sum of pack+fanout+sum+score p50s should explain the latency p50,
# and fanout further splits into wire vs shard queue/serve time via
# the queue_s/served_s fields fetch replies carry back
_STAGE_PACK_S = _obs.REGISTRY.histogram("serve.stage.pack_s")
_STAGE_FANOUT_S = _obs.REGISTRY.histogram("serve.stage.fanout_s")
_STAGE_WIRE_S = _obs.REGISTRY.histogram("serve.stage.wire_s")
_STAGE_QUEUE_S = _obs.REGISTRY.histogram("serve.stage.queue_s")
_STAGE_SCORE_S = _obs.REGISTRY.histogram("serve.stage.score_s")
_STAGE_SUM_S = _obs.REGISTRY.histogram("serve.stage.sum_s")
# score-mode fast path: per-request coalescer queue wait, the slowest
# shard's own kernel time per round (overlaps fanout, like wire/queue),
# and the micro-batcher round accounting
_STAGE_BATCH_WAIT_S = _obs.REGISTRY.histogram("serve.stage.batch_wait_s")
_STAGE_PARTIAL_S = _obs.REGISTRY.histogram("serve.stage.partial_s")
_BATCH_ROUNDS = _obs.REGISTRY.counter("serve.batch.rounds")
_BATCH_COALESCED = _obs.REGISTRY.counter("serve.batch.coalesced")
_BATCH_FLUSH_FULL = _obs.REGISTRY.counter("serve.batch.flush_full")
_BATCH_FLUSH_TIMEOUT = _obs.REGISTRY.counter("serve.batch.flush_timeout")
_BATCH_SIZE = _obs.REGISTRY.histogram("serve.batch.size")

_EPOCH_REPLAYS = 8  # fan-out replays before a mixed-version batch fails


class _HedgeTimer:
    """One long-lived scheduler thread multiplexing every pending hedge
    arm. ``threading.Timer`` spawns a THREAD per arm; at serving rates
    (2 fetches x hundreds of qps) that thread churn alone costs
    double-digit percent of capacity — measured 355 -> 301 qps on the
    serve lab's closed-loop probe. Here arming is a heap push; entries
    whose request completed first (``done`` set) are dropped at fire
    time, so there is no cancel path to race with."""

    def __init__(self):
        self._cond = threading.Condition()
        self._heap: list = []  # (fire_at, tiebreak, fire, done)
        self._n = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    #: batch scheduler wakeups: hedge delays are tail-scale (tens of
    #: ms), so a couple ms of firing slack is free — waking per entry
    #: at serving rates is not
    _GRANULARITY_S = 0.002

    def arm(self, delay_s: float, fire: Callable[[], None],
            done: threading.Event) -> None:
        at = time.monotonic() + delay_s
        with self._cond:
            if self._stop:
                return
            if self._thread is None:  # lazy: only hedging routers pay
                self._thread = threading.Thread(
                    target=self._loop, name="serve-hedge", daemon=True)
                self._thread.start()
            self._n += 1
            # only a new EARLIEST entry moves the scheduler's wake-up
            # time; notifying per arm would wake it at the full
            # request rate for nothing
            is_head = not self._heap or at < self._heap[0][0]
            heapq.heappush(self._heap, (at, self._n, fire, done))
            if is_head:
                self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()

    def _loop(self) -> None:
        while True:
            due = []
            with self._cond:
                while not self._stop:
                    # purge entries whose request already completed —
                    # the common case, since only tail requests outlive
                    # their hedge delay
                    while self._heap and self._heap[0][3].is_set():
                        heapq.heappop(self._heap)
                    if not self._heap:
                        self._cond.wait()
                        continue
                    wait = self._heap[0][0] - time.monotonic()
                    if wait <= 0:
                        now = time.monotonic()
                        while self._heap and self._heap[0][0] <= now:
                            e = heapq.heappop(self._heap)
                            if not e[3].is_set():
                                due.append(e)
                        break
                    self._cond.wait(max(wait, self._GRANULARITY_S))
                if self._stop:
                    return
            for _, _, fire, done in due:
                if not done.is_set():
                    try:
                        fire()
                    except Exception:
                        pass  # e.g. pool shut down mid-close


class _Slot:
    """One pooled shard connection with a STABLE sender identity: the
    seq counter survives redials, so a retried frame after a reconnect
    reuses its seq and hits the shard's reply cache."""

    def __init__(self, sender: str):
        self.sender = sender
        self.seq = 0
        self.sock = None
        self.f = None

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        self.sock = None
        self.f = None


class _BatchReq:
    """One predict request parked in the micro-batcher: its ScorePack,
    the caller's trace context and ambient deadline (batcher-thread
    rounds rebind both), and the result slots the round fills."""

    __slots__ = ("pack", "ctx", "dl", "t0", "t_enq", "done",
                 "scores", "version", "meta", "error")

    def __init__(self, pack, ctx, dl, t0):
        self.pack = pack
        self.ctx = ctx
        self.dl = dl            # absolute time.monotonic deadline | None
        self.t0 = t0            # pack start (end-to-end latency origin)
        self.t_enq = time.perf_counter()
        self.done = threading.Event()
        self.scores = None
        self.version = 0
        self.meta: dict = {}
        self.error: Optional[BaseException] = None


class _Batcher:
    """Dynamic micro-batcher: concurrent ``predict_block`` calls park
    here and one dedicated thread drains them into coalesced score
    rounds of at most WH_SERVE_BATCH_MAX members.

    With the default WH_SERVE_BATCH_WAIT_MS=0 there is no artificial
    linger — batching is *continuous*: while one round executes, new
    arrivals queue, and the next round takes them all. Under a closed
    loop the round size self-regulates to roughly the offered
    concurrency; an idle router serves singles at zero added latency.
    A positive linger holds a non-full round open for stragglers,
    flushing early when any member's deadline would otherwise expire
    mid-round — and is skipped entirely while degraded mode is active
    (admission's job is shedding load then, not shaping bursts)."""

    def __init__(self, router: "Router", max_batch: int, wait_s: float):
        self._router = router
        self._max = max(int(max_batch), 1)
        self._wait = max(float(wait_s), 0.0)
        self._cond = threading.Condition()
        self._q: List[_BatchReq] = []  # wormlint: guarded-by(self._cond)
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True)
        self._thread.start()

    def submit(self, req: _BatchReq):
        with self._cond:
            if self._stop:
                raise RuntimeError("router closed")
            self._q.append(req)
            self._cond.notify()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.scores, req.version, req.meta

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()

    def _linger(self) -> None:
        """Hold a non-full round open up to the linger budget, clamped
        by the earliest member deadline. Two clock domains on purpose:
        the linger is perf_counter (like every stage time), deadlines
        are absolute time.monotonic — never mix them."""
        end = time.perf_counter() + self._wait
        while not self._stop and len(self._q) < self._max:
            wait = end - time.perf_counter()
            dls = [r.dl for r in self._q if r.dl is not None]
            if dls:
                wait = min(wait, min(dls) - time.monotonic())
            if wait <= 0:
                _BATCH_FLUSH_TIMEOUT.inc()
                return
            self._cond.wait(wait)
        if len(self._q) >= self._max:
            _BATCH_FLUSH_FULL.inc()

    def _loop(self) -> None:  # wormlint: thread-entry
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait()
                if not self._q and self._stop:
                    return
                if (self._wait > 0 and len(self._q) < self._max
                        and not self._router._degrade.active()):
                    self._linger()
                batch = self._q[: self._max]
                del self._q[: self._max]
            if batch:
                self._router._score_round(batch)


class Router:
    """Thread-safe fan-out/merge client over a serving shard group."""

    def __init__(self, uris: List[str], scorer, sender: str = "router",
                 retry_deadline: Optional[float] = None,
                 resolver: Optional[Callable[[], Optional[List[str]]]] = None,
                 connect_deadline: float = 10.0,
                 mode: Optional[str] = None):
        self.scorer = scorer
        self.sender = sender
        self.resolver = resolver
        self.retry_deadline = (float(knob_value("WH_SERVE_RETRY_SEC"))
                               if retry_deadline is None
                               else float(retry_deadline))
        self.connect_deadline = connect_deadline
        self._lock = threading.Lock()
        self._uris = list(uris)  # wormlint: guarded-by(self._lock)
        self.world = len(uris)
        self._free: Dict[int, list] = {r: [] for r in range(self.world)}
        # pooled (sock, file) pairs for hedge backups: a hedge must ride
        # a DIFFERENT connection than the primary it insures (the win
        # path severs the primary's socket), but dialing fresh per
        # hedge costs more than the duplicate fetch itself — dedup is
        # keyed on the frame's (sender, seq), not the connection
        self._hedge_free: Dict[int, list] = {
            r: [] for r in range(self.world)}
        self._slot_ids = 0  # wormlint: guarded-by(self._lock)
        self._pool = ThreadPoolExecutor(
            max_workers=max(8, 2 * self.world),
            thread_name_prefix="serve-router")
        # overload machinery: hedged fetches (WH_HEDGE — None when off,
        # so the hot path pays one attribute check) and degraded-mode
        # serving under sustained SLO burn (WH_DEGRADE)
        self._hedge = _overload.hedge_tracker()
        self._hedge_timer = _HedgeTimer()
        self._degrade = _overload.DegradeController()
        # client-edge admission (WH_ADMIT_AIMD): overload queues form
        # HERE, ahead of any shard gate — bounce at entry so admitted
        # requests see bounded queueing instead of everyone expiring
        # mid-queue (see overload.router_gate)
        self._gate = _overload.router_gate()
        # one hello up front: table row counts drive the key split, and
        # a shard configured for a different world would shard-range
        # differently than this router splits
        # per-row-count shard boundary vectors for _split: the even
        # shard_range split depends only on (rows, world), so the
        # per-request python loop of searchsorted pairs collapses to
        # one cached boundary array + one vectorized searchsorted
        self._split_edges: Dict[int, np.ndarray] = {}
        # opt-in reply quantization (WH_SERVE_WIRE): stamped on every
        # fetch/score request header; a stamped shard bf16-truncates
        # its reply floats at send time, halving reply bytes under the
        # documented ulp contract (docs/serving.md). Default raw keeps
        # serving bit-identical to the trainer's own predict. An old
        # shard ignores the stamp and replies raw — the decode path is
        # per-array self-describing, so mixed groups still work.
        # Validated BEFORE dialing so a bad knob fails fast.
        sw = str(knob_value("WH_SERVE_WIRE") or "").strip().lower()
        if sw in ("", "raw", "off", "0"):
            sw = ""
        elif sw != "bf16":
            raise ValueError(
                f"unknown WH_SERVE_WIRE {sw!r} (expected 'raw' or 'bf16')")
        self.serve_wire = sw
        hello = self._rpc(0, {"op": "hello"}, {})[0]
        if int(hello["world"]) != self.world:
            raise RuntimeError(
                f"shard 0 serves world={hello['world']} but the router "
                f"was given {self.world} uris")
        self.full_rows = {k: int(v)
                          for k, v in hello["full_rows"].items()}
        # serving dataflow (WH_SERVE_MODE): 'score' fans partial-margin
        # work out to the shards through the micro-batcher; 'fetch' is
        # the row-shipping fallback; 'auto' takes the fast path when
        # the scorer implements a shard-local kernel
        mode = (str(knob_value("WH_SERVE_MODE"))
                if mode is None else str(mode))
        if mode == "auto":
            mode = ("score" if getattr(scorer, "score_kind", None)
                    else "fetch")
        if mode not in ("fetch", "score"):
            raise ValueError(f"unknown WH_SERVE_MODE {mode!r}")
        self.mode = mode
        self._batcher: Optional[_Batcher] = None
        if mode == "score":
            key_table = scorer.tables[0]
            self._score_edges = _fastpath.shard_edges(
                self.full_rows[key_table], self.world)
            self._batcher = _Batcher(
                self, int(knob_value("WH_SERVE_BATCH_MAX")),
                float(knob_value("WH_SERVE_BATCH_WAIT_MS")) / 1e3)

    @staticmethod
    def from_scheduler(client, scorer, world: int,
                       timeout: float = 60.0, **kw) -> "Router":
        """Build against a scheduler's registered ``--serve`` group; the
        resolver keeps following re-registrations (shard respawns)."""

        def resolve() -> Optional[List[str]]:
            try:
                got = client.call(op="serve_nodes", world=world)
                return got["uris"] if got.get("ready") else None
            except Exception:
                return None

        deadline = time.monotonic() + timeout
        uris = resolve()
        while not uris:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"serve group never fully registered ({world} shards)")
            time.sleep(0.2)
            uris = resolve()
        return Router(uris, scorer, resolver=resolve, **kw)

    # -- connection pool ----------------------------------------------------
    def _acquire(self, r: int) -> _Slot:
        with self._lock:
            if self._free[r]:
                return self._free[r].pop()
            self._slot_ids += 1
            return _Slot(f"{self.sender}:{r}:{self._slot_ids}")

    def _release(self, r: int, slot: _Slot) -> None:
        with self._lock:
            self._free[r].append(slot)

    def _dial(self, slot: _Slot, r: int) -> None:
        # short per-attempt deadline: a dead shard's old port must fail
        # fast so the outer retry loop re-consults the resolver (which
        # is where a respawned shard's NEW uri shows up) instead of
        # burning the whole budget dialing a port nobody listens on
        with self._lock:
            uri = self._uris[r]
        host, port = uri.rsplit(":", 1)
        slot.sock = connect_with_retry((host, int(port)),
                                       min(self.connect_deadline, 1.0))
        slot.f = slot.sock.makefile("rwb")

    def _refresh_uris(self) -> None:
        if self.resolver is None:
            return
        got = self.resolver()
        if got and len(got) == self.world:
            with self._lock:
                self._uris = list(got)

    # -- RPC ----------------------------------------------------------------
    def _send_recv(self, f, r: int, hdr: dict,
                   arrays: Dict[str, np.ndarray],
                   budget: Optional[_retrylib.RetryBudget] = None,
                   abandon_busy: bool = False) -> tuple[dict, dict]:
        """One send + reply on an established connection, resending the
        same seq-stamped frame through busy bounces. A hedge passes
        `abandon_busy`: a busy shard must not absorb EXTRA (backup)
        load, so the hedge gives up instead of backing off."""
        send_frame(f, hdr, arrays)
        while True:
            got = recv_frame(f)
            if got is None:
                raise ConnectionResetError(
                    f"serve shard {r} closed the connection")
            reply, rarr, _ = got
            if reply.get("busy") and abandon_busy:
                raise _HedgeAbandoned()
            if busy_backoff(reply, budget):
                # bounced before dispatch: resend the same seq-stamped
                # frame after the load-scaled, jittered hint
                send_frame(f, hdr, arrays)
                continue
            return reply, rarr

    def _attempt(self, slot: _Slot, r: int, hdr: dict,
                 arrays: Dict[str, np.ndarray],
                 budget: _retrylib.RetryBudget) -> tuple[dict, dict]:
        """One connected attempt, hedged for fetches when WH_HEDGE is
        on: the hedge scheduler fires after the rolling-quantile delay
        and — budget permitting — sends the SAME (sender, seq) frame on
        a fresh ephemeral connection. The shard's per-sender reply cache makes
        the duplicate exactly-once (whichever copy dispatches second is
        answered from the cache with the ORIGINAL bytes), so the hedge
        can never double-score. If the backup answers first it severs
        the pooled socket to unblock the primary's recv, and the
        primary's error path returns the backup's reply."""
        hedge = (self._hedge if hdr.get("op") in ("fetch", "score")
                 else None)
        delay = hedge.delay_s() if hedge is not None else None
        if delay is None:
            return self._send_recv(slot.f, r, hdr, arrays, budget)
        done = threading.Event()
        lock = threading.Lock()
        state: dict = {}

        def fire():  # wormlint: thread-entry
            if done.is_set() or not hedge.try_issue():
                return
            conn = None
            ok = False
            try:
                with self._lock:
                    uri = self._uris[r]
                    if self._hedge_free[r]:
                        conn = self._hedge_free[r].pop()
                if conn is None:
                    host, port = uri.rsplit(":", 1)
                    sock = connect_with_retry((host, int(port)), 1.0)
                    conn = (sock, sock.makefile("rwb"))
                got = self._send_recv(conn[1], r, hdr,
                                      arrays, abandon_busy=True)
                ok = True
                with lock:
                    if not done.is_set():
                        state["reply"] = got
                        # sever the pooled socket: the primary's
                        # blocked recv turns into the error path,
                        # which hands back this reply
                        if slot.sock is not None:
                            try:
                                slot.sock.shutdown(_socket.SHUT_RDWR)
                            except OSError:
                                pass
                        slot.close()
            except Exception:
                pass  # best-effort tail insurance; the primary decides
            finally:
                if conn is not None:
                    if ok:
                        with self._lock:
                            self._hedge_free[r].append(conn)
                    else:
                        try:
                            conn[0].close()
                        except OSError:
                            pass

        # the RPC itself runs on the router pool so a slow hedge never
        # delays OTHER due hedges on the scheduler thread; stale
        # entries (done already set) are dropped at fire time
        self._hedge_timer.arm(
            delay, lambda: self._pool.submit(fire), done)
        try:
            got = self._send_recv(slot.f, r, hdr, arrays, budget)
            with lock:
                done.set()
            return got
        except (OSError, ConnectionError):
            with lock:
                done.set()
                if "reply" in state:
                    hedge.won()
                    return state["reply"]
            raise

    def _rpc(self, r: int, header: dict,
             arrays: Dict[str, np.ndarray]) -> tuple[dict, dict]:
        slot = self._acquire(r)
        try:
            hdr = dict(header, sender=slot.sender, seq=slot.seq)
            slot.seq += 1
            budget = _retrylib.RetryBudget(max(self.retry_deadline, 0.0),
                                           base_s=0.1, op="serve.rpc")
            # the budget's window — tightened by any ambient request
            # deadline — rides every frame sent below as its `dl`
            with budget.bind():
                while True:
                    try:
                        if slot.f is None:
                            self._dial(slot, r)
                        t_req = time.perf_counter()
                        reply, rarr = self._attempt(slot, r, hdr, arrays,
                                                    budget)
                        if "error" in reply:
                            raise RuntimeError(
                                f"serve shard {r}: {reply['error']}")
                        if self._hedge is not None \
                                and hdr.get("op") in ("fetch", "score"):
                            self._hedge.observe(
                                time.perf_counter() - t_req)
                        budget.succeeded()
                        return reply, rarr
                    except (OSError, ConnectionError) as e:
                        slot.close()
                        if budget.expired:
                            budget.give_up(e)
                        _ROUTER_RETRIES.inc()
                        # a respawned shard re-registered under a new
                        # uri; the resolver hands it to the next dial
                        self._refresh_uris()
                        budget.sleep()
        finally:
            self._release(r, slot)

    # -- fan-out ------------------------------------------------------------
    def _split(self, keys: np.ndarray, rows: int) -> List[slice]:
        """Per-shard contiguous slices of a sorted key vector under the
        even split (keys are sorted, so each shard's keys are one run).
        The shard boundaries are a pure function of (rows, world) —
        cached, so each request pays ONE vectorized searchsorted."""
        edges = self._split_edges.get(rows)
        if edges is None:
            edges = np.asarray(
                [shard_range(rows, r, self.world)[0]
                 for r in range(self.world)] + [rows], np.int64)
            self._split_edges[rows] = edges
        cuts = np.searchsorted(keys, edges)
        return [slice(int(cuts[r]), int(cuts[r + 1]))
                for r in range(self.world)]

    def _rpc_traced(self, ctx, dl, r: int, header: dict,
                    arrays: Dict[str, np.ndarray]) -> tuple[dict, dict]:
        """Pool-thread RPC entry: rebind the request's trace context
        AND its deadline (executor threads don't inherit thread-locals)
        so the frame carries both over the wire and the shard's span
        links back."""
        with _overload.bind(dl):
            if ctx is None:
                return self._rpc(r, header, arrays)
            with _trace.bind(ctx):
                with _trace.request_span(
                        f"serve.rpc.{header.get('op', 'fetch')}",
                        cat="serve", shard=r):
                    return self._rpc(r, header, arrays)

    def _fanout(self, packed) -> tuple[list, list, int]:
        """One fetch round: returns (jobs, replies, model version) or
        raises on a mixed-version set (caller replays)."""
        tables = list(self.scorer.tables)
        splits = {t: self._split(packed.keys[t], self.full_rows[t])
                  for t in tables}
        jobs = []  # (rank, tables present, key arrays)
        for r in range(self.world):
            present = [t for t in tables
                       if splits[t][r].stop > splits[t][r].start]
            if not present:
                continue
            arrays = {f"k:{t}": packed.keys[t][splits[t][r]]
                      for t in present}
            jobs.append((r, present, arrays))
        ctx = _trace.current_ctx()
        dl = _overload.current()
        base = {"op": "fetch"}
        if self.serve_wire:
            base["wire"] = self.serve_wire
        futs = [self._pool.submit(
            self._rpc_traced, ctx, dl, r,
            dict(base, tables=present), arrays)
            for r, present, arrays in jobs]
        got = [f.result() for f in futs]
        versions = {int(reply["version"]) for reply, _ in got}
        if len(versions) > 1:
            raise _MixedVersions(versions, jobs, got)
        return jobs, got, versions.pop()

    def _merge(self, jobs: list, got: list) -> Dict[str, np.ndarray]:
        """Reassemble per-shard row pieces into each table's compact
        rows (shard order == key order, so concatenation suffices)."""
        pieces: Dict[str, list] = {t: [] for t in self.scorer.tables}
        for (_, present, _), (_, rarr) in zip(jobs, got):
            for t in present:
                pieces[t].append(np.asarray(rarr[f"r:{t}"]))
        return {t: (p[0] if len(p) == 1 else np.concatenate(p))
                for t, p in pieces.items()}

    def predict_block(self, blk) -> tuple[np.ndarray, int]:
        """Score one RowBlock; returns (scores[:size], model version).
        Outside degraded mode the scores are guaranteed to come from
        ONE snapshot version (use `predict_block_ex` to see the
        degraded stamp)."""
        scores, version, _ = self.predict_block_ex(blk)
        return scores, version

    def predict_block_ex(self, blk) -> tuple[np.ndarray, int, dict]:
        """`predict_block` plus the reply metadata: ``degraded`` (1 =
        bounded-staleness mixed-version scores served under sustained
        SLO burn, stamped per the overload contract) and, when
        degraded, the ``versions`` the rows spanned."""
        ctx = _trace.start_request()
        # default per-request deadline (WH_DEADLINE_MS): bound only
        # when the caller didn't bind one — an explicit caller budget
        # always wins
        dl_ms = float(knob_value("WH_DEADLINE_MS"))
        dl_cm = (_overload.bind_in(dl_ms / 1e3)
                 if dl_ms > 0 and _overload.current() is None
                 else _overload.bind(None))
        with dl_cm, _trace.bind(ctx):
            # already-expired budget: shed before paying for pack or
            # fan-out — the shards would only bounce it at dispatch
            rem = _overload.remaining()
            if (rem is not None and rem <= 0
                    and knob_value("WH_DEADLINE_SHED")):
                _SHED_DEADLINE.inc()
                raise _overload.Shed(
                    "deadline expired before router fan-out")
            gate = self._gate
            if gate is not None and not gate.try_enter("predict"):
                raise _overload.Shed(
                    f"router admission: saturated "
                    f"(limit {gate.limit}, {gate.inflight} in flight)")
            t0 = time.perf_counter()
            try:
                with _trace.request_span("serve.request", cat="serve"):
                    if self._batcher is not None:
                        return self._predict_score(blk)
                    return self._predict_block(blk)
            finally:
                if gate is not None:
                    gate.leave("predict", time.perf_counter() - t0)

    def _predict_block(self, blk) -> tuple[np.ndarray, int, dict]:
        t0 = time.perf_counter()
        packed = self.scorer.pack(blk)
        _STAGE_PACK_S.observe(time.perf_counter() - t0)
        meta = {"degraded": 0}
        try:
            # fan-out is timed from the FIRST attempt: a hot swap
            # landing mid-round costs a full replay plus backoff, and
            # that burned budget must land in a stage or the
            # explained_frac identity (sum of stage means == latency
            # mean) breaks for every request in a swap window
            tf0 = time.perf_counter()
            for attempt in range(_EPOCH_REPLAYS):
                try:
                    with _trace.request_span("serve.stage.fanout",
                                             cat="serve"):
                        jobs, got, version = self._fanout(packed)
                except _MixedVersions as mv:
                    _EPOCH_RETRIES.inc()
                    # replays burn latency budget; they feed the burn
                    # window that arms degraded mode
                    self._degrade.observe_replay()
                    if self._degrade.active():
                        # degraded mode: stop paying for strict version
                        # consistency — serve the mixed-version rows we
                        # already hold, stamped so the caller knows
                        jobs, got = mv.jobs, mv.got
                        version = max(mv.versions)
                        meta = {"degraded": 1,
                                "versions": sorted(mv.versions)}
                        self._degrade.served_degraded()
                    else:
                        # a hot swap landed mid-fan-out; replay against
                        # the (now uniform) new version. Shard watchers
                        # can be skewed by up to their poll interval,
                        # so back off exponentially until the replays
                        # span at least one full WH_SERVE_POLL_SEC —
                        # immediate replays would all burn inside the
                        # skew window
                        poll = float(knob_value("WH_SERVE_POLL_SEC"))
                        time.sleep(min(0.01 * (2 ** attempt),
                                       max(poll, 0.01)))
                        continue
                fanout = time.perf_counter() - tf0
                # wire share = fan-out wall minus the slowest shard's
                # own (queue + serve) time, which replies carry back
                slowest = max(
                    (float(r.get("served_s", 0.0))
                     + float(r.get("queue_s", 0.0)) for r, _ in got),
                    default=0.0)
                queued = max((float(r.get("queue_s", 0.0))
                              for r, _ in got), default=0.0)
                _STAGE_FANOUT_S.observe(fanout)
                _STAGE_WIRE_S.observe(max(fanout - slowest, 0.0))
                _STAGE_QUEUE_S.observe(queued)
                tm0 = time.perf_counter()
                with _trace.request_span("serve.stage.sum", cat="serve"):
                    rows = self._merge(jobs, got)
                _STAGE_SUM_S.observe(time.perf_counter() - tm0)
                ts0 = time.perf_counter()
                scores = self.scorer.score(packed, rows)
                _STAGE_SCORE_S.observe(time.perf_counter() - ts0)
                _ROUTER_REQUESTS.inc()
                lat = time.perf_counter() - t0
                _LATENCY_S.observe(lat)
                self._degrade.observe(lat)
                return scores, version, meta
            raise RuntimeError(
                f"shard versions never agreed after {_EPOCH_REPLAYS} "
                "fan-out replays")
        except Exception:
            _FAILURES.inc()
            raise

    # -- score fast path ----------------------------------------------------
    def _predict_score(self, blk) -> tuple[np.ndarray, int, dict]:
        """Score-mode entry: pack on the caller thread (cheap — live
        COO entries only), park in the micro-batcher, and block until
        the round that carried this request completes."""
        t0 = time.perf_counter()
        try:
            pack = self.scorer.pack_score(blk)
        except Exception:
            _FAILURES.inc()  # round failures are counted by the round
            raise
        _STAGE_PACK_S.observe(time.perf_counter() - t0)
        req = _BatchReq(pack, _trace.current_ctx(), _overload.current(),
                        t0)
        return self._batcher.submit(req)

    def _score_fanout(self, pack) -> tuple[list, list, int]:
        """One score round's fan-out: partition the round pack's
        entries by owning shard, issue one ``score`` RPC per non-empty
        shard, and check the replies came from ONE model version.
        Returns (jobs, replies, version); jobs carry the permutation
        needed to scatter the partial products back."""
        order, counts = _fastpath.partition(pack.idx, self._score_edges)
        if order is None:
            si, sv, ss = pack.idx, pack.val, pack.seg
        else:
            si, sv, ss = pack.idx[order], pack.val[order], pack.seg[order]
        starts = np.concatenate(([0], np.cumsum(counts)))
        hdr = {"op": "score", "kind": self.scorer.score_kind,
               "rows": pack.rows, **self.scorer.score_header()}
        if self.serve_wire:
            hdr["wire"] = self.serve_wire
        difacto = self.scorer.score_kind == "difacto"
        jobs = []  # (rank, payload arrays)
        for r in range(self.world):
            a, b = int(starts[r]), int(starts[r + 1])
            if a == b:
                continue
            arrays = {"i": si[a:b], "v": sv[a:b]}
            if difacto:
                arrays["s"] = ss[a:b]
            jobs.append((r, arrays))
        if not jobs:
            # a zero-nnz round still needs a version to stamp: shard 0
            # scores an empty payload (all folds come back zero)
            jobs = [(0, {"i": si[:0], "v": sv[:0]}
                     if not difacto else
                     {"i": si[:0], "v": sv[:0], "s": ss[:0]})]
        ctx = _trace.current_ctx()
        dl = _overload.current()
        futs = [self._pool.submit(self._rpc_traced, ctx, dl, r,
                                  dict(hdr), arrays)
                for r, arrays in jobs]
        got = [f.result() for f in futs]
        versions = {int(reply["version"]) for reply, _ in got}
        if len(versions) > 1:
            raise _MixedVersions(versions, (jobs, order), got)
        return (jobs, order), got, versions.pop()

    def _score_assemble(self, pack, cuts, jobs_order, got):
        """Scatter the per-shard partial products back into original
        nonzero order, fold per row, and slice per micro-batch member.
        The fold is the bitwise mirror of the trainer's segment_sum
        (serving/fastpath.py docstring)."""
        jobs, order = jobs_order
        parts = [np.asarray(rarr["p"]) for _, rarr in got]
        prod = _fastpath.restore_order(len(pack.idx), order, parts)
        extras = {}
        if self.scorer.score_kind == "difacto":
            # cross-shard reassociation point of the documented ulp
            # contract: per-shard [rows, k] partials summed rank-major
            xv = np.asarray(got[0][1]["xv"]).copy()
            x2 = np.asarray(got[0][1]["x2"]).copy()
            for _, rarr in got[1:]:
                xv += np.asarray(rarr["xv"])
                x2 += np.asarray(rarr["x2"])
            extras = {"xv": xv, "x2": x2}
        scores = self.scorer.finalize(pack, prod, extras)
        return [scores[cuts[m]: cuts[m + 1]]
                for m in range(len(cuts) - 1)]

    def _score_round(self, batch: List[_BatchReq]) -> None:
        """Execute one coalesced fan-out on the batcher thread and
        complete every member. Runs the same replay/degrade loop as
        the fetch path: a hot swap landing mid-fan-out replays the
        round; under sustained burn the mixed partials are served
        stamped degraded (summing partials across versions is exactly
        the bounded-staleness contract mixed fetched rows have)."""
        now = time.perf_counter()
        _BATCH_ROUNDS.inc()
        _BATCH_SIZE.observe(len(batch))
        if len(batch) > 1:
            _BATCH_COALESCED.inc(len(batch) - 1)
        for m in batch:
            _STAGE_BATCH_WAIT_S.observe(now - m.t_enq)
        dls = [m.dl for m in batch]
        dl = None if any(d is None for d in dls) else max(dls)
        ctx = next((m.ctx for m in batch if m.ctx is not None), None)
        try:
            with _overload.bind(dl), (
                    _trace.bind(ctx) if ctx is not None
                    else contextlib.nullcontext()):
                self._score_round_bound(batch)
        except BaseException as e:
            for m in batch:
                _FAILURES.inc()
                m.error = e
                m.done.set()

    def _score_round_bound(self, batch) -> None:
        # the fanout stage covers everything from round assembly to
        # the last reply of the attempt that SUCCEEDED: concat,
        # partition, the RPCs, and any mixed-version replays plus
        # their backoff. All of it is real per-member wall time, and
        # an unattributed stage is exactly what the explained_frac
        # gate exists to catch
        tf0 = time.perf_counter()
        pack, cuts = _fastpath.concat_packs([m.pack for m in batch])
        for attempt in range(_EPOCH_REPLAYS):
            meta = {"degraded": 0}
            try:
                with _trace.request_span("serve.stage.fanout",
                                         cat="serve"):
                    jobs_order, got, version = self._score_fanout(pack)
            except _MixedVersions as mv:
                _EPOCH_RETRIES.inc()
                self._degrade.observe_replay()
                if self._degrade.active():
                    jobs_order, got = mv.jobs, mv.got
                    version = max(mv.versions)
                    meta = {"degraded": 1,
                            "versions": sorted(mv.versions)}
                    self._degrade.served_degraded()
                else:
                    poll = float(knob_value("WH_SERVE_POLL_SEC"))
                    time.sleep(min(0.01 * (2 ** attempt),
                                   max(poll, 0.01)))
                    continue
            fanout = time.perf_counter() - tf0
            slowest = max(
                (float(r.get("served_s", 0.0))
                 + float(r.get("queue_s", 0.0)) for r, _ in got),
                default=0.0)
            queued = max((float(r.get("queue_s", 0.0))
                          for r, _ in got), default=0.0)
            partial = max((float(r.get("served_s", 0.0))
                           for r, _ in got), default=0.0)
            # stage histograms are per-REQUEST distributions, like
            # serve.latency_s: a round's stage time is observed once
            # per member. Round-weighted means would understate the
            # member-weighted time whenever big rounds are slow rounds
            # (they are — queue buildup grows both together), breaking
            # the explained_frac identity
            wire = max(fanout - slowest, 0.0)
            for _ in batch:
                _STAGE_FANOUT_S.observe(fanout)
                _STAGE_WIRE_S.observe(wire)
                _STAGE_QUEUE_S.observe(queued)
                _STAGE_PARTIAL_S.observe(partial)
            tm0 = time.perf_counter()
            with _trace.request_span("serve.stage.sum", cat="serve"):
                per_member = self._score_assemble(pack, cuts,
                                                  jobs_order, got)
            dt_sum = time.perf_counter() - tm0
            for _ in batch:
                _STAGE_SUM_S.observe(dt_sum)
            now = time.perf_counter()
            for m, scores in zip(batch, per_member):
                _ROUTER_REQUESTS.inc()
                lat = now - m.t0
                _LATENCY_S.observe(lat)
                self._degrade.observe(lat)
                m.scores = scores
                m.version = version
                m.meta = meta
                m.done.set()
            return
        raise RuntimeError(
            f"shard versions never agreed after {_EPOCH_REPLAYS} "
            "fan-out replays")

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
        self._hedge_timer.close()
        self._pool.shutdown(wait=False)
        with self._lock:
            slots = [s for free in self._free.values() for s in free]
            for free in self._free.values():
                free.clear()
            hconns = [c for free in self._hedge_free.values()
                      for c in free]
            for free in self._hedge_free.values():
                free.clear()
        for s in slots:
            s.close()
        for sock, _ in hconns:
            try:
                sock.close()
            except OSError:
                pass


class _MixedVersions(Exception):
    """Fan-out replies spanned a hot swap. Internal replay signal that
    carries the mixed payload, so degraded mode can serve it as a
    bounded-staleness reply instead of discarding the round."""

    def __init__(self, versions: set, jobs: list, got: list):
        super().__init__(f"mixed shard versions {sorted(versions)}")
        self.versions = versions
        self.jobs = jobs
        self.got = got


class _HedgeAbandoned(Exception):
    """A hedge met a busy shard and gave up (a backup request must
    never add load a primary would have backed off from)."""
