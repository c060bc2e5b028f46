"""Native fault-tolerant BSP allreduce/broadcast over the frame protocol.

The port's copy of the JAX package's runtime/allreduce.py, renamed to
this package and sharing nothing with it. Its frames go through the
port's runtime/net.py, the JAX package's byte for byte, so port ranks and
JAX ranks can form one ring. It is host code (sockets, threads, numpy):
a learner hands it numpy arrays and its threads make no torch call.

This is the second Wormhole comm stack from PAPER.md's layer map: the
rabit-style synchronous collective runtime, sibling to the async PS
plane (runtime/ps_server.py). The design reproduces rabit's recovery
semantics on top of this repo's own pieces — `runtime/net.py` frames for
the data plane, the tracker (`runtime/tracker.py`) for rendezvous, and
the launcher's respawn supervision for process resurrection:

- **Ring allreduce via mailbox RPC.** Every worker runs a small frame
  server (the ps_server handler idiom). One ring step = a `bsp_step`
  frame PUSHED to the successor's server; the handler deposits the chunk
  into a mailbox keyed (gen, version, seq, step) and acks immediately —
  handlers never block on other ranks, so the RPC graph cannot deadlock.
  The main loop sends to its successor then waits on its own mailbox for
  the predecessor's chunk. Reduce-scatter then allgather, 2(W-1) steps,
  with a FIXED accumulation order (local-then-incoming at each hop) so a
  replayed round is bit-identical.

- **(version, counter) sequencing, rabit-style.** Every collective
  consumes one monotone counter; `checkpoint()` bumps the version and
  resets the counter to 0. Completed results are cached per
  (version, counter) — and only completed results, written BEFORE the
  counter advances, so a peer observing `next > wanted` can rely on
  cached-or-pruned. `checkpoint()` prunes versions `< current - 1`:
  since no collective can complete without every rank, live skew is at
  most one version.

- **Recovery.** A dead worker is respawned by the launcher (with
  WH_RESTORE_EPOCH bumped), re-registers with the tracker under a new
  URI, which bumps the group **generation**. Survivors blocked mid-round
  time out on a mailbox wait, observe the gen bump, abort the round and
  retry it at the new gen — but FETCH-FIRST: a survivor one step ahead
  may already hold the completed result (adjacent ranks can differ by
  one step at the instant of a crash), and re-running a round some rank
  completed would deadlock. The respawned worker loads its own
  version-stamped checkpoint, replays its post-checkpoint collectives by
  fetching peers' cached results (bit-identical, no re-reduction), and
  falls back into the live ring once fetches miss everywhere.

- **Wire codec (WH_WIRE).** Reduce-scatter chunk sends are quantized
  STATELESSLY per chunk (bf16/int8/int4, per-64-element group scales —
  a pure function of the chunk values, never of round history): cross-round EF state
  cannot survive the fetch-replay contract, because a respawned rank
  replays completed rounds from peers' result caches without advancing
  any residuals while survivors' would have advanced. The allgather
  phase always ships bf16 — bf16 rounding is IDEMPOTENT, so after the
  owning rank self-rounds its reduced chunk once, every forwarding hop
  re-encodes the same 16 bits and all ranks reconstruct bit-identical
  results; recovered runs therefore stay bit-identical to fault-free
  runs with the codec on. Chunks below _WIRE_MIN_ELEMS (solver-loss
  scalars, small vectors) stay raw f32.

Knobs (declared in config.py, group "bsp"): WH_BSP_STEP_TIMEOUT bounds
one mailbox wait before re-polling the tracker generation;
WH_BSP_RETRY_SEC bounds how long a blocked collective waits overall for
a dead peer's respawn before failing the job. WH_WIRE (group "ps")
selects the chunk encoding above.
"""

from __future__ import annotations

import os
import socket
import socketserver
import threading
import time
from typing import Callable, Optional

import numpy as np

from wormhole_tpu_torch.config import knob_value
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.obs import trace as _trace
from wormhole_tpu_torch.runtime import faults
from wormhole_tpu_torch.runtime import retry as _retrylib
from wormhole_tpu_torch.runtime.net import (connect_with_retry,
                                            quantize_rows, recv_frame,
                                            send_frame)

_ROUNDS = _obs.REGISTRY.counter("bsp.rounds")
_RING_RETRIES = _obs.REGISTRY.counter("bsp.ring_retries")
_FETCHES = _obs.REGISTRY.counter("bsp.result_fetches")
_CHECKPOINTS = _obs.REGISTRY.counter("bsp.checkpoints")
_CKPT_BYTES = _obs.REGISTRY.counter("bsp.checkpoint_bytes")
_ALLREDUCE_S = _obs.REGISTRY.histogram("bsp.allreduce_s")
_CKPT_S = _obs.REGISTRY.histogram("bsp.checkpoint_s")

_OPS: dict[str, Callable] = {"sum": np.add, "max": np.maximum,
                             "min": np.minimum}

# chunks smaller than this ship raw f32: quantizing a solver-loss
# scalar would be all error and no savings (headers dominate anyway)
_WIRE_MIN_ELEMS = 1024


class _RoundAbort(Exception):
    """The group generation changed mid-round: membership rolled, every
    in-flight step of the old generation is void."""


class _BspHandler(socketserver.StreamRequestHandler):
    def handle(self):
        self.connection.setsockopt(socket.IPPROTO_TCP,
                                   socket.TCP_NODELAY, 1)
        worker = self.server.worker  # type: ignore
        with worker._conns_lock:
            worker._srv_conns.add(self.connection)
        try:
            self._serve(worker)
        except (OSError, ValueError):
            pass  # peer vanished mid-frame; it will reconnect or respawn
        finally:
            with worker._conns_lock:
                worker._srv_conns.discard(self.connection)

    def _serve(self, worker):
        while True:
            got = recv_frame(self.rfile)
            if got is None:
                return
            header, arrays, _ = got
            # a sampled BSP round's trace context rides bsp_step/fetch
            # frames; adopting it stitches this peer's handler work
            # under the initiating rank's round span
            with _trace.bind_wire(header):
                with _trace.request_span(
                        f"bsp.peer.{header.get('op')}", cat="bsp",
                        rank=worker.rank):
                    resp = worker._handle(header, arrays)
            send_frame(self.wfile, *resp)


class _BspServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class BspWorker:
    """One member of a tracker-coordinated BSP allreduce group.

    All collective entry points (`allreduce`, `broadcast`, `checkpoint`)
    are called from the worker's MAIN thread only; the embedded frame
    server's handler threads touch just the mailbox and the result cache
    (both lock-guarded).

    Constructor arguments are explicit (no env reads beyond knob
    defaults) so in-process tests can stand up a group without a
    launcher."""

    def __init__(self, rank: int, world: int, client,
                 snapshot_dir: Optional[str] = None,
                 host: str = "127.0.0.1",
                 step_timeout: Optional[float] = None,
                 retry_sec: Optional[float] = None,
                 wire: Optional[str] = None):
        self.rank = int(rank)
        self.world = int(world)
        self.client = client
        self.snapshot_dir = snapshot_dir or os.environ.get(
            "WH_SNAPSHOT_DIR") or None
        self.step_timeout = (step_timeout if step_timeout is not None
                             else knob_value("WH_BSP_STEP_TIMEOUT"))
        self.retry_sec = (retry_sec if retry_sec is not None
                          else knob_value("WH_BSP_RETRY_SEC"))
        # chunk wire encoding (WH_WIRE; see the module docstring for
        # why the BSP plane quantizes statelessly and allgathers bf16)
        w = (wire if wire is not None
             else os.environ.get("WH_WIRE") or "raw").strip().lower()
        self.wire_enc = w if w in ("bf16", "int8", "int4") else "raw"
        self.version = 0   # checkpoints completed
        self.seq = 0       # next collective's counter within the version
        self.gen = 0       # group membership generation (tracker-owned)
        self._uris: list[str] = []
        # replaying after load_checkpoint / a ring retry. A respawned
        # incarnation (WH_RESTORE_EPOCH > 0) starts behind even when it
        # died BEFORE its first checkpoint: version-0 results are still
        # in the survivors' caches (nothing pruned them), and ringing
        # seq 0 against survivors blocked at a later seq would deadlock.
        self._behind = int(os.environ.get("WH_RESTORE_EPOCH", "0")
                           or 0) > 0
        # mailbox: (gen, version, seq, step) -> chunk, deposited by
        # handler threads, consumed by the main loop
        self._mail: dict[tuple, np.ndarray] = {}
        self._mail_cv = threading.Condition()
        # completed collective results, (version, seq) -> array
        self._results: dict[tuple[int, int], np.ndarray] = {}
        self._results_lock = threading.Lock()
        self._conns: dict[int, object] = {}  # rank -> socket file (ours)
        self._srv_conns: set = set()         # accepted peer connections
        self._conns_lock = threading.Lock()
        self._closed = False
        self._srv = _BspServer((host, 0), _BspHandler)
        self._srv.worker = self  # type: ignore
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()
        h, p = self._srv.server_address[:2]
        self.uri = f"{h}:{p}"
        r = self.client.call(op="register_bsp", rank=self.rank,
                             world=self.world, uri=self.uri)
        self.gen = int(r.get("gen", 0))
        self._wait_group()

    # -- group membership ---------------------------------------------------
    def _wait_group(self) -> None:
        deadline = time.monotonic() + self.retry_sec
        while True:
            r = self.client.call(op="bsp_peers", world=self.world)
            if r["ready"]:
                self._adopt(int(r["gen"]), list(r["uris"]))
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"bsp group never reached {self.world} workers "
                    f"({r.get('num_known')} known)")
            time.sleep(0.1)

    def _adopt(self, gen: int, uris: list[str]) -> None:
        """Switch to a new membership generation: drop cached peer
        connections and every mailbox entry of an older generation.
        ELASTIC membership makes the peer list authoritative — a grown
        or shrunk group re-indexes the ring by list position, so world
        and rank follow the list (chunk boundaries are functions of
        (shape, world, rank), so the rebuilt ring is deterministic for
        the new set). A worker absent from the list has been retired or
        evicted; it keeps its old identity just long enough to exit."""
        self._uris = uris
        # re-index BEFORE the same-gen early return: an elastic joiner
        # learns its (already-bumped) gen from register_bsp's reply, so
        # its first _wait_group adopt arrives gen-equal but still needs
        # the authoritative world/rank
        if self.uri in uris and (len(uris) != self.world
                                 or uris.index(self.uri) != self.rank):
            old_r, old_w = self.rank, self.world
            self.world = len(uris)
            self.rank = uris.index(self.uri)
            print(f"[bsp] ring rebuilt at gen {gen}: rank/world "
                  f"{old_r}/{old_w} -> {self.rank}/{self.world}",
                  flush=True)
        if gen == self.gen:
            return
        self.gen = gen
        with self._conns_lock:
            conns, self._conns = dict(self._conns), {}
        for f in conns.values():
            try:
                f.close()
            except OSError:
                pass
        with self._mail_cv:
            for k in [k for k in self._mail if k[0] < gen]:
                del self._mail[k]

    def _poll_gen(self) -> bool:
        """Re-read the tracker's membership; True if the generation
        advanced (the signal that a peer died and respawned)."""
        try:
            r = self.client.call(op="bsp_peers", world=self.world)
        except OSError:
            return False
        if r["ready"] and int(r["gen"]) > self.gen:
            self._adopt(int(r["gen"]), list(r["uris"]))
            return True
        return False

    # -- frame server side --------------------------------------------------
    def _handle(self, header: dict, arrays: dict):
        op = header.get("op")
        if op == "bsp_step":
            key = (int(header["gen"]), int(header["ver"]),
                   int(header["seq"]), int(header["t"]))
            with self._mail_cv:
                self._mail[key] = arrays["x"]
                self._mail_cv.notify_all()
            return {"op": "ok"}, None
        if op == "bsp_fetch":
            want = (int(header["ver"]), int(header["seq"]))
            with self._results_lock:
                got = self._results.get(want)
            if got is not None:
                _FETCHES.inc()
                return ({"op": "ok", "hit": True,
                         "next": [self.version, self.seq]}, {"x": got})
            return ({"op": "ok", "hit": False,
                     "next": [self.version, self.seq]}, None)
        return {"op": "error", "error": f"unknown bsp op {op!r}"}, None

    # -- peer RPC -----------------------------------------------------------
    def _peer_file(self, rank: int):
        with self._conns_lock:
            f = self._conns.get(rank)
        if f is None:
            host, port = self._uris[rank].rsplit(":", 1)
            sock = connect_with_retry((host, int(port)),
                                      deadline_s=self.step_timeout,
                                      timeout=self.retry_sec)
            f = sock.makefile("rwb")
            with self._conns_lock:
                self._conns[rank] = f
        return f

    def _rpc(self, rank: int, header: dict, arrays=None):
        """One request/response frame to a peer's server. Any failure
        poisons the cached connection (a partial frame corrupts the
        stream), so it is dropped before the error propagates."""
        f = self._peer_file(rank)
        try:
            send_frame(f, header, arrays)
            got = recv_frame(f)
        except OSError:
            self._drop_conn(rank, f)
            raise
        if got is None:
            self._drop_conn(rank, f)
            raise ConnectionResetError(f"bsp peer {rank} closed mid-rpc")
        return got[0], got[1]

    def _drop_conn(self, rank: int, f) -> None:
        with self._conns_lock:
            if self._conns.get(rank) is f:
                del self._conns[rank]
        try:
            f.close()
        except OSError:
            pass

    # -- ring ----------------------------------------------------------------
    def _send_step(self, to: int, gen: int, key: tuple[int, int],
                   t: int, chunk, deadline: float) -> None:
        # `chunk` is an ndarray or a pre-quantized net.QuantRows; every
        # retry re-sends the SAME object, so the bytes never vary
        header = {"op": "bsp_step", "gen": gen, "ver": key[0],
                  "seq": key[1], "t": t, "src": self.rank}
        pace = min(0.2, self.step_timeout)
        budget = _retrylib.RetryBudget(
            max(deadline - time.monotonic(), 0.0),
            base_s=pace, cap_s=pace, op="bsp.step")
        while True:
            try:
                self._rpc(to, header, {"x": chunk})
                budget.succeeded()
                return
            except OSError:
                # successor unreachable: either transient or it died. A
                # death surfaces as a generation bump once its respawn
                # (or the survivors' shrunk ring) re-registers; until
                # then keep retrying within budget.
                if self._poll_gen():
                    raise _RoundAbort()
                if budget.expired:
                    budget.give_up(TimeoutError(
                        f"bsp rank {self.rank}: peer {to} unreachable for "
                        f"{self.retry_sec:.0f}s (step {t} of {key})"))
                budget.sleep()

    def _wait_step(self, gen: int, key: tuple[int, int], t: int,
                   deadline: float) -> np.ndarray:
        mkey = (gen, key[0], key[1], t)
        while True:
            with self._mail_cv:
                got = self._mail.pop(mkey, None)
                if got is None:
                    self._mail_cv.wait(self.step_timeout)
                    got = self._mail.pop(mkey, None)
            if got is not None:
                return got
            if self._poll_gen():
                raise _RoundAbort()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"bsp rank {self.rank}: no step {t} of {key} from "
                    f"predecessor within {self.retry_sec:.0f}s")

    def _wire_rs(self, chunk: np.ndarray):
        """Reduce-scatter wire form of a chunk: the configured encoding
        with grouped scales — a pure function of the chunk values, so a
        retried round re-sends identical bytes. Small chunks stay raw."""
        if self.wire_enc == "raw" or chunk.size < _WIRE_MIN_ELEMS:
            return chunk
        return quantize_rows(chunk, self.wire_enc)

    def _wire_ag(self, chunk: np.ndarray):
        """Allgather wire form: always bf16 when the codec is on. bf16
        rounding is idempotent, so every forwarding hop re-encodes the
        same 16 bits and all ranks reconstruct identical values."""
        if self.wire_enc == "raw" or chunk.size < _WIRE_MIN_ELEMS:
            return chunk
        return quantize_rows(chunk, "bf16")

    def _ring_round(self, key: tuple[int, int], flat: np.ndarray,
                    combine: Callable) -> np.ndarray:
        """One ring reduce-scatter + allgather at the current generation.
        Chunk boundaries (np.array_split) and the local-then-incoming
        accumulation order are functions of (shape, world, rank) only, so
        any retry or replay reproduces the result bit-for-bit. With the
        wire codec on, the rank that finishes reducing a chunk rounds
        its OWN copy to bf16 before the allgather — the same values
        every other rank will decode off the wire — so the concatenated
        result is bit-identical on all ranks."""
        gen0 = self.gen
        w, r = self.world, self.rank
        chunks = list(np.array_split(flat, w))
        succ = (r + 1) % w
        deadline = time.monotonic() + self.retry_sec
        for t in range(w - 1):  # reduce-scatter
            si = (r - t) % w
            ri = (r - t - 1) % w
            self._send_step(succ, gen0, key, t, self._wire_rs(chunks[si]),
                            deadline)
            got = self._wait_step(gen0, key, t, deadline)
            chunks[ri] = combine(chunks[ri], got)
        own = (r + 1) % w  # the chunk this rank finished reducing
        if (self.wire_enc != "raw"
                and chunks[own].size >= _WIRE_MIN_ELEMS):
            chunks[own] = quantize_rows(chunks[own], "bf16").dequant()
        for t in range(w - 1):  # allgather
            si = (r + 1 - t) % w
            ri = (r - t) % w
            self._send_step(succ, gen0, key, w - 1 + t,
                            self._wire_ag(chunks[si]), deadline)
            chunks[ri] = self._wait_step(gen0, key, w - 1 + t, deadline)
        return np.concatenate(chunks)

    # -- replay fetch --------------------------------------------------------
    def _fetch_result(self, key: tuple[int, int]) -> Optional[np.ndarray]:
        """Ask every peer for the cached result of `key`. Returns the
        array on a hit; None when the group provably has not completed
        `key` yet (we are live — join the ring). Peers whose counter is
        PAST `key` but miss the cache mean the window was pruned: the
        group ran a full version ahead while we were gone, which the
        checkpoint protocol rules out for any recoverable death."""
        ahead = False
        reached = 0
        for peer in range(self.world):
            if peer == self.rank:
                continue
            try:
                h, arrs = self._rpc(peer, {"op": "bsp_fetch",
                                           "ver": key[0], "seq": key[1]})
            except OSError:
                continue
            reached += 1
            if h.get("hit"):
                return np.array(arrs["x"])  # own writable copy
            if tuple(h.get("next", (0, 0))) > key:
                ahead = True
        if ahead:
            raise RuntimeError(
                f"bsp rank {self.rank}: result {key} was pruned by peers "
                "(recovery window is one version)")
        if reached == 0 and self.world > 1:
            raise ConnectionError("no bsp peer reachable for replay fetch")
        return None

    def _collective(self, key: tuple[int, int], flat: np.ndarray,
                    combine: Callable) -> np.ndarray:
        attempt_fetch = self._behind
        pace = min(0.2, self.step_timeout)
        budget = _retrylib.RetryBudget(self.retry_sec, base_s=pace,
                                       cap_s=pace, op="bsp.fetch")
        while True:
            if attempt_fetch:
                try:
                    got = self._fetch_result(key)
                except ConnectionError as e:
                    if budget.expired:
                        budget.give_up(e)
                    budget.sleep()
                    self._poll_gen()
                    continue
                if got is not None:
                    return got
                self._behind = False  # caught up: this round is live
            if self.world == 1:
                return flat.copy()
            try:
                return self._ring_round(key, flat, combine)
            except _RoundAbort:
                # membership rolled mid-round. Fetch-first on retry: a
                # survivor one step ahead may have completed this round,
                # and re-ringing a completed round would deadlock.
                _RING_RETRIES.inc()
                attempt_fetch = True
                budget = _retrylib.RetryBudget(self.retry_sec, base_s=pace,
                                               cap_s=pace, op="bsp.fetch")

    # -- public API ----------------------------------------------------------
    def allreduce(self, x, op: str = "sum") -> np.ndarray:
        """Reduce `x` elementwise across the group; every rank returns
        the bit-identical reduced array (float32 on the wire)."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.worker_op("allreduce")
        t0 = time.perf_counter()
        # asarray, not ascontiguousarray: the latter promotes 0-d to 1-d
        # and solver scalars (raw losses) must round-trip shape ()
        x = np.asarray(x, np.float32)
        key = (self.version, self.seq)
        with _trace.bind(_trace.start_request()), \
                _trace.request_span("bsp.round", cat="bsp",
                                    ver=key[0], seq=key[1]):
            out = self._collective(key, np.ascontiguousarray(x.ravel()),
                                   _OPS[op]).reshape(x.shape)
        with self._results_lock:
            self._results[key] = out
        self.seq += 1  # AFTER the cache write: next>key implies cached
        _ROUNDS.inc()
        _ALLREDUCE_S.observe(time.perf_counter() - t0)
        return out

    def broadcast(self, x, root: int = 0) -> np.ndarray:
        """Every rank returns root's array. Consumes one counter of the
        same (version, seq) sequence as allreduce, so it replays the
        same way: non-roots fetch the value from root's result cache."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.worker_op("broadcast")
        key = (self.version, self.seq)
        if self.rank == root:
            out = np.ascontiguousarray(
                np.asarray(x, np.float32).ravel()).reshape(np.shape(x))
        else:
            pace = min(0.1, self.step_timeout)
            budget = _retrylib.RetryBudget(self.retry_sec, base_s=pace,
                                           cap_s=pace, op="bsp.broadcast")
            while True:
                try:
                    h, arrs = self._rpc(root, {"op": "bsp_fetch",
                                               "ver": key[0],
                                               "seq": key[1]})
                    if h.get("hit"):
                        out = np.array(arrs["x"])
                        budget.succeeded()
                        break
                except OSError:
                    self._poll_gen()
                if budget.expired:
                    budget.give_up(TimeoutError(
                        f"bsp rank {self.rank}: broadcast {key} never "
                        f"published by root {root}"))
                budget.sleep()
        with self._results_lock:
            self._results[key] = out
        self.seq += 1
        _ROUNDS.inc()
        return out

    def checkpoint(self, state: dict) -> None:
        """End a synchronized round: bump the version, reset the counter,
        persist `state` (a dict of arrays) version-stamped and atomic,
        and prune the result cache to the one-version recovery window."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.worker_op("checkpoint")
        t0 = time.perf_counter()
        self.version += 1
        self.seq = 0
        if self.snapshot_dir:
            from wormhole_tpu_torch.utils.checkpoint import atomic_savez

            path = self._ckpt_path()
            atomic_savez(path, __version=np.int64(self.version), **state)
            _CKPT_BYTES.inc(os.path.getsize(path))
        with self._results_lock:
            floor = self.version - 1
            for k in [k for k in self._results if k[0] < floor]:
                del self._results[k]
        _CHECKPOINTS.inc()
        _CKPT_S.observe(time.perf_counter() - t0)

    def load_checkpoint(self) -> Optional[dict]:
        """Restore this rank's last checkpoint (None if none exists).
        Rewinds (version, seq) to the checkpoint boundary and switches
        the worker into replay mode: until its collectives stop hitting
        peers' caches, results are fetched instead of re-reduced."""
        if not self.snapshot_dir:
            return None
        path = self._ckpt_path()
        if not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        self.version = int(state.pop("__version"))
        self.seq = 0
        self._behind = True
        return state

    def leave(self) -> None:
        """Resign from the BSP group (elastic retire): bump the tracker
        generation so survivors rebuild the ring without this rank at
        their next round boundary. Best-effort — a crash reaches the
        same end state through liveness eviction; sends both rank and
        uri because a re-indexed survivor's rank may no longer match
        its tracker registration."""
        try:
            self.client.call(op="bsp_leave", rank=self.rank, uri=self.uri)
        except (OSError, ConnectionError):
            pass

    def _ckpt_path(self) -> str:
        return os.path.join(self.snapshot_dir, f"bsp_rank{self.rank}.npz")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._srv.shutdown()
        self._srv.server_close()
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns = {}
            srv_conns = list(self._srv_conns)
        for f in conns:
            try:
                f.close()
            except OSError:
                pass
        for c in srv_conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
