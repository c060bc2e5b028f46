"""Serving shard: a read-only key-range slice of the model, hot-swapped.

The port's copy of the JAX package's serving/server.py, renamed to this
package and sharing nothing with it.

A ``ModelServer`` is the online half of the PS plane: it loads the
``<base>_part-<rank>.npz`` snapshot set that ``write_snapshot_set``
(or the JAX package's PS shards) writes (discovered through the
``<base>_MANIFEST.json`` of utils/manifest.py, so a set mid-replacement
can never be silently mixed), re-shards the FULL tables over the
``--serve`` world with the same even ``shard_range`` split the trainers
use, and answers row-fetch RPCs over the runtime/net.py frame protocol.
The router (serving/router.py) fans a predict batch's unique keys out
across the shards and scores on the gathered rows — so the serving
world size is independent of the training ``-s`` world.

Hot swap: a watcher thread polls the manifest every WH_SERVE_POLL_SEC.
When the version grows it loads the new set into a STANDBY model object
off the request path, then flips the active pointer under a lock the
dispatch path holds only for the pointer read — the request-visible
stall is the pointer swap, not the load (serve.swap_stall_s measures
it). In-flight requests keep the old object alive and finish on the
version they started with; every reply carries its model ``version`` so
the router can detect (and re-fetch across) a mid-batch flip.

Retries are exactly-once in the reply sense: fetches are seq-stamped
per sender and the last reply per sender is cached, so a retried frame
(after a busy bounce or a socket error) returns the ORIGINAL reply —
same rows, same version — instead of re-reading possibly newer state.

Wire codec: a fetch/score request stamped ``wire=bf16`` (router knob
WH_SERVE_WIRE) has its reply floats bf16-truncated at send time —
half the reply bytes under the ulp contract of docs/distributed.md.
The reply cache stores raw arrays and the truncation is deterministic,
so duplicates stay bit-identical on the wire; the default (no stamp)
keeps serving byte-for-byte identical to the trainer's own predict.
"""

from __future__ import annotations

import os
import socket
import socketserver
import threading
import time
from typing import Dict, Optional

import numpy as np

from wormhole_tpu_torch.config import knob_value
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.obs import pyprof as _pyprof
from wormhole_tpu_torch.obs import trace as _trace
from wormhole_tpu_torch.runtime import faults
from wormhole_tpu_torch.runtime import overload as _overload
from wormhole_tpu_torch.runtime.net import busy_reply, recv_frame, send_frame
from wormhole_tpu_torch.serving.fastpath import shard_score as _shard_score
from wormhole_tpu_torch.utils import manifest as _manifest

_REQUESTS = _obs.REGISTRY.counter("serve.requests")
_ROWS = _obs.REGISTRY.counter("serve.rows")
_SWAPS = _obs.REGISTRY.counter("serve.swaps")
_DEDUP_HITS = _obs.REGISTRY.counter("serve.dedup_hits")
_MODEL_EPOCH = _obs.REGISTRY.gauge("serve.model_epoch")
_SWAP_STALL_S = _obs.REGISTRY.histogram("serve.swap_stall_s")
_SHED_DEADLINE = _obs.REGISTRY.counter("serve.shed.deadline")
_SHED_BUSY = _obs.REGISTRY.counter("serve.shed.busy")

_TORN_RETRIES = 3


class ServingModel:
    """One shard's slice of every table at ONE manifest version —
    immutable once built, so requests scoring against it mid-swap need
    no locks. Rows are addressed by GLOBAL row id; the slice covers
    ``shard_range(full_rows[t], rank, world)`` of each table."""

    def __init__(self, base: str, rank: int, world: int,
                 man: Optional[dict] = None):
        man = man if man is not None else _manifest.read_manifest(base)
        if not _manifest.complete(man):
            raise FileNotFoundError(
                f"no complete snapshot manifest at "
                f"{_manifest.manifest_path(base)}")
        self.full_rows = {k: int(v)
                          for k, v in man.get("full_rows", {}).items()}
        self.ranges = {t: _manifest.shard_range(rows, rank, world)
                       for t, rows in self.full_rows.items()}
        self.tables, meta = _manifest.load_slices(base, self.ranges, man)
        self.version = int(meta["version"])
        self.clock = int(meta["clock"])
        self.rank = rank
        self.world = world
        self._base = base
        self._man = man
        # full-table replicas for the score fast path (e.g. difacto's
        # V: hashed mod vb, so a w-range partition scatters its rows
        # across every shard) — loaded lazily on the first score that
        # names the table, then eagerly on standby models off-path
        self._replicated: Dict[str, np.ndarray] = {}
        self._rep_lock = threading.Lock()

    def replicated(self, table: str) -> np.ndarray:
        """The FULL ``table`` at this model's version (not just this
        shard's slice). Torn reads are retried only while the on-disk
        manifest still names this version; once a newer set is
        committed the raise is correct — the watcher's swap is already
        in flight and the router replays against it."""
        got = self._replicated.get(table)
        if got is not None:
            return got
        with self._rep_lock:
            got = self._replicated.get(table)
            if got is not None:
                return got
            rng = {table: (0, self.full_rows[table])}
            for _ in range(_TORN_RETRIES):
                try:
                    tables, _ = _manifest.load_slices(
                        self._base, rng, self._man)
                    break
                except _manifest.TornSnapshot:
                    man = _manifest.read_manifest(self._base)
                    if int(man.get("version", -1)) != self.version:
                        raise
                    time.sleep(0.02)
            else:
                tables, _ = _manifest.load_slices(
                    self._base, rng, self._man)
            self._replicated[table] = tables[table]
            return tables[table]

    def fetch(self, table: str, keys: np.ndarray) -> np.ndarray:
        """Rows at GLOBAL ids ``keys`` (must fall in this shard's
        range — the router's split guarantees it)."""
        lo, hi = self.ranges[table]
        keys = np.asarray(keys, np.int64)
        if len(keys) and (keys[0] < lo or keys[-1] >= hi):
            raise KeyError(
                f"keys outside shard range [{lo}, {hi}) of {table!r}")
        return self.tables[table][keys - lo]


def load_with_retry(base: str, rank: int, world: int,
                    deadline_s: float = 0.0) -> ServingModel:
    """Build a ServingModel, retrying torn reads (a part replaced
    between the manifest and part reads) and — with a deadline —
    waiting for the FIRST complete manifest to appear (a serving shard
    launched alongside the trainer starts before any snapshot exists)."""
    deadline = time.monotonic() + deadline_s
    while True:
        torn: Optional[Exception] = None
        for _ in range(_TORN_RETRIES):
            try:
                return ServingModel(base, rank, world)
            except _manifest.TornSnapshot as e:
                torn = e  # fresh manifest names the replacement files
            except FileNotFoundError:
                torn = None
                break
        if torn is not None:
            raise torn
        if time.monotonic() >= deadline:
            raise FileNotFoundError(
                f"no complete snapshot manifest at "
                f"{_manifest.manifest_path(base)} after "
                f"{deadline_s:.0f}s")
        time.sleep(0.2)


class _ServeHandler(socketserver.StreamRequestHandler):
    def handle(self):
        self.connection.setsockopt(socket.IPPROTO_TCP,
                                   socket.TCP_NODELAY, 1)
        srv = self.server.model_server  # type: ignore
        with srv._conns_lock:
            srv._conns.add(self.connection)
        try:
            self._serve(srv)
        except (OSError, ConnectionError):
            # a peer that vanished mid-frame (or a router that severed
            # this socket after a hedge win) is an ordinary disconnect,
            # not a handler error worth a traceback
            pass
        finally:
            with srv._conns_lock:
                srv._conns.discard(self.connection)

    def _serve(self, srv: "ModelServer"):
        while True:
            got = recv_frame(self.rfile)
            if got is None:
                return
            header, arrays, _ = got
            t_in = time.perf_counter()
            op = header.get("op")
            # a frame whose propagated deadline expired in transit gets
            # a shed reply, not a handler: nobody is waiting for the
            # result, and under overload every shed admits a request
            # someone IS still waiting for
            if _overload.should_shed(header):
                _SHED_DEADLINE.inc()
                send_frame(self.wfile, dict(_overload.shed_reply(header),
                                            version=srv.version))
                continue
            # admission gate (fixed WH_NET_MAX_INFLIGHT or AIMD), same
            # contract as the PS shards: a bounced frame was never
            # dispatched, so the client resends the SAME seq and the
            # reply cache keeps the retry exactly-once
            if not srv._gate.try_enter(op):
                _SHED_BUSY.inc()
                send_frame(self.wfile,
                           dict(busy_reply(srv._gate.busy_hint_ms()),
                                version=srv.version))
                continue
            try:
                # chaos hook: a serve shard sends no request frames of
                # its own, so the net-fault send hook never sees its
                # ops — arm them at dispatch instead. net:slow@fetch
                # models a slow shard; the sleep lands inside the gate
                # so AIMD and the SLO burn see the degraded service time
                if faults.ACTIVE is not None:
                    faults.ACTIVE.frame(op)
                # adopt the trace context a sampled request carried, so
                # this shard's spans stitch under the router's fan-out —
                # and the request's remaining deadline, so downstream
                # work this handler does inherits the budget
                with _trace.bind_wire(header), \
                        _overload.bind(_overload.header_deadline(header)):
                    resp_header, resp_arrays = srv._dispatch(
                        header, arrays, t_in)
            finally:
                srv._gate.leave(op, time.perf_counter() - t_in)
            # opt-in serving wire codec (WH_SERVE_WIRE on the router):
            # a fetch/score request stamped wire=bf16 gets its reply
            # floats bf16-truncated AT SEND TIME. The reply cache keeps
            # RAW arrays, so a retried or hedged duplicate re-encodes
            # to the exact same bytes (RNE truncation is deterministic)
            # — exactly-once still means bit-identical duplicates.
            fb = (2 if (header.get("wire") == "bf16"
                        and op in ("fetch", "score")
                        and "error" not in resp_header) else 0)
            send_frame(self.wfile, resp_header, resp_arrays,
                       fixed_bytes=fb)
            if header.get("op") == "shutdown":
                srv._shutdown.set()
                return


class _ServeServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ModelServer:
    """One serving shard process: loads its slice, serves fetches,
    watches the manifest for newer versions and hot-swaps to them."""

    def __init__(self, rank: int, world: int, base: str,
                 host: str = "127.0.0.1", port: int = 0,
                 poll_sec: Optional[float] = None,
                 deadline_s: Optional[float] = None):
        self.rank = rank
        self.world = world
        self.base = base
        self.poll_sec = (float(knob_value("WH_SERVE_POLL_SEC"))
                         if poll_sec is None else float(poll_sec))
        if deadline_s is None:
            deadline_s = float(knob_value("WH_SERVE_RETRY_SEC"))
        self._model = load_with_retry(base, rank, world, deadline_s)
        _MODEL_EPOCH.set(float(self._model.version))
        # dispatch reads the active pointer under this lock; the watcher
        # holds it only for the pointer flip, so the request-visible
        # swap stall is the flip, never the standby load
        self._flip_lock = threading.Lock()
        # reply cache: sender -> (seq, resp_header, resp_arrays); the
        # router uses one sender id per connection with monotone seqs,
        # so caching the latest reply covers every retry pattern
        self._replies: Dict[str, tuple] = {}
        self._replies_lock = threading.Lock()
        # tables score headers asked to replicate (e.g. difacto's V):
        # remembered so a standby model loads its replicas OFF the
        # request path, before the flip
        self._replicate: set = set()
        self._gate = _overload.AdmissionController()
        self._shutdown = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._srv = _ServeServer((host, port), _ServeHandler)
        self._srv.model_server = self  # type: ignore
        self._watcher: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    @property
    def uri(self) -> str:
        h, p = self._srv.server_address[:2]
        return f"{h}:{p}"

    @property
    def version(self) -> int:
        return self._model.version

    def serve(self) -> None:
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()
        self._watcher = threading.Thread(target=self._watch_loop,
                                         daemon=True)
        self._watcher.start()

    def wait_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown.wait(timeout)

    def stop(self) -> None:
        self._shutdown.set()
        self._srv.shutdown()
        self._srv.server_close()
        # sever live handler connections so a stopped shard looks like a
        # dead process to the router (retry path), not a hung socket
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    # -- hot swap -----------------------------------------------------------
    def _watch_loop(self) -> None:  # wormlint: thread-entry
        _pyprof.tag_thread("watcher")
        while not self._shutdown.wait(self.poll_sec):
            try:
                self.maybe_swap()
            except Exception as e:
                # a torn or half-written set is retried next poll; the
                # active model keeps serving
                print(f"[serve {self.rank}] swap attempt failed: {e}",
                      flush=True)

    def maybe_swap(self) -> bool:
        """Load and flip to a newer snapshot version if one is on disk.
        Returns True when a swap happened. Safe to call directly (tests
        and the lab use it for deterministic swaps)."""
        standby = None
        for _ in range(_TORN_RETRIES):
            man = _manifest.read_manifest(self.base)
            if not _manifest.complete(man):
                return False
            if int(man["version"]) <= self._model.version:
                return False
            try:
                standby = ServingModel(self.base, self.rank, self.world,
                                       man)
                break
            except _manifest.TornSnapshot:
                # a part was replaced under this manifest (a set write is
                # in flight); re-read — the committed manifest names the
                # replacement files
                time.sleep(0.02)
        if standby is None:
            return False  # still torn; the next poll retries
        for t in sorted(self._replicate):
            standby.replicated(t)  # off-path: requests still see old
        t0 = time.perf_counter()
        with self._flip_lock:
            old = self._model.version
            self._model = standby
        stall = time.perf_counter() - t0
        _SWAP_STALL_S.observe(stall)
        _SWAPS.inc()
        _MODEL_EPOCH.set(float(standby.version))
        _trace.event("serve.swap", cat="serve", rank=self.rank,
                     version=standby.version, prev=old,
                     stall_ms=round(stall * 1e3, 3))
        print(f"[serve {self.rank}] swapped to snapshot version "
              f"{standby.version} (was {old}, "
              f"stall {stall * 1e3:.2f} ms)", flush=True)
        return True

    # -- ops ----------------------------------------------------------------
    def _dispatch(self, header: dict,  # wormlint: thread-entry
                  arrays: dict,
                  t_in: Optional[float] = None) -> tuple[dict, dict]:
        op = header.get("op")
        t0 = time.perf_counter()
        try:
            with _trace.request_span(f"serve.shard.{op}", cat="serve",
                                     rank=self.rank):
                resp = self._dispatch_op(op, header, arrays)
            if op in ("fetch", "score") and "queue_s" not in resp[0] \
                    and "error" not in resp[0]:
                # stage attribution for the router: how long the frame
                # waited behind the gate/handler, and how long the fetch
                # itself took. A cached (retried) reply keeps the
                # ORIGINAL numbers — same bytes as the first send.
                resp[0]["queue_s"] = round(
                    t0 - t_in, 6) if t_in is not None else 0.0
                resp[0]["served_s"] = round(time.perf_counter() - t0, 6)
            return resp
        except Exception as e:  # a bad request must not kill the shard
            return {"error": repr(e), "version": self.version}, {}
        finally:
            _obs.REGISTRY.histogram(f"serve.op.{op}_s").observe(
                time.perf_counter() - t0)

    def _dispatch_op(self, op, header: dict,  # wormlint: thread-entry
                     arrays: dict) -> tuple[dict, dict]:
        _REQUESTS.inc()
        # one pointer read per request: rows AND the stamped version come
        # from the same immutable model object even if a swap lands
        # mid-request
        with self._flip_lock:
            m = self._model
        if op == "hello":
            sender = header.get("sender", "?")
            with self._replies_lock:
                cached = self._replies.get(sender)
            return {"ok": 1, "rank": self.rank, "world": self.world,
                    "version": m.version, "full_rows": m.full_rows,
                    "tables": sorted(m.tables),
                    "last_seq": cached[0] if cached else -1}, {}
        if op in ("fetch", "score"):
            sender = header.get("sender", "?")
            seq = int(header.get("seq", -1))
            # one reply cache for BOTH data-plane ops: hedges and
            # socket-error retries resend the same (sender, seq), so a
            # duplicate score is answered with the ORIGINAL partials —
            # same bytes, same version — never recomputed
            if seq >= 0:
                with self._replies_lock:
                    cached = self._replies.get(sender)
                if cached is not None and cached[0] == seq:
                    _DEDUP_HITS.inc()
                    return cached[1], cached[2]
            if op == "score":
                for t in header.get("rep", ()):
                    self._replicate.add(t)
                    m.replicated(t)
                out = _shard_score(header, arrays, m)
                _ROWS.inc(len(arrays.get("i", ())))
            else:
                out = {}
                nrows = 0
                for t in header.get("tables", []):
                    rows = m.fetch(t, arrays[f"k:{t}"])
                    out[f"r:{t}"] = rows
                    nrows += len(rows)
                _ROWS.inc(nrows)
            resp = ({"ok": 1, "version": m.version, "seq": seq}, out)
            if seq >= 0:
                with self._replies_lock:
                    self._replies[sender] = (seq, *resp)
            return resp
        if op == "stats":
            return {"ok": 1, "version": m.version, "rank": self.rank,
                    "metrics": _obs.REGISTRY.snapshot()}, {}
        if op == "shutdown":
            return {"ok": 1, "version": m.version}, {}
        return {"error": f"unknown op {op!r}", "version": m.version}, {}


def run_serve_role(cfg, env) -> dict:
    """Entry for a launcher-spawned ``--serve`` process (role dispatch in
    apps/_runner.run_minibatch_app): load the shard, register with the
    scheduler (re-registration after a respawn is the recovery signal
    the router's resolver picks up), heartbeat with piggybacked metrics,
    exit when the job announces shutdown."""
    from wormhole_tpu_torch.runtime.tracker import SchedulerClient

    base = str(knob_value("WH_SERVE_SNAPSHOT") or "")
    if not base:
        snap_dir = os.environ.get("WH_SNAPSHOT_DIR", "")
        if not snap_dir:
            raise RuntimeError(
                "serve role needs WH_SERVE_SNAPSHOT or the launcher's "
                "snapshot dir (WH_SNAPSHOT_DIR) to locate the model")
        base = os.path.join(snap_dir, "srv")
    world = max(int(getattr(env, "num_serve", 1)), 1)
    # startup must outlast the trainer's FIRST snapshot cycle, which the
    # router retry window does not have to
    deadline = max(float(knob_value("WH_SERVE_RETRY_SEC")), 120.0)
    server = ModelServer(env.rank, world, base, deadline_s=deadline)
    server.serve()
    client = SchedulerClient(env.scheduler_uri, f"serve-{env.rank}")
    client.call(op="register_serve", rank=env.rank, uri=server.uri)
    print(f"[serve {env.rank}] serving {base} version "
          f"{server.version} at {server.uri}", flush=True)
    try:
        while not server.wait_shutdown(2.0):
            try:
                r = client.call(op="epoch",
                                metrics=_obs.REGISTRY.snapshot())
            except Exception:
                break  # scheduler gone: the job is over
            if r.get("shutdown"):
                break
    finally:
        server.stop()
    return {}
