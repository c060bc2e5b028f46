"""Parameter-server data plane: shared model across worker processes.

The port's copy of the JAX package's runtime/ps_server.py, renamed to this
package and sharing nothing with it.

The reference's ps-lite servers hold THE model: every worker ZPulls the
same server-resident weights and ZPushes gradients back, so N workers
train one set of statistics (reference learn/linear/async_sgd.h:240-288,
servers at :200-226; key-range sharding across `-s` server processes).
This module is the cross-process equivalent (host numpy; only the
worker's store, which SyncedStore reaches through gather_rows /
scatter_rows / to_numpy / from_numpy, lives on the card):

- `-s` server processes each own a contiguous bucket-range shard of every
  state table (the ps-lite key-shard layout; rows n*r//S .. n*(r+1)//S of
  each array, matching utils/checkpoint.py's part split so server part
  files ARE checkpoint part files).
- Workers train on their device and synchronize through the
  servers with **bounded staleness**: every `max_delay` minibatches a
  worker pushes the additive delta of its state tables since its last
  pull and pulls the merged state back. For FTRL the (z, n) tables are
  exactly additive in the pushed gradients, so delta-merging reproduces
  async-SGD semantics with staleness <= max_delay minibatches per worker
  (the reference's max_delay knob, difacto guide/criteo.conf:21, bounds
  the same quantity in units of in-flight minibatches).
- **The wire is sparse**: a push carries only the rows the worker
  touched since its last sync — (indices, delta-rows) per table — the
  ZPush-of-the-minibatch's-keys semantic (async_sgd.h:270-287). Pulls
  are versioned: servers stamp every pushed row with a monotonically
  increasing clock, and `pull since=c` returns only rows stamped after
  `c` — so a worker's pull traffic is proportional to what ANY worker
  changed since it last looked, never to the table size. Together these
  make wire bytes/sync O(globally touched keys), which is what lets the
  multi-process path run at the 2^26-bucket Criteo-1TB operating point
  (a dense (z, n) sync there would be ~0.5 GB per worker per sync).
- Pushes are optionally quantized on the wire (fixed_bytes: 2 = bfloat16
  bits, 1 = int8 + scale — the FIXING_FLOAT/TRUNCATE filter parity,
  async_sgd.h:290-301) and optionally zlib-compressed (the
  msg_compression filter, linear config.proto:123-133).
- **Wire codec v2** (`WH_WIRE={raw,bf16,int8,int4}`, `WH_WIRE_EF`,
  `WH_WIRE_COMP={,zlib,bshuf}`): value quantization on BOTH directions
  with sender-side error feedback. Pushes quantize each sync's delta
  rows ONCE (SyncedStore snapshot time) into `net.QuantRows` — per-row
  scales for 2-D tables, per-64-element group scales for 1-D (a scalar
  scale over a skewed compacted row vector flattens everything but the
  hottest row to zero and diverges FTRL) — with an `EFQuant` residual
  accumulator per table (transmit Q(delta + r), keep
  r <- (delta + r) - Q(.)), so low-bit value streams stay unbiased over
  time; journal replays and need_keys resends reuse the SAME QuantRows,
  so the seq-fenced retry can never re-advance (double-apply) a
  residual. Versioned pull replies are quantized server-side with a
  per-(sender, table) EFQuant — pulls are absolute refreshes, so a lost
  reply self-corrects on the next one — and invalidated with the key
  caches on restore; pull replies cap at bf16 (absolute-state refreshes
  need per-element relative precision — absmax codes err relative to
  the hottest group neighbor and diverge skewed FTRL tables). Everything is hello-negotiated per connection: the
  client offers `wire`/`wire_comp`, the server acks what it can decode,
  and an un-acked (older) peer silently degrades to the legacy scalar
  fixed_bytes forms and raw framing. `wire_comp=bshuf` frames eligible
  buffers with a byte-plane shuffle + zlib-1 (`comp="bshuf+zlib"`).
- The reference's third filter, KEY_CACHING, avoids resending
  identical key lists; `WH_KEYCACHE=1` enables its analog here: frames carry a blake2b
  digest of each group's sorted key vector, servers cache key lists per
  (sender, digest), and a repeated touched set (the common case on
  epoch 2+ under the pack cache) ships digest + values only, with a
  miss-reply -> full-resend fallback. Caches are invalidated by the
  recovery path (server restore/reload, client reconnect), counted in
  `ps.keycache.{hits,misses,invalidations}`.
- **Async sync** (`WH_ASYNC_SYNC=1`): `SyncedStore.sync()` snapshots the
  touched rows + deltas and hands the push+pull round-trip to a
  background comms thread (ps-lite's ZPush/ZPull-return-immediately
  semantics), folding the pull result in at the NEXT sync boundary —
  device compute overlaps the wire, and effective staleness grows to at
  most 2*max_delay minibatches. `flush()` is the barrier (part ends,
  eval, checkpoints): it drains the in-flight round-trip and runs one
  synchronous sync so results stay well-defined. With the knob off the
  sync path is bit-identical to the original synchronous one.
- Multi-server pushes/pulls fan their per-server slices out on a small
  thread pool (one socket per server), so a sync against `-s` servers
  costs max-of-shards, not sum-of-shards.

Server discovery rides the scheduler control plane: servers register
their URI (op=register_server), workers poll op=servers until all `-s`
URIs are known.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import queue
import time
import socket
import socketserver
import threading
from typing import Callable, Optional

import numpy as np

from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.obs import pyprof as _pyprof
from wormhole_tpu_torch.obs import trace as _trace
from wormhole_tpu_torch.runtime import faults
from wormhole_tpu_torch.runtime import overload as _overload
from wormhole_tpu_torch.runtime import retry as _retrylib
from wormhole_tpu_torch.runtime.net import (  # noqa: F401  (re-exported: the wire
    _COMPRESS_MIN, _decode, _encode, _read_exact, EFQuant, InflightGate,
    QuantRows, WIRE_COMP_MODES, WIRE_ENCODINGS, busy_backoff, busy_reply,
    connect_with_retry, key_digest, quantize_rows,
    recv_frame, send_frame)  # format moved to net.py so fault
# injection can hook frame send/recv for every net user; tests and tools
# keep importing the names from here.

# registry handles cached at import (see wormhole_tpu_torch/obs/metrics.py)
_NUM_PUSH = _obs.REGISTRY.counter("ps.server.num_push")
_NUM_PULL = _obs.REGISTRY.counter("ps.server.num_pull")
_DEDUP_HITS = _obs.REGISTRY.counter("ps.server.dedup_hits")
_SNAPSHOTS = _obs.REGISTRY.counter("ps.server.snapshots")
_SNAPSHOT_S = _obs.REGISTRY.histogram("ps.server.snapshot_s")
_RESTORES = _obs.REGISTRY.counter("ps.server.restores")
_RESTORE_EPOCH = _obs.REGISTRY.gauge("ps.server.restore_epoch")
_RPC_S = _obs.REGISTRY.histogram("ps.client.rpc_s")
_BYTES_PUSH = _obs.REGISTRY.counter("ps.client.bytes_push")
_BYTES_PULL = _obs.REGISTRY.counter("ps.client.bytes_pull")
_RETRIES = _obs.REGISTRY.counter("ps.client.retries")
_REPLAYS = _obs.REGISTRY.counter("ps.client.replays")
_REPLAY_DEDUP = _obs.REGISTRY.counter("ps.client.replay_dedup")
_ROLLBACKS = _obs.REGISTRY.counter("ps.client.rollback_repulls")
# membership-epoch absorption: re-handshakes run against the (stable)
# server group after the WORKER set changed (see PSClient.rehello)
_REHELLOS = _obs.REGISTRY.counter("ps.client.rehellos")
_SYNCS = _obs.REGISTRY.counter("ps.client.syncs")
_SYNC_PUSH_S = _obs.REGISTRY.histogram("ps.client.sync_push_s")
_SYNC_PULL_S = _obs.REGISTRY.histogram("ps.client.sync_pull_s")
# async-sync plane: in-flight round-trips (0 or 1 per SyncedStore),
# fraction of round-trip wall hidden behind device compute, and the
# fold-wait the training loop actually paid at sync boundaries
_SYNC_INFLIGHT = _obs.REGISTRY.gauge("ps.sync.inflight")
_SYNC_OVERLAP = _obs.REGISTRY.gauge("ps.sync.overlap_frac")
_SYNC_WAIT_S = _obs.REGISTRY.histogram("ps.client.sync_wait_s")
# train.stage.* mirror: the sync wall the TRAIN THREAD actually pays —
# the full round-trip in synchronous mode, only the fold wait in async
# mode (the overlapped remainder is hidden behind compute)
_ST_SYNC = _obs.REGISTRY.histogram("train.stage.sync_s")
# key-list caching (the KEY_CACHING filter analog): hits = frames that
# shipped digest-only, misses = digest sends the receiver couldn't
# resolve (followed by a full resend), invalidations = cache discards
# on the recovery path (server restore/reload, client reconnect)
_KC_HITS = _obs.REGISTRY.counter("ps.keycache.hits")
_KC_MISSES = _obs.REGISTRY.counter("ps.keycache.misses")
_KC_INVALIDATIONS = _obs.REGISTRY.counter("ps.keycache.invalidations")


def _env_flag(name: str) -> bool:
    v = os.environ.get(name)
    return v is not None and v.lower() not in ("", "0", "false", "off")

# init_spec claim TTL: how long a server waits for a claimant's
# init_arrays before handing the claim to the next poller. Clients wait
# 2x this by default so at least one full re-claim cycle fits inside the
# client deadline (a claimant dying right after claiming stays
# recoverable instead of racing the waiters' own timeout).
INIT_CLAIM_TTL = 300.0


def shard_range(n: int, rank: int, world: int) -> tuple[int, int]:
    """Row range of server `rank`: the same even split checkpoint part
    files use (utils/checkpoint.py), so parts reassemble by rank order."""
    return n * rank // world, n * (rank + 1) // world


def _idx_name(rows: int) -> str:
    """Wire name of the shared index array for the row-space group of
    tables with `rows` full rows (tables with equal row counts share one
    touched-index set per frame — z and n are always touched together)."""
    return f"idx:{rows}"


def ftrl_prox_rows(spec: dict, z: np.ndarray,
                   n: np.ndarray) -> np.ndarray:
    """The 'ftrl_prox' derived-table rule: w = prox(z, n) with the
    spec's lr/elastic-net constants. ONE definition shared by the
    server's dirty-row recompute (_recompute_derived) and the client's
    pull-side reconstruction (SyncedStore._fill_derived), so both ends
    of the wire derive identical values from identical sources."""
    eta = (spec["lr_beta"] + np.sqrt(n)) / spec["lr_eta"]
    mag = np.maximum(np.abs(z) - spec["lambda_l1"], 0.0)
    return (np.sign(-z) * mag / (eta + spec["lambda_l2"])
            ).astype(np.float32)


# ---------------------------------------------------------------- server
class _PSHandler(socketserver.StreamRequestHandler):
    def handle(self):
        # mirror the client side's TCP_NODELAY (net.connect_with_retry):
        # reply frames must not sit out a delayed-ACK window
        self.connection.setsockopt(socket.IPPROTO_TCP,
                                   socket.TCP_NODELAY, 1)
        node = self.server.node  # type: ignore
        with node._conns_lock:
            node._conns.add(self.connection)
        try:
            self._serve(node)
        except (OSError, ConnectionError):
            # a peer that vanished mid-frame (or a client that severed
            # this socket after a hedged pull won) is an ordinary
            # disconnect, not a handler error worth a traceback
            pass
        finally:
            with node._conns_lock:
                node._conns.discard(self.connection)

    def _serve(self, node):
        # frame compression (WH_NET_COMPRESS) is per-connection and
        # hello-negotiated: it turns on only after a hello carrying
        # net_compress=1 lands while this server has the knob set, and
        # the ack in the reply is what arms the client side — either end
        # left at the default keeps the whole connection uncompressed.
        # Wire-codec negotiation rides the same hello: `wire` asks "can
        # you decode QuantRows encodings / quantize pull replies" (acked
        # unconditionally — capability is the codebase, not a knob) and
        # `wire_comp` latches the negotiated frame-compression mode
        # ("zlib" / "bshuf") for every frame both ways; fc holds
        # False / True(zlib) / "zlib" / "bshuf" and feeds send_frame.
        fc = False
        while True:
            got = recv_frame(self.rfile)
            if got is None:
                return
            header, arrays, _ = got
            t_in = time.perf_counter()
            op = header.get("op")
            # deadline shed: a frame whose propagated budget expired in
            # transit is answered without dispatch — the sender's retry
            # window is already spent, and under overload every shed
            # admits work someone is still waiting for. Nothing was
            # applied, so seq fences are untouched.
            if _overload.should_shed(header):
                send_frame(self.wfile, dict(_overload.shed_reply(header),
                                            epoch=node.epoch))
                continue
            # admission gate (fixed WH_NET_MAX_INFLIGHT or WH_ADMIT_AIMD):
            # an over-admitted frame is bounced with a structured busy
            # reply BEFORE dispatch — nothing was applied, so the
            # client's resend of the same seq-stamped frame stays
            # exactly-once. Control ops (hello/init/...) always pass.
            if not node._gate.try_enter(op):
                send_frame(self.wfile,
                           dict(busy_reply(node._gate.busy_hint_ms()),
                                epoch=node.epoch))
                continue
            try:
                # adopt the trace context a sampled sync round carried
                # so this shard's spans stitch under the client's round
                # — and its remaining deadline, for downstream budgets
                with _trace.bind_wire(header), \
                        _overload.bind(_overload.header_deadline(header)):
                    resp_header, resp_arrays = node._dispatch(header,
                                                              arrays)
            finally:
                node._gate.leave(op, time.perf_counter() - t_in)
            if header.get("op") == "hello":
                if header.get("net_compress") and node.net_compress:
                    fc = True
                    resp_header["net_compress"] = 1
                if header.get("wire"):
                    resp_header["wire"] = 1
                wc = header.get("wire_comp")
                if wc in ("zlib", "bshuf"):
                    fc = wc
                    resp_header["wire_comp"] = wc
            # every reply carries the server's restore epoch so clients
            # detect a respawned (rolled-back) server on any op
            resp_header.setdefault("epoch", node.epoch)
            send_frame(self.wfile, resp_header, resp_arrays,
                       compress=bool(header.get("comp_reply")) or fc)
            if header.get("op") == "shutdown":
                self.server.node._shutdown.set()  # type: ignore
                return


class _PSServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ServerNode:
    """One `-s` server process: owns its bucket-range slice of every state
    table. Tables are created by the first `init` push (set-if-absent;
    workers init deterministically so any winner is equivalent); `push`
    adds deltas — sparse (rows at pushed indices) or dense; `pull`
    returns rows stamped after the caller's `since` clock; `save` writes
    this server's shard as a checkpoint part file.

    Versioning: every push advances `clock` and stamps the pushed rows
    in a per-row-space version array (`_ver[full_rows][row] = clock`).
    Tables with the same full row count form one group and share a
    version array — pushing z also makes the derived w's rows dirty,
    which is exactly right since w = prox(z, n).

    Fault tolerance: pushes carrying a (`sender`, `seq`) pair are
    seq-fenced — a seq at or below the sender's last applied one is
    acknowledged but NOT re-applied, so clients may blindly replay their
    push journal after a reconnect. `epoch` counts the process's
    incarnations (0 = first run, N = Nth respawn); it rides every reply
    so clients detect a restored-from-snapshot (rolled-back) server.
    `start_snapshots` takes periodic async shard snapshots off the
    request path; `restore_snapshot` rebuilds the shard from the newest
    one (see docs/distributed.md "Fault tolerance")."""

    def __init__(self, rank: int, world: int,
                 host: str = "127.0.0.1", port: int = 0, epoch: int = 0):
        self.rank = rank
        self.world = world
        self.epoch = int(epoch)
        self.tables: dict[str, np.ndarray] = {}
        self.full_rows: dict[str, int] = {}  # full-table row counts
        # derived-table specs ({name: {"kind": "ftrl_prox", ...}}): tables
        # that are NOT additive in worker pushes but are pure functions of
        # additive ones (FTRL's w = prox(z, n)); recomputed server-side
        # after merges so pulls/saves never expose an inconsistent pair
        self.derived: dict[str, dict] = {}
        self.clock = 0
        self._ver: dict[int, np.ndarray] = {}  # group -> int64[shard rows]
        # rows dirty since the last derived recompute, per group:
        # list of shard-local index arrays, or "all" after a dense push
        self._dirty: dict[int, object] = {}
        # push log for O(pushed) versioned pulls: per group a list of
        # (clock, idx) from sparse pushes, and the clock BEFORE the
        # oldest logged entry. A pull with since >= _log_start[g] takes
        # the union of logged rows newer than `since` instead of the
        # O(shard rows) version-array scan — at the 2^26 operating point
        # that scan walks 64M entries per group per sync and was the
        # dominant term of the measured PS-plane overhead (PERF.md r5).
        # Dense merges / checkpoint stamps reset the log (the scan
        # fallback stays correct); the log is capped so memory stays
        # O(recent pushes).
        self._pushlog: dict[int, list] = {}
        self._log_start: dict[int, int] = {}
        self._log_elems: dict[int, int] = {}
        # spec-init bookkeeping: non-zero-init tables awaiting their
        # arrays, per-table upload claims (name -> deadline), the full
        # table shapes for the divergent-conf cross-check, and the
        # post-checkpoint-load stamping state
        self._pending: set[str] = set()
        self._claims: dict[str, float] = {}
        self._full_shapes: Optional[dict[str, list]] = None
        # per-table zero-init flags, known only when THIS server created
        # the tables from an init_spec (checkpoint loads leave it None —
        # the loaded arrays are ground truth and flags are moot)
        self._zero_flags: Optional[dict[str, bool]] = None
        self._loaded = False
        self._stamped_all: set[int] = set()
        # seq fence: last applied push sequence number per sender, the
        # dedup table that makes client-side replay idempotent
        self._last_seq: dict[str, int] = {}
        # KEY_CACHING filter state (client-driven, see PSClient):
        # per-sender LRU of key lists received in full (digest ->
        # shard-local idx) so repeated pushes can ship digest-only, and
        # per-sender LRU of digests the sender itself is known to hold
        # (adopted from its full pushes / our full pull replies) so pull
        # replies can go digest-only too. The known-cap is smaller than
        # the client's cache, so an omitted reply is nearly always
        # reconstructible; the client's full-re-pull fallback keeps a
        # stale assumption harmless.
        self._kc_idx: dict[str, collections.OrderedDict] = {}
        self._kc_known: dict[str, collections.OrderedDict] = {}
        # pull-side error feedback (wire codec v2): per-sender,
        # per-table residual accumulators for quantized pull replies;
        # invalidated with the key caches on restore (a rolled-back
        # shard's residuals describe values that no longer exist)
        self._efq: dict[str, dict[str, EFQuant]] = {}
        # async snapshot state: base path, cadence, clock of the last
        # written snapshot (skip when nothing changed), writer thread
        self._snap_base: Optional[str] = None
        self._snap_every = 0.0
        self._snap_clock = -1
        self._snap_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        # live handler connections, severed on stop() so a stopped node
        # looks like a dead process to its clients (not a half-open
        # socket that strands them in recv)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # hello-negotiated zlib frame compression (WH_NET_COMPRESS):
        # meant for the hot plane's cold-tier traffic — big, rare flush
        # frames — where the codec cost amortizes; default off
        self.net_compress = _env_flag("WH_NET_COMPRESS")
        # max-in-flight admission gate (WH_NET_MAX_INFLIGHT; default
        # unlimited = a single None check per frame)
        self._gate = _overload.AdmissionController()
        self._srv = _PSServer((host, port), _PSHandler)
        self._srv.node = self  # type: ignore
        self.num_push = 0
        self.num_pull = 0

    @property
    def uri(self) -> str:
        h, p = self._srv.server_address[:2]
        return f"{h}:{p}"

    def serve(self) -> None:
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()

    def wait_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown.wait(timeout)

    def stop(self) -> None:
        self._shutdown.set()
        self._srv.shutdown()
        self._srv.server_close()
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

    def _shard_rows(self, group: int) -> int:
        lo, hi = shard_range(group, self.rank, self.world)
        return hi - lo

    def _create_group_meta(self) -> None:
        """Version/dirty arrays for every row-space group (caller holds
        the lock, full_rows already set). uint32 clock stamps: 4
        bytes/row; push asserts the clock never reaches the wrap point
        so staleness can't silently freeze (ADVICE r3)."""
        for g in {r for r in self.full_rows.values()}:
            self._ver[g] = np.zeros(self._shard_rows(g), np.uint32)
            self._dirty[g] = []
            self._reset_pushlog(g)

    # -- ops ----------------------------------------------------------------
    def _dispatch(self, header: dict,
                  arrays: dict) -> tuple[dict, dict]:
        op = header.get("op")
        t0 = time.perf_counter()
        try:
            with _trace.request_span(f"ps.shard.{op}", cat="ps",
                                     rank=self.rank):
                return self._dispatch_op(op, header, arrays)
        finally:
            # per-op service latency (what the server spent, not what the
            # client waited — that's ps.client.rpc_s)
            _obs.REGISTRY.histogram(f"ps.server.op.{op}_s").observe(
                time.perf_counter() - t0)

    def _dispatch_op(self, op, header: dict,
                     arrays: dict) -> tuple[dict, dict]:
        if faults.ACTIVE is not None:
            faults.ACTIVE.server_op(op)
        if op == "hello":
            # reconnect handshake: tells the client this server's epoch
            # (rollback detection) and the last push seq it applied for
            # the asking sender (journal replay starts after it)
            sender = header.get("sender")
            with self._lock:
                return ({"ok": True, "clock": self.clock,
                         "last_seq": self._last_seq.get(sender, 0)}, {})
        if op == "init":
            with self._lock:
                known = bool(self.tables)
                if not known:
                    for k, v in arrays.items():
                        self.tables[k] = v.astype(np.float32)
                    self.full_rows = {
                        k: int(n) for k, n in header["full_rows"].items()}
                    self.derived = header.get("derived") or {}
                    self._create_group_meta()
                return ({"ok": True, "known": known, "clock": self.clock},
                        {})
        if op == "init_spec":
            # O(spec) table creation: the header carries {shape, zero}
            # per table; zero-init tables (the whole FTRL state) are
            # created server-side with no payload at all. Non-zero-init
            # tables are CLAIMED by the first asker (claims expire so a
            # dead claimant can't wedge startup) and only the claimant
            # ships them via init_arrays — so even N concurrently
            # starting workers put exactly one copy on the wire, not N.
            # A dense init offer at the 2^26 operating point is ~768 MB
            # per worker, which this path never sends.
            with self._lock:
                if not self.tables and not self._pending:
                    self.full_rows = {
                        k: int(s["shape"][0])
                        for k, s in header["specs"].items()}
                    self.derived = header.get("derived") or {}
                    self._full_shapes = {
                        k: [int(d) for d in s["shape"]]
                        for k, s in header["specs"].items()}
                    self._zero_flags = {
                        k: bool(s.get("zero", False))
                        for k, s in header["specs"].items()}
                    for k, s in header["specs"].items():
                        lo, hi = shard_range(int(s["shape"][0]), self.rank,
                                             self.world)
                        if s.get("zero", False):
                            self.tables[k] = np.zeros(
                                (hi - lo, *s["shape"][1:]), np.float32)
                        else:
                            self._pending.add(k)
                    self._create_group_meta()
                else:
                    # cross-check FULL shapes (rows AND tails — e.g. two
                    # difacto confs disagreeing on dim) AND the zero-init
                    # flag (same shapes but disagreeing on which tables
                    # are zero-init means an incoherent base mirror): a
                    # divergent worker must fail here, not later with
                    # misrouted or mis-shaped pushes
                    want = {k: [int(d) for d in s["shape"]]
                            for k, s in header["specs"].items()}
                    have = self._full_shapes
                    if have is not None and want != have:
                        return {"error":
                                f"init spec mismatch: offered {want} vs "
                                f"created {have}"}, {}
                    w_zero = {k: bool(s.get("zero", False))
                              for k, s in header["specs"].items()}
                    if (self._zero_flags is not None
                            and w_zero != self._zero_flags):
                        return {"error":
                                f"init spec mismatch: zero flags "
                                f"{w_zero} vs created "
                                f"{self._zero_flags}"}, {}
                    w_drv = header.get("derived") or {}
                    if self._zero_flags is not None:
                        # tables were created from a worker's spec: the
                        # creator's derived set is authoritative, so the
                        # comparison is exact — a worker adding or
                        # omitting derived tables entirely is just as
                        # divergent as one redefining them
                        if w_drv != self.derived:
                            return {"error":
                                    f"init spec mismatch: derived "
                                    f"tables {w_drv} vs created "
                                    f"{self.derived}"}, {}
                    elif self.derived and w_drv and w_drv != self.derived:
                        # checkpoint-loaded: derived may legitimately be
                        # absent on one side (loads don't carry specs),
                        # so only a conflicting non-empty pair fails
                        return {"error":
                                f"init spec mismatch: derived tables "
                                f"{w_drv} vs created {self.derived}"}, {}
                    if not self.derived:
                        # checkpoint loads don't carry derived-table
                        # specs; adopt them from the first worker
                        self.derived = header.get("derived") or {}
                    self._stamp_nonspec_groups(header["specs"])
                now = time.monotonic()
                # claim TTL must comfortably cover a slow upload of a
                # multi-hundred-MB slice; expiry only matters when the
                # claimant DIED, so generous is safe (a live claimant's
                # init_arrays clears the claim)
                need = sorted(k for k in self._pending
                              if self._claims.get(k, 0.0) <= now)
                for k in need:
                    self._claims[k] = now + INIT_CLAIM_TTL
                return ({"ok": True, "known": not self._pending,
                         "need": need, "clock": self.clock}, {})
        if op == "init_arrays":
            # second phase of init_spec: slices for the `need` tables;
            # first worker's arrays win, duplicates are dropped
            with self._lock:
                for k, v in arrays.items():
                    if k in self._pending:
                        self.tables[k] = v.astype(np.float32)
                        self._pending.discard(k)
                        self._claims.pop(k, None)
                return {"ok": True, "known": not self._pending}, {}
        if op == "pull":
            since = header.get("since")
            if since is None:
                with self._lock:
                    self.num_pull += 1
                    _NUM_PULL.inc()
                    self._recompute_derived()
                    out = {k: v.copy() for k, v in self.tables.items()}
                    return {"ok": True, "clock": self.clock}, out
            with self._lock:
                self.num_pull += 1
                _NUM_PULL.inc()
                out = {}
                if since >= self.clock:
                    # nothing pushed since the caller last looked: skip
                    # both the derived recompute and the O(shard rows)
                    # version scans (ADVICE r3 — at 2^26 buckets each
                    # scan walks a 64M-element array); reply shape
                    # matches the scan path (empty idx + empty rows),
                    # INCLUDING the derived-table skip — a quiet shard
                    # that ships an empty `w` part while a dirty peer
                    # honors the skip would leave the client's merged
                    # `w` shorter than its merged index
                    skip = {k for k in (header.get("skip") or ())
                            if k in self.derived}
                    for g in self._ver:
                        out[_idx_name(g)] = np.empty(0, np.int64)
                    for k in self.tables:
                        if k in skip:
                            continue
                        out[k] = self.tables[k][:0]
                    return {"ok": True, "clock": self.clock}, out
                self._recompute_derived()
                sender = header.get("sender")
                use_kc = bool(header.get("kc")) and sender is not None
                wire = header.get("wire")
                if wire not in ("bf16", "int8", "int4"):
                    wire = None
                # derived-table wire skip: a client that can recompute a
                # derived table from its pulled sources asks us to omit
                # it. Honored ONLY for tables in self.derived — additive
                # state can never be silently dropped by a bad request.
                skip = {k for k in (header.get("skip") or ())
                        if k in self.derived}
                kdig_hit: dict[str, str] = {}
                kdig_full: dict[str, str] = {}
                for g, ver in self._ver.items():
                    if since >= self._log_start.get(g, self.clock):
                        parts = [i for c, i in self._pushlog[g]
                                 if c > since]
                        idx = (np.unique(np.concatenate(parts))
                               if parts else np.empty(0, np.int64))
                    else:
                        idx = np.flatnonzero(ver > since).astype(np.int64)
                    omit = False
                    if use_kc and idx.size:
                        dig, held = self._kc_pull_digest(sender, idx)
                        if held:
                            kdig_hit[str(g)] = dig
                            omit = True
                        else:
                            kdig_full[str(g)] = dig
                    if not omit:
                        out[_idx_name(g)] = idx
                    for k, rows in self.full_rows.items():
                        if rows == g:
                            if k in skip:
                                continue
                            vals = self.tables[k][idx]
                            if wire is not None and idx.size:
                                vals = self._wire_pull(sender, k, idx,
                                                       vals, wire,
                                                       header)
                            out[k] = vals
                resp = {"ok": True, "clock": self.clock}
                if kdig_hit:
                    resp["kdig"] = kdig_hit
                if kdig_full:
                    resp["kfull"] = kdig_full
                return resp, out
        if op == "push":
            with self._lock:
                # seq fence BEFORE the clock advance: a replayed push
                # (client journal re-sent after a reconnect) must be
                # acknowledged without re-applying the delta OR bumping
                # the clock — at-most-once apply is what makes the
                # client's blind replay safe
                sender, seq = header.get("sender"), header.get("seq")
                if sender is not None and seq is not None:
                    if seq <= self._last_seq.get(sender, 0):
                        _DEDUP_HITS.inc()
                        return ({"ok": True, "clock": self.clock,
                                 "dup": True}, {})
                idx_of = {g: arrays[_idx_name(g)]
                          for g in self._ver if _idx_name(g) in arrays}
                # resolve key-list digests BEFORE the fence advances: a
                # miss reply must leave fence and clock untouched so the
                # client's full resend (a fresh seq) is a clean first
                # send, not a dup
                kdig = header.get("kdig") or {}
                if kdig and sender is not None:
                    need = self._kc_resolve(sender, kdig, idx_of)
                    if need:
                        _KC_MISSES.inc(len(need))
                        return ({"ok": True, "clock": self.clock,
                                 "need_keys": need}, {})
                if sender is not None and seq is not None:
                    self._last_seq[sender] = int(seq)
                self.num_push += 1
                _NUM_PUSH.inc()
                self.clock += 1
                # uint32 stamp wrap would silently freeze rows as
                # never-dirty; unreachable in practice, but fail loudly
                # rather than go stale (ADVICE r3). An error REPLY (not
                # an assert): asserts vanish under python -O and an
                # exception here would just kill the connection thread
                # without ever telling the worker why.
                if self.clock >= 2**32 - 1:
                    return {"error":
                            "version clock exhausted (2^32 pushes)"}, {}
                dense_groups = set()
                for k, d in arrays.items():
                    if k.startswith("idx:"):
                        continue
                    if k not in self.tables:
                        return {"error": f"push to unknown table {k}"}, {}
                    if k in self.derived:
                        # non-additive derived tables ignore pushed deltas;
                        # they are recomputed from their additive sources
                        continue
                    g = self.full_rows[k]
                    idx = idx_of.get(g)
                    if idx is None:
                        self.tables[k] += d
                        dense_groups.add(g)
                    else:
                        # worker-side indices are unique (np.unique
                        # output), so fancy += is a correct scatter-add
                        self.tables[k][idx] += d
                for g, idx in idx_of.items():
                    self._ver[g][idx] = self.clock
                    if self._dirty.get(g) != "all":
                        self._dirty.setdefault(g, []).append(idx)
                    self._log_push(g, idx)
                # any dense-merged group is wholly dirty — including in a
                # MIXED frame where other groups carried idx arrays;
                # stamping per merged group (not only when NO idx exists)
                # keeps versioned pulls from missing dense rows
                # (ADVICE r3)
                for g in dense_groups:
                    self._ver[g][:] = self.clock
                    self._dirty[g] = "all"
                    self._reset_pushlog(g)
                return {"ok": True, "clock": self.clock}, {}
        if op == "save":
            path = self._save(header["base"], header.get("iter"))
            return {"ok": True, "path": path}, {}
        if op == "load":
            # IterScheduler::LoadModel parity (iter_solver.h:40-47): the
            # scheduler commands the server group to load a checkpoint;
            # each server takes its bucket-range slice straight from the
            # filesystem — the model never crosses the worker wire.
            with self._lock:
                if self.tables:
                    return {"error": "load into a non-empty server "
                                     "(command load before workers init)"
                            }, {}
                try:
                    self._load(header["base"], header.get("iter"))
                except Exception as e:
                    # an error REPLY, not an escaped exception: a typo'd
                    # model_in must surface as "no such checkpoint" at
                    # the scheduler, not as a dead-connection mystery at
                    # the workers
                    self.tables.clear()
                    return {"error": f"checkpoint load failed: {e}"}, {}
                return {"ok": True, "clock": self.clock}, {}
        if op == "stats":
            with self._lock:
                return {"ok": True, "num_push": self.num_push,
                        "num_pull": self.num_pull, "clock": self.clock,
                        "tables": {k: list(v.shape)
                                   for k, v in self.tables.items()}}, {}
        if op == "shutdown":
            return {"ok": True}, {}
        return {"error": f"unknown op {op!r}"}, {}

    # caps: logged row-indices AND entry count per group; beyond either
    # the oldest entries fall off and pulls older than the floor use the
    # scan (the entry cap stops tiny-push streams from growing the log
    # into an O(total pushes) python walk per pull)
    _LOG_ELEM_CAP = 1 << 23
    _LOG_ENTRY_CAP = 4096

    def _log_push(self, g: int, idx) -> None:
        """Record a sparse push for O(pushed) pulls (lock held)."""
        arr = np.asarray(idx, np.int64)
        if arr.size == 0:
            return  # nothing dirtied in this shard's range
        self._pushlog[g].append((self.clock, arr))
        self._log_elems[g] += arr.size
        while ((self._log_elems[g] > self._LOG_ELEM_CAP
                or len(self._pushlog[g]) > self._LOG_ENTRY_CAP)
               and len(self._pushlog[g]) > 1):
            c, old = self._pushlog[g].pop(0)
            self._log_elems[g] -= old.size
            self._log_start[g] = c

    def _reset_pushlog(self, g: int) -> None:
        """Version stamps changed outside push (load/spec stamp): the
        log no longer covers history before this clock (lock held)."""
        self._pushlog[g] = []
        self._log_start[g] = self.clock
        self._log_elems[g] = 0

    # key-cache caps: key lists cached per sender (push side) and
    # digests assumed still client-held (pull side). The known-cap is
    # deliberately below the client's own LRU cap so digest-only pull
    # replies are nearly always reconstructible client-side; the
    # client's full-re-pull fallback covers the rest.
    _KC_CAP = 32
    _KC_KNOWN_CAP = 8

    def _kc_resolve(self, sender: str, kdig: dict, idx_of: dict) -> list:
        """Adopt/resolve a push's key-list digests (lock held): a group
        whose idx array rode the frame is cached under its digest; a
        digest-only group is resolved from the cache into `idx_of`.
        Returns the groups whose digest is unknown (cache miss — the
        caller replies need_keys without applying anything)."""
        cache = self._kc_idx.setdefault(sender, collections.OrderedDict())
        known = self._kc_known.setdefault(sender, collections.OrderedDict())
        need = []
        for gs, dig in kdig.items():
            g = int(gs)
            if g in idx_of:
                # full send: adopt the key list, and remember the sender
                # holds it (it hashed its own idx) so pull replies with
                # the same key set can go digest-only
                cache[dig] = np.ascontiguousarray(idx_of[g], np.int64)
                cache.move_to_end(dig)
                known[dig] = True
                known.move_to_end(dig)
            else:
                hit = cache.get(dig)
                if hit is None:
                    need.append(gs)
                else:
                    cache.move_to_end(dig)
                    idx_of[g] = hit
                    _KC_HITS.inc()
        while len(cache) > self._KC_CAP:
            cache.popitem(last=False)
        while len(known) > self._KC_KNOWN_CAP:
            known.popitem(last=False)
        return need

    def _kc_pull_digest(self, sender: str,
                        idx: np.ndarray) -> tuple[str, bool]:
        """Pull-reply half of the key cache (lock held): returns
        (digest, held) — `held` means the sender provably has this key
        list, so the reply may omit the idx array; otherwise the reply
        ships idx + digest so the client caches it for next time."""
        dig = key_digest(idx)
        known = self._kc_known.setdefault(sender, collections.OrderedDict())
        if dig in known:
            known.move_to_end(dig)
            _KC_HITS.inc()
            return dig, True
        known[dig] = True
        while len(known) > self._KC_KNOWN_CAP:
            known.popitem(last=False)
        return dig, False

    def _wire_pull(self, sender, k: str, idx: np.ndarray,
                   vals: np.ndarray, wire: str, header: dict) -> QuantRows:
        """Quantize a versioned-pull reply's rows (wire codec v2, lock
        held). With `wire_ef` and a named sender the per-(sender, table)
        EFQuant folds prior quantization error of these rows back in;
        pulls are absolute-value refreshes, so a reply lost on the wire
        is corrected by the sender's next pull, never double-counted."""
        if header.get("wire_ef") and sender is not None:
            efq = self._efq.setdefault(sender, {}).setdefault(
                k, EFQuant(wire))
            return efq.apply(idx, vals)
        return quantize_rows(vals, wire)

    def _kc_invalidate(self) -> None:
        """Recovery-path cache discard (snapshot restore / checkpoint
        load): a rolled-back server must not resolve pre-crash digests
        (lock held)."""
        if self._kc_idx or self._kc_known:
            _KC_INVALIDATIONS.inc()
        self._kc_idx = {}
        self._kc_known = {}
        # pull-EF residuals roll back with the tables they corrected
        self._efq = {}

    def _recompute_derived(self) -> None:
        """Recompute derived tables from their additive sources over the
        rows dirtied since the last recompute (caller holds the lock).
        FTRL's w is soft-threshold-nonlinear in (z, n), so additively
        merged worker deltas cannot represent it: a key whose merged z
        crosses the L1 threshold must re-solve the prox even though
        every worker pushed delta-w = 0. Restricting the prox to dirty
        rows keeps server work O(touched keys), not O(table)."""
        for k, spec in self.derived.items():
            g = self.full_rows[k]
            dirty = self._dirty.get(g)
            if dirty == []:
                continue
            if spec["kind"] != "ftrl_prox":
                raise ValueError(f"unknown derived kind {spec['kind']!r}")
            if dirty == "all":
                u = slice(None)
            else:
                u = np.unique(np.concatenate(dirty))
                if u.size == 0:
                    continue
            self.tables[k][u] = ftrl_prox_rows(
                spec, self.tables["z"][u], self.tables["n"][u])
        for g in self._dirty:
            self._dirty[g] = []

    def _load(self, base: str, it: Optional[int]) -> None:
        """Create this shard's tables from a checkpoint (caller holds the
        lock). When the checkpoint was written by a same-world server
        group, this server reads ONLY its own `_part-<rank>` file (the
        __full_rows__ tag each part carries says the full table sizes);
        on any shard-count mismatch it falls back to concatenating all
        parts and slicing its range. Every loaded row that differs from
        the zero init is version-stamped, so a worker that initializes to
        zeros and pulls since=0 receives exactly the model's nonzero
        rows — O(model nnz) wire, not O(table). Rows of NON-zero-init
        tables (e.g. difacto's seeded V) can differ from the load even
        where the load is zero; init_spec stamps those groups fully when
        a worker's spec names them (see _stamp_nonspec_groups)."""
        import glob
        from wormhole_tpu_torch.utils.checkpoint import (load_parts, part_name,
                                                   save_prefix)

        own = part_name(base, it if (it is not None and it >= 0) else None,
                        self.rank) + ".npz"
        prefix = save_prefix(base, it if (it is not None and it >= 0)
                             else None)
        npeers = len(glob.glob(prefix + "_part-*.npz"))
        shard_arrays = None
        if npeers == self.world and os.path.exists(own):
            got = dict(np.load(own))
            meta = got.pop("__full_rows__", None)
            if meta is not None:
                self.full_rows = {
                    k: int(n) for k, n in
                    json.loads(bytes(meta.tobytes()).decode()).items()}
                shard_arrays = got
        if shard_arrays is None:
            arrays = load_parts(base, it)
            self.full_rows = {k: int(v.shape[0])
                              for k, v in arrays.items()}
            shard_arrays = {}
            for k, v in arrays.items():
                lo, hi = shard_range(v.shape[0], self.rank, self.world)
                shard_arrays[k] = np.ascontiguousarray(v[lo:hi],
                                                       np.float32)
        self._full_shapes = {
            k: [self.full_rows[k], *v.shape[1:]]
            for k, v in shard_arrays.items()}
        self._loaded = True
        self._kc_invalidate()
        # a pre-load init_spec may have left pending/claim state; the
        # checkpoint supersedes it (a late init_arrays must not
        # overwrite loaded tables)
        self._pending = set()
        self._claims = {}
        self._zero_flags = None
        for k, v in shard_arrays.items():
            # np.array (not ascontiguousarray): decoded wire arrays are
            # read-only zero-copy views and tables get merged in place
            self.tables[k] = np.array(v, np.float32)
        self._create_group_meta()
        self.clock = 1
        for g, ver in self._ver.items():
            nz = None
            for k, rows in self.full_rows.items():
                if rows != g:
                    continue
                t_nz = self.tables[k] != 0
                if t_nz.ndim > 1:
                    t_nz = t_nz.any(axis=tuple(range(1, t_nz.ndim)))
                nz = t_nz if nz is None else (nz | t_nz)
            if nz is not None:
                ver[nz] = self.clock
            # stamps bypassed the push log: pulls older than this clock
            # must take the scan path
            self._reset_pushlog(g)

    def _stamp_nonspec_groups(self, specs: dict) -> None:
        """After a checkpoint load, groups holding non-zero-init tables
        must be stamped wholly dirty the first time a worker's init spec
        names them: the worker's seeded init differs from the loaded
        values even at loaded-zero rows, so only a full-group pull makes
        its base mirror coherent (caller holds the lock)."""
        if not self._loaded:
            return
        for k, s in specs.items():
            if s.get("zero", True) or k in self.derived:
                continue
            g = self.full_rows.get(k)
            if g is None or g in self._stamped_all:
                continue
            self._ver[g][:] = self.clock
            self._reset_pushlog(g)
            self._stamped_all.add(g)

    def _save(self, base: str, it: Optional[int]) -> str:
        import glob
        import re

        from wormhole_tpu_torch.utils.checkpoint import (atomic_savez, part_name,
                                                   save_prefix)

        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        with self._lock:
            self._recompute_derived()
            tables = {k: v.copy() for k, v in self.tables.items()}
        prefix = save_prefix(base, it)
        if self.rank == 0:
            # remove stale files from a previous save with a different
            # shard count (the invariant utils/checkpoint.save_model
            # keeps): only rank 0 cleans, and only files NO current
            # server writes, so concurrent part writes are never raced
            if self.world > 1 and os.path.exists(prefix + ".npz"):
                os.remove(prefix + ".npz")
            for old in glob.glob(prefix + "_part-*.npz"):
                r = int(re.search(r"_part-(\d+)\.npz$", old).group(1))
                if r >= self.world or self.world <= 1:
                    os.remove(old)
        if self.world <= 1:
            path = prefix + ".npz"
        else:
            path = part_name(base, it, self.rank) + ".npz"
        # __full_rows__ tag: lets a same-world server reload ONLY its own
        # part (ServerNode._load fast path); load_parts skips "__" keys
        tables["__full_rows__"] = np.frombuffer(
            json.dumps(self.full_rows).encode(), np.uint8).copy()
        atomic_savez(path, compressed=True, **tables)
        return path

    # -- hot-restore snapshots ----------------------------------------------
    def start_snapshots(self, base: str, every_sec: float) -> None:
        """Write `snapshot()` to `<base>_part-<rank>.npz` every
        `every_sec` seconds on a daemon thread — off the request path, so
        the only request-visible cost is the brief copy under the lock."""
        self._snap_base = base
        self._snap_every = float(every_sec)
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)

        def loop():
            while not self._shutdown.wait(self._snap_every):
                try:
                    self.snapshot()
                except Exception as e:  # keep snapshotting best-effort
                    print(f"[ps server {self.rank}] snapshot failed: {e}",
                          flush=True)

        self._snap_thread = threading.Thread(target=loop, daemon=True)
        self._snap_thread.start()

    def snapshot(self) -> Optional[str]:
        """One epoch-stamped shard snapshot (atomic temp+rename write).
        Unlike `_save` checkpoints this also captures the clock, the seq
        fence, and the table metadata a respawned server needs to resume
        MID-training without a worker re-init. Skips when no push landed
        since the last snapshot or tables aren't fully created yet."""
        t0 = time.perf_counter()
        path = self._snapshot_impl()
        if path is not None:
            dur = time.perf_counter() - t0
            _SNAPSHOT_S.observe(dur)
            _SNAPSHOTS.inc()
            if _trace.ACTIVE is not None:
                _trace.ACTIVE.emit_span(
                    "ps.snapshot", "ps", time.monotonic() - dur, dur,
                    {"rank": self.rank, "clock": self._snap_clock})
        return path

    def _snapshot_impl(self) -> Optional[str]:
        from wormhole_tpu_torch.utils import manifest as _manifest
        from wormhole_tpu_torch.utils.checkpoint import atomic_savez, part_name

        with self._lock:
            if (not self.tables or self._pending
                    or self.clock == self._snap_clock):
                return None
            self._recompute_derived()
            arrays = {k: v.copy() for k, v in self.tables.items()}
            meta = {
                "clock": self.clock,
                "epoch": self.epoch,
                "world": self.world,
                "full_rows": self.full_rows,
                "derived": self.derived,
                "last_seq": self._last_seq,
                "full_shapes": self._full_shapes,
                "zero_flags": self._zero_flags,
            }
            clock = self.clock
            full_rows = dict(self.full_rows)
        arrays["__snap__"] = np.frombuffer(
            json.dumps(meta).encode(), np.uint8).copy()
        base = self._snap_base or "ps_snap"
        path = part_name(base, None, self.rank) + ".npz"
        atomic_savez(path, compressed=True, **arrays)
        # publish the finished part in the snapshot-set manifest so
        # readers (restore on a respawn, the serving watcher) discover a
        # digest-verified consistent set instead of globbing — closing
        # the torn-read window where a reader pairs this rank's fresh
        # part with a half-replaced peer's
        _manifest.update_manifest(base, self.rank, self.world, path,
                                  clock, self.epoch, full_rows)
        # only advance the skip-fence after the write landed; re-take the
        # lock because restore_snapshot writes it from the serving threads
        with self._lock:
            self._snap_clock = clock
        return path

    def restore_snapshot(self, base: str) -> bool:
        """Rebuild this shard from its snapshot file; returns False when
        none exists (a server dying before its first snapshot restarts
        empty and waits for worker init like a fresh process). The
        restored clock is re-stamped onto every nonzero row so a worker
        pulling with a pre-crash `since` below it receives every row the
        snapshot knows (a superset of what it missed — over-delivery is
        safe, under-delivery would desync the base mirror)."""
        from wormhole_tpu_torch.utils import manifest as _manifest
        from wormhole_tpu_torch.utils.checkpoint import part_name

        self._snap_base = base
        path = part_name(base, None, self.rank) + ".npz"
        got = None
        # manifest-first: read the digest-verified part the manifest
        # names (a peer may be mid-replace — retry a couple of times on
        # a torn read, each time against a fresh manifest)
        man = _manifest.read_manifest(base)
        if man is not None and str(self.rank) in man.get("parts", {}):
            for _ in range(3):
                try:
                    got = _manifest.read_part(base, man, self.rank)
                    break
                except _manifest.TornSnapshot as e:
                    print(f"[ps server {self.rank}] torn snapshot read "
                          f"({e}); retrying", flush=True)
                    time.sleep(0.05)
                    man = _manifest.read_manifest(base) or man
        if got is None:
            # pre-manifest snapshot dirs (or a manifest that never saw
            # this rank): fall back to the direct part path
            if not os.path.exists(path):
                return False
            got = dict(np.load(path))
        meta = json.loads(bytes(got.pop("__snap__").tobytes()).decode())
        with self._lock:
            self.tables = {k: np.ascontiguousarray(v, np.float32)
                           for k, v in got.items()}
            self.full_rows = {k: int(n)
                              for k, n in meta["full_rows"].items()}
            self.derived = meta["derived"] or {}
            self._last_seq = {k: int(v)
                              for k, v in (meta["last_seq"] or {}).items()}
            self._full_shapes = meta["full_shapes"]
            self._zero_flags = meta["zero_flags"]
            self._pending = set()
            self._claims = {}
            self._kc_invalidate()
            self._create_group_meta()
            self.clock = int(meta["clock"])
            self._snap_clock = self.clock
            for g, ver in self._ver.items():
                nz = None
                for k, rows in self.full_rows.items():
                    if rows != g:
                        continue
                    t_nz = self.tables[k] != 0
                    if t_nz.ndim > 1:
                        t_nz = t_nz.any(axis=tuple(range(1, t_nz.ndim)))
                    nz = t_nz if nz is None else (nz | t_nz)
                if nz is not None:
                    ver[nz] = self.clock
                self._reset_pushlog(g)
            self._loaded = True
            self._stamped_all = set()
        _RESTORES.inc()
        _RESTORE_EPOCH.set(self.epoch)
        _trace.event("ps.restore", cat="recovery", rank=self.rank,
                     clock=self.clock, epoch=self.epoch)
        print(f"[ps server {self.rank}] restored snapshot {path} "
              f"(clock {self.clock}, epoch {self.epoch})", flush=True)
        return True


# ---------------------------------------------------------------- client
class PSClient:
    """Worker-side stub over all servers: splits each table by the
    servers' row ranges, keeps one persistent connection per server.
    Tracks wire bytes (bytes_push / bytes_pull, both directions) so the
    sparse-wire claim — bytes/sync proportional to touched keys — is a
    measured quantity, not an assumption.

    Recovery (all opt-in; the defaults reproduce the original fail-fast
    behavior exactly): with `retry_deadline > 0` a failed RPC is retried
    with backoff against a (possibly respawned) server instead of
    raising. `sender` names this worker for the servers' seq fence —
    every push is stamped with a per-server sequence number and journaled
    (last `journal_len` pushes per server), so on reconnect the client
    replays the journal entries the server's `hello` reports as
    unapplied; the fence makes over-replay harmless. `resolver`, when
    given, re-resolves the server URI list on each reconnect attempt (a
    respawned server binds a NEW port and re-announces it through the
    scheduler). A reply whose `epoch` exceeds the last seen one marks the
    server rolled-back; the next pull_sparse turns into a since=0 re-pull
    so the base mirror re-adopts the restored state."""

    # client-side key-list LRU cap: above the server's _KC_KNOWN_CAP so
    # a digest-only pull reply is nearly always reconstructible here
    _KC_CLIENT_CAP = 64

    def __init__(self, uris: list[str], connect_deadline: float = 30.0,
                 sender: Optional[str] = None, retry_deadline: float = 0.0,
                 resolver: Optional[Callable[[], Optional[list[str]]]] = None,
                 journal_len: int = 64, keycache: Optional[bool] = None):
        self.uris = list(uris)
        self.world = len(uris)
        self._socks: list[Optional[socket.socket]] = [None] * self.world
        self._files = [None] * self.world
        self.connect_deadline = connect_deadline
        self.full_rows: dict[str, int] = {}
        self.bytes_push = 0
        self.bytes_pull = 0
        self.bytes_init = 0
        self.sender = sender
        self.retry_deadline = float(retry_deadline)
        self.resolver = resolver
        # per-server push seq numbers + journal of recent pushes
        # (seq, header, arrays, fixed_bytes, compress); journaled only
        # when retry is enabled so the default path pays no copies
        self._seq = [0] * self.world
        self._journal: list = [collections.deque(maxlen=max(journal_len, 1))
                               for _ in range(self.world)]
        self._epochs: list[Optional[int]] = [None] * self.world
        self._rolled_back = [False] * self.world
        self.num_retries = 0
        # KEY_CACHING filter, client half (default from WH_KEYCACHE):
        # per-server LRU of digest -> shard-local idx (content-addressed;
        # fed by our own full pushes AND full pull replies) plus the
        # digests each server has ack'd receiving, so repeat pushes ship
        # digest + values only
        self.keycache = (_env_flag("WH_KEYCACHE") if keycache is None
                         else bool(keycache))
        # hello-negotiated frame compression (WH_NET_COMPRESS): when the
        # knob is set here, every fresh connection's hello offers it and
        # _fc[r] latches the server's ack — from then on every frame to
        # that server ships zlib'd (replies ride the server's fc flag).
        # _fc holds False / True(zlib) / "zlib" / "bshuf" — whatever
        # mode the server latched feeds send_frame's `compress` arg.
        self.net_compress = _env_flag("WH_NET_COMPRESS")
        self._fc = [False] * self.world
        # wire codec v2 (WH_WIRE / WH_WIRE_EF / WH_WIRE_COMP): the value
        # encoding pushes carry and pulls request, whether error
        # feedback is on (default yes — low-bit encodings without it
        # bias convergence), and the negotiated frame compression mode.
        # _wc[r] latches the server's `wire` capability ack: only an
        # acked connection receives QuantRows encodings or quantized
        # pull replies; an un-acked (older) peer keeps the legacy
        # scalar fixed_bytes forms (see SyncedStore._quantize_deltas).
        self.wire_enc = (os.environ.get("WH_WIRE") or "raw").strip().lower()
        if self.wire_enc not in WIRE_ENCODINGS:
            raise ValueError(f"WH_WIRE={self.wire_enc!r}: expected one "
                             f"of {WIRE_ENCODINGS}")
        ef = os.environ.get("WH_WIRE_EF")
        self.wire_ef = (True if ef is None
                        else ef.lower() not in ("", "0", "false", "off"))
        self.wire_comp = (os.environ.get("WH_WIRE_COMP") or "").strip().lower()
        if self.wire_comp not in WIRE_COMP_MODES:
            raise ValueError(f"WH_WIRE_COMP={self.wire_comp!r}: expected "
                             f"one of {WIRE_COMP_MODES}")
        self._wc = [False] * self.world
        self._kc_idx = [collections.OrderedDict()
                        for _ in range(self.world)]
        self._kc_pushed = [collections.OrderedDict()
                           for _ in range(self.world)]
        self.kc_hits = 0
        self.kc_misses = 0
        # byte/hit tallies are written from pool threads during fanned
        # pushes/pulls; a plain int += is a load-add-store race
        self._stats_lock = threading.Lock()
        # per-server RPC fan-out pool, created on first multi-server
        # push/pull (one socket per server, per-rank client state — the
        # only shared mutables are behind _stats_lock)
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # hedged pulls (WH_HEDGE): None when off, so the per-attempt
        # cost of the feature is one attribute check
        self._hedge = _overload.hedge_tracker()

    def _hello_offer(self) -> dict:
        """Per-connection negotiation flags a hello should carry:
        legacy zlib compression, the wire-codec capability ask, and the
        requested frame-compression mode. Empty when every knob is at
        its default (the hello is then skipped on the fast path)."""
        offer: dict = {}
        if self.net_compress:
            offer["net_compress"] = 1
        if self.wire_enc != "raw":
            offer["wire"] = 1
        if self.wire_comp:
            offer["wire_comp"] = self.wire_comp
        return offer

    def _latch_hello(self, r: int, h: dict) -> None:
        """Adopt a hello reply's negotiation acks for connection r: the
        frame-compression mode (string modes win over legacy zlib) and
        the wire-codec capability. An older server acks neither and the
        connection degrades to raw framing + legacy scalar encodings."""
        self._fc[r] = (h.get("wire_comp")
                       if h.get("wire_comp") in ("zlib", "bshuf")
                       else bool(h.get("net_compress")))
        self._wc[r] = bool(h.get("wire"))

    def _file(self, r: int):
        if self._files[r] is None:
            host, port = self.uris[r].rsplit(":", 1)
            s = connect_with_retry((host, int(port)), self.connect_deadline)
            self._socks[r] = s
            self._files[r] = s.makefile("rwb")
            offer = self._hello_offer()
            if offer:
                # negotiate before any payload frame: the server arms
                # its side of the connection on this hello and the ack
                # arms ours; an old/default server simply doesn't ack
                # and the connection stays raw
                f = self._files[r]
                send_frame(f, dict({"op": "hello", "sender": self.sender},
                                   **offer))
                got = recv_frame(f)
                if got is None:
                    raise ConnectionResetError(
                        "connection closed during negotiation hello")
                self._latch_hello(r, got[0])
        return self._files[r]

    def _attempt(self, r: int, header: dict, arrays, fixed_bytes: int,
                 compress: bool) -> tuple[dict, dict, int, int]:
        """One send/recv round against server r; OSError (including the
        ConnectionResetError recv_frame's None maps to) means the
        connection is dead."""
        f = self._file(r)
        sent = send_frame(f, header, arrays, fixed_bytes,
                          compress or self._fc[r])
        got = recv_frame(f)
        if got is None:
            raise ConnectionResetError("connection closed mid-rpc")
        h, arrs, received = got
        return h, arrs, sent, received

    def _attempt_hedged(self, r: int, header: dict, arrays,
                        fixed_bytes: int,
                        compress: bool) -> tuple[dict, dict, int, int]:
        """A pull attempt with tail insurance (WH_HEDGE): after the
        rolling-quantile delay a backup copy of the frame goes out on a
        fresh ephemeral connection. Pulls are idempotent reads with no
        seq fence, so the duplicate is harmless by construction; the
        budget (WH_HEDGE_BUDGET_PCT) bounds the extra load. Gated off
        for non-pull ops and under keycache/compression/wire-codec,
        whose per-connection negotiated state a second connection would
        not share (a hedged wire-codec pull would also advance the
        server's pull-EF residuals twice for the same rows). If the backup answers first it severs the pooled socket
        so the primary's blocked recv turns into the error path, which
        hands back the backup's reply."""
        delay = (self._hedge.delay_s() if self._hedge is not None
                 and header.get("op") == "pull"
                 and not self.keycache and not self.net_compress
                 and self.wire_enc == "raw" and not self.wire_comp
                 and not compress else None)
        if delay is None:
            return self._attempt(r, header, arrays, fixed_bytes, compress)
        done = threading.Event()
        lock = threading.Lock()
        state: dict = {}

        def fire():
            if done.is_set() or not self._hedge.try_issue():
                return
            try:
                host, port = self.uris[r].rsplit(":", 1)
                sock = connect_with_retry((host, int(port)), 1.0)
                try:
                    f = sock.makefile("rwb")
                    sent = send_frame(f, header, arrays, fixed_bytes,
                                      False)
                    got = recv_frame(f)
                    if got is None or got[0].get("busy"):
                        return  # dead or busy backup: primary decides
                    h, arrs, received = got
                    with lock:
                        if not done.is_set():
                            state["reply"] = (h, arrs, sent, received)
                            s = self._socks[r]
                            if s is not None:
                                try:
                                    s.shutdown(socket.SHUT_RDWR)
                                except OSError:
                                    pass
                finally:
                    try:
                        sock.close()
                    except OSError:
                        pass
            except Exception:
                pass  # best-effort tail insurance; the primary decides

        timer = threading.Timer(delay, fire)
        timer.daemon = True
        timer.start()
        try:
            t0 = time.monotonic()
            got = self._attempt(r, header, arrays, fixed_bytes, compress)
            with lock:
                done.set()
            self._hedge.observe(time.monotonic() - t0)
            return got
        except OSError:
            with lock:
                done.set()
                if "reply" in state:
                    self._hedge.won()
                    # the pooled connection was severed to unblock us;
                    # drop it so the next RPC redials cleanly
                    self.close(r)
                    return state["reply"]
            raise
        finally:
            timer.cancel()

    def _note_epoch(self, r: int, h: dict) -> None:
        ep = h.get("epoch")
        if ep is None:
            return
        last = self._epochs[r]
        if last is not None and ep > last:
            # the server restarted and restored a snapshot: its state
            # rolled back to the snapshot clock. Flag it so the next
            # versioned pull re-adopts the full restored state.
            self._rolled_back[r] = True
            _ROLLBACKS.inc()
            _trace.event("ps.rollback", cat="recovery", server=r,
                         epoch_from=last, epoch_to=ep)
            print(f"[ps-retry] server {r} epoch {last} -> {ep}: "
                  "rolled back to its last snapshot; scheduling a "
                  "full re-pull", flush=True)
        self._epochs[r] = ep

    def _rpc(self, r: int, header: dict, arrays=None, fixed_bytes: int = 0,
             compress: bool = False, journal_arrays=None):
        if compress:
            header = dict(header, comp_reply=1)
        op_name = header.get("op", "?")
        if (op_name == "push" and self.sender is not None
                and "seq" not in header):
            # stamp the fence ONCE per logical push (a retried replay
            # reuses the stamp — that's what the dedup keys on)
            self._seq[r] += 1
            header = dict(header, sender=self.sender, seq=self._seq[r])
        t_rpc = time.monotonic()
        recovered = False
        # a saturated server answers `busy` without dispatching;
        # resending the same stamped frame is exactly-once, so back off
        # under the unified full-jitter policy (the budget caps each
        # sleep to the window and counts it) — bounded so a wedged
        # server still fails loudly instead of spinning forever
        busy_budget = None
        while True:
            try:
                h, arrs, sent, received = self._attempt_hedged(
                    r, header, arrays, fixed_bytes, compress)
                if h.get("busy"):
                    if busy_budget is None:  # minted on first bounce only
                        busy_budget = _retrylib.RetryBudget(
                            max(self.retry_deadline, 60.0), op="ps.busy")
                    if busy_budget.expired:
                        raise RuntimeError(
                            f"ps server {self.uris[r]} still busy after "
                            f"{time.monotonic() - t_rpc:.0f}s of backoff "
                            f"during '{op_name}'")
                    busy_backoff(h, busy_budget)
                    continue
                break
            except OSError as e:
                self.close(r)
                if self.retry_deadline <= 0 or op_name == "shutdown":
                    if isinstance(e, ConnectionResetError):
                        raise ConnectionResetError(
                            f"ps server {self.uris[r]} closed the "
                            f"connection during '{op_name}' — the server "
                            "process likely died; the job must be "
                            "restarted (resume from the last _iter-K "
                            "checkpoint)") from e
                    raise ConnectionError(
                        f"ps server {self.uris[r]} unreachable during "
                        f"'{op_name}' ({e}) — the server process likely "
                        "died; the job must be restarted (resume from "
                        "the last _iter-K checkpoint)") from e
                self._recover(r, op_name, e)
                recovered = True
        dur = time.monotonic() - t_rpc
        _RPC_S.observe(dur)
        if _trace.ACTIVE is not None:
            _trace.ACTIVE.emit_span(f"rpc.{op_name}", "rpc", t_rpc, dur,
                                    {"server": r})
        if recovered and op_name == "push" and self.sender is not None:
            # the in-flight push re-sent after a reconnect is itself a
            # replay: count it, and whether the fence absorbed it
            _REPLAYS.inc()
            if h.get("dup"):
                _REPLAY_DEDUP.inc()
        if "error" in h:
            raise RuntimeError(f"ps server error: {h['error']}")
        self._note_epoch(r, h)
        op = header.get("op")
        if op == "push":
            with self._stats_lock:
                self.bytes_push += sent + received
            _BYTES_PUSH.inc(sent + received)
            if (self.retry_deadline > 0 and self.sender is not None
                    and not h.get("need_keys")):
                # journal the FULL-keys form (journal_arrays) so a
                # replay after a reconnect is self-contained even when
                # the original frame shipped digest-only; a need_keys
                # miss reply applied nothing, so the full resend (not
                # this frame) is what gets journaled
                self._journal[r].append(
                    (header["seq"], header, journal_arrays or arrays,
                     fixed_bytes, compress))
        elif op == "pull":
            with self._stats_lock:
                self.bytes_pull += sent + received
            _BYTES_PULL.inc(sent + received)
        elif op in ("init", "init_spec", "init_arrays"):
            with self._stats_lock:
                self.bytes_init += sent + received
        return h, arrs

    def _recover(self, r: int, op_name: str, err: Exception) -> None:
        """Reconnect to server r (re-resolving its URI when a resolver
        is available), fence with `hello`, and replay unacked journaled
        pushes. Raises with the resume guidance once `retry_deadline`
        is exhausted."""
        budget = _retrylib.RetryBudget(self.retry_deadline, base_s=0.25,
                                       cap_s=2.0, op="ps.recover")
        print(f"[ps-retry] server {r} ({self.uris[r]}) failed during "
              f"'{op_name}' ({err}); retrying for up to "
              f"{self.retry_deadline:.0f}s", flush=True)
        while True:
            if budget.expired:
                budget.give_up(ConnectionError(
                    f"ps server {self.uris[r]} unreachable during "
                    f"'{op_name}' and did not come back within "
                    f"{self.retry_deadline:.0f}s — the job must be "
                    "restarted (resume from the last _iter-K checkpoint)"))
            budget.sleep()
            try:
                if self.resolver is not None:
                    uris = self.resolver()
                    if uris and len(uris) == self.world:
                        # atomic rebind of a complete snapshot: racing
                        # fan threads each publish a full resolved list
                        self.uris = list(uris)  # wormsan: allow=race
                self.close(r)
                host, port = self.uris[r].rsplit(":", 1)
                s = connect_with_retry(
                    (host, int(port)),
                    deadline_s=min(2.0, max(budget.remaining, 0.1)))
                self._socks[r] = s
                self._files[r] = s.makefile("rwb")
                hello = dict({"op": "hello", "sender": self.sender},
                             **self._hello_offer())
                h, _, _, _ = self._attempt(r, hello, None, 0, False)
                self._latch_hello(r, h)
                self._note_epoch(r, h)
                with self._stats_lock:  # shared tally; fan threads race
                    self.num_retries += 1
                _RETRIES.inc()
                _trace.event("ps.reconnect", cat="recovery", server=r,
                             uri=self.uris[r], epoch=self._epochs[r])
                if self.keycache and (self._kc_pushed[r]
                                      or self._kc_idx[r]):
                    # the peer may be a fresh/restored process whose key
                    # cache died with the old one: drop both directions
                    # for this rank (correctness never depended on the
                    # cache; the next syncs re-prime it)
                    _KC_INVALIDATIONS.inc()
                    self._kc_pushed[r].clear()
                    self._kc_idx[r].clear()
                applied = int(h.get("last_seq", 0))
                replay = [e for e in self._journal[r] if e[0] > applied]
                # the RPC being retried is re-sent by _rpc after we
                # return; when it is itself an unapplied push, don't
                # count it lost
                in_flight = int(op_name == "push" and self.sender is not None
                                and self._seq[r] > applied)
                if (self.sender is not None
                        and self._seq[r] > applied + len(replay) + in_flight):
                    # pushes older than the journal window were lost with
                    # the dead server and cannot be replayed; the
                    # snapshot bounds the loss — warn, don't die (the
                    # merged model self-corrects like any bounded-
                    # staleness overwrite)
                    print(f"[ps-retry] server {r}: "
                          f"{self._seq[r] - applied - len(replay)} "
                          "pushes predate the journal window and are "
                          "lost to the rollback", flush=True)
                for seq, hdr, arrs, fb, comp in replay:
                    rh, _, _, _ = self._attempt(r, hdr, arrs, fb, comp)
                    if "error" in rh:
                        raise RuntimeError(
                            f"ps server error on replay: {rh['error']}")
                    _REPLAYS.inc()
                    if rh.get("dup"):
                        _REPLAY_DEDUP.inc()
                if replay:
                    print(f"[ps-retry] server {r}: replayed "
                          f"{len(replay)} journaled pushes "
                          f"(server had seq {applied})", flush=True)
                print(f"[ps-retry] server {r} reconnected at "
                      f"{self.uris[r]} (epoch {self._epochs[r]})",
                      flush=True)
                budget.succeeded()
                return
            except (OSError, ConnectionError) as e2:
                self.close(r)
                err = e2

    def rehello(self, mepoch: Optional[int] = None) -> None:
        """Absorb a membership-epoch bump: the WORKER set changed (a
        peer joined or left) while the server group stayed fixed, so the
        shard map is untouched — but this process may be the one that
        just came back from a partition, sitting on half-dead sockets
        whose next frame would ride a stale connection. Re-handshake
        every server: close, reconnect, hello (latching compression +
        the server's restore epoch), and replay any journaled pushes the
        server's `last_seq` reports unapplied. The seq fence makes the
        replay exactly-once, so calling this when nothing was actually
        lost is merely a round of hellos."""
        for r in range(self.world):
            try:
                self.close(r)
                host, port = self.uris[r].rsplit(":", 1)
                s = connect_with_retry((host, int(port)),
                                       self.connect_deadline)
                self._socks[r] = s
                self._files[r] = s.makefile("rwb")
                hello = dict({"op": "hello", "sender": self.sender},
                             **self._hello_offer())
                h, _, _, _ = self._attempt(r, hello, None, 0, False)
                self._latch_hello(r, h)
                self._note_epoch(r, h)
                _REHELLOS.inc()
                applied = int(h.get("last_seq", 0))
                replay = [e for e in self._journal[r] if e[0] > applied]
                for seq, hdr, arrs, fb, comp in replay:
                    rh, _, _, _ = self._attempt(r, hdr, arrs, fb, comp)
                    if "error" in rh:
                        raise RuntimeError(
                            f"ps server error on replay: {rh['error']}")
                    _REPLAYS.inc()
                    if rh.get("dup"):
                        _REPLAY_DEDUP.inc()
                if replay:
                    print(f"[ps-retry] rehello (mepoch {mepoch}): server "
                          f"{r} replayed {len(replay)} journaled pushes "
                          f"(server had seq {applied})", flush=True)
            except (OSError, ConnectionError) as e:
                # a dead server here is the ordinary recovery problem,
                # not a membership one — hand it to the fenced retry
                if self.retry_deadline <= 0:
                    raise
                self._recover(r, "rehello", e)

    def close(self, r: Optional[int] = None) -> None:
        ranks = range(self.world) if r is None else [r]
        for i in ranks:
            try:
                if self._socks[i] is not None:
                    self._socks[i].close()
            except OSError:
                pass
            self._socks[i] = None
            self._files[i] = None
            # compression + wire-codec acks are per-connection state
            self._fc[i] = False
            self._wc[i] = False
        if r is None and self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _fan(self, fn: Callable[[int], object]) -> list:
        """Run fn(r) against every server. Multi-server clients fan out
        on a small thread pool (one socket per server; all per-rank
        client state is rank-indexed, shared tallies sit behind
        _stats_lock), so a sync costs max-of-shards instead of
        sum-of-shards. Results come back in rank order; the first
        worker exception propagates."""
        if self.world == 1:
            return [fn(0)]
        if self._pool is None:
            # lazy init on the train thread only; close() tears it down
            # after the last fan-out returned
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(self.world, 8),
                thread_name_prefix="ps-rpc")
        ctx = _trace.current_ctx()
        dl = _overload.current()
        if ctx is not None or dl is not None:
            # pool threads don't inherit thread-locals: rebind the
            # sampled sync round's trace context (so each per-rank RPC
            # frame carries it to its server shard) and the round's
            # ambient deadline (so those frames keep their budget)
            inner = fn

            def fn(r, _inner=inner, _ctx=ctx, _dl=dl):
                with _overload.bind(_dl):
                    if _ctx is None:
                        return _inner(r)
                    with _trace.bind(_ctx):
                        return _inner(r)
        futs = [self._pool.submit(fn, r) for r in range(self.world)]
        return [f.result() for f in futs]

    def _kc_cache_idx(self, r: int, dig: str, idx: np.ndarray) -> None:
        """Remember a key list by content digest (per-server LRU) so a
        later digest-only pull reply can be reconstructed locally."""
        lru = self._kc_idx[r]
        lru[dig] = idx
        lru.move_to_end(dig)
        while len(lru) > self._KC_CLIENT_CAP:
            lru.popitem(last=False)

    # -- table ops ----------------------------------------------------------
    def _slices(self, tables: dict[str, np.ndarray], r: int):
        out = {}
        for k, v in tables.items():
            lo, hi = shard_range(v.shape[0], r, self.world)
            out[k] = v[lo:hi]
        return out

    def init(self, tables: dict[str, np.ndarray],
             derived: Optional[dict] = None) -> None:
        """Offer init state to every server (full-array fallback; the
        wire cost is O(table) — prefer init_from_specs when the store
        can describe its init)."""
        self.full_rows = {k: int(v.shape[0]) for k, v in tables.items()}
        for r in range(self.world):
            self._rpc(r, {"op": "init", "full_rows": self.full_rows,
                          "derived": derived or {}},
                      self._slices(tables, r))

    def init_from_specs(self, zero_names: set[str],
                        tables: dict[str, np.ndarray],
                        derived: Optional[dict] = None,
                        timeout: float = 2 * INIT_CLAIM_TTL) -> None:
        """O(spec) table creation: send {shape, zero} per table; servers
        build zero-init tables locally, CLAIM the rest for the first
        asker, and only the claimant ships them via init_arrays — one
        copy on the wire no matter how many workers start at once. A
        non-claimant polls until the claimant's arrays land (claims
        expire server-side, so a dead claimant just hands the claim to
        the next poller). The server cross-checks the offered shapes
        against the created tables, so a divergent-conf worker fails at
        init, not later with misrouted row indices. At the 2^26-bucket
        FTRL operating point this turns a ~768 MB-per-worker startup
        push into a ~1 KB header exchange (VERDICT r3 item 2)."""
        self.full_rows = {k: int(v.shape[0]) for k, v in tables.items()}
        specs = {k: {"shape": list(v.shape), "zero": k in zero_names}
                 for k, v in tables.items()}
        for r in range(self.world):
            deadline = time.monotonic() + timeout
            while True:
                h, _ = self._rpc(r, {"op": "init_spec", "specs": specs,
                                     "derived": derived or {}})
                if h.get("known"):
                    break
                need = h.get("need") or []
                if need:  # we hold the claim for these: ship our slices
                    h2, _ = self._rpc(
                        r, {"op": "init_arrays"},
                        self._slices({k: tables[k] for k in need}, r))
                    if h2.get("known"):
                        break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"server {self.uris[r]} tables never completed "
                        "creation (claimant died repeatedly?)")
                time.sleep(0.1)

    def pull(self) -> dict[str, np.ndarray]:
        """Dense full-table pull (startup / test convenience)."""
        parts = [self._rpc(r, {"op": "pull"})[1] for r in range(self.world)]
        if not self.full_rows:
            self.full_rows = {
                k: sum(p[k].shape[0] for p in parts) for k in parts[0]}
        return {
            k: np.concatenate([p[k] for p in parts], axis=0)
            if self.world > 1 else parts[0][k]
            for k in parts[0]
        }

    def pull_sparse(self, since: list[int], compress: bool = False,
                    skip: Optional[list] = None,
                    ) -> tuple[list[int], dict[int, np.ndarray],
                               dict[str, np.ndarray]]:
        """Versioned pull: rows stamped after `since[r]` on each server.
        Returns (new clocks, {group_rows: global indices},
        {table: rows aligned to its group's indices}).

        `skip` names derived tables the caller will recompute from the
        same reply's source rows (SyncedStore._fill_derived) — the
        server omits their values from the wire. Purely advisory: a
        server that predates the field ships them anyway and the caller
        just uses the shipped rows."""
        kc = self.keycache and self.sender is not None

        def one(r: int) -> tuple[dict, dict]:

            s = int(since[r])
            if self._rolled_back[r]:
                # the server restored a snapshot: its clock (and row
                # stamps) rolled back, so our `since` may exceed it and
                # miss rows. since=0 returns every stamped row — a
                # superset of the delta — and re-adopts the restored
                # state wholesale.
                self._rolled_back[r] = False
                s = 0
            def wire_hdr(hdr: dict) -> dict:
                # quantized pull replies (wire codec v2) ride only
                # connections whose hello ack'd the capability; EF is
                # keyed by sender, so anonymous clients get stateless
                # quantization. Pulls cap at bf16 even when WH_WIRE is
                # int8/int4: a pull is an ABSOLUTE-state refresh, and
                # uniform absmax codes give errors relative to the
                # hottest neighbor, not the element itself — on a
                # skewed FTRL table that pushes small z past the L1
                # threshold and diverges training. bf16's per-element
                # relative precision is scale-free; int8/int4 stay on
                # the EF-corrected DELTA streams (pushes), where the
                # residual makes the error unbiased over rounds.
                if self.wire_enc != "raw" and self._wc[r]:
                    hdr["wire"] = ("bf16" if self.wire_enc in
                                   ("int8", "int4") else self.wire_enc)
                    if self.wire_ef and self.sender is not None:
                        hdr.update(sender=self.sender, wire_ef=1)
                return hdr

            header = {"op": "pull", "since": s}
            if skip:
                header["skip"] = list(skip)
            if kc:
                header.update(sender=self.sender, kc=1)
            h, arrs = self._rpc(r, wire_hdr(header), compress=compress)
            if kc:
                for gs, dig in (h.get("kfull") or {}).items():
                    # full reply stamped with its digest: cache the key
                    # list so the server's next same-set reply can omit
                    # it
                    name = _idx_name(int(gs))
                    if name in arrs:
                        self._kc_cache_idx(r, dig, arrs[name])
                kdig = h.get("kdig") or {}
                missing = any(dig not in self._kc_idx[r]
                              for dig in kdig.values())
                if missing:
                    # digest-only reply we can no longer reconstruct
                    # (our LRU evicted it): re-pull this server in full
                    # — correctness never depends on the cache
                    with self._stats_lock:
                        self.kc_misses += 1
                    hdr2 = {"op": "pull", "since": s}
                    if skip:
                        hdr2["skip"] = list(skip)
                    h, arrs = self._rpc(r, wire_hdr(hdr2),
                                        compress=compress)
                elif kdig:
                    for gs, dig in kdig.items():
                        lru = self._kc_idx[r]
                        lru.move_to_end(dig)
                        arrs[_idx_name(int(gs))] = lru[dig]
                    with self._stats_lock:
                        self.kc_hits += len(kdig)
            return h, arrs

        got = self._fan(one)
        clocks = []
        g_idx: dict[int, list] = {}
        t_rows: dict[str, list] = {}
        for r, (h, arrs) in enumerate(got):
            clocks.append(int(h["clock"]))
            for g in {rows for rows in self.full_rows.values()}:
                name = _idx_name(g)
                if name not in arrs:
                    continue
                lo, _ = shard_range(g, r, self.world)
                g_idx.setdefault(g, []).append(arrs[name] + lo)
            for k, rows in self.full_rows.items():
                if k in arrs:
                    t_rows.setdefault(k, []).append(arrs[k])
        groups = {g: np.concatenate(v) if len(v) > 1 else v[0]
                  for g, v in g_idx.items()}
        tables = {k: np.concatenate(v, axis=0) if len(v) > 1 else v[0]
                  for k, v in t_rows.items()}
        return clocks, groups, tables

    def push(self, deltas: dict[str, np.ndarray],
             fixed_bytes: int = 0) -> None:
        """Dense full-table delta push (test convenience / fallback)."""
        for r in range(self.world):
            self._rpc(r, {"op": "push"}, self._slices(deltas, r),
                      fixed_bytes=fixed_bytes)

    def push_sparse(self, groups: dict[int, np.ndarray],
                    deltas: dict[str, np.ndarray],
                    fixed_bytes: int = 0, compress: bool = False) -> None:
        """Sparse delta push. `groups` maps a row-space (full row count)
        to the sorted-unique GLOBAL row indices touched in it;
        `deltas[k]` holds the delta rows of table k aligned to
        `groups[full_rows[k]]`.

        Sortedness makes each server's slice a contiguous searchsorted
        range, so the per-server split is two binary searches and VIEWS
        of the delta rows — no boolean masks, no row copies. With key
        caching on, a slice whose digest the server already holds ships
        digest + values only; a need_keys reply (cache lost — e.g. a
        respawned server) triggers a full resend under a fresh seq."""
        kc = self.keycache and self.sender is not None

        def one(r: int) -> None:

            sel: dict[int, slice] = {}
            loc_of: dict[int, np.ndarray] = {}
            kdig: dict[str, str] = {}
            for g, idx in groups.items():
                lo, hi = shard_range(g, r, self.world)
                a, b = np.searchsorted(idx, (lo, hi))
                sel[g] = slice(a, b)
                loc_of[g] = idx[a:b] - lo
                if kc:
                    kdig[str(g)] = key_digest(loc_of[g])
            vals = {k: rows[sel[self.full_rows[k]]]
                    for k, rows in deltas.items()}
            full = {_idx_name(g): v for g, v in loc_of.items()}
            full.update(vals)
            if not kc:
                self._rpc(r, {"op": "push"}, full,
                          fixed_bytes=fixed_bytes, compress=compress)
                return
            header = {"op": "push", "kdig": kdig}
            send = {_idx_name(g): v for g, v in loc_of.items()
                    if kdig[str(g)] not in self._kc_pushed[r]}
            omitted = len(loc_of) - len(send)
            send.update(vals)
            h, _ = self._rpc(r, header, send, fixed_bytes=fixed_bytes,
                             compress=compress, journal_arrays=full)
            need = h.get("need_keys")
            if need:
                # the server lost (or never had) our key lists — a
                # fresh/restored process. The miss reply advanced
                # neither fence nor clock, so resend in full; _rpc
                # stamps a new seq.
                with self._stats_lock:
                    self.kc_misses += len(need)
                self._kc_pushed[r].clear()
                self._rpc(r, {"op": "push", "kdig": kdig}, full,
                          fixed_bytes=fixed_bytes, compress=compress)
            elif omitted:
                with self._stats_lock:
                    self.kc_hits += omitted
            pushed = self._kc_pushed[r]
            for gs, dig in kdig.items():
                pushed[dig] = True
                pushed.move_to_end(dig)
                # the digest space is content-addressed, so our own
                # pushed key lists double as pull-reply reconstructions
                self._kc_cache_idx(r, dig, loc_of[int(gs)])
            while len(pushed) > ServerNode._KC_CAP:
                pushed.popitem(last=False)

        self._fan(one)

    def save(self, base: str, it: Optional[int] = None) -> list[str]:
        return [self._rpc(r, {"op": "save", "base": base, "iter": it})[0]
                ["path"] for r in range(self.world)]

    def load(self, base: str, it: Optional[int] = None) -> None:
        """Command every server to load its shard of a checkpoint
        (IterScheduler::LoadModel parity) — must run before any worker
        init so the loaded state IS the table-creation state."""
        for r in range(self.world):
            self._rpc(r, {"op": "load", "base": base, "iter": it})

    def stats(self, r: int = 0) -> dict:
        return self._rpc(r, {"op": "stats"})[0]

    def shutdown(self) -> None:
        for r in range(self.world):
            try:
                self._rpc(r, {"op": "shutdown"})
            except (OSError, ConnectionError):
                pass
        self.close()


class SyncedStore:
    """Bounded-staleness synchronization of a learner's KV store against
    the server group: tracks the state at last pull and pushes additive
    deltas (cur - base). `maybe_sync` counts minibatches and syncs every
    `max_delay` (the reference's bounded-async knob).

    Sparse wire: when the learner supplies `touched_fn` (returning, per
    additive table, the sorted-unique global rows it touched since the
    last call) AND the store exposes `gather_rows`/`scatter_rows`, the
    sync path never materializes a full table — it gathers the touched
    device rows, pushes (indices, deltas), and scatters back the rows
    the versioned pull reports dirty. Without hints it falls back to a
    full-table delta scan (host O(table), wire still sparse: only rows
    with nonzero delta are sent).

    Async sync (`async_sync=True`, default from `WH_ASYNC_SYNC`):
    `sync()` snapshots the touched rows + deltas, advances the base
    mirror by them ("deltas on the wire ARE part of base"), hands the
    push+pull round-trip to a daemon comms thread, and returns — the
    device trains through the round-trip. At most ONE round-trip is in
    flight; the next sync waits for it and FOLDS the pull in first:
    for every pulled row, store <- pulled + (cur - base) keeps local
    un-pushed progress on top of the adopted merged state (derived
    tables are overwritten — they are not additive), base <- pulled.
    Effective staleness is therefore at most 2*max_delay minibatches.
    `flush()` is the barrier for part ends / eval / checkpoints: drain
    the in-flight round-trip, then one synchronous sync. Recovery
    composes unchanged: the comms thread rides PSClient's fenced retry,
    journal replay, and rollback re-pull. With async off, sync() is the
    original, bit-identical synchronous path."""

    def __init__(self, store, client: PSClient, max_delay: int = 16,
                 fixed_bytes: int = 0, derived: Optional[dict] = None,
                 perf=None, touched_fn: Optional[Callable] = None,
                 compress: bool = False, offer_arrays: bool = False,
                 async_sync: Optional[bool] = None):
        self.store = store
        self.client = client
        self.perf = perf  # optional utils.perf.Perf: times push/pull ops
        self.max_delay = max(int(max_delay), 1)
        self.fixed_bytes = fixed_bytes
        self.compress = bool(compress)
        # warm starts (model_in loaded into the store) MUST offer real
        # arrays: the spec path would create zero tables while this
        # worker's base mirror holds the loaded model, silently erasing
        # the warm start on the first sync
        self.offer_arrays = bool(offer_arrays)
        # non-additive derived-table specs forwarded to the servers (e.g.
        # FTRL's w = prox(z, n); see ServerNode._recompute_derived)
        self.derived = derived or {}
        self.touched_fn = touched_fn
        self._sparse_store = (hasattr(store, "gather_rows")
                              and hasattr(store, "scatter_rows"))
        # wire codec v2 (client half): the encoding/EF/comp operating
        # point lives on the PSClient (it owns the per-connection
        # negotiation); this store quantizes each sync's delta rows
        # once, with one EF accumulator per table, and tallies the
        # f32-equivalent vs on-the-wire bytes for wire_stats
        self.wire_enc = client.wire_enc
        self.wire_ef = client.wire_ef
        # per-table wire floor (TableSpec.wire_cap via the store hook):
        # second-moment / count accumulator deltas never drop below bf16
        cap_fn = getattr(store, "wire_cap_names", None)
        self._wire_cap: set = set(cap_fn()) if cap_fn is not None else set()
        self._efq: dict[str, EFQuant] = {}
        self._wire_raw = 0
        self._wire_bytes = 0
        self._base: dict[str, np.ndarray] = {}
        self._clocks: Optional[list[int]] = None
        self._steps = 0
        self.num_syncs = 0
        self.async_sync = (_env_flag("WH_ASYNC_SYNC") if async_sync is None
                           else bool(async_sync))
        # async comms state: at most one in-flight round-trip job (that
        # bound IS the staleness guarantee) on a lazily started daemon
        # thread; device-row gathers/scatters stay on the training
        # thread (the steps' CUDA stream), only wire work moves off it
        self._inflight: Optional[dict] = None
        self._comm_q: Optional[queue.Queue] = None
        self._comm_thread: Optional[threading.Thread] = None
        self._mepoch_seen = 0  # last membership epoch absorbed
        self._rt_wall = 0.0    # round-trip wall summed (comms thread)
        self._wait_wall = 0.0  # fold wait actually paid (train thread)
        self._push_s = 0.0
        self._pull_s = 0.0
        self.max_fold_lag = 0  # observed staleness, in sync rounds

    def init(self) -> None:
        """Offer this worker's (deterministic) init state, then adopt the
        merged server state. INVARIANT: all workers initialize
        identically (the learners construct state from fixed seeds /
        zeros), so the local state IS the table-creation state — which
        is what lets both halves of this be O(touched), not O(table):
        the offer goes as an init SPEC when the store can name its
        zero-init tables (arrays only for the remainder, shipped by the
        single claiming worker), and the startup pull asks only for rows
        pushed since creation (since=0). The server rejects an init spec
        whose shapes disagree with the created tables, so a
        divergent-conf worker fails at init rather than training against
        a wrong base mirror. Warm starts (offer_arrays=True) take the
        full-array path: loaded state is NOT the deterministic init, so
        it must be offered as the table-creation state."""
        snap = self.store.to_numpy()
        zero_names = getattr(self.store, "zero_init_names", None)
        if zero_names is not None and not self.offer_arrays:
            self.client.init_from_specs(set(zero_names()), snap,
                                        derived=self.derived)
        else:
            self.client.init(snap, derived=self.derived)
        # writable host mirror (to_numpy may hand out read-only views of
        # device buffers)
        self._base = {k: np.array(v, np.float32) for k, v in snap.items()}
        self._clocks = [0] * self.client.world
        self._apply_pull()

    def _pull_skip(self) -> Optional[list]:
        """Derived tables to omit from quantized pull replies: w is a
        pure function of (z, n), so shipping it alongside its sources
        is a third bf16 table of pure redundancy — the client derives
        the same rows from the same reply (_fill_derived). Raw-wire
        pulls keep shipping it: there the contract is bit-identical
        adoption of server state, and recomputing would trade exact
        f32 equality for a formula re-evaluation."""
        if self.wire_enc == "raw" or not self._wire_ok():
            return None
        sk = [k for k, s in self.derived.items()
              if s.get("kind") == "ftrl_prox"]
        return sk or None

    def _fill_derived(self, groups: dict, tables: dict) -> dict:
        """Client half of the derived-table wire skip: reconstruct any
        derived table the reply omitted from its pulled source rows
        (same ftrl_prox_rows the server runs, so both ends derive
        identical values). A reply that still carries the table (older
        server, raw wire) is used as-is."""
        for k, spec in self.derived.items():
            if spec.get("kind") != "ftrl_prox":
                continue
            z, n = tables.get("z"), tables.get("n")
            if (z is None or n is None
                    or self.client.full_rows.get("z")
                    != self.client.full_rows.get(k)):
                continue
            if k in tables and tables[k].shape[0] == z.shape[0]:
                # a complete part was shipped (raw wire, or every
                # server predates the skip): adopt it as-is
                continue
            # absent — or PARTIAL: in a mixed world where only some
            # servers honor the skip, the merged part covers only the
            # non-honoring servers' rows and is useless; z/n are never
            # skipped, so recomputing from them always aligns with the
            # merged index
            tables[k] = ftrl_prox_rows(spec, z, n)
        return tables

    def _apply_pull(self) -> None:
        """Versioned pull: fetch rows dirty since our clocks, fold them
        into the base mirror and the device store."""
        clocks, groups, tables = self.client.pull_sparse(
            self._clocks, compress=self.compress, skip=self._pull_skip())
        tables = self._fill_derived(groups, tables)
        for k, rows in tables.items():
            idx = groups[self.client.full_rows[k]]
            if idx.size == 0:
                continue
            self._base[k][idx] = rows
            if self._sparse_store:
                self.store.scatter_rows(k, idx, rows)
        if not self._sparse_store and groups:
            self.store.from_numpy(self._base)
        elif self._sparse_store:
            # host-mirror coherence hook (e.g. difacto's admission-count
            # mirror): the dense path refreshes mirrors via from_numpy;
            # the sparse path hands over exactly the pulled rows
            hook = getattr(self.store, "on_sparse_pull", None)
            if hook is not None:
                hook({k: (groups[self.client.full_rows[k]], rows)
                      for k, rows in tables.items()})
        self._clocks = clocks

    def pull(self) -> None:
        if self.async_sync:
            # adopt any completed (or still-flying) round-trip before a
            # fresh pull overwrites rows — base must stay coherent
            self._fold_pending(wait=True)
        if self._clocks is None:
            pulled = self.client.pull()
            self.store.from_numpy(pulled)
            # decoded arrays can be read-only zero-copy views (net.py);
            # the base mirror gets written by later sparse pulls
            self._base = {k: np.array(v, np.float32)
                          for k, v in pulled.items()}
            return
        self._apply_pull()

    def _touched_groups(self):
        """(groups, deltas) for push_sparse from learner hints, or None
        to use the full-scan fallback."""
        if self.touched_fn is None:
            return None
        touched = self.touched_fn()
        if touched is None:
            return None
        per_g: dict[int, list[np.ndarray]] = {}
        for k, rows in self.client.full_rows.items():
            if k in self.derived:
                continue
            idx = touched.get(k)
            if idx is None:
                return None  # incomplete hint: fall back to the scan
            per_g.setdefault(rows, []).append(idx)
        groups = self._union_groups(per_g)
        snap = None if self._sparse_store else self.store.to_numpy()
        deltas: dict[str, np.ndarray] = {}
        multi = (getattr(self.store, "gather_rows_multi", None)
                 if snap is None else None)
        by_g: dict[int, list[str]] = {}
        for k, rows in self.client.full_rows.items():
            if k not in self.derived:
                by_g.setdefault(rows, []).append(k)
        for rows, names in by_g.items():
            idx = groups[rows]
            if multi is not None and len(names) > 1:
                # one padded index transfer + one device dispatch for
                # the whole group (z, n, ... share the touched set)
                cur = multi(names, idx)
            else:
                cur = {k: (self.store.gather_rows(k, idx) if snap is None
                           else snap[k][idx]) for k in names}
            for k in names:
                deltas[k] = cur[k] - self._base[k][idx]
        return groups, deltas

    @staticmethod
    def _union_groups(per_g: dict[int, list]) -> dict[int, np.ndarray]:
        """Union the per-table touched sets of each row-space group with
        ONE concatenate+unique (repeated pairwise np.union1d re-sorts
        the whole accumulated set per table: O(k * n log n))."""
        groups: dict[int, np.ndarray] = {}
        for rows, parts in per_g.items():
            first = parts[0]
            if all(p is first or np.array_equal(p, first)
                   for p in parts[1:]):
                groups[rows] = first
            else:
                groups[rows] = np.unique(np.concatenate(parts))
        return groups

    def _scan_groups(self):
        """Fallback: full-table delta scan; wire stays sparse (only rows
        whose delta is nonzero ship)."""
        cur = self.store.to_numpy()
        per_g: dict[int, list[np.ndarray]] = {}
        diffs: dict[str, np.ndarray] = {}
        for k, v in cur.items():
            if k in self.derived:
                continue
            d = v - self._base[k]
            nz = d != 0
            if nz.ndim > 1:
                nz = nz.any(axis=tuple(range(1, nz.ndim)))
            idx = np.flatnonzero(nz)
            diffs[k] = d
            per_g.setdefault(self.client.full_rows[k], []).append(idx)
        groups = self._union_groups(per_g)
        deltas = {k: diffs[k][groups[self.client.full_rows[k]]]
                  for k in diffs}
        return groups, deltas

    # -- wire codec v2 (push half) -------------------------------------------
    def _wire_ok(self) -> bool:
        """True when every server connection ack'd the wire codec in
        its hello — QuantRows encodings only ship to peers that can
        decode them (per-server slices come from ONE quantized array,
        so the decision is all-or-nothing per sync)."""
        return all(self.client._wc)

    def _wire_fb(self) -> int:
        """Effective fixed_bytes for this sync's push: when WH_WIRE is
        set but a server didn't ack the codec (older peer), degrade to
        the legacy bf16 truncation form (fixed_bytes=2) for EVERY
        quantized encoding instead of sending frames the peer can't
        decode. Not fixed_bytes=1: that form is one global absmax scale
        over the whole push — exactly the hot-neighbor granularity
        pathology wire_cap exists to avoid, with no EF and no per-table
        escape hatch."""
        if self.wire_enc == "raw" or self._wire_ok():
            return self.fixed_bytes
        return 2

    def _quantize_deltas(self, groups: dict, deltas: dict) -> dict:
        """Quantize a sync round's delta rows ONCE into QuantRows
        (per-row scales for 2-D tables, grouped scales for 1-D), folding in and
        advancing the per-table error-feedback residuals. Everything
        downstream — the per-server searchsorted split, the push
        journal, a need_keys full resend — slices/replays these same
        objects, so every (re)send of a logical sync serializes to
        identical bytes and a residual can never be applied twice.
        Returns the deltas untouched when the codec is off or a peer
        didn't negotiate it (see _wire_fb's legacy fallback)."""
        if self.wire_enc == "raw" or not self._wire_ok():
            return deltas
        out: dict = {}
        for k, d in deltas.items():
            idx = groups[self.client.full_rows[k]]
            if not idx.size:
                out[k] = d
                continue
            # wire_cap floor: accumulator tables (FTRL n, difacto
            # n/cnt/nV) ship at bf16 even under int8/int4 — an absmax
            # group code quantizes a cold bucket's delta at the hot
            # neighbor's granularity, mis-scaling its learning rate in
            # a way EF can't repair (see TableSpec.wire_cap)
            enc = ("bf16" if k in self._wire_cap
                   and self.wire_enc in ("int8", "int4")
                   else self.wire_enc)
            if self.wire_ef:
                efq = self._efq.get(k)
                if efq is None:
                    efq = self._efq[k] = EFQuant(enc)
                qr = efq.apply(idx, d)
            else:
                qr = quantize_rows(d, enc)
            out[k] = qr
            self._wire_raw += 4 * int(qr.q.size)
            self._wire_bytes += qr.wire_nbytes()
        return out

    # -- async comms plane ---------------------------------------------------
    def _ensure_comm_thread(self) -> None:
        if self._comm_thread is None:
            self._comm_q = queue.Queue()
            self._comm_thread = threading.Thread(
                target=self._comm_loop, daemon=True, name="ps-sync-comms")
            self._comm_thread.start()

    def _comm_loop(self) -> None:
        """Comms thread: run each queued round-trip (push then versioned
        pull) against the servers. PSClient is touched ONLY from this
        thread while async mode is live, so the fenced retry / journal
        replay / rollback machinery runs here unchanged."""
        _pyprof.tag_thread("comms")
        while True:
            job = self._comm_q.get()
            if job is None:
                return
            t0 = time.perf_counter()
            try:
                # every WH_TRACE_SAMPLE-th round gets a trace context
                # that rides the push/pull frames, so the PS shards'
                # handler spans stitch under this round cross-node
                with _trace.bind(_trace.start_request()), \
                        _trace.request_span("ps.sync.round", cat="ps"):
                    with _trace.span("ps.sync.push", cat="ps"):
                        self.client.push_sparse(
                            job["groups"], job["deltas"],
                            fixed_bytes=self._wire_fb(),
                            compress=self.compress)
                    t1 = time.perf_counter()
                    with _trace.span("ps.sync.pull", cat="ps"):
                        job["pull"] = self.client.pull_sparse(
                            self._clocks, compress=self.compress,
                            skip=self._pull_skip())
                t2 = time.perf_counter()
                _SYNC_PUSH_S.observe(t1 - t0)
                _SYNC_PULL_S.observe(t2 - t1)
                # duration tallies ride the job dict and are folded by
                # _fold_pending on the train thread (job["done"] is the
                # fence), keeping _push_s/_pull_s/perf single-writer
                job["push_s"] = t1 - t0
                job["pull_s"] = t2 - t1
            except BaseException as e:  # surfaced at the next fold
                job["error"] = e
            finally:
                job["rt"] = time.perf_counter() - t0
                job["done"].set()

    def _fold_pending(self, wait: bool) -> None:
        """Adopt the in-flight round-trip's pull, if any (and, with
        `wait`, block until it lands). Comms-thread errors re-raise
        here, on the training thread."""
        job = self._inflight
        if job is None:
            return
        t0 = time.perf_counter()
        if wait:
            job["done"].wait()
        elif not job["done"].is_set():
            return
        waited = time.perf_counter() - t0
        self._inflight = None
        _SYNC_INFLIGHT.set(0)
        err = job.get("error")
        if err is not None:
            raise err
        self._wait_wall += waited
        self._rt_wall += job["rt"]
        if "push_s" in job:
            self._push_s += job["push_s"]
            self._pull_s += job["pull_s"]
            if self.perf is not None:
                self.perf.add("ps_push", job["push_s"])
                self.perf.add("ps_pull", job["pull_s"])
        _SYNC_WAIT_S.observe(waited)
        _ST_SYNC.observe(waited)
        if self._rt_wall > 0:
            _SYNC_OVERLAP.set(
                max(0.0, 1.0 - self._wait_wall / self._rt_wall))
        self.max_fold_lag = max(self.max_fold_lag,
                                self.num_syncs - job["enq_sync"])
        clocks, groups, tables = job["pull"]
        self._fold_rows(groups, self._fill_derived(groups, tables))
        self._clocks = clocks

    def _fold_rows(self, groups: dict, tables: dict) -> None:
        """Fold a pull that raced local training: by the time the
        round-trip landed, the store holds deltas newer than the pushed
        snapshot. For every pulled row of an additive table,

            store <- pulled + (cur - base);  base <- pulled

        keeps that un-pushed local progress on top of the adopted merged
        state (base is always "adopted server state + deltas already on
        the wire", so cur - base IS the un-pushed part). Derived tables
        (non-additive, e.g. FTRL's w) are overwritten like the sync
        path; their rows re-cohere the next time they are trained or
        pulled — the same bounded-staleness wobble async-SGD already
        accepts."""
        snap = None
        if not self._sparse_store:
            # to_numpy may hand out read-only device views; the fold
            # mutates rows in place
            snap = {k: np.array(v, np.float32)
                    for k, v in self.store.to_numpy().items()}
        scattered: dict[str, tuple] = {}
        for k, rows in tables.items():
            idx = groups[self.client.full_rows[k]]
            if idx.size == 0:
                continue
            if k in self.derived:
                new = rows
            else:
                cur = (self.store.gather_rows(k, idx) if snap is None
                       else snap[k][idx])
                new = rows + (cur - self._base[k][idx])
            self._base[k][idx] = rows
            if self._sparse_store:
                self.store.scatter_rows(k, idx, new)
                scattered[k] = (idx, new)
            else:
                snap[k][idx] = new
        if not self._sparse_store and groups:
            self.store.from_numpy(snap)
        elif scattered:
            # host-mirror coherence hook (see _apply_pull): hand over
            # the FOLDED rows — they are what the device store now holds
            hook = getattr(self.store, "on_sparse_pull", None)
            if hook is not None:
                hook(scattered)

    def sync(self) -> None:
        if not self.async_sync:
            self._sync_now()
            return
        # adopt the previous round-trip first (waiting if it is still in
        # flight — one-in-flight is the staleness bound), then snapshot
        # deltas and hand the next round-trip to the comms thread
        self._fold_pending(wait=True)
        with _trace.span("ps.sync.snapshot", cat="ps"):
            got = self._touched_groups()
            if got is None:
                got = self._scan_groups()
            groups, deltas = got
            # mark the snapshot as pushed NOW: the next delta starts
            # from zero and the fold can tell un-pushed progress apart.
            # Base advances by the RAW delta even under quantization:
            # the quantization error lives in the EF residuals (not the
            # mirror), so the fold algebra below stays unchanged and
            # the error re-ships with the next sync that touches the
            # row.
            for k, d in deltas.items():
                idx = groups[self.client.full_rows[k]]
                if idx.size:
                    self._base[k][idx] += d
            # quantize on the TRAIN thread (EF state is single-writer
            # here; the comms thread only serializes the result)
            deltas = self._quantize_deltas(groups, deltas)
        self._ensure_comm_thread()
        job = {"groups": groups, "deltas": deltas,
               "done": threading.Event(), "enq_sync": self.num_syncs}
        self._inflight = job
        _SYNC_INFLIGHT.set(1)
        self._comm_q.put(job)
        _SYNCS.inc()
        self._steps = 0
        self.num_syncs += 1

    def _sync_now(self) -> None:
        """The original synchronous round-trip (also the async mode's
        barrier step): push deltas, then pull+apply the merged rows."""
        t0 = time.perf_counter()
        with _trace.bind(_trace.start_request()), \
                _trace.request_span("ps.sync.round", cat="ps"):
            with _trace.span("ps.sync.push", cat="ps"):
                got = self._touched_groups()
                if got is None:
                    got = self._scan_groups()
                groups, deltas = got
                self.client.push_sparse(groups,
                                        self._quantize_deltas(groups,
                                                              deltas),
                                        fixed_bytes=self._wire_fb(),
                                        compress=self.compress)
            t1 = time.perf_counter()
            with _trace.span("ps.sync.pull", cat="ps"):
                self._apply_pull()
        t2 = time.perf_counter()
        _SYNC_PUSH_S.observe(t1 - t0)
        _SYNC_PULL_S.observe(t2 - t1)
        _ST_SYNC.observe(t2 - t0)
        _SYNCS.inc()
        self._push_s += t1 - t0
        self._pull_s += t2 - t1
        if self.perf is not None:
            self.perf.add("ps_push", t1 - t0)
            self.perf.add("ps_pull", t2 - t1)
        self._steps = 0
        self.num_syncs += 1

    def flush(self) -> None:
        """Barrier for part ends, eval, and checkpoints: drain the
        in-flight round-trip, then run one synchronous sync — afterwards
        every local delta is merged on the servers and the local store
        holds the freshest merged state (with async off this IS
        sync()). When no minibatch ran since the last sync there is
        nothing to push (an adopted in-flight pull already refreshed the
        mirror), so back-to-back barriers — part end, then pass
        boundary, then checkpoint — cost one round-trip, not three."""
        if self.async_sync:
            self._fold_pending(wait=True)
        if self._steps == 0 and self.num_syncs > 0:
            return
        self._sync_now()

    def absorb_membership(self, mepoch: int) -> bool:
        """A membership-epoch bump (worker join/leave/evict) reached
        this worker. Barrier-flush so every local delta is durably
        merged under the OLD membership, then re-handshake the server
        group (PSClient.rehello) so a stale connection from a healed
        partition can't carry pre-bump frames. The servers themselves
        are membership-stable — only the WORKER set changed — so this
        is a fence + freshness barrier, not a reshard. Returns True
        when a bump was actually absorbed; already-seen epochs are a
        no-op, so callers can invoke this every round unconditionally.
        Composes with async sync (flush drains the in-flight
        round-trip first) and with journal replay (rehello replays
        unacked pushes through the seq fence)."""
        mepoch = int(mepoch)
        if mepoch <= self._mepoch_seen:
            return False
        self.flush()
        self.client.rehello(mepoch)
        self._mepoch_seen = mepoch
        return True

    def close(self) -> None:
        """Stop the comms thread (tests and orderly teardown; it is a
        daemon thread otherwise). Pending work is folded first."""
        if self._comm_thread is not None:
            self._fold_pending(wait=True)
            self._comm_q.put(None)
            self._comm_thread.join(timeout=10)
            self._comm_thread = None

    def maybe_sync(self) -> bool:
        self._steps += 1
        if self._steps >= self.max_delay:
            self.sync()
            return True
        return False

    def wire_stats(self) -> dict:
        """Measured wire traffic (both directions) plus the async/key-
        cache operating point, for the distributed bench's [ps-wire]
        line."""
        n = max(self.num_syncs, 1)
        c = self.client
        kc_total = c.kc_hits + c.kc_misses
        overlap = (max(0.0, 1.0 - self._wait_wall / self._rt_wall)
                   if self._rt_wall > 0 else 0.0)
        resid = (sum(e.resid_norm() ** 2 for e in self._efq.values())
                 ** 0.5 if self._efq else 0.0)
        return {"plane": "tcp",
                "num_syncs": self.num_syncs,
                "bytes_push": c.bytes_push,
                "bytes_pull": c.bytes_pull,
                "bytes_per_sync": (c.bytes_push + c.bytes_pull) / n,
                "wire_codec": self.wire_enc,
                "wire_ef": int(self.wire_ef and self.wire_enc != "raw"),
                "wire_comp": c.wire_comp,
                "wire_bytes_raw": self._wire_raw,
                "wire_bytes_wire": self._wire_bytes,
                "wire_ef_resid_norm": round(resid, 6),
                "async_sync": int(self.async_sync),
                "sync_overlap_frac": round(overlap, 4),
                "push_ms_per_sync": round(1e3 * self._push_s / n, 3),
                "pull_ms_per_sync": round(1e3 * self._pull_s / n, 3),
                "keycache": int(c.keycache),
                "keycache_hits": c.kc_hits,
                "keycache_misses": c.kc_misses,
                "keycache_hit_rate": (round(c.kc_hits / kc_total, 4)
                                      if kc_total else 0.0)}
