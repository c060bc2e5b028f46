"""Distributed control plane: scheduler RPC + remote workload pool.

The port's copy of the JAX package's runtime/tracker.py, renamed to this
package and sharing nothing with it.

The reference's control plane is ps-lite Task messages between the
scheduler and worker/server processes (reference learn/solver/
data_parallel.h:93-206: StartDispatch / SendWorkload / ProcessResponse,
node-failure re-queue at :131-135) plus the rabit tracker's rendezvous.
The data plane is the PS servers (runtime/ps_server.py) or a device
mesh's collectives (SURVEY.md §5), so what remains host-side is exactly
this thin control protocol:

- workload dispatch: workers ask for file parts, the scheduler hands out
  parts from a WorkloadPool (elastic: straggler re-queue, failure reset);
- progress: workers push mergeable metric vectors, the scheduler sums and
  prints rows (the ps::Root/Slave monitor channel, iter_solver.h:62-164);
- barrier: BSP phase sync for the rabit-style apps (kmeans, L-BFGS);
- liveness: nodes that stop polling past a timeout get their assigned
  parts re-queued (AddNodeFailureHandler parity).

Transport is newline-delimited JSON over TCP, one connection per request
— control traffic is per-file-part (seconds), not per-minibatch, so
simplicity beats throughput here. The launcher (launcher/dmlc_tpu.py)
spawns the node processes and wires the env vars.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import socket
import socketserver
import threading
import time
from enum import Enum
from typing import Optional

from wormhole_tpu_torch.config import knob_value
from wormhole_tpu_torch.obs import flight as _flight
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.obs import prom as _prom
from wormhole_tpu_torch.obs import slo as _slo
from wormhole_tpu_torch.obs import trace as _trace
from wormhole_tpu_torch.runtime import faults
from wormhole_tpu_torch.runtime import overload as _overload
from wormhole_tpu_torch.runtime import retry as _retry
from wormhole_tpu_torch.runtime.net import connect_with_retry
from wormhole_tpu_torch.runtime.sched_journal import SchedulerJournal
from wormhole_tpu_torch.solver.progress import Progress
from wormhole_tpu_torch.solver.workload import (File, WorkloadPool, WorkType,
                                               match_file)

_EVICTIONS = _obs.REGISTRY.counter("sched.liveness_evictions")
_SRV_RECOVERIES = _obs.REGISTRY.counter("sched.server_recoveries")
_SERVE_RECOVERIES = _obs.REGISTRY.counter("sched.serve_recoveries")
_BSP_RECOVERIES = _obs.REGISTRY.counter("bsp.recoveries")
_BARRIER_WAIT_S = _obs.REGISTRY.histogram("sched.barrier_wait_s")
_SCRAPES = _obs.REGISTRY.counter("obs.scrape.requests")
_RING_DEPTH = _obs.REGISTRY.gauge("obs.ring.depth")
_MEPOCHS = _obs.REGISTRY.counter("sched.membership_epochs")
_JOINS = _obs.REGISTRY.counter("sched.joins")
_LEAVES = _obs.REGISTRY.counter("sched.leaves")
_RECOVERIES = _obs.REGISTRY.counter("sched.recoveries")
_DEDUP_HITS = _obs.REGISTRY.counter("sched.rpc.dedup_hits")
_INCARNATION = _obs.REGISTRY.gauge("sched.incarnation")

# Client ops that mutate scheduler state: these carry a per-sender
# sequence number so a retried RPC (lost reply, scheduler restart)
# deduplicates against the reply cache instead of re-executing.
_MUTATING_OPS = frozenset({
    "join", "leave", "register", "register_server", "register_serve",
    "register_bsp", "bsp_leave", "get", "add_local", "finish", "report",
    "blob_put", "blob_del", "barrier", "bye",
})

# Server-side: which ops append an RPC record to the write-ahead
# journal.  `get` is special-cased — only journaled when it actually
# assigned a part (the assignment is replayed verbatim; `get` picks
# randomly so re-dispatching it would re-roll the choice).  Pure reads
# (epoch, servers, bsp_peers, serve_nodes, blob_get, barrier_wait,
# metrics, elastic) are never journaled.
_JOURNALED_OPS = frozenset({
    "join", "leave", "register", "register_server", "register_serve",
    "register_bsp", "bsp_leave", "add_local", "finish", "report",
    "blob_put", "blob_del", "barrier", "bye",
})

# Ops an overloaded scheduler may shed when their propagated deadline
# expired in transit.  Deliberately tiny: everything else the tracker
# handles IS the control plane (membership, barriers, heartbeats,
# registration) whose loss converts overload into spurious evictions.
# `metrics` is pure telemetry pull — dropping a stale one is free.
_SHEDDABLE_SCHED_OPS = frozenset({"metrics"})


def _worker_rank(node: str) -> int:
    """Numeric rank of a `worker-<r>` node name (for retire ordering);
    unparsable names sort first so they are retired last."""
    try:
        return int(node.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return -1


def _parse_elastic_plan(spec: str) -> list[tuple[float, int]]:
    """`join@<sec>,leave@<sec>,...` -> [(at_sec, +1/-1), ...] sorted by
    time. Unknown verbs raise — a typo'd drill plan must fail loudly."""
    plan = []
    for tok in (t.strip() for t in spec.split(",") if t.strip()):
        verb, _, at = tok.partition("@")
        if verb not in ("join", "leave") or not at:
            raise ValueError(f"bad WH_ELASTIC_PLAN token {tok!r} "
                             "(want join@<sec> or leave@<sec>)")
        plan.append((float(at), 1 if verb == "join" else -1))
    return sorted(plan)


class Role(str, Enum):
    SCHEDULER = "scheduler"
    WORKER = "worker"
    SERVER = "server"
    SERVE = "serve"  # online serving shard (serving/server.py)


@dataclasses.dataclass
class NodeEnv:
    """Role/rank/addressing as the launcher exports it (the reference
    discovers these via ps-lite/rabit env vars, linear.cc:13-20)."""

    role: Optional[Role]
    rank: int
    num_workers: int
    num_servers: int
    scheduler_uri: str
    # the global mesh's coordinator: the workers' process group meets
    # there (parallel/multihost.py init_from_env)
    coord_uri: str = ""
    num_serve: int = 0   # online serving shards (--serve group)

    @property
    def is_distributed(self) -> bool:
        return self.role is not None


def node_env() -> NodeEnv:
    role = os.environ.get("WH_ROLE")
    return NodeEnv(
        role=Role(role) if role else None,
        rank=int(os.environ.get("WH_RANK", "0")),
        num_workers=int(os.environ.get("WH_NUM_WORKERS", "1")),
        num_servers=int(os.environ.get("WH_NUM_SERVERS", "1")),
        scheduler_uri=os.environ.get("WH_SCHEDULER_URI", ""),
        coord_uri=os.environ.get("WH_COORD_URI", ""),
        num_serve=int(os.environ.get("WH_NUM_SERVE", "0")),
    )


# --------------------------------------------------------------- scheduler
class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        line = self.rfile.readline()
        if not line:
            return
        try:
            req = json.loads(line)
            resp = self.server.scheduler._dispatch(req)  # type: ignore
        except Exception as e:  # malformed request must not kill the server
            resp = {"error": repr(e)}
        self.wfile.write((json.dumps(resp) + "\n").encode())


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class Scheduler:
    """The scheduler node: owns the WorkloadPool, the summed Progress, and
    the liveness table. Start with serve(); stop() shuts down."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 node_timeout: float = 30.0, straggler: bool = True,
                 num_servers: int = 0, num_workers: int = 0,
                 journal_dir: Optional[str] = None):
        self.pool = WorkloadPool()
        self.num_workers = num_workers
        self._collect: "Optional[dict]" = None  # worker-local-data round
        self._round: "Optional[dict]" = None     # current dispatch round
        self.progress = Progress()
        self.node_timeout = node_timeout
        self.num_servers = num_servers
        self._server_uris: dict[int, str] = {}   # ps server rank -> uri
        self._serve_uris: dict[int, str] = {}    # serving shard rank -> uri
        self.num_serve_recoveries = 0            # shards that re-registered
        self._bsp_uris: dict[int, str] = {}      # bsp worker rank -> uri
        self._bsp_gen = 0                        # membership generation
        self._bsp_ready = False                  # group fully formed once
        self.num_bsp_recoveries = 0              # workers that re-registered
        self._lock = threading.Lock()
        self._nodes: dict[str, float] = {}       # node -> last seen
        # elastic membership: the epoch fences stale assignments across
        # join/leave/eviction; _members guards join idempotence (a
        # retried join must not double-bump); _retiring holds workers
        # the controller asked to drain and leave; _elastic_target is
        # the controller's published worker-count goal
        self._mepoch = 0
        self._members: set[str] = set()
        self._retiring: set[str] = set()
        self._elastic_target: Optional[int] = None
        self._elastic_thread: Optional[threading.Thread] = None
        self._barriers: dict[str, set] = {}      # name -> arrived nodes
        self._barrier_gen: dict[str, int] = {}   # name -> generation
        self._epoch = 0                          # bumped per dispatch round
        self._shutdown = False                   # job end; workers exit
        self._seen_workers: set[str] = set()     # workers ever registered
        self._blobs: dict[str, str] = {}         # rendezvous KV payloads
        # latest metrics snapshot each node piggybacked on a heartbeat
        # (keyed by node name, so a respawned server's snapshot replaces
        # its dead incarnation's — surviving-incarnation semantics, same
        # as PSClient.stats())
        self._node_metrics: dict[str, dict] = {}
        # flight-recorder control plane: a trigger bumps _flight_gen and
        # every subsequent RPC reply carries it (fgen/fwhy), so clients
        # dump their own rings around the same moment — the multi-node
        # black box. _burning_slos tracks which SLOs were already over
        # budget so only fresh crossings trigger (scrape thread only).
        self._flight_gen = 0
        self._flight_why = ""
        self._burning_slos: set[str] = set()
        self.num_server_recoveries = 0           # servers that re-registered
        self._done = False
        self._stop_evt = threading.Event()
        # metrics-over-time: a periodic sampler (WH_OBS_SCRAPE_SEC)
        # appends the aggregated cluster snapshot to this ring; the
        # `metrics` verb serves it as `history`
        self._snap_ring = _obs.SnapshotRing(int(knob_value("WH_OBS_RING")))
        self._scrape_sec = float(knob_value("WH_OBS_SCRAPE_SEC"))
        self._scrape_port = int(knob_value("WH_OBS_SCRAPE_PORT"))
        self._scrape_srv = None  # Prometheus HTTP endpoint, if enabled
        self._srv = _Server((host, port), _Handler)
        self._srv.scheduler = self  # type: ignore
        self._threads: list[threading.Thread] = []
        # exactly-once RPC: last (seq, reply) per sender — a retried op
        # whose reply was lost returns the cached reply instead of
        # re-executing; an OLDER seq is fenced as a pre-restart ghost
        self._replies: dict[str, tuple[int, dict]] = {}
        # durable control plane: write-ahead journal + replay (see
        # runtime/sched_journal.py). Replay runs BEFORE the straggler
        # killer starts so restored assignments cannot be re-queued
        # while the journal is still being applied.
        self._replaying = False
        self.incarnation = 0
        self._served_at = time.monotonic()
        self._compact_every = int(knob_value("WH_SCHED_JOURNAL_COMPACT"))
        self._journal: Optional[SchedulerJournal] = None
        if journal_dir:
            self._journal = SchedulerJournal(journal_dir)
            self._replay_journal()
            self.pool.on_requeue = self._journal_requeue
        _INCARNATION.set(float(self.incarnation))
        if straggler:
            self.pool.start_straggler_killer()

    # -- lifecycle ----------------------------------------------------------
    @property
    def uri(self) -> str:
        h, p = self._srv.server_address[:2]
        return f"{h}:{p}"

    def serve(self) -> None:
        self._served_at = time.monotonic()
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        w = threading.Thread(target=self._liveness_loop, daemon=True)
        w.start()
        self._threads.append(w)
        if self._scrape_sec > 0:
            s = threading.Thread(target=self._scrape_loop, daemon=True)
            s.start()
            self._threads.append(s)
        if self._scrape_port > 0:
            self._start_scrape_server()

    def announce_shutdown(self) -> None:
        """Mark the job finished; workers see it on their next epoch poll
        and exit their dispatch loop. Journaled — a scheduler respawned
        after a crash-during-drain resumes already shut down instead of
        restarting the pass loop."""
        with self._lock:
            self._shutdown = True
        if self._journal is not None:
            self._journal.record({"k": "shutdown"})

    def stop(self) -> None:
        self._done = True
        self._stop_evt.set()
        self.pool.stop_straggler_killer()
        if self._scrape_srv is not None:
            self._scrape_srv.shutdown()
            self._scrape_srv.server_close()
            self._scrape_srv = None
        self._srv.shutdown()
        self._srv.server_close()
        if self._journal is not None:
            self._journal.close()

    @staticmethod
    def from_env(env) -> "Scheduler":
        """Bind the scheduler on the URI the launcher allocated
        (WH_SCHEDULER_URI). When the launcher provides a snapshot dir
        (and WH_SCHED_JOURNAL is not disabled), the control plane
        journals there — a respawned scheduler replays it and resumes
        the job instead of restarting it."""
        host, port = env.scheduler_uri.rsplit(":", 1)
        jdir = os.environ.get("WH_SNAPSHOT_DIR") or None
        if jdir and not knob_value("WH_SCHED_JOURNAL"):
            jdir = None
        return Scheduler(
            host=host, port=int(port),
            node_timeout=float(os.environ.get("WH_NODE_TIMEOUT", "30")),
            num_servers=env.num_servers,
            num_workers=env.num_workers,
            journal_dir=jdir,
        )

    # -- durable control plane (journal + replay) ---------------------------
    def _replay_journal(self) -> None:
        """Restore state from the snapshot + journal tail. Called from
        __init__ (before any RPC thread exists); a corrupt record is
        skipped with a warning rather than bricking the respawn."""
        snap, records, max_inc = self._journal.load()
        had_state = snap is not None or bool(records)
        self._replaying = True
        try:
            if snap is not None:
                self._restore_state(snap)
            for rec in records:
                try:
                    self._apply_record(rec)
                except Exception as e:
                    print(f"[sched-journal] skipping bad "
                          f"{rec.get('k')!r} record: {e!r}", flush=True)
        finally:
            self._replaying = False
        self.incarnation = (max_inc + 1) if had_state else 0
        self._journal.record({"k": "inc", "inc": self.incarnation})
        if self.incarnation > 0:
            _RECOVERIES.inc()
            _trace.event("sched.resumed", cat="recovery",
                         inc=self.incarnation, records=len(records),
                         snapshot=snap is not None)
            self._flight_trigger(f"sched.resumed inc={self.incarnation}")
            print(f"[recovery] scheduler resumed at incarnation "
                  f"{self.incarnation} (snapshot="
                  f"{'yes' if snap else 'no'}, {len(records)} journal "
                  f"records replayed; epoch {self._epoch}, mepoch "
                  f"{self._mepoch})", flush=True)

    def _apply_record(self, rec: dict) -> None:
        """Re-apply one journal record during replay (chronological)."""
        k = rec.get("k")
        if k == "inc":
            return
        if k == "rpc":
            req = rec["req"]
            op = req.get("op")
            resp = rec.get("resp", {})
            if op == "get":
                # `get` picks randomly — apply the journaled choice
                # instead of re-rolling a different assignment
                if "part_id" in resp:
                    self.pool.assign_part(int(resp["part_id"]),
                                          req.get("node", "?"),
                                          resp.get("mepoch"))
            else:
                self._dispatch_op(op, req)
            sender, seq = req.get("sender"), req.get("seq")
            if sender is not None and seq is not None:
                # the cache holds the JOURNALED reply, not a recomputed
                # one — a post-restart retry must see the original
                with self._lock:
                    prev = self._replies.get(sender)
                    if prev is None or int(seq) >= prev[0]:
                        self._replies[sender] = (int(seq), resp)
            return
        if k == "round":
            self._apply_round_record(rec)
            return
        if k == "evict":
            n = rec["node"]
            _EVICTIONS.inc()
            with self._lock:
                self._nodes.pop(n, None)
            self._handle_dead_node(n)
            return
        if k == "requeue":
            self.pool.requeue_parts([int(i) for i in rec.get("parts", [])])
            return
        if k == "shutdown":
            with self._lock:
                self._shutdown = True
            return
        if k == "blob":
            with self._lock:
                self._blobs[rec["key"]] = rec["data"]
            return
        print(f"[sched-journal] unknown record kind {k!r}; skipped",
              flush=True)

    def _apply_round_record(self, rec: dict) -> None:
        self.pool.clear()
        with self._lock:
            self.progress = Progress()
            self._epoch = int(rec["epoch"])
            self._round = rec["round"]
            c = rec.get("collect")
            self._collect = (dict(pattern=c["pattern"], npp=c["npp"],
                                  fmt=c["fmt"],
                                  reported=set(c.get("reported", [])))
                             if c else None)
        if rec.get("parts") is not None:
            self.pool.load_state(rec["parts"])

    def _journal_round(self) -> None:
        """Append the round record (epoch, round, collect, pool fill)
        right after a round becomes visible. Also the compaction hook:
        round starts are the only quiescent point where no non-idempotent
        record (report/finish progress) can straddle the snapshot."""
        if self._journal is None:
            return
        if (self._compact_every > 0
                and self._journal.appends_since_compact
                >= self._compact_every):
            self._journal.compact(self._durable_state)
            print(f"[sched-journal] compacted into snapshot "
                  f"(epoch {self._epoch})", flush=True)
        with self._lock:
            rec = {"k": "round", "epoch": self._epoch,
                   "round": dict(self._round),
                   "collect": (dict(pattern=self._collect["pattern"],
                                    npp=self._collect["npp"],
                                    fmt=self._collect["fmt"],
                                    reported=sorted(
                                        self._collect["reported"]))
                               if self._collect is not None else None)}
        rec["parts"] = self.pool.export_state()
        self._journal.record(rec)

    def _journal_requeue(self, part_ids: list) -> None:
        """pool.on_requeue hook: the straggler watchdog re-queued parts;
        journal it so a replayed pool agrees about ownership (owner
        cleared, membership stamp kept)."""
        if self._journal is not None and not self._replaying:
            self._journal.record({"k": "requeue", "parts": list(part_ids)})

    def _record_op(self, op, req: dict, resp: dict,
                   sender, seq) -> None:
        """Cache the reply (exactly-once dedup) and append the RPC
        record. WAL order is effect -> journal -> reply: a crash between
        effect and journal loses the effect, but the reply was never
        sent, so the client's retry re-executes it — still exactly
        once."""
        if "error" in resp:
            return
        with self._lock:
            self._replies[sender] = (int(seq), resp)
        if self._journal is None or self._replaying:
            return
        if op not in _JOURNALED_OPS and not (op == "get"
                                             and "part_id" in resp):
            return
        jreq = dict(req)
        if op not in ("bye", "leave"):
            # heartbeat-piggybacked metrics snapshots are bulky and
            # refresh within seconds of a respawn; only the FINAL
            # snapshot a departing node sends is worth replaying
            jreq.pop("metrics", None)
        self._journal.record({"k": "rpc", "req": jreq, "resp": resp})

    def _durable_state(self) -> dict:
        """Everything a respawned scheduler needs, as one JSON-able
        snapshot (the compaction target). URI maps are stored as
        [rank, uri] pairs — JSON would silently turn int keys into
        strings. Counter values ride along so the end-of-run report
        adds up across incarnations."""
        with self._lock:
            state = {
                "inc": self.incarnation,
                "epoch": self._epoch,
                "round": self._round,
                "collect": (dict(pattern=self._collect["pattern"],
                                 npp=self._collect["npp"],
                                 fmt=self._collect["fmt"],
                                 reported=sorted(
                                     self._collect["reported"]))
                            if self._collect is not None else None),
                "mepoch": self._mepoch,
                "members": sorted(self._members),
                "retiring": sorted(self._retiring),
                "seen_workers": sorted(self._seen_workers),
                "blobs": dict(self._blobs),
                "server_uris": [[r, u] for r, u
                                in sorted(self._server_uris.items())],
                "serve_uris": [[r, u] for r, u
                               in sorted(self._serve_uris.items())],
                "bsp_uris": [[r, u] for r, u
                             in sorted(self._bsp_uris.items())],
                "bsp_gen": self._bsp_gen,
                "bsp_ready": self._bsp_ready,
                "barrier_gen": dict(self._barrier_gen),
                "barriers": {k: sorted(v)
                             for k, v in self._barriers.items()},
                "shutdown": self._shutdown,
                "replies": {s: [q, r]
                            for s, (q, r) in self._replies.items()},
                "recoveries": [self.num_server_recoveries,
                               self.num_serve_recoveries,
                               self.num_bsp_recoveries],
                "node_metrics": dict(self._node_metrics),
                "progress": dict(self.progress.tot),
            }
        counters = _obs.REGISTRY.snapshot()["counters"]
        state["counters"] = {
            n: v for n, v in counters.items()
            if v and (n.startswith("sched.") or n == "bsp.recoveries")
        }
        state["pool"] = self.pool.export_state()
        return state

    def _restore_state(self, s: dict) -> None:
        with self._lock:
            self._epoch = int(s.get("epoch", 0))
            self._round = s.get("round")
            c = s.get("collect")
            self._collect = (dict(pattern=c["pattern"], npp=c["npp"],
                                  fmt=c["fmt"],
                                  reported=set(c.get("reported", [])))
                             if c else None)
            self._mepoch = int(s.get("mepoch", 0))
            self._members = set(s.get("members", []))
            self._retiring = set(s.get("retiring", []))
            self._seen_workers = set(s.get("seen_workers", []))
            self._blobs = dict(s.get("blobs", {}))
            self._server_uris = {int(r): u
                                 for r, u in s.get("server_uris", [])}
            self._serve_uris = {int(r): u
                                for r, u in s.get("serve_uris", [])}
            self._bsp_uris = {int(r): u
                              for r, u in s.get("bsp_uris", [])}
            self._bsp_gen = int(s.get("bsp_gen", 0))
            self._bsp_ready = bool(s.get("bsp_ready", False))
            self._barrier_gen = {k: int(v) for k, v
                                 in s.get("barrier_gen", {}).items()}
            self._barriers = {k: set(v) for k, v
                              in s.get("barriers", {}).items()}
            self._shutdown = bool(s.get("shutdown", False))
            self._replies = {snd: (int(q), r) for snd, (q, r)
                             in s.get("replies", {}).items()}
            rec = s.get("recoveries", [0, 0, 0])
            self.num_server_recoveries = int(rec[0])
            self.num_serve_recoveries = int(rec[1])
            self.num_bsp_recoveries = int(rec[2])
            self._node_metrics = dict(s.get("node_metrics", {}))
            self.progress.merge(s.get("progress", {}))
        for name, v in (s.get("counters") or {}).items():
            if v:
                _obs.REGISTRY.counter(name).inc(int(v))
        if s.get("pool"):
            self.pool.load_state(s["pool"])

    def publish_blob(self, key: str, data: str) -> None:
        """Scheduler-side blob publish, journaled (unlike a direct
        _blobs poke) so it survives a restart — e.g. the runner's
        model-loaded marker must not cause a respawned scheduler to
        re-load the input model over live training state."""
        with self._lock:
            self._blobs[key] = data
        if self._journal is not None:
            self._journal.record({"k": "blob", "key": key, "data": data})

    def has_blob(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs

    # -- dispatch round management -----------------------------------------
    def start_round(self, pattern: str, num_parts_per_file: int,
                    fmt: str, wtype: WorkType, data_pass: int,
                    local_data: bool = False,
                    dispatch: str = "online") -> int:
        """Load a pass's file parts into the pool (StartDispatch parity,
        data_parallel.h:93-115). Ordering matters both ways: the epoch is
        bumped BEFORE the pool refills so a worker still polling the old
        round can never be handed a new-round part under the old round's
        semantics (its stale-epoch `get` returns {wait}), and a new-epoch
        worker polling mid-fill sees the empty pool as not-finished
        (WorkloadPool.is_finished) rather than as an instantly-over
        round."""
        self.pool.clear()
        # worker-local data (reference data_parallel.h:82,96-100):
        # workers match the pattern against THEIR filesystems and
        # report; parts then carry node affinity
        collect = (dict(pattern=pattern, npp=num_parts_per_file,
                        fmt=fmt, reported=set())
                   if local_data else None)
        with self._lock:
            # rebind under the lock: handler threads merge() into the
            # current Progress and must not see a half-published swap
            self.progress = Progress()
            self._epoch += 1
            self._round = dict(type=int(wtype), data_pass=data_pass)
            self._collect = collect
        n = 0
        if not local_data:
            n = self.pool.add(pattern, num_parts_per_file, fmt)
            if n == 0:
                raise FileNotFoundError(f"no files match {pattern}")
            if dispatch == "batch" and self.num_workers > 0:
                # stable n/num_workers assignment, unchanged between
                # passes (reference batch mode, data_parallel.h:54-60)
                self.pool.assign_stable(
                    [f"worker-{r}" for r in range(self.num_workers)])
        self._journal_round()
        return n

    def _round_finished(self) -> bool:
        """A worker-local-data round is only over when every expected
        worker has reported its files AND all reported parts are done —
        otherwise a fast worker draining its own parts would end the
        round before a slow worker's files ever entered the pool. A
        collect round where every worker reported zero files terminates
        (as an empty round) instead of spinning; wait_round raises the
        same FileNotFoundError the non-local path does."""
        with self._lock:
            if self._collect is not None and self.num_workers > 0:
                if len(self._collect["reported"]) < self.num_workers:
                    return False
                if self.pool.size() == 0:
                    return True
        return self.pool.is_finished()

    def wait_round(self, print_sec: float = 1.0, t0: Optional[float] = None,
                   verbose: bool = True) -> Progress:
        """Block until every part is done, printing progress rows
        (ShowProgress parity, minibatch_solver.h:169-192). Completion is
        polled every ~0.2s regardless of print_sec — print_sec controls
        only row cadence. (Sleeping print_sec between completion checks
        stalled every job whose conf quieted output with a large
        print_sec: a round that drained in 100s held the scheduler for
        the full print interval — the r3 PS bench timeout.)"""
        t0 = t0 or time.time()
        if verbose:
            print(Progress.header(), flush=True)
        next_print = time.time() + print_sec
        none_live_since: Optional[float] = None
        while not self._round_finished():
            time.sleep(min(0.2, print_sec))
            live = self.live_workers()
            if self._seen_workers and not live:
                # every worker gone from the liveness table. Workers run
                # a LivenessPinger, so eviction means real death — but
                # grant one extra node_timeout of grace before aborting
                # so a transient stall (GC pause, ping thread descheduled)
                # can never kill a healthy job. After that, abort with a
                # clear error instead of waiting forever for parts nobody
                # will finish; the job is resumable from the last
                # save_iter snapshot.
                now = time.monotonic()
                if none_live_since is None:
                    none_live_since = now
                elif now - none_live_since > self.node_timeout:
                    raise RuntimeError(
                        "all workers lost mid-round; aborting the job "
                        "(resume from the last _iter-K checkpoint with "
                        "model_in/load_iter)")
            else:
                none_live_since = None
            if verbose and time.time() >= next_print:
                print(self.progress.row(t0), flush=True)
                next_print = time.time() + print_sec
        with self._lock:
            empty_collect = (self._collect is not None
                             and self.pool.size() == 0)
            pattern = self._collect["pattern"] if empty_collect else None
        if empty_collect:
            raise FileNotFoundError(
                f"no worker matched any file for {pattern!r}")
        if verbose:
            print(self.progress.row(t0), flush=True)
        return self.progress

    # -- RPC ops ------------------------------------------------------------
    def _dispatch(self, req: dict) -> dict:  # wormlint: thread-entry
        op = req.get("op")
        t0 = time.perf_counter()
        try:
            # deadline shed, telemetry ops only (control ops always
            # dispatch): anchor the carried relative deadline and bounce
            # the request if its budget was spent in transit
            _overload.arm(req)
            if op in _SHEDDABLE_SCHED_OPS and _overload.should_shed(req):
                return dict(_overload.shed_reply(req),
                            inc=self.incarnation)
            sender, seq = req.get("sender"), req.get("seq")
            if sender is not None and seq is not None:
                with self._lock:
                    cached = self._replies.get(sender)
                if cached is not None:
                    if seq == cached[0]:
                        # duplicate of this sender's last applied op (a
                        # retry whose reply was lost, possibly across a
                        # restart): return the recorded reply instead
                        # of re-executing — exactly-once
                        _DEDUP_HITS.inc()
                        resp = dict(cached[1])
                        resp["inc"] = self.incarnation
                        return resp
                    if seq < cached[0]:
                        # incarnation fence: an older seq can only be a
                        # ghost from before a restart
                        return {"error": f"stale scheduler seq {seq} < "
                                         f"{cached[0]} from {sender}",
                                "inc": self.incarnation}
            resp = self._dispatch_op(op, req)
            resp["inc"] = self.incarnation
            if self._flight_gen:
                # piggyback the flight generation + trigger reason so
                # every client learns of a cluster trigger on its next
                # RPC (heartbeats flow constantly) and dumps its rings
                with self._lock:
                    resp["fgen"] = self._flight_gen
                    resp["fwhy"] = self._flight_why
            if sender is not None and seq is not None:
                self._record_op(op, req, resp, sender, seq)
            return resp
        finally:
            _obs.REGISTRY.histogram(f"sched.op.{op}_s").observe(
                time.perf_counter() - t0)

    def _dispatch_op(self, op, req: dict) -> dict:  # wormlint: thread-entry
        if faults.ACTIVE is not None and not self._replaying:
            # journal replay re-runs recorded ops; armed faults (drops,
            # kills) must not fire on historical traffic
            faults.ACTIVE.sched_op(op)
        node = req.get("node", "?")
        snap = req.get("metrics")
        with self._lock:
            self._nodes[node] = time.monotonic()
            if node.startswith("worker"):
                self._seen_workers.add(node)
            if isinstance(snap, dict):
                # heartbeat-piggybacked metrics snapshot (any op may
                # carry one; LivenessPinger/heartbeat loops do, and a
                # final one rides the worker's `bye`)
                self._node_metrics[node] = snap
        if op == "metrics":
            got = self.aggregate_metrics()
            if req.get("format") == "prom":
                # Prometheus text exposition over the RPC channel, for
                # scrapers that bridge the newline-JSON protocol (the
                # WH_OBS_SCRAPE_PORT endpoint serves the same body)
                return {"ok": True, "nodes": got["nodes"],
                        "prom": _prom.render_snapshot(got["aggregate"])}
            out = {"ok": True, **got}
            if req.get("history"):
                out["history"] = [{"ts": ts, "aggregate": snap}
                                  for ts, snap in self._snap_ring.items()]
            if req.get("slo"):
                out["slos"] = _slo.evaluate(got["aggregate"],
                                            publish=False)
            return out
        if op == "register":
            return {"ok": True, "epoch": self._epoch,
                    "mepoch": self._mepoch}
        if op == "join":
            # a worker joining a RUNNING job (elastic membership): admit
            # it and bump the membership epoch so both planes observe the
            # change. Idempotent — a joiner retrying its join RPC bumps
            # only once.
            with self._lock:
                fresh = node not in self._members
                self._members.add(node)
            if fresh:
                _JOINS.inc()
                _trace.event("sched.member_join", cat="membership",
                             node=node)
                self.progress.merge({"member_joins": 1.0})
                self._member_change("join", node)
            return {"ok": True, "epoch": self._epoch,
                    "mepoch": self._mepoch}
        if op == "leave":
            # a worker resigning cleanly (retired by the controller, or
            # degrading out of a partition after bounded retries): drop
            # it from liveness NOW instead of burning a node_timeout,
            # re-queue anything it still held, and bump the epoch.
            with self._lock:
                self._nodes.pop(node, None)
                self._members.discard(node)
                self._retiring.discard(node)
            requeued = self.pool.reset(node)
            self.pool.drop_node(node)
            if requeued:
                print(f"[membership] {node} left holding {requeued} "
                      "parts; re-queued", flush=True)
            _LEAVES.inc()
            _trace.event("sched.member_leave", cat="membership", node=node)
            with self._lock:
                self.progress.merge({"member_leaves": 1.0})
            self._member_change("leave", node)
            return {"ok": True, "mepoch": self._mepoch}
        if op == "elastic":
            # the elastic supervisor's poll (launcher --elastic): read
            # the controller's current worker-count target and the live
            # set; a caller may also publish a target here (drills).
            if req.get("target") is not None:
                self.set_elastic_target(int(req["target"]))
            with self._lock:
                live = sorted(n for n in self._nodes
                              if n.startswith("worker"))
                return {"ok": True, "target": self._elastic_target,
                        "live": live, "retiring": sorted(self._retiring),
                        "mepoch": self._mepoch,
                        "shutdown": self._shutdown}
        if op == "register_server":
            # a ps server announces its push/pull endpoint (the ps-lite
            # node-manager rendezvous role). A rank re-registering under
            # a NEW uri is a respawned server rejoining — a first-class
            # recovery event: log it and count it into progress so the
            # job's output records that a failover happened.
            with self._lock:
                rank = int(req["rank"])
                prev = self._server_uris.get(rank)
                self._server_uris[rank] = req["uri"]
                recovered = prev is not None and prev != req["uri"]
                if recovered:
                    self.num_server_recoveries += 1
                    self.progress.merge({"server_recoveries": 1.0})
            if recovered:
                _SRV_RECOVERIES.inc()
                _trace.event("sched.server_recovered", cat="recovery",
                             rank=rank, uri=req["uri"], prev=prev)
                self._flight_trigger(f"server-{rank} recovered")
                print(f"[recovery] ps server-{rank} re-registered at "
                      f"{req['uri']} (was {prev})", flush=True)
            return {"ok": True}
        if op == "register_serve":
            # a serving shard announces its predict endpoint. A rank
            # re-registering under a NEW uri is a respawned shard
            # rejoining after death — routers following the serve_nodes
            # resolver pick the new address up on their next retry.
            with self._lock:
                rank = int(req["rank"])
                prev = self._serve_uris.get(rank)
                self._serve_uris[rank] = req["uri"]
                recovered = prev is not None and prev != req["uri"]
                if recovered:
                    self.num_serve_recoveries += 1
                    self.progress.merge({"serve_recoveries": 1.0})
            if recovered:
                _SERVE_RECOVERIES.inc()
                _trace.event("sched.serve_recovered", cat="recovery",
                             rank=rank, uri=req["uri"], prev=prev)
                self._flight_trigger(f"serve-shard-{rank} recovered")
                print(f"[recovery] serve shard-{rank} re-registered at "
                      f"{req['uri']} (was {prev})", flush=True)
            return {"ok": True}
        if op == "serve_nodes":
            # routers poll until the full --serve group is up, and
            # re-poll after a socket error to chase a respawned shard
            world = int(req.get("world", 0))
            with self._lock:
                known = len(self._serve_uris)
                ready = known >= world > 0
                uris = [self._serve_uris[r]
                        for r in sorted(self._serve_uris)] if ready else []
            return {"ready": ready, "uris": uris, "num_known": known}
        if op == "register_bsp":
            # a BSP worker announces its ring endpoint. A rank
            # re-registering under a NEW uri is a respawned worker
            # rejoining: bump the membership GENERATION — the signal
            # survivors blocked mid-round poll for (runtime/allreduce.py
            # aborts and replays the round at the new generation).
            with self._lock:
                rank = int(req["rank"])
                prev = self._bsp_uris.get(rank)
                self._bsp_uris[rank] = req["uri"]
                recovered = prev is not None and prev != req["uri"]
                # a rank the formed group has never seen is an ELASTIC
                # JOIN: bump the generation so survivors rebuild the
                # ring over the grown peer set at their next version
                # boundary (before the group first forms, new ranks are
                # just the initial rendezvous filling up)
                joined = prev is None and self._bsp_ready
                if recovered:
                    self._bsp_gen += 1
                    self.num_bsp_recoveries += 1
                    self.progress.merge({"bsp_recoveries": 1.0})
                elif joined:
                    self._bsp_gen += 1
                gen = self._bsp_gen
            if recovered:
                _BSP_RECOVERIES.inc()
                _trace.event("sched.bsp_recovered", cat="recovery",
                             rank=rank, uri=req["uri"], prev=prev)
                self._flight_trigger(f"bsp-worker-{rank} recovered")
                print(f"[recovery] bsp worker-{rank} re-registered at "
                      f"{req['uri']} (was {prev}); generation -> {gen}",
                      flush=True)
            elif joined:
                print(f"[membership] bsp worker-{rank} joined at "
                      f"{req['uri']}; generation -> {gen}", flush=True)
            return {"ok": True, "gen": gen}
        if op == "bsp_peers":
            # BSP workers poll until the full group is up, and re-poll
            # mid-round to detect membership changes. Once the group
            # has formed ONCE, the reply reports the CURRENT set even
            # when it is smaller than the caller's world — that is how
            # survivors of a leave adopt the shrunk ring instead of
            # waiting forever for a peer that resigned.
            world = int(req.get("world", self.num_workers))
            with self._lock:
                full = len(self._bsp_uris) >= world > 0
                if full:
                    self._bsp_ready = True
                ready = full or (self._bsp_ready and bool(self._bsp_uris))
                uris = [self._bsp_uris[r]
                        for r in sorted(self._bsp_uris)] if ready else []
                gen = self._bsp_gen
            return {"ready": ready, "gen": gen, "uris": uris,
                    "num_known": len(self._bsp_uris)}
        if op == "bsp_leave":
            # a BSP worker resigning for good (not a respawn): shrink
            # the peer set and bump the generation; survivors rebuild
            # the ring without it.
            with self._lock:
                rank = int(req["rank"])
                uri = req.get("uri")
                # key by rank when it still maps to this worker's uri;
                # otherwise fall back to a uri scan — an elastic
                # survivor may have RE-INDEXED its rank since it
                # registered (allreduce.py _adopt), so the uri is the
                # stable identity
                if uri is None or self._bsp_uris.get(rank) == uri:
                    left = self._bsp_uris.pop(rank, None) is not None
                else:
                    left = False
                    for r, u in list(self._bsp_uris.items()):
                        if u == uri:
                            del self._bsp_uris[r]
                            rank, left = r, True
                            break
                if left:
                    self._bsp_gen += 1
                gen = self._bsp_gen
            if left:
                print(f"[membership] bsp worker-{rank} left; "
                      f"generation -> {gen}", flush=True)
            return {"ok": True, "gen": gen}
        if op == "servers":
            # workers poll until the full `-s` group is up
            with self._lock:
                ready = len(self._server_uris) >= self.num_servers
                uris = [self._server_uris[r]
                        for r in sorted(self._server_uris)] if ready else []
            return {"ready": ready, "uris": uris,
                    "num_known": len(self._server_uris),
                    "num_servers": self.num_servers}
        if op == "get":
            with self._lock:
                retire = node in self._retiring
                mepoch = self._mepoch
            if retire:
                # a retiring worker gets no new parts: it drains what it
                # holds, flushes, and leaves
                return {"wait": True, "retire": True, "epoch": self._epoch,
                        "mepoch": mepoch}
            if req.get("epoch") != self._epoch:
                # worker is in an older round; tell it to resync
                return {"wait": True, "epoch": self._epoch,
                        "mepoch": mepoch}
            with self._lock:
                if (self._collect is not None
                        and node not in self._collect["reported"]):
                    # worker-local-data round: this node must first match
                    # the pattern locally and report its files
                    return {"match": self._collect["pattern"],
                            "epoch": self._epoch}
            got = self.pool.get(node, mepoch=mepoch)
            if got is None:
                done = self._round_finished()
                return {"done": done, "wait": not done,
                        "epoch": self._epoch, "mepoch": mepoch}
            part_id, f = got
            return {
                "part_id": part_id,
                "file": dataclasses.asdict(f),
                "round": self._round,
                "epoch": self._epoch,
                "mepoch": mepoch,
            }
        if op == "add_local":
            with self._lock:
                c = self._collect
                if c is None or req.get("epoch") != self._epoch:
                    return {"ok": False}
                c["reported"].add(node)
                npp, fmt = c["npp"], c["fmt"]
            n = self.pool.add_files(req.get("files", []), npp, fmt,
                                    node=node)
            return {"ok": True, "num_files": n}
        if op == "finish":
            # fenced completion: besides the round epoch, the pool
            # rejects a finish whose sender no longer owns the part — a
            # node declared dead (assignment reset, membership epoch
            # bumped) that comes BACK cannot double-apply its stale
            # assignment; the part's re-execution by a live owner is
            # what counts
            counted = (req.get("epoch") == self._epoch
                       and self.pool.finish(req["part_id"], node=node,
                                            mepoch=req.get("mepoch")))
            # a straggler twin's duplicate finish is dropped so its
            # progress is not double-counted (at-least-once execution,
            # exactly-once accounting); merges run under the lock since
            # handler threads are concurrent
            if counted and req.get("progress"):
                with self._lock:
                    self.progress.merge(req["progress"])
            return {"ok": True, "counted": counted}
        if op == "report":  # pure progress push (ps::Slave channel)
            with self._lock:
                self.progress.merge(req.get("progress", {}))
            return {"ok": True}
        if op == "blob_put":
            # tiny rendezvous KV (host-side rabit::Broadcast payloads,
            # e.g. the k-means centroid init from rank 0)
            with self._lock:
                self._blobs[req["key"]] = req["data"]
            return {"ok": True}
        if op == "blob_del":
            # consumed rendezvous payloads should not sit in scheduler
            # memory for the job's lifetime
            with self._lock:
                self._blobs.pop(req["key"], None)
            return {"ok": True}
        if op == "blob_get":
            with self._lock:
                data = self._blobs.get(req["key"])
            return {"ok": data is not None, "data": data}
        if op == "bye":
            # explicit deregistration (global-mesh workers) so liveness
            # does not have to time the node out
            with self._lock:
                self._nodes.pop(node, None)
            return {"ok": True}
        if op == "epoch":
            with self._lock:
                retire = node in self._retiring
            return {"epoch": self._epoch,
                    "round": getattr(self, "_round", None),
                    "shutdown": self._shutdown,
                    "mepoch": self._mepoch,
                    "retire": retire}
        if op == "barrier":
            return self._barrier_enter(req["name"], node, req["world"])
        if op == "barrier_wait":
            with self._lock:
                gen = self._barrier_gen.get(req["name"], 0)
            return {"released": gen > req["gen"]}
        if op == "flight":
            # explicit black-box dump: dump this node's rings NOW and
            # bump the generation so every client dumps on its next RPC
            reason = str(req.get("reason") or "flight-verb")
            path = self._flight_trigger(reason)
            with self._lock:
                gen = self._flight_gen
            return {"ok": True, "enabled": _flight.ACTIVE is not None,
                    "path": path, "fgen": gen}
        return {"error": f"unknown op {op!r}"}

    def _barrier_enter(self, name: str, node: str, world: int) -> dict:
        """A node arrives at the named barrier. Returns the generation it
        belongs to; the barrier releases (generation increments) when
        `world` distinct nodes of that generation have arrived."""
        with self._lock:
            gen = self._barrier_gen.setdefault(name, 0)
            arrived = self._barriers.setdefault(name, set())
            arrived.add(node)
            if len(arrived) >= world:
                self._barrier_gen[name] = gen + 1
                self._barriers[name] = set()
                return {"released": True, "gen": gen}
            return {"released": False, "gen": gen}

    # -- elastic membership -------------------------------------------------
    @property
    def membership_epoch(self) -> int:
        return self._mepoch

    def _member_change(self, why: str, node: str) -> None:
        """The worker set changed (join/leave/eviction): bump the
        membership epoch and rebalance pinned parts over the live set.
        Must be called WITHOUT the lock held."""
        with self._lock:
            self._mepoch += 1
            mepoch = self._mepoch
            live = sorted((n for n in self._nodes
                           if n.startswith("worker")), key=_worker_rank)
        _MEPOCHS.inc()
        repinned = self.pool.repin(live) if live else 0
        print(f"[membership] epoch -> {mepoch} ({why}: {node}); "
              f"{len(live)} live workers"
              + (f", {repinned} parts re-pinned" if repinned else ""),
              flush=True)

    def set_elastic_target(self, target: int) -> None:
        """Publish the controller's worker-count goal. Growing is the
        launcher's half (spawn processes; they `join`); shrinking is
        decided HERE — the highest-ranked live workers are marked
        retiring, drain their current part, flush, and `leave`."""
        with self._lock:
            self._elastic_target = int(target)
            live = sorted((n for n in self._nodes
                           if n.startswith("worker")), key=_worker_rank)
            active = [n for n in live if n not in self._retiring]
            excess = len(active) - self._elastic_target
            newly = []
            if excess > 0:
                for n in sorted(active, key=_worker_rank,
                                reverse=True)[:excess]:
                    self._retiring.add(n)
                    newly.append(n)
        for n in newly:
            print(f"[membership] retiring {n} (target "
                  f"{target} < {len(active)} active)", flush=True)

    def start_membership_controller(self, initial_workers: int,
                                    controller=None) -> None:
        """WH_ELASTIC decision loop: every WH_ELASTIC_SEC either follow
        the scripted WH_ELASTIC_PLAN (`join@<sec>,leave@<sec>` offsets
        from start — deterministic churn for drills) or feed the
        cluster-aggregated `queue.depth` / `loader.stall_s` gauges to a
        MembershipController (solver/minibatch_solver.py) and publish
        its target."""
        if self._elastic_thread is not None:
            return
        cadence = float(knob_value("WH_ELASTIC_SEC"))
        plan = _parse_elastic_plan(str(knob_value("WH_ELASTIC_PLAN") or ""))
        if controller is None and not plan:
            from wormhole_tpu_torch.solver.minibatch_solver import (
                MembershipController,
            )

            lo = int(knob_value("WH_ELASTIC_MIN"))
            hi = int(knob_value("WH_ELASTIC_MAX")) or 2 * initial_workers
            controller = MembershipController(initial_workers, lo=lo, hi=hi)
        t0 = time.monotonic()

        def loop():  # wormlint: thread-entry
            while not self._stop_evt.wait(max(cadence, 0.2)):
                try:
                    if plan:
                        target = initial_workers + sum(
                            delta for at, delta in plan
                            if time.monotonic() - t0 >= at)
                    else:
                        agg = self.aggregate_metrics()["aggregate"]
                        gauges = agg.get("gauges", {})
                        target = controller.record(
                            float(gauges.get("queue.depth") or 0.0),
                            float(gauges.get("loader.stall_s") or 0.0),
                            live=len(self.live_workers()))
                    if target is not None:
                        self.set_elastic_target(target)
                except Exception:
                    pass  # a malformed snapshot must not kill the loop

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._elastic_thread = t
        self._threads.append(t)

    # -- telemetry ----------------------------------------------------------
    def _flight_trigger(self, reason: str) -> Optional[str]:
        """An anomaly fired: dump this node's flight rings and bump the
        generation every RPC reply piggybacks, so the whole cluster
        dumps its recent past around the same moment. No-op (and no
        generation bump — replies stay byte-identical) when the flight
        recorder is disabled."""
        if _flight.ACTIVE is None:
            return None
        with self._lock:
            self._flight_gen += 1
            self._flight_why = reason
        return _flight.dump(reason, force=True)

    def _scrape_loop(self) -> None:  # wormlint: thread-entry
        """WH_OBS_SCRAPE_SEC sampler: append the aggregated cluster
        snapshot to the ring every tick (metrics over time, not just
        final values) and refresh the slo.*_burn gauges so burn rates
        ride heartbeats and scrapes like any other metric. A FRESH
        SLO-burn crossing (an objective newly over budget this tick)
        triggers a cluster-wide flight dump."""
        while not self._stop_evt.wait(self._scrape_sec):
            try:
                got = self.aggregate_metrics()
            except Exception:
                continue  # a malformed node snapshot must not kill it
            slos = _slo.evaluate(got["aggregate"])
            burning = {v["name"] for v in slos if not v.get("ok", True)}
            with self._lock:
                fresh = burning - self._burning_slos
                self._burning_slos = burning
            if fresh:
                self._flight_trigger(
                    "slo-burn: " + ",".join(sorted(fresh)))
            self._snap_ring.add(time.time(), got["aggregate"])
            _RING_DEPTH.set(float(len(self._snap_ring)))

    def _start_scrape_server(self) -> None:
        """Prometheus text-exposition endpoint (WH_OBS_SCRAPE_PORT):
        GET /metrics renders the live aggregated snapshot."""
        import http.server

        sched = self

        class _MetricsHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                _SCRAPES.inc()
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = _prom.render_snapshot(
                    sched.aggregate_metrics()["aggregate"]).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass  # scrapes are periodic; don't spam stderr

        host = self._srv.server_address[0]
        self._scrape_srv = http.server.ThreadingHTTPServer(
            (host, self._scrape_port), _MetricsHandler)
        t = threading.Thread(target=self._scrape_srv.serve_forever,
                             daemon=True)
        t.start()
        self._threads.append(t)

    def aggregate_metrics(self) -> dict:
        """Cluster-wide metrics view: this process's registry merged
        with the latest snapshot each node piggybacked on a heartbeat.
        The payload of the `metrics` dispatch verb and the raw material
        of the end-of-run report (obs/report.py)."""
        with self._lock:
            snaps = dict(self._node_metrics)
        merged = _obs.merge_snapshots(
            [_obs.REGISTRY.snapshot(), *snaps.values()])
        return {"nodes": sorted(snaps), "aggregate": merged}

    # -- liveness -----------------------------------------------------------
    def live_workers(self) -> list[str]:
        """Workers currently in the liveness table."""
        with self._lock:
            return [n for n in self._nodes if n.startswith("worker")]

    def workers_drained(self, expect: int) -> bool:
        """True once `expect` distinct workers have registered AND none
        remain live — the shutdown-drain condition (a fast worker's
        deregistration must not read as 'everyone finished' while a
        slow-starting peer has yet to register)."""
        if (self.incarnation > 0
                and time.monotonic() - self._served_at < 6.0):
            # a respawned scheduler's liveness table starts from the
            # replayed journal, which may be empty of live workers; let
            # the LivenessPinger cadence (2s) repopulate it before
            # trusting emptiness as "drained"
            return False
        with self._lock:
            if len(self._seen_workers) < expect:
                return False
            return not any(n.startswith("worker") for n in self._nodes)

    def workers_ever_seen(self) -> int:
        """How many distinct workers have registered so far (the drain
        fast-path: a mis-launched job where NO worker ever arrives
        should exit after one liveness window, not the full drain
        bound — VERDICT r4 weak #6)."""
        with self._lock:
            return len(self._seen_workers)

    def _liveness_loop(self) -> None:
        while not self._done:
            time.sleep(min(self.node_timeout / 3, 5.0))
            now = time.monotonic()
            with self._lock:
                dead = [n for n, seen in self._nodes.items()
                        if now - seen > self.node_timeout]
                for n in dead:
                    del self._nodes[n]
            if dead:
                _EVICTIONS.inc(len(dead))
            for n in dead:
                if self._journal is not None:
                    self._journal.record({"k": "evict", "node": n})
                self._handle_dead_node(n)

    def _handle_dead_node(self, n: str) -> None:
        """Evict one node that dropped off the liveness plane (shared
        between the watchdog and journal replay of `evict` records)."""
        _trace.event("sched.liveness_evict", cat="recovery", node=n)
        if not self._replaying:
            self._flight_trigger(f"liveness-evict {n}")
        if n.startswith("server"):
            # servers carry no pool parts; their loss is its own
            # first-class event (the launcher's respawn loop — if
            # enabled — brings the process back; workers ride it
            # out through the PSClient retry path)
            print(f"[recovery] ps {n} lost from the liveness "
                  "plane (no epoch ping for "
                  f"{self.node_timeout:.0f}s); awaiting respawn "
                  "or worker-side retry failure", flush=True)
            return
        requeued = self.pool.reset(n)
        if requeued:
            print(f"node {n} lost; re-queued {requeued} parts",
                  flush=True)
        released, skipped = self.pool.drop_node(n)
        if skipped:
            print(f"node {n} lost; {skipped} parts only it could "
                  "read are skipped", flush=True)
        if n.startswith("worker"):
            # a declared-dead worker is a membership change: the
            # epoch bump (plus the assignment reset above, which
            # clears the parts' owner/epoch stamps) fences any
            # late completion the node sends if it comes back
            with self._lock:
                self._members.discard(n)
                self._retiring.discard(n)
            self._member_change("evict", n)
        with self._lock:
            if (self._collect is not None
                    and n not in self._collect["reported"]):
                # a dead worker will never report its local files;
                # count it as reported-empty so the round can end
                # (its data is unreachable, like the reference
                # losing a node's local disk)
                self._collect["reported"].add(n)
                print(f"node {n} lost before reporting local "
                      "files; its data is skipped", flush=True)


# ------------------------------------------------------------------ client
_CLIENT_NONCE = itertools.count()


class SchedulerClient:
    """Worker-side RPC stub.

    Mutating ops carry a per-sender sequence number; the scheduler
    caches the last reply per sender (journaled), so a retried op whose
    reply was lost — or that straddled a scheduler restart — returns
    the ORIGINAL reply instead of re-executing. That is what makes
    retrying safe here: without it, ops like barrier entry and part
    assignment would double-apply. `retry_deadline` (default: the
    launcher-exported WH_SCHED_RETRY_SEC; 0 = legacy fail-fast) bounds
    how long a lost connection/reply is retried under the unified
    retry budget."""

    def __init__(self, uri: str, node: str, timeout: float = 60.0,
                 connect_deadline: float = 30.0,
                 retry_deadline: Optional[float] = None):
        host, port = uri.rsplit(":", 1)
        self.addr = (host, int(port))
        self.node = node
        self.timeout = timeout
        self.connect_deadline = connect_deadline
        if retry_deadline is None:
            retry_deadline = float(
                os.environ.get("WH_SCHED_RETRY_SEC", "0") or 0.0)
        self.retry_deadline = retry_deadline
        # per-INSTANCE sender id: a client re-created in the same
        # process (an in-process respawn, e.g. a BSP rank rejoining)
        # is a new logical sender with a fresh seq space — it must not
        # be fenced by its dead predecessor's cached seq.
        self._sender = f"{node}:{os.getpid()}.{next(_CLIENT_NONCE)}"
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._inc: Optional[int] = None  # last incarnation seen
        self._fgen = 0  # last flight generation seen (fgen piggyback)

    def call(self, **req) -> dict:
        """One exactly-once RPC. Connection establishment always
        retries under `connect_deadline` (the launcher spawns workers
        concurrently with the scheduler, ADVICE r1). With a positive
        `retry_deadline`, a lost reply retries the SAME (sender, seq)
        — the scheduler's reply cache deduplicates it — so clients
        ride out a scheduler outage/restart instead of crashing."""
        req.setdefault("node", self.node)
        if req.get("op") in _MUTATING_OPS:
            # mint the seq ONCE so every retry of this op carries it
            with self._seq_lock:
                self._seq += 1
                req["sender"], req["seq"] = self._sender, self._seq
        budget = None
        while True:
            # (re)stamp the remaining ambient budget per ATTEMPT — a
            # retry after backoff has less budget left than the first
            # send did, and the scheduler sheds on what the frame says
            dl = _overload.wire_deadline()
            if dl is not None:
                req["dl"] = dl
            payload = json.dumps(req) + "\n"
            try:
                with connect_with_retry(self.addr, self.connect_deadline,
                                        self.timeout) as s:
                    f = s.makefile("rw")
                    f.write(payload)
                    f.flush()
                    line = f.readline()
                if not line:
                    raise ConnectionResetError("empty scheduler reply")
                break
            except (OSError, ConnectionError) as e:
                if self.retry_deadline <= 0:
                    raise  # legacy fail-fast (no retry window granted)
                if budget is None:
                    budget = _retry.RetryBudget(
                        self.retry_deadline,
                        op=f"sched.{req.get('op')}")
                if budget.expired:
                    budget.give_up(e)
                budget.sleep()
        if budget is not None:
            budget.succeeded()
        resp = json.loads(line)
        inc = resp.get("inc")
        if inc is not None:
            with self._seq_lock:
                prev, self._inc = self._inc, inc
            if prev is not None and inc != prev:
                print(f"[sched-client] {self.node}: scheduler restarted "
                      f"(incarnation {prev} -> {inc}); resumed from its "
                      "journal", flush=True)
        fgen = resp.get("fgen")
        if fgen is not None:
            # cluster flight trigger: the scheduler bumped the flight
            # generation — dump THIS node's rings too (multi-node black
            # box; a no-op when the local recorder is off)
            with self._seq_lock:
                fresh_gen = int(fgen) > self._fgen
                if fresh_gen:
                    self._fgen = int(fgen)
            if fresh_gen:
                _flight.dump(f"cluster: {resp.get('fwhy') or '?'}",
                             force=True)
        if "error" in resp:
            raise RuntimeError(f"scheduler error: {resp['error']}")
        return resp

    def register(self) -> dict:
        return self.call(op="register")

    def blob_put(self, key: str, arr) -> None:
        """Broadcast a small host payload (one array, or a dict of
        arrays) through the scheduler — the rabit::Broadcast host path
        for BSP init payloads like centroid seeds and quantile-sketch
        summaries."""
        import base64
        import io

        import numpy as np

        buf = io.BytesIO()
        if isinstance(arr, dict):
            np.savez(buf, **arr)
        else:
            np.save(buf, np.asarray(arr))
        self.call(op="blob_put", key=key,
                  data=base64.b64encode(buf.getvalue()).decode())

    def blob_get(self, key: str, timeout: float = 60.0, poll: float = 0.1):
        """Fetch a rendezvous payload, waiting for the publisher under
        the unified retry policy: jittered backoff growing from `poll`
        instead of a fixed-interval busy-poll (which spun the scheduler
        whenever a partition fault delayed the publisher), bounded by
        the caller's `timeout`."""
        import base64
        import io

        import numpy as np

        budget = _retry.RetryBudget(timeout, base_s=poll, op="blob_get")
        while True:
            r = self.call(op="blob_get", key=key)
            if r.get("ok"):
                budget.succeeded()
                got = np.load(io.BytesIO(base64.b64decode(r["data"])))
                if hasattr(got, "files"):  # npz: dict payload
                    return {k: got[k] for k in got.files}
                return got
            if budget.expired:
                budget.give_up(
                    TimeoutError(f"blob {key!r} never published"))
            budget.sleep()

    def report(self, progress: dict) -> None:
        self.call(op="report", progress=progress)

    def barrier(self, name: str, world: int, poll: float = 0.1,
                timeout: Optional[float] = None) -> None:
        """Block until `world` distinct nodes reach the named barrier
        (rabit tracker rendezvous parity for the BSP apps). With a
        timeout, raises TimeoutError instead of waiting forever for a
        peer that died before arriving."""
        deadline = (time.monotonic() + timeout) if timeout else None
        t_enter = time.monotonic()
        with _trace.span(f"barrier.{name}", cat="sched", world=world):
            try:
                r = self.call(op="barrier", name=name, world=world)
                if r["released"]:
                    return
                gen = r["gen"]
                while True:
                    time.sleep(poll)
                    if self.call(op="barrier_wait", name=name,
                                 gen=gen)["released"]:
                        return
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(
                            f"barrier {name!r} never released")
            finally:
                _BARRIER_WAIT_S.observe(time.monotonic() - t_enter)


class LivenessPinger:
    """Background liveness pings for workers whose main thread runs long
    device computations (global-mesh BSP loops): without them the
    scheduler's sweep would declare the worker dead mid-solve."""

    def __init__(self, client: SchedulerClient, interval: float = 2.0):
        import threading

        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(interval):
                try:
                    # piggyback this process's metrics snapshot on the
                    # liveness ping — the scheduler-aggregation channel
                    client.call(op="epoch",
                                metrics=_obs.REGISTRY.snapshot())
                except Exception:
                    pass

        self._t = threading.Thread(target=loop, daemon=True)
        self._t.start()

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=5)


class RemotePool:
    """WorkloadPool-shaped adapter over the scheduler RPC, so the same
    solver code runs single-process (local pool) or distributed (this).
    get() returns None only when the whole round is finished; while other
    workers still hold parts it blocks-and-polls (online mode semantics,
    data_parallel.h:54-72)."""

    def __init__(self, client: SchedulerClient, poll: float = 0.2):
        self.client = client
        self.poll = poll
        self.epoch = 0  # joins whatever round is live on first sync_round
        self.round: Optional[dict] = None
        # elastic membership state observed on replies: the membership
        # epoch (the worker's store absorbs bumps between parts) and
        # the retire flag (the scheduler asked this worker to drain,
        # flush, and leave)
        self.mepoch = 0
        self.retire = False
        self._part_mepoch: dict[int, int] = {}

    def _observe(self, r: dict) -> None:
        if "mepoch" in r:
            self.mepoch = r["mepoch"]
        if r.get("retire"):
            self.retire = True

    def sync_round(self, wait: bool = True) -> Optional[dict]:
        """Adopt the scheduler's next dispatch round (type/data_pass).
        Returns None on job shutdown (or once this worker is marked
        retiring — the caller leaves instead of joining a new round).
        Blocks until the epoch advances past the one this pool last
        worked."""
        while True:
            r = self.client.call(op="epoch")
            self._observe(r)
            if r.get("shutdown") or self.retire:
                return None
            if r.get("round") is not None and r["epoch"] > self.epoch:
                self.epoch = r["epoch"]
                self.round = r["round"]
                return self.round
            if not wait:
                return None
            time.sleep(self.poll)

    def get(self, node: str = "") -> Optional[tuple[int, File]]:
        while True:
            r = self.client.call(op="get", epoch=self.epoch)
            self._observe(r)
            if self.retire:
                # drain stops here; the part we were handed (if any)
                # was not: retire replies never carry part_ids
                return None
            if "part_id" in r:
                # remember the membership epoch the assignment was made
                # under; finish() echoes it so the scheduler can fence
                # completions that straddled a membership change
                self._part_mepoch[r["part_id"]] = r.get("mepoch", 0)
                f = File(**r["file"])
                return r["part_id"], f
            if "match" in r:
                # worker-local-data round: match the pattern against THIS
                # node's filesystem and report (data_parallel.h:96-100,
                # 143-150)
                try:
                    files = match_file(r["match"])
                except FileNotFoundError:
                    files = []
                self.client.call(op="add_local", files=files,
                                 epoch=self.epoch)
                continue
            if r.get("done"):
                return None
            if r.get("epoch", self.epoch) != self.epoch:
                # the scheduler has moved on to a newer round: this round
                # is over for us — fall back to sync_round (a worker
                # descheduled across the round change must not spin here
                # forever, ADVICE r1)
                return None
            time.sleep(self.poll)

    def finish(self, part_id: int, progress: Optional[dict] = None) -> None:
        self.client.call(op="finish", part_id=part_id, epoch=self.epoch,
                         mepoch=self._part_mepoch.pop(part_id, None),
                         progress=progress or {})

    def join(self) -> dict:
        """Announce this worker as an elastic joiner of a running job
        (bumps the membership epoch scheduler-side) and adopt the
        current state."""
        r = self.client.call(op="join")
        self._observe(r)
        return r

    def leave(self) -> None:
        """Resign from the job cleanly (retirement, or degradation out
        of a partition): the scheduler drops us from liveness NOW and
        re-queues anything we still held."""
        try:
            self.client.call(op="leave",
                             metrics=_obs.REGISTRY.snapshot())
        except Exception:
            pass  # leaving best-effort: liveness eviction is the backstop
