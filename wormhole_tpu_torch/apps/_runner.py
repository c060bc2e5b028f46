"""Shared app runner: conf parsing, role dispatch, and the solver.

The reference's `app.dmlc conf k=v` convention (arg_parser.h:36-45): an
optional conf file as the first argument, then `key=value` overrides.
One more key, `device=` (default `cuda`), picks the torch device; it is
taken off before the learner's config is built, so conf files stay the
same as the JAX package's.

The reference's minibatch apps are a scheduler/server/worker triple over
ps-lite (reference linear.cc:6-25 role dispatch; minibatch_solver.h:85-195
scheduler loop; :284-329 worker loop; servers async_sgd.h:200-226), and
`run_minibatch_app` dispatches on the role the launcher
(launcher/dmlc_tpu.py) exports in WH_ROLE, as the JAX package's runner
does:

- no role: one process drives the whole solver on one device, or, under
  `torch.distributed.run` (WORLD_SIZE, RANK and LOCAL_RANK in the
  environment), an app that runs on several ranks (linear, difacto, gbdt,
  kmeans, lbfgs_linear) is one rank: it joins the process group (NCCL on
  `cuda:LOCAL_RANK`, gloo with `device=cpu`) and builds its mesh over
  all the ranks;
- scheduler: the control plane (runtime/tracker.py) — per-pass workload
  rounds, merged progress rows, model load and save commands to the
  server group, the shutdown drain and the run report;
- server: a runtime.ps_server.ServerNode owning a bucket-range shard of
  every state table; workers push deltas and pull merged rows through
  it, so all workers train ONE model (async_sgd.h:240-288). A worker
  trains at most `max_delay` minibatches between syncs;
- serve: an online serving shard (serving/server.py run_serve_role);
- worker: a learner on its device (the card unless `device=cpu`) whose
  parts come from the scheduler's RemotePool and whose tables sync with
  the server group through a SyncedStore, every `max_delay` minibatches
  and at every part's end.

With global_mesh=1 (`maybe_run_global`, every app) the `-n` workers join
ONE process group instead
(parallel/multihost.py: NCCL when each has a card of its own, gloo when
they share one or run on the CPU) and train one model in lockstep on a
(num_workers x 1) mesh: each feeds minibatch / num_workers rows a step
from its stable slice of the file parts, a drained rank feeds empty
blocks, and a pass ends when a step's all-reduced example count is 0;
rank 0 alone prints and saves. The scheduler is liveness only, servers
idle.

The batch apps (gbdt, lbfgs_linear, lbfgs_fm) dispatch with bsp=1
through `maybe_run_bsp` instead: the scheduler is rendezvous and
liveness only, and each worker, a rank of a BspWorker ring
(runtime/allreduce.py), learns on its stable slice of the file parts and
sums its statistics with the other ranks' over the ring.

The scheduler, server and serve roles are host code (sockets, threads,
numpy): they dispatch before any learner is built, so they never open a
CUDA context. Several workers share one card, each in a context of its
own; the TCP plane needs no NCCL. With `-s 0` the workers train
independent replicas (a file-throughput mode; rank 0 saves its replica).
"""

from __future__ import annotations

import contextlib
import json
import os
import resource
import sys
import time

from wormhole_tpu_torch.config import knob_value, load_config
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.obs import report as _report
from wormhole_tpu_torch.obs import trace as _trace
from wormhole_tpu_torch.runtime.ps_server import (PSClient, ServerNode,
                                                  SyncedStore)
from wormhole_tpu_torch.runtime.tracker import (LivenessPinger, RemotePool,
                                                Scheduler, SchedulerClient,
                                                node_env)
from wormhole_tpu_torch.solver.progress import Progress
from wormhole_tpu_torch.solver.workload import WorkType
from wormhole_tpu_torch.utils import checkpoint as ckpt


def parse_cli(cls, argv, ranks: bool = False):
    """(config, device) from `[conf] key=value ...`. Raises under a
    `torch.distributed.run` launch of several ranks unless the app runs
    on several ranks (`ranks`; lbfgs_fm does not, as the JAX app has no
    mesh or global body); the PS launcher's roles set WH_ROLE and WH_RANK,
    not WORLD_SIZE, and pass."""
    if not ranks and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            f"{cls.__name__} runs in one process (or as a launcher role); "
            f"it takes no ranks of torch.distributed.run")
    conf = None
    rest = list(argv)
    if rest and "=" not in rest[0]:
        conf = rest.pop(0)
    device = "cuda"
    kept = []
    for tok in rest:
        if tok.split("=", 1)[0].strip().lstrip("-") == "device":
            device = tok.split("=", 1)[1].strip()
        else:
            kept.append(tok)
    return load_config(cls, conf_file=conf, argv=kept), device


def refuse_roles(app: str, remedy: str) -> None:
    """Raise under a launcher role that `app` has no part for in this
    launch (the BSP apps without bsp=1, k-means at all); `remedy` says
    how to run it instead."""
    role = os.environ.get("WH_ROLE")
    if role:
        raise NotImplementedError(
            f"the {app} app has no {role} role in this launch: {remedy}")


@contextlib.contextmanager
def ranks_of_launch(device):
    """This rank's device inside its process group, under a launch that
    set WORLD_SIZE: `cuda:LOCAL_RANK` with NCCL, or the CPU with gloo
    when `device` is the CPU. Without WORLD_SIZE, `device` as it is and
    no group."""
    if "WORLD_SIZE" not in os.environ:
        yield device
        return
    import torch
    import torch.distributed as dist

    from wormhole_tpu_torch.device import resolve_device

    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(
            torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", world_size=world,
                            rank=rank)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def run_minibatch_app(cfg, make_learner, device="cuda",
                      verbose: bool = True) -> dict:
    """Entry of the linear and DiFacto apps: the role the launcher set,
    or the whole solver on `device` in this process."""
    env = node_env()
    if env.role is None:
        from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

        return MinibatchSolver(make_learner(cfg, device), cfg,
                               verbose=verbose).run()
    if env.role.value == "serve":
        # online serving shard: independent of the train data plane
        from wormhole_tpu_torch.serving.server import run_serve_role

        return run_serve_role(cfg, env)
    if getattr(cfg, "global_mesh", False):
        # one process group over every worker (parallel/multihost.py)
        return maybe_run_global(
            cfg, lambda cfg, env, client, dev: _global_train(
                cfg, env, make_learner, dev, verbose, client), device)
    # every role checks the plane, so a launch that asks for one the
    # port lacks fails at once, not at the scheduler's liveness timeout
    _pick_plane(env)
    if env.role.value == "scheduler":
        return _run_scheduler(cfg, env, verbose)
    if env.role.value == "server":
        return _run_server(cfg, env)
    return _run_worker(cfg, env, make_learner, device, verbose)


def maybe_run_global(cfg, worker_body, device="cuda"):
    """Role dispatch of global_mesh=1 under the launcher: returns what
    the role returned when this process has a launcher role, else None
    (the caller runs its single-process path, as the JAX app does). Each
    worker joins the group inside multihost.worker_session and is called
    as worker_body(cfg, env, client, device); the scheduler runs liveness
    only and servers idle (no PS data plane: the collectives carry the
    model), both before any tensor exists."""
    if not getattr(cfg, "global_mesh", False):
        return None
    env = node_env()
    if env.role is None:
        return None
    if env.role.value == "scheduler":
        _run_scheduler_global(env)
        return 0
    if env.role.value == "server":
        print(f"[global server {env.rank}] cuda context: "
              f"{_cuda_context()}", flush=True)
        return 0
    return _run_worker_global(env, device, lambda client, dev: worker_body(
        cfg, env, client, dev))


def _run_worker_global(env, device, body):
    """A global-mesh worker: `body(client, device)` inside the worker
    session (register, pings, the group; torn down on every exit path),
    then at a clean exit one `[global-worker]` line: rank, device,
    backend, this process's kernel launches and its all_reduce calls and
    host-clock ms (parallel/collectives.py STATS)."""
    import torch.distributed as dist

    from wormhole_tpu_torch.parallel import collectives
    from wormhole_tpu_torch.parallel import multihost as mh

    with mh.worker_session(env, device) as (client, dev):
        backend = dist.get_backend()
        out = body(client, dev)
    kc = sys.modules.get("wormhole_tpu_torch.ops._cuda")
    print("[global-worker] " + json.dumps({
        "rank": env.rank, "device": str(dev), "backend": backend,
        "kernel_launches": ({k: v for k, v in kc.LAUNCHES.items() if v}
                            if kc is not None else {}),
        "allreduce_calls": collectives.STATS["allreduce_calls"],
        "allreduce_ms": round(collectives.STATS["allreduce_s"] * 1e3, 3)}),
        flush=True)
    return out


def _run_scheduler_global(env) -> dict:
    """Global-mesh scheduler: liveness only (the workers synchronise each
    other through their collectives), so the launcher stays informed and
    worker deaths are reported. Returns once all `-n` workers registered
    and left (a fast worker's bye must not end it while a peer has yet to
    register); raises when none registers within the start-up deadline
    (the group's rendezvous likely failed). Opens no CUDA context."""
    sched = Scheduler.from_env(env)
    sched.serve()
    startup_deadline = time.monotonic() + max(60.0, sched.node_timeout * 4)
    try:
        while True:
            time.sleep(0.2)
            if sched.workers_drained(env.num_workers):
                break
            # a respawned scheduler (journal replay) already saw workers
            # in a previous incarnation
            seen_any = sched.incarnation > 0 or sched.workers_ever_seen()
            if not seen_any and time.monotonic() > startup_deadline:
                raise RuntimeError(
                    "no worker registered within the startup deadline — "
                    "the process group's rendezvous likely failed")
        print(f"[scheduler] cuda context: {_cuda_context()}", flush=True)
        return {}
    finally:
        sched.stop()


def _global_train(cfg, env, make_learner, device, verbose, client) -> dict:
    """Lockstep training on the global mesh (the JAX package's
    _global_train): each rank feeds minibatch / num_workers rows a step
    from its stable slice of the file parts (`rank_parts`), a drained
    rank feeds `empty_rowblock()`, and a pass ends only when a step's
    all-reduced example count is 0, a decision the same on every rank.
    Every rank draws the same random stream (each learner's generators
    are seeded alike and drawn once a step). Rank 0 alone prints and
    writes model_out (a single file: the tables are whole on every rank);
    predict_out gets `{predict_out}_rank-R_part-J` files."""
    import torch.distributed as dist

    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.parallel import multihost as mh
    from wormhole_tpu_torch.parallel.mesh import make_mesh

    nproc, rank = env.num_workers, env.rank
    if cfg.minibatch % nproc:
        raise ValueError(f"minibatch {cfg.minibatch} must divide over "
                         f"{nproc} workers")
    local_rows = cfg.minibatch // nproc
    mesh = make_mesh(nproc, 1, device=device, backend=dist.get_backend())
    learner = make_learner(cfg, device, mesh=mesh)
    train_fn, eval_fn = learner.global_step_protocol()
    empty = mh.empty_rowblock()

    def run_pass(pattern, train: bool, seed: int):
        prog_tot: dict = {}
        steps, t0 = 0, time.perf_counter()

        def batches():
            for f, k in mh.rank_parts(pattern, cfg.num_parts_per_file, env):
                yield from MinibatchIter(
                    f, k, cfg.num_parts_per_file, cfg.data_format,
                    minibatch_size=local_rows,
                    shuf_buf=(cfg.rand_shuffle * local_rows if train else 0),
                    neg_sampling=(cfg.neg_sampling if train else 1.0),
                    seed=seed, device=learner.device)

        it = batches()
        while True:
            blk = next(it, None)
            blk = blk if blk is not None else empty
            prog = train_fn(blk) if train else eval_fn(blk)
            # nex is the global batch's (gathered over the ranks): zero
            # means every rank drained, the same decision on every rank
            if prog["nex"] == 0:
                break
            steps += 1
            for k, v in prog.items():
                prog_tot[k] = prog_tot.get(k, 0.0) + v
        wall = time.perf_counter() - t0
        prog_tot["steps"], prog_tot["wall_s"] = steps, wall
        return prog_tot

    def line(tag, p):
        n = max(p.get("nex", 0.0), 1.0)
        return (f"[global-mesh] {tag}: nex={int(p.get('nex', 0.0))} "
                f"logloss={p.get('logloss', 0.0) / n:.6f} steps="
                f"{p['steps']} ms_per_step="
                f"{p['wall_s'] * 1e3 / max(p['steps'], 1):.3f} examples_per_s="
                f"{p.get('nex', 0.0) / max(p['wall_s'], 1e-9):.1f}")

    result = {}
    if cfg.model_in:
        mh.load_replicated(_store(learner), ckpt.load_parts(
            cfg.model_in, cfg.load_iter if cfg.load_iter >= 0 else None))
    for dp in range(cfg.max_data_pass):
        result["train"] = tr = run_pass(cfg.train_data, True, dp)
        if rank == 0 and verbose:
            print(line(f"train pass {dp}", tr), flush=True)
        if cfg.val_data:
            result["val"] = vl = run_pass(cfg.val_data, False, dp)
            if rank == 0 and verbose:
                print(line(f"val pass {dp}", vl), flush=True)
    if "val" in result and rank == 0 and verbose:
        vl = result["val"]
        n = max(vl.get("nex", 0.0), 1.0)
        print(f"final val: logloss={vl.get('logloss', 0.0) / n:.6f} "
              f"auc={vl.get('auc', 0.0) / n:.6f} "
              f"acc={vl.get('acc', 0.0) / n:.6f}", flush=True)
    if cfg.model_out:
        # every rank takes part (the save's barriers); rank 0 writes
        ckpt.save_model(_store(learner), cfg.model_out)
        if rank == 0 and verbose:
            print(f"model saved: {cfg.model_out}", flush=True)
    if getattr(cfg, "predict_out", None):
        _global_predict(cfg, env, learner, empty, verbose)
    return result


def _global_predict(cfg, env, learner, empty, verbose) -> None:
    """Lockstep predict on the global mesh (PredictStream parity,
    iter_solver.h:140-156, and the reference's per-part output files):
    each rank streams its stable part slice through the collective
    forward, a drained rank feeding empty blocks until the global live-row
    count is 0, and writes the margins of its own rows to
    `{predict_out}_rank-R_part-J` (the PS mode's per-rank naming)."""
    import numpy as np

    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.parallel import multihost as mh

    rank = env.rank
    local_rows = cfg.minibatch // env.num_workers
    pred_fn = learner.global_predict_protocol()
    parts = mh.rank_parts(cfg.val_data or cfg.train_data,
                          cfg.num_parts_per_file, env)
    os.makedirs(os.path.dirname(cfg.predict_out) or ".", exist_ok=True)
    prob = bool(getattr(cfg, "prob_predict", False))

    def path(j):
        return f"{cfg.predict_out}_rank-{rank}_part-{j}"

    for j in range(len(parts)):  # zero-row parts still get their file
        open(path(j), "w").close()

    def blocks():
        for j, (f, k) in enumerate(parts):
            for blk in MinibatchIter(f, k, cfg.num_parts_per_file,
                                     cfg.data_format,
                                     minibatch_size=local_rows,
                                     device=learner.device):
                yield j, blk

    it = blocks()
    while True:
        got = next(it, None)
        blk = got[1] if got is not None else empty
        margins, nex = pred_fn(blk)
        if nex == 0:
            break  # every rank drained (a collective fact)
        if got is None or blk.size == 0:
            continue
        local = mh.fetch_local_rows(margins, rank * local_rows,
                                    rank * local_rows + blk.size)
        if prob:
            local = 1.0 / (1.0 + np.exp(-local))
        with open(path(got[0]), "a") as fh:
            for m in local:
                fh.write(f"{m:.6g}\n")
    if verbose and rank == 0:
        print(f"predict written: {cfg.predict_out}_rank-*", flush=True)


def maybe_run_bsp(cfg, worker_body, device="cuda"):
    """Role dispatch for the BSP-allreduce apps (bsp=1 under the
    launcher): returns an exit code when this process has a launcher
    role, else None (the caller runs its single-process path). Each
    worker gets a `BspWorker` (runtime/allreduce.py) registered with the
    scheduler and is called as worker_body(cfg, env, client, comm,
    device). The scheduler runs liveness and rendezvous and emits the
    run report at drain; servers have no part (`-s 0` is the natural
    launch). The scheduler and server roles return before any learner or
    tensor exists, so they open no CUDA context."""
    if not getattr(cfg, "bsp", False):
        return None
    env = node_env()
    if env.role is None:
        return None
    if env.role.value == "scheduler":
        _run_scheduler_bsp(env)
        return 0
    if env.role.value == "server":
        print(f"[bsp server {env.rank}] cuda context: {_cuda_context()}",
              flush=True)
        return 0
    from wormhole_tpu_torch.runtime.allreduce import BspWorker

    client = SchedulerClient(env.scheduler_uri, f"worker-{env.rank}")
    client.register()
    pinger = LivenessPinger(client)
    comm = BspWorker(env.rank, env.num_workers, client)
    try:
        rc = worker_body(cfg, env, client, comm, device)
    finally:
        pinger.stop()
        comm.close()
    # this incarnation's kernel launches (a respawn counts its own)
    kc = sys.modules.get("wormhole_tpu_torch.ops._cuda")
    print("[bsp-worker] " + json.dumps({
        "rank": env.rank, "device": str(device),
        "restore_epoch": int(os.environ.get("WH_RESTORE_EPOCH", "0") or 0),
        "kernel_launches": ({k: v for k, v in kc.LAUNCHES.items() if v}
                            if kc is not None else {})}), flush=True)
    try:
        # the final metrics snapshot rides the deregistration: bye ONLY
        # on a clean run, as _run_worker's; a crashed worker must be
        # evicted instead, which is what lets its respawn rejoin
        client.call(op="bye", metrics=_obs.REGISTRY.snapshot())
    except Exception:
        pass
    return rc


def _run_scheduler_bsp(env) -> None:
    """BSP-mode scheduler: liveness and rendezvous (register_bsp,
    bsp_peers, blobs); the collectives themselves run worker to worker.
    Exits once every worker registered and left, emitting the aggregated
    run report; bounded startup, so a mis-launched job fails loudly."""
    sched = Scheduler.from_env(env)
    sched.serve()
    if knob_value("WH_ELASTIC"):
        sched.start_membership_controller(env.num_workers)
    startup_deadline = time.monotonic() + max(60.0, sched.node_timeout * 4)
    try:
        # a respawned scheduler (journal replay) already saw workers in a
        # previous incarnation: the startup deadline must not fire while
        # the restored group rides out the restart on its retry budgets
        seen_any = sched.incarnation > 0
        while True:
            time.sleep(0.5)
            seen_any = seen_any or bool(sched.live_workers())
            if seen_any and sched.workers_drained(env.num_workers):
                break
            if not seen_any and time.monotonic() > startup_deadline:
                raise RuntimeError(
                    "no BSP worker registered within the startup deadline")
        _emit_run_report(sched, None, verbose=True)
        print(f"[scheduler] cuda context: {_cuda_context()}", flush=True)
    finally:
        sched.stop()


def _cuda_context() -> str:
    """Whether this process opened a CUDA context: the host roles print
    it as they exit (a context costs ~0.5 GB of the card and seconds)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "none (torch not imported)"
    return "open" if torch.cuda.is_initialized() else "none"


def _wait_server_group(sched: Scheduler, timeout: float = 60.0) -> PSClient:
    """Block until every `-s` server registered its URI; returns a client
    over the group (the scheduler's command channel for load/save)."""
    deadline = time.monotonic() + timeout
    while True:
        with sched._lock:
            if len(sched._server_uris) >= sched.num_servers:
                break
        if time.monotonic() >= deadline:
            raise RuntimeError(
                "ps servers did not all register within "
                f"{timeout:.0f}s ({len(sched._server_uris)}"
                f"/{sched.num_servers})")
        time.sleep(0.2)
    # under recovery (the launcher exports WH_PS_RETRY_SEC) the command
    # channel must survive a server respawn too: a dead server's save or
    # load lands on its reborn URI, which the scheduler holds through
    # re-registration
    retry = float(os.environ.get("WH_PS_RETRY_SEC", "0") or 0)
    return PSClient(_server_uris(sched), retry_deadline=retry,
                    resolver=(lambda: _server_uris(sched))
                    if retry > 0 else None)


_MODEL_LOADED_KEY = "__ps_model_loaded__"


def _run_scheduler(cfg, env, verbose: bool) -> dict:
    """Scheduler loop with the reference's iteration protocol
    (minibatch_solver.h:96-133): command the server group to LOAD
    model_in before any worker initializes (resuming pass numbering at
    load_iter+1), SAVE `_iter-K` checkpoints every save_iter passes, and
    save the final model at job end."""
    sched = Scheduler.from_env(env)
    sched.serve()
    if knob_value("WH_ELASTIC"):
        # elastic membership: scripted churn (WH_ELASTIC_PLAN) or
        # gauge-driven worker-count control; the launcher's elastic
        # supervisor turns the published target into spawned joiners,
        # the scheduler itself marks the shrink side retiring
        sched.start_membership_controller(env.num_workers)
    t0 = time.time()
    result = {}
    ps = None
    start_pass = 0
    try:
        if cfg.model_in and cfg.load_iter >= 0:
            # resume pass numbering in every mode (PS servers load below;
            # replica-mode workers load model_in themselves): the passes
            # already trained must not be dispatched again
            start_pass = cfg.load_iter + 1
        if env.num_servers > 0:
            ps = _wait_server_group(sched)
            if cfg.model_in:
                if sched.has_blob(_MODEL_LOADED_KEY):
                    # respawned scheduler: the journal says the load was
                    # commanded before the crash; the shards hold the
                    # (possibly further trained) model, and loading again
                    # would roll their state back
                    if verbose:
                        print("model load skipped (already loaded before "
                              "the scheduler restart)", flush=True)
                else:
                    it = cfg.load_iter if cfg.load_iter >= 0 else None
                    ps.load(cfg.model_in, it)
                    if verbose:
                        print(f"model loaded from {cfg.model_in}"
                              + (f" iter {cfg.load_iter}"
                                 if cfg.load_iter >= 0 else " (last)"),
                              flush=True)
                    # release the workers gated on the load (they must not
                    # create fresh tables while servers are still loading);
                    # journaled so a restart does not command it again
                    sched.publish_blob(_MODEL_LOADED_KEY, "1")
        # resume point from the replayed journal: a respawned scheduler
        # (incarnation > 0) rejoins the pass loop where the last journaled
        # round left it. An in-flight round is waited out (the restored
        # pool still tracks its unfinished parts); a finished one is
        # skipped.
        resume_wait = None   # "train" | "val": first pass rejoins mid-round
        skip_train = False   # TRAIN of the first pass already finished
        if sched.incarnation > 0 and sched._round is not None:
            rdp = int(sched._round.get("data_pass", 0))
            in_flight = not sched.pool.is_finished()
            if int(sched._round.get("type", 0)) == int(WorkType.TRAIN):
                start_pass = max(start_pass, rdp)
                if in_flight:
                    resume_wait = "train"
                else:
                    skip_train = True
            elif in_flight:    # VAL still running
                start_pass = max(start_pass, rdp)
                skip_train = True
                resume_wait = "val"
            else:              # VAL finished: the whole pass is done
                start_pass = max(start_pass, rdp + 1)
                result["val"] = sched.progress
            if verbose:
                print(f"resuming at pass {start_pass} from the scheduler "
                      f"journal (incarnation {sched.incarnation}"
                      + (f", waiting out the in-flight {resume_wait} round"
                         if resume_wait else "") + ")", flush=True)
        for dp in range(start_pass, cfg.max_data_pass):
            first = dp == start_pass
            if not (first and skip_train):
                if first and resume_wait == "train":
                    if verbose:
                        print(f"training pass {dp}: resumed mid-round",
                              flush=True)
                else:
                    n = sched.start_round(cfg.train_data,
                                          cfg.num_parts_per_file,
                                          cfg.data_format, WorkType.TRAIN,
                                          dp,
                                          local_data=getattr(
                                              cfg, "local_data", False),
                                          dispatch=getattr(cfg, "dispatch",
                                                           "online"))
                    if verbose:
                        print(f"training pass {dp}: {n} files", flush=True)
                result["train"] = sched.wait_round(cfg.print_sec, t0,
                                                   verbose)
            if cfg.val_data:
                if first and resume_wait == "val":
                    if verbose:
                        print(f"validation pass {dp}: resumed mid-round",
                              flush=True)
                else:
                    sched.start_round(cfg.val_data, cfg.num_parts_per_file,
                                      cfg.data_format, WorkType.VAL, dp)
                    if verbose:
                        print(f"validation pass {dp}", flush=True)
                result["val"] = sched.wait_round(cfg.print_sec, t0, verbose)
            if (ps is not None and cfg.model_out
                    and getattr(cfg, "save_iter", 0) > 0
                    and (dp + 1) % cfg.save_iter == 0
                    and dp + 1 < cfg.max_data_pass):
                # periodic `_iter-K` snapshot of the server shards: the
                # mid-job recovery point (minibatch_solver.h:124-127)
                paths = ps.save(cfg.model_out, it=dp)
                if verbose:
                    print(f"model saved for iter {dp}: {paths}",
                          flush=True)
        if "val" in result:
            # machine-readable final metrics line (the tutorial log's final
            # row, criteo_kaggle.rst:78)
            v = result["val"]
            print(f"final val: logloss={v.mean('logloss'):.6f} "
                  f"auc={v.mean('auc'):.6f} acc={v.mean('acc'):.6f}",
                  flush=True)
        # command the server group to save its shards, then release
        # everyone (IterScheduler::SaveModel -> kServerGroup parity)
        if ps is not None and cfg.model_out:
            paths = ps.save(cfg.model_out)
            if verbose:
                print(f"model saved: {paths}", flush=True)
        sched.announce_shutdown()
        # wait for the workers' tail work (final wire stats, per-rank
        # predict) before tearing down the planes they still need: each
        # worker deregisters with op=bye when done. Drained means all
        # `-n` workers registered and left; bounded so a worker that died
        # or never came up cannot hold the job open.
        drain_deadline = time.monotonic() + max(120.0,
                                                sched.node_timeout * 4)
        # a mis-launched job (a wrong -n) has no worker ever register:
        # give up after a startup-sized grace instead of the full drain
        none_deadline = time.monotonic() + max(120.0,
                                               sched.node_timeout * 4)
        while (not sched.workers_drained(env.num_workers)
               and time.monotonic() < drain_deadline):
            if (sched.workers_ever_seen() == 0
                    and time.monotonic() >= none_deadline):
                print("[scheduler] WARNING: no worker ever registered; "
                      "abandoning shutdown drain (mis-launched job? "
                      "check -n and the worker logs)", flush=True)
                break
            time.sleep(0.2)
        # end-of-run telemetry: per-server push/pull truth from the
        # still-alive servers, then the aggregated report, after the drain
        # so the workers' final snapshots (riding their `bye`) are in
        ps_stats = None
        if ps is not None:
            try:
                ps_stats = {r: ps.stats(r) for r in range(ps.world)}
            except Exception as e:
                print(f"[obs] ps stats unavailable at shutdown: {e}",
                      flush=True)
            ps.shutdown()
        _emit_run_report(sched, ps_stats, verbose)
        print(f"[scheduler] cuda context: {_cuda_context()}", flush=True)
        return result
    finally:
        sched.stop()


def _emit_run_report(sched: Scheduler, ps_stats, verbose: bool) -> None:
    """Build the end-of-run report from the scheduler's aggregated
    metrics, print the human summary plus the `[run-report]` machine
    line (the launcher scrapes it), and write run_report.json when
    WH_OBS_DIR is set. Telemetry must never fail the job."""
    try:
        agg = sched.aggregate_metrics()
        report = _report.build(agg["aggregate"], nodes=agg["nodes"],
                               ps_stats=ps_stats)
        if verbose:
            for line in _report.format_lines(report):
                print(line, flush=True)
        print(_report.machine_line(report), flush=True)
        if _report.enabled():
            path = _report.write(report)
            if verbose:
                print(f"[obs] run report written: {path}", flush=True)
    except Exception as e:
        print(f"[obs] run report failed: {e}", flush=True)


def _server_uris(sched: Scheduler) -> list[str]:
    with sched._lock:
        return [sched._server_uris[r] for r in sorted(sched._server_uris)]


def _run_server(cfg, env) -> dict:
    """One ps server process: bucket-range shard owner. When the
    launcher provides a snapshot dir (WH_SNAPSHOT_DIR), the node writes
    periodic shard snapshots there, and a respawned incarnation
    (WH_RESTORE_EPOCH > 0) restores from them before serving, then
    announces its NEW uri through the scheduler (register_server
    overwrites the rank's entry, and the workers' retry re-resolves)."""
    epoch = int(os.environ.get("WH_RESTORE_EPOCH", "0") or 0)
    node = ServerNode(env.rank, env.num_servers, epoch=epoch)
    snap_dir = os.environ.get("WH_SNAPSHOT_DIR", "")
    if snap_dir:
        snap_base = os.path.join(snap_dir, "srv")
        if epoch > 0:
            if not node.restore_snapshot(snap_base):
                print(f"[ps server {env.rank}] respawn epoch {epoch}: no "
                      "snapshot yet — restarting empty (pre-first-"
                      "snapshot state is not recoverable)", flush=True)
    node.serve()
    client = SchedulerClient(env.scheduler_uri, f"server-{env.rank}")
    client.call(op="register_server", rank=env.rank, uri=node.uri)
    if snap_dir:
        node.start_snapshots(os.path.join(snap_dir, "srv"),
                             float(getattr(cfg, "server_snapshot_sec", 5.0)
                                   or 5.0))
    try:
        while not node.wait_shutdown(2.0):
            # liveness ping, carrying this incarnation's metrics
            # snapshot for the scheduler's aggregation
            client.call(op="epoch", metrics=_obs.REGISTRY.snapshot())
    finally:
        node.stop()
    print(f"[ps server {env.rank}] cuda context: {_cuda_context()}",
          flush=True)
    return {}


def _run_worker(cfg, env, make_learner, device, verbose: bool) -> dict:
    learner = make_learner(cfg, device)
    client = SchedulerClient(env.scheduler_uri, f"worker-{env.rank}")
    client.register()
    # background liveness pings: a worker streaming a large part makes no
    # scheduler RPC for minutes; without pings the liveness sweep would
    # evict it and, with the all-workers-lost abort, kill a healthy job
    pinger = LivenessPinger(client)
    try:
        result = _run_worker_body(cfg, env, verbose, learner, client)
    finally:
        pinger.stop()
    # deregister only on clean completion, so the scheduler's shutdown
    # drain sees the tail work finished. A worker that crashes must
    # instead time out of the liveness table: that eviction is what
    # re-queues its in-flight parts.
    try:
        # the bye carries this worker's final metrics snapshot
        client.call(op="bye", metrics=_obs.REGISTRY.snapshot())
    except Exception:
        pass
    return result


def _run_worker_body(cfg, env, verbose, learner, client) -> dict:
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    pool = RemotePool(client)
    if knob_value("WH_ELASTIC_JOIN"):
        # elastic joiner (spawned mid-job by the launcher's supervisor):
        # announce the join so the scheduler bumps the membership epoch
        # and rebalances pinned parts over the grown set
        pool.join()
    if cfg.model_in and env.num_servers == 0:
        # replica mode only: with a server group the SCHEDULER commands
        # the servers to load; this worker gates on that load and pulls
        ckpt.load_model(_store(learner), cfg.model_in,
                        cfg.load_iter if cfg.load_iter >= 0 else None)
    synced = None
    if env.num_servers > 0:
        deadline = time.monotonic() + 60.0
        while not (s := client.call(op="servers"))["ready"]:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"only {s.get('num_known', 0)}/{s['num_servers']} ps "
                    "servers registered within 60s — a server process "
                    "likely died at startup")
            time.sleep(0.2)
        if cfg.model_in:
            # wait for the scheduler's load command to finish: an
            # init_spec racing ahead of it would create fresh tables and
            # the load would then refuse to clobber them
            load_deadline = time.monotonic() + 120.0
            while not client.call(op="blob_get",
                                  key=_MODEL_LOADED_KEY)["ok"]:
                if time.monotonic() >= load_deadline:
                    raise RuntimeError(
                        "scheduler never announced the model_in load")
                time.sleep(0.2)
        # server-death recovery (opt-in): with a retry budget the client
        # survives a dead server — it re-resolves the rank's new uri
        # through the scheduler, fences with `hello`, and replays its
        # push journal. Zero (the default) fails fast.
        retry_sec = float(os.environ.get("WH_PS_RETRY_SEC", "0") or 0)
        cfg_retry = float(getattr(cfg, "ps_retry_sec", 0.0) or 0.0)
        if cfg_retry > 0:
            retry_sec = cfg_retry

        def _resolve():
            try:
                got = client.call(op="servers")
                return got["uris"] if got.get("ready") else None
            except Exception:
                return None

        ps = PSClient(s["uris"], sender=f"worker-{env.rank}",
                      retry_deadline=retry_sec,
                      resolver=_resolve if retry_sec > 0 else None)
        learner.track_touched = hasattr(learner, "collect_touched")
        plane = _pick_plane(env)
        synced = SyncedStore(
            _store(learner), ps,
            max_delay=getattr(cfg, "max_delay", 16),
            fixed_bytes=getattr(cfg, "fixed_bytes", 0),
            derived=getattr(learner, "derived_tables", dict)(),
            touched_fn=getattr(learner, "collect_touched", None),
            compress=bool(getattr(cfg, "msg_compression", 0)))
        if env.rank == 0:
            print(f"[ps-plane] {plane} (workers={env.num_workers}, "
                  f"device={learner.device})", flush=True)
        synced.init()
    solver = MinibatchSolver(learner, cfg, verbose=False)
    if synced is not None:
        synced.perf = solver.perf
        solver.sync_flush = synced.flush
    result = {}
    last_train = None  # (nex, seconds) of the last train round (warm)
    last_round_wire = 0.0  # wire bytes/sync of that round alone
    while (rnd := pool.sync_round()) is not None:
        wtype = WorkType(rnd["type"])
        if synced is not None:
            # adopt the merged model at round start (val rounds then score
            # the shared model, not this worker's replica)
            synced.pull()
            if env.rank == 0 and hasattr(learner, "nnz"):
                # seed the scheduler's fresh round Progress with the
                # shared model's standing |w|_0 (one reporter: every
                # worker just pulled the same state)
                client.report({"new_w": float(learner.nnz())})
        t_rnd = time.perf_counter()
        if synced is not None and wtype == WorkType.TRAIN:
            rnd_b0 = synced.client.bytes_push + synced.client.bytes_pull
            rnd_s0 = synced.num_syncs
        prog = _drain_round(solver, learner, pool, wtype, rnd["data_pass"],
                            synced)
        if wtype == WorkType.TRAIN:
            last_train = (prog.value("nex"), time.perf_counter() - t_rnd)
            if synced is not None:
                # the last TRAIN round's wire volume in isolation: from
                # epoch 2 on the key cache ships digest-only frames, which
                # a whole-run average would hide behind epoch 1
                db = (synced.client.bytes_push + synced.client.bytes_pull
                      - rnd_b0)
                ds = max(synced.num_syncs - rnd_s0, 1)
                last_round_wire = db / ds
        result["train" if wtype == WorkType.TRAIN else "val"] = prog
    if synced is not None:
        synced.close()  # drain + stop the async comms thread
    if pool.retire:
        # retired by the membership controller: every contribution is
        # merged (each train part ends in a flush), so resign cleanly
        print(f"[worker-{env.rank}] retiring (membership controller)",
              flush=True)
        pool.leave()
        return result
    if synced is not None and last_train is not None:
        # machine-readable wire accounting: wire bytes a sync, the
        # perf split, the key cache, and this process's footprint
        stats = dict(synced.wire_stats(), rank=env.rank,
                     last_round_nex=last_train[0],
                     last_round_sec=round(last_train[1], 3),
                     last_round_bytes_per_sync=round(last_round_wire, 1),
                     device=str(learner.device),
                     peak_rss_mb=round(resource.getrusage(
                         resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1))
        snap = _obs.REGISTRY.snapshot()["counters"]
        stats["d2h_copies"] = snap.get("kvstore.d2h_copies", 0)
        stats["h2d_copies"] = snap.get("kvstore.h2d_copies", 0)
        kc = sys.modules.get("wormhole_tpu_torch.ops._cuda")
        if kc is not None:  # the card's kernels this worker launched
            stats["kernel_launches"] = {k: v for k, v in kc.LAUNCHES.items()
                                        if v}
        sums, cnts = synced.perf.snapshot()
        stats["perf_sec"] = {k: round(v, 3) for k, v in sums.items()}
        stats["perf_cnt"] = cnts
        print(f"[ps-wire] {json.dumps(stats)}", flush=True)
    if synced is None:
        if cfg.model_out and env.rank == 0:
            # replica mode: single writer (rank 0) saves its full model
            ckpt.save_model(_store(learner), cfg.model_out)
    if getattr(cfg, "predict_out", None):
        # the last round-end sync already pulled the merged model; the
        # servers may have shut down by now, so predict on that state
        solver.predict(cfg.val_data or cfg.train_data,
                       f"{cfg.predict_out}_rank-{env.rank}")
    return result


def _pick_plane(env) -> str:
    """Resolve WH_PS_PLANE. The port has the TCP plane only: `auto`
    resolves to it, and `hot` (the model resident on the worker's
    devices, the servers a flush-barrier cold tier) raises until its
    slice."""
    plane = (os.environ.get("WH_PS_PLANE") or "auto").lower()
    if plane not in ("auto", "tcp", "hot"):
        raise ValueError(
            f"WH_PS_PLANE={plane!r}: expected auto, tcp, or hot")
    if plane == "hot":
        raise NotImplementedError(
            "WH_PS_PLANE=hot (the hot plane, parallel/hot_plane.py) is "
            "not ported: ROADMAP.md Queue A item 5.5; use tcp or auto")
    return "tcp"


def _store(learner):
    return getattr(learner, "ckpt_store", None) or learner.store


def _drain_round(solver, learner, pool: RemotePool, wtype, data_pass,
                 synced=None):
    """Worker side of one dispatch round: pull parts until the round is
    globally done, stream minibatches through the learner, report summed
    progress per part (the finish RPC carries it). Training state syncs
    against the server group every max_delay minibatches and always
    before a part's finish RPC, so when the scheduler sees the round
    finished, every contribution is already merged on the servers.
    Batches are parsed on the learner's device; the wait for the next
    one and the step land in the solver's perf as `wait` and
    `{train,eval}_step`."""
    from wormhole_tpu_torch.data.minibatch import MinibatchIter

    cfg = solver.cfg
    perf = solver.perf
    prog = Progress()
    train = wtype == WorkType.TRAIN
    step = learner.train_batch if train else learner.eval_batch
    mode = "train" if train else "eval"
    absorb = getattr(synced, "absorb_membership", None)
    while (got := pool.get()) is not None:
        part_id, f = got
        part_prog: dict = {}
        with _trace.span("solver.part", cat="solver", part=part_id,
                         data_pass=data_pass):
            it = iter(MinibatchIter(
                f.filename, f.part, f.num_parts, f.format,
                minibatch_size=cfg.minibatch,
                shuf_buf=(cfg.rand_shuffle * cfg.minibatch if train else 0),
                neg_sampling=(cfg.neg_sampling if train else 1.0),
                seed=data_pass * 7919 + part_id, device=learner.device))
            while True:
                t0 = time.perf_counter()
                blk = next(it, None)
                perf.add("wait", time.perf_counter() - t0)
                if blk is None:
                    break
                t0 = time.perf_counter()
                with _trace.span(f"solver.{mode}_step", cat="solver"):
                    p = step(blk)
                perf.add(f"{mode}_step", time.perf_counter() - t0)
                for k, v in p.items():
                    part_prog[k] = part_prog.get(k, 0.0) + float(v)
                if train and synced is not None:
                    synced.maybe_sync()
            if train and synced is not None:
                # barrier, not plain sync: with async sync on there may
                # be a round-trip still in flight, and the finish RPC's
                # contract is "every contribution already merged"
                synced.flush()
        prog.merge(part_prog)
        pool.finish(part_id, part_prog)
        if absorb is not None and pool.mepoch:
            # membership epoch bump observed on the control plane (a
            # peer joined, left or was evicted): fence and re-handshake
            # the PS plane at the part boundary (a no-op on seen epochs)
            absorb(pool.mepoch)
    return prog


def app_main(cls, make_learner, argv=None, ranks: bool = False) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_cli(cls, argv, ranks)
    with ranks_of_launch(device) as device:
        run_minibatch_app(cfg, make_learner, device)
    return 0
