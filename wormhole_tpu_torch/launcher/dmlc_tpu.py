"""dmlc_tpu: launch a distributed wormhole-tpu job.

The port's copy of the JAX package's launcher/dmlc_tpu.py, renamed to this
package and sharing nothing with it.

Parity with the reference trackers (dmlc-core tracker/dmlc_local.py,
dmlc_ssh-style multi-host, dmlc_mpi.py, dmlc_yarn.py — reference
doc/common/build.rst:53-123): spawn 1 scheduler + N worker processes of
the same program, wiring the role / rank / rendezvous env vars the
program reads via `runtime.node_env()`.

Mapping the reference's launch dimensions onto the port:
- `-n` workers = worker processes, each training on its device (the
  card, `cuda:0`, unless the app is given `device=cpu`; several workers
  on one host share it, a CUDA context each) — N local processes is
  also how the reference tests multi-node on localhost
  (data_parallel_test.cc:8).
- `-s` servers = parameter-server processes (runtime/ps_server.py): each
  owns a bucket-range shard of every state table; workers push deltas /
  pull merged state through them with bounded staleness, so all workers
  train ONE model (async_sgd.h:240-288 parity). Servers and the
  scheduler are host code and open no CUDA context.
- several hosts: `--hosts a,b,c` runs the scheduler locally and spawns
  the role processes across the hosts round-robin through `--ssh-cmd`
  (plain ssh by default). This came with the copy and is untested here.
  `--coord-port` / WH_COORD_URI feed only the global mesh
  (global_mesh=1): the workers' process group meets there
  (parallel/multihost.py).

Usage:
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 4 -s 2 -- \
      python -m wormhole_tpu_torch.apps.linear learn/linear/demo.conf
  python -m wormhole_tpu_torch.launcher.dmlc_tpu -n 2 -s 1 -- \
      python -m wormhole_tpu_torch.apps.linear conf device=cuda
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _default_host_ip() -> str | None:
    """A launch-host address remote role processes can dial back to (the
    dmlc ssh tracker's socket.getsockname trick: no traffic is sent; the
    OS just picks the outbound interface). Probes a routable target
    first (as the dmlc tracker does); returns None when no interface
    can be determined so the caller can fail loudly instead of handing
    remote roles an undialable 127.0.0.1."""
    for probe in ("8.8.8.8", "10.255.255.255"):
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect((probe, 1))
                ip = s.getsockname()[0]
            if not ip.startswith("127."):
                return ip
        except OSError:
            continue
    return None


def _stream(prefix: str, pipe, out, on_line=None):
    for line in iter(pipe.readline, b""):
        out.write(f"[{prefix}] ".encode() + line)
        out.flush()
        if on_line is not None:
            try:
                on_line(line)
            except Exception:
                pass  # a watcher bug must never break output streaming


def launch(num_workers: int, num_servers: int, cmd: list[str],
           node_timeout: float = 30.0,
           env_extra: dict | None = None,
           hosts: list[str] | None = None,
           ssh_cmd: str = "ssh",
           remote_cwd: str | None = None,
           scheduler_host: str | None = None,
           coord_port: int = 0,
           max_server_restarts: int = 0,
           max_worker_restarts: int = 0,
           max_scheduler_restarts: int = 0,
           num_serve: int = 0,
           max_serve_restarts: int = 0,
           snapshot_dir: str | None = None,
           elastic: bool = False,
           pass_env: tuple[str, ...] = ("CUDA_VISIBLE_DEVICES",
                                        "PYTHONPATH", "WH_PS_PLANE",
                                        "WH_NET_COMPRESS",
                                        "WH_WIRE", "WH_WIRE_EF",
                                        "WH_WIRE_COMP", "WH_SERVE_WIRE",
                                        "WH_TRACE_SAMPLE",
                                        "WH_OBS_SCRAPE_SEC",
                                        "WH_OBS_SCRAPE_PORT",
                                        "WH_ELASTIC_SEC", "WH_ELASTIC_MIN",
                                        "WH_ELASTIC_MAX",
                                        "WH_ELASTIC_PLAN",
                                        "WH_RETRY_BASE_SEC",
                                        "WH_RETRY_CAP_SEC",
                                        "WH_PROF", "WH_PROF_HZ",
                                        "WH_PROF_BUDGET_PCT",
                                        "WH_FLIGHT", "WH_FLIGHT_RING",
                                        "WH_FLIGHT_DECISIONS",
                                        "WH_FLIGHT_SNAPS",
                                        "WH_FLIGHT_DIR",
                                        "WH_FLIGHT_MIN_SEC",
                                        "WH_SAN", "WH_SAN_SAMPLE",
                                        "WH_SAN_DUMP_DIR")) -> int:
    """Spawn the scheduler + N workers of `cmd`; stream their output with
    role prefixes; return the first nonzero exit code (0 if all clean).
    On scheduler exit, surviving workers are terminated (the reference
    tracker's process-group teardown).

    With `hosts`, the scheduler runs locally and the server/worker
    processes are spawned round-robin across the hosts via `ssh_cmd`
    (the dmlc ssh-tracker model): each remote invocation is
    `<ssh_cmd> <host> 'cd <remote_cwd> && env <contract> <cmd>'` — the
    same WH_* env contract either way, with the scheduler URI bound on a
    launch-host address the remote nodes can dial. The global mesh's
    coordinator address (WH_COORD_URI, where the workers' process group
    meets) names hosts[0] (worker 0's host) at `coord_port`.

    With `max_server_restarts > 0` the launcher becomes the ps plane's
    supervisor (the ps-lite node-manager role): a server process that
    dies mid-job is respawned — up to the cap, per rank — with
    WH_RESTORE_EPOCH bumped so it restores its latest shard snapshot
    from `snapshot_dir` (auto-allocated when not given) and re-announces
    its new URI; workers ride the death out through PSClient's fenced
    retry (WH_PS_RETRY_SEC, exported automatically). Snapshot respawn is
    local-launch only for now (a remote host's respawn would need the
    ssh round-trip plumbed through the stream threads).

    `max_worker_restarts > 0` extends the same supervision to WORKER
    processes, for the BSP allreduce apps (runtime/allreduce.py): a
    respawned worker re-registers with the tracker (bumping the group
    generation), loads its version-stamped checkpoint from
    `snapshot_dir`, and replays its missed collectives from peers'
    result caches. Unlike supervised servers, a worker's FINAL exit
    code always folds into the job's: workers define job success.

    `num_serve > 0` adds a group of online serving shards
    (serving/server.py): each loads its range of the newest snapshot
    set under WH_SNAPSHOT_DIR (or WH_SERVE_SNAPSHOT), registers its
    predict endpoint with the scheduler, and hot-swaps as training
    writes newer versions. Serving is infrastructure, not workload:
    shard exit codes never fold into the job's (the launcher kills
    leftovers at teardown), and `max_serve_restarts > 0` respawns a
    shard that dies mid-job — routers chase the new uri through the
    scheduler's serve_nodes op.

    `max_scheduler_restarts > 0` closes the last single point of
    failure: the scheduler journals every state-mutating control-plane
    op under the snapshot dir (WH_SCHED_JOURNAL, on by default), and a
    scheduler that CRASHES mid-job is respawned on the SAME pinned URI
    with a bumped incarnation — it replays the journal and resumes the
    job where it died, while workers ride the outage out under
    WH_SCHED_RETRY_SEC (exported automatically). Only a clean
    `announce_shutdown` exit (code 0) tears the job down; crash vs
    shutdown is distinguished by exit code, fixing the old blanket
    kill-everything-on-scheduler-exit behavior.

    `elastic=True` makes the WORKER SET itself dynamic: WH_ELASTIC=1 is
    exported so the scheduler runs its membership controller
    (WH_ELASTIC_PLAN scripted churn, or gauge-driven sizing), and the
    launcher runs an elastic supervisor thread that polls the
    scheduler's `elastic` op — when the target exceeds the live count
    it spawns fresh worker ranks (WH_ELASTIC_JOIN=1, so they `join` the
    running job mid-pass); shrinking is the scheduler's half (it marks
    workers retiring; they drain, flush, `leave`, and exit 0).
    Local-launch only, like snapshot respawn."""
    multi = bool(hosts)
    recovery = max_server_restarts > 0 and num_servers > 0
    recovery_w = max_worker_restarts > 0 and num_workers > 0
    recovery_s = max_scheduler_restarts > 0
    if (recovery or recovery_w or recovery_s
            or num_serve > 0) and snapshot_dir is None:
        import tempfile

        snapshot_dir = tempfile.mkdtemp(prefix="wh_ps_snap_")
    if multi:
        sched_host = scheduler_host or _default_host_ip()
        if not sched_host:
            raise RuntimeError(
                "--hosts mode: could not auto-detect a launch-host IP the "
                "remote roles can dial back to (every interface probe "
                "failed or resolved to loopback); pass --scheduler-host "
                "explicitly")
    else:
        sched_host = "127.0.0.1"
    # WH_SCHED_PORT pins the scheduler's RPC port so an outside process
    # can dial the job without scraping logs; 0/unset keeps the
    # ephemeral default
    sched_port = int(os.environ.get("WH_SCHED_PORT", "0") or 0)
    uri = f"{sched_host}:{sched_port or _free_port()}"
    # one run id for the whole job so every node's trace spans and the
    # final report carry the same tag (obs/trace.py reads WH_RUN_ID)
    run_id = os.environ.get("WH_RUN_ID") or f"wh-{int(time.time())}-{os.getpid()}"
    obs_dir = os.environ.get("WH_OBS_DIR")
    # the global mesh's rendezvous address: worker 0's process-group
    # store binds it (parallel/multihost.py init_from_env). With
    # hosts, worker 0 lives on hosts[0]; coord_port must be free THERE,
    # so it is explicit (the launcher can only probe local ports).
    if multi:
        coord_uri = f"{hosts[0]}:{coord_port or 29477}"
    else:
        coord_uri = f"127.0.0.1:{_free_port()}"

    def contract(role: str, rank: int) -> dict:
        env = dict(
            WH_ROLE=role,
            WH_RANK=str(rank),
            WH_NUM_WORKERS=str(num_workers),
            WH_NUM_SERVERS=str(num_servers),
            WH_NUM_SERVE=str(num_serve),
            WH_SCHEDULER_URI=uri,
            WH_COORD_URI=coord_uri,
            WH_NODE_TIMEOUT=str(node_timeout),
            WH_RUN_ID=run_id,
        )
        if obs_dir:
            # remote spawns don't inherit the launch-host environment;
            # exporting it in the contract keeps telemetry on for them
            # too (each node appends to its host-local WH_OBS_DIR)
            env["WH_OBS_DIR"] = obs_dir
        if snapshot_dir:
            env["WH_SNAPSHOT_DIR"] = snapshot_dir
        if elastic:
            env["WH_ELASTIC"] = "1"
        if recovery and not os.environ.get("WH_PS_RETRY_SEC"):
            # worker-side retry budget: generous enough to span a server
            # death + respawn + snapshot restore + re-registration; an
            # exported WH_PS_RETRY_SEC (or env_extra below) overrides
            env["WH_PS_RETRY_SEC"] = str(max(120.0, node_timeout * 4))
        if recovery_w and not os.environ.get("WH_BSP_RETRY_SEC"):
            # survivor-side stall budget for a blocked BSP collective:
            # must span a worker death + respawn + checkpoint load
            env["WH_BSP_RETRY_SEC"] = str(max(120.0, node_timeout * 4))
        if recovery_s and not os.environ.get("WH_SCHED_RETRY_SEC"):
            # client-side scheduler-RPC retry window: must span a
            # scheduler death + respawn + journal replay; the reply
            # cache keeps the retries exactly-once
            env["WH_SCHED_RETRY_SEC"] = str(max(120.0, node_timeout * 4))
        if env_extra:
            env.update({k: str(v) for k, v in env_extra.items()})
        return env

    def spawn(role: str, rank: int,
              extra: dict | None = None) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(contract(role, rank))
        if extra:
            env.update(extra)
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    def spawn_remote(role: str, rank: int,
                     extra: dict | None = None) -> subprocess.Popen:
        # workers spread over hosts by rank; servers, then serving
        # shards, continue the round-robin after them so a host gets at
        # most ceil((n+s+serve)/len(hosts)) processes
        if role == "worker":
            slot = rank
        elif role == "server":
            slot = num_workers + rank
        else:  # serve
            slot = num_workers + num_servers + rank
        host = hosts[slot % len(hosts)]
        kv = dict(contract(role, rank))
        if extra:
            kv.update(extra)
        for k in pass_env:
            if k in os.environ and k not in kv:
                kv[k] = os.environ[k]
        line = "cd " + shlex.quote(remote_cwd or os.getcwd())
        line += " && env " + " ".join(
            shlex.quote(f"{k}={v}") for k, v in kv.items())
        line += " " + " ".join(shlex.quote(c) for c in cmd)
        argv = shlex.split(ssh_cmd) + [host, line]
        return subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    role_spawn = spawn_remote if multi else spawn
    sched = spawn("scheduler", 0)  # the tracker node always runs locally
    server_procs = {r: role_spawn("server", r) for r in range(num_servers)}
    worker_procs = {r: role_spawn("worker", r) for r in range(num_workers)}
    serve_procs = {r: role_spawn("serve", r) for r in range(num_serve)}
    procs = {"scheduler": sched}
    procs.update({f"server-{r}": p for r, p in server_procs.items()})
    procs.update({f"worker-{r}": p for r, p in worker_procs.items()})
    procs.update({f"serve-{r}": p for r, p in serve_procs.items()})
    threads = []

    def scrape_report(line: bytes) -> None:
        """Scheduler stdout watcher: the scheduler prints the aggregated
        run report as a machine line (`[run-report] {json}`); persist it
        when the scheduler process couldn't (e.g. its WH_OBS_DIR is on
        another filesystem view). Written only when the file is absent —
        the scheduler's own write wins when both see the same dir."""
        marker = b"[run-report] "
        if not obs_dir or not line.startswith(marker):
            return
        path = os.path.join(obs_dir, "run_report.json")
        if os.path.exists(path):
            return
        report = json.loads(line[len(marker):].decode())
        os.makedirs(obs_dir, exist_ok=True)
        tmp = f"{path}.launcher.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)

    def watch_output(name: str, p: subprocess.Popen,
                     on_line=None) -> None:
        t = threading.Thread(target=_stream,
                             args=(name, p.stdout, sys.stdout.buffer,
                                   on_line),
                             daemon=True)
        t.start()
        threads.append(t)

    for name, p in procs.items():
        watch_output(name, p,
                     on_line=scrape_report if name == "scheduler" else None)

    stop_respawn = threading.Event()

    def respawn_loop(role: str, label: str, r: int, table: dict,
                     cap: int) -> None:
        """Supervise one role process: a nonzero/signal exit mid-job gets
        the process respawned with a bumped WH_RESTORE_EPOCH (snapshot /
        BSP-checkpoint restore), up to the cap."""
        restarts = 0
        while True:
            p = table[r]
            code = p.wait()
            if stop_respawn.is_set() or code == 0:
                return
            if restarts >= cap:
                print(f"[dmlc_tpu] ERROR: {label}-{r} died again "
                      f"(exit {code}) and max_{role}_restarts="
                      f"{cap} is exhausted; not "
                      "respawning — the job will fail", flush=True)
                return
            restarts += 1
            print(f"[dmlc_tpu] {label}-{r} died (exit {code}); "
                  f"respawning with restore epoch {restarts} "
                  f"({restarts}/{cap})", flush=True)
            np_ = role_spawn(role, r,
                             {"WH_RESTORE_EPOCH": str(restarts)})
            table[r] = np_
            procs[f"{role}-{r}"] = np_
            watch_output(f"{role}-{r}", np_)

    monitors = []
    if recovery:
        for r in range(num_servers):
            m = threading.Thread(target=respawn_loop,
                                 args=("server", "ps server", r,
                                       server_procs, max_server_restarts),
                                 daemon=True)
            m.start()
            monitors.append(m)
    if recovery_w:
        for r in range(num_workers):
            m = threading.Thread(target=respawn_loop,
                                 args=("worker", "worker", r,
                                       worker_procs, max_worker_restarts),
                                 daemon=True)
            m.start()
            monitors.append(m)
    if max_serve_restarts > 0 and num_serve > 0:
        for r in range(num_serve):
            m = threading.Thread(target=respawn_loop,
                                 args=("serve", "serve shard", r,
                                       serve_procs, max_serve_restarts),
                                 daemon=True)
            m.start()
            monitors.append(m)

    if elastic and not multi:
        # elastic supervisor: the GROW half of the membership loop. The
        # scheduler decides the target (and handles shrink itself via
        # retire flags); this thread only turns target > live into
        # fresh worker processes. Joiners get rank numbers past the
        # launch set — rank is an identity, not an index.
        from wormhole_tpu_torch.obs import metrics as _wh_obs
        from wormhole_tpu_torch.runtime.tracker import SchedulerClient

        _SPAWNS = _wh_obs.REGISTRY.counter("elastic.spawns")
        _RETIRES = _wh_obs.REGISTRY.counter("elastic.retires")
        next_rank = [num_workers]
        seen_retiring: set = set()

        def elastic_loop() -> None:
            cli = SchedulerClient(uri, node="launcher",
                                  connect_deadline=node_timeout)
            poll = max(
                float(os.environ.get("WH_ELASTIC_SEC", "5") or 5) / 2.0,
                0.5)
            while not stop_respawn.wait(poll):
                try:
                    r = cli.call(op="elastic")
                except (OSError, ConnectionError, RuntimeError):
                    continue  # scheduler busy/gone; next tick decides
                for n in r.get("retiring", []):
                    if n not in seen_retiring:
                        seen_retiring.add(n)
                        _RETIRES.inc()
                target = r.get("target")
                if target is None or r.get("shutdown"):
                    # once shutdown is announced, workers draining out
                    # make alive < target look like a deficit; spawning
                    # into a dying job strands the joiner against a
                    # scheduler that exits before it can register
                    continue
                alive = sum(1 for p in worker_procs.values()
                            if p.poll() is None)
                while alive < int(target):
                    rank = next_rank[0]
                    next_rank[0] += 1
                    print(f"[dmlc_tpu] elastic: spawning worker-{rank} "
                          f"(target {target}, {alive} alive)", flush=True)
                    p = spawn("worker", rank, {"WH_ELASTIC_JOIN": "1"})
                    worker_procs[rank] = p
                    procs[f"worker-{rank}"] = p
                    watch_output(f"worker-{rank}", p)
                    _SPAWNS.inc()
                    alive += 1

        m = threading.Thread(target=elastic_loop, daemon=True)
        m.start()
        monitors.append(m)
    try:
        # scheduler supervision: a CLEAN exit (code 0, after
        # announce_shutdown) tears the job down; a crash respawns the
        # scheduler on the same pinned URI — it replays its journal and
        # resumes — while workers ride their WH_SCHED_RETRY_SEC budgets.
        # Without supervision every scheduler exit tears down (legacy).
        sched_restarts = 0
        while True:
            rc = sched.wait()
            if rc == 0 or not recovery_s or stop_respawn.is_set():
                break
            if sched_restarts >= max_scheduler_restarts:
                print(f"[dmlc_tpu] ERROR: scheduler died again "
                      f"(exit {rc}) and max_scheduler_restarts="
                      f"{max_scheduler_restarts} is exhausted; not "
                      "respawning — the job will fail", flush=True)
                break
            sched_restarts += 1
            print(f"[dmlc_tpu] scheduler died (exit {rc}); respawning "
                  f"on {uri} with journal replay "
                  f"({sched_restarts}/{max_scheduler_restarts})",
                  flush=True)
            sched = spawn("scheduler", 0,
                          {"WH_RESTORE_EPOCH": str(sched_restarts)})
            procs["scheduler"] = sched
            watch_output("scheduler", sched, on_line=scrape_report)
        stop_respawn.set()  # teardown begins: server exits are expected
        # give workers a grace period to drain, then terminate leftovers.
        # A signal death is a NEGATIVE returncode — fold it to a
        # nonzero exit instead of letting max() hide it behind a clean
        # scheduler (a worker SIGTERM'd mid-predict must fail the job).
        def fold(code: int) -> None:
            nonlocal rc
            if code != 0 and rc == 0:
                rc = code if code > 0 else 1
        # snapshot CURRENT incarnations (a supervised worker killed
        # mid-job was replaced in worker_procs by its respawn; the dead
        # incarnation's 137 is recovery working, not job failure — but
        # the final incarnation's code always counts)
        for p in (list(worker_procs.values()) + list(server_procs.values())
                  + list(serve_procs.values())):
            try:
                code = p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGTERM)
                try:
                    code = p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    code = 1
            if p in serve_procs.values():
                # serving shards are infrastructure with no natural end:
                # they exit when the scheduler goes away (or get killed
                # here); their codes never define job success
                continue
            if recovery and p in server_procs.values():
                # with supervision on, a server's exit code is not the
                # job's: an injected/real kill that recovery absorbed
                # must not fail a run whose workers finished clean
                # (failures surface through workers or the scheduler)
                continue
            fold(code)
        return rc
    finally:
        stop_respawn.set()
        for p in list(procs.values()):
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join(timeout=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dmlc_tpu",
        description="local multi-process launcher (dmlc_local.py parity)")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=1,
                    help="parameter-server processes (0 = replica mode)")
    ap.add_argument("--node-timeout", type=float, default=30.0)
    ap.add_argument("--max-server-restarts", type=int, default=0,
                    help="respawn a dead ps server up to N times per "
                         "rank, restoring its latest shard snapshot "
                         "(0 = no recovery: a server death fails the "
                         "job fast with resume guidance)")
    ap.add_argument("--max-worker-restarts", type=int, default=0,
                    help="respawn a dead worker up to N times per rank "
                         "(BSP allreduce apps recover it from its "
                         "version checkpoint; 0 = a worker death fails "
                         "the job)")
    ap.add_argument("--max-scheduler-restarts", type=int, default=0,
                    help="respawn a crashed scheduler up to N times on "
                         "the same pinned URI; it replays its "
                         "control-plane journal (WH_SCHED_JOURNAL under "
                         "the snapshot dir) and resumes the job while "
                         "clients retry under WH_SCHED_RETRY_SEC "
                         "(0 = legacy: any scheduler exit ends the job)")
    ap.add_argument("--serve", type=int, default=0, dest="num_serve",
                    help="online serving shards to run alongside the "
                         "job (serving/server.py): each serves its "
                         "range of the newest snapshot set under the "
                         "snapshot dir and hot-swaps as training "
                         "writes newer versions")
    ap.add_argument("--max-serve-restarts", type=int, default=0,
                    help="respawn a dead serving shard up to N times "
                         "per rank; routers re-resolve its new uri "
                         "through the scheduler")
    ap.add_argument("--snapshot-dir", default=None,
                    help="directory for the servers' periodic shard "
                         "snapshots (default: a fresh temp dir when "
                         "recovery is on)")
    ap.add_argument("--elastic", action="store_true",
                    help="dynamic worker membership: the scheduler "
                         "sizes the worker set (WH_ELASTIC_PLAN "
                         "scripted churn or gauge-driven control) and "
                         "the launcher spawns joining workers; "
                         "retiring workers drain and leave without a "
                         "job restart (local launch only)")
    ap.add_argument("-H", "--hosts", default=None,
                    help="comma-separated hosts to spawn role processes "
                         "on via --ssh-cmd (scheduler stays local); "
                         "omit for an all-local launch")
    ap.add_argument("--hostfile", default=None,
                    help="file with one host per line (dmlc ssh-tracker "
                         "convention); merged with --hosts")
    ap.add_argument("--ssh-cmd", default="ssh",
                    help="remote shell command; invoked as "
                         "`<ssh-cmd> <host> '<remote command line>'` "
                         "(e.g. 'ssh -o StrictHostKeyChecking=no', or a "
                         "gcloud tpu-vm wrapper script)")
    ap.add_argument("--remote-cwd", default=None,
                    help="working directory on the hosts (default: the "
                         "launch host's cwd — fine for shared "
                         "filesystems / identical pod VM images)")
    ap.add_argument("--scheduler-host", default=None,
                    help="launch-host address the remote nodes dial for "
                         "the control plane (default: auto-detected "
                         "outbound interface)")
    ap.add_argument("--coord-port", type=int, default=0,
                    help="the global mesh's coordinator port on the "
                         "first host (exported as WH_COORD_URI, where the "
                         "workers' process group meets)")
    ap.add_argument("--plane", choices=("auto", "tcp", "hot"),
                    default=None,
                    help="parameter-plane selection for the spawned "
                         "roles (exports WH_PS_PLANE): the port has the "
                         "tcp plane, which auto resolves to; hot raises "
                         "(ROADMAP.md item 5.5)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="program to launch (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given")
    hosts = [h.strip() for h in (args.hosts or "").split(",") if h.strip()]
    if args.hostfile:
        with open(args.hostfile) as fh:
            hosts += [ln.strip() for ln in fh if ln.strip()
                      and not ln.startswith("#")]
    return launch(args.num_workers, args.num_servers, cmd,
                  node_timeout=args.node_timeout,
                  env_extra=({"WH_PS_PLANE": args.plane}
                             if args.plane else None),
                  hosts=hosts or None, ssh_cmd=args.ssh_cmd,
                  remote_cwd=args.remote_cwd,
                  scheduler_host=args.scheduler_host,
                  coord_port=args.coord_port,
                  max_server_restarts=args.max_server_restarts,
                  max_worker_restarts=args.max_worker_restarts,
                  max_scheduler_restarts=args.max_scheduler_restarts,
                  num_serve=args.num_serve,
                  max_serve_restarts=args.max_serve_restarts,
                  snapshot_dir=args.snapshot_dir,
                  elastic=args.elastic)


if __name__ == "__main__":
    sys.exit(main())
