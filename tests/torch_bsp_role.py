"""A launcher's worker role in the test's own process: a port scheduler
and the WH_* environment a BSP worker of rank 0 in a group of `world`
reads (apps/_runner.py maybe_run_bsp), so an app's main runs its BSP
worker body in-process."""

import contextlib

from wormhole_tpu_torch.runtime.tracker import Scheduler


@contextlib.contextmanager
def bsp_worker_role(monkeypatch, world: int = 1):
    sched = Scheduler("127.0.0.1", 0, node_timeout=30.0)
    sched.serve()
    for k, v in (("WH_ROLE", "worker"), ("WH_RANK", "0"),
                 ("WH_NUM_WORKERS", str(world)), ("WH_NUM_SERVERS", "0"),
                 ("WH_SCHEDULER_URI", sched.uri)):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("WH_RESTORE_EPOCH", raising=False)
    monkeypatch.delenv("WH_SNAPSHOT_DIR", raising=False)
    try:
        yield sched
    finally:
        sched.stop()
