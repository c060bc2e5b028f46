"""The port's threaded workloads, one per process, for the sanitizer
gate (tests/test_torch_san_gate.py).

    WH_SAN=1 WH_SAN_DUMP_DIR=DIR python tests/torch_san_workloads.py NAME TMP

runs workload NAME with TMP as scratch space, importing the port and
nothing of the JAX package, and prints one JSON line last: the
sanitizer's summary, this process's ``san.*`` counters and the model
classes it instrumented. Workloads: ``obs`` (the registry under
contention), ``overload`` (the admission, hedge and degrade
controllers), ``serve`` (a router and two ModelServer shards closed loop
with a snapshot swap), ``async_sync`` (a SyncedStore's comms thread
against two in-process servers), ``solver`` (a linear pass with 4
loaders), and ``seeded_race`` (a port class written from two threads
without its lock: the gate's proof that it is not vacuous).
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import wormhole_tpu_torch  # noqa: E402,F401  (arms WH_SAN first)
from wormhole_tpu_torch.data.rowblock import RowBlock  # noqa: E402
from wormhole_tpu_torch.obs import metrics as _obs  # noqa: E402


def _threads(fn, n, *args):
    ts = [threading.Thread(target=fn, args=(i, *args)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)


def obs(tmp):
    reg = _obs.REGISTRY
    lock = threading.Lock()
    seen = []

    def work(i):
        for k in range(500):
            reg.counter("queue.depth_probe").inc()
            reg.gauge(f"san.gate.g{i % 2}").set(k)
            reg.histogram("train.stage.step_s").observe(k * 1e-4)
            with lock:  # a caller's lock around an instrument (an edge)
                reg.counter("queue.depth_probe").inc()
                seen.append(k)
            if k % 50 == 0:
                reg.snapshot()
            with reg.timer("train.stage.load_s"):
                pass

    _threads(work, 8)
    assert reg.counter("queue.depth_probe").value() == 8 * 1000
    assert reg.histogram("train.stage.step_s").count >= 8 * 500


def overload(tmp):
    from wormhole_tpu_torch.runtime import overload as ov

    gate = ov.AdmissionController(limit=4, adaptive=True)
    hedge = ov.HedgeTracker(quantile=0.9, budget_pct=5.0, min_ms=1.0,
                            warmup=8)
    os.environ["WH_DEGRADE"] = "1"
    deg = ov.DegradeController(target_ms=10.0, window=20)

    def work(i):
        rng = np.random.default_rng(i)
        for _ in range(400):
            if gate.try_enter("pull"):
                gate.leave("pull", float(rng.random()) * 0.01)
            gate.busy_hint_ms()
            hedge.observe(float(rng.random()) * 0.05)
            if hedge.try_issue():
                hedge.won()
            deg.observe(float(rng.random()) * 0.02)
            deg.active()

    _threads(work, 8)
    assert gate.inflight == 0


def serve(tmp):
    from wormhole_tpu_torch import serving as T
    from wormhole_tpu_torch.models.linear import LinearConfig
    from wormhole_tpu_torch.utils import manifest

    rng = np.random.default_rng(3)
    cfg = LinearConfig(minibatch=32, num_buckets=1 << 10, nnz_per_row=8)
    base = os.path.join(tmp, "srv")
    manifest.write_snapshot_set(
        base, {"w": np.full(cfg.num_buckets, 1.0, np.float32)}, world=2)
    servers = [T.ModelServer(r, 2, base, poll_sec=0.02) for r in range(2)]
    for s in servers:
        s.serve()
    router = T.Router([s.uri for s in servers],
                      T.LinearScorer(cfg, device="cpu"), mode="fetch",
                      retry_deadline=10.0)
    blocks = []
    for _ in range(4):
        counts = rng.integers(1, 12, size=32)
        offset = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        blocks.append(RowBlock(
            label=np.zeros(32, np.float32), offset=offset,
            index=rng.integers(0, 1 << 62, size=int(offset[-1]),
                               dtype=np.int64).astype(np.uint64),
            value=rng.normal(size=int(offset[-1])).astype(np.float32)))
    stop = threading.Event()
    versions, errors = set(), []

    def load(i):
        k = i
        while not stop.is_set():
            try:
                _, ver = router.predict_block(blocks[k % len(blocks)])
                versions.add(ver)
            except Exception as e:  # noqa: BLE001  (reported below)
                errors.append(e)
            k += 1

    ts = [threading.Thread(target=load, args=(i,)) for i in range(4)]
    try:
        for t in ts:
            t.start()
        time.sleep(0.5)
        v = manifest.write_snapshot_set(
            base, {"w": np.full(cfg.num_buckets, 2.0, np.float32)}, world=2)
        deadline = time.monotonic() + 10
        while (any(s.version != v for s in servers)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(0.5)
    finally:
        stop.set()
        for t in ts:
            t.join(30)
        router.close()
        for s in servers:
            s.stop()
    assert not errors, errors[:3]
    assert v in versions and len(versions) >= 2


class _HostStore:
    """gather/scatter duck type standing in for a KVStore (host numpy)."""

    def __init__(self, n):
        self.tables = {"w": np.zeros(n, np.float32)}

    def to_numpy(self):
        return {k: v.copy() for k, v in self.tables.items()}

    def from_numpy(self, arrays):
        for k, v in arrays.items():
            self.tables[k] = np.array(v, np.float32)

    def gather_rows(self, k, idx):
        return self.tables[k][idx]

    def scatter_rows(self, k, idx, vals):
        self.tables[k][idx] = vals


def async_sync(tmp):
    from wormhole_tpu_torch.runtime import ps_server as ps

    n = 256
    nodes = [ps.ServerNode(r, 2) for r in range(2)]
    for node in nodes:
        node.serve()
    clients, stores = [], []
    try:
        for w in range(2):
            store = _HostStore(n)
            touched = {"rows": np.empty(0, np.int64)}

            def collect(touched=touched):
                out = {"w": touched["rows"]}
                touched["rows"] = np.empty(0, np.int64)
                return out

            c = ps.PSClient([nd.uri for nd in nodes], sender=f"san{w}")
            clients.append(c)
            ss = ps.SyncedStore(store, c, max_delay=1, touched_fn=collect,
                                async_sync=True)
            stores.append((store, touched, ss))
        for _, _, ss in stores:
            ss.init()
        rng = np.random.default_rng(0)
        want = np.zeros(n, np.float32)
        for _ in range(12):
            for w, (store, touched, ss) in enumerate(stores):
                idx = np.unique(rng.integers(0, n, size=16))
                store.tables["w"][idx] += w + 1.0
                want[idx] += w + 1.0
                touched["rows"] = np.union1d(touched["rows"], idx)
                ss.sync()
        for _, _, ss in stores:
            ss.flush()
        for store, _, ss in stores:
            ss.pull()
            np.testing.assert_allclose(store.tables["w"], want, rtol=1e-6)
            ss.close()
    finally:
        for c in clients:
            c.close()
        for node in nodes:
            node.stop()


def solver(tmp):
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    rng = np.random.default_rng(0)
    w = rng.normal(size=1000)
    path = os.path.join(tmp, "train.libsvm")
    with open(path, "w") as f:
        for _ in range(2048):
            idx = np.sort(rng.choice(1000, 8, replace=False))
            f.write(f"{int(w[idx].sum() > 0)} "
                    + " ".join(f"{i}:1" for i in idx) + "\n")
    os.environ["WH_NUM_LOADERS"] = "4"
    cfg = LinearConfig(train_data=path, val_data=path, algo="ftrl",
                       lambda_l1=1.0, lr_eta=0.2, minibatch=128,
                       num_buckets=1 << 14, max_data_pass=1,
                       num_parts_per_file=4)
    res = MinibatchSolver(LinearLearner(cfg, device="cpu"), cfg,
                          verbose=False).run()
    assert res["val"].mean("logloss") < 0.6


def seeded_race(tmp):
    """Progress.tot written from two threads without Progress._lock."""
    from wormhole_tpu_torch.solver.progress import Progress

    p = Progress()
    p.tot = {"nex": 1.0}  # the owner's write
    first = threading.Event()

    def writer(i):
        if i:
            first.wait(10)
        p.tot = {"nex": float(i + 2)}  # no lock: the seeded bug
        if not i:
            first.set()

    _threads(writer, 2)


WORKLOADS = {f.__name__: f for f in (obs, overload, serve, async_sync,
                                     solver, seeded_race)}


def main(name, tmp):
    WORKLOADS[name](tmp)
    san = sys.modules.get("wormhole_tpu_torch.wormsan")
    out = {"workload": name, "armed": bool(san and san.enabled())}
    if out["armed"]:
        out.update(summary=san.summary(), counters=_obs.san_counters(),
                   instrumented=san.instrumented(),
                   findings=[f["key"] for f in san.findings()])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
