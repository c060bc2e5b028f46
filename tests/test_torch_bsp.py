"""The port's BSP allreduce ring (wormhole_tpu_torch/runtime/allreduce.py)
in one process, threads driving the ranks, against numpy and the JAX
package's ring.

The ring cases are the JAX package's (tests/test_bsp_allreduce.py,
tests/test_wire_codec.py's BSP cases, tests/test_elastic.py's leave and
join) run on the port. A mixed ring (ranks 0 and 2 the JAX package's
BspWorker, rank 1 the port's) must give the same bits as an all-JAX
ring. The solver over the ring: L-BFGS linear and FM with `comm` over a
3-rank port ring against a 3-rank JAX ring on the same part slices, and
against the port's single process on the union of the files, to the bar
of tests/test_torch_lbfgs.py (objv_history within rtol 1e-4 over the
first 8 iterations, the final w within atol 1e-4)."""

import contextlib
import sys
import threading
import types

import numpy as np
import pytest
import torch

from conftest import synth_libsvm_text
from test_difacto import fm_synth_text
from wormhole_tpu.models import batch_objectives as jb
from wormhole_tpu.parallel.mesh import make_mesh as j_make_mesh
from wormhole_tpu.runtime import allreduce as j_allreduce
from wormhole_tpu.runtime import tracker as j_tracker
from wormhole_tpu.solver.lbfgs import LBFGSConfig as JConfig
from wormhole_tpu.solver.lbfgs import LBFGSSolver as JSolver
from wormhole_tpu_torch import interop
from wormhole_tpu_torch.models import batch_objectives as tb
from wormhole_tpu_torch.runtime import allreduce as t_allreduce
from wormhole_tpu_torch.runtime import tracker as t_tracker
from wormhole_tpu_torch.solver.lbfgs import LBFGSConfig, LBFGSSolver

PKGS = {"port": (t_allreduce, t_tracker), "jax": (j_allreduce, j_tracker)}


@contextlib.contextmanager
def fresh_ring():
    """A live scheduler of the port plus a factory of registered
    BspWorkers of either package (`impl`); tears everything down."""
    sched = t_tracker.Scheduler("127.0.0.1", 0, node_timeout=10.0)
    sched.serve()
    made = []

    def make(rank: int, world: int, impl: str = "port", **kw):
        ar, tr = PKGS[impl]
        c = tr.SchedulerClient(sched.uri, f"worker-{rank}")
        c.register()
        w = ar.BspWorker(rank, world, c, step_timeout=0.5, retry_sec=20.0,
                         **kw)
        made.append(w)
        return w

    make.sched = sched
    try:
        yield make
    finally:
        for w in made:
            w.close()
        sched.stop()


@pytest.fixture
def ring():
    with fresh_ring() as make:
        yield make


def run_ranks(fns):
    """Run one callable per rank concurrently (collectives block until
    all ranks arrive); re-raise the first failure."""
    results = [None] * len(fns)
    errors = []

    def runner(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    ts = [threading.Thread(target=runner, args=(i, f))
          for i, f in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    assert all(not t.is_alive() for t in ts), "ring deadlocked"
    return results


def make_group(make, world: int, impls=None, **kw):
    """Construct all ranks concurrently: a BspWorker's constructor blocks
    until the whole group has registered."""
    impls = impls or ["port"] * world
    return run_ranks([lambda r=r: make(r, world, impls[r], **kw)
                      for r in range(world)])


# -- the JAX package's ring cases, on the port -------------------------------

def test_ring_sum_matches_numpy(ring):
    world = 3
    comms = make_group(ring, world)
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=37).astype(np.float32) for _ in range(world)]
    outs = run_ranks([lambda c=c, x=x: c.allreduce(x)
                      for c, x in zip(comms, xs)])
    # the ring's chunked accumulation order differs from np.sum's; across
    # ranks the result is the same bits (the property replays rely on)
    np.testing.assert_allclose(outs[0], np.sum(xs, axis=0), rtol=1e-5)
    for o in outs[1:]:
        assert np.array_equal(outs[0], o)


def test_scalar_keeps_shape(ring):
    comms = make_group(ring, 3)
    outs = run_ranks([lambda c=c, v=v: c.allreduce(np.float32(v))
                      for c, v in zip(comms, [1.5, 2.0, 3.25])])
    for o in outs:
        assert o.shape == ()  # 0-d in, 0-d out (the solver's raw losses)
        assert float(o) == pytest.approx(6.75)


def test_max_and_broadcast(ring):
    world = 3
    comms = make_group(ring, world)
    xs = [np.arange(8, dtype=np.float32) * (r + 1) for r in range(world)]
    outs = run_ranks([lambda c=c, x=x: c.allreduce(x, op="max")
                      for c, x in zip(comms, xs)])
    for o in outs:
        assert np.array_equal(o, xs[-1])  # max is exact
    payload = np.arange(5, dtype=np.float32)
    outs = run_ranks(
        [lambda c=c, r=r: c.broadcast(payload if r == 1 else None, root=1)
         for r, c in enumerate(comms)])
    for o in outs:
        assert np.array_equal(o, payload)


@pytest.mark.parametrize("wire", [None, "int8"], ids=["raw", "int8"])
def test_replay_after_drop(ring, monkeypatch, wire):
    """A respawned rank that died before its first checkpoint replays the
    completed version-0 collectives bit for bit from the survivor's
    result cache, its own (garbage) input ignored; with the codec on
    too, since each chunk quantizes statelessly."""
    n = 4096 if wire else 11
    c0, c1 = make_group(ring, 2, wire=wire)
    rng = np.random.default_rng(11)
    xs0 = [rng.normal(size=n).astype(np.float32) for _ in range(2)]
    xs1 = [rng.normal(size=n).astype(np.float32) for _ in range(2)]
    r0, r1 = run_ranks([lambda: [c0.allreduce(x) for x in xs0],
                        lambda: [c1.allreduce(x) for x in xs1]])
    assert np.array_equal(r0[0], r1[0])
    c1.close()  # rank 1 "dies" (no checkpoint ever taken)
    # its respawned incarnation starts behind (WH_RESTORE_EPOCH is how
    # the launcher marks a respawn) and must fetch, not re-ring
    monkeypatch.setenv("WH_RESTORE_EPOCH", "1")
    c1b = ring(1, 2, wire=wire)
    assert c1b.gen > 0  # re-registration bumped the group generation
    garbage = np.full(n, -999.0, np.float32)
    replayed = [c1b.allreduce(garbage) for _ in range(2)]
    assert np.array_equal(replayed[0], r0[0])
    assert np.array_equal(replayed[1], r0[1])


def test_checkpoint_roundtrip(ring, tmp_path):
    c = ring(0, 1, snapshot_dir=str(tmp_path))
    c.allreduce(np.ones(4, np.float32))
    state = {"w": np.arange(6, dtype=np.float32), "round": np.int64(3)}
    c.checkpoint(state)
    assert c.version == 1 and c.seq == 0
    c.close()
    c2 = ring(0, 1, snapshot_dir=str(tmp_path))
    st = c2.load_checkpoint()
    assert st is not None
    assert int(st["round"]) == 3
    assert np.array_equal(st["w"], state["w"])
    assert c2.version == 1 and c2.seq == 0


def test_checkpoint_prunes_old_versions(ring, tmp_path):
    """The result cache keeps exactly one version of history (live skew
    across ranks is at most one version)."""
    c = ring(0, 1, snapshot_dir=str(tmp_path))
    c.allreduce(np.ones(3, np.float32))            # (v0, 0)
    c.checkpoint({"a": np.zeros(1)})               # -> v1
    c.allreduce(np.ones(3, np.float32))            # (v1, 0)
    c.checkpoint({"a": np.zeros(1)})               # -> v2: prunes v0
    with c._results_lock:
        versions = {k[0] for k in c._results}
    assert versions == {1}


def test_quantized_allreduce_cross_rank_bit_identical(ring):
    """With the codec on, every rank reconstructs the same bits (the
    allgather leg ships bf16, idempotent under re-rounding) and the sum
    stays within the quantization error of exact."""
    world = 3
    comms = make_group(ring, world, wire="int8")
    rng = np.random.default_rng(10)
    xs = [rng.normal(size=5000).astype(np.float32) for _ in range(world)]
    outs = run_ranks([lambda c=c, x=x: c.allreduce(x)
                      for c, x in zip(comms, xs)])
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)
    exact = np.sum(xs, axis=0)
    step = float(np.abs(exact).max())
    np.testing.assert_allclose(outs[0], exact, atol=world * step / 64)


def test_small_payloads_stay_raw(ring):
    """Scalars and tiny arrays (loss sums) never quantize."""
    comms = make_group(ring, 2, wire="int4")
    outs = run_ranks([lambda c=c, v=v: c.allreduce(np.float32(v))
                      for c, v in zip(comms, [1.5, 2.25])])
    for o in outs:
        assert float(o) == 3.75


def test_leave_rebuilds_shrunk_ring(ring):
    """A rank resigning (bsp_leave) bumps the generation; the survivors'
    next collective aborts against the dead peer, adopts the shrunk peer
    list (rank and world re-indexed) and completes over 2, the reduced
    value the same bits on both."""
    world = 3
    c0, c1, c2 = make_group(ring, world)
    xs = [np.full(13, float(r + 1), np.float32) for r in range(world)]
    outs = run_ranks([lambda c=c, x=x: c.allreduce(x)
                      for c, x in zip((c0, c1, c2), xs)])
    assert float(outs[0][0]) == pytest.approx(6.0)
    gen0 = c0.gen
    c2.leave()
    c2.close()
    outs = run_ranks([lambda c=c, x=x: c.allreduce(x)
                      for c, x in zip((c0, c1), xs[:2])])
    np.testing.assert_allclose(outs[0], xs[0] + xs[1])
    assert np.array_equal(outs[0], outs[1])
    assert c0.gen > gen0
    assert c0.world == 2 and c1.world == 2
    assert {c0.rank, c1.rank} == {0, 1}


def test_join_bumps_generation(ring):
    """Once the group has formed, a never-seen rank registering is an
    elastic join: the generation bumps and bsp_peers reports the grown
    set, which survivors rebuild over at their round boundary."""
    c0, c1 = make_group(ring, 2)
    run_ranks([lambda c=c: c.allreduce(np.ones(4, np.float32))
               for c in (c0, c1)])
    gen0 = c0.gen
    c2_client = t_tracker.SchedulerClient(ring.sched.uri, "worker-2")
    c2_client.register()
    r = c2_client.call(op="register_bsp", rank=2, world=3,
                       uri="127.0.0.1:1")
    assert int(r["gen"]) == gen0 + 1
    peers = c2_client.call(op="bsp_peers", world=2)
    assert peers["ready"] and len(peers["uris"]) == 3
    assert c0._poll_gen() is True
    assert c0.world == 3 and c0.rank == 0


# -- a mixed ring --------------------------------------------------------------

def _collectives(comms, xs, payload):
    """sum, max and a broadcast from rank 1 over one group."""
    sums = run_ranks([lambda c=c, x=x: c.allreduce(x)
                      for c, x in zip(comms, xs)])
    maxes = run_ranks([lambda c=c, x=x: c.allreduce(x, op="max")
                       for c, x in zip(comms, xs)])
    bcast = run_ranks(
        [lambda c=c, r=r: c.broadcast(payload if r == 1 else None, root=1)
         for r, c in enumerate(comms)])
    return sums, maxes, bcast


@pytest.mark.parametrize("wire", [None, "int8"], ids=["raw", "int8"])
def test_mixed_ring_matches_an_all_jax_ring(ring, wire):
    """Ranks 0 and 2 the JAX package's BspWorker, rank 1 the port's, on
    the port's scheduler: sum, max and broadcast give the same bits as
    an all-JAX ring on the same inputs, with the codec off and on."""
    world = 3
    rng = np.random.default_rng(21)
    xs = [rng.normal(size=5000).astype(np.float32) for _ in range(world)]
    payload = rng.normal(size=300).astype(np.float32)
    mixed = make_group(ring, world, ["jax", "port", "jax"], wire=wire)
    assert type(mixed[1]) is t_allreduce.BspWorker
    assert type(mixed[0]) is j_allreduce.BspWorker
    got = _collectives(mixed, xs, payload)
    for c in mixed:
        c.leave()
        c.close()
    sched = j_tracker.Scheduler("127.0.0.1", 0, node_timeout=10.0)
    sched.serve()
    try:
        def make(r):
            c = j_tracker.SchedulerClient(sched.uri, f"worker-{r}")
            c.register()
            return j_allreduce.BspWorker(r, world, c, step_timeout=0.5,
                                         retry_sec=20.0, wire=wire)
        alljax = run_ranks([lambda r=r: make(r) for r in range(world)])
        try:
            want = _collectives(alljax, xs, payload)
        finally:
            for c in alljax:
                c.close()
    finally:
        sched.stop()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # and every rank of the mixed ring holds the same bits
    for g in got:
        assert all(np.array_equal(g[0], o) for o in g[1:])


# -- threads ---------------------------------------------------------------------

def test_handler_threads_make_no_torch_call(ring, monkeypatch):
    """The frame server's handler threads touch only the mailbox and the
    result cache (numpy): a profile hook in each handler thread records
    every Python and C call into torch while three ranks run L-BFGS with
    torch objectives over the ring."""
    seen, torch_calls = [], []

    def prof(frame, event, arg):
        if event == "call":
            mod = frame.f_globals.get("__name__", "")
            seen.append(mod)
            if mod.split(".")[0] == "torch":
                torch_calls.append(f"{mod}.{frame.f_code.co_name}")
        elif event == "c_call":
            mod = getattr(arg, "__module__", None) or ""
            if mod.split(".")[0] == "torch":
                torch_calls.append(f"{mod}.{arg.__name__}")

    orig = t_allreduce._BspHandler.handle

    def handle(self):
        sys.setprofile(prof)
        try:
            orig(self)
        finally:
            sys.setprofile(None)

    monkeypatch.setattr(t_allreduce._BspHandler, "handle", handle)
    comms = make_group(ring, 3)
    rng = np.random.default_rng(5)

    def rank(c):
        obj = _ToyObj(rng.standard_normal((64, 9)).astype(np.float32))
        w, _ = LBFGSSolver(obj, LBFGSConfig(max_iter=3, reg_l2=0.1),
                           comm=c).run(verbose=False)
        return w

    ws = run_ranks([lambda c=c: rank(c) for c in comms])
    assert all(torch.equal(ws[0], w) for w in ws[1:])
    assert any(m.endswith("runtime.net") for m in seen)  # the hook ran
    assert not torch_calls, sorted(set(torch_calls))[:10]


class _ToyObj:
    """A least-squares objective of torch tensors on the CPU: enough for
    the solver to drive the ring with real torch work on each rank."""

    def __init__(self, X):
        self.X = torch.from_numpy(X)
        self.y = self.X.sum(1)
        self.num_dim = self.num_dim_padded = X.shape[1]
        self.device = torch.device("cpu")

    def init_model(self):
        return torch.zeros(self.num_dim)

    def eval(self, w):
        return float(0.5 * ((self.X @ w - self.y) ** 2).sum())

    def grad(self, w):
        return self.X.T @ (self.X @ w - self.y)

    def l1_mask(self):
        return torch.ones(self.num_dim)


# -- L-BFGS over the ring ------------------------------------------------------

RANKS = 3


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """Three files drawn from one model, one rank's part each (the
    well-conditioned data of tests/test_torch_lbfgs.py, split)."""
    d = tmp_path_factory.mktemp("bspl")
    for i in range(RANKS):
        (d / f"lin-{i}.libsvm").write_text(synth_libsvm_text(
            n_rows=500, n_feat=120, nnz_per_row=10, seed=11 + i))
    fm = fm_synth_text(n_rows=2000).splitlines(keepends=True)
    for i in range(RANKS):
        (d / f"fm-{i}.libsvm").write_text("".join(fm[i::RANKS]))
    return d


CASES = {"linear": dict(key="lbfgs_dim", nnz=16, cfg=dict(reg_l2=1e-3)),
         "fm": dict(key="lbfgs_fm_dim", nnz=8, cfg=dict(reg_l2=1e-4))}


def _port_obj(kind, batches, nf):
    if kind == "linear":
        return tb.LinearObjFunction(batches, nf, "cpu")
    return tb.FmObjFunction(batches, nf, 6, "cpu", init_scale=0.1)


def _jax_obj(kind, batches, nf, mesh):
    if kind == "linear":
        return jb.LinearObjFunction(batches, nf, mesh)
    return jb.FmObjFunction(batches, nf, dim_k=6, mesh=mesh, init_scale=0.1)


def _ring_run(impl, kind, pattern, world=RANKS):
    """One L-BFGS run over a fresh ring of `world` ranks of `impl`, each
    rank loading its part slice through its package's load_batches_bsp;
    the FM starts every rank from the JAX package's V. Returns each
    rank's (objv_history, w as numpy, iterations)."""
    with fresh_ring() as make:
        return _ring_ranks(make, impl, kind, pattern, world)


def _ring_ranks(make, impl, kind, pattern, world):
    case = CASES[kind]
    comms = make_group(make, world, [impl] * world)
    w0 = None
    if kind == "fm":  # JAX's init: the port draws V with numpy
        bj, nj = jb.load_batches(pattern, j_make_mesh(1, 1), minibatch=512,
                                 nnz_per_row=case["nnz"])
        w0 = np.asarray(_jax_obj(kind, bj, nj, j_make_mesh(1, 1))
                        .init_model())

    def rank(r):
        env = types.SimpleNamespace(rank=r, num_workers=world)
        client, comm = comms[r].client, comms[r]
        if impl == "port":
            b, nf = tb.load_batches_bsp(pattern, env, client, minibatch=512,
                                        nnz_per_row=case["nnz"],
                                        key=case["key"], device="cpu")
            obj = _port_obj(kind, b, nf)
            if w0 is not None:
                w = interop.lbfgs_state_from_numpy(
                    {"w": w0}, obj.num_dim, "cpu")["w"]
                obj.init_model = lambda: w.clone()
            s = LBFGSSolver(obj, LBFGSConfig(max_iter=8, m=8, **case["cfg"]),
                            comm=comm)
        else:
            mesh = j_make_mesh(1, 1)
            b, nf = jb.load_batches_bsp(pattern, mesh, env, client,
                                        minibatch=512,
                                        nnz_per_row=case["nnz"],
                                        key=case["key"])
            obj = _jax_obj(kind, b, nf, mesh)
            s = JSolver(obj, JConfig(max_iter=8, m=8, **case["cfg"]),
                        comm=comm)
        w, _ = s.run(verbose=False)
        return s.objv_history, np.asarray(w)[: obj.num_dim], s.iter

    return run_ranks([lambda r=r: rank(r) for r in range(world)])


def _single_port(kind, pattern):
    """The port's single process on the union of the files."""
    case = CASES[kind]
    b, nf = tb.load_batches(pattern, minibatch=512, nnz_per_row=case["nnz"],
                            device="cpu")
    obj = _port_obj(kind, b, nf)
    if kind == "fm":
        bj, nj = jb.load_batches(pattern, j_make_mesh(1, 1), minibatch=512,
                                 nnz_per_row=case["nnz"])
        w = interop.lbfgs_state_from_numpy(
            {"w": np.asarray(_jax_obj(kind, bj, nj, j_make_mesh(1, 1))
                             .init_model())}, obj.num_dim, "cpu")["w"]
        obj.init_model = lambda: w.clone()
    s = LBFGSSolver(obj, LBFGSConfig(max_iter=8, m=8, **case["cfg"]))
    w, _ = s.run(verbose=False)
    return s.objv_history, w.numpy(), s.iter


def _close(got, want):
    (oh_g, w_g, it_g), (oh_w, w_w, it_w) = got, want
    n = min(9, len(oh_w))  # init + the first 8 iterations
    assert len(oh_g) >= n and it_g == it_w
    np.testing.assert_allclose(oh_g[:n], oh_w[:n], rtol=1e-4)
    np.testing.assert_allclose(w_g, w_w, atol=1e-4)


@pytest.mark.parametrize("kind", ["linear", "fm"])
def test_lbfgs_over_a_port_ring_matches_the_jax_ring(parts, kind):
    pattern = str(parts / f"{'lin' if kind == 'linear' else 'fm'}-.*")
    port = _ring_run("port", kind, pattern)
    jax_ = _ring_run("jax", kind, pattern)
    for r in range(RANKS):  # every rank of a ring holds the same run
        assert port[r][0] == port[0][0]
        assert np.array_equal(port[r][1], port[0][1])
    assert port[0][0][-1] < port[0][0][0]
    _close(port[0], jax_[0])
    _close(port[0], _single_port(kind, pattern))


def test_a_rank_without_parts_joins_every_collective(parts):
    """Four ranks over three files: rank 3 holds no batches, adds zeros
    to every sum, and the run meets the bar against three ranks."""
    pattern = str(parts / "lin-.*")
    four = _ring_run("port", "linear", pattern, world=4)
    assert all(np.array_equal(four[r][1], four[0][1]) for r in range(4))
    _close(four[0], _single_port("linear", pattern))


def _gbdt_ring(make, world, pattern, val, model):
    """The gbdt app's BSP worker body on `world` thread ranks."""
    from wormhole_tpu_torch.apps import _runner, gbdt

    comms = make_group(make, world)

    def rank(r):
        cfg, _ = _runner.parse_cli(gbdt.GbdtConfig, [
            f"train_data={pattern}", f"eval_data={val}", "num_round=2",
            "max_depth=3", "max_bin=16", "minibatch=128",
            f"model_out={model}"])
        env = types.SimpleNamespace(rank=r, num_workers=world)
        return gbdt._bsp_worker_body(cfg, env, comms[r].client, comms[r],
                                     "cpu")

    assert run_ranks([lambda r=r: rank(r) for r in range(world)]) == \
        [0] * world
    return np.load(model)


def test_gbdt_rank_without_parts_holds_one_masked_row(parts, tmp_path):
    """Four GBDT ranks over three files: rank 3 holds one masked row and
    joins every collective; the trees equal three ranks' (the ring sums
    in another order, so leaves within 1e-5)."""
    pattern, val = str(parts / "lin-.*"), str(parts / "lin-0.libsvm")
    with fresh_ring() as make:
        three = _gbdt_ring(make, 3, pattern, val, tmp_path / "three.npz")
    with fresh_ring() as make:
        four = _gbdt_ring(make, 4, pattern, val, tmp_path / "four.npz")
    np.testing.assert_array_equal(three["edges"], four["edges"])
    for k in ("split_feat", "split_bin", "is_split"):
        np.testing.assert_array_equal(three[k], four[k], err_msg=k)
    np.testing.assert_allclose(three["leaf_value"], four["leaf_value"],
                               atol=1e-5)
