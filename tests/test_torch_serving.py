"""The port's serving tier: snapshot manifests, sharded fetch, scoring
bit-matched to the port's own predict_batch on the CPU, hot swap under
load, backpressure and exactly-once replay — the counterparts of
tests/test_serving.py — and its parity with the JAX tier: the same
snapshot served by either package, mixed groups (a port router over JAX
shards and the reverse), and snapshot sets that load across packages.

Bars: linear margins in both modes and DiFacto's fetch mode are held
bit for bit (np.array_equal, which treats -0.0 and +0.0 as equal: the
score-mode fold can flip the sign of a zero margin); DiFacto's score
mode reassociates its quadratic term across shards, and the JAX tier's
DiFacto margins come from XLA's reductions, so both are held to rtol
1e-5 / atol 1e-6."""

import threading
import time

import numpy as np
import pytest
import torch

import wormhole_tpu.serving as J
from wormhole_tpu.models.linear import LinearConfig as JLinearConfig
from wormhole_tpu.models.difacto import DifactoConfig as JDifactoConfig
from wormhole_tpu.utils import manifest as jmanifest
import wormhole_tpu_torch.serving as T
from wormhole_tpu_torch.data.rowblock import RowBlock
from wormhole_tpu_torch.models.difacto import DifactoConfig, DifactoLearner
from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.runtime import net as _net
from wormhole_tpu_torch.serving import scoring as tscoring
from wormhole_tpu_torch.utils import manifest as _manifest

CPU = "cpu"
FM_TOL = dict(rtol=1e-5, atol=1e-6)


def _blk(rng, n=50, max_nnz=12):
    counts = rng.integers(1, max_nnz, size=n)
    offset = np.zeros(n + 1, np.int64)
    offset[1:] = np.cumsum(counts)
    return RowBlock(
        label=np.zeros(n, np.float32),
        offset=offset,
        index=rng.integers(0, 1 << 62, size=int(offset[-1]),
                           dtype=np.int64).astype(np.uint64),
        value=rng.normal(size=int(offset[-1])).astype(np.float32),
    )


def _serve_group(base, world, pkg=T, **kw):
    servers = [pkg.ModelServer(r, world, base, **kw) for r in range(world)]
    for s in servers:
        s.serve()
    return servers


def _serve(base, world, scorer, mode, servers_pkg=T, router_pkg=T):
    """(servers, router) over one snapshot; the caller tears both down
    with _close."""
    servers = _serve_group(base, world, servers_pkg)
    try:
        return servers, router_pkg.Router(
            [s.uri for s in servers], scorer, mode=mode,
            retry_deadline=10.0)
    except BaseException:
        for s in servers:
            s.stop()
        raise


def _close(servers, router):
    router.close()
    for s in servers:
        s.stop()


def _tables(store):
    return {k: v.cpu().numpy() for k, v in store.state.items()}


# ---------------------------------------------------------------- manifest
def test_snapshot_set_roundtrip(tmp_path):
    base = str(tmp_path / "srv")
    w = np.arange(100, dtype=np.float32)
    V = np.arange(40, dtype=np.float32).reshape(20, 2)
    v1 = _manifest.write_snapshot_set(base, {"w": w, "V": V}, world=2)
    man = _manifest.read_manifest(base)
    assert _manifest.complete(man)
    assert man["full_rows"] == {"w": 100, "V": 20}
    tables, meta = _manifest.load_slices(
        base, {"w": (0, 100), "V": (0, 20)}, man)
    assert np.array_equal(tables["w"], w)
    assert np.array_equal(tables["V"], V)
    assert meta["version"] == v1
    v2 = _manifest.write_snapshot_set(base, {"w": w * 2, "V": V}, world=2)
    assert v2 > v1
    tables, _ = _manifest.load_slices(base, {"w": (30, 80)})
    assert np.array_equal(tables["w"], w[30:80] * 2)


def test_torn_snapshot_detected(tmp_path):
    base = str(tmp_path / "srv")
    _manifest.write_snapshot_set(
        base, {"w": np.ones(64, np.float32)}, world=1)
    man = _manifest.read_manifest(base)
    np.savez(base + "_part-0.npz", w=np.zeros(64, np.float32))
    with pytest.raises(_manifest.TornSnapshot):
        _manifest.read_part(base, man, 0)
    with pytest.raises(_manifest.TornSnapshot):
        T.ServingModel(base, 0, 1, man)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_sets_load_across_packages(tmp_path, writer):
    """A set either package's write_snapshot_set writes loads in the
    other's ServingModel, slice for slice, at the committed version."""
    rng = np.random.default_rng(9)
    tables = {"w": rng.normal(size=1000).astype(np.float32),
              "V": rng.normal(size=(250, 4)).astype(np.float32)}
    base = str(tmp_path / "srv")
    write = (jmanifest if writer == "jax" else _manifest).write_snapshot_set
    read = T if writer == "jax" else J
    v = write(base, tables, world=3)
    for rank in range(2):
        m = read.ServingModel(base, rank, 2)
        assert m.version == v
        for t, full in tables.items():
            lo, hi = m.ranges[t]
            assert np.array_equal(m.tables[t], full[lo:hi])
            assert np.array_equal(m.fetch(t, np.arange(lo, hi)),
                                  full[lo:hi])
        assert np.array_equal(m.replicated("V"), tables["V"])


# ------------------------------------------------- bit-exact sharded predict
@pytest.mark.parametrize("mode", ["fetch", "score"])
def test_linear_serving_bitmatch_and_hot_swap(tmp_path, mode):
    """Train a small port linear model, snapshot it, serve it from 2
    shards through the router, and the scores BIT-match the learner's
    own predict_batch on both dataflows; then a newer snapshot
    hot-swaps in and the scores follow it."""
    rng = np.random.default_rng(0)
    cfg = LinearConfig(minibatch=64, num_buckets=1 << 12, nnz_per_row=16)
    learner = LinearLearner(cfg, device=CPU)
    train = _blk(rng, n=64)
    train.label[:] = (rng.random(64) > 0.5).astype(np.float32)
    for _ in range(3):
        learner.train_batch(train)

    base = str(tmp_path / "srv")
    v1 = _manifest.write_snapshot_set(base, _tables(learner.store), world=2)
    servers, router = _serve(base, 2, T.LinearScorer(cfg, device=CPU), mode)
    assert router.mode == mode
    try:
        blk = _blk(rng, n=50)
        scores, version = router.predict_block(blk)
        assert version == v1
        assert np.array_equal(scores, learner.predict_batch(blk)[:50])

        for _ in range(2):
            learner.train_batch(train)
        v2 = _manifest.write_snapshot_set(base, _tables(learner.store),
                                          world=2)
        assert all(s.maybe_swap() for s in servers)
        scores2, version2 = router.predict_block(blk)
        assert version2 == v2 > v1
        assert np.array_equal(scores2, learner.predict_batch(blk)[:50])
    finally:
        _close(servers, router)


def _difacto(rng, **kw):
    cfg = DifactoConfig(minibatch=64, num_buckets=1 << 10, nnz_per_row=16,
                        dim=4, threshold=2, **kw)
    tables = {
        "w": rng.normal(size=cfg.num_buckets).astype(np.float32),
        "cnt": rng.integers(0, 5, size=cfg.num_buckets).astype(np.float32),
        "V": (rng.normal(size=(cfg.vb, cfg.dim)) * 0.1).astype(np.float32)}
    return cfg, tables


@pytest.mark.parametrize("mode", ["fetch", "score"])
def test_difacto_serving_bitmatch(tmp_path, mode):
    """Fetch mode reproduces the learner's margins bit for bit; score
    mode holds the cross-shard reassociation bar."""
    rng = np.random.default_rng(1)
    cfg, tables = _difacto(rng)
    learner = DifactoLearner(cfg, device=CPU)
    learner.store.state["w"].copy_(torch.from_numpy(tables["w"]))
    learner.store.state["cnt"].copy_(torch.from_numpy(tables["cnt"]))
    learner.vstore.state["V"].copy_(torch.from_numpy(tables["V"]))

    base = str(tmp_path / "srv")
    _manifest.write_snapshot_set(base, tables, world=3)
    servers, router = _serve(base, 3, T.DifactoScorer(cfg, device=CPU),
                             mode)
    try:
        blk = _blk(rng, n=40)
        scores, _ = router.predict_block(blk)
        ref = learner.predict_batch(blk)[:40]
        if mode == "fetch":
            assert np.array_equal(scores, ref)
        else:
            np.testing.assert_allclose(scores, ref, **FM_TOL)
    finally:
        _close(servers, router)


@pytest.mark.parametrize("mode", ["fetch", "score"])
def test_router_world_sizes_agree(tmp_path, mode):
    """1-shard and 3-shard groups over one snapshot give the same bits."""
    rng = np.random.default_rng(2)
    cfg = LinearConfig(minibatch=32, num_buckets=1 << 10, nnz_per_row=8)
    base = str(tmp_path / "srv")
    _manifest.write_snapshot_set(
        base, {"w": rng.normal(size=cfg.num_buckets).astype(np.float32)},
        world=2)
    blk = _blk(rng, n=30)
    got = {}
    for world in (1, 3):
        servers, router = _serve(base, world,
                                 T.LinearScorer(cfg, device=CPU), mode)
        try:
            got[world], _ = router.predict_block(blk)
        finally:
            _close(servers, router)
    assert np.array_equal(got[1], got[3])


def test_scorer_needs_cuda_unless_told_cpu(monkeypatch):
    """With no device the scorers take the card, and raise where there
    is none rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, cfg in ((T.LinearScorer, LinearConfig()),
                     (T.DifactoScorer, DifactoConfig())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cfg)
        assert cls(cfg, device=CPU).device == torch.device("cpu")


# ------------------------------------------------------- swap under load
@pytest.mark.parametrize("mode", ["fetch", "score"])
def test_hot_swap_under_load_no_mixed_versions(tmp_path, mode):
    """Concurrent predicts while snapshots keep swapping: every batch's
    scores match the version its reply claims — no drops, no
    mixed-version batches (in score mode, coalesced rounds replay
    whole)."""
    rng = np.random.default_rng(3)
    cfg = LinearConfig(minibatch=32, num_buckets=1 << 10, nnz_per_row=8)
    base = str(tmp_path / "srv")
    versions = {}
    v = _manifest.write_snapshot_set(
        base, {"w": np.full(cfg.num_buckets, 1.0, np.float32)}, world=2)
    versions[v] = 1.0
    servers = _serve_group(base, 2, poll_sec=0.02)
    scorer = T.LinearScorer(cfg, device=CPU)
    router = T.Router([s.uri for s in servers], scorer, mode=mode,
                      retry_deadline=10.0)
    blocks = [_blk(rng, n=32) for _ in range(4)]
    results, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def load(tid):
        i = tid
        while not stop.is_set():
            try:
                scores, ver = router.predict_block(blocks[i % len(blocks)])
                with lock:
                    results.append((i % len(blocks), scores, ver))
            except Exception as e:
                with lock:
                    errors.append(e)
            i += 3

    threads = [threading.Thread(target=load, args=(t,), daemon=True)
               for t in range(3)]
    try:
        for t in threads:
            t.start()
        for k in (2.0, 3.0, 4.0):
            time.sleep(0.15)
            v = _manifest.write_snapshot_set(
                base, {"w": np.full(cfg.num_buckets, k, np.float32)},
                world=2)
            versions[v] = k
        deadline = time.monotonic() + 10
        while (any(s.version != v for s in servers)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        _close(servers, router)
    assert not errors
    assert {ver for _, _, ver in results} >= {min(versions), max(versions)}
    expected = {}
    for bi, scores, ver in results:
        assert ver in versions, f"reply carries unknown version {ver}"
        if (bi, ver) not in expected:
            packed = scorer.pack(blocks[bi])
            w_full = np.full(cfg.num_buckets, versions[ver], np.float32)
            expected[bi, ver] = scorer.score(
                packed, {"w": w_full[packed.keys["w"]]})
        assert np.array_equal(scores, expected[bi, ver])


# --------------------------------------------------------- backpressure
def test_busy_bounce_is_retried_and_exactly_once(tmp_path):
    """A gate-bounced fetch is resent with the SAME seq after the busy
    backoff, and a replayed seq is answered from the reply cache with
    the ORIGINAL version even after a swap."""
    rng = np.random.default_rng(4)
    cfg = LinearConfig(minibatch=32, num_buckets=1 << 10, nnz_per_row=8)
    base = str(tmp_path / "srv")
    v1 = _manifest.write_snapshot_set(
        base, {"w": np.ones(cfg.num_buckets, np.float32)}, world=1)
    (server,) = _serve_group(base, 1)

    class _BouncyGate:
        def __init__(self, bounces):
            self.bounces = bounces

        def try_enter(self, op=None):
            if self.bounces > 0:
                self.bounces -= 1
                return False
            return True

        def leave(self, op=None, service_s=0.0):
            pass

        def busy_hint_ms(self, base_ms=25.0):
            return 1.0

    router = T.Router([server.uri], T.LinearScorer(cfg, device=CPU),
                      retry_deadline=10.0)
    server._gate = _BouncyGate(2)
    retries0 = _obs.REGISTRY.counter("net.busy.retries").value()
    sock = None
    try:
        scores, ver = router.predict_block(_blk(rng, n=16))
        assert ver == v1
        assert _obs.REGISTRY.counter("net.busy.retries").value() \
            >= retries0 + 2

        host, port = server.uri.rsplit(":", 1)
        sock = _net.connect_with_retry((host, int(port)), 5.0)
        f = sock.makefile("rwb")
        keys = np.arange(4, dtype=np.int64)
        hdr = {"op": "fetch", "tables": ["w"], "sender": "replayer",
               "seq": 7}
        _net.send_frame(f, hdr, {"k:w": keys})
        r1, a1, _ = _net.recv_frame(f)
        v2 = _manifest.write_snapshot_set(
            base, {"w": np.zeros(cfg.num_buckets, np.float32)}, world=1)
        assert server.maybe_swap() and server.version == v2
        dedup0 = _obs.REGISTRY.counter("serve.dedup_hits").value()
        _net.send_frame(f, hdr, {"k:w": keys})
        r2, a2, _ = _net.recv_frame(f)
        assert r2["version"] == r1["version"] == v1
        assert np.array_equal(a1["r:w"], a2["r:w"])
        assert _obs.REGISTRY.counter("serve.dedup_hits").value() \
            == dedup0 + 1
        _net.send_frame(f, dict(hdr, seq=8), {"k:w": keys})
        r3, a3, _ = _net.recv_frame(f)
        assert r3["version"] == v2
        assert np.array_equal(a3["r:w"], np.zeros(4, np.float32))
    finally:
        if sock is not None:
            sock.close()
        router.close()
        server.stop()


# --------------------------------------------------- score-mode fast path
def test_score_mode_micro_batch_coalesces(tmp_path, monkeypatch):
    """Concurrent predicts coalesce into shared score rounds under a
    linger budget, and every member still gets the bit-exact margins
    it would have gotten solo."""
    monkeypatch.setenv("WH_SERVE_BATCH_WAIT_MS", "20")
    rng = np.random.default_rng(5)
    cfg = LinearConfig(minibatch=32, num_buckets=1 << 10, nnz_per_row=8)
    base = str(tmp_path / "srv")
    w = rng.normal(size=cfg.num_buckets).astype(np.float32)
    _manifest.write_snapshot_set(base, {"w": w}, world=2)
    scorer = T.LinearScorer(cfg, device=CPU)
    servers, router = _serve(base, 2, scorer, "score")
    blocks = [_blk(rng, n=24) for _ in range(8)]
    expected = []
    for b in blocks:
        packed = scorer.pack(b)
        expected.append(scorer.score(packed, {"w": w[packed.keys["w"]]}))
    rounds0 = _obs.REGISTRY.counter("serve.batch.rounds").value()
    coal0 = _obs.REGISTRY.counter("serve.batch.coalesced").value()
    results = [None] * len(blocks)

    def one(i):
        results[i], _ = router.predict_block(blocks[i])

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(blocks))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        _close(servers, router)
    for got, exp in zip(results, expected):
        assert got is not None
        assert np.array_equal(got, exp)
    rounds = _obs.REGISTRY.counter("serve.batch.rounds").value() - rounds0
    coalesced = (_obs.REGISTRY.counter("serve.batch.coalesced").value()
                 - coal0)
    assert rounds < len(blocks)
    assert coalesced >= len(blocks) - rounds


def test_score_rpc_replay_is_exactly_once(tmp_path):
    """A retried score frame (same sender+seq) is answered from the
    reply cache with the ORIGINAL partials and version, even after a
    hot swap."""
    cfg = LinearConfig(minibatch=32, num_buckets=1 << 9, nnz_per_row=4)
    base = str(tmp_path / "srv")
    v1 = _manifest.write_snapshot_set(
        base, {"w": np.arange(cfg.num_buckets, dtype=np.float32)}, world=1)
    (server,) = _serve_group(base, 1)
    sock = None
    try:
        host, port = server.uri.rsplit(":", 1)
        sock = _net.connect_with_retry((host, int(port)), 5.0)
        f = sock.makefile("rwb")
        hdr = {"op": "score", "kind": "linear", "rows": 2,
               "sender": "replayer", "seq": 3}
        arrays = {"i": np.asarray([1, 5, 2], np.int32),
                  "v": np.asarray([2.0, 1.0, -1.0], np.float32)}
        _net.send_frame(f, hdr, arrays)
        r1, a1, _ = _net.recv_frame(f)
        assert r1["version"] == v1
        np.testing.assert_array_equal(
            a1["p"], np.asarray([2.0, 5.0, -2.0], np.float32))
        v2 = _manifest.write_snapshot_set(
            base, {"w": np.zeros(cfg.num_buckets, np.float32)}, world=1)
        assert server.maybe_swap() and server.version == v2
        dedup0 = _obs.REGISTRY.counter("serve.dedup_hits").value()
        _net.send_frame(f, hdr, arrays)
        r2, a2, _ = _net.recv_frame(f)
        assert r2["version"] == v1
        np.testing.assert_array_equal(a1["p"], a2["p"])
        assert _obs.REGISTRY.counter("serve.dedup_hits").value() \
            == dedup0 + 1
        _net.send_frame(f, dict(hdr, seq=4), arrays)
        r3, a3, _ = _net.recv_frame(f)
        assert r3["version"] == v2
        np.testing.assert_array_equal(a3["p"], np.zeros(3, np.float32))
    finally:
        if sock is not None:
            sock.close()
        server.stop()


# ------------------------------------------------------ parity with JAX
def _model(name, rng):
    """(port cfg, JAX cfg, tables) of one small model."""
    if name == "linear":
        kw = dict(minibatch=48, num_buckets=1 << 11, nnz_per_row=12)
        return (LinearConfig(**kw), JLinearConfig(**kw),
                {"w": rng.normal(size=kw["num_buckets"]).astype(np.float32)})
    cfg, tables = _difacto(rng, v_buckets=1 << 9)
    kw = dict(minibatch=cfg.minibatch, num_buckets=cfg.num_buckets,
              nnz_per_row=cfg.nnz_per_row, dim=cfg.dim,
              threshold=cfg.threshold, v_buckets=cfg.v_buckets)
    return cfg, JDifactoConfig(**kw), tables


def _scorers(name, cfg, jcfg):
    if name == "linear":
        return T.LinearScorer(cfg, device=CPU), J.LinearScorer(jcfg)
    return T.DifactoScorer(cfg, device=CPU), J.DifactoScorer(jcfg)


def _hold(name, got, want):
    if name == "linear":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **FM_TOL)


@pytest.mark.parametrize("name", ["linear", "difacto"])
def test_scorer_margins_match_jax(name):
    """The scorers' margins on full-table rows, without shards: the
    port's plain torch margin against the JAX jitted segment_sum."""
    rng = np.random.default_rng(12)
    cfg, jcfg, tables = _model(name, rng)
    ts, js = _scorers(name, cfg, jcfg)
    for n in (1, 17, 48, 60):
        blk = _blk(rng, n=n)
        tp, jp = ts.pack(blk), js.pack(blk)
        for k in tp.keys:
            assert np.array_equal(tp.keys[k], jp.keys[k])
        rows = {t: tables[t][tp.keys[t]] for t in ts.tables}
        _hold(name, ts.score(tp, rows), js.score(jp, rows))
        assert tscoring._H2D_S.count > 0


@pytest.mark.parametrize("mode", ["fetch", "score"])
@pytest.mark.parametrize("name", ["linear", "difacto"])
def test_jax_and_port_tiers_agree(tmp_path, name, mode):
    """One snapshot, served by a JAX group through a JAX router and by a
    port group through a port router."""
    rng = np.random.default_rng(13)
    cfg, jcfg, tables = _model(name, rng)
    base = str(tmp_path / "srv")
    _manifest.write_snapshot_set(base, tables, world=2)
    ts, js = _scorers(name, cfg, jcfg)
    blks = [_blk(rng, n=n) for n in (40, 48)]
    got = {}
    for pkg, scorer in ((T, ts), (J, js)):
        servers, router = _serve(base, 2, scorer, mode, pkg, pkg)
        try:
            got[pkg] = [router.predict_block(b) for b in blks]
        finally:
            _close(servers, router)
    for (ps, pv), (jsc, jv) in zip(got[T], got[J]):
        assert pv == jv
        _hold(name, ps, jsc)


@pytest.mark.parametrize("mode", ["fetch", "score"])
@pytest.mark.parametrize("name", ["linear", "difacto"])
@pytest.mark.parametrize("router_pkg", ["port", "jax"])
def test_mixed_groups_answer_like_one_package(tmp_path, router_pkg, name,
                                              mode):
    """A port router over JAX shards, and a JAX router over port shards,
    give the scores a group from one package gives."""
    rng = np.random.default_rng(14)
    cfg, jcfg, tables = _model(name, rng)
    base = str(tmp_path / "srv")
    _manifest.write_snapshot_set(base, tables, world=3)
    ts, js = _scorers(name, cfg, jcfg)
    rpkg, spkg, scorer = ((T, J, ts) if router_pkg == "port"
                          else (J, T, js))
    blk = _blk(rng, n=45)
    servers, router = _serve(base, 3, scorer, mode, spkg, rpkg)
    try:
        mixed, mv = router.predict_block(blk)
    finally:
        _close(servers, router)
    servers, router = _serve(base, 3, scorer, mode, rpkg, rpkg)
    try:
        pure, pv = router.predict_block(blk)
    finally:
        _close(servers, router)
    assert mv == pv
    assert np.array_equal(mixed, pure)
