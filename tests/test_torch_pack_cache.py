"""The port's loader plane against the JAX package's: the epoch pack cache
(data/pack_cache.py), the learners' cache keys, LoaderController,
ThreadedParser, the solver's knobs and stage timers, and obs.metrics.

The same numpy inputs, made from a seed, go through both packages. Bars:
cache stats equal to the JAX PackCache's on the same put/get sequence;
controller decisions equal; prepared batches equal to the JAX package's
byte for byte and unchanged by a round trip through the disk tier;
cache-on runs equal to cache-off runs exactly on the CPU (k-means over 3
iterations, the linear solver over 3 passes), and k-means within
tests/test_torch_kmeans.py's atol 1e-5 of the JAX learner with its cache
on, with equal hit and miss counts.
"""

import hashlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import synth_libsvm_text
from test_bsp import _cluster_data
from wormhole_tpu.data import pack_cache as jpc
from wormhole_tpu.data.rowblock import RowBlock as JRowBlock
from wormhole_tpu.models.difacto import DifactoConfig as JDConfig
from wormhole_tpu.models.difacto import DifactoLearner as JDLearner
from wormhole_tpu.models.kmeans import KmeansConfig as JKConfig
from wormhole_tpu.models.kmeans import KmeansLearner as JKLearner
from wormhole_tpu.models.linear import LinearConfig as JLConfig
from wormhole_tpu.models.linear import LinearLearner as JLLearner
from wormhole_tpu.obs import metrics as jm
from wormhole_tpu.parallel.mesh import make_mesh
from wormhole_tpu.solver.minibatch_solver import (
    LoaderController as JController)
from wormhole_tpu.solver.minibatch_solver import (
    MinibatchSolver as JSolver)
from wormhole_tpu_torch import interop
from wormhole_tpu_torch.data import pack_cache as tpc
from wormhole_tpu_torch.data.minibatch import MinibatchIter, ThreadedParser
from wormhole_tpu_torch.data.rowblock import RowBlock
from wormhole_tpu_torch.models.difacto import DifactoConfig, DifactoLearner
from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner
from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
from wormhole_tpu_torch.obs import metrics as tm
from wormhole_tpu_torch.obs.metrics import REGISTRY
from wormhole_tpu_torch.ops.coo_kernels import TILE
from wormhole_tpu_torch.solver.minibatch_solver import (LoaderController,
                                                        MinibatchSolver)

KNOBS = ("WH_PACK_CACHE", "WH_PACK_CACHE_DIR", "WH_PACK_CACHE_MB",
         "WH_NUM_LOADERS")


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _flat(pc, obj):
    """(skeleton with classes by name, leaves as numpy) of a batch."""
    leaves = []
    skel = pc._flatten(obj, leaves)

    def names(s):
        if isinstance(s, type):
            return s.__name__
        if isinstance(s, (tuple, list)):
            return type(s)(names(x) for x in s)
        return s

    return names(skel), [np.asarray(a) for a in leaves]


def _assert_same_leaves(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        x, y = np.asarray(x), np.asarray(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape)
        assert x.tobytes() == y.tobytes()


def _assert_same_batch(pc_a, a, pc_b, b):
    """Same skeleton (classes by name), same leaves byte for byte."""
    sa, la = _flat(pc_a, a)
    sb, lb = _flat(pc_b, b)
    assert repr(sa) == repr(sb)
    _assert_same_leaves(la, lb)


def _disk_round_trip(obj, tmp_path):
    cache = tpc.PackCache(mem_bytes=1 << 26, disk_dir=str(tmp_path))
    assert cache.put("k", obj)
    cache.clear_memory()  # force the disk tier
    got = cache.get("k")
    assert cache.disk_hits == 1
    _assert_same_batch(tpc, obj, tpc, got)
    return got


# ------------------------------------------------------------ fingerprint
@pytest.mark.parametrize("parts", [
    ("a", 1, (2, 3)), ("kmeans", 1, "packed", 784, None, (10, 20), 0.5),
    (("train", ("linear", 1, True, 0)), "n"), ()])
def test_fingerprint_and_stamp_match_jax(parts, tmp_path):
    assert tpc.fingerprint(*parts) == jpc.fingerprint(*parts)
    p = tmp_path / "f"
    p.write_text("x")
    assert tpc.file_stamp(str(p)) == jpc.file_stamp(str(p))
    assert tpc.file_stamp(str(tmp_path / "missing")) == (None, None)


# ------------------------------------------------ the cache against JAX's
def _lru(pc, d):
    mk = lambda: np.zeros(1000, dtype=np.float64)  # noqa: E731
    cache = pc.PackCache(mem_bytes=3 * 8512)
    for k in "abc":
        cache.put(k, mk())
    assert cache.get("a") is not None  # refresh a: b is now LRU
    cache.put("d", mk())
    got = [cache.get(k) is None for k in "badc"]
    assert got == [True, False, False, False]
    return got, cache.stats()


def _oversize(pc, d):
    cache = pc.PackCache(mem_bytes=100, disk_dir=d)
    assert cache.put("big", np.arange(1000.0))
    assert cache.stats()["mem_entries"] == 0
    got = cache.get("big")  # served by the disk tier
    assert np.asarray(got).tobytes() == np.arange(1000.0).tobytes()
    return cache.stats()


def _damaged(how):
    def run(pc, d):
        cache = pc.PackCache(mem_bytes=1 << 20, disk_dir=d)
        cache.put("k", {"x": np.arange(1000), "meta": 3})
        cache.clear_memory()
        (path,) = [os.path.join(d, f) for f in os.listdir(d)]
        with open(path, "r+b") as fh:
            if how == "magic":
                fh.write(b"GARBAGE!")
            else:
                fh.truncate(os.path.getsize(path) - 100)
        assert cache.get("k") is None
        assert not os.path.exists(path)  # dropped, to be packed again
        return cache.stats()
    return run


def _promote(pc, d):
    cache = pc.PackCache(mem_bytes=1 << 20, disk_dir=d)
    cache.put("k", np.arange(10))
    cache.clear_memory()
    assert cache.get("k") is not None and cache.disk_hits == 1
    assert cache.get("k") is not None and cache.disk_hits == 1  # memory
    return cache.stats()


def _uncacheable(pc, d):
    cache = pc.PackCache(mem_bytes=1 << 20, disk_dir=d)
    assert cache.put("k", {"bad": {1, 2, 3}}) is False
    assert cache.get("k") is None and not os.listdir(d)
    return cache.stats()


SCENARIOS = {"lru": _lru, "oversize": _oversize,
             "corrupt": _damaged("magic"), "truncated": _damaged("truncate"),
             "promote": _promote, "uncacheable": _uncacheable}


@pytest.mark.parametrize("name", SCENARIOS)
def test_cache_matches_jax(name, tmp_path):
    outs = []
    for pc in (tpc, jpc):
        d = tmp_path / pc.__name__
        d.mkdir()
        outs.append(SCENARIOS[name](pc, str(d)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("pc", [tpc, jpc], ids=["port", "jax"])
def test_concurrent_get_put(pc):
    """8 threads (more than this box's share of cores) get and put 37 keys
    under a short switch interval: every hit is its key's value, and hits
    plus misses count every get, in both packages."""
    cache = pc.PackCache(mem_bytes=4 << 20)
    errs = []

    def worker(w):
        try:
            rng = np.random.default_rng(w)
            for i in range(200):
                k = f"k{i % 37}"
                got = cache.get(k)
                if got is not None:
                    assert int(np.asarray(got)[0]) == i % 37
                else:
                    cache.put(k, np.full(64, i % 37, dtype=np.int64))
                if rng.random() < 0.02:
                    cache.clear_memory()
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert not errs
    st = cache.stats()
    assert st["hits"] + st["misses"] == 8 * 200
    assert st["mem_bytes"] == st["mem_entries"] * (64 * 8 + 512)


# ----------------------------------------------------- whole-part replay
def _replay(pc, gap: bool):
    cache = pc.PackCache(mem_bytes=16 << 20)
    opened, prepared = [], []

    def raw():
        opened.append(1)
        return iter([np.full(8, i) for i in range(5)])

    def prep(b):
        prepared.append(int(b[0]))
        return b * 2

    key = ("part", 0)
    cold = list(pc.iter_part_cached(cache, key, raw, prep))
    assert len(cold) == 5 and len(opened) == 1 and prepared == list(range(5))
    if gap:  # knock out batch 2: 0-1 replay, 2-4 are packed again
        assert cache._mem.pop(pc.fingerprint(key, 2)) is not None
    prepared.clear()
    warm = list(pc.iter_part_cached(cache, key, raw, prep))
    assert len(warm) == 5
    for c, w in zip(cold, warm):
        assert c.tobytes() == w.tobytes()
    log = [len(opened), list(prepared)]
    prepared.clear()
    list(pc.iter_part_cached(cache, key, raw, prep))  # healed
    return log + [len(opened), list(prepared), cache.stats()]


@pytest.mark.parametrize("gap", [False, True], ids=["replay", "gap"])
def test_iter_part_cached_matches_jax(gap):
    got = _replay(tpc, gap)
    assert got == _replay(jpc, gap)
    if gap:
        assert got[:4] == [2, [2, 3, 4], 2, []]
    else:  # the source is never opened again
        assert got[:4] == [1, [], 1, []]


def test_iter_part_cached_none_is_the_plain_loop():
    for cache, key in ((None, ("k",)), (tpc.PackCache(), None)):
        out = list(tpc.iter_part_cached(cache, key, lambda: iter([1, 2]),
                                        lambda b: b + 1))
        assert out == [2, 3]


def test_from_env_off_by_default_and_reads_the_jax_knobs(monkeypatch,
                                                         tmp_path):
    assert tpc.from_env() is None and jpc.from_env() is None
    for env in ({"WH_PACK_CACHE": "1", "WH_PACK_CACHE_MB": "7"},
                {"WH_PACK_CACHE": "off", "WH_PACK_CACHE_DIR": str(tmp_path)}):
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        t, j = tpc.from_env(), jpc.from_env()
        assert (t.mem_bytes, t.disk_dir) == (j.mem_bytes, j.disk_dir)
    monkeypatch.setenv("WH_PACK_CACHE", "0")
    monkeypatch.delenv("WH_PACK_CACHE_DIR")
    assert tpc.from_env() is None


def test_tensor_leaves_round_trip_through_disk(tmp_path):
    g = torch.Generator().manual_seed(3)
    obj = {"f": torch.rand(3, 5, generator=g),
           "i": (torch.arange(-7, 9, dtype=torch.int64),
                 np.arange(5, dtype=np.int32)),
           "b": torch.tensor([True, False, True]),
           "h": torch.rand(4, generator=g).to(torch.float16),
           "empty": torch.zeros(0, 2)}
    want = sum(t.numel() * t.element_size() for t in
               (obj["f"], obj["i"][0], obj["b"], obj["h"])) + 20 + 512
    assert tpc.nbytes_of(obj) == want
    cache = tpc.PackCache(mem_bytes=1 << 20, disk_dir=str(tmp_path))
    assert cache.put("k", obj)
    assert cache.get("k") is obj  # the memory tier keeps the object
    cache.clear_memory()
    got = cache.get("k")
    assert cache.disk_hits == 1
    for a, b in ((obj["f"], got["f"]), (obj["i"][0], got["i"][0]),
                 (obj["b"], got["b"]), (obj["h"], got["h"]),
                 (obj["empty"], got["empty"])):
        assert isinstance(b, np.ndarray) and b.flags.writeable
        assert (b.dtype, b.shape) == (a.numpy().dtype, a.numpy().shape)
        assert b.tobytes() == a.numpy().tobytes()
    # a copy-on-write map: writing a replayed leaf never reaches the file
    got["f"][0, 0] = -1.0
    cache.clear_memory()
    assert cache.get("k")["f"].tobytes() == obj["f"].numpy().tobytes()


def test_bf16_leaf_stays_in_memory_only(tmp_path):
    obj = (torch.ones(4, dtype=torch.bfloat16),)
    cache = tpc.PackCache(mem_bytes=1 << 20, disk_dir=str(tmp_path))
    assert cache.put("k", obj) and cache.get("k") is obj
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".whpack")]


# ------------------------------------ the learners' packs against JAX's
def _rowblocks(n_rows, nnz, num_buckets, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, num_buckets, size=n_rows * nnz).astype(np.uint64)
    arrays = ((rng.random(n_rows) < 0.5).astype(np.float32),
              np.arange(n_rows + 1, dtype=np.int64) * nnz, idx,
              rng.random(n_rows * nnz).astype(np.float32))
    return JRowBlock(*arrays), RowBlock(*arrays)


LIN = dict(minibatch=128, num_buckets=8 * TILE, nnz_per_row=16,
           kernel="pallas")
FM = dict(minibatch=256, num_buckets=2 * TILE, v_buckets=TILE,
          nnz_per_row=13, dim=4, threshold=1, kernel_dtype="f32")


@pytest.mark.parametrize("case", ["linear-coo", "linear-tcoo", "linear-xla",
                                  "difacto-fm-eval", "difacto-xla"])
def test_learner_pack_round_trips_and_equals_jax(case, tmp_path):
    model, kind = case.split("-", 1)
    if model == "linear":
        kw = dict(LIN, compact_cap=TILE if kind == "tcoo" else 0,
                  kernel="xla" if kind == "xla" else "pallas")
        j = JLLearner(JLConfig(**kw), make_mesh(1, 1))
        t = LinearLearner(LinearConfig(**kw), device="cpu")
        bj, bt = _rowblocks(128, 8, kw["num_buckets"], seed=1)
        pj, pt = j.prepare_batch(bj), t.prepare_batch(bt)
        assert pt[0] == kind
        assert t.pack_cache_token() is not None
    else:
        kw = dict(FM, kernel="xla" if kind == "xla" else "pallas")
        j = JDLearner(JDConfig(**kw), make_mesh(1, 1))
        t = DifactoLearner(DifactoConfig(**kw), device="cpu")
        for seed in (2, 3):  # train: the slot caps and the count mirror
            bj, bt = _rowblocks(256, 13, kw["num_buckets"], seed)
            j.train_batch(bj)
            t.train_batch(bt)
        # the JAX token names the mirror by its pass epoch, the port's by
        # a digest of the mirror's bytes
        tt, tj = t.pack_cache_token(False), j.pack_cache_token(False)
        if kind == "xla":
            assert tt == tj
        else:
            assert tt[:11] + tt[12:] == tj[:11] + tj[12:]
            assert tt[11] == _mirror_digest(t)
        assert (t.pack_cache_token(True) is None) == (kind != "xla")
        pj, pt = j.prepare_batch(bj, train=False), \
            t.prepare_batch(bt, train=False)
    got = _disk_round_trip(pt, tmp_path)
    if case == "difacto-fm-eval":
        # the JAX learner's eval pack is its step's argument list
        _assert_same_leaves(
            DifactoLearner._fm_args(got[1], got[2], got[3], False), pj[1])
        assert (got[0], got[4]) == (pj[0], pj[2])
    else:
        _assert_same_batch(tpc, got, jpc, pj)


def test_linear_token_waits_for_the_compact_decision():
    kw = dict(LIN, compact_cap=-1)
    j = JLLearner(JLConfig(**kw), make_mesh(1, 1))
    t = LinearLearner(LinearConfig(**kw), device="cpu")
    assert t.pack_cache_token() is None and j.pack_cache_token() is None
    bj, bt = _rowblocks(128, 8, kw["num_buckets"], seed=4)
    j.prepare_batch(bj)
    t.prepare_batch(bt)
    assert t.pack_cache_token() is not None
    # the port's token is the JAX one without its mesh fields (one device)
    tj = j.pack_cache_token()
    assert t.pack_cache_token() == tj[:3] + tj[4:5] + tj[6:9] + tj[11:]


def _mirror_digest(lrn):
    return hashlib.blake2b(lrn._cnt_host.tobytes(),
                           digest_size=16).hexdigest()


def test_difacto_pack_epoch_moves_with_the_mirror():
    """The compact eval token follows the count mirror's contents: it
    moves when counts move, and a resync that moves no count keeps it."""
    t = DifactoLearner(DifactoConfig(**dict(FM, kernel="pallas")),
                       device="cpu")
    assert t.pack_cache_token(False) is None  # slot caps not sized yet
    t.train_batch(_rowblocks(256, 13, FM["num_buckets"], seed=2)[1])
    tok = t.pack_cache_token(False)
    t.on_pass_start()
    assert t.pack_cache_token(False) == tok
    t.train_batch(_rowblocks(256, 13, FM["num_buckets"], seed=3)[1])
    t.on_pass_start()
    assert t.pack_cache_token(False) != tok
    assert t.pack_cache_token(False)[11] == _mirror_digest(t)


def test_difacto_eval_entries_follow_the_mirror_across_runs(tmp_path,
                                                            monkeypatch):
    """Runs that share the disk tier replay each other's eval packs only
    where their count mirrors agree: b counts more batches than a, with
    the same slot caps, and must pack its own admissions."""
    (tmp_path / "val.libsvm").write_text(synth_libsvm_text(
        n_rows=512, n_feat=300, nnz_per_row=8, seed=5))
    val = str(tmp_path / r"val\.libsvm")
    kw = dict(FM, kernel="pallas", num_parts_per_file=1)
    monkeypatch.setenv("WH_NUM_LOADERS", "1")

    def eval_pass(seeds, cache_dir):
        lrn = DifactoLearner(DifactoConfig(**kw), device="cpu")
        for seed in seeds:
            lrn.train_batch(_rowblocks(256, 13, FM["num_buckets"], seed)[1])
        if cache_dir:
            monkeypatch.setenv("WH_PACK_CACHE_DIR", cache_dir)
        else:
            monkeypatch.delenv("WH_PACK_CACHE_DIR", raising=False)
        sol = MinibatchSolver(lrn, DifactoConfig(**kw), verbose=False)
        prog = sol.iterate(val, False)
        return prog.tot, lrn._fm_caps, sol.pack_cache

    shared = str(tmp_path / "packs")
    got_a, caps_a, _ = eval_pass((2,), shared)
    got_b, caps_b, cache_b = eval_pass((2, 3), shared)
    want_b, _, _ = eval_pass((2, 3), "")
    assert caps_a == caps_b
    assert got_a != want_b  # the mirrors admit differently
    st = cache_b.stats()
    assert st["disk_hits"] == st["hits"] == 0
    assert got_b == want_b
    # a run with a's mirror replays a's entries from disk: 2 batches and
    # the part's count entry
    again, _, cache_a2 = eval_pass((2,), shared)
    st = cache_a2.stats()
    assert st["disk_hits"] == st["hits"] == 3 and st["misses"] == 0
    assert again == got_a


# ------------------------------------------------------------- k-means
def _kmeans(pkg, path, **over):
    kw = dict(train_data=path, num_clusters=3, dim=16, minibatch=256,
              nnz_per_row=16, seed=2, max_iter=3)
    kw.update(over)
    if pkg == "jax":
        return JKLearner(JKConfig(**kw), make_mesh(1, 1))
    return KmeansLearner(KmeansConfig(**kw), device="cpu")


def test_kmeans_packed_entry_round_trips_and_equals_jax(tmp_path):
    path, _, _ = _cluster_data(tmp_path, seed=7)
    j, t = _kmeans("jax", path), _kmeans("port", path)
    assert t._use_packed
    bt = next(iter(MinibatchIter(path, minibatch_size=256)))
    bj = JRowBlock(bt.label, bt.offset, bt.index, bt.value)
    entries = []
    for lrn, blk in ((t, bt), (j, bj)):
        db = lrn._prep_db(blk)
        entries.append((lrn.pack_batch(db.seg, db.idx, db.val),
                        db.row_mask))
    got = _disk_round_trip(entries[0], tmp_path / "c")
    _assert_same_batch(tpc, got, jpc, entries[1])


@pytest.mark.parametrize("assign", ["dense", "sparse"],
                         ids=["packed", "sparse"])
def test_kmeans_cached_run_equals_uncached_and_jax(tmp_path, monkeypatch,
                                                   assign):
    """Three Lloyd iterations: cache on equals cache off exactly, and the
    JAX learner with its cache on (both from its init) within atol 1e-5,
    with equal cache stats."""
    path, _, _ = _cluster_data(tmp_path, seed=7)
    off = _kmeans("port", path, assign_kernel=assign)
    assert off.pack_cache is None
    off.run(verbose=False)
    monkeypatch.setenv("WH_PACK_CACHE", "1")
    on = _kmeans("port", path, assign_kernel=assign)
    j = _kmeans("jax", path, assign_kernel=assign)
    on.run(verbose=False)
    assert torch.equal(on.centroids, off.centroids)
    st = on.pack_cache.stats()
    # iterations 2-3 replay every batch: 5 a part (4 full, 1 short)
    assert st["hits"] >= 2 * 5 and st["disk_hits"] == 0
    j.init_centroids()
    t = _kmeans("port", path, assign_kernel=assign)
    t.init_centroids()
    t.centroids = interop.kmeans_state_from_numpy(
        np.asarray(j.centroids), t.cfg, "cpu")
    cj, ct = j.run(verbose=False), t.run(verbose=False)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=0, atol=1e-5)
    assert abs(ct - cj) < 1e-5
    assert t.pack_cache.stats() == j.pack_cache.stats()


def test_kmeans_disk_tier_serves_a_new_learner(tmp_path, monkeypatch):
    path, _, _ = _cluster_data(tmp_path, seed=7)
    monkeypatch.setenv("WH_PACK_CACHE_DIR", str(tmp_path / "cache"))
    first = _kmeans("port", path, max_iter=1)
    first.run(verbose=False)
    second = _kmeans("port", path, max_iter=1)
    second.centroids = first.centroids.clone()
    second.run(verbose=False)
    # five batches and the part's count entry, all from disk
    st = second.pack_cache.stats()
    assert st["disk_hits"] == st["hits"] == 6 and st["misses"] == 0


def test_no_knob_means_no_cache_object(tmp_path):
    path, _, _ = _cluster_data(tmp_path, seed=7)
    assert _kmeans("port", path).pack_cache is None
    cfg = LinearConfig(train_data=path, **LIN)
    sol = MinibatchSolver(LinearLearner(cfg, device="cpu"), cfg,
                          verbose=False)
    assert sol.pack_cache is None
    assert sol.controller is not None and sol.controller.n == 4


# --------------------------------------------------------------- solver
@pytest.fixture(scope="module")
def part_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpc_data")
    for i in range(2):
        (d / f"train-{i}.libsvm").write_text(synth_libsvm_text(
            n_rows=400, n_feat=200, nnz_per_row=10, seed=i))
    return d


def _solver_kw(d, **over):
    kw = dict(train_data=str(d / r"train-.*\.libsvm"), minibatch=128,
              num_buckets=8 * TILE, nnz_per_row=16, lr_eta=0.5,
              lambda_l1=0.5, kernel="pallas", kernel_dtype="f32",
              max_data_pass=3, num_parts_per_file=2)
    kw.update(over)
    return kw


def _stage_counts():
    return {k: REGISTRY.histogram(f"train.stage.{k}_s").count
            for k in ("load", "pack", "h2d", "step", "metrics", "total")}


@pytest.mark.parametrize("case", [dict(compact_cap=0),
                                  dict(compact_cap=TILE),
                                  dict(compact_cap=-1),
                                  dict(kernel="xla")],
                         ids=["coo", "tcoo", "auto", "xla"])
def test_linear_solver_cache_equals_uncached(part_files, monkeypatch, case):
    """Three passes over 2 files x 2 parts with one loader: the tables
    exact with the cache on and off, stats equal to the JAX solver's,
    and every train step observed by the stage timers."""
    monkeypatch.setenv("WH_NUM_LOADERS", "1")
    kw = _solver_kw(part_files, **case)
    cfg = LinearConfig(**kw)
    off = LinearLearner(cfg, device="cpu")
    MinibatchSolver(off, cfg, verbose=False).run()
    monkeypatch.setenv("WH_PACK_CACHE", "1")
    on = LinearLearner(cfg, device="cpu")
    sol = MinibatchSolver(on, cfg, verbose=False)
    assert sol.controller is None and sol.num_loaders == 1
    before = _stage_counts()
    sol.run()
    after = _stage_counts()
    for k, v in off.store.to_numpy().items():
        np.testing.assert_array_equal(on.store.to_numpy()[k], v)
    steps = 3 * 2 * 2 * 2  # passes x files x parts x batches
    # a cold pass misses each part's count entry once; a warm one hits it
    # and the part's 2 batches
    for k in ("load", "h2d", "step", "metrics", "total"):
        assert after[k] - before[k] == steps
    packs = after["pack"] - before["pack"]
    st = sol.pack_cache.stats()
    jcfg = JLConfig(**kw)
    jsol = JSolver(JLLearner(jcfg, make_mesh(1, 1)), jcfg, verbose=False)
    jsol.run()
    assert st == jsol.pack_cache.stats()
    if case.get("compact_cap", 0):
        # the compact decision waits for the first batch, so pass 1 packs
        # uncached, pass 2 fills the cache and pass 3 replays it
        assert (st["misses"], st["hits"]) == (4, 12)
        assert packs == 2 * steps // 3
    else:
        assert (st["misses"], st["hits"]) == (4, 24)
        assert packs == steps // 3


@pytest.mark.parametrize("draw", [dict(rand_shuffle=1),
                                  dict(neg_sampling=0.5)],
                         ids=["shuffle", "neg-sampling"])
def test_drawn_train_passes_decline_the_cache(part_files, monkeypatch,
                                              draw):
    """Shuffle and negative sampling draw anew every pass: a train pass
    with either never touches the cache; its eval pass still caches."""
    monkeypatch.setenv("WH_PACK_CACHE", "1")
    kw = _solver_kw(part_files, compact_cap=0, max_data_pass=1,
                    val_data=_solver_kw(part_files)["train_data"], **draw)
    sol = MinibatchSolver(LinearLearner(LinearConfig(**kw), device="cpu"),
                          LinearConfig(**kw), verbose=False)
    assert sol._pass_cache_token(True) is None
    assert sol._pass_cache_token(False) is not None
    sol.iterate(kw["train_data"], True)
    assert sol.pack_cache.stats() == tpc.PackCache().stats()
    sol.iterate(kw["train_data"], False)
    assert sol.pack_cache.stats()["misses"] == 4


def test_linear_app_cache_equals_uncached(part_files, tmp_path,
                                         monkeypatch):
    """The linear app, 3 passes with train and val data: the model files
    with the cache on equal those with it off, byte for byte."""
    from wormhole_tpu_torch.apps import linear as app
    from wormhole_tpu_torch.utils.checkpoint import load_parts

    monkeypatch.setenv("WH_NUM_LOADERS", "1")
    models = []
    for cache in ("", "1"):
        monkeypatch.setenv("WH_PACK_CACHE", cache)
        out = str(tmp_path / f"model{cache}")
        assert app.main([f"train_data={part_files}/train-0\\.libsvm",
                         f"val_data={part_files}/train-1\\.libsvm",
                         "minibatch=128", f"num_buckets={8 * TILE}",
                         "nnz_per_row=16", "kernel=pallas",
                         "compact_cap=0", "max_data_pass=3",
                         "device=cpu", f"model_out={out}"]) == 0
        models.append(load_parts(out))
    for k, v in models[0].items():
        assert v.tobytes() == models[1][k].tobytes()


def test_difacto_train_pack_declines_the_cache(tmp_path, monkeypatch):
    """A compact FM train pass with the cache on makes no entry and equals
    the uncached pass exactly; the xla kind caches its train packs."""
    (tmp_path / "fm.libsvm").write_text(synth_libsvm_text(
        n_rows=768, n_feat=300, nnz_per_row=8, seed=4))
    kw = dict(FM, train_data=str(tmp_path / r"fm\.libsvm"), max_data_pass=2,
              num_parts_per_file=2, kernel="pallas")
    monkeypatch.setenv("WH_NUM_LOADERS", "1")
    tables = []
    for cache in ("", "1"):
        monkeypatch.setenv("WH_PACK_CACHE", cache)
        lrn = DifactoLearner(DifactoConfig(**kw), device="cpu")
        sol = MinibatchSolver(lrn, DifactoConfig(**kw), verbose=False)
        sol.run()
        tables.append(lrn.ckpt_store.to_numpy())
    assert sol.pack_cache.stats() == tpc.PackCache().stats()  # untouched
    for k, v in tables[0].items():
        np.testing.assert_array_equal(tables[1][k], v)
    kw["kernel"] = "xla"
    sol = MinibatchSolver(DifactoLearner(DifactoConfig(**kw), device="cpu"),
                          DifactoConfig(**kw), verbose=False)
    sol.run()
    assert sol.pack_cache.stats()["hits"] == 2 * 2 + 2  # batches + counts


def test_loader_knobs(part_files, monkeypatch):
    cfg = LinearConfig(**_solver_kw(part_files))
    lrn = LinearLearner(cfg, device="cpu")
    jcfg = JLConfig(**_solver_kw(part_files))
    jl = JLLearner(jcfg, make_mesh(1, 1))
    # unpinned: cfg.max_concurrency loaders, sized by the controller
    t = MinibatchSolver(lrn, cfg, verbose=False)
    j = JSolver(jl, jcfg, verbose=False)
    assert t.num_loaders == j.num_loaders == cfg.max_concurrency
    assert t.controller.n == j.controller.n == cfg.max_concurrency
    # WH_NUM_LOADERS pins the count and turns the controller off
    monkeypatch.setenv("WH_NUM_LOADERS", "5")
    t = MinibatchSolver(lrn, cfg, verbose=False)
    j = JSolver(jl, jcfg, verbose=False)
    assert t.num_loaders == j.num_loaders == 5
    assert t.controller is None and j.controller is None
    t.iterate(cfg.train_data, True)  # five loaders, staging their batches
    assert lrn.nnz() > 0


# ---------------------------------------------------- loader controller
CONTROLLER_CASES = {
    "grow": ((2, {"hi": 16}), [(3.0, 10.0, 50, 0.0)]),
    "grow-by-two": ((2, {"hi": 16}), [(6.0, 10.0, 50, 0.0)]),
    "shrink-only-when-full": ((4, {"hi": 16}), [(0.0, 10.0, 50, 0.1),
                                                (0.0, 10.0, 50, 0.9)]),
    "short-passes-and-bounds": ((1, {"lo": 1, "hi": 2}),
                                [(9.0, 10.0, 2, 0.0), (9.0, 10.0, 50, 0.0),
                                 (9.0, 10.0, 50, 0.0),
                                 (0.0, 10.0, 50, 1.0), (0.0, 10.0, 50, 1.0)]),
}
CONTROLLER_SIZES = {"grow": [3], "grow-by-two": [4],
                    "shrink-only-when-full": [4, 3],
                    "short-passes-and-bounds": [1, 2, 2, 1, 1]}


@pytest.mark.parametrize("name", CONTROLLER_CASES)
def test_controller_decides_as_jax(name):
    (initial, kw), passes = CONTROLLER_CASES[name]
    t, j = LoaderController(initial, **kw), JController(initial, **kw)
    sizes = [t.record_pass(*p) for p in passes]
    assert sizes == [j.record_pass(*p) for p in passes]
    assert sizes == CONTROLLER_SIZES[name]
    assert t.decisions == j.decisions
    assert LoaderController(3).hi == JController(3).hi


# ------------------------------------------------------- threaded parser
def test_threaded_parser_relays_a_midstream_error():
    def src():
        yield np.arange(4)
        yield np.arange(4)
        raise RuntimeError("parser died mid-stream")

    it = iter(ThreadedParser(src()))
    assert next(it) is not None and next(it) is not None
    with pytest.raises(RuntimeError, match="mid-stream"):
        next(it)


def test_threaded_parser_ends_the_stream():
    assert list(ThreadedParser(iter(range(10)))) == list(range(10))


def test_minibatch_iter_raises_a_parse_error(tmp_path):
    p = tmp_path / "bad.libsvm"
    p.write_text("1 5:1.0\n0 not_a_feature\n")
    with pytest.raises(ValueError):
        list(MinibatchIter(str(p), minibatch_size=4))


def test_prefetch_gives_the_same_batches(tmp_path):
    p = tmp_path / "d.libsvm"
    p.write_text(synth_libsvm_text(n_rows=700, seed=3))
    got = [list(MinibatchIter(str(p), minibatch_size=128, shuf_buf=256,
                              neg_sampling=0.7, seed=5, prefetch=pf))
           for pf in (True, False)]
    assert len(got[0]) == len(got[1]) > 1
    for a, b in zip(*got):
        _assert_same_batch(tpc, a, tpc, b)


# ----------------------------------------------------------- obs.metrics
def _observe(m):
    reg = m.Registry()
    rng = np.random.default_rng(0)
    for i in range(3):
        reg.counter("pack_cache.hits").inc(i)
    reg.gauge("queue.depth").set(5)
    reg.gauge("queue.depth").set(2.5)
    for v in rng.random(700):
        reg.histogram("train.stage.load_s").observe(float(v))
    reg.histogram("small", reservoir=8).observe(1.0)
    return reg.snapshot()


def test_metrics_snapshot_matches_jax():
    t, j = _observe(tm), _observe(jm)
    assert t == j
    assert t["hists"]["train.stage.load_s"]["count"] == 700
    assert len(t["hists"]["train.stage.load_s"]["res"]) == 256
    assert tm.merge_snapshots([t, t, None]) == \
        jm.merge_snapshots([j, j, None])
