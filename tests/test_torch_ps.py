"""The port's parameter-server plane in one process: the counterparts of
tests/test_ps_server.py, tests/test_ps_async.py, the journal and
scheduler cases of tests/test_sched_ha.py and the MembershipController
cases of tests/test_elastic.py, run against the port's modules and,
where a server or a scheduler answers a client, across the packages: a
port client against a JAX server and a JAX client against a port server
(the frames and the newline-JSON RPC are the same byte for byte).

Also here: one numpy-seeded push/pull sequence through either package
ends in equal tables (bit for bit on the raw wire, within the codec's
bound under WH_WIRE=bf16 and int8), the server's FTRL prox against the
port's plain scatter_update, the pool's file order, DiFacto's touched
rows and count mirror against the JAX learner, and the serve role
against a port scheduler."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import wormhole_tpu.obs.metrics as j_metrics
import wormhole_tpu.runtime.faults as j_faults
import wormhole_tpu.runtime.ps_server as j_ps
import wormhole_tpu.runtime.sched_journal as j_journal
import wormhole_tpu.runtime.tracker as j_tracker
import wormhole_tpu.solver.workload as j_workload
import wormhole_tpu_torch.obs.metrics as t_metrics
import wormhole_tpu_torch.runtime.faults as t_faults
import wormhole_tpu_torch.runtime.ps_server as t_ps
import wormhole_tpu_torch.runtime.sched_journal as t_journal
import wormhole_tpu_torch.runtime.tracker as t_tracker
import wormhole_tpu_torch.solver.workload as t_workload
from conftest import synth_libsvm_text
from wormhole_tpu_torch.solver.minibatch_solver import MembershipController
from wormhole_tpu_torch.utils.checkpoint import load_parts


class _Pkg:
    """One package's PS-plane modules under common names."""

    def __init__(self, ps, faults, metrics, tracker, journal, workload):
        self.ps, self.faults, self.metrics = ps, faults, metrics
        self.tracker, self.journal, self.workload = tracker, journal, workload


PORT = _Pkg(t_ps, t_faults, t_metrics, t_tracker, t_journal, t_workload)
JAX = _Pkg(j_ps, j_faults, j_metrics, j_tracker, j_journal, j_workload)

# (client package, server package): the port alone, then the two mixes
PAIRS = {"port": (PORT, PORT), "port-client-jax-server": (PORT, JAX),
         "jax-client-port-server": (JAX, PORT)}


class _FakeStore:
    """to_numpy/from_numpy/gather/scatter duck type standing in for a
    KVStore (host numpy)."""

    def __init__(self, tables):
        self.tables = {k: np.array(v, np.float32) for k, v in tables.items()}

    def to_numpy(self):
        return {k: v.copy() for k, v in self.tables.items()}

    def from_numpy(self, arrays):
        for k, v in arrays.items():
            self.tables[k] = np.array(v, np.float32)

    def gather_rows(self, k, idx):
        return self.tables[k][idx]

    def scatter_rows(self, k, idx, vals):
        self.tables[k][idx] = vals


class _DenseStore(_FakeStore):
    """The dense duck type: no row access (SyncedStore's scan path)."""

    gather_rows = None
    scatter_rows = None

    def __getattribute__(self, name):
        if name in ("gather_rows", "scatter_rows"):
            raise AttributeError(name)
        return object.__getattribute__(self, name)


# ----------------------------------------------------------- wire, ranges
@pytest.mark.parametrize("fixed_bytes", [0, 1, 2])
def test_wire_encoding_matches_jax(fixed_bytes):
    a = np.random.default_rng(fixed_bytes).normal(
        size=(13, 3)).astype(np.float32)
    mt, bt = t_ps._encode(a, fixed_bytes)
    mj, bj = j_ps._encode(a, fixed_bytes)
    assert mt == mj and bytes(bt) == bytes(bj)
    got = t_ps._decode(mt, bt)
    np.testing.assert_array_equal(got, j_ps._decode(mj, bj))
    if fixed_bytes == 0:
        np.testing.assert_array_equal(got, a)


def test_wire_bf16_rounds_and_halves_bytes():
    a = np.random.default_rng(1).normal(size=256).astype(np.float32)
    meta, buf = t_ps._encode(a, 2)
    assert len(buf) == a.nbytes // 2
    got = t_ps._decode(meta, buf)
    want = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_wire_int8_quarter_bytes():
    a = np.linspace(-1, 1, 128, dtype=np.float32)
    meta, buf = t_ps._encode(a, 1)
    assert len(buf) == a.nbytes // 4
    np.testing.assert_allclose(t_ps._decode(meta, buf), a, atol=1.0 / 127)


@pytest.mark.parametrize("n,world", [(37, 4), (1 << 26, 2), (5, 8)])
def test_shard_range_matches_jax(n, world):
    spans = [t_ps.shard_range(n, r, world) for r in range(world)]
    assert spans == [j_ps.shard_range(n, r, world) for r in range(world)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    for (a, b), (c, d) in zip(spans, spans[1:]):
        assert b == c


# ------------------------------------------------------- server + client
@pytest.fixture(params=list(PAIRS))
def group(request):
    cp, sp = PAIRS[request.param]
    nodes = [sp.ps.ServerNode(r, 2) for r in range(2)]
    for n in nodes:
        n.serve()
    client = cp.ps.PSClient([n.uri for n in nodes])
    yield nodes, client, cp
    client.close()
    for n in nodes:
        n.stop()


def test_init_pull_push(group):
    nodes, client, _ = group
    rng = np.random.default_rng(0)
    tables = {"w": rng.normal(size=10).astype(np.float32),
              "V": rng.normal(size=(10, 3)).astype(np.float32)}
    client.init(tables)
    got = client.pull()
    for k in tables:
        np.testing.assert_array_equal(got[k], tables[k])
    # a second init (another worker) must NOT overwrite
    client.init({k: v + 100 for k, v in tables.items()})
    np.testing.assert_array_equal(client.pull()["w"], tables["w"])
    # deltas accumulate across pushes
    d1 = {k: np.ones_like(v) for k, v in tables.items()}
    client.push(d1)
    client.push(d1)
    got = client.pull()
    np.testing.assert_allclose(got["w"], tables["w"] + 2.0, rtol=1e-6)
    np.testing.assert_allclose(got["V"], tables["V"] + 2.0, rtol=1e-6)


def test_push_unknown_table_errors(group):
    _, client, _ = group
    client.init({"w": np.zeros(4, np.float32)})
    with pytest.raises(RuntimeError, match="unknown table"):
        client.push({"nope": np.zeros(2, np.float32)})


def test_save_parts_reassemble(group, tmp_path):
    _, client, _ = group
    w = np.arange(10, dtype=np.float32)
    client.init({"w": w})
    paths = client.save(str(tmp_path / "m"))
    assert len(paths) == 2  # one part per server (iter_solver.h:115-119)
    np.testing.assert_array_equal(load_parts(str(tmp_path / "m"))["w"], w)


def test_synced_store_bounded_staleness(group):
    nodes, client, cp = group
    s1 = cp.ps.SyncedStore(_DenseStore({"w": np.zeros(8)}), client,
                           max_delay=2)
    s1.init()
    s1.store.tables["w"] += 1.0
    assert not s1.maybe_sync()
    s1.store.tables["w"] += 1.0
    assert s1.maybe_sync()
    np.testing.assert_array_equal(client.pull()["w"], np.full(8, 2.0))
    # a second worker joins, sees the merged state, adds its delta
    c2 = cp.ps.PSClient([n.uri for n in nodes])
    s2 = cp.ps.SyncedStore(_DenseStore({"w": np.zeros(8)}), c2, max_delay=1)
    s2.init()
    np.testing.assert_array_equal(s2.store.tables["w"], np.full(8, 2.0))
    s2.store.tables["w"] += 3.0
    s2.sync()
    np.testing.assert_array_equal(s2.store.tables["w"], np.full(8, 5.0))
    # worker 1 still holds base=2; its next sync pushes only ITS delta
    s1.store.tables["w"] += 1.0
    s1.sync()
    np.testing.assert_array_equal(s1.store.tables["w"], np.full(8, 6.0))
    c2.close()


def test_synced_store_quantized_wire(group):
    _, client, cp = group
    st = cp.ps.SyncedStore(_DenseStore({"w": np.zeros(8)}), client,
                           max_delay=1, fixed_bytes=2)
    st.init()
    st.store.tables["w"] += 0.1
    st.sync()
    np.testing.assert_allclose(client.pull()["w"], np.full(8, 0.1),
                               rtol=1e-2)


def test_sparse_push_versioned_pull(group):
    _, client, _ = group
    n = 40
    client.init({"w": np.zeros(n, np.float32),
                 "V": np.zeros((n, 3), np.float32)})
    idx = np.array([1, 7, 19, 33], np.int64)
    dw = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    dV = np.tile(dw[:, None], (1, 3))
    client.push_sparse({n: idx}, {"w": dw, "V": dV})
    c2, groups, got = client.pull_sparse([0, 0])
    np.testing.assert_array_equal(np.sort(groups[n]), idx)
    order = np.argsort(groups[n])
    np.testing.assert_allclose(got["w"][order], dw)
    np.testing.assert_allclose(got["V"][order], dV)
    # nothing new since those clocks -> empty pull
    _, groups2, got2 = client.pull_sparse(c2)
    assert groups2[n].size == 0 and got2["w"].size == 0
    want = np.zeros(n, np.float32)
    want[idx] = dw
    np.testing.assert_allclose(client.pull()["w"], want)


def test_push_log_capped_fallback_matches_scan(group):
    nodes, client, _ = group
    n = 64
    client.init({"w": np.zeros(n, np.float32)})
    for node in nodes:
        node._LOG_ELEM_CAP = 2
    idx1 = np.array([3, 9], np.int64)
    client.push_sparse({n: idx1}, {"w": np.ones(2, np.float32)})
    c_mid = [node.clock for node in nodes]
    idx2 = np.array([11, 40, 41, 42, 43, 60], np.int64)
    client.push_sparse({n: idx2}, {"w": np.ones(6, np.float32)})
    _, groups, _ = client.pull_sparse([0] * client.world)
    np.testing.assert_array_equal(np.sort(groups[n]),
                                  np.sort(np.concatenate([idx1, idx2])))
    _, groups2, _ = client.pull_sparse(c_mid)
    np.testing.assert_array_equal(np.sort(groups2[n]), idx2)
    assert any(node._log_start[n] > 0 for node in nodes)


def test_sparse_push_accumulates_and_wire_is_sparse(group):
    _, client, _ = group
    n = 1 << 16
    client.init({"w": np.zeros(n, np.float32)})
    base_push = client.bytes_push
    idx = np.arange(0, 64, dtype=np.int64)
    d = np.ones(64, np.float32)
    client.push_sparse({n: idx}, {"w": d})
    client.push_sparse({n: idx}, {"w": d})
    assert (client.bytes_push - base_push) / 2 < 8192
    _, groups, got = client.pull_sparse([0, 0])
    np.testing.assert_allclose(got["w"][np.argsort(groups[n])],
                               2.0 * np.ones(64))


def test_compressed_wire_roundtrip(group):
    _, client, _ = group
    n = 4096
    client.init({"w": np.zeros(n, np.float32)})
    d = np.ones(n, np.float32)
    b0 = client.bytes_push
    client.push_sparse({n: np.arange(n, dtype=np.int64)}, {"w": d},
                       compress=True)
    assert client.bytes_push - b0 < n * 8 // 4
    np.testing.assert_allclose(client.pull()["w"], d)


def test_synced_store_sparse_hints_match_dense(group):
    nodes, client, cp = group
    n = 32

    def mk(client_):
        store = _FakeStore({"w": np.zeros(n)})
        touched = {"rows": np.empty(0, np.int64)}

        def touch(idx, amount):
            store.tables["w"][idx] += amount
            touched["rows"] = np.union1d(touched["rows"],
                                         np.asarray(idx, np.int64))

        def collect():
            out = {"w": touched["rows"]}
            touched["rows"] = np.empty(0, np.int64)
            return out

        return store, touch, cp.ps.SyncedStore(store, client_, max_delay=1,
                                               touched_fn=collect)

    s1_store, touch1, s1 = mk(client)
    s1.init()
    c2 = cp.ps.PSClient([nd.uri for nd in nodes])
    s2_store, touch2, s2 = mk(c2)
    s2.init()
    touch1([3, 5], 1.0)
    s1.sync()
    touch2([5, 30], 10.0)
    s2.sync()
    s1.sync()
    want = np.zeros(n)
    want[[3, 5, 30]] = [1.0, 11.0, 10.0]
    np.testing.assert_allclose(s1_store.tables["w"], want)
    np.testing.assert_allclose(s2_store.tables["w"], want)
    b0 = c2.bytes_push + c2.bytes_pull
    s2.sync()
    assert (c2.bytes_push + c2.bytes_pull) - b0 < 2048
    c2.close()


_SPEC = {"w": {"kind": "ftrl_prox", "lr_eta": 0.5, "lr_beta": 1.0,
               "lambda_l1": 1.0, "lambda_l2": 0.0}}


def test_derived_recompute_sparse_dirty_rows(group):
    _, client, _ = group
    n = 16
    client.init({k: np.zeros(n, np.float32) for k in ("w", "z", "n")},
                derived=_SPEC)
    idx = np.array([2, 9], np.int64)
    for _ in range(2):
        client.push_sparse({n: idx}, {"w": np.zeros(2, np.float32),
                                      "z": np.full(2, 0.9, np.float32),
                                      "n": np.full(2, 0.25, np.float32)})
    eta = (1.0 + np.sqrt(0.5)) / 0.5
    want_w = np.zeros(n, np.float32)
    want_w[idx] = -(1.8 - 1.0) / eta
    np.testing.assert_allclose(client.pull()["w"], want_w, rtol=1e-5)


def test_derived_w_resolved_from_merged_z(group, tmp_path):
    """Two pushes of z below the L1 threshold each merge into a z above
    it: the server re-derives w from the merged (z, n), and saves it."""
    _, client, _ = group
    n_rows = 8
    client.init({k: np.zeros(n_rows, np.float32) for k in ("w", "z", "n")},
                derived=_SPEC)
    for _ in range(2):
        client.push({"w": np.zeros(n_rows, np.float32),
                     "z": np.full(n_rows, 0.9, np.float32),
                     "n": np.full(n_rows, 0.25, np.float32)})
    got = client.pull()
    np.testing.assert_allclose(got["z"], 1.8, rtol=1e-6)
    want_w = -(1.8 - 1.0) / ((1.0 + np.sqrt(0.5)) / 0.5)
    np.testing.assert_allclose(got["w"], want_w, rtol=1e-5)
    client.save(str(tmp_path / "model"))
    np.testing.assert_allclose(load_parts(str(tmp_path / "model"))["w"],
                               want_w, rtol=1e-5)


def test_init_spec_zero_tables_send_no_arrays(group):
    """Spec-based table creation at the 2^26-bucket FTRL operating
    point: the init ships headers, not the 768 MB of tables."""
    _, client, _ = group
    nb = 1 << 26
    tables = {k: np.zeros(nb, np.float32) for k in ("w", "z", "n")}
    client.init_from_specs({"w", "z", "n"}, tables)
    assert client.bytes_init < 1 << 20, client.bytes_init
    assert client.stats(0)["tables"]["w"] == [nb // 2]
    idx = np.array([3, nb - 2], np.int64)
    client.push_sparse({nb: idx}, {"w": np.ones((2,), np.float32)})
    _, groups, got = client.pull_sparse([0, 0])
    np.testing.assert_array_equal(np.sort(groups[nb]), idx)
    np.testing.assert_array_equal(got["w"], np.ones(2, np.float32))


def test_init_spec_nonzero_tables_ship_once(group):
    nodes, client, cp = group
    V = np.random.default_rng(3).normal(size=(16, 4)).astype(np.float32)
    tables = {"V": V, "nV": np.zeros((16, 4), np.float32)}
    client.init_from_specs({"nV"}, tables)
    got = client.pull()
    np.testing.assert_array_equal(got["V"], V)
    np.testing.assert_array_equal(got["nV"], 0.0)
    c2 = cp.ps.PSClient([n.uri for n in nodes])
    b2 = c2.bytes_init
    c2.init_from_specs({"nV"}, {"V": V + 7, "nV": tables["nV"]})
    assert c2.bytes_init - b2 < 4096  # headers only, no payload
    np.testing.assert_array_equal(c2.pull()["V"], V)
    c2.close()


class _SpecStore(_DenseStore):
    def zero_init_names(self):
        return set(self.tables)


def test_synced_store_uses_spec_init(group):
    _, client, cp = group
    st = cp.ps.SyncedStore(_SpecStore({"w": np.zeros(1 << 16)}), client,
                           max_delay=1)
    st.init()
    assert client.bytes_init < 4096
    st.store.tables["w"] += 2.0
    st.sync()
    np.testing.assert_array_equal(client.pull()["w"], np.full(1 << 16, 2.0))


def test_mixed_frame_dense_merge_stamps_versions(group):
    _, client, cp = group
    client.init({"a": np.zeros(8, np.float32), "b": np.zeros(6, np.float32)})
    for r in range(client.world):
        lo8, hi8 = cp.ps.shard_range(8, r, client.world)
        lo6, hi6 = cp.ps.shard_range(6, r, client.world)
        client._rpc(r, {"op": "push"}, {
            cp.ps._idx_name(8): np.arange(1)[:hi8 - lo8 and 1],
            "a": np.ones((1, ), np.float32)[:hi8 - lo8 and 1],
            "b": np.full(hi6 - lo6, 5.0, np.float32),
        })
    _, groups, got = client.pull_sparse([0, 0])
    assert groups[6].size == 6
    np.testing.assert_array_equal(got["b"], np.full((6,), 5.0))


def test_versioned_pull_short_circuits_when_clean(group):
    _, client, _ = group
    client.init({"w": np.zeros(8, np.float32)})
    client.push_sparse({8: np.array([2], np.int64)},
                       {"w": np.ones(1, np.float32)})
    clocks, groups, _ = client.pull_sparse([0, 0])
    assert groups[8].size == 1
    clocks2, groups2, tables2 = client.pull_sparse(clocks)
    assert clocks2 == clocks and groups2[8].size == 0
    assert all(v.shape[0] == 0 for v in tables2.values())


def test_warm_start_offers_arrays_not_specs(group):
    _, client, cp = group
    loaded = np.arange(8, dtype=np.float32)
    st = cp.ps.SyncedStore(_SpecStore({"w": loaded.copy()}), client,
                           max_delay=1, offer_arrays=True)
    st.init()
    np.testing.assert_array_equal(client.pull()["w"], loaded)
    st.store.tables["w"] += 1.0
    st.sync()
    np.testing.assert_array_equal(st.store.tables["w"], loaded + 1.0)
    np.testing.assert_array_equal(client.pull()["w"], loaded + 1.0)


def test_init_spec_shape_mismatch_fails_loudly(group):
    nodes, client, cp = group
    client.init_from_specs({"w"}, {"w": np.zeros(16, np.float32)})
    c2 = cp.ps.PSClient([n.uri for n in nodes])
    with pytest.raises(RuntimeError, match="spec mismatch"):
        c2.init_from_specs({"w"}, {"w": np.zeros(32, np.float32)})
    c2.close()


def test_scan_groups_union_end_to_end(group):
    _, client, cp = group
    n = 40
    store = _DenseStore({"a": np.zeros(n), "b": np.zeros(n)})
    ss = cp.ps.SyncedStore(store, client, max_delay=1)
    ss.init()
    store.tables["a"][[3, 7]] += 1.0
    store.tables["b"][[7, 30]] += 2.0
    groups, deltas = ss._scan_groups()
    np.testing.assert_array_equal(groups[n], np.array([3, 7, 30]))
    np.testing.assert_allclose(deltas["a"], [1.0, 1.0, 0.0])
    np.testing.assert_allclose(deltas["b"], [0.0, 2.0, 2.0])
    ss.close()


def test_union_groups_matches_repeated_union1d():
    rng = np.random.default_rng(11)
    shared = np.unique(rng.integers(0, 1000, size=64))
    parts = [shared, np.unique(rng.integers(0, 1000, size=32)),
             np.unique(rng.integers(500, 1500, size=48)),
             np.empty(0, np.int64)]
    want = np.empty(0, np.int64)
    for p in parts:
        want = np.union1d(want, p)
    got = t_ps.SyncedStore._union_groups({1500: parts})[1500]
    np.testing.assert_array_equal(got, want)
    assert t_ps.SyncedStore._union_groups({1000: [shared, shared]})[1000] \
        is shared


# ------------------------------------------------------------ async sync
def _hinted(cp, client, n, async_sync, **kw):
    """A SyncedStore over a fake host store with touched-row hints."""
    store = _FakeStore({"w": np.zeros(n)})
    touched = {"rows": np.empty(0, np.int64)}

    def touch(idx, amount):
        store.tables["w"][idx] += amount
        touched["rows"] = np.union1d(touched["rows"],
                                     np.asarray(idx, np.int64))

    def collect():
        out = {"w": touched["rows"]}
        touched["rows"] = np.empty(0, np.int64)
        return out

    ss = cp.ps.SyncedStore(store, client, max_delay=1, touched_fn=collect,
                           async_sync=async_sync, **kw)
    return store, touch, ss


@pytest.fixture(params=list(PAIRS))
def agroup(request):
    cp, sp = PAIRS[request.param]
    nodes = [sp.ps.ServerNode(r, 2) for r in range(2)]
    for n in nodes:
        n.serve()
    clients = []

    def mk(**kw):
        c = cp.ps.PSClient([n.uri for n in nodes], **kw)
        clients.append(c)
        return c

    yield nodes, mk, cp, sp
    for c in clients:
        c.close()
    for n in nodes:
        n.stop()


def test_async_off_is_bit_identical_to_sync_mode(agroup):
    nodes, mk, cp, _ = agroup
    n = 64
    rng = np.random.default_rng(3)
    idxs = [np.unique(rng.integers(0, n, size=12)) for _ in range(6)]

    def run(async_sync, sender):
        store, touch, ss = _hinted(cp, mk(sender=sender), n, async_sync)
        ss.init()
        for it, idx in enumerate(idxs):
            touch(idx, float(it + 1))
            ss.sync()
        ss.flush()
        ss.close()
        return store.tables["w"].copy(), ss

    _, ss_sync = run(False, "a0")
    assert ss_sync._comm_thread is None
    before = mk().pull()["w"].copy()
    w_async, _ = run(True, "a1")
    after = mk().pull()["w"].copy()
    np.testing.assert_array_equal(after - before, before)
    np.testing.assert_array_equal(w_async, after)


def test_async_bounded_staleness_invariant(agroup):
    _, mk, cp, _ = agroup
    n = 32
    store, touch, ss = _hinted(cp, mk(sender="b0"), n, async_sync=True)
    ss.init()
    for it in range(8):
        touch([it % n, (it * 5) % n], 1.0)
        ss.sync()
        assert ss.max_fold_lag <= 1
    ss.flush()
    assert ss.max_fold_lag == 1
    ss.close()


def test_async_two_workers_converge_and_keep_unpushed_progress(agroup):
    _, mk, cp, _ = agroup
    n = 48
    s1_store, touch1, s1 = _hinted(cp, mk(sender="c0"), n, async_sync=True)
    s2_store, touch2, s2 = _hinted(cp, mk(sender="c1"), n, async_sync=True)
    s1.init()
    s2.init()
    rng = np.random.default_rng(0)
    want = np.zeros(n, np.float32)
    for _ in range(6):
        i1 = np.unique(rng.integers(0, n, size=6))
        i2 = np.unique(rng.integers(0, n, size=6))
        touch1(i1, 1.0)
        want[i1] += 1.0
        touch2(i2, 10.0)
        want[i2] += 10.0
        s1.sync()
        s2.sync()
    s1.flush()
    s2.flush()
    s1.pull()
    s2.pull()
    np.testing.assert_allclose(s1_store.tables["w"], want, rtol=1e-6)
    np.testing.assert_allclose(s2_store.tables["w"], want, rtol=1e-6)
    s1.close()
    s2.close()


def test_async_fold_overwrites_derived_tables(agroup):
    _, mk, cp, _ = agroup
    n = 16
    store = _FakeStore({k: np.zeros(n) for k in ("w", "z", "n")})
    touched = {}

    def collect():
        rows = touched.pop("rows", np.empty(0, np.int64))
        return {"z": rows, "n": rows}

    ss = cp.ps.SyncedStore(store, mk(sender="d0"), max_delay=1,
                           derived=_SPEC, touched_fn=collect,
                           async_sync=True)
    ss.init()
    idx = np.array([2, 7, 11], np.int64)
    for _ in range(3):
        store.tables["z"][idx] += 1.8
        store.tables["n"][idx] += 0.25
        touched["rows"] = idx
        ss.sync()
    ss.flush()
    server = ss.client.pull()
    np.testing.assert_allclose(store.tables["w"], server["w"], rtol=1e-6)
    assert np.any(server["w"] != 0)
    ss.close()


def test_keycache_hit_then_miss_then_full_resend(agroup):
    nodes, mk, cp, _ = agroup
    client = mk(sender="e0", keycache=True)
    store, touch, ss = _hinted(cp, client, 64, async_sync=False)
    ss.init()
    idx = np.array([3, 5, 9, 40], np.int64)
    for _ in range(3):
        touch(idx, 1.0)
        ss.sync()
    assert client.kc_hits > 0 and client.kc_misses == 0
    nodes[0]._kc_idx = {}  # server 0 loses its cache (a respawn)
    nodes[0]._kc_known = {}
    touch(idx, 1.0)
    ss.sync()
    assert client.kc_misses >= 1
    np.testing.assert_array_equal(client.pull()["w"][idx],
                                  np.full(4, 4.0, np.float32))
    ss.close()


def test_keycache_steady_state_wire_drops(agroup):
    _, mk, cp, _ = agroup
    n = 1 << 14
    client = mk(sender="f0", keycache=True)
    store, touch, ss = _hinted(cp, client, n, async_sync=False)
    ss.init()
    idx = np.arange(0, n, 7, dtype=np.int64)
    per_sync = []
    for _ in range(4):
        touch(idx, 1.0)
        b0 = client.bytes_push + client.bytes_pull
        ss.sync()
        per_sync.append(client.bytes_push + client.bytes_pull - b0)
    assert 1.0 - per_sync[-1] / per_sync[0] >= 0.25, per_sync
    assert client.kc_hits / (client.kc_hits + client.kc_misses or 1) > 0.5
    ss.close()


def test_keycache_invalidated_on_restore_and_recover(agroup, tmp_path):
    nodes, mk, cp, sp = agroup
    inv_s = sp.metrics.REGISTRY.counter("ps.keycache.invalidations")
    inv_c = cp.metrics.REGISTRY.counter("ps.keycache.invalidations")
    client = mk(sender="g0", keycache=True, retry_deadline=10.0)
    store, touch, ss = _hinted(cp, client, 32, async_sync=False)
    ss.init()
    touch([1, 2, 3], 1.0)
    ss.sync()
    base = inv_s.value()
    nodes[0]._snap_base = str(tmp_path / "srv")
    assert nodes[0].snapshot() is not None
    nodes[0].restore_snapshot(str(tmp_path / "srv"))
    assert inv_s.value() > base
    assert not nodes[0]._kc_idx and not nodes[0]._kc_known
    base2 = inv_c.value()
    client._kc_pushed[0]["deadbeef"] = True
    client._recover(0, "push", ConnectionError("x"))
    assert inv_c.value() > base2
    assert not client._kc_pushed[0]
    ss.close()


def test_net_reset_during_async_syncs_applies_exactly_once():
    node = t_ps.ServerNode(0, 1)
    node.serve()
    client = t_ps.PSClient([node.uri], sender="h0", retry_deadline=15.0,
                           keycache=True)
    store, touch, ss = _hinted(PORT, client, 32, async_sync=True)
    ss.init()
    assert t_faults.ACTIVE is None
    t_faults.ACTIVE = t_faults.Faults("net:reset:after_frames=4",
                                      role="worker")
    try:
        for _ in range(5):
            touch([1, 2, 17], 1.0)
            ss.sync()
        ss.flush()
    finally:
        t_faults.ACTIVE = None
    assert client.num_retries >= 1
    np.testing.assert_array_equal(client.pull()["w"][[1, 2, 17]],
                                  np.full(3, 5.0, np.float32))
    ss.close()
    client.close()
    node.stop()


def test_server_kill_during_inflight_async_sync(tmp_path):
    inv = t_metrics.REGISTRY.counter("ps.keycache.invalidations")
    inv0 = inv.value()
    base = str(tmp_path / "srv")
    node = t_ps.ServerNode(0, 1)
    node._snap_base = base
    node.serve()
    holder = {"uris": None}
    client = t_ps.PSClient([node.uri], sender="k0", retry_deadline=20.0,
                           keycache=True, resolver=lambda: holder["uris"])
    store, touch, ss = _hinted(PORT, client, 32, async_sync=True)
    ss.init()
    touch([1, 2], 1.0)
    ss.sync()
    ss.flush()
    assert node.snapshot() is not None
    touch([3], 1.0)
    killed = threading.Event()
    orig = node._dispatch

    def dying(header, arrays):
        if header.get("op") == "push" and not killed.is_set():
            killed.set()
            node.stop()
            raise ConnectionError("server killed by test")
        return orig(header, arrays)

    node._dispatch = dying
    ss.sync()
    assert killed.wait(10)
    node2 = t_ps.ServerNode(0, 1, epoch=1)
    assert node2.restore_snapshot(base)
    node2.serve()
    holder["uris"] = [node2.uri]
    touch([4], 1.0)
    ss.sync()
    ss.flush()
    assert client.num_retries >= 1
    want = np.zeros(32, np.float32)
    want[[1, 2, 3, 4]] = 1.0
    np.testing.assert_array_equal(client.pull()["w"], want)
    np.testing.assert_array_equal(store.tables["w"], want)
    assert inv.value() > inv0
    ss.close()
    client.close()
    node2.stop()


# --------------------------------------------------------- fault tolerance
@pytest.fixture(params=list(PAIRS))
def solo(request):
    cp, sp = PAIRS[request.param]
    node = sp.ps.ServerNode(0, 1)
    node.serve()
    client = cp.ps.PSClient([node.uri])
    yield node, client, cp
    client.close()
    node.stop()


def test_duplicate_push_applied_once(solo):
    _, client, _ = solo
    client.init({"w": np.zeros(8, np.float32)})
    d = np.ones(8, np.float32)
    hdr = {"op": "push", "sender": "worker-0", "seq": 1}
    h1, _ = client._rpc(0, dict(hdr), {"w": d})
    assert not h1.get("dup")
    h2, _ = client._rpc(0, dict(hdr), {"w": d})
    assert h2.get("dup") is True and h2["clock"] == h1["clock"]
    np.testing.assert_array_equal(client.pull()["w"], d)
    client._rpc(0, {"op": "push", "sender": "worker-0", "seq": 2}, {"w": d})
    np.testing.assert_array_equal(client.pull()["w"], 2 * d)
    h, _ = client._rpc(0, {"op": "hello", "sender": "worker-0"})
    assert h["last_seq"] == 2
    h, _ = client._rpc(0, {"op": "hello", "sender": "worker-9"})
    assert h["last_seq"] == 0


def test_client_stamps_seqs_when_named(solo):
    node, client, cp = solo
    client.init({"w": np.zeros(4, np.float32)})
    named = cp.ps.PSClient([node.uri], sender="worker-3",
                           retry_deadline=5.0)
    named.push({"w": np.ones(4, np.float32)})
    named.push({"w": np.ones(4, np.float32)})
    h, _ = named._rpc(0, {"op": "hello", "sender": "worker-3"})
    assert h["last_seq"] == 2
    assert len(named._journal[0]) == 2
    named.close()
    client.push({"w": np.ones(4, np.float32)})
    assert client._journal[0].maxlen and len(client._journal[0]) == 0


def test_no_retry_fails_fast_with_resume_guidance(solo):
    node, client, _ = solo
    client.init({"w": np.zeros(4, np.float32)})
    node.stop()
    with pytest.raises((ConnectionError, ConnectionResetError),
                       match="job must be restarted"):
        for _ in range(3):
            client.push({"w": np.ones(4, np.float32)})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_restore_roundtrip(tmp_path, writer):
    """A respawned port server restores a snapshot either package wrote
    and resumes mid-training: tables, clock, seq fence and derived specs
    survive, and the restored rows are version-stamped."""
    base = str(tmp_path / "srv")
    wp = PORT if writer == "port" else JAX
    node = wp.ps.ServerNode(0, 1)
    node.serve()
    client = wp.ps.PSClient([node.uri])
    try:
        client.init({k: np.zeros(16, np.float32) for k in ("w", "z", "n")},
                    derived=_SPEC)
        client.push_sparse({16: np.array([2, 9], np.int64)},
                           {"w": np.zeros(2, np.float32),
                            "z": np.full(2, 1.8, np.float32),
                            "n": np.full(2, 0.25, np.float32)})
        client._rpc(0, {"op": "push", "sender": "w0", "seq": 7},
                    {k: np.zeros(16, np.float32) for k in ("z", "w", "n")})
        node._snap_base = base
        assert node.snapshot() is not None
        assert node.snapshot() is None  # clean: nothing new to write
        want = client.pull()
        clock = node.clock
    finally:
        client.close()
        node.stop()
    node2 = t_ps.ServerNode(0, 1, epoch=1)
    assert node2.restore_snapshot(base)
    assert node2.clock == clock
    node2.serve()
    c2 = t_ps.PSClient([node2.uri])
    try:
        got = c2.pull()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        h, _ = c2._rpc(0, {"op": "push", "sender": "w0", "seq": 7},
                       {"z": np.ones(16, np.float32),
                        "w": np.zeros(16, np.float32),
                        "n": np.zeros(16, np.float32)})
        assert h.get("dup") is True
        h, _ = c2._rpc(0, {"op": "hello", "sender": "w0"})
        assert h["last_seq"] == 7 and h["epoch"] == 1
        _, groups, _ = c2.pull_sparse([0])
        np.testing.assert_array_equal(np.sort(groups[16]), [2, 9])
        c2.push_sparse({16: np.array([2], np.int64)},
                       {"w": np.zeros(1, np.float32),
                        "z": np.full(1, 0.9, np.float32),
                        "n": np.full(1, 0.25, np.float32)})
        assert c2.pull()["w"][2] != got["w"][2]
    finally:
        c2.close()
        node2.stop()


def test_restore_without_snapshot_restarts_empty(tmp_path):
    node = t_ps.ServerNode(0, 1, epoch=1)
    assert node.restore_snapshot(str(tmp_path / "missing")) is False
    assert not node.tables


def test_retry_deadline_exhaustion_raises():
    node = t_ps.ServerNode(0, 1)
    node.serve()
    client = t_ps.PSClient([node.uri], sender="w0", retry_deadline=1.0)
    client.init({"w": np.zeros(4, np.float32)})
    node.stop()
    with pytest.raises(ConnectionError, match="did not come back"):
        for _ in range(3):
            client.push({"w": np.ones(4, np.float32)})
    client.close()


def test_retry_reconnects_and_replays_journal(tmp_path):
    """Server dies after a snapshot with journaled pushes past it; the
    respawned epoch-1 server restores; the client re-resolves, fences
    with hello, replays exactly the unapplied entries, re-pulls from 0."""
    base = str(tmp_path / "srv")
    node = t_ps.ServerNode(0, 1)
    node.serve()
    holder = {"uris": None}
    client = t_ps.PSClient([node.uri], sender="w0", retry_deadline=15.0,
                           resolver=lambda: holder["uris"])
    client.init({"w": np.zeros(16, np.float32)})
    client.push_sparse({16: np.array([1, 2], np.int64)},
                       {"w": np.ones(2, np.float32)})
    node._snap_base = base
    assert node.snapshot() is not None
    client.push_sparse({16: np.array([3], np.int64)},
                       {"w": np.ones(1, np.float32)})
    snap_clock = node.clock
    node.stop()
    node2 = t_ps.ServerNode(0, 1, epoch=1)
    assert node2.restore_snapshot(base)
    assert node2.clock < snap_clock
    node2.serve()
    holder["uris"] = [node2.uri]
    client.push_sparse({16: np.array([4], np.int64)},
                       {"w": np.ones(1, np.float32)})
    assert client.num_retries >= 1 and client.uris == [node2.uri]
    want = np.zeros(16, np.float32)
    want[[1, 2, 3, 4]] = 1.0
    np.testing.assert_array_equal(client.pull()["w"], want)
    h, _ = client._rpc(0, {"op": "hello", "sender": "w0"})
    assert h["last_seq"] == 3
    assert client._rolled_back[0] is True
    clocks, groups, _ = client.pull_sparse([snap_clock + 100])
    np.testing.assert_array_equal(np.sort(groups[16]), [1, 2, 3, 4])
    _, groups2, _ = client.pull_sparse(clocks)
    assert groups2[16].size == 0
    client.close()
    node2.stop()


def test_net_reset_fault_recovers_exactly_once(solo):
    node, client, cp = solo
    client.init({"w": np.zeros(8, np.float32)})
    named = cp.ps.PSClient([node.uri], sender="w0", retry_deadline=10.0)
    assert cp.faults.ACTIVE is None
    cp.faults.ACTIVE = cp.faults.Faults("net:reset:after_frames=1",
                                        role="worker")
    try:
        for _ in range(3):
            named.push({"w": np.ones(8, np.float32)})
    finally:
        cp.faults.ACTIVE = None
        named.close()
    assert named.num_retries >= 1
    np.testing.assert_array_equal(client.pull()["w"],
                                  np.full(8, 3.0, np.float32))


def test_fault_kill_fires_at_nth_op():
    kills = []
    f = t_faults.Faults("server:0:kill@push:2", role="server", rank=0)
    f.kill_fn = kills.append
    f.server_op("push")
    f.server_op("pull")
    assert not kills
    f.server_op("push")
    assert kills == [t_faults.KILL_EXIT]


# ------------------------------------ one push/pull sequence, two packages
def _sequence_tables(pkg, wire, monkeypatch, steps=6):
    """Two hinted workers over a two-server group of `pkg`, trained by a
    numpy-seeded sequence of touches and syncs under WH_WIRE=`wire`;
    returns the server's tables and each worker's mirror."""
    monkeypatch.setenv("WH_WIRE", wire)
    monkeypatch.setenv("WH_WIRE_EF", "1" if wire != "raw" else "0")
    nodes = [pkg.ps.ServerNode(r, 2) for r in range(2)]
    for n in nodes:
        n.serve()
    clients = [pkg.ps.PSClient([n.uri for n in nodes], sender=f"s{i}")
               for i in range(2)]
    try:
        rng = np.random.default_rng(42)
        n = 96
        stores, syncs = [], []
        for c in clients:
            store = _FakeStore({"w": np.zeros(n), "V": np.zeros((n, 4))})
            touched = {"rows": np.empty(0, np.int64)}

            def collect(touched=touched):
                rows = touched["rows"]
                touched["rows"] = np.empty(0, np.int64)
                return {"w": rows, "V": rows}

            ss = pkg.ps.SyncedStore(store, c, max_delay=1,
                                    touched_fn=collect)
            ss.init()
            stores.append((store, touched))
            syncs.append(ss)
        for _ in range(steps):
            for (store, touched), ss in zip(stores, syncs):
                idx = np.unique(rng.integers(0, n, size=10))
                store.tables["w"][idx] += rng.normal(
                    size=len(idx)).astype(np.float32)
                store.tables["V"][idx] += rng.normal(
                    size=(len(idx), 4)).astype(np.float32)
                touched["rows"] = np.union1d(touched["rows"], idx)
                ss.sync()
        for ss in syncs:
            ss.flush()
        for ss in syncs:
            ss.pull()
        server = clients[0].pull()
        mirrors = [s.tables for s, _ in stores]
        for ss in syncs:
            ss.close()
        return server, mirrors
    finally:
        for c in clients:
            c.close()
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("wire", ["raw", "bf16", "int8"])
def test_push_pull_sequence_matches_jax(wire, monkeypatch):
    """The same seeded sequence through the port's plane and the JAX
    package's ends in the same tables: bit for bit on the raw wire; under
    bf16 and int8 (with error feedback) each package's tables are within
    the codec's bound of the raw run, and of each other."""
    t_srv, t_mir = _sequence_tables(PORT, wire, monkeypatch)
    j_srv, j_mir = _sequence_tables(JAX, wire, monkeypatch)
    for k in ("w", "V"):
        if wire == "raw":
            np.testing.assert_array_equal(t_srv[k], j_srv[k])
            for a, b in zip(t_mir, j_mir):
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_allclose(t_srv[k], j_srv[k], rtol=1e-6,
                                       atol=1e-6)
    if wire != "raw":
        raw, _ = _sequence_tables(PORT, "raw", monkeypatch)
        # a bf16 code keeps 8 mantissa bits, an int8 group code 1/127 of
        # its group's absmax; every delta is O(1) and a row sums <= 12
        atol = {"bf16": 0.05, "int8": 0.25}[wire]
        for k in ("w", "V"):
            np.testing.assert_allclose(t_srv[k], raw[k], atol=atol)
            assert not np.array_equal(t_srv[k], raw[k])  # the codec ran


# --------------------------------------------------------- the FTRL prox
def test_ftrl_prox_rows_matches_scatter_update_and_jax():
    """The w the server derives from (z, n) against the w the port's
    plain scatter_update writes after the same FTRL steps, and against
    the JAX package's ftrl_prox_rows."""
    from wormhole_tpu_torch.ops.fused_update import scatter_update_plain

    rng = np.random.default_rng(5)
    nb, steps = 4096, 5
    cfg = dict(lr_eta=0.1, lr_beta=1.0, lambda_l1=1.0, lambda_l2=0.5)
    spec = {"kind": "ftrl_prox", **cfg}
    state = {k: torch.zeros(nb) for k in ("w", "z", "n")}
    for _ in range(steps):
        uniq = torch.from_numpy(np.unique(rng.integers(0, nb, size=900)))
        g = torch.from_numpy(rng.normal(scale=3.0, size=len(uniq))
                             .astype(np.float32))
        scatter_update_plain("ftrl", state, g, uniq, **cfg)
    z, n = state["z"].numpy(), state["n"].numpy()
    w_srv = t_ps.ftrl_prox_rows(spec, z, n)
    assert w_srv.dtype == np.float32 and np.count_nonzero(w_srv) > 100
    np.testing.assert_array_equal(w_srv, j_ps.ftrl_prox_rows(spec, z, n))
    np.testing.assert_allclose(w_srv, state["w"].numpy(), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ the pool
def test_workload_pool_hands_out_parts_in_file_order(tmp_path):
    for i in range(3):
        (tmp_path / f"part-{i}").write_text("1 1:1\n")
    pool = t_workload.WorkloadPool()
    assert pool.add(f"{tmp_path}/part-.*", 2) == 3
    got = []
    while (p := pool.get("w0")) is not None:
        got.append((p[0], os.path.basename(p[1].filename), p[1].part))
    assert got == [(i, f"part-{i // 2}", i % 2) for i in range(6)]
    # a finished part stays done; a reset part comes back first
    pool.finish(0)
    pool.reset("w0")
    assert pool.get("w1")[0] == 1


def test_workload_pool_state_round_trips_with_jax(tmp_path):
    """A journaled pool state one package exports loads in the other."""
    for i in range(2):
        (tmp_path / f"p{i}").write_text("")
    tp = t_workload.WorkloadPool()
    tp.add(f"{tmp_path}/p.*", 2)
    tp.get("w0")
    tp.finish(0)
    jp = j_workload.WorkloadPool()
    jp.load_state(tp.export_state())
    assert jp.export_state() == tp.export_state()


# --------------------------------------------------- the scheduler, HA
SCHED_PAIRS = {"port": (PORT, PORT), "port-client-jax-sched": (PORT, JAX),
               "jax-client-port-sched": (JAX, PORT)}


def _make_parts(tmp_path, n=4):
    d = tmp_path / "data"
    d.mkdir(exist_ok=True)
    for i in range(n):
        (d / f"part-{i}").write_text("")
    return str(d)


def _counter(pkg, name):
    return int(pkg.metrics.REGISTRY.snapshot()["counters"].get(name, 0))


@pytest.mark.parametrize("pair", list(SCHED_PAIRS))
def test_journal_replay_round_trip(tmp_path, pair):
    cp, sp = SCHED_PAIRS[pair]
    data = _make_parts(tmp_path)
    jdir = str(tmp_path / "ctl")
    s1 = sp.tracker.Scheduler(node_timeout=10, straggler=False,
                              journal_dir=jdir)
    s1.serve()
    try:
        assert s1.incarnation == 0
        c = cp.tracker.SchedulerClient(s1.uri, "w0")
        c.register()
        assert s1.start_round(f"{data}/part-.*", 2, "libsvm",
                              sp.workload.WorkType.TRAIN, 0) == 4
        pool = cp.tracker.RemotePool(c, poll=0.02)
        pool.sync_round()
        part_id, _ = pool.get()
        pool.finish(part_id, {"nex": 3.0})
        s1.publish_blob("resume-key", "resume-val")
        epoch1 = s1._epoch
        assert s1.pool.export_state()["num_finished"] == 1
    finally:
        s1.stop()
    s2 = sp.tracker.Scheduler(node_timeout=10, straggler=False,
                              journal_dir=jdir)
    s2.serve()
    try:
        assert s2.incarnation == 1 and s2._epoch == epoch1
        assert int(s2._round["type"]) == int(sp.workload.WorkType.TRAIN)
        assert s2.pool.export_state()["num_finished"] == 1
        assert not s2.pool.is_finished()
        assert s2.progress.value("nex") == 3.0
        assert s2.has_blob("resume-key")
        assert c._sender in s2._replies
    finally:
        s2.stop()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_written_by_either_package_replays_in_the_port(tmp_path,
                                                                writer):
    wp = PORT if writer == "port" else JAX
    data = _make_parts(tmp_path)
    jdir = str(tmp_path / "ctl")
    s1 = wp.tracker.Scheduler(node_timeout=10, straggler=False,
                              journal_dir=jdir)
    s1.serve()
    try:
        c = wp.tracker.SchedulerClient(s1.uri, "w0")
        c.register()
        s1.start_round(f"{data}/part-.*", 1, "libsvm",
                       wp.workload.WorkType.TRAIN, 0)
        pool = wp.tracker.RemotePool(c, poll=0.02)
        pool.sync_round()
        for _ in range(2):
            pid, _ = pool.get()
            pool.finish(pid, {"nex": 2.0})
        want = s1.pool.export_state()
    finally:
        s1.stop()
    s2 = t_tracker.Scheduler(node_timeout=10, straggler=False,
                             journal_dir=jdir)
    s2.serve()
    try:
        assert s2.incarnation == 1
        assert s2.progress.value("nex") == 4.0
        got = s2.pool.export_state()
        assert [p["state"] for p in got["parts"]] == \
            [p["state"] for p in want["parts"]]
    finally:
        s2.stop()


def test_journal_torn_tail_truncates(tmp_path):
    jdir = str(tmp_path / "ctl")
    j = t_journal.SchedulerJournal(jdir)
    for i in range(3):
        j.record({"k": "blob", "key": f"k{i}", "data": "x"})
    j.close()
    path = os.path.join(jdir, "sched.journal")
    with open(path, "ab") as fh:
        fh.write(b'{"k": "blob", "key": "torn-no-newline"')
    snap, recs, max_inc = t_journal.SchedulerJournal(jdir).load()
    assert snap is None and max_inc == -1
    assert [r["key"] for r in recs] == ["k0", "k1", "k2"]
    with open(path, "rb") as fh:
        body = fh.read()
    assert body.endswith(b"\n") and body.count(b"\n") == 3
    with open(path, "ab") as fh:
        fh.write(b"not json at all\n")
        fh.write(b'{"k": "blob", "key": "after-corruption", "data": "x"}\n')
    _, recs, _ = t_journal.SchedulerJournal(jdir).load()
    assert [r["key"] for r in recs] == ["k0", "k1", "k2"]


def test_compaction_preserves_restored_state(tmp_path):
    data = _make_parts(tmp_path)
    jdir = str(tmp_path / "ctl")
    s1 = t_tracker.Scheduler(node_timeout=10, straggler=False,
                             journal_dir=jdir)
    s1._compact_every = 1
    s1.serve()
    compactions0 = _counter(PORT, "sched.journal.compactions")
    try:
        c = t_tracker.SchedulerClient(s1.uri, "w0")
        c.register()
        for dp in range(2):
            s1.start_round(f"{data}/part-.*", 1, "libsvm",
                           t_workload.WorkType.TRAIN, dp)
            pool = t_tracker.RemotePool(c, poll=0.02)
            pool.sync_round()
            while (got := pool.get()) is not None:
                pool.finish(got[0], {"nex": 1.0})
            s1.wait_round(print_sec=0.05, verbose=False)
        epoch1 = s1._epoch
    finally:
        s1.stop()
    assert _counter(PORT, "sched.journal.compactions") > compactions0
    assert os.path.exists(os.path.join(jdir, "sched.snapshot"))
    s2 = t_tracker.Scheduler(node_timeout=10, straggler=False,
                             journal_dir=jdir)
    s2.serve()
    try:
        assert s2.incarnation == 1 and s2._epoch == epoch1
        assert s2.pool.is_finished()
        assert s2.progress.value("nex") == 4.0
        assert s2.pool.export_state()["num_finished"] == 4
    finally:
        s2.stop()


@pytest.mark.parametrize("pair", list(SCHED_PAIRS))
def test_dedup_and_stale_seq_fence(tmp_path, pair):
    cp, sp = SCHED_PAIRS[pair]
    data = _make_parts(tmp_path)
    sched = sp.tracker.Scheduler(node_timeout=10, straggler=False)
    sched.serve()
    try:
        c = cp.tracker.SchedulerClient(sched.uri, "w0")
        c.register()
        sched.start_round(f"{data}/part-.*", 1, "libsvm",
                          sp.workload.WorkType.TRAIN, 0)
        pool = cp.tracker.RemotePool(c, poll=0.02)
        pool.sync_round()
        part_id, _ = pool.get()
        pool.finish(part_id, {"nex": 5.0})
        assert sched.progress.value("nex") == 5.0
        hits0 = _counter(sp, "sched.rpc.dedup_hits")
        with c._seq_lock:
            c._seq -= 1
        r = c.call(op="finish", part_id=part_id, epoch=pool.epoch,
                   progress={"nex": 5.0})
        assert r["inc"] == 0
        assert sched.progress.value("nex") == 5.0
        assert _counter(sp, "sched.rpc.dedup_hits") == hits0 + 1
        with c._seq_lock:
            c._seq -= 2
        with pytest.raises(RuntimeError, match="stale scheduler seq"):
            c.call(op="report", progress={"nex": 99.0})
        assert sched.progress.value("nex") == 5.0
    finally:
        sched.stop()


def test_reply_cache_exactly_once_across_restart(tmp_path):
    data = _make_parts(tmp_path)
    jdir = str(tmp_path / "ctl")
    s1 = t_tracker.Scheduler(node_timeout=10, straggler=False,
                             journal_dir=jdir)
    s1.serve()
    try:
        c = t_tracker.SchedulerClient(s1.uri, "w0")
        c.register()
        s1.start_round(f"{data}/part-.*", 2, "libsvm",
                       t_workload.WorkType.TRAIN, 0)
        pool = t_tracker.RemotePool(c, poll=0.02)
        pool.sync_round()
        part_id, _ = pool.get()
        pool.finish(part_id, {"nex": 7.0})
        round_epoch = pool.epoch
    finally:
        s1.stop()
    s2 = t_tracker.Scheduler(node_timeout=10, straggler=False,
                             journal_dir=jdir)
    s2.serve()
    try:
        assert s2.incarnation == 1
        hits0 = _counter(PORT, "sched.rpc.dedup_hits")
        c2 = t_tracker.SchedulerClient(s2.uri, "w0")
        c2._sender = c._sender
        with c2._seq_lock:
            c2._seq = c._seq - 1
        r = c2.call(op="finish", part_id=part_id, epoch=round_epoch,
                    progress={"nex": 7.0})
        assert r["inc"] == 1
        assert s2.progress.value("nex") == 7.0
        assert _counter(PORT, "sched.rpc.dedup_hits") == hits0 + 1
        assert s2.pool.export_state()["num_finished"] == 1
    finally:
        s2.stop()


def test_sched_kill_spec_arming():
    killed = []
    f = t_faults.Faults("sched:kill@finish:2", role="scheduler")
    f.kill_fn = killed.append
    f.sched_op("get")
    f.sched_op("finish")
    assert killed == []
    f.sched_op("finish")
    assert killed == [t_faults.KILL_EXIT]
    h = t_faults.Faults("sched:kill@finish:1", role="scheduler", epoch=1)
    h.kill_fn = killed.append
    h.sched_op("finish")
    assert killed == [t_faults.KILL_EXIT]
    d = t_faults.Faults("sched:drop@register_server:1", role="scheduler")
    with pytest.raises(ConnectionError):
        d.sched_op("register_server")


def test_client_retry_rides_out_scheduler_outage(tmp_path):
    jdir = str(tmp_path / "ctl")
    s1 = t_tracker.Scheduler(node_timeout=10, straggler=False,
                             journal_dir=jdir)
    s1.serve()
    host, port = s1.uri.split(":")
    c = t_tracker.SchedulerClient(s1.uri, "w0", timeout=5.0,
                                  connect_deadline=2.0, retry_deadline=30.0)
    c.register()
    s1.stop()
    box = {}

    def rebind():
        time.sleep(1.0)
        box["s"] = t_tracker.Scheduler(host, int(port), node_timeout=10,
                                       straggler=False, journal_dir=jdir)
        box["s"].serve()

    t = threading.Thread(target=rebind)
    t.start()
    try:
        r = c.call(op="blob_put", key="after", data="restart")
        assert r["inc"] == 1 and c._inc == 1
    finally:
        t.join()
        box["s"].stop()


# ------------------------------------------------- MembershipController
def test_controller_grows_on_sustained_stall():
    c = MembershipController(2, lo=1, hi=4, grow_after=3)
    assert c.record(0.0, 1.0) == 2
    assert c.record(0.0, 1.0) == 2
    assert c.record(0.0, 1.0) == 3
    assert c.decisions[-1]["why"] == "starved"


def test_controller_shrinks_on_sustained_idle():
    c = MembershipController(2, lo=1, hi=4, shrink_after=6)
    for _ in range(5):
        assert c.record(4.0, 0.0) == 2
    assert c.record(4.0, 0.0) == 1
    assert c.decisions[-1]["why"] == "overfed"


def test_controller_hysteresis_resets_on_mixed_signal():
    c = MembershipController(2, lo=1, hi=4, grow_after=3)
    c.record(0.0, 1.0)
    c.record(0.0, 1.0)
    c.record(0.0, 0.2)
    assert c.record(0.0, 1.0) == 2
    assert c.record(0.0, 1.0) == 2
    assert c.record(0.0, 1.0) == 3


def test_controller_clamps_to_bounds():
    c = MembershipController(1, lo=1, hi=2, grow_after=1, shrink_after=1)
    assert c.record(0.0, 1.0) == 2
    assert c.record(0.0, 1.0) == 2
    assert c.record(4.0, 0.0) == 1
    assert c.record(4.0, 0.0) == 1


def test_controller_decisions_match_jax():
    """One seeded stream of observations: the same targets and the same
    decision log as the JAX package's controller."""
    from wormhole_tpu.solver.minibatch_solver import \
        MembershipController as JController

    rng = np.random.default_rng(2)
    a, b = MembershipController(3, lo=1, hi=6), JController(3, lo=1, hi=6)
    for _ in range(200):
        q, s = float(rng.integers(0, 5)), float(rng.choice([0.0, 0.01, 0.3,
                                                             0.9]))
        assert a.record(q, s, live=3) == b.record(q, s, live=3)
    assert a.decisions == b.decisions and a.decisions


def test_membership_controller_runs_in_the_port_scheduler(monkeypatch):
    """Scheduler.start_membership_controller imports the port's
    MembershipController and publishes a scripted plan's target."""
    monkeypatch.setenv("WH_ELASTIC_PLAN", "join@0.05")
    monkeypatch.setenv("WH_ELASTIC_SEC", "0.1")
    sched = t_tracker.Scheduler(node_timeout=10, straggler=False)
    sched.serve()
    try:
        sched.start_membership_controller(2)
        c = t_tracker.SchedulerClient(sched.uri, "launcher")
        deadline = time.monotonic() + 10
        while c.call(op="elastic").get("target") != 3:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        sched.stop()


# ------------------------------------------------------------- DiFacto
@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_difacto_touched_and_count_mirror_match_jax(tmp_path, kernel):
    """collect_touched after the same trained batches, and the count
    mirror after the same sparse pull, against the JAX learner."""
    from test_difacto import fm_synth_text
    from test_torch_difacto import _pair
    from wormhole_tpu.data.minibatch import MinibatchIter as JIter
    from wormhole_tpu_torch.data.minibatch import MinibatchIter as TIter

    path = tmp_path / "fm.libsvm"
    path.write_text(fm_synth_text())
    j, t = _pair(kernel=kernel, threshold=2)
    j.track_touched = t.track_touched = True
    for bj, bt in list(zip(JIter(str(path), minibatch_size=256),
                           TIter(str(path), minibatch_size=256)))[:2]:
        j.train_batch(bj)
        t.train_batch(bt)
    tj, tt = j.collect_touched(), t.collect_touched()
    assert set(tt) == set(tj) == {"w", "z", "n", "cnt", "V", "nV"}
    for k in tt:
        np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
    assert tt["w"].size > 0 and t.collect_touched()["w"].size == 0
    assert t.derived_tables() == j.derived_tables()
    # a sparse pull of cnt rows lands in both mirrors alike
    idx = tt["cnt"][::3]
    rows = np.arange(len(idx), dtype=np.float32) + 5.0
    j.ckpt_store.on_sparse_pull({"cnt": (idx, rows), "w": (idx, rows)})
    t.ckpt_store.on_sparse_pull({"cnt": (idx, rows), "w": (idx, rows)})
    np.testing.assert_array_equal(t._cnt_host, np.asarray(j._cnt_host))
    assert t.ckpt_store.zero_init_names() == j.ckpt_store.zero_init_names()
    assert t.ckpt_store.wire_cap_names() == j.ckpt_store.wire_cap_names()


def test_difacto_combined_store_rows():
    from wormhole_tpu_torch.models.difacto import (DifactoConfig,
                                                   DifactoLearner)

    t = DifactoLearner(DifactoConfig(num_buckets=256, v_buckets=64, dim=4),
                       device="cpu")
    cs = t.ckpt_store
    idx = np.array([1, 5, 63], np.int64)
    cs.scatter_rows("V", idx, np.ones((3, 4), np.float32))
    cs.scatter_rows("cnt", idx, np.full(3, 2.0, np.float32))
    got = cs.gather_rows_multi(["cnt", "V", "w"], idx)
    np.testing.assert_array_equal(got["V"], np.ones((3, 4)))
    np.testing.assert_array_equal(got["cnt"], np.full(3, 2.0))
    np.testing.assert_array_equal(cs.gather_rows("w", idx), np.zeros(3))
    assert cs.nnz("w") == 0


# ------------------------------------------------------------ serve role
def test_serve_role_against_a_port_scheduler(tmp_path):
    """run_serve_role registers with a port Scheduler; a Router built by
    Router.from_scheduler scores one block equal to a router over an
    in-process ModelServer; announce_shutdown ends the role."""
    from test_torch_serving import _blk
    from wormhole_tpu_torch.models.linear import LinearConfig
    from wormhole_tpu_torch.serving import (LinearScorer, ModelServer,
                                            Router, run_serve_role)
    from wormhole_tpu_torch.utils.manifest import write_snapshot_set

    rng = np.random.default_rng(0)
    nb = 1 << 12
    base = str(tmp_path / "srv")
    write_snapshot_set(base, {k: rng.normal(size=nb).astype(np.float32)
                              for k in ("w", "z", "n")}, world=2)
    cfg = LinearConfig(num_buckets=nb, minibatch=64, nnz_per_row=12)
    sched = t_tracker.Scheduler(node_timeout=10, straggler=False)
    sched.serve()
    env = t_tracker.NodeEnv(role=t_tracker.Role.SERVE, rank=0,
                            num_workers=1, num_servers=0,
                            scheduler_uri=sched.uri, num_serve=1)
    old = os.environ.get("WH_SERVE_SNAPSHOT")
    os.environ["WH_SERVE_SNAPSHOT"] = base
    errors = []

    def role():
        try:
            run_serve_role(cfg, env)
        except BaseException as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=role, daemon=True)
    th.start()
    local = ModelServer(0, 1, base)
    local.serve()
    router = ref = None
    try:
        client = t_tracker.SchedulerClient(sched.uri, "router")
        router = Router.from_scheduler(client, LinearScorer(cfg, device="cpu"),
                                       world=1, mode="fetch")
        ref = Router([local.uri], LinearScorer(cfg, device="cpu"),
                     mode="fetch")
        blk = _blk(rng)
        got, v_got = router.predict_block(blk)
        want, v_want = ref.predict_block(blk)
        np.testing.assert_array_equal(got, want)
        assert v_got == v_want
        sched.announce_shutdown()
        th.join(timeout=15)
        assert not th.is_alive() and not errors, errors
    finally:
        if old is None:
            os.environ.pop("WH_SERVE_SNAPSHOT", None)
        else:
            os.environ["WH_SERVE_SNAPSHOT"] = old
        for r in (router, ref):
            if r is not None:
                r.close()
        local.stop()
        sched.stop()
