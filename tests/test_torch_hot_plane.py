"""The port's hot parameter plane (wormhole_tpu_torch/parallel/hot_plane.py)
against the JAX package's, on the CPU.

The six contract tests of tests/test_hot_plane.py run once for each
package's HotPlane over the same host stand-in store and a two-shard
ServerNode group of that package: wire-silent steps, a synchronous flush
under WH_ASYNC_SYNC=1, pulls that never write the store, self-healing
after a server restore, plane selection and the wire-stats fields. Plane
selection in the port keys `auto` on torch.cuda.device_count(), tried at
0, 1 and 2 devices. A hot-plane port learner is bit-identical to the
plain port learner on one device (linear and DiFacto, max_delay 1 and
8), and its tables hold to the JAX package's hot-plane tables at the
learner bar (rtol 1e-4 / atol 1e-6), the JAX side run as its own tests
run it (tests/hot_plane_check.py's learners and cadence on a forced
4-device CPU mesh, in a subprocess: tests/hot_plane_tables.py).
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from conftest import synth_libsvm_text
from wormhole_tpu.parallel import hot_plane as jax_hot
from wormhole_tpu.runtime import ps_server as jax_ps
from wormhole_tpu_torch.parallel import hot_plane as port_hot
from wormhole_tpu_torch.runtime import ps_server as port_ps

PACKAGES = {"jax": (jax_hot, jax_ps), "torch": (port_hot, port_ps)}
LEARNER_BAR = dict(rtol=1e-4, atol=1e-6)


class _FakeStore:
    """Host stand-in for a KVStore (scan-path SyncedStore surface)."""

    def __init__(self, tables):
        self.tables = {k: np.array(v, np.float32)
                       for k, v in tables.items()}

    def to_numpy(self):
        return {k: v.copy() for k, v in self.tables.items()}

    def from_numpy(self, arrays):
        for k, v in arrays.items():
            self.tables[k] = np.array(v, np.float32)

    def zero_init_names(self):
        return set(self.tables)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """(HotPlane, ps_server module) of one package."""
    hot, ps = PACKAGES[request.param]
    return hot.HotPlane, ps


@pytest.fixture
def group(pkg):
    HotPlane, ps = pkg
    nodes = [ps.ServerNode(r, 2) for r in range(2)]
    for n in nodes:
        n.serve()
    client = ps.PSClient([n.uri for n in nodes], sender="worker-0")
    yield HotPlane, ps, nodes, client
    client.close()
    for n in nodes:
        n.stop()


def test_hot_steps_make_no_rpcs(group):
    """The training path is wire-silent: maybe_sync only counts; the
    cold tier sees traffic at flush barriers only."""
    HotPlane, _, nodes, client = group
    plane = HotPlane(_FakeStore({"w": np.zeros(16)}), client, max_delay=2)
    plane.init()
    b0 = client.bytes_push + client.bytes_pull
    for _ in range(10):  # 5x max_delay: the TCP plane would sync 5 times
        plane.store.tables["w"] += 1.0
        assert plane.maybe_sync() is False
    assert client.bytes_push + client.bytes_pull == b0
    assert plane.num_syncs == 0
    plane.flush()
    assert plane.num_syncs == 1
    np.testing.assert_array_equal(client.pull()["w"], np.full(16, 10.0))
    # barrier right after a barrier: nothing new, no extra round-trip
    s0 = plane.num_syncs
    plane.flush()
    assert plane.num_syncs == s0


def test_hot_forces_sync_flush_even_under_async_env(group, monkeypatch):
    """Drivers export WH_ASYNC_SYNC=1 for the TCP plane; the hot plane's
    flush stays synchronous regardless."""
    monkeypatch.setenv("WH_ASYNC_SYNC", "1")
    HotPlane, _, nodes, client = group
    plane = HotPlane(_FakeStore({"w": np.zeros(4)}), client)
    assert plane.async_sync is False


def test_hot_pull_never_writes_store(group):
    """Steady-state pulls refresh the base mirror only; the next flush
    drives the cold tier back to the device state."""
    HotPlane, ps, nodes, client = group
    plane = HotPlane(_FakeStore({"w": np.zeros(8)}), client, max_delay=1)
    plane.init()
    c2 = ps.PSClient([n.uri for n in nodes], sender="worker-1")
    c2.init_from_specs({"w"}, {"w": np.zeros(8, np.float32)})
    c2.push({"w": np.full(8, 5.0, np.float32)})
    local = plane.store.tables["w"].copy()
    plane.pull()
    np.testing.assert_array_equal(plane.store.tables["w"], local)
    np.testing.assert_array_equal(plane._base["w"], np.full(8, 5.0))
    plane.store.tables["w"] += 1.0
    plane.maybe_sync()
    plane.flush()
    np.testing.assert_array_equal(client.pull()["w"], np.full(8, 1.0))
    np.testing.assert_array_equal(plane._base["w"], np.full(8, 1.0))
    c2.close()


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_hot_plane_selfheals_after_server_restore(tmp_path, name):
    """A server rolled back to its snapshot is repaired wholesale by the
    next flush (base re-zeroed for the restored shard, cur - base
    re-uploads the authoritative device rows)."""
    hot, ps = PACKAGES[name]
    base = str(tmp_path / "srv")
    node = ps.ServerNode(0, 1)
    node.serve()
    holder = {"uris": None}
    client = ps.PSClient([node.uri], sender="w0", retry_deadline=15.0,
                         resolver=lambda: holder["uris"])
    plane = hot.HotPlane(_FakeStore({"w": np.zeros(8)}), client,
                         max_delay=1)
    plane.init()
    plane.store.tables["w"] += 1.0
    plane.maybe_sync()
    plane.flush()                       # server w=1 (seq 1)
    node._snap_base = base
    assert node.snapshot() is not None
    plane.store.tables["w"] += 1.0
    plane.maybe_sync()
    plane.flush()                       # server w=2, NOT in the snapshot
    node.stop()                         # SIGKILL stand-in

    node2 = ps.ServerNode(0, 1, epoch=1)
    assert node2.restore_snapshot(base)
    node2.serve()
    holder["uris"] = [node2.uri]
    try:
        plane.store.tables["w"] += 1.0  # device (authoritative) w=3
        plane.maybe_sync()
        plane.flush()  # reconnect + journal replay + rollback re-pull
        assert client.num_retries >= 1
        np.testing.assert_array_equal(plane.store.tables["w"],
                                      np.full(8, 3.0))
        np.testing.assert_array_equal(client.pull()["w"], np.full(8, 3.0))
        np.testing.assert_array_equal(plane._base["w"], np.full(8, 3.0))
        plane.store.tables["w"] += 1.0
        plane.maybe_sync()
        plane.flush()
        np.testing.assert_array_equal(client.pull()["w"], np.full(8, 4.0))
    finally:
        client.close()
        node2.stop()


def _local_devices(name, monkeypatch, count=None):
    """The local device count `auto` keys on: jax.local_device_count()
    in the JAX package, torch.cuda.device_count() (patched to `count`)
    in the port."""
    if name == "jax":
        import jax

        return jax.local_device_count()
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    return count


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_pick_plane_selection(monkeypatch, name):
    """WH_PS_PLANE routing in the runner: explicit values honored,
    invalid rejected, hot refused across processes with the same
    message, auto keyed on the in-process device count."""
    if name == "jax":
        from wormhole_tpu.apps._runner import _pick_plane
    else:
        from wormhole_tpu_torch.apps._runner import _pick_plane

    env1 = types.SimpleNamespace(num_workers=1)
    env2 = types.SimpleNamespace(num_workers=2)
    monkeypatch.setenv("WH_PS_PLANE", "tcp")
    assert _pick_plane(env1) == "tcp"
    monkeypatch.setenv("WH_PS_PLANE", "bogus")
    with pytest.raises(ValueError):
        _pick_plane(env1)
    monkeypatch.setenv("WH_PS_PLANE", "hot")
    assert _pick_plane(env1) == "hot"
    with pytest.raises(RuntimeError, match="requires all data-parallel "
                                           "workers in one process"):
        _pick_plane(env2)
    monkeypatch.delenv("WH_PS_PLANE")
    n = _local_devices(name, monkeypatch, 2)
    assert _pick_plane(env1) == ("hot" if n >= 2 else "tcp")
    assert _pick_plane(env2) == "tcp"


@pytest.mark.parametrize("count,want", [(0, "tcp"), (1, "tcp"), (2, "hot")])
def test_port_auto_plane_keys_on_cuda_device_count(monkeypatch, count, want):
    """`auto` in the port: hot for -n 1 with two or more cards, tcp with
    one card or none (the one-H100 machine and the CPU), tcp for -n 2
    whatever the count; the JAX package resolves the same way on a host
    with that many local devices."""
    from wormhole_tpu.apps import _runner as jax_runner
    from wormhole_tpu_torch.apps._runner import _pick_plane

    monkeypatch.delenv("WH_PS_PLANE", raising=False)
    _local_devices("torch", monkeypatch, count)
    assert _pick_plane(types.SimpleNamespace(num_workers=1)) == want
    assert _pick_plane(types.SimpleNamespace(num_workers=2)) == "tcp"
    import jax

    monkeypatch.setattr(jax, "local_device_count", lambda: count)
    assert jax_runner._pick_plane(
        types.SimpleNamespace(num_workers=1)) == want


def test_hot_wire_stats_plane_fields(group):
    HotPlane, ps, nodes, client = group
    plane = HotPlane(_FakeStore({"w": np.zeros(4)}), client, max_delay=4)
    plane.init()
    plane.store.tables["w"] += 1.0
    plane.maybe_sync()
    plane.flush()
    ws = plane.wire_stats()
    assert ws["plane"] == "hot" and ws["devices"] == 1
    assert ws["hot_steps"] == 1 and ws["flushes"] == 1
    # the TCP plane names itself too
    tcp = ps.SyncedStore(_FakeStore({"w": np.zeros(4)}), client)
    assert tcp.wire_stats()["plane"] == "tcp"


# ------------------------------------------------ the port's learners
@pytest.fixture(scope="module")
def synth_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("thot") / "synth.libsvm"
    p.write_text(synth_libsvm_text(n_rows=512, n_feat=300, nnz_per_row=12,
                                   seed=5))
    return str(p)


def _port_learner(model, max_delay):
    """tests/hot_plane_check.py's learners, in the port, on the CPU."""
    if model == "linear":
        from wormhole_tpu_torch.models.linear import (LinearConfig,
                                                      LinearLearner)

        cfg = LinearConfig(minibatch=128, num_buckets=1 << 10,
                           nnz_per_row=16, algo="ftrl", lr_eta=0.5,
                           lambda_l1=0.5, max_delay=max_delay,
                           kernel="xla")
        return LinearLearner(cfg, device="cpu")
    from wormhole_tpu_torch.models.difacto import (DifactoConfig,
                                                   DifactoLearner)

    cfg = DifactoConfig(minibatch=128, num_buckets=1 << 10, nnz_per_row=16,
                        algo="ftrl", lr_eta=0.5, lambda_l1=0.5, dim=4,
                        threshold=2, v_buckets=1 << 8, max_delay=max_delay,
                        kernel="xla")
    return DifactoLearner(cfg, device="cpu")


def _train(data, lrn, plane=None, passes=2, parts=2):
    """tests/hot_plane_check.py's cadence: maybe_sync a train batch, a
    flush at each part end."""
    from wormhole_tpu_torch.data.minibatch import MinibatchIter

    for ep in range(passes):
        for part in range(parts):
            for blk in MinibatchIter(data, fmt="libsvm", minibatch_size=128,
                                     seed=ep * 7919 + part, device="cpu"):
                lrn.train_batch(blk)
                if plane is not None:
                    plane.maybe_sync()
            if plane is not None:
                plane.flush()


def _store(lrn):
    return getattr(lrn, "ckpt_store", None) or lrn.store


def _state(lrn):
    return {k: np.asarray(v) for k, v in _store(lrn).to_numpy().items()}


def _hot_run(data, lrn, max_delay):
    """Train `lrn` under the port's HotPlane over a two-shard in-process
    cold tier; (final tables, cold tier tables, wire stats)."""
    nodes = [port_ps.ServerNode(r, 2) for r in range(2)]
    for nd in nodes:
        nd.serve()
    client = port_ps.PSClient([nd.uri for nd in nodes], sender="worker-0")
    lrn.track_touched = hasattr(lrn, "collect_touched")
    plane = port_hot.HotPlane(
        _store(lrn), client, max_delay=max_delay,
        derived=getattr(lrn, "derived_tables", dict)(),
        touched_fn=getattr(lrn, "collect_touched", None))
    plane.init()
    try:
        _train(data, lrn, plane)
        return _state(lrn), client.pull(), plane.wire_stats()
    finally:
        client.close()
        for nd in nodes:
            nd.stop()


@pytest.mark.parametrize("max_delay", [1, 8])
@pytest.mark.parametrize("model", ["linear", "difacto"])
def test_hot_plane_bit_identity(synth_file, model, max_delay):
    """A hot-plane port learner == the plain port learner, bitwise, on
    one device: the plane never writes the device store after init. The
    cold tier mirrors the device after the final flush, and the plane
    counted its steps and made one flush a part."""
    ref = _port_learner(model, max_delay)
    _train(synth_file, ref)
    hot = _port_learner(model, max_delay)
    got, cold, ws = _hot_run(synth_file, hot, max_delay)
    want = _state(ref)
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in sorted(cold):
        np.testing.assert_allclose(cold[k], got[k], **LEARNER_BAR,
                                   err_msg=f"cold tier {k}")
    assert ws["plane"] == "hot" and ws["devices"] == 1
    assert ws["hot_steps"] == 2 * 2 * 4  # passes x parts x 512/128 batches
    assert ws["flushes"] == ws["num_syncs"] == 2 * 2


@pytest.mark.parametrize("model", ["linear", "difacto"])
def test_hot_plane_tables_match_the_jax_hot_plane(synth_file, model,
                                                  tmp_path):
    """The port's hot-plane learner against the JAX package's hot-plane
    learner (tests/hot_plane_check.py's, on its forced 4-device CPU mesh
    of two model shards), from the same initial tables: the final device
    tables and the cold tiers hold to each other at the learner bar."""
    from wormhole_tpu_torch import interop

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = str(tmp_path / model)
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tests", "hot_plane_tables.py"),
         "--model", model, "--max-delay", "1", "--data", synth_file,
         "--out", out], env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    load = lambda kind: dict(np.load(f"{out}-{kind}.npz"))  # noqa: E731
    lrn = _port_learner(model, 1)
    init = load("init")
    if model == "linear":
        interop.load_linear_state(lrn, init)
    else:
        interop.load_difacto_state(lrn, init)
    got, cold, ws = _hot_run(synth_file, lrn, 1)
    want, jcold = load("final"), load("cold")
    assert set(got) == set(want) and set(cold) == set(jcold)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], **LEARNER_BAR,
                                   err_msg=f"device table {k}")
    for k in sorted(jcold):
        np.testing.assert_allclose(cold[k], jcold[k], **LEARNER_BAR,
                                   err_msg=f"cold tier {k}")
    assert f"flushes={ws['flushes']}" in r.stdout
    assert f"hot_steps={ws['hot_steps']}" in r.stdout
