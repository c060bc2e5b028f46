"""The port's public surface against the JAX package's.

Every public top-level function, class and method of each module of
``wormhole_tpu/`` has its counterpart in the port's module of the same
name (a method may be inherited); EXEMPT names each JAX-only name with
its reason. Then the names ported last (config helpers, the registry's
quantile/timer/reset, the key byte reversal, the block localizer, the
batches' nbytes, the apps' serve_scorer and the loader knobs
WH_DEVICE_FEED / WH_ADAPTIVE_LOADERS) against the JAX package on the
same numpy inputs.
"""

import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

from conftest import synth_libsvm_text

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "wormhole_tpu"

_SHARDING = ("a jax.sharding helper: XLA partitions the arrays; the "
             "port's ranks hold their shard and move rows with "
             "torch.distributed (parallel/mesh.py, parallel/kvstore.py)")
_NATIVE = ("the ctypes loader of the JAX package's native C++ core; the "
           "port parses, hashes and sorts on the card through the CUDA "
           "kernels of csrc/ and wormhole_tpu_torch/native.py "
           "(ROADMAP.md, the port's design)")

#: module (relative dotted name) -> reason the whole module is JAX-only
EXEMPT_MODULES = {
    "ops.pallas_compat": "shims over Pallas/jax versions for the TPU "
                         "kernels; no counterpart on the card",
}

#: "module:name" -> reason the name is JAX-only
EXEMPT = {
    "parallel.mesh:batch_sharding": _SHARDING,
    "parallel.mesh:replicated": _SHARDING,
    "parallel.mesh:table_sharding": _SHARDING,
    "parallel.kvstore:KVStore.sharding": _SHARDING,
    "parallel.kvstore:KVStore.constrain": _SHARDING,
    "parallel.kvstore:KVStore.update": (
        "a functional swap of immutable jax arrays; the port's steps "
        "update its tensors in place, and neither package calls it"),
    **{f"native:{n}": _NATIVE for n in (
        "available", "cityhash64", "gather", "get_lib", "parse_text",
        "radix_argsort")},
}


def _public(path):
    """Public top-level functions and classes of a module, and the
    public methods of its classes ("Class.method")."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
    return out


def _jax_modules():
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


JAX_MODULES = [m for m, _ in _jax_modules() if m]


def _has(mod, name):
    obj = mod
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_module_has_every_public_name(module):
    path = dict(_jax_modules())[module]
    if module in EXEMPT_MODULES:
        assert not (ROOT / "wormhole_tpu_torch" /
                    f"{module.replace('.', '/')}.py").exists()
        return
    port = importlib.import_module(f"wormhole_tpu_torch.{module}")
    missing = sorted(n for n in _public(path)
                     if not _has(port, n) and f"{module}:{n}" not in EXEMPT)
    assert missing == [], f"wormhole_tpu_torch.{module} lacks {missing}"


def test_every_exemption_names_a_jax_only_name():
    """No stale entry: each exempted name exists in the JAX module and
    not in the port's."""
    mods = dict(_jax_modules())
    for key in EXEMPT:
        module, name = key.split(":")
        assert name in _public(mods[module]), key
        port = importlib.import_module(f"wormhole_tpu_torch.{module}")
        assert not _has(port, name), key
    assert set(EXEMPT_MODULES) <= set(mods)


# --- the names ported last, against the JAX package -------------------------

def test_reverse_bytes_u64_bit_for_bit():
    from wormhole_tpu.ops import reverse_bytes_u64 as jrev
    from wormhole_tpu_torch.ops import reverse_bytes_u64 as trev

    rng = np.random.default_rng(0)
    for keys in (rng.integers(0, 1 << 63, size=1000, dtype=np.uint64),
                 np.arange(300, dtype=np.uint64),
                 np.array([0, (1 << 64) - 1, 1 << 56], np.uint64),
                 np.arange(17, dtype=np.int64)[::2]):
        got, want = trev(keys), jrev(keys)
        assert got.dtype == want.dtype == np.uint64
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _rowblocks(pkg, rng, n=40, weighted=False):
    from importlib import import_module

    RowBlock = import_module(f"{pkg}.data.rowblock").RowBlock
    counts = rng.integers(0, 9, size=n)
    offset = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    nnz = int(offset[-1])
    return RowBlock(
        label=rng.integers(0, 2, size=n).astype(np.float32), offset=offset,
        index=rng.integers(0, 50, size=nnz).astype(np.uint64) << np.uint64(
            40),
        value=rng.normal(size=nnz).astype(np.float32),
        weight=(rng.random(n).astype(np.float32) if weighted else None))


@pytest.mark.parametrize("weighted", [False, True])
def test_localize_block_array_for_array(weighted):
    from wormhole_tpu.ops.localizer import localize_block as jloc
    from wormhole_tpu_torch.ops.localizer import localize_block as tloc

    jblk = _rowblocks("wormhole_tpu", np.random.default_rng(4), weighted=weighted)
    tblk = _rowblocks("wormhole_tpu_torch", np.random.default_rng(4),
                      weighted=weighted)
    (jl, jb), (tl, tb) = jloc(jblk), tloc(tblk, device="cpu")
    for f in ("uniq_keys", "counts", "local_index"):
        a, b = getattr(tl, f), getattr(jl, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("label", "offset", "index", "value", "weight"):
        a, b = getattr(tb, f), getattr(jb, f)
        assert (a is None and b is None) or (
            a.dtype == b.dtype and np.array_equal(a, b)), f


def test_nbytes_of_both_batches():
    from wormhole_tpu.data.rowblock import to_device_batch as jdb
    from wormhole_tpu_torch.data.rowblock import to_device_batch as tdb

    for weighted in (False, True):
        jblk = _rowblocks("wormhole_tpu", np.random.default_rng(5),
                          weighted=weighted)
        tblk = _rowblocks("wormhole_tpu_torch", np.random.default_rng(5),
                          weighted=weighted)
        assert tblk.nbytes == jblk.nbytes > 0
        j, t = jdb(jblk, 64, 512, 1 << 12), tdb(tblk, 64, 512, 1 << 12)
        assert t.nbytes == j.nbytes == sum(
            a.nbytes for a in (t.seg, t.idx, t.val, t.label, t.row_mask))


@dataclasses.dataclass
class _Conf:
    train_data: str = "a/train-.*"
    minibatch: int = 128
    lr_eta: float = 0.1
    model_in: str = None
    tags: list = dataclasses.field(default_factory=lambda: ["x", "y"])
    l1_shrk: bool = True


def test_config_to_text_text_for_text():
    from wormhole_tpu.config import config_to_text as jtext
    from wormhole_tpu.models.linear import LinearConfig as JLin
    from wormhole_tpu_torch.config import config_to_text as ttext
    from wormhole_tpu_torch.config import load_config
    from wormhole_tpu_torch.models.linear import LinearConfig as TLin

    assert ttext(_Conf()) == jtext(_Conf())
    kw = dict(train_data="d/t-.*", minibatch=256, lambda_l1=2.0,
              num_buckets=1 << 12)
    tl, jl = ttext(TLin(**kw)).splitlines(), jtext(JLin(**kw)).splitlines()
    common = {f.name for f in dataclasses.fields(TLin)} & {
        f.name for f in dataclasses.fields(JLin)}
    assert [x for x in tl if x.split(" = ")[0] in common] == \
        [x for x in jl if x.split(" = ")[0] in common]
    # the text reads back into the same config
    assert load_config(TLin, argv=[x.replace(" = ", "=") for x in tl]) == \
        TLin(**kw)


def _rows(md):
    lines = md.splitlines()
    assert lines[:2] == ["| Knob | Type | Default | Description |",
                         "| --- | --- | --- | --- |"]
    return {ln.split("|")[1].strip(): ln for ln in lines[2:]}


@pytest.mark.parametrize("group", [None, "obs", "data", "ps"])
def test_knob_table_rows_match_for_shared_knobs(group):
    from wormhole_tpu.config import knob_table_markdown as jmd
    from wormhole_tpu_torch import config as tconfig

    trows, jrows = _rows(tconfig.knob_table_markdown(group)), _rows(jmd(group))
    shared = set(trows) & set(jrows)
    assert set(trows) == {f"`{k}`" for k, v in tconfig.KNOBS.items()
                          if group is None or v.group == group}
    assert shared == set(trows)  # every port knob is a JAX knob
    for k in shared:
        assert trows[k] == jrows[k], k
    for name in ("WH_SAN", "WH_SAN_SAMPLE", "WH_SAN_DUMP_DIR",
                 "WH_ADAPTIVE_LOADERS", "WH_DEVICE_FEED"):
        assert (f"`{name}`" in trows) == (
            group is None or tconfig.KNOBS[name].group == group)


@pytest.mark.parametrize("raw", [None, "", "0", "false", "OFF", "1", "yes"])
def test_env_flag_matches(raw, monkeypatch):
    from wormhole_tpu.config import env_flag as jflag
    from wormhole_tpu_torch.config import env_flag as tflag

    if raw is None:
        monkeypatch.delenv("WH_TEST_FLAG", raising=False)
    else:
        monkeypatch.setenv("WH_TEST_FLAG", raw)
    for default in (False, True):
        assert tflag("WH_TEST_FLAG", default) == jflag("WH_TEST_FLAG",
                                                       default)


def test_histogram_quantile_timer_and_registry_reset():
    from wormhole_tpu.obs.metrics import Registry as JReg
    from wormhole_tpu_torch.obs.metrics import Registry as TReg

    rng = np.random.default_rng(6)
    obs = rng.exponential(size=1000)
    t, j = TReg(), JReg()
    for reg in (t, j):
        h = reg.histogram("serve.request_s", reservoir=64)
        for v in obs:
            h.observe(v)
        reg.counter("net.frames_sent").inc(3)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0, 2.0):
        assert t.histogram("serve.request_s").quantile(q) == \
            j.histogram("serve.request_s").quantile(q)
    assert TReg().histogram("x_s").quantile(0.5) is None
    for reg in (t, j):
        with reg.timer("sched.op.get_s"):
            pass
        h = reg.histogram("sched.op.get_s")
        assert h.count == 1 and 0.0 <= h.sum < 1.0
        with pytest.raises(KeyError):
            with reg.timer("sched.op.put_s"):
                raise KeyError("the block's error propagates")
        assert reg.histogram("sched.op.put_s").count == 1
    assert t.snapshot()["counters"] == j.snapshot()["counters"]
    old = t.counter("net.frames_sent")
    t.reset()
    j.reset()
    assert t.snapshot() == j.snapshot() == {
        "counters": {}, "gauges": {}, "hists": {}}
    old.inc()  # a handle cached before the reset keeps working
    assert t.counter("net.frames_sent").value() == 0


@pytest.mark.parametrize("name", ["linear", "difacto"])
def test_serve_scorer_scores_like_the_scorers(name):
    import wormhole_tpu.apps.difacto as japp_fm
    import wormhole_tpu.apps.linear as japp_lin
    import wormhole_tpu_torch.apps.difacto as tapp_fm
    import wormhole_tpu_torch.apps.linear as tapp_lin
    from wormhole_tpu.models.difacto import DifactoConfig as JFm
    from wormhole_tpu.models.linear import LinearConfig as JLin
    from wormhole_tpu_torch.models.difacto import DifactoConfig as TFm
    from wormhole_tpu_torch.models.linear import LinearConfig as TLin
    from wormhole_tpu_torch.serving import DifactoScorer, LinearScorer

    rng = np.random.default_rng(12)
    if name == "linear":
        kw = dict(minibatch=48, num_buckets=1 << 11, nnz_per_row=12)
        tcfg, jcfg, cls = TLin(**kw), JLin(**kw), LinearScorer
        ts, js = tapp_lin.serve_scorer(tcfg, device="cpu"), \
            japp_lin.serve_scorer(jcfg)
        tables = {"w": rng.normal(size=kw["num_buckets"]).astype(
            np.float32)}
    else:
        kw = dict(minibatch=64, num_buckets=1 << 10, nnz_per_row=16, dim=4,
                  threshold=2, v_buckets=1 << 9)
        tcfg, jcfg, cls = TFm(**kw), JFm(**kw), DifactoScorer
        ts, js = tapp_fm.serve_scorer(tcfg, device="cpu"), \
            japp_fm.serve_scorer(jcfg)
        tables = {
            "w": rng.normal(size=kw["num_buckets"]).astype(np.float32),
            "cnt": rng.integers(0, 5, size=kw["num_buckets"]).astype(
                np.float32),
            "V": (rng.normal(size=(tcfg.vb, tcfg.dim)) * 0.1).astype(
                np.float32)}
    assert type(ts) is cls and str(ts.device) == "cpu"
    direct = cls(tcfg, device="cpu")
    for n in (1, 17, 40):
        blk = _rowblocks("wormhole_tpu_torch", rng, n=n)
        tp, jp, dp = ts.pack(blk), js.pack(blk), direct.pack(blk)
        rows = {t: tables[t][tp.keys[t]] for t in ts.tables}
        got = ts.score(tp, rows)
        assert np.array_equal(got, direct.score(dp, rows))
        np.testing.assert_allclose(got, js.score(jp, rows), rtol=1e-5,
                                   atol=1e-6)


# --- the loader knobs ----------------------------------------------------------

@pytest.fixture(scope="module")
def part_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("surface")
    path = d / "train.libsvm"
    path.write_text(synth_libsvm_text(n_rows=640, n_feat=300,
                                      nnz_per_row=8, seed=2))
    return str(path)


def _linear_pass(part_file, monkeypatch, feed):
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    monkeypatch.setenv("WH_NUM_LOADERS", "1")
    monkeypatch.setenv("WH_DEVICE_FEED", feed)
    cfg = LinearConfig(train_data=part_file, val_data=part_file,
                       algo="ftrl", lambda_l1=1.0, lr_eta=0.2,
                       minibatch=128, num_buckets=1 << 12, max_data_pass=2,
                       num_parts_per_file=2)
    lrn = LinearLearner(cfg, device="cpu")
    sol = MinibatchSolver(lrn, cfg, verbose=False)
    assert sol.device_feed == (feed == "1")
    res = sol.run()
    return res["val"].mean("logloss"), {
        k: v.numpy() for k, v in lrn.store.state.items()}


def test_device_feed_off_stages_on_the_main_thread_same_model(
        part_file, monkeypatch):
    """WH_DEVICE_FEED=0 moves stage_batch from the loader to the main
    thread: the same batches in the same order, the same model bit for
    bit and the same validation logloss."""
    from wormhole_tpu_torch.models.linear import LinearLearner

    staged_on = []
    orig = LinearLearner.stage_batch

    def spy(self, b, train=True):
        import threading
        if self._prepared(b)[0] != "staged":  # a step re-asks a staged one
            staged_on.append(threading.current_thread() is
                             threading.main_thread())
        return orig(self, b, train=train)

    monkeypatch.setattr(LinearLearner, "stage_batch", spy)
    ll_on, on = _linear_pass(part_file, monkeypatch, "1")
    assert staged_on and not any(staged_on)
    staged_on.clear()
    ll_off, off = _linear_pass(part_file, monkeypatch, "0")
    assert staged_on and all(staged_on)
    assert ll_on == ll_off
    for k in on:
        assert np.array_equal(on[k], off[k]), k


@pytest.mark.parametrize("pin,adaptive,want", [
    (None, None, True), ("2", None, False), ("2", "1", True),
    (None, "0", False), ("3", "0", False)])
def test_adaptive_loaders_knob_matches_jax(pin, adaptive, want, monkeypatch):
    """A pinned WH_NUM_LOADERS turns the controller off unless
    WH_ADAPTIVE_LOADERS=1; WH_ADAPTIVE_LOADERS=0 turns it off unpinned:
    the same decision as the JAX solver's."""
    from wormhole_tpu.models.linear import LinearConfig as JLin
    from wormhole_tpu.models.linear import LinearLearner as JLearner
    from wormhole_tpu.solver.minibatch_solver import MinibatchSolver as JSol
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    for name, val in (("WH_NUM_LOADERS", pin), ("WH_ADAPTIVE_LOADERS",
                                                adaptive)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    kw = dict(num_buckets=1 << 10, minibatch=128)
    t = MinibatchSolver(LinearLearner(LinearConfig(**kw), device="cpu"),
                        LinearConfig(**kw), verbose=False)
    j = JSol(JLearner(JLin(**kw)), JLin(**kw), verbose=False)
    assert (t.controller is not None) == (j.controller is not None) == want
    assert t.num_loaders == j.num_loaders
    if want:
        assert t.controller.n == j.controller.n == t.num_loaders
