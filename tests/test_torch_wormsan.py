"""The port's runtime sanitizer (wormhole_tpu_torch/wormsan), case for
case against tests/test_wormsan.py, and its shared-state model against
the JAX package's.

Every test that arms the sanitizer runs it in a subprocess that imports
the port and nothing of the JAX package: install() patches threading,
socket, queue and os process-wide and has no uninstall, and a process
that imported both packages under WH_SAN=1 would arm both sanitizers.
Each subprocess ends by asserting that neither ``jax`` nor
``wormhole_tpu`` was imported.
"""

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import sys as _s
assert not [m for m in _s.modules
            if m in ("jax", "wormhole_tpu") or m.startswith("jax.")
            or m.startswith("wormhole_tpu.")], "imported the JAX package"
"""


def _env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WH_SAN", "WH_SAN_DUMP_DIR", "WH_SAN_SAMPLE")}
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


def _run_py(code: str, env_extra: dict | None = None,
            timeout: float = 120.0) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code) + _NO_JAX],
        cwd=REPO, capture_output=True, text=True, env=_env(env_extra),
        timeout=timeout)


def _last_json(r):
    return json.loads(r.stdout.strip().splitlines()[-1])


# --- seeded fixtures: the selftest is the contract --------------------------

def test_selftest_detects_all_three_fixture_classes():
    r = subprocess.run(
        [sys.executable, "-m", "wormhole_tpu_torch.wormsan", "--selftest"],
        cwd=REPO, capture_output=True, text=True, env=_env(), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for det in ("order", "block", "race"):
        assert f"selftest[{det}]: PASS" in r.stdout, r.stdout


def test_lock_order_finding_carries_both_acquisition_stacks():
    r = _run_py("""
        import json
        from wormhole_tpu_torch import wormsan
        from wormhole_tpu_torch.wormsan import fixtures
        wormsan.install(instrument=False)
        fixtures.lock_order_cycle()
        fs = [f for f in wormsan.findings() if f["detector"] == "order"]
        print(json.dumps(fs))
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    fs = _last_json(r)
    assert len(fs) == 1
    f = fs[0]
    assert "fixtures.py" in f["message"]
    assert len(f["stacks"]) >= 2
    assert all("lock_order_cycle" in s for s in f["stacks"].values())


def test_blocking_send_finding_names_the_known_lock():
    r = _run_py("""
        import json
        from wormhole_tpu_torch import wormsan
        from wormhole_tpu_torch.wormsan import fixtures
        wormsan.install(instrument=False)
        fixtures.blocking_send_under_lock()
        fs = [f for f in wormsan.findings() if f["detector"] == "block"]
        print(json.dumps(fs))
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    fs = _last_json(r)
    assert len(fs) == 1
    assert "_Sender._lock" in fs[0]["message"]
    assert "socket.sendall" in fs[0]["message"]
    assert "blocking_send_under_lock" in fs[0]["stacks"]["call"]


def test_race_finding_has_transition_and_write_stacks():
    r = _run_py("""
        import json
        from wormhole_tpu_torch import wormsan
        from wormhole_tpu_torch.wormsan import fixtures
        wormsan.install(instrument=False)
        fixtures.unguarded_shared_write()
        fs = [f for f in wormsan.findings() if f["detector"] == "race"]
        print(json.dumps(fs))
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    fs = _last_json(r)
    assert len(fs) == 1
    f = fs[0]
    assert f["key"] == "race:_Shared.hits"
    assert "writer" in f["stacks"]["transition"]
    assert "writer" in f["stacks"]["write"]


# --- default-off and arming behavior ----------------------------------------

def test_off_by_default_nothing_is_patched():
    r = _run_py("""
        import threading, sys
        import wormhole_tpu_torch
        import wormhole_tpu_torch.obs.metrics
        assert type(threading.Lock()).__module__ == '_thread', \\
            type(threading.Lock())
        assert not any(m.startswith('wormhole_tpu_torch.wormsan')
                       for m in sys.modules)
        assert not any(m.startswith('tools') for m in sys.modules)
        from wormhole_tpu_torch.obs.metrics import Counter
        assert Counter.__setattr__ is object.__setattr__
        print('unpatched')
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "unpatched" in r.stdout


def test_wh_san_arms_at_package_import_and_instruments_model():
    """Armed at `import wormhole_tpu_torch`; a model module imported
    later is instrumented as it loads, and one never imported is not
    loaded by arming (the scheduler's imports stay free of torch)."""
    r = _run_py("""
        import json, sys, threading
        import wormhole_tpu_torch
        from wormhole_tpu_torch import wormsan
        assert wormsan.enabled()
        assert threading.Lock is wormsan.SanLock
        assert threading.RLock is wormsan.SanRLock
        assert 'wormhole_tpu_torch.runtime.ps_server' not in sys.modules
        assert 'torch' not in sys.modules
        from wormhole_tpu_torch.obs.metrics import Counter, REGISTRY
        assert Counter.__setattr__.__name__ == '_san_setattr'
        # a lock the module made at import is tagged registry-known
        assert REGISTRY._lock._known == 'Registry._lock'
        from wormhole_tpu_torch.runtime.ps_server import PSClient
        assert PSClient.__setattr__.__name__ == '_san_setattr'
        assert 'torch' not in sys.modules
        print(json.dumps(wormsan.instrumented()))
    """, env_extra={"WH_SAN": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    got = set(_last_json(r))
    assert {"wormhole_tpu_torch.obs.metrics:Counter",
            "wormhole_tpu_torch.obs.metrics:Registry",
            "wormhole_tpu_torch.runtime.ps_server:PSClient",
            "wormhole_tpu_torch.runtime.ps_server:ServerNode"} <= got


def test_clean_threaded_workload_produces_no_findings():
    r = _run_py("""
        import threading
        from wormhole_tpu_torch import wormsan
        wormsan.install(instrument=False)

        class Guarded:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
        wormsan.watch_class(Guarded, attrs=("n",), locks=("_lock",))
        g = Guarded()

        def work():
            for _ in range(200):
                with g._lock:
                    g.n += 1
        ts = [threading.Thread(target=work) for _ in range(4)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert g.n == 800
        assert wormsan.findings() == [], wormsan.findings()
        print('clean')
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean" in r.stdout


def test_wormsan_allow_comment_suppresses_at_runtime(tmp_path):
    mod = tmp_path / "allowmod.py"
    mod.write_text(textwrap.dedent("""
        import threading

        class Shared:
            def __init__(self):
                self.x = 0

        def hammer(obj):
            obj.x += 1  # wormsan: allow=race
    """))
    r = _run_py(f"""
        import sys, threading
        sys.path.insert(0, {str(tmp_path)!r})
        from wormhole_tpu_torch import wormsan
        wormsan.install(instrument=False)
        import allowmod
        wormsan.watch_class(allowmod.Shared, attrs=("x",))
        obj = allowmod.Shared()
        allowmod.hammer(obj)
        done = threading.Event()
        t = threading.Thread(target=lambda: (allowmod.hammer(obj),
                                             done.set()))
        t.start(); t.join()
        assert done.is_set()
        allowmod.hammer(obj)
        assert wormsan.findings() == [], wormsan.findings()
        print('suppressed')
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "suppressed" in r.stdout


def test_sampling_skips_most_race_checks():
    r = _run_py("""
        import threading
        from wormhole_tpu_torch import wormsan

        class Shared:
            def __init__(self):
                self.x = 0
        wormsan.install(instrument=False)
        wormsan.watch_class(Shared, attrs=("x",))
        obj = Shared()
        obj.x = 1
        t = threading.Thread(target=lambda: setattr(obj, 'x', 2))
        t.start(); t.join()
        assert wormsan.findings() == [], wormsan.findings()
        print('sampled-out')
    """, env_extra={"WH_SAN_SAMPLE": "1000000"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "sampled-out" in r.stdout


# --- reporting plumbing ------------------------------------------------------

def test_findings_dump_to_jsonl_and_replay_cli(tmp_path):
    dump = tmp_path / "san"
    r = _run_py("""
        from wormhole_tpu_torch import wormsan
        from wormhole_tpu_torch.wormsan import fixtures
        wormsan.install(instrument=False)
        fixtures.lock_order_cycle()
    """, env_extra={"WH_SAN_DUMP_DIR": str(dump)})
    assert r.returncode == 0, r.stdout + r.stderr
    files = list(dump.glob("san-*.jsonl"))
    assert len(files) == 1
    recs = [json.loads(x) for x in
            files[0].read_text().strip().splitlines()]
    assert recs and recs[0]["detector"] == "order"

    cli = [sys.executable, "-m", "wormhole_tpu_torch.wormsan"]
    replay = subprocess.run(cli + ["--stacks", str(dump)], cwd=REPO,
                            capture_output=True, text=True, env=_env(),
                            timeout=60)
    assert replay.returncode == 1  # findings exist -> nonzero verdict
    assert "order" in replay.stdout
    assert "lock_order_cycle" in replay.stdout  # stacks printed

    empty = tmp_path / "empty"
    empty.mkdir()
    replay0 = subprocess.run(cli + [str(empty)], cwd=REPO,
                             capture_output=True, text=True, env=_env(),
                             timeout=60)
    assert replay0.returncode == 0


def test_findings_feed_san_counters():
    r = _run_py("""
        from wormhole_tpu_torch import wormsan
        from wormhole_tpu_torch.wormsan import fixtures
        wormsan.install(instrument=False)
        fixtures.lock_order_cycle()
        from wormhole_tpu_torch.obs.metrics import REGISTRY
        wormsan.summary()  # drains any deferred counter bumps
        c = REGISTRY.snapshot()["counters"]
        assert c.get("san.findings", 0) >= 1, c
        assert c.get("san.order.cycles", 0) >= 1, c
        assert c.get("san.order.edges", 0) >= 1, c
        print('counted')
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "counted" in r.stdout


def test_shared_model_is_wormlints():
    """Static and dynamic share one model: the classes the port's
    sanitizer loads are exactly what shared_state_model infers over
    wormhole_tpu_torch/, computed from the repo root."""
    from tools.wormlint.core import load_files
    from tools.wormlint.locks import shared_state_model
    from wormhole_tpu_torch.wormsan import load_model

    here = os.getcwd()
    os.chdir(REPO)
    try:
        expect = shared_state_model(load_files(["wormhole_tpu_torch"]))
    finally:
        os.chdir(here)
    got = load_model()
    assert got == expect
    assert "wormhole_tpu_torch/obs/metrics.py" in got
    assert "wormhole_tpu_torch/runtime/tracker.py" in got


def test_overhead_smoke():
    """Armed lock traffic stays within a generous budget: a regression
    to pathological overhead (or a deadlock) fails or hangs quickly."""
    code = """
        import threading, time
        %s
        lk = threading.Lock()
        t0 = time.perf_counter()
        for _ in range(20000):
            with lk:
                pass
        print(time.perf_counter() - t0)
    """
    base = _run_py(code % "")
    armed = _run_py(code % (
        "from wormhole_tpu_torch import wormsan; "
        "wormsan.install(instrument=False)"))
    assert base.returncode == 0 and armed.returncode == 0, \
        base.stderr + armed.stderr
    t_base = float(base.stdout.strip().splitlines()[-1])
    t_armed = float(armed.stdout.strip().splitlines()[-1])
    assert t_armed < max(t_base * 60.0, 2.0), (t_base, t_armed)


def test_rlock_and_condition_survive_instrumentation():
    r = _run_py("""
        import threading
        from wormhole_tpu_torch import wormsan
        wormsan.install(instrument=False)
        rl = threading.RLock()
        with rl:
            with rl:
                pass
        cond = threading.Condition()
        results = []

        def waiter():
            with cond:
                while not results:
                    cond.wait(5.0)
                results.append('woke')
        t = threading.Thread(target=waiter)
        t.start()
        import time; time.sleep(0.05)
        with cond:
            results.append('go')
            cond.notify()
        t.join(5.0)
        assert results == ['go', 'woke'], results
        assert wormsan.findings() == [], wormsan.findings()
        print('cond-ok')
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "cond-ok" in r.stdout


def test_arming_without_the_model_says_so_and_stays_off(tmp_path):
    """Where tools/wormlint cannot be imported, WH_SAN=1 says so on
    stderr and leaves the process unpatched: no silent fallback."""
    code = textwrap.dedent("""
        import sys, threading
        sys.path = [p for p in sys.path if p not in ('', %r)]
        sys.path.insert(0, %r)
        import wormhole_tpu_torch
        assert type(threading.Lock()).__module__ == '_thread'
        print('off')
    """) % (REPO, str(tmp_path))
    # a copy of the package alone, without tools/ beside it
    import shutil
    shutil.copytree(os.path.join(REPO, "wormhole_tpu_torch"),
                    tmp_path / "wormhole_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    env = _env({"WH_SAN": "1"})
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, env=env, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "off" in r.stdout
    assert "[wormsan] WH_SAN=1 but the sanitizer cannot load" in r.stderr


# --- the lock model the port restored ----------------------------------------

#: classes of the JAX package's model whose port counterpart lacks an
#: attr the JAX class watches, with the reason (none today)
MODEL_EXCEPTIONS: dict[tuple[str, str], str] = {}


def _model(pkg):
    from tools.wormlint.core import load_files
    from tools.wormlint.locks import shared_state_model

    here = os.getcwd()
    os.chdir(REPO)
    try:
        return shared_state_model(load_files([pkg]))
    finally:
        os.chdir(here)


def test_port_model_covers_every_class_of_the_jax_model():
    """For each (path, class) of the JAX package's shared-state model,
    the port's model has the class at the same relative path, and its
    attrs include every JAX attr that the port's class assigns."""
    import ast

    jax_model, port_model = _model("wormhole_tpu"), _model(
        "wormhole_tpu_torch")
    assert sum(len(c) for c in jax_model.values()) >= 12
    for path, classes in jax_model.items():
        ppath = "wormhole_tpu_torch/" + path[len("wormhole_tpu/"):]
        tree = ast.parse(open(os.path.join(REPO, ppath)).read())
        for cls, spec in classes.items():
            if (path, cls) in MODEL_EXCEPTIONS:
                continue
            got = port_model.get(ppath, {}).get(cls)
            assert got is not None, (ppath, cls)
            node = next(n for n in ast.walk(tree)
                        if isinstance(n, ast.ClassDef) and n.name == cls)
            assigned = {t.attr for t in ast.walk(node)
                        if isinstance(t, ast.Attribute)
                        and isinstance(t.ctx, ast.Store)}
            want = set(spec["attrs"]) & assigned
            assert want <= set(got["attrs"]), (cls, want - set(got["attrs"]))
            assert set(spec["locks"]) <= set(got["locks"]), cls
