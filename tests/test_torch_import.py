"""The PyTorch/CUDA port stands alone: it imports neither JAX nor anything
of the JAX package wormhole_tpu (whose name is a prefix of the port's, so
every check matches `wormhole_tpu` and `wormhole_tpu.` exactly)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "wormhole_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_BLOCKED = ("jax", "jaxlib", "wormhole_tpu")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in _BLOCKED)


_PROBE = r'''
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "wormhole_tpu")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import wormhole_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    wormhole_tpu_torch.__path__, "wormhole_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules if blocked(m))
assert not bad, bad
print(len(names))
'''


def test_port_imports_with_jax_and_jax_package_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _blocked(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_package(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    visible card, and when it stands in a directory without the port."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, cwd=str(script.parent),
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_blocked_name_matching_is_exact():
    assert _blocked("wormhole_tpu") and _blocked("wormhole_tpu.ops")
    assert _blocked("jax") and _blocked("jax.numpy")
    assert not _blocked("wormhole_tpu_torch")
    assert not _blocked("wormhole_tpu_torch.ops.coo_kernels")
    assert not _blocked("jaxtyping")


def test_scan_covers_the_native_core():
    """The host data path's core (native.py, the counterpart of the JAX
    package's native/) is among the sources scanned above and the
    modules the probe imports with JAX blocked."""
    assert PORT / "native.py" in SOURCES
    assert PORT / "data" / "parsers.py" in SOURCES


def test_scan_covers_the_batch_learners():
    """k-means, L-BFGS, their objectives and their apps are among the
    sources scanned and the modules the probe imports."""
    for rel in ("models/kmeans.py", "models/batch_objectives.py",
                "solver/lbfgs.py", "apps/kmeans.py", "apps/lbfgs_linear.py",
                "apps/lbfgs_fm.py"):
        assert PORT / rel in SOURCES


def test_scan_covers_the_loader_plane():
    """The metrics registry, the epoch pack cache, the prefetching
    MinibatchIter and the solver are among the sources scanned and the
    modules the probe imports."""
    for rel in ("obs/metrics.py", "data/pack_cache.py", "data/minibatch.py",
                "solver/minibatch_solver.py"):
        assert PORT / rel in SOURCES


def test_scan_covers_the_mesh():
    """The device mesh, its collectives and the sharded store are among
    the sources scanned and the modules the probe imports with JAX
    blocked."""
    for rel in ("parallel/mesh.py", "parallel/collectives.py",
                "parallel/kvstore.py", "apps/_runner.py"):
        assert PORT / rel in SOURCES


def test_scan_covers_the_data_formats():
    """The hashing, the crb reader and writer and the convert app are
    among the sources scanned and the modules the probe imports with JAX
    blocked."""
    for rel in ("ops/hashing.py", "data/crb.py", "data/synth.py",
                "apps/convert.py"):
        assert PORT / rel in SOURCES


def test_scan_covers_the_serving_tier():
    """The serving tier and the wire, retry, overload, fault, manifest
    and obs modules beneath it are among the sources scanned and the
    modules the probe imports with JAX blocked."""
    for rel in ("serving/scoring.py", "serving/fastpath.py",
                "serving/server.py", "serving/router.py", "runtime/net.py",
                "runtime/retry.py", "runtime/overload.py",
                "runtime/faults.py", "utils/manifest.py", "obs/flight.py",
                "obs/trace.py", "obs/pyprof.py"):
        assert PORT / rel in SOURCES


def test_scan_covers_the_ps_plane():
    """The scheduler, the PS servers and SyncedStore, their journal, the
    launcher, the pool and the obs modules they report through are among
    the sources scanned and the modules the probe imports."""
    for rel in ("runtime/tracker.py", "runtime/ps_server.py",
                "runtime/sched_journal.py", "launcher/dmlc_tpu.py",
                "solver/workload.py", "obs/prom.py", "obs/slo.py",
                "obs/report.py", "utils/perf.py"):
        assert PORT / rel in SOURCES


def test_scan_covers_the_bsp_plane():
    """The BSP ring, the host part of multihost.py and the metric-name
    registry are among the sources scanned and the modules the probe
    imports with JAX blocked."""
    for rel in ("runtime/allreduce.py", "parallel/multihost.py",
                "obs/names.py"):
        assert PORT / rel in SOURCES


def test_ps_plane_host_modules_import_no_torch():
    """The roles that never touch the card (scheduler, servers, launcher)
    and the BSP ring run on modules that import neither torch nor JAX."""
    probe = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import wormhole_tpu_torch.runtime.allreduce\n"
        "import wormhole_tpu_torch.obs.names\n"
        "import wormhole_tpu_torch.runtime.tracker\n"
        "import wormhole_tpu_torch.runtime.ps_server\n"
        "import wormhole_tpu_torch.launcher.dmlc_tpu\n"
        "import wormhole_tpu_torch.solver.workload\n"
        "import wormhole_tpu_torch.obs.report\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'wormhole_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr


def test_scan_covers_the_last_modules():
    """The hot plane, the URI filesystem layer and match_file are among
    the sources scanned and the modules the probe imports with JAX
    blocked."""
    for rel in ("parallel/hot_plane.py", "data/filesys.py",
                "data/match_file.py", "__init__.py"):
        assert PORT / rel in SOURCES


def test_scheduler_file_matching_imports_no_torch():
    """The scheduler matches files through data/match_file.py and
    data/filesys.py: importing them, and the pool that re-exports
    match_file, pulls in neither torch nor JAX."""
    probe = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import wormhole_tpu_torch.data.filesys\n"
        "import wormhole_tpu_torch.data.match_file\n"
        "from wormhole_tpu_torch.solver.workload import match_file\n"
        "from wormhole_tpu_torch.data.match_file import match_file as m\n"
        "assert match_file is m\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'wormhole_tpu'))\n"
        "assert not bad, bad\n"
        "from wormhole_tpu_torch.data import MinibatchIter, RowBlock\n"
        "assert 'torch' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
