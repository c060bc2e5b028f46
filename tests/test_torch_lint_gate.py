"""The lint gate over the port: `python -m tools.wormlint
wormhole_tpu_torch --json`, run from the repo root as a developer runs
it, reports no finding outside the baseline and no parse error, as
tests/test_lint_gate.py holds the JAX package's roots. The baseline
(tools/wormlint/baseline.json) stays as it is: a finding in the port is
fixed in the port, not baselined. And the port's stack dump:
WORMHOLE_STACKDUMP=1 at import registers faulthandler on SIGUSR1 for
all threads, as the JAX package's __init__ does."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "tools.wormlint", *args, "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    return proc, json.loads(proc.stdout)


def test_port_is_lint_clean():
    proc, report = _lint("wormhole_tpu_torch")
    assert proc.returncode == 0, \
        f"wormlint found new issues in the port:\n{proc.stdout}\n{proc.stderr}"
    assert report["new"] == []
    assert report["parse_errors"] == []
    assert report["files_scanned"] > 70  # the scan covered the package
    assert report["stale_baseline"] == []


def test_port_lint_runs_without_the_baseline():
    """Clean with the baseline ignored too: nothing of the port hides
    behind a baseline entry."""
    proc, report = _lint("wormhole_tpu_torch", "--no-baseline")
    assert proc.returncode == 0 and report["findings"] == [], report


def test_port_lint_sees_an_undeclared_knob(tmp_path):
    """The gate is not vacuous: a port module that reads an undeclared
    WH_* knob is a finding."""
    stray = tmp_path / "stray.py"
    stray.write_text('import os\nos.environ.get("WH_NOT_A_KNOB")\n')
    proc, report = _lint("wormhole_tpu_torch", str(stray))
    assert proc.returncode == 1
    assert [f["key"] for f in report["new"]] == ["undeclared:WH_NOT_A_KNOB"]


_DUMP = r'''
import os, signal, sys, threading, time
sys.path.insert(0, sys.argv[1])
import wormhole_tpu_torch  # noqa: F401  (installs the handler)
ready = threading.Event()
def parked_worker():
    ready.set()
    time.sleep(30)
threading.Thread(target=parked_worker, name="parked", daemon=True).start()
ready.wait()
os.kill(os.getpid(), signal.SIGUSR1)
time.sleep(0.5)
print("alive")
'''


def test_stackdump_on_sigusr1():
    """With WORMHOLE_STACKDUMP=1 the import registers the dump: SIGUSR1
    prints every thread's stack to stderr and the process lives on.
    Without it, SIGUSR1 keeps its default action and ends the process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _DUMP, REPO],
                         env=dict(env, WORMHOLE_STACKDUMP="1"),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "alive", out.stderr
    assert "parked_worker" in out.stderr  # the other thread's frame
    assert "Current thread" in out.stderr
    bare = subprocess.run([sys.executable, "-c", _DUMP, REPO],
                          env=dict(env, WORMHOLE_STACKDUMP="0"),
                          capture_output=True, text=True, timeout=60)
    assert bare.returncode != 0 and "alive" not in bare.stdout
