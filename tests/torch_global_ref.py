"""Launch and reference helpers of the global-mesh tests
(tests/test_torch_global_*.py).

`launch_global` runs `python -m wormhole_tpu_torch.launcher.dmlc_tpu -n N
-s 0 -- python -m wormhole_tpu_torch.apps.APP ... global_mesh=1
device=cpu` in a session of its own under a timeout, killing the whole
process group when it runs out, and checks the workers' and the
scheduler's exit lines. `global_blocks` makes the reference's batches: the
global batches the launch's ranks step through, each the ranks' local
blocks in rank order (apps/_runner.py _global_train), concatenated into
one RowBlock of the JAX package, to step its single-device learner over.
"""

import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

from wormhole_tpu.data.minibatch import MinibatchIter as JIter
from wormhole_tpu.data.rowblock import RowBlock
from wormhole_tpu.parallel.multihost import rank_parts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 120


class Env:
    """The rank / world of a launch's worker (multihost.rank_parts)."""

    def __init__(self, rank: int, num_workers: int):
        self.rank, self.num_workers = rank, num_workers


def launch_global(app: str, n: int, args, timeout=LAUNCH_TIMEOUT) -> dict:
    """One global-mesh launch; fails unless it exits 0, each of the n
    workers prints its [global-worker] line on gloo and the CPU, and the
    scheduler opened no CUDA context. Returns the output and the workers'
    records by rank."""
    cmd = [sys.executable, "-m", "wormhole_tpu_torch.launcher.dmlc_tpu",
           "-n", str(n), "-s", "0", "--node-timeout", "10", "--",
           sys.executable, "-m", f"wormhole_tpu_torch.apps.{app}",
           *[str(a) for a in args], "global_mesh=1", "device=cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    env.pop("WORLD_SIZE", None)
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=REPO, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        pytest.fail(f"launch timed out after {timeout}s:\n{out[-3000:]}")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    assert p.returncode == 0, out[-4000:]
    workers = {w["rank"]: w for w in (
        json.loads(m) for m in re.findall(r"\[global-worker\] (\{.*\})",
                                          out))}
    assert sorted(workers) == list(range(n)), out[-3000:]
    for w in workers.values():
        assert (w["backend"], w["device"]) == ("gloo", "cpu"), w
        assert w["allreduce_calls"] > 0, w
    assert re.findall(r"\[scheduler\] cuda context: (.+)", out) == \
        ["none"], out[-3000:]
    return {"out": out, "workers": workers}


def concat_blocks(blocks) -> RowBlock:
    """Rows of the blocks one after the other, as one RowBlock."""
    offs, base = [np.zeros(1, np.int64)], 0
    for b in blocks:
        offs.append(b.offset[1:].astype(np.int64) + base)
        base += int(b.offset[-1])
    ones = [b.value if b.value is not None
            else np.ones(len(b.index), np.float32) for b in blocks]
    return RowBlock(label=np.concatenate([b.label for b in blocks]),
                    offset=np.concatenate(offs),
                    index=np.concatenate([b.index for b in blocks]),
                    value=np.concatenate(ones).astype(np.float32),
                    weight=None)


def rank_blocks(pattern: str, nparts: int, rank: int, world: int,
                local_rows: int, fmt: str = "libsvm", **kw) -> list:
    """Rank `rank`'s local blocks, in the order it feeds them."""
    return [blk for f, k in rank_parts(pattern, nparts, Env(rank, world))
            for blk in JIter(f, k, nparts, fmt, minibatch_size=local_rows,
                             **kw)]


def global_blocks(pattern: str, nparts: int, world: int, local_rows: int,
                  **kw) -> list:
    """The global batches of a pass: step s joins each rank's s-th block
    (a drained rank adds none)."""
    per = [rank_blocks(pattern, nparts, r, world, local_rows, **kw)
           for r in range(world)]
    steps = max(len(p) for p in per)
    return [concat_blocks([p[s] for p in per if s < len(p)])
            for s in range(steps)]


def final_val(out: str) -> tuple:
    m = re.search(r"final val: logloss=([0-9.]+) auc=([0-9.]+)", out)
    assert m, out[-3000:]
    return float(m.group(1)), float(m.group(2))


def step_passes(lrn, train: str, val: str, nparts: int, world: int,
                local_rows: int, passes: int) -> dict:
    """A JAX learner stepped as the launch's ranks step: each pass trains
    on the global batches (seed = the pass), then evaluates the val
    file's; returns the last val pass's mean logloss and AUC."""
    for dp in range(passes):
        for blk in global_blocks(train, nparts, world, local_rows, seed=dp):
            lrn.train_batch(blk)
        tot = {}
        for blk in global_blocks(val, nparts, world, local_rows, seed=dp):
            for k, v in lrn.eval_batch(blk).items():
                tot[k] = tot.get(k, 0.0) + float(v)
    n = max(tot["nex"], 1.0)
    return {"logloss": tot["logloss"] / n, "auc": tot["auc"] / n}


def predict_files(lrn, pattern: str, nparts: int, world: int,
                  local_rows: int) -> dict:
    """{(rank, part j): margins} the launch's predict must write to
    `{predict_out}_rank-R_part-J`: the learner's margins of each rank's
    rows of its j-th part, in order."""
    out = {}
    for r in range(world):
        for j, (f, k) in enumerate(rank_parts(pattern, nparts,
                                              Env(r, world))):
            got = [lrn.predict_batch(blk) for blk in JIter(
                f, k, nparts, minibatch_size=local_rows)]
            out[(r, j)] = (np.concatenate(got) if got
                           else np.zeros(0, np.float32))
    return out


def check_predict_files(base: str, want: dict) -> None:
    """Each `{base}_rank-R_part-J` file holds the expected margins (printed
    %.6g: rtol 1e-4 / atol 1e-5)."""
    for (r, j), m in want.items():
        got = np.loadtxt(f"{base}_rank-{r}_part-{j}", ndmin=1)
        assert got.shape == m.shape, (r, j, got.shape, m.shape)
        np.testing.assert_allclose(got, m, rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {r} part {j}")
