"""One in-process linear FTRL run of a package's MinibatchSolver under
WH_OBS_DIR, in a process of its own (each package's tracer starts at its
import, and each registry is process-wide), for the obs parity tests:

  python tests/torch_obs_solver_run.py {wormhole_tpu|wormhole_tpu_torch} DATA OBS_DIR

The caller sets WH_OBS_DIR=OBS_DIR (and JAX_PLATFORMS=cpu for the JAX
package). Prints one JSON line: the trace's span names with their
counts, the run report's top-level keys, its counters and its
train.stage.* histogram counts."""

import collections
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MINIBATCH = 64
NUM_BUCKETS = 1 << 9
NNZ_PER_ROW = 8


def main(pkg: str, data: str, obs_dir: str) -> int:
    linear = importlib.import_module(f"{pkg}.models.linear")
    solver = importlib.import_module(f"{pkg}.solver.minibatch_solver")
    trace = importlib.import_module(f"{pkg}.obs.trace")
    cfg = linear.LinearConfig(train_data=data, data_format="libsvm",
                              minibatch=MINIBATCH, num_buckets=NUM_BUCKETS,
                              nnz_per_row=NNZ_PER_ROW, algo="ftrl",
                              max_data_pass=1, max_concurrency=1)
    if pkg == "wormhole_tpu":
        from wormhole_tpu.parallel.mesh import make_mesh

        lrn = linear.LinearLearner(cfg, make_mesh(1, 1))
    else:
        lrn = linear.LinearLearner(cfg, device="cpu")
    solver.MinibatchSolver(lrn, cfg, verbose=False).run()
    trace.ACTIVE.close()
    traces = [f for f in os.listdir(obs_dir) if f.startswith("trace-")]
    spans = collections.Counter()
    for f in traces:
        for line in open(os.path.join(obs_dir, f)):
            rec = json.loads(line)
            if rec.get("ph") == "X":
                spans[rec["name"]] += 1
    report = json.load(open(os.path.join(obs_dir, "run_report.json")))
    print(json.dumps({
        "traces": len(traces), "spans": dict(spans),
        "report_keys": sorted(report), "counters": report["counters"],
        "stage_counts": {k: v["count"] for k, v in report["hists"].items()
                         if k.startswith("train.stage.")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
