"""DiFacto through the PS plane of both packages, on the CPU, at the
configuration of chip_smoke.py's [ps] DiFacto launches: w over 2^22
buckets, V over 2^20 rows, dim 8, threshold 2, lambda_l1 1, lr_eta 0.1,
the [e2e] 2^22 file (8 minibatches of 65,536 synthetic Criteo rows, 4
parts, one pass), a 65,536-row val file, max_delay 2. Prints the val
logloss of the port's single-process run and of `-n 1 -s 1` and `-n 2
-s 2` launches (sync and async) through each package's launcher, one
JSON line a run.

  python tests/torch_ps_reference.py [WORKDIR]

The synthetic labels carry no signal (30% positive at random), so the
val logloss measures how far each run overfits; the -n 2 runs add two
workers' steps at the same hot keys between syncs. Takes ~6 minutes and
a few GB of host memory.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs

    d = argv[0] if argv else tempfile.mkdtemp(prefix="ps-ref-")
    os.makedirs(d, exist_ok=True)
    train, val = os.path.join(d, "e2e.libsvm"), os.path.join(d, "val.libsvm")
    cs.write_libsvm(train, cs.DENSE_BUCKETS, cs.E2E_BATCHES * cs.MINIBATCH,
                    62)
    cs.write_libsvm(val, cs.DENSE_BUCKETS, cs.MINIBATCH, 63)
    conf = cs.write_ps_conf(os.path.join(d, "fm.conf"), {
        "train_data": train, "val_data": val, "algo": "ftrl",
        "lambda_l1": 1, "lr_eta": 0.1, "minibatch": cs.MINIBATCH,
        "nnz_per_row": cs.NNZ_PER_ROW, "num_buckets": cs.DENSE_BUCKETS,
        "v_buckets": cs.V_BUCKETS, "dim": cs.FM_DIM, "threshold": 2,
        "num_parts_per_file": cs.E2E_PARTS, "max_data_pass": 1,
        "max_delay": cs.PS_MAX_DELAY, "print_sec": 3600})
    t = time.perf_counter()
    single = cs.ps_single("difacto", conf, torch.device("cpu"), loaders=1)
    print(json.dumps({"run": "port single", "val_logloss":
                      single["val_logloss"],
                      "s": round(time.perf_counter() - t)}), flush=True)
    for pkg, extra in (("wormhole_tpu_torch", ["device=cpu",
                                               "kernel=pallas"]),
                       ("wormhole_tpu", [])):
        for n, s, async_sync in ((1, 1, "0"), (2, 2, "0"), (2, 2, "1")):
            env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                       WH_ASYNC_SYNC=async_sync, WH_KEYCACHE=async_sync)
            p = subprocess.run(
                [sys.executable, "-m", f"{pkg}.launcher.dmlc_tpu", "-n",
                 str(n), "-s", str(s), "--", sys.executable, "-m",
                 f"{pkg}.apps.difacto", conf, *extra],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=3000, start_new_session=True)
            m = re.search(r"final val: logloss=([0-9.]+) auc=([0-9.]+)",
                          p.stdout)
            if p.returncode != 0 or m is None:
                print(p.stdout[-3000:], p.stderr[-3000:], file=sys.stderr)
                return 1
            print(json.dumps({"run": f"{pkg} -n {n} -s {s}",
                              "async_sync": int(async_sync),
                              "val_logloss": float(m.group(1)),
                              "val_auc": float(m.group(2)),
                              "s": round(time.perf_counter() - t)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
