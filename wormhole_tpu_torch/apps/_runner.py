"""Shared app runner: conf parsing and the single-process solver.

The reference's `app.dmlc conf k=v` convention (arg_parser.h:36-45): an
optional conf file as the first argument, then `key=value` overrides.
One more key, `device=` (default `cuda`), picks the torch device; it is
taken off before the learner's config is built, so conf files stay the
same as the JAX package's.
"""

from __future__ import annotations

import sys

from wormhole_tpu_torch.config import load_config
from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver


def parse_cli(cls, argv):
    """(config, device) from `[conf] key=value ...`."""
    conf = None
    rest = list(argv)
    if rest and "=" not in rest[0]:
        conf = rest.pop(0)
    device = "cuda"
    kept = []
    for tok in rest:
        if tok.split("=", 1)[0].strip().lstrip("-") == "device":
            device = tok.split("=", 1)[1].strip()
        else:
            kept.append(tok)
    return load_config(cls, conf_file=conf, argv=kept), device


def run_minibatch_app(cfg, make_learner, device="cuda") -> dict:
    """Build the learner on `device` and run the solver over cfg's data."""
    return MinibatchSolver(make_learner(cfg, device), cfg).run()


def app_main(cls, make_learner, argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_cli(cls, argv)
    run_minibatch_app(cfg, make_learner, device)
    return 0
