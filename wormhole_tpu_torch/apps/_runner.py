"""Shared app runner: conf parsing, the ranks of a launch, and the solver.

The reference's `app.dmlc conf k=v` convention (arg_parser.h:36-45): an
optional conf file as the first argument, then `key=value` overrides.
One more key, `device=` (default `cuda`), picks the torch device; it is
taken off before the learner's config is built, so conf files stay the
same as the JAX package's.

Under `torch.distributed.run` (WORLD_SIZE, RANK and LOCAL_RANK in the
environment) an app that runs on a mesh (linear, gbdt) is one rank: it
joins the process group (NCCL on `cuda:LOCAL_RANK`, gloo with
`device=cpu`) and builds its mesh over all the ranks. The other apps
refuse several ranks until their slices. Without WORLD_SIZE every app runs
one process on one device.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch
import torch.distributed as dist

from wormhole_tpu_torch.config import load_config
from wormhole_tpu_torch.device import resolve_device
from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver


def parse_cli(cls, argv, ranks: bool = False):
    """(config, device) from `[conf] key=value ...`. Raises under a launch
    of several ranks unless the app runs on a mesh (`ranks`)."""
    if not ranks and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            f"{cls.__name__} runs on one device; several ranks wait for its "
            f"multi-GPU slice (ROADMAP.md Queue A)")
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


@contextlib.contextmanager
def ranks_of_launch(device):
    """This rank's device inside its process group, under a launch that
    set WORLD_SIZE: `cuda:LOCAL_RANK` with NCCL, or the CPU with gloo
    when `device` is the CPU. Without WORLD_SIZE, `device` as it is and
    no group."""
    if "WORLD_SIZE" not in os.environ:
        yield device
        return
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(
            torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", world_size=world,
                            rank=rank)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def run_minibatch_app(cfg, make_learner, device="cuda") -> dict:
    """Build the learner on `device` and run the solver over cfg's data."""
    return MinibatchSolver(make_learner(cfg, device), cfg).run()


def app_main(cls, make_learner, argv=None, ranks: bool = False) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_cli(cls, argv, ranks)
    with ranks_of_launch(device) as device:
        run_minibatch_app(cfg, make_learner, device)
    return 0
