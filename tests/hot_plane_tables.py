"""Subprocess body for tests/test_torch_hot_plane.py (not pytest-collected).

Trains the JAX package's learner under its hot parameter plane exactly as
tests/hot_plane_check.py does (its build_learner and train, on a forced
4-device CPU mesh of two model shards, a two-shard in-process TCP cold
tier), and writes the learner's initial tables, its final tables and the
cold tier's tables after the last flush to one npz per kind, so the
port's hot plane can be held against them at the learner bar.

The driver sets JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=4 before jax imports.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hot_plane_check import build_learner, state_of, train  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["linear", "difacto"],
                    required=True)
    ap.add_argument("--max-delay", type=int, default=1)
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    from wormhole_tpu.parallel.hot_plane import HotPlane
    from wormhole_tpu.parallel.mesh import make_mesh
    from wormhole_tpu.runtime.ps_server import PSClient, ServerNode

    mesh = make_mesh(num_model=2)
    lrn = build_learner(args.model, mesh, args.max_delay)
    np.savez(args.out + "-init.npz", **state_of(lrn))
    nodes = [ServerNode(r, 2) for r in range(2)]
    for nd in nodes:
        nd.serve()
    client = PSClient([nd.uri for nd in nodes], sender="worker-0")
    lrn.track_touched = hasattr(lrn, "collect_touched")
    store = getattr(lrn, "ckpt_store", None) or lrn.store
    plane = HotPlane(
        store, client, max_delay=args.max_delay,
        derived=getattr(lrn, "derived_tables", dict)(),
        touched_fn=getattr(lrn, "collect_touched", None))
    plane.init()
    try:
        train(args.data, lrn, plane)
        np.savez(args.out + "-final.npz", **state_of(lrn))
        np.savez(args.out + "-cold.npz", **client.pull())
    finally:
        client.close()
        for nd in nodes:
            nd.stop()
    ws = plane.wire_stats()
    print(f"hot_plane_tables ok: hot_steps={ws['hot_steps']} "
          f"flushes={ws['flushes']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
