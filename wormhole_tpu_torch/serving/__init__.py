"""Online serving tier: predict-as-a-service over training snapshots.

Shards (``ModelServer``) each hold one ``shard_range`` slice of a
``write_snapshot_set`` snapshot set, hot-swap to newer versions the
moment the manifest says they are complete, and answer row-fetch and
score RPCs. A ``Router`` fans a batch out over the shards: in fetch
mode it gathers the batch's unique rows and scores on the reassembled
compact tables with a model scorer, on the card unless the scorer was
given ``device="cpu"``; in score mode the shards return partial
products the router folds on the host. Both are bit-identical on the
CPU to the trainer's own predict path (DiFacto's score mode to a few
ulp). ``run_serve_role`` is the launcher's ``--serve`` role: a shard
that registers with the scheduler and lives until the job shuts down.
"""

from wormhole_tpu_torch.serving.router import Router
from wormhole_tpu_torch.serving.scoring import (
    DifactoScorer, LinearScorer, PackedBatch,
)
from wormhole_tpu_torch.serving.server import (
    ModelServer, ServingModel, load_with_retry, run_serve_role,
)

__all__ = [
    "DifactoScorer",
    "LinearScorer",
    "ModelServer",
    "PackedBatch",
    "Router",
    "ServingModel",
    "load_with_retry",
    "run_serve_role",
]
