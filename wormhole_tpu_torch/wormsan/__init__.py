"""wormsan: the port's default-off runtime concurrency sanitizer.

Arm with ``WH_SAN=1``: wormhole_tpu_torch/__init__.py installs the hooks
at import, before any submodule creates a lock. Three detectors, as in
the JAX package's ``tools/wormsan``: lock acquisition-order cycles,
blocking calls under registry-known locks, and a sampled Eraser-style
lockset race pass over the shared-state model that wormlint's
lock-discipline checker infers over ``wormhole_tpu_torch/``
(``shared_state_model`` in tools/wormlint/locks.py).

Knobs: ``WH_SAN`` (arm), ``WH_SAN_SAMPLE`` (race-check 1-in-N writes),
``WH_SAN_DUMP_DIR`` (``san-<pid>.jsonl`` finding dumps; replay with
``python -m wormhole_tpu_torch.wormsan <dir>``). ``python -m
wormhole_tpu_torch.wormsan --selftest`` proves each detector fires on a
seeded fixture. A process arms one sanitizer: one that imports both
packages under ``WH_SAN=1`` would arm both.
"""

from __future__ import annotations

from .core import (DETECTORS, ENV_DUMP_DIR, ENV_ENABLE, ENV_SAMPLE, SanLock,
                   SanRLock, enabled, env_enabled, findings, install,
                   instrument_classes, instrumented, load_model, reset,
                   summary, watch_class)

__all__ = ["DETECTORS", "ENV_DUMP_DIR", "ENV_ENABLE", "ENV_SAMPLE",
           "SanLock", "SanRLock", "enabled", "env_enabled", "findings",
           "install", "instrument_classes", "instrumented", "load_model",
           "reset", "summary", "watch_class"]
