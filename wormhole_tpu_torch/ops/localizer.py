"""Localizer: compact a minibatch's arbitrary uint64 keys to dense ids.

The reference's Localize (learn/base/localizer.h:98-221) as sort + unique
+ remap: the sorted unique keys, their occurrence counts, and each
nonzero's position in the unique list. The unique runs on the device the
caller names (native.unique: np.unique on the CPU, torch.unique on the
card), with the same bytes either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from wormhole_tpu_torch import native


@dataclasses.dataclass
class Localized:
    uniq_keys: np.ndarray   # uint64[n_uniq], sorted ascending
    counts: np.ndarray      # int32[n_uniq] occurrences in the block
    local_index: np.ndarray  # int32[nnz] positions into uniq_keys


def localize(block_index: np.ndarray, device=None) -> Localized:
    """Map raw keys to [0, n_uniq), on `device` (None: the CPU)."""
    keys = np.ascontiguousarray(block_index, dtype=np.uint64)
    uniq, inv, counts = native.unique(keys, device)
    return Localized(uniq_keys=uniq, counts=counts.astype(np.int32),
                     local_index=inv.astype(np.int32).reshape(-1))
