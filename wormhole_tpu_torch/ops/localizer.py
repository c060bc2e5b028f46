"""Localizer: compact a minibatch's arbitrary uint64 keys to dense ids.

The reference's Localize (learn/base/localizer.h:98-221) as sort + unique
+ remap with numpy: the sorted unique keys, their occurrence counts, and
each nonzero's position in the unique list.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Localized:
    uniq_keys: np.ndarray   # uint64[n_uniq], sorted ascending
    counts: np.ndarray      # int32[n_uniq] occurrences in the block
    local_index: np.ndarray  # int32[nnz] positions into uniq_keys


def localize(block_index: np.ndarray) -> Localized:
    """Map raw keys to [0, n_uniq)."""
    keys = np.ascontiguousarray(block_index, dtype=np.uint64)
    uniq, inv, counts = np.unique(keys, return_inverse=True,
                                  return_counts=True)
    return Localized(uniq_keys=uniq, counts=counts.astype(np.int32),
                     local_index=inv.astype(np.int32).reshape(-1))
