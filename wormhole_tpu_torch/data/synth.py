"""Synthetic workloads of the repo bench: Criteo-shaped minibatches, and
HIGGS-shaped dense rows for the GBDT learner (synth_higgs, below).

Rows carry 39 features (13 integer + 26 categorical, criteo_parser.h:
55-82) drawn Zipf(1.2) within each field over per-field cardinalities
from ~10 to ~10M, field-salted and 64-bit mixed, then hashed into the
bucket table. Key skew matters: it sets how many unique keys and how
long the hot-key runs a batch has. The same seed gives the same batch as
the JAX package's bench (bench.py synth_criteo_batch).
"""

from __future__ import annotations

import numpy as np

FIELD_CARDS = [50] * 13 + [
    10, 100, 1000, 10_000, 100_000, 1_000_000, 10_000_000,
    25, 250, 2500, 25_000, 250_000, 2_500_000,
    40, 400, 4000, 40_000, 400_000, 4_000_000,
    60, 600, 6000, 60_000, 600_000,
    80, 800,
]
assert len(FIELD_CARDS) == 39


def synth_criteo_batch(rng, minibatch: int, num_buckets: int):
    """(seg, idx, val, label, mask) of one minibatch in COO form: row ids,
    bucket ids, all-ones values, 0/1 labels (30% positive), all-ones
    row mask."""
    nnz = len(FIELD_CARDS)
    vals = np.empty((minibatch, nnz), dtype=np.uint64)
    with np.errstate(over="ignore"):  # 64-bit mixing wraps by design
        for f, card in enumerate(FIELD_CARDS):
            draw = rng.zipf(1.2, size=minibatch).astype(np.uint64) % card
            x = draw + np.uint64(f) * np.uint64(0x9E3779B97F4A7C15)
            x ^= x >> np.uint64(30)
            x *= np.uint64(0xBF58476D1CE4E5B9)
            x ^= x >> np.uint64(27)
            vals[:, f] = x
    idx = (vals.reshape(-1) % np.uint64(num_buckets)).astype(np.int32)
    seg = np.repeat(np.arange(minibatch, dtype=np.int32), nnz)
    val = np.ones(minibatch * nnz, dtype=np.float32)
    label = (rng.random(minibatch) < 0.3).astype(np.float32)
    mask = np.ones(minibatch, dtype=np.float32)
    return seg, idx, val, label, mask


def synth_higgs(rng, rows: int, dim: int = 28):
    """(X, y): `rows` dense rows of `dim` standard-normal f32 features and
    0/1 f32 labels that depend on the first four features plus noise, the
    HIGGS-shaped data of the repo bench (bench.py bench_gbdt). The same
    generator state gives the same arrays as the bench's recipe."""
    X = rng.standard_normal((rows, dim)).astype(np.float32)
    y = X[:, :4].sum(axis=1) + 0.5 * rng.standard_normal(rows) > 0
    return X, y.astype(np.float32)
