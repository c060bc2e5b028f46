"""RowBlock: the CSR minibatch container, and its fixed-shape device form.

Host side, a RowBlock is numpy CSR — the same batch abstraction as the
reference's ``dmlc::RowBlock<I>`` (consumed all over, e.g. reference
learn/base/spmv.h:49, learn/base/localizer.h:42). Feature ids are uint64
(hashed keys may use all 64 bits, reference learn/base/criteo_parser.h:69-82).

Device side, a RowBlock is flattened into a
``DeviceBatch``: padded COO arrays of a fixed capacity (``num_rows`` rows x
``capacity`` nonzeros) with zero-valued padding. Padding entries carry
``val == 0`` and point at row ``num_rows-1`` / key 0, so they contribute
nothing to SpMV / segment-sum gradients and need no masks in the compute
path (only ``row_mask`` for per-example metrics).

This replaces the reference's dynamic-size minibatches (minibatch_iter.h)
with the fixed-capacity buffer strategy SURVEY.md §7 "hard parts" calls for.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class RowBlock:
    """CSR batch of `size` examples.

    label:  float32[size]          (0/1 or -1/+1; may be all-zero for predict)
    offset: int64[size+1]          row pointer
    index:  uint64[nnz]            feature ids (possibly hashed 64-bit keys)
    value:  float32[nnz] or None   None means binary features (all ones),
                                   matching the reference's binary compaction
                                   (minibatch_iter.h:114-116)
    weight: float32[size] or None  per-example weights
    """

    label: np.ndarray
    offset: np.ndarray
    index: np.ndarray
    value: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return len(self.offset) - 1

    @property
    def nnz(self) -> int:
        return int(self.offset[-1])

    def __len__(self) -> int:
        return self.size

    @property
    def nbytes(self) -> int:
        """Host footprint of the batch's arrays (cache byte budgeting)."""
        return sum(a.nbytes for a in (self.label, self.offset, self.index,
                                      self.value, self.weight)
                   if a is not None)

    def slice(self, begin: int, end: int) -> "RowBlock":
        """Zero-copy row range view (offsets are rebased)."""
        end = min(end, self.size)
        o = self.offset[begin : end + 1]
        lo, hi = int(o[0]), int(o[-1])
        return RowBlock(
            label=self.label[begin:end],
            offset=o - lo,
            index=self.index[lo:hi],
            value=None if self.value is None else self.value[lo:hi],
            weight=None if self.weight is None else self.weight[begin:end],
        )

    def values_or_ones(self) -> np.ndarray:
        if self.value is not None:
            return self.value
        return np.ones(self.nnz, dtype=np.float32)

    @staticmethod
    def concat(blocks: "list[RowBlock]") -> "RowBlock":
        assert blocks
        sizes = [b.size for b in blocks]
        offs = [np.asarray(b.offset, dtype=np.int64) for b in blocks]
        out_off = np.zeros(sum(sizes) + 1, dtype=np.int64)
        pos, base = 1, 0
        for o in offs:
            out_off[pos : pos + len(o) - 1] = o[1:] + base
            base += int(o[-1])
            pos += len(o) - 1
        any_val = any(b.value is not None for b in blocks)
        return RowBlock(
            label=np.concatenate([b.label for b in blocks]),
            offset=out_off,
            index=np.concatenate([b.index for b in blocks]),
            value=(
                np.concatenate([b.values_or_ones() for b in blocks])
                if any_val
                else None
            ),
            weight=(
                np.concatenate(
                    [
                        (
                            b.weight
                            if b.weight is not None
                            else np.ones(b.size, dtype=np.float32)
                        )
                        for b in blocks
                    ]
                )
                if any(b.weight is not None for b in blocks)
                else None
            ),
        )


@dataclasses.dataclass
class DeviceBatch:
    """Fixed-shape COO batch ready for the device.

    All arrays have fixed shapes, so every minibatch packs to the same
    layout. Built by :func:`to_device_batch`.

    seg:      int32[capacity]  row id of each nonzero (padding -> num_rows-1)
    idx:      int32[capacity]  bucket id in [0, num_buckets) (padding -> 0)
    val:      float32[capacity] feature value (padding -> 0)
    label:    float32[num_rows] (padding rows -> 0)
    row_mask: float32[num_rows] 1 for real rows, 0 for padding
    dropped_rows: examples excluded because the batch overflowed capacity
    """

    seg: np.ndarray
    idx: np.ndarray
    val: np.ndarray
    label: np.ndarray
    row_mask: np.ndarray
    dropped_rows: int = 0

    @property
    def num_rows(self) -> int:
        return len(self.label)

    @property
    def capacity(self) -> int:
        return len(self.seg)

    @property
    def nbytes(self) -> int:
        """Host footprint of the padded arrays (cache byte budgeting)."""
        return (self.seg.nbytes + self.idx.nbytes + self.val.nbytes
                + self.label.nbytes + self.row_mask.nbytes)


def bucketize(index: np.ndarray, num_buckets: int) -> np.ndarray:
    """Map raw uint64 keys to [0, num_buckets) bucket ids.

    The mod-by-capacity "hash kernel" is the reference's own escape hatch for
    bounding the key space (localizer.h:107-115 under ps::FLAGS_max_key);
    upstream hashing (criteo/adfea parsers) has already spread the keys.
    """
    return (index % np.uint64(num_buckets)).astype(np.int32)


def to_device_batch(
    blk: RowBlock,
    num_rows: int,
    capacity: int,
    num_buckets: int,
    index_map: Optional[np.ndarray] = None,
) -> DeviceBatch:
    """Pad/truncate a RowBlock into a fixed-shape DeviceBatch.

    If ``index_map`` is given it is used as the per-nonzero bucket ids
    (already localized); otherwise raw ids are bucketized mod num_buckets.
    Rows beyond ``num_rows`` are dropped. If the nonzeros overflow
    ``capacity``, the partially-represented row and everything after it are
    dropped whole (masked out) rather than trained on truncated features;
    the count is reported in ``dropped_rows`` so callers can warn.
    """
    dropped = max(blk.size - num_rows, 0)
    n = min(blk.size, num_rows)
    if blk.size > num_rows:
        blk = blk.slice(0, num_rows)
    nnz = int(blk.nnz)
    if nnz > capacity:
        # keep only rows fully contained in the first `capacity` nonzeros
        cut = int(np.searchsorted(blk.offset, capacity, side="right")) - 1
        dropped += n - cut
        n = cut
        blk = blk.slice(0, cut)
        nnz = int(blk.nnz)

    seg = np.full(capacity, max(num_rows - 1, 0), dtype=np.int32)
    idx = np.zeros(capacity, dtype=np.int32)
    val = np.zeros(capacity, dtype=np.float32)
    label = np.zeros(num_rows, dtype=np.float32)
    row_mask = np.zeros(num_rows, dtype=np.float32)

    # expand row pointers to per-nonzero segment ids
    seg_src = np.repeat(
        np.arange(n, dtype=np.int32), np.diff(blk.offset[: n + 1]).astype(np.int64)
    )
    seg[:nnz] = seg_src
    if index_map is not None:
        idx[:nnz] = index_map[:nnz]
    else:
        idx[:nnz] = bucketize(blk.index, num_buckets)
    val[:nnz] = blk.values_or_ones()
    if blk.weight is not None:
        # example weights fold into the values for linear models
        val[:nnz] *= blk.weight[seg_src]
    label[:n] = blk.label[:n]
    row_mask[:n] = 1.0
    return DeviceBatch(seg=seg, idx=idx, val=val, label=label,
                       row_mask=row_mask, dropped_rows=dropped)
