"""Sparse matrix x vector products on a fixed-shape COO batch, as plain
torch ops (the ``kernel=xla`` path; reference learn/base/spmv.h:72-119).

Padding entries carry val == 0, so they contribute nothing.
"""

from __future__ import annotations

import torch


def spmv(seg, idx, val, w, num_rows: int):
    """y[i] = sum_{j in row i} val[j] * w[idx[j]]   (SpMV::Times)."""
    out = torch.zeros(num_rows, dtype=w.dtype, device=w.device)
    return out.index_add_(0, seg, val * w.index_select(0, idx))


def spmv_t(seg, idx, val, d, table_size: int):
    """g[k] = sum_{j: idx[j]=k} val[j] * d[seg[j]]   (SpMV::TransTimes),
    in parameter-table layout."""
    out = torch.zeros(table_size, dtype=d.dtype, device=d.device)
    return out.index_add_(0, idx, val * d.index_select(0, seg))
