"""Sparse matrix x vector and matrix x dense-block products on a
fixed-shape COO batch, as plain torch ops (the ``kernel=xla`` path;
reference learn/base/spmv.h:72-119, spmm.h:41-123).

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


def spmm(seg, idx, val, V, num_rows: int):
    """Y = X V for a dense k-column table V[table, k]   (SpMM::Times,
    spmm.h:41-52): Y[i, :] = sum_j val[j] * V[idx[j], :]."""
    out = torch.zeros(num_rows, V.shape[1], dtype=V.dtype, device=V.device)
    return out.index_add_(0, seg, val[:, None] * V.index_select(0, idx))


def spmm_t(seg, idx, val, D, table_size: int):
    """G = Xᵀ D for a dense D[num_rows, k]   (SpMM::TransTimes):
    G[key, :] = sum_{j: idx[j]=key} val[j] * D[seg[j], :]."""
    out = torch.zeros(table_size, D.shape[1], dtype=D.dtype,
                      device=D.device)
    return out.index_add_(0, idx, val[:, None] * D.index_select(0, seg))


def row_squares(seg, idx, val, V, num_rows: int):
    """sum_j val[j]^2 * V[idx[j], :]^2 per row: the (X^2)(V^2) term of the
    FM quadratic part (reference difacto/loss.h:62-84)."""
    out = torch.zeros(num_rows, V.shape[1], dtype=V.dtype, device=V.device)
    return out.index_add_(
        0, seg, (val ** 2)[:, None] * V.index_select(0, idx) ** 2)
