"""Gradient histograms of one tree level, for the GBDT learner.

The split search needs, per level, G[n, f, b] = the sum of the gradients
of the rows assigned to node n whose feature f falls in bin b, and the
same for the hessians H: the quantity the reference's xgboost accumulates
in per-thread CPU histograms and allreduces over rabit.

``level_hist`` keeps the JAX package's signature. The kernel
(csrc/hist.cu) accumulates in f32 with atomic adds into a histogram tile
in shared memory; beside it here is the plain version, the JAX package's
own scatter formulation (models/gbdt.py local_hist): a flat index
``rel * F * B + f * B + bin`` and an ``index_add_``.

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from wormhole_tpu_torch.ops import _cuda


def hist_index(binned, rel, num_nodes: int, B: int):
    """Flat (rows * F,) int32 cell index of every (row, feature) into
    ((num_nodes + 1) * F * B,): rows outside the level (rel not in
    [0, num_nodes)) land in the extra node, which the caller drops."""
    rows, F = binned.shape
    node = torch.where((rel >= 0) & (rel < num_nodes), rel,
                       torch.full_like(rel, num_nodes))
    base = (node[:, None] * (F * B)
            + torch.arange(F, dtype=torch.int32, device=rel.device) * B)
    return (base + binned.to(torch.int32)).reshape(-1)


def level_hist_plain(binned, g, h, rel, num_nodes: int, B: int,
                     acc_dtype=torch.float32):
    """Plain version of level_hist: the flat scatter index, then one
    index_add_ each for G and H into accumulators of acc_dtype, rounded to
    f32 at the end. With f32 accumulators it is the JAX package's
    scatter, sum for sum. A check of the kernel at full size passes
    torch.float64: an f32 running sum over the thousands of rows of one
    cell drifts (after the first rounds g takes few distinct values, so
    its rounding errors share a sign) by more than the kernel's
    hierarchical f32 sums are off."""
    rows, F = binned.shape
    flat = hist_index(binned, rel, num_nodes, B)
    cells = num_nodes * F * B
    out = []
    for x in (g, h):
        acc = torch.zeros(cells + F * B, dtype=acc_dtype, device=g.device)
        acc.index_add_(
            0, flat, x.to(acc_dtype)[:, None].expand(rows, F).reshape(-1))
        out.append(acc[:cells].float().reshape(num_nodes, F, B))
    return out[0], out[1]


def level_hist(binned, g, h, rel, num_nodes: int, B: int):
    """Per-level gradient/hessian histograms.

    binned: (rows, F) uint8 bin ids below B; g, h: (rows,) f32; rel:
    (rows,) int32 node of each row relative to the level (rows not in the
    level carry rel == num_nodes and contribute nothing). Returns (G, H):
    (num_nodes, F, B) f32, each cell the f32 sum of its rows' g (h); a
    cell no row reaches is exactly 0.0. B <= 256.

    On the card the sums are float atomics, so their order, and with it
    the last bits, may change from launch to launch.

    Replaces wormhole_tpu/ops/hist.py level_hist (_hist_kernel).
    Kernel: csrc/hist.cu level_hist_kernel."""
    if binned.dim() != 2:
        raise ValueError("level_hist: binned must be (rows, F)")
    rows, F = binned.shape
    if not (g.shape == h.shape == rel.shape == (rows,)):
        raise ValueError("level_hist: g, h and rel must be (rows,)")
    if num_nodes < 1 or not 1 <= B <= 256 or F < 1:
        raise ValueError(f"level_hist: num_nodes {num_nodes}, F {F}, B {B}: "
                         f"need num_nodes >= 1, F >= 1 and 1 <= B <= 256")
    if not binned.is_cuda:
        return level_hist_plain(binned, g, h, rel, num_nodes, B)
    _cuda.require("level_hist", binned.device, binned=binned, g=g, h=h,
                  rel=rel)
    out = torch.empty(2, num_nodes, F, B, dtype=torch.float32,
                      device=binned.device)
    rc = _cuda.lib("hist").wh_level_hist(
        binned.data_ptr(), g.data_ptr(), h.data_ptr(), rel.data_ptr(),
        out.data_ptr(), rows, F, B, num_nodes, _cuda.stream(binned))
    _cuda.check("hist", rc, "level_hist")
    _cuda.LAUNCHES["level_hist"] += 1
    return out[0], out[1]
