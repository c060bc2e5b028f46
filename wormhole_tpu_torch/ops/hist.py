"""Gradient histograms of one tree level, for the GBDT learner.

The split search needs, per level, G[n, f, b] = the sum of the gradients
of the rows assigned to node n whose feature f falls in bin b, and the
same for the hessians H: the quantity the reference's xgboost accumulates
in per-thread CPU histograms and allreduces over rabit.

``level_hist`` keeps the JAX package's signature. On the card it first
partitions the level's rows by node (``level_partition``: three kernels
of csrc/hist.cu, nothing read back to the host), then one kernel
accumulates each node's rows in f32 with atomic adds into a histogram
tile in shared memory. Beside them here are the plain versions: for the
histogram the JAX package's own scatter formulation (models/gbdt.py
local_hist), a flat index ``rel * F * B + f * B + bin`` and an
``index_add_``; for the partition a stable sort; and ``hist_shares``,
how the kernel splits the partition among its CTAs.

The wrappers run the plain versions only for tensors on the CPU. For CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

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


def level_partition_plain(rel, num_nodes: int):
    """Plain version of the partition: (order, node_start), both int32.
    order lists the rows in the level (0 <= rel < num_nodes) grouped by
    node, in row order within a node (a stable sort by rel); node n's rows
    are order[node_start[n]:node_start[n + 1]], node_start (num_nodes + 1,)
    the running count."""
    live = torch.nonzero((rel >= 0) & (rel < num_nodes)).flatten()
    key = rel[live].long()
    order = live[torch.sort(key, stable=True).indices].to(torch.int32)
    node_start = torch.zeros(num_nodes + 1, dtype=torch.int32,
                             device=rel.device)
    node_start[1:] = torch.bincount(key, minlength=num_nodes).cumsum(0)
    return order, node_start


def _scratch(rows: int, num_nodes: int, device):
    n = ctypes.c_int64(0)
    rc = _cuda.lib("hist").wh_level_scratch_ints(rows, num_nodes,
                                                 ctypes.addressof(n))
    _cuda.check("hist", rc, "level_hist scratch")
    return torch.empty(n.value, dtype=torch.int32, device=device)


def level_partition(rel, num_nodes: int):
    """The level's rows grouped by node: (order, node_start) as
    level_partition_plain gives them. On the card, order is the (rows,)
    buffer the kernels wrote, whose first node_start[-1] entries are the
    partition (the rest unspecified): its length would need a host sync.

    Kernels: csrc/hist.cu partition_count_kernel, partition_scan_kernel,
    partition_scatter_kernel. level_hist launches them itself."""
    if rel.dim() != 1 or num_nodes < 1:
        raise ValueError("level_partition: rel must be (rows,) and "
                         "num_nodes >= 1")
    if not rel.is_cuda:
        return level_partition_plain(rel, num_nodes)
    _cuda.require("level_partition", rel.device, rel=rel)
    rows = rel.shape[0]
    scratch = _scratch(rows, num_nodes, rel.device)
    rc = _cuda.lib("hist").wh_level_partition(
        rel.data_ptr(), scratch.data_ptr(), rows, num_nodes,
        _cuda.stream(rel))
    _cuda.check("hist", rc, "level_partition")
    _cuda.LAUNCHES["level_partition"] += 1
    n1 = num_nodes + 1
    return scratch[n1:n1 + rows], scratch[:n1]


def hist_shares(node_start, ctas: int, node_cost: int):
    """How the histogram kernel splits a partition among its CTAs: the
    level costs its rows plus node_cost a node (csrc/hist.cu kNodeCost),
    node n's share of the cost first, then its rows; CTA c takes the c-th
    even share of that cost. Returns, for each CTA, its [(node, lo, hi)]
    runs of order, node by node."""
    starts = [int(x) for x in node_start]
    nodes = len(starts) - 1
    cost = starts[-1] + node_cost * nodes
    shares = []
    for c in range(ctas):
        v0, v1 = cost * c // ctas, cost * (c + 1) // ctas
        runs = []
        for n in range(nodes):
            rows_at = starts[n] + node_cost * (n + 1)
            if rows_at - node_cost >= v1:
                break
            size = starts[n + 1] - starts[n]
            a = min(size, max(v0 - rows_at, 0))
            b = min(size, max(v1 - rows_at, 0))
            if a < b:
                runs.append((n, starts[n] + a, starts[n] + b))
        shares.append(runs)
    return shares


def level_hist(binned, g, h, rel, num_nodes: int, B: int):
    """Per-level gradient/hessian histograms.

    binned: (rows, F) uint8 bin ids below B; g, h: (rows,) f32; rel:
    (rows,) int32 node of each row relative to the level (rows not in the
    level carry rel == num_nodes and contribute nothing). Returns (G, H):
    (num_nodes, F, B) f32, each cell the f32 sum of its rows' g (h); a
    cell no row reaches is exactly 0.0. B <= 256.

    On the card the sums are float atomics, so their order, and with it
    the last bits, may change from launch to launch. Five launches (the
    output's memset, the partition's three kernels, the histogram), no
    host sync.

    Replaces wormhole_tpu/ops/hist.py level_hist (_hist_kernel).
    Kernels: csrc/hist.cu, the partition's and level_hist_kernel."""
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
    scratch = _scratch(rows, num_nodes, binned.device)
    out = torch.empty(2, num_nodes, F, B, dtype=torch.float32,
                      device=binned.device)
    rc = _cuda.lib("hist").wh_level_hist(
        binned.data_ptr(), g.data_ptr(), h.data_ptr(), rel.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), rows, F, B, num_nodes,
        _cuda.stream(binned))
    _cuda.check("hist", rc, "level_hist")
    _cuda.LAUNCHES["level_partition"] += 1
    _cuda.LAUNCHES["level_hist"] += 1
    return out[0], out[1]


def _mesh_hist(hist, mesh, binned, g, h, rel, num_nodes: int, B: int):
    from wormhole_tpu_torch.parallel import collectives
    from wormhole_tpu_torch.parallel.mesh import DATA_AXIS

    stat = torch.stack(hist(binned, g, h, rel, num_nodes, B))
    collectives.allreduce_sum(stat, mesh, DATA_AXIS)
    return stat[0], stat[1]


def mesh_level_hist(mesh, binned, g, h, rel, num_nodes: int, B: int):
    """level_hist over rows sharded on the data axis of a mesh: this
    rank's (G, H) of its own rows (the level_hist kernel on the card),
    summed over the data axis by one all_reduce of the stacked block (the
    rabit::Allreduce of gradient histograms). Every rank gets the same
    (num_nodes, F, B) sums.

    Replaces wormhole_tpu/models/gbdt.py hist (local_hist under shard_map,
    psum over the data axis)."""
    out = _mesh_hist(level_hist, mesh, binned, g, h, rel, num_nodes, B)
    if binned.is_cuda:
        _cuda.count("mesh_level_hist")
    return out


def mesh_level_hist_plain(mesh, binned, g, h, rel, num_nodes: int, B: int,
                          acc_dtype=torch.float32):
    """Plain version of mesh_level_hist: level_hist_plain on the rank's
    rows, then the same all_reduce."""
    return _mesh_hist(
        lambda *a: level_hist_plain(*a, acc_dtype=acc_dtype),
        mesh, binned, g, h, rel, num_nodes, B)
