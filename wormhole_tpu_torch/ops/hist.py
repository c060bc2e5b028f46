"""Gradient histograms of one tree level, for the GBDT learner.

The split search needs, per level, G[n, f, b] = the sum of the gradients
of the rows assigned to node n whose feature f falls in bin b, and the
same for the hessians H: the quantity the reference's xgboost accumulates
in per-thread CPU histograms and allreduces over rabit.

``level_hist`` keeps the JAX package's signature. On the card it first
partitions the level's rows by node (``level_partition``: three kernels
of csrc/hist.cu, nothing read back to the host), then one kernel
accumulates each node's rows into a histogram tile in shared memory, in
64-bit fixed point: integer adds, so every launch gives the same bits.
Beside them here are the plain versions: for the histogram the JAX
package's own scatter formulation (models/gbdt.py local_hist), a flat
index ``rel * F * B + f * B + bin`` and an ``index_add_``; for the
partition a stable sort; ``hist_shares``, how the kernel splits the
partition among its CTAs; and ``level_hist_fixed_plain``, the kernel's
fixed-point rule in plain ops, which the tests hold against the kernel
and the JAX package. ``level_totals``, the GBDT learner's node totals,
sums in the same fixed point.

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


_FIXED_BITS = 62  # csrc/hist.cu kFixedBits


def fixed_scale_exp(maxabs, rows):
    """The exponent s of csrc/hist.cu's fixed point (fixed_exp): with
    maxabs < 2^e (e from maxabs's f32 bits, its biased exponent less 126,
    or -126 where it is 0 or subnormal) and rows <= 2^r (r the bit length
    of rows), s = 62 - r - e, so that rows terms of at most maxabs * 2^s
    each sum below 2^62. maxabs: f32 tensor (any shape); rows: an int or
    an integer tensor. Returns s as an int64 tensor of maxabs's shape."""
    bits = maxabs.float().contiguous().view(torch.int32).long()
    biased = (bits >> 23) & 0xFF
    e = torch.where(biased == 0, -126, biased - 126)
    n = torch.as_tensor(rows, dtype=torch.float64, device=maxabs.device)
    r = torch.frexp(n)[1].long()  # n < 2^r, n = 2^(r-1) .. 2^r - 1
    return _FIXED_BITS - r - e


def _pow2(k):
    """2^k as f64, exactly (k an int64 tensor in [-1022, 1023])."""
    return ((k + 1023) << 52).view(torch.float64)


def fixed_point(x, live):
    """A level's terms in csrc/hist.cu's fixed point: x (rows, k) f32, k
    series each scaled on its own; live (rows,) bool, the rows in the
    level. Returns (q, nonfinite, s): q (rows, k) int64, each finite term
    times 2^s rounded to nearest (ties to even), 0 where it is not
    finite; nonfinite (rows, k) f64, the non-finite terms, 0 elsewhere;
    s (k,) from the largest finite |x| of the live rows and their
    count."""
    fin = torch.isfinite(x)
    if x.shape[0]:
        m = torch.where(live[:, None] & fin, x.abs(), 0).amax(0)
    else:
        m = x.new_zeros(x.shape[1:])
    s = fixed_scale_exp(m, live.sum())
    q = torch.round(torch.where(fin, x, 0).double() * _pow2(s)).long()
    return q, torch.where(fin, 0, x).double(), s


def from_fixed(acc, nonfinite, s):
    """Sums in fixed point (int64) back to f64: each sum's double times
    2^-s, exact up to the one rounding of the int64 to a double, plus the
    sum of its non-finite terms (0 where there were none; +-inf, or nan
    where a nan or both infinities came)."""
    return acc.double() * _pow2(-s) + nonfinite


def level_hist_fixed_plain(binned, g, h, rel, num_nodes: int, B: int):
    """The kernel's rule in plain ops, for the tests: level_hist as
    csrc/hist.cu computes it, bit for bit. Each g (h) of a row in the
    level is taken in fixed point (fixed_point: the scale from the level's
    max finite |g| and its rows), the cells sum those integers exactly,
    and each cell is rounded to f32 once (from_fixed); a bin id >= B adds
    nothing. The same bits in any order of the rows."""
    rows, F = binned.shape
    live = (rel >= 0) & (rel < num_nodes)
    cells = num_nodes * F * B
    flat = torch.where((binned.int() < B).reshape(-1),
                       hist_index(binned, rel, num_nodes, B).long(), cells)
    q, nf, s = fixed_point(torch.stack([g, h], dim=1), live)
    acc = torch.zeros(cells + F * B, 2, dtype=torch.int64, device=g.device)
    acc.index_add_(0, flat, q.repeat_interleave(F, dim=0))
    nfs = torch.zeros(cells + F * B, 2, dtype=torch.float64, device=g.device)
    nfs.index_add_(0, flat, nf.repeat_interleave(F, dim=0))
    out = from_fixed(acc[:cells], nfs[:cells], s).float()
    return (out[:, 0].reshape(num_nodes, F, B),
            out[:, 1].reshape(num_nodes, F, B))


def level_totals(g, h, rel, num_nodes: int, ways: int = 1):
    """Each node's (sum of g, sum of h) as (num_nodes, 2) f64, the same
    bits in any order of the rows: the terms in csrc/hist.cu's fixed
    point (fixed_point, the scale from the level's rows), summed as exact
    int64 adds (index_add_ of integers takes no order), then from_fixed.
    Rows with rel outside [0, num_nodes) add nothing. `ways` spreads
    each node's rows over that many accumulators, summed at the end (on
    the card all rows of a node adding to one address serialise)."""
    live = (rel >= 0) & (rel < num_nodes)
    n = num_nodes + 1
    node = torch.where(live, rel, num_nodes).long()
    idx = (torch.arange(g.shape[0], device=g.device) % ways) * n + node
    q, nf, s = fixed_point(torch.stack([g, h], dim=1), live)
    acc = torch.zeros(ways * n, 2, dtype=torch.int64, device=g.device)
    acc = acc.index_add_(0, idx, q).view(ways, n, 2).sum(0)
    nfs = torch.zeros(ways * n, 2, dtype=torch.float64, device=g.device)
    nfs = nfs.index_add_(0, idx, nf).view(ways, n, 2).sum(0)
    return from_fixed(acc[:num_nodes], nfs[:num_nodes], s)


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

    On the card the sums are taken in 64-bit fixed point
    (level_hist_fixed_plain gives the same bits), so every launch on the
    same inputs gives the same bits, in whatever order the rows come. G
    and H are views of one workspace. Five launches (the workspace's
    memset, the partition's three kernels, the histogram), no host
    sync.

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
    lib = _cuda.lib("hist")
    n = ctypes.c_int64(0)
    _cuda.check("hist", lib.wh_level_hist_bytes(rows, F, B, num_nodes,
                                                ctypes.addressof(n)),
                "level_hist workspace")
    ws = torch.empty(n.value, dtype=torch.uint8, device=binned.device)
    rc = lib.wh_level_hist(
        binned.data_ptr(), g.data_ptr(), h.data_ptr(), rel.data_ptr(),
        ws.data_ptr(), rows, F, B, num_nodes, _cuda.stream(binned))
    _cuda.check("hist", rc, "level_hist")
    out = ws[:8 * num_nodes * F * B].view(torch.float32).view(
        2, num_nodes, F, B)
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
