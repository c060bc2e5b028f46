"""The port's level_hist (its plain version: on the CPU the wrapper takes
it) against the JAX package's Pallas kernel in interpret mode and against
a numpy loop, on the same seeded inputs.

Tolerances: rtol 1e-4 / atol 1e-4 against the JAX kernel (its own bar,
tests/test_gbdt.py: its bf16 hi/lo split of g and h leaves ~2^-16 per
element); rtol 1e-5 / atol 1e-5 against the numpy loop (f32 sums in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wormhole_tpu.ops.hist import level_hist as j_level_hist
from wormhole_tpu_torch.ops import _cuda
from wormhole_tpu_torch.ops import hist as t_hist


def _inputs(rows, F, B, nodes, seed, inactive="some", binary=False):
    rng = np.random.default_rng(seed)
    hi = 2 if binary else B
    binned = rng.integers(0, hi, (rows, F)).astype(np.uint8)
    g = rng.standard_normal(rows).astype(np.float32)
    h = rng.random(rows).astype(np.float32)
    if inactive == "all":
        rel = np.full(rows, nodes, np.int32)
    elif inactive == "none":
        rel = rng.integers(0, nodes, rows).astype(np.int32)
    else:
        rel = rng.integers(0, nodes + 1, rows).astype(np.int32)
    return binned, g, h, rel


def _loop(binned, g, h, rel, nodes, B):
    rows, F = binned.shape
    G = np.zeros((nodes, F, B), np.float64)
    H = np.zeros((nodes, F, B), np.float64)
    for i in range(rows):
        if 0 <= rel[i] < nodes:
            for f in range(F):
                G[rel[i], f, binned[i, f]] += g[i]
                H[rel[i], f, binned[i, f]] += h[i]
    return G.astype(np.float32), H.astype(np.float32)


def _port(binned, g, h, rel, nodes, B):
    G, H = t_hist.level_hist(torch.from_numpy(binned), torch.from_numpy(g),
                             torch.from_numpy(h), torch.from_numpy(rel),
                             nodes, B)
    assert G.shape == H.shape == (nodes, binned.shape[1], B)
    assert G.dtype == H.dtype == torch.float32
    return G.numpy(), H.numpy()


def _jax(binned, g, h, rel, nodes, B):
    G, H = j_level_hist(jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
                        jnp.asarray(rel), nodes, B)
    return np.asarray(G), np.asarray(H)


SHAPES = [
    # rows, F, B, nodes
    (1, 1, 16, 1),
    (600, 5, 16, 4),
    (600, 28, 256, 1),
    (5000, 5, 256, 16),
    (5000, 28, 16, 4),
    (5000, 1, 256, 4),
]


@pytest.mark.parametrize("rows,F,B,nodes", SHAPES)
def test_level_hist_matches_jax_kernel_and_loop(rows, F, B, nodes):
    args = _inputs(rows, F, B, nodes, seed=rows + F + B + nodes)
    G, H = _port(*args, nodes, B)
    Gl, Hl = _loop(*args, nodes, B)
    np.testing.assert_allclose(G, Gl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(H, Hl, rtol=1e-5, atol=1e-5)
    Gj, Hj = _jax(*args, nodes, B)
    np.testing.assert_allclose(G, Gj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(H, Hj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("inactive", ["all", "none"])
def test_level_hist_inactive_rows(inactive):
    """All rows outside the level give all zeros; none outside, and the
    totals over bins are each node's sum of g."""
    rows, F, B, nodes = 600, 5, 16, 4
    binned, g, h, rel = _inputs(rows, F, B, nodes, seed=2, inactive=inactive)
    G, H = _port(binned, g, h, rel, nodes, B)
    Gj, Hj = _jax(binned, g, h, rel, nodes, B)
    np.testing.assert_allclose(G, Gj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(H, Hj, rtol=1e-4, atol=1e-4)
    if inactive == "all":
        assert not G.any() and not H.any()
    else:
        for n in range(nodes):
            np.testing.assert_allclose(G[n].sum(-1), g[rel == n].sum(),
                                       rtol=1e-4, atol=1e-4)


def test_level_hist_empty_node_is_exactly_zero():
    rows, F, B, nodes = 600, 5, 16, 4
    binned, g, h, rel = _inputs(rows, F, B, nodes, seed=3)
    rel[rel == 2] = nodes     # node 2 gets no rows
    G, H = _port(binned, g, h, rel, nodes, B)
    assert not G[2].any() and not H[2].any()
    assert G[0].any() and H[3].any()
    Gl, Hl = _loop(binned, g, h, rel, nodes, B)
    np.testing.assert_allclose(G, Gl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(H, Hl, rtol=1e-5, atol=1e-5)
    Gj, _ = _jax(binned, g, h, rel, nodes, B)
    np.testing.assert_allclose(G, Gj, rtol=1e-4, atol=1e-4)


def test_level_hist_binary_bins():
    """0/1 bins (the mushroom data's shape): every row lands in two cells
    of each feature; all other cells are exactly zero."""
    rows, F, B, nodes = 5000, 28, 256, 4
    binned, g, h, rel = _inputs(rows, F, B, nodes, seed=4, binary=True)
    G, H = _port(binned, g, h, rel, nodes, B)
    assert not G[:, :, 2:].any() and not H[:, :, 2:].any()
    Gl, Hl = _loop(binned, g, h, rel, nodes, B)
    np.testing.assert_allclose(G, Gl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(H, Hl, rtol=1e-5, atol=1e-5)
    Gj, Hj = _jax(binned, g, h, rel, nodes, B)
    np.testing.assert_allclose(G, Gj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(H, Hj, rtol=1e-4, atol=1e-4)


def test_level_hist_out_of_range_rel_drops_out():
    """Any rel outside [0, num_nodes) is outside the level, as the JAX
    package's scatter drops every out-of-range segment."""
    rows, F, B, nodes = 600, 5, 16, 4
    binned, g, h, rel = _inputs(rows, F, B, nodes, seed=5)
    wild = rel.copy()
    wild[rel == nodes] = np.where(np.arange((rel == nodes).sum()) % 2, -1,
                                  nodes + 7)
    G, H = _port(binned, g, h, wild, nodes, B)
    G0, H0 = _port(binned, g, h, rel, nodes, B)
    np.testing.assert_array_equal(G, G0)
    np.testing.assert_array_equal(H, H0)


def test_hist_index_is_the_jax_scatter_index():
    rows, F, B, nodes = 600, 5, 16, 4
    binned, _, _, rel = _inputs(rows, F, B, nodes, seed=6)
    flat = t_hist.hist_index(torch.from_numpy(binned), torch.from_numpy(rel),
                             nodes, B).numpy()
    want = (rel[:, None] * (F * B) + np.arange(F)[None, :] * B
            + binned.astype(np.int32)).ravel()
    np.testing.assert_array_equal(flat, want)
    assert flat.dtype == np.int32


def test_level_hist_on_cpu_counts_no_launch():
    n0 = _cuda.LAUNCHES["level_hist"]
    _port(*_inputs(64, 3, 16, 2, seed=7), 2, 16)
    assert _cuda.LAUNCHES["level_hist"] == n0


@pytest.mark.parametrize("bad", ["B", "nodes", "shape", "dim"])
def test_level_hist_rejects(bad):
    binned, g, h, rel = (torch.from_numpy(a)
                         for a in _inputs(64, 3, 16, 2, seed=8))
    with pytest.raises(ValueError):
        if bad == "B":
            t_hist.level_hist(binned, g, h, rel, 2, 257)
        elif bad == "nodes":
            t_hist.level_hist(binned, g, h, rel, 0, 16)
        elif bad == "shape":
            t_hist.level_hist(binned, g[:-1], h, rel, 2, 16)
        else:
            t_hist.level_hist(binned[:, 0], g, h, rel, 2, 16)


def test_require_knows_the_uint8_argument():
    """ops/_cuda.require holds `binned` to uint8 and `rel` to int32 (it
    used to hold every tensor to int32 or float32)."""
    dev = torch.device("cpu")
    binned = torch.zeros(4, 2, dtype=torch.uint8)
    rel = torch.zeros(4, dtype=torch.int32)
    g = torch.zeros(4)
    _cuda.require("level_hist", dev, binned=binned, g=g, rel=rel)
    with pytest.raises(ValueError, match="binned"):
        _cuda.require("level_hist", dev, binned=binned.int(), g=g, rel=rel)
    with pytest.raises(ValueError, match="rel"):
        _cuda.require("level_hist", dev, binned=binned, g=g, rel=rel.long())
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.require("level_hist", dev, binned=binned.t(), g=g, rel=rel)


def test_plain_version_accumulator_types_agree():
    """f32 accumulators are the JAX scatter; f64 ones are the reference a
    full-size check of the kernel uses. At this size they agree."""
    binned, g, h, rel = (torch.from_numpy(a)
                         for a in _inputs(5000, 5, 16, 4, seed=9))
    G32, H32 = t_hist.level_hist_plain(binned, g, h, rel, 4, 16)
    G64, H64 = t_hist.level_hist_plain(binned, g, h, rel, 4, 16,
                                       acc_dtype=torch.float64)
    assert G64.dtype == H64.dtype == torch.float32
    torch.testing.assert_close(G32, G64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(H32, H64, rtol=1e-5, atol=1e-5)


def _rel_case(case, rows, nodes, rng):
    """rel of a level: some rows outside it ("some"), none in it, empty
    nodes, rel below 0 and above num_nodes, or one node with 99% of the
    rows beside tiny ones (with one node, the 1% is outside the level)."""
    rel = rng.integers(0, nodes + 1, rows).astype(np.int32)
    if case == "all_inactive":
        rel[:] = nodes
    elif case == "empty_nodes":
        rel[rel % 3 == 1] = nodes
    elif case == "wild_rel":
        rel[rel == nodes] = rng.choice([-7, -1, nodes, nodes + 3, 2 ** 31 - 1],
                                       int((rel == nodes).sum()))
    elif case == "skewed":
        rel[:] = 0
        tail = rng.random(rows) < 0.01
        rel[tail] = rng.integers(1, max(nodes, 2), int(tail.sum()))
    return rel


PARTITION_CASES = ["some", "all_inactive", "empty_nodes", "wild_rel",
                   "skewed"]


@pytest.mark.parametrize("nodes", [1, 16, 256])
@pytest.mark.parametrize("case", PARTITION_CASES)
def test_level_partition_plain_is_a_stable_sort(case, nodes):
    rng = np.random.default_rng(nodes + len(case))
    rel = _rel_case(case, 5000, nodes, rng)
    order, start = t_hist.level_partition(torch.from_numpy(rel), nodes)
    assert order.dtype == start.dtype == torch.int32
    live = np.nonzero((rel >= 0) & (rel < nodes))[0]
    want = live[np.argsort(rel[live], kind="stable")]
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(
        start.numpy(),
        np.concatenate([[0], np.bincount(rel[live], minlength=nodes)
                        .cumsum()]))


@pytest.mark.parametrize("ctas", [1, 7, 264])
@pytest.mark.parametrize("case", PARTITION_CASES)
def test_hist_shares_cover_every_row_once(case, ctas):
    """The histogram kernel's split of a partition among its CTAs: each
    in-level row in exactly one CTA's runs, a run inside one node, and
    each CTA's rows plus node_cost a node within node_cost of an even
    share of the level's cost."""
    nodes, node_cost = 16, 256
    rel = _rel_case(case, 5000, nodes, np.random.default_rng(ctas))
    order, start = t_hist.level_partition(torch.from_numpy(rel), nodes)
    shares = t_hist.hist_shares(start, ctas, node_cost)
    assert len(shares) == ctas
    seen = np.zeros(len(order), np.int64)
    even = -(-(len(order) + node_cost * nodes) // ctas)
    for runs in shares:
        for n, lo, hi in runs:
            assert start[n] <= lo < hi <= start[n + 1]
            seen[lo:hi] += 1
        assert sum(hi - lo + node_cost for _, lo, hi in runs) <= \
            even + node_cost
        assert len({n for n, _, _ in runs}) == len(runs)
    assert (seen == 1).all()


@pytest.mark.parametrize("case", ["some", "skewed", "wild_rel"])
@pytest.mark.parametrize("rows,F,B,nodes", SHAPES[1:])
def test_level_hist_over_partition_matches_plain_and_jax(rows, F, B, nodes,
                                                         case):
    """The kernel's decomposition on the CPU: partition, split among five
    CTAs, one histogram per run added into its node. It equals
    level_hist_plain and the JAX kernel."""
    rng = np.random.default_rng(rows + F + B + nodes)
    binned, g, h, _ = _inputs(rows, F, B, nodes, seed=rows + nodes)
    rel = _rel_case(case, rows, nodes, rng)
    tb, tg, th = (torch.from_numpy(a) for a in (binned, g, h))
    order, start = t_hist.level_partition(torch.from_numpy(rel), nodes)
    G = torch.zeros(nodes, F, B)
    H = torch.zeros(nodes, F, B)
    runs = [r for share in t_hist.hist_shares(start, 5, 256) for r in share]
    for n, lo, hi in runs:
        rows_i = order[lo:hi].long()
        Gi, Hi = t_hist.level_hist_plain(
            tb[rows_i], tg[rows_i], th[rows_i],
            torch.zeros(hi - lo, dtype=torch.int32), 1, B)
        G[n] += Gi[0]
        H[n] += Hi[0]
    Gp, Hp = t_hist.level_hist_plain(tb, tg, th, torch.from_numpy(rel),
                                     nodes, B)
    torch.testing.assert_close(G, Gp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(H, Hp, rtol=1e-5, atol=1e-5)
    Gj, Hj = _jax(binned, g, h, rel, nodes, B)
    np.testing.assert_allclose(G.numpy(), Gj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(H.numpy(), Hj, rtol=1e-4, atol=1e-4)


def test_level_partition_rejects():
    with pytest.raises(ValueError):
        t_hist.level_partition(torch.zeros(4, 2, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        t_hist.level_partition(torch.zeros(4, dtype=torch.int32), 0)
