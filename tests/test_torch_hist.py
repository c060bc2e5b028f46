"""The port's level_hist (its plain version: on the CPU the wrapper takes
it) against the JAX package's Pallas kernel in interpret mode and against
a numpy loop, on the same seeded inputs.

Tolerances: rtol 1e-4 / atol 1e-4 against the JAX kernel (its own bar,
tests/test_gbdt.py: its bf16 hi/lo split of g and h leaves ~2^-16 per
element); rtol 1e-5 / atol 1e-5 against the numpy loop (f32 sums in
another order).
"""

from fractions import Fraction

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


# ------------------------------------------- the kernel's fixed point
# csrc/hist.cu sums each level in 64-bit fixed point;
# level_hist_fixed_plain is its rule in plain ops (the card's kernel
# gives its bits, tests/test_torch_cuda.py).
def _fixed(binned, g, h, rel, nodes, B):
    G, H = t_hist.level_hist_fixed_plain(
        *(torch.from_numpy(a) for a in (binned, g, h, rel)), nodes, B)
    return G.numpy(), H.numpy()


def _f64(x, rel, nodes):
    """(num_nodes,) f64 sums of x by node."""
    live = (rel >= 0) & (rel < nodes)
    return np.bincount(rel[live], x[live].astype(np.float64),
                       minlength=nodes)


@pytest.mark.parametrize("rows,F,B,nodes", SHAPES)
def test_level_hist_fixed_plain_matches_jax_kernel_and_loop(rows, F, B,
                                                            nodes):
    args = _inputs(rows, F, B, nodes, seed=rows + F + B + nodes)
    G, H = _fixed(*args, nodes, B)
    assert G.dtype == H.dtype == np.float32
    Gl, Hl = _loop(*args, nodes, B)
    np.testing.assert_allclose(G, Gl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(H, Hl, rtol=1e-5, atol=1e-5)
    Gj, Hj = _jax(*args, nodes, B)
    np.testing.assert_allclose(G, Gj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(H, Hj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["some", "empty_nodes", "wild_rel",
                                  "skewed"])
@pytest.mark.parametrize("binary", [False, True], ids=["bins", "binary"])
def test_level_hist_fixed_plain_same_bits_in_any_row_order(case, binary):
    """Integer sums take no order: the rows permuted (so every cell's
    terms come in another order) give the same bits; so does the plain
    f32 scatter only by chance, and here it does not."""
    rows, F, B, nodes = 20000, 6, 64, 16
    rng = np.random.default_rng(len(case) + binary)
    binned, g, h, _ = _inputs(rows, F, B, nodes, seed=11, binary=binary)
    rel = _rel_case(case, rows, nodes, rng)
    G, H = _fixed(binned, g, h, rel, nodes, B)
    moved = False
    for seed in range(3):
        p = np.random.default_rng(seed).permutation(rows)
        G2, H2 = _fixed(binned[p], g[p], h[p], rel[p], nodes, B)
        assert G2.tobytes() == G.tobytes() and H2.tobytes() == H.tobytes()
        P2, _ = (a.numpy() for a in t_hist.level_hist_plain(
            *(torch.from_numpy(a[p]) for a in (binned, g, h, rel)), nodes, B))
        P, _ = (a.numpy() for a in t_hist.level_hist_plain(
            *(torch.from_numpy(a) for a in (binned, g, h, rel)), nodes, B))
        moved |= P2.tobytes() != P.tobytes()
    assert moved or case == "empty_nodes" and binary


def test_level_hist_fixed_plain_two_million_equal_g_in_one_cell():
    """The bench's largest level, 2,000,000 rows, all in one cell with one
    repeated g that no binary fraction holds: the f64 sum of the fixed
    terms is within rows * 2^-(s+1) of the exact sum (some 1e-6 of
    max|g|), and the f32 cell within the kernel's bar (atol 1e-4 + rtol
    1e-5 of the terms' magnitudes) of the f64 sum; so is a cell of the
    same rows with g and -g alternating."""
    rows = 2_000_000
    g0 = np.float32(0.1)
    for g in (np.full(rows, g0, np.float32),
              np.where(np.arange(rows) % 2 == 0, g0, -g0).astype(np.float32)):
        binned = np.zeros((rows, 1), np.uint8)
        rel = np.zeros(rows, np.int32)
        G, H = _fixed(binned, g, np.abs(g), rel, 1, 4)
        exact = float(g.astype(np.float64).sum())
        q, nf, s = t_hist.fixed_point(torch.from_numpy(g)[:, None],
                                      torch.ones(rows, dtype=torch.bool))
        sum64 = float(t_hist.from_fixed(q.sum(0), nf.sum(0), s)[0])
        assert abs(sum64 - exact) <= rows * 2.0 ** -(int(s[0]) + 1)
        assert abs(sum64 - exact) <= 1e-6 * float(g0)
        mag = rows * float(g0)
        assert abs(float(G[0, 0, 0]) - exact) <= 1e-4 + 1e-5 * mag
        assert float(H[0, 0, 0]) == np.float32(rows * float(g0))
        assert not G[0, 0, 1:].any() and not H[0, 0, 1:].any()


def test_level_hist_fixed_plain_zero_g_gives_zeros():
    rows, F, B, nodes = 5000, 5, 16, 4
    binned, _, _, rel = _inputs(rows, F, B, nodes, seed=12)
    z = np.zeros(rows, np.float32)
    G, H = _fixed(binned, z, -z, rel, nodes, B)
    assert not G.any() and not H.any()
    assert not np.signbit(G).any() and not np.signbit(H).any()


@pytest.mark.parametrize("kind", ["inf", "-inf", "nan", "both-inf",
                                  "outlier"])
def test_level_hist_fixed_plain_non_finite_g(kind):
    """A non-finite g makes its cells what level_hist_plain gives them
    (+-inf, or nan where a nan or both infinities came), and every other
    cell keeps the finite sum of its rows: never a finite wrong number. A
    finite outlier (1e4, some 1e4 of the other g) coarsens the scale,
    and the cells stay within the bar (a term is off by at most
    2^(r + e - 63), max|g| < 2^e, rows <= 2^r)."""
    rows, F, B, nodes = 5000, 5, 16, 4
    binned, g, h, rel = _inputs(rows, F, B, nodes, seed=13, inactive="none")
    bad = {"inf": [(3, np.inf)], "-inf": [(3, -np.inf)],
           "nan": [(3, np.nan)], "both-inf": [(3, np.inf), (7, -np.inf)],
           "outlier": [(3, 1e4)]}[kind]
    binned[7] = binned[3]
    rel[7] = rel[3]
    for r, v in bad:
        g[r] = v
    h[5] = np.inf
    G, H = _fixed(binned, g, h, rel, nodes, B)
    Gp, Hp = (a.numpy() for a in t_hist.level_hist_plain(
        *(torch.from_numpy(a) for a in (binned, g, h, rel)), nodes, B))
    for got, want in ((G, Gp), (H, Hp)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(Gp)
    assert (~fin).any() or kind == "outlier"
    mag, _ = (a.numpy() for a in t_hist.level_hist_plain(
        *(torch.from_numpy(a) for a in (binned, np.abs(g), h, rel)), nodes,
        B, acc_dtype=torch.float64))
    Gd, _ = (a.numpy() for a in t_hist.level_hist_plain(
        *(torch.from_numpy(a) for a in (binned, g, h, rel)), nodes, B,
        acc_dtype=torch.float64))
    err = np.abs(G[fin].astype(np.float64) - Gd[fin])
    assert (err <= 1e-4 + 1e-5 * mag[fin]).all()


@pytest.mark.parametrize("seed", range(4))
def test_fixed_scale_never_lets_a_level_overflow(seed):
    """For a level of `rows` terms of at most maxabs, s = fixed_scale_exp
    keeps rows x round(maxabs x 2^s) <= 2^62 (so no int64 sum can
    overflow) and is within one of the largest such s, over maxabs from 0
    and the least subnormal to the largest f32, powers of two and their
    neighbours, and rows from 1 to 2^31 - 1."""
    rng = np.random.default_rng(seed)
    m = np.concatenate([
        [0.0, 1e-45, 1.1754942e-38, 1.1754944e-38, 3.4028235e38, 1.0,
         np.nextafter(np.float32(1.0), np.float32(0.0)), 2.0, 0.5],
        np.ldexp(1.0, rng.integers(-149, 128, 40)),
        rng.standard_normal(40) * 10.0 ** rng.integers(-40, 38, 40)])
    m = np.abs(m.astype(np.float32))
    m = m[np.isfinite(m)]
    rows = np.concatenate([[1, 2, 3, 4, 2_000_000, 2 ** 21, 2 ** 21 + 1,
                            2 ** 31 - 1],
                           rng.integers(1, 2 ** 31 - 1, 20)])
    for n in rows:
        s = t_hist.fixed_scale_exp(torch.from_numpy(m), int(n)).numpy()
        sn = t_hist.fixed_scale_exp(torch.from_numpy(m),
                                    torch.tensor(int(n))).numpy()
        np.testing.assert_array_equal(s, sn)
        for x, k in zip(m.tolist(), s.tolist()):
            q = round(Fraction(x) * Fraction(2) ** k)  # ties to even
            assert int(n) * q <= 2 ** 62, (x, n, k)
            if x >= 2.0 ** -126:  # normal: e is tight
                assert int(n) * Fraction(x) * Fraction(2) ** (k + 2) \
                    >= 2 ** 62, (x, n, k)


@pytest.mark.parametrize("ways", [1, 64])
def test_level_totals_same_bits_in_any_row_order(ways):
    """The GBDT learner's node totals (models/gbdt.py totals): f64 sums
    within rows * 2^-(s+1) of the exact sums, the same bits with the
    rows permuted; a rel outside [0, nodes) adds nothing."""
    rows, nodes = 50000, 16
    rng = np.random.default_rng(ways)
    g = rng.standard_normal(rows).astype(np.float32)
    h = rng.random(rows).astype(np.float32)
    rel = rng.integers(-1, nodes + 2, rows).astype(np.int32)
    tg, th, tr = (torch.from_numpy(a) for a in (g, h, rel))
    got = t_hist.level_totals(tg, th, tr, nodes, ways=ways)
    assert got.shape == (nodes, 2) and got.dtype == torch.float64
    for k, x in enumerate((g, h)):
        exact = _f64(x, rel, nodes)
        live = (rel >= 0) & (rel < nodes)
        s = int(t_hist.fixed_scale_exp(
            torch.tensor(np.abs(x[live]).max()), int(live.sum())))
        assert (np.abs(got[:, k].numpy() - exact)
                <= live.sum() * 2.0 ** -(s + 1)).all()
    for seed in range(3):
        p = torch.from_numpy(np.random.default_rng(seed).permutation(rows))
        again = t_hist.level_totals(tg[p], th[p], tr[p], nodes, ways=ways)
        assert torch.equal(again, got)


def test_level_totals_non_finite_and_empty():
    g = np.array([1.0, np.inf, 2.0, np.nan, -np.inf, np.inf, 3.0],
                 np.float32)
    h = np.ones(7, np.float32)
    rel = np.array([0, 0, 1, 2, 3, 3, 5], np.int32)
    got = t_hist.level_totals(*(torch.from_numpy(a) for a in (g, h, rel)),
                              5).numpy()
    assert got[0, 0] == np.inf and got[1, 0] == 2.0
    assert np.isnan(got[2, 0]) and np.isnan(got[3, 0]) and got[4, 0] == 0.0
    np.testing.assert_array_equal(got[:, 1], [2.0, 1.0, 1.0, 2.0, 0.0])
    empty = t_hist.level_totals(torch.zeros(0), torch.zeros(0),
                                torch.zeros(0, dtype=torch.int32), 3)
    assert empty.shape == (3, 2) and not empty.any()
