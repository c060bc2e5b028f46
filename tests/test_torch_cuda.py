"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need an NVIDIA GPU with nvcc and skip without one (the
kernels have no CPU mode). This file imports no JAX, so it runs on a
machine with the card but without JAX:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the pull and push sum in another order (float atomics), and
the FM push in another order (a fixed tree), so they hold to atol 1e-4 +
rtol 1e-5 * (sum of the terms' magnitudes); the gathers are exact; the
updates hold to rtol 1e-5 / atol 1e-6 (the plain version divides by a
scalar as a multiply by its reciprocal on CUDA), and the V update is
also bit-equal to numpy's IEEE f32 steps; level_hist sums in 64-bit
fixed point: it gives level_hist_fixed_plain's bits exactly, the same in
every launch and any row order, holds to the same bar as the pull and
push against the f64 sums, and every cell that no row reaches is exactly
0. The host data path on the card (the libsvm, criteo and adfea parse
kernels, the pack's sorts and uniques) gives the plain routes' bytes
exactly. A 2^26 solver step under WH_OBS_DIR makes the host syncs and
device operations of the same step with tracing off.
"""

import json
import re
import threading

import numpy as np
import pytest
import torch

from wormhole_tpu_torch import native
from wormhole_tpu_torch.data.parsers import parse_libsvm, parse_text
from wormhole_tpu_torch.data.synth import tile_edge_text
from wormhole_tpu_torch.ops import _cuda
from wormhole_tpu_torch.ops import coo_kernels as ck
from wormhole_tpu_torch.ops import fused_update as fu
from wormhole_tpu_torch.ops import hist as hk

DTYPES = [torch.float32, torch.bfloat16]
HYPER = dict(lr_eta=0.5, lr_beta=1.0, lambda_l1=0.3, lambda_l2=0.1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _sum_close(got, want, mag):
    err = (got - want).abs()
    assert (err <= 1e-4 + 1e-5 * mag).all(), float(err.max())


def _graph_ops(call, stream):
    """The device operations `call` enqueues, as a CUDA graph captured on
    `stream` records them: a list of (kind, label), kind "memset" or
    "kernel", from the graph's DOT dump. A capture holds exactly what the
    call enqueued on its stream, nothing of another stream, thread or
    test, and no record can go missing (a torch.profiler session in a
    full-file run lost some of its operations' activity records), and a
    host sync inside the call fails the capture."""
    import os
    import tempfile

    g = torch.cuda.CUDAGraph(keep_graph=True)  # kept for the dump
    with torch.cuda.graph(g, stream=stream):
        call()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        g.enable_debug_mode()
        g.debug_dump(path)
        with open(path) as f:
            text = f.read()
    del g
    # a node's definition starts a line with its quoted name and its
    # attributes, up to "];" (an edge's line starts `"a" -> "b" [`)
    nodes = re.findall(r'^\s*"[^"\s]*node_\d+"\s*\[(.*?)\];', text,
                       flags=re.S | re.M)
    assert nodes, text[:2000]
    return [("memset" if "MEMSET" in node.upper() else "kernel", node)
            for node in nodes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_coo_kernels_match_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    num_rows, nb = 256, 2 * ck.TILE
    idx = (rng.zipf(1.3, size=num_rows * 13) % nb).astype(np.int32)
    seg = np.repeat(np.arange(num_rows, dtype=np.int32), 13)
    val = rng.normal(size=idx.size).astype(np.float32)
    val[rng.random(idx.size) < 0.1] = 0.0
    p = ck.pack_sorted_coo(idx, seg, val, nb)
    args = [torch.from_numpy(a).to(cuda)
            for a in (p.idx, p.seg, p.val, p.tmap, p.first)]
    w = torch.randn(nb, device=cuda)
    d = torch.randn(num_rows, device=cuda)
    n0 = dict(_cuda.LAUNCHES)
    got = ck.coo_spmv(w, *args, num_rows, dtype=dtype)
    want = ck.coo_spmv_plain(w, *args[:3], num_rows, dtype)
    mag = ck.coo_spmv_plain(w.abs(), args[0], args[1], args[2].abs(),
                            num_rows, torch.float32)
    _sum_close(got, want, mag)
    got = ck.coo_spmv_t(d, *args, nb, dtype=dtype)
    want = ck.coo_spmv_t_plain(d, *args[:3], nb, dtype)
    mag = ck.coo_spmv_t_plain(d.abs(), args[0], args[1], args[2].abs(), nb,
                              torch.float32)
    _sum_close(got, want, mag)
    assert not got[mag == 0].any()  # untouched buckets exactly zero
    assert _cuda.LAUNCHES["coo_spmv"] == n0["coo_spmv"] + 1
    assert _cuda.LAUNCHES["coo_spmv_t"] == n0["coo_spmv_t"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ftrl", "adagrad", "sgd"])
def test_compact_kernels_match_plain(cuda, algo):
    rng = np.random.default_rng(2)
    nb = 4 * ck.TILE
    uniq = np.unique(rng.integers(0, nb, size=3000))
    ts = ck.assign_tile_slots(uniq, ck.TILE, 8 * ck.BLK_U, nb)
    slots = torch.from_numpy(ts.uniq).to(cuda)
    live = slots < nb
    g = torch.where(live, torch.randn(slots.numel(), device=cuda), 0.0)
    g[torch.nonzero(live).flatten()[::7]] = 0.0
    base = {"w": torch.randn(nb, device=cuda),
            "z": torch.randn(nb, device=cuda),
            "n": 3 * torch.rand(nb, device=cuda)}
    base["w"][::5] = 0.0
    names = {"ftrl": ("z", "n", "w"), "adagrad": ("n", "w"),
             "sgd": ("w",)}[algo]
    for dtype in DTYPES:
        got = ck.tile_gather(base["w"].view(-1, 128), slots, None, dtype)
        want = ck.tile_gather_plain(base["w"].view(-1, 128), slots, dtype)
        assert torch.equal(got, want)
        assert not got[~live].any()
        for fb in (0, 1, 2):
            sk = {k: base[k].clone() for k in names}
            sp = {k: base[k].clone() for k in names}
            _, nw_k = fu.scatter_update(algo, sk, g, slots, None, None,
                                        None, fixed_bytes=fb, dtype=dtype,
                                        **HYPER)
            nw_p = fu.scatter_update_plain(algo, sp, g, slots,
                                           fixed_bytes=fb, dtype=dtype,
                                           **HYPER)
            for k in names:
                torch.testing.assert_close(sk[k], sp[k], rtol=1e-5,
                                           atol=1e-6)
            assert int(nw_k) == int(nw_p)


@pytest.mark.cuda
def test_wrapper_rejects_cpu_index_on_cuda(cuda):
    w = torch.zeros(ck.TILE, device=cuda)
    z = torch.zeros(4096, dtype=torch.int32)
    with pytest.raises(ValueError):
        ck.coo_spmv(w, z, z.to(cuda), torch.zeros(4096, device=cuda), None,
                    None, 128)


def _fm_stream(rows, hot, n_other, spare_blocks, seed):
    """A slot-sorted V-side stream over `rows` compact rows: one hot row
    whose run crosses many FM_BLK blocks, other rows with a few entries,
    and trailing spare blocks of pads (one long all-zero run)."""
    rng = np.random.default_rng(seed)
    slots = np.concatenate([np.full(hot, 3, np.int64),
                            rng.integers(0, rows // 2, size=n_other)])
    seg = rng.integers(0, 256, size=slots.size).astype(np.int32)
    val = rng.normal(size=slots.size).astype(np.float32)
    cap = slots.size + spare_blocks * ck.FM_BLK
    return ck.pack_sorted_coo(slots, seg, val, rows, capacity=cap,
                              tile=ck.TILE_HI, blk=ck.FM_BLK)


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True], ids=["blocks", "ragged"])
@pytest.mark.parametrize("dim", [1, 8, 32, 128])
def test_fm_kernels_match_plain(cuda, dim, ragged):
    rows = 8 * ck.TILE_HI
    p = _fm_stream(rows, hot=40 * ck.FM_BLK + 7, n_other=9000,
                   spare_blocks=70, seed=dim)
    # ragged: a prefix that ends inside a chunk of the kernel
    n = p.idx.size - 300 if ragged else p.idx.size
    sidx = torch.from_numpy(p.idx[:n]).to(cuda)
    val = torch.from_numpy(p.val[:n]).to(cuda)
    live = val != 0
    a = torch.randn(n, dim, device=cuda) * live[:, None]
    b = torch.randn(n, device=cuda) * live
    Vc = torch.randn(rows, dim, device=cuda)
    n0 = dict(_cuda.LAUNCHES)
    for dtype in DTYPES:
        got = ck.fm_push_contrib(Vc, a, b, sidx, None, None, dtype)
        again = ck.fm_push_contrib(Vc, a, b, sidx, None, None, dtype)
        assert torch.equal(got, again)  # no atomics: the same every run
        want = ck.fm_push_contrib_plain(Vc, a, b, sidx, dtype)
        mag = ck.fm_push_contrib_plain(Vc.abs(), a.abs(), -b.abs(), sidx,
                                       torch.float32)
        _sum_close(got, want, mag)
        touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
        touched[sidx[live].long()] = True
        assert not got[~touched].any()  # rows with no entry exactly 0
    assert _cuda.LAUNCHES["fm_push_contrib"] == n0["fm_push_contrib"] + 4

    vb = 4 * ck.TILE // dim
    ts = ck.assign_tile_slots(np.unique(np.random.default_rng(3).integers(
        0, vb, size=3000)), ck.TILE // dim, 8 * ck.BLK_U, vb)
    uniq = torch.from_numpy(ts.uniq).to(cuda)
    V = torch.randn(vb, dim, device=cuda)
    nV = torch.rand(vb, dim, device=cuda)
    gV = torch.randn(uniq.numel(), dim, device=cuda)
    vt = (torch.rand(uniq.numel(), device=cuda) < 0.8).float()
    hyper = dict(V_lr_eta=0.1, V_lr_beta=1.0, lambda_V=0.01)
    for dtype in DTYPES:
        got = fu.row_tile_gather(V.view(-1, 128), uniq, None, dim, dtype)
        assert torch.equal(got, fu.row_tile_gather_plain(
            V.view(-1, 128), uniq, dim, dtype))
        assert not got[uniq == vb].any()
        Vk, nVk, Vp, nVp = V.clone(), nV.clone(), V.clone(), nV.clone()
        fu.v_scatter_update(Vk, nVk, gV, vt, uniq, None, None, None,
                            dim=dim, dtype=dtype, **hyper)
        fu.v_scatter_update_plain(Vp, nVp, gV, vt, uniq, dim=dim,
                                  dtype=dtype, **hyper)
        torch.testing.assert_close(Vk, Vp, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(nVk, nVp, rtol=1e-5, atol=1e-6)
        moved = (Vk != V).any(1)
        hit = uniq[(uniq < vb) & (vt > 0)].long()
        moved[hit] = False
        assert not moved.any()  # untouched rows unchanged


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_scatter_update_additive_table(cuda, dtype):
    rng = np.random.default_rng(4)
    nb = 4 * ck.TILE
    ts = ck.assign_tile_slots(np.unique(rng.integers(0, nb, size=3000)),
                              ck.TILE, 8 * ck.BLK_U, nb)
    slots = torch.from_numpy(ts.uniq).to(cuda)
    live = slots < nb
    g = torch.where(live, torch.randn(slots.numel(), device=cuda), 0.0)
    add = torch.where(live, torch.randint(0, 40, (slots.numel(),),
                                          device=cuda).float(), 0.0)
    base = {"w": torch.randn(nb, device=cuda),
            "z": torch.randn(nb, device=cuda),
            "n": 3 * torch.rand(nb, device=cuda),
            "cnt": torch.randint(0, 9, (nb,), device=cuda).float()}
    sk = {k: v.clone() for k, v in base.items()}
    sp = {k: v.clone() for k, v in base.items()}
    _, nw_k = fu.scatter_update("ftrl", sk, g, slots, None, None, None,
                                dtype=dtype, add_table="cnt",
                                add_values=add, **HYPER)
    nw_p = fu.scatter_update_plain("ftrl", sp, g, slots, dtype=dtype,
                                   add_table="cnt", add_values=add, **HYPER)
    for k in base:
        torch.testing.assert_close(sk[k], sp[k], rtol=1e-5, atol=1e-6)
    assert torch.equal(sk["cnt"], sp["cnt"])  # integer counts: exact
    assert int(nw_k) == int(nw_p)


def _hist_inputs(cuda, rows, F, B, nodes, seed, binary=False, inactive=0.3,
                 layout="uniform"):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, 2 if binary else B, (rows, F)).astype(np.uint8)
    rel = rng.integers(0, nodes, rows).astype(np.int32)
    rel[rng.random(rows) < inactive] = nodes
    if layout == "skewed":     # node 0 holds 99% of the rows in the level
        rel[rel < nodes] = np.where(rng.random(int((rel < nodes).sum()))
                                    < 0.99, 0, rel[rel < nodes])
    return (torch.from_numpy(binned).to(cuda),
            torch.from_numpy(rng.standard_normal(rows).astype(np.float32)
                             ).to(cuda),
            torch.from_numpy(rng.random(rows).astype(np.float32)).to(cuda),
            torch.from_numpy(rel).to(cuda))


# rows, F, B, nodes, layout: one row; ragged rows; several rows to a warp
# pass (F <= 16); the HIGGS width over 1 and 16 nodes; features over 32
# lanes and over feature tiles; bins not a multiple of 4 (scalar merge);
# one node with 99% of the rows beside tiny or empty ones; 256 nodes
HIST_SHAPES = [(1, 1, 16, 1, "uniform"), (600, 5, 16, 4, "uniform"),
               (5000, 1, 256, 4, "uniform"), (5000, 16, 32, 3, "uniform"),
               (70001, 28, 256, 1, "uniform"),
               (70001, 28, 256, 16, "uniform"),
               (20000, 40, 64, 2, "uniform"), (20000, 126, 256, 2, "uniform"),
               (3000, 7, 10, 3, "uniform"), (200003, 28, 256, 16, "skewed"),
               (70001, 28, 256, 256, "uniform")]


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [False, True], ids=["bins", "binary"])
@pytest.mark.parametrize("rows,F,B,nodes,layout", HIST_SHAPES)
def test_level_hist_matches_plain(cuda, rows, F, B, nodes, layout, binary):
    binned, g, h, rel = _hist_inputs(cuda, rows, F, B, nodes,
                                     seed=rows + F + nodes, binary=binary,
                                     layout=layout)
    n0 = dict(_cuda.LAUNCHES)
    G, H = hk.level_hist(binned, g, h, rel, nodes, B)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["level_hist"] == n0["level_hist"] + 1
    assert _cuda.LAUNCHES["level_partition"] == n0["level_partition"] + 1
    assert G.shape == H.shape == (nodes, F, B)
    Gp, Hp = hk.level_hist_plain(binned, g, h, rel, nodes, B,
                                 acc_dtype=torch.float64)
    Gmag, cnt = hk.level_hist_plain(binned, g.abs(), torch.ones_like(h), rel,
                                    nodes, B, acc_dtype=torch.float64)
    _sum_close(G, Gp, Gmag)
    _sum_close(H, Hp, Hp)
    assert not G[cnt == 0].any() and not H[cnt == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_inactive", "empty_node", "wild_rel",
                                  "bad_bin"])
def test_level_hist_edges(cuda, case):
    rows, F, B, nodes = 5000, 28, 64, 4
    binned, g, h, rel = _hist_inputs(cuda, rows, F, B, nodes, seed=9)
    if case == "all_inactive":
        rel[:] = nodes
    elif case == "empty_node":
        rel[rel == 2] = nodes
    elif case == "wild_rel":   # any rel outside [0, nodes) drops out
        out = rel == nodes
        rel[out] = torch.where(torch.arange(int(out.sum()), device=cuda) % 2
                               == 0, -3, nodes + 5).to(torch.int32)
    else:                      # a bin id >= B adds nothing
        binned[::7, 3] = B + 1
    G, H = hk.level_hist(binned, g, h, rel, nodes, B)
    keep = binned < B
    Gp, Hp = hk.level_hist_plain(torch.where(keep, binned, 0), g, h, rel,
                                 nodes, B)
    if case == "bad_bin":      # the plain version has no such guard
        drop = ~keep[:, 3] & (rel >= 0) & (rel < nodes)
        Gp[:, 3, 0].index_add_(0, rel[drop].long(), -g[drop])
        Hp[:, 3, 0].index_add_(0, rel[drop].long(), -h[drop])
    torch.testing.assert_close(G, Gp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(H, Hp, rtol=1e-4, atol=1e-4)
    if case == "all_inactive":
        assert not G.any() and not H.any()
    if case == "empty_node":
        assert not G[2].any() and not H[2].any()


@pytest.mark.cuda
def test_level_hist_rejects_wrong_types_on_cuda(cuda):
    binned, g, h, rel = _hist_inputs(cuda, 64, 3, 16, 2, seed=1)
    with pytest.raises(ValueError, match="binned"):
        hk.level_hist(binned.int(), g, h, rel, 2, 16)
    with pytest.raises(ValueError, match="rel"):
        hk.level_hist(binned, g, h, rel.long(), 2, 16)
    with pytest.raises(ValueError):
        hk.level_hist(binned, g, h, rel.cpu(), 2, 16)
    with pytest.raises(ValueError, match="contiguous"):
        hk.level_hist(binned.t().contiguous().t(), g, h, rel, 2, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,F,B,nodes,layout", HIST_SHAPES)
def test_level_partition_matches_plain(cuda, rows, F, B, nodes, layout):
    """The partition kernels give the stable sort exactly: node_start,
    and the first node_start[-1] entries of order."""
    _, _, _, rel = _hist_inputs(cuda, rows, 1, 2, nodes, seed=rows + nodes,
                                layout=layout)
    rel[::11] = -5             # any rel outside [0, nodes) drops out
    n0 = _cuda.LAUNCHES["level_partition"]
    order, start = hk.level_partition(rel, nodes)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["level_partition"] == n0 + 1
    want_order, want_start = hk.level_partition_plain(rel, nodes)
    assert torch.equal(start, want_start)
    assert torch.equal(order[:int(start[-1])], want_order)


@pytest.mark.cuda
def test_level_hist_syncs_nothing_in_five_launches(cuda):
    """No host sync in the wrapper (CUDA's sync debug mode raises on
    one), and at most five launches a call, the memset included."""
    binned, g, h, rel = _hist_inputs(cuda, 70001, 28, 256, 16, seed=3)
    hk.level_hist(binned, g, h, rel, 16, 256)      # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hk.level_hist(binned, g, h, rel, 16, 256)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        hk.level_hist(binned, g, h, rel, 16, 256)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(device_ops) <= 5, device_ops


# The fixed point (csrc/hist.cu): level_hist gives level_hist_fixed_plain's
# bits, the same in every launch and in any order of the rows.
@pytest.mark.cuda
@pytest.mark.parametrize("rows,F,B,nodes,layout", HIST_SHAPES)
def test_level_hist_is_the_fixed_point_rule_bit_for_bit(cuda, rows, F, B,
                                                        nodes, layout):
    binned, g, h, rel = _hist_inputs(cuda, rows, F, B, nodes,
                                     seed=rows + F + nodes + 1, layout=layout)
    G, H = hk.level_hist(binned, g, h, rel, nodes, B)
    Gf, Hf = hk.level_hist_fixed_plain(binned, g, h, rel, nodes, B)
    assert torch.equal(G, Gf) and torch.equal(H, Hf)
    p = torch.randperm(rows, device=cuda)
    G2, H2 = hk.level_hist(binned[p].contiguous(), g[p].contiguous(),
                           h[p].contiguous(), rel[p].contiguous(), nodes, B)
    assert torch.equal(G2, G) and torch.equal(H2, H)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inf", "nan", "both-inf", "zeros"])
def test_level_hist_non_finite_and_zero_g(cuda, case):
    """Non-finite g and h flag their cells (+-inf, or nan) as the plain f32
    sums have them, every other cell keeps its finite sum; all-zero g and
    h give zeros."""
    rows, F, B, nodes = 20000, 28, 64, 4
    binned, g, h, rel = _hist_inputs(cuda, rows, F, B, nodes, seed=21)
    if case == "zeros":
        g.zero_()
        h.zero_()
    else:
        g[5] = float("nan") if case == "nan" else float("inf")
        if case == "both-inf":
            binned[9] = binned[5]
            rel[9] = rel[5]
            g[9] = -float("inf")
        h[7] = float("inf")
    G, H = hk.level_hist(binned, g, h, rel, nodes, B)
    Gf, Hf = hk.level_hist_fixed_plain(binned, g, h, rel, nodes, B)
    Gp, Hp = hk.level_hist_plain(binned, g, h, rel, nodes, B)
    for got, fixed, plain in ((G, Gf, Gp), (H, Hf, Hp)):
        assert torch.equal(got.isnan(), plain.isnan())
        assert torch.equal(got.isinf() & (got > 0), plain.isinf() & (plain > 0))
        assert torch.equal(got.isinf() & (got < 0), plain.isinf() & (plain < 0))
        fin = got.isfinite()
        assert torch.equal(got[fin], fixed[fin])
    if case == "zeros":
        assert not G.any() and not H.any()


def _round_levels(cuda, monkeypatch, rows=200_000, depth=6, B=256):
    """(binned, [(g, h, rel, num_nodes)]): the inputs of level_hist at
    each of the six levels of a real boosting round (the learner's second
    round, at the HIGGS widths)."""
    from wormhole_tpu_torch.data.synth import synth_higgs
    from wormhole_tpu_torch.models import gbdt

    X, y = synth_higgs(np.random.default_rng(5), rows, 28)
    edges = gbdt.quantile_edges(X[:1 << 17], B)
    lrn = gbdt.GbdtLearner(gbdt.GbdtConfig(
        dim=28, max_depth=depth, num_round=2, eta=0.3, max_bin=B,
        hist_kernel="mxu"), device=cuda)
    lrn.edges = edges
    ds = gbdt.BinnedDataset(
        binned=torch.from_numpy(gbdt.bin_matrix(X, edges)).to(cuda),
        label=torch.from_numpy(y).to(cuda),
        mask=torch.ones(rows, device=cuda), num_real=rows)
    calls = []
    real = gbdt.level_hist

    def recording(binned, g, h, rel, num_nodes, B):
        calls.append((g.clone(), h.clone(), rel.clone(), num_nodes))
        return real(binned, g, h, rel, num_nodes, B)

    monkeypatch.setattr(gbdt, "level_hist", recording)
    _, _, margin = lrn._round(ds, lrn._base_margins(ds))
    calls.clear()
    lrn._round(ds, margin)
    assert [c[3] for c in calls] == [1] + [2 ** d for d in range(depth - 1)]
    return ds.binned, calls


@pytest.mark.cuda
def test_level_hist_same_bits_at_a_rounds_six_levels(cuda, monkeypatch):
    """Two launches at each level of a real round give equal bits, so do
    the level's rows permuted within their nodes, and both are the fixed
    point rule's bits, within the bar of the f64 sums."""
    binned, calls = _round_levels(cuda, monkeypatch)
    B = 256
    for g, h, rel, nodes in calls:
        G, H = hk.level_hist(binned, g, h, rel, nodes, B)
        G2, H2 = hk.level_hist(binned, g, h, rel, nodes, B)
        assert torch.equal(G, G2) and torch.equal(H, H2), nodes
        # rows permuted within each node: a stable sort of a random
        # permutation by node keeps every node's rows, in another order
        p = torch.randperm(rel.numel(), device=cuda)
        p = p[torch.sort(rel[p], stable=True).indices]
        G3, H3 = hk.level_hist(binned[p].contiguous(), g[p].contiguous(),
                               h[p].contiguous(), rel[p].contiguous(), nodes,
                               B)
        assert torch.equal(G3, G) and torch.equal(H3, H), nodes
        Gf, Hf = hk.level_hist_fixed_plain(binned, g, h, rel, nodes, B)
        assert torch.equal(G, Gf) and torch.equal(H, Hf), nodes
        Gp, Hp = hk.level_hist_plain(binned, g, h, rel, nodes, B,
                                     acc_dtype=torch.float64)
        Gmag, _ = hk.level_hist_plain(binned, g.abs(), h, rel, nodes, B,
                                      acc_dtype=torch.float64)
        _sum_close(G, Gp, Gmag)
        _sum_close(H, Hp, Hp)


@pytest.mark.cuda
def test_level_totals_same_bits_on_the_card_and_the_cpu(cuda):
    """The GBDT learner's node totals: two calls on the card give equal
    bits, the rows permuted too, and they are the CPU's bits (exact
    integer sums, then the same f64 steps)."""
    from wormhole_tpu_torch.models.gbdt import _TOTALS_WAYS

    rng = np.random.default_rng(23)
    rows, nodes = 2_000_000, 32
    g = torch.from_numpy(rng.standard_normal(rows).astype(np.float32))
    h = torch.from_numpy(rng.random(rows).astype(np.float32))
    rel = torch.from_numpy(rng.integers(0, nodes + 1, rows).astype(np.int32))
    want = hk.level_totals(g, h, rel, nodes, ways=_TOTALS_WAYS)
    gc, hc, rc = g.to(cuda), h.to(cuda), rel.to(cuda)
    got = hk.level_totals(gc, hc, rc, nodes, ways=_TOTALS_WAYS)
    again = hk.level_totals(gc, hc, rc, nodes, ways=_TOTALS_WAYS)
    p = torch.randperm(rows, device=cuda)
    moved = hk.level_totals(gc[p], hc[p], rc[p], nodes, ways=_TOTALS_WAYS)
    assert torch.equal(got, again) and torch.equal(got, moved)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_gbdt_rounds_deterministic_on_the_card(cuda, monkeypatch):
    """Two rounds of the GBDT learner on the card under
    torch.use_deterministic_algorithms(True) (which raises on an op with
    no deterministic version): no op raises, and two fits give equal
    trees bit for bit."""
    from wormhole_tpu_torch.data.synth import synth_higgs
    from wormhole_tpu_torch.models import gbdt

    rows, B = 100_000, 256
    X, y = synth_higgs(np.random.default_rng(6), rows, 28)
    edges = gbdt.quantile_edges(X[:1 << 17], B)
    binned = torch.from_numpy(gbdt.bin_matrix(X, edges)).to(cuda)
    trees = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            lrn = gbdt.GbdtLearner(gbdt.GbdtConfig(
                dim=28, max_depth=6, num_round=2, eta=0.3, max_bin=B,
                hist_kernel="mxu"), device=cuda)
            lrn.edges = edges
            ds = gbdt.BinnedDataset(binned=binned,
                                    label=torch.from_numpy(y).to(cuda),
                                    mask=torch.ones(rows, device=cuda),
                                    num_real=rows)
            lrn.fit_prepared(ds, [], verbose=False)
            trees.append(lrn.trees)
    finally:
        torch.use_deterministic_algorithms(False)
    for k in trees[0]:
        assert np.array_equal(trees[0][k], trees[1][k]), k


def _edge_stream(case, rows, dim, seed):
    """The FM push's edge streams (as in tests/test_torch_fm_kernels.py,
    packed by the port's own host function): a run over 41 chunks, runs
    ending on chunk and thread edges, a zero-sum live run before a tile's
    pads, only one-entry runs, pads only."""
    rng = np.random.default_rng(seed)
    chunk = ck._FM_CHUNK
    if case == "long-run":
        slots = np.concatenate([np.full(41 * chunk + 5, 3),
                                rng.integers(0, rows, size=2000)])
    elif case == "cta-edge":
        slots = np.concatenate([np.full(2 * chunk, 1), np.full(chunk, 2),
                                np.full(24, 4),
                                rng.integers(5, rows, size=3000)])
    elif case == "zero-sum-pads":
        slots = np.concatenate([rng.integers(0, ck.TILE_HI - 1, size=900),
                                [ck.TILE_HI - 1] * 2,
                                rng.integers(ck.TILE_HI, rows, size=900)])
    elif case == "singletons":
        slots = rng.permutation(rows)[:rows // 2]
    else:
        slots = np.zeros(0, np.int64)
    val = rng.normal(size=slots.size).astype(np.float32)
    val[val == 0] = 1.0
    p = ck.pack_sorted_coo(slots, np.zeros(slots.size, np.int32), val, rows,
                           capacity=slots.size + 2 * ck.FM_BLK,
                           tile=ck.TILE_HI, blk=ck.FM_BLK)
    live = p.val != 0
    a = (rng.normal(size=(p.idx.size, dim)) * live[:, None]).astype(np.float32)
    b = (rng.normal(size=p.idx.size) * live).astype(np.float32)
    if case == "zero-sum-pads":
        e0, e1 = np.flatnonzero(live & (p.idx == ck.TILE_HI - 1))
        a[e1], b[e1] = -a[e0], -b[e0]
    return p, a, b, rng.normal(size=(rows, dim)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("case", ["long-run", "cta-edge", "zero-sum-pads",
                                  "singletons", "empty"])
def test_fm_push_contrib_edge_streams(cuda, case, dim):
    rows = 4 * ck.TILE_HI
    p, a, b, Vc = _edge_stream(case, rows, dim, seed=dim + len(case))
    to = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    sidx, a_t, b_t, V_t = to(p.idx), to(a), to(b), to(Vc)
    touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
    touched[sidx[to(p.val) != 0].long()] = True
    mag = ck.fm_push_contrib_plain(V_t.abs(), a_t.abs(), -b_t.abs(), sidx,
                                   torch.float32)
    for dtype in DTYPES:
        got = ck.fm_push_contrib(V_t, a_t, b_t, sidx, None, None, dtype)
        again = ck.fm_push_contrib(V_t, a_t, b_t, sidx, None, None, dtype)
        assert torch.equal(got, again)  # no atomics: the same every run
        _sum_close(got, ck.fm_push_contrib_plain(V_t, a_t, b_t, sidx, dtype),
                   mag)
        mirror = ck.fm_push_mirror(Vc, a, b, p.idx,
                                   bf16=dtype == torch.bfloat16)
        _sum_close(got, to(mirror), mag)
        assert not got[~touched].any()  # rows with no entry exactly 0
        if case == "zero-sum-pads":
            assert not got[ck.TILE_HI - 1].any()


def _update_slots(layout, rng):
    """(num_buckets, uniq) for scatter_update: the pack's layout with
    sentinels moved into the middle of blocks, all sentinels, one block,
    or the 2^26 path's 1,572,864 slots with 167,650 live keys."""
    if layout == "u_cap-2^26":
        nb, n_keys, u_cap = 1 << 26, 167_650, 1_572_864
    else:
        nb, n_keys, u_cap = 4 * ck.TILE, 3000, 8 * ck.BLK_U
    keys = np.unique(rng.integers(0, nb, size=n_keys + n_keys // 50))
    if layout == "one-block":
        keys = keys[keys < ck.TILE][:700]
        u_cap = ck.BLK_U
    uniq = ck.assign_tile_slots(keys, ck.TILE, u_cap, nb).uniq
    if layout == "mid-block":
        for blk in uniq.reshape(-1, ck.BLK_U):
            rng.shuffle(blk)
    elif layout == "all-sentinel":
        uniq[:] = nb
    return nb, uniq


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ftrl", "adagrad", "sgd"])
@pytest.mark.parametrize("layout", ["mid-block", "all-sentinel", "one-block",
                                    "u_cap-2^26"])
def test_scatter_update_layouts(cuda, layout, algo):
    """Every algo, filter and type, with the additive table, on slot
    layouts the pack never gives as well as the ones it does."""
    rng = np.random.default_rng(len(layout))
    nb, uniq_np = _update_slots(layout, rng)
    slots = torch.from_numpy(uniq_np).to(cuda)
    live = slots < nb
    n_live = int(live.sum())
    g = torch.where(live, torch.randn(slots.numel(), device=cuda), 0.0)
    g[torch.nonzero(live).flatten()[::7]] = 0.0
    add = torch.where(live, torch.randint(0, 40, (slots.numel(),),
                                          device=cuda).float(), 0.0)
    base = {"w": torch.randn(nb, device=cuda),
            "z": torch.randn(nb, device=cuda),
            "n": 3 * torch.rand(nb, device=cuda),
            "cnt": torch.randint(0, 9, (nb,), device=cuda).float()}
    base["w"][::5] = 0.0
    names = {"ftrl": ("z", "n", "w"), "adagrad": ("n", "w"),
             "sgd": ("w",)}[algo] + ("cnt",)
    n0 = _cuda.LAUNCHES["scatter_update"]
    for fb in (0, 1, 2):
        for dtype in DTYPES:
            sk = {k: base[k].clone() for k in names}
            sp = {k: base[k].clone() for k in names}
            _, nw_k = fu.scatter_update(algo, sk, g, slots, None, None, None,
                                        fixed_bytes=fb, dtype=dtype,
                                        add_table="cnt", add_values=add,
                                        **HYPER)
            nw_p = fu.scatter_update_plain(algo, sp, g, slots,
                                           fixed_bytes=fb, dtype=dtype,
                                           add_table="cnt", add_values=add,
                                           **HYPER)
            for k in names:
                torch.testing.assert_close(sk[k], sp[k], rtol=1e-5,
                                           atol=1e-6)
            assert torch.equal(sk["cnt"], sp["cnt"])
            # the plain version divides by a scalar as a multiply by its
            # reciprocal on CUDA: a key at the l1 edge may land apart
            assert abs(int(nw_k) - int(nw_p)) <= 1 + n_live // 100000
            if layout == "all-sentinel":
                assert int(nw_k) == 0
                assert all(torch.equal(sk[k], base[k]) for k in names)
    assert _cuda.LAUNCHES["scatter_update"] == n0 + 6


def _v_row_slots(case, dim, rng):
    """Compact V row slots over 4 * TILE // dim rows in 8 BLK_U blocks
    (the pack's layout: a tile's rows first, whole sentinel chunks
    behind), and vtouched with 30% of the rows unadmitted; cut or edited
    to one of the row kernels' edges."""
    vb = 4 * ck.TILE // dim
    uniq = ck.assign_tile_slots(np.unique(rng.integers(0, vb, size=3000)),
                                ck.TILE // dim, 8 * ck.BLK_U, vb).uniq
    vt = (rng.random(uniq.size) < 0.7).astype(np.float32)
    if case == "ragged":        # u_cap ends inside a 128-slot chunk
        uniq, vt = uniq[:-1037], vt[:-1037]
    elif case == "sentinel-chunks":  # chunks 2-4 and half of 5 sentinel
        uniq[256:704] = vb
    elif case == "unadmitted-chunk":  # a chunk of live rows, none admitted
        assert (uniq[:128] < vb).all()
        vt[:128] = 0.0
    elif case == "empty":       # u_cap = 0
        uniq, vt = uniq[:0], vt[:0]
    return vb, uniq, vt


def _v_update_ieee(V, nV, gV, vt, uniq, dtype, eta0, beta, lam):
    """The V handle at the admitted rows in numpy f32, one IEEE operation
    at a time in the kernel's order (true division, correctly rounded
    sqrt), on the host."""
    f = np.float32
    V, nV = V.cpu().numpy().copy(), nV.cpu().numpy().copy()
    sel = ((uniq < V.shape[0]) & (vt > 0)).cpu()
    r = uniq.cpu()[sel].long().numpy()
    g = ck.round_to(gV.cpu()[sel], dtype).numpy()
    n2 = nV[r] + g * g
    eta = (f(beta) + np.sqrt(n2)) / f(eta0)
    V[r] = V[r] - (g + f(lam) * V[r]) / eta
    nV[r] = n2
    return torch.from_numpy(V), torch.from_numpy(nV)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pack", "ragged", "sentinel-chunks",
                                  "unadmitted-chunk", "empty"])
@pytest.mark.parametrize("dim", [1, 2, 4, 8, 16, 32, 64, 128])
def test_v_row_kernels_layouts(cuda, dim, case):
    """row_tile_gather and v_scatter_update at every dim, f32 and bf16, on
    the slot layouts at the row kernels' edges: the gather equal to its
    plain version with sentinel slots exactly 0; the update close to its
    plain version and bit-equal to the same IEEE operations in numpy;
    rows not admitted bit-identical; two calls the same bits; one launch
    a call (none for u_cap = 0)."""
    rng = np.random.default_rng(dim + len(case))
    vb, uniq_np, vt_np = _v_row_slots(case, dim, rng)
    uniq, vt = (torch.from_numpy(uniq_np).to(cuda),
                torch.from_numpy(vt_np).to(cuda))
    V = torch.randn(vb, dim, device=cuda)
    nV = torch.rand(vb, dim, device=cuda)
    gV = torch.randn(uniq.numel(), dim, device=cuda)
    hyper = dict(V_lr_eta=0.1, V_lr_beta=1.0, lambda_V=0.01)
    one = int(uniq.numel() > 0)
    admitted = torch.zeros(vb, dtype=torch.bool, device=cuda)
    admitted[uniq[(uniq < vb) & (vt > 0)].long()] = True
    for dtype in DTYPES:
        n0 = dict(_cuda.LAUNCHES)
        got = fu.row_tile_gather(V.view(-1, 128), uniq, None, dim, dtype)
        again = fu.row_tile_gather(V.view(-1, 128), uniq, None, dim, dtype)
        assert _cuda.LAUNCHES["row_tile_gather"] == \
            n0["row_tile_gather"] + 2 * one
        assert torch.equal(got, fu.row_tile_gather_plain(
            V.view(-1, 128), uniq, dim, dtype))
        assert torch.equal(got, again)
        assert got.shape == (uniq.numel(), dim)
        assert not got[uniq >= vb].any()  # sentinel slots exactly 0

        runs = []
        for _ in range(2):
            Vk, nVk = V.clone(), nV.clone()
            fu.v_scatter_update(Vk, nVk, gV, vt, uniq, None, None, None,
                                dim=dim, dtype=dtype, **hyper)
            runs.append((Vk, nVk))
        assert _cuda.LAUNCHES["v_scatter_update"] == \
            n0["v_scatter_update"] + 2 * one
        (Vk, nVk), (V2, nV2) = runs
        assert torch.equal(Vk, V2) and torch.equal(nVk, nV2)
        Vp, nVp = V.clone(), nV.clone()
        fu.v_scatter_update_plain(Vp, nVp, gV, vt, uniq, dim=dim,
                                  dtype=dtype, **hyper)
        torch.testing.assert_close(Vk, Vp, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(nVk, nVp, rtol=1e-5, atol=1e-6)
        Ve, nVe = _v_update_ieee(V, nV, gV, vt, uniq, dtype, 0.1, 1.0, 0.01)
        assert torch.equal(Vk.cpu(), Ve) and torch.equal(nVk.cpu(), nVe)
        assert torch.equal(Vk[~admitted], V[~admitted])
        assert torch.equal(nVk[~admitted], nV[~admitted])
        if case == "unadmitted-chunk":
            rows0 = uniq[:128].long()
            assert torch.equal(Vk[rows0], V[rows0])


@pytest.mark.cuda
def test_scatter_update_one_launch_no_sync(cuda):
    """With fixed_bytes == 0 a call enqueues one device operation (the
    kernel: no memset, no scale) and never syncs the host. Every call
    runs on one stream of the test's own: the wrapper's scratch is a
    stream's, zeroed by its first call there."""
    rng = np.random.default_rng(7)
    nb, uniq_np = _update_slots("pack", rng)
    slots = torch.from_numpy(uniq_np).to(cuda)
    g = torch.randn(slots.numel(), device=cuda)
    state = {"w": torch.randn(nb, device=cuda),
             "z": torch.randn(nb, device=cuda),
             "n": torch.rand(nb, device=cuda)}
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        fu.scatter_update("ftrl", state, g, slots, None, None, None,
                          dtype=torch.float32, **HYPER)  # builds, scratch
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fu.scatter_update("ftrl", state, g, slots, None, None, None,
                              dtype=torch.float32, **HYPER)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    device_ops = _graph_ops(
        lambda: fu.scatter_update("ftrl", state, g, slots, None, None, None,
                                  dtype=torch.float32, **HYPER), stream)
    assert len(device_ops) == 1, device_ops
    assert device_ops[0][0] == "kernel", device_ops
    assert "scatter_update" in device_ops[0][1], device_ops


def _push_edge_stream(case, seed):
    """The push's edge streams (as in tests/test_torch_kernels.py, packed
    by the port's own host function), over 4 * TILE buckets: a run over
    three BLK edges, runs ending on a BLK edge, tiles of pads only, live
    runs at tile bases with pads behind, keys far apart before a tile's
    pads, live entries with val 0, keys at tile bases, tile ends and the
    table's last bucket; or pack_tile_coo's compact stream."""
    nb, tile, blk = 4 * ck.TILE, ck.TILE, ck.BLK
    rng = np.random.default_rng(seed)
    if case == "compact":
        from wormhole_tpu_torch.data.synth import synth_criteo_batch

        seg, idx, val, _, _ = synth_criteo_batch(rng, 1024, 1 << 22)
        return ck.pack_tile_coo(idx, seg, val, 1 << 22, nb).coo, nb
    spread = rng.integers(0, nb, size=3000)
    if case == "hot-run":
        idx = np.concatenate([np.full(3 * blk + 100, 7), spread])
    elif case == "chunk-edge":
        idx = np.concatenate([np.full(blk, 1), np.full(blk - 5, 2),
                              np.full(5, 3), spread[:500] % tile + tile])
    elif case == "pads-only-tile":
        idx = np.concatenate([spread[:800] % tile,
                              2 * tile + spread[800:1600] % tile])
    elif case == "base-then-pads":
        idx = np.concatenate([np.full(5, tile), np.full(3, 2 * tile),
                              np.full(2, 2 * tile + 9), spread[:200] % tile])
    elif case == "sparse-then-pads":
        idx = np.concatenate([np.arange(1, 301) * 211, spread[:400] % tile
                              + tile])
    elif case == "zero-val":
        idx = np.concatenate([np.full(6, 11), [12], spread[:900]])
    else:
        idx = np.concatenate([[0, tile - 1, tile, 2 * tile - 1, nb - 1] * 3,
                              spread[:700]])
    idx = idx.astype(np.int32)
    seg = rng.integers(0, 256, size=idx.size).astype(np.int32)
    val = rng.normal(size=idx.size).astype(np.float32)
    val[val == 0] = 1.0
    if case == "zero-val":
        val[[2, 6]] = 0.0
    return ck.pack_sorted_coo(idx, seg, val, nb), nb


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hot-run", "chunk-edge", "pads-only-tile",
                                  "base-then-pads", "sparse-then-pads",
                                  "zero-val", "edges", "compact"])
def test_coo_spmv_t_edge_streams(cuda, case):
    """The push on its edge streams against the plain version; untouched
    buckets exactly 0."""
    p, nb = _push_edge_stream(case, seed=len(case))
    to = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    sidx, sseg, sval = to(p.idx), to(p.seg), to(p.val)
    d = to(np.random.default_rng(5).normal(size=1024).astype(np.float32))
    mag = ck.coo_spmv_t_plain(d.abs(), sidx, sseg, sval.abs(), nb,
                              torch.float32)
    n0 = _cuda.LAUNCHES["coo_spmv_t"]
    for dtype in DTYPES:
        got = ck.coo_spmv_t(d, sidx, sseg, sval, None, None, nb, dtype)
        _sum_close(got, ck.coo_spmv_t_plain(d, sidx, sseg, sval, nb, dtype),
                   mag)
        assert not got[mag == 0].any()  # untouched buckets exactly 0
    assert _cuda.LAUNCHES["coo_spmv_t"] == n0 + 2


@pytest.mark.cuda
def test_coo_spmv_t_no_sync(cuda):
    """A push call enqueues the output's memset and one kernel, and never
    syncs the host."""
    p, nb = _push_edge_stream("hot-run", seed=3)
    to = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    args = (to(p.idx), to(p.seg), to(p.val), None, None, nb)
    d = torch.randn(256, device=cuda)
    ck.coo_spmv_t(d, *args)  # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ck.coo_spmv_t(d, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(cuda)

    def three_calls():
        for _ in range(3):
            ck.coo_spmv_t(d, *args)

    device_ops = _graph_ops(three_calls, stream)
    assert len(device_ops) == 6, device_ops
    assert sum(kind == "kernel" and "push_kernel" in lab
               for kind, lab in device_ops) == 3, device_ops
    assert sum(kind == "memset" for kind, _ in device_ops) == 3, device_ops


@pytest.mark.cuda
@pytest.mark.parametrize("num_rows", [128, 1 << 16, 8 * 16384 + 128])
def test_coo_spmv_row_counts(cuda, num_rows):
    """The pull on a skewed batch at 128 rows, at 65,536 (the main
    path's) and at 131,200."""
    rng = np.random.default_rng(num_rows)
    nb, nnz = 8 * ck.TILE, 200_000
    idx = (rng.zipf(1.3, size=nnz) % nb).astype(np.int32)
    seg = rng.integers(0, num_rows, size=nnz).astype(np.int32)
    val = rng.normal(size=nnz).astype(np.float32)
    val[rng.random(nnz) < 0.1] = 0.0
    p = ck.pack_sorted_coo(idx, seg, val, nb)
    sidx, sseg, sval = (torch.from_numpy(a).to(cuda)
                        for a in (p.idx, p.seg, p.val))
    w = torch.randn(nb, device=cuda)
    mag = ck.coo_spmv_plain(w.abs(), sidx, sseg, sval.abs(), num_rows,
                            torch.float32)
    n0 = _cuda.LAUNCHES["coo_spmv"]
    for dtype in DTYPES:
        got = ck.coo_spmv(w, sidx, sseg, sval, None, None, num_rows, dtype)
        _sum_close(got, ck.coo_spmv_plain(w, sidx, sseg, sval, num_rows,
                                          dtype), mag)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["coo_spmv"] == n0 + 2


# ------------------------------------------------------- host data path
# The libsvm edge corpus. tests/test_torch_parse.py holds the plain parser
# against the JAX package's on it, and the card parser's mirror against
# the plain parser; here the card parser meets the plain parser.
LIBSVM_EDGE = {
    "comments-blank": "# a header\n\n1 3:1 5:1\n  # indented 1:2\n\n0 2\n#\n",
    "bare-keys": "1 3 5 7\n0 2\n1\n",
    "no-final-newline": "1 3:1\n0 4:2",
    "crlf-tabs-spaces": "1\t3:1   5:2\r\n0  \t 4 \r\n\r\n  1 6:0.5\t\n",
    "signs-decimals-exponents": ("-1 3:-2.5 4:1e3 5:+0.125\n"
                                 "+1.5e-1 2:-3E+2 6:.5 7:5. 8:1.25e-7\n"
                                 "-0 9:-0.0 10:0007.50\n"),
    "max-keys": "1 18446744073709551615:1 0:2 09223372036854775808\n",
    "outside-fast-path": ("1 1:1.00000000000000000001 2:12345678901234567890 "
                          "3:1e300 4:inf 5:nan 6:-inf 7:1_0 8:1e-400 "
                          "9:9007199254740993 10:0.1e-22\n1e30 11:Infinity\n"),
    "all-ones": "1 3:1 4:1.0 5:1e0 6 7:100e-2\n0 8:1.000\n",
    "underscores-words": ("1_0 1_2:3_0.5 +7:1e1_0 -0:nAn 8:-INFINITY\n"
                          "-nan 9:+inf 1_0_0:0_0.0_1\n"),
    "exact-path": ("0.30000000000000004 1:1.2345678901234567e-05 "
                   "2:4.9406564584124654e-324 3:1.7976931348623157e308\n"
                   "1 4:2.2250738585072011e-308 "
                   "5:0.1000000000000000055511151231257827\n"
                   "0 6:" + "1" * 900 + "e-880 7:1.5" + "0" * 850 + "1\n"),
}
# decimals of each corpus entry that the kernel's exact path converts
LIBSVM_EDGE_EXACT = {"outside-fast-path": 6, "exact-path": 8}
# chunks the plain parser refuses; the card's raises ValueError
LIBSVM_ERRORS = {
    "negative-key": "1 3:1\n0 -2:1\n",
    "key-2^64": "1 18446744073709551616:1\n",
    "bad-token": "1 3:1 x:1\n",
    "control-byte": "1 3:1\n0 2\x013:1\n",
    "misplaced-underscore": "1 3:1__0\n",
    "word-key": "1 inf:1\n",
    "empty-value": "1 3:\n",
    "sign-label": "+ 3:1\n",
    "hex-value": "1 3:0x10\n",
}


def sized_text(size: int, final_newline: bool) -> str:
    """A libsvm chunk of exactly `size` bytes: rows of three tokens, the
    last row padded with blanks to the size."""
    line = "1 3:1.5 4:2\n"
    body = line * max(0, (size - 16) // len(line))
    rest = size - len(body)
    last = "0" + " " * (rest - 1 - final_newline) + "\n" * final_newline
    return body + last


def _same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def same_block(got, want):
    """Two RowBlocks with the same bytes (value None in both, or equal)."""
    for f in ("label", "offset", "index", "value"):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            _same_arrays(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIBSVM_EDGE))
def test_parse_libsvm_kernel_edge_corpus(cuda, name):
    text = LIBSVM_EDGE[name]
    n0 = _cuda.LAUNCHES["parse_libsvm"]
    got = native.parse_libsvm_cuda(text, cuda)
    assert _cuda.LAUNCHES["parse_libsvm"] == n0 + 1
    same_block(got, parse_libsvm(text))
    same_block(parse_text(text.encode(), "libsvm", cuda), got)
    p = native.parse_libsvm_kernel(native.upload(text.encode(), cuda))
    assert int(p.stats[native.EXACT]) == LIBSVM_EDGE_EXACT.get(name, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIBSVM_ERRORS))
def test_parse_libsvm_kernel_raises_where_plain_raises(cuda, name):
    text = LIBSVM_ERRORS[name]
    with pytest.raises((ValueError, OverflowError)):
        parse_libsvm(text)
    with pytest.raises(ValueError):
        native.parse_libsvm_cuda(text, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("values", [False, True, "repr"])
def test_parse_libsvm_kernel_synthetic_chunk(cuda, values):
    """4,096 Criteo-shaped rows, keys only, k:v with %.5f values, or k:v
    with repr() doubles (most through the exact path): the plain parser's
    bytes."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 26, size=(4096, 39))
    vals = rng.normal(size=keys.shape)
    fmt = {False: None, True: "{:.5f}", "repr": "{!r}"}[values]
    lines = []
    for r in range(4096):
        toks = ([f"{k}:" + fmt.format(float(v))
                 for k, v in zip(keys[r], vals[r])] if fmt
                else [str(k) for k in keys[r]])
        lines.append(f"{r % 2} " + " ".join(toks))
    text = "\n".join(lines) + "\n"
    got = native.parse_libsvm_cuda(text, cuda)
    same_block(got, parse_libsvm(text))
    assert got.size == 4096


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, 2, 3, 5, 8, 13, 21, 34, 64, 100,
                                   255, 256, 257, 300])
def test_parse_libsvm_kernel_tile_edges(cuda, shift):
    """The tile-edge corpus (data/synth.py tile_edge_text: each piece
    starts `shift` bytes before a tile edge) at the kernel's own tile
    (16,384 bytes; a shift past 256 puts a token's start before an edge
    and its end past the halo): the plain parser's bytes."""
    text = tile_edge_text("libsvm", 16384, shift)
    same_block(native.parse_libsvm_cuda(text, cuda), parse_libsvm(text))


@pytest.mark.cuda
@pytest.mark.parametrize("size,final_newline", [(1, False)] + [
    (size, nl) for size in (2, 100, 16383, 16384, 16385, 32767, 32768, 32769,
                            5 * 16384 - 1, 5 * 16384, 5 * 16384 + 1)
    for nl in (True, False)])
def test_parse_libsvm_kernel_chunk_sizes(cuda, size, final_newline):
    """Chunks under one tile and around whole numbers of tiles."""
    text = sized_text(size, final_newline)
    assert len(text) == size
    same_block(native.parse_libsvm_cuda(text, cuda), parse_libsvm(text))


# The criteo and adfea edge corpora. tests/test_torch_formats.py holds the
# plain parsers against the JAX package's on them, and the card parsers'
# mirror against the plain parsers; here the card meets the plain parsers.
# "lone-cr" and "underscore-label" of criteo, "negative-fid",
# "fid-past-2^64" and "underscores" of adfea are where the JAX package's
# Python and native C++ parsers disagree: the port follows the Python one.
CRITEO_EDGE = {
    "basic": ("1\t5\t\t3\tab12cd34\t\t9f0e1d2c\n"
              "0\t\t\t\t\t\t\t\t\t\t\t\t\t\t68fd1e64\n"),
    "spaces-in-fields": " 1 \t a b \t  \tc\n0\t\t x\n",
    "crlf-and-blank-lines": "\n\n1\t2\r\n   \n\t\t\t\n \t \n0\t3\r\n\r\n",
    "no-final-newline": "1\t2\t3",
    "label-only-and-trailing-tab": "1\n0\t\n1\t7\t\n",
    "past-39-fields": "1\t" + "\t".join(f"f{i}" for i in range(50)) + "\n",
    "labels": ("0.5\t1\n-1e-3\t2\n+inf\t3\nnan\t4\n1e400\t5\n"
               "0.1000000000000000055511151231257827021181583404541015625"
               "\t6\n"),
    "long-fields": "1\t" + "\t".join("abcdefghijklmnopqrstuvwxyz0123456789"
                                       [:1 + k % 36] * (1 + k // 9)
                                       for k in range(39)) + "\n",
    "lone-cr": "1\t5\r1\t6\n",
    "underscore-label": "1_0\t5\n",
}
# labels of criteo chunks that the plain parser refuses (criteo_test reads
# no label, so the same chunks parse there)
CRITEO_ERRORS = {
    "word-label": "x\t5\n",
    "empty-label": "1\t2\n\t5\n",
    "spaces-label": " \t5\n",
    "inner-space-label": "1 2\t5\n",
    "lone-cr-splits-a-line": "1\t5\rx\t6\n",
    "misplaced-underscore": "1__0\t5\n",
}
ADFEA_EDGE = {
    "basic": "0 3 1 5:3 7:1 9\n1 2 -1 11:2 13:5\n",
    "short-lines": "1 2\n\n1\n0 0 1\n 0 \t 0 \n",
    "tabs-spaces-crlf": "\t0  2\t1\t 3:4 \t5:6 \r\n1 1 0 5:6\r0 0 1 7:8\n",
    "labels": ("a b nan 1:1\na b -0.0 1:1\na b 1e-400 1:1\na b inf 1:1\n"
               "a b 0.5 1:1\na b -2 1:1\na b 1_0 1:1\n"),
    "gid-wraps": "a b 1 12345:1024 12345:-1 12345:2047 12345:512 0:1023\n",
    "bare-keys": "a b 1 18446744073709551615 0 +7 -0 0_1\n",
    "unread-tokens": "x_y ?? 1 3:4\n1:2:3 :: 0 5:6\n",
    "negative-fid": "a b 1 -5:3 -1024:0 -1025:1\n",
    "fid-past-2^64": ("a b 1 %d:12345 %d:7 -%d:-5\n"
                      % (2 ** 70 + 12345, 2 ** 74 + 2048, 10 ** 22 + 7)),
    "underscores": "a b 1 1_000:3 +1_0:-0_0\n",
}
# adfea chunks the plain parser refuses (ValueError, or numpy's
# OverflowError for a bare key outside [0, 2^64))
ADFEA_ERRORS = {
    "word-label": "a b x 1:1\n",
    "bare-key-2^64": "a b 1 18446744073709551616\n",
    "negative-bare-key": "a b 1 -5\n",
    "word-fid": "a b 1 x:1\n",
    "empty-fid": "a b 1 :1\n",
    "empty-gid": "a b 1 1:\n",
    "two-colons": "a b 1 1:2:3\n",
    "misplaced-underscore": "a b 1 1__0:3\n",
}


def format_sized_text(fmt: str, size: int, final_newline: bool) -> str:
    """A criteo or adfea chunk of exactly `size` bytes: kept rows, the
    last padded with blanks to the size."""
    line, head = (("a b 1 3:4\n", "a b 0") if fmt == "adfea"
                  else ("1\t5\tab\n", "0"))
    body = line * max(0, (size - 16) // len(line))
    rest = size - len(body) - final_newline
    if rest < len(head):
        head = "0"
    return body + head + " " * (rest - len(head)) + "\n" * final_newline


def criteo_sweep_text(max_len: int = 300, seed: int = 0) -> str:
    """criteo_test lines, one a token length 0 to max_len, each holding
    the token at field 0 and its reverse, with a byte of shift, at field
    1: every CityHash64 branch, at even and odd offsets."""
    rng = np.random.default_rng(seed)
    lines = []
    for n in range(max_len + 1):
        tok = bytes(rng.integers(0x20, 0x7F, size=n).astype(np.uint8))
        tok = tok.decode()
        lines.append(f"{tok}\t{tok[::-1]}x")
    return "\n".join(lines) + "\n"


# (format, corpus entry) pairs that parse: criteo_test also takes the
# chunks whose labels criteo refuses
FORMAT_EDGE = ([(f, n) for f in ("criteo", "criteo_test")
                for n in sorted(CRITEO_EDGE)]
               + [("criteo_test", n) for n in sorted(CRITEO_ERRORS)]
               + [("adfea", n) for n in sorted(ADFEA_EDGE)])


def format_text(fmt: str, name: str) -> str:
    return (ADFEA_EDGE if fmt == "adfea"
            else {**CRITEO_EDGE, **CRITEO_ERRORS})[name]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,name", FORMAT_EDGE)
def test_parse_format_kernels_edge_corpus(cuda, fmt, name):
    text = format_text(fmt, name)
    want = parse_text(text, fmt)
    key = "parse_adfea" if fmt == "adfea" else "parse_criteo"
    n0 = _cuda.LAUNCHES[key]
    got = parse_text(text, fmt, cuda)
    assert _cuda.LAUNCHES[key] == n0 + 1
    same_block(got, want)
    same_block(parse_text(text.encode(), fmt, cuda), want)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,name", [("criteo", n) for n in sorted(CRITEO_ERRORS)]
                         + [("adfea", n) for n in sorted(ADFEA_ERRORS)])
def test_parse_format_kernels_raise_where_plain_raises(cuda, fmt, name):
    text = (CRITEO_ERRORS if fmt == "criteo" else ADFEA_ERRORS)[name]
    with pytest.raises((ValueError, OverflowError)):
        parse_text(text, fmt)
    with pytest.raises(ValueError, match=r"token .* at byte \d+"):
        parse_text(text, fmt, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["criteo", "criteo_test", "adfea"])
@pytest.mark.parametrize("byte", [0x0B, 0x0C, 0x1C, 0x7F, 0xC3])
def test_parse_format_kernels_refuse_bytes_outside_the_alphabet(cuda, fmt,
                                                                byte):
    raw = b"1 2 1 3:4\t5\n0 1 0 4" + bytes([byte]) + b"5\t6\n"
    with pytest.raises(ValueError, match=r"byte 19 "):
        parse_text(raw, fmt, cuda)


@pytest.mark.cuda
def test_cityhash_on_the_card_every_length(cuda):
    """Tokens of every length 0 to 300 (all four CityHash64 branches):
    the card's keys are the plain parser's."""
    text = criteo_sweep_text()
    got = parse_text(text, "criteo_test", cuda)
    same_block(got, parse_text(text, "criteo_test"))
    assert got.size == 301 and got.nnz == 301 + 301 - 1


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["criteo", "criteo_test", "adfea"])
def test_parse_format_kernels_synthetic_chunk(cuda, fmt):
    """4,096 rows of synthetic Criteo TSV or adfea text: the plain
    parser's bytes; adfea keys at and above 2^63 come back as uint64."""
    from wormhole_tpu_torch.data.synth import (synth_adfea_text,
                                               synth_criteo_tsv)
    rng = np.random.default_rng(4)
    raw = (synth_adfea_text(rng, 4096) if fmt == "adfea"
           else synth_criteo_tsv(rng, 4096))
    got = parse_text(raw, fmt, cuda)
    same_block(got, parse_text(raw, fmt))
    assert got.size == 4096
    if fmt == "adfea":
        assert int(got.index.max()) >= 1 << 63


FORMATS = ["criteo", "criteo_test", "adfea"]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shift", [0, 1, 2, 3, 5, 8, 13, 21, 34, 64, 100,
                                   255, 256, 257, 300])
def test_parse_format_kernels_tile_edges(cuda, fmt, shift):
    """The criteo and adfea tile-edge corpora at the kernels' own tile
    (16,384 bytes, a 256-byte halo; a shift past 256 puts a cell's start
    before an edge and its end past the halo): the plain parser's
    bytes."""
    text = tile_edge_text(fmt, 16384, shift)
    same_block(parse_text(text, fmt, cuda), parse_text(text, fmt))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("size,final_newline", [(1, False)] + [
    (size, nl) for size in (2, 100, 16383, 16384, 16385, 32767, 32768, 32769,
                            5 * 16384 - 1, 5 * 16384, 5 * 16384 + 1)
    for nl in (True, False)])
def test_parse_format_kernels_chunk_sizes(cuda, fmt, size, final_newline):
    """Chunks under one tile and around whole numbers of tiles."""
    text = format_sized_text(fmt, size, final_newline)
    assert len(text) == size
    same_block(parse_text(text, fmt, cuda), parse_text(text, fmt))


def _format_chunk(fmt: str) -> bytes:
    """4,096 synthetic rows and the tile-edge corpus at shift 7."""
    from wormhole_tpu_torch.data.synth import (synth_adfea_text,
                                               synth_criteo_tsv)
    rng = np.random.default_rng(9)
    raw = (synth_adfea_text(rng, 4096) if fmt == "adfea"
           else synth_criteo_tsv(rng, 4096))
    return raw + tile_edge_text(fmt, 16384, 7).encode()


def _format_kernel(fmt: str, buf):
    if fmt == "adfea":
        return native.parse_adfea_kernel(buf)
    return native.parse_criteo_kernel(buf, fmt == "criteo")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_parse_format_kernels_same_bits_twice(cuda, fmt):
    """Two launches over the same chunk write the same bits, stats
    included; the stats keep their meaning (tokens: criteo's cells,
    adfea's tokens; lines: criteo's line breaks + 1, adfea's lines with a
    token; the offset of the first refused token ~0)."""
    raw = _format_chunk(fmt)
    buf = native.upload(raw, cuda)
    a, b = _format_kernel(fmt, buf), _format_kernel(fmt, buf)
    torch.cuda.synchronize()
    rows, feats = int(a.stats[native._ROWS]), int(a.stats[native._FEATS])
    for x, y in ((a.stats, b.stats), (a.label[:rows], b.label[:rows]),
                 (a.offset[:rows + 1], b.offset[:rows + 1]),
                 (a.index[:feats], b.index[:feats])):
        _same_arrays(x.cpu().numpy(), y.cpu().numpy())
    st = a.stats.cpu().numpy()
    text = raw.decode()
    lines = text.replace("\r", "\n").split("\n")
    if fmt == "adfea":
        assert st[native._TOKENS] == len(text.split())
        assert st[native._LINES] == sum(bool(ln.split()) for ln in lines)
    else:
        assert st[native._TOKENS] == sum(ln.count("\t") + 1 for ln in lines)
        assert st[native._LINES] == len(lines)
    assert st.view(np.uint32)[native._BAD_AT] == 0xFFFFFFFF
    assert st[native._BAD] == 0 and st.view(np.uint32)[native._ERR] == \
        0xFFFFFFFF
    same_block(native.finish_parse(a, raw), parse_text(raw, fmt))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_parse_format_kernels_no_sync_in_three_launches(cuda, fmt):
    """No host sync in the wrapper (CUDA's sync debug mode raises on
    one), and three device ops a call: the count, scan and emit kernels,
    no memset and no library kernel."""
    buf = native.upload(_format_chunk(fmt), cuda)
    _format_kernel(fmt, buf)                     # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _format_kernel(fmt, buf)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            _format_kernel(fmt, buf)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    assert round(len(device_ops) / 10) == 3, device_ops
    assert all(any(k in op for op in device_ops) for k in (
        "formats_count_kernel", "formats_scan_kernel",
        "formats_emit_kernel")), device_ops
    assert all("formats_" in op for op in device_ops), device_ops


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,name", [("criteo", n) for n in sorted(CRITEO_ERRORS)]
                         + [("adfea", n) for n in sorted(ADFEA_ERRORS)])
def test_parse_format_kernels_name_the_first_refused_token(cuda, fmt, name):
    """The card names the first refused label or key by its offset, as
    the old chains named it (criteo: its whole cell)."""
    text = (CRITEO_ERRORS if fmt == "criteo" else ADFEA_ERRORS)[name]
    beg, tok = FIRST_REFUSED[fmt, name]
    with pytest.raises(ValueError, match=f"token {re.escape(repr(tok))} "
                                         f"at byte {beg} "):
        parse_text(text, fmt, cuda)


# the first refused label or key of each error corpus entry: (offset,
# token)
FIRST_REFUSED = {
    ("criteo", "word-label"): (0, "x"),
    ("criteo", "empty-label"): (4, ""),
    ("criteo", "spaces-label"): (0, " "),
    ("criteo", "inner-space-label"): (0, "1 2"),
    ("criteo", "lone-cr-splits-a-line"): (4, "x"),
    ("criteo", "misplaced-underscore"): (0, "1__0"),
    ("adfea", "word-label"): (4, "x"),
    ("adfea", "bare-key-2^64"): (6, "18446744073709551616"),
    ("adfea", "negative-bare-key"): (6, "-5"),
    ("adfea", "word-fid"): (6, "x:1"),
    ("adfea", "empty-fid"): (6, ":1"),
    ("adfea", "empty-gid"): (6, "1:"),
    ("adfea", "two-colons"): (6, "1:2:3"),
    ("adfea", "misplaced-underscore"): (6, "1__0:3"),
}


@pytest.mark.cuda
def test_convert_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The convert app parses on the card by default and writes the same
    crb bytes as with device=cpu; the crb file trains no differently."""
    from wormhole_tpu_torch.apps import convert
    from wormhole_tpu_torch.data.synth import synth_criteo_tsv

    src = tmp_path / "day.tsv"
    src.write_bytes(synth_criteo_tsv(np.random.default_rng(5), 3000))
    n0 = _cuda.LAUNCHES["parse_criteo"]
    for dev in ("cuda", "cpu"):
        assert convert.main([f"data_in={src}", "format_in=criteo",
                             f"data_out={tmp_path}/{dev}.crb",
                             "minibatch=1000", f"device={dev}"]) == 0
    assert _cuda.LAUNCHES["parse_criteo"] > n0
    assert ((tmp_path / "cuda.crb").read_bytes()
            == (tmp_path / "cpu.crb").read_bytes())


def _pack_inputs(nb, rows=256, nnz=13, seed=1):
    rng = np.random.default_rng(seed)
    idx = (rng.zipf(1.3, size=rows * nnz) % nb).astype(np.int32)
    seg = np.repeat(np.arange(rows, dtype=np.int32), nnz)
    val = rng.normal(size=idx.size).astype(np.float32)
    val[rng.random(idx.size) < 0.1] = 0.0
    return idx, seg, val


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sorted", "tile", "fm"])
def test_card_pack_matches_numpy_pack(cuda, kind):
    """The pack with its sorts and uniques on the card gives the numpy
    pack's bytes: pack_sorted_coo, pack_tile_coo (with the row-major
    layout) and DiFacto's _pack_fm."""
    if kind == "sorted":
        nb = 4 * ck.TILE
        idx, seg, val = _pack_inputs(nb)
        a = ck.pack_sorted_coo(idx, seg, val, nb)
        b = ck.pack_sorted_coo(idx, seg, val, nb, device=cuda)
        for f in ("idx", "seg", "val", "tmap", "first"):
            _same_arrays(getattr(a, f), getattr(b, f))
    elif kind == "tile":
        nb = 32 * ck.TILE
        idx, seg, val = _pack_inputs(nb, rows=128, nnz=16)
        kw = dict(capacity=128 * 16 + 64, rm_rows=128, rm_width=16)
        a = ck.pack_tile_coo(idx, seg, val, nb, 4 * ck.TILE, **kw)
        b = ck.pack_tile_coo(idx, seg, val, nb, 4 * ck.TILE, device=cuda,
                             **kw)
        for f in ("uniq", "tmap_u", "first_u", "last_u", "rm_slot",
                  "rm_val"):
            _same_arrays(getattr(a, f), getattr(b, f))
        for f in ("idx", "seg", "val", "tmap", "first"):
            _same_arrays(getattr(a.coo, f), getattr(b.coo, f))
        assert (a.num_uniq, a.dropped_nnz) == (b.num_uniq, b.dropped_nnz)
    else:
        import types

        from wormhole_tpu_torch.models.difacto import (DifactoConfig,
                                                       DifactoLearner)
        kw = dict(minibatch=256, num_buckets=2 * ck.TILE, v_buckets=ck.TILE,
                  nnz_per_row=13, dim=4, threshold=2, kernel="pallas",
                  kernel_dtype="f32")
        idx, seg, val = _pack_inputs(2 * ck.TILE)
        db = types.SimpleNamespace(seg=seg, idx=idx, val=val)
        packs = []
        for dev in ("cpu", cuda):
            lrn = DifactoLearner(DifactoConfig(**kw), device=dev)
            packs.append([lrn._pack_fm(db, train) for train in (True, False)])
        for pa, pb in zip(*packs):
            flat = [DifactoLearner._fm_args(p, np.zeros(256), np.ones(256),
                                            p[2] is not None)
                    for p in (pa, pb)]
            assert len(flat[0]) == len(flat[1])
            for x, y in zip(*flat):
                _same_arrays(x, y)


@pytest.mark.cuda
def test_loader_packs_on_a_stream_of_its_own(cuda, tmp_path):
    """The solver's loaders parse and pack on streams of their own, one a
    loader, never the steps' stream; the parse runs the card's kernel."""
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    seen = []

    class Recording(LinearLearner):
        def prepare_batch(self, blk, train=True):
            seen.append((threading.get_ident(),
                         torch.cuda.current_stream(self.device).cuda_stream))
            return super().prepare_batch(blk, train)

    rng = np.random.default_rng(0)
    path = tmp_path / "train.libsvm"
    path.write_text("".join(
        f"{r % 2} " + " ".join(str(k) for k in rng.integers(0, 1 << 22, 13))
        + "\n" for r in range(2048)))
    cfg = LinearConfig(train_data=str(path), minibatch=256, nnz_per_row=13,
                       num_buckets=1 << 22, max_data_pass=1,
                       num_parts_per_file=4, max_concurrency=2,
                       kernel="pallas")
    n0 = _cuda.LAUNCHES["parse_libsvm"]
    solver = MinibatchSolver(Recording(cfg, device=cuda), cfg,
                             verbose=False)
    solver.iterate(cfg.train_data, True)
    assert _cuda.LAUNCHES["parse_libsvm"] > n0
    default = torch.cuda.default_stream(cuda).cuda_stream
    streams = {}
    for thread, stream in seen:
        assert stream != default
        streams.setdefault(thread, set()).add(stream)
    assert all(len(v) == 1 for v in streams.values())
    assert len({next(iter(v)) for v in streams.values()}) == len(streams)
    assert 0.0 <= solver.last_pass_stall_s <= solver.last_pass_wall_s


@pytest.mark.cuda
@pytest.mark.parametrize("kdt", ["f32", "bf16"])
def test_kmeans_packed_densify_matches_plain(cuda, kdt):
    """k-means' packed densify (coo_spmv_t over the flat (row * stride +
    col) buckets, d = ones) on an MNIST-shaped batch, 160 uniform columns
    a row of 784, so columns repeat in a row: the kernel's dense rows
    against the plain version's (sums' bar), and the assignment against
    the scatter densify's (f32: counts equal)."""
    from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner

    B, d, nnz = 1024, 784, 160
    lrn = KmeansLearner(KmeansConfig(num_clusters=10, dim=d, minibatch=B,
                                     nnz_per_row=nnz, kernel_dtype=kdt),
                        device=cuda)
    assert lrn._use_packed
    rng = np.random.default_rng(7)
    seg = np.repeat(np.arange(B, dtype=np.int32), nnz)
    idx = rng.integers(0, d, size=B * nnz).astype(np.int32)
    val = rng.random(B * nnz).astype(np.float32)
    pk = [torch.from_numpy(a).to(cuda) for a in lrn.pack_batch(seg, idx,
                                                                 val)]
    ones = torch.ones(B, device=cuda)
    n0 = _cuda.LAUNCHES["coo_spmv_t"]
    got = ck.coo_spmv_t(ones, *pk, lrn._num_flat, dtype=lrn._kdt)
    assert _cuda.LAUNCHES["coo_spmv_t"] == n0 + 1
    want = ck.coo_spmv_t_plain(ones, *pk[:3], lrn._num_flat, lrn._kdt)
    mag = ck.coo_spmv_t_plain(ones, pk[0], pk[1], pk[2].abs(),
                              lrn._num_flat, torch.float32)
    _sum_close(got, want, mag)
    assert not got[mag == 0].any()
    mask = torch.ones(B, device=cuda)
    C = torch.randn(10, d, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    sp, cp, cop = lrn._assign_packed(C, *pk, mask)
    dev = [torch.from_numpy(a).to(cuda) for a in (seg, idx, val)]
    sd, cd, cod = lrn._assign_dense(C, *dev, mask)
    if kdt == "f32":
        assert torch.equal(cp, cd)
        torch.testing.assert_close(sp, sd, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(cop, cod, rtol=1e-5, atol=0)
    assert torch.isfinite(sp).all() and float(cp.sum()) == B


@pytest.mark.cuda
def test_batch_learners_parse_on_the_card(cuda, tmp_path):
    """k-means (dim discovery and every iteration's batches) and the
    L-BFGS loader parse on the card: parse_libsvm launches over each."""
    from wormhole_tpu_torch.models.batch_objectives import (
        LinearObjFunction, load_batches)
    from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner
    from wormhole_tpu_torch.solver.lbfgs import LBFGSConfig, LBFGSSolver

    rng = np.random.default_rng(2)
    path = tmp_path / "km.libsvm"
    path.write_text("".join(
        f"{r % 2} " + " ".join(f"{k}:{v:.4f}" for k, v in zip(
            rng.integers(0, 64, 12), rng.random(12))) + "\n"
        for r in range(1024)))
    n0 = dict(_cuda.LAUNCHES)
    lrn = KmeansLearner(KmeansConfig(train_data=str(path), num_clusters=4,
                                     max_iter=2, minibatch=256,
                                     nnz_per_row=12), device=cuda)
    cost = lrn.run(verbose=False)
    assert np.isfinite(cost) and lrn.cfg.dim == 64
    assert _cuda.LAUNCHES["parse_libsvm"] > n0["parse_libsvm"]
    assert _cuda.LAUNCHES["coo_spmv_t"] >= n0["coo_spmv_t"] + 8
    n1 = _cuda.LAUNCHES["parse_libsvm"]
    batches, nf = load_batches(str(path), minibatch=256, nnz_per_row=12,
                               device=cuda)
    assert _cuda.LAUNCHES["parse_libsvm"] > n1 and nf == 64
    obj = LinearObjFunction(batches, nf, cuda)
    solver = LBFGSSolver(obj, LBFGSConfig(max_iter=3, reg_l2=0.1))
    w, objv = solver.run(verbose=False)
    assert w.is_cuda and objv < solver.objv_history[0]


@pytest.mark.cuda
def test_prefetch_parses_on_a_stream_of_its_own(cuda, tmp_path,
                                                monkeypatch):
    """MinibatchIter's prefetch thread parses on the card on a stream of
    its own, not the steps' default stream, and its batches equal those
    of the unprefetched iterator."""
    from wormhole_tpu_torch.data import minibatch

    seen = []

    def recording(chunk, fmt, device=None):
        seen.append((threading.get_ident(),
                     torch.cuda.current_stream(device).cuda_stream))
        return parse_text(chunk, fmt, device)

    monkeypatch.setattr(minibatch.parsers, "parse_text", recording)
    rng = np.random.default_rng(4)
    path = tmp_path / "d.libsvm"
    path.write_text("".join(
        f"{r % 2} " + " ".join(str(k) for k in rng.integers(0, 1 << 20, 9))
        + "\n" for r in range(3000)))
    got = [list(minibatch.MinibatchIter(str(path), minibatch_size=256,
                                        device=cuda, prefetch=pf))
           for pf in (True, False)]
    default = torch.cuda.default_stream(cuda).cuda_stream
    (thread, stream), (thread2, stream2) = seen[0], seen[-1]
    assert thread != threading.get_ident() and stream != default
    assert thread2 == threading.get_ident() and stream2 == default
    assert len(got[0]) == len(got[1]) == 12
    for a, b in zip(*got):
        for f in ("label", "offset", "index"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.cuda
def test_kmeans_replays_cached_packs_on_the_card(cuda, tmp_path,
                                                 monkeypatch):
    """With WH_PACK_CACHE=1, Lloyd iterations 2-3 parse nothing and launch
    the packed densify once a batch; the centroids stay within atol 1e-5
    of the run with the cache off (the densify sums with float atomics)."""
    from wormhole_tpu_torch.models.kmeans import KmeansConfig, KmeansLearner

    rng = np.random.default_rng(5)
    path = tmp_path / "km.libsvm"
    path.write_text("".join(
        "0 " + " ".join(f"{k}:{v:.4f}" for k, v in zip(
            rng.integers(0, 96, 20), rng.random(20))) + "\n"
        for _ in range(1024)))
    kw = dict(train_data=str(path), num_clusters=4, dim=96, max_iter=3,
              minibatch=256, nnz_per_row=20)
    for k in ("WH_PACK_CACHE", "WH_PACK_CACHE_DIR"):
        monkeypatch.delenv(k, raising=False)
    off = KmeansLearner(KmeansConfig(**kw), device=cuda)
    assert off.pack_cache is None and off._use_packed
    off.init_centroids()
    C0 = off.centroids.clone()
    off.run(verbose=False)
    monkeypatch.setenv("WH_PACK_CACHE", "1")
    on = KmeansLearner(KmeansConfig(**kw), device=cuda)
    on.centroids = C0.clone()
    on.cfg.max_iter = 1
    on.run(verbose=False)
    n0 = dict(_cuda.LAUNCHES)
    on.start_iter, on.cfg.max_iter = 1, 3
    on.run(verbose=False)
    assert _cuda.LAUNCHES["parse_libsvm"] == n0["parse_libsvm"]
    assert _cuda.LAUNCHES["coo_spmv_t"] == n0["coo_spmv_t"] + 2 * 4
    st = on.pack_cache.stats()
    assert (st["hits"], st["misses"]) == (2 * 5, 1)
    assert float((on.centroids - off.centroids).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["linear", "difacto"])
def test_serving_scorer_on_the_card_matches_the_cpu(cuda, model):
    """A serving scorer built with no device runs on the card; its
    fetch-mode margins hold to the same scorer's on the CPU within the
    kernels' bar (a CUDA index_add_ adds with f32 atomics)."""
    from wormhole_tpu_torch.data.rowblock import RowBlock
    from wormhole_tpu_torch.models.difacto import DifactoConfig
    from wormhole_tpu_torch.models.linear import LinearConfig
    from wormhole_tpu_torch.serving import DifactoScorer, LinearScorer

    rng = np.random.default_rng(17)
    kw = dict(minibatch=1000, nnz_per_row=64, num_buckets=1 << 16)
    if model == "linear":
        cls, cfg = LinearScorer, LinearConfig(**kw)
    else:
        cls = DifactoScorer
        cfg = DifactoConfig(v_buckets=1 << 14, dim=8, threshold=2, **kw)
    tables = {"w": rng.normal(size=cfg.num_buckets).astype(np.float32),
              "cnt": rng.integers(0, 4, cfg.num_buckets).astype(np.float32),
              "V": (rng.normal(size=(1 << 14, 8)) * 0.1).astype(np.float32)}
    card, host = cls(cfg), cls(cfg, device="cpu")
    assert card.device.type == "cuda"
    for n in (1, 517, 1000):
        counts = rng.integers(32, 65, size=n)
        offset = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        blk = RowBlock(label=np.zeros(n, np.float32), offset=offset,
                       index=rng.integers(0, 1 << 62, int(offset[-1]),
                                          dtype=np.int64).astype(np.uint64),
                       value=rng.normal(size=int(offset[-1])).astype(
                           np.float32))
        p = card.pack(blk)
        rows = {t: tables[t][p.keys[t]] for t in cls.tables}
        got = card.score(p, rows)
        want = host.score(host.pack(blk), rows)
        assert got.shape == (n,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# -- the parameter-server plane's seams with the card ---------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rows", "empty"])
def test_kvstore_rows_on_the_card_at_2_26(cuda, case):
    """KVStore.gather_rows / scatter_rows on the card at 2^26 buckets:
    a sentinel-free unique index set (the PS plane's touched rows) and
    the empty set; the CPU store holds the same rows."""
    from wormhole_tpu_torch.parallel.kvstore import KVStore, TableSpec

    nb = 1 << 26
    specs = {k: TableSpec() for k in ("w", "z", "n")}
    card = KVStore(nb, specs, device=cuda)
    rng = np.random.default_rng(3)
    idx = (np.unique(rng.integers(0, nb, size=200_000)) if case == "rows"
           else np.empty(0, np.int64))
    vals = {k: rng.normal(size=len(idx)).astype(np.float32) for k in specs}
    for k, v in vals.items():
        card.scatter_rows(k, idx, v)
    got = card.gather_rows_multi(["z", "n"], idx)
    for k in ("z", "n"):
        np.testing.assert_array_equal(got[k], vals[k])
    np.testing.assert_array_equal(card.gather_rows("w", idx), vals["w"])
    assert card.gather_rows("w", idx).shape == (len(idx),)
    # untouched rows stay zero: the table sums to the scattered values
    for k in specs:
        assert int(torch.count_nonzero(card.state[k])) == int(
            np.count_nonzero(vals[k]))
    host = KVStore(1 << 20, {"w": TableSpec()}, device="cpu")
    small = idx[idx < 1 << 20]
    host.scatter_rows("w", small, vals["w"][idx < 1 << 20])
    np.testing.assert_array_equal(host.gather_rows("w", small),
                                  card.gather_rows("w", small))


def _linear_batches(nb, n_batches, rows=1024, nnz=32, seed=0):
    from wormhole_tpu_torch.data.rowblock import RowBlock

    rng = np.random.default_rng(seed)
    hot = rng.integers(0, nb, size=4096)
    for _ in range(n_batches):
        offset = np.arange(rows + 1, dtype=np.int64) * nnz
        index = np.where(rng.random(rows * nnz) < 0.5,
                         rng.choice(hot, rows * nnz),
                         rng.integers(0, nb, rows * nnz))
        yield RowBlock(label=(rng.random(rows) < 0.3).astype(np.float32),
                       offset=offset, index=index.astype(np.uint64),
                       value=np.ones(rows * nnz, np.float32))


class _Recorder:
    """Store proxy that records the thread of every call SyncedStore makes
    into the learner's store (the only way it reaches the card)."""

    def __init__(self, store):
        self._store = store
        self.threads = set()

    def __getattr__(self, name):
        attr = getattr(self._store, name)
        if not callable(attr):
            return attr

        def call(*a, **kw):
            self.threads.add(threading.current_thread().name)
            return attr(*a, **kw)

        return call


def _run_synced(cuda, async_sync, flush_every, batches, nb):
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.runtime import ps_server as ps

    node = ps.ServerNode(0, 1)
    node.serve()
    client = ps.PSClient([node.uri], sender="w0")
    torch_calls = []

    def prof(frame, event, arg):
        if threading.current_thread().name != "ps-sync-comms":
            return
        mod = (getattr(arg, "__module__", "") or "") if event == "c_call" \
            else frame.f_globals.get("__name__", "")
        if mod.startswith("torch"):
            torch_calls.append((event, mod))

    threading.setprofile(prof)
    try:
        cfg = LinearConfig(num_buckets=nb, minibatch=1024, nnz_per_row=32,
                           algo="ftrl", lambda_l1=1.0, kernel="pallas",
                           kernel_dtype="f32")
        lrn = LinearLearner(cfg, device=cuda)
        lrn.track_touched = True
        rec = _Recorder(lrn.store)
        ss = ps.SyncedStore(rec, client, max_delay=1,
                            derived=lrn.derived_tables(),
                            touched_fn=lrn.collect_touched,
                            async_sync=async_sync)
        ss.init()
        for i, blk in enumerate(batches):
            lrn.train_batch(blk)
            ss.maybe_sync()
            if (i + 1) % flush_every == 0:
                ss.flush()
        ss.flush()
        assert lrn.prepare_batch(blk)[0] == "tcoo"  # the compact path
        used_thread = ss._comm_thread is not None
        lag = ss.max_fold_lag
        ss.close()
        tables = lrn.store.to_numpy()
        server = client.pull()
    finally:
        threading.setprofile(None)
        client.close()
        node.stop()
    return tables, server, rec.threads, torch_calls, used_thread, lag


@pytest.mark.cuda
@pytest.mark.parametrize("flush_every", [1, 4])
def test_synced_store_async_matches_sync_on_the_card(cuda, flush_every):
    """A SyncedStore over an in-process ServerNode with the linear compact
    learner on the card. Async sync hands every wire round-trip to its
    comms thread, which makes no torch call (a profile hook on it); the
    store's rows are gathered and scattered on the training thread only.
    After flush() each run's tables equal the server's. With a flush
    after every sync the async run's tables equal the sync run's bit for
    bit. With four syncs between flushes the round-trips overlap the
    steps (a fold lags one sync), and the two runs part ways by design:
    a step reads w rows the fold has not refreshed yet (the bounded
    staleness of 2 * max_delay minibatches)."""
    nb = 1 << 22
    batches = list(_linear_batches(nb, 8))
    t_sync, s_sync, th_sync, _, used_sync, _ = _run_synced(
        cuda, False, flush_every, batches, nb)
    t_async, s_async, th_async, calls, used_async, lag = _run_synced(
        cuda, True, flush_every, batches, nb)
    assert not used_sync and used_async
    assert calls == []
    assert th_sync == th_async == {threading.current_thread().name}
    for t, s in ((t_sync, s_sync), (t_async, s_async)):
        for k in ("w", "z", "n"):
            np.testing.assert_array_equal(t[k], s[k], err_msg=k)
    assert np.count_nonzero(t_sync["w"]) > 0
    assert lag == 1  # folds lag one sync: the round-trips ran async
    if flush_every == 1:
        for k in ("w", "z", "n"):
            np.testing.assert_array_equal(t_async[k], t_sync[k], err_msg=k)


@pytest.mark.cuda
def test_difacto_count_mirror_after_a_sparse_pull(cuda):
    """DiFacto on the card: another worker's count pushes reach this
    worker through a sparse pull, and the host count mirror its packs
    admit from equals the card's cnt table afterwards."""
    from wormhole_tpu_torch.models.difacto import (DifactoConfig,
                                                   DifactoLearner)
    from wormhole_tpu_torch.runtime import ps_server as ps

    nb = 1 << 20
    cfg = DifactoConfig(num_buckets=nb, v_buckets=1 << 16, dim=8,
                        threshold=2, minibatch=1024, nnz_per_row=32,
                        kernel="pallas", kernel_dtype="f32")
    node = ps.ServerNode(0, 1)
    node.serve()
    c0 = ps.PSClient([node.uri], sender="w0")
    c1 = ps.PSClient([node.uri], sender="w1")
    try:
        lrn = DifactoLearner(cfg, device=cuda)
        lrn.track_touched = True
        ss = ps.SyncedStore(lrn.ckpt_store, c0, max_delay=1,
                            derived=lrn.derived_tables(),
                            touched_fn=lrn.collect_touched)
        ss.init()
        batches = list(_linear_batches(nb, 3, seed=5))
        lrn.train_batch(batches[0])
        ss.sync()
        # the other worker counts keys this one has not seen
        c1.pull()  # learns the tables' row spaces
        idx = np.arange(7, nb, 9973, dtype=np.int64)
        c1.push_sparse({nb: idx}, {"cnt": np.full(len(idx), 3.0,
                                                  np.float32)})
        lrn.train_batch(batches[1])
        ss.sync()
        cnt = lrn.store.state["cnt"].cpu().numpy()
        np.testing.assert_array_equal(lrn._cnt_host, cnt)
        assert (cnt[idx] >= 3.0).all()
        lrn.train_batch(batches[2])  # packs admit from the pulled counts
        ss.flush()
        np.testing.assert_array_equal(lrn._cnt_host,
                                      lrn.store.state["cnt"].cpu().numpy())
    finally:
        c0.close()
        c1.close()
        node.stop()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_init_from_env_starts_a_one_rank_nccl_group(cuda):
    """The global mesh's rendezvous on the card: one worker with a card
    of its own joins an NCCL group at tcp://WH_COORD_URI, sums on the
    card, and leaves the group at its exit barrier."""
    import torch.distributed as dist

    from wormhole_tpu_torch.parallel import multihost as mh
    from wormhole_tpu_torch.runtime.tracker import NodeEnv

    env = NodeEnv(role=None, rank=0, num_workers=1, num_servers=0,
                  scheduler_uri="", coord_uri=f"127.0.0.1:{_free_port()}")
    backend, dev = mh.init_from_env(env, "cuda", timeout=60)
    try:
        assert (backend, dist.get_backend()) == ("nccl", "nccl")
        assert dev == torch.device("cuda", 0)
        x = torch.arange(4.0, device=dev)
        dist.all_reduce(x)
        assert x.tolist() == [0.0, 1.0, 2.0, 3.0]
        assert mh.global_scalar_sum(5) == 5 and mh.global_scalar_max(-2) == -2
    finally:
        mh.exit_barrier(None, 1)
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_global_linear_on_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """dmlc_tpu -n 2 -s 0 ... global_mesh=1 device=cuda on one card: the
    two workers share it over gloo, each launches W1 / W2 (the pull and
    push kernels) and the parse kernel; against one device stepped over
    the same global batches (the ranks' blocks in rank order): final val
    logloss and AUC within 1e-3, w at rtol 1e-4 / atol 1e-6."""
    import json
    import os
    import subprocess
    import sys

    from wormhole_tpu_torch.data.minibatch import MinibatchIter
    from wormhole_tpu_torch.data.rowblock import RowBlock
    from wormhole_tpu_torch.data.synth import synth_criteo_batch
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.parallel import multihost as mh
    from wormhole_tpu_torch.utils.checkpoint import load_parts

    def write_libsvm(path, rows, seed):
        rng = np.random.default_rng(seed)
        _, idx, _, label, _ = synth_criteo_batch(rng, rows, 2 * ck.TILE)
        keys = idx.reshape(rows, -1)
        with open(path, "w") as f:
            f.write("".join(f"{int(y)} " + " ".join(map(str, k)) + "\n"
                            for y, k in zip(label, keys)))

    for i in range(2):
        write_libsvm(tmp_path / f"train-{i}.libsvm", 640, seed=i)
    write_libsvm(tmp_path / "val.libsvm", 512, seed=9)
    body = dict(algo="ftrl", lambda_l1=1.0, minibatch=256,
                num_buckets=2 * ck.TILE, nnz_per_row=64, max_data_pass=2,
                num_parts_per_file=2, kernel_dtype="f32")
    conf = tmp_path / "gm.conf"
    conf.write_text("".join(f"{k} = {v}\n" for k, v in dict(
        body, train_data=f'"{tmp_path}/train-.*"',
        val_data=f'"{tmp_path}/val.libsvm"', model_out=tmp_path / "m"
    ).items()))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="0")
    p = subprocess.run(
        [sys.executable, "-m", "wormhole_tpu_torch.launcher.dmlc_tpu", "-n",
         "2", "-s", "0", "--node-timeout", "30", "--", sys.executable, "-m",
         "wormhole_tpu_torch.apps.linear", str(conf), "global_mesh=1",
         "device=cuda"], capture_output=True, text=True, env=env, cwd=root,
        timeout=300, start_new_session=True)
    out = p.stdout + p.stderr
    assert p.returncode == 0, out[-4000:]
    workers = [json.loads(m) for m in re.findall(
        r"\[global-worker\] (\{.*\})", out)]
    assert sorted(w["rank"] for w in workers) == [0, 1], out[-3000:]
    for w in workers:
        assert (w["backend"], w["device"]) == ("gloo", "cuda:0"), w
        for k in ("mesh_coo_spmv", "mesh_coo_spmv_t", "coo_spmv",
                  "coo_spmv_t", "parse_libsvm"):
            assert w["kernel_launches"].get(k), (k, w)
    assert "[scheduler] cuda context: none" in out

    def steps(pattern, seed):
        per = [[b for f, k in mh.rank_parts(pattern, 2, type(
            "E", (), {"rank": r, "num_workers": 2}))
            for b in MinibatchIter(f, k, 2, minibatch_size=128, seed=seed,
                                   device="cpu")] for r in range(2)]
        for s in range(max(len(x) for x in per)):
            bl = [x[s] for x in per if s < len(x)]
            offs, base = [np.zeros(1, np.int64)], 0
            for b in bl:
                offs.append(b.offset[1:].astype(np.int64) + base)
                base += int(b.offset[-1])
            yield RowBlock(label=np.concatenate([b.label for b in bl]),
                           offset=np.concatenate(offs),
                           index=np.concatenate([b.index for b in bl]),
                           value=np.concatenate([b.values_or_ones()
                                                 for b in bl]),
                           weight=None)

    one = LinearLearner(LinearConfig(**body), device=cuda)
    for dp in range(2):
        for blk in steps(f"{tmp_path}/train-.*", dp):
            one.train_batch(blk)
        tot = {}
        for blk in steps(f"{tmp_path}/val.libsvm", dp):
            for k, v in one.eval_batch(blk).items():
                tot[k] = tot.get(k, 0.0) + v
    m = re.search(r"final val: logloss=([0-9.]+) auc=([0-9.]+)", out)
    assert abs(float(m.group(1)) - tot["logloss"] / tot["nex"]) < 1e-3
    assert abs(float(m.group(2)) - tot["auc"] / tot["nex"]) < 1e-3
    np.testing.assert_allclose(load_parts(str(tmp_path / "m"))["w"],
                               one.store.state["w"].cpu().numpy(),
                               rtol=1e-4, atol=1e-6)


def _solver_step_counts(lrn, cfg) -> tuple:
    """(host syncs, device ops by name) of one solver run, as the
    profiler records them: the CUDA runtime's synchronize calls, and the
    kernels and memory operations on the card."""
    from collections import Counter

    from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        MinibatchSolver(lrn, cfg, verbose=False).run()
        torch.cuda.synchronize()
    events = prof.events()
    syncs = sum("Synchronize" in e.name for e in events
                if e.device_type != torch.autograd.DeviceType.CUDA)
    ops = Counter(e.name for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return syncs, ops


@pytest.mark.cuda
def test_obs_spans_add_no_sync_and_no_launch_to_a_2_26_step(cuda, tmp_path,
                                                            monkeypatch):
    """One 2^26 train step through the solver (a file of one 4,096-row
    minibatch read as one part by one loader) under WH_OBS_DIR makes the
    host syncs and the device operations of the same step with the tracer
    off: the pass and step spans read the host clock alone."""
    from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner
    from wormhole_tpu_torch.obs import trace

    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 26, size=(4096, 39))
    data = tmp_path / "train.libsvm"
    data.write_text("".join(f"{r % 2} " + " ".join(map(str, keys[r])) + "\n"
                            for r in range(4096)))
    cfg = LinearConfig(train_data=str(data), data_format="libsvm",
                       minibatch=4096, num_buckets=1 << 26, nnz_per_row=39,
                       algo="ftrl", max_data_pass=1, num_parts_per_file=1,
                       max_concurrency=1)
    lrn = LinearLearner(cfg, device=cuda)
    for k in ("WH_OBS_DIR", "WH_FLIGHT", "WH_PROF", "WORMHOLE_PROFILE_DIR"):
        monkeypatch.delenv(k, raising=False)
    assert trace.init_from_env() is None
    _solver_step_counts(lrn, cfg)  # builds and loads the kernels
    off = _solver_step_counts(lrn, cfg)
    monkeypatch.setenv("WH_OBS_DIR", str(tmp_path / "obs"))
    try:
        assert trace.init_from_env() is not None
        on = _solver_step_counts(lrn, cfg)
        trace.ACTIVE.close()
    finally:
        monkeypatch.delenv("WH_OBS_DIR")
        trace.init_from_env()
    spans = [json.loads(line)["name"]
             for f in (tmp_path / "obs").glob("trace-*.jsonl")
             for line in open(f) if '"ph":"X"' in line]
    assert sorted(spans) == ["solver.train_pass", "solver.train_step"]
    assert on[0] == off[0], (on[0], off[0])
    assert on[1] == off[1], {k: (on[1][k], off[1][k])
                             for k in set(on[1]) | set(off[1])
                             if on[1][k] != off[1][k]}
    assert off[0] >= 1 and any("tile_gather_kernel" in k for k in off[1])
