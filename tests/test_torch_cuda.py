"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need an NVIDIA GPU with nvcc and skip without one (the
kernels have no CPU mode). This file imports no JAX, so it runs on a
machine with the card but without JAX:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the pull and push sum in another order (float atomics), so
they hold to atol 1e-4 + rtol 1e-5 * (sum of the terms' magnitudes); the
gather is exact; the update holds to rtol 1e-5 / atol 1e-6 (the plain
version divides by a scalar as a multiply by its reciprocal on CUDA).
"""

import numpy as np
import pytest
import torch

from wormhole_tpu_torch.ops import _cuda
from wormhole_tpu_torch.ops import coo_kernels as ck
from wormhole_tpu_torch.ops import fused_update as fu

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
