"""chip_smoke.py's synthetic texts, byte for byte what %-formatting writes.

criteo_text, mnist_text and higgs_text format their rows with numpy
(chip_smoke's _dec, _fixed and _rows_text). Every text the card phases
parse is made by them, so these tests hold them against the plain
%-formatting they stand for ("%d", "%.3f", "%.5f"): on the generators'
own data, across block boundaries, and on the values where a formatter
can slip (half-way ties, negatives that round to zero, zeros of either
sign, the largest key).
"""

import numpy as np
import pytest

import chip_smoke as cs
from wormhole_tpu_torch.data.synth import synth_criteo_batch, synth_higgs


def percent_criteo(num_buckets, rows, seed, values=False):
    rng = np.random.default_rng(seed)
    _, idx, _, label, _ = synth_criteo_batch(rng, rows, num_buckets)
    toks = idx.reshape(rows, cs.NNZ_PER_ROW).astype(str)
    if values:
        v = rng.integers(1, 100_000, size=toks.shape) / 1000
        toks = np.char.add(np.char.add(toks, ":"), np.char.mod("%.3f", v))
    return "\n".join(f"{int(y)} " + " ".join(k)
                     for y, k in zip(label, toks)) + "\n"


def percent_mnist(rows, seed):
    rng = np.random.default_rng(seed)
    _, idx, val = cs.uniform_rows(rng, rows, cs.KM_DIM, cs.KM_NNZ,
                                  distinct=False)
    toks = np.char.add(np.char.add(idx.astype(str), ":"),
                       np.char.mod("%.3f", val)).reshape(rows, cs.KM_NNZ)
    return "\n".join("0 " + " ".join(t) for t in toks) + "\n"


def percent_higgs(rows, dim, seed, fmt="%.5f"):
    X, y = synth_higgs(np.random.default_rng(seed), rows, dim)
    cols = [np.char.add(f"{f}:", np.char.mod(fmt, X[:, f]))
            for f in range(dim)]
    lines = [f"{int(t)} " + " ".join(c) for t, c in zip(y, zip(*cols))]
    return "\n".join(lines) + "\n"


def lines_of(parts):
    """One formatted value a line, from token parts of (n, 1, w)."""
    return cs._rows_text([], parts)


@pytest.mark.parametrize("block", [7, cs.TEXT_ROWS])
@pytest.mark.parametrize("values", [False, True])
@pytest.mark.parametrize("num_buckets", [1 << 22, 1 << 26])
def test_criteo_text_is_percent_formatting(monkeypatch, block, values,
                                           num_buckets):
    monkeypatch.setattr(cs, "TEXT_ROWS", block)
    assert cs.criteo_text(num_buckets, 50, 11, values) == \
        percent_criteo(num_buckets, 50, 11, values)


@pytest.mark.parametrize("block", [5, cs.TEXT_ROWS])
def test_mnist_text_is_percent_formatting(monkeypatch, block):
    monkeypatch.setattr(cs, "TEXT_ROWS", block)
    assert cs.mnist_text(40, 71) == percent_mnist(40, 71)


@pytest.mark.parametrize("block", [6, cs.TEXT_ROWS])
@pytest.mark.parametrize("fmt", ["%.5f", "%.17g"])
def test_higgs_text_is_percent_formatting(monkeypatch, block, fmt):
    monkeypatch.setattr(cs, "TEXT_ROWS", block)
    assert cs.higgs_text(30, cs.HIGGS_DIM, 32, fmt) == \
        percent_higgs(30, cs.HIGGS_DIM, 32, fmt)


# float32 values whose exact value is half-way at the places (2^-4 and
# 3/16 at 3, 2^-6 and 3/64 at 5: printf rounds them half to even), their
# negatives, negatives that round to -0, zeros of either sign, and wide
# values
EDGE = [0.0625, 0.1875, 0.3125, 0.015625, 0.046875, 0.078125, -0.0625,
        -0.015625, -0.0004, -0.000001, -0.0, 0.0, 0.0004, 0.9995, -0.9995,
        1.0, 7.25, -3.5, 123.456, -4096.125, 65504.0]


@pytest.mark.parametrize("places", [3, 5])
def test_fixed_places_edges(places):
    rng = np.random.default_rng(3)
    v = np.concatenate([np.array(EDGE, np.float32),
                        rng.normal(size=500).astype(np.float32),
                        (rng.normal(size=500) * 1e-4).astype(np.float32)])
    got = lines_of(cs._fixed(v.reshape(-1, 1), places))
    want = "".join(f"%.{places}f\n" % float(x) for x in v)
    assert got == want


def test_fixed_thousandths_of_ints():
    # criteo_text's and [cache]'s values: k / 1000 in float64
    k = np.concatenate([np.arange(0, 2000), np.arange(99_000, 100_000),
                        [1, 5, 500, 999, 1000, 1001, 99_999]])
    v = k / 1000
    got = lines_of(cs._fixed(v.reshape(-1, 1), 3))
    assert got == "".join("%.3f\n" % x for x in v)


@pytest.mark.parametrize("num_buckets", [cs.DENSE_BUCKETS,
                                         cs.COMPACT_BUCKETS])
def test_dec_largest_key(num_buckets):
    k = np.array([num_buckets - 1, 0, 1, 9, 10, 99, 100, num_buckets // 2,
                  num_buckets - 10], np.int64)
    got = lines_of([cs._dec(k.reshape(-1, 1), len(str(num_buckets - 1)))])
    assert got == "".join("%d\n" % x for x in k)
