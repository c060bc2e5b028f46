"""Synthetic workloads of the repo bench: Criteo-shaped minibatches, and
HIGGS-shaped dense rows for the GBDT learner (synth_higgs, below); and
text in the Criteo TSV and adfea formats (synth_criteo_tsv,
synth_adfea_text) for the parsers; and the tile-edge corpora of the
card's tiled parsers (tile_edge_text), whose seams cross a tile edge at
any shift.

Rows carry 39 features (13 integer + 26 categorical, criteo_parser.h:
55-82) drawn Zipf(1.2) within each field over per-field cardinalities
from ~10 to ~10M, field-salted and 64-bit mixed, then hashed into the
bucket table. Key skew matters: it sets how many unique keys and how
long the hot-key runs a batch has. The same seed gives the same batch as
the JAX package's bench (bench.py synth_criteo_batch).
"""

from __future__ import annotations

import numpy as np

FIELD_CARDS = [50] * 13 + [
    10, 100, 1000, 10_000, 100_000, 1_000_000, 10_000_000,
    25, 250, 2500, 25_000, 250_000, 2_500_000,
    40, 400, 4000, 40_000, 400_000, 4_000_000,
    60, 600, 6000, 60_000, 600_000,
    80, 800,
]
assert len(FIELD_CARDS) == 39


def synth_criteo_batch(rng, minibatch: int, num_buckets: int):
    """(seg, idx, val, label, mask) of one minibatch in COO form: row ids,
    bucket ids, all-ones values, 0/1 labels (30% positive), all-ones
    row mask."""
    nnz = len(FIELD_CARDS)
    vals = np.empty((minibatch, nnz), dtype=np.uint64)
    with np.errstate(over="ignore"):  # 64-bit mixing wraps by design
        for f, card in enumerate(FIELD_CARDS):
            draw = rng.zipf(1.2, size=minibatch).astype(np.uint64) % card
            x = draw + np.uint64(f) * np.uint64(0x9E3779B97F4A7C15)
            x ^= x >> np.uint64(30)
            x *= np.uint64(0xBF58476D1CE4E5B9)
            x ^= x >> np.uint64(27)
            vals[:, f] = x
    idx = (vals.reshape(-1) % np.uint64(num_buckets)).astype(np.int32)
    seg = np.repeat(np.arange(minibatch, dtype=np.int32), nnz)
    val = np.ones(minibatch * nnz, dtype=np.float32)
    label = (rng.random(minibatch) < 0.3).astype(np.float32)
    mask = np.ones(minibatch, dtype=np.float32)
    return seg, idx, val, label, mask


def synth_higgs(rng, rows: int, dim: int = 28):
    """(X, y): `rows` dense rows of `dim` standard-normal f32 features and
    0/1 f32 labels that depend on the first four features plus noise, the
    HIGGS-shaped data of the repo bench (bench.py bench_gbdt). The same
    generator state gives the same arrays as the bench's recipe."""
    X = rng.standard_normal((rows, dim)).astype(np.float32)
    y = X[:, :4].sum(axis=1) + 0.5 * rng.standard_normal(rows) > 0
    return X, y.astype(np.float32)


def _mix(x):
    """A 64-bit mix of uint64 values (wraps by design)."""
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint64(30))
        x = x * np.uint64(0xBF58476D1CE4E5B9)
        return x ^ (x >> np.uint64(27))


_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)
EMPTY_INT = 0.2  # share of empty integer fields in synth_criteo_tsv
EMPTY_CAT = 0.1  # share of empty categorical fields
ADFEA_FEATS = 10  # fid:gid tokens a synth_adfea_text line


def synth_criteo_tsv(rng, rows: int) -> bytes:
    """`rows` lines of Criteo TSV (criteo_parser.h's input): a 0/1 label
    (30% positive), 13 integer fields and 26 categorical fields of 8 hex
    digits, tab-separated. Each field draws Zipf(1.2) over its
    FIELD_CARDS cardinality (integers below 10^6; categories field-salted
    and mixed to 32 bits); a field is empty with probability EMPTY_INT
    or EMPTY_CAT. About 243 bytes a line. Built as a byte matrix with 0
    as padding, which no line holds."""
    n_int, n_cat = 13, 26
    width = 2 + n_int * 7 + n_cat * 9 + 1
    mat = np.zeros((rows, width), np.uint8)
    mat[:, 0] = np.where(rng.random(rows) < 0.3, ord("1"), ord("0"))
    col = 1
    for f, card in enumerate(FIELD_CARDS):
        mat[:, col] = ord("\t")
        col += 1
        draw = rng.zipf(1.2, size=rows).astype(np.uint64) % np.uint64(card)
        if f < n_int:
            v = np.minimum(draw, 999_999).astype(np.int64)
            digits = np.zeros((rows, 6), np.uint8)
            for k in range(6):  # right-aligned, leading zeros left out
                d = (v // 10 ** (5 - k)) % 10
                keep = (v >= 10 ** (5 - k)) | (k == 5)
                digits[:, k] = np.where(keep, ord("0") + d, 0)
            digits[rng.random(rows) < EMPTY_INT] = 0
            mat[:, col:col + 6] = digits
            col += 6
        else:
            with np.errstate(over="ignore"):
                x = _mix(draw + np.uint64(f) * np.uint64(0x9E3779B97F4A7C15))
            x = (x & np.uint64(0xFFFFFFFF)).astype(np.int64)
            digits = _HEX[(x[:, None] >> (4 * np.arange(7, -1, -1))) & 15]
            digits[rng.random(rows) < EMPTY_CAT] = 0
            mat[:, col:col + 8] = digits
            col += 8
    mat[:, col] = ord("\n")
    return mat[mat != 0].tobytes()


def synth_adfea_text(rng, rows: int) -> bytes:
    """`rows` adfea lines ("lineid num_features label fid:gid ..."):
    labels -1/1, ADFEA_FEATS fid:gid tokens a line with gids over 0-1023 and
    fids drawn Zipf(1.2) and mixed to 64 bits, one in eight of them
    negative and one in eight widened to 22 digits (the key takes fid mod
    2^74), and a bare key every fifth line."""
    lines, feats = [], ADFEA_FEATS
    fid = _mix(rng.zipf(1.2, size=(rows, feats)).astype(np.uint64))
    gid = rng.integers(0, 1024, size=(rows, feats))
    kind = rng.integers(0, 8, size=(rows, feats))
    label = np.where(rng.random(rows) < 0.3, 1, -1)
    for r in range(rows):
        toks = [str(r), str(feats), str(label[r])]
        for j in range(feats):
            v = int(fid[r, j])
            if kind[r, j] == 0:
                v = -v
            elif kind[r, j] == 1:
                v = v * 10 ** 3 + 123  # 22 or 23 digits
            toks.append(f"{v}:{gid[r, j]}")
        if r % 5 == 0:
            toks.append(str(int(fid[r, 0])))
        lines.append(" ".join(toks))
    return ("\n".join(lines) + "\n").encode()


# The tile-edge corpora of the card's tiled parsers (csrc/parse.cu for
# libsvm, csrc/formats.cu for criteo, criteo_test and adfea), which cut a
# chunk into tiles (16,384 bytes on the card, smaller in the tests' Python
# mirrors). Each piece starts `shift` bytes before a tile edge, after a
# filler line, so that over the shifts every seam of it crosses an edge.
# libsvm (filler: a comment line of x's): comment lines, "\r\n" and empty
# lines, a label, "k:v" tokens, bare keys, blanks, a decimal longer than
# the mirrors' halo, a last line with no line break.
LIBSVM_EDGE_PIECES = ("# a comment 1:2 3:4\n", "1 3:1.5 4\r\n", "\r\n\n",
                      "  0\t7:2.25  8 9:1e-3\n",
                      "1 10:" + "1" * 60 + "e-58 11:1\n", "#\n",
                      "\n\r1 13\t \n", "-1 12:0.5")


def _criteo_edge_pieces(tile: int) -> tuple:
    """criteo (filler: a kept line, "0\\t" and a field of x's): empty and
    blank-only cells and lines, "\\r\\n" and empty lines, a line whose only
    kept byte lies 70 bytes on, a cell longer than the halo, a label on
    the exact path longer than it, a line longer than a tile (`tile` + 64
    bytes or more) with fields past 39, no final line break."""
    wide = -(-(tile + 64) // 42)
    return ("1\t5\t\t3\tab12cd34\t\t9f0e1d2c\n", "0\t7\t\t x y \t\r\n",
            "\r\n\n", "  \t \t  \n", " " * 70 + "1\n",
            "1\t" + "c" * 300 + "\td\n",
            "1.5" + "0" * 300 + "1\t2\n",
            "1\t" + "\t".join(f"{k:02d}" + "w" * wide for k in range(42))
            + "\n", "0\t1\r\n", "\t\t\n", "1\t2\t3")


def _adfea_edge_pieces(tile: int) -> tuple:
    """adfea (filler: a kept line, a label and blanks): short and empty
    lines, tabs, spaces and "\\r\\n", a label 70 bytes on, a token longer
    than the halo, a label on the exact path longer than it, a line longer
    than a tile, a blank line, no final line break."""
    wide = -(-(tile + 64) // 12)
    return ("0 3 1 5:3 7:1 9\n", "1 2\n\n1\n",
            "\t0  2\t1\t 3:4 \t5:6 \r\n", "a b " + " " * 70 + "1 5:6\n",
            "a b 1 " + "1" * 300 + ":3 7\n",
            "a b 1.5" + "0" * 300 + "1 2:3\n",
            "a b 0 " + " ".join(f"{k}:{k * 97 % 1024}" for k in
                                range(1, wide)) + "\n",
            "x y -1 4:5 \r\n", "  \t \n", "x y 1 7:8")


def tile_edge_text(fmt: str, tile: int, shift: int) -> str:
    """The tile-edge corpus of `fmt` (libsvm, criteo, criteo_test or
    adfea) at a tile size and shift."""
    if fmt == "libsvm":
        pieces, least = LIBSVM_EDGE_PIECES, 2

        def filler(k):
            return "#" + "x" * (k - 2) + "\n"
    elif fmt == "adfea":
        pieces, least = _adfea_edge_pieces(tile), 6

        def filler(k):
            return "a b 0" + " " * (k - 6) + "\n"
    else:
        pieces, least = _criteo_edge_pieces(tile), 3

        def filler(k):
            return "0\t" + "x" * (k - 3) + "\n"
    out = ""
    for piece in pieces:
        target = (len(out) // tile + 1) * tile - shift
        while target - len(out) < least:
            target += tile
        out += filler(target - len(out)) + piece
    return out
