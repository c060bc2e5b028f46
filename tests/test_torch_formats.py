"""The port's criteo, criteo_test, adfea and crb formats against the JAX
package's, and the card parsers' rules on the CPU.

- cityhash64 (ops/hashing.py) gives the JAX package's on random bytes of
  every length 0 to 300.
- The plain parsers (data/parsers.py parse_criteo, parse_adfea, the card
  kernels' contracts) give the JAX package's Python parsers' bytes on the
  edge corpora and on hypothesis-made lines, and raise where they raise;
  on well-formed text they also give its parse_text's (the native C++
  route where it is built). Where the JAX package's two routes disagree
  (the lone CR, PEP 515 labels and ids, negative and wide fids), the port
  follows the Python parser.
- formats_mirror (parse_criteo_mirror, parse_adfea_mirror), csrc/
  formats.cu's tiled design in Python at any tiling (each group's masks,
  the warps' walks of the lines that start in their regions, criteo's
  look-ahead for a line's keep, the scan of the tiles' counts, the
  queued cells read from the tile or past its halo, the per-cell hash,
  the grammar, the 128-bit fid accumulator), gives the plain parsers'
  bytes on the corpora, on the tile-edge corpora at every shift and at
  the card's tiling, around whole numbers of tiles and on hypothesis
  lines at any offset; where the plain parser raises it raises, naming
  the token as the card's wrapper does.
- crb files written by either package are read by both; the same blocks
  give the same bytes. The convert app writes the JAX convert's files
  byte for byte, appends as it does, and MinibatchIter over crb emits the
  JAX package's batches.
- The apps train from Criteo TSV and from its crb as the JAX apps do
  (linear: predictions and tables rtol 1e-4 / atol 1e-6, the bar of
  tests/test_linear.py:247-253; DiFacto: rtol 1e-4 / atol 1e-5, as
  tests/test_torch_difacto.py holds it), and a crb file trains exactly
  as its text does.

The kernels themselves meet the plain parsers on the card
(tests/test_torch_cuda.py, marker cuda).
"""

import os
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import synth_libsvm_text
from test_torch_cuda import (ADFEA_EDGE, ADFEA_ERRORS, CRITEO_EDGE,
                             CRITEO_ERRORS, FIRST_REFUSED, criteo_sweep_text,
                             format_sized_text, same_block)
from test_torch_parse import (BAD, CARD_HALO, CARD_TILE, CARD_WARPS, EXACT,
                              FAST, digit_run_end, parse_float, parse_key)
from wormhole_tpu.data import crb as j_crb
from wormhole_tpu.data import parsers as j_parsers
from wormhole_tpu.data.minibatch import MinibatchIter as JIter
from wormhole_tpu.ops import hashing as j_hashing
from wormhole_tpu_torch.data import crb as t_crb
from wormhole_tpu_torch.data import parsers as t_parsers
from wormhole_tpu_torch.data.minibatch import MinibatchIter as TIter
from wormhole_tpu_torch.data.rowblock import RowBlock
from wormhole_tpu_torch.data.synth import (synth_adfea_text, synth_criteo_tsv,
                                           tile_edge_text)
from wormhole_tpu_torch.ops import hashing as t_hashing
from wormhole_tpu_torch.ops import coo_kernels as t_ck

M64 = (1 << 64) - 1
TILE = t_ck.TILE
PLAIN = {"criteo": lambda t: t_parsers.parse_criteo(t, True),
         "criteo_test": lambda t: t_parsers.parse_criteo(t, False),
         "adfea": t_parsers.parse_adfea}
J_PLAIN = {"criteo": lambda t: j_parsers.parse_criteo(t, True),
           "criteo_test": lambda t: j_parsers.parse_criteo(t, False),
           "adfea": j_parsers.parse_adfea}
# corpus entries where the JAX package's native C++ route differs from
# its Python parser (and so from the port)
NATIVE_DIFFERS = {"criteo": {"lone-cr", "underscore-label"},
                  "criteo_test": {"lone-cr", "lone-cr-splits-a-line"},
                  "adfea": {"negative-fid", "fid-past-2^64", "underscores",
                            "bare-keys", "labels", "tabs-spaces-crlf"}}


def outcome(parse, text):
    """A parser's RowBlock, or the class of error it raised."""
    try:
        return parse(text)
    except (ValueError, OverflowError):
        return "raises"


def same_outcome(got, want):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want == "raises", (got, want)
    else:
        same_block(got, want)


# ------------------------------------------------------------ cityhash64
@pytest.mark.parametrize("lengths", [range(0, 17), range(17, 33),
                                     range(33, 65), range(65, 301)],
                         ids=["0-16", "17-32", "33-64", "65-300"])
def test_cityhash64_matches_jax_every_length(lengths):
    rng = np.random.default_rng(lengths.start)
    for n in lengths:
        for _ in range(3):
            b = bytes(rng.integers(0, 256, size=n).astype(np.uint8))
            want = j_hashing.cityhash64(b)
            assert t_hashing.cityhash64(b) == want
            assert cityhash_mirror(b) == want
    assert t_hashing.cityhash64("abc") == j_hashing.cityhash64(b"abc")


def test_pack_field_key_matches_jax():
    rng = np.random.default_rng(2)
    toks = ["68fd1e64", ""] + [f"{v:x}" for v in
                               rng.integers(0, 1 << 62, size=62)]
    for f in (0, 13, 38, 1023, 1024):
        for tok in toks:
            assert (t_hashing.pack_field_key(tok, f)
                    == j_hashing.pack_field_key(tok, f))


# ---------------------------------------- csrc/formats.cu's rules, mirrored
K0, K1, K2 = 0xC3A5C85C97CB3127, 0xB492B66FBE98F273, 0x9AE16A3B2F90404F
KMUL = 0x9DDFEA08EB382D69


def _fetch64(s, i):  # formats.cu fetch64: bytes, little-endian
    r = 0
    for k in range(7, -1, -1):
        r = (r << 8) | s[i + k]
    return r


def _fetch32(s, i):
    return s[i] | s[i + 1] << 8 | s[i + 2] << 16 | s[i + 3] << 24


def _rotr(v, s):
    return v if s == 0 else ((v >> s) | (v << (64 - s))) & M64


def _byte_perm_0123(x):  # __byte_perm(x, 0, 0x0123): a 32-bit byte swap
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def _bswap64(v):
    return (_byte_perm_0123(v & 0xFFFFFFFF) << 32) | _byte_perm_0123(v >> 32)


def _len16(u, v, mul):
    a = ((u ^ v) * mul) & M64
    a ^= a >> 47
    b = ((v ^ a) * mul) & M64
    b ^= b >> 47
    return (b * mul) & M64


def _weak32_at(s, i, a, b):
    w, x, y, z = (_fetch64(s, i + 8 * k) for k in range(4))
    a = (a + w) & M64
    b = _rotr((b + a + z) & M64, 21)
    c = a
    a = (a + x + y) & M64
    b = (b + _rotr(a, 44)) & M64
    return (a + z) & M64, (b + c) & M64


def cityhash_mirror(s: bytes) -> int:
    """formats.cu cityhash64, step for step (u64 arithmetic wraps)."""
    n = len(s)
    mul = (K2 + n * 2) & M64
    if n <= 16:
        if n >= 8:
            a = (_fetch64(s, 0) + K2) & M64
            b = _fetch64(s, n - 8)
            c = (_rotr(b, 37) * mul + a) & M64
            d = ((_rotr(a, 25) + b) * mul) & M64
            return _len16(c, d, mul)
        if n >= 4:
            return _len16(n + (_fetch32(s, 0) << 3), _fetch32(s, n - 4), mul)
        if n > 0:
            y = s[0] + (s[n >> 1] << 8)
            z = n + (s[n - 1] << 2)
            v = ((y * K2) & M64) ^ ((z * K0) & M64)
            return ((v ^ (v >> 47)) * K2) & M64
        return K2
    if n <= 32:
        a = (_fetch64(s, 0) * K1) & M64
        b = _fetch64(s, 8)
        c = (_fetch64(s, n - 8) * mul) & M64
        d = (_fetch64(s, n - 16) * K2) & M64
        return _len16((_rotr((a + b) & M64, 43) + _rotr(c, 30) + d) & M64,
                      (a + _rotr((b + K2) & M64, 18) + c) & M64, mul)
    if n <= 64:
        a = (_fetch64(s, 0) * K2) & M64
        b = _fetch64(s, 8)
        c, d = _fetch64(s, n - 24), _fetch64(s, n - 32)
        e = (_fetch64(s, 16) * K2) & M64
        f = (_fetch64(s, 24) * 9) & M64
        g = _fetch64(s, n - 8)
        h = (_fetch64(s, n - 16) * mul) & M64
        u = (_rotr((a + g) & M64, 43) + ((_rotr(b, 30) + c) * 9)) & M64
        v = ((((a + g) & M64) ^ d) + f + 1) & M64
        w = (_bswap64(((u + v) * mul) & M64) + h) & M64
        x = (_rotr((e + f) & M64, 42) + c) & M64
        y = ((_bswap64(((v + w) * mul) & M64) + g) * mul) & M64
        z = (e + f + c) & M64
        a = (_bswap64(((x + z) * mul + y) & M64) + b) & M64
        t = ((z + a) * mul + d + h) & M64
        return (((t ^ (t >> 47)) * mul) + x) & M64
    x = _fetch64(s, n - 40)
    y = (_fetch64(s, n - 16) + _fetch64(s, n - 56)) & M64
    z = _len16((_fetch64(s, n - 48) + n) & M64, _fetch64(s, n - 24), KMUL)
    v = _weak32_at(s, n - 64, n, z)
    w = _weak32_at(s, n - 32, (y + K1) & M64, x)
    x = (x * K1 + _fetch64(s, 0)) & M64
    rem, p = (n - 1) & ~63, 0
    while True:
        x = (_rotr((x + y + v[0] + _fetch64(s, p + 8)) & M64, 37) * K1) & M64
        y = (_rotr((y + v[1] + _fetch64(s, p + 48)) & M64, 42) * K1) & M64
        x ^= w[1]
        y = (y + v[0] + _fetch64(s, p + 40)) & M64
        z = (_rotr((z + w[0]) & M64, 33) * K1) & M64
        v = _weak32_at(s, p, (v[1] * K1) & M64, (x + w[0]) & M64)
        w = _weak32_at(s, p + 32, (z + w[1]) & M64,
                       (y + _fetch64(s, p + 16)) & M64)
        z, x = x, z
        p, rem = p + 64, rem - 64
        if rem == 0:
            break
    sy = y ^ (y >> 47)
    return _len16((_len16(v[0], w[0], KMUL) + sy * K1 + z) & M64,
                  (_len16(v[1], w[1], KMUL) + x) & M64, KMUL)


def parse_int_wrap(p: bytes):
    """formats.cu parse_int_wrap: int() mod 2^128 as (lo, hi), or None."""
    i, neg = 0, False
    if p[:1] in (b"+", b"-"):
        neg, i = p[0] == ord("-"), 1
    end = digit_run_end(p, i)
    if end != len(p) or end == i:
        return None
    lo = hi = 0
    for c in p[i:]:
        if c == ord("_"):
            continue
        hi = (hi * 10 + ((lo * 10) >> 64)) & M64
        lo = (lo * 10) & M64
        s = (lo + c - 48) & M64
        hi, lo = (hi + (s < lo)) & M64, s
    if neg:
        lo = (~lo + 1) & M64
        hi = (~hi + (lo == 0)) & M64
    return lo, hi


def adfea_key_mirror(tok: bytes):
    """formats.cu adfea_key: fid:gid or a bare key, or None."""
    fid, colon, gid = tok.partition(b":")
    if not colon:
        return parse_key(tok)
    f, g = parse_int_wrap(fid), parse_int_wrap(gid)
    if f is None or g is None:
        return None
    return ((f[0] >> 10) | (f[1] << 54) & M64) | ((g[0] & 0x3FF) << 54)


# csrc/formats.cu's tiles: kTile bytes a CTA, kTile / warps bytes a
# warp's region, kHalo bytes loaded past a tile. The mirror takes them
# small by default (a 64-byte tile of two one-group regions, a 32-byte
# halo), so that short texts cross many tile edges and long cells run past
# the halo, or at the card's own (CARD_TILE, CARD_WARPS, CARD_HALO).
_PAD = 10  # bytes outside the chunk read as line breaks
_BREAKS, _SEPS = b"\r\n", b" \t\r\n"
_M32 = 0xFFFFFFFF


def _ffs(x: int) -> int:
    return (x & -x).bit_length()  # __ffs: 1 + the lowest set bit, 0 for 0


def _top(x: int) -> int:
    return x.bit_length() - 1     # 31 - __clz, -1 for 0


def _bits(x: int):
    while x:
        low = x & -x
        yield low.bit_length() - 1
        x ^= low


def _classify(b: np.ndarray, criteo: bool):
    """formats.cu classify over whole groups of bytes: (nl, x, y) masks a
    group (criteo: tabs and bytes that keep a line; adfea: separators)."""
    def masks(flags):
        return [int(v) for v in
                np.packbits(flags, bitorder="little").view("<u4")]
    nl = np.isin(b, list(_BREAKS))
    if criteo:
        x = b == 9
        y = ~np.isin(b, list(b" \t\r\n"))
    else:
        x = np.isin(b, list(_SEPS))
        y = np.zeros_like(x)
    return masks(nl), masks(x), masks(y)


class _FormatsTile:
    """A tile as formats.cu's load_tile and mask_tile leave it in shared
    memory: its bytes, the byte before it and the halo (line breaks
    outside the chunk), each group's masks, and the region counts of the
    count pass (criteo: cell separators and line breaks; adfea: token
    starts) and its first byte outside the alphabet."""

    def __init__(self, raw: bytes, t0: int, tile: int, warps: int,
                 halo: int, criteo: bool):
        n = len(raw)
        self.t0, self.tile, self.halo, self.criteo = t0, tile, halo, criteo
        self.region = tile // warps
        self.ngroups = (tile + halo) // 32
        pre = raw[t0 - 1] if t0 > 0 else _PAD
        body = raw[t0:t0 + tile + halo]
        self.buf = bytes([pre]) + body + bytes([_PAD]) * (
            tile + halo - len(body))
        self.nl, self.x, self.y = _classify(
            np.frombuffer(self.buf[1:], np.uint8), criteo)
        valid = [_M32 if n - (t0 + 32 * g) >= 32 else
                 max(0, (1 << max(0, n - (t0 + 32 * g))) - 1)
                 for g in range(tile // 32)]
        if criteo:
            self.a = sum(((self.x[g] | self.nl[g]) & v).bit_count()
                         for g, v in enumerate(valid))
            self.b = sum((self.nl[g] & v).bit_count()
                         for g, v in enumerate(valid))
        else:
            before = int(self.buf[0] in _SEPS)
            self.a = 0
            for g, v in enumerate(valid):
                x = self.x[g]
                self.a += (~x & ((x << 1) | before) & v & _M32).bit_count()
                before = x >> 31
            self.b = 0
        self.err = next((t0 + i for i in range(min(tile, n - t0))
                         if not (0x20 <= raw[t0 + i] <= 0x7E
                                 or raw[t0 + i] in b"\t\r\n")), None)

    def group(self, raw: bytes, g: int):
        """group_at: the masks of group g, from the tile inside it and its
        halo, else from the chunk (line breaks past its end)."""
        if g < self.ngroups:
            return self.nl[g], self.x[g], self.y[g]
        a = self.t0 + 32 * g
        b = np.frombuffer(raw[a:a + 32].ljust(32, bytes([_PAD])), np.uint8)
        return tuple(m[0] for m in _classify(b, self.criteo))

    def kept_ahead(self, raw: bytes, g: int) -> bool:
        """formats.cu kept_ahead: the first keeping byte or line break
        after group g is a keeping byte."""
        while True:
            g += 1
            nl, _, y = self.group(raw, g)
            if y | nl:
                return bool(y >> (_ffs(y | nl) - 1) & 1)

    def cell(self, raw: bytes, pos: int) -> bytes:
        """cell_end: the cell or token at chunk offset pos, its end from
        the masks inside the halo, read on from the chunk past it."""
        p = pos - self.t0
        if p < self.tile + self.halo:
            g = p >> 5
            m = self.end_mask(g) & (_M32 << (p & 31)) & _M32
            while m == 0 and g + 1 < self.ngroups:
                g += 1
                m = self.end_mask(g)
            if m:
                end = self.t0 + 32 * g + _ffs(m) - 1
                return self.buf[1 + p:1 + end - self.t0]
        end = max(pos, self.t0 + self.tile + self.halo)
        ends = b"\t\r\n" if self.criteo else _SEPS
        while end < len(raw) and raw[end] not in ends:
            end += 1
        return raw[pos:end]

    def end_mask(self, g: int) -> int:
        return self.nl[g] | self.x[g] if self.criteo else self.x[g]


def _walk(t: _FormatsTile, raw: bytes, w: int, has_label: bool, rows: int,
          feats: int, emit: list | None):
    """formats.cu walk: warp w walks the lines that start in its region,
    a group at a time, its last line on to its end. Each lane's line is
    its last line start at or below it (owned where the start lies in the
    region, or where the line ran on into the group and was owned); criteo
    keeps a line whose first event (keeping byte or line break) is a
    keeping byte (looking ahead past the group where it must), rows start
    at kept lines' starts and features are nonempty cells of fields 0-38;
    adfea's token 2 is the row's label, tokens 3 and on its features. A
    group with no line start is taken in mask arithmetic where all its
    cells or tokens have one role. With `emit` a list, appends ("offset",
    row, feat), ("label0", row) and the queued ("label" | "feat", pos,
    slot, kind) in the kernel's order. Returns (rows, feats, heads)."""
    n = len(raw)
    criteo = t.criteo
    r0 = t.t0 + w * t.region
    r1 = min(r0 + t.region, n)
    g = w * t.region // 32
    before = t.buf[32 * g]  # the byte before the region (buf[0] is t0 - 1)
    nl_before, x_before = int(before in _BREAKS), int(
        before == 9 if criteo else before in _SEPS)
    in_line, keep, cnt, heads = False, False, 0, 0

    def ballot(pred):
        return sum(1 << lane for lane in range(32) if pred(lane))

    while True:
        base = t.t0 + 32 * g
        if base >= n or (base >= r1 and not in_line):
            break
        nl, x, y = t.group(raw, g)
        starts = ((nl << 1) | nl_before) & _M32
        if criteo:  # nonempty cell starts
            cells = (starts | (x << 1) | x_before) & ~(x | nl) & _M32
        else:       # token starts
            cells = ~x & ((x << 1) | x_before) & _M32
        row_m = label_m = feat_m = 0
        kind = [0] * 32

        def lt(lane):
            return (1 << lane) - 1

        if starts == 0:  # the group lies on the line running on into it
            if criteo:
                kind = [cnt + (x & lt(l)).bit_count() - has_label
                        for l in range(32)]
                if in_line and keep and cells:
                    if (cnt >= has_label
                            and cnt + x.bit_count() < 39 + has_label):
                        feat_m = cells
                    else:
                        feat_m = ballot(lambda l: cells >> l & 1
                                        and 0 <= kind[l] < 39)
                cnt += x.bit_count()
            else:
                if in_line and cells:
                    if cnt >= 3:
                        feat_m = cells
                    else:
                        idx = [cnt + (cells & lt(l)).bit_count()
                               for l in range(32)]
                        row_m = ballot(lambda l: cells >> l & 1
                                       and idx[l] == 2)
                        feat_m = ballot(lambda l: cells >> l & 1
                                        and idx[l] >= 3)
                        heads += ballot(lambda l: cells >> l & 1
                                        and idx[l] == 0).bit_count()
                cnt += cells.bit_count()
        else:
            hi = r1 - base
            own = starts & (_M32 if hi >= 32 else 0 if hi <= 0
                            else (1 << hi) - 1)
            last = _top(starts)
            line = [_top(starts & ((2 << l) - 1)) for l in range(32)]
            owned = [own >> p & 1 if p >= 0 else in_line for p in line]
            if criteo:
                keeps = ahead = 0
                for l in _bits(starts):
                    ev = (y | nl) & (_M32 << l) & _M32
                    if ev:
                        keeps |= (y >> (_ffs(ev) - 1) & 1) << l
                    else:
                        ahead |= 1 << l
                ahead &= own
                if ahead and t.kept_ahead(raw, g):
                    keeps |= ahead
                kp = [keeps >> p & 1 if p >= 0 else keep for p in line]
                kind = [((x & lt(l) & ~((1 << p) - 1)).bit_count() if p >= 0
                         else cnt + (x & lt(l)).bit_count()) - has_label
                        for l, p in enumerate(line)]
                row_m = ballot(lambda l: owned[l] and kp[l]
                               and starts >> l & 1)
                feat_m = ballot(lambda l: owned[l] and kp[l]
                                and cells >> l & 1 and 0 <= kind[l] < 39)
                label_m = row_m if has_label else 0
                in_line, keep = bool(own >> last & 1), bool(keeps >> last & 1)
                cnt = (x & ~((1 << last) - 1) & _M32).bit_count()
            else:
                idx = [(cells & lt(l) & ~((1 << p) - 1)).bit_count()
                       if p >= 0 else cnt + (cells & lt(l)).bit_count()
                       for l, p in enumerate(line)]
                row_m = ballot(lambda l: owned[l] and cells >> l & 1
                               and idx[l] == 2)
                feat_m = ballot(lambda l: owned[l] and cells >> l & 1
                                and idx[l] >= 3)
                heads += ballot(lambda l: owned[l] and cells >> l & 1
                                and idx[l] == 0).bit_count()
                in_line = bool(own >> last & 1)
                cnt = (cells & ~((1 << last) - 1) & _M32).bit_count()
        if not criteo:
            label_m = row_m  # adfea's row is its label token
        if nl >> 31:
            in_line = False
        nl_before, x_before = nl >> 31, x >> 31
        if emit is not None:
            for l in _bits(row_m | feat_m):
                row = rows + (row_m & lt(l)).bit_count()
                feat = feats + (feat_m & lt(l)).bit_count()
                if row_m >> l & 1:
                    emit.append(("offset", row, feat))
                    if not label_m >> l & 1:
                        emit.append(("label0", row))
                if label_m >> l & 1:
                    emit.append(("label", base + l, row, -1))
                elif feat_m >> l & 1:  # criteo_test's field 0 heads a row
                    emit.append(("feat", base + l, feat, kind[l]))
        rows += row_m.bit_count()
        feats += feat_m.bit_count()
        g += 1
    return rows, feats, heads


def formats_mirror(data, fmt: str, tile: int = 64, warps: int = 2,
                   halo: int = 32):
    """csrc/formats.cu's design in Python, step for step at any tiling:
    each tile's masks and region counts and each warp's walk counting its
    rows and features (count pass), the tiles' sums scanned into carries
    (scan), then each warp's walk from its carry (the tile's and the
    warps' before it) writing the rows' offsets and queueing the labels
    and features, each converted or hashed from its cell's bytes (emit).
    Returns the RowBlock and the kernel's stats (tokens, lines, rows,
    feats, exact); raises ValueError where the wrapper raises, naming the
    refused token as native.py's _refused_span does."""
    raw = data.encode() if isinstance(data, str) else bytes(data)
    n = len(raw)
    assert tile % (32 * warps) == 0 and halo % 32 == 0
    criteo, has_label = fmt != "adfea", fmt == "criteo"
    tiles = [_FormatsTile(raw, t0, tile, warps, halo, criteo)
             for t0 in range(0, n, tile)]
    errs = [t.err for t in tiles if t.err is not None]
    if errs:
        raise ValueError(f"{fmt} chunk: byte {min(errs)} is outside the "
                         f"alphabet")
    # 1. count
    wcounts = [[_walk(t, raw, w, has_label, 0, 0, None)
                for w in range(warps)] for t in tiles]
    # 2. scan
    carry, rows, feats = [], 0, 0
    for wc in wcounts:
        carry.append((rows, feats))
        rows += sum(c[0] for c in wc)
        feats += sum(c[1] for c in wc)
    R, F = rows, feats
    tokens = sum(t.a for t in tiles) + criteo
    lines = (sum(t.b for t in tiles) + 1 if criteo
             else sum(c[2] for wc in wcounts for c in wc))
    # 3. emit
    label = np.zeros(R, np.uint32)
    offset = np.zeros(R + 1, np.int64)
    index = np.zeros(F, np.uint64)
    offset[R] = F
    n_exact, bad = 0, []
    for t, wc, (rows, feats) in zip(tiles, wcounts, carry):
        for w in range(warps):
            before = wc[:w]
            ops = []
            _walk(t, raw, w, has_label, rows + sum(c[0] for c in before),
                  feats + sum(c[1] for c in before), ops)
            for op in ops:
                if op[0] == "offset":
                    offset[op[1]] = op[2]
                elif op[0] == "label0":
                    label[op[1]] = 0
                else:  # converted 32 at a time on the card
                    _, pos, slot, kind = op
                    cell = t.cell(raw, pos)
                    if op[0] == "label" and criteo:
                        conv, _, bits = parse_float(cell.strip(b" "))
                        label[slot] = bits or 0
                    elif op[0] == "label":
                        conv, v, _ = parse_float(cell)
                        label[slot] = 0x3F800000 if conv != BAD and v > 0 \
                            else 0
                    elif criteo:
                        conv = FAST
                        index[slot] = (cityhash_mirror(cell) >> 10) | (
                            kind << 54)
                    else:
                        key = adfea_key_mirror(cell)
                        conv = BAD if key is None else FAST
                        index[slot] = key or 0
                    if conv == BAD:
                        bad.append(pos)
                    n_exact += conv == EXACT
    if bad:
        beg = end = min(bad)
        while end < n and raw[end] not in (b"\t\r\n" if criteo else _SEPS):
            end += 1
        raise ValueError(f"{fmt} chunk: token {raw[beg:end].decode()!r} at "
                         f"byte {beg} ({len(bad)} such tokens)")
    stats = dict(tokens=tokens, lines=lines, rows=R, feats=F, exact=n_exact)
    return RowBlock(label=label.view(np.float32), offset=offset, index=index,
                    value=None), stats


def parse_criteo_mirror(data, has_label=True, **tiling):
    """formats_mirror of criteo (has_label) or criteo_test: (RowBlock,
    labels on the exact path)."""
    blk, stats = formats_mirror(data, "criteo" if has_label else
                                "criteo_test", **tiling)
    return blk, stats["exact"]


def parse_adfea_mirror(data, **tiling):
    return formats_mirror(data, "adfea", **tiling)[0]


MIRROR = {"criteo": lambda t: parse_criteo_mirror(t, True)[0],
          "criteo_test": lambda t: parse_criteo_mirror(t, False)[0],
          "adfea": parse_adfea_mirror}

# --------------------------------------------------------- the corpora
CORPUS = ([(f, n) for f in ("criteo", "criteo_test")
           for n in sorted({**CRITEO_EDGE, **CRITEO_ERRORS})]
          + [("adfea", n) for n in sorted({**ADFEA_EDGE, **ADFEA_ERRORS})])


def corpus_text(fmt, name):
    return ({**ADFEA_EDGE, **ADFEA_ERRORS} if fmt == "adfea"
            else {**CRITEO_EDGE, **CRITEO_ERRORS})[name]


@pytest.mark.parametrize("fmt,name", CORPUS)
def test_plain_parsers_match_jax(fmt, name):
    text = corpus_text(fmt, name)
    got = outcome(PLAIN[fmt], text)
    same_outcome(got, outcome(J_PLAIN[fmt], text))
    same_outcome(outcome(lambda t: t_parsers.parse_text(t, fmt), text), got)
    same_outcome(outcome(lambda t: t_parsers.parse_text(t.encode(), fmt,
                                                        "cpu"), text), got)
    errors = ADFEA_ERRORS if fmt == "adfea" else (
        CRITEO_ERRORS if fmt == "criteo" else {})
    assert isinstance(got, str) == (name in errors)
    if not isinstance(got, str) and name not in NATIVE_DIFFERS[fmt]:
        # the JAX package's parse_text: its native C++ parser where it is
        # built, which agrees with its Python parser on this text
        same_block(j_parsers.parse_text(text, fmt), got)


@pytest.mark.parametrize("fmt,name", CORPUS)
def test_mirror_matches_plain(fmt, name):
    text = corpus_text(fmt, name)
    same_outcome(outcome(MIRROR[fmt], text), outcome(PLAIN[fmt], text))
    same_outcome(outcome(MIRROR[fmt], text.encode()),
                 outcome(PLAIN[fmt], text))


def test_where_the_jax_routes_disagree_the_port_follows_python():
    """Where the JAX package's Python and native C++ parsers disagree
    (ROADMAP Queue C's table), the Python parser's outcome, row by row."""
    rows = [
        ("criteo", "1\t5\rx\t6\n", "raises"),
        ("criteo_test", "1\t5\rx\t6\n", [0, 2, 4]),
        ("criteo", "1_0\t5\n", [0, 1]),
        ("adfea", "a b 1 -5:3\n", [0, 1]),
        ("adfea", f"a b 1 {2 ** 70 + 12345}:3\n", [0, 1]),
        ("adfea", f"a b 1 {2 ** 64}\n", "raises"),
        ("adfea", "a b 1 -5\n", "raises"),
        ("adfea", "a b 1 1_000:3\n", [0, 1]),
    ]
    for fmt, text, want in rows:
        got = outcome(PLAIN[fmt], text)
        same_outcome(got, outcome(J_PLAIN[fmt], text))
        same_outcome(outcome(MIRROR[fmt], text), got)
        if want == "raises":
            assert got == "raises", (fmt, text)
        else:
            assert got.offset.tolist() == want, (fmt, text)
    assert t_parsers.parse_criteo("1_0\t5\n").label.tolist() == [10.0]
    assert t_parsers.parse_adfea("a b 1 -5:3\n").index.tolist() == [M64]
    assert t_parsers.parse_adfea(
        f"a b 1 {2 ** 70 + 12345}:3\n").index.tolist() == [
        ((2 ** 70 + 12345) >> 10) & M64 | 3 << 54]


def test_cityhash_sweep_through_the_mirror():
    text = criteo_sweep_text()
    got, _ = parse_criteo_mirror(text, has_label=False)
    same_block(got, t_parsers.parse_criteo(text, has_label=False))
    same_block(got, j_parsers.parse_criteo(text, has_label=False))
    assert got.size == 301


@pytest.mark.parametrize("fmt", ["criteo", "criteo_test", "adfea"])
def test_synthetic_text_through_every_route(fmt):
    rng = np.random.default_rng(6)
    raw = (synth_adfea_text(rng, 300) if fmt == "adfea"
           else synth_criteo_tsv(rng, 300))
    text = raw.decode()
    got = PLAIN[fmt](text)
    assert got.size == 300
    same_block(J_PLAIN[fmt](text), got)
    if fmt != "adfea":  # the native route saturates negative and wide fids
        same_block(j_parsers.parse_text(text, fmt), got)
    same_block(MIRROR[fmt](raw), got)
    if fmt == "adfea":
        assert int(got.index.max()) >= 1 << 63  # gids of 512 and up
    else:
        assert int(got.index.max()) < 1 << 60
        assert 30 * 300 < got.nnz < 39 * 300


def test_bytes_outside_the_alphabet_raise_in_the_mirror():
    for fmt in MIRROR:
        with pytest.raises(ValueError, match=r"byte 19 "):
            MIRROR[fmt](b"1 2 1 3:4\t5\n0 1 0 4\x0b5\t6\n")


# hypothesis: lines from the alphabet's corners
_CELL = st.text(alphabet=" 0123456789abcef.+-_eEinfINFa\x20", max_size=12)
_NL = st.sampled_from(["\n", "\r\n", "\r"])


@st.composite
def criteo_text(draw):
    lines = []
    for _ in range(draw(st.integers(0, 5))):
        cells = draw(st.lists(_CELL, min_size=0, max_size=44))
        lines.append("\t".join(cells) + draw(_NL))
    return "".join(lines) + draw(st.sampled_from(["", "1\t2"]))


_INT = st.from_regex(r"[+-]?[0-9]{1,25}(_[0-9]{1,3})?", fullmatch=True)
_ATOM = st.one_of(_INT, st.builds(lambda a, b: f"{a}:{b}", _INT, _INT),
                  st.sampled_from(["nan", "-inf", "1e-400", "0.5", "x", ":",
                                   "1:", ":2", "1__2", "1:2:3", "-0"]))


@st.composite
def adfea_text(draw):
    lines = []
    for _ in range(draw(st.integers(0, 5))):
        toks = draw(st.lists(_ATOM, min_size=0, max_size=8))
        seps = draw(st.lists(st.sampled_from([" ", "\t", "  ", " \t"]),
                             min_size=len(toks) + 1,
                             max_size=len(toks) + 1))
        lines.append("".join(s + t for s, t in zip(seps, toks)) + seps[-1]
                     + draw(_NL))
    return "".join(lines)


@settings(max_examples=150, deadline=None)
@given(text=criteo_text(), has_label=st.booleans())
def test_criteo_routes_agree_on_generated_lines(text, has_label):
    fmt = "criteo" if has_label else "criteo_test"
    want = outcome(J_PLAIN[fmt], text)
    same_outcome(outcome(PLAIN[fmt], text), want)
    same_outcome(outcome(MIRROR[fmt], text), want)


@settings(max_examples=150, deadline=None)
@given(text=adfea_text())
def test_adfea_routes_agree_on_generated_lines(text):
    want = outcome(J_PLAIN["adfea"], text)
    same_outcome(outcome(PLAIN["adfea"], text), want)
    same_outcome(outcome(MIRROR["adfea"], text), want)


# ------------------------------------- the tiled design, at tile edges
FORMATS = ["criteo", "criteo_test", "adfea"]
_TILINGS = [(64, 2, 32), (128, 2, 32), (256, 4, 64)]


def _mirror_matches(fmt, text, **tiling):
    got, stats = formats_mirror(text, fmt, **tiling)
    want = PLAIN[fmt](text)
    same_block(got, want)
    return got, stats


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("tiling", _TILINGS,
                         ids=lambda t: "-".join(map(str, t)))
@pytest.mark.parametrize("shift", range(0, 66))
def test_mirror_tile_edge_corpus(fmt, tiling, shift):
    """Every seam of the criteo or adfea tile-edge corpus across a tile
    edge (empty, blank-only and late-kept lines, "\\r\\n", cells and
    tokens longer than the halo, an exact-path label past it, a line
    longer than a tile, no final line break): the plain parser's bytes at
    the mirror's tile sizes, one exact-path label each."""
    tile, warps, halo = tiling
    text = tile_edge_text(fmt, tile, shift % tile)
    _, stats = _mirror_matches(fmt, text, tile=tile, warps=warps, halo=halo)
    assert stats["exact"] == (fmt != "criteo_test")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shift", [0, 1, 31, 32, 255, 256, 257])
def test_mirror_tile_edge_corpus_at_the_card_tile(fmt, shift):
    """The corpus at the kernels' own tiling (16,384-byte tiles of 16
    warps, a 256-byte halo): its long line spans two tiles."""
    text = tile_edge_text(fmt, CARD_TILE, shift)
    _mirror_matches(fmt, text, tile=CARD_TILE, warps=CARD_WARPS,
                    halo=CARD_HALO)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("final_newline", [True, False])
@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_mirror_chunks_of_whole_tiles(fmt, k, delta, final_newline):
    """Chunks of exactly k tiles and k tiles +- 1 byte."""
    text = format_sized_text(fmt, 64 * k + delta, final_newline)
    assert len(text) == 64 * k + delta
    got, _ = _mirror_matches(fmt, text)
    assert got.size == text.count("\n") + (not final_newline)


def _case_text(case: str, fmt: str, tile: int, at: int) -> str:
    """A text whose `case` lies at byte `at` of the second tile."""
    lead = tile + at
    fill = (("a b 0" + " " * (lead - 6)) if fmt == "adfea"
            else "0\t" + "x" * (lead - 3)) + "\n"
    label = "a b 1" if fmt == "adfea" else "1"
    sep = " " if fmt == "adfea" else "\t"
    body = {
        # the line before the edge, and its cells and tokens past it
        "line-longer-than-a-tile": label + sep + sep.join(
            f"{k}:{k}" for k in range(3 * tile // 4)) + "\n",
        # one cell or token past the halo (the halo is half the tile)
        "cell-longer-than-the-halo": label + sep + "7" * tile + ":3" + sep
        + "5:6\n",
        "crlf-across-the-edge": label + sep + "3:4\r\n" + label + "\n",
        "blank-only-line": "  \t  " * (tile // 4) + "\n" + label + "\n",
        "kept-byte-in-the-next-tile": (
            ("a b " + " " * tile + "1 2:3") if fmt == "adfea"
            else " " * tile + "1") + "\n" + label + "\n",
    }[case]
    return fill + body


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", ["line-longer-than-a-tile",
                                  "cell-longer-than-the-halo",
                                  "crlf-across-the-edge", "blank-only-line",
                                  "kept-byte-in-the-next-tile"])
def test_mirror_the_five_cases(fmt, case):
    """The cases the design must hold, each placed at every byte from 8
    before to 8 after a tile edge (64-byte tiles, a 32-byte halo)."""
    for at in range(-8, 9):
        text = _case_text(case, fmt, 64, at)
        _mirror_matches(fmt, text)
        _mirror_matches(fmt, text, tile=128, warps=4, halo=32)


@pytest.mark.parametrize("fmt,name", sorted(FIRST_REFUSED))
def test_mirror_names_the_first_refused_token(fmt, name):
    """The refused label or key the card's wrapper names (its offset from
    the kernel's stats, the token to the next separator; criteo: the
    whole cell), for each error corpus entry."""
    text = (CRITEO_ERRORS if fmt == "criteo" else ADFEA_ERRORS)[name]
    beg, tok = FIRST_REFUSED[fmt, name]
    with pytest.raises(ValueError, match=f"token {re.escape(repr(tok))} "
                                         f"at byte {beg} "):
        formats_mirror(text, fmt)
    assert text.encode()[beg:beg + len(tok)] == tok.encode()


@pytest.mark.parametrize("fmt,name", CORPUS)
def test_mirror_stats_keep_their_meaning(fmt, name):
    """The kernels' stats: tokens (criteo's cells, separators + 1;
    adfea's tokens) and lines (criteo's line breaks + 1; adfea's lines
    with a token), rows and features."""
    text = corpus_text(fmt, name)
    try:
        blk, stats = formats_mirror(text, fmt)
    except ValueError:
        return
    lines = text.replace("\r", "\n").split("\n")
    if fmt == "adfea":
        assert stats["tokens"] == len(text.split())
        assert stats["lines"] == sum(bool(ln.split()) for ln in lines)
    else:
        assert stats["tokens"] == sum(ln.count("\t") + 1 for ln in lines)
        assert stats["lines"] == len(lines)
    assert (stats["rows"], stats["feats"]) == (blk.size, blk.nnz)


def test_mirror_cityhash_sweep_at_the_card_tile():
    """criteo-sweep's cells of every length to 301 bytes, some across
    the halo's end at the card's tiling, some past a small halo."""
    text = criteo_sweep_text()
    want = t_parsers.parse_criteo(text, has_label=False)
    for tiling in (dict(tile=CARD_TILE, warps=CARD_WARPS, halo=CARD_HALO),
                   dict(tile=256, warps=2, halo=32)):
        got, _ = parse_criteo_mirror(text, has_label=False, **tiling)
        same_block(got, want)


_LEAD = {"criteo": lambda k: "0\t" + "x" * k + "\n",
         "criteo_test": lambda k: "0\t" + "x" * k + "\n",
         "adfea": lambda k: "a b 0" + " " * k + "\n"}


@settings(max_examples=150, deadline=None)
@given(text=criteo_text(), has_label=st.booleans(), lead=st.integers(0, 70))
def test_criteo_mirror_on_generated_lines_at_any_offset(text, has_label,
                                                        lead):
    """hypothesis lines after a kept line of `lead` more bytes, so that
    their seams land anywhere in a 64-byte tile."""
    fmt = "criteo" if has_label else "criteo_test"
    text = _LEAD[fmt](lead) + text
    same_outcome(outcome(MIRROR[fmt], text), outcome(PLAIN[fmt], text))


@settings(max_examples=150, deadline=None)
@given(text=adfea_text(), lead=st.integers(0, 70))
def test_adfea_mirror_on_generated_lines_at_any_offset(text, lead):
    text = _LEAD["adfea"](lead) + text
    same_outcome(outcome(MIRROR["adfea"], text), outcome(PLAIN["adfea"], text))


@pytest.mark.parametrize("dev", [None, "cpu"])
def test_parse_text_formats_and_refusals(dev):
    text = "1\t2\n"
    for fmt in ("libsvm", "criteo", "criteo_test", "adfea"):
        t_parsers.parse_text("1 2 3\n" if fmt == "adfea" else text, fmt, dev)
    with pytest.raises(ValueError, match="unknown data format"):
        t_parsers.parse_text(text, "crb", dev)


# -------------------------------------------------------------------- crb
def _blocks():
    """Four blocks: Criteo keys (binary), libsvm values, adfea keys past
    2^63 with weights, and a slice of the first."""
    rng = np.random.default_rng(7)
    crit = t_parsers.parse_criteo(synth_criteo_tsv(rng, 40).decode())
    svm = t_parsers.parse_libsvm(synth_libsvm_text(n_rows=30, seed=3))
    adf = t_parsers.parse_adfea(synth_adfea_text(rng, 20).decode())
    adf.weight = rng.random(adf.size).astype(np.float32)
    return [crit, svm, adf, crit.slice(3, 17)]


def _same_rb(a, b):
    same_block(a, b)
    if a.weight is None or b.weight is None:
        assert a.weight is None and b.weight is None
    else:
        assert a.weight.tobytes() == b.weight.tobytes()


@pytest.mark.parametrize("num_parts", [1, 2, 3])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_crb_files_read_by_both(tmp_path, writer, num_parts):
    blocks = _blocks()
    path = str(tmp_path / "x.crb")
    w = j_crb.write_crb if writer == "jax" else t_crb.write_crb
    assert w(path, blocks) == len(blocks)
    for part in range(num_parts):
        got = list(t_crb.read_crb(path, part, num_parts))
        want = list(j_crb.read_crb(path, part, num_parts))
        assert len(got) == len(want) == len(blocks[part::num_parts])
        for g, j, b in zip(got, want, blocks[part::num_parts]):
            _same_rb(g, RowBlock(j.label, j.offset, j.index, j.value,
                                 j.weight))
            _same_rb(g, RowBlock(np.asarray(b.label, np.float32),
                                 np.asarray(b.offset, np.int64),
                                 np.asarray(b.index, np.uint64), b.value,
                                 b.weight))


@pytest.mark.parametrize("append", [False, True])
def test_crb_writers_write_the_same_bytes(tmp_path, append):
    blocks = _blocks()
    for name, w in (("jax", j_crb.write_crb), ("port", t_crb.write_crb)):
        path = str(tmp_path / f"{name}.crb")
        w(path, blocks[:2])
        w(path, blocks[2:], append=append)
    assert ((tmp_path / "jax.crb").read_bytes()
            == (tmp_path / "port.crb").read_bytes())
    n = len(list(t_crb.read_crb(str(tmp_path / "port.crb"))))
    assert n == (len(blocks) if append else len(blocks) - 2)


def test_crb_bad_magic_raises_in_both(tmp_path):
    path = tmp_path / "bad.crb"
    path.write_bytes(b"\0" * 64)
    for read in (t_crb.read_crb, j_crb.read_crb):
        with pytest.raises(ValueError, match="magic"):
            list(read(str(path)))


# --------------------------------------------------------- MinibatchIter
@pytest.fixture(scope="module")
def criteo_files(tmp_path_factory):
    """A Criteo TSV train file, a val file, an adfea file, a libsvm file,
    and the train file as crb (the JAX package's convert)."""
    from wormhole_tpu.apps import convert as j_convert

    d = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(8)
    files = {"train": d / "train.tsv", "val": d / "val.tsv",
             "adfea": d / "day.adfea", "libsvm": d / "train.libsvm"}
    files["train"].write_bytes(synth_criteo_tsv(rng, 1500))
    files["val"].write_bytes(synth_criteo_tsv(rng, 256))
    files["adfea"].write_bytes(synth_adfea_text(rng, 400))
    files["libsvm"].write_text(synth_libsvm_text(n_rows=600, seed=4))
    for name in ("train", "val"):
        assert j_convert.main([f"data_in={files[name]}", "format_in=criteo",
                               f"data_out={d}/{name}.crb",
                               "minibatch=256"]) == 0
        files[f"{name}_crb"] = d / f"{name}.crb"
    return {k: str(v) for k, v in files.items()}


@pytest.mark.parametrize("kw", [dict(minibatch_size=100),
                                dict(minibatch_size=256, part=1,
                                     num_parts=2),
                                dict(minibatch_size=64, shuf_buf=500,
                                     seed=3),
                                dict(minibatch_size=128, neg_sampling=0.5,
                                     seed=4)],
                         ids=["plain", "part", "shuffle", "negsample"])
def test_minibatch_iter_over_crb_matches_jax(criteo_files, kw):
    path = criteo_files["train_crb"]
    kw = dict(kw)
    part, num_parts = kw.pop("part", 0), kw.pop("num_parts", 1)
    got = list(TIter(path, part, num_parts, "crb", **kw))
    want = list(JIter(path, part, num_parts, "crb", **kw))
    assert len(got) == len(want) > 0
    for g, j in zip(got, want):
        same_block(g, j)
    if num_parts == 1 and "shuf_buf" not in kw and "neg_sampling" not in kw:
        text = list(TIter(criteo_files["train"], 0, 1, "criteo", **kw))
        assert len(text) == len(got)
        for g, t in zip(got, text):
            same_block(g, t)


# ---------------------------------------------------------------- convert
CONVERT = [("criteo", "crb", 0), ("criteo", "libsvm", 0),
           ("criteo", "libsvm", 1), ("criteo", "crb", 1),
           ("crb", "libsvm", 0), ("adfea", "crb", 0), ("adfea", "libsvm", 0),
           ("libsvm", "crb", 0), ("criteo_test", "libsvm", 0)]


@pytest.mark.parametrize("fmt_in,fmt_out,part_size", CONVERT)
def test_convert_matches_jax_convert(criteo_files, tmp_path, monkeypatch,
                                     fmt_in, fmt_out, part_size):
    from wormhole_tpu import native as j_native
    from wormhole_tpu.apps import convert as j_convert
    from wormhole_tpu_torch.apps import convert as t_convert

    if fmt_in == "adfea":  # the file's negative and wide fids: the JAX
        # package's native route saturates them, its Python parser is the
        # contract
        monkeypatch.setattr(j_native, "parse_text", lambda *a: None)
    src = criteo_files[{"criteo": "train", "criteo_test": "train",
                        "crb": "train_crb", "adfea": "adfea",
                        "libsvm": "libsvm"}[fmt_in]]
    # a part of 1 MB needs more than 1 MB out: the train file written
    # over and over (crb holds about half the text's bytes)
    if part_size:
        big = tmp_path / "big.tsv"
        big.write_bytes(open(src, "rb").read() * (4 if fmt_out == "libsvm"
                                                  else 12))
        src = str(big)
    outs = {}
    for name, app, extra in (("jax", j_convert, []),
                             ("port", t_convert, ["device=cpu"])):
        os.mkdir(tmp_path / name)
        out = tmp_path / name / "out"
        assert app.main([f"data_in={src}", f"format_in={fmt_in}",
                         f"data_out={out}", f"format_out={fmt_out}",
                         f"part_size={part_size}", "minibatch=300",
                         *extra]) == 0
        outs[name] = {p: (tmp_path / name / p).read_bytes()
                      for p in sorted(os.listdir(tmp_path / name))}
    assert outs["port"] == outs["jax"]
    if part_size:
        assert len(outs["port"]) >= 2


def test_convert_appends_to_an_existing_crb_as_jax_does(criteo_files,
                                                        tmp_path):
    """The JAX convert appends its crb output (roll() never truncates):
    converting twice into one path doubles its records. The port mirrors
    it."""
    from wormhole_tpu.apps import convert as j_convert
    from wormhole_tpu_torch.apps import convert as t_convert

    src = criteo_files["val"]
    for name, app, extra in (("jax", j_convert, []),
                             ("port", t_convert, ["device=cpu"])):
        for _ in range(2):
            assert app.main([f"data_in={src}", "format_in=criteo",
                             f"data_out={tmp_path}/{name}.crb",
                             "minibatch=100", *extra]) == 0
    port = (tmp_path / "port.crb").read_bytes()
    assert port == (tmp_path / "jax.crb").read_bytes()
    recs = list(t_crb.read_crb(str(tmp_path / "port.crb")))
    assert sum(r.size for r in recs) == 2 * 256


def test_convert_refuses_what_it_cannot_write(tmp_path):
    from wormhole_tpu_torch.apps import convert as t_convert

    with pytest.raises(ValueError, match="data_in"):
        t_convert.main(["data_out=x", "device=cpu"])
    with pytest.raises(ValueError, match="format_out"):
        t_convert.main([f"data_in={tmp_path}", "data_out=x",
                        "format_out=csv", "device=cpu"])
    with pytest.raises(FileNotFoundError):
        t_convert.main([f"data_in={tmp_path}/none", "data_out=x",
                        "device=cpu"])


# -------------------------------------------------------------- the apps
def _linear_conf(tmp_path, files, fmt, train, val):
    conf = tmp_path / f"{fmt}.conf"
    conf.write_text(f"""
train_data = "{files[train]}"
val_data = "{files[val]}"
data_format = {fmt}
algo = ftrl
lambda_l1 = 1
minibatch = 256
nnz_per_row = 39
num_buckets = {8 * TILE}
max_data_pass = 2
num_parts_per_file = 1
max_concurrency = 1
""")
    return str(conf)


def _run_app(app, conf, tmp_path, name, extra):
    from wormhole_tpu_torch.utils import checkpoint as t_ckpt

    assert app.main([conf, f"model_out={tmp_path}/{name}_model",
                     f"predict_out={tmp_path}/{name}_pred", *extra]) == 0
    return (np.loadtxt(f"{tmp_path}/{name}_pred_part-0"),
            t_ckpt.load_parts(f"{tmp_path}/{name}_model"))


def test_linear_app_trains_from_criteo_and_crb_as_jax(criteo_files,
                                                      tmp_path):
    from wormhole_tpu.apps import linear as j_app
    from wormhole_tpu_torch.apps import linear as t_app

    tsv = _linear_conf(tmp_path, criteo_files, "criteo", "train", "val")
    crb = _linear_conf(tmp_path, criteo_files, "crb", "train_crb",
                       "val_crb")
    pj, mj = _run_app(j_app, tsv, tmp_path, "jax", [])
    pt, mt = _run_app(t_app, tsv, tmp_path, "port", ["device=cpu"])
    pc, mc = _run_app(t_app, crb, tmp_path, "port_crb", ["device=cpu"])
    assert pt.shape == (256,) and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-4)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(mc[k], mt[k])
    np.testing.assert_array_equal(pc, pt)
    assert np.count_nonzero(mt["w"]) > 0


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_difacto_app_trains_from_criteo_and_crb_as_jax(criteo_files,
                                                       tmp_path, kernel):
    """Both apps from the same model_in, written by the JAX learner before
    any step (V's init draws from another generator in each package)."""
    from wormhole_tpu.apps import difacto as j_app
    from wormhole_tpu.models.difacto import DifactoConfig as JConfig
    from wormhole_tpu.models.difacto import DifactoLearner as JLearner
    from wormhole_tpu.parallel.mesh import make_mesh
    from wormhole_tpu.utils import checkpoint as j_ckpt
    from wormhole_tpu_torch.apps import difacto as t_app

    kw = dict(minibatch=256, num_buckets=2 * TILE, v_buckets=TILE,
              nnz_per_row=39, dim=4, threshold=2, lr_eta=0.3, V_lr_eta=0.1,
              kernel=kernel, kernel_dtype="f32")
    j_ckpt.save_model(JLearner(JConfig(**kw), make_mesh(1, 1)).ckpt_store,
                      str(tmp_path / "init"))
    confs = {}
    for fmt, train, val in (("criteo", "train", "val"),
                            ("crb", "train_crb", "val_crb")):
        confs[fmt] = tmp_path / f"{fmt}.conf"
        confs[fmt].write_text(
            f'train_data = "{criteo_files[train]}"\n'
            f'val_data = "{criteo_files[val]}"\n'
            f'model_in = "{tmp_path}/init"\ndata_format = {fmt}\n'
            + "".join(f"{k} = {v}\n" for k, v in kw.items())
            + "max_data_pass = 1\nnum_parts_per_file = 1\n"
              "max_concurrency = 1\n")
    pj, mj = _run_app(j_app, str(confs["criteo"]), tmp_path, "jax", [])
    pt, mt = _run_app(t_app, str(confs["criteo"]), tmp_path, "port",
                      ["device=cpu"])
    pc, mc = _run_app(t_app, str(confs["crb"]), tmp_path, "port_crb",
                      ["device=cpu"])
    assert pt.shape == (256,) and np.isfinite(pt).all()
    # margins of 39 fields: the FM term's difference of squares, summed in
    # another order, moves a margin near 0 by up to 2.2e-5 on the plain
    # (xla) path, where the tables stay inside the bar of
    # tests/test_torch_difacto.py
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-4)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"table {k}")
        np.testing.assert_array_equal(mc[k], mt[k])
    np.testing.assert_array_equal(pc, pt)
    assert int((mt["cnt"] >= 2).sum()) > 0


def _crb_of(path, tmp_path, name):
    from wormhole_tpu_torch.apps import convert as t_convert

    out = str(tmp_path / f"{name}.crb")
    assert t_convert.main([f"data_in={path}", "format_in=libsvm",
                           f"data_out={out}", "minibatch=128",
                           "device=cpu"]) == 0
    return out


def _model(path: str) -> dict:
    """A model file's arrays: an .npz's, or a text file's bytes."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    return {"text": open(path, "rb").read()}


def test_batch_and_gbdt_apps_train_from_crb_as_from_text(criteo_files,
                                                         tmp_path):
    """gbdt, kmeans, lbfgs_linear and lbfgs_fm read data_format=crb: a crb
    file of a libsvm file gives the same model as the text."""
    from wormhole_tpu_torch.apps import gbdt, kmeans, lbfgs_fm, lbfgs_linear

    svm = criteo_files["libsvm"]
    crb = _crb_of(svm, tmp_path, "train")
    runs = (
        (kmeans, ["num_clusters=3", "max_iter=3", "minibatch=128",
                  "nnz_per_row=16"], "data", ".txt"),
        (lbfgs_linear, ["max_lbfgs_iter=5", "reg_L2=0.1", "minibatch=128",
                        "nnz_per_row=16"], "data", ".npz"),
        (lbfgs_fm, ["max_lbfgs_iter=3", "nfactor=2", "minibatch=128",
                    "nnz_per_row=16"], "data", ".npz"),
        (gbdt, ["num_round=2", "max_depth=3", "minibatch=128"],
         "train_data", ".npz"),
    )
    for app, args, data_key, ext in runs:
        models = {}
        for fmt, path in (("libsvm", svm), ("crb", crb)):
            out = str(tmp_path / f"{app.__name__}-{fmt}{ext}")
            assert app.main([f"{data_key}={path}", f"data_format={fmt}",
                             *args, f"model_out={out}", "device=cpu"]) == 0
            models[fmt] = _model(out)
        assert models["crb"].keys() == models["libsvm"].keys()
        for k, v in models["libsvm"].items():
            np.testing.assert_array_equal(models["crb"][k], v,
                                          err_msg=app.__name__)


def test_hashed_formats_in_the_true_feature_space_learners(criteo_files):
    """k-means and L-BFGS use the true feature space, as the reference's
    do: the dimension a Criteo file gives is its largest key + 1, the one
    the JAX package discovers, and the L-BFGS objectives refuse ids of
    2^31 - 1 and up as the JAX ones do."""
    from wormhole_tpu.models.kmeans import discover_dim as j_discover
    from wormhole_tpu_torch.apps import lbfgs_linear
    from wormhole_tpu_torch.models.kmeans import discover_dim

    path = criteo_files["val"]
    want = int(t_parsers.parse_criteo(open(path).read()).index.max()) + 1
    assert discover_dim(path, "criteo") == want
    assert discover_dim(criteo_files["val_crb"], "crb") == want
    assert j_discover(path, "criteo") == want
    with pytest.raises(ValueError, match="2\\^31"):
        lbfgs_linear.main([f"data={path}", "data_format=criteo",
                           "device=cpu"])
