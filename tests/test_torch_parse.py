"""The port's libsvm parsing against the JAX package's, and the card
parser's rules on the CPU.

- The plain parser (wormhole_tpu_torch/data/parsers.py parse_libsvm, the
  card parser's contract) gives the JAX package's Python parser's bytes,
  and its parse_text's, on an edge corpus.
- parse_libsvm_mirror, csrc/parse.cu's tiled design in Python at a
  small tile (the masks of 32-byte groups, the warps' state maps, the
  scan of the tiles' maps, the walks from each warp's carry, the
  per-token grammar, the fast path and the exact path), gives the plain
  parser's bytes, on the corpus, on the tile-edge corpus at every shift,
  on chunks around whole numbers of tiles and on hypothesis-made lines;
  its number rules give float()'s double and int()'s key bit for bit,
  halfway cases included.
- Where the plain parser raises, so do the mirror and the JAX parsers.

The kernel itself meets the plain parser on the card
(tests/test_torch_cuda.py, marker cuda).
"""

import math
import struct
from decimal import Decimal, localcontext

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_cuda import (LIBSVM_EDGE, LIBSVM_EDGE_EXACT, LIBSVM_ERRORS,
                             same_block, sized_text)
from wormhole_tpu.data import parsers as j_parsers
from wormhole_tpu_torch.data import parsers as t_parsers
from wormhole_tpu_torch.data.minibatch import MinibatchIter
from wormhole_tpu_torch.data.rowblock import RowBlock
from wormhole_tpu_torch.data.synth import tile_edge_text

# ------------------------------------- csrc/parse.cu's rules, mirrored
BAD, FAST, EXACT = 0, 1, 2
_POW10 = [float(10 ** k) for k in range(23)]  # exact doubles
_TWO53 = 1 << 53
_EXP_CAP = 100_000_000
_DEC_CAP, _MAX_SHIFT = 800, 60
_POWTAB = (1, 3, 6, 9, 13, 16, 19, 23, 26)


def _digit(c):
    return 48 <= c <= 57


def digit_run_end(p: bytes, i: int) -> int:
    """parse.cu digit_run_end: digits with single '_' between them."""
    n = len(p)
    if i >= n or not _digit(p[i]):
        return i
    while True:
        i += 1
        if i < n and p[i] == ord("_"):
            if i + 1 >= n or not _digit(p[i + 1]):
                return -1
            i += 1
        elif i >= n or not _digit(p[i]):
            return i


class Dec:
    """parse.cu Decimal: 0.d[0..nd) * 10^dp, with the trunc flag."""

    def __init__(self):
        self.d, self.nd, self.dp, self.trunc = [0] * (_DEC_CAP + 1), 0, 0, False

    def trim(self):
        while self.nd > 0 and self.d[self.nd - 1] == 0:
            self.nd -= 1
        if self.nd == 0:
            self.dp = 0

    def right_shift(self, k):
        r = w = n = 0
        while n >> k == 0:
            if r >= self.nd:
                if n == 0:
                    self.nd = 0
                    return
                while n >> k == 0:
                    n, r = n * 10, r + 1
                break
            n, r = n * 10 + self.d[r], r + 1
        self.dp -= r - 1
        mask = (1 << k) - 1
        while r < self.nd:
            self.d[w], w = n >> k, w + 1
            n, r = (n & mask) * 10 + self.d[r], r + 1
        while n > 0:
            dig, n = n >> k, n & mask
            if w < _DEC_CAP:
                self.d[w], w = dig, w + 1
            elif dig > 0:
                self.trunc = True
            n *= 10
        self.nd = w
        self.trim()

    def left_shift(self, k):
        D = len(str(1 << k))
        w, n, r = self.nd + D, 0, self.nd - 1
        while r >= 0 or n > 0:
            if r >= 0:
                n += self.d[r] << k
            quo, rem = divmod(n, 10)
            w -= 1
            if w <= _DEC_CAP:
                self.d[w] = rem
            elif rem:
                self.trunc = True
            n, r = quo, r - 1
        nd = self.nd + D - w
        if w == 1:
            top = min(nd, _DEC_CAP)
            self.d[:top] = self.d[1:top + 1]
        elif nd > _DEC_CAP and self.d[_DEC_CAP]:
            self.trunc = True
        self.dp += nd - self.nd
        self.nd = min(nd, _DEC_CAP)
        self.trim()

    def shift(self, k):
        if self.nd == 0:
            return
        while k > _MAX_SHIFT:
            self.left_shift(_MAX_SHIFT)
            k -= _MAX_SHIFT
        while k < -_MAX_SHIFT:
            self.right_shift(_MAX_SHIFT)
            k += _MAX_SHIFT
        if k > 0:
            self.left_shift(k)
        if k < 0:
            self.right_shift(-k)

    def round_up(self, nd):
        if nd < 0 or nd >= self.nd:
            return False
        if self.d[nd] == 5 and nd + 1 == self.nd:
            return self.trunc or (nd > 0 and self.d[nd - 1] % 2 == 1)
        return self.d[nd] >= 5

    def rounded_integer(self):
        if self.dp > 20:
            return (1 << 64) - 1
        n = 0
        for i in range(self.dp):
            n = n * 10 + (self.d[i] if i < self.nd else 0)
        return n + self.round_up(self.dp)

    def to_double_bits(self):
        mant_bits, bias, exp_max = 52, -1023, (1 << 11) - 1
        inf = exp_max << mant_bits
        if self.nd == 0 or self.dp < -330:
            return 0
        if self.dp > 310:
            return inf
        exp = 0
        while self.dp > 0:
            n = 27 if self.dp >= 9 else _POWTAB[self.dp]
            self.shift(-n)
            exp += n
        while self.dp < 0 or (self.dp == 0 and self.d[0] < 5):
            n = 27 if -self.dp >= 9 else _POWTAB[-self.dp]
            self.shift(n)
            exp -= n
        exp -= 1
        if exp < bias + 1:
            n = bias + 1 - exp
            self.shift(-n)
            exp += n
        if exp - bias >= exp_max:
            return inf
        self.shift(1 + mant_bits)
        mant = self.rounded_integer()
        if mant == 2 << mant_bits:
            mant, exp = mant >> 1, exp + 1
            if exp - bias >= exp_max:
                return inf
        if not mant & (1 << mant_bits):
            exp = bias
        return (mant & ((1 << mant_bits) - 1)) | (((exp - bias) & exp_max)
                                                  << mant_bits)


def exact_decimal(p: bytes) -> float:
    """parse.cu exact_decimal: a grammar-checked unsigned decimal."""
    a, point, seen, i = Dec(), False, 0, 0
    while i < len(p):
        c = p[i]
        if c == ord("_"):
            i += 1
            continue
        if c == ord("."):
            point, a.dp, i = True, seen, i + 1
            continue
        if not _digit(c):
            break
        if c == ord("0") and a.nd == 0:
            a.dp -= 1
        else:
            seen += 1
            if a.nd < _DEC_CAP:
                a.d[a.nd], a.nd = c - 48, a.nd + 1
            elif c != ord("0"):
                a.trunc = True
        i += 1
    if not point:
        a.dp = seen
    if i < len(p):
        i += 1
        sign = 1
        if p[i] in b"+-":
            sign, i = (-1 if p[i] == ord("-") else 1), i + 1
        e = 0
        for c in p[i:]:
            if c != ord("_") and e < _EXP_CAP:
                e = e * 10 + c - 48
        a.dp += sign * e
    return struct.unpack("<d", struct.pack("<Q", a.to_double_bits()))[0]


def _f32_bits(x: float) -> int:
    with np.errstate(over="ignore"):
        return int(np.float32(x).view(np.uint32))


def parse_float(p: bytes):
    """parse.cu parse_float: (BAD | FAST | EXACT, double, f32 bits)."""
    i, neg = 0, False
    if p[:1] in (b"+", b"-"):
        neg, i = p[0] == ord("-"), 1
    word = p[i:].lower()
    sign32 = 0x80000000 if neg else 0
    if word in (b"inf", b"infinity"):
        return FAST, -math.inf if neg else math.inf, sign32 | 0x7F800000
    if word == b"nan":
        return FAST, math.nan, sign32 | 0x7FC00000
    int_end = digit_run_end(p, i)
    if int_end < 0:
        return BAD, None, None
    frac_beg = frac_end = int_end
    if p[int_end:int_end + 1] == b".":
        frac_beg = int_end + 1
        frac_end = digit_run_end(p, frac_beg)
        if frac_end < 0:
            return BAD, None, None
    if int_end == i and frac_end == frac_beg:
        return BAD, None, None
    j, e = frac_end, 0
    if p[j:j + 1] in (b"e", b"E"):
        j += 1
        eneg = p[j:j + 1] == b"-"
        if p[j:j + 1] in (b"+", b"-"):
            j += 1
        e_end = digit_run_end(p, j)
        if e_end <= j:
            return BAD, None, None
        for c in p[j:e_end]:
            if c != ord("_") and e < _EXP_CAP:
                e = e * 10 + c - 48
        j, e = e_end, -e if eneg else e
    if j != len(p):
        return BAD, None, None
    m = zeros = frac = 0
    fits = True
    for k in range(i, frac_end):
        c = p[k]
        if not fits:
            break
        if c in b"_.":
            continue
        frac += k >= frac_beg
        if c == ord("0"):
            zeros += m != 0
            continue
        z = 0
        while z <= zeros and fits:
            fits, m, z = m < _TWO53, m * 10, z + 1
        zeros, m = 0, m + c - 48
    e10 = e - frac + zeros
    if fits and m == 0:
        return FAST, -0.0 if neg else 0.0, sign32
    while fits and e10 > 22 and m * 10 < _TWO53:
        m, e10 = m * 10, e10 - 1
    if fits and m < _TWO53 and -22 <= e10 <= 22:
        r = float(m) * _POW10[e10] if e10 >= 0 else float(m) / _POW10[-e10]
        r = -r if neg else r
        return FAST, r, _f32_bits(r)
    r = exact_decimal(p[i:])
    r = -r if neg else r
    return EXACT, r, _f32_bits(r)


def parse_key(p: bytes):
    """parse.cu parse_key: an int() key in [0, 2^64), or None."""
    i, neg = 0, False
    if p[:1] in (b"+", b"-"):
        neg, i = p[0] == ord("-"), 1
    end = digit_run_end(p, i)
    if end != len(p) or end == i:
        return None
    k = int(p[i:].replace(b"_", b""))
    return None if k >= 1 << 64 or (neg and k) else k


_SEP = b" \t\r\n"
# csrc/parse.cu's tiles: kTile bytes a CTA, kTile / 32 / warps groups of
# 32 bytes a warp, kHalo bytes loaded past a tile. The mirror takes them
# small (a 64-byte tile of two one-group warps, a 32-byte halo), so that
# short texts cross many tile edges and long tokens run past the halo.
CARD_TILE, CARD_WARPS, CARD_HALO = 16384, 16, 256
NOHEAD, KEPT, COMMENT, UNKNOWN = range(4)
_M32 = 0xFFFFFFFF


def _ffs(x: int) -> int:
    return (x & -x).bit_length()  # __ffs: 1 + the lowest set bit, 0 for 0


def _top(x: int) -> int:
    return x.bit_length() - 1     # 31 - __clz


# parse.cu Agg: (tok, pre, fh, has_nl, lines, rows, feats, exit)
_IDENTITY = (0, 0, 0, 0, 0, 0, 0, UNKNOWN)


def _apply(a, s):
    """parse.cu apply: (lines, rows, feats, state after) from state s."""
    _, pre, fh, has_nl, lines, rows, feats, ex = a
    if pre > 0:
        if s == NOHEAD:
            lines += 1
            if not fh:
                rows, feats = rows + 1, feats + pre - 1
            s = COMMENT if fh else KEPT
        elif s == KEPT:
            feats += pre
    return lines, rows, feats, ex if has_nl else s


def _compose(a, b):
    """parse.cu compose: a then b."""
    if a[3]:
        lines, rows, feats, ex = _apply(b, a[7])
        return (a[0] + b[0], a[1], a[2], 1, a[4] + lines, a[5] + rows,
                a[6] + feats, ex)
    return (a[0] + b[0], a[1] + b[1], a[2] if a[1] else b[2], b[3], b[4],
            b[5], b[6], b[7])


class _Tile:
    """A tile as parse.cu's load_tile leaves it in shared memory: its
    bytes with the halo (spaces outside the chunk), each group's masks,
    and its first byte outside the alphabet."""

    def __init__(self, raw: bytes, t0: int, tile: int, halo: int):
        n = len(raw)
        self.t0, self.tile, self.halo = t0, tile, halo
        self.buf = bytes(raw[t0 + i] if 0 <= t0 + i < n else 32
                         for i in range(-1, tile + halo))
        self.sep, self.nl, self.hash = [], [], []
        for g in range((tile + halo) // 32):
            grp = self.buf[1 + 32 * g:33 + 32 * g]
            self.sep.append(sum((c in _SEP) << i for i, c in enumerate(grp)))
            self.nl.append(sum((c in b"\r\n") << i
                               for i, c in enumerate(grp)))
            self.hash.append(sum((c == 35) << i for i, c in enumerate(grp)))
        self.err = next((t0 + i for i in range(min(tile, n - t0))
                         if not (0x20 <= raw[t0 + i] <= 0x7E
                                 or raw[t0 + i] in b"\t\r\n")), None)

    def starts(self, g: int) -> int:
        sep = self.sep[g]
        before = self.sep[g - 1] >> 31 if g else int(self.buf[0] in _SEP)
        return ~sep & ((sep << 1) | before) & _M32

    def walk(self, g: int, e: int):
        """parse.cu walk_group: (start, head, row, feat, exit), in mask
        arithmetic (32-bit): carries from the byte after each line break
        (and byte 0 where no token came yet) ripple over the gaps between
        events onto the heads; a comment runs from a '#' head to the next
        line break."""
        S, NL, HM = self.starts(g), self.nl[g], self.hash[g]
        before_nl = (1 << (_ffs(NL) - 1)) - 1 if NL else _M32
        head = ((~(S | NL) & _M32) + (((NL << 1) | (e == NOHEAD)) & _M32)
                & _M32) & S
        not_nl = ~NL & _M32
        comment = (((not_nl + (head & HM)) & _M32) ^ not_nl) & not_nl
        if e == COMMENT:
            comment |= before_nl
        feat = S & ~head & ~comment & _M32
        if e == UNKNOWN:
            feat &= ~before_nl
        if NL:
            after = S & ~((2 << _top(NL)) - 1) & _M32
            ex = (NOHEAD if not after else
                  COMMENT if HM >> (_ffs(after) - 1) & 1 else KEPT)
        elif e == NOHEAD and S:
            ex = COMMENT if HM >> (_ffs(S) - 1) & 1 else KEPT
        else:
            ex = e
        return S, head, head & ~HM & _M32, feat, ex

    def group_agg(self, g: int):
        S, head, row, feat, ex = self.walk(g, UNKNOWN)
        NL = self.nl[g]
        pre = S & ((1 << (_ffs(NL) - 1)) - 1) if NL else S
        fh = self.hash[g] >> (_ffs(pre) - 1) & 1 if pre else 0
        return (S.bit_count(), pre.bit_count(), fh, int(NL != 0),
                head.bit_count(), row.bit_count(), feat.bit_count(), ex)

    def region_aggs(self, warps: int):
        per = self.tile // 32 // warps
        out = []
        for w in range(warps):
            a = _IDENTITY
            for k in range(per):
                a = _compose(a, self.group_agg(w * per + k))
            out.append(a)
        return out

    def token(self, raw: bytes, p: int) -> bytes:
        """parse.cu token_end: the token at tile offset p, its end from
        the separator masks, read on from the chunk past the halo."""
        g, m = p >> 5, self.sep[p >> 5] & (_M32 << (p & 31)) & _M32
        while m == 0 and g + 1 < len(self.sep):
            g += 1
            m = self.sep[g]
        if m:
            return self.buf[1 + p:1 + 32 * g + _ffs(m) - 1]
        end = self.t0 + self.tile + self.halo
        while end < len(raw) and raw[end] not in _SEP:
            end += 1
        return raw[self.t0 + p:end]


def _scan(aggs, threads: int):
    """parse.cu parse_scan_kernel: runs of tiles a thread, each run
    composed, the runs scanned in a tree (a Hillis-Steele step a
    shuffle), then each tile's carry (state, rows, features before it)
    and the chunk's (tokens, lines, rows, features)."""
    per = -(-len(aggs) // threads)
    runs = []
    for t in range(threads):
        a = _IDENTITY
        for x in aggs[t * per:(t + 1) * per]:
            a = _compose(a, x)
        runs.append(a)
    incl, o = list(runs), 1
    while o < threads:
        incl = [_compose(incl[i - o], incl[i]) if i >= o else incl[i]
                for i in range(threads)]
        o *= 2
    carry = []
    for t in range(threads):
        before = incl[t - 1] if t else _IDENTITY
        lines, rows, feats, state = _apply(before, NOHEAD)
        tok = before[0]
        for x in aggs[t * per:(t + 1) * per]:
            carry.append((state, rows, feats))
            lines_x, rows_x, feats_x, state = _apply(x, state)
            lines, rows, feats, tok = (lines + lines_x, rows + rows_x,
                                       feats + feats_x, tok + x[0])
    return carry, (tok, lines, rows, feats)


def parse_libsvm_mirror(data, tile: int = 64, warps: int = 2,
                        halo: int = 32, threads: int = 4):
    """csrc/parse.cu's design in Python, step for step at a small tile:
    each tile's masks and its warps' state maps of their regions, and the
    tile's (count pass), the scan of the tiles' maps, then each warp
    walking its groups from its carry (the tile's, then the regions'
    before it), the heads' offsets and the slots of the queued tokens,
    each converted with the per-token rules. Returns the RowBlock and the
    number of decimals the exact path converted; raises ValueError where
    the kernel's wrapper raises."""
    raw = data.encode() if isinstance(data, str) else bytes(data)
    n = len(raw)
    assert tile % (32 * warps) == 0 and halo % 32 == 0
    tiles = [_Tile(raw, t0, tile, halo) for t0 in range(0, n, tile)]
    errs = [t.err for t in tiles if t.err is not None]
    if errs:
        raise ValueError(f"libsvm chunk: byte {min(errs)} is outside the "
                         f"alphabet")
    # 1. count: each warp's map of its region, and the tile's (its warps'
    # composed in order)
    raggs = [t.region_aggs(warps) for t in tiles]
    aggs = []
    for ra in raggs:
        a = _IDENTITY
        for x in ra:
            a = _compose(a, x)
        aggs.append(a)
    # 2. scan: each tile's carry
    carry, (T, _, R, F) = _scan(aggs, threads) if tiles else ([], (0,) * 4)
    # 3. emit
    label = np.zeros(R, np.uint32)
    offset = np.zeros(R + 1, np.int64)
    index = np.zeros(F, np.uint64)
    value = np.zeros(F, np.uint32)
    offset[R] = F
    ne1, n_exact, bad = False, 0, []
    per = tile // 32 // warps
    for t, ra, (state, rows, feats) in zip(tiles, raggs, carry):
        starts = []  # each warp's carry: the tile's, then its regions
        for a in ra:
            starts.append((state, rows, feats))
            _, dr, df, state = _apply(a, state)
            rows, feats = rows + dr, feats + df
        queued = []
        for w, (state, rows, feats) in enumerate(starts):
            for g in range(w * per, (w + 1) * per):
                _, _, row_m, feat_m, ex = t.walk(g, state)
                for lane in range(32):
                    lt = (1 << lane) - 1
                    slot_r = rows + (row_m & lt).bit_count()
                    slot_f = feats + (feat_m & lt).bit_count()
                    if row_m >> lane & 1:
                        offset[slot_r] = slot_f  # a head is no feature
                        queued.append((32 * g + lane, True, slot_r))
                    elif feat_m >> lane & 1:
                        queued.append((32 * g + lane, False, slot_f))
                rows += row_m.bit_count()
                feats += feat_m.bit_count()
                state = ex
        for p, is_label, slot in queued:
            tok = t.token(raw, p)
            if is_label:
                conv, _, f32 = parse_float(tok)
                if conv != BAD:
                    label[slot] = f32
            else:
                k, colon, vtok = tok.partition(b":")
                key = parse_key(k)
                conv, v, f32 = (BAD, None, None) if key is None else (
                    parse_float(vtok) if colon else (FAST, 1.0, 0x3F800000))
                if conv != BAD:
                    index[slot], value[slot] = key, f32
                    ne1 = ne1 or v != 1.0
            if conv == BAD:
                bad.append(t.t0 + p)
            n_exact += conv == EXACT
    if bad:
        beg = min(bad)
        end = beg
        while end < n and raw[end] not in _SEP:
            end += 1
        raise ValueError(f"libsvm chunk: token {raw[beg:end]!r} at byte "
                         f"{beg} ({len(bad)} such tokens)")
    assert T == sum(len(raw[a:b].split()) for a, b in _line_spans(raw))
    block = RowBlock(label=label.view(np.float32), offset=offset,
                     index=index, value=value.view(np.float32) if ne1
                     else None)
    return block, n_exact


def _line_spans(raw: bytes):
    """(start, end) of each line (at '\\r' or '\\n')."""
    a = 0
    for i, c in enumerate(raw):
        if c in b"\r\n":
            yield a, i
            a = i + 1
    yield a, len(raw)


@pytest.mark.parametrize("name", sorted(LIBSVM_EDGE))
def test_plain_parser_matches_jax(name):
    text = LIBSVM_EDGE[name]
    got = t_parsers.parse_libsvm(text)
    same_block(got, j_parsers.parse_libsvm(text))
    same_block(t_parsers.parse_text(text, "libsvm"), got)
    same_block(t_parsers.parse_text(text, "libsvm", "cpu"), got)
    if name not in ("outside-fast-path", "underscores-words"):
        # the JAX package's parse_text takes its native C++ parser where
        # it is built (strtof, C isspace), which refuses '1_0' (float()
        # takes it); elsewhere it agrees
        same_block(j_parsers.parse_text(text, "libsvm"), got)


@pytest.mark.parametrize("name", sorted(LIBSVM_EDGE))
def test_mirror_matches_plain(name):
    text = LIBSVM_EDGE[name]
    got, n_exact = parse_libsvm_mirror(text)
    same_block(got, t_parsers.parse_libsvm(text))
    assert n_exact == LIBSVM_EDGE_EXACT.get(name, 0)
    same_block(parse_libsvm_mirror(text.encode())[0], got)


@pytest.mark.parametrize("name", sorted(LIBSVM_ERRORS))
def test_error_cases_raise_in_both(name):
    text = LIBSVM_ERRORS[name]
    for parse in (t_parsers.parse_libsvm, j_parsers.parse_libsvm):
        with pytest.raises((ValueError, OverflowError)):
            parse(text)
    with pytest.raises(ValueError):
        parse_libsvm_mirror(text)


@pytest.mark.parametrize("byte", [0x0B, 0x0C, 0x1C, 0x1F, 0x7F, 0xC3])
def test_bytes_outside_the_alphabet_raise_with_their_offset(byte):
    """\\v, \\f and \\x1c split lines for str.splitlines(); the card's
    parser takes none of them, nor DEL or a non-ASCII byte."""
    raw = b"1 3:1\n0 4" + bytes([byte]) + b"5:1\n"
    with pytest.raises(ValueError, match=r"byte 9 "):
        parse_libsvm_mirror(raw)


def test_parse_text_refuses_other_formats():
    """An unknown format raises on each device, before any parse (crb is
    a file format: data/minibatch.py reads it, parse_text does not)."""
    for fmt in ("svmlight", "crb", ""):
        for dev in (None, "cpu", "cuda"):
            with pytest.raises(ValueError, match="unknown data format"):
                t_parsers.parse_text("1 2\n", fmt, dev)


def _bench_chunk(kind: str, rows: int = 300) -> str:
    """chip_smoke.py's three parse chunks, cut to a few rows: Criteo keys
    (binary), the same with k:v values, HIGGS rows of %.5f values."""
    rng = np.random.default_rng(11)
    if kind == "higgs":
        X = rng.normal(size=(rows, 28))
        return "".join(f"{r % 2} " + " ".join(
            f"{f}:{X[r, f]:.5f}" for f in range(28)) + "\n"
            for r in range(rows))
    keys = rng.integers(0, 1 << 26, size=(rows, 39))
    vals = rng.integers(1, 100000, size=keys.shape) / 1000
    return "".join(f"{r % 2} " + " ".join(
        f"{k}:{v:.3f}" if kind == "values" else str(k)
        for k, v in zip(keys[r], vals[r])) + "\n" for r in range(rows))


@pytest.mark.parametrize("kind", ["binary", "values", "higgs"])
def test_bench_chunks_take_the_fast_path(kind):
    text = _bench_chunk(kind)
    got, n_exact = parse_libsvm_mirror(text)
    same_block(got, t_parsers.parse_libsvm(text))
    assert n_exact == 0
    assert (got.value is None) == (kind == "binary")


# -------------------------------------------- hypothesis: the token rules
_DECIMAL = st.from_regex(
    r"[+-]?[0-9]{0,24}(\.[0-9]{0,24})?([eE][+-]?[0-9]{1,4})?",
    fullmatch=True)
_NUMBER = st.one_of(
    _DECIMAL,
    st.integers(-10**6, 10**6).map(str),
    st.floats(allow_nan=True, allow_infinity=True).map(repr),
    st.floats(-1e6, 1e6).map(lambda x: f"{x:.5f}"),
    st.floats(allow_nan=False, allow_infinity=False).map(
        lambda x: f"{x:.17g}"),
    st.from_regex(r"[+-]?[0-9_]{0,6}(\.[0-9_]{0,4})?([eE][+-]?[0-9_]{0,3})?",
                  fullmatch=True),
    st.sampled_from(["inf", "-nan", "1_0", "Infinity", "", ".", "1e", "0x10",
                     "1.0", "1", "1e0", "+1", "NaN", "-iNf", "infinit",
                     "1__0", "_1", "1_", "1._5", "1e_1", "1e400", "-1e-400",
                     "0e999"]))
_KEY = st.one_of(
    st.integers(0, 2**64 - 1).map(str),
    st.integers(-3, 2**64 + 3).map(str),
    st.from_regex(r"[+-]?[0-9_]{0,8}", fullmatch=True),
    st.sampled_from(["007", "+5", "-0", "1_000", "", "x", "1.5", "-0_0",
                     "1__0", "18446744073709551616"]))
_TOKEN = st.one_of(_KEY, st.tuples(_KEY, _NUMBER).map(":".join))
_BLANK = st.sampled_from([" ", "\t", "  ", " \t "])
_LINE = st.one_of(
    st.tuples(st.sampled_from(["", " ", "\t"]), _NUMBER,
              st.lists(st.tuples(_BLANK, _TOKEN).map("".join), max_size=6),
              st.sampled_from(["", " ", "\t"])).map(
        lambda t: t[0] + t[1] + "".join(t[2]) + t[3]),
    st.sampled_from(["", "#", "# 1 2:3", "  #x y", "   "]))


def _outcome(parse, text):
    try:
        return parse(text)
    except (ValueError, OverflowError):
        return None


@settings(max_examples=300, deadline=None)
@given(lines=st.lists(_LINE, max_size=8),
       newline=st.sampled_from(["\n", "\r\n", "\r"]),
       final=st.booleans())
def test_mirror_matches_plain_on_generated_lines(lines, newline, final):
    text = newline.join(lines) + (newline if final and lines else "")
    want = _outcome(t_parsers.parse_libsvm, text)
    got = _outcome(parse_libsvm_mirror, text)
    assert (want is None) == (got is None), text
    if want is not None:
        same_block(got[0], want)


def _same_float(tok: str) -> None:
    """parse_float(tok) is float(tok) and its f32 np.float32's, bit for
    bit; BAD exactly where float() raises."""
    try:
        want = float(tok)
    except ValueError:
        assert parse_float(tok.encode())[0] == BAD, tok
        return
    conv, got, f32 = parse_float(tok.encode())
    assert conv != BAD, tok
    if math.isnan(want):
        assert math.isnan(got)
        want32 = _f32_bits(-math.nan if tok.startswith("-") else math.nan)
    else:
        assert struct.pack("<d", got) == struct.pack("<d", want), tok
        want32 = _f32_bits(want)
    assert f32 == want32, tok


@settings(max_examples=500, deadline=None)
@given(tok=_DECIMAL)
def test_fast_decimal_is_float_bit_for_bit(tok):
    """Decimals of up to 48 digits and 4-digit exponents, through the
    fast path or the exact one."""
    _same_float(tok)


@settings(max_examples=300, deadline=None)
@given(x=st.floats(-1e15, 1e15), digits=st.integers(0, 6))
def test_fixed_point_decimals_take_the_fast_path(x, digits):
    """%.Nf text with at most 15 significant digits has a significand
    below 2^53 and |e| <= 6: the fast path converts it, to float()'s
    double."""
    tok = f"{x:.{digits}f}"
    sig = len(tok.lstrip("+-").replace(".", "").lstrip("0"))
    conv = parse_float(tok.encode())[0]
    if sig <= 15:
        assert conv == FAST
    _same_float(tok)


@settings(max_examples=300, deadline=None)
@given(x=st.floats(allow_nan=False), fmt=st.sampled_from(
    ["r", ".17g", ".16g", ".20e", ".30e"]))
def test_exact_path_is_float_bit_for_bit(x, fmt):
    """Every double's repr and its %.17g, %.16g (what sklearn's
    dump_svmlight_file writes) and long %e texts, subnormals and the
    largest doubles among them."""
    _same_float(repr(x) if fmt == "r" else format(x, fmt))


def _midpoint(bits: int) -> Decimal:
    """The exact decimal halfway between a positive double and the next."""
    x = struct.unpack("<d", struct.pack("<Q", bits))[0]
    with localcontext() as ctx:
        ctx.prec = 2000
        return (Decimal(x) + Decimal(math.nextafter(x, math.inf))) / 2


@settings(max_examples=150, deadline=None)
@given(bits=st.integers(1, 0x7FEFFFFFFFFFFFFE),
       tail=st.sampled_from(["", "1", "0" * 900 + "1", "0" * 900]))
def test_halfway_cases_round_to_even(bits, tail):
    """A decimal exactly halfway between two doubles goes to the even
    one; a nonzero digit after it, even past the exact path's 800 kept
    digits, goes up."""
    mant, exp = format(_midpoint(bits).normalize(), "e").split("e")
    if "." not in mant:
        mant += "."
    _same_float(f"{mant}{tail}e{exp}")


@pytest.mark.parametrize("tok", [
    "1e23", "8.98846567431158e307", "1.7976931348623157e308",
    "1.7976931348623158e308", "1.7976931348623159e308", "2e308",
    "2.2250738585072011e-308", "2.2250738585072012e-308",
    "4.9406564584124654e-324", "2.4703282292062327e-324",
    "2.4703282292062328e-324", "1e-400", "9007199254740993",
    "0.30000000000000004", "0.1e-22", "1" * 30, "0." + "0" * 1000 + "1e1001",
    "1" + "0" * 900 + "e-900", "00000.00000e00000", "1e0000000000000000005",
    "1e999999999999", "1e-999999999999", "0e999999999999", "1_0.5_5e1_0",
    "1__0", "_1", "1_", "1._5", "5_.5", "1.5_", "1e_1", "1e+_1", "1e", ".",
    ".e5", "e5", "+.5", "-.5e-3", "1.", ".5", "inf", "-INF", "Infinity",
    "-iNfInItY", "nan", "-nan", "+NaN", "infinit", "nan(1)", "0x10", "1e5.5",
    "", "+", "-", "-0", "+0", "1:2"])
def test_number_grammar_is_float(tok):
    _same_float(tok)


@settings(max_examples=300, deadline=None)
@given(tok=_KEY)
def test_keys_are_int_in_uint64(tok):
    try:
        want = int(tok)
        want = want if 0 <= want < 1 << 64 else None
    except ValueError:
        want = None
    assert parse_key(tok.encode()) == want


def test_minibatch_iter_parses_on_the_named_device(tmp_path):
    """MinibatchIter and parse_text pass the device down: device "cpu"
    is the plain parser, and gives the same batches as no device."""
    path = tmp_path / "d.libsvm"
    path.write_text(_bench_chunk("values", rows=500))
    a = list(MinibatchIter(str(path), minibatch_size=128))
    b = list(MinibatchIter(str(path), minibatch_size=128, device="cpu"))
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        same_block(x, y)


@pytest.mark.parametrize("final_newline", [True, False])
@pytest.mark.parametrize("chunk_bytes", [1, 7, 64, 1000, 1 << 24])
@pytest.mark.parametrize("num_parts", [1, 3, 7])
def test_file_chunks_match_jax(tmp_path, num_parts, chunk_bytes,
                               final_newline):
    """The port reads a part a block at a time; its chunks are the JAX
    package's line-by-line chunks, byte for byte, part by part (lines of
    every length, one longer than the small chunk sizes, and lines that
    end exactly on a chunk size)."""
    rng = np.random.default_rng(chunk_bytes + num_parts)
    lines = [" ".join(str(k) for k in rng.integers(0, 999, size=n))
             for n in rng.integers(0, 30, size=200)]
    lines[5] = "1 " + "2" * 62  # 64 bytes with its newline
    text = "\n".join(lines) + ("\n" if final_newline else "")
    path = tmp_path / "d.libsvm"
    path.write_text(text)
    got, want = [], []
    for part in range(num_parts):
        got += [list(t_parsers.iter_file_chunks(str(path), part, num_parts,
                                                chunk_bytes))]
        want += [list(j_parsers.iter_file_chunks(str(path), part, num_parts,
                                                 chunk_bytes))]
    assert got == want
    assert "".join("".join(c) for c in got) == text


# ----------------------------------------- the tiled design, at tile edges
_TILINGS = [(64, 2, 32), (128, 2, 32), (256, 4, 64)]


@pytest.mark.parametrize("tiling", _TILINGS, ids=lambda t: "-".join(map(str, t)))
@pytest.mark.parametrize("shift", range(0, 66))
def test_mirror_tile_edge_corpus(shift, tiling):
    """Every seam of the tile-edge corpus (comment lines, "\\r\\n" and empty
    lines, labels, k:v tokens, bare keys, blanks, a long decimal past the
    halo, no final line break) across a tile edge: the plain parser's
    bytes, at the mirror's tile sizes."""
    tile, warps, halo = tiling
    text = tile_edge_text("libsvm", tile, shift % tile)
    got, n_exact = parse_libsvm_mirror(text, tile, warps, halo)
    same_block(got, t_parsers.parse_libsvm(text))
    assert n_exact == 1


@pytest.mark.parametrize("final_newline", [True, False])
@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_mirror_chunks_of_whole_tiles(k, delta, final_newline):
    """Chunks of exactly k tiles and k tiles +- 1 byte."""
    text = sized_text(64 * k + delta, final_newline)
    got, _ = parse_libsvm_mirror(text)
    same_block(got, t_parsers.parse_libsvm(text))
    assert got.size == t_parsers.parse_libsvm(text).size


@pytest.mark.parametrize("size", [1, 2, 17, 63])
def test_mirror_chunk_under_one_tile(size):
    text = sized_text(size, size > 1)
    same_block(parse_libsvm_mirror(text)[0], t_parsers.parse_libsvm(text))


@pytest.mark.parametrize("kind", ["binary", "values", "higgs"])
def test_mirror_at_the_card_tile(kind):
    """The mirror at the kernel's own tiling (16,384-byte tiles of 16
    warps, a 256-byte halo) over the bench chunks."""
    text = _bench_chunk(kind, rows=600)
    got, n_exact = parse_libsvm_mirror(text, CARD_TILE, CARD_WARPS,
                                       CARD_HALO, threads=1024)
    same_block(got, t_parsers.parse_libsvm(text))
    assert n_exact == 0 and len(text) > 2 * CARD_TILE


def test_mirror_scan_groups_tiles_in_any_runs():
    """The scan composes the tiles' maps in runs of any length (the
    composition is associative): 1, 3, 4 and 1024 threads agree."""
    text = (tile_edge_text("libsvm", 64, 7) + "\n"
            + LIBSVM_EDGE["comments-blank"])
    want = t_parsers.parse_libsvm(text)
    for threads in (1, 3, 4, 1024):
        same_block(parse_libsvm_mirror(text, threads=threads)[0], want)


@settings(max_examples=150, deadline=None)
@given(lines=st.lists(_LINE, max_size=10),
       newline=st.sampled_from(["\n", "\r\n", "\r"]),
       final=st.booleans(), lead=st.integers(0, 70))
def test_mirror_matches_plain_on_generated_lines_at_any_offset(
        lines, newline, final, lead):
    """hypothesis lines after a comment line of `lead` bytes, so that
    their seams land anywhere in a 64-byte tile."""
    text = ("#" + "x" * lead + newline + newline.join(lines)
            + (newline if final and lines else ""))
    want = _outcome(t_parsers.parse_libsvm, text)
    got = _outcome(parse_libsvm_mirror, text)
    assert (want is None) == (got is None), text
    if want is not None:
        same_block(got[0], want)
