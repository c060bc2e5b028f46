// The libsvm parser, written by hand for Hopper (sm_90a).
//
// Replaces the host C++ parser of the JAX package's native core:
//   wormhole_tpu/native/src/parsers.cc:41 parse_libsvm
// (not a Pallas kernel: the TPU package parses on the host). Its contract
// here is the plain Python parser's (wormhole_tpu_torch/data/parsers.py
// parse_libsvm), exactly:
//   - lines end at '\n' or '\r' ("\r\n" leaves an empty line between, and
//     empty lines are skipped, as str.splitlines() has it); a line whose
//     first token starts with '#' is a comment and is skipped whole;
//   - tokens are split at runs of ' ' and '\t';
//   - a line's first token is its label, float() rounded to f32;
//   - every further token is "k:v" (split at the first ':') or a bare "k"
//     (value 1.0), k an int() in [0, 2^64), v float() rounded to f32;
//   - the chunk's rows, with offsets, keys and values, and whether any
//     value of a "k:v" token differs from 1.0 as a double.
// A byte outside printable ASCII, ' ', '\t', '\r' and '\n' is not taken:
// its first offset is reported and the wrapper raises. Python's own
// splitting would treat some of them ('\v', '\f', '\x1c'-'\x1e', bytes of
// non-ASCII whitespace) as separators; the port does not guess. A token
// the plain parser refuses is counted, the first one's offset kept, and
// the wrapper raises naming it.
//
// Numbers: the shared grammar of parse_common.cuh (float() and int()
// exactly; Clinger's fast path, else the exact path dec_to_double).
//
// Design: the chunk is cut into tiles of kTile bytes, a CTA a tile, in
// three launches and no library call:
//   1. parse_count_kernel: the CTA loads its tile into shared memory (16
//      bytes a thread a load, with a halo of kHalo bytes past its end and
//      the bytes before it), and each warp classifies its 1 KB region 32
//      bytes at a time: __ballot_sync masks of separators, line breaks
//      and '#'s. A token starts at a non-separator after a separator, so
//      a group's starts are ~sep & (sep << 1 | the byte before). From the
//      masks alone (walk_group: popc, clz, ffs and carries that ripple
//      through the gaps between events) the warp sums its region as a
//      small state map (Agg below): its tokens, the tokens before its
//      first line break, whether the first of those starts with '#', and
//      the lines, rows, features and the line state after it. The warps'
//      maps are kept, and composed in order into the tile's; also the
//      tile's first byte outside the alphabet.
//   2. parse_scan_kernel (one CTA): composes the tiles' maps in order (a
//      warp-shuffle scan; the composition is associative, not
//      commutative), and gives each tile the line state it starts in
//      (no token yet on its line, a kept line, a comment) and the rows
//      and features before it; writes the counts (tokens, lines, rows,
//      features), the first byte outside the alphabet, the offset past
//      the last row, and clears the slots that the third kernel adds to.
//   3. parse_emit_kernel: loads the tile again and keeps its masks in
//      shared memory; each warp's carry is the tile's with the maps of
//      the regions before it applied. Each warp walks its groups from
//      its carry: a token heads its line where the last event before it
//      (a line break or a token start) is a line break, a token of a kept
//      line that does not head it is a feature, and a head or feature's
//      slot is the running count plus the popc of the mask below its
//      lane. A head writes its row's offset. Heads and features go into a
//      queue of the warp's, and each time 32 wait, each lane converts one
//      from shared memory (its end found from the separator masks; a
//      token that runs past the halo reads on from device memory) with
//      parse_common.cuh's parse_float / parse_key.
// The chunk is read twice; the rows and features come out in file
// order, the same bits every call. Array sizes are bounds from the byte
// count n alone (tokens <= (n+1)/2), and the kernels read the counts
// they need from device memory, so a call makes no host sync; the
// wrapper reads the counts once, with the results.
//
// Bound: device memory, at 3.35 TB/s: the chunk's bytes once, and the
// outputs (label, offset, index, value) once. The passes are bound by
// their instructions, not their bytes: some hundred a 32-byte group to
// classify and walk it, and each token's conversion (on the H100,
// PERF.md). Decimals off the fast path are bound by their conversion.

#include <cstdint>

#include <cuda_runtime.h>

#include "parse_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTile = 16384;                    // bytes a CTA
constexpr int kRegionGroups = kTile / 32 / kTileWarps;  // 32-byte groups a warp
constexpr int kHalo = 256;                      // bytes loaded past the tile
constexpr int kPre = 16;                        // bytes loaded before it
constexpr int kGroups = (kTile + kHalo) / 32;   // groups classified
constexpr int kQueue = 64;                      // a warp's tokens to convert
constexpr int kScanThreads = 1024;

// the line state at a point of the chunk
constexpr int kNoHead = 0;   // no token yet since the last line break
constexpr int kKept = 1;     // the line's head is a label
constexpr int kComment = 2;  // the line's head starts with '#'
constexpr int kUnknown = 3;  // (a region's start, before its carry is known)

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// What a stretch of bytes does to the running counts, as a function of
// the line state it starts in. The stretch's `pre` tokens before its
// first line break depend on that state (the first is a head where no
// token came yet, the rest features where the line is kept); everything
// after the first line break does not: its lines (heads), rows (heads
// not starting with '#'), features, and the state at its end (`exit`,
// where has_nl).
struct Agg {
  int tok, pre, fh, has_nl, lines, rows, feats, exit;
};

__host__ __device__ __forceinline__ Agg agg_identity() {
  return Agg{0, 0, 0, 0, 0, 0, 0, kUnknown};
}

// Counts and the state after a stretch that starts in state s (known).
__device__ __forceinline__ void apply(const Agg& a, int s, int* lines,
                                      int* rows, int* feats, int* exit) {
  *lines = a.lines;
  *rows = a.rows;
  *feats = a.feats;
  if (a.pre > 0) {
    if (s == kNoHead) {
      *lines += 1;
      if (!a.fh) {
        *rows += 1;
        *feats += a.pre - 1;
      }
      s = a.fh ? kComment : kKept;
    } else if (s == kKept) {
      *feats += a.pre;
    }
  }
  *exit = a.has_nl ? a.exit : s;
}

// a then b
__device__ __forceinline__ Agg compose(const Agg& a, const Agg& b) {
  Agg c;
  c.tok = a.tok + b.tok;
  if (a.has_nl) {
    int l, r, f, e;
    apply(b, a.exit, &l, &r, &f, &e);
    c.pre = a.pre;
    c.fh = a.fh;
    c.has_nl = 1;
    c.lines = a.lines + l;
    c.rows = a.rows + r;
    c.feats = a.feats + f;
    c.exit = e;
  } else {
    c.pre = a.pre + b.pre;
    c.fh = a.pre > 0 ? a.fh : b.fh;
    c.has_nl = b.has_nl;
    c.lines = b.lines;
    c.rows = b.rows;
    c.feats = b.feats;
    c.exit = b.exit;
  }
  return c;
}

__device__ __forceinline__ Agg shfl_up_agg(const Agg& a, int o) {
  Agg b;
  b.tok = __shfl_up_sync(kFull, a.tok, o);
  b.pre = __shfl_up_sync(kFull, a.pre, o);
  b.fh = __shfl_up_sync(kFull, a.fh, o);
  b.has_nl = __shfl_up_sync(kFull, a.has_nl, o);
  b.lines = __shfl_up_sync(kFull, a.lines, o);
  b.rows = __shfl_up_sync(kFull, a.rows, o);
  b.feats = __shfl_up_sync(kFull, a.feats, o);
  b.exit = __shfl_up_sync(kFull, a.exit, o);
  return b;
}

// A warp's inclusive scan of one Agg a lane, in lane order.
__device__ __forceinline__ Agg warp_scan(Agg a) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Agg y = shfl_up_agg(a, o);
    if (lane >= o) a = compose(y, a);
  }
  return a;
}

// A tile in shared memory: buf[kPre + i] is the chunk's byte t0 + i for
// -kPre <= i < kTile + kHalo (a space outside the chunk: a separator,
// not a line break); per 32-byte group g (bytes 32 g .. 32 g + 31 of the
// tile), bit l of sep[g], nl[g], hash[g] says byte 32 g + l is a
// separator, a line break, a '#' (the emit pass's masks).
struct Tile {
  uint8_t buf[kPre + kTile + kHalo];
  uint32_t sep[kGroups];
  uint32_t nl[kGroups];
  uint32_t hash[kGroups];
  Agg warp_agg[kTileWarps];        // the count pass's
  unsigned int warp_err[kTileWarps];
  int warp_carry[kTileWarps][3];   // state, rows and features before
  int2 queue[kTileWarps][kQueue];  // (offset, slot; bit 31 = a label)
};

// Loads tile t0 .. t0 + kTile, its halo and the bytes before it. Ends
// with __syncthreads().
__device__ void load_tile(const uint8_t* __restrict__ buf, int64_t n,
                          int64_t t0, bool aligned, Tile& tile) {
  constexpr int kChunks = (kPre + kTile + kHalo) / 16;
  for (int c = threadIdx.x; c < kChunks; c += kTileThreads) {
    const int64_t g = t0 - kPre + 16 * c;
    uint8_t* dst = tile.buf + 16 * c;
    if (aligned && g >= 0 && g + 16 <= n) {
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(buf + g));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = g + j >= 0 && g + j < n ? buf[g + j] : ' ';
    }
  }
  __syncthreads();
}

// A group's masks, a warp's ballots over its 32 bytes: separators, line
// breaks, '#'s; the token starts (non-separators after a separator,
// `before` the separator bit of the byte before the group).
struct Masks {
  uint32_t sep, nl, hash, start;
};

__device__ __forceinline__ Masks group_masks(const Tile& tile, int grp,
                                             uint32_t before) {
  const uint8_t c = tile.buf[kPre + 32 * grp + (threadIdx.x & 31)];
  Masks m;
  m.sep = __ballot_sync(kFull, is_sep(c));
  m.nl = __ballot_sync(kFull, is_nl(c));
  m.hash = __ballot_sync(kFull, c == '#');
  m.start = ~m.sep & ((m.sep << 1) | before);
  return m;
}

// A group's tokens from line state e, in mask arithmetic alone (the same
// in every lane): its heads, its rows (heads of kept lines), its
// features, and the state after it (e where it holds no line break and
// no head). With e == kUnknown the tokens before the group's first line
// break are left out.
//   - A start heads its line where the last event (start or line break)
//     before it is a line break: adding a carry at each byte after a
//     line break (and at byte 0 where no token came yet) to the gaps
//     between events ripples up to the next event, so the carries land
//     on the heads.
//   - A line whose head starts with '#' is a comment from its head up to
//     the next line break: the same ripple over the non-line-breaks.
struct Walk {
  uint32_t head, row, feat;
  int exit;
};

__device__ __forceinline__ Walk walk_group(const Masks& m, int e) {
  const uint32_t S = m.start, NL = m.nl, HM = m.hash;
  const uint32_t before_nl =
      NL != 0 ? (1u << (__ffs(NL) - 1)) - 1 : ~0u;  // bytes before the first
  const uint32_t head =
      (~(S | NL) + ((NL << 1) | (e == kNoHead ? 1u : 0u))) & S;
  const uint32_t not_nl = ~NL;
  uint32_t comment = ((not_nl + (head & HM)) ^ not_nl) & not_nl;
  if (e == kComment) comment |= before_nl;
  uint32_t feat = S & ~head & ~comment;
  if (e == kUnknown) feat &= ~before_nl;
  Walk w;
  w.head = head;
  w.row = head & ~HM;
  w.feat = feat;
  if (NL != 0) {
    const uint32_t after = S & ~((2u << (31 - __clz(NL))) - 1);
    w.exit = after == 0 ? kNoHead
                        : (HM >> (__ffs(after) - 1)) & 1 ? kComment : kKept;
  } else if (e == kNoHead && S != 0) {
    w.exit = (HM >> (__ffs(S) - 1)) & 1 ? kComment : kKept;
  } else {
    w.exit = e;
  }
  return w;
}

// A group's Agg (its start state not known).
__device__ __forceinline__ Agg group_agg(const Masks& m) {
  const Walk w = walk_group(m, kUnknown);
  const uint32_t pre =
      m.nl != 0 ? m.start & ((1u << (__ffs(m.nl) - 1)) - 1) : m.start;
  Agg a;
  a.tok = __popc(m.start);
  a.pre = __popc(pre);
  a.fh = pre != 0 ? (m.hash >> (__ffs(pre) - 1)) & 1 : 0;
  a.has_nl = m.nl != 0;
  a.lines = __popc(w.head);
  a.rows = __popc(w.row);
  a.feats = __popc(w.feat);
  a.exit = w.exit;
  return a;
}

// The count pass of a warp: its region's Agg, and the first byte of the
// region outside the alphabet (~0 where none).
__device__ void count_region(const Tile& tile, int64_t t0, Agg* agg,
                             unsigned int* err) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = warp * kRegionGroups;
  uint32_t before = is_sep(tile.buf[kPre + 32 * g0 - 1]) ? 1u : 0u;
  unsigned bad = ~0u;
  Agg a = agg_identity();
  for (int k = 0; k < kRegionGroups; ++k) {
    const int grp = g0 + k;
    const Masks m = group_masks(tile, grp, before);
    before = m.sep >> 31;
    // the bytes past the chunk are spaces, inside the alphabet
    const uint32_t outside = __ballot_sync(
        kFull, !in_alphabet(tile.buf[kPre + 32 * grp + lane]));
    if (outside != 0 && bad == ~0u)
      bad = static_cast<unsigned>(t0 + 32 * grp + __ffs(outside) - 1);
    a = compose(a, group_agg(m));
  }
  if (lane == 0) {
    *agg = a;
    *err = bad;
  }
}

// The emit pass's masks: each warp its region's groups, the first warps
// also the halo's (their separators, for the token ends). Ends with
// __syncthreads().
__device__ void mask_region(Tile& tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < kRegionGroups; ++k) {
    const int grp = warp * kRegionGroups + k;
    const Masks m = group_masks(tile, grp, 0);
    if (lane == 0) {
      tile.sep[grp] = m.sep;
      tile.nl[grp] = m.nl;
      tile.hash[grp] = m.hash;
    }
  }
  if (warp < kGroups - kTile / 32) {
    const int grp = kTile / 32 + warp;
    const uint32_t sep = __ballot_sync(
        kFull, is_sep(tile.buf[kPre + 32 * grp + lane]));
    if (lane == 0) tile.sep[grp] = sep;
  }
  __syncthreads();
}

// ------------------------------------------------------------- kernels
// Each warp's Agg of its region into raggs[tile * kTileWarps + warp],
// the tile's (its warps' composed in order) into aggs[tile], and the
// tile's first byte outside the alphabet into errs[tile].
__global__ void __launch_bounds__(kTileThreads)
parse_count_kernel(const uint8_t* __restrict__ buf, int64_t n, bool aligned,
                   Agg* __restrict__ aggs, Agg* __restrict__ raggs,
                   unsigned int* __restrict__ errs) {
  __shared__ __align__(16) Tile tile;
  const int warp = threadIdx.x >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  load_tile(buf, n, t0, aligned, tile);
  count_region(tile, t0, &tile.warp_agg[warp], &tile.warp_err[warp]);
  __syncthreads();
  if (threadIdx.x < kTileWarps)
    raggs[blockIdx.x * kTileWarps + threadIdx.x] = tile.warp_agg[threadIdx.x];
  if (threadIdx.x == 0) {
    Agg a = agg_identity();
    unsigned e = ~0u;
    for (int w = 0; w < kTileWarps; ++w) {
      a = compose(a, tile.warp_agg[w]);
      e = min(e, tile.warp_err[w]);
    }
    aggs[blockIdx.x] = a;
    errs[blockIdx.x] = e;
  }
}

// One CTA: each thread composes a run of tiles, the CTA scans the runs,
// and each thread gives its tiles their carry (state, rows and features
// before the tile).
__global__ void __launch_bounds__(kScanThreads)
parse_scan_kernel(const Agg* __restrict__ aggs,
                  const unsigned int* __restrict__ errs,
                  int* __restrict__ carry, int tiles,
                  int64_t* __restrict__ offset, int* __restrict__ stats) {
  __shared__ Agg warp_sum[kScanThreads / 32];
  __shared__ unsigned int err;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) err = ~0u;
  __syncthreads();
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = min(tiles, static_cast<int>(threadIdx.x) * per);
  const int t1 = min(tiles, t0 + per);
  Agg run = agg_identity();
  unsigned e = ~0u;
  for (int t = t0; t < t1; ++t) {
    run = compose(run, aggs[t]);
    e = min(e, errs[t]);
  }
  e = __reduce_min_sync(kFull, e);
  if (lane == 0 && e != ~0u) atomicMin(&err, e);
  const Agg incl = warp_scan(run);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const Agg w = warp_scan(lane < kScanThreads / 32 ? warp_sum[lane]
                                                      : agg_identity());
    __syncwarp();
    warp_sum[lane] = w;
  }
  __syncthreads();
  // the runs before this thread's
  Agg before = shfl_up_agg(incl, 1);
  if (lane == 0) before = agg_identity();
  if (warp > 0) before = compose(warp_sum[warp - 1], before);
  int lines, rows, feats, state;
  apply(before, kNoHead, &lines, &rows, &feats, &state);
  int tok = before.tok;
  for (int t = t0; t < t1; ++t) {
    carry[3 * t] = state;
    carry[3 * t + 1] = rows;
    carry[3 * t + 2] = feats;
    const Agg a = aggs[t];
    int l, r, f;
    apply(a, state, &l, &r, &f, &state);
    lines += l;
    rows += r;
    feats += f;
    tok += a.tok;
  }
  if (threadIdx.x == kScanThreads - 1) {  // its runs end the chunk
    stats[kTokens] = tok;
    stats[kLines] = lines;
    stats[kRows] = rows;
    stats[kFeats] = feats;
    stats[kNe1] = 0;
    stats[kBad] = 0;
    stats[kExact] = 0;
    stats[kBadAt] = -1;
    offset[rows] = feats;
  }
  __syncthreads();
  if (threadIdx.x == 0) stats[kErr] = static_cast<int>(err);
}

struct Out {
  uint32_t* label;
  int64_t* offset;
  uint64_t* index;
  uint32_t* value;
  int* stats;
};

// The end (tile offset) of the token at tile offset p: the next
// separator, from the masks; kTile + kHalo where it runs past the halo.
__device__ __forceinline__ int token_end(const Tile& tile, int p) {
  int grp = p >> 5;
  uint32_t m = tile.sep[grp] & (~0u << (p & 31));
  while (m == 0 && ++grp < kGroups) m = tile.sep[grp];
  return m != 0 ? 32 * grp + __ffs(m) - 1 : kTile + kHalo;
}

// Lanes below k convert the warp's queued tokens 0 .. k - 1.
__device__ void convert_queue(const uint8_t* __restrict__ buf, int64_t n,
                              int64_t t0, const Tile& tile, int k,
                              const Out& out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Conv conv = kConvFast;
  bool ne1 = false;
  int pos = 0;
  if (lane < k) {
    const int2 q = tile.queue[warp][lane];
    pos = q.x;
    const int slot = q.y & 0x7fffffff;
    const int p = static_cast<int>(pos - t0);
    const int end = token_end(tile, p);
    const uint8_t* tp;
    int len;
    if (end < kTile + kHalo) {
      tp = tile.buf + kPre + p;
      len = end - p;
    } else {  // past the halo: on from device memory
      int64_t g = t0 + kTile + kHalo;
      while (g < n && !is_sep(buf[g])) ++g;
      tp = buf + pos;
      len = static_cast<int>(g - pos);
    }
    if (q.y < 0) {  // a label
      double v;
      uint32_t f;
      conv = parse_float(tp, len, &v, &f);
      if (conv != kConvBad) out.label[slot] = f;
    } else {
      int colon = 0;
      while (colon < len && tp[colon] != ':') ++colon;
      uint64_t key = 0;
      double v = 1.0;
      uint32_t bits = 0x3f800000u;  // 1.0f
      if (!parse_key(tp, colon, &key)) {
        conv = kConvBad;
      } else if (colon < len) {
        conv = parse_float(tp + colon + 1, len - colon - 1, &v, &bits);
      }
      if (conv != kConvBad) {
        out.index[slot] = key;
        out.value[slot] = bits;
        ne1 = v != 1.0;
      }
    }
  }
  const uint32_t bad = __ballot_sync(kFull, lane < k && conv == kConvBad);
  const uint32_t exact = __ballot_sync(kFull, lane < k && conv == kConvExact);
  const bool any_ne1 = __any_sync(kFull, ne1);
  if ((bad >> lane) & 1)
    atomicMin(reinterpret_cast<unsigned int*>(&out.stats[kBadAt]),
              static_cast<unsigned int>(pos));
  if (lane == 0) {
    if (bad != 0) atomicAdd(&out.stats[kBad], __popc(bad));
    if (exact != 0) atomicAdd(&out.stats[kExact], __popc(exact));
    if (any_ne1) out.stats[kNe1] = 1;
  }
}

__global__ void __launch_bounds__(kTileThreads)
parse_emit_kernel(const uint8_t* __restrict__ buf, int64_t n, bool aligned,
                  const int* __restrict__ carry,
                  const Agg* __restrict__ raggs, Out out) {
  __shared__ __align__(16) Tile tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  load_tile(buf, n, t0, aligned, tile);
  if (threadIdx.x == 0) {  // each warp's carry: the tile's, then its regions
    const int* c = carry + 3 * blockIdx.x;
    int state = c[0], rows = c[1], feats = c[2];
    const Agg* ra = raggs + blockIdx.x * kTileWarps;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      tile.warp_carry[w][0] = state;
      tile.warp_carry[w][1] = rows;
      tile.warp_carry[w][2] = feats;
      int l, r, f;
      apply(ra[w], state, &l, &r, &f, &state);
      rows += r;
      feats += f;
    }
  }
  mask_region(tile);
  int state = tile.warp_carry[warp][0];
  int rows = tile.warp_carry[warp][1];
  int feats = tile.warp_carry[warp][2];
  const unsigned lt = lanemask_lt();
  int queued = 0;
  for (int k = 0; k < kRegionGroups; ++k) {
    const int grp = warp * kRegionGroups + k;
    Masks m;
    m.sep = tile.sep[grp];
    m.nl = tile.nl[grp];
    m.hash = tile.hash[grp];
    m.start = ~m.sep & ((m.sep << 1) |
                        (grp > 0 ? tile.sep[grp - 1] >> 31
                                 : is_sep(tile.buf[kPre - 1]) ? 1u : 0u));
    const Walk g = walk_group(m, state);
    const bool is_row = (g.row >> lane) & 1, is_feat = (g.feat >> lane) & 1;
    const int row = rows + __popc(g.row & lt);
    const int feat = feats + __popc(g.feat & lt);
    if (is_row) out.offset[row] = feat;  // a head is no feature
    const uint32_t conv = g.row | g.feat;
    if (is_row || is_feat)
      tile.queue[warp][queued + __popc(conv & lt)] = make_int2(
          static_cast<int>(t0 + 32 * grp + lane),
          is_row ? (row | static_cast<int>(0x80000000u)) : feat);
    queued += __popc(conv);
    rows += __popc(g.row);
    feats += __popc(g.feat);
    state = g.exit;
    if (queued >= 32) {
      __syncwarp();
      convert_queue(buf, n, t0, tile, 32, out);
      queued -= 32;
      int2 rest = make_int2(0, 0);
      if (lane < queued) rest = tile.queue[warp][32 + lane];
      __syncwarp();
      if (lane < queued) tile.queue[warp][lane] = rest;
      __syncwarp();
    }
  }
  __syncwarp();
  if (queued > 0) convert_queue(buf, n, t0, tile, queued, out);
}

int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

const char* wh_parse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// *bytes = the scratch (16-byte aligned) that wh_parse_libsvm takes for
// a chunk of n bytes; *slots = the int32 slots of its stats.
int wh_parse_libsvm_scratch(int64_t n, void* bytes, void* slots) {
  if (n <= 0 || n >= (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<int64_t*>(bytes) =
      tiles_for(n) * ((kTileWarps + 1) * sizeof(Agg) + sizeof(unsigned int) +
                      3 * sizeof(int));
  *static_cast<int64_t*>(slots) = kStats;
  return 0;
}

// The parse of a chunk of n bytes (0 < n < 2^30) on the stream, three
// launches. With tmax = (n + 1) / 2: label (f32 bits), index (uint64)
// and value (f32 bits) hold tmax entries, offset (int64) tmax + 1; stats
// kStats int32s; scratch wh_parse_libsvm_scratch's bytes.
int wh_parse_libsvm(const void* buf, int64_t n, void* label, void* offset,
                    void* index, void* value, void* stats, void* scratch,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n >= (int64_t{1} << 30) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(tiles_for(n));
  Agg* aggs = static_cast<Agg*>(scratch);
  Agg* raggs = aggs + tiles;
  unsigned int* errs = reinterpret_cast<unsigned int*>(raggs + tiles * kTileWarps);
  int* carry = reinterpret_cast<int*>(errs + tiles);
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  const bool aligned = (reinterpret_cast<uintptr_t>(buf) & 15) == 0;
  const Out out{static_cast<uint32_t*>(label), static_cast<int64_t*>(offset),
                static_cast<uint64_t*>(index), static_cast<uint32_t*>(value),
                static_cast<int*>(stats)};
  parse_count_kernel<<<tiles, kTileThreads, 0, st>>>(b, n, aligned, aggs,
                                                     raggs, errs);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  parse_scan_kernel<<<1, kScanThreads, 0, st>>>(aggs, errs, carry, tiles,
                                                out.offset, out.stats);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  parse_emit_kernel<<<tiles, kTileThreads, 0, st>>>(b, n, aligned, carry,
                                                    raggs, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
