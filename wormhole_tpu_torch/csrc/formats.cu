// The criteo and adfea parsers, written by hand for Hopper (sm_90a).
//
// Replace the host C++ parsers of the JAX package's native core:
//   wormhole_tpu/native/src/parsers.cc:101 parse_criteo
//   wormhole_tpu/native/src/parsers.cc:171 parse_adfea
// (not Pallas kernels: the TPU package parses on the host). Their
// contracts are the plain Python parsers (wormhole_tpu_torch/data/
// parsers.py parse_criteo, parse_adfea), exactly, for bytes in the
// alphabet of parse_common.cuh (printable ASCII, ' ', '\t', '\r', '\n'):
// a byte outside it is not taken, its first offset is reported and the
// wrapper raises. Lines end at '\n' or '\r' (str.splitlines(): a lone
// '\r' splits a line, "\r\n" leaves an empty line between, which is
// skipped). Numbers follow the shared grammar of parse_common.cuh.
//
// criteo: a line is cut into cells at every '\t' (str.split("\t")); a
// line of spaces and tabs only is skipped (not line.strip()).
//   - With a label, cell 0 is the label: float() of the cell with its
//     spaces stripped, rounded to f32; without (criteo_test) the label is
//     0 and the fields start at cell 0.
//   - The field cells are numbered from 0; an empty one is skipped but
//     keeps its number; fields 39 and on are ignored. A field's key is
//     (CityHash64(cell bytes) >> 10) | (field << 54): below 2^60.
// adfea: a line is cut into tokens at runs of ' ' and '\t'
// (str.split()); a line of fewer than three tokens is skipped, and
// tokens 0 and 1 are never read.
//   - Token 2 is the label: 1 if float() of it is > 0, else 0 (nan: 0).
//   - Each further token is "fid:gid" (split at the first ':') or a bare
//     key. Both sides of "fid:gid" are int()s of any length; the key is
//     ((fid >> 10) | ((gid & 0x3FF) << 54)) mod 2^64 on Python's
//     unbounded two's complement integers, which depends only on fid mod
//     2^74 and gid mod 2^10: fid is read into a 128-bit accumulator that
//     wraps, negated for '-'. A bare key is an int() in [0, 2^64) (the
//     plain parser's numpy conversion raises OverflowError outside it).
// A label or key the plain parser refuses is counted, the first one's
// offset kept (stats slot kBadAt), and the wrapper raises ValueError
// naming it.
//
// CityHash64: v1.1 (wormhole_tpu_torch/ops/hashing.py cityhash64, its
// contract), with all four length branches (0-16, 17-32, 33-64, the
// 64-byte loop) and the byte swaps of HashLen33to64. A cell starts at any
// byte: in shared memory an 8-byte load is two aligned 8-byte loads and a
// funnel shift; in device memory (a cell past the halo) it is assembled
// from single bytes, little-endian.
//
// Design: parse.cu's tiles, in three launches and no library call. The
// chunk is cut into tiles of kTile bytes, a CTA a tile, loaded into
// shared memory with 16-byte loads (bytes outside the chunk read as line
// breaks), with a halo of kHalo bytes past the tile and the bytes before
// it; each warp's region is kRegion bytes of it. Every 32-byte group's
// bytes become __ballot_sync masks: line breaks, and for criteo tabs and
// the bytes that keep a line (not ' ', '\t' or a line break), for adfea
// separators (' ', '\t', line breaks).
//   Lines belong to the tile and the warp whose region holds their first
//   byte (byte 0, or the byte after a line break). A warp walks its
//   region a group at a time, and its last line on to its end: through
//   the other warps' groups, the halo, and device memory past it. In a
//   group each lane finds its line's start (the last line start at or
//   below it), whether the warp owns that line, and its cell or token
//   number on it (the tabs or token starts between, popc of the masks,
//   plus what the line carried from the groups before).
//   - criteo: a line is kept if the first event (a keeping byte or a
//     line break) at or after its start is a keeping byte; where a group
//     holds no event after a start, the warp looks ahead over the groups
//     that follow. A kept line's start heads a row (cell 0 its label);
//     a nonempty cell (a start that is no tab or line break) with field
//     0 to 38 is a feature.
//   - adfea: token 2 of a line is its row's label, tokens 3 and on its
//     features; no look-ahead is needed, as the label comes first.
// So a tile's counts are plain sums of its warps' lines:
//   1. formats_count_kernel: the masks, each warp's walk counting its
//      rows and features (adfea also the lines with a token), and by
//      position the tile's cells and lines (criteo) or tokens (adfea)
//      and its first byte outside the alphabet.
//   2. formats_scan_kernel (one CTA): the tiles' rows and features
//      scanned into each tile's carry, the counts into stats, the offset
//      past the last row, and the slots the third kernel adds to cleared.
//   3. formats_emit_kernel: the masks again, each warp's carry (its
//      tile's, plus the warps before it), the same walk, writing each
//      row's offset, and queueing labels and features; each time 32 wait
//      each lane converts or hashes one from shared memory (its end found
//      from the masks; a cell past the halo reads on from device memory).
// The chunk is read twice; rows and features come out in file order,
// the same bits every call. Array sizes are bounds from the byte count n
// alone (a kept line, a nonempty cell and a token each take at least two
// bytes with the byte after them, so rows and features <= (n + 1) / 2),
// and the kernels read the counts they need from device memory, so a call
// makes no host sync; the wrapper reads the counts once, with the results.
//
// Bound: device memory, at 3.35 TB/s: the chunk's bytes once, and the
// outputs (label, offset, index) once. The passes are bound by their
// instructions, not their bytes: the walk of each 32-byte group, and each
// cell's hash or token's conversion (on the H100, PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

#include "parse_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTile = 16384;                     // bytes a CTA
constexpr int kRegion = kTile / kTileWarps;      // bytes a warp
constexpr int kRegionGroups = kRegion / 32;
constexpr int kHalo = 256;                       // bytes loaded past the tile
constexpr int kPre = 16;                         // bytes loaded before it
constexpr int kPost = 16;  // more past the halo: an 8-byte load near its end
constexpr int kGroups = (kTile + kHalo) / 32;    // groups with masks
constexpr int kQueue = 64;                       // a warp's cells to convert
constexpr int kScanThreads = 1024;
constexpr uint8_t kPad = '\n';                   // bytes outside the chunk
constexpr int kCriteoFields = 39;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// ------------------------------------------------------------ cityhash64
constexpr uint64_t kK0 = 0xc3a5c85c97cb3127ull;
constexpr uint64_t kK1 = 0xb492b66fbe98f273ull;
constexpr uint64_t kK2 = 0x9ae16a3b2f90404full;
constexpr uint64_t kMul = 0x9ddfea08eb382d69ull;

// A cell's bytes in device memory: loads assembled from single bytes.
struct GlobalBytes {
  const uint8_t* p;
  __device__ __forceinline__ uint64_t at(int i) const { return p[i]; }
  __device__ __forceinline__ uint64_t fetch64(int i) const {
    uint64_t r = 0;
    for (int k = 7; k >= 0; --k) r = (r << 8) | p[i + k];
    return r;
  }
  __device__ __forceinline__ uint64_t fetch32(int i) const {
    return at(i) | (at(i + 1) << 8) | (at(i + 2) << 16) | (at(i + 3) << 24);
  }
};

// A cell's bytes in shared memory (8-byte aligned, with kPost bytes past
// its end): an 8-byte load at any byte is two aligned loads and a shift.
struct SharedBytes {
  const uint8_t* p;
  __device__ __forceinline__ uint64_t at(int i) const { return p[i]; }
  __device__ __forceinline__ uint64_t fetch64(int i) const {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p + i);
    const uint64_t* w = reinterpret_cast<const uint64_t*>(a & ~uintptr_t{7});
    const int s = static_cast<int>(a & 7) * 8;
    return s == 0 ? w[0] : (w[0] >> s) | (w[1] << (64 - s));
  }
  __device__ __forceinline__ uint64_t fetch32(int i) const {
    return fetch64(i) & 0xffffffffull;
  }
};

__device__ __forceinline__ uint64_t rotr(uint64_t v, int s) {
  return s == 0 ? v : (v >> s) | (v << (64 - s));
}

__device__ __forceinline__ uint64_t shift_mix(uint64_t v) {
  return v ^ (v >> 47);
}

__device__ __forceinline__ uint64_t bswap64(uint64_t v) {
  const uint32_t lo = static_cast<uint32_t>(v);
  const uint32_t hi = static_cast<uint32_t>(v >> 32);
  return (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) |
         __byte_perm(hi, 0, 0x0123);
}

__device__ __forceinline__ uint64_t hash_len16(uint64_t u, uint64_t v,
                                               uint64_t mul) {
  uint64_t a = (u ^ v) * mul;
  a ^= a >> 47;
  uint64_t b = (v ^ a) * mul;
  b ^= b >> 47;
  return b * mul;
}

template <class B>
__device__ uint64_t hash_len0to16(const B& s, int n) {
  if (n >= 8) {
    const uint64_t mul = kK2 + static_cast<uint64_t>(n) * 2;
    const uint64_t a = s.fetch64(0) + kK2;
    const uint64_t b = s.fetch64(n - 8);
    const uint64_t c = rotr(b, 37) * mul + a;
    const uint64_t d = (rotr(a, 25) + b) * mul;
    return hash_len16(c, d, mul);
  }
  if (n >= 4) {
    const uint64_t mul = kK2 + static_cast<uint64_t>(n) * 2;
    const uint64_t a = s.fetch32(0);
    return hash_len16(n + (a << 3), s.fetch32(n - 4), mul);
  }
  if (n > 0) {
    const uint64_t a = s.at(0), b = s.at(n >> 1), c = s.at(n - 1);
    const uint64_t y = a + (b << 8);
    const uint64_t z = n + (c << 2);
    return shift_mix(y * kK2 ^ z * kK0) * kK2;
  }
  return kK2;
}

template <class B>
__device__ uint64_t hash_len17to32(const B& s, int n) {
  const uint64_t mul = kK2 + static_cast<uint64_t>(n) * 2;
  const uint64_t a = s.fetch64(0) * kK1;
  const uint64_t b = s.fetch64(8);
  const uint64_t c = s.fetch64(n - 8) * mul;
  const uint64_t d = s.fetch64(n - 16) * kK2;
  return hash_len16(rotr(a + b, 43) + rotr(c, 30) + d,
                    a + rotr(b + kK2, 18) + c, mul);
}

template <class B>
__device__ uint64_t hash_len33to64(const B& s, int n) {
  const uint64_t mul = kK2 + static_cast<uint64_t>(n) * 2;
  uint64_t a = s.fetch64(0) * kK2;
  uint64_t b = s.fetch64(8);
  const uint64_t c = s.fetch64(n - 24);
  const uint64_t d = s.fetch64(n - 32);
  const uint64_t e = s.fetch64(16) * kK2;
  const uint64_t f = s.fetch64(24) * 9;
  const uint64_t g = s.fetch64(n - 8);
  const uint64_t h = s.fetch64(n - 16) * mul;
  const uint64_t u = rotr(a + g, 43) + (rotr(b, 30) + c) * 9;
  const uint64_t v = ((a + g) ^ d) + f + 1;
  const uint64_t w = bswap64((u + v) * mul) + h;
  const uint64_t x = rotr(e + f, 42) + c;
  const uint64_t y = (bswap64((v + w) * mul) + g) * mul;
  const uint64_t z = e + f + c;
  a = bswap64((x + z) * mul + y) + b;
  b = shift_mix((z + a) * mul + d + h) * mul;
  return b + x;
}

struct Pair {
  uint64_t first, second;
};

__device__ __forceinline__ Pair weak32(uint64_t w, uint64_t x, uint64_t y,
                                       uint64_t z, uint64_t a, uint64_t b) {
  a += w;
  b = rotr(b + a + z, 21);
  const uint64_t c = a;
  a += x + y;
  b += rotr(a, 44);
  return {a + z, b + c};
}

template <class B>
__device__ __forceinline__ Pair weak32_at(const B& s, int i, uint64_t a,
                                          uint64_t b) {
  return weak32(s.fetch64(i), s.fetch64(i + 8), s.fetch64(i + 16),
                s.fetch64(i + 24), a, b);
}

// CityHash64 v1.1 of s[0..n).
template <class B>
__device__ uint64_t cityhash64(const B& s, int n) {
  if (n <= 16) return hash_len0to16(s, n);
  if (n <= 32) return hash_len17to32(s, n);
  if (n <= 64) return hash_len33to64(s, n);
  uint64_t x = s.fetch64(n - 40);
  uint64_t y = s.fetch64(n - 16) + s.fetch64(n - 56);
  uint64_t z = hash_len16(s.fetch64(n - 48) + n, s.fetch64(n - 24), kMul);
  Pair v = weak32_at(s, n - 64, n, z);
  Pair w = weak32_at(s, n - 32, y + kK1, x);
  x = x * kK1 + s.fetch64(0);
  int rem = (n - 1) & ~63;
  int p = 0;
  do {
    x = rotr(x + y + v.first + s.fetch64(p + 8), 37) * kK1;
    y = rotr(y + v.second + s.fetch64(p + 48), 42) * kK1;
    x ^= w.second;
    y += v.first + s.fetch64(p + 40);
    z = rotr(z + w.first, 33) * kK1;
    v = weak32_at(s, p, v.second * kK1, x + w.first);
    w = weak32_at(s, p + 32, z + w.second, y + s.fetch64(p + 16));
    const uint64_t t = z;
    z = x;
    x = t;
    p += 64;
    rem -= 64;
  } while (rem != 0);
  return hash_len16(
      hash_len16(v.first, w.first, kMul) + shift_mix(y) * kK1 + z,
      hash_len16(v.second, w.second, kMul) + x, kMul);
}

// ---------------------------------------------------------------- adfea
// int() of p[0..len) mod 2^128 (two's complement for '-') as (lo, hi):
// [+-] digits with '_' between digits, of any length; false outside the
// grammar.
__device__ bool parse_int_wrap(const uint8_t* p, int len, uint64_t* lo,
                               uint64_t* hi) {
  int i = 0;
  bool neg = false;
  if (i < len && (p[i] == '+' || p[i] == '-')) {
    neg = p[i] == '-';
    ++i;
  }
  const int end = digit_run_end(p, i, len);
  if (end != len || end == i) return false;
  uint64_t l = 0, h = 0;
  for (; i < len; ++i) {
    if (p[i] == '_') continue;
    h = h * 10 + __umul64hi(l, 10);
    l *= 10;
    const uint64_t s = l + (p[i] - '0');
    h += s < l;
    l = s;
  }
  if (neg) {
    l = ~l + 1;
    h = ~h + (l == 0);
  }
  *lo = l;
  *hi = h;
  return true;
}

// An adfea feature token's key: "fid:gid" or a bare key; false where the
// plain parser raises.
__device__ bool adfea_key(const uint8_t* p, int len, uint64_t* key) {
  int colon = 0;
  while (colon < len && p[colon] != ':') ++colon;
  if (colon == len) return parse_key(p, len, key);
  uint64_t flo, fhi, glo, ghi;
  if (!parse_int_wrap(p, colon, &flo, &fhi) ||
      !parse_int_wrap(p + colon + 1, len - colon - 1, &glo, &ghi))
    return false;
  *key = ((flo >> 10) | (fhi << 54)) | ((glo & 0x3FF) << 54);
  return true;
}

// ------------------------------------------------------- the two formats
// Each format's byte classes: x (criteo: a tab; adfea: a separator) and
// y (criteo: a byte that keeps its line, not ' ', '\t' or a line break;
// adfea: none), and the bytes that end a cell or token.
struct Criteo {
  static constexpr bool kCriteo = true;
  __device__ __forceinline__ static bool x(uint8_t c) { return c == '\t'; }
  __device__ __forceinline__ static bool y(uint8_t c) {
    return c != ' ' && c != '\t' && !is_nl(c);
  }
  __device__ __forceinline__ static bool ends(uint8_t c) {
    return c == '\t' || is_nl(c);
  }
  __device__ __forceinline__ static uint32_t end_mask(uint32_t nl,
                                                      uint32_t x) {
    return nl | x;
  }
};

struct Adfea {
  static constexpr bool kCriteo = false;
  __device__ __forceinline__ static bool x(uint8_t c) { return is_sep(c); }
  __device__ __forceinline__ static bool y(uint8_t) { return false; }
  __device__ __forceinline__ static bool ends(uint8_t c) { return is_sep(c); }
  __device__ __forceinline__ static uint32_t end_mask(uint32_t,
                                                      uint32_t x) {
    return x;
  }
};

// A tile in shared memory: buf[kPre + i] is the chunk's byte t0 + i for
// -kPre <= i < kTile + kHalo + kPost (a line break outside the chunk);
// per 32-byte group g (bytes 32 g .. 32 g + 31 of the tile), bit l of
// nl[g], x[g], y[g] classes byte 32 g + l.
struct Tile {
  uint8_t buf[kPre + kTile + kHalo + kPost];
  uint32_t nl[kGroups];
  uint32_t x[kGroups];
  uint32_t y[kGroups];
};

// A queued label or feature: its offset in the chunk, its slot, and its
// kind (-1 a label; else a criteo feature's field, 0 for adfea's).
struct Entry {
  int pos, slot, kind;
};

// Loads tile t0 .. t0 + kTile, its halo, and the bytes before and after.
// Ends with __syncthreads(). Chunk offsets are below 2^30: ints.
__device__ void load_tile(const uint8_t* __restrict__ buf, int n, int t0,
                          bool aligned, Tile& tile) {
  constexpr int kChunks = (kPre + kTile + kHalo + kPost) / 16;
  for (int c = threadIdx.x; c < kChunks; c += kTileThreads) {
    const int g = t0 - kPre + 16 * c;
    uint8_t* dst = tile.buf + 16 * c;
    if (aligned && g >= 0 && g + 16 <= n) {
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(buf + g));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = g + j >= 0 && g + j < n ? buf[g + j] : kPad;
    }
  }
  __syncthreads();
}

struct Group {
  uint32_t nl, x, y;
};

template <class F>
__device__ __forceinline__ Group classify(uint8_t c) {
  Group m;
  m.nl = __ballot_sync(kFull, is_nl(c));
  m.x = __ballot_sync(kFull, F::x(c));
  m.y = F::kCriteo ? __ballot_sync(kFull, F::y(c)) : 0u;
  return m;
}

// The masks of the tile's group g (g >= 0): from shared memory in the
// tile and its halo, else from device memory.
template <class F>
__device__ __forceinline__ Group group_at(const Tile& tile,
                                          const uint8_t* __restrict__ buf,
                                          int n, int t0, int g) {
  if (g < kGroups) return Group{tile.nl[g], tile.x[g], tile.y[g]};
  const int i = t0 + 32 * g + (threadIdx.x & 31);
  return classify<F>(i < n ? buf[i] : kPad);
}

// The per-position counts of a warp's region (tiles' sums give the
// chunk's): criteo its cell separators and line breaks, adfea its token
// starts; and its first byte outside the alphabet (~0 where none).
struct RegionCount {
  int a, b;
  unsigned err;
};

// Every group's masks into the tile: each warp its region's, the first
// warps also the halo's. With kCount, the region's counts too. Ends with
// __syncthreads().
template <class F, bool kCount>
__device__ void mask_tile(Tile& tile, int n, int t0, RegionCount* rc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = warp * kRegionGroups;
  uint32_t x_before = F::x(tile.buf[kPre + 32 * g0 - 1]) ? 1u : 0u;
  int a = 0, b = 0;
  unsigned err = ~0u;  // this lane's first byte outside the alphabet
  for (int k = 0; k < kRegionGroups; ++k) {
    const int grp = g0 + k;
    const uint8_t c = tile.buf[kPre + 32 * grp + lane];
    const Group m = classify<F>(c);
    if (lane == 0) {
      tile.nl[grp] = m.nl;
      tile.x[grp] = m.x;
      tile.y[grp] = m.y;
    }
    if (kCount) {
      const int base = t0 + 32 * grp;
      const uint32_t valid = base + 32 <= n ? kFull
                             : base >= n    ? 0u
                                            : (1u << (n - base)) - 1;
      if (F::kCriteo) {
        a += __popc((m.x | m.nl) & valid);
        b += __popc(m.nl & valid);
      } else {
        a += __popc(~m.x & ((m.x << 1) | x_before) & valid);
      }
      x_before = m.x >> 31;
      // the bytes past the chunk are line breaks, inside the alphabet
      if (err == ~0u && !in_alphabet(c)) err = base + lane;
    }
  }
  if (warp < kGroups - kTile / 32) {
    const int grp = kTile / 32 + warp;
    const Group m = classify<F>(tile.buf[kPre + 32 * grp + lane]);
    if (lane == 0) {
      tile.nl[grp] = m.nl;
      tile.x[grp] = m.x;
      tile.y[grp] = m.y;
    }
  }
  if (kCount) *rc = RegionCount{a, b, __reduce_min_sync(kFull, err)};
  __syncthreads();
}

struct Out {
  uint32_t* label;
  int64_t* offset;
  uint64_t* index;
  int* stats;
};

// Whether the first event (a keeping byte or a line break) after group g
// is a keeping byte: a criteo line whose start has no event after it in
// its group is kept if so. Past the chunk every byte is a line break.
template <class F>
__device__ bool kept_ahead(const Tile& tile, const uint8_t* __restrict__ buf,
                           int n, int t0, int g) {
  while (true) {
    const Group m = group_at<F>(tile, buf, n, t0, ++g);
    const uint32_t e = m.y | m.nl;
    if (e != 0) return (m.y >> (__ffs(e) - 1)) & 1;
  }
}

// The end (chunk offset) of the cell or token at chunk offset pos, and
// whether it ends inside the tile's halo, its bytes in shared memory
// (*sh).
template <class F>
__device__ __forceinline__ int cell_end(const Tile& tile,
                                        const uint8_t* __restrict__ buf,
                                        int n, int t0, int pos, bool* sh) {
  const int p = pos - t0;
  if (p < kTile + kHalo) {
    int grp = p >> 5;
    uint32_t m = F::end_mask(tile.nl[grp], tile.x[grp]) & (~0u << (p & 31));
    while (m == 0 && ++grp < kGroups)
      m = F::end_mask(tile.nl[grp], tile.x[grp]);
    if (m != 0) {
      *sh = true;
      return t0 + 32 * grp + __ffs(m) - 1;
    }
  }
  *sh = false;  // past the halo: on from device memory
  int g = max(pos, t0 + kTile + kHalo);
  while (g < n && !F::ends(buf[g])) ++g;
  return g;
}

// Lanes below k convert (adfea) or hash (criteo) the warp's queued
// entries 0 .. k - 1.
template <class F>
__device__ void convert_queue(const uint8_t* __restrict__ buf, int n, int t0,
                              const Tile& tile, const Entry* queue, int k,
                              const Out& out) {
  const int lane = threadIdx.x & 31;
  Conv conv = kConvFast;
  int pos = 0;
  if (lane < k) {
    const Entry e = queue[lane];
    pos = e.pos;
    bool sh;
    const int len = cell_end<F>(tile, buf, n, t0, pos, &sh) - pos;
    const uint8_t* tp = sh ? tile.buf + kPre + (pos - t0) : buf + pos;
    if (e.kind < 0 && F::kCriteo) {  // float() strips the cell's spaces
      int b = 0, end = len;
      while (b < end && tp[b] == ' ') ++b;
      while (end > b && tp[end - 1] == ' ') --end;
      double v;
      uint32_t bits = 0;
      conv = parse_float(tp + b, end - b, &v, &bits);
      out.label[e.slot] = bits;
    } else if (e.kind < 0) {
      double v = 0.0;
      uint32_t bits;
      conv = parse_float(tp, len, &v, &bits);
      out.label[e.slot] = v > 0.0 ? 0x3f800000u : 0u;  // nan > 0 is false
    } else if (F::kCriteo) {
      const uint64_t h = sh ? cityhash64(SharedBytes{tp}, len)
                            : cityhash64(GlobalBytes{tp}, len);
      out.index[e.slot] = (h >> 10) | (static_cast<uint64_t>(e.kind) << 54);
    } else {
      uint64_t key = 0;
      if (!adfea_key(tp, len, &key)) conv = kConvBad;
      out.index[e.slot] = key;
    }
  }
  const uint32_t bad = __ballot_sync(kFull, lane < k && conv == kConvBad);
  const uint32_t exact = __ballot_sync(kFull, lane < k && conv == kConvExact);
  if ((bad >> lane) & 1)
    atomicMin(reinterpret_cast<unsigned int*>(&out.stats[kBadAt]),
              static_cast<unsigned int>(pos));
  if (lane == 0) {
    if (bad != 0) atomicAdd(&out.stats[kBad], __popc(bad));
    if (exact != 0) atomicAdd(&out.stats[kExact], __popc(exact));
  }
}

// What a warp's walk counted: its rows and features (from its carry),
// and adfea's lines with a token.
struct WalkCount {
  int rows, feats, heads;
};

// A group's roles on the warp's lines: rows (criteo: kept line starts;
// adfea: token 2), labels among them, features, and each lane's field
// (criteo).
struct Roles {
  uint32_t row, label, feat;
  int kind;
};

// A warp's walk of the lines that start in its region (the design
// above): kEmit writes each row's offset (and criteo_test's label 0) and
// queues its labels and features, converting each 32; else it counts.
// A group with no line start lies on the line that runs on into it: the
// walk takes it in mask arithmetic where every cell or token of it has
// the same role (criteo: fields 0 to 38; adfea: tokens 3 and on).
template <class F, bool kEmit>
__device__ WalkCount walk(const Tile& tile, const uint8_t* __restrict__ buf,
                          int n, int t0, int has_label, int rows, int feats,
                          Entry* queue, const Out& out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lt = lanemask_lt(), le = lt | (1u << lane);
  const int r0 = t0 + warp * kRegion;
  const int r1 = min(r0 + kRegion, n);
  int g = warp * kRegionGroups;
  const uint8_t before = tile.buf[kPre + 32 * g - 1];
  uint32_t nl_before = is_nl(before) ? 1u : 0u;
  uint32_t x_before = F::x(before) ? 1u : 0u;
  bool in_line = false;  // the line running on into this group is ours
  bool keep = false;     // ... and kept (criteo)
  int cnt = 0;           // ... and its tabs (criteo) or tokens (adfea)
  int heads = 0, queued = 0;
  for (;; ++g) {
    const int base = t0 + 32 * g;
    if (base >= n || (base >= r1 && !in_line)) break;
    const Group m = group_at<F>(tile, buf, n, t0, g);
    const uint32_t starts = (m.nl << 1) | nl_before;  // line starts
    // criteo: nonempty cell starts; adfea: token starts
    const uint32_t cells =
        F::kCriteo ? (starts | (m.x << 1) | x_before) & ~(m.x | m.nl)
                   : ~m.x & ((m.x << 1) | x_before);
    Roles r{0u, 0u, 0u, 0};
    if (starts == 0) {
      if (F::kCriteo) {
        r.kind = cnt + __popc(m.x & lt) - has_label;
        if (in_line && keep && cells != 0) {
          const bool all = cnt >= has_label &&
                           cnt + __popc(m.x) < kCriteoFields + has_label;
          r.feat = all ? cells
                       : __ballot_sync(kFull, ((cells >> lane) & 1) &&
                                                  r.kind >= 0 &&
                                                  r.kind < kCriteoFields);
        }
        cnt += __popc(m.x);
      } else {
        if (in_line && cells != 0) {
          if (cnt >= 3) {
            r.feat = cells;
          } else {
            const bool tok = (cells >> lane) & 1;
            const int idx = cnt + __popc(cells & lt);
            r.row = __ballot_sync(kFull, tok && idx == 2);
            r.feat = __ballot_sync(kFull, tok && idx >= 3);
            heads += __popc(__ballot_sync(kFull, tok && idx == 0));
          }
        }
        cnt += __popc(cells);
      }
    } else {
      const int hi = r1 - base;  // the region's end (base >= r0 here)
      const uint32_t own =
          starts & (hi >= 32 ? kFull : hi <= 0 ? 0u : (1u << hi) - 1);
      const uint32_t mine = starts & le;
      const int p = mine != 0 ? 31 - __clz(mine) : -1;  // this lane's line
      const uint32_t from_p = p >= 0 ? ~((1u << p) - 1) : kFull;
      const bool owned = p >= 0 ? (own >> p) & 1 : in_line;
      const int last = 31 - __clz(starts);
      const bool at_start = (starts >> lane) & 1;
      const bool cell = (cells >> lane) & 1;
      if (F::kCriteo) {
        // a line start is kept where the first event at or after it is a
        // keeping byte; a start with no event after it in the group (the
        // last one) looks ahead
        const uint32_t ev = (m.y | m.nl) & ~lt;
        uint32_t keeps = __ballot_sync(
            kFull, at_start && ev != 0 && ((m.y >> (__ffs(ev) - 1)) & 1));
        const uint32_t ahead =
            __ballot_sync(kFull, at_start && ev == 0) & own;
        if (ahead != 0 && kept_ahead<F>(tile, buf, n, t0, g)) keeps |= ahead;
        const bool kp = p >= 0 ? (keeps >> p) & 1 : keep;
        r.kind = (p >= 0 ? __popc(m.x & lt & from_p)
                         : cnt + __popc(m.x & lt)) - has_label;
        r.row = __ballot_sync(kFull, owned && kp && at_start);
        r.feat = __ballot_sync(kFull, owned && kp && cell && r.kind >= 0 &&
                                          r.kind < kCriteoFields);
        r.label = has_label ? r.row : 0u;
        in_line = (own >> last) & 1;
        keep = (keeps >> last) & 1;
        cnt = __popc(m.x & ~((1u << last) - 1));
      } else {
        const int idx = p >= 0 ? __popc(cells & lt & from_p)
                               : cnt + __popc(cells & lt);
        r.row = __ballot_sync(kFull, owned && cell && idx == 2);
        r.feat = __ballot_sync(kFull, owned && cell && idx >= 3);
        heads += __popc(__ballot_sync(kFull, owned && cell && idx == 0));
        in_line = (own >> last) & 1;
        cnt = __popc(cells & ~((1u << last) - 1));
      }
    }
    if (!F::kCriteo) r.label = r.row;  // adfea's row is its label token
    if (m.nl >> 31) in_line = false;  // a line break ends the group's line
    nl_before = m.nl >> 31;
    x_before = m.x >> 31;
    if (kEmit && (r.row | r.feat) != 0) {
      const bool is_row = (r.row >> lane) & 1, is_feat = (r.feat >> lane) & 1;
      const bool is_label = (r.label >> lane) & 1;
      const int row = rows + __popc(r.row & lt);
      const int feat = feats + __popc(r.feat & lt);
      if (is_row) {
        out.offset[row] = feat;
        if (!is_label) out.label[row] = 0u;  // criteo_test
      }
      const uint32_t q_m = r.label | r.feat;
      if (is_label || is_feat)
        queue[queued + __popc(q_m & lt)] = Entry{
            base + lane, is_label ? row : feat, is_label ? -1 : r.kind};
      queued += __popc(q_m);
      if (queued >= 32) {
        __syncwarp();
        convert_queue<F>(buf, n, t0, tile, queue, 32, out);
        queued -= 32;
        Entry rest{0, 0, 0};
        if (lane < queued) rest = queue[32 + lane];
        __syncwarp();
        if (lane < queued) queue[lane] = rest;
        __syncwarp();
      }
    }
    rows += __popc(r.row);
    feats += __popc(r.feat);
  }
  if (kEmit) {
    __syncwarp();
    if (queued > 0) convert_queue<F>(buf, n, t0, tile, queue, queued, out);
  }
  return WalkCount{rows, feats, heads};
}

// ------------------------------------------------------------- kernels
// Each warp's rows and features into warp_counts[tile * kTileWarps +
// warp]; the tile's rows, features, and a and b (RegionCount's, adfea's b
// its lines with a token) into counts[tile], its first byte outside the
// alphabet into errs[tile].
template <class F>
__global__ void __launch_bounds__(kTileThreads)
formats_count_kernel(const uint8_t* __restrict__ buf, int n, bool aligned,
                     int has_label, int4* __restrict__ counts,
                     int2* __restrict__ warp_counts,
                     unsigned int* __restrict__ errs) {
  __shared__ __align__(16) Tile tile;
  __shared__ int4 warp_sum[kTileWarps];
  __shared__ unsigned int warp_err[kTileWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kTile;
  load_tile(buf, n, t0, aligned, tile);
  RegionCount rc;
  mask_tile<F, true>(tile, n, t0, &rc);
  const WalkCount w = walk<F, false>(tile, buf, n, t0, has_label, 0, 0,
                                     nullptr, Out{});
  if (lane == 0) {
    warp_counts[blockIdx.x * kTileWarps + warp] = make_int2(w.rows, w.feats);
    warp_sum[warp] = make_int4(w.rows, w.feats, rc.a, rc.b + w.heads);
    warp_err[warp] = rc.err;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int4 s = make_int4(0, 0, 0, 0);
    unsigned e = ~0u;
    for (int k = 0; k < kTileWarps; ++k) {
      s.x += warp_sum[k].x;
      s.y += warp_sum[k].y;
      s.z += warp_sum[k].z;
      s.w += warp_sum[k].w;
      e = min(e, warp_err[k]);
    }
    counts[blockIdx.x] = s;
    errs[blockIdx.x] = e;
  }
}

// A CTA's exclusive prefix sum of one int a thread, and the total.
__device__ int block_scan(int v, int* total, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScanThreads / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    __syncwarp();
    warp_sum[lane] = w;
  }
  __syncthreads();
  const int out = incl - v + (warp > 0 ? warp_sum[warp - 1] : 0);
  *total = warp_sum[kScanThreads / 32 - 1];
  __syncthreads();
  return out;
}

// One CTA: each thread sums a run of tiles, the CTA scans the runs, and
// each thread gives its tiles their carry (rows and features before the
// tile). The chunk's cells (criteo: separators + 1) or tokens, and its
// lines (criteo: line breaks + 1; adfea: lines with a token), into stats.
__global__ void __launch_bounds__(kScanThreads)
formats_scan_kernel(const int4* __restrict__ counts,
                    const unsigned int* __restrict__ errs,
                    int2* __restrict__ carry, int tiles, int criteo,
                    int64_t* __restrict__ offset, int* __restrict__ stats) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ unsigned int err;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) err = ~0u;
  __syncthreads();
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = min(tiles, static_cast<int>(threadIdx.x) * per);
  const int t1 = min(tiles, t0 + per);
  int4 run = make_int4(0, 0, 0, 0);
  unsigned e = ~0u;
  for (int t = t0; t < t1; ++t) {
    const int4 c = counts[t];
    run.x += c.x;
    run.y += c.y;
    run.z += c.z;
    run.w += c.w;
    e = min(e, errs[t]);
  }
  e = __reduce_min_sync(kFull, e);
  if (lane == 0 && e != ~0u) atomicMin(&err, e);
  int rows_all, feats_all, a_all, b_all;
  int rows = block_scan(run.x, &rows_all, warp_sum);
  int feats = block_scan(run.y, &feats_all, warp_sum);
  block_scan(run.z, &a_all, warp_sum);
  block_scan(run.w, &b_all, warp_sum);
  for (int t = t0; t < t1; ++t) {
    carry[t] = make_int2(rows, feats);
    rows += counts[t].x;
    feats += counts[t].y;
  }
  if (threadIdx.x == 0) {
    stats[kErr] = static_cast<int>(err);
    stats[kNe1] = 0;
    stats[kBad] = 0;
    stats[kTokens] = a_all + criteo;
    stats[kLines] = b_all + criteo;
    stats[kRows] = rows_all;
    stats[kFeats] = feats_all;
    stats[kExact] = 0;
    stats[kBadAt] = -1;
    offset[rows_all] = feats_all;
  }
}

template <class F>
__global__ void __launch_bounds__(kTileThreads)
formats_emit_kernel(const uint8_t* __restrict__ buf, int n, bool aligned,
                    int has_label, const int2* __restrict__ carry,
                    const int2* __restrict__ warp_counts, Out out) {
  __shared__ __align__(16) Tile tile;
  __shared__ Entry queue[kTileWarps][kQueue];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kTile;
  load_tile(buf, n, t0, aligned, tile);
  mask_tile<F, false>(tile, n, t0, nullptr);
  // this warp's carry: the tile's, and the warps' before it
  const int2 c = carry[blockIdx.x];
  const int2 w = lane < warp ? warp_counts[blockIdx.x * kTileWarps + lane]
                             : make_int2(0, 0);
  const int rows = c.x + __reduce_add_sync(kFull, w.x);
  const int feats = c.y + __reduce_add_sync(kFull, w.y);
  walk<F, true>(tile, buf, n, t0, has_label, rows, feats, queue[warp], out);
}

int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

template <class F>
int run_parse(int has_label, const void* buf, int64_t n, void* label,
              void* offset, void* index, void* stats, void* scratch,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n >= (int64_t{1} << 30) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(tiles_for(n));
  int4* counts = static_cast<int4*>(scratch);
  int2* warp_counts = reinterpret_cast<int2*>(counts + tiles);
  int2* carry = warp_counts + static_cast<int64_t>(tiles) * kTileWarps;
  unsigned int* errs = reinterpret_cast<unsigned int*>(carry + tiles);
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  const bool aligned = (reinterpret_cast<uintptr_t>(buf) & 15) == 0;
  const Out out{static_cast<uint32_t*>(label), static_cast<int64_t*>(offset),
                static_cast<uint64_t*>(index), static_cast<int*>(stats)};
  formats_count_kernel<F><<<tiles, kTileThreads, 0, st>>>(
      b, static_cast<int>(n), aligned, has_label, counts, warp_counts, errs);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  formats_scan_kernel<<<1, kScanThreads, 0, st>>>(
      counts, errs, carry, tiles, F::kCriteo ? 1 : 0, out.offset, out.stats);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  formats_emit_kernel<F><<<tiles, kTileThreads, 0, st>>>(
      b, static_cast<int>(n), aligned, has_label, carry, warp_counts, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* wh_formats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// *bytes = the scratch (16-byte aligned) that wh_parse_criteo and
// wh_parse_adfea take for a chunk of n bytes; *slots = the int32 slots of
// their stats.
int wh_formats_scratch(int64_t n, void* bytes, void* slots) {
  if (n <= 0 || n >= (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<int64_t*>(bytes) =
      tiles_for(n) * (sizeof(int4) + (kTileWarps + 1) * sizeof(int2) +
                      sizeof(unsigned int));
  *static_cast<int64_t*>(slots) = kStats;
  return 0;
}

// The criteo (has_label) or criteo_test parse of a chunk of n bytes
// (0 < n < 2^30) on the stream, three launches. With tmax = (n + 1) / 2:
// label (f32 bits) and index (uint64) hold tmax entries, offset (int64)
// tmax + 1; stats kStats int32s; scratch wh_formats_scratch's
// bytes.
int wh_parse_criteo(int has_label, const void* buf, int64_t n, void* label,
                    void* offset, void* index, void* stats, void* scratch,
                    void* stream) {
  return run_parse<Criteo>(has_label ? 1 : 0, buf, n, label, offset, index,
                           stats, scratch, stream);
}

// The adfea parse of a chunk, as wh_parse_criteo's.
int wh_parse_adfea(const void* buf, int64_t n, void* label, void* offset,
                   void* index, void* stats, void* scratch, void* stream) {
  return run_parse<Adfea>(0, buf, n, label, offset, index, stats, scratch,
                          stream);
}

}  // extern "C"
