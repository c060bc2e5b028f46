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
// A token the plain parser refuses is marked bad; the wrapper raises
// ValueError naming the first.
//
// CityHash64: v1.1 (wormhole_tpu_torch/ops/hashing.py cityhash64, its
// contract), with all four length branches (0-16, 17-32, 33-64, the
// 64-byte loop), the byte swaps of HashLen33to64, and every 8- and 4-byte
// load assembled from single bytes in little-endian order: a cell starts
// at any byte, and a cast pointer there would be misaligned.
//
// Design (simple first, as parse.cu): kernels with inclusive scans
// between them (torch.cumsum, in the wrapper), a thread a byte to
// classify and a thread a cell or token to convert or hash.
//   criteo (cells: at most n + 1, one more than the separators):
//   0. classify_cells_kernel, a thread a byte: separators ('\t', '\r',
//      '\n') and the first byte outside the alphabet.
//      scan -> spos, each separator's cell.
//   1. cell_kernel, a thread a separator (and one for the chunk's end):
//      each cell's end, and whether a line starts at the next cell (the
//      separator is a line break).
//      scan of the heads -> lno, each cell's line.
//   2. cell_line_kernel, a thread a cell: each line's first cell, and a
//      line is kept if some cell holds a byte other than ' '.
//      scan of kept lines -> rowc, each line's row.
//   3. cell_feat_kernel, a thread a cell: a feature is a nonempty field
//      cell below 39 of a kept line.
//      scan of the features -> fcum, each feature's slot.
//   4. cell_value_kernel, a thread a cell: labels, row offsets, keys, the
//      bad labels and the counts.
//   adfea (tokens: at most (n + 1) / 2):
//   0. classify_kernel and 1. token_kernel (below), with
//      their scans (tpos, lno).
//   2. adfea_line_kernel, a thread a token: a line is kept if its head
//      has two more tokens on its line; a feature is a token with three
//      before it on its line.
//      scans -> rowc and fcum.
//   3. adfea_value_kernel, a thread a token: labels, row offsets, keys,
//      the bad tokens and the counts.
// Array sizes are bounds from n alone, every kernel reads the counts it
// needs from device memory, and a call makes no host sync.
//
// Bound: device memory, at 3.35 TB/s: the chunk's bytes once, and the
// outputs (label, offset, index) once. The scans over byte- and
// cell-sized flags and the byte-serial loops a thread make this first
// version many times slower than that, as parse.cu is.

#include <cstdint>

#include <cuda_runtime.h>

#include "parse_common.cuh"

namespace {

constexpr int kThreads = 256;

unsigned blocks_for(int64_t items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

// ------------------------------------------------------ tokens (adfea)
// classify_kernel and token_kernel cut a chunk into parse_common.cuh's
// tokens and mark the first of each line.
__device__ __forceinline__ int num_tokens(const int* tpos, int64_t n) {
  return n > 0 ? tpos[n - 1] : 0;
}

__global__ void classify_kernel(const uint8_t* __restrict__ buf, int64_t n,
                                uint8_t* __restrict__ tflag,
                                unsigned int* __restrict__ err) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t c = buf[i];
  if (!in_alphabet(c)) atomicMin(err, static_cast<unsigned int>(i));
  tflag[i] = (!is_sep(c) && (i == 0 || is_sep(buf[i - 1]))) ? 1 : 0;
}

__global__ void token_kernel(const uint8_t* __restrict__ buf, int64_t n,
                             const uint8_t* __restrict__ tflag,
                             const int* __restrict__ tpos,
                             int* __restrict__ start, int* __restrict__ len,
                             uint8_t* __restrict__ head) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !tflag[i]) return;
  const int t = tpos[i] - 1;
  int64_t j = i + 1;
  while (j < n && !is_sep(buf[j])) ++j;
  start[t] = static_cast<int>(i);
  len[t] = static_cast<int>(j - i);
  // the chunk's first token heads a line; so does one after a line break
  bool is_head = true;
  for (int64_t k = i - 1; k >= 0; --k) {
    const uint8_t c = buf[k];
    if (is_nl(c)) break;
    if (!is_sep(c)) {
      is_head = false;
      break;
    }
  }
  head[t] = is_head ? 1 : 0;
}


constexpr int kCriteoFields = 39;

// ------------------------------------------------------------ cityhash64
constexpr uint64_t kK0 = 0xc3a5c85c97cb3127ull;
constexpr uint64_t kK1 = 0xb492b66fbe98f273ull;
constexpr uint64_t kK2 = 0x9ae16a3b2f90404full;
constexpr uint64_t kMul = 0x9ddfea08eb382d69ull;

__device__ __forceinline__ uint64_t fetch64(const uint8_t* p) {
  uint64_t r = 0;
  for (int i = 7; i >= 0; --i) r = (r << 8) | p[i];
  return r;
}

__device__ __forceinline__ uint64_t fetch32(const uint8_t* p) {
  return static_cast<uint64_t>(p[0]) | (static_cast<uint64_t>(p[1]) << 8) |
         (static_cast<uint64_t>(p[2]) << 16) |
         (static_cast<uint64_t>(p[3]) << 24);
}

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

__device__ uint64_t hash_len0to16(const uint8_t* s, int n) {
  if (n >= 8) {
    const uint64_t mul = kK2 + static_cast<uint64_t>(n) * 2;
    const uint64_t a = fetch64(s) + kK2;
    const uint64_t b = fetch64(s + n - 8);
    const uint64_t c = rotr(b, 37) * mul + a;
    const uint64_t d = (rotr(a, 25) + b) * mul;
    return hash_len16(c, d, mul);
  }
  if (n >= 4) {
    const uint64_t mul = kK2 + static_cast<uint64_t>(n) * 2;
    const uint64_t a = fetch32(s);
    return hash_len16(n + (a << 3), fetch32(s + n - 4), mul);
  }
  if (n > 0) {
    const uint64_t a = s[0], b = s[n >> 1], c = s[n - 1];
    const uint64_t y = a + (b << 8);
    const uint64_t z = n + (c << 2);
    return shift_mix(y * kK2 ^ z * kK0) * kK2;
  }
  return kK2;
}

__device__ uint64_t hash_len17to32(const uint8_t* s, int n) {
  const uint64_t mul = kK2 + static_cast<uint64_t>(n) * 2;
  const uint64_t a = fetch64(s) * kK1;
  const uint64_t b = fetch64(s + 8);
  const uint64_t c = fetch64(s + n - 8) * mul;
  const uint64_t d = fetch64(s + n - 16) * kK2;
  return hash_len16(rotr(a + b, 43) + rotr(c, 30) + d,
                    a + rotr(b + kK2, 18) + c, mul);
}

__device__ uint64_t hash_len33to64(const uint8_t* s, int n) {
  const uint64_t mul = kK2 + static_cast<uint64_t>(n) * 2;
  uint64_t a = fetch64(s) * kK2;
  uint64_t b = fetch64(s + 8);
  const uint64_t c = fetch64(s + n - 24);
  const uint64_t d = fetch64(s + n - 32);
  const uint64_t e = fetch64(s + 16) * kK2;
  const uint64_t f = fetch64(s + 24) * 9;
  const uint64_t g = fetch64(s + n - 8);
  const uint64_t h = fetch64(s + n - 16) * mul;
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

__device__ __forceinline__ Pair weak32_at(const uint8_t* s, uint64_t a,
                                          uint64_t b) {
  return weak32(fetch64(s), fetch64(s + 8), fetch64(s + 16), fetch64(s + 24),
                a, b);
}

// CityHash64 v1.1 of s[0..n).
__device__ uint64_t cityhash64(const uint8_t* s, int n) {
  if (n <= 16) return hash_len0to16(s, n);
  if (n <= 32) return hash_len17to32(s, n);
  if (n <= 64) return hash_len33to64(s, n);
  uint64_t x = fetch64(s + n - 40);
  uint64_t y = fetch64(s + n - 16) + fetch64(s + n - 56);
  uint64_t z = hash_len16(fetch64(s + n - 48) + n, fetch64(s + n - 24), kMul);
  Pair v = weak32_at(s + n - 64, n, z);
  Pair w = weak32_at(s + n - 32, y + kK1, x);
  x = x * kK1 + fetch64(s);
  int rem = (n - 1) & ~63;
  const uint8_t* p = s;
  do {
    x = rotr(x + y + v.first + fetch64(p + 8), 37) * kK1;
    y = rotr(y + v.second + fetch64(p + 48), 42) * kK1;
    x ^= w.second;
    y += v.first + fetch64(p + 40);
    z = rotr(z + w.first, 33) * kK1;
    v = weak32_at(p, v.second * kK1, x + w.first);
    w = weak32_at(p + 32, z + w.second, y + fetch64(p + 16));
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

// ------------------------------------------------------------- kernels
__device__ __forceinline__ bool is_cell_sep(uint8_t c) {
  return c == '\t' || is_nl(c);
}

// criteo's scratch, one array each (the wrapper allocates them); cmax =
// n + 1 entries unless noted.
struct Cells {
  int* spos;        // n: separators at or before each byte
  uint8_t* sflag;   // n: a separator
  int* cend;        // each cell's end (its separator's offset, or n)
  uint8_t* head;    // the cell starts its line
  int* lno;         // each cell's line, from 1
  int* lfirst;      // each line's first cell
  uint8_t* keep;    // the line is not blank (zeroed in stage 0)
  int* rowc;        // each line's row, from 1
  uint8_t* isfeat;  // the cell is a feature
  int* fcum;        // features up to each cell
  uint8_t* bad;     // the cell is a label the plain parser refuses
};

__device__ __forceinline__ int num_cells(const int* spos, int64_t n) {
  return spos[n - 1] + 1;
}

__device__ __forceinline__ int cell_start(const int* cend, int k) {
  return k == 0 ? 0 : cend[k - 1] + 1;
}

__global__ void classify_cells_kernel(const uint8_t* __restrict__ buf,
                                      int64_t n,
                                      uint8_t* __restrict__ sflag,
                                      unsigned int* __restrict__ err) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t c = buf[i];
  if (!in_alphabet(c)) atomicMin(err, static_cast<unsigned int>(i));
  sflag[i] = is_cell_sep(c) ? 1 : 0;
}

__global__ void cell_kernel(const uint8_t* __restrict__ buf, int64_t n,
                            Cells s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i > n) return;
  if (i == n) {  // the last cell ends the chunk; the first starts a line
    s.cend[num_cells(s.spos, n) - 1] = static_cast<int>(n);
    s.head[0] = 1;
    return;
  }
  if (!s.sflag[i]) return;
  const int k = s.spos[i] - 1;
  s.cend[k] = static_cast<int>(i);
  s.head[k + 1] = is_nl(buf[i]) ? 1 : 0;  // a line break ends cell k
}

__global__ void cell_line_kernel(const uint8_t* __restrict__ buf, int64_t n,
                                 Cells s) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= num_cells(s.spos, n)) return;
  const int l = s.lno[k] - 1;
  if (s.head[k]) s.lfirst[l] = static_cast<int>(k);
  const int end = s.cend[k];
  for (int i = cell_start(s.cend, k); i < end; ++i) {
    if (buf[i] != ' ') {
      s.keep[l] = 1;
      break;
    }
  }
}

__global__ void cell_feat_kernel(int64_t n, int has_label, Cells s) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= num_cells(s.spos, n)) return;
  const int l = s.lno[k] - 1;
  const int64_t field = k - s.lfirst[l] - has_label;
  const bool nonempty = s.cend[k] > cell_start(s.cend, k);
  s.isfeat[k] = (s.keep[l] && field >= 0 && field < kCriteoFields &&
                 nonempty) ? 1 : 0;
}

__global__ void cell_value_kernel(const uint8_t* __restrict__ buf,
                                  int64_t n, int has_label, Cells s,
                                  uint32_t* __restrict__ label,
                                  int64_t* __restrict__ offset,
                                  uint64_t* __restrict__ index,
                                  int* __restrict__ stats) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int S = num_cells(s.spos, n);
  if (k == 0) {
    const int lines = s.lno[S - 1];
    const int rows = s.rowc[lines - 1];
    const int feats = s.fcum[S - 1];
    stats[kTokens] = S;
    stats[kLines] = lines;
    stats[kRows] = rows;
    stats[kFeats] = feats;
    offset[rows] = feats;
  }
  if (k >= S) return;
  const int l = s.lno[k] - 1;
  int beg = cell_start(s.cend, k), end = s.cend[k];
  s.bad[k] = 0;
  if (s.head[k] && s.keep[l]) {
    const int row = s.rowc[l] - 1;
    offset[row] = s.fcum[k] - s.isfeat[k];
    uint32_t bits = 0;
    if (has_label) {  // float() strips the cell's spaces
      while (beg < end && buf[beg] == ' ') ++beg;
      while (end > beg && buf[end - 1] == ' ') --end;
      double v;
      const Conv conv = parse_float(buf + beg, end - beg, &v, &bits);
      if (conv == kConvBad) {
        s.bad[k] = 1;
        atomicAdd(&stats[kBad], 1);
      } else if (conv == kConvExact) {
        atomicAdd(&stats[kExact], 1);
      }
    }
    label[row] = bits;
  }
  if (s.isfeat[k]) {  // without a label, a line's first cell is field 0
    const uint64_t field = k - s.lfirst[l] - has_label;
    index[s.fcum[k] - 1] =
        (cityhash64(buf + beg, end - beg) >> 10) | (field << 54);
  }
}

// adfea's scratch; tmax = (n + 1) / 2 entries unless noted.
struct Tokens {
  int* tpos;        // n: tokens starting at or before each byte
  uint8_t* tflag;   // n: a token starts here
  int* start;
  int* len;
  uint8_t* head;    // the token heads its line
  int* lno;         // each token's line, from 1
  uint8_t* keep;    // the line has three tokens or more
  int* rowc;        // each line's row, from 1
  uint8_t* isfeat;  // the token is a feature (three before it on its line)
  int* fcum;        // features up to each token
  uint8_t* bad;     // the plain parser refuses the token
};

__global__ void adfea_line_kernel(int64_t n, Tokens s) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int T = num_tokens(s.tpos, n);
  if (t >= T) return;
  if (s.head[t])
    s.keep[s.lno[t] - 1] = (t + 2 < T && !s.head[t + 1] && !s.head[t + 2])
                               ? 1 : 0;
  s.isfeat[t] = (t >= 3 && !s.head[t] && !s.head[t - 1] && !s.head[t - 2])
                    ? 1 : 0;
}

__global__ void adfea_value_kernel(const uint8_t* __restrict__ buf,
                                   int64_t n, Tokens s,
                                   uint32_t* __restrict__ label,
                                   int64_t* __restrict__ offset,
                                   uint64_t* __restrict__ index,
                                   int* __restrict__ stats) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int T = num_tokens(s.tpos, n);
  if (t == 0) {
    const int lines = T > 0 ? s.lno[T - 1] : 0;
    const int rows = lines > 0 ? s.rowc[lines - 1] : 0;
    const int feats = T > 0 ? s.fcum[T - 1] : 0;
    stats[kTokens] = T;
    stats[kLines] = lines;
    stats[kRows] = rows;
    stats[kFeats] = feats;
    offset[rows] = feats;
  }
  if (t >= T) return;
  const uint8_t* p = buf + s.start[t];
  const int len = s.len[t];
  bool ok = true;
  if (t >= 2 && s.head[t - 2] && !s.head[t - 1] && !s.head[t]) {  // label
    const int row = s.rowc[s.lno[t] - 1] - 1;
    offset[row] = s.fcum[t];
    double v = 0.0;
    uint32_t bits;
    const Conv conv = parse_float(p, len, &v, &bits);
    ok = conv != kConvBad;
    if (conv == kConvExact) atomicAdd(&stats[kExact], 1);
    label[row] = v > 0.0 ? 0x3f800000u : 0u;  // nan > 0 is false
  } else if (s.isfeat[t]) {
    uint64_t key = 0;
    ok = adfea_key(p, len, &key);
    index[s.fcum[t] - 1] = key;
  }
  s.bad[t] = ok ? 0 : 1;
  if (!ok) atomicAdd(&stats[kBad], 1);
}

cudaError_t clear_stats(int* stats, cudaStream_t st) {
  cudaError_t rc = cudaMemsetAsync(stats, 0, sizeof(int) * kStats, st);
  if (rc != cudaSuccess) return rc;
  return cudaMemsetAsync(stats + kErr, 0xff, sizeof(int), st);
}

}  // namespace

extern "C" {

const char* wh_formats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One stage of the criteo parse of a chunk of n bytes (0 < n < 2^30) on
// the stream: 0 classify (zeroes stats and keep first), 1 cells, 2 lines,
// 3 features, 4 values; the wrapper runs the scans between them
// (sflag -> spos, head -> lno, keep -> rowc, isfeat -> fcum). With cmax =
// n + 1: spos (int32) and sflag (uint8) hold n entries; cend, lno,
// lfirst, rowc, fcum (int32), head, keep, isfeat, bad (uint8),
// label (f32) and index (uint64) hold cmax, offset (int64) cmax + 1;
// stats 8 int32s.
int wh_parse_criteo(int stage, int has_label, const void* buf, int64_t n,
                    void* spos, void* sflag, void* cend, void* head,
                    void* lno, void* lfirst, void* keep,
                    void* rowc, void* isfeat, void* fcum, void* bad,
                    void* label, void* offset, void* index, void* stats,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n >= (int64_t{1} << 30) || stage < 0 || stage > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cmax = n + 1;
  const Cells s{static_cast<int*>(spos),    static_cast<uint8_t*>(sflag),
                static_cast<int*>(cend),    static_cast<uint8_t*>(head),
                static_cast<int*>(lno),     static_cast<int*>(lfirst),
                static_cast<uint8_t*>(keep), static_cast<int*>(rowc),
                static_cast<uint8_t*>(isfeat), static_cast<int*>(fcum),
                static_cast<uint8_t*>(bad)};
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  int* st32 = static_cast<int*>(stats);
  const int hl = has_label ? 1 : 0;
  switch (stage) {
    case 0: {
      cudaError_t rc = clear_stats(st32, st);
      if (rc == cudaSuccess) rc = cudaMemsetAsync(s.keep, 0, cmax, st);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      classify_cells_kernel<<<blocks_for(n), kThreads, 0, st>>>(
          b, n, s.sflag, reinterpret_cast<unsigned int*>(st32 + kErr));
      break;
    }
    case 1:
      cell_kernel<<<blocks_for(n + 1), kThreads, 0, st>>>(b, n, s);
      break;
    case 2:
      cell_line_kernel<<<blocks_for(cmax), kThreads, 0, st>>>(b, n, s);
      break;
    case 3:
      cell_feat_kernel<<<blocks_for(cmax), kThreads, 0, st>>>(n, hl, s);
      break;
    default:
      cell_value_kernel<<<blocks_for(cmax), kThreads, 0, st>>>(
          b, n, hl, s, static_cast<uint32_t*>(label),
          static_cast<int64_t*>(offset), static_cast<uint64_t*>(index),
          st32);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// One stage of the adfea parse of a chunk of n bytes (0 < n < 2^30) on
// the stream: 0 classify (zeroes stats first), 1 tokens, 2 lines and
// features, 3 values; the wrapper runs the scans between them (tflag ->
// tpos, head -> lno, then keep -> rowc and isfeat -> fcum). With tmax =
// (n + 1) / 2: tpos (int32) and tflag (uint8) hold n entries; start,
// len, lno, rowc, fcum (int32), head, keep, isfeat, bad (uint8), label
// (f32) and index (uint64) hold tmax, offset (int64) tmax + 1; stats 8
// int32s.
int wh_parse_adfea(int stage, const void* buf, int64_t n, void* tpos,
                   void* tflag, void* start, void* len, void* head,
                   void* lno, void* keep, void* rowc, void* isfeat,
                   void* fcum, void* bad, void* label, void* offset,
                   void* index, void* stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n >= (int64_t{1} << 30) || stage < 0 || stage > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tmax = (n + 1) / 2;
  const Tokens s{static_cast<int*>(tpos),     static_cast<uint8_t*>(tflag),
                 static_cast<int*>(start),    static_cast<int*>(len),
                 static_cast<uint8_t*>(head), static_cast<int*>(lno),
                 static_cast<uint8_t*>(keep), static_cast<int*>(rowc),
                 static_cast<uint8_t*>(isfeat), static_cast<int*>(fcum),
                 static_cast<uint8_t*>(bad)};
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  int* st32 = static_cast<int*>(stats);
  switch (stage) {
    case 0: {
      const cudaError_t rc = clear_stats(st32, st);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      classify_kernel<<<blocks_for(n), kThreads, 0, st>>>(
          b, n, s.tflag, reinterpret_cast<unsigned int*>(st32 + kErr));
      break;
    }
    case 1:
      token_kernel<<<blocks_for(n), kThreads, 0, st>>>(b, n, s.tflag, s.tpos,
                                                    s.start, s.len, s.head);
      break;
    case 2:
      adfea_line_kernel<<<blocks_for(tmax), kThreads, 0, st>>>(n, s);
      break;
    default:
      adfea_value_kernel<<<blocks_for(tmax), kThreads, 0, st>>>(
          b, n, s, static_cast<uint32_t*>(label),
          static_cast<int64_t*>(offset), static_cast<uint64_t*>(index),
          st32);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
