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
// non-ASCII whitespace) as separators; the port does not guess.
//
// Numbers: the shared grammar of parse_common.cuh (float() and int()
// exactly; Clinger's fast path, else the exact path dec_to_double).
//
// Design (simple first): five kernels with inclusive scans between them
// (torch.cumsum, in the wrapper):
//   1. classify_kernel, a thread a byte: token starts, and the first
//      byte outside the alphabet (atomicMin).
//      scan of the token starts -> tpos, each token's number.
//   2. token_kernel, a thread a byte at a token start: the token's start
//      and length, and whether it heads its line (a line break, or the
//      chunk's start, before it with only blanks between).
//      scan of the heads -> lno, each token's line.
//   3. line_kernel, a thread a token: a head marks its line kept unless
//      it starts with '#'.
//      scan of kept lines -> rowc, each line's row.
//   4. feat_kernel, a thread a token: a feature is a token of a kept line
//      that does not head it.
//      scan of the features -> fcum, each feature's slot.
//   5. value_kernel, a thread a token: labels, row offsets, keys, values,
//      the bad tokens, the counts (tokens, lines, rows, features, bad and
//      exact-path tokens) and the offset past the last row.
// Array sizes are bounds from the byte count n alone (tokens <= (n+1)/2),
// and every kernel reads the counts it needs from device memory, so a
// call makes no host sync; the wrapper reads the counts once, with the
// results.
//
// Bound: device memory, at 3.35 TB/s: the chunk's bytes once, and the
// outputs (label, offset, index, value) once. The scans, the byte flags
// and a byte-serial token loop a thread make this first version many
// times slower than that; a one-pass design (warp-level scans, a warp a
// line) is later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "parse_common.cuh"

namespace {

// ------------------------------------------------------------- kernels
// The scratch, one array each (the wrapper allocates them).
struct Scratch {
  int* tpos;        // n: tokens starting at or before each byte
  int* start;       // tmax
  int* len;         // tmax
  int* lno;         // tmax: line of each token, from 1
  int* rowc;        // tmax: row of each line, from 1
  int* fcum;        // tmax: features up to each token
  uint8_t* tflag;   // n: a token starts here
  uint8_t* head;    // tmax: the token heads its line
  uint8_t* keep;    // tmax: the line is no comment
  uint8_t* isfeat;  // tmax
  uint8_t* bad;     // tmax: the plain parser refuses the token
};

__global__ void line_kernel(const uint8_t* __restrict__ buf, int64_t n,
                            int64_t tmax, Scratch s) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= tmax || t >= num_tokens(s.tpos, n) || !s.head[t]) return;
  s.keep[s.lno[t] - 1] = buf[s.start[t]] != '#' ? 1 : 0;
}

__global__ void feat_kernel(int64_t n, int64_t tmax, Scratch s) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= tmax || t >= num_tokens(s.tpos, n)) return;
  // token 0 heads a line, so every token's line number is >= 1
  s.isfeat[t] = (!s.head[t] && s.keep[s.lno[t] - 1]) ? 1 : 0;
}

__global__ void value_kernel(const uint8_t* __restrict__ buf, int64_t n,
                             int64_t tmax, Scratch s,
                             uint32_t* __restrict__ label,
                             int64_t* __restrict__ offset,
                             uint64_t* __restrict__ index,
                             uint32_t* __restrict__ value,
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
  if (t >= tmax || t >= T) return;
  const uint8_t* p = buf + s.start[t];
  const int len = s.len[t];
  Conv conv = kConvFast;
  if (s.head[t]) {
    const int l = s.lno[t] - 1;
    if (s.keep[l]) {
      const int row = s.rowc[l] - 1;
      // a head is no feature, so fcum here counts the features before it
      offset[row] = s.fcum[t];
      double v;
      uint32_t f;
      conv = parse_float(p, len, &v, &f);
      if (conv != kConvBad) label[row] = f;
    }
  } else if (s.isfeat[t]) {
    const int f = s.fcum[t] - 1;
    int colon = 0;
    while (colon < len && p[colon] != ':') ++colon;
    uint64_t key = 0;
    double v = 1.0;
    uint32_t bits = 0x3f800000u;  // 1.0f
    if (!parse_key(p, colon, &key)) {
      conv = kConvBad;
    } else if (colon < len) {
      conv = parse_float(p + colon + 1, len - colon - 1, &v, &bits);
    }
    if (conv != kConvBad) {
      index[f] = key;
      value[f] = bits;
      if (v != 1.0) stats[kNe1] = 1;
    }
  }
  s.bad[t] = conv == kConvBad ? 1 : 0;
  if (conv == kConvBad) atomicAdd(&stats[kBad], 1);
  if (conv == kConvExact) atomicAdd(&stats[kExact], 1);
}

}  // namespace

extern "C" {

const char* wh_parse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One stage of the parse of a chunk of n bytes (0 < n < 2^30) on the
// stream: 0 classify (zeroes stats first), 1 tokens, 2 lines, 3 features,
// 4 values; the wrapper runs the scans between them. With tmax =
// (n + 1) / 2: tpos (int32) and tflag (uint8) hold n entries; start,
// len, lno, rowc, fcum (int32), head, keep, isfeat, bad (uint8), label,
// index and value hold tmax, offset tmax + 1; stats 8 int32s.
int wh_parse_libsvm(int stage, const void* buf, int64_t n, void* tpos,
                    void* start, void* len, void* lno, void* rowc,
                    void* fcum, void* tflag, void* head, void* keep,
                    void* isfeat, void* bad, void* label, void* offset,
                    void* index, void* value, void* stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n >= (int64_t{1} << 30) || stage < 0 || stage > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tmax = (n + 1) / 2;
  const Scratch s{static_cast<int*>(tpos),     static_cast<int*>(start),
                  static_cast<int*>(len),      static_cast<int*>(lno),
                  static_cast<int*>(rowc),     static_cast<int*>(fcum),
                  static_cast<uint8_t*>(tflag), static_cast<uint8_t*>(head),
                  static_cast<uint8_t*>(keep), static_cast<uint8_t*>(isfeat),
                  static_cast<uint8_t*>(bad)};
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  int* st32 = static_cast<int*>(stats);
  switch (stage) {
    case 0: {
      cudaError_t rc = cudaMemsetAsync(st32, 0, sizeof(int) * kStats, st);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      rc = cudaMemsetAsync(st32 + kErr, 0xff, sizeof(int), st);
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
      line_kernel<<<blocks_for(tmax), kThreads, 0, st>>>(b, n, tmax, s);
      break;
    case 3:
      feat_kernel<<<blocks_for(tmax), kThreads, 0, st>>>(n, tmax, s);
      break;
    default:
      value_kernel<<<blocks_for(tmax), kThreads, 0, st>>>(
          b, n, tmax, s, static_cast<uint32_t*>(label),
          static_cast<int64_t*>(offset), static_cast<uint64_t*>(index),
          static_cast<uint32_t*>(value), st32);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
