// The GBDT level histogram, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of wormhole_tpu/ops/hist.py:
//   level_hist (_hist_kernel, :52; wrapper :79)
//
// Computes, for one tree level,
//   G[n, f, b] = sum of g[r] over rows r with rel[r] == n, binned[r, f] == b
//   H[n, f, b] = the same sum of h[r]
// for n < num_nodes. binned is (rows, F) uint8, g and h are (rows,) f32,
// rel is (rows,) int32; a row whose rel is outside [0, num_nodes) is in no
// node of the level and adds nothing, and neither does a bin id >= B
// (B <= 256). The output is exactly (2, num_nodes, F, B) f32: G first,
// then H. A cell that no row reaches is exactly 0.0.
//
// The TPU kernel restates the sum as one-hot matmuls to fill the MXU (a
// node one-hot operand weighted by bf16 hi/lo planes of g and h, nodes
// padded to 8, rows padded to 4096-row blocks). None of that is carried
// over. Here the level's rows are first grouped by node, on the device,
// and the sums are exact integer adds, so that every launch gives the
// same bits whatever order the card takes them in:
//
// 0. Fixed point. Each g is taken as the int64 nearest g * 2^sg (h as
//    h * 2^sh), the sums are int64, and each cell becomes f32 once, at
//    the end, as the double of its sum times 2^-sg rounded to f32. sg is
//    a function of the level's inputs alone: with max|g| < 2^e over the
//    level's finite g and its rows <= 2^r, sg = 62 - r - e, so that no
//    term exceeds 2^(62 - r) and no sum 2^62. A term is then off by at
//    most 2^(r + e - 63): a cell of the bench's largest level (2^21
//    rows) by at most 2^(e - 21), some 1e-6 of max|g|, where one f32 ulp
//    of such a sum is far larger. A level of all-zero g gives zeros. A
//    non-finite g adds nothing to the integer sum; it sets a flag of its
//    cell (+inf, -inf, nan), and the cell becomes what an f32 sum gives:
//    nan where a nan or both infinities came, else the infinity.
// 1. Partition (three launches). partition_count_kernel: a CTA counts the
//    rows of its 8,192-row chunk per node (each warp its own 512 rows,
//    match_any to add a group of equal nodes at once), and takes the
//    level's max |g| and |h| over finite values (an integer atomicMax of
//    their f32 bits, which gives the same answer in any order).
//    partition_scan_kernel (one CTA): an exclusive scan of those counts,
//    node-major, so that node n's rows start at node_start[n].
//    partition_scatter_kernel: writes each row id to its place in
//    order[], in row order within each node. Nothing comes back to the
//    host: the histogram kernel reads node_start and the maxima from
//    device memory, and the grid is sized from rows alone.
// 2. level_hist_kernel: a grid of resident CTAs. The level costs its
//    rows plus kNodeCost a node (a node's merge, in rows), and CTA c
//    takes the c-th even share of that cost: a run of order[] that may
//    span a few nodes. So a CTA reads only rows of the level, node by
//    node, whatever the node count; a node of 1.9M rows beside nodes of
//    a hundred spreads over the card by rows, and a CTA whose share
//    holds many small nodes takes fewer rows. For each node of its share
//    the CTA accumulates into its tile, then adds the tile into an int64
//    accumulator in device memory and clears it.
//    - A warp takes 32 rows at a time. Lane i reads row i's bin bytes as
//      words (bytes where rows are not word-aligned) and its g and h,
//      and stages them in shared memory, g and h already in fixed point;
//      the loads of the next 32 rows are issued before this group's
//      adds, so the adds never wait on device memory.
//    - The tile: a column per lane, B rows of 32 columns, each cell an
//      int64 held as two 32-bit words, a low one (unsigned) and a high
//      one: 128 KB at B = 256, so one CTA of 1024 threads an SM. A pass
//      holds one row, one lane per feature (32 / F rows where F <= 16,
//      each in its own columns, summed at the merge), and lane l adds to
//      column l: its bank is l, so no bank conflict and no two lanes on
//      one address, whatever the bins. sm_90's shared-memory add of 64
//      bits is no native instruction (ATOMS.CAST.SPIN.64, a
//      compare-and-swap loop); its 32-bit integer add is (ATOMS.ADD). So
//      a value v goes in as its low word, whose add returns the word
//      before it, and its high word plus the carry out of the low add:
//      the pair is v's sum modulo 2^64, in any order, and the true sum
//      lies within int64. A lane sums a run of equal
//      bins in registers and adds it once, so a feature with few
//      distinct values (0/1 bins) costs fewer adds. F > 32 is cut into
//      feature tiles of at most 32 (blockIdx.y).
//    - The merge: a thread sums a cell over its columns and adds it to
//      the accumulator with the native 64-bit device-memory atomic; then
//      the CTA adds its share of the node's rows to the node's ticket,
//      and the CTA whose add completes the node's rows converts the
//      node's cells (of its feature tile) to f32 in the output. Merges
//      per level: at most one per CTA plus one per node.
//
// Bound: device memory, at 3.35 TB/s: rel of every row; g, h and the F
// bin bytes of each row in the level; the output once. The partition
// adds rel read twice, g and h read once more and order written and
// read. The f32 version of this kernel was bound by sm_90's
// shared-memory f32 add, a compare-and-swap loop (ATOMS.CAST.SPIN), two
// per (row, feature); here the adds are native integer ones, but four
// per (row, feature) run, two of them waiting on the adds before them,
// and the merge's 64-bit device-memory adds: on the H100 a level takes
// about 1.4 times the f32 version's time (PERF.md).
//
// Plain C entry points, loaded with ctypes by ops/_cuda.py. Every entry
// enqueues on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// partition: a CTA's chunk is kPartWarps warps x kPartSteps steps of 32
// rows; per-warp node counters for kNodeWindow nodes at a time (64 KB)
constexpr int kPartThreads = 512;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kPartSteps = 16;
constexpr int kWarpRows = 32 * kPartSteps;
constexpr int kChunk = kPartWarps * kWarpRows;
constexpr int kNodeWindow = 1024;
constexpr int kScanThreads = 1024;

// histogram
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;          // tile columns: one per lane
constexpr int kMinCtaRows = 512;   // rows per CTA below which fewer CTAs run
// What a CTA's merge of one node costs, in rows: a CTA's share of the
// level is an even share of rows + kNodeCost x nodes
constexpr int64_t kNodeCost = 256;
// fixed point: no level sum reaches 2^kFixedBits
constexpr int kFixedBits = 62;
// a term's non-finite flags, g's in bits 0-2, h's in bits 3-5
constexpr uint32_t kPosInf = 1, kNegInf = 2, kNan = 4;
constexpr int kHFlags = 3;

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Scratch, in int32s: [node_start: num_nodes + 1][order: rows][counts:
// num_nodes * chunks]. The first two are the partition's result
// (ops/hist.py reads them there).
struct Scratch {
  int* node_start;
  int* order;
  int* counts;
};

inline int64_t chunks_for(int64_t rows) { return (rows + kChunk - 1) / kChunk; }

inline int64_t scratch_ints(int64_t rows, int num_nodes) {
  return static_cast<int64_t>(num_nodes) + 1 + rows +
         static_cast<int64_t>(num_nodes) * chunks_for(rows);
}

inline Scratch carve(int* base, int64_t rows, int num_nodes) {
  Scratch s;
  s.node_start = base;
  s.order = s.node_start + num_nodes + 1;
  s.counts = s.order + rows;
  return s;
}

// ---------------------------------------------------------- partition
// Warp w of CTA c owns rows [c * kChunk + w * kWarpRows, + kWarpRows);
// step i reads row base + 32 i + lane. Rows past the end read as -1.
__device__ __forceinline__ void load_rel(const int* __restrict__ rel,
                                         int64_t rows, int64_t warp0,
                                         int (&nd)[kPartSteps]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kPartSteps; ++i) {
    const int64_t r = warp0 + 32 * i + lane;
    nd[i] = r < rows ? rel[r] : -1;
  }
}

// Adds this warp's rows of nodes [w0, w0 + win) into wc[node - w0], a
// counter row of the warp's own: the first lane of each group of equal
// nodes adds the group's size, so one step's lanes never share a counter.
__device__ __forceinline__ void count_window(const int (&nd)[kPartSteps],
                                             int w0, int win, int* wc) {
#pragma unroll
  for (int i = 0; i < kPartSteps; ++i) {
    const bool in = nd[i] >= w0 && nd[i] < w0 + win;
    const unsigned peers = __match_any_sync(kFull, in ? nd[i] - w0 : -1);
    if (in && (peers & lanemask_lt()) == 0) wc[nd[i] - w0] += __popc(peers);
  }
}

// |x|'s f32 bits where x is finite, else 0
__device__ __forceinline__ uint32_t finite_abs_bits(float x) {
  const uint32_t b = __float_as_uint(x) & 0x7fffffffu;
  return b < 0x7f800000u ? b : 0u;
}

// counts[n * chunks + c] = the rows of chunk c in node n. Where maxbits
// is given, maxbits[0] and [1] also take the largest f32 bits of a
// finite |g| and |h| over the rows of the level (zeroed by the caller).
__global__ void __launch_bounds__(kPartThreads)
partition_count_kernel(const int* __restrict__ rel,
                       const float* __restrict__ g,
                       const float* __restrict__ h, int* __restrict__ counts,
                       unsigned int* __restrict__ maxbits, int64_t rows,
                       int num_nodes, int chunks) {
  extern __shared__ int wcnt[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t warp0 =
      static_cast<int64_t>(blockIdx.x) * kChunk + warp * kWarpRows;
  int nd[kPartSteps];
  load_rel(rel, rows, warp0, nd);
  if (maxbits != nullptr) {
    uint32_t mg = 0, mh = 0;
#pragma unroll
    for (int i = 0; i < kPartSteps; ++i) {
      if (nd[i] >= 0 && nd[i] < num_nodes) {
        const int64_t r = warp0 + 32 * i + lane;
        mg = max(mg, finite_abs_bits(g[r]));
        mh = max(mh, finite_abs_bits(h[r]));
      }
    }
    mg = __reduce_max_sync(kFull, mg);
    mh = __reduce_max_sync(kFull, mh);
    if (lane == 0 && mg != 0) atomicMax(&maxbits[0], mg);
    if (lane == 0 && mh != 0) atomicMax(&maxbits[1], mh);
  }
  for (int w0 = 0; w0 < num_nodes; w0 += kNodeWindow) {
    const int win = min(kNodeWindow, num_nodes - w0);
    for (int i = threadIdx.x; i < kPartWarps * win; i += kPartThreads)
      wcnt[i] = 0;
    __syncthreads();
    count_window(nd, w0, win, wcnt + warp * win);
    __syncthreads();
    for (int n = threadIdx.x; n < win; n += kPartThreads) {
      int s = 0;
      for (int w = 0; w < kPartWarps; ++w) s += wcnt[w * win + n];
      counts[static_cast<int64_t>(w0 + n) * chunks + blockIdx.x] = s;
    }
    __syncthreads();
  }
}

// Exclusive scan of one int a thread over the CTA; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? sh[warp - 1] : 0);
  *total = sh[nwarps - 1];
  __syncthreads();
  return excl;
}

// One CTA. counts becomes exclusive offsets (node-major, so node n's
// rows start at node_start[n] and chunk c's rows of n follow chunk c-1's):
// each warp scans its own contiguous range, 32 counts a step (coalesced),
// from the sum of the ranges before it.
__global__ void __launch_bounds__(kScanThreads)
partition_scan_kernel(int* __restrict__ counts, int* __restrict__ node_start,
                      int num_nodes, int chunks) {
  __shared__ int sh[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_all = static_cast<int64_t>(num_nodes) * chunks;
  const int64_t per = (n_all + kScanThreads / 32 - 1) / (kScanThreads / 32);
  const int64_t lo = min64(n_all, warp * per);
  const int64_t hi = min64(n_all, lo + per);
  int s = 0;
  for (int64_t i = lo + lane; i < hi; i += 32) s += counts[i];
  s = __reduce_add_sync(kFull, s);
  int total;
  int run = __shfl_sync(
      kFull, block_exclusive_scan(lane == 0 ? s : 0, sh, &total), 0);
#pragma unroll 4
  for (int64_t i = lo; i < hi; i += 32) {
    const int64_t j = i + lane;
    const int v = j < hi ? counts[j] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (j < hi) counts[j] = run + x - v;
    run += __shfl_sync(kFull, x, 31);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < num_nodes; n += kScanThreads)
    node_start[n] = counts[static_cast<int64_t>(n) * chunks];
  if (threadIdx.x == 0) node_start[num_nodes] = total;
}

// order[offset of (node, chunk) + rank] = row: the warps' counts give
// each warp its start in every node, and a step's rows of one node take
// consecutive places in lane order, so rows keep their order in a node.
__global__ void __launch_bounds__(kPartThreads)
partition_scatter_kernel(const int* __restrict__ rel,
                         const int* __restrict__ offsets,
                         int* __restrict__ order, int64_t rows,
                         int num_nodes, int chunks) {
  extern __shared__ int wcnt[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t warp0 =
      static_cast<int64_t>(blockIdx.x) * kChunk + warp * kWarpRows;
  int nd[kPartSteps];
  load_rel(rel, rows, warp0, nd);
  for (int w0 = 0; w0 < num_nodes; w0 += kNodeWindow) {
    const int win = min(kNodeWindow, num_nodes - w0);
    for (int i = threadIdx.x; i < kPartWarps * win; i += kPartThreads)
      wcnt[i] = 0;
    __syncthreads();
    int* wc = wcnt + warp * win;
    count_window(nd, w0, win, wc);
    __syncthreads();
    for (int n = threadIdx.x; n < win; n += kPartThreads) {
      int run = offsets[static_cast<int64_t>(w0 + n) * chunks + blockIdx.x];
      for (int w = 0; w < kPartWarps; ++w) {
        const int t = wcnt[w * win + n];
        wcnt[w * win + n] = run;
        run += t;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPartSteps; ++i) {
      const bool in = nd[i] >= w0 && nd[i] < w0 + win;
      const unsigned peers = __match_any_sync(kFull, in ? nd[i] - w0 : -1);
      if (in)
        order[wc[nd[i] - w0] + __popc(peers & lanemask_lt())] =
            static_cast<int>(warp0 + 32 * i + lane);
      __syncwarp();
      if (in && (peers & lanemask_lt()) == 0) wc[nd[i] - w0] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------- histogram
// A warp's group of 32 rows, staged in shared memory: the tile's bin bytes
// of each row (an odd stride of words, so that lane i's stores of row i
// hit distinct banks), then the rows' fixed-point (g, h).
constexpr int kRowWords = kCols / 4;
constexpr int kBinWords = 32 * (kRowWords + 1);
constexpr int kStageWords = kBinWords + 32 * 4;

// The fixed-point exponent s of a level's sums (0. above): 2^s x max < 2^62
// / rows, from max's f32 bits and the level's row count.
__device__ __forceinline__ int fixed_exp(uint32_t maxbits, int64_t rows) {
  const int biased = static_cast<int>(maxbits >> 23);
  const int e = biased == 0 ? -126 : biased - 126;  // max < 2^e
  const int r = 64 - __clzll(static_cast<unsigned long long>(rows));
  return kFixedBits - r - e;
}

// 2^k as a double, -1022 <= k <= 1023
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
}

// x in fixed point (x * scale rounded to nearest, ties to even; exact
// products), or 0 with x's flag in *fl where x is not finite
__device__ __forceinline__ long long fixed_term(float x, double scale,
                                                uint32_t* fl, int shift) {
  if (isfinite(x)) return __double2ll_rn(static_cast<double>(x) * scale);
  *fl |= (isnan(x) ? kNan : x > 0.0f ? kPosInf : kNegInf) << shift;
  return 0;
}

struct Fetched {
  uint32_t w[kRowWords];
  float g, h;
};

// Row r's bytes f0 .. f0 + ft of binned, as words, and its g and h. The
// loads are issued here and land while the caller works on the group
// before. Rows whose bytes are not 4-byte aligned are read byte by byte.
__device__ __forceinline__ void fetch_row(const uint8_t* __restrict__ binned,
                                          const float* __restrict__ g,
                                          const float* __restrict__ h, int r,
                                          int F, int f0, int ft, bool words,
                                          Fetched& x) {
  if (r < 0) {
    x.g = x.h = 0.0f;
    return;
  }
  const uint8_t* row = binned + static_cast<int64_t>(r) * F + f0;
  x.g = g[r];
  x.h = h[r];
  const int nw = (ft + 3) >> 2;
  if (words) {
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int k = 0; k < kRowWords; ++k)
      if (k < nw) x.w[k] = __ldg(rw + k);
  } else {
#pragma unroll
    for (int k = 0; k < kRowWords; ++k) {
      if (k < nw) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * k + j < ft) v |= static_cast<uint32_t>(__ldg(row + 4 * k + j)) << (8 * j);
        x.w[k] = v;
      }
    }
  }
}

// The tile: four planes of B x kCols words, G's low words, G's high
// words, H's low, H's high. v into the cell: its low word, then its high
// word plus the low add's carry (native 32-bit adds, both made whatever
// the words, so that the lanes of a warp never part; the pair is the sum
// modulo 2^64).
__device__ __forceinline__ void add_fixed(uint32_t* lo, int cell,
                                          int plane, long long v) {
  const uint32_t l = static_cast<uint32_t>(v);
  const uint32_t old = atomicAdd(&lo[cell], l);
  atomicAdd(reinterpret_cast<int*>(&lo[plane + cell]),
            static_cast<int>(v >> 32) + (old + l < old));
}

// A cell's int64 (of plane pair `lo`), cleared
__device__ __forceinline__ long long take_cell(uint32_t* lo, int cell,
                                               int plane) {
  const uint32_t l = lo[cell], hi = lo[plane + cell];
  lo[cell] = 0;
  lo[plane + cell] = 0;
  return static_cast<long long>((static_cast<unsigned long long>(hi) << 32) | l);
}

// The tile's sums of (node, feature tile) into the accumulator, each read
// clearing its cell. Feature fastest over the threads, so a warp reads
// distinct columns of one bin row (no bank conflicts).
__device__ void merge_tile(uint32_t* tile, unsigned long long* __restrict__ acc,
                           int node, int f0, int ft, int per_pass, int F,
                           int B, int64_t out_plane) {
  const int plane = B * kCols;
  unsigned long long* dst = acc + (static_cast<int64_t>(node) * F + f0) * B;
  const int cells = ft * B;
  for (int i = threadIdx.x; i < 2 * cells; i += kThreads) {
    const int which = i >= cells;
    const int j = i - which * cells;
    const int fj = j % ft, b = j / ft;
    uint32_t* t = tile + 2 * which * plane;
    long long s = 0;
    for (int sl = 0; sl < per_pass; ++sl)
      s += take_cell(t, b * kCols + sl * ft + fj, plane);
    if (s != 0)
      atomicAdd(dst + which * out_plane + static_cast<int64_t>(fj) * B + b,
                static_cast<unsigned long long>(s));
  }
}

// An f32 sum with non-finite terms of these flags
__device__ __forceinline__ float nonfinite(uint32_t fl) {
  if ((fl & kNan) || (fl & (kPosInf | kNegInf)) == (kPosInf | kNegInf))
    return __uint_as_float(0x7fc00000u);
  return __uint_as_float(fl & kPosInf ? 0x7f800000u : 0xff800000u);
}

// A node's cells of this feature tile, from the accumulator into the
// output, once every CTA has merged: the double of the sum times 2^-s,
// rounded to f32 once (exact up to that rounding, so the same bits from
// the same sum).
__device__ void convert_node(const unsigned long long* __restrict__ acc,
                             const uint32_t* __restrict__ flags,
                             float* __restrict__ out, int node, int f0,
                             int ft, int F, int B, int64_t out_plane,
                             double inv_g, double inv_h) {
  const int cells = ft * B;
  const int64_t base = (static_cast<int64_t>(node) * F + f0) * B;
  for (int i = threadIdx.x; i < 2 * cells; i += kThreads) {
    const int which = i >= cells;
    const int64_t k = which * out_plane + base + (i - which * cells);
    const long long v = static_cast<long long>(__ldcg(acc + k));
    const uint32_t fl = __ldcg(flags + k);
    out[k] = fl != 0 ? nonfinite(fl)
                     : __double2float_rn(__ll2double_rn(v) *
                                         (which ? inv_h : inv_g));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
level_hist_kernel(const uint8_t* __restrict__ binned,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const int* __restrict__ order,
                  const int* __restrict__ node_start,
                  const unsigned int* __restrict__ maxbits,
                  unsigned long long* __restrict__ acc,
                  unsigned int* __restrict__ flags, int* __restrict__ tickets,
                  float* __restrict__ out, int F, int B, int num_nodes,
                  int feat_tile, bool words) {
  // the tile's four planes, then each warp's stage
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int last;
  // the level's fixed point
  const int64_t level_rows = node_start[num_nodes];
  const int sg = fixed_exp(maxbits[0], level_rows);
  const int sh = fixed_exp(maxbits[1], level_rows);
  const double scale_g = pow2(sg), scale_h = pow2(sh);
  // this CTA's share of the level: node n spans kNodeCost, then its rows
  const int64_t cost = level_rows + kNodeCost * num_nodes;
  const int64_t v0 = cost * blockIdx.x / gridDim.x;
  const int64_t v1 = cost * (blockIdx.x + 1) / gridDim.x;
  // the last node that starts at or before v0
  int n0 = 0;
  for (int b = num_nodes - 1; n0 < b;) {
    const int m = (n0 + b + 1) >> 1;
    if (node_start[m] + kNodeCost * m <= v0) n0 = m; else b = m - 1;
  }

  const int f0 = blockIdx.y * feat_tile;
  const int ft = min(feat_tile, F - f0);
  const int nw = (ft + 3) >> 2;
  const int stride = nw | 1;
  // rows per pass, and this lane's (row slot, feature); lanes past
  // per_pass * ft hold no column
  const int per_pass = ft > 16 ? 1 : kCols / ft;
  const int passes = (32 + per_pass - 1) / per_pass;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / ft;
  const int f = lane - slot * ft;
  const bool live = slot < per_pass;
  const int plane = B * kCols;
  uint32_t* tG = smem;              // G: low plane, then high
  uint32_t* tH = smem + 2 * plane;  // H
  uint32_t* stage = smem + 4 * plane + warp * kStageWords;
  const uint8_t* sbytes = reinterpret_cast<const uint8_t*>(stage);
  longlong2* sq = reinterpret_cast<longlong2*>(stage + kBinWords);
  for (int i = threadIdx.x; i < 4 * plane; i += kThreads) smem[i] = 0;
  const int64_t out_plane = static_cast<int64_t>(num_nodes) * F * B;
  constexpr int step = kWarps * 32;

  for (int node = n0; node < num_nodes; ++node) {
    const int64_t rows_at = node_start[node] + kNodeCost * (node + 1);
    if (rows_at - kNodeCost >= v1) break;
    const int64_t len = node_start[node + 1] - node_start[node];
    const int64_t a = min64(len, v0 > rows_at ? v0 - rows_at : 0);
    const int64_t b = min64(len, v1 > rows_at ? v1 - rows_at : 0);
    if (a >= b) continue;
    const int lo = static_cast<int>(node_start[node] + a);
    const int hi = static_cast<int>(node_start[node] + b);
    __syncthreads();  // the tile clear, the last node's conversion

    // a run of equal bins in this lane's column is summed in registers
    // and added once: a feature with few distinct values (0/1 bins)
    // costs fewer adds
    int run_b = -1;
    long long run_g = 0, run_h = 0;
    int base = lo + warp * 32;
    Fetched next;
    fetch_row(binned, g, h, base + lane < hi ? order[base + lane] : -1, F,
              f0, ft, words, next);
    int rn = base + step + lane < hi ? order[base + step + lane] : -1;
    for (; base < hi; base += step) {
      // stage this group (fetched one group ago) in fixed point, fetch
      // the next group, then add this one from shared memory
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kRowWords; ++k)
        if (k < nw) stage[lane * stride + k] = next.w[k];
      uint32_t fl = 0;
      const long long qg = fixed_term(next.g, scale_g, &fl, 0);
      const long long qh = fixed_term(next.h, scale_h, &fl, kHFlags);
      sq[lane] = make_longlong2(qg, qh);
      if (fl != 0) {  // a non-finite g or h (rare): flag the row's cells
#pragma unroll
        for (int j = 0; j < kCols; ++j) {  // unrolled: w's index is known
          const int bin = (next.w[j >> 2] >> (8 * (j & 3))) & 0xff;
          if (j >= ft || bin >= B) continue;
          const int64_t k = (static_cast<int64_t>(node) * F + f0 + j) * B + bin;
          if (fl & 7u) atomicOr(&flags[k], fl & 7u);
          if (fl >> kHFlags) atomicOr(&flags[out_plane + k], fl >> kHFlags);
        }
      }
      __syncwarp();
      fetch_row(binned, g, h, rn, F, f0, ft, words, next);
      const int after = base + 2 * step + lane;
      rn = after < hi ? order[after] : -1;
      const int valid = min(32, hi - base);
      for (int p = 0; p < passes; ++p) {
        const int row = p * per_pass + slot;
        if (!live || row >= valid) continue;
        const int bin = sbytes[row * stride * 4 + f];
        if (bin >= B) continue;
        const longlong2 v = sq[row];
        if (bin == run_b) {
          run_g += v.x;
          run_h += v.y;
        } else {
          if (run_b >= 0) {
            add_fixed(tG, run_b * kCols + lane, plane, run_g);
            add_fixed(tH, run_b * kCols + lane, plane, run_h);
          }
          run_b = bin;
          run_g = v.x;
          run_h = v.y;
        }
      }
    }
    if (run_b >= 0) {
      add_fixed(tG, run_b * kCols + lane, plane, run_g);
      add_fixed(tH, run_b * kCols + lane, plane, run_h);
    }
    __syncthreads();  // the node's adds
    merge_tile(smem, acc, node, f0, ft, per_pass, F, B, out_plane);
    // this CTA's rows of the node are in the accumulator; the CTA that
    // brings the node's count to its rows converts it
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int done = static_cast<int>(b - a);
      last = atomicAdd(&tickets[blockIdx.y * num_nodes + node], done) +
                 done == len;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      convert_node(acc, flags, out, node, f0, ft, F, B, out_plane,
                   pow2(-sg), pow2(-sh));
    }
  }
}

int launch_partition(const int* rel, const float* g, const float* h,
                     unsigned int* maxbits, const Scratch& s, int64_t rows,
                     int num_nodes, cudaStream_t st) {
  const int chunks = static_cast<int>(chunks_for(rows));
  // per-warp counters of a window of nodes
  const int shared =
      kPartWarps * (num_nodes < kNodeWindow ? num_nodes : kNodeWindow) *
      static_cast<int>(sizeof(int));
  cudaError_t rc = cudaFuncSetAttribute(
      partition_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(partition_scatter_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  partition_count_kernel<<<chunks, kPartThreads, shared, st>>>(
      rel, g, h, s.counts, maxbits, rows, num_nodes, chunks);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  partition_scan_kernel<<<1, kScanThreads, 0, st>>>(
      s.counts, s.node_start, num_nodes, chunks);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  partition_scatter_kernel<<<chunks, kPartThreads, shared, st>>>(
      rel, s.counts, s.order, rows, num_nodes, chunks);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int64_t rows, int num_nodes) {
  return num_nodes <= 0 || rows < 0 || rows > INT32_MAX - kChunk;
}

// feature tiles of at most kCols features, as even as they come in
// multiples of 4 (so that a tile's bytes start on a word where rows do)
inline int feat_tiles_for(int F) { return (F + kCols - 1) / kCols; }

// The histogram's workspace, in bytes from its start: the output (f32),
// the accumulator (uint64), the flags (uint32), each 2 * num_nodes * F *
// B; the tickets (int32, num_nodes a feature tile); the two maxima; then,
// from `zeroed` on, the partition's scratch (int32s). The memset clears
// everything before `zeroed`.
struct Layout {
  int64_t out, acc, flags, tickets, maxbits, zeroed, part, total;
};

inline int64_t align16(int64_t x) { return (x + 15) & ~int64_t{15}; }

Layout layout(int64_t rows, int F, int B, int num_nodes) {
  const int64_t cells = 2 * static_cast<int64_t>(num_nodes) * F * B;
  Layout l;
  l.out = 0;
  l.acc = align16(4 * cells);
  l.flags = l.acc + 8 * cells;
  l.tickets = l.flags + 4 * cells;
  l.maxbits = l.tickets + 4 * static_cast<int64_t>(num_nodes) * feat_tiles_for(F);
  l.zeroed = align16(l.maxbits + 8);
  l.part = l.zeroed;
  l.total = l.part + 4 * scratch_ints(rows, num_nodes);
  return l;
}

bool bad_hist_shape(int64_t rows, int F, int B, int num_nodes) {
  return F <= 0 || B <= 0 || B > 256 || bad_shape(rows, num_nodes) ||
         feat_tiles_for(F) > 65535;
}

}  // namespace

extern "C" {

const char* wh_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// *ints = the int32s of scratch that wh_level_partition takes.
int wh_level_scratch_ints(int64_t rows, int num_nodes, void* ints) {
  if (bad_shape(rows, num_nodes)) return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<int64_t*>(ints) = scratch_ints(rows, num_nodes);
  return 0;
}

// The partition alone: scratch's first num_nodes + 1 ints become
// node_start and the next node_start[num_nodes] ints order (the rest of
// order's rows ints is left as it was).
int wh_level_partition(const void* rel, void* scratch, int64_t rows,
                       int num_nodes, void* stream) {
  if (bad_shape(rows, num_nodes)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0)
    return static_cast<int>(cudaMemsetAsync(
        scratch, 0, sizeof(int) * (num_nodes + 1),
        static_cast<cudaStream_t>(stream)));
  return launch_partition(static_cast<const int*>(rel), nullptr, nullptr,
                          nullptr,
                          carve(static_cast<int*>(scratch), rows, num_nodes),
                          rows, num_nodes, static_cast<cudaStream_t>(stream));
}

// *bytes = the bytes of the workspace that wh_level_hist takes; its
// first 8 * num_nodes * F * B bytes become the (2, num_nodes, F, B) f32
// output.
int wh_level_hist_bytes(int64_t rows, int F, int B, int num_nodes,
                        void* bytes) {
  if (bad_hist_shape(rows, F, B, num_nodes))
    return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<int64_t*>(bytes) = layout(rows, F, B, num_nodes).total;
  return 0;
}

// binned: (rows, F) uint8; g, h: (rows,) f32; rel: (rows,) int32; ws:
// wh_level_hist_bytes bytes, 16-byte aligned, the output at its start.
// Five launches: the memset, the partition's three kernels, the
// histogram.
int wh_level_hist(const void* binned, const void* g, const void* h,
                  const void* rel, void* ws, int64_t rows, int F, int B,
                  int num_nodes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_hist_shape(rows, F, B, num_nodes) ||
      (reinterpret_cast<uintptr_t>(ws) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(rows, F, B, num_nodes);
  char* base = static_cast<char*>(ws);
  cudaError_t rc = cudaMemsetAsync(base, 0, l.zeroed, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (rows == 0) return static_cast<int>(cudaGetLastError());

  const int feat_tiles = feat_tiles_for(F);
  const int feat_tile = ((F + feat_tiles - 1) / feat_tiles + 3) & ~3;
  const size_t shared =
      sizeof(uint32_t) * (4 * B * kCols + static_cast<size_t>(kWarps) * kStageWords);
  const bool words =
      (F & 3) == 0 && (reinterpret_cast<uintptr_t>(binned) & 3) == 0;
  int device = 0, sms = 0, per_sm = 0;
  rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(level_hist_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(shared));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, level_hist_kernel, kThreads, shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // every CTA resident at once; fewer where the rows are few
  int64_t ctas = static_cast<int64_t>(per_sm) * sms / feat_tiles;
  const int64_t by_rows = (rows + kMinCtaRows - 1) / kMinCtaRows;
  if (ctas > by_rows) ctas = by_rows;
  if (ctas < 1) ctas = 1;

  const Scratch s = carve(reinterpret_cast<int*>(base + l.part), rows,
                          num_nodes);
  unsigned int* maxbits = reinterpret_cast<unsigned int*>(base + l.maxbits);
  int code = launch_partition(static_cast<const int*>(rel),
                              static_cast<const float*>(g),
                              static_cast<const float*>(h), maxbits, s, rows,
                              num_nodes, st);
  if (code != 0) return code;
  level_hist_kernel<<<dim3(static_cast<unsigned>(ctas),
                           static_cast<unsigned>(feat_tiles)),
                      kThreads, shared, st>>>(
      static_cast<const uint8_t*>(binned), static_cast<const float*>(g),
      static_cast<const float*>(h), s.order, s.node_start, maxbits,
      reinterpret_cast<unsigned long long*>(base + l.acc),
      reinterpret_cast<unsigned int*>(base + l.flags),
      reinterpret_cast<int*>(base + l.tickets),
      reinterpret_cast<float*>(base + l.out), F, B, num_nodes, feat_tile,
      words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
