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
// and the sums are f32 atomic adds into a histogram tile in shared memory:
//
// 1. Partition (three launches). partition_count_kernel: a CTA counts the
//    rows of its 8,192-row chunk per node (each warp its own 512 rows,
//    match_any to add a group of equal nodes at once). partition_scan_
//    kernel (one CTA): an exclusive scan of those counts, node-major, so
//    that node n's rows start at node_start[n]. partition_scatter_kernel:
//    writes each row id to its place in order[], in row order within
//    each node. Nothing comes back to the host: the histogram kernel
//    reads node_start from device memory, and the grid is sized from
//    rows alone.
// 2. level_hist_kernel: a grid of resident CTAs. The level costs its
//    rows plus kNodeCost a node (a node's merge, in rows), and CTA c
//    takes the c-th even share of that cost: a run of order[] that may
//    span a few nodes. So a CTA reads only rows of the level, node by
//    node, whatever the node count; a node of 1.9M rows beside nodes of
//    a hundred spreads over the card by rows, and a CTA whose share
//    holds many small nodes takes fewer rows. For each node of its share
//    the CTA accumulates into its tile, then adds the tile into the
//    zeroed output and clears it.
//    - A warp takes 32 rows at a time. Lane i reads row i's bin bytes as
//      words (bytes where rows are not word-aligned) and its g and h,
//      and stages them in shared memory; the loads of the next 32 rows
//      are issued before this group's atomics, so the adds never wait
//      on device memory.
//    - The tile is [2][B][32] floats: a column per lane, 64 KB at B =
//      256. A pass holds one row, one lane per feature (32 / F rows where
//      F <= 16, each in its own columns, summed at the merge), and lane l
//      adds to column l: its bank is l, so no bank conflict and no two
//      lanes on one address, whatever the bins. A lane sums a run of
//      equal bins in registers and adds it once, so a feature with few
//      distinct values (0/1 bins) costs fewer atomics. F > 32 is cut into
//      feature tiles of at most 32 (blockIdx.y).
//    - The merge: a thread sums four consecutive bins of a feature over
//      its columns and adds them with one vector atomic (sm_90's float4
//      atomicAdd, one element at a time) where any is non-zero, and a
//      scalar atomic per non-zero bin when B is not a multiple of 4.
//      Merges per level: at most one per CTA plus one per node.
//
// Bound: device memory, at 3.35 TB/s: rel of every row; g, h and the F
// bin bytes of each row in the level; the output once. The partition
// adds rel read twice and order written and read. What bounds the kernel
// on the card is the shared-memory atomic: sm_90 has no native f32 add
// in shared memory, and atomicAdd(float*) compiles to a compare-and-swap
// loop (ATOMS.CAST.SPIN). Two per (row, feature) set its time; the
// loads, staged ahead, take less than half of it. Integer accumulators
// would be native adds, but a fixed-point scale taken from the rows' g
// rounds equal values of g the same way, and a cell of many equal g then
// drifts past the precision bar; the sums stay f32. The float atomics
// make the order of each sum free, so two launches may differ in the
// last bits.
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
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;          // tile columns: one per lane
constexpr int kMinCtaRows = 512;   // rows per CTA below which fewer CTAs run
// What a CTA's merge of one node costs, in rows: a CTA's share of the
// level is an even share of rows + kNodeCost x nodes
constexpr int64_t kNodeCost = 256;

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

// counts[n * chunks + c] = the rows of chunk c in node n
__global__ void __launch_bounds__(kPartThreads)
partition_count_kernel(const int* __restrict__ rel, int* __restrict__ counts,
                       int64_t rows, int num_nodes, int chunks) {
  extern __shared__ int wcnt[];
  const int warp = threadIdx.x >> 5;
  int nd[kPartSteps];
  load_rel(rel, rows, static_cast<int64_t>(blockIdx.x) * kChunk +
                          warp * kWarpRows, nd);
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
// of each row (kStageWords words at most, an odd stride so that lane i's
// stores of row i hit distinct banks), then the rows' (g, h).
constexpr int kRowWords = kCols / 4;
constexpr int kStageWords = 32 * (kRowWords + 1) + 64;

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
  if (r < 0) return;
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

__device__ __forceinline__ void add_cell(float* tG, float* tH, int cell,
                                         float gv, float hv) {
  atomicAdd(&tG[cell], gv);
  atomicAdd(&tH[cell], hv);
}

// The tile's sums of (node, feature tile) into the zeroed output, each
// read clearing its cell. Feature fastest over the threads, so a warp
// reads distinct columns of one bin row (no bank conflicts).
__device__ void merge_tile(float* tG, float* tH, float* __restrict__ out,
                           int node, int f0, int ft, int per_pass, int F,
                           int B, int64_t out_plane) {
  float* dst = out + (static_cast<int64_t>(node) * F + f0) * B;
  if ((B & 3) == 0) {
    const int quads = ft * (B >> 2);
    for (int i = threadIdx.x; i < 2 * quads; i += kThreads) {
      const int which = i >= quads;
      const int j = i - which * quads;
      const int fj = j % ft, b0 = 4 * (j / ft);
      float* t = which ? tH : tG;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float s = 0.0f;
        for (int sl = 0; sl < per_pass; ++sl) {
          float* c = &t[(b0 + k) * kCols + sl * ft + fj];
          s += *c;
          *c = 0.0f;
        }
        v[k] = s;
      }
      if (v[0] != 0.0f || v[1] != 0.0f || v[2] != 0.0f || v[3] != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(
                      dst + which * out_plane + static_cast<int64_t>(fj) * B + b0),
                  make_float4(v[0], v[1], v[2], v[3]));
    }
  } else {
    const int cells = ft * B;
    for (int i = threadIdx.x; i < 2 * cells; i += kThreads) {
      const int which = i >= cells;
      const int j = i - which * cells;
      const int fj = j % ft, b = j / ft;
      float* t = which ? tH : tG;
      float s = 0.0f;
      for (int sl = 0; sl < per_pass; ++sl) {
        float* c = &t[b * kCols + sl * ft + fj];
        s += *c;
        *c = 0.0f;
      }
      if (s != 0.0f)
        atomicAdd(dst + which * out_plane + static_cast<int64_t>(fj) * B + b, s);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
level_hist_kernel(const uint8_t* __restrict__ binned,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const int* __restrict__ order,
                  const int* __restrict__ node_start,
                  float* __restrict__ out, int F, int B, int num_nodes,
                  int feat_tile, bool words) {
  // [2][B][kCols] floats (G, then H), then each warp's stage
  extern __shared__ __align__(16) float smem[];
  // this CTA's share of the level: node n spans kNodeCost, then its rows
  const int64_t cost = node_start[num_nodes] + kNodeCost * num_nodes;
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
  float* tG = smem;
  float* tH = smem + plane;
  uint32_t* stage =
      reinterpret_cast<uint32_t*>(smem + 2 * plane) + warp * kStageWords;
  const uint8_t* sbytes = reinterpret_cast<const uint8_t*>(stage);
  float2* sgh = reinterpret_cast<float2*>(stage + 32 * (kRowWords + 1));
  for (int i = threadIdx.x; i < 2 * plane; i += kThreads) smem[i] = 0.0f;
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
    __syncthreads();  // the tile clear

    // a run of equal bins in this lane's column is summed in registers
    // and added once: a feature with few distinct values (0/1 bins)
    // costs fewer atomics
    int run_b = -1;
    float run_g = 0.0f, run_h = 0.0f;
    int base = lo + warp * 32;
    Fetched next;
    fetch_row(binned, g, h, base + lane < hi ? order[base + lane] : -1, F,
              f0, ft, words, next);
    int rn = base + step + lane < hi ? order[base + step + lane] : -1;
    for (; base < hi; base += step) {
      // stage this group (fetched one group ago), fetch the next group,
      // then add this one from shared memory
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kRowWords; ++k)
        if (k < nw) stage[lane * stride + k] = next.w[k];
      sgh[lane] = make_float2(next.g, next.h);
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
        const float2 v = sgh[row];
        if (bin == run_b) {
          run_g += v.x;
          run_h += v.y;
        } else {
          if (run_b >= 0) add_cell(tG, tH, run_b * kCols + lane, run_g, run_h);
          run_b = bin;
          run_g = v.x;
          run_h = v.y;
        }
      }
    }
    if (run_b >= 0) add_cell(tG, tH, run_b * kCols + lane, run_g, run_h);
    __syncthreads();  // the node's adds
    merge_tile(tG, tH, out, node, f0, ft, per_pass, F, B, out_plane);
  }
}

int launch_partition(const int* rel, const Scratch& s, int64_t rows,
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
      rel, s.counts, rows, num_nodes, chunks);
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

}  // namespace

extern "C" {

const char* wh_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// *ints = the int32s of scratch that the two entries below take.
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
  return launch_partition(static_cast<const int*>(rel),
                          carve(static_cast<int*>(scratch), rows, num_nodes),
                          rows, num_nodes, static_cast<cudaStream_t>(stream));
}

// binned: (rows, F) uint8; g, h: (rows,) f32; rel: (rows,) int32;
// scratch: wh_level_scratch_ints int32s; out: (2, num_nodes, F, B) f32,
// zeroed here and then accumulated into. Five launches: the memset, the
// partition's three kernels, the histogram.
int wh_level_hist(const void* binned, const void* g, const void* h,
                  const void* rel, void* scratch, void* out, int64_t rows,
                  int F, int B, int num_nodes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F <= 0 || B <= 0 || B > 256 || bad_shape(rows, num_nodes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(
      out, 0, sizeof(float) * 2 * static_cast<int64_t>(num_nodes) * F * B, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (rows == 0) return static_cast<int>(cudaGetLastError());

  // feature tiles of at most kCols features, as even as they come in
  // multiples of 4 (so that a tile's bytes start on a word where rows do)
  const int feat_tiles = (F + kCols - 1) / kCols;
  const int feat_tile = ((F + feat_tiles - 1) / feat_tiles + 3) & ~3;
  const size_t shared =
      sizeof(float) * (2 * B * kCols + static_cast<size_t>(kWarps) * kStageWords);
  const bool words =
      (F & 3) == 0 && (reinterpret_cast<uintptr_t>(binned) & 3) == 0;
  if (feat_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
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

  const Scratch s = carve(static_cast<int*>(scratch), rows, num_nodes);
  int code = launch_partition(static_cast<const int*>(rel), s, rows,
                              num_nodes, st);
  if (code != 0) return code;
  level_hist_kernel<<<dim3(static_cast<unsigned>(ctas),
                           static_cast<unsigned>(feat_tiles)),
                      kThreads, shared, st>>>(
      static_cast<const uint8_t*>(binned), static_cast<const float*>(g),
      static_cast<const float*>(h), s.order, s.node_start,
      static_cast<float*>(out), F, B, num_nodes, feat_tile, words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
