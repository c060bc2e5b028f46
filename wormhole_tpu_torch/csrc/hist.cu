// The GBDT level histogram, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of wormhole_tpu/ops/hist.py:
//   level_hist (_hist_kernel, :52; wrapper :79)
//
// Computes, for one tree level,
//   G[n, f, b] = sum of g[r] over rows r with rel[r] == n, binned[r, f] == b
//   H[n, f, b] = the same sum of h[r]
// for n < num_nodes. binned is (rows, F) uint8 with values below B <= 256,
// g and h are (rows,) f32, rel is (rows,) int32; a row whose rel is outside
// [0, num_nodes) is in no node of the level and adds nothing. The output
// is exactly (2, num_nodes, F, B) f32: G first, then H.
//
// The TPU kernel restates the sum as one-hot matmuls to fill the MXU (a
// node one-hot operand weighted by bf16 hi/lo planes of g and h, nodes
// padded to 8, rows padded to 4096-row blocks, features in groups). None
// of that is carried over. Here the sums are f32 atomic adds into a
// histogram tile in shared memory:
//
// - A CTA owns a tile of nodes x features (as many as fit its shared-memory
//   budget: at 28 features x 256 bins one node's G and H are 57,568 bytes,
//   so at most two nodes to a CTA and at least two CTAs to an SM) and a
//   grid-strided share of the rows. The grid is (row shares, node tiles,
//   feature tiles), sized so that every CTA is resident at once.
// - A warp takes 32 rows at a time: each lane reads one row's rel
//   (coalesced) and, where the row is in the CTA's node tile, its g and h.
//   A row outside the tile costs that rel read and nothing else. Then the
//   warp walks its rows in the tile, one lane per feature (several rows at
//   once where F <= 16): a lane reads one bin byte (the lanes of a row read
//   consecutive bytes, one or two sectors) and adds g and h at
//   [node, feature, bin]. Offsets into binned are 64-bit.
// - Lanes of one pass hold different features, so they never add to the
//   same address, whatever the data: a binary feature (every row in bin 0
//   or 1) costs no same-address serialisation. The feature stride in shared
//   memory is B + 1 floats, so lanes whose bins are equal fall into
//   different banks too.
// - At the end the CTA adds its non-zero cells to the output with one
//   global atomic each. The output is zeroed before the launch, so a cell
//   that no row reaches is exactly 0.0.
//
// Bound: device memory (rel of every row; g, h and the F bin bytes of each
// row in the level; the output once); the arithmetic is two adds per (row,
// feature). The float atomics make the order of each sum free, so two
// launches may differ in the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a CTA's histogram tile may take: leaves room for two CTAs
// on an SM
constexpr int64_t kTileBudget = 115200;
constexpr int64_t kMaxDynamicShared = 232448;

__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const uint8_t* __restrict__ binned,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const int* __restrict__ rel, float* __restrict__ out,
                  int64_t rows, int F, int B, int num_nodes, int node_tile,
                  int feat_tile) {
  extern __shared__ float tile[];
  const int n0 = blockIdx.y * node_tile;
  const int f0 = blockIdx.z * feat_tile;
  const int nt = min(node_tile, num_nodes - n0);
  const int ft = min(feat_tile, F - f0);
  const int stride = B + 1;
  const int cells = nt * ft * stride;
  float* sG = tile;
  float* sH = tile + cells;
  for (int i = threadIdx.x; i < 2 * cells; i += kThreads) tile[i] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // rows per pass of the warp, and this lane's (row slot, feature) in it
  const int per_pass = ft >= 32 ? 1 : 32 / ft;
  const int slot = ft >= 32 ? 0 : lane / ft;
  const int f_lane = ft >= 32 ? lane : lane % ft;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
       base < rows; base += step) {
    const int64_t r = base + lane;
    int node = -1;
    float gr = 0.0f, hr = 0.0f;
    if (r < rows) {
      const int n = rel[r] - n0;
      if (n >= 0 && n < nt) {
        node = n;
        gr = g[r];
        hr = h[r];
      }
    }
    unsigned todo = __ballot_sync(kFull, node >= 0);
    while (todo) {
      // the slot-th row still to do, if there is one
      unsigned m = todo;
      for (int i = 0; i < slot; ++i) m &= m - 1;
      const bool have = slot < per_pass && m != 0;
      const int src = have ? __ffs(m) - 1 : 0;
      const int node_s = __shfl_sync(kFull, node, src);
      const float g_s = __shfl_sync(kFull, gr, src);
      const float h_s = __shfl_sync(kFull, hr, src);
      if (have) {
        const uint8_t* row = binned + (base + src) * F + f0;
        for (int f = f_lane; f < ft; f += 32) {
          const int bin = row[f];
          if (bin < B) {
            const int cell = (node_s * ft + f) * stride + bin;
            atomicAdd(&sG[cell], g_s);
            atomicAdd(&sH[cell], h_s);
          }
        }
      }
      for (int i = 0; i < per_pass && todo; ++i) todo &= todo - 1;
    }
  }
  __syncthreads();

  // add the tile into the zeroed output; untouched cells stay exactly 0
  const int64_t plane = static_cast<int64_t>(num_nodes) * F * B;
  const int live = nt * ft * B;
  for (int i = threadIdx.x; i < live; i += kThreads) {
    const int b = i % B;
    const int nf = i / B;
    const int f = nf % ft;
    const int n = nf / ft;
    const int cell = (n * ft + f) * stride + b;
    const int64_t o = (static_cast<int64_t>(n0 + n) * F + (f0 + f)) * B + b;
    const float vg = sG[cell], vh = sH[cell];
    if (vg != 0.0f) atomicAdd(&out[o], vg);
    if (vh != 0.0f) atomicAdd(&out[plane + o], vh);
  }
}

}  // namespace

extern "C" {

const char* wh_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// binned: (rows, F) uint8; g, h: (rows,) f32; rel: (rows,) int32;
// out: (2, num_nodes, F, B) f32, zeroed here and then accumulated into.
int wh_level_hist(const void* binned, const void* g, const void* h,
                  const void* rel, void* out, int64_t rows, int F, int B,
                  int num_nodes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F <= 0 || B <= 0 || B > 256 || num_nodes <= 0 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(
      out, 0, sizeof(float) * 2 * static_cast<int64_t>(num_nodes) * F * B, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (rows == 0) return static_cast<int>(cudaGetLastError());

  // the tile: as many features of one node as the budget holds, then as
  // many nodes of those features
  const int64_t per_feat = static_cast<int64_t>(B + 1) * 2 * sizeof(float);
  const int feat_tile = static_cast<int>(
      F < kTileBudget / per_feat ? F : kTileBudget / per_feat);
  int64_t node_fit = kTileBudget / (per_feat * feat_tile);
  if (node_fit < 1) node_fit = 1;
  const int node_tile =
      static_cast<int>(num_nodes < node_fit ? num_nodes : node_fit);
  const size_t shared = static_cast<size_t>(per_feat) * feat_tile * node_tile;
  const int node_tiles = (num_nodes + node_tile - 1) / node_tile;
  const int feat_tiles = (F + feat_tile - 1) / feat_tile;
  if (node_tiles > 65535 || feat_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);

  int device = 0, sms = 0;
  rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(level_hist_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(kMaxDynamicShared));
  if (rc != cudaSuccess) return static_cast<int>(rc);

  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, level_hist_kernel, kThreads, shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);

  // every CTA resident at once, shared among the tiles
  const int64_t row_blocks = (rows + kThreads - 1) / kThreads;
  int64_t shares =
      (static_cast<int64_t>(per_sm) * sms) / (node_tiles * feat_tiles);
  if (shares < 1) shares = 1;
  if (shares > row_blocks) shares = row_blocks;
  const dim3 grid(static_cast<unsigned>(shares),
                  static_cast<unsigned>(node_tiles),
                  static_cast<unsigned>(feat_tiles));
  level_hist_kernel<<<grid, kThreads, shared, st>>>(
      static_cast<const uint8_t*>(binned), static_cast<const float*>(g),
      static_cast<const float*>(h), static_cast<const int*>(rel),
      static_cast<float*>(out), rows, F, B, num_nodes, node_tile, feat_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
