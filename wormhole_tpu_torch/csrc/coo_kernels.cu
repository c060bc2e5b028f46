// Sparse COO products and the compact-slot gather of the linear learner,
// written by hand for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of wormhole_tpu/ops/coo_kernels.py:
//   coo_spmv    (_pull_kernel, :280)         xw[r] = sum val * w[idx]
//   coo_spmv_t  (_push_kernel, :343)         g[k]  = sum val * d[seg]
//   tile_gather (_tile_gather_kernel, :579)  out[s] = table[uniq[s]]
//
// The TPU kernels play gather and scatter with one-hot MXU matmuls because
// Mosaic has no sublane gather; Hopper gathers natively, so none of that
// comes across. All three are bound by device memory: each reads the
// packed (idx, seg, val) stream or the slot list once, and touches one
// table or row entry per element. The designs below read every stream
// element with one coalesced 4-byte load per thread and keep the random
// accesses to a single gather (pull, push) or a single atomic add per row
// entry (pull) or per run of equal keys in a warp (push).
//
// bf16 mode rounds at the points the TPU kernels round (the MXU operand
// casts): the gathered table value, then the product with val.
//
// Plain C entry points, loaded with ctypes by ops/_cuda.py. Every entry
// enqueues on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Pull: one thread per packed entry. The stream is sorted by bucket, not
// by row, so a row's entries are spread over the whole stream and the
// per-row sums are float atomics into an output zeroed by the entry
// point. The summation order inside a row therefore changes from run to
// run (results agree to rtol 1e-5 with the plain version).
//
// A packed stream never holds a live entry whose bucket or row is out of
// range; one that does means a packing fault, and the kernel traps (the
// launch fails, as the plain version's index_add_ asserts) rather than
// drop the entry.
template <bool kBf16>
__global__ void pull_kernel(const float* __restrict__ w,
                            const int* __restrict__ idx,
                            const int* __restrict__ seg,
                            const float* __restrict__ val,
                            float* __restrict__ out, int64_t n,
                            int64_t num_buckets, int64_t num_rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = val[i];
  if (v == 0.0f) return;  // padding entries: idx and seg are not read
  const int k = idx[i];
  const int r = seg[i];
  if (k < 0 || k >= num_buckets || r < 0 || r >= num_rows) __trap();
  float wv = __ldg(&w[k]);
  if (kBf16) wv = round_bf16(wv);
  float p = wv * v;
  if (kBf16) p = round_bf16(p);
  atomicAdd(&out[r], p);
}

// Push: one thread per packed entry, then a segmented sum over the runs of
// equal bucket ids inside each warp, and one atomic add per run. Runs are
// found by comparing each lane's key with its left neighbour's, so the
// kernel needs no sortedness to be right: the per-tile pad entries
// (val 0, idx = tile base, out of order after the tile's live entries)
// take key -1 without reading idx or seg, and their runs are skipped.
// A hot bucket's run, however long, costs one atomic per warp it spans.
// An out-of-range live entry traps, as in the pull.
template <bool kBf16>
__global__ void push_kernel(const float* __restrict__ d,
                            const int* __restrict__ idx,
                            const int* __restrict__ seg,
                            const float* __restrict__ val,
                            float* __restrict__ g, int64_t n,
                            int64_t num_buckets, int64_t num_rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  int key = -1;
  float c = 0.0f;
  const float v = i < n ? val[i] : 0.0f;
  if (v != 0.0f) {
    key = idx[i];
    const int r = seg[i];
    if (key < 0 || key >= num_buckets || r < 0 || r >= num_rows) __trap();
    float dv = __ldg(&d[r]);
    if (kBf16) dv = round_bf16(dv);
    c = dv * v;
    if (kBf16) c = round_bf16(c);
  }
  const int left = __shfl_up_sync(kFull, key, 1);
  const bool head = lane == 0 || left != key;
  const unsigned heads = __ballot_sync(kFull, head);
  // last lane of this lane's run: one before the next head above it
  const unsigned above = lane == 31u ? 0u : (heads >> (lane + 1u)) << (lane + 1u);
  const int end = above ? __ffs(above) - 2 : 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float oc = __shfl_down_sync(kFull, c, off);
    if (static_cast<int>(lane) + off <= end) c += oc;
  }
  if (head && key >= 0 && c != 0.0f) atomicAdd(&g[key], c);
}

// Gather at the compact slots: one thread per slot. Sentinel slots
// (uniq == num_buckets) read 0.0, as the TPU kernel's all-zero one-hot row
// does. The TPU kernel streams each touched table tile through VMEM
// (tmap_u names it); here each slot reads its entry directly.
template <bool kBf16>
__global__ void tile_gather_kernel(const float* __restrict__ table,
                                   const int* __restrict__ uniq,
                                   float* __restrict__ out, int64_t u_cap,
                                   int64_t num_buckets) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= u_cap) return;
  const int k = uniq[s];
  float v = 0.0f;
  if (k >= 0 && k < num_buckets) {
    v = __ldg(&table[k]);
    if (kBf16) v = round_bf16(v);
  }
  out[s] = v;
}

}  // namespace

extern "C" {

const char* wh_coo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int wh_coo_spmv(const void* w, const void* idx, const void* seg,
                const void* val, void* out, int64_t n, int64_t num_buckets,
                int64_t num_rows, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, num_rows * sizeof(float), st);
  if (n > 0) {
    auto kern = bf16 ? pull_kernel<true> : pull_kernel<false>;
    kern<<<blocks_for(n), kThreads, 0, st>>>(
        static_cast<const float*>(w), static_cast<const int*>(idx),
        static_cast<const int*>(seg), static_cast<const float*>(val),
        static_cast<float*>(out), n, num_buckets, num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int wh_coo_spmv_t(const void* d, const void* idx, const void* seg,
                  const void* val, void* g, int64_t n, int64_t num_buckets,
                  int64_t num_rows, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(g, 0, num_buckets * sizeof(float), st);
  if (n > 0) {
    auto kern = bf16 ? push_kernel<true> : push_kernel<false>;
    kern<<<blocks_for(n), kThreads, 0, st>>>(
        static_cast<const float*>(d), static_cast<const int*>(idx),
        static_cast<const int*>(seg), static_cast<const float*>(val),
        static_cast<float*>(g), n, num_buckets, num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int wh_tile_gather(const void* table, const void* uniq, void* out,
                   int64_t u_cap, int64_t num_buckets, int bf16,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u_cap > 0) {
    auto kern = bf16 ? tile_gather_kernel<true> : tile_gather_kernel<false>;
    kern<<<blocks_for(u_cap), kThreads, 0, st>>>(
        static_cast<const float*>(table), static_cast<const int*>(uniq),
        static_cast<float*>(out), u_cap, num_buckets);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
