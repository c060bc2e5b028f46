// The linear learner's optimizer update at the batch's unique keys, in
// place, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scatter_update of
// wormhole_tpu/ops/fused_update.py (_kernel, :85; wrapper :329). That kernel
// walks each touched (512, 128) table tile, scatters the compact gradient
// into it with a one-hot MXU matmul, applies the FTRL / AdaGrad / SGD handle
// to the whole tile and writes the tile back. Here uniq names each key at
// most once, so one thread per compact slot reads the key's state, applies
// the handle and writes it back: no scatter, no collisions, and the
// untouched entries of a touched tile are never read (in the TPU kernel
// they are exact no-ops: FTRL with g = 0, and the g != 0 mask of
// AdaGrad/SGD).
//
// Bound: device memory. Each live slot reads g, uniq and 1-3 state
// entries and writes the state back; the state accesses are random over
// the table (sorted by key, so neighbouring slots often share a sector).
//
// Numerics follow models/linear._update of the JAX package in f32 with
// IEEE sqrt and division; the build passes -fmad=false so no product is
// fused into an add the plain version rounds separately. The push filter
// (fixed_bytes) rounds half to even (rintf), like jnp.round. In bf16 mode
// the gradient is rounded to bf16 before the filter, where the TPU
// kernel's scatter matmul rounds it. The |w|_0 delta is an integer block
// count plus one integer atomic per block, so it is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Algo { kFtrl = 0, kAdagrad = 1, kSgd = 2 };

struct Hyper {
  float lr_eta, lr_beta, lambda_l1, lambda_l2, sgd_eta;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ops/penalty.l1l2_solve: sign(neg_z) * max(|neg_z| - l1, 0) / (eta + l2)
__device__ __forceinline__ float l1l2_solve(float neg_z, float eta, float l1,
                                            float l2) {
  const float mag = fmaxf(fabsf(neg_z) - l1, 0.0f);
  const float sgn = neg_z > 0.0f ? 1.0f : (neg_z < 0.0f ? -1.0f : 0.0f);
  return sgn * mag / (eta + l2);
}

template <int kFixedBytes>
__device__ __forceinline__ float quantize(float g, const float* qscale) {
  if (kFixedBytes == 0) return g;
  if (kFixedBytes >= 2) return round_bf16(g);
  const float s = *qscale;
  const float q = fminf(fmaxf(rintf(g / s), -127.0f), 127.0f);
  return q * s;
}

template <int kAlgo, int kFixedBytes, bool kBf16, bool kAdd>
__global__ void scatter_update_kernel(
    float* __restrict__ z, float* __restrict__ n, float* __restrict__ w,
    float* __restrict__ add_table, const float* __restrict__ add_values,
    const float* __restrict__ g, const int* __restrict__ uniq,
    const float* __restrict__ qscale, int64_t u_cap, int64_t num_buckets,
    Hyper h, int* __restrict__ new_w) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int k = s < u_cap ? uniq[s] : -1;
  const bool live = k >= 0 && k < num_buckets;  // sentinel slots skip
  bool was_nz = false, is_nz = false;
  if (live) {
    float raw = g[s];
    if (kBf16) raw = round_bf16(raw);
    const float gq = quantize<kFixedBytes>(raw, qscale);
    const float w0 = w[k];
    float w2 = w0;
    if (kAlgo == kFtrl) {
      const float z0 = z[k], n0 = n[k];
      const float sigma = (sqrtf(n0 + gq * gq) - sqrtf(n0)) / h.lr_eta;
      const float z2 = z0 + (gq - sigma * w0);
      const float n2 = n0 + gq * gq;
      const float eta = (h.lr_beta + sqrtf(n2)) / h.lr_eta;
      w2 = l1l2_solve(-z2, eta, h.lambda_l1, h.lambda_l2);
      z[k] = z2;
      n[k] = n2;
    } else if (raw != 0.0f) {  // touched: the key received a push
      float eta = h.sgd_eta;
      if (kAlgo == kAdagrad) {
        const float n2 = n[k] + gq * gq;
        eta = (h.lr_beta + sqrtf(n2)) / h.lr_eta;
        n[k] = n2;
      }
      w2 = l1l2_solve(eta * w0 - gq, eta, h.lambda_l1, h.lambda_l2);
    }
    w[k] = w2;
    if (kAdd) add_table[k] += add_values[s];
    was_nz = w0 != 0.0f;
    is_nz = w2 != 0.0f;
  }
  const int c_new = __syncthreads_count(is_nz);
  const int c_old = __syncthreads_count(was_nz);
  if (threadIdx.x == 0 && c_new != c_old) atomicAdd(new_w, c_new - c_old);
}

struct Args {
  float *z, *n, *w, *add_table;
  const float *add_values, *g, *qscale;
  const int* uniq;
  int64_t u_cap, num_buckets;
  Hyper h;
  int* new_w;
  cudaStream_t stream;
};

template <int kAlgo, int kFixedBytes, bool kBf16, bool kAdd>
void launch(const Args& a) {
  const unsigned blocks = static_cast<unsigned>((a.u_cap + kThreads - 1) / kThreads);
  scatter_update_kernel<kAlgo, kFixedBytes, kBf16, kAdd>
      <<<blocks, kThreads, 0, a.stream>>>(a.z, a.n, a.w, a.add_table,
                                          a.add_values, a.g, a.uniq, a.qscale,
                                          a.u_cap, a.num_buckets, a.h,
                                          a.new_w);
}

template <int kAlgo, int kFixedBytes, bool kBf16>
void launch_add(const Args& a) {
  if (a.add_table) launch<kAlgo, kFixedBytes, kBf16, true>(a);
  else launch<kAlgo, kFixedBytes, kBf16, false>(a);
}

template <int kAlgo, int kFixedBytes>
void launch_bf16(const Args& a, bool bf16) {
  if (bf16) launch_add<kAlgo, kFixedBytes, true>(a);
  else launch_add<kAlgo, kFixedBytes, false>(a);
}

template <int kAlgo>
bool launch_fixed(const Args& a, int fixed_bytes, bool bf16) {
  switch (fixed_bytes) {
    case 0: launch_bf16<kAlgo, 0>(a, bf16); return true;
    case 1: launch_bf16<kAlgo, 1>(a, bf16); return true;
    case 2: launch_bf16<kAlgo, 2>(a, bf16); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

const char* wh_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// algo: 0 ftrl {z, n, w}, 1 adagrad {n, w}, 2 sgd {w}; unused table
// pointers may be null. add_table/add_values: optional additive table
// (null for none). qscale: device scalar, read only when fixed_bytes == 1.
// new_w: device int32, set to the step's |w|_0 delta.
int wh_scatter_update(int algo, int fixed_bytes, int bf16, void* z, void* n,
                      void* w, void* add_table, const void* add_values,
                      const void* g, const void* uniq, const void* qscale,
                      int64_t u_cap, int64_t num_buckets, float lr_eta,
                      float lr_beta, float lambda_l1, float lambda_l2,
                      float sgd_eta, void* new_w, void* stream) {
  Args a;
  a.z = static_cast<float*>(z);
  a.n = static_cast<float*>(n);
  a.w = static_cast<float*>(w);
  a.add_table = static_cast<float*>(add_table);
  a.add_values = static_cast<const float*>(add_values);
  a.g = static_cast<const float*>(g);
  a.qscale = static_cast<const float*>(qscale);
  a.uniq = static_cast<const int*>(uniq);
  a.u_cap = u_cap;
  a.num_buckets = num_buckets;
  a.h = Hyper{lr_eta, lr_beta, lambda_l1, lambda_l2, sgd_eta};
  a.new_w = static_cast<int*>(new_w);
  a.stream = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(new_w, 0, sizeof(int), a.stream);
  if (u_cap <= 0) return static_cast<int>(cudaGetLastError());
  bool ok = false;
  switch (algo) {
    case kFtrl: ok = launch_fixed<kFtrl>(a, fixed_bytes, bf16 != 0); break;
    case kAdagrad: ok = launch_fixed<kAdagrad>(a, fixed_bytes, bf16 != 0); break;
    case kSgd: ok = launch_fixed<kSgd>(a, fixed_bytes, bf16 != 0); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
