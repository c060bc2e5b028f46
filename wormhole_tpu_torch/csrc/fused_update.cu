// The optimizer updates at the batch's unique keys, in place, and the
// embedding-row gather, written by hand for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of wormhole_tpu/ops/fused_update.py:
//   scatter_update   (_kernel, :85; wrapper :329)
//   row_tile_gather  (_row_gather_kernel, :184; wrapper :196)
//   v_scatter_update (_v_update_kernel, :225; wrapper :279)
// The last two come after scatter_update, below.
//
// scatter_update: the TPU kernel walks each touched (512, 128) table tile,
// scatters the compact gradient into it with a one-hot MXU matmul, applies
// the FTRL / AdaGrad / SGD handle to the whole tile and writes the tile
// back. Here uniq names each key at most once, so each live slot's key is
// read, updated and written back by one thread: no scatter, no
// collisions, and the untouched entries of a touched tile are never read
// (in the TPU kernel they are exact no-ops: FTRL with g = 0, and the
// g != 0 mask of AdaGrad/SGD).
//
// Bound: device memory, by random accesses. Each live key costs a
// 32-byte sector of each state table read and written back, in tables of
// up to 256 MB, while most compact slots are sentinel holes: the pack
// puts a tile's ~164 keys at the front of its 1,024-slot block, so at
// 2^26 buckets 89% of the slots hold no key. On an H100 at 2^26 (167,650
// keys) FTRL takes as long as a probe that only reads and writes back z,
// n and w at a list of the live keys (chip_smoke.py's floor_ms): the
// three tables' scattered sectors set it, not this kernel's structure.
// One record of (z, n, w) per key would need one sector. The design:
//  - a persistent grid of kSuCtasPerSm CTAs per SM; each warp walks
//    chunks of 128 slots (4 coalesced uniq loads a lane, the next chunk's
//    loads issued before this one is used), skips an all-sentinel chunk
//    after one ballot, and queues the live keys of its chunks, with
//    their g, in a ring in shared memory (ballot + popc give each key its
//    place);
//  - once 128 keys are queued, each lane takes 4 of them and issues all
//    their state loads before the first use, so a random-access
//    instruction serves 32 live keys and a thread has up to 12 in flight;
//  - an entry is stored only where its bits change, so a w that stays 0
//    under L1 (most of a sparse model's keys) leaves its line clean;
//  - the |w|_0 delta: per-CTA integer counts go to scratch, and the last
//    CTA to finish (a ticket counter) sums them in a fixed order, writes
//    new_w and resets the counter. One launch per call, no memset.
// The kernel is right for any uniq (sentinels anywhere, keys in any
// order); the prefix layout only makes the chunk skip pay.
//
// Numerics follow models/linear._update of the JAX package in f32 with
// IEEE sqrt and division; the build passes -fmad=false so no product is
// fused into an add the plain version rounds separately. The push filter
// (fixed_bytes) rounds half to even (rintf), like jnp.round. In bf16 mode
// the gradient is rounded to bf16 before the filter, where the TPU
// kernel's scatter matmul rounds it. The |w|_0 delta is an integer sum,
// so it is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
enum Algo { kFtrl = 0, kAdagrad = 1, kSgd = 2 };

constexpr int kSuThreads = 256;
constexpr int kSuWarps = kSuThreads / 32;
constexpr int kSuCtasPerSm = 3;  // 85 registers a thread: no spills
constexpr int kSuChunk = 128;  // slots a warp loads at once, 4 a lane
constexpr int kSuPer = 4;      // queued keys a lane updates at once
constexpr int kSuFlush = 32 * kSuPer;
constexpr int kSuRing = 256;   // >= kSuFlush - 1 + kSuChunk, a power of 2

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
__device__ __forceinline__ float quantize(float g, float s) {
  if (kFixedBytes == 0) return g;
  if (kFixedBytes >= 2) return round_bf16(g);
  const float q = fminf(fmaxf(rintf(g / s), -127.0f), 127.0f);
  return q * s;
}

// A store only where the value's bits change: an unchanged entry (w that
// stays 0 under L1, a count that adds 0) leaves its line clean, and a
// clean line costs no write back to device memory.
__device__ __forceinline__ void store_changed(float* p, float old, float v) {
  if (__float_as_int(v) != __float_as_int(old)) *p = v;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The values of one 128-slot chunk of a per-slot array (uniq, vtouched):
// lane l holds slots l, l + 32, l + 64, l + 96 (each load coalesced,
// streamed); `past` past the end.
template <class T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a, int64_t c,
                                           int64_t u_cap, unsigned lane,
                                           T (&v)[4], T past = T(-1)) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t s = c * kSuChunk + j * 32 + lane;
    v[j] = s < u_cap ? __ldcs(&a[s]) : past;
  }
}

// Update the `count` keys queued from ring position `head` on; lane l
// takes queue entries l, l + 32, ... All state loads are issued before
// the first use. Returns this lane's part of the |w|_0 delta.
template <int kAlgo, int kFixedBytes, bool kBf16, bool kAdd>
__device__ __forceinline__ int update_queued(
    float* __restrict__ z, float* __restrict__ n, float* __restrict__ w,
    float* __restrict__ add_table, const int* q_key, const float* q_g,
    const float* q_add, int head, int count, unsigned lane, const Hyper& h,
    float qs) {
  int k[kSuPer];
  float raw[kSuPer], av[kSuPer], w0[kSuPer], z0[kSuPer], n0[kSuPer],
      c0[kSuPer];
  bool on[kSuPer];
#pragma unroll
  for (int j = 0; j < kSuPer; ++j) {
    const int i = static_cast<int>(lane) + 32 * j;
    const int pos = (head + i) & (kSuRing - 1);
    on[j] = false;
    if (i < count) {
      k[j] = q_key[pos];
      raw[j] = q_g[pos];
      if (kBf16) raw[j] = round_bf16(raw[j]);
      if (kAdd) av[j] = q_add[pos];
      // FTRL updates every live key; AdaGrad/SGD only the pushed ones
      on[j] = kAlgo == kFtrl || raw[j] != 0.0f;
      if (on[j]) {
        w0[j] = w[k[j]];
        if (kAlgo == kFtrl) z0[j] = z[k[j]];
        if (kAlgo != kSgd) n0[j] = n[k[j]];
      }
      if (kAdd) c0[j] = add_table[k[j]];
    }
  }
  int delta = 0;
#pragma unroll
  for (int j = 0; j < kSuPer; ++j) {
    const int i = static_cast<int>(lane) + 32 * j;
    if (i >= count) continue;
    if (kAdd) store_changed(&add_table[k[j]], c0[j], c0[j] + av[j]);
    if (!on[j]) continue;
    const float gq = quantize<kFixedBytes>(raw[j], qs);
    float w2;
    if (kAlgo == kFtrl) {
      const float sigma = (sqrtf(n0[j] + gq * gq) - sqrtf(n0[j])) / h.lr_eta;
      const float z2 = z0[j] + (gq - sigma * w0[j]);
      const float n2 = n0[j] + gq * gq;
      const float eta = (h.lr_beta + sqrtf(n2)) / h.lr_eta;
      w2 = l1l2_solve(-z2, eta, h.lambda_l1, h.lambda_l2);
      store_changed(&z[k[j]], z0[j], z2);
      store_changed(&n[k[j]], n0[j], n2);
    } else {
      float eta = h.sgd_eta;
      if (kAlgo == kAdagrad) {
        const float n2 = n0[j] + gq * gq;
        eta = (h.lr_beta + sqrtf(n2)) / h.lr_eta;
        store_changed(&n[k[j]], n0[j], n2);
      }
      w2 = l1l2_solve(eta * w0[j] - gq, eta, h.lambda_l1, h.lambda_l2);
    }
    store_changed(&w[k[j]], w0[j], w2);
    delta += static_cast<int>(w2 != 0.0f) - static_cast<int>(w0[j] != 0.0f);
  }
  return delta;
}

// scratch: [0] the finished-CTA ticket (0 between launches), [1 + b] the
// |w|_0 count of CTA b.
template <int kAlgo, int kFixedBytes, bool kBf16, bool kAdd>
__global__ void __launch_bounds__(kSuThreads, kSuCtasPerSm)
scatter_update_kernel(
    float* __restrict__ z, float* __restrict__ n, float* __restrict__ w,
    float* __restrict__ add_table, const float* __restrict__ add_values,
    const float* __restrict__ g, const int* __restrict__ uniq,
    const float* __restrict__ qscale, int64_t u_cap, int64_t num_buckets,
    Hyper h, int* __restrict__ new_w, int* __restrict__ scratch) {
  __shared__ int q_key[kSuWarps][kSuRing];
  __shared__ float q_g[kSuWarps][kSuRing];
  __shared__ float q_add[kSuWarps][kAdd ? kSuRing : 1];
  __shared__ int part[kSuWarps];
  __shared__ bool last_cta;
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t nchunks = (u_cap + kSuChunk - 1) / kSuChunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSuWarps;
  const float qs = kFixedBytes == 1 ? *qscale : 1.0f;
  int* qk = q_key[warp];
  float* qg = q_g[warp];
  float* qa = q_add[warp];
  int head = 0, tail = 0;  // ring positions, the same in every lane
  int delta = 0;

  int64_t c = static_cast<int64_t>(blockIdx.x) * kSuWarps + warp;
  int key[4];
  load_chunk(uniq, c, u_cap, lane, key);
  while (c < nchunks) {
    const int64_t cn = c + stride;
    int next[4];
    load_chunk(uniq, cn, u_cap, lane, next);
    bool live[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      live[j] = key[j] >= 0 && key[j] < num_buckets;  // sentinels skip
      any |= live[j];
    }
    if (__any_sync(kFull, any)) {
      float gv[4], av[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t s = c * kSuChunk + j * 32 + lane;
        if (live[j]) {
          gv[j] = g[s];
          if (kAdd) av[j] = add_values[s];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned m = __ballot_sync(kFull, live[j]);
        if (live[j]) {
          const int pos = (tail + __popc(m & below)) & (kSuRing - 1);
          qk[pos] = key[j];
          qg[pos] = gv[j];
          if (kAdd) qa[pos] = av[j];
        }
        tail += __popc(m);
      }
      __syncwarp();
      if (tail - head >= kSuFlush) {
        delta += update_queued<kAlgo, kFixedBytes, kBf16, kAdd>(
            z, n, w, add_table, qk, qg, qa, head, kSuFlush, lane, h, qs);
        head += kSuFlush;
        __syncwarp();
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = next[j];
    c = cn;
  }
  if (tail > head) {
    delta += update_queued<kAlgo, kFixedBytes, kBf16, kAdd>(
        z, n, w, add_table, qk, qg, qa, head, tail - head, lane, h, qs);
  }

  delta = warp_sum(delta);
  if (lane == 0u) part[warp] = delta;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int i = 0; i < kSuWarps; ++i) sum += part[i];
    scratch[1 + blockIdx.x] = sum;
    __threadfence();
    last_cta = atomicAdd(&scratch[0], 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  int sum = 0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kSuThreads) {
    sum += __ldcg(&scratch[1 + i]);
  }
  sum = warp_sum(sum);
  if (lane == 0u) part[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kSuWarps; ++i) total += part[i];
    *new_w = total;
    scratch[0] = 0;
  }
}

struct Args {
  float *z, *n, *w, *add_table;
  const float *add_values, *g, *qscale;
  const int* uniq;
  int64_t u_cap, num_buckets;
  Hyper h;
  int *new_w, *scratch;
  unsigned ctas;
  cudaStream_t stream;
};

template <int kAlgo, int kFixedBytes, bool kBf16, bool kAdd>
void launch(const Args& a) {
  scatter_update_kernel<kAlgo, kFixedBytes, kBf16, kAdd>
      <<<a.ctas, kSuThreads, 0, a.stream>>>(
          a.z, a.n, a.w, a.add_table, a.add_values, a.g, a.uniq, a.qscale,
          a.u_cap, a.num_buckets, a.h, a.new_w, a.scratch);
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

// SMs of the current device, read once per device.
int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cache[dev]) return cache[dev];
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < 64) cache[dev] = v;
  return v > 0 ? v : 1;
}

// ------------------------------------------------ embedding-row kernels
// DiFacto's V table is (rows, dim) f32, row-major, dim a power of two
// dividing 128. The TPU kernels stream each touched (512, 128) flat tile
// through VMEM and pick rows out of it with one-hot matmuls (Mosaic has no
// sublane gather). Here rows are read and written where they lie: each
// row appears at one compact slot only, so no two threads write one entry
// and there is no float atomic; two calls give the same bits.
//
// What bounds them. At the bench (394,240 slots, 155,342 rows, 72,661 of
// them admitted, dim 8: a row is one 32-byte sector) 61% of the slots are
// sentinel holes, and each tile's live slots come first, so whole
// 128-slot chunks hold no row. A thread per (slot, channel) would run
// 3.15M threads that each load their own uniq entry and 4 bytes of a row
// behind a chain of dependent loads, with nothing else in flight: bound by
// latency, not bytes. With the design below, on an H100, the gather runs
// at its byte bound (the 12.6 MB output), and the update's time splits
// into loads and stores at the admitted rows, the slot scan, and the IEEE
// sqrt and two divisions of each entry, which on lanes tied to slots
// would idle through the unadmitted half of them (tools/v_row_lab.py
// times each part). The design:
//  - a persistent grid of kRowCtasPerSm CTAs per SM; each warp owns
//    chunks of kRowChunk slots (4 coalesced uniq loads a lane, and in
//    the update 4 of vtouched, streamed), walks them by a grid stride and
//    issues the next chunk's loads before this one is used;
//  - the gather writes a chunk with no row as 16-byte zero stores and
//    loads nothing; the update queues a chunk's admitted slots in shared
//    memory (one ballot each of 4 slot columns), so a chunk with none
//    costs nothing more and the arithmetic runs on full warps;
//  - rows move as vectors of min(dim, 4) floats, neighbouring lanes on
//    neighbouring vectors (several vectors a row above dim 4, a vector a
//    row below it). In the gather a lane's vector it of the chunk is the
//    chunk's vector 32 it + lane, its slot from the lane that loaded it,
//    by a shuffle (ops/fused_update.row_walk mirrors this); a lane issues
//    the loads of kGatherBatch vectors (update: kUpdateBatch) before
//    it uses the first;
//  - V is read through the read-only path in the gather; gV, uniq,
//    vtouched and the gather's output are streamed (evict-first).
// Numerics: the JAX operation order in f32, IEEE sqrtf and division, no
// fused multiply-add (-fmad=false); the gather is exact.
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
// tools/v_row_lab.py times other values of these three. At dim 8 the
// update takes 68 registers a thread and spills nothing; 4 vectors a
// batch spill at 3 CTAs an SM, and 4 CTAs gain nothing.
constexpr int kRowCtasPerSm = 3;
constexpr int kGatherBatch = 8;  // vectors a lane loads at once
constexpr int kUpdateBatch = 2;
constexpr int kRowChunk = 128;  // slots a warp owns at once, 4 a lane
static_assert(kRowChunk == kSuChunk, "load_chunk lays out 128 slots");

template <int kW> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

template <class T>
__device__ __forceinline__ float* lanes_of(T& v) {
  return reinterpret_cast<float*>(&v);
}

template <class T>
__device__ __forceinline__ T zero_vec() {
  T v;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 4); ++i) {
    lanes_of(v)[i] = 0.0f;
  }
  return v;
}

__device__ __forceinline__ int pick(const int (&a)[4], int q) {
  return q == 0 ? a[0] : q == 1 ? a[1] : q == 2 ? a[2] : a[3];
}

// Where a lane's vector `it` of a chunk lies: vector index 32 it + lane,
// so slot 32 q + src of the chunk, whose uniq lane src loaded as its
// key[q], and the part `part` (of kEpr) of that slot's row.
template <int kEpr>
struct RowVec {
  int q, src, part;
  __device__ __forceinline__ RowVec(int it, unsigned lane) {
    const int f = (it % kEpr) * 32 + static_cast<int>(lane);
    q = it / kEpr;
    src = f / kEpr;
    part = f % kEpr;
  }
};

// Gather: out[s] = V[uniq[s]], 0.0 at sentinel slots (uniq == rows), as
// the TPU kernel's all-zero one-hot rows give. bf16 mode rounds the
// value, where the TPU kernel's row-fetch matmul operand rounds.
template <int kDimShift, bool kBf16>
__global__ void __launch_bounds__(kRowThreads, kRowCtasPerSm)
row_gather_kernel(const float* __restrict__ V, const int* __restrict__ uniq,
                  float* __restrict__ out, int64_t u_cap, int64_t rows) {
  constexpr int kDim = 1 << kDimShift;
  constexpr int kW = kDim < 4 ? kDim : 4;
  constexpr int kEpr = kDim / kW;    // vectors a row
  constexpr int kPer = 4 * kEpr;     // vectors a lane, a chunk
  constexpr int kB = kPer < kGatherBatch ? kPer : kGatherBatch;
  using T = typename VecOf<kW>::T;
  const unsigned lane = threadIdx.x & 31u;
  const int64_t nchunks = (u_cap + kRowChunk - 1) / kRowChunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowWarps;
  const T* Vv = reinterpret_cast<const T*>(V);
  const int warp = threadIdx.x >> 5;
  int64_t c = static_cast<int64_t>(blockIdx.x) * kRowWarps + warp;
  int key[4];
  load_chunk(uniq, c, u_cap, lane, key);
  while (c < nchunks) {
    const int64_t cn = c + stride;
    int next[4];
    load_chunk(uniq, cn, u_cap, lane, next);
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (key[j] >= rows) key[j] = -1;  // sentinel
      any |= key[j] >= 0;
    }
    T* o = reinterpret_cast<T*>(out) + c * kRowChunk * kEpr;
    if (!__any_sync(kFull, any) && (c + 1) * kRowChunk <= u_cap) {
      float4* o4 = reinterpret_cast<float4*>(out + c * kRowChunk * kDim);
#pragma unroll 4
      for (int i = lane; i < kRowChunk * kDim / 4; i += 32) {
        __stcs(&o4[i], zero_vec<float4>());
      }
    } else {
      const int64_t s0 = c * kRowChunk;
#pragma unroll 1
      for (int it0 = 0; it0 < kPer; it0 += kB) {
        T v[kB];
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const RowVec<kEpr> at(it0 + b, lane);
          const int k = __shfl_sync(kFull, pick(key, at.q), at.src);
          v[b] = k >= 0 ? __ldg(&Vv[static_cast<int64_t>(k) * kEpr + at.part])
                        : zero_vec<T>();
        }
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const RowVec<kEpr> at(it0 + b, lane);
          if (s0 + at.q * 32 + at.src >= u_cap) continue;
          if (kBf16) {
#pragma unroll
            for (int i = 0; i < kW; ++i) {
              lanes_of(v[b])[i] = round_bf16(lanes_of(v[b])[i]);
            }
          }
          __stcs(&o[(it0 + b) * 32 + lane], v[b]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = next[j];
    c = cn;
  }
}

// AdaGrad V handle (difacto async_sgd.h:289-296) at the admitted slots, in
// the JAX operation order: nV += g * g; eta = (beta + sqrt(nV)) / eta0;
// V -= (g + lambda_V * V) / eta. Unadmitted slots (vtouched == 0) and
// sentinel slots change nothing. bf16 mode rounds g first, where the TPU
// kernel's scatter matmul rounds it. A chunk's admitted slots are queued
// in shared memory (ballot and popc give each its place, in slot order),
// and the warp's lanes take the queued rows' vectors 32 at a time, so the
// IEEE sqrt and the two divisions of each entry run on full warps.
template <int kDimShift, bool kBf16>
__global__ void __launch_bounds__(kRowThreads, kRowCtasPerSm)
v_update_kernel(float* __restrict__ V, float* __restrict__ nV,
                const float* __restrict__ gV,
                const float* __restrict__ vtouched,
                const int* __restrict__ uniq, int64_t u_cap, int64_t rows,
                float V_lr_eta, float V_lr_beta, float lambda_V) {
  constexpr int kDim = 1 << kDimShift;
  constexpr int kW = kDim < 4 ? kDim : 4;
  constexpr int kEpr = kDim / kW;
  constexpr int kB = kUpdateBatch;
  using T = typename VecOf<kW>::T;
  __shared__ int q_key[kRowWarps][kRowChunk];
  __shared__ int q_slot[kRowWarps][kRowChunk];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  const int warp = threadIdx.x >> 5;
  int* qk = q_key[warp];
  int* qs = q_slot[warp];
  const int64_t nchunks = (u_cap + kRowChunk - 1) / kRowChunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowWarps;
  T* Vv = reinterpret_cast<T*>(V);
  T* nVv = reinterpret_cast<T*>(nV);
  int64_t c = static_cast<int64_t>(blockIdx.x) * kRowWarps + warp;
  int key[4];
  float tch[4];
  load_chunk(uniq, c, u_cap, lane, key);
  load_chunk(vtouched, c, u_cap, lane, tch, 0.0f);
  while (c < nchunks) {
    const int64_t cn = c + stride;
    int next[4];
    float next_t[4];
    load_chunk(uniq, cn, u_cap, lane, next);
    load_chunk(vtouched, cn, u_cap, lane, next_t, 0.0f);
    int count = 0;  // admitted slots queued, the same in every lane
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool adm = key[j] >= 0 && key[j] < rows && tch[j] > 0.0f;
      const unsigned m = __ballot_sync(kFull, adm);
      if (adm) {
        const int pos = count + __popc(m & below);
        qk[pos] = key[j];
        qs[pos] = j * 32 + static_cast<int>(lane);
      }
      count += __popc(m);
    }
    __syncwarp();
    const T* g_chunk = reinterpret_cast<const T*>(gV) + c * kRowChunk * kEpr;
    const int nvec = count * kEpr;  // 0 skips the chunk
    for (int v0 = 0; v0 < nvec; v0 += 32 * kB) {
      int64_t e[kB];
      T g[kB], va[kB], na[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int i = v0 + b * 32 + static_cast<int>(lane);
        e[b] = -1;
        if (i < nvec) {
          const int entry = i / kEpr, part = i % kEpr;
          e[b] = static_cast<int64_t>(qk[entry]) * kEpr + part;
          g[b] = __ldcs(&g_chunk[qs[entry] * kEpr + part]);
          va[b] = Vv[e[b]];
          na[b] = nVv[e[b]];
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (e[b] < 0) continue;
        T v2, n2;
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          float gi = lanes_of(g[b])[i];
          if (kBf16) gi = round_bf16(gi);
          const float vi = lanes_of(va[b])[i];
          const float ni = lanes_of(na[b])[i] + gi * gi;
          const float eta = (V_lr_beta + sqrtf(ni)) / V_lr_eta;
          lanes_of(v2)[i] = vi - (gi + lambda_V * vi) / eta;
          lanes_of(n2)[i] = ni;
        }
        Vv[e[b]] = v2;
        nVv[e[b]] = n2;
      }
    }
    __syncwarp();  // the queue is read before the next chunk refills it
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      key[j] = next[j];
      tch[j] = next_t[j];
    }
    c = cn;
  }
}

// Both row kernels' grid: enough warps for the chunks, at most
// kRowCtasPerSm CTAs an SM.
unsigned row_grid(int64_t u_cap) {
  const int64_t chunks = (u_cap + kRowChunk - 1) / kRowChunk;
  const int64_t ctas = (chunks + kRowWarps - 1) / kRowWarps;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kRowCtasPerSm;
  return static_cast<unsigned>(ctas < cap ? ctas : cap);
}

bool misaligned(const void* p, int dim_shift) {
  const int vec_bytes = 4 * (dim_shift < 2 ? 1 << dim_shift : 4);
  return reinterpret_cast<uintptr_t>(p) % vec_bytes != 0;
}

// Calls f(dim_shift, bf16) with both as compile-time constants.
template <int kDimShift, class F>
void with_bf16(bool bf16, F& f) {
  if (bf16) f(std::integral_constant<int, kDimShift>(), std::true_type());
  else f(std::integral_constant<int, kDimShift>(), std::false_type());
}

template <class F>
bool with_dim(int dim_shift, bool bf16, F f) {
  switch (dim_shift) {
    case 0: with_bf16<0>(bf16, f); return true;
    case 1: with_bf16<1>(bf16, f); return true;
    case 2: with_bf16<2>(bf16, f); return true;
    case 3: with_bf16<3>(bf16, f); return true;
    case 4: with_bf16<4>(bf16, f); return true;
    case 5: with_bf16<5>(bf16, f); return true;
    case 6: with_bf16<6>(bf16, f); return true;
    case 7: with_bf16<7>(bf16, f); return true;
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
// (null for none). qscale: device scalar, read only when fixed_bytes == 1
// (may be null otherwise). new_w: device int32, set to the step's |w|_0
// delta. scratch: scratch_ints >= 2 device int32, zero before the first
// call and left zero by each (one stream at a time). One launch.
int wh_scatter_update(int algo, int fixed_bytes, int bf16, void* z, void* n,
                      void* w, void* add_table, const void* add_values,
                      const void* g, const void* uniq, const void* qscale,
                      int64_t u_cap, int64_t num_buckets, float lr_eta,
                      float lr_beta, float lambda_l1, float lambda_l2,
                      float sgd_eta, void* new_w, void* scratch,
                      int64_t scratch_ints, void* stream) {
  if ((fixed_bytes == 1 && !qscale) || scratch_ints < 2 || u_cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  a.scratch = static_cast<int*>(scratch);
  a.stream = static_cast<cudaStream_t>(stream);
  // enough warps for the chunks, at most kSuCtasPerSm CTAs an SM
  const int64_t warps = (u_cap + kSuChunk - 1) / kSuChunk;
  int64_t ctas = (warps + kSuWarps - 1) / kSuWarps;
  ctas = ctas < 1 ? 1 : ctas;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kSuCtasPerSm;
  ctas = ctas < cap ? ctas : cap;
  ctas = ctas < scratch_ints - 1 ? ctas : scratch_ints - 1;
  a.ctas = static_cast<unsigned>(ctas);
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

// V: (rows, dim) f32 flat; uniq: (u_cap,) int32; out: (u_cap, dim) f32.
// One launch (none when u_cap is 0); V and out aligned to a row vector.
int wh_row_tile_gather(const void* V, const void* uniq, void* out,
                       int64_t u_cap, int64_t rows, int dim_shift, int bf16,
                       void* stream) {
  if (dim_shift < 0 || dim_shift > 7 || u_cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (misaligned(V, dim_shift) || misaligned(out, dim_shift)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (u_cap > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    with_dim(dim_shift, bf16 != 0, [&](auto d, auto b) {
      row_gather_kernel<decltype(d)::value, decltype(b)::value>
          <<<row_grid(u_cap), kRowThreads, 0, st>>>(
              static_cast<const float*>(V), static_cast<const int*>(uniq),
              static_cast<float*>(out), u_cap, rows);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// V, nV: (rows, dim) f32 flat, updated in place; gV: (u_cap, dim) f32;
// vtouched: (u_cap,) f32; uniq: (u_cap,) int32. One launch (none when
// u_cap is 0); V, nV and gV aligned to a row vector.
int wh_v_scatter_update(void* V, void* nV, const void* gV,
                        const void* vtouched, const void* uniq, int64_t u_cap,
                        int64_t rows, int dim_shift, int bf16, float V_lr_eta,
                        float V_lr_beta, float lambda_V, void* stream) {
  if (dim_shift < 0 || dim_shift > 7 || u_cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (misaligned(V, dim_shift) || misaligned(nV, dim_shift) ||
      misaligned(gV, dim_shift)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (u_cap > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    with_dim(dim_shift, bf16 != 0, [&](auto d, auto b) {
      v_update_kernel<decltype(d)::value, decltype(b)::value>
          <<<row_grid(u_cap), kRowThreads, 0, st>>>(
              static_cast<float*>(V), static_cast<float*>(nV),
              static_cast<const float*>(gV),
              static_cast<const float*>(vtouched),
              static_cast<const int*>(uniq), u_cap, rows, V_lr_eta,
              V_lr_beta, lambda_V);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
