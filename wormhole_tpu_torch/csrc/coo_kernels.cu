// Sparse COO products, the compact-slot gather and the FM embedding push,
// written by hand for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of wormhole_tpu/ops/coo_kernels.py:
//   coo_spmv    (_pull_kernel, :280)         xw[r] = sum val * w[idx]
//   coo_spmv_t  (_push_kernel, :343)         g[k]  = sum val * d[seg]
//   tile_gather (_tile_gather_kernel, :579)  out[s] = table[uniq[s]]
//   fm_push_contrib (_fm_push_contrib_kernel, :630)
//                 out[j] = sum a[e] - (sum b[e]) * V[j] over sidx[e] == j
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
// run (results agree to rtol 1e-5 with the plain version). On the bench's
// dense batch the 2.6M global reds into 65,536 rows set the pace (a probe
// that only reads the stream takes a third of the time; chip_smoke.py's
// [probe] line), so the kernel keeps one thread per entry, the most reds
// in flight, and reads the stream with evict-first loads so that w and
// the output keep their place in L2. (Four entries a thread with 16-byte
// loads, two a thread, and summing in a thread-block cluster's shared
// memory were slower on sm_90, the last because an f32 atomic add to
// shared or distributed shared memory is a compare-and-swap loop.)
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
  const float v = __ldcs(&val[i]);
  if (v == 0.0f) return;  // padding entries: idx and seg are not read
  const int k = __ldcs(&idx[i]);
  const int r = __ldcs(&seg[i]);
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
//
// The order of those atomics changes from call to call, so g is not
// repeatable bit for bit. Deterministic reductions by key that write g
// once, with no memset, were 1.2 to 2.7x slower at the bench's batches on
// sm_90 (PERF.md, section 6).
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

// ---------------------------------------------------------- FM push
// fm_push_contrib: per-row sums of the (a | b) stream of the slot-sorted
// V-side COO, then out[j] = A[j] - B[j] * V[j]. Bound by device memory: it
// reads (dim + 2) words of each entry once and writes each output row once.
//
// The TPU kernel scatters each FM_BLK block into its tile with a one-hot
// matmul and carries the tile's sums across grid steps. Here the sums are
// a deterministic segmented reduction over the sorted stream, in two
// kernels:
//  1. fm_push_local_kernel: one CTA per chunk of kFmChunk entries finds
//     the chunk's runs of equal sidx (head flags and a CTA scan in shared
//     memory), then each warp sums whole runs: lanes stride over the run's
//     entries, one float4 load per four channels, and a butterfly of
//     shuffles adds the lanes in a fixed order (every lane ends with the
//     same totals). A run that starts and ends inside the chunk writes its
//     output row. A run cut by a chunk edge writes its partial sums to
//     scratch instead, and the chunk's flags say which edge it crosses.
//  2. fm_push_combine_kernel: one warp per chunk whose last run starts in
//     it and continues into the next chunk. Lanes take the following
//     chunks 32 at a time, a ballot finds the first chunk where the run
//     ends, and the lanes' partials meet in a butterfly again. The Zipf
//     head row, whose run spans ~16 chunks, costs one such step.
// No float atomics, so the result is the same from run to run.
//
// For dim <= 16, fm_push_scan_kernel (after these two) takes the place of
// kernel 1: a reduce-by-key over threads that keeps every lane busy on
// short runs. For dim >= 32 a run's dim + 1 sums fill a warp's lanes, and
// kernel 1 stays.
//
// A run whose sums are all zero writes nothing: the output was zeroed
// first, and 0 - 0 * V is 0. That covers rows with no entry, and the pad
// entries (a = b = 0, sidx = tile base) that pack_sorted_coo puts after
// each tile's live entries: they form a second run of the tile's first
// row, which must not overwrite that row's real run. A live run of one row
// is contiguous in the stream, so no row has two runs with nonzero sums.
// An entry whose sidx is out of range traps.
constexpr int kFmChunk = 1024;    // stream entries per CTA of kernel 1
constexpr int kFmThreads = 256;   // 8 warps
constexpr int kFmWarps = kFmThreads / 32;
constexpr int kFmPer = kFmChunk / kFmThreads;
enum FmFlag { kFmFirstCont = 1, kFmLastCont = 2, kFmSingle = 4 };

template <int kDim>
__device__ __forceinline__ void butterfly(float (&acc)[kDim + 1]) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
    for (int c = 0; c <= kDim; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], off);
  }
}

template <int kDim>
__device__ __forceinline__ bool any_nonzero(const float (&acc)[kDim + 1]) {
  bool nz = false;
#pragma unroll
  for (int c = 0; c <= kDim; ++c) nz |= acc[c] != 0.0f;
  return nz;
}

// out[key] = A - B * V[key]; lane c writes channels c, c + 32, ...
template <int kDim>
__device__ __forceinline__ void write_row(const float (&acc)[kDim + 1],
                                          const float* __restrict__ V,
                                          float* __restrict__ out, int key,
                                          unsigned lane) {
  const int64_t row = static_cast<int64_t>(key) * kDim;
#pragma unroll
  for (int c = 0; c < kDim; ++c) {
    if ((c & 31) == static_cast<int>(lane)) {
      out[row + c] = acc[c] - acc[kDim] * V[row + c];
    }
  }
}

template <int kDim>
__device__ __forceinline__ void store_part(const float (&acc)[kDim + 1],
                                           float* __restrict__ dst,
                                           unsigned lane) {
#pragma unroll
  for (int c = 0; c <= kDim; ++c) {
    if ((c & 31) == static_cast<int>(lane)) dst[c] = acc[c];
  }
}

template <int kDim, bool kBf16>
__global__ void __launch_bounds__(kFmThreads)
fm_push_local_kernel(const float* __restrict__ V, const float* __restrict__ a,
                     const float* __restrict__ b, const int* __restrict__ sidx,
                     float* __restrict__ out, float* __restrict__ part_first,
                     float* __restrict__ part_last, int* __restrict__ flags,
                     int64_t n, int64_t rows) {
  __shared__ int keys[kFmChunk];
  __shared__ int starts[kFmChunk + 1];
  __shared__ int warp_off[kFmWarps];
  __shared__ int nruns_s;
  const int t = threadIdx.x;
  const unsigned lane = t & 31u;
  const int warp = t >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kFmChunk;
  const int cnt = static_cast<int>(n - base < kFmChunk ? n - base : kFmChunk);
  for (int i = t; i < cnt; i += kFmThreads) {
    const int k = sidx[base + i];
    if (k < 0 || k >= rows) __trap();
    keys[i] = k;
  }
  __syncthreads();

  // run heads of this thread's kFmPer consecutive entries, then a CTA-wide
  // exclusive scan of the head counts gives each head its run number
  bool head[kFmPer];
  int mine = 0;
#pragma unroll
  for (int q = 0; q < kFmPer; ++q) {
    const int i = t * kFmPer + q;
    head[q] = i < cnt && (i == 0 || keys[i] != keys[i - 1]);
    mine += head[q];
  }
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (static_cast<int>(lane) >= o) incl += y;
  }
  if (lane == 31u) warp_off[warp] = incl;
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int w = 0; w < kFmWarps; ++w) {
      const int x = warp_off[w];
      warp_off[w] = run;
      run += x;
    }
    nruns_s = run;
    starts[run] = cnt;
  }
  __syncthreads();
  int pos = warp_off[warp] + incl - mine;
#pragma unroll
  for (int q = 0; q < kFmPer; ++q) {
    if (head[q]) starts[pos++] = t * kFmPer + q;
  }
  __syncthreads();

  const int nruns = nruns_s;
  const bool cont_before = base > 0 && sidx[base - 1] == keys[0];
  const bool cont_after = base + cnt < n && sidx[base + cnt] == keys[cnt - 1];
  for (int r = warp; r < nruns; r += kFmWarps) {
    float acc[kDim + 1];
#pragma unroll
    for (int c = 0; c <= kDim; ++c) acc[c] = 0.0f;
    const int64_t e1 = base + starts[r + 1];
    for (int64_t e = base + starts[r] + lane; e < e1; e += 32) {
      const float* ar = a + e * kDim;
      if constexpr (kDim % 4 == 0) {
#pragma unroll
        for (int c = 0; c < kDim; c += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(ar + c));
          const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[c + u] += kBf16 ? round_bf16(x[u]) : x[u];
        }
      } else {
#pragma unroll
        for (int c = 0; c < kDim; ++c) {
          const float x = __ldg(ar + c);
          acc[c] += kBf16 ? round_bf16(x) : x;
        }
      }
      const float bv = __ldg(b + e);
      acc[kDim] += kBf16 ? round_bf16(bv) : bv;
    }
    butterfly<kDim>(acc);
    const bool first = r == 0 && cont_before;
    const bool last = r == nruns - 1 && cont_after;
    if (first || last) {
      float* dst = (first ? part_first : part_last) +
                   static_cast<int64_t>(blockIdx.x) * (kDim + 1);
      store_part<kDim>(acc, dst, lane);
    } else if (any_nonzero<kDim>(acc)) {
      write_row<kDim>(acc, V, out, keys[starts[r]], lane);
    }
  }
  if (t == 0) {
    flags[blockIdx.x] = (cont_before ? kFmFirstCont : 0) |
                        (cont_after ? kFmLastCont : 0) |
                        (nruns == 1 ? kFmSingle : 0);
  }
}

template <int kDim>
__global__ void fm_push_combine_kernel(const float* __restrict__ V,
                                       const int* __restrict__ sidx,
                                       float* __restrict__ out,
                                       const float* __restrict__ part_first,
                                       const float* __restrict__ part_last,
                                       const int* __restrict__ flags,
                                       int64_t nchunks) {
  constexpr int kThrough = kFmFirstCont | kFmLastCont | kFmSingle;
  const int64_t c = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const unsigned lane = threadIdx.x & 31u;
  if (c >= nchunks) return;  // the whole warp leaves together
  const int f = flags[c];
  // only the chunk where a cross-chunk run starts combines it
  if (!(f & kFmLastCont) || (f & kThrough) == kThrough) return;
  float acc[kDim + 1];
#pragma unroll
  for (int k = 0; k <= kDim; ++k) {
    acc[k] = lane == 0u ? part_last[c * (kDim + 1) + k] : 0.0f;
  }
  for (int64_t v0 = c + 1;; v0 += 32) {
    const int64_t v = v0 + lane;
    const bool through = v < nchunks && (flags[v] & kThrough) == kThrough;
    const unsigned ends = __ballot_sync(kFull, !through);
    const int end_lane = ends ? __ffs(ends) - 1 : 32;
    if (static_cast<int>(lane) <= end_lane && v < nchunks) {
#pragma unroll
      for (int k = 0; k <= kDim; ++k) acc[k] += part_first[v * (kDim + 1) + k];
    }
    if (ends) break;
  }
  butterfly<kDim>(acc);
  if (any_nonzero<kDim>(acc)) {
    write_row<kDim>(acc, V, out, sidx[(c + 1) * kFmChunk - 1], lane);
  }
}

// fm_push_scan_kernel: the local pass for dim <= 16, a reduce-by-key that
// keeps every lane busy whatever the run lengths (the warp-per-run kernel
// above idles most lanes on Zipf's short runs and pays a 5-step butterfly
// over dim + 1 values per run). One CTA of kFmScanThreads threads per
// chunk of kFmChunk entries:
//  1. the chunk's a, b and sidx are staged into shared memory with
//     cp.async, 16 bytes a lane with neighbours on neighbouring addresses
//     (a XOR swizzle on the 16-byte words keeps the per-thread reads below
//     free of bank conflicts);
//  2. thread t takes the kFmItems consecutive entries from kFmItems * t and
//     sums them serially in registers, cutting at run heads (key !=
//     previous key). A run that starts and ends inside the thread is
//     complete and written at once. What remains are the thread's first
//     run (which may continue a run of earlier threads) and its tail (the
//     carry into later threads);
//  3. a segmented inclusive scan of the tails over the warp (shuffles, in
//     a fixed order), then over the CTA's warps in order, gives each
//     thread the carry of the run its first entry belongs to. The thread
//     that holds a run's last entry writes its row.
// The chunk's first and last runs, when they cross the chunk's edges, go
// to part_first / part_last with the same flags as the local kernel above,
// so fm_push_combine_kernel finishes them. The same rules for zero sums
// (nothing written) and pads hold, and the result is the same from run to
// run (no atomics, a fixed order of adds).
constexpr int kFmScanThreads = 128;
constexpr int kFmScanWarps = kFmScanThreads / 32;
constexpr int kFmItems = kFmChunk / kFmScanThreads;  // 8
constexpr int kFmScanMaxDim = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Where 16-byte word f of a staged array lands in shared memory, when
// each thread reads its own run of kWords consecutive words: f is XORed
// with a few bits above the run, so it stays inside the run, and the
// eight lanes of a quarter warp that read word q of their runs hit the
// eight bank groups (word mod 8) once each, not two to eight times.
template <int kWords>
__device__ __forceinline__ int fm_swizzle(int f) {
  if constexpr (kWords >= 8) {
    return f ^ ((f / kWords) & 7);
  } else {
    return f ^ ((f >> 3) & (kWords - 1));
  }
}

// nf floats from src into dst (16-byte words through swizzle kWords when
// src is 16-byte aligned, else 4 bytes at a time), by all threads.
template <int kWords>
__device__ __forceinline__ void stage(float* dst, const float* src, int nf,
                                      int t) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15u) == 0;
  const int nv = aligned ? nf / 4 : 0;
  for (int f = t; f < nv; f += kFmScanThreads) {
    cp_async16(dst + 4 * fm_swizzle<kWords>(f), src + 4 * f);
  }
  for (int i = 4 * nv + t; i < nf; i += kFmScanThreads) {
    cp_async4(dst + 4 * fm_swizzle<kWords>(i >> 2) + (i & 3), src + i);
  }
}

template <int kDim>
__device__ __forceinline__ void seg_combine(bool& f, float (&v)[kDim + 1],
                                            bool of, const float (&ov)[kDim + 1]) {
  // (of, ov) then (f, v): v restarts at a head, else adds to the left
  if (!f) {
#pragma unroll
    for (int c = 0; c <= kDim; ++c) v[c] = ov[c] + v[c];
  }
  f = f || of;
}

// A chunk's staged a (kFmChunk * kDim), b and sidx (kFmChunk each), in
// one buffer of shared memory.
template <int kDim>
__device__ __forceinline__ void fm_stage_chunk(float* buf,
                                               const float* __restrict__ a,
                                               const float* __restrict__ b,
                                               const int* __restrict__ sidx,
                                               int64_t chunk, int64_t n, int t) {
  const int64_t base = chunk * kFmChunk;
  const int cnt = static_cast<int>(n - base < kFmChunk ? n - base : kFmChunk);
  stage<kFmItems * kDim / 4>(buf, a + base * kDim, cnt * kDim, t);
  stage<kFmItems / 4>(buf + kFmChunk * kDim, b + base, cnt, t);
  stage<kFmItems / 4>(buf + kFmChunk * (kDim + 1),
                      reinterpret_cast<const float*>(sidx + base), cnt, t);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kDim, bool kBf16>
__device__ __forceinline__ void fm_scan_chunk(
    const float* buf, int64_t chunk, const float* __restrict__ V,
    const int* __restrict__ sidx, float* __restrict__ out,
    float* __restrict__ part_first, float* __restrict__ part_last,
    int* __restrict__ flags, int64_t n, int64_t rows,
    float (*w_val)[kDim + 1], int* w_flag) {
  constexpr int kWords = kFmItems * kDim / 4;  // 16-byte words of a a thread
  const float* a_s = buf;
  const float* b_s = buf + kFmChunk * kDim;
  const int* k_s = reinterpret_cast<const int*>(buf + kFmChunk * (kDim + 1));
  const int t = threadIdx.x;
  const unsigned lane = t & 31u;
  const int warp = t >> 5;
  const int64_t base = chunk * kFmChunk;
  const int cnt = static_cast<int>(n - base < kFmChunk ? n - base : kFmChunk);
  const bool vec = kDim % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(V) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;

  constexpr int kKeyWords = kFmItems / 4;
  auto key_at = [&](int i) {
    return k_s[4 * fm_swizzle<kKeyWords>(i >> 2) + (i & 3)];
  };
  const int e0 = t * kFmItems;
  const int e1 = e0 + kFmItems < cnt ? e0 + kFmItems : cnt;
  const bool cont_before = base > 0 && sidx[base - 1] == key_at(0);
  const bool cont_after = base + cnt < n && sidx[base + cnt] == key_at(cnt - 1);
  // this thread's keys and b values, a 16-byte word at a time
  int kk[kFmItems];
  float bb[kFmItems];
#pragma unroll
  for (int q = 0; q < kKeyWords; ++q) {
    const int f = fm_swizzle<kKeyWords>(t * kKeyWords + q);
    const int4 kv = reinterpret_cast<const int4*>(k_s)[f];
    const float4 bv = reinterpret_cast<const float4*>(b_s)[f];
    kk[4 * q] = kv.x, kk[4 * q + 1] = kv.y, kk[4 * q + 2] = kv.z, kk[4 * q + 3] = kv.w;
    bb[4 * q] = bv.x, bb[4 * q + 1] = bv.y, bb[4 * q + 2] = bv.z, bb[4 * q + 3] = bv.w;
  }
  // this thread's first entry starts a run (chunk entry 0 aside: the
  // chunk's first run is told apart by the scan's flag below)
  const bool h0 = t > 0 && e0 < cnt && kk[0] != key_at(e0 - 1);
  // the V rows of the runs that end in this thread go to L2 now, so the
  // emits below do not wait on device memory
#pragma unroll
  for (int j = 0; j < kFmItems; ++j) {
    const int e = e0 + j;
    if (e >= cnt || kk[j] < 0 || kk[j] >= rows) continue;
    if (e + 1 == cnt ||
        (j + 1 < kFmItems ? kk[j + 1] != kk[j] : key_at(e + 1) != kk[j])) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(V + static_cast<int64_t>(kk[j]) * kDim));
    }
  }

  auto emit = [&](const float (&acc)[kDim + 1], int key, bool first_run,
                  bool last_run) {
    if ((first_run && cont_before) || (last_run && cont_after)) {
      float* dst = (first_run && cont_before ? part_first : part_last) +
                   chunk * (kDim + 1);
#pragma unroll
      for (int c = 0; c <= kDim; ++c) dst[c] = acc[c];
      return;
    }
    if (!any_nonzero<kDim>(acc)) return;  // output zeroed: pads, empty runs
    const int64_t row = static_cast<int64_t>(key) * kDim;
    if constexpr (kDim % 4 == 0) {
      if (vec) {  // 16 bytes at a time: at dim 8 the row is one sector
#pragma unroll
        for (int c = 0; c < kDim; c += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(V + row + c));
          float4 o;
          o.x = acc[c] - acc[kDim] * v.x;
          o.y = acc[c + 1] - acc[kDim] * v.y;
          o.z = acc[c + 2] - acc[kDim] * v.z;
          o.w = acc[c + 3] - acc[kDim] * v.w;
          *reinterpret_cast<float4*>(out + row + c) = o;
        }
        return;
      }
    }
#pragma unroll
    for (int c = 0; c < kDim; ++c) out[row + c] = acc[c] - acc[kDim] * V[row + c];
  };

  // serial sums of this thread's entries, cut at run heads
  float acc[kDim + 1], first[kDim + 1];
#pragma unroll
  for (int c = 0; c <= kDim; ++c) acc[c] = first[c] = 0.0f;
  int cuts = 0;  // run heads inside the thread, past its first entry
  int last = -1;  // the key of the thread's last entry
#pragma unroll
  for (int j = 0; j < kFmItems; ++j) {
    const int e = e0 + j;
    if (e < e1) {
      const int key = kk[j];
      if (key < 0 || key >= rows) __trap();
      last = key;
      if (j > 0 && key != kk[j - 1]) {
        if (cuts == 0) {
#pragma unroll
          for (int c = 0; c <= kDim; ++c) first[c] = acc[c];
        } else {
          emit(acc, kk[j - 1], false, false);  // wholly inside
        }
#pragma unroll
        for (int c = 0; c <= kDim; ++c) acc[c] = 0.0f;
        ++cuts;
      }
      if constexpr (kDim % 4 == 0) {
#pragma unroll
        for (int c = 0; c < kDim; c += 4) {
          const int f = (e * kDim + c) >> 2;
          const float4 v =
              *reinterpret_cast<const float4*>(a_s + 4 * fm_swizzle<kWords>(f));
          const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[c + u] += kBf16 ? round_bf16(x[u]) : x[u];
        }
      } else {
#pragma unroll
        for (int c = 0; c < kDim; ++c) {
          const int i = e * kDim + c;
          const float x = a_s[4 * fm_swizzle<kWords>(i >> 2) + (i & 3)];
          acc[c] += kBf16 ? round_bf16(x) : x;
        }
      }
      acc[kDim] += kBf16 ? round_bf16(bb[j]) : bb[j];
    }
  }

  // segmented scan of the tails: flag = a run starts in this thread
  bool f = h0 || cuts > 0;
  float v[kDim + 1];
#pragma unroll
  for (int c = 0; c <= kDim; ++c) v[c] = acc[c];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float ov[kDim + 1];
#pragma unroll
    for (int c = 0; c <= kDim; ++c) ov[c] = __shfl_up_sync(kFull, v[c], off);
    const bool of = __shfl_up_sync(kFull, f, off);
    if (static_cast<int>(lane) >= off) seg_combine<kDim>(f, v, of, ov);
  }
  if (lane == 31u) {
    w_flag[warp] = f;
#pragma unroll
    for (int c = 0; c <= kDim; ++c) w_val[warp][c] = v[c];
  }
  // exclusive: the lane before's inclusive value
  bool cf;
  float carry[kDim + 1];
#pragma unroll
  for (int c = 0; c <= kDim; ++c) carry[c] = __shfl_up_sync(kFull, v[c], 1);
  cf = __shfl_up_sync(kFull, f, 1);
  if (lane == 0u) {
    cf = false;
#pragma unroll
    for (int c = 0; c <= kDim; ++c) carry[c] = 0.0f;
  }
  const int any_head = __syncthreads_or(h0 || cuts > 0);
  // the warps before this one, in order, then this lane's carry
  bool pf = false;
  float pv[kDim + 1];
#pragma unroll
  for (int c = 0; c <= kDim; ++c) pv[c] = 0.0f;
  for (int w = 0; w < warp; ++w) {
    float wv[kDim + 1];
#pragma unroll
    for (int c = 0; c <= kDim; ++c) wv[c] = w_val[w][c];
    bool wf = w_flag[w];
    seg_combine<kDim>(wf, wv, pf, pv);
    pf = wf;
#pragma unroll
    for (int c = 0; c <= kDim; ++c) pv[c] = wv[c];
  }
  seg_combine<kDim>(cf, carry, pf, pv);

  if (e0 < cnt) {
    // this thread's first run is the chunk's first run when no run
    // starts between chunk entry 0 and here
    const bool first_run = !cf && !h0;
    float tot[kDim + 1];
    if (cuts > 0) {
#pragma unroll
      for (int c = 0; c <= kDim; ++c) tot[c] = (h0 ? 0.0f : carry[c]) + first[c];
      emit(tot, kk[0], first_run, false);
#pragma unroll
      for (int c = 0; c <= kDim; ++c) tot[c] = acc[c];
    } else {
#pragma unroll
      for (int c = 0; c <= kDim; ++c) tot[c] = (h0 ? 0.0f : carry[c]) + acc[c];
    }
    // the tail ends here if the next entry starts a run or the chunk ends
    if (e1 == cnt || key_at(e1) != last) {
      emit(tot, last, cuts == 0 && first_run, e1 == cnt);
    }
  }
  if (t == 0) {
    flags[chunk] = (cont_before ? kFmFirstCont : 0) |
                   (cont_after ? kFmLastCont : 0) | (any_head ? 0 : kFmSingle);
  }
}

// One CTA per chunk. (A persistent grid of two CTAs an SM, each staging
// its next chunk while it sums the current one, was slower at the DiFacto
// batch: its emits' latency was no longer hidden by other CTAs.)
template <int kDim, bool kBf16>
__global__ void __launch_bounds__(kFmScanThreads)
fm_push_scan_kernel(const float* __restrict__ V, const float* __restrict__ a,
                    const float* __restrict__ b, const int* __restrict__ sidx,
                    float* __restrict__ out, float* __restrict__ part_first,
                    float* __restrict__ part_last, int* __restrict__ flags,
                    int64_t n, int64_t rows) {
  extern __shared__ float4 fm_smem[];
  float* buf = reinterpret_cast<float*>(fm_smem);
  __shared__ float w_val[kFmScanWarps][kDim + 1];
  __shared__ int w_flag[kFmScanWarps];
  fm_stage_chunk<kDim>(buf, a, b, sidx, blockIdx.x, n, threadIdx.x);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  fm_scan_chunk<kDim, kBf16>(buf, blockIdx.x, V, sidx, out, part_first,
                             part_last, flags, n, rows, w_val, w_flag);
}

struct FmArgs {
  const float *V, *a, *b;
  const int* sidx;
  float *out, *part_first, *part_last;
  int* flags;
  int64_t n, rows, nchunks;
  cudaStream_t stream;
};

template <int kDim>
void fm_launch(const FmArgs& f, bool bf16) {
  if constexpr (kDim <= kFmScanMaxDim) {
    auto scan = bf16 ? fm_push_scan_kernel<kDim, true> : fm_push_scan_kernel<kDim, false>;
    constexpr int smem = kFmChunk * (kDim + 2) * 4;
    if constexpr (smem + 1024 > 48 * 1024) {  // past 48 KB a kernel opts in
      cudaFuncSetAttribute(scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    scan<<<static_cast<unsigned>(f.nchunks), kFmScanThreads, smem, f.stream>>>(
        f.V, f.a, f.b, f.sidx, f.out, f.part_first, f.part_last, f.flags, f.n,
        f.rows);
  } else {
    auto local = bf16 ? fm_push_local_kernel<kDim, true> : fm_push_local_kernel<kDim, false>;
    local<<<static_cast<unsigned>(f.nchunks), kFmThreads, 0, f.stream>>>(
        f.V, f.a, f.b, f.sidx, f.out, f.part_first, f.part_last, f.flags, f.n,
        f.rows);
  }
  fm_push_combine_kernel<kDim><<<blocks_for(f.nchunks * 32), kThreads, 0, f.stream>>>(
      f.V, f.sidx, f.out, f.part_first, f.part_last, f.flags, f.nchunks);
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

// V: (rows, dim) f32; a: (n, dim) f32; b: (n,) f32; sidx: (n,) int32;
// out: (rows, dim) f32. part_first, part_last: scratch of
// ceil(n / chunk) * (dim + 1) f32 each; flags: ceil(n / chunk) int32.
// chunk must equal kFmChunk and dim be a power of two up to 128.
int wh_fm_push_contrib(const void* V, const void* a, const void* b,
                       const void* sidx, void* out, void* part_first,
                       void* part_last, void* flags, int64_t n, int64_t rows,
                       int dim, int chunk, int bf16, void* stream) {
  FmArgs f;
  f.V = static_cast<const float*>(V);
  f.a = static_cast<const float*>(a);
  f.b = static_cast<const float*>(b);
  f.sidx = static_cast<const int*>(sidx);
  f.out = static_cast<float*>(out);
  f.part_first = static_cast<float*>(part_first);
  f.part_last = static_cast<float*>(part_last);
  f.flags = static_cast<int*>(flags);
  f.n = n;
  f.rows = rows;
  f.nchunks = (n + kFmChunk - 1) / kFmChunk;
  f.stream = static_cast<cudaStream_t>(stream);
  if (chunk != kFmChunk) return static_cast<int>(cudaErrorInvalidValue);
  cudaMemsetAsync(out, 0, rows * dim * sizeof(float), f.stream);
  if (n > 0) {
    switch (dim) {
      case 1: fm_launch<1>(f, bf16 != 0); break;
      case 2: fm_launch<2>(f, bf16 != 0); break;
      case 4: fm_launch<4>(f, bf16 != 0); break;
      case 8: fm_launch<8>(f, bf16 != 0); break;
      case 16: fm_launch<16>(f, bf16 != 0); break;
      case 32: fm_launch<32>(f, bf16 != 0); break;
      case 64: fm_launch<64>(f, bf16 != 0); break;
      case 128: fm_launch<128>(f, bf16 != 0); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
