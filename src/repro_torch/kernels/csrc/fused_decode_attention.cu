// One-token GQA decode attention with the KV ring insert, for Hopper
// (sm_90a), bf16 or f32 in and out (one kernel template for each).
//
// Replaces the TPU kernel
// `repro/kernels/decode_superkernel.py::fused_decode_attention`
// (`_gqa_decode_kernel` with `_online_softmax`, pallas_call at
// decode_superkernel.py:259). Per batch row b, with c = cache_len[b]:
//     k_out = k_cache with row (c % S) replaced by k_new   (v likewise)
//     out   = softmax_{pos < min(c + 1, S)}(
//                 softcap((q * D^-1/2) . k_out[pos])) @ v_out
// scores, softmax and the weighted sum in fp32; out rounded to the input
// type (no rounding for f32, which the reference also runs, to 2e-5).
//
// Design.
// - One block per (kv head, row): B * Hkv blocks (64 at olmoe-1b-7b's decode
//   at batch 4). The TPU version walks rows in a sequential grid and keeps a
//   whole (S, Hkv, D) cache row in VMEM; here a block owns one head's (S, D)
//   slice, which is what the G = Hq / Hkv query heads of that kv head read.
// - The caches are never written in place: the block copies its slice of
//   the old caches into the new ones (16-byte vectors), taking the inserted
//   row from k_new / v_new. That fuses the ring insert into the copy that
//   copy semantics need anyway (a saved decode state and the engine's
//   replay checkpoints keep the old tensors). The attention half reads the
//   old cache and substitutes the inserted row itself, so it never depends
//   on the block's own writes.
// - Online softmax in chunks of 128 positions, as the TPU kernel does:
//   chunks at or past min(c + 1, S) are skipped, so the work follows the
//   filled prefix, not the ring capacity. Scores: each warp takes a
//   position at a time, lanes stride over D, a shuffle reduction sums them.
//   The softmax bookkeeping (chunk max, rescale, running sum) is done by
//   every thread from shared memory, in one fixed order, so the result is
//   the same from run to run. expf, not __expf.
//
// Bound on an H100 SXM (3.35 TB/s): the copy reads the old K and V caches
// and writes the new ones, 4 * B * S * Hkv * D * 2 bytes = 16.8 MB at B = 4,
// S = 256, Hkv = 16, D = 128, so 5.0 us; FLOPs are negligible
// (4 * B * Hq * D * S = 2.1 MFLOP). In practice the launch dominates.
//
// C interface (ctypes): fused_decode_attention_launch returns
// cudaGetLastError() after enqueueing the kernel on `stream`. cache_len is
// int64, read at b * clen_stride (stride 0: one length for every row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK_S = 128;      // positions per online-softmax chunk
constexpr int MAX_G = 16;         // query heads per kv head
constexpr int MAX_D = 256;        // head dim
constexpr int D_PER_THREAD = MAX_D / THREADS;
constexpr float NEG_INF = -1073741824.0f;   // -2^30, as the reference

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                      const T* __restrict__ v_new,
                      const T* __restrict__ k_cache,
                      const T* __restrict__ v_cache,
                      const int64_t* __restrict__ cache_len, int clen_stride,
                      T* __restrict__ out, T* __restrict__ k_out,
                      T* __restrict__ v_out, int S, int Hkv, int G, int D,
                      float scale, float softcap) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float q_s[MAX_G][MAX_D];
  __shared__ float s_s[MAX_G][BLOCK_S];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t clen = cache_len[static_cast<int64_t>(b) * clen_stride];
  const int ins = static_cast<int>(clen % S);
  const int valid = clen + 1 < S ? static_cast<int>(clen + 1) : S;
  const int64_t pos_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * Hkv + h) * D;
  const int64_t new_base = (static_cast<int64_t>(b) * Hkv + h) * D;

  // ---- 1. new caches = old caches with row `ins` from k_new / v_new -----
  const int vecs = D / VEC;
  for (int i = tid; i < S * vecs; i += THREADS) {
    const int pos = i / vecs;
    const int c = (i - pos * vecs) * VEC;
    const int64_t off = base + pos * pos_stride + c;
    const bool is_new = pos == ins;
    const uint4 kv = *reinterpret_cast<const uint4*>(
        is_new ? k_new + new_base + c : k_cache + off);
    const uint4 vv = *reinterpret_cast<const uint4*>(
        is_new ? v_new + new_base + c : v_cache + off);
    *reinterpret_cast<uint4*>(k_out + off) = kv;
    *reinterpret_cast<uint4*>(v_out + off) = vv;
  }

  // ---- 2. attention of the G query heads of kv head h --------------------
  const int Hq = Hkv * G;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    const int d = i - g * D;
    q_s[g][d] = to_f(q[(static_cast<int64_t>(b) * Hq + h * G + g) * D + d]) *
                scale;
  }
  float m[MAX_G], l[MAX_G], acc[MAX_G][D_PER_THREAD];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int r = 0; r < D_PER_THREAD; ++r) acc[g][r] = 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < valid; c0 += BLOCK_S) {
    const int n = min(BLOCK_S, S - c0);
    // scores: one position per warp at a time
    for (int j = warp; j < n; j += WARPS) {
      const int pos = c0 + j;
      if (pos >= valid) {
        if (lane == 0)
          for (int g = 0; g < G; ++g) s_s[g][j] = NEG_INF;
        continue;
      }
      const T* krow = pos == ins ? k_new + new_base
                                 : k_cache + base + pos * pos_stride;
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float kf = to_f(krow[d]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) part[g] += q_s[g][d] * kf;
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        float v = part[g];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (softcap > 0.f) v = softcap * tanhf(v / softcap);
        if (lane == 0) s_s[g][j] = v;
      }
    }
    __syncthreads();
    // chunk max and rescale factor (every thread, same order)
    float m_new[MAX_G], corr[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      float mb = s_s[g][0];
      for (int j = 1; j < n; ++j) mb = fmaxf(mb, s_s[g][j]);
      m_new[g] = fmaxf(m[g], mb);
      corr[g] = expf(m[g] - m_new[g]);
    }
    __syncthreads();
    for (int i = tid; i < G * n; i += THREADS) {
      const int g = i / n;
      const int j = i - g * n;
      s_s[g][j] = expf(s_s[g][j] - m_new[g]);
    }
    __syncthreads();
    // running sum and p @ v; thread owns head dims tid, tid + THREADS
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      float ls = 0.f;
      for (int j = 0; j < n; ++j) ls += s_s[g][j];
      l[g] = l[g] * corr[g] + ls;
      m[g] = m_new[g];
    }
#pragma unroll
    for (int r = 0; r < D_PER_THREAD; ++r) {
      const int d = tid + r * THREADS;
      if (d >= D) break;
      float pv[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) pv[g] = 0.f;
      for (int j = 0; j < n; ++j) {
        const int pos = c0 + j;
        if (pos >= valid) break;
        const T* vrow = pos == ins ? v_new + new_base
                                   : v_cache + base + pos * pos_stride;
        const float vf = to_f(vrow[d]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) pv[g] += s_s[g][j] * vf;
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g][r] = acc[g][r] * corr[g] + pv[g];
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < D_PER_THREAD; ++r) {
    const int d = tid + r * THREADS;
    if (d >= D) break;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      out[(static_cast<int64_t>(b) * Hq + h * G + g) * D + d] =
          from_f<T>(acc[g][r] / fmaxf(l[g], 1e-20f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_cache, const void* v_cache, const void* cache_len,
           int clen_stride, void* out, void* k_out, void* v_out, int B, int S,
           int Hkv, int G, int D, float scale, float softcap,
           cudaStream_t stream) {
  gqa_decode_kernel<T><<<dim3(Hkv, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int64_t*>(cache_len),
      clen_stride, static_cast<T*>(out), static_cast<T*>(k_out),
      static_cast<T*>(v_out), S, Hkv, G, D, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32: 1 for float tensors, 0 for bf16.
extern "C" int fused_decode_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* cache_len, int clen_stride, void* out,
    void* k_out, void* v_out, int B, int S, int Hkv, int G, int D,
    float scale, float softcap, int f32, void* stream) {
  if (G < 1 || G > MAX_G || D < 8 || D > MAX_D || D % 8 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(q, k_new, v_new, k_cache, v_cache, cache_len,
                             clen_stride, out, k_out, v_out, B, S, Hkv, G, D,
                             scale, softcap, st)
             : launch<bf16>(q, k_new, v_new, k_cache, v_cache, cache_len,
                            clen_stride, out, k_out, v_out, B, S, Hkv, G, D,
                            scale, softcap, st);
}
