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
// What bounds it. Copy semantics (below) read the old K and V caches and
// write the new ones: 4 * B * S * Hkv * D * 2 bytes = 16.8 MB in bf16 at
// olmoe-1b-7b's decode (B = 4, S = 256, Hkv = 16, D = 128), 5.0 us at
// 3.35 TB/s (H100 SXM); the FLOPs (4 * B * Hq * D * S = 2.1 MFLOP) are
// negligible. So bytes, streamed by enough SMs, each read once.
//
// Design (split-S, as flash-decoding; as `fused_mla_decode_attention.cu`):
// - The grid is (8 splits, Hkv, B), one cluster of 8 blocks per (kv head,
//   row): 512 blocks at olmoe decode. Block s owns positions
//   [s P, (s+1) P), P = ceil(S / 8): the splits depend on S alone, never on
//   B, the lengths or the other rows, so a row's bits do not depend on the
//   batch it is in.
// - One read of the cache: block s copies its positions of head h from the
//   old caches into the new ones with 16-byte vectors (the row at c % S
//   from k_new / v_new) and, as it copies, stages the positions below
//   min(c + 1, S) in shared memory, 32 at a time. The caches are never
//   written in place: a saved decode state and the engine's replay
//   checkpoints keep the old tensors.
// - Attention of the kv head's G query heads from shared memory, an online
//   softmax over the 32-position chunks: warp w scores positions 4w..4w+3,
//   8 lanes a position striding over D in 16-byte vectors, a 3-step
//   shuffle per head; warp w keeps the max and sum of heads w, w + 8 (32
//   scores, one a lane, two 5-step shuffles: no thread walks a chunk's
//   scores in series); thread t accumulates (head, dim) pairs t, t + 256,
//   ... of p @ v. Softcap as the reference; expf, not __expf.
// - Merge: each block leaves its per-head max, sum and fp32 partial output
//   in shared memory; after a cluster barrier, block s combines head dims
//   [s D/8, (s+1) D/8) of every head from the 8 splits in ascending split
//   order through distributed shared memory. No atomics: the same bits
//   from run to run. A split with no attended position has max -2^30 and
//   sum 0, so it contributes nothing.
//
// C interface (ctypes): fused_decode_attention_launch returns
// cudaGetLastError() after enqueueing the kernel on `stream`. cache_len is
// int64, read at b * clen_stride (stride 0: one length for every row).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SPLITS = 8;         // blocks a (kv head, row): one cluster
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 32;            // positions a chunk: one a lane
constexpr int LANES_PER_POS = 8;  // lanes scoring one position
constexpr int MAX_G = 16;         // query heads per kv head
constexpr int MAX_D = 256;        // head dim
constexpr int PAD = 8;            // staged row padding (elements)
constexpr int ACC = MAX_G * MAX_D / THREADS;   // (head, dim) pairs a thread
constexpr float NEG_INF = -1073741824.0f;      // -2^30, as the reference
static_assert(WARPS * 32 / LANES_PER_POS == CH, "a chunk is one pass");

template <typename T>
size_t gqa_smem(int G, int D) {
  return (2 * static_cast<size_t>(G) * D + G * CH + 3 * MAX_G) *
             sizeof(float) +
         2 * static_cast<size_t>(CH) * (D + PAD) * sizeof(T);
}

// the floats of one 16-byte vector
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <typename T>
__global__ void __cluster_dims__(SPLITS, 1, 1) __launch_bounds__(THREADS)
    gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                      const T* __restrict__ v_new,
                      const T* __restrict__ k_cache,
                      const T* __restrict__ v_cache,
                      const int64_t* __restrict__ cache_len, int clen_stride,
                      T* __restrict__ out, T* __restrict__ k_out,
                      T* __restrict__ v_out, int S, int Hkv, int G, int D,
                      float scale, float softcap) {
  constexpr int VEC = Vec<T>::N;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t clen = cache_len[static_cast<int64_t>(b) * clen_stride];
  const int ins = static_cast<int>(clen % S);
  const int valid = clen + 1 < S ? static_cast<int>(clen + 1) : S;
  const int per = (S + SPLITS - 1) / SPLITS;
  const int p_begin = min(split * per, S);
  const int p_end = min(p_begin + per, S);
  const int64_t pos_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * Hkv + h) * D;
  const int64_t new_base = (static_cast<int64_t>(b) * Hkv + h) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * Hkv + h) * G * D;
  const int pitch = D + PAD;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                        // [G][D] scaled queries
  float* acc_s = q_s + G * D;               // [G][D] partial output
  float* s_s = acc_s + G * D;               // [G][CH] scores, then p
  float* m_s = s_s + G * CH;                // [MAX_G] running max
  float* l_s = m_s + MAX_G;                 // [MAX_G] running sum
  float* corr_s = l_s + MAX_G;              // [MAX_G] chunk rescale
  T* k_s = reinterpret_cast<T*>(corr_s + MAX_G);   // [CH][pitch]
  T* v_s = k_s + CH * pitch;                       // [CH][pitch]

  for (int i = tid; i < G * D; i += THREADS)
    q_s[i] = to_f(q[q_base + i]) * scale;
  if (tid < MAX_G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;

  const int vecs = D / VEC;
  for (int c0 = p_begin; c0 < p_end; c0 += CH) {
    const int nc = min(CH, p_end - c0);            // positions copied
    const int n = max(0, min(nc, valid - c0));     // of them attended
    // 1. copy into the new caches (row `ins` from k_new / v_new) and stage
    //    the attended rows
    for (int i = tid; i < nc * vecs; i += THREADS) {
      const int j = i / vecs;
      const int c = (i - j * vecs) * VEC;
      const int pos = c0 + j;
      const int64_t off = base + pos * pos_stride + c;
      const bool is_new = pos == ins;
      const uint4 kv = *reinterpret_cast<const uint4*>(
          is_new ? k_new + new_base + c : k_cache + off);
      const uint4 vv = *reinterpret_cast<const uint4*>(
          is_new ? v_new + new_base + c : v_cache + off);
      *reinterpret_cast<uint4*>(k_out + off) = kv;
      *reinterpret_cast<uint4*>(v_out + off) = vv;
      if (j < n) {
        *reinterpret_cast<uint4*>(k_s + j * pitch + c) = kv;
        *reinterpret_cast<uint4*>(v_s + j * pitch + c) = vv;
      }
    }
    __syncthreads();
    if (n > 0) {
      // 2. scores: 8 lanes a position, 16-byte vectors in ascending order
      {
        const int j = warp * (32 / LANES_PER_POS) + lane / LANES_PER_POS;
        const int l8 = lane % LANES_PER_POS;
        float part[MAX_G];
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
        if (j < n) {
          for (int v = l8; v < vecs; v += LANES_PER_POS) {
            float kf[VEC];
            unpack(*reinterpret_cast<const uint4*>(k_s + j * pitch + v * VEC),
                   kf);
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) {
              if (g < G) {
                const float* qg = q_s + g * D + v * VEC;
#pragma unroll
                for (int e = 0; e < VEC; ++e) part[g] += qg[e] * kf[e];
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g >= G) break;
          float s = part[g];
#pragma unroll
          for (int o = LANES_PER_POS / 2; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (l8 == 0 && j < n) {
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            s_s[g * CH + j] = s;
          }
        }
      }
      __syncthreads();
      // 3. per head: chunk max, rescale factor, p = exp(s - max), sum
      for (int g = warp; g < G; g += WARPS) {
        const float s = lane < n ? s_s[g * CH + lane] : NEG_INF;
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        const float p = lane < n ? expf(s - m_new) : 0.f;
        s_s[g * CH + lane] = p;
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      // 4. acc = acc * corr + p @ v; thread tid owns pairs tid + THREADS r
#pragma unroll
      for (int r = 0; r < ACC; ++r) {
        const int i = tid + r * THREADS;
        if (i >= G * D) break;
        const int g = i / D;
        const int d = i - g * D;
        const float* p = s_s + g * CH;
        float pv = 0.f;
        for (int j = 0; j < n; ++j) pv += p[j] * to_f(v_s[j * pitch + d]);
        acc[r] = acc[r] * corr_s[g] + pv;
      }
    }
    __syncthreads();            // the staged rows and scores are free
  }

  // ---- merge the splits of (row b, kv head h) in ascending split order --
#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    const int i = tid + r * THREADS;
    if (i >= G * D) break;
    acc_s[i] = acc[r];
  }
  cluster.sync();
  const int cols = (D + SPLITS - 1) / SPLITS;
  const int col0 = split * cols;
  const int ncol = max(0, min(cols, D - col0));
  for (int i = tid; i < G * ncol; i += THREADS) {
    const int g = i / ncol;
    const int d = col0 + (i - g * ncol);
    float mx = NEG_INF;
    for (int r = 0; r < SPLITS; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(m_s, r)[g]);
    float l = 0.f, c = 0.f;
    for (int r = 0; r < SPLITS; ++r) {
      const float w = expf(cluster.map_shared_rank(m_s, r)[g] - mx);
      l += cluster.map_shared_rank(l_s, r)[g] * w;
      c += cluster.map_shared_rank(acc_s, r)[g * D + d] * w;
    }
    out[q_base + g * D + d] = from_f<T>(c / fmaxf(l, 1e-20f));
  }
  cluster.sync();              // no block leaves while others read it
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_cache, const void* v_cache, const void* cache_len,
           int clen_stride, void* out, void* k_out, void* v_out, int B, int S,
           int Hkv, int G, int D, float scale, float softcap,
           cudaStream_t stream) {
  // at the largest size the wrapper lets through
  const cudaError_t e = opt_in_smem(
      gqa_decode_kernel<T>, static_cast<int>(gqa_smem<T>(MAX_G, MAX_D)));
  if (e != cudaSuccess) return static_cast<int>(e);
  gqa_decode_kernel<T>
      <<<dim3(SPLITS, Hkv, B), THREADS, gqa_smem<T>(G, D), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_new),
          static_cast<const T*>(v_new), static_cast<const T*>(k_cache),
          static_cast<const T*>(v_cache),
          static_cast<const int64_t*>(cache_len), clen_stride,
          static_cast<T*>(out), static_cast<T*>(k_out),
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
  if (G < 1 || G > MAX_G || D < 8 || D > MAX_D || D % 8 || S < 1 || B < 1 ||
      Hkv < 1 || Hkv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(q, k_new, v_new, k_cache, v_cache, cache_len,
                             clen_stride, out, k_out, v_out, B, S, Hkv, G, D,
                             scale, softcap, st)
             : launch<bf16>(q, k_new, v_new, k_cache, v_cache, cache_len,
                            clen_stride, out, k_out, v_out, B, S, Hkv, G, D,
                            scale, softcap, st);
}
