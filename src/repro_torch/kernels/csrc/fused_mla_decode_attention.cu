// Weight-absorbed MLA decode attention with the positional latent insert,
// for Hopper (sm_90a): fp32 queries and output, bf16 or f32 caches.
//
// Replaces the TPU kernel
// `repro/kernels/decode_superkernel.py::fused_mla_decode_attention`
// (`_mla_decode_kernel` with `_online_softmax`, pallas_call at
// decode_superkernel.py:344). Per batch row b, with c = cache_len[b] < S:
//     lat_out = latent with position c replaced by c_new[b]   (pe likewise)
//     s[h, p] = (q_abs[b, h] . lat_out[p] + q_pe[b, h] . pe_out[p]) * scale
//     ctx[b, h] = softmax_{p <= c}(s[h]) @ lat_out              (fp32)
// After absorbing wkv_b into the query and output sides, MLA is attention
// with a single key/value head: key width R + P, value width R, shared by
// all H query heads.
//
// What bounds it. The copy semantics (below) read the old caches and write
// the new ones: at DeepSeek-V2-Lite decode, batch 4 (H = 16, R = 512,
// P = 64, S = 256), 2 x 1.18 MB in bf16, plus 0.28 MB of queries and ctx,
// about 0.8 us at 3.35 TB/s (H100 SXM). The FLOPs, 2 H (2R + P) per
// attended position, are 36 MFLOP at full length, 0.5 us at 67 TFLOP/s
// fp32. So bytes, and enough SMs to stream them.
//
// Design (split-S, as flash-decoding):
// - The grid is (8 splits, B, head groups), one cluster of 8 blocks a
//   batch row and head group (below). Block s owns positions
//   [s S/8, (s+1) S/8) of its row: it copies them from the old caches into
//   the new ones (16-byte vectors; the row at c comes from c_new / pe_new),
//   and as it copies it stages the positions <= c in shared memory, so
//   every cache byte is read once. The caches are never
//   written in place: a saved decode state, the engine's replay checkpoints
//   and the oracle keep the old tensors.
// - Attention over the staged rows, 32 positions a chunk with an online
//   softmax: warp w scores 2 positions against the H queries (lanes stride
//   over R + P, a shuffle tree sums), warp h keeps head h's max and sum,
//   and thread t accumulates latent column t for every head.
// - Merge: each block leaves its per-head max, sum and fp32 context in
//   shared memory; after a cluster barrier, block s combines columns
//   [s R/8, (s+1) R/8) of every head from the 8 splits in ascending split
//   order through distributed shared memory. No atomics: the result is the
//   same from run to run. expf, not __expf.
// - Heads: a block holds at most MAX_H = 16 query heads (one warp each in
//   the softmax step, 16 fp32 accumulators a thread). More heads (minicpm3
//   has 40) split into groups of 16 along the grid's z dimension; each
//   group is its own cluster of 8 splits over the same row, stages the
//   row's attended positions itself (so the cache is read once a group)
//   and only group 0 writes the new caches. At H <= 16 there is one group
//   and the kernel does what it did before.
// - Any length is safe: only positions < S are read and only the new
//   caches and ctx are written; a row with no position <= c gets ctx 0.
//
// C interface (ctypes): fused_mla_decode_attention_launch returns
// cudaGetLastError() after enqueueing the kernel on `stream`. cache_len is
// int64, read at b * clen_stride (stride 0: one length for every row).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SPLITS = 8;          // blocks a batch row: one cluster
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 32;             // positions per online-softmax chunk
constexpr int PPW = CH / WARPS;    // positions per warp in a chunk
constexpr int MAX_H = 16;          // query heads a block (a head group)
constexpr int MAX_R = THREADS;     // latent width: one column per thread
constexpr int MAX_P = 128;         // rope key width
constexpr float NEG_INF = -1073741824.0f;   // -2^30, as the reference

template <typename T>
size_t mla_smem(int H, int R, int P) {
  const size_t K = R + P;
  return (H * K + CH * MAX_H + 3 * MAX_H + static_cast<size_t>(H) * R) *
             sizeof(float) +
         CH * K * sizeof(T);
}

// GROUPS: H > MAX_H, the heads split along the grid's z dimension; without
// it (H <= MAX_H) the kernel is the one-group code, with nothing to decide
// at run time.
template <typename T, bool GROUPS>
__global__ void __cluster_dims__(SPLITS, 1, 1) __launch_bounds__(THREADS)
    mla_decode_kernel(const float* __restrict__ q_abs,
                      const float* __restrict__ q_pe,
                      const T* __restrict__ c_new,
                      const T* __restrict__ pe_new,
                      const T* __restrict__ latent, const T* __restrict__ pe,
                      const int64_t* __restrict__ cache_len, int clen_stride,
                      float* __restrict__ ctx, T* __restrict__ lat_out,
                      T* __restrict__ pe_out, int S, int H, int R, int P,
                      float scale) {
  constexpr int VEC = Vec<T>::N;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int h0 = GROUPS ? blockIdx.z * MAX_H : 0;  // group's first head
  const int HG = GROUPS ? min(MAX_H, H - h0) : H;  // and its heads
  const bool writes = !GROUPS || blockIdx.z == 0;  // group 0 writes caches
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t clen = cache_len[static_cast<int64_t>(b) * clen_stride];
  const int ins = clen < 0 ? -1 : (clen >= S ? S : static_cast<int>(clen));
  const int valid = min(ins + 1, S);           // attended positions
  const int per = (S + SPLITS - 1) / SPLITS;
  const int p_begin = min(split * per, S);
  const int p_end = min(p_begin + per, S);
  const T* lat_b = latent + static_cast<int64_t>(b) * S * R;
  const T* pe_b = pe + static_cast<int64_t>(b) * S * P;
  T* lat_o = lat_out + static_cast<int64_t>(b) * S * R;
  T* pe_o = pe_out + static_cast<int64_t>(b) * S * P;
  const T* cn = c_new + static_cast<int64_t>(b) * R;
  const T* pn = pe_new + static_cast<int64_t>(b) * P;

  extern __shared__ __align__(16) float smem[];
  const int K = R + P;
  float* q_s = smem;                                  // [HG][K] queries
  float* s_s = q_s + HG * K;                          // [CH][MAX_H] scores
  float* m_s = s_s + CH * MAX_H;                      // [MAX_H] running max
  float* l_s = m_s + MAX_H;                           // [MAX_H] running sum
  float* corr_s = l_s + MAX_H;                        // [MAX_H] chunk rescale
  float* acc_s = corr_s + MAX_H;                      // [HG][R] context
  T* kv_s = reinterpret_cast<T*>(acc_s + HG * R);     // [CH][K] rows

  for (int i = tid; i < HG * K; i += THREADS) {
    const int h = i / K;
    const int kk = i - h * K;
    const int64_t bh = static_cast<int64_t>(b) * H + h0 + h;
    q_s[i] = kk < R ? q_abs[bh * R + kk] : q_pe[bh * P + (kk - R)];
  }
  if (tid < MAX_H) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_H];
#pragma unroll
  for (int h = 0; h < MAX_H; ++h) acc[h] = 0.f;

  const int rv = R / VEC;
  const int row_v = rv + P / VEC;
  for (int c0 = p_begin; c0 < p_end; c0 += CH) {
    const int nc = min(CH, p_end - c0);            // positions copied
    const int n = max(0, min(nc, valid - c0));     // of them attended
    // 0. copy the chunk into the new caches (the row at `ins` from c_new /
    //    pe_new; group 0 only) and stage the attended rows [latent | pe]
    const int nr = writes ? nc : n;                // positions read
    for (int i = tid; i < nr * row_v; i += THREADS) {
      const int j = i / row_v;
      const int c = i - j * row_v;
      const int pos = c0 + j;
      const bool is_new = pos == ins;
      const bool lat_part = c < rv;
      const int off = (lat_part ? c : c - rv) * VEC;
      const T* src = lat_part
          ? (is_new ? cn : lat_b + static_cast<int64_t>(pos) * R) + off
          : (is_new ? pn : pe_b + static_cast<int64_t>(pos) * P) + off;
      T* dst = lat_part ? lat_o + static_cast<int64_t>(pos) * R + off
                        : pe_o + static_cast<int64_t>(pos) * P + off;
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      if (writes) *reinterpret_cast<uint4*>(dst) = v;
      if (j < n)
        *reinterpret_cast<uint4*>(kv_s + j * K + (lat_part ? 0 : R) + off) =
            v;
    }
    __syncthreads();
    if (n > 0) {
      // 1. scores: warp w takes positions w * PPW .. + PPW - 1
      {
        const int j0 = warp * PPW;
        float part[PPW][MAX_H];
#pragma unroll
        for (int jj = 0; jj < PPW; ++jj)
#pragma unroll
          for (int h = 0; h < MAX_H; ++h) part[jj][h] = 0.f;
        if (j0 < n) {
          for (int kk = lane; kk < K; kk += 32) {
            float kv[PPW];
#pragma unroll
            for (int jj = 0; jj < PPW; ++jj)
              kv[jj] = j0 + jj < n ? to_f(kv_s[(j0 + jj) * K + kk]) : 0.f;
#pragma unroll
            for (int h = 0; h < MAX_H; ++h) {
              if (h < HG) {
                const float q = q_s[h * K + kk];
#pragma unroll
                for (int jj = 0; jj < PPW; ++jj) part[jj][h] += q * kv[jj];
              }
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < PPW; ++jj) {
#pragma unroll
          for (int h = 0; h < MAX_H; ++h) {
            if (h >= HG) break;
            float v = part[jj][h];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              v += __shfl_xor_sync(0xffffffffu, v, o);
            if (lane == 0 && j0 + jj < n)
              s_s[(j0 + jj) * MAX_H + h] = v * scale;
          }
        }
      }
      __syncthreads();
      // 2. per head: chunk max, rescale factor, p = exp(s - max), sum
      for (int h = warp; h < HG; h += WARPS) {
        float mx = NEG_INF;
        for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_s[j * MAX_H + h]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[h];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float e = expf(s_s[j * MAX_H + h] - m_new);
          s_s[j * MAX_H + h] = e;
          sum += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          corr_s[h] = corr;
          l_s[h] = l_s[h] * corr + sum;
          m_s[h] = m_new;
        }
      }
      __syncthreads();
      // 3. acc = acc * corr + p @ latent rows; thread tid owns column tid
      if (tid < R) {
        float pv[MAX_H];
#pragma unroll
        for (int h = 0; h < MAX_H; ++h) pv[h] = 0.f;
        for (int j = 0; j < n; ++j) {
          const float v = to_f(kv_s[j * K + tid]);
          const float4* pj = reinterpret_cast<const float4*>(s_s + j * MAX_H);
#pragma unroll
          for (int q4 = 0; q4 < MAX_H / 4; ++q4) {
            if (q4 * 4 >= HG) break;
            const float4 p4 = pj[q4];
            pv[q4 * 4 + 0] += p4.x * v;
            pv[q4 * 4 + 1] += p4.y * v;
            pv[q4 * 4 + 2] += p4.z * v;
            pv[q4 * 4 + 3] += p4.w * v;
          }
        }
#pragma unroll
        for (int h = 0; h < MAX_H; ++h)
          if (h < HG) acc[h] = acc[h] * corr_s[h] + pv[h];
      }
    }
    __syncthreads();
  }

  // ---- merge the splits of row b in ascending split order ---------------
  if (tid < R) {
#pragma unroll
    for (int h = 0; h < MAX_H; ++h)
      if (h < HG) acc_s[h * R + tid] = acc[h];
  }
  cluster.sync();
  const int cols = (R + SPLITS - 1) / SPLITS;
  const int col0 = split * cols;
  const int ncol = max(0, min(cols, R - col0));
  for (int i = tid; i < HG * ncol; i += THREADS) {
    const int h = i / ncol;
    const int col = col0 + (i - h * ncol);
    float mx = NEG_INF;
    for (int r = 0; r < SPLITS; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(m_s, r)[h]);
    float l = 0.f, c = 0.f;
    for (int r = 0; r < SPLITS; ++r) {
      const float w = expf(cluster.map_shared_rank(m_s, r)[h] - mx);
      l += cluster.map_shared_rank(l_s, r)[h] * w;
      c += cluster.map_shared_rank(acc_s, r)[h * R + col] * w;
    }
    ctx[(static_cast<int64_t>(b) * H + h0 + h) * R + col] =
        c / fmaxf(l, 1e-20f);
  }
  cluster.sync();              // no block leaves while others read it
}

template <typename T>
int launch(const void* q_abs, const void* q_pe, const void* c_new,
           const void* pe_new, const void* latent, const void* pe,
           const void* cache_len, int clen_stride, void* ctx, void* lat_out,
           void* pe_out, int B, int S, int H, int R, int P, float scale,
           cudaStream_t stream) {
  const size_t smem = mla_smem<T>(min(H, MAX_H), R, P);
  const int groups = (H + MAX_H - 1) / MAX_H;
  auto kernel = groups > 1 ? mla_decode_kernel<T, true>
                           : mla_decode_kernel<T, false>;
  // at the largest size the checked shapes need
  const cudaError_t e = opt_in_smem(
      kernel, static_cast<int>(mla_smem<T>(MAX_H, MAX_R, MAX_P)));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(SPLITS, B, groups), THREADS, smem, stream>>>(
      static_cast<const float*>(q_abs), static_cast<const float*>(q_pe),
      static_cast<const T*>(c_new), static_cast<const T*>(pe_new),
      static_cast<const T*>(latent), static_cast<const T*>(pe),
      static_cast<const int64_t*>(cache_len), clen_stride,
      static_cast<float*>(ctx), static_cast<T*>(lat_out),
      static_cast<T*>(pe_out), S, H, R, P, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32: 1 for float caches and new rows, 0 for bf16.
extern "C" int fused_mla_decode_attention_launch(
    const void* q_abs, const void* q_pe, const void* c_new,
    const void* pe_new, const void* latent, const void* pe,
    const void* cache_len, int clen_stride, void* ctx, void* lat_out,
    void* pe_out, int B, int S, int H, int R, int P, float scale, int f32,
    void* stream) {
  if (H < 1 || H > 65535 * MAX_H || R < 8 || R > MAX_R || R % 8 || P < 8 ||
      P > MAX_P || P % 8 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(q_abs, q_pe, c_new, pe_new, latent, pe,
                             cache_len, clen_stride, ctx, lat_out, pe_out, B,
                             S, H, R, P, scale, st)
             : launch<bf16>(q_abs, q_pe, c_new, pe_new, latent, pe,
                            cache_len, clen_stride, ctx, lat_out, pe_out, B,
                            S, H, R, P, scale, st);
}
