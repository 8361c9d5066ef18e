// Weight-absorbed MLA decode attention with the positional latent insert,
// for Hopper (sm_90a): fp32 queries and output, bf16 caches.
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
// Design.
// - The TPU version walks the batch in a sequential grid, one step per row,
//   with the row's whole (S, R) latent in VMEM. Here the grid is
//   (B, 1 + ceil(S / COPY_POS)): block y = 0 of row b attends, blocks y >= 1
//   each copy COPY_POS positions of the row's old caches into the new ones.
//   The caches are never written in place (copy semantics: a saved decode
//   state, the engine's replay checkpoints and the oracle keep the old
//   tensors), so the copy is needed anyway and the insert is fused into it.
//   The attention block reads the old caches and substitutes the inserted
//   row itself, so it never waits for the copy blocks.
// - One latent row serves every head. Per chunk of BLOCK_S positions the
//   attention block first stages the rows [latent | pe] in shared memory,
//   every thread issuing its 16-byte loads at once (only positions <= c are
//   read). Scores: warp w takes PPW positions together, lanes stride over
//   R + P against the H absorbed queries held in shared memory (fp32), so
//   one query read serves PPW positions; a shuffle reduction sums each
//   score. Values: thread t owns latent column t and keeps H fp32
//   accumulators, so one shared-memory read of a row element feeds H
//   multiply-adds.
// - Online softmax over the chunks, as the TPU kernel does. Warp w does the
//   max / exp / sum bookkeeping of heads w, w + 16, in one fixed order, so
//   the result is the same from run to run. expf, not __expf.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32), DeepSeek-V2-Lite decode
// at batch 4 (H = 16, R = 512, P = 64, S = 256): the copy reads and writes
// B * S * (R + P) * 2 bytes each way, 1.18 MB + 1.18 MB; q_abs, q_pe and ctx
// add 0.28 MB; about 2.6 MB, 0.8 us. FLOPs are 2 * H * (2 * R + P) per
// attended position (scores over R + P, values over R), 36 MFLOP at full
// length, 0.5 us. So it is bound by bytes, and
// what the design does about it is read every cache byte once: the copy
// blocks stream the caches with 16-byte vectors, and the attention block
// reads only the filled prefix, each row once for all heads. It does not
// reach the bound: one attention block per row leaves most SMs idle and
// walks the prefix serially, and its ~4.5 M fp32 multiply-adds per full
// row take ~20 us on one SM's CUDA cores (splitting S across blocks with a
// combine pass is left to a later change).
//
// C interface (ctypes): fused_mla_decode_attention_launch returns
// cudaGetLastError() after enqueueing the kernel on `stream`. cache_len is
// int64, read at b * clen_stride (stride 0: one length for every row); the
// caller guarantees 0 <= cache_len < S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK_S = 64;       // positions per online-softmax chunk
constexpr int PPW = BLOCK_S / WARPS;  // positions per warp in a chunk
constexpr int COPY_POS = 16;      // positions per copy block
constexpr int MAX_H = 16;         // query heads
constexpr int MAX_R = THREADS;    // latent width: one column per thread
constexpr int MAX_P = 128;        // rope key width
constexpr float NEG_INF = -1073741824.0f;   // -2^30, as the reference

__global__ void __launch_bounds__(THREADS)
    mla_decode_kernel(const float* __restrict__ q_abs,
                      const float* __restrict__ q_pe,
                      const bf16* __restrict__ c_new,
                      const bf16* __restrict__ pe_new,
                      const bf16* __restrict__ latent,
                      const bf16* __restrict__ pe,
                      const int64_t* __restrict__ cache_len, int clen_stride,
                      float* __restrict__ ctx, bf16* __restrict__ lat_out,
                      bf16* __restrict__ pe_out, int S, int H, int R, int P,
                      float scale) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ins = static_cast<int>(
      cache_len[static_cast<int64_t>(b) * clen_stride]);
  const bf16* lat_b = latent + static_cast<int64_t>(b) * S * R;
  const bf16* pe_b = pe + static_cast<int64_t>(b) * S * P;
  const bf16* cn = c_new + static_cast<int64_t>(b) * R;
  const bf16* pn = pe_new + static_cast<int64_t>(b) * P;

  if (blockIdx.y > 0) {
    // ---- copy COPY_POS positions, the inserted row from c_new / pe_new --
    const int p0 = (blockIdx.y - 1) * COPY_POS;
    const int p1 = min(p0 + COPY_POS, S);
    const int rv = R / 8;
    const int row_v = rv + P / 8;
    bf16* lat_o = lat_out + static_cast<int64_t>(b) * S * R;
    bf16* pe_o = pe_out + static_cast<int64_t>(b) * S * P;
    for (int i = tid; i < (p1 - p0) * row_v; i += THREADS) {
      const int pos = p0 + i / row_v;
      const int c = i - (pos - p0) * row_v;
      const bool is_new = pos == ins;
      if (c < rv) {
        const bf16* src = (is_new ? cn : lat_b + static_cast<int64_t>(pos) * R)
                          + c * 8;
        *reinterpret_cast<uint4*>(lat_o + static_cast<int64_t>(pos) * R +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        const int cp = (c - rv) * 8;
        const bf16* src = (is_new ? pn : pe_b + static_cast<int64_t>(pos) * P)
                          + cp;
        *reinterpret_cast<uint4*>(pe_o + static_cast<int64_t>(pos) * P + cp) =
            *reinterpret_cast<const uint4*>(src);
      }
    }
    return;
  }

  // ---- attention of the H heads of row b ----------------------------------
  extern __shared__ __align__(16) float smem[];
  const int K = R + P;
  float* q_s = smem;                                  // [H][K] fp32 queries
  bf16* kv_s = reinterpret_cast<bf16*>(q_s + H * K);  // [BLOCK_S][K] rows
  float* s_s = reinterpret_cast<float*>(kv_s + BLOCK_S * K);  // [S][MAX_H]
  float* m_s = s_s + BLOCK_S * MAX_H;                 // [MAX_H] running max
  float* l_s = m_s + MAX_H;                           // [MAX_H] running sum
  float* corr_s = l_s + MAX_H;                        // [MAX_H] chunk rescale

  for (int i = tid; i < H * K; i += THREADS) {
    const int h = i / K;
    const int k = i - h * K;
    q_s[i] = k < R ? q_abs[(static_cast<int64_t>(b) * H + h) * R + k]
                   : q_pe[(static_cast<int64_t>(b) * H + h) * P + (k - R)];
  }
  if (tid < MAX_H) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_H];
#pragma unroll
  for (int h = 0; h < MAX_H; ++h) acc[h] = 0.f;

  const int valid = min(ins + 1, S);
  const int rv = R / 8;
  const int row_v = rv + P / 8;
  for (int c0 = 0; c0 < valid; c0 += BLOCK_S) {
    const int n = min(BLOCK_S, valid - c0);
    // 0. stage the chunk's rows [latent | pe] in shared memory: every
    //    thread issues its 16-byte loads at once; the inserted row comes
    //    from c_new / pe_new
    for (int i = tid; i < n * row_v; i += THREADS) {
      const int j = i / row_v;
      const int c = i - j * row_v;
      const int pos = c0 + j;
      const bool is_new = pos == ins;
      const bf16* row = c < rv
          ? (is_new ? cn : lat_b + static_cast<int64_t>(pos) * R)
          : (is_new ? pn : pe_b + static_cast<int64_t>(pos) * P);
      const bf16* src = row + (c < rv ? c : c - rv) * 8;
      *reinterpret_cast<uint4*>(kv_s + j * K + c * 8) =
          *reinterpret_cast<const uint4*>(src);
    }
    __syncthreads();
    // 1. scores: warp w takes positions w * PPW .. + PPW - 1 together, so
    //    each query value read from shared memory serves PPW positions;
    //    lanes stride over R + P, a shuffle reduction sums each score
    {
      const int j0 = warp * PPW;
      float part[PPW][MAX_H];
#pragma unroll
      for (int jj = 0; jj < PPW; ++jj)
#pragma unroll
        for (int h = 0; h < MAX_H; ++h) part[jj][h] = 0.f;
      if (j0 < n) {
        for (int k = lane; k < K; k += 32) {
          float kv[PPW];
#pragma unroll
          for (int jj = 0; jj < PPW; ++jj)
            kv[jj] = j0 + jj < n ? __bfloat162float(kv_s[(j0 + jj) * K + k])
                                 : 0.f;
#pragma unroll
          for (int h = 0; h < MAX_H; ++h) {
            if (h < H) {
              const float q = q_s[h * K + k];
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
          if (h >= H) break;
          float v = part[jj][h];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0 && j0 + jj < n) s_s[(j0 + jj) * MAX_H + h] = v * scale;
        }
      }
    }
    __syncthreads();
    // 2. per head: chunk max, rescale factor, p = exp(s - max), running sum
    for (int h = warp; h < H; h += WARPS) {
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
    // 3. acc = acc * corr + p @ latent rows; thread tid owns latent column
    //    tid, one shared-memory read of a row element feeds all H heads
    if (tid < R) {
      float pv[MAX_H];
#pragma unroll
      for (int h = 0; h < MAX_H; ++h) pv[h] = 0.f;
      for (int j = 0; j < n; ++j) {
        const float v = __bfloat162float(kv_s[j * K + tid]);
        const float4* pj = reinterpret_cast<const float4*>(s_s + j * MAX_H);
#pragma unroll
        for (int q4 = 0; q4 < MAX_H / 4; ++q4) {
          if (q4 * 4 >= H) break;
          const float4 p4 = pj[q4];
          pv[q4 * 4 + 0] += p4.x * v;
          pv[q4 * 4 + 1] += p4.y * v;
          pv[q4 * 4 + 2] += p4.z * v;
          pv[q4 * 4 + 3] += p4.w * v;
        }
      }
#pragma unroll
      for (int h = 0; h < MAX_H; ++h)
        if (h < H) acc[h] = acc[h] * corr_s[h] + pv[h];
    }
    __syncthreads();
  }

  if (tid < R) {
#pragma unroll
    for (int h = 0; h < MAX_H; ++h) {
      if (h >= H) break;
      ctx[(static_cast<int64_t>(b) * H + h) * R + tid] =
          acc[h] / fmaxf(l_s[h], 1e-20f);
    }
  }
}

}  // namespace

extern "C" int fused_mla_decode_attention_launch(
    const void* q_abs, const void* q_pe, const void* c_new,
    const void* pe_new, const void* latent, const void* pe,
    const void* cache_len, int clen_stride, void* ctx, void* lat_out,
    void* pe_out, int B, int S, int H, int R, int P, float scale,
    void* stream) {
  if (H < 1 || H > MAX_H || R < 8 || R > MAX_R || R % 8 || P < 8 ||
      P > MAX_P || P % 8 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(H) * (R + P) + BLOCK_S * MAX_H + 3 * MAX_H) *
          sizeof(float) +
      static_cast<size_t>(BLOCK_S) * (R + P) * sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B, 1 + (S + COPY_POS - 1) / COPY_POS);
  mla_decode_kernel<<<grid, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_abs), static_cast<const float*>(q_pe),
      static_cast<const bf16*>(c_new), static_cast<const bf16*>(pe_new),
      static_cast<const bf16*>(latent), static_cast<const bf16*>(pe),
      static_cast<const int64_t*>(cache_len), clen_stride,
      static_cast<float*>(ctx), static_cast<bf16*>(lat_out),
      static_cast<bf16*>(pe_out), S, H, R, P, scale);
  return static_cast<int>(cudaGetLastError());
}
