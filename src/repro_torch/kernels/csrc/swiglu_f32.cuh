// SwiGLU expert FFN in fp32 for Hopper (sm_90a), on the CUDA cores: the f32
// path of `slot_ffn.cu` and `expert_ffn.cu`, the reference kernels' f32
// function. For every expert e, with w = slot_of_expert[e] (or e), over the
// first rows_e rows of x[e]:
//     g = x[e] @ Wg[w],  u = x[e] @ Wu[w]        (fp32 sums)
//     h = silu(g) * u                            (rounded to fp32: none)
//     out[e] = h @ Wd[w]                         (fp32 sums)
//
// Why not the bf16 path's wgmma: the tensor cores take fp32 only as TF32,
// which keeps about three decimal digits and misses the reference's 2e-5.
// So this is a plain shared-memory tiled GEMM on the CUDA cores (67 TFLOP/s
// fp32 on an H100 SXM against 989 bf16): bound by operations above a few
// rows per expert, and meant to be right, not fast.
//
// It walks the bf16 GEMM's tile list (`TileWalker`, twinned by
// `kernels/ref.py::ffn_block_tiles`): the same 128-row m-tiles, 64-column
// gate/up panels and 128-column down tiles, the same persistent grid, and
// the same row counts, so an expert with no rows reads neither x nor its
// weights. A tile stages 16-deep slices of its rows (transposed) and of
// the weight panel(s) in shared memory; each of the 256 threads keeps an
// 8 x 4 block per weight operand (gate/up) or 8 x 8 (down) in registers
// and sums k in ascending order: deterministic, no atomics, no split-K.

#pragma once

#include "swiglu_gemm.cuh"

namespace {

constexpr int F32_THREADS = 256;
constexpr int F32_BK = 16;

// GATED: A = x (E, C, K=D), B0/B1 = gate/up (S, K, N=F), one 64-column
// panel a tile, out = h (E, C, F). Otherwise A = h (E, C, K=F), B0 = down
// (S, K, N=D), 128 columns a tile, out (E, C, D).
// MOE: `fused_moe_entry`'s grouped rows, as in `swiglu_gemm_kernel` (f32
// rounds nowhere, so only the row addressing and the combine differ).
template <bool GATED, bool MOE = false>
__global__ void __launch_bounds__(F32_THREADS)
    swiglu_f32_kernel(const float* __restrict__ A,
                      const float* __restrict__ B0,
                      const float* __restrict__ B1,
                      const int* __restrict__ slot_of_expert,
                      const int* __restrict__ counts, int n_slots,
                      float* __restrict__ out, int E, int C, int N, int K,
                      MoeArgs moe) {
  constexpr int TILE_N = GATED ? PANEL : 2 * PANEL;
  constexpr int NB = GATED ? 2 : 1;
  constexpr int TR = 8;                         // rows a thread
  constexpr int TC = TILE_N / 16;               // columns a thread
  __shared__ float As[F32_BK][BM];
  __shared__ float Bs[NB][F32_BK][TILE_N];
  __shared__ int combine_flag;
  if constexpr (MOE && !GATED) {
    if (*moe.tiles == 0) {                 // nothing routed is resident
      for (int64_t i = blockIdx.x * F32_THREADS + threadIdx.x;
           i < static_cast<int64_t>(moe.T) * N; i += gridDim.x * F32_THREADS)
        moe.y[i] = 0.f;
      return;
    }
  }
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int n_panels = (N + TILE_N - 1) / TILE_N;
  TileWalker walk;
  walk.init(counts, E, C, n_panels);
  int panel, m0;
  for (int t = blockIdx.x; walk.next(t, panel, m0); t += gridDim.x) {
    int slot = slot_of_expert ? slot_of_expert[walk.e] : walk.e;
    slot = slot < 0 ? 0 : (slot >= n_slots ? n_slots - 1 : slot);
    const int n0 = panel * TILE_N;
    const int64_t first =
        MOE ? moe.start[walk.e] : static_cast<int64_t>(walk.e) * C;
    const float* a = A + first * K;
    const float* b0 = B0 + static_cast<int64_t>(slot) * K * N;
    const float* b1 = GATED ? B1 + static_cast<int64_t>(slot) * K * N : b0;
    float acc[NB][TR][TC];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[i][r][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += F32_BK) {
      __syncthreads();                          // the slices are free
      for (int i = tid; i < BM * F32_BK; i += F32_THREADS) {
        const int r = i / F32_BK;
        const int kk = i % F32_BK;
        const int row = m0 + r;
        As[kk][r] = row < walk.rows && k0 + kk < K
                        ? a[static_cast<int64_t>(row) * K + k0 + kk]
                        : 0.f;
      }
      for (int i = tid; i < NB * F32_BK * TILE_N; i += F32_THREADS) {
        const int m = i / (F32_BK * TILE_N);
        const int kk = (i / TILE_N) % F32_BK;
        const int n = i % TILE_N;
        Bs[m][kk][n] = k0 + kk < K && n0 + n < N
                           ? (m ? b1 : b0)[static_cast<int64_t>(k0 + kk) * N +
                                           n0 + n]
                           : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < F32_BK; ++kk) {
        float av[TR];
#pragma unroll
        for (int r = 0; r < TR; ++r) av[r] = As[kk][ty * TR + r];
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            const float bv = Bs[i][kk][tx * TC + c];
#pragma unroll
            for (int r = 0; r < TR; ++r) acc[i][r][c] += av[r] * bv;
          }
      }
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = m0 + ty * TR + r;
      if (row >= walk.rows) continue;
      float* o = out + (first + row) * N;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int n = n0 + tx * TC + c;
        if (n >= N) continue;
        if constexpr (GATED) {
          const float g = acc[0][r][c];
          o[n] = g / (1.0f + expf(-g)) * acc[1][r][c];
        } else {
          o[n] = acc[0][r][c];
        }
      }
    }
    if constexpr (MOE && !GATED)
      moe_tile_done(moe, out, N, panel, n0, min(n0 + TILE_N, N),
                    static_cast<int>(threadIdx.x), F32_THREADS,
                    &combine_flag, [] { __syncthreads(); });
  }
}

// The two launches of the fp32 SwiGLU FFN on `stream`; `h` is the fp32
// (E, C, F) scratch. Returns cudaGetLastError().
inline int swiglu_ffn_f32_launch(const void* x, const int* slot_of_expert,
                                 const int* counts, const void* w_gate,
                                 const void* w_up, const void* w_down,
                                 void* h, void* out, int E, int C, int D,
                                 int F, int S, void* stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  swiglu_f32_kernel<true>
      <<<grid_for(dev, E, C, (F + PANEL - 1) / PANEL), F32_THREADS, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w_gate),
          static_cast<const float*>(w_up), slot_of_expert, counts, S,
          static_cast<float*>(h), E, C, F, D, MoeArgs{});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swiglu_f32_kernel<false>
      <<<grid_for(dev, E, C, (D + 2 * PANEL - 1) / (2 * PANEL)), F32_THREADS,
         0, st>>>(static_cast<const float*>(h),
                  static_cast<const float*>(w_down), nullptr, slot_of_expert,
                  counts, S, static_cast<float*>(out), E, C, D, F, MoeArgs{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
