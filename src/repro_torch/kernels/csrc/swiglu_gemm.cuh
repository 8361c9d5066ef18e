// Tiled SwiGLU expert FFN for Hopper (sm_90a), bf16 in, fp32 out: the
// device code shared by `slot_ffn.cu` (weights read through an expert ->
// slot table) and `expert_ffn.cu` (weights indexed by expert). For every
// expert e, with w = slot_of_expert[e] (or e without a table):
//     g = x[e] @ Wg[w],  u = x[e] @ Wu[w]        (fp32 sums)
//     h = bf16(silu(g) * u)
//     out[e] = h @ Wd[w]                         (fp32 sums)
//
// Two launches on one stream: (1) g/u GEMMs over D with the SwiGLU
// epilogue, writing h in bf16; (2) the h @ Wd GEMM, one block per output
// tile, looping over all of F. No atomics and no split-F: every output
// element is summed by one thread in one fixed order, so the result is
// deterministic, and both entry points give the same bits for the same
// weights. Both launches are one tiled GEMM: 64x64 output tiles, 4 warps of
// mma.sync.m16n8k16 (bf16 x bf16 -> fp32), 32-deep K tiles staged through
// shared memory by a 2-stage cp.async pipeline. B tiles are row-major in
// shared memory and reach the tensor cores through ldmatrix.trans. Ragged
// C is masked by row; D and F must be multiples of 8 (16-byte loads), and
// their ragged tails are zero-filled.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // reduction depth per pipeline stage
constexpr int THREADS = 128;    // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int PAD = 8;          // bf16 padding per shared-memory row
constexpr int A_LD = BK + PAD;  // 40 elements = 80 bytes (16-byte aligned)
constexpr int B_LD = BN + PAD;  // 72 elements = 144 bytes

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when `pred` is false.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two B fragments (n-blocks n and n+8) of a 16 x 16 k x n tile stored
// row-major (k rows) in shared memory.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One 64 x 64 output tile of A[e] (M x K) @ B[slot[e]] (K x N), per expert
// e = blockIdx.z (slot[e] = e when slot_of_expert is null). GATED: two B operands (gate, up), epilogue
// bf16(silu(g) * u) into a bf16 output; otherwise fp32 output.
template <bool GATED>
__global__ void __launch_bounds__(THREADS)
    slot_gemm_kernel(const bf16* __restrict__ A, int64_t a_expert_stride,
                     const int* __restrict__ slot_of_expert, int n_slots,
                     const bf16* __restrict__ B0, const bf16* __restrict__ B1,
                     int64_t b_slot_stride, void* __restrict__ out,
                     int64_t o_expert_stride, int M, int N, int K) {
  constexpr int NB = GATED ? 2 : 1;
  __shared__ __align__(16) bf16 As[2][BM * A_LD];
  __shared__ __align__(16) bf16 Bs[NB][2][BK * B_LD];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // the expert -> slot pointer chase (clamped: never read outside the
  // buffer); without a table, expert e's weights are entry e
  int slot = slot_of_expert ? slot_of_expert[e] : e;
  slot = slot < 0 ? 0 : (slot >= n_slots ? n_slots - 1 : slot);

  const bf16* a_base = A + static_cast<int64_t>(e) * a_expert_stride;
  const bf16* b_base[NB];
  b_base[0] = B0 + static_cast<int64_t>(slot) * b_slot_stride;
  if constexpr (GATED) b_base[NB - 1] = B1 + static_cast<int64_t>(slot) * b_slot_stride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // warp's row offset in the tile
  const int wn = (warp & 1) * 32;   // warp's column offset in the tile
  const int grp = lane >> 2;        // mma group id
  const int tig = lane & 3;         // thread in group

  auto load_stage = [&](int stage, int k0) {
    // A: 64 rows x 32 cols = 256 16-byte chunks, 2 per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 2;
      const int col = (c & 3) * 8;
      const bool ok = (m0 + r < M) && (k0 + col < K);
      const bf16* src = ok ? a_base + static_cast<int64_t>(m0 + r) * K + k0 + col
                           : a_base;
      cp_async16(&As[stage][r * A_LD + col], src, ok);
    }
    // B: 32 rows x 64 cols = 256 chunks, 2 per thread per operand
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * THREADS;
        const int r = c >> 3;
        const int col = (c & 7) * 8;
        const bool ok = (k0 + r < K) && (n0 + col < N);
        const bf16* src =
            ok ? b_base[b] + static_cast<int64_t>(k0 + r) * N + n0 + col
               : b_base[b];
        cp_async16(&Bs[b][stage][r * B_LD + col], src, ok);
      }
    }
  };

  float acc[NB][2][4][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[b][i][j][q] = 0.f;

  const int n_k = (K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_k) {
      load_stage(stage ^ 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* a = &As[stage][(wm + i * 16 + grp) * A_LD + kk + tig * 2];
        af[i][0] = ld_u32(a);
        af[i][1] = ld_u32(a + 8 * A_LD);
        af[i][2] = ld_u32(a + 8);
        af[i][3] = ld_u32(a + 8 * A_LD + 8);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, &Bs[b][stage][(kk + (lane & 15)) * B_LD + wn +
                                              jp * 16 + (lane >> 4) * 8]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[b][i][jp * 2], af[i], bf[0], bf[1]);
            mma_bf16(acc[b][i][jp * 2 + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: c0,c1 at (row grp, cols 2*tig, +1); c2,c3 at row grp + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + tig * 2;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + i * 16 + grp + half * 8;
        if (row >= M) continue;
        const int64_t off = static_cast<int64_t>(e) * o_expert_stride +
                            static_cast<int64_t>(row) * N + col;
        if constexpr (GATED) {
          const float g0 = acc[0][i][j][half * 2];
          const float g1 = acc[0][i][j][half * 2 + 1];
          const float u0 = acc[NB - 1][i][j][half * 2];
          const float u1 = acc[NB - 1][i][j][half * 2 + 1];
          __nv_bfloat162 h;
          h.x = __float2bfloat16(g0 / (1.0f + expf(-g0)) * u0);
          h.y = __float2bfloat16(g1 / (1.0f + expf(-g1)) * u1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) = h;
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
              make_float2(acc[0][i][j][half * 2], acc[0][i][j][half * 2 + 1]);
        }
      }
    }
  }
}


// The two launches of the SwiGLU FFN on `stream`; returns
// cudaGetLastError(). `slot_of_expert` may be null (weights indexed by
// expert); `h` is the bf16 (E, C, F) scratch, `out` the fp32 (E, C, D).
inline int swiglu_ffn_launch(const void* x, const int* slot_of_expert,
                             const void* w_gate, const void* w_up,
                             const void* w_down, void* h, void* out, int E,
                             int C, int D, int F, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(THREADS);
  // (1) h = bf16(silu(x @ Wg) * (x @ Wu)): M = C, N = F, K = D
  const dim3 grid_h((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  slot_gemm_kernel<true><<<grid_h, block, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int64_t>(C) * D,
      slot_of_expert, S, static_cast<const bf16*>(w_gate),
      static_cast<const bf16*>(w_up), static_cast<int64_t>(D) * F, h,
      static_cast<int64_t>(C) * F, C, F, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // (2) out = h @ Wd: M = C, N = D, K = F
  const dim3 grid_o((D + BN - 1) / BN, (C + BM - 1) / BM, E);
  slot_gemm_kernel<false><<<grid_o, block, 0, st>>>(
      static_cast<const bf16*>(h), static_cast<int64_t>(C) * F,
      slot_of_expert, S, static_cast<const bf16*>(w_down), nullptr,
      static_cast<int64_t>(F) * D, out, static_cast<int64_t>(C) * D, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

