// Slot-indirect expert SwiGLU FFN for Hopper (sm_90a), bf16 in, fp32 out.
//
// Replaces the TPU kernel `repro/kernels/slot_gather.py::slot_ffn`
// (`_slot_ffn_kernel`, pallas_call at slot_gather.py:72): for every expert e
//     g = x[e] @ Wg[slot[e]],  u = x[e] @ Wu[slot[e]]        (fp32 sums)
//     h = bf16(silu(g) * u)
//     out[e] = h @ Wd[slot[e]]                                (fp32 sums)
// with the weights read straight out of the bounded slot buffer through the
// expert -> slot table.
//
// Design.
// - The TPU version hands the table to its BlockSpec index maps as a
//   scalar-prefetch operand. Here every block chases the pointer itself:
//   it reads slot_of_expert[e] from device memory and offsets its weight
//   loads by it. No gathered copy of the weights is ever made.
// - The TPU reduces h @ Wd over F tiles in a sequential grid, carrying the
//   sum in its output block. Blocks on the card run in no order, and a
//   (rows x D) fp32 sum does not fit a block, so the FFN runs as two
//   launches on one stream: (1) g/u GEMMs over D with the SwiGLU epilogue,
//   writing h in bf16 (the same rounding point as the TPU kernel); (2) the
//   h @ Wd GEMM, one block per output tile, looping over all of F. No
//   atomics and no split-F: every output element is summed by one thread
//   in one fixed order, so the result is deterministic from run to run.
// - Both launches are one tiled GEMM: 64x64 output tiles, 4 warps of
//   mma.sync.m16n8k16 (bf16 x bf16 -> fp32), 32-deep K tiles staged through
//   shared memory by a 2-stage cp.async pipeline. B tiles are row-major in
//   shared memory and reach the tensor cores through ldmatrix.trans. Ragged
//   C is masked by row; D and F must be multiples of 8 (16-byte loads), and
//   their ragged tails are zero-filled.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), olmoe-1b-7b
// (D = 2048, F = 1024, E = 64; one expert = 12.6 MB):
// - decode, batch 4: C = B*k = 32, E*C = 2048 rows, 25.8 GFLOP. Memory
//   bound: it reads the weights of every distinct slot the table names (at
//   most B*k = 32 routed experts, 403 MB; 805 MB if all 64 are distinct),
//   so the floor is distinct bytes / 3.35 TB/s, 0.12-0.24 ms.
// - prefill, a 128-token prompt: C = T*k = 1024, E*C = 65536 rows,
//   0.82 TFLOP per layer, so 0.83 ms at 989 TFLOP/s.
// Only T*k of the E*C dispatch rows hold tokens; the rest are zero padding
// that this kernel multiplies like any other row (E*C / (T*k) = 64x the
// needed work at both shapes). Skipping empty rows is left to a later
// change; the caller's capacity choice, not the kernel, sets the padding.
//
// C interface (bound with ctypes): slot_ffn_launch returns cudaGetLastError()
// after enqueueing both launches on `stream`. It allocates nothing: the
// caller passes the bf16 (E, C, F) scratch `h` and the fp32 output.

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
// e = blockIdx.z. GATED: two B operands (gate, up), epilogue
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
  // the expert -> slot pointer chase (clamped: never read outside the buffer)
  int slot = slot_of_expert[e];
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

}  // namespace

extern "C" int slot_ffn_launch(const void* x, const void* slot_of_expert,
                               const void* s_gate, const void* s_up,
                               const void* s_down, void* h, void* out, int E,
                               int C, int D, int F, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* slot = static_cast<const int*>(slot_of_expert);
  const dim3 block(THREADS);
  // (1) h = bf16(silu(x @ Wg) * (x @ Wu)): M = C, N = F, K = D
  const dim3 grid_h((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  slot_gemm_kernel<true><<<grid_h, block, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int64_t>(C) * D, slot, S,
      static_cast<const bf16*>(s_gate), static_cast<const bf16*>(s_up),
      static_cast<int64_t>(D) * F, h, static_cast<int64_t>(C) * F, C, F, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // (2) out = h @ Wd: M = C, N = D, K = F
  const dim3 grid_o((D + BN - 1) / BN, (C + BM - 1) / BM, E);
  slot_gemm_kernel<false><<<grid_o, block, 0, st>>>(
      static_cast<const bf16*>(h), static_cast<int64_t>(C) * F, slot, S,
      static_cast<const bf16*>(s_down), nullptr, static_cast<int64_t>(F) * D,
      out, static_cast<int64_t>(C) * D, C, D, F);
  return static_cast<int>(cudaGetLastError());
}
