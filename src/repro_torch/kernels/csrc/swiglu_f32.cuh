// SwiGLU expert FFN in fp32 for Hopper (sm_90a), on the tensor cores as
// 3xTF32: the f32 path of `slot_ffn.cu`, `expert_ffn.cu` and
// `fused_moe_entry.cu`'s expert passes, the reference kernels' f32
// function. For every expert e, with w = slot_of_expert[e] (or e), over the
// first rows_e rows of x[e]:
//     g = x[e] @ Wg[w],  u = x[e] @ Wu[w]        (fp32 sums)
//     h = silu(g) * u                            (rounded to fp32: none)
//     out[e] = h @ Wd[w]                         (fp32 sums)
//
// Why 3xTF32. The tensor cores take fp32 only as TF32 (10 mantissa bits),
// and one TF32 product per multiply-add misses the reference's 2e-5 (about
// 1e-3 off at olmoe width). Split each operand instead, x = hi + lo with
// hi = tf32_rna(x) and lo = x - hi, read by the tensor cores truncated to
// TF32 (`split_tf32`), and sum
//     a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
// in fp32: a product of two TF32 values is exact in fp32, and only
// lo_a.lo_b (about 2^-22 relative) is dropped. The tensor core truncates
// its own sums, so the products of each 16-deep half slice are summed from
// zero there (small terms first) and the partial is added to the running
// fp32 sum on the CUDA cores, rounded to nearest: a running sum kept in
// the mma accumulator across all of K drifted 1.2e-4 from the plain
// version at olmoe width on the card (PERF.md, Findings). The twin in
// `kernels/ref.py` (`tf32_split`, `expert_ffn_3xtf32`) stays within 5e-6
// of the plain fp32 chain at olmoe width, where one product is 1e-3 off.
//
// Route: both, by the call's rows an expert (C). Up to 64 (decode: 1-4
// rows an expert), `mma.sync.m16n8k8` TF32, fragments read from shared
// memory as they land and split in registers, skipping 16-row groups with
// no tokens. More, wgmma m64n128k8 TF32: its B operand must be K-major
// for TF32 and the weights are (K, N) N-major, so a split pass writes
// their hi and lo K-major into shared memory first; mma.sync there stayed
// slower than fp32 cuBLAS, and wgmma at decode took 1.8x mma.sync's time
// (it multiplies all 128 rows of a tile; PERF.md, Findings).
// The route is the call's, never the tile's, so a row's bits do not
// depend on how many rows share its tile.
//
// What bounds it on an H100 SXM. At decode, the weight bytes of the
// routed, resident experts (28 experts x 3 x 2048 x 1024 x 4 B = 705 MB at
// olmoe width, 0.21 ms at 3.35 TB/s); with 128 rows an expert, the three
// TF32 products (3 x 1.03e11 FLOP at 495 TFLOP/s, 0.62 ms, for 64 experts
// at olmoe width). So the loads must run ahead of the math, and the math
// must be on the tensor cores.
//
// Design.
// - Tile walk as the bf16 GEMM's (`TileWalker`, twinned by
//   `kernels/ref.py::ffn_block_tiles`): the same 128-row m-tiles, 64-column
//   gate/up panels and 128-column down tiles, the same persistent grid, the
//   same row counts, so an expert with no rows reads neither x nor its
//   weights.
// - Loads: a ring of 4 stages of 32-deep K-slices in dynamic shared memory
//   (A: the tile's rows, only the 16-row groups that hold tokens; B: the
//   gate and up panels side by side, or two down panels), filled by
//   16-byte `cp.async` from all 256 threads, with the K and N tails and
//   rows past the count zero-filled. The ring runs on across tiles: a
//   block's next tile's first slices load while it finishes this one. Rows
//   are padded (A by 4 floats, B by 8) so every fragment read is free of
//   bank conflicts.
// - Split: hi rounded on its bit pattern in two integer operations
//   (`tf32_rna`; cvt.rna.tf32.f32 compiles to about six), lo one fp32
//   subtraction, not rounded (rounding it, or testing x for a NaN, cost
//   up to 40 % at decode; PERF.md, Findings).
// - Narrow route: each of the 8 warps owns 16 of the tile's 128 columns
//   (8 gate and the same 8 up columns, or 16 down columns) over every
//   16-row group that holds tokens; the group count is a template
//   argument, so the fragments' mma chains overlap.
// - Wide route: all threads split the stage's weights K-major into one of
//   two buffers while the tensor cores may still multiply the last slice
//   from the other; warpgroup g then multiplies rows 64 g .. + 63, A split
//   in registers, by all 128 columns.
// - Each 16-deep half slice's products (lo.hi, hi.lo, hi.hi per 8-deep
//   step) form a partial that is added to the running sum, k ascending.
//   Every output element is summed by one thread in one fixed order:
//   deterministic, no atomics, no split-K, and a row's value depends
//   neither on the other rows (the products are row-independent) nor on
//   the slot table.
// - Epilogue straight from the accumulators: SiLU(g) * u for gate/up, the
//   plain product for down, and in the MOE form the combine of
//   `moe_tile_done` (ascending expert id, no fused multiply-add).

#pragma once

#include "swiglu_gemm.cuh"

namespace {

constexpr int F32_THREADS = 256;                 // 8 warps
constexpr int F32_BK = 32;                       // K per stage
constexpr int F32_STAGES = 4;
constexpr int F32_TILE_N = 2 * PANEL;            // columns a stage holds
constexpr int F32_LDA = F32_BK + 4;              // A row pitch (floats)
constexpr int F32_LDB = F32_TILE_N + 8;          // B row pitch (floats)
constexpr int F32_A_FLOATS = BM * F32_LDA;
constexpr int F32_STAGE_FLOATS = F32_A_FLOATS + F32_BK * F32_LDB;

// 16 bytes from global to shared memory, asynchronously; `full` false
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, on
// the bit pattern: cvt.rna.tf32.f32's result for every finite x and the
// infinities, in two integer operations (the PTX instruction compiles to
// about six on sm_90a, and the split is the kernel's busiest code). A NaN
// may come out as a zero or an infinity; `split_tf32` keeps it all the
// same.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo as the tensor cores read them: hi = tf32_rna(x), and lo =
// x - hi (exact in fp32) as it is, since a TF32 operand's low 13 bits are
// not read, so lo is truncated to TF32 there (x - hi - lo below 2^-21 |x|).
// A NaN x makes lo the canonical NaN 0x7FFFFFFF, which stays a NaN in its
// top 19 bits, so the products, and the row's output, are NaN as in the
// plain fp32 chain. Twin: `kernels/ref.py::tf32_split`.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8 fp32) += a (16 x 8, row) @ b (8 x 8, col), TF32 operands
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a @ b, from zero
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// ---- narrow route (C <= 64 rows an expert): mma.sync --------------------
// Each of the 8 warps owns two 8-column fragments of the tile (gate and up
// at the same 8 columns, or 16 down columns) over every 16-row group that
// holds tokens: warp w's fragment j starts at stage column
//     GATED: 8 w (j = 0) and 64 + 8 w (j = 1);  otherwise 16 w + 8 j.
template <bool GATED>
__device__ __forceinline__ int narrow_col(int warp, int j) {
  return GATED ? (j == 0 ? 8 * warp : PANEL + 8 * warp) : 16 * warp + 8 * j;
}

// acc[2 m + j] += the stage's 32-deep slice of row group m times fragment
// j, for the tile's M16 <= 4 row groups. Per 16-deep half the products
// lo.hi, hi.lo, hi.hi of both 8-deep steps are summed from zero on the
// tensor cores, then added to acc in fp32. M16 is a template argument, so
// the loops unroll without a branch and the fragments' chains overlap.
template <int M16, bool GATED>
__device__ __forceinline__ void mma_slice(float (&acc)[16][4],
                                          const float* as, const float* bs,
                                          int warp, int gq, int tq) {
  const int nc0 = narrow_col<GATED>(warp, 0) + gq;
  const int nc1 = narrow_col<GATED>(warp, 1) + gq;
#pragma unroll
  for (int kh = 0; kh < F32_BK; kh += 16) {
    float p[M16][2][4];
#pragma unroll
    for (int ks = 0; ks < 16; ks += 8) {
      const int kk = kh + ks;
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* br = bs + (kk + tq + 4 * q) * F32_LDB;
        split_tf32(br[nc0], bh[0][q], bl[0][q]);
        split_tf32(br[nc1], bh[1][q], bl[1][q]);
      }
#pragma unroll
      for (int m = 0; m < M16; ++m) {
        const float* ar = as + (16 * m + gq) * F32_LDA + kk + tq;
        uint32_t ah[4], al[4];
        split_tf32(ar[0], ah[0], al[0]);
        split_tf32(ar[8 * F32_LDA], ah[1], al[1]);
        split_tf32(ar[4], ah[2], al[2]);
        split_tf32(ar[8 * F32_LDA + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (ks == 0)
            mma_tf32_new(p[m][j], al, bh[j]);
          else
            mma_tf32(p[m][j], al, bh[j]);
          mma_tf32(p[m][j], ah, bl[j]);
          mma_tf32(p[m][j], ah, bh[j]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M16; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[2 * m + j][i] += p[m][j][i];
  }
}

// ---- wide route (C > 64 rows an expert): wgmma ---------------------------
// wgmma takes TF32 operands K-major only, and the weights arrive (K, N)
// N-major, so a split pass writes hi and lo of the stage's B columns
// K-major into two 16 KB buffers, in the 128-byte-swizzled layout a wgmma
// descriptor reads (16-byte chunk c of 128-byte row n at chunk c ^ (n % 8)),
// double-buffered so that the next slice's split runs while the tensor
// cores multiply this one. A comes from registers: each warp splits its
// own 16 rows' fragments (the mma.sync layout) as it issues. Warpgroup g
// multiplies rows 64 g .. 64 g + 63 by all 128 columns: warp w owns row
// group w, and its accumulators are the 16 fragments of columns 8 j
// (GATED: j < 8 gate, j + 8 its up).
constexpr int SPLIT_BYTES = F32_TILE_N * F32_BK * 4;   // one of hi / lo
constexpr int B_LO = SPLIT_BYTES;                      // after B_HI (0)

// hi and lo of all of the stage's B columns into the split buffer at
// `split` (generic pointer, 1 KB aligned); consecutive threads take
// consecutive columns n, so the reads are free of bank conflicts.
__device__ __forceinline__ void split_b(uint8_t* split, const float* bs,
                                       int tid) {
  for (int i = tid; i < F32_TILE_N * (F32_BK / 4); i += F32_THREADS) {
    const int n = i % F32_TILE_N;
    const int c = i / F32_TILE_N;
    const float* b = bs + 4 * c * F32_LDB + n;
    uint4 hi, lo;
    split_tf32(b[0], hi.x, lo.x);
    split_tf32(b[F32_LDB], hi.y, lo.y);
    split_tf32(b[2 * F32_LDB], hi.z, lo.z);
    split_tf32(b[3 * F32_LDB], hi.w, lo.w);
    const uint32_t at = n * 128 + ((c ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(split + at) = hi;
    *reinterpret_cast<uint4*>(split + B_LO + at) = lo;
  }
  // the split buffer is read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 128 fp32) = d * (accumulate != 0) + A (64 x 8, the warpgroup's
// registers) @ B (8 x 128, K-major in 128-byte-swizzled shared memory)
__device__ __forceinline__ void wgmma_64x128x8_tf32(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// p = the stage's 32-deep slice for the warp's row group: A's fragments
// (rows 16 warp + gq (+8), k tq (+4) of each 8-deep step) split here,
// then lo.hi, hi.lo, hi.hi per step from zero, with B from the split
// buffer at shared address `split`. Issued and committed, not waited
// for; `ah` / `al` must stay untouched until it is.
__device__ __forceinline__ void wgmma_slice(float (&p)[64],
                                            uint32_t (&ah)[4][4],
                                            uint32_t (&al)[4][4],
                                            const float* as, uint32_t split,
                                            int warp, int gq, int tq) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* ar = as + (16 * warp + gq) * F32_LDA + 8 * s + tq;
    split_tf32(ar[0], ah[s][0], al[s][0]);
    split_tf32(ar[8 * F32_LDA], ah[s][1], al[s][1]);
    split_tf32(ar[4], ah[s][2], al[s][2]);
    split_tf32(ar[8 * F32_LDA + 4], ah[s][3], al[s][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t b_hi = desc_a(split + 32 * s);    // 8 k = 32 bytes
    const uint64_t b_lo = desc_a(split + B_LO + 32 * s);
    wgmma_64x128x8_tf32(p, al[s], b_hi, s);
    wgmma_64x128x8_tf32(p, ah[s], b_lo, 1);
    wgmma_64x128x8_tf32(p, ah[s], b_hi, 1);
  }
  wgmma_commit();
}

// acc (the warp's 16 fragments) += p, once the warpgroup's products are in
__device__ __forceinline__ void add_partial(float (&acc)[16][4],
                                            float (&p)[64]) {
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i / 4][i % 4] += p[i];
}

// Writes a finished tile from acc: fragment t's register 2h + i holds row
// gq + 8h of its row group, column 2 tq + i. WIDE: row group `warp`,
// fragments at columns 8 t; otherwise row groups m < m16, fragments 2 m + j
// at narrow_col(j). GATED: silu(g) * u; otherwise the sums.
template <bool WIDE, bool GATED>
__device__ __forceinline__ void store_tile(const float (&acc)[16][4],
                                           float* out, int64_t first, int m0,
                                           int rows, int m16, int n0, int N,
                                           int warp, int gq, int tq) {
  constexpr int NM = WIDE ? 1 : 4;              // row groups a warp
  constexpr int NJ = WIDE ? 16 : 2;             // fragments a row group
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int group = WIDE ? warp : m;
    if (group >= m16) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * group + gq + 8 * h;
      if (row >= rows) continue;
      float* o = out + (first + row) * N;
#pragma unroll
      for (int j = 0; j < (GATED ? NJ / 2 : NJ); ++j) {
        const int n =
            n0 + (WIDE ? 8 * j : narrow_col<GATED>(warp, j)) + 2 * tq;
        if (n >= N) continue;
        const float* a = acc[m * NJ + j];
        if constexpr (GATED) {
          const float* u = acc[m * NJ + j + NJ / 2];
          const float g0 = a[2 * h], g1 = a[2 * h + 1];
          *reinterpret_cast<float2*>(o + n) =
              make_float2(g0 / (1.0f + expf(-g0)) * u[2 * h],
                          g1 / (1.0f + expf(-g1)) * u[2 * h + 1]);
        } else {
          *reinterpret_cast<float2*>(o + n) =
              make_float2(a[2 * h], a[2 * h + 1]);
        }
      }
    }
  }
}

// A block's place in its flattened (tile, K-slice) sequence.
struct SliceCursor {
  TileWalker walk;
  int t, kb, panel, m0;
  bool live;
  __device__ void init(const int* counts, int E, int C, int n_panels) {
    walk.init(counts, E, C, n_panels);
    t = blockIdx.x;
    kb = 0;
    live = walk.next(t, panel, m0);
  }
  __device__ void advance(int n_k) {
    if (++kb < n_k) return;
    kb = 0;
    t += gridDim.x;
    live = walk.next(t, panel, m0);
  }
  // rows of the current tile that hold tokens, and their 16-row groups
  __device__ int rows() const { return min(BM, walk.rows - m0); }
  __device__ int m16() const { return (rows() + 15) / 16; }
};

__device__ __forceinline__ int slot_of(const int* slot_of_expert, int e,
                                       int n_slots) {
  const int s = slot_of_expert ? slot_of_expert[e] : e;
  return s < 0 ? 0 : (s >= n_slots ? n_slots - 1 : s);
}

// GATED: A = x (E, C, K=D), B0/B1 = gate/up (S, K, N=F), one 64-column
// panel of each a tile, out = h (E, C, F). Otherwise A = h (E, C, K=F),
// B0 = down (S, K, N=D), 128 columns a tile, out (E, C, D).
// MOE: `fused_moe_entry`'s grouped rows, as in `swiglu_gemm_kernel` (f32
// rounds nowhere, so only the row addressing and the combine differ).
// WIDE: the route for calls of more than 64 rows an expert (the host
// picks it from C, so every tile of a call takes the same route).
template <bool GATED, bool MOE, bool WIDE>
__global__ void __launch_bounds__(F32_THREADS, 1)
    swiglu_f32_kernel(const float* __restrict__ A,
                      const float* __restrict__ B0,
                      const float* __restrict__ B1,
                      const int* __restrict__ slot_of_expert,
                      const int* __restrict__ counts, int n_slots,
                      float* __restrict__ out, int E, int C, int N, int K,
                      MoeArgs moe) {
  constexpr int TILE_N = GATED ? PANEL : 2 * PANEL;
  extern __shared__ __align__(16) uint8_t f32_smem_raw[];
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
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;                 // fragment row / column group
  const int tq = lane % 4;                 // fragment k index
  const int n_panels = (N + TILE_N - 1) / TILE_N;
  const int n_k = (K + F32_BK - 1) / F32_BK;
  // WIDE: the split buffers (1 KB aligned), then the ring of stages
  const uint32_t split0 = (smem_u32(f32_smem_raw) + 1023u) & ~1023u;
  uint8_t* split = f32_smem_raw + (split0 - smem_u32(f32_smem_raw));
  const int ring_off = WIDE ? 4 * SPLIT_BYTES : 0;
  const uint32_t smem0 = split0 + ring_off;
  const float* ring = reinterpret_cast<const float*>(split + ring_off);

  // Each thread copies the same 16-byte chunks of every slice: A chunk
  // column a_col of rows tid / 8 + 32 r, B stage column b_col of k-rows
  // tid / 32 + 8 r. Their sources move only when the tile changes.
  constexpr int A_CHUNKS = F32_BK / 4;                 // 16-byte chunks a row
  constexpr int B_CHUNKS = F32_TILE_N / 4;
  const int a_col = 4 * (tid % A_CHUNKS);
  const int b_col = 4 * (tid % B_CHUNKS);
  const float* a_src = A;          // this thread's chunk of row m0, k 0
  const float* b_src = B0;         // this thread's chunk of k-row 0
  int a_rows = 0, a_groups = 0;
  bool b_ok = false;
  // one K-slice of the load cursor's tile into ring stage `st`
  auto load = [&](const SliceCursor& c, int st) {
    if (c.kb == 0) {                       // a new tile
      const int64_t first =
          MOE ? moe.start[c.walk.e] : static_cast<int64_t>(c.walk.e) * C;
      a_src = A + (first + c.m0) * K + a_col;
      a_rows = c.rows();
      a_groups = c.m16() * 16;
      const int64_t w = static_cast<int64_t>(
                            slot_of(slot_of_expert, c.walk.e, n_slots)) *
                        K * N;
      // GATED: gate in stage columns 0-63, up in 64-127, both at panel n0
      const int n = c.panel * TILE_N + (GATED ? b_col % PANEL : b_col);
      b_src = (GATED && b_col >= PANEL ? B1 : B0) + w + n;
      b_ok = n < N;
    }
    const int k0 = c.kb * F32_BK;
    const uint32_t as = smem0 + st * F32_STAGE_FLOATS * 4;
    const uint32_t bs = as + F32_A_FLOATS * 4;
    const bool a_k = k0 + a_col < K;
#pragma unroll
    for (int r = 0; r < BM * A_CHUNKS / F32_THREADS; ++r) {
      const int row = tid / A_CHUNKS + r * (F32_THREADS / A_CHUNKS);
      if (row >= a_groups) break;
      const bool ok = row < a_rows && a_k;
      cp_async16(as + (row * F32_LDA + a_col) * 4,
                 ok ? a_src + static_cast<int64_t>(row) * K + k0 : A, ok);
    }
#pragma unroll
    for (int r = 0; r < F32_BK * B_CHUNKS / F32_THREADS; ++r) {
      const int kk = tid / B_CHUNKS + r * (F32_THREADS / B_CHUNKS);
      const bool ok = b_ok && k0 + kk < K;
      cp_async16(bs + (kk * F32_LDB + b_col) * 4,
                 ok ? b_src + static_cast<int64_t>(k0 + kk) * N : B0, ok);
    }
  };

  SliceCursor ld, cur;
  ld.init(counts, E, C, n_panels);
  cur = ld;
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (ld.live) {
      load(ld, s);
      ld.advance(n_k);
    }
    cp_async_commit();
  }
  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  // a finished tile out of acc (then zeroed), and MOE's combine
  auto finish = [&](const SliceCursor& c) {
    const int n0 = c.panel * TILE_N;
    const int64_t first =
        MOE ? moe.start[c.walk.e] : static_cast<int64_t>(c.walk.e) * C;
    store_tile<WIDE, GATED>(acc, out, first, c.m0, c.walk.rows, c.m16(), n0,
                            N, warp, gq, tq);
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
    if constexpr (MOE && !GATED)
      moe_tile_done(moe, out, N, c.panel, n0, min(n0 + TILE_N, N), tid,
                    F32_THREADS, &combine_flag, [] { __syncthreads(); });
  };
  // WIDE: the partial the tensor cores fill, the A fragments they read,
  // and the tile of the slice in flight
  float p[WIDE ? 64 : 1];
#pragma unroll
  for (int i = 0; i < (WIDE ? 64 : 1); ++i) p[i] = 0.f;
  uint32_t ah[WIDE ? 4 : 1][4], al[WIDE ? 4 : 1][4];
  SliceCursor done = cur;
  int slice = 0;
  int stage = 0, ld_stage = F32_STAGES - 1;
  while (cur.live) {
    cp_async_wait<F32_STAGES - 2>();       // this slice has landed
    __syncthreads();                       // and the oldest stage is free
    if (ld.live) {
      load(ld, ld_stage);
      ld.advance(n_k);
    }
    cp_async_commit();
    if (++ld_stage == F32_STAGES) ld_stage = 0;

    const float* as = ring + stage * F32_STAGE_FLOATS;
    const float* bs = as + F32_A_FLOATS;
    if constexpr (WIDE) {
      // split B into this slice's buffer while the tensor cores may still
      // multiply the last slice (its buffer is the other one); then wait
      // for those products, add them, finish the last tile if this slice
      // starts a new one, and issue this slice. No branch surrounds a wait
      // or a wgmma (ptxas serialises wgmma in divergent code), so both
      // warpgroups multiply every slice, rows without tokens included.
      const uint32_t buf = (slice & 1) * 2 * SPLIT_BYTES;
      split_b(split + buf, bs, tid);
      __syncthreads();
      add_partial(acc, p);
      if (cur.kb == 0 && slice > 0) finish(done);
      wgmma_slice(p, ah, al, as, split0 + buf, warp, gq, tq);
      done = cur;
    } else {
      switch (cur.m16()) {     // a compile-time row count: no branch
        case 1: mma_slice<1, GATED>(acc, as, bs, warp, gq, tq); break;
        case 2: mma_slice<2, GATED>(acc, as, bs, warp, gq, tq); break;
        case 3: mma_slice<3, GATED>(acc, as, bs, warp, gq, tq); break;
        default: mma_slice<4, GATED>(acc, as, bs, warp, gq, tq); break;
      }
      if (cur.kb == n_k - 1) finish(cur);
    }
    if (++stage == F32_STAGES) stage = 0;
    ++slice;
    cur.advance(n_k);
  }
  if constexpr (WIDE) {
    if (slice > 0) {              // the last tile's last products
      add_partial(acc, p);
      finish(done);
    }
  }
  cp_async_wait<0>();
}

// Dynamic shared memory of a route: 1 KB alignment, WIDE's four split
// buffers, the ring.
constexpr int f32_smem_bytes(bool wide) {
  return 1024 + (wide ? 4 * SPLIT_BYTES : 0) +   // two buffers of hi + lo
         F32_STAGES * F32_STAGE_FLOATS * 4;
}

// One pass of the f32 GEMM on `stream`, its route picked from C (more
// than 64 rows an expert: wgmma). Returns cudaSuccess or the error.
template <bool GATED, bool MOE>
inline cudaError_t f32_pass(int grid, cudaStream_t st, const float* A,
                            const float* B0, const float* B1,
                            const int* slot_of_expert, const int* counts,
                            int n_slots, float* out, int E, int C, int N,
                            int K, const MoeArgs& moe) {
  const bool wide = C > 64;
  auto kernel = wide ? swiglu_f32_kernel<GATED, MOE, true>
                     : swiglu_f32_kernel<GATED, MOE, false>;
  const cudaError_t err = opt_in_smem(kernel, f32_smem_bytes(wide));
  if (err != cudaSuccess) return err;
  kernel<<<grid, F32_THREADS, f32_smem_bytes(wide), st>>>(
      A, B0, B1, slot_of_expert, counts, n_slots, out, E, C, N, K, moe);
  return cudaGetLastError();
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
  const cudaError_t err = f32_pass<true, false>(
      grid_for(dev, E, C, (F + PANEL - 1) / PANEL), st,
      static_cast<const float*>(x), static_cast<const float*>(w_gate),
      static_cast<const float*>(w_up), slot_of_expert, counts, S,
      static_cast<float*>(h), E, C, F, D, MoeArgs{});
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(f32_pass<false, false>(
      grid_for(dev, E, C, (D + 2 * PANEL - 1) / (2 * PANEL)), st,
      static_cast<const float*>(h), static_cast<const float*>(w_down),
      nullptr, slot_of_expert, counts, S, static_cast<float*>(out), E, C, D,
      F, MoeArgs{}));
}

}  // namespace
