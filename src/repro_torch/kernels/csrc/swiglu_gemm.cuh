// SwiGLU expert FFN for Hopper (sm_90a), bf16 in, fp32 out: the device
// code shared by `slot_ffn.cu` (weights read through an expert -> slot
// table) and `expert_ffn.cu` (weights indexed by expert). For every expert
// e, with w = slot_of_expert[e] (or e without a table), over the first
// rows_e rows of x[e] (rows_e = counts[e] clamped to [0, C], or C without
// counts):
//     g = x[e] @ Wg[w],  u = x[e] @ Wu[w]        (fp32 sums)
//     h = bf16(silu(g) * u)
//     out[e] = h @ Wd[w]                         (fp32 sums)
//
// Two launches on one stream: (1) the g/u GEMMs over D with the SwiGLU
// epilogue, writing h in bf16; (2) the h @ Wd GEMM over all of F. Both are
// one persistent warp-specialised GEMM:
// - Work list. An output tile is (expert, column panel, 128-row m-tile),
//   only for m-tiles that hold rows: expert e has ceil(rows_e / 128)
//   m-tiles, so an expert with no rows (empty, or not resident: the caller
//   sets its count to 0) reads neither x nor its weights. The list runs
//   expert by expert, panel by panel, m-tile fastest, so the m-tiles of one
//   weight panel run side by side and share it through L2. Each block
//   walks tiles blockIdx.x, + gridDim.x, ... with a cursor over the counts
//   (`TileWalker`, twinned in Python by `kernels/ref.py::ffn_block_tiles`);
//   the grid is min(SMs, an upper bound on the tiles), so no host read of
//   the counts is needed.
// - Loads. One producer warp (one thread) issues TMA copies of 64 x 64
//   bf16 boxes with 128-byte swizzle into a 6-stage ring of 32 KB stages in
//   dynamic shared memory: the tile's A rows (two boxes of 64 rows; the
//   second only where it holds rows) and two B boxes (gate and up panels,
//   or two adjacent down panels). The weights are 3-D tensor maps (S, K, N),
//   so the slot chase is the TMA's third coordinate: no gathered copy.
//   Full/empty mbarriers hand stages between producer and consumers.
// - Compute. Two consumer warpgroups, 64 rows each, run
//   wgmma.mma_async.m64n64k16 (bf16 x bf16 -> fp32) on each stage: A is
//   K-major, B is read N-major (the weights' own (K, N) layout, through the
//   transpose bit of the B descriptor). A warpgroup whose 64 rows hold no
//   tokens skips its products.
// - Epilogue. Straight from the accumulators to global memory, rows past
//   rows_e and columns past N masked; GATED writes bf16(silu(g) * u).
// - Ragged shapes. TMA zero-fills every box element outside the tensor, so
//   D, F need only be multiples of 8 (16-byte strides), C is any size, and
//   the K tail adds zeros.
// No atomics and no split-K: every output element is summed by one thread
// in one fixed order, deterministic from run to run, and a row's value
// depends neither on the other rows of its tile nor on the slot table, so
// both entry points give the same bits for the same weights.
//
// MOE (`fused_moe_entry.cu`'s two expert passes): the rows are the decode
// tokens' assignments grouped by expert, expert e's at rows [start[e],
// start[e] + counts[e]) of one (rows, K) buffer, counts 0 for an expert
// that is not routed or not resident; the epilogues round where that
// kernel does (g, u, silu(g), h and part to bf16), and the down pass writes
// part (fp32 values of bf16 numbers) and then, in the block that finishes
// a 128-column panel's last tile (a counter per panel, not a sum), adds
// gate * part over each token's experts in ascending id (`moe_combine`).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"  // bf16, opt_in_smem

namespace {

constexpr int BM = 128;               // rows per tile: 2 warpgroups x 64
constexpr int BK = 64;                // reduction depth per stage
constexpr int PANEL = 64;             // columns per B box
constexpr int STAGES = 6;
constexpr int CONSUMERS = 2;          // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
constexpr int BOX_BYTES = 64 * 64 * 2;          // one 64 x 64 bf16 box
constexpr int STAGE_BYTES = 4 * BOX_BYTES;      // A lo, A hi, B0, B1
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + 1 KB alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Spins until the phase of parity `parity` has completed. A pipeline wait
// lasts microseconds; one that never completes traps (a launch error the
// wrapper reports) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One 64 x 64 box of a 3-D tensor map into shared memory; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A box: 64 rows x 64 k (128 bytes a row), K-major; 8-row groups 1 KB
// apart. A k16 step is +32 bytes inside the swizzled row.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}

// B box: 64 k-rows x 64 n (128 bytes a row), N-major; 8-k-row groups 1 KB
// apart (the box is one swizzle atom wide in N, so the N-repeat offset is
// never used). A k16 step is +2 KB.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return smem_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64 fp32, 32 registers a thread) += A (64 x 16, K-major) @
// B (16 x 64, N-major)
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Cursor over the tile list (expert, panel, m-tile), experts in order, m
// fastest. `next` takes non-decreasing tile indices.
struct TileWalker {
  const int* counts;
  int E, C, n_panels;
  int e, start, tiles, m_tiles, rows;

  __device__ void load() {
    int r = counts ? counts[e] : C;
    rows = r < 0 ? 0 : (r > C ? C : r);
    m_tiles = (rows + BM - 1) / BM;
    tiles = m_tiles * n_panels;
  }
  __device__ void init(const int* c, int E_, int C_, int np) {
    counts = c;
    E = E_;
    C = C_;
    n_panels = np;
    e = 0;
    start = 0;
    load();
  }
  // false once t is past the last tile
  __device__ bool next(int t, int& panel, int& m0) {
    while (t >= start + tiles) {
      start += tiles;
      if (++e >= E) return false;
      load();
    }
    const int local = t - start;
    panel = local / m_tiles;
    m0 = (local - panel * m_tiles) * BM;
    return true;
  }
};

// The MOE passes' extra operands (all from `fused_moe_entry`'s route).
struct MoeArgs {
  const int* start;       // (E,) expert e's first row
  const int* tiles;       // tiles a down panel has (all its experts' m-tiles)
  int* counters;          // (down panels,) tiles finished, zeroed by route
  const float* gates;     // (T k,) gate of each assignment
  const int* order;       // (T, k) each token's assignments, ascending id
  const int* grow;        // (T k,) an assignment's row, -1 if not resident
  float* y;               // (T, N) output
  int T, k;
};

// y[t, n0:n1] = sum over t's assignments in ascending expert id of
// gate * part[row] (no fused multiply-add), by `threads` threads; part is
// read through L2 (other blocks wrote it).
__device__ inline void moe_combine(const MoeArgs& m, const float* part,
                                   int N, int n0, int n1, int tid,
                                   int threads) {
  const int w = n1 - n0;
  for (int i = tid; i < m.T * w; i += threads) {
    const int t = i / w;
    const int col = n0 + i - t * w;
    float acc = 0.f;
    for (int r = 0; r < m.k; ++r) {
      const int a = t * m.k + m.order[t * m.k + r];
      const int row = m.grow[a];
      if (row >= 0)
        acc = __fadd_rn(acc, __fmul_rn(m.gates[a],
                                       __ldcg(part + static_cast<int64_t>(
                                                         row) * N + col)));
    }
    m.y[static_cast<int64_t>(t) * N + col] = acc;
  }
}

// MOE down pass, once per finished tile: counts the tile into its panel's
// counter and, in the block that brings it to the panel's total, combines
// that panel. `sync` is a barrier of the `threads` calling threads.
template <typename Sync>
__device__ inline void moe_tile_done(const MoeArgs& m, const float* part,
                                     int N, int panel, int n0, int n1,
                                     int tid, int threads, int* flag,
                                     Sync sync) {
  __threadfence();                         // this thread's part is out
  sync();
  if (tid == 0) *flag = atomicAdd(&m.counters[panel], 1) == *m.tiles - 1;
  sync();
  if (*flag) {
    __threadfence();
    moe_combine(m, part, N, n0, n1, tid, threads);
  }
}

// GATED: A = x (E, C, K=D), B0/B1 = gate/up (S, K, N=F) at the same panel;
// out = h, bf16 (E, C, F), one 64-column panel a tile.
// Otherwise: A = h (E, C, K=F), B0 = B1 = down (S, K, N=D) at two adjacent
// panels; out fp32 (E, C, D), 128 columns a tile.
// MOE: A and out are (rows, K) / (rows, N), expert e's rows from
// moe.start[e] (see the note above).
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

template <bool GATED, bool MOE = false>
__global__ void __launch_bounds__(THREADS, 1)
    swiglu_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b0,
                       const __grid_constant__ CUtensorMap tm_b1,
                       const int* __restrict__ slot_of_expert,
                       const int* __restrict__ counts, int n_slots,
                       void* __restrict__ out, int E, int C, int N, int K,
                       MoeArgs moe) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ int combine_flag;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  constexpr int TILE_N = GATED ? PANEL : 2 * PANEL;
  const int n_panels = (N + TILE_N - 1) / TILE_N;
  const int n_k = (K + BK - 1) / BK;
  if constexpr (MOE && !GATED) {
    if (*moe.tiles == 0) {                 // nothing routed is resident
      for (int64_t i = blockIdx.x * THREADS + threadIdx.x;
           i < static_cast<int64_t>(moe.T) * N; i += gridDim.x * THREADS)
        moe.y[i] = 0.f;
      return;
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  TileWalker walk;
  walk.init(counts, E, C, n_panels);
  const int wg = threadIdx.x / 128;

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every TMA copy ----
    if (threadIdx.x % 32 != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    int panel, m0;
    for (int t = blockIdx.x; walk.next(t, panel, m0); t += gridDim.x) {
      int slot = slot_of_expert ? slot_of_expert[walk.e] : walk.e;
      slot = slot < 0 ? 0 : (slot >= n_slots ? n_slots - 1 : slot);
      const int n0 = panel * TILE_N;
      const int n1 = GATED ? n0 : n0 + PANEL;
      const bool a_hi = m0 + 64 < walk.rows;
      const bool b_hi = GATED || n1 < N;
      const uint32_t bytes = BOX_BYTES * (2 + (a_hi ? 1 : 0) + (b_hi ? 1 : 0));
      for (int kb = 0; kb < n_k; ++kb) {
        const uint32_t full = smem_u32(&full_bar[stage]);
        mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
        mbar_expect_tx(full, bytes);
        const uint32_t st = base + stage * STAGE_BYTES;
        const int k0 = kb * BK;
        const int a_row = MOE ? moe.start[walk.e] + m0 : m0;
        const int a_mat = MOE ? 0 : walk.e;
        tma_load_3d(st, &tm_a, full, k0, a_row, a_mat);
        if (a_hi)
          tma_load_3d(st + BOX_BYTES, &tm_a, full, k0, a_row + 64, a_mat);
        tma_load_3d(st + 2 * BOX_BYTES, &tm_b0, full, n0, k0, slot);
        if (b_hi) tma_load_3d(st + 3 * BOX_BYTES, &tm_b1, full, n1, k0, slot);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg computes rows m0 + 64 wg .. + 63 ----
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  int stage = 0;
  uint32_t phase = 0;
  int panel, m0;
  for (int t = blockIdx.x; walk.next(t, panel, m0); t += gridDim.x) {
    const int n0 = panel * TILE_N;
    const int n1 = GATED ? n0 : n0 + PANEL;
    const bool active = m0 + 64 * wg < walk.rows;
    const bool b_hi = GATED || n1 < N;
    float acc[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
    for (int kb = 0; kb < n_k; ++kb) {
      mbar_wait(smem_u32(&full_bar[stage]), phase);
      if (active) {
        const uint32_t st = base + stage * STAGE_BYTES;
        const uint64_t da = desc_a(st + wg * BOX_BYTES);
        const uint64_t db0 = desc_b(st + 2 * BOX_BYTES);
        const uint64_t db1 = desc_b(st + 3 * BOX_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // +32 bytes along K in A, +16 k-rows (2 KB) in B
          wgmma_64x64x16(acc[0], da + 2 * kk, db0 + 128 * kk);
          if (b_hi) wgmma_64x64x16(acc[1], da + 2 * kk, db1 + 128 * kk);
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (active) {
      // accumulator layout: register 4j + 2h + i holds row 16 warp +
      // lane/4 + 8h, column 8j + 2 (lane % 4) + i
      const int64_t row0 = m0 + 64 * wg + 16 * warp + lane / 4;
      const int64_t first =
          MOE ? moe.start[walk.e] : static_cast<int64_t>(walk.e) * C;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = row0 + 8 * h;
          if (row >= walk.rows) continue;
          const int64_t off = (first + row) * N;
          if constexpr (GATED) {
            if (n0 + col >= N) continue;
            const int r = 4 * j + 2 * h;
            float g0 = acc[0][r], g1 = acc[0][r + 1];
            float u0 = acc[1][r], u1 = acc[1][r + 1];
            __nv_bfloat162 hv;
            if constexpr (MOE) {
              // fused_moe_entry's rounding points: g, u, silu(g), h
              g0 = bf16_round(g0);
              g1 = bf16_round(g1);
              u0 = bf16_round(u0);
              u1 = bf16_round(u1);
              hv.x = __float2bfloat16(
                  __fmul_rn(bf16_round(g0 / (1.0f + expf(-g0))), u0));
              hv.y = __float2bfloat16(
                  __fmul_rn(bf16_round(g1 / (1.0f + expf(-g1))), u1));
            } else {
              hv.x = __float2bfloat16(g0 / (1.0f + expf(-g0)) * u0);
              hv.y = __float2bfloat16(g1 / (1.0f + expf(-g1)) * u1);
            }
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                               off + n0 + col) = hv;
          } else {
            float* o = static_cast<float*>(out) + off;
            const int r = 4 * j + 2 * h;
            float2 v0 = make_float2(acc[0][r], acc[0][r + 1]);
            float2 v1 = make_float2(acc[1][r], acc[1][r + 1]);
            if constexpr (MOE) {              // part rounds to bf16
              v0 = make_float2(bf16_round(v0.x), bf16_round(v0.y));
              v1 = make_float2(bf16_round(v1.x), bf16_round(v1.y));
            }
            if (n0 + col < N) *reinterpret_cast<float2*>(o + n0 + col) = v0;
            if (b_hi && n1 + col < N)
              *reinterpret_cast<float2*>(o + n1 + col) = v1;
          }
        }
      }
    }
    if constexpr (MOE && !GATED)
      moe_tile_done(moe, static_cast<const float*>(out), N, panel, n0,
                    min(n0 + TILE_N, N), threadIdx.x, CONSUMERS * 128,
                    &combine_flag, consumers_sync);
  }
}

// ---- host side ----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so the
// library needs no -lcuda link.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A contiguous bf16 (d2, d1, d0) tensor as a 3-D map of 64 x 64 x 1 boxes
// with 128-byte swizzle; elements outside the tensor read as zero.
inline bool encode_3d(CUtensorMap* map, const void* ptr, int64_t d0,
                      int64_t d1, int64_t d2) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0 * 2),
                                 static_cast<cuuint64_t>(d0 * d1 * 2)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int grid_for(int dev, int E, int C, int n_panels) {
  int sms = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 1;
  const int64_t upper =
      static_cast<int64_t>(E) * ((C + BM - 1) / BM) * n_panels;
  return static_cast<int>(upper < sms ? upper : sms);
}

// The two launches of the SwiGLU FFN on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue if a tensor map cannot be
// encoded. `slot_of_expert` and `counts` may be null (weights indexed by
// expert; every row computed); `h` is the bf16 (E, C, F) scratch, `out`
// the fp32 (E, C, D).
inline int swiglu_ffn_launch(const void* x, const int* slot_of_expert,
                             const int* counts, const void* w_gate,
                             const void* w_up, const void* w_down, void* h,
                             void* out, int E, int C, int D, int F, int S,
                             void* stream) {
  CUtensorMap tx, tg, tu, th, td;
  if (!encode_3d(&tx, x, D, C, E) || !encode_3d(&tg, w_gate, F, D, S) ||
      !encode_3d(&tu, w_up, F, D, S) || !encode_3d(&th, h, F, C, E) ||
      !encode_3d(&td, w_down, D, F, S))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = opt_in_smem(swiglu_gemm_kernel<true>, SMEM_BYTES)) !=
          cudaSuccess ||
      (err = opt_in_smem(swiglu_gemm_kernel<false>, SMEM_BYTES)) !=
          cudaSuccess)
    return static_cast<int>(err);
  int dev = 0;
  cudaGetDevice(&dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // (1) h = bf16(silu(x @ Wg) * (x @ Wu)): N = F, K = D
  swiglu_gemm_kernel<true><<<grid_for(dev, E, C, (F + PANEL - 1) / PANEL),
                             THREADS, SMEM_BYTES, st>>>(
      tx, tg, tu, slot_of_expert, counts, S, h, E, C, F, D, MoeArgs{});
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // (2) out = h @ Wd: N = D, K = F
  swiglu_gemm_kernel<false>
      <<<grid_for(dev, E, C, (D + 2 * PANEL - 1) / (2 * PANEL)), THREADS,
         SMEM_BYTES, st>>>(th, td, td, slot_of_expert, counts, S, out, E, C,
                           D, F, MoeArgs{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
