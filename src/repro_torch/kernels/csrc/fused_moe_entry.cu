// Decode MoE entry for Hopper (sm_90a): route, top-k, slot lookup and the
// gate-weighted expert SwiGLU, bf16 or f32 tokens and weights, fp32 output.
//
// Replaces the TPU kernel
// `repro/kernels/decode_superkernel.py::fused_moe_entry`
// (`_fused_moe_kernel`, pallas_call at decode_superkernel.py:141). For
// tokens x (T, d) of type X (bf16 or f32), router (d, E) fp32, bias (E,)
// fp32, slot table (E,) int32 (-1 = not resident) and slot buffers
// Wg, Wu (S, d, f), Wd (S, f, d) of type X:
//     probs = softmax(x @ router + bias)                        (fp32)
//     ids, gates = first-max top-k of probs (ties to the lowest id),
//                  renormalised over k when asked, zeroed where slot < 0
//     g = X(x @ Wg[slot]), u = X(x @ Wu[slot])                  (fp32 sums)
//     h = X(X(silu(g)) * u)
//     part = X(h @ Wd[slot])
//     y[t] = sum over t's resident experts in ascending id of gate * part
// X(.) rounds to the input type: the TPU kernel's dots of bf16 operands
// return bf16, and nothing rounds in f32. Its expert grid adds each
// expert's gate * part into y in expert order.
//
// What bounds it. Decode has a few rows per expert, so the work is the
// weight bytes of the distinct routed, resident experts, not the FLOPs: at
// olmoe-1b-7b decode (T = 4, d = 2048, f = 1024, k = 8) about 28 experts x
// 12.6 MB, ~0.1 ms at 3.35 TB/s (H100 SXM).
//
// Design: three launches on one stream, no atomics in any sum.
// 1. route: one cluster of 8 blocks. Block r reads rows [r d/8, (r+1) d/8)
//    of the router once per tile of 8 tokens, as 16-byte vectors, and sums
//    its slice of every token's logits in a fixed order; block 0 adds the
//    8 slices in rank order through distributed shared memory. One warp per
//    token then runs softmax, k warp arg-max passes on (value desc, index
//    asc), the renormalisation in rank order and the dead-sentinel rule,
//    all in registers. Last, block 0 builds the work list on the device
//    (`Work`): each expert's rows (its routed assignments if resident, else
//    none) grouped by expert in ascending id, each expert's assignments
//    ascending; the cluster then copies the grouped token rows into one
//    buffer. No later block rescans the ids.
// 2. gate/up and 3. down + combine: the SwiGLU GEMM that `slot_ffn` runs
//    (`swiglu_gemm.cuh`: persistent, one block per SM walking (expert,
//    column panel, 128-row tile) items over the per-expert row counts, a
//    TMA ring of 128-byte-swizzled boxes with the slot as a tensor-map
//    coordinate, wgmma on two warpgroups; f32 takes `swiglu_f32.cuh`, the
//    same walk as 3xTF32 over a cp.async ring), in its MOE form: rows
//    grouped by expert, fused_moe_entry's rounding points in the epilogues,
//    and the combine folded into the down pass. An expert with up to 128
//    rows multiplies each weight panel once, whatever its row count; an
//    unrouted or absent expert has no rows, so no item, and costs nothing;
//    the grid never depends on the routing. The block that finishes a
//    128-column panel's last down tile (a counter per panel) adds
//    gate * part over each token's experts in ascending id, with no fused
//    multiply-add. So every y element is summed by one thread in one order
//    that depends neither on S nor on which slot holds an expert: the slot
//    path and a fully-resident run give the same bits.
// Why not a kernel of its own for 2 and 3: a design that streamed each
// expert's slab as 32-byte-wide column strips (so that a whole strip stays
// in shared memory for every row of the expert) and multiplied on the CUDA
// cores moved only ~15-20 GB/s per SM on an H100, with TMA or cp.async
// alike, and was compute-bound at 8 rows an expert (see PERF.md).
//
// C interface (ctypes): fused_moe_entry_launch returns cudaGetLastError()
// after enqueueing the three launches on `stream` (cudaErrorInvalidValue
// for shapes it does not take or a tensor map it cannot encode). It
// allocates nothing: the caller passes the outputs and
// fused_moe_entry_scratch_bytes() of scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "swiglu_f32.cuh"   // the expert passes (and swiglu_gemm.cuh)

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;       // top-k masking, as the reference
constexpr int MAX_E = 256;
constexpr int MAX_K = 16;
constexpr int MAX_T = 1024;         // tokens per call (a decode batch)
constexpr int SMEM_MAX = 232448;    // shared memory a block may use

// ---- 1. route ----------------------------------------------------------
constexpr int ROUTE_CLUSTER = 8;    // blocks, each a slice of d
constexpr int ROUTE_THREADS = 256;
constexpr int TT = ROUTE_THREADS / 32;   // tokens a tile: one warp each

// The work list (int32), built by the route launch:
//   counts[E]   rows of expert e: its routed assignments if it is resident,
//               else 0 (the expert passes skip it)
//   start[E]    expert e's first row in the grouped buffers
//   rows[T k]   grouped row -> assignment t * k + j (experts in ascending
//               id, each one's assignments ascending)
//   grow[T k]   assignment -> grouped row, -1 if its expert is absent
//   order[T k]  per token, its assignments j in ascending expert id
//   tiles       the down pass's tiles per 128-column panel
//   counters[]  per panel, the down tiles finished (zeroed here)
struct Work {
  int E, n;                                  // n = T k
  __host__ __device__ int counts() const { return 0; }
  __host__ __device__ int start() const { return E; }
  __host__ __device__ int rows() const { return 2 * E; }
  __host__ __device__ int grow() const { return 2 * E + n; }
  __host__ __device__ int order() const { return 2 * E + 2 * n; }
  __host__ __device__ int tiles() const { return 2 * E + 3 * n; }
  __host__ __device__ int counters() const { return 2 * E + 3 * n + 1; }
  __host__ __device__ int size(int panels) const {
    return counters() + panels;
  }
};

inline size_t route_smem(int T, int d, int E, int k) {
  return (static_cast<size_t>(TT) * (d / ROUTE_CLUSTER)   // x slice
          + 1024 * TT                                     // slice partials
          + TT * E) * 4                                   // block logits
         + static_cast<size_t>(T) * k * 4 + E * 4;        // ids, counts
}

template <typename X>
__global__ void __cluster_dims__(ROUTE_CLUSTER, 1, 1)
    __launch_bounds__(ROUTE_THREADS)
    route_kernel(const X* __restrict__ x, const float* __restrict__ rw,
                 const float* __restrict__ bias,
                 const int* __restrict__ slot_of_expert, int n_slots,
                 float* __restrict__ gates, int* __restrict__ ids,
                 int* __restrict__ work, X* __restrict__ x_rows, int T,
                 int d, int E, int k, int norm, int panels) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int SL = d / ROUTE_CLUSTER;          // router rows of this block
  const int r0 = rank * SL;
  const int TPR = E / 4;                     // threads a router row
  const int RG = ROUTE_THREADS / TPR;        // rows in parallel
  const int q = tid % TPR;
  const int rg = tid / TPR;
  extern __shared__ __align__(16) float rsm[];
  float* xs = rsm;                           // [TT][SL]
  float* red = xs + TT * SL;                 // [RG][TT][E]; logits [TT][E]
  float* part = red + 1024 * TT;             // [TT][E]
  int* ids_s = reinterpret_cast<int*>(part + TT * E);   // [T k]
  int* cnt_s = ids_s + T * k;                           // [E]

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int nt = min(TT, T - t0);
    for (int i = tid; i < TT * SL; i += ROUTE_THREADS) {
      const int tt = i / SL;
      const int c = i - tt * SL;
      xs[i] = tt < nt ? to_f(x[static_cast<int64_t>(t0 + tt) * d + r0 + c])
                      : 0.f;
    }
    __syncthreads();
    // this slice's logits: 16-byte router loads, one quad of experts a
    // thread, rows rg, rg + RG, ... in order
    if (rg < RG) {
      float acc[TT][4];
#pragma unroll
      for (int tt = 0; tt < TT; ++tt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[tt][j] = 0.f;
      constexpr int U = 8;                   // router loads in flight
      for (int i0 = rg; i0 < SL; i0 += RG * U) {
        float4 w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * RG;
          w[u] = i < SL ? *reinterpret_cast<const float4*>(
                              rw + static_cast<int64_t>(r0 + i) * E + 4 * q)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * RG;
          if (i >= SL) break;
#pragma unroll
          for (int tt = 0; tt < TT; ++tt) {
            const float a = xs[tt * SL + i];
            acc[tt][0] += a * w[u].x;
            acc[tt][1] += a * w[u].y;
            acc[tt][2] += a * w[u].z;
            acc[tt][3] += a * w[u].w;
          }
        }
      }
#pragma unroll
      for (int tt = 0; tt < TT; ++tt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[(rg * TT + tt) * E + 4 * q + j] = acc[tt][j];
    }
    __syncthreads();
    for (int i = tid; i < TT * E; i += ROUTE_THREADS) {
      float s = 0.f;
      for (int g = 0; g < RG; ++g) s += red[g * TT * E + i];
      part[i] = s;
    }
    cluster.sync();                          // every slice is in
    if (rank == 0) {
      for (int i = tid; i < TT * E; i += ROUTE_THREADS) {
        float s = 0.f;
        for (int r = 0; r < ROUTE_CLUSTER; ++r)
          s += cluster.map_shared_rank(part, r)[i];
        red[i] = s + bias[i % E];            // logits [TT][E]
      }
    }
    cluster.sync();                          // the slices may be reused
    if (rank != 0) continue;
    if (warp < nt) {
      // softmax and top-k of token t0 + warp; lane holds experts lane + 32 j
      const float* lg = red + warp * E;
      constexpr int PL = MAX_E / 32;
      float p[PL];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < PL; ++j) {
        const int e = lane + 32 * j;
        p[j] = e < E ? lg[e] : -INFINITY;
        mx = fmaxf(mx, p[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < PL; ++j) {
        p[j] = lane + 32 * j < E ? expf(p[j] - mx) : 0.f;
        sum += p[j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
      for (int j = 0; j < PL; ++j)
        p[j] = lane + 32 * j < E ? p[j] / sum : NEG;
      int my_sel = 0;
      float my_val = 0.f;
      float total = 0.f;
      for (int r = 0; r < k; ++r) {
        float bv = p[0];
        int bi = lane;
#pragma unroll
        for (int j = 1; j < PL; ++j)
          if (p[j] > bv) {                   // strict: the lower id wins
            bv = p[j];
            bi = lane + 32 * j;
          }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
        total += bv;
        if (lane == r) {
          my_sel = bi;
          my_val = bv;
        }
#pragma unroll
        for (int j = 0; j < PL; ++j)
          if (lane + 32 * j == bi) p[j] = NEG;
      }
      // the token's ids are distinct: my_sel's rank among them
      int rank_id = 0;
      for (int i = 0; i < k; ++i)
        rank_id += __shfl_sync(0xffffffffu, my_sel, i) < my_sel;
      if (lane < k) {
        const int slot = slot_of_expert[my_sel];
        float g = norm ? my_val / fmaxf(total, 1e-9f) : my_val;
        if (slot < 0 || slot >= n_slots) g = 0.f;   // dead-sentinel rule
        const int a = (t0 + warp) * k + lane;
        gates[a] = g;
        ids[a] = my_sel;
        ids_s[a] = my_sel;
        work[Work{E, T * k}.order() + (t0 + warp) * k + rank_id] = lane;
      }
    }
  }
  // ---- the work list: routed, resident experts in ascending id ----------
  const int n = T * k;
  const Work W{E, n};
  int* counts = work + W.counts();
  int* start = work + W.start();
  int* rows = work + W.rows();
  int* grow = work + W.grow();
  if (rank == 0) {
    __syncthreads();
    for (int e = warp; e < E; e += TT) {
      const int slot = slot_of_expert[e];
      int c = 0;
      if (slot >= 0 && slot < n_slots)
        for (int i0 = 0; i0 < n; i0 += 32) {
          const int i = i0 + lane;
          c += __popc(__ballot_sync(0xffffffffu, i < n && ids_s[i] == e));
        }
      if (lane == 0) cnt_s[e] = c;
    }
    for (int i = tid; i < n; i += ROUTE_THREADS) grow[i] = -1;
    for (int i = tid; i < panels; i += ROUTE_THREADS)
      work[W.counters() + i] = 0;
    __syncthreads();
    if (tid == 0) {
      int at = 0, tiles = 0;
      for (int e = 0; e < E; ++e) {
        const int c = cnt_s[e];
        counts[e] = c;
        start[e] = at;
        cnt_s[e] = at;                       // now each expert's first row
        at += c;
        tiles += (c + BM - 1) / BM;
      }
      work[W.tiles()] = tiles;
    }
    __syncthreads();
    for (int e = warp; e < E; e += TT) {
      const int slot = slot_of_expert[e];
      if (slot < 0 || slot >= n_slots) continue;
      int at = cnt_s[e];
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        const bool hit = i < n && ids_s[i] == e;
        const unsigned b = __ballot_sync(0xffffffffu, hit);
        if (hit) {
          const int row = at + __popc(b & ((1u << lane) - 1u));
          rows[row] = i;
          grow[i] = row;
        }
        at += __popc(b);
      }
    }
    __threadfence();
  }
  cluster.sync();                            // the list is out
  // the grouped token rows the gate/up pass multiplies, x[rows[g] / k],
  // copied by the whole cluster
  const int total = start[E - 1] + counts[E - 1];
  const int dv = d * static_cast<int>(sizeof(X)) / 16;
  for (int i = rank * ROUTE_THREADS + tid; i < total * dv;
       i += ROUTE_CLUSTER * ROUTE_THREADS) {
    const int g = i / dv;
    const int a = rows[g];
    const int v = i - g * dv;
    reinterpret_cast<uint4*>(x_rows)[static_cast<int64_t>(g) * dv + v] =
        reinterpret_cast<const uint4*>(x)[static_cast<int64_t>(a / k) * dv +
                                          v];
  }
}

// Byte offsets of the scratch the caller allocates: the work list, the
// grouped token rows (n, d) and h (n, f) of type X, and part (n, d) fp32.
struct Scratch {
  size_t work, x_rows, h, part, total;
  Scratch(int T, int d, int E, int k, int f, int isz) {
    const size_t n = static_cast<size_t>(T) * k;
    auto up = [](size_t b) { return (b + 1023) & ~size_t(1023); };
    work = 0;
    x_rows = up(static_cast<size_t>(Work{E, static_cast<int>(n)}.size(
                    (d + 2 * PANEL - 1) / (2 * PANEL))) * 4);
    h = x_rows + up(n * d * isz);
    part = h + up(n * f * isz);
    total = part + up(n * d * 4);
  }
};

template <typename X>
int launch(const void* x, const void* router_w, const void* logit_bias,
           const void* slot_of_expert, const void* s_gate, const void* s_up,
           const void* s_down, void* gates, void* ids, void* scratch, void* y,
           int T, int d, int E, int k, int f, int S, int norm,
           cudaStream_t st) {
  const int n = T * k;
  const int panels = (d + 2 * PANEL - 1) / (2 * PANEL);   // down panels
  const Scratch sc(T, d, E, k, f, sizeof(X));
  uint8_t* base = static_cast<uint8_t*>(scratch);
  int* work = reinterpret_cast<int*>(base + sc.work);
  X* x_rows = reinterpret_cast<X*>(base + sc.x_rows);
  X* h = reinterpret_cast<X*>(base + sc.h);
  float* part = reinterpret_cast<float*>(base + sc.part);
  const Work W{E, n};
  const int* soe = static_cast<const int*>(slot_of_expert);
  const MoeArgs moe{work + W.start(), work + W.tiles(),
                    work + W.counters(), static_cast<const float*>(gates),
                    work + W.order(), work + W.grow(), static_cast<float*>(y),
                    T, k};
  const size_t rs = route_smem(T, d, E, k);
  if (rs > SMEM_MAX - 2048) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = opt_in_smem(route_kernel<X>, SMEM_MAX - 2048)) != cudaSuccess)
    return static_cast<int>(err);
  int dev = 0;
  cudaGetDevice(&dev);
  route_kernel<X><<<ROUTE_CLUSTER, ROUTE_THREADS, rs, st>>>(
      static_cast<const X*>(x), static_cast<const float*>(router_w),
      static_cast<const float*>(logit_bias), soe, S,
      static_cast<float*>(gates), static_cast<int*>(ids), work, x_rows, T, d,
      E, k, norm, panels);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int* counts = work + W.counts();
  const int grid_g = grid_for(dev, E, T, (f + PANEL - 1) / PANEL);
  const int grid_d = grid_for(dev, E, T, panels);
  if constexpr (sizeof(X) == 2) {
    // the TMA + wgmma GEMM: rows grouped by expert, T rows an expert at most
    if ((err = opt_in_smem(swiglu_gemm_kernel<true, true>, SMEM_BYTES)) !=
            cudaSuccess ||
        (err = opt_in_smem(swiglu_gemm_kernel<false, true>, SMEM_BYTES)) !=
            cudaSuccess)
      return static_cast<int>(err);
    CUtensorMap tx, tg, tu, th, td;
    if (!encode_3d(&tx, x_rows, d, n, 1) || !encode_3d(&tg, s_gate, f, d, S) ||
        !encode_3d(&tu, s_up, f, d, S) || !encode_3d(&th, h, f, n, 1) ||
        !encode_3d(&td, s_down, d, f, S))
      return static_cast<int>(cudaErrorInvalidValue);
    swiglu_gemm_kernel<true, true><<<grid_g, THREADS, SMEM_BYTES, st>>>(
        tx, tg, tu, soe, counts, S, h, E, T, f, d, moe);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    swiglu_gemm_kernel<false, true><<<grid_d, THREADS, SMEM_BYTES, st>>>(
        th, td, td, soe, counts, S, part, E, T, d, f, moe);
  } else {
    // f32: the 3xTF32 GEMM over the same tiles
    if ((err = f32_pass<true, true>(
             grid_g, st, reinterpret_cast<const float*>(x_rows),
             static_cast<const float*>(s_gate),
             static_cast<const float*>(s_up), soe, counts, S,
             reinterpret_cast<float*>(h), E, T, f, d, moe)) != cudaSuccess)
      return static_cast<int>(err);
    return static_cast<int>(f32_pass<false, true>(
        grid_d, st, reinterpret_cast<const float*>(h),
        static_cast<const float*>(s_down), nullptr, soe, counts, S, part, E,
        T, d, f, moe));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch fused_moe_entry_launch needs.
extern "C" int fused_moe_entry_scratch_bytes(int T, int d, int E, int k,
                                             int f, int f32) {
  return static_cast<int>(Scratch(T, d, E, k, f, f32 ? 4 : 2).total);
}

// f32: 1 for float tokens and slot buffers, 0 for bf16.
extern "C" int fused_moe_entry_launch(
    const void* x, const void* router_w, const void* logit_bias,
    const void* slot_of_expert, const void* s_gate, const void* s_up,
    const void* s_down, void* gates, void* ids, void* scratch, void* y,
    int T, int d, int E, int k, int f, int S, int norm, int f32,
    void* stream) {
  if (T < 1 || T > MAX_T || E < 4 || E > MAX_E || E % 4 || k < 1 ||
      k > MAX_K || k > E || d % 8 || f % 8 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(x, router_w, logit_bias, slot_of_expert, s_gate,
                             s_up, s_down, gates, ids, scratch, y, T, d, E, k,
                             f, S, norm, st)
             : launch<bf16>(x, router_w, logit_bias, slot_of_expert, s_gate,
                            s_up, s_down, gates, ids, scratch, y, T, d, E, k,
                            f, S, norm, st);
}
