// Decode MoE entry for Hopper (sm_90a): route, top-k, slot lookup and the
// gate-weighted expert SwiGLU, bf16 weights, fp32 output.
//
// Replaces the TPU kernel
// `repro/kernels/decode_superkernel.py::fused_moe_entry`
// (`_fused_moe_kernel`, pallas_call at decode_superkernel.py:141). For
// tokens x (T, d), router (d, E) fp32, bias (E,) fp32, slot table (E,)
// int32 (-1 = not resident) and slot buffers Wg, Wu (S, d, f), Wd (S, f, d):
//     probs = softmax(x @ router + bias)                        (fp32)
//     ids, gates = first-max top-k of probs (ties to the lowest id),
//                  renormalised over k when asked, zeroed where slot < 0
//     g = bf16(x @ Wg[slot]), u = bf16(x @ Wu[slot])            (fp32 sums)
//     h = bf16(bf16(silu(g)) * u)
//     part = bf16(h @ Wd[slot])
//     y[t] = sum over t's resident experts in ascending id of gate * part
// The rounding points are the TPU kernel's: its dots of bf16 operands
// return bf16, and its expert grid adds each expert's gate * part into y
// in expert order.
//
// Design.
// - The TPU grid walks all E experts, reads every expert's weights
//   (through slot 0 for absent ones) and multiplies every token by every
//   expert, with a zero gate for the unrouted pairs. On the card only the
//   (token, expert) pairs that are routed AND resident need work: an
//   unrouted or absent pair's gate is exactly 0. Four launches on one
//   stream, no atomics:
//   1. route: one block per token; fp32 logits (d split over the threads,
//      partial sums combined in a fixed order), then softmax, k first-max
//      passes, renormalisation and the sentinel rule on one thread. Writes
//      gates / ids and each token's k assignments in ascending expert id.
//   2. gate / up: one block per (expert, 128 columns of f). The block finds
//      the tokens routed to its expert; if there are none, or the expert is
//      not resident, it exits before any weight is loaded. Weight rows are
//      read once per block as 16-byte vectors and multiplied into up to 4
//      tokens at a time on the CUDA cores (decode has few tokens per
//      expert: the work is the weight bytes, not the FLOPs). The SwiGLU
//      epilogue writes h (T * k, f) in bf16.
//   3. down: the same kernel over Wd, writing part (T * k, d) in bf16.
//   4. combine: one thread per (token, column) sums gate * part over the
//      token's resident experts in ascending id, in fp32, with no fused
//      multiply-add (the plain version rounds the product and the sum).
//   Every output element is summed by one thread in one fixed order, and
//   that order depends neither on S nor on which slot holds an expert, so
//   the slot path and a fully-resident run give the same bits.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), olmoe-1b-7b decode at
// batch 4 (T = 4, d = 2048, f = 1024, E = 64, k = 8): the bytes of the
// distinct routed, resident experts' weights, 12.6 MB each (about 28 of
// them, 352 MB), so about 0.105 ms; the FLOPs (2 * 3 * T * k * d * f =
// 0.4 GFLOP) are far below. The TPU kernel's all-experts read would be
// 805 MB.
//
// C interface (ctypes): fused_moe_entry_launch returns cudaGetLastError()
// after enqueueing the four launches on `stream`. It allocates nothing:
// the caller passes the scratch (order, h, part) and the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;       // top-k masking, as the reference
constexpr int ROUTE_THREADS = 256;
constexpr int MAX_E = 256;
constexpr int MAX_K = 16;
constexpr int MAX_T = 1024;         // tokens per call (a decode batch)

constexpr int GEMV_THREADS = 256;
constexpr int NT = 128;             // output columns per block
constexpr int CPT = 8;              // columns per thread (one 16-byte load)
constexpr int COL_GROUPS = NT / CPT;                 // 16
constexpr int ROW_GROUPS = GEMV_THREADS / COL_GROUPS;  // 16, 2 per warp
constexpr int WARPS = GEMV_THREADS / 32;
constexpr int MT = 4;               // tokens per pass
constexpr int KC = 1024;            // reduction chunk staged in shared memory

// ---- 1. route ----------------------------------------------------------
__global__ void __launch_bounds__(ROUTE_THREADS)
    route_kernel(const bf16* __restrict__ x, const float* __restrict__ rw,
                 const float* __restrict__ bias,
                 const int* __restrict__ slot_of_expert,
                 float* __restrict__ gates, int* __restrict__ ids,
                 int* __restrict__ order, int d, int E, int k, int norm) {
  __shared__ float part[ROUTE_THREADS];
  __shared__ float prob[MAX_E];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = ROUTE_THREADS / E;          // d split into P interleaved parts
  const bf16* xt = x + static_cast<int64_t>(t) * d;
  if (tid < P * E) {
    const int e = tid % E;
    const int s = tid / E;
    float acc = 0.f;
    for (int i = s; i < d; i += P)
      acc += __bfloat162float(xt[i]) * rw[static_cast<int64_t>(i) * E + e];
    part[tid] = acc;
  }
  __syncthreads();
  if (tid < E) {
    float acc = 0.f;
    for (int s = 0; s < P; ++s) acc += part[s * E + tid];
    prob[tid] = acc + bias[tid];
  }
  __syncthreads();
  if (tid != 0) return;
  float mx = prob[0];
  for (int e = 1; e < E; ++e) mx = fmaxf(mx, prob[e]);
  float sum = 0.f;
  for (int e = 0; e < E; ++e) {
    prob[e] = expf(prob[e] - mx);
    sum += prob[e];
  }
  for (int e = 0; e < E; ++e) prob[e] = prob[e] / sum;
  int sel[MAX_K];
  float val[MAX_K];
  float total = 0.f;
  for (int j = 0; j < k; ++j) {
    int best = 0;
    for (int e = 1; e < E; ++e)
      if (prob[e] > prob[best]) best = e;   // strict: first max wins
    sel[j] = best;
    val[j] = prob[best];
    total += prob[best];
    prob[best] = NEG;
  }
  const float denom = fmaxf(total, 1e-9f);
  for (int j = 0; j < k; ++j) {
    float g = norm ? val[j] / denom : val[j];
    if (slot_of_expert[sel[j]] < 0) g = 0.f;   // the dead-sentinel rule
    gates[t * k + j] = g;
    ids[t * k + j] = sel[j];
  }
  // assignment indices in ascending expert id (ids are distinct)
  for (int j = 0; j < k; ++j) {
    int rank = 0;
    for (int i = 0; i < k; ++i) rank += sel[i] < sel[j];
    order[t * k + rank] = j;
  }
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[CPT]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// ---- 2 / 3. per-expert rows x weights ---------------------------------
// out[p, n] for every assignment p = t * k + j routed to this block's expert
// (blockIdx.y), columns n in this block's tile. A row of p is A[p / k]
// (GATED: the token) or A[p] (the assignment's h row). GATED: two weight
// operands and the SwiGLU epilogue; otherwise one operand, bf16 output.
template <bool GATED>
__global__ void __launch_bounds__(GEMV_THREADS)
    expert_rows_kernel(const bf16* __restrict__ A,
                       const int* __restrict__ ids,
                       const int* __restrict__ slot_of_expert, int n_slots,
                       int T, int k, const bf16* __restrict__ W0,
                       const bf16* __restrict__ W1, bf16* __restrict__ out,
                       int K, int N) {
  constexpr int NB = GATED ? 2 : 1;
  __shared__ int rows[MAX_T];
  __shared__ int count;
  __shared__ __align__(16) bf16 As[MT][KC];
  __shared__ float red[NB][WARPS][MT][NT];

  const int e = blockIdx.y;
  const int n0 = blockIdx.x * NT;
  const int tid = threadIdx.x;
  const int slot = slot_of_expert[e];
  if (slot < 0 || slot >= n_slots) return;      // absent: no work
  if (tid == 0) {
    int c = 0;
    for (int p = 0; p < T * k; ++p)
      if (ids[p] == e) rows[c++] = p;
    count = c;
  }
  __syncthreads();
  const int M = count;
  if (M == 0) return;                            // not routed: no work

  const int cg = tid % COL_GROUPS;
  const int rg = tid / COL_GROUPS;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col = n0 + cg * CPT;
  const bool col_ok = col < N;
  const bf16* w[NB];
  w[0] = W0 + static_cast<int64_t>(slot) * K * N;
  if constexpr (GATED) w[NB - 1] = W1 + static_cast<int64_t>(slot) * K * N;

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mc = min(MT, M - m0);
    float acc[NB][MT][CPT];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[b][m][c] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      __syncthreads();                           // As is free again
      for (int i = tid; i < MT * kc; i += GEMV_THREADS) {
        const int m = i / kc;
        const int kk = i - m * kc;
        bf16 a = __float2bfloat16(0.f);
        if (m < mc) {
          const int p = rows[m0 + m];
          const int64_t r = GATED ? p / k : p;
          a = A[r * K + k0 + kk];
        }
        As[m][kk] = a;
      }
      __syncthreads();
      if (col_ok) {
#pragma unroll 4
        for (int kk = rg; kk < kc; kk += ROW_GROUPS) {
          const int64_t off = static_cast<int64_t>(k0 + kk) * N + col;
          float wf[NB][CPT];
#pragma unroll
          for (int b = 0; b < NB; ++b)
            unpack8(*reinterpret_cast<const uint4*>(w[b] + off), wf[b]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float a = __bfloat162float(As[m][kk]);
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
              for (int c = 0; c < CPT; ++c) acc[b][m][c] += a * wf[b][c];
          }
        }
      }
    }
    // the two row groups of a warp, then the warps, in a fixed order
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[b][m][c] += __shfl_xor_sync(0xffffffffu, acc[b][m][c], 16);
        }
    if (lane < 16) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < CPT; ++c) red[b][warp][m][cg * CPT + c] = acc[b][m][c];
    }
    __syncthreads();
    for (int i = tid; i < mc * NT; i += GEMV_THREADS) {
      const int m = i / NT;
      const int nn = i - m * NT;
      if (n0 + nn >= N) continue;
      float s[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        s[b] = 0.f;
        for (int wi = 0; wi < WARPS; ++wi) s[b] += red[b][wi][m][nn];
      }
      const int64_t o = static_cast<int64_t>(rows[m0 + m]) * N + n0 + nn;
      if constexpr (GATED) {
        const float g = __bfloat162float(__float2bfloat16(s[0]));
        const float u = __bfloat162float(__float2bfloat16(s[NB - 1]));
        const float sg = __bfloat162float(
            __float2bfloat16(g / (1.0f + expf(-g))));
        out[o] = __float2bfloat16(__fmul_rn(sg, u));
      } else {
        out[o] = __float2bfloat16(s[0]);
      }
    }
    __syncthreads();                              // red is free again
  }
}

// ---- 4. combine --------------------------------------------------------
__global__ void combine_kernel(const bf16* __restrict__ part,
                               const float* __restrict__ gates,
                               const int* __restrict__ ids,
                               const int* __restrict__ order,
                               const int* __restrict__ slot_of_expert,
                               int n_slots, float* __restrict__ y, int T,
                               int k, int d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(T) * d) return;
  const int t = static_cast<int>(i / d);
  const int c = static_cast<int>(i - static_cast<int64_t>(t) * d);
  float acc = 0.f;
  for (int r = 0; r < k; ++r) {
    const int p = t * k + order[t * k + r];
    const int slot = slot_of_expert[ids[p]];
    if (slot < 0 || slot >= n_slots) continue;
    const float v = __bfloat162float(part[static_cast<int64_t>(p) * d + c]);
    acc = __fadd_rn(acc, __fmul_rn(gates[p], v));
  }
  y[i] = acc;
}

}  // namespace

extern "C" int fused_moe_entry_launch(
    const void* x, const void* router_w, const void* logit_bias,
    const void* slot_of_expert, const void* s_gate, const void* s_up,
    const void* s_down, void* gates, void* ids, void* order, void* h,
    void* part, void* y, int T, int d, int E, int k, int f, int S, int norm,
    void* stream) {
  if (T < 1 || T > MAX_T || E < 1 || E > MAX_E || k < 1 || k > MAX_K ||
      k > E || d % 8 || f % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* soe = static_cast<const int*>(slot_of_expert);
  int* id = static_cast<int*>(ids);
  route_kernel<<<T, ROUTE_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(router_w),
      static_cast<const float*>(logit_bias), soe, static_cast<float*>(gates),
      id, static_cast<int*>(order), d, E, k, norm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expert_rows_kernel<true><<<dim3((f + NT - 1) / NT, E), GEMV_THREADS, 0,
                             st>>>(
      static_cast<const bf16*>(x), id, soe, S, T, k,
      static_cast<const bf16*>(s_gate), static_cast<const bf16*>(s_up),
      static_cast<bf16*>(h), d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expert_rows_kernel<false><<<dim3((d + NT - 1) / NT, E), GEMV_THREADS, 0,
                              st>>>(
      static_cast<const bf16*>(h), id, soe, S, T, k,
      static_cast<const bf16*>(s_down), nullptr, static_cast<bf16*>(part), f,
      d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(T) * d;
  combine_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(part), static_cast<const float*>(gates), id,
      static_cast<const int*>(order), soe, S, static_cast<float*>(y), T, k,
      d);
  return static_cast<int>(cudaGetLastError());
}
