// Softmax + top-k router gating for Hopper (sm_90a): logits fp32 or bf16 in,
// gates fp32 and ids int32 out.
//
// Replaces the TPU kernel `repro/kernels/topk_gating.py::topk_gating`
// (`_topk_kernel`, pallas_call at topk_gating.py:56): per row of logits
// (T, E), E <= 256,
//     probs = softmax(float(logits))                              (fp32)
//     k rounds: v = max(work); i = the lowest index with work == v;
//               work[i] = -1e30; total += v
//     gates = v's in rank order, divided by max(total, 1e-9) if norm
//
// Design.
// - The TPU kernel holds a (T tile, E) block in VMEM with E in the lanes.
//   Here one warp owns one row: lane l holds entries l, l + 32, ... in
//   registers, read with neighbouring lanes on neighbouring addresses. The
//   kernel is templated on the entries a lane holds, NJ = ceil(E / 32) in
//   {1, 2, 4, 8}: at E = 64 a round scans 2 registers, not 8.
// - Selection runs on unsigned keys through `redux.sync` (sm_80+,
//   `__reduce_max_sync` / `__reduce_min_sync`), one instruction a warp
//   reduction. A probability is >= 0, so its bit pattern orders as the
//   float does; its key is bits + 1, and 0 marks a chosen or padding entry,
//   below every probability (as the reference's -1e30). A round is one max
//   of the keys, then one min over the indices of the entries that hold it,
//   so ties go to the lowest index exactly as in the TPU kernel. The
//   softmax max takes the same instruction on order-preserving keys
//   (negative floats flip every bit, the others the sign bit). The sum stays
//   a shuffle tree: sm_90 has no float `redux`.
// - total is summed in rank order, as the TPU kernel's loop does.
//
// Bound on an H100 SXM: pure data movement, T * E * (2 or 4) bytes read and
// T * k * 8 bytes written at 3.35 TB/s (a (512, 64) fp32 batch: 0.05 us);
// the FLOPs (~E * (k + 6) per row) are far below. At serving sizes a launch
// costs more than the data, so the kernel is one launch with 8 rows per
// block of 256 threads; the wrapper keeps its own host work to one output
// allocation and one launch.
//
// C interface (bound with ctypes): topk_gating_launch returns
// cudaGetLastError() after enqueueing one launch on `stream`. It allocates
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;            // 8 warps, one row each
constexpr int ROWS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// float -> unsigned key with the float's order (NaN aside)
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned b = __float_as_uint(f);
  return b ^ ((b & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float(u ^ ((u & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    topk_kernel(const T* __restrict__ logits, float* __restrict__ gates,
                int* __restrict__ ids, int n_rows, int E, int k, int norm) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= n_rows) return;            // whole warps leave together
  const T* x = logits + static_cast<int64_t>(row) * E;

  float v[NJ];
  unsigned mk = 0u;                     // below ordered(-inf)
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? load(x + e) : -INFINITY;
    mk = max(mk, ordered(v[j]));
  }
  const float mx = from_ordered(__reduce_max_sync(FULL, mk));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? expf(v[j] - mx) : 0.f;
    sum += v[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(FULL, sum, o);
  unsigned key[NJ];                     // probability bits + 1; 0 = out
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int e = lane + 32 * j;
    key[j] = e < E ? __float_as_uint(v[j] / sum) + 1u : 0u;
  }

  // round r's (value, index) stays with lane r % 32, entry r / 32
  float sel_v[NJ] = {};
  int sel_i[NJ] = {};
  float total = 0.f;
  for (int r = 0; r < k; ++r) {
    // this lane's best: entries ascend in index, so strict > keeps the first
    unsigned bk = key[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < NJ; ++j)
      if (key[j] > bk) {
        bk = key[j];
        bi = lane + 32 * j;
      }
    const unsigned m = __reduce_max_sync(FULL, bk);
    const int win = static_cast<int>(__reduce_min_sync(
        FULL, bk == m ? static_cast<unsigned>(bi) : FULL));
    const float p = __uint_as_float(m - 1u);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (win == lane + 32 * j) key[j] = 0u;
      if (r == lane + 32 * j) {
        sel_v[j] = p;
        sel_i[j] = win;
      }
    }
    total += p;
  }
  const float denom = norm ? fmaxf(total, 1e-9f) : 1.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int r = lane + 32 * j;
    if (r < k) {
      const int64_t o = static_cast<int64_t>(row) * k + r;
      gates[o] = norm ? sel_v[j] / denom : sel_v[j];
      ids[o] = sel_i[j];
    }
  }
}

template <typename T>
void launch(const void* logits, void* gates, void* ids, int T_, int E, int k,
            int norm, cudaStream_t st) {
  const dim3 grid((T_ + ROWS - 1) / ROWS);
  const T* in = static_cast<const T*>(logits);
  float* g = static_cast<float*>(gates);
  int* i = static_cast<int*>(ids);
  if (E <= 32)
    topk_kernel<T, 1><<<grid, THREADS, 0, st>>>(in, g, i, T_, E, k, norm);
  else if (E <= 64)
    topk_kernel<T, 2><<<grid, THREADS, 0, st>>>(in, g, i, T_, E, k, norm);
  else if (E <= 128)
    topk_kernel<T, 4><<<grid, THREADS, 0, st>>>(in, g, i, T_, E, k, norm);
  else
    topk_kernel<T, 8><<<grid, THREADS, 0, st>>>(in, g, i, T_, E, k, norm);
}

}  // namespace

extern "C" int topk_gating_launch(const void* logits, int is_bf16,
                                  void* gates, void* ids, int T, int E, int k,
                                  int norm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(logits, gates, ids, T, E, k, norm, st);
  else
    launch<float>(logits, gates, ids, T, E, k, norm, st);
  return static_cast<int>(cudaGetLastError());
}
