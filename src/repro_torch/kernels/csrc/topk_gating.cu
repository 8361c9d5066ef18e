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
//   registers (at most 8 at E = 256), read with neighbouring lanes on
//   neighbouring addresses. Max and sum are shuffle reductions; nothing
//   goes through shared memory.
// - Each of the k rounds is a warp arg-max over (value desc, index asc),
//   so ties go to the lowest index as in the TPU kernel. The winner's lane
//   masks its entry to -1e30, which loses to every probability (>= 0);
//   lanes' unused entries (index >= E) hold -inf and lose to -1e30, so with
//   k <= E a masked entry is never chosen while an unmasked one remains.
// - total is summed in rank order, as the TPU kernel's loop does.
//
// Bound on an H100 SXM: pure data movement, T * E * (2 or 4) bytes read and
// T * k * 8 bytes written at 3.35 TB/s (a (512, 64) fp32 batch: 0.04 us);
// the FLOPs (~E * (k + 6) per row) are far below. At serving sizes a launch
// costs more than the data, so the kernel is one launch with 8 rows per
// block of 256 threads.
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
constexpr int MAX_E = 256;
constexpr int PER_LANE = MAX_E / 32;    // 8
constexpr float MASKED = -1e30f;        // as the reference kernel

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    topk_kernel(const T* __restrict__ logits, float* __restrict__ gates,
                int* __restrict__ ids, int n_rows, int E, int k, int norm) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= n_rows) return;            // whole warps leave together
  const T* x = logits + static_cast<int64_t>(row) * E;

  float v[PER_LANE];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? load(x + e) : -INFINITY;
    mx = fmaxf(mx, v[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? expf(v[j] - mx) : 0.f;
    sum += v[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? v[j] / sum : -INFINITY;
  }

  // round r's (value, index) stays with lane r % 32, entry r / 32
  float sel_v[PER_LANE] = {};
  int sel_i[PER_LANE] = {};
  float total = 0.f;
  for (int r = 0; r < k; ++r) {
    // this lane's best: entries ascend in index, so strict > keeps the first
    float bv = v[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < PER_LANE; ++j)
      if (v[j] > bv) {
        bv = v[j];
        bi = lane + 32 * j;
      }
    // warp arg-max over (value desc, index asc): every lane ends with it
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if (bi == lane + 32 * j) v[j] = MASKED;
      if (r == lane + 32 * j) {
        sel_v[j] = bv;
        sel_i[j] = bi;
      }
    }
    total += bv;
  }
  const float denom = norm ? fmaxf(total, 1e-9f) : 1.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int r = lane + 32 * j;
    if (r < k) {
      const int64_t o = static_cast<int64_t>(row) * k + r;
      gates[o] = norm ? sel_v[j] / denom : sel_v[j];
      ids[o] = sel_i[j];
    }
  }
}

}  // namespace

extern "C" int topk_gating_launch(const void* logits, int is_bf16,
                                  void* gates, void* ids, int T, int E, int k,
                                  int norm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + ROWS - 1) / ROWS);
  if (is_bf16)
    topk_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(gates),
        static_cast<int*>(ids), T, E, k, norm);
  else
    topk_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(logits), static_cast<float*>(gates),
        static_cast<int*>(ids), T, E, k, norm);
  return static_cast<int>(cudaGetLastError());
}
