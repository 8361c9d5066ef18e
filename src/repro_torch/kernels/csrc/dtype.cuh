// Element types of the kernels that run in bf16 or f32 (the reference's two
// types): conversion to and from fp32, and the elements of a 16-byte load;
// and the launchers' opt-in to more than 48 KB of dynamic shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Rounds to T: a no-op for float.
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);   // elements of one 16-byte load
};

// Lets `kernel` launch with up to `bytes` of dynamic shared memory (the
// opt-in above 48 KB), once per kernel and device; a launcher passes the
// most it ever asks for. Returns cudaSuccess or the error.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel* kernel, int bytes) {
  struct Done {
    const void* kernel;
    int dev;
  };
  static Done done[64];
  static int n_done = 0;
  const void* k = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_done; ++i)
    if (done[i].kernel == k && done[i].dev == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && n_done < 64) done[n_done++] = {k, dev};
  return err;
}

}  // namespace
