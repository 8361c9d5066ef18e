// Element types of the kernels that run in bf16 or f32 (the reference's two
// types): conversion to and from fp32, and the elements of a 16-byte load.

#pragma once

#include <cuda_bf16.h>

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

}  // namespace
