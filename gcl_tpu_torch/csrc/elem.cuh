// The element types of the conv kernels: float32, and bfloat16 read and
// written as bf16 with float32 arithmetic in between (products and sums),
// as gcl_tpu's Pallas kernels take bf16 features.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// float32 to T, rounded to nearest even for bf16
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// a read through the read-only cache, as float32
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16* p) {
  return __bfloat162float(__ldg(p));
}
