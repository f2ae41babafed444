// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its activations as float or bfloat16, computes in
// float32 and stores in the input type. Conversions go through the
// intrinsics so the file builds with or without PyTorch's
// __CUDA_NO_BFLOAT16_CONVERSIONS__ flags.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

}  // namespace vt
