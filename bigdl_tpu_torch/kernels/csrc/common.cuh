// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel computes in fp32 and takes fp32 or bf16 tensors. The dtype
// code passed across the C interface is 0 for float32 and 1 for bfloat16.
// Conversions go through the cuda_bf16 intrinsics only, so the sources build
// the same with or without PyTorch's -D__CUDA_NO_BFLOAT16_CONVERSIONS__.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bigdl {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

}  // namespace bigdl
