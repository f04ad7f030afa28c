// Shared helpers for the hand-written kernels of mm2d3d_tpu_torch.
//
// Every library exports kernel_error_string() so the Python wrapper can turn
// the cudaError_t a launch function returns into a message.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// dtype codes passed from Python (ops/kernels/*.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };
