// Shared helpers of the port's CUDA kernels: storage-type conversions and
// the error-string entry every library exports to its ctypes binding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* rn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace rn {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace rn
