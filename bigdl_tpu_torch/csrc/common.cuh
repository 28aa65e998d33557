// Shared helpers for the port's kernels: element loads and stores in f32
// math, and the dtype codes the Python wrappers pass (0 = f32, 1 = bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bigdl {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace bigdl

// Every library exports its own copy, so a wrapper can name the error
// its launcher returned.
#define BIGDL_EXPORT_ERROR_STRING                               \
  extern "C" const char* bigdl_error_string(int err) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(err));   \
  }
