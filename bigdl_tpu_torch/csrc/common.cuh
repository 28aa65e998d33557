// Shared helpers for the port's kernels: element loads and stores in f32
// math, and the dtype codes the Python wrappers pass (0 = f32, 1 = bf16,
// 2 = f16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace bigdl {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Division of unsigned n < 2^31 by a divisor d fixed at launch, as a
// multiply-high, an add and a shift (the round-up magic-number method of
// Granlund and Montgomery): a kernel that splits a flat index into
// coordinates spends most of its instructions on 64-bit division
// otherwise.  The host fills it once per launch.
struct FastDiv {
  unsigned d, magic, shift;
};

inline FastDiv make_fastdiv(unsigned d) {
  unsigned shift = 0;
  while (shift < 32 && (1u << shift) < d) ++shift;
  const unsigned long long one = 1;
  const unsigned magic = static_cast<unsigned>(
      ((one << 32) * ((one << shift) - d)) / d + 1);
  return {d, magic, shift};
}

__device__ __forceinline__ unsigned div(unsigned n, FastDiv f) {
  return (__umulhi(n, f.magic) + n) >> f.shift;
}

}  // namespace bigdl

// Every library exports its own copy, so a wrapper can name the error
// its launcher returned.
#define BIGDL_EXPORT_ERROR_STRING                               \
  extern "C" const char* bigdl_error_string(int err) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(err));   \
  }
