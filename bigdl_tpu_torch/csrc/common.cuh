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

// cp.async (sm_80 and up): copies from global to shared memory that the
// issuing thread waits for by group.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, both addresses 16-byte aligned; with valid false the source
// size is 0 and the 16 bytes are zero-filled (src must still be a mapped
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace bigdl

// Every library exports its own copy, so a wrapper can name the error
// its launcher returned.
#define BIGDL_EXPORT_ERROR_STRING                               \
  extern "C" const char* bigdl_error_string(int err) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(err));   \
  }
