// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): the tile geometry, tile loads into shared
// memory, the causal liveness test and the row reductions.
//
// Every kernel runs 256 threads as a 16 x 16 grid (tx = tid % 16 fastest).
// A 64 x 64 score tile gives each thread the 4 x 4 entries at rows
// ty + 16 i and columns tx + 16 j (i, j < 4); an accumulator over the head
// dim gives it rows ty + 16 i and columns tx + 16 j (j < NJ = ceil(D / 16)).
// A row's 16 owners are the 16 lanes of one half-warp, so a row reduction
// is four xor-shuffles.  A shared tile row holds the head dim rounded up
// to 4 (zeros past d) plus 4 floats of padding, so the loops over the head
// dim and over a score row read float4s, and the 8 threads of a quarter
// warp that read 8 rows at one column hit 32 banks.
#pragma once

#include "common.cuh"

namespace bigdl {
namespace flash {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // q rows and k rows of a tile
constexpr int kMaxD = 128;            // the largest head dim
constexpr int kTS = kTile + 4;        // row stride of a score tile
constexpr float kNegInf = -1e30f;     // the Pallas kernels' _NEG_INF

// The head dim rounded up to a multiple of 4, and a tile's row stride.
__host__ __device__ constexpr int d4(int d) { return (d + 3) / 4 * 4; }
__host__ __device__ constexpr int ld(int d) { return d4(d) + 4; }

// Four consecutive elements from global memory as f32: one 16-byte load
// of f32, one 8-byte load of bf16.
__device__ __forceinline__ float4 load4_global(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4_global(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Copy rows [row0, row0 + kTile) of a contiguous [rows, d] matrix into a
// shared [kTile][ld(d)] f32 tile; rows past `rows` and columns d..d4(d)-1
// are zeros.  When d is a multiple of 4 whose d / 4 column groups divide
// the 256 threads (d = 4, 8, 16, 32, 64, 128) and the matrix starts on a
// four-element boundary, each thread keeps one column group and loads
// four elements at a time (no division per element); otherwise one
// element at a time.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int row0,
                                          int rows, int d) {
  const int valid = min(kTile, rows - row0);
  const T* base = src + static_cast<long long>(row0) * d;
  const int groups = d / 4;
  if (d % 4 == 0 && kThreads % groups == 0 &&
      reinterpret_cast<unsigned long long>(src) % (4 * sizeof(T)) == 0) {
    const int c = 4 * (threadIdx.x % groups);
    for (int r = threadIdx.x / groups; r < kTile; r += kThreads / groups) {
      const float4 v = r < valid ? load4_global(base + r * d + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + r * ld(d) + c) = v;
    }
    return;
  }
  const int w = d4(d);
  for (int idx = threadIdx.x; idx < kTile * w; idx += kThreads) {
    const int r = idx / w;
    const int c = idx - r * w;
    dst[r * ld(d) + c] = r < valid && c < d ? to_f32(base[r * d + c]) : 0.f;
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Component u (a constant after unrolling) of a float4.
__device__ __forceinline__ float at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// acc[i][j] += sum over the head dim of a[row i][e] * b[row j][e], for the
// 4 rows of `a` at ra + 16 i and the 4 rows of `b` at rb + 16 j, e in
// order (the zero padding adds nothing).
__device__ __forceinline__ void dot_rows(float (&acc)[4][4],
                                         const float* __restrict__ a, int ra,
                                         const float* __restrict__ b, int rb,
                                         int d) {
  for (int e = 0; e < d4(d); e += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = load4(a + (ra + 16 * i) * ld(d) + e);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = load4(b + (rb + 16 * j) * ld(d) + e);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(at(x[i], u), at(y[j], u), acc[i][j]);
  }
}

// acc[i][j] += sum over c < n of w[row i][c] * m[c][col j], for the 4
// rows of the score tile `w` at r + 16 i and this thread's NJ head-dim
// columns of the tile `m`; n is rounded up to 4 (w is 0 and m's rows
// are zeros past the tile's valid keys or queries).
template <int NJ>
__device__ __forceinline__ void mul_tile(float (&acc)[4][NJ],
                                         const float* __restrict__ w, int r,
                                         const float* __restrict__ m,
                                         const int (&col)[NJ], int n, int d) {
  for (int c = 0; c < n; c += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = load4(w + (r + 16 * i) * kTS + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float y[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) y[j] = m[(c + u) * ld(d) + col[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(at(x[i], u), y[j], acc[i][j]);
    }
  }
}

// The last q row of the tile at q0 that exists (the ragged tile's rows past
// sq do not count), and the Pallas liveness test for the k tile at k0:
// some row of the q tile sees some key of the k tile.
__device__ __forceinline__ bool live(bool causal, int q0, int sq, int k0,
                                     int off) {
  const int q_last = min(q0 + kTile, sq) - 1;
  return !causal || q_last + off >= k0;
}

// May q row r (absolute) see key c (absolute)?  off = sk - sq.
__device__ __forceinline__ bool visible(bool causal, int r, int c, int sk,
                                        int off) {
  return c < sk && (!causal || r + off >= c);
}

// Reductions over the 16 lanes of a half-warp (one row's owners).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised
// once, before its first launch (never inside a graph capture: the
// wrappers' first call runs eagerly).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace flash
}  // namespace bigdl
