// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): the tile geometry, the causal liveness test,
// and two sets of building blocks.
//
// The CUDA-core set (the f32 kernels): the kernels run 256 threads as a
// 16 x 16 grid (tx = tid % 16 fastest).  A 64 x 64 score tile gives each
// thread the 4 x 4 entries at rows ty + 16 i and columns tx + 16 j
// (i, j < 4); an accumulator over the head dim gives it rows ty + 16 i
// and columns tx + 16 j (j < NJ = ceil(D / 16)).  A row's
// 16 owners are the 16 lanes of one half-warp, so a row reduction is four
// xor-shuffles.  A shared tile row holds the head dim rounded up to 4
// (zeros past d) plus 4 floats of padding, converted to f32, so the loops
// over the head dim and over a score row read float4s, and the 8 threads
// of a quarter warp that read 8 rows at one column hit 32 banks.  They
// compute in f32 with FMAs.
//
// The tensor-core set (namespace tc: the bf16 kernels): 128 threads, 4
// warps of 16 tile rows each, products by
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with f32 accumulators,
// operands from bf16 tiles in shared memory by ldmatrix (.trans where the
// operand runs along the sequence), streamed tiles copied by cp.async into
// a two-stage ring.  A shared bf16 tile row holds the head dim rounded up
// to DP (32, 64 or 128; zeros past d) plus 8 elements (16 bytes) of
// padding: the 8 row addresses of one ldmatrix then fall 4 banks apart
// and cover all 32 banks, and every row starts on 16 bytes for cp.async.
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

// Four consecutive f32 elements from global memory: one 16-byte load.
__device__ __forceinline__ float4 load4_global(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

// ---------------------------------------------------------------------------
// tensor-core building blocks (sm_80 and up; built here for sm_90a)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 128;  // 4 warps, 16 tile rows each
constexpr float kLog2e = 1.4426950408889634f;

// Row stride, in elements, of a shared bf16 tile whose rows hold DP values.
__host__ __device__ constexpr int stride(int dp) { return dp + 8; }

// The head dim rounded up to the width a kernel instance holds.
__host__ __device__ constexpr int padded_d(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// cp.async: the 16-byte copies, groups and waits of common.cuh, and 4-byte
// copies zero-filled the same way.
using ::bigdl::cp_async16;
using ::bigdl::cp_commit;
using ::bigdl::cp_wait;
using ::bigdl::smem_addr;

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register j receives, of matrix j, the
// pair at row lane / 4, columns 2 (lane % 4) and 2 (lane % 4) + 1 (with
// .trans: rows 2 (lane % 4) and 2 (lane % 4) + 1 of column lane / 4).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col) and a 16 x 8
// f32 C.  With g = lane / 4 and t = lane % 4: a = {(g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}, b = {(2t..2t+1, g),
// (2t+8.., g)}, c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.  So the
// accumulators of two neighbouring n8 tiles, packed to bf16 pairs, are
// the A operand of the next product over those 16 columns.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low
// half: one register of an A operand.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The A operand of the product over the 16 columns 16 kk .. 16 kk + 15 of
// a 16-row accumulator held as n8 tiles.
__device__ __forceinline__ void acc_to_a(unsigned (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Lane offset, in elements, into a shared tile for the ldmatrix that reads
// rows r0..r0+15 x columns c0..c0+15 as an A operand (matrices: rows 0-7
// and 8-15 at columns 0-7, then at 8-15).
template <int DP>
__device__ __forceinline__ int a_offset(int lane, int r0, int c0) {
  return (r0 + (lane & 15)) * stride(DP) + c0 + (lane >> 4) * 8;
}

// ... as the B operands of two n8 tiles from a tile stored [n][k] (rows
// n0..n0+15, columns = k): matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
// (n 8-15, k 0-7), (n 8-15, k 8-15) give b0, b1 of tile n0 and of n0 + 8.
template <int DP>
__device__ __forceinline__ int b_offset(int lane, int n0, int k0) {
  return (n0 + (lane & 7) + (lane >> 4) * 8) * stride(DP) + k0 +
         ((lane >> 3) & 1) * 8;
}

// ... as the B operands of two n8 tiles from a tile stored [k][n] (rows
// k0..k0+15 along the sequence, columns n0..n0+15), read with .trans:
// matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
// (k 8-15, n 8-15) give b0, b1 of tile n0 and of n0 + 8.
template <int DP>
__device__ __forceinline__ int bt_offset(int lane, int k0, int n0) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride(DP) + n0 +
         (lane >> 4) * 8;
}

// Rows [row0, row0 + kTile) of a contiguous [rows, d] bf16 matrix into a
// shared [kTile][stride(DP)] tile; rows past `rows` and columns d..DP-1
// are zeros.  vec (d % 8 == 0 and a 16-byte aligned matrix): 16-byte
// cp.async copies, zero-filled by a source size of 0 where they fall past
// the matrix.  Otherwise element loads and stores, which complete before
// the next barrier as the copies do after cp_wait.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int d, bool vec) {
  const int valid = rows - row0;
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = r < valid && c < d;
      cp_async16(dst + r * stride(DP) + c,
                 ok ? src + static_cast<long long>(row0 + r) * d + c : src,
                 ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dst[r * stride(DP) + c] =
        r < valid && c < d ? src[static_cast<long long>(row0 + r) * d + c]
                           : __float2bfloat16_rn(0.f);
  }
}

// One warp's 16 staged rows [r0, r0 + 16) of a shared bf16 tile out to
// rows r0 + row0 .. of a contiguous [rows, d] matrix, rows past `rows`
// and columns past d left out: 16-byte stores when vec, else elements.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int row0, int rows, int d,
                                           bool vec, int lane) {
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int i = lane; i < 16 * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (row0 + r0 + r < rows && c < d)
        *reinterpret_cast<uint4*>(
            dst + static_cast<long long>(row0 + r0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(src + (r0 + r) * stride(DP) + c);
    }
    return;
  }
  for (int i = lane; i < 16 * DP; i += 32) {
    const int r = i / DP, c = i % DP;
    if (row0 + r0 + r < rows && c < d)
      dst[static_cast<long long>(row0 + r0 + r) * d + c] =
          src[(r0 + r) * stride(DP) + c];
  }
}

// Sums over the 4 lanes of a quad (the owners of one accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace tc

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
