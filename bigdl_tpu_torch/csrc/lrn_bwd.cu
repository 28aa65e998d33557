// Cross-map LRN backward for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/lrn_pallas.py::_cml_bwd_kernel (launched by
// _cml_bwd_pallas through _cml_call, pl.pallas_call).
//
// Over NCHW x, the forward's den and the output gradient g, with a zero
// channel halo of half = (n-1)/2 on each side:
//   t[i]  = g[i] * x[i] * den[i]^(-beta-1)
//   dx[i] = g[i] * den[i]^-beta - (2*alpha*beta/n) * x[i] * sum_{d=0..n-1} t[i-half+d]
// For an odd band the transposed window of the backward is the forward's
// window, and the sum runs in band order d = 0..n-1, the order of the
// Pallas kernel.  The Pallas kernel pads den with 1.0 and x, g with 0 so
// that the halo's t is 0; here t is 0 outside [0, c) directly.  Powers
// are exp(p * log(den)), rsqrt when p == -0.5 (lrn_pallas.py::_pow).
// Multiplies and adds are kept apart (__fmul_rn, __fadd_rn, __fsub_rn)
// so that no FMA rounds differently from the plain version.
//
// What bounds it on the card: bytes.  x, den and g are read once and dx
// is written once (4 tensors; norm2 at batch 256 in bf16 is 1.2 GB, about
// 0.37 ms at 3.35 TB/s); about 2n+12 flops and two exp/log pairs per
// element stay far below the card's f32 rate.
//
// Design: the forward kernel's layout.  One thread per (image, chunk of
// CHUNK channels, pixel); neighbouring threads take neighbouring pixels,
// so every load and store of a warp is one contiguous line (channels lie
// HW elements apart).  A thread walks its chunk and keeps the last n
// values of t, of g*den^-beta and of x in registers (fully unrolled, so
// the ring shift is register renaming); each channel's three inputs are
// loaded once per chunk, and a chunk re-reads only its 2*half halo
// channels, which mostly hit L2.  No shared memory, no atomics.

#include "common.cuh"

namespace {

constexpr int kChunk = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float pow_p(float s, float p) {
  return (p == -0.5f) ? rsqrtf(s) : expf(__fmul_rn(p, logf(s)));
}

template <typename T, int SIZE>
__global__ void __launch_bounds__(kThreads)
cml_bwd_kernel(const T* __restrict__ x, const T* __restrict__ den,
               const T* __restrict__ g, T* __restrict__ dx, int c, int hw,
               int nchunks, long long total, float c2, float p0, float p1) {
  constexpr int HALF = (SIZE - 1) / 2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int p = static_cast<int>(idx % hw);
  const long long t = idx / hw;
  const int c0 = static_cast<int>(t % nchunks) * kChunk;
  const long long base = (t / nchunks) * static_cast<long long>(c) * hw + p;

  // slot d of each ring holds channel i - HALF + d for the output channel i
  float tr[SIZE], ar[SIZE], xr[SIZE];
  auto load = [&](int ch, float& tv, float& av, float& xv) {
    if (ch >= 0 && ch < c) {
      const long long off = base + static_cast<long long>(ch) * hw;
      xv = bigdl::to_f32(x[off]);
      const float gv = bigdl::to_f32(g[off]);
      const float dv = bigdl::to_f32(den[off]);
      tv = __fmul_rn(__fmul_rn(gv, xv), pow_p(dv, p1));
      av = __fmul_rn(gv, pow_p(dv, p0));
    } else {
      tv = 0.f;
      av = 0.f;
      xv = 0.f;
    }
  };
#pragma unroll
  for (int d = 1; d < SIZE; ++d) load(c0 - HALF + d - 1, tr[d], ar[d], xr[d]);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int i = c0 + j;
#pragma unroll
    for (int d = 0; d + 1 < SIZE; ++d) {
      tr[d] = tr[d + 1];
      ar[d] = ar[d + 1];
      xr[d] = xr[d + 1];
    }
    load(i + HALF, tr[SIZE - 1], ar[SIZE - 1], xr[SIZE - 1]);
    if (i < c) {
      float s = tr[0];
#pragma unroll
      for (int d = 1; d < SIZE; ++d) s = __fadd_rn(s, tr[d]);
      const float v = __fsub_rn(ar[HALF], __fmul_rn(__fmul_rn(c2, xr[HALF]), s));
      dx[base + static_cast<long long>(i) * hw] = bigdl::from_f32<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* den, const void* g, void* dx,
                   int n, int c, int hw, int size, float c2, float p0,
                   float p1, cudaStream_t stream) {
  const int nchunks = (c + kChunk - 1) / kChunk;
  const long long total = static_cast<long long>(n) * nchunks * hw;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const T* xs = static_cast<const T*>(x);
  const T* ds = static_cast<const T*>(den);
  const T* gs = static_cast<const T*>(g);
  T* dxs = static_cast<T*>(dx);
#define BIGDL_CML_CASE(S)                                                    \
  case S:                                                                    \
    cml_bwd_kernel<T, S><<<blocks, kThreads, 0, stream>>>(                   \
        xs, ds, gs, dxs, c, hw, nchunks, total, c2, p0, p1);                 \
    break;
  switch (size) {
    BIGDL_CML_CASE(1)
    BIGDL_CML_CASE(3)
    BIGDL_CML_CASE(5)
    BIGDL_CML_CASE(7)
    BIGDL_CML_CASE(9)
    BIGDL_CML_CASE(11)
    BIGDL_CML_CASE(13)
    BIGDL_CML_CASE(15)
    default:
      return cudaErrorInvalidValue;
  }
#undef BIGDL_CML_CASE
  return cudaGetLastError();
}

}  // namespace

// x, den, g and dx are contiguous [n, c, hw] tensors of one dtype
// (0 = f32, 1 = bf16); c2 is 2*alpha*beta/size, p0 is -beta and p1 is
// -beta-1.  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError().
extern "C" int bigdl_cml_bwd(const void* x, const void* den, const void* g,
                             void* dx, int n, int c, int hw, int size,
                             float c2, float p0, float p1, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(x, den, g, dx, n, c, hw, size, c2, p0, p1, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, den, g, dx, n, c, hw, size, c2, p0, p1, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
