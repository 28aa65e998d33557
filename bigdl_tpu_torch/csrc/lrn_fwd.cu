// Cross-map LRN forward for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/lrn_pallas.py::_cml_fwd_kernel (launched by
// _cml_fwd_pallas through _cml_call, pl.pallas_call).
//
// Over NCHW x, with a zero channel halo of half = (n-1)/2 on each side:
//   den[i] = k + (alpha/n) * sum_{d=0..n-1} x[i-half+d]^2
//   y[i]   = x[i] * den[i]^-beta        (rsqrt when beta == 0.5)
// The squares are summed in band order d = 0..n-1, the order of the
// Pallas kernel; multiplies and adds are kept apart (__fmul_rn,
// __fadd_rn) so the compiler does not fuse them into FMAs that round
// differently from the reference.
//
// What bounds it on the card: bytes.  Each element is read once and y is
// written once (den only when the caller asks, for the backward); about
// 2n+6 flops per element is far below the ~20 flops per byte at which an
// H100 turns compute-bound in f32.
//
// Design: one thread per (image, chunk of CHUNK channels, pixel).
// Neighbouring threads take neighbouring pixels, so each load and store
// of a warp is one contiguous line (channels lie HW elements apart).  A
// thread walks its chunk and keeps the last n inputs in registers: the
// fully unrolled loop turns the ring shift into register renaming, and
// every load address is known up front, so the loads of a chunk are in
// flight together.  The chunks give the card enough independent threads
// to cover DRAM latency (norm1 at batch 8: 8*4*3136 = 100k threads);
// each chunk re-reads its 2*half halo channels, which mostly hit L2.  No
// shared memory: no value is reused across pixels.

#include "common.cuh"

namespace {

constexpr int kChunk = 16;
constexpr int kThreads = 256;

template <typename T, int SIZE>
__global__ void __launch_bounds__(kThreads)
cml_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, T* __restrict__ den,
               int c, int hw, int nchunks, long long total, float alpha_n,
               float beta, float k) {
  constexpr int HALF = (SIZE - 1) / 2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int p = static_cast<int>(idx % hw);
  const long long t = idx / hw;
  const int c0 = static_cast<int>(t % nchunks) * kChunk;
  const long long base = (t / nchunks) * static_cast<long long>(c) * hw + p;

  // ring[d] holds x at channel i - HALF + d for the output channel i
  float ring[SIZE];
#pragma unroll
  for (int d = 1; d < SIZE; ++d) {
    const int ch = c0 - HALF + d - 1;
    ring[d] = (ch >= 0 && ch < c)
                  ? bigdl::to_f32(x[base + static_cast<long long>(ch) * hw]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int i = c0 + j;
#pragma unroll
    for (int d = 0; d + 1 < SIZE; ++d) ring[d] = ring[d + 1];
    const int ch = i + HALF;
    ring[SIZE - 1] = (ch < c)
                         ? bigdl::to_f32(x[base + static_cast<long long>(ch) * hw]) : 0.f;
    if (i < c) {
      float s = __fmul_rn(ring[0], ring[0]);
#pragma unroll
      for (int d = 1; d < SIZE; ++d) s = __fadd_rn(s, __fmul_rn(ring[d], ring[d]));
      const float dn = __fadd_rn(k, __fmul_rn(s, alpha_n));
      const float scale = (beta == 0.5f) ? rsqrtf(dn) : expf(-beta * logf(dn));
      const long long off = base + static_cast<long long>(i) * hw;
      y[off] = bigdl::from_f32<T>(__fmul_rn(ring[HALF], scale));
      if (den != nullptr) den[off] = bigdl::from_f32<T>(dn);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, void* den, int n, int c, int hw,
                   int size, float alpha_n, float beta, float k,
                   cudaStream_t stream) {
  const int nchunks = (c + kChunk - 1) / kChunk;
  const long long total = static_cast<long long>(n) * nchunks * hw;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  T* ds = static_cast<T*>(den);
#define BIGDL_CML_CASE(S)                                                    \
  case S:                                                                    \
    cml_fwd_kernel<T, S><<<blocks, kThreads, 0, stream>>>(                   \
        xs, ys, ds, c, hw, nchunks, total, alpha_n, beta, k);                \
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

// x, y (and den, or null) are contiguous [n, c, hw] tensors of one dtype
// (0 = f32, 1 = bf16); alpha_n is alpha / size.  Launches on `stream`,
// does not synchronise, allocates nothing; returns cudaGetLastError().
extern "C" int bigdl_cml_fwd(const void* x, void* y, void* den, int n, int c,
                             int hw, int size, float alpha_n, float beta,
                             float k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(x, y, den, n, c, hw, size, alpha_n, beta, k, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, y, den, n, c, hw, size, alpha_n, beta, k, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
