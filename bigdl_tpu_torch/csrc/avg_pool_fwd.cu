// Torch-semantics average-pool forward for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/pool_pallas.py::_avg_fwd_kernel (launched by
// _avg_fwd_pallas through ops/pallas_util.py::plane_call,
// pl.pallas_call).
//
// Over NCHW x with asymmetric zero padding (ph, pw on the low side; the
// high side, ceil overflow included, is whatever the output extent
// reaches):
//   y[p, oy, ox] = (sum over the kh x kw window, in (dh, dw) order) * inv[oy, ox]
// inv is the reciprocal divisor plane the wrapper computes once per
// geometry from the JAX package's _np_inv_counts (declared padding counts
// under count_include_pad, ceil overflow never does).  Taps in the
// padding add 0, so the sum equals the Pallas kernel's sum over the
// zero-padded plane; adds and the final multiply are kept apart from
// FMA contraction.  General kernel size, stride and padding: the
// Inception head is 7x7 s1 on 7x7 planes, the aux heads 5x5 s3 ceil.
//
// What bounds it on the card: bytes for large planes (x read once, y
// written once), launch latency at the head's shape ([8,1024,7,7] moves
// 1.6 MB, about half a microsecond of DRAM time).
//
// Design: one thread per output element, consecutive threads on
// consecutive outputs of a plane, summing in f32 in registers.  With the
// head's 1x1 output a warp's threads each walk their own 49-element
// plane; the planes of a warp are contiguous, so L1 serves the reads
// the strided first pass brings in.  No shared memory, no atomics.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
avg_pool_fwd_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                    T* __restrict__ y, long long total, int h, int w, int oh,
                    int ow, int kh, int kw, int sh, int sw, int ph, int pw) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ox = static_cast<int>(idx % ow);
  const long long t = idx / ow;
  const int oy = static_cast<int>(t % oh);
  const T* plane = x + (t / oh) * static_cast<long long>(h) * w;
  const int h0 = oy * sh - ph;
  const int w0 = ox * sw - pw;
  float s = 0.f;
  for (int dh = 0; dh < kh; ++dh) {
    const int ih = h0 + dh;
    const bool row = ih >= 0 && ih < h;
    for (int dw = 0; dw < kw; ++dw) {
      const int iw = w0 + dw;
      const float v = (row && iw >= 0 && iw < w) ? bigdl::to_f32(plane[ih * w + iw]) : 0.f;
      s = __fadd_rn(s, v);
    }
  }
  y[idx] = bigdl::from_f32<T>(__fmul_rn(s, inv[oy * ow + ox]));
}

template <typename T>
cudaError_t launch(const void* x, const void* inv, void* y, int nc, int h,
                   int w, int oh, int ow, int kh, int kw, int sh, int sw,
                   int ph, int pw, cudaStream_t stream) {
  const long long total = static_cast<long long>(nc) * oh * ow;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  avg_pool_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(inv),
      static_cast<T*>(y), total, h, w, oh, ow, kh, kw, sh, sw, ph, pw);
  return cudaGetLastError();
}

}  // namespace

// x is a contiguous [nc, h, w] tensor and y a contiguous [nc, oh, ow]
// tensor of one dtype (0 = f32, 1 = bf16); inv is a contiguous f32
// [oh, ow] plane.  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError().
extern "C" int bigdl_avg_pool_fwd(const void* x, const void* inv, void* y,
                                  int nc, int h, int w, int oh, int ow,
                                  int kh, int kw, int sh, int sw, int ph,
                                  int pw, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(x, inv, y, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, inv, y, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
