// Max-pool forward for Hopper (sm_90a): the window maximum, and on
// request the int8 tap index of the first maximum.
//
// Replaces: bigdl_tpu/ops/pool_pallas.py::_maxpool_fwd_kernel (launched
// by _tie_fwd_pallas through ops/pallas_util.py::plane_call,
// pl.pallas_call), the tie-split forward.  With the index output it is
// also the argmax-mode forward, which the JAX package computes as one
// XLA reduce_window over a packed u32 (ops/pooling_pallas.py::
// _fwd_packed) and not as a Pallas kernel.
//
// Over NCHW x with low-side paddings ph, pw (the high side, ceil
// overflow included, is whatever the output extent reaches), for every
// output o = (p, oy, ox) the taps (dh, dw) run in row-major order and
//   y[o]   = x at the first tap whose value beats every earlier one
//   idx[o] = dh * kw + dw of that tap                     (int8)
// where "beats" is: the first tap at all, or a NaN over a non-NaN, or
// strictly greater (so NaN propagates as jnp.maximum propagates it and
// the first NaN wins; -0.0 ties with +0.0 and the first wins; equal
// values go to the first tap, the reference's first-argmax order).  y
// keeps the winning element's own bits.  Taps outside the plane are
// skipped: a padding tap never wins, as the packed-u32 init of 0 never
// wins in _fwd_packed.  For the tie-split forward the JAX package pads
// with -inf instead; that gives the same y, since a max over real taps
// and -inf equals the max over the real taps.  A window with no tap in
// the plane (Torch's rule pad <= k/2 leaves none) gives -inf and
// index -1.  Comparisons run in f32, which is exact for bf16 and f16.
//
// What bounds it on the card: bytes.  x is read and y (and idx) written
// once; Inception-v1's pool1 at batch 256 in bf16 reads 411 MB and
// writes 103 MB (0.153 ms at 3.35 TB/s).  Overlapping windows (3x3 s2
// reads each row of x up to twice) are served from L1/L2.
//
// Design: one thread per output element, consecutive threads on
// consecutive outputs of a plane, so stores are contiguous and a warp's
// loads of one tap row fall in a few cache lines.  The flat index is
// split into (plane, oy, ox) in 32-bit arithmetic with FastDiv (every
// tensor here holds fewer than 2^31 elements): with 64-bit division
// that split cost more than the taps.  No shared memory, no atomics.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                   int8_t* __restrict__ idx, unsigned total, int h, int w,
                   bigdl::FastDiv oh, bigdl::FastDiv ow, int kh, int kw,
                   int sh, int sw, int ph, int pw) {
  const unsigned o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const unsigned t = bigdl::div(o, ow);
  const unsigned p = bigdl::div(t, oh);
  const int ox = static_cast<int>(o - t * ow.d);
  const int oy = static_cast<int>(t - p * oh.d);
  const T* plane = x + static_cast<size_t>(p) * h * w;
  const int h0 = oy * sh - ph;
  const int w0 = ox * sw - pw;
  T best = bigdl::from_f32<T>(__int_as_float(0xff800000));  // -inf
  float bv = 0.f;
  int bi = -1;
  for (int dh = 0; dh < kh; ++dh) {
    const int ih = h0 + dh;
    if (ih < 0 || ih >= h) continue;
    for (int dw = 0; dw < kw; ++dw) {
      const int iw = w0 + dw;
      if (iw < 0 || iw >= w) continue;
      const T e = plane[ih * w + iw];
      const float v = bigdl::to_f32(e);
      if (bi < 0 || (!isnan(bv) && (isnan(v) || v > bv))) {
        best = e;
        bv = v;
        bi = dh * kw + dw;
      }
    }
  }
  y[o] = best;
  if (idx != nullptr) idx[o] = static_cast<int8_t>(bi);
}

template <typename T>
cudaError_t launch(const void* x, void* y, void* idx, int nc, int h, int w,
                   int oh, int ow, int kh, int kw, int sh, int sw, int ph,
                   int pw, cudaStream_t stream) {
  const long long total = static_cast<long long>(nc) * oh * ow;
  if (total >= (1ll << 31) || static_cast<long long>(nc) * h * w >= (1ll << 31))
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  maxpool_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int8_t*>(idx),
      static_cast<unsigned>(total), h, w, bigdl::make_fastdiv(oh),
      bigdl::make_fastdiv(ow), kh, kw, sh, sw, ph, pw);
  return cudaGetLastError();
}

}  // namespace

// x is a contiguous [nc, h, w] tensor and y a contiguous [nc, oh, ow]
// tensor, each of fewer than 2^31 elements, of one dtype (0 = f32,
// 1 = bf16, 2 = f16); idx is a contiguous int8 [nc, oh, ow] tensor or
// null (then no index is written), and with an index kh * kw is at most
// 127.  Launches on `stream`, does not synchronise, allocates nothing;
// returns cudaGetLastError().
extern "C" int bigdl_maxpool_fwd(const void* x, void* y, void* idx, int nc,
                                 int h, int w, int oh, int ow, int kh, int kw,
                                 int sh, int sw, int ph, int pw, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx != nullptr && kh * kw > 127) return cudaErrorInvalidValue;
  if (dtype == bigdl::kF32)
    return launch<float>(x, y, idx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, y, idx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kF16)
    return launch<__half>(x, y, idx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
