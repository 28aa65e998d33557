// Tie-split max-pool backward for Hopper (sm_90a): each window's
// gradient is split in equal parts among every tap that ties for its
// maximum, so the gradient mass is conserved.
//
// Replaces: bigdl_tpu/ops/pool_pallas.py::_tie_bwd_kernel (launched by
// _tie_bwd_pallas through ops/pallas_util.py::plane_call,
// pl.pallas_call).
//
// In padded coordinates (ph, pw on the low side), the Pallas kernel
// computes per plane, as this launcher does in two passes:
//   1. per output o: cnt[o] = number of taps equal to y[o], the taps
//      outside the plane reading -inf as the JAX pad does (so they count
//      in a window whose maximum is -inf); wgt[o] = gy[o] / cnt[o] where
//      cnt[o] > 0, else 0 (the Pallas kernel's form: a NaN maximum
//      matches nothing and gets 0);
//   2. per input q = (qh, qw): with a = q / s and r = q % s per axis, the
//      windows that hold q are o = a - j for the taps d = r + s*j < k;
//      dx[q] = sum of wgt[o] over those windows with x[q] == y[o], jh
//      outer and jw inner, both ascending (the Pallas residue order).
// wgt is f32 scratch; the sum runs in f32 and is rounded once to the
// input dtype, as the plain version does, so the two agree bit for bit.
// Windows past the output grid (the bottom-row residue shortfall) are
// skipped: no read leaves [0, oh) x [0, ow).
//
// What bounds it on the card: bytes.  x, y and gy are read and dx
// written once (Inception-v1's pool1 at batch 256 in bf16: 411 + 103 +
// 103 MB in, 411 MB out, 0.307 ms at 3.35 TB/s); the f32 scratch adds a
// write and a read of 205 MB each for pool1.  Counting in a
// pass of its own keeps the count at 9 compares per output instead of
// repeating it for each of the up to 9 inputs that read that window.
//
// Design: one thread per output element in pass 1 and per input element
// in pass 2, consecutive threads on consecutive elements of a plane.
// Index arithmetic is 32-bit with FastDiv, as in maxpool_fwd.cu.  No
// shared memory, no atomics: pass 2 gathers, so every element has one
// fixed order of summation.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
tie_weight_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const T* __restrict__ gy, float* __restrict__ wgt,
                  unsigned total, int h, int w, bigdl::FastDiv oh,
                  bigdl::FastDiv ow, int kh, int kw, int sh, int sw, int ph,
                  int pw) {
  const unsigned o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const unsigned t = bigdl::div(o, ow);
  const unsigned p = bigdl::div(t, oh);
  const int ox = static_cast<int>(o - t * ow.d);
  const int oy = static_cast<int>(t - p * oh.d);
  const T* plane = x + static_cast<size_t>(p) * h * w;
  const int h0 = oy * sh - ph;
  const int w0 = ox * sw - pw;
  const float yv = bigdl::to_f32(y[o]);
  const bool y_neg_inf = yv == __int_as_float(0xff800000);
  int cnt = 0;
  for (int dh = 0; dh < kh; ++dh) {
    const int ih = h0 + dh;
    const bool row = ih >= 0 && ih < h;
    for (int dw = 0; dw < kw; ++dw) {
      const int iw = w0 + dw;
      if (row && iw >= 0 && iw < w)
        cnt += bigdl::to_f32(plane[ih * w + iw]) == yv;
      else
        cnt += y_neg_inf;
    }
  }
  wgt[o] = cnt > 0 ? __fdiv_rn(bigdl::to_f32(gy[o]), static_cast<float>(cnt)) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tie_gather_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const float* __restrict__ wgt, T* __restrict__ dx,
                  unsigned total, bigdl::FastDiv h, bigdl::FastDiv w, int oh,
                  int ow, int kh, int kw, bigdl::FastDiv sh,
                  bigdl::FastDiv sw, int ph, int pw) {
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= total) return;
  const unsigned t = bigdl::div(q, w);
  const unsigned p = bigdl::div(t, h);
  const size_t plane = static_cast<size_t>(p) * oh * ow;
  const T* yp = y + plane;
  const float* wp = wgt + plane;
  const float xv = bigdl::to_f32(x[q]);
  const unsigned qh = t - p * h.d + ph, qw = q - t * w.d + pw;
  const int ah = bigdl::div(qh, sh), rh = qh - ah * sh.d;
  const int aw = bigdl::div(qw, sw), rw = qw - aw * sw.d;
  float s = 0.f;
  for (int dh = rh, oy = ah; dh < kh && oy >= 0; dh += sh.d, --oy) {
    if (oy >= oh) continue;
    for (int dw = rw, ox = aw; dw < kw && ox >= 0; dw += sw.d, --ox) {
      if (ox >= ow) continue;
      const int o = oy * ow + ox;
      if (xv == bigdl::to_f32(yp[o])) s = __fadd_rn(s, wp[o]);
    }
  }
  dx[q] = bigdl::from_f32<T>(s);
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* gy, void* wgt,
                   void* dx, int nc, int h, int w, int oh, int ow, int kh,
                   int kw, int sh, int sw, int ph, int pw,
                   cudaStream_t stream) {
  const long long outs = static_cast<long long>(nc) * oh * ow;
  const long long ins = static_cast<long long>(nc) * h * w;
  if (outs >= (1ll << 31) || ins >= (1ll << 31)) return cudaErrorInvalidValue;
  tie_weight_kernel<T><<<static_cast<unsigned>((outs + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(gy), static_cast<float*>(wgt),
      static_cast<unsigned>(outs), h, w, bigdl::make_fastdiv(oh),
      bigdl::make_fastdiv(ow), kh, kw, sh, sw, ph, pw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tie_gather_kernel<T><<<static_cast<unsigned>((ins + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const float*>(wgt), static_cast<T*>(dx),
      static_cast<unsigned>(ins), bigdl::make_fastdiv(h), bigdl::make_fastdiv(w),
      oh, ow, kh, kw, bigdl::make_fastdiv(sh), bigdl::make_fastdiv(sw), ph, pw);
  return cudaGetLastError();
}

}  // namespace

// x and dx are contiguous [nc, h, w] tensors, y and gy contiguous
// [nc, oh, ow] tensors, each of fewer than 2^31 elements, all of one
// dtype (0 = f32, 1 = bf16, 2 = f16); wgt is contiguous f32 [nc, oh, ow]
// scratch.  Launches both passes on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError().
extern "C" int bigdl_maxpool_tie_bwd(const void* x, const void* y,
                                     const void* gy, void* wgt, void* dx,
                                     int nc, int h, int w, int oh, int ow,
                                     int kh, int kw, int sh, int sw, int ph,
                                     int pw, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(x, y, gy, wgt, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, y, gy, wgt, dx, nc, h, w, oh, ow, kh, kw, sh, sw,
                                 ph, pw, s);
  if (dtype == bigdl::kF16)
    return launch<__half>(x, y, gy, wgt, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
