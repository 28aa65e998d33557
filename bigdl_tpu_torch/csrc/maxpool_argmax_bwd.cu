// Argmax-index max-pool backward for Hopper (sm_90a): each output
// gradient goes to the one tap that won its window, read from the int8
// tap index the forward saved; x and y are never read.
//
// Replaces: bigdl_tpu/ops/pooling_pallas.py::_bwd_kernel (launched by
// _bwd_impl, pl.pallas_call).
//
// In padded coordinates (ph, pw on the low side), for every input
// q = (qh, qw) with a = q / s and r = q % s per axis, the windows that
// hold q are o = a - j for the taps d = r + s*j < k, and
//   dx[q] = sum over those windows with idx[o] == dh * kw + dw of gy[o]
// jh outer and jw inner, both ascending (the Pallas residue order),
// summed in f32 and rounded once to gy's dtype, as the plain version
// does, so the two agree bit for bit.  A select, not the Pallas
// kernel's mask-multiply: the multiply was a Mosaic workaround that
// lets a non-finite gy leak NaN into the window's other taps (0 * inf);
// here an inf gradient stays on its winner.  The Pallas launcher pads
// its halo to n_tiles + 1 row blocks for the bottom-row residue
// shortfall (lh > oh + jh_max); this kernel skips every window past the
// output grid, so no read leaves [0, oh) x [0, ow).  Index -1 (a window
// with no tap in the plane) matches no tap.
//
// What bounds it on the card: bytes.  gy (16-bit) and idx (int8) are
// read and dx written once (Inception-v1's pool1 at batch 256 in bf16:
// 103 + 51 MB in, 411 MB out, 0.169 ms at 3.35 TB/s).
//
// Design: one thread per dx element, consecutive threads on consecutive
// elements of a plane, so stores are contiguous.  Index arithmetic is
// 32-bit with FastDiv, as in maxpool_fwd.cu.  No shared memory, no
// atomics: a gather gives every element one fixed order of summation.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
argmax_bwd_kernel(const T* __restrict__ gy, const int8_t* __restrict__ idx,
                  T* __restrict__ dx, unsigned total, bigdl::FastDiv h,
                  bigdl::FastDiv w, int oh, int ow, int kh, int kw,
                  bigdl::FastDiv sh, bigdl::FastDiv sw, int ph, int pw) {
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= total) return;
  const unsigned t = bigdl::div(q, w);
  const unsigned p = bigdl::div(t, h);
  const size_t plane = static_cast<size_t>(p) * oh * ow;
  const T* gp = gy + plane;
  const int8_t* ip = idx + plane;
  const unsigned qh = t - p * h.d + ph, qw = q - t * w.d + pw;
  const int ah = bigdl::div(qh, sh), rh = qh - ah * sh.d;
  const int aw = bigdl::div(qw, sw), rw = qw - aw * sw.d;
  float s = 0.f;
  for (int dh = rh, oy = ah; dh < kh && oy >= 0; dh += sh.d, --oy) {
    if (oy >= oh) continue;
    for (int dw = rw, ox = aw; dw < kw && ox >= 0; dw += sw.d, --ox) {
      if (ox >= ow) continue;
      const int o = oy * ow + ox;
      if (ip[o] == dh * kw + dw) s = __fadd_rn(s, bigdl::to_f32(gp[o]));
    }
  }
  dx[q] = bigdl::from_f32<T>(s);
}

template <typename T>
cudaError_t launch(const void* gy, const void* idx, void* dx, int nc, int h,
                   int w, int oh, int ow, int kh, int kw, int sh, int sw,
                   int ph, int pw, cudaStream_t stream) {
  const long long total = static_cast<long long>(nc) * h * w;
  if (total >= (1ll << 31) || static_cast<long long>(nc) * oh * ow >= (1ll << 31))
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  argmax_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(gy), static_cast<const int8_t*>(idx),
      static_cast<T*>(dx), static_cast<unsigned>(total), bigdl::make_fastdiv(h),
      bigdl::make_fastdiv(w), oh, ow, kh, kw, bigdl::make_fastdiv(sh),
      bigdl::make_fastdiv(sw), ph, pw);
  return cudaGetLastError();
}

}  // namespace

// gy is a contiguous [nc, oh, ow] tensor and dx a contiguous [nc, h, w]
// tensor, each of fewer than 2^31 elements, of one dtype (0 = f32,
// 1 = bf16, 2 = f16); idx is a contiguous int8 [nc, oh, ow] tensor.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError().
extern "C" int bigdl_maxpool_argmax_bwd(const void* gy, const void* idx,
                                        void* dx, int nc, int h, int w,
                                        int oh, int ow, int kh, int kw,
                                        int sh, int sw, int ph, int pw,
                                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(gy, idx, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(gy, idx, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kF16)
    return launch<__half>(gy, idx, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
