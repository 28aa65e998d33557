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
// What bounds it on the card: bytes (x read once, y written once): at
// the training head ([256,1024,7,7] bf16) 26 MB, 0.0078 ms at 3.35 TB/s;
// at the serve head ([8,1024,7,7] f32) 1.6 MB, half a microsecond, where
// launch and load latency bound it instead.
//
// Two kernels, chosen on the host by the plane's size; both are
// hand-written, both keep the (dh, dw) order of the taps and the
// rounding points, so both give the plain version's bits.
//
// Planes of up to kStageBytes (every geometry of the registered models:
// the 7x7 and 8x8 heads, the aux heads' 5x5 s3 on 14x14, the 3x3 branch
// pools): avg_pool_fwd_staged.  Each CTA owns a group of consecutive
// planes, whose input is one contiguous span: it copies the span into
// shared memory with 16-byte cp.async copies, all issued before the
// first wait, and element loads for the partial 16-byte chunks at its
// two ends (a span need not start or end on 16 bytes).  The span keeps
// its offset from 16 bytes in shared memory, so every full chunk lands
// aligned (bigdl::stage_span of pool_stage.cuh, which the max-pool
// backwards share).  Then its threads walk the group's outputs, consecutive
// threads on consecutive outputs (coalesced stores), each summing its
// window from shared memory.  The group is sized so that a launch has
// about kFillBlocks CTAs where the planes allow it (the serve head: 8
// planes a CTA, 1024 CTAs), and holds at most kStageBytes.
//
// Larger planes: avg_pool_fwd_kernel, one thread per output element,
// consecutive threads on consecutive outputs of a plane, summing in f32
// in registers from global memory.  No atomics in either.

#include "pool_stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageThreads = 128;
// the most input a staged CTA holds, and the CTAs a launch aims at
// (about eight for each of the card's 132 SMs)
constexpr int kStageBytes = 12288;
constexpr long long kFillBlocks = 1024;

// Sum over the kh x kw window at (oy, ox) of one plane, taps outside
// the plane adding 0, in (dh, dw) order from -0.0 (so the sum equals one
// that starts from its first tap, -0.0 included), kept apart from FMA
// contraction.
template <typename T>
__device__ __forceinline__ float window_sum(const T* plane, int h, int w,
                                            int oy, int ox, int kh, int kw,
                                            int sh, int sw, int ph, int pw) {
  const int h0 = oy * sh - ph;
  const int w0 = ox * sw - pw;
  float s = -0.f;
  for (int dh = 0; dh < kh; ++dh) {
    const int ih = h0 + dh;
    const bool row = ih >= 0 && ih < h;
    for (int dw = 0; dw < kw; ++dw) {
      const int iw = w0 + dw;
      const float v = (row && iw >= 0 && iw < w) ? bigdl::to_f32(plane[ih * w + iw]) : 0.f;
      s = __fadd_rn(s, v);
    }
  }
  return s;
}

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
  const float s = window_sum(plane, h, w, oy, ox, kh, kw, sh, sw, ph, pw);
  y[idx] = bigdl::from_f32<T>(__fmul_rn(s, inv[oy * ow + ox]));
}

template <typename T>
__global__ void __launch_bounds__(kStageThreads)
avg_pool_fwd_staged(const T* __restrict__ x, const float* __restrict__ inv,
                    T* __restrict__ y, int nc, int group, int h, int w,
                    int oh, int ow, int kh, int kw, int sh, int sw, int ph,
                    int pw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int hw = h * w;
  const long long p0 = static_cast<long long>(blockIdx.x) * group;
  const int planes = static_cast<int>(min(static_cast<long long>(group), nc - p0));
  const int n = planes * hw;  // elements of the span
  const T* src = x + p0 * hw;
  // the span starts `lead` elements past a 16-byte boundary and sits at
  // tile[lead ..]
  const int lead = bigdl::span_lead(src);
  bigdl::stage_span(tile, src, n, lead);
  bigdl::cp_commit();
  bigdl::cp_wait<0>();
  __syncthreads();

  const int outs = oh * ow;
  T* yb = y + p0 * outs;
  for (int o = threadIdx.x; o < planes * outs; o += kStageThreads) {
    const int pl = o / outs;
    const int r = o - pl * outs;
    const int oy = r / ow;
    const int ox = r - oy * ow;
    const float s = window_sum(tile + lead + pl * hw, h, w, oy, ox, kh, kw,
                               sh, sw, ph, pw);
    yb[o] = bigdl::from_f32<T>(__fmul_rn(s, inv[r]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* inv, void* y, int nc, int h,
                   int w, int oh, int ow, int kh, int kw, int sh, int sw,
                   int ph, int pw, cudaStream_t stream) {
  const int plane_bytes = h * w * static_cast<int>(sizeof(T));
  if (plane_bytes > 0 && plane_bytes <= kStageBytes) {
    const long long fill = (nc + kFillBlocks - 1) / kFillBlocks;
    const int group = static_cast<int>(
        fill < kStageBytes / plane_bytes ? fill : kStageBytes / plane_bytes);
    const unsigned blocks = static_cast<unsigned>((nc + group - 1) / group);
    avg_pool_fwd_staged<T><<<blocks, kStageThreads, group * plane_bytes + 16,
                             stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(inv),
        static_cast<T*>(y), nc, group, h, w, oh, ow, kh, kw, sh, sw, ph, pw);
    return cudaGetLastError();
  }
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
