// Torch-semantics average-pool backward for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/pool_pallas.py::_avg_bwd_kernel (launched by
// _avg_bwd_pallas through ops/pallas_util.py::plane_call,
// pl.pallas_call).
//
// The forward is a strided window sum times a divisor map, so its
// transpose is a sum of the out-grid weights wgt = gy * inv (the wrapper
// forms wgt) over the windows that hold each input position.  In padded
// coordinates q = i + pad, per axis, the windows o with
// o*s <= q < o*s + k are o = ceil((q-k+1)/s) .. floor(q/s), clipped to
// [0, out):
//   dx[p, ih, iw] = sum_{oy} sum_{ox} wgt[p, oy, ox]   (oy outer, ox inner,
//                                                      both ascending)
// The Pallas kernel computes the same sum by residue classes of the
// strides on a dilated plane and interleaves them; this kernel gathers
// instead, which needs no atomics and gives every element one fixed
// order, the order of the plain version (dilate, edge-pad, stride-1
// window sum).  Positions in the ceil-overflow padding are never
// written; a floor-mode tail that no window reaches gets 0.  General
// kernel size, stride and asymmetric padding, summed in f32.
//
// What bounds it on the card: by its work, bytes.  wgt is read and dx
// written once (the Inception head at batch 256 in bf16: 0.5 MB in,
// 25.7 MB out, about 7.7 us at 3.35 TB/s).  At the head's shape the
// per-element index arithmetic (64-bit divisions and the window
// bounds) costs more than the bytes, so the kernel is instruction-bound
// there; a thread that keeps one position's window bounds across many
// planes would amortize it.
//
// Design: one thread per dx element, consecutive threads on consecutive
// elements of a plane, so stores are contiguous.  At the head (7x7
// window, 1x1 output) the 49 threads of a plane read the same wgt value,
// which L1 broadcasts.  No shared memory, no atomics.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int first_window(int q, int k, int s) {
  const int lo = q - k + 1;
  return lo <= 0 ? 0 : (lo + s - 1) / s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
avg_pool_bwd_kernel(const T* __restrict__ wgt, T* __restrict__ dx,
                    long long total, int h, int w, int oh, int ow, int kh,
                    int kw, int sh, int sw, int ph, int pw) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int iw = static_cast<int>(idx % w);
  const long long t = idx / w;
  const int ih = static_cast<int>(t % h);
  const T* plane = wgt + (t / h) * static_cast<long long>(oh) * ow;
  const int qh = ih + ph;
  const int qw = iw + pw;
  const int oy0 = first_window(qh, kh, sh);
  const int oy1 = min(qh / sh, oh - 1);
  const int ox0 = first_window(qw, kw, sw);
  const int ox1 = min(qw / sw, ow - 1);
  float s = 0.f;
  for (int oy = oy0; oy <= oy1; ++oy)
    for (int ox = ox0; ox <= ox1; ++ox)
      s = __fadd_rn(s, bigdl::to_f32(plane[oy * ow + ox]));
  dx[idx] = bigdl::from_f32<T>(s);
}

template <typename T>
cudaError_t launch(const void* wgt, void* dx, int nc, int h, int w, int oh,
                   int ow, int kh, int kw, int sh, int sw, int ph, int pw,
                   cudaStream_t stream) {
  const long long total = static_cast<long long>(nc) * h * w;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  avg_pool_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(wgt), static_cast<T*>(dx), total, h, w, oh, ow,
      kh, kw, sh, sw, ph, pw);
  return cudaGetLastError();
}

}  // namespace

// wgt is a contiguous [nc, oh, ow] tensor and dx a contiguous [nc, h, w]
// tensor of one dtype (0 = f32, 1 = bf16); ph, pw are the low-side
// paddings.  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError().
extern "C" int bigdl_avg_pool_bwd(const void* wgt, void* dx, int nc, int h,
                                  int w, int oh, int ow, int kh, int kw,
                                  int sh, int sw, int ph, int pw, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(wgt, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(wgt, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
