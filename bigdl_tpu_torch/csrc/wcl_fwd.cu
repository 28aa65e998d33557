// Within-channel LRN forward for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/lrn_pallas.py::_wcl_fwd_kernel (launched by
// _wcl_fwd_pallas through plane_call, pl.pallas_call).
//
// Over each h x w plane of NCHW x, with an n x n window under the Torch
// pads (lo, hi) = ((n-1)/2, n-1-lo), zero outside the plane:
//   scale = 1 + (alpha/n^2) * sum_{dh, dw} x[y-lo+dh][x-lo+dw]^2
//   y     = x * scale^-beta      (rsqrt when beta == 0.5)
// The squares are summed in (dh, dw) order, the order of the Pallas
// kernel, in f32; multiplies and adds are kept apart (__fmul_rn,
// __fadd_rn) so that no FMA rounds differently from the plain version.
// scale is written in x's dtype, as the Pallas output spec does; y is
// computed from the f32 scale and rounded once.
//
// What bounds it on the card: bytes.  x is read once, y and scale are
// written once (6 bytes an element in bf16); n^2 + 6 flops an element is
// below the ~20 flops a byte at which an H100 turns compute-bound in f32.
//
// Design: one block per tile of up to 64 x 64 outputs of a plane
// (window.cuh), a whole plane at 56 x 56.  The block squares the tile's
// inputs and its n-1 halo rows and columns once into shared memory, zero
// outside the plane, so the n^2 taps of each output are shared-memory
// reads with no bounds checks; its 256 threads then walk the tile's
// outputs, a dozen or more each.

#include "window.cuh"

namespace {

__device__ __forceinline__ float pow_p(float s, float p) {
  return (p == -0.5f) ? rsqrtf(s) : expf(__fmul_rn(p, logf(s)));
}

template <typename T>
__global__ void __launch_bounds__(bigdl::kTileThreads)
wcl_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
               T* __restrict__ scale, bigdl::TileGrid grid, int size, int lo,
               float alpha_n, float neg_beta) {
  extern __shared__ float tile[];
  const int h = grid.out_h, w = grid.out_w;
  const bigdl::Tile t = bigdl::block_tile(grid);
  const long long base = t.plane * h * w;
  const int cols = t.w + size - 1;
  bigdl::fill_tile(tile, t.h + size - 1, cols, t.y0 - lo, t.x0 - lo, h, w,
                   [&](int r, int c) {
                     const float v = bigdl::to_f32(x[base + r * w + c]);
                     return __fmul_rn(v, v);
                   });
  for (int o = threadIdx.x; o < t.h * t.w; o += bigdl::kTileThreads) {
    const int ty = o / t.w;
    const int tx = o - ty * t.w;
    const float ws = bigdl::tile_sum(tile, cols, ty, tx, size, size);
    const float s = __fadd_rn(1.f, __fmul_rn(ws, alpha_n));
    const long long off = base + (t.y0 + ty) * w + t.x0 + tx;
    y[off] = bigdl::from_f32<T>(__fmul_rn(bigdl::to_f32(x[off]), pow_p(s, neg_beta)));
    scale[off] = bigdl::from_f32<T>(s);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, void* scale, int planes, int h,
                   int w, int size, int lo, float alpha_n, float neg_beta,
                   cudaStream_t stream) {
  if (size < 1 || size > bigdl::kMaxWindow) return cudaErrorInvalidValue;
  const bigdl::TileGrid grid = bigdl::make_tile_grid(planes, h, w);
  const size_t smem = sizeof(float) * bigdl::tile_floats(grid, size, size);
  wcl_fwd_kernel<T><<<bigdl::tile_blocks(planes, grid), bigdl::kTileThreads,
                      smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(scale),
      grid, size, lo, alpha_n, neg_beta);
  return cudaGetLastError();
}

}  // namespace

// x, y and scale are contiguous [planes, h, w] tensors of one dtype
// (0 = f32, 1 = bf16); lo is the window's top and left pad, alpha_n is
// alpha / size^2 and neg_beta is -beta.  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError().
extern "C" int bigdl_wcl_fwd(const void* x, void* y, void* scale, int planes,
                             int h, int w, int size, int lo, float alpha_n,
                             float neg_beta, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(x, y, scale, planes, h, w, size, lo, alpha_n, neg_beta, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, y, scale, planes, h, w, size, lo, alpha_n,
                                 neg_beta, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
