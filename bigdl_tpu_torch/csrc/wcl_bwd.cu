// Within-channel LRN backward for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/lrn_pallas.py::_wcl_bwd_kernel (launched by
// _wcl_bwd_pallas through plane_call, pl.pallas_call), together with the
// elementwise t that _wcl_bwd_pallas forms in XLA before the call.
//
// Over each h x w plane of NCHW x, the forward's scale and the output
// gradient g, with the n x n window transposed (pads (hi, lo), exact for
// even windows too), zero outside the plane:
//   t[m]  = g[m] * x[m] * scale[m]^(-beta-1)
//   dx[m] = g[m] * scale[m]^-beta
//           - (2*alpha*beta/n^2) * x[m] * sum_{dh, dw} t[m-hi+dh][m-hi+dw]
// The sum runs over the taps in (dh, dw) order, the order of the Pallas
// kernel, in f32; powers are exp(p * log(scale)), rsqrt when p == -0.5
// (lrn_pallas.py::_pow).  Multiplies and adds are kept apart (__fmul_rn,
// __fadd_rn, __fsub_rn) so that no FMA rounds differently from the plain
// version.
//
// What bounds it on the card: bytes.  x, scale and g are read once and dx
// is written once (8 bytes an element in bf16); n^2 + 12 flops and two
// exp/log pairs an element stay below the card's f32 rate.
//
// Design: the forward's tiles (window.cuh).  Each block forms t for its
// tile and halo once, into shared memory, from x, scale and g, so no t is
// written to or read back from device memory and no tap recomputes a
// power: a halo element's t is formed again only by the (at most three)
// tiles that share it.  The n^2 taps of each output are shared-memory
// reads with no bounds checks; its own x, scale and g come from L1.
// A tile is a whole plane at 56 x 56, so no halo is formed twice.

#include "window.cuh"

namespace {

__device__ __forceinline__ float pow_p(float s, float p) {
  return (p == -0.5f) ? rsqrtf(s) : expf(__fmul_rn(p, logf(s)));
}

template <typename T>
__global__ void __launch_bounds__(bigdl::kTileThreads)
wcl_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               const T* __restrict__ g, T* __restrict__ dx,
               bigdl::TileGrid grid, int size, int hi, float c2, float p0,
               float p1) {
  extern __shared__ float tile[];
  const int h = grid.out_h, w = grid.out_w;
  const bigdl::Tile t = bigdl::block_tile(grid);
  const long long base = t.plane * h * w;
  const int cols = t.w + size - 1;
  bigdl::fill_tile(tile, t.h + size - 1, cols, t.y0 - hi, t.x0 - hi, h, w,
                   [&](int r, int c) {
                     const long long off = base + r * w + c;
                     const float gx = __fmul_rn(bigdl::to_f32(g[off]),
                                                bigdl::to_f32(x[off]));
                     return __fmul_rn(gx, pow_p(bigdl::to_f32(scale[off]), p1));
                   });
  for (int o = threadIdx.x; o < t.h * t.w; o += bigdl::kTileThreads) {
    const int ty = o / t.w;
    const int tx = o - ty * t.w;
    const float ts = bigdl::tile_sum(tile, cols, ty, tx, size, size);
    const long long off = base + (t.y0 + ty) * w + t.x0 + tx;
    const float a = __fmul_rn(bigdl::to_f32(g[off]), pow_p(bigdl::to_f32(scale[off]), p0));
    const float v = __fsub_rn(a, __fmul_rn(__fmul_rn(c2, bigdl::to_f32(x[off])), ts));
    dx[off] = bigdl::from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* g, void* dx,
                   int planes, int h, int w, int size, int hi, float c2,
                   float p0, float p1, cudaStream_t stream) {
  if (size < 1 || size > bigdl::kMaxWindow) return cudaErrorInvalidValue;
  const bigdl::TileGrid grid = bigdl::make_tile_grid(planes, h, w);
  const size_t smem = sizeof(float) * bigdl::tile_floats(grid, size, size);
  wcl_bwd_kernel<T><<<bigdl::tile_blocks(planes, grid), bigdl::kTileThreads,
                      smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), grid, size, hi, c2, p0,
      p1);
  return cudaGetLastError();
}

}  // namespace

// x, scale, g and dx are contiguous [planes, h, w] tensors of one dtype
// (0 = f32, 1 = bf16); hi is the transposed window's top and left pad,
// c2 is 2*alpha*beta/size^2, p0 is -beta and p1 is -beta-1.  Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError().
extern "C" int bigdl_wcl_bwd(const void* x, const void* scale, const void* g,
                             void* dx, int planes, int h, int w, int size,
                             int hi, float c2, float p0, float p1, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(x, scale, g, dx, planes, h, w, size, hi, c2, p0, p1, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, scale, g, dx, planes, h, w, size, hi, c2,
                                 p0, p1, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
