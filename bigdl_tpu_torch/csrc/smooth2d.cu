// Kernel-weighted window sum over a stack of planes, both directions,
// for Hopper (sm_90a): the smoothing under the subtractive, divisive and
// contrastive normalizations.
//
// Replaces: bigdl_tpu/ops/norm_pallas.py::_smooth_kernel (launched by
// _smooth_pallas through plane_call, pl.pallas_call), in its forward
// (flip false) and its transpose (flip true).
//
// Over each h x w plane of a [B, h, w] stack v, a kh x kw weight table w
// and the pads (top, left) of the window (bottom and right are implied
// by the output's size):
//   out[y][x] = sum_{i, j} v[y-top+i][x-left+j] * w'[i][j]
//   w'[i][j]  = flip ? w[kh-1-i][kw-1-j] : w[i][j]
// zero outside the plane.  The wrapper rounds the weights to the stack's
// dtype first and hands them over in f32, as the Pallas leg casts the
// kernel to the stack's dtype (norm_pallas.py:101).  The taps are summed
// in (i, j) order, the order of the Pallas kernel, in f32, and rounded
// once; multiplies and adds are kept apart (__fmul_rn, __fadd_rn) so that
// no FMA rounds differently from the plain version.
//
// What bounds it on the card: at the contrastive front end's 9 x 9
// Gaussian, operations.  Each output costs 2*kh*kw flops against 4 bytes
// moved in bf16 (v read, out written), 162 flops against 4 bytes, far
// above the ~20 flops a byte at which an H100 turns compute-bound in f32.
//
// Design: the within-channel LRN's tiles (window.cuh).  Each block
// stages its tile's inputs with their kh-1 and kw-1 halo rows and
// columns in f32, and the (flipped, where asked) weights, in shared
// memory, so every tap is two shared-memory reads, a multiply and an
// add, with no bounds checks; 224 x 224 planes split into 64 x 64
// tiles (the last row and column 32 wide).

#include "window.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(bigdl::kTileThreads)
smooth2d_kernel(const T* __restrict__ v, const float* __restrict__ wt,
                T* __restrict__ out, int h, int w, bigdl::TileGrid grid,
                int kh, int kw, int top, int left, int flip) {
  extern __shared__ float smem[];
  float* weights = smem;
  float* tile = smem + kh * kw;
  for (int k = threadIdx.x; k < kh * kw; k += bigdl::kTileThreads)
    weights[k] = wt[flip ? kh * kw - 1 - k : k];
  const bigdl::Tile t = bigdl::block_tile(grid);
  const long long in_base = t.plane * h * w;
  const int cols = t.w + kw - 1;
  bigdl::fill_tile(tile, t.h + kh - 1, cols, t.y0 - top, t.x0 - left, h, w,
                   [&](int r, int c) { return bigdl::to_f32(v[in_base + r * w + c]); });
  const long long out_base = t.plane * grid.out_h * grid.out_w;
  for (int o = threadIdx.x; o < t.h * t.w; o += bigdl::kTileThreads) {
    const int ty = o / t.w;
    const int tx = o - ty * t.w;
    float acc = -0.f;  // -0 + first tap keeps the first tap's bits
    for (int i = 0; i < kh; ++i) {
      const float* row = tile + (ty + i) * cols + tx;
      const float* wrow = weights + i * kw;
#pragma unroll 4
      for (int j = 0; j < kw; ++j) acc = __fadd_rn(acc, __fmul_rn(row[j], wrow[j]));
    }
    out[out_base + (t.y0 + ty) * grid.out_w + t.x0 + tx] = bigdl::from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* v, const float* wt, void* out, int planes,
                   int h, int w, int out_h, int out_w, int kh, int kw,
                   int top, int left, int flip, cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > bigdl::kMaxWindow || kw > bigdl::kMaxWindow)
    return cudaErrorInvalidValue;
  const bigdl::TileGrid grid = bigdl::make_tile_grid(planes, out_h, out_w);
  const size_t smem = sizeof(float) * (kh * kw + bigdl::tile_floats(grid, kh, kw));
  smooth2d_kernel<T><<<bigdl::tile_blocks(planes, grid), bigdl::kTileThreads,
                       smem, stream>>>(
      static_cast<const T*>(v), wt, static_cast<T*>(out), h, w, grid, kh, kw,
      top, left, flip);
  return cudaGetLastError();
}

}  // namespace

// v is a contiguous [planes, h, w] stack and out a contiguous
// [planes, out_h, out_w] one, of one dtype (0 = f32, 1 = bf16); wt is a
// contiguous f32 [kh, kw] table on the device; top and left are the
// window's first pads.  Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError().
extern "C" int bigdl_smooth2d(const void* v, const void* wt, void* out,
                              int planes, int h, int w, int out_h, int out_w,
                              int kh, int kw, int top, int left, int flip,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(wt);
  if (dtype == bigdl::kF32)
    return launch<float>(v, wf, out, planes, h, w, out_h, out_w, kh, kw, top,
                         left, flip, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(v, wf, out, planes, h, w, out_h, out_w, kh,
                                 kw, top, left, flip, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
