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
// kernel, in f32 from -0.0; multiplies and adds are kept apart
// (__fmul_rn, __fadd_rn) so that no FMA rounds differently from the
// plain version, and the power is expf(p * logf(s)) as there (no fast
// math).  scale is written in x's dtype, as the Pallas output spec does;
// y is computed from the f32 scale and rounded once.
//
// What bounds it on the card: instructions, not bytes.  x is read once
// and y and scale written once, 6 bytes an element in bf16 (0.276 ms at
// the norm2 site, [256,192,56,56]); but each output also takes 25
// separate adds, a full-precision power (some 35 instructions with the
// scale: logf, a multiply, expf) and its share of the staging, about 85
// instructions, some 0.5 ms of the card's issue rate at that site.  f32
// moves twice the bytes and stages twice the chunks.
//
// Design (window.cuh): one block a tile of up to 64 x 64 outputs of one
// plane (a whole plane at 56 x 56).  The block stages the squares of the
// tile's inputs and of its n-1 halo rows and columns into shared memory
// in f32, zero outside the plane, from 16-byte loads of x (stage_map),
// and synchronises once.  Then units of 2 rows x 4 outputs, three a
// thread (160 threads at 56 x 56), consecutive threads on consecutive
// units.  For the norm path's 5 x 5 window (compiled in) a unit loads
// each of its 6 staged rows once, as two 16-byte shared loads, and adds
// it into the 8 sums it feeds: 12 shared loads for 200 adds, where the
// first design made 200 4-byte loads and an integer division an output.
// Any other window up to 32 x 32 runs the same units through a run-time
// loop, 4 values a load sliding along each staged row, in the same
// order.  A unit's x is loaded before its sums, by one 8- or 16-byte
// load a row (from L1 or L2: the block staged it), and y and scale leave
// by one store a row each where rows are 4-aligned.  Registers are
// capped at 40 so that eight blocks share an SM, one staging while
// others sum.
//
// Tried on the card and dropped, all slower at norm2 in f32 and all but
// the last in bf16 too: one unit a thread in 392-thread blocks; two or
// four units a thread; units of 4 rows or of 1 row; and chunks staged
// column by column so that a warp's lanes take chunks of one kind (a
// warp's loads then fall 16 bytes in each of 32 rows).

#include "window.cuh"

namespace {

// output rows of a unit
constexpr int kUnitRows = 2;
// units a thread takes
constexpr int kUnitsPerThread = 3;
// threads a block may take (a 64 x 64 tile holds 512 units)
constexpr int kMaxThreads = bigdl::round_up(512 / kUnitsPerThread, 32);
// blocks an SM should hold, one staging while others sum: caps the
// registers at 40 a thread
constexpr int kMinBlocks = 8;

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
wcl_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
               T* __restrict__ scale, bigdl::WinGrid g, int n, int lo,
               float alpha_n, float neg_beta, bool vec) {
  extern __shared__ __align__(16) float tile[];
  const bigdl::Tile t = bigdl::block_tile(g);
  const long long base = t.plane * g.h * g.w;
  float* const dst[1] = {tile};
  const T* const src[1] = {x + base};
  bigdl::stage_map(dst, g.rows, g.cols, src, g.h, g.w, t.y0 - lo, t.x0 - lo,
                   [](const float (&a)[1], float (&b)[1]) {
                     b[0] = __fmul_rn(a[0], a[0]);
                   });
  __syncthreads();

  bigdl::for_each_unit(g, t, kUnitRows, [&](int ty0, int tx0) {
    const int nq = min(4, t.w - tx0);
    // the unit's x, loaded before its sums so that the loads are in
    // flight while they run
    const long long off0 =
        base + static_cast<long long>(t.y0 + ty0) * g.w + t.x0 + tx0;
    float xv[kUnitRows][4];
#pragma unroll
    for (int a = 0; a < kUnitRows; ++a)
      if (ty0 + a < t.h) bigdl::load4(xv[a], x + off0 + a * g.w, nq, vec);
    float acc[kUnitRows][4];
#pragma unroll
    for (int a = 0; a < kUnitRows; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = -0.f;
    bigdl::unit_sums<K, kUnitRows>(acc, tile + ty0 * g.cols + tx0, g.cols, n);
#pragma unroll
    for (int a = 0; a < kUnitRows; ++a) {
      if (ty0 + a >= t.h) break;
      const long long off = off0 + a * g.w;
      float s[4], yv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[q] = __fadd_rn(1.f, __fmul_rn(acc[a][q], alpha_n));
        yv[q] = __fmul_rn(xv[a][q], bigdl::pow_p(s[q], neg_beta));
      }
      bigdl::store4(y + off, yv, nq, vec);
      bigdl::store4(scale + off, s, nq, vec);
    }
  });
}

template <typename T, int K>
cudaError_t launch_as(const void* x, void* y, void* scale, int planes, int h,
                      int w, int size, int lo, float alpha_n, float neg_beta,
                      cudaStream_t stream) {
  const bigdl::WinGrid g = bigdl::make_win_grid(planes, h, w, size, kUnitRows);
  const size_t smem = sizeof(float) * g.rows * g.cols;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wcl_fwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec = w % 4 == 0 && bigdl::aligned4<T>(x) &&
                   bigdl::aligned4<T>(y) && bigdl::aligned4<T>(scale);
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(planes) * g.tiles_h * g.tiles_w);
  const int threads =
      bigdl::unit_threads(g, kUnitRows, kUnitsPerThread, kMaxThreads);
  wcl_fwd_kernel<T, K><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(scale),
      g, size, lo, alpha_n, neg_beta, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* y, void* scale, int planes, int h,
                   int w, int size, int lo, float alpha_n, float neg_beta,
                   cudaStream_t stream) {
  if (size < 1 || size > bigdl::kMaxWindow) return cudaErrorInvalidValue;
  if (size == 5)
    return launch_as<T, 5>(x, y, scale, planes, h, w, size, lo, alpha_n,
                           neg_beta, stream);
  return launch_as<T, 0>(x, y, scale, planes, h, w, size, lo, alpha_n,
                         neg_beta, stream);
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
