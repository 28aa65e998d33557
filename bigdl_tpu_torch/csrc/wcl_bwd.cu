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
// kernel, in f32 from -0.0 (so a first tap of -0 keeps its sign); powers
// are expf(p * logf(scale)), rsqrt when p == -0.5 (lrn_pallas.py::_pow),
// with no fast math.  Multiplies and adds are kept apart (__fmul_rn,
// __fadd_rn, __fsub_rn) so that no FMA rounds differently from the plain
// version.  scale is the forward's, rounded to x's dtype.
//
// What bounds it on the card: instructions, not bytes.  x, scale and g
// are read once and dx written once, 8 bytes an element in bf16 (0.368
// ms at the norm2 site, [256,192,56,56]); but each element also takes
// two full-precision powers of its scale (one logf and two expf, some 50
// instructions), 25 separate adds and its share of the staging, about
// 100 instructions an output, some 0.6 ms of the card's issue rate at
// that site.  The staging is the larger part and runs at about half the
// issue rate: a warp's lanes take 16-byte chunks of two kinds (a chunk
// inside the plane carries eight elements' powers, one at an edge a few
// zeros), and the 1.75 chunks inside the plane a thread leave some
// threads waiting at the barrier.
//
// Design (window.cuh): one block a tile of up to 64 x 64 outputs of one
// plane, a whole plane at 56 x 56, so no halo's t is formed twice there.
// The block stages two tiles in f32 from 16-byte loads of x, scale and g
// (stage_map): t over the tile and its n-1 halo rows and columns, zero
// outside the plane, and beside it a = g * scale^-beta, the two powers of
// an element sharing one logf.  So no t is written to or read back from
// device memory, no tap forms a power, and each element's powers are
// formed once.  Then units of 2 rows x 4 outputs, two a thread (224
// threads at 56 x 56), sum t as the forward sums x^2: the 5 x 5 window
// compiled in, 12 16-byte shared loads for 200 adds; any other window up
// to 32 x 32 by the run-time loop.  Each unit row reads its a by two
// 8-byte shared loads and its x by one 8- or 16-byte load (from L1 or L2:
// the block staged it), and stores dx by one store where rows are
// 4-aligned.  Registers are capped at 40 so that six blocks share an SM,
// one staging while others sum.
//
// Tried on the card and dropped, all slower at norm2 in f32 and all but
// the last two in bf16 too: one unit a thread in 392-thread blocks;
// units of 4 rows or of 1 row; caps of 48 registers (five blocks an SM)
// or of 32 (spills); staging in two passes, x, scale and g raw (scale 1
// outside the plane, so t = a = +0 there) and then t and a formed by an
// even pass over 4-element quads, x read from shared memory; three units
// a thread; and chunks taken column by column so that a warp's lanes
// share a chunk's kind (a warp's loads then fall 16 bytes in each of 32
// rows).

#include "window.cuh"

namespace {

// output rows of a unit
constexpr int kUnitRows = 2;
// units a thread takes
constexpr int kUnitsPerThread = 2;
// threads a block may take (a 64 x 64 tile holds 512 units)
constexpr int kMaxThreads = bigdl::round_up(512 / kUnitsPerThread, 32);
// blocks an SM should hold, one staging while others sum (two 14.4 KB
// tiles a block at 56 x 56): caps the registers at 40 a thread
constexpr int kMinBlocks = 6;

// The 4 staged values at p, p's float offset mod 4 being `phase`: one
// 16-byte load at phase 0, two 8-byte loads at phase 2, else 4 loads.
__device__ __forceinline__ void staged4(float (&v)[4], const float* p,
                                        int phase) {
  if (phase == 0) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if (phase == 2) {
    const float2 f0 = *reinterpret_cast<const float2*>(p);
    const float2 f1 = *reinterpret_cast<const float2*>(p + 2);
    v[0] = f0.x, v[1] = f0.y, v[2] = f1.x, v[3] = f1.y;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = p[q];
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
wcl_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               const T* __restrict__ g, T* __restrict__ dx, bigdl::WinGrid grid,
               int n, int hi, float c2, float p0, float p1, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* const tt = smem;                          // t
  float* const at = smem + grid.rows * grid.cols;  // a = g * scale^-beta
  const bigdl::Tile t = bigdl::block_tile(grid);
  const long long base = t.plane * grid.h * grid.w;
  float* const dst[2] = {tt, at};
  const T* const src[3] = {x + base, scale + base, g + base};
  bigdl::stage_map(dst, grid.rows, grid.cols, src, grid.h, grid.w, t.y0 - hi,
                   t.x0 - hi, [p0, p1](const float (&v)[3], float (&b)[2]) {
                     const float log_s = logf(v[1]);
                     b[0] = __fmul_rn(__fmul_rn(v[2], v[0]),
                                      bigdl::pow_from_log(v[1], log_s, p1));
                     b[1] = __fmul_rn(v[2],
                                      bigdl::pow_from_log(v[1], log_s, p0));
                   });
  __syncthreads();

  const int phase = hi % 4;
  bigdl::for_each_unit(grid, t, kUnitRows, [&](int ty0, int tx0) {
    const int nq = min(4, t.w - tx0);
    float acc[kUnitRows][4];
#pragma unroll
    for (int a = 0; a < kUnitRows; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = -0.f;
    bigdl::unit_sums<K, kUnitRows>(acc, tt + ty0 * grid.cols + tx0,
                                   grid.cols, n);
#pragma unroll
    for (int a = 0; a < kUnitRows; ++a) {
      if (ty0 + a >= t.h) break;
      const long long off =
          base + static_cast<long long>(t.y0 + ty0 + a) * grid.w + t.x0 + tx0;
      float xv[4], av[4], v[4];
      bigdl::load4(xv, x + off, nq, vec);
      staged4(av, at + (ty0 + a + hi) * grid.cols + tx0 + hi, phase);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = __fsub_rn(av[q], __fmul_rn(__fmul_rn(c2, xv[q]), acc[a][q]));
      bigdl::store4(dx + off, v, nq, vec);
    }
  });
}

template <typename T, int K>
cudaError_t launch_as(const void* x, const void* scale, const void* g,
                      void* dx, int planes, int h, int w, int size, int hi,
                      float c2, float p0, float p1, cudaStream_t stream) {
  const bigdl::WinGrid grid =
      bigdl::make_win_grid(planes, h, w, size, kUnitRows);
  const size_t smem = 2 * sizeof(float) * grid.rows * grid.cols;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wcl_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec = w % 4 == 0 && bigdl::aligned4<T>(x) &&
                   bigdl::aligned4<T>(dx);
  const unsigned blocks = static_cast<unsigned>(
      static_cast<long long>(planes) * grid.tiles_h * grid.tiles_w);
  const int threads =
      bigdl::unit_threads(grid, kUnitRows, kUnitsPerThread, kMaxThreads);
  wcl_bwd_kernel<T, K><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), grid, size, hi, c2, p0,
      p1, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* g, void* dx,
                   int planes, int h, int w, int size, int hi, float c2,
                   float p0, float p1, cudaStream_t stream) {
  if (size < 1 || size > bigdl::kMaxWindow) return cudaErrorInvalidValue;
  if (size == 5)
    return launch_as<T, 5>(x, scale, g, dx, planes, h, w, size, hi, c2, p0,
                           p1, stream);
  return launch_as<T, 0>(x, scale, g, dx, planes, h, w, size, hi, c2, p0, p1,
                         stream);
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
