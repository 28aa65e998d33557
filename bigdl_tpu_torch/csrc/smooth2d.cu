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
// in (i, j) order, the order of the Pallas kernel, in f32 from -0.0
// (which keeps the first tap's bits), and rounded once; multiplies and
// adds are kept apart (__fmul_rn, __fadd_rn) so that no FMA rounds
// differently from the plain version, and the two agree bit for bit.
//
// What bounds it on the card: at the normalizations' 9 x 9 Gaussian,
// operations.  Each output costs 2*kh*kw flops against 4 bytes moved in
// bf16 (v read, out written), 162 flops against 4 bytes, far above the
// ~20 flops a byte at which an H100 turns compute-bound in f32.  Since
// the multiply and the add stay apart, each tap is two f32 instructions
// and the floor is twice the FMA-rate bound that chip_smoke.py states:
// 162 instructions an output.  The first design read both operands of
// every tap from shared memory, 162 loads an output, and those loads
// bound it.
//
// Design: register blocking.  A CTA takes a tile of up to 32 x 32
// outputs of one plane (smaller tiles where a stack has too few planes
// to fill the card) and stages the tile's inputs with their kh-1 and
// kw-1 halo rows and columns into shared memory in f32, zero outside the
// plane, by 16-byte loads of each source row (window.cuh stage_rows), and
// the (flipped, where asked) weights with each row padded to a multiple
// of 4.  One thread a unit: 128 threads at 9 x 9.  Each thread then computes a unit of 4 consecutive outputs of a
// row.  For the normalizations' 9 x 9 window (compiled in) a unit is 2
// such rows: for each window row i it loads the row's 9 weights and the
// 12 staged values the unit's lower row needs by 16-byte shared loads,
// keeps the upper row's 12 from the step before in registers, and does
// its 2 x 9 x 4 multiply-add pairs from registers (about 7 shared loads
// for 72 taps).  Any other window up to 32 x 32 runs a run-time loop
// over units of one row, sliding 4 staged values along each window row:
// one load of a value and one of a weight a tap, for 4 outputs.  Each
// output's sum keeps its (i, j) order either way.  Units of a warp lie
// side by side along a row, so its 16-byte shared loads fall on distinct
// banks; the weights are broadcast.  Outputs leave as one 8- or 16-byte
// store a unit row where the output rows are 4-aligned.  Tried on the
// card and dropped, all slower: 64 x 64 tiles, units of 1 or 4 rows,
// 16 x 64 tiles, and a fill that issues four chunks' loads before it
// stores any.

#include "window.cuh"

namespace {

// threads a CTA may take: one a unit, and a 32 x 32 tile holds at most
// 256 units (of one row)
constexpr int kMaxThreads = 256;
// the most rows and columns of outputs a tile takes
constexpr int kTileRows = 32;
constexpr int kTileCols = 32;
// fewest blocks worth launching: two for each of an H100's 132 SMs
constexpr long long kFillBlocks = 264;
// output rows of a unit of the compiled-in 9 x 9 window
constexpr int kUnitRows = 2;

__host__ __device__ constexpr int round_up(int n, int q) { return (n + q - 1) / q * q; }

// How a stack's outputs split into tiles of tile_h x tile_w (the last
// row and column of tiles may be shorter; tile_h a multiple of the unit
// rows, tile_w of 4), and the shared memory a tile stages: rows x cols
// floats (cols a multiple of 4) after the kh weight rows of wstride
// floats.  The host fills it once per launch.
struct Grid {
  int out_h, out_w, tile_h, tile_w, tiles_h, tiles_w;
  int rows, cols, wstride;
};

// n cut into pieces of at most `most`, as even as possible, rounded up
// to a multiple of q.
inline int piece(int n, int most, int q) {
  const int pieces = (n + most - 1) / most;
  return round_up((n + pieces - 1) / pieces, q);
}

// Tiles of up to kTileRows x kTileCols outputs, halved (rows first,
// down to 8 x 16) while a stack of few planes would give fewer than
// kFillBlocks blocks (the one-plane edge-coverage mass).
inline Grid make_grid(long long planes, int out_h, int out_w, int kh, int kw,
                      int unit_rows, int wstride) {
  Grid g;
  g.out_h = out_h;
  g.out_w = out_w;
  g.tile_h = piece(out_h, kTileRows, unit_rows);
  g.tile_w = piece(out_w, kTileCols, 4);
  for (;;) {
    g.tiles_h = (out_h + g.tile_h - 1) / g.tile_h;
    g.tiles_w = (out_w + g.tile_w - 1) / g.tile_w;
    if (planes * g.tiles_h * g.tiles_w >= kFillBlocks) break;
    if (g.tile_h > 8) {
      g.tile_h = round_up((g.tile_h + 1) / 2, unit_rows);
    } else if (g.tile_w > 16) {
      g.tile_w = round_up((g.tile_w + 1) / 2, 4);
    } else {
      break;
    }
  }
  g.rows = g.tile_h + kh - 1;
  g.cols = round_up(g.tile_w + kw - 1, 4);
  g.wstride = wstride;
  return g;
}

// The unit's sums, any window: one row of 4 outputs whose first input
// is row[0], a tap a step along each window row.
__device__ __forceinline__ void sum_any(float acc[4], const float* row,
                                        const float* weights, int cols,
                                        int kh, int kw, int wstride) {
  for (int i = 0; i < kh; ++i) {
    const float* r = row + i * cols;
    const float* wr = weights + i * wstride;
    float v0 = r[0], v1 = r[1], v2 = r[2];
    for (int j = 0; j < kw; ++j) {
      const float v3 = r[j + 3], wj = wr[j];
      acc[0] = __fadd_rn(acc[0], __fmul_rn(v0, wj));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(v1, wj));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(v2, wj));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(v3, wj));
      v0 = v1;
      v1 = v2;
      v2 = v3;
    }
  }
}

template <int N>
__device__ __forceinline__ void load4s(float (&dst)[N], const float* src) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = f.x;
    dst[4 * q + 1] = f.y;
    dst[4 * q + 2] = f.z;
    dst[4 * q + 3] = f.w;
  }
}

// The unit's sums for a K x K window known at compile time: RY rows of
// 4 outputs, the first input of the first at row[0] (16-byte aligned).
// Window row i of output row a reads staged row a + i, so each step
// loads one new row and keeps the rest.
template <int K, int RY>
__device__ __forceinline__ void sum_fixed(float (&acc)[RY][4], const float* row,
                                          const float* weights, int cols) {
  constexpr int V = round_up(K + 3, 4);   // staged values a unit row reads
  constexpr int W = round_up(K, 4);       // the weight row's stride
  float vals[RY][V];
#pragma unroll
  for (int a = 0; a < RY; ++a) load4s(vals[a], row + a * cols);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i > 0) {
#pragma unroll
      for (int a = 0; a + 1 < RY; ++a)
#pragma unroll
        for (int c = 0; c < V; ++c) vals[a][c] = vals[a + 1][c];
      load4s(vals[RY - 1], row + (i + RY - 1) * cols);
    }
    float wr[W];
    load4s(wr, weights + i * W);
#pragma unroll
    for (int a = 0; a < RY; ++a)
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[a][r] = __fadd_rn(acc[a][r], __fmul_rn(vals[a][j + r], wr[j]));
  }
}

// Four outputs of a row, rounded to T: one store where `vec`.
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float acc[4], int n,
                                       bool vec) {
  T q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) q[r] = bigdl::from_f32<T>(acc[r]);
  if (vec && n == 4) {
    if constexpr (sizeof(T) == 4) {
      uint4 u;
      memcpy(&u, q, 16);
      *reinterpret_cast<uint4*>(dst) = u;
    } else {
      uint2 u;
      memcpy(&u, q, 8);
      *reinterpret_cast<uint2*>(dst) = u;
    }
  } else {
    for (int r = 0; r < n; ++r) dst[r] = q[r];
  }
}

// K == 0: any window up to kMaxWindow (units of one row); else K x K
// compiled in (units of RY rows).
template <typename T, int K, int RY>
__global__ void __launch_bounds__(kMaxThreads)
smooth2d_kernel(const T* __restrict__ v, const float* __restrict__ wt,
                T* __restrict__ out, int h, int w, Grid g, int kh, int kw,
                int top, int left, int flip) {
  extern __shared__ __align__(16) float smem[];
  float* weights = smem;
  float* tile = smem + round_up(kh * g.wstride, 4);
  for (int k = threadIdx.x; k < kh * g.wstride; k += blockDim.x) {
    const int i = k / g.wstride, j = k - i * g.wstride;
    const int src = i * kw + j;
    weights[k] = j < kw ? wt[flip ? kh * kw - 1 - src : src] : 0.f;
  }
  const long long per_plane = static_cast<long long>(g.tiles_h) * g.tiles_w;
  const long long plane = blockIdx.x / per_plane;
  const int t = static_cast<int>(blockIdx.x % per_plane);
  const int y0 = t / g.tiles_w * g.tile_h, x0 = t % g.tiles_w * g.tile_w;
  const int th = min(g.tile_h, g.out_h - y0), tw = min(g.tile_w, g.out_w - x0);
  bigdl::stage_rows(tile, g.rows, g.cols, v + plane * h * w, h, w, y0 - top,
                    x0 - left);
  __syncthreads();

  T* o = out + (plane * g.out_h + y0) * g.out_w + x0;
  const bool vec = g.out_w % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(out) % (4 * sizeof(T)) == 0;
  const int across = (tw + 3) / 4, units = (th + RY - 1) / RY * across;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int ty0 = u / across * RY, tx0 = u % across * 4;
    const float* row = tile + ty0 * g.cols + tx0;
    float acc[RY][4];
#pragma unroll
    for (int a = 0; a < RY; ++a)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][r] = -0.f;  // -0 + first tap keeps its bits
    if constexpr (K == 0)
      sum_any(acc[0], row, weights, g.cols, kh, kw, g.wstride);
    else
      sum_fixed<K, RY>(acc, row, weights, g.cols);
#pragma unroll
    for (int a = 0; a < RY; ++a)
      if (ty0 + a < th)
        store4(o + (ty0 + a) * g.out_w + tx0, acc[a], min(4, tw - tx0), vec);
  }
}

template <typename T, int K, int RY>
cudaError_t launch_as(const void* v, const float* wt, void* out, int planes,
                      int h, int w, int out_h, int out_w, int kh, int kw,
                      int top, int left, int flip, cudaStream_t stream) {
  const Grid g = make_grid(planes, out_h, out_w, kh, kw, RY,
                           K ? round_up(K, 4) : kw);
  const size_t smem =
      sizeof(float) * (round_up(kh * g.wstride, 4) + static_cast<size_t>(g.rows) * g.cols);
  const int units = g.tile_h / RY * (g.tile_w / 4);
  const int threads = round_up(units, 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        smooth2d_kernel<T, K, RY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(planes) * g.tiles_h * g.tiles_w);
  smooth2d_kernel<T, K, RY><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(v), wt, static_cast<T*>(out), h, w, g, kh, kw, top,
      left, flip);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* v, const float* wt, void* out, int planes,
                   int h, int w, int out_h, int out_w, int kh, int kw,
                   int top, int left, int flip, cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > bigdl::kMaxWindow || kw > bigdl::kMaxWindow)
    return cudaErrorInvalidValue;
  if (kh == 9 && kw == 9)
    return launch_as<T, 9, kUnitRows>(v, wt, out, planes, h, w, out_h, out_w,
                                      kh, kw, top, left, flip, stream);
  return launch_as<T, 0, 1>(v, wt, out, planes, h, w, out_h, out_w, kh, kw,
                            top, left, flip, stream);
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
