// Tie-split max-pool backward for Hopper (sm_90a): each window's
// gradient is split in equal parts among every tap that ties for its
// maximum, so the gradient mass is conserved.
//
// Replaces: bigdl_tpu/ops/pool_pallas.py::_tie_bwd_kernel (launched by
// _tie_bwd_pallas through ops/pallas_util.py::plane_call,
// pl.pallas_call).
//
// In padded coordinates (ph, pw on the low side), the Pallas kernel
// computes per plane, as each CTA here does for its tile:
//   1. per output o: cnt[o] = number of taps equal to y[o], the taps
//      outside the plane reading -inf as the JAX pad does (so they count
//      in a window whose maximum is -inf); wgt[o] = gy[o] / cnt[o] where
//      cnt[o] > 0, else 0 (the Pallas kernel's form: a NaN maximum
//      matches nothing and gets 0);
//   2. per input q = (qh, qw): with a = q / s and r = q % s per axis, the
//      windows that hold q are o = a - j for the taps d = r + s*j < k;
//      dx[q] = sum of wgt[o] over those windows with x[q] == y[o], jh
//      outer and jw inner, both ascending (the Pallas residue order).
// The sum runs in f32 from 0 and is rounded once to the input dtype, as
// the plain version does, so the two agree bit for bit.  Windows past
// the output grid (the bottom-row residue shortfall) are skipped.
//
// What bounds it on the card.  Its byte bound: x, y and gy read and dx
// written once (Inception-v1's pool1 at batch 256 in bf16: 411 + 103 +
// 103 MB in, 411 MB out, 0.307 ms at 3.35 TB/s); wgt never leaves
// shared memory.  It runs at about 2x that bound at stride 2 and 3x at
// stride 1, bound by operations: 9 compares and up to 9 adds for each
// input at stride 1 (2.25 on average at stride 2) and a division for
// each output, so f32 takes only about 1.13x its bf16 time.
//
// Design: one launch.  A CTA takes a group of whole consecutive planes
// (their x, y and gy are three contiguous spans) or, where one plane's
// spans exceed kStageBytes, a band of rows of one plane with the halo
// its windows need (pool_stage.cuh).  It stages its x, y and gy spans
// into shared memory by 16-byte cp.async, computes every wgt of its
// outputs into f32 shared memory, then gathers each input's dx from
// shared memory and writes it over the input's own x, which no other
// thread reads after the counts.  Last the CTA writes its dx span back
// with one 16-byte store a thread.  For Inception-v1's 3x3 s1 and s2
// pools both steps are specialised at compile time: a thread takes 8
// outputs (or inputs) down one column and reads each x row (or window
// row) they share once into registers, with no division and no bound
// check inside the strip; other geometries loop at run time, one thread
// per output and per input.  Consecutive threads take consecutive
// columns, so shared-memory reads of a warp fall in distinct banks or
// broadcast.  Plane, row and column come from the CTA's tile and a
// carried walk (bigdl::Walk), not from dividing each flat index.  No
// atomics: every dx element has one fixed order of summation.

#include "pool_stage.cuh"

namespace {

constexpr int kThreads = 128;
// the shared memory a CTA aims at, and the CTAs a launch aims at (about
// nine waves of seven 32 KB CTAs on each of the card's 132 SMs): the
// fastest on the card of 256 threads with 32 or 48 KB and 128 threads
// with 16 or 32 KB
constexpr long long kStageBytes = 32768;
constexpr long long kFillBlocks = 8192;

// The gather's terms (pool_stage.cuh): an input's own x against each
// window's y, with the window's weight.
template <typename T>
struct TieWin {
  const T* x;       // the tile's rows [r0, r1), dx written over them
  const T* y;
  const float* wgt;
  __device__ __forceinline__ float key(int i) const { return bigdl::to_f32(x[i]); }
  __device__ __forceinline__ float2 load(int o, int) const {
    return make_float2(bigdl::to_f32(y[o]), wgt[o]);
  }
  static __device__ __forceinline__ bool match(float x, float y, int) {
    return x == y;
  }
};

// wgt of one output from its tie count: gy / cnt, 0 where cnt is 0.
template <typename T>
__device__ __forceinline__ float weight(int cnt, T gy) {
  return cnt > 0 ? __fdiv_rn(bigdl::to_f32(gy), static_cast<float>(cnt)) : 0.f;
}

// The weights of the tile's outputs, any geometry: one thread per
// output, consecutive threads on consecutive outputs.
template <typename T>
__device__ __forceinline__ void weigh_any(const bigdl::TileRows& t, const T* xs,
                                          const T* ys, const T* gs, float* ws,
                                          int h, int w, int ow, int kh, int kw,
                                          int sh, int sw, int ph, int pw) {
  const int orows = t.oy1 - t.oy0, xrows = t.xr1 - t.xr0;
  const int no = t.planes * orows * ow;
  const float neg_inf = __int_as_float(0xff800000);
  for (bigdl::Walk o(threadIdx.x, kThreads, orows, ow); o.i < no; o.next()) {
    const int h0 = (t.oy0 + o.r) * sh - ph;
    const int w0 = o.c * sw - pw;
    const int plane = (o.g * xrows - t.xr0) * w;  // row ih at plane + ih * w
    const float yv = bigdl::to_f32(ys[o.i]);
    const bool y_neg_inf = yv == neg_inf;
    int cnt = 0;
    for (int dh = 0; dh < kh; ++dh) {
      const int ih = h0 + dh;
      const bool row = ih >= 0 && ih < h;
      for (int dw = 0; dw < kw; ++dw) {
        const int iw = w0 + dw;
        if (row && iw >= 0 && iw < w)
          cnt += bigdl::to_f32(xs[plane + ih * w + iw]) == yv;
        else
          cnt += y_neg_inf;
      }
    }
    ws[o.i] = weight(cnt, gs[o.i]);
  }
}

// The same for a square K x K window of stride S known at compile time:
// a thread takes kStrip outputs down one column and reads each x row
// they need once, K taps of it, a tap outside the tile reading -inf
// (every tap of an output of the tile that lies in the plane is in the
// tile, so only taps outside the plane, or of outputs past the tile's
// last row, read it).  Consecutive threads take consecutive columns.
template <int K, int S, typename T>
__device__ __forceinline__ void weigh_strips(const bigdl::TileRows& t,
                                             const T* xs, const T* ys,
                                             const T* gs, float* ws, int w,
                                             int ow, int ph, int pw) {
  constexpr int M = bigdl::kStrip;
  constexpr int X = (M - 1) * S + K;        // x rows a strip reads
  const float neg_inf = __int_as_float(0xff800000);
  const int orows = t.oy1 - t.oy0, xrows = t.xr1 - t.xr0;
  const int strips = (orows + M - 1) / M;
  const int units = t.planes * strips * ow;
  for (bigdl::Walk u(threadIdx.x, kThreads, strips, ow); u.i < units; u.next()) {
    const int ol = u.r * M;                 // the strip's first output row, in the tile
    const int o0 = (u.g * orows + ol) * ow + u.c;
    const int ih0 = (t.oy0 + ol) * S - ph, iw0 = u.c * S - pw;
    const int plane = (u.g * xrows - t.xr0) * w;  // row ih at plane + ih * w
    float yv[M];
    int cnt[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      yv[m] = ol + m < orows ? bigdl::to_f32(ys[o0 + m * ow]) : 0.f;
      cnt[m] = 0;
    }
    bool col_ok[K];
#pragma unroll
    for (int dw = 0; dw < K; ++dw) col_ok[dw] = iw0 + dw >= 0 && iw0 + dw < w;
#pragma unroll
    for (int r = 0; r < X; ++r) {
      const int ih = ih0 + r;
      const bool row_ok = ih >= t.xr0 && ih < t.xr1;
      float xv[K];
#pragma unroll
      for (int dw = 0; dw < K; ++dw)
        xv[dw] = row_ok && col_ok[dw] ? bigdl::to_f32(xs[plane + ih * w + iw0 + dw])
                                      : neg_inf;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int dh = r - m * S;
        if (dh < 0 || dh >= K) continue;
#pragma unroll
        for (int dw = 0; dw < K; ++dw) cnt[m] += xv[dw] == yv[m];
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (ol + m < orows) ws[o0 + m * ow] = weight(cnt[m], gs[o0 + m * ow]);
  }
}

// K == 0: any geometry; else a square K x K window of stride S.
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
tie_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
               const T* __restrict__ gy, T* __restrict__ dx,
               bigdl::PoolTiles tiles, int nc, int h, int w, int oh, int ow,
               int kh, int kw, bigdl::FastDiv sh, bigdl::FastDiv sw, int ph,
               int pw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bigdl::TileRows t = bigdl::tile_rows(tiles, nc, h, oh, kh, sh.d, ph);
  unsigned char* at = smem_raw;
  T* xs = reinterpret_cast<T*>(at);
  at += bigdl::span_bytes(tiles.x_cap, sizeof(T));
  T* ys = reinterpret_cast<T*>(at);
  at += bigdl::span_bytes(tiles.o_cap, sizeof(T));
  T* gs = reinterpret_cast<T*>(at);
  at += bigdl::span_bytes(tiles.o_cap, sizeof(T));
  float* ws = reinterpret_cast<float*>(at);

  const int xrows = t.xr1 - t.xr0, orows = t.oy1 - t.oy0, rows = t.r1 - t.r0;
  const T* xsrc = x + (t.p0 * h + t.xr0) * w;
  const size_t ostart = (t.p0 * oh + t.oy0) * ow;
  const int nx = t.planes * xrows * w, no = t.planes * orows * ow;
  const int lx = bigdl::span_lead(xsrc), ly = bigdl::span_lead(y + ostart),
            lg = bigdl::span_lead(gy + ostart);
  bigdl::stage_span(xs, xsrc, nx, lx);
  bigdl::stage_span(ys, y + ostart, no, ly);
  bigdl::stage_span(gs, gy + ostart, no, lg);
  bigdl::cp_commit();
  xs += lx;
  ys += ly;
  gs += lg;
  bigdl::cp_wait<0>();
  __syncthreads();

  // 1. the weights of the tile's outputs
  if constexpr (K == 0)
    weigh_any(t, xs, ys, gs, ws, h, w, ow, kh, kw, sh.d, sw.d, ph, pw);
  else
    weigh_strips<K, S>(t, xs, ys, gs, ws, w, ow, ph, pw);
  __syncthreads();

  // 2. the gather, dx over the input's own x
  T* ds = xs + (t.r0 - t.xr0) * w;  // the tile's rows [r0, r1)
  const TieWin<T> win{ds, ys, ws};
  if constexpr (K == 0)
    bigdl::gather_any(t, ds, w, ow, kh, kw, sh, sw, ph, pw, win);
  else
    bigdl::gather_strips<K, S>(t, ds, w, ow, ph, pw, win);
  __syncthreads();
  bigdl::store_span(dx + (t.p0 * h + t.r0) * w, ds, t.planes * rows * w);
}

template <typename T, int K, int S>
cudaError_t launch_as(const bigdl::PoolTiles& tiles, long long smem,
                      const void* x, const void* y, const void* gy, void* dx,
                      int nc, int h, int w, int oh, int ow, int kh, int kw,
                      int sh, int sw, int ph, int pw, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tie_bwd_kernel<T, K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tie_bwd_kernel<T, K, S><<<tiles.blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(gy), static_cast<T*>(dx), tiles, nc, h, w, oh, ow,
      kh, kw, bigdl::make_fastdiv(sh), bigdl::make_fastdiv(sw), ph, pw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* gy, void* dx,
                   int nc, int h, int w, int oh, int ow, int kh, int kw,
                   int sh, int sw, int ph, int pw, cudaStream_t stream) {
  const long long outs = static_cast<long long>(nc) * oh * ow;
  const long long ins = static_cast<long long>(nc) * h * w;
  if (outs >= (1ll << 31) || ins >= (1ll << 31)) return cudaErrorInvalidValue;
  // x (dx in place), then y, gy and the f32 wgt per output
  const int sz = static_cast<int>(sizeof(T));
  const bigdl::PoolTiles tiles = bigdl::plan_tiles(
      nc, h, w, oh, ow, kh, sh, sz, 0, 2 * sz + 4, 4, kStageBytes, kFillBlocks);
  if (tiles.blocks == 0) return cudaErrorInvalidValue;
  const long long smem = bigdl::span_bytes(tiles.x_cap, sz) +
                         2 * bigdl::span_bytes(tiles.o_cap, sz) +
                         bigdl::span_bytes(tiles.o_cap, 4);
  const bool square3 = kh == 3 && kw == 3 && sh == sw;
  if (square3 && sh == 1)
    return launch_as<T, 3, 1>(tiles, smem, x, y, gy, dx, nc, h, w, oh, ow, kh, kw,
                              sh, sw, ph, pw, stream);
  if (square3 && sh == 2)
    return launch_as<T, 3, 2>(tiles, smem, x, y, gy, dx, nc, h, w, oh, ow, kh, kw,
                              sh, sw, ph, pw, stream);
  return launch_as<T, 0, 0>(tiles, smem, x, y, gy, dx, nc, h, w, oh, ow, kh, kw,
                            sh, sw, ph, pw, stream);
}

}  // namespace

// x and dx are contiguous [nc, h, w] tensors, y and gy contiguous
// [nc, oh, ow] tensors, each of fewer than 2^31 elements, all of one
// dtype (0 = f32, 1 = bf16, 2 = f16).  Launches one kernel on `stream`,
// does not synchronise, allocates nothing; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a geometry whose one-row band does not
// fit a CTA's shared memory (rows of several thousand elements).
extern "C" int bigdl_maxpool_tie_bwd(const void* x, const void* y,
                                     const void* gy, void* dx, int nc, int h,
                                     int w, int oh, int ow, int kh, int kw,
                                     int sh, int sw, int ph, int pw,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(x, y, gy, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, y, gy, dx, nc, h, w, oh, ow, kh, kw, sh, sw,
                                 ph, pw, s);
  if (dtype == bigdl::kF16)
    return launch<__half>(x, y, gy, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
