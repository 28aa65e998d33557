// Max-pool forward for Hopper (sm_90a): the window maximum, and on
// request the int8 tap index of the first maximum.
//
// Replaces: bigdl_tpu/ops/pool_pallas.py::_maxpool_fwd_kernel (launched
// by _tie_fwd_pallas through ops/pallas_util.py::plane_call,
// pl.pallas_call), the tie-split forward.  With the index output it is
// also the argmax-mode forward, which the JAX package computes as one
// XLA reduce_window over a packed u32 (ops/pooling_pallas.py::
// _fwd_packed) and not as a Pallas kernel.
//
// Over NCHW x with low-side paddings ph, pw (the high side, ceil
// overflow included, is whatever the output extent reaches), for every
// output o = (p, oy, ox) the taps (dh, dw) run in row-major order and
//   y[o]   = x at the first tap whose value beats every earlier one
//   idx[o] = dh * kw + dw of that tap                     (int8)
// where "beats" is: the first tap at all, or a NaN over a non-NaN, or
// strictly greater (so NaN propagates as jnp.maximum propagates it and
// the first NaN wins; -0.0 ties with +0.0 and the first wins; equal
// values go to the first tap, the reference's first-argmax order).  y
// keeps the winning element's own bits.  Taps outside the plane are
// skipped: a padding tap never wins, as the packed-u32 init of 0 never
// wins in _fwd_packed.  For the tie-split forward the JAX package pads
// with -inf instead; that gives the same y, since a max over real taps
// and -inf equals the max over the real taps.  A window with no tap in
// the plane (Torch's rule pad <= k/2 leaves none) gives -inf and
// index -1.  Comparisons run in f32, which is exact for bf16 and f16.
//
// What bounds it on the card: bytes.  x is read and y (and idx) written
// once; Inception-v1's pool1 at batch 256 in bf16 reads 411 MB and
// writes 103 MB (0.153 ms at 3.35 TB/s).  The first design, one thread
// an output loading its taps from global memory one element at a time,
// ran at 3.4-3.6x that bound at stride 2 and 8.2x at stride 1: load and
// compare instructions held it, since each input was loaded up to 9
// times as a separate request.
//
// Design: one launch, tiled as the backwards are (pool_stage.cuh): a
// CTA takes a group of whole consecutive planes or, where one plane's
// spans exceed kStageBytes, a band of output rows of one plane with the
// x rows their windows read.  It stages that x span into shared memory
// by 16-byte cp.async, computes its outputs into shared y (and idx)
// tiles that lie as far past 16 bytes as their spans in device memory
// do, and writes them back with one 16-byte store a thread (16 indices
// to an int8 chunk).  For 3x3 windows of stride 1 or 2 (all 13 of
// Inception-v1's max pools) the maximum is taken separably
// (pool_strips): a thread takes 8 outputs down one column (two
// neighbouring columns at stride 1), reads each x row they need once,
// takes the first maximum of each row's taps once and offers it to the
// windows that hold the row; other geometries loop at run time, one
// thread an output.  Consecutive threads take consecutive columns.
// Rows too wide for a one-row band to fit a CTA's shared memory (tens
// of thousands of elements) take a one-thread-per-output kernel that
// loads its taps from global memory, chosen on the host by shape.  No
// atomics, no scratch.  Tried on the card and dropped: a persistent
// CTA that stages its next tile while it computes (slower: twice the
// shared memory halves the CTAs an SM holds), staging a tile in two
// parts so the first computes while the second lands (slower, the more
// so with the index), 64 or 256 threads, 12, 16 or 48 KB tiles.

#include <cstdint>

#include "pool_stage.cuh"

namespace {

constexpr int kThreads = 128;
// the shared memory a CTA aims at (a bf16 pool1 plane and its y fit),
// and the CTAs a launch aims at: as the backwards
constexpr long long kStageBytes = 32768;
constexpr long long kFillBlocks = 8192;

// A running first maximum by the rule above: v the winner's value, e
// its bits and t its tap.  The bits are carried as an integer: the
// compiler may fold the select of v into a max instruction, which is
// free to return +0 for a -0 that won first or another NaN's bits, so v
// only ever decides.  With an index, a 16-bit type packs its tap into
// the low 8 bits of e (so one select moves both); f32 keeps t apart.  A
// run starts at -inf (start) or at its first tap (a copy), since the
// first tap always wins: where nothing beats -inf, v stays -inf and the
// index is set apart (index).  A tap outside the plane comes as -inf
// and never wins.
template <typename T, bool kIndex>
struct Best {
  static constexpr bool kPack = kIndex && sizeof(T) == 2;
  unsigned e;
  float v;
  int t;
  __device__ __forceinline__ void start() {
    v = __int_as_float(0xff800000);
    e = word(bigdl::from_f32<T>(v), 0);
    t = 0;
  }
  // a run of one tap
  __device__ __forceinline__ void one(T x, float xv, int tap) {
    e = word(x, tap);
    v = xv;
    t = tap;
  }
  __device__ __forceinline__ void tap(unsigned xe, float xv, int tap) {
    if (!(xv <= v) && v == v) {
      e = xe;
      v = xv;
      t = tap;
    }
  }
  __device__ __forceinline__ void tap(T x, float xv, int tap) { this->tap(word(x, tap), xv, tap); }
  // the first maximum of a later run, its taps shifted by dt
  __device__ __forceinline__ void take(const Best& o, int dt) {
    tap(kPack ? o.e + dt : o.e, o.v, o.t + dt);
  }
  static __device__ __forceinline__ unsigned word(T x, int tap) {
    typename bigdl::RawBits<sizeof(T)>::type r;
    memcpy(&r, &x, sizeof(T));
    return kPack ? static_cast<unsigned>(r) << 8 | tap : r;
  }
  // y: the winner's own bits (-inf where nothing won)
  __device__ __forceinline__ T y() const {
    const auto r = static_cast<typename bigdl::RawBits<sizeof(T)>::type>(kPack ? e >> 8 : e);
    T out;
    memcpy(&out, &r, sizeof(T));
    return out;
  }
  // The index of the window that starts at (h0, w0) of an h x w plane:
  // the winner's tap, or where nothing beat -inf (every tap in the
  // plane is -inf) the first tap in the plane, or -1 where the window
  // holds none.
  __device__ __forceinline__ int8_t index(int h0, int w0, int h, int w,
                                          int kh, int kw) const {
    if (v != __int_as_float(0xff800000))
      return static_cast<int8_t>(kPack ? e & 0xff : t);
    const int dh = max(0, -h0), dw = max(0, -w0);
    const bool any = dh < kh && h0 + dh < h && dw < kw && w0 + dw < w;
    return static_cast<int8_t>(any ? dh * kw + dw : -1);
  }
};

// Every output of the tile, any geometry: one thread an output,
// consecutive threads on consecutive outputs.
template <bool kIndex, typename T>
__device__ __forceinline__ void pool_any(const bigdl::TileRows& t, const T* xs,
                                         T* ys, int8_t* is, int h, int w, int ow,
                                         int kh, int kw, int sh, int sw, int ph,
                                         int pw) {
  const int orows = t.oy1 - t.oy0, xrows = t.xr1 - t.xr0;
  const int no = t.planes * orows * ow;
  for (bigdl::Walk o(threadIdx.x, kThreads, orows, ow); o.i < no; o.next()) {
    const int h0 = (t.oy0 + o.r) * sh - ph;
    const int w0 = o.c * sw - pw;
    const int plane = (o.g * xrows - t.xr0) * w;  // row ih at plane + ih * w
    Best<T, kIndex> b;
    b.start();
    for (int dh = max(0, -h0); dh < kh && h0 + dh < h; ++dh) {
      const T* row = xs + plane + (h0 + dh) * w;
      for (int dw = max(0, -w0); dw < kw && w0 + dw < w; ++dw) {
        const T e = row[w0 + dw];
        b.tap(e, bigdl::to_f32(e), dh * kw + dw);
      }
    }
    ys[o.i] = b.y();
    if (kIndex) is[o.i] = b.index(h0, w0, h, w, kh, kw);
  }
}

// The same for a 3 x 3 window of stride S = 1 or 2, separably: a thread
// takes a unit of kStrip outputs down one column (stride 2) or each of
// two neighbouring columns (stride 1) and reads the X x rows they need
// once each, top down, the unit's taps of each row.  It takes the first
// maximum of each column's 3 taps in the row (at stride 1 the middle
// pair once for both columns), then offers the row maxima to the unit's
// outputs in row order: the first maximum of the row maxima, rows in
// order, is the first maximum of the window in row-major order, so
// every output keeps the rule and its tap.  At stride 1 two outputs
// share the maximum of their two common rows.  An output is written as
// soon as its last row is in.  A tap outside the plane reads -inf
// (every tap of an output of the tile that lies in the plane is in the
// tile, so only taps outside the plane, or of outputs past the tile's
// last row or column, fall outside it).
template <int S, bool kIndex, typename T>
__device__ __forceinline__ void pool_strips(const bigdl::TileRows& t,
                                            const T* xs, T* ys, int8_t* is,
                                            int h, int w, int ow, int ph,
                                            int pw) {
  constexpr int K = 3, M = bigdl::kStrip;
  constexpr int U = S == 1 ? 2 : 1;         // columns of outputs a unit takes
  constexpr int X = (M - 1) * S + K;        // x rows a unit reads
  constexpr int C = (U - 1) * S + K;        // x columns a unit reads
  static_assert(S == 1 || S == 2, "strides 1 and 2");
  static_assert(M % 2 == 0, "whole pairs of outputs");
  using Run = Best<T, kIndex>;
  const float neg_inf = __int_as_float(0xff800000);
  const T neg_inf_t = bigdl::from_f32<T>(neg_inf);
  const int orows = t.oy1 - t.oy0, xrows = t.xr1 - t.xr0;
  const int strips = (orows + M - 1) / M, cols = (ow + U - 1) / U;
  const int units = t.planes * strips * cols;
  for (bigdl::Walk u(threadIdx.x, kThreads, strips, cols); u.i < units; u.next()) {
    const int ol = u.r * M, ox = U * u.c;   // the unit's first output row (in the tile) and column
    const int o0 = (u.g * orows + ol) * ow + ox;
    const int ih0 = (t.oy0 + ol) * S - ph, iw0 = ox * S - pw;
    const int plane = (u.g * xrows - t.xr0) * w;  // row ih at plane + ih * w
    bool col_ok[C];
#pragma unroll
    for (int j = 0; j < C; ++j) col_ok[j] = iw0 + j >= 0 && iw0 + j < w;
    auto emit = [&](const Run& b, int m, int c) {
      if (ol + m >= orows || ox + c >= ow) return;
      ys[o0 + m * ow + c] = b.y();
      if (kIndex) is[o0 + m * ow + c] = b.index(ih0 + m * S, iw0 + c * S, h, w, K, K);
    };
    Run o[M][U], q[U];
#pragma unroll
    for (int r = 0; r < X; ++r) {
      const int ih = ih0 + r;
      const bool row_ok = ih >= t.xr0 && ih < t.xr1;
      Run x[C];                             // the row's taps, as runs of one
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const bool ok = row_ok && col_ok[j];
        const T e = ok ? xs[plane + ih * w + iw0 + j] : neg_inf_t;
        x[j].one(e, ok ? bigdl::to_f32(e) : neg_inf, 0);
      }
      Run rb[U];                            // each column's row maximum, t = its dw
      if constexpr (S == 1) {
        Run mid = x[1];                     // taps 1, 2 of column 0; 0, 1 of column 1
        mid.take(x[2], 1);
        rb[0] = x[0];
        rb[0].take(mid, 1);
        rb[1] = mid;
        rb[1].take(x[3], 2);
      } else {
        rb[0] = x[0];
        rb[0].take(x[1], 1);
        rb[0].take(x[2], 2);
      }
#pragma unroll
      for (int c = 0; c < U; ++c) {
        if constexpr (S == 1) {
          // outputs 2j, 2j+1 read rows 2j..2j+2 and 2j+1..2j+3; q holds
          // the first maximum of rows 2j+1, 2j+2 (taps from row 2j+1)
          const int j = r / 2;
          if (r % 2 == 0) {
            if (j >= 1) {
              q[c].take(rb[c], K);
              o[2 * j - 2][c].take(q[c], K);
              emit(o[2 * j - 2][c], 2 * j - 2, c);
              o[2 * j - 1][c] = q[c];
            }
            if (j < M / 2) o[2 * j][c] = rb[c];
          } else {
            if (j >= 1) {
              o[2 * j - 1][c].take(rb[c], 2 * K);
              emit(o[2 * j - 1][c], 2 * j - 1, c);
            }
            if (j < M / 2) q[c] = rb[c];
          }
        } else {
          // output m reads rows 2m, 2m+1, 2m+2
          const int m = r / 2;
          if (r % 2 == 0) {
            if (m >= 1) {
              o[m - 1][c].take(rb[c], 2 * K);
              emit(o[m - 1][c], m - 1, c);
            }
            if (m < M) o[m][c] = rb[c];
          } else {
            o[m][c].take(rb[c], K);
          }
        }
      }
    }
  }
}

// K == 0: any geometry; else a square K x K window of stride S.
template <typename T, bool kIndex, int K, int S>
__global__ void __launch_bounds__(kThreads)
maxpool_fwd_staged(const T* __restrict__ x, T* __restrict__ y,
                   int8_t* __restrict__ idx, bigdl::PoolTiles tiles, int nc,
                   int h, int w, int oh, int ow, int kh, int kw, int sh, int sw,
                   int ph, int pw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bigdl::TileRows t = bigdl::fwd_tile_rows(tiles, nc, h, oh, kh, sh, ph);
  unsigned char* at = smem_raw;
  T* xs = reinterpret_cast<T*>(at);
  at += bigdl::span_bytes(tiles.x_cap, sizeof(T));
  T* ys = reinterpret_cast<T*>(at);
  at += bigdl::span_bytes(tiles.o_cap, sizeof(T));
  int8_t* is = reinterpret_cast<int8_t*>(at);

  const int xrows = t.xr1 - t.xr0, orows = t.oy1 - t.oy0;
  const T* xsrc = x + (t.p0 * h + t.xr0) * w;
  const size_t ostart = (t.p0 * oh + t.oy0) * ow;
  const int nx = t.planes * xrows * w, no = t.planes * orows * ow;
  const int lx = bigdl::span_lead(xsrc);
  bigdl::stage_span(xs, xsrc, nx, lx);
  bigdl::cp_commit();
  xs += lx;
  ys += bigdl::span_lead(y + ostart);
  if (kIndex) is += bigdl::span_lead(idx + ostart);
  bigdl::cp_wait<0>();
  __syncthreads();

  if constexpr (K == 0)
    pool_any<kIndex>(t, xs, ys, is, h, w, ow, kh, kw, sh, sw, ph, pw);
  else
    pool_strips<S, kIndex>(t, xs, ys, is, h, w, ow, ph, pw);
  __syncthreads();
  bigdl::store_span(y + ostart, ys, no);
  if (kIndex) bigdl::store_span(idx + ostart, is, no);
}

// Rows too wide to stage: one thread an output, its taps loaded from
// global memory.
template <typename T, bool kIndex>
__global__ void __launch_bounds__(kThreads)
maxpool_fwd_direct(const T* __restrict__ x, T* __restrict__ y,
                   int8_t* __restrict__ idx, unsigned total, int h, int w,
                   bigdl::FastDiv oh, bigdl::FastDiv ow, int kh, int kw,
                   int sh, int sw, int ph, int pw) {
  const unsigned o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const unsigned t = bigdl::div(o, ow);
  const unsigned p = bigdl::div(t, oh);
  const int ox = static_cast<int>(o - t * ow.d);
  const int oy = static_cast<int>(t - p * oh.d);
  const T* plane = x + static_cast<size_t>(p) * h * w;
  const int h0 = oy * sh - ph;
  const int w0 = ox * sw - pw;
  Best<T, kIndex> b;
  b.start();
  for (int dh = max(0, -h0); dh < kh && h0 + dh < h; ++dh) {
    const T* row = plane + (h0 + dh) * w;
    for (int dw = max(0, -w0); dw < kw && w0 + dw < w; ++dw) {
      const T e = row[w0 + dw];
      b.tap(e, bigdl::to_f32(e), dh * kw + dw);
    }
  }
  y[o] = b.y();
  if (kIndex) idx[o] = b.index(h0, w0, h, w, kh, kw);
}

template <typename T, bool kIndex, int K, int S>
cudaError_t launch_as(const bigdl::PoolTiles& tiles, long long smem,
                      const void* x, void* y, void* idx, int nc, int h, int w,
                      int oh, int ow, int kh, int kw, int sh, int sw, int ph,
                      int pw, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        maxpool_fwd_staged<T, kIndex, K, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  maxpool_fwd_staged<T, kIndex, K, S><<<tiles.blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int8_t*>(idx),
      tiles, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw);
  return cudaGetLastError();
}

template <typename T, bool kIndex>
cudaError_t launch_index(const void* x, void* y, void* idx, int nc, int h,
                         int w, int oh, int ow, int kh, int kw, int sh, int sw,
                         int ph, int pw, cudaStream_t stream) {
  const int sz = static_cast<int>(sizeof(T));
  const bigdl::PoolTiles tiles =
      bigdl::plan_fwd_tiles(nc, h, w, oh, ow, kh, sh, sz, sz + kIndex,
                            2 + kIndex, kStageBytes, kFillBlocks);
  if (tiles.blocks == 0) {
    const long long total = static_cast<long long>(nc) * oh * ow;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    maxpool_fwd_direct<T, kIndex><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<int8_t*>(idx),
        static_cast<unsigned>(total), h, w, bigdl::make_fastdiv(oh),
        bigdl::make_fastdiv(ow), kh, kw, sh, sw, ph, pw);
    return cudaGetLastError();
  }
  long long smem = bigdl::span_bytes(tiles.x_cap, sz) +
                   bigdl::span_bytes(tiles.o_cap, sz);
  if (kIndex) smem += bigdl::span_bytes(tiles.o_cap, 1);
  const bool square3 = kh == 3 && kw == 3 && sh == sw;
  if (square3 && sh == 1)
    return launch_as<T, kIndex, 3, 1>(tiles, smem, x, y, idx, nc, h, w, oh, ow,
                                      kh, kw, sh, sw, ph, pw, stream);
  if (square3 && sh == 2)
    return launch_as<T, kIndex, 3, 2>(tiles, smem, x, y, idx, nc, h, w, oh, ow,
                                      kh, kw, sh, sw, ph, pw, stream);
  return launch_as<T, kIndex, 0, 0>(tiles, smem, x, y, idx, nc, h, w, oh, ow,
                                    kh, kw, sh, sw, ph, pw, stream);
}

template <typename T>
cudaError_t launch(const void* x, void* y, void* idx, int nc, int h, int w,
                   int oh, int ow, int kh, int kw, int sh, int sw, int ph,
                   int pw, cudaStream_t stream) {
  if (static_cast<long long>(nc) * oh * ow >= (1ll << 31) ||
      static_cast<long long>(nc) * h * w >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (idx != nullptr)
    return launch_index<T, true>(x, y, idx, nc, h, w, oh, ow, kh, kw, sh, sw,
                                 ph, pw, stream);
  return launch_index<T, false>(x, y, idx, nc, h, w, oh, ow, kh, kw, sh, sw, ph,
                                pw, stream);
}

}  // namespace

// x is a contiguous [nc, h, w] tensor and y a contiguous [nc, oh, ow]
// tensor, each of fewer than 2^31 elements, of one dtype (0 = f32,
// 1 = bf16, 2 = f16); idx is a contiguous int8 [nc, oh, ow] tensor or
// null (then no index is written), and with an index kh * kw is at most
// 127.  Launches one kernel on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError().
extern "C" int bigdl_maxpool_fwd(const void* x, void* y, void* idx, int nc,
                                 int h, int w, int oh, int ow, int kh, int kw,
                                 int sh, int sw, int ph, int pw, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx != nullptr && kh * kw > 127) return cudaErrorInvalidValue;
  if (dtype == bigdl::kF32)
    return launch<float>(x, y, idx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, y, idx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kF16)
    return launch<__half>(x, y, idx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
