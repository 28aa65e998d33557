// Shared-memory staging for the pooling kernels: a contiguous span of
// device memory copied into shared memory by 16-byte cp.async and
// written back by 16-byte stores, the split of a pooling forward or
// backward into CTA tiles (groups of whole planes, or bands of rows of
// one plane), and a walk over a tile's elements that carries its
// (plane, row, column) digits instead of dividing every flat index.
#pragma once

#include <cstring>

#include "common.cuh"

namespace bigdl {

// Elements a span starting at p lies past the 16-byte boundary below it.
template <typename T>
__device__ __forceinline__ int span_lead(const T* p) {
  return static_cast<int>(reinterpret_cast<unsigned long long>(p) % 16) /
         static_cast<int>(sizeof(T));
}

// Issues the copy of src[0, n) to tile[lead, lead + n), lead =
// span_lead(src), so every full 16-byte chunk of the span lands aligned:
// a cp.async for each full chunk, element copies for the partial chunks
// at the two ends.  Every thread of the block takes part; the caller
// commits, waits and synchronises.  tile is 16-byte aligned and holds
// lead + n elements.
template <typename T>
__device__ __forceinline__ void stage_span(T* tile, const T* src, int n,
                                           int lead) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int chunks = (lead + n + kPer - 1) / kPer;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int e0 = c * kPer - lead;
    if (e0 >= 0 && e0 + kPer <= n) {
      cp_async16(tile + c * kPer, src + e0);
    } else {
      for (int e = max(e0, 0); e < min(e0 + kPer, n); ++e) tile[lead + e] = src[e];
    }
  }
}

template <int S> struct RawBits;
template <> struct RawBits<1> { using type = unsigned char; };
template <> struct RawBits<2> { using type = unsigned short; };
template <> struct RawBits<4> { using type = unsigned int; };

// Writes src[0, n) (shared memory) to dst[0, n) (device memory): one
// 16-byte store a thread for every aligned chunk of dst, element stores
// at the two ends.  A chunk is read from shared memory as one 16-byte
// load where src lies as far past 16 bytes as dst does, else element by
// element.  Every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void store_span(T* dst, const T* src, int n) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  using Raw = typename RawBits<sizeof(T)>::type;
  const int lead = span_lead(dst);
  const bool same = span_lead(src) == lead;
  const int chunks = (lead + n + kPer - 1) / kPer;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int e0 = c * kPer - lead;
    if (e0 >= 0 && e0 + kPer <= n) {
      uint4 v;
      if (same) {
        v = *reinterpret_cast<const uint4*>(src + e0);
      } else {
        Raw buf[kPer];
        const Raw* s = reinterpret_cast<const Raw*>(src + e0);
#pragma unroll
        for (int e = 0; e < kPer; ++e) buf[e] = s[e];
        memcpy(&v, buf, 16);
      }
      *reinterpret_cast<uint4*>(dst + e0) = v;
    } else {
      for (int e = max(e0, 0); e < min(e0 + kPer, n); ++e) dst[e] = src[e];
    }
  }
}

// A flat index over [.][rows][cols] with its digits (g, r, c), advanced
// by a fixed step: each thread divides once, at its start, and then
// carries.
struct Walk {
  int i, g, r, c;
  int sg, sr, sc, step, rows, cols;
  __device__ __forceinline__ Walk(int start, int step_, int rows_, int cols_)
      : i(start), step(step_), rows(rows_), cols(cols_) {
    const int plane = rows * cols;
    if (plane == 0) {
      g = r = c = sg = sr = sc = 0;
      return;
    }
    g = start / plane;
    r = start % plane / cols;
    c = start % cols;
    sg = step / plane;
    sr = step % plane / cols;
    sc = step % cols;
  }
  __device__ __forceinline__ void next() {
    i += step;
    c += sc;
    if (c >= cols) { c -= cols; ++r; }
    r += sr;
    if (r >= rows) { r -= rows; ++g; }
    g += sg;
  }
};

// Shared memory of one staged span of n elements of `size` bytes: the
// elements, up to 16 bytes of lead, rounded up to 16 bytes.
__host__ __device__ __forceinline__ long long span_bytes(long long n, int size) {
  return (n * size + 16 + 15) / 16 * 16;
}

// How a pooling backward over nc planes (h x w inputs, oh x ow outputs)
// is cut into CTAs (a forward's bands: plan_fwd_tiles).  bands == 1:
// CTA b takes the whole planes [b * group, b * group + group) (the last
// group may be short).  bands > 1: CTA b takes input rows [j * rows,
// j * rows + rows) of plane b / bands, j = b % bands (group 1).  x_cap,
// d_cap and o_cap bound the elements a CTA stages of x (with the halo
// rows its windows' counts need), of dx, and of each output-shaped
// tensor.
struct PoolTiles {
  int group, rows, bands;
  int x_cap, d_cap, o_cap;
  unsigned blocks;
};

// A CTA's rows.  Inputs [r0, r1) are written; outputs [oy0, oy1) are
// every window that holds one of them; x rows [xr0, xr1) are those rows
// and every tap of those windows inside the plane.  Whole planes keep
// every row, so a group's spans are contiguous.
struct TileRows {
  long long p0;
  int planes, r0, r1, oy0, oy1, xr0, xr1;
};

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ TileRows tile_rows(const PoolTiles& t, int nc,
                                              int h, int oh, int kh, int sh,
                                              int ph) {
  TileRows tr;
  if (t.bands == 1) {
    tr.p0 = static_cast<long long>(blockIdx.x) * t.group;
    tr.planes = static_cast<int>(min(static_cast<long long>(t.group), nc - tr.p0));
    tr.r0 = tr.xr0 = tr.oy0 = 0;
    tr.r1 = tr.xr1 = h;
    tr.oy1 = oh;
    return tr;
  }
  tr.p0 = blockIdx.x / t.bands;
  tr.planes = 1;
  tr.r0 = static_cast<int>(blockIdx.x % t.bands) * t.rows;
  tr.r1 = min(h, tr.r0 + t.rows);
  tr.oy0 = max(0, -floor_div(-(tr.r0 + ph - kh + 1), sh));
  tr.oy1 = max(tr.oy0, min(oh, (tr.r1 - 1 + ph) / sh + 1));
  tr.xr0 = tr.r0;
  tr.xr1 = tr.r1;
  if (tr.oy1 > tr.oy0) {
    tr.xr0 = min(tr.r0, max(0, tr.oy0 * sh - ph));
    tr.xr1 = max(tr.r1, min(h, (tr.oy1 - 1) * sh - ph + kh));
  }
  return tr;
}

// The gather of a max-pool backward over a CTA's tile: for every input
// q of rows [r0, r1) (tile index i = (g * rows + r - r0) * w + c),
//   s = sum of b over the windows o that hold q with
//       Win::match(key(i), a, dh * kw)              ((a, b) = load(o, dw))
// jh outer and jw inner, both ascending (the Pallas residue order), from
// 0 in f32, each term added by __fadd_rn; the result, rounded to T, goes
// to ds[i].  (The plain version adds +0 for the windows that do not
// match; that leaves the sum's bits alone, since a sum from +0 is never
// -0.)  o is a tile index (g * orows + oy - oy0) * ow + ox; only windows
// inside the output grid and inside [oy0, oy1) are loaded.  Any geometry (kh, kw, sh, sw
// at run time); one thread per input, consecutive threads on
// consecutive inputs.
template <class Win, typename T>
__device__ __forceinline__ void gather_any(const TileRows& t, T* ds, int w,
                                           int ow, int kh, int kw, FastDiv sh,
                                           FastDiv sw, int ph, int pw,
                                           const Win& win) {
  const int rows = t.r1 - t.r0, orows = t.oy1 - t.oy0;
  const int nd = t.planes * rows * w;
  for (Walk q(threadIdx.x, blockDim.x, rows, w); q.i < nd; q.next()) {
    const float key = win.key(q.i);
    const unsigned qh = t.r0 + q.r + ph, qw = q.c + pw;
    const int ah = div(qh, sh), rh = qh - ah * sh.d;
    const int aw = div(qw, sw), rw = qw - aw * sw.d;
    const int base = q.g * orows - t.oy0;  // output row oy at (base + oy) * ow
    float s = 0.f;
    for (int dh = rh, oy = ah; dh < kh && oy >= t.oy0; dh += sh.d, --oy) {
      if (oy >= t.oy1) continue;
      const int row = (base + oy) * ow;
      for (int dw = rw, ox = aw; dw < kw && ox >= 0; dw += sw.d, --ox) {
        if (ox >= ow) continue;
        const float2 ab = win.load(row + ox, dw);
        if (Win::match(key, ab.x, dh * kw)) s = __fadd_rn(s, ab.y);
      }
    }
    ds[q.i] = from_f32<T>(s);
  }
}

// The same gather for a square K x K window of stride S known at compile
// time (Inception-v1's 3x3 s1 and s2 pools), the order and the terms
// unchanged.  A thread takes a strip of kStrip inputs down one column,
// starting on a padded row that is a multiple of S, so every input's
// residue, and which windows reach it, is known at compile time.  It
// loads each window row that the strip's inputs need once (the rows
// bottom up, so each input meets its windows jh ascending), holds the
// strip's sums in registers, and needs no division.  Consecutive
// threads take consecutive columns.  Windows outside the tile hold
// a = NaN, which matches nothing.
constexpr int kStrip = 8;

template <int K, int S, class Win, typename T>
__device__ __forceinline__ void gather_strips(const TileRows& t, T* ds, int w,
                                              int ow, int ph, int pw,
                                              const Win& win) {
  static_assert(kStrip % S == 0, "a strip holds whole stride blocks");
  constexpr int J = (K + S - 1) / S;        // windows a row of inputs meets
  constexpr int V = kStrip / S + J - 1;     // window rows a strip meets
  const float nan = __int_as_float(0x7fffffff);
  const int rows = t.r1 - t.r0, orows = t.oy1 - t.oy0;
  const int p0 = (t.r0 + ph) / S * S;       // padded row of the first strip
  const int strips = (t.r1 + ph - p0 + kStrip - 1) / kStrip;
  const int units = t.planes * strips * w;
  for (Walk u(threadIdx.x, blockDim.x, strips, w); u.i < units; u.next()) {
    const int pr = p0 + u.r * kStrip;       // padded row of the strip's top
    const int qw = u.c + pw, aw = qw / S, rw = qw % S;
    const int e0 = (u.g * rows + pr - ph - t.r0) * w + u.c;
    const int base = u.g * orows - t.oy0;   // output row oy at (base + oy) * ow
    float key[kStrip], s[kStrip];
#pragma unroll
    for (int m = 0; m < kStrip; ++m) {
      const int r = pr + m - ph;
      s[m] = 0.f;
      key[m] = r >= t.r0 && r < t.r1 ? win.key(e0 + m * w) : 0.f;
    }
#pragma unroll
    for (int v = V - 1; v >= 0; --v) {
      const int oy = pr / S - (J - 1) + v;
      const bool row_ok = oy >= t.oy0 && oy < t.oy1;
      float a[J], b[J];
#pragma unroll
      for (int jw = 0; jw < J; ++jw) {
        const int ox = aw - jw, dw = rw + S * jw;
        a[jw] = nan;
        b[jw] = 0.f;
        if (row_ok && dw < K && ox >= 0 && ox < ow) {
          const float2 ab = win.load((base + oy) * ow + ox, dw);
          a[jw] = ab.x;
          b[jw] = ab.y;
        }
      }
#pragma unroll
      for (int m = 0; m < kStrip; ++m) {
        const int jh = m / S + J - 1 - v;   // this window row's jh for input m
        const int dh = m % S + S * jh;
        if (jh < 0 || jh >= J || dh >= K) continue;
#pragma unroll
        for (int jw = 0; jw < J; ++jw)
          if (Win::match(key[m], a[jw], dh * K)) s[m] = __fadd_rn(s[m], b[jw]);
      }
    }
#pragma unroll
    for (int m = 0; m < kStrip; ++m) {
      const int r = pr + m - ph;
      if (r >= t.r0 && r < t.r1) ds[e0 + m * w] = from_f32<T>(s[m]);
    }
  }
}

// Largest shared-memory budget of one CTA on Hopper (227 KB).
constexpr long long kMaxSmem = 232448;

// The tiles of a pooling backward: whole planes where one plane's spans
// fit `budget` bytes, as many to a CTA as fit and as keep about `fill`
// CTAs; else bands of rows as tall as fit `budget` (one row at the
// least, up to kMaxSmem), balanced.  A CTA stages x_bytes a staged x
// element, d_bytes a dx element and o_bytes an output position over
// `spans` spans.  blocks == 0: not even one row fits.
inline PoolTiles plan_tiles(int nc, int h, int w, int oh, int ow, int kh,
                            int sh, int x_bytes, int d_bytes, int o_bytes,
                            int spans, long long budget, long long fill) {
  auto bytes = [&](long long g, long long xr, long long r, long long orows) {
    return g * (xr * w * x_bytes + r * w * d_bytes + orows * ow * o_bytes) +
           spans * 32;
  };
  PoolTiles t;
  const long long plane = bytes(1, h, h, oh) - spans * 32;
  if (plane + spans * 32 <= budget) {
    const long long g = (nc + fill - 1) / fill, most = (budget - spans * 32) / plane;
    t.group = static_cast<int>(g < most ? g : most);
    t.rows = h;
    t.bands = 1;
    t.x_cap = t.d_cap = t.group * h * w;
    t.o_cap = t.group * oh * ow;
    t.blocks = static_cast<unsigned>((nc + t.group - 1) / t.group);
  } else {
    auto orows = [&](long long r) {
      const long long o = (r + kh - 2) / sh + 1;
      return o < oh ? o : static_cast<long long>(oh);
    };
    auto xrows = [&](long long r) {
      const long long x = r + 2 * (kh - 1);
      return x < h ? x : static_cast<long long>(h);
    };
    auto band = [&](long long r) { return bytes(1, xrows(r), r, orows(r)); };
    long long lo = 1, hi = h;  // largest r with band(r) <= budget, else 1
    while (lo < hi) {
      const long long mid = (lo + hi + 1) / 2;
      if (band(mid) <= budget) lo = mid; else hi = mid - 1;
    }
    t.group = 1;
    t.bands = static_cast<int>((h + lo - 1) / lo);
    t.rows = (h + t.bands - 1) / t.bands;
    t.x_cap = static_cast<int>(xrows(t.rows)) * w;
    t.d_cap = t.rows * w;
    t.o_cap = static_cast<int>(orows(t.rows)) * ow;
    t.blocks = static_cast<unsigned>(static_cast<long long>(nc) * t.bands);
    if (band(t.rows) > kMaxSmem) t.blocks = 0;
  }
  return t;
}

// The tiles of a pooling forward: whole planes as plan_tiles cuts them
// (d_cap unused), but a band is cut in output rows, since every output
// has one window and one CTA computes it.  bands > 1: CTA b takes output
// rows [j * rows, j * rows + rows) of plane b / bands, j = b % bands,
// and stages the x rows of their windows.  A CTA stages x_bytes a
// staged x element and o_bytes an output over `spans` spans.
// blocks == 0: not even a one-row band fits kMaxSmem.
inline PoolTiles plan_fwd_tiles(int nc, int h, int w, int oh, int ow, int kh,
                                int sh, int x_bytes, int o_bytes, int spans,
                                long long budget, long long fill) {
  PoolTiles t = plan_tiles(nc, h, w, oh, ow, kh, sh, x_bytes, 0, o_bytes,
                           spans, budget, fill);
  if (t.bands == 1) return t;
  auto xrows = [&](long long r) {
    const long long x = (r - 1) * sh + kh;
    return x < h ? x : static_cast<long long>(h);
  };
  auto band = [&](long long r) {
    return xrows(r) * w * x_bytes + r * ow * o_bytes + spans * 32;
  };
  long long lo = 1, hi = oh;  // largest r with band(r) <= budget, else 1
  while (lo < hi) {
    const long long mid = (lo + hi + 1) / 2;
    if (band(mid) <= budget) lo = mid; else hi = mid - 1;
  }
  t.bands = static_cast<int>((oh + lo - 1) / lo);
  t.rows = (oh + t.bands - 1) / t.bands;
  t.x_cap = static_cast<int>(xrows(t.rows)) * w;
  t.o_cap = t.rows * ow;
  t.blocks = static_cast<unsigned>(static_cast<long long>(nc) * t.bands);
  if (band(t.rows) > kMaxSmem) t.blocks = 0;
  return t;
}

// A forward CTA's rows (plan_fwd_tiles): whole planes as tile_rows
// gives them; in a band, outputs [oy0, oy1) and x rows [xr0, xr1), every
// tap of those windows inside the plane (none where no window reaches
// the plane), r0, r1 repeating xr0, xr1.
__device__ __forceinline__ TileRows fwd_tile_rows(const PoolTiles& t, int nc,
                                                  int h, int oh, int kh,
                                                  int sh, int ph) {
  if (t.bands == 1) return tile_rows(t, nc, h, oh, kh, sh, ph);
  TileRows tr;
  tr.p0 = blockIdx.x / t.bands;
  tr.planes = 1;
  tr.oy0 = static_cast<int>(blockIdx.x % t.bands) * t.rows;
  tr.oy1 = min(oh, tr.oy0 + t.rows);
  tr.xr0 = min(h, max(0, tr.oy0 * sh - ph));
  tr.xr1 = max(tr.xr0, min(h, (tr.oy1 - 1) * sh - ph + kh));
  tr.r0 = tr.xr0;
  tr.r1 = tr.xr1;
  return tr;
}

}  // namespace bigdl
