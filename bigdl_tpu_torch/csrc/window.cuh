// Shared-memory tiles for the port's spatial-window kernels: the
// within-channel LRN forward and backward (wcl_fwd.cu, wcl_bwd.cu) and
// the smoothing of the subtractive, divisive and contrastive
// normalizations (smooth2d.cu, which plans its own tiles and fills them
// with stage_rows, below).
//
// The within-channel LRN's tiles (WinGrid, make_win_grid): a block owns
// a tile of up to 64 x 64 outputs of one plane (a whole 56 x 56 plane
// at the LRN's two sites, so no halo element is formed twice; tiles
// halve while a stack has too few planes to give kFillBlocks blocks).
// It stages, in f32, the rows and columns that the tile's windows read
// into shared memory, zero outside the plane, by 16-byte loads of each
// source row (stage_map), transformed on the way in (x^2 for the
// forward; t and g * scale^-beta for the backward).  Then its threads
// take units of RY rows x 4 consecutive outputs of a row, a few each:
// consecutive threads of the 1-D block on consecutive units in row-major
// order, tile_w / 4 units across, each thread stepping its unit's row and
// column with no division (for_each_unit).  A unit loads each staged row
// it reads once, 4 values at a time by 16-byte shared loads, and adds it
// into its RY x 4 sums in registers (unit_sums), each sum in the
// window's (dh, dw) order.  The tile's row stride is padded so that the
// 16-byte loads of a warp's units, which straddle rows when a tile is
// less than 32 units wide, fall on distinct banks.
#pragma once

#include <cstring>

#include "common.cuh"

namespace bigdl {

// widest window a tile takes on either axis (the wrappers check it)
constexpr int kMaxWindow = 32;

__host__ __device__ constexpr int round_up(int n, int q) {
  return (n + q - 1) / q * q;
}

// Stores v[0..N) (N a multiple of 4) at d, 16-byte stores where d is
// 16-byte aligned (phase 0, d's float offset mod 4), an 8-byte store at
// each end and 16-byte ones between at phase 2, element stores
// otherwise: element stores of neighbouring threads' spans would fall on
// the same banks.
template <int N>
__device__ __forceinline__ void store_span(float* d, const float (&v)[N],
                                           int phase) {
  if (phase == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<float4*>(d + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else if (phase == 2) {
    *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
#pragma unroll
    for (int q = 2; q + 4 <= N; q += 4)
      *reinterpret_cast<float4*>(d + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    *reinterpret_cast<float2*>(d + N - 2) = make_float2(v[N - 2], v[N - 1]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) d[e] = v[e];
  }
}

// Fills NOUT tiles dst[o][r * cols + c], r < rows, c < cols, from NIN
// planes of one h x w layout: where (row0 + r, col0 + c) lies inside the
// plane, map(in, out) turns the NIN f32 values there into the NOUT
// staged ones; elsewhere every tile holds 0 (the caller synchronises).
// The block's threads take 16-byte chunks of the source rows, stepping
// (row, chunk) with no division: a chunk wholly inside the plane and the
// tile is one 16-byte load from each plane (when all NIN planes lie at
// one offset from 16 bytes), the chunks at the edges element loads.
// Rows whose start lies off 16 bytes (w * sizeof(T) no multiple of 16)
// each get their own chunk boundaries.  dst and cols keep rows 16-byte
// aligned (cols a multiple of 4).
template <int NOUT, int NIN, typename T, typename Map>
__device__ __forceinline__ void stage_map(float* const (&dst)[NOUT], int rows,
                                          int cols, const T* const (&src)[NIN],
                                          int h, int w, int row0, int col0,
                                          Map map) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int chunks = (cols + 2 * kPer - 2) / kPer;  // most a row's span meets
  const unsigned long long base = reinterpret_cast<unsigned long long>(src[0]);
  // src[0]'s offset from 16 bytes, in elements
  const int base_lead = static_cast<int>(base % 16) / static_cast<int>(sizeof(T));
  bool one_phase = true;
#pragma unroll
  for (int i = 1; i < NIN; ++i)
    one_phase &= (reinterpret_cast<unsigned long long>(src[i]) - base) % 16 == 0;
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int dr = threads / chunks, dk = threads - dr * chunks;
  int r = tid / chunks, k = tid - r * chunks;
  for (; r < rows; r += dr, k += dk) {
    if (k >= chunks) {
      k -= chunks;
      if (++r >= rows) break;
    }
    const int gr = row0 + r;
    const int start = gr * w + col0;  // plane element of tile column 0
    const int lead = (base_lead + start) & (kPer - 1);
    const int e0 = k * kPer - lead;  // tile column of its first element
    if (e0 >= cols || e0 + kPer <= 0) continue;
    const bool row_in = gr >= 0 && gr < h;
    if (one_phase && row_in && e0 >= 0 && e0 + kPer <= cols &&
        col0 + e0 >= 0 && col0 + e0 + kPer <= w) {
      float in[NIN][kPer];
#pragma unroll
      for (int i = 0; i < NIN; ++i) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src[i] + start + e0);
        T v[kPer];
        memcpy(v, &raw, 16);
#pragma unroll
        for (int e = 0; e < kPer; ++e) in[i][e] = to_f32(v[e]);
      }
      float out[NOUT][kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        float a[NIN], b[NOUT];
#pragma unroll
        for (int i = 0; i < NIN; ++i) a[i] = in[i][e];
        map(a, b);
#pragma unroll
        for (int o = 0; o < NOUT; ++o) out[o][e] = b[o];
      }
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
        store_span(dst[o] + r * cols + e0, out[o], e0 % 4);
    } else {
      for (int e = max(e0, 0); e < min(e0 + kPer, cols); ++e) {
        const int gc = col0 + e;
        float a[NIN], b[NOUT];
        if (row_in && gc >= 0 && gc < w) {
#pragma unroll
          for (int i = 0; i < NIN; ++i) a[i] = to_f32(src[i][start + e]);
          map(a, b);
        } else {
#pragma unroll
          for (int o = 0; o < NOUT; ++o) b[o] = 0.f;
        }
#pragma unroll
        for (int o = 0; o < NOUT; ++o) dst[o][r * cols + e] = b[o];
      }
    }
  }
}

// Fills tile[r * cols + c], r < rows, c < cols, with the f32 value of
// plane[(row0 + r) * w + col0 + c] where that lies inside the h x w
// plane and 0 elsewhere (the caller synchronises), by stage_map.
template <typename T>
__device__ __forceinline__ void stage_rows(float* tile, int rows, int cols,
                                           const T* __restrict__ plane, int h,
                                           int w, int row0, int col0) {
  float* const dst[1] = {tile};
  const T* const src[1] = {plane};
  stage_map(dst, rows, cols, src, h, w, row0, col0,
            [](const float (&a)[1], float (&b)[1]) { b[0] = a[0]; });
}

// ---------------------------------------------------------------------------
// the within-channel LRN's tiles
// ---------------------------------------------------------------------------

// the most rows and columns of outputs a tile takes
constexpr int kWinTile = 64;
// fewest blocks worth launching: two for each of an H100's 132 SMs
constexpr long long kFillBlocks = 264;

// How the h x w planes of a stack split into tiles of tile_h x tile_w
// outputs (the last row and column of tiles may be shorter; tile_h a
// multiple of the unit's rows, tile_w of 4), and the rows x cols floats
// a tile stages (cols a multiple of 4).  The host fills it once per
// launch.
struct WinGrid {
  int h, w, tile_h, tile_w, tiles_h, tiles_w, rows, cols;
};

// n cut into pieces of at most `most`, as even as possible, rounded up
// to a multiple of q.
inline int piece(int n, int most, int q) {
  const int pieces = (n + most - 1) / most;
  return round_up((n + pieces - 1) / pieces, q);
}

// Tiles of up to kWinTile x kWinTile outputs for an n x n window and
// units of unit_rows x 4 outputs, halved (rows first, down to 8 x 16)
// while a stack of few planes would give fewer than kFillBlocks blocks.
// The staged rows are padded so that the 16-byte loads of a warp's
// units fall on distinct banks: a row of units is tile_w / 4 wide, and
// the next row of units starts unit_rows * cols / 4 16-byte slots
// further on, so the slots of consecutive threads stay consecutive
// modulo 8 when the two agree modulo 8.
inline WinGrid make_win_grid(long long planes, int h, int w, int n,
                             int unit_rows) {
  WinGrid g;
  g.h = h;
  g.w = w;
  g.tile_h = piece(h, kWinTile, unit_rows);
  g.tile_w = piece(w, kWinTile, 4);
  for (;;) {
    g.tiles_h = (h + g.tile_h - 1) / g.tile_h;
    g.tiles_w = (w + g.tile_w - 1) / g.tile_w;
    if (planes * g.tiles_h * g.tiles_w >= kFillBlocks) break;
    if (g.tile_h > 8) {
      g.tile_h = round_up((g.tile_h + 1) / 2, unit_rows);
    } else if (g.tile_w > 16) {
      g.tile_w = round_up((g.tile_w + 1) / 2, 4);
    } else {
      break;
    }
  }
  g.rows = g.tile_h + n - 1;
  const int need = round_up(g.tile_w + n - 1, 4);
  g.cols = need;
  for (int pad = 0; pad < 32; pad += 4) {
    if ((unit_rows * (need + pad) / 4 - g.tile_w / 4) % 8 == 0) {
      g.cols = need + pad;
      break;
    }
  }
  return g;
}

// The block's tile: its plane, its first output row and column, and its
// extent.  Blocks run over (plane, tile row, tile column), planes
// outermost, so the tiles of one plane run together and share halos in
// L2.
struct Tile {
  long long plane;
  int y0, x0, h, w;
};

__device__ __forceinline__ Tile block_tile(const WinGrid& g) {
  const long long per_plane = static_cast<long long>(g.tiles_h) * g.tiles_w;
  const int t = static_cast<int>(blockIdx.x % per_plane);
  Tile tile;
  tile.plane = blockIdx.x / per_plane;
  tile.y0 = t / g.tiles_w * g.tile_h;
  tile.x0 = t % g.tiles_w * g.tile_w;
  tile.h = min(g.tile_h, g.h - tile.y0);
  tile.w = min(g.tile_w, g.w - tile.x0);
  return tile;
}

// Threads of the 1-D block that takes a tile: about per_thread units a
// thread, a multiple of a warp, at most max_threads.
inline int unit_threads(const WinGrid& g, int unit_rows, int per_thread,
                        int max_threads) {
  const int units = g.tile_h / unit_rows * (g.tile_w / 4);
  const int threads = round_up((units + per_thread - 1) / per_thread, 32);
  return threads < max_threads ? threads : max_threads;
}

// Calls unit(ty0, tx0) for each unit of unit_rows x 4 outputs of the
// block's tile whose first output lies inside it (ty0, tx0: the unit's
// first output row and column in the tile).  Units run in row-major
// order, g.tile_w / 4 across, consecutive threads of the 1-D block on
// consecutive units; each thread steps its unit's row and column with
// no division.
template <typename Unit>
__device__ __forceinline__ void for_each_unit(const WinGrid& g, const Tile& t,
                                              int unit_rows, Unit unit) {
  const int across = g.tile_w / 4;
  const int units = (t.h + unit_rows - 1) / unit_rows * across;
  const int dy = blockDim.x / across, dx = blockDim.x - dy * across;
  int uy = threadIdx.x / across, ux = threadIdx.x - uy * across;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    if (ux * 4 < t.w) unit(uy * unit_rows, ux * 4);
    ux += dx;
    uy += dy;
    if (ux >= across) {
      ux -= across;
      ++uy;
    }
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The window sums of a unit of RY x 4 outputs over a K x K window (K a
// compile-time constant) or an n x n one (K == 0), added tap by tap in
// (i, j) order into acc, which the caller starts at -0.0 (-0 + v == v
// for every v, so each sum equals one that starts from its first tap).
// row is the staged value under the unit's first output's first tap
// (16-byte aligned).  Staged row s is loaded once, 4 values at a time
// by 16-byte shared loads sliding along it, and added into every output
// row a whose window holds it (window row s - a), so each output's sum
// keeps its order.  __fadd_rn keeps the adds apart from any multiply
// (no FMA contraction).
template <int K, int RY>
__device__ __forceinline__ void unit_sums(float (&acc)[RY][4],
                                          const float* row, int cols, int n) {
  const int kn = K > 0 ? K : n;
#pragma unroll
  for (int s = 0; s < kn + RY - 1; ++s) {
    const float* r = row + s * cols;
    float4 cur = lds4(r);
#pragma unroll
    for (int jb = 0; jb < kn; jb += 4) {
      // the next 4 values, where a tap of this step reaches them
      const float4 nxt = jb + 4 <= kn + 2 ? lds4(r + jb + 4) : cur;
      const float v[8] = {cur.x, cur.y, cur.z, cur.w,
                          nxt.x, nxt.y, nxt.z, nxt.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jb + jj >= kn) break;
#pragma unroll
        for (int a = 0; a < RY; ++a) {
          if (s - a < 0 || s - a >= kn) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[a][q] = __fadd_rn(acc[a][q], v[jj + q]);
        }
      }
      cur = nxt;
    }
  }
}

// Four values of a row of T at src, in f32: one load where `vec`, else
// the n <= 4 that exist (the rest 0).
template <typename T>
__device__ __forceinline__ void load4(float (&v)[4], const T* src, int n,
                                      bool vec) {
  if (vec && n == 4) {
    T q[4];
    if constexpr (sizeof(T) == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      memcpy(q, &u, 16);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      memcpy(q, &u, 8);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = to_f32(q[r]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = r < n ? to_f32(src[r]) : 0.f;
  }
}

// Four outputs of a row, rounded to T: one store where `vec`, else the
// first n.
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&v)[4], int n,
                                       bool vec) {
  T q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) q[r] = from_f32<T>(v[r]);
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

// Whether p is aligned to 4 elements of T: a row of 4 outputs at a
// column that is a multiple of 4 is then one 16- or 8-byte access, in
// rows of a multiple of 4 elements.
template <typename T>
inline bool aligned4(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % (4 * sizeof(T)) == 0;
}

}  // namespace bigdl
