// Shared-memory tiles for the port's spatial-window kernels (the
// within-channel LRN forward and backward, the smoothing of the
// subtractive, divisive and contrastive normalizations).
//
// The within-channel LRN's tiles (make_tile_grid, fill_tile, tile_sum)
// are described here; the smoothing plans its own tiles
// (smooth2d.cu) and fills them with stage_rows, below.
//
// Each block owns one tile of up to 64 x 64 outputs of one plane (a
// whole 56 x 56 plane at the within-channel LRN's sites; smaller tiles
// when a stack has too few planes to fill the card).  It first
// stages, in f32, the input rows and columns that the tile's windows
// read into shared memory, zero outside the plane, so the tap loop needs
// no bounds checks and reads every tap from shared memory; then its 256
// threads walk the tile's outputs, neighbouring threads on neighbouring
// columns.  Large tiles keep the halo that neighbouring tiles both load
// small, and give every thread a dozen or more outputs, so each block
// has many independent loads in flight while it stages its tile.
#pragma once

#include <cstring>

#include "common.cuh"

namespace bigdl {

constexpr int kTileThreads = 256;
// the longest side of a tile, in outputs
constexpr int kMaxTile = 64;
// fewest blocks worth launching: two for each of an H100's 132 SMs
constexpr long long kFillBlocks = 264;
// widest window a tile takes on either axis (the wrappers check it)
constexpr int kMaxWindow = 32;

// How the outputs of one plane split into tiles: out_h x out_w outputs
// in tiles of tile_h x tile_w (the last row and column of tiles may be
// shorter).  The host fills it once per launch.
struct TileGrid {
  int out_h, out_w, tile_h, tile_w, tiles_h, tiles_w;
};

// Tiles of up to 64 x 64 outputs, halved (rows first, down to 8 x 32)
// while a stack of few planes would give fewer than kFillBlocks blocks
// (the smoothing's one-plane edge-coverage mass).
inline TileGrid make_tile_grid(long long planes, int out_h, int out_w) {
  TileGrid g;
  g.out_h = out_h;
  g.out_w = out_w;
  g.tile_h = out_h < kMaxTile ? out_h : kMaxTile;
  g.tile_w = out_w < kMaxTile ? out_w : kMaxTile;
  for (;;) {
    g.tiles_h = (out_h + g.tile_h - 1) / g.tile_h;
    g.tiles_w = (out_w + g.tile_w - 1) / g.tile_w;
    if (planes * g.tiles_h * g.tiles_w >= kFillBlocks) break;
    if (g.tile_h > 8) {
      g.tile_h = (g.tile_h + 1) / 2;
    } else if (g.tile_w > 32) {
      g.tile_w = (g.tile_w + 1) / 2;
    } else {
      break;
    }
  }
  return g;
}

inline unsigned tile_blocks(long long planes, const TileGrid& g) {
  return static_cast<unsigned>(planes * g.tiles_h * g.tiles_w);
}

// Floats of shared memory a block stages for a kh x kw window.
inline size_t tile_floats(const TileGrid& g, int kh, int kw) {
  return static_cast<size_t>(g.tile_h + kh - 1) * (g.tile_w + kw - 1);
}

// The block's tile: its plane, its first output row and column, and its
// extent.  Blocks run over (plane, tile row, tile column), planes
// outermost, so the tiles of one plane run together and share halos in L2.
struct Tile {
  long long plane;
  int y0, x0, h, w;
};

__device__ __forceinline__ Tile block_tile(const TileGrid& g) {
  const long long per_plane = static_cast<long long>(g.tiles_h) * g.tiles_w;
  const long long b = blockIdx.x;
  const int t = static_cast<int>(b % per_plane);
  Tile tile;
  tile.plane = b / per_plane;
  tile.y0 = (t / g.tiles_w) * g.tile_h;
  tile.x0 = (t % g.tiles_w) * g.tile_w;
  tile.h = min(g.tile_h, g.out_h - tile.y0);
  tile.w = min(g.tile_w, g.out_w - tile.x0);
  return tile;
}

// Fills tile[r * cols + c], r < rows, c < cols, with value(row0 + r,
// col0 + c) where that lies inside the h x w plane and 0 elsewhere, then
// waits for the whole block.
template <typename Value>
__device__ __forceinline__ void fill_tile(float* tile, int rows, int cols,
                                          int row0, int col0, int h, int w,
                                          Value value) {
  for (int i = threadIdx.x; i < rows * cols; i += kTileThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    const int gr = row0 + r;
    const int gc = col0 + c;
    tile[i] = (gr >= 0 && gr < h && gc >= 0 && gc < w) ? value(gr, gc) : 0.f;
  }
  __syncthreads();
}

// Sum over the kh x kw window whose top-left tap is tile[ty * cols + tx],
// one tap at a time in (i, j) order.  Starting from -0.0 keeps the first
// tap's bits (-0 + v == v for every v, +0 and -0 included), so the sum
// equals one that starts from its first tap.  __fadd_rn keeps the adds
// apart from any multiply (no FMA contraction).
__device__ __forceinline__ float tile_sum(const float* tile, int cols, int ty,
                                          int tx, int kh, int kw) {
  float acc = -0.f;
  for (int i = 0; i < kh; ++i) {
    const float* row = tile + (ty + i) * cols + tx;
#pragma unroll 4
    for (int j = 0; j < kw; ++j) acc = __fadd_rn(acc, row[j]);
  }
  return acc;
}

// Fills tile[r * cols + c], r < rows, c < cols, with the f32 value of
// plane[(row0 + r) * w + col0 + c] where that lies inside the h x w
// plane and 0 elsewhere (the caller synchronises).  Each thread takes
// 16-byte chunks of the source rows, one integer division a chunk: a
// chunk wholly inside the plane and the tile is one 16-byte load, the
// chunks at the edges element loads.  Rows whose start lies off 16
// bytes (w * sizeof(T) no multiple of 16) each get their own chunk
// boundaries.  tile and cols keep rows 16-byte aligned (cols a multiple
// of 4).
template <typename T>
__device__ __forceinline__ void stage_rows(float* tile, int rows, int cols,
                                           const T* __restrict__ plane, int h,
                                           int w, int row0, int col0) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int chunks = (cols + 2 * kPer - 2) / kPer;  // most a row's span meets
  const unsigned long long base = reinterpret_cast<unsigned long long>(plane);
  for (int k = threadIdx.x; k < rows * chunks; k += blockDim.x) {
    const int r = k / chunks;
    const int gr = row0 + r;
    const long long start = static_cast<long long>(gr) * w + col0;
    const int lead = static_cast<int>(
        (base + static_cast<unsigned long long>(start) * sizeof(T)) % 16) /
        static_cast<int>(sizeof(T));
    const int e0 = (k - r * chunks) * kPer - lead;  // tile column of its first element
    if (e0 >= cols || e0 + kPer <= 0) continue;
    float* trow = tile + r * cols;
    const bool row_in = gr >= 0 && gr < h;
    if (row_in && e0 >= 0 && e0 + kPer <= cols && col0 + e0 >= 0 &&
        col0 + e0 + kPer <= w) {
      const uint4 raw = *reinterpret_cast<const uint4*>(plane + start + e0);
      T v[kPer];
      memcpy(v, &raw, 16);
      float f[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) f[e] = to_f32(v[e]);
      if (e0 % 4 == 0) {  // 16-byte stores: element stores of neighbouring
                          // chunks would fall on the same banks
#pragma unroll
        for (int q = 0; q < kPer; q += 4)
          *reinterpret_cast<float4*>(trow + e0 + q) =
              make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < kPer; ++e) trow[e0 + e] = f[e];
      }
    } else {
      for (int e = max(e0, 0); e < min(e0 + kPer, cols); ++e) {
        const int gc = col0 + e;
        trow[e] = row_in && gc >= 0 && gc < w ? to_f32(plane[start + e]) : 0.f;
      }
    }
  }
}

}  // namespace bigdl
