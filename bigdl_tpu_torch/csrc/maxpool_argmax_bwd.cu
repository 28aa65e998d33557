// Argmax-index max-pool backward for Hopper (sm_90a): each output
// gradient goes to the one tap that won its window, read from the int8
// tap index the forward saved; x and y are never read.
//
// Replaces: bigdl_tpu/ops/pooling_pallas.py::_bwd_kernel (launched by
// _bwd_impl, pl.pallas_call).
//
// In padded coordinates (ph, pw on the low side), for every input
// q = (qh, qw) with a = q / s and r = q % s per axis, the windows that
// hold q are o = a - j for the taps d = r + s*j < k, and
//   dx[q] = sum over those windows with idx[o] == dh * kw + dw of gy[o]
// jh outer and jw inner, both ascending (the Pallas residue order),
// summed in f32 from 0 and rounded once to gy's dtype, as the plain
// version does, so the two agree bit for bit.  A select, not the Pallas
// kernel's mask-multiply: the multiply was a Mosaic workaround that
// lets a non-finite gy leak NaN into the window's other taps (0 * inf);
// here an inf gradient stays on its winner.  The Pallas launcher pads
// its halo to n_tiles + 1 row blocks for the bottom-row residue
// shortfall (lh > oh + jh_max); this kernel skips every window past the
// output grid.  Index -1 (a window with no tap in the plane) matches no
// tap.
//
// What bounds it on the card.  Its byte bound: gy (16-bit) and idx
// (int8) read and dx written once (Inception-v1's pool1 at batch 256 in
// bf16: 103 + 51 MB in, 411 MB out, 0.169 ms at 3.35 TB/s).  It runs at
// 2.0-2.5x that bound; whether its compares and adds (one each for
// every window over an input) or the wait for each CTA's staging hold
// it there, no counter on the card has shown.
//
// Design: one launch, tiled as maxpool_tie_bwd.cu is (pool_stage.cuh):
// a CTA takes a group of whole consecutive planes or, where one plane's
// spans exceed kStageBytes, a band of rows of one plane with the output
// rows of every window over it.  It stages its gy and idx spans into
// shared memory by 16-byte cp.async, gathers each input's dx from shared
// memory into a dx tile (bigdl::gather_strips for Inception-v1's 3x3 s1
// and s2 pools: 8 inputs down a column a thread, each window row read
// once into registers; bigdl::gather_any otherwise), then writes the
// tile back with one 16-byte store a thread; the tile lies as far past
// 16 bytes as its span of dx does, so every full chunk leaves as one
// aligned load and store.  Plane, row and column come from the CTA's
// tile and a carried walk, not from dividing each flat index.  No
// atomics.

#include <cstdint>

#include "pool_stage.cuh"

namespace {

constexpr int kThreads = 128;
// the shared memory a CTA aims at, and the CTAs a launch aims at (about
// nine waves of seven 32 KB CTAs on each of the card's 132 SMs): the
// fastest on the card of 256 threads with 32 or 48 KB and 128 threads
// with 16 or 32 KB
constexpr long long kStageBytes = 32768;
constexpr long long kFillBlocks = 8192;

// The gather's terms (pool_stage.cuh): a window's gy where its index
// names the tap, idx == dh * kw + dw (load gives idx - dw).
template <typename T>
struct ArgmaxWin {
  const T* gy;
  const int8_t* idx;
  __device__ __forceinline__ float key(int) const { return 0.f; }
  __device__ __forceinline__ float2 load(int o, int dw) const {
    return make_float2(static_cast<float>(idx[o] - dw), bigdl::to_f32(gy[o]));
  }
  static __device__ __forceinline__ bool match(float, float tap, int row_tap) {
    return tap == static_cast<float>(row_tap);
  }
};

// K == 0: any geometry; else a square K x K window of stride S.
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
argmax_bwd_kernel(const T* __restrict__ gy, const int8_t* __restrict__ idx,
                  T* __restrict__ dx, bigdl::PoolTiles tiles, int nc, int h,
                  int w, int oh, int ow, int kh, int kw, bigdl::FastDiv sh,
                  bigdl::FastDiv sw, int ph, int pw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bigdl::TileRows t = bigdl::tile_rows(tiles, nc, h, oh, kh, sh.d, ph);
  unsigned char* at = smem_raw;
  T* ds = reinterpret_cast<T*>(at);
  at += bigdl::span_bytes(tiles.d_cap, sizeof(T));
  T* gs = reinterpret_cast<T*>(at);
  at += bigdl::span_bytes(tiles.o_cap, sizeof(T));
  int8_t* is = reinterpret_cast<int8_t*>(at);

  const size_t ostart = (t.p0 * oh + t.oy0) * ow;
  const int no = t.planes * (t.oy1 - t.oy0) * ow;
  const int lg = bigdl::span_lead(gy + ostart), li = bigdl::span_lead(idx + ostart);
  bigdl::stage_span(gs, gy + ostart, no, lg);
  bigdl::stage_span(is, idx + ostart, no, li);
  bigdl::cp_commit();
  T* dst = dx + (t.p0 * h + t.r0) * w;
  ds += bigdl::span_lead(dst);  // as far past 16 bytes as dst
  const ArgmaxWin<T> win{gs + lg, is + li};
  bigdl::cp_wait<0>();
  __syncthreads();

  if constexpr (K == 0)
    bigdl::gather_any(t, ds, w, ow, kh, kw, sh, sw, ph, pw, win);
  else
    bigdl::gather_strips<K, S>(t, ds, w, ow, ph, pw, win);
  __syncthreads();
  bigdl::store_span(dst, ds, t.planes * (t.r1 - t.r0) * w);
}

template <typename T, int K, int S>
cudaError_t launch_as(const bigdl::PoolTiles& tiles, long long smem,
                      const void* gy, const void* idx, void* dx, int nc, int h,
                      int w, int oh, int ow, int kh, int kw, int sh, int sw,
                      int ph, int pw, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        argmax_bwd_kernel<T, K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  argmax_bwd_kernel<T, K, S><<<tiles.blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(gy), static_cast<const int8_t*>(idx),
      static_cast<T*>(dx), tiles, nc, h, w, oh, ow, kh, kw,
      bigdl::make_fastdiv(sh), bigdl::make_fastdiv(sw), ph, pw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* gy, const void* idx, void* dx, int nc, int h,
                   int w, int oh, int ow, int kh, int kw, int sh, int sw,
                   int ph, int pw, cudaStream_t stream) {
  const long long total = static_cast<long long>(nc) * h * w;
  if (total >= (1ll << 31) || static_cast<long long>(nc) * oh * ow >= (1ll << 31))
    return cudaErrorInvalidValue;
  // dx, then gy and the int8 idx per output
  const int sz = static_cast<int>(sizeof(T));
  const bigdl::PoolTiles tiles = bigdl::plan_tiles(
      nc, h, w, oh, ow, kh, sh, 0, sz, sz + 1, 3, kStageBytes, kFillBlocks);
  if (tiles.blocks == 0) return cudaErrorInvalidValue;
  const long long smem = bigdl::span_bytes(tiles.d_cap, sz) +
                         bigdl::span_bytes(tiles.o_cap, sz) +
                         bigdl::span_bytes(tiles.o_cap, 1);
  const bool square3 = kh == 3 && kw == 3 && sh == sw;
  if (square3 && sh == 1)
    return launch_as<T, 3, 1>(tiles, smem, gy, idx, dx, nc, h, w, oh, ow, kh, kw,
                              sh, sw, ph, pw, stream);
  if (square3 && sh == 2)
    return launch_as<T, 3, 2>(tiles, smem, gy, idx, dx, nc, h, w, oh, ow, kh, kw,
                              sh, sw, ph, pw, stream);
  return launch_as<T, 0, 0>(tiles, smem, gy, idx, dx, nc, h, w, oh, ow, kh, kw,
                            sh, sw, ph, pw, stream);
}

}  // namespace

// gy is a contiguous [nc, oh, ow] tensor and dx a contiguous [nc, h, w]
// tensor, each of fewer than 2^31 elements, of one dtype (0 = f32,
// 1 = bf16, 2 = f16); idx is a contiguous int8 [nc, oh, ow] tensor.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry whose
// one-row band does not fit a CTA's shared memory.
extern "C" int bigdl_maxpool_argmax_bwd(const void* gy, const void* idx,
                                        void* dx, int nc, int h, int w,
                                        int oh, int ow, int kh, int kw,
                                        int sh, int sw, int ph, int pw,
                                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(gy, idx, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(gy, idx, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kF16)
    return launch<__half>(gy, idx, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
