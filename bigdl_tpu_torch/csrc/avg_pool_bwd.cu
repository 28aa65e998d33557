// Torch-semantics average-pool backward for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/pool_pallas.py::_avg_bwd_kernel (launched by
// _avg_bwd_pallas through ops/pallas_util.py::plane_call,
// pl.pallas_call).
//
// The forward is a strided window sum times a divisor map, so its
// transpose is a sum of the out-grid weights wgt = gy * inv (the wrapper
// forms wgt) over the windows that hold each input position.  In padded
// coordinates q = i + pad, per axis, the windows o with
// o*s <= q < o*s + k are o = ceil((q-k+1)/s) .. floor(q/s), clipped to
// [0, out):
//   dx[p, ih, iw] = sum_{oy} sum_{ox} wgt[p, oy, ox]   (oy outer, ox inner,
//                                                      both ascending)
// from +0, in f32, each term added by __fadd_rn, rounded once.  The
// Pallas kernel computes the same sum by residue classes of the strides
// on a dilated plane and interleaves them; these kernels gather instead,
// which needs no atomics and gives every element one fixed order, the
// order of the plain version (dilate, edge-pad, stride-1 window sum).
// Positions in the ceil-overflow padding are never written; a
// floor-mode tail that no window reaches gets 0.  General kernel size,
// stride and asymmetric padding.
//
// What bounds it on the card: bytes.  wgt is read and dx written once
// (the Inception head at batch 256 in bf16: 0.5 MB in, 25.7 MB out, 7.8
// us at 3.35 TB/s).  At the head every dx element is one wgt value (a
// 7x7 window over a 7x7 plane), so the work is a broadcast, and the
// instructions an element, not the adds, decide how close a kernel
// comes to the bound.
//
// Two kernels, chosen on the host by the plane's size; both are
// hand-written, both keep the order and the rounding point, so both give
// the plain version's bits.
//
// Planes whose wgt and dx fit kStageBytes together (every geometry of
// the registered models: the 7x7 and 8x8 heads, the aux heads' 5x5 s3 on
// 14x14, the 3x3 branch pools): avg_pool_bwd_staged, the layout of the
// staged forward.  Each CTA owns a group of consecutive planes, whose
// wgt is one contiguous span and whose dx is another.  It copies the wgt
// span into shared memory with 16-byte cp.async copies
// (bigdl::stage_span).  Then each thread takes a position of the plane
// and a residue class of the group's planes (lanes: slots x h*w, slots =
// kStageThreads / (h*w) planes side by side, two at the 7x7 head), forms
// the position's window ranges once, by multiply-high divisions
// (bigdl::FastDiv), and walks its planes, writing each sum into a dx
// tile in shared memory; a position that one window holds (every
// position at the heads) takes a loop of a load, an add and a store a
// plane.  The tile lies as far past 16 bytes as the dx span, so it leaves
// by 16-byte loads and stores (bigdl::store_span).  The group is sized
// so that a launch has about kFillBlocks CTAs where the planes allow it
// (the training head: 256 planes a CTA, 1024 CTAs, one wave).
//
// Larger planes: avg_pool_bwd_kernel, one thread per dx element of a
// plane (blocks never straddle planes), consecutive threads on
// consecutive elements; the window ranges from FastDiv divisions.
//
// Every index is 32-bit; the only 64-bit arithmetic is a multiply for
// the base of a plane or of a group.  No atomics.
//
// On an H100 SXM (700 W), at the training head in bf16: the first design
// (one thread a dx element over the flat [nc, h, w] index: two 64-bit
// divisions and four 32-bit divisions an element, a 2-byte store) took
// 0.088 ms, 8.9% of the byte bound; this one 0.014 ms, 56%.  Tried and
// dropped: threads on 16-byte chunks of the group's dx span, each
// element's plane, row and column carried through the chunk and its
// window ranges read from per-row and per-column tables in shared memory
// (0.044 ms, and not much less with the gather's loops rolled): the
// per-element walk and the ranges cost more than the broadcast itself.

#include "pool_stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageThreads = 128;
// the most wgt and dx a staged CTA holds, and the CTAs a launch aims at
// (about eight for each of the card's 132 SMs)
constexpr int kStageBytes = 32768;
constexpr long long kFillBlocks = 1024;

// The windows o = lo .. hi (none when lo > hi) that hold padded
// coordinate q along an axis of window k, stride s and out windows.
__device__ __forceinline__ int2 window_range(int q, int k, bigdl::FastDiv s,
                                             int out) {
  const int lo = q - k + 1;
  return make_int2(lo <= 0 ? 0 : static_cast<int>(bigdl::div(lo + s.d - 1, s)),
                   min(static_cast<int>(bigdl::div(q, s)), out - 1));
}

// The sum over windows rows.x .. rows.y, cols.x .. cols.y of one wgt
// plane, oy outer and ox inner, from +0, in f32.  The loops stay rolled:
// a position meets one window or a few.
template <typename T>
__device__ __forceinline__ float gather(const T* plane, int ow, int2 rows,
                                        int2 cols) {
  float s = 0.f;
  const T* row = plane + rows.x * ow;
#pragma unroll 1
  for (int oy = rows.x; oy <= rows.y; ++oy, row += ow) {
#pragma unroll 1
    for (int ox = cols.x; ox <= cols.y; ++ox)
      s = __fadd_rn(s, bigdl::to_f32(row[ox]));
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
avg_pool_bwd_kernel(const T* __restrict__ wgt, T* __restrict__ dx,
                    bigdl::FastDiv blocks_per_plane, bigdl::FastDiv wd,
                    bigdl::FastDiv sh, bigdl::FastDiv sw, int h, int oh,
                    int ow, int kh, int kw, int ph, int pw) {
  const int w = static_cast<int>(wd.d);
  const int plane = static_cast<int>(bigdl::div(blockIdx.x, blocks_per_plane));
  const int pos = (blockIdx.x - plane * blocks_per_plane.d) * kThreads + threadIdx.x;
  if (pos >= h * w) return;
  const int ih = static_cast<int>(bigdl::div(pos, wd));
  const int iw = pos - ih * w;
  const float s = gather(wgt + static_cast<long long>(plane) * (oh * ow), ow,
                         window_range(ih + ph, kh, sh, oh),
                         window_range(iw + pw, kw, sw, ow));
  dx[static_cast<long long>(plane) * (h * w) + pos] = bigdl::from_f32<T>(s);
}

template <typename T>
__global__ void __launch_bounds__(kStageThreads)
avg_pool_bwd_staged(const T* __restrict__ wgt, T* __restrict__ dx, int nc,
                    int group, int slots, bigdl::FastDiv hwd,
                    bigdl::FastDiv wd, bigdl::FastDiv sh, bigdl::FastDiv sw,
                    int oh, int ow, int kh, int kw, int ph, int pw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hw = static_cast<int>(hwd.d), w = static_cast<int>(wd.d);
  const int ohw = oh * ow;
  T* const wtile = reinterpret_cast<T*>(smem_raw);
  T* const dtile = reinterpret_cast<T*>(
      smem_raw + bigdl::span_bytes(static_cast<long long>(group) * ohw, sizeof(T)));
  const long long p0 = static_cast<long long>(blockIdx.x) * group;
  const int planes = static_cast<int>(min(static_cast<long long>(group), nc - p0));
  const T* src = wgt + p0 * ohw;
  const int lead = bigdl::span_lead(src);
  bigdl::stage_span(wtile, src, planes * ohw, lead);
  bigdl::cp_commit();
  T* const dst = dx + p0 * hw;
  // the tile lies as far past 16 bytes as dst
  T* const dt = dtile + bigdl::span_lead(dst);
  bigdl::cp_wait<0>();
  __syncthreads();

  const T* const ws = wtile + lead;
  for (int l = threadIdx.x; l < slots * hw; l += kStageThreads) {
    const int slot = static_cast<int>(bigdl::div(l, hwd));
    const int pos = l - slot * hw;
    const int ih = static_cast<int>(bigdl::div(pos, wd));
    const int2 rows = window_range(ih + ph, kh, sh, oh);
    const int2 cols = window_range(pos - ih * w + pw, kw, sw, ow);
    if (rows.x == rows.y && cols.x == cols.y) {
      const int off = rows.x * ow + cols.x;
      for (int g = slot; g < planes; g += slots)
        dt[g * hw + pos] = bigdl::from_f32<T>(
            __fadd_rn(0.f, bigdl::to_f32(ws[g * ohw + off])));
    } else {
      for (int g = slot; g < planes; g += slots)
        dt[g * hw + pos] = bigdl::from_f32<T>(gather(ws + g * ohw, ow, rows, cols));
    }
  }
  __syncthreads();
  bigdl::store_span(dst, dt, planes * hw);
}

template <typename T>
cudaError_t launch(const void* wgt, void* dx, int nc, int h, int w, int oh,
                   int ow, int kh, int kw, int sh, int sw, int ph, int pw,
                   cudaStream_t stream) {
  const long long hw = static_cast<long long>(h) * w;
  const long long ohw = static_cast<long long>(oh) * ow;
  const long long plane_bytes = (hw + ohw) * static_cast<long long>(sizeof(T));
  const bigdl::FastDiv shd = bigdl::make_fastdiv(sh), swd = bigdl::make_fastdiv(sw);
  if (ohw > 0 && plane_bytes <= kStageBytes) {
    const long long fill = (nc + kFillBlocks - 1) / kFillBlocks;
    const long long most = kStageBytes / plane_bytes;
    const int group = static_cast<int>(fill < most ? fill : most);
    const int slots = hw < kStageThreads ? kStageThreads / static_cast<int>(hw) : 1;
    const unsigned blocks = static_cast<unsigned>((nc + group - 1) / group);
    const long long smem = bigdl::span_bytes(group * ohw, sizeof(T)) +
                           bigdl::span_bytes(group * hw, sizeof(T));
    avg_pool_bwd_staged<T><<<blocks, kStageThreads, static_cast<size_t>(smem), stream>>>(
        static_cast<const T*>(wgt), static_cast<T*>(dx), nc, group, slots,
        bigdl::make_fastdiv(static_cast<unsigned>(hw)), bigdl::make_fastdiv(w),
        shd, swd, oh, ow, kh, kw, ph, pw);
    return cudaGetLastError();
  }
  const long long per_plane = (hw + kThreads - 1) / kThreads;
  const long long blocks = per_plane * nc;
  if (hw >= (1LL << 31) || blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  avg_pool_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(wgt), static_cast<T*>(dx),
      bigdl::make_fastdiv(static_cast<unsigned>(per_plane)), bigdl::make_fastdiv(w),
      shd, swd, h, oh, ow, kh, kw, ph, pw);
  return cudaGetLastError();
}

}  // namespace

// wgt is a contiguous [nc, oh, ow] tensor and dx a contiguous [nc, h, w]
// tensor of one dtype (0 = f32, 1 = bf16); ph, pw are the low-side
// paddings.  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError().
extern "C" int bigdl_avg_pool_bwd(const void* wgt, void* dx, int nc, int h,
                                  int w, int oh, int ow, int kh, int kw,
                                  int sh, int sw, int ph, int pw, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(wgt, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(wgt, dx, nc, h, w, oh, ow, kh, kw, sh, sw, ph, pw, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
