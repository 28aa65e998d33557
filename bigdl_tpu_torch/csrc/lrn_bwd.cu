// Cross-map LRN backward for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/lrn_pallas.py::_cml_bwd_kernel (launched by
// _cml_bwd_pallas through _cml_call, pl.pallas_call).
//
// Over NCHW x, the forward's den and the output gradient g, with a zero
// channel halo of half = (n-1)/2 on each side:
//   t[i]  = g[i] * x[i] * den[i]^(-beta-1)
//   dx[i] = g[i] * den[i]^-beta - (2*alpha*beta/n) * x[i] * sum_{d=0..n-1} t[i-half+d]
// For an odd band the transposed window of the backward is the forward's
// window, and the sum runs in band order d = 0..n-1 from t[i-half], the
// order of the Pallas kernel.  The Pallas kernel pads den with 1.0 and
// x, g with 0 so that the halo's t is 0; here t is 0 outside [0, c)
// directly.  Powers are exp(p * log(den)), rsqrt when p == -0.5
// (lrn_pallas.py::_pow), the two powers of an element sharing one logf
// (expf and logf, not their fast-math forms, so that they round as
// torch.exp and torch.log do).  Multiplies and adds are kept apart
// (__fmul_rn, __fadd_rn, __fsub_rn) in the plain version's association,
// (g*x)*den^p1, g*den^p0 and (c2*x)*sum, so that no FMA rounds
// differently from it.
//
// What bounds it on the card: bytes, once the instructions are few
// enough.  x, den and g are read once and dx is written once (4 tensors;
// norm2 [256,192,56,56] in bf16 is 1.23 GB, 0.368 ms at 3.35 TB/s).  An
// element also takes one logf and two expf, its band's n adds and a few
// multiplies, some 50 instructions an output: at 528 warp instructions a
// clock on 132 SMs and 1.755-1.98 GHz about 0.25-0.3 ms at norm2, under
// the byte bound only when each element's loads and powers are formed
// close to once.
//
// Design: a thread owns V consecutive pixels of one image, 8 bytes of
// each tensor (4 pixels in bf16, 2 in f32; 2 in bf16 for bands 7 to 13
// and 1 for 15, whose rings would not fit the registers otherwise), and
// walks a chunk of up to 64 channels, plus the band's halo, so each
// element's loads and powers are formed (chunk + n - 1) / chunk times
// (1.06 at both sites) rather than 1.25.  Each channel step is one
// V-wide load of x, of den and of g (issued a step
// ahead, from a channel clamped into [0, c), so the loads need no
// branch), and one V-wide store of dx.  Per pixel it keeps rings of the
// last n values of t and of HALF + 1 values of g*den^-beta and c2*x in
// registers, indexed by the step modulo n in a loop unrolled n times, so
// the rings rotate by register naming.  Consecutive threads take
// consecutive pixel vectors (one contiguous line a warp); the chunks
// are sized so that a launch has about kFillThreads threads.  Pixel
// counts that are no multiple of V, or bases off V elements, take the
// same kernel with V = 1 (an element a thread), chosen on the host by
// shape and alignment; both give the plain version's bits.  No shared
// memory, no atomics.
//
// On an H100 SXM (700 W), norm2 in bf16: the first design (one thread a
// pixel, 16-channel chunks, scalar 2-byte accesses, a logf for each
// power) took 0.815 ms, 45% of the byte bound; this one 0.566 ms, 65%,
// with 104 registers (two blocks, 16 warps an SM) and about 65 warp
// instructions an output, each of the two near 60% of its peak rate.
// Tried and dropped: 8 pixels a thread in bf16 (16-byte accesses), which
// needed all 128 registers and spilled 60 bytes at n = 5, as 4 pixels did
// at n = 9 (and at n = 7 in f32); 2 pixels in bf16 (slower); 4 pixels
// in f32 (16-byte accesses, slower than 2); a cap of 85 registers (three
// blocks an SM), faster in bf16 but spilling 88 bytes.

#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// two blocks an SM at least: caps the registers at 128, which the rings
// of 4 pixels at n = 5 (32 values) and the powers' temporaries fit
// without spilling
constexpr int kMinBlocks = 2;
// channels a thread walks, at most and at the least
constexpr int kMaxChunk = 64;
constexpr int kMinChunk = 16;
// threads a launch aims at (about three waves of two blocks on each of
// the card's 132 SMs), where the chunks allow it
constexpr long long kFillThreads = 196608;

// Pixels a thread owns for band n: 8 bytes of each tensor, where the
// rings of the band leave room for them under the register cap.
template <typename T, int SIZE>
constexpr int vec_width() {
  constexpr int most = SIZE <= 5 ? 4 : SIZE <= 13 ? 2 : 1;
  constexpr int fit = 8 / static_cast<int>(sizeof(T));
  return fit < most ? fit : most;
}

template <typename T, int V>
__device__ __forceinline__ void unpack(float (&v)[V],
                                       const typename bigdl::RawBits<V * sizeof(T)>::type& raw) {
  T q[V];
  memcpy(q, &raw, sizeof(q));
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = bigdl::to_f32(q[e]);
}

// den^p from log_d = logf(den): with ANY_RSQRT false neither power of
// the launch is -0.5, and the rsqrt branch is compiled out of the loop.
template <bool ANY_RSQRT>
__device__ __forceinline__ float power(float d, float log_d, float p) {
  return ANY_RSQRT ? bigdl::pow_from_log(d, log_d, p) : expf(__fmul_rn(p, log_d));
}

// One thread's walk over output channels [c0, c1) of its V pixels at
// base (the element offset of channel 0).
template <typename T, int SIZE, int V, bool ANY_RSQRT>
__device__ __forceinline__ void walk(const T* __restrict__ x,
                                     const T* __restrict__ den,
                                     const T* __restrict__ g,
                                     T* __restrict__ dx, int c, int hw,
                                     int c0, int c1, long long base, float c2,
                                     float p0, float p1) {
  constexpr int HALF = (SIZE - 1) / 2;
  using Raw = typename bigdl::RawBits<V * sizeof(T)>::type;
  // step s loads channel c0 - HALF + s and, from s = 2 * HALF on, writes
  // channel c0 - 2 * HALF + s
  const int steps = c1 - c0 + 2 * HALF;

  Raw nx, nd, ng;  // the next step's inputs
  auto load = [&](int s) {
    const int ch = min(max(c0 - HALF + s, 0), c - 1);
    const long long off = base + static_cast<long long>(ch) * hw;
    nx = *reinterpret_cast<const Raw*>(x + off);
    nd = *reinterpret_cast<const Raw*>(den + off);
    ng = *reinterpret_cast<const Raw*>(g + off);
  };
  load(0);

  // slot s % SIZE of each ring holds step s's values
  float tr[SIZE][V], ar[SIZE][V], cr[SIZE][V];
  for (int s0 = 0; s0 < steps; s0 += SIZE) {
#pragma unroll
    for (int r = 0; r < SIZE; ++r) {
      const int s = s0 + r;
      if (s >= steps) break;
      float xv[V], dv[V], gv[V];
      unpack<T, V>(xv, nx);
      unpack<T, V>(dv, nd);
      unpack<T, V>(gv, ng);
      load(s + 1);
      const int ch = c0 - HALF + s;
      const bool in = ch >= 0 && ch < c;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float log_d = logf(dv[e]);
        const float t = __fmul_rn(__fmul_rn(gv[e], xv[e]),
                                  power<ANY_RSQRT>(dv[e], log_d, p1));
        tr[r][e] = in ? t : 0.f;
        ar[r][e] = __fmul_rn(gv[e], power<ANY_RSQRT>(dv[e], log_d, p0));
        cr[r][e] = __fmul_rn(c2, xv[e]);
      }
      if (s >= 2 * HALF) {
        // the band of channel ch - HALF: steps s - 2*HALF .. s, slots
        // r + 1 .. r + SIZE modulo SIZE; its own a and c2*x at step s - HALF
        const int own = (r + SIZE - HALF) % SIZE;
        T q[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float sum = tr[(r + 1) % SIZE][e];
#pragma unroll
          for (int d = 1; d < SIZE; ++d) sum = __fadd_rn(sum, tr[(r + 1 + d) % SIZE][e]);
          q[e] = bigdl::from_f32<T>(__fsub_rn(ar[own][e], __fmul_rn(cr[own][e], sum)));
        }
        Raw out;
        memcpy(&out, q, sizeof(q));
        *reinterpret_cast<Raw*>(dx + base + static_cast<long long>(ch - HALF) * hw) = out;
      }
    }
  }
}

template <typename T, int SIZE, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cml_bwd_kernel(const T* __restrict__ x, const T* __restrict__ den,
               const T* __restrict__ g, T* __restrict__ dx, int c, int hw,
               int vecs, int nchunks, int chunk, long long total, float c2,
               float p0, float p1) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int v = static_cast<int>(idx % vecs);
  const long long rest = idx / vecs;
  const int c0 = static_cast<int>(rest % nchunks) * chunk;
  const int c1 = min(c, c0 + chunk);  // output channels [c0, c1)
  const long long base = (rest / nchunks) * static_cast<long long>(c) * hw +
                         static_cast<long long>(v) * V;
  // a branch of the whole launch, taken before the loop rather than at
  // each power of each element
  if (p0 == -0.5f || p1 == -0.5f)
    walk<T, SIZE, V, true>(x, den, g, dx, c, hw, c0, c1, base, c2, p0, p1);
  else
    walk<T, SIZE, V, false>(x, den, g, dx, c, hw, c0, c1, base, c2, p0, p1);
}

template <typename T, int SIZE, int V>
cudaError_t launch_as(const T* x, const T* den, const T* g, T* dx, int n,
                      int c, int hw, float c2, float p0, float p1,
                      cudaStream_t stream) {
  const int vecs = hw / V;
  const long long per_chunk = static_cast<long long>(n) * vecs;
  const long long fill = (kFillThreads + per_chunk - 1) / per_chunk;
  const long long fewest = (c + kMaxChunk - 1) / kMaxChunk;
  const long long most = (c + kMinChunk - 1) / kMinChunk;
  const int want = static_cast<int>(fill < fewest ? fewest : fill > most ? most : fill);
  const int chunk = (c + want - 1) / want;
  const int nchunks = (c + chunk - 1) / chunk;
  const long long total = per_chunk * nchunks;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cml_bwd_kernel<T, SIZE, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, den, g, dx, c, hw, vecs, nchunks, chunk, total, c2, p0, p1);
  return cudaGetLastError();
}

template <typename T, int SIZE>
cudaError_t launch_size(const void* x, const void* den, const void* g,
                        void* dx, int n, int c, int hw, float c2, float p0,
                        float p1, cudaStream_t stream) {
  constexpr int V = vec_width<T, SIZE>();
  constexpr unsigned long long kAlign = V * sizeof(T);
  const T* xs = static_cast<const T*>(x);
  const T* ds = static_cast<const T*>(den);
  const T* gs = static_cast<const T*>(g);
  T* dxs = static_cast<T*>(dx);
  const bool vec = hw % V == 0 &&
                   (reinterpret_cast<unsigned long long>(x) |
                    reinterpret_cast<unsigned long long>(den) |
                    reinterpret_cast<unsigned long long>(g) |
                    reinterpret_cast<unsigned long long>(dx)) % kAlign == 0;
  if (vec)
    return launch_as<T, SIZE, V>(xs, ds, gs, dxs, n, c, hw, c2, p0, p1, stream);
  return launch_as<T, SIZE, 1>(xs, ds, gs, dxs, n, c, hw, c2, p0, p1, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* den, const void* g, void* dx,
                   int n, int c, int hw, int size, float c2, float p0,
                   float p1, cudaStream_t stream) {
  switch (size) {
#define BIGDL_CML_CASE(S) \
  case S:                 \
    return launch_size<T, S>(x, den, g, dx, n, c, hw, c2, p0, p1, stream);
    BIGDL_CML_CASE(1)
    BIGDL_CML_CASE(3)
    BIGDL_CML_CASE(5)
    BIGDL_CML_CASE(7)
    BIGDL_CML_CASE(9)
    BIGDL_CML_CASE(11)
    BIGDL_CML_CASE(13)
    BIGDL_CML_CASE(15)
#undef BIGDL_CML_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, den, g and dx are contiguous [n, c, hw] tensors of one dtype
// (0 = f32, 1 = bf16); c2 is 2*alpha*beta/size, p0 is -beta and p1 is
// -beta-1.  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError().
extern "C" int bigdl_cml_bwd(const void* x, const void* den, const void* g,
                             void* dx, int n, int c, int hw, int size,
                             float c2, float p0, float p1, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return launch<float>(x, den, g, dx, n, c, hw, size, c2, p0, p1, s);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, den, g, dx, n, c, hw, size, c2, p0, p1, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
