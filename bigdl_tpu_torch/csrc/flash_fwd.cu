// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_fwd_impl, pl.pallas_call over the grid (b*h, nq, nk)).
//
// For each (batch*head, q row):
//   s   = (q . k) * scale over the keys, masked entries -1e30 (causal: row
//         r sees the keys c <= r + sk - sq; keys past sk do not exist)
//   online softmax over the k tiles in order: m_new = max(m, max s),
//   alpha = exp(m - m_new), p = s > -1e30/2 ? exp(s - m_new) : 0,
//   l = l * alpha + sum p, acc = acc * alpha + p v
//   out = acc / l, lse = m + log l   (l == 0: out 0, lse -1e30)
// out has the input's dtype, lse is f32 [b*h, sq].
//
// Two kernels, chosen by dtype; a launch never falls back to the other.
//
// bf16: flash_fwd_tc, on the tensor cores.  What bounds it on the card:
// at the training shape ([32,8,512,64] causal) 4 * D operations per live
// (q, k) pair, 8.6 GFLOP, 0.0087 ms at the 989 TFLOP/s of bf16 products,
// against q, k, v read and out, lse written once, 0.020 ms at 3.35 TB/s:
// the bytes bound it.  Design: one CTA of 4 warps per (b*h, 64-row q
// tile), heavy causal tiles first.  Each warp owns 16 q rows; their Q
// fragments go from shared memory to registers once (ldmatrix) and stay
// there.  The 64-row K and V tiles stream through a two-stage cp.async
// ring (tile kt + 1 is in flight while tile kt is used; rows past sk and
// columns past d zero-filled by a source size of 0).  S = Q K^T is 8 n8
// tiles of mma.sync m16n8k16 over the head dim, K read by ldmatrix as the
// col-major B operand; the mask (the Pallas liveness test per tile, then
// per entry where the tile is not wholly visible to the warp's rows) and
// the online softmax run on the f32 fragments, a row's four owners (a
// quad) reducing by 2 xor-shuffles, in base 2 (scale * log2 e folded into
// the scores; m kept in that unit, lse converted back).  P goes from the
// S accumulators straight into the A operand of P V (the m16n8k16 C
// layout of two n8 tiles is the A layout of one k16 step), so it never
// touches shared memory, and V is read with ldmatrix.trans.  Shared rows
// are padded by 16 bytes, so ldmatrix and the cp.async stores are free of
// bank conflicts.  The output tile is staged through the warp's own Q
// rows and written with 16-byte stores.  Head dims 1..128 run as 32, 64
// or 128 columns; d % 8 != 0 (or an unaligned tensor) loads and stores
// elements instead of 16-byte chunks, in the same kernel.
//
// Numerics of the bf16 kernel against the plain version (f32 throughout):
// the products of bf16 values are exact in f32, so S differs only by the
// order of its sums; P is rounded to bf16 before P V (the Pallas kernel
// keeps it in f32), a relative error of at most 2^-9 per term, while l
// sums the unrounded P.  out is rounded to bf16 at the end in both, so
// the budget stays inside the bf16 tolerance (2e-2) of chip_smoke.py.
//
// f32: flash_fwd_kernel, on the CUDA cores, unchanged (f32 is held to
// rtol 1e-5, which rules out bf16 operands and TF32).  In f32 the
// operations bound it (67 TFLOP/s of f32 FMAs).  Design: the Pallas grid's
// sequential k axis becomes a loop inside one CTA per (b*h, 64-row q
// tile).  The q tile stays in shared memory; each 64-row k and v tile is
// staged there in turn.  A thread computes a 4 x 4 block of the 64 x 64
// score tile (rows ty+16i, keys tx+16j) with FMAs over the head dim,
// keeps its rows' m and l in registers (the row's 16 owners reduce by
// shuffles), writes p to shared memory and accumulates its 4 x NJ block
// of acc in registers.  Shared memory is read as float4s along the head
// dim and along p's rows: at two FMAs per 4-byte load the loads would
// hold an SM to half its FMA rate.
//
// Both: with causal, k tiles past the diagonal are never loaded (the
// Pallas liveness test on the tile's last existing row); the diagonal
// tile is masked per entry.  No atomics: every output has one writer, and
// the k tiles are summed in the Pallas kernel's order.

#include "flash.cuh"

namespace {

using namespace bigdl::flash;

constexpr int smem_floats(int d) {
  return 3 * kTile * ld(d) + kTile * kTS;  // q, k, v tiles; p
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, float scale,
                 bool causal) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kTile * ld(d);
  float* vs = ks + kTile * ld(d);
  float* ps = vs + kTile * ld(d);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = sk - sq;
  const T* kb = k + static_cast<long long>(bh) * sk * d;
  const T* vb = v + static_cast<long long>(bh) * sk * d;
  int col[NJ];  // this thread's head-dim columns, clamped into the row
#pragma unroll
  for (int j = 0; j < NJ; ++j) col[j] = min(tx + 16 * j, d - 1);

  load_tile(qs, q + static_cast<long long>(bh) * sq * d, q0, sq, d);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (sk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!live(causal, q0, sq, k0, off)) break;
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_tile(ks, kb, k0, sk, d);
    load_tile(vs, vb, k0, sk, d);
    __syncthreads();

    float s[4][4] = {};
    dot_rows(s, qs, ty, ks, tx, d);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        s[i][j] = visible(causal, r, c, sk, off) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > kNegInf / 2 ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kTS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    mul_tile(acc, ps, ty, vs, col, min(kTile, sk - k0), d);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (static_cast<long long>(bh) * sq + r) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[c] = bigdl::from_f32<T>(acc[i][j] / l_safe);
    }
    if (tx == 0) lse[static_cast<long long>(bh) * sq + r] = m[i] + logf(l_safe);
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int bh, int sq, int sk, int d, float scale,
                   bool causal, cudaStream_t stream) {
  static bool ready = false;
  const int bytes = smem_floats(d) * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(flash_fwd_kernel<T, NJ>,
                               smem_floats(kMaxD) * static_cast<int>(sizeof(float)),
                               &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int bh, int sq, int sk, int d, float scale,
                     bool causal, cudaStream_t s) {
  if (d <= 32) return launch<T, 2>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
  if (d <= 64) return launch<T, 4>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
  return launch<T, 8>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int DP>
constexpr int tc_smem_bytes() {
  // q; two stages of k and v
  return 5 * kTile * tc::stride(DP) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int DP>
__global__ void __launch_bounds__(tc::kThreads)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int sq,
             int sk, int d, float scale_log2, bool causal, bool vec) {
  constexpr int LD = tc::stride(DP);
  constexpr int KS = DP / 16;  // k16 steps over the head dim
  constexpr int NT = DP / 8;   // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTile * LD;      // stage s at ks + s * kTile * LD
  __nv_bfloat16* vs = ks + 2 * kTile * LD;  // likewise

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = sk - sq;
  const __nv_bfloat16* qb = q + static_cast<long long>(bh) * sq * d;
  const __nv_bfloat16* kb = k + static_cast<long long>(bh) * sk * d;
  const __nv_bfloat16* vb = v + static_cast<long long>(bh) * sk * d;
  // this warp's rows: w0 .. w0 + 15; this thread's: w0 + g and w0 + g + 8
  const int w0 = q0 + warp * 16;
  const int w_last = min(w0 + 15, sq - 1);
  const int nk = (sk + kTile - 1) / kTile;
  int n_live = 0;  // live k tiles are a prefix
  while (n_live < nk && live(causal, q0, sq, n_live * kTile, off)) ++n_live;

  tc::load_tile<DP>(qs, qb, q0, sq, d, vec);
  tc::cp_commit();
  if (n_live > 0) {
    tc::load_tile<DP>(ks, kb, 0, sk, d, vec);
    tc::load_tile<DP>(vs, vb, 0, sk, d, vec);
  }
  tc::cp_commit();
  tc::cp_wait<1>();
  __syncthreads();
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    tc::ldsm_x4(qf[kk], qs + tc::a_offset<DP>(lane, warp * 16, 16 * kk));

  float m[2] = {kNegInf, kNegInf};  // base 2, scaled
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kTile;
    const int stage = kt & 1;
    if (kt + 1 < n_live) {
      const int next = (stage ^ 1) * kTile * LD;
      tc::load_tile<DP>(ks + next, kb, k0 + kTile, sk, d, vec);
      tc::load_tile<DP>(vs + next, vb, k0 + kTile, sk, d, vec);
    }
    tc::cp_commit();
    tc::cp_wait<1>();  // tile kt has landed (tile kt + 1 may be in flight)
    __syncthreads();
    // a warp none of whose rows exists or sees a key of this tile would
    // only multiply by alpha = 1 and add p = 0: it skips the tile
    if (w0 < sq && !(causal && w_last + off < k0)) {
      const __nv_bfloat16* kst = ks + stage * kTile * LD;
      const __nv_bfloat16* vst = vs + stage * kTile * LD;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          unsigned b[4];
          tc::ldsm_x4(b, kst + tc::b_offset<DP>(lane, 16 * jj, 16 * kk));
          tc::mma_bf16(s[2 * jj], qf[kk], b[0], b[1]);
          tc::mma_bf16(s[2 * jj + 1], qf[kk], b[2], b[3]);
        }

      // every key of the tile exists and every row of the warp sees it
      const bool full = k0 + kTile <= sk && (!causal || w0 + off >= k0 + kTile - 1);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          float x = s[j][e] * scale_log2;
          const int c = k0 + 8 * j + 2 * t + (e & 1);
          if (!full && !visible(causal, w0 + g + 8 * h, c, sk, off))
            x = kNegInf;
          s[j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = tc::quad_max(mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const float p = s[j][e] > kNegInf / 2 ? exp2f(s[j][e] - m[h]) : 0.f;
          s[j][e] = p;
          l[h] += p;
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
        unsigned a[4];
        tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int nn = 0; nn < NT / 2; ++nn) {
          unsigned b[4];
          tc::ldsm_x4_t(b, vst + tc::bt_offset<DP>(lane, 16 * kk, 16 * nn));
          tc::mma_bf16(o[2 * nn], a, b[0], b[1]);
          tc::mma_bf16(o[2 * nn + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  // out = o / l through the warp's own q rows of shared memory (no other
  // warp reads them), then to global memory
  __nv_bfloat16* stage_rows = qs + warp * 16 * LD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = tc::quad_sum(l[h]);
    const float inv = sum == 0.f ? 1.f : 1.f / sum;
    const int r = w0 + g + 8 * h;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<unsigned*>(stage_rows + (g + 8 * h) * LD + 8 * n + 2 * t) =
          tc::pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    if (t == 0 && r < sq)
      lse[static_cast<long long>(bh) * sq + r] =
          sum == 0.f ? kNegInf : m[h] / tc::kLog2e + logf(sum);
  }
  __syncwarp();
  tc::store_rows<DP>(out + static_cast<long long>(bh) * sq * d, qs, warp * 16,
                     q0, sq, d, vec, lane);
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int bh, int sq, int sk, int d, float scale,
                      bool causal, cudaStream_t stream) {
  static bool ready = false;
  cudaError_t err = allow_smem(flash_fwd_tc<DP>, tc_smem_bytes<DP>(), &ready);
  if (err != cudaSuccess) return err;
  const bool vec = d % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) &&
                   tc::aligned16(v) && tc::aligned16(out);
  const dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_fwd_tc<DP><<<grid, tc::kThreads, tc_smem_bytes<DP>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, sq, sk, d, scale * tc::kLog2e, causal, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* out,
                        float* lse, int bh, int sq, int sk, int d, float scale,
                        bool causal, cudaStream_t s) {
  switch (tc::padded_d(d)) {
    case 32: return launch_tc<32>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
    case 64: return launch_tc<64>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
    default: return launch_tc<128>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
  }
}

}  // namespace

// q, out: contiguous [bh, sq, d]; k, v: contiguous [bh, sk, d], all of one
// dtype (0 = f32, 1 = bf16); lse: contiguous f32 [bh, sq].  1 <= d <= 128,
// sq, sk >= 1.  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError().
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int bh, int sq, int sk,
                               int d, float scale, int causal, int dtype,
                               void* stream) {
  if (d < 1 || d > kMaxD || sq < 1 || sk < 1 || bh < 1 ||
      (sq + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == bigdl::kF32)
    return dispatch<float>(q, k, v, out, l, bh, sq, sk, d, scale, causal != 0, s);
  if (dtype == bigdl::kBF16)
    return dispatch_tc(q, k, v, out, l, bh, sq, sk, d, scale, causal != 0, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
