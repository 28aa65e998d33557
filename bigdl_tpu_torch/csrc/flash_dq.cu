// Flash-attention dq for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/attention.py::_dq_kernel (launched by
// _flash_bwd_impl, pl.pallas_call over the grid (b*h, nq, nk)).
//
// For each (batch*head, q row), over the k tiles in order:
//   s  = (q . k) * scale, masked entries -1e30 (as the forward)
//   p  = s > -1e30/2 ? exp(s - lse) : 0
//   ds = p * (do . v - delta) * scale
//   dq += ds k
// delta = sum(do * out, -1) comes in f32 from the wrapper, as JAX forms it
// outside Pallas.  dq has the input's dtype.
//
// Two kernels, chosen by dtype; a launch never falls back to the other.
//
// bf16: flash_dq_tc, on the tensor cores.  What bounds it on the card:
// at the training shape ([32,8,512,64] causal) 6 * D operations per live
// (q, k) pair (S, dP and dq), 12.9 GFLOP, 0.0131 ms at the 989 TFLOP/s of
// bf16 products, against q, k, v, do, lse and delta read and dq written
// once, 0.025 ms at 3.35 TB/s: the bytes bound it.  Design: one CTA of 4
// warps per (b*h, 64-row q tile), heavy causal tiles first; each warp
// owns 16 q rows.  The Q and dO tiles are copied once and stay in shared
// memory; each warp reads its rows' A fragments of both by ldmatrix at
// every k16 step (held in registers instead, they took 118/166/238
// registers at head dims 32/64/128 against 80/98/168, and the kernel was
// 6% slower at the training shape: chip_ab.py, NVIDIA H100 80GB HBM3,
// 700.00 W).  The 64-row K and V tiles stream through a
// two-stage cp.async ring (tile kt + 1 in flight while tile kt is used;
// rows past sk and columns past d zero-filled by a source size of 0).
// Per k tile, in chunks of 32 keys: S = Q K^T and dP = dO V^T are
// mma.sync m16n8k16 products with K and V read by ldmatrix as [n][k]
// B operands; P = exp2(s scale log2e - lse log2e) with the -1e30 / 2 test
// on the masked score (the Pallas liveness test per tile, then per entry
// where the chunk is not wholly visible to the warp's rows), and
// dS = P (dP - delta) scale, on the f32 fragments; dS goes from the
// accumulators straight into the A operand of dQ += dS K (the C layout of
// two n8 tiles is the A layout of one k16 step), with K read along the
// sequence by ldmatrix.trans, so dS never touches shared memory.  dq
// stays in f32 registers across the k tiles, summed in the Pallas order,
// and is written once in bf16, staged through the warp's own Q rows for
// 16-byte stores.  A warp none of whose rows exists or sees a key of a
// chunk skips it.  Head dims 1..128 run as 32, 64 or 128 columns; d % 8
// != 0 (or an unaligned tensor) loads and stores elements instead of
// 16-byte chunks, in the same kernel.
//
// Numerics of the bf16 kernel against the plain version (f32 throughout):
// the products of bf16 values are exact in f32, so S and dP differ only
// by the order of their sums; dS is rounded to bf16 before dS K (the
// Pallas kernel keeps it in f32), a relative error of at most 2^-9 per
// term, as flash_dkv_tc rounds P^T and dS^T; dq is rounded to bf16 at the
// end in both.  The budget stays inside the bf16 tolerance (2e-2) of
// chip_smoke.py.
//
// f32: flash_dq_kernel, on the CUDA cores, unchanged (f32 is held to
// rtol 1e-5, which rules out bf16 operands and TF32); the operations
// bound it.  Design: one CTA per (b*h, 64-row q tile); the q and do tiles
// stay in shared memory and each k, v tile is staged there in turn.  A
// thread forms a 4 x 4 block of s and of do . v over the head dim
// (float4 loads), turns it into ds, writes ds to shared memory and
// accumulates its 4 x NJ block of dq in registers.
//
// Both: causal k tiles past the diagonal are skipped (the Pallas liveness
// test), the diagonal tile masked per entry; a row that sees no key gets
// dq exactly 0.  No atomics; the k tiles are summed in the Pallas
// kernel's order.

#include "flash.cuh"

namespace {

using namespace bigdl::flash;

constexpr int smem_floats(int d) {
  return 4 * kTile * ld(d) + kTile * kTS;  // q, do, k, v tiles; ds
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int sq, int sk, int d, float scale,
                bool causal) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * ld(d);
  float* ks = dos + kTile * ld(d);
  float* vs = ks + kTile * ld(d);
  float* dss = vs + kTile * ld(d);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = sk - sq;
  const long long qbase = static_cast<long long>(bh) * sq;
  const T* kb = k + static_cast<long long>(bh) * sk * d;
  const T* vb = v + static_cast<long long>(bh) * sk * d;
  int col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) col[j] = min(tx + 16 * j, d - 1);

  load_tile(qs, q + qbase * d, q0, sq, d);
  load_tile(dos, dout + qbase * d, q0, sq, d);
  float row_lse[4], row_delta[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    row_lse[i] = r < sq ? lse[qbase + r] : 0.f;
    row_delta[i] = r < sq ? delta[qbase + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (sk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!live(causal, q0, sq, k0, off)) break;
    __syncthreads();  // the previous tile's k and ds are consumed
    load_tile(ks, kb, k0, sk, d);
    load_tile(vs, vb, k0, sk, d);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    dot_rows(s, qs, ty, ks, tx, d);
    dot_rows(dp, dos, ty, vs, tx, d);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float sv = visible(causal, r, c, sk, off) ? s[i][j] * scale : kNegInf;
        const float p = sv > kNegInf / 2 ? expf(sv - row_lse[i]) : 0.f;
        dss[(ty + 16 * i) * kTS + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
    __syncthreads();

    mul_tile(acc, dss, ty, ks, col, min(kTile, sk - k0), d);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    T* row = dq + (qbase + r) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) row[c] = bigdl::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int sq, int sk, int d, float scale,
                   bool causal, cudaStream_t stream) {
  static bool ready = false;
  const int bytes = smem_floats(d) * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(flash_dq_kernel<T, NJ>,
                               smem_floats(kMaxD) * static_cast<int>(sizeof(float)),
                               &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_dq_kernel<T, NJ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, int bh, int sq, int sk, int d, float scale,
                     bool causal, cudaStream_t s) {
  if (d <= 32)
    return launch<T, 2>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, causal, s);
  if (d <= 64)
    return launch<T, 4>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, causal, s);
  return launch<T, 8>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, causal, s);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int DP>
constexpr int tc_smem_bytes() {
  // q, do; two stages of k and v
  return 6 * kTile * tc::stride(DP) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int DP>
__global__ void __launch_bounds__(tc::kThreads)
flash_dq_tc(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, int sq, int sk, int d,
            float scale, float scale_log2, bool causal, bool vec) {
  constexpr int LD = tc::stride(DP);
  constexpr int KS = DP / 16;  // k16 steps over the head dim
  constexpr int NT = DP / 8;   // n8 tiles of dq
  constexpr int KC = 32;       // keys per chunk
  constexpr int CT = KC / 8;   // n8 tiles of a chunk's S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile * LD;
  __nv_bfloat16* ks = dos + kTile * LD;     // stage s at ks + s * kTile * LD
  __nv_bfloat16* vs = ks + 2 * kTile * LD;  // likewise

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = sk - sq;
  const long long qbase = static_cast<long long>(bh) * sq;
  const __nv_bfloat16* kb = k + static_cast<long long>(bh) * sk * d;
  const __nv_bfloat16* vb = v + static_cast<long long>(bh) * sk * d;
  // this warp's rows: w0 .. w0 + 15; this thread's: w0 + g and w0 + g + 8
  const int w0 = q0 + warp * 16;
  const int w_last = min(w0 + 15, sq - 1);
  const int nk = (sk + kTile - 1) / kTile;
  int n_live = 0;  // live k tiles are a prefix
  while (n_live < nk && live(causal, q0, sq, n_live * kTile, off)) ++n_live;

  tc::load_tile<DP>(qs, q + qbase * d, q0, sq, d, vec);
  tc::load_tile<DP>(dos, dout + qbase * d, q0, sq, d, vec);
  tc::cp_commit();
  if (n_live > 0) {
    tc::load_tile<DP>(ks, kb, 0, sk, d, vec);
    tc::load_tile<DP>(vs, vb, 0, sk, d, vec);
  }
  tc::cp_commit();
  float lse2[2], dl[2];  // this thread's rows' lse (base 2) and delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w0 + g + 8 * h;
    lse2[h] = r < sq ? lse[qbase + r] * tc::kLog2e : 0.f;
    dl[h] = r < sq ? delta[qbase + r] : 0.f;
  }
  // q and do have landed (k and v tile 0 may be in flight): with no live
  // k tile, the epilogue reuses the q rows at once
  tc::cp_wait<1>();
  __syncthreads();
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
    const __nv_bfloat16* kst = ks + stage * kTile * LD;
    const __nv_bfloat16* vst = vs + stage * kTile * LD;
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += KC) {
      const int kc = k0 + c0;  // the chunk's first key
      // a chunk with no key, or none that a row of the warp sees, adds
      // only zeros: the warp skips it
      if (w0 >= sq || kc >= sk || (causal && w_last + off < kc)) continue;
      float s[CT][4], dp[CT][4];
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned qf[4], df[4];
        tc::ldsm_x4(qf, qs + tc::a_offset<DP>(lane, warp * 16, 16 * kk));
        tc::ldsm_x4(df, dos + tc::a_offset<DP>(lane, warp * 16, 16 * kk));
#pragma unroll
        for (int jj = 0; jj < CT / 2; ++jj) {
          unsigned b[4];
          tc::ldsm_x4(b, kst + tc::b_offset<DP>(lane, c0 + 16 * jj, 16 * kk));
          tc::mma_bf16(s[2 * jj], qf, b[0], b[1]);
          tc::mma_bf16(s[2 * jj + 1], qf, b[2], b[3]);
          tc::ldsm_x4(b, vst + tc::b_offset<DP>(lane, c0 + 16 * jj, 16 * kk));
          tc::mma_bf16(dp[2 * jj], df, b[0], b[1]);
          tc::mma_bf16(dp[2 * jj + 1], df, b[2], b[3]);
        }
      }

      // every key of the chunk exists and every row of the warp sees it
      const bool full = kc + KC <= sk && (!causal || w0 + off >= kc + KC - 1);
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int c = kc + 8 * j + 2 * t + (e & 1);
          const bool vis = full || visible(causal, w0 + g + 8 * h, c, sk, off);
          const float x = vis ? s[j][e] * scale_log2 : kNegInf;
          const float p = x > kNegInf / 2 ? exp2f(x - lse2[h]) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[h]) * scale;  // dS
        }

#pragma unroll
      for (int kk = 0; kk < CT / 2; ++kk) {  // keys c0 + 16 kk .. + 15
        unsigned a[4];
        tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int nn = 0; nn < NT / 2; ++nn) {
          unsigned b[4];
          tc::ldsm_x4_t(b, kst + tc::bt_offset<DP>(lane, c0 + 16 * kk, 16 * nn));
          tc::mma_bf16(acc[2 * nn], a, b[0], b[1]);
          tc::mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  // dq through the warp's own q rows of shared memory (no other warp
  // reads them, and this warp is done with them), then to global memory
  __nv_bfloat16* rows = qs + warp * 16 * LD;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<unsigned*>(rows + (g + 8 * h) * LD + 8 * n + 2 * t) =
          tc::pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
  __syncwarp();
  tc::store_rows<DP>(dq + qbase * d, qs, warp * 16, q0, sq, d, vec, lane);
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int sq, int sk, int d, float scale,
                      bool causal, cudaStream_t stream) {
  static bool ready = false;
  cudaError_t err = allow_smem(flash_dq_tc<DP>, tc_smem_bytes<DP>(), &ready);
  if (err != cudaSuccess) return err;
  const bool vec = d % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) &&
                   tc::aligned16(v) && tc::aligned16(dout) &&
                   tc::aligned16(dq);
  const dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_dq_tc<DP><<<grid, tc::kThreads, tc_smem_bytes<DP>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), sq, sk, d, scale, scale * tc::kLog2e,
      causal, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int bh, int sq, int sk, int d, float scale,
                        bool causal, cudaStream_t s) {
  switch (tc::padded_d(d)) {
    case 32:
      return launch_tc<32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale,
                           causal, s);
    case 64:
      return launch_tc<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale,
                           causal, s);
    default:
      return launch_tc<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                            scale, causal, s);
  }
}

}  // namespace

// q, do, dq: contiguous [bh, sq, d]; k, v: contiguous [bh, sk, d], all of
// one dtype (0 = f32, 1 = bf16); lse, delta: contiguous f32 [bh, sq].
// 1 <= d <= 128, sq, sk >= 1.  Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError().
extern "C" int bigdl_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, int bh, int sq,
                              int sk, int d, float scale, int causal,
                              int dtype, void* stream) {
  if (d < 1 || d > kMaxD || sq < 1 || sk < 1 || bh < 1 ||
      (sq + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == bigdl::kF32)
    return dispatch<float>(q, k, v, dout, l, dl, dq, bh, sq, sk, d, scale, causal != 0, s);
  if (dtype == bigdl::kBF16)
    return dispatch_tc(q, k, v, dout, l, dl, dq, bh, sq, sk, d, scale,
                       causal != 0, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
