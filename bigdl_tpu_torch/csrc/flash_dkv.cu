// Flash-attention dk and dv for Hopper (sm_90a).
//
// Replaces: bigdl_tpu/ops/attention.py::_dkv_kernel (launched by
// _flash_bwd_impl, pl.pallas_call over the grid (b*h, nk, nq)).
//
// For each (batch*head, key), over the q tiles in order:
//   s  = (q . k) * scale, masked entries -1e30 (as the forward)
//   p  = s > -1e30/2 ? exp(s - lse) : 0
//   ds = p * (do . v - delta) * scale
//   dv += p^T do,   dk += ds^T q
// dk and dv have the input's dtype.
//
// Two kernels, chosen by dtype; a launch never falls back to the other.
//
// bf16: flash_dkv_tc, on the tensor cores.  What bounds it on the card:
// at the training shape ([32,8,512,64] causal) 8 * D operations per live
// (q, k) pair (S^T, dP^T, dv and dk), 17.2 GFLOP, 0.0174 ms at the 989
// TFLOP/s of bf16 products, against q, k, v, do, lse and delta read and
// dk, dv written once, 0.030 ms at 3.35 TB/s: the bytes bound it.
// Design: one CTA of 4 warps per (b*h, 64-row k tile), heavy causal tiles
// (the first k tiles) first; each warp owns 16 keys.  The K and V tiles
// stay in shared memory; the q tiles with their do tile, lse and delta
// stream through a two-stage cp.async ring (zero-filled past sq and past
// d by a source size of 0).  Per q tile, in chunks of 32 queries:
// S^T = K Q^T and dP^T = V dO^T are mma.sync m16n8k16 products with K and
// V as row-major A operands and Q, dO as col-major B operands (ldmatrix);
// P^T = exp(S^T - lse) takes lse and delta from shared memory by column
// (the columns are queries), in base 2; dS^T = P^T (dP^T - delta) scale.
// P^T and dS^T go from the accumulators straight into the A operands of
// dV += P^T dO and dK += dS^T Q (the C layout of two n8 tiles is the A
// layout of one k16 step), with dO and Q read by ldmatrix.trans, so
// neither touches shared memory.  Shared rows are padded by 16 bytes
// (ldmatrix and cp.async free of bank conflicts).  dk and dv are staged
// through the warp's own K and V rows and written with 16-byte stores.
// Registers: the dk and dv accumulators take 64 a thread at head dim 64
// (128 at 128), S^T and dP^T of a 32-query chunk 32 more; K and V
// fragments are read from shared memory for each chunk rather than held.
// Chunks of 64 queries took 234 registers at head dim 64, two CTAs an SM,
// and 0.171 ms at the training shape; chunks of 32, 0.133 ms
// (chip_ab.py, NVIDIA H100 80GB HBM3, 700.00 W).
//
// Numerics of the bf16 kernel against the plain version (f32 throughout):
// the products of bf16 values are exact in f32, so S^T and dP^T differ
// only by the order of their sums; P^T and dS^T are rounded to bf16
// before the second products (the Pallas kernel keeps them in f32), a
// relative error of at most 2^-9 per term; dk and dv are rounded to bf16
// at the end in both.  The budget stays inside the bf16 tolerance (2e-2)
// of chip_smoke.py.
//
// f32: flash_dkv_kernel, on the CUDA cores, unchanged (f32 is held to
// rtol 1e-5, which rules out bf16 operands and TF32); the operations
// bound it.  Design: one CTA per (b*h, 64-row k tile); the k and v tiles
// stay in shared memory and each q, do tile (with its rows' lse and
// delta) is staged there in turn, converted to f32.  A thread forms a
// 4 x 4 block of the transposed tiles s^T and (do . v)^T (rows: keys
// ty+16i, columns: queries tx+16j) with float4 loads over the head dim,
// writes p^T and ds^T to shared memory, and accumulates its 4 x NJ
// blocks of dk and dv in registers.
//
// Both: causal q tiles before the diagonal are skipped (the Pallas
// liveness test), the diagonal tile masked per entry; rows past sq of a
// ragged q tile count as masked.  No atomics; the q tiles are summed in
// the Pallas kernel's order.

#include "flash.cuh"

namespace {

using namespace bigdl::flash;

constexpr int smem_floats(int d) {
  // k, v, q, do tiles; p^T and ds^T; the q tile's lse and delta
  return 4 * kTile * ld(d) + 2 * kTile * kTS + 2 * kTile;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int sq, int sk, int d, float scale,
                 bool causal) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTile * ld(d);
  float* qs = vs + kTile * ld(d);
  float* dos = qs + kTile * ld(d);
  float* pts = dos + kTile * ld(d);
  float* dts = pts + kTile * kTS;
  float* lse_s = dts + kTile * kTS;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = sk - sq;
  const long long qbase = static_cast<long long>(bh) * sq;
  const long long kbase = static_cast<long long>(bh) * sk;
  int col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) col[j] = min(tx + 16 * j, d - 1);

  load_tile(ks, k + kbase * d, k0, sk, d);
  load_tile(vs, v + kbase * d, k0, sk, d);
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (sq + kTile - 1) / kTile;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    if (!live(causal, q0, sq, k0, off)) continue;
    __syncthreads();  // the previous tile's q, do, p^T and ds^T are consumed
    load_tile(qs, q + qbase * d, q0, sq, d);
    load_tile(dos, dout + qbase * d, q0, sq, d);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < sq ? lse[qbase + r] : 0.f;
      delta_s[threadIdx.x] = r < sq ? delta[qbase + r] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    dot_rows(s, ks, ty, qs, tx, d);
    dot_rows(dp, vs, ty, dos, tx, d);

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = tx + 16 * j;
      const int r = q0 + qc;
      const float row_lse = lse_s[qc], row_delta = delta_s[qc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k0 + ty + 16 * i;
        const bool vis = r < sq && visible(causal, r, c, sk, off);
        const float sv = vis ? s[i][j] * scale : kNegInf;
        const float p = sv > kNegInf / 2 ? expf(sv - row_lse) : 0.f;
        pts[(ty + 16 * i) * kTS + qc] = p;
        dts[(ty + 16 * i) * kTS + qc] = p * (dp[i][j] - row_delta) * scale;
      }
    }
    __syncthreads();

    const int qn = min(kTile, sq - q0);
    mul_tile(dv_acc, pts, ty, dos, col, qn, d);
    mul_tile(dk_acc, dts, ty, qs, col, qn, d);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= sk) continue;
    T* krow = dk + (kbase + c) * d;
    T* vrow = dv + (kbase + c) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = tx + 16 * j;
      if (e < d) {
        krow[e] = bigdl::from_f32<T>(dk_acc[i][j]);
        vrow[e] = bigdl::from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int bh, int sq, int sk, int d,
                   float scale, bool causal, cudaStream_t stream) {
  static bool ready = false;
  const int bytes = smem_floats(d) * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(flash_dkv_kernel<T, NJ>,
                               smem_floats(kMaxD) * static_cast<int>(sizeof(float)),
                               &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sk + kTile - 1) / kTile);
  flash_dkv_kernel<T, NJ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int bh, int sq, int sk, int d,
                     float scale, bool causal, cudaStream_t s) {
  if (d <= 32)
    return launch<T, 2>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, causal, s);
  if (d <= 64)
    return launch<T, 4>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, causal, s);
  return launch<T, 8>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, causal, s);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int DP>
constexpr int tc_smem_bytes() {
  // k, v; two stages of q, do, lse and delta
  return 6 * kTile * tc::stride(DP) * static_cast<int>(sizeof(__nv_bfloat16)) +
         4 * kTile * static_cast<int>(sizeof(float));
}

template <int DP>
__global__ void __launch_bounds__(tc::kThreads)
flash_dkv_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             int sq, int sk, int d, float scale, float scale_log2, bool causal,
             bool vec) {
  constexpr int LD = tc::stride(DP);
  constexpr int KS = DP / 16;             // k16 steps over the head dim
  constexpr int NT = DP / 8;              // n8 tiles of dk and dv
  constexpr int QC = 32;                  // queries per chunk
  constexpr int CT = QC / 8;              // n8 tiles of a chunk's S^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * LD;
  __nv_bfloat16* qs = vs + kTile * LD;       // stage s at qs + s * kTile * LD
  __nv_bfloat16* dos = qs + 2 * kTile * LD;  // likewise
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile * LD);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                              // [2][kTile]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = sk - sq;
  const long long qbase = static_cast<long long>(bh) * sq;
  const long long kbase = static_cast<long long>(bh) * sk;
  const __nv_bfloat16* qb = q + qbase * d;
  const __nv_bfloat16* dob = dout + qbase * d;
  // this warp's keys: kw .. kw + 15; this thread's: kw + g and kw + g + 8
  const int kw = k0 + warp * 16;
  const int nq = (sq + kTile - 1) / kTile;
  int first = 0;  // live q tiles are a suffix
  while (first < nq && !live(causal, first * kTile, sq, k0, off)) ++first;

  // the q tile at q0 (with its do tile, lse and delta) into stage st
  auto load_q_tile = [&](int q0, int st) {
    tc::load_tile<DP>(qs + st * kTile * LD, qb, q0, sq, d, vec);
    tc::load_tile<DP>(dos + st * kTile * LD, dob, q0, sq, d, vec);
    const int i = threadIdx.x % kTile;
    const bool ok = q0 + i < sq;
    if (threadIdx.x < kTile)
      tc::cp_async4(lse_s + st * kTile + i, lse + qbase + (ok ? q0 + i : 0), ok);
    else
      tc::cp_async4(delta_s + st * kTile + i, delta + qbase + (ok ? q0 + i : 0), ok);
  };

  tc::load_tile<DP>(ks, k + kbase * d, k0, sk, d, vec);
  tc::load_tile<DP>(vs, v + kbase * d, k0, sk, d, vec);
  if (first < nq) load_q_tile(first * kTile, 0);
  tc::cp_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    const int stage = (qt - first) & 1;
    if (qt + 1 < nq) load_q_tile(q0 + kTile, stage ^ 1);
    tc::cp_commit();
    tc::cp_wait<1>();  // tile qt has landed (tile qt + 1 may be in flight)
    __syncthreads();
    const __nv_bfloat16* qst = qs + stage * kTile * LD;
    const __nv_bfloat16* dost = dos + stage * kTile * LD;
    const float* lse_t = lse_s + stage * kTile;
    const float* delta_t = delta_s + stage * kTile;
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += QC) {
      const int qc = q0 + c0;  // the chunk's first query
      const int qc_last = min(qc + QC, sq) - 1;
      // a chunk with no query, or none that sees one of the warp's keys,
      // adds only zeros: the warp skips it
      if (qc >= sq || kw >= sk || (causal && qc_last + off < kw)) continue;
      float s[CT][4], dp[CT][4];
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned ka[4], va[4];
        tc::ldsm_x4(ka, ks + tc::a_offset<DP>(lane, warp * 16, 16 * kk));
        tc::ldsm_x4(va, vs + tc::a_offset<DP>(lane, warp * 16, 16 * kk));
#pragma unroll
        for (int jj = 0; jj < CT / 2; ++jj) {
          unsigned b[4];
          tc::ldsm_x4(b, qst + tc::b_offset<DP>(lane, c0 + 16 * jj, 16 * kk));
          tc::mma_bf16(s[2 * jj], ka, b[0], b[1]);
          tc::mma_bf16(s[2 * jj + 1], ka, b[2], b[3]);
          tc::ldsm_x4(b, dost + tc::b_offset<DP>(lane, c0 + 16 * jj, 16 * kk));
          tc::mma_bf16(dp[2 * jj], va, b[0], b[1]);
          tc::mma_bf16(dp[2 * jj + 1], va, b[2], b[3]);
        }
      }

      // every query of the chunk exists and sees every key of the warp
      const bool full = qc + QC <= sq && kw + 16 <= sk &&
                        (!causal || qc + off >= kw + 15);
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);  // query in the tile
          const int r = q0 + col;
          const bool vis =
              full || (r < sq && visible(causal, r, kw + g + 8 * (e / 2), sk, off));
          const float p =
              vis ? exp2f(s[j][e] * scale_log2 - lse_t[col] * tc::kLog2e) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_t[col]) * scale;
        }

#pragma unroll
      for (int kk = 0; kk < CT / 2; ++kk) {  // queries c0 + 16 kk .. + 15
        unsigned pa[4], da[4];
        tc::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        tc::acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int nn = 0; nn < NT / 2; ++nn) {
          unsigned b[4];
          tc::ldsm_x4_t(b, dost + tc::bt_offset<DP>(lane, c0 + 16 * kk, 16 * nn));
          tc::mma_bf16(dv_acc[2 * nn], pa, b[0], b[1]);
          tc::mma_bf16(dv_acc[2 * nn + 1], pa, b[2], b[3]);
          tc::ldsm_x4_t(b, qst + tc::bt_offset<DP>(lane, c0 + 16 * kk, 16 * nn));
          tc::mma_bf16(dk_acc[2 * nn], da, b[0], b[1]);
          tc::mma_bf16(dk_acc[2 * nn + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  // dk and dv through the warp's own k and v rows of shared memory (no
  // other warp reads them), then to global memory; with no live q tile
  // the k and v copies may still be in flight
  tc::cp_wait<0>();
  __syncthreads();
  __nv_bfloat16* k_rows = ks + warp * 16 * LD;
  __nv_bfloat16* v_rows = vs + warp * 16 * LD;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int at = (g + 8 * h) * LD + 8 * n + 2 * t;
      *reinterpret_cast<unsigned*>(k_rows + at) =
          tc::pack_bf16(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      *reinterpret_cast<unsigned*>(v_rows + at) =
          tc::pack_bf16(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  __syncwarp();
  tc::store_rows<DP>(dk + kbase * d, ks, warp * 16, k0, sk, d, vec, lane);
  tc::store_rows<DP>(dv + kbase * d, vs, warp * 16, k0, sk, d, vec, lane);
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, int bh, int sq, int sk, int d,
                      float scale, bool causal, cudaStream_t stream) {
  static bool ready = false;
  cudaError_t err = allow_smem(flash_dkv_tc<DP>, tc_smem_bytes<DP>(), &ready);
  if (err != cudaSuccess) return err;
  const bool vec = d % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) &&
                   tc::aligned16(v) && tc::aligned16(dout) &&
                   tc::aligned16(dk) && tc::aligned16(dv);
  const dim3 grid(bh, (sk + kTile - 1) / kTile);
  flash_dkv_tc<DP><<<grid, tc::kThreads, tc_smem_bytes<DP>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq, sk,
      d, scale, scale * tc::kLog2e, causal, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dk, void* dv, int bh, int sq, int sk, int d,
                        float scale, bool causal, cudaStream_t s) {
  switch (tc::padded_d(d)) {
    case 32:
      return launch_tc<32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                           scale, causal, s);
    case 64:
      return launch_tc<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                           scale, causal, s);
    default:
      return launch_tc<128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                           scale, causal, s);
  }
}

}  // namespace

// q, do: contiguous [bh, sq, d]; k, v, dk, dv: contiguous [bh, sk, d], all
// of one dtype (0 = f32, 1 = bf16); lse, delta: contiguous f32 [bh, sq].
// 1 <= d <= 128, sq, sk >= 1.  Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError().
extern "C" int bigdl_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int bh,
                               int sq, int sk, int d, float scale, int causal,
                               int dtype, void* stream) {
  if (d < 1 || d > kMaxD || sq < 1 || sk < 1 || bh < 1 ||
      (sk + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == bigdl::kF32)
    return dispatch<float>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, d, scale,
                           causal != 0, s);
  if (dtype == bigdl::kBF16)
    return dispatch_tc(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, d, scale,
                       causal != 0, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
