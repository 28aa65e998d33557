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
// What bounds it on the card: 8 * D operations per live (q, k) pair (two
// score-sized products, dk and dv) against q, k, v, do read and dk, dv
// written once; in f32 on the CUDA cores the operations bound it.
//
// Design: one CTA per (b*h, 64-row k tile); the k and v tiles stay in
// shared memory and each q, do tile (with its rows' lse and delta) is
// staged there in turn.  A thread forms a 4 x 4 block of the transposed
// tiles s^T and (do . v)^T (rows: keys ty+16i, columns: queries tx+16j)
// with float4 loads over the head dim, writes p^T and ds^T to shared
// memory, and accumulates its 4 x NJ blocks of dk and dv in registers.  Causal q tiles before the diagonal are
// skipped (the Pallas liveness test), the diagonal tile masked per entry;
// rows past sq of a ragged q tile count as masked.  No atomics; the q
// tiles are summed in the Pallas kernel's order.

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
    return dispatch<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, bh, sq, sk, d,
                                   scale, causal != 0, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
