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
// What bounds it on the card: 6 * D operations per live (q, k) pair (two
// score-sized products and dq) against q, k, v, do read and dq written
// once; in f32 on the CUDA cores the operations bound it.
//
// Design: one CTA per (b*h, 64-row q tile); the q and do tiles stay in
// shared memory and each k, v tile is staged there in turn.  A thread
// forms a 4 x 4 block of s and of do . v over the head dim (float4 loads),
// turns it into ds, writes ds to shared memory and accumulates its
// 4 x NJ block of dq in registers.  Causal k tiles past the diagonal are
// skipped (the Pallas liveness test), the diagonal tile masked per entry.
// No atomics; the k tiles are summed in the Pallas kernel's order.

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
    return dispatch<__nv_bfloat16>(q, k, v, dout, l, dl, dq, bh, sq, sk, d, scale,
                                   causal != 0, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
