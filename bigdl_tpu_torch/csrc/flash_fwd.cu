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
// What bounds it on the card: at the training shape ([32,8,512,64]
// causal) 4 * D operations per live (q, k) pair against q, k, v read and
// out written once.  In f32 on the CUDA cores (the Pallas kernel casts
// every block to f32, and this port keeps that arithmetic) the operations
// bound it; in bf16 against the tensor cores' rate the bytes would.
//
// Design: the Pallas grid's sequential k axis becomes a loop inside one
// CTA per (b*h, 64-row q tile).  The q tile stays in shared memory; each
// 64-row k and v tile is staged there in turn, converted to f32.  A
// thread computes a 4 x 4 block of the 64 x 64 score tile (rows ty+16i,
// keys tx+16j) with FMAs over the head dim, keeps its rows' m and l in
// registers (the row's 16 owners reduce by shuffles), writes p to shared
// memory and accumulates its 4 x NJ block of acc in registers.  Shared
// memory is read as float4s along the head dim and along p's rows: at
// two FMAs per 4-byte load the loads would hold an SM to half its FMA
// rate.  With
// causal, k tiles past the diagonal are never loaded (the Pallas liveness
// test on the tile's last existing row); the diagonal tile is masked per
// entry.  No atomics: every output has one writer, and the k tiles are
// summed in the Pallas kernel's order.  Heavy causal q tiles (the last
// ones) are scheduled first.

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
    return dispatch<__nv_bfloat16>(q, k, v, out, l, bh, sq, sk, d, scale, causal != 0, s);
  return cudaErrorInvalidValue;
}

BIGDL_EXPORT_ERROR_STRING
