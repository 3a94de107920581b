// The trainable fused attention blocks of the Item Q-Former, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of unirec_tpu/ops/fused_qformer_vjp.py:
//   B12s fwd  _self_fwd_kernel   (call :218)
//             qkv = x . Wqkv + bqkv (saved); per-item softmax attention over
//             the item's K rows with a per-key bias; ctx (saved);
//             out = ctx . Wo + bo.  Stops before dropout, residual and LN.
//   B12s bwd  _self_bwd_kernel   (call :260)
//             dctx = dout . Wo^T (fp32); recomputes p per item and head; the
//             softmax VJP; writes dqkv.
//   B12c fwd  _cross_fwd_kernel  (call :421)
//             q = x . Wq + bq, kv = mem . Wkv + bkv (both saved); per-item
//             attention of the K query rows over the item's F field rows with
//             the per-key bias; ctx (saved); out = ctx . Wo + bo.
//   B12c bwd  _cross_bwd_kernel  (call :472)
//             dctx = dout . Wo^T; the softmax VJP; writes dq and dkv.
// dx, dmem, the weight gradients and the bias sums stay outside (torch, as
// the JAX package leaves them to XLA).
//
// What bounds them at the item-training shape (512 items, hidden 1024, 16
// heads of 64, K=32, F=14): the forwards are projection GEMMs (B12s 140
// GFLOP against ~210 MB of HBM traffic, B12c 100 GFLOP against ~190 MB), so
// tensor-core arithmetic; the backwards do one [rows, D] x [D, D] GEMM plus
// the per-item attention VJP (~40 GFLOP) while reading qkv / q, kv and dout
// and writing their gradients (~240 MB for B12s), so they sit near the byte
// bound.
//
// Design (first version: right and simple):
//   * every projection inside the Pallas bodies (x . Wqkv, x . Wq, mem . Wkv,
//     ctx . Wo and dout . Wo^T) is gemm_bf16_kernel (gemm_bf16.cuh,
//     mma.sync), with the +bias -> bf16 epilogue, or the bare fp32 one for
//     dctx (Wo^T is passed transposed, [D_in, D_out], so that its contracted
//     dimension is contiguous);
//   * the TPU kernels pack 256-row tiles of several items under a
//     block-diagonal bias (2 * NEG_INF off the item); exp of that is exactly
//     0, so attending within each item's own rows computes the same
//     function, and one block per (item, head) owns that item's rows of the
//     outputs: no atomics, identical bits run to run;
//   * attention_fwd_kernel: one block per (item, head, tile of up to 64 query
//     rows), s = (q . k) * scale + bias in fp32 (the scale after the
//     product, unlike B1/B2 which round q * scale to bf16), p = e * (1 /
//     sum e) in fp32, rounded to bf16 before the value product, which
//     accumulates in fp32; ctx in bf16;
//   * attention_bwd_kernel: one block per (item, head) holding the item's q,
//     k and v of the head (bf16), dctx (fp32), p and dp / ds (fp32) in
//     shared memory: p recomputed as in the forward, dp = bf16(dctx) . v^T,
//     ds = bf16(p * (dp - sum(dp * p)) * scale), dq = ds . k, dk = ds^T . q,
//     dv = p^T . dctx with p and dctx in fp32 (the JAX kernel's rounding
//     points).  The shared-memory footprint grows with K * F: the kernel
//     takes up to 227 KB (K = F = 128 at head dim 64).
// An item with no valid key (every bias -1e9) averages its own value rows
// uniformly, as the packed JAX kernel does.
//
// Every C entry launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_bf16.cuh"

namespace {

constexpr int FWD_THREADS = 128;
constexpr int BWD_THREADS = 256;
constexpr int MAX_FWD_TILE = 64;     // query rows per forward block
constexpr int SMEM_LIMIT = 232448;   // what a block may use on sm_90 (227 KB)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// bf16 row pitch in shared memory: even, and an odd number of 4-byte words,
// so that threads on neighbouring rows hit different banks
__host__ __device__ __forceinline__ int bf_pitch(int hd) {
  int words = (hd + 1) / 2;
  if (words % 2 == 0) ++words;
  return 2 * words;
}

__host__ __device__ __forceinline__ int fwd_smem(int qt, int nkv, int hd) {
  return (int)sizeof(float) * (qt * (hd + 1) + qt * (nkv + 1)) +
         (int)sizeof(bf16) * 2 * nkv * bf_pitch(hd);
}

__host__ __device__ __forceinline__ int bwd_smem(int nq, int nkv, int hd) {
  return (int)sizeof(float) * (nq * (hd + 1) + 2 * nq * (nkv + 1)) +
         (int)sizeof(bf16) * (nq + 2 * nkv) * bf_pitch(hd);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block per (item, head, tile of up to `qt` query rows).  q rows:
// item*nq + i at q + row*q_stride + h*hd; k / v rows: item*nkv + j at
// kv + row*kv_stride + {k_off, v_off} + h*hd; ctx rows as q's, stride
// ctx_stride.  key_bias [items * nkv] fp32 (nullptr: none).
__global__ void __launch_bounds__(FWD_THREADS)
attention_fwd_kernel(const bf16* __restrict__ q, int q_stride, const bf16* __restrict__ kv,
                     int kv_stride, int k_off, int v_off, const float* __restrict__ key_bias,
                     bf16* __restrict__ ctx, int ctx_stride, int nq, int nkv, int hd, int qt,
                     float scale) {
  extern __shared__ float sm[];
  const int hs = hd + 1;  // padded rows: conflict-free column walks
  const int ss = nkv + 1;
  const int kp = bf_pitch(hd);
  float* Qs = sm;           // [qt][hs]
  float* S = Qs + qt * hs;  // [qt][ss] scores, then e, then bf16-rounded p
  bf16* Ks = reinterpret_cast<bf16*>(S + qt * ss);  // [nkv][kp]
  bf16* Vs = Ks + nkv * kp;                         // [nkv][kp]
  const int item = blockIdx.x;
  const int col0 = blockIdx.y * hd;
  const int i0 = blockIdx.z * qt;
  const int rows = min(qt, nq - i0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < rows * hd; e += FWD_THREADS) {
    const int i = e / hd, d = e - i * hd;
    Qs[i * hs + d] = __bfloat162float(q[(size_t)(item * nq + i0 + i) * q_stride + col0 + d]);
  }
  for (int e = tid; e < nkv * hd; e += FWD_THREADS) {
    const int j = e / hd, d = e - j * hd;
    const size_t base = (size_t)(item * nkv + j) * kv_stride + col0 + d;
    Ks[j * kp + d] = kv[base + k_off];
    Vs[j * kp + d] = kv[base + v_off];
  }
  __syncthreads();

  for (int e = tid; e < rows * nkv; e += FWD_THREADS) {
    const int i = e / nkv, j = e - i * nkv;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(Qs[i * hs + d], __bfloat162float(Ks[j * kp + d]), s);
    const float b = key_bias != nullptr ? key_bias[(size_t)item * nkv + j] : 0.f;
    S[i * ss + j] = s * scale + b;  // (q . k) * scale + bias, in fp32
  }
  __syncthreads();

  for (int i = warp; i < rows; i += FWD_THREADS / 32) {
    float m = -INFINITY;
    for (int j = lane; j < nkv; j += 32) m = fmaxf(m, S[i * ss + j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < nkv; j += 32) {
      const float e = expf(S[i * ss + j] - m);
      S[i * ss + j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < nkv; j += 32) S[i * ss + j] = round_bf16(S[i * ss + j] * inv);
  }
  __syncthreads();

  for (int e = tid; e < rows * hd; e += FWD_THREADS) {
    const int i = e / hd, d = e - i * hd;
    float c = 0.f;
    for (int j = 0; j < nkv; ++j) c = fmaf(S[i * ss + j], __bfloat162float(Vs[j * kp + d]), c);
    ctx[(size_t)(item * nq + i0 + i) * ctx_stride + col0 + d] = __float2bfloat16(c);
  }
}

// One block per (item, head): the softmax VJP of the item's nq query rows
// over its nkv key rows.  Layouts as attention_fwd_kernel's; dctx [rows,
// dctx_stride] fp32; dq rows as q's (stride dq_stride); dk / dv rows as k's
// at dkv + row*dkv_stride + {dk_off, dv_off} + h*hd.
__global__ void __launch_bounds__(BWD_THREADS)
attention_bwd_kernel(const bf16* __restrict__ q, int q_stride, const bf16* __restrict__ kv,
                     int kv_stride, int k_off, int v_off, const float* __restrict__ key_bias,
                     const float* __restrict__ dctx, int dctx_stride, bf16* __restrict__ dq,
                     int dq_stride, bf16* __restrict__ dkv, int dkv_stride, int dk_off,
                     int dv_off, int nq, int nkv, int hd, float scale) {
  extern __shared__ float sm[];
  const int hs = hd + 1;
  const int ss = nkv + 1;
  const int kp = bf_pitch(hd);
  float* Ds = sm;            // [nq][hs] dctx
  float* P = Ds + nq * hs;   // [nq][ss] scores, then e, then p
  float* G = P + nq * ss;    // [nq][ss] dp, then bf16-rounded ds
  bf16* Qs = reinterpret_cast<bf16*>(G + nq * ss);  // [nq][kp]
  bf16* Ks = Qs + nq * kp;                          // [nkv][kp]
  bf16* Vs = Ks + nkv * kp;                         // [nkv][kp]
  const int item = blockIdx.x;
  const int col0 = blockIdx.y * hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < nq * hd; e += BWD_THREADS) {
    const int i = e / hd, d = e - i * hd;
    const size_t row = (size_t)(item * nq + i);
    Qs[i * kp + d] = q[row * q_stride + col0 + d];
    Ds[i * hs + d] = dctx[row * dctx_stride + col0 + d];
  }
  for (int e = tid; e < nkv * hd; e += BWD_THREADS) {
    const int j = e / hd, d = e - j * hd;
    const size_t base = (size_t)(item * nkv + j) * kv_stride + col0 + d;
    Ks[j * kp + d] = kv[base + k_off];
    Vs[j * kp + d] = kv[base + v_off];
  }
  __syncthreads();

  // scores as the forward computes them, and dp = bf16(dctx) . v^T
  for (int e = tid; e < nq * nkv; e += BWD_THREADS) {
    const int i = e / nkv, j = e - i * nkv;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < hd; ++d) {
      s = fmaf(__bfloat162float(Qs[i * kp + d]), __bfloat162float(Ks[j * kp + d]), s);
      dp = fmaf(round_bf16(Ds[i * hs + d]), __bfloat162float(Vs[j * kp + d]), dp);
    }
    const float b = key_bias != nullptr ? key_bias[(size_t)item * nkv + j] : 0.f;
    P[i * ss + j] = s * scale + b;
    G[i * ss + j] = dp;
  }
  __syncthreads();

  // per row (one warp): p = e * (1 / sum e); ds = p * (dp - sum(dp * p));
  // bf16(ds * scale).  Each lane keeps to its own columns j = lane + 32t.
  for (int i = warp; i < nq; i += BWD_THREADS / 32) {
    float m = -INFINITY;
    for (int j = lane; j < nkv; j += 32) m = fmaxf(m, P[i * ss + j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < nkv; j += 32) {
      const float e = expf(P[i * ss + j] - m);
      P[i * ss + j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    float dot = 0.f;
    for (int j = lane; j < nkv; j += 32) {
      const float p = P[i * ss + j] * inv;
      P[i * ss + j] = p;
      dot = fmaf(G[i * ss + j], p, dot);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < nkv; j += 32) {
      const float p = P[i * ss + j];
      G[i * ss + j] = round_bf16((p * (G[i * ss + j] - dot)) * scale);
    }
  }
  __syncthreads();

  for (int e = tid; e < nq * hd; e += BWD_THREADS) {  // dq = ds . k
    const int i = e / hd, d = e - i * hd;
    float acc = 0.f;
    for (int j = 0; j < nkv; ++j) acc = fmaf(G[i * ss + j], __bfloat162float(Ks[j * kp + d]), acc);
    dq[(size_t)(item * nq + i) * dq_stride + col0 + d] = __float2bfloat16(acc);
  }
  for (int e = tid; e < nkv * hd; e += BWD_THREADS) {  // dk = ds^T . q, dv = p^T . dctx
    const int j = e / hd, d = e - j * hd;
    float ak = 0.f, av = 0.f;
    for (int i = 0; i < nq; ++i) {
      ak = fmaf(G[i * ss + j], __bfloat162float(Qs[i * kp + d]), ak);
      av = fmaf(P[i * ss + j], Ds[i * hs + d], av);
    }
    const size_t base = (size_t)(item * nkv + j) * dkv_stride + col0 + d;
    dkv[base + dk_off] = __float2bfloat16(ak);
    dkv[base + dv_off] = __float2bfloat16(av);
  }
}

cudaError_t attention_fwd(const void* q, int q_stride, const void* kv, int kv_stride, int k_off,
                          int v_off, const float* key_bias, void* ctx, int ctx_stride, int items,
                          int heads, int nq, int nkv, int hd, float scale, cudaStream_t stream) {
  int qt = min(nq, MAX_FWD_TILE);
  while (qt > 1 && fwd_smem(qt, nkv, hd) > SMEM_LIMIT) qt = (qt + 1) / 2;
  const int bytes = fwd_smem(qt, nkv, hd);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(items, heads, (nq + qt - 1) / qt);
  attention_fwd_kernel<<<grid, FWD_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), q_stride, static_cast<const bf16*>(kv), kv_stride, k_off,
      v_off, key_bias, static_cast<bf16*>(ctx), ctx_stride, nq, nkv, hd, qt, scale);
  return cudaGetLastError();
}

cudaError_t attention_bwd(const void* q, int q_stride, const void* kv, int kv_stride, int k_off,
                          int v_off, const float* key_bias, const float* dctx, int dctx_stride,
                          void* dq, int dq_stride, void* dkv, int dkv_stride, int dk_off,
                          int dv_off, int items, int heads, int nq, int nkv, int hd, float scale,
                          cudaStream_t stream) {
  const int bytes = bwd_smem(nq, nkv, hd);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(items, heads);
  attention_bwd_kernel<<<grid, BWD_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), q_stride, static_cast<const bf16*>(kv), kv_stride, k_off,
      v_off, key_bias, dctx, dctx_stride, static_cast<bf16*>(dq), dq_stride,
      static_cast<bf16*>(dkv), dkv_stride, dk_off, dv_off, nq, nkv, hd, scale);
  return cudaGetLastError();
}

bool shape_ok(long long items, int heads, int nq, int nkv, int d) {
  return items > 0 && items <= 2147483647 / 512 && heads > 0 && heads <= 65535 &&
         d % heads == 0 && nq > 0 && nkv > 0 && (nq + MAX_FWD_TILE - 1) / MAX_FWD_TILE <= 65535;
}

}  // namespace

#define UNIREC_TRY(call)                     \
  do {                                       \
    const cudaError_t e_ = (call);           \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

// B12s forward.  x, out [items*nq, d] bf16; wqkv [3d, d] (rows Wq | Wk | Wv);
// bqkv [3d] fp32; wo [d, d]; bo [d] fp32; key_bias [items*nq] fp32; outputs
// qkv [items*nq, 3d] and ctx [items*nq, d] bf16 (the backward's residuals).
extern "C" int unirec_b12_self_fwd(const void* x, const void* wqkv, const float* bqkv,
                                   const void* wo, const float* bo, const float* key_bias,
                                   void* out, void* qkv, void* ctx, int items, int nq, int d,
                                   int heads, float scale, void* stream) {
  const long long rows = (long long)items * nq;
  if (!shape_ok(items, heads, nq, nq, d) || rows > 2147483647 || !gemm_shape_ok(rows, 3 * d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm<EPI_BIAS>(x, wqkv, bqkv, nullptr, qkv, m, 3 * d, d, s));
  UNIREC_TRY(attention_fwd(qkv, 3 * d, qkv, 3 * d, d, 2 * d, key_bias, ctx, d, items, heads, nq,
                           nq, hd, scale, s));
  return (int)gemm<EPI_BIAS>(ctx, wo, bo, nullptr, out, m, d, d, s);
}

// B12s backward.  qkv [items*nq, 3d] bf16 and key_bias as saved by the
// forward; wo_t [d, d] = Wo transposed (rows: Wo's input columns); dout
// [items*nq, d] bf16; scratch dctx [items*nq, d] fp32; output dqkv
// [items*nq, 3d] bf16.
extern "C" int unirec_b12_self_bwd(const void* qkv, const void* wo_t, const float* key_bias,
                                   const void* dout, float* dctx, void* dqkv, int items, int nq,
                                   int d, int heads, float scale, void* stream) {
  const long long rows = (long long)items * nq;
  if (!shape_ok(items, heads, nq, nq, d) || rows > 2147483647 || !gemm_shape_ok(rows, d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm<EPI_F32>(dout, wo_t, nullptr, nullptr, dctx, m, d, d, s));
  return (int)attention_bwd(qkv, 3 * d, qkv, 3 * d, d, 2 * d, key_bias, dctx, d, dqkv, 3 * d,
                            dqkv, 3 * d, d, 2 * d, items, heads, nq, nq, hd, scale, s);
}

// B12c forward.  x, out [items*nq, d] bf16; mem [items*nkv, dm] bf16;
// key_bias [items*nkv] fp32; wq [d, d], wkv [2d, dm] (rows Wk | Wv), wo
// [d, d] bf16 with fp32 biases; outputs q [items*nq, d], kv [items*nkv, 2d]
// and ctx [items*nq, d] bf16 (the backward's residuals).
extern "C" int unirec_b12_cross_fwd(const void* x, const void* mem, const float* key_bias,
                                    const void* wq, const float* bq, const void* wkv,
                                    const float* bkv, const void* wo, const float* bo, void* out,
                                    void* q, void* kv, void* ctx, int items, int nq, int nkv,
                                    int d, int dm, int heads, float scale, void* stream) {
  const long long rows = (long long)items * nq;
  const long long mem_rows = (long long)items * nkv;
  if (!shape_ok(items, heads, nq, nkv, d) || rows > 2147483647 || mem_rows > 2147483647 ||
      !gemm_shape_ok(rows, d, d) || !gemm_shape_ok(mem_rows, 2 * d, dm))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm<EPI_BIAS>(x, wq, bq, nullptr, q, m, d, d, s));
  UNIREC_TRY(gemm<EPI_BIAS>(mem, wkv, bkv, nullptr, kv, (int)mem_rows, 2 * d, dm, s));
  UNIREC_TRY(attention_fwd(q, d, kv, 2 * d, 0, d, key_bias, ctx, d, items, heads, nq, nkv, hd,
                           scale, s));
  return (int)gemm<EPI_BIAS>(ctx, wo, bo, nullptr, out, m, d, d, s);
}

// B12c backward.  q [items*nq, d], kv [items*nkv, 2d] bf16 and key_bias as
// saved by the forward; wo_t [d, d] = Wo transposed; dout [items*nq, d]
// bf16; scratch dctx [items*nq, d] fp32; outputs dq [items*nq, d] and dkv
// [items*nkv, 2d] bf16.
extern "C" int unirec_b12_cross_bwd(const void* q, const void* kv, const void* wo_t,
                                    const float* key_bias, const void* dout, float* dctx,
                                    void* dq, void* dkv, int items, int nq, int nkv, int d,
                                    int heads, float scale, void* stream) {
  const long long rows = (long long)items * nq;
  if (!shape_ok(items, heads, nq, nkv, d) || rows > 2147483647 ||
      (long long)items * nkv > 2147483647 || !gemm_shape_ok(rows, d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm<EPI_F32>(dout, wo_t, nullptr, nullptr, dctx, m, d, d, s));
  return (int)attention_bwd(q, d, kv, 2 * d, 0, d, key_bias, dctx, d, dq, d, dkv, 2 * d, 0, d,
                            items, heads, nq, nkv, hd, scale, s);
}
