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
// heads of 64, K=32, F=14): the forwards are projection GEMMs (B12s 137.5
// GFLOP against ~210 MB of HBM traffic, B12c 100 GFLOP against ~190 MB), so
// tensor-core arithmetic; the backwards do one [rows, D] x [D, D] GEMM plus
// the per-item attention VJP (~40 GFLOP) while reading qkv / q, kv and dout
// and writing their gradients (~240 MB for B12s), so they sit near the byte
// bound.
//
// Design:
//   * every projection (x . Wqkv, x . Wq, mem . Wkv, ctx . Wo and dout .
//     Wo^T) is gemm_wide (gemm_wide.cuh): TMA tile loads by a producer warp
//     and wgmma.m64n256k16 in two consumer warpgroups, 128 x 256 tiles,
//     with the +bias -> bf16 epilogue, or the bare fp32 one for dctx (Wo^T
//     is passed transposed, [D_in, D_out], so that its contracted dimension
//     is contiguous); rows that are not 16-byte aligned take its cp.async
//     edge kernel;
//   * the attention, forward and backward, is the per-item core of
//     item_attention.cuh in its B12 rounding: whole items packed into
//     64-row tiles as the TPU kernels pack them, S, P V and the five
//     backward products on tensor cores, one block owning its items' rows of
//     every output (no atomics, identical bits run to run), any K, F and head
//     dim (resident or streamed tiles), rows of any width (2-byte loads where
//     16-byte copies do not align);
//   * the projections and the attention stay separate launches.  Fusing the
//     head's q / k / v projection into the attention block (the JAX kernel's
//     shape, :133-159) would save the qkv read-back (96 MB at 512 items,
//     about 0.03 ms at the card's byte rate) but shrink the GEMM to 64 x 192
//     tiles that re-read Wqkv for every tile of items; the measured split
//     (PERF.md) put the parent's time in the GEMM mainloop and the scalar
//     attention, not in the round trip.  The backward's dctx likewise stays
//     an fp32 GEMM output read back by the attention (67 MB each way).
// An item with no valid key (every bias -1e9) averages its own value rows
// uniformly, as the packed JAX kernel does.
//
// fp32 forms (the JAX kernels take float32 x too: qkv in x's dtype, :146;
// p in v's dtype, :79; ds, dq, dk and dv in fp32, :109-125): every
// projection on gemm_f32.cuh (fp32 FMA on CUDA cores; TF32 would break the
// fp32 gate of 1e-5), the forward's attention on attention_f32.cuh (B15's
// scalar kernel; o = (e . v) / l where the JAX kernel takes (e * (1 / l)) .
// v, within an ulp), and the backward's on the two scalar kernels below:
//   * bw_dq_kernel, one block per (item, head, 64 query rows): a pass over
//     the item's key tiles for each row's max m and sum l, a second for
//     D = sum_j p dp (p = e * (1 / l), dp = dctx . v), both written to a
//     scratch [items, heads, nq, 3]; then dq = ds . k with ds = p (dp - D)
//     scale, 64 output columns at a time (s and dp kept in registers where
//     one key tile and one column chunk cover the item);
//   * bw_dkv_kernel, one block per (item, head, 64 keys): over the item's
//     query tiles, p and ds again from the scratch's m, 1 / l and D, then
//     dk = ds^T . q and dv = p^T . dctx.
// Tiles of 64 x 64 in shared memory, 4 x 4 outputs a thread, every sum in a
// fixed order and every output with one owner: identical bits run to run.
// Any K, F and head dim.  Bound by operations at 67 TFLOP/s (fp32, CUDA
// cores); at the item-training shape the half-empty tiles (K = 32 of 64
// rows) waste most of them: tensor cores (3xTF32) and packed items are later
// work.
//
// Every C entry launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "gemm_f32.cuh"
#include "gemm_wide.cuh"
#include "item_attention.cuh"

namespace {

// what the kernels take: int32 row counts, a grid of at most 65,535 heads
// and query tiles of an item
bool shape_ok(long long items, int heads, int nq, int nkv, int d) {
  return items > 0 && heads > 0 && heads <= 65535 && d > 0 && d % heads == 0 && nq > 0 &&
         nkv > 0 && items * nq <= 2147483647 && items * nkv <= 2147483647 &&
         (nq + IA_TILE - 1) / IA_TILE <= 65535;
}

// ------------------------------------------- fp32 attention backward ----

struct BwArgs {
  const float* q;
  Strides qs;
  const float* k;
  Strides ks;
  const float* v;
  Strides vs;
  const float* dc;  // dctx [rows, d] fp32
  Strides dcs;
  const float* bias;  // [items * nkv]
  float* dq;
  Strides dqs;
  float* dk;
  Strides dks;
  float* dv;
  Strides dvs;
  float* stats;  // [items, heads, nq, 3]: m, 1 / l, D
  int heads, nq, nkv, hd;
  float scale;
};

constexpr int BW_SMEM = 6 * PT * PP * 4;

// dst[r][c] = base row r0 + r, column c0 + c, for r < nr and c0 + c < hd;
// zeros elsewhere (base: the item's and head's first element)
__device__ __forceinline__ void bw_load(float* dst, const float* base, long long rstride, int r0,
                                        int nr, int c0, int hd) {
  for (int e = threadIdx.x; e < PT * PT; e += P_THREADS) {
    const int r = e / PT, c = e - (e / PT) * PT;
    dst[r * PP + c] = r < nr && c0 + c < hd ? base[(r0 + r) * rstride + c0 + c] : 0.f;
  }
}

// acc[i][j] += sum over d < w of a[row ty + 16i][d] * b[row tx + 16j][d]
__device__ __forceinline__ void bw_dot(float (&acc)[4][4], const float* a, const float* b, int w) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int d = 0; d < w; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * PP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * PP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the item's and head's first element of t
__device__ __forceinline__ const float* bw_at(const float* t, Strides s, int item, int h) {
  return t + item * s.b + h * s.h;
}

// s = (q . k) * scale + bias (-inf past the item's keys) and dp = dctx . v
// for this thread's 4 x 4 (row, key) pairs: query rows r0 + ty + 16i, keys
// j0 + tx + 16j of the item; with_dp false leaves dp alone
__device__ __forceinline__ void bw_scores(const BwArgs& a, int item, int h, int r0, int nr,
                                          int j0, int nj, float* sm, bool with_dp,
                                          float (&s)[4][4], float (&dp)[4][4]) {
  float* Qs = sm;
  float* Ks = Qs + PT * PP;
  float* Ds = Ks + PT * PP;
  float* Vs = Ds + PT * PP;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      if (with_dp) dp[i][j] = 0.f;
    }
  for (int c = 0; c < a.hd; c += PT) {
    __syncthreads();  // every thread is done with the tiles
    bw_load(Qs, bw_at(a.q, a.qs, item, h), a.qs.r, r0, nr, c, a.hd);
    bw_load(Ks, bw_at(a.k, a.ks, item, h), a.ks.r, j0, nj, c, a.hd);
    if (with_dp) {
      bw_load(Ds, bw_at(a.dc, a.dcs, item, h), a.dcs.r, r0, nr, c, a.hd);
      bw_load(Vs, bw_at(a.v, a.vs, item, h), a.vs.r, j0, nj, c, a.hd);
    }
    __syncthreads();
    const int w = min(PT, a.hd - c);
    bw_dot(s, Qs, Ks, w);
    if (with_dp) bw_dot(dp, Ds, Vs, w);
  }
  const float* kb = a.bias + (size_t)item * a.nkv + j0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = tx + 16 * j;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i][j] = key < nj ? __fadd_rn(__fmul_rn(s[i][j], a.scale), kb[key]) : -INFINITY;
  }
}

// grid (items, heads, query tiles of 64 rows): the row statistics and dq
__global__ void __launch_bounds__(P_THREADS)
bw_dq_kernel(const BwArgs a) {
  extern __shared__ __align__(16) float bw_smem[];
  float* Ks = bw_smem + PT * PP;
  float* Ss = bw_smem + 4 * PT * PP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int item = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * PT, nr = min(PT, a.nq - r0);
  const int nkt = (a.nkv + PT - 1) / PT;
  const bool keep = nkt == 1 && a.hd <= PT;  // pass 1's s and dp serve every pass
  float s[4][4], dp[4][4], m[4], l[4], linv[4], D[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {  // pass 1: m and l
    const int j0 = kt * PT;
    bw_scores(a, item, h, r0, nr, j0, min(PT, a.nkv - j0), bw_smem, keep, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], pa_half_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                                     fmaxf(s[i][2], s[i][3]))));
      float sum = l[i] * expf(m[i] - mn);
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - mn);
      l[i] = sum;
      m[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) linv[i] = 1.0f / pa_half_sum(l[i]), D[i] = 0.f;
  // pass 2: D = sum_j p dp
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * PT;
    if (!keep) bw_scores(a, item, h, r0, nr, j0, min(PT, a.nkv - j0), bw_smem, true, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) D[i] = fmaf(expf(s[i][j] - m[i]) * linv[i], dp[i][j], D[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    D[i] = pa_half_sum(D[i]);
    const int r = ty + 16 * i;
    if (tx == 0 && r < nr) {
      float* st = a.stats + (((size_t)item * a.heads + h) * a.nq + r0 + r) * 3;
      st[0] = m[i], st[1] = linv[i], st[2] = D[i];
    }
  }
  // pass 3: dq = ds . k, 64 output columns at a time
  float* dqb = a.dq + item * a.dqs.b + h * a.dqs.h;
  for (int oc = 0; oc < a.hd; oc += PT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int j0 = kt * PT, nj = min(PT, a.nkv - j0);
      if (!keep) bw_scores(a, item, h, r0, nr, j0, nj, bw_smem, true, s, dp);
      __syncthreads();  // every thread is done with Ks and Ss
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m[i]) * linv[i];  // 0 past the keys
          Ss[(ty + 16 * i) * PP + tx + 16 * j] = p * (dp[i][j] - D[i]) * a.scale;
        }
      bw_load(Ks, bw_at(a.k, a.ks, item, h), a.ks.r, j0, nj, oc, a.hd);
      __syncthreads();
      for (int j = 0; j < nj; ++j) {
        float dv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = Ss[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = Ks[j * PP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(dv[i], kv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= nr) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = oc + tx + 16 * c;
        if (col < a.hd) dqb[(r0 + r) * a.dqs.r + col] = acc[i][c];
      }
    }
  }
}

// grid (items, heads, key tiles of 64 keys): dk = ds^T . q, dv = p^T . dctx
__global__ void __launch_bounds__(P_THREADS)
bw_dkv_kernel(const BwArgs a) {
  extern __shared__ __align__(16) float bw_smem[];
  float* Qs = bw_smem;
  float* Ds = bw_smem + 2 * PT * PP;
  float* Ps = bw_smem + 4 * PT * PP;
  float* Ss = bw_smem + 5 * PT * PP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int item = blockIdx.x, h = blockIdx.y;
  const int j0 = blockIdx.z * PT, nj = min(PT, a.nkv - j0);
  const int nqt = (a.nq + PT - 1) / PT;
  const float* qb = bw_at(a.q, a.qs, item, h);
  const float* db = bw_at(a.dc, a.dcs, item, h);
  const float* st0 = a.stats + ((size_t)item * a.heads + h) * a.nq * 3;
  float s[4][4], dp[4][4];
  for (int oc = 0; oc < a.hd; oc += PT) {
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[i][c] = 0.f, dv[i][c] = 0.f;
    for (int qt = 0; qt < nqt; ++qt) {
      const int r0 = qt * PT, nr = min(PT, a.nq - r0);
      bw_scores(a, item, h, r0, nr, j0, nj, bw_smem, true, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const bool live = r < nr;
        const float* st = st0 + (size_t)(r0 + (live ? r : 0)) * 3;
        const float m = st[0], linv = st[1], D = st[2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = live ? expf(s[i][j] - m) * linv : 0.f;  // 0 past the keys
          Ps[r * PP + tx + 16 * j] = p;
          Ss[r * PP + tx + 16 * j] = p * (dp[i][j] - D) * a.scale;
        }
      }
      __syncthreads();  // every thread is done with bw_scores' tiles
      bw_load(Qs, qb, a.qs.r, r0, nr, oc, a.hd);
      bw_load(Ds, db, a.dcs.r, r0, nr, oc, a.hd);
      __syncthreads();
      for (int i = 0; i < nr; ++i) {
        float pv[4], sv[4], qv[4], gv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = Ps[i * PP + ty + 16 * j], sv[j] = Ss[i * PP + ty + 16 * j];
#pragma unroll
        for (int c = 0; c < 4; ++c) qv[c] = Qs[i * PP + tx + 16 * c], gv[c] = Ds[i * PP + tx + 16 * c];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dk[j][c] = fmaf(sv[j], qv[c], dk[j][c]);
            dv[j][c] = fmaf(pv[j], gv[c], dv[j][c]);
          }
      }
    }
    float* dkb = a.dk + item * a.dks.b + h * a.dks.h;
    float* dvb = a.dv + item * a.dvs.b + h * a.dvs.h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = ty + 16 * j;
      if (key >= nj) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = oc + tx + 16 * c;
        if (col < a.hd) {
          dkb[(j0 + key) * a.dks.r + col] = dk[j][c];
          dvb[(j0 + key) * a.dvs.r + col] = dv[j][c];
        }
      }
    }
  }
}

cudaError_t attention_f32_bwd(const BwArgs& a, int items, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bw_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BW_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bw_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BW_SMEM);
  if (err != cudaSuccess) return err;
  bw_dq_kernel<<<dim3(items, a.heads, (a.nq + PT - 1) / PT), P_THREADS, BW_SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bw_dkv_kernel<<<dim3(items, a.heads, (a.nkv + PT - 1) / PT), P_THREADS, BW_SMEM, stream>>>(a);
  return cudaGetLastError();
}

// the fp32 kernels' shape rule: items in the grid's x axis, query and key
// tiles in its z axis
bool f32_shape_ok(long long items, int heads, int nq, int nkv, int d) {
  return shape_ok(items, heads, nq, nkv, d) && (nkv + PT - 1) / PT <= 65535;
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
  if (!shape_ok(items, heads, nq, nq, d) || !gemm_wide_shape_ok(rows, 3 * d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm_wide<WG_BIAS>(x, wqkv, bqkv, qkv, m, 3 * d, d, s));
  UNIREC_TRY(item_attention<IA_B12>(qkv, 3 * d, qkv, 3 * d, d, 2 * d, key_bias, ctx, d, items,
                                    heads, nq, nq, hd, scale, s));
  return (int)gemm_wide<WG_BIAS>(ctx, wo, bo, out, m, d, d, s);
}

// B12s backward.  qkv [items*nq, 3d] bf16 and key_bias as saved by the
// forward; wo_t [d, d] = Wo transposed (rows: Wo's input columns); dout
// [items*nq, d] bf16; scratch dctx [items*nq, d] fp32; output dqkv
// [items*nq, 3d] bf16.
extern "C" int unirec_b12_self_bwd(const void* qkv, const void* wo_t, const float* key_bias,
                                   const void* dout, float* dctx, void* dqkv, int items, int nq,
                                   int d, int heads, float scale, void* stream) {
  const long long rows = (long long)items * nq;
  if (!shape_ok(items, heads, nq, nq, d) || !gemm_wide_shape_ok(rows, d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm_wide<WG_F32>(dout, wo_t, nullptr, dctx, m, d, d, s));
  return (int)item_attention_bwd(qkv, 3 * d, qkv, 3 * d, d, 2 * d, key_bias, dctx, d, dqkv,
                                 3 * d, dqkv, 3 * d, d, 2 * d, items, heads, nq, nq, hd, scale, s);
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
  if (!shape_ok(items, heads, nq, nkv, d) || !gemm_wide_shape_ok(rows, d, d) ||
      !gemm_wide_shape_ok(mem_rows, 2 * d, dm))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm_wide<WG_BIAS>(x, wq, bq, q, m, d, d, s));
  UNIREC_TRY(gemm_wide<WG_BIAS>(mem, wkv, bkv, kv, (int)mem_rows, 2 * d, dm, s));
  UNIREC_TRY(item_attention<IA_B12>(q, d, kv, 2 * d, 0, d, key_bias, ctx, d, items, heads, nq,
                                    nkv, hd, scale, s));
  return (int)gemm_wide<WG_BIAS>(ctx, wo, bo, out, m, d, d, s);
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
  if (!shape_ok(items, heads, nq, nkv, d) || !gemm_wide_shape_ok(rows, d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm_wide<WG_F32>(dout, wo_t, nullptr, dctx, m, d, d, s));
  return (int)item_attention_bwd(q, d, kv, 2 * d, 0, d, key_bias, dctx, d, dq, d, dkv, 2 * d, 0,
                                 d, items, heads, nq, nkv, hd, scale, s);
}

// The fp32 forms: arguments as the bf16 entries', every tensor float32; the
// backwards take one more scratch, stats [items * heads * nq * 3] fp32.

// B12s forward, fp32.
extern "C" int unirec_b12_self_fwd_f32(const float* x, const float* wqkv, const float* bqkv,
                                       const float* wo, const float* bo, const float* key_bias,
                                       float* out, float* qkv, float* ctx, int items, int nq,
                                       int d, int heads, float scale, void* stream) {
  const long long rows = (long long)items * nq;
  if (!f32_shape_ok(items, heads, nq, nq, d) || !gemm_f32_shape_ok(rows, 3 * d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = d / heads;
  const Strides qkv_s{(long long)nq * 3 * d, hd, 3LL * d}, ctx_s{(long long)nq * d, hd, d};
  UNIREC_TRY(gemm_f32<GF_BIAS>(x, wqkv, bqkv, nullptr, qkv, rows, 3 * d, d, s));
  UNIREC_TRY(attention_f32_fwd(qkv, qkv_s, qkv + d, qkv_s, qkv + 2 * d, qkv_s, key_bias, ctx,
                               ctx_s, items, heads, nq, nq, hd, scale, s));
  return (int)gemm_f32<GF_BIAS>(ctx, wo, bo, nullptr, out, rows, d, d, s);
}

// B12s backward, fp32: dqkv from the saved qkv, wo_t = Wo transposed, dout.
extern "C" int unirec_b12_self_bwd_f32(const float* qkv, const float* wo_t,
                                       const float* key_bias, const float* dout, float* dctx,
                                       float* stats, float* dqkv, int items, int nq, int d,
                                       int heads, float scale, void* stream) {
  const long long rows = (long long)items * nq;
  if (!f32_shape_ok(items, heads, nq, nq, d) || !gemm_f32_shape_ok(rows, d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = d / heads;
  UNIREC_TRY(gemm_f32<GF_PLAIN>(dout, wo_t, nullptr, nullptr, dctx, rows, d, d, s));
  const Strides qkv_s{(long long)nq * 3 * d, hd, 3LL * d}, ctx_s{(long long)nq * d, hd, d};
  BwArgs a{qkv,  qkv_s, qkv + d,  qkv_s, qkv + 2 * d,  qkv_s, dctx,  ctx_s, key_bias,
           dqkv, qkv_s, dqkv + d, qkv_s, dqkv + 2 * d, qkv_s, stats, heads, nq,
           nq,   hd,    scale};
  return (int)attention_f32_bwd(a, items, s);
}

// B12c forward, fp32.
extern "C" int unirec_b12_cross_fwd_f32(const float* x, const float* mem, const float* key_bias,
                                        const float* wq, const float* bq, const float* wkv,
                                        const float* bkv, const float* wo, const float* bo,
                                        float* out, float* q, float* kv, float* ctx, int items,
                                        int nq, int nkv, int d, int dm, int heads, float scale,
                                        void* stream) {
  const long long rows = (long long)items * nq;
  const long long mem_rows = (long long)items * nkv;
  if (!f32_shape_ok(items, heads, nq, nkv, d) || !gemm_f32_shape_ok(rows, d, d) ||
      !gemm_f32_shape_ok(mem_rows, 2 * d, dm))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = d / heads;
  const Strides q_s{(long long)nq * d, hd, d}, kv_s{(long long)nkv * 2 * d, hd, 2LL * d};
  UNIREC_TRY(gemm_f32<GF_BIAS>(x, wq, bq, nullptr, q, rows, d, d, s));
  UNIREC_TRY(gemm_f32<GF_BIAS>(mem, wkv, bkv, nullptr, kv, mem_rows, 2 * d, dm, s));
  UNIREC_TRY(attention_f32_fwd(q, q_s, kv, kv_s, kv + d, kv_s, key_bias, ctx, q_s, items, heads,
                               nq, nkv, hd, scale, s));
  return (int)gemm_f32<GF_BIAS>(ctx, wo, bo, nullptr, out, rows, d, d, s);
}

// B12c backward, fp32: dq and dkv from the saved q and kv, wo_t, dout.
extern "C" int unirec_b12_cross_bwd_f32(const float* q, const float* kv, const float* wo_t,
                                        const float* key_bias, const float* dout, float* dctx,
                                        float* stats, float* dq, float* dkv, int items, int nq,
                                        int nkv, int d, int heads, float scale, void* stream) {
  const long long rows = (long long)items * nq;
  if (!f32_shape_ok(items, heads, nq, nkv, d) || !gemm_f32_shape_ok(rows, d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = d / heads;
  UNIREC_TRY(gemm_f32<GF_PLAIN>(dout, wo_t, nullptr, nullptr, dctx, rows, d, d, s));
  const Strides q_s{(long long)nq * d, hd, d}, kv_s{(long long)nkv * 2 * d, hd, 2LL * d};
  BwArgs a{q,  q_s, kv,      kv_s, kv + d,  kv_s,  dctx, q_s, key_bias,
           dq, q_s, dkv,     kv_s, dkv + d, kv_s,  stats, heads, nq,
           nkv, hd, scale};
  return (int)attention_f32_bwd(a, items, s);
}
