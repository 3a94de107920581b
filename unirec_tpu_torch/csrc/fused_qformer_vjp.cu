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
// Every C entry launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
