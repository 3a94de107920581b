// The warpgroup GEMM of the port's projections, for bf16 and int8
// operands: the projections of the trainable blocks B12s / B12c
// (fused_qformer_vjp.cu), every product of the sweep's bf16 blocks B1-B3
// and of their W8A8 forms B4-B6, and every product of the int8 Qwen3
// serving kernels B8, B9a and B9b (qformer_blocks.cu): one int8 mainloop
// for B4-B6 and B8-B9b.
//
//   C[M, N] = epilogue(A[M, K] . W[N, K]^T), both operands K-contiguous (W
//   is the torch Linear layout), bf16 with fp32 sums or int8 codes with
//   int32 sums, on gemm_tma_kernel, or gemm_edge_kernel where TMA cannot
//   take the rows.
//
// What bounds it: tensor-core arithmetic (x . Wqkv at 512 items is 103
// GFLOP against 130 MB; B6's two products at 4096 items 1.1 TOP each
// against under 1 GB).  The mma.sync GEMM B1-B3 ran on before ran these
// products at 19-27% of the bf16 peak, and no mma.sync tiling did much
// better on this card (scripts/bench_gemm_wide.py, PERF.md): mma.sync issues
// from each warp, 16 x 8 x 16 at a time.  Here the warpgroup product wgmma
// does it:
//   * 128 x 256 block tiles (128 x 128 where an int8 product folds several
//     chunks, below), two consumer warpgroups of 64 x BN (BN / 2 fp32 or
//     int32 accumulators a thread), each k-step one wgmma.m64nBNk16 (bf16)
//     or m64nBNk32 (int8) with A and B read from shared memory through
//     descriptors;
//   * a k-tile row is 128 bytes (64 bf16 values or 128 int8 codes), stored
//     with the 128-byte swizzle that wgmma reads (16-byte chunk c of row r
//     at chunk c ^ (r % 8), 1024-byte aligned tiles), loaded by TMA from a
//     producer warp into a 4-stage ring of mbarrier-tracked stages (193 KB
//     of shared memory at BN 256, one block per SM); a k-step is 32 bytes of
//     a row in either type, so one mainloop serves both; at most one k-tile
//     of products is in flight (wgmma.wait_group 1) before a stage is
//     released.  The same wgmma over a ring that every thread fills with
//     16-byte cp.async reached 125-329 TFLOP/s at B12's shapes; TMA and
//     the producer warp, 349-387 (scripts/bench_gemm_wide.py, PERF.md);
//   * the epilogue (wg_stage, wg_flush below) stages each warpgroup's tile
//     in the ring once its products are done and writes it out as 16-byte
//     rows: stored straight from the accumulator layout, every warp store
//     scattered over eight rows and the epilogue, not the products, held
//     the GEMM (B6's up projection 3.40 ms against 2.47 staged, PERF.md).
//     A persistent form with writer warps overlapping the next tile was
//     tried and measured no better: its fp32 outputs must take 128 x 128
//     tiles to fit a separate staging buffer;
//   * the edge path: rows that are not whole 16-byte chunks (a width not a
//     multiple of 8 bf16 values or 16 int8 codes, e.g. hidden 1020 or
//     1032) or operands not 16-byte aligned cannot take TMA;
//     gemm_edge_kernel fills its ring with 4-byte cp.async copies where the
//     rows are whole 4-byte words and plain loads otherwise, zero past the
//     ragged edges, and both kernels' epilogues store single values where N
//     is odd.
// Epilogues, fp32 sums (bf16 operands):
//   WG_BIAS           + bias -> bf16 (the projections)
//   WG_F32            the bare fp32 sum (the backward's dctx = dout . Wo^T)
//   WG_BIAS_GELU      + bias -> tanh gelu in fp32 -> bf16 (B3's up projection)
//   WG_BIAS_RESID     + bias + resid -> fp32 (B1-B3's Wo and down projection
//                     where WG_BIAS_RESID_LN does not apply; LayerNorm follows
//                     in a kernel of its own)
//   WG_BIAS_RESID_LN  y = + bias + resid in fp32, then each row's LayerNorm
//                     (y - mean) * rsqrt(var + eps) * gamma + beta -> bf16
//                     (B1-B3's Wo and down projection, N <= 2048; below)
// int32 sums (int8 codes), dequantized as (float(acc) * rs) * cs with the
// row scale rs (row_scale[row * rs_stride]) and the column scale cs, rounded
// with __fmul_rn / __fadd_rn (no contraction): the JAX kernels' fp32
// rounding points (unirec_tpu/ops/fused_qformer_int8.py _mm_q); the int32
// sums are exact in any order, so each epilogue gives the bits of its plain
// form (the exact product, then the same fp32 roundings):
//   EPQ_BIAS          + bias -> bf16
//   EPQ_BIAS_F32      + bias -> fp32 (B6's up projection u: its gelu runs in
//                     the quantization pass that reads u, qformer_blocks.cu)
//   EPQ_BIAS_RESID    + bias + resid -> fp32
//   EPQ_CHUNKED_RESID f = sum over the chunks of `chunk` columns of K of
//                     float(acc_chunk) * rs_chunk (row_scale[row * rs_stride
//                     + chunk index]), in chunk order; f * cs + bias + resid
//                     -> fp32 (B6's down projection over h requantized per
//                     chunk).  A chunk is a multiple of 64 codes, so its
//                     boundary may fall inside a 128-code k-tile: the sums
//                     are folded after the products up to it are done
//                     (wait_group 0) and restarted.  One chunk (production:
//                     the whole 4096) needs no fp32 registers of its own and
//                     takes the 128 x 256 tile; several fold into BN / 2 fp32
//                     registers beside the int32 ones, which fit at 128 x 128.
//   EPQ_CHUNKED       EPQ_CHUNKED_RESID without the residual (B6 at fp32
//                     activations: its LayerNorm adds the fp32 x, at the
//                     same rounding point; B4 and B5 take EPQ_BIAS_F32)
//   EPQ_PLAIN         no bias -> bf16 (the Qwen3 projections B8, B9a and
//                     B9b's down projection)
//   EPQ_PLAIN_F32     no bias -> fp32 (B8's fp32 form)
//   EPQ_SWIGLU        W [2N, K] holds gate rows, then up rows (B9b's gate|up
//                     product); C [M, N] fp32 = h = (g * sigmoid(g)) * u of
//                     the dequantized g and u, with each row's max |h| raised
//                     in row_max (wg_stage_swiglu below).  A 128 x 256 tile
//                     holds 128 columns of h: the producer loads its W stage
//                     as two TMA boxes, the tile's gate rows and its up rows,
//                     so that one thread holds g and u of the same column.
//
// The LayerNorm in the residual GEMM's epilogue (WG_BIAS_RESID_LN): a row
// spans all N columns, more than one 128 x 256 tile, and 128 x 1024 fp32
// sums do not fit one SM's registers.  So the GEMM launches as clusters of
// ceil(N / 256) CTAs along N (at N 1024: 4 CTAs on 4 SMs of one GPC), which
// together hold whole rows.  While the products run, the producer thread
// also loads the tile's residual by TMA and the producer warpgroup's other
// warps its bias, gamma and beta columns, into shared memory beside a
// 3-stage ring (read in the epilogue from global memory, with the sums
// holding most registers, the residual's latency was exposed).  Each CTA
// adds bias and residual to its sums in registers, reduces its columns of
// each row to a partial sum (in column
// order a thread, then over the 4 threads of a quad), writes the partials
// to its shared memory and meets the cluster at a barrier; every CTA then
// reads all partials of its rows from the cluster's shared memory (mapa +
// ld.shared::cluster) and sums them in CTA-rank order: the mean.  The same
// for the centred sum of squares gives the variance (the two-pass form of
// the JAX kernels' _layer_norm_rows: mean, then mean((y - mu)^2), then
// rsqrt(var + eps)), and the CTA writes (y - mu) * r * gamma + beta as bf16
// straight to the output.  The fp32 pre-LN sum never reaches memory (537 MB
// and a separate LayerNorm pass at 4096 items), and a fixed order gives
// identical bits on repeat.  Above 8 CTAs (N > 2048, the portable cluster
// size) and where TMA cannot take the rows (K or N not a multiple of 8),
// WG_BIAS_RESID and a LayerNorm kernel do the same in two passes
// (qformer_blocks.cu).
//
// Everything is in an unnamed namespace: each source that includes this
// header gets its own copy, and nothing is exported.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ptx_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WG_ROW = 128;  // bytes of a swizzled tile row

enum {
  WG_BIAS,
  WG_F32,
  WG_BIAS_GELU,
  WG_BIAS_RESID,
  WG_BIAS_RESID_LN,
  EPQ_BIAS,
  EPQ_BIAS_F32,
  EPQ_BIAS_RESID,
  EPQ_CHUNKED_RESID,
  EPQ_PLAIN,
  EPQ_SWIGLU,
  EPQ_CHUNKED,
  EPQ_PLAIN_F32
};

// what an epilogue reads besides the sums (unused fields may be null)
struct WgEpi {
  const float* bias;       // [N]
  const bf16* resid;       // [M, N]: the *_RESID epilogues (WG_BIAS_RESID_LN: by TMA)
  const float* row_scale;  // int8: [M, rs_stride]
  int rs_stride;
  const float* col_scale;  // int8: [N]
  int chunk;               // EPQ_CHUNKED_RESID: columns of K a row scale covers
  const float* gamma;      // WG_BIAS_RESID_LN: [N]
  const float* beta;       // WG_BIAS_RESID_LN: [N]
  float eps;               // WG_BIAS_RESID_LN
  int* row_max;            // EPQ_SWIGLU: [M], each row's max |h| as the float's bits
};

template <typename T>
using WgAcc = std::conditional_t<std::is_same_v<T, int8_t>, int, float>;

// jax.nn.gelu(approximate=True) in fp32
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x)))));
}

// element k of row r of a swizzled tile of T
template <typename T>
__device__ __forceinline__ int wg_at(int r, int k) {
  const int b = k * (int)sizeof(T);
  return (r * WG_ROW + ((((b >> 4) ^ r) & 7) << 4) + (b & 15)) / (int)sizeof(T);
}

__device__ __forceinline__ void wg_mma(float (&d)[128], uint64_t a, uint64_t b) {
  wgmma_m64n256k16(d, a, b);
}
__device__ __forceinline__ void wg_mma(float (&d)[64], uint64_t a, uint64_t b) {
  wgmma_m64n128k16(d, a, b);
}
__device__ __forceinline__ void wg_mma(int (&d)[128], uint64_t a, uint64_t b) {
  wgmma_m64n256k32_s8(d, a, b);
}
__device__ __forceinline__ void wg_mma(int (&d)[64], uint64_t a, uint64_t b) {
  wgmma_m64n128k32_s8(d, a, b);
}

// acc[4n + e] of this thread lies at row row0 + 8 * (e >> 1) and column
// n0 + 8n + 2 (lane % 4) + (e & 1) (the mma.m16n8 C layout, n8 block by n8
// block), row0 = the warpgroup's first row + 16 (warp % 4) + lane / 4.  EPQ_CHUNKED_RESID over several chunks: the sums of chunk grp
// folded into facc, and restarted
template <int NA>
__device__ __forceinline__ void wg_fold(int (&acc)[NA], float (&facc)[NA], const WgEpi& ep,
                                        int grp, int row0, int M) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 8 * hf;
    const float rs = row < M ? ep.row_scale[(size_t)row * ep.rs_stride + grp] : 0.f;
#pragma unroll
    for (int n = 0; n < NA / 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * n + 2 * hf + e;
        facc[i] = __fadd_rn(facc[i], __fmul_rn(__int2float_rn(acc[i]), rs));
        acc[i] = 0;
      }
  }
}

// the products of one k-tile (four k-steps of 32 bytes) at shared addresses
// as / ws; k0 its first column of K.  FOLD: a chunk that ends inside the
// tile is folded once its products are done
template <bool FOLD, int NA, typename Acc>
__device__ __forceinline__ void wg_ktile(Acc (&acc)[NA], float (&facc)[FOLD ? NA : 1],
                                         uint32_t as, uint32_t ws, int k0, int K,
                                         const WgEpi& ep, int row0, int M) {
  constexpr int KS = std::is_same_v<Acc, int> ? 32 : 16;  // values of a k-step
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WG_ROW / 32; ++kk) {
    wg_mma(acc, wgmma_desc(as + 32 * kk), wgmma_desc(ws + 32 * kk));
    if constexpr (FOLD) {
      const int kend = k0 + (kk + 1) * KS;
      if (kend <= K && kend % ep.chunk == 0) {
        wgmma_commit();
        wgmma_wait<0>();
        wg_fold(acc, facc, ep, kend / ep.chunk - 1, row0, M);
        wgmma_fence();
      }
    }
  }
  wgmma_commit();
}

// The epilogue, in two phases.  wg_stage: each consumer thread turns its
// sums into output values (bias, dequantization, gelu, the residual, whose
// loads all go out at once) and writes them, rounded to the output type,
// into its warpgroup's 64 x BN staging tile in shared memory (the ring,
// free once every product is done); pitches of BN + 8 fp32 or BN / 2 + 4
// words keep the accumulator layout's 8-byte (fp32) and 4-byte (bf16)
// writes free of bank conflicts.  wg_flush: the warpgroup writes the tile
// out as whole 16-byte chunks of consecutive columns, so a warp stores 512
// contiguous bytes at a time; the accumulator layout itself would scatter
// every store over eight rows.  (A residual read in wg_flush, one
// dependent 8-byte load a chunk, left the tile's epilogue waiting on load
// latency: B4's Wo product took 0.92 ms.)

template <int EPI>
__host__ __device__ constexpr bool wg_f32_out() {
  return EPI == WG_F32 || EPI == WG_BIAS_RESID || EPI == EPQ_BIAS_F32 ||
         EPI == EPQ_BIAS_RESID || EPI == EPQ_CHUNKED_RESID || EPI == EPQ_SWIGLU ||
         EPI == EPQ_CHUNKED || EPI == EPQ_PLAIN_F32;
}

// output columns of a block tile of BN product columns (EPQ_SWIGLU pairs a
// gate column with an up column)
template <int EPI, int BN>
__host__ __device__ constexpr int wg_cols() {
  return EPI == EPQ_SWIGLU ? BN / 2 : BN;
}

// words (4 bytes) between staged rows of a tile's output columns
template <int EPI, int BN>
__host__ __device__ constexpr int wg_pitch() {
  return wg_f32_out<EPI>() ? wg_cols<EPI, BN>() + 8 : BN / 2 + 4;
}

// bytes of the two consumer warpgroups' staging tiles
template <int EPI, int BN>
__host__ __device__ constexpr int wg_stage_bytes() {
  return 2 * 64 * wg_pitch<EPI, BN>() * 4;
}

// phase 1 (layout as wg_fold): values of this thread's sums into `stage`,
// the warpgroup's tile; row0 / n0: the global row of its first sum and the
// tile's first column
template <int EPI, bool FOLD, int NA, typename Acc>
__device__ __forceinline__ void wg_stage(const Acc (&acc)[NA], const float (&facc)[FOLD ? NA : 1],
                                         const WgEpi& ep, uint32_t* stage, int row0, int n0,
                                         int M, int N) {
  constexpr bool INT8 = EPI >= EPQ_BIAS;
  constexpr int P = wg_pitch<EPI, 2 * NA>();
  const int t2 = (threadIdx.x & 3) * 2;
  const int lrow = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  float rs[2] = {0.f, 0.f};
  if constexpr (INT8 && !FOLD) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row0 + 8 * hf < M) rs[hf] = ep.row_scale[(size_t)(row0 + 8 * hf) * ep.rs_stride];
  }
#pragma unroll
  for (int n = 0; n < NA / 4; ++n) {
    const int col = n0 + n * 8 + t2;
    if (col >= N) continue;
    const bool two = col + 1 < N;
    float bs[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f};
    if constexpr (EPI != WG_F32 && EPI != EPQ_PLAIN && EPI != EPQ_PLAIN_F32) {
      bs[0] = ep.bias[col];
      bs[1] = two ? ep.bias[col + 1] : 0.f;
    }
    if constexpr (INT8) {
      cs[0] = ep.col_scale[col];
      cs[1] = two ? ep.col_scale[col + 1] : 0.f;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * n + 2 * hf + e;
        if constexpr (EPI == WG_F32) {
          v[e] = acc[i];
        } else if constexpr (!INT8) {
          v[e] = acc[i] + bs[e];
        } else {
          float f;
          if constexpr (FOLD)
            f = facc[i];
          else if constexpr (EPI == EPQ_CHUNKED_RESID || EPI == EPQ_CHUNKED)  // folded once
            f = __fadd_rn(0.f, __fmul_rn(__int2float_rn(acc[i]), rs[hf]));
          else
            f = __fmul_rn(__int2float_rn(acc[i]), rs[hf]);
          v[e] = __fmul_rn(f, cs[e]);
          if constexpr (EPI != EPQ_PLAIN && EPI != EPQ_PLAIN_F32) v[e] = __fadd_rn(v[e], bs[e]);
        }
      }
      if constexpr (EPI == WG_BIAS_GELU) {
        v[0] = gelu_tanh(v[0]);
        v[1] = gelu_tanh(v[1]);
      }
      if constexpr (EPI == WG_BIAS_RESID || EPI == EPQ_BIAS_RESID ||
                    EPI == EPQ_CHUNKED_RESID) {
        const int row = row0 + 8 * hf;
        if (row < M) {
          const size_t off = (size_t)row * N + col;
          float r0, r1 = 0.f;
          if ((N & 1) == 0) {  // (row * N + col) is even: one 4-byte load
            const __nv_bfloat162 rb = *reinterpret_cast<const __nv_bfloat162*>(ep.resid + off);
            r0 = __bfloat162float(rb.x);
            r1 = __bfloat162float(rb.y);
          } else {
            r0 = __bfloat162float(ep.resid[off]);
            if (two) r1 = __bfloat162float(ep.resid[off + 1]);
          }
          v[0] = __fadd_rn(v[0], r0);
          v[1] = __fadd_rn(v[1], r1);
        }
      }
      const int r = lrow + 8 * hf;
      if constexpr (wg_f32_out<EPI>()) {
        *reinterpret_cast<float2*>(stage + r * P + n * 8 + t2) = make_float2(v[0], v[1]);
      } else {
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[0], v[1]);
        stage[r * P + n * 4 + t2 / 2] = *reinterpret_cast<const uint32_t*>(&b);
      }
    }
  }
}

// EPQ_SWIGLU's phase 1, in place of wg_stage (layout as wg_fold).  The
// producer loads a tile's W rows as two boxes, gate rows n0.. and up rows
// N + n0.. of W [2N, K], so that tile column j < BN / 2 is gate column
// n0 + j and column BN / 2 + j up column n0 + j: acc[4n + i] and
// acc[4(n + BN / 16) + i] are g and u of one column of h (each thread of an
// m64nBN product holds sums in every 8-column block).  h = (g * sigmoid(g))
// * u in fp32, with g = (acc_g * rs) * cs_g and u = (acc_u * rs) * cs_u,
// into `stage` (BN / 2 columns); and each row's max |h| over the tile's
// columns into ep.row_max by atomicMax on the float's bits: |h| >= 0, so
// integer order is float order, and a maximum does not depend on the order
// of the atomics (identical bits on repeat).
template <int NA>
__device__ __forceinline__ void wg_stage_swiglu(const int (&acc)[NA], const WgEpi& ep,
                                                uint32_t* stage, int row0, int n0, int M,
                                                int N) {
  constexpr int P = wg_pitch<EPQ_SWIGLU, 2 * NA>();
  constexpr int HB = NA / 8;  // 8-column blocks of h
  const int t2 = (threadIdx.x & 3) * 2;
  const int lrow = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  float rs[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    if (row0 + 8 * hf < M) rs[hf] = ep.row_scale[(size_t)(row0 + 8 * hf) * ep.rs_stride];
#pragma unroll
  for (int n = 0; n < HB; ++n) {
    const int col = n0 + n * 8 + t2;
    if (col >= N) continue;
    const bool two = col + 1 < N;
    const float cg[2] = {ep.col_scale[col], two ? ep.col_scale[col + 1] : 0.f};
    const float cu[2] = {ep.col_scale[N + col], two ? ep.col_scale[N + col + 1] : 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * n + 2 * hf + e;
        const float g = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), rs[hf]), cg[e]);
        const float u = __fmul_rn(__fmul_rn(__int2float_rn(acc[i + 4 * HB]), rs[hf]), cu[e]);
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
        h[e] = __fmul_rn(__fmul_rn(g, sig), u);
      }
      mx[hf] = fmaxf(mx[hf], two ? fmaxf(fabsf(h[0]), fabsf(h[1])) : fabsf(h[0]));
      *reinterpret_cast<float2*>(stage + (lrow + 8 * hf) * P + n * 8 + t2) = make_float2(h[0], h[1]);
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {  // the row's 4 threads, then the other tiles
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    if (t2 == 0 && row0 + 8 * hf < M) atomicMax(ep.row_max + row0 + 8 * hf, __float_as_int(mx[hf]));
  }
}

// phase 2: the warpgroup's staged 64-row tile (rows m0.., its output
// columns n0..) into C in 16-byte chunks; t: the thread's index in its
// warpgroup
template <int EPI, int BN>
__device__ __forceinline__ void wg_flush(const uint32_t* stage, void* C, int t, int m0, int n0,
                                         int M, int N) {
  using O = std::conditional_t<wg_f32_out<EPI>(), float, bf16>;
  constexpr int P = wg_pitch<EPI, BN>();
  constexpr int E = 16 / (int)sizeof(O);        // values of a 16-byte chunk
  constexpr int CPR = wg_cols<EPI, BN>() / E;  // chunks of a row
  const bool vec = N % E == 0 && (uintptr_t)C % 16 == 0;
  for (int c = t; c < 64 * CPR; c += 128) {
    const int r = c / CPR, cc = c - r * CPR;
    const int row = m0 + r, col = n0 + cc * E;
    if (row >= M || col >= N) continue;
    const uint4 w = *reinterpret_cast<const uint4*>(stage + r * P + cc * 4);
    O* dst = static_cast<O*>(C) + (size_t)row * N + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = w;
    } else {
      const O* v = reinterpret_cast<const O*>(&w);
      for (int i = 0; i < E && col + i < N; ++i) dst[i] = v[i];
    }
  }
}

// ------------------------------------------------ TMA, warp-specialised --
// The aligned path: one producer warpgroup whose first thread keeps TMA
// loads of the A and W tiles in flight (each stage's full barrier counts
// their bytes), and two consumer warpgroups of 64 x BN that wait for a
// stage, multiply it with wgmma and release it (empty barrier) once the
// products that read it are done.  No thread spends issue slots or
// registers on copies, and the ring runs WT_STAGES - 1 tiles ahead.

constexpr int WT_BM = 128;
constexpr int WT_STAGES = 4;
constexpr int WT_THREADS = 384;  // producer warpgroup + two consumers
// WG_BIAS_RESID_LN: a 3-stage ring, beside which the tile's residual (BN / 64
// swizzled boxes of WT_BM rows x 128 bytes) and its bias, gamma and beta
// columns arrive while the products run
template <int EPI>
__host__ __device__ constexpr int wt_stages() {
  return EPI == WG_BIAS_RESID_LN ? 3 : WT_STAGES;
}
// bytes of WG_BIAS_RESID_LN's own shared memory: the residual tile, its
// barrier, the partial sums [2][WT_BM] and bias / gamma / beta [3][BN]
template <int EPI, int BN>
__host__ __device__ constexpr int wl_smem() {
  return EPI == WG_BIAS_RESID_LN ? BN * 2 * WT_BM + 8 + 2 * WT_BM * 4 + 3 * BN * 4 : 0;
}
// the ring, its barriers, WG_BIAS_RESID_LN's own and room to align the ring
// to 1024 bytes
template <int EPI, int BN>
constexpr int wt_smem() {
  return wt_stages<EPI>() * ((WT_BM + BN) * WG_ROW + 16) + wl_smem<EPI, BN>() + 1024;
}

// WG_BIAS_RESID_LN (layout as wg_fold), in place of wg_stage: y = acc +
// bias + resid in acc, each row's mean and variance over the cluster's N
// columns, and the normalised row as bf16 into `stage` (for wg_flush).
// res: the tile's residual (swizzled boxes of 64 columns, zeros past M and
// N), vec: its bias, gamma and beta columns ([3][BN]), both in shared
// memory; part: this CTA's [2][WT_BM] partial sums (sums, then centred sums
// of squares); crow the CTA row of the thread's first sum.  Every thread of
// the cluster meets it at two barriers here and arrives at a third, which it
// waits on after its flush (wl_done): no CTA leaves while a peer may still
// read its partials.
template <int NA>
__device__ __forceinline__ void wg_stage_ln(float (&acc)[NA], const WgEpi& ep,
                                            const unsigned char* res, const float* vec,
                                            uint32_t* stage, float* part, int crow, int n0,
                                            int N) {
  constexpr int BN = 2 * NA;
  constexpr int P = wg_pitch<WG_BIAS_RESID_LN, BN>();
  const int t2 = (threadIdx.x & 3) * 2;
  const int lrow = crow & 63;
  const int ncta = gridDim.x;  // the cluster spans the grid's columns
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NA / 4; ++n) {
    const int c = n * 8 + t2;  // the tile's column
    if (n0 + c >= N) continue;
    const bool two = n0 + c + 1 < N;
    const bf16* box = reinterpret_cast<const bf16*>(res + (n / 8) * WT_BM * WG_ROW);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const __nv_bfloat162 rb =
          *reinterpret_cast<const __nv_bfloat162*>(box + wg_at<bf16>(crow + 8 * hf, c % 64));
      const float r[2] = {__bfloat162float(rb.x), __bfloat162float(rb.y)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * n + 2 * hf + e;
        if (e == 0 || two) {
          acc[i] = __fadd_rn(acc[i] + vec[c + e], r[e]);
          s[hf] += acc[i];
        }
      }
    }
  }
  auto cluster_rows = [&](float (&v)[2], int half) {  // v: this thread's partials -> totals
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      v[hf] += __shfl_xor_sync(0xffffffffu, v[hf], 1);
      v[hf] += __shfl_xor_sync(0xffffffffu, v[hf], 2);
      if (t2 == 0) part[half * WT_BM + crow + 8 * hf] = v[hf];
    }
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t a = smem_addr(part + half * WT_BM + crow + 8 * hf);
      float total = 0.f;
      for (int r = 0; r < ncta; ++r) total += ld_cluster_f32(cluster_map(a, r));
      v[hf] = total;
    }
  };
  cluster_rows(s, 0);
  const float mu[2] = {s[0] / (float)N, s[1] / (float)N};
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NA / 4; ++n) {
    const int c = n * 8 + t2;
    if (n0 + c >= N) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (e == 0 || n0 + c + 1 < N) {
          const float x = acc[4 * n + 2 * hf + e] - mu[hf];
          q[hf] += x * x;
        }
  }
  cluster_rows(q, 1);
  cluster_arrive();  // done with the peers' partials (wl_done waits)
  const float rs[2] = {1.0f / sqrtf(q[0] / (float)N + ep.eps),
                       1.0f / sqrtf(q[1] / (float)N + ep.eps)};
#pragma unroll
  for (int n = 0; n < NA / 4; ++n) {
    const int c = n * 8 + t2;
    if (n0 + c >= N) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = (acc[4 * n + 2 * hf + e] - mu[hf]) * rs[hf] * vec[BN + c + e] + vec[2 * BN + c + e];
      const __nv_bfloat162 o = __floats2bfloat162_rn(v[0], v[1]);
      stage[(lrow + 8 * hf) * P + n * 4 + t2 / 2] = *reinterpret_cast<const uint32_t*>(&o);
    }
  }
}

// the cluster barriers of WG_BIAS_RESID_LN that a thread without sums (the
// producer warpgroup) takes part in, and the last one's wait
__device__ __forceinline__ void wl_join() {
  cluster_arrive();
  cluster_wait();
  cluster_arrive();
  cluster_wait();
  cluster_arrive();
}
__device__ __forceinline__ void wl_done() { cluster_wait(); }

template <typename T, int EPI, int BN, bool FOLD>
__global__ void __launch_bounds__(WT_THREADS, 1)
gemm_tma_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_w,
                const __grid_constant__ CUtensorMap tma_r, const WgEpi ep, void* __restrict__ C,
                int M, int N, int K) {
  constexpr int BK = WG_ROW / (int)sizeof(T);  // values of K a k-tile
  constexpr bool LN = EPI == WG_BIAS_RESID_LN;
  constexpr int ST = wt_stages<EPI>();
  static_assert(wg_stage_bytes<EPI, BN>() <= ST * (WT_BM + BN) * WG_ROW, "staging");
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  unsigned char* As = smem + ((1024 - (s0 & 1023)) & 1023);
  unsigned char* Ws = As + ST * WT_BM * WG_ROW;
  unsigned char* Rs = Ws + ST * BN * WG_ROW;  // WG_BIAS_RESID_LN: the residual
  uint64_t* full = reinterpret_cast<uint64_t*>(Rs + (LN ? BN * 2 * WT_BM : 0));
  uint64_t* empty = full + ST;
  uint64_t* rbar = empty + ST;  // WG_BIAS_RESID_LN: residual and vectors landed
  float* part = reinterpret_cast<float*>(rbar + 1);
  float* vec = part + 2 * WT_BM;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int m0 = blockIdx.y * WT_BM;
  const int n0 = blockIdx.x * wg_cols<EPI, BN>();  // the tile's first output column
  const int k_tiles = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    if constexpr (LN) mbar_init(rbar, 1 + 96);  // the TMA thread, warps 1-3
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if (tid == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(&empty[s], (kt / ST - 1) & 1);
        mbar_arrive_expect(&full[s], (WT_BM + BN) * WG_ROW);
        tma_load_2d(As + s * WT_BM * WG_ROW, &tma_a, kt * BK, m0, &full[s]);
        tma_load_2d(Ws + s * BN * WG_ROW, &tma_w, kt * BK, n0, &full[s]);
        if constexpr (EPI == EPQ_SWIGLU)  // the up rows N + n0.. below the gate rows
          tma_load_2d(Ws + (s * BN + BN / 2) * WG_ROW, &tma_w, kt * BK, N + n0, &full[s]);
        if constexpr (LN) {
          if (kt == min(ST, k_tiles) - 1) {  // the ring is filled: the residual
            mbar_arrive_expect(rbar, BN * 2 * WT_BM);
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(Rs + j * WT_BM * WG_ROW, &tma_r, n0 + 64 * j, m0, rbar);
          }
        }
      }
    }
    if constexpr (LN) {
      if (tid >= 32) {  // warps 1-3: the tile's bias, gamma and beta
        for (int c = tid - 32; c < BN; c += 96) {
          const bool in = n0 + c < N;
          vec[c] = in ? ep.bias[n0 + c] : 0.f;
          vec[BN + c] = in ? ep.gamma[n0 + c] : 0.f;
          vec[2 * BN + c] = in ? ep.beta[n0 + c] : 0.f;
        }
        mbar_arrive(rbar);
      }
      wl_join();
      wl_done();
    }
    return;
  }

  const int cw = wg - 1;  // consumer: rows cw * 64 ..
  const int lane = tid & 31;
  const int row0 = m0 + cw * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  WgAcc<T> acc[BN / 2];
  float facc[FOLD ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < (FOLD ? BN / 2 : 1); ++i) facc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % ST;
    mbar_wait(&full[s], (kt / ST) & 1);
    wg_ktile<FOLD>(acc, facc, smem_addr(As + s * WT_BM * WG_ROW + cw * 64 * WG_ROW),
                   smem_addr(Ws + s * BN * WG_ROW), kt * BK, K, ep, row0, M);
    wgmma_wait<1>();  // tile kt - 1's products are done: release its stage
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(kt - 1) % ST]);
  }
  wgmma_wait<0>();
  named_barrier(1, 256);  // both consumers are done with the ring
  uint32_t* stage = reinterpret_cast<uint32_t*>(As) + cw * 64 * wg_pitch<EPI, BN>();
  if constexpr (LN) {
    mbar_wait(rbar, 0);
    wg_stage_ln(acc, ep, Rs, vec, stage, part, row0 - m0, n0, N);
  } else if constexpr (EPI == EPQ_SWIGLU) {
    wg_stage_swiglu(acc, ep, stage, row0, n0, M, N);
  } else {
    wg_stage<EPI, FOLD>(acc, facc, ep, stage, row0, n0, M, N);
  }
  named_barrier(2 + cw, 128);
  wg_flush<EPI, BN>(stage, C, tid & 127, m0 + cw * 64, n0, M, N);
  if constexpr (LN) wl_done();
}

typedef CUresult (*WtEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                               const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
inline WtEncodeFn wt_encode() {
  static const WtEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &q) == cudaSuccess &&
                    q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<WtEncodeFn>(p) : nullptr;
  }();
  return fn;
}

// the tensor map of a row-major [rows, cols] matrix of T in boxes of one
// 128-byte row x box_rows rows, 128-byte swizzled (zeros past its edges)
template <typename T>
cudaError_t wt_tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const WtEncodeFn encode = wt_encode();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(WG_ROW / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same_v<T, int8_t> ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int EPI, int BN, bool FOLD>
cudaError_t launch_gemm_tma(const void* A, const void* W, const WgEpi& ep, void* C, int M, int N,
                            int K, cudaStream_t stream) {
  CUtensorMap ta, tw, tr;  // tr: WG_BIAS_RESID_LN's residual [M, N]
  constexpr int OC = wg_cols<EPI, BN>();
  cudaError_t err = wt_tensor_map<T>(&ta, A, M, K, WT_BM);
  // EPQ_SWIGLU: W is [2N, K], loaded in boxes of the tile's BN / 2 gate and
  // BN / 2 up rows
  if (err == cudaSuccess) err = wt_tensor_map<T>(&tw, W, N * (BN / OC), K, OC);
  if (err != cudaSuccess) return err;
  if constexpr (EPI == WG_BIAS_RESID_LN)
    err = wt_tensor_map<bf16>(&tr, ep.resid, M, N, WT_BM);
  else
    tr = ta;
  if (err != cudaSuccess) return err;
  constexpr int smem = wt_smem<EPI, BN>();
  err = cudaFuncSetAttribute(gemm_tma_kernel<T, EPI, BN, FOLD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + OC - 1) / OC, (M + WT_BM - 1) / WT_BM);
  if constexpr (EPI == WG_BIAS_RESID_LN) {  // a cluster spans the columns
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(WT_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid.x;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, gemm_tma_kernel<T, EPI, BN, FOLD>, ta, tw, tr, ep, C, M, N,
                             K);
    if (err != cudaSuccess) return err;
  } else {
    gemm_tma_kernel<T, EPI, BN, FOLD><<<grid, WT_THREADS, smem, stream>>>(ta, tw, tr, ep, C, M, N,
                                                                        K);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------- the edge path --
// Rows that TMA cannot take: two warpgroups of 64 x 128 over a 3-stage ring
// that every thread fills, with 4-byte cp.async copies where the rows are
// whole 4-byte words (K a multiple of 2 bf16 or 4 int8 values, 4-byte
// aligned operands) and plain loads otherwise (zeros past the ragged
// edges), into the same swizzled tiles; tile kt + 1 is loaded while tile kt
// is multiplied.

constexpr int WE_BM = 128;
constexpr int WE_BN = 128;
constexpr int WE_STAGES = 3;
constexpr int WE_THREADS = 256;
constexpr int WE_SMEM = WE_STAGES * (WE_BM + WE_BN) * WG_ROW + 1024;

template <typename T, int EPI, bool FOLD>
__global__ void __launch_bounds__(WE_THREADS, 2)
gemm_edge_kernel(const T* __restrict__ A, const T* __restrict__ W, const WgEpi ep,
                 void* __restrict__ C, int M, int N, int K) {
  constexpr int BK = WG_ROW / (int)sizeof(T);
  constexpr int PW = 4 / (int)sizeof(T);  // values of a 4-byte word
  static_assert(wg_stage_bytes<EPI, WE_BN>() <= WE_STAGES * (WE_BM + WE_BN) * WG_ROW, "staging");
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  T* As = reinterpret_cast<T*>(smem + ((1024 - (s0 & 1023)) & 1023));
  T* Ws = As + WE_STAGES * WE_BM * BK;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroup: rows wg * 64 ..
  const int m0 = blockIdx.y * WE_BM;
  const int n0 = blockIdx.x * WE_BN;
  const int k_tiles = (K + BK - 1) / BK;
  const bool words = K % PW == 0 && ((uintptr_t)A | (uintptr_t)W) % 4 == 0;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    T* as = As + stage * WE_BM * BK;
    T* ws = Ws + stage * WE_BN * BK;
    if (words) {  // rows of whole 4-byte words
      for (int e = tid; e < (WE_BM + WE_BN) * BK / PW; e += WE_THREADS) {
        const int r = e / (BK / PW);
        const int kc = (e - r * (BK / PW)) * PW;
        const int gk = k0 + kc;
        if (r < WE_BM) {
          const bool p = gk < K && m0 + r < M;
          cp_async_4(smem_addr(as + wg_at<T>(r, kc)), p ? A + (size_t)(m0 + r) * K + gk : A, p);
        } else {
          const int rw = r - WE_BM;
          const bool p = gk < K && n0 + rw < N;
          cp_async_4(smem_addr(ws + wg_at<T>(rw, kc)), p ? W + (size_t)(n0 + rw) * K + gk : W,
                     p);
        }
      }
    } else {
      for (int e = tid; e < (WE_BM + WE_BN) * BK; e += WE_THREADS) {
        const int r = e / BK;
        const int kc = e - r * BK;
        const int gk = k0 + kc;
        if (r < WE_BM) {
          as[wg_at<T>(r, kc)] = gk < K && m0 + r < M ? A[(size_t)(m0 + r) * K + gk] : T{};
        } else {
          const int rw = r - WE_BM;
          ws[wg_at<T>(rw, kc)] = gk < K && n0 + rw < N ? W[(size_t)(n0 + rw) * K + gk] : T{};
        }
      }
    }
  };

  const int lane = tid & 31;
  const int row0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  WgAcc<T> acc[WE_BN / 2];
  float facc[FOLD ? WE_BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < WE_BN / 2; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < (FOLD ? WE_BN / 2 : 1); ++i) facc[i] = 0.f;

  if (k_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<0>();   // this thread's copies of tile kt have landed
    fence_proxy_async();  // visible to wgmma's reads
    __syncthreads();      // everyone's; and tile kt - 2's products are done
    if (kt + 1 < k_tiles) load_tile((kt + 1) % WE_STAGES, kt + 1);
    cp_async_commit();
    const int s = kt % WE_STAGES;
    wg_ktile<FOLD>(acc, facc, smem_addr(As + s * WE_BM * BK + wg * 64 * BK),
                   smem_addr(Ws + s * WE_BN * BK), kt * BK, K, ep, row0, M);
    wgmma_wait<1>();  // tile kt - 1's products done: its stage may be refilled
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // every product is done with the ring
  uint32_t* stage = reinterpret_cast<uint32_t*>(As) + wg * 64 * wg_pitch<EPI, WE_BN>();
  wg_stage<EPI, FOLD>(acc, facc, ep, stage, row0, n0, M, N);
  __syncthreads();
  wg_flush<EPI, WE_BN>(stage, C, tid & 127, m0 + wg * 64, n0, M, N);
}

template <typename T, int EPI, bool FOLD>
cudaError_t launch_gemm_edge(const void* A, const void* W, const WgEpi& ep, void* C, int M, int N,
                             int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_edge_kernel<T, EPI, FOLD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WE_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + WE_BN - 1) / WE_BN, (M + WE_BM - 1) / WE_BM);
  gemm_edge_kernel<T, EPI, FOLD><<<grid, WE_THREADS, WE_SMEM, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(W), ep, C, M, N, K);
  return cudaGetLastError();
}

// TMA takes rows of whole 16-byte chunks from 16-byte aligned operands
template <typename T>
bool wt_takes(const void* A, const void* W, int K) {
  return K % (16 / (int)sizeof(T)) == 0 && (uintptr_t)A % 16 == 0 && (uintptr_t)W % 16 == 0;
}

// C = A . W^T (+ epilogue WG_*), bf16 operands: the TMA kernel where it
// takes the rows, the edge kernel otherwise.  resid: WG_BIAS_RESID's [M, N].
template <int EPI>
cudaError_t gemm_wide(const void* A, const void* W, const float* bias, void* C, int M, int N,
                      int K, cudaStream_t stream, const void* resid = nullptr) {
  static_assert(EPI < WG_BIAS_RESID_LN, "bf16 epilogues of one CTA");
  WgEpi ep{};
  ep.bias = bias;
  ep.resid = static_cast<const bf16*>(resid);
  return wt_takes<bf16>(A, W, K) ? launch_gemm_tma<bf16, EPI, 256, false>(A, W, ep, C, M, N, K, stream)
                                 : launch_gemm_edge<bf16, EPI, false>(A, W, ep, C, M, N, K, stream);
}

// the most CTAs of a cluster that every Hopper part schedules, and the
// columns of each of WG_BIAS_RESID_LN's tiles
constexpr int WL_MAX_CLUSTER = 8;
constexpr int WL_BN = 256;

// whether gemm_resid_ln takes a residual product of N columns over K
// inputs: TMA takes rows of K (A and W) and of N (the residual [M, N]) bf16
// values, and one portable cluster of WL_BN-column tiles spans the N columns.
// The one copy of this rule: the wrappers ask it through
// unirec_resid_ln_two_pass (qformer_blocks.cu)
bool wl_shape(int N, int K) {
  return K % 8 == 0 && N % 8 == 0 && N <= WL_MAX_CLUSTER * WL_BN;
}

// wl_shape, and the operands 16-byte aligned as TMA needs them
bool wl_takes(const void* A, const void* W, const void* resid, int N, int K) {
  return wl_shape(N, K) && wt_takes<bf16>(A, W, K) && (uintptr_t)resid % 16 == 0;
}

// out [M, N] bf16 = LayerNorm(A . W^T + bias + resid) with gamma, beta and
// eps (WG_BIAS_RESID_LN), bf16 operands; only where wl_takes holds, which
// the caller checks
cudaError_t gemm_resid_ln(const void* A, const void* W, const float* bias, const void* resid,
                          const float* gamma, const float* beta, float eps, void* out, int M,
                          int N, int K, cudaStream_t stream) {
  WgEpi ep{};
  ep.bias = bias;
  ep.resid = static_cast<const bf16*>(resid);
  ep.gamma = gamma;
  ep.beta = beta;
  ep.eps = eps;
  return launch_gemm_tma<bf16, WG_BIAS_RESID_LN, WL_BN, false>(A, W, ep, out, M, N, K, stream);
}

// C = epilogue(A . W^T), int8 codes (EPQ_*; ep as WgEpi says).  EPQ_SWIGLU:
// W [2N, K] holds the gate rows, then the up rows; C [M, N] is h; only
// where TMA takes the rows (else cudaErrorInvalidValue)
template <int EPI>
cudaError_t gemm_q(const void* A, const void* W, const WgEpi& ep, void* C, int M, int N, int K,
                   cudaStream_t stream) {
  static_assert(EPI >= EPQ_BIAS, "int8 epilogues");
  const bool tma = wt_takes<int8_t>(A, W, K);
  if constexpr (EPI == EPQ_SWIGLU) {
    return tma ? launch_gemm_tma<int8_t, EPI, 256, false>(A, W, ep, C, M, N, K, stream)
               : cudaErrorInvalidValue;
  } else {
    if constexpr (EPI == EPQ_CHUNKED_RESID || EPI == EPQ_CHUNKED) {
      if (ep.chunk < K)
        return tma ? launch_gemm_tma<int8_t, EPI, 128, true>(A, W, ep, C, M, N, K, stream)
                   : launch_gemm_edge<int8_t, EPI, true>(A, W, ep, C, M, N, K, stream);
    }
    return tma ? launch_gemm_tma<int8_t, EPI, 256, false>(A, W, ep, C, M, N, K, stream)
               : launch_gemm_edge<int8_t, EPI, false>(A, W, ep, C, M, N, K, stream);
  }
}

bool gemm_wide_shape_ok(long long m, int n, int k) {
  return m > 0 && m <= 2147483647 && n > 0 && k > 0 && (m + WT_BM - 1) / WT_BM <= 65535;
}

}  // namespace
