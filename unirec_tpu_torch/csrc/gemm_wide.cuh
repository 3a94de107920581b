// The warpgroup GEMM of the Item Q-Former kernels, for bf16 and int8
// operands: the projections of the trainable blocks B12s / B12c
// (fused_qformer_vjp.cu), every int8 product of the sweep's W8A8 blocks
// B4-B6 and the bf16 products of B1-B3 at widths gemm_bf16.cuh does not
// take (qformer_blocks.cu).
//
//   C[M, N] = epilogue(A[M, K] . W[N, K]^T), both operands K-contiguous (W
//   is the torch Linear layout), bf16 with fp32 sums or int8 codes with
//   int32 sums, on gemm_tma_kernel, or gemm_edge_kernel where TMA cannot
//   take the rows.
//
// What bounds it: tensor-core arithmetic (x . Wqkv at 512 items is 103
// GFLOP against 130 MB; B6's two products at 4096 items 1.1 TOP each
// against under 1 GB).  gemm_bf16.cuh's mma.sync tiles ran these products
// at 19-27% of the bf16 peak, and no mma.sync tiling did much better on this
// card (scripts/bench_gemm_wide.py, PERF.md): mma.sync issues from each
// warp, 16 x 8 x 16 at a time.  Here the warpgroup product wgmma does it:
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
//   WG_BIAS_RESID     + bias + resid -> fp32 (B1-B3's Wo and down projection)
// int32 sums (int8 codes), dequantized as (float(acc) * rs) * cs with the
// row scale rs (row_scale[row * rs_stride]) and the column scale cs, rounded
// with __fmul_rn / __fadd_rn (no contraction): the JAX kernels' fp32
// rounding points (unirec_tpu/ops/fused_qformer_int8.py _mm_q), the same as
// gemm_s8_kernel's in qformer_blocks.cu, so the two give the same bits:
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
  EPQ_BIAS,
  EPQ_BIAS_F32,
  EPQ_BIAS_RESID,
  EPQ_CHUNKED_RESID
};

// what an epilogue reads besides the sums (unused fields may be null)
struct WgEpi {
  const float* bias;       // [N]
  const bf16* resid;       // [M, N]: the *_RESID epilogues
  const float* row_scale;  // int8: [M, rs_stride]
  int rs_stride;
  const float* col_scale;  // int8: [N]
  int chunk;               // EPQ_CHUNKED_RESID: columns of K a row scale covers
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
         EPI == EPQ_BIAS_RESID || EPI == EPQ_CHUNKED_RESID;
}

// words (4 bytes) between staged rows of BN values
template <int EPI, int BN>
__host__ __device__ constexpr int wg_pitch() {
  return wg_f32_out<EPI>() ? BN + 8 : BN / 2 + 4;
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
    if constexpr (EPI != WG_F32) {
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
          else if constexpr (EPI == EPQ_CHUNKED_RESID)  // one chunk, folded once
            f = __fadd_rn(0.f, __fmul_rn(__int2float_rn(acc[i]), rs[hf]));
          else
            f = __fmul_rn(__int2float_rn(acc[i]), rs[hf]);
          v[e] = __fadd_rn(__fmul_rn(f, cs[e]), bs[e]);
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

// phase 2: the warpgroup's staged 64 x BN tile (rows m0.., columns n0..)
// into C in 16-byte chunks; t: the thread's index in its warpgroup
template <int EPI, int BN>
__device__ __forceinline__ void wg_flush(const uint32_t* stage, void* C, int t, int m0, int n0,
                                         int M, int N) {
  using O = std::conditional_t<wg_f32_out<EPI>(), float, bf16>;
  constexpr int P = wg_pitch<EPI, BN>();
  constexpr int E = 16 / (int)sizeof(O);  // values of a 16-byte chunk
  constexpr int CPR = BN / E;             // chunks of a row
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
// the ring, its barriers, and room to align it to 1024 bytes
template <int BN>
constexpr int wt_smem() {
  return WT_STAGES * (WT_BM + BN) * WG_ROW + 16 * WT_STAGES + 1024;
}

template <typename T, int EPI, int BN, bool FOLD>
__global__ void __launch_bounds__(WT_THREADS, 1)
gemm_tma_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_w, const WgEpi ep, void* __restrict__ C,
                int M, int N, int K) {
  constexpr int BK = WG_ROW / (int)sizeof(T);  // values of K a k-tile
  static_assert(wg_stage_bytes<EPI, BN>() <= WT_STAGES * (WT_BM + BN) * WG_ROW, "staging");
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  unsigned char* As = smem + ((1024 - (s0 & 1023)) & 1023);
  unsigned char* Ws = As + WT_STAGES * WT_BM * WG_ROW;
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + WT_STAGES * BN * WG_ROW);
  uint64_t* empty = full + WT_STAGES;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int m0 = blockIdx.y * WT_BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < WT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if (tid == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % WT_STAGES;
        if (kt >= WT_STAGES) mbar_wait(&empty[s], (kt / WT_STAGES - 1) & 1);
        mbar_arrive_expect(&full[s], (WT_BM + BN) * WG_ROW);
        tma_load_2d(As + s * WT_BM * WG_ROW, &tma_a, kt * BK, m0, &full[s]);
        tma_load_2d(Ws + s * BN * WG_ROW, &tma_w, kt * BK, n0, &full[s]);
      }
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
    const int s = kt % WT_STAGES;
    mbar_wait(&full[s], (kt / WT_STAGES) & 1);
    wg_ktile<FOLD>(acc, facc, smem_addr(As + s * WT_BM * WG_ROW + cw * 64 * WG_ROW),
                   smem_addr(Ws + s * BN * WG_ROW), kt * BK, K, ep, row0, M);
    wgmma_wait<1>();  // tile kt - 1's products are done: release its stage
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(kt - 1) % WT_STAGES]);
  }
  wgmma_wait<0>();
  named_barrier(1, 256);  // both consumers are done with the ring
  uint32_t* stage = reinterpret_cast<uint32_t*>(As) + cw * 64 * wg_pitch<EPI, BN>();
  wg_stage<EPI, FOLD>(acc, facc, ep, stage, row0, n0, M, N);
  named_barrier(2 + cw, 128);
  wg_flush<EPI, BN>(stage, C, tid & 127, m0 + cw * 64, n0, M, N);
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
  CUtensorMap ta, tw;
  cudaError_t err = wt_tensor_map<T>(&ta, A, M, K, WT_BM);
  if (err == cudaSuccess) err = wt_tensor_map<T>(&tw, W, N, K, BN);
  if (err != cudaSuccess) return err;
  constexpr int smem = wt_smem<BN>();
  err = cudaFuncSetAttribute(gemm_tma_kernel<T, EPI, BN, FOLD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + WT_BM - 1) / WT_BM);
  gemm_tma_kernel<T, EPI, BN, FOLD><<<grid, WT_THREADS, smem, stream>>>(ta, tw, ep, C, M, N, K);
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
  static_assert(EPI < EPQ_BIAS, "bf16 epilogues");
  WgEpi ep{};
  ep.bias = bias;
  ep.resid = static_cast<const bf16*>(resid);
  return wt_takes<bf16>(A, W, K) ? launch_gemm_tma<bf16, EPI, 256, false>(A, W, ep, C, M, N, K, stream)
                                 : launch_gemm_edge<bf16, EPI, false>(A, W, ep, C, M, N, K, stream);
}

// C = epilogue(A . W^T), int8 codes (EPQ_*; ep as WgEpi says)
template <int EPI>
cudaError_t gemm_q(const void* A, const void* W, const WgEpi& ep, void* C, int M, int N, int K,
                   cudaStream_t stream) {
  static_assert(EPI >= EPQ_BIAS, "int8 epilogues");
  const bool tma = wt_takes<int8_t>(A, W, K);
  if constexpr (EPI == EPQ_CHUNKED_RESID) {
    if (ep.chunk < K)
      return tma ? launch_gemm_tma<int8_t, EPI, 128, true>(A, W, ep, C, M, N, K, stream)
                 : launch_gemm_edge<int8_t, EPI, true>(A, W, ep, C, M, N, K, stream);
  }
  return tma ? launch_gemm_tma<int8_t, EPI, 256, false>(A, W, ep, C, M, N, K, stream)
             : launch_gemm_edge<int8_t, EPI, false>(A, W, ep, C, M, N, K, stream);
}

bool gemm_wide_shape_ok(long long m, int n, int k) {
  return m > 0 && m <= 2147483647 && n > 0 && k > 0 && (m + WT_BM - 1) / WT_BM <= 65535;
}

}  // namespace
