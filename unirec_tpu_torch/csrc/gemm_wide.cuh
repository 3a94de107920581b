// The projection GEMM of the trainable Item Q-Former blocks (B12s / B12c in
// fused_qformer_vjp.cu).  The sweep's blocks (qformer_blocks.cu) keep
// gemm_bf16.cuh, so that their GEMMs do not move.
//
//   gemm_wide: C[M, N] = A[M, K] . W[N, K]^T (+ epilogue), both operands
//   bf16 with K contiguous (W is the torch Linear layout), on
//   gemm_tma_kernel, or gemm_edge_kernel where TMA cannot take the rows.
//
// What bounds it: tensor-core arithmetic (x . Wqkv at 512 items is 103
// GFLOP against 130 MB).  gemm_bf16.cuh's mma.sync tiles ran these products
// at 19-27% of the bf16 peak, and no mma.sync tiling did much better on this
// card (scripts/bench_gemm_wide.py, PERF.md): mma.sync issues from each
// warp, 16 x 8 x 16 at a time.  Here the warpgroup product wgmma does it:
//   * 128 x 256 block tiles, two consumer warpgroups of 64 x 256 (128 fp32
//     accumulators a thread), each k-step of 16 one wgmma.m64n256k16 with A
//     and B read from shared memory through descriptors;
//   * BK = 64: a tile row is 128 bytes, stored with the 128-byte swizzle that
//     wgmma reads (chunk c of row r at chunk c ^ (r % 8), 1024-byte aligned
//     tiles), loaded by TMA from a producer warp into a 4-stage ring of
//     mbarrier-tracked stages (193 KB of shared memory, one block per SM);
//     at most one k-tile of products is in flight (wgmma.wait_group 1)
//     before a stage is released.  The same wgmma over a ring that every
//     thread fills with 16-byte cp.async reached 125-329 TFLOP/s at
//     B12's shapes; TMA and the producer warp, 349-387
//     (scripts/bench_gemm_wide.py, PERF.md);
//   * the edge path: rows whose width is not a multiple of 8 bf16 (or
//     operands not 16-byte aligned) cannot take TMA; gemm_edge_kernel fills
//     its ring with 4-byte cp.async copies where K is even and plain 2-byte
//     loads where it is odd, zero past the ragged edges, and both kernels'
//     epilogues store single values where N is odd;
//   * epilogues: +bias -> bf16 (the projections), and the bare fp32 sum
//     (the backward's dctx = dout . Wo^T).
//
// Everything is in an unnamed namespace: each source that includes this
// header gets its own copy, and nothing is exported.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WG_BK = 64;  // one 128-byte swizzled row

enum { WG_BIAS = 0, WG_F32 = 1 };

// element k of row r of a swizzled 64-column tile
__device__ __forceinline__ int wg_at(int r, int k) {
  return r * WG_BK + ((((k >> 3) ^ r) & 7) << 3) + (k & 7);
}

// the epilogue of one accumulator pair: columns col, col + 1 (if < N) of
// row, + bias (WG_BIAS, -> bf16) or bare (WG_F32); pairs: N is even, so
// (row * N + col) is too and the two values go in one store
template <int EPI>
__device__ __forceinline__ void wg_store(void* C, const float* bias, int row, int col, int N,
                                         bool pairs, float v0, float v1) {
  const bool two = col + 1 < N;
  if constexpr (EPI == WG_BIAS) {
    v0 += bias[col];
    v1 += two ? bias[col + 1] : 0.f;
  }
  const size_t off = (size_t)row * N + col;
  if constexpr (EPI == WG_F32) {
    float* c = static_cast<float*>(C) + off;
    if (pairs) {
      *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
    } else {
      c[0] = v0;
      if (two) c[1] = v1;
    }
  } else {
    bf16* c = static_cast<bf16*>(C) + off;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(v0, v1);
    } else {
      c[0] = __float2bfloat16(v0);
      if (two) c[1] = __float2bfloat16(v1);
    }
  }
}

// ------------------------------------------------ TMA, warp-specialised --
// The aligned path: one producer warpgroup whose first thread keeps TMA
// loads of the A and W tiles in flight (each stage's full barrier counts
// their bytes), and two consumer warpgroups of 64 x 256 that wait for a
// stage, multiply it with wgmma and release it (empty barrier) once the
// products that read it are done.  No thread spends issue slots or
// registers on copies, and the ring runs WT_STAGES - 1 tiles ahead.

constexpr int WT_BM = 128;
constexpr int WT_BN = 256;
constexpr int WT_STAGES = 4;
constexpr int WT_THREADS = 384;  // producer warpgroup + two consumers
// the ring, its barriers, and room to align it to 1024 bytes
constexpr int WT_SMEM = WT_STAGES * (WT_BM + WT_BN) * WG_BK * (int)sizeof(bf16) +
                        16 * WT_STAGES + 1024;

template <int EPI>
__global__ void __launch_bounds__(WT_THREADS, 1)
gemm_tma_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_w, const float* __restrict__ bias,
                void* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  bf16* As = reinterpret_cast<bf16*>(smem + ((1024 - (s0 & 1023)) & 1023));
  bf16* Ws = As + WT_STAGES * WT_BM * WG_BK;
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + WT_STAGES * WT_BN * WG_BK);
  uint64_t* empty = full + WT_STAGES;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int m0 = blockIdx.y * WT_BM;
  const int n0 = blockIdx.x * WT_BN;
  const int k_tiles = (K + WG_BK - 1) / WG_BK;
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
        mbar_arrive_expect(&full[s], (WT_BM + WT_BN) * WG_BK * (int)sizeof(bf16));
        tma_load_2d(As + s * WT_BM * WG_BK, &tma_a, kt * WG_BK, m0, &full[s]);
        tma_load_2d(Ws + s * WT_BN * WG_BK, &tma_w, kt * WG_BK, n0, &full[s]);
      }
    }
    return;
  }

  const int cw = wg - 1;  // consumer: rows cw * 64 ..
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % WT_STAGES;
    mbar_wait(&full[s], (kt / WT_STAGES) & 1);
    const uint32_t as = smem_addr(As + s * WT_BM * WG_BK + cw * 64 * WG_BK);
    const uint32_t ws = smem_addr(Ws + s * WT_BN * WG_BK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_m64n256k16(acc, wgmma_desc(as + 32 * kk), wgmma_desc(ws + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // tile kt - 1's products are done: release its stage
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(kt - 1) % WT_STAGES]);
  }
  wgmma_wait<0>();

  // acc[4n + e]: row 16 * warp + g + 8 * (e >> 1), column 8n + 2t + (e & 1)
  const int lane = tid & 31;
  const int row0 = m0 + cw * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int n = 0; n < WT_BN / 8; ++n) {
    const int col = n0 + n * 8 + (lane & 3) * 2;
    if (col >= N) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row0 + hf * 8 < M)
        wg_store<EPI>(C, bias, row0 + hf * 8, col, N, pairs, acc[4 * n + 2 * hf],
                      acc[4 * n + 2 * hf + 1]);
  }
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

// the tensor map of a row-major [rows, cols] bf16 matrix in boxes of 64
// columns x box_rows rows, 128-byte swizzled (zeros past its edges)
inline cudaError_t wt_tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                                 int box_rows) {
  const WtEncodeFn encode = wt_encode();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)WG_BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int EPI>
cudaError_t launch_gemm_tma(const void* A, const void* W, const float* bias, void* C, int M,
                            int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tw;
  cudaError_t err = wt_tensor_map(&ta, A, M, K, WT_BM);
  if (err == cudaSuccess) err = wt_tensor_map(&tw, W, N, K, WT_BN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_tma_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WT_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + WT_BN - 1) / WT_BN, (M + WT_BM - 1) / WT_BM);
  gemm_tma_kernel<EPI><<<grid, WT_THREADS, WT_SMEM, stream>>>(ta, tw, bias, C, M, N, K);
  return cudaGetLastError();
}

// ------------------------------------------------------- the edge path --
// Rows that TMA cannot take (K not a multiple of 8, or operands not 16-byte
// aligned): two warpgroups of 64 x 128 over a 3-stage ring that every thread
// fills, with 4-byte cp.async copies where K is even and plain 2-byte loads
// where it is odd (zeros past the ragged edges), into the same swizzled
// tiles; tile kt + 1 is loaded while tile kt is multiplied.

constexpr int WE_BM = 128;
constexpr int WE_BN = 128;
constexpr int WE_STAGES = 3;
constexpr int WE_THREADS = 256;
constexpr int WE_A_TILE = WE_BM * WG_BK;
constexpr int WE_W_TILE = WE_BN * WG_BK;
constexpr int WE_SMEM = WE_STAGES * (WE_A_TILE + WE_W_TILE) * (int)sizeof(bf16) + 1024;

template <int EPI>
__global__ void __launch_bounds__(WE_THREADS, 2)
gemm_edge_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, void* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  bf16* As = reinterpret_cast<bf16*>(smem + ((1024 - (s0 & 1023)) & 1023));
  bf16* Ws = As + WE_STAGES * WE_A_TILE;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroup: rows wg * 64 ..
  const int m0 = blockIdx.y * WE_BM;
  const int n0 = blockIdx.x * WE_BN;
  const int k_tiles = (K + WG_BK - 1) / WG_BK;
  const bool words = K % 2 == 0 && ((uintptr_t)A | (uintptr_t)W) % 4 == 0;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * WG_BK;
    bf16* as = As + stage * WE_A_TILE;
    bf16* ws = Ws + stage * WE_W_TILE;
    if (words) {  // rows of whole 4-byte words
      for (int e = tid; e < (WE_BM + WE_BN) * WG_BK / 2; e += WE_THREADS) {
        const int r = e / (WG_BK / 2);
        const int kc = (e - r * (WG_BK / 2)) * 2;
        const int gk = k0 + kc;
        if (r < WE_BM) {
          const bool p = gk < K && m0 + r < M;
          cp_async_4(smem_addr(as + wg_at(r, kc)), p ? A + (size_t)(m0 + r) * K + gk : A, p);
        } else {
          const int rw = r - WE_BM;
          const bool p = gk < K && n0 + rw < N;
          cp_async_4(smem_addr(ws + wg_at(rw, kc)), p ? W + (size_t)(n0 + rw) * K + gk : W, p);
        }
      }
    } else {
      for (int e = tid; e < (WE_BM + WE_BN) * WG_BK; e += WE_THREADS) {
        const int r = e / WG_BK;
        const int kc = e - r * WG_BK;
        const int gk = k0 + kc;
        bf16 v = __float2bfloat16(0.f);
        if (r < WE_BM) {
          if (gk < K && m0 + r < M) v = A[(size_t)(m0 + r) * K + gk];
          as[wg_at(r, kc)] = v;
        } else {
          const int rw = r - WE_BM;
          if (gk < K && n0 + rw < N) v = W[(size_t)(n0 + rw) * K + gk];
          ws[wg_at(rw, kc)] = v;
        }
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (k_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<0>();   // this thread's copies of tile kt have landed
    fence_proxy_async();  // visible to wgmma's reads
    __syncthreads();      // everyone's; and tile kt - 2's products are done
    if (kt + 1 < k_tiles) load_tile((kt + 1) % WE_STAGES, kt + 1);
    cp_async_commit();

    const uint32_t as = smem_addr(As + (kt % WE_STAGES) * WE_A_TILE + wg * 64 * WG_BK);
    const uint32_t ws = smem_addr(Ws + (kt % WE_STAGES) * WE_W_TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_m64n128k16(acc, wgmma_desc(as + 32 * kk), wgmma_desc(ws + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // tile kt - 1's products done: its stage may be refilled
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  const int lane = tid & 31;
  const int row0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int n = 0; n < WE_BN / 8; ++n) {
    const int col = n0 + n * 8 + (lane & 3) * 2;
    if (col >= N) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row0 + hf * 8 < M)
        wg_store<EPI>(C, bias, row0 + hf * 8, col, N, pairs, acc[4 * n + 2 * hf],
                      acc[4 * n + 2 * hf + 1]);
  }
}

template <int EPI>
cudaError_t launch_gemm_edge(const void* A, const void* W, const float* bias, void* C, int M,
                             int N, int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_edge_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WE_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + WE_BN - 1) / WE_BN, (M + WE_BM - 1) / WE_BM);
  gemm_edge_kernel<EPI><<<grid, WE_THREADS, WE_SMEM, stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(W), bias, C, M, N, K);
  return cudaGetLastError();
}

// C = A . W^T (+ epilogue): the TMA kernel where the rows are whole
// 16-byte chunks (K a multiple of 8, 16-byte aligned operands), the edge
// kernel otherwise
template <int EPI>
cudaError_t gemm_wide(const void* A, const void* W, const float* bias, void* C, int M, int N,
                      int K, cudaStream_t stream) {
  const bool tma = K % 8 == 0 && (uintptr_t)A % 16 == 0 && (uintptr_t)W % 16 == 0;
  return tma ? launch_gemm_tma<EPI>(A, W, bias, C, M, N, K, stream)
             : launch_gemm_edge<EPI>(A, W, bias, C, M, N, K, stream);
}

bool gemm_wide_shape_ok(long long m, int n, int k) {
  return m > 0 && m <= 2147483647 && n > 0 && k > 0 && (m + WT_BM - 1) / WT_BM <= 65535;
}

}  // namespace
