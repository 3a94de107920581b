// The bf16 GEMM of the item-token sweep's Q-Former blocks B1-B3 at widths
// that are whole 16-byte rows (qformer_blocks.cu; the trainable blocks
// B12s/B12c, the int8 blocks B4-B6 and B1-B3 at other widths take
// gemm_wide.cuh, which also holds gelu_tanh).  Its cp.async / ldmatrix /
// mma.sync helpers, which the int8 GEMM of qformer_blocks.cu also uses, are
// in ptx_helpers.cuh.
//
//   gemm_bf16_kernel: C[M, N] = A[M, K] . W[N, K]^T, both operands bf16 with K
//   contiguous (W is the torch Linear layout), 128x128x32 block tiles, 8 warps
//   of 64x32, mma.sync m16n8k16 with fp32 accumulation, ldmatrix from padded
//   shared rows, a 3-stage cp.async ring.  Ragged M, N and K edges are
//   zero-filled on load and masked on store.  Epilogues: +bias -> bf16,
//   +bias -> tanh gelu in fp32 -> bf16, +bias +residual -> fp32, and the bare
//   fp32 sum (no bias: the backward's dctx = dout . Wo).
//
// Everything is in an unnamed namespace: each source that includes this
// header gets its own copy, and nothing is exported.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_wide.cuh"
#include "ptx_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- GEMM ----

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int GEMM_THREADS = 256;
constexpr int LDS = BK + 8;  // padded shared row (80 bytes): ldmatrix conflict-free
constexpr int A_TILE = BM * LDS;
constexpr int W_TILE = BN * LDS;
constexpr int GEMM_SMEM = STAGES * (A_TILE + W_TILE) * (int)sizeof(bf16);  // 61,440

enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESID = 2, EPI_F32 = 3 };

// C[M, N] = A[M, K] . W[N, K]^T + epilogue.  N and K are multiples of 8;
// bias is not read by EPI_F32 (pass nullptr).
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const bf16* __restrict__ resid,
                 void* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + STAGES * A_TILE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // warp rows wm*64 .. +63
  const int wn = warp & 3;   // warp cols wn*32 .. +31
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * A_TILE;
    bf16* ws = Ws + stage * W_TILE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;  // 512 chunks of 16 bytes per operand
      const int r = c >> 2;
      const int kc = (c & 3) * 8;
      const int gk = k0 + kc;
      const bool pa = gk < K && m0 + r < M;
      cp_async_16(smem_addr(as + r * LDS + kc), pa ? A + (size_t)(m0 + r) * K + gk : A, pa);
      const bool pw = gk < K && n0 + r < N;
      cp_async_16(smem_addr(ws + r * LDS + kc), pw ? W + (size_t)(n0 + r) * K + gk : W, pw);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // and every warp is done with tile kt - 1
    const int next = kt + STAGES - 1;
    if (next < k_tiles) load_tile(next % STAGES, next);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * A_TILE;
    const bf16* ws = Ws + (kt % STAGES) * W_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(a[mi], smem_addr(as + r * LDS + kk + (lane >> 4) * 8));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        const int n = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t t[4];
        ldmatrix_x4(t, smem_addr(ws + n * LDS + kk + ((lane >> 3) & 1) * 8));
        b[2 * nj][0] = t[0];
        b[2 * nj][1] = t[1];
        b[2 * nj + 1][0] = t[2];
        b[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + t4 * 2;
    if (col >= N) continue;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (EPI != EPI_F32) {
      b0 = bias[col];
      b1 = bias[col + 1];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm * 64 + mi * 16 + g + hf * 8;
        if (row >= M) continue;
        float v0 = acc[mi][ni][2 * hf] + b0;
        float v1 = acc[mi][ni][2 * hf + 1] + b1;
        const size_t off = (size_t)row * N + col;
        if constexpr (EPI == EPI_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(C) + off) = make_float2(v0, v1);
        } else if constexpr (EPI == EPI_BIAS_RESID) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(resid + off);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
          *reinterpret_cast<float2*>(static_cast<float*>(C) + off) = make_float2(v0, v1);
        } else {
          if constexpr (EPI == EPI_BIAS_GELU) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + off) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int EPI>
cudaError_t gemm(const void* A, const void* W, const float* bias, const void* resid, void* C,
                 int M, int N, int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(W), bias,
      static_cast<const bf16*>(resid), C, M, N, K);
  return cudaGetLastError();
}

bool gemm_shape_ok(long long m, int n, int k) {
  return m > 0 && n > 0 && k > 0 && n % 8 == 0 && k % 8 == 0 &&
         (m + BM - 1) / BM <= 65535;
}

}  // namespace
