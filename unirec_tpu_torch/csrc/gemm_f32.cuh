// A float32 GEMM on CUDA cores for Hopper (sm_90a): the projections of the
// fp32 forms of B1-B3 (qformer_blocks.cu) and B12s/B12c
// (fused_qformer_vjp.cu).
//
//   C[M, N] = epilogue(A[M, K] . W[N, K]^T)   A, W, C float32, W in the torch
//                                            Linear layout [out, in]
// Epilogues:
//   GF_PLAIN       the bare sum (B12's dctx = dout . Wo^T)
//   GF_BIAS        + bias (QKV, Q, KV, B12's output projection)
//   GF_BIAS_GELU   + bias, then the exact erf gelu (B3's up projection: the
//                  JAX kernel takes tanh only for bf16, fused_qformer_layer.py
//                  :532)
//   GF_BIAS_RESID  + bias + resid: the fp32 pre-LayerNorm sum (Wo and W2;
//                  a row LayerNorm reads it, the two-pass route of
//                  unirec_tpu/ops/fused_qformer_layer.py:148-164)
//
// Every product is fp32 FMA on CUDA cores, summed in k order from 0.  TF32
// tensor cores keep about three decimal digits and would break the fp32
// gate of 1e-5 (packed_attention.cu says the same of its fp32 kernel); a
// 3xTF32 or bf16x3 split on tensor cores is later work (ROADMAP.md).  So the
// bound is operations at 67 TFLOP/s: the sweep's fp32 projections run at a
// few hundred FLOP per byte, far above the card's fp32 ridge (~20).
//
// Design, a plain shared-memory SGEMM: a block of 256 threads owns a 128 x
// 128 tile of C; each thread 8 x 8 outputs (rows ty*4.. and 64+ty*4.., cols
// tx*4.. and 64+tx*4..), so every shared-memory read is a float4 that feeds
// 16 FMAs.  K advances in tiles of 8, staged transposed in shared memory
// ([k][row], rows padded to 132 floats: the transposing stores of a warp hit
// 32 banks) and double buffered through registers (the next tile's global
// loads are in flight while this one multiplies).  Ragged M, N and K edges
// load zeros and mask the stores; rows whose length is a multiple of 4 and
// 16-byte aligned operands take float4 loads and stores.  Each output has
// one owner and a fixed order of sums: identical bits run to run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int GF_BM = 128;
constexpr int GF_BN = 128;
constexpr int GF_BK = 8;
constexpr int GF_PAD = GF_BM + 4;
constexpr int GF_THREADS = 256;
constexpr int GF_SMEM = 2 * 2 * GF_BK * GF_PAD * 4;  // A and W tiles, two buffers each

enum { GF_PLAIN, GF_BIAS, GF_BIAS_GELU, GF_BIAS_RESID };

// jax.nn.gelu(approximate=False) in fp32
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

template <int EPI>
__global__ void __launch_bounds__(GF_THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ resid,
                float* __restrict__ C, int M, int N, int K, int vec) {
  extern __shared__ __align__(16) float gf_smem[];  // GF_SMEM bytes
  float(*As)[GF_BK][GF_PAD] = reinterpret_cast<float(*)[GF_BK][GF_PAD]>(gf_smem);
  float(*Ws)[GF_BK][GF_PAD] = As + 2;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * GF_BM;
  const int n0 = blockIdx.y * GF_BN;
  // this thread's share of a k-tile: 4 consecutive k of one row of A and W
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const long long arow = m0 + lr;
  const int wrow = n0 + lr;
  const float* ap = A + arow * K;
  const float* wp = W + (long long)wrow * K;
  float ra[4], rw[4];

  auto fetch = [&](int k0) {
    const int k = k0 + lk;
    if (vec && k < K) {  // K % 4 == 0: the 4 values are in the row
      float4 a = arow < M ? *reinterpret_cast<const float4*>(ap + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 w = wrow < N ? *reinterpret_cast<const float4*>(wp + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      ra[0] = a.x, ra[1] = a.y, ra[2] = a.z, ra[3] = a.w;
      rw[0] = w.x, rw[1] = w.y, rw[2] = w.z, rw[3] = w.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ra[i] = arow < M && k + i < K ? ap[k + i] : 0.f;
        rw[i] = wrow < N && k + i < K ? wp[k + i] : 0.f;
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[buf][lk + i][lr] = ra[i];
      Ws[buf][lk + i][lr] = rw[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int k_tiles = (K + GF_BK - 1) / GF_BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_tiles) fetch((kt + 1) * GF_BK);
#pragma unroll
    for (int k = 0; k < GF_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < k_tiles) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = n0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + j;
        v[j] = acc[i][4 * h + j];
        if (col >= N) continue;
        if constexpr (EPI != GF_PLAIN) v[j] = v[j] + bias[col];
        if constexpr (EPI == GF_BIAS_GELU) v[j] = gelu_erf(v[j]);
        if constexpr (EPI == GF_BIAS_RESID) v[j] = v[j] + resid[row * N + col];
      }
      float* dst = C + row * N + c0;
      if (vec && c0 + 4 <= N) {  // N % 4 == 0: 16-byte aligned
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < N) dst[j] = v[j];
      }
    }
  }
}

// what gemm_f32 takes: M rows in the grid's x axis, N in its y axis
bool gemm_f32_shape_ok(long long m, int n, int k) {
  return m > 0 && m <= 2147483647LL && n > 0 && k > 0 && (n + GF_BN - 1) / GF_BN <= 65535;
}

// C = epilogue(A . W^T), float32 (bias [N] for every epilogue but GF_PLAIN,
// resid [M, N] for GF_BIAS_RESID); refuses a shape gemm_f32_shape_ok does
// not take
template <int EPI>
cudaError_t gemm_f32(const float* A, const float* W, const float* bias, const float* resid,
                     float* C, long long M, int N, int K, cudaStream_t stream) {
  if (!gemm_f32_shape_ok(M, N, K)) return cudaErrorInvalidValue;
  const int vec = K % 4 == 0 && N % 4 == 0 &&
                  (((uintptr_t)A | (uintptr_t)W | (uintptr_t)C) % 16) == 0;
  const dim3 grid((unsigned)((M + GF_BM - 1) / GF_BM), (N + GF_BN - 1) / GF_BN);
  gemm_f32_kernel<EPI><<<grid, GF_THREADS, GF_SMEM, stream>>>(A, W, bias, resid, C, (int)M, N, K, vec);
  return cudaGetLastError();
}

}  // namespace
