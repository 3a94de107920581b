// Per-item softmax attention in float32 on CUDA cores for Hopper (sm_90a),
// one kernel for four callers: B15's fp32 form (packed_attention.cu) and the
// fp32 forms of B1, B2 (qformer_blocks.cu) and the forwards of B12s / B12c
// (fused_qformer_vjp.cu), and the helpers of B12's fp32 backward.
//
// q [B, H, K, hd], k / v [B, H, F, hd] at any strides (Strides: elements
// between items, heads and rows; the head dim contiguous), an additive key
// bias [B, F] or none; every item's K query rows attend over its own F keys:
//   s = (q . k) * scale + bias        two fp32 roundings (no contraction)
//   m = max_j s,  e = exp(s - m),  l = sum_j e
//   o = (sum_j e v_j) / (l == 0 ? 1 : l)
// Scalar fp32 FMAs (TF32 would break the fp32 gate of 1e-5, as
// flash_cross.cu:120 says): one block of 256 threads per (64-row query tile
// of whole items, head), 4 x 4 outputs a thread; a first pass over the key
// tiles takes each row's max and sum, a second recomputes the scores tile by
// tile (64 columns of the head dim at a time, kept across passes where one
// tile covers them) and accumulates e . v, 64 output columns at a time: any
// head dim, K and F.  Keys of another item of the tile get no weight at all,
// so an item with no valid key (every bias -1e9) is uniform over its own
// keys.  Each output has one owner and the sums run in a fixed order:
// identical bits run to run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "item_attention.cuh"

namespace {

constexpr int PT = 64;          // query rows / keys of a tile, columns of a chunk
constexpr int PP = PT + 1;      // padded fp32 row of a tile
constexpr int P_THREADS = 256;  // 16 x 16: rows ty + 16i, keys (or columns) tx + 16j
constexpr int P_SMEM = 3 * PT * PP * 4 + 2 * PT * 4;

struct Strides {
  long long b, h, r;  // elements between batches, heads and rows
};

// dst[r][c] = row r0 + r of the block (item r / n, row r % n of it), columns
// c0 + c, for r < nr and c0 + c < hd; zeros elsewhere
__device__ __forceinline__ void pa_load(float* dst, const float* base, Strides s, int n, int r0,
                                        int nr, int c0, int hd, bool vec4) {
  for (int e = threadIdx.x; e < PT * PT / 4; e += P_THREADS) {
    const int r = e / (PT / 4), c = (e % (PT / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < nr) {
      const int row = r0 + r;
      const float* src = base + (row / n) * s.b + (row % n) * s.r + c0 + c;
      if (vec4 && c0 + c + 4 <= hd) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
      } else {
        for (int i = 0; i < 4; ++i)
          if (c0 + c + i < hd) x[i] = src[i];
      }
    }
    for (int i = 0; i < 4; ++i) dst[r * PP + c + i] = x[i];
  }
}

__device__ __forceinline__ float pa_half_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float pa_half_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (blocks of ipt items, heads, 64-row query tiles of an item when K > 64)
__global__ void __launch_bounds__(P_THREADS)
packed_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            float* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os,
                            int B, int K, int F, int hd, int ipt, float scale, int vec4) {
  extern __shared__ __align__(16) float pa_smem[];
  float* Qs = pa_smem;       // [64][65] q chunk
  float* Ks = Qs + PT * PP;  // [64][65] k chunk, then v chunk
  float* Ss = Ks + PT * PP;  // [64][65] e of a key tile
  float* kb = Ss + PT * PP;  // [64] the key tile's bias
  int* ki = reinterpret_cast<int*>(kb + PT);  // [64] its keys' local item, -1 past the block
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int item0 = blockIdx.x * ipt;
  const int n_items = min(ipt, B - item0);
  const int rows_b = n_items * K, keys_b = n_items * F;
  const int nkt = (keys_b + PT - 1) / PT;
  const int r0 = blockIdx.z * PT;
  const int rows_t = min(PT, rows_b - r0);
  const size_t h = blockIdx.y;
  const float* qg = q + item0 * qs.b + h * qs.h;
  const float* kg = k + item0 * ks.b + h * ks.h;
  const float* vg = v + item0 * vs.b + h * vs.h;
  int ritem[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    ritem[i] = r < rows_b ? r / K : -2;
  }

  // s of this thread's 4 x 4 (row, key) pairs of key tile kt, -inf off the item
  auto scores = [&](int kt, float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < hd; c += PT) {
      __syncthreads();  // every thread is done with the tiles
      pa_load(Qs, qg, qs, K, r0, rows_t, c, hd, vec4);
      pa_load(Ks, kg, ks, F, kt * PT, keys_b - kt * PT, c, hd, vec4);
      if (c == 0 && threadIdx.x < PT) {
        const int key = kt * PT + threadIdx.x;
        const bool live = key < keys_b;
        ki[threadIdx.x] = live ? key / F : -1;
        kb[threadIdx.x] = live && bias != nullptr ? bias[(size_t)item0 * F + key] : 0.f;
      }
      __syncthreads();
      const int w = min(PT, hd - c);
      for (int d = 0; d < w; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * PP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * PP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = ki[jj] == ritem[i] ? __fadd_rn(__fmul_rn(s[i][j], scale), kb[jj]) : -INFINITY;
    }
  };

  // pass 1: each row's max and sum of e (the sums over this thread's keys,
  // reduced over the 16 threads of the row at the end)
  float s[4][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    scores(kt, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], pa_half_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                                     fmaxf(s[i][2], s[i][3]))));
      const float base = mn == -INFINITY ? 0.f : mn;
      float sum = l[i] * expf(m[i] - base);
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - base);
      l[i] = sum;
      m[i] = mn;
    }
  }
  float den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sum = pa_half_sum(l[i]);
    den[i] = sum == 0.f ? 1.f : sum;
    if (m[i] == -INFINITY) m[i] = 0.f;
  }

  // pass 2: e . v, 64 output columns at a time
  const bool keep = nkt == 1 && hd <= PT;  // s of pass 1 is this tile's
  for (int oc = 0; oc < hd; oc += PT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      if (!keep) scores(kt, s);
      __syncthreads();  // every thread is done with Ks and Ss
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ss[(ty + 16 * i) * PP + tx + 16 * j] = expf(s[i][j] - m[i]);  // 0 off the item
      pa_load(Ks, vg, vs, F, kt * PT, keys_b - kt * PT, oc, hd, vec4);
      __syncthreads();
      for (int j = 0; j < PT; ++j) {
        float ev[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ev[i] = Ss[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) vv[c] = Ks[j * PP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(ev[i], vv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows_t) continue;
      const int row = r0 + r;
      float* dst = o + (item0 + row / K) * os.b + h * os.h + (row % K) * os.r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = oc + tx + 16 * c;
        if (col < hd) dst[col] = __fdiv_rn(acc[i][c], den[i]);
      }
    }
  }
}

// o = attention(q, k, v) in float32 as above; the items of a block follow
// ia_ipt (item_attention.cuh), K > 64 takes one item a block and a grid axis
// over its query tiles
cudaError_t attention_f32_fwd(const float* q, Strides qs, const float* k, Strides ks,
                              const float* v, Strides vs, const float* bias, float* o, Strides os,
                              int B, int H, int K, int F, int hd, float scale,
                              cudaStream_t stream) {
  const int ipt = ia_ipt(K, F);
  const int qtiles = K > PT ? (K + PT - 1) / PT : 1;
  const int vec4 = hd % 4 == 0 &&
                   ((qs.b | qs.h | qs.r | ks.b | ks.h | ks.r | vs.b | vs.h | vs.r) & 3) == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(packed_attention_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + ipt - 1) / ipt, H, qtiles);
  packed_attention_f32_kernel<<<grid, P_THREADS, P_SMEM, stream>>>(
      q, k, v, bias, o, qs, ks, vs, os, B, K, F, hd, ipt, scale, vec4);
  return cudaGetLastError();
}

}  // namespace
