// Exact small-K per-item attention for Hopper (sm_90a): kernel B15.
//
// Replaces the Pallas TPU kernel
//   B15  unirec_tpu/ops/packed_attention.py::packed_item_attention
//        (_packed_kernel :39, call :148): q [B, H, K, hd], k / v [B, H, F, hd]
//        and an additive per-key bias [B, F]; every item's K query rows
//        attend over that item's F keys.
// Its arithmetic, as the JAX kernel does it:
//   s = (q . k) * scale + bias        two fp32 roundings (no contraction)
//   m = max_j s,  e = exp(s - m),  l = sum_j e
//   o = (sum_j e v_j) / (l == 0 ? 1 : l)              in q's dtype
//
// The TPU kernel packs 128 / K items into one 128-row MXU tile and adds a
// block-diagonal mask, -2e9 on every other item's keys, so that a 128 x 128
// product serves them all.  That packing only buys MXU tile use; these
// kernels compute each item's softmax over its own F keys and give the other
// items' keys no weight at all.  That equals the TPU kernel: an item with a
// valid key has a score near its logits (|s| << 1e9) while every foreign key
// sits at or below -2e9, so exp(s - m) of a foreign key is exactly 0 in fp32
// and adds nothing to l or o; an item with no valid key scores its own keys
// at about -1e9 (the bias), which still beats -2e9, so m is its own keys'
// maximum and the item is uniform over its OWN keys (the per-item XLA
// behaviour the JAX kernel's -2e9 was chosen for), never over other items'.
//
// What bounds it: at the item sweep's self-attention shape (4096 items, 16
// heads, K = F = 32, hd 64, bf16) it reads q, k and v and writes o once,
// 1.07 GB, for 17.2 GFLOP: far below the card's bf16 ridge (about 295
// operations a byte), so bytes bound it (0.32 ms at 3.35 TB/s).
//   * bf16: the per-item attention core of item_attention.cuh (B1/B2/B12's,
//     on mma.sync tensor cores) in its IA_B15 rounding, on B15's per-head
//     strides: whole items packed into 64-row query tiles (the TPU's packing
//     without its mask: a key of another item gets exactly zero weight),
//     resident tiles or 64 x 64 tiles streamed where an item does not fit
//     (any K, F and head dim), e in fp32 entering e . v as a bf16 hi + lo
//     pair, / l after.  The first design ran scalar fp32 FMAs from shared
//     memory: 3.01 ms at the self shape, 1.9x SDPA (PERF.md).
//   * fp32: scalar fp32 FMAs (TF32 would break the fp32 gate of 1e-5, as
//     flash_cross.cu:120 says), on the same packing and key tiling: one block
//     of 256 threads per (64-row query tile, head), 4 x 4 outputs a thread;
//     a first pass over the key tiles takes each row's max and sum, a second
//     recomputes the scores tile by tile (64 columns of the head dim at a
//     time, kept across passes where one tile covers them) and accumulates
//     e . v, 64 output columns at a time: any head dim, K and F.
// Each output has one owner and the sums run in a fixed order: identical
// bits run to run.
//
// Every C entry launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (0 = success).

#include <cuda_bf16.h>
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

bool fits_int(long long x) { return x >= -2147483647LL && x <= 2147483647LL; }

}  // namespace

// B15: o [B, H, K, hd] from q [B, H, K, hd], k / v [B, H, F, hd] (strides in
// elements for (batch, head, row) of q, k, v and o; the head dim contiguous)
// and bias [B, F] float or null; K divides 128.  dtype: 0 = float32, 1 =
// bfloat16 (v with k's strides).
extern "C" int unirec_packed_item_attention(
    const void* q, const void* k, const void* v, const float* bias, void* o, long long qsb,
    long long qsh, long long qsr, long long ksb, long long ksh, long long ksr, long long vsb,
    long long vsh, long long vsr, long long osb, long long osh, long long osr, int B, int H,
    int K, int F, int head_dim, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || H > 65535 || K <= 0 || 128 % K || F <= 0 || head_dim <= 0 ||
      dtype < 0 || dtype > 1 || (long long)B * F > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (vsb != ksb || vsh != ksh || vsr != ksr ||
        !(fits_int(qsr) && fits_int(ksr) && fits_int(osr) && fits_int(qsh) && fits_int(ksh) &&
          fits_int(osh)))
      return (int)cudaErrorInvalidValue;
    IaArgs a{};
    a.q = static_cast<const bf16*>(q);
    a.kv = static_cast<const bf16*>(k);
    a.vbase = static_cast<const bf16*>(v);
    a.key_bias = bias;
    a.ctx = static_cast<bf16*>(o);
    a.q_item = qsb, a.q_stride = (int)qsr, a.q_head = (int)qsh;
    a.kv_item = ksb, a.kv_stride = (int)ksr, a.kv_head = (int)ksh;
    a.ctx_item = osb, a.ctx_stride = (int)osr, a.ctx_head = (int)osh;
    a.q_n = qsb == K * qsr ? 0 : K;  // ia_row: one run of rows, or items of rows
    a.kv_n = ksb == F * ksr ? 0 : F;
    a.ctx_n = osb == K * osr ? 0 : K;
    a.items = B;
    a.nq = K;
    a.nkv = F;
    a.hd = head_dim;
    a.scale = scale;
    return (int)item_attention_fwd<IA_B15>(a, H, s);
  }
  const int ipt = ia_ipt(K, F);
  const int qtiles = K > PT ? (K + PT - 1) / PT : 1;
  const int vec4 = head_dim % 4 == 0 &&
                   ((qsb | qsh | qsr | ksb | ksh | ksr | vsb | vsh | vsr) & 3) == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(packed_attention_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + ipt - 1) / ipt, H, qtiles);
  packed_attention_f32_kernel<<<grid, P_THREADS, P_SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(o), Strides{qsb, qsh, qsr}, Strides{ksb, ksh, ksr},
      Strides{vsb, vsh, vsr}, Strides{osb, osh, osr}, B, K, F, head_dim, ipt, scale, vec4);
  return (int)cudaGetLastError();
}
