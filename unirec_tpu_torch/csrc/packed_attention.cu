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
// product serves them all.  That packing only buys MXU tile use; this kernel
// computes each item's softmax over its own F keys and gives the other
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
// operations a byte), so bytes bound it (0.32 ms at 3.35 TB/s).  This first
// design does the arithmetic as scalar fp32 FMAs from shared memory (one
// code path for bf16 and fp32), which reaches the fp32 rate's order (17.2
// GFLOP at 67 TFLOP/s is 0.26 ms) before the bytes; tensor cores are later
// work.
//   One block per (group of G items, head): G = 128 / K items (the TPU
//   tile's rows) or fewer, as the caller (ops/packed_attention.py) sizes it
//   to shared memory; the items' k and v, then chunks of 64 query rows, in
//   shared memory as fp32 rows of hd + 1, read with 16-byte loads (rows
//   start on 16-byte boundaries); one thread per (row, key) score,
//   one per row for the softmax, one per output element.  Each output has
//   one owner and the sums run in a fixed order: identical bits run to run.
//
// Every C entry launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "head_dim.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QC = 64;                  // query rows of a chunk
constexpr size_t MAX_SMEM = 232448;     // shared memory a block may use

struct Strides {
  long long b, h, r;  // elements between batches, heads and rows
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of a row (8 bf16 or 4 floats) -> fp32 shared memory; rows start on
// 16-byte boundaries (the wrapper checks)
template <typename T>
__device__ __forceinline__ void load16(float* dst, const T* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = to_f(x[i]);
}

// the shared memory of a block of G items (ops/packed_attention.py's
// smem_bytes): k and v [G * F][hd + 1], q [qc][hd + 1], e [qc][F + 1], l [qc],
// bias [G * F], qc = min(64, G * K)
size_t smem_bytes(int hd, int G, int K, int F) {
  const size_t qc = G * K < QC ? G * K : QC;
  return sizeof(float) * (2 * (size_t)G * F * (hd + 1) + qc * (hd + 1) + qc * (F + 1) + qc +
                          (size_t)G * F);
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
packed_item_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os,
                             int B, int K, int F, int G, float scale) {
  constexpr int RS = HD + 1;  // padded row stride of a q / k / v row
  constexpr int V = 16 / sizeof(T);  // elements of one 16-byte load
  constexpr int VPR = HD / V;        // loads per row
  const int FS = F + 1;       // padded row stride of an e row
  const int qc = G * K < QC ? G * K : QC;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [G * F][RS]
  float* Vs = Ks + G * F * RS;       // [G * F][RS]
  float* Qs = Vs + G * F * RS;       // [qc][RS]
  float* Es = Qs + qc * RS;          // [qc][FS]  scores, then exp(s - m)
  float* ls = Es + qc * FS;          // [qc]      l with 0 guarded to 1
  float* bs = ls + qc;               // [G * F]

  const int g0 = blockIdx.x * G;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int items = min(G, B - g0);
  const int keys = items * F, rows = items * K;

  for (int e = tid; e < keys * VPR; e += THREADS) {
    const int kr = e / VPR, d = (e % VPR) * V;
    const long long b = g0 + kr / F;
    const int j = kr % F;
    load16(Ks + kr * RS + d, k + b * ks.b + h * ks.h + j * ks.r + d);
    load16(Vs + kr * RS + d, v + b * vs.b + h * vs.h + j * vs.r + d);
  }
  for (int kr = tid; kr < keys; kr += THREADS)
    bs[kr] = bias ? bias[(long long)g0 * F + kr] : 0.f;

  for (int r0 = 0; r0 < rows; r0 += qc) {
    const int nr = min(qc, rows - r0);
    __syncthreads();  // k / v / bias stored; the previous chunk's reads done
    for (int e = tid; e < nr * VPR; e += THREADS) {
      const int r = e / VPR, d = (e % VPR) * V;
      const int row = r0 + r;
      const long long b = g0 + row / K;
      load16(Qs + r * RS + d, q + b * qs.b + h * qs.h + (row % K) * qs.r + d);
    }
    __syncthreads();

    // s = (q . k) * scale + bias over the row's own item's keys
    for (int e = tid; e < nr * F; e += THREADS) {
      const int r = e / F, j = e % F;
      const int kr = ((r0 + r) / K) * F + j;
      const float* qr = Qs + r * RS;
      const float* kk = Ks + kr * RS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kk[d], dot);
      Es[r * FS + j] = __fadd_rn(__fmul_rn(dot, scale), bs[kr]);
    }
    __syncthreads();

    if (tid < nr) {
      float* er = Es + tid * FS;
      float m = -INFINITY;
      for (int j = 0; j < F; ++j) m = fmaxf(m, er[j]);
      float l = 0.f;
      for (int j = 0; j < F; ++j) {
        const float x = expf(er[j] - m);
        er[j] = x;
        l += x;
      }
      ls[tid] = l == 0.f ? 1.f : l;
    }
    __syncthreads();

    // o = (e . v) / l
    for (int e = tid; e < nr * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      const int row = r0 + r;
      const int it = row / K;
      const float* er = Es + r * FS;
      const float* vc = Vs + it * F * RS + d;
      float acc = 0.f;
      for (int j = 0; j < F; ++j) acc = fmaf(er[j], vc[j * RS], acc);
      store(o + (long long)(g0 + it) * os.b + h * os.h + (row % K) * os.r + d, acc / ls[r]);
    }
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B, int H, int K, int F,
                   int G, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, G, K, F);
  cudaError_t err = cudaFuncSetAttribute(packed_item_attention_kernel<HD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + G - 1) / G, H);
  packed_item_attention_kernel<HD, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(o), qs, ks, vs, os, B, K, F, G, scale);
  return cudaGetLastError();
}

}  // namespace

// B15: o [B, H, K, hd] from q [B, H, K, hd], k / v [B, H, F, hd] (strides in
// elements for (batch, head, row) of q, k, v and o) and bias [B, F] float or
// null; G items per block (K * G <= 128; the caller sizes it to shared
// memory).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int unirec_packed_item_attention(
    const void* q, const void* k, const void* v, const float* bias, void* o, long long qsb,
    long long qsh, long long qsr, long long ksb, long long ksh, long long ksr, long long vsb,
    long long vsh, long long vsr, long long osb, long long osh, long long osr, int B, int H,
    int K, int F, int G, int head_dim, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || H > 65535 || K <= 0 || 128 % K || F <= 0 || G <= 0 ||
      K * G > 128 || dtype < 0 || dtype > 1 || smem_bytes(head_dim, G, K, F) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qsr}, ks{ksb, ksh, ksr}, vs{vsb, vsh, vsr}, os{osb, osh, osr};
  return (int)with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    if (dtype == 0)
      return launch<HD, float>(q, k, v, bias, o, qs, ks, vs, os, B, H, K, F, G, scale, s);
    return launch<HD, __nv_bfloat16>(q, k, v, bias, o, qs, ks, vs, os, B, H, K, F, G, scale,
                                     s);
  });
}
