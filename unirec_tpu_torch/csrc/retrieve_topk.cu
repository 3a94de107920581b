// Blocked full-catalog retrieval with a running top-k, for Hopper (sm_90a).
//
// Replaces unirec_tpu/ops/ranking.py::retrieve_top_k (_retrieval_kernel with
// merge_running_topk): fp32 dot products of L2-normalised users [B, D] against
// the L2-normalised catalog [N, D], returning the top k <= 32 per user in
// descending score order, ties going to the lower catalog index.  The [B, N]
// score matrix never reaches device memory.
//
// The TPU grid walked the catalog in order and carried the running top-k in
// VMEM from one step to the next.  Blocks on Hopper run in no order, so this
// is two passes:
//   1. grid (catalog split S, user tile of 8).  Each block keeps its 8 users in
//      shared memory and streams its slice of catalog rows; each warp scores 4
//      rows per step (float4 loads, 32 sums per lane, folded to one score per
//      lane by a reduce-scatter butterfly) and keeps a private sorted top-k per
//      user.  The block then merges its 8 warp lists per user and writes a
//      sorted [k] partial result per (user, split).
//   2. one warp per user merges the S sorted partial lists.
//
// What bounds it: the catalog read, 82 MB in fp32 at N=20,000, D=1,024.  At
// 8 users the arithmetic is 4 FMAs per catalog float; the splits put every SM
// to work on the stream.  At 64 users (8 user tiles) the catalog is re-read
// per user tile, from L2 where it fits; fewer tiles per block are later work.
//
// B11, the same search over an int8 catalog (replaces
// unirec_tpu/ops/quantization.py::retrieve_top_k_int8, _q_retrieval_kernel):
// rows row-quantized by quantize_rows into int8 codes [N, D] and fp32 scales
// [N]; a row scores (u . float(q_n)) * s_n.  The partial pass is the same
// kernel, reading 4 codes (4 bytes) per lane where it read 4 floats, and
// scaling each row's sum once.  The catalog read drops 4x, to 20.5 MB.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BU = 8;        // users per block
constexpr int WARPS = 8;     // warps per block
constexpr int ROWS = 4;      // catalog rows per warp step (BU * ROWS == 32)
constexpr int KMAX = 32;
constexpr int THREADS = WARPS * 32;
constexpr int MERGE_WARPS = 4;  // users per block in pass 2
constexpr unsigned FULL = 0xffffffffu;

// Total order: higher score first, then lower catalog index, then lower list.
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void insert(float* ls, int* li, int k, float s, int i) {
  if (!better(s, i, ls[k - 1], li[k - 1])) return;
  int p = k - 1;
  while (p > 0 && better(s, i, ls[p - 1], li[p - 1])) {
    ls[p] = ls[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  ls[p] = s;
  li[p] = i;
}

// One warp merges `nlists` sorted lists of length k (list l starts at
// ls + l * stride) into the top k, written by lane 0.  heads: nlists ints of
// shared memory private to this warp.
template <typename Idx>
__device__ void warp_merge(const float* ls, const int* li, int nlists, int stride,
                           int k, int* heads, float* out_s, Idx* out_i) {
  const int lane = threadIdx.x & 31;
  for (int l = lane; l < nlists; l += 32) heads[l] = 0;
  __syncwarp();
  for (int j = 0; j < k; ++j) {
    float bs = -INFINITY;
    int bi = INT_MAX, bl = -1;
    for (int l = lane; l < nlists; l += 32) {
      const int h = heads[l];
      if (h >= k) continue;
      const float s = ls[l * stride + h];
      const int i = li[l * stride + h];
      if (bl < 0 || better(s, i, bs, bi)) {
        bs = s;
        bi = i;
        bl = l;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(FULL, bs, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      const int ol = __shfl_xor_sync(FULL, bl, o);
      const bool take = ol >= 0 && (bl < 0 || better(os, oi, bs, bi) ||
                                    (os == bs && oi == bi && ol < bl));
      if (take) {
        bs = os;
        bi = oi;
        bl = ol;
      }
    }
    if (lane == 0) {
      out_s[j] = bs;
      out_i[j] = (Idx)bi;
      if (bl >= 0) heads[bl] += 1;
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float4 load4(const float* __restrict__ c, size_t off) {
  return __ldg(reinterpret_cast<const float4*>(c + off));
}

__device__ __forceinline__ float4 load4(const int8_t* __restrict__ c, size_t off) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(c + off));
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}

// T = float: scores are the dot products.  T = int8_t: each dot product is
// multiplied by its row's scale.
template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_partial_kernel(const float* __restrict__ users, const T* __restrict__ catalog,
                    const float* __restrict__ scales, float* __restrict__ part_s,
                    int* __restrict__ part_i, int B, int N, int D, int k, int rows_per_split) {
  extern __shared__ float smem[];
  float* us = smem;                                   // [BU][D]
  float* ls = us + BU * D;                            // [WARPS][BU][KMAX]
  int* li = reinterpret_cast<int*>(ls + WARPS * BU * KMAX);
  int* heads = li + WARPS * BU * KMAX;                // [WARPS][WARPS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, S = gridDim.x;
  const int u0 = blockIdx.y * BU;
  for (int e = tid; e < BU * D; e += THREADS) {
    const int u = e / D;
    us[e] = (u0 + u < B) ? users[(size_t)(u0 + u) * D + e % D] : 0.f;
  }
  for (int e = tid; e < WARPS * BU * KMAX; e += THREADS) {
    ls[e] = -INFINITY;
    li[e] = INT_MAX;
  }
  __syncthreads();

  const int r0 = split * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  float* my_ls = ls + warp * BU * KMAX;
  int* my_li = li + warp * BU * KMAX;
  for (int base = r0 + warp * ROWS; base < r1; base += WARPS * ROWS) {
    float v[ROWS * BU];
#pragma unroll
    for (int x = 0; x < ROWS * BU; ++x) v[x] = 0.f;
    for (int d0 = lane * 4; d0 < D; d0 += 128) {
      float4 c[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = base + r;
        c[r] = row < r1 ? load4(catalog, (size_t)row * D + d0) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < BU; ++u) {
        const float4 uv = *reinterpret_cast<const float4*>(us + u * D + d0);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float a = v[r * BU + u];
          a = fmaf(c[r].x, uv.x, a);
          a = fmaf(c[r].y, uv.y, a);
          a = fmaf(c[r].z, uv.z, a);
          a = fmaf(c[r].w, uv.w, a);
          v[r * BU + u] = a;
        }
      }
    }
    // reduce-scatter butterfly: afterwards v[0] on lane x holds the full sum
    // of value x = r * BU + u
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int x = 0; x < o; ++x) {
        const float send = upper ? v[x] : v[x + o];
        const float keep = upper ? v[x + o] : v[x];
        v[x] = keep + __shfl_xor_sync(FULL, send, o);
      }
    }
    float score = v[0];
    if constexpr (sizeof(T) == 1) {  // lane x holds row x / BU
      const int row = base + lane / BU;
      score *= row < r1 ? __ldg(scales + row) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float cs = __shfl_sync(FULL, score, (lane % BU) + r * BU);
      const int row = base + r;
      if (lane < BU && row < r1 && u0 + lane < B)
        insert(my_ls + lane * KMAX, my_li + lane * KMAX, k, cs, row);
    }
    __syncwarp();
  }
  __syncthreads();

  // warp w merges user w's WARPS lists
  const int u = u0 + warp;
  if (u < B) {
    const size_t off = ((size_t)u * S + split) * k;
    warp_merge<int>(ls + warp * KMAX, li + warp * KMAX, WARPS, BU * KMAX, k,
                    heads + warp * WARPS, part_s + off, part_i + off);
  }
}

__global__ void topk_merge_kernel(const float* __restrict__ part_s,
                                  const int* __restrict__ part_i, float* __restrict__ out_s,
                                  long long* __restrict__ out_i, int B, int S, int k) {
  extern __shared__ int merge_heads[];  // [MERGE_WARPS][S]
  const int warp = threadIdx.x >> 5;
  const int u = blockIdx.x * MERGE_WARPS + warp;
  if (u >= B) return;
  const size_t off = (size_t)u * S * k;
  warp_merge<long long>(part_s + off, part_i + off, S, k, k, merge_heads + warp * S,
                        out_s + (size_t)u * k, out_i + (size_t)u * k);
}

template <typename T>
cudaError_t retrieve(const float* users, const T* catalog, const float* scales, float* part_s,
                     int* part_i, float* out_s, long long* out_i, int B, int N, int D, int k,
                     int splits, cudaStream_t s) {
  if (k < 1 || k > KMAX || k > N || D % 4 != 0 || B <= 0 || splits <= 0)
    return cudaErrorInvalidValue;
  const size_t smem1 = (size_t)BU * D * sizeof(float) +
                       (size_t)WARPS * BU * KMAX * (sizeof(float) + sizeof(int)) +
                       WARPS * WARPS * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  const int rows_per_split = (N + splits - 1) / splits;
  dim3 grid1(splits, (B + BU - 1) / BU);
  topk_partial_kernel<T><<<grid1, THREADS, smem1, s>>>(users, catalog, scales, part_s, part_i,
                                                       B, N, D, k, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = (size_t)MERGE_WARPS * splits * sizeof(int);
  topk_merge_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, smem2, s>>>(
      part_s, part_i, out_s, out_i, B, splits, k);
  return cudaGetLastError();
}

}  // namespace

// users [B, D], catalog [N, D] float32 (both already L2-normalised);
// part_s/part_i [B, splits, k] scratch; out_s [B, k] float32, out_i [B, k] int64.
// Requires 1 <= k <= 32, k <= N, D % 4 == 0 (checked by the wrapper).
extern "C" int unirec_retrieve_topk(const float* users, const float* catalog, float* part_s,
                                    int* part_i, float* out_s, long long* out_i, int B,
                                    int N, int D, int k, int splits, void* stream) {
  return (int)retrieve<float>(users, catalog, nullptr, part_s, part_i, out_s, out_i, B, N, D,
                              k, splits, static_cast<cudaStream_t>(stream));
}

// B11.  users [B, D] float32 (L2-normalised); catalog codes [N, D] int8 and
// row scales [N] float32 (quantize_rows); the rest as unirec_retrieve_topk.
extern "C" int unirec_retrieve_topk_int8(const float* users, const int8_t* catalog,
                                         const float* scales, float* part_s, int* part_i,
                                         float* out_s, long long* out_i, int B, int N, int D,
                                         int k, int splits, void* stream) {
  return (int)retrieve<int8_t>(users, catalog, scales, part_s, part_i, out_s, out_i, B, N, D,
                               k, splits, static_cast<cudaStream_t>(stream));
}
