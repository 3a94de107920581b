// Head dimensions above 256 in the flash kernels K1, B7b, B13, B14 and B14p:
// the head-dim-chunked form.
//
// Replaces, at head dims above 256, the Pallas TPU kernels
//   K1       unirec_tpu/ops/flash_causal_vjp.py::_fwd_kernel (and the stock
//            flash of unirec_tpu/models/qwen3.py:347);
//   B7b      unirec_tpu/ops/flash_causal_vjp.py::_dq_kernel and _dkv_kernel;
//   B13      unirec_tpu/ops/attention.py::flash_cross_attention (_flash_kernel);
//   B14      unirec_tpu/ops/flash_vjp.py::_mh_fwd_kernel and _mh_bwd_kernel;
//   B14p     unirec_tpu/ops/flash_vjp.py::_fwd_kernel and _bwd_kernel.
// The JAX kernels take any head dim (flash_causal_vjp.py pads lanes;
// flash_vjp.py and attention.py hold the whole head in a VMEM block).
// Hopper's shared memory does not hold a whole head above 256 next to the
// tiles of the designs at <= 256, so above 256 the head dim is cut into C =
// ceil(hd / 256) chunks of 256 columns (the last chunk's columns past hd
// zero-filled in shared memory; the wrappers zero-pad to C * 256 only a head
// dim whose rows are not whole 16-byte pieces, ops/attention.padded_launch)
// and a grid axis runs over the chunks: one
// block owns one chunk of the output columns, and a call is one launch (two
// where the bf16 cross forward splits its keys, below).  The designs at <=
// 256 are not touched.
//
// What bounds it (bf16, bytes): at the 2-head user step's shape (64 users,
// 64 queries over 1,600 memory rows, 2 heads of 512) the forward reads ~420
// MB of q, k and v for 27 GFLOP and the backward moves ~870 MB for 67
// GFLOP, 0.13 and 0.26 ms at 3.35 TB/s, 8 times what the arithmetic takes
// at the bf16 tensor-core peak; at 8 users an eighth of both.  K1 at B 2, L
// 512, 4 / 2 heads reads ~12 MB (3.5 us).  Four things kept the first form
// (scalar fp32 FMA) 5-8 times behind scaled_dot_product_attention:
//   1. no tensor cores: every product a scalar FMA (67 TFLOP/s of fp32);
//   2. staging through registers into padded float rows, q restaged for
//      every key tile and chunk, two barriers per chunk;
//   3. small key tiles (32) and a small grid (32 blocks at 8 users);
//   4. the scores computed C times, once in each chunk's block.
//
// bf16 design (tensor cores; chunk_fwd_tc, chunk_fwd_merge, chunk_bwd_rows_tc,
// chunk_bwd_keys_tc; the cluster form below reuses its tiles):
//   - One block of 4 warps per (64-row q tile, chunk, head, batch), warp w
//     owning rows 16 w .. 16 w + 15; products on mma.sync.m16n8k16 (bf16 in,
//     fp32 accumulate) through ldmatrix, from bf16 rows padded to 264
//     columns (33 x 16 bytes: ldmatrix without bank conflicts).  (1)
//   - The q tile's C chunks (and in the backward dO's) are loaded once by
//     16-byte cp.async and stay in shared memory for the whole key loop.
//     Each 32-key tile streams through a ring as units of one chunk [32][264]
//     by 16-byte cp.async: the forward's C + 1 units are the K chunks 0 ..
//     C - 1, then the block's V chunk; the backward's 2 C are K and V of
//     chunk 0, then of chunk 1, ...  One barrier per unit; the next units
//     load while this one computes.  (2)
//   - A block's time is the chain of its key tiles: products, barriers and the
//     softmax one after another, with the SM mostly waiting (one block of 4
//     warps at 8 users took 0.21 ms for B13, 1.4 us a unit; two blocks an SM
//     at 64 users took 0.26 ms for 8 times the work; taking the score
//     products, the softmax or the barriers out of it one at a time saved
//     0.017-0.032 ms each, scripts/probe_chunked_fwd.py).  So the forward's
//     ring is 2 units where that lets two blocks share an SM (101,632 bytes at
//     C = 2), and the cross forward (B13, B14, B14p) splits each row's key
//     tiles over as many blocks as fill two an SM when its grid is smaller (8
//     splits of up to 7 key tiles at 8 users; none at 64), each split writing
//     its unnormalised o, m and l in float32 and chunk_fwd_merge combining
//     them in split order (m = max, l and o rescaled by exp(m_s - m)).  K1
//     takes no split: at B 2, L 512 its merge cost more than the split saved.
//     Key tiles stay at 32 keys: each thread holds the 256 fp32 columns of its
//     chunk of o (or dq) for two rows, 128 registers, as the hd-256 designs
//     do.  (3)
//   - S = sum_c Q_c K_c^T is summed in chunk order 0 .. C - 1 in every
//     chunk's block, so all C blocks hold the same S, m, l and P bit for bit;
//     the chunk-0 block (or the merge) writes m and l.  The scores are still
//     computed C times (4): a block needs all of P for its columns of P V
//     (the cluster form below computes them once).
//   - Forward: the online softmax in fp32 registers in the accumulator
//     layout (__expf); P is rounded to bf16 in registers as the A fragment
//     of P V_c.  B14 / B14p (o in float32, read by dsum) take P as two bf16
//     terms, hi and lo, each tile's P V summed from zero and folded into o by
//     one fp32 fma; B13 and K1 (o in bf16) take hi, accumulated in place.
//   - Backward: S and dP = sum_c dO_c V_c^T on tensor cores; the block's K_c
//     is copied aside as its unit passes; p = exp(s - m) / l and ds = p (dp -
//     dsum) scale in fp32 registers, ds rounded to bf16 for dq += ds K_c (dq
//     in registers over the pass).  B14 / B14p write p and ds as bf16 to
//     shared memory and the four warps split the tile's dv_c = p^T dO_c and
//     dk_c = ds^T Q_c by 16-key groups (ldmatrix.trans), written at once, or
//     with Lq > 64 as float32 partials per q tile that chunk_dkv_sum adds in
//     q-tile order (deterministic).  dsum comes from the caller (the float32
//     o of B14 / B14p), m and l from the forward.  B7b's dq is the same
//     kernel without dk / dv.
//   - B7b's dk / dv (chunk_bwd_keys_tc): one block of 8 warps per (32-key
//     tile, chunk, key head, batch), as the scalar kernel's grid, over the
//     group's query heads and the 32-row q tiles from the diagonal on; dk_c
//     and dv_c in fp32 registers over the loop (64 a thread).  The key
//     tile's C chunks of K and V stay in shared memory; each q tile streams
//     through the ring as C stages of (Q_cc, dO_cc), chunk c last (its Q_c
//     and dO_c then serve the products: loading them again after chunk C
//     - 1 would add half the loads at C = 2, and the ring's loads and
//     barriers alone took 0.074 of the first form's 0.19 ms at
//     WIDE_CAUSAL, scripts/probe_chunked_keys.py).  S^T_cc =
//     K_cc Q_cc^T (warps 0-3) and dP^T_cc = V_cc dO_cc^T (warps 4-7), a 16
//     x 16 block a warp, are partials of their own, summed in chunk order;
//     dP^T crosses to warps 0-3 through shared memory, which write p^T and
//     ds^T as bf16; then dv_c += p^T dO_c (warps 0-3) and dk_c += ds^T Q_c
//     (4-7), a 16-key x 128-column block a warp.
//   - Shared memory (of 232,448 bytes): forward C * 33,792 (q) + S *
//     17,024 (a unit and a key tile's key info), S = 2 at C = 2 (101,632
//     bytes, two blocks an SM) and as many as fit, at least 2, up to C = 5
//     (hd <= 1280); backward over rows 2 C * 33,792 (q, dO) + 16,896 (K_c)
//     + 10,240 (p, ds) + S * 17,024, S = 4 at C = 2 (230,400 bytes), the
//     most chunks it holds (hd <= 512); backward over keys C * 33,792 (K,
//     V) + 10,368 (p^T, ds^T, dP^T, the mask) + S * 34,176 (Q_cc, dO_cc and
//     the rows' stats), S = 4 at C = 2, 2 at C = 4 (hd <= 1024).
//
// Cluster design (bf16 above those limits, up to 8 chunks: the forward at 6
// <= C <= 8, dq and B14 / B14p's backward at 3 <= C <= 8;
// flash_chunked_cluster.cuh): the C chunk blocks of a q tile run as one
// thread-block cluster; each keeps only its own Q_c (and dO_c) resident,
// streams only its own K_c / V_c, and the partial scores S_c (and dP_c)
// are summed in rank order through distributed shared memory, one cluster
// barrier a key tile, so every block holds the same S bit for bit and the
// scores are computed once (4).  What bounds it: a block's chain of key
// tiles, as above, plus one cluster barrier and C float4 reads through
// distributed shared memory a thread for each partial; shared memory 101 KB
// (forward) and 230 KB (backward) whatever C is; the cluster's 8 blocks,
// the portable size.
//
// float32 design (chunk_fwd_cl32, chunk_bwd_rows_cl32 in
// flash_chunked_cluster.cuh, 2 to 8 chunks): the cluster schedule with
// every product on tensor cores in 3xTF32 (each float32 operand split into
// tf32 big + small, three products a step; ptx_helpers.cuh), which holds
// the 1e-5 float32 gates where plain TF32 (one product) misses them by 30
// to 60 times (tests/test_torch_tf32_split.py); 8 warps a block, one block
// an SM, key splits where the grid holds fewer (the cross forward and
// backward, K1 and B7b's dq).
//
// The form rule (form()), by shape before the launch: bf16 on tensor cores
// up to 5 chunks forward, 2 over rows, 4 over keys; in a cluster up to 8
// forward and over rows; float32 in a cluster in 3xTF32 up to 8 chunks
// forward and over rows; the scalar kernels below (templates on the type)
// for bf16 above those (the forward and over rows above hd 2048, dk / dv
// above 1024) and for float32 above 8 chunks and over keys (B7b's dk /
// dv).
//
// Scalar design (chunk_fwd, chunk_bwd_rows, chunk_bwd_keys; above the other
// forms' chunk counts, and float32's dk / dv): scalar fp32 FMAs, staged
// through shared memory one chunk at a time in chunk order, 16 x 16 threads
// over 64-row q tiles and 32-key tiles: the scores are computed C times and
// q and k staged once per (key tile, chunk) pair.
//   - Backward: B7b keeps its two kernels (dq over the key tiles of a q
//     tile, dk / dv over the q tiles of a key tile and its GQA group); B14
//     and B14p keep one pass over the keys: a block writes its chunk of dq,
//     and its chunk of each key tile's dk / dv (float32 partials per 64-row
//     q tile when Lq > 64, summed in q-tile order by a second kernel).
//
// Masks and numerics are each family's own:
//   cross (B13 / B14 / B14p): s = (q . k) * scale + bias (two roundings), m
//     starts at -1e9, keys past Lkv excluded, o = acc / (l == 0 ? 1 : l);
//   causal (K1 / B7b): s = (q . k) * scale, keys after the row or with mask
//     0 excluded, m starts at -inf, o = acc * (l > 0 ? 1 / l : 0); key 0 of
//     every row is valid (the wrappers' check_pad_mask).
// Layouts: (batch, head, row) strides per tensor in elements, the head dim
// contiguous and rows on 16-byte boundaries; query head h reads key head
// h / group.  m, l, dsum [B, Lq, H] float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ptx_helpers.cuh"

namespace chunked {

using bf16 = __nv_bfloat16;

constexpr int CW = 256;       // columns of a chunk
constexpr int RS = CW + 1;    // padded float row of a staged chunk
constexpr int BQ = 64;        // query rows of a block (of a q tile)
constexpr int BK = 32;        // keys of a key tile
constexpr int PS = BK + 1;    // padded row of the p / ds tiles [BQ][PS]
constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int RQ = BQ / 16;   // score rows of a thread: ty * RQ + i
constexpr int RK = BK / 16;   // score keys of a thread: tx + 16 j; key rows of dk / dv: ty * RK + i
constexpr int CJ = CW / 16;   // output columns of a thread: tx + 16 j
constexpr float NEG_INF = -1e9f;

struct Strides {
  long long b, h, r;  // elements between batches, heads and rows
};

// forward: Q chunk, K chunk, V chunk, p, the key tile's bias and validity
constexpr size_t FWD_BYTES = (size_t)(BQ * RS + 2 * BK * RS + BQ * PS + 2 * BK) * sizeof(float);
// backward: Q, dO, K, V chunks, p and ds, m / l / dsum, bias and validity
constexpr size_t BWD_BYTES =
    (size_t)(2 * BQ * RS + 2 * BK * RS + 2 * BQ * PS + 3 * BQ + 2 * BK) * sizeof(float);
static_assert(BWD_BYTES <= 232448, "shared memory of one block");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }

// the columns of chunk c that hold data, of a head dim of cols columns
__host__ __device__ __forceinline__ int chunk_cols(int cols, int c) {
  return cols - c * CW < CW ? cols - c * CW : CW;
}

// rows [r0, r0 + n) of one chunk (src at the chunk's first column, row
// stride rs) -> smem [n][RS] floats, rows past L and columns from ncol on
// as zero; 16-byte loads
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs, int r0, int n,
                                      int L, int ncol, int tid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = CW / V;
  for (int e = tid; e < n * VPR; e += THREADS) {
    const int r = e / VPR, d = (e % VPR) * V;
    const int row = r0 + r;
    float* out = dst + r * RS + d;
    if (row < L && d < ncol) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (long long)row * rs + d);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = to_f(x[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = 0.f;
    }
  }
}

// the key tile's bias (cross: bias[key] or 0) and validity (cross: key <
// Lkv; causal: key < Lkv and mask[key] != 0) into bs / ok
template <bool CAUSAL>
__device__ __forceinline__ void stage_keys(float* bs, float* ok, const float* bm, int k0,
                                           int Lkv, int tid) {
  if (tid < BK) {
    const int key = k0 + tid;
    const bool in = key < Lkv;
    if (CAUSAL) {
      bs[tid] = 0.f;
      ok[tid] = in && bm[key] != 0.f ? 1.f : 0.f;
    } else {
      bs[tid] = in && bm != nullptr ? bm[key] : 0.f;
      ok[tid] = in ? 1.f : 0.f;
    }
  }
}

// the scaled score of one (row, key) pair and whether the pair is live
template <bool CAUSAL>
__device__ __forceinline__ float pair_score(float dot, float scale, float bias, bool key_ok,
                                            int row, int key, bool& live) {
  if (CAUSAL) {
    live = key_ok && key <= row;
    return dot * scale;
  }
  live = key_ok;
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// s += Qc . Kc^T (and dp += dOc . Vc^T) over one staged chunk: rows ty * RQ
// + i of the q tile, keys tx + 16 j of the key tile
template <bool DP>
__device__ __forceinline__ void accumulate(float (&s)[RQ][RK], float (&dp)[RQ][RK],
                                           const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < CW; ++d) {
    float qv[RQ], ov[RQ], kv[RK], vv[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = Qs[(ty * RQ + i) * RS + d];
      if (DP) ov[i] = dOs[(ty * RQ + i) * RS + d];
    }
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      kv[j] = Ks[(tx + 16 * j) * RS + d];
      if (DP) vv[j] = Vs[(tx + 16 * j) * RS + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        if (DP) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// max / sum over the 16 threads (tx) that share a row: a half warp
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the forward for one (q tile, chunk, head, batch): blockIdx.y = h * C + c.
// o (type OT) gets the chunk's columns; with m_out the chunk-0 block writes
// m and l.  bm: the cross bias [B, Lkv] (or null), or the causal pad mask
// [B, Lkv].
template <typename T, typename OT, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
chunk_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ bm, OT* __restrict__ o, float* __restrict__ m_out,
          float* __restrict__ l_out, Strides qs, Strides ks, Strides vs, Strides os, int Lq,
          int Lkv, int H, int group, int C, int cols, float scale) {
  extern __shared__ __align__(16) float chunk_smem[];
  float* Qs = chunk_smem;          // [BQ][RS]
  float* Ks = Qs + BQ * RS;    // [BK][RS]
  float* Vs = Ks + BK * RS;    // [BK][RS]  the block's chunk of V
  float* Ps = Vs + BK * RS;    // [BQ][PS]
  float* bs = Ps + BQ * PS;    // [BK]
  float* oks = bs + BK;        // [BK]

  // longest rows first (causal: the last q tiles visit the most key tiles)
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y / C, c = blockIdx.y % C;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h + c * CW;
  const float* bmb = bm ? bm + (long long)b * Lkv : nullptr;
  const int n_kv = CAUSAL ? (min(q0 + BQ, Lq) - 1) / BK + 1 : (Lkv + BK - 1) / BK;

  float m_run[RQ], l_run[RQ], acc[RQ][CJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_run[i] = CAUSAL ? -INFINITY : NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    for (int cc = 0; cc < C; ++cc) {
      __syncthreads();  // the previous chunk's (and tile's P / V) reads are done
      stage(Qs, qb + cc * CW, qs.r, q0, BQ, Lq, chunk_cols(cols, cc), tid);
      stage(Ks, kb + cc * CW, ks.r, k0, BK, Lkv, chunk_cols(cols, cc), tid);
      if (cc == 0) {
        stage(Vs, vb, vs.r, k0, BK, Lkv, chunk_cols(cols, c), tid);
        stage_keys<CAUSAL>(bs, oks, bmb, k0, Lkv, tid);
      }
      __syncthreads();
      accumulate<false>(s, s, Qs, nullptr, Ks, nullptr, ty, tx);
    }

    // online softmax; every row has a live key in tile 0 (cross: key 0 <
    // Lkv; causal: key 0 is valid), so m is finite from there on
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
      float mx = -INFINITY;
      bool live[RK];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kc = tx + 16 * j;
        s[i][j] = pair_score<CAUSAL>(s[i][j], scale, bs[kc], oks[kc] != 0.f, row, k0 + kc,
                                     live[j]);
        if (live[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], half_max(mx));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * RQ + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + half_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // p written

#pragma unroll 4
    for (int kc = 0; kc < BK; ++kc) {
      float pv[RQ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty * RQ + i) * PS + kc];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = Vs[kc * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  OT* ob = o + b * os.b + h * os.h + c * CW;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= Lq) continue;
    float inv_or_den;
    if (CAUSAL)
      inv_or_den = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
    else
      inv_or_den = l_run[i] == 0.f ? 1.f : l_run[i];
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      if (c * CW + tx + 16 * j < cols)
        put(ob + row * os.r + tx + 16 * j,
            CAUSAL ? acc[i][j] * inv_or_den : acc[i][j] / inv_or_den);
    if (m_out != nullptr && c == 0 && tx == 0) {
      const size_t r = ((size_t)b * Lq + row) * H + h;
      m_out[r] = m_run[i];
      l_out[r] = l_run[i];
    }
  }
}

struct BwdStrides {
  Strides q, k, v, dout, dq, dk, dv;
};

// p = exp(s - m) / l and ds = p (dp - dsum) scale of the block's score
// fragment into Ps and dSs (zero for dead pairs and rows past Lq)
template <bool CAUSAL>
__device__ __forceinline__ void p_and_ds(const float (&s)[RQ][RK], const float (&dp)[RQ][RK],
                                         float* Ps, float* dSs, const float* ms,
                                         const float* ls, const float* dsums, const float* bs,
                                         const float* oks, int q0, int k0, int Lq, float scale,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int kc = tx + 16 * j;
      bool live;
      const float sc = pair_score<CAUSAL>(s[i][j], scale, bs[kc], oks[kc] != 0.f, row, k0 + kc,
                                          live);
      const float p = live && row < Lq ? expf(sc - ms[r]) / ls[r] : 0.f;
      Ps[r * PS + kc] = p;
      dSs[r * PS + kc] = p * (dp[i][j] - dsums[r]) * scale;
    }
  }
}

// m, l (0 guarded to 1) and dsum of rows [q0, q0 + BQ) of head h
__device__ __forceinline__ void stage_rows(float* ms, float* ls, float* dsums, const float* m_in,
                                           const float* l_in, const float* dsum_in, int b,
                                           int h, int H, int q0, int Lq, int tid) {
  if (tid < BQ) {
    const int row = q0 + tid;
    const size_t r = ((size_t)b * Lq + row) * H + h;
    const float lv = row < Lq ? l_in[r] : 1.f;
    ms[tid] = row < Lq ? m_in[r] : 0.f;
    ls[tid] = lv == 0.f ? 1.f : lv;
    dsums[tid] = row < Lq ? dsum_in[r] : 0.f;
  }
}

// the key-owned product of one key tile over the q tile's BQ rows: out[key
// ty * RK + i][col tx + 16 j] = sum_r A[r][key] B[r][col] (A: p or ds, B: dO
// or Q, both staged)
__device__ __forceinline__ void key_product(float (&acc)[RK][CJ], const float* A,
                                            const float* Bs, int ty, int tx) {
#pragma unroll 2
  for (int r = 0; r < BQ; ++r) {
    float av[RK], bv[CJ];
#pragma unroll
    for (int i = 0; i < RK; ++i) av[i] = A[r * PS + ty * RK + i];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = Bs[r * RS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The backward over the key tiles of one (q tile, chunk, head, batch):
// blockIdx.y = h * C + c.  dq's chunk in registers over the pass.  With DKV
// (cross: B14 / B14p, one pass) each key tile's dk / dv chunk over this q
// tile's rows is written as it is (part null: one q tile, group 1) or as a
// float32 partial [n_qt][dk, dv][B][H][Lkv][C * CW] to part.  Without DKV it
// is B7b's dq kernel.
template <typename T, bool CAUSAL, bool DKV>
__global__ void __launch_bounds__(THREADS)
chunk_bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bm, const T* __restrict__ dout,
               const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ dsum_in, T* __restrict__ dq, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ part, BwdStrides st, int Lq, int Lkv,
               int H, int group, int C, int cols, float scale) {
  extern __shared__ __align__(16) float chunk_smem[];
  float* Qs = chunk_smem;           // [BQ][RS]
  float* dOs = Qs + BQ * RS;    // [BQ][RS]
  float* Ks = dOs + BQ * RS;    // [BK][RS]
  float* Vs = Ks + BK * RS;     // [BK][RS]
  float* Ps = Vs + BK * RS;     // [BQ][PS]
  float* dSs = Ps + BQ * PS;    // [BQ][PS]
  float* ms = dSs + BQ * PS;    // [BQ]
  float* ls = ms + BQ;          // [BQ]
  float* dsums = ls + BQ;       // [BQ]
  float* bs = dsums + BQ;       // [BK]
  float* oks = bs + BK;         // [BK]

  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y / C, c = blockIdx.y % C;
  const int b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kh = h / group;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* dob = dout + b * st.dout.b + h * st.dout.h;
  const T* kb = k + b * st.k.b + kh * st.k.h;
  const T* vb = v + b * st.v.b + kh * st.v.h;
  const float* bmb = bm ? bm + (long long)b * Lkv : nullptr;
  const int n_kv = CAUSAL ? (min(q0 + BQ, Lq) - 1) / BK + 1 : (Lkv + BK - 1) / BK;
  stage_rows(ms, ls, dsums, m_in, l_in, dsum_in, b, h, H, q0, Lq, tid);

  float acc[RQ][CJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int cc = 0; cc < C; ++cc) {
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      const int nc = chunk_cols(cols, cc);
      stage(Qs, qb + cc * CW, st.q.r, q0, BQ, Lq, nc, tid);
      stage(dOs, dob + cc * CW, st.dout.r, q0, BQ, Lq, nc, tid);
      stage(Ks, kb + cc * CW, st.k.r, k0, BK, Lkv, nc, tid);
      stage(Vs, vb + cc * CW, st.v.r, k0, BK, Lkv, nc, tid);
      if (cc == 0) stage_keys<CAUSAL>(bs, oks, bmb, k0, Lkv, tid);
      __syncthreads();
      accumulate<true>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
    }
    p_and_ds<CAUSAL>(s, dp, Ps, dSs, ms, ls, dsums, bs, oks, q0, k0, Lq, scale, ty, tx);
    if (c != C - 1) {  // the block's own chunk of K (and Q, dO) back in place
      __syncthreads();
      stage(Ks, kb + c * CW, st.k.r, k0, BK, Lkv, chunk_cols(cols, c), tid);
      if (DKV) {
        stage(Qs, qb + c * CW, st.q.r, q0, BQ, Lq, chunk_cols(cols, c), tid);
        stage(dOs, dob + c * CW, st.dout.r, q0, BQ, Lq, chunk_cols(cols, c), tid);
      }
    }
    __syncthreads();  // p, ds and the chunk's tiles in place

    // dq += ds K
#pragma unroll 4
    for (int kc = 0; kc < BK; ++kc) {
      float dsv[RQ], kv[CJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = dSs[(ty * RQ + i) * PS + kc];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[kc * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }

    if constexpr (DKV) {
      // dv = p^T dO, then dk = ds^T Q, over this q tile's rows
#pragma unroll 1
      for (int is_dk = 0; is_dk < 2; ++is_dk) {
        float kacc[RK][CJ];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) kacc[i][j] = 0.f;
        key_product(kacc, is_dk ? dSs : Ps, is_dk ? Qs : dOs, ty, tx);
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const int key = k0 + ty * RK + i;
          if (key >= Lkv) continue;
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            const int col = c * CW + tx + 16 * j;
            if (part != nullptr) {
              part[((((long long)(qt * 2 + is_dk) * B + b) * H + h) * Lkv + key) * (C * CW) +
                   col] = kacc[i][j];
            } else if (col < cols) {
              if (is_dk)
                put(dk + b * st.dk.b + h * st.dk.h + key * st.dk.r + col, kacc[i][j]);
              else
                put(dv + b * st.dv.b + h * st.dv.h + key * st.dv.r + col, kacc[i][j]);
            }
          }
        }
      }
    }
  }

  T* dqb = dq + b * st.dq.b + h * st.dq.h + c * CW;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      if (c * CW + tx + 16 * j < cols) put(dqb + row * st.dq.r + tx + 16 * j, acc[i][j]);
  }
}

// B7b's dk / dv kernel: one block per (key tile, chunk, key head, batch),
// blockIdx.y = kh * C + c, over the q tiles at and after the key tile of
// each query head of the key head's group
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_bwd_keys(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ mask, const T* __restrict__ dout,
               const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ dsum_in, T* __restrict__ dk, T* __restrict__ dv,
               BwdStrides st, int L, int H, int group, int C, int cols, float scale) {
  extern __shared__ __align__(16) float chunk_smem[];
  float* Qs = chunk_smem;           // [BQ][RS]
  float* dOs = Qs + BQ * RS;    // [BQ][RS]
  float* Ks = dOs + BQ * RS;    // [BK][RS]
  float* Vs = Ks + BK * RS;     // [BK][RS]
  float* Ps = Vs + BK * RS;     // [BQ][PS]
  float* dSs = Ps + BQ * PS;    // [BQ][PS]
  float* ms = dSs + BQ * PS;    // [BQ]
  float* ls = ms + BQ;          // [BQ]
  float* dsums = ls + BQ;       // [BQ]
  float* bs = dsums + BQ;       // [BK]
  float* oks = bs + BK;         // [BK]

  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y / C, c = blockIdx.y % C;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + b * st.k.b + kh * st.k.h;
  const T* vb = v + b * st.v.b + kh * st.v.h;
  const float* mb = mask + (long long)b * L;
  const int n_qt = (L + BQ - 1) / BQ;
  stage_keys<true>(bs, oks, mb, k0, L, tid);

  float acc_k[RK][CJ], acc_v[RK][CJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const T* qb = q + b * st.q.b + h * st.q.h;
    const T* dob = dout + b * st.dout.b + h * st.dout.h;
    for (int qt = k0 / BQ; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      float s[RQ][RK], dp[RQ][RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int cc = 0; cc < C; ++cc) {
        __syncthreads();  // the previous chunk's (and q tile's) reads are done
        const int nc = chunk_cols(cols, cc);
        stage(Qs, qb + cc * CW, st.q.r, q0, BQ, L, nc, tid);
        stage(dOs, dob + cc * CW, st.dout.r, q0, BQ, L, nc, tid);
        stage(Ks, kb + cc * CW, st.k.r, k0, BK, L, nc, tid);
        stage(Vs, vb + cc * CW, st.v.r, k0, BK, L, nc, tid);
        if (cc == 0) stage_rows(ms, ls, dsums, m_in, l_in, dsum_in, b, h, H, q0, L, tid);
        __syncthreads();
        accumulate<true>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
      }
      p_and_ds<true>(s, dp, Ps, dSs, ms, ls, dsums, bs, oks, q0, k0, L, scale, ty, tx);
      if (c != C - 1) {  // the block's own chunk of Q and dO back in place
        __syncthreads();
        stage(Qs, qb + c * CW, st.q.r, q0, BQ, L, chunk_cols(cols, c), tid);
        stage(dOs, dob + c * CW, st.dout.r, q0, BQ, L, chunk_cols(cols, c), tid);
      }
      __syncthreads();  // p, ds and the chunk's tiles in place
      key_product(acc_v, Ps, dOs, ty, tx);
      key_product(acc_k, dSs, Qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty * RK + i;
    if (key >= L) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = c * CW + tx + 16 * j;
      if (col >= cols) continue;
      put(dk + b * st.dk.b + kh * st.dk.h + key * st.dk.r + col, acc_k[i][j]);
      put(dv + b * st.dv.b + kh * st.dv.h + key * st.dv.r + col, acc_v[i][j]);
    }
  }
}

// ------------------------------------------------- bf16, tensor cores ------

constexpr int TTHREADS = 128;       // 4 warps, 16 query rows each
constexpr int TK = 32;              // keys of a key tile
constexpr int LDC = CW + 8;         // padded bf16 row of a staged chunk (33 x 16 bytes)
constexpr int QCH = BQ * LDC;       // one resident q or dO chunk [BQ][LDC]
constexpr int UNIT = TK * LDC;      // one ring unit: a key tile's K or V chunk [TK][LDC]
constexpr int PLD = TK + 8;         // padded bf16 row of the p / ds tiles
constexpr int MAX_STAGES = 8;      // units of the ring, at most
constexpr size_t SMEM_MAX = 232448;
// a stage of the ring: one unit and one key tile's key info (the key info
// ring has as many entries as the unit ring, indexed by key tile)
constexpr size_t STAGE_BYTES = UNIT * sizeof(bf16) + TK * sizeof(float);
constexpr size_t SMEM_PAIR = 113664;  // a block's share where two share an SM
// forward: Q's C chunks; backward: Q's and dO's, the block's K chunk, p and ds
inline size_t tc_fixed_bytes(int C, bool bwd) {
  return bwd ? (size_t)(2 * C * QCH + UNIT + 2 * BQ * PLD) * sizeof(bf16)
             : (size_t)C * QCH * sizeof(bf16);
}
// the ring's stages: two where that lets two blocks share an SM (the
// forward at C = 2: a block's chain of products, barriers and softmax
// leaves the SM idle enough that a second block is worth more than a deeper
// ring), else as many as fit, up to MAX_STAGES (0 where fewer than 2 fit:
// the scalar form runs)
inline int tc_stages(int C, bool bwd) {
  const size_t fixed = tc_fixed_bytes(C, bwd);
  if (fixed + 2 * STAGE_BYTES <= SMEM_PAIR) return 2;
  const int fit = fixed >= SMEM_MAX ? 0 : (int)((SMEM_MAX - fixed) / STAGE_BYTES);
  return fit < 2 ? 0 : (fit < MAX_STAGES ? fit : MAX_STAGES);
}

// cp.async.wait_group with a run-time count n <= MAX_STAGES - 2
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// rows [r0, r0 + n) of one chunk (src at the chunk's first column, row
// stride rs; rows past L and columns from ncol on zero-filled) -> smem
// [n][LDC] bf16 by 16-byte cp.async, over the NT threads of the block
template <int NT = TTHREADS>
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, long long rs, int r0,
                                           int n, int L, int ncol, int tid) {
  constexpr int CH = CW / 8;  // 16-byte pieces of a chunk's row
  for (int e = tid; e < n * CH; e += NT) {
    const int r = e / CH, ch = e % CH;
    const int row = r0 + r;
    const bool ok = row < L && ch * 8 < ncol;
    cp_async_16(smem_addr(dst + r * LDC + ch * 8), ok ? src + (long long)row * rs + ch * 8 : src,
                ok);
  }
}

// the columns of chunk x a tensor-core kernel loads: all CW unless the head
// dim ends inside the last chunk (PART)
template <bool PART>
__device__ __forceinline__ int tc_cols(int cols, int x) {
  return PART ? chunk_cols(cols, x) : CW;
}

// the key info of the N-key tile at k0 -> kin[N]: cross, the bias (0 where
// there is none, and past Lkv); causal, the pad mask (0 past Lkv).  dummy:
// any global address, read by no copy
template <int N = TK>
__device__ __forceinline__ void copy_key_info(float* kin, const float* bm, int k0, int Lkv,
                                              const void* dummy, int tid) {
  if (tid < N) {
    const int key = k0 + tid;
    const bool ok = bm != nullptr && key < Lkv;
    cp_async_4(smem_addr(kin + tid), ok ? bm + key : static_cast<const float*>(dummy), ok);
  }
}

// s (16 rows of the warp x 8 NT columns) += A (rows r0.., one staged chunk)
// . B^T (the first 8 NT rows of Bt, one staged chunk)
template <int NT>
__device__ __forceinline__ void chunk_scores(float (&s)[NT][4], const bf16* A, const bf16* Bt,
                                             int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < CW / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_addr(A + (r0 + (lane & 15)) * LDC + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      uint32_t bk[4];
      ldmatrix_x4(bk, smem_addr(Bt + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDC +
                                kk * 16 + ((lane >> 3) & 1) * 8));
      mma_16816(s[2 * nj], a, bk[0], bk[1]);
      mma_16816(s[2 * nj + 1], a, bk[2], bk[3]);
    }
  }
}

// the score of one (row, key) pair of the accumulator layout, or -inf where
// the pair is dead: cross (q . k) * scale + bias in two roundings, keys past
// Lkv dead; causal (q . k) * scale, keys after the row or with mask 0 dead
template <bool CAUSAL>
__device__ __forceinline__ float tc_score(float dot, float scale, float kinfo, int row, int key,
                                          int Lkv) {
  if (CAUSAL) return kinfo != 0.f && key <= row ? dot * scale : -INFINITY;
  return key < Lkv ? __fadd_rn(__fmul_rn(dot, scale), kinfo) : -INFINITY;
}

// The forward on tensor cores for one (64-row q tile, key split, chunk c,
// head, batch): blockIdx.x = q tile * splits + split, blockIdx.y = h * C +
// c; warp w owns rows 16 w .. 16 w + 15.  The q tile's C chunks stay in
// shared memory; each key tile of the split's range streams through the
// ring as C + 1 units, its K chunks 0 .. C - 1 (S summed over them in that
// order, so every chunk's block has the same S, m, l and P) and then V's
// chunk c.  OT float (B14, B14p): P enters P V as bf16 hi + lo and each
// tile's P V is folded into o with one fp32 fma; OT bf16 (B13, K1): P's hi,
// in place.  With one split the block writes o (and from chunk 0, m and l);
// with more it writes its split's unnormalised o, m and l to part
// (chunk_fwd_merge's layout) for chunk_fwd_merge.
template <typename OT, bool CAUSAL, bool PART>
__global__ void __launch_bounds__(TTHREADS)
chunk_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const float* __restrict__ bm, OT* __restrict__ o, float* __restrict__ m_out,
             float* __restrict__ l_out, float* __restrict__ part, Strides qs, Strides ks,
             Strides vs, Strides os, int Lq, int Lkv, int H, int group, int C, int cols,
             int S, int splits, float scale) {
  constexpr bool F32O = std::is_same<OT, float>::value;
  constexpr int NT = TK / 8;  // n-tiles of a score row
  extern __shared__ __align__(16) unsigned char chunk_tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(chunk_tc_smem);        // [C][BQ][LDC]
  bf16* ring = Qs + C * QCH;                                 // [S][TK][LDC]
  float* kin = reinterpret_cast<float*>(ring + S * UNIT);   // [S][TK]

  // longest rows first (causal: the last q tiles visit the most key tiles)
  const int n_qt = gridDim.x / splits;
  const int qt = CAUSAL ? n_qt - 1 - (int)blockIdx.x / splits : (int)blockIdx.x / splits;
  const int sp = blockIdx.x % splits;
  const int q0 = qt * BQ;
  const int h = blockIdx.y / C, c = blockIdx.y % C;
  const int b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;  // the warp's first row of the tile
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + (h / group) * ks.h;
  const bf16* vb = v + b * vs.b + (h / group) * vs.h + c * CW;
  const float* bmb = bm ? bm + (long long)b * Lkv : nullptr;
  // the split's key tiles [t0, t1) of the row's n_kv
  const int n_kv = CAUSAL ? (min(q0 + BQ, Lq) - 1) / TK + 1 : (Lkv + TK - 1) / TK;
  const int per = (n_kv + splits - 1) / splits;
  const int t0 = sp * per, t1 = min(t0 + per, n_kv);
  const int U = C + 1;  // units of a key tile
  const int n_units = t1 > t0 ? (t1 - t0) * U : 0;

  auto load_unit = [&](int u) {
    const int t = t0 + u / U, i = u % U;
    bf16* dst = ring + (u % S) * UNIT;
    if (i < C)
      copy_chunk(dst, kb + i * CW, ks.r, t * TK, TK, Lkv, tc_cols<PART>(cols, i), tid);
    else
      copy_chunk(dst, vb, vs.r, t * TK, TK, Lkv, tc_cols<PART>(cols, c), tid);
    if (i == 0) copy_key_info(kin + (u / U % S) * TK, bmb, t * TK, Lkv, q, tid);
  };
  // Q with unit 0, then units 1 .. S - 2, a commit group each
  for (int cc = 0; cc < C; ++cc)
    copy_chunk(Qs + cc * QCH, qb + cc * CW, qs.r, q0, BQ, Lq, tc_cols<PART>(cols, cc), tid);
  for (int u = 0; u < S - 1; ++u) {
    if (u < n_units) load_unit(u);
    cp_async_commit();
  }

  float oacc[CW / 8][4];
#pragma unroll
  for (int n = 0; n < CW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_run[2], l_run[2] = {0.f, 0.f};  // rows g and g + 8; l: this thread's columns' share
  m_run[0] = m_run[1] = CAUSAL ? -INFINITY : NEG_INF;
  float s[NT][4];

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait_upto(S - 2);  // unit u (and Q) has landed
    __syncthreads();            // ... for every thread, and unit u - 1's stage is free
    if (u + S - 1 < n_units) load_unit(u + S - 1);
    cp_async_commit();
    const int i = u % U;
    const int k0 = (t0 + u / U) * TK;
    const bf16* tile = ring + (u % S) * UNIT;
    // causal: a warp whose rows all lie before the tile's first key skips it
    if (CAUSAL && k0 > q0 + r0 + 15) continue;
    if (i == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
    if (i < C) {  // S += Q_i K_i^T
      chunk_scores(s, Qs + i * QCH, tile, r0, lane);
      continue;
    }
    // the online softmax of rows g (e < 2) and g + 8 (e >= 2); every row
    // has a live key in the block's first tile (cross: every key < Lkv;
    // causal, one split: key 0), so m is finite from there on
    const float* kt = kin + (u / U % S) * TK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        s[n][e] = tc_score<CAUSAL>(s[n][e], scale, kt[col], q0 + r0 + g + 8 * (e >> 1), k0 + col,
                                   Lkv);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = m_new == -INFINITY ? 1.f : __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == -INFINITY ? 0.f : __expf(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    if constexpr (!F32O) {
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
    }
    // O += P V_c: P (bf16; hi and lo with F32O) from the S fragments, V via
    // ldmatrix.trans, CC columns at a time (F32O's tile sums stay few
    // registers); with F32O each tile's P V is summed from zero and folded
    // into o by an fp32 fma (o alpha + tile)
    constexpr int CC = 32;
#pragma unroll
    for (int c0 = 0; c0 < CW; c0 += CC) {
      float tacc[F32O ? CC / 8 : 1][4];
      if constexpr (F32O) {
#pragma unroll
        for (int n = 0; n < CC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t a[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = s[2 * kk + (r >> 1)] + 2 * (r & 1);
          if constexpr (F32O)
            split_bf16(x[0], x[1], a[r], lo[r]);
          else
            a[r] = pack_bf16(x[0], x[1]);
        }
#pragma unroll
        for (int nd = 0; nd < CC / 16; ++nd) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                     LDC +
                                          c0 + nd * 16 + (lane >> 4) * 8));
          if constexpr (F32O) {
            mma_16816(tacc[2 * nd], a, bv[0], bv[1]);
            mma_16816(tacc[2 * nd + 1], a, bv[2], bv[3]);
            mma_16816(tacc[2 * nd], lo, bv[0], bv[1]);
            mma_16816(tacc[2 * nd + 1], lo, bv[2], bv[3]);
          } else {
            mma_16816(oacc[c0 / 8 + 2 * nd], a, bv[0], bv[1]);
            mma_16816(oacc[c0 / 8 + 2 * nd + 1], a, bv[2], bv[3]);
          }
        }
      }
      if constexpr (F32O) {
#pragma unroll
        for (int n = 0; n < CC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oacc[c0 / 8 + n][e] = fmaf(oacc[c0 / 8 + n][e], alpha[e >> 1], tacc[n][e]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int HDP = C * CW;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= Lq) continue;
    if (splits > 1) {  // the split's partial: o unnormalised, m and l
      float* prow = part + ((((long long)sp * B + b) * H + h) * Lq + row) * HDP + c * CW;
#pragma unroll
      for (int n = 0; n < CW / 8; ++n)
        *reinterpret_cast<float2*>(prow + n * 8 + 2 * t4) =
            make_float2(oacc[n][2 * r], oacc[n][2 * r + 1]);
      if (c == 0 && t4 == 0) {
        float* ml = part + (long long)splits * B * H * Lq * HDP;
        ml[(((long long)sp * 2 * B + b) * Lq + row) * H + h] = m_run[r];
        ml[((((long long)sp * 2 + 1) * B + b) * Lq + row) * H + h] = l_run[r];
      }
      continue;
    }
    OT* orow = o + b * os.b + h * os.h + c * CW + row * os.r;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    const float den = l_run[r] == 0.f ? 1.f : l_run[r];
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
      if (PART && c * CW + n * 8 >= cols) continue;
      const float x0 = CAUSAL ? oacc[n][2 * r] * inv : oacc[n][2 * r] / den;
      const float x1 = CAUSAL ? oacc[n][2 * r + 1] * inv : oacc[n][2 * r + 1] / den;
      if constexpr (F32O)
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * t4) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) = __floats2bfloat162_rn(x0, x1);
    }
    if (m_out != nullptr && c == 0 && t4 == 0) {
      const size_t ri = ((size_t)b * Lq + row) * H + h;
      m_out[ri] = m_run[r];
      l_out[ri] = l_run[r];
    }
  }
}

// The key splits of the chunked forward merged, one block per (row, head,
// batch): m = max_s m_s (cross: each split's m starts at -1e9, so every
// weight is finite; causal, the float32 cluster form: a split whose keys
// all follow the row keeps m = -inf, weight 0, and split 0 holds key 0), l
// = sum_s l_s exp(m_s - m), o = sum_s o_s exp(m_s - m), normalised as the
// family's kernels do (cross / (l == 0 ? 1 : l), causal * (l > 0 ? 1 / l :
// 0)), summed in split order.  part: o_s [splits][B][H][Lq][HDP], then m_s,
// l_s [splits][m, l][B][Lq][H]; o's first cols columns are written.
template <typename OT, bool CAUSAL = false>
__global__ void __launch_bounds__(256)
chunk_fwd_merge(const float* __restrict__ part, OT* __restrict__ o, float* __restrict__ m_out,
                float* __restrict__ l_out, Strides os, int splits, int H, int Lq, int HDP,
                int cols) {
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const float* ml = part + (long long)splits * B * H * Lq * HDP;
  auto at = [&](int sp, int which) {
    return ml[((((long long)sp * 2 + which) * B + b) * Lq + row) * H + h];
  };
  float m = NEG_INF;
  for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, at(sp, 0));
  float l = 0.f;
  for (int sp = 0; sp < splits; ++sp) l += at(sp, 1) * expf(at(sp, 0) - m);
  const float den = l == 0.f ? 1.f : l;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  OT* orow = o + b * os.b + h * os.h + row * os.r;
  for (int col = threadIdx.x; col < cols; col += 256) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      acc += part[((((long long)sp * B + b) * H + h) * Lq + row) * HDP + col] *
             expf(at(sp, 0) - m);
    put(orow + col, CAUSAL ? acc * inv : acc / den);
  }
  if (m_out != nullptr && threadIdx.x == 0) {
    const size_t ri = ((size_t)b * Lq + row) * H + h;
    m_out[ri] = m;
    l_out[ri] = l;
  }
}

// The backward on tensor cores over the key tiles of one (64-row q tile,
// chunk c, head, batch), blockIdx.y = h * C + c.  Q's and dO's C chunks stay
// in shared memory; each key tile streams through the ring as 2 C units, K
// and V of chunk 0, then of chunk 1, ...: S = sum Q_cc K_cc^T and dP = sum
// dO_cc V_cc^T on tensor cores, K_c copied aside for dq.  Then p = exp(s -
// m) / l and ds = p (dp - dsum) scale in fp32 registers, dq += ds K_c with
// ds rounded to bf16 in registers (dq in registers over the pass).  With DKV
// (cross: B14 / B14p, one pass) p and ds go to shared memory as bf16 and
// the four warps split this tile's dv_c = p^T dO_c and dk_c = ds^T Q_c by
// 16-key groups, written as they are (part null: one q tile) or as float32
// partials [n_qt][dk, dv][B][H][Lkv][C * CW] to part.  Without DKV it is
// B7b's dq kernel.
template <bool CAUSAL, bool DKV, bool PART>
__global__ void __launch_bounds__(TTHREADS)
chunk_bwd_rows_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bm,
                  const bf16* __restrict__ dout, const float* __restrict__ m_in,
                  const float* __restrict__ l_in, const float* __restrict__ dsum_in,
                  bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  float* __restrict__ part, BwdStrides st, int Lq, int Lkv, int H, int group,
                  int C, int cols, int S, float scale) {
  constexpr int NT = TK / 8;     // n-tiles of a score row
  constexpr int UNITS = TK / 8;  // (16 keys, dk or dv) products of a key tile
  extern __shared__ __align__(16) unsigned char chunk_tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(chunk_tc_smem);  // [C][BQ][LDC]
  bf16* dOs = Qs + C * QCH;                            // [C][BQ][LDC]
  bf16* Kc = dOs + C * QCH;                            // [TK][LDC]  the key tile's K chunk c
  bf16* Ps = Kc + UNIT;                                // [BQ][PLD]  p, bf16
  bf16* dSs = Ps + BQ * PLD;                           // [BQ][PLD]  ds, bf16
  bf16* ring = dSs + BQ * PLD;                         // [S][TK][LDC]
  float* kin = reinterpret_cast<float*>(ring + S * UNIT);  // [S][TK]

  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y / C, c = blockIdx.y % C;
  const int b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int kh = h / group;
  const bf16* qb = q + b * st.q.b + h * st.q.h;
  const bf16* dob = dout + b * st.dout.b + h * st.dout.h;
  const bf16* kb = k + b * st.k.b + kh * st.k.h;
  const bf16* vb = v + b * st.v.b + kh * st.v.h;
  const float* bmb = bm ? bm + (long long)b * Lkv : nullptr;
  const int n_kv = CAUSAL ? (min(q0 + BQ, Lq) - 1) / TK + 1 : (Lkv + TK - 1) / TK;
  const int U = 2 * C;  // units of a key tile
  const int n_units = n_kv * U;

  auto load_unit = [&](int u) {
    const int t = u / U, i = u % U;
    const bf16* src = ((i & 1) ? vb : kb) + (i >> 1) * CW;
    copy_chunk(ring + (u % S) * UNIT, src, (i & 1) ? st.v.r : st.k.r, t * TK, TK, Lkv,
               tc_cols<PART>(cols, i >> 1), tid);
    if (i == 0) copy_key_info(kin + (t % S) * TK, bmb, t * TK, Lkv, q, tid);
  };
  for (int cc = 0; cc < C; ++cc) {
    copy_chunk(Qs + cc * QCH, qb + cc * CW, st.q.r, q0, BQ, Lq, tc_cols<PART>(cols, cc), tid);
    copy_chunk(dOs + cc * QCH, dob + cc * CW, st.dout.r, q0, BQ, Lq, tc_cols<PART>(cols, cc),
               tid);
  }
  for (int u = 0; u < S - 1; ++u) {
    if (u < n_units) load_unit(u);
    cp_async_commit();
  }

  // rows g and g + 8 of the warp: m, l (0 guarded to 1), dsum
  float mr[2], lr[2], dsr[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    row_ok[r] = row < Lq;
    const size_t ri = ((size_t)b * Lq + (row_ok[r] ? row : 0)) * H + h;
    const float lv = row_ok[r] ? l_in[ri] : 1.f;
    mr[r] = row_ok[r] ? m_in[ri] : 0.f;
    lr[r] = lv == 0.f ? 1.f : lv;
    dsr[r] = row_ok[r] ? dsum_in[ri] : 0.f;
  }

  float dqacc[CW / 8][4];
#pragma unroll
  for (int n = 0; n < CW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[n][e] = 0.f;
  float s[NT][4], dp[NT][4];

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait_upto(S - 2);  // unit u (and Q, dO) has landed
    __syncthreads();            // ... for every thread; unit u - 1's stage is free
    if (u + S - 1 < n_units) load_unit(u + S - 1);
    cp_async_commit();
    const int t = u / U, i = u % U;
    const int k0 = t * TK;
    const bf16* tile = ring + (u % S) * UNIT;
    // causal: a warp whose rows all lie before the tile's first key skips it
    const bool active = !CAUSAL || k0 <= q0 + r0 + 15;
    if (i == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    if (i == 2 * c) {  // K_c aside for dq (and read after this tile's last unit)
      for (int e = tid; e < TK * (CW / 8); e += TTHREADS) {
        const int r = e / (CW / 8), ch = e % (CW / 8);
        *reinterpret_cast<uint4*>(Kc + r * LDC + ch * 8) =
            *reinterpret_cast<const uint4*>(tile + r * LDC + ch * 8);
      }
    }
    if (active) {
      if (i & 1)
        chunk_scores(dp, dOs + (i >> 1) * QCH, tile, r0, lane);  // dP += dO_cc V_cc^T
      else
        chunk_scores(s, Qs + (i >> 1) * QCH, tile, r0, lane);  // S += Q_cc K_cc^T
    }
    if (i != U - 1) continue;

    // p = exp(score - m) / l (0 for dead pairs and rows past Lq), ds = p (dp
    // - dsum) scale, kept in dp; with DKV both to shared memory as bf16
    const float* kt = kin + (t % S) * TK;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t4 + e;
          const float sc = tc_score<CAUSAL>(s[n][2 * r + e], scale, kt[col], q0 + r0 + g + 8 * r,
                                            k0 + col, Lkv);
          pe[e] = active && row_ok[r] && sc != -INFINITY ? __expf(sc - mr[r]) / lr[r] : 0.f;
          dp[n][2 * r + e] = pe[e] * (dp[n][2 * r + e] - dsr[r]) * scale;
        }
        if constexpr (DKV) {
          const int at = (r0 + g + 8 * r) * PLD + n * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(Ps + at) = pack_bf16(pe[0], pe[1]);
          *reinterpret_cast<uint32_t*>(dSs + at) = pack_bf16(dp[n][2 * r], dp[n][2 * r + 1]);
        }
      }
    // dq += ds K_c: ds (bf16) from the fragments, K_c via ldmatrix.trans
    if (active) {
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = dp[2 * kk + (r >> 1)] + 2 * (r & 1);
          a[r] = pack_bf16(x[0], x[1]);
        }
#pragma unroll
        for (int nd = 0; nd < CW / 16; ++nd) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, smem_addr(Kc + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDC +
                                          nd * 16 + (lane >> 4) * 8));
          mma_16816(dqacc[2 * nd], a, bk[0], bk[1]);
          mma_16816(dqacc[2 * nd + 1], a, bk[2], bk[3]);
        }
      }
    }
    if constexpr (DKV) {
      __syncthreads();  // p and ds of every row written
      // unit w: dv (w < UNITS / 2) or dk of keys kg .. kg + 15 of the tile,
      // over the q tile's 64 rows: p^T / ds^T and dO_c / Q_c via
      // ldmatrix.trans, 16 output columns at a time
      for (int w = warp; w < UNITS; w += TTHREADS / 32) {
        const bool is_dk = w >= UNITS / 2;
        const int kg = (w % (UNITS / 2)) * 16;
        const bf16* as = is_dk ? dSs : Ps;
        const bf16* bsrc = (is_dk ? Qs : dOs) + c * QCH;
        uint32_t a[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          ldmatrix_x4_trans(a[kk], smem_addr(as + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * PLD +
                                             kg + ((lane >> 3) & 1) * 8));
        const int key0 = k0 + kg + g;  // rows g and g + 8 of the product
#pragma unroll 2
        for (int nd = 0; nd < CW / 16; ++nd) {
          float acc[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, smem_addr(bsrc + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                       LDC +
                                            nd * 16 + (lane >> 4) * 8));
            mma_16816(acc[0], a[kk], bb[0], bb[1]);
            mma_16816(acc[1], a[kk], bb[2], bb[3]);
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int key = key0 + 8 * hf;
            if (key >= Lkv) continue;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int col = c * CW + nd * 16 + n * 8 + 2 * t4;
              if (PART && part == nullptr && col >= cols) continue;
              if (part != nullptr) {
                const long long at =
                    ((((long long)(qt * 2 + is_dk) * B + b) * H + h) * Lkv + key) * (C * CW) + col;
                *reinterpret_cast<float2*>(part + at) =
                    make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
              } else {
                bf16* out = is_dk ? dk + b * st.dk.b + h * st.dk.h + key * st.dk.r
                                  : dv + b * st.dv.b + h * st.dv.h + key * st.dv.r;
                *reinterpret_cast<__nv_bfloat162*>(out + col) =
                    __floats2bfloat162_rn(acc[n][2 * hf], acc[n][2 * hf + 1]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* dqb = dq + b * st.dq.b + h * st.dq.h + c * CW;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    bf16* drow = dqb + (q0 + r0 + g + 8 * r) * st.dq.r;
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
      if (!PART || c * CW + n * 8 < cols)
        *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(dqacc[n][2 * r], dqacc[n][2 * r + 1]);
  }
}

// dk and dv from chunk_bwd_rows' float32 partials, added in q-tile order
// (their first cols columns)
template <typename T>
__global__ void __launch_bounds__(256)
chunk_dkv_sum(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
              Strides dks, Strides dvs, int n_qt, int B, int H, int Lkv, int HDP, int cols) {
  const long long n = (long long)B * H * Lkv * HDP;  // elements of dk (and of dv)
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < 2 * n;
       i += (long long)gridDim.x * 256) {
    const bool is_dk = i >= n;
    const long long e = is_dk ? i - n : i;
    const int col = (int)(e % HDP);
    if (col >= cols) continue;
    const long long row = e / HDP;  // (b, h, key)
    const int key = (int)(row % Lkv);
    const int h = (int)((row / Lkv) % H);
    const int b = (int)(row / ((long long)Lkv * H));
    float sum = 0.f;
    for (int t = 0; t < n_qt; ++t) sum += part[((long long)t * 2 + is_dk) * n + e];
    T* out = is_dk ? dk + b * dks.b + h * dks.h + key * dks.r
                   : dv + b * dvs.b + h * dvs.h + key * dvs.r;
    put(out + col, sum);
  }
}

// B7b's dk / dv on tensor cores (chunk_bwd_keys_tc): 8 warps over one 32-key
// tile; 32-row q tiles, a ring stage holds one chunk of the tile's Q and dO
// ([TQ][LDC] each, the UNIT of the other kernels) and the tile's m, l and
// dsum; the key tile's C chunks of K and V, its mask, p^T / ds^T and the dP^T
// exchange stay resident
constexpr int KTHREADS = 256;
constexpr int TQ = TK;        // query rows of a q tile (= keys of a key tile)
constexpr int XLD = TQ + 8;   // padded float row of the dP^T exchange
constexpr int KEYS_MAX_C = 4;  // chunks of the tensor-core form (a score partial each)
constexpr size_t KSTAGE_BYTES = 2 * UNIT * sizeof(bf16) + 3 * TQ * sizeof(float);
inline size_t keys_fixed_bytes(int C) {
  return (size_t)(2 * C * UNIT + 2 * TK * PLD) * sizeof(bf16) +
         (size_t)(TK * XLD + TK) * sizeof(float);
}
// the ring's stages where K / V's C chunks fit: as many as fit, up to
// MAX_STAGES; 0 where fewer than 2 fit (the scalar form runs): C <= 4
inline int keys_stages(int C) {
  const size_t fixed = keys_fixed_bytes(C);
  const int fit = fixed >= SMEM_MAX ? 0 : (int)((SMEM_MAX - fixed) / KSTAGE_BYTES);
  return C > KEYS_MAX_C || fit < 2 ? 0 : (fit < MAX_STAGES ? fit : MAX_STAGES);
}

// B7b's dk / dv on tensor cores for one (32-key tile, chunk c, key head,
// batch), blockIdx.y = kh * C + c: dv_c = sum p^T dO_c and dk_c = sum ds^T
// Q_c over the group's query heads and, for each, the 32-row q tiles from
// the diagonal on, in that order (fp32 registers over the loop; no atomics,
// no partials: the same bits on every run).  The key tile's C chunks of K
// and V stay in shared memory; each q tile streams through the ring as C
// stages of Q_cc and dO_cc, chunks c + 1, .., C - 1, 0, .., c (chunk c last,
// so that its Q_c and dO_c are still in the ring for the products; its
// stage also brings the rows' m, l and dsum).  Each stage's S^T_cc = K_cc
// Q_cc^T (warps 0-3) or dP^T_cc = V_cc dO_cc^T (warps 4-7), a 16-key x
// 16-row block a warp, is a partial of its own; the partials are summed in
// chunk order 0 .. C - 1, so every chunk's block holds the same S^T and p
// bit for bit.  At the last stage warps 4-7 hand dP^T over through shared
// memory, warps 0-3 write p^T = exp(s - m) / l and ds^T = p (dp - dsum)
// scale as bf16, and warp w takes dv (w < 4) or dk of keys 16 (w & 1) ..
// and columns 128 ((w >> 1) & 1) .. of the chunk (p^T / ds^T by ldmatrix,
// dO_c / Q_c by ldmatrix.trans).  PART: the head dim (cols) ends inside the
// last chunk.
template <bool PART>
__global__ void __launch_bounds__(KTHREADS)
chunk_bwd_keys_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ mask,
                  const bf16* __restrict__ dout, const float* __restrict__ m_in,
                  const float* __restrict__ l_in, const float* __restrict__ dsum_in,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, BwdStrides st, int L, int H,
                  int group, int C, int cols, int S, float scale) {
  extern __shared__ __align__(16) unsigned char chunk_tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(chunk_tc_smem);  // [C][TK][LDC]
  bf16* Vs = Ks + C * UNIT;                            // [C][TK][LDC]
  bf16* Pt = Vs + C * UNIT;                            // [TK][PLD]  p^T, bf16
  bf16* dSt = Pt + TK * PLD;                           // [TK][PLD]  ds^T, bf16
  float* Xs = reinterpret_cast<float*>(dSt + TK * PLD);  // [TK][XLD]  dP^T
  float* kin = Xs + TK * XLD;                             // [TK]  the keys' mask
  unsigned char* ring = reinterpret_cast<unsigned char*>(kin + TK);  // [S][KSTAGE_BYTES]

  const int kt = blockIdx.x, k0 = kt * TK;
  const int kh = blockIdx.y / C, c = blockIdx.y % C;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool dp_warp = warp >= 4;           // scores: dP^T (4-7) or S^T (0-3); dk or dv
  const int kw = 16 * (warp & 1);           // the warp's keys of the tile
  const int rw = 16 * ((warp >> 1) & 1);    // scores: the warp's rows of the q tile
  const int cq = 128 * ((warp >> 1) & 1);   // dk / dv: the warp's columns of the chunk
  const bf16* kb = k + b * st.k.b + kh * st.k.h;
  const bf16* vb = v + b * st.v.b + kh * st.v.h;
  const float* mb = mask + (long long)b * L;
  const int nq = (L + TQ - 1) / TQ - kt;  // q tiles from the diagonal on
  const int n_units = group * nq * C;

  // unit u: q tile it = u / C (head kh * group + it / nq, rows (kt + it % nq)
  // * TQ ..), chunk (c + 1 + u % C) % C; the last of a tile (chunk c) with
  // the rows' m, l, dsum
  auto load_unit = [&](int u) {
    const int it = u / C, j = u % C;
    const int h = kh * group + it / nq, q0 = (kt + it % nq) * TQ;
    const int cc = (c + 1 + j) % C;
    bf16* slot = reinterpret_cast<bf16*>(ring + (u % S) * KSTAGE_BYTES);
    const int nc = tc_cols<PART>(cols, cc);
    copy_chunk<KTHREADS>(slot, q + b * st.q.b + h * st.q.h + cc * CW, st.q.r, q0, TQ, L, nc, tid);
    copy_chunk<KTHREADS>(slot + UNIT, dout + b * st.dout.b + h * st.dout.h + cc * CW, st.dout.r,
                         q0, TQ, L, nc, tid);
    if (j == C - 1 && tid < 3 * TQ) {
      const int which = tid / TQ, row = q0 + tid % TQ;
      const bool ok = row < L;  // rows past L: m = l = dsum = 0 (p = 0 below)
      const float* src = which == 0 ? m_in : which == 1 ? l_in : dsum_in;
      cp_async_4(smem_addr(reinterpret_cast<float*>(slot + 2 * UNIT) + tid),
                 src + ((size_t)b * L + (ok ? row : 0)) * H + h, ok);
    }
  };
  for (int cc = 0; cc < C; ++cc) {
    copy_chunk<KTHREADS>(Ks + cc * UNIT, kb + cc * CW, st.k.r, k0, TK, L,
                         tc_cols<PART>(cols, cc), tid);
    copy_chunk<KTHREADS>(Vs + cc * UNIT, vb + cc * CW, st.v.r, k0, TK, L,
                         tc_cols<PART>(cols, cc), tid);
  }
  copy_key_info(kin, mb, k0, L, q, tid);
  for (int u = 0; u < S - 1; ++u) {
    if (u < n_units) load_unit(u);
    cp_async_commit();
  }

  float acc[CW / 16][4];  // dv or dk: keys kw + g (+ 8), columns cq ..
#pragma unroll
  for (int n = 0; n < CW / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // S^T or dP^T partials by chunk: keys kw + g (+ 8), rows rw + 8 n + 2 t4 (+ 1)
  float part[KEYS_MAX_C][2][4];

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait_upto(S - 2);  // unit u (and K, V, the mask) has landed
    __syncthreads();            // ... for every thread; unit u - 1's stage is free
    if (u + S - 1 < n_units) load_unit(u + S - 1);
    cp_async_commit();
    const int j = u % C, cc = (c + 1 + j) % C;
    const int q0 = (kt + u / C % nq) * TQ;
    const bf16* slot = reinterpret_cast<const bf16*>(ring + (u % S) * KSTAGE_BYTES);
    // causal: a block of keys all after its rows (on the diagonal) is skipped
    const bool live = k0 + kw <= q0 + rw + 15;
#pragma unroll
    for (int x = 0; x < KEYS_MAX_C; ++x) {
      if (x != cc) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[x][n][e] = 0.f;
      if (live)  // S^T_cc = K_cc Q_cc^T, dP^T_cc = V_cc dO_cc^T
        chunk_scores(part[x], (dp_warp ? Vs : Ks) + x * UNIT,
                     slot + (dp_warp ? UNIT : 0) + rw * LDC, kw, lane);
    }
    if (j != C - 1) continue;

    // the q tile's last stage (chunk c): the partials in chunk order
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = part[0][n][e];
#pragma unroll
        for (int x = 1; x < KEYS_MAX_C; ++x)
          if (x < C) sc[n][e] += part[x][n][e];
      }
    if (dp_warp) {  // dP^T to the exchange
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(Xs + (kw + g + 8 * hf) * XLD + rw + n * 8 + 2 * t4) =
              make_float2(sc[n][2 * hf], sc[n][2 * hf + 1]);
    }
    __syncthreads();  // dP^T in the exchange
    if (!dp_warp) {  // p^T and ds^T
      const float* ms = reinterpret_cast<const float*>(slot + 2 * UNIT);
      const float* ls = ms + TQ;
      const float* dsums = ls + TQ;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = kw + g + 8 * hf;
          const float2 dpv =
              *reinterpret_cast<const float2*>(Xs + key * XLD + rw + n * 8 + 2 * t4);
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = rw + n * 8 + 2 * t4 + e;
            const int row = q0 + r;
            const float lv = ls[r];
            const float s =
                tc_score<true>(sc[n][2 * hf + e], scale, kin[key], row, k0 + key, L);
            p[e] = row < L && s != -INFINITY ? __expf(s - ms[r]) / (lv == 0.f ? 1.f : lv) : 0.f;
            ds[e] = p[e] * ((e ? dpv.y : dpv.x) - dsums[r]) * scale;
          }
          const int at = key * PLD + rw + n * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(Pt + at) = pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(dSt + at) = pack_bf16(ds[0], ds[1]);
        }
    }
    __syncthreads();  // p^T and ds^T written
    const bf16* as = dp_warp ? dSt : Pt;
    const bf16* bsrc = slot + (dp_warp ? 0 : UNIT);  // Q_c (dk) or dO_c (dv)
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_addr(as + (kw + (lane & 15)) * PLD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, smem_addr(bsrc + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                   LDC +
                                        cq + nd * 16 + (lane >> 4) * 8));
        mma_16816(acc[2 * nd], a, bb[0], bb[1]);
        mma_16816(acc[2 * nd + 1], a, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();

  bf16* out = dp_warp ? dk + b * st.dk.b + kh * st.dk.h : dv + b * st.dv.b + kh * st.dv.h;
  const long long rs = dp_warp ? st.dk.r : st.dv.r;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + kw + g + 8 * hf;
    if (key >= L) continue;
    bf16* orow = out + key * rs + c * CW + cq;
#pragma unroll
    for (int n = 0; n < CW / 16; ++n)
      if (!PART || c * CW + cq + n * 8 < cols)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[n][2 * hf], acc[n][2 * hf + 1]);
  }
}

// -------------------------------------------------- 3xTF32 tile products --
// The float32 tile products on tensor cores, shared by the cluster kernels
// (flash_chunked_cluster.cuh: chunk_fwd_cl32, chunk_bwd_rows_cl32) and the
// kernels at head dims up to 256 (flash_tf32.cu).  Tiles are float32 rows of
// LD floats in shared memory, each operand split into tf32 big + small as it
// is read (ptx_helpers.cuh: split_tf32, mma_3xtf32).  The tensor cores do not
// round their sums to nearest, so each product sums runs of RUN mma steps (k
// = 8 each) from zero and adds each run to its accumulator by an fp32 add;
// the callers choose RUN (the cluster kernels 4, flash_tf32.cu 2: see their
// headers), OU and IU the unroll counts of the loops over runs and over a
// run's steps (full unless given).

// rows [r0, r0 + n) of a tile W floats wide (src at its first column, row
// stride rs; rows past L zero-filled, with COLS also the columns from ncol
// on) -> smem [n][LD] by 16-byte cp.async over NTHR threads.  Without COLS
// neither the column test nor the pointer select: with them the 3xTF32
// forward at hd 64 took 3% longer (scripts/probe_flash_tf32.py,
// copy_rows_cols)
template <int LD, int W, int NTHR, bool COLS = false>
__device__ __forceinline__ void copy_rows32(float* dst, const float* src, long long rs, int r0,
                                            int n, int L, int tid, int ncol = W) {
  constexpr int CH = W / 4;  // 16-byte pieces of a row
  for (int e = tid; e < n * CH; e += NTHR) {
    const int r = e / CH, ch = e % CH;
    const int row = r0 + r;
    const bool ok = row < L && (!COLS || ch * 4 < ncol);
    cp_async_16(smem_addr(dst + r * LD + ch * 4),
                COLS ? (ok ? src + (long long)row * rs + ch * 4 : src)
                     : src + (long long)(ok ? row : 0) * rs + ch * 4,
                ok);
  }
}

// s (16 rows of the warp x 8 NT columns) += A (rows r0..) . B^T (the first
// 8 NT rows of Bt) over K columns, in 3xTF32
template <int LD, int K, int NT, int RUN, int OU = K / (8 * RUN), int IU = RUN>
__device__ __forceinline__ void scores32(float (&s)[NT][4], const float* A, const float* Bt,
                                         int r0, int lane) {
  static_assert(K % (8 * RUN) == 0, "whole runs");
  const float* ar = A + (r0 + (lane >> 2)) * LD + (lane & 3);
  const float* br = Bt + (lane >> 2) * LD + (lane & 3);
#pragma unroll (OU)
  for (int k0 = 0; k0 < K; k0 += 8 * RUN) {
    float t[NT][4] = {};
#pragma unroll (IU)
    for (int kk = k0; kk < k0 + 8 * RUN; kk += 8) {
      uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
      split_tf32(ar[kk], ab[0], as[0]);
      split_tf32(ar[8 * LD + kk], ab[1], as[1]);
      split_tf32(ar[kk + 4], ab[2], as[2]);
      split_tf32(ar[8 * LD + kk + 4], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        split_tf32(br[n * 8 * LD + kk], bb[n][0], bs[n][0]);
        split_tf32(br[n * 8 * LD + kk + 4], bb[n][1], bs[n][1]);
      }
      mma_3xtf32<NT>(t, ab, as, bb, bs);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += t[n][e];
  }
}

// acc (16 rows x 8 ND columns) += P (the C fragments of NT n-tiles: 8 NT
// keys) . B (rows: those keys, from B's first row and the output's first
// column), in 3xTF32, each 8-key step's k index permuted: A slot t holds key
// 2t and slot t + 4 key 2t + 1, as the C fragment has them; B's rows read to
// match.  Groups of G n-tiles of the output side by side, each group's runs
// of up to RUN steps summed from zero, then added to acc
template <int LD, int NT, int ND, int RUN>
__device__ __forceinline__ void frag_product32(float (&acc)[ND][4], const float (&p)[NT][4],
                                               const float* B, int lane) {
  constexpr int G = ND % 4 == 0 ? 4 : 2;
  static_assert(ND % G == 0, "whole groups of n-tiles");
  const float* br = B + 2 * (lane & 3) * LD + (lane >> 2);
  uint32_t ab[NT][4], as[NT][4];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    split_tf32(p[kk][0], ab[kk][0], as[kk][0]);  // (g, key 2t)
    split_tf32(p[kk][2], ab[kk][1], as[kk][1]);  // (g + 8, key 2t)
    split_tf32(p[kk][1], ab[kk][2], as[kk][2]);  // (g, key 2t + 1)
    split_tf32(p[kk][3], ab[kk][3], as[kk][3]);  // (g + 8, key 2t + 1)
  }
#pragma unroll
  for (int nd = 0; nd < ND; nd += G) {
#pragma unroll
    for (int k0 = 0; k0 < NT; k0 += RUN) {
      float t[G][4] = {};
#pragma unroll
      for (int kk = k0; kk < k0 + RUN && kk < NT; ++kk) {
        const float* bk = br + kk * 8 * LD + nd * 8;
        uint32_t bb[G][2], bs[G][2];
#pragma unroll
        for (int n = 0; n < G; ++n) {
          split_tf32(bk[n * 8], bb[n][0], bs[n][0]);
          split_tf32(bk[LD + n * 8], bb[n][1], bs[n][1]);
        }
        mma_3xtf32<G>(t, ab[kk], as[kk], bb, bs);
      }
#pragma unroll
      for (int n = 0; n < G; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd + n][e] += t[n][e];
    }
  }
}

// acc (16 keys x 8 G columns) += X^T (X [rows][PL] floats: p or ds, keys
// from column kc) . B ([rows][LD]: dO or Q, from the output's first column)
// over rows [0, R): A's k index (the row) permuted as in frag_product32, so
// both operands read rows 2t and 2t + 1
template <int LD, int PL, int R, int G, int RUN, int IU = RUN>
__device__ __forceinline__ void key_product32(float (&acc)[G][4], const float* X, int kc,
                                              const float* B, int lane) {
  static_assert(R % (8 * RUN) == 0, "whole runs");
  const float* ar = X + 2 * (lane & 3) * PL + kc + (lane >> 2);
  const float* br = B + 2 * (lane & 3) * LD + (lane >> 2);
#pragma unroll
  for (int r0 = 0; r0 < R; r0 += 8 * RUN) {
    float t[G][4] = {};
#pragma unroll (IU)
    for (int kk = r0; kk < r0 + 8 * RUN; kk += 8) {
      uint32_t ab[4], as[4], bb[G][2], bs[G][2];
      split_tf32(ar[kk * PL], ab[0], as[0]);            // (key g, row 2t)
      split_tf32(ar[kk * PL + 8], ab[1], as[1]);        // (key g + 8, row 2t)
      split_tf32(ar[(kk + 1) * PL], ab[2], as[2]);      // (key g, row 2t + 1)
      split_tf32(ar[(kk + 1) * PL + 8], ab[3], as[3]);  // (key g + 8, row 2t + 1)
#pragma unroll
      for (int n = 0; n < G; ++n) {
        split_tf32(br[kk * LD + n * 8], bb[n][0], bs[n][0]);
        split_tf32(br[(kk + 1) * LD + n * 8], bb[n][1], bs[n][1]);
      }
      mma_3xtf32<G>(t, ab, as, bb, bs);
    }
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];
  }
}

// part (NT n-tiles of this thread's partial scores, from n-tile n0 of the key
// tile) -> its slots of the exchange X ([n-tile][row group][lane] float4s)
template <int NT>
__device__ __forceinline__ void put_x(float* X, const float (&part)[NT][4], int n0, int rg,
                                      int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    *reinterpret_cast<float4*>(X + (((n0 + n) * (BQ / 16) + rg) * 32 + lane) * 4) =
        make_float4(part[n][0], part[n][1], part[n][2], part[n][3]);
}

// s = all NT n-tiles of the exchange at this thread's slots
template <int NT>
__device__ __forceinline__ void get_x(float (&s)[NT][4], const float* X, int rg, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float4 x = *reinterpret_cast<const float4*>(X + ((n * (BQ / 16) + rg) * 32 + lane) * 4);
    s[n][0] = x.x; s[n][1] = x.y; s[n][2] = x.z; s[n][3] = x.w;
  }
}

}  // namespace chunked

#include "flash_chunked_cluster.cuh"

namespace chunked {

// ----------------------------------------------------------------- launch --

// The chunked form takes every head dim above CW as C = ceil(head_dim / CW)
// chunks, the last one's columns past head_dim zero-filled as they are
// loaded and never stored, so a head dim whose rows are whole 16-byte pieces
// (a multiple of 8 in bf16, of 4 in float32) runs as it is; the wrappers
// zero-pad any other to C * CW (ops/attention.padded_launch).
inline bool is_chunked(int head_dim) { return head_dim > CW; }
inline int chunks(int head_dim) { return (head_dim + CW - 1) / CW; }
template <typename T>
inline bool whole_pieces(int head_dim) { return head_dim % (16 / (int)sizeof(T)) == 0; }

// The form a chunked launch takes, chosen by shape before any launch: bf16
// on the tensor-core kernel where its shared memory holds C chunks (the
// forward C <= 5, the backward over rows C <= 2, over keys C <= 4); above
// those the cluster kernel (flash_chunked_cluster.cuh) up to CL_MAX chunks
// in the forward and over rows (the forward 6 <= C <= 8, over rows 3 <= C
// <= 8); float32 on the 3xTF32 cluster kernel (flash_chunked_cluster.cuh)
// at every C up to CL_MAX in the forward and over rows; the scalar kernel
// otherwise (above 8 chunks, and over keys: bf16 above 4 chunks, float32
// always).  A launch of the form chosen that fails still fails: nothing is
// retried.
enum Kind { FWD = 0, ROWS = 1, KEYS = 2 };
enum Form { SCALAR = 1, TENSOR_CORES = 2, CLUSTER = 3, CLUSTER_TF32 = 4 };
inline Form form(Kind kind, int C, bool bf) {
  if (!bf) return kind != KEYS && C <= CL_MAX ? CLUSTER_TF32 : SCALAR;
  const int S = kind == KEYS ? keys_stages(C) : tc_stages(C, kind == ROWS);
  if (S > 0) return TENSOR_CORES;
  return kind != KEYS && C <= CL_MAX ? CLUSTER : SCALAR;
}

template <typename OT, bool CAUSAL, bool PART>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, const float* bm, void* o,
                          float* m, float* l, float* part, Strides qs, Strides ks, Strides vs,
                          Strides os, int B, int H, int group, int Lq, int Lkv, int C, int cols,
                          int S, int splits, float scale, cudaStream_t stream) {
  const size_t smem = tc_fixed_bytes(C, false) + S * STAGE_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      chunk_fwd_tc<OT, CAUSAL, PART>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Lq + BQ - 1) / BQ;
  chunk_fwd_tc<OT, CAUSAL, PART><<<dim3(n_qt * splits, H * C, B), TTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bm,
      static_cast<OT*>(o), m, l, part, qs, ks, vs, os, Lq, Lkv, H, group, C, cols, S, splits,
      scale);
  return cudaGetLastError();
}

template <bool CAUSAL, bool DKV, bool PART>
cudaError_t launch_rows_tc(const void* q, const void* k, const void* v, const float* bm,
                           const void* dout, const float* m, const float* l, const float* dsum,
                           void* dq, void* dk, void* dv, float* part, const BwdStrides& st,
                           int B, int H, int group, int Lq, int Lkv, int C, int cols,
                           float scale, cudaStream_t stream) {
  const int S = tc_stages(C, true);
  const size_t smem = tc_fixed_bytes(C, true) + S * STAGE_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      chunk_bwd_rows_tc<CAUSAL, DKV, PART>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Lq + BQ - 1) / BQ;
  chunk_bwd_rows_tc<CAUSAL, DKV, PART><<<dim3(n_qt, H * C, B), TTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bm,
      static_cast<const bf16*>(dout), m, l, dsum, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, st, Lq, Lkv, H, group, C, cols, S, scale);
  return cudaGetLastError();
}

// the forward.  Cross on tensor cores or in a cluster (bf16 and float32),
// and causal in the float32 cluster form: splits key splits (part: float32
// scratch of splits * B * H * Lq * (C * CW + 2) elements when splits > 1,
// null otherwise), merged by a second launch; bf16 causal and the scalar
// form take splits == 1.
template <typename T, typename OT, bool CAUSAL>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bm, void* o,
                       float* m, float* l, float* part, Strides qs, Strides ks, Strides vs,
                       Strides os, int B, int H, int group, int Lq, int Lkv, int head_dim,
                       int splits, float scale, cudaStream_t stream) {
  const int C = chunks(head_dim);
  const int n_qt = (Lq + BQ - 1) / BQ;
  if ((long long)H * C > 65535 || splits < 1 || (splits > 1) != (part != nullptr) ||
      (CAUSAL && splits > 1 && form(FWD, C, std::is_same<T, bf16>::value) != CLUSTER_TF32) ||
      (long long)n_qt * splits > 2147483647ll || !whole_pieces<T>(head_dim))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const Form f = form(FWD, C, true);
    if (f == TENSOR_CORES) {
      const int S = tc_stages(C, false);
      err = head_dim < C * CW
                ? launch_fwd_tc<OT, CAUSAL, true>(q, k, v, bm, o, m, l, part, qs, ks, vs, os, B,
                                                  H, group, Lq, Lkv, C, head_dim, S, splits,
                                                  scale, stream)
                : launch_fwd_tc<OT, CAUSAL, false>(q, k, v, bm, o, m, l, part, qs, ks, vs, os, B,
                                                   H, group, Lq, Lkv, C, head_dim, S, splits,
                                                   scale, stream);
    } else if (f == CLUSTER) {
      err = head_dim < C * CW
                ? launch_fwd_cl<OT, CAUSAL, true>(q, k, v, bm, o, m, l, part, qs, ks, vs, os, B,
                                                  H, group, Lq, Lkv, C, head_dim, splits, scale,
                                                  stream)
                : launch_fwd_cl<OT, CAUSAL, false>(q, k, v, bm, o, m, l, part, qs, ks, vs, os, B,
                                                   H, group, Lq, Lkv, C, head_dim, splits, scale,
                                                   stream);
    }
    if (f != SCALAR) {
      if (CAUSAL || err != cudaSuccess || splits == 1) return err;
      chunk_fwd_merge<OT><<<dim3(Lq, H, B), 256, 0, stream>>>(
          part, static_cast<OT*>(o), m, l, os, splits, H, Lq, C * CW, head_dim);
      return cudaGetLastError();
    }
  } else if (form(FWD, C, false) == CLUSTER_TF32) {
    static_assert(std::is_same<OT, float>::value, "float32 writes a float32 o");
    err = head_dim < C * CW
              ? launch_fwd_cl32<CAUSAL, true>(q, k, v, bm, o, m, l, part, qs, ks, vs, os, B, H,
                                              group, Lq, Lkv, C, head_dim, splits, scale, stream)
              : launch_fwd_cl32<CAUSAL, false>(q, k, v, bm, o, m, l, part, qs, ks, vs, os, B, H,
                                               group, Lq, Lkv, C, head_dim, splits, scale,
                                               stream);
    if (err != cudaSuccess || splits == 1) return err;
    chunk_fwd_merge<float, CAUSAL><<<dim3(Lq, H, B), 256, 0, stream>>>(
        part, static_cast<float*>(o), m, l, os, splits, H, Lq, C * CW, head_dim);
    return cudaGetLastError();
  }
  if (splits != 1) return cudaErrorInvalidValue;  // the scalar form takes no key splits
  err = cudaFuncSetAttribute(chunk_fwd<T, OT, CAUSAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_BYTES);
  if (err != cudaSuccess) return err;
  chunk_fwd<T, OT, CAUSAL><<<dim3(n_qt, H * C, B), THREADS, FWD_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bm,
      static_cast<OT*>(o), m, l, qs, ks, vs, os, Lq, Lkv, H, group, C, head_dim, scale);
  return cudaGetLastError();
}

// the backward over key tiles: B7b's dq (CAUSAL, no dk / dv) or B14 / B14p's
// one pass (cross: part is float32 scratch of 2 * ceil(Lq / BQ) * B * H *
// Lkv * C * CW elements when Lq > BQ, null otherwise).  The float32 form in
// a cluster takes splits key splits (dqpart: float32 scratch of splits * B
// * H * Lq * C * CW elements when splits > 1, null otherwise), their dq
// summed by a second launch; the others take splits == 1.
template <typename T, bool CAUSAL>
cudaError_t launch_bwd_rows(const void* q, const void* k, const void* v, const float* bm,
                            const void* dout, const float* m, const float* l,
                            const float* dsum, void* dq, void* dk, void* dv, float* part,
                            float* dqpart, const BwdStrides& st, int B, int H, int group, int Lq,
                            int Lkv, int head_dim, int splits, float scale,
                            cudaStream_t stream) {
  constexpr bool DKV = !CAUSAL;
  const int C = chunks(head_dim);
  const int n_qt = (Lq + BQ - 1) / BQ;
  if ((long long)H * C > 65535 || (DKV && (n_qt > 1) != (part != nullptr)) ||
      !whole_pieces<T>(head_dim) || splits < 1 || (splits > 1) != (dqpart != nullptr) ||
      (splits > 1 && form(ROWS, C, std::is_same<T, bf16>::value) != CLUSTER_TF32))
    return cudaErrorInvalidValue;
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  cudaError_t err;
  Form f = SCALAR;
  if constexpr (std::is_same<T, bf16>::value) {
    f = form(ROWS, C, true);
    if (f == TENSOR_CORES)
      err = head_dim < C * CW
                ? launch_rows_tc<CAUSAL, DKV, true>(q, k, v, bm, dout, m, l, dsum, dq, dk, dv,
                                                    part, st, B, H, group, Lq, Lkv, C, head_dim,
                                                    scale, stream)
                : launch_rows_tc<CAUSAL, DKV, false>(q, k, v, bm, dout, m, l, dsum, dq, dk, dv,
                                                     part, st, B, H, group, Lq, Lkv, C,
                                                     head_dim, scale, stream);
    else if (f == CLUSTER)
      err = head_dim < C * CW
                ? launch_rows_cl<CAUSAL, DKV, true>(q, k, v, bm, dout, m, l, dsum, dq, dk, dv,
                                                    part, st, B, H, group, Lq, Lkv, C, head_dim,
                                                    scale, stream)
                : launch_rows_cl<CAUSAL, DKV, false>(q, k, v, bm, dout, m, l, dsum, dq, dk, dv,
                                                     part, st, B, H, group, Lq, Lkv, C,
                                                     head_dim, scale, stream);
    if (f != SCALAR && err != cudaSuccess) return err;
  } else {
    f = form(ROWS, C, false);
    if (f == CLUSTER_TF32)
      err = head_dim < C * CW
                ? launch_rows_cl32<CAUSAL, DKV, true>(q, k, v, bm, dout, m, l, dsum, dq, dk, dv,
                                                      part, dqpart, st, B, H, group, Lq, Lkv, C,
                                                      head_dim, splits, scale, stream)
                : launch_rows_cl32<CAUSAL, DKV, false>(q, k, v, bm, dout, m, l, dsum, dq, dk, dv,
                                                       part, dqpart, st, B, H, group, Lq, Lkv, C,
                                                       head_dim, splits, scale, stream);
    if (f != SCALAR && err != cudaSuccess) return err;
    if (dqpart != nullptr) {
      const long long n = (long long)B * H * Lq * C * CW;
      const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
      chunk_dq_sum<T><<<blocks, 256, 0, stream>>>(dqpart, static_cast<T*>(dq), st.dq, splits, B,
                                                   H, Lq, C * CW, head_dim);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  if (f == SCALAR) {
    err = cudaFuncSetAttribute(chunk_bwd_rows<T, CAUSAL, DKV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_BYTES);
    if (err != cudaSuccess) return err;
    chunk_bwd_rows<T, CAUSAL, DKV><<<dim3(n_qt, H * C, B), THREADS, BWD_BYTES, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bm,
        static_cast<const T*>(dout), m, l, dsum, static_cast<T*>(dq), dkt, dvt, part, st, Lq,
        Lkv, H, group, C, head_dim, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const long long n = 2ll * B * H * Lkv * C * CW;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  chunk_dkv_sum<T><<<blocks, 256, 0, stream>>>(part, dkt, dvt, st.dk, st.dv, n_qt, B, H, Lkv,
                                                C * CW, head_dim);
  return cudaGetLastError();
}

template <bool PART>
cudaError_t launch_keys_tc(const void* q, const void* k, const void* v, const float* mask,
                           const void* dout, const float* m, const float* l, const float* dsum,
                           void* dk, void* dv, const BwdStrides& st, int B, int H, int group,
                           int L, int C, int cols, int S, float scale, cudaStream_t stream) {
  const size_t smem = keys_fixed_bytes(C) + S * KSTAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(chunk_bwd_keys_tc<PART>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chunk_bwd_keys_tc<PART><<<dim3((L + TK - 1) / TK, (H / group) * C, B), KTHREADS, smem,
                            stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
      static_cast<const bf16*>(dout), m, l, dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      st, L, H, group, C, cols, S, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_keys(const void* q, const void* k, const void* v, const float* mask,
                            const void* dout, const float* m, const float* l,
                            const float* dsum, void* dk, void* dv, const BwdStrides& st, int B,
                            int H, int group, int L, int head_dim, float scale,
                            cudaStream_t stream) {
  const int C = chunks(head_dim);
  if ((long long)(H / group) * C > 65535 || !whole_pieces<T>(head_dim))
    return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value) {
    if (form(KEYS, C, true) == TENSOR_CORES) {
      const int S = keys_stages(C);
      return head_dim < C * CW
                 ? launch_keys_tc<true>(q, k, v, mask, dout, m, l, dsum, dk, dv, st, B, H, group,
                                        L, C, head_dim, S, scale, stream)
                 : launch_keys_tc<false>(q, k, v, mask, dout, m, l, dsum, dk, dv, st, B, H,
                                         group, L, C, head_dim, S, scale, stream);
    }
  }
  cudaError_t err = cudaFuncSetAttribute(chunk_bwd_keys<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BWD_BYTES);
  if (err != cudaSuccess) return err;
  chunk_bwd_keys<T><<<dim3((L + BK - 1) / BK, (H / group) * C, B), THREADS, BWD_BYTES,
                      stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(dout), m, l, dsum, static_cast<T*>(dk), static_cast<T*>(dv), st, L,
      H, group, C, head_dim, scale);
  return cudaGetLastError();
}

// the merged-head layout of K1 / B7b ([B, L, heads * head_dim]) as strides
inline Strides merged(int L, int heads, int head_dim) {
  return Strides{(long long)L * heads * head_dim, head_dim, (long long)heads * head_dim};
}

}  // namespace chunked
