// Head dimensions above 256 in the flash kernels K1, B7b, B13, B14 and B14p:
// the head-dim-chunked form.
//
// The JAX kernels take any head dim (unirec_tpu/ops/flash_causal_vjp.py pads
// lanes; ops/flash_vjp.py and ops/attention.py hold the whole head in a VMEM
// block).  Hopper's shared memory does not hold a whole head above 256 next
// to the tiles of the designs at <= 256 (the bf16 cross forward takes
// 135,552 bytes at 256 already), so above 256 the head dim is cut into C =
// ceil(hd / 256) chunks of 256 columns (the wrappers zero-pad it to C * 256,
// ops/attention.padded_launch) and a grid axis runs over the chunks: one
// block owns one chunk of the output columns, and one call stays one launch.
// The designs at <= 256 are not touched; their instances give the same bits.
//
//   - A block forms each score tile q . k^T by summing over all C chunks of
//     q and k, staged through shared memory one chunk at a time, in chunk
//     order 0 .. C - 1 (every chunk's block computes the same scores, bit for
//     bit, so m and l are those of every chunk's softmax).  The backward's
//     dP = dO . v^T sums over the chunks of dO and v in the same way.
//   - The output accumulators are those of one chunk: o (or dq) for the
//     block's 64 rows, dk / dv for its 32 keys, 256 columns each.
//   - m and l (B14 / B14p / K1 training) are equal across chunks: only the
//     chunk-0 block writes them.  dsum comes from the caller (the float32 o
//     of B14 / B14p, ROADMAP.md numerics).
//   - Backward: B7b keeps its two kernels (dq over the key tiles of a q
//     tile, dk / dv over the q tiles of a key tile and its GQA group); B14
//     and B14p keep one pass over the keys: a block writes its chunk of dq,
//     and its chunk of each key tile's dk / dv (float32 partials per 64-row
//     q tile when Lq > 64, summed in q-tile order by a second kernel).
//   - Arithmetic is scalar fp32 FMA for both input types (bf16 inputs are
//     widened when staged): a simple form that is right first.  The scores
//     are computed C times (once per chunk's block), and q and k are staged
//     once per (key tile, chunk) pair: that is this form's cost, written
//     down in PERF.md.
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

// rows [r0, r0 + n) of one chunk (src at the chunk's first column, row
// stride rs) -> smem [n][RS] floats, rows past L as zero; 16-byte loads
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs, int r0, int n,
                                      int L, int tid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = CW / V;
  for (int e = tid; e < n * VPR; e += THREADS) {
    const int r = e / VPR, d = (e % VPR) * V;
    const int row = r0 + r;
    float* out = dst + r * RS + d;
    if (row < L) {
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
          int Lkv, int H, int group, int C, float scale) {
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
      stage(Qs, qb + cc * CW, qs.r, q0, BQ, Lq, tid);
      stage(Ks, kb + cc * CW, ks.r, k0, BK, Lkv, tid);
      if (cc == 0) {
        stage(Vs, vb, vs.r, k0, BK, Lkv, tid);
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
      put(ob + row * os.r + tx + 16 * j, CAUSAL ? acc[i][j] * inv_or_den : acc[i][j] / inv_or_den);
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
               int H, int group, int C, float scale) {
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
      stage(Qs, qb + cc * CW, st.q.r, q0, BQ, Lq, tid);
      stage(dOs, dob + cc * CW, st.dout.r, q0, BQ, Lq, tid);
      stage(Ks, kb + cc * CW, st.k.r, k0, BK, Lkv, tid);
      stage(Vs, vb + cc * CW, st.v.r, k0, BK, Lkv, tid);
      if (cc == 0) stage_keys<CAUSAL>(bs, oks, bmb, k0, Lkv, tid);
      __syncthreads();
      accumulate<true>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
    }
    p_and_ds<CAUSAL>(s, dp, Ps, dSs, ms, ls, dsums, bs, oks, q0, k0, Lq, scale, ty, tx);
    if (c != C - 1) {  // the block's own chunk of K (and Q, dO) back in place
      __syncthreads();
      stage(Ks, kb + c * CW, st.k.r, k0, BK, Lkv, tid);
      if (DKV) {
        stage(Qs, qb + c * CW, st.q.r, q0, BQ, Lq, tid);
        stage(dOs, dob + c * CW, st.dout.r, q0, BQ, Lq, tid);
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
            } else if (is_dk) {
              put(dk + b * st.dk.b + h * st.dk.h + key * st.dk.r + col, kacc[i][j]);
            } else {
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
    for (int j = 0; j < CJ; ++j) put(dqb + row * st.dq.r + tx + 16 * j, acc[i][j]);
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
               BwdStrides st, int L, int H, int group, int C, float scale) {
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
        stage(Qs, qb + cc * CW, st.q.r, q0, BQ, L, tid);
        stage(dOs, dob + cc * CW, st.dout.r, q0, BQ, L, tid);
        stage(Ks, kb + cc * CW, st.k.r, k0, BK, L, tid);
        stage(Vs, vb + cc * CW, st.v.r, k0, BK, L, tid);
        if (cc == 0) stage_rows(ms, ls, dsums, m_in, l_in, dsum_in, b, h, H, q0, L, tid);
        __syncthreads();
        accumulate<true>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
      }
      p_and_ds<true>(s, dp, Ps, dSs, ms, ls, dsums, bs, oks, q0, k0, L, scale, ty, tx);
      if (c != C - 1) {  // the block's own chunk of Q and dO back in place
        __syncthreads();
        stage(Qs, qb + c * CW, st.q.r, q0, BQ, L, tid);
        stage(dOs, dob + c * CW, st.dout.r, q0, BQ, L, tid);
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
      put(dk + b * st.dk.b + kh * st.dk.h + key * st.dk.r + col, acc_k[i][j]);
      put(dv + b * st.dv.b + kh * st.dv.h + key * st.dv.r + col, acc_v[i][j]);
    }
  }
}

// dk and dv from chunk_bwd_rows' float32 partials, added in q-tile order
template <typename T>
__global__ void __launch_bounds__(256)
chunk_dkv_sum(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
              Strides dks, Strides dvs, int n_qt, int B, int H, int Lkv, int HDP) {
  const long long n = (long long)B * H * Lkv * HDP;  // elements of dk (and of dv)
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < 2 * n;
       i += (long long)gridDim.x * 256) {
    const bool is_dk = i >= n;
    const long long e = is_dk ? i - n : i;
    const int col = (int)(e % HDP);
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

// ----------------------------------------------------------------- launch --

// head_dim: C * CW for C >= 2 (the wrappers pad to it)
inline bool is_chunked(int head_dim) { return head_dim > CW && head_dim % CW == 0; }

template <typename T, typename OT, bool CAUSAL>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bm, void* o,
                       float* m, float* l, Strides qs, Strides ks, Strides vs, Strides os,
                       int B, int H, int group, int Lq, int Lkv, int head_dim, float scale,
                       cudaStream_t stream) {
  const int C = head_dim / CW;
  if ((long long)H * C > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chunk_fwd<T, OT, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FWD_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H * C, B);
  chunk_fwd<T, OT, CAUSAL><<<grid, THREADS, FWD_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bm,
      static_cast<OT*>(o), m, l, qs, ks, vs, os, Lq, Lkv, H, group, C, scale);
  return cudaGetLastError();
}

// the backward over key tiles: B7b's dq (CAUSAL, no dk / dv) or B14 / B14p's
// one pass (cross: part is float32 scratch of 2 * ceil(Lq / BQ) * B * H *
// Lkv * head_dim elements when Lq > BQ, null otherwise)
template <typename T, bool CAUSAL>
cudaError_t launch_bwd_rows(const void* q, const void* k, const void* v, const float* bm,
                            const void* dout, const float* m, const float* l,
                            const float* dsum, void* dq, void* dk, void* dv, float* part,
                            const BwdStrides& st, int B, int H, int group, int Lq, int Lkv,
                            int head_dim, float scale, cudaStream_t stream) {
  constexpr bool DKV = !CAUSAL;
  const int C = head_dim / CW;
  const int n_qt = (Lq + BQ - 1) / BQ;
  if ((long long)H * C > 65535 || (DKV && (n_qt > 1) != (part != nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chunk_bwd_rows<T, CAUSAL, DKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BWD_BYTES);
  if (err != cudaSuccess) return err;
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  chunk_bwd_rows<T, CAUSAL, DKV><<<dim3(n_qt, H * C, B), THREADS, BWD_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bm,
      static_cast<const T*>(dout), m, l, dsum, static_cast<T*>(dq), dkt, dvt, part, st, Lq,
      Lkv, H, group, C, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const long long n = 2ll * B * H * Lkv * head_dim;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  chunk_dkv_sum<T><<<blocks, 256, 0, stream>>>(part, dkt, dvt, st.dk, st.dv, n_qt, B, H, Lkv,
                                                head_dim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_keys(const void* q, const void* k, const void* v, const float* mask,
                            const void* dout, const float* m, const float* l,
                            const float* dsum, void* dk, void* dv, const BwdStrides& st, int B,
                            int H, int group, int L, int head_dim, float scale,
                            cudaStream_t stream) {
  const int C = head_dim / CW;
  if ((long long)(H / group) * C > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chunk_bwd_keys<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BWD_BYTES);
  if (err != cudaSuccess) return err;
  chunk_bwd_keys<T><<<dim3((L + BK - 1) / BK, (H / group) * C, B), THREADS, BWD_BYTES,
                      stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(dout), m, l, dsum, static_cast<T*>(dk), static_cast<T*>(dv), st, L,
      H, group, C, scale);
  return cudaGetLastError();
}

// the merged-head layout of K1 / B7b ([B, L, heads * head_dim]) as strides
inline Strides merged(int L, int heads, int head_dim) {
  return Strides{(long long)L * heads * head_dim, head_dim, (long long)heads * head_dim};
}

}  // namespace chunked
