// Streaming-softmax cross-attention for Hopper (sm_90a): kernels B13, B14
// and B14p (forward and backward), the user Q-Former's attention of its 64
// query tokens over the flattened history memory (seq * K rows, 1,600 at
// seq 50).
//
// Replaces the Pallas TPU kernels
//   B13      unirec_tpu/ops/attention.py::flash_cross_attention (_flash_kernel,
//            call :308): inference attention over per-head [B, H, L, hd]
//            tensors with an additive per-key bias;
//   B14 fwd  unirec_tpu/ops/flash_vjp.py::_mh_fwd (_mh_fwd_kernel, call :549):
//            the same over merged-head [B, L, H * hd] tensors, heads as column
//            ranges, keeping the per-(batch, row, head) max m and sum l;
//   B14 bwd  unirec_tpu/ops/flash_vjp.py::_mh_bwd (_mh_bwd_kernel, call :595):
//            dq, dk and dv from (m, l), flash-2 recompute, the backward of
//            flash_cross_attention_proj_vjp;
//   B14p fwd unirec_tpu/ops/flash_vjp.py::_fwd (_fwd_kernel :51, call :236)
//            and bwd _bwd (_bwd_kernel :113, call :276): the same pair over
//            per-head [B, H, L, hd] tensors, flash_cross_attention_vjp.
// The TPU needed two kernel pairs only for its lane layout (heads as lane
// column ranges against heads as a grid axis); here every kernel takes
// (batch, head, row) strides, so one forward and one backward serve all
// three.  Their arithmetic, as the JAX kernels do it:
//   s  = (q . k) * scale + bias       two fp32 roundings (no contraction)
//   m  = max(-1e9, max_j s),  l = sum_j exp(s - m)   (m starts at NEG_INF)
//   o  = (sum_j exp(s - m) v_j) / (l == 0 ? 1 : l)
//   p  = exp(s - m) / (l == 0 ? 1 : l)                       (backward)
//   dv = p^T dO,  dp = dO v^T,  ds = p (dp - dsum) scale,  dsum = rowsum(dO O)
//   dk = ds^T q,  dq = ds k
// m and l are kept apart, never folded into a logsumexp: at the -1e9 mask
// magnitude fp32 would swallow log l.  dsum is computed by the caller in
// plain torch, as JAX computes it in XLA, but from an O that B14's forward
// writes in fp32 also for bf16 inputs (the JAX kernel writes it in bf16):
// dsum then equals sum_j p dp to fp32 rounding, so that ds sums to ~0 over
// a query's keys as the softmax VJP's does.  From a bf16 O the sum is off by
// a bf16 rounding of dsum, which reaches dq through the keys' common
// component and dk through the memory's: the first cross layer's query and
// key weight gradients, whose queries are the same for every user, are sums
// of nearly cancelling terms and lose most of their digits to it.
//
// Keys past Lkv (the ragged edge of the last 64-key tile) are skipped: they
// get exactly zero weight.  The JAX kernels pad them with a 2 * NEG_INF bias
// for that reason: on a row whose every real key carries -1e9 (a user whose
// whole history is missing from the cache) the real keys then share the
// probability uniformly and a pad at -1e9 would take a share too.
//
// Layouts (elements; the head dimension is always contiguous and every row
// starts on a 16-byte boundary): q, dO, o, dq
// [B, H, Lq, HD] and k, v, dk, dv [B, H, Lkv, HD], each by its own (batch,
// head, row) strides, so B13 reads the per-head views of merged [B, L, D]
// projections without a copy, B14 passes the merged layout itself and B14p
// plain per-head tensors; bias [B, Lkv] float or null; m, l, dsum [B, Lq, H]
// float (B14, B14p).  The head dimension HD is a template parameter: every
// multiple of 16 up to 128 (any head count a Q-Former width of 1024 splits
// into, and more).  Inputs and outputs are float or bf16 (one type per
// call, except the forward's o of B14 and B14p, which is float);
// arithmetic and accumulators are fp32.
//
// What bounds them: at the user stage's training shape (B = 64, Lq = 64,
// Lkv = 1,600, 16 heads of 64, bf16) the forward reads ~420 MB of q, k and v
// for 26.8 GFLOP and the backward ~870 MB for 67 GFLOP: both sit below the
// card's bf16 ridge (about 295 operations a byte), so bytes bound them.  This
// first design does the arithmetic as K1 and B7b do, with scalar fp32 FMAs
// from shared memory (one code path for bf16 and fp32), which caps it at the
// fp32 rate well before the bytes: tensor cores (mma.sync / wgmma) and TMA
// are later work.
//   fwd:     one block per (64-row q tile, head, batch); loops over 64-key
//            k/v tiles with a running max, sum and accumulator in registers.
//   bwd dq:  one block per (64-row q tile, head, batch); loops over kv tiles,
//            dq accumulates in registers.
//   bwd dkv: one block per (64-key kv tile, head, batch); loops over the q
//            tiles (one at Lq = 64), dk and dv accumulate in registers.
// Each output has one owner block and no atomics: the bits are the same from
// run to run.  16 x 16 threads; a thread owns a 4 x 4 block of a 64 x 64
// score tile and a 4 x (HD / 16) block of a 64 x HD output.  Shared memory
// grows with HD: at HD = 128 the dk / dv kernel takes 166,400 bytes of the
// 232,448 a block may have, set per instance.
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

constexpr int BT = 64;            // rows of a q tile and keys of a kv tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int PS = BT + 1;        // padded row stride of a [64][64] tile
constexpr float NEG_INF = -1e9f;  // the running max's start (ops/attention.py)

// the shared-memory layout of each kernel, per head dimension
template <int HD>
struct Tile {
  static constexpr int CJ = HD / 16;  // output columns a thread owns
  static constexpr int RS = HD + 1;   // padded row stride of a [64][HD] tile
  // forward: Q, K, V tiles, the p tile, the kv tile's bias
  static constexpr size_t FWD_BYTES = (3 * BT * RS + BT * PS + BT) * sizeof(float);
  // dq kernel: Q, dO, K, V tiles, the ds tile, m / l / dsum / bias
  static constexpr size_t DQ_BYTES = (4 * BT * RS + BT * PS + 4 * BT) * sizeof(float);
  // dkv kernel: K, V, Q, dO tiles, the p^T and ds^T tiles, m / l / dsum / bias
  static constexpr size_t DKV_BYTES =
      (4 * BT * RS + 2 * BT * PS + 4 * BT) * sizeof(float);
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head_dim");
  static_assert(DKV_BYTES <= 232448, "shared memory of one block");
};

struct Strides {
  long long b, h, r;  // elements between batches, heads and rows
};

// the backward's seven tensors
struct BwdStrides {
  Strides q, k, v, dout, dq, dk, dv;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// (q . k) * scale + bias with both roundings, as the JAX kernels compute it
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// rows [r0, r0 + 64) of one head (row stride rs) -> smem [64][HD + 1] floats;
// rows past L read as zero.  16-byte loads (8 bf16 or 4 floats a thread):
// the tile loads wait on device memory with nothing to overlap them, so the
// fewer load instructions the better.  Rows start on 16-byte boundaries
// (the wrappers check: ops/attention.check_kernel_tensors).
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long rs, int r0,
                                          int L, int tid) {
  constexpr int V = 16 / sizeof(T);  // elements of one load
  constexpr int VPR = HD / V;        // loads per row
  for (int e = tid; e < BT * VPR; e += THREADS) {
    const int r = e / VPR, d = (e % VPR) * V;
    const int row = r0 + r;
    float* out = dst + r * Tile<HD>::RS + d;
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

// max / sum over the 16 threads (tx) that share a row: a half warp
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the forward's o: B13 writes T, B14 (STATS) float for the backward's dsum
template <typename T, bool STATS>
using OutT = typename std::conditional<STATS, float, T>::type;

template <int HD, typename T, bool STATS>
__global__ void __launch_bounds__(THREADS)
flash_cross_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       OutT<T, STATS>* __restrict__ o, float* __restrict__ m_out,
                       float* __restrict__ l_out, Strides qs, Strides ks, Strides vs,
                       Strides os, int Lq, int Lkv, int H, float scale) {
  constexpr int CJ = Tile<HD>::CJ, RS = Tile<HD>::RS;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BT][RS]
  float* Ks = Qs + BT * RS;      // [BT][RS]
  float* Vs = Ks + BT * RS;      // [BT][RS]
  float* Ps = Vs + BT * RS;      // [BT][PS]  exp(s - m) of this tile
  float* bs = Ps + BT * PS;      // [BT]      bias of this tile's keys

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;        // rows ty*4 .. ty*4+3
  const int tx = tid & 15;        // score cols tx + 16j, output cols tx + 16j
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias ? bias + (long long)b * Lkv : nullptr;

  load_tile<HD>(Qs, qb, qs.r, q0, Lq, tid);

  float m_run[4], l_run[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = (Lkv + BT - 1) / BT;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K / V / P reads are done
    load_tile<HD>(Ks, kb, ks.r, k0, Lkv, tid);
    load_tile<HD>(Vs, vb, vs.r, k0, Lkv, tid);
    if (tid < BT) {
      const int key = k0 + tid;
      bs[tid] = (key < Lkv && biasb) ? biasb[key] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * RS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: every tile holds key k0 < Lkv, so the tile max is finite
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = score(s[i][j], scale, bs[c]);
        if (k0 + c < Lkv) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = k0 + c < Lkv ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * PS + c] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + row_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // p written

    // acc += p v
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = Vs[c * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  OutT<T, STATS>* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    // all-masked rows have l == 0: emit zeros rather than NaN
    const float den = l_run[i] == 0.f ? 1.f : l_run[i];
#pragma unroll
    for (int j = 0; j < CJ; ++j) store(ob + row * os.r + tx + 16 * j, acc[i][j] / den);
    if (STATS && tx == 0) {
      const size_t r = ((size_t)b * Lq + row) * H + h;
      m_out[r] = m_run[i];
      l_out[r] = l_run[i];
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_cross_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ bias,
                          const T* __restrict__ dout, const float* __restrict__ m_in,
                          const float* __restrict__ l_in,
                          const float* __restrict__ dsum_in, T* __restrict__ dq,
                          BwdStrides st, int Lq, int Lkv, int H, float scale) {
  constexpr int CJ = Tile<HD>::CJ, RS = Tile<HD>::RS;
  extern __shared__ float smem[];
  float* Qs = smem;                // [BT][RS]
  float* dOs = Qs + BT * RS;       // [BT][RS]
  float* Ks = dOs + BT * RS;       // [BT][RS]
  float* Vs = Ks + BT * RS;        // [BT][RS]
  float* dSs = Vs + BT * RS;       // [BT][PS]  ds of this tile
  float* ms = dSs + BT * PS;       // [BT]
  float* ls = ms + BT;             // [BT]  l with 0 guarded to 1
  float* dsums = ls + BT;          // [BT]
  float* bs = dsums + BT;          // [BT]  bias of this tile's keys

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // rows ty*4 .. ty*4+3
  const int tx = tid & 15;          // score cols tx + 16j, output cols tx + 16j
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* dob = dout + b * st.dout.b + h * st.dout.h;
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;
  const float* biasb = bias ? bias + (long long)b * Lkv : nullptr;

  load_tile<HD>(Qs, qb, st.q.r, q0, Lq, tid);
  load_tile<HD>(dOs, dob, st.dout.r, q0, Lq, tid);
  if (tid < BT) {
    const int row = q0 + tid;
    const size_t r = ((size_t)b * Lq + row) * H + h;
    const float lv = row < Lq ? l_in[r] : 1.f;
    ms[tid] = row < Lq ? m_in[r] : 0.f;
    ls[tid] = lv == 0.f ? 1.f : lv;
    dsums[tid] = row < Lq ? dsum_in[r] : 0.f;
  }

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  const int n_kv = (Lkv + BT - 1) / BT;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K / ds reads are done
    load_tile<HD>(Ks, kb, st.k.r, k0, Lkv, tid);
    load_tile<HD>(Vs, vb, st.v.r, k0, Lkv, tid);
    if (tid < BT) {
      const int key = k0 + tid;
      bs[tid] = (key < Lkv && biasb) ? biasb[key] : 0.f;
    }
    __syncthreads();

    // s = q k^T and dp = dO v^T for rows ty*4+i, keys tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * RS + d];
        ov[i] = dOs[(ty * 4 + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * RS + d];
        vv[j] = Vs[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const bool row_ok = q0 + r < Lq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (row_ok && k0 + c < Lkv)
                            ? expf(score(s[i][j], scale, bs[c]) - ms[r]) / ls[r]
                            : 0.f;
        dSs[r * PS + c] = p * (dp[i][j] - dsums[r]) * scale;
      }
    }
    __syncthreads();  // ds written

    // dq += ds k
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float dsv[4], kk[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kk[j] = Ks[c * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(dsv[i], kk[j], acc[i][j]);
    }
  }

  T* dqb = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) store(dqb + row * st.dq.r + tx + 16 * j, acc[i][j]);
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_cross_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           const T* __restrict__ dout, const float* __restrict__ m_in,
                           const float* __restrict__ l_in,
                           const float* __restrict__ dsum_in, T* __restrict__ dk,
                           T* __restrict__ dv, BwdStrides st, int Lq, int Lkv, int H,
                           float scale) {
  constexpr int CJ = Tile<HD>::CJ, RS = Tile<HD>::RS;
  extern __shared__ float smem[];
  float* Ks = smem;                // [BT][RS]
  float* Vs = Ks + BT * RS;        // [BT][RS]
  float* Qs = Vs + BT * RS;        // [BT][RS]
  float* dOs = Qs + BT * RS;       // [BT][RS]
  float* Pt = dOs + BT * RS;       // [BT][PS]  p^T: [key][row]
  float* dSt = Pt + BT * PS;       // [BT][PS]  ds^T
  float* ms = dSt + BT * PS;       // [BT]
  float* ls = ms + BT;             // [BT]
  float* dsums = ls + BT;          // [BT]
  float* bs = dsums + BT;          // [BT]

  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // keys ty*4 .. ty*4+3
  const int tx = tid & 15;          // score rows tx + 16j, output cols tx + 16j
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* dob = dout + b * st.dout.b + h * st.dout.h;
  const float* biasb = bias ? bias + (long long)b * Lkv : nullptr;

  load_tile<HD>(Ks, kb, st.k.r, k0, Lkv, tid);
  load_tile<HD>(Vs, vb, st.v.r, k0, Lkv, tid);
  if (tid < BT) {
    const int key = k0 + tid;
    bs[tid] = (key < Lkv && biasb) ? biasb[key] : 0.f;
  }

  float acc_k[4][CJ], acc_v[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_q = (Lq + BT - 1) / BT;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the previous tile's Q / dO / p^T / ds^T reads are done
    load_tile<HD>(Qs, qb, st.q.r, q0, Lq, tid);
    load_tile<HD>(dOs, dob, st.dout.r, q0, Lq, tid);
    if (tid < BT) {
      const int row = q0 + tid;
      const size_t r = ((size_t)b * Lq + row) * H + h;
      const float lv = row < Lq ? l_in[r] : 1.f;
      ms[tid] = row < Lq ? m_in[r] : 0.f;
      ls[tid] = lv == 0.f ? 1.f : lv;
      dsums[tid] = row < Lq ? dsum_in[r] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T for keys ty*4+i, rows tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kk[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = Ks[(ty * 4 + i) * RS + d];
        vv[i] = Vs[(ty * 4 + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * RS + d];
        ov[j] = dOs[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kk[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i;
      const bool key_ok = k0 + c < Lkv;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float p = (key_ok && q0 + r < Lq)
                            ? expf(score(s[i][j], scale, bs[c]) - ms[r]) / ls[r]
                            : 0.f;
        Pt[c * PS + r] = p;
        dSt[c * PS + r] = p * (dp[i][j] - dsums[r]) * scale;
      }
    }
    __syncthreads();  // p^T and ds^T written

    // dv += p^T dO, dk += ds^T q
#pragma unroll 2
    for (int r = 0; r < BT; ++r) {
      float pv[4], sv[4], ov[CJ], qv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(ty * 4 + i) * PS + r];
        sv[i] = dSt[(ty * 4 + i) * PS + r];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        ov[j] = dOs[r * RS + tx + 16 * j];
        qv[j] = Qs[r * RS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
        }
    }
  }

  T* dkb = dk + b * st.dk.b + h * st.dk.h;
  T* dvb = dv + b * st.dv.b + h * st.dv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Lkv) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      store(dkb + key * st.dk.r + tx + 16 * j, acc_k[i][j]);
      store(dvb + key * st.dv.r + tx + 16 * j, acc_v[i][j]);
    }
  }
}

template <int HD, typename T, bool STATS>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bias,
                       void* o, float* m, float* l, Strides qs, Strides ks, Strides vs,
                       Strides os, int B, int H, int Lq, int Lkv, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::FWD_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_cross_fwd_kernel<HD, T, STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BT - 1) / BT, H, B);
  flash_cross_fwd_kernel<HD, T, STATS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<OutT<T, STATS>*>(o), m, l, qs, ks, vs, os, Lq, Lkv, H, scale);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* bias,
                       const void* dout, const float* m, const float* l, const float* dsum,
                       void* dq, void* dk, void* dv, const BwdStrides& st, int B, int H,
                       int Lq, int Lkv, float scale, cudaStream_t stream) {
  constexpr size_t dq_smem = Tile<HD>::DQ_BYTES, dkv_smem = Tile<HD>::DKV_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_cross_bwd_dq_kernel<HD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_cross_bwd_dkv_kernel<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_cross_bwd_dq_kernel<HD, T><<<dim3((Lq + BT - 1) / BT, H, B), THREADS, dq_smem,
                                     stream>>>(qt, kt, vt, bias, dot, m, l, dsum,
                                               static_cast<T*>(dq), st, Lq, Lkv, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_cross_bwd_dkv_kernel<HD, T><<<dim3((Lkv + BT - 1) / BT, H, B), THREADS, dkv_smem,
                                      stream>>>(qt, kt, vt, bias, dot, m, l, dsum,
                                                static_cast<T*>(dk), static_cast<T*>(dv),
                                                st, Lq, Lkv, H, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Lq, int Lkv) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lkv <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// B13 (m = l = null; o in the inputs' type), the forward of B14 and of B14p
// (m, l [B, Lq, H] float; o float).  Strides in elements for (batch, head,
// row) of q, k, v and o.  dtype: 0 = float32, 1 = bfloat16.  bias: [B, Lkv]
// float additive per-key bias, or null.
extern "C" int unirec_flash_cross_fwd(const void* q, const void* k, const void* v,
                                      const float* bias, void* o, float* m, float* l,
                                      long long qsb, long long qsh, long long qsr,
                                      long long ksb, long long ksh, long long ksr,
                                      long long vsb, long long vsh, long long vsr,
                                      long long osb, long long osh, long long osr, int B,
                                      int H, int Lq, int Lkv, int head_dim, int dtype,
                                      float scale, void* stream) {
  if (bad_shape(B, H, Lq, Lkv) || ((m == nullptr) != (l == nullptr)) || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qsr}, ks{ksb, ksh, ksr}, vs{vsb, vsh, vsr}, os{osb, osh, osr};
  return (int)with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    if (dtype == 0)
      return m ? launch_fwd<HD, float, true>(q, k, v, bias, o, m, l, qs, ks, vs, os, B, H,
                                             Lq, Lkv, scale, s)
               : launch_fwd<HD, float, false>(q, k, v, bias, o, m, l, qs, ks, vs, os, B,
                                              H, Lq, Lkv, scale, s);
    return m ? launch_fwd<HD, __nv_bfloat16, true>(q, k, v, bias, o, m, l, qs, ks, vs, os,
                                                   B, H, Lq, Lkv, scale, s)
             : launch_fwd<HD, __nv_bfloat16, false>(q, k, v, bias, o, m, l, qs, ks, vs, os,
                                                    B, H, Lq, Lkv, scale, s);
  });
}

// The backward of B14 and B14p: the dq kernel, then the dk / dv kernel.
// strides: 21 values, (batch, head, row) of q, k, v, dO, dq, dk and dv in
// that order.
extern "C" int unirec_flash_cross_bwd(const void* q, const void* k, const void* v,
                                      const float* bias, const void* dout, const float* m,
                                      const float* l, const float* dsum, void* dq, void* dk,
                                      void* dv, const long long* strides, int B, int H,
                                      int Lq, int Lkv, int head_dim, int dtype, float scale,
                                      void* stream) {
  if (bad_shape(B, H, Lq, Lkv) || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* x = strides;
  const BwdStrides st{{x[0], x[1], x[2]},    {x[3], x[4], x[5]},    {x[6], x[7], x[8]},
                      {x[9], x[10], x[11]},  {x[12], x[13], x[14]}, {x[15], x[16], x[17]},
                      {x[18], x[19], x[20]}};
  return (int)with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    if (dtype == 0)
      return launch_bwd<HD, float>(q, k, v, bias, dout, m, l, dsum, dq, dk, dv, st, B, H,
                                   Lq, Lkv, scale, s);
    return launch_bwd<HD, __nv_bfloat16>(q, k, v, bias, dout, m, l, dsum, dq, dk, dv, st,
                                         B, H, Lq, Lkv, scale, s);
  });
}
