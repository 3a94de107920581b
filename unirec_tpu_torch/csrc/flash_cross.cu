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
// Keys past Lkv (the ragged edge of the last key tile) are zero-filled and
// get exactly zero weight.  The JAX kernels pad them with a 2 * NEG_INF bias
// for that reason: on a row whose every real key carries -1e9 (a user whose
// whole history is missing from the cache) the real keys then share the
// probability uniformly (their scores all round to -1e9), and a pad at -1e9
// would take a share too.
//
// Layouts (elements; the head dimension is always contiguous and every row
// starts on a 16-byte boundary): q, dO, o, dq [B, H, Lq, HD] and k, v, dk, dv
// [B, H, Lkv, HD], each by its own (batch, head, row) strides, so B13 reads
// the per-head views of merged [B, L, D] projections without a copy, B14
// passes the merged layout itself (each head's row a 128-byte segment at HD
// 64) and B14p plain per-head tensors; bias [B, Lkv] float or null; m, l,
// dsum [B, Lq, H] float (B14, B14p).  The head dimension HD is a template
// parameter: every multiple of 16 up to 128, and 256 (head_dim.cuh); the
// wrappers zero-pad any other head dimension up to 256 to the next instance
// (ops/attention.padded_launch: zero lanes add exact zeros to every dot
// product) and pass the scale of the true one; above 256 the C entries hand
// the head dim to the chunked form of flash_chunked.cuh (chunks of 256; the
// wrappers pad to whole chunks only rows that are not whole 16-byte
// pieces).  Inputs and outputs are float
// or bf16 (one type per call, except the forward's o of B14 and B14p, which
// is float); arithmetic and accumulators are fp32.
//
// What bounds them: at the user stage's training shape (B = 64, Lq = 64,
// Lkv = 1,600, 16 heads of 64, bf16) the forward reads ~420 MB of q, k and v
// for 26.8 GFLOP and the backward moves ~870 MB for 67 GFLOP: both sit far
// below the card's bf16 ridge (about 295 operations a byte), so bytes bound
// them (0.13 and 0.26 ms at 3.35 TB/s).  Scalar fp32 FMAs would cap the
// score-sized products at the fp32 rate (0.4 ms forward, 1 ms backward)
// well before the bytes, and a backward split into a dq kernel and a dk /
// dv kernel reads K and V twice: the bf16 design runs the products on tensor
// cores and the backward in one pass, and streams the tiles through
// asynchronous copies so that loads overlap the arithmetic.
//
// bf16 design (tensor cores; the path's type):
//   - fwd (flash_cross_fwd_tc, B13 / B14 fwd / B14p fwd): one block of 4
//     warps per (64-row q tile, head, batch), each warp 16 query rows; at Lq
//     = 64 that is one block per (user, head), 1,024 at the user shape,
//     which fill the card by occupancy (65 KB of shared memory a block at HD
//     64: three blocks an SM).  Q is loaded once; K, V and the keys' bias
//     stream through a ring of three stages filled by 16-byte (bias 4-byte)
//     cp.async copies, so tiles t + 1 and t + 2 load while tile t computes.
//     Rows are padded by 16 bytes, so ldmatrix reads are free of bank
//     conflicts.  S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in,
//     fp32 accumulate); the online softmax runs in fp32 registers in the
//     accumulator layout with expf (m and l are held to 1e-5); P is rounded
//     to bf16 in registers as the A fragment of P V, l sums the fp32 p.
//     B14's and B14p's o is float32, held to 1e-5 like m and l and read by
//     the backward's dsum: there P enters as two bf16 terms, hi = bf16(p)
//     and lo = bf16(p - hi), two products that keep p to about 16 bits (one
//     bf16 term left o 5e-4 off), and each kv tile's P V is summed from zero
//     and folded into o by an fp32 fma (o alpha + tile): the tensor cores'
//     own accumulation over all the tiles left o 7e-6 to 1e-5 off.  B13's
//     bf16 o takes hi alone, accumulated in place.
//   - bwd (flash_cross_bwd_tc, B14 / B14p bwd): one pass over the keys.  One
//     block of 4 warps per (64-row q tile, head, batch) holds Q and dO; K, V
//     and the bias stream through a two-stage ring.  Per kv tile, each warp
//     computes S and dP for its 16 rows on tensor cores, p = exp(s - m) / l
//     and ds = p (dp - dsum) scale in fp32 registers (S and dP once per
//     (query, key) pair), dq += ds K with ds rounded to bf16 in registers
//     (dq stays in registers over the whole pass), and writes p and ds as
//     bf16 to shared memory; then the four warps split this tile's dv = p^T
//     dO and dk = ds^T Q by 16-key groups (p^T, ds^T, dO and Q through
//     ldmatrix.trans, 16 output columns at a time so the accumulators stay
//     small) and write them at once.  K and V are read once, and five
//     score-sized products run where the two-kernel split ran seven.  At Lq
//     <= 64 (the user stage) each output has one owner block and no atomics.
//     With more q tiles (B14p at shapes no path uses) each q tile's block
//     writes float32 partial dk / dv to scratch that flash_cross_dkv_sum adds
//     up in q-tile order: deterministic too.
//   - Tiles: 64-key tiles up to HD 64, 32-key tiles above (more blocks an
//     SM at HD 128; at HD 256 the forward takes 135,552 bytes of shared
//     memory and the backward 145,664, one block an SM, the registers of the
//     HD / 2 floats of o or dq a thread holds being the other limit).
//   - The products see bf16-rounded p and ds (up to HD 32, ds as a bf16 hi
//     + lo pair, as B7b: a row of 16 or 32 lanes has too few components for
//     one rounding); the fp32 p is what the softmax state (m, l)
//     normalises, as in K1 and B7b.  Rounding each ds to bf16 is
//     unbiased noise, far smaller than the systematic error that a bf16 dsum
//     put into the first cross layer's weight gradients (chip_smoke.py phase
//     8 holds them).  wgmma and TMA are the next step, as for K1.
//
// fp32 design up to HD 256 (flash_tf32.cu; above it the chunked form,
// whose float32 kernels run in 3xTF32 too: flash_chunked_cluster.cuh):
// plain TF32 on tensor cores keeps about 3 decimal digits and breaks the
// 1e-5 fp32 gates, so every product runs in 3xTF32 (each float32 operand
// split into tf32 big + small, three mma.sync.m16n8k8 a step, each short run
// of steps summed from zero and added by an fp32 add), with the bf16
// design's schedule: the forward on 64-row q tiles, the backward in one pass
// over the keys with per-q-tile float32 partials of dk / dv above Lq 64.
// float32 is the default precision of train user-qformer, whose --flash
// cross layers run B14.  Float32 rows are padded to hd + 4 floats; the key
// tile and the ring depth are chosen per head dim (32 keys up to hd 64 in
// the backward, 16 above; 8 warps at hd 256, where a pair of warps shares
// a row group and splits the columns), as flash_tf32.cu's header sets out.
//
// Every C entry launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_chunked.cuh"
#include "flash_tf32.cuh"
#include "head_dim.cuh"
#include "ptx_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e9f;  // the running max's start (ops/attention.py)

using chunked::BwdStrides;
using chunked::Strides;

// (q . k) * scale + bias with both roundings, as the JAX kernels compute it
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// the forward's o: B13 writes T, B14 (STATS) float for the backward's dsum
template <typename T, bool STATS>
using OutT = typename std::conditional<STATS, float, T>::type;

// ------------------------------------------------- bf16, tensor cores ------

constexpr int TC_THREADS = 128;  // 4 warps, 16 query rows each
constexpr int BQ = 64;           // query rows of a block

template <int HD>
struct Tc {
  // keys of a kv tile: 64, or 32 above HD 64 so that more blocks share an SM
  static constexpr int BK = HD > 64 ? 32 : 64;
  static constexpr int LD = HD + 8;   // padded bf16 row (odd multiple of 16 bytes)
  static constexpr int PLD = BK + 8;  // padded bf16 row of the p / ds tiles
  static constexpr int KV = BK * LD;  // elements of one K or V tile
  static constexpr int FWD_STAGES = 3, BWD_STAGES = 2;
  // up to HD 32 the backward's ds enters dq and dk as a bf16 hi + lo pair
  static constexpr bool SPLIT_DS = HD <= 32;
  // forward: Q, the ring of (K, V, bias)
  static constexpr size_t FWD_BYTES =
      (size_t)(BQ * LD + FWD_STAGES * 2 * KV) * sizeof(bf16) + FWD_STAGES * BK * sizeof(float);
  // backward: Q, dO, the ring of (K, V, bias), p and ds (and ds's lo)
  static constexpr size_t BWD_BYTES =
      (size_t)(2 * BQ * LD + BWD_STAGES * 2 * KV + (SPLIT_DS ? 3 : 2) * BQ * PLD) *
          sizeof(bf16) +
      BWD_STAGES * BK * sizeof(float);
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 256, "head_dim");
  static_assert(FWD_BYTES <= 232448 && BWD_BYTES <= 232448, "shared memory of one block");
};

// rows [r0, r0 + n) of one head (row stride rs, rows past L zero-filled) ->
// smem [n][LD] bf16 by 16-byte cp.async
template <int HD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long long rs, int r0,
                                          int n, int L, int tid) {
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  for (int c = tid; c < n * CH; c += TC_THREADS) {
    const int r = c / CH, ch = c % CH;
    const int row = r0 + r;
    const bool ok = row < L;
    cp_async_16(smem_addr(dst + r * Tc<HD>::LD + ch * 8), src + (ok ? row : 0) * rs + ch * 8,
                ok);
  }
}

// one kv tile into stage `st` of the ring: K, V and the keys' bias (zero
// where there is no bias or no key)
template <int HD>
__device__ __forceinline__ void load_kv_tile(bf16* kvs, float* bs, const bf16* kb,
                                             const bf16* vb, const float* biasb, Strides ks,
                                             Strides vs, int st, int t, int Lkv, int tid) {
  using S = Tc<HD>;
  bf16* kt = kvs + st * 2 * S::KV;
  copy_rows<HD>(kt, kb, ks.r, t * S::BK, S::BK, Lkv, tid);
  copy_rows<HD>(kt + S::KV, vb, vs.r, t * S::BK, S::BK, Lkv, tid);
  if (tid < S::BK) {
    const int key = t * S::BK + tid;
    const bool ok = biasb != nullptr && key < Lkv;
    cp_async_4(smem_addr(bs + st * S::BK + tid), ok ? biasb + key : reinterpret_cast<const float*>(kb),
               ok);
  }
}

// the forward on tensor cores: o = softmax(q k^T scale + bias) v for one
// 64-row q tile of one (batch, head); warp w owns rows 16 w .. 16 w + 15.
// With STATS (B14, B14p: o in float32, held to 1e-5 and read by dsum) P
// enters P V as two bf16 terms, hi and lo; B13 (o in bf16) takes hi alone.
template <int HD, bool STATS>
__global__ void __launch_bounds__(TC_THREADS)
flash_cross_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   OutT<bf16, STATS>* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ l_out, Strides qs, Strides ks, Strides vs, Strides os,
                   int Lq, int Lkv, int H, float scale) {
  using S = Tc<HD>;
  constexpr int LD = S::LD, BK = S::BK, STAGES = S::FWD_STAGES;
  constexpr int NT = BK / 8;  // n-tiles of a score row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);                  // [BQ][LD]
  bf16* KVs = Qs + BQ * LD;                                       // [STAGES][K, V][BK][LD]
  float* bs = reinterpret_cast<float*>(KVs + STAGES * 2 * S::KV);  // [STAGES][BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias ? bias + (long long)b * Lkv : nullptr;
  const int n_kv = (Lkv + BK - 1) / BK;

  // prologue: Q with tile 0, then tiles 1 .. STAGES - 2, one group each
  copy_rows<HD>(Qs, qb, qs.r, q0, BQ, Lq, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_kv) load_kv_tile<HD>(KVs, bs, kb, vb, biasb, ks, vs, t, t, Lkv, tid);
    cp_async_commit();
  }

  float oacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of the warp
  float l_run[2] = {0.f, 0.f};          // this thread's columns' share

  for (int j = 0; j < n_kv; ++j) {
    const int pre = j + STAGES - 1;  // the tile that loads while tile j computes
    if (pre < n_kv) load_kv_tile<HD>(KVs, bs, kb, vb, biasb, ks, vs, pre % STAGES, pre, Lkv, tid);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile j (and Q) has landed
    __syncthreads();
    const int st = j % STAGES;
    const bf16* kt = KVs + st * 2 * S::KV;
    const bf16* vt = kt + S::KV;
    const float* bt = bs + st * BK;
    const int k0 = j * BK;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(kt + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_16816(s[2 * nj], a, bk[0], bk[1]);
        mma_16816(s[2 * nj + 1], a, bk[2], bk[3]);
      }
    }
    // score with both roundings, keys past Lkv out; running max of rows g
    // (e < 2) and g + 8 (e >= 2): every tile holds key k0 < Lkv
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        s[n][e] = k0 + c < Lkv ? score(s[n][e], scale, bt[c]) : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_run[e >> 1]);  // exactly 0 past Lkv
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    if constexpr (!STATS) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
    }
    // O += P V: P (bf16, hi and lo with STATS) from the S fragments, V via
    // ldmatrix.trans.  With STATS each tile's P V is summed from zero (CC
    // columns at a time) and folded into o with one fp32 fma, o * alpha +
    // tile: the tensor cores' accumulation, run over all 25 tiles, left
    // float32 o 1e-5 off at the user shape
    constexpr int CC = HD < 128 ? HD : 128;
#pragma unroll
    for (int c0 = 0; c0 < HD; c0 += CC) {
      float tacc[STATS ? CC / 8 : 1][4];
      if constexpr (STATS) {
#pragma unroll
        for (int n = 0; n < CC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = s[2 * kk + (r >> 1)] + 2 * (r & 1);
          if constexpr (STATS)
            split_bf16(x[0], x[1], a[r], lo[r]);
          else
            a[r] = pack_bf16(x[0], x[1]);
        }
#pragma unroll
        for (int nd = 0; nd < CC / 16; ++nd) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                          c0 + nd * 16 + (lane >> 4) * 8));
          if constexpr (STATS) {
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
      if constexpr (STATS) {
#pragma unroll
        for (int n = 0; n < CC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oacc[c0 / 8 + n][e] = fmaf(oacc[c0 / 8 + n][e], alpha[e >> 1], tacc[n][e]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  OutT<bf16, STATS>* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Lq) continue;
    const float den = l_run[i] == 0.f ? 1.f : l_run[i];
    OutT<bf16, STATS>* orow = ob + row * os.r;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float x0 = oacc[n][2 * i] / den, x1 = oacc[n][2 * i + 1] / den;
      if constexpr (STATS)
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * t4) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) = __floats2bfloat162_rn(x0, x1);
    }
    if (STATS && t4 == 0) {
      const size_t r = ((size_t)b * Lq + row) * H + h;
      m_out[r] = m_run[i];
      l_out[r] = l_run[i];
    }
  }
}

// The backward on tensor cores in one pass over the keys, for one 64-row q
// tile of one (batch, head): per kv tile, S = Q K^T and dP = dO V^T, p and
// ds in fp32 registers, dq += ds K in registers, and p and ds (bf16) through
// shared memory into this tile's dv = p^T dO and dk = ds^T Q.  With one q
// tile (part == null) dk and dv are written as they are; with more, each q
// tile's block writes float32 partials [n_qt][dk, dv][B][H][Lkv][HD] to
// part, which flash_cross_dkv_sum adds up in q-tile order.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_cross_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   const bf16* __restrict__ dout, const float* __restrict__ m_in,
                   const float* __restrict__ l_in, const float* __restrict__ dsum_in,
                   bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   float* __restrict__ part, BwdStrides st, int Lq, int Lkv, int H,
                   float scale) {
  using S = Tc<HD>;
  constexpr int LD = S::LD, PLD = S::PLD, BK = S::BK, STAGES = S::BWD_STAGES;
  constexpr int NT = BK / 8;        // n-tiles of a score row
  constexpr int UNITS = BK / 8;     // (16 keys, dk or dv) products of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                       // [BQ][LD]
  bf16* KVs = dOs + BQ * LD;                      // [STAGES][K, V][BK][LD]
  bf16* Ps = KVs + STAGES * 2 * S::KV;            // [BQ][PLD]  p, bf16
  bf16* dSs = Ps + BQ * PLD;                      // [BQ][PLD]  ds, bf16
  bf16* dSl = dSs + BQ * PLD;                     // [BQ][PLD]  ds - bf16(ds), SPLIT_DS
  float* bs = reinterpret_cast<float*>(dSs + (S::SPLIT_DS ? 2 : 1) * BQ * PLD);  // [STAGES][BK]

  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;  // the warp's first row of the tile
  const bf16* kb = k + b * st.k.b + h * st.k.h;
  const bf16* vb = v + b * st.v.b + h * st.v.h;
  const float* biasb = bias ? bias + (long long)b * Lkv : nullptr;
  const int n_kv = (Lkv + BK - 1) / BK;

  copy_rows<HD>(Qs, q + b * st.q.b + h * st.q.h, st.q.r, q0, BQ, Lq, tid);
  copy_rows<HD>(dOs, dout + b * st.dout.b + h * st.dout.h, st.dout.r, q0, BQ, Lq, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_kv) load_kv_tile<HD>(KVs, bs, kb, vb, biasb, st.k, st.v, t, t, Lkv, tid);
    cp_async_commit();
  }

  // rows g and g + 8 of the warp: m, 1 / l (l == 0 guarded to 1), dsum
  float mr[2], il[2], dsr[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    row_ok[i] = row < Lq;
    const size_t r = ((size_t)b * Lq + (row_ok[i] ? row : 0)) * H + h;
    const float lv = l_in[r];
    mr[i] = m_in[r];
    il[i] = 1.f / (lv == 0.f ? 1.f : lv);
    dsr[i] = dsum_in[r];
  }

  float dqacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[n][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int pre = j + STAGES - 1;
    if (pre < n_kv) load_kv_tile<HD>(KVs, bs, kb, vb, biasb, st.k, st.v, pre % STAGES, pre, Lkv, tid);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile j (and Q, dO) has landed
    __syncthreads();
    const int stg = j % STAGES;
    const bf16* kt = KVs + stg * 2 * S::KV;
    const bf16* vt = kt + S::KV;
    const float* bt = bs + stg * BK;
    const int k0 = j * BK;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ao[4];
      const int arow = (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(aq, smem_addr(Qs + arow));
      ldmatrix_x4(ao, smem_addr(dOs + arow));
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        const int brow = (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, smem_addr(kt + brow));
        ldmatrix_x4(bv, smem_addr(vt + brow));
        mma_16816(s[2 * nj], aq, bk[0], bk[1]);
        mma_16816(s[2 * nj + 1], aq, bk[2], bk[3]);
        mma_16816(dp[2 * nj], ao, bv[0], bv[1]);
        mma_16816(dp[2 * nj + 1], ao, bv[2], bv[3]);
      }
    }
    // p = exp(score - m) / l (0 past Lq and Lkv), ds = p (dp - dsum) scale;
    // both to shared memory as bf16, ds kept in dp
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t4 + e;
          const bool ok = row_ok[i] && k0 + c < Lkv;
          pe[e] = ok ? __expf(score(s[n][2 * i + e], scale, bt[c]) - mr[i]) * il[i] : 0.f;
          dp[n][2 * i + e] = pe[e] * (dp[n][2 * i + e] - dsr[i]) * scale;
        }
        const int at = (r0 + g + 8 * i) * PLD + n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(Ps + at) = pack_bf16(pe[0], pe[1]);
        if constexpr (S::SPLIT_DS)
          split_bf16(dp[n][2 * i], dp[n][2 * i + 1], *reinterpret_cast<uint32_t*>(dSs + at),
                     *reinterpret_cast<uint32_t*>(dSl + at));
        else
          *reinterpret_cast<uint32_t*>(dSs + at) = pack_bf16(dp[n][2 * i], dp[n][2 * i + 1]);
      }
    // dq += ds K: ds (bf16; hi and lo with SPLIT_DS) from the fragments, K
    // via ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* x = dp[2 * kk + (r >> 1)] + 2 * (r & 1);
        if constexpr (S::SPLIT_DS)
          split_bf16(x[0], x[1], a[r], lo[r]);
        else
          a[r] = pack_bf16(x[0], x[1]);
      }
#pragma unroll
      for (int nd = 0; nd < HD / 16; ++nd) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, smem_addr(kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                        nd * 16 + (lane >> 4) * 8));
        mma_16816(dqacc[2 * nd], a, bk[0], bk[1]);
        mma_16816(dqacc[2 * nd + 1], a, bk[2], bk[3]);
        if constexpr (S::SPLIT_DS) {
          mma_16816(dqacc[2 * nd], lo, bk[0], bk[1]);
          mma_16816(dqacc[2 * nd + 1], lo, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // p and ds of every row written

    // unit u: dv (u < UNITS / 2) or dk of keys kg .. kg + 15 of the tile,
    // over the q tile's 64 rows; p^T and ds^T via ldmatrix.trans of p / ds,
    // dO and Q via ldmatrix.trans, 16 output columns at a time
    for (int u = warp; u < UNITS; u += TC_THREADS / 32) {
      const bool is_dk = u >= UNITS / 2;
      const int kg = (u % (UNITS / 2)) * 16;
      const bf16* as = is_dk ? dSs : Ps;
      const bf16* bsrc = is_dk ? Qs : dOs;
      const bool lo_too = S::SPLIT_DS && is_dk;  // dk's ds - bf16(ds)
      uint32_t a[BQ / 16][4], lo[S::SPLIT_DS ? BQ / 16 : 1][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const int at = (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * PLD + kg + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(a[kk], smem_addr(as + at));
        if constexpr (S::SPLIT_DS)
          if (lo_too) ldmatrix_x4_trans(lo[kk], smem_addr(dSl + at));
      }
      const int key0 = k0 + kg + g;  // rows g and g + 8 of the product
#pragma unroll 2
      for (int nd = 0; nd < HD / 16; ++nd) {
        float acc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, smem_addr(bsrc + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                          nd * 16 + (lane >> 4) * 8));
          mma_16816(acc[0], a[kk], bb[0], bb[1]);
          mma_16816(acc[1], a[kk], bb[2], bb[3]);
          if constexpr (S::SPLIT_DS)
            if (lo_too) {
              mma_16816(acc[0], lo[kk], bb[0], bb[1]);
              mma_16816(acc[1], lo[kk], bb[2], bb[3]);
            }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = key0 + 8 * hf;
          if (key >= Lkv) continue;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = nd * 16 + n * 8 + 2 * t4;
            if (part != nullptr) {
              const long long at =
                  ((((long long)(qt * 2 + is_dk) * B + b) * H + h) * Lkv + key) * HD + col;
              *reinterpret_cast<float2*>(part + at) = make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
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
    __syncthreads();  // p / ds and stage stg are free for the next tile
  }
  cp_async_wait<0>();

  bf16* dqb = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    bf16* drow = dqb + (q0 + r0 + g + 8 * i) * st.dq.r;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(dqacc[n][2 * i], dqacc[n][2 * i + 1]);
  }
}

// dk and dv from the q tiles' float32 partials, added in q-tile order
__global__ void __launch_bounds__(256)
flash_cross_dkv_sum(const float* __restrict__ part, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Strides dks, Strides dvs, int n_qt, int B, int H,
                    int Lkv, int HD) {
  const long long n = (long long)B * H * Lkv * HD;  // elements of dk (and of dv)
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < 2 * n;
       i += (long long)gridDim.x * 256) {
    const bool is_dk = i >= n;
    const long long e = is_dk ? i - n : i;
    const int col = (int)(e % HD);
    const long long row = e / HD;  // (b, h, key)
    const int key = (int)(row % Lkv);
    const int h = (int)((row / Lkv) % H);
    const int b = (int)(row / ((long long)Lkv * H));
    float sum = 0.f;
    for (int t = 0; t < n_qt; ++t) sum += part[((long long)t * 2 + is_dk) * n + e];
    bf16* out = is_dk ? dk + b * dks.b + h * dks.h + key * dks.r
                      : dv + b * dvs.b + h * dvs.h + key * dvs.r;
    out[col] = __float2bfloat16(sum);
  }
}

// ----------------------------------------------------------------- launch --

template <int HD, bool STATS>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, const float* bias,
                          void* o, float* m, float* l, Strides qs, Strides ks, Strides vs,
                          Strides os, int B, int H, int Lq, int Lkv, float scale,
                          cudaStream_t stream) {
  constexpr size_t smem = Tc<HD>::FWD_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_cross_fwd_tc<HD, STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_cross_fwd_tc<HD, STATS><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<OutT<bf16, STATS>*>(o), m, l, qs, ks, vs, os, Lq, Lkv, H, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const float* bias,
                          const void* dout, const float* m, const float* l, const float* dsum,
                          void* dq, void* dk, void* dv, float* part, const BwdStrides& st,
                          int B, int H, int Lq, int Lkv, float scale, cudaStream_t stream) {
  const int n_qt = (Lq + BQ - 1) / BQ;
  if ((n_qt > 1) != (part != nullptr)) return cudaErrorInvalidValue;
  constexpr size_t smem = Tc<HD>::BWD_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_cross_bwd_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  flash_cross_bwd_tc<HD><<<dim3(n_qt, H, B), TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<const bf16*>(dout), m, l, dsum, static_cast<bf16*>(dq), dkt, dvt, part,
      st, Lq, Lkv, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const long long n = 2ll * B * H * Lkv * HD;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  flash_cross_dkv_sum<<<blocks, 256, 0, stream>>>(part, dkt, dvt, st.dk, st.dv, n_qt, B, H,
                                                  Lkv, HD);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Lq, int Lkv) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lkv <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// B13 (m = l = null; o in the inputs' type), the forward of B14 and of B14p
// (m, l [B, Lq, H] float; o float).  Strides in elements for (batch, head,
// row) of q, k, v and o.  dtype: 0 = float32 (3xTF32 on tensor cores,
// flash_tf32.cu), 1 = bfloat16 (tensor cores).  bias: [B, Lkv] float additive per-key bias, or
// null.  head_dim: an instance of head_dim.cuh, or above 256 (the chunked
// form, rows of whole 16-byte pieces); scale: 1 / sqrt of the true head dim (the wrapper pads other head
// dims to an instance).  splits, part: the chunked bf16 form's key splits
// and their float32 scratch (flash_chunked.cuh launch_fwd); 1 and null
// otherwise.
extern "C" int unirec_flash_cross_fwd(const void* q, const void* k, const void* v,
                                      const float* bias, void* o, float* m, float* l,
                                      float* part, long long qsb, long long qsh,
                                      long long qsr, long long ksb, long long ksh,
                                      long long ksr, long long vsb, long long vsh,
                                      long long vsr, long long osb, long long osh,
                                      long long osr, int B, int H, int Lq, int Lkv,
                                      int head_dim, int dtype, int splits, float scale,
                                      void* stream) {
  if (bad_shape(B, H, Lq, Lkv) || ((m == nullptr) != (l == nullptr)) || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked::is_chunked(head_dim)) {
    const chunked::Strides cq{qsb, qsh, qsr}, ck{ksb, ksh, ksr}, cv{vsb, vsh, vsr},
        co{osb, osh, osr};
    if (dtype == 0)
      return (int)chunked::launch_fwd<float, float, false>(q, k, v, bias, o, m, l, part, cq, ck,
                                                           cv, co, B, H, 1, Lq, Lkv, head_dim,
                                                           splits, scale, s);
    return (int)(m ? chunked::launch_fwd<bf16, float, false>(q, k, v, bias, o, m, l, part, cq,
                                                             ck, cv, co, B, H, 1, Lq, Lkv,
                                                             head_dim, splits, scale, s)
                   : chunked::launch_fwd<bf16, bf16, false>(q, k, v, bias, o, m, l, part, cq,
                                                            ck, cv, co, B, H, 1, Lq, Lkv,
                                                            head_dim, splits, scale, s));
  }
  const Strides qs{qsb, qsh, qsr}, ks{ksb, ksh, ksr}, vs{vsb, vsh, vsr}, os{osb, osh, osr};
  if (dtype == 0)
    return (int)tf32::cross_fwd(q, k, v, bias, o, m, l, qs, ks, vs, os, B, H, Lq, Lkv, head_dim,
                                scale, s);
  return (int)with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return m ? launch_fwd_tc<HD, true>(q, k, v, bias, o, m, l, qs, ks, vs, os, B, H, Lq, Lkv,
                                       scale, s)
             : launch_fwd_tc<HD, false>(q, k, v, bias, o, m, l, qs, ks, vs, os, B, H, Lq,
                                        Lkv, scale, s);
  });
}

// The backward of B14 and B14p: the one-pass kernel (float32 in 3xTF32,
// flash_tf32.cu; bfloat16 on tensor cores), and with Lq > 64 the sum of its
// q tiles' partials, for which part is float32 scratch of 2 * ceil(Lq / 64)
// * B * H * Lkv * head_dim elements (null otherwise).  Above 256 the
// chunked form, one pass in both types; the float32 cluster form takes
// splits key splits (dqpart: float32 scratch of splits * B * H * Lq *
// head_dim elements when splits > 1, null otherwise; flash_chunked.cuh's
// launch_bwd_rows), every other launch splits == 1.  strides: 21 values,
// (batch, head, row) of q, k, v, dO, dq, dk and dv in that order.
extern "C" int unirec_flash_cross_bwd(const void* q, const void* k, const void* v,
                                      const float* bias, const void* dout, const float* m,
                                      const float* l, const float* dsum, void* dq, void* dk,
                                      void* dv, float* part, float* dqpart,
                                      const long long* strides, int B, int H, int Lq, int Lkv,
                                      int head_dim, int dtype, int splits, float scale,
                                      void* stream) {
  if (bad_shape(B, H, Lq, Lkv) || dtype < 0 || dtype > 1 ||
      (splits != 1 && !chunked::is_chunked(head_dim)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* x = strides;
  const BwdStrides st{{x[0], x[1], x[2]},    {x[3], x[4], x[5]},    {x[6], x[7], x[8]},
                      {x[9], x[10], x[11]},  {x[12], x[13], x[14]}, {x[15], x[16], x[17]},
                      {x[18], x[19], x[20]}};
  if (chunked::is_chunked(head_dim)) {
    const chunked::BwdStrides cs{{x[0], x[1], x[2]},    {x[3], x[4], x[5]},
                                 {x[6], x[7], x[8]},    {x[9], x[10], x[11]},
                                 {x[12], x[13], x[14]}, {x[15], x[16], x[17]},
                                 {x[18], x[19], x[20]}};
    return (int)(dtype == 0
                     ? chunked::launch_bwd_rows<float, false>(q, k, v, bias, dout, m, l, dsum,
                                                              dq, dk, dv, part, dqpart, cs, B, H,
                                                              1, Lq, Lkv, head_dim, splits,
                                                              scale, s)
                     : chunked::launch_bwd_rows<bf16, false>(q, k, v, bias, dout, m, l, dsum,
                                                             dq, dk, dv, part, dqpart, cs, B, H,
                                                             1, Lq, Lkv, head_dim, splits, scale,
                                                             s));
  }
  if (dtype == 0)
    return (int)tf32::cross_bwd(q, k, v, bias, dout, m, l, dsum, dq, dk, dv, part, st, B, H, Lq,
                                Lkv, head_dim, scale, s);
  return (int)with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return launch_bwd_tc<HD>(q, k, v, bias, dout, m, l, dsum, dq, dk, dv, part, st, B, H, Lq,
                             Lkv, scale, s);
  });
}
