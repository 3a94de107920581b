// The float32 flash kernels at head dims up to 256 on tensor cores, every
// product in 3xTF32: B13, B14 and B14p (forward, fwd_tf32; one-pass
// backward, bwd_rows_tf32) and B7b (dq, bwd_rows_tf32 with CAUSAL; dk / dv,
// bwd_keys_tf32).
//
// Replaces, in float32 at head dims <= 256, the Pallas TPU kernels
//   B13      unirec_tpu/ops/attention.py::flash_cross_attention (_flash_kernel);
//   B14      unirec_tpu/ops/flash_vjp.py::_mh_fwd_kernel and _mh_bwd_kernel;
//   B14p     unirec_tpu/ops/flash_vjp.py::_fwd_kernel and _bwd_kernel;
//   B7b      unirec_tpu/ops/flash_causal_vjp.py::_dq_kernel and _dkv_kernel.
// float32 is the default precision of `train user-qformer` (--bf16 is
// opt-in), whose --flash cross layers run B14 at 16 heads of 64, and the
// joint trainer's float32 path runs B7b at 16 / 8 heads of 128.
//
// Numerics.  Plain TF32 (one product a step) keeps about 3 decimal digits
// and misses the 1e-5 float32 gates by 30 to 60 times
// (tests/test_torch_tf32_split.py).  3xTF32 (ptx_helpers.cuh: split_tf32,
// mma_3xtf32) holds each float32 operand as tf32 big + small and issues
// small . big + big . small + big . big, dropping only small . small (about
// 2^-22 of the product).  The tile products are flash_chunked.cuh's
// scores32, frag_product32 and key_product32, which the float32 cluster
// kernels share.  The tensor cores do not round their sums to nearest, so
// every product is summed in short runs that start at zero (RUN = 2 steps
// of k = 8) and each run is added to its accumulator by an fp32 add: with
// runs of 4 steps, as the cluster kernels take them, B14's dk at the user
// shape lay 2.8e-6 of its largest value from a float64 evaluation of the
// formula, the scalar fp32 kernel's 1.1e-6; with runs of 2, 1.1e-6
// (scripts/probe_flash_tf32.py).
// P and ds enter their products through the same split, never rounded
// to a lower type; o, dq, dk and dv stay float32.  The rest is the scalar
// kernels' arithmetic, as the JAX kernels do it: s = (q . k) * scale + bias
// in two roundings (causal: (q . k) * scale), the additive -1e9 mask, m
// starting at -1e9, l summing the fp32 p, (m, l) written apart (never a
// logsumexp), p = exp(s - m) / (l == 0 ? 1 : l), ds = p (dp - dsum) scale
// with the caller's dsum (from B14's float32 o), keys past Lkv (and padded
// or later keys in B7b) exactly zero weight.
//
// Layouts: q, dO, o, dq and k, v, dk, dv by (batch, head, row) strides in
// elements, the head dim contiguous and rows on 16-byte boundaries (B14's
// merged [B, L, H * hd], B13 / B14p's per-head [B, H, L, hd], K1 / B7b's
// merged [B, L, heads * hd]); query head h reads key head h / group (B7b's
// GQA; group 1 for the cross kernels); m, l, dsum [B, Lq, H] float; the key
// info [B, Lkv] float: the cross kernels' additive bias or null, B7b's pad
// mask (0 = padded key).
//
// Tiles.  Float32 rows are padded to LD = hd + 4 floats (4 or 20 mod 32
// banks): the score products read rows g and columns t, t + 4 of A and B
// (banks 4g + t or 20g + t: no conflicts); the products whose A is the
// accumulator of the previous one (P V, dq += ds K) take the k index
// permuted (ptx_helpers.cuh) and read B's rows 2t and 2t + 1 (banks 8t + g);
// dv = p^T dO and dk = ds^T Q read p / ds ([rows][keys + 4]) the same way.
// Shared memory holds at most 232,448 bytes a block; the choices per head
// dim (Fwd, Rows, Keys below):
//   - forward: one block per (64-row q tile, head, batch), 4 warps of 16
//     rows; 32-key tiles of (K, V, bias) through a cp.async ring of 3 stages
//     up to hd 64 (70,016 bytes at hd 64: three blocks an SM) and 2 above
//     (101,632 at hd 128: two an SM); at hd 256 8 warps, warp w and w + 4
//     sharing rows 16 (w % 4) .. and splitting the key tile's score n-tiles
//     and o's columns (a thread then holds 64 floats of o, not 128), the
//     partial scores exchanged through shared memory (208,128 bytes: one
//     block an SM);
//   - backward over rows (B14 / B14p's one pass; B7b's dq without dk / dv):
//     one block per (64-row q tile, head, batch) holds Q and dO; 32-key tiles
//     in 3 stages up to hd 64 (105,856 bytes at hd 64 with p and ds: two
//     blocks an SM), 16-key tiles in 2 stages above (111,744 at hd 128: two
//     an SM; 218,240 at hd 256 with 8 warps as the forward's); per key tile
//     S and dP, p and ds in fp32 registers, dq += ds K in registers over the
//     pass; with DKV p and ds go to shared memory and the warps split dv =
//     p^T dO and dk = ds^T Q by (output, 16-key group, column part), written
//     at once (Lq <= 64: one owner a key) or as float32 partials per q tile
//     that chunked::chunk_dkv_sum adds up in q-tile order;
//   - B7b's dk / dv: one block of 8 warps per (32-key tile, key head,
//     batch) (111,492 bytes at hd 128: two blocks an SM, which took B7b's
//     dk / dv 15% under 64-key tiles at one an SM, though each q tile is
//     loaded by twice the blocks; scripts/probe_flash_tf32.py), K and V
//     resident, the group's
//     query heads and the 32-row q tiles from the diagonal on streaming
//     through the ring with their m, l and dsum; per q tile the warps split
//     S and dP by (16-row group, key n-tiles), write p and ds, then dv and
//     dk by (16-key group, column part) into fp32 registers over the whole
//     loop.  A key tile that is all padding writes exact zeros.
// Every output has one owner (or one q-tile partial summed in order): the
// bits are the same from run to run.
//
// What bounds them: at the user stage's training shape (64 users, 64
// queries, 1,600 memory rows, 16 heads of 64) the forward is 26.8 GFLOP and
// the backward 67, 0.49 and 1.22 ms at the 3xTF32 rate (495 / 3 TFLOP/s)
// against 0.26 and 0.52 ms of bytes: the tensor cores' issue of three mma a
// step and the split's ALU work bound them.

#include "flash_tf32.cuh"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_chunked.cuh"
#include "head_dim.cuh"
#include "ptx_helpers.cuh"

namespace tf32 {

using chunked::BwdStrides;
using chunked::chunk_dkv_sum;
using chunked::copy_rows32;
using chunked::frag_product32;
using chunked::get_x;
using chunked::key_product32;
using chunked::put_x;
using chunked::scores32;
using chunked::Strides;

constexpr int BQ = 64;             // query rows of a q tile (forward, over rows)
constexpr float NEG_INF = -1e9f;   // the running max's start
constexpr size_t SMEM_MAX = 232448;
// mma steps (k = 8 each) a product sums from zero before an fp32 add into
// its accumulator: the tensor cores do not round their sums to nearest
// (runs of 4 doubled B14's error, runs of 1 cost B7b a quarter more time)
constexpr int RUN = 2;

// ---------------------------------------------------------------- forward --

template <int HD>
struct Fwd {
  static constexpr int WC = HD > 128 ? 2 : 1;  // warps sharing a row group
  static constexpr int THREADS = 128 * WC;
  static constexpr int BK = 32;                // keys of a key tile
  static constexpr int NT = BK / 8;
  static constexpr int STAGES = HD <= 64 ? 3 : 2;
  static constexpr int LD = HD + 4;
  static constexpr int KV = BK * LD;  // floats of one K or V tile
  static constexpr int XF = WC > 1 ? NT * (BQ / 16) * 32 * 4 : 0;  // the score exchange
  static constexpr size_t BYTES = (size_t)(BQ * LD + STAGES * (2 * KV + BK) + XF) * sizeof(float);
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 256, "head_dim");
  static_assert(BYTES <= SMEM_MAX, "shared memory of one block");
};

// The forward for one 64-row q tile of one (batch, head): o = softmax(q k^T
// scale + bias) v in float32, and with m_out (B14, B14p) m and l.  Warp w:
// rows 16 (w % 4) .., with WC = 2 the key tile's score n-tiles NT / 2 (w /
// 4) .. and o's columns HD / 2 (w / 4) .. (both warps of a pair run the same
// softmax on the exchanged tile, bit for bit).  The online softmax in fp32
// registers (expf); o = o alpha + P V, each tile's P V summed from zero.
template <int HD>
__global__ void __launch_bounds__(Fwd<HD>::THREADS)
fwd_tf32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ bias, float* __restrict__ o, float* __restrict__ m_out,
         float* __restrict__ l_out, Strides qs, Strides ks, Strides vs, Strides os, int Lq,
         int Lkv, int H, float scale) {
  using S = Fwd<HD>;
  constexpr int LD = S::LD, BK = S::BK, NT = S::NT, STAGES = S::STAGES, WC = S::WC;
  constexpr int NTW = NT / WC;      // score n-tiles a warp computes
  constexpr int ND = HD / 8 / WC;   // n-tiles of o a warp holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][LD]
  float* ring = Qs + BQ * LD;                       // [STAGES][K, V][BK][LD]
  float* kin = ring + STAGES * 2 * S::KV;           // [STAGES][BK]  the keys' bias
  float* X = kin + STAGES * BK;                     // [NT][BQ / 16][32][4] (WC = 2)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, hk = warp >> 2;
  const int r0 = rg * 16;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias ? bias + (long long)b * Lkv : nullptr;
  const int n_kv = (Lkv + BK - 1) / BK;

  auto load = [&](int st, int t) {
    float* kt = ring + st * 2 * S::KV;
    copy_rows32<LD, HD, S::THREADS>(kt, kb, ks.r, t * BK, BK, Lkv, tid);
    copy_rows32<LD, HD, S::THREADS>(kt + S::KV, vb, vs.r, t * BK, BK, Lkv, tid);
    chunked::copy_key_info<BK>(kin + st * BK, biasb, t * BK, Lkv, q, tid);
  };
  copy_rows32<LD, HD, S::THREADS>(Qs, q + b * qs.b + h * qs.h, qs.r, q0, BQ, Lq, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_kv) load(t, t);
    cp_async_commit();
  }

  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of the warp
  float l_run[2] = {0.f, 0.f};          // this thread's columns' share

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and Q) has landed ...
    __syncthreads();              // ... for every thread; tile j - 1's stage is free
    const int pre = j + STAGES - 1;
    if (pre < n_kv) load(pre % STAGES, pre);
    cp_async_commit();
    const int st = j % STAGES;
    const float* kt = ring + st * 2 * S::KV;
    const float* vt = kt + S::KV;
    const float* bt = kin + st * BK;
    const int k0 = j * BK;

    // S = Q K^T (with WC = 2: the warp's n-tiles, exchanged)
    float s[NT][4] = {};
    if constexpr (WC == 1) {
      scores32<LD, HD, NT, RUN>(s, Qs, kt, r0, lane);
    } else {
      float own[NTW][4] = {};
      scores32<LD, HD, NTW, RUN>(own, Qs, kt + hk * NTW * 8 * LD, r0, lane);
      put_x(X, own, hk * NTW, rg, lane);
      __syncthreads();
      get_x(s, X, rg, lane);
    }
    // score with both roundings, keys past Lkv out; the running max of rows
    // g (e < 2) and g + 8 (e >= 2): every tile holds key k0 < Lkv
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        s[n][e] = chunked::tc_score<false>(s[n][e], scale, bt[c], 0, k0 + c, Lkv);
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
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
    // o += P V, the warp's columns
    frag_product32<LD, NT, ND, RUN>(oacc, s, vt + hk * ND * 8, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  float* ob = o + b * os.b + h * os.h + hk * ND * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= Lq) continue;
    // all-masked rows have l == 0: zeros rather than NaN
    const float den = l_run[i] == 0.f ? 1.f : l_run[i];
    float* orow = ob + row * os.r;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t4) =
          make_float2(oacc[n][2 * i] / den, oacc[n][2 * i + 1] / den);
    if (m_out != nullptr && hk == 0 && t4 == 0) {
      const size_t r = ((size_t)b * Lq + row) * H + h;
      m_out[r] = m_run[i];
      l_out[r] = l_run[i];
    }
  }
}

// ------------------------------------------------------ backward over rows --

template <int HD>
struct Rows {
  static constexpr int WC = HD > 128 ? 2 : 1;  // warps sharing a row group
  static constexpr int THREADS = 128 * WC;
  static constexpr int BK = HD <= 64 ? 32 : 16;  // keys of a key tile
  static constexpr int NT = BK / 8;
  static constexpr int STAGES = HD <= 64 ? 3 : 2;
  static constexpr int LD = HD + 4;
  static constexpr int PL = BK + 4;   // padded row of the p / ds tiles [BQ][PL]
  static constexpr int KV = BK * LD;  // floats of one K or V tile
  static constexpr int XF = WC > 1 ? NT * (BQ / 16) * 32 * 4 : 0;  // S's (and dP's) exchange
  static constexpr size_t bytes(bool dkv) {
    return (size_t)(2 * BQ * LD + (dkv ? 2 * BQ * PL : 0) + 2 * XF + STAGES * (2 * KV + BK)) *
           sizeof(float);
  }
  // dk / dv: the warps split (dv or dk) x 16-key groups x column parts
  static constexpr int KG = BK / 16;
  static constexpr int CP = THREADS / 32 / (2 * KG);
  static constexpr int CWD = HD / CP;  // columns of a part
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 256, "head_dim");
  static_assert(CP >= 1 && CWD % 8 == 0, "the dk / dv parts");
  static_assert(bytes(true) <= SMEM_MAX, "shared memory of one block");
};

// dv (is_dk false) or dk of the tile's keys kc .. kc + 15, columns c0 .. c0
// + 8 G, over the q tile's 64 rows, from p or ds (X) and dO or Q (B):
// written at once (part null) or as this q tile's float32 partial
template <int LD, int PL, int G>
__device__ __forceinline__ void dkv_part(const float* X, const float* B, int kc, int c0, bool is_dk,
                                         int k0, int qt, int b, int h, int B_, int H, int Lkv,
                                         int HD, float* dk, float* dv, float* part,
                                         const BwdStrides& st, int lane) {
  float acc[G][4] = {};
  key_product32<LD, PL, BQ, G, RUN>(acc, X, kc, B + c0, lane);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + kc + g + 8 * hf;
    if (key >= Lkv) continue;
#pragma unroll
    for (int n = 0; n < G; ++n) {
      const int col = c0 + n * 8 + 2 * t4;
      const float2 x = make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
      if (part != nullptr) {
        const long long at =
            ((((long long)(qt * 2 + is_dk) * B_ + b) * H + h) * Lkv + key) * HD + col;
        *reinterpret_cast<float2*>(part + at) = x;
      } else {
        float* out = is_dk ? dk + b * st.dk.b + h * st.dk.h + key * st.dk.r
                           : dv + b * st.dv.b + h * st.dv.h + key * st.dv.r;
        *reinterpret_cast<float2*>(out + col) = x;
      }
    }
  }
}

// The backward over the key tiles of one 64-row q tile of one (batch, head)
// in one pass: per key tile S = Q K^T and dP = dO V^T (with WC = 2 each
// warp of a pair one half of the n-tiles, exchanged), p = exp(score - m) /
// l and ds = p (dp - dsum) scale in fp32 registers, dq += ds K for the
// warp's columns with dq in registers over the pass.  With DKV (B14, B14p)
// p and ds go to shared memory and dv = p^T dO and dk = ds^T Q of the
// tile's keys are written at once (part null: one q tile) or as float32
// partials [n_qt][dk, dv][B][H][Lkv][HD] to part.  CAUSAL (B7b's dq, no
// DKV): keys after a row or with pad mask 0 dead, the q tiles longest
// first, a warp whose rows all lie before the tile's first key skips it.
template <int HD, bool CAUSAL, bool DKV>
__global__ void __launch_bounds__(Rows<HD>::THREADS)
bwd_rows_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bm,
              const float* __restrict__ dout, const float* __restrict__ m_in,
              const float* __restrict__ l_in, const float* __restrict__ dsum_in,
              float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
              float* __restrict__ part, BwdStrides st, int Lq, int Lkv, int H, int group,
              float scale) {
  using S = Rows<HD>;
  constexpr int LD = S::LD, PL = S::PL, BK = S::BK, NT = S::NT, STAGES = S::STAGES, WC = S::WC;
  constexpr int NTW = NT / WC;     // score n-tiles a warp computes
  constexpr int ND = HD / 8 / WC;  // n-tiles of dq a warp holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][LD]
  float* dOs = Qs + BQ * LD;                        // [BQ][LD]
  float* Ps = dOs + BQ * LD;                        // [BQ][PL]  p (DKV)
  float* dSs = Ps + (DKV ? BQ * PL : 0);            // [BQ][PL]  ds (DKV)
  float* X = dSs + (DKV ? BQ * PL : 0);             // [S, dP][NT][BQ / 16][32][4] (WC = 2)
  float* ring = X + 2 * S::XF;                      // [STAGES][K, V][BK][LD]
  float* kin = ring + STAGES * 2 * S::KV;           // [STAGES][BK]  bias or pad mask

  const int n_qt = (Lq + BQ - 1) / BQ;
  // causal: longest rows first (the last q tiles visit the most key tiles)
  const int qt = CAUSAL ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, hk = warp >> 2;
  const int r0 = rg * 16;
  const int kh = h / group;
  const float* kb = k + b * st.k.b + kh * st.k.h;
  const float* vb = v + b * st.v.b + kh * st.v.h;
  const float* bmb = bm ? bm + (long long)b * Lkv : nullptr;
  const int n_kv = CAUSAL ? (min(q0 + BQ, Lq) - 1) / BK + 1 : (Lkv + BK - 1) / BK;

  auto load = [&](int stg, int t) {
    float* kt = ring + stg * 2 * S::KV;
    copy_rows32<LD, HD, S::THREADS>(kt, kb, st.k.r, t * BK, BK, Lkv, tid);
    copy_rows32<LD, HD, S::THREADS>(kt + S::KV, vb, st.v.r, t * BK, BK, Lkv, tid);
    chunked::copy_key_info<BK>(kin + stg * BK, bmb, t * BK, Lkv, q, tid);
  };
  copy_rows32<LD, HD, S::THREADS>(Qs, q + b * st.q.b + h * st.q.h, st.q.r, q0, BQ, Lq, tid);
  copy_rows32<LD, HD, S::THREADS>(dOs, dout + b * st.dout.b + h * st.dout.h, st.dout.r, q0, BQ, Lq,
                            tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_kv) load(t, t);
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

  float dqacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[n][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and Q, dO) has landed ...
    __syncthreads();              // ... for every thread; tile j - 1's stage, p and ds are free
    const int pre = j + STAGES - 1;
    if (pre < n_kv) load(pre % STAGES, pre);
    cp_async_commit();
    const int stg = j % STAGES;
    const float* kt = ring + stg * 2 * S::KV;
    const float* vt = kt + S::KV;
    const float* bt = kin + stg * BK;
    const int k0 = j * BK;
    // causal: a warp whose rows all lie before the tile's first key skips
    // it (both warps of a pair alike)
    const bool active = !CAUSAL || k0 <= q0 + r0 + 15;

    float s[NT][4] = {}, dp[NT][4] = {};
    if constexpr (WC == 1) {
      if (active) {
        scores32<LD, HD, NT, RUN>(s, Qs, kt, r0, lane);
        scores32<LD, HD, NT, RUN>(dp, dOs, vt, r0, lane);
      }
    } else {
      if (active) {
        float own_s[NTW][4] = {}, own_dp[NTW][4] = {};
        scores32<LD, HD, NTW, RUN>(own_s, Qs, kt + hk * NTW * 8 * LD, r0, lane);
        scores32<LD, HD, NTW, RUN>(own_dp, dOs, vt + hk * NTW * 8 * LD, r0, lane);
        put_x(X, own_s, hk * NTW, rg, lane);
        put_x(X + S::XF, own_dp, hk * NTW, rg, lane);
      }
      __syncthreads();
      if (active) {
        get_x(s, X, rg, lane);
        get_x(dp, X + S::XF, rg, lane);
      }
    }

    // p = exp(score - m) / l (0 for dead pairs and rows past Lq), ds = p (dp
    // - dsum) scale, kept in dp; with DKV the warp's n-tiles of both to
    // shared memory
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t4 + e;
          const float sc = chunked::tc_score<CAUSAL>(s[n][2 * r + e], scale, bt[col],
                                                     q0 + r0 + g + 8 * r, k0 + col, Lkv);
          pe[e] = active && row_ok[r] && sc != -INFINITY ? expf(sc - mr[r]) / lr[r] : 0.f;
          dp[n][2 * r + e] = pe[e] * (dp[n][2 * r + e] - dsr[r]) * scale;
        }
        if (DKV && (WC == 1 || n / NTW == hk)) {
          const int at = (r0 + g + 8 * r) * PL + n * 8 + 2 * t4;
          *reinterpret_cast<float2*>(Ps + at) = make_float2(pe[0], pe[1]);
          *reinterpret_cast<float2*>(dSs + at) = make_float2(dp[n][2 * r], dp[n][2 * r + 1]);
        }
      }
    if (active) frag_product32<LD, NT, ND, RUN>(dqacc, dp, kt + hk * ND * 8, lane);  // dq += ds K
    if constexpr (DKV) {
      __syncthreads();  // p and ds of every row written
      // warp w: dv (the first half of the warps) or dk of the tile's 16-key
      // group kg and column part cp, over the q tile's 64 rows
      constexpr int NDC = S::CWD / 8;  // n-tiles of a part
      const int half = S::THREADS / 64;
      const bool is_dk = warp >= half;
      const int u = warp % half;
      const int kc = (u % S::KG) * 16, c0 = (u / S::KG) * S::CWD;
      const float* X_ = is_dk ? dSs : Ps;
      const float* B_ = is_dk ? Qs : dOs;
#pragma unroll
      for (int n0 = 0; n0 + 4 <= NDC; n0 += 4)
        dkv_part<LD, PL, 4>(X_, B_, kc, c0 + n0 * 8, is_dk, k0, qt, b, h, B, H, Lkv, HD, dk, dv,
                            part, st, lane);
      if constexpr (NDC % 4 != 0)
        dkv_part<LD, PL, NDC % 4>(X_, B_, kc, c0 + NDC / 4 * 32, is_dk, k0, qt, b, h, B, H, Lkv,
                                  HD, dk, dv, part, st, lane);
    }
  }
  cp_async_wait<0>();

  float* dqb = dq + b * st.dq.b + h * st.dq.h + hk * ND * 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    float* drow = dqb + (q0 + r0 + g + 8 * r) * st.dq.r;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(drow + n * 8 + 2 * t4) =
          make_float2(dqacc[n][2 * r], dqacc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------- B7b's dk / dv (keys) --

template <int HD>
struct Keys {
  static constexpr int THREADS = 256;            // 8 warps
  static constexpr int BKV = 32;                 // keys of a block
  static constexpr int TQ = 32;                  // query rows of a q tile
  static constexpr int STAGES = HD <= 64 ? 3 : 2;
  static constexpr int LD = HD + 4;
  static constexpr int PL = BKV + 4;  // padded row of the p / ds tiles [TQ][PL]
  static constexpr int KG = BKV / 16;  // 16-key groups
  static constexpr int CP = 4 / KG;    // column parts of dk (and of dv)
  static constexpr int CWD = HD / CP;  // columns of a part
  static constexpr int NPW = BKV / 8 / 4;  // key n-tiles of a warp's score block
  // a stage: Q and dO [TQ][LD], the rows' m, l, dsum [3][TQ]
  static constexpr int STAGE = 2 * TQ * LD + 3 * TQ;
  static constexpr size_t BYTES =
      (size_t)(2 * BKV * LD + BKV + 1 + 2 * TQ * PL + STAGES * STAGE) * sizeof(float);
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 256, "head_dim");
  static_assert(BKV == 32 && CWD % 8 == 0, "a warp's ballot of the keys; the dk / dv parts");
  static_assert(BYTES <= SMEM_MAX, "shared memory of one block");
};

// B7b's dk and dv for one (BKV-key tile, key head, batch): the group's
// query heads and the 32-row q tiles from the diagonal on stream through the
// ring; per q tile warp w computes S = Q K^T and dP = dO V^T for rows 16 (w
// % 2) .. and key n-tiles NPW (w / 2) .., writes p and ds ([row][key]) to
// shared memory; then warps 0-3 take dv += p^T dO and warps 4-7 dk += ds^T
// Q for 16-key group (w % 4) % KG and column part (w % 4) / KG, each q
// tile's product summed from zero and added to the registers.
template <int HD>
__global__ void __launch_bounds__(Keys<HD>::THREADS)
bwd_keys_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ dout, const float* __restrict__ m_in,
              const float* __restrict__ l_in, const float* __restrict__ dsum_in,
              float* __restrict__ dk, float* __restrict__ dv, BwdStrides st, int L, int Hq,
              int group, float scale) {
  using S = Keys<HD>;
  constexpr int LD = S::LD, PL = S::PL, BKV = S::BKV, TQ = S::TQ, STAGES = S::STAGES;
  constexpr int NPW = S::NPW, NDC = S::CWD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [BKV][LD]
  float* Vs = Ks + BKV * LD;                        // [BKV][LD]
  float* Ps = Vs + BKV * LD;                        // [TQ][PL]  p
  float* dSs = Ps + TQ * PL;                        // [TQ][PL]  ds
  float* ring = dSs + TQ * PL;                      // [STAGES][Q, dO [TQ][LD], m, l, dsum [TQ]]
  float* kin = ring + STAGES * S::STAGE;            // [BKV]  the pad mask
  unsigned* live = reinterpret_cast<unsigned*>(kin + BKV);  // the live keys' bits

  const int kt = blockIdx.x;  // the first key tiles are seen by the most q tiles
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float* kb = k + b * st.k.b + kvh * st.k.h;
  const float* vb = v + b * st.v.b + kvh * st.v.h;
  const float* mb = mask + (long long)b * L;
  float* dkb = dk + b * st.dk.b + kvh * st.dk.h;
  float* dvb = dv + b * st.dv.b + kvh * st.dv.h;

  if (warp == 0) {
    const unsigned bits = __ballot_sync(0xffffffffu, k0 + lane < L && mb[k0 + lane] != 0.f);
    if (lane == 0) *live = bits;
  }
  __syncthreads();
  if (*live == 0u) {  // every key of the tile is padding: no gradient
    for (int e = tid; e < BKV * HD; e += S::THREADS) {
      const int r = e / HD, c = e % HD;
      const int key = k0 + r;
      if (key >= L) continue;
      dkb[key * st.dk.r + c] = 0.f;
      dvb[key * st.dv.r + c] = 0.f;
    }
    return;
  }

  copy_rows32<LD, HD, S::THREADS>(Ks, kb, st.k.r, k0, BKV, L, tid);
  copy_rows32<LD, HD, S::THREADS>(Vs, vb, st.v.r, k0, BKV, L, tid);
  chunked::copy_key_info<BKV>(kin, mb, k0, L, q, tid);

  // iteration i: query head kvh * group + i / n_qt, q tile k0 / TQ + i % n_qt
  const int qt0 = k0 / TQ;
  const int n_qt = (L + TQ - 1) / TQ - qt0;
  const int n_it = group * n_qt;
  auto load = [&](int stg, int i) {
    const int h = kvh * group + i / n_qt;
    const int q0 = (qt0 + i % n_qt) * TQ;
    float* qs = ring + stg * S::STAGE;
    float* os = qs + TQ * LD;
    float* stats = os + TQ * LD;  // m, l, dsum [3][TQ]
    copy_rows32<LD, HD, S::THREADS>(qs, q + b * st.q.b + h * st.q.h, st.q.r, q0, TQ, L, tid);
    copy_rows32<LD, HD, S::THREADS>(os, dout + b * st.dout.b + h * st.dout.h, st.dout.r, q0, TQ, L,
                              tid);
    if (tid < 3 * TQ) {
      const int which = tid / TQ, r = tid % TQ;
      const int row = q0 + r;
      const bool ok = row < L;  // rows past L: m = l = dsum = 0 (masked below)
      const float* src = which == 0 ? m_in : which == 1 ? l_in : dsum_in;
      cp_async_4(smem_addr(stats + tid), src + ((size_t)b * L + (ok ? row : 0)) * Hq + h, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_it) load(i, i);
    cp_async_commit();  // K, V and the mask ride with the first group
  }

  // the warp's score block: rows 16 rg .., keys 8 NPW nb ..
  const int rg = warp & 1, nb = (warp >> 1) * NPW;
  // its dv (warps 0-3) or dk (4-7) part: keys kc .. kc + 15, columns c0 ..
  const bool is_dk = warp >= 4;
  const int kc = ((warp & 3) % S::KG) * 16, c0 = ((warp & 3) / S::KG) * S::CWD;
  float acc[NDC][4];
#pragma unroll
  for (int n = 0; n < NDC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<STAGES - 2>();  // stage i (and K, V) has landed ...
    __syncthreads();              // ... for every thread; stage i - 1, p and ds are free
    if (i + STAGES - 1 < n_it) load((i + STAGES - 1) % STAGES, i + STAGES - 1);
    cp_async_commit();
    const int q0 = (qt0 + i % n_qt) * TQ;
    const float* qs = ring + (i % STAGES) * S::STAGE;
    const float* os = qs + TQ * LD;
    const float* ms = os + TQ * LD;
    const float* ls = ms + TQ;
    const float* dsums = ls + TQ;

    // S and dP of the warp's block; a block whose keys all lie after its
    // rows is dead (p = ds = 0)
    const bool active = k0 + nb * 8 <= q0 + rg * 16 + 15;
    float s[NPW][4] = {}, dp[NPW][4] = {};
    if (active) {
      scores32<LD, HD, NPW, RUN>(s, qs, Ks + nb * 8 * LD, rg * 16, lane);
      scores32<LD, HD, NPW, RUN>(dp, os, Vs + nb * 8 * LD, rg * 16, lane);
    }
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = rg * 16 + g + 8 * r;  // the row within the q tile
        const int row = q0 + rr;
        const float lv = ls[rr];
        float pe[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = (nb + n) * 8 + 2 * t4 + e;  // within the tile
          const float sc =
              chunked::tc_score<true>(s[n][2 * r + e], scale, kin[key], row, k0 + key, L);
          pe[e] = active && row < L && sc != -INFINITY
                      ? expf(sc - ms[rr]) / (lv == 0.f ? 1.f : lv)
                      : 0.f;
          ds[e] = pe[e] * (dp[n][2 * r + e] - dsums[rr]) * scale;
        }
        const int at = rr * PL + (nb + n) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(Ps + at) = make_float2(pe[0], pe[1]);
        *reinterpret_cast<float2*>(dSs + at) = make_float2(ds[0], ds[1]);
      }
    __syncthreads();  // p and ds of the q tile written

    const float* X_ = is_dk ? dSs : Ps;
    const float* B_ = (is_dk ? qs : os) + c0;
#pragma unroll
    for (int n0 = 0; n0 + 4 <= NDC; n0 += 4) {
      float t[4][4] = {};
      key_product32<LD, PL, TQ, 4, RUN>(t, X_, kc, B_ + n0 * 8, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] += t[n][e];
    }
    if constexpr (NDC % 4 != 0) {
      constexpr int R = NDC % 4, N0 = NDC / 4 * 4;
      float t[R][4] = {};
      key_product32<LD, PL, TQ, R, RUN>(t, X_, kc, B_ + N0 * 8, lane);
#pragma unroll
      for (int n = 0; n < R; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[N0 + n][e] += t[n][e];
    }
  }
  cp_async_wait<0>();

  float* outb = is_dk ? dkb : dvb;
  const long long rs = is_dk ? st.dk.r : st.dv.r;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + kc + g + 8 * hf;
    if (key >= L) continue;
    float* orow = outb + key * rs + c0;
#pragma unroll
    for (int n = 0; n < NDC; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t4) =
          make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
  }
}

// ----------------------------------------------------------------- launch --

cudaError_t cross_fwd(const void* q, const void* k, const void* v, const float* bias, void* o,
                      float* m, float* l, Strides qs, Strides ks, Strides vs, Strides os, int B,
                      int H, int Lq, int Lkv, int head_dim, float scale, cudaStream_t stream) {
  return with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    constexpr size_t smem = Fwd<HD>::BYTES;
    const cudaError_t err = cudaFuncSetAttribute(
        fwd_tf32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    fwd_tf32<HD><<<dim3((Lq + BQ - 1) / BQ, H, B), Fwd<HD>::THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(o), m, l, qs, ks, vs, os, Lq,
        Lkv, H, scale);
    return cudaGetLastError();
  });
}

template <int HD, bool CAUSAL, bool DKV>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const float* bm,
                        const void* dout, const float* m, const float* l, const float* dsum,
                        void* dq, void* dk, void* dv, float* part, const BwdStrides& st, int B,
                        int H, int group, int Lq, int Lkv, float scale, cudaStream_t stream) {
  const int n_qt = (Lq + BQ - 1) / BQ;
  if ((DKV && n_qt > 1) != (part != nullptr)) return cudaErrorInvalidValue;
  constexpr size_t smem = Rows<HD>::bytes(DKV);
  cudaError_t err = cudaFuncSetAttribute(bwd_rows_tf32<HD, CAUSAL, DKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  float* dkt = static_cast<float*>(dk);
  float* dvt = static_cast<float*>(dv);
  bwd_rows_tf32<HD, CAUSAL, DKV><<<dim3(n_qt, H, B), Rows<HD>::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), bm,
      static_cast<const float*>(dout), m, l, dsum, static_cast<float*>(dq), dkt, dvt, part, st, Lq,
      Lkv, H, group, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const long long n = 2ll * B * H * Lkv * HD;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  chunk_dkv_sum<float><<<blocks, 256, 0, stream>>>(part, dkt, dvt, st.dk, st.dv, n_qt, B, H, Lkv,
                                                   HD, HD);
  return cudaGetLastError();
}

cudaError_t cross_bwd(const void* q, const void* k, const void* v, const float* bias,
                      const void* dout, const float* m, const float* l, const float* dsum,
                      void* dq, void* dk, void* dv, float* part, const BwdStrides& st, int B,
                      int H, int Lq, int Lkv, int head_dim, float scale, cudaStream_t stream) {
  return with_head_dim(head_dim, [&](auto hd) {
    return launch_rows<decltype(hd)::value, false, true>(q, k, v, bias, dout, m, l, dsum, dq, dk,
                                                         dv, part, st, B, H, 1, Lq, Lkv, scale,
                                                         stream);
  });
}

cudaError_t causal_dq(const void* q, const void* k, const void* v, const float* mask,
                      const void* dout, const float* m, const float* l, const float* dsum,
                      void* dq, const BwdStrides& st, int B, int L, int Hq, int Hkv,
                      int head_dim, float scale, cudaStream_t stream) {
  return with_head_dim(head_dim, [&](auto hd) {
    return launch_rows<decltype(hd)::value, true, false>(q, k, v, mask, dout, m, l, dsum, dq,
                                                         nullptr, nullptr, nullptr, st, B, Hq,
                                                         Hq / Hkv, L, L, scale, stream);
  });
}

cudaError_t causal_dkv(const void* q, const void* k, const void* v, const float* mask,
                       const void* dout, const float* m, const float* l, const float* dsum,
                       void* dk, void* dv, const BwdStrides& st, int B, int L, int Hq, int Hkv,
                       int head_dim, float scale, cudaStream_t stream) {
  return with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    constexpr size_t smem = Keys<HD>::BYTES;
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_keys_tf32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    bwd_keys_tf32<HD><<<dim3((L + Keys<HD>::BKV - 1) / Keys<HD>::BKV, Hkv, B),
                        Keys<HD>::THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<const float*>(dout), m, l, dsum,
        static_cast<float*>(dk), static_cast<float*>(dv), st, L, Hq, Hq / Hkv, scale);
    return cudaGetLastError();
  });
}

}  // namespace tf32
