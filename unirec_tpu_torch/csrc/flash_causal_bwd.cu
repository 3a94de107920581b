// Causal grouped-query flash-attention backward for Hopper (sm_90a): kernel B7b.
//
// Replaces unirec_tpu/ops/flash_causal_vjp.py::_bwd, its two Pallas kernels
// _dq_kernel (dq) and _dkv_kernel (dk, dv), the backward of
// flash_causal_self_attention that the joint trainer takes with
// flash_vjp_attention.  Flash-2 recompute: the probabilities are rebuilt
// tile by tile from the forward's saved per-(row, head) max m and sum l
// (kernel K1, flash_causal_fwd.cu), kept apart and never folded into a
// logsumexp, exactly as the JAX kernels do:
//   p  = exp(s - m) / (l == 0 ? 1 : l),  s = q k^T / sqrt(hd), masked -> p = 0
//   dp = dO v^T,  ds = p (dp - dsum) / sqrt(hd),  dsum = rowsum(dO * O)
//   dq = ds k,  dk = ds^T q,  dv = p^T dO  (dk, dv summed over the GQA group)
// dsum is computed by the caller in plain torch, as JAX computes it in XLA.
//
// Layout as K1: merged heads, K/V un-repeated.
//   q, dO, dq   [B, L, Hq  * HD]  (float or bf16; dq in the same type)
//   k, v, dk, dv [B, L, Hkv * HD]
//   mask        [B, L]  float, 0 = padded key (gets no gradient)
//   m, l, dsum  [B, L, Hq]  float
// Head dims: every multiple of 16 up to 128, and 256 (head_dim.cuh); the
// wrapper zero-pads any other head dim up to 256 to the next instance and
// passes the softmax scale of the true one (above 256: the chunked form of
// flash_chunked.cuh, chunks of 256).  At 256 the bf16 dq kernel holds 64
// slots in 4 warps (Q, dO and the ring take 202,752 bytes of shared memory).
//
// Two kernels, deterministic and without atomics, as the JAX design: a TPU
// grid runs in order and carries a sum in scratch, a Hopper grid does not, so
// each output is owned by one block that loops over what it sums, in a fixed
// order.  The bits are the same from run to run.
//
// What bounds it: at the joint training shape (B=8, L=512, Hq=16, Hkv=8,
// HD=128) the causal pairs of the five score-sized products (S, dP and dq in
// the dq kernel; S^T, dP^T, dv and dk in the dk/dv kernel: seven in all) are
// about 2.2 GFLOP each, against ~70 MB of q/k/v/dO and gradient traffic per
// kernel: at the bf16 tensor-core peak the arithmetic takes 7-9 us, the
// bytes about 20 us, so each kernel is bound by bytes and loses the rest to
// latency.
//
// bf16 design: FlashAttention-2 on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), tiles bf16 in shared memory with rows padded by 16 bytes (no
// ldmatrix bank conflicts), 16-byte cp.async copies into a two-stage ring.
//   dq kernel (flash_causal_bwd_dq_tc): one block of 8 warps per (batch, q
//     tile, pair of query heads of one GQA group), 2 heads x 64 rows (1 x 128
//     when the group is odd), each warp 16 rows.  Q and dO stay in shared
//     memory; K/V tiles stream through the ring, tiles above the diagonal and
//     key tiles that are all padding are never loaded, a warp skips a tile
//     whose keys all lie after its rows.  Per tile: S = Q K^T and dP = dO V^T
//     on tensor cores; p = exp(S scale - m) / l and ds = p (dP - dsum) scale
//     in fp32 registers in the accumulator layout; ds rounded to bf16 in
//     registers is the A fragment of dq += ds K (K via ldmatrix.trans).
//   dk/dv kernel (flash_causal_bwd_dkv_tc): one block of 8 warps per (batch,
//     64-key tile, KV head) that loops over its group's query heads and over
//     the q tiles from the diagonal on, Q, dO and the rows' m, l and dsum
//     streaming through the ring (4-byte cp.async for the strided stats).
//     Per q tile: each warp computes a 16-key x 32-row block of S^T = K Q^T
//     and dP^T = V dO^T, and writes p^T and ds^T as bf16 to shared memory;
//     then warps 0-3 take dv += p^T dO and warps 4-7 dk += ds^T Q for 16 keys
//     each over the full head dim (dO and Q via ldmatrix.trans).  A key tile
//     that is all padding writes exact zeros and returns.
//   The products see bf16-rounded p and ds; the fp32 p is what the softmax
//   state (m, l) normalises, as in K1.  Up to HD 32, ds enters dq += ds K
//   and dk += ds^T Q as two bf16 terms (hi = bf16(ds), lo = bf16(ds - hi)):
//   a row of 16 or 32 lanes has too few components for one rounding of ds,
//   which took dq's row cosine below 0.9999 at head dim 8.
//   wgmma and TMA are the next step, as for K1 (flash_causal_fwd.cu).
//
// fp32 design (HD <= 256, flash_tf32.cu; above it dq in the chunked form's
// 3xTF32 cluster kernel, flash_chunked_cluster.cuh, and dk / dv scalar):
// plain TF32 on tensor cores breaks the 1e-5 fp32 gates, so every product
// runs in 3xTF32 (each float32 operand split into tf32 big + small, three
// mma.sync.m16n8k8 a step, each short run of steps summed from zero and
// added by an fp32 add).  dq: bwd_rows_tf32 with CAUSAL, one block
// per (64-row q tile, query head, batch), longest rows first, 16-key tiles
// at hd 128 (two blocks an SM).  dk / dv: bwd_keys_tf32, one block of 8
// warps per (32-key tile, key head, batch; two blocks an SM at hd 128) over
// the group's query heads and the 32-row q tiles from the diagonal on, dk
// and dv in registers over the loop, an all-padding key tile written as
// zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "causal_tiles.cuh"
#include "flash_chunked.cuh"
#include "flash_tf32.cuh"
#include "head_dim.cuh"
#include "ptx_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BT = 64;  // rows of a q tile and of a kv tile

// ------------------------------------------------- bf16, tensor cores ------

constexpr int TC_THREADS = 256;  // 8 warps (the dk/dv kernel; the dq kernel's below)
constexpr int STAGES = 2;        // the ring
constexpr int PT_LD = BT + 8;    // padded bf16 row of the p^T / ds^T tiles

template <int HD>
struct TcBwd {
  static constexpr int LD = HD + 8;  // padded bf16 row (odd multiple of 16 bytes)
  static constexpr int TILE = BT * LD;
  // dq kernel: 2 heads x 64 rows or 1 head x 128 rows (8 warps); at HD 256
  // half that (4 warps), so that Q, dO and the ring fit in shared memory
  static constexpr int SLOTS = HD > 128 ? 64 : 128;
  static constexpr int DQ_THREADS = 2 * SLOTS;
  // up to HD 32 ds enters dq += ds K and dk += ds^T Q as a bf16 hi + lo
  // pair: a row of 16 or 32 lanes has too few components for one rounding
  // of ds (dq's row cosine fell to 0.99990 at hd 8)
  static constexpr bool SPLIT_DS = HD <= 32;
  // dq kernel: Q and dO [SLOTS][LD], the ring of K and V tiles
  static constexpr size_t DQ_FIXED = (size_t)(2 * SLOTS * LD + STAGES * 2 * TILE) * sizeof(bf16);
  static_assert(DQ_FIXED + 1024 <= 232448, "dq kernel: shared memory of one block");
  // dkv kernel: K and V, the ring of (Q, dO, m / l / dsum), p^T and ds^T
  static constexpr size_t STAGE_BYTES = 2 * TILE * sizeof(bf16) + 3 * BT * sizeof(float);
  static constexpr size_t DKV_BYTES = 2 * TILE * sizeof(bf16) + STAGES * STAGE_BYTES +
                                      (SPLIT_DS ? 3 : 2) * BT * PT_LD * sizeof(bf16) +
                                      sizeof(unsigned long long);
};

template <int HD>
__global__ void __launch_bounds__(TcBwd<HD>::DQ_THREADS)
flash_causal_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ mask,
                       const bf16* __restrict__ dout, const float* __restrict__ m_in,
                       const float* __restrict__ l_in, const float* __restrict__ dsum_in,
                       bf16* __restrict__ dq, int L, int Hq, int Hkv, int nh, float scale) {
  using S = TcBwd<HD>;
  constexpr int LD = S::LD;
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  constexpr int SLOTS = S::SLOTS, THREADS = S::DQ_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [SLOTS][LD]
  bf16* dOs = Qs + SLOTS * LD;                    // [SLOTS][LD]
  bf16* KVs = dOs + SLOTS * LD;                   // [STAGES][K, V][BT][LD]
  const int n_kv_max = (L + BT - 1) / BT;
  unsigned long long* kbits =
      reinterpret_cast<unsigned long long*>(smem_raw + S::DQ_FIXED);  // [n_kv_max]
  int* tiles = reinterpret_cast<int*>(kbits + n_kv_max);               // [n_kv_max + 1]

  const int rows = SLOTS / nh;  // query rows of the block
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h0 = blockIdx.y * nh;
  const int b = blockIdx.z;
  const int kvh = h0 / (Hq / Hkv);  // nh == 2 only when the group is even
  const int q0 = qt * rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int slot0 = warp * 16;        // the warp's 16 slots
  const int h = h0 + slot0 / rows;    // its head
  const int wr0 = q0 + slot0 % rows;  // its first query row
  const size_t q_row = (size_t)Hq * HD;
  const size_t kv_row = (size_t)Hkv * HD;
  const bf16* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const float* mb = mask + (size_t)b * L;
  const int n_kv = (min(q0 + rows, L) - 1) / BT + 1;

  live_tiles(mb, L, n_kv, n_kv_max, kbits, tiles);
  const int n_live = tiles[n_kv_max];

  // Q and dO: slot s is row q0 + s % rows of head h0 + s / rows
  for (int c = tid; c < SLOTS * CH; c += THREADS) {
    const int s = c / CH, ch = c % CH;
    const int row = q0 + s % rows;
    const bool ok = row < L;
    const size_t off =
        ((size_t)b * L + (ok ? row : 0)) * q_row + (size_t)(h0 + s / rows) * HD + ch * 8;
    cp_async_16(smem_addr(Qs + s * LD + ch * 8), q + off, ok);
    cp_async_16(smem_addr(dOs + s * LD + ch * 8), dout + off, ok);
  }
  auto load_kv = [&](int stage, int t) {
    bf16* ks = KVs + stage * 2 * S::TILE;
    bf16* vs = ks + S::TILE;
    for (int c = tid; c < BT * CH; c += THREADS) {
      const int r = c / CH, ch = c % CH;
      const int key = t * BT + r;
      const bool ok = key < L;  // keys past L are zero-filled
      const size_t off = (size_t)(ok ? key : 0) * kv_row + ch * 8;
      cp_async_16(smem_addr(ks + r * LD + ch * 8), kb + off, ok);
      cp_async_16(smem_addr(vs + r * LD + ch * 8), vb + off, ok);
    }
  };
  if (n_live > 0) load_kv(0, tiles[0]);
  cp_async_commit();

  // rows g and g + 8 of the warp: m, 1 / l (l == 0 guarded to 1), dsum
  float mr[2], il[2], dsr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    const size_t r = ((size_t)b * L + row) * Hq + h;
    const float lv = row < L ? l_in[r] : 1.f;
    mr[i] = row < L ? m_in[r] : 0.f;
    il[i] = 1.f / (lv == 0.f ? 1.f : lv);
    dsr[i] = row < L ? dsum_in[r] : 0.f;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_live; ++j) {
    if (j + 1 < n_live) load_kv((j + 1) % STAGES, tiles[j + 1]);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q, dO) has landed
    __syncthreads();
    const int t = tiles[j];
    const int k0 = t * BT;
    if (k0 <= wr0 + 15) {
      const bf16* ks = KVs + (j % STAGES) * 2 * S::TILE;
      const bf16* vs = ks + S::TILE;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t aq[4], ao[4];
        const int arow = (slot0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(aq, smem_addr(Qs + arow));
        ldmatrix_x4(ao, smem_addr(dOs + arow));
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int brow =
              (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, smem_addr(ks + brow));
          ldmatrix_x4(bv, smem_addr(vs + brow));
          mma_16816(s[2 * nj], aq, bk[0], bk[1]);
          mma_16816(s[2 * nj + 1], aq, bk[2], bk[3]);
          mma_16816(dp[2 * nj], ao, bv[0], bv[1]);
          mma_16816(dp[2 * nj + 1], ao, bv[2], bv[3]);
        }
      }
      // p and ds in the accumulator layout; ds overwrites s
      const unsigned long long bits = kbits[t];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t4 + (e & 1);
          const int i = e >> 1;
          const int row = wr0 + g + 8 * i;
          const bool ok = row < L && ((bits >> c) & 1ull) && k0 + c <= row;
          const float p = ok ? __expf(s[n][e] * scale - mr[i]) * il[i] : 0.f;
          s[n][e] = p * (dp[n][e] - dsr[i]) * scale;
        }
      // dq += ds K: ds (bf16; hi and lo with SPLIT_DS) from the fragments, K
      // via ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        uint32_t a[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = s[2 * kk + (r >> 1)] + 2 * (r & 1);
          if constexpr (S::SPLIT_DS)
            split_bf16(x[0], x[1], a[r], lo[r]);
          else
            a[r] = pack_bf16(x[0], x[1]);
        }
#pragma unroll
        for (int nd = 0; nd < HD / 16; ++nd) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, smem_addr(ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                          nd * 16 + (lane >> 4) * 8));
          mma_16816(acc[2 * nd], a, bk[0], bk[1]);
          mma_16816(acc[2 * nd + 1], a, bk[2], bk[3]);
          if constexpr (S::SPLIT_DS) {
            mma_16816(acc[2 * nd], lo, bk[0], bk[1]);
            mma_16816(acc[2 * nd + 1], lo, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage j before tile j + 2 refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    if (row >= L) continue;
    bf16* drow = dq + ((size_t)b * L + row) * q_row + (size_t)h * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_causal_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ mask,
                        const bf16* __restrict__ dout, const float* __restrict__ m_in,
                        const float* __restrict__ l_in, const float* __restrict__ dsum_in,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int Hq, int Hkv,
                        float scale) {
  using S = TcBwd<HD>;
  constexpr int LD = S::LD;
  constexpr int CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BT][LD]
  bf16* Vs = Ks + S::TILE;                        // [BT][LD]
  unsigned char* ring = smem_raw + 2 * S::TILE * sizeof(bf16);  // [STAGES][STAGE_BYTES]
  bf16* Pt = reinterpret_cast<bf16*>(ring + STAGES * S::STAGE_BYTES);  // [BT][PT_LD] p^T
  bf16* dSt = Pt + BT * PT_LD;                                          // [BT][PT_LD] ds^T
  bf16* dSl = dSt + BT * PT_LD;  // [BT][PT_LD] ds^T - bf16(ds^T), with SPLIT_DS
  unsigned long long* kbits =
      reinterpret_cast<unsigned long long*>(dSt + (S::SPLIT_DS ? 2 : 1) * BT * PT_LD);

  // the first kv tiles are seen by the most q tiles: start them first
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kt * BT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kw = (warp & 3) * 16;  // the warp's 16 keys of the tile
  const int half = warp >> 2;      // S^T: rows 32 half ..; dk (1) or dv (0)
  const size_t q_row = (size_t)Hq * HD;
  const size_t kv_row = (size_t)Hkv * HD;
  const bf16* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const float* mb = mask + (size_t)b * L;
  bf16* dkb = dk + (size_t)b * L * kv_row + (size_t)kvh * HD;
  bf16* dvb = dv + (size_t)b * L * kv_row + (size_t)kvh * HD;

  if (warp == 0) {
    const int ka = k0 + lane, kc = ka + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, ka < L && mb[ka] != 0.f);
    const unsigned hi = __ballot_sync(0xffffffffu, kc < L && mb[kc] != 0.f);
    if (lane == 0) *kbits = ((unsigned long long)hi << 32) | lo;
  }
  __syncthreads();
  const unsigned long long bits = *kbits;
  if (bits == 0ull) {  // every key of the tile is padding: no gradient
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int e = tid; e < BT * HD / 2; e += TC_THREADS) {
      const int r = e / (HD / 2), c = 2 * (e % (HD / 2));
      const int key = k0 + r;
      if (key >= L) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key * kv_row + c) = zero;
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key * kv_row + c) = zero;
    }
    return;
  }

  for (int c = tid; c < BT * CH; c += TC_THREADS) {
    const int r = c / CH, ch = c % CH;
    const int key = k0 + r;
    const bool ok = key < L;
    const size_t off = (size_t)(ok ? key : 0) * kv_row + ch * 8;
    cp_async_16(smem_addr(Ks + r * LD + ch * 8), kb + off, ok);
    cp_async_16(smem_addr(Vs + r * LD + ch * 8), vb + off, ok);
  }

  // iteration i: head kvh * group + i / n_qt, q tile kt + i % n_qt
  const int n_qt = (L + BT - 1) / BT - kt;
  const int n_it = group * n_qt;
  auto load_q = [&](int stage, int i) {
    const int h = kvh * group + i / n_qt;
    const int q0 = (kt + i % n_qt) * BT;
    unsigned char* st = ring + stage * S::STAGE_BYTES;
    bf16* qs = reinterpret_cast<bf16*>(st);
    bf16* os = qs + S::TILE;
    float* stats = reinterpret_cast<float*>(os + S::TILE);  // m, l, dsum [3][BT]
    for (int c = tid; c < BT * CH; c += TC_THREADS) {
      const int r = c / CH, ch = c % CH;
      const int row = q0 + r;
      const bool ok = row < L;
      const size_t off = ((size_t)b * L + (ok ? row : 0)) * q_row + (size_t)h * HD + ch * 8;
      cp_async_16(smem_addr(qs + r * LD + ch * 8), q + off, ok);
      cp_async_16(smem_addr(os + r * LD + ch * 8), dout + off, ok);
    }
    if (tid < 3 * BT) {
      const int which = tid / BT, r = tid % BT;
      const int row = q0 + r;
      const bool ok = row < L;  // rows past L: m = l = dsum = 0 (masked below)
      const float* src = which == 0 ? m_in : which == 1 ? l_in : dsum_in;
      cp_async_4(smem_addr(stats + tid), src + ((size_t)b * L + (ok ? row : 0)) * Hq + h, ok);
    }
  };
  load_q(0, 0);
  cp_async_commit();

  float acc[HD / 8][4];  // dv (warps 0-3) or dk (warps 4-7) of the warp's keys
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_it; ++i) {
    if (i + 1 < n_it) load_q((i + 1) % STAGES, i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage i (and K, V) has landed
    __syncthreads();
    const int q0 = (kt + i % n_qt) * BT;
    const unsigned char* st = ring + (i % STAGES) * S::STAGE_BYTES;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* os = qs + S::TILE;
    const float* ms = reinterpret_cast<const float*>(os + S::TILE);
    const float* ls = ms + BT;
    const float* dsums = ls + BT;

    // S^T = K Q^T and dP^T = V dO^T: keys kw .. kw + 15, rows 32 half .. + 31
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      const int arow = (kw + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(ak, smem_addr(Ks + arow));
      ldmatrix_x4(av, smem_addr(Vs + arow));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int brow = (32 * half + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        ldmatrix_x4(bq, smem_addr(qs + brow));
        ldmatrix_x4(bo, smem_addr(os + brow));
        mma_16816(s[2 * np], ak, bq[0], bq[1]);
        mma_16816(s[2 * np + 1], ak, bq[2], bq[3]);
        mma_16816(dp[2 * np], av, bo[0], bo[1]);
        mma_16816(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }
    // p^T and ds^T, rounded to bf16 into shared memory (ds^T as hi + lo with
    // SPLIT_DS)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = kw + g + 8 * hf;  // key within the tile
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 32 * half + n * 8 + 2 * t4 + e;  // row within the q tile
          const int row = q0 + r;
          const bool ok = row < L && ((bits >> c) & 1ull) && k0 + c <= row;
          const float lv = ls[r];
          p[e] = ok ? __expf(s[n][2 * hf + e] * scale - ms[r]) / (lv == 0.f ? 1.f : lv) : 0.f;
          ds[e] = p[e] * (dp[n][2 * hf + e] - dsums[r]) * scale;
        }
        const int at = c * PT_LD + 32 * half + n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(Pt + at) = pack_bf16(p[0], p[1]);
        if constexpr (S::SPLIT_DS)
          split_bf16(ds[0], ds[1], *reinterpret_cast<uint32_t*>(dSt + at),
                     *reinterpret_cast<uint32_t*>(dSl + at));
        else
          *reinterpret_cast<uint32_t*>(dSt + at) = pack_bf16(ds[0], ds[1]);
      }
    __syncthreads();  // p^T and ds^T written

    // dv += p^T dO (warps 0-3), dk += ds^T Q (warps 4-7); B via ldmatrix.trans
    const bf16* as = half ? dSt : Pt;
    const bf16* bs = half ? qs : os;
    const bool lo_too = S::SPLIT_DS && half;  // dk's ds^T - bf16(ds^T)
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const int arow = (kw + (lane & 15)) * PT_LD + kk * 16 + (lane >> 4) * 8;
      uint32_t a[4], lo[4];
      ldmatrix_x4(a, smem_addr(as + arow));
      if (lo_too) ldmatrix_x4(lo, smem_addr(dSl + arow));
#pragma unroll
      for (int nd = 0; nd < HD / 16; ++nd) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, smem_addr(bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                        nd * 16 + (lane >> 4) * 8));
        mma_16816(acc[2 * nd], a, bb[0], bb[1]);
        mma_16816(acc[2 * nd + 1], a, bb[2], bb[3]);
        if (lo_too) {
          mma_16816(acc[2 * nd], lo, bb[0], bb[1]);
          mma_16816(acc[2 * nd + 1], lo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // p^T / ds^T and stage i are free for the next iteration
  }
  cp_async_wait<0>();

  bf16* outb = half ? dkb : dvb;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + kw + g + 8 * hf;
    if (key >= L) continue;
    bf16* orow = outb + (size_t)key * kv_row;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * hf], acc[n][2 * hf + 1]);
  }
}

// ----------------------------------------------------------------- launch --

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const float* mask,
                      const void* dout, const float* m, const float* l, const float* dsum,
                      void* dq, int B, int L, int Hq, int Hkv, float scale, cudaStream_t stream) {
  const size_t smem = TcBwd<HD>::DQ_FIXED + live_tiles_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(flash_causal_bwd_dq_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nh = (Hq / Hkv) % 2 == 0 ? 2 : 1;  // heads per block
  const int rows = TcBwd<HD>::SLOTS / nh;
  dim3 grid((L + rows - 1) / rows, Hq / nh, B);
  flash_causal_bwd_dq_tc<HD><<<grid, TcBwd<HD>::DQ_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, static_cast<const bf16*>(dout), m, l, dsum, static_cast<bf16*>(dq), L, Hq, Hkv, nh,
      scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const float* mask,
                       const void* dout, const float* m, const float* l, const float* dsum,
                       void* dk, void* dv, int B, int L, int Hq, int Hkv, float scale,
                       cudaStream_t stream) {
  const size_t smem = TcBwd<HD>::DKV_BYTES;
  dim3 grid((L + BT - 1) / BT, Hkv, B);
  cudaError_t err = cudaFuncSetAttribute(flash_causal_bwd_dkv_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_causal_bwd_dkv_tc<HD><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, static_cast<const bf16*>(dout), m, l, dsum, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, Hq, Hkv, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int L, int Hq, int Hkv, int dtype) {
  return Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || L <= 0 || dtype < 0 || dtype > 1;
}

// the merged-head strides of q, k, v, dO, dq, dk and dv
chunked::BwdStrides chunked_strides(int L, int Hq, int Hkv, int head_dim) {
  const chunked::Strides qs = chunked::merged(L, Hq, head_dim),
                         ks = chunked::merged(L, Hkv, head_dim);
  return chunked::BwdStrides{qs, ks, ks, qs, qs, ks, ks};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: an instance of head_dim.cuh,
// or above 256 (the chunked form, rows of whole 16-byte pieces;
// cudaErrorInvalidValue otherwise).  scale: the softmax scale, 1 / sqrt of
// the true head dim (the wrapper pads other head dims to an instance).
// splits (dq only): key splits, above one only in the float32 chunked
// cluster form (dqpart: float32 scratch of splits * B * Hq * L * C * 256
// elements, flash_chunked.cuh's launch_bwd_rows; null with one split).
extern "C" int unirec_flash_causal_bwd_dq(const void* q, const void* k, const void* v,
                                          const float* mask, const void* dout,
                                          const float* m, const float* l,
                                          const float* dsum, void* dq, float* dqpart, int B,
                                          int L, int Hq, int Hkv, int head_dim, int dtype,
                                          int splits, float scale, void* stream) {
  if (bad_shape(B, L, Hq, Hkv, dtype) || (splits != 1 && !chunked::is_chunked(head_dim)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked::is_chunked(head_dim)) {
    const chunked::BwdStrides st = chunked_strides(L, Hq, Hkv, head_dim);
    return (int)(dtype == 0
                     ? chunked::launch_bwd_rows<float, true>(q, k, v, mask, dout, m, l, dsum, dq,
                                                             nullptr, nullptr, nullptr, dqpart,
                                                             st, B, Hq, Hq / Hkv, L, L, head_dim,
                                                             splits, scale, s)
                     : chunked::launch_bwd_rows<bf16, true>(q, k, v, mask, dout, m, l, dsum, dq,
                                                            nullptr, nullptr, nullptr, dqpart,
                                                            st, B, Hq, Hq / Hkv, L, L, head_dim,
                                                            splits, scale, s));
  }
  if (dtype == 0)
    return (int)tf32::causal_dq(q, k, v, mask, dout, m, l, dsum, dq,
                                chunked_strides(L, Hq, Hkv, head_dim), B, L, Hq, Hkv, head_dim,
                                scale, s);
  return (int)with_head_dim(head_dim, [&](auto hd) {
    return launch_dq<decltype(hd)::value>(q, k, v, mask, dout, m, l, dsum, dq, B, L, Hq, Hkv,
                                          scale, s);
  });
}

extern "C" int unirec_flash_causal_bwd_dkv(const void* q, const void* k, const void* v,
                                           const float* mask, const void* dout,
                                           const float* m, const float* l,
                                           const float* dsum, void* dk, void* dv,
                                           int B, int L, int Hq, int Hkv, int head_dim,
                                           int dtype, float scale, void* stream) {
  if (bad_shape(B, L, Hq, Hkv, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked::is_chunked(head_dim)) {
    const chunked::BwdStrides st = chunked_strides(L, Hq, Hkv, head_dim);
    return (int)(dtype == 0
                     ? chunked::launch_bwd_keys<float>(q, k, v, mask, dout, m, l, dsum, dk, dv,
                                                       st, B, Hq, Hq / Hkv, L, head_dim, scale,
                                                       s)
                     : chunked::launch_bwd_keys<bf16>(q, k, v, mask, dout, m, l, dsum, dk, dv,
                                                      st, B, Hq, Hq / Hkv, L, head_dim, scale,
                                                      s));
  }
  if (dtype == 0)
    return (int)tf32::causal_dkv(q, k, v, mask, dout, m, l, dsum, dk, dv,
                                 chunked_strides(L, Hq, Hkv, head_dim), B, L, Hq, Hkv, head_dim,
                                 scale, s);
  return (int)with_head_dim(head_dim, [&](auto hd) {
    return launch_dkv<decltype(hd)::value>(q, k, v, mask, dout, m, l, dsum, dk, dv, B, L, Hq,
                                           Hkv, scale, s);
  });
}

// The form a launch takes, for the wrappers' key splits and per-form launch
// counts: kind 0 the forward (K1; above 256 also B13, B14, B14p), 1 the
// backward over rows (B7b's dq, B14 / B14p's one pass), 2 the backward over
// keys (B7b's dk / dv), 3 the cross forward (B13, B14, B14p; kind 0's form
// above 256); dtype 0 float32, 1 bfloat16.  Above 256 flash_chunked.cuh's
// chunked::form: 1 the scalar kernel, 2 the tensor-core kernel, 3 the
// cluster kernel, 4 the float32 3xTF32 cluster kernel
// (flash_chunked_cluster.cuh).  At head dims up to 256: 5 for float32's
// 3xTF32 kernels of kinds 1-3 (flash_tf32.cu), 0 otherwise (bf16's
// tensor-core kernels and K1's float32 forward, not counted).  -1 for a kind
// or dtype out of range.
extern "C" int unirec_chunked_form(int kind, int head_dim, int dtype) {
  if (kind < 0 || kind > 3 || dtype < 0 || dtype > 1) return -1;
  if (!chunked::is_chunked(head_dim)) return dtype == 0 && kind != 0 ? 5 : 0;
  return (int)chunked::form(static_cast<chunked::Kind>(kind == 3 ? 0 : kind),
                            chunked::chunks(head_dim), dtype == 1);
}
