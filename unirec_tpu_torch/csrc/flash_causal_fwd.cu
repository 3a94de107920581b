// Causal grouped-query flash-attention forward for Hopper (sm_90a): kernel K1.
//
// Replaces unirec_tpu/ops/flash_causal_vjp.py::_fwd_kernel (reached through
// flash_causal_self_attention), and with it the stock Pallas TPU
// flash_attention that unirec_tpu/models/qwen3.py calls on deterministic
// forwards: out = softmax(q k^T / sqrt(hd) + causal + key-pad bias) v for
// every query head h, head h reading KV head h / (Hq / Hkv).
//
// Layout: merged heads, as the JAX public entry takes them.
//   q    [B, L, Hq  * HD]  (float or bf16)
//   k, v [B, L, Hkv * HD]  un-repeated
//   mask [B, L]  float, 0 = padded key
//   out  [B, L, Hq  * HD]  same type as q
//   m, l [B, L, Hq]  float, optional (the training forward): per (row, head)
//        the running max of the scaled scores and the softmax denominator,
//        kept apart (never a logsumexp: fp32 swallows log l at the -1e9 mask
//        magnitude), for the backward kernels of flash_causal_bwd.cu
// Masked keys (causal or padded) get probability exactly 0, which is what the
// additive -1e9 bias gives whenever a row has one unmasked key.  The wrapper
// guarantees that by requiring mask[:, 0] != 0 (key 0 is causal for every row).
// Head dims: every multiple of 16 up to 128, and 256 (head_dim.cuh), each
// its own template instance; the wrapper zero-pads any other head dim up to
// 256 to the next instance and passes the softmax scale of the true one;
// above 256 it pads to whole chunks of 256, which the C entry hands to the
// chunked form of flash_chunked.cuh.  At 256 both designs below fit as they are: the bf16 block takes 202,752
// bytes of shared memory and one block an SM, the fp32 block 148,480.
//
// What bounds it: at the serving shape (B=8, L=512, Hq=16, Hkv=8, HD=128) the
// causal pairs of QK^T and PV are ~4.3 GFLOP (about 4.4 us at the bf16
// tensor-core peak) against ~50 MB of q/k/v/o traffic (15 us at 3.35 TB/s):
// the bound is bytes, and what a kernel loses beyond it is latency --
// waiting on loads and on the softmax between the two products.
//
// bf16 design (flash_causal_fwd_tc): FlashAttention-2 on mma.sync.
//   - One block of 8 warps per (batch, q tile, pair of query heads of one GQA
//     group): 2 heads x 64 rows (1 head x 128 rows when the group is odd).
//     Each K/V tile is loaded once for both heads.  Longest rows first.
//   - Q, K and V tiles are bf16 in shared memory, rows padded by 16 bytes so
//     that ldmatrix reads are free of bank conflicts.  K and V stream through
//     a ring of two stages filled by 16-byte cp.async copies: tile t + 1
//     loads while tile t computes.
//   - S = Q K^T and O += P V run on tensor cores (mma.sync.m16n8k16, bf16 in,
//     fp32 accumulate); each warp owns 16 query rows.  P is rounded to bf16
//     in registers (the S accumulator is the A fragment of the second
//     product, ptx_helpers.cuh); V is the B operand via ldmatrix.trans.
//   - Online softmax in fp32 registers in the accumulator layout.  l sums
//     the fp32 p (as the JAX kernel does), so the backward's p = exp(s - m) /
//     l is the normalised fp32 probability; only the PV product sees the
//     bf16-rounded p.
//   - Tiles above the diagonal are not visited, and a warp skips a tile
//     whose keys all lie after its rows.  A key tile whose keys are all
//     padding is skipped before it is loaded: it would leave m, l and the
//     accumulator unchanged (every row has key 0).  The block builds the
//     list of live tiles from the mask with warp ballots.
//   wgmma (64-row warpgroup products with B from shared memory) and TMA are
//   the next step: mma.sync keeps this redesign's fragment logic in one
//   warp, where it could be brought up and checked within one change.
//
// fp32 design (flash_causal_fwd_f32): tensor cores would mean TF32, which
// keeps ~3 decimal digits and breaks the 1e-5 fp32 gates, so fp32 keeps the
// scalar design: 16 x 16 threads, each owning a 4 x 4 block of a 64 x 64
// score tile and a 4 x (HD / 16) block of the output, fp32 FMAs from padded
// shared tiles.  No main path on the card runs fp32 attention.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "causal_tiles.cuh"
#include "flash_chunked.cuh"
#include "head_dim.cuh"
#include "ptx_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BT = 64;  // keys per tile; q rows per block of the fp32 kernel

// ------------------------------------------------------------ fp32, scalar --

constexpr int F32_THREADS = 256;  // 16 x 16 threads

template <int HD>
constexpr size_t f32_smem_bytes() {
  return (size_t)(2 * BT * (HD + 1) + BT * (BT + 1) + BT) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_causal_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int L, int Hq, int Hkv, float scale) {
  constexpr int QS = HD + 1;  // padded row strides (bank-conflict free)
  constexpr int KS = HD + 1;
  constexpr int PS = BT + 1;
  constexpr int OC = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BT][QS]
  float* KVs = Qs + BT * QS;                        // [BT][KS]  K tile, then V tile
  float* Ps = KVs + BT * KS;                        // [BT][PS]  probabilities of this tile
  float* kval = Ps + BT * PS;                       // [BT]      key validity of this tile

  // longest rows first: the last q tiles loop over the most kv tiles
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * BT;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // score cols tx + 16j, output cols tx + 16j
  const size_t q_row = (size_t)Hq * HD;
  const size_t kv_row = (size_t)Hkv * HD;
  const float* qb = q + (size_t)b * L * q_row + (size_t)h * HD;
  const float* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const float* mb = mask + (size_t)b * L;

  for (int e = tid; e < BT * HD; e += F32_THREADS) {
    const int r = e / HD, d = e % HD;
    const int row = q0 + r;
    Qs[r * QS + d] = row < L ? qb[(size_t)row * q_row + d] : 0.f;
  }

  float acc[4][OC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;
  }

  const int last_row = min(q0 + BT, L) - 1;
  const int n_kv = last_row / BT + 1;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // previous tile's V reads are done
    for (int e = tid; e < BT * HD; e += F32_THREADS) {
      const int c = e / HD, d = e % HD;
      const int key = k0 + c;
      KVs[c * KS + d] = key < L ? kb[(size_t)key * kv_row + d] : 0.f;
    }
    if (tid < BT) {
      const int key = k0 + tid;
      kval[tid] = (key < L && mb[key] != 0.f) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = (k0 + c <= row) && kval[c] != 0.f;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // S reads of K done, P written

    for (int e = tid; e < BT * HD; e += F32_THREADS) {
      const int c = e / HD, d = e % HD;
      const int key = k0 + c;
      KVs[c * KS + d] = key < L ? vb[(size_t)key * kv_row + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float pv[4], vv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) vv[j] = KVs[c * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = out + (size_t)b * L * q_row + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < OC; ++j) ob[(size_t)row * q_row + tx + 16 * j] = acc[i][j] * inv;
    if (m_out != nullptr && tx == 0) {  // the 16 threads of a row agree
      const size_t r = ((size_t)b * L + row) * Hq + h;
      m_out[r] = m[i];
      l_out[r] = l[i];
    }
  }
}

// ------------------------------------------------- bf16, tensor cores ------

constexpr int TC_THREADS = 256;  // 8 warps, 16 (head, row) slots each
constexpr int SLOTS = 128;       // 2 heads x 64 rows, or 1 head x 128 rows
constexpr int STAGES = 2;        // K/V ring

template <int HD>
struct TcFwd {
  static constexpr int LD = HD + 8;  // padded bf16 row (odd multiple of 16 bytes)
  static constexpr int Q_ELEMS = SLOTS * LD;
  static constexpr int KV_ELEMS = BT * LD;  // one K or one V tile
  static constexpr size_t FIXED = (size_t)(Q_ELEMS + STAGES * 2 * KV_ELEMS) * sizeof(bf16);
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_causal_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ mask,
                    bf16* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int L, int Hq, int Hkv, int nh, float scale) {
  using S = TcFwd<HD>;
  constexpr int LD = S::LD;
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [SLOTS][LD]
  bf16* KVs = Qs + S::Q_ELEMS;                    // [STAGES][K, V][BT][LD]
  const int n_kv_max = (L + BT - 1) / BT;
  unsigned long long* kbits =
      reinterpret_cast<unsigned long long*>(smem_raw + S::FIXED);  // [n_kv_max]
  int* tiles = reinterpret_cast<int*>(kbits + n_kv_max);           // [n_kv_max + 1]

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
  const int slot0 = warp * 16;             // the warp's 16 slots
  const int h = h0 + slot0 / rows;         // its head
  const int wr0 = q0 + slot0 % rows;       // its first query row
  const size_t q_row = (size_t)Hq * HD;
  const size_t kv_row = (size_t)Hkv * HD;
  const bf16* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const float* mb = mask + (size_t)b * L;
  const int n_kv = (min(q0 + rows, L) - 1) / BT + 1;

  live_tiles(mb, L, n_kv, n_kv_max, kbits, tiles);
  const int n_live = tiles[n_kv_max];

  // Q: slot s is row q0 + s % rows of head h0 + s / rows; rows past L read 0
  for (int c = tid; c < SLOTS * CH; c += TC_THREADS) {
    const int s = c / CH, ch = c % CH;
    const int row = q0 + s % rows;
    const bool ok = row < L;
    const bf16* src = q + ((size_t)b * L + (ok ? row : 0)) * q_row +
                      (size_t)(h0 + s / rows) * HD + ch * 8;
    cp_async_16(smem_addr(Qs + s * LD + ch * 8), src, ok);
  }
  auto load_kv = [&](int stage, int t) {
    bf16* ks = KVs + stage * 2 * S::KV_ELEMS;
    bf16* vs = ks + S::KV_ELEMS;
    for (int c = tid; c < BT * CH; c += TC_THREADS) {
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

  float oacc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};               // this thread's columns' share
  const int rlo = wr0 + g;

  for (int j = 0; j < n_live; ++j) {
    if (j + 1 < n_live) load_kv((j + 1) % STAGES, tiles[j + 1]);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) has landed
    __syncthreads();
    const int t = tiles[j];
    const int k0 = t * BT;
    if (k0 <= wr0 + 15) {  // the warp has a row at or after the tile's first key
      const bf16* ks = KVs + (j % STAGES) * 2 * S::KV_ELEMS;
      const bf16* vs = ks + S::KV_ELEMS;
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(Qs + (slot0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_addr(ks + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                    kk * 16 + ((lane >> 3) & 1) * 8));
          mma_16816(s[2 * nj], a, bk[0], bk[1]);
          mma_16816(s[2 * nj + 1], a, bk[2], bk[3]);
        }
      }
      // mask, scale and the running max of rows g (e < 2) and g + 8 (e >= 2)
      const unsigned long long bits = kbits[t];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t4 + (e & 1);
          const int row = rlo + (e >> 1) * 8;
          const bool ok = ((bits >> c) & 1ull) && k0 + c <= row;
          s[n][e] = ok ? s[n][e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        alpha[i] = (m_new == -INFINITY) ? 1.f : __expf(m_run[i] - m_new);
        m_run[i] = m_new;
        l_run[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[n][e] == -INFINITY ? 0.f : __expf(s[n][e] - m_run[e >> 1]);
          s[n][e] = p;
          l_run[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
      // O += P V: P (bf16) from the S fragments, V via ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < HD / 16; ++nd) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                          nd * 16 + (lane >> 4) * 8));
          mma_16816(oacc[2 * nd], a, bv[0], bv[1]);
          mma_16816(oacc[2 * nd + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage j before tile j + 2 refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rlo + i * 8;
    if (row >= L) continue;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
    bf16* orow = out + ((size_t)b * L + row) * q_row + (size_t)h * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(oacc[n][2 * i] * inv, oacc[n][2 * i + 1] * inv);
    if (m_out != nullptr && t4 == 0) {
      const size_t r = ((size_t)b * L + row) * Hq + h;
      m_out[r] = m_run[i];
      l_out[r] = l_run[i];
    }
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* mask,
                       void* out, float* m_out, float* l_out, int B, int L, int Hq, int Hkv,
                       float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_causal_fwd_f32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BT - 1) / BT, Hq, B);
  flash_causal_fwd_f32<HD><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), m_out, l_out, L, Hq, Hkv,
      scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* mask,
                      void* out, float* m_out, float* l_out, int B, int L, int Hq, int Hkv,
                      float scale, cudaStream_t stream) {
  const size_t smem = TcFwd<HD>::FIXED + live_tiles_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(flash_causal_fwd_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nh = (Hq / Hkv) % 2 == 0 ? 2 : 1;  // heads per block
  const int rows = SLOTS / nh;
  dim3 grid((L + rows - 1) / rows, Hq / nh, B);
  flash_causal_fwd_tc<HD><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, static_cast<bf16*>(out), m_out, l_out, L, Hq, Hkv, nh, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: an instance of head_dim.cuh
// (cudaErrorInvalidValue otherwise; the wrapper pads to one first).  scale:
// the softmax scale, 1 / sqrt of the true head dim.  m_out and l_out are
// both null (inference) or both [B, L, Hq] float (training).
extern "C" int unirec_flash_causal_fwd(const void* q, const void* k, const void* v,
                                       const float* mask, void* out, float* m_out,
                                       float* l_out, int B, int L, int Hq, int Hkv,
                                       int head_dim, int dtype, float scale,
                                       void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || L <= 0 ||
      (m_out == nullptr) != (l_out == nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked::is_chunked(head_dim)) {
    const chunked::Strides qs = chunked::merged(L, Hq, head_dim),
                           ks = chunked::merged(L, Hkv, head_dim);
    return (int)(dtype == 0
                     ? chunked::launch_fwd<float, float, true>(q, k, v, mask, out, m_out, l_out,
                                                               qs, ks, ks, qs, B, Hq, Hq / Hkv,
                                                               L, L, head_dim, scale, s)
                     : chunked::launch_fwd<bf16, bf16, true>(q, k, v, mask, out, m_out, l_out,
                                                             qs, ks, ks, qs, B, Hq, Hq / Hkv, L,
                                                             L, head_dim, scale, s));
  }
  return (int)with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return dtype == 0
               ? launch_f32<HD>(q, k, v, mask, out, m_out, l_out, B, L, Hq, Hkv, scale, s)
               : launch_tc<HD>(q, k, v, mask, out, m_out, l_out, B, L, Hq, Hkv, scale, s);
  });
}
