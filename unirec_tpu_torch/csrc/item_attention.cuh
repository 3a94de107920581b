// The per-item attention core of the Item Q-Former kernels, on bf16 tensor
// cores: the sweep's blocks B1/B2/B4/B5 (qformer_blocks.cu), the
// trainable blocks B12s/B12c, forward and backward (fused_qformer_vjp.cu),
// and the packed item attention B15 in bf16 (packed_attention.cu).
//
// Each item's nq query rows attend over its own nkv key rows, with an
// additive per-key bias (0 valid / -1e9 missing; none for self-attention).
// Heads are column ranges [h*hd, (h+1)*hd) of row-major q, k, v; the
// forward also takes B15's per-head layout, any (item, row, head) strides
// (IaArgs).  It replaces the per-head attention inside the Pallas bodies of
// unirec_tpu/ops/fused_qformer_layer.py (_group_attention) and
// unirec_tpu/ops/fused_qformer_vjp.py (_attn_heads_fwd, _attn_heads_bwd), and
// the body of unirec_tpu/ops/packed_attention.py (_packed_kernel).
//
// What bounds it: bytes.  At the item-training shape (512 items, K 32,
// 16 heads of 64) the forward reads q / k / v (96 MB) and writes ctx (32
// MB) for 4.3 GFLOP, the backward also reads dctx in fp32 and writes dq /
// dk / dv; a block's few products leave the SM waiting on its loads, so
// the design keeps many blocks in flight (small blocks of 4 warps, 28-56
// KB of shared memory at hd 64) and loads each operand once, 16 bytes a
// copy.
//
// Packing.  Whole items go into 64-row query tiles: ipt = 64 / nq items a
// block when nq <= 64 (at most 128 keys a block, so a long memory is not
// multiplied by the packing), ceil(nq / 64) tiles of one item when nq > 64.
// This is the TPU kernels' packing (_block_bias,
// unirec_tpu/ops/fused_qformer_vjp.py:50-57): a query and a key of different
// items, and a key past the block's last, get exactly zero weight (p forced
// to 0, not a large negative score).  An item whose keys are all at -1e9
// averages its own value rows uniformly: its scores round to -1e9 in fp32.
//
// Products.  S = Q K^T, P V and, backward, dP = bf16(dctx) V^T, dq = ds K,
// dk = ds^T Q and dv = p^T dctx run on mma.sync.m16n8k16 (bf16 in, fp32
// accumulation) with ldmatrix(.trans) fragments; a warp owns 16 query rows
// (S, P V, dq) or 16 keys (dk, dv) of a 64-row tile.  P and ds go from the S
// accumulators straight into A fragments; p^T and ds^T through shared memory
// and ldmatrix.trans.  dv's operands are fp32 in the JAX function
// (_attn_heads_bwd: p and dctx), so they enter as bf16 hi + lo pairs (three
// products: hi.hi + hi.lo + lo.hi).
//
// Any key count and any head dim.  Scores are exact softmax, not an online
// rescaling of the output: a first pass over the key tiles takes each row's
// max and sum, a second computes p = e * (1 / sum) (or e, for B1) and P V.
// S is kept in registers when the block has one key tile (every B12 shape at
// nq <= 64 self, or <= 64 fields a tile cross), and recomputed otherwise.
// The head dim is zero-padded to a multiple of 16 (hp); the output is
// written in 64-column chunks.  Resident mode keeps the block's whole
// q / k / v (and dctx) in shared memory, loaded once by 16-byte cp.async;
// where that does not fit (a long memory, hd above ~256), streaming mode
// loads 64 x 64 tiles as each product needs them, recomputing what it must.
// Rows that are not 16-byte aligned (hd or a stride not a multiple of 8) are
// loaded by plain 2-byte loads on the same path.  The one-tile cases (ONE,
// SINGLE: every B12 shape at K <= 64) are instances of their own, so that
// the compiler keeps S (and dP) in registers between the passes; the
// one-tile backward puts ds and p's high half where k and v were once
// they are read, which leaves room for four blocks an SM.
//
// Rounding variants (template RND), each its JAX function's:
//   IA_B12  _attn_heads_fwd / _attn_heads_bwd: s = (q . k) * scale + bias in
//           fp32, p = e * (1 / sum e) fp32, bf16(p) . v; ctx bf16.
//           Backward: dp = bf16(dctx) . v^T, ds = bf16(p (dp - sum dp p) scale),
//           dq = ds . k, dk = ds^T . q, dv = p^T . dctx.
//   IA_B1   _group_attention of the sweep's blocks: bf16(q * scale) before
//           the product, s = q . k + bias, unnormalised bf16(e) . v, then
//           * (1 / sum e).
//   IA_B15  _packed_kernel: s = (q . k) * scale + bias (two roundings), the
//           unnormalised e in fp32 enters e . v as a bf16 hi + lo pair (two
//           products; the JAX kernel multiplies in fp32), then
//           / (sum e == 0 ? 1 : sum e); the output in bf16.
// Every output element has one owner (no atomics): a repeat gives the same
// bits.
//
// Everything is in an unnamed namespace: each source that includes this
// header gets its own copy, and nothing is exported.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int IA_TILE = 64;          // query rows a tile, keys a key tile, columns a chunk
constexpr int IA_THREADS = 128;      // four warps of 16 rows (or keys)
constexpr int IA_PACKED_KEYS = 128;  // at most this many keys in a block of several items
constexpr int IA_SMEM_LIMIT = 232448;
constexpr int IA_SP = IA_TILE + 8;   // pitch of a streamed 64 x 64 tile: 144 bytes

enum { IA_B12 = 0, IA_B1 = 1, IA_B15 = 2 };

// Row r of an item of q sits at q + item * q_item + r * q_stride + head *
// q_head (k and v likewise with kv_item, kv_stride, kv_head, from kv + k_off
// and vbase + v_off; ctx with ctx_*).  q_n, kv_n, ctx_n: 0 where a tensor's
// items' rows are one run of rows q_stride apart (q_item = nq * q_stride),
// else its rows an item (nq, nkv), for ia_row.  The backward takes one run
// of row-major rows, heads hd apart.
struct IaArgs {
  const bf16* q;
  const bf16* kv;
  const bf16* vbase;      // v's tensor: kv, or B15's own
  const float* key_bias;  // [items * nkv] or nullptr
  const float* dctx;      // backward: [items * nq, dctx_stride] fp32
  bf16* ctx;              // forward output
  bf16* dq;               // backward outputs
  bf16* dkv;
  int q_stride, kv_stride, k_off, v_off, ctx_stride;
  long long q_item, kv_item, ctx_item;
  int q_head, kv_head, ctx_head, q_n, kv_n, ctx_n;
  int dctx_stride, dq_stride, dkv_stride, dk_off, dv_off;
  int items, nq, nkv, hd;
  int ipt, hp, nqt, nkt;  // items a block; hd padded to 16; 64-row tiles of rows, keys
  int resident, vec, pairs;
  float scale;
};

__host__ __device__ __forceinline__ int ia_ipt(int nq, int nkv) {
  if (nq > IA_TILE) return 1;
  const int by_keys = IA_PACKED_KEYS / nkv;
  return max(1, min(IA_TILE / nq, by_keys));
}

// shared memory of the forward and backward kernels (resident or streaming)
inline long long ia_fwd_smem(bool resident, int nkt, int hp) {
  if (resident) return 2LL * (IA_TILE + 2LL * nkt * IA_TILE) * (hp + 8) + 8LL * nkt * IA_TILE;
  return 2LL * 3 * IA_TILE * IA_SP + 8LL * IA_TILE;
}

// alias: one query and one key tile, resident, rows at least 64 wide: ds and
// p's high half take the places of k and v once they are read, and only p's
// low half needs a tile of its own
inline long long ia_bwd_smem(bool resident, int nqt, int nkt, int hp, bool alias = false) {
  const long long common = 2LL * (alias ? 1 : 3) * IA_TILE * IA_SP + 12LL * nqt * IA_TILE;
  if (resident)
    return 2LL * (3LL * nqt + 2LL * nkt) * IA_TILE * (hp + 8) + common + 8LL * nkt * IA_TILE;
  return 2LL * 5 * IA_TILE * IA_SP + common + 8LL * IA_TILE;
}

// the offset of a block's row r: rows `stride` apart, or (n > 0) items of n
// rows `item` apart
__device__ __forceinline__ size_t ia_row(int r, int stride, int n, long long item) {
  return n == 0 ? (size_t)r * stride : (size_t)(r / n) * item + (size_t)(r % n) * stride;
}

// dst[r * pitch + c] = src[ia_row(r0 + r) + c] for r < nr, c < nc, else 0,
// over rows x cols (cols a multiple of 16).  vec: 16-byte cp.async (the
// caller commits and waits); else plain loads.
__device__ __forceinline__ void ia_load(bf16* dst, int pitch, int rows, int cols,
                                        const bf16* src, int stride, int nr, int nc, bool vec,
                                        int r0 = 0, int n = 0, long long item = 0) {
  if (vec) {
    const int per_row = cols / 8;
    for (int ch = threadIdx.x; ch < rows * per_row; ch += IA_THREADS) {
      const int r = ch / per_row;
      const int c = (ch - r * per_row) * 8;
      const bool p = r < nr && c < nc;
      cp_async_16(smem_addr(dst + r * pitch + c),
                  p ? src + ia_row(r0 + r, stride, n, item) + c : src, p);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += IA_THREADS) {
      const int r = e / cols;
      const int c = e - r * cols;
      dst[r * pitch + c] = r < nr && c < nc ? src[ia_row(r0 + r, stride, n, item) + c]
                                            : __float2bfloat16(0.f);
    }
  }
}

// fp32 rows as bf16 hi = bf16(x) and lo = bf16(x - hi), zero outside.
// vec4: 16-byte loads (stride, nc and src 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void ia_split_store(bf16* hi, bf16* lo, int at, float x) {
  const bf16 h = __float2bfloat16(x);
  hi[at] = h;
  lo[at] = __float2bfloat16(x - __bfloat162float(h));
}

__device__ __forceinline__ void ia_load_split(bf16* hi, bf16* lo, int pitch, int rows, int cols,
                                              const float* src, int stride, int nr, int nc,
                                              bool vec4) {
  if (vec4) {
    const int per_row = cols / 4;
#pragma unroll 4
    for (int ch = threadIdx.x; ch < rows * per_row; ch += IA_THREADS) {
      const int r = ch / per_row;
      const int c = (ch - r * per_row) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr && c < nc) x = *reinterpret_cast<const float4*>(src + (size_t)r * stride + c);
      const int at = r * pitch + c;
      ia_split_store(hi, lo, at, x.x);
      ia_split_store(hi, lo, at + 1, x.y);
      ia_split_store(hi, lo, at + 2, x.z);
      ia_split_store(hi, lo, at + 3, x.w);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += IA_THREADS) {
      const int r = e / cols;
      const int c = e - r * cols;
      ia_split_store(hi, lo, r * pitch + c, r < nr && c < nc ? src[(size_t)r * stride + c] : 0.f);
    }
  }
}

__device__ __forceinline__ void ia_land() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// bf16(x * scale) of both halves of an A-fragment register (B1's q * scale)
__device__ __forceinline__ uint32_t ia_scale_pair(uint32_t v, float scale) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__bfloat162float(b.x) * scale, __bfloat162float(b.y) * scale);
}

// acc[16 rows of this warp][64 keys] += A[rows][0..w) . B[keys][0..w)^T; A
// rows warp*16.. of `a` (pitch ap), B rows 0..63 of `b` (pitch bp); w a
// multiple of 16.  scale_a: A in bf16(a * scale) (B1).
__device__ __forceinline__ void ia_qk(float (&acc)[8][4], const bf16* a, int ap, const bf16* b,
                                      int bp, int w, bool scale_a, float scale) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int kk = 0; kk < w; kk += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_addr(a + (warp * 16 + (lane & 15)) * ap + kk + (lane >> 4) * 8));
    if (scale_a) {
#pragma unroll
      for (int r = 0; r < 4; ++r) af[r] = ia_scale_pair(af[r], scale);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t t[4];
      ldmatrix_x4(t, smem_addr(b + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * bp + kk +
                               ((lane >> 3) & 1) * 8));
      mma_16816(acc[2 * nj], af, t[0], t[1]);
      mma_16816(acc[2 * nj + 1], af, t[2], t[3]);
    }
  }
}

// acc[16 rows][w columns] += A (4 k-steps of 16 keys, fragments) . B[keys][cols]
// with B rows 0..63 of `b` (pitch bp) through ldmatrix.trans; w <= 64
__device__ __forceinline__ void ia_pv(float (&acc)[8][4], const uint32_t (&a)[4][4], const bf16* b,
                                      int bp, int w) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      if (nd * 16 >= w) break;
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, smem_addr(b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * bp +
                                      nd * 16 + (lane >> 4) * 8));
      mma_16816(acc[2 * nd], a[kk], bv[0], bv[1]);
      mma_16816(acc[2 * nd + 1], a[kk], bv[2], bv[3]);
    }
  }
}

__device__ __forceinline__ void ia_zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// A fragments of one 16 x 64 product operand from C-fragment values (8
// n-tiles of 8 keys): k-step kk is n-tiles 2kk (keys 0-7) and 2kk + 1
__device__ __forceinline__ void ia_frags(uint32_t (&a)[4][4], const float (&v)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* x = v[2 * kk + (r >> 1)] + 2 * (r & 1);
      a[kk][r] = pack_bf16(x[0], x[1]);
    }
}

// Scores of this warp's 16 rows of query tile qt over key tile kt, masked to
// the rows' own items: s = (q . k) * scale + bias (B12) or q . k + bias (B1),
// -inf off the item.  kb / ki: the key tile's bias and local item (-1 past
// the block's keys).
template <int RND>
__device__ __forceinline__ void ia_mask(float (&s)[8][4], const float* kb, const int* ki,
                                        const int (&ritem)[2], float scale) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = n * 8 + 2 * t4 + (e & 1);
      const float v = RND == IA_B12  ? s[n][e] * scale + kb[j]
                      : RND == IA_B1 ? s[n][e] + kb[j]
                                     : __fadd_rn(__fmul_rn(s[n][e], scale), kb[j]);
      s[n][e] = ki[j] == ritem[e >> 1] ? v : -INFINITY;
    }
}

__device__ __forceinline__ float ia_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float ia_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// running max and sum of e over one more key tile (per thread; the sums
// are the thread's own columns, reduced over the quad at the end)
__device__ __forceinline__ void ia_stats(const float (&s)[8][4], float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hf], s[n][2 * hf + 1]));
    const float mn = fmaxf(m[hf], ia_quad_max(mx));
    const float base = mn == -INFINITY ? 0.f : mn;
    float sum = l[hf] * expf(m[hf] - base);
#pragma unroll
    for (int n = 0; n < 8; ++n) sum += expf(s[n][2 * hf] - base) + expf(s[n][2 * hf + 1] - base);
    l[hf] = sum;
    m[hf] = mn;
  }
}

// key tile kt's bias and local item into kb / ki (64 entries)
__device__ __forceinline__ void ia_key_info(float* kb, int* ki, const IaArgs& a, size_t krow0,
                                            int keys_b, int kt) {
  for (int j = threadIdx.x; j < IA_TILE; j += IA_THREADS) {
    const int key = kt * IA_TILE + j;
    const bool live = key < keys_b;
    ki[j] = live ? key / a.nkv : -1;
    kb[j] = live && a.key_bias != nullptr ? a.key_bias[krow0 + key] : 0.f;
  }
}

// ---------------------------------------------------------------- forward --
// grid (blocks of ipt items, heads, query tiles of an item when nq > 64).
// ONE: resident, and one key tile in every block (the compiler keeps only
// that path, and S in registers between the passes).
template <int RND, bool ONE>
__global__ void __launch_bounds__(IA_THREADS)
item_attention_fwd_kernel(const IaArgs a) {
  extern __shared__ __align__(16) unsigned char ia_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int item0 = blockIdx.x * a.ipt;
  const int n_items = min(a.ipt, a.items - item0);
  const int rows_b = n_items * a.nq;
  const int keys_b = n_items * a.nkv;
  const int nkt = ONE ? 1 : (keys_b + IA_TILE - 1) / IA_TILE;
  const int qt = blockIdx.z;
  const int rows_t = min(IA_TILE, rows_b - qt * IA_TILE);
  const size_t krow0 = (size_t)item0 * a.nkv;
  const size_t head = blockIdx.y;
  const int hp = a.hp;
  const bool resident = ONE || a.resident != 0;
  const bool vec = a.vec != 0;

  const int P = resident ? hp + 8 : IA_SP;
  const int key_rows = resident ? nkt * IA_TILE : IA_TILE;
  bf16* Qs = reinterpret_cast<bf16*>(ia_smem);
  bf16* Ks = Qs + IA_TILE * P;
  bf16* Vs = Ks + (resident ? a.nkt * IA_TILE : IA_TILE) * P;
  float* kb = reinterpret_cast<float*>(Vs + (resident ? a.nkt * IA_TILE : IA_TILE) * P);
  int* ki = reinterpret_cast<int*>(kb + (resident ? a.nkt * IA_TILE : IA_TILE));

  // the block's first rows, at the head's first column; its rows as ia_row
  const bf16* qg = a.q + item0 * a.q_item + head * a.q_head;
  const bf16* kg = a.kv + item0 * a.kv_item + head * a.kv_head + a.k_off;
  const bf16* vg = a.vbase + item0 * a.kv_item + head * a.kv_head + a.v_off;
  bf16* cg = a.ctx + item0 * a.ctx_item + head * a.ctx_head;
  const int qn = a.q_n, kn = a.kv_n;
  const int q0 = qt * IA_TILE;

  int ritem[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = qt * IA_TILE + warp * 16 + g + 8 * hf;  // the block's row
    ritem[hf] = r < rows_b ? r / a.nq : -2;
  }

  if (resident) {
    ia_load(Qs, P, IA_TILE, hp, qg, a.q_stride, rows_t, a.hd, vec, q0, qn, a.q_item);
    ia_load(Ks, P, key_rows, hp, kg, a.kv_stride, keys_b, a.hd, vec, 0, kn, a.kv_item);
    ia_load(Vs, P, key_rows, hp, vg, a.kv_stride, keys_b, a.hd, vec, 0, kn, a.kv_item);
    for (int kt = 0; kt < nkt; ++kt)
      ia_key_info(kb + kt * IA_TILE, ki + kt * IA_TILE, a, krow0, keys_b, kt);
    ia_land();
  }

  auto scores = [&](int kt, float (&s)[8][4]) {
    ia_zero(s);
    if (resident) {
      ia_qk(s, Qs, P, Ks + kt * IA_TILE * P, P, hp, RND == IA_B1, a.scale);
      ia_mask<RND>(s, kb + kt * IA_TILE, ki + kt * IA_TILE, ritem, a.scale);
    } else {
      for (int c = 0; c < hp; c += IA_TILE) {
        __syncthreads();  // every warp is done with the slots
        ia_load(Qs, P, IA_TILE, IA_TILE, qg + c, a.q_stride, rows_t, a.hd - c, vec, q0, qn,
                a.q_item);
        ia_load(Ks, P, IA_TILE, IA_TILE, kg + c, a.kv_stride, keys_b - kt * IA_TILE, a.hd - c,
                vec, kt * IA_TILE, kn, a.kv_item);
        if (c == 0) ia_key_info(kb, ki, a, krow0, keys_b, kt);
        ia_land();
        ia_qk(s, Qs, P, Ks, P, min(IA_TILE, hp - c), RND == IA_B1, a.scale);
      }
      ia_mask<RND>(s, kb, ki, ritem, a.scale);
    }
  };

  // pass 1: each row's max and sum of e over every key tile
  float s[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    scores(kt, s);
    ia_stats(s, m, l);
  }
  float mb[2], inv[2], den[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float sum = ia_quad_sum(l[hf]);
    mb[hf] = m[hf] == -INFINITY ? 0.f : m[hf];
    inv[hf] = sum > 0.f ? 1.f / sum : 0.f;
    den[hf] = sum == 0.f ? 1.f : sum;
  }

  size_t orow[2];  // the offsets of this thread's two output rows
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    orow[hf] = ia_row(q0 + warp * 16 + g + 8 * hf, a.ctx_stride, a.ctx_n, a.ctx_item);

  // pass 2: P V, 64 output columns at a time
  for (int oc = 0; oc < hp; oc += IA_TILE) {
    const int w = min(IA_TILE, hp - oc);
    float o[8][4];
    ia_zero(o);
    for (int kt = 0; kt < nkt; ++kt) {
      if (!ONE && nkt > 1) scores(kt, s);
      // p (B12) or e (B1, B15), bf16, as A fragments; B15: e's low half in pl
      uint32_t pa[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = s[2 * kk + (r >> 1)] + 2 * (r & 1);
          const int hf = r & 1;
          float p0 = expf(x[0] - mb[hf]), p1 = expf(x[1] - mb[hf]);  // 0 off the item
          if (RND == IA_B12) {
            p0 *= inv[hf];
            p1 *= inv[hf];
          }
          if (RND == IA_B15)
            split_bf16(p0, p1, pa[kk][r], pl[kk][r]);
          else
            pa[kk][r] = pack_bf16(p0, p1);
        }
      const bf16* vt = Vs + kt * IA_TILE * P + oc;
      if (!resident) {
        __syncthreads();
        ia_load(Vs, P, IA_TILE, IA_TILE, vg + oc, a.kv_stride, keys_b - kt * IA_TILE,
                a.hd - oc, vec, kt * IA_TILE, kn, a.kv_item);
        ia_land();
        vt = Vs;
      }
      ia_pv(o, pa, vt, P, w);
      if (RND == IA_B15) ia_pv(o, pl, vt, P, w);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = oc + n * 8 + 2 * t4;
      if (col >= a.hd) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = warp * 16 + g + 8 * hf;
        if (r >= rows_t) continue;
        float v0 = o[n][2 * hf], v1 = o[n][2 * hf + 1];
        if (RND == IA_B1) {
          v0 *= inv[hf];
          v1 *= inv[hf];
        } else if (RND == IA_B15) {
          v0 = __fdiv_rn(v0, den[hf]);
          v1 = __fdiv_rn(v1, den[hf]);
        }
        bf16* dst = cg + orow[hf] + col;
        if (a.pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < a.hd) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// --------------------------------------------------------------- backward --
// grid (blocks of ipt items, heads): a block owns its items' dq, dk and dv
// columns of the head, over every query tile of an item.  SINGLE: resident,
// and one query tile and one key tile in every block (s and dp computed
// once and kept; the compiler keeps only that path).
template <int RND, bool SINGLE>
__global__ void __launch_bounds__(IA_THREADS, SINGLE ? 4 : 1)
item_attention_bwd_kernel(const IaArgs a) {
  static_assert(RND == IA_B12, "the backward is B12's");
  extern __shared__ __align__(16) unsigned char ia_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int item0 = blockIdx.x * a.ipt;
  const int n_items = min(a.ipt, a.items - item0);
  const int rows_b = n_items * a.nq;
  const int keys_b = n_items * a.nkv;
  const int nqt = SINGLE ? 1 : (rows_b + IA_TILE - 1) / IA_TILE;
  const int nkt = SINGLE ? 1 : (keys_b + IA_TILE - 1) / IA_TILE;
  constexpr bool single = SINGLE;
  const size_t qrow0 = (size_t)item0 * a.nq;
  const size_t krow0 = (size_t)item0 * a.nkv;
  const int col0 = blockIdx.y * a.hd;
  const int hp = a.hp;
  const bool resident = SINGLE || a.resident != 0;
  const bool vec = a.vec != 0;

  const int P = resident ? hp + 8 : IA_SP;
  const int qrows = resident ? a.nqt * IA_TILE : IA_TILE;
  const int krows = resident ? a.nkt * IA_TILE : IA_TILE;
  bf16* Qs = reinterpret_cast<bf16*>(ia_smem);
  bf16* Dh = Qs + qrows * P;  // bf16(dctx)
  bf16* Dl = Dh + qrows * P;  // dctx - bf16(dctx)
  bf16* Ks = Dl + qrows * P;
  bf16* Vs = Ks + krows * P;
  // ds of a (query tile, key tile), [row][key], and p as hi + lo
  const bool alias = SINGLE && P >= IA_SP;  // see ia_bwd_smem
  bf16* Ts = alias ? Ks : Vs + krows * P;
  bf16* Ph = alias ? Vs : Ts + IA_TILE * IA_SP;
  bf16* Pl = alias ? Vs + krows * P : Ph + IA_TILE * IA_SP;
  float* st_m = reinterpret_cast<float*>(Pl + IA_TILE * IA_SP);  // per row: max,
  float* st_i = st_m + a.nqt * IA_TILE;                          // 1 / sum e,
  float* st_d = st_i + a.nqt * IA_TILE;                          // sum dp p
  float* kb = st_d + a.nqt * IA_TILE;
  int* ki = reinterpret_cast<int*>(kb + krows);

  const bf16* qg = a.q + qrow0 * a.q_stride + col0;
  const bf16* kg = a.kv + krow0 * a.kv_stride + a.k_off + col0;
  const bf16* vg = a.kv + krow0 * a.kv_stride + a.v_off + col0;
  const float* dg = a.dctx + qrow0 * a.dctx_stride + col0;
  const bool dvec = a.hd % 4 == 0 && a.dctx_stride % 4 == 0 && (uintptr_t)a.dctx % 16 == 0;

  if (resident) {
    ia_load(Qs, P, nqt * IA_TILE, hp, qg, a.q_stride, rows_b, a.hd, vec);
    ia_load(Ks, P, nkt * IA_TILE, hp, kg, a.kv_stride, keys_b, a.hd, vec);
    ia_load(Vs, P, nkt * IA_TILE, hp, vg, a.kv_stride, keys_b, a.hd, vec);
    ia_load_split(Dh, Dl, P, nqt * IA_TILE, hp, dg, a.dctx_stride, rows_b, a.hd, dvec);
    for (int kt = 0; kt < nkt; ++kt)
      ia_key_info(kb + kt * IA_TILE, ki + kt * IA_TILE, a, krow0, keys_b, kt);
    ia_land();
  }

  // the tiles of query tile qt / key tile kt at columns c.. (streaming: loaded now)
  auto rows_of = [&](int qt) { return rows_b - qt * IA_TILE; };
  auto keys_of = [&](int kt) { return keys_b - kt * IA_TILE; };
  auto q_tile = [&](int qt, int c) -> const bf16* {
    if (resident) return Qs + qt * IA_TILE * P + c;
    ia_load(Qs, P, IA_TILE, IA_TILE, qg + (size_t)qt * IA_TILE * a.q_stride + c, a.q_stride,
            rows_of(qt), a.hd - c, vec);
    return Qs;
  };
  auto d_tiles = [&](int qt, int c) -> int {  // offset of the tile in Dh / Dl
    if (resident) return qt * IA_TILE * P + c;
    ia_load_split(Dh, Dl, P, IA_TILE, IA_TILE, dg + (size_t)qt * IA_TILE * a.dctx_stride + c,
                  a.dctx_stride, rows_of(qt), a.hd - c, dvec);
    return 0;
  };
  auto k_tile = [&](int kt, int c) -> const bf16* {
    if (resident) return Ks + kt * IA_TILE * P + c;
    ia_load(Ks, P, IA_TILE, IA_TILE, kg + (size_t)kt * IA_TILE * a.kv_stride + c, a.kv_stride,
            keys_of(kt), a.hd - c, vec);
    return Ks;
  };
  auto v_tile = [&](int kt, int c) -> const bf16* {
    if (resident) return Vs + kt * IA_TILE * P + c;
    ia_load(Vs, P, IA_TILE, IA_TILE, vg + (size_t)kt * IA_TILE * a.kv_stride + c, a.kv_stride,
            keys_of(kt), a.hd - c, vec);
    return Vs;
  };
  auto kinfo = [&](int kt) { return resident ? kt * IA_TILE : 0; };

  auto row_items = [&](int qt, int (&ritem)[2]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = qt * IA_TILE + warp * 16 + g + 8 * hf;
      ritem[hf] = r < rows_b ? r / a.nq : -2;
    }
  };

  // s (masked, scaled) and, with want_dp, dp = bf16(dctx) . v^T of this
  // warp's rows of query tile qt over key tile kt
  auto sdp = [&](int qt, int kt, bool want_dp, float (&s)[8][4], float (&dp)[8][4]) {
    int ritem[2];
    row_items(qt, ritem);
    ia_zero(s);
    ia_zero(dp);
    for (int c = 0; c < (resident ? 1 : hp); c += IA_TILE) {
      if (!resident) __syncthreads();
      const bf16* qt_ = q_tile(qt, c);
      const bf16* kt_ = k_tile(kt, c);
      const bf16* vt_ = want_dp ? v_tile(kt, c) : nullptr;
      const int doff = want_dp ? d_tiles(qt, c) : 0;
      if (!resident) {
        if (c == 0) ia_key_info(kb, ki, a, krow0, keys_b, kt);
        ia_land();
      }
      const int w = resident ? hp : min(IA_TILE, hp - c);
      ia_qk(s, qt_, P, kt_, P, w, false, a.scale);
      if (want_dp) ia_qk(dp, Dh + doff, P, vt_, P, w, false, a.scale);
    }
    ia_mask<RND>(s, kb + kinfo(kt), ki + kinfo(kt), ritem, a.scale);
  };

  // p (fp32) of s, in place, with the rows' stats
  auto probs = [&](int qt, float (&s)[8][4]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = qt * IA_TILE + warp * 16 + g + 8 * hf;
      const float mb = st_m[r], inv = st_i[r];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][2 * hf] = expf(s[n][2 * hf] - mb) * inv;  // 0 off the item
        s[n][2 * hf + 1] = expf(s[n][2 * hf + 1] - mb) * inv;
      }
    }
  };
  // ds = bf16(p (dp - sum dp p) scale), in place of dp
  auto grads = [&](int qt, const float (&p)[8][4], float (&dp)[8][4]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float dsum = st_d[qt * IA_TILE + warp * 16 + g + 8 * hf];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e)
          dp[n][e] = __bfloat162float(__float2bfloat16((p[n][e] * (dp[n][e] - dsum)) * a.scale));
    }
  };
  // p (hi, lo) of this warp's rows into Ph / Pl
  auto stash_p = [&](const float (&p)[8][4]) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int at = (warp * 16 + g + 8 * hf) * IA_SP + n * 8 + 2 * t4;
        split_bf16(p[n][2 * hf], p[n][2 * hf + 1], *reinterpret_cast<uint32_t*>(Ph + at),
                   *reinterpret_cast<uint32_t*>(Pl + at));
      }
  };
  // ds of this warp's rows into Ts, from its A fragments
  auto stash_ds = [&](const uint32_t (&da)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<uint32_t*>(
            Ts + (warp * 16 + g + 8 * (r & 1)) * IA_SP + kk * 16 + (r >> 1) * 8 + 2 * t4) =
            da[kk][r];
  };
  // bf16 values v0, v1 at columns col, col + 1 (< hd) of the head, from base + off
  auto store = [&](bf16* base, size_t row, int stride, int off, int col, float v0, float v1) {
    bf16* dst = base + row * stride + off + col0 + col;
    if (a.pairs) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    } else {
      dst[0] = __float2bfloat16(v0);
      if (col + 1 < a.hd) dst[1] = __float2bfloat16(v1);
    }
  };

  // s, then p; dp, then ds.  With one query and one key tile they are
  // computed once, in pass 1, and kept.
  float s[8][4], dp[8][4];

  // pass 1: each row's max and sum of e
  for (int qt = 0; qt < nqt; ++qt) {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kt = 0; kt < nkt; ++kt) {
      sdp(qt, kt, single, s, dp);
      ia_stats(s, m, l);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float sum = ia_quad_sum(l[hf]);
      if (t4 == 0) {
        const int r = qt * IA_TILE + warp * 16 + g + 8 * hf;
        st_m[r] = m[hf] == -INFINITY ? 0.f : m[hf];
        st_i[r] = sum > 0.f ? 1.f / sum : 0.f;
      }
    }
  }
  __syncthreads();

  // pass 2: sum over keys of dp * p for each row
  for (int qt = 0; qt < nqt; ++qt) {
    float dsum[2] = {0.f, 0.f};
    for (int kt = 0; kt < nkt; ++kt) {
      if (!single) sdp(qt, kt, true, s, dp);
      probs(qt, s);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e >> 1] = fmaf(dp[n][e], s[n][e], dsum[e >> 1]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float v = ia_quad_sum(dsum[hf]);
      if (t4 == 0) st_d[qt * IA_TILE + warp * 16 + g + 8 * hf] = v;
    }
  }
  __syncthreads();

  // pass 3: dq = ds . k, 64 columns at a time
  uint32_t da[4][4];  // ds as A fragments
  if (single) {  // v has been read: p's high half may take its place
    grads(0, s, dp);
    stash_p(s);
    ia_frags(da, dp);
  }
  for (int qt = 0; qt < nqt; ++qt) {
    for (int oc = 0; oc < hp; oc += IA_TILE) {
      const int w = min(IA_TILE, hp - oc);
      float acc[8][4];
      ia_zero(acc);
      for (int kt = 0; kt < nkt; ++kt) {
        if (!single) {
          sdp(qt, kt, true, s, dp);
          probs(qt, s);
          grads(qt, s, dp);
          ia_frags(da, dp);
        }
        if (!resident) __syncthreads();  // every warp is done with the slots
        const bf16* kt_ = k_tile(kt, oc);
        if (!resident) ia_land();
        ia_pv(acc, da, kt_, P, w);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = oc + n * 8 + 2 * t4;
        if (col >= a.hd) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = qt * IA_TILE + warp * 16 + g + 8 * hf;
          if (r < rows_b)
            store(a.dq, qrow0 + r, a.dq_stride, 0, col, acc[n][2 * hf], acc[n][2 * hf + 1]);
        }
      }
    }
  }
  if (single) {  // every warp is done with k: ds may take its place
    __syncthreads();
    stash_ds(da);
  }
  __syncthreads();

  // pass 4: dk = ds^T . q and dv = p^T . dctx; warp w owns keys 16w.. of a
  // key tile, over every query tile
  for (int kt = 0; kt < nkt; ++kt) {
    for (int oc = 0; oc < hp; oc += IA_TILE) {
      const int w = min(IA_TILE, hp - oc);
      float ak[8][4], av[8][4];
      ia_zero(ak);
      ia_zero(av);
      for (int qt = 0; qt < nqt; ++qt) {
        if (!single) {
          sdp(qt, kt, true, s, dp);
          probs(qt, s);
          grads(qt, s, dp);
          ia_frags(da, dp);
          stash_p(s);
          stash_ds(da);
        }
        if (!resident) __syncthreads();
        const bf16* qt_ = q_tile(qt, oc);
        const int doff = d_tiles(qt, oc);
        if (!resident) cp_async_commit();
        if (!resident) cp_async_wait<0>();
        __syncthreads();  // ds, p and the tiles in place
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16 query rows a step
          uint32_t at[4], ah[4], al[4];
          const int off = (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * IA_SP + warp * 16 +
                          ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(at, smem_addr(Ts + off));
          ldmatrix_x4_trans(ah, smem_addr(Ph + off));
          ldmatrix_x4_trans(al, smem_addr(Pl + off));
          const int brow = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P;
#pragma unroll
          for (int nd = 0; nd < 4; ++nd) {
            if (nd * 16 >= w) break;
            const int bc = nd * 16 + (lane >> 4) * 8;
            uint32_t bq[4], bh[4], bl[4];
            ldmatrix_x4_trans(bq, smem_addr(qt_ + brow + bc));
            ldmatrix_x4_trans(bh, smem_addr(Dh + doff + brow + bc));
            ldmatrix_x4_trans(bl, smem_addr(Dl + doff + brow + bc));
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              mma_16816(ak[2 * nd + h2], at, bq[2 * h2], bq[2 * h2 + 1]);
              mma_16816(av[2 * nd + h2], ah, bh[2 * h2], bh[2 * h2 + 1]);
              mma_16816(av[2 * nd + h2], ah, bl[2 * h2], bl[2 * h2 + 1]);
              mma_16816(av[2 * nd + h2], al, bh[2 * h2], bh[2 * h2 + 1]);
            }
          }
        }
        __syncthreads();  // every warp is done with ds, p and the tiles
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = oc + n * 8 + 2 * t4;
        if (col >= a.hd) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = kt * IA_TILE + warp * 16 + g + 8 * hf;
          if (j >= keys_b) continue;
          store(a.dkv, krow0 + j, a.dkv_stride, a.dk_off, col, ak[n][2 * hf], ak[n][2 * hf + 1]);
          store(a.dkv, krow0 + j, a.dkv_stride, a.dv_off, col, av[n][2 * hf], av[n][2 * hf + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launch --

inline bool ia_aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

// fills the plan fields of `a` (ipt, hp, nqt, nkt, resident, vec, pairs)
// and returns the grid's first dimension and the shared memory, or 0 bytes
// where the block does not fit
inline int ia_plan(IaArgs& a, bool backward, int& groups) {
  a.ipt = ia_ipt(a.nq, a.nkv);
  groups = (a.items + a.ipt - 1) / a.ipt;
  const int rows = a.nq > IA_TILE ? a.nq : a.ipt * a.nq;
  const int keys = a.ipt * a.nkv;
  a.nqt = (rows + IA_TILE - 1) / IA_TILE;
  a.nkt = (keys + IA_TILE - 1) / IA_TILE;
  a.hp = (a.hd + 15) / 16 * 16;
  a.vec = a.hd % 8 == 0 && a.q_stride % 8 == 0 && a.kv_stride % 8 == 0 && a.k_off % 8 == 0 &&
          a.v_off % 8 == 0 && a.q_item % 8 == 0 && a.kv_item % 8 == 0 && a.q_head % 8 == 0 &&
          a.kv_head % 8 == 0 && ia_aligned(a.q) && ia_aligned(a.kv) && ia_aligned(a.vbase);
  const bool alias = a.nqt == 1 && a.nkt == 1 && a.hp + 8 >= IA_SP;
  const long long res = backward ? ia_bwd_smem(true, a.nqt, a.nkt, a.hp, alias)
                                 : ia_fwd_smem(true, a.nkt, a.hp);
  a.resident = res <= IA_SMEM_LIMIT;
  const long long bytes = a.resident ? res
                          : backward ? ia_bwd_smem(false, a.nqt, a.nkt, a.hp)
                                     : ia_fwd_smem(false, a.nkt, a.hp);
  return bytes <= IA_SMEM_LIMIT ? (int)bytes : 0;
}

// the forward of the layout and variant that `a` holds (its plan fields
// filled here)
template <int RND>
cudaError_t item_attention_fwd(IaArgs& a, int heads, cudaStream_t stream) {
  int groups = 0;
  const int bytes = ia_plan(a, false, groups);
  a.pairs = a.hd % 2 == 0 && a.ctx_stride % 2 == 0 && a.ctx_item % 2 == 0 && a.ctx_head % 2 == 0;
  if (bytes == 0 || heads > 65535 || a.nqt > 65535) return cudaErrorInvalidValue;
  const bool one = a.resident && a.nkt == 1;
  cudaError_t err = cudaFuncSetAttribute(
      one ? item_attention_fwd_kernel<RND, true> : item_attention_fwd_kernel<RND, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, heads, a.nq > IA_TILE ? a.nqt : 1);
  if (one)
    item_attention_fwd_kernel<RND, true><<<grid, IA_THREADS, bytes, stream>>>(a);
  else
    item_attention_fwd_kernel<RND, false><<<grid, IA_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ctx = per-item attention (variant RND) of q over k / v, heads as column
// ranges of row-major rows (IaArgs)
template <int RND>
cudaError_t item_attention(const void* q, int q_stride, const void* kv, int kv_stride, int k_off,
                           int v_off, const float* key_bias, void* ctx, int ctx_stride, int items,
                           int heads, int nq, int nkv, int hd, float scale, cudaStream_t stream) {
  IaArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.kv = a.vbase = static_cast<const bf16*>(kv);
  a.key_bias = key_bias;
  a.ctx = static_cast<bf16*>(ctx);
  a.q_stride = q_stride;
  a.kv_stride = kv_stride;
  a.k_off = k_off;
  a.v_off = v_off;
  a.ctx_stride = ctx_stride;
  a.q_item = (long long)nq * q_stride;
  a.kv_item = (long long)nkv * kv_stride;
  a.ctx_item = (long long)nq * ctx_stride;
  a.q_head = a.kv_head = a.ctx_head = hd;
  a.items = items;
  a.nq = nq;
  a.nkv = nkv;
  a.hd = hd;
  a.scale = scale;
  return item_attention_fwd<RND>(a, heads, stream);
}

// B12's softmax VJP: dq [rows, dq_stride], dk / dv at dkv + row * dkv_stride
// + {dk_off, dv_off}, from q, k, v as the forward read them and dctx fp32
// (a template, so that only the sources that call it build its kernels)
template <int RND = IA_B12>
cudaError_t item_attention_bwd(const void* q, int q_stride, const void* kv, int kv_stride,
                                      int k_off, int v_off, const float* key_bias,
                                      const float* dctx, int dctx_stride, void* dq, int dq_stride,
                                      void* dkv, int dkv_stride, int dk_off, int dv_off,
                                      int items, int heads, int nq, int nkv, int hd, float scale,
                                      cudaStream_t stream) {
  IaArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.kv = a.vbase = static_cast<const bf16*>(kv);
  a.key_bias = key_bias;
  a.dctx = dctx;
  a.dq = static_cast<bf16*>(dq);
  a.dkv = static_cast<bf16*>(dkv);
  a.q_stride = q_stride;
  a.kv_stride = kv_stride;
  a.k_off = k_off;
  a.v_off = v_off;
  a.dctx_stride = dctx_stride;
  a.dq_stride = dq_stride;
  a.dkv_stride = dkv_stride;
  a.dk_off = dk_off;
  a.dv_off = dv_off;
  a.q_item = (long long)nq * q_stride;
  a.kv_item = (long long)nkv * kv_stride;
  a.q_head = a.kv_head = hd;
  a.items = items;
  a.nq = nq;
  a.nkv = nkv;
  a.hd = hd;
  a.scale = scale;
  int groups = 0;
  const int bytes = ia_plan(a, true, groups);
  a.pairs = hd % 2 == 0 && dq_stride % 2 == 0 && dkv_stride % 2 == 0 && dk_off % 2 == 0 &&
            dv_off % 2 == 0;
  if (bytes == 0 || heads > 65535) return cudaErrorInvalidValue;
  const bool single = a.resident && a.nqt == 1 && a.nkt == 1;
  cudaError_t err = cudaFuncSetAttribute(
      single ? item_attention_bwd_kernel<RND, true> : item_attention_bwd_kernel<RND, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, heads);
  if (single)
    item_attention_bwd_kernel<RND, true><<<grid, IA_THREADS, bytes, stream>>>(a);
  else
    item_attention_bwd_kernel<RND, false><<<grid, IA_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
