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
// product serves them all.  That packing only buys MXU tile use; these
// kernels compute each item's softmax over its own F keys and give the other
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
// operations a byte), so bytes bound it (0.32 ms at 3.35 TB/s).
//   * bf16: the per-item attention core of item_attention.cuh (B1/B2/B12's,
//     on mma.sync tensor cores) in its IA_B15 rounding, on B15's per-head
//     strides: whole items packed into 64-row query tiles (the TPU's packing
//     without its mask: a key of another item gets exactly zero weight),
//     resident tiles or 64 x 64 tiles streamed where an item does not fit
//     (any K, F and head dim), e in fp32 entering e . v as a bf16 hi + lo
//     pair, / l after.  The first design ran scalar fp32 FMAs from shared
//     memory: 3.01 ms at the self shape, 1.9x SDPA (PERF.md).
//   * fp32: attention_f32.cuh's kernel, which the fp32 forms of B1, B2 and
//     B12 share: scalar fp32 FMAs (TF32 would break the fp32 gate of 1e-5, as
//     flash_cross.cu:120 says), on the same packing and key tiling: one block
//     of 256 threads per (64-row query tile, head), 4 x 4 outputs a thread;
//     a first pass over the key tiles takes each row's max and sum, a second
//     recomputes the scores tile by tile (64 columns of the head dim at a
//     time, kept across passes where one tile covers them) and accumulates
//     e . v, 64 output columns at a time: any head dim, K and F.
// Each output has one owner and the sums run in a fixed order: identical
// bits run to run.
//
// Every C entry launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "item_attention.cuh"

namespace {

bool fits_int(long long x) { return x >= -2147483647LL && x <= 2147483647LL; }

}  // namespace

// B15: o [B, H, K, hd] from q [B, H, K, hd], k / v [B, H, F, hd] (strides in
// elements for (batch, head, row) of q, k, v and o; the head dim contiguous)
// and bias [B, F] float or null; K divides 128.  dtype: 0 = float32, 1 =
// bfloat16 (v with k's strides).
extern "C" int unirec_packed_item_attention(
    const void* q, const void* k, const void* v, const float* bias, void* o, long long qsb,
    long long qsh, long long qsr, long long ksb, long long ksh, long long ksr, long long vsb,
    long long vsh, long long vsr, long long osb, long long osh, long long osr, int B, int H,
    int K, int F, int head_dim, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || H > 65535 || K <= 0 || 128 % K || F <= 0 || head_dim <= 0 ||
      dtype < 0 || dtype > 1 || (long long)B * F > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (vsb != ksb || vsh != ksh || vsr != ksr ||
        !(fits_int(qsr) && fits_int(ksr) && fits_int(osr) && fits_int(qsh) && fits_int(ksh) &&
          fits_int(osh)))
      return (int)cudaErrorInvalidValue;
    IaArgs a{};
    a.q = static_cast<const bf16*>(q);
    a.kv = static_cast<const bf16*>(k);
    a.vbase = static_cast<const bf16*>(v);
    a.key_bias = bias;
    a.ctx = static_cast<bf16*>(o);
    a.q_item = qsb, a.q_stride = (int)qsr, a.q_head = (int)qsh;
    a.kv_item = ksb, a.kv_stride = (int)ksr, a.kv_head = (int)ksh;
    a.ctx_item = osb, a.ctx_stride = (int)osr, a.ctx_head = (int)osh;
    a.q_n = qsb == K * qsr ? 0 : K;  // ia_row: one run of rows, or items of rows
    a.kv_n = ksb == F * ksr ? 0 : F;
    a.ctx_n = osb == K * osr ? 0 : K;
    a.items = B;
    a.nq = K;
    a.nkv = F;
    a.hd = head_dim;
    a.scale = scale;
    return (int)item_attention_fwd<IA_B15>(a, H, s);
  }
  return (int)attention_f32_fwd(static_cast<const float*>(q), Strides{qsb, qsh, qsr},
                                static_cast<const float*>(k), Strides{ksb, ksh, ksr},
                                static_cast<const float*>(v), Strides{vsb, vsh, vsr}, bias,
                                static_cast<float*>(o), Strides{osb, osh, osr}, B, H, K, F,
                                head_dim, scale, s);
}
