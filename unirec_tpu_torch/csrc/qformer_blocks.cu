// The Item Q-Former blocks of the item-token sweep, bf16 and W8A8, for
// Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of unirec_tpu/ops/fused_qformer_layer.py:
//   B1  fused_self_attention_block  (_self_block_kernel)
//       y = LN(x + Wo . SelfAttn(x) + bo), attention within each item's K rows
//   B2  fused_cross_attention_block (_cross_block_kernel)
//       y = LN(x + Wo . CrossAttn(x -> mem) + bo), each item's K query rows
//       over its own F field rows, additive key bias 0 / -1e9 per field
//   B3  fused_ffn_block             (_ffn_kernel)
//       y = LN(x + W2 . gelu_tanh(W1 . x + b1) + b2)
// and their W8A8 forms in unirec_tpu/ops/fused_qformer_int8.py:
//   B4  fused_self_attention_block_q  (_self_block_kernel_q)
//   B5  fused_cross_attention_block_q (_cross_block_kernel_q)
//   B6  fused_ffn_block_q             (_ffn_kernel_q)
// (int8 projections with int32 sums; see the W8A8 section below), and the
// W8A8 kernels of the int8 Qwen3 serving forward (last section):
//   B8  unirec_tpu/ops/int8_matmul.py int8_linear       (_kernel)
//   B9a unirec_tpu/ops/fused_qwen3_int8.py qkv_int8      (_qkv_kernel)
//   B9b unirec_tpu/ops/fused_qwen3_int8.py swiglu_mlp_int8 (_mlp_kernel)
//
// What bounds them: the projections.  At the production shape (hidden 1024,
// 16 heads of 64, K=32 queries, F=14 fields, intermediate 4096) an item costs
// 268 MFLOP of self projections per layer, 537 MFLOP of FFN and 193 MFLOP of
// cross projections, against under 5 MFLOP of attention core; with 4096 items
// a block's GEMMs run at hundreds of FLOP per byte of HBM traffic, so all
// three blocks are bound by tensor-core arithmetic.
//
// Design (every GEMM hand-written here, every one on gemm_wide.cuh):
//   * every bf16 product of B1-B3 runs on gemm_wide.cuh's warpgroup GEMM
//     (gemm_wide): C[M, N] = A[M, K] . W[N, K]^T, both operands bf16 with K
//     contiguous (W is the torch Linear layout, packed once on the host),
//     fp32 sums.  Rows TMA takes (K a multiple of 8, every production width)
//     run on gemm_tma_kernel: a TMA producer warp, two wgmma.m64n256k16
//     consumer warpgroups, a 4-stage mbarrier ring; other widths (hidden
//     1020: C-10) on gemm_edge_kernel.  Ragged M (the 32-row layer-0 self
//     block, B*14 memory rows), N and K edges are zero-filled on load and
//     masked on store.  Epilogues round where the JAX kernels do: +bias ->
//     bf16 (QKV, Q, KV), +bias -> tanh gelu in fp32 -> bf16 (FFN up).
//   * the residual product (Wo, FFN down) and the LayerNorm, by shape
//     (resid_ln): where TMA takes the rows and d <= 2048 (every width the
//     configs use: hidden 1024, and 896 or 1032 with a ragged last tile),
//     one launch of WG_BIAS_RESID_LN, a cluster of ceil(d / 256) CTAs that
//     adds bias and residual in fp32, exchanges each row's partial sums
//     through distributed shared memory and writes the LayerNorm output as
//     bf16 (gemm_wide.cuh); the fp32 pre-LN sum never reaches memory.  Where
//     TMA cannot take the rows (hidden 1020: d or the product's K not a
//     multiple of 8) or d > 2048 (more than the 8 CTAs of a portable
//     cluster), WG_BIAS_RESID writes it in fp32 and layer_norm_kernel
//     normalises it.
//   * the attention is the per-item core of item_attention.cuh (shared with
//     B12) in its B1 rounding, the rounding points of _group_attention:
//     bf16(q * scale) before the product, scores and softmax in fp32 with
//     the additive key bias (never skipped: an item whose fields are all
//     missing gets the uniform average of its own value rows, as the JAX
//     path does), unnormalised probabilities rounded to bf16 before the
//     value product, which accumulates in fp32 and is then scaled by
//     1/rowsum; ctx in bf16 in the head's column range.  Whole items are
//     packed into 64-row tiles, S and P V run on tensor cores, and any head
//     dim and any number of fields is taken.
//   * layer_norm_kernel: one warp per row, fp32 mean / centred variance /
//     rsqrt, output bf16 (the two-pass route above, and B4-B6).
// What this design spills to HBM that the TPU kernels kept on chip, at 4096
// items (131,072 query rows): B1 the qkv buffer [rows, 3072] bf16 (805 MB)
// and ctx [rows, 1024] bf16 (268 MB); B2 q (268 MB), kv [57,344, 2048] bf16
// (235 MB) and ctx; B3 the gelu output h [rows, 4096] bf16, written by the
// up projection and read by the down projection (a 2.15 GB round trip,
// about 0.64 ms at 3.35 TB/s), which the JAX kernel keeps in VMEM.  Keeping
// h on the SM is next: a fused FFN whose cluster shares each chunk of the
// up projection's output, as the LayerNorm shares its partial sums.
//
// W8A8 blocks: the same pipeline with every product on gemm_wide.cuh's int8
// TMA + wgmma GEMM (wgmma.m64n256k32.s32.s8.s8, twice the bf16 rate; its
// edge kernel where a width is not a multiple of 16 codes) and a
// row-quantization pass before each GEMM.  The int8 FFN (B6) spills more
// than B3: its gelu output h stays fp32, as the JAX kernel keeps it, and is
// requantized per row within each intermediate chunk (the whole 4096 at
// production), and a row's absmax spans all 4096 columns, which no block
// holds.  So the up projection and its codes go through HBM: at 4096 items
// GEMM1 writes u = (acc * rs) * cs + b1 in fp32 (2.15 GB), one pass reads u
// once, applies the gelu in registers and writes h's codes (0.54 GB), and
// GEMM2 reads the codes: at least 5.4 GB, about 1.6 ms at 3.35 TB/s, which
// the TPU kernel keeps in VMEM.  The next step is to recompute GEMM1's tile
// inside GEMM2's producer so that h never leaves the SM.  The down
// projection folds its int32 sums into fp32 at every chunk boundary.  The
// Qwen3 kernels B8, B9a and B9b (last section) share this one int8
// mainloop with B4-B6.
//
// Every C entry launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_wide.cuh"
#include "item_attention.cuh"

namespace {

// ---------------------------------------------------------- LayerNorm ----

constexpr int LN_THREADS = 256;  // 8 rows per block, one warp each

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out = (x - mean) * rsqrt(var + eps) * gamma + beta, fp32 in, bf16 out
__global__ void __launch_bounds__(LN_THREADS)
layer_norm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, bf16* __restrict__ out, int rows, int d,
                  float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += xr[c];
  const float mu = warp_sum(s) / (float)d;
  float v = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xc = xr[c] - mu;
    v += xc * xc;
  }
  const float r = 1.0f / sqrtf(warp_sum(v) / (float)d + eps);
  bf16* o = out + (size_t)row * d;
  for (int c = lane; c < d; c += 32) o[c] = __float2bfloat16((xr[c] - mu) * r * gamma[c] + beta[c]);
}

cudaError_t layer_norm(const float* x, const float* gamma, const float* beta, void* out,
                       int rows, int d, float eps, cudaStream_t stream) {
  const int per_block = LN_THREADS / 32;
  layer_norm_kernel<<<(rows + per_block - 1) / per_block, LN_THREADS, 0, stream>>>(
      x, gamma, beta, static_cast<bf16*>(out), rows, d, eps);
  return cudaGetLastError();
}

// what the attention core takes: int32 row counts, a grid of at most 65,535
// heads and query tiles of an item (any head dim, any K and F)
bool attention_shape_ok(int items, int heads, int nq, int nkv, int d) {
  return items > 0 && heads > 0 && heads <= 65535 && d % heads == 0 && nq > 0 && nkv > 0 &&
         (long long)items * nq <= 2147483647 && (long long)items * nkv <= 2147483647 &&
         (nq + IA_TILE - 1) / IA_TILE <= 65535;
}

// ------------------------------------------------------ W8A8 (B4-B6) ----
//
// The int8 blocks are B1-B3 with every projection as int8 x int8 -> int32:
// activations are row-quantized on the fly (row_quant_kernel), weights per
// output column once on the host, and each GEMM epilogue dequantizes as
// (float(acc) * row_scale) * col_scale + bias.  The epilogues round with
// __fmul_rn / __fadd_rn so that no multiply-add is contracted: these are the
// JAX kernels' fp32 rounding points (ops/fused_qformer_int8.py _mm_q).

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// One warp per (row, group of `group` columns): absmax = max(max|x|, 1e-6),
// q = rint(x * fl(127 / absmax)) (half to even, no clip: |q| <= 127),
// scale[row * groups + g] = absmax / 127.  _row_quant of the JAX kernels.
// RCP_SCALE: scale = absmax * fl(1 / 127), the form XLA compiles
// `absmax / 127.0` to inside a jitted kernel (the Qwen3 blocks B8-B9b follow
// their JAX kernels there; B4-B6 keep the division).
// zero: null, or a [rows * groups] buffer set to 0 here (B9b's row maxima of
// h, which its gate|up epilogue then raises by atomics)
template <typename T, bool RCP_SCALE = false>
__global__ void __launch_bounds__(LN_THREADS)
row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                 int rows, int width, int group, float* __restrict__ zero) {
  const int lane = threadIdx.x & 31;
  const int groups = width / group;
  const long long w = (long long)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (w >= (long long)rows * groups) return;
  const size_t off = (size_t)w * group;  // row-major: row * width + g * group
  const T* xr = x + off;
  float m = 0.f;
  for (int c = lane; c < group; c += 32) m = fmaxf(m, fabsf(to_float(xr[c])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float absmax = fmaxf(m, 1e-6f);
  const float r = 127.0f / absmax;
  int8_t* qr = q + off;
  for (int c = lane; c < group; c += 32)
    qr[c] = (int8_t)__float2int_rn(__fmul_rn(to_float(xr[c]), r));
  if (lane == 0) {
    scale[w] = RCP_SCALE ? __fmul_rn(absmax, 1.0f / 127.0f) : absmax / 127.0f;
    if (zero != nullptr) zero[w] = 0.f;
  }
}

template <typename T, bool RCP_SCALE = false>
cudaError_t row_quant(const void* x, void* q, float* scale, int rows, int width, int group,
                      cudaStream_t stream, float* zero = nullptr) {
  const int per_block = LN_THREADS / 32;
  const long long warps = (long long)rows * (width / group);
  row_quant_kernel<T, RCP_SCALE><<<(unsigned)((warps + per_block - 1) / per_block), LN_THREADS, 0,
                        stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(q), scale,
                                  rows, width, group, zero);
  return cudaGetLastError();
}

// B6's gelu and the quantization of h in one pass: one block of GQ_THREADS
// per (row, group of `group` columns, a multiple of 64) reads the up
// projection's fp32 output u once with 16-byte loads, keeps h = gelu_tanh(u)
// in registers (up to 16 values a thread: every group up to GQ_MAX, which
// covers every chunk ffn_q_chunk picks; a wider group reads u twice), takes
// the absmax of h over the group (warp shuffles, then the block's warps)
// and writes the codes and the scale as row_quant_kernel<float> does from
// h.  h never reaches memory: the down projection reads only its codes.
// The gelu, the costliest part of B6's epilogue, runs here at full
// occupancy instead of in the GEMM's exposed epilogue (PERF.md §6).
constexpr int GQ_THREADS = 256;
constexpr int GQ_MAX = 4096;

__device__ __forceinline__ uint32_t gq_codes(float h0, float h1, float h2, float h3, float r) {
  const float h[4] = {h0, h1, h2, h3};
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    packed |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fmul_rn(h[i], r)) << (8 * i);
  return packed;
}

__global__ void __launch_bounds__(GQ_THREADS)
gelu_quant_kernel(const float* __restrict__ u, int8_t* __restrict__ q, float* __restrict__ scale,
                  int group) {
  extern __shared__ float wmax[];  // [GQ_THREADS / 32]
  const size_t w = blockIdx.x;  // row * groups + g
  const float4* ur = reinterpret_cast<const float4*>(u + w * group);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + w * group);
  const int t = threadIdx.x;
  const int n4 = group / 4;
  auto block_max = [&](float m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((t & 31) == 0) wmax[t >> 5] = m;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < GQ_THREADS / 32; ++i) m = fmaxf(m, wmax[i]);
    return fmaxf(m, 1e-6f);
  };
  float m = 0.f, absmax;
  if (group <= GQ_MAX) {
    float h[GQ_MAX / GQ_THREADS];
#pragma unroll
    for (int j = 0; j < GQ_MAX / GQ_THREADS / 4; ++j) {
      const int c = j * GQ_THREADS + t;
      if (c < n4) {
        const float4 x = ur[c];
        h[4 * j] = gelu_tanh(x.x);
        h[4 * j + 1] = gelu_tanh(x.y);
        h[4 * j + 2] = gelu_tanh(x.z);
        h[4 * j + 3] = gelu_tanh(x.w);
        m = fmaxf(m, fmaxf(fmaxf(fabsf(h[4 * j]), fabsf(h[4 * j + 1])),
                           fmaxf(fabsf(h[4 * j + 2]), fabsf(h[4 * j + 3]))));
      }
    }
    absmax = block_max(m);
    const float r = 127.0f / absmax;
#pragma unroll
    for (int j = 0; j < GQ_MAX / GQ_THREADS / 4; ++j) {
      const int c = j * GQ_THREADS + t;
      if (c < n4) qr[c] = gq_codes(h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3], r);
    }
  } else {
    for (int c = t; c < n4; c += GQ_THREADS) {
      const float4 x = ur[c];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(gelu_tanh(x.x)), fabsf(gelu_tanh(x.y))),
                         fmaxf(fabsf(gelu_tanh(x.z)), fabsf(gelu_tanh(x.w)))));
    }
    absmax = block_max(m);
    const float r = 127.0f / absmax;
    for (int c = t; c < n4; c += GQ_THREADS) {
      const float4 x = ur[c];
      qr[c] = gq_codes(gelu_tanh(x.x), gelu_tanh(x.y), gelu_tanh(x.z), gelu_tanh(x.w), r);
    }
  }
  if (t == 0) scale[w] = absmax / 127.0f;
}

cudaError_t gelu_quant(const float* u, void* q, float* scale, int rows, int width, int group,
                       cudaStream_t stream) {
  const long long blocks = (long long)rows * (width / group);
  gelu_quant_kernel<<<(unsigned)blocks, GQ_THREADS, GQ_THREADS / 32 * sizeof(float), stream>>>(
      u, static_cast<int8_t*>(q), scale, group);
  return cudaGetLastError();
}

// B9b's quantization of h [rows, width] fp32 (width a multiple of 4) with
// each row's max |h| given: scale[row] holds it on entry, as the float's
// bits that the gate|up epilogue raised by atomics, and the row scale on
// exit.  One warp per row reads h once with 16-byte loads and writes the
// codes rint(h * fl(127 / absmax)) and the scale absmax * fl(1 / 127),
// absmax = max(max |h|, 1e-6): row_quant_kernel<float, true>'s arithmetic
// without its first read of h.
__global__ void __launch_bounds__(LN_THREADS)
quant_given_max_kernel(const float* __restrict__ h, int8_t* __restrict__ q, float* scale, int rows,
                       int width) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float absmax = fmaxf(scale[row], 1e-6f);
  const float r = 127.0f / absmax;
  const float4* hr = reinterpret_cast<const float4*>(h + (size_t)row * width);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + (size_t)row * width);
#pragma unroll 4
  for (int c = lane; c < width / 4; c += 32) {
    const float4 v = hr[c];
    qr[c] = gq_codes(v.x, v.y, v.z, v.w, r);
  }
  __syncwarp();  // every lane has read the maximum before it is overwritten
  if (lane == 0) scale[row] = __fmul_rn(absmax, 1.0f / 127.0f);
}

cudaError_t quant_given_max(const float* h, void* q, float* scale, int rows, int width,
                            cudaStream_t stream) {
  const int per_block = LN_THREADS / 32;
  quant_given_max_kernel<<<(rows + per_block - 1) / per_block, LN_THREADS, 0, stream>>>(
      h, static_cast<int8_t*>(q), scale, rows, width);
  return cudaGetLastError();
}

// the dequantizing epilogue's inputs of an int8 product (gemm_wide.cuh)
WgEpi epq(const float* row_scale, int rs_stride, const float* col_scale, const float* bias,
          const void* resid = nullptr) {
  WgEpi e{};
  e.row_scale = row_scale;
  e.rs_stride = rs_stride;
  e.col_scale = col_scale;
  e.bias = bias;
  e.resid = static_cast<const bf16*>(resid);
  return e;
}

// B1-B3's residual product and LayerNorm, out [M, N] bf16 = LayerNorm(A .
// W^T + bias + resid), on the route their shape takes: one cluster launch
// that writes the LayerNorm itself where gemm_wide.cuh's wl_takes (TMA
// rows: K and N multiples of 8; N <= 2048), else the fp32 sum into acc [M,
// N] and layer_norm_kernel (acc may be null on the cluster route)
cudaError_t resid_ln(const void* A, const void* W, const float* bias, const void* resid,
                     const float* gamma, const float* beta, float eps, void* out, float* acc,
                     int M, int N, int K, cudaStream_t stream) {
  if (wl_takes(A, W, resid, N, K))
    return gemm_resid_ln(A, W, bias, resid, gamma, beta, eps, out, M, N, K, stream);
  if (acc == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = gemm_wide<WG_BIAS_RESID>(A, W, bias, acc, M, N, K, stream, resid);
  return err != cudaSuccess ? err : layer_norm(acc, gamma, beta, out, M, N, eps, stream);
}

}  // namespace

#define UNIREC_TRY(call)                     \
  do {                                       \
    const cudaError_t e_ = (call);           \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

// B1-B3's scratch acc (the fp32 pre-LN sum [rows, d]) is read only where
// resid_ln takes the two-pass route (d > 2048 or K not a multiple of 8) and
// may be null elsewhere.  The wrappers ask this entry which route a residual
// product of n columns over k inputs takes (1: two passes, acc needed), for
// 16-byte aligned operands, which they check.
extern "C" int unirec_resid_ln_two_pass(int n, int k) { return wl_shape(n, k) ? 0 : 1; }

//
// B1.  x, out [items*nq, d]; wqkv [3d, d] (rows Wq | Wk | Wv); wo [d, d];
// scratch qkv [items*nq, 3d] bf16, ctx [items*nq, d] bf16, acc.
extern "C" int unirec_qformer_self_block(const void* x, const void* wqkv, const float* bqkv,
                                         const void* wo, const float* bo, const float* gamma,
                                         const float* beta, void* out, void* qkv, void* ctx,
                                         float* acc, int items, int nq, int d, int heads,
                                         float scale, float eps, void* stream) {
  const long long rows = (long long)items * nq;
  if (!attention_shape_ok(items, heads, nq, nq, d) || !gemm_wide_shape_ok(rows, 3 * d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm_wide<WG_BIAS>(x, wqkv, bqkv, qkv, m, 3 * d, d, s));
  UNIREC_TRY(item_attention<IA_B1>(qkv, 3 * d, qkv, 3 * d, d, 2 * d, nullptr, ctx, d, items,
                                   heads, nq, nq, hd, scale, s));
  return (int)resid_ln(ctx, wo, bo, x, gamma, beta, eps, out, acc, m, d, d, s);
}

// B2.  x, out [items*nq, d]; mem [items*nkv, dm]; key_bias [items, nkv] fp32;
// wq [d, d]; wkv [2d, dm] (rows Wk | Wv); wo [d, d];
// scratch q [items*nq, d], kv [items*nkv, 2d], ctx [items*nq, d] bf16, acc.
extern "C" int unirec_qformer_cross_block(const void* x, const void* mem, const float* key_bias,
                                          const void* wq, const float* bq, const void* wkv,
                                          const float* bkv, const void* wo, const float* bo,
                                          const float* gamma, const float* beta, void* out,
                                          void* q, void* kv, void* ctx, float* acc, int items,
                                          int nq, int nkv, int d, int dm, int heads, float scale,
                                          float eps, void* stream) {
  const long long rows = (long long)items * nq;
  const long long mem_rows = (long long)items * nkv;
  if (!attention_shape_ok(items, heads, nq, nkv, d) || !gemm_wide_shape_ok(rows, d, d) ||
      !gemm_wide_shape_ok(mem_rows, 2 * d, dm))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(gemm_wide<WG_BIAS>(x, wq, bq, q, m, d, d, s));
  UNIREC_TRY(gemm_wide<WG_BIAS>(mem, wkv, bkv, kv, (int)mem_rows, 2 * d, dm, s));
  UNIREC_TRY(item_attention<IA_B1>(q, d, kv, 2 * d, 0, d, key_bias, ctx, d, items, heads, nq,
                                   nkv, hd, scale, s));
  return (int)resid_ln(ctx, wo, bo, x, gamma, beta, eps, out, acc, m, d, d, s);
}

// B3.  x, out [rows, d]; w1 [inter, d]; w2 [d, inter];
// scratch h [rows, inter] bf16 (the gelu output), acc.
extern "C" int unirec_qformer_ffn_block(const void* x, const void* w1, const float* b1,
                                        const void* w2, const float* b2, const float* gamma,
                                        const float* beta, void* out, void* h, float* acc,
                                        int rows, int d, int inter, float eps, void* stream) {
  if (!gemm_wide_shape_ok(rows, inter, d) || !gemm_wide_shape_ok(rows, d, inter))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UNIREC_TRY(gemm_wide<WG_BIAS_GELU>(x, w1, b1, h, rows, inter, d, s));
  return (int)resid_ln(h, w2, b2, x, gamma, beta, eps, out, acc, rows, d, inter, s);
}

// B4, the W8A8 B1.  x, out [items*nq, d] bf16; wqkv [3d, d] int8 (rows
// Wq | Wk | Wv) with column scales sqkv [3d]; wo [d, d] int8, so [d];
// scratch xq [items*nq, d] int8 and xs [items*nq] fp32 (x's codes and row
// scales, then ctx's), qkv [items*nq, 3d] bf16, ctx [items*nq, d] bf16,
// acc [items*nq, d] fp32.
extern "C" int unirec_qformer_self_block_q(const void* x, const void* wqkv, const float* sqkv,
                                           const float* bqkv, const void* wo, const float* so,
                                           const float* bo, const float* gamma,
                                           const float* beta, void* out, void* xq, float* xs,
                                           void* qkv, void* ctx, float* acc, int items, int nq,
                                           int d, int heads, float scale, float eps,
                                           void* stream) {
  const long long rows = (long long)items * nq;
  if (!attention_shape_ok(items, heads, nq, nq, d) || !gemm_wide_shape_ok(rows, 3 * d, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, hd = d / heads;
  UNIREC_TRY(row_quant<bf16>(x, xq, xs, m, d, d, s));
  UNIREC_TRY(gemm_q<EPQ_BIAS>(xq, wqkv, epq(xs, 1, sqkv, bqkv), qkv, m, 3 * d, d, s));
  UNIREC_TRY(item_attention<IA_B1>(qkv, 3 * d, qkv, 3 * d, d, 2 * d, nullptr, ctx, d, items,
                                   heads, nq, nq, hd, scale, s));
  UNIREC_TRY(row_quant<bf16>(ctx, xq, xs, m, d, d, s));
  UNIREC_TRY(gemm_q<EPQ_BIAS_RESID>(xq, wo, epq(xs, 1, so, bo, x), acc, m, d, d, s));
  return (int)layer_norm(acc, gamma, beta, out, m, d, eps, s);
}

// B5, the W8A8 B2.  x, out [items*nq, d] bf16; mem [items*nkv, dm] bf16;
// key_bias [items, nkv] fp32; wq [d, d], wkv [2d, dm] (rows Wk | Wv), wo
// [d, d] int8 with column scales sq, skv, so; scratch xq [items*nq, d] int8
// and xs [items*nq] (x's, then ctx's), mq [items*nkv, dm] int8 and ms
// [items*nkv], q [items*nq, d], kv [items*nkv, 2d], ctx [items*nq, d] bf16,
// acc [items*nq, d] fp32.
extern "C" int unirec_qformer_cross_block_q(
    const void* x, const void* mem, const float* key_bias, const void* wq, const float* sq,
    const float* bq, const void* wkv, const float* skv, const float* bkv, const void* wo,
    const float* so, const float* bo, const float* gamma, const float* beta, void* out,
    void* xq, float* xs, void* mq, float* ms, void* q, void* kv, void* ctx, float* acc,
    int items, int nq, int nkv, int d, int dm, int heads, float scale, float eps,
    void* stream) {
  const long long rows = (long long)items * nq;
  const long long mem_rows = (long long)items * nkv;
  if (!attention_shape_ok(items, heads, nq, nkv, d) || !gemm_wide_shape_ok(rows, d, d) ||
      !gemm_wide_shape_ok(mem_rows, 2 * d, dm))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)rows, mm = (int)mem_rows, hd = d / heads;
  UNIREC_TRY(row_quant<bf16>(x, xq, xs, m, d, d, s));
  UNIREC_TRY(gemm_q<EPQ_BIAS>(xq, wq, epq(xs, 1, sq, bq), q, m, d, d, s));
  UNIREC_TRY(row_quant<bf16>(mem, mq, ms, mm, dm, dm, s));
  UNIREC_TRY(gemm_q<EPQ_BIAS>(mq, wkv, epq(ms, 1, skv, bkv), kv, mm, 2 * d, dm, s));
  UNIREC_TRY(item_attention<IA_B1>(q, d, kv, 2 * d, 0, d, key_bias, ctx, d, items, heads, nq,
                                   nkv, hd, scale, s));
  UNIREC_TRY(row_quant<bf16>(ctx, xq, xs, m, d, d, s));
  UNIREC_TRY(gemm_q<EPQ_BIAS_RESID>(xq, wo, epq(xs, 1, so, bo, x), acc, m, d, d, s));
  return (int)layer_norm(acc, gamma, beta, out, m, d, eps, s);
}

// B6, the W8A8 FFN.  x, out [rows, d] bf16; w1 [inter, d] int8, s1 [inter];
// w2 [d, inter] int8, s2 [d]; the gelu output h is requantized per row over
// each group of `chunk` intermediate columns (a multiple of 64).  Scratch xq [rows, d] int8, xs [rows], u [rows, inter] fp32 (the up
// projection before its gelu), hq [rows, inter] int8, hs [rows,
// inter/chunk], acc [rows, d] fp32.
extern "C" int unirec_qformer_ffn_block_q(const void* x, const void* w1, const float* s1,
                                          const float* b1, const void* w2, const float* s2,
                                          const float* b2, const float* gamma,
                                          const float* beta, void* out, void* xq, float* xs,
                                          float* u, void* hq, float* hs, float* acc, int rows,
                                          int d, int inter, int chunk, float eps, void* stream) {
  if (!gemm_wide_shape_ok(rows, inter, d) || !gemm_wide_shape_ok(rows, d, inter) || chunk <= 0 ||
      chunk % 64 != 0 || inter % chunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UNIREC_TRY(row_quant<bf16>(x, xq, xs, rows, d, d, s));
  UNIREC_TRY(gemm_q<EPQ_BIAS_F32>(xq, w1, epq(xs, 1, s1, b1), u, rows, inter, d, s));
  UNIREC_TRY(gelu_quant(u, hq, hs, rows, inter, chunk, s));
  WgEpi down = epq(hs, inter / chunk, s2, b2, x);
  down.chunk = chunk;
  UNIREC_TRY(gemm_q<EPQ_CHUNKED_RESID>(hq, w2, down, acc, rows, d, inter, s));
  return (int)layer_norm(acc, gamma, beta, out, rows, d, eps, s);
}

// ------------------------------------------- Qwen3 W8A8 (B8, B9a, B9b) ----
//
// The int8 serving forward of the joint model's Qwen3-0.6B, on the int8 TMA
// + wgmma GEMM of gemm_wide.cuh that B4-B6 run on (gemm_q), with the
// bias-free dequantizing epilogue to bf16 (EPQ_PLAIN) and the SwiGLU
// epilogue (EPQ_SWIGLU).  At batch 8 x L 512 = 4096 rows a layer's
// projections are 129 GOP against 16 MB of int8 weights and ~60 MB of
// activations: bound by tensor-core arithmetic, as the Item Q-Former's GEMMs
// are.  The mma.sync GEMM they ran on first reached 21-22% of the int8
// peak at these shapes (PERF.md).
//
// B8 and B9a are one computation (JAX's int8_matmul._kernel and
// fused_qwen3_int8._qkv_kernel both quantize each row with absmax/127 and
// dequantize (float(acc) * rs) * cs, rs = absmax * fl(1/127) as XLA compiles
// them), so B9a is unirec_int8_linear over the concatenated [Wq | Wk | Wv]
// rows: one row-quantization pass into an int8 buffer, then the GEMM.  The
// TPU kernel recomputes the row quantization per column tile to avoid that
// buffer; the codes are the same.  B9b keeps the JAX kernel's grouping:
// h = silu(g) * u in fp32, one row quantization over the whole intermediate,
// then the down GEMM.  The TPU holds gu and h in VMEM; an SM cannot hold a
// [rows, 3072] fp32 tile, so h goes through HBM once: the gate|up product
// pairs each gate column with its up column in one tile (two TMA boxes of
// W), writes h in fp32 (50 MB per layer at 4096 rows) and raises each row's
// max |h| by atomics, so the quantization pass reads h once
// (quant_given_max), and the down GEMM reads its codes (12.6 MB).  Keeping
// h on the SM (quantized by the down GEMM's producer) is next.

// B8 (and B9a): out [m, n] bf16 = W8A8(x [m, k] bf16, wq [n, k] int8,
// ws [n]); scratch xq [m, k] int8, xs [m] fp32.
extern "C" int unirec_int8_linear(const void* x, const void* wq, const float* ws, void* out,
                                  void* xq, float* xs, int m, int n, int k, void* stream) {
  if (!gemm_wide_shape_ok(m, n, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UNIREC_TRY((row_quant<bf16, true>(x, xq, xs, m, k, k, s)));
  return (int)gemm_q<EPQ_PLAIN>(xq, wq, epq(xs, 1, ws, nullptr), out, m, n, k, s);
}

// B9b: the whole SwiGLU MLP.  x, out [rows, d] bf16; wgu [2 * inter, d] int8
// (gate rows, then up rows) with sgu [2 * inter]; wd [d, inter] int8, sd [d];
// scratch xq [rows, d] int8, xs [rows], h [rows, inter] fp32, hq [rows,
// inter] int8, hs [rows].
extern "C" int unirec_qwen3_swiglu_q(const void* x, const void* wgu, const float* sgu,
                                     const void* wd, const float* sd, void* out, void* xq,
                                     float* xs, float* h, void* hq, float* hs, int rows, int d,
                                     int inter, void* stream) {
  if (inter <= 0 || inter % 16 != 0 || !gemm_wide_shape_ok(rows, inter, d) ||
      !gemm_wide_shape_ok(rows, d, inter) || !wt_takes<int8_t>(xq, wgu, d) ||
      (uintptr_t)h % 16 != 0 || (uintptr_t)hq % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UNIREC_TRY((row_quant<bf16, true>(x, xq, xs, rows, d, d, s, hs)));  // hs = 0: h's row maxima
  WgEpi gu = epq(xs, 1, sgu, nullptr);
  gu.row_max = reinterpret_cast<int*>(hs);
  UNIREC_TRY(gemm_q<EPQ_SWIGLU>(xq, wgu, gu, h, rows, inter, d, s));
  UNIREC_TRY(quant_given_max(h, hq, hs, rows, inter, s));
  return (int)gemm_q<EPQ_PLAIN>(hq, wd, epq(hs, 1, sd, nullptr), out, rows, d, inter, s);
}

// For the tests only: C = epilogue(A . W^T) by gemm_q, in each int8
// epilogue of gemm_wide.cuh, so that each can be held bit for bit to its
// plain form (ops/fused_qformer_int8._mm_q: the exact product, then the
// same fp32 rounding).  epi 0 EPQ_BIAS, 1 EPQ_BIAS_F32, 2 EPQ_BIAS_RESID, 3
// EPQ_CHUNKED_RESID (row_scale [m, k / chunk]), 4 EPQ_PLAIN, 5 EPQ_SWIGLU
// (w [2n, k], gate rows then up rows; c [m, n] fp32 is h; row_max [m],
// zeros on entry, receives each row's max |h|).
extern "C" int unirec_gemm_q_test(int epi, const void* a, const void* w, const float* row_scale,
                                  int rs_stride, const float* col_scale, const float* bias,
                                  const void* resid, void* c, float* row_max, int m, int n, int k,
                                  int chunk, void* stream) {
  if (epi < 0 || epi > 5 || !gemm_wide_shape_ok(m, n, k) ||
      (epi == 3 && (chunk <= 0 || chunk % 64 != 0 || k % chunk != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WgEpi e = epq(row_scale, rs_stride, col_scale, bias, resid);
  e.chunk = chunk;
  e.row_max = reinterpret_cast<int*>(row_max);
  switch (epi) {
    case 0:
      return (int)gemm_q<EPQ_BIAS>(a, w, e, c, m, n, k, s);
    case 1:
      return (int)gemm_q<EPQ_BIAS_F32>(a, w, e, c, m, n, k, s);
    case 2:
      return (int)gemm_q<EPQ_BIAS_RESID>(a, w, e, c, m, n, k, s);
    case 3:
      return (int)gemm_q<EPQ_CHUNKED_RESID>(a, w, e, c, m, n, k, s);
    case 4:
      return (int)gemm_q<EPQ_PLAIN>(a, w, e, c, m, n, k, s);
    default:
      return (int)gemm_q<EPQ_SWIGLU>(a, w, e, c, m, n, k, s);
  }
}

// For the tests only: B1-B3's residual product and LayerNorm, out [m, n]
// bf16 = LayerNorm(a . w^T + bias + resid), by WG_BIAS_RESID_LN's cluster
// launch (which = 1; refused where wl_takes does not hold) or as two passes,
// WG_BIAS_RESID into acc [m, n] fp32 and layer_norm_kernel (which = 0).
extern "C" int unirec_gemm_ln_test(int which, const void* a, const void* w, const float* bias,
                                   const void* resid, const float* gamma, const float* beta,
                                   void* out, float* acc, int m, int n, int k, float eps,
                                   void* stream) {
  if (!gemm_wide_shape_ok(m, n, k) || (which == 0 && acc == nullptr) ||
      (which && !wl_takes(a, w, resid, n, k)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which) return (int)gemm_resid_ln(a, w, bias, resid, gamma, beta, eps, out, m, n, k, s);
  UNIREC_TRY(gemm_wide<WG_BIAS_RESID>(a, w, bias, acc, m, n, k, s, resid));
  return (int)layer_norm(acc, gamma, beta, out, m, n, eps, s);
}
