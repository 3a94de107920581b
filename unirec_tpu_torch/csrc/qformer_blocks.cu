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
// Design (every GEMM hand-written here):
//   * gemm_bf16_kernel (in gemm_bf16.cuh), B1-B3's products at widths that
//     are whole 16-byte rows (every production width):
//     C[M, N] = A[M, K] . W[N, K]^T, both operands bf16 with
//     K contiguous (W is the torch Linear layout, packed once on the host),
//     128x128x32 block tiles, 8 warps of 64x32, mma.sync m16n8k16 with fp32
//     accumulation, ldmatrix from padded shared rows, a 3-stage cp.async
//     ring.  Ragged M (the 32-row layer-0 self block, B*14 memory rows), N
//     and K edges are zero-filled on load and masked on store.  Epilogues:
//     +bias -> bf16 (QKV, Q, KV), +bias -> tanh gelu in fp32 -> bf16 (FFN
//     up), +bias +residual -> fp32 (Wo, FFN down).  At other widths (hidden
//     1020: C-10) the same products and epilogues run on gemm_wide.cuh's
//     warpgroup kernels (gemm_any).
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
//     rsqrt, output bf16.
// What this design spills to HBM that the TPU kernels kept on chip, at 4096
// items (131,072 query rows): B1 the qkv buffer [rows, 3072] bf16 (805 MB),
// ctx [rows, 1024] bf16 (268 MB) and the fp32 pre-LN sum (537 MB); B2 q
// (268 MB), kv [57,344, 2048] bf16 (235 MB), ctx and the pre-LN sum; B3 the
// gelu output [rows, 4096] bf16 (1.07 GB) and the pre-LN sum.  Keeping them
// on the SM (wgmma, TMA, fused epilogues) is later work.
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
// projection folds its int32 sums into fp32 at every chunk boundary.
// gemm_s8_kernel below (mma.sync m16n8k32) is left to the Qwen3 kernels
// B8/B9a/B9b and to a test entry that holds the new GEMM to it bit for bit.
//
// Every C entry launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_bf16.cuh"
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

// gemm_s8_kernel keeps the bf16 GEMM's byte layout: a 64-byte int8 k-tile
// is a 32-value bf16 one, so loads, ldmatrix addresses and the 80-byte
// padded rows are the same; two m16n8k32 steps cover a tile.
constexpr int QBK = 64;                  // int8 values of K per tile
constexpr int QLDS = QBK + 16;           // padded shared row in bytes
constexpr int QA_TILE = BM * QLDS;
constexpr int QW_TILE = BN * QLDS;
constexpr int QGEMM_SMEM = STAGES * (QA_TILE + QW_TILE);  // 61,440

// gemm_s8_kernel's epilogues: gemm_wide.cuh's EPQ_BIAS, EPQ_BIAS_RESID and
// EPQ_CHUNKED_RESID, and its own
enum { EPQ_BIAS_GELU = EPQ_CHUNKED_RESID + 1, EPQ_PLAIN, EPQ_SWIGLU };

// C[M, N] = epilogue(A[M, K] . W[N, K]^T), int8 operands with K contiguous.
// row_scale[row * rs_stride + c] scales row `row` over the c-th group of
// `chunk` columns of K.  Epilogues:
//   EPQ_BIAS          (acc * rs) * cs + bias -> bf16
//   EPQ_BIAS_GELU     gelu_tanh((acc * rs) * cs + bias) -> fp32
//   EPQ_BIAS_RESID    (acc * rs) * cs + bias + resid -> fp32
//   EPQ_CHUNKED_RESID f = sum over groups of float(acc_group) * rs_group, in
//                     group order; f * cs + bias + resid -> fp32 (the FFN's
//                     down projection, its h requantized per chunk)
//   EPQ_PLAIN         (acc * rs) * cs -> bf16, no bias (the Qwen3 projections)
//   EPQ_SWIGLU        W is [gate rows | up rows] ([2I, K], N = 2I); the tile
//                     loader interleaves them in groups of 8, so that fragment
//                     ni (even) holds gate and ni + 1 up of the same 8 columns
//                     of h, and C[M, I] fp32 = (g * sigmoid(g)) * u with
//                     g = (acc_g * rs) * cs_g, u = (acc_u * rs) * cs_u
// M any; N a multiple of 8 (of 16 for EPQ_SWIGLU); K a multiple of 16 (of
// `chunk`, itself a multiple of QBK, for EPQ_CHUNKED_RESID).
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
               const float* __restrict__ row_scale, int rs_stride,
               const float* __restrict__ col_scale, const float* __restrict__ bias,
               const bf16* __restrict__ resid, void* __restrict__ C, int M, int N, int K,
               int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Ws = As + STAGES * QA_TILE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // warp rows wm*64 .. +63
  const int wn = warp & 3;   // warp cols wn*32 .. +31
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (K + QBK - 1) / QBK;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * QBK;
    int8_t* as = As + stage * QA_TILE;
    int8_t* ws = Ws + stage * QW_TILE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;  // 512 chunks of 16 bytes per operand
      const int r = c >> 2;
      const int kc = (c & 3) * 16;
      const int gk = k0 + kc;
      const bool pa = gk < K && m0 + r < M;
      cp_async_16(smem_addr(as + r * QLDS + kc), pa ? A + (size_t)(m0 + r) * K + gk : A, pa);
      int wrow = n0 + r;
      bool pw = gk < K && wrow < N;
      if constexpr (EPI == EPQ_SWIGLU) {  // tile row r: gate (r & 8 == 0) or up
        const int inter = N >> 1;
        const int hcol = (n0 >> 1) + (r >> 4) * 8 + (r & 7);
        wrow = hcol + ((r & 8) ? inter : 0);
        pw = gk < K && hcol < inter;
      }
      cp_async_16(smem_addr(ws + r * QLDS + kc), pw ? W + (size_t)wrow * K + gk : W, pw);
    }
  };

  int acc[4][4][4];
  float facc[4][4][4];  // EPQ_CHUNKED_RESID only
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        facc[i][j][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }

  const int tiles_per_chunk = chunk / QBK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // and every warp is done with tile kt - 1
    const int next = kt + STAGES - 1;
    if (next < k_tiles) load_tile(next % STAGES, next);
    cp_async_commit();

    const int8_t* as = As + (kt % STAGES) * QA_TILE;
    const int8_t* ws = Ws + (kt % STAGES) * QW_TILE;
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 32) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // matrices: (rows 0-7, k 0-15), (rows 8-15, k 0-15), (rows 0-7, k 16-31), ...
        const int r = wm * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(a[mi], smem_addr(as + r * QLDS + kk + (lane >> 4) * 16));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31)
        const int n = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t t[4];
        ldmatrix_x4(t, smem_addr(ws + n * QLDS + kk + ((lane >> 3) & 1) * 16));
        b[2 * nj][0] = t[0];
        b[2 * nj][1] = t[1];
        b[2 * nj + 1][0] = t[2];
        b[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }

    if constexpr (EPI == EPQ_CHUNKED_RESID) {
      if ((kt + 1) % tiles_per_chunk == 0) {  // fold the finished group
        const int grp = kt / tiles_per_chunk;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = m0 + wm * 64 + mi * 16 + g + hf * 8;
            const float rs = row < M ? row_scale[(size_t)row * rs_stride + grp] : 0.f;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                int& a_ = acc[mi][ni][2 * hf + e];
                float& f_ = facc[mi][ni][2 * hf + e];
                f_ = __fadd_rn(f_, __fmul_rn(__int2float_rn(a_), rs));
                a_ = 0;
              }
          }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8
  if constexpr (EPI == EPQ_SWIGLU) {
    const int inter = N >> 1;
#pragma unroll
    for (int ni = 0; ni < 4; ni += 2) {  // ni: gate, ni + 1: up, same columns of h
      const int col = (n0 >> 1) + (wn * 2 + (ni >> 1)) * 8 + t4 * 2;
      if (col >= inter) continue;
      const float cg[2] = {col_scale[col], col_scale[col + 1]};
      const float cu[2] = {col_scale[inter + col], col_scale[inter + col + 1]};
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + wm * 64 + mi * 16 + g + hf * 8;
          if (row >= M) continue;
          const float rs = row_scale[(size_t)row * rs_stride];
          float h[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gv =
                __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * hf + e]), rs), cg[e]);
            const float uv =
                __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni + 1][2 * hf + e]), rs), cu[e]);
            const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gv)));
            h[e] = __fmul_rn(__fmul_rn(gv, sig), uv);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(C) + (size_t)row * inter + col) =
              make_float2(h[0], h[1]);
        }
      }
    }
  } else {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + t4 * 2;
      if (col >= N) continue;
      const float cs[2] = {col_scale[col], col_scale[col + 1]};
      float bs[2] = {0.f, 0.f};
      if constexpr (EPI != EPQ_PLAIN) {
        bs[0] = bias[col];
        bs[1] = bias[col + 1];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + wm * 64 + mi * 16 + g + hf * 8;
          if (row >= M) continue;
          const size_t off = (size_t)row * N + col;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (EPI == EPQ_CHUNKED_RESID) {
              v[e] = __fmul_rn(facc[mi][ni][2 * hf + e], cs[e]);
            } else {
              const float rs = row_scale[(size_t)row * rs_stride];
              v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * hf + e]), rs), cs[e]);
            }
            if constexpr (EPI != EPQ_PLAIN) v[e] = __fadd_rn(v[e], bs[e]);
          }
          if constexpr (EPI == EPQ_BIAS || EPI == EPQ_PLAIN) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + off) =
                __floats2bfloat162_rn(v[0], v[1]);
          } else {
            if constexpr (EPI == EPQ_BIAS_GELU) {
              v[0] = gelu_tanh(v[0]);
              v[1] = gelu_tanh(v[1]);
            } else {
              const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(resid + off);
              v[0] = __fadd_rn(v[0], __bfloat162float(r.x));
              v[1] = __fadd_rn(v[1], __bfloat162float(r.y));
            }
            *reinterpret_cast<float2*>(static_cast<float*>(C) + off) = make_float2(v[0], v[1]);
          }
        }
      }
    }
  }
}

template <int EPI>
cudaError_t gemm_s8(const void* A, const void* W, const float* row_scale, int rs_stride,
                    const float* col_scale, const float* bias, const void* resid, void* C, int M,
                    int N, int K, int chunk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_s8_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, QGEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_s8_kernel<EPI><<<grid, GEMM_THREADS, QGEMM_SMEM, stream>>>(
      static_cast<const int8_t*>(A), static_cast<const int8_t*>(W), row_scale, rs_stride,
      col_scale, bias, static_cast<const bf16*>(resid), C, M, N, K, chunk);
  return cudaGetLastError();
}

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// One warp per (row, group of `group` columns): absmax = max(max|x|, 1e-6),
// q = rint(x * fl(127 / absmax)) (half to even, no clip: |q| <= 127),
// scale[row * groups + g] = absmax / 127.  _row_quant of the JAX kernels.
// RCP_SCALE: scale = absmax * fl(1 / 127), the form XLA compiles
// `absmax / 127.0` to inside a jitted kernel (the Qwen3 blocks B8-B9b follow
// their JAX kernels there; B4-B6 keep the division).
template <typename T, bool RCP_SCALE = false>
__global__ void __launch_bounds__(LN_THREADS)
row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                 int rows, int width, int group) {
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
  if (lane == 0) scale[w] = RCP_SCALE ? __fmul_rn(absmax, 1.0f / 127.0f) : absmax / 127.0f;
}

template <typename T, bool RCP_SCALE = false>
cudaError_t row_quant(const void* x, void* q, float* scale, int rows, int width, int group,
                      cudaStream_t stream) {
  const int per_block = LN_THREADS / 32;
  const long long warps = (long long)rows * (width / group);
  row_quant_kernel<T, RCP_SCALE><<<(unsigned)((warps + per_block - 1) / per_block), LN_THREADS, 0,
                        stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(q), scale,
                                  rows, width, group);
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

// B1-B3's products: gemm_bf16.cuh where the rows are whole 16-byte chunks
// (every production width), gemm_wide.cuh's kernels otherwise (C-10)
template <int EPI>
cudaError_t gemm_any(const void* A, const void* W, const float* bias, const void* resid, void* C,
                     int M, int N, int K, cudaStream_t stream) {
  if (gemm_shape_ok(M, N, K)) return gemm<EPI>(A, W, bias, resid, C, M, N, K, stream);
  constexpr int WEPI = EPI == EPI_BIAS        ? WG_BIAS
                       : EPI == EPI_BIAS_GELU ? WG_BIAS_GELU
                       : EPI == EPI_BIAS_RESID ? WG_BIAS_RESID
                                               : WG_F32;
  return gemm_wide<WEPI>(A, W, bias, C, M, N, K, stream, resid);
}

bool gemm_s8_shape_ok(long long m, int n, int k) {
  return m > 0 && m <= 2147483647 && n > 0 && k > 0 && n % 8 == 0 && k % 16 == 0 &&
         (m + BM - 1) / BM <= 65535;
}

}  // namespace

#define UNIREC_TRY(call)                     \
  do {                                       \
    const cudaError_t e_ = (call);           \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

// B1.  x, out [items*nq, d]; wqkv [3d, d] (rows Wq | Wk | Wv); wo [d, d];
// scratch qkv [items*nq, 3d] bf16, ctx [items*nq, d] bf16, acc [items*nq, d] fp32.
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
  UNIREC_TRY(gemm_any<EPI_BIAS>(x, wqkv, bqkv, nullptr, qkv, m, 3 * d, d, s));
  UNIREC_TRY(item_attention<IA_B1>(qkv, 3 * d, qkv, 3 * d, d, 2 * d, nullptr, ctx, d, items,
                                   heads, nq, nq, hd, scale, s));
  UNIREC_TRY(gemm_any<EPI_BIAS_RESID>(ctx, wo, bo, x, acc, m, d, d, s));
  return (int)layer_norm(acc, gamma, beta, out, m, d, eps, s);
}

// B2.  x, out [items*nq, d]; mem [items*nkv, dm]; key_bias [items, nkv] fp32;
// wq [d, d]; wkv [2d, dm] (rows Wk | Wv); wo [d, d];
// scratch q [items*nq, d], kv [items*nkv, 2d], ctx [items*nq, d] bf16, acc fp32.
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
  UNIREC_TRY(gemm_any<EPI_BIAS>(x, wq, bq, nullptr, q, m, d, d, s));
  UNIREC_TRY(gemm_any<EPI_BIAS>(mem, wkv, bkv, nullptr, kv, (int)mem_rows, 2 * d, dm, s));
  UNIREC_TRY(item_attention<IA_B1>(q, d, kv, 2 * d, 0, d, key_bias, ctx, d, items, heads, nq,
                                   nkv, hd, scale, s));
  UNIREC_TRY(gemm_any<EPI_BIAS_RESID>(ctx, wo, bo, x, acc, m, d, d, s));
  return (int)layer_norm(acc, gamma, beta, out, m, d, eps, s);
}

// B3.  x, out [rows, d]; w1 [inter, d]; w2 [d, inter];
// scratch h [rows, inter] bf16 (the gelu output), acc [rows, d] fp32.
extern "C" int unirec_qformer_ffn_block(const void* x, const void* w1, const float* b1,
                                        const void* w2, const float* b2, const float* gamma,
                                        const float* beta, void* out, void* h, float* acc,
                                        int rows, int d, int inter, float eps, void* stream) {
  if (!gemm_wide_shape_ok(rows, inter, d) || !gemm_wide_shape_ok(rows, d, inter))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UNIREC_TRY(gemm_any<EPI_BIAS_GELU>(x, w1, b1, nullptr, h, rows, inter, d, s));
  UNIREC_TRY(gemm_any<EPI_BIAS_RESID>(h, w2, b2, x, acc, rows, d, inter, s));
  return (int)layer_norm(acc, gamma, beta, out, rows, d, eps, s);
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
// The int8 serving forward of the joint model's Qwen3-0.6B.  The same s8
// GEMM and row quantization as B4-B6, with a bias-free dequantizing epilogue
// to bf16 (EPQ_PLAIN) and the SwiGLU epilogue (EPQ_SWIGLU).  At batch 8 x
// L 512 = 4096 rows a layer's projections are 129 GOP against 16 MB of int8
// weights and ~60 MB of activations: bound by tensor-core arithmetic, as the
// Item Q-Former's GEMMs are.
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
// [rows, 3072] fp32 tile, so this first design writes h to HBM from the
// gate|up epilogue (50 MB per layer at 4096 rows) and reads it twice in the
// quantization pass, and its codes (12.6 MB) once in the down GEMM.

// B8 (and B9a): out [m, n] bf16 = W8A8(x [m, k] bf16, wq [n, k] int8,
// ws [n]); scratch xq [m, k] int8, xs [m] fp32.
extern "C" int unirec_int8_linear(const void* x, const void* wq, const float* ws, void* out,
                                  void* xq, float* xs, int m, int n, int k, void* stream) {
  if (!gemm_s8_shape_ok(m, n, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UNIREC_TRY((row_quant<bf16, true>(x, xq, xs, m, k, k, s)));
  return (int)gemm_s8<EPQ_PLAIN>(xq, wq, xs, 1, ws, nullptr, nullptr, out, m, n, k, k, s);
}

// B9b: the whole SwiGLU MLP.  x, out [rows, d] bf16; wgu [2 * inter, d] int8
// (gate rows, then up rows) with sgu [2 * inter]; wd [d, inter] int8, sd [d];
// scratch xq [rows, d] int8, xs [rows], h [rows, inter] fp32, hq [rows,
// inter] int8, hs [rows].
extern "C" int unirec_qwen3_swiglu_q(const void* x, const void* wgu, const float* sgu,
                                     const void* wd, const float* sd, void* out, void* xq,
                                     float* xs, float* h, void* hq, float* hs, int rows, int d,
                                     int inter, void* stream) {
  if (inter <= 0 || inter % 16 != 0 || !gemm_s8_shape_ok(rows, 2 * inter, d) ||
      !gemm_s8_shape_ok(rows, d, inter))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UNIREC_TRY((row_quant<bf16, true>(x, xq, xs, rows, d, d, s)));
  UNIREC_TRY(gemm_s8<EPQ_SWIGLU>(xq, wgu, xs, 1, sgu, nullptr, nullptr, h, rows, 2 * inter, d, d,
                                 s));
  UNIREC_TRY((row_quant<float, true>(h, hq, hs, rows, inter, inter, s)));
  return (int)gemm_s8<EPQ_PLAIN>(hq, wd, hs, 1, sd, nullptr, nullptr, out, rows, d, inter, inter,
                                 s);
}

// For the tests only, while B8/B9 keep gemm_s8_kernel: one step of B4-B6 by
// the int8 GEMM of gemm_wide.cuh (which = 1) or as it ran on gemm_s8_kernel
// before (which = 0), so that the two can be held to each other bit for
// bit.  epi 0, 2, 3: C = epilogue(A . W^T) with EPQ_BIAS, EPQ_BIAS_RESID or
// EPQ_CHUNKED_RESID.  epi 1: B6's up projection, gelu and quantization of h
// per group of `chunk` columns: codes into c [m, n] and scales into scales
// [m, n / chunk], by EPQ_BIAS_F32 and gelu_quant (new) or EPQ_BIAS_GELU and
// row_quant<float> (before); scratch [m, n] fp32 holds u or h.
extern "C" int unirec_gemm_q_test(int which, int epi, const void* a, const void* w,
                                  const float* row_scale, int rs_stride, const float* col_scale,
                                  const float* bias, const void* resid, void* c, float* scratch,
                                  float* scales, int m, int n, int k, int chunk, void* stream) {
  if (epi < 0 || epi > 3 || !gemm_wide_shape_ok(m, n, k) ||
      (which == 0 && (!gemm_s8_shape_ok(m, n, k) || (epi == 3 && chunk % QBK != 0))) ||
      (epi == 3 && (chunk <= 0 || chunk % 64 != 0 || k % chunk != 0)) ||
      (epi == 1 && (chunk <= 0 || chunk % 64 != 0 || n % chunk != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WgEpi e = epq(row_scale, rs_stride, col_scale, bias, resid);
  e.chunk = chunk;
  switch (epi) {
    case 0:
      return (int)(which ? gemm_q<EPQ_BIAS>(a, w, e, c, m, n, k, s)
                         : gemm_s8<EPQ_BIAS>(a, w, row_scale, rs_stride, col_scale, bias,
                                             resid, c, m, n, k, chunk, s));
    case 1:
      if (which) {
        UNIREC_TRY(gemm_q<EPQ_BIAS_F32>(a, w, e, scratch, m, n, k, s));
        return (int)gelu_quant(scratch, c, scales, m, n, chunk, s);
      }
      UNIREC_TRY(gemm_s8<EPQ_BIAS_GELU>(a, w, row_scale, rs_stride, col_scale, bias, resid,
                                        scratch, m, n, k, k, s));
      return (int)row_quant<float>(scratch, c, scales, m, n, chunk, s);
    case 2:
      return (int)(which ? gemm_q<EPQ_BIAS_RESID>(a, w, e, c, m, n, k, s)
                         : gemm_s8<EPQ_BIAS_RESID>(a, w, row_scale, rs_stride, col_scale, bias,
                                                   resid, c, m, n, k, chunk, s));
    default:
      return (int)(which ? gemm_q<EPQ_CHUNKED_RESID>(a, w, e, c, m, n, k, s)
                         : gemm_s8<EPQ_CHUNKED_RESID>(a, w, row_scale, rs_stride, col_scale,
                                                      bias, resid, c, m, n, k, chunk, s));
  }
}
