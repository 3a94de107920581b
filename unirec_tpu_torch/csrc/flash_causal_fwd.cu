// Causal grouped-query flash-attention forward for Hopper (sm_90a).
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
// Masked keys (causal or padded) get probability exactly 0, which is what the
// additive -1e9 bias gives whenever a row has one unmasked key.  The wrapper
// guarantees that by requiring mask[:, 0] != 0 (key 0 is causal for every row).
//
// What bounds it: at the serving shape (B=8, L=512, Hq=16, Hkv=8, HD=128) the
// causal half of QK^T and PV is ~8.6 GFLOP per layer against ~25 MB of q/k/v/o
// traffic, so it is bound by arithmetic.  This first version does that
// arithmetic with scalar fp32 FMAs from shared memory (one code path for bf16
// and fp32 inputs, fp32 softmax and accumulator): a 64x64 tile per step, each
// thread owning a 4x4 block of scores and a 4x8 block of the output in
// registers; the (m, l) online-softmax state lives in registers, replicated
// over the 16 threads that share a row.  Tensor cores (mma.sync / wgmma) and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;           // head_dim this build supports
constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int QS = HD + 1;        // padded row strides (bank-conflict free)
constexpr int KS = HD + 1;
constexpr int PS = BK + 1;
constexpr int SMEM_FLOATS = BQ * QS + BK * KS + BQ * PS + BK;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_causal_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ mask,
                        T* __restrict__ out, int L, int Hq, int Hkv, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][QS]
  float* KVs = Qs + BQ * QS;       // [BK][KS]  K tile, then V tile
  float* Ps = KVs + BK * KS;       // [BQ][PS]  probabilities of this tile
  float* kval = Ps + BQ * PS;      // [BK]      key validity of this tile

  // longest rows first: the last q tiles loop over the most kv tiles
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // rows ty*4 .. ty*4+3
  const int tx = tid & 15;          // score cols tx + 16j, output cols tx + 16j
  const size_t q_row = (size_t)Hq * HD;
  const size_t kv_row = (size_t)Hkv * HD;
  const T* qb = q + (size_t)b * L * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const float* mb = mask + (size_t)b * L;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int row = q0 + r;
    Qs[r * QS + d] = row < L ? to_f(qb[(size_t)row * q_row + d]) : 0.f;
  }

  float acc[4][8];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int last_row = min(q0 + BQ, L) - 1;
  const int n_kv = last_row / BK + 1;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's V reads are done
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int c = e / HD, d = e % HD;
      const int key = k0 + c;
      KVs[c * KS + d] = key < L ? to_f(kb[(size_t)key * kv_row + d]) : 0.f;
    }
    if (tid < BK) {
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
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // S reads of K done, P written

    for (int e = tid; e < BK * HD; e += THREADS) {
      const int c = e / HD, d = e % HD;
      const int key = k0 + c;
      KVs[c * KS + d] = key < L ? to_f(vb[(size_t)key * kv_row + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = KVs[c * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + (size_t)b * L * q_row + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store(ob + (size_t)row * q_row + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask,
                   void* out, int B, int L, int Hq, int Hkv, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_causal_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BQ - 1) / BQ, Hq, B);
  flash_causal_fwd_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(out), L, Hq, Hkv, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim must be 128 (checked by the
// wrapper; returns cudaErrorInvalidValue otherwise).
extern "C" int unirec_flash_causal_fwd(const void* q, const void* k, const void* v,
                                       const float* mask, void* out, int B, int L,
                                       int Hq, int Hkv, int head_dim, int dtype,
                                       void* stream) {
  if (head_dim != HD || Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, mask, out, B, L, Hq, Hkv, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(q, k, v, mask, out, B, L, Hq, Hkv, s);
  return (int)cudaErrorInvalidValue;
}
