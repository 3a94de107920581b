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
//
// Two kernels, deterministic and without atomics, as the JAX design: a TPU
// grid runs in order and carries a sum in scratch, a Hopper grid does not, so
// each output is owned by one block that loops over what it sums.
//   dq kernel:  one block per (batch, 64-row q tile, q head); loops over kv
//               tiles up to the diagonal; dq accumulates in registers.
//   dkv kernel: one block per (batch, 64-key kv tile, kv head); loops over its
//               group's q heads and over q tiles from the diagonal on; dk and
//               dv accumulate in registers.
// No cross-block reduction, so the bits are the same from run to run.
//
// What bounds it: at the joint training shape (B=8, L=512, Hq=16, Hkv=8,
// HD=128) the causal half of each of the seven score-sized products is about
// 4.3 GFLOP, 30 GFLOP per layer (3 in the dq kernel, 4 in the dkv kernel)
// against ~40 MB of q/k/v/dO/dq/dk/dv traffic: it is bound by arithmetic
// (about 30 us at the card's bf16 tensor-core peak).  This first design does
// that arithmetic as K1 does, with scalar fp32 FMAs from shared memory (one
// code path for bf16 and fp32 inputs, fp32 accumulators): 16 x 16 threads,
// each owning a 4 x 4 block of a 64 x 64 score tile and a 4 x 8 block of a
// 64 x 128 output.  Tensor cores (mma.sync / wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;           // head_dim this build supports
constexpr int BT = 64;            // rows of a q tile and of a kv tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int RS = HD + 1;        // padded row stride of a [64][128] tile
constexpr int PS = BT + 1;        // padded row stride of a [64][64] tile
// dq kernel: Q, dO, K, V tiles, the ds tile, m / l / dsum / key validity
constexpr int DQ_SMEM_FLOATS = 4 * BT * RS + BT * PS + 4 * BT;
// dkv kernel: K, V, Q, dO tiles, the p^T and ds^T tiles, m / l / dsum / rows
constexpr int DKV_SMEM_FLOATS = 4 * BT * RS + 2 * BT * PS + 4 * BT;
constexpr size_t DQ_SMEM_BYTES = DQ_SMEM_FLOATS * sizeof(float);
constexpr size_t DKV_SMEM_BYTES = DKV_SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// rows [r0, r0 + 64) of one head's columns of a merged-head tensor -> smem
// [64][RS] floats; rows past L read as zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t row_stride,
                                          int r0, int L, int tid) {
  for (int e = tid; e < BT * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int row = r0 + r;
    dst[r * RS + d] = row < L ? to_f(src[(size_t)row * row_stride + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_causal_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ mask,
                           const T* __restrict__ dout, const float* __restrict__ m_in,
                           const float* __restrict__ l_in,
                           const float* __restrict__ dsum_in, T* __restrict__ dq,
                           int L, int Hq, int Hkv, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [BT][RS]
  float* dOs = Qs + BT * RS;       // [BT][RS]
  float* Ks = dOs + BT * RS;       // [BT][RS]
  float* Vs = Ks + BT * RS;        // [BT][RS]
  float* dSs = Vs + BT * RS;       // [BT][PS]  ds of this tile
  float* ms = dSs + BT * PS;       // [BT]
  float* ls = ms + BT;             // [BT]  l with 0 guarded to 1
  float* dsums = ls + BT;          // [BT]
  float* kval = dsums + BT;        // [BT]  key validity of this kv tile

  // longest rows first: the last q tiles loop over the most kv tiles
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * BT;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // rows ty*4 .. ty*4+3
  const int tx = tid & 15;          // score cols tx + 16j, output cols tx + 16j
  const size_t q_row = (size_t)Hq * HD;
  const size_t kv_row = (size_t)Hkv * HD;
  const T* qb = q + (size_t)b * L * q_row + (size_t)h * HD;
  const T* dob = dout + (size_t)b * L * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const float* mb = mask + (size_t)b * L;

  load_tile(Qs, qb, q_row, q0, L, tid);
  load_tile(dOs, dob, q_row, q0, L, tid);
  if (tid < BT) {
    const int row = q0 + tid;
    const size_t r = ((size_t)b * L + row) * Hq + h;
    const float lv = row < L ? l_in[r] : 1.f;
    ms[tid] = row < L ? m_in[r] : 0.f;
    ls[tid] = lv == 0.f ? 1.f : lv;
    dsums[tid] = row < L ? dsum_in[r] : 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int last_row = min(q0 + BT, L) - 1;
  const int n_kv = last_row / BT + 1;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K reads are done
    load_tile(Ks, kb, kv_row, k0, L, tid);
    load_tile(Vs, vb, kv_row, k0, L, tid);
    if (tid < BT) {
      const int key = k0 + tid;
      kval[tid] = (key < L && mb[key] != 0.f) ? 1.f : 0.f;
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
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = row < L && k0 + c <= row && kval[c] != 0.f;
        const float p = ok ? expf(s[i][j] * scale - ms[r]) / ls[r] : 0.f;
        dSs[r * PS + c] = p * (dp[i][j] - dsums[r]) * scale;
      }
    }
    __syncthreads();  // ds written

    // dq += ds k
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float dv_[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_[i] = dSs[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = Ks[c * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dv_[i], kk[j], acc[i][j]);
    }
  }

  T* dqb = dq + (size_t)b * L * q_row + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) store(dqb + (size_t)row * q_row + tx + 16 * j, acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_causal_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ mask,
                            const T* __restrict__ dout, const float* __restrict__ m_in,
                            const float* __restrict__ l_in,
                            const float* __restrict__ dsum_in, T* __restrict__ dk,
                            T* __restrict__ dv, int L, int Hq, int Hkv, float scale) {
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
  float* kval = dsums + BT;        // [BT]

  // the first kv tiles are seen by the most q tiles: start them first
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kt * BT;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // keys ty*4 .. ty*4+3
  const int tx = tid & 15;          // score rows tx + 16j, output cols tx + 16j
  const size_t q_row = (size_t)Hq * HD;
  const size_t kv_row = (size_t)Hkv * HD;
  const T* kb = k + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * L * kv_row + (size_t)kvh * HD;
  const float* mb = mask + (size_t)b * L;

  load_tile(Ks, kb, kv_row, k0, L, tid);
  load_tile(Vs, vb, kv_row, k0, L, tid);
  if (tid < BT) {
    const int key = k0 + tid;
    kval[tid] = (key < L && mb[key] != 0.f) ? 1.f : 0.f;
  }

  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_q = (L + BT - 1) / BT;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qb = q + (size_t)b * L * q_row + (size_t)h * HD;
    const T* dob = dout + (size_t)b * L * q_row + (size_t)h * HD;
    for (int qt = kt; qt < n_q; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the previous tile's Q / dO / p^T / ds^T reads are done
      load_tile(Qs, qb, q_row, q0, L, tid);
      load_tile(dOs, dob, q_row, q0, L, tid);
      if (tid < BT) {
        const int row = q0 + tid;
        const size_t r = ((size_t)b * L + row) * Hq + h;
        const float lv = row < L ? l_in[r] : 1.f;
        ms[tid] = row < L ? m_in[r] : 0.f;
        ls[tid] = lv == 0.f ? 1.f : lv;
        dsums[tid] = row < L ? dsum_in[r] : 0.f;
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
        const int key = k0 + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int row = q0 + r;
          const bool ok = row < L && key <= row && kval[c] != 0.f;
          const float p = ok ? expf(s[i][j] * scale - ms[r]) / ls[r] : 0.f;
          Pt[c * PS + r] = p;
          dSt[c * PS + r] = p * (dp[i][j] - dsums[r]) * scale;
        }
      }
      __syncthreads();  // p^T and ds^T written

      // dv += p^T dO, dk += ds^T q
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
        float pv[4], sv[4], ov[8], qv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(ty * 4 + i) * PS + r];
          sv[i] = dSt[(ty * 4 + i) * PS + r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ov[j] = dOs[r * RS + tx + 16 * j];
          qv[j] = Qs[r * RS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

  T* dkb = dk + (size_t)b * L * kv_row + (size_t)kvh * HD;
  T* dvb = dv + (size_t)b * L * kv_row + (size_t)kvh * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      store(dkb + (size_t)key * kv_row + tx + 16 * j, acc_k[i][j]);
      store(dvb + (size_t)key * kv_row + tx + 16 * j, acc_v[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const float* mask,
                      const void* dout, const float* m, const float* l,
                      const float* dsum, void* dq, int B, int L, int Hq, int Hkv,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_causal_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DQ_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BT - 1) / BT, Hq, B);
  flash_causal_bwd_dq_kernel<T><<<grid, THREADS, DQ_SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<const T*>(dout), m, l, dsum, static_cast<T*>(dq), L, Hq, Hkv,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const float* mask,
                       const void* dout, const float* m, const float* l,
                       const float* dsum, void* dk, void* dv, int B, int L, int Hq,
                       int Hkv, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_causal_bwd_dkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DKV_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BT - 1) / BT, Hkv, B);
  flash_causal_bwd_dkv_kernel<T><<<grid, THREADS, DKV_SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<const T*>(dout), m, l, dsum, static_cast<T*>(dk),
      static_cast<T*>(dv), L, Hq, Hkv, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

bool bad_shape(int head_dim, int B, int L, int Hq, int Hkv) {
  return head_dim != HD || Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || L <= 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim must be 128.
extern "C" int unirec_flash_causal_bwd_dq(const void* q, const void* k, const void* v,
                                          const float* mask, const void* dout,
                                          const float* m, const float* l,
                                          const float* dsum, void* dq, int B, int L,
                                          int Hq, int Hkv, int head_dim, int dtype,
                                          void* stream) {
  if (bad_shape(head_dim, B, L, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dq<float>(q, k, v, mask, dout, m, l, dsum, dq, B, L, Hq, Hkv, s);
  if (dtype == 1)
    return (int)launch_dq<__nv_bfloat16>(q, k, v, mask, dout, m, l, dsum, dq, B, L,
                                         Hq, Hkv, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int unirec_flash_causal_bwd_dkv(const void* q, const void* k, const void* v,
                                           const float* mask, const void* dout,
                                           const float* m, const float* l,
                                           const float* dsum, void* dk, void* dv,
                                           int B, int L, int Hq, int Hkv, int head_dim,
                                           int dtype, void* stream) {
  if (bad_shape(head_dim, B, L, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, mask, dout, m, l, dsum, dk, dv, B, L, Hq,
                                  Hkv, s);
  if (dtype == 1)
    return (int)launch_dkv<__nv_bfloat16>(q, k, v, mask, dout, m, l, dsum, dk, dv, B,
                                          L, Hq, Hkv, s);
  return (int)cudaErrorInvalidValue;
}
