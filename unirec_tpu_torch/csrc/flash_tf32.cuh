// The entries of flash_tf32.cu, the float32 flash kernels at head dims up to
// 256 on tensor cores in 3xTF32 (that file's notes give the design): B13,
// B14 and B14p's forward (cross_fwd) and one-pass backward (cross_bwd), for
// flash_cross.cu's C entries; B7b's dq (causal_dq) and dk / dv (causal_dkv),
// for flash_causal_bwd.cu's.  Their own translation unit, so that the build
// compiles them beside those two sources.  head_dim: an instance of
// head_dim.cuh (cudaErrorInvalidValue otherwise); scale: the softmax scale of
// the true head dim.  Each launches on the caller's stream, allocates
// nothing and returns the first CUDA error.
#pragma once

#include <cuda_runtime.h>

#include "flash_chunked.cuh"

namespace tf32 {

// B13 (m = l = null) and the forward of B14 and B14p (m, l [B, Lq, H]); o
// float32, by (batch, head, row) strides as q, k and v; bias [B, Lkv] or null
cudaError_t cross_fwd(const void* q, const void* k, const void* v, const float* bias, void* o,
                      float* m, float* l, chunked::Strides qs, chunked::Strides ks,
                      chunked::Strides vs, chunked::Strides os, int B, int H, int Lq, int Lkv,
                      int head_dim, float scale, cudaStream_t stream);

// the backward of B14 and B14p in one pass; with Lq > 64 part is float32
// scratch of 2 * ceil(Lq / 64) * B * H * Lkv * head_dim elements (the q
// tiles' partial dk / dv, summed in q-tile order), null otherwise
cudaError_t cross_bwd(const void* q, const void* k, const void* v, const float* bias,
                      const void* dout, const float* m, const float* l, const float* dsum,
                      void* dq, void* dk, void* dv, float* part, const chunked::BwdStrides& st,
                      int B, int H, int Lq, int Lkv, int head_dim, float scale,
                      cudaStream_t stream);

// B7b's dq and dk / dv over merged-head layouts (st: chunked::merged's
// strides), the pad mask [B, L], Hq / Hkv query heads per key head
cudaError_t causal_dq(const void* q, const void* k, const void* v, const float* mask,
                      const void* dout, const float* m, const float* l, const float* dsum,
                      void* dq, const chunked::BwdStrides& st, int B, int L, int Hq, int Hkv,
                      int head_dim, float scale, cudaStream_t stream);
cudaError_t causal_dkv(const void* q, const void* k, const void* v, const float* mask,
                       const void* dout, const float* m, const float* l, const float* dsum,
                       void* dk, void* dv, const chunked::BwdStrides& st, int B, int L, int Hq,
                       int Hkv, int head_dim, float scale, cudaStream_t stream);

}  // namespace tf32
