// PTX helpers shared by the port's tensor-core kernels: shared-memory
// addresses, 16- and 4-byte cp.async copies, ldmatrix (plain and transposed)
// and the bf16 mma.sync.m16n8k16 with fp32 accumulation, with the bf16
// packing of its A fragments (one rounding, or a hi + lo pair).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major) a[0]: (g, 2t..2t+1)   a[1]: (g + 8, 2t..2t+1)
//                          a[2]: (g, 2t+8..)     a[3]: (g + 8, 2t+8..)
//   B (16 x 8, k x n)      b0: (k 2t..2t+1, n g) b1: (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32)       c[0..1]: (g, 2t..2t+1) c[2..3]: (g + 8, 2t..2t+1)
// so the C fragments of two neighbouring n-tiles, packed to bf16 pairs, are
// the A fragment of one k-step of the next product (pack_bf16).
//
// Everything is in an unnamed namespace: each source that includes this
// header gets its own copy, and nothing is exported.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; pred false zero-fills the destination
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool pred) {
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

// 4-byte async copy (through L1); pred false zero-fills the destination
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool pred) {
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the four 8 x 8 matrices transposed: register j holds (row 2t, col g) and
// (row 2t + 1, col g) of matrix j
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 as the bf16 pairs hi = bf16(x) and lo = bf16(x - hi): hi + lo holds
// x to about 16 bits (two products where one bf16 rounding is too coarse)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16(x0 - __bfloat162float(h.x), x1 - __bfloat162float(h.y));
}

}  // namespace
