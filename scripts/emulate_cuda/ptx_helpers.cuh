// The PTX helpers of csrc/ptx_helpers.cuh for the CPU emulation (emu.h):
// the same functions, computed from the fragment layouts that header
// documents.  mma.sync sums each product in fp32 in k order.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
inline uint32_t smem_addr(const void* p) {
  const size_t off = __cvta_generic_to_shared(p);
  if (off > emu::smem_size) emu::fail("smem_addr outside shared memory");
  return (uint32_t)off;
}
inline void cp_async_16(uint32_t dst, const void* src, bool pred) {
  if (dst % 16) emu::fail("cp.async.16 dst misaligned");
  if (pred && ((uintptr_t)src % 16)) emu::fail("cp.async.16 src misaligned");
  emu::Copy c{dst, src, 16, pred};
  if (emu::eager) emu::do_copy(c); else emu::cur.push_back(c);
}
inline void cp_async_4(uint32_t dst, const void* src, bool pred) {
  if (dst % 4) emu::fail("cp.async.4 dst misaligned");
  emu::Copy c{dst, src, 4, pred};
  if (emu::eager) emu::do_copy(c); else emu::cur.push_back(c);
}
inline void cp_async_commit() { emu::groups.push_back(emu::cur); emu::cur.clear(); }
template <int N>
inline void cp_async_wait() {
  while ((int)emu::groups.size() > N) {
    for (auto& c : emu::groups.front()) emu::do_copy(c);
    emu::groups.erase(emu::groups.begin());
  }
}
inline uint16_t emu_ld16(uint32_t off) {
  if (off + 2 > emu::smem_size) { emu::fail("ldmatrix out of smem"); return 0; }
  uint16_t v; memcpy(&v, emu::smem_base + off, 2); return v;
}
// lane i gives the row address of row i % 8 of matrix i / 8
inline void ldmatrix_impl(uint32_t (&r)[4], uint32_t addr, bool trans) {
  if (addr % 16) emu::fail("ldmatrix row misaligned");
  auto& xb = emu::blk->xbuf[emu::warp()];
  const int ln = emu::lane();
  xb[ln][0] = addr;
  emu::wsync();
  const int g = ln >> 2, t = ln & 3;
  for (int j = 0; j < 4; ++j) {
    uint16_t lo, hi;
    if (!trans) {
      const uint32_t row = xb[8 * j + g][0];
      lo = emu_ld16(row + 4 * t); hi = emu_ld16(row + 4 * t + 2);
    } else {
      lo = emu_ld16(xb[8 * j + 2 * t][0] + 2 * g);
      hi = emu_ld16(xb[8 * j + 2 * t + 1][0] + 2 * g);
    }
    r[j] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  emu::wsync();
}
inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) { ldmatrix_impl(r, addr, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) { ldmatrix_impl(r, addr, true); }
inline float bfl(uint32_t w, int hi) {
  uint32_t u = (hi ? (w >> 16) : (w & 0xffffu)) << 16; float f; memcpy(&f, &u, 4); return f;
}
inline void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& xb = emu::blk->xbuf[emu::warp()];
  const int ln = emu::lane();
  for (int i = 0; i < 4; ++i) xb[ln][i] = a[i];
  xb[ln][4] = b0; xb[ln][5] = b1;
  for (int i = 0; i < 4; ++i) memcpy(&xb[ln][6 + i], &c[i], 4);
  emu::wsync();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = bfl(xb[l][0], h);
      A[g + 8][2 * t + h] = bfl(xb[l][1], h);
      A[g][2 * t + 8 + h] = bfl(xb[l][2], h);
      A[g + 8][2 * t + 8 + h] = bfl(xb[l][3], h);
      B[2 * t + h][g] = bfl(xb[l][4], h);
      B[2 * t + 8 + h][g] = bfl(xb[l][5], h);
    }
  }
  const int g = ln >> 2, t = ln & 3;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc; memcpy(&acc, &xb[ln][6 + e], 4);
    for (int k = 0; k < 16; ++k) acc += A[row][k] * B[k][col];
    out[e] = acc;
  }
  emu::wsync();
  for (int e = 0; e < 4; ++e) c[e] = out[e];
}
inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r; memcpy(&r, &v, 4); return r;
}

// x0, x1 as the bf16 pairs hi = bf16(x) and lo = bf16(x - hi): hi + lo holds
// x to about 16 bits (two products where one bf16 rounding is too coarse)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16(x0 - __bfloat162float(h.x), x1 - __bfloat162float(h.y));
}
}  // namespace
