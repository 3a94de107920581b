// The PTX helpers of csrc/ptx_helpers.cuh for the CPU emulation (emu.h):
// the same functions, computed from the fragment layouts that header
// documents.  mma.sync and wgmma sum each product in fp32 (int32 for int8
// codes) in k order.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <atomic>
#include <chrono>
#include <thread>
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
// m16n8k32 s8: a[0] (g, 4t..4t+3) a[1] (g + 8, ..) a[2] (g, 4t+16..) a[3]
// (g + 8, 4t+16..); b0 (k 4t..4t+3, n g) b1 (k 4t+16.., n g); int32 sums
inline int emu_s8(uint32_t w, int i) { return (int)(int8_t)((w >> (8 * i)) & 0xffu); }
inline void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& xb = emu::blk->xbuf[emu::warp()];
  const int ln = emu::lane();
  for (int i = 0; i < 4; ++i) xb[ln][i] = a[i];
  xb[ln][4] = b0; xb[ln][5] = b1;
  for (int i = 0; i < 4; ++i) memcpy(&xb[ln][6 + i], &c[i], 4);
  emu::wsync();
  int A[16][32], B[32][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int i = 0; i < 4; ++i) {
      A[g][4 * t + i] = emu_s8(xb[l][0], i);
      A[g + 8][4 * t + i] = emu_s8(xb[l][1], i);
      A[g][4 * t + 16 + i] = emu_s8(xb[l][2], i);
      A[g + 8][4 * t + 16 + i] = emu_s8(xb[l][3], i);
      B[4 * t + i][g] = emu_s8(xb[l][4], i);
      B[4 * t + 16 + i][g] = emu_s8(xb[l][5], i);
    }
  }
  const int g = ln >> 2, t = ln & 3;
  int out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    int acc; memcpy(&acc, &xb[ln][6 + e], 4);
    for (int k = 0; k < 32; ++k) acc += A[row][k] * B[k][col];
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

// wgmma: each thread computes its own accumulator elements straight from
// the shared-memory tiles the descriptors name (K-major, 128-byte swizzle:
// address bits 4-6 XOR bits 7-9), summing each product in k order.  The
// fence and the wait are barriers of the warpgroup, as the collective
// products keep its warps together (one thread may release a stage once its
// wait returns); commit is a no-op: a product is complete on return.
inline uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
inline void wgmma_fence() { emu::blk->gbar[emu::tIdx.x >> 7]->arrive_and_wait(); }
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() { emu::blk->gbar[emu::tIdx.x >> 7]->arrive_and_wait(); }
inline void fence_proxy_async() {}
// bar.sync id, n: a barrier of the n threads that name it
inline void named_barrier(int id, int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(emu::blk->nmu);
    if (!emu::blk->nbar[id]) emu::blk->nbar[id] = new std::barrier<>(n);
    b = emu::blk->nbar[id];
  }
  b->arrive_and_wait();
}
// the shared address of byte b of row `row` of a descriptor's tile
inline uint32_t emu_desc_addr(uint64_t desc, int row, int b) {
  if ((desc >> 62) != 1) { emu::fail("wgmma descriptor: not 128-byte swizzle"); return 0; }
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  const uint32_t logical = start + (row / 8) * sbo + (row % 8) * 128 + b;
  return logical ^ (((logical >> 7) & 7) << 4);
}
inline float emu_desc_elem(uint64_t desc, int row, int k) {
  return bfl(emu_ld16(emu_desc_addr(desc, row, 2 * k)), 0);
}
inline int emu_desc_s8(uint64_t desc, int row, int k) {
  const uint32_t a = emu_desc_addr(desc, row, k);
  if (a + 1 > emu::smem_size) { emu::fail("wgmma read out of smem"); return 0; }
  return (int)(int8_t)emu::smem_base[a];
}
template <int N>
inline void emu_wgmma(float* d, uint64_t da, uint64_t db) {
  const int t = emu::tIdx.x % 128, w = t / 32, ln = t % 32, g = ln >> 2, q = ln & 3;
  for (int n = 0; n < N / 8; ++n)
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * w + g + 8 * (e >> 1), col = 8 * n + 2 * q + (e & 1);
      float acc = d[4 * n + e];
      for (int k = 0; k < 16; ++k) acc += emu_desc_elem(da, row, k) * emu_desc_elem(db, col, k);
      d[4 * n + e] = acc;
    }
}
inline void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  emu_wgmma<128>(d, da, db);
}
inline void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  emu_wgmma<256>(d, da, db);
}
// the int8 forms: 32 codes a k-step, int32 sums, the same accumulator layout
template <int N>
inline void emu_wgmma_s8(int* d, uint64_t da, uint64_t db) {
  const int t = emu::tIdx.x % 128, w = t / 32, ln = t % 32, g = ln >> 2, q = ln & 3;
  for (int n = 0; n < N / 8; ++n)
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * w + g + 8 * (e >> 1), col = 8 * n + 2 * q + (e & 1);
      int acc = d[4 * n + e];
      for (int k = 0; k < 32; ++k) acc += emu_desc_s8(da, row, k) * emu_desc_s8(db, col, k);
      d[4 * n + e] = acc;
    }
}
inline void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  emu_wgmma_s8<128>(d, da, db);
}
inline void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da, uint64_t db) {
  emu_wgmma_s8<256>(d, da, db);
}

// mbarriers: an 8-byte shared word updated atomically, bits 0-14 pending
// arrivals, 15-29 the arrival count, 30 the phase, 32-63 pending
// transaction bytes (signed); a phase completes when arrivals and bytes
// reach zero.  TMA copies its box at once (128-byte swizzle by address
// bits, zeros past the tensor) and completes the bytes on the barrier.
inline std::atomic_ref<uint64_t> emu_bar(uint64_t* bar) {
  const uint32_t off = smem_addr(bar);
  if (off % 8) emu::fail("mbarrier misaligned");
  return std::atomic_ref<uint64_t>(*bar);
}
inline void emu_bar_update(uint64_t* bar, int arrivals, long long bytes) {
  auto a = emu_bar(bar);
  uint64_t v = a.load();
  for (;;) {
    int pending = (int)(v & 0x7FFF) - arrivals;
    const int count = (int)((v >> 15) & 0x7FFF);
    uint64_t phase = (v >> 30) & 1;
    long long tx = (long long)(int32_t)(uint32_t)(v >> 32) + bytes;
    if (pending < 0) { emu::fail("mbarrier: too many arrivals"); return; }
    if (pending == 0 && tx == 0) { pending = count; phase ^= 1; }
    const uint64_t nv = (uint64_t)pending | ((uint64_t)count << 15) | (phase << 30) |
                        ((uint64_t)(uint32_t)(int32_t)tx << 32);
    if (a.compare_exchange_weak(v, nv)) return;
  }
}
inline void mbar_init(uint64_t* bar, int count) {
  emu_bar(bar).store((uint64_t)count | ((uint64_t)count << 15));
}
inline void mbar_fence_init() {}
inline void mbar_arrive_expect(uint64_t* bar, int bytes) {
  // the bytes first, then the arrival: the phase cannot complete between
  emu_bar_update(bar, 0, bytes);
  emu_bar_update(bar, 1, 0);
}
inline void mbar_arrive(uint64_t* bar) { emu_bar_update(bar, 1, 0); }
inline void mbar_wait(uint64_t* bar, int parity) {
  for (long long spins = 0; ((emu_bar(bar).load() >> 30) & 1) == (uint64_t)parity; ++spins) {
    if (emu::fault) return;
    if (spins > 200000) {
      char msg[160];
      const uint64_t v = emu_bar(bar).load();
      snprintf(msg, sizeof msg, "mbarrier wait: no progress (barrier at %u, parity %d, word %llx)",
               smem_addr(bar), parity, (unsigned long long)v);
      emu::fail(msg);
      return;
    }
    std::this_thread::sleep_for(std::chrono::microseconds(20));
  }
}
inline void tma_load_2d(void* dst, const void* map, int x, int y, uint64_t* bar) {
  const uint64_t* m = static_cast<const CUtensorMap*>(map)->opaque;
  const auto* base = reinterpret_cast<const unsigned char*>((uintptr_t)m[0]);
  const long long cols = (long long)m[1], rows = (long long)m[2], stride = (long long)m[3];
  const int bc = (int)m[4], br = (int)m[5], es = (int)m[7];  // es: bytes an element
  if (m[6] != 3 || bc * es != 128) {
    emu::fail("TMA: only 128-byte swizzled boxes of one 128-byte row");
    return;
  }
  const uint32_t d0 = smem_addr(dst);
  if (d0 % 1024) { emu::fail("TMA: destination not 1024-byte aligned"); return; }
  for (int r = 0; r < br; ++r) {
    const long long gr = y + r;
    for (int c = 0; c < bc; c += 16 / es) {  // 16-byte chunks, zero past the edges
      unsigned char chunk[16] = {0};
      if (gr < rows && x + c < cols) {
        const long long n = std::min<long long>(16 / es, cols - (x + c)) * es;
        const unsigned char* src = base + gr * stride + (x + c) * es;
        if (!emu::in_global(src, n)) { emu::fail("TMA source out of global tensors"); return; }
        memcpy(chunk, src, n);
      }
      const uint32_t logical = d0 + r * 128 + c * es;
      const uint32_t phys = logical ^ (((logical >> 7) & 7) << 4);
      if (phys + 16 > emu::smem_size) { emu::fail("TMA destination out of smem"); return; }
      memcpy(emu::smem_base + phys, chunk, 16);
    }
  }
  emu_bar_update(bar, 0, -(long long)br * bc * es);
}
}  // namespace
