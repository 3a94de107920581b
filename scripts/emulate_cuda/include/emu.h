// A CPU emulation of the CUDA subset that the port's attention kernels use,
// so that their index and fragment logic can be run with g++ on a machine
// without a card (build.py compiles a source against these headers).
//
// One OS thread per CUDA thread, one block (or one thread-block cluster: its
// blocks at once, with a barrier of all their threads and each other's
// shared memory) at a time; __syncthreads is a block barrier and every warp collective (shuffles, ballots, ldmatrix,
// mma.sync in ptx_helpers.cuh) exchanges the 32 lanes' operands through a
// per-warp buffer between two warp barriers.  Shared memory starts as 0xFF
// bytes (NaN in bf16 and fp32), so a read of a word nobody wrote shows, and a
// guard past its end catches writes out of bounds.  cp.async copies land as
// late as the PTX allows (at the wait that covers their group) unless
// emu_set_eager(1) makes them land at once; each source range is checked
// against the tensors registered with emu_register.  Times mean nothing here.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <atomic>
#include <optional>
#include <thread>
#include <vector>
#include <algorithm>
#include <type_traits>
#include <utility>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n)
#define __grid_constant__
#ifndef INFINITY
#define INFINITY (__builtin_inff())
#endif

struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum cudaError { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801,
                 cudaErrorSmem = 700, cudaErrorLaunch = 701 };
typedef cudaError cudaError_t;
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

namespace emu {
struct Block {
  std::barrier<>* bar;
  std::barrier<>* wbar[32];
  std::barrier<>* gbar[8];  // warpgroups of 128 threads (wgmma's collective)
  std::barrier<>* nbar[16] = {};  // named barriers, made by their first arrival
  std::mutex nmu;
  uint32_t xbuf[32][32][12];
  uint64_t abuf[32][32];
};
inline thread_local dim3 tIdx, bIdx;
inline thread_local unsigned char* smem_base = nullptr;
inline thread_local size_t smem_size = 0;
inline thread_local Block* blk = nullptr;
// a thread-block cluster: one barrier of all its threads, and each block's
// shared memory by rank in the cluster
struct Cluster {
  std::barrier<>* bar;
  std::vector<unsigned char*> smem;
};
inline thread_local Cluster* clu = nullptr;
inline thread_local std::optional<std::barrier<>::arrival_token> clu_token;
inline thread_local cudaError last_error = cudaSuccess;
inline std::atomic<int> fault{0};
inline char fault_msg[512];
inline void fail(const char* msg) {
  if (!fault.exchange(1)) snprintf(fault_msg, sizeof fault_msg, "%s (block %u,%u,%u thread %u)", msg,
                                   bIdx.x, bIdx.y, bIdx.z, tIdx.x);
}
struct Range { uintptr_t lo, hi; };
inline std::vector<Range> ranges;
inline bool in_global(const void* p, size_t n) {
  if (ranges.empty()) return true;
  uintptr_t a = (uintptr_t)p;
  for (auto& r : ranges) if (a >= r.lo && a + n <= r.hi) return true;
  return false;
}
inline int eager = 0;
struct Copy { uint32_t dst; const void* src; int bytes; bool pred; };
inline thread_local std::vector<Copy> cur;
inline thread_local std::vector<std::vector<Copy>> groups;
inline void do_copy(const Copy& c) {
  if (c.dst + c.bytes > smem_size) { fail("cp.async dst out of smem"); return; }
  if (c.pred) {
    if (!in_global(c.src, c.bytes)) { fail("cp.async src out of global tensors"); return; }
    memcpy(smem_base + c.dst, c.src, c.bytes);
  } else memset(smem_base + c.dst, 0, c.bytes);
}
inline int lane() { return tIdx.x & 31; }
inline int warp() { return tIdx.x >> 5; }
inline void wsync() { blk->wbar[warp()]->arrive_and_wait(); }
}  // namespace emu

#define threadIdx (emu::tIdx)
#define blockIdx (emu::bIdx)
// variables, not macros: cudaLaunchConfig_t has members of these names
inline dim3 blockDim, gridDim;

inline void __syncthreads() { emu::blk->bar->arrive_and_wait(); }

template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) <= 4);
  uint32_t u = 0; memcpy(&u, &v, sizeof(T));
  auto& xb = emu::blk->xbuf[emu::warp()];
  xb[emu::lane()][0] = u;
  emu::wsync();
  uint32_t r = xb[emu::lane() ^ off][0];
  emu::wsync();
  T out; memcpy(&out, &r, sizeof(T));
  return out;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  auto& xb = emu::blk->xbuf[emu::warp()];
  xb[emu::lane()][0] = pred ? 1u : 0u;
  emu::wsync();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (xb[i][0] ? 1u : 0u) << i;
  emu::wsync();
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncwarp() { emu::wsync(); }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline int atomicMax(int* p, int v) {  // the blocks of a cluster run at once
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {}
  return old;
}
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __expf(float x) { return expf(x); }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __int2float_rn(int i) { return (float)i; }
inline int __float2int_rn(float x) { return (int)std::nearbyint(x); }
inline float __fdividef(float a, float b) { return a / b; }
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const unsigned char*)p - emu::smem_base);
}
using std::min;
using std::max;

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int v) {
  return v > 232448 ? cudaErrorSmem : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { auto e = emu::last_error; emu::last_error = cudaSuccess; return e; }

namespace emu {
// blocks in clusters of cx along x (cx = 1: one block at a time)
template <class K, class... A>
void launch_cluster(unsigned cx, dim3 grid, dim3 block, size_t smem, K kernel, A... args) {
  const unsigned nt = block.x * block.y * block.z;
  if (nt > 1024 || nt % 32 || smem > 232448 || grid.y > 65535 || grid.z > 65535 || cx == 0 ||
      grid.x % cx) {
    last_error = cudaErrorLaunch; return;
  }
  blockDim = block; gridDim = grid;
  const int nw = nt / 32;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx0 = 0; bx0 < grid.x; bx0 += cx) {
        // garbage (NaN) + guard, a block each
        std::vector<std::vector<unsigned char>> mem(cx, std::vector<unsigned char>(smem + 64, 0xFF));
        Cluster c;
        c.bar = new std::barrier<>(nt * cx);
        std::vector<Block*> blocks(cx);
        for (unsigned r = 0; r < cx; ++r) {
          Block* b = blocks[r] = new Block();
          b->bar = new std::barrier<>(nt);
          for (int w = 0; w < nw; ++w) b->wbar[w] = new std::barrier<>(32);
          for (int w = 0; w < (nw + 3) / 4; ++w)
            b->gbar[w] = new std::barrier<>(std::min(128, (int)nt - 128 * w));
          c.smem.push_back(mem[r].data());
        }
        std::vector<std::thread> th;
        for (unsigned r = 0; r < cx; ++r)
          for (unsigned t = 0; t < nt; ++t)
            th.emplace_back([&, r, t]() {
              Block* b = blocks[r];
              tIdx = dim3(t); bIdx = dim3(bx0 + r, by, bz);
              smem_base = mem[r].data(); smem_size = smem; blk = b; clu = &c;
              clu_token.reset();
              cur.clear(); groups.clear();
              kernel(args...);
              b->wbar[t >> 5]->arrive_and_drop();
              b->gbar[t >> 7]->arrive_and_drop();
              b->bar->arrive_and_drop();
              c.bar->arrive_and_drop();
            });
        for (auto& x : th) x.join();
        for (unsigned r = 0; r < cx; ++r)
          for (int i = 0; i < 64; ++i)
            if (mem[r][smem + i] != 0xFF) { fail("shared memory written past its end"); break; }
        for (Block* b : blocks) {
          for (int w = 0; w < nw; ++w) delete b->wbar[w];
          for (int w = 0; w < (nw + 3) / 4; ++w) delete b->gbar[w];
          for (auto* nb : b->nbar) delete nb;
          delete b->bar; delete b;
        }
        delete c.bar;
        if (fault) return;
      }
}
template <class K, class... A>
void launch(dim3 grid, dim3 block, size_t smem, K kernel, A... args) {
  launch_cluster(1, grid, block, smem, kernel, args...);
}
}  // namespace emu

template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= 4);
  uint32_t u = 0; memcpy(&u, &v, sizeof(T));
  auto& xb = emu::blk->xbuf[emu::warp()];
  xb[emu::lane()][0] = u;
  emu::wsync();
  uint32_t r = xb[src & 31][0];
  emu::wsync();
  T out; memcpy(&out, &r, sizeof(T));
  return out;
}
// byte n of the result is byte (s >> 4n) & 7 of the eight bytes {y:x}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFFu) << (8 * n);
  return r;
}
