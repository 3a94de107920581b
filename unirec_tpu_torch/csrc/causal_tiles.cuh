// The live key tiles of a causal attention row (flash_causal_fwd.cu,
// flash_causal_bwd.cu): a tile whose keys are all padding changes nothing
// (its probabilities are exactly 0), so the kernels skip it before loading it.

#pragma once

#include <cuda_runtime.h>

namespace {

// Key tiles of 64 among the first n_kv of batch row mb: kbits[t] gets tile
// t's key-validity bits (bit c: key 64 t + c < L and mask != 0), tiles[] the
// indices of the tiles with a valid key in order, tiles[n_kv_max] their
// count.  Every thread of the block calls it; it ends with a barrier.
__device__ __forceinline__ void live_tiles(const float* __restrict__ mb, int L, int n_kv,
                                           int n_kv_max, unsigned long long* kbits,
                                           int* tiles) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < n_kv; t += nwarps) {
    const int ka = t * 64 + lane, kb = ka + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, ka < L && mb[ka] != 0.f);
    const unsigned hi = __ballot_sync(0xffffffffu, kb < L && mb[kb] != 0.f);
    if (lane == 0) kbits[t] = ((unsigned long long)hi << 32) | lo;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < n_kv; base += 32) {
      const int t = base + lane;
      const bool live = t < n_kv && kbits[t] != 0ull;
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (live) tiles[count + __popc(bal & ((1u << lane) - 1u))] = t;
      count += __popc(bal);
    }
    if (lane == 0) tiles[n_kv_max] = count;
  }
  __syncthreads();
}

// shared-memory bytes of the tile list for rows of length L
__host__ __device__ inline size_t live_tiles_bytes(int L) {
  const int n = (L + 63) / 64;
  return (size_t)n * sizeof(unsigned long long) + (size_t)(n + 1) * sizeof(int);
}

}  // namespace
