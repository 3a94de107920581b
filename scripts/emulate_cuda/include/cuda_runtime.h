#pragma once
#include "emu.h"
#include "cuda.h"

// the entry point the kernels fetch through the runtime (tensor maps)
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0,
                                       cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };
inline cudaError_t cudaGetDriverEntryPoint(const char* symbol, void** fn, unsigned long long,
                                           cudaDriverEntryPointQueryResult* q) {
  if (std::strcmp(symbol, "cuTensorMapEncodeTiled") != 0) {
    *q = cudaDriverEntryPointSymbolNotFound;
    return cudaSuccess;
  }
  *fn = reinterpret_cast<void*>(&emu_encode_tiled);
  *q = cudaDriverEntryPointSuccess;
  return cudaSuccess;
}

// cudaLaunchKernelEx with a cluster dimension along x (the one launch
// attribute the kernels set)
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class K, class... A>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, K kernel, A&&... args) {
  unsigned cx = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      const auto& d = cfg->attrs[i].val.clusterDim;
      if (d.y != 1 || d.z != 1 || d.x > 8) return cudaErrorLaunch;  // portable, along x
      cx = d.x;
    }
  emu::launch_cluster(cx, cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, kernel, args...);
  return emu::last_error;
}

// the clusters of cfg's shape that fit at once: an H100's 132 SMs, one block
// an SM, where a cluster is at most 8 blocks along x and a block's shared
// memory fits (the one question the kernels ask before a cluster launch)
template <class K>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t* cfg) {
  unsigned cx = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) cx = cfg->attrs[i].val.clusterDim.x;
  const unsigned nt = cfg->blockDim.x * cfg->blockDim.y * cfg->blockDim.z;
  *n = cx >= 1 && cx <= 8 && nt <= 1024 && cfg->dynamicSmemBytes <= 232448 ? 132 / cx : 0;
  return cudaSuccess;
}
