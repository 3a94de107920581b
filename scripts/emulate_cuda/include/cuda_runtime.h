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
