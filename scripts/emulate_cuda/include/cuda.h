// The CUDA types the kernels name (tensor maps for TMA), for the CPU
// emulation.  An emulated CUtensorMap holds the fields emu_encode_tiled
// stores: base, columns, rows, row stride in bytes, box columns, box rows,
// swizzle, bytes an element.
#pragma once
#include <cstdint>
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0 };
typedef enum {
  CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0,
  CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7,
  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9
} CUtensorMapDataType;
typedef enum { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 } CUtensorMapInterleave;
typedef enum { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_128B = 3 } CUtensorMapSwizzle;
typedef enum { CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 } CUtensorMapL2promotion;
typedef enum { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 } CUtensorMapFloatOOBfill;
struct alignas(64) CUtensorMap { uint64_t opaque[16]; };

inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                 void* base,
                                 const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill) {
  const uint64_t es = type == CU_TENSOR_MAP_DATA_TYPE_UINT8     ? 1
                      : type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4
                                                                : 2;
  if (rank != 2 || (uintptr_t)base % 16 || strides[0] % 16 || box[0] * es > 128) return 1;
  map->opaque[0] = (uint64_t)(uintptr_t)base;
  map->opaque[1] = dims[0];
  map->opaque[2] = dims[1];
  map->opaque[3] = strides[0];
  map->opaque[4] = box[0];
  map->opaque[5] = box[1];
  map->opaque[6] = (uint64_t)swizzle;
  map->opaque[7] = es;
  return CUDA_SUCCESS;
}
