#pragma once
#include "emu.h"
struct __nv_bfloat16 {
  uint16_t x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  __nv_bfloat16 r;
  if ((u & 0x7fffffffu) > 0x7f800000u) { r.x = 0x7fc0; return r; }
  u += 0x7fffu + ((u >> 16) & 1u);
  r.x = (uint16_t)(u >> 16);
  return r;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16; float f; memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return __nv_bfloat162{__float2bfloat16(a), __float2bfloat16(b)};
}
