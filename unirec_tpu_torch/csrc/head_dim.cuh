// The head dimensions the attention kernels of flash_cross.cu (B13, B14,
// B14p), flash_causal_fwd.cu / flash_causal_bwd.cu (K1, B7b) and
// packed_attention.cu (B15) are built for: every multiple of 16 up to 128,
// and 256 for all but B15 (ops/attention.py:KERNEL_HEAD_DIMS).  Any other
// head dimension up to the largest instance is zero-padded to the next one
// by the Python wrappers (ops/attention.pad_head_dim), which pass the softmax
// scale of the true head dimension.  Each kernel takes the head dimension as
// a template parameter; with_head_dim maps the runtime value to one instance.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// fn(std::integral_constant<int, HD>) for a head dimension this build has up
// to MAX_HD; cudaErrorInvalidValue for any other
template <int MAX_HD = 256, typename Fn>
cudaError_t with_head_dim(int head_dim, Fn&& fn) {
  switch (head_dim) {
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 48: return fn(std::integral_constant<int, 48>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 80: return fn(std::integral_constant<int, 80>{});
    case 96: return fn(std::integral_constant<int, 96>{});
    case 112: return fn(std::integral_constant<int, 112>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 256:
      if constexpr (MAX_HD >= 256) return fn(std::integral_constant<int, 256>{});
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}
