"""Exact per-item attention for small K (port of
``unirec_tpu/ops/packed_attention.py``): kernel B15.

``packed_item_attention(q, k, v, bias)`` takes q ``[B, H, K, hd]``, k / v
``[B, H, F, hd]`` and an additive per-key bias ``[B, 1, 1, F]`` (or None):
every item's K query rows attend over that item's F keys, in fp32 whatever
the input dtype, and the output comes back in q's dtype.  The JAX kernel
packs 128 / K items into one 128-row MXU tile under a block-diagonal -2e9
mask, so K must divide 128; the CUDA kernels (``csrc/packed_attention.cu``)
keep that contract but compute each item's softmax over its own keys
alone, which gives the same function (its header says why, down to the item
with no valid key, which attends uniformly over its own keys).  Like the
JAX function it is not wired into the model's dispatch: the Item
Q-Former's attention runs inside B1/B2 and B12.

CPU tensors take ``packed_item_attention_plain``; on the card the wrapper
launches the kernel or raises (float32 or bfloat16 of one dtype on one
device, the head dimension contiguous; any head dim, K dividing 128 and any
F), and counts its launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.attention import dtype_code, key_bias, sm_scale

# query rows of the TPU kernel's tile: K must divide it
PACKED_ROWS = 128


def packed_item_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                bias: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """B15's plain version: per-item softmax attention in fp32.  s = (q .
    k) * scale + bias, e = exp(s - max s), o = (e v) / (l == 0 ? 1 : l) with
    l = sum e, cast to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * sm_scale(q.shape[-1])
    if bias is not None:
        s = s + bias.float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e, v.float()) / torch.where(l == 0, 1.0, l)
    return o.to(q.dtype)


def _check_tensors(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernels take: one CUDA device, float32 or bfloat16 of one
    dtype, the head dimension contiguous (any other strides)."""
    if q.device.type != "cuda":
        raise ValueError(f"B15: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"B15 takes float32 or bfloat16, got {q.dtype}")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"B15: all tensors must share {q.dtype} on "
                            f"{q.device}")
        if t.stride(-1) != 1:
            raise ValueError("B15: the head dimension must be contiguous")


def packed_item_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Exact per-item attention (B15).  q ``[B, H, K, hd]``, k / v ``[B, H,
    F, hd]`` (any strides with a contiguous head dimension), bias ``[B, 1,
    1, F]`` or None; K must divide 128, as the JAX kernel asks.  Returns
    ``[B, H, K, hd]`` in q's dtype.  CPU tensors take the plain version."""
    b, h, n_q, hd = q.shape
    if PACKED_ROWS % n_q:
        raise ValueError(f"query count {n_q} must divide {PACKED_ROWS}")
    n_kv = k.shape[2]
    if k.shape != (b, h, n_kv, hd) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return packed_item_attention_plain(q, k, v, bias)
    _check_tensors(q, k, v)
    if k.stride() != v.stride():  # the bf16 kernel reads v at k's strides
        k, v = k.contiguous(), v.contiguous()
    bias32 = key_bias(bias, b, n_kv, q.device)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = load_kernels().lib.unirec_packed_item_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias32 is None else bias32.data_ptr(), out.data_ptr(),
        *strides, b, h, n_q, n_kv, hd, dtype_code(q), sm_scale(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "packed_item_attention")
    packed_item_attention.launches += 1
    return out


packed_item_attention.launches = 0
