"""Exact per-item attention for small K (port of
``unirec_tpu/ops/packed_attention.py``): kernel B15.

``packed_item_attention(q, k, v, bias)`` takes q ``[B, H, K, hd]``, k / v
``[B, H, F, hd]`` and an additive per-key bias ``[B, 1, 1, F]`` (or None):
every item's K query rows attend over that item's F keys, in fp32 whatever
the input dtype, and the output comes back in q's dtype.  The JAX kernel
packs 128 / K items into one 128-row MXU tile under a block-diagonal -2e9
mask, so K must divide 128; the CUDA kernel (``csrc/packed_attention.cu``)
keeps that contract but computes each item's softmax over its own keys
alone, which gives the same function (its header says why, down to the item
with no valid key, which attends uniformly over its own keys).  Like the
JAX function it is not wired into the model's dispatch: the Item
Q-Former's attention runs inside B1/B2 and B12.

CPU tensors take ``packed_item_attention_plain``; on the card the wrapper
launches the kernel or raises (float32 or bfloat16 of one dtype, a head
dimension in ``ops/attention.KERNEL_HEAD_DIMS``, a block's items within
shared memory), and counts its launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.attention import (
    check_head_dim,
    check_kernel_tensors,
    dtype_code,
    key_bias,
    sm_scale,
)

# query rows of the TPU kernel's tile: K must divide it
PACKED_ROWS = 128
# shared memory one block may use on sm_90; the kernel's budget for a block
# of several items leaves room for two blocks an SM
BLOCK_SMEM_BYTES = 232448
ITEMS_SMEM_BYTES = BLOCK_SMEM_BYTES // 2
QUERY_CHUNK = 64  # query rows the kernel holds at once


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


def smem_bytes(head_dim: int, items: int, n_q: int, n_kv: int) -> int:
    """Shared memory of a kernel block of ``items`` items (the C
    ``smem_bytes``): k and v rows, a chunk of query rows, its scores, sums
    and the keys' bias, all float32, rows padded by one."""
    qc = min(QUERY_CHUNK, items * n_q)
    return 4 * (2 * items * n_kv * (head_dim + 1) + qc * (head_dim + 1)
                + qc * (n_kv + 1) + qc + items * n_kv)


def items_per_block(n_q: int, n_kv: int, head_dim: int, batch: int) -> int:
    """Items a kernel block holds: the TPU tile's 128 / K, fewer where their
    keys would take more than ``ITEMS_SMEM_BYTES`` of shared memory, one
    where even that is over the budget; raises if one item does not fit a
    block."""
    items = min(PACKED_ROWS // n_q, batch)
    while items > 1 and smem_bytes(head_dim, items, n_q, n_kv) > \
            ITEMS_SMEM_BYTES:
        items -= 1
    if smem_bytes(head_dim, items, n_q, n_kv) > BLOCK_SMEM_BYTES:
        raise ValueError(f"B15: one item of {n_q} queries over {n_kv} keys "
                         f"at head_dim {head_dim} is over a block's shared "
                         "memory")
    return items


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
    check_kernel_tensors("B15", q, k, v)
    check_head_dim("B15", hd)
    items = items_per_block(n_q, n_kv, hd, b)
    bias32 = key_bias(bias, b, n_kv, q.device)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = load_kernels().lib.unirec_packed_item_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias32 is None else bias32.data_ptr(), out.data_ptr(),
        *strides, b, h, n_q, n_kv, items, hd, dtype_code(q), sm_scale(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "packed_item_attention")
    packed_item_attention.launches += 1
    return out


packed_item_attention.launches = 0
