"""Sequence-parallel cross-attention: the memory split over the ranks of a
process group (port of ``unirec_tpu/ops/sharded_attention.py``).

Each sp rank holds its slice of the memory's keys and values and the whole
(replicated) queries.  It computes the partial softmax statistics of its
slice, (acc, l, m): the unnormalised context, the normaliser and the row
max; the ranks then combine them exactly by log-sum-exp: ``m``'s max over
the group (detached: softmax is shift invariant, as the JAX op's
``stop_gradient``), ``l * c`` and ``acc * c`` summed over it with
``c = exp(m - max)``, and the output ``acc / l`` (``l == 0`` taken as 1).
An all-masked slice has ``m = -1e9`` under the additive mask, so its
``c`` is 0, never NaN.

The gradient.  The output is replicated over the group and every sp rank
computes the same loss from it, while the K/V projections and the memory's
producers are sharded.  The rule that is right throughout: each sp rank
scales its loss by 1/S; the sums here are ``AllReduceSum``, whose backward
all-reduces the cotangent (the S scaled cotangents add up to the whole
one, and each rank's slice then receives its full gradient); after the
backward every parameter's gradient is summed over the group (and averaged
over dp, ``parallel/mesh.all_reduce_sum``).  Replicated parameters then
sum S copies of 1/S, and sharded ones the S slices' parts.

The collective is this module's own ``torch.autograd.Function``
(``torch.distributed.nn.functional.all_reduce`` is deprecated).  The JAX
trainer refuses sp with the flash and fused kernels, so this runs plain
attention, einsums and collectives as the JAX op does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist


class AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the cotangent over it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def local_partial_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: Optional[torch.Tensor]
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(acc [B, H, Lq, hd], l [B, H, Lq, 1], m [B, H, Lq, 1]) of one slice,
    float32: q [B, H, Lq, hd], k / v [B, H, Lkv_local, hd], bias
    [B, 1, 1, Lkv_local]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    acc = torch.matmul(e.to(v.dtype).float(), v.float())
    return acc, l, m


def sequence_parallel_cross_attention(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      bias: Optional[torch.Tensor] = None,
                                      *, group=None) -> torch.Tensor:
    """Exact cross-attention over a memory split across ``group``: q
    replicated [B, H, Lq, hd], k / v this rank's slice [B, H, Lkv / S, hd]
    and bias its slice [B, 1, 1, Lkv / S] (``split_memory``, which refuses
    a length that does not divide, as the JAX op does)."""
    acc, l, m = local_partial_attention(q, k, v, bias)
    m_global = m.detach().clone()
    dist.all_reduce(m_global, op=dist.ReduceOp.MAX, group=group)
    correction = torch.exp(m - m_global)
    l_global = AllReduceSum.apply(l * correction, group)
    acc_global = AllReduceSum.apply(acc * correction, group)
    safe_l = torch.where(l_global == 0.0, torch.ones_like(l_global),
                         l_global)
    return (acc_global / safe_l).to(q.dtype)


def split_memory(x: torch.Tensor, shards: int, index: int,
                 dim: int = 1) -> torch.Tensor:
    """Slice ``index`` of ``shards`` equal slices of ``x`` along ``dim``
    (the memory axis); raises when the length does not divide."""
    n = x.shape[dim]
    if n % shards != 0:
        raise ValueError(f"memory length {n} not divisible by {shards}")
    per = n // shards
    return x.narrow(dim, index * per, per)
