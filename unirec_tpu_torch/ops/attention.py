"""Attention primitives for the Q-Former stacks (port of
``unirec_tpu/ops/attention.py``, the fp32-softmax path with its
attention-probability dropout).

Layout and semantics follow the JAX module: per-head ``[B, H, L, head_dim]``
tensors and an additive bias broadcastable to ``[B, H, Lq, Lkv]`` with
``NEG_INF`` at masked keys.  The item Q-Former's memory (14 fields) is far
below the length where the JAX package switches to its streaming kernel, so
this path is plain tensor code.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from unirec_tpu_torch.ops.dropout import DropoutStream, dropout

# exp(-1e9) == 0.0 in fp32: identical to the reference's additive -10000.
NEG_INF = -1e9


def make_additive_mask(mask: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, Lk] 0/1 validity mask -> additive bias [B, 1, 1, Lk]."""
    return ((1.0 - mask.to(dtype)) * NEG_INF)[:, None, None, :]


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, D // H]."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, hd] -> [B, L, H * hd]."""
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
              drop: Optional[DropoutStream] = None) -> torch.Tensor:
    """Softmax attention with fp32 scores and softmax whatever the input
    dtype; probabilities are cast back to the input dtype before the value
    product, which accumulates in fp32 (the JAX einsums'
    ``preferred_element_type=float32``).  A training forward's ``drop``
    stream applies attention-probability dropout to the fp32 probabilities,
    as the JAX function does."""
    in_dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate, drop)
    out = torch.matmul(probs.to(in_dtype).float(), v.float())
    return out.to(in_dtype)
