"""Causal grouped-query flash attention, forward (kernel K1).

Replaces ``unirec_tpu/ops/flash_causal_vjp.py::_fwd_kernel`` (public entry
``flash_causal_self_attention``), and with it the stock Pallas TPU flash
attention that ``unirec_tpu/models/qwen3.py`` takes for deterministic
forwards.  The CUDA kernel is ``csrc/flash_causal_fwd.cu``; its source note
says what bounds it on the card (arithmetic at L=512) and how the first
design handles that.

Layout: merged heads, K/V un-repeated.  q ``[B, L, Hq*hd]``, k/v
``[B, L, Hkv*hd]``, pad mask ``[B, L]`` (1 valid, 0 padded key); output
``[B, L, Hq*hd]`` in q's dtype.  Head h reads KV head ``h // (Hq // Hkv)``.
Every query row is computed, padded ones included: the joint model's mean
pool reads them.

Mask semantics are the additive -1e9 bias of the JAX XLA path.  The kernel
gives masked keys probability exactly 0, which equals that bias whenever a
row has one unmasked causal key; the wrapper guarantees it by refusing a
mask whose key 0 is padded (a zero-length row).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.attention import NEG_INF

KERNEL_HEAD_DIM = 128


def flash_causal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, pad_mask: torch.Tensor,
                                 num_q_heads: int,
                                 num_kv_heads: int) -> torch.Tensor:
    """The plain version: the XLA additive-mask path of
    ``unirec_tpu/models/qwen3.py`` (fp32 scores and softmax, probabilities
    cast to the input dtype, fp32 value product)."""
    b, l, dq = q.shape
    hd = dq // num_q_heads
    groups = num_q_heads // num_kv_heads
    qh = q.reshape(b, l, num_q_heads, hd).transpose(1, 2)
    kh = k.reshape(b, l, num_kv_heads, hd).repeat_interleave(groups, dim=2)
    vh = v.reshape(b, l, num_kv_heads, hd).repeat_interleave(groups, dim=2)
    kh, vh = kh.transpose(1, 2), vh.transpose(1, 2)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(hd))
    causal = torch.tril(torch.ones(l, l, device=q.device))[None, None]
    allowed = causal * pad_mask.float()[:, None, None, :]
    scores = scores + (1.0 - allowed) * NEG_INF
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.matmul(probs.float(), vh.float()).to(q.dtype)
    return ctx.transpose(1, 2).reshape(b, l, dq)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pad_mask: Optional[torch.Tensor], num_q_heads: int,
                           num_kv_heads: int) -> torch.Tensor:
    """Causal GQA attention: K1 for CUDA tensors, the plain version for CPU
    tensors.  On a CUDA tensor it launches the kernel or raises."""
    b, l, dq = q.shape
    if num_kv_heads <= 0 or num_q_heads % num_kv_heads:
        raise ValueError("num_q_heads must be a multiple of num_kv_heads")
    if dq % num_q_heads or k.shape != v.shape or k.shape[:2] != (b, l):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    hd = dq // num_q_heads
    if k.shape[-1] != num_kv_heads * hd:
        raise ValueError("k/v width must be num_kv_heads * head_dim")
    if pad_mask is None:
        pad_mask = torch.ones(b, l, device=q.device)
    if pad_mask.shape != (b, l):
        raise ValueError(f"pad_mask must be [B, L], got {tuple(pad_mask.shape)}")
    if not bool((pad_mask[:, 0] != 0).all()):
        raise ValueError("zero-length row: key 0 of every row must be valid")
    if q.device.type == "cpu":
        return flash_causal_attention_plain(q, k, v, pad_mask, num_q_heads,
                                            num_kv_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(f"K1 is built for head_dim {KERNEL_HEAD_DIM}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    mask = pad_mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q)
    err = load_kernels().lib.unirec_flash_causal_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b, l, num_q_heads, num_kv_heads, hd,
        0 if q.dtype == torch.float32 else 1,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "flash_causal_fwd")
    flash_causal_attention.launches += 1
    return out


flash_causal_attention.launches = 0
