"""Causal grouped-query flash attention: the forward (kernel K1) and the
trainable form with its backward (kernel B7b).

K1 (``csrc/flash_causal_fwd.cu``) replaces
``unirec_tpu/ops/flash_causal_vjp.py::_fwd_kernel`` (public entry
``flash_causal_self_attention``), and with it the stock Pallas TPU flash
attention that ``unirec_tpu/models/qwen3.py`` takes for deterministic
forwards.  B7b (``csrc/flash_causal_bwd.cu``, a dq kernel and a dk/dv kernel)
replaces that file's ``_bwd`` (``_dq_kernel``, ``_dkv_kernel``), the backward
of its ``jax.custom_vjp``.

On the card, at the Qwen3-0.6B shapes (B 8, L 512, 16 query and 8 KV heads
of 128), each kernel is bound by the bytes it must move (q, k, v, dO and the
outputs: about 15 us for K1 and 20 us for each B7b kernel at 3.35 TB/s);
the arithmetic of the causal pairs takes a third of that at the bf16
tensor-core peak.  For bf16 the three kernels are FlashAttention-2 designs
on tensor cores (``mma.sync.m16n8k16``, fp32 accumulation): bf16 tiles in
shared memory filled by 16-byte ``cp.async`` copies through a two-stage
ring, one block per pair of query heads of a GQA group so each K/V tile is
loaded once for both, online softmax in fp32 registers, P and dS rounded to
bf16 in registers before their products, tiles above the diagonal and key
tiles that are all padding never loaded.  float32 keeps the scalar fp32 FMA
design up to head dim 256: plain TF32 on tensor cores keeps about 3 decimal
digits and breaks the 1e-5 float32 gates; above 256 the chunked form runs
K1 and B7b's dq on tensor cores in 3xTF32 (three TF32 products of split
operands, which hold the gates; ``csrc/flash_chunked_cluster.cuh``).  The
sources' notes give the details, and why ``wgmma`` is the next step.

Head dims: the kernels are built for every multiple of 16 up to 128 and
for 256 (``ops/attention.KERNEL_HEAD_DIMS``); any other head dim up to 256
runs zero-padded to the next instance with the softmax scale of the true
one (``ops/attention.padded_launch``), as the JAX kernel pads lanes; above
256 the chunked form of ``csrc/flash_chunked.cuh`` runs it in chunks of 256
(zero-padded to whole chunks).  The plain versions take every head dim, so
CPU tensors do too.

Layout: merged heads, K/V un-repeated.  q ``[B, L, Hq*hd]``, k/v
``[B, L, Hkv*hd]``, pad mask ``[B, L]`` (1 valid, 0 padded key); output
``[B, L, Hq*hd]`` in q's dtype.  Head h reads KV head ``h // (Hq // Hkv)``.
Every query row is computed, padded ones included: the joint model's mean
pool reads them.

Mask semantics are the additive -1e9 bias of the JAX XLA path.  The kernels
give masked keys probability exactly 0, which equals that bias whenever a
row has one unmasked causal key: key 0 of every row must be valid.
``check_pad_mask`` tests that with one host synchronisation; the wrappers
call it unless the caller says it already has (``Qwen3Model.forward``
checks once per forward, not once per layer).

``flash_causal_attention`` is the inference entry: on a CUDA tensor that
needs a gradient it raises, since the kernel's output has no path back to
q, k and v.  ``flash_causal_attention_train`` is a ``torch.autograd.Function``
(the JAX ``custom_vjp``): its forward runs K1 and keeps the per-(row, head)
max ``m`` and sum ``l`` as float32 ``[B, L, Hq]``, separate and never folded
into a logsumexp (fp32 swallows log l at the -1e9 mask magnitude); its
backward computes ``dsum = rowsum(dO * O)`` per head in plain torch, as JAX
does in XLA, then launches B7b's two kernels.  The mask gets no gradient.
A CPU tensor takes the plain versions of both directions.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.attention import (
    CHUNKED_FWD,
    CHUNKED_KEYS,
    CHUNKED_ROWS,
    NEG_INF,
    check_head_dim,
    chunked_form,
    chunked_plan,
    count_form,
    padded_launch,
    sm_scale,
)


def check_pad_mask(pad_mask: torch.Tensor) -> None:
    """Raise unless key 0 of every row is valid (one host synchronisation)."""
    if not bool((pad_mask[:, 0] != 0).all()):
        raise ValueError("zero-length row: key 0 of every row must be valid")


def _check_shapes(q, k, v, pad_mask, num_q_heads, num_kv_heads, mask_checked
                  ) -> torch.Tensor:
    """Validate the layout; returns the pad mask (ones when None)."""
    b, l, dq = q.shape
    if num_kv_heads <= 0 or num_q_heads % num_kv_heads:
        raise ValueError("num_q_heads must be a multiple of num_kv_heads")
    if dq % num_q_heads or k.shape != v.shape or k.shape[:2] != (b, l):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if k.shape[-1] != num_kv_heads * (dq // num_q_heads):
        raise ValueError("k/v width must be num_kv_heads * head_dim")
    if pad_mask is None:
        return torch.ones(b, l, device=q.device)
    if pad_mask.shape != (b, l):
        raise ValueError(f"pad_mask must be [B, L], got {tuple(pad_mask.shape)}")
    if not mask_checked:
        check_pad_mask(pad_mask)
    return pad_mask


def _check_kernel_inputs(name: str, num_q_heads: int,
                         *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take: one CUDA device, fp32 or bf16 q/k/v of one
    dtype (the first three tensors), a head dim of at least 1
    (``check_head_dim``; the launches pad it to an instance or to whole
    chunks of 256), contiguous, and each tensor on a 16-byte boundary (the bf16
    kernels copy rows in 16-byte pieces)."""
    q = tensors[0]
    check_head_dim(name, q.shape[-1] // num_q_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if any(t.dtype != q.dtype for t in tensors[1:3]):
        raise TypeError("q, k and v must share a dtype")
    if any(t.device != q.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs every tensor on a 16-byte boundary")


def _dtype_code(t: torch.Tensor) -> int:
    return 0 if t.dtype == torch.float32 else 1


def _heads(q, k, v, num_q_heads: int, num_kv_heads: int) -> list:
    """q, k and v as ``padded_launch`` inputs: merged heads."""
    return [(q, num_q_heads), (k, num_kv_heads), (v, num_kv_heads)]


def _split(q, k, v, num_q_heads, num_kv_heads):
    """Per-head views: q [B, Hq, L, hd], k/v repeated to [B, Hq, L, hd]."""
    b, l, dq = q.shape
    hd = dq // num_q_heads
    groups = num_q_heads // num_kv_heads
    qh = q.reshape(b, l, num_q_heads, hd).transpose(1, 2)
    kh = k.reshape(b, l, num_kv_heads, hd).repeat_interleave(groups, dim=2)
    vh = v.reshape(b, l, num_kv_heads, hd).repeat_interleave(groups, dim=2)
    return qh, kh.transpose(1, 2), vh.transpose(1, 2), hd


def _scores(q, k, v, pad_mask, num_q_heads, num_kv_heads):
    """fp32 scaled scores plus the causal and key-padding -1e9 bias, and the
    fp32 per-head value tensor: [B, Hq, L, L], [B, Hq, L, hd]."""
    qh, kh, vh, hd = _split(q, k, v, num_q_heads, num_kv_heads)
    l = q.shape[1]
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    scores = scores * sm_scale(hd)
    causal = torch.tril(torch.ones(l, l, device=q.device))[None, None]
    allowed = causal * pad_mask.float()[:, None, None, :]
    return scores + (1.0 - allowed) * NEG_INF, kh, vh, hd


def flash_causal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, pad_mask: torch.Tensor,
                                 num_q_heads: int,
                                 num_kv_heads: int) -> torch.Tensor:
    """The plain version: the XLA additive-mask path of
    ``unirec_tpu/models/qwen3.py`` (fp32 scores and softmax, probabilities
    cast to the input dtype, fp32 value product)."""
    b, l, dq = q.shape
    scores, _, vh, _ = _scores(q, k, v, pad_mask, num_q_heads, num_kv_heads)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.matmul(probs.float(), vh.float()).to(q.dtype)
    return ctx.transpose(1, 2).reshape(b, l, dq)


def flash_causal_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, pad_mask: torch.Tensor,
                                     num_q_heads: int, num_kv_heads: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """K1's training form, plain: (o, m, l) as ``_fwd_kernel`` computes them,
    o = (exp(s - m) v) / l in fp32 cast to q's dtype, m and l float32
    ``[B, L, Hq]``."""
    b, l, dq = q.shape
    scores, _, vh, _ = _scores(q, k, v, pad_mask, num_q_heads, num_kv_heads)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    den = p.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(p, vh.float()) / torch.where(den == 0, 1.0, den)
    o = ctx.to(q.dtype).transpose(1, 2).reshape(b, l, dq)
    return (o, m[..., 0].transpose(1, 2).contiguous(),
            den[..., 0].transpose(1, 2).contiguous())


def attention_dsum(do: torch.Tensor, o: torch.Tensor,
                   num_q_heads: int) -> torch.Tensor:
    """rowsum(dO * O) per (row, head), float32 ``[B, L, Hq]`` (JAX's
    ``_dsum``, outside the kernels)."""
    b, l, dq = do.shape
    return (do.float() * o.float()).reshape(b, l, num_q_heads,
                                            dq // num_q_heads).sum(-1)


def flash_causal_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, pad_mask: torch.Tensor,
                                     do: torch.Tensor, m: torch.Tensor,
                                     l: torch.Tensor, dsum: torch.Tensor,
                                     num_q_heads: int, num_kv_heads: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """B7b, plain: the formula of ``_dq_kernel`` and ``_dkv_kernel`` step by
    step from the saved m and l, in fp32; (dq, dk, dv) in the input dtype,
    dk and dv summed over each GQA group."""
    b, seq, dq_width = q.shape
    groups = num_q_heads // num_kv_heads
    scores, kh, vh, hd = _scores(q, k, v, pad_mask, num_q_heads, num_kv_heads)
    qh = q.reshape(b, seq, num_q_heads, hd).transpose(1, 2).float()
    doh = do.reshape(b, seq, num_q_heads, hd).transpose(1, 2).float()
    m_h = m.transpose(1, 2)[..., None]
    l_h = l.transpose(1, 2)[..., None]
    p = torch.exp(scores - m_h) / torch.where(l_h == 0, 1.0, l_h)
    dp = torch.matmul(doh, vh.float().transpose(-1, -2))
    ds = p * (dp - dsum.transpose(1, 2)[..., None]) * sm_scale(hd)
    dq = torch.matmul(ds, kh.float())
    dk = torch.matmul(ds.transpose(-1, -2), qh)  # [B, Hq, L, hd]
    dv = torch.matmul(p.transpose(-1, -2), doh)

    def kv_grad(g):  # sum the group's q heads into their kv head
        g = g.reshape(b, num_kv_heads, groups, seq, hd).sum(2)
        return g.transpose(1, 2).reshape(b, seq, num_kv_heads * hd).to(k.dtype)

    dq = dq.transpose(1, 2).reshape(b, seq, dq_width).to(q.dtype)
    return dq, kv_grad(dk), kv_grad(dv)


def _k1(q, k, v, pad_mask, num_q_heads, num_kv_heads, stats: bool):
    """Launch K1; returns the output, and (m, l) when ``stats``."""
    _check_kernel_inputs("K1", num_q_heads, q, k, v)
    b, l, dq = q.shape
    hd = dq // num_q_heads
    mask = pad_mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q)
    m = l_ = None
    if stats:
        m = torch.empty(b, l, num_q_heads, device=q.device)
        l_ = torch.empty_like(m)

    def launch(ins, outs, kernel_hd):
        splits, part = chunked_plan(
            q, CHUNKED_FWD, b, num_q_heads, l, l, kernel_hd,
            chunked_form(CHUNKED_FWD, kernel_hd, q), causal=True)
        err = load_kernels().lib.unirec_flash_causal_fwd(
            *(t.data_ptr() for t in ins), mask.data_ptr(), outs[0].data_ptr(),
            m.data_ptr() if stats else None, l_.data_ptr() if stats else None,
            None if part is None else part.data_ptr(), b, l, num_q_heads,
            num_kv_heads, kernel_hd, _dtype_code(q), splits, sm_scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
        check(err, "flash_causal_fwd")
        count_form(flash_causal_attention, CHUNKED_FWD, kernel_hd, q)

    padded_launch("K1", hd, _heads(q, k, v, num_q_heads, num_kv_heads),
                  [(out, num_q_heads)], launch)
    flash_causal_attention.launches += 1
    return (out, m, l_) if stats else out


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pad_mask: Optional[torch.Tensor], num_q_heads: int,
                           num_kv_heads: int, *,
                           mask_checked: bool = False) -> torch.Tensor:
    """Causal GQA attention for forwards without a gradient: K1 for CUDA
    tensors, the plain version for CPU tensors.  On a CUDA tensor it
    launches the kernel or raises; it raises too when q, k or v needs a
    gradient (use ``flash_causal_attention_train``)."""
    pad_mask = _check_shapes(q, k, v, pad_mask, num_q_heads, num_kv_heads,
                             mask_checked)
    if q.device.type == "cpu":
        return flash_causal_attention_plain(q, k, v, pad_mask, num_q_heads,
                                            num_kv_heads)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_causal_attention has no gradient: a forward that needs one "
            "goes through flash_causal_attention_train")
    return _k1(q, k, v, pad_mask, num_q_heads, num_kv_heads, stats=False)


flash_causal_attention.launches = 0
flash_causal_attention.forms = collections.Counter()  # K1's, above hd 256


def flash_causal_bwd_dq(q, k, v, pad_mask, do, m, l, dsum, num_q_heads: int,
                        num_kv_heads: int) -> torch.Tensor:
    """B7b's dq kernel on CUDA tensors (no plain fallback)."""
    _check_kernel_inputs("B7b", num_q_heads, q, k, v, do, m, l, dsum)
    b, seq, dq_width = q.shape
    hd = dq_width // num_q_heads
    mask = pad_mask.to(device=q.device, dtype=torch.float32).contiguous()
    dq = torch.empty_like(q)

    def launch(ins, outs, kernel_hd):
        qk, kk, vk, dok = ins
        splits, dqpart = chunked_plan(
            q, CHUNKED_ROWS, b, num_q_heads, seq, seq, kernel_hd,
            chunked_form(CHUNKED_ROWS, kernel_hd, q), causal=True)
        err = load_kernels().lib.unirec_flash_causal_bwd_dq(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), mask.data_ptr(),
            dok.data_ptr(), m.data_ptr(), l.data_ptr(), dsum.data_ptr(),
            outs[0].data_ptr(), None if dqpart is None else dqpart.data_ptr(),
            b, seq, num_q_heads, num_kv_heads, kernel_hd, _dtype_code(q),
            splits, sm_scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
        check(err, "flash_causal_bwd_dq")
        count_form(flash_causal_bwd_dq, CHUNKED_ROWS, kernel_hd, q)

    padded_launch("B7b", hd, _heads(q, k, v, num_q_heads, num_kv_heads)
                  + [(do, num_q_heads)], [(dq, num_q_heads)], launch)
    flash_causal_bwd_dq.launches += 1
    return dq


flash_causal_bwd_dq.launches = 0
flash_causal_bwd_dq.forms = collections.Counter()


def flash_causal_bwd_dkv(q, k, v, pad_mask, do, m, l, dsum, num_q_heads: int,
                         num_kv_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7b's dk/dv kernel on CUDA tensors (no plain fallback)."""
    _check_kernel_inputs("B7b", num_q_heads, q, k, v, do, m, l, dsum)
    b, seq, dq_width = q.shape
    hd = dq_width // num_q_heads
    mask = pad_mask.to(device=q.device, dtype=torch.float32).contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)

    def launch(ins, outs, kernel_hd):
        qk, kk, vk, dok = ins
        err = load_kernels().lib.unirec_flash_causal_bwd_dkv(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), mask.data_ptr(),
            dok.data_ptr(), m.data_ptr(), l.data_ptr(), dsum.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), b, seq, num_q_heads,
            num_kv_heads, kernel_hd, _dtype_code(q), sm_scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
        check(err, "flash_causal_bwd_dkv")
        count_form(flash_causal_bwd_dkv, CHUNKED_KEYS, kernel_hd, q)

    padded_launch("B7b", hd, _heads(q, k, v, num_q_heads, num_kv_heads)
                  + [(do, num_q_heads)],
                  [(dk, num_kv_heads), (dv, num_kv_heads)], launch)
    flash_causal_bwd_dkv.launches += 1
    return dk, dv


flash_causal_bwd_dkv.launches = 0
flash_causal_bwd_dkv.forms = collections.Counter()


def flash_causal_attention_bwd(q, k, v, pad_mask, do, m, l, num_q_heads: int,
                               num_kv_heads: int, o: torch.Tensor):
    """(dq, dk, dv) from the saved forward: dsum in plain torch, then B7b's
    two kernels on CUDA tensors or the plain version on CPU tensors."""
    do = do.to(q.dtype).contiguous()
    dsum = attention_dsum(do, o, num_q_heads).contiguous()
    if q.device.type == "cpu":
        return flash_causal_attention_bwd_plain(q, k, v, pad_mask, do, m, l,
                                                dsum, num_q_heads, num_kv_heads)
    dq = flash_causal_bwd_dq(q, k, v, pad_mask, do, m, l, dsum, num_q_heads,
                             num_kv_heads)
    dk, dv = flash_causal_bwd_dkv(q, k, v, pad_mask, do, m, l, dsum,
                                  num_q_heads, num_kv_heads)
    return dq, dk, dv


class _FlashCausalTrain(torch.autograd.Function):
    """The JAX ``custom_vjp``: K1 with (m, l) forward, B7b backward."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, num_q_heads, num_kv_heads):
        if q.device.type == "cpu":
            o, m, l = flash_causal_attention_fwd_plain(
                q, k, v, pad_mask, num_q_heads, num_kv_heads)
        else:
            o, m, l = _k1(q, k, v, pad_mask, num_q_heads, num_kv_heads,
                          stats=True)
        ctx.save_for_backward(q, k, v, pad_mask, o, m, l)
        ctx.heads = (num_q_heads, num_kv_heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pad_mask, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_causal_attention_bwd(q, k, v, pad_mask, do, m, l,
                                                *ctx.heads, o=o)
        return dq, dk, dv, None, None, None


def flash_causal_attention_train(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 pad_mask: Optional[torch.Tensor],
                                 num_q_heads: int, num_kv_heads: int, *,
                                 mask_checked: bool = False) -> torch.Tensor:
    """Causal GQA attention with a gradient to q, k and v (the port of
    ``flash_causal_self_attention``): K1 forward and B7b backward on CUDA
    tensors, their plain versions on CPU tensors."""
    pad_mask = _check_shapes(q, k, v, pad_mask, num_q_heads, num_kv_heads,
                             mask_checked)
    mask = pad_mask.to(device=q.device, dtype=torch.float32).contiguous()
    return _FlashCausalTrain.apply(q, k, v, mask, num_q_heads, num_kv_heads)
