"""The trainable fused attention blocks of the Item Q-Former (B12s, B12c),
forward and backward.  Port of ``unirec_tpu/ops/fused_qformer_vjp.py``.

    out = W_o . SelfAttn(W_qkv . x) + b_o               (B12s, per item)
    out = W_o . CrossAttn(W_q . x, W_kv . mem) + b_o    (B12c, per item)

Both stop before the hidden dropout, the residual and the LayerNorm, which
stay in ``models/qformer.QFormerAttention``.  Attention-probability dropout is
not supported (the backward recomputes deterministic probabilities); the
model takes these blocks only when it is off.  The CUDA kernels are in
``csrc/fused_qformer_vjp.cu`` (projections in ``csrc/gemm_wide.cuh``, the
per-item attention in ``csrc/item_attention.cuh``); its source note says what
bounds them and how the attention packs whole items into tiles as the TPU
kernels do.  They take every shape ``supports_fused_train`` admits: any K,
F and head dim, and widths that are not a multiple of 8.

Layouts: rows item-major ``[B * K, D]``, heads as column ranges, the memory
field-major ``[B * F, Dm]``, a per-key additive bias (0 valid / ``NEG_INF``
missing; queries are never masked).  Weights are in the torch ``Linear``
layout ``[out, in]``, as the port's inference blocks take them: ``wqkv
[3D, D]`` (rows Wq | Wk | Wv), ``wkv [2D, Dm]`` (rows Wk | Wv), ``wq`` and
``wo [D, D]``; biases ``[out]``.

Four wrappers, one per TPU kernel, launch the kernels for CUDA tensors
(bfloat16 or float32, one dtype for the activations and weights; anything
the kernels do not take raises) and take the plain
versions beside them for CPU tensors; each counts its launches:

    self_attention_fwd   (B12s fwd)  -> out, qkv, ctx
    self_attention_bwd   (B12s bwd)  -> dqkv
    cross_attention_fwd  (B12c fwd)  -> out, q, kv, ctx
    cross_attention_bwd  (B12c bwd)  -> dq, dkv

``fused_self_attention_train`` and ``fused_cross_attention_train`` are the
differentiable blocks (``torch.autograd.Function``): their backward runs the
bwd wrapper, then dx, dmem, the weight gradients and the bias sums as plain
products, as the JAX package leaves them to XLA.  The plain versions keep the
JAX kernels' rounding points in any dtype: projections accumulate in fp32
and are cast to the input dtype after the bias; scores ``(q . k) * scale +
bias`` and the softmax ``e * (1 / sum e)`` are fp32, the probabilities are
cast to the input dtype before the value product; in the backward dctx stays
fp32, ``dp = dctx.cast . v^T``, ``ds = cast(p * (dp - sum(dp * p)) *
scale)``, ``dq = ds . k``, ``dk = ds^T . q`` and ``dv = p^T . dctx`` with p
and dctx in fp32.  In float32 they are the JAX kernels' arithmetic, which the
CPU tests hold against the Pallas kernels in interpret mode.  On the card
float32 takes the fp32 forms of the kernels (``_f32`` entries): projections
on ``csrc/gemm_f32.cuh`` (fp32 FMA, no TF32), the forward's attention on
``csrc/attention_f32.cuh`` and the backward's on the scalar kernels of
``csrc/fused_qformer_vjp.cu``, which keep their per-row statistics in a
scratch ``[B * H * n_q * 3]``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from unirec_tpu_torch.ops._build import check
from unirec_tpu_torch.ops.fused_qformer_layer import _entry

NEG_INF = -1e9
_TILE_ROWS = 256  # the JAX kernels' packed tile, read by supports_fused_train


def supports_fused_train(k: int, d: int, num_heads: int, f: int = 1) -> bool:
    """The JAX package's shape gate, answer for answer: K divides the 256-row
    tile, heads split the hidden dim, the packed memory tile and the weights
    fit the TPU kernels' VMEM (d <= 1024).  The model takes the fused blocks
    only where it holds."""
    return (
        k > 0
        and _TILE_ROWS % k == 0
        and d % num_heads == 0
        and d <= 1024
        and (_TILE_ROWS // k) * f <= 512
    )


# -- plain versions -------------------------------------------------------------


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x . w^T + b accumulated in fp32, cast to x's dtype (w ``[out, in]``)."""
    return (torch.matmul(x.float(), w.float().t()) + b.float()).to(x.dtype)


def _heads(t: torch.Tensor, rows: int, num_heads: int) -> torch.Tensor:
    """[B * rows, D] -> [B, H, rows, hd]."""
    d = t.shape[-1]
    return t.reshape(-1, rows, num_heads, d // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """[B, H, rows, hd] -> [B * rows, H * hd]."""
    b, h, rows, hd = t.shape
    return t.transpose(1, 2).reshape(b * rows, h * hd)


def _probs(q, k, kbias, n_kv: int, scale: float) -> torch.Tensor:
    """fp32 p = e * (1 / sum e) of s = (q . k) * scale + bias, per head."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + kbias.float().reshape(-1, 1, 1, n_kv)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def _attention_fwd(q, k, v, kbias, num_heads: int, n_q: int,
                   n_kv: int) -> torch.Tensor:
    """Per-item attention: q ``[B*n_q, D]``, k/v ``[B*n_kv, D]`` -> ctx."""
    dt = q.dtype
    qh, kh, vh = (_heads(q, n_q, num_heads), _heads(k, n_kv, num_heads),
                  _heads(v, n_kv, num_heads))
    p = _probs(qh, kh, kbias, n_kv, _scale(q.shape[-1] // num_heads))
    return _merge(torch.matmul(p.to(dt).float(), vh.float()).to(dt))


def _attention_bwd(q, k, v, kbias, dctx, num_heads: int, n_q: int,
                   n_kv: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The softmax VJP per item: (dq, dk, dv) in q's dtype; dctx fp32."""
    dt = q.dtype
    scale = _scale(q.shape[-1] // num_heads)
    qh, kh, vh = (_heads(q, n_q, num_heads), _heads(k, n_kv, num_heads),
                  _heads(v, n_kv, num_heads))
    dch = _heads(dctx, n_q, num_heads)
    p = _probs(qh, kh, kbias, n_kv, scale)
    dp = torch.matmul(dch.to(dt).float(), vh.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(dt).float()
    dq = torch.matmul(ds, kh.float()).to(dt)
    dk = torch.matmul(ds.transpose(-1, -2), qh.float()).to(dt)
    dv = torch.matmul(p.transpose(-1, -2), dch).to(dt)
    return _merge(dq), _merge(dk), _merge(dv)


def _scale(head_dim: int) -> float:
    """1/sqrt(head_dim), applied to the fp32 scores (a float32 constant)."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim), dtype=torch.float32))


def self_attention_fwd_plain(x2, kbias, wqkv, bqkv, wo, bo, *, num_heads: int,
                             n_q: int):
    """B12s forward's plain version (``_self_fwd_kernel``)."""
    d = x2.shape[-1]
    qkv = _linear(x2, wqkv, bqkv)
    q, k, v = qkv.split(d, dim=-1)
    ctx = _attention_fwd(q, k, v, kbias, num_heads, n_q, n_q)
    return _linear(ctx, wo, bo), qkv, ctx


def self_attention_bwd_plain(qkv, wo, kbias, dout, *, num_heads: int,
                             n_q: int) -> torch.Tensor:
    """B12s backward's plain version (``_self_bwd_kernel``): dqkv."""
    d = qkv.shape[-1] // 3
    dctx = torch.matmul(dout.float(), wo.float())  # dout . Wo^T in [out, in]
    q, k, v = qkv.split(d, dim=-1)
    return torch.cat(_attention_bwd(q, k, v, kbias, dctx, num_heads, n_q, n_q),
                     dim=-1)


def cross_attention_fwd_plain(x2, mem2, kbias, wq, bq, wkv, bkv, wo, bo, *,
                              num_heads: int, n_q: int, n_kv: int):
    """B12c forward's plain version (``_cross_fwd_kernel``)."""
    d = x2.shape[-1]
    q = _linear(x2, wq, bq)
    kv = _linear(mem2.to(x2.dtype), wkv, bkv)
    k, v = kv.split(d, dim=-1)
    ctx = _attention_fwd(q, k, v, kbias, num_heads, n_q, n_kv)
    return _linear(ctx, wo, bo), q, kv, ctx


def cross_attention_bwd_plain(q, kv, wo, kbias, dout, *, num_heads: int,
                              n_q: int, n_kv: int):
    """B12c backward's plain version (``_cross_bwd_kernel``): (dq, dkv)."""
    d = q.shape[-1]
    dctx = torch.matmul(dout.float(), wo.float())
    k, v = kv.split(d, dim=-1)
    dq, dk, dv = _attention_bwd(q, k, v, kbias, dctx, num_heads, n_q, n_kv)
    return dq, torch.cat([dk, dv], dim=-1)


# -- wrappers -------------------------------------------------------------------


def _on_card(block: str, tensors: dict, floats: dict = ()) -> bool:
    """False for CPU tensors (plain version); True after checking that the
    kernel takes these CUDA tensors (one dtype, bfloat16 or float32,
    contiguous, 16-byte aligned; ``floats`` float32 and contiguous); raises
    otherwise."""
    first = next(iter(tensors.values()))
    if first.device.type == "cpu":
        return False
    if first.device.type != "cuda":
        raise ValueError(f"{block}: unsupported device {first.device}")
    if first.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{block}: the CUDA kernels take bfloat16 or float32, "
                        f"got {first.dtype}")
    for name, t in {**tensors, **dict(floats)}.items():
        want = torch.float32 if name in dict(floats) else first.dtype
        if t.device != first.device:
            raise ValueError(f"{block}: {name} is on {t.device}, not "
                             f"{first.device}")
        if t.dtype != want:
            raise TypeError(f"{block}: the CUDA kernel takes {name} in {want}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{block}: {name} must be contiguous")
        if name not in dict(floats) and t.data_ptr() % 16:
            raise ValueError(f"{block}: {name} must be 16-byte aligned")
    return True


def _stats(x: torch.Tensor, items: int, num_heads: int, n_q: int):
    """The fp32 backward's scratch of per-row statistics, or None."""
    if x.dtype != torch.float32:
        return None
    return torch.empty(items * num_heads * n_q * 3, device=x.device,
                       dtype=torch.float32)


def _check_shapes(x2, n_q: int, num_heads: int, weights: dict) -> Tuple[int, int]:
    """(items, D) of rows ``x2 [items * n_q, D]``; raises on a weight whose
    shape is not the one given."""
    rows, d = x2.shape
    if num_heads <= 0 or d % num_heads or n_q <= 0 or rows % n_q:
        raise ValueError(f"rows {tuple(x2.shape)} do not fit n_q={n_q}, "
                         f"num_heads={num_heads}")
    for name, (t, shape) in weights.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    return rows // n_q, d


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def self_attention_fwd(x2, kbias, wqkv, bqkv, wo, bo, *, num_heads: int,
                       n_q: int):
    """B12s forward: (out, qkv, ctx).  x2 ``[B * n_q, D]``, kbias
    ``[B * n_q]`` float32, wqkv ``[3D, D]``, bqkv ``[3D]``, wo ``[D, D]``."""
    d = x2.shape[-1]
    items, _ = _check_shapes(x2, n_q, num_heads, {
        "kbias": (kbias, (x2.shape[0],)), "wqkv": (wqkv, (3 * d, d)),
        "bqkv": (bqkv, (3 * d,)), "wo": (wo, (d, d)), "bo": (bo, (d,))})
    if not _on_card("B12s fwd", {"x": x2, "wqkv": wqkv, "wo": wo},
                    {"kbias": kbias}):
        return self_attention_fwd_plain(x2, kbias, wqkv, bqkv, wo, bo,
                                        num_heads=num_heads, n_q=n_q)
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    qkv = torch.empty(rows, 3 * d, device=x2.device, dtype=x2.dtype)
    ctx = torch.empty_like(x2)
    bqkv32, bo32 = bqkv.float().contiguous(), bo.float().contiguous()
    err = _entry("unirec_b12_self_fwd", x2)(
        x2.data_ptr(), wqkv.data_ptr(), bqkv32.data_ptr(), wo.data_ptr(),
        bo32.data_ptr(), kbias.data_ptr(), out.data_ptr(), qkv.data_ptr(),
        ctx.data_ptr(), items, n_q, d, num_heads, _scale(d // num_heads),
        _stream(x2))
    check(err, "B12s fwd")
    self_attention_fwd.launches += 1
    return out, qkv, ctx


def self_attention_bwd(qkv, wo, kbias, dout, *, num_heads: int,
                       n_q: int) -> torch.Tensor:
    """B12s backward: dqkv ``[B * n_q, 3D]`` from the saved qkv and the
    output's gradient dout ``[B * n_q, D]``."""
    d = dout.shape[-1]
    items, _ = _check_shapes(dout, n_q, num_heads, {
        "qkv": (qkv, (dout.shape[0], 3 * d)), "wo": (wo, (d, d)),
        "kbias": (kbias, (dout.shape[0],))})
    if not _on_card("B12s bwd", {"dout": dout, "qkv": qkv, "wo": wo},
                    {"kbias": kbias}):
        return self_attention_bwd_plain(qkv, wo, kbias, dout,
                                        num_heads=num_heads, n_q=n_q)
    wo_t = wo.t().contiguous()  # [in, out]: the GEMM's contracted dim last
    dctx = torch.empty(dout.shape, device=dout.device, dtype=torch.float32)
    dqkv = torch.empty_like(qkv)
    stats = _stats(dout, items, num_heads, n_q)
    err = _entry("unirec_b12_self_bwd", dout)(
        qkv.data_ptr(), wo_t.data_ptr(), kbias.data_ptr(), dout.data_ptr(),
        dctx.data_ptr(), *([] if stats is None else [stats.data_ptr()]),
        dqkv.data_ptr(), items, n_q, d, num_heads, _scale(d // num_heads),
        _stream(dout))
    check(err, "B12s bwd")
    self_attention_bwd.launches += 1
    return dqkv


def cross_attention_fwd(x2, mem2, kbias, wq, bq, wkv, bkv, wo, bo, *,
                        num_heads: int, n_q: int, n_kv: int):
    """B12c forward: (out, q, kv, ctx).  x2 ``[B * n_q, D]``, mem2
    ``[B * n_kv, Dm]``, kbias ``[B * n_kv]`` float32, wq ``[D, D]``, wkv
    ``[2D, Dm]``, wo ``[D, D]``."""
    d, dm = x2.shape[-1], mem2.shape[-1]
    items, _ = _check_shapes(x2, n_q, num_heads, {
        "wq": (wq, (d, d)), "bq": (bq, (d,)), "wkv": (wkv, (2 * d, dm)),
        "bkv": (bkv, (2 * d,)), "wo": (wo, (d, d)), "bo": (bo, (d,))})
    if mem2.shape[0] != items * n_kv or tuple(kbias.shape) != (items * n_kv,):
        raise ValueError(f"mem {tuple(mem2.shape)} / kbias "
                         f"{tuple(kbias.shape)} do not hold {items} items of "
                         f"{n_kv} keys")
    if not _on_card("B12c fwd", {"x": x2, "mem": mem2, "wq": wq, "wkv": wkv,
                                 "wo": wo}, {"kbias": kbias}):
        return cross_attention_fwd_plain(x2, mem2, kbias, wq, bq, wkv, bkv, wo,
                                         bo, num_heads=num_heads, n_q=n_q,
                                         n_kv=n_kv)
    out = torch.empty_like(x2)
    q = torch.empty_like(x2)
    kv = torch.empty(mem2.shape[0], 2 * d, device=x2.device, dtype=x2.dtype)
    ctx = torch.empty_like(x2)
    bq32, bkv32, bo32 = (b.float().contiguous() for b in (bq, bkv, bo))
    err = _entry("unirec_b12_cross_fwd", x2)(
        x2.data_ptr(), mem2.data_ptr(), kbias.data_ptr(), wq.data_ptr(),
        bq32.data_ptr(), wkv.data_ptr(), bkv32.data_ptr(), wo.data_ptr(),
        bo32.data_ptr(), out.data_ptr(), q.data_ptr(), kv.data_ptr(),
        ctx.data_ptr(), items, n_q, n_kv, d, dm, num_heads,
        _scale(d // num_heads), _stream(x2))
    check(err, "B12c fwd")
    cross_attention_fwd.launches += 1
    return out, q, kv, ctx


def cross_attention_bwd(q, kv, wo, kbias, dout, *, num_heads: int, n_q: int,
                        n_kv: int):
    """B12c backward: (dq ``[B * n_q, D]``, dkv ``[B * n_kv, 2D]``) from the
    saved q and kv and the output's gradient dout."""
    d = dout.shape[-1]
    items, _ = _check_shapes(dout, n_q, num_heads, {
        "q": (q, tuple(dout.shape)), "wo": (wo, (d, d))})
    if tuple(kv.shape) != (items * n_kv, 2 * d) or tuple(kbias.shape) != (
            items * n_kv,):
        raise ValueError(f"kv {tuple(kv.shape)} / kbias {tuple(kbias.shape)} "
                         f"do not hold {items} items of {n_kv} keys")
    if not _on_card("B12c bwd", {"dout": dout, "q": q, "kv": kv, "wo": wo},
                    {"kbias": kbias}):
        return cross_attention_bwd_plain(q, kv, wo, kbias, dout,
                                         num_heads=num_heads, n_q=n_q,
                                         n_kv=n_kv)
    wo_t = wo.t().contiguous()
    dctx = torch.empty(dout.shape, device=dout.device, dtype=torch.float32)
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv)
    stats = _stats(dout, items, num_heads, n_q)
    err = _entry("unirec_b12_cross_bwd", dout)(
        q.data_ptr(), kv.data_ptr(), wo_t.data_ptr(), kbias.data_ptr(),
        dout.data_ptr(), dctx.data_ptr(),
        *([] if stats is None else [stats.data_ptr()]), dq.data_ptr(),
        dkv.data_ptr(), items, n_q, n_kv, d, num_heads,
        _scale(d // num_heads), _stream(dout))
    check(err, "B12c bwd")
    cross_attention_bwd.launches += 1
    return dq, dkv


self_attention_fwd.launches = 0
self_attention_bwd.launches = 0
cross_attention_fwd.launches = 0
cross_attention_bwd.launches = 0


# -- the differentiable blocks -----------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a . b with fp32 accumulation, cast to ``dtype`` (the JAX VJP's
    ``preferred_element_type=float32`` products; on the card a bf16 matmul)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.matmul(a, b).to(dtype)
    return torch.matmul(a.float(), b.float()).to(dtype)


def _bias_grad(g: torch.Tensor) -> torch.Tensor:
    return g.float().sum(dim=0).to(g.dtype)


class _SelfBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, kbias, wqkv, bqkv, wo, bo, num_heads, n_q):
        out, qkv, c = self_attention_fwd(x2, kbias, wqkv, bqkv, wo, bo,
                                         num_heads=num_heads, n_q=n_q)
        ctx.save_for_backward(x2, kbias, qkv, c, wqkv, wo)
        ctx.num_heads, ctx.n_q = num_heads, n_q
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, kbias, qkv, c, wqkv, wo = ctx.saved_tensors
        dout = dout.contiguous()
        dqkv = self_attention_bwd(qkv, wo, kbias, dout,
                                  num_heads=ctx.num_heads, n_q=ctx.n_q)
        return (_mm(dqkv, wqkv, x2.dtype), None, _mm(dqkv.t(), x2, wqkv.dtype),
                _bias_grad(dqkv), _mm(dout.t(), c, wo.dtype), _bias_grad(dout),
                None, None)


class _CrossBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, mem2, kbias, wq, bq, wkv, bkv, wo, bo, num_heads, n_q,
                n_kv):
        out, q, kv, c = cross_attention_fwd(x2, mem2, kbias, wq, bq, wkv, bkv,
                                            wo, bo, num_heads=num_heads,
                                            n_q=n_q, n_kv=n_kv)
        ctx.save_for_backward(x2, mem2, kbias, q, kv, c, wq, wkv, wo)
        ctx.num_heads, ctx.n_q, ctx.n_kv = num_heads, n_q, n_kv
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, mem2, kbias, q, kv, c, wq, wkv, wo = ctx.saved_tensors
        dout = dout.contiguous()
        dq, dkv = cross_attention_bwd(q, kv, wo, kbias, dout,
                                      num_heads=ctx.num_heads, n_q=ctx.n_q,
                                      n_kv=ctx.n_kv)
        return (_mm(dq, wq, x2.dtype), _mm(dkv, wkv, mem2.dtype), None,
                _mm(dq.t(), x2, wq.dtype), _bias_grad(dq),
                _mm(dkv.t(), mem2, wkv.dtype), _bias_grad(dkv),
                _mm(dout.t(), c, wo.dtype), _bias_grad(dout), None, None, None)


def fused_self_attention_train(x, key_bias, wqkv, bqkv, wo, bo, *,
                               num_heads: int) -> torch.Tensor:
    """W_o . SelfAttn(x) + b_o per item, differentiable.  x ``[B, K, D]``,
    key_bias ``[B, K]`` (0 / ``NEG_INF``); returns ``[B, K, D]``, before the
    residual and LayerNorm."""
    b, k, d = x.shape
    out = _SelfBlock.apply(x.reshape(b * k, d).contiguous(),
                           key_bias.reshape(b * k).float().contiguous(),
                           wqkv, bqkv, wo, bo, num_heads, k)
    return out.reshape(b, k, d)


def fused_cross_attention_train(x, mem, key_bias, wq, bq, wkv, bkv, wo, bo, *,
                                num_heads: int) -> torch.Tensor:
    """W_o . CrossAttn(x -> mem) + b_o per item, differentiable.  x
    ``[B, K, D]``, mem ``[B, F, Dm]``, key_bias ``[B, F]``; gradients flow
    to x, mem and the weights."""
    b, k, d = x.shape
    f, dm = mem.shape[1], mem.shape[2]
    out = _CrossBlock.apply(x.reshape(b * k, d).contiguous(),
                            mem.reshape(b * f, dm).contiguous(),
                            key_bias.reshape(b * f).float().contiguous(),
                            wq, bq, wkv, bkv, wo, bo, num_heads, k, f)
    return out.reshape(b, k, d)
