"""The Item Q-Former's W8A8 blocks, one call per block (kernels B4-B6).

Port of ``unirec_tpu/ops/fused_qformer_int8.py``.  The CUDA kernels are the
W8A8 section of ``csrc/qformer_blocks.cu``, every product on the int8 TMA +
``wgmma`` GEMM of ``csrc/gemm_wide.cuh`` at any width; their source notes
say what the design spills to HBM.

    B4  fused_self_attention_block_q   y = LN(x + Wo . SelfAttn(x) + bo)
    B5  fused_cross_attention_block_q  y = LN(x + Wo . CrossAttn(x -> mem) + bo)
    B6  fused_ffn_block_q              y = LN(x + W2 . gelu(W1 . x + b1) + b2)

Every projection is int8 x int8 with int32 sums.  Weights are quantized once
per output column (``quantize_weight``) and held as int8 ``[out, in]`` with a
float32 ``[out]`` scale, the transpose of the JAX ``[in, out]`` / ``[1, out]``;
activations are quantized per row on the fly (``row_quant``).  A product is
dequantized as ``(float(acc) * row_scale) * col_scale`` and the bias is added
in fp32.  Between the projections the blocks are B1-B3 in bfloat16: qkv, q and
kv are cast to bfloat16 after the bias, attention rounds as B1/B2 do, and
residual and LayerNorm are fp32.  The FFN keeps the gelu output ``h`` in fp32
and requantizes it per row within each intermediate chunk (``ffn_q_chunk``):
the down projection sums ``float(h_q . W2_c) * h_scale_c`` over the chunks in
order, then ``y = LN(acc * s2 + b2 + x)``.

The plain versions compute the int32 products exactly in float64 (sums of at
most 127**2 * I stay far below 2**53) on any device.  Each wrapper launches
its kernel for a CUDA tensor (bfloat16 activations, int8 weights; anything
the kernel does not take raises) and takes the plain version for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.fused_qformer_layer import (
    _expect,
    _gelu,
    _item_attention,
    _layer_norm_rows,
    _on_card,
    _scale,
    _stream,
    ffn_chunk_size,
)

# the Qwen3 kernels B8/B9 take rows of whole 16-byte chunks of codes (the
# int8 GEMM's TMA kernel); B4-B6 take any width (its edge kernel too)
KERNEL_INT8_MULTIPLE = 16
# B6 folds its down projection's sums at chunk boundaries of 64 codes
KERNEL_CHUNK_MULTIPLE = 64


def true_div(a, b) -> torch.Tensor:
    """``a / b`` as one IEEE division, as JAX divides.  torch computes a
    Python-scalar numerator as ``reciprocal(b) * a``, and on CUDA a
    Python-scalar denominator as ``a * reciprocal(b)``: each can move a
    quotient by one ulp and so flip an int8 code."""
    dev = (b if isinstance(b, torch.Tensor) else a).device
    return torch.as_tensor(a, device=dev) / torch.as_tensor(b, device=dev)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[out, in]`` weight -> (int8 ``[out, in]``, float32 ``[out]`` scales):
    per output column of the JAX layout, ``scale = max(absmax, 1e-8) / 127``
    and ``q = clip(round(w / scale), -127, 127)``."""
    w = w.float()
    scale = true_div(w.abs().amax(dim=1).clamp_min(1e-8), 127.0)
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), scale.contiguous()


def row_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., W]`` -> (int8 codes, float32 ``[..., 1]`` row scales), as the
    JAX kernels' ``_row_quant``: ``absmax = max(max|x|, 1e-6)``, codes
    ``round(x * (127 / absmax))`` half to even with no clip, scale
    ``absmax / 127``."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    q = torch.round(x32 * true_div(127.0, absmax)).to(torch.int8)
    return q, true_div(absmax, 127.0)


def _int_mm(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact ``a_q . w_q^T`` of int8 codes (w ``[out, in]``) as float32: the
    float64 sum is the int32 sum, then rounded once as ``astype(f32)``."""
    return torch.matmul(a_q.double(), w_q.double().t()).float()


def _mm_q(a_q, rscale, w_q, col_scale) -> torch.Tensor:
    """``(float(a_q . w_q^T) * rscale) * col_scale`` (``_mm_q``)."""
    return _int_mm(a_q, w_q) * rscale * col_scale.float()


def ffn_q_chunk(intermediate: int, chunk: Optional[int] = None) -> int:
    """The intermediate columns over which B6 requantizes ``h`` per row: the
    whole intermediate when it is <= 4096 and a multiple of 128 (the JAX
    wrapper keeps it resident), else ``ffn_chunk_size``; an explicit
    ``chunk`` must divide the intermediate."""
    if chunk is None and intermediate <= 4096 and intermediate % 128 == 0:
        chunk = intermediate
    chunk = chunk or ffn_chunk_size(intermediate)
    if not chunk or intermediate % chunk:
        raise ValueError(f"no chunk divides intermediate dim {intermediate}")
    return chunk


# -- plain versions -----------------------------------------------------------


def fused_self_attention_block_q_plain(x, wqkv, sqkv, bqkv, wo, so, bo,
                                       ln_gamma, ln_beta, *, num_heads: int,
                                       n_q: int,
                                       ln_eps: float = 1e-12) -> torch.Tensor:
    """B4's plain version (``_self_block_kernel_q``)."""
    d = x.shape[-1]
    x_q, xs = row_quant(x)
    qkv = (_mm_q(x_q, xs, wqkv, sqkv) + bqkv.float()).to(torch.bfloat16)
    q, k, v = qkv.split(d, dim=-1)
    ctx = _item_attention(q, k, v, None, num_heads)
    c_q, cs = row_quant(ctx)
    out = _mm_q(c_q, cs, wo, so) + bo.float()
    return _layer_norm_rows(out + x.float(), ln_gamma, ln_beta,
                            ln_eps).to(x.dtype)


def fused_cross_attention_block_q_plain(x, mem, key_bias, wq, sq, bq, wkv, skv,
                                        bkv, wo, so, bo, ln_gamma, ln_beta, *,
                                        num_heads: int, n_q: int, n_kv: int,
                                        ln_eps: float = 1e-12) -> torch.Tensor:
    """B5's plain version (``_cross_block_kernel_q``): the memory rows are
    quantized with their own row scales; an item whose keys all carry
    ``NEG_INF`` attends uniformly over its own value rows."""
    d = x.shape[-1]
    x_q, xs = row_quant(x)
    q = (_mm_q(x_q, xs, wq, sq) + bq.float()).to(torch.bfloat16)
    m_q, ms = row_quant(mem)
    kv = (_mm_q(m_q, ms, wkv, skv) + bkv.float()).to(torch.bfloat16)
    k, v = kv.split(d, dim=-1)
    ctx = _item_attention(q, k, v, key_bias, num_heads)
    c_q, cs = row_quant(ctx)
    out = _mm_q(c_q, cs, wo, so) + bo.float()
    return _layer_norm_rows(out + x.float(), ln_gamma, ln_beta,
                            ln_eps).to(x.dtype)


def fused_ffn_block_q_plain(x, w1, s1, b1, w2, s2, b2, ln_gamma, ln_beta, *,
                            ln_eps: float = 1e-12,
                            chunk: Optional[int] = None) -> torch.Tensor:
    """B6's plain version (``_ffn_kernel_q``): fp32 tanh gelu, ``h`` not
    rounded to bfloat16, requantized per row within each chunk."""
    inter = w1.shape[0]
    chunk = ffn_q_chunk(inter, chunk)
    x_q, xs = row_quant(x)
    h = _gelu(_mm_q(x_q, xs, w1, s1) + b1.float(), approximate=True)
    acc = torch.zeros(*x.shape, dtype=torch.float32, device=x.device)
    for c0 in range(0, inter, chunk):
        h_q, hs = row_quant(h[..., c0:c0 + chunk])
        acc = acc + _int_mm(h_q, w2[:, c0:c0 + chunk]) * hs
    out = acc * s2.float() + b2.float() + x.float()
    return _layer_norm_rows(out, ln_gamma, ln_beta, ln_eps).to(x.dtype)


# -- wrappers -------------------------------------------------------------------


def _check_vectors(pairs) -> None:
    for name, t, n in pairs:
        _expect(t, (n,), name)


def fused_self_attention_block_q(x, wqkv, sqkv, bqkv, wo, so, bo, ln_gamma,
                                 ln_beta, *, num_heads: int, n_q: int,
                                 ln_eps: float = 1e-12) -> torch.Tensor:
    """B4: the W8A8 B1.  x ``[B, n_q, D]``; wqkv ``[3D, D]`` int8 (rows
    Wq | Wk | Wv) with scales sqkv ``[3D]``; wo ``[D, D]`` int8, so ``[D]``."""
    b, k, d = x.shape
    if k != n_q or num_heads <= 0 or d % num_heads:
        raise ValueError(f"x {tuple(x.shape)} does not fit n_q={n_q}, "
                         f"num_heads={num_heads}")
    _expect(wqkv, (3 * d, d), "wqkv")
    _expect(wo, (d, d), "wo")
    _check_vectors([("sqkv", sqkv, 3 * d), ("bqkv", bqkv, 3 * d),
                    ("so", so, d), ("bo", bo, d), ("ln_gamma", ln_gamma, d),
                    ("ln_beta", ln_beta, d)])
    args = (x, wqkv, sqkv, bqkv, wo, so, bo, ln_gamma, ln_beta)
    name = "fused_self_attention_block_q"
    if not _on_card(x, name, {"x": x},
                    {"sqkv": sqkv, "bqkv": bqkv, "so": so, "bo": bo,
                     "ln_gamma": ln_gamma, "ln_beta": ln_beta},
                    codes={"wqkv": wqkv, "wo": wo}):
        return fused_self_attention_block_q_plain(
            *args, num_heads=num_heads, n_q=n_q, ln_eps=ln_eps)
    rows = b * k
    dev = x.device
    out = torch.empty_like(x)
    xq = torch.empty(rows, d, device=dev, dtype=torch.int8)
    xs = torch.empty(rows, device=dev, dtype=torch.float32)
    qkv = torch.empty(rows, 3 * d, device=dev, dtype=torch.bfloat16)
    ctx = torch.empty(rows, d, device=dev, dtype=torch.bfloat16)
    acc = torch.empty(rows, d, device=dev, dtype=torch.float32)
    err = load_kernels().lib.unirec_qformer_self_block_q(
        x.data_ptr(), wqkv.data_ptr(), sqkv.data_ptr(), bqkv.data_ptr(),
        wo.data_ptr(), so.data_ptr(), bo.data_ptr(), ln_gamma.data_ptr(),
        ln_beta.data_ptr(), out.data_ptr(), xq.data_ptr(), xs.data_ptr(),
        qkv.data_ptr(), ctx.data_ptr(), acc.data_ptr(), b, k, d, num_heads,
        _scale(d // num_heads, torch.bfloat16), ln_eps, _stream(x))
    check(err, name)
    fused_self_attention_block_q.launches += 1
    return out


def fused_cross_attention_block_q(x, mem, key_bias, wq, sq, bq, wkv, skv, bkv,
                                  wo, so, bo, ln_gamma, ln_beta, *,
                                  num_heads: int, n_q: int, n_kv: int,
                                  ln_eps: float = 1e-12) -> torch.Tensor:
    """B5: the W8A8 B2.  x ``[B, n_q, D]``, mem ``[B, n_kv, Dm]``, key_bias
    ``[B, n_kv]`` float32 (0 valid, NEG_INF missing); wq ``[D, D]``, wkv
    ``[2D, Dm]`` (rows Wk | Wv), wo ``[D, D]`` int8 with their scales."""
    b, k, d = x.shape
    if k != n_q or num_heads <= 0 or d % num_heads:
        raise ValueError(f"x {tuple(x.shape)} does not fit n_q={n_q}, "
                         f"num_heads={num_heads}")
    if mem.dim() != 3 or mem.shape[:2] != (b, n_kv):
        raise ValueError(f"mem must be [{b}, {n_kv}, Dm], got {tuple(mem.shape)}")
    dm = mem.shape[2]
    _expect(key_bias, (b, n_kv), "key_bias")
    _expect(wq, (d, d), "wq")
    _expect(wkv, (2 * d, dm), "wkv")
    _expect(wo, (d, d), "wo")
    _check_vectors([("sq", sq, d), ("bq", bq, d), ("skv", skv, 2 * d),
                    ("bkv", bkv, 2 * d), ("so", so, d), ("bo", bo, d),
                    ("ln_gamma", ln_gamma, d), ("ln_beta", ln_beta, d)])
    args = (x, mem, key_bias, wq, sq, bq, wkv, skv, bkv, wo, so, bo, ln_gamma,
            ln_beta)
    name = "fused_cross_attention_block_q"
    if not _on_card(x, name, {"x": x, "mem": mem},
                    {"key_bias": key_bias, "sq": sq, "bq": bq, "skv": skv,
                     "bkv": bkv, "so": so, "bo": bo, "ln_gamma": ln_gamma,
                     "ln_beta": ln_beta},
                    codes={"wq": wq, "wkv": wkv, "wo": wo}):
        return fused_cross_attention_block_q_plain(
            *args, num_heads=num_heads, n_q=n_q, n_kv=n_kv, ln_eps=ln_eps)
    rows, mem_rows = b * k, b * n_kv
    dev = x.device
    out = torch.empty_like(x)
    xq = torch.empty(rows, d, device=dev, dtype=torch.int8)
    xs = torch.empty(rows, device=dev, dtype=torch.float32)
    mq = torch.empty(mem_rows, dm, device=dev, dtype=torch.int8)
    ms = torch.empty(mem_rows, device=dev, dtype=torch.float32)
    q = torch.empty(rows, d, device=dev, dtype=torch.bfloat16)
    kv = torch.empty(mem_rows, 2 * d, device=dev, dtype=torch.bfloat16)
    ctx = torch.empty(rows, d, device=dev, dtype=torch.bfloat16)
    acc = torch.empty(rows, d, device=dev, dtype=torch.float32)
    err = load_kernels().lib.unirec_qformer_cross_block_q(
        x.data_ptr(), mem.data_ptr(), key_bias.data_ptr(), wq.data_ptr(),
        sq.data_ptr(), bq.data_ptr(), wkv.data_ptr(), skv.data_ptr(),
        bkv.data_ptr(), wo.data_ptr(), so.data_ptr(), bo.data_ptr(),
        ln_gamma.data_ptr(), ln_beta.data_ptr(), out.data_ptr(), xq.data_ptr(),
        xs.data_ptr(), mq.data_ptr(), ms.data_ptr(), q.data_ptr(),
        kv.data_ptr(), ctx.data_ptr(), acc.data_ptr(), b, k, n_kv, d, dm,
        num_heads, _scale(d // num_heads, torch.bfloat16), ln_eps, _stream(x))
    check(err, name)
    fused_cross_attention_block_q.launches += 1
    return out


def fused_ffn_block_q(x, w1, s1, b1, w2, s2, b2, ln_gamma, ln_beta, *,
                      ln_eps: float = 1e-12,
                      chunk: Optional[int] = None) -> torch.Tensor:
    """B6: the W8A8 FFN, row-wise.  x ``[B, K, D]``; w1 ``[I, D]`` int8 with
    s1 ``[I]``, w2 ``[D, I]`` int8 with s2 ``[D]``; ``chunk`` as
    ``ffn_q_chunk``."""
    b, k, d = x.shape
    inter = w1.shape[0]
    _expect(w1, (inter, d), "w1")
    _expect(w2, (d, inter), "w2")
    _check_vectors([("s1", s1, inter), ("b1", b1, inter), ("s2", s2, d),
                    ("b2", b2, d), ("ln_gamma", ln_gamma, d),
                    ("ln_beta", ln_beta, d)])
    chunk = ffn_q_chunk(inter, chunk)
    args = (x, w1, s1, b1, w2, s2, b2, ln_gamma, ln_beta)
    name = "fused_ffn_block_q"
    if not _on_card(x, name, {"x": x},
                    {"s1": s1, "b1": b1, "s2": s2, "b2": b2,
                     "ln_gamma": ln_gamma, "ln_beta": ln_beta},
                    codes={"w1": w1, "w2": w2}):
        return fused_ffn_block_q_plain(*args, ln_eps=ln_eps, chunk=chunk)
    if chunk % KERNEL_CHUNK_MULTIPLE:
        raise ValueError(f"{name}: chunk {chunk} is not a multiple of "
                         f"{KERNEL_CHUNK_MULTIPLE}")
    rows = b * k
    dev = x.device
    out = torch.empty_like(x)
    xq = torch.empty(rows, d, device=dev, dtype=torch.int8)
    xs = torch.empty(rows, device=dev, dtype=torch.float32)
    u = torch.empty(rows, inter, device=dev, dtype=torch.float32)
    hq = torch.empty(rows, inter, device=dev, dtype=torch.int8)
    hs = torch.empty(rows, inter // chunk, device=dev, dtype=torch.float32)
    acc = torch.empty(rows, d, device=dev, dtype=torch.float32)
    err = load_kernels().lib.unirec_qformer_ffn_block_q(
        x.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), ln_gamma.data_ptr(),
        ln_beta.data_ptr(), out.data_ptr(), xq.data_ptr(), xs.data_ptr(),
        u.data_ptr(), hq.data_ptr(), hs.data_ptr(), acc.data_ptr(), rows, d,
        inter, chunk, ln_eps, _stream(x))
    check(err, name)
    fused_ffn_block_q.launches += 1
    return out


fused_self_attention_block_q.launches = 0
fused_cross_attention_block_q.launches = 0
fused_ffn_block_q.launches = 0
