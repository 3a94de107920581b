"""The Item Q-Former's transformer blocks, one call per block (kernels B1-B3).

Port of ``unirec_tpu/ops/fused_qformer_layer.py``.  The CUDA kernels are in
``csrc/qformer_blocks.cu``; its source note says what bounds them on the card
(the projection GEMMs) and what the design spills to HBM.  They take any
width: every product runs on the warpgroup GEMM of ``csrc/gemm_wide.cuh``
(its TMA kernel where the rows are whole 16-byte chunks, its edge kernel
otherwise, e.g. hidden 1020), and the attention core
(``csrc/item_attention.cuh``) takes any head dim, K and F.  The residual
product writes the LayerNorm output itself over a thread-block cluster where
TMA takes its rows and the width is at most 2048; elsewhere it writes the
fp32 sum into a scratch buffer that a LayerNorm kernel reads
(``two_pass_layer_norm``).  Float32 activations (the JAX kernels take them
too) take the blocks' fp32 forms (``_f32`` entries): every product on the
fp32 GEMM of ``csrc/gemm_f32.cuh`` (fp32 FMA on CUDA cores, no TF32), the
attention on the scalar fp32 kernel of ``csrc/attention_f32.cuh`` (B15's),
and the fp32 pre-LN sum through the scratch buffer to the LayerNorm.

    B1  fused_self_attention_block   y = LN(x + Wo . SelfAttn(x) + bo)
    B2  fused_cross_attention_block  y = LN(x + Wo . CrossAttn(x -> mem) + bo)
    B3  fused_ffn_block              y = LN(x + W2 . gelu(W1 . x + b1) + b2)

Signatures follow the JAX functions (x ``[B, K, D]``, mem ``[B, F, Dm]``,
key_bias ``[B, F]`` of 0 / ``NEG_INF``), but the weights are packed in the
torch ``Linear`` layout ``[out, in]`` so that the GEMM reads them with the
contracted dimension contiguous: ``wqkv [3D, D]`` (rows Wq | Wk | Wv),
``wkv [2D, Dm]`` (rows Wk | Wv), ``wo [D, D]``, ``w1 [I, D]``, ``w2 [D, I]``.
Biases and LayerNorm parameters are float32 (``inference/fused_qformer.py``
packs them all once).

Each wrapper launches its kernel for a CUDA tensor (bfloat16 or float32
activations and weights of one dtype; anything the kernel does not take
raises) and takes the plain version beside it for a
CPU tensor.  The plain versions mirror the JAX kernels' rounding points in any
dtype: projections accumulate in fp32 and are cast to the input dtype after
the bias; q is scaled in the input dtype; scores, softmax, residual and
LayerNorm are fp32; unnormalised probabilities are cast to the input dtype
before the value product and the row sum is divided out after it; gelu is
tanh for bfloat16 and exact erf otherwise, computed in fp32 and cast before W2.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from unirec_tpu_torch.ops._build import check, load_kernels

NEG_INF = -1e9


def ffn_chunk_size(intermediate: int) -> int:
    """Largest lane-aligned chunk (<=1024, multiple of 128) dividing the
    intermediate dim; 0 if none exists.  The JAX engine's FFN kernel needs
    one (``supports_fused`` reads it); the CUDA FFN block does not chunk."""
    for c in range(min(1024, intermediate), 0, -128):
        if intermediate % c == 0 and c % 128 == 0:
            return c
    return 0


# -- plain versions -----------------------------------------------------------


def _scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(head_dim) as the JAX kernel applies it: a weakly typed Python
    float multiplied into an array of ``dtype`` is first cast to ``dtype``."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim), dtype=dtype))


def _linear_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """x . w^T + b with fp32 accumulation (w is ``[out, in]``)."""
    return torch.matmul(x.float(), w.float().t()) + b.float()


def _layer_norm_rows(x32: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _gelu(h32: torch.Tensor, approximate: bool) -> torch.Tensor:
    if approximate:  # jax.nn.gelu(approximate=True)
        k = math.sqrt(2.0 / math.pi)
        return h32 * (0.5 * (1.0 + torch.tanh(k * (h32 + 0.044715 * h32 ** 3))))
    return F.gelu(h32, approximate="none")


def _item_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: Optional[torch.Tensor],
                    num_heads: int) -> torch.Tensor:
    """Per-item softmax attention: q ``[B, nq, D]``, k/v ``[B, nkv, D]`` in
    the block dtype, key_bias ``[B, nkv]`` or None -> ctx ``[B, nq, D]``."""
    b, nq, d = q.shape
    nkv = k.shape[1]
    hd = d // num_heads
    qh = q.reshape(b, nq, num_heads, hd).transpose(1, 2) * _scale(hd, q.dtype)
    kh = k.reshape(b, nkv, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, nkv, num_heads, hd).transpose(1, 2)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    c = torch.matmul(e.to(q.dtype).float(), vh.float())
    c = c * (1.0 / e.sum(dim=-1, keepdim=True))
    return c.to(q.dtype).transpose(1, 2).reshape(b, nq, d)


def fused_self_attention_block_plain(x, wqkv, bqkv, wo, bo, ln_gamma, ln_beta,
                                     *, num_heads: int, n_q: int,
                                     ln_eps: float = 1e-12) -> torch.Tensor:
    """B1's plain version (``_self_block_kernel``)."""
    d = x.shape[-1]
    qkv = _linear_f32(x, wqkv, bqkv).to(x.dtype)
    q, k, v = qkv.split(d, dim=-1)
    ctx = _item_attention(q, k, v, None, num_heads)
    out = _linear_f32(ctx, wo, bo) + x.float()
    return _layer_norm_rows(out, ln_gamma, ln_beta, ln_eps).to(x.dtype)


def fused_cross_attention_block_plain(x, mem, key_bias, wq, bq, wkv, bkv, wo,
                                      bo, ln_gamma, ln_beta, *, num_heads: int,
                                      n_q: int, n_kv: int,
                                      ln_eps: float = 1e-12) -> torch.Tensor:
    """B2's plain version (``_cross_block_kernel``).  An item whose keys all
    carry ``NEG_INF`` attends uniformly over its own value rows."""
    d = x.shape[-1]
    q = _linear_f32(x, wq, bq).to(x.dtype)
    k, v = _linear_f32(mem, wkv, bkv).to(x.dtype).split(d, dim=-1)
    ctx = _item_attention(q, k, v, key_bias, num_heads)
    out = _linear_f32(ctx, wo, bo) + x.float()
    return _layer_norm_rows(out, ln_gamma, ln_beta, ln_eps).to(x.dtype)


def fused_ffn_block_plain(x, w1, b1, w2, b2, ln_gamma, ln_beta, *,
                          ln_eps: float = 1e-12) -> torch.Tensor:
    """B3's plain version (``_ffn_kernel``): b2 is added after the whole
    W2 accumulation, then the residual."""
    h = _gelu(_linear_f32(x, w1, b1), x.dtype == torch.bfloat16).to(x.dtype)
    out = _linear_f32(h, w2, b2) + x.float()
    return _layer_norm_rows(out, ln_gamma, ln_beta, ln_eps).to(x.dtype)


# -- wrappers -------------------------------------------------------------------


def two_pass_layer_norm(d: int, k: int) -> bool:
    """Whether a block's residual product of width ``d`` over ``k`` inputs
    takes the two-pass route (fp32 sum into a scratch buffer, then a
    LayerNorm kernel) rather than the cluster epilogue, by the kernels' own
    rule (``unirec_resid_ln_two_pass``: ``csrc/gemm_wide.cuh``'s
    ``wl_shape``), for 16-byte aligned tensors, which ``_on_card`` checks
    and torch's allocator gives.  Builds the kernels at first use."""
    return bool(load_kernels().lib.unirec_resid_ln_two_pass(d, k))


def _acc(rows: int, d: int, k: int, x: torch.Tensor):
    """The fp32 pre-LN scratch where the two-pass route needs it (always for
    float32 x), else None (a null pointer)."""
    if x.dtype != torch.float32 and not two_pass_layer_norm(d, k):
        return None
    return torch.empty(rows, d, device=x.device, dtype=torch.float32)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _expect(t: torch.Tensor, shape, name: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _on_card(x: torch.Tensor, block: str, weights, params,
             codes=None, dtypes=KERNEL_DTYPES) -> bool:
    """False for CPU tensors (plain version); True after checking that the
    kernel takes these CUDA tensors (x in ``dtypes``: bfloat16 or float32
    for B1-B6, bfloat16 alone for the Qwen3 kernels; ``weights`` in x's
    dtype, ``params`` float32, ``codes`` int8); raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{block}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{block}: the CUDA kernel takes "
                        f"{' or '.join(str(t)[6:] for t in dtypes)}, got "
                        f"{x.dtype}")
    codes = codes or {}
    for name, t in {**weights, **params, **codes}.items():
        if t.device != x.device:
            raise ValueError(f"{block}: {name} is on {t.device}, x on {x.device}")
        want = (torch.int8 if name in codes else
                x.dtype if name in weights else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{block}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{block}: {name} must be contiguous")
        if name not in params and t.data_ptr() % 16:
            raise ValueError(f"{block}: {name} must be 16-byte aligned")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _entry(name: str, x: torch.Tensor):
    """The C entry ``name`` for x's dtype (its fp32 form ``name_f32`` for
    float32)."""
    return getattr(load_kernels().lib,
                   name + ("_f32" if x.dtype == torch.float32 else ""))


def fused_self_attention_block(x, wqkv, bqkv, wo, bo, ln_gamma, ln_beta, *,
                               num_heads: int, n_q: int,
                               ln_eps: float = 1e-12) -> torch.Tensor:
    """B1: LayerNorm(x + Wo . SelfAttn(x) + bo), attention within each item's
    ``n_q`` rows.  x ``[B, n_q, D]``; wqkv ``[3D, D]``, bqkv ``[3D]``."""
    b, k, d = x.shape
    if k != n_q or num_heads <= 0 or d % num_heads:
        raise ValueError(f"x {tuple(x.shape)} does not fit n_q={n_q}, "
                         f"num_heads={num_heads}")
    _expect(wqkv, (3 * d, d), "wqkv")
    _expect(bqkv, (3 * d,), "bqkv")
    _expect(wo, (d, d), "wo")
    for name, t in (("bo", bo), ("ln_gamma", ln_gamma), ("ln_beta", ln_beta)):
        _expect(t, (d,), name)
    args = (x, wqkv, bqkv, wo, bo, ln_gamma, ln_beta)
    if not _on_card(x, "fused_self_attention_block",
                    {"x": x, "wqkv": wqkv, "wo": wo},
                    {"bqkv": bqkv, "bo": bo, "ln_gamma": ln_gamma,
                     "ln_beta": ln_beta}):
        return fused_self_attention_block_plain(
            *args, num_heads=num_heads, n_q=n_q, ln_eps=ln_eps)
    rows = b * k
    out = torch.empty_like(x)
    qkv = torch.empty(rows, 3 * d, device=x.device, dtype=x.dtype)
    ctx = torch.empty(rows, d, device=x.device, dtype=x.dtype)
    acc = _acc(rows, d, d, x)
    err = _entry("unirec_qformer_self_block", x)(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), ln_gamma.data_ptr(), ln_beta.data_ptr(), out.data_ptr(),
        qkv.data_ptr(), ctx.data_ptr(), _ptr(acc), b, k, d, num_heads,
        _scale(d // num_heads, x.dtype), ln_eps, _stream(x))
    check(err, "fused_self_attention_block")
    fused_self_attention_block.launches += 1
    return out


def fused_cross_attention_block(x, mem, key_bias, wq, bq, wkv, bkv, wo, bo,
                                ln_gamma, ln_beta, *, num_heads: int, n_q: int,
                                n_kv: int,
                                ln_eps: float = 1e-12) -> torch.Tensor:
    """B2: LayerNorm(x + Wo . CrossAttn(x -> mem) + bo).  x ``[B, n_q, D]``,
    mem ``[B, n_kv, Dm]``, key_bias ``[B, n_kv]`` float32 (0 valid, NEG_INF
    missing); wq ``[D, D]``, wkv ``[2D, Dm]``."""
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
    _expect(bkv, (2 * d,), "bkv")
    _expect(wo, (d, d), "wo")
    for name, t in (("bq", bq), ("bo", bo), ("ln_gamma", ln_gamma),
                    ("ln_beta", ln_beta)):
        _expect(t, (d,), name)
    args = (x, mem, key_bias, wq, bq, wkv, bkv, wo, bo, ln_gamma, ln_beta)
    if not _on_card(x, "fused_cross_attention_block",
                    {"x": x, "mem": mem, "wq": wq, "wkv": wkv, "wo": wo},
                    {"key_bias": key_bias, "bq": bq, "bkv": bkv, "bo": bo,
                     "ln_gamma": ln_gamma, "ln_beta": ln_beta}):
        return fused_cross_attention_block_plain(
            *args, num_heads=num_heads, n_q=n_q, n_kv=n_kv, ln_eps=ln_eps)
    rows = b * k
    out = torch.empty_like(x)
    q = torch.empty(rows, d, device=x.device, dtype=x.dtype)
    kv = torch.empty(b * n_kv, 2 * d, device=x.device, dtype=x.dtype)
    ctx = torch.empty(rows, d, device=x.device, dtype=x.dtype)
    acc = _acc(rows, d, d, x)
    err = _entry("unirec_qformer_cross_block", x)(
        x.data_ptr(), mem.data_ptr(), key_bias.data_ptr(), wq.data_ptr(),
        bq.data_ptr(), wkv.data_ptr(), bkv.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), ln_gamma.data_ptr(), ln_beta.data_ptr(), out.data_ptr(),
        q.data_ptr(), kv.data_ptr(), ctx.data_ptr(), _ptr(acc), b, k,
        n_kv, d, dm, num_heads, _scale(d // num_heads, x.dtype), ln_eps,
        _stream(x))
    check(err, "fused_cross_attention_block")
    fused_cross_attention_block.launches += 1
    return out


def fused_ffn_block(x, w1, b1, w2, b2, ln_gamma, ln_beta, *,
                    ln_eps: float = 1e-12) -> torch.Tensor:
    """B3: LayerNorm(x + W2 . gelu(W1 . x + b1) + b2), row-wise.
    x ``[B, K, D]``; w1 ``[I, D]``, w2 ``[D, I]``."""
    b, k, d = x.shape
    inter = w1.shape[0]
    _expect(w1, (inter, d), "w1")
    _expect(b1, (inter,), "b1")
    _expect(w2, (d, inter), "w2")
    for name, t in (("b2", b2), ("ln_gamma", ln_gamma), ("ln_beta", ln_beta)):
        _expect(t, (d,), name)
    args = (x, w1, b1, w2, b2, ln_gamma, ln_beta)
    if not _on_card(x, "fused_ffn_block", {"x": x, "w1": w1, "w2": w2},
                    {"b1": b1, "b2": b2, "ln_gamma": ln_gamma,
                     "ln_beta": ln_beta}):
        return fused_ffn_block_plain(*args, ln_eps=ln_eps)
    rows = b * k
    out = torch.empty_like(x)
    h = torch.empty(rows, inter, device=x.device, dtype=x.dtype)
    acc = _acc(rows, d, inter, x)
    err = _entry("unirec_qformer_ffn_block", x)(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), ln_gamma.data_ptr(), ln_beta.data_ptr(), out.data_ptr(),
        h.data_ptr(), _ptr(acc), rows, d, inter, ln_eps, _stream(x))
    check(err, "fused_ffn_block")
    fused_ffn_block.launches += 1
    return out


fused_self_attention_block.launches = 0
fused_cross_attention_block.launches = 0
fused_ffn_block.launches = 0
