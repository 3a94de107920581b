"""Trainable flash cross-attention with the K/V projections inside its
gradient (port of ``unirec_tpu/ops/flash_vjp.py``'s
``flash_cross_attention_proj_vjp``): kernel B14, forward and backward.

The user Q-Former's 64 query tokens attend, at every layer, over the
flattened history memory (seq * K = 1,600 rows at seq 50).  The trainable
form keeps the ``[B, H, Lq, Lkv]`` probabilities out of device memory in both
directions, and its saved state is the SHARED memory tensor, not each layer's
projected k/v:

* forward: ``k3 = mem . Wk + bk`` and ``v3 = mem . Wv + bv`` by
  ``torch.matmul`` in q's dtype (JAX does them outside the Pallas call),
  then B14's forward kernel (``csrc/flash_cross.cu``, replacing
  ``_mh_fwd_kernel``) on the merged-head ``[B, L, D]`` tensors, which writes
  o in float32 and the per-(batch, row, head) max m and sum l, float32
  ``[B, Lq, H]``, kept apart (never a logsumexp: fp32 swallows log l at the
  -1e9 mask magnitude); the Function returns o in q's dtype;
* the Function saves ``(q, mem, wk, bk, wv, bv, bias, o, m, l)`` with the
  float32 o, never k3 or v3, and recomputes them in the backward;
* backward: ``dsum = rowsum(dO_h * O_h)`` per head in torch, from the
  float32 O where JAX takes its bf16 O: then ds sums to ~0 over a query's
  keys, as the softmax VJP's does, while a bf16 O shifts every ds of a row
  by one rounding of dsum, which reaches dq through the keys' common
  component and dk through the memory's; the first cross layer's query and
  key weight gradients, sums over users whose queries are all the same,
  nearly cancel and keep mostly that error; B14's backward kernels
  (replacing ``_mh_bwd_kernel``: a dq kernel, then a dk/dv kernel)
  for dq, dk3 and dv3, then dmem, dWk, dbk, dWv and dbv by float32
  ``torch.matmul`` and sums, as ``_proj_vjp_bwd`` computes them; the bias
  (a validity mask) gets no gradient.

Weights are the torch ``Linear`` layout ``[out, in]`` (the port's
parameters), so ``k3 = mem . Wk^T + bk``; their gradients come back in the
weights' dtype.  The wrappers ``flash_cross_fwd`` and ``flash_cross_bwd``
launch the kernels for CUDA tensors (float32 or bfloat16, head dim 64; they
raise on anything else) and take the plain versions beside them for CPU
tensors; each counts its launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.attention import (
    KERNEL_HEAD_DIM,
    check_kernel_tensors,
    dtype_code,
    key_bias,
    launch_flash_cross_fwd,
    sm_scale,
    streaming_softmax_stats,
)
from unirec_tpu_torch.ops.flash_causal import attention_dsum


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, D // H] (a view)."""
    b, l, d = t.shape
    return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _scores(q, k3, bias32, num_heads: int) -> torch.Tensor:
    """fp32 s = (q . k) * scale + bias per head, ``[B, H, Lq, Lkv]``."""
    hd = q.shape[-1] // num_heads
    s = torch.matmul(_heads(q, num_heads).float(),
                     _heads(k3, num_heads).float().transpose(-1, -2))
    s = s * sm_scale(hd)
    if bias32 is not None:
        s = s + bias32[:, None, None, :]
    return s


def flash_cross_fwd_plain(q, k3, v3, bias32, num_heads: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B14 forward's plain version: (o ``[B, Lq, D]``, m, l ``[B, Lq, H]``),
    all float32; bias32 float32 ``[B, Lkv]`` or None."""
    b, lq, d = q.shape
    p, m, l = streaming_softmax_stats(_scores(q, k3, bias32, num_heads))
    ctx = torch.matmul(p, _heads(v3, num_heads).float())
    o = ctx / torch.where(l == 0, 1.0, l)
    return (o.transpose(1, 2).reshape(b, lq, d),
            m[..., 0].transpose(1, 2).contiguous(),
            l[..., 0].transpose(1, 2).contiguous())


def flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l, dsum, num_heads: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B14 backward's plain version, ``_mh_bwd_kernel`` step by step in fp32
    from the saved m and l: (dq, dk3, dv3) in the inputs' dtypes."""
    b, lq, d = q.shape
    hd = d // num_heads
    s = _scores(q, k3, bias32, num_heads)
    m_h = m.transpose(1, 2)[..., None]
    l_h = l.transpose(1, 2)[..., None]
    p = torch.exp(s - m_h) / torch.where(l_h == 0, 1.0, l_h)
    doh = _heads(do, num_heads).float()
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, _heads(v3, num_heads).float().transpose(-1, -2))
    ds = p * (dp - dsum.transpose(1, 2)[..., None]) * sm_scale(hd)
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, num_heads).float())
    dq = torch.matmul(ds, _heads(k3, num_heads).float())

    def merged(g, like):
        return g.transpose(1, 2).reshape(like.shape).to(like.dtype)

    return merged(dq, q), merged(dk, k3), merged(dv, v3)


def _check_shapes(q, k3, v3, num_heads: int) -> None:
    b, lq, d = q.shape
    if num_heads <= 0 or d % num_heads:
        raise ValueError(f"width {d} does not split into {num_heads} heads")
    if k3.shape != (b, k3.shape[1], d) or v3.shape != k3.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k3 {tuple(k3.shape)} "
                         f"v3 {tuple(v3.shape)}")


def _kernel_inputs(name: str, num_heads: int, *tensors) -> None:
    check_kernel_tensors(name, *tensors)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: merged-head tensors must be contiguous")
    hd = tensors[0].shape[-1] // num_heads
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(f"{name} is built for head_dim {KERNEL_HEAD_DIM}, "
                         f"got {hd}")


def flash_cross_fwd(q, k3, v3, bias32, num_heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B14 forward: (o, m, l), all float32, from merged-head q ``[B, Lq,
    D]``, k3 / v3 ``[B, Lkv, D]`` and bias32 float32 ``[B, Lkv]`` or None."""
    _check_shapes(q, k3, v3, num_heads)
    if q.device.type == "cpu":
        return flash_cross_fwd_plain(q, k3, v3, bias32, num_heads)
    _kernel_inputs("B14 fwd", num_heads, q, k3, v3)
    b, lq, d = q.shape
    o = torch.empty_like(q, dtype=torch.float32)
    m = torch.empty(b, lq, num_heads, device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    launch_flash_cross_fwd(_heads(q, num_heads), _heads(k3, num_heads),
                           _heads(v3, num_heads), bias32, _heads(o, num_heads),
                           m, l)
    flash_cross_fwd.launches += 1
    return o, m, l


def flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, num_heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B14 backward: (dq, dk3, dv3) from the forward's inputs, dO and the
    saved m, l with dsum = rowsum(dO_h * O_h) (float32 ``[B, Lq, H]``)."""
    _check_shapes(q, k3, v3, num_heads)
    if q.device.type == "cpu":
        return flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l, dsum,
                                     num_heads)
    _kernel_inputs("B14 bwd", num_heads, q, k3, v3, do)
    b, lq, d = q.shape
    for name, t in (("m", m), ("l", l), ("dsum", dsum)):
        if (t.dtype != torch.float32 or t.shape != (b, lq, num_heads)
                or not t.is_contiguous()):
            raise ValueError(f"B14 bwd: {name} must be float32 [B, Lq, H], "
                             "contiguous")
    dq, dk3, dv3 = (torch.empty_like(t) for t in (q, k3, v3))
    err = load_kernels().lib.unirec_flash_cross_bwd(
        q.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        None if bias32 is None else bias32.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk3.data_ptr(), dv3.data_ptr(), b, num_heads, lq, k3.shape[1],
        d // num_heads, dtype_code(q),
        sm_scale(d // num_heads),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_cross_bwd")
    flash_cross_bwd.launches += 1
    return dq, dk3, dv3


flash_cross_fwd.launches = 0
flash_cross_bwd.launches = 0


def _project(mem, w, b, dt) -> torch.Tensor:
    """mem . W^T in mem's dtype, cast to dt, plus b in dt (the JAX VJP's
    ``jnp.dot(mem, wk.astype(mem.dtype)).astype(dt) + bk.astype(dt)``)."""
    return torch.matmul(mem, w.to(mem.dtype).t()).to(dt) + b.to(dt)


class _FlashCrossProj(torch.autograd.Function):
    """The JAX ``custom_vjp``: B14 forward, B14 backward plus the projection
    gradients; o is kept in float32 for dsum."""

    @staticmethod
    def forward(ctx, q, mem, wk, bk, wv, bv, bias32, num_heads):
        dt = q.dtype
        k3, v3 = _project(mem, wk, bk, dt), _project(mem, wv, bv, dt)
        o32, m, l = flash_cross_fwd(q, k3, v3, bias32, num_heads)
        ctx.save_for_backward(q, mem, wk, bk, wv, bv, bias32, o32, m, l)
        ctx.num_heads = num_heads
        return o32.to(dt)

    @staticmethod
    def backward(ctx, do):
        q, mem, wk, bk, wv, bv, bias32, o32, m, l = ctx.saved_tensors
        h = ctx.num_heads
        dt = q.dtype
        k3, v3 = _project(mem, wk, bk, dt), _project(mem, wv, bv, dt)
        do = do.to(dt).contiguous()
        dsum = attention_dsum(do, o32, h).contiguous()
        dq, dk3, dv3 = flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, h)
        del k3, v3
        f32 = torch.float32
        dk32, dv32 = dk3.to(f32), dv3.to(f32)
        dmem = (torch.matmul(dk32, wk.to(f32))
                + torch.matmul(dv32, wv.to(f32))).to(mem.dtype)
        mem2 = mem.reshape(-1, mem.shape[-1]).to(f32)
        dwk = torch.matmul(dk32.reshape(-1, dk32.shape[-1]).t(), mem2)
        dwv = torch.matmul(dv32.reshape(-1, dv32.shape[-1]).t(), mem2)
        dbk, dbv = dk32.sum(dim=(0, 1)), dv32.sum(dim=(0, 1))
        return (dq, dmem, dwk.to(wk.dtype), dbk.to(bk.dtype), dwv.to(wv.dtype),
                dbv.to(bv.dtype), None, None)


def flash_cross_attention_proj_vjp(q: torch.Tensor, mem: torch.Tensor,
                                   wk: torch.Tensor, bk: torch.Tensor,
                                   wv: torch.Tensor, bv: torch.Tensor,
                                   bias: Optional[torch.Tensor] = None,
                                   num_heads: int = 1) -> torch.Tensor:
    """Differentiable flash cross-attention with the K/V projections inside.
    q ``[B, Lq, D]`` merged heads, mem ``[B, Lkv, D_enc]`` the shared memory
    (in q's dtype), wk / wv ``[D, D_enc]``, bk / bv ``[D]``, bias ``[B, 1, 1,
    Lkv]`` or None (no gradient).  Returns ``[B, Lq, D]`` in q's dtype; the
    gradients flow to q, mem and the four projection parameters."""
    b, lq, d = q.shape
    bias32 = key_bias(bias, b, mem.shape[1], q.device)
    return _FlashCrossProj.apply(q.contiguous(), mem.contiguous(), wk, bk, wv,
                                 bv, bias32, num_heads)
