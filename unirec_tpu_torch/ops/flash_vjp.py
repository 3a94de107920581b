"""Trainable flash cross-attention (port of ``unirec_tpu/ops/flash_vjp.py``):
kernel B14, ``flash_cross_attention_proj_vjp`` with the K/V projections
inside its gradient, and kernel B14p, ``flash_cross_attention_vjp`` over
per-head tensors, forward and backward each.

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
  nearly cancel and keep mostly that error; B14's backward (replacing
  ``_mh_bwd_kernel``; one pass over the keys on tensor cores, in float32
  every product in 3xTF32) for dq, dk3 and dv3, then dmem,
  dWk, dbk, dWv and dbv by float32 ``torch.matmul`` and sums, as
  ``_proj_vjp_bwd`` computes them; the bias (a validity mask) gets no
  gradient.

B14p is the same pair of kernels on ``[B, H, L, hd]`` tensors (replacing
``_fwd_kernel`` and ``_bwd_kernel``; the TPU needed a second pair only for
its lane layout): ``_FlashCross`` saves (q, k, v, bias, o, m, l) with o in
float32, takes dsum from it, and returns (dq, dk, dv) and no bias gradient.
Only the JAX package's tests call it; here its tests and ``chip_smoke.py``.

Weights are the torch ``Linear`` layout ``[out, in]`` (the port's
parameters), so ``k3 = mem . Wk^T + bk``; their gradients come back in the
weights' dtype.  The wrappers ``flash_cross_fwd`` / ``flash_cross_bwd``
(B14) and ``flash_cross_vjp_fwd`` / ``flash_cross_vjp_bwd`` (B14p) launch
the kernels for CUDA tensors (float32 or bfloat16, any head dimension: the
kernels are built for the multiples of 16 up to 128 and for 256, and
``ops/attention.padded_launch`` zero-pads any other to the next, or above
256 to whole chunks of 256 for the chunked form, with the softmax scale of
the true one) and take
the plain versions beside them for CPU tensors; each counts its launches.
B14's plain versions are B14p's on per-head views of the merged tensors.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.attention import (
    CHUNKED_ROWS,
    check_head_dim,
    chunked_form,
    chunked_plan,
    count_form,
    check_kernel_tensors,
    dtype_code,
    key_bias,
    launch_flash_cross_fwd,
    merge_heads,
    padded_launch,
    scratch_width,
    sm_scale,
    streaming_softmax_stats,
)
from unirec_tpu_torch.ops.flash_causal import attention_dsum


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, D // H] (a view)."""
    b, l, d = t.shape
    return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _scores(q, k, bias32) -> torch.Tensor:
    """fp32 s = (q . k) * scale + bias per head, ``[B, H, Lq, Lkv]``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * sm_scale(q.shape[-1])
    if bias32 is not None:
        s = s + bias32[:, None, None, :]
    return s


def _rows(t: torch.Tensor) -> torch.Tensor:
    """[B, H, Lq, 1] -> [B, Lq, H], contiguous (the kernels' m, l, dsum)."""
    return t[..., 0].transpose(1, 2).contiguous()


def flash_cross_vjp_fwd_plain(q, k, v, bias32
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """B14p forward's plain version on per-head q ``[B, H, Lq, hd]``, k / v
    ``[B, H, Lkv, hd]``: (o ``[B, H, Lq, hd]``, m, l ``[B, Lq, H]``), all
    float32; bias32 float32 ``[B, Lkv]`` or None."""
    p, m, l = streaming_softmax_stats(_scores(q, k, bias32))
    o = torch.matmul(p, v.float()) / torch.where(l == 0, 1.0, l)
    return o, _rows(m), _rows(l)


def flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """B14p backward's plain version, ``_bwd_kernel`` step by step in fp32
    from the saved m and l and dsum (``[B, Lq, H]``): (dq, dk, dv) in the
    inputs' dtypes."""
    s = _scores(q, k, bias32)
    m_h = m.transpose(1, 2)[..., None]
    l_h = l.transpose(1, 2)[..., None]
    p = torch.exp(s - m_h) / torch.where(l_h == 0, 1.0, l_h)
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - dsum.transpose(1, 2)[..., None]) * sm_scale(q.shape[-1])
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_cross_fwd_plain(q, k3, v3, bias32, num_heads: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B14 forward's plain version: (o ``[B, Lq, D]``, m, l ``[B, Lq, H]``),
    all float32; bias32 float32 ``[B, Lkv]`` or None."""
    o, m, l = flash_cross_vjp_fwd_plain(
        *(_heads(t, num_heads) for t in (q, k3, v3)), bias32)
    return merge_heads(o), m, l


def flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l, dsum, num_heads: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B14 backward's plain version, ``_mh_bwd_kernel`` step by step in fp32
    from the saved m and l: (dq, dk3, dv3) in the inputs' dtypes."""
    q_h, k_h, v_h, do_h = (_heads(t, num_heads) for t in (q, k3, v3, do))
    grads = flash_cross_vjp_bwd_plain(q_h, k_h, v_h, bias32, do_h, m, l, dsum)
    return tuple(merge_heads(g) for g in grads)


# query rows of the backward's tile: with more, each q tile's block writes
# float32 partial dk / dv, which a second kernel sums in order
BWD_Q_TILE = 64


def launch_flash_cross_bwd(q, k, v, bias32, do, m, l, dsum, dq, dk, dv
                           ) -> None:
    """The backward of ``csrc/flash_cross.cu`` on per-head views ``[B, H,
    L, hd]`` of any (batch, head, row) strides: B14's merged layout or
    B14p's per-head one.  Both dtypes run one pass over the keys (with
    float32 scratch for the partial dk / dv of each 64-row q tile when Lq is
    longer; float32 in 3xTF32 on tensor cores), above 256 float32's cluster
    form with the key splits and dq scratch of ``chunked_plan``.  A head dim
    that is not an instance runs zero-padded (``padded_launch``); the
    launches count by form in ``launch_flash_cross_bwd.forms``
    (``chunked_form``)."""
    b, h, lq, hd = q.shape
    lkv = k.shape[2]

    def launch(ins, outs, kernel_hd):
        n_qt = -(-lq // BWD_Q_TILE)
        scratch = None
        if n_qt > 1:
            scratch = torch.empty(
                n_qt * 2 * b * h * lkv * scratch_width(kernel_hd),
                device=q.device, dtype=torch.float32)
        splits, dqpart = chunked_plan(
            q, CHUNKED_ROWS, b, h, lq, lkv, kernel_hd,
            chunked_form(CHUNKED_ROWS, kernel_hd, q))
        strides = [s for t in (*ins, *outs) for s in t.stride()[:3]]
        qk, kk, vk, dok = ins
        err = load_kernels().lib.unirec_flash_cross_bwd(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(),
            None if bias32 is None else bias32.data_ptr(), dok.data_ptr(),
            m.data_ptr(), l.data_ptr(), dsum.data_ptr(),
            *(t.data_ptr() for t in outs),
            None if scratch is None else scratch.data_ptr(),
            None if dqpart is None else dqpart.data_ptr(),
            (ctypes.c_longlong * 21)(*strides), b, h, lq, lkv, kernel_hd,
            dtype_code(q), splits, sm_scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
        check(err, "flash_cross_bwd")
        count_form(launch_flash_cross_bwd, CHUNKED_ROWS, kernel_hd, q)

    padded_launch("the streaming backward", hd,
                  [(q, None), (k, None), (v, None), (do, None)],
                  [(dq, None), (dk, None), (dv, None)], launch)


launch_flash_cross_bwd.forms = collections.Counter()


def _check_stats(name: str, b: int, lq: int, h: int, *stats) -> None:
    for t in stats:
        if (t.dtype != torch.float32 or t.shape != (b, lq, h)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: m, l and dsum must be float32 "
                             "[B, Lq, H], contiguous")


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
    check_head_dim(name, tensors[0].shape[-1] // num_heads)


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
    _check_stats("B14 bwd", q.shape[0], q.shape[1], num_heads, m, l, dsum)
    dq, dk3, dv3 = (torch.empty_like(t) for t in (q, k3, v3))
    launch_flash_cross_bwd(*(_heads(t, num_heads)
                             for t in (q, k3, v3)), bias32,
                           _heads(do, num_heads), m, l, dsum,
                           *(_heads(t, num_heads) for t in (dq, dk3, dv3)))
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


# -- B14p: trainable flash cross-attention over per-head tensors ------------


def _check_head_shapes(q, k, v) -> None:
    b, h, lq, hd = q.shape
    if k.dim() != 4 or k.shape[:2] != (b, h) or k.shape[3] != hd \
            or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")


def flash_cross_vjp_fwd(q, k, v, bias32
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B14p forward: (o ``[B, H, Lq, hd]``, m, l ``[B, Lq, H]``), all
    float32, from per-head q ``[B, H, Lq, hd]``, k / v ``[B, H, Lkv, hd]``
    (any strides with a contiguous head dimension) and bias32 float32
    ``[B, Lkv]`` or None."""
    _check_head_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_cross_vjp_fwd_plain(q, k, v, bias32)
    check_kernel_tensors("B14p fwd", q, k, v)
    b, h, lq, hd = q.shape
    o = torch.empty(b, h, lq, hd, device=q.device, dtype=torch.float32)
    m = torch.empty(b, lq, h, device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    launch_flash_cross_fwd(q, k, v, bias32, o, m, l)
    flash_cross_vjp_fwd.launches += 1
    return o, m, l


def flash_cross_vjp_bwd(q, k, v, bias32, do, m, l, dsum
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B14p backward: (dq, dk, dv) in the inputs' dtype and layout from the
    forward's inputs, dO ``[B, H, Lq, hd]`` and the saved m, l with dsum =
    rowsum(dO * O) (float32 ``[B, Lq, H]``)."""
    _check_head_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum)
    check_kernel_tensors("B14p bwd", q, k, v, do)
    if do.shape != q.shape:
        raise ValueError(f"B14p bwd: dO {tuple(do.shape)} is not q's shape")
    b, h, lq, _ = q.shape
    _check_stats("B14p bwd", b, lq, h, m, l, dsum)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch_flash_cross_bwd(q, k, v, bias32, do, m, l, dsum, dq, dk, dv)
    flash_cross_vjp_bwd.launches += 1
    return dq, dk, dv


flash_cross_vjp_fwd.launches = 0
flash_cross_vjp_bwd.launches = 0


class _FlashCross(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``flash_cross_attention_vjp``: B14p forward
    (o kept in float32 for dsum), B14p backward; the bias gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias32):
        o32, m, l = flash_cross_vjp_fwd(q, k, v, bias32)
        ctx.save_for_backward(q, k, v, bias32, o32, m, l)
        return o32.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias32, o32, m, l = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dsum = _rows((do.float() * o32).sum(-1, keepdim=True))
        dq, dk, dv = flash_cross_vjp_bwd(q, k, v, bias32, do, m, l, dsum)
        return dq, dk, dv, None


def flash_cross_attention_vjp(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Differentiable streaming cross-attention (B14p).  q ``[B, H, Lq,
    hd]``, k / v ``[B, H, Lkv, hd]`` of one dtype (float32 or bfloat16 on
    the card), bias an additive per-key ``[B, 1, 1, Lkv]`` or None (no
    gradient).  Returns ``[B, H, Lq, hd]`` in q's dtype; the gradients flow
    to q, k and v.  CPU tensors take the plain versions."""
    _check_head_shapes(q, k, v)
    bias32 = key_bias(bias, q.shape[0], k.shape[2], q.device)
    return _FlashCross.apply(q, k, v, bias32)
