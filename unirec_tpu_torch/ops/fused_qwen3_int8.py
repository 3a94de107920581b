"""The fused int8 Qwen3 blocks of the serving forward (kernels B9a, B9b).

Port of ``unirec_tpu/ops/fused_qwen3_int8.py``.  The CUDA kernels are the
Qwen3 W8A8 section of ``csrc/qformer_blocks.cu``, every product on the int8
TMA + ``wgmma`` GEMM of ``csrc/gemm_wide.cuh``, the one int8 mainloop that
B4-B6 and B8 share; its source note says what the design writes to HBM that
the TPU kernel kept on chip.

    B9a  qkv_int8         one row quantization of the normed hidden rows,
                          one int8 GEMM against the concatenated Wq | Wk | Wv
                          (B8's kernel: the same bits as the plain version)
    B9b  swiglu_mlp_int8  gate|up GEMM whose epilogue pairs each gate column
                          with its up column and writes h = (g * sigmoid(g))
                          * u in fp32 with each row's max |h|; one pass that
                          reads h once and writes its codes (one row scale
                          over the whole intermediate); the down GEMM,
                          dequantized to bf16

Both take the already-normed hidden rows ``[rows, D]`` and weights in the
torch ``[out, in]`` layout, int8 with float32 per-output scales: ``wqkv
[Nq + 2 Nkv, D]`` (rows Wq | Wk | Wv), ``wgu [2I, D]`` (gate rows, then up
rows), ``wdown [D, I]``.  ``int8_linear_fused_ste`` is the trainable form of
B9a: its forward is B9a, its backward the straight-through estimator of
``ops/int8_ste``.

The models dispatch here under ``supports_fused_qwen3``, the JAX guard kept
exactly (``rows % 512 == 0`` and lane-aligned widths): it decides which
numbers the model computes, because the fused blocks quantize in the
multiply form ``x * fl(127/absmax)`` and the per-projection path on the CPU
in the divide form.  Each wrapper launches its kernel for a CUDA tensor
(bfloat16 activations, int8 weights; anything else raises) and takes the
plain version for a CPU tensor.
"""

from __future__ import annotations

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.fused_qformer_int8 import _mm_q
from unirec_tpu_torch.ops.fused_qformer_layer import _expect, _on_card, _stream
from unirec_tpu_torch.ops.int8_matmul import (
    int8_linear_plain,
    kernel_row_quant,
    launch_int8_linear,
    supports_int8_linear,
)
from unirec_tpu_torch.ops.int8_ste import ste_input_grad

_TILE_ROWS = 512


def supports_fused_qwen3(rows: int, d: int, inter: int = 0) -> bool:
    """The JAX guard: row tiles divide evenly, widths lane-aligned."""
    return (rows % _TILE_ROWS == 0 and d % 128 == 0
            and (inter == 0 or inter % 128 == 0))


def _check_rows(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or x.shape[0] % _TILE_ROWS:
        raise ValueError(f"{name}: x must be [rows, D] with rows a multiple "
                         f"of {_TILE_ROWS}, got {tuple(x.shape)}")


# -- plain versions -----------------------------------------------------------


def qkv_int8_plain(x, wqkv_q, sqkv) -> torch.Tensor:
    """B9a's plain version (``_qkv_kernel``): B8's over [Wq|Wk|Wv]."""
    return int8_linear_plain(x, wqkv_q, sqkv, x.dtype)


def swiglu_mlp_int8_plain(x, wgu_q, sgu, wdown_q, sdown) -> torch.Tensor:
    """B9b's plain version (``_mlp_kernel``)."""
    inter = wdown_q.shape[1]
    x_q, rs = kernel_row_quant(x)
    gu = _mm_q(x_q, rs, wgu_q, sgu)
    g, u = gu[:, :inter], gu[:, inter:]
    h = (g * torch.sigmoid(g)) * u
    h_q, hrs = kernel_row_quant(h)
    return _mm_q(h_q, hrs, wdown_q, sdown).to(x.dtype)


# -- wrappers -------------------------------------------------------------------


def qkv_int8(x, wqkv_q, sqkv) -> torch.Tensor:
    """B9a: x ``[rows, D]`` -> ``[rows, N]`` in x's dtype; wqkv_q int8
    ``[N, D]``, sqkv float32 ``[N]``."""
    _check_rows(x, "qkv_int8")
    d = x.shape[1]
    n = wqkv_q.shape[0]
    _expect(wqkv_q, (n, d), "wqkv_q")
    _expect(sqkv, (n,), "sqkv")
    if not _on_card(x, "qkv_int8", {"x": x}, {"sqkv": sqkv},
                    codes={"wqkv_q": wqkv_q}, dtypes=(torch.bfloat16,)):
        return qkv_int8_plain(x, wqkv_q, sqkv)
    out = launch_int8_linear(x, wqkv_q, sqkv, "qkv_int8")
    qkv_int8.launches += 1
    return out


def swiglu_mlp_int8(x, wgu_q, sgu, wdown_q, sdown) -> torch.Tensor:
    """B9b: x ``[rows, D]`` -> ``[rows, D]`` (no residual); wgu_q int8
    ``[2I, D]`` with sgu ``[2I]``, wdown_q int8 ``[D, I]`` with sdown
    ``[D]``."""
    _check_rows(x, "swiglu_mlp_int8")
    rows, d = x.shape
    inter = wdown_q.shape[1]
    _expect(wgu_q, (2 * inter, d), "wgu_q")
    _expect(sgu, (2 * inter,), "sgu")
    _expect(wdown_q, (d, inter), "wdown_q")
    _expect(sdown, (d,), "sdown")
    if not _on_card(x, "swiglu_mlp_int8", {"x": x},
                    {"sgu": sgu, "sdown": sdown},
                    codes={"wgu_q": wgu_q, "wdown_q": wdown_q},
                    dtypes=(torch.bfloat16,)):
        return swiglu_mlp_int8_plain(x, wgu_q, sgu, wdown_q, sdown)
    if not (supports_int8_linear(rows, d, 2 * inter)
            and supports_int8_linear(rows, inter, d)):
        raise ValueError(f"swiglu_mlp_int8: D {d} / I {inter} is not a shape "
                         "the kernel takes")
    dev = x.device
    out = torch.empty_like(x)
    xq = torch.empty(rows, d, device=dev, dtype=torch.int8)
    xs = torch.empty(rows, device=dev, dtype=torch.float32)
    h = torch.empty(rows, inter, device=dev, dtype=torch.float32)
    hq = torch.empty(rows, inter, device=dev, dtype=torch.int8)
    hs = torch.empty(rows, device=dev, dtype=torch.float32)
    err = load_kernels().lib.unirec_qwen3_swiglu_q(
        x.data_ptr(), wgu_q.data_ptr(), sgu.data_ptr(), wdown_q.data_ptr(),
        sdown.data_ptr(), out.data_ptr(), xq.data_ptr(), xs.data_ptr(),
        h.data_ptr(), hq.data_ptr(), hs.data_ptr(), rows, d, inter, _stream(x))
    check(err, "swiglu_mlp_int8")
    swiglu_mlp_int8.launches += 1
    return out


qkv_int8.launches = 0
swiglu_mlp_int8.launches = 0


class _Int8LinearFusedSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, s):
        ctx.save_for_backward(wq, s)
        return qkv_int8(x, wq, s)

    @staticmethod
    def backward(ctx, g):
        wq, s = ctx.saved_tensors
        return ste_input_grad(g, wq, s), None, None


def int8_linear_fused_ste(x: torch.Tensor, wq: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """The trainable wide int8 linear: forward B9a (one row quantization for
    the concatenated projections), backward ``dx = g . (wq * s)``; no
    gradient for the frozen weights.  x must pass ``supports_fused_qwen3``."""
    return _Int8LinearFusedSTE.apply(x, wq, s)
