"""The W8A8 linear of the int8 Qwen3 forward (kernel B8).

Port of ``unirec_tpu/ops/int8_matmul.py``.  The CUDA kernel is the Qwen3
W8A8 section of ``csrc/qformer_blocks.cu``: one row-quantization pass into an
int8 buffer, then the int8 TMA + ``wgmma`` GEMM of ``csrc/gemm_wide.cuh``
(the one int8 mainloop of B4-B6 and B8-B9b) with the bias-free dequantizing
epilogue ``EPQ_PLAIN``.  The integer sums are exact in any order and the
epilogue rounds where the plain version does, so the two give the same
bits.

    y = (float(round(x * fl(127 / absmax)) . wq^T) * rs) * ws

with ``absmax = max(max|x|, 1e-6)`` and ``rs = absmax * fl(1 / 127)`` per
row: the JAX kernel writes ``absmax / 127.0``, which XLA compiles, inside
the jitted kernel, to a multiply by the rounded reciprocal
(``kernel_row_quant``; B9a and B9b quantize the same way).  ``wq`` is int8 ``[N, K]``, the
torch ``[out, in]`` layout and the transpose of JAX's ``[K, N]``; ``ws`` is the
float32 ``[N]`` column scale (``models/qwen3.quantize_qwen3_weights``).

The JAX package engages its kernel only at 16384 rows or more: below that the
XLA int8 dot was faster on the TPU.  That was a property of XLA on the TPU,
not of the computation; on the card B8 takes every shape its tiles take
(``supports_int8_linear``), so batch-8 serving (4096 rows) runs it too.
``PERF.md`` holds its times against the plain version at 4096 and 16384 rows.

The wrapper launches the kernel for a CUDA tensor (bfloat16 in and out,
or float32 in and out: the fp32 form, whose rows are quantized from their
float32 values and whose output is the float32 dequantized product, for the
W8A8 training forward at float32 compute; anything else raises) and takes
the plain version for a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.fused_qformer_int8 import (
    KERNEL_INT8_MULTIPLE,
    _mm_q,
    true_div,
)
from unirec_tpu_torch.ops.fused_qformer_layer import _expect, _on_card, _stream

_RCP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def kernel_row_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., W]`` -> (int8 codes, float32 ``[..., 1]`` row scales) as the
    jitted JAX kernels compute them: ``absmax = max(max|x|, 1e-6)``, codes
    ``round(x * fl(127 / absmax))`` half to even (|code| <= 127), scale
    ``absmax * fl(1 / 127)``.  ``fused_qformer_int8.row_quant`` differs only
    in the scale, which it divides."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    q = torch.round(x32 * true_div(127.0, absmax)).to(torch.int8)
    return q, absmax * _RCP_127.to(absmax.device)


def supports_int8_linear(m: int, k: int, n: int) -> bool:
    """The shapes the wrappers launch: rows of whole 16-byte chunks of int8
    codes (K a multiple of 16: the GEMM's TMA kernel) and of bf16 outputs
    (N a multiple of 8: 16-byte stores; no projection of the models has
    another width), at any row count."""
    return m >= 1 and k % KERNEL_INT8_MULTIPLE == 0 and n % 8 == 0


def int8_linear_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B8's plain version (``_kernel``): the row codes of
    ``kernel_row_quant`` (the kernel's clip to +-127 is a no-op: |x *
    fl(127/absmax)| < 127.5), exact integer products, ``(float(acc) * rs) *
    ws``."""
    x_q, rs = kernel_row_quant(x)
    return _mm_q(x_q, rs, wq, ws).to(out_dtype)


def int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B8: x ``[M, K]`` -> ``[M, N]`` in ``out_dtype``.  On the card x and
    the output are both bfloat16 or both float32, wq int8 ``[N, K]``, ws
    float32 ``[N]``."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    n = wq.shape[0]
    _expect(wq, (n, k), "wq")
    _expect(ws, (n,), "ws")
    if not _on_card(x, "int8_linear", {"x": x}, {"ws": ws},
                    codes={"wq": wq},
                    dtypes=(torch.bfloat16, torch.float32)):
        return int8_linear_plain(x, wq, ws, out_dtype)
    if out_dtype != x.dtype:
        raise TypeError(f"int8_linear: the kernel writes x's dtype "
                        f"{x.dtype}, got out_dtype {out_dtype}")
    if x.dtype == torch.float32:
        out = _launch_int8_linear_f32(x, wq, ws)
    else:
        out = launch_int8_linear(x, wq, ws, "int8_linear")
    int8_linear.launches += 1
    return out


def _launch_int8_linear_f32(x: torch.Tensor, wq: torch.Tensor,
                            ws: torch.Tensor) -> torch.Tensor:
    """B8's fp32 form on checked float32 CUDA inputs."""
    m, k = x.shape
    n = wq.shape[0]
    if not supports_int8_linear(m, k, n):
        raise ValueError(f"int8_linear: [{m}, {k}] x [{k}, {n}] is not a "
                         "shape the kernel takes")
    out = torch.empty(m, n, device=x.device, dtype=torch.float32)
    xq = torch.empty(m, k, device=x.device, dtype=torch.int8)
    xs = torch.empty(m, device=x.device, dtype=torch.float32)
    err = load_kernels().lib.unirec_int8_linear_f32(
        x.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
        xq.data_ptr(), xs.data_ptr(), m, n, k, _stream(x))
    check(err, "int8_linear")
    return out


def launch_int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                       name: str) -> torch.Tensor:
    """The kernel's launch on checked bfloat16 CUDA inputs, counted by the
    caller: B8 here, B9a (``fused_qwen3_int8.qkv_int8``) over [Wq|Wk|Wv]."""
    m, k = x.shape
    n = wq.shape[0]
    if not supports_int8_linear(m, k, n):
        raise ValueError(f"{name}: [{m}, {k}] x [{k}, {n}] is not a shape the "
                         "kernel takes")
    out = torch.empty(m, n, device=x.device, dtype=torch.bfloat16)
    xq = torch.empty(m, k, device=x.device, dtype=torch.int8)
    xs = torch.empty(m, device=x.device, dtype=torch.float32)
    err = load_kernels().lib.unirec_int8_linear(
        x.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
        xq.data_ptr(), xs.data_ptr(), m, n, k, _stream(x))
    check(err, name)
    return out


int8_linear.launches = 0
