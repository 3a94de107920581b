"""Differentiable W8A8 linear for frozen int8 weights (port of
``unirec_tpu/ops/int8_ste.py``).

The forward is the int8 inference formula; the backward is the
straight-through estimator through the dequantized weight,

    dx = g . (wq * ws)    (wq int8 [N, K], ws [N]; computed in g's dtype)

with no gradient for the weights or the scales (they are frozen: LoRA adapts
around them).

Forward by device: for a CUDA tensor it is kernel B8 (``ops/int8_matmul``);
for a CPU tensor it is the XLA formula that the JAX package runs off the TPU,
which divides by the row scale (``x / rs``) and clips, where the kernel
multiplies by ``fl(127 / absmax)``.  The two forms can put a value that lies
on a rounding boundary one code apart; the JAX package splits the same way at
16384 rows on the TPU, the port by device.  The row scale is the one the
JAX function computes under ``jit``, as every JAX caller runs it: XLA
compiles ``absmax / 127.0`` to ``absmax * fl(1 / 127)``, which is one ulp
off the quotient in some rows (and then moves their codes and their
dequantized outputs).
"""

from __future__ import annotations

import torch

from unirec_tpu_torch.ops.fused_qformer_int8 import _int_mm
from unirec_tpu_torch.ops.int8_matmul import _RCP_127, int8_linear


def _xla_forward(x: torch.Tensor, wq: torch.Tensor,
                 ws: torch.Tensor) -> torch.Tensor:
    """``int8_ste._fwd_math`` off the TPU, as jitted: the divide form with
    clip, over the row scale ``absmax * fl(1 / 127)``."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    rs = absmax * _RCP_127
    xq = torch.round(x32 / rs).clamp(-127, 127).to(torch.int8)
    return ((_int_mm(xq, wq) * rs) * ws.float()).to(x.dtype)


def _forward(x: torch.Tensor, wq: torch.Tensor,
             ws: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return _xla_forward(x, wq, ws)
    lead = x.shape[:-1]
    y = int8_linear(x.reshape(-1, x.shape[-1]).contiguous(), wq, ws,
                    out_dtype=x.dtype)
    return y.reshape(*lead, wq.shape[0])


def ste_input_grad(g: torch.Tensor, wq: torch.Tensor,
                   ws: torch.Tensor) -> torch.Tensor:
    """dx = g . W_eff with W_eff = wq * ws per output row, in g's dtype."""
    w_eff = wq.to(g.dtype) * ws.to(g.dtype)[:, None]
    return torch.matmul(g, w_eff)


class _Int8LinearSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, ws):
        ctx.save_for_backward(wq, ws)
        return _forward(x, wq, ws)

    @staticmethod
    def backward(ctx, g):
        wq, ws = ctx.saved_tensors
        return ste_input_grad(g, wq, ws), None, None


def int8_linear_ste(x: torch.Tensor, wq: torch.Tensor,
                    ws: torch.Tensor) -> torch.Tensor:
    """``[..., K]`` -> ``[..., N]`` in x's dtype: dequant(quant(x) . wq^T),
    differentiable in x by the STE."""
    return _Int8LinearSTE.apply(x, wq, ws)
