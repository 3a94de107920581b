"""Int8 catalog quantization and retrieval over it (port of
``unirec_tpu/ops/quantization.py``; kernel B11).

The serving catalog can be held as int8 rows with one float32 scale each
(``quantize_rows``): a quarter of the bytes that retrieval, bound by reading
the catalog, has to stream.  A row scores ``(u . float(q_n)) * s_n`` with the
user ``u`` L2-normalised in float32.

B11 (``csrc/retrieve_topk.cu``, ``unirec_retrieve_topk_int8``) replaces
``unirec_tpu/ops/quantization.py::retrieve_top_k_int8``
(``_q_retrieval_kernel`` :78, called at :166): K2's design over int8 codes
(``ops/ranking.py`` and the source note), one pass over the 20.5 MB of codes
at 20,000 x 1,024, the users' norms and the row scales applied in the
epilogue, the codes turned into floats by a byte permute.  At 8 users it is
bound by the codes' bytes, at 64 by its fp32 FMAs.  Both
``quantized_top_k`` and the kernel return scores ``[B, k]`` float32 in
descending order and catalog ids ``[B, k]`` int64; equal scores go to the
lower catalog index.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.fused_qformer_int8 import true_div
from unirec_tpu_torch.ops.losses import l2_normalize
from unirec_tpu_torch.ops.ranking import (
    MAX_KERNEL_K,
    kernel_inputs,
    kernel_outputs,
    retrieval_plan,
    sm_count,
)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of the L2-normalised rows:
    ``scale = max(absmax, 1e-12) / 127``, ``q = clip(round(x / scale),
    -127, 127)``.  Returns (int8 ``[N, D]``, float32 ``[N]``)."""
    x = l2_normalize(x.float())
    scale = true_div(x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12),
                     127.0)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), scale[..., 0].contiguous()


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales[..., None]


def quantized_scores(user_emb: torch.Tensor, catalog_q: torch.Tensor,
                     catalog_scales: torch.Tensor) -> torch.Tensor:
    """[B, N] cosine scores against an int8 catalog."""
    u = l2_normalize(user_emb.float())
    return (u @ catalog_q.float().T) * catalog_scales.float()[None, :]


def quantized_top_k(user_emb: torch.Tensor, catalog_q: torch.Tensor,
                    catalog_scales: torch.Tensor,
                    k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain retrieval over an int8 catalog: all scores, then the top k by a
    stable descending sort (ties -> lower index)."""
    scores = quantized_scores(user_emb, catalog_q, catalog_scales)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def int8_kernel_inputs(user_emb: torch.Tensor, catalog_q: torch.Tensor,
                       catalog_scales: torch.Tensor, k: int):
    """B11's checks and layout: ``kernel_inputs`` over int8 codes, with
    float32 scales ``[N]``.  Any width D >= 1."""
    if catalog_q.dtype != torch.int8 or catalog_scales.dtype != torch.float32:
        raise TypeError(f"B11 takes int8 codes and float32 scales, got "
                        f"{catalog_q.dtype} and {catalog_scales.dtype}")
    u, c = kernel_inputs(user_emb, catalog_q, k)
    s = catalog_scales.contiguous()
    if tuple(s.shape) != (c.shape[0],):
        raise ValueError(f"bad shapes catalog {tuple(c.shape)} scales "
                         f"{tuple(s.shape)}")
    return u, c, s


def retrieve_top_k_int8(user_emb: torch.Tensor, catalog_q: torch.Tensor,
                        catalog_scales: torch.Tensor,
                        k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k catalog items per user over an int8 catalog: B11 for CUDA
    tensors, ``quantized_top_k`` for CPU tensors.  The kernel normalises
    the users in its epilogue: nothing else is launched.

    ``k > 32`` takes ``quantized_top_k`` on every device, the JAX package's
    rule.  On a CUDA tensor with k <= 32 it launches the kernel or raises.
    """
    if user_emb.device.type == "cpu" or k > MAX_KERNEL_K:
        return quantized_top_k(user_emb, catalog_q, catalog_scales, k)
    dev = user_emb.device
    if (dev.type != "cuda" or catalog_q.device != dev
            or catalog_scales.device != dev):
        raise ValueError("users and catalog must be on one CUDA device")
    return launch_b11(user_emb, catalog_q, catalog_scales, k)


def launch_b11(user_emb: torch.Tensor, catalog_q: torch.Tensor,
               catalog_scales: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B11's launches (the share pass and the merge) on checked inputs; the
    device test is ``retrieve_top_k_int8``'s."""
    u, c, s = int8_kernel_inputs(user_emb, catalog_q, catalog_scales, k)
    (b, d), n = u.shape, c.shape[0]
    plan = retrieval_plan(b, n, d, 1, sm_count(u.device))
    part, out_s, out_i = kernel_outputs(plan, k, u.device)
    err = load_kernels().lib.unirec_retrieve_topk_int8(
        u.data_ptr(), c.data_ptr(), s.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, n, d, k,
        plan.users_per_group, plan.shares, plan.rows_per_share,
        plan.tile_rows, torch.cuda.current_stream(u.device).cuda_stream)
    check(err, "retrieve_topk_int8")
    retrieve_top_k_int8.launches += 1
    return out_s, out_i


retrieve_top_k_int8.launches = 0
