"""Int8 catalog quantization and retrieval over it (port of
``unirec_tpu/ops/quantization.py``; kernel B11).

The serving catalog can be held as int8 rows with one float32 scale each
(``quantize_rows``): a quarter of the bytes that retrieval, bound by reading
the catalog, has to stream.  A row scores ``(u . float(q_n)) * s_n`` with the
user ``u`` L2-normalised in float32.

B11 (``csrc/retrieve_topk.cu``, ``unirec_retrieve_topk_int8``) replaces
``retrieve_top_k_int8`` (``_q_retrieval_kernel``): K2's two-pass blocked
top-k reading int8 codes.  Both ``quantized_top_k`` and the kernel return
scores ``[B, k]`` float32 in descending order and catalog ids ``[B, k]``
int64; equal scores go to the lower catalog index.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.fused_qformer_int8 import true_div
from unirec_tpu_torch.ops.losses import l2_normalize
from unirec_tpu_torch.ops.ranking import MAX_KERNEL_K, _num_splits


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


def retrieve_top_k_int8(user_emb: torch.Tensor, catalog_q: torch.Tensor,
                        catalog_scales: torch.Tensor,
                        k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k catalog items per user over an int8 catalog: B11 for CUDA
    tensors, ``quantized_top_k`` for CPU tensors.

    ``k > 32`` takes ``quantized_top_k`` on every device, the JAX package's
    rule.  On a CUDA tensor with k <= 32 it launches the kernel or raises.
    """
    if user_emb.device.type == "cpu" or k > MAX_KERNEL_K:
        return quantized_top_k(user_emb, catalog_q, catalog_scales, k)
    dev = user_emb.device
    if (dev.type != "cuda" or catalog_q.device != dev
            or catalog_scales.device != dev):
        raise ValueError("users and catalog must be on one CUDA device")
    if catalog_q.dtype != torch.int8 or catalog_scales.dtype != torch.float32:
        raise TypeError(f"B11 takes int8 codes and float32 scales, got "
                        f"{catalog_q.dtype} and {catalog_scales.dtype}")
    u = l2_normalize(user_emb.float()).contiguous()
    c, s = catalog_q.contiguous(), catalog_scales.contiguous()
    if (u.dim() != 2 or c.dim() != 2 or u.shape[1] != c.shape[1]
            or tuple(s.shape) != (c.shape[0],)):
        raise ValueError(f"bad shapes users {tuple(u.shape)} catalog "
                         f"{tuple(c.shape)} scales {tuple(s.shape)}")
    b, d = u.shape
    n = c.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if d % 4:
        raise ValueError(f"B11 needs the embedding width % 4 == 0, got {d}")
    splits = _num_splits(
        b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_s = torch.empty(b, splits, k, device=dev, dtype=torch.float32)
    part_i = torch.empty(b, splits, k, device=dev, dtype=torch.int32)
    out_s = torch.empty(b, k, device=dev, dtype=torch.float32)
    out_i = torch.empty(b, k, device=dev, dtype=torch.int64)
    err = load_kernels().lib.unirec_retrieve_topk_int8(
        u.data_ptr(), c.data_ptr(), s.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, n, d, k,
        splits, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "retrieve_topk_int8")
    retrieve_top_k_int8.launches += 1
    return out_s, out_i


retrieve_top_k_int8.launches = 0
