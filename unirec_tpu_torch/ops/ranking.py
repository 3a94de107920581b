"""Candidate-pool ranking and full-catalog retrieval (port of
``unirec_tpu/ops/ranking.py``): ``rank_of_positive`` and ``ranking_metrics``
(the joint trainer's evaluation), the plain ``top_k_items`` and the blocked
running-top-k kernel K2.

K2 (``csrc/retrieve_topk.cu``) replaces ``unirec_tpu/ops/ranking.py::
retrieve_top_k`` (``_retrieval_kernel`` with ``merge_running_topk``).  It is
bound by reading the catalog (about 82 MB in fp32 at 20,000 x 1,024); its
source note says how the two-pass design spreads that read over the card.
The [B, N] score matrix never reaches device memory.

Both return scores ``[B, k]`` float32 in descending order and catalog ids
``[B, k]`` int64; equal scores go to the lower catalog index.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.losses import l2_normalize, normalize_promoted

MAX_KERNEL_K = 32  # the kernel keeps k <= 32 candidates per user on chip
_USERS_PER_BLOCK = 8


def rank_of_positive(user_emb: torch.Tensor, positive_emb: torch.Tensor,
                     negative_emb: torch.Tensor,
                     negative_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """1-based rank of the positive among [positive] + negatives by cosine
    similarity: 1 + the number of negatives scoring strictly higher (ties go
    to the positive; a masked negative scores -inf)."""
    u, p, n = normalize_promoted(user_emb, positive_emb, negative_emb)
    pos_sim = (u * p).sum(-1)                             # [B]
    neg_sim = torch.einsum("bd,bnd->bn", u, n)            # [B, N]
    if negative_mask is not None:
        neg_sim = torch.where(negative_mask.bool(), neg_sim,
                              torch.full_like(neg_sim, float("-inf")))
    return 1 + (neg_sim > pos_sim[:, None]).sum(-1)


def ranking_metrics(user_emb: torch.Tensor, positive_emb: torch.Tensor,
                    negative_emb: torch.Tensor,
                    negative_mask: Optional[torch.Tensor] = None,
                    ks: Tuple[int, ...] = (1, 5, 10)
                    ) -> Dict[str, torch.Tensor]:
    """MRR, Recall@K and NDCG@K for one relevant item per user: Recall@K is
    hit@K, NDCG@K is 1/log2(rank + 1) within K and 0 beyond."""
    ranks = rank_of_positive(user_emb, positive_emb, negative_emb,
                             negative_mask)
    out: Dict[str, torch.Tensor] = {"mrr": (1.0 / ranks).mean()}
    for k in ks:
        hit = ranks <= k
        out[f"recall@{k}"] = hit.float().mean()
        out[f"ndcg@{k}"] = torch.where(
            hit, 1.0 / torch.log2(ranks.float() + 1.0),
            torch.zeros((), device=ranks.device)).mean()
    return out


def top_k_items(user_emb: torch.Tensor, catalog_emb: torch.Tensor,
                k: int = 10,
                normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain retrieval: cosine scores for the whole catalog, then the top k
    by a stable descending sort (ties -> lower index)."""
    u = l2_normalize(user_emb.float()) if normalize else user_emb.float()
    c = l2_normalize(catalog_emb.float()) if normalize else catalog_emb.float()
    scores = u @ c.T
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _num_splits(b: int, n: int, sm_count: int) -> int:
    """Catalog splits for pass 1: about two blocks per SM over all user
    tiles, at least 128 catalog rows per block, at most 1024 splits."""
    tiles = -(-b // _USERS_PER_BLOCK)
    return max(1, min(-(-2 * sm_count // tiles), -(-n // 128), 1024))


def retrieve_top_k(user_emb: torch.Tensor, catalog_emb: torch.Tensor,
                   k: int = 10,
                   normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k catalog items per user: K2 for CUDA tensors, ``top_k_items``
    for CPU tensors.

    ``k > 32`` takes ``top_k_items`` on every device: that is the JAX
    package's own dispatch rule (its in-kernel selection is k unrolled
    rounds, the wrong tool beyond serving-size k).  On a CUDA tensor with
    k <= 32 it launches the kernel or raises.
    """
    if user_emb.device.type == "cpu" or k > MAX_KERNEL_K:
        return top_k_items(user_emb, catalog_emb, k, normalize)
    if user_emb.device.type != "cuda" or catalog_emb.device != user_emb.device:
        raise ValueError("users and catalog must be on one CUDA device")
    u = l2_normalize(user_emb.float()) if normalize else user_emb.float()
    c = l2_normalize(catalog_emb.float()) if normalize else catalog_emb.float()
    u, c = u.contiguous(), c.contiguous()
    if u.dim() != 2 or c.dim() != 2 or u.shape[1] != c.shape[1]:
        raise ValueError(f"bad shapes users {tuple(u.shape)} "
                         f"catalog {tuple(c.shape)}")
    b, d = u.shape
    n = c.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if d % 4:
        raise ValueError(f"K2 needs the embedding width % 4 == 0, got {d}")
    splits = _num_splits(
        b, n, torch.cuda.get_device_properties(u.device).multi_processor_count)
    part_s = torch.empty(b, splits, k, device=u.device, dtype=torch.float32)
    part_i = torch.empty(b, splits, k, device=u.device, dtype=torch.int32)
    out_s = torch.empty(b, k, device=u.device, dtype=torch.float32)
    out_i = torch.empty(b, k, device=u.device, dtype=torch.int64)
    err = load_kernels().lib.unirec_retrieve_topk(
        u.data_ptr(), c.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), b, n, d, k, splits,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    check(err, "retrieve_topk")
    retrieve_top_k.launches += 1
    return out_s, out_i


retrieve_top_k.launches = 0
