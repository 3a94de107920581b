"""Losses and normalisation (port of ``unirec_tpu/ops/losses.py``).

The same semantics as the JAX functions: masked reconstruction MSE and the
triplet margin of the item trainer, InfoNCE over masked negatives for the
joint trainer, plain MSE for the user trainer.  The JAX functions' dp
``axis_name`` is not taken: data parallelism is ROADMAP.md A9.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)`` semantics: divide by the norm clamped at eps."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
    return x / norm


def normalize_promoted(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each tensor L2-normalised in its own dtype, then all cast to their
    promoted dtype (JAX promotes a bf16 user embedding against float32
    candidates inside the products; torch's matmuls want one dtype)."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return tuple(l2_normalize(x).to(dtype) for x in xs)


def masked_reconstruction_mse(reconstructed: torch.Tensor,
                              target: torch.Tensor,
                              field_mask: torch.Tensor) -> torch.Tensor:
    """Squared error summed over valid fields' elements, divided by the
    number of valid fields (at least 1): [B, F, D], [B, F, D], [B, F]."""
    masked = (reconstructed - target) ** 2 * field_mask[..., None]
    return masked.sum() / field_mask.sum().clamp_min(1.0)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 0.5,
                        eps: float = 1e-6) -> torch.Tensor:
    """mean(relu(margin + d(a, p) - d(a, n))), euclidean d with eps inside
    the square root, as the JAX function."""
    d_pos = torch.sqrt(((anchor - positive) ** 2).sum(-1) + eps)
    d_neg = torch.sqrt(((anchor - negative) ** 2).sum(-1) + eps)
    return torch.clamp(d_pos - d_neg + margin, min=0.0).mean()


def item_qformer_loss(model_output: Dict[str, torch.Tensor],
                      field_embeddings: torch.Tensor,
                      field_mask: torch.Tensor, positive_rep: torch.Tensor,
                      negative_rep: torch.Tensor,
                      reconstruction_weight: float = 1.0,
                      contrastive_weight: float = 0.25, margin: float = 0.5
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, reconstruction, contrastive) of the item trainer."""
    recon = masked_reconstruction_mse(model_output["reconstructed_fields"],
                                      field_embeddings, field_mask)
    cont = triplet_margin_loss(model_output["item_representation"],
                               positive_rep, negative_rep, margin)
    return reconstruction_weight * recon + contrastive_weight * cont, recon, cont


def info_nce_loss(user_embeddings: torch.Tensor,
                  positive_embeddings: torch.Tensor,
                  negative_embeddings: torch.Tensor,
                  negative_mask: Optional[torch.Tensor] = None,
                  temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE over one positive and masked negatives: users [B, D],
    positives [B, D], negatives [B, N, D], mask [B, N].  One vectorised
    logsumexp; a masked negative's logit is -1e9, whose exp is 0."""
    u, p, n = normalize_promoted(user_embeddings, positive_embeddings,
                                 negative_embeddings)
    pos_sim = (u * p).sum(-1) / temperature                    # [B]
    neg_sim = torch.einsum("bd,bnd->bn", u, n) / temperature   # [B, N]
    if negative_mask is not None:
        neg_sim = torch.where(negative_mask.bool(), neg_sim,
                              torch.full_like(neg_sim, -1e9))
    all_sim = torch.cat([pos_sim[:, None], neg_sim], dim=1)    # [B, 1 + N]
    return (torch.logsumexp(all_sim, dim=1) - pos_sim).mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain mean squared error (the user trainer's objective)."""
    return ((pred - target) ** 2).mean()
