"""Losses and normalisation (port of ``unirec_tpu/ops/losses.py``).

The same semantics as the JAX functions: masked reconstruction MSE and the
triplet margin of the item trainer, InfoNCE over masked negatives for the
joint trainer, plain MSE for the user trainer.  The JAX functions' dp
``axis_name`` is the ``group`` argument here: the dp process group whose
shards' losses the gradient all-reduce averages
(``parallel/mesh.all_reduce_sum``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


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


def global_mean_denominator(count: torch.Tensor, group=None) -> torch.Tensor:
    """A shard's denominator for a sum normalised by a count over the
    whole batch: ``max(count, 1)`` on one device; over the dp ``group`` of
    S shards, the global count's mean ``C / S`` clamped at ``1 / S``
    (``max(C, 1) / S``, not ``max(C / S, 1)``, which differs when
    ``0 < C < S``).  The dp mean of the shards' ``sum_s / (C / S)`` is then
    ``sum / C``, the one-device value, and so are its gradients."""
    if group is None:
        return count.clamp_min(1.0)
    total = count.detach().clone()
    dist.all_reduce(total, group=group)
    shards = dist.get_world_size(group)
    return torch.clamp_min(total / shards, 1.0 / shards)


def masked_reconstruction_mse(reconstructed: torch.Tensor,
                              target: torch.Tensor,
                              field_mask: torch.Tensor,
                              group=None) -> torch.Tensor:
    """Squared error summed over valid fields' elements, divided by the
    number of valid fields (at least 1): [B, F, D], [B, F, D], [B, F].
    ``group``: the dp group of a shard (``global_mean_denominator``)."""
    masked = (reconstructed - target) ** 2 * field_mask[..., None]
    return masked.sum() / global_mean_denominator(field_mask.sum(), group)


def triplet_hinge_arguments(anchor: torch.Tensor, positive: torch.Tensor,
                            negative: torch.Tensor, margin: float = 0.5,
                            eps: float = 1e-6) -> torch.Tensor:
    """margin + d(a, p) - d(a, n) per sample, euclidean d with eps inside
    the square root: the argument of the triplet hinge."""
    d_pos = torch.sqrt(((anchor - positive) ** 2).sum(-1) + eps)
    d_neg = torch.sqrt(((anchor - negative) ** 2).sum(-1) + eps)
    return d_pos - d_neg + margin


def triplet_hinge_active(arguments: torch.Tensor) -> torch.Tensor:
    """The samples (0 / 1) whose hinge argument ``triplet_margin_loss``
    passes: ``clamp(arg, min=0)``'s gradient is 1 where arg >= 0, an
    argument of exactly 0 included."""
    return (arguments >= 0).to(arguments.dtype)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 0.5,
                        eps: float = 1e-6,
                        active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean(relu(margin + d(a, p) - d(a, n))), as the JAX function.
    ``active`` (0 / 1 per sample), for parity tests: the hinge passes the
    argument of exactly these samples, the same loss wherever the set
    agrees with the argument's sign."""
    arg = triplet_hinge_arguments(anchor, positive, negative, margin, eps)
    if active is None:
        return torch.clamp(arg, min=0.0).mean()
    return (arg * active).mean()


def item_qformer_loss(model_output: Dict[str, torch.Tensor],
                      field_embeddings: torch.Tensor,
                      field_mask: torch.Tensor, positive_rep: torch.Tensor,
                      negative_rep: torch.Tensor,
                      reconstruction_weight: float = 1.0,
                      contrastive_weight: float = 0.25, margin: float = 0.5,
                      hinge_active: Optional[torch.Tensor] = None,
                      group=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, reconstruction, contrastive) of the item trainer;
    ``hinge_active`` is ``triplet_margin_loss``'s ``active``; ``group``
    the dp group of a shard (the triplet term is a mean over equal shards,
    which the dp mean already makes exact)."""
    recon = masked_reconstruction_mse(model_output["reconstructed_fields"],
                                      field_embeddings, field_mask, group)
    cont = triplet_margin_loss(model_output["item_representation"],
                               positive_rep, negative_rep, margin,
                               active=hinge_active)
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
