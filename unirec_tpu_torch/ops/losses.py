"""Losses and normalisation (port of ``unirec_tpu/ops/losses.py``).

Only ``l2_normalize`` is ported so far: serving normalises user embeddings
after the forward and again inside retrieval.  The training losses wait for
the joint-training slice.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)`` semantics: divide by the norm clamped at eps."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
    return x / norm
