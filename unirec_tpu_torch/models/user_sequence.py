"""User sequence encoding: item query tokens + time/geo context + positions
(port of ``unirec_tpu/models/user_sequence.py``).

Item query tokens come from the precomputed catalog tokens (one Item
Q-Former pass over the field cache, ``train/user_qformer.
precompute_item_tokens``); the sequence assembly is plain batched tensor
code:

  contextual = item_tokens + (time_emb + geo_emb)[:, :, None, :]
  flat       = reshape to [B, S*K, D] + sinusoidal PE
  flat_mask  = seq mask repeated K times per event

Parameter names follow the Flax tree (``context.timestamp.fc1``, ...).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from unirec_tpu_torch.models.mwne import (
    GeoCoordinateEncoder,
    TimestampEncoder,
    sinusoidal_position_encoding,
)


class SequenceContextEncoder(nn.Module):
    """Timestamp + geo MLP encoders producing the per-event context vector
    (reference: models/user_sequence_encoder.py:49-52, 124-131)."""

    def __init__(self, embedding_dim: int, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.embedding_dim = embedding_dim
        self.timestamp = TimestampEncoder(embedding_dim, **kw)
        self.geo = GeoCoordinateEncoder(embedding_dim, **kw)

    def forward(self, timestamps: torch.Tensor,
                coordinates: torch.Tensor) -> torch.Tensor:
        """[B, S] timestamps + [B, S, 2] coords -> [B, S, D] context."""
        b, s = timestamps.shape
        time_emb = self.timestamp(timestamps.reshape(-1))
        geo_emb = self.geo(coordinates.reshape(-1, 2))
        return (time_emb + geo_emb).reshape(b, s, self.embedding_dim)


def assemble_user_sequence(item_tokens: torch.Tensor, context: torch.Tensor,
                           seq_mask: Optional[torch.Tensor] = None,
                           add_positional: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse context into item tokens, flatten, add sinusoidal PE.

    item_tokens ``[B, S, K, D]``, context ``[B, S, D]``, seq_mask ``[B, S]``.
    Returns (flat_tokens ``[B, S*K, D]``, flat_mask ``[B, S*K]``), both in
    the dtype of ``item_tokens + context``: context broadcast over the K query
    tokens (:130-131), flatten (:133-136), PE over flattened positions
    (:138-140)."""
    b, s, k, d = item_tokens.shape
    fused = item_tokens + context[:, :, None, :]
    flat = fused.reshape(b, s * k, d)
    if add_positional:
        flat = flat + sinusoidal_position_encoding(
            s * k, d, dtype=flat.dtype, device=flat.device)[None]
    if seq_mask is None:
        flat_mask = flat.new_ones(b, s * k)
    else:
        flat_mask = seq_mask.to(flat.dtype).repeat_interleave(k, dim=1)
    return flat, flat_mask


class UserSequenceModel(nn.Module):
    """Context encoders + assembly in one module (item tokens supplied by the
    frozen Item Q-Former outside)."""

    def __init__(self, embedding_dim: int, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        self.context = SequenceContextEncoder(
            embedding_dim, device=device, dtype=dtype, param_dtype=param_dtype)

    def forward(self, item_tokens: torch.Tensor, timestamps: torch.Tensor,
                coordinates: torch.Tensor,
                seq_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        context = self.context(timestamps, coordinates)
        return assemble_user_sequence(item_tokens, context, seq_mask)
