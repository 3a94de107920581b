"""Item Q-Former (port of ``unirec_tpu/models/item_qformer.py``): compresses
an item's per-field embeddings into K query tokens.

  field_embeddings [B, F, field_dim], attention_mask [B, F] (1 = present)
  -> query_outputs        [B, K, hidden]
     item_representation  [B, field_dim]   Linear(mean over queries)
     reconstructed_fields [B, F, field_dim] Linear(K -> F) over the query axis

The joint model reads only ``query_outputs`` (``query_outputs()``), which is
what the JAX jit graph keeps after dead-code elimination.

With ``use_field_type_embeddings`` a learned ``field_id_embeddings [F,
field_dim]`` table is added to the field embeddings before the encoder, as in
the JAX model.  Its per-call modality table (``modality_ids``) is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unirec_tpu.configs import ItemQFormerConfig
from unirec_tpu_torch.models.qformer import QFormerModel


class ItemQFormer(nn.Module):
    def __init__(self, config: ItemQFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        k, d, fd = (config.num_query_tokens, config.hidden_size,
                    config.field_embedding_dim)
        self.query_embeddings = nn.Parameter(
            torch.empty(1, k, d, device=device, dtype=dtype))
        self.field_id_embeddings = (
            nn.Parameter(torch.empty(config.num_fields, fd, device=device,
                                     dtype=dtype))
            if config.use_field_type_embeddings else None)
        self.qformer = QFormerModel(config.qformer(), device=device,
                                    dtype=dtype)
        self.item_representation_head = nn.Linear(d, fd, device=device,
                                                  dtype=dtype)
        self.reconstruction_head = nn.Linear(d, fd, device=device, dtype=dtype)
        # Flax DenseGeneral(features=F, axis=1): kernel [K, F] -> weight [F, K]
        self.field_projection = nn.Linear(k, config.num_fields, device=device,
                                          dtype=dtype)

    def query_outputs(self, field_embeddings: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None,
                      modality_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """[B, F, field_dim] fields -> [B, K, hidden] query tokens."""
        if modality_ids is not None:
            raise NotImplementedError(
                "modality-id embeddings are not ported yet (they arrive with "
                "the encoders)")
        batch = field_embeddings.shape[0]
        if attention_mask is None:
            attention_mask = field_embeddings.new_ones(
                field_embeddings.shape[:2], dtype=torch.float32)
        if self.field_id_embeddings is not None:
            # added before the cast to the model dtype, as in the JAX model
            field_embeddings = field_embeddings + self.field_id_embeddings[None]
        query_embeds = self.query_embeddings.expand(batch, -1, -1)
        # queries are never masked
        query_mask = field_embeddings.new_ones(
            (batch, self.config.num_query_tokens), dtype=torch.float32)
        return self.qformer(
            query_embeds,
            attention_mask=query_mask,
            encoder_hidden_states=field_embeddings.to(self.dtype),
            encoder_attention_mask=attention_mask,
        )

    def forward(self, field_embeddings: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                modality_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        query_outputs = self.query_outputs(field_embeddings, attention_mask,
                                           modality_ids)
        item_representation = self.item_representation_head(
            query_outputs.mean(dim=1))
        recon = self.reconstruction_head(query_outputs)  # [B, K, field_dim]
        reconstructed = self.field_projection(recon.transpose(1, 2))
        return {
            "query_outputs": query_outputs,
            "item_representation": item_representation,
            "reconstructed_fields": reconstructed.transpose(1, 2),
        }
