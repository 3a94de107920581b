"""Item Q-Former (port of ``unirec_tpu/models/item_qformer.py``): compresses
an item's per-field embeddings into K query tokens.

  field_embeddings [B, F, field_dim], attention_mask [B, F] (1 = present)
  -> query_outputs        [B, K, hidden]
     item_representation  [B, field_dim]   Linear(mean over queries)
     reconstructed_fields [B, F, field_dim] Linear(K -> F) over the query axis

The joint model reads only ``query_outputs`` (``query_outputs()``), which is
what the JAX jit graph keeps after dead-code elimination.

With ``use_field_type_embeddings`` a learned ``field_id_embeddings [F,
field_dim]`` table is added to the field embeddings before the encoder, and
with ``modality_ids`` ``[F]`` (the schema's modality id of each field) the
rows of a ``modality_id_embeddings [num_modalities, field_dim]`` table too,
as in the JAX model.  A Flax module creates that table only when its init
sees ``modality_ids``, so the port builds it with ``modality_table=True``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unirec_tpu_torch.configs import ItemQFormerConfig
from unirec_tpu_torch.models.qformer import Linear, QFormerModel
from unirec_tpu_torch.ops.dropout import DropoutStream


class ItemQFormer(nn.Module):
    """``param_dtype`` (default ``dtype``) stores the parameters, ``dtype``
    computes, as ``models/qwen3.py`` does."""

    def __init__(self, config: ItemQFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 modality_table: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        k, d, fd = (config.num_query_tokens, config.hidden_size,
                    config.field_embedding_dim)
        pkw = dict(device=device, dtype=param_dtype or dtype)
        lkw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.query_embeddings = nn.Parameter(torch.empty(1, k, d, **pkw))
        self.field_id_embeddings = (
            nn.Parameter(torch.empty(config.num_fields, fd, **pkw))
            if config.use_field_type_embeddings else None)
        self.modality_id_embeddings = (
            nn.Parameter(torch.empty(config.num_modalities, fd, **pkw))
            if config.use_field_type_embeddings and modality_table else None)
        self.qformer = QFormerModel(config.qformer(), **lkw)
        self.item_representation_head = Linear(d, fd, **lkw)
        self.reconstruction_head = Linear(d, fd, **lkw)
        # Flax DenseGeneral(features=F, axis=1): kernel [K, F] -> weight [F, K]
        self.field_projection = Linear(k, config.num_fields, **lkw)

    def query_outputs(self, field_embeddings: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None,
                      modality_ids: Optional[torch.Tensor] = None,
                      dropout: Optional[DropoutStream] = None
                      ) -> torch.Tensor:
        """[B, F, field_dim] fields -> [B, K, hidden] query tokens;
        ``dropout``: a training forward's stream."""
        batch = field_embeddings.shape[0]
        if attention_mask is None:
            attention_mask = field_embeddings.new_ones(
                field_embeddings.shape[:2], dtype=torch.float32)
        if self.field_id_embeddings is not None:
            # added before the cast to the model dtype, as in the JAX model
            field_embeddings = field_embeddings + self.field_id_embeddings[None]
            if modality_ids is not None:
                if self.modality_id_embeddings is None:
                    raise ValueError("modality_ids need the modality table: "
                                     "build the model with modality_table=True")
                field_embeddings = (field_embeddings
                                    + self.modality_id_embeddings[modality_ids][None])
        query_embeds = self.query_embeddings.expand(batch, -1, -1)
        # queries are never masked
        query_mask = field_embeddings.new_ones(
            (batch, self.config.num_query_tokens), dtype=torch.float32)
        return self.qformer(
            query_embeds,
            attention_mask=query_mask,
            encoder_hidden_states=field_embeddings.to(self.dtype),
            encoder_attention_mask=attention_mask,
            dropout=dropout,
        )

    def forward(self, field_embeddings: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                modality_ids: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutStream] = None
                ) -> Dict[str, torch.Tensor]:
        query_outputs = self.query_outputs(field_embeddings, attention_mask,
                                           modality_ids, dropout)
        item_representation = self.item_representation_head(
            query_outputs.mean(dim=1))
        recon = self.reconstruction_head(query_outputs)  # [B, K, field_dim]
        reconstructed = self.field_projection(recon.transpose(1, 2))
        return {
            "query_outputs": query_outputs,
            "item_representation": item_representation,
            "reconstructed_fields": reconstructed.transpose(1, 2),
        }
