"""User Q-Former: a fixed-length user representation over the flattened
event sequence (port of ``unirec_tpu/models/user_qformer.py``;
reference: training/user_qformer_training.py:17-68).

64 learned query tokens, broadcast over the batch, run a 4-layer Q-Former
that cross-attends at every layer into the user's flattened history
``[B, S*K, D]``; the query outputs are mean-pooled into the user vector, and
a head Dense -> exact gelu -> LayerNorm(eps 1e-5) -> Dense(K*D) predicts the
next item's K query tokens.

With ``gradient_checkpointing`` a training forward recomputes each layer in
the backward (``models/qformer.QFormerEncoder``).  ``set_sequence_parallel``
splits the memory over an sp process group (the JAX module's ``sp_mesh``):
the caller then passes this rank's slice of the memory and its mask.  Parameter names follow
the Flax tree (``query_embeddings``, ``qformer.*``, ``head_dense1``,
``head_norm``, ``head_dense2``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from unirec_tpu_torch.configs import UserQFormerConfig
from unirec_tpu_torch.models.qformer import LayerNorm, Linear, QFormerModel
from unirec_tpu_torch.models.user_sequence import UserSequenceModel
from unirec_tpu_torch.ops.dropout import DropoutStream


class UserQFormer(nn.Module):
    """``param_dtype`` (default ``dtype``) stores the parameters, ``dtype``
    computes."""

    def __init__(self, config: UserQFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        d = config.hidden_size
        lkw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.query_embeddings = nn.Parameter(torch.empty(
            1, config.num_query_tokens, d, device=device,
            dtype=param_dtype or dtype))
        self.qformer = QFormerModel(config.qformer(), **lkw)
        self.head_dense1 = Linear(d, d, **lkw)
        self.head_norm = LayerNorm(d, 1e-5, device=device, dtype=dtype)
        self.head_dense2 = Linear(
            d, config.num_item_tokens_to_predict * config.input_embedding_dim,
            **lkw)

    def forward(self, user_sequence_tokens: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutStream] = None,
                return_user_representation: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """[B, L, input_dim] memory (+ [B, L] mask) -> [B, K, input_dim]
        predicted tokens; ``dropout``: a training forward's stream (None:
        deterministic)."""
        cfg = self.config
        batch = user_sequence_tokens.shape[0]
        query_embeds = self.query_embeddings.expand(batch, -1, -1)
        query_mask = user_sequence_tokens.new_ones(
            (batch, cfg.num_query_tokens), dtype=torch.float32)
        outputs = self.qformer(
            query_embeds, attention_mask=query_mask,
            encoder_hidden_states=user_sequence_tokens.to(self.dtype),
            encoder_attention_mask=attention_mask, dropout=dropout)
        # mean over query outputs -> user vector
        # (reference: training/user_qformer_training.py:60)
        user_representation = outputs.mean(dim=1)
        h = torch.nn.functional.gelu(self.head_dense1(user_representation),
                                     approximate="none")
        predicted = self.head_dense2(self.head_norm(h)).reshape(
            batch, cfg.num_item_tokens_to_predict, cfg.input_embedding_dim)
        if return_user_representation:
            return predicted, user_representation
        return predicted

    def set_sequence_parallel(self, group) -> None:
        """Split the cross-attention memory over ``group`` (None: whole):
        every cross block then takes this rank's slice of the memory and
        combines exactly over the group (``ops/sharded_attention``)."""
        for mod in self.modules():
            if getattr(mod, "is_cross", False):
                mod.sp_group = group


class UserStage(nn.Module):
    """The user stage's parameters in one module: ``sequence`` (the context
    encoders, ``UserSequenceModel``) and ``user`` (the ``UserQFormer``), the
    ``{"sequence": ..., "user": ...}`` tree of the JAX trainer."""

    def __init__(self, config: UserQFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.config = config
        self.sequence = UserSequenceModel(config.input_embedding_dim, **kw)
        self.user = UserQFormer(config, **kw)
