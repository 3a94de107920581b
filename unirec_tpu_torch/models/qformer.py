"""Q-Former encoder, query-only path (port of ``unirec_tpu/models/qformer.py``).

The item Q-Former runs its learned query tokens through a BERT encoder:
self-attention over the queries, cross-attention into the field memory on
layers where ``i % cross_attention_freq == 0``, and the query FFN; every block
is post-LayerNorm with exact-erf gelu and additive ``-1e9`` key masks.  The
plain-tensor path is ported, deterministic and training: a training forward's
``DropoutStream`` applies the JAX module's dropout sites (the embeddings
after their LayerNorm, the attention probabilities, each attention block's
and the FFN's output before the residual LayerNorm) at
``hidden_dropout_prob`` / ``attention_probs_dropout_prob``.  The text-token
embeddings and FFN, the decoder mask, relative positions and the fused/flash
branches wait; ``fused_training`` raises (its kernels, B12, are not ported).

Parameter names follow the Flax tree one to one (``query``, ``key``,
``value``, ``output_dense``, ``output_LayerNorm``, ``crossattention``,
``ffn_query``, ``encoder.layer.{i}``), with Flax ``kernel [in, out]`` stored
as torch ``weight [out, in]`` and LayerNorm ``scale`` as ``weight``
(``utils/weights.py``).  LayerNorm parameters stay float32 as in Flax; the
rest are stored in the model dtype, which is what the JAX modules cast them
to before use.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unirec_tpu_torch.configs import QFormerConfig
from unirec_tpu_torch.ops.attention import (
    attention,
    make_additive_mask,
    merge_heads,
    split_heads,
)
from unirec_tpu_torch.ops.dropout import DropoutStream, dropout
from unirec_tpu_torch.ops.dropout import at as _at


class Linear(nn.Linear):
    """``nn.Linear`` with its parameters in ``param_dtype`` and its product
    in ``dtype`` (Flax ``Dense(dtype=..., param_dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, device=device,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics and parameters, output in ``dtype``."""

    def __init__(self, dim: int, eps: float, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias,
                         self.eps)
        return y.to(self.dtype)


class QFormerEmbeddings(nn.Module):
    """Query-token path: LayerNorm over ``query_embeds``, then dropout."""

    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   device=device, dtype=dtype)
        self.dtype = dtype
        self.rate = config.hidden_dropout_prob

    def forward(self, query_embeds: torch.Tensor,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        return dropout(self.LayerNorm(query_embeds.to(self.dtype)), self.rate,
                       drop)


class QFormerAttention(nn.Module):
    """Self- or cross-attention block: projections, softmax attention, output
    dense, then ``LayerNorm(out + hidden_states)``."""

    def __init__(self, config: QFormerConfig, is_cross: bool = False, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype=None):
        super().__init__()
        d = config.hidden_size
        src = config.encoder_width if is_cross else d
        self.is_cross = is_cross
        self.num_heads = config.num_attention_heads
        self.rates = (config.attention_probs_dropout_prob,
                      config.hidden_dropout_prob)
        lkw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.query = Linear(d, d, **lkw)
        self.key = Linear(src, d, **lkw)
        self.value = Linear(src, d, **lkw)
        self.output_dense = Linear(d, d, **lkw)
        self.output_LayerNorm = LayerNorm(d, config.layer_norm_eps,
                                          device=device, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                kv_states: Optional[torch.Tensor] = None,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        src = kv_states if self.is_cross else hidden_states
        q = split_heads(self.query(hidden_states), self.num_heads)
        k = split_heads(self.key(src), self.num_heads)
        v = split_heads(self.value(src), self.num_heads)
        probs_rate, hidden_rate = self.rates
        ctx = merge_heads(attention(q, k, v, bias, probs_rate,
                                    _at(drop, "probs")))
        out = dropout(self.output_dense(ctx), hidden_rate, _at(drop, "out"))
        return self.output_LayerNorm(out + hidden_states)


class QFormerFFN(nn.Module):
    """intermediate dense -> exact-erf gelu -> output dense -> LN(x + h)."""

    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        if config.hidden_act != "gelu":
            raise ValueError(f"only exact gelu is ported, got {config.hidden_act}")
        d = config.hidden_size
        self.rate = config.hidden_dropout_prob
        lkw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.intermediate_dense = Linear(d, config.intermediate_size, **lkw)
        self.output_dense = Linear(config.intermediate_size, d, **lkw)
        self.output_LayerNorm = LayerNorm(d, config.layer_norm_eps,
                                          device=device, dtype=dtype)

    def forward(self, x: torch.Tensor,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        h = F.gelu(self.intermediate_dense(x), approximate="none")
        h = dropout(self.output_dense(h), self.rate, drop)
        return self.output_LayerNorm(h + x)


class QFormerLayer(nn.Module):
    """Self-attention, cross-attention into the memory (on cross layers), and
    the query FFN."""

    def __init__(self, config: QFormerConfig, has_cross_attention: bool, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.attention = QFormerAttention(config, **kw)
        self.crossattention = (QFormerAttention(config, is_cross=True, **kw)
                               if has_cross_attention else None)
        self.ffn_query = QFormerFFN(config, **kw)

    def forward(self, hidden_states: torch.Tensor,
                self_bias: Optional[torch.Tensor],
                encoder_hidden_states: Optional[torch.Tensor],
                encoder_bias: Optional[torch.Tensor],
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        x = self.attention(hidden_states, self_bias,
                           drop=_at(drop, "attention"))
        if self.crossattention is not None:
            if encoder_hidden_states is None:
                raise ValueError(
                    "encoder_hidden_states required for cross-attention layers")
            x = self.crossattention(x, encoder_bias,
                                    kv_states=encoder_hidden_states,
                                    drop=_at(drop, "crossattention"))
        return self.ffn_query(x, _at(drop, "ffn_query"))


class QFormerEncoder(nn.Module):
    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        self.layer = nn.ModuleList(
            QFormerLayer(
                config,
                config.add_cross_attention
                and i % config.cross_attention_freq == 0,
                device=device, dtype=dtype, param_dtype=param_dtype,
            )
            for i in range(config.num_hidden_layers)
        )

    def forward(self, hidden_states, self_bias, encoder_hidden_states,
                encoder_bias, drop: Optional[DropoutStream] = None):
        for i, layer in enumerate(self.layer):
            hidden_states = layer(hidden_states, self_bias,
                                  encoder_hidden_states, encoder_bias,
                                  _at(drop, "layer", i))
        return hidden_states


class QFormerModel(nn.Module):
    """Query-only BERT encoder: returns the last hidden state [B, K, D]."""

    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        if config.position_embedding_type != "absolute":
            raise ValueError("relative position scoring is not ported yet")
        self.config = config
        self.embeddings = QFormerEmbeddings(config, device=device, dtype=dtype)
        self.encoder = QFormerEncoder(config, device=device, dtype=dtype,
                                      param_dtype=param_dtype)

    def forward(self, query_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutStream] = None) -> torch.Tensor:
        """``dropout``: a training forward's stream (None: no dropout)."""
        if self.training and self.config.fused_training:
            raise NotImplementedError(
                "fused_training is not ported (B12): the trainable fused "
                "Q-Former blocks wait for the item-training slice")
        hidden = self.embeddings(query_embeds, _at(dropout, "embeddings"))
        if attention_mask is None:
            attention_mask = hidden.new_ones(hidden.shape[:2], dtype=torch.float32)
        self_bias = make_additive_mask(attention_mask)
        encoder_bias = None
        if encoder_hidden_states is not None:
            if encoder_attention_mask is None:
                encoder_attention_mask = encoder_hidden_states.new_ones(
                    encoder_hidden_states.shape[:2], dtype=torch.float32)
            encoder_bias = make_additive_mask(encoder_attention_mask)
        return self.encoder(hidden, self_bias, encoder_hidden_states,
                            encoder_bias, _at(dropout, "encoder"))
