"""Q-Former encoder, query-only path (port of ``unirec_tpu/models/qformer.py``).

The item Q-Former runs its learned query tokens through a BERT encoder:
self-attention over the queries, cross-attention into the field memory on
layers where ``i % cross_attention_freq == 0``, and the query FFN; every block
is post-LayerNorm with exact-erf gelu and additive ``-1e9`` key masks.  The
plain-tensor path is ported, deterministic and training: a training forward's
``DropoutStream`` applies the JAX module's dropout sites (the embeddings
after their LayerNorm, the attention probabilities, each attention block's
and the FFN's output before the residual LayerNorm) at
``hidden_dropout_prob`` / ``attention_probs_dropout_prob``.  With
``fused_training`` an attention block runs as one trainable fused block
(``ops/fused_qformer_vjp``: B12s / B12c on the card) wherever the JAX
module's dispatch takes its Pallas blocks; with ``flash_training`` a cross
block that takes no fused block runs the trainable flash cross-attention
(``ops/flash_vjp``: B14), and a deterministic cross block otherwise goes
through ``ops/attention.cross_attention`` (B13 on the card over long
memories), in the JAX module's order of checks.  The text-token embeddings
and FFN, the decoder mask and relative positions wait.

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
from torch.utils.checkpoint import checkpoint

from unirec_tpu_torch.configs import QFormerConfig
from unirec_tpu_torch.ops.attention import (
    attention,
    cross_attention,
    make_additive_mask,
    merge_heads,
    split_heads,
)
from unirec_tpu_torch.ops.dropout import DropoutStream, dropout
from unirec_tpu_torch.ops.dropout import at as _at
from unirec_tpu_torch.ops.flash_vjp import flash_cross_attention_proj_vjp
from unirec_tpu_torch.ops.fused_qformer_vjp import (
    fused_cross_attention_train,
    fused_self_attention_train,
    supports_fused_train,
)


class Linear(nn.Linear):
    """``nn.Linear`` with its parameters in ``param_dtype`` and its product
    in ``dtype`` (Flax ``Dense(dtype=..., param_dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


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
        self.config = config
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
        probs_rate, hidden_rate = self.rates
        cfg = self.config
        fast = cfg.fast_attention and drop is None
        if self._fused_ok(hidden_states, src, bias, drop):
            out = self._fused(hidden_states, src, bias)
        elif (self.is_cross and cfg.flash_training
              and not cfg.capture_attention_probs
              and (drop is None or probs_rate <= 0.0) and not fast):
            # B14: the K/V projections inside the gradient, merged heads in
            # and out; its saved state is the shared memory, not k / v
            q = self.query(hidden_states)
            out = self.output_dense(flash_cross_attention_proj_vjp(
                q, src.to(q.dtype), self.key.weight, self.key.bias,
                self.value.weight, self.value.bias, bias, self.num_heads))
        else:
            q = split_heads(self.query(hidden_states), self.num_heads)
            k = split_heads(self.key(src), self.num_heads)
            v = split_heads(self.value(src), self.num_heads)
            attend = cross_attention if self.is_cross and not fast else attention
            ctx = merge_heads(attend(q, k, v, bias, probs_rate,
                                     _at(drop, "probs")))
            out = self.output_dense(ctx)
        out = dropout(out, hidden_rate, _at(drop, "out"))
        return self.output_LayerNorm(out + hidden_states)

    def _fused_ok(self, hidden_states, src, bias, drop) -> bool:
        """The JAX module's dispatch to its trainable fused blocks:
        ``fused_training``, attention-probability dropout inactive, no
        fast or capture path, a key-only bias, bf16 compute (or a CPU
        tensor, where the blocks run their plain versions as JAX runs
        interpret mode) and ``supports_fused_train``."""
        cfg = self.config
        deterministic = drop is None
        return bool(
            cfg.fused_training
            and not cfg.capture_attention_probs
            and (deterministic or self.rates[0] <= 0.0)
            and not (cfg.fast_attention and deterministic)
            and (self.is_cross or cfg.position_embedding_type == "absolute")
            and (bias is None or (bias.dim() == 4 and bias.shape[1] == 1
                                  and bias.shape[2] == 1))
            and (self.query.compute_dtype == torch.bfloat16
                 or hidden_states.device.type == "cpu")
            and supports_fused_train(hidden_states.shape[1], cfg.hidden_size,
                                     self.num_heads, src.shape[1]))

    def _fused(self, hidden_states, src, bias) -> torch.Tensor:
        """W_o . Attention + b_o through B12s / B12c, on the weights
        concatenated as the JAX module does (Wq | Wk | Wv, Wk | Wv) and cast
        to the compute dtype at use, so gradients reach the masters."""
        dt = self.query.compute_dtype
        kb = (bias[:, 0, 0, :].float() if bias is not None
              else src.new_zeros(src.shape[:2], dtype=torch.float32))
        wo, bo = self.output_dense.weight.to(dt), self.output_dense.bias.to(dt)
        if self.is_cross:
            wkv = torch.cat([self.key.weight, self.value.weight]).to(dt)
            bkv = torch.cat([self.key.bias, self.value.bias]).to(dt)
            return fused_cross_attention_train(
                hidden_states.to(dt), src.to(dt), kb, self.query.weight.to(dt),
                self.query.bias.to(dt), wkv, bkv, wo, bo,
                num_heads=self.num_heads)
        wqkv = torch.cat([self.query.weight, self.key.weight,
                          self.value.weight]).to(dt)
        bqkv = torch.cat([self.query.bias, self.key.bias,
                          self.value.bias]).to(dt)
        return fused_self_attention_train(hidden_states.to(dt), kb, wqkv, bqkv,
                                          wo, bo, num_heads=self.num_heads)


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
    """The layers; with ``gradient_checkpointing`` a training forward that
    needs gradients recomputes each layer in the backward
    (``torch.utils.checkpoint``), the JAX module's layer remat.  The
    recompute gets the same dropout stream and so draws the same masks."""

    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        self.remat = config.gradient_checkpointing
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
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i, layer in enumerate(self.layer):
            args = (hidden_states, self_bias, encoder_hidden_states,
                    encoder_bias, _at(drop, "layer", i))
            hidden_states = (checkpoint(layer, *args, use_reentrant=False)
                             if remat else layer(*args))
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
