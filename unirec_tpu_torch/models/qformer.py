"""Q-Former encoder (port of ``unirec_tpu/models/qformer.py``): the BERT
stack with learned query tokens, its text branch and its LM heads.

The Q-Former runs its learned query tokens (optionally followed by text
tokens) through a BERT encoder: self-attention over the whole sequence,
cross-attention of the query slice into the memory on layers where ``i %
cross_attention_freq == 0``, then the query FFN (``ffn_query``) on the query
slice and the text FFN (``ffn``) on the text slice; every block is
post-LayerNorm with exact-erf gelu and additive ``-1e9`` key masks.  Text
tokens embed through ``word_embeddings`` plus, for the absolute position
type, ``position_embeddings``; the relative types (``relative_key``,
``relative_key_query``) instead add distance-embedding terms to the raw
self-attention scores.  ``is_decoder`` takes the causal mask with its UniLM
query prefix (``ops/attention.make_causal_mask``).  A training forward's
``DropoutStream`` applies the JAX module's dropout sites (the embeddings
after their LayerNorm, the attention probabilities, each attention block's
and FFN's output before the residual LayerNorm).  With ``fused_training`` an
attention block runs as one trainable fused block (``ops/fused_qformer_vjp``:
B12s / B12c on the card) wherever the JAX module's dispatch takes its
Pallas blocks; with ``flash_training`` a cross block that takes no fused
block runs the trainable flash cross-attention (``ops/flash_vjp``: B14), and
a deterministic cross block otherwise goes through
``ops/attention.cross_attention`` (B13 on the card over long memories), in
the JAX module's order of checks.  A cross block with an ``sp_group``
(sequence parallelism, the JAX module's ``sp_mesh``) projects K/V from its
rank's slice of the memory and combines over the group
(``ops/sharded_attention``).  With ``capture_attention_probs`` every
attention block takes the plain path and keeps its post-dropout
probabilities in ``captured_probs`` (``utils/debug.capture_attention_maps``).

The LM heads: ``QFormerLMPredictionHead`` (dense, gelu, LayerNorm, vocab
projection), ``causal_lm_loss`` (shifted, label smoothing 0.1 over the mean
log-probability, ignore -100), ``QFormerLMHeadModel`` (the decoder; query
positions are dropped before the head), ``greedy_generate`` (a full forward
per step; ``models/qformer_decode.py`` is the KV-cached form) and
``QFormerForMaskedLM``.

Parameter names follow the Flax tree one to one (``query``, ``key``,
``value``, ``output_dense``, ``output_LayerNorm``, ``crossattention``,
``ffn_query``, ``ffn``, ``encoder.layer.{i}``, ``word_embeddings.embedding``,
``distance_embedding.embedding``), with Flax ``kernel [in, out]`` stored as
torch ``weight [out, in]`` and LayerNorm ``scale`` as ``weight``
(``utils/weights.py``; ``nn.Embed`` tables keep their layout).  A Flax
module creates the text tables and FFNs only when it sees text tokens and
the query FFN and cross-attention only when it sees queries, so the port
takes that as ``with_text`` / ``with_queries`` at construction.  LayerNorm
parameters stay float32 as in Flax; the rest are stored in the model dtype,
which is what the JAX modules cast them to before use.
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
    make_causal_mask,
    merge_heads,
    split_heads,
)
from unirec_tpu_torch.ops.dropout import DropoutStream, dropout
from unirec_tpu_torch.ops.dropout import at as _at
from unirec_tpu_torch.ops.flash_vjp import flash_cross_attention_proj_vjp
from unirec_tpu_torch.ops.sharded_attention import (
    sequence_parallel_cross_attention,
)
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


class Embed(nn.Module):
    """Flax ``nn.Embed``: a table ``embedding [num, dim]`` in the parameter
    dtype, looked up and cast to ``dtype``."""

    def __init__(self, num: int, dim: int, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(
            num, dim, device=device, dtype=param_dtype or dtype))
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.dtype)


class QFormerEmbeddings(nn.Module):
    """Word (+ absolute position) embeddings of the text tokens, the query
    tokens prepended, then the shared LayerNorm and dropout."""

    def __init__(self, config: QFormerConfig, with_text: bool = False, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        d = config.hidden_size
        self.absolute = config.position_embedding_type == "absolute"
        self.word_embeddings = (Embed(config.vocab_size, d, **kw)
                                if with_text else None)
        self.position_embeddings = (
            Embed(config.max_position_embeddings, d, **kw)
            if with_text and self.absolute else None)
        self.LayerNorm = LayerNorm(d, config.layer_norm_eps,
                                   device=device, dtype=dtype)
        self.dtype = dtype
        self.rate = config.hidden_dropout_prob

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                query_embeds: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                past_length: int = 0,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        if input_ids is not None:
            if self.word_embeddings is None:
                raise ValueError("this model was built without text tables "
                                 "(with_text=False)")
            emb = self.word_embeddings(input_ids)
            if self.absolute:
                if position_ids is None:
                    position_ids = torch.arange(
                        past_length, past_length + input_ids.shape[1],
                        device=input_ids.device)[None, :]
                emb = emb + self.position_embeddings(position_ids)
            if query_embeds is not None:
                emb = torch.cat([query_embeds.to(emb.dtype), emb], dim=1)
        elif query_embeds is None:
            raise ValueError("need input_ids or query_embeds")
        else:
            emb = query_embeds.to(self.dtype)
        return dropout(self.LayerNorm(emb), self.rate, drop)


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
        self.relative = (not is_cross
                         and config.position_embedding_type != "absolute")
        self.distance_embedding = (
            Embed(2 * config.max_position_embeddings - 1, config.head_dim,
                  **lkw) if self.relative else None)
        self.captured_probs: Optional[torch.Tensor] = None
        # the sp process group of a cross block whose memory is split over
        # ranks (models/user_qformer.UserQFormer.set_sequence_parallel)
        self.sp_group = None

    def forward(self, hidden_states: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                kv_states: Optional[torch.Tensor] = None,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        src = kv_states if self.is_cross else hidden_states
        probs_rate, hidden_rate = self.rates
        cfg = self.config
        capture = cfg.capture_attention_probs
        fast = cfg.fast_attention and drop is None and not capture
        if self._fused_ok(hidden_states, src, bias, drop):
            out = self._fused(hidden_states, src, bias)
        elif (self.is_cross and self.sp_group is not None and not capture
              and not fast):
            # sequence parallel: K/V projected from this rank's memory
            # slice, then the exact combine over the sp group
            if drop is not None and probs_rate > 0.0:
                raise ValueError(
                    "sequence-parallel cross-attention requires "
                    "attention-prob dropout off (set sequence_parallel on "
                    "the config so qformer() zeroes it)")
            ctx = sequence_parallel_cross_attention(
                split_heads(self.query(hidden_states), self.num_heads),
                split_heads(self.key(src), self.num_heads),
                split_heads(self.value(src), self.num_heads), bias,
                group=self.sp_group)
            out = self.output_dense(merge_heads(ctx))
        elif (self.is_cross and cfg.flash_training and not capture
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
            probs_drop = _at(drop, "probs")
            if self.relative:
                ctx = self._relative(q, k, v, bias, probs_rate, probs_drop)
            elif capture:
                ctx, self.captured_probs = attention(
                    q, k, v, bias, probs_rate, probs_drop, return_probs=True)
            elif self.is_cross and not fast:
                ctx = cross_attention(q, k, v, bias, probs_rate, probs_drop)
            else:
                ctx = attention(q, k, v, bias, probs_rate, probs_drop)
            out = self.output_dense(merge_heads(ctx))
        out = dropout(out, hidden_rate, _at(drop, "out"))
        return self.output_LayerNorm(out + hidden_states)

    def _relative(self, q, k, v, bias, rate, drop) -> torch.Tensor:
        """BERT's relative-position scoring, self-attention only: q . pe
        (and k . pe for ``relative_key_query``) added to the raw scores
        q . k, the sum scaled by 1 / sqrt(hd) afterwards, then the bias and
        an fp32 softmax (the JAX module's einsums, fp32 accumulation)."""
        length = q.shape[2]
        pos = torch.arange(length, device=q.device)
        max_pos = self.config.max_position_embeddings
        pe = self.distance_embedding(pos[:, None] - pos[None, :] + max_pos
                                     - 1).float()  # [L, L, hd]
        qf, kf = q.float(), k.float()
        scores = torch.matmul(qf, kf.transpose(-1, -2))
        scores = scores + torch.einsum("bhld,lrd->bhlr", qf, pe)
        if self.config.position_embedding_type == "relative_key_query":
            scores = scores + torch.einsum("bhrd,lrd->bhlr", kf, pe)
        scores = scores / torch.sqrt(torch.tensor(float(q.shape[-1])))
        if bias is not None:
            scores = scores + bias.float()
        probs = dropout(torch.softmax(scores, dim=-1), rate, drop)
        if self.config.capture_attention_probs:
            self.captured_probs = probs
        return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)

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
    """Self-attention over the whole sequence; on the query slice,
    cross-attention into the memory (on cross layers) and the query FFN; on
    the text slice, the text FFN."""

    def __init__(self, config: QFormerConfig, has_cross_attention: bool,
                 with_text: bool = False, with_queries: bool = True, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.attention = QFormerAttention(config, **kw)
        self.crossattention = (
            QFormerAttention(config, is_cross=True, **kw)
            if has_cross_attention and with_queries else None)
        self.ffn_query = QFormerFFN(config, **kw) if with_queries else None
        self.ffn = QFormerFFN(config, **kw) if with_text else None

    def forward(self, hidden_states: torch.Tensor,
                self_bias: Optional[torch.Tensor],
                encoder_hidden_states: Optional[torch.Tensor],
                encoder_bias: Optional[torch.Tensor],
                query_length: int,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        x = self.attention(hidden_states, self_bias,
                           drop=_at(drop, "attention"))
        if query_length == 0:
            return self.ffn(x, _at(drop, "ffn"))
        query_part = x[:, :query_length]
        if self.crossattention is not None:
            if encoder_hidden_states is None:
                raise ValueError(
                    "encoder_hidden_states required for cross-attention layers")
            query_part = self.crossattention(
                query_part, encoder_bias, kv_states=encoder_hidden_states,
                drop=_at(drop, "crossattention"))
        query_out = self.ffn_query(query_part, _at(drop, "ffn_query"))
        if x.shape[1] == query_length:
            return query_out
        text_out = self.ffn(x[:, query_length:], _at(drop, "ffn"))
        return torch.cat([query_out, text_out], dim=1)


class QFormerEncoder(nn.Module):
    """The layers; with ``gradient_checkpointing`` a training forward that
    needs gradients recomputes each layer in the backward
    (``torch.utils.checkpoint``), the JAX module's layer remat.  The
    recompute gets the same dropout stream and so draws the same masks."""

    def __init__(self, config: QFormerConfig, with_text: bool = False,
                 with_queries: bool = True, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        self.remat = config.gradient_checkpointing
        self.layer = nn.ModuleList(
            QFormerLayer(
                config,
                config.add_cross_attention
                and i % config.cross_attention_freq == 0,
                with_text, with_queries,
                device=device, dtype=dtype, param_dtype=param_dtype,
            )
            for i in range(config.num_hidden_layers)
        )

    def forward(self, hidden_states, self_bias, encoder_hidden_states,
                encoder_bias, query_length: int,
                drop: Optional[DropoutStream] = None):
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i, layer in enumerate(self.layer):
            args = (hidden_states, self_bias, encoder_hidden_states,
                    encoder_bias, query_length, _at(drop, "layer", i))
            hidden_states = (checkpoint(layer, *args, use_reentrant=False)
                             if remat else layer(*args))
        return hidden_states


class QFormerPooler(nn.Module):
    """dense + tanh over the first token."""

    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            device=device, dtype=dtype,
                            param_dtype=param_dtype)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden_states[:, 0]))


class QFormerModel(nn.Module):
    """The BERT encoder over [queries + text]: returns the last hidden state
    ``[B, query_length + text_length, hidden]``, and the pooled first token
    with ``add_pooling_layer``.  ``with_text`` builds the text tables and
    FFNs, ``with_queries`` the query FFNs and cross-attention (the Item and
    User Q-Formers: queries only)."""

    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None,
                 with_text: bool = False, with_queries: bool = True,
                 add_pooling_layer: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.config = config
        self.embeddings = QFormerEmbeddings(config, with_text, **kw)
        self.encoder = QFormerEncoder(config, with_text, with_queries, **kw)
        self.pooler = QFormerPooler(config, **kw) if add_pooling_layer else None

    def forward(self, query_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutStream] = None, *,
                input_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                is_decoder: bool = False):
        """``dropout``: a training forward's stream (None: no dropout)."""
        query_length = 0 if query_embeds is None else query_embeds.shape[1]
        hidden = self.embeddings(input_ids, query_embeds, position_ids,
                                 drop=_at(dropout, "embeddings"))
        if attention_mask is None:
            attention_mask = hidden.new_ones(hidden.shape[:2], dtype=torch.float32)
        if is_decoder:
            self_bias = make_causal_mask(attention_mask,
                                         hidden.shape[1] - query_length,
                                         query_length)
        else:
            self_bias = make_additive_mask(attention_mask)
        encoder_bias = None
        if encoder_hidden_states is not None:
            if encoder_attention_mask is None:
                encoder_attention_mask = encoder_hidden_states.new_ones(
                    encoder_hidden_states.shape[:2], dtype=torch.float32)
            encoder_bias = make_additive_mask(encoder_attention_mask)
        out = self.encoder(hidden, self_bias, encoder_hidden_states,
                           encoder_bias, query_length, _at(dropout, "encoder"))
        if self.pooler is not None:
            return out, self.pooler(out)
        return out


class QFormerLMPredictionHead(nn.Module):
    """transform (dense -> gelu -> LayerNorm) -> vocab projection."""

    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        if config.hidden_act != "gelu":
            raise ValueError(f"only exact gelu is ported, got {config.hidden_act}")
        lkw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        d = config.hidden_size
        self.transform_dense = Linear(d, d, **lkw)
        self.transform_LayerNorm = LayerNorm(d, config.layer_norm_eps,
                                             device=device, dtype=dtype)
        self.decoder = Linear(d, config.vocab_size, **lkw)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.transform_dense(hidden_states), approximate="none")
        return self.decoder(self.transform_LayerNorm(h))


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   label_smoothing: float = 0.1,
                   ignore_index: int = -100) -> torch.Tensor:
    """Shifted causal LM loss: (1 - s) * NLL + s * (-mean log p) per
    position, fp32, over the labels that are not ``ignore_index``."""
    logits, labels = logits[:, :-1], labels[:, 1:]
    valid = labels != ignore_index
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    loss = (1.0 - label_smoothing) * nll - label_smoothing * logp.mean(-1)
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().clamp_min(1)


class QFormerLMHeadModel(nn.Module):
    """The causal / UniLM LM over [queries + text]: ``bert`` (the decoder
    mask) and ``cls``; query positions are dropped before the head.  Returns
    the logits ``[B, T, vocab]``, and ``causal_lm_loss`` with ``labels``."""

    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None,
                 with_queries: bool = True):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.config = config
        self.bert = QFormerModel(config, with_text=True,
                                 with_queries=with_queries, **kw)
        self.cls = QFormerLMPredictionHead(config, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                query_embeds: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutStream] = None):
        query_length = 0 if query_embeds is None else query_embeds.shape[1]
        hidden = self.bert(query_embeds, attention_mask, encoder_hidden_states,
                           encoder_attention_mask, dropout, input_ids=input_ids,
                           is_decoder=True)
        logits = self.cls(hidden[:, query_length:])
        if labels is not None:
            return logits, causal_lm_loss(logits, labels)
        return logits


@torch.no_grad()
def greedy_generate(model: QFormerLMHeadModel, query_embeds: torch.Tensor,
                    encoder_hidden_states: Optional[torch.Tensor] = None,
                    encoder_attention_mask: Optional[torch.Tensor] = None,
                    bos_token_id: int = 30522 - 1, eos_token_id: int = 102,
                    pad_token_id: int = 0,
                    max_new_tokens: int = 32) -> torch.Tensor:
    """Greedy decoding with the UniLM decoder mask, a full forward per step
    over a text buffer of ``max_new_tokens`` (the later positions masked);
    positions after EOS stay ``pad_token_id``.  ``[B, max_new_tokens]``
    int64 ids, the first ``bos_token_id``."""
    batch, k = query_embeds.shape[:2]
    device = query_embeds.device
    ids = torch.full((batch, max_new_tokens), pad_token_id, dtype=torch.long,
                     device=device)
    ids[:, 0] = bos_token_id
    finished = torch.zeros(batch, dtype=torch.bool, device=device)
    positions = torch.arange(max_new_tokens, device=device)
    for step in range(max_new_tokens - 1):
        mask = torch.cat([torch.ones(batch, k, device=device),
                          (positions <= step).float()[None].expand(batch, -1)],
                         dim=1)
        logits = model(ids, mask, query_embeds, encoder_hidden_states,
                       encoder_attention_mask)
        next_tok = logits[:, step].argmax(-1)
        next_tok = torch.where(finished, pad_token_id, next_tok)
        ids[:, step + 1] = next_tok
        finished |= next_tok == eos_token_id
    return ids


class QFormerForMaskedLM(nn.Module):
    """The masked-LM head over the text positions: ``bert`` (bidirectional
    mask) and ``cls``; with ``labels`` also the mean NLL over the labels that
    are not -100."""

    def __init__(self, config: QFormerConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None,
                 with_queries: bool = True):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.config = config
        self.bert = QFormerModel(config, with_text=True,
                                 with_queries=with_queries, **kw)
        self.cls = QFormerLMPredictionHead(config, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                query_embeds: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutStream] = None):
        query_length = 0 if query_embeds is None else query_embeds.shape[1]
        hidden = self.bert(query_embeds, attention_mask, encoder_hidden_states,
                           encoder_attention_mask, dropout, input_ids=input_ids)
        logits = self.cls(hidden[:, query_length:])
        if labels is None:
            return logits
        valid = labels != -100
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
        return logits, torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)
