"""Qwen3 dense decoder with LoRA overlays (port of
``unirec_tpu/models/qwen3.py``).

Pre-RMSNorm layers, grouped-query attention with per-head q/k RMSNorm before
rotary embeddings (rotate-half, theta 1e6), SwiGLU MLP, and an extra block of
embedding rows after the base vocabulary for the joint model's special
tokens.

Self-attention, as the JAX module dispatches it:

* a deterministic forward (``model.eval()``) goes through
  ``ops/flash_causal.flash_causal_attention``: kernel K1 for CUDA tensors,
  its plain version (the JAX additive-mask path) for CPU tensors;
* a training forward (``model.train()``) with
  ``Qwen3Config.flash_vjp_attention`` goes through
  ``flash_causal_attention_train`` (K1 forward, B7b backward on the card);
  without it, through the plain additive-mask attention under autograd, the
  JAX package's own XLA training path.

``Qwen3Model.forward`` checks once per forward that key 0 of every row is
valid (the kernels' mask contract), not once per layer.

Training forwards take a ``DropoutStream`` (``ops/dropout.py``): LoRA dropout
acts on the adapter input only, per projection, or once per q/k/v and
gate/up group with ``LoRAConfig.grouped``, as in the JAX module.
``remat=True`` wraps each layer in ``torch.utils.checkpoint``;
``remat_policy="dots"`` keeps the matrix products' outputs and recomputes the
rest (JAX's ``dots_with_no_batch_dims_saveable``).

Parameter names follow the Flax tree (``layers.{i}`` for ``layers_{i}``);
RMSNorm scales stay float32 as in Flax.  The rest is stored in
``param_dtype`` (default: the compute ``dtype``) and cast to ``dtype`` at
use, Flax's mixed precision: the trainer keeps float32 masters of what it
trains and computes in bfloat16.  ``lora_a [in, r]`` and ``lora_b [r, out]``
keep the Flax layout.

The int8 (W8A8) forward: ``quantize_qwen3_weights`` quantizes the seven
projections per output column, and ``set_qweights`` attaches the codes and
scales to the ``LoRADense`` modules as non-persistent buffers (``weight_q``,
``weight_scale``; the state_dict neither carries nor needs them), the JAX
package's ``qweights`` collection.  A projection with them runs
``ops/int8_ste.int8_linear_ste`` (kernel B8 on the card) with the LoRA
overlay added in the model dtype.  ``Qwen3Config.fused_int8_inference``
(LoRA absent or merged) routes q|k|v through kernel B9a and the whole MLP
through B9b; ``fused_int8_training`` runs q|k|v and gate|up as one wide STE
linear each with bias and LoRA on top (``y_base``).  The guards are the JAX
ones (``ops/fused_qwen3_int8.supports_fused_qwen3``); otherwise each
projection runs on its own.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from unirec_tpu_torch.configs import LoRAConfig, Qwen3Config
from unirec_tpu_torch.ops.dropout import DropoutStream, dropout
from unirec_tpu_torch.ops.dropout import at as _at
from unirec_tpu_torch.ops.flash_causal import (
    check_pad_mask,
    flash_causal_attention,
    flash_causal_attention_plain,
    flash_causal_attention_train,
)
from unirec_tpu_torch.ops.fused_qformer_int8 import quantize_weight
from unirec_tpu_torch.ops.fused_qwen3_int8 import (
    int8_linear_fused_ste,
    qkv_int8,
    supports_fused_qwen3,
    swiglu_mlp_int8,
)
from unirec_tpu_torch.ops.int8_ste import int8_linear_ste


class RMSNorm(nn.Module):
    """Computed in float32 and cast back to the model dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight).to(self.dtype)


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float,
                     dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] positions -> (cos, sin), each [B, L, head_dim]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions.float()[..., None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, H, hd]; cos/sin [B, L, hd] (HF rotate-half convention)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


class LoRADense(nn.Module):
    """y = x W^T (+ b) + (x A) B * alpha / r.

    ``lora_mid`` is the grouped form: the caller already computed ``x A`` for
    several projections sharing ``x`` in one matmul and passes this module's
    ``[..., r]`` slice.  At inference both forms are the same maths.
    ``y_base`` is the base projection computed by the caller through a fused
    kernel spanning several modules; this module adds bias and LoRA.  With
    ``weight_q`` / ``weight_scale`` set (``set_qweights``) the base
    projection is the int8 one.  ``drop`` (a training forward's stream)
    applies LoRA dropout to the adapter's input, unless ``lora_mid`` was
    given (the group drew it)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False,
                 lora: Optional[LoRAConfig] = None, lora_enabled: bool = False,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        pkw = dict(device=device, dtype=param_dtype or dtype)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, **pkw))
        self.bias = (nn.Parameter(torch.zeros(features, **pkw))
                     if use_bias else None)
        self.lora_a = self.lora_b = None
        self.scaling, self.lora_dropout = 0.0, 0.0
        if lora_enabled and lora is not None:
            self.lora_a = nn.Parameter(torch.empty(in_features, lora.r, **pkw))
            self.lora_b = nn.Parameter(torch.zeros(lora.r, features, **pkw))
            self.scaling, self.lora_dropout = lora.scaling, lora.dropout
        self.register_buffer("weight_q", None, persistent=False)
        self.register_buffer("weight_scale", None, persistent=False)

    def forward(self, x: torch.Tensor,
                lora_mid: Optional[torch.Tensor] = None,
                y_base: Optional[torch.Tensor] = None,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        dtype = self.dtype
        if y_base is None and self.weight_q is None:
            y = F.linear(x, self.weight.to(dtype), _cast(self.bias, dtype))
        else:
            if y_base is not None:
                y = y_base
            else:
                y = int8_linear_ste(x.to(dtype), self.weight_q,
                                    self.weight_scale).to(dtype)
            if self.bias is not None:
                y = y + self.bias.to(dtype)
        if self.lora_a is not None:
            mid = lora_mid
            if mid is None:
                mid = dropout(x, self.lora_dropout, drop) @ self.lora_a.to(dtype)
            y = y + (mid @ self.lora_b.to(dtype)) * self.scaling
        return y


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


def _lora_on(lora: Optional[LoRAConfig], name: str) -> bool:
    return lora is not None and name in lora.target_modules


def _grouped_mids(lora: Optional[LoRAConfig], x: torch.Tensor, mods,
                  drop: Optional[DropoutStream] = None
                  ) -> Tuple[Optional[torch.Tensor], ...]:
    """Grouped overlay: one dropout draw and one [D, n*r] lora_a matmul for
    modules sharing x."""
    if (lora is None or not lora.grouped
            or any(m.lora_a is None for m in mods)):
        return (None,) * len(mods)
    dtype = mods[0].dtype
    a_cat = torch.cat([m.lora_a.to(dtype) for m in mods], dim=1)
    mid = dropout(x, lora.dropout, drop) @ a_cat
    return tuple(mid.split(lora.r, dim=-1))


class Qwen3Attention(nn.Module):
    def __init__(self, config: Qwen3Config, lora: Optional[LoRAConfig] = None,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)

        def dense(name, n_in, n_out):
            return LoRADense(n_in, n_out, use_bias=c.attention_bias, lora=lora,
                             lora_enabled=_lora_on(lora, name), **kw)

        self.config, self.lora = config, lora
        self.q_proj = dense("q_proj", c.hidden_size, c.q_size)
        self.k_proj = dense("k_proj", c.hidden_size, c.kv_size)
        self.v_proj = dense("v_proj", c.hidden_size, c.kv_size)
        self.q_norm = RMSNorm(c.head_dim, c.rms_norm_eps, **kw)
        self.k_norm = RMSNorm(c.head_dim, c.rms_norm_eps, **kw)
        self.o_proj = LoRADense(c.q_size, c.hidden_size, lora=lora,
                                lora_enabled=_lora_on(lora, "o_proj"), **kw)
        # int8 [Wq | Wk | Wv] rows and scales (set_qweights); the three
        # modules' weight_q / weight_scale are views into them
        self.register_buffer("qkv_q", None, persistent=False)
        self.register_buffer("qkv_scale", None, persistent=False)

    def projections(self, hidden: torch.Tensor,
                    drop: Optional[DropoutStream] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q [B, L, Hq*hd], k and v [B, L, Hkv*hd] before norm and RoPE."""
        c = self.config
        b, l, d = hidden.shape
        rows, mods = b * l, (self.q_proj, self.k_proj, self.v_proj)
        names = ("q_proj", "k_proj", "v_proj")
        fused = self.qkv_q is not None and supports_fused_qwen3(rows, d)
        dtype = self.q_proj.dtype
        if (fused and c.fused_int8_inference and self.lora is None
                and not c.attention_bias):
            # one row quantization feeds the concatenated int8 matmul (B9a)
            qkv = qkv_int8(hidden.reshape(rows, d).to(dtype), self.qkv_q,
                           self.qkv_scale)
            return tuple(t.reshape(b, l, -1) for t in
                         qkv.split([c.q_size, c.kv_size, c.kv_size], dim=1))
        if fused and c.fused_int8_training:
            # the frozen base as one wide STE linear; bias and LoRA on top
            qkv = int8_linear_fused_ste(hidden.reshape(rows, d).to(dtype),
                                        self.qkv_q, self.qkv_scale.float())
            parts = qkv.split([c.q_size, c.kv_size, c.kv_size], dim=1)
            return tuple(m(hidden, y_base=t.reshape(b, l, -1),
                           drop=_at(drop, n))
                         for m, t, n in zip(mods, parts, names))
        mids = _grouped_mids(self.lora, hidden, mods, _at(drop, "qkv"))
        return tuple(m(hidden, mid, drop=_at(drop, n))
                     for m, mid, n in zip(mods, mids, names))

    def qkv(self, hidden: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
            drop: Optional[DropoutStream] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Merged-head attention inputs: q [B, L, Hq*hd] and k [B, L, Hkv*hd]
        after the per-head RMSNorm and RoPE, and v [B, L, Hkv*hd]."""
        c = self.config
        b, l, _ = hidden.shape
        q, k, v = self.projections(hidden, drop)
        q = q.reshape(b, l, c.num_attention_heads, c.head_dim)
        k = k.reshape(b, l, c.num_key_value_heads, c.head_dim)
        q = apply_rope(self.q_norm(q), cos, sin).reshape(b, l, c.q_size)
        k = apply_rope(self.k_norm(k), cos, sin).reshape(b, l, c.kv_size)
        return q, k, v.contiguous()

    def forward(self, hidden: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, pad_mask: torch.Tensor,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        """``pad_mask`` has passed ``check_pad_mask`` (``Qwen3Model``)."""
        c = self.config
        heads = (c.num_attention_heads, c.num_key_value_heads)
        q, k, v = self.qkv(hidden, cos, sin, drop)
        if not self.training:
            ctx = flash_causal_attention(q, k, v, pad_mask, *heads,
                                         mask_checked=True)
        elif c.flash_vjp_attention:
            ctx = flash_causal_attention_train(q, k, v, pad_mask, *heads,
                                               mask_checked=True)
        else:  # the JAX XLA training path: additive mask under autograd
            ctx = flash_causal_attention_plain(q, k, v, pad_mask, *heads)
        return self.o_proj(ctx, drop=_at(drop, "o_proj"))


class Qwen3MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: Qwen3Config, lora: Optional[LoRAConfig] = None,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, i = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.config, self.lora = config, lora
        self.gate_proj = LoRADense(d, i, lora=lora,
                                   lora_enabled=_lora_on(lora, "gate_proj"),
                                   **kw)
        self.up_proj = LoRADense(d, i, lora=lora,
                                 lora_enabled=_lora_on(lora, "up_proj"), **kw)
        self.down_proj = LoRADense(i, d, lora=lora,
                                   lora_enabled=_lora_on(lora, "down_proj"),
                                   **kw)
        # int8 [Wgate | Wup] rows and scales (set_qweights), as Qwen3Attention
        self.register_buffer("gate_up_q", None, persistent=False)
        self.register_buffer("gate_up_scale", None, persistent=False)

    def forward(self, x: torch.Tensor,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        c = self.config
        b, l, d = x.shape
        rows, inter = b * l, c.intermediate_size
        fused = (self.gate_up_q is not None
                 and supports_fused_qwen3(rows, d, inter))
        dtype = self.gate_proj.dtype
        if (fused and c.fused_int8_inference and self.lora is None
                and self.down_proj.weight_q is not None):
            # the whole MLP as one kernel (B9b)
            out = swiglu_mlp_int8(x.reshape(rows, d).to(dtype),
                                  self.gate_up_q, self.gate_up_scale,
                                  self.down_proj.weight_q,
                                  self.down_proj.weight_scale)
            return out.reshape(b, l, d)
        if fused and c.fused_int8_training:
            # gate|up as one wide STE linear; LoRA perturbs gate and up
            # before the nonlinearity, so silu stays outside the kernel
            gu = int8_linear_fused_ste(x.reshape(rows, d).to(dtype),
                                       self.gate_up_q,
                                       self.gate_up_scale.float())
            gate = self.gate_proj(x, y_base=gu[:, :inter].reshape(b, l, inter),
                                  drop=_at(drop, "gate_proj"))
            up = self.up_proj(x, y_base=gu[:, inter:].reshape(b, l, inter),
                              drop=_at(drop, "up_proj"))
        else:
            g_mid, u_mid = _grouped_mids(self.lora, x,
                                         (self.gate_proj, self.up_proj),
                                         _at(drop, "gate_up"))
            gate = self.gate_proj(x, g_mid, drop=_at(drop, "gate_proj"))
            up = self.up_proj(x, u_mid, drop=_at(drop, "up_proj"))
        return self.down_proj(F.silu(gate) * up, drop=_at(drop, "down_proj"))


class Qwen3Layer(nn.Module):
    def __init__(self, config: Qwen3Config, lora: Optional[LoRAConfig] = None,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                                       **kw)
        self.self_attn = Qwen3Attention(config, lora, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = Qwen3MLP(config, lora, **kw)

    def forward(self, hidden, cos, sin, pad_mask,
                drop: Optional[DropoutStream] = None):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), cos,
                                         sin, pad_mask, _at(drop, "self_attn"))
        return hidden + self.mlp(self.post_attention_layernorm(hidden),
                                 _at(drop, "mlp"))


def _save_products(ctx, op, *args, **kwargs):
    """The "dots" remat policy: keep 2-D matrix products (the projections),
    recompute everything else, batched products included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class Qwen3Model(nn.Module):
    """Decoder stack -> final-norm hidden states [B, L, D].

    ``n_extra_tokens`` rows (``extra_embed_tokens``) follow the base
    vocabulary: id ``vocab_size + i`` reads extra row i.  ``remat`` and
    ``remat_policy`` ("dots" or None) rematerialise each layer in a training
    backward, as the JAX module's ``nn.remat``."""

    def __init__(self, config: Qwen3Config, lora: Optional[LoRAConfig] = None,
                 n_extra_tokens: int = 0, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        if remat_policy not in (None, "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        pkw = dict(device=device, dtype=param_dtype or dtype)
        self.config = config
        self.dtype = dtype
        self.remat, self.remat_policy = remat, remat_policy
        self.embed_tokens = nn.Parameter(
            torch.empty(config.vocab_size, config.hidden_size, **pkw))
        self.extra_embed_tokens = (
            nn.Parameter(torch.empty(n_extra_tokens, config.hidden_size,
                                     **pkw))
            if n_extra_tokens > 0 else None)
        self.layers = nn.ModuleList(
            Qwen3Layer(config, lora, **kw)
            for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings from the base table plus the extra rows (the JAX
        module's concatenated table, without materialising the concat), in
        the compute dtype."""
        vocab = self.config.vocab_size
        out = F.embedding(input_ids.clamp(max=vocab - 1),
                          self.embed_tokens).to(self.dtype)
        if self.extra_embed_tokens is not None:
            extra_ids = (input_ids - vocab).clamp(
                0, self.extra_embed_tokens.shape[0] - 1)
            extra = F.embedding(extra_ids,
                                self.extra_embed_tokens).to(self.dtype)
            out = torch.where((input_ids >= vocab)[..., None], extra, out)
        return out

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutStream] = None) -> torch.Tensor:
        """``dropout``: the training forward's stream (None: no dropout)."""
        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("need input_ids or inputs_embeds")
            inputs_embeds = self.embed(input_ids)
        b, l, _ = inputs_embeds.shape
        device = inputs_embeds.device
        position_ids = torch.arange(l, device=device)[None].expand(b, l)
        cos, sin = rotary_embedding(position_ids, self.config.head_dim,
                                    self.config.rope_theta, dtype=self.dtype)
        pad_mask = (attention_mask.float() if attention_mask is not None
                    else torch.ones(b, l, device=device))
        check_pad_mask(pad_mask)  # once per forward, for every layer
        hidden = inputs_embeds.to(self.dtype)
        remat = self.remat and self.training and torch.is_grad_enabled()
        context_fn = None
        if remat and self.remat_policy == "dots":
            context_fn = functools.partial(create_selective_checkpoint_contexts,
                                           _save_products)
        for i, layer in enumerate(self.layers):
            drop = _at(dropout, "layers", i)
            if not remat:
                hidden = layer(hidden, cos, sin, pad_mask, drop)
            elif context_fn is None:
                hidden = checkpoint(layer, hidden, cos, sin, pad_mask, drop,
                                    use_reentrant=False)
            else:
                hidden = checkpoint(layer, hidden, cos, sin, pad_mask, drop,
                                    use_reentrant=False, context_fn=context_fn)
        return self.norm(hidden)


def mean_pool(hidden: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None,
              masked: bool = False) -> torch.Tensor:
    """Mean over ALL positions, padding included (the reference joint
    model); ``masked=True`` gives the masked mean."""
    if masked and attention_mask is not None:
        m = attention_mask.to(hidden.dtype)[..., None]
        return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return hidden.mean(dim=1)


def last_token_pool(hidden: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
    """Last non-padding position (right padding)."""
    lengths = attention_mask.sum(dim=1).long() - 1
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), lengths]


# -- int8 (W8A8) weights --------------------------------------------------------

INT8_DENSE_NAMES = frozenset({"q_proj", "k_proj", "v_proj", "o_proj",
                              "gate_proj", "up_proj", "down_proj"})


def quantize_qwen3_weights(model_or_state_dict) -> Dict[str, torch.Tensor]:
    """The seven projections of every Qwen3 layer -> int8 weights, as
    ``unirec_tpu/models/qwen3.quantize_qwen3_weights``: each weight as
    stored, upcast to float32, quantized per output column (absmax / 127
    with a 1e-8 floor).  Returns ``{"<module>.weight_q": int8 [out, in],
    "<module>.weight_scale": float32 [out]}`` keyed by the module names of
    the model (or state_dict) given; LoRA, norms and embeddings are left
    out."""
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    out: Dict[str, torch.Tensor] = {}
    for key, w in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if (leaf == "weight" and prefix.rpartition(".")[2] in INT8_DENSE_NAMES
                and w.dim() == 2):
            out[prefix + ".weight_q"], out[prefix + ".weight_scale"] = (
                quantize_weight(w))
    return out


def set_qweights(model: nn.Module,
                 qweights: Optional[Dict[str, torch.Tensor]]) -> None:
    """Attach ``quantize_qwen3_weights``' output to ``model``'s projections
    (moved to each module's device), or detach all with ``None``.  Where
    q/k/v (gate/up) all have int8 weights they are stored once,
    concatenated, on the attention (MLP) module for B9a (B9b), and the
    projections read views of that buffer."""
    modules = dict(model.named_modules())
    for mod in modules.values():
        if isinstance(mod, LoRADense):
            mod.weight_q = mod.weight_scale = None
        elif isinstance(mod, Qwen3Attention):
            mod.qkv_q = mod.qkv_scale = None
        elif isinstance(mod, Qwen3MLP):
            mod.gate_up_q = mod.gate_up_scale = None
    for key, t in (qweights or {}).items():
        prefix, _, leaf = key.rpartition(".")
        mod = modules.get(prefix)
        if not isinstance(mod, LoRADense) or leaf not in ("weight_q",
                                                          "weight_scale"):
            raise KeyError(f"{key} names no projection of the model")
        setattr(mod, leaf, t.to(mod.weight.device))
    for mod in modules.values():
        if isinstance(mod, Qwen3Attention):
            _concat_qweights(mod, (mod.q_proj, mod.k_proj, mod.v_proj),
                             "qkv_q", "qkv_scale")
        elif isinstance(mod, Qwen3MLP):
            _concat_qweights(mod, (mod.gate_proj, mod.up_proj), "gate_up_q",
                             "gate_up_scale")


def _concat_qweights(owner: nn.Module, mods, codes: str, scales: str) -> None:
    if any(m.weight_q is None for m in mods):
        return
    q = torch.cat([m.weight_q for m in mods], dim=0)
    s = torch.cat([m.weight_scale for m in mods], dim=0)
    setattr(owner, codes, q)
    setattr(owner, scales, s)
    sizes = [m.weight_q.shape[0] for m in mods]
    for m, mq, ms in zip(mods, q.split(sizes), s.split(sizes)):
        m.weight_q, m.weight_scale = mq, ms
