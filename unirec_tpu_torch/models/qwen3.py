"""Qwen3 dense decoder with LoRA overlays (port of
``unirec_tpu/models/qwen3.py``), deterministic forward.

Pre-RMSNorm layers, grouped-query attention with per-head q/k RMSNorm before
rotary embeddings (rotate-half, theta 1e6), SwiGLU MLP, and an extra block of
embedding rows after the base vocabulary for the joint model's special
tokens.  Self-attention goes through ``ops/flash_causal.flash_causal_attention``:
the hand-written CUDA kernel for CUDA tensors, its plain version (the JAX
additive-mask path) for CPU tensors.

Parameter names follow the Flax tree (``layers.{i}`` for ``layers_{i}``);
RMSNorm scales stay float32 as in Flax, everything else is stored in the
model dtype.  ``lora_a [in, r]`` and ``lora_b [r, out]`` keep the Flax layout.
The int8 ``qweights`` and ``y_base`` branches wait for the int8 slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unirec_tpu.configs import LoRAConfig, Qwen3Config
from unirec_tpu_torch.ops.flash_causal import flash_causal_attention


class RMSNorm(nn.Module):
    """Computed in float32 and cast back to the model dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype: torch.dtype = torch.float32):
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
    ``[..., r]`` slice.  At inference both forms are the same maths."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False,
                 lora: Optional[LoRAConfig] = None, lora_enabled: bool = False,
                 *, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(features, device=device,
                                              dtype=dtype))
                     if use_bias else None)
        self.lora_a = self.lora_b = None
        self.scaling = 0.0
        if lora_enabled and lora is not None:
            self.lora_a = nn.Parameter(
                torch.empty(in_features, lora.r, device=device, dtype=dtype))
            self.lora_b = nn.Parameter(
                torch.zeros(lora.r, features, device=device, dtype=dtype))
            self.scaling = lora.scaling

    def forward(self, x: torch.Tensor,
                lora_mid: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = F.linear(x, self.weight, self.bias)
        if self.lora_a is not None:
            mid = lora_mid if lora_mid is not None else x @ self.lora_a
            y = y + (mid @ self.lora_b) * self.scaling
        return y


def _lora_on(lora: Optional[LoRAConfig], name: str) -> bool:
    return lora is not None and name in lora.target_modules


def _grouped_mids(lora: Optional[LoRAConfig], x: torch.Tensor,
                  mods) -> Tuple[Optional[torch.Tensor], ...]:
    """Grouped overlay: one [D, n*r] lora_a matmul for modules sharing x."""
    if (lora is None or not lora.grouped
            or any(m.lora_a is None for m in mods)):
        return (None,) * len(mods)
    mid = x @ torch.cat([m.lora_a for m in mods], dim=1)
    return tuple(mid.split(lora.r, dim=-1))


class Qwen3Attention(nn.Module):
    def __init__(self, config: Qwen3Config, lora: Optional[LoRAConfig] = None,
                 *, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype)

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

    def qkv(self, hidden: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Merged-head attention inputs: q [B, L, Hq*hd] and k [B, L, Hkv*hd]
        after the per-head RMSNorm and RoPE, and v [B, L, Hkv*hd]."""
        c = self.config
        b, l, _ = hidden.shape
        mods = (self.q_proj, self.k_proj, self.v_proj)
        q_mid, k_mid, v_mid = _grouped_mids(self.lora, hidden, mods)
        q = self.q_proj(hidden, q_mid).reshape(b, l, c.num_attention_heads,
                                               c.head_dim)
        k = self.k_proj(hidden, k_mid).reshape(b, l, c.num_key_value_heads,
                                               c.head_dim)
        q = apply_rope(self.q_norm(q), cos, sin).reshape(b, l, c.q_size)
        k = apply_rope(self.k_norm(k), cos, sin).reshape(b, l, c.kv_size)
        return q, k, self.v_proj(hidden, v_mid).contiguous()

    def forward(self, hidden: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        c = self.config
        ctx = flash_causal_attention(*self.qkv(hidden, cos, sin), pad_mask,
                                     c.num_attention_heads,
                                     c.num_key_value_heads)
        return self.o_proj(ctx)


class Qwen3MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: Qwen3Config, lora: Optional[LoRAConfig] = None,
                 *, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, i = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.lora = lora
        self.gate_proj = LoRADense(d, i, lora=lora,
                                   lora_enabled=_lora_on(lora, "gate_proj"),
                                   **kw)
        self.up_proj = LoRADense(d, i, lora=lora,
                                 lora_enabled=_lora_on(lora, "up_proj"), **kw)
        self.down_proj = LoRADense(i, d, lora=lora,
                                   lora_enabled=_lora_on(lora, "down_proj"),
                                   **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g_mid, u_mid = _grouped_mids(self.lora, x,
                                     (self.gate_proj, self.up_proj))
        h = F.silu(self.gate_proj(x, g_mid)) * self.up_proj(x, u_mid)
        return self.down_proj(h)


class Qwen3Layer(nn.Module):
    def __init__(self, config: Qwen3Config, lora: Optional[LoRAConfig] = None,
                 *, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                                       **kw)
        self.self_attn = Qwen3Attention(config, lora, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = Qwen3MLP(config, lora, **kw)

    def forward(self, hidden, cos, sin, pad_mask):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), cos,
                                         sin, pad_mask)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class Qwen3Model(nn.Module):
    """Decoder stack -> final-norm hidden states [B, L, D].

    ``n_extra_tokens`` rows (``extra_embed_tokens``) follow the base
    vocabulary: id ``vocab_size + i`` reads extra row i."""

    def __init__(self, config: Qwen3Config, lora: Optional[LoRAConfig] = None,
                 n_extra_tokens: int = 0, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.dtype = dtype
        self.embed_tokens = nn.Parameter(
            torch.empty(config.vocab_size, config.hidden_size, **kw))
        self.extra_embed_tokens = (
            nn.Parameter(torch.empty(n_extra_tokens, config.hidden_size, **kw))
            if n_extra_tokens > 0 else None)
        self.layers = nn.ModuleList(
            Qwen3Layer(config, lora, **kw)
            for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings from the base table plus the extra rows (the JAX
        module's concatenated table, without materialising the concat)."""
        vocab = self.config.vocab_size
        out = F.embedding(input_ids.clamp(max=vocab - 1), self.embed_tokens)
        if self.extra_embed_tokens is not None:
            extra_ids = (input_ids - vocab).clamp(
                0, self.extra_embed_tokens.shape[0] - 1)
            extra = F.embedding(extra_ids, self.extra_embed_tokens)
            out = torch.where((input_ids >= vocab)[..., None], extra, out)
        return out

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        hidden = inputs_embeds.to(self.dtype)
        for layer in self.layers:
            hidden = layer(hidden, cos, sin, pad_mask)
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
