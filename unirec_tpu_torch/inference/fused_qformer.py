"""The fused inference engine of the Item Q-Former (port of
``unirec_tpu/inference/fused_qformer.py``).

It runs the same parameters as ``models/item_qformer.ItemQFormer`` through
one block call per attention block and one per FFN and returns the query
tokens, the hot path of the item-token sweep.  Inference only.  Two
precisions, as in the JAX engine:

* ``bf16``: ``ops/fused_qformer_layer`` (kernels B1-B3 on the card, their
  plain versions on the CPU).  Weights in the engine dtype (bfloat16 on the
  card), every projection accumulated in fp32, softmax and LayerNorm in fp32,
  tanh gelu in bfloat16 and exact erf in fp32.
* ``int8`` (W8A8): ``ops/fused_qformer_int8`` (kernels B4-B6).  Every
  projection weight is rounded to the engine dtype and then quantized per
  output column (``quantize_weight``); activations are quantized per row in
  the blocks.

Either way biases and LayerNorm parameters are held as float32 tensors whose
values are rounded to the engine dtype, which is what the JAX engine computes
with (it casts them to the engine dtype and the kernels read them back as
fp32).
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Union

import torch
from torch import nn

from unirec_tpu_torch.configs import ItemQFormerConfig
from unirec_tpu_torch.ops import fused_qformer_int8 as ops_q
from unirec_tpu_torch.ops import fused_qformer_layer as ops
from unirec_tpu_torch.ops.fused_qformer_layer import NEG_INF, ffn_chunk_size


@dataclasses.dataclass
class FusedLayerParams:
    """One layer's weights, packed for the blocks: ``[out, in]`` matrices
    (Wq|Wk|Wv and Wk|Wv stacked by rows) in the engine dtype, or int8 with a
    float32 ``[out]`` scale each on the int8 engine; float32 vectors."""

    wqkv: torch.Tensor  # [3D, D]
    bqkv: torch.Tensor  # [3D]
    self_wo: torch.Tensor
    self_bo: torch.Tensor
    self_ln_g: torch.Tensor
    self_ln_b: torch.Tensor
    # cross-attention (None on layers without it)
    wq: Optional[torch.Tensor] = None
    bq: Optional[torch.Tensor] = None
    wkv: Optional[torch.Tensor] = None  # [2D, Dm]
    bkv: Optional[torch.Tensor] = None
    cross_wo: Optional[torch.Tensor] = None
    cross_bo: Optional[torch.Tensor] = None
    cross_ln_g: Optional[torch.Tensor] = None
    cross_ln_b: Optional[torch.Tensor] = None
    # query FFN
    w1: Optional[torch.Tensor] = None  # [I, D]
    b1: Optional[torch.Tensor] = None
    w2: Optional[torch.Tensor] = None  # [D, I]
    b2: Optional[torch.Tensor] = None
    ffn_ln_g: Optional[torch.Tensor] = None
    ffn_ln_b: Optional[torch.Tensor] = None
    # int8 per-output-column weight scales; None on the bf16 engine
    sqkv: Optional[torch.Tensor] = None
    self_so: Optional[torch.Tensor] = None
    sq: Optional[torch.Tensor] = None
    skv: Optional[torch.Tensor] = None
    cross_so: Optional[torch.Tensor] = None
    s1: Optional[torch.Tensor] = None
    s2: Optional[torch.Tensor] = None

    @property
    def has_cross(self) -> bool:
        return self.wq is not None

    @property
    def is_int8(self) -> bool:
        return self.sqkv is not None


@dataclasses.dataclass
class FusedQFormerParams:
    query_embeddings: torch.Tensor  # [1, K, D] in the engine dtype
    emb_ln_g: torch.Tensor
    emb_ln_b: torch.Tensor
    layers: List[FusedLayerParams]
    # [F, field_dim] when ItemQFormerConfig.use_field_type_embeddings
    field_id_embeddings: Optional[torch.Tensor] = None


def prepare_fused_params(
    params: Union[nn.Module, Mapping[str, torch.Tensor]],
    config: ItemQFormerConfig,
    dtype: torch.dtype = torch.bfloat16,
    precision: str = "bf16",
    device: Optional[Union[str, torch.device]] = None,
) -> FusedQFormerParams:
    """The port's ``ItemQFormer`` (or its ``state_dict``) -> packed engine
    weights on ``device`` (default: where the parameters are), once.

    ``precision="int8"`` quantizes every projection and FFN weight per output
    column after rounding it to ``dtype``, as the JAX engine does."""
    if precision not in ("bf16", "int8"):
        raise ValueError(f"precision must be bf16 or int8, got {precision!r}")
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    if device is None:
        device = sd["query_embeddings"].device

    def mat(*names):  # matrices stacked by output rows, engine dtype
        return torch.cat([sd[n] for n in names]).to(device=device,
                                                    dtype=dtype).contiguous()

    def proj(*names):  # a projection: engine dtype, or (int8, scale)
        w = mat(*names)
        return ops_q.quantize_weight(w) if precision == "int8" else (w, None)

    def vec(*names):  # float32, with the values the engine dtype can hold
        return torch.cat([sd[n].reshape(-1) for n in names]).to(
            device=device, dtype=dtype).float().contiguous()

    layers = []
    for i in range(config.num_hidden_layers):
        p = f"qformer.encoder.layer.{i}."
        a = p + "attention."
        wqkv, sqkv = proj(a + "query.weight", a + "key.weight",
                          a + "value.weight")
        wo, so = proj(a + "output_dense.weight")
        layer = FusedLayerParams(
            wqkv=wqkv, sqkv=sqkv,
            bqkv=vec(a + "query.bias", a + "key.bias", a + "value.bias"),
            self_wo=wo, self_so=so,
            self_bo=vec(a + "output_dense.bias"),
            self_ln_g=vec(a + "output_LayerNorm.weight"),
            self_ln_b=vec(a + "output_LayerNorm.bias"),
        )
        c = p + "crossattention."
        if c + "query.weight" in sd:
            layer.wq, layer.sq = proj(c + "query.weight")
            layer.bq = vec(c + "query.bias")
            layer.wkv, layer.skv = proj(c + "key.weight", c + "value.weight")
            layer.bkv = vec(c + "key.bias", c + "value.bias")
            layer.cross_wo, layer.cross_so = proj(c + "output_dense.weight")
            layer.cross_bo = vec(c + "output_dense.bias")
            layer.cross_ln_g = vec(c + "output_LayerNorm.weight")
            layer.cross_ln_b = vec(c + "output_LayerNorm.bias")
        f = p + "ffn_query."
        layer.w1, layer.s1 = proj(f + "intermediate_dense.weight")
        layer.b1 = vec(f + "intermediate_dense.bias")
        layer.w2, layer.s2 = proj(f + "output_dense.weight")
        layer.b2 = vec(f + "output_dense.bias")
        layer.ffn_ln_g = vec(f + "output_LayerNorm.weight")
        layer.ffn_ln_b = vec(f + "output_LayerNorm.bias")
        layers.append(layer)

    e = "qformer.embeddings.LayerNorm."
    return FusedQFormerParams(
        query_embeddings=mat("query_embeddings"),
        emb_ln_g=vec(e + "weight"),
        emb_ln_b=vec(e + "bias"),
        layers=layers,
        field_id_embeddings=(mat("field_id_embeddings")
                             if "field_id_embeddings" in sd else None),
    )


def supports_fused(config: ItemQFormerConfig) -> bool:
    """The JAX engine's gate, answer for answer: K divides 256, heads split
    the hidden dim, and the FFN intermediate admits a lane-aligned chunk."""
    k = config.num_query_tokens
    return (
        k > 0
        and 256 % k == 0
        and config.hidden_size % config.num_attention_heads == 0
        and ffn_chunk_size(config.intermediate_size) > 0
    )


def _embedding_layer_norm(fused: FusedQFormerParams, eps: float
                          ) -> torch.Tensor:
    """LayerNorm of the query tokens in fp32 -> [1, K, D] in the engine
    dtype (every item starts from these same rows)."""
    h = fused.query_embeddings.float()
    mu = h.mean(dim=-1, keepdim=True)
    hc = h - mu
    var = (hc * hc).mean(dim=-1, keepdim=True)
    h = hc * torch.rsqrt(var + eps) * fused.emb_ln_g + fused.emb_ln_b
    return h.to(fused.query_embeddings.dtype)


def fused_qformer_forward(
    fused: FusedQFormerParams,
    config: ItemQFormerConfig,
    field_embeddings: torch.Tensor,  # [B, F, field_dim]
    attention_mask: Optional[torch.Tensor] = None,  # [B, F], 1 = present
    *,
    plain: bool = False,
) -> torch.Tensor:
    """[B, F, field_dim] field embeddings -> [B, K, hidden] query tokens.

    The query path of ``ItemQFormer`` without the reconstruction heads, on
    the bf16 or the int8 blocks as ``fused`` was packed.  ``plain=True`` runs
    the blocks' plain versions on any device (the reference the card's engine
    is held against).
    """
    cfg = config.qformer() if hasattr(config, "qformer") else config
    b, f = field_embeddings.shape[:2]
    heads, eps = cfg.num_attention_heads, cfg.layer_norm_eps
    k = config.num_query_tokens
    dtype = fused.query_embeddings.dtype
    device = fused.query_embeddings.device
    if attention_mask is None:
        attention_mask = torch.ones(b, f, device=device)
    key_bias = ((1.0 - attention_mask.to(device, torch.float32)) * NEG_INF
                ).contiguous()
    mem = field_embeddings.to(device, dtype)
    if fused.field_id_embeddings is not None:
        # field-id conditioning, added after the cast (models/item_qformer.py)
        mem = mem + fused.field_id_embeddings[None]
    mem = mem.contiguous()

    int8 = bool(fused.layers) and fused.layers[0].is_int8
    mod = ops_q if int8 else ops
    suffix = ("_q" if int8 else "") + ("_plain" if plain else "")
    self_block = getattr(mod, "fused_self_attention_block" + suffix)
    cross_block = getattr(mod, "fused_cross_attention_block" + suffix)
    ffn_block = getattr(mod, "fused_ffn_block" + suffix)

    def scaled(w, s):  # an int8 weight travels with its column scales
        return (w, s) if int8 else (w,)

    h = _embedding_layer_norm(fused, eps)  # [1, K, D]
    for li, layer in enumerate(fused.layers):
        h = self_block(h, *scaled(layer.wqkv, layer.sqkv), layer.bqkv,
                       *scaled(layer.self_wo, layer.self_so), layer.self_bo,
                       layer.self_ln_g, layer.self_ln_b, num_heads=heads,
                       n_q=k, ln_eps=eps)
        if li == 0:
            # every item enters with the same query rows, so layer 0's self
            # block ran on one item; broadcasting it is exact
            h = h.expand(b, -1, -1).contiguous()
        if layer.has_cross:
            h = cross_block(h, mem, key_bias, *scaled(layer.wq, layer.sq),
                            layer.bq, *scaled(layer.wkv, layer.skv), layer.bkv,
                            *scaled(layer.cross_wo, layer.cross_so),
                            layer.cross_bo, layer.cross_ln_g, layer.cross_ln_b,
                            num_heads=heads, n_q=k, n_kv=f, ln_eps=eps)
        h = ffn_block(h, *scaled(layer.w1, layer.s1), layer.b1,
                      *scaled(layer.w2, layer.s2), layer.b2, layer.ffn_ln_g,
                      layer.ffn_ln_b, ln_eps=eps)
    return h.expand(b, -1, -1)
