"""CLIP vision and text towers (port of ``unirec_tpu/models/clip.py``).

The image encoder of the item fields (ViT-L/14, reference:
models/item_encoder_pure_value.py:53-61) and the CLIP text tower of the
candidate-embedding stage (reference: data_processing/item_embedding_clip.py:
56-58).  OpenAI CLIP: pre-LN transformer, quick-gelu, class-token vision
pooling, causal text attention pooled at the end-of-text token, projections
without bias into the shared space.

The JAX package runs CLIP attention as XLA einsum + softmax (no Pallas
kernel), and so does the port, in plain torch on the same arithmetic: the
scores in float32 (the products of the compute-dtype q and k summed in
float32), the additive ``-1e9`` causal / padding bias, a float32 softmax
whose probabilities are cast to the compute dtype before ``P·V`` (summed in
float32 and cast back).  Below float32 both products run on TF32 tensor
cores, which hold every such operand exactly.  LayerNorms take float32 statistics and parameters; the
rest computes in ``dtype`` from parameters stored in ``param_dtype`` (default
``dtype``).

Parameter names mirror the Flax tree (``layer.{i}`` for ``layer_{i}``), so
``utils/weights.clip_state_dict_from_flax`` maps a JAX tree onto a tower.
Two leaves need more than the Dense rule: the patch convolution (Flax
``Conv`` kernel ``[kh, kw, in, out]`` on NHWC pixels, torch ``Conv2d``
weight ``[out, in, kh, kw]`` on NCHW) and the text tower's token table (Flax
``Embed.embedding``, torch ``Embedding.weight``).  ``class_embedding`` and
``position_embedding`` are raw parameters, as in Flax.

``preprocess_image`` and the HF converters ``convert_clip_vision`` /
``convert_clip_text`` (HF state_dict -> the Flax-layout numpy tree) are the
JAX module's, numpy only; PIL is imported where an image is preprocessed.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unirec_tpu_torch.models.qformer import LayerNorm, Linear


@dataclass(frozen=True)
class CLIPVisionConfig:
    """Defaults: ViT-L/14 (the item-encoder tower)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    # HF pools at the first eos_token_id position; eos_token_id=None falls
    # back to the original OpenAI argmax-of-ids convention.
    eos_token_id: Optional[int] = 49407


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


@contextlib.contextmanager
def _tf32_products(on: bool):
    """cuBLAS float32 products on TF32 tensor cores while ``on``; the
    process-wide setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on or prev
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.num_heads = num_heads
        self.dtype = dtype
        self.q_proj = Linear(hidden_size, hidden_size, **kw)
        self.k_proj = Linear(hidden_size, hidden_size, **kw)
        self.v_proj = Linear(hidden_size, hidden_size, **kw)
        self.out_proj = Linear(hidden_size, hidden_size, **kw)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, d = x.shape
        h = self.num_heads
        hd = d // h

        def heads(t):  # [B, L, D] -> [B, H, L, hd], as float32 operands
            return t.reshape(b, l, h, hd).transpose(1, 2).float()

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(
            self.v_proj(x))
        # compute-dtype values multiplied and summed in float32 (the einsum's
        # preferred_element_type).  A bf16 or fp16 value is exact in TF32 and
        # so is the product of two, so below float32 the two products run on
        # TF32 tensor cores with float32 sums: the same products as exact
        # float32, in another order of summation.
        with _tf32_products(self.dtype != torch.float32):
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
            if bias is not None:
                scores = scores + bias.float()
            probs = torch.softmax(scores, dim=-1).to(self.dtype)
            ctx = torch.matmul(probs.float(), v).to(self.dtype)
        return self.out_proj(ctx.transpose(1, 2).reshape(b, l, d))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_heads: int, eps: float, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.layer_norm1 = LayerNorm(hidden_size, eps, **kw)
        self.self_attn = CLIPAttention(hidden_size, num_heads, **kw)
        self.layer_norm2 = LayerNorm(hidden_size, eps, **kw)
        self.fc1 = Linear(hidden_size, intermediate_size, **kw)
        self.fc2 = Linear(intermediate_size, hidden_size, **kw)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class CLIPVisionTower(nn.Module):
    """pixel_values [B, H, W, 3] (NHWC, as ``preprocess_image`` makes them)
    -> projected image embeddings [B, projection_dim] in ``dtype`` (HF
    ``get_image_features``)."""

    def __init__(self, config: CLIPVisionConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        pkw = dict(device=device, dtype=param_dtype or dtype)
        self.config, self.dtype = config, dtype
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size,
                                         stride=c.patch_size, bias=False,
                                         **pkw)
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden_size, **pkw))
        self.position_embedding = nn.Parameter(
            torch.zeros(c.num_patches + 1, c.hidden_size, **pkw))
        self.pre_layrnorm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.layer = nn.ModuleList(
            CLIPEncoderLayer(c.hidden_size, c.intermediate_size,
                             c.num_attention_heads, c.layer_norm_eps, **kw)
            for _ in range(c.num_hidden_layers))
        self.post_layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.visual_projection = Linear(c.hidden_size, c.projection_dim,
                                        bias=False, **kw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = pixel_values.shape[0]
        x = pixel_values.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW
        # [B, D, H/p, W/p] -> [B, patches, D] in (row, column) order
        patches = F.conv2d(x, self.patch_embedding.weight.to(dt),
                           stride=self.patch_embedding.stride)
        patches = patches.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding.to(dt)
        x = self.pre_layrnorm(x)
        for layer in self.layer:
            x = layer(x)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


class CLIPTextTower(nn.Module):
    """input_ids [B, L] (and a [B, L] padding mask) -> projected text
    embeddings [B, projection_dim] in ``dtype``: causal attention, pooled at
    the first ``eos_token_id`` of each row (the highest id where the config
    has none, OpenAI's convention)."""

    def __init__(self, config: CLIPTextConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        pkw = dict(device=device, dtype=param_dtype or dtype)
        self.config, self.dtype = config, dtype
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size, **pkw)
        self.position_embedding = nn.Parameter(
            torch.zeros(c.max_position_embeddings, c.hidden_size, **pkw))
        self.layer = nn.ModuleList(
            CLIPEncoderLayer(c.hidden_size, c.intermediate_size,
                             c.num_attention_heads, c.layer_norm_eps, **kw)
            for _ in range(c.num_hidden_layers))
        self.final_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                          **kw)
        self.text_projection = Linear(c.hidden_size, c.projection_dim,
                                      bias=False, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        c, dt = self.config, self.dtype
        b, l = input_ids.shape
        ids = input_ids.long()
        x = (self.token_embedding(ids).to(dt)
             + self.position_embedding[:l].to(dt))
        allowed = torch.ones(l, l, device=ids.device).tril()[None, None]
        if attention_mask is not None:
            allowed = allowed * attention_mask.float()[:, None, None, :]
        bias = (1.0 - allowed) * -1e9
        for layer in self.layer:
            x = layer(x, bias)
        x = self.final_layer_norm(x)
        if c.eos_token_id is not None:  # the first eos (HF)
            eot = (ids == c.eos_token_id).int().argmax(dim=-1)
        else:  # the highest id (OpenAI)
            eot = ids.argmax(dim=-1)
        pooled = x[torch.arange(b, device=ids.device), eot]
        return self.text_projection(pooled)


# ---------------------------------------------------------------------------
# Image preprocessing (host side; the CLIPProcessor equivalent)
# ---------------------------------------------------------------------------

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_image(image, image_size: int = 224) -> np.ndarray:
    """PIL image -> [H, W, 3] float32 (resize shortest side, center crop,
    CLIP normalize)."""
    from PIL import Image

    w, h = image.size
    scale = image_size / min(w, h)
    image = image.resize(
        (max(1, round(w * scale)), max(1, round(h * scale))), Image.BICUBIC
    )
    w, h = image.size
    left = (w - image_size) // 2
    top = (h - image_size) // 2
    image = image.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(image.convert("RGB"), np.float32) / 255.0
    return (arr - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD


# ---------------------------------------------------------------------------
# HF weight conversion (HF state_dict -> the Flax-layout numpy tree)
# ---------------------------------------------------------------------------


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _layers(get, lin, ln, n: int) -> Dict[str, Any]:
    out = {}
    for i in range(n):
        lp = f"encoder.layers.{i}"
        out[f"layer_{i}"] = {
            "self_attn": {
                "q_proj": lin(f"{lp}.self_attn.q_proj"),
                "k_proj": lin(f"{lp}.self_attn.k_proj"),
                "v_proj": lin(f"{lp}.self_attn.v_proj"),
                "out_proj": lin(f"{lp}.self_attn.out_proj"),
            },
            "layer_norm1": ln(f"{lp}.layer_norm1"),
            "layer_norm2": ln(f"{lp}.layer_norm2"),
            "fc1": lin(f"{lp}.mlp.fc1"),
            "fc2": lin(f"{lp}.mlp.fc2"),
        }
    return out


def _readers(sd: Mapping[str, Any], prefixes):
    def get(k: str):
        for prefix in prefixes:
            if prefix + k in sd:
                return _np(sd[prefix + k])
        raise KeyError(k)

    def lin(prefix: str) -> Dict:
        out = {"kernel": get(prefix + ".weight").T}
        try:
            out["bias"] = get(prefix + ".bias")
        except KeyError:
            pass
        return out

    def ln(prefix: str) -> Dict:
        return {"scale": get(prefix + ".weight"), "bias": get(prefix + ".bias")}

    return get, lin, ln


def convert_clip_vision(sd: Mapping[str, Any], config: CLIPVisionConfig) -> Dict:
    """HF CLIPModel (or CLIPVisionModelWithProjection) state_dict -> the
    Flax-layout tree of the vision tower."""
    get, lin, ln = _readers(sd, ("vision_model.", "clip.vision_model.", ""))
    params: Dict[str, Any] = {
        # HF conv weight [out, in, kh, kw] -> flax [kh, kw, in, out]
        "patch_embedding": {
            "kernel": get("embeddings.patch_embedding.weight").transpose(2, 3, 1, 0)
        },
        "class_embedding": get("embeddings.class_embedding"),
        "position_embedding": get("embeddings.position_embedding.weight"),
        "pre_layrnorm": ln("pre_layrnorm"),
        "post_layernorm": ln("post_layernorm"),
    }
    if "visual_projection.weight" in sd:
        params["visual_projection"] = {
            "kernel": _np(sd["visual_projection.weight"]).T
        }
    params.update(_layers(get, lin, ln, config.num_hidden_layers))
    return params


def convert_clip_text(sd: Mapping[str, Any], config: CLIPTextConfig) -> Dict:
    """HF CLIPModel (or CLIPTextModelWithProjection) state_dict -> the
    Flax-layout tree of the text tower."""
    get, lin, ln = _readers(sd, ("text_model.", ""))
    params: Dict[str, Any] = {
        "token_embedding": {"embedding": get("embeddings.token_embedding.weight")},
        "position_embedding": get("embeddings.position_embedding.weight"),
        "final_layer_norm": ln("final_layer_norm"),
    }
    if "text_projection.weight" in sd:
        params["text_projection"] = {"kernel": _np(sd["text_projection.weight"]).T}
    params.update(_layers(get, lin, ln, config.num_hidden_layers))
    return params


def vision_config_from_hf(hf_config) -> CLIPVisionConfig:
    """A transformers ``CLIPConfig`` -> the vision tower's config."""
    vc = hf_config.vision_config
    return CLIPVisionConfig(
        hidden_size=vc.hidden_size, intermediate_size=vc.intermediate_size,
        num_hidden_layers=vc.num_hidden_layers,
        num_attention_heads=vc.num_attention_heads,
        image_size=vc.image_size, patch_size=vc.patch_size,
        projection_dim=hf_config.projection_dim)


def text_config_from_hf(hf_config) -> CLIPTextConfig:
    """A transformers ``CLIPConfig`` -> the text tower's config."""
    tc = hf_config.text_config
    return CLIPTextConfig(
        vocab_size=tc.vocab_size, hidden_size=tc.hidden_size,
        intermediate_size=tc.intermediate_size,
        num_hidden_layers=tc.num_hidden_layers,
        num_attention_heads=tc.num_attention_heads,
        max_position_embeddings=tc.max_position_embeddings,
        projection_dim=hf_config.projection_dim,
        eos_token_id=tc.eos_token_id)
