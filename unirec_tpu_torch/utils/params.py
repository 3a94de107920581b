"""Parameter utilities (port of ``unirec_tpu/utils/params.py``): the joint
trainer's trainability mask, bf16 storage of the frozen base, merging and
pruning state_dicts, and folding trained LoRA adapters into the base weights.

The JAX package decides trainability by parameter path and stops the
frozen leaves' gradients (``jax.lax.stop_gradient``); the port applies the
same mask as ``requires_grad``, so autograd computes no weight gradient for
the frozen 0.6B base at all.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding

# a parameter trains when a segment of its name contains one of these
TRAINABLE_NAMES = ("lora_a", "lora_b", "extra_embed_tokens", "qformer")

ParamsLike = Union[nn.Module, Mapping[str, torch.Tensor]]


def _named(params: ParamsLike) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def is_trainable(name: str) -> bool:
    """Joint-training trainability of one parameter name: the LoRA adapters,
    the extra (special-token) embedding rows and the whole Q-Former."""
    return any(needle in part for part in name.split(".")
               for needle in TRAINABLE_NAMES)


def lora_trainable_mask(params: ParamsLike) -> Dict[str, bool]:
    """{name: trainable} over a module's parameters or a state_dict."""
    return {name: is_trainable(name) for name in _named(params)}


def apply_trainable_mask(model: nn.Module) -> int:
    """``requires_grad`` = the mask for every parameter; returns the number
    of trainable elements."""
    n = 0
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name))
        n += p.numel() if p.requires_grad else 0
    return n


@torch.no_grad()
def cast_frozen_to_bf16(model: nn.Module) -> nn.Module:
    """Store the frozen floating parameters in bfloat16, in place: free
    under bf16 compute, where every weight is cast at use, and half the
    frozen base's memory.  Trainable parameters keep their (fp32) masters;
    integer tensors are untouched."""
    for name, p in model.named_parameters():
        if not is_trainable(name) and p.is_floating_point():
            p.data = p.data.to(torch.bfloat16)
    return model


def merge_params(template: Mapping[str, torch.Tensor],
                 loaded: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``template`` with the entries of ``loaded`` written over it; an entry
    only ``loaded`` has raises (a conversion or config mismatch)."""
    out = dict(template)
    for key, value in loaded.items():
        if key not in template:
            raise KeyError(f"loaded param {key!r} not in model structure")
        out[key] = value
    return out


def prune_to_structure(tree: Mapping[str, torch.Tensor],
                       template: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Only the entries ``template`` has (a converted checkpoint may carry
    parameters the query-only modules never create)."""
    return {key: tree[key] for key in template}


def merge_lora_weights(state_dict: Mapping[str, torch.Tensor],
                       scaling: float) -> Dict[str, torch.Tensor]:
    """PEFT's ``merge_and_unload`` over a port state_dict: wherever a module
    holds ``weight`` + ``lora_a`` + ``lora_b``, ``weight + (A @ B)^T *
    scaling`` accumulated in float32 and stored in the weight's dtype, and
    the adapter entries dropped.  Every other entry is the same tensor, not
    a copy (``unirec_tpu/utils/params.merge_lora_weights``; the port's weight
    is the ``[out, in]`` transpose of the Flax kernel)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf in ("lora_a", "lora_b"):
            continue
        a = state_dict.get(prefix + ".lora_a")
        b = state_dict.get(prefix + ".lora_b")
        if leaf == "weight" and a is not None and b is not None:
            delta = (a.float() @ b.float()) * scaling  # [in, out]
            value = (value.float() + delta.t()).to(value.dtype)
        out[key] = value
    return out


def merged_model(model: MultiModalQwenEmbedding) -> MultiModalQwenEmbedding:
    """The ``lora=None`` joint model over ``merge_lora_weights`` of
    ``model``'s weights (the merged projections are new tensors, the rest is
    shared); ``model`` itself is left as it is.  A model without LoRA is
    returned as it is."""
    if model.lora is None:
        return model
    merged = merge_lora_weights(model.state_dict(), model.lora.scaling)
    return model.clone(merged, lora=None)
