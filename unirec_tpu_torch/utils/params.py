"""Parameter utilities (port of ``unirec_tpu/utils/params.py``, the
deployment part): folding trained LoRA adapters into the base weights.

The LoRA mask, ``cast_frozen_to_bf16`` and the rest arrive with the training
slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding


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
