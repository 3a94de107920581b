"""Debugging aids (port of ``unirec_tpu/utils/debug.py``): NaN / Inf checks,
the eager-mode switch and attention-map capture.

The JAX package's NaN checks are ``jax_debug_nans`` / ``jax_debug_infs``;
here they are torch's own anomaly detection, which raises where a backward
produces NaN and names the forward op that made it.  ``eager_mode`` is a
no-op kept for the JAX package's interface: PyTorch runs eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Tuple

import torch

from unirec_tpu_torch.configs import QFormerConfig

# the kernel paths that never materialise the probabilities, and the
# layer recompute: all off for the capture pass
_OFF = ("fast_attention", "fused_training", "flash_training",
        "gradient_checkpointing")


def enable_nan_checks(enable: bool = True) -> None:
    """Raise where a backward produces NaN (``torch.autograd``'s anomaly
    detection, with its NaN check)."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


@contextlib.contextmanager
def nan_checks():
    """``enable_nan_checks`` over the block, then the previous setting."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


@contextlib.contextmanager
def eager_mode():
    """A no-op: PyTorch runs eagerly (the JAX package disables ``jit``)."""
    yield


def _jax_path(name: str) -> str:
    """``qformer.encoder.layer.0.attention`` ->
    ``qformer/encoder/layer_0/attention``, the Flax module path."""
    return re.sub(r"\b(layers?)\.(\d+)\b", r"\1_\2", name).replace(".", "/")


def capture_attention_maps(model: torch.nn.Module, *args, **kwargs
                           ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Run a Q-Former-family forward (``QFormerModel``, ``ItemQFormer``,
    ``UserQFormer``, the LM heads) and return ``(outputs, maps)``: ``maps``
    is ``{module path: [B, H, Lq, Lkv] float32 probabilities}``, the
    post-dropout probabilities of every attention module in layer order,
    keyed by the Flax module path (e.g.
    ``qformer/encoder/layer_0/crossattention``).

    For the pass every Q-Former config gets ``capture_attention_probs`` and
    loses the paths that never materialise probabilities (fused, flash,
    fast) and the layer recompute, as the JAX helper clones the model; the
    forward's numerics are the plain path's.  The configs are restored
    after."""
    from unirec_tpu_torch.models.qformer import QFormerAttention, QFormerEncoder

    saved = []
    for module in model.modules():
        cfg = getattr(module, "config", None)
        if isinstance(cfg, QFormerConfig):
            module.config = dataclasses.replace(
                cfg, capture_attention_probs=True, **dict.fromkeys(_OFF, False))
            saved.append((module, "config", cfg))
        if isinstance(module, QFormerEncoder):
            saved.append((module, "remat", module.remat))
            module.remat = False
    try:
        outputs = model(*args, **kwargs)
        maps = {_jax_path(name): module.captured_probs
                for name, module in model.named_modules()
                if isinstance(module, QFormerAttention)
                and module.captured_probs is not None}
    finally:
        for module, attr, value in saved:
            setattr(module, attr, value)
        for module in model.modules():
            if isinstance(module, QFormerAttention):
                module.captured_probs = None
    return outputs, maps
