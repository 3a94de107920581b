"""Field-encoder backends (port of part of ``unirec_tpu/encoders/backends.py``).

Each backend has a batched numpy-in / numpy-out ``encode`` that the
``ItemEncoder`` orchestrates:

* ``HashTextBackend`` / ``HashImageBackend``: deterministic pseudo-embeddings
  keyed by content, numpy only, bit for bit the JAX package's (for tests and
  weightless environments);
* ``MWNENumberBackend``: the math-aware number encoder
  (``models/mwne.NormalizedMathematicalEncoder`` in eval mode), then L2
  normalisation; ``from_reference_checkpoint`` reads the reference's trained
  ``.pth``.

The Qwen3 text and CLIP image backends wait for ROADMAP.md A8.
"""

from __future__ import annotations

import hashlib
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from unirec_tpu_torch.configs import MWNEConfig
from unirec_tpu_torch.models.mwne import load_mwne


class TextBackend:
    dim: int

    def encode(self, texts: Sequence[str]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class ImageBackend:
    dim: int

    def encode(self, images: Sequence[Any]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class NumberBackend:
    dim: int

    def encode(self, numbers: Sequence[float]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


def _l2_normalize_np(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


class HashTextBackend(TextBackend):
    """Deterministic pseudo-embeddings keyed by text content."""

    def __init__(self, dim: int = 1024):
        self.dim = dim

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            seed = int(hashlib.md5(str(t).encode()).hexdigest()[:8], 16)
            out[i] = np.random.RandomState(seed).randn(self.dim)
        return _l2_normalize_np(out)


class HashImageBackend(ImageBackend):
    """Deterministic pseudo-embeddings keyed by image reference (URL/path)."""

    def __init__(self, dim: int = 768):
        self.dim = dim

    def encode(self, images: Sequence[Any]) -> np.ndarray:
        out = np.zeros((len(images), self.dim), np.float32)
        for i, ref in enumerate(images):
            seed = int(hashlib.md5(str(ref).encode()).hexdigest()[:8], 16)
            out[i] = np.random.RandomState(seed ^ 0xBEEF).randn(self.dim)
        return _l2_normalize_np(out)


class MWNENumberBackend(NumberBackend):
    """Normalized math-aware number encoder + L2 normalisation
    (reference: models/item_encoder_pure_value.py:290-306).

    ``state_dict``: the encoder's weights and running statistics (e.g.
    ``utils/weights.mwne_state_dict_from_flax``); without one the weights
    are drawn from ``seed`` with the Flax initialisers' distributions (not
    the JAX package's bits: another generator).  The encoder is a few
    elementwise products per number; it runs on ``device`` (default the
    CPU, where the cache precompute's numpy batches live)."""

    def __init__(self, config: Optional[MWNEConfig] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None, seed: int = 0):
        self.config = config or MWNEConfig()
        self.dim = self.config.embedding_dim
        self.device = torch.device(device or "cpu")
        self.model = load_mwne(self.config, state_dict, device=self.device,
                               seed=seed)

    @classmethod
    def from_reference_checkpoint(cls, path: str, device=None
                                  ) -> "MWNENumberBackend":
        """Load the reference's trained number-encoder checkpoint
        (number_encoders/mathematical_encoder_1024d_normalized.pth;
        reference: models/item_encoder_pure_value.py:68-70, schema
        models/mwne.py:784-806)."""
        from unirec_tpu_torch.utils.torch_convert import (
            load_reference_mwne_checkpoint,
        )
        from unirec_tpu_torch.utils.weights import mwne_state_dict_from_flax

        cfg, variables = load_reference_mwne_checkpoint(path)
        return cls(cfg, mwne_state_dict_from_flax(variables), device=device)

    @torch.no_grad()
    def encode(self, numbers: Sequence[float]) -> np.ndarray:
        # invalid values encode as 0.0 (reference :295-301)
        clean = []
        for x in numbers:
            try:
                clean.append(float(x))
            except (TypeError, ValueError):
                clean.append(0.0)
        x = torch.tensor(clean, dtype=torch.float32, device=self.device)
        emb = self.model(x, train=False).cpu().numpy().astype(np.float32)
        return _l2_normalize_np(emb)
