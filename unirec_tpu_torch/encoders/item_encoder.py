"""ItemEncoder: multimodal field-encoder orchestration (port of
``unirec_tpu/encoders/item_encoder.py``, numpy in and out as there).

Rebuild of reference models/item_encoder_pure_value.py:

* text/category fields -> text backend (Qwen3-Embedding, 1024-d);
* image fields -> image backend (CLIP ViT-L, 768-d **zero-padded to 1024**,
  reference :161-163, 255-257);
* number fields -> MWNE, L2-normalized (reference :271-306);
* empty text -> zero embedding (reference :80-82, 91-97); image failures ->
  zero embedding (reference :167-170); invalid numbers -> encode 0.0
  (reference :295-301);
* fields missing from the schema -> zeros with a warning (reference :373-377).

The batched ``encode_batch_by_field`` is the cache-precompute workhorse
(consumed by ``data/cache.build_cache``).  Without backends it uses the hash
text and image backends and the MWNE number backend on ``device`` (default
the CPU).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from unirec_tpu_torch.configs import FieldSchema
from unirec_tpu_torch.encoders.backends import (
    HashImageBackend,
    HashTextBackend,
    ImageBackend,
    MWNENumberBackend,
    NumberBackend,
    TextBackend,
)


class ItemEncoder:
    def __init__(
        self,
        schema: Optional[FieldSchema] = None,
        text_backend: Optional[TextBackend] = None,
        image_backend: Optional[ImageBackend] = None,
        number_backend: Optional[NumberBackend] = None,
        embedding_dim: int = 1024,
        config_path: Optional[str] = None,
        device=None,
    ):
        if config_path is not None:
            schema = FieldSchema.from_yaml(config_path)
        self.schema = schema or FieldSchema()
        self.field_mapping = self.schema.as_dict()
        self.embedding_dim = embedding_dim
        self.text_backend = text_backend or HashTextBackend(embedding_dim)
        self.image_backend = image_backend or HashImageBackend(768)
        self.number_backend = number_backend or MWNENumberBackend(
            device=device)

    # -- helpers -----------------------------------------------------------

    def _pad(self, emb: np.ndarray) -> np.ndarray:
        """Zero-pad last dim to embedding_dim (reference :163, 257)."""
        d = emb.shape[-1]
        if d == self.embedding_dim:
            return emb
        if d > self.embedding_dim:
            raise ValueError(f"backend dim {d} > embedding_dim {self.embedding_dim}")
        pad = np.zeros((*emb.shape[:-1], self.embedding_dim - d), emb.dtype)
        return np.concatenate([emb, pad], axis=-1)

    def _encode_text_batch(self, texts: Sequence[Any]) -> np.ndarray:
        """Empty/blank values get zero embeddings (reference :88-97)."""
        out = np.zeros((len(texts), self.embedding_dim), np.float32)
        valid = [
            i for i, t in enumerate(texts) if t is not None and str(t).strip()
        ]
        if valid:
            emb = self.text_backend.encode([str(texts[i]) for i in valid])
            emb = self._pad(np.asarray(emb, np.float32))
            for j, i in enumerate(valid):
                out[i] = emb[j]
        return out

    def _encode_image_batch(self, refs: Sequence[Any]) -> np.ndarray:
        """Empty/None refs -> zero embeddings (reference :188-190, 336-339)."""
        out = np.zeros((len(refs), self.embedding_dim), np.float32)
        valid = [
            i for i, r in enumerate(refs) if r is not None and str(r).strip()
        ]
        if valid:
            emb = self.image_backend.encode([refs[i] for i in valid])
            emb = self._pad(np.asarray(emb, np.float32))
            for j, i in enumerate(valid):
                out[i] = emb[j]
        return out

    def _encode_number_batch(self, numbers: Sequence[Any]) -> np.ndarray:
        emb = self.number_backend.encode(list(numbers))
        return self._pad(np.asarray(emb, np.float32))

    # -- public API (reference :308-409) -----------------------------------

    def encode_batch_by_field(
        self, samples: Sequence[Dict[str, Any]], fields_to_encode: Sequence[str]
    ) -> Dict[str, np.ndarray]:
        if not samples:
            return {f: np.zeros((0, self.embedding_dim)) for f in fields_to_encode}
        out: Dict[str, np.ndarray] = {}
        for field in fields_to_encode:
            info = self.field_mapping.get(field)
            values = [s.get(field, "") for s in samples]
            if info is None:
                out[field] = np.zeros(
                    (len(samples), self.embedding_dim), np.float32
                )
                continue
            modality = info[2]
            if modality in ("text", "category"):
                out[field] = self._encode_text_batch(values)
            elif modality == "image":
                out[field] = self._encode_image_batch(values)
            elif modality == "number":
                out[field] = self._encode_number_batch(values)
            else:
                raise ValueError(f"unknown modality {modality} for {field}")
        return out

    def encode_sample(self, sample: Dict[str, Any]) -> Dict[str, np.ndarray]:
        by_field = self.encode_batch_by_field(
            [sample], [name for name, _ in self.schema.mapping]
        )
        return {f: emb[0] for f, emb in by_field.items()}

    def encode_batch(
        self, samples: Sequence[Dict[str, Any]]
    ) -> List[Dict[str, np.ndarray]]:
        fields = [name for name, _ in self.schema.mapping]
        by_field = self.encode_batch_by_field(samples, fields)
        return [
            {f: by_field[f][i] for f in fields} for i in range(len(samples))
        ]

    def get_embedding_dimensions(self) -> Dict[str, int]:
        return {name: self.embedding_dim for name, _ in self.schema.mapping}

    # -- single-value helpers (used by QFormerInference raw path) ----------

    def _encode_text(self, text: str) -> np.ndarray:
        return self._encode_text_batch([text])[0]

    def _encode_image(self, ref: str) -> np.ndarray:
        return self._encode_image_batch([ref])[0]

    def _encode_number(self, number: float) -> np.ndarray:
        return self._encode_number_batch([number])[0]
