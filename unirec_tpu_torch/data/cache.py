"""On-disk field-embedding cache (the port's copy of
``unirec_tpu/data/cache.py``; numpy only, same directory layout, so either
package reads the other's caches).

The reference caches per-item field embeddings as pickled torch dicts
(``embeddings.pt``/``masks.pt`` keyed by sample index, plus ``fields.json``
for validation; reference: models/qformer_utils.py:121-147).  This cache
stores one dense memory-mappable array pair instead:

  cache_dir/
    embeddings.npy   float32 [N, F, D]
    masks.npy        float32 [N, F]
    fields.json      ordered field list (cache-validity check)
    item_ids.json    item id per row

A compat loader ingests reference-format ``.pt`` caches.  ``build_cache``
precomputes a cache with an item encoder (``encoders/item_encoder.py``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class FieldEmbeddingCache:
    embeddings: np.ndarray  # [N, F, D]
    masks: np.ndarray  # [N, F]
    fields: List[str]
    item_ids: List[str]

    def __post_init__(self):
        self.id_to_row = {iid: i for i, iid in enumerate(self.item_ids)}

    def __len__(self) -> int:
        return self.embeddings.shape[0]

    @property
    def num_fields(self) -> int:
        return self.embeddings.shape[1]

    @property
    def embedding_dim(self) -> int:
        return self.embeddings.shape[2]

    def rows_for(self, item_ids: Sequence[str]) -> np.ndarray:
        """Row indices for item ids; -1 for unknown ids."""
        return np.asarray(
            [self.id_to_row.get(str(i), -1) for i in item_ids], np.int32
        )

    def gather(self, item_ids: Sequence[str]):
        """(embeddings [B,F,D], masks [B,F]) with zero rows for unknown ids
        (the reference's zero-embedding degradation semantics,
        train_item_individual_token_joint.py:569-575)."""
        rows = self.rows_for(item_ids)
        emb = np.where(
            (rows >= 0)[:, None, None],
            self.embeddings[np.clip(rows, 0, None)],
            0.0,
        ).astype(np.float32)
        mask = np.where(
            (rows >= 0)[:, None], self.masks[np.clip(rows, 0, None)], 0.0
        ).astype(np.float32)
        return emb, mask

    def save(self, cache_dir: str) -> None:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(os.path.join(cache_dir, "embeddings.npy"), self.embeddings)
        np.save(os.path.join(cache_dir, "masks.npy"), self.masks)
        with open(os.path.join(cache_dir, "fields.json"), "w") as f:
            json.dump(self.fields, f)
        with open(os.path.join(cache_dir, "item_ids.json"), "w") as f:
            json.dump(self.item_ids, f)

    @staticmethod
    def exists(cache_dir: str) -> bool:
        return all(
            os.path.exists(os.path.join(cache_dir, n))
            for n in ("embeddings.npy", "masks.npy", "fields.json", "item_ids.json")
        )

    @staticmethod
    def load(
        cache_dir: str,
        expected_fields: Optional[List[str]] = None,
        mmap: bool = True,
    ) -> "FieldEmbeddingCache":
        with open(os.path.join(cache_dir, "fields.json")) as f:
            fields = json.load(f)
        if expected_fields is not None and fields != expected_fields:
            # Field-list validation (reference: models/qformer_utils.py:126-139).
            raise ValueError(
                f"cache fields {fields} != expected {expected_fields}; recompute"
            )
        with open(os.path.join(cache_dir, "item_ids.json")) as f:
            item_ids = json.load(f)
        mode = "r" if mmap else None
        emb = np.load(os.path.join(cache_dir, "embeddings.npy"), mmap_mode=mode)
        masks = np.load(os.path.join(cache_dir, "masks.npy"), mmap_mode=mode)
        return FieldEmbeddingCache(emb, masks, fields, item_ids)

    @staticmethod
    def load_reference_pt(cache_dir: str) -> "FieldEmbeddingCache":
        """Ingest a reference-format cache (embeddings.pt/masks.pt/fields.json,
        models/qformer_utils.py:141-147).  Requires torch."""
        import torch

        with open(os.path.join(cache_dir, "fields.json")) as f:
            fields = json.load(f)
        emb_d = torch.load(
            os.path.join(cache_dir, "embeddings.pt"), map_location="cpu",
            weights_only=False,
        )
        mask_d = torch.load(
            os.path.join(cache_dir, "masks.pt"), map_location="cpu",
            weights_only=False,
        )
        n = len(emb_d)
        order = sorted(emb_d.keys())
        emb = np.stack([emb_d[i].numpy() for i in order]).astype(np.float32)
        masks = np.stack([mask_d[i].numpy() for i in order]).astype(np.float32)
        item_ids = [str(i) for i in order]  # reference caches key by index
        return FieldEmbeddingCache(emb, masks, fields, item_ids)


def analyze_fields(samples: Sequence[Dict]) -> List[str]:
    """Sorted union of sample keys minus item_id
    (reference: models/qformer_utils.py:78-90)."""
    all_fields = set()
    for s in samples:
        all_fields.update(s.keys())
    return sorted(f for f in all_fields if f != "item_id")


def build_cache(
    samples: Sequence[Dict],
    item_encoder,
    fields: Optional[List[str]] = None,
    cache_dir: Optional[str] = None,
    batch_size: int = 8192,
) -> FieldEmbeddingCache:
    """Precompute the dense cache with the batched encoder.

    Equivalent of QFormerDataset._precompute (reference:
    models/qformer_utils.py:92-119): a field is valid iff its embedding is
    nonzero.  If ``cache_dir`` holds a valid cache it is loaded instead.
    """
    fields = fields or analyze_fields(samples)
    if cache_dir and FieldEmbeddingCache.exists(cache_dir):
        try:
            return FieldEmbeddingCache.load(cache_dir, expected_fields=fields)
        except ValueError:
            pass  # fields changed -> recompute

    n = len(samples)
    dim = item_encoder.embedding_dim
    emb = np.zeros((n, len(fields), dim), np.float32)
    for i in range(0, n, batch_size):
        batch = samples[i : i + batch_size]
        by_field = item_encoder.encode_batch_by_field(batch, fields)
        for fi, f in enumerate(fields):
            emb[i : i + len(batch), fi] = by_field[f]
    masks = (np.abs(emb).sum(axis=-1) > 0).astype(np.float32)
    item_ids = [str(s.get("item_id", i)) for i, s in enumerate(samples)]
    cache = FieldEmbeddingCache(emb, masks, fields, item_ids)
    if cache_dir:
        cache.save(cache_dir)
    return cache
