"""Item Q-Former reconstruction-quality evaluation (port of
``unirec_tpu/eval/reconstruction.py``).

Rebuild of reference evaluation/evaluate_item_qformer.py: a batched forward
over cached field embeddings, the masked reconstruction MSE per batch
(averaged over batches) and the mean cosine similarity over valid fields
(reference :41-104), as one masked reduction per batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.ops.losses import l2_normalize, masked_reconstruction_mse


@torch.no_grad()
def reconstruction_batch(model: torch.nn.Module, emb: torch.Tensor,
                         mask: torch.Tensor) -> Tuple[float, float, float]:
    """(masked MSE, sum of per-field cosines over valid fields, number of
    valid fields) of one batch, the JAX eval step's three numbers."""
    recon = model(emb, mask)["reconstructed_fields"].float()
    mse = masked_reconstruction_mse(recon, emb, mask)
    cos = (l2_normalize(emb) * l2_normalize(recon)).sum(-1)
    return float(mse), float((cos * mask).sum()), float(mask.sum())


def evaluate_reconstruction_quality(
    model: torch.nn.Module,
    cache: FieldEmbeddingCache,
    rows: Optional[np.ndarray] = None,
    batch_size: int = 256,
) -> Dict[str, float]:
    """Reconstruction metrics of an ``ItemQFormer`` over the cache's
    ``rows`` (default: all), on the model's device."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    rows = np.arange(len(cache)) if rows is None else rows
    total_mse, total_cos, total_valid, batches = 0.0, 0.0, 0.0, 0
    try:
        for i in range(0, len(rows), batch_size):
            r = rows[i: i + batch_size]
            emb = torch.from_numpy(np.asarray(cache.embeddings[r], np.float32))
            mask = torch.from_numpy(np.asarray(cache.masks[r], np.float32))
            mse, cos_sum, n_valid = reconstruction_batch(
                model, emb.to(device), mask.to(device))
            total_mse += mse
            total_cos += cos_sum
            total_valid += n_valid
            batches += 1
    finally:
        model.train(was_training)
    return {
        "val_recon_loss": total_mse / max(batches, 1),
        "avg_cosine_similarity": total_cos / max(total_valid, 1.0),
        "num_samples": int(len(rows)),
        "num_valid_fields": int(total_valid),
    }
