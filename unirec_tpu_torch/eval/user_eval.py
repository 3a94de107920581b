"""User Q-Former evaluation: next-item prediction quality (port of
``unirec_tpu/eval/user_eval.py``).

* token MSE and mean cosine between predicted and true next-item query tokens
  on held-out samples;
* retrieval: rank the true next item among the whole catalog by the mean over
  the K token cosines between the predicted tokens and every item's
  precomputed tokens -> hit@k and MRR.  A rank counts the items scoring
  strictly higher, so a tie goes to the true item.

The forward is deterministic (no dropout stream) and runs without
gradients: on the card its cross-attention goes through B13
(``ops/attention.cross_attention``), or through B14's forward when the model
trains with ``flash_training``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.ops.losses import l2_normalize


def token_metrics(pred: torch.Tensor, target: torch.Tensor) -> Dict[str, float]:
    """[N, K, D] predicted vs true tokens -> mse + mean per-token cosine."""
    pred, target = pred.float(), target.float()
    mse = ((pred - target) ** 2).mean()
    cos = (l2_normalize(pred) * l2_normalize(target)).sum(dim=-1).mean()
    return {"token_mse": float(mse), "token_cosine": float(cos)}


def token_similarity(pred: torch.Tensor,
                     catalog_tokens: torch.Tensor) -> torch.Tensor:
    """[N, K, D] x [M, K, D] -> [N, M] mean-over-K cosine similarity."""
    p = l2_normalize(pred.float())
    c = l2_normalize(catalog_tokens.float())
    return torch.einsum("nkd,mkd->nm", p, c) / pred.shape[1]


def retrieval_metrics(
    pred_tokens: np.ndarray,  # [N, K, D]
    target_rows: np.ndarray,  # [N] row index of the true next item
    catalog_tokens: np.ndarray,  # [M, K, D]
    ks: Tuple[int, ...] = (1, 5, 10),
    device=None,
) -> Dict[str, float]:
    """hit@k and MRR of the true items among the catalog; the similarities
    are computed on ``device`` (default: the CPU)."""
    sims = token_similarity(
        torch.as_tensor(np.asarray(pred_tokens, np.float32), device=device),
        torch.as_tensor(np.asarray(catalog_tokens, np.float32), device=device),
    ).cpu().numpy()
    true_sim = sims[np.arange(len(sims)), target_rows]
    ranks = 1 + (sims > true_sim[:, None]).sum(axis=1)
    out = {"retrieval_mrr": float(np.mean(1.0 / ranks))}
    for k in ks:
        out[f"retrieval_hit@{k}"] = float(np.mean(ranks <= k))
    return out


@torch.no_grad()
def evaluate_user_qformer(
    trainer,  # train/user_qformer.UserQFormerTrainer
    state,
    samples: Sequence[Tuple[List[str], str]],
    item_tokens: np.ndarray,
    cache: FieldEmbeddingCache,
    timestamp_map: Dict[str, int],
    batch_size: int = 64,
) -> Dict[str, float]:
    """Full user-stage evaluation over held-out sliding-window samples."""
    from unirec_tpu_torch.train.user_qformer import batch_to_device, user_forward

    model = state.model
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    preds, targets, target_rows = [], [], []
    for i in range(0, len(samples), batch_size):
        idx = list(range(i, min(i + batch_size, len(samples))))
        batch = trainer.make_batch(samples, idx, item_tokens, cache,
                                   timestamp_map)
        pred = user_forward(model, batch_to_device(batch, device))
        preds.append(pred.float().cpu().numpy())
        targets.append(batch["target_tokens"])
        target_rows.extend(
            cache.rows_for([samples[j][1] for j in idx]).tolist())
    model.train(was_training)
    pred = np.concatenate(preds)
    target = np.concatenate(targets)
    rows = np.asarray(target_rows)
    valid = rows >= 0
    metrics = token_metrics(torch.from_numpy(pred), torch.from_numpy(target))
    if valid.any():
        metrics.update(retrieval_metrics(pred[valid], rows[valid], item_tokens,
                                         device=device))
    return metrics
