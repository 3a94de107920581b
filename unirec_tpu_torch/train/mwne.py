"""Self-supervised MWNE property training (port of
``unirec_tpu/train/mwne.py``): the number encoder learns additivity,
invertibility and distance ranking on synthetic number batches.

Losses (reference weights models/mwne.py:246-248):

* additivity (w 10): MSE(E(a) + E(b), E(a + b)) over the batch's first
  ``n_pairs`` numbers against the next ``n_pairs``, and over random pairs;
* invertibility (w 1): the mean relative error of the MLP decoder
  (``models/mwne.MWNEDecoder``);
* distance rank (w 1): a margin-0.1 ranking loss on random triplets, so that
  embedding distances order like numeric distances.

The losses take their random pair and triplet indices as tensors, so a test
can hand them the JAX package's draws; the trainer draws them (and the
batches) from its own ``torch.Generator``.  The step clips the gradient's
global norm at 0.5 and applies AdamW with weight decay 1e-6
(``train/common.make_optimizer``, optax's arithmetic).  Evaluation follows
models/mwne.py:441-501: fixed additivity pairs, invertibility errors and
the Spearman correlation of numeric and embedding distances.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from unirec_tpu_torch.configs import MWNEConfig, OptimizerConfig
from unirec_tpu_torch.models.mwne import MathematicalEncoder, MWNEDecoder
from unirec_tpu_torch.train.common import make_optimizer

ADDITIVITY_WEIGHT = 10.0
INVERTIBILITY_WEIGHT = 1.0
DISTANCE_WEIGHT = 1.0
BATCH_SIZE = 64
N_TRIPLETS = 10


def generate_training_batch(gen: torch.Generator, batch_size: int
                            ) -> torch.Tensor:
    """Balanced synthetic numbers (reference: models/mwne.py:416-439): small
    positives, medium, small negatives, decimals and a gaussian mix."""
    n_each = batch_size // 5
    dev = gen.device

    def uniform(n):
        return torch.rand(n, generator=gen, device=dev)
    return torch.cat([
        uniform(n_each) * 10.0, uniform(n_each) * 100.0 + 10.0,
        -uniform(n_each) * 10.0, uniform(n_each),
        torch.randn(batch_size - 4 * n_each, generator=gen, device=dev) * 5.0,
    ])


def num_pairs(n: int) -> int:
    """The additivity loss's pair count for a batch of ``n`` numbers."""
    return min(n // 2, 32)


def draw_indices(gen: torch.Generator, n: int,
                 n_triplets: int = N_TRIPLETS
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ia, ib, triplets): random pair indices with replacement and
    ``n_triplets`` rows of 3 distinct indices, for a batch of ``n``."""
    dev = gen.device
    pairs = num_pairs(n)
    ia = torch.randint(0, n, (pairs,), generator=gen, device=dev)
    ib = torch.randint(0, n, (pairs,), generator=gen, device=dev)
    triplets = torch.stack([torch.randperm(n, generator=gen, device=dev)[:3]
                            for _ in range(n_triplets)])
    return ia, ib, triplets


def additivity_loss(encode, numbers: torch.Tensor, ia: torch.Tensor,
                    ib: torch.Tensor) -> torch.Tensor:
    """Consecutive pairs (reference: models/mwne.py:294-298) and random
    pairs ``(ia, ib)`` (:302-308), the mean of the two MSEs."""
    p = ia.shape[0]
    a1, b1 = numbers[:p], numbers[p:2 * p]
    l1 = ((encode(a1) + encode(b1) - encode(a1 + b1)) ** 2).mean()
    a2, b2 = numbers[ia], numbers[ib]
    l2 = ((encode(a2) + encode(b2) - encode(a2 + b2)) ** 2).mean()
    return (l1 + l2) / 2.0


def invertibility_loss(decoded: torch.Tensor,
                       numbers: torch.Tensor) -> torch.Tensor:
    return ((decoded - numbers).abs() / (numbers.abs() + 1e-6)).mean()


def distance_loss(numbers: torch.Tensor, emb: torch.Tensor,
                  triplets: torch.Tensor) -> torch.Tensor:
    """Margin 0.1 ranking loss on triplets ``[n, 3]`` (reference:
    models/mwne.py:335-369): the embedding of the numerically nearer of b
    and c must be nearer to a's; ties in number distance add nothing."""
    a, b, c = (numbers[triplets[:, i]] for i in range(3))
    ea, eb, ec = (emb[triplets[:, i]] for i in range(3))
    d_ab, d_ac = (a - b).abs(), (a - c).abs()
    ed_ab = torch.linalg.vector_norm(ea - eb, dim=-1)
    ed_ac = torch.linalg.vector_norm(ea - ec, dim=-1)
    loss_ab = torch.clamp_min(ed_ab - ed_ac + 0.1, 0.0)
    loss_ac = torch.clamp_min(ed_ac - ed_ab + 0.1, 0.0)
    zero = torch.zeros_like(loss_ab)
    return torch.where(d_ab < d_ac, loss_ab,
                       torch.where(d_ac < d_ab, loss_ac, zero)).mean()


class MWNEModel(nn.Module):
    """The trained pair: ``encoder`` (``MathematicalEncoder``, the base the
    reference checkpoint holds) and ``decoder``; the JAX trainer's
    ``{"encoder": ..., "decoder": ...}`` tree."""

    def __init__(self, config: MWNEConfig, *, device=None):
        super().__init__()
        self.encoder = MathematicalEncoder(config, device=device)
        self.decoder = MWNEDecoder(config.embedding_dim, device=device)


@torch.no_grad()
def init_mwne_model(config: MWNEConfig, gen: torch.Generator,
                    device=None) -> MWNEModel:
    """The Flax initialisers' distributions: ones for the Fourier weights
    and raw scales, lecun-normal dense kernels, zero biases."""
    from unirec_tpu_torch.utils.weights import _lecun_normal_

    model = MWNEModel(config, device=device)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, gen)
            if module.bias is not None:
                module.bias.zero_()
    return model


class MWNETrainer:
    """One step: losses, backward, clip 0.5, AdamW (lr, weight decay 1e-6).
    Runs on the card unless ``device="cpu"``."""

    def __init__(self, config: MWNEConfig, lr: float = 1e-3, seed: int = 0,
                 device: str = "cuda", model: Optional[MWNEModel] = None):
        self.config = config
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = model if model is not None else init_mwne_model(
            config, self.gen, self.device)
        self.optimizer = make_optimizer(
            dict(self.model.named_parameters()),
            OptimizerConfig(learning_rate=lr, weight_decay=1e-6,
                            max_grad_norm=0.5))

    def losses(self, numbers: torch.Tensor, ia: torch.Tensor,
               ib: torch.Tensor, triplets: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {"additivity", "invertibility", "distance"})."""
        encode = self.model.encoder
        emb = encode(numbers)
        decoded = self.model.decoder(emb)
        add = additivity_loss(encode, numbers, ia, ib)
        inv = invertibility_loss(decoded, numbers)
        dist = distance_loss(numbers, emb, triplets)
        total = (ADDITIVITY_WEIGHT * add + INVERTIBILITY_WEIGHT * inv
                 + DISTANCE_WEIGHT * dist)
        return total, {"additivity": add, "invertibility": inv,
                       "distance": dist}

    def step(self, numbers: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
             triplets: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update on the given batch and indices; device-scalar
        metrics with ``total``."""
        params = dict(self.model.named_parameters())
        total, metrics = self.losses(numbers, ia, ib, triplets)
        grads = torch.autograd.grad(total, list(params.values()))
        self.optimizer.step(dict(zip(params, grads)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total"] = total.detach()
        return metrics

    def train(self, num_steps: int = 200) -> Dict[str, float]:
        """``num_steps`` steps on batches of 64 drawn from the trainer's
        generator; the last step's metrics, and ``total_first`` (the first
        step's total)."""
        metrics, first = {}, None
        for _ in range(num_steps):
            numbers = generate_training_batch(self.gen, BATCH_SIZE)
            metrics = self.step(numbers, *draw_indices(self.gen, BATCH_SIZE))
            if first is None:
                first = metrics["total"]
        out = {k: float(v) for k, v in metrics.items()}
        if first is not None:
            out["total_first"] = float(first)
        return out

    @torch.no_grad()
    def evaluate(self, test_numbers: np.ndarray) -> Dict[str, float]:
        """Fixed additivity pairs, invertibility errors and, with 5 or more
        numbers, the distance-rank correlation (reference:
        models/mwne.py:441-501)."""
        encode = self.model.encoder
        dev = self.device

        def one(x):
            return encode(torch.tensor([x], dtype=torch.float32, device=dev))
        errs = [float(((one(a) + one(b) - one(a + b)) ** 2).mean())
                for a, b in ((1.0, 2.0), (3.0, 5.0), (0.1, 0.9), (-2.0, 4.0),
                             (10.0, 0.01))]
        x = torch.as_tensor(np.asarray(test_numbers, np.float32), device=dev)
        emb = encode(x)
        err = (self.model.decoder(emb) - x).abs()
        results = {"additivity_mse": float(np.mean(errs)),
                   "additivity_max": float(np.max(errs)),
                   "invertibility_mean": float(err.mean()),
                   "invertibility_max": float(err.max())}
        if len(test_numbers) >= 5:
            results["distance_rank_correlation"] = spearman_distance_correlation(
                np.asarray(test_numbers), emb.cpu().numpy())
        return results


def spearman_distance_correlation(numbers: np.ndarray,
                                  emb: np.ndarray) -> float:
    """Spearman rank correlation between pairwise numeric and embedding
    distances (reference: models/mwne.py:480-490)."""
    n = len(numbers)
    iu = np.triu_indices(n, k=1)
    num_d = np.abs(numbers[:, None] - numbers[None, :])[iu]
    emb_d = np.linalg.norm(emb[:, None, :] - emb[None, :, :], axis=-1)[iu]
    if len(num_d) < 2:
        return float("nan")
    nr = np.argsort(np.argsort(num_d)).astype(np.float64)
    er = np.argsort(np.argsort(emb_d)).astype(np.float64)
    return float(np.corrcoef(nr, er)[0, 1])
