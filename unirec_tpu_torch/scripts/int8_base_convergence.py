"""Convergence-quality gate for ``train joint --int8-base`` on the port (port
of ``scripts/int8_base_convergence.py``).

``int8_base`` changes training numerics: the frozen base's projections run
W8A8 in the forward (``ops/int8_ste.int8_linear_ste``, kernel B8 on the
card) with a straight-through backward.  So the same joint model is trained
on the same synthetic corpus (``convergence_demo.make_corpus``) with and
without it, from one seeded init and on the same batches, and the final
ranking metrics each run's evaluator reports are compared (MRR /
Recall@10 / NDCG@10 over 100-candidate pools; ``quality_gates.py`` holds
the gate).

    python -m unirec_tpu_torch.scripts.int8_base_convergence [--device cpu]

Prints one JSON line: {"exact": {...}, "int8_base": {...}, "n_test": ...}.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.scripts.convergence_demo import (
    joint_datasets,
    joint_trainer,
    make_corpus,
    rank_metrics,
    rounded,
)


def run(int8_base: bool, cache: FieldEmbeddingCache, emb_dict: Dict,
        item_dict: Dict, users: Sequence[Dict], steps: int = 800,
        batch: int = 8, lr: float = 1e-3, seed: int = 2, device=None,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        losses: Optional[List[torch.Tensor]] = None) -> Dict[str, float]:
    """Train the joint stage's model for ``steps`` steps (from the seed's
    init, or the joint ``params`` state_dict) and return its ranking
    metrics on the held-out users (unrounded).  ``losses``: a list that
    receives each step's loss (a device scalar)."""
    trainer = joint_trainer(cache.num_fields, batch, lr, seed=seed,
                            int8_base=int8_base, device=device)
    state = trainer.init_state(params=params)
    train_ds, test_ds = joint_datasets(trainer, cache, emb_dict, item_dict,
                                       users)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        idx = rng.randint(0, len(train_ds), batch)
        state, metrics = trainer._train_step(state,
                                             train_ds.batch(idx.tolist()))
        if losses is not None:
            losses.append(metrics["loss"])
    return rank_metrics(trainer, state, test_ds)


def compare(cache: FieldEmbeddingCache, emb_dict: Dict, item_dict: Dict,
            users: Sequence[Dict], steps: int = 800, device=None) -> Dict:
    """Both runs from one init, as the JSON line ``main`` prints."""
    exact = run(False, cache, emb_dict, item_dict, users, steps=steps,
                device=device)
    q = run(True, cache, emb_dict, item_dict, users, steps=steps,
            device=device)
    return {
        "corpus": (f"convergence_demo default ({len(cache)} items / "
                   f"{len(users)} users)"),
        "steps": steps,
        # held-out eval size: Recall@10 is quantized in 1/n_test steps, so
        # gates on it must be granularity-aware (quality_gates.py)
        "n_test": len(users) - int(0.8 * len(users)),
        "exact": rounded(exact),
        "int8_base": rounded(q),
    }


def main(argv=None) -> int:
    from unirec_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cache, emb_dict, item_dict, users, _, _ = make_corpus()
    print(json.dumps(compare(cache, emb_dict, item_dict, users,
                             device=device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
