"""Checkpoint-strategy callbacks (the port's copy of
``unirec_tpu/train/callbacks.py``).

Mirrors BestMRRCallback (reference:
train_item_individual_token_joint.py:422-474): evaluate every N steps and
save per strategy — ``best_only`` (save iff the metric improved), ``always``
(save latest every eval), ``both`` (latest/ + best/ subdirectories).
In a torch.distributed world every rank keeps the tracker (the reduced
metrics are equal, so the ranks decide alike) and ``save_fn``
(``utils/checkpoint.save_train_state``) writes on rank 0 only.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional


class BestMetricTracker:
    def __init__(
        self,
        save_dir: Optional[str],
        metric: str = "mrr",
        strategy: str = "best_only",
        eval_steps: int = 20,
        mode: str = "max",
        save_fn: Optional[Callable[[str, Any], None]] = None,
    ):
        if strategy not in ("best_only", "always", "both"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if mode not in ("max", "min"):
            raise ValueError(f"unknown mode {mode!r}")
        self.save_dir = save_dir
        self.metric = metric
        self.strategy = strategy
        self.eval_steps = eval_steps
        self.mode = mode
        self.best = float("-inf") if mode == "max" else float("inf")
        self.last_eval_step = 0
        self._save_fn = save_fn

    def should_eval(self, step: int) -> bool:
        """reference :440: eval when >= eval_steps since the last eval."""
        return step > 0 and step - self.last_eval_step >= self.eval_steps

    def _improved(self, value: float) -> bool:
        return value > self.best if self.mode == "max" else value < self.best

    def _save(self, subdir: str, state) -> None:
        if not self.save_dir or self._save_fn is None:
            return
        path = os.path.join(self.save_dir, subdir) if subdir else self.save_dir
        self._save_fn(path, state)

    def update(self, step: int, value: float, state=None) -> Dict[str, Any]:
        """Record an eval result; saves per strategy.  Returns status."""
        self.last_eval_step = step
        improved = self._improved(value)
        if improved:
            # before the saves: save_fn closures typically record
            # ``tracker.best`` in checkpoint metadata, which must be the
            # value being saved, not the previous watermark
            self.best = value
        saved = []
        if self.strategy == "best_only":
            if improved:
                self._save("", state)
                saved.append("best")
        elif self.strategy == "always":
            self._save("", state)
            saved.append("latest")
        else:  # both
            self._save("latest_model", state)
            saved.append("latest")
            if improved:
                self._save("best_model", state)
                saved.append("best")
        return {
            "step": step,
            self.metric: value,
            "best": self.best,
            "improved": improved,
            "saved": saved,
        }
