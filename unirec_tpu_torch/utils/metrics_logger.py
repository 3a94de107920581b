"""Structured training metrics: JSONL log + optional wandb (the port's copy
of ``unirec_tpu/utils/metrics_logger.py``).

The reference prints metrics and carries a dead ``USE_WANDB = True`` flag that
never imports wandb (reference: train_item_individual_token_joint.py:691;
SURVEY.md §5 "dead flag").  Here the flag is real: metrics always stream to a
JSONL file (greppable, resumable) and to wandb iff it is installed and
enabled.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(
        self,
        log_path: Optional[str] = None,
        use_wandb: bool = False,
        wandb_project: str = "unirec-tpu",
        wandb_config: Optional[Dict[str, Any]] = None,
        stdout: bool = True,
    ):
        self.log_path = log_path
        self.stdout = stdout
        self._file = None
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            self._file = open(log_path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project, config=wandb_config or {})
            except ImportError:
                print("wandb requested but not installed; JSONL logging only")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"ts": time.time(), **({"step": step} if step is not None else {}),
                  **{k: float(v) if hasattr(v, "item") or isinstance(v, (int, float))
                     else v for k, v in metrics.items()}}
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)
        if self.stdout:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items() if k != "ts"
            )
            print(parts)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._wandb:
            self._wandb.finish()
