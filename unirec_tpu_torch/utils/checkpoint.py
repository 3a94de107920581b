"""Checkpoint directories with the JAX package's metadata contract (port of
``unirec_tpu/utils/checkpoint.py``).

    directory/
      meta.json   {"config": {...}, "config_class": "...", **extra}
                  (extra carries ``field_names`` for an Item Q-Former)
      params.pt   torch state_dict (in place of orbax's ``state/``)

Optimizer state, the step and resume arrive with the training slice.  A
reference ``best_qformer_model.pth`` is read by ``QFormerInference`` through
``unirec_tpu.utils.torch_convert`` instead (unpickling its ``BertConfig``
needs ``transformers``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

PARAMS_FILE = "params.pt"
META_FILE = "meta.json"


def save_checkpoint(
    directory: str,
    params: Union[nn.Module, Mapping[str, torch.Tensor]],
    config: Optional[Any] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a module's (or a state_dict's) parameters, on the CPU, plus the
    config and ``extra`` metadata; returns the absolute directory."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    torch.save({k: v.detach().cpu() for k, v in sd.items()},
               os.path.join(directory, PARAMS_FILE))
    meta: Dict[str, Any] = dict(extra or {})
    if config is not None:
        meta["config"] = dataclasses.asdict(config)
        meta["config_class"] = type(config).__name__
    with open(os.path.join(directory, META_FILE), "w") as f:
        json.dump(meta, f, default=str)
    return directory


def load_checkpoint(directory: str, map_location: Union[str, torch.device] = "cpu"
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Returns (state_dict, meta dict)."""
    directory = os.path.abspath(directory)
    sd = torch.load(os.path.join(directory, PARAMS_FILE),
                    map_location=map_location, weights_only=True)
    return sd, read_meta(directory)


def read_meta(directory: str) -> Dict[str, Any]:
    meta_path = os.path.join(os.path.abspath(directory), META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def restore_config(meta: Dict[str, Any], config_cls):
    cfg = dict(meta.get("config", {}))
    fields = {f.name for f in dataclasses.fields(config_cls)}
    return config_cls(**{k: v for k, v in cfg.items() if k in fields})
