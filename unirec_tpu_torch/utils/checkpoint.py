"""Checkpoint directories with the JAX package's metadata contract (port of
``unirec_tpu/utils/checkpoint.py``).

    directory/
      meta.json     {"config": {...}, "config_class": "...", **extra}
                    (extra carries ``field_names`` for an Item Q-Former;
                    a train state adds ``step`` and ``grad_accum``)
      params.pt     torch state_dict (in place of orbax's ``state/``)
      optimizer.pt  a train state only: the optimizer's moments, its
                    gradient-accumulation buffer and counters, and the step

``params.pt`` alone is what ``serve_cli --checkpoint`` and
``QFormerInference`` read; ``restore_train_state`` reads all three.  A
reference ``best_qformer_model.pth`` is read by ``QFormerInference`` through
``utils/torch_convert.py`` instead (unpickling its ``BertConfig`` needs
``transformers``).

A JAX checkpoint (orbax's ``state/`` beside the same ``meta.json``) becomes
such a directory through ``scripts/orbax_to_torch.py``, which runs where the
JAX package is installed and hands numpy arrays to
``save_converted_checkpoint`` here (numpy and torch only).

In a torch.distributed world (``parallel/mesh.py``) only rank 0 writes,
and a restore reads on every rank and then broadcasts rank 0's parameters,
optimizer state and step, so the ranks hold one state.  Under tensor
parallelism the trainer hands the writer the gathered full tree, and a
restore cuts each rank's shards from it (``shard``) and broadcasts within
the ranks of one tp index; a directory has the one-rank schema whatever tp
wrote it.  The pipeline's trainer writes its merged parameters and step
with ``{"pp_layout": True}`` in place of the optimizer state
(``save_pipeline_state``, the JAX ``_run_joint_pp``'s sentinel): such a
directory resumes with parameters and step only.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from unirec_tpu_torch.parallel.mesh import is_writer, replicate

PARAMS_FILE = "params.pt"
META_FILE = "meta.json"
OPTIMIZER_FILE = "optimizer.pt"


def save_checkpoint(
    directory: str,
    params: Union[nn.Module, Mapping[str, torch.Tensor]],
    config: Optional[Any] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a module's (or a state_dict's) parameters, on the CPU, plus the
    config and ``extra`` metadata; returns the absolute directory.  Only
    rank 0 of a torch.distributed world writes."""
    directory = os.path.abspath(directory)
    if not is_writer():
        return directory
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


def save_converted_checkpoint(directory: str, params: Mapping[str, Any],
                              meta: Mapping[str, Any], step: int,
                              optimizer: Optional[Dict[str, Any]] = None
                              ) -> str:
    """Write the port's checkpoint directory from a JAX checkpoint's parts:
    ``params`` the Flax parameter tree as numpy arrays (names through
    ``utils/weights.port_state_dict_from_flax``), ``meta`` its
    ``meta.json`` copied whole (``config`` and ``config_class``,
    ``field_names``, ``grad_accum``, the joint model's ``qwen_config`` /
    ``qformer_config``, the trainers' extras) with ``step`` added, and
    ``optimizer`` an ``OptaxAdamW.state_dict()``
    (``train/common.optimizer_state_from_optax`` of its optax state) or None:
    then no ``optimizer.pt`` is written, and the directory serves and
    resumes with a fresh optimizer (``restore_params_and_step``).  Returns
    the absolute directory."""
    from unirec_tpu_torch.utils.weights import port_state_dict_from_flax

    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    torch.save(port_state_dict_from_flax(params),
               os.path.join(directory, PARAMS_FILE))
    with open(os.path.join(directory, META_FILE), "w") as f:
        json.dump({**meta, "step": int(step)}, f, default=str)
    path = os.path.join(directory, OPTIMIZER_FILE)
    if optimizer is not None:
        torch.save({"step": int(step), "optimizer": optimizer}, path)
    elif os.path.exists(path):
        os.remove(path)  # a stale state would pair with other parameters
    return directory


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


# -- train states -------------------------------------------------------------


def has_train_state(directory: Optional[str]) -> bool:
    """Whether ``directory`` holds an optimizer state (a pipeline-saved one
    holds the sentinel instead)."""
    return (bool(directory)
            and os.path.exists(os.path.join(directory, OPTIMIZER_FILE))
            and not read_meta(directory).get("pp_layout"))


def save_pipeline_state(directory: str, params: Mapping[str, torch.Tensor],
                        step: int, config: Optional[Any] = None,
                        extra: Optional[Dict[str, Any]] = None) -> str:
    """The pipeline trainer's checkpoint: the merged (one-rank) parameters,
    the step and ``{"pp_layout": True}`` for the optimizer state, which
    the pp layout does not carry over (the JAX package's sentinel)."""
    directory = save_checkpoint(directory, params, config, extra={
        **(extra or {}), "step": int(step), "pp_layout": True})
    if is_writer():
        torch.save({"step": int(step), "optimizer": {"pp_layout": True}},
                   os.path.join(directory, OPTIMIZER_FILE))
    return directory


def save_train_state(directory: str, state, config: Optional[Any] = None,
                     extra: Optional[Dict[str, Any]] = None) -> str:
    """Parameters, optimizer state and step of a ``train/common.TrainState``
    (the JAX ``save_checkpoint`` of a TrainState)."""
    directory = save_checkpoint(directory, state.model, config,
                                extra={**(extra or {}), "step": int(state.step)})
    if not is_writer():
        return directory
    opt = state.optimizer.state_dict()
    host = {k: ({n: t.detach().cpu() for n, t in v.items()}
                if isinstance(v, dict) else v) for k, v in opt.items()}
    torch.save({"step": int(state.step), "optimizer": host},
               os.path.join(directory, OPTIMIZER_FILE))
    return directory


Shard = Optional[Callable[[Mapping[str, torch.Tensor]],
                          Dict[str, torch.Tensor]]]


def restore_train_state(directory: str, template_state, shard: Shard = None,
                        group=None, src: int = 0):
    """Restore parameters, optimizer state and step into a freshly built
    ``TrainState`` (its structure is the template); returns (state, meta).
    ``shard`` cuts this rank's part from the full parameters and moments;
    ``group`` / ``src``: the ranks that hold the same part, and the one
    whose state they all take (default: the world, rank 0)."""
    shard = shard or dict
    directory = os.path.abspath(directory)
    sd, meta = load_checkpoint(directory)
    model = template_state.model
    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device) for k, v in shard(sd).items()})
    saved = torch.load(os.path.join(directory, OPTIMIZER_FILE),
                       map_location=device, weights_only=True)
    opt = dict(saved["optimizer"])
    for part in ("mu", "nu", "acc"):
        opt[part] = shard(opt[part])
    template_state.optimizer.load_state_dict(opt)
    template_state.step = int(saved["step"])
    return _replicate_state(template_state, group, src), meta


def _replicate_state(state, group=None, src: int = 0):
    """Rank ``src``'s parameters, optimizer tensors and step on every rank
    of ``group`` (default: rank 0's on the world; a no-op outside one)."""
    opt = state.optimizer
    replicate(list(state.model.state_dict().values())
              + [t for part in (opt.mu, opt.nu, opt.acc)
                 for t in part.values()], group=group, src=src)
    counters = torch.tensor([state.step, opt.count, opt.mini_step,
                             opt.gradient_step], dtype=torch.int64,
                            device=next(state.model.parameters()).device)
    replicate([counters], group=group, src=src)
    state.step, opt.count, opt.mini_step, opt.gradient_step = (
        int(c) for c in counters.tolist())
    return state


def has_params(directory: Optional[str]) -> bool:
    return bool(directory) and os.path.exists(
        os.path.join(directory, PARAMS_FILE))


def restore_params_and_step(directory: str, template_state,
                            shard: Shard = None, group=None, src: int = 0):
    """Parameters and step (from ``meta.json``) into a freshly built
    ``TrainState`` whose optimizer restarts: a directory without an
    optimizer state, such as one a pipeline wrote (here or in the JAX
    package, converted), whose optimizer state has another layout (the JAX
    package's resume does the same).  ``shard``, ``group`` and ``src`` as
    in ``restore_train_state``.  Returns (state, meta)."""
    sd, meta = load_checkpoint(directory)
    model = template_state.model
    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device)
                           for k, v in (shard or dict)(sd).items()})
    template_state.step = int(meta.get("step", 0))
    return _replicate_state(template_state, group, src), meta


def check_grad_accum(meta: Dict[str, Any], expected: int) -> None:
    """The checkpoint's gradient-accumulation setting must be the resuming
    run's (the optimizer state's layout depends on it); checkpoints without
    the field count as 1."""
    saved = int(meta.get("grad_accum", 1))
    if saved != int(expected):
        raise ValueError(
            f"checkpoint was saved with gradient accumulation {saved} but "
            f"this run uses {int(expected)}; the optimizer-state layout "
            "depends on it — resume with the matching --grad-accum")


def resume_train_state(directory: Optional[str], template_state, log_fn=print,
                       expect_grad_accum: Optional[int] = None):
    """``restore_train_state`` with the trainer-resume contract: raise when
    no checkpoint exists instead of silently training from scratch."""
    if not has_train_state(directory):
        raise FileNotFoundError(
            f"resume requested but no checkpoint under {directory!r}")
    if expect_grad_accum is not None:
        check_grad_accum(read_meta(directory), expect_grad_accum)
    state, meta = restore_train_state(directory, template_state)
    log_fn(f"resumed from {directory} at step {int(state.step)}")
    return state, meta
