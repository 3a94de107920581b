"""Tensor parallelism of the Qwen3 base over torch.distributed: the plan, the
shards and the collectives.

The JAX package shards the base with GSPMD: ``tp_spec_for_path``
(``unirec_tpu/models/qwen3.py``) puts each parameter on the ``tp`` mesh axis
and XLA inserts the collectives.  The port writes both out, Megatron's way:

* the plan (``tp_split``), a rule on state_dict names: column-parallel
  (the output features split) for the q/k/v/gate/up weights and their
  ``lora_b``, row-parallel (the input features split) for the o/down
  weights and their ``lora_a``, everything else replicated.  A column
  layer's bias splits with its outputs; a row layer's bias stays whole and
  is added once, after the reduce (Qwen3 has none: ``attention_bias`` is
  false and o/down never take one);
* ``shard_state_dict`` cuts a full state_dict (or an optimizer's moments,
  which carry the same names) into one rank's shards, and
  ``gather_state_dict`` puts the shards of every rank of the tp group back
  together, so a checkpoint written under tp has the one-rank schema;
* the collectives, as autograd Functions: ``copy_to_tp`` is the identity
  forward with an all-reduce backward (a replicated activation entering
  column layers, whose input gradients are partial sums over the ranks),
  ``reduce_from_tp`` an all-reduce forward with the identity backward (the
  partial outputs of a row layer).

LoRA is where GSPMD's placement is rebuilt by hand (``models/qwen3.LoRADense``):

* column layer: ``lora_a`` replicated, ``lora_b`` split; ``mid = x @ A``
  gets a partial gradient on each rank (each holds some of B's columns), so
  ``mid`` passes through its own ``copy_to_tp`` and ``x`` reaches A
  without one: A's gradient and the LoRA path's share of x's gradient are
  then whole on every rank;
* row layer: ``lora_a`` split, ``lora_b`` replicated; the base product and
  ``x_loc @ A_loc`` are reduced separately and B applies to the reduced
  ``mid``.  One reduce of the summed partials would give each rank B's
  gradient from its own ``mid`` only.  The partials are products in the
  compute dtype and are reduced in it, as GSPMD's are: in bfloat16 each
  is rounded before the sum, one rounding more than the one-rank product.

With that placement every replicated leaf's gradient is whole and the same
on every rank of the tp group: the trainers reduce gradients over dp alone
and add the sharded leaves' squared norms over tp for clipping
(``train/common.OptaxAdamW``).

Gloo (the CPU, or two ranks that share one card) reduces bfloat16 tensors
in float32 and casts back; NCCL reduces them as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist

COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")
_COLUMN_DIMS = {"weight": 0, "bias": 0, "lora_b": 1}
_ROW_DIMS = {"weight": 1, "lora_a": 0}


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the tp axis: ``size`` ranks, this one
    ``index``, their ``group`` (None: the world)."""

    size: int
    index: int = 0
    group: Any = None


def tp_split(name: str) -> Optional[int]:
    """The dim along which the tensor ``name`` of a Qwen3 (or joint)
    state_dict is split over tp, or None when it is replicated.  The port's
    layouts: ``weight [out, in]``, ``bias [out]``, ``lora_a [in, r]``,
    ``lora_b [r, out]``."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    module, leaf = parts[-2], parts[-1]
    if module in COLUMN:
        return _COLUMN_DIMS.get(leaf)
    if module in ROW:
        return _ROW_DIMS.get(leaf)
    return None


def local_size(n: int, tp: int, what: str) -> int:
    """``n / tp``, or a ValueError naming ``what`` when tp does not divide
    it."""
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {what}={n}")
    return n // tp


def shard_state_dict(full: Mapping[str, torch.Tensor], tp: int,
                     index: int) -> Dict[str, torch.Tensor]:
    """Rank ``index``'s shards of a full state_dict (new tensors; the
    replicated ones as they are)."""
    out = {}
    for name, t in full.items():
        dim = tp_split(name)
        if dim is None or tp == 1:
            out[name] = t
            continue
        n = local_size(t.shape[dim], tp, f"{name} dim {dim}")
        out[name] = t.narrow(dim, index * n, n).clone()
    return out


def gather_state_dict(local: Mapping[str, torch.Tensor],
                      tp: TensorParallel) -> Dict[str, torch.Tensor]:
    """The full state_dict from every tp rank's shards (a collective: every
    rank of ``tp.group`` calls it); the replicated tensors as they are."""
    out = {}
    for name, t in local.items():
        dim = tp_split(name)
        if dim is None or tp.size == 1:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(tp.size)]
        dist.all_gather(parts, t.contiguous(), group=tp.group)
        out[name] = torch.cat(parts, dim=dim)
    return out


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (a gloo group reduces half
    precision in float32)."""
    if (t.dtype in (torch.bfloat16, torch.float16)
            and dist.get_backend(group) == "gloo"):
        wide = t.float()
        dist.all_reduce(wide, group=group)
        t.copy_(wide)
    else:
        dist.all_reduce(t, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Identity forward, gradient summed over the tp group (identity
    without tp)."""
    if tp is None or tp.size == 1:
        return x
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor,
                   tp: Optional[TensorParallel]) -> torch.Tensor:
    """Sum over the tp group forward, identity backward (identity without
    tp)."""
    if tp is None or tp.size == 1:
        return x
    return _ReduceFromTP.apply(x, tp.group)
