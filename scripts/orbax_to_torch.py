"""Convert a checkpoint of the JAX package (orbax's ``state/`` beside
``meta.json``) into a checkpoint directory of the PyTorch port
(``params.pt``, ``optimizer.pt``, ``meta.json``), so that a model trained
with JAX serves, sweeps and resumes training on the GPU.

    JAX_PLATFORMS=cpu python scripts/orbax_to_torch.py SRC DST

It runs where the JAX package is installed (the CPU is enough), not on the
GPU machine, which has no JAX.  The checkpoint's kind is its
``meta.json`` ``config_class``:

* ``ItemQFormerConfig``  ``train item-qformer`` (item)
* ``UserQFormerConfig``  ``train user-qformer`` (user; a frozen context is
  read from the optimizer's ``multi_transform``)
* ``JointModelConfig``   ``train joint`` (joint; Qwen3 and Q-Former configs
  from ``qwen_config`` / ``qformer_config``, the LoRA rank and targets
  from the adapters in the tree)
* ``MWNEConfig``         ``train mwne``

For the kind, the JAX trainer builds a template state from the configs,
with an optimizer of the layout the checkpoint holds (warmup, clipping,
gradient accumulation), and ``unirec_tpu.utils.checkpoint.load_checkpoint``
restores into it.  Parameters, adam moments and counters, the schedule's
count and ``MultiSteps``' accumulator then go to the port as numpy arrays
(``unirec_tpu_torch.utils.checkpoint.save_converted_checkpoint`` and
``unirec_tpu_torch.train.common.optimizer_state_from_optax``).  A joint
checkpoint saved under pipeline parallelism (``train joint --pp``) carries
``{"pp_layout": True}`` in place of an optimizer state: its parameters and
step are converted and no ``optimizer.pt`` is written, so that a
``--resume`` restarts the optimizer, as the JAX package's own resume does.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Callable, Dict, Mapping

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

KINDS = {"ItemQFormerConfig": "item", "UserQFormerConfig": "user",
         "JointModelConfig": "joint", "MWNEConfig": "mwne"}


def plain(tree: Any) -> Any:
    """A restored tree as nested dicts, lists and numpy arrays, as orbax
    restores it without a template: a NamedTuple's fields by name, None for
    an empty one (optax's EmptyState, MaskedNode) and for None."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return ({k: plain(v) for k, v in tree._asdict().items()}
                if tree._fields else None)
    if isinstance(tree, Mapping):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    return np.asarray(tree)


def optimizer_layout(opt_state: Any, grad_accum: int) -> Dict[str, Any]:
    """The make_optimizer options that give a restored (template-free)
    optax state its structure: ``frozen`` (a ``multi_transform`` with a
    frozen branch), warmup (a schedule count), clipping and gradient
    accumulation."""
    frozen = isinstance(opt_state, Mapping) and "inner_states" in opt_state
    node = opt_state["inner_states"]["train"]["inner_state"] if frozen \
        else opt_state
    multi = isinstance(node, Mapping) and "mini_step" in node
    if multi != (grad_accum > 1):
        raise ValueError(f"meta grad_accum {grad_accum} does not match the "
                         "optimizer state")
    chain = node["inner_opt_state"] if multi else node
    # adamw: [adam, decay, scale]; under clip_by_global_norm: [clip, adamw]
    clip = chain[0] is None and isinstance(chain[1], list)
    adamw = chain[1] if clip else chain
    return dict(frozen=frozen, warmup=adamw[2] is not None, clip=clip,
                grad_accum=grad_accum)


def _optimizer_config(layout: Dict[str, Any]):
    from unirec_tpu.configs import OptimizerConfig

    return OptimizerConfig(
        warmup_steps=1 if layout["warmup"] else 0,
        max_grad_norm=1.0 if layout["clip"] else 0.0,
        gradient_accumulation_steps=layout["grad_accum"])


def _leaves(tree: Mapping, path=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (name,))
        else:
            yield path + (name,), value


def template_state(kind: str, meta: Dict[str, Any], raw_params: Mapping,
                   layout: Dict[str, Any]):
    """The JAX trainer's fresh state for a checkpoint of ``kind``: the
    configs of ``meta``, the optimizer of ``layout``; ``raw_params`` (the
    template-free restore) gives the joint model's LoRA rank and targets."""
    from unirec_tpu.configs import (
        ItemQFormerConfig,
        JointModelConfig,
        LoRAConfig,
        MeshConfig,
        MWNEConfig,
        Qwen3Config,
        TrainConfig,
        UserQFormerConfig,
    )
    from unirec_tpu.utils.checkpoint import restore_config

    import jax

    tc = TrainConfig(optimizer=_optimizer_config(layout),
                     mesh=MeshConfig(dp=1))

    def init(trainer):  # traced once: the eager Flax init runs op by op
        return jax.jit(lambda: trainer.init_state(seed=0))()

    if kind == "item":
        from unirec_tpu.train.item_qformer import ItemQFormerTrainer

        return init(ItemQFormerTrainer(restore_config(meta, ItemQFormerConfig),
                                       tc, fused_reference_forwards=False))
    if kind == "user":
        from unirec_tpu.train.user_qformer import UserQFormerTrainer

        return init(UserQFormerTrainer(restore_config(meta, UserQFormerConfig),
                                       tc, train_context=not layout["frozen"]))
    if kind == "joint":
        from unirec_tpu.train.joint import JointTrainer

        lora = [(path, np.shape(v)) for path, v in _leaves(raw_params)
                if path[-1] == "lora_a"]
        if not lora:
            raise ValueError("a joint checkpoint without LoRA adapters")
        targets = tuple(sorted({path[-2] for path, _ in lora}))
        qwen = restore_config({"config": meta["qwen_config"]}, Qwen3Config)
        qformer = restore_config({"config": meta["qformer_config"]},
                                 ItemQFormerConfig)
        return init(JointTrainer(
            qwen, qformer, restore_config(meta, JointModelConfig),
            lora=LoRAConfig(r=int(lora[0][1][-1]), target_modules=targets),
            train_config=tc))
    if kind == "mwne":
        from unirec_tpu.train.mwne import MWNETrainer

        trainer = MWNETrainer(restore_config(meta, MWNEConfig))
        return type("MWNEState", (), {"params": trainer.params,
                                      "opt_state": trainer.opt_state})
    raise ValueError(f"unknown kind {kind!r}")


def convert(src: str, dst: str, log: Callable[[str], None] = print) -> str:
    """Convert the JAX checkpoint directory ``src`` into the port's ``dst``;
    returns the absolute ``dst``."""
    from unirec_tpu.utils.checkpoint import load_checkpoint, read_meta
    from unirec_tpu_torch.train.common import optimizer_state_from_optax
    from unirec_tpu_torch.utils.checkpoint import save_converted_checkpoint

    meta = read_meta(src)
    kind = KINDS.get(meta.get("config_class"))
    if kind is None:
        raise ValueError(f"{src}: meta.json config_class "
                         f"{meta.get('config_class')!r} is none of "
                         f"{sorted(KINDS)}")
    raw, _ = load_checkpoint(src)
    opt = raw["opt_state"]
    if isinstance(opt, Mapping) and opt.get("pp_layout"):
        step = int(np.asarray(raw["step"]))
        out = save_converted_checkpoint(dst, plain(raw["params"]), meta, step)
        log(f"{src}: saved under pipeline parallelism (optimizer state "
            "{'pp_layout': True}); converted the parameters and step "
            f"{step} to {out}, no optimizer state: a --resume restarts the "
            "optimizer, as the JAX package's resume does")
        return out
    grad_accum = int(meta.get("grad_accum", 1))
    layout = optimizer_layout(opt, grad_accum)
    tmpl = template_state(kind, meta, raw["params"], layout)
    tree, _ = load_checkpoint(src, target={"params": tmpl.params,
                                           "opt_state": tmpl.opt_state,
                                           "step": 0})
    step = int(np.asarray(tree["step"]))
    optimizer = optimizer_state_from_optax(plain(tree["opt_state"]),
                                           grad_accum)
    out = save_converted_checkpoint(dst, plain(tree["params"]), meta, step,
                                    optimizer)
    log(f"{src} ({kind}, step {step}, gradient accumulation {grad_accum}, "
        f"{len(optimizer['mu'])} trained tensors) -> {out}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="the JAX checkpoint directory "
                        "(state/ and meta.json)")
    parser.add_argument("dst", help="the port's checkpoint directory to write")
    args = parser.parse_args(argv)
    convert(args.src, args.dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
