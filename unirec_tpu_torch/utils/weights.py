"""Weights for the joint model: the bridge from the JAX parameter tree and a
seeded initialiser.

``joint_state_dict_from_flax`` takes the JAX package's ``MultiModalQwenEmbedding``
parameters as numpy arrays and returns the port's ``state_dict``.  The port's
module tree mirrors the Flax tree, so names map one to one: ``layers_{i}`` ->
``layers.{i}``, ``layer_{i}`` -> ``layer.{i}``, a Dense ``kernel [in, out]``
-> ``weight [out, in]`` (transposed), a norm ``scale`` -> ``weight``.  The
port holds only what the forward uses: no zero text FFNs and no 30522-row
word table, which ``unirec_tpu.utils.torch_convert.export_qformer_model``
synthesises for the reference layout.

A reference ``.pth`` of the joint model loads by composing the two numpy-only
functions::

    flax_params = torch_convert.convert_joint_model(sd, qwen_cfg, qf_cfg)
    model.load_state_dict(joint_state_dict_from_flax(flax_params, qwen_cfg, qf_cfg))

``init_joint`` and ``init_item_qformer`` build full-size models on a device
from a ``torch.Generator`` with the Flax initialisers' distributions, for
runs that have no checkpoint (the card machine has no Flax to make weights
with).  ``item_qformer_state_dict_from_flax`` is the bridge for an Item
Q-Former tree, a reference ``.pth`` converted by ``torch_convert`` included.
``qweights_from_flax`` carries a JAX ``qweights`` collection (the int8 Qwen3
projections) across.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from unirec_tpu.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    Qwen3Config,
)
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding

_INDEXED = re.compile(r"^(layers|layer)_(\d+)$")
# text-side Q-Former parameters that a reference checkpoint carries but the
# item Q-Former's query-only forward never reads (keys of a bare Item
# Q-Former tree, or of one nested in the joint model under "qformer.")
_TEXT_SIDE = re.compile(
    r"^(qformer\.)?qformer\.(embeddings\.(word|position)_embeddings\."
    r"|encoder\.layer\.\d+\.ffn\.|pooler\.)")


def _flatten(tree: Mapping[str, Any], prefix=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Any Flax parameter tree of a ported module (``{"params": ...}`` or the
    bare tree) -> float32 ``state_dict`` by the one-to-one name map."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        names = []
        for part in path[:-1]:
            m = _INDEXED.match(part)
            names.extend((m.group(1), m.group(2)) if m else (part,))
        arr = np.array(leaf, np.float32)  # a writable copy
        leaf_name = path[-1]
        if leaf_name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D kernel")
            arr, leaf_name = arr.T, "weight"
        elif leaf_name == "scale":
            leaf_name = "weight"
        sd[".".join(names + [leaf_name])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return sd


def joint_state_dict_from_flax(params: Mapping[str, Any],
                               qwen_cfg: Qwen3Config,
                               qf_cfg: ItemQFormerConfig
                               ) -> Dict[str, torch.Tensor]:
    """JAX joint parameter tree (numpy or array leaves) -> the port's
    ``MultiModalQwenEmbedding`` state_dict, with the layer counts checked
    against the configs.  Text-side Q-Former entries (word and position
    tables, text FFNs), which a tree converted from a reference checkpoint
    carries, are dropped: the query-only forward never reads them."""
    sd = {k: v for k, v in flax_to_state_dict(params).items()
          if not _TEXT_SIDE.match(k)}
    n_qwen = len({k.split(".")[2] for k in sd if k.startswith("base_model.layers.")})
    n_qf = len({k.split(".")[4] for k in sd
                if k.startswith("qformer.qformer.encoder.layer.")})
    if (n_qwen, n_qf) != (qwen_cfg.num_hidden_layers, qf_cfg.num_hidden_layers):
        raise ValueError(
            f"parameter tree has {n_qwen} Qwen3 / {n_qf} Q-Former layers, "
            f"configs say {qwen_cfg.num_hidden_layers} / "
            f"{qf_cfg.num_hidden_layers}")
    return sd


def qweights_from_flax(qweights: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``qweights`` collection (``quantize_qwen3_weights``' output, as
    numpy or array leaves) -> the port's int8 weights for
    ``models/qwen3.set_qweights``: ``kernel_q [in, out]`` -> ``weight_q
    [out, in]`` int8, ``kernel_scale`` -> ``weight_scale [out]`` float32,
    names mapped as ``flax_to_state_dict`` maps them."""
    tree = qweights.get("qweights", qweights)
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        names = []
        for part in path[:-1]:
            m = _INDEXED.match(part)
            names.extend((m.group(1), m.group(2)) if m else (part,))
        if path[-1] == "kernel_q":
            arr, leaf_name = np.asarray(leaf, np.int8).T, "weight_q"
        elif path[-1] == "kernel_scale":
            arr, leaf_name = np.asarray(leaf, np.float32).reshape(-1), "weight_scale"
        else:
            raise ValueError(f"{'/'.join(path)}: not a qweights leaf")
        out[".".join(names + [leaf_name])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def item_qformer_state_dict_from_flax(params: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """JAX ``ItemQFormer`` parameter tree -> the port's ``ItemQFormer``
    state_dict, without the text-side entries that a tree converted from a
    reference checkpoint carries and the query-only forward never reads."""
    return {k: v for k, v in flax_to_state_dict(params).items()
            if not _TEXT_SIDE.match(k)}


def _fill_normal(p: torch.Tensor, std: float,
                 generator: torch.Generator) -> None:
    """p ~ N(0, std^2), drawn in float32 on the generator's device."""
    draw = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
    draw.normal_(0.0, std, generator=generator)
    p.copy_(draw)


@torch.no_grad()
def init_joint(qwen_cfg: Qwen3Config, qf_cfg: ItemQFormerConfig,
               jc: JointModelConfig, lora: Optional[LoRAConfig],
               generator: torch.Generator, device=None,
               dtype: torch.dtype = torch.float32,
               lora_b_std: float = 0.0) -> MultiModalQwenEmbedding:
    """The joint model with the Flax initialisers' distributions: normal(0.02)
    for dense kernels and embeddings, normal(1.0) for the query embeddings,
    normal(1/r) for ``lora_a``, ones/zeros for norm scales and biases.

    ``lora_b`` is zero as in Flax unless ``lora_b_std > 0``: with zeros the
    LoRA path is computed but contributes nothing."""
    model = MultiModalQwenEmbedding(qwen_cfg, qf_cfg, jc, lora, device=device,
                                    dtype=dtype).eval()
    _flax_init_(model, generator, lora, lora_b_std)
    return model


@torch.no_grad()
def init_item_qformer(cfg: ItemQFormerConfig, generator: torch.Generator,
                      device=None, dtype: torch.dtype = torch.float32
                      ) -> ItemQFormer:
    """The Item Q-Former with the Flax initialisers' distributions:
    normal(1.0) for ``query_embeddings``, normal(0.02) for dense kernels and
    ``field_id_embeddings``, ones/zeros for LayerNorm, zero biases."""
    model = ItemQFormer(cfg, device=device, dtype=dtype).eval()
    _flax_init_(model, generator)
    return model


def _flax_init_(model: torch.nn.Module, generator: torch.Generator,
                lora: Optional[LoRAConfig] = None,
                lora_b_std: float = 0.0) -> None:
    """Fill ``model``'s parameters in place, drawing from ``generator`` in
    module order."""
    norm_types = {"LayerNorm", "RMSNorm"}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if type(module).__name__ in norm_types:
                p.fill_(1.0 if name == "weight" else 0.0)
            elif name == "bias":
                p.zero_()
            elif name == "query_embeddings":
                _fill_normal(p, 1.0, generator)
            elif name == "lora_a":
                _fill_normal(p, 1.0 / lora.r, generator)
            elif name == "lora_b":
                if lora_b_std > 0:
                    _fill_normal(p, lora_b_std, generator)
                else:
                    p.zero_()
            else:  # dense weights and embedding tables
                _fill_normal(p, 0.02, generator)
