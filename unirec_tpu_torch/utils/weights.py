"""Weights for the joint model: the bridge from the JAX parameter tree and a
seeded initialiser.

``joint_state_dict_from_flax`` takes the JAX package's ``MultiModalQwenEmbedding``
parameters as numpy arrays and returns the port's ``state_dict``.  The port's
module tree mirrors the Flax tree, so names map one to one: ``layers_{i}`` ->
``layers.{i}``, ``layer_{i}`` -> ``layer.{i}``, a Dense ``kernel [in, out]``
-> ``weight [out, in]`` (transposed), a norm ``scale`` -> ``weight``.  The
port holds only what the forward uses: no zero text FFNs and no 30522-row
word table, which the JAX package's ``torch_convert.export_qformer_model``
synthesises for the reference layout.

``state_dict_to_flax`` is its inverse, the way back to a Flax-layout tree
that the exporters of ``utils/torch_convert`` write reference files from.

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
projections) across, and ``mwne_state_dict_from_flax`` a number encoder's
parameters and running statistics.  ``user_state_dict_from_flax`` maps the
user trainer's ``{"sequence": ..., "user": ...}`` tree onto
``models/user_qformer.UserStage``, and ``init_user_qformer`` draws that
module's weights from a generator.

The item encoders' towers: ``qwen3_state_dict_from_flax`` maps a JAX
``Qwen3Model`` tree (e.g. ``torch_convert.convert_qwen3`` of a Hugging Face
checkpoint) onto the port's ``models/qwen3.Qwen3Model`` and ``init_qwen3``
draws one from a generator; ``clip_state_dict_from_flax`` maps a JAX CLIP
tower's tree (or ``models/clip.convert_clip_*`` of an HF ``CLIPModel``) onto
``models/clip``'s towers, and ``init_clip_vision`` / ``init_clip_text`` draw
them with the Flax initialisers' distributions.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from unirec_tpu_torch.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    Qwen3Config,
    UserQFormerConfig,
)
from unirec_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextTower,
    CLIPVisionConfig,
    CLIPVisionTower,
)
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding
from unirec_tpu_torch.models.qwen3 import Qwen3Model
from unirec_tpu_torch.models.user_qformer import UserStage

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


def _prune(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A tree without its None leaves (an empty optax state or a masked
    leaf, as orbax restores them) and the branches left empty."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            value = _prune(value)
            if value:
                out[name] = value
        elif value is not None:
            out[name] = value
    return out


def port_state_dict_from_flax(tree: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """A parameter tree of any trainer of the JAX package (item, user, joint,
    MWNE; numpy leaves, ``None`` at masked leaves) -> the port's names:
    ``flax_to_state_dict`` without the text-side Q-Former entries, which the
    query-only forward never reads (bare, under ``qformer.`` or under
    ``user.``).  Applies alike to the optimizer's moments, whose trees mirror
    the parameters'."""
    sd = flax_to_state_dict(_prune(tree))
    return {k: v for k, v in sd.items()
            if not (_TEXT_SIDE.match(k) or (k.startswith("user.")
                    and _TEXT_SIDE.match(k[len("user."):])))}


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: a port state_dict -> the Flax
    parameter tree with numpy leaves (floating ones as float32), which the
    exporters of ``utils/torch_convert`` take.  ``layers.{i}`` /
    ``layer.{i}`` -> ``layers_{i}`` / ``layer_{i}``; a 2-D ``weight`` ->
    ``kernel [in, out]`` (transposed), a 1-D one -> a norm's ``scale``;
    every other leaf (``bias``, ``embedding`` tables, raw parameters,
    buffers) keeps its name and layout."""
    tree: Dict[str, Any] = {}
    for key, value in sd.items():
        parts = key.split(".")
        names, i = [], 0
        while i < len(parts) - 1:
            if (parts[i] in ("layers", "layer") and i + 2 < len(parts)
                    and parts[i + 1].isdigit()):
                names.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
            else:
                names.append(parts[i])
                i += 1
        t = value.detach().cpu()
        arr = t.float().numpy() if t.is_floating_point() else t.numpy()
        leaf = parts[-1]
        if leaf == "weight" and arr.ndim == 2:
            arr, leaf = arr.T, "kernel"
        elif leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        node = tree
        for name in names:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


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
    return port_state_dict_from_flax(params)


def user_state_dict_from_flax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX ``UserQFormerTrainer.init_state`` parameter tree ``{"sequence":
    ..., "user": ...}`` (numpy or array leaves) -> the port's ``UserStage``
    state_dict, without text-side Q-Former entries (the query-only forward
    never reads them)."""
    return port_state_dict_from_flax(params)


def mwne_state_dict_from_flax(variables: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """JAX ``NormalizedMathematicalEncoder`` variables (``params`` and
    ``batch_stats``, numpy or array leaves) -> the port's state_dict:
    ``base.extra_proj.kernel [1, extra]`` -> ``weight [extra, 1]``, the
    running statistics as buffers (``num_batches_tracked`` int32)."""
    sd = flax_to_state_dict(variables.get("params", {}))
    stats = variables.get("batch_stats", {})
    if "running_std" in stats:
        sd["running_std"] = torch.from_numpy(
            np.array(stats["running_std"], np.float32))
    if "num_batches_tracked" in stats:
        sd["num_batches_tracked"] = torch.tensor(
            int(np.asarray(stats["num_batches_tracked"])), dtype=torch.int32)
    return sd


def qwen3_state_dict_from_flax(params: Mapping[str, Any],
                               cfg: Qwen3Config) -> Dict[str, torch.Tensor]:
    """A JAX ``Qwen3Model`` tree (numpy or array leaves) -> the port's
    ``Qwen3Model`` state_dict, its layer count checked against ``cfg``."""
    sd = flax_to_state_dict(params)
    n = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    if n != cfg.num_hidden_layers:
        raise ValueError(f"parameter tree has {n} Qwen3 layers, the config "
                         f"says {cfg.num_hidden_layers}")
    return sd


def qwen3_state_dict_from_hf(path: str, cfg: Qwen3Config
                             ) -> Dict[str, torch.Tensor]:
    """A local Hugging Face Qwen3 checkpoint (no network) -> the port's
    ``Qwen3Model`` state_dict: ``AutoModel.from_pretrained`` in float32,
    ``utils/torch_convert.convert_qwen3``, then the bridge above."""
    from transformers import AutoModel

    from unirec_tpu_torch.utils.torch_convert import convert_qwen3

    hf = AutoModel.from_pretrained(path, torch_dtype=torch.float32,
                                   local_files_only=True)
    return qwen3_state_dict_from_flax(
        convert_qwen3(hf.state_dict(), cfg.num_hidden_layers), cfg)


def clip_state_dict_from_flax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """A JAX ``CLIPVisionTower`` or ``CLIPTextTower`` tree -> the port
    tower's state_dict.  The Dense rule of ``flax_to_state_dict`` holds for
    every leaf but two: the patch convolution's kernel ``[kh, kw, in, out]``
    (NHWC) becomes ``Conv2d.weight [out, in, kh, kw]`` (NCHW), and the token
    table ``token_embedding.embedding`` becomes ``token_embedding.weight``;
    ``class_embedding`` and ``position_embedding`` are raw parameters and
    keep their names."""
    tree = dict(params.get("params", params))
    sd: Dict[str, torch.Tensor] = {}
    conv = tree.pop("patch_embedding", None)
    if conv is not None:
        kernel = np.asarray(conv["kernel"], np.float32)
        if kernel.ndim != 4:
            raise ValueError("patch_embedding: expected a 4-D Conv kernel")
        sd["patch_embedding.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    table = tree.pop("token_embedding", None)
    if table is not None:
        sd["token_embedding.weight"] = torch.from_numpy(
            np.array(table["embedding"], np.float32))
    sd.update(flax_to_state_dict(tree))
    return sd


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
               lora_b_std: float = 0.0,
               param_dtype: Optional[torch.dtype] = None,
               remat: bool = False,
               remat_policy: Optional[str] = None) -> MultiModalQwenEmbedding:
    """The joint model with the Flax initialisers' distributions: normal(0.02)
    for dense kernels and embeddings, normal(1.0) for the query embeddings,
    normal(1/r) for ``lora_a``, ones/zeros for norm scales and biases.

    ``lora_b`` is zero as in Flax unless ``lora_b_std > 0``: with zeros the
    LoRA path is computed but contributes nothing.  ``param_dtype`` (default
    ``dtype``) stores the parameters, ``dtype`` computes: the trainer asks
    for float32 masters under bfloat16 compute.  ``remat`` and
    ``remat_policy`` go to the decoder (``models/qwen3.Qwen3Model``)."""
    model = MultiModalQwenEmbedding(qwen_cfg, qf_cfg, jc, lora, device=device,
                                    dtype=dtype, param_dtype=param_dtype,
                                    remat=remat,
                                    remat_policy=remat_policy).eval()
    _flax_init_(model, generator, lora, lora_b_std)
    return model


@torch.no_grad()
def init_item_qformer(cfg: ItemQFormerConfig, generator: torch.Generator,
                      device=None, dtype: torch.dtype = torch.float32,
                      param_dtype: Optional[torch.dtype] = None,
                      modality_table: bool = False) -> ItemQFormer:
    """The Item Q-Former with the Flax initialisers' distributions:
    normal(1.0) for ``query_embeddings``, normal(0.02) for dense kernels and
    ``field_id_embeddings`` (and ``modality_id_embeddings``), ones/zeros
    for LayerNorm, zero biases.  ``param_dtype`` (default ``dtype``) stores the parameters, ``dtype``
    computes (the trainer's float32 masters under bfloat16 compute)."""
    model = ItemQFormer(cfg, device=device, dtype=dtype,
                        param_dtype=param_dtype,
                        modality_table=modality_table).eval()
    _flax_init_(model, generator)
    return model


@torch.no_grad()
def init_qformer_lm_head(cfg, generator: torch.Generator, device=None,
                         dtype: torch.dtype = torch.float32,
                         param_dtype: Optional[torch.dtype] = None):
    """``models/qformer.QFormerLMHeadModel`` with the Flax initialisers'
    distributions: normal(0.02) for dense kernels and the embedding tables,
    ones/zeros for LayerNorm, zero biases."""
    from unirec_tpu_torch.models.qformer import QFormerLMHeadModel

    model = QFormerLMHeadModel(cfg, device=device, dtype=dtype,
                               param_dtype=param_dtype).eval()
    _flax_init_(model, generator)
    return model


@torch.no_grad()
def init_user_qformer(cfg: UserQFormerConfig, generator: torch.Generator,
                      device=None, dtype: torch.dtype = torch.float32,
                      param_dtype: Optional[torch.dtype] = None) -> UserStage:
    """The user stage with the Flax initialisers' distributions: the context
    encoders' Dense layers lecun-normal (a normal of std 1/sqrt(fan_in) /
    0.8796, truncated at two standard deviations) with zero biases; the
    User Q-Former as ``init_item_qformer`` (normal(1.0) query embeddings,
    normal(0.02) dense kernels and head, ones/zeros LayerNorms, zero
    biases).  ``param_dtype`` stores, ``dtype`` computes."""
    model = UserStage(cfg, device=device, dtype=dtype,
                      param_dtype=param_dtype).eval()
    for module in model.sequence.modules():
        if isinstance(module, torch.nn.Linear):
            std = 1.0 / module.in_features ** 0.5 / 0.87962566103423978
            draw = torch.empty(module.weight.shape, dtype=torch.float32,
                               device=generator.device)
            torch.nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            module.weight.copy_(draw)
            module.bias.zero_()
    _flax_init_(model.user, generator)
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


@torch.no_grad()
def init_qwen3(cfg: Qwen3Config, generator: torch.Generator, device=None,
               dtype: torch.dtype = torch.float32) -> Qwen3Model:
    """A bare Qwen3 decoder (the text backend's tower) with the Flax
    initialisers' distributions: normal(0.02) for dense kernels and the
    embedding table, ones for the RMSNorm scales."""
    model = Qwen3Model(cfg, device=device, dtype=dtype).eval()
    _flax_init_(model, generator)
    return model


def _lecun_normal_(p: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """Flax's default ``lecun_normal``: a normal of std 1/sqrt(fan_in) /
    0.8796, truncated at two standard deviations."""
    std = 1.0 / fan_in ** 0.5 / 0.87962566103423978
    draw = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                                generator=generator)
    p.copy_(draw)


def _clip_init_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """The JAX CLIP towers' initialisers, drawn in module order: Dense and
    Conv kernels ``lecun_normal`` (fan-in = in features; in channels x
    kernel area), zero biases, the token table ``variance_scaling(1,
    fan_in, normal)`` over its width, the class and position embeddings
    normal(0.02), LayerNorms ones/zeros."""
    for module in model.modules():
        if isinstance(module, torch.nn.Conv2d):
            _lecun_normal_(module.weight, module.weight[0].numel(), generator)
        elif isinstance(module, torch.nn.Linear):
            _lecun_normal_(module.weight, module.in_features, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, torch.nn.Embedding):
            _fill_normal(module.weight, module.embedding_dim ** -0.5,
                         generator)
        elif type(module).__name__ == "LayerNorm":
            module.weight.fill_(1.0)
            module.bias.zero_()
        for name in ("class_embedding", "position_embedding"):
            p = module._parameters.get(name)
            if p is not None:
                _fill_normal(p, 0.02, generator)


@torch.no_grad()
def init_clip_vision(cfg: CLIPVisionConfig, generator: torch.Generator,
                     device=None, dtype: torch.dtype = torch.float32
                     ) -> CLIPVisionTower:
    """The CLIP vision tower with the Flax initialisers' distributions."""
    model = CLIPVisionTower(cfg, device=device, dtype=dtype).eval()
    _clip_init_(model, generator)
    return model


@torch.no_grad()
def init_clip_text(cfg: CLIPTextConfig, generator: torch.Generator,
                   device=None, dtype: torch.dtype = torch.float32
                   ) -> CLIPTextTower:
    """The CLIP text tower with the Flax initialisers' distributions."""
    model = CLIPTextTower(cfg, device=device, dtype=dtype).eval()
    _clip_init_(model, generator)
    return model
