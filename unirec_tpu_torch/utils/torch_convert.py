"""Readers and writers of reference checkpoints (the port's copy of
``unirec_tpu/utils/torch_convert.py``, numpy only).

Readers: ``best_qformer_model.pth`` (a torch pickle ``{model_state_dict,
config: BertConfig, field_names}``, reference:
training/item_qformer_training.py:178-182), the user stage's
``best_user_qformer_model.pth``, BERT LM heads, the joint model's PEFT
layout, Hugging Face Qwen3 and the MWNE number encoder.  Each ``convert_*``
maps a reference state_dict to the JAX package's parameter tree (numpy
leaves, Flax names and ``kernel [in, out]`` layout), which
``utils/weights.flax_to_state_dict`` (or one of its wrappers) turns into the
port's state_dict: the same two steps the JAX package takes, so both
packages read one checkpoint to the same weights.

Writers, the inverse direction: ``export_*`` take a Flax-layout tree (the
port's state_dict through ``utils/weights.state_dict_to_flax``) to the
reference's state_dicts, synthesising what the reference modules hold and
the functional tree has no reason to (zero text tables and text FFNs, the
``position_ids`` buffer); ``save_reference_*`` write the reference's files,
and ``save_pretrained_directory`` the joint trainer's ``save_pretrained``
directory.  The pickled ``BertConfig`` is ``transformers``' own where that
package is installed and ``ReferenceBertConfig`` (the same attributes)
where it is not; ``adapter_config.json`` is written from the port's own dict
with the keys ``peft`` writes, so neither writer needs ``peft``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from unirec_tpu_torch.configs import (
    ItemQFormerConfig,
    LoRAConfig,
    MWNEConfig,
    QFormerConfig,
    UserQFormerConfig,
)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _dense(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """torch nn.Linear -> Flax Dense (the kernel is transposed)."""
    out = {"kernel": _np(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def _layernorm(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[prefix + ".weight"]),
            "bias": _np(sd[prefix + ".bias"])}


def _attention(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """BertAttention (self or cross) -> QFormerAttention parameters."""
    out = {
        "query": _dense(sd, f"{prefix}.self.query"),
        "key": _dense(sd, f"{prefix}.self.key"),
        "value": _dense(sd, f"{prefix}.self.value"),
        "output_dense": _dense(sd, f"{prefix}.output.dense"),
        "output_LayerNorm": _layernorm(sd, f"{prefix}.output.LayerNorm"),
    }
    if f"{prefix}.self.distance_embedding.weight" in sd:
        out["distance_embedding"] = {
            "embedding": _np(sd[f"{prefix}.self.distance_embedding.weight"])}
    return out


def _ffn(sd: Mapping[str, Any], inter_prefix: str,
         out_prefix: str) -> Dict[str, Any]:
    return {
        "intermediate_dense": _dense(sd, f"{inter_prefix}.dense"),
        "output_dense": _dense(sd, f"{out_prefix}.dense"),
        "output_LayerNorm": _layernorm(sd, f"{out_prefix}.LayerNorm"),
    }


def convert_qformer_model(sd: Mapping[str, Any], config: QFormerConfig,
                          prefix: str = "") -> Dict[str, Any]:
    """Torch BertModel state_dict -> QFormerModel parameter tree."""
    p = prefix
    emb: Dict[str, Any] = {"LayerNorm": _layernorm(sd, f"{p}embeddings.LayerNorm")}
    if f"{p}embeddings.word_embeddings.weight" in sd:
        emb["word_embeddings"] = {
            "embedding": _np(sd[f"{p}embeddings.word_embeddings.weight"])}
        emb["position_embeddings"] = {
            "embedding": _np(sd[f"{p}embeddings.position_embeddings.weight"])}
    encoder: Dict[str, Any] = {}
    for i in range(config.num_hidden_layers):
        lp = f"{p}encoder.layer.{i}"
        layer: Dict[str, Any] = {
            "attention": _attention(sd, f"{lp}.attention"),
            "ffn_query": _ffn(sd, f"{lp}.intermediate_query",
                              f"{lp}.output_query"),
        }
        if f"{lp}.crossattention.self.query.weight" in sd:
            layer["crossattention"] = _attention(sd, f"{lp}.crossattention")
        if f"{lp}.intermediate.dense.weight" in sd:
            layer["ffn"] = _ffn(sd, f"{lp}.intermediate", f"{lp}.output")
        encoder[f"layer_{i}"] = layer
    out = {"embeddings": emb, "encoder": encoder}
    if f"{p}pooler.dense.weight" in sd:
        out["pooler"] = {"dense": _dense(sd, f"{p}pooler.dense")}
    return out


def convert_item_qformer(sd: Mapping[str, Any],
                         config: ItemQFormerConfig) -> Dict[str, Any]:
    """Torch QFormerForItemRepresentation state_dict -> ItemQFormer tree
    (the field_projection Linear(K -> F) weight [F, K] becomes the
    DenseGeneral kernel [K, F])."""
    return {
        "query_embeddings": _np(sd["query_embeddings"]),
        "qformer": convert_qformer_model(sd, config.qformer(),
                                         prefix="qformer."),
        "item_representation_head": _dense(sd, "item_representation_head"),
        "reconstruction_head": _dense(sd, "reconstruction_head"),
        "field_projection": {
            "kernel": _np(sd["field_projection.weight"]).T,
            "bias": _np(sd["field_projection.bias"]),
        },
    }


def convert_user_qformer(sd: Mapping[str, Any],
                         config: UserQFormerConfig) -> Dict[str, Any]:
    """Torch UserQFormer state_dict -> the JAX ``UserQFormer`` tree (the
    prediction head is a Sequential[Linear, GELU, LayerNorm, Linear]:
    indices 0, 2, 3; reference: training/user_qformer_training.py:17-45)."""
    return {
        "query_embeddings": _np(sd["query_embeddings"]),
        "qformer": convert_qformer_model(sd, config.qformer(),
                                         prefix="qformer."),
        "head_dense1": _dense(sd, "prediction_head.0"),
        "head_norm": _layernorm(sd, "prediction_head.2"),
        "head_dense2": _dense(sd, "prediction_head.3"),
    }


def convert_qformer_lm_head(sd: Mapping[str, Any],
                            prefix: str = "cls.predictions") -> Dict[str, Any]:
    """BertLMPredictionHead -> ``QFormerLMPredictionHead`` tree
    (transform.dense -> gelu -> LayerNorm -> decoder, whose bias may stand
    alone as ``{prefix}.bias``)."""
    decoder = {"kernel": _np(sd[f"{prefix}.decoder.weight"]).T}
    if f"{prefix}.decoder.bias" in sd:
        decoder["bias"] = _np(sd[f"{prefix}.decoder.bias"])
    elif f"{prefix}.bias" in sd:
        decoder["bias"] = _np(sd[f"{prefix}.bias"])
    return {
        "transform_dense": _dense(sd, f"{prefix}.transform.dense"),
        "transform_LayerNorm": _layernorm(sd, f"{prefix}.transform.LayerNorm"),
        "decoder": decoder,
    }


def convert_qformer_lm_model(sd: Mapping[str, Any], config) -> Dict[str, Any]:
    """Torch BertLMHeadModel state_dict -> ``QFormerLMHeadModel`` tree."""
    return {"bert": convert_qformer_model(sd, config, prefix="bert."),
            "cls": convert_qformer_lm_head(sd)}


def convert_qwen3(sd: Mapping[str, Any], num_layers: int) -> Dict[str, Any]:
    """HF Qwen3Model state_dict -> the JAX ``Qwen3Model`` parameter tree.

    Accepts both bare-model keys (``layers.0...``) and ``model.``-prefixed
    keys (full checkpoints).  LoRA params are not present in HF checkpoints;
    they initialize fresh (zeros for lora_b -> identity overlay).
    """
    def get(k: str) -> np.ndarray:
        if k in sd:
            return _np(sd[k])
        return _np(sd["model." + k])

    def lin(prefix: str) -> Dict[str, np.ndarray]:
        out = {"kernel": get(prefix + ".weight").T}
        if prefix + ".bias" in sd or ("model." + prefix + ".bias") in sd:
            out["bias"] = get(prefix + ".bias")
        return out

    params: Dict[str, Any] = {
        "embed_tokens": get("embed_tokens.weight"),
        "norm": {"scale": get("norm.weight")},
    }
    for i in range(num_layers):
        lp = f"layers.{i}"
        params[f"layers_{i}"] = {
            "self_attn": {
                "q_proj": lin(f"{lp}.self_attn.q_proj"),
                "k_proj": lin(f"{lp}.self_attn.k_proj"),
                "v_proj": lin(f"{lp}.self_attn.v_proj"),
                "o_proj": lin(f"{lp}.self_attn.o_proj"),
                "q_norm": {"scale": get(f"{lp}.self_attn.q_norm.weight")},
                "k_norm": {"scale": get(f"{lp}.self_attn.k_norm.weight")},
            },
            "mlp": {
                "gate_proj": lin(f"{lp}.mlp.gate_proj"),
                "up_proj": lin(f"{lp}.mlp.up_proj"),
                "down_proj": lin(f"{lp}.mlp.down_proj"),
            },
            "input_layernorm": {"scale": get(f"{lp}.input_layernorm.weight")},
            "post_attention_layernorm": {
                "scale": get(f"{lp}.post_attention_layernorm.weight")
            },
        }
    return params


def load_reference_item_qformer_checkpoint(path: str):
    """A reference ``best_qformer_model.pth`` -> (ItemQFormerConfig,
    ``{"params": tree}``, field_names)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    bert_cfg = ckpt["config"]
    field_names = ckpt["field_names"]
    cfg = ItemQFormerConfig(
        hidden_size=bert_cfg.hidden_size,
        num_hidden_layers=bert_cfg.num_hidden_layers,
        num_attention_heads=bert_cfg.num_attention_heads,
        intermediate_size=bert_cfg.intermediate_size,
        num_query_tokens=bert_cfg.query_length,
        field_embedding_dim=bert_cfg.encoder_width,
        num_fields=len(field_names),
        dropout=bert_cfg.hidden_dropout_prob,
    )
    params = convert_item_qformer(ckpt["model_state_dict"], cfg)
    return cfg, {"params": params}, field_names


# ---------------------------------------------------------------------------
# Export (Flax layout -> reference torch state_dict): checkpoints trained
# here load into the reference's consumers (reference:
# data_processing/qformer_inference.py:25-48 reads {model_state_dict, config,
# field_names} and rebuilds QFormerForItemRepresentation from it).
# ---------------------------------------------------------------------------


class ReferenceBertConfig:
    """The fields of ``transformers.BertConfig`` that the reference's
    readers take, pickled in its place where ``transformers`` is not
    installed (attribute access, ``to_dict``)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


def _bert_config(qc: QFormerConfig, dropout: float):
    """The stock ``BertConfig`` the reference wrappers build
    (models/qformer_utils.py:23-28; extra fields ride PretrainedConfig's
    kwargs), with the CONFIGURED dropout: the kernel training flags zero the
    derived probability dropout, the exported description keeps the
    user's rate."""
    fields = dict(
        hidden_size=qc.hidden_size,
        num_hidden_layers=qc.num_hidden_layers,
        num_attention_heads=qc.num_attention_heads,
        intermediate_size=qc.intermediate_size,
        hidden_dropout_prob=dropout,
        attention_probs_dropout_prob=dropout,
        add_cross_attention=qc.add_cross_attention,
        query_length=qc.query_length,
        encoder_width=qc.encoder_width,
        cross_attention_freq=qc.cross_attention_freq,
        vocab_size=qc.vocab_size,
        max_position_embeddings=qc.max_position_embeddings,
    )
    try:
        from transformers import BertConfig
    except ImportError:
        return ReferenceBertConfig(**fields)
    return BertConfig(**fields)


def _put_dense(sd: Dict[str, np.ndarray], prefix: str,
               p: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
    if "bias" in p:
        sd[prefix + ".bias"] = _np(p["bias"])


def _put_layernorm(sd: Dict[str, np.ndarray], prefix: str,
                   p: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = _np(p["scale"])
    sd[prefix + ".bias"] = _np(p["bias"])


def _put_attention(sd: Dict[str, np.ndarray], prefix: str,
                   p: Mapping[str, Any]) -> None:
    _put_dense(sd, f"{prefix}.self.query", p["query"])
    _put_dense(sd, f"{prefix}.self.key", p["key"])
    _put_dense(sd, f"{prefix}.self.value", p["value"])
    _put_dense(sd, f"{prefix}.output.dense", p["output_dense"])
    _put_layernorm(sd, f"{prefix}.output.LayerNorm", p["output_LayerNorm"])
    if "distance_embedding" in p:
        sd[f"{prefix}.self.distance_embedding.weight"] = _np(
            p["distance_embedding"]["embedding"])


def _put_ffn(sd: Dict[str, np.ndarray], inter_prefix: str, out_prefix: str,
             p: Mapping[str, Any]) -> None:
    _put_dense(sd, f"{inter_prefix}.dense", p["intermediate_dense"])
    _put_dense(sd, f"{out_prefix}.dense", p["output_dense"])
    _put_layernorm(sd, f"{out_prefix}.LayerNorm", p["output_LayerNorm"])


def _zero_ffn(sd: Dict[str, np.ndarray], inter_prefix: str, out_prefix: str,
              hidden: int, inter: int) -> None:
    """A text FFN the tree never created (query-only flows never run it;
    the reference module holds one regardless): zero Linears and an
    identity LayerNorm."""
    sd[f"{inter_prefix}.dense.weight"] = np.zeros((inter, hidden), np.float32)
    sd[f"{inter_prefix}.dense.bias"] = np.zeros((inter,), np.float32)
    sd[f"{out_prefix}.dense.weight"] = np.zeros((hidden, inter), np.float32)
    sd[f"{out_prefix}.dense.bias"] = np.zeros((hidden,), np.float32)
    sd[f"{out_prefix}.LayerNorm.weight"] = np.ones((hidden,), np.float32)
    sd[f"{out_prefix}.LayerNorm.bias"] = np.zeros((hidden,), np.float32)


def export_qformer_model(params: Mapping[str, Any], config: QFormerConfig,
                         prefix: str = "") -> Dict[str, np.ndarray]:
    """QFormerModel tree -> torch BertModel state_dict (numpy values), the
    inverse of ``convert_qformer_model``, strict-clean against the reference
    module (reference: models/qformer.py:50-75, :288-294): missing word and
    position tables become zeros, missing text FFNs ``_zero_ffn``, and
    ``embeddings.position_ids`` is ``arange(max_position_embeddings)``."""
    p = prefix
    sd: Dict[str, np.ndarray] = {}
    emb = params["embeddings"]
    _put_layernorm(sd, f"{p}embeddings.LayerNorm", emb["LayerNorm"])
    hidden = config.hidden_size
    for name, rows in (("word_embeddings", config.vocab_size),
                       ("position_embeddings", config.max_position_embeddings)):
        sd[f"{p}embeddings.{name}.weight"] = (
            _np(emb[name]["embedding"]) if name in emb
            else np.zeros((rows, hidden), np.float32))
    sd[f"{p}embeddings.position_ids"] = np.arange(
        config.max_position_embeddings, dtype=np.int64)[None, :]
    for i in range(config.num_hidden_layers):
        layer = params["encoder"][f"layer_{i}"]
        lp = f"{p}encoder.layer.{i}"
        _put_attention(sd, f"{lp}.attention", layer["attention"])
        if "crossattention" in layer:
            _put_attention(sd, f"{lp}.crossattention", layer["crossattention"])
        _put_ffn(sd, f"{lp}.intermediate_query", f"{lp}.output_query",
                 layer["ffn_query"])
        if "ffn" in layer:
            _put_ffn(sd, f"{lp}.intermediate", f"{lp}.output", layer["ffn"])
        else:
            _zero_ffn(sd, f"{lp}.intermediate", f"{lp}.output", hidden,
                      config.intermediate_size)
    if "pooler" in params:
        _put_dense(sd, f"{p}pooler.dense", params["pooler"]["dense"])
    return sd


def export_item_qformer(params: Mapping[str, Any],
                        config: ItemQFormerConfig) -> Dict[str, np.ndarray]:
    """ItemQFormer tree -> torch QFormerForItemRepresentation state_dict
    (the inverse of ``convert_item_qformer``)."""
    sd: Dict[str, np.ndarray] = {
        "query_embeddings": _np(params["query_embeddings"]),
        "field_projection.weight": np.ascontiguousarray(
            _np(params["field_projection"]["kernel"]).T),
        "field_projection.bias": _np(params["field_projection"]["bias"]),
    }
    _put_dense(sd, "item_representation_head",
               params["item_representation_head"])
    _put_dense(sd, "reconstruction_head", params["reconstruction_head"])
    sd.update(export_qformer_model(params["qformer"], config.qformer(),
                                   prefix="qformer."))
    return sd


def export_user_qformer(params: Mapping[str, Any],
                        config: UserQFormerConfig) -> Dict[str, np.ndarray]:
    """UserQFormer tree -> torch state_dict (the inverse of
    ``convert_user_qformer``)."""
    sd: Dict[str, np.ndarray] = {
        "query_embeddings": _np(params["query_embeddings"])}
    _put_dense(sd, "prediction_head.0", params["head_dense1"])
    _put_layernorm(sd, "prediction_head.2", params["head_norm"])
    _put_dense(sd, "prediction_head.3", params["head_dense2"])
    sd.update(export_qformer_model(params["qformer"], config.qformer(),
                                   prefix="qformer."))
    return sd


def _tensors(sd: Mapping[str, np.ndarray]):
    import torch

    # copies: array leaves may be read-only views
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def save_reference_item_qformer_checkpoint(path: str,
                                           params: Mapping[str, Any],
                                           config: ItemQFormerConfig,
                                           field_names) -> None:
    """Write a reference-schema ``best_qformer_model.pth``: exactly the
    reference trainer's ``{model_state_dict, config, field_names}``
    (training/item_qformer_training.py:176-186)."""
    import torch

    torch.save({"model_state_dict": _tensors(export_item_qformer(params,
                                                                 config)),
                "config": _bert_config(config.qformer(), config.dropout),
                "field_names": list(field_names)}, path)


def save_reference_user_qformer_checkpoint(path: str,
                                           params: Mapping[str, Any],
                                           config: UserQFormerConfig,
                                           epoch: int = 0,
                                           loss: float = 0.0) -> None:
    """Write a reference-schema ``best_user_qformer_model.pth``
    ({model_state_dict, config, epoch, loss}, training/
    user_qformer_training.py:218-228)."""
    import torch

    torch.save({"model_state_dict": _tensors(export_user_qformer(params,
                                                                 config)),
                "config": _bert_config(config.qformer(), config.dropout),
                "epoch": int(epoch), "loss": float(loss)}, path)


def export_joint_model(params: Mapping[str, Any], qwen_config,
                       qformer_config: ItemQFormerConfig
                       ) -> Dict[str, np.ndarray]:
    """Joint tree -> the reference ``MultiModalQwenEmbedding`` state_dict in
    the PEFT-wrapped layout it trains (train_item_individual_token_joint.py:
    88-132): the Q-Former under ``qformer_model.*``; the Qwen3 under
    ``base_model.base_model.model.*`` with ``<proj>.base_layer.weight`` and
    ``lora_A`` / ``lora_B.default.weight`` for adapted projections; the
    ``embed_tokens`` / ``extra_embed_tokens`` split merged back into the
    resized table.  The inverse of ``convert_joint_model``."""
    sd: Dict[str, np.ndarray] = {}
    for k, v in export_item_qformer(params["qformer"], qformer_config).items():
        sd["qformer_model." + k] = v
    base = params["base_model"]
    bp = "base_model.base_model.model."
    embed = _np(base["embed_tokens"])
    if "extra_embed_tokens" in base:
        embed = np.concatenate([embed, _np(base["extra_embed_tokens"])], axis=0)
    sd[bp + "embed_tokens.weight"] = embed
    sd[bp + "norm.weight"] = _np(base["norm"]["scale"])

    def put_proj(prefix: str, p: Mapping[str, Any]) -> None:
        lora = "lora_a" in p
        stem = f"{prefix}.base_layer" if lora else prefix
        sd[f"{stem}.weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
        if "bias" in p:
            sd[f"{stem}.bias"] = _np(p["bias"])
        if lora:
            sd[f"{prefix}.lora_A.default.weight"] = np.ascontiguousarray(
                _np(p["lora_a"]).T)
            sd[f"{prefix}.lora_B.default.weight"] = np.ascontiguousarray(
                _np(p["lora_b"]).T)

    for i in range(qwen_config.num_hidden_layers):
        layer = base[f"layers_{i}"]
        lp = f"{bp}layers.{i}"
        attn, mlp = layer["self_attn"], layer["mlp"]
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            put_proj(f"{lp}.self_attn.{proj}", attn[proj])
        sd[f"{lp}.self_attn.q_norm.weight"] = _np(attn["q_norm"]["scale"])
        sd[f"{lp}.self_attn.k_norm.weight"] = _np(attn["k_norm"]["scale"])
        for proj in ("gate_proj", "up_proj", "down_proj"):
            put_proj(f"{lp}.mlp.{proj}", mlp[proj])
        sd[f"{lp}.input_layernorm.weight"] = _np(
            layer["input_layernorm"]["scale"])
        sd[f"{lp}.post_attention_layernorm.weight"] = _np(
            layer["post_attention_layernorm"]["scale"])
    return sd


def convert_joint_model(sd: Mapping[str, Any], qwen_config,
                        qformer_config: ItemQFormerConfig) -> Dict[str, Any]:
    """Reference ``MultiModalQwenEmbedding`` state_dict -> joint tree.  The
    PEFT-wrapped layout (train_item_individual_token_joint.py:88-132,
    183-200) or an un-wrapped one; the resized table (vocab + 20 special
    rows, :118-119) splits into ``embed_tokens`` + ``extra_embed_tokens``."""
    qwen_sd: Dict[str, Any] = {}
    lora_sd: Dict[str, Any] = {}
    qformer_sd: Dict[str, Any] = {}
    for key, value in sd.items():
        if key.startswith("qformer_model."):
            qformer_sd[key[len("qformer_model."):]] = value
            continue
        k = key
        while k.startswith("base_model."):
            k = k[len("base_model."):]
        if k.startswith("model."):
            k = k[len("model."):]
        if ".lora_A." in k or ".lora_B." in k:
            lora_sd[k] = value
        else:
            qwen_sd[k.replace(".base_layer.", ".")] = value
    base = convert_qwen3(qwen_sd, qwen_config.num_hidden_layers)
    vocab = qwen_config.vocab_size
    full_embed = base["embed_tokens"]
    if full_embed.shape[0] > vocab:
        base["embed_tokens"] = full_embed[:vocab]
        base["extra_embed_tokens"] = full_embed[vocab:]
    for k, v in lora_sd.items():
        # layers.{i}.(self_attn|mlp).{proj}.lora_[AB][.default].weight
        parts = k.split(".")
        dest = base[f"layers_{int(parts[1])}"][parts[2]][parts[3]]
        if parts[4] == "lora_A":
            dest["lora_a"] = _np(v).T
        elif parts[4] == "lora_B":
            dest["lora_b"] = _np(v).T
        else:
            raise KeyError(f"unrecognized LoRA key {k}")
    return {"base_model": base,
            "qformer": convert_item_qformer(qformer_sd, qformer_config)}


# ---------------------------------------------------------------------------
# MWNE (math-aware number encoder) checkpoints: the reference ItemEncoder
# loads a self-trained number encoder from
# number_encoders/mathematical_encoder_1024d_normalized.pth (reference:
# models/item_encoder_pure_value.py:68-70, schema written at
# models/mwne.py:784-806, loaded at :613-663).
# ---------------------------------------------------------------------------


def convert_mwne(ckpt: Mapping[str, Any]):
    """Reference MWNE checkpoint dict -> (MWNEConfig, Flax-layout variables).

    ``encoder_state_dict`` holds the BASE encoder's weights only
    (``frequencies`` buffer, ``fourier_weight``, ``raw_scale``,
    ``extra_proj.weight``); the reference's ``load_trained_encoder`` wraps it
    in a fresh normalizer, so the running statistics are the init values
    (ones and 0)."""
    ec = ckpt["encoder_config"]
    nc = ckpt.get("normalization_config") or {}
    cfg = MWNEConfig(
        embedding_dim=int(ec["embedding_dim"]),
        num_frequencies=int(ec["num_frequencies"]),
        max_frequency=float(ec["max_frequency"]),
        include_raw=bool(ec["include_raw"]),
        target_std=float(nc.get("target_std") or 1.0),
        momentum=float(nc.get("momentum") or 0.99),
        min_std=float(nc.get("min_std") or 0.1),
    )
    sd = {k: _np(v) for k, v in ckpt["encoder_state_dict"].items()}
    # the frequencies follow from the config; a checkpoint whose buffer
    # disagrees with its own config cannot be converted faithfully
    if "frequencies" in sd:
        expect = np.logspace(-2, np.log10(cfg.max_frequency),
                             cfg.num_frequencies)
        if not np.allclose(sd["frequencies"], expect, rtol=1e-4):
            raise ValueError(
                "checkpoint 'frequencies' buffer does not match the "
                "logspace(-2, log10(max_frequency)) grid implied by its own "
                "encoder_config")
    base: Dict[str, Any] = {"fourier_weight": sd["fourier_weight"]}
    if cfg.include_raw:
        base["raw_scale"] = sd["raw_scale"]
    if cfg.extra_dim > 0:
        # torch Linear(1, extra) weight [extra, 1] -> Flax kernel [1, extra]
        base["extra_proj"] = {"kernel": sd["extra_proj.weight"].T}
    variables = {
        "params": {"base": base},
        "batch_stats": {
            "running_std": np.ones((cfg.embedding_dim,), np.float32),
            "num_batches_tracked": np.zeros((), np.int32),
        },
    }
    return cfg, variables


def load_reference_mwne_checkpoint(path: str):
    """A reference ``mathematical_encoder_*d_normalized.pth`` ->
    (MWNEConfig, Flax-layout variables)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_mwne(ckpt)


def export_mwne(cfg: MWNEConfig, variables: Mapping[str, Any],
                final_metrics: Mapping[str, float] = None) -> Dict[str, Any]:
    """(MWNEConfig, Flax-layout variables or ``{"base": ...}``) -> the
    reference checkpoint dict, the inverse of ``convert_mwne``;
    ``final_metrics`` as the reference trainer records them
    (models/mwne.py:796-803)."""
    params = (variables["params"]["base"] if "params" in variables
              else variables["base"])
    sd: Dict[str, np.ndarray] = {
        "frequencies": np.logspace(-2, np.log10(cfg.max_frequency),
                                   cfg.num_frequencies).astype(np.float32),
        "fourier_weight": _np(params["fourier_weight"]),
    }
    if cfg.include_raw:
        sd["raw_scale"] = _np(params["raw_scale"])
    if cfg.extra_dim > 0:
        sd["extra_proj.weight"] = np.ascontiguousarray(
            _np(params["extra_proj"]["kernel"]).T)
    out = {
        "encoder_state_dict": sd,
        "encoder_config": {
            "embedding_dim": cfg.embedding_dim,
            "num_frequencies": cfg.num_frequencies,
            "max_frequency": cfg.max_frequency,
            "include_raw": cfg.include_raw,
        },
        "normalization_config": {
            "use_normalization": True,
            "target_std": cfg.target_std,
            "momentum": cfg.momentum,
            "min_std": cfg.min_std,
        },
    }
    if final_metrics is not None:
        out["final_metrics"] = dict(final_metrics)
    return out


def save_reference_mwne_checkpoint(path: str, cfg: MWNEConfig,
                                   variables: Mapping[str, Any],
                                   final_metrics: Mapping[str, float] = None
                                   ) -> None:
    import torch

    ckpt = export_mwne(cfg, variables, final_metrics)
    ckpt["encoder_state_dict"] = {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in ckpt["encoder_state_dict"].items()}
    torch.save(ckpt, path)


# ---------------------------------------------------------------------------
# The reference joint trainer's ``save_pretrained`` directory
# (train_item_individual_token_joint.py:183-200).
# ---------------------------------------------------------------------------


def adapter_config(lora_config: LoRAConfig, base_model_name: str
                   ) -> Dict[str, Any]:
    """``adapter_config.json`` as ``peft`` writes it for the reference's
    ``LoraConfig(task_type=FEATURE_EXTRACTION, bias="none", ...)`` (the keys
    of peft 0.19.1's ``LoraConfig.save_pretrained``)."""
    return {
        "alora_invocation_tokens": None, "alpha_pattern": {},
        "arrow_config": None, "auto_mapping": None,
        "base_model_name_or_path": base_model_name, "bias": "none",
        "corda_config": None, "ensure_weight_tying": False,
        "eva_config": None, "exclude_modules": None, "fan_in_fan_out": False,
        "inference_mode": False, "init_lora_weights": True,
        "layer_replication": None, "layers_pattern": None,
        "layers_to_transform": None, "loftq_config": {},
        "lora_alpha": lora_config.alpha, "lora_bias": False,
        "lora_dropout": lora_config.dropout, "lora_ga_config": None,
        "megatron_config": None, "megatron_core": "megatron.core",
        "modules_to_save": None, "peft_type": "LORA",
        "peft_version": "0.19.1", "qalora_group_size": 16,
        "r": lora_config.r, "rank_pattern": {}, "revision": None,
        "target_modules": sorted(lora_config.target_modules),
        "target_parameters": None, "task_type": "FEATURE_EXTRACTION",
        "trainable_token_indices": None, "use_bdlora": None,
        "use_dora": False, "use_qalora": False, "use_rslora": False,
    }


def save_pretrained_directory(save_directory: str, params: Mapping[str, Any],
                              qwen_config, qformer_config: ItemQFormerConfig,
                              lora_config: LoRAConfig = None, tokenizer=None,
                              base_model_name: str = "Qwen/Qwen3-Embedding-0.6B"
                              ) -> None:
    """Write a joint tree as the reference's ``save_pretrained`` directory:

    * ``adapter_config.json`` + ``adapter_model.bin``: the PEFT adapter,
      loadable by ``peft.PeftModel.from_pretrained`` on the same resized
      base model (``adapter_config``);
    * ``qformer_model.bin``: the Q-Former state_dict (strict into the
      reference ``QFormerForItemRepresentation``);
    * ``model_config.json``: ``{"hidden_size", "use_lora"}``;
    * the tokenizer's files, when a Hugging Face ``tokenizer`` is passed.

    As in the reference's own artifact, the adapter carries no base weights
    and not the 20 resized special-token rows (``export_joint_model``'s
    full state_dict carries them)."""
    import json
    import os

    import torch

    lora_config = lora_config or LoRAConfig()
    os.makedirs(save_directory, exist_ok=True)
    sd = export_joint_model(params, qwen_config, qformer_config)
    torch.save({k[len("qformer_model."):]: torch.from_numpy(
                    np.ascontiguousarray(v))
                for k, v in sd.items() if k.startswith("qformer_model.")},
               os.path.join(save_directory, "qformer_model.bin"))
    # PEFT's keys drop the outer wrapper and the adapter name:
    # base_model.base_model.model.X.lora_A.default.weight
    #   -> base_model.model.X.lora_A.weight
    torch.save({k[len("base_model."):].replace(".default.", "."):
                    torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items() if ".lora_A." in k or ".lora_B." in k},
               os.path.join(save_directory, "adapter_model.bin"))
    with open(os.path.join(save_directory, "adapter_config.json"), "w") as f:
        json.dump(adapter_config(lora_config, base_model_name), f, indent=2,
                  sort_keys=True)
    if tokenizer is not None:
        tokenizer.save_pretrained(save_directory)
    with open(os.path.join(save_directory, "model_config.json"), "w") as f:
        json.dump({"hidden_size": int(qwen_config.hidden_size),
                   "use_lora": True}, f, indent=2)
