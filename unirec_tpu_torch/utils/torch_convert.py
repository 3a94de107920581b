"""Readers for reference checkpoints: ``best_qformer_model.pth`` and the MWNE
number encoder (the port's copy of those parts of
``unirec_tpu/utils/torch_convert.py``).

The reference checkpoint is a torch pickle ``{model_state_dict, config:
BertConfig, field_names}`` (reference: training/item_qformer_training.py:
178-182).  ``convert_item_qformer`` maps its state_dict to the JAX package's
parameter tree (numpy leaves, Flax names and ``kernel [in, out]`` layout),
which ``utils/weights.item_qformer_state_dict_from_flax`` turns into the
port's state_dict: the same two steps the JAX package takes, so both packages
read one checkpoint to the same weights.  Unpickling the ``BertConfig`` needs
``transformers``.  ``convert_mwne`` does the same for a number encoder
(``utils/weights.mwne_state_dict_from_flax`` is its bridge), and
``convert_qwen3`` for a Hugging Face Qwen3 checkpoint
(``utils/weights.qwen3_state_dict_from_flax``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from unirec_tpu_torch.configs import ItemQFormerConfig, MWNEConfig, QFormerConfig


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
