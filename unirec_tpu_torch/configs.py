"""Configuration tree (the port's copy of the dataclasses of
``unirec_tpu/configs.py`` that the port reads).

Pure-Python frozen dataclasses with the JAX package's field names and
defaults, so a config written to a checkpoint's ``meta.json`` by either
package restores in the other.  Port modules read configs by attribute only,
so the JAX package's config objects work with them too (the parity tests
build both models from one config).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _warn_prob_dropout_zeroed(cls_name: str, flags: str, rate: float) -> None:
    """Kernel training flags run deterministic attention probs; make the
    semantic change loud instead of silent (hidden-state dropout keeps the
    configured rate)."""
    warnings.warn(
        f"{cls_name}: {flags} zeroes attention-prob dropout (configured "
        f"{rate}) — the trainable kernels compute deterministic attention "
        "probs; hidden-state dropout stays at the configured rate. Set "
        "dropout=0.0 to silence, or drop the kernel flag for exact "
        "prob-dropout semantics on the XLA path.",
        UserWarning,
        stacklevel=3,
    )


# ---------------------------------------------------------------------------
# Field schema (reference: config/triplet_config.yaml)
# ---------------------------------------------------------------------------

#: Modality names -> modality id (reference: config/triplet_config.yaml:18-22)
MODALITY_IDS: Dict[str, int] = {"text": 0, "category": 1, "image": 2, "number": 3}

#: Default field schema: field name -> (field_id, modality_id, modality_type)
#: (reference: config/triplet_config.yaml:1-16)
DEFAULT_FIELD_MAPPING: Dict[str, Tuple[int, int, str]] = {
    "title": (0, 0, "text"),
    "description": (1, 0, "text"),
    "features": (2, 0, "text"),
    "main_category": (3, 1, "category"),
    "store": (4, 1, "category"),
    "brand": (5, 1, "category"),
    "style": (6, 1, "category"),
    "color": (7, 1, "category"),
    "size": (8, 1, "category"),
    "material": (9, 1, "category"),
    "main_image": (10, 2, "image"),
    "price": (11, 3, "number"),
    "average_rating": (12, 3, "number"),
    "rating_number": (13, 3, "number"),
}


@dataclass(frozen=True)
class FieldSchema:
    """Maps item fields to modalities (the YAML schema the reference reads at
    models/item_encoder_pure_value.py:35-42)."""

    mapping: Tuple[Tuple[str, Tuple[int, int, str]], ...] = tuple(
        sorted(DEFAULT_FIELD_MAPPING.items())
    )

    @staticmethod
    def from_yaml(path: str) -> "FieldSchema":
        import yaml  # only ``--config`` reaches this

        with open(path) as f:
            raw = yaml.safe_load(f)
        mapping = {
            name: (int(spec[0]), int(spec[1]), str(spec[2]))
            for name, spec in raw["FIELD_MAPPING"].items()
        }
        return FieldSchema(mapping=tuple(sorted(mapping.items())))

    def as_dict(self) -> Dict[str, Tuple[int, int, str]]:
        return dict(self.mapping)


# ---------------------------------------------------------------------------
# Q-Former (reference: models/qformer.py BertConfig usage,
# models/qformer_utils.py:23-28)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QFormerConfig:
    """BLIP-2-style Q-Former (BERT with query tokens + cross attention).

    Defaults match the reference item Q-Former construction at
    models/qformer_utils.py:17-28 (hidden 1024, 12 layers, 16 heads, FFN 4096,
    dropout 0.2, encoder width 1024, cross-attention every 2 layers).
    """

    hidden_size: int = 1024
    num_hidden_layers: int = 12
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_dropout_prob: float = 0.2
    attention_probs_dropout_prob: float = 0.2
    encoder_width: int = 1024
    add_cross_attention: bool = True
    cross_attention_freq: int = 2
    query_length: int = 32
    # Text-side vocabulary (BertConfig defaults; exercised by the LM heads)
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    pad_token_id: int = 0
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    hidden_act: str = "gelu"
    # Self-attention position scoring: "absolute" (the only mode UniRec's
    # pipelines use) or the BERT relative variants "relative_key" /
    # "relative_key_query" (reference: models/qformer.py:207-242).
    position_embedding_type: str = "absolute"
    gradient_checkpointing: bool = False
    # Inference-only bf16 softmax path (~20% faster on TPU for the tiny
    # per-item attention shapes); keep False for training / strict parity.
    fast_attention: bool = False
    # Trainable streaming cross-attention (ops/flash_vjp.py, B14): fwd AND
    # bwd stream over the memory axis, so long-history training memory is
    # O(Lq * tile) instead of O(Lq * Lkv).  Only takes effect when
    # attention-prob dropout is inactive (the kernel's probs are
    # deterministic); plain path otherwise.
    flash_training: bool = False
    # Trainable FUSED attention blocks (ops/fused_qformer_vjp.py): QKV
    # projections + packed per-item attention + output projection as one
    # kernel each way (the training counterpart of the inference engine).
    # Engages only for key-only masks (the item path), bf16 compute, and
    # inactive attention-prob dropout; hidden dropout stays in XLA and is
    # unaffected.  XLA path otherwise.
    fused_training: bool = False
    # Introspection: sow per-layer attention probabilities as flax
    # "intermediates" (functional equivalent of the reference's
    # save_attention hooks, models/qformer.py:147-159).  Forces the plain
    # XLA attention paths (fused/flash/fast kernels never materialize the
    # probs).  Use utils.debug.capture_attention_maps rather than setting
    # this directly.
    capture_attention_probs: bool = False

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_attention_heads == 0
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class ItemQFormerConfig:
    """Item Q-Former wrapper config (reference: models/qformer_utils.py:16-35).

    Unifies the duplicate wrappers qformer_utils.QFormerForItemRepresentation
    (K=32) and qformer_model.QFormerForItemRepresentation (K=8) with K as
    config (SURVEY.md §7.1.4).
    """

    hidden_size: int = 1024
    num_hidden_layers: int = 12
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_query_tokens: int = 32
    field_embedding_dim: int = 1024
    num_fields: int = 14
    dropout: float = 0.2
    # Optional field-id / modality-id conditioning: learned embeddings added
    # to each field's value embedding before the Q-Former.  Salvages the
    # design idea from the reference's dead triplet encoder
    # (models/item_encoder_triplet.py:160-183; SURVEY.md §7.1.2).
    use_field_type_embeddings: bool = False
    num_modalities: int = 4
    fast_attention: bool = False
    gradient_checkpointing: bool = False
    # Trainable fused attention blocks (see QFormerConfig.fused_training).
    # Zeroes attention-PROB dropout (the kernels recompute deterministic
    # probs in the backward) — hidden dropout keeps self.dropout; the same
    # tradeoff as the user stage's --flash (BASELINE.md round 3).
    fused_training: bool = False
    # see QFormerConfig.capture_attention_probs
    capture_attention_probs: bool = False

    def qformer(self) -> QFormerConfig:
        if self.fused_training and self.dropout > 0.0:
            _warn_prob_dropout_zeroed(
                "ItemQFormerConfig", "fused_training", self.dropout
            )
        return QFormerConfig(
            hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size,
            hidden_dropout_prob=self.dropout,
            attention_probs_dropout_prob=(
                0.0 if self.fused_training else self.dropout
            ),
            add_cross_attention=True,
            cross_attention_freq=2,
            encoder_width=self.field_embedding_dim,
            query_length=self.num_query_tokens,
            fast_attention=self.fast_attention,
            gradient_checkpointing=self.gradient_checkpointing,
            fused_training=self.fused_training,
            capture_attention_probs=self.capture_attention_probs,
        )


@dataclass(frozen=True)
class UserQFormerConfig:
    """User Q-Former config (reference: training/user_qformer_training.py:21-45).

    4 layers, 64 query tokens, cross-attention at every layer, and an MLP
    prediction head emitting the next item's flattened query tokens.
    """

    hidden_size: int = 1024
    num_hidden_layers: int = 4
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_query_tokens: int = 64
    input_embedding_dim: int = 1024
    num_item_tokens_to_predict: int = 32
    dropout: float = 0.1
    # layer-level remat (``torch.utils.checkpoint`` over the layers and the
    # sequence assembly): long histories hold [B, H, 64, seq * K] attention
    # probabilities per layer without it
    gradient_checkpointing: bool = False
    # trainable flash cross-attention (ops/flash_vjp.py, B14); zeroes
    # attention-PROB dropout (qformer() below), hidden dropout stays exact
    flash_training: bool = False
    # trainable fused SELF-attention blocks over the 64 query tokens (B12s;
    # the 1,600-row cross side fails supports_fused_train and takes the
    # flash or plain path), composes with flash_training
    fused_training: bool = False
    # sequence parallelism (`train user-qformer --sp N`): the memory axis
    # is split over the mesh's sp ranks and combined exactly
    # (ops/sharded_attention.py); attention probabilities never exist
    # whole, so their dropout is zeroed like the kernel flags'
    sequence_parallel: bool = False

    def qformer(self) -> QFormerConfig:
        # the trainable kernels engage only without attention-prob dropout:
        # zero it when a kernel flag is set so the flags are never silently
        # inert; hidden-state dropout keeps the configured rate
        kernel_train = (self.fused_training or self.flash_training
                        or self.sequence_parallel)
        if kernel_train and self.dropout > 0.0:
            _warn_prob_dropout_zeroed(
                "UserQFormerConfig",
                "flash_training/fused_training/sequence_parallel",
                self.dropout,
            )
        return QFormerConfig(
            hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size,
            hidden_dropout_prob=self.dropout,
            attention_probs_dropout_prob=0.0 if kernel_train else self.dropout,
            add_cross_attention=True,
            cross_attention_freq=1,
            encoder_width=self.input_embedding_dim,
            query_length=self.num_query_tokens,
            gradient_checkpointing=self.gradient_checkpointing,
            flash_training=self.flash_training,
            fused_training=self.fused_training,
        )


# ---------------------------------------------------------------------------
# MWNE number encoder (reference: models/mwne.py:91-183)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MWNEConfig:
    """Math-aware number encoder (reference: models/mwne.py:91-183)."""

    embedding_dim: int = 1024
    num_frequencies: int = 20
    max_frequency: float = 100.0
    include_raw: bool = True
    # Normalizer (reference: models/mwne.py:9-64)
    target_std: float = 1.0
    momentum: float = 0.99
    min_std: float = 0.1

    @property
    def fourier_dim(self) -> int:
        return 2 * self.num_frequencies

    @property
    def raw_dim(self) -> int:
        return 2 if self.include_raw else 0

    @property
    def extra_dim(self) -> int:
        d = self.embedding_dim - self.fourier_dim - self.raw_dim
        if d < 0:
            raise ValueError(
                f"embedding_dim {self.embedding_dim} too small for "
                f"{self.fourier_dim} fourier + {self.raw_dim} raw dims"
            )
        return d


# ---------------------------------------------------------------------------
# Qwen3 decoder + LoRA (reference: training/train_item_individual_token_joint.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Qwen3Config:
    """Qwen3 dense decoder config.

    Defaults are the Qwen3-Embedding-0.6B backbone used by the joint model
    (reference: train_item_individual_token_joint.py:97-103).
    """

    vocab_size: int = 151669
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    # Pallas flash attention for the decoder self-attention. None = auto
    # (on for TPU when seq % 128 == 0 and head_dim % 128 == 0); False forces
    # the XLA additive-mask path (exact parity reference).
    flash_attention: Optional[bool] = None
    # TRAINABLE flash causal self-attention (ops/flash_causal_vjp.py):
    # custom-VJP streaming kernel for non-deterministic (training) forwards
    # — the [B, H, L, L] attention probs never reach HBM, freeing ~1.9 GB
    # at batch 8 / seq 512 over 28 layers in the no-remat joint config.
    # Opt-in: the backward recomputes score blocks (flash-2 style), which
    # trades FLOPs for memory — measure per config (BASELINE.md).
    flash_vjp_attention: bool = False
    # Fused int8 serving blocks (ops/fused_qwen3_int8.py): ONE quantize
    # pass feeds the concatenated qkv matmul, and the MLP's gate/up/silu/
    # down chain keeps its [rows, I] intermediates in VMEM.  Engages only
    # for deterministic forwards with the qweights collection present and
    # LoRA merged/absent (Recommender(precision="int8", merge_lora=True)
    # sets this).  XLA per-projection int8 dots otherwise.
    fused_int8_inference: bool = False
    # Fused int8 TRAINING projections (`--int8-base` joint training): the
    # frozen base's q|k|v and gate|up projections run as ONE wide int8
    # matmul each (ops/fused_qwen3_int8.int8_linear_fused_ste) with an STE
    # backward; LoRA overlays stay XLA/exact on top.  Engages only when the
    # qweights collection is present and rows tile evenly; o/down stay on
    # the per-projection STE path.  MEASURED SLOWER than the per-projection
    # default at the joint shape (BASELINE.md round 9: XLA CSE already
    # shares the quant pass) — kept as an opt-in A/B probe, not a default.
    fused_int8_training: bool = False

    @property
    def q_size(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_key_value_heads * self.head_dim


def tiny_qwen3_config(**overrides: Any) -> Qwen3Config:
    """A small Qwen3 config for tests / CI (same architecture, tiny dims)."""
    base = dict(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
    )
    base.update(overrides)
    return Qwen3Config(**base)


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapter config (reference: train_item_individual_token_joint.py:721-731)."""

    r: int = 16
    alpha: float = 32.0
    dropout: float = 0.1
    # Grouped overlay (opt-in, `train joint --lora-grouped`): projections
    # sharing an input (q/k/v; gate/up) draw ONE dropout mask and run ONE
    # concatenated lora_a matmul [D, 3r] instead of three [D, r] — the
    # input tensor is read once per group instead of once per projection
    # on BOTH the forward and the dW_a backward.  The joint-step
    # dissection (BASELINE.md round 9) measured the per-projection
    # overlay at 23.3 ms/step (20% of the flagship step) with the cost in
    # per-projection HBM traffic, not FLOPs.  Changes training numerics
    # (dropout masks become correlated within a group — same
    # "equally-valid bits" class as the rbg RNG switch, but structural),
    # so it is OFF by default; param layout/checkpoints are unchanged.
    grouped: bool = False
    target_modules: Tuple[str, ...] = (
        "q_proj",
        "k_proj",
        "v_proj",
        "o_proj",
        "gate_proj",
        "up_proj",
        "down_proj",
    )

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


@dataclass(frozen=True)
class JointModelConfig:
    """Joint multimodal Qwen3 embedding model
    (reference: train_item_individual_token_joint.py:88-181)."""

    num_history_items: int = 10
    num_query_tokens_per_item: int = 2
    max_length: int = 512
    pool: str = "mean"  # reference pools mean over ALL positions (:180);
    # "masked_mean" and "last_token" (:37-44) are also supported.


# ---------------------------------------------------------------------------
# Training / parallelism
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. axis 'dp' = data parallel, 'tp' = tensor
    parallel, 'sp' = sequence parallel (the user stage's long-history
    memory axis — ops/sharded_attention.py)."""

    dp: int = -1  # -1: use all remaining devices
    tp: int = 1
    sp: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int, int]:
        tp, sp = max(1, self.tp), max(1, self.sp)
        dp = self.dp if self.dp > 0 else n_devices // (tp * sp)
        if dp * tp * sp != n_devices:
            raise ValueError(
                f"mesh dp={dp} x tp={tp} x sp={sp} != {n_devices} devices")
        return dp, tp, sp


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 0
    max_grad_norm: float = 0.0  # 0 = no clipping
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # apply the optimizer every k micro-batches on the averaged gradient
    # (= HF TrainingArguments.gradient_accumulation_steps, reference
    # training/train_item_individual_token_joint.py:758); warmup counts
    # optimizer applies, not micro-steps, matching the HF scheduler
    gradient_accumulation_steps: int = 1


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 4096
    num_epochs: int = 500
    seed: int = 42
    eval_every_epochs: int = 50
    log_every_steps: int = 10
    dtype: str = "bfloat16"  # computation dtype
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_dir: Optional[str] = None

