"""Joint training: Qwen3 + LoRA + Item Q-Former with the InfoNCE ranking loss
(port of ``unirec_tpu/train/joint.py``).

* ``JointDataset`` is the JAX class's numpy code, so its batches are the same
  arrays the JAX trainer gets;
* one step: Q-Former forward -> token injection -> Qwen3 forward -> pooling
  -> InfoNCE -> backward through LoRA, the extra token embeddings and the
  whole Q-Former (the frozen base has ``requires_grad=False``, the JAX
  ``stop_gradient``: no weight gradient is computed for it) -> the optax
  AdamW chain of ``train/common.py``;
* evaluation: MRR and Recall/NDCG@{1,5,10} over the padded 100-candidate
  pool.

The trainer runs on one device.  Parameters are float32 masters; with
``dtype="bfloat16"`` the model computes in bfloat16 and ``bf16_base`` stores
the frozen base in bfloat16.  On the card the training forward's attention
is K1 and its backward B7b (``flash_vjp_attention``), ``int8_base`` runs the
frozen projections through B8 (``int8_linear_ste``) and ``int8_fused`` the
q|k|v and gate|up groups through the wide STE linear.  Meshes (``dp > 1``,
``tp > 1``) and the pipelined trainer wait for ROADMAP.md A9.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from unirec_tpu_torch.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    OptimizerConfig,
    Qwen3Config,
    TrainConfig,
)
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import BaseTokenizer
from unirec_tpu_torch.models.joint import (
    MultiModalQwenEmbedding,
    construct_input_text,
)
from unirec_tpu_torch.models.qwen3 import quantize_qwen3_weights, set_qweights
from unirec_tpu_torch.ops.dropout import DropoutStream
from unirec_tpu_torch.ops.losses import info_nce_loss
from unirec_tpu_torch.ops.ranking import rank_of_positive
from unirec_tpu_torch.train.common import (
    OptaxAdamW,
    TrainState,
    drive_steps,
    epoch_batches,
    make_optimizer,
    pad_to_batch,
)
from unirec_tpu_torch.utils.params import (
    apply_trainable_mask,
    cast_frozen_to_bf16,
    is_trainable,
)

_BATCH_KEYS = ("input_ids", "attention_mask", "history_field_embeddings",
               "history_attention_mask", "positive_item_embeddings",
               "negative_item_embeddings", "negative_masks")


class JointDataset:
    """Assembles fixed-shape joint batches from rec samples (the JAX class,
    numpy only).

    ``data``: list of {history, candidate, ground_truth} samples.
    """

    def __init__(
        self,
        data: Sequence[Dict],
        item_emb_dict: Dict[str, Sequence[float]],
        tokenizer: BaseTokenizer,
        item_dict: Dict[str, Dict],
        field_cache: FieldEmbeddingCache,
        joint_config: JointModelConfig = JointModelConfig(),
        max_negatives: int = 10,
        item_emb_dim: int = 1024,
    ):
        self.data = list(data)
        self._item_emb_dict = item_emb_dict
        self.tokenizer = tokenizer
        self.item_dict = item_dict
        self.cache = field_cache
        self.jc = joint_config
        self.max_negatives = max_negatives
        self._item_emb_dim = item_emb_dim
        self._build_index_tables()

    def __len__(self) -> int:
        return len(self.data)

    @property
    def item_emb_dict(self):
        return self._item_emb_dict

    @item_emb_dict.setter
    def item_emb_dict(self, value):
        self._item_emb_dict = value
        self._tables_dirty = True

    @property
    def item_emb_dim(self) -> int:
        return self._item_emb_dim

    @item_emb_dim.setter
    def item_emb_dim(self, value: int):
        self._item_emb_dim = int(value)
        self._tables_dirty = True

    def _build_index_tables(self) -> None:
        """Per-sample gather indices, so ``batch`` is numpy fancy-indexing:
        history rows into the field cache (-1 missing), candidate embeddings
        with row 0 = zeros (unknown ids), negatives padded to the
        dataset-wide maximum; tokenization is memoized per sample."""
        n = len(self.data)
        jc = self.jc
        h = jc.num_history_items

        self._hist_rows = np.full((n, h), -1, np.int32)
        for i, sample in enumerate(self.data):
            hist = [str(x) for x in sample["history"]][:h]
            if hist:
                self._hist_rows[i, : len(hist)] = self.cache.rows_for(hist)

        ids = list(self.item_emb_dict)
        self._emb_matrix = np.zeros((len(ids) + 1, self.item_emb_dim), np.float32)
        emb_row = {}
        for j, key in enumerate(ids):
            self._emb_matrix[j + 1] = np.asarray(self.item_emb_dict[key],
                                                 np.float32)
            emb_row[str(key)] = j + 1

        cmax = max((len(s["candidate"]) - 1 for s in self.data), default=0)
        cmax = max(cmax, 1)
        self._pos_rows = np.zeros(n, np.int32)
        self._neg_rows = np.zeros((n, cmax), np.int32)
        self._neg_valid = np.zeros((n, cmax), np.float32)
        for i, sample in enumerate(self.data):
            candidates = sample["candidate"]
            gt_idx = candidates.index(sample["ground_truth"])
            self._pos_rows[i] = emb_row.get(str(candidates[gt_idx]), 0)
            neg_ids = [c for j, c in enumerate(candidates) if j != gt_idx]
            for j, c in enumerate(neg_ids):
                self._neg_rows[i, j] = emb_row.get(str(c), 0)
            self._neg_valid[i, : len(neg_ids)] = 1.0

        if not hasattr(self, "_tok_ids") or len(self._tok_done) != n:
            self._tok_ids = np.zeros((n, jc.max_length), np.int32)
            self._tok_mask = np.zeros((n, jc.max_length), np.float32)
            self._tok_done = np.zeros(n, bool)
        self._tables_dirty = False

    def _tokenize_rows(self, idx: np.ndarray) -> None:
        todo = idx[~self._tok_done[idx]]
        jc = self.jc
        for si in todo:
            sample = self.data[si]
            history = [str(x) for x in sample["history"]][: jc.num_history_items]
            text = construct_input_text(history, self.item_dict,
                                        jc.num_history_items,
                                        jc.num_query_tokens_per_item)
            ids, mask = self.tokenizer.encode(text, jc.max_length)
            self._tok_ids[si], self._tok_mask[si] = ids, mask
            self._tok_done[si] = True

    def batch(self, indices: Sequence[int], max_negatives: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
        if self._tables_dirty:
            self._build_index_tables()
        max_neg = max_negatives or self.max_negatives
        idx = np.asarray(indices, np.int64)
        n = len(idx)

        self._tokenize_rows(idx)

        rows = self._hist_rows[idx]  # [B, H]
        valid = rows >= 0
        clipped = np.clip(rows, 0, None)
        hist_emb = np.where(valid[..., None, None], self.cache.embeddings[clipped],
                            0.0).astype(np.float32)
        hist_mask = np.where(valid[..., None], self.cache.masks[clipped],
                             0.0).astype(np.float32)

        k = min(max_neg, self._neg_rows.shape[1])
        negs = np.zeros((n, max_neg, self.item_emb_dim), np.float32)
        neg_mask = np.zeros((n, max_neg), np.float32)
        negs[:, :k] = self._emb_matrix[self._neg_rows[idx, :k]]
        neg_mask[:, :k] = self._neg_valid[idx, :k]

        return {
            "input_ids": self._tok_ids[idx],
            "attention_mask": self._tok_mask[idx],
            "history_field_embeddings": hist_emb,
            "history_attention_mask": hist_mask,
            "positive_item_embeddings": self._emb_matrix[self._pos_rows[idx]],
            "negative_item_embeddings": negs,
            "negative_masks": neg_mask,
        }


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (ids as int64)."""
    out = {}
    for key in _BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[key]))
        if key == "input_ids":
            t = t.long()
        out[key] = t.to(device, non_blocking=True)
    return out


def joint_loss(model: MultiModalQwenEmbedding, batch: Mapping[str, torch.Tensor],
               drop: Optional[DropoutStream], temperature: float = 0.07
               ) -> torch.Tensor:
    """The training forward and InfoNCE on a device batch."""
    user = model(batch["input_ids"], batch["attention_mask"],
                 batch["history_field_embeddings"],
                 batch["history_attention_mask"], dropout=drop)
    return info_nce_loss(user, batch["positive_item_embeddings"],
                         batch["negative_item_embeddings"],
                         batch["negative_masks"], temperature)


def make_joint_train_step(model: MultiModalQwenEmbedding,
                          temperature: float = 0.07,
                          return_grads: bool = False, seed: int = 1):
    """The ``(state, batch) -> (state, metrics)`` step.

    Dropout draws from ``DropoutStream(seed, state.step)`` (the JAX step's
    ``fold_in(key(seed), step)``), one generator per site, so a remat
    recompute draws the same masks.  ``metrics["loss"]`` stays on the device
    (no host synchronisation); ``return_grads`` adds the trainable
    parameters' gradients by name (parity-test instrumentation)."""
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        device = next(model.parameters()).device
        model.train()
        for p in trainable.values():
            p.grad = None
        loss = joint_loss(model, batch_to_device(batch, device),
                          DropoutStream(seed, state.step), temperature)
        loss.backward()
        # the Item Q-Former's heads feed no joint output: zero gradient, as
        # in the JAX tree (AdamW's weight decay still reaches them)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in trainable.items()}
        state.optimizer.step(grads)
        state.step += 1
        metrics = {"loss": loss.detach()}
        if return_grads:
            metrics["grads"] = {n: g.detach().clone() for n, g in grads.items()}
        return state, metrics

    return step


def make_joint_optimizer(model: torch.nn.Module,
                         opt_cfg: OptimizerConfig) -> OptaxAdamW:
    """AdamW on LoRA + the extra token embeddings + the Q-Former; the base
    Qwen3 is frozen (PEFT's behaviour)."""
    return make_optimizer({n: p for n, p in model.named_parameters()
                           if is_trainable(n)}, opt_cfg)


@dataclasses.dataclass
class JointTrainer:
    qwen_config: Qwen3Config
    qformer_config: ItemQFormerConfig
    joint_config: JointModelConfig = JointModelConfig()
    lora: LoRAConfig = LoRAConfig()
    train_config: TrainConfig = TrainConfig(batch_size=16)
    dtype: str = "float32"
    remat: bool = False
    remat_policy: Optional[str] = None  # "dots": keep the GEMM outputs
    # store the frozen Qwen3 base in bf16 (utils/params.cast_frozen_to_bf16):
    # free under dtype="bfloat16", where weights are cast at use anyway
    bf16_base: bool = False
    # QLoRA-style training: the frozen projections run W8A8 (B8) in the
    # training forward with a straight-through backward; evaluation forwards
    # stay full precision, as in the JAX trainer
    int8_base: bool = False
    # q|k|v and gate|up of the frozen base as one wide int8 linear each
    int8_fused: Optional[bool] = None
    device: Optional[str] = None  # None: the CUDA card

    def __post_init__(self):
        from unirec_tpu_torch.utils.device import resolve_device

        mesh = self.train_config.mesh
        if mesh.dp > 1 or mesh.tp > 1 or mesh.sp > 1:
            raise NotImplementedError(
                "meshes (dp > 1, tp > 1, sp > 1) are not ported (A9): the "
                "trainer runs on one device")
        if self.int8_fused is None:
            self.int8_fused = False
        if self.int8_fused and not self.int8_base:
            raise ValueError("int8_fused requires int8_base (it is a "
                             "dispatch choice within the W8A8 training path)")
        if self.int8_fused:
            self.qwen_config = dataclasses.replace(self.qwen_config,
                                                   fused_int8_training=True)
        if self.bf16_base and self.dtype != "bfloat16":
            raise ValueError(
                "bf16_base requires dtype='bfloat16' (fp32 compute exists "
                "for strict parity; a bf16 frozen base would break it)")
        if self.remat_policy not in (None, "dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        self.device = resolve_device(self.device)
        self.compute_dtype = (torch.bfloat16 if self.dtype == "bfloat16"
                              else torch.float32)
        self.qweights = None  # built in init_state when int8_base
        self._train_step = None

    def init_state(self, qformer_params: Optional[Mapping] = None,
                   qwen_params: Optional[Mapping] = None,
                   seed: Optional[int] = None,
                   params: Optional[Mapping] = None) -> TrainState:
        """A fresh state: the Flax initialisers' distributions drawn from
        ``seed`` (``utils/weights.init_joint``), then ``qformer_params`` (an
        ``ItemQFormer`` state_dict) and ``qwen_params`` (a ``Qwen3Model``
        state_dict) merged over them, or a whole joint ``params``
        state_dict."""
        from unirec_tpu_torch.utils.weights import init_joint

        seed = self.train_config.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model = init_joint(self.qwen_config, self.qformer_config,
                           self.joint_config, self.lora, gen,
                           device=self.device, dtype=self.compute_dtype,
                           param_dtype=torch.float32, remat=self.remat,
                           remat_policy=self.remat_policy)
        for module, loaded in ((model.qformer, qformer_params),
                               (model.base_model, qwen_params)):
            if loaded is not None:  # the JAX merge_params: extra keys raise
                unexpected = module.load_state_dict(
                    loaded, strict=False).unexpected_keys
                if unexpected:
                    raise KeyError(f"loaded params {unexpected[:3]} not in "
                                   "model structure")
        if params is not None:
            model.load_state_dict(params)
        if self.bf16_base:
            cast_frozen_to_bf16(model)
        apply_trainable_mask(model)
        if self.int8_base:
            self.qweights = quantize_qwen3_weights(model.base_model)
            set_qweights(model.base_model, self.qweights)
        model.train()
        optimizer = make_joint_optimizer(model, self.train_config.optimizer)
        self._train_step = make_joint_train_step(model,
                                                 seed=self.train_config.seed)
        return TrainState(model, optimizer, 0)

    def _batch_stream(self, dataset: JointDataset, rng: np.random.Generator,
                      batch_size: int, num_steps: Optional[int] = None):
        produced = 0
        while num_steps is None or produced < num_steps:
            for idx in epoch_batches(rng, len(dataset), batch_size):
                yield dataset.batch(idx)
                produced += 1
                if num_steps is not None and produced >= num_steps:
                    return
            if num_steps is None:
                return

    def train_epoch(self, state: TrainState, dataset: JointDataset,
                    rng: np.random.Generator,
                    batch_size: Optional[int] = None
                    ) -> Tuple[TrainState, Dict[str, float]]:
        batch_size = batch_size or self.train_config.batch_size
        state, mean, _ = drive_steps(
            self._train_step, state,
            self._batch_stream(dataset, rng, batch_size))
        return state, mean

    def train_steps(self, state: TrainState, dataset: JointDataset,
                    rng: np.random.Generator, num_steps: int,
                    batch_size: Optional[int] = None, step_hook=None
                    ) -> Tuple[TrainState, Dict[str, float]]:
        """Step-driven training; ``step_hook(global_step, state, metrics)``
        after every step (it reads the loss: one synchronisation a step)."""
        batch_size = batch_size or self.train_config.batch_size
        hook = None
        if step_hook is not None:
            hook = lambda i, st, m: step_hook(st.step, st, m)  # noqa: E731
        state, _, last = drive_steps(
            self._train_step, state,
            self._batch_stream(dataset, rng, batch_size, num_steps),
            step_hook=hook)
        return state, last

    @contextlib.contextmanager
    def evaluating(self, state: TrainState):
        """The deterministic model without gradients and at full precision
        (no int8 base), as the JAX evaluation runs it; training mode and the
        int8 weights come back afterwards."""
        model = state.model
        model.eval()
        if self.qweights is not None:
            set_qweights(model.base_model, None)
        try:
            with torch.no_grad():
                yield model
        finally:
            if self.qweights is not None:
                set_qweights(model.base_model, self.qweights)
            model.train()

    def evaluate(self, state: TrainState, dataset: JointDataset,
                 batch_size: int = 32, max_negatives: int = 99,
                 ks: Tuple[int, ...] = (1, 5, 10)) -> Dict[str, float]:
        """MRR + Recall@K + NDCG@K over the full candidate pool; the tail
        batch is padded to ``batch_size`` and its padded rows dropped."""
        ranks: List[np.ndarray] = []
        with self.evaluating(state) as model:
            for i in range(0, len(dataset), batch_size):
                idx = list(range(i, min(i + batch_size, len(dataset))))
                batch, n = pad_to_batch(
                    dataset.batch(idx, max_negatives=max_negatives), batch_size)
                b = batch_to_device(batch, self.device)
                user = model(b["input_ids"], b["attention_mask"],
                             b["history_field_embeddings"],
                             b["history_attention_mask"])
                r = rank_of_positive(user, b["positive_item_embeddings"],
                                     b["negative_item_embeddings"],
                                     b["negative_masks"])
                ranks.append(r.cpu().numpy()[:n])
        all_ranks = np.concatenate(ranks).astype(np.float64)
        out: Dict[str, float] = {"mrr": float(np.mean(1.0 / all_ranks))}
        for k in ks:
            hit = all_ranks <= k
            out[f"recall@{k}"] = float(hit.mean())
            out[f"ndcg@{k}"] = float(
                np.where(hit, 1.0 / np.log2(all_ranks + 1.0), 0.0).mean())
        return out
