"""Item Q-Former training: masked reconstruction + triplet contrastive (port
of ``unirec_tpu/train/item_qformer.py``).

* triplets = (anchor, positive = next in a user's history, random negative)
  (reference training/item_qformer_training.py:23-39); ``build_triplet_pairs``
  and ``sample_negatives`` are the JAX functions' numpy code, so one seed
  draws the same negatives;
* the anchor forward carries gradients and hidden dropout
  (``ops/dropout.DropoutStream`` from the seed and the step); the positive
  and negative forwards run without gradients and without dropout;
* loss = 1.0 * masked reconstruction MSE + 0.25 * TripletMargin(0.5)
  (``ops/losses.item_qformer_loss``), then the optax AdamW chain of
  ``train/common.py``;
* validation: masked MSE per batch and the mean cosine over valid fields;
* the checkpoint with the best validation loss is a train-state directory
  (``utils/checkpoint.save_train_state``) carrying ``{config, field_names,
  val_recon_loss, grad_accum}``, which ``QFormerInference`` and the sweep CLI
  read; ``resume`` restores it.

On the card with ``dtype="bfloat16"`` the positive and negative
representations come from the fused inference engine
(``inference/fused_qformer``: B1-B3, or B4-B6 with ``fused_precision=
"int8"``) on the live weights, packed again every step; with
``ItemQFormerConfig.fused_training`` the anchor's attention blocks run through
B12s / B12c (``ops/fused_qformer_vjp``).  The trainer runs on one device;
meshes wait for ROADMAP.md A9.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from unirec_tpu_torch.configs import ItemQFormerConfig, TrainConfig
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.eval.reconstruction import (
    evaluate_reconstruction_quality,
    reconstruction_batch,
)
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.ops.dropout import DropoutStream
from unirec_tpu_torch.ops.losses import item_qformer_loss
from unirec_tpu_torch.train.common import (
    TrainState,
    drive_steps,
    epoch_batches,
    flush_grad_accum,
    make_optimizer,
)

_BATCH_KEYS = ("anchor_emb", "anchor_mask", "pos_emb", "pos_mask", "neg_emb",
               "neg_mask")


def build_triplet_pairs(
    item_sequences: Sequence[Sequence[str]], id_to_row: Dict[str, int]
) -> np.ndarray:
    """(anchor_row, positive_row) for consecutive items in user histories
    (reference: training/item_qformer_training.py:27-28)."""
    pairs = [
        (id_to_row[seq[i]], id_to_row[seq[i + 1]])
        for seq in item_sequences
        for i in range(len(seq) - 1)
        if seq[i] in id_to_row and seq[i + 1] in id_to_row
    ]
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def sample_negatives(
    rng: np.random.Generator, pairs: np.ndarray, num_items: int
) -> np.ndarray:
    """Random negative != anchor and != positive
    (reference: training/item_qformer_training.py:32-34)."""
    if num_items <= 2:
        # every item is the anchor or the positive of some pair: rejection
        # sampling would loop forever; take any different item
        return ((pairs[:, 0] + 1) % max(num_items, 1)).astype(np.int32)
    neg = rng.integers(0, num_items, size=len(pairs)).astype(np.int32)
    bad = (neg == pairs[:, 0]) | (neg == pairs[:, 1])
    while bad.any():
        neg[bad] = rng.integers(0, num_items, size=int(bad.sum()))
        bad = (neg == pairs[:, 0]) | (neg == pairs[:, 1])
    return neg


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32)).to(
        device, non_blocking=True) for k in _BATCH_KEYS}


@torch.no_grad()
def fused_reference_representation(model: ItemQFormer,
                                   config: ItemQFormerConfig,
                                   emb: torch.Tensor, mask: torch.Tensor,
                                   precision: str = "bf16",
                                   fused=None) -> torch.Tensor:
    """The no-gradient item representation through the fused inference
    engine on the model's live weights (``fused``: the packed weights, to
    share one packing between calls): ``mean(q) @ W_rep + b`` in the
    engine's bf16, returned as float32, as the JAX step computes it.  (The
    JAX step's ``int8_cross_tile`` is a TPU VMEM budget with no counterpart
    on the card.)"""
    from unirec_tpu_torch.inference.fused_qformer import (
        fused_qformer_forward,
        prepare_fused_params,
    )

    if fused is None:
        fused = prepare_fused_params(model, config, dtype=torch.bfloat16,
                                     precision=precision)
    q = fused_qformer_forward(fused, config, emb, mask)
    head = model.item_representation_head
    rep = torch.nn.functional.linear(q.mean(dim=1), head.weight.to(q.dtype),
                                     head.bias.to(q.dtype))
    return rep.float()


def make_train_step(
    model: ItemQFormer,
    reconstruction_weight: float = 1.0,
    contrastive_weight: float = 0.25,
    margin: float = 0.5,
    fused_reference_config: Optional[ItemQFormerConfig] = None,
    fused_precision: str = "bf16",
    return_grads: bool = False,
    seed: int = 0,
):
    """The ``(state, batch) -> (state, metrics)`` step.

    ``fused_reference_config``: when set, the positive and negative forwards
    run through the fused inference engine (``fused_precision`` "bf16" or
    "int8"), on the live weights packed again at every step.  Metrics stay on
    the device; ``return_grads`` adds every parameter's gradient by name
    (parity-test instrumentation)."""
    params = dict(model.named_parameters())

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        device = next(model.parameters()).device
        b = batch_to_device(batch, device)
        for p in params.values():
            p.grad = None
        model.train()
        anc = model(b["anchor_emb"], b["anchor_mask"],
                    dropout=DropoutStream(seed, state.step))
        with torch.no_grad():  # reference: item_qformer_training.py:123-125
            if fused_reference_config is not None:
                from unirec_tpu_torch.inference.fused_qformer import (
                    prepare_fused_params,
                )

                fused = prepare_fused_params(model, fused_reference_config,
                                             dtype=torch.bfloat16,
                                             precision=fused_precision)
                pos, neg = (fused_reference_representation(
                    model, fused_reference_config, b[f"{x}_emb"],
                    b[f"{x}_mask"], fused=fused) for x in ("pos", "neg"))
            else:
                pos, neg = (model(b[f"{x}_emb"], b[f"{x}_mask"])
                            ["item_representation"] for x in ("pos", "neg"))
        total, recon, cont = item_qformer_loss(
            anc, b["anchor_emb"], b["anchor_mask"], pos, neg,
            reconstruction_weight, contrastive_weight, margin)
        total.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        state.optimizer.step(grads)
        state.step += 1
        metrics = {"loss": total.detach(), "recon": recon.detach(),
                   "contrastive": cont.detach()}
        if return_grads:
            metrics["grads"] = {n: g.detach().clone() for n, g in grads.items()}
        return state, metrics

    return step


def make_eval_step(model: ItemQFormer):
    """The ``(emb, mask) -> (masked MSE, sum of per-field cosines over valid
    fields, number of valid fields)`` step of one batch, the JAX eval step's
    three numbers (``eval/reconstruction.reconstruction_batch``)."""
    return functools.partial(reconstruction_batch, model)


@dataclasses.dataclass
class ItemQFormerTrainer:
    """End-to-end trainer over a FieldEmbeddingCache, on one device."""

    model_config: ItemQFormerConfig
    train_config: TrainConfig
    reconstruction_weight: float = 1.0
    contrastive_weight: float = 0.25
    # "float32" (strict reference parity) or "bfloat16" (bf16 activations,
    # float32 parameters and optimizer)
    dtype: str = "float32"
    # None: the fused pos/neg forwards on the card under bfloat16
    fused_reference_forwards: Optional[bool] = None
    fused_precision: str = "bf16"  # or "int8": B4-B6 for pos/neg
    device: Optional[str] = None  # None: the CUDA card

    def __post_init__(self):
        from unirec_tpu_torch.inference.fused_qformer import supports_fused
        from unirec_tpu_torch.utils.device import resolve_device

        mesh = self.train_config.mesh
        if mesh.dp > 1 or mesh.tp > 1 or mesh.sp > 1:
            raise NotImplementedError(
                "meshes (dp > 1, tp > 1, sp > 1) are not ported (A9): the "
                "trainer runs on one device")
        if self.fused_precision not in ("bf16", "int8"):
            raise ValueError(f"fused_precision must be bf16 or int8, got "
                             f"{self.fused_precision!r}")
        self.device = resolve_device(self.device)
        self.compute_dtype = (torch.bfloat16 if self.dtype == "bfloat16"
                              else torch.float32)
        use_fused = self.fused_reference_forwards
        if use_fused is None:
            use_fused = (self.device.type == "cuda"
                         and self.dtype == "bfloat16")
        self.use_fused = bool(use_fused) and supports_fused(self.model_config)
        self._train_step = None

    def init_state(self, seed: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """A fresh state: the Flax initialisers' distributions drawn from
        ``seed`` (``utils/weights.init_item_qformer``), or the ``params``
        state_dict; float32 masters, the optimizer's moments at zero."""
        from unirec_tpu_torch.utils.weights import init_item_qformer

        seed = self.train_config.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model = init_item_qformer(self.model_config, gen, device=self.device,
                                  dtype=self.compute_dtype,
                                  param_dtype=torch.float32)
        if params is not None:
            model.load_state_dict(params)
        model.train()
        optimizer = make_optimizer(dict(model.named_parameters()),
                                   self.train_config.optimizer)
        self._train_step = make_train_step(
            model, self.reconstruction_weight, self.contrastive_weight,
            fused_reference_config=self.model_config if self.use_fused
            else None,
            fused_precision=self.fused_precision, seed=self.train_config.seed)
        return TrainState(model, optimizer, 0)

    @staticmethod
    def gather_batch(cache: FieldEmbeddingCache, pairs: np.ndarray,
                     neg: np.ndarray) -> Dict[str, np.ndarray]:
        a, p = pairs[:, 0], pairs[:, 1]
        return {
            "anchor_emb": cache.embeddings[a], "anchor_mask": cache.masks[a],
            "pos_emb": cache.embeddings[p], "pos_mask": cache.masks[p],
            "neg_emb": cache.embeddings[neg], "neg_mask": cache.masks[neg],
        }

    def train_epoch(self, state: TrainState, cache: FieldEmbeddingCache,
                    pairs: np.ndarray, rng: np.random.Generator,
                    batch_size: Optional[int] = None
                    ) -> Tuple[TrainState, Dict[str, float]]:
        batch_size = batch_size or self.train_config.batch_size

        def stream():
            for idx in epoch_batches(rng, len(pairs), batch_size):
                bp = pairs[idx]
                neg = sample_negatives(rng, bp, len(cache))
                yield self.gather_batch(cache, bp, neg)

        state, mean, _ = drive_steps(self._train_step, state, stream())
        return state, mean

    def evaluate(self, state: TrainState, cache: FieldEmbeddingCache,
                 rows: Optional[np.ndarray] = None,
                 batch_size: int = 512) -> Dict[str, float]:
        """Masked MSE averaged over batches and the mean cosine over valid
        fields (``eval/reconstruction``).  (The JAX trainer pads the tail
        batch with zero-mask rows to keep one compiled shape; those rows add
        nothing to either sum.)"""
        res = evaluate_reconstruction_quality(state.model, cache, rows,
                                              batch_size)
        return {k: res[k] for k in ("val_recon_loss",
                                    "avg_cosine_similarity")}


def train_item_qformer(
    cache: FieldEmbeddingCache,
    item_sequences: Sequence[Sequence[str]],
    model_config: Optional[ItemQFormerConfig] = None,
    train_config: Optional[TrainConfig] = None,
    val_rows: Optional[np.ndarray] = None,
    checkpoint_dir: Optional[str] = None,
    contrastive_weight: float = 0.25,
    dtype: str = "float32",
    fused_precision: str = "bf16",
    resume: bool = False,
    metrics_logger=None,
    log_fn=print,
    device: Optional[str] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    """The training loop (reference: train_qformer,
    item_qformer_training.py:70-187).  ``resume=True`` restores parameters,
    optimizer state and step from ``checkpoint_dir`` (the epoch counter
    restarts; the optimizer step and the best-validation watermark
    continue)."""
    from unirec_tpu_torch.utils.checkpoint import (
        resume_train_state,
        save_train_state,
    )

    model_config = model_config or ItemQFormerConfig(
        num_fields=cache.num_fields, field_embedding_dim=cache.embedding_dim)
    train_config = train_config or TrainConfig()
    trainer = ItemQFormerTrainer(
        model_config, train_config, contrastive_weight=contrastive_weight,
        dtype=dtype, fused_precision=fused_precision, device=device)
    state = trainer.init_state()
    pairs = build_triplet_pairs(item_sequences, cache.id_to_row)
    rng = np.random.default_rng(train_config.seed)
    grad_accum = train_config.optimizer.gradient_accumulation_steps

    best_val = float("inf")
    if resume:
        state, meta = resume_train_state(checkpoint_dir, state, log_fn,
                                         expect_grad_accum=grad_accum)
        best_val = float(meta.get("val_recon_loss", float("inf")))
    last_metrics: Dict[str, float] = {}
    for epoch in range(train_config.num_epochs):
        state, train_metrics = trainer.train_epoch(state, cache, pairs, rng)
        log_fn(f"epoch {epoch + 1}: {train_metrics}")
        if metrics_logger:
            metrics_logger.log(dict(train_metrics), step=state.step)
        if (epoch + 1) % train_config.eval_every_epochs == 0:
            val = trainer.evaluate(state, cache, val_rows)
            log_fn(f"epoch {epoch + 1} val: {val}")
            if metrics_logger:
                metrics_logger.log(dict(val), step=state.step)
            last_metrics = {**train_metrics, **val}
            if val["val_recon_loss"] < best_val and checkpoint_dir:
                best_val = val["val_recon_loss"]
                save_train_state(
                    checkpoint_dir, state, config=model_config,
                    extra={"field_names": list(cache.fields),
                           "val_recon_loss": best_val,
                           "grad_accum": grad_accum})
        else:
            last_metrics = train_metrics
    state = flush_grad_accum(state)
    return state, last_metrics
