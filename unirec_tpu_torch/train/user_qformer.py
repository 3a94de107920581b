"""User Q-Former training: predict the next item's query tokens (port of
``unirec_tpu/train/user_qformer.py``; reference:
training/user_qformer_training.py).

* sliding-window samples from user histories (input = history[:i], target =
  history[i]; reference :96-112), timestamps proxied by each item's first
  review time (:87-94), coordinates placeholder [0, 0] (:126-133);
* the catalog's item query tokens come from ONE pass of the frozen Item
  Q-Former over the field-embedding cache (``precompute_item_tokens``), and
  batches gather rows of them;
* loss = MSE(predicted tokens, target item tokens) per sample, weighted by
  ``sample_weight`` (0 for a target missing from the cache) over
  ``max(sum w, 1)``; then the optax AdamW chain of ``train/common.py``;
* ``train_context`` False freezes the context encoders (no gradient, no
  weight decay: the optimizer holds the User Q-Former's parameters only),
  the reference's semantics;
* ``UserQFormerConfig.gradient_checkpointing`` recomputes the sequence
  assembly and each Q-Former layer in the backward (``torch.utils.
  checkpoint``); the dropout stream is per site (``ops/dropout``), so the
  recompute draws the same masks;
* a 90/10 held-out split, best-by-train-loss checkpoints (train-state
  directories, ``utils/checkpoint``), ``resume``, the pending gradient
  accumulation applied at the end, and ``eval/user_eval`` on the held-out
  samples.

On the card with ``flash_training`` every cross-attention layer runs B14
(``ops/flash_vjp``), with ``fused_training`` every self-attention layer
B12s; the evaluation forward runs B14's forward, or B13 without
``flash_training``.

``TrainConfig.mesh`` trains over a torch.distributed world of dp x sp
ranks (``parallel/mesh.py``; sp the fastest axis).  dp splits the batch:
each rank steps on its rows and the weighted loss divides by the global
weight sum (``ops/losses.global_mean_denominator``: ``max(W, 1) / S``).  sp
(``UserQFormerConfig.sequence_parallel``) splits the memory: each sp rank
assembles its rows' sequences, keeps its slice of the memory axis, projects
K/V from it and combines exactly over the sp group
(``ops/sharded_attention``); its loss is scaled by 1/sp and the gradients
are summed over sp and averaged over dp (``train/common.reduce_step``).  sp
runs the plain attention path: the JAX trainer refuses it with the flash
and fused kernels, and so does this one.  The evaluation runs on the whole
memory on every rank.  ``tp > 1`` replicates the parameters over tp (the
ranks of one dp and sp index compute the same step, as the JAX trainer's
GSPMD step does); the flash and fused kernels are refused with it, as in
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from unirec_tpu_torch.configs import (
    OptimizerConfig,
    TrainConfig,
    UserQFormerConfig,
)
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.models.user_qformer import UserStage
from unirec_tpu_torch.ops.dropout import DropoutStream
from unirec_tpu_torch.ops.losses import global_mean_denominator, mse_loss
from unirec_tpu_torch.ops.sharded_attention import split_memory
from unirec_tpu_torch.parallel.mesh import (
    DistMesh,
    dist_mesh,
    is_writer,
    replicate,
)
from unirec_tpu_torch.train.common import (
    TrainState,
    check_batch_size,
    drive_steps,
    epoch_batches,
    flush_grad_accum,
    local_rows,
    loss_scale,
    make_optimizer,
    reduce_step,
    step_dropout,
)

BATCH_KEYS = ("item_tokens", "timestamps", "coordinates", "seq_mask",
              "target_tokens", "sample_weight")


def build_sliding_window_samples(
    user_histories: Sequence[Dict],
    min_seq_len: int = 3,
    max_seq_len: int = 50,
) -> List[Tuple[List[str], str]]:
    """(input_history_ids, target_id) samples
    (reference: user_qformer_training.py:96-112)."""
    samples: List[Tuple[List[str], str]] = []
    for user in user_histories:
        history = user.get("history", [])
        if len(history) < min_seq_len:
            continue
        history = history[-max_seq_len:]
        for i in range(1, len(history) - 1):
            samples.append((list(history[:i]), history[i]))
    return samples


def build_timestamp_map(review_data: Dict[str, list]) -> Dict[str, int]:
    """item -> earliest review unix time (reference :87-94)."""
    ts = {}
    for item_id, reviews in review_data.items():
        if reviews:
            ts[item_id] = reviews[0].get("unixReviewTime", 0)
    return ts


@torch.no_grad()
def precompute_item_tokens(item_qformer: ItemQFormer,
                           cache: FieldEmbeddingCache,
                           batch_size: int = 1024) -> np.ndarray:
    """One pass: whole catalog -> [N, K, hidden] float32 query tokens of the
    frozen Item Q-Former, in the dtype it was built with."""
    device = next(item_qformer.parameters()).device
    item_qformer.eval()
    outs = []
    for i in range(0, len(cache), batch_size):
        emb = torch.from_numpy(np.ascontiguousarray(
            cache.embeddings[i: i + batch_size], np.float32)).to(device)
        mask = torch.from_numpy(np.ascontiguousarray(
            cache.masks[i: i + batch_size], np.float32)).to(device)
        outs.append(item_qformer.query_outputs(emb, mask).float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32)).to(
        device, non_blocking=True) for k in BATCH_KEYS if k in batch}


def user_forward(model: UserStage, b: Mapping[str, torch.Tensor],
                 drop: Optional[DropoutStream] = None,
                 mesh: Optional[DistMesh] = None) -> torch.Tensor:
    """Predicted tokens ``[B, K, D]`` of a device batch: the sequence
    assembly, then the User Q-Former (``drop``: a training forward's stream).
    With ``gradient_checkpointing`` a training forward that needs gradients
    recomputes the assembly in the backward (the layers recompute
    themselves).  With an sp ``mesh`` the User Q-Former takes this rank's
    slice of the memory (its cross blocks combine over the sp group)."""
    args = (b["item_tokens"], b["timestamps"], b["coordinates"], b["seq_mask"])
    if (model.config.gradient_checkpointing and model.training
            and torch.is_grad_enabled()):
        flat, flat_mask = checkpoint(model.sequence, *args, use_reentrant=False)
    else:
        flat, flat_mask = model.sequence(*args)
    if mesh is not None and mesh.sp_size > 1:
        flat, flat_mask = (split_memory(t, mesh.sp_size, mesh.sp_index)
                           for t in (flat, flat_mask))
    return model.user(flat, flat_mask, dropout=drop)


def user_loss(model: UserStage, b: Mapping[str, torch.Tensor],
              drop: Optional[DropoutStream] = None,
              mesh: Optional[DistMesh] = None) -> torch.Tensor:
    """MSE of the predicted tokens; with ``sample_weight`` the per-sample
    means weighted over ``max(sum w, 1)``, under a dp ``mesh`` over the
    global weight sum (``global_mean_denominator``)."""
    pred = user_forward(model, b, drop, mesh)
    w = b.get("sample_weight")
    if w is None:  # equal shards: the dp mean of the means is the mean
        return mse_loss(pred, b["target_tokens"])
    per = ((pred - b["target_tokens"]) ** 2).mean(dim=(1, 2))
    group = None if mesh is None or mesh.dp_size == 1 else mesh.dp_group
    return (per * w).sum() / global_mean_denominator(w.sum(), group)


def make_train_step(model: UserStage, return_grads: bool = False,
                    seed: int = 0, mesh: Optional[DistMesh] = None):
    """The ``(state, batch) -> (state, metrics)`` step over the parameters
    that need gradients.  Metrics stay on the device; ``return_grads`` adds
    every parameter's gradient by name (zeros for frozen ones: parity-test
    instrumentation).  Under a ``mesh`` the step takes this rank's rows and
    memory slice, scales its loss by 1/sp and reduces
    (``train/common.reduce_step``)."""
    params = dict(model.named_parameters())
    trainable = {n: p for n, p in params.items() if p.requires_grad}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        device = next(model.parameters()).device
        b = batch_to_device(local_rows(batch, mesh), device)
        for p in params.values():
            p.grad = None
        model.train()
        loss = user_loss(model, b, step_dropout(seed, state.step, mesh), mesh)
        scale = loss_scale(mesh)
        (loss * scale if scale != 1.0 else loss).backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in trainable.items()}
        grads, metrics = reduce_step(grads, {"loss": loss.detach()}, mesh)
        state.optimizer.step(grads)
        state.step += 1
        if return_grads:
            metrics["grads"] = {
                n: (grads[n].detach().clone() if n in grads
                    else torch.zeros_like(p)) for n, p in params.items()}
        return state, metrics

    return step



def check_user_layout(tp: int, sp: int, flash_training: bool,
                      fused_training: bool) -> None:
    """The JAX user trainer's refusals of tp > 1 and sp > 1 with the flash
    or fused kernels."""
    if tp > 1 and (flash_training or fused_training):
        raise ValueError(
            "flash_training/fused_training are incompatible with tp>1 (the "
            "kernels have no in-kernel collectives); use dp-only meshes")
    if sp > 1 and (flash_training or fused_training):
        raise ValueError(
            "sequence_parallel is incompatible with flash/fused training "
            "(the kernels are single-device; the sp combine is a "
            "collective path)")


@dataclasses.dataclass
class UserQFormerTrainer:
    """End-to-end trainer over precomputed catalog tokens, on one device."""

    user_config: UserQFormerConfig
    train_config: TrainConfig
    max_seq_len: int = 50
    # "float32" (strict parity) or "bfloat16" (bf16 activations, float32
    # parameters and optimizer)
    dtype: str = "float32"
    # True (default) trains the timestamp / geo context encoders with the
    # User Q-Former; False reproduces the reference, which encodes context
    # with frozen encoders (user_qformer_training.py:191-194)
    train_context: bool = True
    device: Optional[str] = None  # None: the CUDA card

    def __post_init__(self):
        from unirec_tpu_torch.utils.device import resolve_device

        mesh = self.train_config.mesh
        uc = self.user_config
        if uc.sequence_parallel != (max(mesh.sp, 1) > 1):
            raise ValueError(
                "sequence_parallel requires an 'sp' mesh axis > 1 "
                "(TrainConfig.mesh.sp / `train user-qformer --sp N`), and "
                "an sp axis > 1 requires sequence_parallel")
        check_user_layout(mesh.tp, mesh.sp, uc.flash_training,
                          uc.fused_training)
        self.mesh = dist_mesh(mesh)
        check_batch_size(self.train_config.batch_size, self.mesh)
        self.device = resolve_device(self.device)
        self.compute_dtype = (torch.bfloat16 if self.dtype == "bfloat16"
                              else torch.float32)
        self._train_step = None

    def init_state(self, seed: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """A fresh state: the Flax initialisers' distributions drawn from
        ``seed`` (``utils/weights.init_user_qformer``), or the ``params``
        state_dict; float32 masters, the optimizer's moments at zero, over
        the trainable parameters only."""
        from unirec_tpu_torch.utils.weights import init_user_qformer

        seed = self.train_config.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model = init_user_qformer(self.user_config, gen, device=self.device,
                                  dtype=self.compute_dtype,
                                  param_dtype=torch.float32)
        if params is not None:
            model.load_state_dict(params)
        replicate(model)  # rank 0's parameters on every rank
        if self.user_config.sequence_parallel:
            model.user.set_sequence_parallel(self.mesh.sp_group)
        model.sequence.requires_grad_(self.train_context)
        model.train()
        optimizer = make_optimizer(
            {n: p for n, p in model.named_parameters() if p.requires_grad},
            self.train_config.optimizer)
        self._train_step = make_train_step(model, seed=self.train_config.seed,
                                           mesh=self.mesh)
        return TrainState(model, optimizer, 0)

    @contextlib.contextmanager
    def whole_memory(self, state: TrainState):
        """The model without sequence parallelism (an evaluation on the
        whole memory, on every rank alone); restored afterwards."""
        user = state.model.user
        user.set_sequence_parallel(None)
        try:
            yield state.model
        finally:
            if self.user_config.sequence_parallel:
                user.set_sequence_parallel(self.mesh.sp_group)

    def make_batch(
        self,
        samples: Sequence[Tuple[List[str], str]],
        indices: Sequence[int],
        item_tokens: np.ndarray,  # [N, K, D] precomputed catalog tokens
        cache: FieldEmbeddingCache,
        timestamp_map: Dict[str, int],
        max_seq_len: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """The JAX trainer's numpy batch: histories right-padded to
        ``max_seq_len``; history items missing from the cache are masked out
        and a target missing from it gets sample weight 0."""
        s_max = max_seq_len or self.max_seq_len
        k, d = item_tokens.shape[1], item_tokens.shape[2]
        n = len(indices)
        toks = np.zeros((n, s_max, k, d), np.float32)
        ts = np.zeros((n, s_max), np.float32)
        coords = np.zeros((n, s_max, 2), np.float32)
        seq_mask = np.zeros((n, s_max), np.float32)
        targets = np.zeros((n, k, d), np.float32)
        weights = np.ones((n,), np.float32)
        for bi, si in enumerate(indices):
            hist, target = samples[si]
            hist = hist[-s_max:]
            rows = cache.rows_for(hist)
            valid = rows >= 0
            toks[bi, : len(hist)][valid] = item_tokens[rows[valid]]
            ts[bi, : len(hist)] = [timestamp_map.get(h, 0) for h in hist]
            seq_mask[bi, : len(hist)] = valid.astype(np.float32)
            trow = cache.rows_for([target])[0]
            if trow >= 0:
                targets[bi] = item_tokens[trow]
            else:
                weights[bi] = 0.0
        return {
            "item_tokens": toks,
            "timestamps": ts,
            "coordinates": coords,
            "seq_mask": seq_mask,
            "target_tokens": targets,
            "sample_weight": weights,
        }

    def train_epoch(self, state: TrainState, samples,
                    item_tokens: np.ndarray, cache: FieldEmbeddingCache,
                    timestamp_map: Dict[str, int], rng: np.random.Generator,
                    batch_size: Optional[int] = None
                    ) -> Tuple[TrainState, Dict[str, float]]:
        batch_size = batch_size or self.train_config.batch_size

        def stream():
            for idx in epoch_batches(rng, len(samples), batch_size):
                yield self.make_batch(samples, idx, item_tokens, cache,
                                      timestamp_map)

        state, mean, _ = drive_steps(self._train_step, state, stream())
        return state, mean


def train_user_qformer(
    cache: FieldEmbeddingCache,
    user_histories: Sequence[Dict],
    review_data: Dict[str, list],
    item_qformer: ItemQFormer,
    user_config: Optional[UserQFormerConfig] = None,
    train_config: Optional[TrainConfig] = None,
    max_seq_len: int = 50,
    checkpoint_dir: Optional[str] = None,
    dtype: str = "float32",
    resume: bool = False,
    metrics_logger=None,
    log_fn=print,
    device: Optional[str] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    """The full training run (reference: train_user_qformer,
    user_qformer_training.py:166-229) over an Item Q-Former with its weights
    loaded.  ``resume=True`` restores parameters, optimizer state, step and
    the best-loss watermark from ``checkpoint_dir``."""
    from unirec_tpu_torch.eval.user_eval import evaluate_user_qformer
    from unirec_tpu_torch.utils.checkpoint import (
        resume_train_state,
        save_train_state,
    )

    if not is_writer():  # rank 0 logs for the world
        log_fn = lambda *args, **kwargs: None  # noqa: E731
    iq = item_qformer.config
    user_config = user_config or UserQFormerConfig(
        num_item_tokens_to_predict=iq.num_query_tokens,
        # item tokens live in the item Q-Former's hidden space
        input_embedding_dim=iq.hidden_size,
    )
    train_config = train_config or TrainConfig(
        batch_size=64, num_epochs=50,
        optimizer=OptimizerConfig(learning_rate=5e-5))
    grad_accum = train_config.optimizer.gradient_accumulation_steps
    trainer = UserQFormerTrainer(user_config, train_config, max_seq_len,
                                 dtype=dtype, device=device)
    samples = build_sliding_window_samples(user_histories,
                                           max_seq_len=max_seq_len)
    ts_map = build_timestamp_map(review_data)
    item_tokens = precompute_item_tokens(item_qformer, cache)

    # 90/10 held-out split (the reference checkpoints by train loss only and
    # has no validation set, user_qformer_training.py:219-229)
    rng = np.random.default_rng(train_config.seed)
    perm = rng.permutation(len(samples))
    split = max(int(0.9 * len(samples)), 1)
    train_samples = [samples[i] for i in perm[:split]]
    val_samples = [samples[i] for i in perm[split:]]

    state = trainer.init_state()
    best_loss = float("inf")
    if resume:
        state, meta = resume_train_state(checkpoint_dir, state, log_fn,
                                         expect_grad_accum=grad_accum)
        best_loss = float(meta.get("loss", float("inf")))
    metrics: Dict[str, float] = {}
    for epoch in range(train_config.num_epochs):
        state, metrics = trainer.train_epoch(state, train_samples, item_tokens,
                                             cache, ts_map, rng)
        log_fn(f"epoch {epoch + 1}: {metrics}")
        if metrics_logger:
            metrics_logger.log(dict(metrics), step=state.step)
        if metrics["loss"] < best_loss:
            best_loss = metrics["loss"]
            if checkpoint_dir:
                save_train_state(checkpoint_dir, state, config=user_config,
                                 extra={"epoch": epoch, "loss": best_loss,
                                        "grad_accum": grad_accum})
    state = flush_grad_accum(state)
    if val_samples:
        with trainer.whole_memory(state):
            val = evaluate_user_qformer(trainer, state, val_samples,
                                        item_tokens, cache, ts_map)
        log_fn(f"validation: {val}")
        if metrics_logger:
            metrics_logger.log(dict(val), step=state.step)
        metrics = {**metrics, **val}
    return state, metrics
