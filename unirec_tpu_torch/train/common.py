"""Shared training utilities (port of ``unirec_tpu/train/common.py``): the
train state, the optimizer chain, batching and the step loop.

The optimizer is optax's chain written out, not ``torch.optim``'s defaults,
so that the port's updates equal the JAX trainers' (``make_optimizer``):

* warmup: ``optax.linear_schedule(0, lr, warmup)`` read at the count before
  the update, so with warmup the first update has learning rate 0;
* clipping: ``clip_by_global_norm`` scales every gradient by
  ``max_norm / |g|`` only when ``|g| >= max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
* ``optax.adamw``: bias-corrected moments, eps outside the square root
  (``eps_root`` 0), then the decoupled decay ``wd * p``, then ``-lr``;
* gradient accumulation: ``optax.MultiSteps`` keeps the running mean of the
  micro-batch gradients and applies the chain above every k calls; warmup
  counts applies, not micro-steps.  ``flush_grad_accum`` applies a pending
  partial mean at the end of training.

The optimizer holds only the trainable parameters (the JAX trainer's
``multi_transform`` gives the frozen ones ``set_to_zero``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn

from unirec_tpu_torch.configs import OptimizerConfig


class OptaxAdamW:
    """``make_optimizer(cfg)`` of the JAX package over named parameters.

    ``step(grads)`` applies one micro-step in place; the moments and the
    accumulator are float32 tensors beside each parameter."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: OptimizerConfig):
        self.params = dict(params)
        self.cfg = cfg
        self.k = max(1, int(cfg.gradient_accumulation_steps))
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for n, p in self.params.items()}
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.k > 1 else {}
        self.count = 0          # inner applies (adam and the schedule)
        self.mini_step = 0      # MultiSteps: micro-steps since the last apply
        self.gradient_step = 0  # MultiSteps: applies

    def learning_rate(self, count: int) -> torch.Tensor:
        """The schedule at ``count`` applies, float32 as optax computes it."""
        lr = torch.tensor(self.cfg.learning_rate, dtype=torch.float32)
        warm = self.cfg.warmup_steps
        if warm <= 0:
            return lr
        c = torch.tensor(min(max(count, 0), warm), dtype=torch.float32)
        frac = 1 - c / warm
        return (0.0 - lr) * frac + lr

    @torch.no_grad()
    def _apply(self, grads: Dict[str, torch.Tensor]) -> None:
        cfg = self.cfg
        grads = {n: g.float() for n, g in grads.items()}
        if cfg.max_grad_norm > 0:  # on the device: no host synchronisation
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            keep = norm < cfg.max_grad_norm
            grads = {n: torch.where(keep, g, g / norm * cfg.max_grad_norm)
                     for n, g in grads.items()}
        step_size = -self.learning_rate(self.count)
        self.count += 1
        b1 = torch.tensor(cfg.b1, dtype=torch.float32)
        b2 = torch.tensor(cfg.b2, dtype=torch.float32)
        device = next(iter(self.mu.values())).device
        bc1, bc2, step_size = (t.to(device) for t in (
            1 - b1 ** self.count, 1 - b2 ** self.count, step_size))
        for name, p in self.params.items():
            g, mu, nu = grads[name], self.mu[name], self.nu[name]
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * (g * g))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if cfg.weight_decay:
                upd = upd + cfg.weight_decay * p.float()
            p.copy_(p.float() + upd * step_size)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One micro-step: with k > 1, fold ``grads`` into the running mean
        and apply the chain on every k-th call."""
        if self.k == 1:
            self._apply(grads)
            return
        n = self.mini_step
        for name, acc in self.acc.items():
            acc.add_((grads[name].float() - acc) / (n + 1))
        if self.mini_step == self.k - 1:
            self._apply(self.acc)
            for acc in self.acc.values():
                acc.zero_()
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % self.k

    @torch.no_grad()
    def flush(self) -> bool:
        """Apply a pending partial accumulation (the JAX
        ``flush_grad_accum``); False when there was none."""
        if self.k == 1 or self.mini_step == 0:
            return False
        self._apply(self.acc)
        for acc in self.acc.values():
            acc.zero_()
        self.mini_step = 0
        self.gradient_step += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mini_step": self.mini_step,
                "gradient_step": self.gradient_step, "k": self.k,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if int(state["k"]) != self.k or set(state["mu"]) != set(self.mu):
            raise ValueError("optimizer state does not match this optimizer "
                             "(gradient accumulation or parameters differ)")
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                             (self.acc, state["acc"])):
            for name, t in mine.items():
                t.copy_(theirs[name])


def _nodes(tree: Any, pred: Callable[[Mapping], bool]) -> list:
    """Every mapping in a restored optax state (nested dicts and lists) that
    ``pred`` accepts, in order; a match is not searched further."""
    if isinstance(tree, Mapping):
        if pred(tree):
            return [tree]
        return [n for v in tree.values() for n in _nodes(v, pred)]
    if isinstance(tree, (list, tuple)):
        return [n for v in tree for n in _nodes(v, pred)]
    return []


def optimizer_state_from_optax(state: Any, grad_accum: int = 1
                               ) -> Dict[str, Any]:
    """The JAX trainers' optax state, as orbax restores it (nested dicts, a
    NamedTuple's fields by name; lists for tuples; numpy arrays; None for an
    empty state or a masked leaf), -> ``OptaxAdamW.state_dict()`` for an
    optimizer of gradient accumulation ``grad_accum`` (the checkpoint
    meta's ``grad_accum``).

    It reads ``multi_transform``'s trainable branch ("train"; the frozen
    one holds no state), ``MultiSteps``' ``mini_step``, ``gradient_step``
    and ``acc_grads``, adamw's ``count``, ``mu`` and ``nu``, and the warmup
    schedule's ``count``, which must equal adam's (the port keeps one
    count).  The moments and the accumulator take the port's names and
    layouts (``utils/weights.port_state_dict_from_flax``); masked leaves
    drop out, so they cover the trainable parameters only."""
    from unirec_tpu_torch.utils.weights import port_state_dict_from_flax

    node = state
    if isinstance(node, Mapping) and "inner_states" in node:
        node = node["inner_states"]["train"]["inner_state"]
    multi = node if isinstance(node, Mapping) and "mini_step" in node else None
    if (multi is not None) != (int(grad_accum) > 1):
        raise ValueError(f"optax state {'has' if multi else 'lacks'} "
                         f"MultiSteps, but grad_accum is {grad_accum}")
    inner = multi["inner_opt_state"] if multi is not None else node
    adam = _nodes(inner, lambda d: {"count", "mu", "nu"} <= set(d))
    if len(adam) != 1:
        raise ValueError(f"expected one adam state, found {len(adam)}")
    count = int(np.asarray(adam[0]["count"]))
    for sched in _nodes(inner, lambda d: set(d) == {"count"}):
        if int(np.asarray(sched["count"])) != count:
            raise ValueError("the schedule's count differs from adam's")
    return {
        "count": count,
        "mini_step": int(np.asarray(multi["mini_step"])) if multi else 0,
        "gradient_step": (int(np.asarray(multi["gradient_step"]))
                          if multi else 0),
        "k": max(1, int(grad_accum)),
        "mu": port_state_dict_from_flax(adam[0]["mu"]),
        "nu": port_state_dict_from_flax(adam[0]["nu"]),
        "acc": (port_state_dict_from_flax(multi["acc_grads"])
                if multi else {}),
    }


def make_optimizer(params: Dict[str, torch.Tensor],
                   cfg: OptimizerConfig) -> OptaxAdamW:
    """AdamW with optional warmup, global-norm clipping and gradient
    accumulation, as the JAX ``make_optimizer``."""
    return OptaxAdamW(params, cfg)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer and the step count
    (micro-steps: batches consumed), the JAX ``TrainState``'s parts."""

    model: nn.Module
    optimizer: OptaxAdamW
    step: int = 0


def flush_grad_accum(state: TrainState) -> TrainState:
    """Force-apply any pending micro-gradient accumulation at the end of
    training (HF Trainer semantics: the tail of the last window is never
    dropped).  ``state.step`` is unchanged: the flush consumes no batch."""
    state.optimizer.flush()
    return state


def epoch_batches(rng: np.random.Generator, num_examples: int,
                  batch_size: int, shuffle: bool = True,
                  drop_last: Optional[bool] = None) -> Iterator[np.ndarray]:
    """Index arrays per batch, the JAX function's (same shuffle, same
    batches).  drop_last defaults to True whenever one full batch exists;
    a dataset smaller than one batch yields one short batch."""
    idx = np.arange(num_examples)
    if shuffle:
        rng.shuffle(idx)
    if drop_last is None:
        drop_last = num_examples >= batch_size
    stop = num_examples - (num_examples % batch_size) if drop_last else num_examples
    stop = max(stop, min(batch_size, num_examples))
    for i in range(0, stop, batch_size):
        yield idx[i: i + batch_size]


def pad_to_batch(batch, batch_size: int):
    """Pad a dict-of-arrays batch to a fixed leading size (repeat the last
    row); returns (padded, original_n)."""
    n = next(iter(batch.values())).shape[0]
    if n == batch_size:
        return batch, n
    pad = batch_size - n
    padded = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
              for k, v in batch.items()}
    return padded, n


def drive_steps(train_step: Callable, state, batches: Iterable, *,
                max_in_flight: int = 2,
                step_hook: Optional[Callable] = None):
    """Run ``train_step(state, batch) -> (state, metrics)`` over batches.

    Metrics are device scalars; they are read (a host synchronisation) at
    most ``max_in_flight`` steps late, so the host queues the next steps
    while the card works.  ``step_hook(step_index, state, float_metrics)``
    reads every step's metrics as it comes (hooks observe real values).
    Returns ``(state, mean_metrics, last_metrics)``."""
    queue: collections.deque = collections.deque()
    sums: Dict[str, float] = {}
    count = 0
    last: Dict[str, float] = {}

    def drain_one():
        nonlocal count, last
        floats = {k: float(v) for k, v in queue.popleft().items()}
        for k, v in floats.items():
            sums[k] = sums.get(k, 0.0) + v
        count += 1
        last = floats
        return floats

    for step_index, batch in enumerate(batches):
        state, metrics = train_step(state, batch)
        queue.append({k: v for k, v in metrics.items() if k != "grads"})
        if step_hook is not None:
            state = step_hook(step_index, state, drain_one()) or state
        elif len(queue) >= max_in_flight:
            drain_one()
    while queue:
        drain_one()
    mean = {k: v / max(count, 1) for k, v in sums.items()}
    return state, mean, last

