"""Port parity: ``unirec_tpu_torch/train/common.py`` against the JAX
package's optax chain (``unirec_tpu/train/common.make_optimizer`` and
``flush_grad_accum``) on the same parameters and gradients, and the batching
and step-driving helpers against theirs.

fp32 on the CPU.  Tolerance: parameters within rtol 1e-6, atol 1e-7 after
every update (the same float32 operations in the same order; only pow and
sqrt may round differently); an update with learning rate 0 leaves the
parameters bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.configs import OptimizerConfig
from unirec_tpu.train.common import TrainState as JaxTrainState
from unirec_tpu.train.common import epoch_batches as jax_epoch_batches
from unirec_tpu.train.common import flush_grad_accum as jax_flush
from unirec_tpu.train.common import make_optimizer as jax_make_optimizer
from unirec_tpu.train.common import pad_to_batch as jax_pad_to_batch
from unirec_tpu_torch.train.common import (
    TrainState,
    drive_steps,
    epoch_batches,
    flush_grad_accum,
    make_optimizer,
    pad_to_batch,
)

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"w": (4, 3), "b": (5,)}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(n, seed=1, scale=1.0):
    rng = np.random.RandomState(seed)
    return [{k: (rng.randn(*s) * scale).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


class _Pair:
    """The port's optimizer and the JAX TrainState, stepped together."""

    def __init__(self, cfg):
        init = _params()
        self.port = {k: torch.tensor(v) for k, v in init.items()}
        self.opt = make_optimizer(self.port, cfg)
        self.jax = JaxTrainState.create(
            apply_fn=lambda *a: None,
            params={k: jnp.asarray(v) for k, v in init.items()},
            tx=jax_make_optimizer(cfg))
        self.cfg = cfg

    def step(self, g):
        self.opt.step({k: torch.tensor(v) for k, v in g.items()})
        self.jax = self.jax.apply_gradients(
            grads={k: jnp.asarray(v) for k, v in g.items()})

    def check(self):
        for k, p in self.port.items():
            np.testing.assert_allclose(p.numpy(), np.asarray(self.jax.params[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


CONFIGS = {
    "adamw": OptimizerConfig(learning_rate=1e-2),
    "decay": OptimizerConfig(learning_rate=1e-2, weight_decay=0.01),
    "warmup": OptimizerConfig(learning_rate=1e-2, warmup_steps=3),
    "clip": OptimizerConfig(learning_rate=1e-2, max_grad_norm=1.0),
    "joint_cli": OptimizerConfig(learning_rate=1e-3, warmup_steps=20,
                                 max_grad_norm=1.0),
    "accum": OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                             max_grad_norm=1.0, weight_decay=0.01,
                             gradient_accumulation_steps=3),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_optimizer_matches_optax(name):
    pair = _Pair(CONFIGS[name])
    for g in _grads(8, scale=3.0):
        pair.step(g)
        pair.check()


def test_warmup_first_update_has_learning_rate_zero():
    cfg = CONFIGS["warmup"]
    pair = _Pair(cfg)
    before = {k: v.clone() for k, v in pair.port.items()}
    pair.step(_grads(1)[0])
    for k in SHAPES:  # linear_schedule(0, lr, warmup) read at count 0
        assert torch.equal(pair.port[k], before[k])
        np.testing.assert_array_equal(np.asarray(pair.jax.params[k]),
                                      before[k].numpy())
    assert pair.opt.learning_rate(0).item() == 0.0
    np.testing.assert_allclose(pair.opt.learning_rate(1).item(), 1e-2 / 3,
                               rtol=RTOL)  # a float32 schedule
    assert pair.opt.learning_rate(10).item() == pytest.approx(1e-2)


@pytest.mark.parametrize("norm", [0.5, 1.0, 2.0],
                         ids=["below", "exactly_at", "above"])
def test_clip_by_global_norm_at_and_above_max_norm(norm):
    """optax clips when |g| >= max_norm (no epsilon): a gradient of norm
    exactly max_norm takes the scaling branch, t / |g| * max_norm."""
    cfg = dataclasses.replace(CONFIGS["clip"], learning_rate=1.0)
    g = {"w": np.zeros(SHAPES["w"], np.float32),
         "b": np.zeros(SHAPES["b"], np.float32)}
    g["w"][0, 0], g["b"][1] = 0.6 * norm, 0.8 * norm  # |g| = norm exactly
    pair = _Pair(cfg)
    pair.step(g)
    pair.check()
    # with one step Adam's update is ~sign(g): clipping shows in the moments
    for k in SHAPES:
        want = g[k] if norm < 1.0 else g[k] / np.float32(norm)
        np.testing.assert_allclose(pair.opt.mu[k].numpy(), 0.1 * want,
                                   rtol=1e-6)


def test_multisteps_running_mean_and_flush():
    cfg = dataclasses.replace(CONFIGS["accum"], gradient_accumulation_steps=4)
    pair = _Pair(cfg)
    grads = _grads(6)
    for i, g in enumerate(grads):
        pair.step(g)
        pair.check()
        assert pair.opt.mini_step == int(pair.jax.opt_state.mini_step)
        assert pair.opt.gradient_step == int(pair.jax.opt_state.gradient_step)
    np.testing.assert_allclose(
        pair.opt.acc["w"].numpy(), np.asarray(pair.jax.opt_state.acc_grads["w"]),
        rtol=RTOL, atol=ATOL)
    state = TrainState(model=None, optimizer=pair.opt, step=6)
    state = flush_grad_accum(state)
    pair.jax = jax_flush(pair.jax, cfg)
    pair.check()
    assert state.step == 6 and pair.opt.mini_step == 0
    assert pair.opt.gradient_step == int(pair.jax.opt_state.gradient_step) == 2
    assert all(float(a.abs().max()) == 0.0 for a in pair.opt.acc.values())
    assert not pair.opt.flush()  # nothing pending any more


def test_optimizer_state_dict_round_trip():
    cfg = CONFIGS["accum"]
    a = _Pair(cfg)
    for g in _grads(4):
        a.step(g)
    b = _Pair(cfg)
    for k in SHAPES:
        b.port[k].copy_(a.port[k])
    b.opt.load_state_dict(a.opt.state_dict())
    for g in _grads(3, seed=5):
        a.opt.step({k: torch.tensor(v) for k, v in g.items()})
        b.opt.step({k: torch.tensor(v) for k, v in g.items()})
    for k in SHAPES:
        assert torch.equal(a.port[k], b.port[k])
    with pytest.raises(ValueError, match="accumulation"):
        _Pair(CONFIGS["adamw"]).opt.load_state_dict(a.opt.state_dict())


@pytest.mark.parametrize("n,batch", [(10, 4), (8, 4), (3, 4)])
def test_epoch_batches_and_padding_match_jax(n, batch):
    got = list(epoch_batches(np.random.default_rng(7), n, batch))
    want = list(jax_epoch_batches(np.random.default_rng(7), n, batch))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    data = {"x": np.arange(3 * 2).reshape(3, 2)}
    (p1, n1), (p2, n2) = pad_to_batch(data, 5), jax_pad_to_batch(data, 5)
    assert n1 == n2 == 3
    np.testing.assert_array_equal(p1["x"], p2["x"])


def test_drive_steps_bounds_in_flight_and_hooks():
    """Without a hook at most max_in_flight steps' metrics wait unread; a
    hook sees every step's float metrics."""
    pending = []

    class Lazy:
        def __init__(self, v):
            self.v = v
            pending.append(self)

        def __float__(self):
            pending.remove(self)
            return float(self.v)

    high = []

    def step(state, batch):
        high.append(len(pending))
        return state + 1, {"loss": Lazy(batch)}

    state, mean, last = drive_steps(step, 0, range(6), max_in_flight=2)
    assert state == 6 and max(high) <= 1 and not pending
    assert mean == {"loss": 2.5} and last == {"loss": 5.0}
    seen = []
    drive_steps(step, 0, range(3),
                step_hook=lambda i, st, m: seen.append((i, st, m["loss"])))
    assert seen == [(0, 1, 0.0), (1, 2, 1.0), (2, 3, 2.0)]
