"""Port parity: MWNE property training (``train/mwne.py``) against
``unirec_tpu/train/mwne.py`` on the CPU, fp32.

The JAX trainer's weights (Flax ``init``, embedding 48, 8 frequencies) are
bridged into the port's ``MWNEModel``.  The JAX step's random draws (the
batch of 64, the additivity pairs and the 10 distance triplets) are made
with ``jax.random`` from the step's key, as the JAX step makes them, and
fed to the port.  The three losses and the total, as one vector, are held
within 1e-5 (max|d| / max|ref|; the additivity term alone differs by about
1e-5 of itself, a cancellation of Fourier features of large phases), and
the parameters after one step (clip 0.5, AdamW with weight decay 1e-6)
within 1e-5 (max|d| / max|ref|).  ``train mwne`` runs through
the CLI on the CPU at a small size and writes its checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.configs import MWNEConfig as JaxMWNEConfig
from unirec_tpu.train import mwne as jm
from unirec_tpu_torch.configs import MWNEConfig
from unirec_tpu_torch.train import mwne as pm
from unirec_tpu_torch.utils.weights import flax_to_state_dict

TOL = 1e-5
DIMS = dict(embedding_dim=48, num_frequencies=8)


def _jax_draws(key):
    """The JAX step's batch and indices, drawn as ``_make_step`` draws
    them."""
    r_batch, r_loss = jax.random.split(key)
    numbers = jm.generate_training_batch(r_batch, 64)
    r_add, r_dist = jax.random.split(r_loss)
    ra, rb = jax.random.split(r_add)
    ia = jax.random.randint(ra, (32,), 0, 64)
    ib = jax.random.randint(rb, (32,), 0, 64)
    trip = jnp.stack([jax.random.choice(r, 64, (3,), replace=False)
                      for r in jax.random.split(r_dist, 10)])
    return [torch.from_numpy(np.array(a)) for a in (numbers, ia, ib, trip)]


@pytest.fixture(scope="module")
def trainers():
    jtr = jm.MWNETrainer(JaxMWNEConfig(**DIMS), lr=1e-3, seed=0)
    model = pm.MWNEModel(MWNEConfig(**DIMS))
    model.load_state_dict(flax_to_state_dict(jtr.params))
    ptr = pm.MWNETrainer(MWNEConfig(**DIMS), lr=1e-3, device="cpu",
                         model=model)
    return jtr, ptr


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max()
                 / np.abs(want).max())


def test_losses_and_one_step_match_jax(trainers):
    jtr, ptr = trainers
    key = jax.random.PRNGKey(5)
    numbers, ia, ib, trip = _jax_draws(key)
    # the losses on the JAX step's inputs, before the update
    total, parts = ptr.losses(numbers, ia.long(), ib.long(), trip.long())
    params, _, metrics = jtr._step(jtr.params, jtr.opt_state, key)
    names = ("additivity", "invertibility", "distance")
    got = torch.stack([parts[n] for n in names] + [total]).detach()
    assert _rel(got, [metrics[n] for n in names + ("total",)]) <= TOL
    ptr.step(numbers, ia.long(), ib.long(), trip.long())
    want_sd = flax_to_state_dict(params)
    for name, p in ptr.model.named_parameters():
        assert _rel(p, want_sd[name].numpy()) <= TOL, name


def test_draws_and_batches_have_the_jax_shapes():
    gen = torch.Generator().manual_seed(0)
    batch = pm.generate_training_batch(gen, 64)
    ia, ib, trip = pm.draw_indices(gen, 64)
    assert batch.shape == (64,) and ia.shape == ib.shape == (32,)
    assert trip.shape == (10, 3)
    assert all(len(set(row.tolist())) == 3 for row in trip)
    assert bool((batch[12:24] >= 10).all()) and bool((batch[24:36] <= 0).all())


def test_spearman_matches_jax():
    rng = np.random.RandomState(1)
    numbers = rng.randn(9).astype(np.float32)
    emb = rng.randn(9, 5).astype(np.float32)
    assert pm.spearman_distance_correlation(numbers, emb) == pytest.approx(
        jm.spearman_distance_correlation(numbers, emb), abs=1e-12)


def test_train_mwne_cli(tmp_path, capsys):
    from unirec_tpu_torch.cli import train_cli

    ckpt = tmp_path / "mwne"
    rc = train_cli.main(["mwne", "--embedding-dim", "48", "--num-frequencies",
                         "8", "--num-steps", "40", "--device", "cpu",
                         "--checkpoint-dir", str(ckpt)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"train", "eval"}
    assert np.isfinite(out["train"]["total"])
    assert -1.0 <= out["eval"]["distance_rank_correlation"] <= 1.0
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["config"]["embedding_dim"] == 48
    assert "final_metrics" in meta and (ckpt / "optimizer.pt").exists()
