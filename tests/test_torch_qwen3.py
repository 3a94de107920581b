"""Port parity: Qwen3Model hidden states and its parts, unirec_tpu_torch vs
unirec_tpu on the CPU (fp32, atol 5e-5).

``tiny_qwen3_config(max_position_embeddings=64)`` with LoRA on all seven
projections, ``lora_b`` randomised, right-padded masks.  The JAX model runs
its exact XLA path on the CPU; the port's attention runs the plain version
of K1 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import LoRAConfig, tiny_qwen3_config
from unirec_tpu.models import qwen3 as jq
from unirec_tpu_torch.models import qwen3 as pq
from unirec_tpu_torch.utils.weights import flax_to_state_dict
from tests.test_torch_joint import randomize_lora_b


CFG = tiny_qwen3_config(max_position_embeddings=64)
ATOL = 5e-5


def _inputs(seed=0, b=3, l=24):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, CFG.vocab_size + 4, (b, l)).astype(np.int32)
    mask = np.zeros((b, l), np.float32)
    for i, length in enumerate([l, 11, 1][:b]):
        mask[i, :length] = 1.0
    return ids, mask


@pytest.mark.parametrize("grouped", [False, True])
def test_qwen3_hidden_states_match_jax(grouped):
    lora = LoRAConfig(r=4, dropout=0.0, grouped=grouped)
    jm = jq.Qwen3Model(CFG, lora=lora, n_extra_tokens=4)
    ids, mask = _inputs()
    params = randomize_lora_b(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)))
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    pm = pq.Qwen3Model(CFG, lora=lora, n_extra_tokens=4)
    pm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # every query row is computed, padded rows included
    assert np.isfinite(got).all()


def test_norm_and_rope_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1))
    jcos, jsin = jq.rotary_embedding(jnp.asarray(pos), 16, 1e6)
    pcos, psin = pq.rotary_embedding(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(pcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(psin.numpy(), np.asarray(jsin), atol=1e-6)
    np.testing.assert_allclose(
        pq.apply_rope(torch.from_numpy(x), pcos, psin).numpy(),
        np.asarray(jq.apply_rope(jnp.asarray(x), jcos, jsin)), atol=1e-6)
    norm = jq.RMSNorm(16)
    scale = rng.rand(16).astype(np.float32) + 0.5
    nparams = {"params": {"scale": jnp.asarray(scale)}}
    pnorm = pq.RMSNorm(16)
    pnorm.weight.data = torch.from_numpy(scale)
    np.testing.assert_allclose(
        pnorm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(norm.apply(nparams, jnp.asarray(x))), atol=1e-6)


def test_pools_match_jax():
    rng = np.random.RandomState(2)
    h = rng.randn(3, 6, 8).astype(np.float32)
    mask = np.array([[1] * 6, [1] * 2 + [0] * 4, [1] + [0] * 5], np.float32)
    ht, mt = torch.from_numpy(h), torch.from_numpy(mask)
    for masked in (False, True):
        np.testing.assert_allclose(
            pq.mean_pool(ht, mt, masked=masked).numpy(),
            np.asarray(jq.mean_pool(jnp.asarray(h), jnp.asarray(mask),
                                    masked=masked)), atol=1e-6)
    np.testing.assert_array_equal(
        pq.last_token_pool(ht, mt).numpy(),
        np.asarray(jq.last_token_pool(jnp.asarray(h), jnp.asarray(mask))))


def test_lora_dense_forms_agree():
    """Plain and grouped (lora_mid) LoRA overlays are the same maths."""
    lora = LoRAConfig(grouped=True)  # r=16, alpha=32
    gen = torch.Generator().manual_seed(0)
    dense = pq.LoRADense(8, 6, lora=lora, lora_enabled=True)
    for p in dense.parameters():
        p.data = torch.randn(p.shape, generator=gen)
    x = torch.randn(2, 5, 8, generator=gen)
    plain = dense(x)
    grouped = dense(x, lora_mid=x @ dense.lora_a)
    torch.testing.assert_close(plain, grouped)
    assert dense.scaling == lora.scaling == 2.0
    want = x @ dense.weight.T + (x @ dense.lora_a @ dense.lora_b) * 2.0
    torch.testing.assert_close(plain, want)
