"""Port parity: Item Q-Former and the attention primitives,
unirec_tpu_torch vs unirec_tpu on the CPU (fp32, atol 2e-5).

Q-Former: hidden 64, 2 layers (layer 1 has no cross-attention), 2 heads,
K=2 queries, F=3 fields of width 16, with and without the field-type table.
Parameters come from Flax ``init`` and go through
``utils.weights.flax_to_state_dict``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import ItemQFormerConfig
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.ops import attention as jax_attn
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.ops import attention as port_attn
from unirec_tpu_torch.utils.weights import flax_to_state_dict


CFG = ItemQFormerConfig(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=128, num_query_tokens=2, field_embedding_dim=16,
    num_fields=3, dropout=0.0,
)
ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jm = JaxItemQFormer(CFG)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16)),
                     jnp.ones((1, 3)))
    pm = ItemQFormer(CFG)
    pm.load_state_dict(flax_to_state_dict(params))
    return jm, params, pm.eval()


def _masks(rng, mode, batch):
    if mode == "all_present":
        return np.ones((batch, CFG.num_fields), np.float32)
    mask = (rng.rand(batch, CFG.num_fields) > 0.4).astype(np.float32)
    mask[0] = [1.0, 0.0, 1.0]
    mask[1] = 0.0  # an item with every field missing
    return mask


@pytest.mark.parametrize("mode", ["all_present", "some_masked"])
def test_item_qformer_matches_jax(models, mode):
    jm, params, pm = models
    rng = np.random.RandomState(3)
    fields = rng.randn(5, CFG.num_fields, 16).astype(np.float32)
    mask = _masks(rng, mode, 5)
    want = jm.apply(params, jnp.asarray(fields), jnp.asarray(mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(fields), torch.from_numpy(mask))
    for key in ("query_outputs", "item_representation", "reconstructed_fields"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("mode", ["all_present", "some_masked"])
def test_item_qformer_field_type_embeddings_match_jax(mode):
    cfg = dataclasses.replace(CFG, use_field_type_embeddings=True)
    jm = JaxItemQFormer(cfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 16)),
                     jnp.ones((1, 3)))
    pm = ItemQFormer(cfg).eval()
    pm.load_state_dict(flax_to_state_dict(params))
    assert pm.field_id_embeddings.shape == (3, 16)
    rng = np.random.RandomState(6)
    fields = rng.randn(5, CFG.num_fields, 16).astype(np.float32)
    mask = _masks(rng, mode, 5)
    want = jm.apply(params, jnp.asarray(fields), jnp.asarray(mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(fields), torch.from_numpy(mask))
    for key in ("query_outputs", "item_representation", "reconstructed_fields"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    # built without the modality table, modality ids are refused
    with pytest.raises(ValueError, match="modality"):
        pm.query_outputs(torch.from_numpy(fields), torch.from_numpy(mask),
                         modality_ids=torch.zeros(3, dtype=torch.long))


def test_masked_field_values_are_ignored(models):
    _, _, pm = models
    rng = np.random.RandomState(4)
    fields = rng.randn(2, CFG.num_fields, 16).astype(np.float32)
    mask = np.array([[1, 0, 1], [1, 1, 0]], np.float32)
    noisy = fields.copy()
    noisy[mask == 0] = 100.0 * rng.randn(int((mask == 0).sum()), 16)
    with torch.no_grad():
        a = pm.query_outputs(torch.from_numpy(fields), torch.from_numpy(mask))
        b = pm.query_outputs(torch.from_numpy(noisy), torch.from_numpy(mask))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_attention_primitives_match_jax():
    rng = np.random.RandomState(5)
    q = rng.randn(2, 2, 4, 8).astype(np.float32)
    k = rng.randn(2, 2, 3, 8).astype(np.float32)
    v = rng.randn(2, 2, 3, 8).astype(np.float32)
    mask = np.array([[1, 1, 0], [0, 1, 1]], np.float32)
    jb = jax_attn.make_additive_mask(jnp.asarray(mask))
    pb = port_attn.make_additive_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    want = jax_attn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb)
    got = port_attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), pb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    x = rng.randn(2, 4, 16).astype(np.float32)
    split = port_attn.split_heads(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(
        split.numpy(), np.asarray(jax_attn.split_heads(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(port_attn.merge_heads(split).numpy(), x)
