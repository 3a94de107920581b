"""Port parity: MultiModalQwenEmbedding (injection + Qwen3 + pooling) and the
prompt helpers, unirec_tpu_torch vs unirec_tpu on the CPU.

Parameters come from Flax ``init`` with ``lora_b`` randomised (so the LoRA
path contributes) and go through ``utils.weights.joint_state_dict_from_flax``.
Inputs come from ``np.random.RandomState``.  Tolerance: atol 5e-5 in fp32
(tiny two-layer stacks; sums run in another order in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    tiny_qwen3_config,
)
from unirec_tpu.models import joint as jax_joint
from unirec_tpu.utils.torch_convert import (
    convert_joint_model,
    export_joint_model,
)
from unirec_tpu_torch.models import joint as port_joint
from unirec_tpu_torch.utils.weights import joint_state_dict_from_flax


QWEN = tiny_qwen3_config(max_position_embeddings=64)
F, FD = 3, 16
QF = ItemQFormerConfig(
    hidden_size=QWEN.hidden_size, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, num_query_tokens=2, field_embedding_dim=FD,
    num_fields=F, dropout=0.0,
)
JC = JointModelConfig(num_history_items=2, num_query_tokens_per_item=2,
                      max_length=32)
LORA = LoRAConfig(r=2, dropout=0.0)


def randomize_lora_b(params, seed: int = 0):
    """Numpy copy of a Flax tree with every ``lora_b`` leaf made nonzero."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for name, value in tree.items():
            if isinstance(value, dict) or hasattr(value, "items"):
                out[name] = walk(value)
            elif name == "lora_b":
                out[name] = (0.2 * rng.randn(*np.shape(value))).astype(
                    np.float32)
            else:
                out[name] = np.asarray(value, np.float32)
        return out

    return walk(params)


def joint_inputs(rng, batch: int, jc=JC, qwen=QWEN):
    """Right-padded ids with the special tokens placed, masks, history."""
    n_special = jc.num_history_items * jc.num_query_tokens_per_item
    ids = rng.randint(1, qwen.vocab_size, (batch, jc.max_length)).astype(
        np.int32)
    mask = np.zeros((batch, jc.max_length), np.float32)
    for i in range(batch):
        length = rng.randint(n_special + 1, jc.max_length + 1)
        mask[i, :length] = 1.0
        ids[i, length:] = 0
        pos = rng.choice(length, n_special, replace=False)
        ids[i, pos] = qwen.vocab_size + np.arange(n_special)
    hist = rng.randn(batch, jc.num_history_items, F, FD).astype(np.float32)
    hmask = (rng.rand(batch, jc.num_history_items, F) > 0.3).astype(np.float32)
    hmask[..., 0] = 1.0
    return ids, mask, hist, hmask


def build_pair(pool: str = "mean", grouped: bool = False, seed: int = 0):
    """(jax model, numpy params, port model) with shared weights."""
    jc = dataclasses.replace(JC, pool=pool)
    lora = dataclasses.replace(LORA, grouped=grouped)
    jm = jax_joint.MultiModalQwenEmbedding(QWEN, QF, jc, lora=lora)
    ids, mask, hist, hmask = joint_inputs(np.random.RandomState(seed), 1, jc)
    params = randomize_lora_b(
        jm.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask),
                jnp.asarray(hist), jnp.asarray(hmask)))
    pm = port_joint.MultiModalQwenEmbedding(QWEN, QF, jc, lora=lora)
    pm.load_state_dict(joint_state_dict_from_flax(params, QWEN, QF))
    return jm, params, pm.eval()


@pytest.mark.parametrize("pool", ["mean", "masked_mean", "last_token"])
def test_joint_pooled_output_matches_jax(pool):
    jm, params, pm = build_pair(pool=pool)
    ids, mask, hist, hmask = joint_inputs(np.random.RandomState(1), 3)
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                               jnp.asarray(hist), jnp.asarray(hmask)))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                 torch.from_numpy(hist), torch.from_numpy(hmask)).numpy()
    assert got.shape == want.shape == (3, QWEN.hidden_size)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_injection_uses_first_query_tokens():
    """Special positions carry the first ``num_query_tokens_per_item`` query
    outputs of their item; every other position keeps its token embedding."""
    _, _, pm = build_pair()
    ids, mask, hist, hmask = joint_inputs(np.random.RandomState(2), 2)
    ids_t = torch.from_numpy(ids).long()
    seen = {}
    hook = pm.base_model.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.update(kwargs), with_kwargs=True)
    with torch.no_grad():
        pm(ids_t, torch.from_numpy(mask), torch.from_numpy(hist),
           torch.from_numpy(hmask))
        q_out = pm.qformer.query_outputs(
            torch.from_numpy(hist).reshape(-1, F, FD),
            torch.from_numpy(hmask).reshape(-1, F))
        text = pm.base_model.embed(ids_t)
    hook.remove()
    k = JC.num_query_tokens_per_item
    tokens = q_out[:, :k].reshape(2, JC.num_history_items * k, -1)
    injected = seen["inputs_embeds"]
    for b in range(2):
        for pos in range(JC.max_length):
            slot = int(ids_t[b, pos]) - QWEN.vocab_size
            want = tokens[b, slot] if slot >= 0 else text[b, pos]
            assert torch.equal(injected[b, pos], want)


def test_prompt_helpers_identical():
    assert (port_joint.history_token_strings(10, 2)
            == jax_joint.history_token_strings(10, 2))
    items = {"a": {"title": "x" * 90}, "b": {"title": "Lip balm, cherry"}}
    for history in ([], ["a"], ["a", "b", "zz"]):
        assert (port_joint.construct_input_text(history, items, 3, 2)
                == jax_joint.construct_input_text(history, items, 3, 2))


def test_reference_state_dict_loads_through_the_bridge():
    """A reference-layout state_dict (as a .pth holds it) loads by composing
    ``torch_convert.convert_joint_model`` with the bridge, and gives the
    JAX model's output."""
    jm, params, _ = build_pair()
    ref_sd = export_joint_model(params["params"], QWEN, QF)
    flax_tree = convert_joint_model(ref_sd, QWEN, QF)
    pm = port_joint.MultiModalQwenEmbedding(QWEN, QF, JC, lora=LORA)
    pm.load_state_dict(joint_state_dict_from_flax(flax_tree, QWEN, QF))
    ids, mask, hist, hmask = joint_inputs(np.random.RandomState(3), 2)
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                               jnp.asarray(hist), jnp.asarray(hmask)))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                        torch.from_numpy(hist), torch.from_numpy(hmask))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def test_bridge_checks_layer_counts():
    _, params, _ = build_pair()
    with pytest.raises(ValueError, match="layers"):
        joint_state_dict_from_flax(
            params, dataclasses.replace(QWEN, num_hidden_layers=3), QF)
