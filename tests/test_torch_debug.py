"""Port parity: attention-map capture, the Item Q-Former's modality table,
and the debugging and profiling helpers (``utils/debug.py``,
``utils/profiling.annotate`` / ``device_memory_stats``).

Attention maps: the port's ``capture_attention_maps`` and the JAX one on a
Q-Former (hidden 32, 4 layers, cross-attention on layers 0 and 2, 8
queries, 6 memory rows with masked fields) and on an ``ItemQFormer`` whose
config asks for the fast path, with weights bridged from Flax ``init``:
the same module paths in the same order, each map within 1e-5 (max|d| /
max|ref|), masked fields at exactly zero, rows summing to 1, outputs
unperturbed.  The modality table: ``ItemQFormer`` with ``modality_ids`` held
to the JAX model within 1e-5, fp32.  Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.configs import ItemQFormerConfig as JaxItemConfig
from unirec_tpu.configs import QFormerConfig as JaxQFormerConfig
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.models.qformer import QFormerModel as JaxQFormerModel
from unirec_tpu.utils.debug import capture_attention_maps as jax_capture
from unirec_tpu_torch.configs import ItemQFormerConfig, QFormerConfig
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.models.qformer import QFormerModel
from unirec_tpu_torch.utils import debug, profiling
from unirec_tpu_torch.utils.weights import flax_to_state_dict

TOL = 1e-5
QF = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
          intermediate_size=64, hidden_dropout_prob=0.0,
          attention_probs_dropout_prob=0.0, encoder_width=24, query_length=8,
          vocab_size=50, max_position_embeddings=32)
ITEM = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, num_query_tokens=4, field_embedding_dim=16,
            num_fields=3, dropout=0.0)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max()
                 / np.abs(want).max())


def test_attention_maps_match_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(3, 8, 32).astype(np.float32)
    mem = rng.randn(3, 6, 24).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 0, 1, 0, 1],
                     [1, 0, 0, 0, 0, 0]], np.float32)
    jm = JaxQFormerModel(JaxQFormerConfig(**QF))
    params = jm.init(jax.random.PRNGKey(0), query_embeds=jnp.asarray(q),
                     encoder_hidden_states=jnp.asarray(mem))
    pm = QFormerModel(QFormerConfig(**QF, flash_training=True))
    pm.load_state_dict(flax_to_state_dict(params))
    want_out, want = jax_capture(jm, params, query_embeds=jnp.asarray(q),
                                 encoder_hidden_states=jnp.asarray(mem),
                                 encoder_attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        out, maps = debug.capture_attention_maps(
            pm, torch.from_numpy(q), encoder_hidden_states=torch.from_numpy(mem),
            encoder_attention_mask=torch.from_numpy(mask))
    assert list(maps) == list(want)
    assert len(maps) == 6  # 4 self + 2 cross
    assert _rel(out, want_out) <= TOL
    for key, probs in maps.items():
        assert _rel(probs, want[key]) <= TOL, key
    cross = maps["encoder/layer_2/crossattention"]
    assert cross.shape == (3, 4, 8, 6)
    assert bool((cross[1, :, :, 2] == 0).all())
    # the configs are restored, and nothing stays captured
    assert pm.config.flash_training and all(
        m.captured_probs is None for m in pm.modules()
        if hasattr(m, "captured_probs"))


def test_capture_on_item_qformer_wrapper_with_fast_config():
    cfg = dict(ITEM, fast_attention=True)
    jm = JaxItemQFormer(JaxItemConfig(**cfg))
    rng = np.random.RandomState(1)
    fields = rng.randn(2, 3, 16).astype(np.float32)
    mask = np.array([[1, 1, 1], [1, 0, 1]], np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(fields),
                     jnp.asarray(mask))
    pm = ItemQFormer(ItemQFormerConfig(**cfg))
    pm.load_state_dict(flax_to_state_dict(params))
    _, want = jax_capture(jm, params, jnp.asarray(fields), jnp.asarray(mask))
    with torch.no_grad():
        out, maps = debug.capture_attention_maps(
            pm, torch.from_numpy(fields), torch.from_numpy(mask))
    assert out["query_outputs"].shape == (2, 4, 32)
    assert list(maps) == list(want)
    probs = maps["qformer/encoder/layer_0/crossattention"]
    assert _rel(probs, want["qformer/encoder/layer_0/crossattention"]) <= TOL
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    assert bool((probs[1, :, :, 1] == 0).all())


def test_modality_table_matches_jax():
    cfg = dict(ITEM, use_field_type_embeddings=True)
    jm = JaxItemQFormer(JaxItemConfig(**cfg))
    rng = np.random.RandomState(2)
    fields = rng.randn(4, 3, 16).astype(np.float32)
    mask = np.array([[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0]], np.float32)
    modality = np.array([0, 3, 1], np.int32)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(fields),
                     jnp.asarray(mask), modality_ids=jnp.asarray(modality))
    assert "modality_id_embeddings" in params["params"]
    pm = ItemQFormer(ItemQFormerConfig(**cfg), modality_table=True)
    pm.load_state_dict(flax_to_state_dict(params))
    want = jm.apply(params, jnp.asarray(fields), jnp.asarray(mask),
                    modality_ids=jnp.asarray(modality))
    with torch.no_grad():
        got = pm(torch.from_numpy(fields), torch.from_numpy(mask),
                 torch.from_numpy(modality).long())
    for key in ("query_outputs", "item_representation",
                "reconstructed_fields"):
        assert _rel(got[key], want[key]) <= TOL, key
    # without the table, modality ids are refused rather than ignored
    plain = ItemQFormer(ItemQFormerConfig(**cfg))
    with pytest.raises(ValueError, match="modality_table"):
        plain(torch.from_numpy(fields), torch.from_numpy(mask),
              torch.from_numpy(modality).long())


def test_nan_checks_raise_on_a_nan_gradient():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with debug.nan_checks():
            torch.sqrt(x).sum().backward()
    with debug.eager_mode():
        assert torch.sqrt(torch.tensor(4.0)) == 2.0


def test_annotate_names_a_span_and_memory_stats_need_a_card():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("port.phase"):
            torch.ones(4).sum()
    assert any(e.name == "port.phase" for e in prof.events())
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
