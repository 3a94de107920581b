"""Port parity: the Q-Former's text branch, relative positions, pooler and
LM heads, and the KV-cached decoders, unirec_tpu_torch vs unirec_tpu on the
CPU in fp32.

Tiny configs (hidden 32, 2 layers, 2 heads, FFN 64, memory width 24, 4
queries, vocab 50, 32 positions, dropout off).  Flax ``init`` makes the
weights; ``utils/weights.flax_to_state_dict`` carries them across (the
``nn.Embed`` tables keep their layout), loaded strictly, so the port builds
exactly the tree each JAX module creates.  Inputs are made with numpy from a
seed.  Activations, pooled outputs, logits and losses are held within 1e-5
of JAX as max|d| / max|ref|; generated ids and beam scores must be equal
(scores within 1e-5).  As ``tests/test_extras.py`` holds the JAX decoders:
the KV-cached greedy ids equal ``greedy_generate``'s, one beam equals
greedy, and the beam's score equals its teacher-forced re-score.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.configs import QFormerConfig as JaxQFormerConfig
from unirec_tpu.models import qformer as jq
from unirec_tpu.models import qformer_decode as jd
from unirec_tpu.ops.attention import make_causal_mask as jax_causal_mask
from unirec_tpu_torch.configs import QFormerConfig
from unirec_tpu_torch.models import qformer as pq
from unirec_tpu_torch.models import qformer_decode as pd
from unirec_tpu_torch.ops.attention import make_causal_mask
from unirec_tpu_torch.utils.weights import flax_to_state_dict

TOL = 1e-5
SIZES = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=64, encoder_width=24, query_length=4,
             vocab_size=50, max_position_embeddings=32,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
POSITIONS = ("absolute", "relative_key", "relative_key_query")
B, K, T, F = 3, 4, 7, 5


def _cfgs(position="absolute"):
    return (JaxQFormerConfig(**SIZES, position_embedding_type=position),
            QFormerConfig(**SIZES, position_embedding_type=position))


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 50, size=(B, T)).astype(np.int32)
    query = rng.randn(B, K, 32).astype(np.float32)
    mem = rng.randn(B, F, 24).astype(np.float32)
    text_mask = np.ones((B, T), np.float32)
    text_mask[1, 5:] = 0.0
    mem_mask = np.ones((B, F), np.float32)
    mem_mask[2, 2:] = 0.0
    return ids, query, mem, text_mask, mem_mask


def _load(port, params):
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    return port.eval()


def test_make_causal_mask_matches_jax():
    mask = np.ones((2, 3 + 5), np.float32)
    mask[1, 6:] = 0.0
    want = jax_causal_mask(jnp.asarray(mask), 5, query_length=3)
    got = make_causal_mask(torch.from_numpy(mask), 5, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("position", POSITIONS)
def test_text_only_model_with_pooler_matches_jax(position):
    jcfg, pcfg = _cfgs(position)
    ids, _, _, text_mask, _ = _inputs(1)
    jm = jq.QFormerModel(jcfg, add_pooling_layer=True)
    params = jm.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids))
    pm = _load(pq.QFormerModel(pcfg, with_text=True, with_queries=False,
                               add_pooling_layer=True), params)
    want_h, want_p = jm.apply(params, input_ids=jnp.asarray(ids),
                              attention_mask=jnp.asarray(text_mask))
    with torch.no_grad():
        got_h, got_p = pm(input_ids=torch.from_numpy(ids).long(),
                          attention_mask=torch.from_numpy(text_mask))
    assert got_h.shape == (B, T, 32)
    assert _rel(got_h, want_h) <= TOL and _rel(got_p, want_p) <= TOL


@pytest.mark.parametrize("is_decoder", [False, True])
@pytest.mark.parametrize("position", POSITIONS)
def test_query_and_text_forward_matches_jax(position, is_decoder):
    jcfg, pcfg = _cfgs(position)
    ids, query, mem, text_mask, mem_mask = _inputs(2)
    full_mask = np.concatenate([np.ones((B, K), np.float32), text_mask], 1)
    jm = jq.QFormerModel(jcfg)
    params = jm.init(jax.random.PRNGKey(1), input_ids=jnp.asarray(ids),
                     query_embeds=jnp.asarray(query),
                     encoder_hidden_states=jnp.asarray(mem))
    pm = _load(pq.QFormerModel(pcfg, with_text=True), params)
    want = jm.apply(params, input_ids=jnp.asarray(ids),
                    attention_mask=jnp.asarray(full_mask),
                    query_embeds=jnp.asarray(query),
                    encoder_hidden_states=jnp.asarray(mem),
                    encoder_attention_mask=jnp.asarray(mem_mask),
                    is_decoder=is_decoder)
    with torch.no_grad():
        got = pm(torch.from_numpy(query), torch.from_numpy(full_mask),
                 torch.from_numpy(mem), torch.from_numpy(mem_mask),
                 input_ids=torch.from_numpy(ids).long(),
                 is_decoder=is_decoder)
    assert got.shape == (B, K + T, 32)
    assert _rel(got, want) <= TOL


@functools.lru_cache(maxsize=None)
def _lm(position="absolute", seed=3):
    """(JAX config, JAX LM, its params, the port's LM on them), made once a
    (position type, seed)."""
    jcfg, pcfg = _cfgs(position)
    ids, query, mem, _, _ = _inputs(seed)
    jm = jq.QFormerLMHeadModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed), input_ids=jnp.asarray(ids),
                     query_embeds=jnp.asarray(query),
                     encoder_hidden_states=jnp.asarray(mem))
    return jcfg, jm, params, _load(pq.QFormerLMHeadModel(pcfg), params)


@pytest.mark.parametrize("position", POSITIONS)
def test_lm_head_logits_and_loss_match_jax(position):
    _, jm, params, pm = _lm(position)
    ids, query, mem, text_mask, mem_mask = _inputs(4)
    full_mask = np.concatenate([np.ones((B, K), np.float32), text_mask], 1)
    labels = ids.copy()
    labels[0, 3] = -100
    labels[1, 5:] = -100
    want_logits, want_loss = jm.apply(
        params, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(full_mask),
        query_embeds=jnp.asarray(query),
        encoder_hidden_states=jnp.asarray(mem),
        encoder_attention_mask=jnp.asarray(mem_mask),
        labels=jnp.asarray(labels))
    with torch.no_grad():
        logits, loss = pm(torch.from_numpy(ids).long(),
                          torch.from_numpy(full_mask), torch.from_numpy(query),
                          torch.from_numpy(mem), torch.from_numpy(mem_mask),
                          labels=torch.from_numpy(labels).long())
    assert logits.shape == (B, T, 50)
    assert _rel(logits, want_logits) <= TOL
    assert abs(float(loss) - float(want_loss)) <= TOL * abs(float(want_loss))


def test_causal_lm_loss_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(3, 6, 11).astype(np.float32)
    labels = rng.randint(0, 11, size=(3, 6))
    labels[0, 2] = labels[2, :] = -100
    want = jq.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = pq.causal_lm_loss(torch.from_numpy(logits),
                            torch.from_numpy(labels).long())
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))


def test_masked_lm_matches_jax():
    jcfg, pcfg = _cfgs()
    ids, query, mem, text_mask, mem_mask = _inputs(6)
    full_mask = np.concatenate([np.ones((B, K), np.float32), text_mask], 1)
    labels = np.full_like(ids, -100)
    labels[:, 2] = ids[:, 2]
    labels[0, 4] = ids[0, 4]
    jm = jq.QFormerForMaskedLM(jcfg)
    params = jm.init(jax.random.PRNGKey(6), input_ids=jnp.asarray(ids),
                     query_embeds=jnp.asarray(query),
                     encoder_hidden_states=jnp.asarray(mem))
    pm = _load(pq.QFormerForMaskedLM(pcfg), params)
    want_logits, want_loss = jm.apply(
        params, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(full_mask), query_embeds=jnp.asarray(query),
        encoder_hidden_states=jnp.asarray(mem),
        encoder_attention_mask=jnp.asarray(mem_mask),
        labels=jnp.asarray(labels))
    with torch.no_grad():
        logits, loss = pm(torch.from_numpy(ids).long(),
                          torch.from_numpy(full_mask), torch.from_numpy(query),
                          torch.from_numpy(mem), torch.from_numpy(mem_mask),
                          labels=torch.from_numpy(labels).long())
    assert _rel(logits, want_logits) <= TOL
    assert abs(float(loss) - float(want_loss)) <= TOL * abs(float(want_loss))


@pytest.mark.parametrize("masked", [False, True])
def test_greedy_and_kv_cached_greedy_match_jax(masked):
    jcfg, jm, params, pm = _lm(seed=7)
    _, query, mem, _, _ = _inputs(7)
    emask = np.array([[1, 1, 0, 1, 1], [1, 0, 0, 0, 0], [1, 1, 1, 1, 1]],
                     np.float32) if masked else None
    jargs = (jnp.asarray(query), jnp.asarray(mem),
             None if emask is None else jnp.asarray(emask))
    pargs = (torch.from_numpy(query), torch.from_numpy(mem),
             None if emask is None else torch.from_numpy(emask))
    kw = dict(bos_token_id=1, eos_token_id=2, max_new_tokens=8)
    want = np.asarray(jq.greedy_generate(jm, params, *jargs, **kw))
    want_kv = np.asarray(jd.kv_cached_greedy_generate(params, jcfg, *jargs,
                                                      **kw))
    np.testing.assert_array_equal(want, want_kv)
    got = pq.greedy_generate(pm, *pargs, **kw)
    got_kv = pd.kv_cached_greedy_generate(pm, *pargs, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_kv.numpy(), want)


@pytest.mark.parametrize("beams", [1, 4])
def test_kv_cached_beam_matches_jax(beams):
    jcfg, jm, params, pm = _lm(seed=7)
    _, query, mem, _, _ = _inputs(8)
    kw = dict(bos_token_id=1, eos_token_id=2, max_new_tokens=8)
    want_ids, want_score = jd.kv_cached_beam_generate(
        params, jcfg, jnp.asarray(query), jnp.asarray(mem), num_beams=beams,
        **kw)
    ids, score = pd.kv_cached_beam_generate(
        pm, torch.from_numpy(query), torch.from_numpy(mem), num_beams=beams,
        **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                               rtol=TOL, atol=TOL)
    if beams == 1:
        greedy = pd.kv_cached_greedy_generate(pm, torch.from_numpy(query),
                                              torch.from_numpy(mem), **kw)
        np.testing.assert_array_equal(ids.numpy(), greedy.numpy())
        return
    # the beam's score is its teacher-forced, length-normalised log-prob
    full_mask = torch.ones(B, K + ids.shape[1])
    with torch.no_grad():
        logp = torch.log_softmax(pm(ids, full_mask, torch.from_numpy(query),
                                    torch.from_numpy(mem)).float(), -1)
    for row in range(B):
        total, t = 0.0, 0
        while t + 1 < ids.shape[1]:
            tok = int(ids[row, t + 1])
            total += float(logp[row, t, tok])
            t += 1
            if tok == 2:
                break
        assert abs(total / (t + 1) - float(score[row])) <= 1e-4


def test_dropout_stream_reaches_the_text_ffn():
    """A training forward draws at the text FFN's site too: two streams
    with other seeds give other outputs, one stream twice the same."""
    _, pcfg = _cfgs()
    pcfg = dataclasses.replace(pcfg, hidden_dropout_prob=0.3)
    ids, query, mem, _, _ = _inputs(9)
    torch.manual_seed(0)
    pm = pq.QFormerModel(pcfg, with_text=True)
    for p in pm.parameters():
        torch.nn.init.normal_(p, std=0.1)
    from unirec_tpu_torch.ops.dropout import DropoutStream

    def run(seed):
        with torch.no_grad():
            return pm(torch.from_numpy(query), None, torch.from_numpy(mem),
                      dropout=DropoutStream(seed, 0),
                      input_ids=torch.from_numpy(ids).long())[:, K:]
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
