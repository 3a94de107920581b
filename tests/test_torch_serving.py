"""Port parity: the serving path, unirec_tpu_torch vs unirec_tpu on the CPU.

The same fixture (20 items, hash tokenizer, tiny joint model with LoRA and a
randomised ``lora_b``) and the same weights go to both ``Recommender``s:
item ids must be identical and scores within 1e-5.  Also an HTTP round trip
through the port's ``make_server``, and prompt ids identical to the JAX
package's tokenizer and prompt cache.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.data.cache import FieldEmbeddingCache
from unirec_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from unirec_tpu.models import joint as jax_joint
from unirec_tpu.serving.prompt_cache import CachedPromptEncoder
from unirec_tpu.serving.recommender import Recommender as JaxRecommender
from unirec_tpu_torch.data.tokenizer import HashTokenizer
from unirec_tpu_torch.models import joint as port_joint
from unirec_tpu_torch.serving.recommender import Recommender
from unirec_tpu_torch.serving.server import make_server
from unirec_tpu_torch.utils.weights import joint_state_dict_from_flax
from tests.test_torch_joint import F, FD, JC, LORA, QF, QWEN, randomize_lora_b

HISTORIES = [["i0", "i1"], ["i3"], [], ["i2", "i7", "i9"], ["i4"],
             ["unknown", "i5"]]


@pytest.fixture(scope="module")
def fixture_data():
    rng = np.random.RandomState(0)
    n = 20
    item_ids = [f"i{j}" for j in range(n)]
    masks = np.ones((n, F), np.float32)
    masks[::3, 1] = 0.0
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, F, FD).astype(np.float32), masks=masks,
        fields=["a", "b", "c"], item_ids=item_ids)
    catalog = {iid: rng.randn(QWEN.hidden_size).astype(np.float32).tolist()
               for iid in item_ids}
    item_dict = {iid: {"title": f"Item {iid} title"} for iid in item_ids}
    jm = jax_joint.MultiModalQwenEmbedding(QWEN, QF, JC, lora=LORA)
    params = randomize_lora_b(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, JC.max_length), jnp.int32),
        jnp.ones((1, JC.max_length)),
        jnp.zeros((1, JC.num_history_items, F, FD)),
        jnp.ones((1, JC.num_history_items, F))))
    return cache, catalog, item_dict, jm, params


@pytest.fixture(scope="module")
def recommenders(fixture_data):
    cache, catalog, item_dict, jm, params = fixture_data
    jtok = JaxHashTokenizer(QWEN.vocab_size, JC.num_history_items,
                            JC.num_query_tokens_per_item)
    jrec = JaxRecommender(jm, {"params": params["params"]}, jtok,
                          dict(item_dict), cache, catalog, batch_size=4)
    pm = port_joint.MultiModalQwenEmbedding(QWEN, QF, JC, lora=LORA)
    pm.load_state_dict(joint_state_dict_from_flax(params, QWEN, QF))
    ptok = HashTokenizer(QWEN.vocab_size, JC.num_history_items,
                         JC.num_query_tokens_per_item)
    prec = Recommender(pm, ptok, dict(item_dict), cache, catalog,
                       batch_size=4)
    return jrec, prec


def test_recommend_matches_jax(recommenders):
    jrec, prec = recommenders
    want = jrec.recommend(HISTORIES, k=5)
    got = prec.recommend(HISTORIES, k=5)
    assert len(got) == len(HISTORIES)
    for w, g, h in zip(want, got, HISTORIES):
        assert [r.item_id for r in g] == [r.item_id for r in w]
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], atol=1e-5, rtol=0)
        assert len(g) == 5 and not {r.item_id for r in g} & set(h)


def test_recommend_quantized_catalog_matches_jax(fixture_data, recommenders):
    """quantize_catalog=True on both sides: ranking over the int8 catalog
    (B11's plain path here) gives the JAX recommender's ids and scores."""
    cache, catalog, item_dict, jm, params = fixture_data
    jtok = JaxHashTokenizer(QWEN.vocab_size, JC.num_history_items,
                            JC.num_query_tokens_per_item)
    jrec = JaxRecommender(jm, {"params": params["params"]}, jtok,
                          dict(item_dict), cache, catalog, batch_size=4,
                          quantize_catalog=True)
    _, prec = recommenders
    qrec = Recommender(prec.model, prec.tokenizer, dict(item_dict), cache,
                       catalog, batch_size=4, quantize_catalog=True)
    assert qrec.quantized and qrec._catalog_q.dtype == torch.int8
    np.testing.assert_array_equal(qrec._catalog_q.numpy(),
                                  np.asarray(jrec._catalog_q))
    want = jrec.recommend(HISTORIES, k=5)
    got = qrec.recommend(HISTORIES, k=5)
    for w, g, h in zip(want, got, HISTORIES):
        assert [r.item_id for r in g] == [r.item_id for r in w]
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], atol=1e-5, rtol=0)
        assert len(g) == 5 and not {r.item_id for r in g} & set(h)


def test_encode_users_matches_jax(recommenders):
    jrec, prec = recommenders
    want = jrec.encode_users(HISTORIES)
    got = prec.encode_users(HISTORIES)
    assert got.shape == (len(HISTORIES), QWEN.hidden_size)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_prompt_ids_identical(fixture_data):
    _, _, item_dict, _, _ = fixture_data
    items = dict(item_dict, long={"title": "Serum " * 30})
    args = (QWEN.vocab_size, JC.num_history_items, JC.num_query_tokens_per_item)
    ptok, jtok = HashTokenizer(*args), JaxHashTokenizer(*args)
    cached = CachedPromptEncoder(jtok, dict(items), JC.num_history_items,
                                 JC.num_query_tokens_per_item)
    for history in ([], ["i1"], ["long", "i2"], ["i3", "nope", "i4"]):
        h = history[-JC.num_history_items:]
        ids, mask = ptok.encode(
            port_joint.construct_input_text(h, items, JC.num_history_items,
                                            JC.num_query_tokens_per_item),
            JC.max_length)
        want_ids, want_mask = jtok.encode(
            jax_joint.construct_input_text(h, items, JC.num_history_items,
                                           JC.num_query_tokens_per_item),
            JC.max_length)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)
        c_ids, c_mask = cached.encode(history, JC.max_length)
        np.testing.assert_array_equal(ids, c_ids)
        np.testing.assert_array_equal(mask, c_mask)


def _post(url, payload):
    req = urllib.request.Request(url, data=payload, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_http_round_trip(recommenders):
    _, prec = recommenders
    server, batcher = make_server(prec, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["catalog_size"] == 20
        status, out = _post(f"{base}/recommend",
                            json.dumps({"history": ["i0"], "k": 3}).encode())
        assert status == 200 and len(out["items"]) == 3
        direct = prec.recommend([["i0"]], k=3)[0]
        assert [r["item_id"] for r in out["items"]] == [r.item_id
                                                       for r in direct]
        status, ranked = _post(f"{base}/score", json.dumps(
            {"history": ["i0"], "candidates": ["i5", "i6", "nope"]}).encode())
        scores = [s for _, s in ranked["ranking"]]
        assert status == 200 and scores == sorted(scores, reverse=True)
        assert {c for c, _ in ranked["ranking"]} == {"i5", "i6", "nope"}
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(f"{base}/recommend", b"{not json")
        assert bad.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as bad_k:
            _post(f"{base}/recommend", json.dumps({"k": 0}).encode())
        assert bad_k.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_recommender_refuses_int8(fixture_data):
    cache, catalog, item_dict, _, _ = fixture_data
    pm = port_joint.MultiModalQwenEmbedding(QWEN, QF, JC, lora=LORA)
    tok = HashTokenizer(QWEN.vocab_size, JC.num_history_items,
                        JC.num_query_tokens_per_item)
    with pytest.raises(ValueError, match="bf16"):
        Recommender(pm, tok, item_dict, cache, catalog, precision="int8")
