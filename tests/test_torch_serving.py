"""Port parity: the serving path, unirec_tpu_torch vs unirec_tpu on the CPU.

The same fixture (20 items, hash tokenizer, tiny joint model with LoRA and a
randomised ``lora_b``) and the same weights go to both ``Recommender``s:
item ids must be identical and scores within 1e-5.  Also an HTTP round trip
through the port's ``make_server``, and prompt ids identical to the JAX
package's tokenizer and prompt cache.  Int8 serving runs on a lane-aligned
tiny model (hidden 128, one head of 128, batch 8 x L 64 = 512 rows, so the
fused guards pass) against the JAX ``Recommender(precision="int8")``, and
``serve_cli.build_recommender`` with ``--tiny`` on the CPU.
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

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    tiny_qwen3_config,
)
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


def test_bulk_encode_users_bounds_device_chunks(recommenders, monkeypatch):
    """A bulk encode_users call keeps at most MAX_IN_FLIGHT (8) embedding
    chunks alive over 20 batches, draining the older ones to host copies,
    and returns what the on-device chunks hold, bit for bit."""
    import weakref

    _, prec = recommenders
    histories = [HISTORIES[i % len(HISTORIES)] for i in range(20 * 4)]
    kept = [emb[:n].float().cpu().numpy()
            for emb, n in prec._encode_user_chunks(histories)]
    live, peak = [], [0]
    forward = prec._forward_rows

    def counting(*args):
        out = forward(*args)
        live.append(weakref.ref(out))
        peak[0] = max(peak[0], sum(r() is not None for r in live))
        return out

    monkeypatch.setattr(prec, "_forward_rows", counting)
    got = prec.encode_users(histories)
    assert len(live) == 20 and peak[0] == prec.MAX_IN_FLIGHT == 8
    np.testing.assert_array_equal(got, np.concatenate(kept))
    # recommend keeps its chunks on the device for retrieval
    chunks = prec._encode_user_chunks(histories[:8])
    assert all(isinstance(emb, torch.Tensor) for emb, _ in chunks)


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
    """int8 is accepted (the W8A8 forward is ported); any other precision is
    refused, and the caller's model is left as it was."""
    cache, catalog, item_dict, _, _ = fixture_data
    pm = port_joint.MultiModalQwenEmbedding(QWEN, QF, JC, lora=LORA)
    tok = HashTokenizer(QWEN.vocab_size, JC.num_history_items,
                        JC.num_query_tokens_per_item)
    rec = Recommender(pm, tok, item_dict, cache, catalog, precision="int8")
    assert rec.precision == "int8" and rec.model is not pm
    assert pm.base_model.layers[0].self_attn.q_proj.weight_q is None
    with pytest.raises(ValueError, match="bf16 or int8"):
        Recommender(pm, tok, item_dict, cache, catalog, precision="fp4")


# -- int8 serving: a lane-aligned model at 8 x 64 = 512 rows ---------------------

QWEN8 = tiny_qwen3_config(
    hidden_size=128, intermediate_size=256, num_attention_heads=1,
    num_key_value_heads=1, head_dim=128, max_position_embeddings=64,
    flash_attention=False)
QF8 = ItemQFormerConfig(
    hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
    intermediate_size=64, num_query_tokens=2, field_embedding_dim=FD,
    num_fields=F, dropout=0.0)
JC8 = JointModelConfig(num_history_items=2, num_query_tokens_per_item=2,
                       max_length=64)
HISTORIES8 = [["i0", "i1"], ["i3"], [], ["i2", "i5"], ["i7", "i4"]]
INT8_MODES = {"live": {}, "merged": dict(merge_lora=True),
              "merged_unfused": dict(merge_lora=True, fused_blocks=False)}


@pytest.fixture(scope="module")
def int8_data():
    rng = np.random.RandomState(11)
    n = 12
    item_ids = [f"i{j}" for j in range(n)]
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, F, FD).astype(np.float32),
        masks=np.ones((n, F), np.float32), fields=["a", "b", "c"],
        item_ids=item_ids)
    catalog = {iid: rng.randn(QWEN8.hidden_size).astype(np.float32).tolist()
               for iid in item_ids}
    item_dict = {iid: {"title": f"Item {iid}"} for iid in item_ids}
    jm = jax_joint.MultiModalQwenEmbedding(QWEN8, QF8, JC8, lora=LORA)
    params = randomize_lora_b(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, JC8.max_length), jnp.int32),
        jnp.ones((1, JC8.max_length)),
        jnp.zeros((1, JC8.num_history_items, F, FD)),
        jnp.ones((1, JC8.num_history_items, F))))
    args = (QWEN8.vocab_size, JC8.num_history_items,
            JC8.num_query_tokens_per_item)
    pm = port_joint.MultiModalQwenEmbedding(QWEN8, QF8, JC8, lora=LORA)
    pm.load_state_dict(joint_state_dict_from_flax(params, QWEN8, QF8))
    return (cache, catalog, item_dict, jm, params, JaxHashTokenizer(*args),
            pm, HashTokenizer(*args))


@pytest.mark.parametrize("mode", list(INT8_MODES))
def test_int8_recommender_matches_jax(int8_data, mode, monkeypatch):
    """precision="int8" with the adapters live, merged (fused blocks B9a and
    B9b), and merged with fused_blocks=False, against the JAX recommender
    on the same weights: user-embedding cosine >= 0.9999 (the per-projection
    path quantizes by division and the sums between projections run in
    another order, so a code can move by one), the same top-5 ids, and the
    caller's model untouched."""
    from unirec_tpu_torch.models import qwen3 as pq

    cache, catalog, item_dict, jm, params, jtok, pm, ptok = int8_data
    kw = dict(batch_size=8, precision="int8", **INT8_MODES[mode])
    jrec = JaxRecommender(jm, {"params": params["params"]}, jtok,
                          dict(item_dict), cache, catalog, **kw)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    prec = Recommender(pm, ptok, dict(item_dict), cache, catalog, **kw)
    assert (prec.model.qwen_config.fused_int8_inference
            == jrec.model.qwen_config.fused_int8_inference
            == (mode == "merged"))
    assert (prec.model.lora is None) == (mode != "live")
    calls = []
    for name in ("qkv_int8", "swiglu_mlp_int8", "int8_linear_ste"):
        fn = getattr(pq, name)
        monkeypatch.setattr(pq, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    got = prec.encode_users(HISTORIES8)
    want = np.asarray(jrec.encode_users(HISTORIES8), np.float32)
    n_layers = QWEN8.num_hidden_layers
    assert (calls.count("qkv_int8"), calls.count("swiglu_mlp_int8"),
            calls.count("int8_linear_ste")) == (
        (n_layers, n_layers, n_layers) if mode == "merged"
        else (0, 0, 7 * n_layers))
    assert ((got * want).sum(-1) >= 0.9999).all(), (got * want).sum(-1)
    assert [[r.item_id for r in row]
            for row in prec.recommend(HISTORIES8, k=5)] == [
        [r.item_id for r in row] for row in jrec.recommend(HISTORIES8, k=5)]
    assert pm.lora is LORA and not pm.qwen_config.fused_int8_inference
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_serve_cli_build_recommender_tiny(tmp_path):
    """serve_cli.build_recommender with --tiny on the CPU: a seeded joint
    model around a saved Item Q-Former checkpoint, in bf16 precision and in
    int8 with the adapters merged (8 x 64 = 512 rows: the fused blocks);
    a saved joint checkpoint reloads to the same embeddings; --dp is
    refused, and an --hf-path that holds no tokenizer raises."""
    from unirec_tpu_torch.cli import serve_cli
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint
    from unirec_tpu_torch.utils.weights import init_item_qformer

    rng = np.random.RandomState(12)
    n = 10
    item_ids = [f"i{j}" for j in range(n)]
    qf = init_item_qformer(QF8, torch.Generator().manual_seed(1))
    save_checkpoint(str(tmp_path / "iq"), qf, QF8,
                    extra={"field_names": ["a", "b", "c"]})
    FieldEmbeddingCache(rng.randn(n, F, FD).astype(np.float32),
                        np.ones((n, F), np.float32), ["a", "b", "c"],
                        item_ids).save(str(tmp_path / "cache"))
    (tmp_path / "items.json").write_text(json.dumps(
        {i: {"title": f"Item {i}"} for i in item_ids}))
    (tmp_path / "catalog.json").write_text(json.dumps(
        {i: rng.randn(QF8.hidden_size).tolist() for i in item_ids}))
    base = ["--qformer-checkpoint", str(tmp_path / "iq"),
            "--cache-dir", str(tmp_path / "cache"),
            "--item-dict", str(tmp_path / "items.json"),
            "--catalog", str(tmp_path / "catalog.json"),
            "--tiny", "--max-length", "64", "--prewarm", "--device", "cpu"]
    hists = [["i0", "i1"], ["i3"], []]
    bf16 = serve_cli.build_recommender(serve_cli.parse_args(base))
    int8 = serve_cli.build_recommender(serve_cli.parse_args(
        base + ["--precision", "int8", "--merge-lora"]))
    assert int8.model.qwen_config.fused_int8_inference
    assert int8.model.base_model.layers[0].mlp.gate_up_q is not None
    u_bf, u_8 = bf16.encode_users(hists), int8.encode_users(hists)
    assert ((u_bf * u_8).sum(-1) >= 0.98).all()  # the int8 quality class
    recs = int8.recommend(hists, k=3)
    assert all(len(r) == 3 for r in recs)

    save_checkpoint(str(tmp_path / "joint"), bf16.model)
    again = serve_cli.build_recommender(serve_cli.parse_args(
        base + ["--checkpoint", str(tmp_path / "joint")]))
    np.testing.assert_array_equal(again.encode_users(hists), u_bf)
    # --dp is taken (tests/test_torch_dp_inference.py); a batch that does
    # not split over it is refused with the JAX class's error
    with pytest.raises(ValueError, match="not divisible by dp mesh size 3"):
        serve_cli.build_recommender(serve_cli.parse_args(base + ["--dp", "3"]))
    with pytest.raises(ValueError, match="tokenizer"):
        serve_cli.build_recommender(serve_cli.parse_args(
            base + ["--hf-path", str(tmp_path)]))
