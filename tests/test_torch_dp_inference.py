"""The port's data-parallel inference (one process, a replica per device)
against its one-device path and the JAX package's dp meshes, on the CPU.

* ``QFormerInference`` at dp = 2 over ``["cpu", "cpu"]``: the plain bf16
  model, the fused bf16 engine (B1-B3's plain versions) and the int8 engine
  (B4-B6's) equal dp = 1 bit for bit (every block works item by item), and
  the JAX class on a dp = 2 mesh of the virtual CPU devices
  (``tests/test_train_slice.py``) within the fused engine's bf16 gate of
  ``tests/test_torch_qformer_inference.py`` (the int8 engine within the
  same gate), the plain model at cosine 0.999 (bf16 against the JAX fp32
  model); an undersized call (5 items at batch 8, padded to 6 and trimmed);
* ``Recommender`` at dp = 2 against dp = 1: ``encode_users`` within 1e-5
  and the same ``recommend`` ids, on the float32 and the int8 catalog
  (``tests/test_serving.py``'s dp case); the batch's divisibility error;
* ``serve_cli.build_recommender`` and the sweep CLI with ``--dp 2 --device
  cpu``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_qformer_inference import (
    BF16_ENGINE_ATOL,
    CFG,
    FIELDS,
)
from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import MeshConfig as JaxMeshConfig
from unirec_tpu.inference.qformer_inference import (
    QFormerInference as JaxQFormerInference,
)
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unirec_tpu_torch.cli import generate_all_item_embeddings as sweep_cli
from unirec_tpu_torch.configs import MeshConfig
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import HashTokenizer
from unirec_tpu_torch.inference.qformer_inference import QFormerInference
from unirec_tpu_torch.parallel.mesh import make_mesh
from unirec_tpu_torch.serving.recommender import Recommender
from unirec_tpu_torch.utils.checkpoint import save_checkpoint
from unirec_tpu_torch.utils.weights import (
    init_item_qformer,
    init_joint,
    state_dict_to_flax,
)
from tests.test_torch_joint import F, FD, JC, LORA, QF, QWEN


HISTORIES = [["i0", "i1"], ["i3"], [], ["i2", "i7", "i9"], ["i4"],
             ["unknown", "i5"], ["i6", "i8"], ["i11"], ["i12", "i13", "i1"]]
CPU2 = make_mesh(MeshConfig(dp=2), ["cpu", "cpu"])


@pytest.fixture(scope="module")
def sweep_setup():
    """Seeded inputs and the port's seed-0 weights, also as the Flax tree."""
    rng = np.random.RandomState(1)
    emb = rng.randn(20, 6, 16).astype(np.float32)
    mask = (rng.rand(20, 6) > 0.2).astype(np.float32)
    mask[5] = 0.0
    emb *= mask[..., None]
    sd = init_item_qformer(CFG, torch.Generator().manual_seed(0)).state_dict()
    return {"params": state_dict_to_flax(sd)}, sd, emb, mask


def _inference(sd, **kw):
    return QFormerInference(config=CFG, params=sd, field_names=FIELDS,
                            device="cpu", batch_size=8, **kw)


@pytest.mark.parametrize("engine", ["plain", "bf16", "int8"])
def test_sweep_dp2_equals_dp1_and_jax(sweep_setup, engine):
    params, sd, emb, mask = sweep_setup
    kw = ({"use_fused": False} if engine == "plain" else
          {"use_fused": True, "precision": engine})
    one, two = _inference(sd, **kw), _inference(sd, mesh=CPU2, **kw)
    assert two.dp_size == 2 and two.shard_devices == [torch.device("cpu")] * 2
    got = two.query_tokens_from_embeddings(emb, mask)
    np.testing.assert_array_equal(got, one.query_tokens_from_embeddings(
        emb, mask))
    # an undersized call: 5 items padded to 6 over dp, trimmed to 5
    np.testing.assert_array_equal(
        two.query_tokens_from_embeddings(emb[:5], mask[:5]), got[:5])
    jax_mesh = jax_make_mesh(JaxMeshConfig(dp=2, tp=1),
                             jax.devices()[:2])
    jkw = dict(kw, use_fused=engine != "plain")
    if engine == "plain":
        want = np.asarray(JaxItemQFormer(CFG).apply(
            params, jnp.asarray(emb), jnp.asarray(mask))["query_outputs"])
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() > 0.999  # bf16 against the fp32 model
        return
    jax_inf = JaxQFormerInference(config=CFG, params=params,
                                  field_names=FIELDS, batch_size=8,
                                  mesh=jax_mesh, **jkw)
    assert jax_inf.dp_size == 2
    want = jax_inf.query_tokens_from_embeddings(emb, mask)
    np.testing.assert_allclose(got, want, atol=BF16_ENGINE_ATOL, rtol=0)


def test_sweep_batch_must_divide_by_dp(sweep_setup):
    _, sd, _, _ = sweep_setup
    with pytest.raises(ValueError, match="batch_size 8 not divisible by "
                                         "mesh size 3"):
        _inference(sd, mesh=make_mesh(MeshConfig(dp=3), ["cpu"] * 3))


def test_sweep_cli_dp2(sweep_setup, tmp_path, capsys):
    _, sd, emb, mask = sweep_setup
    save_checkpoint(str(tmp_path / "ckpt"), sd, CFG,
                    extra={"field_names": FIELDS})
    ids = [f"item{j}" for j in range(20)]
    FieldEmbeddingCache(emb, mask, FIELDS, ids).save(str(tmp_path / "cache"))
    out = str(tmp_path / "tok.pkl")
    argv = ["--checkpoint", str(tmp_path / "ckpt"), "--cache-dir",
            str(tmp_path / "cache"), "--device", "cpu", "--output", out,
            "--batch-size", "7"]
    assert sweep_cli.main(argv + ["--dp", "2"]) == 0
    assert "sweep sharded over 2 devices (batch 8)" in capsys.readouterr().out
    with open(out, "rb") as f:
        tokens = pickle.load(f)
    want = _inference(sd).query_tokens_from_embeddings(emb, mask)
    assert sorted(tokens) == sorted(ids)
    for j, iid in enumerate(ids):
        np.testing.assert_array_equal(tokens[iid], want[j])


@pytest.fixture(scope="module")
def serving():
    """A 20-item field cache, catalog and item dict, and the seed-0 tiny
    joint model with a random ``lora_b`` (``tests/test_torch_serving.py``'s
    shapes)."""
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
    model = init_joint(QWEN, QF, JC, LORA, torch.Generator().manual_seed(0),
                       lora_b_std=0.02).eval()
    return cache, catalog, item_dict, model


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_recommender_dp2_equals_dp1(serving, quantize):
    cache, catalog, item_dict, port_model = serving
    tok = HashTokenizer(QWEN.vocab_size, JC.num_history_items,
                        JC.num_query_tokens_per_item)
    recs = [Recommender(port_model, tok, dict(item_dict), cache, catalog,
                        batch_size=4, quantize_catalog=quantize, mesh=mesh)
            for mesh in (None, CPU2)]
    assert recs[1].dp_size == 2 and len(recs[1]._shards) == 2
    histories = HISTORIES
    one, two = (r.encode_users(histories) for r in recs)
    np.testing.assert_allclose(two, one, atol=1e-5, rtol=0)
    want, got = (r.recommend(histories, k=5) for r in recs)
    for w, g in zip(want, got):
        assert [r.item_id for r in g] == [r.item_id for r in w]
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], atol=1e-5, rtol=0)
    handle = recs[1].recommend_submit(histories[:3], k=2)
    assert [[r.item_id for r in x] for x in recs[1].recommend_finalize(
        handle)] == [[r.item_id for r in x[:2]] for x in want[:3]]
    with pytest.raises(ValueError, match="not divisible by dp mesh size 3"):
        Recommender(port_model, tok, dict(item_dict), cache, catalog,
                    batch_size=4, mesh=make_mesh(MeshConfig(dp=3),
                                                 ["cpu"] * 3))


def test_serve_cli_dp2(serving, tmp_path):
    import json

    from unirec_tpu_torch.cli import serve_cli

    cache, catalog, item_dict, port_model = serving
    qf_sd = {k[len("qformer."):]: v for k, v in
             port_model.state_dict().items() if k.startswith("qformer.")}
    save_checkpoint(str(tmp_path / "iq"), qf_sd, QF,
                    extra={"field_names": list(cache.fields)})
    cache.save(str(tmp_path / "cache"))
    (tmp_path / "items.json").write_text(json.dumps(item_dict))
    (tmp_path / "catalog.json").write_text(json.dumps(catalog))
    base = ["--qformer-checkpoint", str(tmp_path / "iq"),
            "--cache-dir", str(tmp_path / "cache"),
            "--item-dict", str(tmp_path / "items.json"),
            "--catalog", str(tmp_path / "catalog.json"), "--tiny",
            "--device", "cpu", "--batch-size", "4", "--max-length", "64"]
    one, two = (serve_cli.build_recommender(serve_cli.parse_args(base + x))
                for x in ([], ["--dp", "2"]))
    assert two.dp_size == 2 and one.dp_size == 1
    np.testing.assert_allclose(two.encode_users(HISTORIES),
                               one.encode_users(HISTORIES), atol=1e-5, rtol=0)
    assert ([[r.item_id for r in x] for x in two.recommend(HISTORIES, k=3)]
            == [[r.item_id for r in x] for x in one.recommend(HISTORIES,
                                                              k=3)])
