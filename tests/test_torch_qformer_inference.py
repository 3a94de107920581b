"""The port's item-token sweep around the engine: ``QFormerInference``, the
checkpoint directory, and the ``generate_all_item_embeddings`` CLI, on the CPU
at a tiny size (hidden 64, 3 layers, 4 heads, K=8, F=6 fields of width 16).

``QFormerInference(use_fused=True)`` runs the fused engine in bf16 on both
sides (the JAX blocks in interpret mode, the port's plain versions): they
round at the same points and differ only in summation order, so the tokens
agree within atol 6.3e-2, two bf16 ulps at the top of a LayerNorm output's
range (|y| < 8), after 3 layers of chained blocks.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import ItemQFormerConfig
from unirec_tpu.data.cache import FieldEmbeddingCache
from unirec_tpu.inference.qformer_inference import (
    QFormerInference as JaxQFormerInference,
)
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.utils.torch_convert import save_reference_item_qformer_checkpoint
from unirec_tpu_torch.cli import generate_all_item_embeddings as cli
from unirec_tpu_torch.configs import MeshConfig
from unirec_tpu_torch.inference.qformer_inference import (
    QFormerInference,
    is_null_value,
    run_inference,
)
from unirec_tpu_torch.parallel.mesh import make_mesh
from unirec_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    read_meta,
    restore_config,
    save_checkpoint,
)
from unirec_tpu_torch.utils.weights import item_qformer_state_dict_from_flax


CFG = ItemQFormerConfig(
    hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
    intermediate_size=128, num_query_tokens=8, field_embedding_dim=16,
    num_fields=6, dropout=0.0,
)
FIELDS = [f"f{i}" for i in range(6)]
BF16_ENGINE_ATOL = 6.3e-2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    emb = rng.randn(20, 6, 16).astype(np.float32)
    mask = (rng.rand(20, 6) > 0.2).astype(np.float32)
    mask[5] = 0.0  # an item with no field
    emb *= mask[..., None]
    params = JaxItemQFormer(CFG).init(jax.random.PRNGKey(0),
                                      jnp.asarray(emb[:2]),
                                      jnp.asarray(mask[:2]))
    sd = item_qformer_state_dict_from_flax(params)
    return params, sd, emb, mask


def _port(sd, **kw):
    kw.setdefault("batch_size", 8)
    return QFormerInference(config=CFG, params=sd, field_names=FIELDS,
                            device="cpu", **kw)


def test_fused_inference_matches_jax(setup):
    params, sd, emb, mask = setup
    jax_inf = JaxQFormerInference(config=CFG, params=params,
                                  field_names=FIELDS, batch_size=8,
                                  use_fused=True)
    port = _port(sd, use_fused=True)
    assert port.use_fused and port.model is None
    got = port.query_tokens_from_embeddings(emb, mask)
    want = jax_inf.query_tokens_from_embeddings(emb, mask)
    assert got.shape == want.shape == (20, 8, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=BF16_ENGINE_ATOL, rtol=0)


def test_default_on_cpu_is_the_bf16_model(setup):
    params, sd, emb, mask = setup
    port = _port(sd)
    assert not port.use_fused and port.model.dtype == torch.bfloat16
    got = port.query_tokens_from_embeddings(emb, mask)
    want = np.asarray(JaxItemQFormer(CFG).apply(
        params, jnp.asarray(emb), jnp.asarray(mask))["query_outputs"])
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.999  # bf16 against the fp32 model


def test_outputs_do_not_depend_on_batch_composition(setup):
    _, sd, emb, mask = setup
    port = _port(sd, use_fused=True, batch_size=20)
    full = port.query_tokens_from_embeddings(emb, mask)
    for i in (0, 5, 19):
        alone = port.query_tokens_from_embeddings(emb[i:i + 1], mask[i:i + 1])
        np.testing.assert_array_equal(alone[0], full[i])
    port.batch_size = 7  # ragged chunks: 7, 7, 6
    np.testing.assert_array_equal(
        port.query_tokens_from_embeddings(emb, mask), full)


def test_checkpoint_directory_round_trip(setup, tmp_path):
    _, sd, emb, mask = setup
    save_checkpoint(str(tmp_path / "ckpt"), sd, CFG,
                    extra={"field_names": FIELDS})
    loaded, meta = load_checkpoint(str(tmp_path / "ckpt"))
    assert loaded.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(loaded[k], sd[k], atol=0, rtol=0)
    assert meta == read_meta(str(tmp_path / "ckpt"))
    assert meta["config_class"] == "ItemQFormerConfig"
    assert meta["field_names"] == FIELDS
    assert restore_config(meta, ItemQFormerConfig) == CFG
    from_dir = QFormerInference(str(tmp_path / "ckpt"), device="cpu",
                                use_fused=True, batch_size=8)
    # the port's own config class, with the same fields
    assert dataclasses.asdict(from_dir.config) == dataclasses.asdict(CFG)
    assert from_dir.field_names == FIELDS
    np.testing.assert_array_equal(
        from_dir.query_tokens_from_embeddings(emb, mask),
        _port(sd, use_fused=True).query_tokens_from_embeddings(emb, mask))


def test_reference_pth_loads(setup, tmp_path):
    params, sd, emb, mask = setup
    path = str(tmp_path / "best_qformer_model.pth")
    save_reference_item_qformer_checkpoint(path, params["params"], CFG, FIELDS)
    ref = QFormerInference(path, device="cpu", use_fused=True, batch_size=8)
    assert ref.field_names == FIELDS
    assert ref.config.field_embedding_dim == 16
    np.testing.assert_array_equal(
        ref.query_tokens_from_embeddings(emb, mask),
        _port(sd, use_fused=True).query_tokens_from_embeddings(emb, mask))


def test_precision_and_mesh_are_refused(setup):
    _, sd, _, _ = setup
    q8 = _port(sd, precision="int8")  # the W8A8 engine, even on the CPU
    assert q8.use_fused and q8.fused_params.layers[0].is_int8
    # a dp mesh is taken (tests/test_torch_dp_inference.py); a batch that
    # does not split over it is refused with the JAX class's error
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        _port(sd, mesh=make_mesh(MeshConfig(dp=3), ["cpu"] * 3))
    with pytest.raises(ValueError):
        _port(sd, precision="fp8")


@pytest.fixture
def tiny_sweep(setup, tmp_path):
    _, sd, emb, mask = setup
    save_checkpoint(str(tmp_path / "ckpt"), sd, CFG,
                    extra={"field_names": FIELDS})
    ids = [f"item{j}" for j in range(20)]
    FieldEmbeddingCache(emb, mask, FIELDS, ids).save(str(tmp_path / "cache"))
    # the CLI's QFormerInference defaults: on the CPU, the bf16 model
    expect = dict(zip(ids, _port(sd).query_tokens_from_embeddings(emb, mask)))
    argv = ["--checkpoint", str(tmp_path / "ckpt"),
            "--cache-dir", str(tmp_path / "cache"), "--device", "cpu"]
    return tmp_path, argv, expect


def test_cli_pkl_progress_and_max_items(tiny_sweep):
    tmp, argv, expect = tiny_sweep
    out, prog = str(tmp / "tok.pkl"), str(tmp / "progress.json")
    rc = cli.main(argv + ["--output", out, "--batch-size", "4",
                          "--max-items", "13", "--progress-file", prog,
                          "--profile"])
    assert rc == 0
    with open(out, "rb") as f:
        tokens = pickle.load(f)
    assert sorted(tokens) == sorted(list(expect)[:13])
    for k, v in tokens.items():
        assert v.shape == (8, 64)
        np.testing.assert_array_equal(v, expect[k])
    with open(prog) as f:
        progress = json.load(f)
    assert progress["done"] == progress["total"] == 13
    assert progress["fallback_items"] == 0


def test_cli_json_output(tiny_sweep):
    tmp, argv, expect = tiny_sweep
    out = str(tmp / "tok.json")
    assert cli.main(argv + ["--output", out, "--batch-size", "8"]) == 0
    with open(out) as f:
        tokens = json.load(f)
    assert len(tokens) == 20
    np.testing.assert_allclose(np.asarray(tokens["item5"]), expect["item5"],
                               atol=0, rtol=0)


def test_cli_oom_downshift(tiny_sweep, monkeypatch, capsys):
    tmp, argv, expect = tiny_sweep
    real = QFormerInference.query_tokens_from_embeddings
    sizes = []

    def fake(self, emb, mask):
        sizes.append(emb.shape[0])
        if emb.shape[0] > 4:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 1.00 GiB")
        return real(self, emb, mask)

    monkeypatch.setattr(QFormerInference, "query_tokens_from_embeddings", fake)
    prog = str(tmp / "progress.json")
    rc = cli.main(argv + ["--output", str(tmp / "tok.pkl"), "--batch-size",
                          "16", "--min-batch-size", "2",
                          "--progress-file", prog])
    assert rc == 0
    assert sizes[:3] == [16, 8, 4] and max(sizes[3:]) == 4
    assert "downshifting batch size to 4" in capsys.readouterr().err
    with open(str(tmp / "tok.pkl"), "rb") as f:
        tokens = pickle.load(f)
    assert len(tokens) == 20
    np.testing.assert_array_equal(tokens["item7"], expect["item7"])
    with open(prog) as f:
        assert json.load(f)["fallback_items"] == 0


def test_cli_counts_fallback_items(tiny_sweep, monkeypatch):
    tmp, argv, expect = tiny_sweep
    real = QFormerInference.query_tokens_from_embeddings

    def flaky(self, emb, mask):
        if emb.shape[0] > 1:
            raise RuntimeError("a batch failed")
        if np.all(emb == emb_of_item3):
            raise RuntimeError("this item fails alone too")
        return real(self, emb, mask)

    emb_of_item3 = FieldEmbeddingCache.load(str(tmp / "cache")).gather(
        ["item3"])[0]
    monkeypatch.setattr(QFormerInference, "query_tokens_from_embeddings",
                        flaky)
    prog = str(tmp / "progress.json")
    assert cli.main(argv + ["--output", str(tmp / "tok.pkl"), "--batch-size",
                            "8", "--progress-file", prog]) == 0
    with open(prog) as f:
        assert json.load(f)["fallback_items"] == 20
    with open(str(tmp / "tok.pkl"), "rb") as f:
        tokens = pickle.load(f)
    np.testing.assert_array_equal(tokens["item3"], np.zeros((8, 64)))
    np.testing.assert_array_equal(tokens["item4"], expect["item4"])


def test_cli_compare_trace_and_device_check(tiny_sweep, capsys):
    tmp, argv, _ = tiny_sweep
    assert cli.main(argv + ["--compare", "--batch-size", "8"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert result["sample_size"] == 20 and result["outputs_match"]
    trace = tmp / "trace"
    assert cli.main(argv + ["--output", str(tmp / "t.pkl"), "--trace-dir",
                            str(trace), "--max-items", "3"]) == 0
    assert json.loads((trace / "trace.json").read_text())["traceEvents"]
    # no card here: the self-test reports it and the CLI exits 1
    assert cli.main(["--check-devices"]) == (0 if torch.cuda.is_available()
                                             else 1)


def test_cli_int8_sweep(tiny_sweep):
    """--precision int8: every item gets the W8A8 engine's tokens, none takes
    a fallback."""
    tmp, argv, _ = tiny_sweep
    out, prog = str(tmp / "tok8.pkl"), str(tmp / "progress.json")
    rc = cli.main(argv + ["--precision", "int8", "--output", out,
                          "--batch-size", "8", "--progress-file", prog])
    assert rc == 0
    with open(out, "rb") as f:
        tokens = pickle.load(f)
    with open(prog) as f:
        progress = json.load(f)
    assert progress["done"] == 20 and progress["fallback_items"] == 0
    cache = FieldEmbeddingCache.load(str(tmp / "cache"))
    emb, mask = cache.gather(cache.item_ids)
    sd = load_checkpoint(str(tmp / "ckpt"))[0]
    want = _port(sd, precision="int8").query_tokens_from_embeddings(emb, mask)
    assert sorted(tokens) == sorted(cache.item_ids)
    for j, iid in enumerate(cache.item_ids):
        assert np.isfinite(tokens[iid]).all()
        np.testing.assert_array_equal(tokens[iid], want[j])


# more cards than the machine has (2 here)
_TOO_MANY_CARDS = str(max(2, torch.cuda.device_count() + 1))


@pytest.mark.parametrize("extra", [["--dp", _TOO_MANY_CARDS, "--device",
                                    "cuda"],
                                   ["--data", "items.json"], []],
                         ids=["dp2", "data-without-cache", "no-ckpt"])
def test_cli_refuses_what_is_not_ported(tiny_sweep, extra):
    """--dp above the number of cards (--dp itself is ported:
    tests/test_torch_dp_inference.py); --data without a cache is ported
    (tests/test_torch_front_cli.py), and a --data file that does not exist
    is refused; no checkpoint."""
    tmp, argv, _ = tiny_sweep
    if extra == ["--data", "items.json"]:
        argv = argv[:2] + argv[4:]  # checkpoint, no cache
        assert not (tmp / "items.json").exists()
        extra = ["--data", str(tmp / "items.json")]
    elif not extra:
        argv = argv[2:]  # cache, no checkpoint
    assert cli.main(argv + extra) == 2


def test_is_null_value():
    for v in (None, "", "  ", "null", "NULL", " None ", "nan", "NaN"):
        assert is_null_value(v), v
    for v in ("0", "text", 0, 0.0, [], "nullable"):
        assert not is_null_value(v), v


class StubEncoder:
    """Field text -> a fixed vector; an empty encode gives zeros."""

    embedding_dim = 16

    def encode_batch_by_field(self, items, fields):
        out = {}
        for f in fields:
            rows = []
            for item in items:
                v = item.get(f)
                if v in (None, "", "boom"):
                    rows.append(np.zeros(16, np.float32))
                else:
                    rows.append(np.full(16, float(len(str(v))), np.float32))
            out[f] = np.stack(rows)
        return out


def test_encode_items_masks_nulls_and_zero_vectors(setup, tmp_path):
    _, sd, _, _ = setup
    port = _port(sd, use_fused=True, item_encoder=StubEncoder())
    items = [
        {"f0": "lipstick", "f1": "null", "f2": "boom", "f3": None, "f4": "x"},
        {"f0": " NaN ", "f5": "serum"},
    ]
    emb, mask = port.encode_items(items)
    assert emb.shape == (2, 6, 16)
    np.testing.assert_array_equal(mask, [[1, 0, 0, 0, 1, 0],
                                         [0, 0, 0, 0, 0, 1]])
    data = {"a": items[0], "b": items[1]}
    path = tmp_path / "items.json"
    path.write_text(json.dumps(data))
    one = port.generate_query_tokens_by_id("a", str(path))
    both = port.generate_query_tokens_batch_by_ids(["a", "missing", "b"],
                                                   str(path))
    assert port.generate_query_tokens_by_id("missing", str(path)) is None
    assert sorted(both) == ["a", "b"] and one.shape == (8, 64)
    np.testing.assert_array_equal(both["a"], one)
    cache = FieldEmbeddingCache(emb, mask, FIELDS, ["a", "b"])
    out = str(tmp_path / "run.pkl")
    tokens = run_inference(port, cache, out, log_fn=lambda *a: None)
    with open(out, "rb") as f:
        assert sorted(pickle.load(f)) == sorted(tokens) == ["a", "b"]
