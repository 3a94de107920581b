"""Port parity: the pipeline's front-end CLIs, unirec_tpu_torch vs
unirec_tpu on the same files, on the CPU.

* ``embed qwen3|clip`` and ``review-embed`` with the hash backends write the
  JAX CLIs' JSON byte for byte; with ``--hf-path`` (a tiny Hugging Face
  Qwen3, and a tiny ``CLIPModel`` with a BPE ``CLIPTokenizerFast``, written
  here; images read from PNG files, one missing) they give the JAX CLIs'
  items and rows within the bf16 class (max|d| / max|ref| <= 2e-2: both
  run the image and Qwen3 towers in bf16, as their defaults are).
* ``tokens --data`` encodes the raw items with ``ItemEncoder()`` into the
  JAX package's cache (hash rows bit for bit; the number encoders share one
  set of weights, 1e-6) and sweeps it as the same CLI does from that cache.
* ``users`` with both history schemas and both output forms gives the JAX
  CLI's embeddings within 1e-5 in float32, over one reference ``.pth`` Item
  Q-Former and the JAX CLI's seed-0 joint weights carried over; the field
  cache holds bfloat16 values, so the device cache (a bfloat16 copy) and
  ``--host-field-cache`` (float32 on the host) give the same rows.
* ``python -m unirec_tpu_torch`` lists the seven commands and routes each to
  the port's CLI.
"""

import json
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_builders import write_raw
from tests.test_torch_text_backend import write_hf_qwen3
from unirec_tpu.cli import candidate_embeddings as jax_embed
from unirec_tpu.cli import review_embeddings as jax_review
from unirec_tpu.cli import serve_cli as jax_serve
from unirec_tpu.cli import user_embeddings as jax_users
from unirec_tpu.configs import ItemQFormerConfig, MWNEConfig
from unirec_tpu.data.cache import build_cache as jax_build_cache
from unirec_tpu.encoders.backends import MWNENumberBackend as JaxMWNE
from unirec_tpu.encoders.item_encoder import ItemEncoder as JaxItemEncoder
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.models.mwne import NormalizedMathematicalEncoder
from unirec_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from unirec_tpu.utils.torch_convert import save_reference_item_qformer_checkpoint
from unirec_tpu_torch.cli import candidate_embeddings as port_embed
from unirec_tpu_torch.cli import data_pipeline
from unirec_tpu_torch.cli import generate_all_item_embeddings as port_tokens
from unirec_tpu_torch.cli import review_embeddings as port_review
from unirec_tpu_torch.cli import serve_cli
from unirec_tpu_torch.cli import user_embeddings as port_users
from unirec_tpu_torch.configs import DEFAULT_FIELD_MAPPING, Qwen3Config
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.encoders import backends as port_backends
from unirec_tpu_torch.encoders import item_encoder as port_item_encoder
from unirec_tpu_torch.utils.checkpoint import save_checkpoint
from unirec_tpu_torch.utils.weights import (
    item_qformer_state_dict_from_flax,
    joint_state_dict_from_flax,
    mwne_state_dict_from_flax,
)

FIELDS = sorted(DEFAULT_FIELD_MAPPING)
HIDDEN = 32
IQ = ItemQFormerConfig(hidden_size=HIDDEN, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=64,
                       num_query_tokens=2, field_embedding_dim=1024,
                       num_fields=len(FIELDS), dropout=0.0)
BF16_REL = 2e-2
COMMANDS = ("data", "train", "tokens", "embed", "review-embed", "users",
            "serve")


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def front(tmp_path_factory):
    """Raw files through the port's ``data`` CLI, and a reference ``.pth``
    Item Q-Former over the default schema's 14 fields of width 1024."""
    d = tmp_path_factory.mktemp("front")
    write_raw(d, n_items=40, n_users=24)
    for argv in (["item-dict", "--input", str(d / "meta.jsonl"), "--output",
                  str(d / "items.json")],
                 ["review-dict", "--input", str(d / "reviews.jsonl"),
                  "--output", str(d / "reviews.json")],
                 ["triplet-dict", "--input", str(d / "items.json"),
                  "--output", str(d / "triplet.json")],
                 ["rec-old-user", "--inter", str(d / "x.inter"),
                  "--output-prefix", str(d / "rec"), "--num-candidates",
                  "12"]):
        assert data_pipeline.main(argv) == 0
    params = JaxItemQFormer(IQ).init(
        jax.random.PRNGKey(0), jnp.zeros((2, IQ.num_fields, 1024)),
        jnp.ones((2, IQ.num_fields)))
    save_reference_item_qformer_checkpoint(str(d / "iq.pth"),
                                           params["params"], IQ, FIELDS)
    # the same weights as the JAX package's and the port's checkpoint
    # directories (the JAX serving path refuses a reference .pth's text-side
    # entries)
    meta = {"field_names": FIELDS}
    jax_save_checkpoint(str(d / "iq_jax"), SimpleNamespace(
        params=params["params"], opt_state={}, step=0), IQ, meta)
    save_checkpoint(str(d / "iq_port"), item_qformer_state_dict_from_flax(
        params), IQ, meta)
    return d


def _both(port_main, jax_main, argv, d, name):
    """One CLI through both packages; the two outputs' paths."""
    outs = []
    for tag, fn in (("port", port_main), ("jax", jax_main)):
        out = str(d / f"{name}_{tag}.json")
        assert fn(argv + ["--output", out]) == 0
        outs.append(out)
    return outs


@pytest.mark.parametrize("mode", ["qwen3", "clip"])
def test_embed_hash_backends_write_the_jax_file(front, mode):
    d = front
    argv = [mode, "--item-dict", str(d / "items.json")]
    argv += (["--samples", str(d / "rec_train.json"), str(d / "rec_test.json"),
              "--embedding-dim", str(HIDDEN)] if mode == "qwen3"
             else ["--max-items", "30", "--batch-size", "8"])
    port, jax_out = _both(port_embed.main, jax_embed.main, argv, d,
                          f"embed_{mode}")
    with open(port, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()
    emb = json.load(open(port))
    assert len(emb) > 10


def test_review_embed_hash_backends_write_the_jax_file(front):
    d = front
    if not (d / "embed_clip_port.json").exists():
        test_embed_hash_backends_write_the_jax_file(front, "clip")
    argv = ["--review-dict", str(d / "reviews.json"), "--item-dict",
            str(d / "items.json"), "--item-emb",
            str(d / "embed_clip_port.json")]
    port, jax_out = _both(port_review.main, jax_review.main, argv, d,
                          "review")
    with open(port, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()
    rows = json.load(open(port))
    assert rows and all(len(v) == 1024 for v in rows.values())


def _write_hf_clip(path):
    """A tiny ``CLIPModel`` (28-pixel images of 14-pixel patches) and a BPE
    ``CLIPTokenizerFast`` over the byte alphabet, saved to ``path``."""
    from transformers import CLIPConfig, CLIPModel, CLIPTokenizerFast
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    merges = ["p r", "pr o", "pro d", "d u", "du c", "duc t</w>"]
    vocab = chars + [c + "</w>" for c in chars] + [
        "".join(m.split()) for m in merges] + ["<|startoftext|>",
                                               "<|endoftext|>"]
    path.mkdir()
    (path / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(vocab)}))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                     + "\n")
    tok = CLIPTokenizerFast(str(path / "vocab.json"), str(path / "merges.txt"))
    cfg = CLIPConfig(
        text_config=dict(vocab_size=len(vocab), hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=77,
                         eos_token_id=tok.eos_token_id,
                         bos_token_id=tok.bos_token_id),
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=28, patch_size=14),
        projection_dim=16)
    torch.manual_seed(0)
    CLIPModel(cfg).save_pretrained(str(path))
    tok.save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def image_items(front):
    """Items whose MAIN images are PNG files (one missing), their reviews."""
    d = front
    rng = np.random.RandomState(0)
    items = {}
    for i in range(10):
        png = d / f"img{i}.png"
        if i != 3:
            Image.fromarray((rng.rand(30 + i, 40, 3) * 255).astype(
                np.uint8)).save(png)
        items[f"A{i}"] = {"title": f"Product {i}", "features": ["matte"],
                          "images": [{"variant": "MAIN", "large": str(png)}]}
    (d / "image_items.json").write_text(json.dumps(items))
    reviews = {f"u{i}|A{i}": {"title": "ok", "text": f"review {i}"}
               for i in range(10)}
    (d / "image_reviews.json").write_text(json.dumps(reviews))
    return d / "image_items.json", d / "image_reviews.json"


def _close_rows(port_path, jax_path):
    port, want = json.load(open(port_path)), json.load(open(jax_path))
    assert sorted(port) == sorted(want) and port
    keys = sorted(port)
    assert rel_err([port[k] for k in keys], [want[k] for k in keys]) \
        <= BF16_REL
    return port


def test_embed_and_review_hf_path_match_jax(front, image_items, tmp_path):
    d = front
    items, reviews = image_items
    clip_dir = _write_hf_clip(tmp_path / "clip")
    # qwen3: a right-padding tokenizer (C-14: the JAX wrapper would pool a
    # pad position of a left-padded row)
    qwen_dir = write_hf_qwen3(
        tmp_path / "qwen", Qwen3Config(vocab_size=256, hidden_size=64,
                                       intermediate_size=128,
                                       num_hidden_layers=2,
                                       num_attention_heads=4,
                                       num_key_value_heads=2, head_dim=16),
        256, "Product product 1 2 3 4 5 6 7 8 9 matte".split(),
        padding_side="right")
    port, want = (str(tmp_path / f"q_{t}.json") for t in ("port", "jax"))
    argv = ["qwen3", "--item-dict", str(items), "--hf-path", qwen_dir]
    assert port_embed.main(argv + ["--output", port, "--device", "cpu"]) == 0
    assert jax_embed.main(argv + ["--output", want]) == 0
    assert len(_close_rows(port, want)) == 10

    port, want = (str(tmp_path / f"c_{t}.json") for t in ("port", "jax"))
    argv = ["clip", "--item-dict", str(items), "--hf-path", clip_dir]
    assert port_embed.main(argv + ["--output", port, "--device", "cpu"]) == 0
    assert jax_embed.main(argv + ["--output", want]) == 0
    rows = _close_rows(port, want)
    assert len(rows) == 9 and "A3" not in rows  # the missing image

    out = [str(tmp_path / f"r_{t}.json") for t in ("port", "jax")]
    argv = ["--review-dict", str(reviews), "--item-dict", str(items),
            "--item-emb", port, "--hf-path", clip_dir]
    assert port_review.main(argv + ["--output", out[0], "--device",
                                    "cpu"]) == 0
    assert jax_review.main(argv + ["--output", out[1]]) == 0
    assert len(_close_rows(*out)) == 9


def _shared_mwne():
    """One number encoder's weights for both packages' ``ItemEncoder()``."""
    cfg = MWNEConfig()
    variables = NormalizedMathematicalEncoder(cfg).init(jax.random.PRNGKey(1),
                                                        jnp.zeros((2,)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return cfg, variables


def test_tokens_data_builds_the_jax_cache_and_sweeps_it(front, tmp_path,
                                                         monkeypatch):
    d = front
    cfg, variables = _shared_mwne()
    monkeypatch.setattr(
        port_item_encoder, "MWNENumberBackend",
        lambda device=None: port_backends.MWNENumberBackend(
            cfg, mwne_state_dict_from_flax(variables), device=device))
    with open(d / "triplet.json") as f:
        triplet = json.load(f)
    items = [dict(v, item_id=k) for k, v in triplet.items()]
    want = jax_build_cache(items, JaxItemEncoder(
        number_backend=JaxMWNE(cfg, variables)), fields=FIELDS)

    out = str(tmp_path / "tok_data.pkl")
    argv = ["--checkpoint", str(d / "iq.pth"), "--device", "cpu",
            "--batch-size", "16"]
    assert port_tokens.main(argv + ["--data", str(d / "triplet.json"),
                                    "--cache-dir", str(tmp_path / "cache"),
                                    "--output", out]) == 0
    got = FieldEmbeddingCache.load(str(tmp_path / "cache"))
    assert got.item_ids == want.item_ids and list(got.fields) == FIELDS
    np.testing.assert_array_equal(got.masks, want.masks)
    numbers = [FIELDS.index(f) for f in ("average_rating", "price",
                                         "rating_number")]
    text = [i for i in range(len(FIELDS)) if i not in numbers]
    np.testing.assert_array_equal(got.embeddings[:, text],
                                  want.embeddings[:, text])
    np.testing.assert_allclose(got.embeddings[:, numbers],
                               want.embeddings[:, numbers], atol=1e-6)
    # the --data sweep equals the sweep of the cache it wrote
    again = str(tmp_path / "tok_cache.pkl")
    assert port_tokens.main(argv + ["--cache-dir", str(tmp_path / "cache"),
                                    "--output", again]) == 0
    with open(out, "rb") as a, open(again, "rb") as b:
        tok_data, tok_cache = pickle.load(a), pickle.load(b)
    assert sorted(tok_data) == sorted(triplet)
    for k, v in tok_data.items():
        assert v.shape == (IQ.num_query_tokens, HIDDEN)
        np.testing.assert_array_equal(v, tok_cache[k])


@pytest.fixture(scope="module")
def users_files(front):
    """A bfloat16-valued field cache, a catalog in the tiny LLM's width, both
    history schemas, the JAX CLI's seed-0 joint weights as a port
    checkpoint, and the shared flags."""
    d = front
    rng = np.random.RandomState(3)
    with open(d / "triplet.json") as f:
        ids = list(json.load(f))
    emb = torch.from_numpy(rng.randn(len(ids), IQ.num_fields, 1024).astype(
        np.float32)).bfloat16().float().numpy()
    masks = (rng.rand(len(ids), IQ.num_fields) > 0.2).astype(np.float32)
    FieldEmbeddingCache(emb * masks[..., None], masks, FIELDS, ids).save(
        str(d / "ucache"))
    (d / "catalog.json").write_text(json.dumps(
        {i: rng.randn(HIDDEN).tolist() for i in ids}))
    with open(d / "rec_train.json") as f:
        samples = json.load(f)
    (d / "hist_dict.json").write_text(json.dumps(
        {s["user_id"]: s["history"] for s in samples}))
    base = ["--cache-dir", str(d / "ucache"),
            "--item-dict", str(d / "triplet.json"),
            "--catalog", str(d / "catalog.json"),
            "--tiny", "--max-length", "64", "--batch-size", "4"]
    jrec = jax_serve.build_recommender(jax_serve.parse_args(
        base + ["--qformer-checkpoint", str(d / "iq_jax")]))
    sd = joint_state_dict_from_flax(jrec.params, jrec.model.qwen_config,
                                    jrec.model.qformer_config)
    save_checkpoint(str(d / "joint"), sd)
    return base, samples


@pytest.mark.parametrize("schema,suffix", [("rec_train.json", ".npy"),
                                           ("hist_dict.json", ".json")],
                         ids=["samples_npy", "dict_json"])
def test_users_matches_jax(front, users_files, tmp_path, schema, suffix):
    d = front
    base, samples = users_files
    hist = ["--histories", str(d / schema)]
    outs = [str(tmp_path / f"u_{t}{suffix}") for t in ("port", "jax")]
    assert port_users.main(base + hist + [
        "--qformer-checkpoint", str(d / "iq_port"), "--checkpoint",
        str(d / "joint"), "--device", "cpu", "--output", outs[0]]) == 0
    assert jax_users.main(base + hist + [
        "--qformer-checkpoint", str(d / "iq_jax"), "--output", outs[1]]) == 0
    if suffix == ".npy":
        got, want = np.load(outs[0]), np.load(outs[1])
        ids = json.load(open(outs[0] + ".ids.json"))
        assert ids == json.load(open(outs[1] + ".ids.json"))
        assert ids == [s["user_id"] for s in samples]
    else:
        got_map, want_map = json.load(open(outs[0])), json.load(open(outs[1]))
        assert list(got_map) == list(want_map)
        got, want = (np.asarray(list(m.values())) for m in (got_map,
                                                            want_map))
    assert got.shape == (len(samples), HIDDEN)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_users_host_field_cache_equals_device_cache(front, users_files):
    base, samples = users_files
    argv = base + ["--qformer-checkpoint", str(front / "iq_port"),
                   "--checkpoint", str(front / "joint"), "--device", "cpu",
                   "--histories", "h", "--output", "o"]
    rec = serve_cli.build_recommender(port_users.parse_args(argv))
    host = serve_cli.build_recommender(port_users.parse_args(
        argv + ["--host-field-cache"]))
    assert rec.device_cache and not host.device_cache
    assert not hasattr(host, "_cache_emb_dev")
    hists = [s["history"] for s in samples] + [["unknown", "A1"], []]
    np.testing.assert_allclose(host.encode_users(hists),
                               rec.encode_users(hists), atol=1e-6, rtol=0)
    want = [[r.item_id for r in u] for u in rec.recommend(hists[:5], k=4)]
    assert [[r.item_id for r in u] for u in host.recommend(hists[:5], k=4)] \
        == want


def test_dispatcher_routes_every_command(monkeypatch, tmp_path):
    from unirec_tpu_torch import __main__ as dispatcher
    from unirec_tpu_torch.cli import (
        candidate_embeddings,
        generate_all_item_embeddings,
        review_embeddings,
        train_cli,
        user_embeddings,
    )

    modules = dict(zip(COMMANDS, (data_pipeline, train_cli,
                                  generate_all_item_embeddings,
                                  candidate_embeddings, review_embeddings,
                                  user_embeddings, serve_cli)))
    for cmd, module in modules.items():
        seen = []
        monkeypatch.setattr(module, "main",
                            lambda argv, seen=seen: seen.append(argv) or 7)
        assert dispatcher.main([cmd, "--flag", "x"]) == 7, cmd
        assert seen == [["--flag", "x"]], cmd
    assert dispatcher.main(["nonsense"]) == 2
    out = subprocess.run([sys.executable, "-m", "unirec_tpu_torch", "--help"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    listed = [line.split()[0] for line in out.stdout.splitlines()
              if line.startswith("  ") and line.split()]
    assert set(COMMANDS) <= set(listed)
    (tmp_path / "m.jsonl").write_text(json.dumps({"parent_asin": "A",
                                                  "title": "t"}) + "\n")
    out = subprocess.run([sys.executable, "-m", "unirec_tpu_torch", "data",
                          "item-dict", "--input", str(tmp_path / "m.jsonl"),
                          "--output", str(tmp_path / "i.json")],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads((tmp_path / "i.json").read_text()) == {"A": {
        "title": "t"}}
