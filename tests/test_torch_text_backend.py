"""Port parity: the Qwen3-Embedding text backend, the Hugging Face tokenizer,
``convert_qwen3`` and ``train joint --hf-path``, unirec_tpu_torch vs
unirec_tpu on the CPU.

A tiny Hugging Face Qwen3 and a word-level tokenizer made with ``tokenizers``
(padding side left, as Qwen3-Embedding's) are written to ``tmp_path`` in the
test; nothing is downloaded.  In float32 the port's ``Qwen3TextBackend``
gives the JAX backend's rows within max|d| / max|ref| <= 1e-5 for one chunk
and for a padded tail, with bridged weights and with ``from_local_hf``.
``HFTokenizer`` ids and ``convert_qwen3`` arrays are equal to the JAX
package's.  One ``JointTrainer`` step over a base read from the HF
checkpoint matches the JAX step within the joint-parity tolerances
(``tests/test_torch_train_joint.py``), and ``train_cli joint --hf-path``
runs where it used to raise.

C-15: a text of no token gives the JAX backend's row (an all-pad row is
the same at every position, whatever the attention weights).

C-14: with a left-padding tokenizer the JAX backend's ``from_local_hf``
pools a pad position (its ``last_token_pool`` is the right-padding branch);
the port's wrapper pads on the right, and K1's key-0 contract refuses the
left-padded mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import (
    MeshConfig,
    Qwen3Config as JaxQwen3Config,
    TrainConfig,
)
from unirec_tpu.data import tokenizer as jax_tok
from unirec_tpu.data.cache import FieldEmbeddingCache as JaxCache
from unirec_tpu.encoders import backends as jax_backends
from unirec_tpu.models.qwen3 import Qwen3Model as JaxQwen3
from unirec_tpu.train import joint as jax_train
from unirec_tpu.utils import torch_convert as jax_convert
from unirec_tpu_torch.configs import Qwen3Config
from unirec_tpu_torch.data import tokenizer as port_tok
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.encoders.backends import Qwen3TextBackend
from unirec_tpu_torch.ops.flash_causal import check_pad_mask
from unirec_tpu_torch.train import joint as port_train
from unirec_tpu_torch.utils import torch_convert as port_convert
from unirec_tpu_torch.utils.weights import (
    flax_to_state_dict,
    joint_state_dict_from_flax,
    qwen3_state_dict_from_flax,
)
from tests.test_torch_train_joint import (
    JC,
    LORA,
    OPT,
    QF,
    QWEN,
    _cli_files,
    _data,
)


CFG = Qwen3Config(vocab_size=128, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, flash_attention=False)
JAX_CFG = JaxQwen3Config(**{f: getattr(CFG, f) for f in (
    "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
    "num_attention_heads", "num_key_value_heads", "head_dim",
    "flash_attention")})
REL = 1e-5
TEXTS = ["lip balm cherry", "face cream with a long description of it",
         "a", "shampoo 2 in 1", "matte red lipstick", "nail polish remover",
         "sunscreen spf 50"]
WORDS = ("item ab abab ababab abababab lip balm cherry face cream with a "
         "long description of it shampoo 2 in 1 matte red lipstick nail "
         "polish remover sunscreen spf 50").split()


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def write_hf_qwen3(path, cfg, n_vocab: int, words=WORDS, seed=0,
                   padding_side="left") -> str:
    """A random HF ``Qwen3Model`` of ``cfg``'s shapes and a word-level
    tokenizer of ``n_vocab`` entries (pad, unk, ``words``, fillers), padding
    on ``padding_side`` (Qwen3-Embedding's: left), saved to ``path``."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    from transformers import Qwen3Config as HFConfig
    from transformers import Qwen3Model as HFModel

    names = ["<pad>", "<unk>"] + list(dict.fromkeys(words))
    names += [f"w{i}" for i in range(n_vocab - len(names))]
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(names)},
                                    unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tk, pad_token="<pad>",
                            unk_token="<unk>",
                            padding_side=padding_side).save_pretrained(
                                str(path))
    hf_cfg = HFConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        max_position_embeddings=128, attention_bias=False)
    torch.manual_seed(seed)
    HFModel(hf_cfg).save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return write_hf_qwen3(tmp_path_factory.mktemp("hf_qwen3"), CFG, 128)


@pytest.mark.parametrize("texts", [TEXTS[:3], TEXTS],
                         ids=["one_chunk", "padded_tail"])
def test_text_backend_matches_jax(texts):
    jm = JaxQwen3(JAX_CFG)
    params = jm.init(jax.random.PRNGKey(0),
                     input_ids=jnp.zeros((1, 4), jnp.int32))
    jb = jax_backends.Qwen3TextBackend(JAX_CFG, params, max_length=16,
                                       batch_size=4, dtype=jnp.float32)
    pb = Qwen3TextBackend(CFG, qwen3_state_dict_from_flax(params, CFG),
                          max_length=16, batch_size=4, dtype=torch.float32,
                          device="cpu")
    want, got = jb.encode(texts), pb.encode(texts)
    assert got.shape == (len(texts), CFG.hidden_size)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    assert rel_err(got, want) <= REL


def test_text_backend_empty_text_runs():
    """A text of no token is a row whose key 0 is marked valid (C-15), not
    a zero-length row K1 would refuse."""
    pb = Qwen3TextBackend(CFG, max_length=8, batch_size=4,
                          dtype=torch.float32, device="cpu")
    out = pb.encode(["lip balm", "", "   "])
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[1], out[2], rtol=1e-6)


def test_text_backend_empty_text_matches_jax():
    """C-15: an item whose text tokenizes to no token.  The JAX backend pools
    position L-1 of the all-masked row, the port position 0 (its key 0 is
    marked valid, K1's contract).  Every position holds the pad token, so
    every layer's value rows are equal, and any attention weights (the XLA
    path's uniform ones over all L keys, a Pallas block's, the port's one
    key) give the same hidden row at every position: the JAX row is a
    function of its inputs, and the port's equals it (max|d| / max|ref| <=
    1e-5), beside a real text in the same batch."""
    jm = JaxQwen3(JAX_CFG)
    params = jm.init(jax.random.PRNGKey(3),
                     input_ids=jnp.zeros((1, 4), jnp.int32))
    jb = jax_backends.Qwen3TextBackend(JAX_CFG, params, max_length=16,
                                       batch_size=4, dtype=jnp.float32)
    pb = Qwen3TextBackend(CFG, qwen3_state_dict_from_flax(params, CFG),
                          max_length=16, batch_size=4, dtype=torch.float32,
                          device="cpu")
    texts = ["lip balm", "", "   "]
    want, got = jb.encode(texts), pb.encode(texts)
    for row in range(3):
        assert rel_err(got[row], want[row]) <= REL, row
    ids = jnp.zeros((1, 16), jnp.int32)
    hidden = np.asarray(jm.apply(params, input_ids=ids,
                                 attention_mask=jnp.zeros((1, 16))))[0]
    assert rel_err(hidden, np.broadcast_to(hidden[:1], hidden.shape)) <= 1e-6


def test_text_backend_from_local_hf_matches_jax(hf_dir):
    pb = Qwen3TextBackend.from_local_hf(hf_dir, max_length=12, batch_size=4,
                                        dtype=torch.float32, device="cpu")
    jb = jax_backends.Qwen3TextBackend.from_local_hf(
        hf_dir, max_length=12, batch_size=4, dtype=jnp.float32)
    assert pb.config.vocab_size == 128 and pb.config.rope_theta == 1e6
    # C-14: the JAX wrapper pads on the tokenizer's side (left): key 0 of a
    # short text is padding, and the right-padding pool reads a pad position
    ids, mask = jb.tokenizer.encode("lip balm", 12)
    assert mask[0] == 0 and mask[int(mask.sum()) - 1] == 0
    with pytest.raises(ValueError, match="key 0"):
        check_pad_mask(torch.from_numpy(mask)[None])
    ids_p, mask_p = pb.tokenizer.encode("lip balm", 12)
    np.testing.assert_array_equal(mask_p, np.sort(mask)[::-1])
    np.testing.assert_array_equal(ids_p[:2], ids[-2:])
    # against the JAX backend fed right-padded rows
    jb.tokenizer.tok.padding_side = "right"
    assert rel_err(pb.encode(TEXTS), jb.encode(TEXTS)) <= REL


def test_hf_tokenizer_matches_jax(hf_dir):
    got = port_tok.make_tokenizer(hf_dir, 0, 3, 2)
    want = jax_tok.make_tokenizer(hf_dir, 0, 3, 2)
    assert isinstance(got, port_tok.HFTokenizer)
    assert got.base_vocab_size == want.base_vocab_size == 128
    assert got.special_to_id == want.special_to_id
    assert min(got.special_to_id.values()) == 128
    assert got.affix_ids() == want.affix_ids()
    text = ("lip balm <|history_item_1_query_0|><|history_item_1_query_1|> "
            "cherry unknownword")
    for t in (text, "a", ""):
        assert got.encode_plain(t) == want.encode_plain(t)
    assert got.encode_plain_batch(TEXTS) == want.encode_plain_batch(TEXTS)
    ids, masks = got.encode_batch([text, "a"], 10)
    j_ids, j_masks = want.encode_batch([text, "a"], 10)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(masks, j_masks)
    with pytest.raises(ValueError, match="failed to load HF tokenizer"):
        port_tok.make_tokenizer(str(hf_dir) + "_missing")


def test_convert_qwen3_matches_jax(hf_dir):
    from transformers import AutoModel

    hf = AutoModel.from_pretrained(hf_dir, torch_dtype=torch.float32)
    sd = hf.state_dict()
    prefixed = {"model." + k: v for k, v in sd.items()}
    for source in (sd, prefixed):
        got = port_convert.convert_qwen3(source, CFG.num_hidden_layers)
        want = jax_convert.convert_qwen3(source, CFG.num_hidden_layers)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    ported = qwen3_state_dict_from_flax(got, CFG)
    for k, v in flax_to_state_dict(want).items():
        assert torch.equal(ported[k], v), k
    with pytest.raises(ValueError, match="layers"):
        qwen3_state_dict_from_flax(got, Qwen3Config(num_hidden_layers=3))


def test_train_joint_hf_path_step_matches_jax(tmp_path):
    """One joint step over a Qwen3 base read from a Hugging Face checkpoint
    (tokenizer included), the port against the JAX trainer; then ``train_cli
    joint --hf-path`` runs one step end to end."""
    words = WORDS + [str(j) for j in range(30)]
    hf = write_hf_qwen3(tmp_path / "hf", QWEN, QWEN.vocab_size, words)
    data = _data()
    ids, emb, masks, item_emb, item_dict, train, _ = data
    fields = [f"f{i}" for i in range(emb.shape[1])]

    def dataset(module, cache_cls, tok_module):
        tok = tok_module.make_tokenizer(hf, 0, JC.num_history_items,
                                        JC.num_query_tokens_per_item)
        return module.JointDataset(train, item_emb, tok, item_dict,
                                   cache_cls(emb, masks, fields, ids), JC,
                                   max_negatives=10,
                                   item_emb_dim=QWEN.hidden_size)

    jds = dataset(jax_train, JaxCache, jax_tok)
    pds = dataset(port_train, FieldEmbeddingCache, port_tok)
    from transformers import AutoModel

    sd = AutoModel.from_pretrained(hf, torch_dtype=torch.float32).state_dict()
    tc = TrainConfig(batch_size=2, optimizer=OPT, mesh=MeshConfig(dp=1))
    jt = jax_train.JointTrainer(QWEN, QF, JC, lora=LORA, train_config=tc)
    jstate = jt.init_state(qwen_params=jax_convert.convert_qwen3(
        sd, QWEN.num_hidden_layers))
    port_sd = joint_state_dict_from_flax(jstate.params, QWEN, QF)
    base = qwen3_state_dict_from_flax(
        port_convert.convert_qwen3(sd, QWEN.num_hidden_layers), QWEN)
    for k, v in base.items():  # the port's reading of the HF base
        assert torch.equal(port_sd["base_model." + k], v), k
    pt = port_train.JointTrainer(QWEN, QF, JC, lora=LORA, train_config=tc,
                                 device="cpu")
    pstate = pt.init_state(params=port_sd)

    idx = next(iter(jax_train.epoch_batches(np.random.default_rng(4),
                                            len(jds), 2)))
    batch, pbatch = jds.batch(idx), pds.batch(idx)
    for k in batch:
        np.testing.assert_array_equal(batch[k], pbatch[k], err_msg=k)
    step = jax.jit(jax_train.make_joint_train_step(jt.model, 0.07,
                                                   return_grads=True))
    _, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    pstep = port_train.make_joint_train_step(pstate.model, return_grads=True)
    _, pm = pstep(port_train.TrainState(pstate.model,
                                        port_train.make_joint_optimizer(
                                            pstate.model, OPT)), pbatch)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=2e-5)
    want = flax_to_state_dict(jm["grads"])
    for name, g in pm["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=5e-3, err_msg=name)

    # the CLI: --tiny's shapes (hidden = the Q-Former's), a 4096-entry
    # tokenizer so the history tokens land on the extra embedding rows
    from unirec_tpu_torch.cli import train_cli
    from unirec_tpu_torch.configs import tiny_qwen3_config

    tiny = tiny_qwen3_config(vocab_size=4096, hidden_size=QF.hidden_size,
                             intermediate_size=1024, num_hidden_layers=2,
                             num_attention_heads=8, num_key_value_heads=4,
                             head_dim=128)
    cli_hf = write_hf_qwen3(tmp_path / "hf_tiny", tiny, 4096, words)
    argv = _cli_files(tmp_path) + ["--hf-path", cli_hf, "--no-remat"]
    argv[argv.index("--num-epochs") + 1] = "1"
    assert train_cli.main(argv) == 0
    from unirec_tpu_torch.utils.checkpoint import load_checkpoint

    state, _ = load_checkpoint(str(tmp_path / "ck" / "latest_model"))
    hf_tiny = AutoModel.from_pretrained(cli_hf, torch_dtype=torch.float32)
    torch.testing.assert_close(
        state["base_model.layers.1.mlp.down_proj.weight"].float(),
        hf_tiny.state_dict()["layers.1.mlp.down_proj.weight"],
        rtol=0, atol=4e-3)  # the frozen base, stored in bf16 (--no-remat)
