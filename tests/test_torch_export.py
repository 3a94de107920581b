"""Port parity: the exporters of ``utils/torch_convert`` and the ``train
export-pth`` / ``export-pretrained`` CLIs against the JAX package's
exporters on the same weights.

Weights come from Flax ``init`` at tiny sizes, bridged into the port's
modules; the port exports from its own ``state_dict`` through
``utils/weights.state_dict_to_flax``.  Every exported state_dict must equal
the JAX exporter's key for key and bit for bit (``np.array_equal`` with
equal dtypes, ``torch.equal`` for saved files): Item Q-Former, User
Q-Former, MWNE, the joint model and the ``save_pretrained`` directory.  The
port's ``convert_*`` read the exports back to the trees they came from.
The CLIs run on checkpoint directories of ``utils/checkpoint.py``; the
directory's adapter loads through ``peft.PeftModel.from_pretrained`` onto a
tiny resized Hugging Face Qwen3, as ``tests/test_cli.py`` loads the JAX
one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_joint import (
    JC,
    QF,
    QWEN,
    joint_inputs,
    randomize_lora_b,
)
from unirec_tpu.models import joint as jax_joint
from unirec_tpu import configs as jcfgs
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.models.user_qformer import UserQFormer as JaxUserQFormer
from unirec_tpu.train.mwne import MWNETrainer as JaxMWNETrainer
from unirec_tpu.utils import torch_convert as jtc
from unirec_tpu_torch import configs as pcfgs
from unirec_tpu_torch.cli import train_cli
from unirec_tpu_torch.models import joint as port_joint
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.models.user_qformer import UserQFormer
from unirec_tpu_torch.train.mwne import MWNEModel
from unirec_tpu_torch.utils import torch_convert as ptc
from unirec_tpu_torch.utils.checkpoint import save_checkpoint
from unirec_tpu_torch.utils.weights import (
    flax_to_state_dict,
    joint_state_dict_from_flax,
    state_dict_to_flax,
)

ITEM = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, num_query_tokens=4, field_embedding_dim=16,
            num_fields=3, dropout=0.1)
USER = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, num_query_tokens=4, input_embedding_dim=16,
            num_item_tokens_to_predict=2, dropout=0.1)
MWNE = dict(embedding_dim=48, num_frequencies=8)
FIELDS = ["title", "price", "brand"]


def _same_arrays(got, want):
    assert list(got) == list(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and np.array_equal(g, w), key


def _same_tensors(got, want):
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def _same_trees(got, want, exact=True):
    """Equal leaves; with ``exact=False`` ``got`` may hold more (a read-back
    of an export carries the zero text FFNs the export synthesises)."""
    if isinstance(want, dict):
        assert set(got) == set(want) if exact else set(want) <= set(got)
        for key in want:
            _same_trees(got[key], want[key], exact)
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def item():
    jm = JaxItemQFormer(jcfgs.ItemQFormerConfig(**ITEM))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16)),
                     jnp.ones((1, 3)))
    pm = ItemQFormer(pcfgs.ItemQFormerConfig(**ITEM))
    pm.load_state_dict(flax_to_state_dict(params))
    return jax.tree_util.tree_map(np.asarray, params["params"]), pm


@pytest.fixture(scope="module")
def user():
    jm = JaxUserQFormer(jcfgs.UserQFormerConfig(**USER))
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 6, 16)),
                     jnp.ones((1, 6)))
    pm = UserQFormer(pcfgs.UserQFormerConfig(**USER))
    pm.load_state_dict(flax_to_state_dict(params))
    return jax.tree_util.tree_map(np.asarray, params["params"]), pm


def test_state_dict_to_flax_inverts_the_bridge(item):
    params, pm = item
    _same_trees(state_dict_to_flax(pm.state_dict()), params)


def test_item_export_matches_jax_and_reads_back(item, tmp_path):
    params, pm = item
    cfg_j, cfg_p = jcfgs.ItemQFormerConfig(**ITEM), pcfgs.ItemQFormerConfig(**ITEM)
    tree = state_dict_to_flax(pm.state_dict())
    want = jtc.export_item_qformer(params, cfg_j)
    got = ptc.export_item_qformer(tree, cfg_p)
    _same_arrays(got, want)
    back = ptc.convert_item_qformer(got, cfg_p)
    _same_trees(back["query_embeddings"], params["query_embeddings"])
    _same_trees(back["qformer"]["encoder"], params["qformer"]["encoder"],
                exact=False)
    jtc.save_reference_item_qformer_checkpoint(str(tmp_path / "j.pth"),
                                               params, cfg_j, FIELDS)
    ptc.save_reference_item_qformer_checkpoint(str(tmp_path / "p.pth"), tree,
                                               cfg_p, FIELDS)
    j = torch.load(tmp_path / "j.pth", weights_only=False)
    p = torch.load(tmp_path / "p.pth", weights_only=False)
    _same_tensors(p["model_state_dict"], j["model_state_dict"])
    assert p["field_names"] == j["field_names"] == FIELDS
    assert p["config"].to_dict() == j["config"].to_dict()


def test_user_export_matches_jax_and_reads_back(user, tmp_path):
    params, pm = user
    cfg_j, cfg_p = jcfgs.UserQFormerConfig(**USER), pcfgs.UserQFormerConfig(**USER)
    tree = state_dict_to_flax(pm.state_dict())
    want = jtc.export_user_qformer(params, cfg_j)
    got = ptc.export_user_qformer(tree, cfg_p)
    _same_arrays(got, want)
    back = ptc.convert_user_qformer(got, cfg_p)
    _same_trees(back["head_norm"], params["head_norm"])
    _same_trees(back["qformer"]["encoder"], params["qformer"]["encoder"],
                exact=False)
    jtc.save_reference_user_qformer_checkpoint(str(tmp_path / "j.pth"),
                                               params, cfg_j, 3, 0.5)
    ptc.save_reference_user_qformer_checkpoint(str(tmp_path / "p.pth"), tree,
                                               cfg_p, 3, 0.5)
    j = torch.load(tmp_path / "j.pth", weights_only=False)
    p = torch.load(tmp_path / "p.pth", weights_only=False)
    _same_tensors(p["model_state_dict"], j["model_state_dict"])
    assert (p["epoch"], p["loss"]) == (j["epoch"], j["loss"]) == (3, 0.5)


def test_mwne_export_matches_jax():
    jtr = JaxMWNETrainer(jcfgs.MWNEConfig(**MWNE), seed=0)
    model = MWNEModel(pcfgs.MWNEConfig(**MWNE))
    model.load_state_dict(flax_to_state_dict(jtr.params))
    tree = state_dict_to_flax(model.state_dict())
    metrics = {"additivity_mse": 0.25}
    want = jtc.export_mwne(jcfgs.MWNEConfig(**MWNE),
                           {"base": jtr.params["encoder"]}, metrics)
    got = ptc.export_mwne(pcfgs.MWNEConfig(**MWNE), {"base": tree["encoder"]},
                          metrics)
    _same_arrays(got["encoder_state_dict"], want["encoder_state_dict"])
    for key in ("encoder_config", "normalization_config", "final_metrics"):
        assert got[key] == want[key]
    cfg, variables = ptc.convert_mwne(got)
    assert cfg == pcfgs.MWNEConfig(**MWNE)
    _same_trees(variables["params"]["base"],
                jax.tree_util.tree_map(np.asarray, jtr.params["encoder"]))


@pytest.fixture(scope="module")
def joint():
    """A JAX joint model at the LoRA rank `train joint` trains at
    (``LoRAConfig()``, which the directory's adapter_config.json states),
    ``lora_b`` made nonzero, and the port's on the same weights."""
    jm = jax_joint.MultiModalQwenEmbedding(QWEN, QF, JC,
                                           lora=jcfgs.LoRAConfig(dropout=0.0))
    ids, mask, hist, hmask = joint_inputs(np.random.RandomState(3), 1)
    params = randomize_lora_b(jm.init(
        jax.random.PRNGKey(3), jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(hist), jnp.asarray(hmask)))
    pm = port_joint.MultiModalQwenEmbedding(
        QWEN, QF, JC, lora=pcfgs.LoRAConfig(dropout=0.0))
    pm.load_state_dict(joint_state_dict_from_flax(params, QWEN, QF))
    return params, pm


def test_joint_export_matches_jax(joint):
    params, pm = joint
    tree = state_dict_to_flax(pm.state_dict())
    want = jtc.export_joint_model(params["params"], QWEN, QF)
    got = ptc.export_joint_model(tree, QWEN, QF)
    _same_arrays(got, want)
    back = ptc.convert_joint_model(got, QWEN, QF)
    _same_trees(back["base_model"], params["params"]["base_model"])


def test_export_pth_cli_matches_jax(item, user, tmp_path):
    params, pm = item
    save_checkpoint(str(tmp_path / "item"), pm,
                    config=pcfgs.ItemQFormerConfig(**ITEM),
                    extra={"field_names": FIELDS})
    assert train_cli.main(["export-pth", "--checkpoint", str(tmp_path / "item"),
                           "--output", str(tmp_path / "item.pth")]) == 0
    got = torch.load(tmp_path / "item.pth", weights_only=False)
    jtc.save_reference_item_qformer_checkpoint(
        str(tmp_path / "jitem.pth"), params,
        jcfgs.ItemQFormerConfig(**ITEM), FIELDS)
    want = torch.load(tmp_path / "jitem.pth", weights_only=False)
    _same_tensors(got["model_state_dict"], want["model_state_dict"])
    # the reference .pth reads back through the port's reader
    _, sd, names = _read_item(tmp_path / "item.pth")
    assert names == FIELDS
    for key, value in pm.state_dict().items():
        assert torch.equal(sd[key], value), key

    uparams, upm = user
    stage = {f"user.{k}": v for k, v in upm.state_dict().items()}
    save_checkpoint(str(tmp_path / "user"), stage,
                    config=pcfgs.UserQFormerConfig(**USER),
                    extra={"epoch": 2, "loss": 0.75})
    assert train_cli.main(["export-pth", "--stage", "user", "--checkpoint",
                           str(tmp_path / "user"), "--output",
                           str(tmp_path / "user.pth")]) == 0
    got = torch.load(tmp_path / "user.pth", weights_only=False)
    jtc.save_reference_user_qformer_checkpoint(
        str(tmp_path / "juser.pth"), uparams,
        jcfgs.UserQFormerConfig(**USER), 2, 0.75)
    want = torch.load(tmp_path / "juser.pth", weights_only=False)
    _same_tensors(got["model_state_dict"], want["model_state_dict"])
    assert (got["epoch"], got["loss"]) == (2, 0.75)


def _read_item(path):
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference

    return QFormerInference.read_checkpoint(str(path))


def test_export_pth_cli_mwne_matches_jax(tmp_path, capsys):
    ckpt = tmp_path / "mwne"
    assert train_cli.main(["mwne", "--embedding-dim", "48", "--num-frequencies",
                           "8", "--num-steps", "3", "--device", "cpu",
                           "--checkpoint-dir", str(ckpt)]) == 0
    capsys.readouterr()
    assert train_cli.main(["export-pth", "--stage", "mwne", "--checkpoint",
                           str(ckpt), "--output", str(tmp_path / "m.pth")]) == 0
    got = torch.load(tmp_path / "m.pth", weights_only=False)
    sd = torch.load(ckpt / "params.pt", weights_only=True)
    meta = json.loads((ckpt / "meta.json").read_text())
    jtc.save_reference_mwne_checkpoint(
        str(tmp_path / "j.pth"), jcfgs.MWNEConfig(**MWNE),
        {"base": state_dict_to_flax(sd)["encoder"]},
        final_metrics=meta["final_metrics"])
    want = torch.load(tmp_path / "j.pth", weights_only=False)
    _same_tensors(got["encoder_state_dict"], want["encoder_state_dict"])
    assert got["final_metrics"] == want["final_metrics"]


def test_export_pretrained_cli_matches_jax_and_loads_in_peft(joint,
                                                           tmp_path):
    peft = pytest.importorskip("peft")
    from transformers import Qwen3Config as HFQwen3Config
    from transformers import Qwen3Model

    params, pm = joint
    ckpt = tmp_path / "joint" / "latest_model"
    save_checkpoint(str(ckpt), pm, config=pcfgs.JointModelConfig(),
                    extra=train_cli._joint_cfg_meta(QWEN, QF))
    out = tmp_path / "saved"
    assert train_cli.main(["export-pretrained", "--checkpoint",
                           str(tmp_path / "joint"), "--output", str(out)]) == 0
    jout = tmp_path / "jsaved"
    jtc.save_pretrained_directory(str(jout), params["params"], QWEN, QF)
    for name in ("adapter_model.bin", "qformer_model.bin"):
        _same_tensors(torch.load(out / name, weights_only=True),
                      torch.load(jout / name, weights_only=True))
    for name in ("adapter_config.json", "model_config.json"):
        got = json.loads((out / name).read_text())
        want = json.loads((jout / name).read_text())
        if "target_modules" in want:
            assert sorted(got.pop("target_modules")) == sorted(
                want.pop("target_modules"))
        assert got == want, name
    base = Qwen3Model(HFQwen3Config(
        vocab_size=QWEN.vocab_size, hidden_size=QWEN.hidden_size,
        intermediate_size=QWEN.intermediate_size,
        num_hidden_layers=QWEN.num_hidden_layers,
        num_attention_heads=QWEN.num_attention_heads,
        num_key_value_heads=QWEN.num_key_value_heads,
        head_dim=QWEN.head_dim, attention_bias=False))
    base.resize_token_embeddings(QWEN.vocab_size + 20)
    loaded = peft.PeftModel.from_pretrained(base, str(out))
    adapter = torch.load(out / "adapter_model.bin", weights_only=True)
    state = loaded.state_dict()
    for key, value in adapter.items():
        attached = key.replace(".weight", ".default.weight")
        assert torch.equal(state[attached], value), key
    assert os.path.exists(out / "qformer_model.bin")
