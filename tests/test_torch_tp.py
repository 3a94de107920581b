"""The port's tensor parallelism (``parallel/tensor.py``, the tp forms of
``models/qwen3.py``, the joint, item and user trainers at tp > 1, ``train
--tp``) on the CPU, in float32.

Two gloo ranks (``tests/torch_dist_ranks.py``: torch and the port only) are
spawned once for the module as a ``MeshConfig(dp=1, tp=2)`` world; the JAX
references and the port's one-rank runs are computed here meanwhile.  The
joint model is ``tests/test_pipeline.py``'s tiny shape (4 layers, widths 64,
2 history items, LoRA r = 2), parameters from the Flax ``init`` with
``lora_b`` randomised, so that every LoRA leaf has a gradient.

* the deterministic joint and Qwen3 forwards at tp = 2 (K1's plain version
  on the local heads) against the JAX ``model.apply``: max |d| <= 2e-5;
* the first step's gradients, gathered from the shards, against
  ``jax.grad`` of the same InfoNCE loss with dropout off (atol 1e-5, rtol
  5e-3, the joint step's tolerance of ``tests/test_torch_train_joint.py``)
  and against the one-rank port's (1e-4 of each leaf's largest entry), on
  every trainable leaf (``lora_a`` and ``lora_b`` of the column and the row
  layers among them);
* two ``JointTrainer`` steps at tp = 2 against the one-rank steps, with
  ``max_grad_norm`` small enough that clipping binds: losses and the
  gathered parameters within 1e-5; the ranks' replicated parameters bit for
  bit equal; a step at LoRA dropout 0.1 equals the one-rank step (the row
  layers take their columns of the whole mask);
* the evaluation's metrics equal the one-rank ones; a checkpoint written
  at tp = 2 restores at tp = 2 and at tp = 1;
* the item and user trainers at tp = 2 (parameters replicated) step as at
  tp = 1; ``train joint --tp 2`` and ``train user-qformer --tp 2`` as
  torchrun's ranks;
* the refusals: flash-VJP and ``int8_base`` with tp (joint), the fused
  anchor (item), flash and fused (user), a tp that does not divide the KV
  heads.
"""

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_ranks as ranks
from tests.test_torch_dp_train import (
    ITEM,
    SEQ,
    USER,
    _item_batches,
    _port,
    _user_batch,
)
from tests.test_torch_joint import randomize_lora_b
from tests.test_torch_mesh import _user_cli_inputs
from tests.test_torch_train_joint import F, HIDDEN, QF, QWEN, VOCAB, _data
from tests.test_torch_train_joint import _cli_files as _joint_cli_files
from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import JointModelConfig, LoRAConfig
from unirec_tpu.models.joint import MultiModalQwenEmbedding as JaxJoint
from unirec_tpu.models.qwen3 import Qwen3Model as JaxQwen3
from unirec_tpu.ops import losses as jax_losses
from unirec_tpu_torch import configs as pc
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import HashTokenizer
from unirec_tpu_torch.parallel.tensor import (
    TensorParallel,
    shard_state_dict,
    tp_split,
)
from unirec_tpu_torch.train import item_qformer as port_item
from unirec_tpu_torch.train import joint as port_joint
from unirec_tpu_torch.train import user_qformer as port_user
from unirec_tpu_torch.utils.checkpoint import restore_train_state
from unirec_tpu_torch.utils.weights import (
    init_item_qformer,
    init_user_qformer,
    joint_state_dict_from_flax,
)


FWD_ATOL, STEP_TOL = 2e-5, 1e-5
# gradients: against JAX, the joint step's per-leaf tolerance of
# tests/test_torch_train_joint.py (the one-rank port is 8.3e-5 of a leaf's
# largest entry off JAX on the Q-Former's cross-attention query weight, and
# the key biases' true gradient is 0: both sides hold rounding there);
# against the one-rank port, 1e-4 of each leaf's largest entry (the row
# layers' sums split over the ranks move the lora_a leaves by 1.5e-5)
GRAD_ATOL, GRAD_RTOL, GRAD_REL = 1e-5, 5e-3, 1e-4
# and 1e-9 absolute for the leaves of zero true gradient (the key biases)
GRAD_FLOOR = 1e-9
QWEN4 = dataclasses.replace(QWEN, num_hidden_layers=4)
LORA2 = LoRAConfig(r=2, alpha=4.0, dropout=0.0)
JC2 = JointModelConfig(num_history_items=2, num_query_tokens_per_item=2,
                       max_length=32)
# clipping binds: the first step's gradient norm is far above it
MAX_NORM = 1e-3
TEMPERATURE = 0.07


def port_configs(lora=LORA2):
    return (_port(pc.Qwen3Config, QWEN4), _port(pc.ItemQFormerConfig, QF),
            _port(pc.JointModelConfig, JC2), _port(pc.LoRAConfig, lora))


def port_tc(batch_size, dp=1, tp=1):
    return pc.TrainConfig(
        batch_size=batch_size, seed=3,
        optimizer=pc.OptimizerConfig(learning_rate=1e-3,
                                     max_grad_norm=MAX_NORM),
        mesh=pc.MeshConfig(dp=dp, tp=tp))


def joint_datasets(data):
    """The port's train and validation ``JointDataset`` at ``JC2``."""
    ids, emb, masks, item_emb, item_dict, train, val = data
    cache = FieldEmbeddingCache(emb, masks, [f"f{i}" for i in range(F)], ids)
    tok = HashTokenizer(VOCAB, JC2.num_history_items,
                        JC2.num_query_tokens_per_item)
    return tuple(port_joint.JointDataset(s, item_emb, tok, item_dict, cache,
                                         JC2, max_negatives=4,
                                         item_emb_dim=HIDDEN)
                 for s in (train, val))


def jax_joint_reference(batches):
    """The JAX joint model's parameters (``lora_b`` randomised), its
    deterministic output and the Qwen3 hidden states on ``batches[0]``, and
    ``jax.grad`` of InfoNCE on each batch (dropout off)."""
    model = JaxJoint(QWEN4, QF, JC2, lora=LORA2)
    b0 = batches[0]
    keys = ("input_ids", "attention_mask", "history_field_embeddings",
            "history_attention_mask")
    params = randomize_lora_b(jax.jit(model.init)(
        jax.random.PRNGKey(0), *(jnp.asarray(b0[k]) for k in keys)),
        seed=5)["params"]
    user = jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
        params, *(jnp.asarray(b0[k]) for k in keys))
    base = JaxQwen3(QWEN4, lora=LORA2, n_extra_tokens=4)
    hidden = jax.jit(lambda p, i, m: base.apply({"params": p}, i, m))(
        params["base_model"], jnp.asarray(b0["input_ids"]),
        jnp.asarray(b0["attention_mask"]))

    def loss(p, b):
        u = model.apply({"params": p}, *(b[k] for k in keys),
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_losses.info_nce_loss(
            u, b["positive_item_embeddings"], b["negative_item_embeddings"],
            b["negative_masks"], temperature=TEMPERATURE)

    grad = jax.jit(jax.grad(loss))
    grads = joint_state_dict_from_flax(
        grad(params, {k: jnp.asarray(v) for k, v in b0.items()}), QWEN4, QF)
    return (params, np.asarray(user), np.asarray(hidden),
            {n: np.asarray(g) for n, g in grads.items()})


def one_rank_joint(sd, batches, val, lora=LORA2, steps=None):
    """The port's one-rank trainer: the Qwen3 hidden states on
    ``batches[0]`` and the evaluation, then ``steps`` (default: every batch)
    steps with gradients; ((hidden, metrics), [(loss, grads)], state)."""
    trainer = port_joint.JointTrainer(*port_configs(lora),
                                      train_config=port_tc(4), device="cpu")
    state = trainer.init_state(params=sd)
    b = port_joint.batch_to_device(batches[0], torch.device("cpu"))
    with trainer.evaluating(state) as model:
        hidden = model.base_model(input_ids=b["input_ids"],
                                  attention_mask=b["attention_mask"])
    ev = hidden, trainer.evaluate(state, val, batch_size=6, max_negatives=7)
    step = port_joint.make_joint_train_step(state.model, return_grads=True,
                                            seed=3)
    out = []
    for b in batches[:steps]:
        state, m = step(state, b)
        out.append((float(m["loss"]), m["grads"]))
    return ev, out, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp"))
    data = _data()
    train_ds, val_ds = joint_datasets(data)
    batches = [train_ds.batch([0, 1, 2, 3]), train_ds.batch([4, 5, 6, 7])]
    params, user, hidden, grads = jax_joint_reference(batches)
    sd = joint_state_dict_from_flax(params, QWEN4, QF)
    item_cfg, user_cfg = _port(pc.ItemQFormerConfig, ITEM), _port(
        pc.UserQFormerConfig, USER)
    item_sd = init_item_qformer(item_cfg,
                                torch.Generator().manual_seed(0)).state_dict()
    user_sd = init_user_qformer(user_cfg,
                                torch.Generator().manual_seed(0)).state_dict()
    item_batches, user_batch = _item_batches()[:1], _user_batch()
    joint_cli = _joint_cli_files(_mkdir(work, "joint_cli"))
    user_cli = _user_cli_inputs(_mkdir(work, "user_cli"))
    qwen, qf, jc, lora = port_configs()
    inputs = {
        "joint": dict(qwen=qwen, qf=qf, jc=jc, lora=lora, params=sd,
                      tc=port_tc(4, tp=2), batches=batches, val=val_ds),
        "joint_dropout": dict(lora=port_configs(
            dataclasses.replace(LORA2, dropout=0.1))[3]),
        "item": dict(cfg=item_cfg, tc=port_tc(8, tp=2), params=item_sd,
                     batches=item_batches),
        "item_refs": dict(cfg=item_cfg, tc=port_tc(8, tp=2), params=item_sd,
                          batches=item_batches, fused_refs=True),
        "user": dict(cfg=user_cfg, tc=port_tc(4, tp=2), seq=SEQ,
                     params=user_sd, batch=user_batch),
        "cli": [(joint_cli + ["--tp", "2", "--no-remat"], None),
                (user_cli["user_cli_argv"] + ["--tp", "2"],
                 user_cli["user_cli_widths"])],
    }
    torch.save(inputs, os.path.join(work, "tp.inputs.pt"))
    procs = ranks.start_group("tp", 2, work)

    ref = {"jax_user": user, "jax_hidden": hidden, "jax_grads": grads,
           "sd": sd, "work": work, "joint_cli": joint_cli,
           "user_ck": user_cli["user_cli_argv"][-1]}
    (ref["hidden"], ref["eval"]), ref["steps"], ref["state"] = (
        one_rank_joint(sd, batches, val_ds))
    _, ref["dropout"], _ = one_rank_joint(
        sd, batches, val_ds, dataclasses.replace(LORA2, dropout=0.1), 1)
    for key, cls, cfg, bs, params, batch_list, kw in (
            ("item", port_item.ItemQFormerTrainer, item_cfg, 8, item_sd,
             item_batches, dict(fused_reference_forwards=False)),
            ("item_refs", port_item.ItemQFormerTrainer, item_cfg, 8, item_sd,
             item_batches, dict(fused_reference_forwards=True)),
            ("user", port_user.UserQFormerTrainer, user_cfg, 4, user_sd,
             [user_batch], dict(max_seq_len=SEQ))):
        trainer = cls(cfg, port_tc(bs), device="cpu", **kw)
        state = trainer.init_state(params=params)
        if key == "user":
            step = port_user.make_train_step(state.model, return_grads=True,
                                             seed=3)
        else:
            assert trainer.use_fused == (key == "item_refs")
            step = port_item.make_train_step(
                state.model, return_grads=True, seed=3,
                fused_reference_config=cfg if trainer.use_fused else None)
        ref[key] = [ranks._step_result(*step(state, b)) for b in batch_list]
    got = ranks.finish_group("tp", procs, work)
    return ref, got


def _mkdir(root, name) -> Path:
    path = Path(root, name)
    path.mkdir(exist_ok=True)
    return path


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol, err_msg=what)


def test_tp2_forward_matches_jax(runs):
    """The joint output within 2e-5 of JAX's.  The Qwen3 hidden states
    (the final norm's output, up to 3.5 here; the norm scales rounding up
    where a row's pre-norm values are small) within 2e-5 of their largest
    magnitude, against JAX and against the one-rank port: the one-rank
    port is itself 5.2e-5 off JAX, and tp = 2 4.3e-5 off the one-rank
    port."""
    ref, got = runs
    for r in got:
        _close(r["user"], ref["jax_user"], FWD_ATOL, "joint")
        for want in (ref["hidden"].numpy(), ref["jax_hidden"]):
            _close(r["hidden"], want, FWD_ATOL * float(np.abs(want).max()),
                   "qwen3")


def test_tp2_first_step_gradients_match_jax(runs):
    """Every trainable leaf, gathered from the shards, against JAX and the
    one-rank port (see GRAD_*); the LoRA leaves of column and row layers
    all carry gradient."""
    ref, got = runs
    grads = got[0]["steps"][0]["grads"]
    jax_grads = ref["jax_grads"]
    assert set(grads) <= set(jax_grads)
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        for leaf in ("lora_a", "lora_b"):
            names = [n for n in grads if n.endswith(f"{proj}.{leaf}")]
            assert len(names) == QWEN4.num_hidden_layers, (proj, leaf)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jax_grads[name], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
        if "lora" in name:
            assert float(g.abs().max()) > 0, name
    # against the one-rank port's gradients
    for name, g in ref["steps"][0][1].items():
        _close(grads[name], g, GRAD_REL * float(g.abs().max()) + GRAD_FLOOR,
               name)


def _replicated_equal(got):
    for name, t in got[0]["local"].items():
        if tp_split(name) is None:
            assert torch.equal(t, got[1]["local"][name]), name


def test_tp2_steps_match_one_rank(runs):
    ref, got = runs
    norm = float(torch.sqrt(sum((g * g).sum()
                                for g in ref["steps"][0][1].values())))
    assert norm > 10 * MAX_NORM  # clipping binds
    for r in got:
        for mine, (loss, _) in zip(r["steps"], ref["steps"]):
            np.testing.assert_allclose(mine["loss"], loss, rtol=STEP_TOL)
        want = ref["state"].model.state_dict()
        for name, p in r["params"].items():
            _close(p, want[name], STEP_TOL, name)
        for name, mu in ref["state"].optimizer.mu.items():
            _close(r["opt"]["mu"][name], mu, STEP_TOL, f"mu {name}")
    _replicated_equal(got)


def test_tp2_step_with_lora_dropout_matches_one_rank(runs):
    ref, got = runs
    loss, grads = ref["dropout"][0]
    nodrop_loss = ref["steps"][0][0]
    assert abs(loss - nodrop_loss) > 1e-6  # the dropout acted
    for r in got:
        np.testing.assert_allclose(r["dropout"]["loss"], loss, rtol=STEP_TOL)
        for name, g in grads.items():
            _close(r["dropout"]["grads"][name], g,
                   GRAD_REL * float(g.abs().max()) + GRAD_FLOOR, name)


def test_tp2_evaluation_matches_one_rank(runs):
    ref, got = runs
    for r in got:
        assert r["eval"].keys() == ref["eval"].keys()
        for k, v in ref["eval"].items():
            assert r["eval"][k] == pytest.approx(v, abs=1e-6), k


def test_tp2_checkpoint_restores_at_tp2_and_tp1(runs):
    ref, got = runs
    for r in got:
        whole, step, params, mu = r["restored"]
        assert whole and step == 2
        for name, p in r["local"].items():
            assert torch.equal(params[name], p), name
        for name, t in r["local_mu"].items():
            assert torch.equal(mu[name], t), name
    trainer = port_joint.JointTrainer(*port_configs(),
                                      train_config=port_tc(4), device="cpu")
    template = trainer.init_state(seed=11)
    state, meta = restore_train_state(os.path.join(ref["work"], "tp_ck"),
                                      template)
    assert state.step == 2 and meta["grad_accum"] == 1
    for name, p in state.model.state_dict().items():
        assert torch.equal(p, got[0]["params"][name]), name
    for name, t in state.optimizer.mu.items():
        assert torch.equal(t, got[0]["opt"]["mu"][name]), name


@pytest.mark.parametrize("key", ["item", "item_refs", "user"])
def test_item_and_user_tp2_match_one_rank(runs, key):
    """tp replicates these trainers' parameters: the tp = 2 step is the
    one-rank step, and the ranks hold the same parameters.  "item_refs":
    the item step with the fused reference forwards, which stay on under
    tp as under dp."""
    ref, got = runs
    res = [r["user_step"] if key == "user" else r[key][0] for r in got]
    want = ref[key][0]
    for r in res:
        np.testing.assert_allclose(r["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=STEP_TOL)
        for name, p in want["params"].items():
            _close(r["params"][name], p, STEP_TOL, name)
    for name, p in res[0]["params"].items():
        assert torch.equal(p, res[1]["params"][name]), name


def test_train_cli_tp2_as_torchrun_ranks(runs):
    from unirec_tpu_torch.utils.checkpoint import read_meta

    ref, got = runs
    assert [r["cli"] for r in got] == [[0, 0], [0, 0]]
    ck = ref["joint_cli"][ref["joint_cli"].index("--checkpoint-dir") + 1]
    meta = read_meta(os.path.join(ck, "latest_model"))
    assert meta["step"] == 2
    assert read_meta(ref["user_ck"])["step"] > 0


@pytest.mark.parametrize("case", ["flash_vjp", "int8_base", "item_fused",
                                  "user_flash", "user_fused", "kv_heads"])
def test_tp_refusals(case):
    """The JAX package's refusals of tp > 1, and a tp that does not divide
    the KV heads (JAX's ``device_put`` refuses a dim its mesh axis does not
    divide; the port also keeps KV heads whole)."""
    qwen, qf, jc, lora = port_configs()
    if case in ("flash_vjp", "int8_base"):
        flash = case == "flash_vjp"
        with pytest.raises(ValueError, match="is incompatible with tp>1"
                           ) as err:
            port_joint.JointTrainer(
                dataclasses.replace(qwen, flash_vjp_attention=flash), qf, jc,
                lora=lora, train_config=port_tc(4, tp=2),
                int8_base=not flash, device="cpu")
        assert str(err.value).startswith(case)
    elif case == "item_fused":
        with pytest.raises(ValueError, match="fused_training is incompatible"):
            port_item.ItemQFormerTrainer(
                _port(pc.ItemQFormerConfig, ITEM, fused_training=True),
                port_tc(8, tp=2), device="cpu")
    elif case.startswith("user"):
        cfg = _port(pc.UserQFormerConfig, USER,
                    **{f"{case[5:]}_training": True})
        with pytest.raises(ValueError, match="flash_training/fused_training "
                                             "are incompatible with tp>1"):
            port_user.UserQFormerTrainer(cfg, port_tc(4, tp=2), device="cpu")
    else:
        from unirec_tpu_torch.models.qwen3 import Qwen3Attention

        with pytest.raises(ValueError, match="num_key_value_heads=2"):
            Qwen3Attention(qwen, lora, device="meta",
                           tp=TensorParallel(size=4))


def test_tp_plan_and_shards():
    """``tp_split`` is ``tp_spec_for_path`` on the port's layouts, and the
    shards of every rank put back together are the full tensors."""
    cases = {
        "base_model.layers.0.self_attn.q_proj.weight": 0,
        "base_model.layers.0.self_attn.k_proj.lora_b": 1,
        "base_model.layers.0.self_attn.v_proj.lora_a": None,
        "base_model.layers.0.self_attn.o_proj.weight": 1,
        "base_model.layers.0.self_attn.o_proj.lora_a": 0,
        "base_model.layers.0.self_attn.o_proj.lora_b": None,
        "base_model.layers.0.mlp.gate_proj.weight": 0,
        "base_model.layers.0.mlp.up_proj.lora_b": 1,
        "base_model.layers.0.mlp.down_proj.weight": 1,
        "base_model.layers.0.mlp.down_proj.lora_a": 0,
        "base_model.layers.0.self_attn.q_norm.weight": None,
        "base_model.embed_tokens": None, "qformer.query_tokens": None,
    }
    for name, dim in cases.items():
        assert tp_split(name) == dim, name
    full = {n: torch.randn(4, 6) for n in cases}
    shards = [shard_state_dict(full, 2, i) for i in range(2)]
    for name, dim in cases.items():
        if dim is None:
            assert shards[0][name] is full[name]
        else:
            assert torch.equal(torch.cat([s[name] for s in shards], dim),
                               full[name])
    with pytest.raises(ValueError, match="does not divide"):
        shard_state_dict(full, 4, 0)
