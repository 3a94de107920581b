"""Port parity: joint training (``unirec_tpu_torch/train/joint.py`` and what
it runs) against ``unirec_tpu`` on the CPU, fp32, dropout 0 unless a test
says otherwise.

* the Qwen3 training forward and its gradients with flash-VJP attention (the
  JAX Pallas kernels in interpret mode), with the XLA path, and under remat
  ("dots"), parameters from Flax ``init`` with ``lora_b`` randomised, through
  the weight bridge: hidden atol 2e-5, rtol 1e-4 (as
  ``tests/test_flash_causal.py`` holds the JAX kernels to XLA); gradients
  rtol 1e-3 plus 1e-4 of the leaf's largest entry (the normalised output
  makes the embedding rows' gradients large, their small entries noisy);
* one joint step's loss (rtol 2e-5) and per-leaf gradients (atol 1e-5, rtol
  5e-3, as ``tests/test_train_step_parity.py``) against the JAX
  ``make_joint_train_step``, and a 20-step loss trajectory of the port's
  ``JointTrainer`` against the JAX ``JointTrainer`` over one ``JointDataset``
  and the same batches (rtol 1e-3);
* ``info_nce_loss`` (rtol 1e-6; 1e-2 for a bf16 user), ``rank_of_positive`` with ties (exact) and
  ``evaluate``'s metrics (1e-9) against the JAX functions;
* the dropout masks are the same when remat recomputes a layer; the train
  state checkpoint round-trips; ``train_cli joint --tiny --device cpu`` runs
  end to end.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_joint import randomize_lora_b
from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    MeshConfig,
    OptimizerConfig,
    Qwen3Config,
    TrainConfig,
)
from unirec_tpu.data.cache import FieldEmbeddingCache as JaxCache
from unirec_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from unirec_tpu.models.joint import MultiModalQwenEmbedding as JaxJoint
from unirec_tpu.models.qwen3 import Qwen3Model as JaxQwen3
from unirec_tpu.ops import losses as jax_losses
from unirec_tpu.ops import ranking as jax_ranking
from unirec_tpu.train import joint as jax_train
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import HashTokenizer
from unirec_tpu_torch.models.qwen3 import Qwen3Model
from unirec_tpu_torch.ops import losses, ranking
from unirec_tpu_torch.ops.dropout import DropoutStream
from unirec_tpu_torch.train import joint as port_train
from unirec_tpu_torch.utils.checkpoint import (
    check_grad_accum,
    restore_train_state,
    resume_train_state,
    save_train_state,
)
from unirec_tpu_torch.utils.weights import flax_to_state_dict, joint_state_dict_from_flax


VOCAB, HIDDEN, FFN, LAYERS, HEADS, WIDTH, F = 128, 64, 128, 2, 4, 48, 6
QWEN = Qwen3Config(vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
                   num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                   num_key_value_heads=2, head_dim=16, flash_attention=False)
QF = ItemQFormerConfig(hidden_size=HIDDEN, num_hidden_layers=LAYERS,
                       num_attention_heads=HEADS, intermediate_size=FFN,
                       num_query_tokens=2, field_embedding_dim=WIDTH,
                       num_fields=F, dropout=0.0)
LORA = LoRAConfig(r=4, alpha=8.0, dropout=0.0)
QWEN_LORA = LoRAConfig(r=2, dropout=0.0)
JC = JointModelConfig(max_length=48)
OPT = OptimizerConfig(learning_rate=1e-3, warmup_steps=3, max_grad_norm=1.0)
HIDDEN_ATOL, GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4, 1e-3


# -- the Qwen3 training path ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_qwen3(flash_vjp: bool):
    """The JAX Qwen3 training forward and gradients of sum(h * ct)."""
    cfg = dataclasses.replace(QWEN, flash_vjp_attention=flash_vjp)
    rng = np.random.RandomState(3)
    ids = rng.randint(0, VOCAB, (2, 24))
    mask = np.ones((2, 24), np.float32)
    mask[0, 20:] = 0.0
    # a random cotangent: sum(h ** 2) of an RMSNorm output is constant
    ct = rng.randn(2, 24, HIDDEN).astype(np.float32)
    jm = JaxQwen3(cfg, lora=QWEN_LORA)
    params = randomize_lora_b(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)))

    def loss(p):
        h = jm.apply(p, jnp.asarray(ids), jnp.asarray(mask), deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(h * ct), h

    (_, h_jax), g_jax = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return cfg, ids, mask, ct, params, np.asarray(h_jax), g_jax


@pytest.mark.parametrize("case", ["flash_vjp", "xla", "flash_vjp_remat_dots"])
def test_qwen3_training_path_matches_jax(case):
    cfg, ids, mask, ct, params, h_jax, g_jax = _jax_qwen3(case != "xla")
    lora = QWEN_LORA
    remat = case.endswith("remat_dots")
    pm = Qwen3Model(cfg, lora, remat=remat,
                    remat_policy="dots" if remat else None)
    pm.load_state_dict(flax_to_state_dict(params))
    pm.train()
    h = pm(torch.tensor(ids), torch.tensor(mask), dropout=DropoutStream(1, 0))
    (h * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_jax),
                               atol=HIDDEN_ATOL, rtol=1e-4)
    want = flax_to_state_dict(g_jax)
    got = dict(pm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(ref).max(),
                                   err_msg=name)


# -- the joint step and the trainer ---------------------------------------------


def _data(seed=13, n_items=30, n_train=12, n_val=5):
    """A field cache, candidate embeddings, item dict and samples, numpy."""
    rng = np.random.RandomState(seed)
    ids = [f"i{j}" for j in range(n_items)]
    emb = rng.randn(n_items, F, WIDTH).astype(np.float32)
    masks = (rng.rand(n_items, F) > 0.3).astype(np.float32)
    masks[:, 0] = 1.0
    item_emb = {i: rng.randn(HIDDEN).astype(np.float32).tolist() for i in ids}
    item_dict = {i: {"title": f"item {j} {'ab' * (j % 5)}"}
                 for j, i in enumerate(ids)}

    def samples(m):
        out = []
        for _ in range(m):
            cand = list(rng.choice(ids, 6, replace=False))
            hist = list(rng.choice(ids, rng.randint(1, 6), replace=False))
            out.append({"history": hist, "candidate": cand,
                        "ground_truth": cand[rng.randint(6)]})
        return out

    return ids, emb, masks, item_emb, item_dict, samples(n_train), \
        samples(n_val)


def _datasets(module, cache_cls, tok_cls, data):
    ids, emb, masks, item_emb, item_dict, train, val = data
    cache = cache_cls(emb, masks, [f"f{i}" for i in range(F)], ids)
    tok = tok_cls(VOCAB, JC.num_history_items, JC.num_query_tokens_per_item)
    return tuple(module.JointDataset(s, item_emb, tok, item_dict, cache, JC,
                                     max_negatives=10, item_emb_dim=HIDDEN)
                 for s in (train, val))


@pytest.fixture(scope="module")
def joint_setup():
    jax_model = JaxJoint(QWEN, QF, JC, lora=LORA)
    b = {"input_ids": jnp.zeros((2, JC.max_length), jnp.int32),
         "attention_mask": jnp.ones((2, JC.max_length)),
         "history_field_embeddings": jnp.zeros((2, JC.num_history_items, F,
                                                WIDTH)),
         "history_attention_mask": jnp.ones((2, JC.num_history_items, F))}
    params = randomize_lora_b(
        jax.jit(jax_model.init)(jax.random.PRNGKey(0), *b.values()),
        seed=5)["params"]
    data = _data()
    return params, data


def _port_trainer(**kw):
    return port_train.JointTrainer(
        QWEN, QF, JC, lora=LORA,
        train_config=TrainConfig(batch_size=2, optimizer=OPT,
                                 mesh=MeshConfig(dp=1)),
        device="cpu", **kw)


def test_joint_step_grads_trajectory_and_eval_match_jax(joint_setup):
    params, data = joint_setup
    jtrain, jval = _datasets(jax_train, JaxCache, JaxHashTokenizer, data)
    ptrain, pval = _datasets(port_train, FieldEmbeddingCache, HashTokenizer,
                             data)
    jt = jax_train.JointTrainer(
        QWEN, QF, JC, lora=LORA,
        train_config=TrainConfig(batch_size=2, optimizer=OPT,
                                 mesh=MeshConfig(dp=1)))
    # the trainer's own state (its jitted step knows this tree), with the
    # shared parameters in place of its seed's; the moments start at zero
    jstate = jt.init_state().replace(params=jax.tree_util.tree_map(
        jnp.asarray, params))
    pt = _port_trainer()
    pstate = pt.init_state(params=joint_state_dict_from_flax(params, QWEN, QF))
    assert not pstate.model.base_model.layers[0].mlp.up_proj.weight.requires_grad
    assert pstate.model.qformer.query_embeddings.requires_grad

    # the same batches from both datasets
    first = np.random.default_rng(4)
    idx = next(iter(jax_train.epoch_batches(first, len(jtrain), 2)))
    batch = jtrain.batch(idx)
    pbatch = ptrain.batch(idx)
    for k in batch:
        np.testing.assert_array_equal(batch[k], pbatch[k], err_msg=k)

    # one step: loss and every trainable leaf's gradient
    step = jax.jit(jax_train.make_joint_train_step(jt.model, 0.07,
                                                   return_grads=True))
    _, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    pstep = port_train.make_joint_train_step(pstate.model, return_grads=True)
    _, pm = pstep(port_train.TrainState(pstate.model,
                                        port_train.make_joint_optimizer(
                                            pstate.model, OPT)), pbatch)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=2e-5)
    want = flax_to_state_dict(jm["grads"])
    assert set(pm["grads"]) == {n for n in want if port_train.is_trainable(n)}
    for name, g in pm["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=5e-3, err_msg=name)

    # evaluation metrics at the shared starting point
    pstate = pt.init_state(params=joint_state_dict_from_flax(params, QWEN, QF))
    ev_j, ev_p = jt.evaluate(jstate, jval), pt.evaluate(pstate, pval)
    assert ev_j.keys() == ev_p.keys()
    for k in ev_j:
        assert ev_p[k] == pytest.approx(ev_j[k], abs=1e-9), k

    # a 20-step trajectory over the same shuffled batches
    traj = {}
    for name, trainer, state, ds in (("jax", jt, jstate, jtrain),
                                     ("port", pt, pstate, ptrain)):
        losses_ = []
        trainer.train_steps(state, ds, np.random.default_rng(4), num_steps=20,
                            step_hook=lambda s, st, m: losses_.append(
                                m["loss"]))
        traj[name] = losses_
    assert len(traj["port"]) == 20
    np.testing.assert_allclose(traj["port"], traj["jax"], rtol=1e-3, atol=1e-5)


def test_info_nce_and_ranking_match_jax():
    rng = np.random.RandomState(2)
    b, n, d = 5, 7, 16
    u, p = rng.randn(b, d).astype(np.float32), rng.randn(b, d).astype(np.float32)
    neg = rng.randn(b, n, d).astype(np.float32)
    mask = (rng.rand(b, n) > 0.3).astype(np.float32)
    neg[0, 2] = p[0] * 3.0  # a negative tied with the positive
    mask[0, 2] = 1.0
    neg[1, 4] = p[1] * 2.0  # a tie behind a mask
    mask[1, 4] = 0.0
    t = [torch.tensor(a) for a in (u, p, neg, mask)]
    j = [jnp.asarray(a) for a in (u, p, neg, mask)]
    np.testing.assert_allclose(float(losses.info_nce_loss(*t)),
                               float(jax_losses.info_nce_loss(*j)), rtol=1e-6)
    ranks = ranking.rank_of_positive(*t).numpy()
    np.testing.assert_array_equal(ranks,
                                  np.asarray(jax_ranking.rank_of_positive(*j)))
    assert ranks[0] == 1 + int((np.einsum("d,nd->n", u[0], neg[0]) /
                                np.linalg.norm(neg[0], axis=-1) >
                                u[0] @ p[0] / np.linalg.norm(p[0]))[
                                    mask[0] > 0].sum())
    got = ranking.ranking_metrics(*t)
    want = jax_ranking.ranking_metrics(*j)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    # a bf16 user embedding against float32 candidates (the trainer's
    # case): promoted as JAX promotes; the two frameworks round the bf16
    # normalisation differently, which 1/temperature amplifies (rtol 1e-2)
    bf = torch.tensor(u).bfloat16()
    np.testing.assert_allclose(
        float(losses.info_nce_loss(bf, *t[1:])),
        float(jax_losses.info_nce_loss(jnp.asarray(u, jnp.bfloat16), *j[1:])),
        rtol=1e-2)


def test_other_losses_match_jax():
    rng = np.random.RandomState(4)
    rec, tgt = (rng.randn(3, 5, 8).astype(np.float32) for _ in range(2))
    fmask = (rng.rand(3, 5) > 0.4).astype(np.float32)
    a, p_, n_ = (rng.randn(3, 8).astype(np.float32) for _ in range(3))
    out = {"reconstructed_fields": rec, "item_representation": a}
    got = losses.item_qformer_loss(
        {k: torch.tensor(v) for k, v in out.items()}, torch.tensor(tgt),
        torch.tensor(fmask), torch.tensor(p_), torch.tensor(n_))
    want = jax_losses.item_qformer_loss(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(tgt),
        jnp.asarray(fmask), jnp.asarray(p_), jnp.asarray(n_))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.mse_loss(torch.tensor(rec), torch.tensor(tgt))),
        float(jax_losses.mse_loss(jnp.asarray(rec), jnp.asarray(tgt))),
        rtol=1e-6)


# -- dropout, remat, checkpoints, the CLI -----------------------------------------


@pytest.mark.parametrize("grouped", [False, True], ids=["per_projection",
                                                        "grouped"])
def test_dropout_masks_survive_remat_recompute(grouped):
    """LoRA dropout 0.5: a remat run (the layer recomputed in the backward)
    gives the gradients of a run that keeps its activations, and another
    step draws other masks."""
    torch.manual_seed(0)
    lora = LoRAConfig(r=4, dropout=0.5, grouped=grouped)
    cfg = dataclasses.replace(QWEN, flash_vjp_attention=True)
    ids = torch.randint(0, VOCAB, (2, 16))
    grads, outs = [], []
    for remat, step in ((False, 0), ("dots", 0), (True, 0), (False, 1)):
        torch.manual_seed(1)
        m = Qwen3Model(cfg, lora, remat=bool(remat),
                       remat_policy="dots" if remat == "dots" else None)
        with torch.no_grad():
            for p in m.parameters():
                p.normal_(0, 0.05)
        m.train()
        h = m(ids, dropout=DropoutStream(7, step))
        h.square().sum().backward()
        outs.append(h.detach())
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
    for other in grads[1:3]:
        for n in grads[0]:
            torch.testing.assert_close(other[n], grads[0][n], atol=1e-6,
                                       rtol=1e-5, msg=n)
    assert not torch.allclose(outs[3], outs[0])  # step 1 draws other masks
    torch.manual_seed(1)
    m.eval()
    with torch.no_grad():
        assert not torch.allclose(m(ids), outs[3])  # dropout is training-only


def test_qformer_training_dropout_and_fused_refusal():
    from unirec_tpu_torch.models.item_qformer import ItemQFormer

    cfg = dataclasses.replace(QF, dropout=0.2)
    torch.manual_seed(0)
    model = ItemQFormer(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.1)
    x, mask = torch.randn(3, F, WIDTH), torch.ones(3, F)
    model.train()
    a = model.query_outputs(x, mask, dropout=DropoutStream(1, 2))
    b = model.query_outputs(x, mask, dropout=DropoutStream(1, 2))
    c = model.query_outputs(x, mask, dropout=DropoutStream(1, 3))
    model.eval()
    d = model.query_outputs(x, mask)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert not torch.allclose(a, d)
    # fused_training takes the trainable fused blocks (B12s / B12c, their
    # plain versions on the CPU): the same forward as the plain path at
    # dropout 0, where it used to be refused
    plain = ItemQFormer(dataclasses.replace(cfg, dropout=0.0)).train()
    fused = ItemQFormer(dataclasses.replace(cfg, fused_training=True,
                                            dropout=0.0)).train()
    fused.load_state_dict(model.state_dict())
    plain.load_state_dict(model.state_dict())
    torch.testing.assert_close(
        fused.query_outputs(x, mask, dropout=DropoutStream(1, 0)),
        plain.query_outputs(x, mask, dropout=DropoutStream(1, 0)),
        atol=1e-5, rtol=1e-5)


def test_train_state_checkpoint_round_trip(joint_setup, tmp_path):
    params, data = joint_setup
    ptrain, _ = _datasets(port_train, FieldEmbeddingCache, HashTokenizer, data)
    opt = dataclasses.replace(OPT, gradient_accumulation_steps=2)
    mk = lambda: port_train.JointTrainer(  # noqa: E731
        QWEN, QF, JC, lora=LORA, device="cpu",
        train_config=TrainConfig(batch_size=2, optimizer=opt))
    a_tr = mk()
    a = a_tr.init_state(params=joint_state_dict_from_flax(params, QWEN, QF))
    a, _ = a_tr.train_steps(a, ptrain, np.random.default_rng(0), num_steps=3)
    save_train_state(str(tmp_path / "ck"), a, config=JC,
                     extra={"grad_accum": 2})
    b_tr = mk()
    b, meta = restore_train_state(str(tmp_path / "ck"), b_tr.init_state(seed=9))
    assert b.step == a.step == 3 and meta["grad_accum"] == 2
    assert b.optimizer.mini_step == a.optimizer.mini_step == 1
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    for t in (a, b):  # the same next step from both
        tr = a_tr if t is a else b_tr
        tr.train_steps(t, ptrain, np.random.default_rng(1), num_steps=1)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="accumulation"):
        check_grad_accum(meta, 1)
    with pytest.raises(FileNotFoundError):
        resume_train_state(str(tmp_path / "none"), b)


def _cli_files(tmp_path):
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint
    from unirec_tpu_torch.utils.weights import init_item_qformer

    ids, emb, masks, item_emb, item_dict, train, val = _data(n_items=20)
    cfg = dataclasses.replace(QF, field_embedding_dim=WIDTH)
    qf = init_item_qformer(cfg, torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "iq"), qf, cfg,
                    extra={"field_names": [f"f{i}" for i in range(F)]})
    FieldEmbeddingCache(emb, masks, [f"f{i}" for i in range(F)], ids).save(
        str(tmp_path / "cache"))
    for name, obj in (("emb", item_emb), ("items", item_dict), ("train", train),
                      ("val", val)):
        (tmp_path / f"{name}.json").write_text(json.dumps(obj))
    return ["joint", "--train-data", str(tmp_path / "train.json"),
            "--val-data", str(tmp_path / "val.json"),
            "--item-emb", str(tmp_path / "emb.json"),
            "--item-dict", str(tmp_path / "items.json"),
            "--qformer-checkpoint", str(tmp_path / "iq"),
            "--cache-dir", str(tmp_path / "cache"), "--tiny",
            "--device", "cpu", "--max-length", "48", "--batch-size", "4",
            "--num-epochs", "1", "--eval-every-steps", "2",
            "--checkpoint-dir", str(tmp_path / "ck")]


def test_train_cli_joint_tiny_end_to_end(tmp_path, capsys):
    from unirec_tpu_torch.cli import train_cli
    from unirec_tpu_torch.utils.checkpoint import read_meta

    argv = _cli_files(tmp_path)
    assert train_cli.main(argv + ["--flash-vjp", "--no-remat"]) == 0
    out = capsys.readouterr().out
    assert "initial eval:" in out and "final eval:" in out
    latest = tmp_path / "ck" / "latest_model"
    meta = read_meta(str(latest))
    assert meta["step"] == 2 and meta["qwen_config"]["flash_vjp_attention"]
    assert (tmp_path / "ck" / "metrics.jsonl").exists()
    assert train_cli.main(argv + ["--flash-vjp", "--no-remat",
                                  "--resume"]) == 0
    assert "resumed from" in capsys.readouterr().out
    # three more steps, evaluated at 3 and 5 (the tracker restarts from 0,
    # as the JAX CLI's does)
    assert read_meta(str(latest))["step"] == 5
    assert train_cli.main(argv + ["--int8-base", "--lora-grouped",
                                  "--grad-accum", "2"]) == 0


@pytest.mark.parametrize("extra,error,match", [
    # --dp, --tp and --pp are ported (tests/test_torch_mesh.py,
    # tests/test_torch_tp.py, tests/test_torch_pipeline.py); the JAX
    # package's refusals of their combinations stay
    (["--pp", "2", "--tp", "2"], ValueError, "composes with dp only"),
    (["--dp", "2", "--tp", "2", "--int8-base"], ValueError,
     "int8_base is incompatible with tp>1"),
    (["--tp", "2", "--flash-vjp"], ValueError,
     "flash_vjp_attention is incompatible with tp>1"),
    # --hf-path is ported (tests/test_torch_text_backend.py); a path that
    # holds no checkpoint is refused, not replaced by hash tokens
    (["--hf-path", "somewhere"], ValueError, "somewhere")],
    ids=["extra0-A9", "extra1-A9", "extra2-A9", "extra3-hf-path"])
def test_train_cli_refuses_what_is_not_ported(tmp_path, extra, error, match):
    from unirec_tpu_torch.cli import train_cli

    with pytest.raises(error, match=match):
        train_cli.main(_cli_files(tmp_path) + extra)


def test_train_cli_other_subcommands_are_not_ported(capsys):
    """Every subcommand of the JAX CLI is ported: ``mwne`` parses its own
    flags and refuses another, as argparse does."""
    from unirec_tpu_torch.cli import train_cli

    with pytest.raises(SystemExit) as exit_info:
        train_cli.main(["mwne", "--history", "x"])
    assert exit_info.value.code == 2
    assert "--history" in capsys.readouterr().err
