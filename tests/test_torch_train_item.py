"""Item Q-Former training (``train/item_qformer.py``, ``eval/
reconstruction.py``, ``train_cli item-qformer / evaluate / precompute``)
against the JAX package's, at a tiny size in float32 with dropout off: the
triplets and negatives, one step's loss and every parameter's gradient (plain
anchor and ``fused_training``), the fused-reference positives and negatives
(B1-B3 / B4-B6 plain versions against the JAX engine in interpret mode), a
short trajectory, the evaluations, checkpoints and resume, and the CLI."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import (
    ItemQFormerConfig,
    MeshConfig,
    OptimizerConfig,
    TrainConfig,
)
from unirec_tpu.data.cache import FieldEmbeddingCache as JaxCache
from unirec_tpu.eval import reconstruction as jax_recon
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.train import item_qformer as jax_train
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.eval.reconstruction import evaluate_reconstruction_quality
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.train import item_qformer as port_train
from unirec_tpu_torch.utils.weights import (
    flax_to_state_dict,
    item_qformer_state_dict_from_flax,
)


D, F, N_ITEMS = 128, 5, 48
CFG = ItemQFormerConfig(hidden_size=D, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=256,
                        num_query_tokens=8, field_embedding_dim=D,
                        num_fields=F, dropout=0.0)
OPT = OptimizerConfig(learning_rate=1e-3)


def _tc(batch_size=8, **kw):
    return TrainConfig(batch_size=batch_size, seed=3, optimizer=OPT,
                       mesh=MeshConfig(dp=1), **kw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((N_ITEMS, F, D), dtype=np.float32)
    masks = (rng.random((N_ITEMS, F)) > 0.25).astype(np.float32)
    masks[3] = 0.0  # an item with no field
    emb *= masks[..., None]
    ids = [f"it{i}" for i in range(N_ITEMS)]
    seqs = [[ids[j] for j in rng.choice(N_ITEMS, 5, replace=False)]
            for _ in range(12)] + [["it0"], ["it1", "missing", "it2"]]
    fields = [f"f{i}" for i in range(F)]
    return emb, masks, ids, fields, seqs


def _caches(data):
    emb, masks, ids, fields, _ = data
    return (JaxCache(emb, masks, fields, ids),
            FieldEmbeddingCache(emb, masks, fields, ids))


@pytest.fixture(scope="module")
def jax_params():
    jt = jax_train.ItemQFormerTrainer(CFG, _tc(), fused_reference_forwards=False)
    return jax.tree_util.tree_map(np.asarray, jt.init_state(seed=0).params)


def _batch(data, pairs, neg):
    emb, masks = data[0], data[1]
    a, p = pairs[:, 0], pairs[:, 1]
    return {"anchor_emb": emb[a], "anchor_mask": masks[a], "pos_emb": emb[p],
            "pos_mask": masks[p], "neg_emb": emb[neg], "neg_mask": masks[neg]}


def test_triplets_and_negatives_match_jax(data):
    jc, pc = _caches(data)
    seqs = data[4]
    want = jax_train.build_triplet_pairs(seqs, jc.id_to_row)
    got = port_train.build_triplet_pairs(seqs, pc.id_to_row)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape[1] == 2
    for n_items in (N_ITEMS, 2, 1):
        np.testing.assert_array_equal(
            port_train.sample_negatives(np.random.default_rng(7), got, n_items),
            jax_train.sample_negatives(np.random.default_rng(7), want, n_items))


def _jax_step(cfg, params, batch, **kw):
    jt = jax_train.ItemQFormerTrainer(cfg, _tc(), fused_reference_forwards=False)
    state = jt.init_state(seed=0).replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    step = jax.jit(jax_train.make_train_step(jt.model, return_grads=True,
                                             seed=3, **kw))
    _, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return m


def _port_step(cfg, params, batch, hinge_active=None, **kw):
    pt = port_train.ItemQFormerTrainer(cfg, _tc(), device="cpu",
                                       fused_reference_forwards=False)
    state = pt.init_state(params=item_qformer_state_dict_from_flax(params))
    step = port_train.make_train_step(state.model, return_grads=True, seed=3,
                                      **kw)
    _, m = step(state, batch, hinge_active)
    return m


@pytest.mark.parametrize("fused_anchor", [False, True],
                         ids=["plain_anchor", "fused_training"])
def test_train_step_loss_and_grads_match_jax(data, jax_params, fused_anchor):
    cfg = dataclasses.replace(CFG, fused_training=fused_anchor)
    pairs = port_train.build_triplet_pairs(data[4], _caches(data)[1].id_to_row)
    batch = _batch(data, pairs[:8], np.arange(10, 18))
    jm = _jax_step(cfg, jax_params, batch)
    pm = _port_step(cfg, jax_params, batch)
    for k in ("loss", "recon", "contrastive"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    want = flax_to_state_dict(jm["grads"])
    assert set(pm["grads"]) == set(want)
    for name, g in pm["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=2e-3, err_msg=name)


def test_train_step_hinge_hook(data, jax_params):
    """The parity instrumentation of the step: ``hinge_arguments`` are the
    arguments whose hinge is the JAX step's contrastive term; a
    ``hinge_active`` equal to their sign gives the same loss and gradients
    as the step without it, and one sample moved to the other side changes
    the contrastive term by its argument over the batch."""
    pairs = port_train.build_triplet_pairs(data[4], _caches(data)[1].id_to_row)
    batch = _batch(data, pairs[:8], np.arange(10, 18))
    jm = _jax_step(CFG, jax_params, batch)
    pm = _port_step(CFG, jax_params, batch)
    arg = pm["hinge_arguments"]
    assert arg.shape == (8,) and not arg.requires_grad
    np.testing.assert_allclose(float(torch.clamp(arg, min=0.0).mean()),
                               float(jm["contrastive"]), rtol=2e-5)
    active = (arg > 0).float()
    same = _port_step(CFG, jax_params, batch, hinge_active=active)
    assert torch.equal(same["loss"], pm["loss"])
    for name, g in pm["grads"].items():
        torch.testing.assert_close(same["grads"][name], g, rtol=0, atol=0,
                                   msg=name)
    i = int(torch.argmin(arg.abs()))
    moved = active.clone()
    moved[i] = 1.0 - moved[i]
    other = _port_step(CFG, jax_params, batch, hinge_active=moved)
    np.testing.assert_allclose(
        float(other["contrastive"] - pm["contrastive"]),
        float((moved[i] - active[i]) * arg[i] / 8), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_fused_reference_step_matches_jax(data, jax_params, precision):
    """The positive and negative representations through the fused engine
    (the port's B1-B3 / B4-B6 plain versions on the CPU, the JAX engine in
    interpret mode), both in bf16: the step's contrastive term agrees to
    the engine's rounding, the reconstruction term exactly as before."""
    pairs = port_train.build_triplet_pairs(data[4], _caches(data)[1].id_to_row)
    batch = _batch(data, pairs[:8], np.arange(10, 18))
    kw = dict(fused_reference_config=CFG, fused_precision=precision)
    jm = _jax_step(CFG, jax_params, batch, **kw)
    pm = _port_step(CFG, jax_params, batch, **kw)
    np.testing.assert_allclose(float(pm["recon"]), float(jm["recon"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(pm["contrastive"]),
                               float(jm["contrastive"]), rtol=2e-3)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=2e-4)
    # the representations themselves, against the JAX engine's
    sd = item_qformer_state_dict_from_flax(jax_params)
    model = ItemQFormer(CFG)
    model.load_state_dict(sd)
    emb, mask = (torch.tensor(batch[k]) for k in ("pos_emb", "pos_mask"))
    got = port_train.fused_reference_representation(model, CFG, emb, mask,
                                                    precision)
    from unirec_tpu.inference.fused_qformer import (
        fused_qformer_forward,
        prepare_fused_params,
    )

    fp = prepare_fused_params({"params": jax_params}, CFG, dtype=jnp.bfloat16,
                              precision=precision)
    q = fused_qformer_forward(fp, CFG, jnp.asarray(batch["pos_emb"]),
                              jnp.asarray(batch["pos_mask"]), interpret=True)
    head = jax_params["item_representation_head"]
    want = np.asarray((q.mean(axis=1) @ jnp.asarray(head["kernel"], q.dtype)
                       + jnp.asarray(head["bias"], q.dtype)).astype(
                           jnp.float32))
    assert got.dtype == torch.float32
    cos = (got.numpy() * want).sum(-1) / (np.linalg.norm(got.numpy(), axis=-1)
                                          * np.linalg.norm(want, axis=-1))
    assert cos.min() > (0.9999 if precision == "bf16" else 0.999), cos


def test_eval_step_matches_jax(data, jax_params):
    """One batch's masked MSE, per-field cosine sum over valid fields and
    valid-field count (an item with no field included) against JAX's."""
    emb, masks = data[0][:10], data[1][:10]
    want = jax_train.make_eval_step(JaxItemQFormer(CFG))(
        jax.tree_util.tree_map(jnp.asarray, jax_params), jnp.asarray(emb),
        jnp.asarray(masks))
    model = ItemQFormer(CFG)
    model.load_state_dict(item_qformer_state_dict_from_flax(jax_params))
    got = port_train.make_eval_step(model)(torch.tensor(emb),
                                           torch.tensor(masks))
    for g, w, name in zip(got, want, ("mse", "cos_sum", "n_valid")):
        np.testing.assert_allclose(g, float(w), rtol=1e-5, err_msg=name)


def test_trajectory_and_evaluation_match_jax_trainer(data, jax_params):
    jc, pc = _caches(data)
    seqs = data[4]
    jt = jax_train.ItemQFormerTrainer(CFG, _tc(), fused_reference_forwards=False)
    jstate = jt.init_state(seed=0).replace(
        params=jax.tree_util.tree_map(jnp.asarray, jax_params))
    pt = port_train.ItemQFormerTrainer(CFG, _tc(), device="cpu")
    assert not pt.use_fused  # the CPU takes the plain pos/neg forwards
    pstate = pt.init_state(params=item_qformer_state_dict_from_flax(jax_params))
    val = np.arange(0, N_ITEMS, 3)
    ev_j = jt.evaluate(jstate, jc, val, batch_size=7)
    ev_p = pt.evaluate(pstate, pc, val, batch_size=7)
    for k in ev_j:
        np.testing.assert_allclose(ev_p[k], ev_j[k], rtol=1e-5, err_msg=k)
    pairs = jax_train.build_triplet_pairs(seqs, jc.id_to_row)
    jr, pr = np.random.default_rng(5), np.random.default_rng(5)
    for epoch in range(2):
        jstate, jm = jt.train_epoch(jstate, jc, pairs, jr)
        pstate, pm = pt.train_epoch(pstate, pc, pairs, pr)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=2e-4,
                                       err_msg=f"epoch {epoch} {k}")
    assert pstate.step == int(jstate.step)
    # evaluate_reconstruction_quality on the trained weights, both sides
    sd = item_qformer_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    model = ItemQFormer(CFG)
    model.load_state_dict(sd)
    got = evaluate_reconstruction_quality(model, pc, batch_size=10)
    want = jax_recon.evaluate_reconstruction_quality(
        JaxItemQFormer(CFG), {"params": jstate.params}, jc, batch_size=10)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_train_item_qformer_checkpoints_and_resume(data, tmp_path):
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.utils.checkpoint import read_meta

    _, pc = _caches(data)
    ck = str(tmp_path / "ck")
    tc = dataclasses.replace(_tc(), num_epochs=2, eval_every_epochs=1,
                             optimizer=dataclasses.replace(
                                 OPT, gradient_accumulation_steps=2))
    cfg = dataclasses.replace(CFG, fused_training=True, dropout=0.1)
    logs = []
    state, metrics = port_train.train_item_qformer(
        pc, data[4], cfg, tc, val_rows=np.arange(8), checkpoint_dir=ck,
        device="cpu", log_fn=logs.append)
    meta = read_meta(ck)
    assert meta["field_names"] == pc.fields and meta["grad_accum"] == 2
    assert meta["config"]["fused_training"] and "val_recon_loss" in metrics
    assert meta["val_recon_loss"] <= min(
        float(line.split("'val_recon_loss': ")[1].split(",")[0])
        for line in logs if " val: " in line)
    steps = meta["step"]
    assert steps > 0 and state.optimizer.mini_step == 0  # flushed at the end
    # the sweep reads the checkpoint
    inf = QFormerInference(ck, device="cpu")
    tokens = inf.query_tokens_from_cache(pc, pc.item_ids[:3])
    assert tokens[pc.item_ids[0]].shape == (CFG.num_query_tokens, D)
    # resume continues the optimizer step and the best-validation watermark
    logs.clear()
    state2, _ = port_train.train_item_qformer(
        pc, data[4], cfg, dataclasses.replace(tc, num_epochs=1),
        val_rows=np.arange(8), checkpoint_dir=ck, device="cpu", resume=True,
        log_fn=logs.append)
    assert any("resumed from" in line for line in logs)
    assert state2.step > steps
    with pytest.raises(ValueError, match="accumulation"):
        port_train.train_item_qformer(
            pc, data[4], cfg, dataclasses.replace(tc, optimizer=OPT),
            checkpoint_dir=ck, device="cpu", resume=True, log_fn=logs.append)


def _cli_files(tmp_path, n=30):
    rng = np.random.default_rng(1)
    words = ["serum", "lip", "balm", "rose", "matte", "gloss", "mini"]
    items = {f"p{i}": {"title": " ".join(rng.choice(words, 3)),
                       "price": float(rng.integers(1, 90)),
                       "main_image": f"http://img/{i}.jpg" if i % 3 else "",
                       "store": "" if i % 4 == 0 else "Acme"}
             for i in range(n)}
    seqs = [{"history": [f"p{j}" for j in rng.choice(n, 6, replace=False)]}
            for _ in range(8)] + [{"history": ["p1"]}]
    (tmp_path / "items.json").write_text(json.dumps(items))
    (tmp_path / "seq.json").write_text(json.dumps(seqs))
    return ["--data", str(tmp_path / "items.json"),
            "--sequences", str(tmp_path / "seq.json"),
            "--cache-dir", str(tmp_path / "cache"), "--device", "cpu",
            "--hidden-size", "64", "--num-layers", "2", "--num-heads", "4",
            "--intermediate-size", "128", "--num-query-tokens", "8",
            "--batch-size", "8", "--num-epochs", "2", "--eval-every", "1",
            "--checkpoint-dir", str(tmp_path / "ck")]


def test_train_cli_item_qformer_evaluate_precompute(tmp_path, capsys):
    from unirec_tpu_torch.cli import train_cli
    from unirec_tpu_torch.utils.checkpoint import read_meta

    argv = _cli_files(tmp_path)
    assert train_cli.main(["precompute", "--data", argv[1], "--cache-dir",
                           str(tmp_path / "pre"), "--device", "cpu",
                           "--max-items", "20"]) == 0
    assert "cached 20 items x 4 fields" in capsys.readouterr().out
    pre = FieldEmbeddingCache.load(str(tmp_path / "pre"))
    assert pre.fields == ["main_image", "price", "store", "title"]
    assert len(pre) == 20 and pre.embedding_dim == 1024
    assert train_cli.main(["item-qformer"] + argv + ["--bf16",
                                                     "--fused-anchor"]) == 0
    out = capsys.readouterr().out
    assert "val_recon_loss" in out
    meta = read_meta(str(tmp_path / "ck"))
    assert meta["config"]["fused_training"] and len(meta["field_names"]) == 4
    assert train_cli.main(["item-qformer"] + argv + ["--bf16", "--fused-anchor",
                                                     "--resume",
                                                     "--int8-ref"]) == 0
    assert "resumed from" in capsys.readouterr().out
    assert train_cli.main(["evaluate", "--checkpoint", str(tmp_path / "ck"),
                           "--cache-dir", str(tmp_path / "cache"),
                           "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["num_samples"] == 30 and np.isfinite(res["val_recon_loss"])


def test_train_cli_item_qformer_refusals(tmp_path, capsys, monkeypatch):
    from unirec_tpu_torch.cli import train_cli

    argv = _cli_files(tmp_path, n=6)
    with pytest.raises(SystemExit, match="--fused-anchor requires --bf16"):
        train_cli.main(["item-qformer"] + argv + ["--fused-anchor"])
    # --dp and --tp are ported (tests/test_torch_mesh.py,
    # tests/test_torch_tp.py); --tp refuses the fused anchor, as in JAX
    with pytest.raises(ValueError, match="fused_training is incompatible "
                                         "with tp>1"):
        train_cli.main(["item-qformer"] + argv + ["--dp", "2", "--tp", "2",
                                                  "--bf16", "--fused-anchor"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["item-qformer"] + [a for a in argv if a != "cpu"
                                    and a != "--device"],
                ["precompute", "--data", argv[1], "--cache-dir", "x"],
                ["evaluate", "--checkpoint", "x", "--cache-dir", "y"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_cli.main(cmd)
