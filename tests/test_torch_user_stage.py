"""The user stage of the port (``models/mwne`` context encoders,
``models/user_sequence``, ``models/user_qformer``, ``train/user_qformer``,
``eval/user_eval``, ``train_cli user-qformer``) against the JAX package's, at
a tiny size (hidden 32, 2 heads, 8 queries, memories of 150 and 200 rows) in
float32: the timestamp features, the context encoders, the position encoding
and the sequence assembly; the User Q-Former forward and gradients, exact and
with ``flash_training`` (the JAX test's tolerances: loss rtol 1e-5, gradients
atol 5e-5 rtol 1e-3); one trainer step's loss and every leaf's gradient,
exact and with flash + fused training, with the context encoders trained and
frozen; remat against no remat under dropout; the evaluation and its
retrieval metrics (a tie goes to the true item); and the CLI with
``--resume``.  JAX's Pallas kernels run in interpret mode."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.configs import (
    ItemQFormerConfig,
    MeshConfig,
    OptimizerConfig,
    TrainConfig,
    UserQFormerConfig,
)
from unirec_tpu.data.cache import FieldEmbeddingCache as JaxCache
from unirec_tpu.eval import user_eval as jeval
from unirec_tpu.models import mwne as jmwne
from unirec_tpu.models import user_sequence as jseq
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.models.user_qformer import UserQFormer as JaxUserQFormer
from unirec_tpu.train import user_qformer as jtrain
from unirec_tpu_torch import configs as pconfigs
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.eval import user_eval as peval
from unirec_tpu_torch.models import mwne as pmwne
from unirec_tpu_torch.models import qformer as pqformer
from unirec_tpu_torch.models import user_sequence as pseq
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.models.user_qformer import UserQFormer
from unirec_tpu_torch.ops.dropout import DropoutStream
from unirec_tpu_torch.train import user_qformer as ptrain
from unirec_tpu_torch.utils.weights import (
    flax_to_state_dict,
    item_qformer_state_dict_from_flax,
    user_state_dict_from_flax,
)

D, K, N_ITEMS, S = 32, 4, 40, 50  # memory S * K = 200 rows
UC = UserQFormerConfig(hidden_size=D, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=64,
                       num_query_tokens=8, input_embedding_dim=D,
                       num_item_tokens_to_predict=K, dropout=0.0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _timestamps(rng, n):
    ts = rng.uniform(0, 1.8e9, n).astype(np.float32)
    ts[:3] = [0.0, 86399.0, 1.7e9]
    return ts


def test_timestamp_features_match_jax():
    ts = _timestamps(np.random.RandomState(0), 64)
    want = np.asarray(jmwne.timestamp_features(jnp.asarray(ts)))
    got = pmwne.timestamp_features(_t(ts)).numpy()
    assert got.shape == (64, 9)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)
    coords = np.random.RandomState(1).uniform(-90, 90, (16, 2)).astype(
        np.float32)
    np.testing.assert_allclose(
        pmwne.geo_to_cartesian(_t(coords)).numpy(),
        np.asarray(jmwne.geo_to_cartesian(jnp.asarray(coords))), atol=1e-6)
    for length, d in ((150, D), (200, 48)):
        np.testing.assert_allclose(
            pmwne.sinusoidal_position_encoding(length, d).numpy(),
            np.asarray(jmwne.sinusoidal_position_encoding(length, d)),
            atol=1e-6)


def test_sequence_model_and_assembly_match_jax():
    rng = np.random.RandomState(2)
    b, s = 3, 5
    toks = rng.randn(b, s, K, D).astype(np.float32)
    ts = _timestamps(rng, b * s).reshape(b, s)
    coords = rng.uniform(-60, 60, (b, s, 2)).astype(np.float32)
    mask = (rng.rand(b, s) > 0.3).astype(np.float32)
    mask[2] = 0.0
    jm = jseq.UserSequenceModel(D)
    params = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in
                                              (toks, ts, coords, mask)))
    jflat, jmask = jm.apply(params, *(jnp.asarray(a) for a in
                                      (toks, ts, coords, mask)))
    pm = pseq.UserSequenceModel(D)
    pm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        flat, fmask = pm(_t(toks), _t(ts), _t(coords), _t(mask))
    assert flat.shape == (b, s * K, D) and fmask.shape == (b, s * K)
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(jmask))
    ctx = rng.randn(b, s, D).astype(np.float32)
    for m in (mask, None):
        want = jseq.assemble_user_sequence(
            jnp.asarray(toks), jnp.asarray(ctx),
            None if m is None else jnp.asarray(m))
        got = pseq.assemble_user_sequence(_t(toks), _t(ctx),
                                          None if m is None else _t(m))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("flash", [False, True], ids=["exact", "flash"])
def test_user_qformer_matches_jax(flash):
    """Loss sum(out ** 2) and every gradient over a 150-row memory with a
    user whose whole history is masked."""
    rng = np.random.RandomState(4)
    cfg = dataclasses.replace(UC, flash_training=flash)
    seq = rng.randn(3, 150, D).astype(np.float32)
    mask = (rng.rand(3, 150) > 0.2).astype(np.float32)
    mask[2] = 0.0
    jm = JaxUserQFormer(cfg)
    params = JaxUserQFormer(UC).init(jax.random.PRNGKey(0), jnp.asarray(seq),
                                     jnp.asarray(mask))
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(seq), jnp.asarray(mask))
                          ** 2)))(params)
    pm = UserQFormer(cfg)
    pm.load_state_dict(flax_to_state_dict(params))
    loss = (pm(_t(seq), _t(mask)) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    want = flax_to_state_dict(jg)
    assert {n for n, _ in pm.named_parameters()} == set(want)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=5e-5, rtol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def stage():
    """A catalog of item tokens, a cache over it (some history items and
    targets missing from it), samples and timestamps."""
    rng = np.random.RandomState(5)
    ids = [f"i{j}" for j in range(N_ITEMS)]
    cache_args = (rng.randn(N_ITEMS, 3, D).astype(np.float32),
                  np.ones((N_ITEMS, 3), np.float32), ["a", "b", "c"], ids)
    tokens = rng.randn(N_ITEMS, K, D).astype(np.float32)
    histories = [{"history": [ids[j] for j in rng.choice(N_ITEMS, n)]}
                 for n in (8, 12, 5, 9)]
    histories[1]["history"][3] = "gone"       # a history item not cached
    histories[2]["history"][2] = "gone_too"   # a target not cached
    samples = jtrain.build_sliding_window_samples(histories)
    reviews = {i: [{"unixReviewTime": int(1.5e9) + 3600 * j}]
               for j, i in enumerate(ids)}
    return dict(cache_args=cache_args, tokens=tokens, histories=histories,
                samples=samples, ts_map=jtrain.build_timestamp_map(reviews))


def _tc(**kw):
    return TrainConfig(batch_size=8, seed=3,
                       optimizer=OptimizerConfig(learning_rate=1e-3,
                                                 weight_decay=0.01),
                       mesh=MeshConfig(dp=1), **kw)


def test_samples_and_batches_match_jax(stage):
    assert ptrain.build_sliding_window_samples(stage["histories"]) == \
        stage["samples"]
    jt = jtrain.UserQFormerTrainer(UC, _tc(), max_seq_len=S)
    pt = ptrain.UserQFormerTrainer(UC, _tc(), max_seq_len=S, device="cpu")
    idx = list(range(len(stage["samples"])))
    want = jt.make_batch(stage["samples"], idx, stage["tokens"],
                         JaxCache(*stage["cache_args"]), stage["ts_map"])
    got = pt.make_batch(stage["samples"], idx, stage["tokens"],
                        FieldEmbeddingCache(*stage["cache_args"]),
                        stage["ts_map"])
    assert set(got) == set(want) == set(ptrain.BATCH_KEYS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["sample_weight"].min() == 0.0 and got["seq_mask"].min() == 0.0


@pytest.fixture(scope="module")
def jax_steps(stage):
    """The JAX trainer's step (``_make_step(return_grads=True)``, jitted) on
    one batch, exact and with flash + fused training: params, loss, grads."""
    out = {}
    for kernels in (False, True):
        uc = dataclasses.replace(UC, flash_training=kernels,
                                 fused_training=kernels)
        jt = jtrain.UserQFormerTrainer(uc, _tc(), max_seq_len=S)
        state = jt.init_state(seed=0)
        batch = jt.make_batch(stage["samples"], list(range(8)),
                              stage["tokens"], JaxCache(*stage["cache_args"]),
                              stage["ts_map"])
        _, m = jax.jit(jt._make_step(return_grads=True))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        out[kernels] = (jax.tree_util.tree_map(np.asarray, state.params),
                        batch, float(m["loss"]), flax_to_state_dict(m["grads"]))
    return out


@pytest.mark.parametrize("kernels,train_context", [
    (False, True), (False, False), (True, True), (True, False)],
    ids=["exact", "exact_frozen_context", "flash_fused",
         "flash_fused_frozen_context"])
def test_trainer_step_matches_jax(jax_steps, kernels, train_context):
    """Loss and every leaf's gradient.  The JAX trainer freezes the context
    encoders with ``stop_gradient`` (their gradient is exactly 0, the User
    Q-Former's unchanged) and ``set_to_zero``; the port holds them out of
    the optimizer."""
    params, batch, jloss, want = jax_steps[kernels]
    uc = dataclasses.replace(UC, flash_training=kernels,
                             fused_training=kernels)
    pt = ptrain.UserQFormerTrainer(uc, _tc(), max_seq_len=S,
                                   train_context=train_context, device="cpu")
    pstate = pt.init_state(params=user_state_dict_from_flax(params))
    _, pm = ptrain.make_train_step(pstate.model, return_grads=True)(pstate,
                                                                    batch)
    np.testing.assert_allclose(float(pm["loss"]), jloss, rtol=1e-5)
    assert set(pm["grads"]) == set(want)
    for name, g in pm["grads"].items():
        w = want[name].numpy()
        if not train_context and name.startswith("sequence."):
            w = np.zeros_like(w)
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=1e-3,
                                   err_msg=name)
    if not train_context:  # frozen: no gradient, no update, no decay
        assert all(n.startswith("user.") for n in pstate.optimizer.params)


def test_remat_matches_no_remat_under_dropout(stage):
    """Layer and sequence-assembly remat recompute with the same per-site
    dropout streams: the same loss and gradients as without remat."""
    uc = dataclasses.replace(UC, dropout=0.1)
    batch = ptrain.UserQFormerTrainer(uc, _tc(), S, device="cpu").make_batch(
        stage["samples"], list(range(8)), stage["tokens"],
        FieldEmbeddingCache(*stage["cache_args"]), stage["ts_map"])
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(uc, gradient_checkpointing=remat)
        pt = ptrain.UserQFormerTrainer(cfg, _tc(), S, device="cpu")
        st = pt.init_state(seed=0)
        _, m = ptrain.make_train_step(st.model, return_grads=True,
                                      seed=7)(st, batch)
        out.append(m)
    torch.testing.assert_close(out[1]["loss"], out[0]["loss"], rtol=1e-6,
                               atol=0)
    for name, g in out[0]["grads"].items():
        torch.testing.assert_close(out[1]["grads"][name], g, rtol=1e-5,
                                   atol=1e-7, msg=name)


def test_model_dispatch_takes_b14_and_b12s(monkeypatch):
    """flash + fused: every self-attention block through the fused block,
    every cross block (150 rows: no fused tile) through B14, in training and
    in the deterministic evaluation."""
    calls = {"b14": 0, "b12s": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pqformer, "flash_cross_attention_proj_vjp",
                        count("b14", pqformer.flash_cross_attention_proj_vjp))
    monkeypatch.setattr(pqformer, "fused_self_attention_train",
                        count("b12s", pqformer.fused_self_attention_train))
    cfg = dataclasses.replace(UC, flash_training=True, fused_training=True)
    model = UserQFormer(cfg)
    torch.nn.init.normal_(model.query_embeddings)
    seq, mask = torch.randn(2, 150, D), torch.ones(2, 150)
    model(seq, mask, dropout=DropoutStream(0, 0)).sum().backward()
    assert calls == {"b14": 2, "b12s": 2}
    with torch.no_grad():
        model(seq, mask)
    assert calls == {"b14": 4, "b12s": 4}
    plain = UserQFormer(UC)
    plain(seq, mask, dropout=DropoutStream(0, 0))
    assert calls == {"b14": 4, "b12s": 4}


def test_evaluation_and_retrieval_match_jax(stage):
    jt = jtrain.UserQFormerTrainer(UC, _tc(), max_seq_len=S)
    state = jt.init_state(seed=1)
    pt = ptrain.UserQFormerTrainer(UC, _tc(), max_seq_len=S, device="cpu")
    pstate = pt.init_state(params=user_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params)))
    samples = stage["samples"][:20]
    want = jeval.evaluate_user_qformer(jt, state, samples, stage["tokens"],
                                       JaxCache(*stage["cache_args"]),
                                       stage["ts_map"], batch_size=8)
    got = peval.evaluate_user_qformer(pt, pstate, samples, stage["tokens"],
                                      FieldEmbeddingCache(*stage["cache_args"]),
                                      stage["ts_map"], batch_size=8)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # ranks count strictly better items: a duplicate of the true item ties
    rng = np.random.RandomState(6)
    catalog = rng.randn(12, K, D).astype(np.float32)
    catalog[7] = catalog[2]
    pred = catalog[[2, 2, 9]] + 0.3 * rng.randn(3, K, D).astype(np.float32)
    rows = np.array([2, 7, 9])
    want = jeval.retrieval_metrics(pred, rows, catalog)
    got = peval.retrieval_metrics(pred, rows, catalog)
    assert got == pytest.approx(want, rel=1e-6)
    assert got["retrieval_hit@1"] == 1.0  # rows 2 and 7 tie


def test_precompute_item_tokens_matches_jax(stage):
    cfg = ItemQFormerConfig(hidden_size=D, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=64,
                            num_query_tokens=K, field_embedding_dim=D,
                            num_fields=3, dropout=0.0)
    jm = JaxItemQFormer(cfg)
    emb, masks = stage["cache_args"][:2]
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(emb[:2]),
                     jnp.asarray(masks[:2]))
    want = jtrain.precompute_item_tokens(jm, params,
                                         JaxCache(*stage["cache_args"]),
                                         batch_size=16)
    pm = ItemQFormer(cfg)
    pm.load_state_dict(item_qformer_state_dict_from_flax(params))
    got = ptrain.precompute_item_tokens(
        pm, FieldEmbeddingCache(*stage["cache_args"]), batch_size=16)
    assert got.shape == (N_ITEMS, K, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_train_cli_user_qformer_and_resume(stage, tmp_path, monkeypatch,
                                           capsys):
    from unirec_tpu_torch.cli import train_cli
    from unirec_tpu_torch.utils.checkpoint import read_meta, save_checkpoint
    from unirec_tpu_torch.utils.weights import init_item_qformer

    iq = pconfigs.ItemQFormerConfig(
        hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=K, field_embedding_dim=D,
        num_fields=3)
    save_checkpoint(str(tmp_path / "iq"),
                    init_item_qformer(iq, torch.Generator().manual_seed(0)),
                    config=iq, extra={"field_names": ["a", "b", "c"]})
    FieldEmbeddingCache(*stage["cache_args"]).save(str(tmp_path / "cache"))
    (tmp_path / "hist.json").write_text(json.dumps(stage["histories"]))
    (tmp_path / "rev.json").write_text(json.dumps(
        {f"u{j % 3}|{i}": {"unixReviewTime": int(1.4e9) + 7 * j}
         for j, i in enumerate(stage["cache_args"][3])}))
    # the subcommand builds UserQFormerConfig() at full width: shrink it
    monkeypatch.setattr(pconfigs, "UserQFormerConfig", functools.partial(
        pconfigs.UserQFormerConfig, hidden_size=D, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, num_query_tokens=8))
    ck = str(tmp_path / "ck")
    base = ["user-qformer", "--item-qformer-checkpoint", str(tmp_path / "iq"),
            "--history", str(tmp_path / "hist.json"), "--reviews",
            str(tmp_path / "rev.json"), "--cache-dir", str(tmp_path / "cache"),
            "--device", "cpu", "--batch-size", "8", "--max-seq-len", "12",
            "--checkpoint-dir", ck]

    def metrics():  # the JSON the subcommand prints last
        out = capsys.readouterr().out
        return out, json.loads(out[out.rindex("\n{") + 1:])

    assert train_cli.main(base + ["--flash", "--fused", "--num-epochs",
                                  "2"]) == 0
    _, m = metrics()
    assert np.isfinite(m["loss"]) and "retrieval_mrr" in m
    steps = read_meta(ck)["step"]
    assert steps > 0 and read_meta(ck)["config"]["flash_training"]
    assert train_cli.main(base + ["--flash", "--fused", "--num-epochs", "1",
                                  "--resume"]) == 0
    out, _ = metrics()
    assert f"resumed from {ck} at step {steps}" in out
    assert read_meta(ck)["step"] > steps
    assert train_cli.main(base[:-2] + ["--bf16", "--remat", "--num-epochs",
                                       "1"]) == 0
    _, m = metrics()
    assert np.isfinite(m["loss"]) and np.isfinite(m["token_mse"])
    with pytest.raises(NotImplementedError, match="A9"):
        train_cli.main(base + ["--sp", "2"])
