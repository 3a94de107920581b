"""Port parity: the quality gates of ``unirec_tpu_torch/scripts`` against
the JAX package's scripts and functions, on the CPU at tiny sizes.

* ``convergence_demo.make_corpus`` equals the JAX script's (taken from its
  source with ``ast``: the script imports the reference checkout and cannot
  be imported here), bit for bit, at the defaults and at ``--scaled``;
* ``measure_serving_quality`` at ``--tiny``: every mode's user embeddings
  (fp32 oracle, bf16, int8 XLA dots, int8 fused blocks) against the JAX
  ``Recommender``'s on the same weights and histories, cosine >= 0.999999
  (fp32) or 0.9999 (the other modes: bf16 and int8 codes round at the same
  points but sum in other orders, the int8 class of
  ``tests/test_torch_serving.py``), and each mode's cosines to the oracle
  within 1e-3 of JAX's;
* ``measure_int8_quality`` on one layer: the port's ``QUALITY``
  cosines within 1e-4 of JAX's ``fused_qformer_forward`` (Pallas kernels in
  interpret mode) against the Flax model, on the same weights and inputs;
* ``int8_base_convergence.run`` for 5 ``int8_base`` steps: the losses
  within 1e-3 (relative) of the JAX ``JointTrainer``'s built from the
  script's config, from the same init and on the same batches, and its
  ranking metrics;
* the demo's three stages run 3 steps each and report the JAX keys;
* ``quality_gates``' engine and convergence verdicts equal the JAX
  runner's on crafted output, the n_test-aware Recall@10 tolerance
  included.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    MeshConfig,
    OptimizerConfig,
    Qwen3Config,
    TrainConfig,
    tiny_qwen3_config,
)
from unirec_tpu.data.cache import FieldEmbeddingCache as JaxCache
from unirec_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from unirec_tpu.inference import fused_qformer as jax_engine
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.models.joint import MultiModalQwenEmbedding as JaxJoint
from unirec_tpu.serving.recommender import Recommender as JaxRecommender
from unirec_tpu.train import joint as jax_train
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding
from unirec_tpu_torch.scripts import (
    convergence_demo as demo,
    int8_base_convergence,
    measure_int8_quality,
    measure_serving_quality,
    quality_gates,
)
from unirec_tpu_torch.utils.weights import (
    item_qformer_state_dict_from_flax,
    joint_state_dict_from_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name: str) -> str:
    with open(os.path.join(REPO, "scripts", name)) as f:
        return f.read()


# -- the corpus -------------------------------------------------------------------


def _jax_make_corpus(scaled: bool):
    """``make_corpus`` and its constants from the JAX script's source, run
    with the JAX package's field cache; ``scaled`` sets the globals as its
    ``main`` does for ``--scaled``."""
    tree = ast.parse(_jax_script("convergence_demo.py"))
    keep = [node for node in tree.body
            if (isinstance(node, ast.Assign)
                and all(isinstance(t, (ast.Name, ast.Tuple))
                        for t in node.targets)
                and isinstance(node.value, (ast.Tuple, ast.Constant)))
            or (isinstance(node, ast.FunctionDef)
                and node.name == "make_corpus")]
    ns = {"np": np, "FieldEmbeddingCache": JaxCache}
    exec(compile(ast.Module(keep, type_ignores=[]), "convergence_demo.py",
                 "exec"), ns)
    assert ns["HIDDEN"] == demo.HIDDEN and ns["VOCAB"] == demo.VOCAB
    if scaled:
        ns.update(N_ITEMS=2000, N_USERS=1000, F=14, K_ITEM=32)
    return ns["make_corpus"](), ns


@pytest.mark.parametrize("scaled", [False, True], ids=["default", "scaled"])
def test_make_corpus_equals_the_jax_script(scaled):
    want, ns = _jax_make_corpus(scaled)
    got = demo.make_corpus(**(demo.SCALED if scaled else {}))
    assert (ns["N_ITEMS"], ns["N_USERS"], ns["F"], ns["K_ITEM"]) == (
        (demo.SCALED["n_items"], demo.SCALED["n_users"], demo.SCALED["f"],
         demo.SCALED_K_ITEM) if scaled else
        (demo.N_ITEMS, demo.N_USERS, demo.F, demo.K_ITEM))
    (jcache, jemb, jitems, jusers, jfields, jmasks) = want
    cache, emb, items, users, fields, masks = got
    for a, b in ((cache.embeddings, jcache.embeddings),
                 (cache.masks, jcache.masks), (fields, jfields),
                 (masks, jmasks)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (cache.fields, cache.item_ids) == (jcache.fields, jcache.item_ids)
    assert emb == jemb and items == jitems and users == jusers


# -- serving quality --------------------------------------------------------------

SERVING_USERS = 16


def _jax_serving_configs():
    """The JAX script's ``--tiny`` configs."""
    qwen = tiny_qwen3_config(
        hidden_size=128, intermediate_size=256, num_attention_heads=1,
        num_key_value_heads=1, head_dim=128, max_position_embeddings=64,
        flash_attention=False)
    qf = ItemQFormerConfig(
        hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=2, field_embedding_dim=16,
        num_fields=3, dropout=0.0)
    return qwen, qf, JointModelConfig(max_length=64)


def test_tiny_serving_quality_matches_jax():
    qwen, qf, jc = _jax_serving_configs()
    pqwen, pqf, pjc = measure_serving_quality.configs(tiny=True)
    assert (repr(pqwen), repr(pqf), repr(pjc)) == (repr(qwen), repr(qf),
                                                   repr(jc))
    cache, catalog, item_dict, tok, hists = measure_serving_quality.serving_data(
        pqwen, pqf, pjc, 200, SERVING_USERS)
    model32 = JaxJoint(qwen, qf, jc, lora=LoRAConfig(), dtype=jnp.float32)
    params = jax.jit(model32.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, jc.max_length), jnp.int32),
        jnp.ones((1, jc.max_length)),
        jnp.zeros((1, jc.num_history_items, qf.num_fields,
                   qf.field_embedding_dim)),
        jnp.ones((1, jc.num_history_items, qf.num_fields)))
    jtok = JaxHashTokenizer(qwen.vocab_size, jc.num_history_items,
                            jc.num_query_tokens_per_item)
    jcache = JaxCache(cache.embeddings, cache.masks, cache.fields,
                      cache.item_ids)
    model_bf16 = JaxJoint(qwen, qf, jc, lora=LoRAConfig(), dtype=jnp.bfloat16)
    want = {}
    for label, model, kw in [("fp32", model32, {})] + [
            (label, model_bf16, kw)
            for label, kw in measure_serving_quality.MODES.items()]:
        rec = JaxRecommender(model, params, jtok, item_dict, jcache, catalog,
                             batch_size=8, **kw)
        want[label] = np.asarray(rec.encode_users(hists), np.float32)

    pm = MultiModalQwenEmbedding(pqwen, pqf, pjc, lora=LoRAConfig())
    pm.load_state_dict(joint_state_dict_from_flax(params, qwen, qf))
    got = measure_serving_quality.encode_modes(pm, tok, item_dict, cache,
                                               catalog, hists, batch=8,
                                               log=lambda msg: None)
    assert set(got) == set(want) == {"fp32", "bf16", "int8_xla",
                                     "int8_fused"}
    for label in got:
        cos = measure_serving_quality.user_cosines(got[label], want[label])
        assert cos.min() >= (0.999999 if label == "fp32" else 0.9999), label
    for label in measure_serving_quality.MODES:
        p = measure_serving_quality.user_cosines(got[label], got["fp32"])
        j = measure_serving_quality.user_cosines(want[label], want["fp32"])
        assert abs(p.mean() - j.mean()) <= 1e-3, label
        assert abs(p.min() - j.min()) <= 1e-3, label
    lines = measure_serving_quality.gate_lines(got)
    assert [line.split(":")[0] for line, _ in lines] == list(
        measure_serving_quality.MODES)
    assert all(ok for _, ok in lines)


# -- engine quality ---------------------------------------------------------------


def _jax_stats(out, ref):
    """The JAX script's ``stats``."""
    a = out.reshape(-1, out.shape[-1]).astype(jnp.float32)
    b = ref.reshape(-1, ref.shape[-1]).astype(jnp.float32)
    cos = (a * b).sum(-1) / (
        jnp.linalg.norm(a, axis=-1) * jnp.linalg.norm(b, axis=-1) + 1e-9)
    rel = jnp.linalg.norm(a - b, axis=-1) / (jnp.linalg.norm(b, axis=-1)
                                              + 1e-9)
    return (float(cos.mean()), float(cos.min()), float(rel.mean()),
            float(rel.max()))


def test_engine_quality_matches_jax():
    """One layer of ``--tiny``'s engine (self, cross and FFN blocks), on 8
    items."""
    pcfg = dataclasses.replace(measure_int8_quality.TINY, num_hidden_layers=1)
    cfg = ItemQFormerConfig(**{k: getattr(pcfg, k) for k in (
        "hidden_size", "num_hidden_layers", "num_attention_heads",
        "intermediate_size", "num_query_tokens", "field_embedding_dim",
        "num_fields", "dropout")})
    fields_t, mask_t = measure_int8_quality.make_inputs(pcfg, 8, "cpu")
    fields, mask = fields_t.numpy(), mask_t.numpy()
    jm = JaxItemQFormer(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(fields[:2]),
                              jnp.asarray(mask[:2]))
    ref = jax.jit(jm.apply)(params, jnp.asarray(fields), jnp.asarray(mask))[
        "query_outputs"]
    pm = ItemQFormer(pcfg)
    pm.load_state_dict(item_qformer_state_dict_from_flax(params))
    got = measure_int8_quality.measure(pm, pcfg, fields_t, mask_t)
    assert list(got) == ["bf16", "int8"]
    for precision, stats in got.items():
        fused = jax_engine.prepare_fused_params(params, cfg,
                                                precision=precision)
        out = jax_engine.fused_qformer_forward(
            fused, cfg, jnp.asarray(fields), jnp.asarray(mask),
            interpret=True)
        want = _jax_stats(out, ref)
        assert abs(stats[0] - want[0]) <= 1e-4, precision
        assert abs(stats[1] - want[1]) <= 1e-4, precision
        line = measure_int8_quality.quality_line(precision, stats)
        assert line.startswith(f"QUALITY {precision}: cos_mean=")
        assert f"cos_min={stats[1]:.6f}" in line


# -- the int8-base convergence run ------------------------------------------------


def test_int8_base_convergence_run_matches_jax():
    """Five ``int8_base`` steps of ``run`` against the JAX ``JointTrainer``
    of the script's config from one init, on the same batches.  (The exact
    run is the same code with the flag off; ``tests/test_torch_train_joint``
    holds that trajectory.)  The trained weights differ by summation order
    only, which moves one positive past a near-tie below rank 10: MRR
    within 2e-4, Recall@10 and NDCG@10 equal."""
    steps, seed, batch = 5, 2, 8
    cache, emb, items, users, _, _ = demo.make_corpus()
    qc = Qwen3Config(
        vocab_size=demo.VOCAB, hidden_size=demo.HIDDEN,
        intermediate_size=demo.FFN, num_hidden_layers=demo.LAYERS,
        num_attention_heads=demo.HEADS, num_key_value_heads=2, head_dim=16,
        flash_attention=False)
    icfg = ItemQFormerConfig(
        hidden_size=demo.HIDDEN, num_hidden_layers=demo.LAYERS,
        num_attention_heads=demo.HEADS, intermediate_size=demo.FFN,
        num_query_tokens=2, field_embedding_dim=demo.WIDTH, num_fields=demo.F,
        dropout=0.0)
    jc = JointModelConfig(max_length=96)
    trainer = jax_train.JointTrainer(
        qc, icfg, jc, lora=LoRAConfig(r=4, alpha=8.0, dropout=0.0),
        train_config=TrainConfig(
            batch_size=batch,
            optimizer=OptimizerConfig(learning_rate=1e-3, weight_decay=0.0,
                                      warmup_steps=5, max_grad_norm=1.0),
            mesh=MeshConfig(dp=1), seed=seed),
        int8_base=True)
    # the trainer's Flax init traced once (op by op it compiles ~250 programs)
    object.__setattr__(trainer.model, "init", jax.jit(trainer.model.init))
    state = trainer.init_state()
    sd = joint_state_dict_from_flax(jax.device_get(state.params), qc, icfg)
    jcache = JaxCache(cache.embeddings, cache.masks, cache.fields,
                      cache.item_ids)
    tok = JaxHashTokenizer(demo.VOCAB, 10, 2)
    split = int(0.8 * len(users))
    train_ds = jax_train.JointDataset(users[:split], emb, tok, items, jcache,
                                      jc, max_negatives=10,
                                      item_emb_dim=demo.HIDDEN)
    test_ds = jax_train.JointDataset(users[split:], emb, tok, items, jcache,
                                     jc, max_negatives=99,
                                     item_emb_dim=demo.HIDDEN)
    rng = np.random.RandomState(seed)
    want_losses = []
    for _ in range(steps):
        idx = rng.randint(0, len(train_ds), batch)
        state, m = trainer._train_step(state, {
            k: jnp.asarray(v) for k, v in train_ds.batch(idx.tolist()).items()})
        want_losses.append(float(m["loss"]))
    want = trainer.evaluate(state, test_ds, batch_size=16, max_negatives=99,
                            ks=(10,))

    losses = []
    got = int8_base_convergence.run(True, cache, emb, items, users,
                                    steps=steps, device="cpu", params=sd,
                                    losses=losses)
    np.testing.assert_allclose([float(x) for x in losses], want_losses,
                               rtol=1e-3, atol=1e-5)
    assert set(got) == {"mrr", "recall@10", "ndcg@10"}
    assert got["mrr"] == pytest.approx(float(want["mrr"]), abs=2e-4)
    for k in ("recall@10", "ndcg@10"):
        assert got[k] == pytest.approx(float(want[k]), abs=1e-9), k


# -- the demo's stages --------------------------------------------------------------


def test_demo_stages_run_and_report_the_jax_keys():
    cache, emb, items, users, fields, masks = demo.make_corpus()
    item = demo.item_stage(cache, users, fields, masks, steps=3,
                           device="cpu")
    user = demo.user_stage(users, fields, masks, steps=3, device="cpu")
    joint = demo.joint_stage(cache, emb, items, users, steps=3, device="cpu")
    side = "unirec_tpu_torch"
    assert set(item) == {"stage", "steps", side}
    assert set(item[side]) == {"val_recon_mse", "val_cosine"}
    assert set(user) == {"stage", "steps", "val_windows", "predict_zero_mse",
                         side}
    assert set(user[side]) == {"val_pred_mse", "val_token_cosine"}
    assert set(joint) == {"stage", "steps", "test_users", "untrained_init",
                          side}
    assert set(joint[side]) == set(joint["untrained_init"]) == {
        "mrr", "recall@10", "ndcg@10"}
    assert (item["steps"], user["steps"], joint["steps"]) == (3, 3, 3)
    assert joint["test_users"] == 32 and user["val_windows"] > 0
    for metrics in (item[side], user[side], joint[side]):
        assert all(np.isfinite(v) for v in metrics.values())
    assert [json.loads(json.dumps(r))["stage"] for r in (item, user, joint)
            ] == ["item", "user", "joint"]


# -- the runner's verdicts ----------------------------------------------------------


def _jax_gates():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_gates", os.path.join(REPO, "scripts", "quality_gates.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ENGINE_OUTPUTS = [
    ("QUALITY bf16: cos_mean=0.999990 cos_min=0.999934 rel_l2_mean=0.00400 "
     "rel_l2_max=0.00900\nQUALITY int8: cos_mean=0.999900 cos_min=0.999272 "
     "rel_l2_mean=0.01000 rel_l2_max=0.03000\n", 0),
    ("QUALITY bf16: cos_mean=0.999990 cos_min=0.999934 rel_l2_mean=0.00400 "
     "rel_l2_max=0.00900\nQUALITY int8: cos_mean=0.999000 cos_min=0.998999 "
     "rel_l2_mean=0.01000 rel_l2_max=0.03000\n", 0),
    ("QUALITY bf16: cos_mean=0.999990 cos_min=0.999934 rel_l2_mean=0.00400 "
     "rel_l2_max=0.00900\n", 0),
    ("QUALITY bf16: cos_mean=0.999990 cos_min=0.999934 rel_l2_mean=0.00400 "
     "rel_l2_max=0.00900\nQUALITY int8: cos_mean=0.999900 cos_min=0.999272 "
     "rel_l2_mean=0.01000 rel_l2_max=0.03000\n", 1),
]


def _converge_output(d_recall, d_mrr, n_test):
    j = {"steps": 800, "exact": {"mrr": 0.1464, "recall@10": 0.2812,
                                 "ndcg@10": 0.1632},
         "int8_base": {"mrr": round(0.1464 + d_mrr, 4),
                       "recall@10": round(0.2812 + d_recall, 4),
                       "ndcg@10": 0.17}}
    if n_test is not None:
        j["n_test"] = n_test
    return "log line\n" + json.dumps(j) + "\n"


CONVERGE_OUTPUTS = [
    (_converge_output(0.0626, 0.0014, 32), 0),  # 2 flips of 32: within
    (_converge_output(0.0938, 0.0014, 32), 0),  # 3 flips: over 2.5
    (_converge_output(0.0625, 0.0014, 200), 0),  # n_test 200: tol 0.05
    (_converge_output(0.045, 0.0014, 200), 0),
    (_converge_output(0.0312, 0.0501, 32), 0),  # MRR keeps 0.05
    (_converge_output(0.0626, 0.0014, None), 0),  # no n_test: 32
    (_converge_output(0.0, 0.0, 32), 1),
    ("no json here\n", 0),
]


@pytest.mark.parametrize("gate,case", [("engine", i) for i in range(len(
    ENGINE_OUTPUTS))] + [("converge", i) for i in range(len(
        CONVERGE_OUTPUTS))])
def test_gate_verdicts_match_jax(gate, case, monkeypatch):
    stdout, rc = (ENGINE_OUTPUTS if gate == "engine" else
                  CONVERGE_OUTPUTS)[case]

    def fake_run(cmd, *args, **kwargs):
        return subprocess.CompletedProcess(cmd, rc, stdout, "stderr"), 1.0

    jg = _jax_gates()
    monkeypatch.setattr(jg, "run", fake_run)
    monkeypatch.setattr(quality_gates, "run", fake_run)
    want = getattr(jg, f"gate_{gate}")()
    got = getattr(quality_gates, f"gate_{gate}")("cpu")
    assert got[0] == want[0]
    if want[0] or gate == "converge" and "d_mrr" in want[1]:
        assert got[1] == want[1]
