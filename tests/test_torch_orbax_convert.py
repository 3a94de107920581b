"""The orbax converter: ``scripts/orbax_to_torch.py`` (the JAX half) with
``utils/checkpoint.save_converted_checkpoint`` and
``train/common.optimizer_state_from_optax`` (the port half), on the CPU at
tiny sizes in float32 with dropout off.

For each kind of JAX checkpoint (item, user with a frozen context, joint,
MWNE) the JAX trainer takes a few steps (the item one with gradient
accumulation 2, warmup and clipping over 3 steps, so that the accumulator,
``mini_step`` and the schedule's count are not trivial), saves as the JAX
package's trainers save (orbax ``state/`` and ``meta.json``), and the script
converts.  The port's own reader (``restore_train_state``) then restores
into the port trainer's fresh state: parameters and adam moments (and the
accumulator) are bit for bit ``flax_to_state_dict`` of the JAX trees, the
counters and the step equal.  One more step on each side on the same batch:
loss within 1e-5 relative, every parameter within 1e-5 max|d| / max|ref|
over the model's parameters.  Held tensor by tensor, its own max|ref| would
not do: Adam normalises each element's update, so the two frameworks'
rounding of a gradient (the step parity tests hold gradients to about 1e-3
relative) reaches about lr x 1e-3 in an element whatever the tensor's size:
up to 5.5e-5 of their own max in the zero-initialised biases, which only a
few updates of lr have moved, and noise in the attention key biases, whose
exact gradient is 0 (C-11's rule, one level up).  The converted item checkpoint read by
the port's ``QFormerInference`` equals the orbax original read by the JAX
``QFormerInference``: the fp32 query tokens of the two packages' models on
what each reader returns within atol 2e-5, rtol 1e-4, and the port's
``QFormerInference`` on the converted directory gives the same tokens as on
the JAX reader's parameters, bit for bit.
A joint checkpoint saved under pipeline parallelism converts its parameters
and step and writes no optimizer state.  Each kind's JAX run is shared by
its tests through a module fixture.
"""

import dataclasses
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.cli.train_cli import _joint_cfg_meta
from unirec_tpu.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    MeshConfig,
    MWNEConfig,
    OptimizerConfig,
    Qwen3Config,
    TrainConfig,
    UserQFormerConfig,
)
from unirec_tpu.data.cache import FieldEmbeddingCache as JaxCache
from unirec_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from unirec_tpu.inference.qformer_inference import (
    QFormerInference as JaxQFormerInference,
)
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.train import item_qformer as jax_item
from unirec_tpu.train import joint as jax_joint
from unirec_tpu.train import mwne as jax_mwne
from unirec_tpu.train import user_qformer as jax_user
from unirec_tpu.utils.checkpoint import save_checkpoint
from unirec_tpu_torch import configs as pconfigs
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import HashTokenizer
from unirec_tpu_torch.inference.qformer_inference import QFormerInference
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.train import item_qformer as port_item
from unirec_tpu_torch.train import joint as port_joint
from unirec_tpu_torch.train import mwne as port_mwne
from unirec_tpu_torch.train import user_qformer as port_user
from unirec_tpu_torch.train.common import TrainState
from unirec_tpu_torch.utils.checkpoint import (
    OPTIMIZER_FILE,
    read_meta,
    restore_params_and_step,
    restore_train_state,
)
from unirec_tpu_torch.utils.weights import (
    flax_to_state_dict,
    item_qformer_state_dict_from_flax,
)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "orbax_to_torch", os.path.join(ROOT, "scripts", "orbax_to_torch.py"))
o2t = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(o2t)

TOL = 1e-5


def _init(trainer):
    """The JAX trainer's fresh state, its init traced once (the eager Flax
    init runs op by op)."""
    return jax.jit(lambda: trainer.init_state(seed=0))()


def _convert(src, dst):
    logs = []
    o2t.convert(str(src), str(dst), log=logs.append)
    return logs


def _numpy(tree):
    """A JAX parameter tree as nested dicts of numpy arrays, without optax's
    masked leaves (the frozen parameters' moments)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, optax.MaskedNode):
            continue
        v = _numpy(v) if hasattr(v, "items") else np.asarray(v)
        if not (isinstance(v, dict) and not v):
            out[k] = v
    return out


def _sd(tree):
    """flax_to_state_dict of a JAX tree, masked leaves left out."""
    return flax_to_state_dict(_numpy(tree))


def _states(opt_state, cls):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, cls)) if isinstance(s, cls)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale else 1.0))


def _check_restored(pstate, jstate, grad_accum):
    """Parameters, moments and the accumulator bit for bit, counters and
    step equal."""
    want = _sd(jstate.params)
    got = pstate.model.state_dict()
    names = {n for n, _ in pstate.model.named_parameters()}
    assert names <= set(want)
    for name in names:
        assert torch.equal(got[name], want[name]), name
    adam = _states(jstate.opt_state, optax.ScaleByAdamState)
    assert len(adam) == 1
    opt = pstate.optimizer
    assert opt.count == int(adam[0].count) > 0
    for mine, theirs in ((opt.mu, adam[0].mu), (opt.nu, adam[0].nu)):
        theirs = _sd(theirs)
        assert set(mine) == set(theirs) == set(opt.params)
        for name, t in mine.items():
            assert torch.equal(t, theirs[name]), name
    multi = _states(jstate.opt_state, optax.MultiStepsState)
    assert opt.k == grad_accum and len(multi) == (grad_accum > 1)
    if multi:
        assert opt.mini_step == int(multi[0].mini_step) > 0
        assert opt.gradient_step == int(multi[0].gradient_step) > 0
        acc = _sd(multi[0].acc_grads)
        for name, t in opt.acc.items():
            assert torch.equal(t, acc[name]), name
    assert pstate.step == int(jstate.step)


def _check_next_step(jloss, jparams, ploss, pmodel):
    assert abs(float(ploss) - float(jloss)) <= TOL * abs(float(jloss))
    want = _sd(jparams)
    top = max(float(np.abs(want[n].numpy()).max())
              for n, _ in pmodel.named_parameters())
    for name, p in pmodel.named_parameters():
        err = float(np.abs(p.detach().numpy() - want[name].numpy()).max())
        assert err <= TOL * top, (name, err, top)


# -- item ----------------------------------------------------------------------

ITEM = ItemQFormerConfig(hidden_size=32, num_hidden_layers=1,
                         num_attention_heads=4, intermediate_size=64,
                         num_query_tokens=4, field_embedding_dim=32,
                         num_fields=4, dropout=0.0)
ITEM_OPT = OptimizerConfig(learning_rate=1e-3, warmup_steps=2,
                           max_grad_norm=1.0, gradient_accumulation_steps=2)


def _item_tc():
    return TrainConfig(batch_size=6, seed=3, optimizer=ITEM_OPT,
                       mesh=MeshConfig(dp=1))


@pytest.fixture(scope="module")
def item_run(tmp_path_factory):
    """The JAX item trainer 3 steps (grad_accum 2), saved as
    ``train_item_qformer`` saves; its fourth batch and step; the cache."""
    rng = np.random.default_rng(0)
    n, f, d = 24, ITEM.num_fields, ITEM.field_embedding_dim
    emb = rng.standard_normal((n, f, d), dtype=np.float32)
    masks = (rng.random((n, f)) > 0.25).astype(np.float32)
    masks[3] = 0.0
    emb *= masks[..., None]
    ids = [f"it{i}" for i in range(n)]
    fields = [f"f{i}" for i in range(f)]
    jt = jax_item.ItemQFormerTrainer(ITEM, _item_tc(),
                                     fused_reference_forwards=False)
    state = _init(jt)
    step = jax.jit(jax_item.make_train_step(jt.model, seed=3))
    batches = []
    for _ in range(4):
        a, p, q = (rng.choice(n, 6) for _ in range(3))
        batches.append({"anchor_emb": emb[a], "anchor_mask": masks[a],
                        "pos_emb": emb[p], "pos_mask": masks[p],
                        "neg_emb": emb[q], "neg_mask": masks[q]})
    for b in batches[:3]:
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    src = tmp_path_factory.mktemp("item") / "jax"
    save_checkpoint(str(src), state, config=ITEM,
                    extra={"field_names": fields, "val_recon_loss": 0.5,
                           "grad_accum": 2})
    nxt, m = step(state, {k: jnp.asarray(v) for k, v in batches[3].items()})
    dst = src.parent / "port"
    logs = _convert(src, dst)
    return dict(state=state, src=src, dst=dst, logs=logs, batch=batches[3],
                next_params=nxt.params, next_loss=float(m["loss"]),
                emb=emb, masks=masks, fields=fields)


def test_item_checkpoint_converts_restores_and_resumes(item_run):
    r = item_run
    meta = read_meta(str(r["dst"]))
    assert meta["field_names"] == r["fields"] and meta["grad_accum"] == 2
    assert meta["config_class"] == "ItemQFormerConfig" and meta["step"] == 3
    assert "gradient accumulation 2" in r["logs"][0]
    pt = port_item.ItemQFormerTrainer(ITEM, _item_tc(), device="cpu",
                                      fused_reference_forwards=False)
    pstate, _ = restore_train_state(str(r["dst"]), pt.init_state())
    _check_restored(pstate, r["state"], 2)
    step = port_item.make_train_step(pstate.model, seed=3)
    pstate, pm = step(pstate, r["batch"], None)
    _check_next_step(r["next_loss"], r["next_params"], pm["loss"],
                     pstate.model)
    assert pstate.optimizer.mini_step == 0  # the 4th micro-step applied


def test_converted_item_checkpoint_serves_as_the_jax_one(item_run):
    r = item_run
    jcfg, jparams, jfields = JaxQFormerInference._load_checkpoint(
        str(r["src"]))
    pcfg, psd, pfields = QFormerInference.read_checkpoint(str(r["dst"]))
    assert pfields == jfields == r["fields"]
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    want = JaxItemQFormer(jcfg).apply(
        jparams, jnp.asarray(r["emb"]),
        jnp.asarray(r["masks"]))["query_outputs"]
    model = ItemQFormer(pcfg)
    model.load_state_dict(psd)
    with torch.no_grad():
        got = model.query_outputs(torch.from_numpy(r["emb"]),
                                  torch.from_numpy(r["masks"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    served = QFormerInference(str(r["dst"]), device="cpu", use_fused=False
                              ).query_tokens_from_embeddings(r["emb"],
                                                             r["masks"])
    direct = QFormerInference(
        config=pcfg, params=item_qformer_state_dict_from_flax(jparams),
        field_names=jfields, device="cpu", use_fused=False
    ).query_tokens_from_embeddings(r["emb"], r["masks"])
    np.testing.assert_array_equal(served, direct)


# -- user ----------------------------------------------------------------------

UD, UK, US = 32, 4, 12
USER = UserQFormerConfig(hidden_size=UD, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=64,
                         num_query_tokens=8, input_embedding_dim=UD,
                         num_item_tokens_to_predict=UK, dropout=0.0)


def _user_tc():
    return TrainConfig(batch_size=6, seed=3,
                       optimizer=OptimizerConfig(learning_rate=1e-3,
                                                 weight_decay=0.01),
                       mesh=MeshConfig(dp=1))


@pytest.fixture(scope="module")
def user_run(tmp_path_factory):
    """The JAX user trainer (context encoders frozen: multi_transform) 2
    steps, saved as ``train_user_qformer`` saves, and its third step."""
    rng = np.random.RandomState(5)
    n = 30
    ids = [f"i{j}" for j in range(n)]
    cache = JaxCache(rng.randn(n, 3, UD).astype(np.float32),
                     np.ones((n, 3), np.float32), ["a", "b", "c"], ids)
    tokens = rng.randn(n, UK, UD).astype(np.float32)
    histories = [{"history": [ids[j] for j in rng.choice(n, m)]}
                 for m in (8, 12, 5, 9)]
    samples = jax_user.build_sliding_window_samples(histories)
    ts_map = jax_user.build_timestamp_map(
        {i: [{"unixReviewTime": int(1.5e9) + 3600 * j}]
         for j, i in enumerate(ids)})
    jt = jax_user.UserQFormerTrainer(USER, _user_tc(), max_seq_len=US,
                                     train_context=False)
    state = _init(jt)
    step = jax.jit(jt._make_step())
    batches = [jt.make_batch(samples, list(range(i * 6, i * 6 + 6)), tokens,
                             cache, ts_map) for i in range(3)]
    for b in batches[:2]:
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    src = tmp_path_factory.mktemp("user") / "jax"
    save_checkpoint(str(src), state, config=USER,
                    extra={"epoch": 0, "loss": 1.0, "grad_accum": 1})
    nxt, m = step(state, {k: jnp.asarray(v) for k, v in batches[2].items()})
    dst = src.parent / "port"
    _convert(src, dst)
    return dict(state=state, dst=dst, batch=batches[2], next_params=nxt.params,
                next_loss=float(m["loss"]))


def test_user_checkpoint_converts_restores_and_resumes(user_run):
    r = user_run
    pt = port_user.UserQFormerTrainer(USER, _user_tc(), max_seq_len=US,
                                      train_context=False, device="cpu")
    pstate, meta = restore_train_state(str(r["dst"]), pt.init_state())
    assert meta["config_class"] == "UserQFormerConfig"
    assert all(n.startswith("user.") for n in pstate.optimizer.params)
    _check_restored(pstate, r["state"], 1)
    pstate, pm = port_user.make_train_step(pstate.model)(pstate, r["batch"])
    _check_next_step(r["next_loss"], r["next_params"], pm["loss"],
                     pstate.model)


# -- joint ---------------------------------------------------------------------

VOCAB, HIDDEN, WIDTH, JF = 128, 32, 24, 3
QWEN = Qwen3Config(vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=64,
                   num_hidden_layers=1, num_attention_heads=2,
                   num_key_value_heads=1, head_dim=16, flash_attention=False)
QF = ItemQFormerConfig(hidden_size=HIDDEN, num_hidden_layers=1,
                       num_attention_heads=2, intermediate_size=64,
                       num_query_tokens=2, field_embedding_dim=WIDTH,
                       num_fields=JF, dropout=0.0)
LORA = LoRAConfig(r=4, alpha=8.0, dropout=0.0)
JC = JointModelConfig(num_history_items=3, max_length=32)
JOINT_OPT = OptimizerConfig(learning_rate=1e-3, warmup_steps=2,
                            max_grad_norm=1.0)


def _joint_tc():
    return TrainConfig(batch_size=2, optimizer=JOINT_OPT,
                       mesh=MeshConfig(dp=1))


def _joint_datasets(module, cache_cls, tok_cls):
    rng = np.random.RandomState(13)
    ids = [f"i{j}" for j in range(12)]
    emb = rng.randn(12, JF, WIDTH).astype(np.float32)
    masks = np.ones((12, JF), np.float32)
    item_emb = {i: rng.randn(HIDDEN).astype(np.float32).tolist() for i in ids}
    item_dict = {i: {"title": f"item {j}"} for j, i in enumerate(ids)}
    data = []
    for _ in range(6):
        cand = list(rng.choice(ids, 4, replace=False))
        data.append({"history": list(rng.choice(ids, 3, replace=False)),
                     "candidate": cand, "ground_truth": cand[0]})
    cache = cache_cls(emb, masks, [f"f{i}" for i in range(JF)], ids)
    tok = tok_cls(VOCAB, JC.num_history_items, JC.num_query_tokens_per_item)
    return module.JointDataset(data, item_emb, tok, item_dict, cache, JC,
                               max_negatives=3, item_emb_dim=HIDDEN)


@pytest.fixture(scope="module")
def joint_run(tmp_path_factory):
    """The JAX joint trainer 2 steps (warmup, clipping, the frozen base under
    multi_transform), saved as ``train joint`` saves, its third step; and the
    same parameters saved as ``train joint --pp`` saves them."""
    jds = _joint_datasets(jax_joint, JaxCache, JaxHashTokenizer)
    jt = jax_joint.JointTrainer(QWEN, QF, JC, lora=LORA,
                                train_config=_joint_tc())
    state = _init(jt)
    step = jax.jit(jax_joint.make_joint_train_step(jt.model, 0.07))
    idx = [np.array([0, 1]), np.array([2, 3]), np.array([4, 5])]
    for i in idx[:2]:
        state, _ = step(state, {k: jnp.asarray(v)
                                for k, v in jds.batch(i).items()})
    root = tmp_path_factory.mktemp("joint")
    extra = {"mrr": 0.25, "grad_accum": 1, **_joint_cfg_meta(QWEN, QF)}
    save_checkpoint(str(root / "jax"), state, config=JC, extra=extra)
    shim = types.SimpleNamespace(params=state.params,
                                 opt_state={"pp_layout": True}, step=2)
    save_checkpoint(str(root / "jax_pp"), shim, config=JC, extra=extra)
    nxt, m = step(state, {k: jnp.asarray(v)
                          for k, v in jds.batch(idx[2]).items()})
    _convert(root / "jax", root / "port")
    pp_logs = _convert(root / "jax_pp", root / "port_pp")
    return dict(state=state, root=root, batch_idx=idx[2],
                next_params=nxt.params, next_loss=float(m["loss"]),
                pp_logs=pp_logs)


def _port_joint_trainer():
    return port_joint.JointTrainer(QWEN, QF, JC, lora=LORA,
                                   train_config=_joint_tc(), device="cpu")


def test_joint_checkpoint_converts_restores_and_resumes(joint_run):
    r = joint_run
    meta = read_meta(str(r["root"] / "port"))
    assert meta["qwen_config"] == dataclasses.asdict(QWEN)
    assert meta["qformer_config"] == dataclasses.asdict(QF)
    assert meta["grad_accum"] == 1 and meta["mrr"] == 0.25
    pt = _port_joint_trainer()
    pstate, _ = restore_train_state(str(r["root"] / "port"), pt.init_state())
    _check_restored(pstate, r["state"], 1)
    pds = _joint_datasets(port_joint, FieldEmbeddingCache, HashTokenizer)
    step = port_joint.make_joint_train_step(pstate.model)
    pstate, pm = step(pstate, pds.batch(r["batch_idx"]))
    _check_next_step(r["next_loss"], r["next_params"], pm["loss"],
                     pstate.model)


def test_pp_saved_joint_checkpoint_converts_params_and_step(joint_run):
    r = joint_run
    dst = r["root"] / "port_pp"
    assert not os.path.exists(dst / OPTIMIZER_FILE)
    assert "no optimizer state" in r["pp_logs"][0]
    assert read_meta(str(dst))["step"] == 2
    pstate, _ = restore_params_and_step(str(dst), _port_joint_trainer()
                                        .init_state())
    want = _sd(r["state"].params)
    for name, p in pstate.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
    assert pstate.step == 2 and pstate.optimizer.count == 0


# -- MWNE ----------------------------------------------------------------------

MWNE_DIMS = dict(embedding_dim=16, num_frequencies=4)


@jax.jit
def _mwne_draws_jax(key):
    r_batch, r_loss = jax.random.split(key)
    numbers = jax_mwne.generate_training_batch(r_batch, 64)
    r_add, r_dist = jax.random.split(r_loss)
    ra, rb = jax.random.split(r_add)
    ia = jax.random.randint(ra, (32,), 0, 64)
    ib = jax.random.randint(rb, (32,), 0, 64)
    trip = jnp.stack([jax.random.choice(k, 64, (3,), replace=False)
                      for k in jax.random.split(r_dist, 10)])
    return numbers, ia, ib, trip


def _mwne_draws(key):
    """The JAX MWNE step's batch and indices, drawn as ``_make_step`` draws
    them (tests/test_torch_mwne_train.py)."""
    return [torch.from_numpy(np.array(a)) for a in _mwne_draws_jax(key)]


def test_mwne_checkpoint_converts_restores_and_resumes(tmp_path):
    cfg = MWNEConfig(**MWNE_DIMS)
    jtr = jax_mwne.MWNETrainer(cfg, lr=1e-3, seed=0)
    params, opt_state = jtr.params, jtr.opt_state
    for i in range(2):
        params, opt_state, _ = jtr._step(params, opt_state,
                                         jax.random.PRNGKey(i))
    shim = types.SimpleNamespace(params=params, opt_state=opt_state, step=2)
    save_checkpoint(str(tmp_path / "jax"), shim, config=cfg,
                    extra={"final_metrics": {"invertibility_mean": 0.1}})
    _convert(tmp_path / "jax", tmp_path / "port")
    ptr = port_mwne.MWNETrainer(pconfigs.MWNEConfig(**MWNE_DIMS), lr=1e-3,
                                device="cpu")
    pstate, meta = restore_train_state(
        str(tmp_path / "port"), TrainState(ptr.model, ptr.optimizer, 0))
    assert meta["final_metrics"] == {"invertibility_mean": 0.1}
    _check_restored(pstate, types.SimpleNamespace(
        params=params, opt_state=opt_state, step=2), 1)
    key = jax.random.PRNGKey(7)
    numbers, ia, ib, trip = _mwne_draws(key)
    nxt, _, m = jtr._step(params, opt_state, key)
    pm = ptr.step(numbers, ia.long(), ib.long(), trip.long())
    _check_next_step(m["total"], nxt, pm["total"], ptr.model)


def test_train_cli_joint_resumes_from_parameters_without_optimizer(
        tmp_path, capsys):
    """``train joint --resume`` over a directory with ``params.pt`` and no
    ``optimizer.pt`` (what a pp-saved JAX checkpoint converts to) restores
    the parameters and the step and restarts the optimizer, as the JAX
    CLI's resume does."""
    from tests.test_torch_train_joint import _cli_files
    from unirec_tpu_torch.cli import train_cli

    argv = _cli_files(tmp_path)
    assert train_cli.main(argv) == 0
    latest = tmp_path / "ck" / "latest_model"
    os.remove(latest / OPTIMIZER_FILE)
    capsys.readouterr()
    assert train_cli.main(argv + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "restored params + step only" in out
    assert "resumed from" in out and read_meta(str(latest))["step"] == 5
