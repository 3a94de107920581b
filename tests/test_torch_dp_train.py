"""The port's data- and sequence-parallel training over torch.distributed
against its one-rank step and the JAX trainers' dp and sp meshes, on the
CPU, in float32 with dropout off (but for one sp case).

Ranks are gloo processes (``tests/torch_dist_ranks.py``: torch and the port
only), spawned once for the module: a world of 2 (dp = 2) for the joint,
item and user steps and the checkpoints, a world of 4 (dp = 2 x sp = 2) for
the user stage's sequence parallelism, and a world of 2 that runs
``train user-qformer --sp 2`` as ``torchrun``'s ranks would.  The JAX
trainers run here on meshes of the virtual CPU devices.

* one joint step (one layer each, flash-VJP attention, B7b's plain version under autograd)
  at dp = 2: the loss within 1e-5 of the one-rank step and of the JAX
  ``JointTrainer`` at ``MeshConfig(dp=2)``, every gradient within 1e-5 of
  the one-rank step's and every parameter after the step within 1e-5 of
  both (``tests/test_joint.py``'s dp case); the dp evaluation's metrics
  within 1e-6 of the one-rank evaluation's (which equals the JAX one:
  ``tests/test_torch_train_joint.py``);
* two item steps at dp = 2, the first with shards that hold different
  valid-field counts, the second with one valid field in the whole batch
  (0 < C < S): the same gates against the one-rank step and the JAX
  ``ItemQFormerTrainer`` at dp = 2; the fused anchor with int8 fused
  references (B12s / B12c and B4-B6's plain versions) against its one-rank
  step;
* a user step at dp = 2 with sample weights (shards of weight 1 and 2) and
  one at dp = 2 x sp = 2 against the sp = 1 step and the JAX
  ``UserQFormerTrainer`` at ``MeshConfig(dp=2, sp=2)``
  (``tests/test_sharded_attention.py``); at hidden-state dropout 0.1 (sp
  zeroes attention-prob dropout only), the dp = 2 x sp = 2 step against
  the dp = 2 step built the same way;
* the ranks' parameters are bit for bit equal after every step; a train
  state is written by rank 0 alone, and a restore into rank-dependent
  templates gives every rank the saved state, as does a params-only
  directory (the orbax converter's form for a pipeline checkpoint).
"""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_ranks as ranks
from tests.test_torch_joint import randomize_lora_b
from tests.test_torch_train_joint import JC, LORA, OPT, _data, _datasets
from tests.test_torch_train_joint import QF as QF2
from tests.test_torch_train_joint import QWEN as QWEN2
from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import (
    ItemQFormerConfig,
    MeshConfig,
    TrainConfig,
    UserQFormerConfig,
)
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.models.joint import MultiModalQwenEmbedding as JaxJoint
from unirec_tpu.models.user_qformer import UserQFormer as JaxUserQFormer
from unirec_tpu.models.user_sequence import (
    UserSequenceModel as JaxUserSequence,
)
from unirec_tpu.train import item_qformer as jax_item
from unirec_tpu.train import joint as jax_joint
from unirec_tpu.train import user_qformer as jax_user
from unirec_tpu_torch import configs as pc
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import HashTokenizer
from unirec_tpu_torch.train import item_qformer as port_item
from unirec_tpu_torch.train import joint as port_joint
from unirec_tpu_torch.train import user_qformer as port_user
from unirec_tpu_torch.utils.weights import (
    item_qformer_state_dict_from_flax,
    joint_state_dict_from_flax,
    user_state_dict_from_flax,
)


ATOL = 1e-5
# one layer each: the JAX steps' compile time is most of this file's
QWEN = dataclasses.replace(QWEN2, num_hidden_layers=1)
QF = dataclasses.replace(QF2, num_hidden_layers=1)
ITEM = ItemQFormerConfig(hidden_size=32, num_hidden_layers=1,
                         num_attention_heads=4, intermediate_size=128,
                         num_query_tokens=8, field_embedding_dim=16,
                         num_fields=5, dropout=0.0)
USER = UserQFormerConfig(hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=64,
                         num_query_tokens=4, input_embedding_dim=32,
                         num_item_tokens_to_predict=2, dropout=0.0)
SEQ = 8  # memory 8 x 2 = 16 rows: 8 per sp rank at sp = 2


def _port(cls, cfg, **changes):
    """The port's config of the same fields as a JAX one."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{**{k: v for k, v in dataclasses.asdict(cfg).items()
                     if k in names}, **changes})


def _port_tc(batch_size, dp, sp=1, opt=OPT):
    return pc.TrainConfig(batch_size=batch_size, seed=3,
                          optimizer=_port(pc.OptimizerConfig, opt),
                          mesh=pc.MeshConfig(dp=dp, sp=sp))


def _jax_tc(batch_size, dp, sp=1, opt=OPT):
    return TrainConfig(batch_size=batch_size, seed=3, optimizer=opt,
                       mesh=MeshConfig(dp=dp, tp=1, sp=sp))


@contextlib.contextmanager
def _jitted_inits():
    """The JAX models' ``init`` jitted while the trainers build their
    states (an eager Flax init takes seconds)."""
    import flax.linen as nn

    def init(self, rng, *args, **kw):
        return jax.jit(lambda r, *a: nn.Module.init(self, r, *a, **kw))(
            rng, *args)

    classes = (JaxJoint, JaxItemQFormer, JaxUserQFormer, JaxUserSequence)
    saved = [cls.__dict__.get("init") for cls in classes]
    for cls in classes:
        cls.init = init
    try:
        yield
    finally:
        for cls, old in zip(classes, saved):
            if old is None:
                del cls.init
            else:
                cls.init = old


def _item_batches():
    rng = np.random.default_rng(7)
    out = []
    for c_lt_s in (False, True):
        b = {}
        for x in ("anchor", "pos", "neg"):
            b[f"{x}_emb"] = rng.standard_normal((8, 5, 16), dtype=np.float32)
            b[f"{x}_mask"] = (rng.random((8, 5)) > 0.3).astype(np.float32)
        if c_lt_s:  # one valid field in the batch: 0 < C < S = 2
            b["anchor_mask"][:] = 0.0
            b["anchor_mask"][5, 2] = 1.0
        else:  # shards of different valid counts
            b["anchor_mask"][:4] = 1.0
            b["anchor_mask"][4:, 1:] = 0.0
        out.append(b)
    return out


def _user_batch():
    rng = np.random.default_rng(9)
    return {
        "item_tokens": rng.standard_normal((4, SEQ, 2, 32), dtype=np.float32),
        "timestamps": (rng.random((4, SEQ)) * 1.7e9).astype(np.float32),
        "coordinates": rng.standard_normal((4, SEQ, 2), dtype=np.float32),
        "seq_mask": (rng.random((4, SEQ)) > 0.2).astype(np.float32),
        "target_tokens": rng.standard_normal((4, 2, 32), dtype=np.float32),
        # shard weights 1 and 2: the global weight sum normalises
        "sample_weight": np.asarray([1.0, 0.0, 1.0, 1.0], np.float32),
    }


def _jax_step(trainer, state, batch):
    state, m = trainer._train_step(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state, float(m["loss"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dp_train"))
    groups = {}

    # the user stage: JAX parameters first (the sp world needs them)
    user_batch = _user_batch()
    ju_dp = jax_user.UserQFormerTrainer(USER, _jax_tc(4, 2), max_seq_len=SEQ)
    with _jitted_inits():
        ju_state = ju_dp.init_state(seed=0)
    # a host copy: the sp trainer starts from it (the steps donate states)
    user_host = jax.tree_util.tree_map(np.asarray, ju_state)
    user_sd = user_state_dict_from_flax(user_host.params)
    p_user = _port(pc.UserQFormerConfig, USER)
    sp_inputs = {"user_sp": dict(
        cfg=dataclasses.replace(p_user, sequence_parallel=True),
        tc=_port_tc(4, 2, 2), seq=SEQ, params=user_sd, batch=user_batch)}
    # sp with hidden-state dropout on (the CLI's rate)
    sp_inputs["user_sp_dropout"] = dict(
        sp_inputs["user_sp"],
        cfg=dataclasses.replace(p_user, sequence_parallel=True, dropout=0.1))
    torch.save(sp_inputs, os.path.join(work, "sp.inputs.pt"))
    groups["sp"] = ranks.start_group("sp", 4, work)

    # the joint model (jitted Flax init) and the item Q-Former
    jt = jax_joint.JointTrainer(QWEN, QF, JC, lora=LORA,
                                train_config=_jax_tc(4, 2))
    with _jitted_inits():
        jt_state = jt.init_state()
    jparams = randomize_lora_b({"params": jt_state.params}, seed=5)["params"]
    jt_state = jt_state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                              jparams))
    joint_sd = joint_state_dict_from_flax(jparams, QWEN, QF)
    data = _data()
    ptrain_ds, pval_ds = _datasets(port_joint, FieldEmbeddingCache,
                                   HashTokenizer, data)
    joint_batch = ptrain_ds.batch([0, 1, 2, 3])
    p_qwen = _port(pc.Qwen3Config, QWEN, flash_vjp_attention=True)
    p_qf, p_jc = _port(pc.ItemQFormerConfig, QF), _port(pc.JointModelConfig,
                                                        JC)
    p_lora = _port(pc.LoRAConfig, LORA)

    ji = jax_item.ItemQFormerTrainer(ITEM, _jax_tc(8, 2),
                                     fused_reference_forwards=False)
    with _jitted_inits():
        ji_state = ji.init_state(seed=0)
    item_sd = item_qformer_state_dict_from_flax(ji_state.params)
    item_batches = _item_batches()
    p_item = _port(pc.ItemQFormerConfig, ITEM)
    p_item_fused = dataclasses.replace(p_item, fused_training=True)
    train_inputs = {
        "joint": dict(qwen=p_qwen, qf=p_qf, jc=p_jc, lora=p_lora,
                      tc=_port_tc(4, 2), params=joint_sd, batch=joint_batch,
                      val=pval_ds),
        "item": dict(cfg=p_item, tc=_port_tc(8, 2), params=item_sd,
                     batches=item_batches),
        "item_fused": dict(cfg=p_item_fused, tc=_port_tc(8, 2),
                           params=item_sd, batches=item_batches[:1],
                           fused_refs=True, fused_precision="int8"),
        "user": dict(cfg=p_user, tc=_port_tc(4, 2), seq=SEQ, params=user_sd,
                     batch=user_batch),
        "user_dropout": dict(cfg=dataclasses.replace(p_user, dropout=0.1),
                             probs_dropout_off=True, tc=_port_tc(4, 2),
                             seq=SEQ, params=user_sd, batch=user_batch),
    }
    torch.save(train_inputs, os.path.join(work, "train.inputs.pt"))
    groups["train"] = ranks.start_group("train", 2, work)

    # the JAX dp and sp steps
    ref = {}
    st, ref["jax_joint_loss"] = _jax_step(jt, jt_state, joint_batch)
    ref["jax_joint_params"] = joint_state_dict_from_flax(st.params, QWEN, QF)
    ref["jax_item"] = []
    st = ji_state
    for b in item_batches:
        st, loss = _jax_step(ji, st, b)
        ref["jax_item"].append(
            (loss, item_qformer_state_dict_from_flax(st.params)))
    st, loss = _jax_step(ju_dp, ju_state, user_batch)
    ref["jax_user"] = (loss, user_state_dict_from_flax(st.params))
    ju_sp = jax_user.UserQFormerTrainer(
        dataclasses.replace(USER, sequence_parallel=True), _jax_tc(4, 2, 2),
        max_seq_len=SEQ)
    assert ju_sp.sp_size == 2
    st, loss = _jax_step(ju_sp, user_host, user_batch)
    ref["jax_user_sp"] = (loss, user_state_dict_from_flax(st.params))

    # the port's one-rank steps
    def one_rank(trainer, step_fn, batches, **init):
        state = trainer.init_state(**init)
        step = step_fn(state.model)
        out = []
        for b in batches:
            state, m = step(state, b)
            out.append(ranks._step_result(state, m))
        return state, out

    pj = port_joint.JointTrainer(p_qwen, p_qf, p_jc, lora=p_lora,
                                 train_config=_port_tc(4, 1), device="cpu")
    st = pj.init_state(params=joint_sd)
    ref["joint_eval"] = pj.evaluate(st, pval_ds, batch_size=6,
                                    max_negatives=7)
    _, ref["joint"] = one_rank(pj, functools.partial(
        port_joint.make_joint_train_step, return_grads=True, seed=3),
        [joint_batch], params=joint_sd)
    for key, cfg, fused, n in (("item", p_item, False, 2),
                               ("item_fused", p_item_fused, True, 1)):
        tr = port_item.ItemQFormerTrainer(
            cfg, _port_tc(8, 1), fused_reference_forwards=fused,
            fused_precision="int8", device="cpu")
        assert tr.use_fused == fused
        _, ref[key] = one_rank(tr, functools.partial(
            port_item.make_train_step, return_grads=True, seed=3,
            fused_reference_config=cfg if fused else None,
            fused_precision="int8"), item_batches[:n], params=item_sd)
    pu = port_user.UserQFormerTrainer(p_user, _port_tc(4, 1),
                                      max_seq_len=SEQ, device="cpu")
    _, ref["user"] = one_rank(pu, functools.partial(
        port_user.make_train_step, return_grads=True, seed=3), [user_batch],
        params=user_sd)

    got = {case: ranks.finish_group(case, procs, work)
           for case, procs in groups.items()}
    return ref, got


def _close(got, want, atol=ATOL, rtol=ATOL, what=""):
    assert set(got) == set(want), what
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                   np.asarray(want[name], np.float64),
                                   atol=atol, rtol=rtol,
                                   err_msg=f"{what} {name}")


def _ranks_equal(results):
    for other in results[1:]:
        for name, p in results[0]["params"].items():
            assert torch.equal(p, other["params"][name]), name


def _step_matches(got, want, jax_loss=None, jax_params=None, what=""):
    """dp step ``got`` (rank 0's) against the one-rank step ``want`` and
    the JAX dp step."""
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=ATOL, atol=0)
    _close(got["grads"], want["grads"], what=f"{what} grad")
    _close(got["params"], want["params"], what=f"{what} param")
    if jax_loss is not None:
        np.testing.assert_allclose(got["metrics"]["loss"], jax_loss,
                                   rtol=ATOL, atol=0)
        _close(got["params"], {n: jax_params[n] for n in got["params"]},
               rtol=0, what=f"{what} JAX param")


def test_joint_dp2_step_and_evaluation(runs):
    ref, got = runs
    res = [r["joint"] for r in got["train"]]
    _ranks_equal(res)
    _step_matches(res[0], ref["joint"][0], ref["jax_joint_loss"],
                  ref["jax_joint_params"], "joint")
    for r in res:
        assert r["eval"].keys() == ref["joint_eval"].keys()
        for k, v in ref["joint_eval"].items():
            assert r["eval"][k] == pytest.approx(v, abs=1e-6), k


@pytest.mark.parametrize("batch", [0, 1], ids=["uneven_counts", "c_lt_s"])
def test_item_dp2_steps(runs, batch):
    ref, got = runs
    res = [r["item"][batch] for r in got["train"]]
    _ranks_equal(res)
    loss, params = ref["jax_item"][batch]
    _step_matches(res[0], ref["item"][batch], loss, params, "item")
    assert res[0]["metrics"].keys() == {"loss", "recon", "contrastive"}


def test_item_dp2_fused_anchor_int8_references(runs):
    ref, got = runs
    res = [r["item_fused"][0] for r in got["train"]]
    _ranks_equal(res)
    _step_matches(res[0], ref["item_fused"][0], what="fused item")


def test_user_dp2_weighted_step(runs):
    ref, got = runs
    res = [r["user"] for r in got["train"]]
    _ranks_equal(res)
    _step_matches(res[0], ref["user"][0], *ref["jax_user"], what="user")


def test_user_dp2_sp2_step(runs):
    """sp = 2 splits the memory: the same step as sp = 1 and JAX's."""
    ref, got = runs
    res = [r["user_sp"] for r in got["sp"]]
    _ranks_equal(res)
    _step_matches(res[0], ref["user"][0], *ref["jax_user_sp"], what="sp")


def test_user_dp2_sp2_step_with_hidden_dropout(runs):
    """sp zeroes attention-prob dropout only: at hidden-state dropout 0.1
    the sp ranks of a dp shard draw that shard's masks, so dp = 2 x sp = 2
    steps as dp = 2 x sp = 1 on the same dp-folded stream."""
    ref, got = runs
    res = [r["user_sp_dropout"] for r in got["sp"]]
    _ranks_equal(res)
    want = got["train"][0]["user_dropout"]
    # the dropout is on: the loss is not the dropout-free step's
    assert abs(want["metrics"]["loss"] - ref["user"][0]["metrics"]["loss"]) \
        > 1e-4
    _step_matches(res[0], want, what="sp dropout")


def test_checkpoint_written_once_and_restored_on_every_rank(runs):
    _, got = runs
    res = [r["checkpoint"] for r in got["train"]]
    assert len(res[0]["writes"]) == 2 and res[1]["writes"] == []
    for r in res:
        assert r["step"] == 1 and r["count"] == 1
        assert r["params_only_step"] == 5
        for name, p in r["params"].items():
            assert torch.equal(p, res[0]["saved"][name]), name
            assert torch.equal(r["params_only"][name], res[0]["saved"][name])
        for name, t in r["mu"].items():
            assert torch.equal(t, res[0]["mu"][name]), name
