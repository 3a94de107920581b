"""The port's GPipe pipeline (``parallel/pipeline.py``,
``train/joint.PipelinedJointTrainer``, ``train joint --pp``) on the CPU, in
float32, against the JAX package and the port's one-rank step.

Two gloo worlds (``tests/torch_dist_ranks.py``: torch and the port only)
are spawned once for the module: (pp 2, dp 1) and (pp 2, dp 2), both with
M = 2 microbatches, on ``tests/test_pipeline.py``'s tiny joint model (4
layers, widths 64, 2 history items, LoRA r = 2; parameters from the Flax
``init`` with ``lora_b`` randomised).  The JAX references run here
meanwhile, the JAX pipeline on a (dp 1, pp 2) mesh of the virtual CPU
devices.

* the deterministic ``joint_pp_forward`` on every rank's rows against the
  JAX ``model.apply`` and the JAX ``joint_pp_forward``: max |d| <= 2e-5
  (``tests/test_pipeline.py``'s tolerance);
* one step's gradients, merged over the stages, against ``jax.grad`` of
  InfoNCE with dropout off (the joint step's tolerance of
  ``tests/test_torch_train_joint.py``) and against the one-rank port's
  (1e-4 of each leaf's largest entry); the loss and the parameters after
  the step within 1e-5 of the one-rank step's, the replicated parameters
  bit for bit equal on every rank, the merged tree's evaluation equal to
  the one-rank one;
* a step at LoRA dropout 0.1: a finite loss, other than the dropout-free
  one, and only trainable leaves changed;
* the split / merge round trip bit for bit; pp = 1 with one microbatch is
  the plain step bit for bit;
* a pipeline checkpoint (merged parameters, step, the ``pp_layout``
  sentinel) resumes with parameters and step only; ``train joint --pp 2
  --pp-microbatches 2`` as torchrun's ranks, then ``train joint --resume``
  from its checkpoint on one rank;
* the refusals: layers that pp does not divide, a batch that dp x M does
  not divide, flash-VJP, tp > 1 and ``int8_base``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_ranks as ranks
from tests.test_torch_joint import randomize_lora_b
from tests.test_torch_tp import (
    FWD_ATOL,
    GRAD_ATOL,
    GRAD_FLOOR,
    GRAD_REL,
    GRAD_RTOL,
    JC2,
    LORA2,
    QWEN4,
    STEP_TOL,
    TEMPERATURE,
    _close,
    _mkdir,
    joint_datasets,
    port_configs,
    port_tc,
)
from tests.test_torch_train_joint import QF, _data
from tests.test_torch_train_joint import _cli_files as _joint_cli_files
from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.models.joint import MultiModalQwenEmbedding as JaxJoint
from unirec_tpu.ops import losses as jax_losses
from unirec_tpu.parallel import pipeline as jax_pipeline
from unirec_tpu_torch.parallel import pipeline as pp
from unirec_tpu_torch.train import joint as port_joint
from unirec_tpu_torch.utils.checkpoint import has_train_state, read_meta
from unirec_tpu_torch.utils.params import is_trainable
from unirec_tpu_torch.utils.weights import joint_state_dict_from_flax


WORLDS = {"pp2": 2, "pp4": 4}  # (pp 2, dp 1) and (pp 2, dp 2)
KEYS = ("input_ids", "attention_mask", "history_field_embeddings",
        "history_attention_mask")


def jax_references(batch):
    """Parameters, ``model.apply``, the JAX pipeline's forward on a (dp 1,
    pp 2) mesh (M = 2) and ``jax.grad`` of InfoNCE, on ``batch``."""
    model = JaxJoint(QWEN4, QF, JC2, lora=LORA2)
    args = [jnp.asarray(batch[k]) for k in KEYS]
    params = randomize_lora_b(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                  *args), seed=5)["params"]
    user = jax.jit(lambda p, *a: model.apply({"params": p}, *a))(params,
                                                                 *args)
    mesh = jax_pipeline.make_pp_mesh(pp=2, dp=1)
    pipe = jax_pipeline.PipelinedQwen3(QWEN4, mesh, num_microbatches=2,
                                       lora=LORA2, n_extra_tokens=4)
    stacked, rest, qf = jax_pipeline.split_joint_params({"params": params})
    pp_user = jax.jit(lambda st, rs, q: jax_pipeline.joint_pp_forward(
        model, pipe, st, rs, q, *args, deterministic=True))(stacked, rest, qf)

    def loss(p, b):
        u = model.apply({"params": p}, *(b[k] for k in KEYS),
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_losses.info_nce_loss(
            u, b["positive_item_embeddings"], b["negative_item_embeddings"],
            b["negative_masks"], temperature=TEMPERATURE)

    grads = jax.jit(jax.grad(loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = joint_state_dict_from_flax(grads, QWEN4, QF)
    return (params, np.asarray(user), np.asarray(pp_user),
            {n: np.asarray(g) for n, g in grads.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pp"))
    train_ds, val_ds = joint_datasets(_data())
    batch = train_ds.batch(list(range(8)))
    params, user, pp_user, grads = jax_references(batch)
    sd = joint_state_dict_from_flax(params, QWEN4, QF)
    joint_cli = _joint_cli_files(_mkdir(work, "joint_cli"))
    qwen, qf, jc, lora = port_configs()
    inputs = {"joint": dict(
        qwen=qwen, qf=qf, jc=jc, lora=lora, params=sd, tc=port_tc(8),
        batches=[batch], val=val_ds,
        lora_dropout=port_configs(dataclasses.replace(LORA2,
                                                      dropout=0.1))[3]),
        "cli": [(joint_cli + ["--pp", "2", "--pp-microbatches", "2"],
                 None)]}
    torch.save(inputs, os.path.join(work, "pp.inputs.pt"))
    procs = {case: ranks.start_group(case, world, work)
             for case, world in WORLDS.items()}

    trainer = port_joint.JointTrainer(qwen, qf, jc, lora=lora,
                                      train_config=port_tc(8), device="cpu")
    state = trainer.init_state(params=sd)
    ev = trainer.evaluate(state, val_ds, batch_size=6, max_negatives=7)
    step = port_joint.make_joint_train_step(state.model, return_grads=True,
                                            seed=3)
    state, m = step(state, batch)
    ref = {"jax_user": user, "jax_pp_user": pp_user, "jax_grads": grads,
           "sd": sd, "eval": ev, "loss": float(m["loss"]),
           "grads": m["grads"], "params": state.model.state_dict(),
           "work": work, "joint_cli": joint_cli}
    got = {case: ranks.finish_group(case, p, work)
           for case, p in procs.items()}
    return ref, got


def merged_grads(results):
    """The stages' gradients under the joint model's names."""
    out = {}
    prefix = "base_model.layers."
    for r in results:
        for name, g in r["grads"].items():
            if name.startswith(prefix):
                j, _, leaf = name[len(prefix):].partition(".")
                name = f"{prefix}{r['stage'] * r['per'] + int(j)}.{leaf}"
            out[name] = g
    return out


@pytest.mark.parametrize("case", sorted(WORLDS))
def test_pp_forward_matches_jax(runs, case):
    ref, got = runs
    for r in got[case]:
        rows = slice(*r["rows"])
        _close(r["user"], ref["jax_user"][rows], FWD_ATOL, "model.apply")
        _close(r["user"], ref["jax_pp_user"][rows], FWD_ATOL,
               "joint_pp_forward")


@pytest.mark.parametrize("case", sorted(WORLDS))
def test_pp_gradients_match_jax_and_one_rank(runs, case):
    ref, got = runs
    grads = merged_grads(got[case])
    assert set(grads) == set(ref["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref["jax_grads"][name],
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
        want = ref["grads"][name]
        _close(g, want, GRAD_REL * float(want.abs().max()) + GRAD_FLOOR, name)


@pytest.mark.parametrize("case", sorted(WORLDS))
def test_pp_step_and_evaluation_match_one_rank(runs, case):
    ref, got = runs
    for r in got[case]:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=STEP_TOL)
        assert r["merged"].keys() == ref["params"].keys()
        for name, p in ref["params"].items():
            _close(r["merged"][name], p, STEP_TOL, name)
        for k, v in ref["eval"].items():
            assert r["eval"][k] == pytest.approx(v, abs=1e-6), k
    first = got[case][0]["merged"]
    for r in got[case][1:]:
        for name, p in first.items():
            assert torch.equal(r["merged"][name], p), name


def test_pp_step_with_lora_dropout(runs):
    """The counterpart of ``tests/test_pipeline.py``'s dropout step: a
    finite loss, moved by the dropout, and only trainable leaves changed."""
    ref, got = runs
    for r in got["pp2"]:
        d = r["dropout"]
        assert np.isfinite(d["loss"]) and abs(d["loss"] - ref["loss"]) > 1e-6
        assert d["changed"] and all(is_trainable(n) for n in d["changed"])
        assert any("lora" in n for n in d["changed"])


def test_split_merge_round_trip_and_mesh(runs):
    ref, _ = runs
    sd = ref["sd"]
    stacked, rest, qf = pp.split_joint_params(sd)
    assert stacked["self_attn.q_proj.weight"].shape[0] == 4
    merged = pp.merge_joint_params(stacked, rest, qf)
    assert merged.keys() == sd.keys()
    for name, t in sd.items():
        assert torch.equal(merged[name], t), name
    base = {k[len("base_model."):]: v for k, v in sd.items()
            if k.startswith("base_model.")}
    again = pp.merge_layer_params(*pp.split_layer_params(base))
    assert again.keys() == base.keys()
    assert all(torch.equal(again[k], v) for k, v in base.items())
    mesh = pp.make_pp_mesh(2, devices=["d0", "d1", "d2", "d3", "d4"])
    assert mesh.tolist() == [["d0", "d1"], ["d2", "d3"]]  # pp fastest
    with pytest.raises(ValueError, match="mesh 3x2 needs 6 devices, have 5"):
        pp.make_pp_mesh(2, dp=3, devices=["d"] * 5)
    stage = pp.stage_state_dict(stacked, rest, qf, 1, 2)
    assert torch.equal(stage["base_model.layers.0.mlp.down_proj.lora_a"],
                       sd["base_model.layers.2.mlp.down_proj.lora_a"])
    assert "base_model.layers.2.mlp.down_proj.lora_a" not in stage


def test_pp1_single_microbatch_step_is_the_plain_step(runs):
    """One stage and one microbatch through the pipeline's code: the plain
    step's loss, gradients and parameters bit for bit."""
    ref, _ = runs
    train_ds, _ = joint_datasets(_data())
    batch = train_ds.batch(list(range(8)))
    trainer = port_joint.JointTrainer(*port_configs(),
                                      train_config=port_tc(8), device="cpu")
    pt = port_joint.PipelinedJointTrainer(trainer, pp=1)
    ps = pt.init_trainable(trainer.init_state(params=ref["sd"]))
    step = port_joint.make_pipeline_train_step(ps.model, pt.mesh,
                                               return_grads=True, seed=3)
    ps, m = step(ps, batch)
    assert float(m["loss"]) == ref["loss"]
    for name, g in m["grads"].items():
        assert torch.equal(g, ref["grads"][name]), name
    merged = pt.merged_params(ps)
    for name, p in ref["params"].items():
        assert torch.equal(merged[name], p), name


def test_pp_checkpoint_resumes_params_and_step(runs):
    ref, got = runs
    ck = os.path.join(ref["work"], "pp_ck")
    assert read_meta(ck)["pp_layout"] and not has_train_state(ck)
    saved = torch.load(os.path.join(ck, "optimizer.pt"), weights_only=True)
    assert saved == {"step": 1, "optimizer": {"pp_layout": True}}
    trainer = port_joint.JointTrainer(*port_configs(),
                                      train_config=port_tc(8), device="cpu")
    state, meta, whole = trainer.restore(ck, trainer.init_state(seed=11))
    assert not whole and state.step == 1 and state.optimizer.count == 0
    for name, p in got["pp2"][0]["merged"].items():
        assert torch.equal(state.model.state_dict()[name], p), name


def test_train_cli_pp2_and_resume(runs, capsys):
    from unirec_tpu_torch.cli import train_cli

    ref, got = runs
    assert [r["cli"] for r in got["pp2"]] == [[0], [0]]
    argv = ref["joint_cli"]
    latest = os.path.join(argv[argv.index("--checkpoint-dir") + 1],
                          "latest_model")
    meta = read_meta(latest)
    assert meta["pp_layout"] and meta["step"] == 2
    assert train_cli.main(argv + ["--no-remat", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "restored params + step only" in out
    assert f"resumed from {latest} at step 2" in out
    assert read_meta(latest)["step"] == 5 and not read_meta(latest).get(
        "pp_layout")


@pytest.mark.parametrize("case", ["layers", "batch", "flash_vjp", "tp",
                                  "int8_base", "cli_flash_vjp",
                                  "cli_int8_base"])
def test_pp_refusals(case, tmp_path, capsys):
    from unirec_tpu_torch.cli import train_cli

    qwen, qf, jc, lora = port_configs()
    if case == "layers":
        with pytest.raises(ValueError, match="num_hidden_layers=4 not "
                                             "divisible by pp=3"):
            pp.check_pipeline(qwen, 3)
    elif case == "flash_vjp":
        with pytest.raises(ValueError, match="not supported under pipeline"):
            pp.PipelinedQwen3(dataclasses.replace(qwen,
                                                  flash_vjp_attention=True),
                              device="meta")
    elif case == "batch":
        trainer = port_joint.JointTrainer(qwen, qf, jc, lora=lora,
                                          train_config=port_tc(4),
                                          device="cpu")
        pt = port_joint.PipelinedJointTrainer(trainer, pp=1,
                                              num_microbatches=3)
        ps = pt.init_trainable(trainer.init_state())
        train_ds, _ = joint_datasets(_data())
        with pytest.raises(ValueError, match="multiple of "
                                             "dp\\*num_microbatches=3"):
            pt._train_step(ps, train_ds.batch([0, 1, 2, 3]))
    elif case == "int8_base":
        trainer = port_joint.JointTrainer(qwen, qf, jc, lora=lora,
                                          train_config=port_tc(4),
                                          int8_base=True, device="cpu")
        with pytest.raises(ValueError, match="int8_base is incompatible "
                                             "with pipeline"):
            port_joint.PipelinedJointTrainer(trainer, pp=1)
    else:
        argv = _joint_cli_files(tmp_path) + ["--pp", "2"]
        if case == "tp":
            with pytest.raises(ValueError, match="composes with dp only"):
                train_cli.main(argv + ["--tp", "2"])
            return
        flag = "--" + case[4:].replace("_", "-")
        assert train_cli.main(argv + [flag]) == 2
        assert f"--pp is incompatible with {flag}" in capsys.readouterr().err
