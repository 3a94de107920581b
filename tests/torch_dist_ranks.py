"""Rank programs of the CPU tests of the port's torch.distributed paths, and
the helpers that spawn them.

    python -m tests.torch_dist_ranks CASE RANK WORLD PORT WORKDIR

A rank imports torch and the port only, never JAX: it joins a gloo world
over ``tcp://127.0.0.1:PORT`` (with a timeout), reads the inputs the test
wrote to ``WORKDIR/CASE.inputs.pt``, runs ``CASES[CASE]`` and writes what it got
to ``WORKDIR/CASE.RANK.pt``.  ``start_group`` spawns the ranks of one
world; ``finish_group`` waits for them with a deadline, kills them when it
passes, and fails with every rank's output.
"""

from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUP_TIMEOUT_S = 120.0  # the collectives' timeout inside a rank


# -- the test side ---------------------------------------------------------------


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` inside the block, restored
    after it.  The port's test modules run on one thread: six test workers
    share eight cores, at tiny shapes every torch op is a parallel region
    whose threads wait for each other, and with six pools of eight threads
    each such wait costs a scheduler slice (a CLI test of 5 s alone took
    248 s in the suite)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A test module on one torch thread (``torch_threads``).  Each of the
    port's test modules imports it by name, which makes pytest use it
    there."""
    with torch_threads(1):
        yield


def child_env(**extra) -> Dict[str, str]:
    """The environment of a spawned rank: one thread (the ranks share the
    machine), the repo importable, no JAX settings."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, **extra)
    return env


def start_group(case: str, world: int, workdir: str) -> List[subprocess.Popen]:
    """Spawn the ``world`` ranks of ``case``; outputs go to files."""
    from unirec_tpu_torch.parallel.mesh import free_port

    port = str(free_port())
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"{case}.{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_ranks", case, str(rank),
             str(world), port, workdir], cwd=REPO, env=child_env(),
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True))
    return procs


def finish(procs: List[subprocess.Popen], logs: List[str],
           timeout: float) -> None:
    """Wait for every process until the deadline; kill them all, with
    whatever they spawned (each leads its own session), when it passes or
    when one fails, and raise with their outputs."""
    deadline = time.monotonic() + timeout
    failed = None
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            failed = "a process failed"
            break
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            failed = f"timed out after {timeout:.0f} s"
            break
        time.sleep(0.1)
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    outputs = []
    for p, log in zip(procs, logs):
        with open(log) as f:
            outputs.append(f"--- {log} (exit {p.returncode}) ---\n"
                           f"{f.read()[-4000:]}")
    raise AssertionError(failed + "\n" + "\n".join(outputs))


def finish_group(case: str, procs: List[subprocess.Popen], workdir: str,
                 timeout: float = 240.0) -> list:
    """Every rank's result of ``case`` (``finish``'s failure otherwise)."""
    import torch

    finish(procs, [os.path.join(workdir, f"{case}.{r}.log")
                   for r in range(len(procs))], timeout)
    return [torch.load(os.path.join(workdir, f"{case}.{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


# -- the ranks ---------------------------------------------------------------------


def _inputs(workdir: str, case: str) -> dict:
    import torch

    return torch.load(os.path.join(workdir, f"{case}.inputs.pt"),
                      weights_only=False)


def _step_result(state, metrics) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()
                        if k != "grads" and v.numel() == 1},
            "grads": {n: g.clone() for n, g in metrics["grads"].items()},
            "params": {n: p.detach().clone()
                       for n, p in state.model.state_dict().items()}}


def _joint(inp: dict) -> dict:
    import numpy as np

    from unirec_tpu_torch.train import joint as port_train

    c = inp["joint"]
    trainer = port_train.JointTrainer(
        c["qwen"], c["qf"], c["jc"], lora=c["lora"],
        train_config=c["tc"], device="cpu")
    assert trainer.mesh.dp_size == 2
    state = trainer.init_state(params=c["params"])
    ev = trainer.evaluate(state, c["val"], batch_size=6, max_negatives=7)
    step = port_train.make_joint_train_step(state.model, return_grads=True,
                                            seed=c["tc"].seed,
                                            mesh=trainer.mesh)
    state, m = step(state, {k: np.asarray(v) for k, v in c["batch"].items()})
    return {**_step_result(state, m), "eval": ev}


def _item(inp: dict, key: str) -> dict:
    from unirec_tpu_torch.train import item_qformer as port_train

    c = inp[key]
    trainer = port_train.ItemQFormerTrainer(
        c["cfg"], c["tc"], fused_reference_forwards=c.get("fused_refs", False),
        fused_precision=c.get("fused_precision", "bf16"), device="cpu")
    state = trainer.init_state(params=c["params"])
    assert trainer.use_fused == c.get("fused_refs", False)
    step = port_train.make_train_step(
        state.model, return_grads=True, seed=c["tc"].seed, mesh=trainer.mesh,
        fused_reference_config=c["cfg"] if trainer.use_fused else None,
        fused_precision=trainer.fused_precision)
    out = []
    for batch in c["batches"]:
        state, m = step(state, batch)
        out.append(_step_result(state, m))
    return out


def _user(inp: dict, key: str) -> dict:
    """One user step.  ``probs_dropout_off`` builds the model as
    ``sequence_parallel`` does (hidden-state dropout at the configured
    rate, attention-prob dropout off) on a mesh without an sp axis."""
    import dataclasses

    from unirec_tpu_torch.train import user_qformer as port_train

    c = inp[key]
    cls = type(c["cfg"])
    real_qformer = cls.qformer
    if c.get("probs_dropout_off"):
        cls.qformer = lambda self: dataclasses.replace(
            real_qformer(self), attention_probs_dropout_prob=0.0)
    try:
        trainer = port_train.UserQFormerTrainer(c["cfg"], c["tc"],
                                                max_seq_len=c["seq"],
                                                device="cpu")
        state = trainer.init_state(params=c["params"])
    finally:
        cls.qformer = real_qformer
    step = port_train.make_train_step(state.model, return_grads=True,
                                      seed=c["tc"].seed, mesh=trainer.mesh)
    return _step_result(*step(state, c["batch"]))


def _checkpoint(inp: dict, workdir: str) -> dict:
    """One dp step, a train-state save (counting this rank's file writes),
    then a restore into a template drawn from another seed."""
    import torch

    from unirec_tpu_torch.train import item_qformer as port_train
    from unirec_tpu_torch.utils import checkpoint as ckpt

    c = inp["item"]
    trainer = port_train.ItemQFormerTrainer(c["cfg"], c["tc"], device="cpu",
                                            fused_reference_forwards=False)
    state = trainer.init_state(params=c["params"])
    state, _ = trainer._train_step(state, c["batches"][0])
    writes = []
    real_save = torch.save
    torch.save = lambda obj, f, *a, **k: (writes.append(str(f)),
                                          real_save(obj, f, *a, **k))
    try:
        ckpt.save_train_state(os.path.join(workdir, "ck"), state,
                              config=c["cfg"], extra={"grad_accum": 1})
    finally:
        torch.save = real_save
    torch.distributed.barrier()
    template = trainer.init_state(seed=11)
    with torch.no_grad():  # a rank-dependent template: the restore decides
        for p in template.model.parameters():
            p.add_(torch.distributed.get_rank())
    restored, meta = ckpt.restore_train_state(os.path.join(workdir, "ck"),
                                              template)
    opt = restored.optimizer
    # a params-only directory (the orbax converter's, for a pipeline
    # checkpoint): parameters and step, broadcast as well
    ckpt.save_checkpoint(os.path.join(workdir, "params_only"), state.model,
                         extra={"step": 5})
    torch.distributed.barrier()
    template = trainer.init_state(seed=12)
    with torch.no_grad():
        for p in template.model.parameters():
            p.add_(torch.distributed.get_rank())
    params_only, _ = ckpt.restore_params_and_step(
        os.path.join(workdir, "params_only"), template)
    return {"writes": writes, "step": restored.step, "count": opt.count,
            "params_only_step": params_only.step,
            "params_only": {n: p.detach().clone() for n, p in
                            params_only.model.state_dict().items()},
            "params": {n: p.detach().clone()
                       for n, p in restored.model.state_dict().items()},
            "saved": {n: p.detach().clone()
                      for n, p in state.model.state_dict().items()},
            "mu": {n: t.clone() for n, t in opt.mu.items()}}


def _train(rank: int, world: int, workdir: str) -> dict:
    inp = _inputs(workdir, "train")
    return {"joint": _joint(inp), "item": _item(inp, "item"),
            "item_fused": _item(inp, "item_fused"),
            "user": _user(inp, "user"),
            "user_dropout": _user(inp, "user_dropout"),
            "checkpoint": _checkpoint(inp, workdir)}


def _sp(rank: int, world: int, workdir: str) -> dict:
    inp = _inputs(workdir, "sp")
    return {key: _user(inp, key) for key in inp}


def _user_cli(rank: int, world: int, workdir: str) -> dict:
    """``train user-qformer --sp 2`` as a rank of a torchrun world, at a
    tiny width (the subcommand builds ``UserQFormerConfig()``)."""
    import functools

    from unirec_tpu_torch import configs
    from unirec_tpu_torch.cli import train_cli

    inp = _inputs(workdir, "user_cli")
    configs.UserQFormerConfig = functools.partial(configs.UserQFormerConfig,
                                                  **inp["user_cli_widths"])
    rc = train_cli.main(inp["user_cli_argv"])
    return {"rc": rc}


def _sharded(rank: int, world: int, workdir: str) -> dict:
    """The sp combine over 4 ranks and over the pairs [0, 1] / [2, 3]: the
    output, q's gradient summed over the pair and this rank's k / v slices'
    gradients of sum(out * ct) / S; the refusal of a memory length that
    does not divide."""
    import torch
    import torch.distributed as dist

    from unirec_tpu_torch.ops.sharded_attention import (
        sequence_parallel_cross_attention,
        split_memory,
    )
    from unirec_tpu_torch.parallel.mesh import all_reduce_sum

    inp = _inputs(workdir, "sharded")
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    out = {}
    for name, case in inp.items():
        q, k, v, bias, ct = (torch.tensor(case[x])
                             for x in ("q", "k", "v", "bias", "ct"))
        for shards, group, index in ((4, None, rank),
                                     (2, pairs[rank // 2], rank % 2)):
            q_ = q.clone().requires_grad_()
            k_, v_ = (split_memory(t, shards, index, dim=2).clone()
                      .requires_grad_() for t in (k, v))
            b_ = split_memory(bias, shards, index, dim=3)
            o = sequence_parallel_cross_attention(q_, k_, v_, b_,
                                                  group=group)
            ((o * ct).sum() / shards).backward()
            dq, = all_reduce_sum([q_.grad], group=group)
            out[(name, shards)] = {"out": o.detach(), "dq": dq,
                                   "dk": k_.grad, "dv": v_.grad}
    try:
        split_memory(torch.zeros(1, 2, 15, 8), 2, rank % 2, dim=2)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _init(rank: int, world: int, workdir: str) -> dict:
    """``init_distributed`` from torchrun's environment, the mesh's groups,
    the bucketed all-reduce, the broadcast of a module and rank 0 first."""
    import torch
    import torch.distributed as dist

    from unirec_tpu_torch.configs import MeshConfig
    from unirec_tpu_torch.parallel import mesh as pm

    out = {"world": pm.init_distributed("cpu", timeout_s=GROUP_TIMEOUT_S),
           "backend": dist.get_backend(), "writer": pm.is_writer()}
    for cfg in (MeshConfig(dp=1, sp=2), MeshConfig(dp=-1)):
        m = pm.dist_mesh(cfg)
        out[(cfg.dp, cfg.sp)] = (m.dp_index, m.sp_index, m.dp_size,
                                 m.sp_size, dist.get_world_size(m.dp_group),
                                 dist.get_world_size(m.sp_group))
    try:
        pm.dist_mesh(MeshConfig(dp=4))
    except ValueError as e:
        out["too_big"] = str(e)
    tensors = [torch.full((3,), rank + 1.0),
               torch.arange(5, dtype=torch.float64) * (rank + 1),
               torch.full((2, 2), float(rank))]
    out["reduced"] = pm.all_reduce_sum(tensors, scale=0.5, bucket_bytes=16)
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(rank + 7.0)
    out["broadcast"] = pm.replicate(module).weight.detach().clone()
    path = os.path.join(workdir, "written_first.txt")
    with pm.writer_first():
        if pm.is_writer():
            with open(path, "w") as f:
                f.write("rank 0")
        with open(path) as f:
            out["read"] = f.read()
    return out


def _as_torchrun(rank: int, world: int) -> None:
    """The environment ``torchrun`` gives a rank (its world is already
    joined: ``init_distributed`` returns at once)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))


def _cli_runs(rank: int, world: int, runs) -> list:
    """``train_cli.main(argv)`` for each argv, as torchrun's ranks of the
    joined world; the CLI's end-of-run ``destroy_process_group`` waits for
    the last run."""
    import functools

    import torch.distributed as dist

    from unirec_tpu_torch import configs
    from unirec_tpu_torch.cli import train_cli

    _as_torchrun(rank, world)
    destroy, real_cfg = dist.destroy_process_group, configs.UserQFormerConfig
    dist.destroy_process_group = lambda *a, **k: None
    rcs = []
    try:
        for argv, user_widths in runs:
            if user_widths:
                configs.UserQFormerConfig = functools.partial(real_cfg,
                                                              **user_widths)
            try:
                rcs.append(train_cli.main(argv))
            finally:
                configs.UserQFormerConfig = real_cfg
    finally:
        dist.destroy_process_group = destroy
    return rcs


def _tp(rank: int, world: int, workdir: str) -> dict:
    """The joint trainer at tp = 2: the deterministic joint and Qwen3
    forwards, two steps (each one's gradients gathered to the full tree),
    the evaluation, a checkpoint written from the gathered state and
    restored at tp = 2 into a template of another seed; the item (without
    and with the fused reference forwards) and user trainers at tp = 2;
    ``train joint --tp 2`` and ``train user-qformer --tp 2`` as torchrun's
    ranks."""
    import torch

    from unirec_tpu_torch.parallel.tensor import gather_state_dict
    from unirec_tpu_torch.train import joint as jt
    from unirec_tpu_torch.utils import checkpoint as ckpt

    inp = _inputs(workdir, "tp")
    c = inp["joint"]
    trainer = jt.JointTrainer(c["qwen"], c["qf"], c["jc"], lora=c["lora"],
                              train_config=c["tc"], device="cpu")
    assert trainer.tp.size == 2 and trainer.tp.index == rank
    state = trainer.init_state(params=c["params"])
    b = jt.batch_to_device(c["batches"][0], torch.device("cpu"))
    out = {}
    with trainer.evaluating(state) as model:
        out["user"] = model(b["input_ids"], b["attention_mask"],
                            b["history_field_embeddings"],
                            b["history_attention_mask"])
        out["hidden"] = model.base_model(input_ids=b["input_ids"],
                                         attention_mask=b["attention_mask"])
    out["eval"] = trainer.evaluate(state, c["val"], batch_size=6,
                                   max_negatives=7)
    step = jt.make_joint_train_step(state.model, return_grads=True,
                                    seed=c["tc"].seed, mesh=trainer.mesh)
    out["steps"] = []
    for batch in c["batches"]:
        state, m = step(state, batch)
        out["steps"].append({"loss": float(m["loss"]), "grads":
                             gather_state_dict(m["grads"], trainer.tp)})
    full = trainer.checkpoint_state(state)
    out["params"] = dict(full.model)
    out["opt"] = full.optimizer.state_dict()
    out["local"] = {n: p.detach().clone()
                    for n, p in state.model.state_dict().items()}
    ck = os.path.join(workdir, "tp_ck")
    ckpt.save_train_state(ck, full, extra={"grad_accum": 1})
    torch.distributed.barrier()
    template = trainer.init_state(seed=11)
    restored, _, whole = trainer.restore(ck, template)
    out["restored"] = (whole, restored.step, {
        n: p.detach().clone() for n, p in restored.model.state_dict().items()},
        {n: t.clone() for n, t in restored.optimizer.mu.items()})
    out["local_mu"] = {n: t.clone() for n, t in state.optimizer.mu.items()}
    # one step at LoRA dropout 0.1
    dtrainer = jt.JointTrainer(c["qwen"], c["qf"], c["jc"],
                               lora=inp["joint_dropout"]["lora"],
                               train_config=c["tc"], device="cpu")
    dstate = dtrainer.init_state(params=c["params"])
    _, m = jt.make_joint_train_step(dstate.model, return_grads=True,
                                    seed=c["tc"].seed, mesh=dtrainer.mesh)(
        dstate, c["batches"][0])
    out["dropout"] = {"loss": float(m["loss"]),
                      "grads": gather_state_dict(m["grads"], dtrainer.tp)}
    out["item"] = _item(inp, "item")
    out["item_refs"] = _item(inp, "item_refs")
    out["user_step"] = _user(inp, "user")
    out["cli"] = _cli_runs(rank, world, inp["cli"])
    return out


def _pp(rank: int, world: int, workdir: str) -> dict:
    """The joint model over (dp = world / 2, pp = 2, M = 2): the evaluation
    of the merged tree, the deterministic ``joint_pp_forward`` on this
    rank's rows, one step's gradients (this stage's layers under its local
    names) and the merged parameters after it; in the world of
    2 also a step with LoRA dropout, a pipeline checkpoint and ``train
    joint --pp 2 --pp-microbatches 2`` as torchrun's ranks."""
    import dataclasses

    import torch

    from unirec_tpu_torch.configs import MeshConfig
    from unirec_tpu_torch.parallel.mesh import shard_rows
    from unirec_tpu_torch.parallel.pipeline import joint_pp_forward
    from unirec_tpu_torch.train import joint as jt
    from unirec_tpu_torch.utils.checkpoint import save_pipeline_state

    inp = _inputs(workdir, "pp")
    c = inp["joint"]

    def pipelined(lora):
        trainer = jt.JointTrainer(
            c["qwen"], c["qf"], c["jc"], lora=lora,
            train_config=dataclasses.replace(c["tc"],
                                             mesh=MeshConfig(dp=world)),
            device="cpu")
        pt = jt.PipelinedJointTrainer(trainer, pp=2, num_microbatches=2)
        return pt, pt.init_trainable(trainer.init_state(params=c["params"]))

    pt, ps = pipelined(c["lora"])
    ev = pt.evaluate(ps, c["val"], batch_size=6, max_negatives=7)
    batch = c["batches"][0]
    rows = shard_rows(len(batch["input_ids"]), pt.dp_size, pt.mesh.dp_index)
    b = jt.batch_to_device({k: v[rows] for k, v in batch.items()},
                           torch.device("cpu"))
    ps.model.eval()
    with torch.no_grad():
        user = joint_pp_forward(ps.model, b["input_ids"], b["attention_mask"],
                                b["history_field_embeddings"],
                                b["history_attention_mask"])
    ps.model.train()
    step = jt.make_pipeline_train_step(ps.model, pt.mesh, return_grads=True,
                                       seed=c["tc"].seed)
    ps, m = step(ps, batch)
    out = {"user": user, "rows": (rows.start, rows.stop),
           "stage": pt.mesh.stage,
           "per": ps.model.base_model.layers_per_stage,
           "loss": float(m["loss"]), "grads": m["grads"],
           "merged": pt.merged_params(ps), "eval": ev}
    if world == 2:
        dpt, dps = pipelined(c["lora_dropout"])
        before = pt.merged_params(dps)
        dps, dm = dpt._train_step(dps, batch)
        after = dpt.merged_params(dps)
        out["dropout"] = {"loss": float(dm["loss"]), "changed": sorted(
            n for n in after if not torch.equal(after[n], before[n]))}
        save_pipeline_state(os.path.join(workdir, "pp_ck"),
                            pt.merged_params(ps, to_host=True), ps.step,
                            config=c["jc"], extra={"grad_accum": 1})
        out["cli"] = _cli_runs(rank, world, inp["cli"])
    return out


CASES = {"train": _train, "sp": _sp, "user_cli": _user_cli,
         "sharded": _sharded, "init": _init, "tp": _tp, "pp2": _pp,
         "pp4": _pp}
# cases that join their world themselves (torchrun's environment)
SELF_INIT = {"user_cli", "init"}


def main(argv) -> None:
    case, rank, world, port, workdir = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    from unirec_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    if case in SELF_INIT:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=port)
    else:
        init_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=world, rank=rank,
                         timeout_s=GROUP_TIMEOUT_S)
    result = CASES[case](rank, world, workdir)
    torch.save(result, os.path.join(workdir, f"{case}.{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
