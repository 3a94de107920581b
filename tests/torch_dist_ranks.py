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

import os
import signal
import subprocess
import sys
import time
from typing import Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120.0  # the collectives' timeout inside a rank


# -- the test side ---------------------------------------------------------------


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


CASES = {"train": _train, "sp": _sp, "user_cli": _user_cli,
         "sharded": _sharded, "init": _init}
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
