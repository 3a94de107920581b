"""Training CLI (port of ``unirec_tpu/cli/train_cli.py``): the ``joint``
subcommand.

    python -m unirec_tpu_torch.cli.train_cli joint \\
        --train-data train.json --val-data val.json --item-emb item_emb.json \\
        --item-dict items.json --qformer-checkpoint IQ_CKPT --cache-dir CACHE \\
        [--flash-vjp] [--no-remat] [--int8-base] [--lora-grouped] \\
        [--grad-accum K] [--checkpoint-dir DIR [--resume]] [--tiny] \\
        [--device cpu]

The flags and the loop are the JAX CLI's ``joint``: AdamW with warmup 20 and
clipping at 1.0, an evaluation (MRR, Recall/NDCG@{1,5,10}) before training,
every ``--eval-every-steps`` steps and at the end, checkpoints by
``--save-strategy`` (``latest_model/`` and ``best_model/`` with "both"),
``--resume`` from the newest of them, and the pending gradient accumulation
applied at the end.  ``--qformer-checkpoint`` is an Item Q-Former checkpoint
directory of ``utils/checkpoint.py`` or a reference ``.pth``; checkpoints
written here are train-state directories (``utils/checkpoint.py``), which
``serve_cli --checkpoint`` also reads.  It runs on the CUDA card;
``--device cpu`` asks for the CPU.

Not ported yet, refused with the queue that holds them: ``--pp``, ``--dp``
and ``--tp`` above 1 (A9), and ``--hf-path`` (it reads a Hugging Face Qwen3
checkpoint, and the repository holds none).  The other subcommands print
"not ported yet".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# the JAX CLI's other subcommands and the ROADMAP.md queue that holds each
NOT_PORTED = {"precompute": "A8", "mwne": "A8", "item-qformer": "A6",
              "user-qformer": "A7", "evaluate": "A6", "export-pth": "A8",
              "export-pretrained": "A8"}


def _joint_cfg_meta(qwen_cfg, qformer_cfg) -> dict:
    """Config dicts recorded in a joint checkpoint's meta."""
    return {"qwen_config": dataclasses.asdict(qwen_cfg),
            "qformer_config": dataclasses.asdict(qformer_cfg)}


def _metrics_logger(args):
    """JSONL metrics under --checkpoint-dir (+ optional wandb), or None."""
    if not (args.wandb or args.checkpoint_dir):
        return None
    from unirec_tpu_torch.utils.metrics_logger import MetricsLogger

    return MetricsLogger(
        os.path.join(args.checkpoint_dir, "metrics.jsonl")
        if args.checkpoint_dir else None,
        use_wandb=args.wandb,
        wandb_config={k: v for k, v in vars(args).items()
                      if isinstance(v, (int, float, str, bool))},
        stdout=False)


def _joint_parser(sub) -> None:
    sp = sub.add_parser("joint")
    sp.add_argument("--train-data", required=True)
    sp.add_argument("--val-data", required=True)
    sp.add_argument("--item-emb", required=True,
                    help="candidate item-embedding JSON")
    sp.add_argument("--item-dict", required=True)
    sp.add_argument("--qformer-checkpoint", required=True)
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--hf-path", default=None,
                    help="Hugging Face Qwen3 checkpoint (not ported: raises)")
    sp.add_argument("--max-length", type=int, default=512)
    sp.add_argument("--eval-every-steps", type=int, default=20)
    sp.add_argument("--save-strategy", default="both",
                    choices=["best_only", "always", "both"])
    sp.add_argument("--bf16", action="store_true", default=True)
    sp.add_argument("--bf16-base", action="store_true", default=None,
                    help="store the frozen Qwen3 base in bf16 (default: on "
                         "with --no-remat, off with remat)")
    sp.add_argument("--no-bf16-base", dest="bf16_base", action="store_false")
    sp.add_argument("--no-remat", dest="remat", action="store_false",
                    default=True, help="disable rematerialization")
    sp.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (not ported: above 1 raises)")
    sp.add_argument("--pp-microbatches", type=int, default=1)
    sp.add_argument("--flash-vjp", action="store_true",
                    help="trainable flash causal self-attention: kernel K1 "
                         "forward and B7b backward on the card")
    sp.add_argument("--int8-base", action="store_true",
                    help="QLoRA-style training: the frozen Qwen3 "
                         "projections run W8A8 (B8) with an STE backward")
    sp.add_argument("--lora-grouped", action="store_true",
                    help="grouped LoRA overlay (LoRAConfig.grouped)")
    sp.add_argument("--tiny", action="store_true",
                    help="2-layer Qwen3 (hidden of the Q-Former) for smoke "
                         "tests / CPU")
    sp.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--num-epochs", type=int, default=500)
    sp.add_argument("--learning-rate", type=float, default=1e-4)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--resume", action="store_true",
                    help="restore params + optimizer state + step from "
                         "--checkpoint-dir before training")
    sp.add_argument("--wandb", action="store_true",
                    help="also stream metrics to wandb (JSONL under "
                         "--checkpoint-dir is always written)")
    sp.add_argument("--dp", type=int, default=-1,
                    help="data-parallel size (not ported: above 1 raises)")
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size (not ported: above 1 raises)")
    sp.add_argument("--grad-accum", type=int, default=1,
                    help="apply the optimizer every k micro-batches on the "
                         "averaged gradient")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    _joint_parser(sub)
    for name in NOT_PORTED:
        sub.add_parser(name, add_help=False)
    args, rest = p.parse_known_args(argv)
    if args.cmd != "joint":
        print(f"train {args.cmd}: not ported yet (ROADMAP.md queue A, "
              f"{NOT_PORTED[args.cmd]})", file=sys.stderr)
        return 2
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return _run_joint(args)


def _run_joint(args) -> int:
    import numpy as np

    from unirec_tpu_torch.configs import (
        JointModelConfig,
        LoRAConfig,
        MeshConfig,
        OptimizerConfig,
        Qwen3Config,
        TrainConfig,
        tiny_qwen3_config,
    )
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.data.tokenizer import make_tokenizer
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.train.callbacks import BestMetricTracker
    from unirec_tpu_torch.train.common import flush_grad_accum
    from unirec_tpu_torch.train.joint import JointDataset, JointTrainer
    from unirec_tpu_torch.utils.checkpoint import (
        check_grad_accum,
        has_train_state,
        read_meta,
        restore_train_state,
        save_train_state,
    )
    from unirec_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # the card unless --device cpu
    if args.pp > 1:
        raise NotImplementedError("--pp (pipeline parallelism) is not ported "
                                  "yet (ROADMAP.md A9)")
    if args.dp > 1 or args.tp > 1:
        raise NotImplementedError("--dp / --tp above 1 are not ported yet "
                                  "(ROADMAP.md A9)")
    if args.hf_path:
        raise NotImplementedError(
            "--hf-path is not ported yet: it reads a Hugging Face Qwen3 "
            "checkpoint, and the repository holds none to test it on")

    with open(args.train_data) as f:
        train_data = json.load(f)
    with open(args.val_data) as f:
        val_data = json.load(f)
    with open(args.item_emb) as f:
        item_emb_dict = json.load(f)
    with open(args.item_dict) as f:
        item_dict = json.load(f)

    qf_cfg, qf_state, _ = QFormerInference.read_checkpoint(
        args.qformer_checkpoint)
    cache = FieldEmbeddingCache.load(args.cache_dir)
    if args.tiny:
        qwen_cfg = tiny_qwen3_config(
            vocab_size=4096, hidden_size=qf_cfg.hidden_size,
            intermediate_size=1024, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, head_dim=128,
            max_position_embeddings=max(128, args.max_length))
    else:
        qwen_cfg = Qwen3Config()
    if args.flash_vjp:
        qwen_cfg = dataclasses.replace(qwen_cfg, flash_vjp_attention=True)
    jc = JointModelConfig(max_length=args.max_length)
    tokenizer = make_tokenizer(None, qwen_cfg.vocab_size, jc.num_history_items,
                               jc.num_query_tokens_per_item)
    emb_dim = len(next(iter(item_emb_dict.values())))
    if emb_dim != qwen_cfg.hidden_size:
        # InfoNCE compares the pooled user embedding with the candidates:
        # they must share the LLM's hidden space
        print(f"error: candidate embedding dim {emb_dim} != LLM hidden size "
              f"{qwen_cfg.hidden_size}; regenerate --item-emb with the same "
              "base model", file=sys.stderr)
        return 2
    train_ds = JointDataset(train_data, item_emb_dict, tokenizer, item_dict,
                            cache, jc, item_emb_dim=emb_dim)
    val_ds = JointDataset(val_data, item_emb_dict, tokenizer, item_dict,
                          cache, jc, item_emb_dim=emb_dim)

    tc = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.num_epochs,
        seed=args.seed,
        optimizer=OptimizerConfig(
            learning_rate=args.learning_rate, warmup_steps=20,
            max_grad_norm=1.0, gradient_accumulation_steps=args.grad_accum),
        mesh=MeshConfig(dp=args.dp, tp=args.tp))
    bf16_base = args.bf16_base
    if bf16_base is None:
        bf16_base = not args.remat  # the JAX CLI's default
    trainer = JointTrainer(
        qwen_cfg, qf_cfg, jc, lora=LoRAConfig(grouped=args.lora_grouped),
        train_config=tc, dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat, remat_policy="dots",
        bf16_base=bf16_base and args.bf16, int8_base=args.int8_base,
        device=device)
    state = trainer.init_state(qformer_params=qf_state)

    best_mrr = float("-inf")
    if args.resume and args.checkpoint_dir:
        # "both" nests latest_model/ and best_model/: prefer latest (the
        # true continuation), then best, then the flat layout
        for cand in (os.path.join(args.checkpoint_dir, "latest_model"),
                     os.path.join(args.checkpoint_dir, "best_model"),
                     args.checkpoint_dir):
            if has_train_state(cand):
                check_grad_accum(read_meta(cand), args.grad_accum)
                state, meta = restore_train_state(cand, state)
                best_mrr = float(meta.get("mrr", float("-inf")))
                print(f"resumed from {cand} at step {state.step} "
                      f"(best MRR {best_mrr:.4f})")
                break
        else:
            print(f"error: --resume but no checkpoint under "
                  f"{args.checkpoint_dir}", file=sys.stderr)
            return 2

    tracker = BestMetricTracker(
        args.checkpoint_dir, metric="mrr", strategy=args.save_strategy,
        eval_steps=args.eval_every_steps,
        save_fn=lambda path, st: save_train_state(
            path, st, config=jc,
            extra={"mrr": tracker.best, "grad_accum": args.grad_accum,
                   **_joint_cfg_meta(qwen_cfg, qf_cfg)}))
    if best_mrr > tracker.best:
        tracker.best = best_mrr  # the resumed watermark: don't demote "best"
    ml = _metrics_logger(args)
    print("initial eval:", json.dumps(trainer.evaluate(state, val_ds)))

    def hook(step, st, metrics):
        if tracker.should_eval(step):
            ev = trainer.evaluate(st, val_ds)
            status = tracker.update(step, ev["mrr"], st)
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"eval={json.dumps(ev)} {status}")
            if ml:
                ml.log({"loss": metrics["loss"], **ev}, step=step)
        return st

    rng = np.random.default_rng(args.seed)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    state, _ = trainer.train_steps(
        state, train_ds, rng, num_steps=args.num_epochs * steps_per_epoch,
        step_hook=hook)
    # apply any pending micro-grad accumulation (HF Trainer semantics)
    state = flush_grad_accum(state)
    final = trainer.evaluate(state, val_ds)
    print(f"final eval: {json.dumps(final)}; best MRR: {tracker.best:.4f}")
    if ml:
        ml.log(final, step=state.step)
        ml.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
