"""Training CLI (port of ``unirec_tpu/cli/train_cli.py``): the ``joint``,
``item-qformer``, ``user-qformer``, ``evaluate``, ``precompute``, ``mwne``,
``export-pth`` and ``export-pretrained`` subcommands.

    python -m unirec_tpu_torch.cli.train_cli joint \\
        --train-data train.json --val-data val.json --item-emb item_emb.json \\
        --item-dict items.json --qformer-checkpoint IQ_CKPT --cache-dir CACHE \\
        [--flash-vjp] [--no-remat] [--int8-base] [--lora-grouped] \\
        [--grad-accum K] [--checkpoint-dir DIR [--resume]] [--tiny] \\
        [--dp N] [--tp N | --pp N [--pp-microbatches M]] [--device cpu]
    python -m unirec_tpu_torch.cli.train_cli item-qformer \\
        --data items.json --sequences train.json --cache-dir CACHE \\
        [--bf16 [--fused-anchor] [--int8-ref]] [--grad-accum K] \\
        [--checkpoint-dir DIR [--resume]] [--max-samples N] [--eval-every E] \\
        [--device cpu]
    python -m unirec_tpu_torch.cli.train_cli user-qformer \\
        --item-qformer-checkpoint IQ_CKPT --history train.json \\
        --reviews reviews.json --cache-dir CACHE [--max-seq-len 50] \\
        [--bf16] [--flash] [--fused] [--remat] [--grad-accum K] \\
        [--checkpoint-dir DIR [--resume]] [--device cpu]
    python -m unirec_tpu_torch.cli.train_cli evaluate --checkpoint DIR \\
        --cache-dir CACHE [--device cpu]
    python -m unirec_tpu_torch.cli.train_cli precompute --data items.json \\
        --cache-dir CACHE [--max-items N] [--device cpu]
    python -m unirec_tpu_torch.cli.train_cli mwne [--embedding-dim 1024] \\
        [--num-frequencies 20] [--num-steps 1500] [--learning-rate 1e-3] \\
        [--checkpoint-dir number_encoders] [--device cpu]
    python -m unirec_tpu_torch.cli.train_cli export-pth --checkpoint DIR \\
        --output OUT.pth [--stage item|user|mwne]
    python -m unirec_tpu_torch.cli.train_cli export-pretrained \\
        --checkpoint JOINT_DIR --output DIR [--tokenizer HF_PATH]

The flags and the loops are the JAX CLI's.  ``joint``: AdamW with warmup 20
and clipping at 1.0, an evaluation (MRR, Recall/NDCG@{1,5,10}) before
training, every ``--eval-every-steps`` steps and at the end, checkpoints by
``--save-strategy`` (``latest_model/`` and ``best_model/`` with "both"),
``--resume`` from the newest of them, and the pending gradient accumulation
applied at the end.  ``--qformer-checkpoint`` is an Item Q-Former checkpoint
directory of ``utils/checkpoint.py`` or a reference ``.pth``.
``item-qformer``: the field cache is built from ``--data`` with the hash and
MWNE backends unless ``--cache-dir`` already holds one for its fields; a
90/10 split by ``--seed``; the best-validation checkpoint goes to
``--checkpoint-dir`` (a train-state directory that ``QFormerInference``,
``generate_all_item_embeddings`` and ``joint --qformer-checkpoint`` read).
``--fused-anchor`` (needs ``--bf16``) runs the anchor's attention blocks
through B12s / B12c and zeroes attention-probability dropout; with
``--bf16`` on the card the positive and negative forwards run on the fused
engine, B1-B3, or B4-B6 with ``--int8-ref``.  Checkpoints written here are
train-state directories (``utils/checkpoint.py``).  ``user-qformer``: the
User Q-Former (``UserQFormerConfig()`` over the Item Q-Former checkpoint's K
and hidden) on sliding-window samples of ``--history`` with the first
review time of each item from ``--reviews`` (keyed "user|item"), a 90/10
split by ``--seed``, best-by-train-loss checkpoints and the held-out
evaluation; ``--flash`` runs every cross-attention layer through B14 and
``--fused`` every self-attention layer through B12s (both set dropout 0),
``--remat`` recomputes the layers and the sequence assembly in the
backward.  Every subcommand runs on the CUDA card; ``--device cpu`` asks
for the CPU.  ``joint --hf-path DIR`` reads the frozen Qwen3 base and the
tokenizer from a local Hugging Face checkpoint (``utils/torch_convert.
convert_qwen3``, ``data/tokenizer.HFTokenizer``; needs ``transformers``),
whose shapes must be the model's (``Qwen3Config()``, or the ``--tiny`` one).

``mwne``: MWNE property training (``train/mwne.MWNETrainer``), the
evaluation printed as JSON, a train-state directory under
``--checkpoint-dir``.  ``export-pth`` writes the reference's ``.pth`` of an
item (a checkpoint directory or a reference ``.pth``), user or MWNE
checkpoint directory, ``export-pretrained`` the reference's
``save_pretrained`` directory of a joint checkpoint (``latest_model/``,
``best_model/`` or the directory itself; its meta records both configs),
through ``utils/weights.state_dict_to_flax`` and ``utils/torch_convert``.

``--dp N`` (``joint``, ``item-qformer``, ``user-qformer``) trains
data-parallel over N ranks, ``--tp N`` shards the joint model's Qwen3 base
over N ranks (``parallel/tensor.py``; the item and user trainers replicate
over it, as the JAX ones do), ``user-qformer --sp M`` splits the memory
over M ranks (``parallel/mesh.py``) and ``joint --pp N
[--pp-microbatches M]`` splits the decoder's layers into N GPipe stages
(``parallel/pipeline.py``, ``train/joint.PipelinedJointTrainer``): under
``torchrun`` (which sets ``WORLD_SIZE``) the command is one rank of that
world and dp x tp x sp x pp must equal it; otherwise the command spawns
that many local ranks, one per visible card (gloo ranks on the CPU with
``--device cpu``), joined over ``tcp://127.0.0.1`` with a timeout on every
collective (``parallel.mesh.DEFAULT_TIMEOUT_S``).  More ranks than cards
is refused before anything spawns, as are the JAX package's refusals:
``--tp`` above 1 with ``--flash-vjp`` or ``--int8-base`` (joint), with
``--fused-anchor`` (item) or ``--flash`` / ``--fused`` (user); ``--pp``
with ``--flash-vjp``, ``--int8-base`` or ``--tp`` above 1.  ``--dp -1``
(the default) takes every card left after tp, sp and pp, so one card
trains as before.  A rank that fails ends the run with an error.  Rank 0
alone prints and writes checkpoints and metrics; a checkpoint written
under tp holds the full tree (it resumes at any tp), and one written under
pp holds the merged parameters and step with ``{"pp_layout": True}`` for
the optimizer state, so ``--resume`` from it (with or without ``--pp``)
restores parameters and step and restarts the optimizer, as the JAX CLI's
does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# the JAX CLI's subcommands still to port and the ROADMAP.md queue of each
NOT_PORTED: dict = {}


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


def _common_train_flags(sp, batch_size: int, epochs: int, lr: float) -> None:
    sp.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    sp.add_argument("--batch-size", type=int, default=batch_size)
    sp.add_argument("--num-epochs", type=int, default=epochs)
    sp.add_argument("--learning-rate", type=float, default=lr)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--resume", action="store_true",
                    help="restore params + optimizer state + step from "
                         "--checkpoint-dir before training")
    sp.add_argument("--wandb", action="store_true",
                    help="also stream metrics to wandb (JSONL under "
                         "--checkpoint-dir is always written)")
    sp.add_argument("--dp", type=int, default=-1,
                    help="data-parallel ranks (-1: every visible card; "
                         "with --device cpu, 1)")
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size: joint shards the Qwen3 base "
                         "over N ranks; item-qformer / user-qformer "
                         "replicate over them")
    sp.add_argument("--grad-accum", type=int, default=1,
                    help="apply the optimizer every k micro-batches on the "
                         "averaged gradient")


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
                    help="local Hugging Face Qwen3 checkpoint: the base "
                         "weights and the tokenizer")
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
                    help="pipeline-parallel stages (GPipe, "
                         "parallel/pipeline.py); composes with --dp, refuses "
                         "--tp>1, --flash-vjp and --int8-base; --resume "
                         "restores params only")
    sp.add_argument("--pp-microbatches", type=int, default=1,
                    help="microbatches per dp-local batch (shrinks the "
                         "pipeline bubble; batch/(dp*M) must stay integral)")
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
    _common_train_flags(sp, 16, 500, 1e-4)


def _item_parsers(sub) -> None:
    sp = sub.add_parser("precompute")
    sp.add_argument("--data", required=True, help="item (triplet) dict JSON")
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--batch-size", type=int, default=8192)
    sp.add_argument("--max-items", type=int, default=None)
    sp.add_argument("--config", default=None, help="field schema YAML")
    sp.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu: "
                         "where the number encoder runs")

    sp = sub.add_parser("item-qformer")
    sp.add_argument("--data", required=True, help="item (triplet) dict JSON")
    sp.add_argument("--sequences", required=True, help="LRanker train JSON")
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--num-query-tokens", type=int, default=32)
    sp.add_argument("--hidden-size", type=int, default=1024)
    sp.add_argument("--num-layers", type=int, default=12)
    sp.add_argument("--num-heads", type=int, default=16)
    sp.add_argument("--intermediate-size", type=int, default=4096)
    sp.add_argument("--contrastive-weight", type=float, default=0.25)
    sp.add_argument("--max-samples", type=int, default=None)
    sp.add_argument("--eval-every", type=int, default=50)
    sp.add_argument("--bf16", action="store_true",
                    help="bf16 activations (fp32 params); default fp32 for "
                         "strict reference parity")
    sp.add_argument("--int8-ref", action="store_true",
                    help="run the no-gradient pos/neg reference forwards on "
                         "the W8A8 blocks (B4-B6)")
    sp.add_argument("--fused-anchor", action="store_true",
                    help="run the trainable anchor forward+backward through "
                         "the fused attention blocks B12s/B12c (requires "
                         "--bf16); zeroes attention-PROB dropout (hidden "
                         "dropout unchanged)")
    _common_train_flags(sp, 4096, 500, 1e-4)

    sp = sub.add_parser("user-qformer")
    sp.add_argument("--item-qformer-checkpoint", required=True)
    sp.add_argument("--history", required=True, help="LRanker train JSON")
    sp.add_argument("--reviews", required=True, help="review dict JSON")
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--max-seq-len", type=int, default=50)
    sp.add_argument("--bf16", action="store_true",
                    help="bf16 activations (fp32 params)")
    sp.add_argument("--remat", action="store_true",
                    help="recompute the layers and the sequence assembly in "
                         "the backward (long histories)")
    sp.add_argument("--flash", action="store_true",
                    help="trainable flash cross-attention (B14 forward and "
                         "backward on the card); sets dropout 0")
    sp.add_argument("--fused", action="store_true",
                    help="trainable fused self-attention blocks (B12s); "
                         "sets dropout 0 like --flash")
    sp.add_argument("--sp", type=int, default=1,
                    help="sequence parallelism: split the memory axis over "
                         "N ranks (exact combine, ops/sharded_attention.py); "
                         "seq * K must divide by N; incompatible with "
                         "--flash / --fused; zeroes attention-prob dropout "
                         "(hidden-state dropout stays on)")
    _common_train_flags(sp, 64, 50, 5e-5)

    sp = sub.add_parser("evaluate")
    sp.add_argument("--checkpoint", required=True)
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--batch-size", type=int, default=256)
    sp.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")


def _export_parsers(sub) -> None:
    sp = sub.add_parser("mwne")
    sp.add_argument("--embedding-dim", type=int, default=1024)
    sp.add_argument("--num-frequencies", type=int, default=20)
    sp.add_argument("--num-steps", type=int, default=1500)
    sp.add_argument("--learning-rate", type=float, default=1e-3)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--checkpoint-dir", default="number_encoders")
    sp.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")

    sp = sub.add_parser(
        "export-pth",
        help="write a checkpoint in the reference's .pth schema")
    sp.add_argument("--checkpoint", required=True,
                    help="checkpoint directory (or, for --stage item, a "
                         "reference .pth)")
    sp.add_argument("--output", required=True, help="output .pth path")
    sp.add_argument("--stage", choices=["item", "user", "mwne"],
                    default="item")

    sp = sub.add_parser(
        "export-pretrained",
        help="write a joint checkpoint as the reference's save_pretrained "
             "directory (PEFT adapter, qformer_model.bin, model_config.json "
             "and the tokenizer's files)")
    sp.add_argument("--checkpoint", required=True,
                    help="joint checkpoint directory (train joint "
                         "--checkpoint-dir)")
    sp.add_argument("--output", required=True, help="output directory")
    sp.add_argument("--tokenizer", default=None,
                    help="a local Hugging Face tokenizer to copy into the "
                         "directory (needs transformers)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    _joint_parser(sub)
    _item_parsers(sub)
    _export_parsers(sub)
    for name in NOT_PORTED:
        sub.add_parser(name, add_help=False)
    args, rest = p.parse_known_args(argv)
    if args.cmd in NOT_PORTED:
        print(f"train {args.cmd}: not ported yet (ROADMAP.md queue A, "
              f"{NOT_PORTED[args.cmd]})", file=sys.stderr)
        return 2
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.cmd in _TRAINERS:
        return _run_parallel(args)
    return {"evaluate": _run_evaluate,
            "precompute": _run_precompute, "mwne": _run_mwne,
            "export-pth": _run_export_pth,
            "export-pretrained": _run_export_pretrained}[args.cmd](args)


def _run_trainer(args) -> int:
    return _TRAINERS[args.cmd](args)


def _refusals(args) -> int:
    """The JAX package's refusals of parallel layouts, before anything
    spawns: the trainers' own checks raise, and ``--pp`` with
    ``--flash-vjp`` or ``--int8-base`` returns the JAX CLI's exit code 2
    (0 when none applies)."""
    tp = args.tp
    if args.cmd == "joint":
        from unirec_tpu_torch.train.joint import check_joint_layout

        if args.pp > 1:
            for flag, why in (("flash_vjp", "--flash-vjp (the pp schedule "
                               "drives layers with additive biases)"),
                              ("int8_base", "--int8-base (the pp layout "
                               "stacks layer params; the qweights tree is "
                               "not stacked)")):
                if getattr(args, flag):
                    print(f"error: --pp is incompatible with {why}",
                          file=sys.stderr)
                    return 2
        check_joint_layout(tp, args.flash_vjp, args.int8_base,
                           pipeline=args.pp > 1)
    elif args.cmd == "item-qformer":
        from unirec_tpu_torch.train.item_qformer import check_item_layout

        check_item_layout(tp, args.fused_anchor)
    elif args.cmd == "user-qformer":
        from unirec_tpu_torch.train.user_qformer import check_user_layout

        check_user_layout(tp, args.sp, args.flash, args.fused)
    return 0


def _run_parallel(args) -> int:
    """Run a trainer subcommand on its dp x tp x sp x pp ranks: in this
    process (one rank, or a rank of ``torchrun``'s world), or on spawned
    local ranks."""
    import torch

    rc = _refusals(args)
    if rc:
        return rc
    tp, sp, pp = (max(args.tp, 1), getattr(args, "sp", 1),
                  max(getattr(args, "pp", 1), 1))
    inner = tp * sp * pp
    sizes = f"--tp {tp} x --sp {sp} x --pp {pp}"
    if "WORLD_SIZE" in os.environ:  # a rank of torchrun's world
        from unirec_tpu_torch.parallel.mesh import init_distributed

        world = int(os.environ["WORLD_SIZE"])
        dp = world // inner if args.dp < 0 else args.dp
        if dp * inner != world:
            raise ValueError(f"--dp {dp} x {sizes} != the world's {world} "
                             "ranks")
        args.dp = dp
        init_distributed(args.device)
        return _rank_main(int(os.environ["RANK"]), args, None, 0)
    cuda = torch.device(args.device).type == "cuda"
    cards = torch.cuda.device_count() if cuda else 1
    dp = args.dp if args.dp > 0 else max(cards // inner, 1) if cuda else 1
    world = dp * inner
    if cuda and world > max(cards, 1):
        raise ValueError(f"--dp {dp} x {sizes} needs {world} cards, "
                         f"have {cards}")
    args.dp = dp
    if world == 1:  # no card at all: the trainer's device check says so
        return _run_trainer(args)
    import torch.multiprocessing as mp

    from unirec_tpu_torch.parallel.mesh import free_port

    # joins every rank, and raises (ending the others) if one fails
    mp.start_processes(_rank_main, args=(args, world, free_port()),
                       nprocs=world, start_method="spawn")
    return 0


def _rank_main(rank: int, args, world, port: int) -> int:
    """One rank: join the world (unless torchrun's is joined), run the
    trainer, leave; a non-zero return exits the rank with it.  Ranks other
    than 0 print nothing."""
    import torch.distributed as dist

    from unirec_tpu_torch.parallel.mesh import init_distributed

    if rank:
        sys.stdout = open(os.devnull, "w")
    if world is not None:
        if args.device.startswith("cuda"):
            args.device = f"cuda:{rank}"
        init_distributed(args.device, init_method=f"tcp://127.0.0.1:{port}",
                         world_size=world, rank=rank)
    try:
        rc = _run_trainer(args)
    finally:
        dist.destroy_process_group()
    if rc:
        raise SystemExit(rc)
    return rc


def _read_items(path: str):
    """An item dict JSON -> a list of item dicts carrying their ``item_id``."""
    with open(path) as f:
        data = json.load(f)
    return [dict(item, item_id=iid) for iid, item in data.items()]


def _run_precompute(args) -> int:
    from unirec_tpu_torch.data.cache import build_cache
    from unirec_tpu_torch.encoders.item_encoder import ItemEncoder
    from unirec_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    items = _read_items(args.data)
    if args.max_items:
        items = items[: args.max_items]
    encoder = ItemEncoder(config_path=args.config, device=device)
    cache = build_cache(items, encoder, cache_dir=args.cache_dir,
                        batch_size=args.batch_size)
    print(f"cached {len(cache)} items x {cache.num_fields} fields "
          f"-> {args.cache_dir}")
    return 0


def _run_item_qformer(args) -> int:
    import numpy as np

    from unirec_tpu_torch.configs import (
        ItemQFormerConfig,
        MeshConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from unirec_tpu_torch.data.cache import build_cache
    from unirec_tpu_torch.encoders.item_encoder import ItemEncoder
    from unirec_tpu_torch.ops.fused_qformer_vjp import supports_fused_train
    from unirec_tpu_torch.parallel.mesh import writer_first
    from unirec_tpu_torch.train.item_qformer import train_item_qformer
    from unirec_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.fused_anchor and not args.bf16:
        # the JAX CLI's refusal: the fused kernels are bf16-only
        raise SystemExit("--fused-anchor requires --bf16")
    items = _read_items(args.data)
    if args.max_samples:
        items = items[: args.max_samples]
    with open(args.sequences) as f:
        seq_data = json.load(f)
    sequences = [s["history"] for s in seq_data
                 if "history" in s and len(s["history"]) > 1]
    with writer_first():  # rank 0 writes the cache the others then read
        cache = build_cache(items, ItemEncoder(device=device),
                            cache_dir=args.cache_dir)
    # 90/10 split by --seed (reference: item_qformer_training.py:64-68)
    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(len(cache))
    val_rows = perm[int(0.9 * len(cache)):]
    mc = ItemQFormerConfig(
        num_fields=cache.num_fields, field_embedding_dim=cache.embedding_dim,
        num_query_tokens=args.num_query_tokens, hidden_size=args.hidden_size,
        num_hidden_layers=args.num_layers, num_attention_heads=args.num_heads,
        intermediate_size=args.intermediate_size,
        fused_training=args.fused_anchor)
    if args.fused_anchor and not (
            supports_fused_train(mc.num_query_tokens, mc.hidden_size,
                                 mc.num_attention_heads, mc.num_fields)
            and supports_fused_train(mc.num_query_tokens, mc.hidden_size,
                                     mc.num_attention_heads,
                                     mc.num_query_tokens)):
        raise SystemExit("--fused-anchor: the fused blocks do not take this "
                         "shape (ops/fused_qformer_vjp.supports_fused_train)")
    tc = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.num_epochs, seed=args.seed,
        eval_every_epochs=args.eval_every,
        optimizer=OptimizerConfig(learning_rate=args.learning_rate,
                                  gradient_accumulation_steps=args.grad_accum),
        mesh=MeshConfig(dp=args.dp, tp=args.tp))
    _, metrics = train_item_qformer(
        cache, sequences, mc, tc, val_rows=val_rows,
        checkpoint_dir=args.checkpoint_dir,
        contrastive_weight=args.contrastive_weight,
        dtype="bfloat16" if args.bf16 else "float32",
        fused_precision="int8" if args.int8_ref else "bf16",
        resume=args.resume, metrics_logger=_metrics_logger(args),
        device=device)
    print(json.dumps(metrics, indent=2))
    return 0


def _run_user_qformer(args) -> int:
    from unirec_tpu_torch import configs
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.models.item_qformer import ItemQFormer
    from unirec_tpu_torch.train.user_qformer import train_user_qformer
    from unirec_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    iq_cfg, iq_sd, _ = QFormerInference.read_checkpoint(
        args.item_qformer_checkpoint)
    item_qformer = ItemQFormer(iq_cfg, device=device)
    item_qformer.load_state_dict(iq_sd)
    cache = FieldEmbeddingCache.load(args.cache_dir)
    with open(args.history) as f:
        histories = json.load(f)
    with open(args.reviews) as f:
        reviews_raw = json.load(f)
    # the review dict is keyed "user|asin": regroup per item
    reviews: dict = {}
    for key, review in reviews_raw.items():
        reviews.setdefault(key.split("|", 1)[-1], []).append(review)
    tc = configs.TrainConfig(
        batch_size=args.batch_size, num_epochs=args.num_epochs, seed=args.seed,
        optimizer=configs.OptimizerConfig(
            learning_rate=args.learning_rate,
            gradient_accumulation_steps=args.grad_accum),
        mesh=configs.MeshConfig(dp=args.dp, tp=args.tp, sp=args.sp))
    uc = configs.UserQFormerConfig(
        num_item_tokens_to_predict=iq_cfg.num_query_tokens,
        input_embedding_dim=iq_cfg.hidden_size,
        gradient_checkpointing=args.remat, flash_training=args.flash,
        fused_training=args.fused, sequence_parallel=args.sp > 1,
        dropout=0.0 if (args.flash or args.fused) else 0.1)
    _, metrics = train_user_qformer(
        cache, histories, reviews, item_qformer, user_config=uc,
        train_config=tc, max_seq_len=args.max_seq_len,
        checkpoint_dir=args.checkpoint_dir,
        dtype="bfloat16" if args.bf16 else "float32", resume=args.resume,
        metrics_logger=_metrics_logger(args), device=device)
    print(json.dumps(metrics, indent=2))
    return 0


def _run_evaluate(args) -> int:
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.eval.reconstruction import (
        evaluate_reconstruction_quality,
    )
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.models.item_qformer import ItemQFormer
    from unirec_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg, sd, _ = QFormerInference.read_checkpoint(args.checkpoint)
    cache = FieldEmbeddingCache.load(args.cache_dir)
    model = ItemQFormer(cfg, device=device)
    model.load_state_dict(sd)
    res = evaluate_reconstruction_quality(model, cache,
                                          batch_size=args.batch_size)
    print(json.dumps(res, indent=2))
    return 0


def _run_mwne(args) -> int:
    import numpy as np

    from unirec_tpu_torch.configs import MWNEConfig
    from unirec_tpu_torch.train.common import TrainState
    from unirec_tpu_torch.train.mwne import MWNETrainer
    from unirec_tpu_torch.utils.checkpoint import save_train_state
    from unirec_tpu_torch.utils.device import resolve_device

    cfg = MWNEConfig(embedding_dim=args.embedding_dim,
                     num_frequencies=args.num_frequencies)
    trainer = MWNETrainer(cfg, lr=args.learning_rate, seed=args.seed,
                          device=resolve_device(args.device))
    metrics = trainer.train(num_steps=args.num_steps)
    test = np.array([0.5, 1.0, 2.0, 5.0, 10.0, -3.0, 42.0, 100.0], np.float32)
    results = trainer.evaluate(test)
    print(json.dumps({"train": metrics, "eval": results}, indent=2))
    if args.checkpoint_dir:
        save_train_state(args.checkpoint_dir,
                         TrainState(trainer.model, trainer.optimizer,
                                    args.num_steps),
                         config=cfg, extra={"final_metrics": results})
    return 0


def _run_export_pth(args) -> int:
    from unirec_tpu_torch.utils import torch_convert as tc
    from unirec_tpu_torch.utils.checkpoint import load_checkpoint, restore_config
    from unirec_tpu_torch.utils.weights import state_dict_to_flax

    if args.stage == "item":
        from unirec_tpu_torch.inference.qformer_inference import QFormerInference

        cfg, sd, field_names = QFormerInference.read_checkpoint(args.checkpoint)
        tc.save_reference_item_qformer_checkpoint(
            args.output, state_dict_to_flax(sd), cfg, field_names)
        print(f"wrote reference-schema checkpoint -> {args.output} "
              f"({len(field_names)} fields)")
        return 0
    sd, meta = load_checkpoint(args.checkpoint)
    tree = state_dict_to_flax(sd)
    if args.stage == "user":
        from unirec_tpu_torch.configs import UserQFormerConfig

        tc.save_reference_user_qformer_checkpoint(
            args.output, tree["user"], restore_config(meta, UserQFormerConfig),
            epoch=int(meta.get("epoch", 0)), loss=float(meta.get("loss", 0.0)))
        print(f"wrote reference-schema user checkpoint -> {args.output}")
        return 0
    from unirec_tpu_torch.configs import MWNEConfig

    tc.save_reference_mwne_checkpoint(
        args.output, restore_config(meta, MWNEConfig),
        {"base": tree["encoder"]}, final_metrics=meta.get("final_metrics"))
    print(f"wrote reference-schema MWNE checkpoint -> {args.output}")
    return 0


def _run_export_pretrained(args) -> int:
    from unirec_tpu_torch.configs import ItemQFormerConfig, Qwen3Config
    from unirec_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        read_meta,
        restore_config,
    )
    from unirec_tpu_torch.utils.torch_convert import save_pretrained_directory
    from unirec_tpu_torch.utils.weights import state_dict_to_flax

    cand = next((c for c in (os.path.join(args.checkpoint, "latest_model"),
                             os.path.join(args.checkpoint, "best_model"),
                             args.checkpoint)
                 if os.path.exists(os.path.join(c, "params.pt"))), None)
    if cand is None:
        print(f"error: no checkpoint under {args.checkpoint}", file=sys.stderr)
        return 2
    meta = read_meta(cand)

    def config(key, cls):  # the configs the joint save records
        if key not in meta:
            raise SystemExit(f"checkpoint meta lacks {key!r}: re-save it with "
                             f"`train joint`")
        return restore_config({"config": meta[key]}, cls)

    tokenizer = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer,
                                                  local_files_only=True)
    sd, _ = load_checkpoint(cand)
    save_pretrained_directory(
        args.output, state_dict_to_flax(sd),
        config("qwen_config", Qwen3Config),
        config("qformer_config", ItemQFormerConfig), tokenizer=tokenizer)
    print(f"wrote reference save_pretrained layout -> {args.output}")
    return 0


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
        has_params,
        read_meta,
        save_train_state,
    )
    from unirec_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # the card unless --device cpu

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
    tokenizer = make_tokenizer(args.hf_path, qwen_cfg.vocab_size,
                               jc.num_history_items,
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
        # under --pp the trainer spans the world as dp (its evaluator)
        mesh=MeshConfig(dp=args.dp * args.pp, tp=args.tp) if args.pp > 1
        else MeshConfig(dp=args.dp, tp=args.tp))
    bf16_base = args.bf16_base
    if bf16_base is None:
        bf16_base = not args.remat  # the JAX CLI's default
    trainer = JointTrainer(
        qwen_cfg, qf_cfg, jc, lora=LoRAConfig(grouped=args.lora_grouped),
        train_config=tc, dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat, remat_policy="dots",
        bf16_base=bf16_base and args.bf16, int8_base=args.int8_base,
        device=device)
    qwen_params = None
    if args.hf_path:
        from unirec_tpu_torch.utils.weights import qwen3_state_dict_from_hf

        qwen_params = qwen3_state_dict_from_hf(args.hf_path, qwen_cfg)
    state = trainer.init_state(qformer_params=qf_state,
                               qwen_params=qwen_params)

    best_mrr = float("-inf")
    if args.resume and args.checkpoint_dir:
        # "both" nests latest_model/ and best_model/: prefer latest (the
        # true continuation), then best, then the flat layout
        for cand in (os.path.join(args.checkpoint_dir, "latest_model"),
                     os.path.join(args.checkpoint_dir, "best_model"),
                     args.checkpoint_dir):
            if has_params(cand):
                check_grad_accum(read_meta(cand), args.grad_accum)
                # any tp; a pipeline's checkpoint (written here under --pp,
                # or converted from the JAX package's) has no optimizer
                # state: parameters and step only
                state, meta, whole = trainer.restore(cand, state)
                if not whole:
                    print("restored params + step only (no optimizer state "
                          "in the checkpoint — it restarts)")
                best_mrr = float(meta.get("mrr", float("-inf")))
                print(f"resumed from {cand} at step {state.step} "
                      f"(best MRR {best_mrr:.4f})")
                break
        else:
            print(f"error: --resume but no checkpoint under "
                  f"{args.checkpoint_dir}", file=sys.stderr)
            return 2
    if args.pp > 1:
        return _run_joint_pp(args, trainer, state, train_ds, val_ds, jc,
                             best_mrr)

    tracker = BestMetricTracker(
        args.checkpoint_dir, metric="mrr", strategy=args.save_strategy,
        eval_steps=args.eval_every_steps,
        save_fn=lambda path, st: save_train_state(
            path, trainer.checkpoint_state(st), config=jc,
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


def _run_joint_pp(args, trainer, state, train_ds, val_ds, jc,
                  best_mrr) -> int:
    """GPipe-staged joint training (``train joint --pp N``): the dp path's
    datasets, tracker and checkpoint schema, the decoder streaming through
    the stages (``train/joint.PipelinedJointTrainer``).  A ``--resume``
    carries parameters and step into the pp layout; the optimizer restarts
    (the JAX CLI's ``_run_joint_pp``)."""
    import numpy as np

    from unirec_tpu_torch.train.callbacks import BestMetricTracker
    from unirec_tpu_torch.train.joint import PipelinedJointTrainer
    from unirec_tpu_torch.utils.checkpoint import save_pipeline_state

    ptrainer = PipelinedJointTrainer(trainer, pp=args.pp,
                                     num_microbatches=args.pp_microbatches)
    if state.step > 0:
        print("note: --resume under --pp restores params and the step "
              "counter; the optimizer state restarts (layout change)")
    pstate = ptrainer.init_trainable(state)
    del state

    def save_fn(path, st):
        save_pipeline_state(
            path, ptrainer.merged_params(st, to_host=True),
            # the hook already passes global steps to tracker.update
            tracker.last_eval_step, config=jc,
            extra={"mrr": tracker.best, "grad_accum": args.grad_accum,
                   **_joint_cfg_meta(trainer.qwen_config,
                                     trainer.qformer_config)})

    tracker = BestMetricTracker(
        args.checkpoint_dir, metric="mrr", strategy=args.save_strategy,
        eval_steps=args.eval_every_steps, save_fn=save_fn)
    if best_mrr > tracker.best:
        tracker.best = best_mrr
    ml = _metrics_logger(args)
    print("initial eval:", json.dumps(ptrainer.evaluate(pstate, val_ds)))

    def hook(step, st, metrics):
        if tracker.should_eval(step):
            ev = ptrainer.evaluate(st, val_ds)
            status = tracker.update(step, ev["mrr"], st)
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"eval={json.dumps(ev)} {status}")
            if ml:
                ml.log({"loss": metrics["loss"], **ev}, step=step)
        return st

    rng = np.random.default_rng(args.seed)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    pstate, _ = ptrainer.train_steps(
        pstate, train_ds, rng, num_steps=args.num_epochs * steps_per_epoch,
        step_hook=hook)
    final = ptrainer.evaluate(pstate, val_ds)
    print(f"final eval: {json.dumps(final)}; best MRR: {tracker.best:.4f}")
    if ml:
        ml.log(final)
        ml.close()
    return 0


_TRAINERS = {"joint": _run_joint, "item-qformer": _run_item_qformer,
             "user-qformer": _run_user_qformer}


if __name__ == "__main__":
    raise SystemExit(main())
