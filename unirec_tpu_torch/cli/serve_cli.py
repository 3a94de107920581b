"""Serve CLI (port of ``unirec_tpu/cli/serve_cli.py``): load the checkpoints
and the catalog, then answer HTTP ``/recommend`` requests.

    python -m unirec_tpu_torch.cli.serve_cli \\
        --qformer-checkpoint IQ_CKPT_DIR --cache-dir CACHE_DIR \\
        --item-dict items.json --catalog emb.json --port 8099 \\
        [--checkpoint JOINT_CKPT_DIR] [--quantize] \\
        [--precision int8 [--merge-lora] [--no-fused-blocks]] [--prewarm] \\
        [--host-field-cache]

The flags are the JAX CLI's.  ``--checkpoint`` and ``--qformer-checkpoint``
are checkpoint directories of ``utils/checkpoint.py`` (the Item Q-Former's
may also be a reference ``.pth``).  Without ``--checkpoint`` the joint model
is initialised from seed 0 around the given Item Q-Former, as in the JAX
CLI: the ranking then rests on the Q-Former and the catalog alone, which
smoke-tests a deployment before joint training is done.  The model runs on
the CUDA card in bfloat16 (the kernels' type); ``--device cpu`` asks for the
CPU, where it runs in float32.  Without a card and without that flag it
raises.

``--hf-path`` names a local Hugging Face tokenizer directory
(``data/tokenizer.HFTokenizer``; needs ``transformers``); without it the
prompts take the hash tokenizer.  The field cache lives on the card in
bfloat16; ``--host-field-cache`` (not a flag of the JAX CLI) keeps it on the
host for a catalog whose cache does not fit there, and uploads each batch's
gathered fields instead (``Recommender(device_field_cache=False)``).
``users`` (``cli/user_embeddings.py``) shares these flags.

Not ported, refused with an error: ``--dp`` (a dp mesh, ROADMAP.md A9).
"""

from __future__ import annotations

import argparse
import json


def add_recommender_flags(p, batch_size: int = 8):
    """Every flag ``build_recommender`` reads."""
    p.add_argument("--checkpoint", default=None,
                   help="joint-model checkpoint directory (optional)")
    p.add_argument("--qformer-checkpoint", required=True)
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--item-dict", required=True)
    p.add_argument("--catalog", required=True,
                   help="candidate item-embedding JSON")
    p.add_argument("--hf-path", default=None,
                   help="local Hugging Face tokenizer directory (default: "
                        "the hash tokenizer)")
    p.add_argument("--batch-size", type=int, default=batch_size)
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize the catalog")
    p.add_argument("--precision", default="bf16", choices=["bf16", "int8"],
                   help="int8: W8A8 Qwen3 projections for user encoding")
    p.add_argument("--merge-lora", action="store_true",
                   help="fold the LoRA adapters into the base weights "
                        "(int8 then quantizes the adapted weights)")
    p.add_argument("--no-fused-blocks", action="store_true",
                   help="disable the fused int8 Qwen3 blocks (B9a/B9b); "
                        "int8 then runs each projection on its own")
    p.add_argument("--prewarm", action="store_true",
                   help="tokenize all prompt fragments at startup")
    p.add_argument("--host-field-cache", action="store_true",
                   help="keep the field cache on the host and gather each "
                        "batch's history fields there (a catalog whose "
                        "cache does not fit in the card's memory)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny Qwen3 config (smoke tests / CPU)")
    p.add_argument("--dp", type=int, default=0,
                   help="dp mesh size (not ported: anything but 0 raises)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_recommender_flags(p, batch_size=8)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8099)
    return p.parse_args(argv)


def build_recommender(args):
    """Load checkpoints and catalog and assemble the ``Recommender`` (apart
    from ``main`` so that tests drive it without the HTTP loop)."""
    import torch

    from unirec_tpu_torch.configs import (
        JointModelConfig,
        LoRAConfig,
        Qwen3Config,
        tiny_qwen3_config,
    )
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.data.tokenizer import make_tokenizer
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding
    from unirec_tpu_torch.serving.recommender import Recommender
    from unirec_tpu_torch.utils.checkpoint import load_checkpoint
    from unirec_tpu_torch.utils.device import resolve_device
    from unirec_tpu_torch.utils.weights import init_joint

    if args.dp:
        raise NotImplementedError(
            "--dp (serving over a dp mesh) is not ported yet (ROADMAP.md A9)")
    device = resolve_device(args.device)
    with open(args.item_dict) as f:
        item_dict = json.load(f)
    with open(args.catalog) as f:
        catalog = json.load(f)
    cache = FieldEmbeddingCache.load(args.cache_dir)
    qf_cfg, qf_state, _ = QFormerInference.read_checkpoint(
        args.qformer_checkpoint)

    if args.tiny:
        # hidden must match the Q-Former's: query tokens are injected into
        # the LLM's embedding space
        qwen_cfg = tiny_qwen3_config(
            vocab_size=4096, hidden_size=qf_cfg.hidden_size,
            intermediate_size=1024, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, head_dim=128,
            max_position_embeddings=max(128, args.max_length))
    else:
        qwen_cfg = Qwen3Config()
    cat_dim = len(next(iter(catalog.values())))
    if cat_dim != qwen_cfg.hidden_size:
        raise ValueError(
            f"catalog embedding dim {cat_dim} != LLM hidden size "
            f"{qwen_cfg.hidden_size}; regenerate --catalog with the same "
            "base model")
    jc = JointModelConfig(max_length=args.max_length)
    tokenizer = make_tokenizer(args.hf_path, qwen_cfg.vocab_size,
                               jc.num_history_items,
                               jc.num_query_tokens_per_item)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.checkpoint:
        state, _ = load_checkpoint(args.checkpoint)
        model = MultiModalQwenEmbedding(qwen_cfg, qf_cfg, jc, lora=LoRAConfig(),
                                        device=device, dtype=dtype)
        model.load_state_dict(state)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        model = init_joint(qwen_cfg, qf_cfg, jc, LoRAConfig(), gen,
                           device=device, dtype=dtype)
        model.qformer.load_state_dict(qf_state)
    rec = Recommender(
        model, tokenizer, item_dict, cache, catalog,
        batch_size=args.batch_size, precision=args.precision,
        quantize_catalog=args.quantize, merge_lora=args.merge_lora,
        fused_blocks=False if args.no_fused_blocks else None,
        device_field_cache=not args.host_field_cache)
    if args.prewarm:
        print(f"prewarmed {rec.prewarm_prompts()} prompt fragments")
    return rec


def main(argv=None) -> int:
    from unirec_tpu_torch.serving.server import serve

    args = parse_args(argv)
    rec = build_recommender(args)
    serve(rec, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
