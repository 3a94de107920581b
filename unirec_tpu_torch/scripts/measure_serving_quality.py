"""Quality gate for the serving user-embedding paths against the fp32
forward (port of ``scripts/measure_serving_quality.py``).

Measures per-user cosine similarity of ``Recommender.encode_users`` for
each serving mode against the fp32 oracle (the same ``Recommender`` over
the float32 model) at the production config (Qwen3-0.6B, seq 512,
seeded random weights from ``utils/weights.init_joint``: the weights'
statistics, not their values, drive quantization error):

    bf16        the compute dtype bfloat16 over the same weights (K1)
    int8_xla    precision="int8", fused_blocks=False (B8 per projection)
    int8_fused  precision="int8", merge_lora=True (B9a, B9b, B8 on o_proj)

Gate: per-user cosine >= 0.9995 for bf16 and >= 0.999 for both int8 modes
(the item engine's bar, ``measure_int8_quality.py``).  Exits 1 when a gate
is missed.

    python -m unirec_tpu_torch.scripts.measure_serving_quality [--users 64]
        [--batch 16] [--catalog 2000] [--seq 512] [--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from unirec_tpu_torch.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    Qwen3Config,
    tiny_qwen3_config,
)
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import HashTokenizer
from unirec_tpu_torch.scripts import full_fp32

# each mode's Recommender arguments over the bfloat16 model
MODES = {
    "bf16": {},
    "int8_xla": dict(precision="int8", fused_blocks=False),
    "int8_fused": dict(precision="int8", merge_lora=True),
}
GATES = {"bf16": 0.9995, "int8_xla": 0.999, "int8_fused": 0.999}


def configs(tiny: bool, seq: int = 512):
    """(Qwen3, Item Q-Former, joint) configs: production, or the JAX
    script's ``--tiny`` (hidden 128, one head of 128, L 64: batch 8 x 64 =
    512 rows, the fused int8 tile)."""
    if tiny:
        qwen = tiny_qwen3_config(
            hidden_size=128, intermediate_size=256, num_attention_heads=1,
            num_key_value_heads=1, head_dim=128, max_position_embeddings=64,
            flash_attention=False,
        )
        qf = ItemQFormerConfig(
            hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, num_query_tokens=2, field_embedding_dim=16,
            num_fields=3, dropout=0.0,
        )
        return qwen, qf, JointModelConfig(max_length=64)
    return (Qwen3Config(), ItemQFormerConfig(num_query_tokens=2),
            JointModelConfig(max_length=seq))


def serving_data(qwen: Qwen3Config, qf: ItemQFormerConfig,
                 jc: JointModelConfig, n: int, users: int, seed: int = 0):
    """(field cache, catalog, item dict, tokenizer, histories): the JAX
    script's draws, in its order, from one ``RandomState``."""
    rng = np.random.RandomState(seed)
    item_ids = ["B%08d" % k for k in range(n)]
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, qf.num_fields, qf.field_embedding_dim)
        .astype(np.float32),
        masks=np.ones((n, qf.num_fields), np.float32),
        fields=[f"f{j}" for j in range(qf.num_fields)],
        item_ids=item_ids,
    )
    catalog = {iid: rng.randn(qwen.hidden_size).astype(np.float32)
               for iid in item_ids}
    item_dict = {iid: {"title": f"Product {k} with a catalog title"}
                 for k, iid in enumerate(item_ids)}
    tok = HashTokenizer(qwen.vocab_size, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    hists = []
    for _ in range(users):
        h = rng.randint(1, 8)
        hists.append(["B%08d" % rng.randint(0, n) for _ in range(h)])
    return cache, catalog, item_dict, tok, hists


def bf16_model(model32):
    """A module computing in bfloat16 over ``model32``'s float32 tensors
    (shared, not copied): the JAX script's bfloat16 model over the same
    params."""
    from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding

    model = MultiModalQwenEmbedding(
        model32.qwen_config, model32.qformer_config, model32.joint_config,
        model32.lora, device="meta", dtype=torch.bfloat16,
        param_dtype=model32.param_dtype)
    model.load_state_dict(model32.state_dict(), assign=True)
    return model


def encode(model, tok, item_dict: Dict, cache: FieldEmbeddingCache,
           catalog: Dict, hists: Sequence[Sequence[str]], batch: int,
           **kw) -> np.ndarray:
    """``Recommender(model, ..., **kw).encode_users(hists)``."""
    from unirec_tpu_torch.serving.recommender import Recommender

    rec = Recommender(model, tok, item_dict, cache, catalog,
                      batch_size=batch, **kw)
    return rec.encode_users(hists)


def encode_modes(model32, tok, item_dict: Dict, cache: FieldEmbeddingCache,
                 catalog: Dict, hists: Sequence[Sequence[str]], batch: int,
                 log: Callable[[str], None] = print,
                 after: Callable[[str], None] = lambda label: None
                 ) -> Dict[str, np.ndarray]:
    """User embeddings [users, D] of the fp32 oracle ("fp32": ``model32``
    itself) and of each of ``MODES`` over ``bf16_model(model32)``.
    ``after(label)`` runs after each mode (the launch counters' reader)."""
    full_fp32()
    model_bf16 = bf16_model(model32)
    out = {}
    for label, model, kw in [("fp32", model32, {})] + [
            (label, model_bf16, kw) for label, kw in MODES.items()]:
        t0 = time.time()
        out[label] = encode(model, tok, item_dict, cache, catalog, hists,
                            batch, **kw)
        log(f"  {label}: encoded in {time.time() - t0:.1f}s")
        after(label)
    return out


def user_cosines(emb: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-user cosine of ``emb`` against ``ref``, both [users, D]."""
    return (emb * ref).sum(-1) / (
        np.linalg.norm(emb, axis=-1) * np.linalg.norm(ref, axis=-1) + 1e-9)


def gate_lines(results: Dict[str, np.ndarray]) -> List[tuple]:
    """[(line, passed)] of each mode against ``results["fp32"]``, as the
    JAX script prints them."""
    out = []
    for label in MODES:
        cos = user_cosines(results[label], results["fp32"])
        gate = GATES[label]
        ok = bool(cos.min() >= gate)
        out.append((f"{label}: cosine mean {cos.mean():.5f} min "
                    f"{cos.min():.5f} (gate {gate}) {'OK' if ok else 'FAIL'}",
                    ok))
    return out


def main(argv=None) -> int:
    from unirec_tpu_torch.utils.device import resolve_device
    from unirec_tpu_torch.utils.weights import init_joint

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--users", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--catalog", type=int, default=2000)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    qwen, qf, jc = configs(args.tiny, args.seq)
    if args.tiny:
        args.catalog = min(args.catalog, 200)
        args.batch = 8  # 8 * 64 = 512 rows: the fused tile

    cache, catalog, item_dict, tok, hists = serving_data(
        qwen, qf, jc, args.catalog, args.users)
    t0 = time.time()
    model32 = init_joint(qwen, qf, jc, LoRAConfig(),
                         torch.Generator(device).manual_seed(0),
                         device=device)
    print(f"init: {time.time() - t0:.1f}s", flush=True)
    results = encode_modes(model32, tok, item_dict, cache, catalog, hists,
                           args.batch,
                           log=lambda msg: print(msg, flush=True))
    ok = True
    for line, passed in gate_lines(results):
        print(line, flush=True)
        ok &= passed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
