"""Batch item-query-token generation CLI (port of
``unirec_tpu/cli/generate_all_item_embeddings.py``).

    python -m unirec_tpu_torch.cli.generate_all_item_embeddings \\
        --checkpoint CKPT --cache-dir CACHE --output tokens.pkl --batch-size 4096

Same flags as the JAX CLI.  It sweeps a precomputed field-embedding cache
(``--cache-dir``) through ``QFormerInference`` on one device, the fused
engine with kernels B1-B3 on a CUDA card, or with the W8A8 kernels B4-B6
under ``--precision int8`` (which takes the fused engine on any device).
``--checkpoint`` is a checkpoint directory of ``utils/checkpoint.py`` or a
reference ``.pth``.

An OOM-shaped failure halves the batch (sticky) and retries; any other
failure of a batch falls back to per-item processing, and a failed item gets
zero tokens.  The number of items that took either fallback is printed and
written to the progress file as ``fallback_items``.

Not ported yet, refused with an error: ``--dp`` above 1, and ``--data``
without a cache (it needs the item encoders).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np

# framework-free helpers, shared with the JAX CLI
from unirec_tpu.cli.generate_all_item_embeddings import (
    _save,
    compare_processing_methods,
    is_oom_error,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data", help="item dict JSON (id -> fields)")
    p.add_argument("--checkpoint", required=False,
                   help="Item Q-Former checkpoint (directory or reference .pth)")
    p.add_argument("--cache-dir",
                   help="precomputed field-embedding cache directory")
    p.add_argument("--output", default="item_query_tokens.pkl",
                   help=".pkl or .json output path")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--min-batch-size", type=int, default=16,
                   help="floor for the memory-aware batch downshift")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel devices: -1 or 1 = one device (more "
                        "than one is not ported yet)")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--profile", action="store_true",
                   help="print per-batch timing stats")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    p.add_argument("--compare", action="store_true",
                   help="benchmark batch vs per-item processing on a sample")
    p.add_argument("--check-devices", action="store_true")
    p.add_argument("--progress-file", default=None)
    p.add_argument("--precision", default="bf16", choices=["bf16", "int8"],
                   help="bf16, or int8 for the W8A8 fused engine")
    return p.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dp > 1:
        return _fail("--dp > 1 (the data-parallel sweep) is not ported yet")

    from unirec_tpu.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.utils.profiling import (
        ProgressWriter,
        ThroughputMeter,
        check_devices,
        profiler_trace,
    )

    if args.check_devices:
        info = check_devices()
        if not (args.data or args.cache_dir):
            return 0 if info["ok"] else 1
    if not args.checkpoint:
        return _fail("--checkpoint required")
    if not (args.cache_dir and FieldEmbeddingCache.exists(args.cache_dir)):
        if args.data:
            return _fail("encoding raw items needs the item encoders, which "
                         "are not ported yet: pass --cache-dir with a "
                         "field-embedding cache")
        return _fail("need --cache-dir (a field-embedding cache)")

    inference = QFormerInference(args.checkpoint, batch_size=args.batch_size,
                                 precision=args.precision)
    cache = FieldEmbeddingCache.load(args.cache_dir)
    ids = cache.item_ids
    if args.max_items:
        ids = ids[: args.max_items]

    if args.compare:
        compare_processing_methods(inference, cache)
        return 0

    meter = ThroughputMeter(total_items=len(ids))
    progress = ProgressWriter(args.progress_file)
    tokens: Dict[str, np.ndarray] = {}
    fallback_items = 0

    current_bs = args.batch_size
    with profiler_trace(args.trace_dir):
        i = 0
        while i < len(ids):
            batch_ids = ids[i: i + current_bs]
            meter.start_batch()
            try:
                emb, mask = cache.gather(batch_ids)
                out = inference.query_tokens_from_embeddings(emb, mask)
                for j, iid in enumerate(batch_ids):
                    tokens[iid] = out[j]
            except Exception as e:  # noqa: BLE001  the sweep's boundary
                # memory-aware downshift: an OOM halves the batch (sticky)
                # and retries the same items
                # (reference: generate_all_item_embeddings.py:191-211)
                if is_oom_error(e) and current_bs > max(args.min_batch_size, 1):
                    current_bs = max(current_bs // 2, args.min_batch_size, 1)
                    inference.batch_size = current_bs
                    print(f"OOM at batch starting {i}; downshifting batch size "
                          f"to {current_bs} and retrying", file=sys.stderr)
                    continue
                # per-batch fallback (reference :295-309)
                print(f"batch starting {i} failed ({e}); falling back to "
                      "per-item", file=sys.stderr)
                fallback_items += len(batch_ids)
                for iid in batch_ids:
                    try:
                        e1, m1 = cache.gather([iid])
                        tokens[iid] = inference.query_tokens_from_embeddings(
                            e1, m1)[0]
                    except Exception:  # noqa: BLE001  degrade to zero tokens
                        tokens[iid] = np.zeros(
                            (inference.config.num_query_tokens,
                             inference.config.hidden_size), np.float32)
            i += len(batch_ids)
            dt = meter.end_batch(len(batch_ids))
            if args.profile:
                print(f"batch {i // args.batch_size}: {dt * 1e3:.1f} ms, "
                      f"{json.dumps(meter.stats())}")
            progress.update({"done": meter.items_done, "total": len(ids),
                             "fallback_items": fallback_items,
                             **meter.stats()})

    _save(tokens, args.output)
    progress.finish({"done": meter.items_done, "total": len(ids),
                     "fallback_items": fallback_items, **meter.stats()})
    print(f"generated query tokens for {len(tokens)} items "
          f"({meter.items_per_sec:.0f} items/s, {fallback_items} items took a "
          f"fallback) -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
