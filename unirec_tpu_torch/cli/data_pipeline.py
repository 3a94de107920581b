"""Data-pipeline CLI: dict building, field filtering, rec-sample generation
(port of ``unirec_tpu/cli/data_pipeline.py``; the same flags and the same
output files, byte for byte).

    python -m unirec_tpu_torch data item-dict --input meta.jsonl --output items.json

Mirrors the reference scripts as subcommands (SURVEY.md C13-C17):
  item-dict     (create_item_dict.py)      meta JSONL -> item dict JSON
  review-dict   (create_review_dict.py)    review JSONL -> review dict JSON
  triplet-dict  (create_triplet_dict.py)   item dict -> 14-field filtered dict
  rec-new-user  (process_rec_new_user.py)  .inter -> LRanker train/test JSON
  rec-old-user  (process_rec_old_user.py)  .inter -> 20-history train/test JSON
"""

from __future__ import annotations

import argparse
import json
import os


def _write_json(obj, path: str, indent=None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False, indent=indent)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("item-dict")
    sp.add_argument("--input", required=True, help="meta_*.jsonl")
    sp.add_argument("--output", required=True)

    sp = sub.add_parser("review-dict")
    sp.add_argument("--input", required=True, help="reviews .jsonl")
    sp.add_argument("--output", required=True)

    sp = sub.add_parser("triplet-dict")
    sp.add_argument("--input", required=True, help="item dict JSON")
    sp.add_argument("--output", required=True)
    sp.add_argument("--config", default=None, help="field schema YAML")

    sp = sub.add_parser("rec-new-user")
    sp.add_argument("--inter", required=True, help=".inter TSV")
    sp.add_argument("--output-prefix", required=True)
    sp.add_argument("--num-samples", type=int, default=290)
    sp.add_argument("--hist-len", type=int, default=10)
    sp.add_argument("--num-candidates", type=int, default=100)
    sp.add_argument("--test-size", type=float, default=0.2)
    sp.add_argument("--seed", type=int, default=42)

    sp = sub.add_parser("rec-old-user")
    sp.add_argument("--inter", required=True)
    sp.add_argument("--output-prefix", required=True)
    sp.add_argument("--min-interactions", type=int, default=12)
    sp.add_argument("--num-candidates", type=int, default=100)
    sp.add_argument("--seed", type=int, default=42)

    args = p.parse_args(argv)

    from unirec_tpu_torch.configs import DEFAULT_FIELD_MAPPING, FieldSchema
    from unirec_tpu_torch.data import builders

    if args.cmd == "item-dict":
        d = builders.build_item_dict(args.input)
        _write_json(d, args.output)
        print(f"{len(d)} items -> {args.output}")
    elif args.cmd == "review-dict":
        d = builders.build_review_dict(args.input)
        _write_json(d, args.output)
        print(f"{len(d)} reviews -> {args.output}")
    elif args.cmd == "triplet-dict":
        with open(args.input) as f:
            item_dict = json.load(f)
        mapping = (
            FieldSchema.from_yaml(args.config).as_dict()
            if args.config
            else dict(DEFAULT_FIELD_MAPPING)
        )
        filtered = builders.build_triplet_dict(item_dict, mapping)
        _write_json(filtered, args.output, indent=2)
        print(f"{len(item_dict)} -> {len(filtered)} filtered items "
              f"-> {args.output}")
    elif args.cmd == "rec-new-user":
        seqs = builders.user_sequences(builders.load_interactions(args.inter))
        samples = builders.create_new_user_samples(
            seqs, args.num_samples, args.hist_len, args.num_candidates,
            args.seed,
        )
        train, test = builders.train_test_split(
            samples, args.test_size, args.seed
        )
        _write_json(train, args.output_prefix + "_train_LRanker.json", indent=4)
        _write_json(test, args.output_prefix + "_test_LRanker.json", indent=4)
        print(f"{len(train)} train / {len(test)} test samples")
    elif args.cmd == "rec-old-user":
        seqs = builders.user_sequences(builders.load_interactions(args.inter))
        train, test = builders.create_old_user_samples(
            seqs, args.min_interactions, args.num_candidates, args.seed
        )
        _write_json(train, args.output_prefix + "_train.json", indent=4)
        _write_json(test, args.output_prefix + "_test.json", indent=4)
        print(f"{len(train)} train / {len(test)} test samples")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
