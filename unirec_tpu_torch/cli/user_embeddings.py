"""Offline bulk user-embedding sweep (port of
``unirec_tpu/cli/user_embeddings.py``).

The batch counterpart of serving's online user encoding: every user's
interaction history becomes one L2-normalised joint-space vector
(``serving/recommender.Recommender.encode_users``: fixed-shape batches,
fragment-cached tokenization, optional int8), for downstream batch retrieval
or ANN index builds.

    python -m unirec_tpu_torch users \\
        --qformer-checkpoint iq_ckpt/ --cache-dir cache/ \\
        --item-dict items.json --catalog emb.json \\
        --histories histories.json --output user_emb.npy

``--histories`` accepts either a dict ``{user_id: [asin, ...]}`` or the
LRanker sample list ``[{"user_id": ..., "history": [...]}, ...]`` that the
``data rec-*`` commands write.  ``--output *.npy`` writes the embedding
matrix plus a ``<output>.ids.json`` sidecar; ``--output *.json`` writes one
``{user_id: [floats]}`` map.  The other flags are ``serve_cli``'s: the model
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    from unirec_tpu_torch.cli.serve_cli import add_recommender_flags

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_recommender_flags(p, batch_size=16)
    p.add_argument("--histories", required=True,
                   help="user histories JSON (dict user->[asins] or "
                        "LRanker sample list)")
    p.add_argument("--output", required=True,
                   help=".npy matrix (+ .ids.json sidecar) or .json map")
    return p.parse_args(argv)


def load_histories(path: str):
    """-> (user_ids, histories) from either accepted schema."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        ids = list(data)
        return ids, [list(data[u]) for u in ids]
    ids, hists = [], []
    for i, sample in enumerate(data):
        ids.append(str(sample.get("user_id", i)))
        hists.append(list(sample["history"]))
    return ids, hists


def main(argv=None) -> int:
    import numpy as np

    from unirec_tpu_torch.cli.serve_cli import build_recommender
    from unirec_tpu_torch.utils.profiling import ThroughputMeter

    args = parse_args(argv)
    user_ids, histories = load_histories(args.histories)
    rec = build_recommender(args)

    meter = ThroughputMeter()
    meter.start_batch()
    emb = rec.encode_users(histories)
    meter.end_batch(len(histories))
    if emb.shape[0] != len(user_ids):
        raise RuntimeError(f"{emb.shape[0]} embeddings for {len(user_ids)} "
                           "users")
    if args.output.endswith(".json"):
        with open(args.output, "w") as f:
            json.dump({u: emb[i].tolist() for i, u in enumerate(user_ids)}, f)
    else:
        np.save(args.output, emb.astype(np.float32))
        with open(args.output + ".ids.json", "w") as f:
            json.dump(user_ids, f)
    print(f"{len(user_ids)} user embeddings [{emb.shape[0]}, {emb.shape[1]}]"
          f" -> {args.output} ({meter.items_per_sec:.1f} users/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
