"""Candidate-pool item-embedding stages (port of
``unirec_tpu/cli/candidate_embeddings.py``).

    python -m unirec_tpu_torch embed qwen3 --item-dict items.json \\
        --samples train.json test.json --output emb.json [--hf-path DIR]

Two modes:

* ``clip``: CLIP text+image mean embedding per item (reference:
  data_processing/item_embedding_clip.py: text = title + features +
  description + details; first large image; mean(text_embed, image_embed)
  -> ``*_item_embedding_clip.json``); items without an image, or whose
  image does not load, are skipped.
* ``qwen3``: the same assembled item text through the Qwen3-Embedding text
  backend -> JSON (the stage the joint trainer's
  ``all_beauty_item_embedding_qwen3_0.6B.json`` comes from).

Both keep to the items of the train/test samples' histories, candidate
pools and ground truths (reference :64-78) when sample files are given.
Without ``--hf-path`` the towers are the weightless hash backends (numpy,
the JAX package's bits); with it, a local Hugging Face checkpoint's towers
(``Qwen3TextBackend``; ``CLIPImageBackend`` and ``CLIPTextBackend``) run on
the card unless ``--device cpu`` is given, and need ``transformers`` (and
PIL for images).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Set

import numpy as np


def extract_text(item: Dict) -> str:
    """reference: data_processing/item_embedding_clip.py:17-26."""
    parts = [item.get("title", "")]
    if item.get("features"):
        f = item["features"]
        parts.append(" ".join(f) if isinstance(f, list) else str(f))
    if item.get("description"):
        d = item["description"]
        parts.append(" ".join(d) if isinstance(d, list) else str(d))
    if item.get("details"):
        parts.append(", ".join(f"{k}: {v}" for k, v in item["details"].items()))
    return " ".join(parts)


def get_main_images(item: Dict) -> List[str]:
    """reference: data_processing/item_embedding_clip.py:28-29."""
    return [img["large"] for img in item.get("images", []) if "large" in img]


def collect_sample_item_ids(sample_paths: List[str]) -> Set[str]:
    """Union of history + candidates + ground truth (reference :68-76)."""
    ids: Set[str] = set()
    for path in sample_paths:
        with open(path) as f:
            data = json.load(f)
        for sample in data:
            ids.update(sample.get("history", []))
            ids.update(sample.get("candidate", []))
            if "ground_truth" in sample:
                ids.add(sample["ground_truth"])
    return ids


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("mode", choices=["clip", "qwen3"])
    p.add_argument("--item-dict", required=True)
    p.add_argument("--samples", nargs="*", default=[],
                   help="train/test sample JSONs to restrict the item set")
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--hf-path", default=None,
                   help="local HF checkpoint (CLIP or Qwen3) for real weights")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--embedding-dim", type=int, default=1024,
                   help="output dim for the weightless hash backend "
                        "(must match the joint model's hidden size)")
    p.add_argument("--device", default="cuda",
                   help="where an --hf-path tower runs: cuda (the default; "
                        "raises without a card) or cpu")
    return p.parse_args(argv)


def clip_embeddings(item_dict: Dict, item_ids: List[str], text_backend,
                    image_backend, batch_size: int) -> Dict[str, list]:
    """mean(text, image) per item with an image; items whose image fails to
    load are skipped."""
    embeddings: Dict[str, list] = {}
    texts, urls, kept = [], [], []
    for iid in item_ids:
        item = item_dict[iid]
        images = get_main_images(item)
        if not images:
            continue  # reference skips items without images (:101-102)
        texts.append(extract_text(item))
        urls.append(images[0])
        kept.append(iid)
    for i in range(0, len(kept), batch_size):
        t_emb = text_backend.encode(texts[i: i + batch_size])
        i_emb = image_backend.encode(urls[i: i + batch_size])
        for j, iid in enumerate(kept[i: i + batch_size]):
            if np.abs(i_emb[j]).sum() == 0:
                continue  # image failed to load -> skip item
            combined = (t_emb[j] + i_emb[j]) / 2.0
            embeddings[iid] = combined.astype(np.float32).tolist()
    return embeddings


def main(argv=None) -> int:
    from unirec_tpu_torch.encoders.backends import (
        CLIPImageBackend,
        CLIPTextBackend,
        HashImageBackend,
        HashTextBackend,
        Qwen3TextBackend,
    )

    args = parse_args(argv)
    with open(args.item_dict) as f:
        item_dict = json.load(f)
    if args.samples:
        keep = collect_sample_item_ids(args.samples)
        item_ids = [i for i in item_dict if i in keep]
    else:
        item_ids = list(item_dict)
    if args.max_items:
        item_ids = item_ids[: args.max_items]

    if args.mode == "qwen3":
        backend = (Qwen3TextBackend.from_local_hf(args.hf_path,
                                                  device=args.device)
                   if args.hf_path else HashTextBackend(args.embedding_dim))
        embs = backend.encode([extract_text(item_dict[i]) for i in item_ids])
        embeddings = {iid: np.asarray(embs[i], np.float32).tolist()
                      for i, iid in enumerate(item_ids)}
    else:  # clip: mean(text_embed, image_embed); items w/o image skipped
        if args.hf_path:
            image_backend = CLIPImageBackend.from_local_hf(args.hf_path,
                                                           device=args.device)
            text_backend = CLIPTextBackend.from_local_hf(args.hf_path,
                                                         device=args.device)
        else:
            text_backend, image_backend = HashTextBackend(512), \
                HashImageBackend(512)
        embeddings = clip_embeddings(item_dict, item_ids, text_backend,
                                     image_backend, args.batch_size)

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(embeddings, f)
    print(f"{len(embeddings)} item embeddings -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
