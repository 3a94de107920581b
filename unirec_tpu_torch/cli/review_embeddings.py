"""Review embedding stage (port of ``unirec_tpu/cli/review_embeddings.py``).

    python -m unirec_tpu_torch review-embed --review-dict reviews.json \\
        --item-dict items.json --item-emb clip_emb.json --output out.json

Rebuild of data_processing/review_embedding_clip.py: for a user's history,
embed each review (text + review image, falling back to the item image) with
CLIP, then concatenate with the item embedding -> ``[N, 2 * dim]`` vectors
(reference :106-131), written to JSON keyed ``"user|item"``.  Without
``--hf-path`` both towers are the hash backends; with it the image tower is
a local Hugging Face CLIP checkpoint's (on the card unless ``--device cpu``;
needs ``transformers`` and PIL) and the text stays the hash backend, as in
the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from unirec_tpu_torch.cli.candidate_embeddings import get_main_images


def review_text(review: Dict) -> str:
    parts = [review.get("title", ""),
             review.get("text", review.get("reviewText", ""))]
    return " ".join(p for p in parts if p)


def review_images(review: Dict, item: Dict) -> Optional[str]:
    """Review image, falling back to the item's main image (reference
    :110-118)."""
    imgs = review.get("images") or []
    for img in imgs:
        for key in ("large_image_url", "attachment_url", "large"):
            if isinstance(img, dict) and img.get(key):
                return img[key]
    item_imgs = get_main_images(item)
    return item_imgs[0] if item_imgs else None


def build_review_embeddings(
    review_dict: Dict[str, Dict],
    item_dict: Dict[str, Dict],
    item_embeddings: Dict[str, List[float]],
    text_backend,
    image_backend,
    keys: Optional[List[str]] = None,
) -> Dict[str, List[float]]:
    """CLIP mean(text, image) per review, concatenated with the item's
    embedding."""
    keys = keys or [
        k for k in review_dict if k.split("|", 1)[-1] in item_embeddings
    ]
    texts, img_refs, kept = [], [], []
    for key in keys:
        item = item_dict.get(key.split("|", 1)[-1], {})
        texts.append(review_text(review_dict[key]))
        img_refs.append(review_images(review_dict[key], item))
        kept.append(key)
    if not kept:
        return {}
    t_emb = text_backend.encode(texts)
    i_emb = image_backend.encode([r if r is not None else "" for r in img_refs])
    out = {}
    for j, key in enumerate(kept):
        item_emb = np.asarray(item_embeddings[key.split("|", 1)[-1]],
                              np.float32)
        review_emb = (np.asarray(t_emb[j]) + np.asarray(i_emb[j])) / 2.0
        out[key] = np.concatenate([review_emb.astype(np.float32),
                                   item_emb]).tolist()
    return out


def main(argv=None) -> int:
    from unirec_tpu_torch.encoders.backends import (
        CLIPImageBackend,
        HashImageBackend,
        HashTextBackend,
    )

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--review-dict", required=True)
    p.add_argument("--item-dict", required=True)
    p.add_argument("--item-emb", required=True,
                   help="candidate item-embedding JSON (clip stage output)")
    p.add_argument("--output", required=True)
    p.add_argument("--hf-path", default=None)
    p.add_argument("--max-reviews", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="where an --hf-path tower runs: cuda (the default; "
                        "raises without a card) or cpu")
    args = p.parse_args(argv)

    with open(args.review_dict) as f:
        review_dict = json.load(f)
    with open(args.item_dict) as f:
        item_dict = json.load(f)
    with open(args.item_emb) as f:
        item_embeddings = json.load(f)

    if args.hf_path:
        image_backend = CLIPImageBackend.from_local_hf(args.hf_path,
                                                       device=args.device)
        text_backend = HashTextBackend(image_backend.dim)  # CLIP text optional
    else:
        dim = len(next(iter(item_embeddings.values())))
        text_backend, image_backend = HashTextBackend(dim), HashImageBackend(dim)

    keys = list(review_dict)
    if args.max_reviews:
        keys = keys[: args.max_reviews]
    out = build_review_embeddings(
        review_dict, item_dict, item_embeddings, text_backend, image_backend,
        keys=[k for k in keys if k.split("|", 1)[-1] in item_embeddings])
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"{len(out)} review embeddings -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
