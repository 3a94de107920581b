"""Data-pipeline builders: dicts, field filtering, and rec-sample generation
(the port's copy of ``unirec_tpu/data/builders.py``, kept line for line: the
same ``random.Random(seed)`` draws, so that both packages write the same
sample files byte for byte).

Plain-Python stage of the pipeline (SURVEY.md §7.2.6), rebuilt from:
  * create_item_dict.py      — meta JSONL -> {parent_asin: metadata}
  * create_review_dict.py    — review JSONL -> {"user|asin": review}
  * create_triplet_dict.py   — filter items to the 14 configured fields
  * process_rec_new_user.py  — first-10-history samples + 100-candidate pools
  * process_rec_old_user.py  — sliding 20-history train/test samples

All functions are deterministic given a seed (the reference uses the global
``random`` module; here every sampler takes an explicit ``random.Random``).
"""

from __future__ import annotations

import json
import random as _random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Dict builders
# ---------------------------------------------------------------------------


def build_item_dict(jsonl_path: str) -> Dict[str, dict]:
    """meta_*.jsonl -> {parent_asin: metadata}
    (reference: data_processing/create_item_dict.py:3-18)."""
    item_dict: Dict[str, dict] = {}
    with open(jsonl_path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            parent_asin = obj.pop("parent_asin", None)
            if parent_asin is not None:
                item_dict[parent_asin] = obj
    return item_dict


def build_review_dict(jsonl_path: str) -> Dict[str, dict]:
    """review jsonl -> {"user|asin": review}
    (reference: data_processing/create_review_dict.py:3-20)."""
    review_dict: Dict[str, dict] = {}
    with open(jsonl_path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            user_id = obj.pop("user_id", None)
            parent_asin = obj.pop("parent_asin", None)
            if user_id is not None and parent_asin is not None:
                review_dict[f"{user_id}|{parent_asin}"] = obj
    return review_dict


# ---------------------------------------------------------------------------
# Triplet-dict field filtering
# ---------------------------------------------------------------------------

_DETAILS_FIELD_MAP = {
    "Brand": "brand",
    "Style": "style",
    "Color": "color",
    "Size": "size",
    "Material": "material",
}

_DIRECT_FIELDS = (
    "title", "main_category", "store", "price", "average_rating", "rating_number",
)


def _join_list_field(value) -> str:
    if isinstance(value, list):
        return " ".join(value) if value else ""
    return str(value) if value else ""


def extract_main_image(images) -> Optional[str]:
    """variant == MAIN, prefer large then hi_res
    (reference: data_processing/create_triplet_dict.py:38-51)."""
    if not images:
        return None
    for img in images:
        if img.get("variant") == "MAIN":
            return img.get("large") or img.get("hi_res")
    return None


def filter_item_data(item_data: dict, field_mapping: Dict[str, object]) -> dict:
    """Keep only configured fields; lists -> strings, details -> lowercase
    fields, images -> main_image
    (reference: data_processing/create_triplet_dict.py:53-92)."""
    out: dict = {}
    for field in _DIRECT_FIELDS:
        if field in field_mapping and field in item_data:
            out[field] = item_data[field]
    for field in ("description", "features"):
        if field in field_mapping and field in item_data:
            out[field] = _join_list_field(item_data[field])
    details = item_data.get("details")
    if isinstance(details, dict):
        for dkey, dval in details.items():
            cfg_field = _DETAILS_FIELD_MAP.get(dkey)
            if cfg_field and cfg_field in field_mapping:
                out[cfg_field] = dval
    if "images" in item_data and "main_image" in field_mapping:
        main_img = extract_main_image(item_data["images"])
        if main_img:
            out["main_image"] = main_img
    return out


def build_triplet_dict(
    item_dict: Dict[str, dict], field_mapping: Dict[str, object]
) -> Dict[str, dict]:
    filtered = {}
    for asin, data in item_dict.items():
        f = filter_item_data(data, field_mapping)
        if f:
            filtered[asin] = f
    return filtered


# ---------------------------------------------------------------------------
# Interaction loading + rec-sample builders
# ---------------------------------------------------------------------------


def load_interactions(inter_path: str) -> List[Tuple[str, str, float, int]]:
    """.inter TSV (user, item, rating, timestamp), header skipped, sorted by
    (user, timestamp) (reference: process_rec_new_user.py:17-41)."""
    rows: List[Tuple[str, str, float, int]] = []
    with open(inter_path, encoding="utf-8") as f:
        next(f)
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 4:
                rows.append((str(parts[0]), parts[1], float(parts[2]), int(parts[3])))
    rows.sort(key=lambda r: (r[0], r[3]))
    return rows


def user_sequences(
    interactions: Sequence[Tuple[str, str, float, int]]
) -> Dict[str, List[str]]:
    """user -> time-ordered item list."""
    seqs: Dict[str, List[str]] = defaultdict(list)
    for user, item, _rating, _ts in interactions:
        seqs[user].append(item)
    return dict(seqs)


def _sample_candidates(
    rng: _random.Random,
    all_items: Sequence[str],
    history: Sequence[str],
    ground_truth: str,
    num_candidates: int,
) -> Optional[List[str]]:
    excluded = set(history) | {ground_truth}
    available = [i for i in all_items if i not in excluded]
    if len(available) < num_candidates - 1:
        return None
    negatives = rng.sample(available, num_candidates - 1)
    candidates = [ground_truth] + negatives
    rng.shuffle(candidates)
    return candidates


def create_new_user_samples(
    sequences: Dict[str, List[str]],
    num_samples: int = 290,
    hist_len: int = 10,
    num_candidates: int = 100,
    seed: int = 42,
) -> List[Dict]:
    """history = first hist_len items, gt = item hist_len; 99 negatives + gt
    shuffled into a 100-candidate pool
    (reference: process_rec_new_user.py:43-87)."""
    rng = _random.Random(seed)
    valid = [u for u, seq in sequences.items() if len(seq) >= hist_len + 1]
    if len(valid) < num_samples:
        raise ValueError(
            f"not enough users: found {len(valid)}, need {num_samples}"
        )
    selected = rng.sample(sorted(valid), num_samples)
    all_items = sorted({i for seq in sequences.values() for i in seq})
    samples = []
    for user in selected:
        seq = sequences[user]
        history, gt = seq[:hist_len], seq[hist_len]
        candidates = _sample_candidates(rng, all_items, history, gt, num_candidates)
        if candidates is None:
            continue
        samples.append(
            {
                "user_id": str(user),
                "history": history,
                "candidate": candidates,
                "ground_truth": gt,
            }
        )
    return samples


def create_old_user_samples(
    sequences: Dict[str, List[str]],
    min_interactions: int = 12,
    num_candidates: int = 100,
    seed: int = 42,
) -> Tuple[List[Dict], List[Dict]]:
    """Users with > min_interactions: train history seq[-22:-2] / gt seq[-2];
    test history seq[-21:-1] / gt seq[-1]
    (reference: process_rec_old_user.py:43-105)."""
    rng = _random.Random(seed)
    all_items = sorted({i for seq in sequences.values() for i in seq})
    train, test = [], []
    for user in sorted(sequences):
        seq = sequences[user]
        if len(seq) <= min_interactions:
            continue
        t_hist, t_gt = seq[-22:-2], seq[-2]
        cand = _sample_candidates(rng, all_items, t_hist, t_gt, num_candidates)
        if cand is None:
            continue
        train.append(
            {"user_id": str(user), "history": t_hist, "candidate": cand,
             "ground_truth": t_gt}
        )
        v_hist, v_gt = seq[-21:-1], seq[-1]
        cand = _sample_candidates(rng, all_items, v_hist, v_gt, num_candidates)
        if cand is None:
            continue
        test.append(
            {"user_id": str(user), "history": v_hist, "candidate": cand,
             "ground_truth": v_gt}
        )
    return train, test


def train_test_split(
    samples: List[Dict], test_size: float = 0.2, seed: int = 42
) -> Tuple[List[Dict], List[Dict]]:
    """Deterministic shuffle split (reference uses sklearn train_test_split
    with random_state=42, process_rec_new_user.py:118)."""
    rng = _random.Random(seed)
    idx = list(range(len(samples)))
    rng.shuffle(idx)
    n_test = int(round(len(samples) * test_size))
    test_idx = set(idx[:n_test])
    train = [samples[i] for i in range(len(samples)) if i not in test_idx]
    test = [samples[i] for i in range(len(samples)) if i in test_idx]
    return train, test
