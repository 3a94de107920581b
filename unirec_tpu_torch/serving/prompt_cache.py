"""Cached prompt-token assembly for serving (port of
``unirec_tpu/serving/prompt_cache.py``; it imports nothing of JAX).

The joint prompt (``models/joint.construct_input_text``) is a fixed template
whose only variable parts are per-(slot, item) title fragments, and the
reserved history special tokens are hard segmentation boundaries for the
tokenizer, so the ids of each fragment between special tokens do not depend
on their position and can be cached.  ``CachedPromptEncoder`` assembles
full fixed-length rows from:

* a per-(slot, item id) dict of title-fragment ids,
* precomputed constant fragments (prompt head, ", " separators, the gap
  between a slot's special tokens, sequence affixes),
* the tokenizer's special-token id table.

On construction it checks itself against the tokenizer's full-text path on
representative prompts and falls back to full-text encoding on any
mismatch, so the cache can never change what is served.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from unirec_tpu_torch.data.tokenizer import BaseTokenizer
from unirec_tpu_torch.models.joint import construct_input_text

_HEAD = "I have bought these items in the past: "


def _truncate_title(title: str) -> str:
    return title[:77] + "..." if len(title) > 80 else title


class CachedPromptEncoder:
    """Fragment-cached ``tokenizer.encode(construct_input_text(...))``."""

    def __init__(self, tokenizer: BaseTokenizer, item_dict: Dict[str, dict],
                 num_history_items: int = 10,
                 num_query_tokens_per_item: int = 2, verify: bool = True):
        self.tok = tokenizer
        self.item_dict = item_dict
        self.n_hist = num_history_items
        self.n_q = num_query_tokens_per_item
        self.special_ids = [
            [tokenizer.special_to_id[f"<|history_item_{i}_query_{j}|>"]
             for j in range(self.n_q)]
            for i in range(self.n_hist)
        ]
        self.prefix, self.suffix = tokenizer.affix_ids()
        self.head_absent = tokenizer.encode_plain(_HEAD)
        self.mid_absent = tokenizer.encode_plain(", ")
        self.gap = tokenizer.encode_plain(" ") if self.n_q > 1 else []
        self._frag_cache: Dict[Tuple[int, str], List[int]] = {}
        self.enabled = True
        if verify:
            self.enabled = self._self_check()

    # -- fragments -----------------------------------------------------------

    def _fragment_text(self, slot: int, item_id: str) -> str:
        title = _truncate_title(
            self.item_dict.get(item_id, {}).get("title", f"Item {item_id}"))
        return f"{_HEAD}1. {title} " if slot == 0 else f", {slot + 1}. {title} "

    def _fragment(self, slot: int, item_id: str) -> List[int]:
        key = (slot, item_id)
        ids = self._frag_cache.get(key)
        if ids is None:
            ids = self.tok.encode_plain(self._fragment_text(slot, item_id))
            self._frag_cache[key] = ids
        return ids

    def _assemble(self, history: Sequence[str]) -> List[int]:
        history = [str(h) for h in history][-self.n_hist:]
        ids: List[int] = list(self.prefix)
        for i in range(self.n_hist):
            if i < len(history):
                ids += self._fragment(i, history[i])
            elif i == 0:
                ids += self.head_absent
            else:
                ids += self.mid_absent
            specials = self.special_ids[i]
            ids.append(specials[0])
            for j in range(1, self.n_q):
                ids += self.gap
                ids.append(specials[j])
        ids += self.suffix
        return ids

    def prewarm(self, item_ids=None, slots=None) -> int:
        """Tokenize fragments ahead of traffic in one batch call; defaults
        to every item of the item dict in every slot.  Returns the number of
        fragments added."""
        if not self.enabled:
            return 0
        ids = list(item_ids) if item_ids is not None else list(self.item_dict)
        slot_list = list(slots) if slots is not None else range(self.n_hist)
        keys = [(slot, str(iid)) for slot in slot_list for iid in ids
                if (slot, str(iid)) not in self._frag_cache]
        texts = [self._fragment_text(slot, iid) for slot, iid in keys]
        if texts:
            for key, frag in zip(keys, self.tok.encode_plain_batch(texts)):
                self._frag_cache[key] = list(frag)
        return len(texts)

    # -- public API ----------------------------------------------------------

    def encode(self, history: Sequence[str], max_length: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, mask) of one history, ``max_length`` long; a history longer
        than ``num_history_items`` keeps its last items."""
        ids, length = self.encode_ids(history, max_length)
        mask = np.zeros(max_length, np.float32)
        mask[:length] = 1.0
        return ids, mask

    def encode_ids(self, history: Sequence[str], max_length: int
                   ) -> Tuple[np.ndarray, int]:
        """(ids row, valid length): the mask is always a prefix mask."""
        if not self.enabled:
            text = construct_input_text(
                [str(h) for h in history][-self.n_hist:], self.item_dict,
                self.n_hist, self.n_q)
            ids, mask = self.tok.encode(text, max_length)
            return ids, int(np.asarray(mask).sum())
        ids = self._assemble(history)[:max_length]
        out = np.full(max_length, self.tok.pad_id, np.int32)
        out[: len(ids)] = ids
        return out, len(ids)

    # -- verification ---------------------------------------------------------

    def _self_check(self) -> bool:
        """Assembled ids must equal the full-text path on full, partial and
        empty histories, over the first items of the dict and synthetic
        titles (the 77-character truncation, punctuation and whitespace next
        to a special token, non-ASCII text); a mismatch disables the
        cache."""
        sample_ids = list(self.item_dict)[:3]
        synthetic = {
            "__selfcheck_long__": {
                "title": "Ultra Hydrating Vitamin-C Brightening Facial "
                "Serum with Hyaluronic Acid, Niacinamide and Botanical "
                "Extracts, 2 Fl Oz"},
            "__selfcheck_punct__": {"title": "Lip balm (cherry), tube.  "},
            "__selfcheck_unicode__": {"title": "Crème brûlée café — 10 µl"},
        }
        self.item_dict.update(synthetic)
        try:
            cases = [[], sample_ids[:1], sample_ids, list(synthetic),
                     sample_ids[:1] + list(synthetic)]
            return self._run_check_cases(cases)
        finally:
            for key in synthetic:
                self.item_dict.pop(key, None)
            self._frag_cache = {k: v for k, v in self._frag_cache.items()
                                if k[1] not in synthetic}

    def _run_check_cases(self, cases: List[List[str]]) -> bool:
        for history in cases:
            history = history[-self.n_hist:]
            text = construct_input_text(history, self.item_dict, self.n_hist,
                                        self.n_q)
            if list(self.tok._encode_text(text)) != list(
                    self._assemble(history)):
                self._frag_cache.clear()
                return False
        return True
