"""Tokenizers for the joint model (port of ``unirec_tpu/data/tokenizer.py``).

Framework-free copy of ``BaseTokenizer``, the md5 ``HashTokenizer``, the
Hugging Face ``HFTokenizer`` and ``make_tokenizer``: the JAX module imports
its ``history_token_strings`` from a module that pulls in JAX.  All produce
fixed-length right-padded ids and a prefix mask, and the reserved history
special tokens resolve to ids ``>= base_vocab_size``.  ``encode_plain``,
``encode_plain_batch`` and ``affix_ids`` are what ``serving/prompt_cache.py``
assembles prompts from.  ``transformers`` is imported only when an
``HFTokenizer`` is made.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from unirec_tpu_torch.models.joint import history_token_strings

_WORD_RE = re.compile(r"<\|history_item_\d+_query_\d+\|>|\S+")


class BaseTokenizer:
    """Fixed-shape batch encoding with reserved history special tokens."""

    def __init__(self, base_vocab_size: int, num_history_items: int = 10,
                 num_query_tokens_per_item: int = 2, pad_id: int = 0):
        self.base_vocab_size = base_vocab_size
        self.pad_id = pad_id
        self.special_tokens = history_token_strings(num_history_items,
                                                    num_query_tokens_per_item)
        self.special_to_id = {
            tok: base_vocab_size + i for i, tok in enumerate(self.special_tokens)
        }

    @property
    def vocab_size(self) -> int:
        return self.base_vocab_size + len(self.special_tokens)

    def _encode_text(self, text: str) -> List[int]:  # pragma: no cover
        raise NotImplementedError

    def encode_plain(self, text: str) -> List[int]:
        """Ids of a text fragment: no sequence affixes and no special tokens
        inside (the prompt cache's unit)."""
        return self._encode_text(text)

    def encode_plain_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.encode_plain(t) for t in texts]

    def affix_ids(self) -> Tuple[List[int], List[int]]:
        """(prefix, suffix) ids the tokenizer adds around a full sequence."""
        return [], []

    def encode(self, text: str,
               max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [max_length] int32, mask [max_length] float32), right padded."""
        ids = self._encode_text(text)[:max_length]
        mask = np.zeros(max_length, np.float32)
        mask[: len(ids)] = 1.0
        out = np.full(max_length, self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out, mask

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        ids, masks = zip(*(self.encode(t, max_length) for t in texts))
        return np.stack(ids), np.stack(masks)


class HashTokenizer(BaseTokenizer):
    """Deterministic word-hash tokenizer (no vocabulary files needed)."""

    def _encode_text(self, text: str) -> List[int]:
        ids = []
        for tok in _WORD_RE.findall(text):
            if tok in self.special_to_id:
                ids.append(self.special_to_id[tok])
            else:
                h = int(hashlib.md5(tok.lower().encode()).hexdigest(), 16)
                ids.append(1 + h % (self.base_vocab_size - 1))  # never pad 0
        return ids


class HFTokenizer(BaseTokenizer):
    """Wraps a local HF tokenizer; adds the history special tokens exactly as
    the reference does (train_item_individual_token_joint.py:117-119)."""

    def __init__(self, name_or_path: str, num_history_items: int = 10,
                 num_query_tokens_per_item: int = 2):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(name_or_path)
        base_vocab = len(self.tok)
        super().__init__(base_vocab, num_history_items,
                         num_query_tokens_per_item,
                         pad_id=self.tok.pad_token_id or 0)
        self.tok.add_special_tokens(
            {"additional_special_tokens": self.special_tokens})
        # HF assigns added ids sequentially from base_vocab: the same contract
        self.special_to_id = {
            t: self.tok.convert_tokens_to_ids(t) for t in self.special_tokens}

    def _encode_text(self, text: str) -> List[int]:
        return self.tok(text, add_special_tokens=True)["input_ids"]

    def encode_plain(self, text: str) -> List[int]:
        return self.tok(text, add_special_tokens=False)["input_ids"]

    def encode_plain_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return self.tok(list(texts), add_special_tokens=False)["input_ids"]

    def affix_ids(self) -> Tuple[List[int], List[int]]:
        """Sequence affixes from the tokenizer's own template: ids added
        around an empty input (Qwen adds none; BERT-style adds CLS/SEP)."""
        ids = self.tok("", add_special_tokens=True)["input_ids"]
        if not ids:
            return [], []
        # everything a bare encode emits is affix; a one-token probe locates
        # the boundary between prefix and suffix
        probe = self.tok("a", add_special_tokens=False)["input_ids"]
        full = self.tok("a", add_special_tokens=True)["input_ids"]
        for start in range(len(full) - len(probe) + 1):
            if full[start: start + len(probe)] == probe:
                return full[:start], full[start + len(probe):]
        return ids, []  # fallback: treat everything as prefix


def make_tokenizer(name_or_path: Optional[str] = None,
                   base_vocab_size: int = 151669,
                   num_history_items: int = 10,
                   num_query_tokens_per_item: int = 2) -> BaseTokenizer:
    """The HF tokenizer when a path is given, the hash tokenizer otherwise.

    A path that fails to load (no tokenizer there, or no ``transformers``)
    raises instead of degrading to hash tokens, which would silently change
    every prompt."""
    if name_or_path:
        try:
            return HFTokenizer(name_or_path, num_history_items,
                               num_query_tokens_per_item)
        except Exception as e:  # noqa: BLE001  re-raised with the path
            raise ValueError(
                f"failed to load HF tokenizer from {name_or_path!r}; "
                "pass name_or_path=None to use the hash tokenizer explicitly"
            ) from e
    return HashTokenizer(base_vocab_size, num_history_items,
                         num_query_tokens_per_item)
