"""Tokenizers for the joint model (port of ``unirec_tpu/data/tokenizer.py``).

Framework-free copy of ``BaseTokenizer`` and the md5 ``HashTokenizer``: the
JAX module imports its ``history_token_strings`` from a module that pulls in
JAX.  Both produce fixed-length right-padded ids and a prefix mask, and the
reserved history special tokens resolve to ids ``>= base_vocab_size``.  The
Hugging Face tokenizer waits: it needs tokenizer files.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Tuple

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

    def _encode_text(self, text: str) -> List[int]:  # pragma: no cover
        raise NotImplementedError

    def encode(self, text: str,
               max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [max_length] int32, mask [max_length] float32), right padded."""
        ids = self._encode_text(text)[:max_length]
        mask = np.zeros(max_length, np.float32)
        mask[: len(ids)] = 1.0
        out = np.full(max_length, self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out, mask


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
