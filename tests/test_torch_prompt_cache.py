"""Port parity: the serving prompt cache and the tokenizer helpers it reads,
unirec_tpu_torch vs unirec_tpu on the CPU.  Ids must be identical (integers:
no tolerance)."""

import numpy as np
import pytest

from unirec_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from unirec_tpu.models.joint import construct_input_text as jax_prompt
from unirec_tpu.serving.prompt_cache import (
    CachedPromptEncoder as JaxCachedPromptEncoder,
)
from unirec_tpu_torch.data.tokenizer import HashTokenizer, make_tokenizer
from unirec_tpu_torch.models.joint import construct_input_text
from unirec_tpu_torch.serving.prompt_cache import CachedPromptEncoder

ITEMS = {
    "a1": {"title": "Hydrating Face Cream"},
    "a2": {"title": "x" * 200},  # the 80-character truncation
    "a3": {"title": "Mascara, waterproof (black) <brackets>"},
    "a4": {},  # no title: "Item a4"
    "a5": {"title": "Crème brûlée — 10 µl"},
}
N_HIST, N_Q = 4, 2
HISTORIES = [[], ["a1"], ["a1", "a2"], ["a1", "a2", "a3", "a4"],
             ["a2", "a2", "a2", "a2"], ["zz-unknown", "a5"],
             ["a1", "a2", "a3", "a4", "a5", "a3"]]  # the last: > N_HIST


class Broken(HashTokenizer):
    """Fragments do not compose (whitespace dropped): the self-check must
    turn the cache off."""

    def encode_plain(self, text):
        return super().encode_plain(text.replace(" ", ""))


def _full_text(tok, history, max_length):
    text = construct_input_text([str(h) for h in history][-N_HIST:], ITEMS,
                                N_HIST, N_Q)
    return tok.encode(text, max_length)


@pytest.mark.parametrize("max_length", [12, 64])
def test_ids_equal_full_text_and_jax(max_length):
    tok = HashTokenizer(1000, N_HIST, N_Q)
    jtok = JaxHashTokenizer(1000, N_HIST, N_Q)
    enc = CachedPromptEncoder(tok, dict(ITEMS), N_HIST, N_Q)
    jenc = JaxCachedPromptEncoder(jtok, dict(ITEMS), N_HIST, N_Q)
    assert enc.enabled and jenc.enabled
    for history in HISTORIES:
        ids, mask = enc.encode(history, max_length)
        want_ids, want_mask = _full_text(tok, history, max_length)
        np.testing.assert_array_equal(ids, want_ids, err_msg=str(history))
        np.testing.assert_array_equal(mask, want_mask)
        j_ids, j_len = jenc.encode_ids(history, max_length)
        p_ids, p_len = enc.encode_ids(history, max_length)
        np.testing.assert_array_equal(p_ids, j_ids)
        assert p_len == j_len == int(want_mask.sum())
        h = history[-N_HIST:]
        np.testing.assert_array_equal(
            tok.encode(construct_input_text(h, ITEMS, N_HIST, N_Q),
                       max_length)[0],
            jtok.encode(jax_prompt(h, ITEMS, N_HIST, N_Q), max_length)[0])


def test_self_check_turns_a_broken_cache_off():
    tok = Broken(1000, N_HIST, N_Q)
    enc = CachedPromptEncoder(tok, dict(ITEMS), N_HIST, N_Q)
    assert not enc.enabled and enc.prewarm() == 0
    for history in HISTORIES:  # the full-text path, last N_HIST items
        np.testing.assert_array_equal(enc.encode(history, 48)[0],
                                      _full_text(tok, history, 48)[0])


def test_prewarm_fills_the_cache(monkeypatch):
    tok = HashTokenizer(1000, N_HIST, N_Q)
    items = dict(ITEMS)
    enc = CachedPromptEncoder(tok, items, N_HIST, N_Q)
    assert set(items) == set(ITEMS)  # the self-check's items are gone
    n = enc.prewarm()
    assert 0 < n <= N_HIST * len(ITEMS)
    assert len(enc._frag_cache) == N_HIST * len(ITEMS)
    assert enc.prewarm() == 0
    want = _full_text(tok, ["a1", "a3", "a4"], 48)[0]
    calls = []
    monkeypatch.setattr(tok, "encode_plain",
                        lambda text: calls.append(text) or [1])
    np.testing.assert_array_equal(enc.encode(["a1", "a3", "a4"], 48)[0], want)
    assert calls == []


def test_tokenizer_helpers_match_jax():
    tok = make_tokenizer(None, 1000, N_HIST, N_Q)
    jtok = JaxHashTokenizer(1000, N_HIST, N_Q)
    assert isinstance(tok, HashTokenizer)
    assert tok.vocab_size == jtok.vocab_size == 1000 + N_HIST * N_Q
    assert tok.special_to_id == jtok.special_to_id
    assert tok.affix_ids() == jtok.affix_ids() == ([], [])
    texts = ["1. Face cream ", ", 2. Lip balm (cherry) "]
    assert tok.encode_plain_batch(texts) == jtok.encode_plain_batch(texts)
    ids, masks = tok.encode_batch(texts, 8)
    j_ids, j_masks = jtok.encode_batch(texts, 8)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(masks, j_masks)
    # a path loads the Hugging Face tokenizer; one that holds none raises
    # (as the JAX make_tokenizer does) rather than falling back to hashing
    with pytest.raises(ValueError, match="tokenizer"):
        make_tokenizer("/nonexistent/tokenizer")
