"""KV-cached decoding for ``QFormerLMHeadModel`` (port of
``unirec_tpu/models/qformer_decode.py``).

``greedy_generate`` (``models/qformer.py``) re-runs the full forward every
step: O(T^2).  This is the O(T) form, over the model's own modules:

* the query prefix attends only within itself (the UniLM mask) and never to
  text, so its hidden states and its per-layer K/V do not depend on the
  text: ``_prefill`` computes them once, with the cross-attention into the
  memory on cross layers and the query FFN;
* each text token self-attends over [prefix + generated so far], skips the
  cross-attention and runs the text FFN (``ffn``), so a step appends one K/V
  column per layer.

The cache has a fixed shape, ``[B, H, K + T, hd]`` per layer, and a step's
visible columns are masked by the step index.  The decode attention is the
JAX einsum path (fp32 scores and softmax), in plain torch
(``ops/attention.attention``); a cross-attention over a memory of
``FLASH_MIN_KV`` rows or more takes B13 on the card, as the module does.
Greedy ids equal ``greedy_generate``'s token for token (fp32);
``kv_cached_beam_generate`` is the beam search, ``num_beams=1`` equal to
greedy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from unirec_tpu_torch.models.qformer import QFormerLMHeadModel
from unirec_tpu_torch.ops.attention import (
    NEG_INF,
    attention,
    make_additive_mask,
    merge_heads,
    split_heads,
)


def _qkv(att, h: torch.Tensor, heads: int):
    return (split_heads(att.query(h), heads), split_heads(att.key(h), heads),
            split_heads(att.value(h), heads))


def _finish(att, ctx: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """output dense, then LayerNorm(out + residual)."""
    return att.output_LayerNorm(att.output_dense(merge_heads(ctx)) + h)


def _prefill(model: QFormerLMHeadModel, query_embeds: torch.Tensor,
             encoder_hidden_states: Optional[torch.Tensor],
             encoder_attention_mask: Optional[torch.Tensor]
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The query prefix's forward; returns each layer's prefix K and V
    ``[B, H, K, hd]``.  The prefix self-attends within itself with no
    padding mask (queries are never masked)."""
    bert = model.bert
    heads = model.config.num_attention_heads
    h = bert.embeddings.LayerNorm(query_embeds.to(bert.embeddings.dtype))
    enc_bias = None
    if encoder_hidden_states is not None:
        if encoder_attention_mask is None:
            encoder_attention_mask = encoder_hidden_states.new_ones(
                encoder_hidden_states.shape[:2], dtype=torch.float32)
        enc_bias = make_additive_mask(encoder_attention_mask)
    ks, vs = [], []
    for layer in bert.encoder.layer:
        q, k, v = _qkv(layer.attention, h, heads)
        h = _finish(layer.attention, attention(q, k, v), h)
        ks.append(k)
        vs.append(v)
        if layer.crossattention is not None and encoder_hidden_states is not None:
            h = layer.crossattention(h, enc_bias,
                                     kv_states=encoder_hidden_states.to(h.dtype))
        h = layer.ffn_query(h)
    return ks, vs


def _caches(ks, vs, max_new_tokens: int, repeat: int = 1):
    """Per-layer caches ``[B * repeat, H, K + T, hd]`` with the prefix in
    place (row b -> rows b * repeat .. b * repeat + repeat - 1)."""
    def grow(t):
        t = t.repeat_interleave(repeat, dim=0)
        b, h, _, hd = t.shape
        return torch.cat([t, t.new_zeros(b, h, max_new_tokens, hd)], dim=2)
    return [grow(k) for k in ks], [grow(v) for v in vs]


def _embed_token(model: QFormerLMHeadModel, tok: torch.Tensor,
                 t: int) -> torch.Tensor:
    """LayerNorm(word[tok] + position[t]) as ``[N, 1, D]``."""
    emb = model.bert.embeddings
    pos = torch.full_like(tok, t)
    return emb.LayerNorm(emb.word_embeddings(tok)[:, None]
                         + emb.position_embeddings(pos)[:, None])


def _decode_step(model: QFormerLMHeadModel, h: torch.Tensor, k_cache,
                 v_cache, bias: torch.Tensor, col: int) -> torch.Tensor:
    """One cached step for a ``[N, 1, D]`` token batch: writes column
    ``col`` of every layer's cache in place; returns the hidden state."""
    heads = model.config.num_attention_heads
    for layer, kc, vc in zip(model.bert.encoder.layer, k_cache, v_cache):
        q, k, v = _qkv(layer.attention, h, heads)
        kc[:, :, col] = k[:, :, 0]
        vc[:, :, col] = v[:, :, 0]
        h = _finish(layer.attention, attention(q, kc, vc, bias), h)
        h = layer.ffn(h)
    return h


def _visible(total: int, col: int, device) -> torch.Tensor:
    """The additive bias ``[1, 1, 1, K + T]`` of a step writing ``col``:
    the prefix and the text up to ``col`` visible."""
    cols = torch.arange(total, device=device)
    return torch.where(cols <= col, 0.0, NEG_INF)[None, None, None, :]


@torch.no_grad()
def kv_cached_greedy_generate(model: QFormerLMHeadModel,
                              query_embeds: torch.Tensor,
                              encoder_hidden_states: Optional[torch.Tensor] = None,
                              encoder_attention_mask: Optional[torch.Tensor] = None,
                              *, bos_token_id: int, eos_token_id: int,
                              pad_token_id: int = 0,
                              max_new_tokens: int = 32) -> torch.Tensor:
    """O(T) greedy decoding; ``[B, max_new_tokens]`` ids token for token
    equal to ``greedy_generate``'s."""
    b, n_q = query_embeds.shape[:2]
    device = query_embeds.device
    k_cache, v_cache = _caches(*_prefill(model, query_embeds,
                                         encoder_hidden_states,
                                         encoder_attention_mask),
                               max_new_tokens)
    ids = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.long,
                     device=device)
    ids[:, 0] = bos_token_id
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    for t in range(max_new_tokens - 1):
        h = _embed_token(model, ids[:, t], t)
        h = _decode_step(model, h, k_cache, v_cache,
                         _visible(n_q + max_new_tokens, n_q + t, device),
                         n_q + t)
        next_tok = model.cls(h)[:, 0].argmax(-1)
        next_tok = torch.where(finished, pad_token_id, next_tok)
        ids[:, t + 1] = next_tok
        finished |= next_tok == eos_token_id
    return ids


@torch.no_grad()
def kv_cached_beam_generate(model: QFormerLMHeadModel,
                            query_embeds: torch.Tensor,
                            encoder_hidden_states: Optional[torch.Tensor] = None,
                            encoder_attention_mask: Optional[torch.Tensor] = None,
                            *, bos_token_id: int, eos_token_id: int,
                            pad_token_id: int = 0, max_new_tokens: int = 32,
                            num_beams: int = 4, length_penalty: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached beam search.  Returns ``(ids [B, T], score [B])``: the best
    beam of each row under Hugging Face's length-penalised score ``log p /
    len ** length_penalty`` (len counts BOS and EOS).  Finished beams keep
    their score and emit pad; the cache is reordered by parent each step.
    Candidates are ranked by a stable descending sort, ties to the lower
    index as ``lax.top_k`` breaks them."""
    b, n_q = query_embeds.shape[:2]
    n = num_beams
    device = query_embeds.device
    k_cache, v_cache = _caches(*_prefill(model, query_embeds,
                                         encoder_hidden_states,
                                         encoder_attention_mask),
                               max_new_tokens, repeat=n)
    ids = torch.full((b, n, max_new_tokens), pad_token_id, dtype=torch.long,
                     device=device)
    ids[:, :, 0] = bos_token_id
    # only beam 0 is live at the start (every beam holds the same BOS)
    scores = torch.full((b, n), NEG_INF, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros(b, n, dtype=torch.bool, device=device)
    lengths = torch.full((b, n), max_new_tokens, dtype=torch.long,
                         device=device)
    vocab = model.config.vocab_size
    pad_row = torch.full((vocab,), NEG_INF, device=device)
    pad_row[pad_token_id] = 0.0
    offsets = (torch.arange(b, device=device) * n)[:, None]
    for t in range(max_new_tokens - 1):
        h = _embed_token(model, ids[:, :, t].reshape(b * n), t)
        h = _decode_step(model, h, k_cache, v_cache,
                         _visible(n_q + max_new_tokens, n_q + t, device),
                         n_q + t)
        logp = torch.log_softmax(model.cls(h)[:, 0].float(), dim=-1)
        logp = logp.reshape(b, n, vocab)
        logp = torch.where(finished[..., None], pad_row, logp)
        cand = (scores[..., None] + logp).reshape(b, n * vocab)
        top_scores, top_idx = torch.sort(cand, dim=-1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :n], top_idx[:, :n]
        parent, token = top_idx // vocab, top_idx % vocab
        ids = torch.gather(ids, 1, parent[..., None].expand(-1, -1,
                                                            max_new_tokens))
        finished = torch.gather(finished, 1, parent)
        lengths = torch.gather(lengths, 1, parent)
        rows = (offsets + parent).reshape(-1)
        k_cache = [c[rows] for c in k_cache]
        v_cache = [c[rows] for c in v_cache]
        token = torch.where(finished, pad_token_id, token)
        ids[:, :, t + 1] = token
        just = ~finished & (token == eos_token_id)
        lengths = torch.where(just, t + 2, lengths)
        finished |= just
        scores = top_scores
    final = scores / lengths.float() ** length_penalty
    best = final.argmax(dim=1)
    best_ids = ids[torch.arange(b, device=device), best]
    return best_ids, final[torch.arange(b, device=device), best]
