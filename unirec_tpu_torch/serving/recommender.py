"""Serving: user encoding plus full-catalog retrieval (port of
``unirec_tpu/serving/recommender.py``, single device).

``Recommender`` encodes user histories with the joint model in fixed-shape
padded batches and ranks the whole catalog with ``ops/ranking.retrieve_top_k``
(kernel K2 on the card), or, with ``quantize_catalog=True``, over an int8
copy of the catalog (``ops/quantization``: ``quantize_rows`` once, then
``retrieve_top_k_int8``, kernel B11).  The field-embedding cache lives on
the device in bfloat16, as in the JAX package, so each batch uploads
``[B, H]`` row indices and ``[B]`` prompt lengths instead of gathered
embeddings and masks.  Prompts come from ``serving/prompt_cache``, whose ids
equal ``tokenizer.encode(construct_input_text(...))``.

``precision="int8"`` runs the Qwen3 forward in W8A8 (``models/qwen3``:
``quantize_qwen3_weights``, kernel B8 per projection on the card);
``merge_lora=True`` folds the adapters into the base weights first, and then
``fused_blocks`` (default on for int8) routes q|k|v and the MLP through
kernels B9a and B9b.  As the JAX class clones its Flax module, the
recommender builds its own module over the caller's tensors
(``MultiModalQwenEmbedding.clone``): the caller's model, its weights and its
config are never changed.  Meshes wait (A9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unirec_tpu.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import BaseTokenizer
from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding
from unirec_tpu_torch.models.qwen3 import quantize_qwen3_weights, set_qweights
from unirec_tpu_torch.ops.losses import l2_normalize
from unirec_tpu_torch.ops.quantization import quantize_rows, retrieve_top_k_int8
from unirec_tpu_torch.ops.ranking import retrieve_top_k
from unirec_tpu_torch.serving.prompt_cache import CachedPromptEncoder
from unirec_tpu_torch.utils.params import merged_model


@dataclasses.dataclass
class Recommendation:
    item_id: str
    score: float


class Recommender:
    """Joint-model recommender over a precomputed catalog, on the model's
    device."""

    def __init__(self, model: MultiModalQwenEmbedding,
                 tokenizer: BaseTokenizer, item_dict: Dict[str, Dict],
                 field_cache: FieldEmbeddingCache,
                 catalog_embeddings: Dict[str, Sequence[float]],
                 batch_size: int = 8, precision: str = "bf16",
                 quantize_catalog: bool = False, merge_lora: bool = False,
                 fused_blocks: Optional[bool] = None):
        """``precision`` is "bf16" (the compute dtype is the model's own) or
        "int8" (W8A8 projections quantized from the weights as they are).
        ``merge_lora`` and ``fused_blocks`` take the JAX defaults: no merge,
        and the fused int8 blocks whenever precision is int8 and no adapter
        is live.  ``quantize_catalog`` keeps the catalog on the device as
        int8 rows with float32 scales and ranks over them (the JAX flag of
        the same name); ``score_candidates`` still reads the float32
        catalog."""
        if precision not in ("bf16", "int8"):
            raise ValueError(f"precision must be bf16 or int8, got {precision!r}")
        if merge_lora:
            model = merged_model(model)
        if fused_blocks is None:
            fused_blocks = precision == "int8"
        if precision == "int8":
            cfg = model.qwen_config
            if fused_blocks and model.lora is None:
                cfg = dataclasses.replace(cfg, fused_int8_inference=True)
            model = model.clone(qwen_config=cfg)  # the caller's stays as is
            set_qweights(model, quantize_qwen3_weights(model))
        self.precision = precision
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.item_dict = item_dict
        self.cache = field_cache
        self.batch_size = batch_size
        self.jc = model.joint_config

        self.catalog_ids: List[str] = list(catalog_embeddings)
        self.catalog = np.asarray(
            [catalog_embeddings[i] for i in self.catalog_ids], np.float32)
        self.quantized = quantize_catalog
        catalog_dev = torch.from_numpy(self.catalog).to(self.device)
        if quantize_catalog:
            self._catalog_q, self._catalog_scales = quantize_rows(catalog_dev)
            self._catalog_dev = None
        else:
            self._catalog_dev = catalog_dev
        # device-resident field cache, bfloat16 even for a float32 model
        # (0.57 GB for 20k items x 14 x 1024), upcast after the gather
        self._cache_emb_dev = torch.from_numpy(
            np.asarray(field_cache.embeddings, np.float32)).to(
                device=self.device, dtype=torch.bfloat16)
        self._cache_mask_dev = torch.from_numpy(
            np.asarray(field_cache.masks, np.float32)).to(self.device)
        self._prompt = CachedPromptEncoder(tokenizer, item_dict,
                                           self.jc.num_history_items,
                                           self.jc.num_query_tokens_per_item)

    def prewarm_prompts(self, item_ids=None, slots=None) -> int:
        """Tokenize prompt fragments ahead of traffic (prompt_cache)."""
        return self._prompt.prewarm(item_ids, slots)

    # -- user encoding -----------------------------------------------------

    def _build_batch_rows(self, histories: Sequence[Sequence[str]]
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(input_ids [B, L], prompt lengths [B], cache rows [B, H])."""
        jc = self.jc
        n = len(histories)
        input_ids = np.zeros((n, jc.max_length), np.int32)
        lengths = np.zeros((n,), np.int32)
        rows = np.full((n, jc.num_history_items), -1, np.int32)
        for i, history in enumerate(histories):
            history = [str(h) for h in history][-jc.num_history_items:]
            rows[i, : len(history)] = self.cache.rows_for(history)
            input_ids[i], lengths[i] = self._prompt.encode_ids(history,
                                                               jc.max_length)
        return input_ids, lengths, rows

    @torch.no_grad()
    def _forward_rows(self, ids: np.ndarray, lengths: np.ndarray,
                      rows: np.ndarray) -> torch.Tensor:
        """L2-normalised user embeddings [B, D] on the device."""
        dev = self.device
        ids_t = torch.from_numpy(ids).to(dev).long()
        lengths_t = torch.from_numpy(lengths).to(dev)
        rows_t = torch.from_numpy(rows).to(dev).long()
        mask = (torch.arange(ids.shape[1], device=dev)[None, :]
                < lengths_t[:, None]).float()
        valid = rows_t >= 0
        safe = rows_t.clamp_min(0)
        he = torch.where(valid[..., None, None],
                         self._cache_emb_dev[safe].float(), 0.0)
        hm = torch.where(valid[..., None], self._cache_mask_dev[safe], 0.0)
        return l2_normalize(self.model(ids_t, mask, he, hm))

    def _encode_user_chunks(self, histories: Sequence[Sequence[str]]
                            ) -> List[Tuple[torch.Tensor, int]]:
        """[(embedding chunk [batch_size, D] on the device, n_valid), ...];
        every chunk is padded to the full batch with empty histories."""
        out = []
        bs = self.batch_size
        for i in range(0, len(histories), bs):
            chunk = list(histories[i: i + bs])
            n = len(chunk)
            chunk += [[] for _ in range(bs - n)]
            out.append((self._forward_rows(*self._build_batch_rows(chunk)), n))
        return out

    def encode_users(self, histories: Sequence[Sequence[str]]) -> np.ndarray:
        """[num_users, D] L2-normalised user embeddings (float32 numpy)."""
        chunks = self._encode_user_chunks(histories)
        return np.concatenate(
            [emb[:n].float().cpu().numpy() for emb, n in chunks], axis=0)

    # -- ranking -----------------------------------------------------------

    def recommend(self, histories: Sequence[Sequence[str]], k: int = 10,
                  exclude_history: bool = True) -> List[List[Recommendation]]:
        """Top-k catalog items per user, history items excluded."""
        return self.recommend_finalize(
            self.recommend_submit(histories, k, exclude_history))

    def recommend_submit(self, histories: Sequence[Sequence[str]],
                         k: int = 10, exclude_history: bool = True):
        """Host assembly and device work for ``recommend``; returns a handle
        for ``recommend_finalize``.  Retrieval fetches ``k`` plus the history
        length so excluded items still leave ``k`` answers."""
        chunks = self._encode_user_chunks(histories)
        fetch = k + (self.jc.num_history_items if exclude_history else 0)
        users = torch.cat([emb for emb, _ in chunks], dim=0).float()
        if self.quantized:
            s, ix = retrieve_top_k_int8(users, self._catalog_q,
                                        self._catalog_scales, k=fetch)
        else:
            s, ix = retrieve_top_k(users, self._catalog_dev, k=fetch)
        return (s, ix, [n for _, n in chunks], histories, k, exclude_history)

    def recommend_finalize(self, handle) -> List[List[Recommendation]]:
        """Fetch the [users, fetch] scores and ids and build the results."""
        s, ix, counts, histories, k, exclude_history = handle
        s, ix = s.cpu().numpy(), ix.cpu().numpy()
        keep = np.concatenate(
            [np.arange(i * self.batch_size, i * self.batch_size + n)
             for i, n in enumerate(counts)])
        scores, idx = s[keep], ix[keep]
        results: List[List[Recommendation]] = []
        for u, history in enumerate(histories):
            seen = set(map(str, history)) if exclude_history else set()
            recs: List[Recommendation] = []
            for score, j in zip(scores[u], idx[u]):
                iid = self.catalog_ids[int(j)]
                if iid in seen:
                    continue
                recs.append(Recommendation(iid, float(score)))
                if len(recs) == k:
                    break
            results.append(recs)
        return results

    def score_candidates(self, history: Sequence[str],
                         candidate_ids: Sequence[str]
                         ) -> List[Tuple[str, float]]:
        """Rank an explicit candidate pool by cosine similarity."""
        user = self.encode_users([history])[0]
        index = {iid: i for i, iid in enumerate(self.catalog_ids)}
        cand = np.asarray([
            self.catalog[index[c]] if c in index
            else np.zeros(self.catalog.shape[1], np.float32)
            for c in map(str, candidate_ids)
        ])
        norms = np.maximum(np.linalg.norm(cand, axis=1, keepdims=True), 1e-12)
        sims = (cand / norms) @ user
        order = np.argsort(-sims)
        return [(str(candidate_ids[i]), float(sims[i])) for i in order]
