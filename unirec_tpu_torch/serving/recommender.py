"""Serving: user encoding plus full-catalog retrieval (port of
``unirec_tpu/serving/recommender.py``).

``Recommender`` encodes user histories with the joint model in fixed-shape
padded batches and ranks the whole catalog with ``ops/ranking.retrieve_top_k``
(kernel K2 on the card), or, with ``quantize_catalog=True``, over an int8
copy of the catalog (``ops/quantization``: ``quantize_rows`` once, then
``retrieve_top_k_int8``, kernel B11).  The field-embedding cache lives on
the device in bfloat16, as in the JAX package, so each batch uploads
``[B, H]`` row indices and ``[B]`` prompt lengths instead of gathered
embeddings and masks; ``device_field_cache=False`` keeps it on the host,
gathers each batch's history fields there in float32 and uploads them with
the ``[B, L]`` attention masks (the JAX ``_build_batch`` path).  Prompts come from ``serving/prompt_cache``, whose ids
equal ``tokenizer.encode(construct_input_text(...))``.

``precision="int8"`` runs the Qwen3 forward in W8A8 (``models/qwen3``:
``quantize_qwen3_weights``, kernel B8 per projection on the card);
``merge_lora=True`` folds the adapters into the base weights first, and then
``fused_blocks`` (default on for int8) routes q|k|v and the MLP through
kernels B9a and B9b.  As the JAX class clones its Flax module, the
recommender builds its own module over the caller's tensors
(``MultiModalQwenEmbedding.clone``): the caller's model, its weights and its
config are never changed.

``mesh`` (``parallel/mesh.make_mesh``) serves data-parallel in one process:
each distinct device of the mesh's dp axis holds a replica of the
parameters, the int8 weights, the catalog (or its codes and scales) and the
field cache; every batch of users splits into dp shards, each encoded (K1;
B8/B9a/B9b at int8) and ranked against the whole catalog (K2 or B11) on its
own device, with no collective, as the JAX class's ``shard_map``; the
shards are concatenated on the host.  ``batch_size`` must divide by dp.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import BaseTokenizer
from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding
from unirec_tpu_torch.models.qwen3 import quantize_qwen3_weights, set_qweights
from unirec_tpu_torch.ops.losses import l2_normalize
from unirec_tpu_torch.ops.quantization import quantize_rows, retrieve_top_k_int8
from unirec_tpu_torch.ops.ranking import retrieve_top_k
from unirec_tpu_torch.parallel.mesh import replicate
from unirec_tpu_torch.serving.prompt_cache import CachedPromptEncoder
from unirec_tpu_torch.utils.params import merged_model


@dataclasses.dataclass
class Recommendation:
    item_id: str
    score: float


@dataclasses.dataclass
class _Replica:
    """What one device of a (dp) recommender holds."""

    model: MultiModalQwenEmbedding
    device: torch.device
    catalog: Optional[torch.Tensor] = None  # float32 rows
    catalog_q: Tuple = (None, None)  # int8 codes, float32 scales
    cache_emb: Optional[torch.Tensor] = None  # bfloat16 field cache
    cache_mask: Optional[torch.Tensor] = None


class Recommender:
    """Joint-model recommender over a precomputed catalog, on the model's
    device."""

    def __init__(self, model: MultiModalQwenEmbedding,
                 tokenizer: BaseTokenizer, item_dict: Dict[str, Dict],
                 field_cache: FieldEmbeddingCache,
                 catalog_embeddings: Dict[str, Sequence[float]],
                 batch_size: int = 8, precision: str = "bf16",
                 quantize_catalog: bool = False, merge_lora: bool = False,
                 fused_blocks: Optional[bool] = None,
                 device_field_cache: bool = True, mesh=None):
        """``precision`` is "bf16" (the compute dtype is the model's own) or
        "int8" (W8A8 projections quantized from the weights as they are).
        ``merge_lora`` and ``fused_blocks`` take the JAX defaults: no merge,
        and the fused int8 blocks whenever precision is int8 and no adapter
        is live.  ``quantize_catalog`` keeps the catalog on the device as
        int8 rows with float32 scales and ranks over them (the JAX flag of
        the same name); ``score_candidates`` still reads the float32
        catalog.  ``device_field_cache`` (default on) keeps the field cache on
        the device; off, each batch's history fields are gathered on the
        host.  ``mesh``: serve over its dp devices (the class docstring)."""
        if precision not in ("bf16", "int8"):
            raise ValueError(f"precision must be bf16 or int8, got {precision!r}")
        self.dp_size = int(mesh.shape["dp"]) if mesh is not None else 1
        if batch_size % self.dp_size:
            raise ValueError(f"batch_size {batch_size} not divisible by dp "
                             f"mesh size {self.dp_size}")
        if merge_lora:
            model = merged_model(model)
        if fused_blocks is None:
            fused_blocks = precision == "int8"
        if precision == "int8":
            cfg = model.qwen_config
            if fused_blocks and model.lora is None:
                cfg = dataclasses.replace(cfg, fused_int8_inference=True)
            model = model.clone(qwen_config=cfg)  # the caller's stays as is
            qweights = quantize_qwen3_weights(model)
            set_qweights(model, qweights)
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
        self.device_cache = device_field_cache
        # one replica per distinct device of the dp axis (shards that share
        # a device share it); the model's own device keeps the model
        devices = ([torch.device(d) for d in mesh.dp_devices]
                   if mesh is not None else [self.device])
        replicas: Dict[torch.device, _Replica] = {}
        for dev in devices:
            if dev not in replicas:
                rep_model = self.model
                if dev != self.device:
                    rep_model = self.model.clone(replicate(
                        self.model.state_dict(), [dev])[dev]).eval()
                    if precision == "int8":
                        set_qweights(rep_model, qweights)
                replicas[dev] = self._replica(rep_model, dev)
        self._shards = [replicas[d] for d in devices]
        primary = self._shards[0]
        self._catalog_dev = primary.catalog
        self._catalog_q, self._catalog_scales = primary.catalog_q
        if device_field_cache:
            self._cache_emb_dev = primary.cache_emb
            self._cache_mask_dev = primary.cache_mask
        self._prompt = CachedPromptEncoder(tokenizer, item_dict,
                                           self.jc.num_history_items,
                                           self.jc.num_query_tokens_per_item)

    def _replica(self, model: MultiModalQwenEmbedding,
                 device: torch.device) -> "_Replica":
        """The model, the catalog (or its int8 codes and scales) and the
        field cache on ``device``."""
        catalog = torch.from_numpy(self.catalog).to(device)
        rep = _Replica(model, device)
        if self.quantized:
            rep.catalog_q = quantize_rows(catalog)
        else:
            rep.catalog = catalog
        if self.device_cache:
            # bfloat16 even for a float32 model (0.57 GB for 20k items x
            # 14 x 1024), upcast after the gather
            rep.cache_emb = torch.from_numpy(
                np.asarray(self.cache.embeddings, np.float32)).to(
                    device=device, dtype=torch.bfloat16)
            rep.cache_mask = torch.from_numpy(
                np.asarray(self.cache.masks, np.float32)).to(device)
        return rep

    def prewarm_prompts(self, item_ids=None, slots=None) -> int:
        """Tokenize prompt fragments ahead of traffic (prompt_cache)."""
        return self._prompt.prewarm(item_ids, slots)

    # -- user encoding -----------------------------------------------------

    def _build_batch(self, histories: Sequence[Sequence[str]]
                     ) -> Tuple[np.ndarray, ...]:
        """(input_ids [B, L], attention mask [B, L], history field
        embeddings [B, H, F, FD] float32, their masks [B, H, F]): the host
        gather of ``device_field_cache=False``."""
        jc = self.jc
        n = len(histories)
        f, fd = self.cache.num_fields, self.cache.embedding_dim
        input_ids = np.zeros((n, jc.max_length), np.int32)
        attn = np.zeros((n, jc.max_length), np.float32)
        hist_emb = np.zeros((n, jc.num_history_items, f, fd), np.float32)
        hist_mask = np.zeros((n, jc.num_history_items, f), np.float32)
        for i, history in enumerate(histories):
            history = [str(h) for h in history][-jc.num_history_items:]
            e, m = self.cache.gather(history)
            hist_emb[i, : len(history)] = e
            hist_mask[i, : len(history)] = m
            input_ids[i], attn[i] = self._prompt.encode(history, jc.max_length)
        return input_ids, attn, hist_emb, hist_mask

    @torch.no_grad()
    def _forward(self, ids: np.ndarray, attn: np.ndarray, he: np.ndarray,
                 hm: np.ndarray, rep: Optional["_Replica"] = None
                 ) -> torch.Tensor:
        """L2-normalised user embeddings [B, D] on the device of ``rep``
        (default: the first shard's), from host arrays."""
        rep = rep or self._shards[0]
        dev = rep.device
        ids_t, attn_t, he_t, hm_t = (torch.from_numpy(a).to(dev)
                                     for a in (ids, attn, he, hm))
        return l2_normalize(rep.model(ids_t.long(), attn_t, he_t, hm_t))

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
                      rows: np.ndarray, rep: Optional["_Replica"] = None
                      ) -> torch.Tensor:
        """L2-normalised user embeddings [B, D] on the device of ``rep``
        (default: the first shard's)."""
        rep = rep or self._shards[0]
        dev = rep.device
        ids_t = torch.from_numpy(ids).to(dev).long()
        lengths_t = torch.from_numpy(lengths).to(dev)
        rows_t = torch.from_numpy(rows).to(dev).long()
        mask = (torch.arange(ids.shape[1], device=dev)[None, :]
                < lengths_t[:, None]).float()
        valid = rows_t >= 0
        safe = rows_t.clamp_min(0)
        he = torch.where(valid[..., None, None],
                         rep.cache_emb[safe].float(), 0.0)
        hm = torch.where(valid[..., None], rep.cache_mask[safe], 0.0)
        return l2_normalize(rep.model(ids_t, mask, he, hm))

    # batches allowed on the device before the oldest is drained to the host
    # in a bulk ``encode_users`` call: host assembly overlaps device work,
    # and device memory stays bounded for any number of users
    MAX_IN_FLIGHT = 8

    def _encode_user_chunks(self, histories: Sequence[Sequence[str]],
                            to_host: bool = False) -> List[Tuple[object, int]]:
        """[(embedding chunk [batch_size, D], n_valid), ...]; every chunk is
        padded to the full batch with empty histories.  Under a dp mesh a
        chunk's embedding is a tuple of its dp shards' [batch_size / dp, D],
        each on its replica's device (all launched before any is read).

        ``to_host=False`` (the ``recommend`` path) keeps the chunks on the
        device for retrieval.  ``to_host=True`` (bulk ``encode_users``)
        copies each chunk to a float32 numpy array once ``MAX_IN_FLIGHT``
        newer ones are pending, so at most that many stay on the device."""
        out: List[Tuple[object, int]] = []
        pending: collections.deque = collections.deque()
        bs = self.batch_size
        per = bs // self.dp_size

        def drain(emb, n: int) -> None:
            parts = emb if isinstance(emb, tuple) else (emb,)
            out.append((np.concatenate([
                p.to("cpu", torch.float32, copy=True).numpy()
                for p in parts]), n))

        def encode(chunk, rep):
            if self.device_cache:
                return self._forward_rows(*self._build_batch_rows(chunk), rep)
            return self._forward(*self._build_batch(chunk), rep)

        for i in range(0, len(histories), bs):
            chunk = list(histories[i: i + bs])
            n = len(chunk)
            chunk += [[] for _ in range(bs - n)]
            if self.dp_size == 1:
                emb = encode(chunk, self._shards[0])
            else:
                emb = tuple(encode(chunk[j * per: (j + 1) * per], rep)
                            for j, rep in enumerate(self._shards))
            if not to_host:
                out.append((emb, n))
                continue
            pending.append((emb, n))
            del emb
            if len(pending) >= self.MAX_IN_FLIGHT:
                drain(*pending.popleft())
        while pending:
            drain(*pending.popleft())
        return out

    def encode_users(self, histories: Sequence[Sequence[str]]) -> np.ndarray:
        """[num_users, D] L2-normalised user embeddings (float32 numpy)."""
        chunks = self._encode_user_chunks(histories, to_host=True)
        return np.concatenate([emb[:n] for emb, n in chunks], axis=0)

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
        found = []  # per dp shard: its users of every chunk, on its device
        for j, rep in enumerate(self._shards):
            users = torch.cat([emb[j] if isinstance(emb, tuple) else emb
                               for emb, _ in chunks], dim=0).float()
            if self.quantized:
                found.append(retrieve_top_k_int8(users, *rep.catalog_q,
                                                 k=fetch))
            else:
                found.append(retrieve_top_k(users, rep.catalog, k=fetch))
        return (found, [n for _, n in chunks], histories, k, exclude_history)

    def recommend_finalize(self, handle) -> List[List[Recommendation]]:
        """Fetch the [users, fetch] scores and ids and build the results
        (dp shards back in their chunks' row order)."""
        found, counts, histories, k, exclude_history = handle

        def rows(t: List[np.ndarray]) -> np.ndarray:
            # [dp][chunks * per, fetch] -> [chunks * batch_size, fetch]
            a = np.stack(t).reshape(self.dp_size, len(counts), -1,
                                    t[0].shape[-1])
            return a.transpose(1, 0, 2, 3).reshape(-1, t[0].shape[-1])

        s = rows([f[0].cpu().numpy() for f in found])
        ix = rows([f[1].cpu().numpy() for f in found])
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
