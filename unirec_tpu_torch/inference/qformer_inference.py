"""Batch item-query-token generation, the throughput-critical path (port of
``unirec_tpu/inference/qformer_inference.py``).

``QFormerInference`` turns cached field embeddings into an item's K query
tokens through the fused engine (``inference/fused_qformer.py``: kernels
B1-B3 on the card, or B4-B6 with ``precision="int8"``) or the plain
``ItemQFormer`` in bfloat16.  Null-value semantics mirror
process_item_for_inference
(reference: data_processing/qformer_inference.py:57-110): a field is masked
out when missing or a null-ish string, and a failed encode (a zero vector) is
masked as well.

Unlike the JAX class, batches are not padded to a fixed shape: that padding
existed to keep one jit-compiled shape, and eager PyTorch has none.  Outputs
do not depend on the batch's composition (each block works row by row or item
by item; ``tests/test_torch_qformer_inference.py`` holds a lone item to its
row of a batch).

``mesh`` (``parallel/mesh.make_mesh``) is the dp-sharded sweep: a replica
of the forward weights (or of the fused engine's packed weights) on each
distinct device of the mesh's dp axis, each batch split into dp shards,
every shard launched before any is read back, and the outputs concatenated
on the host.  ``batch_size`` must divide by dp; a smaller call is padded up
to a multiple of dp by repeating its last row, and the padded rows are
trimmed.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from unirec_tpu_torch.configs import ItemQFormerConfig
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.inference.fused_qformer import (
    fused_qformer_forward,
    prepare_fused_params,
    supports_fused,
)
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.parallel.mesh import pad_batch
from unirec_tpu_torch.utils.device import resolve_device

NULL_STRINGS = {
    "", "null", "NULL", "Null", "none", "NONE", "None", "nan", "NaN", "NAN",
}


def is_null_value(value) -> bool:
    """reference: data_processing/qformer_inference.py:74-79."""
    if value is None:
        return True
    if isinstance(value, str):
        return value.strip() in NULL_STRINGS
    return False


class QFormerInference:
    """Checkpointed Item Q-Former + batched forward on one device, or on
    the dp devices of ``mesh``.

    Interface expected by the batch CLI: ``device``,
    ``query_tokens_from_embeddings``, ``query_tokens_from_cache``,
    ``generate_query_tokens_by_id(item_id, data_path)`` and
    ``generate_query_tokens_batch_by_ids(item_ids, data_path)``.

    ``params`` is the port's ``ItemQFormer`` state_dict (float32 or any
    dtype; it is cast to bfloat16).  ``use_fused`` defaults to True on a CUDA
    device when ``supports_fused`` holds, and is decided here, once; the
    fused engine's packed weights are ``fused_params``.  ``precision="int8"``
    (W8A8 blocks) needs the fused engine: it raises ``ValueError`` when
    ``use_fused`` is False or ``supports_fused`` fails, and otherwise runs the
    fused engine on any device, as the JAX class does.
    """

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        device=None,
        *,
        config: Optional[ItemQFormerConfig] = None,
        params=None,
        field_names: Optional[List[str]] = None,
        item_encoder=None,
        batch_size: int = 512,
        mesh=None,
        use_fused: Optional[bool] = None,
        precision: str = "bf16",
    ):
        if precision not in ("bf16", "int8"):
            raise ValueError(f"precision must be bf16 or int8, got {precision!r}")
        if checkpoint_path is not None:
            config, params, field_names = self.read_checkpoint(checkpoint_path)
        if config is None or params is None or field_names is None:
            raise ValueError(
                "provide checkpoint_path or (config, params, field_names)")
        self.config = config
        self.field_names = list(field_names)
        self.item_encoder = item_encoder
        self.mesh = mesh
        if mesh is not None:
            self.dp_size = mesh.shape["dp"]
            if batch_size % self.dp_size:
                raise ValueError(f"batch_size {batch_size} not divisible by "
                                 f"mesh size {self.dp_size}")
            self.shard_devices = [resolve_device(d) for d in mesh.dp_devices]
            self.device = self.shard_devices[0]
        else:
            self.dp_size = 1
            self.device = resolve_device(device)
            self.shard_devices = [self.device]
        self.batch_size = batch_size
        self.precision = precision
        if precision == "int8":
            if use_fused is False or not supports_fused(config):
                raise ValueError(
                    "precision='int8' requires the fused kernel engine "
                    "(supports_fused must hold and use_fused must not be False)")
            use_fused = True
        if use_fused is None:
            use_fused = self.device.type == "cuda"
        self.use_fused = bool(use_fused) and supports_fused(config)
        # one replica of the weights per distinct device (replicas that
        # share a device share it)
        self._replicas: Dict[torch.device, object] = {}
        for dev in self.shard_devices:
            if dev in self._replicas:
                continue
            if self.use_fused:
                self._replicas[dev] = prepare_fused_params(
                    params, config, dtype=torch.bfloat16, precision=precision,
                    device=dev)
            else:
                model = ItemQFormer(config, device=dev,
                                    dtype=torch.bfloat16).eval()
                model.load_state_dict(params)
                self._replicas[dev] = model
        primary = self._replicas[self.device]
        self.fused_params = primary if self.use_fused else None
        self.model = None if self.use_fused else primary
        self._data_cache: Dict[str, Dict] = {}

    @staticmethod
    def read_checkpoint(path: str):
        """(config, ``ItemQFormer`` state_dict, field names) of a checkpoint
        directory of ``utils/checkpoint.py`` or a reference ``.pth``
        (converted through ``utils/torch_convert``)."""
        if os.path.isdir(path):
            from unirec_tpu_torch.utils.checkpoint import (
                load_checkpoint,
                restore_config,
            )

            sd, meta = load_checkpoint(path)
            return (restore_config(meta, ItemQFormerConfig), sd,
                    meta.get("field_names"))
        from unirec_tpu_torch.utils.torch_convert import (
            load_reference_item_qformer_checkpoint,
        )
        from unirec_tpu_torch.utils.weights import (
            item_qformer_state_dict_from_flax,
        )

        cfg, tree, field_names = load_reference_item_qformer_checkpoint(path)
        return cfg, item_qformer_state_dict_from_flax(tree), field_names

    # ------------------------------------------------------------------
    # Core batched path: cached field embeddings -> query tokens
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward(self, field_embeddings: torch.Tensor,
                masks: torch.Tensor, device=None) -> torch.Tensor:
        """One batch on ``device`` (default: the first): [B, F, D] + [B, F]
        -> [B, K, hidden] bfloat16 tokens, left on the device."""
        device = self.device if device is None else torch.device(device)
        emb = field_embeddings.to(device)
        mask = masks.to(device, torch.float32)
        replica = self._replicas[device]
        if self.use_fused:
            return fused_qformer_forward(replica, self.config, emb, mask)
        return replica.query_outputs(emb, mask)

    def _forward_to_host(self, emb: np.ndarray, mask: np.ndarray
                         ) -> np.ndarray:
        """One chunk -> float32 tokens on the host: whole on one device, or
        padded to a multiple of dp, split into dp shards, every shard
        launched before any is read back, then trimmed."""
        if self.mesh is None:
            return self.forward(torch.from_numpy(emb),
                                torch.from_numpy(mask)).float().cpu().numpy()
        padded, n = pad_batch({"emb": emb, "mask": mask}, self.dp_size)
        per = padded["emb"].shape[0] // self.dp_size
        outs = [self.forward(torch.from_numpy(padded["emb"][j * per:
                                                            (j + 1) * per]),
                             torch.from_numpy(padded["mask"][j * per:
                                                             (j + 1) * per]),
                             device=dev)
                for j, dev in enumerate(self.shard_devices)]
        return np.concatenate([o.float().cpu().numpy() for o in outs])[:n]

    def query_tokens_from_embeddings(
        self, field_embeddings: np.ndarray, masks: np.ndarray
    ) -> np.ndarray:
        """[N, F, D] + [N, F] -> [N, K, hidden] float32, ``batch_size`` items
        per forward (split over dp under a mesh)."""
        outs = []
        for i in range(0, field_embeddings.shape[0], self.batch_size):
            outs.append(self._forward_to_host(
                np.ascontiguousarray(field_embeddings[i:i + self.batch_size],
                                     np.float32),
                np.ascontiguousarray(masks[i:i + self.batch_size],
                                     np.float32)))
        return np.concatenate(outs, axis=0)

    def query_tokens_from_cache(
        self, cache: FieldEmbeddingCache, item_ids: Optional[Sequence[str]] = None
    ) -> Dict[str, np.ndarray]:
        ids = list(item_ids) if item_ids is not None else cache.item_ids
        emb, mask = cache.gather(ids)
        tokens = self.query_tokens_from_embeddings(emb, mask)
        return {iid: tokens[i] for i, iid in enumerate(ids)}

    # ------------------------------------------------------------------
    # Raw-item path (encodes fields on the fly via an item encoder)
    # ------------------------------------------------------------------

    def _load_data(self, data_path: str) -> Dict[str, Dict]:
        if data_path not in self._data_cache:
            with open(data_path) as f:
                data = json.load(f)
            for item_id, item in data.items():
                if isinstance(item, dict):
                    item.setdefault("item_id", item_id)
            self._data_cache[data_path] = data
        return self._data_cache[data_path]

    def encode_items(self, items: Sequence[Dict]) -> tuple:
        """Items -> ([N, F, D] embeddings, [N, F] masks) with null-aware
        masking and zero-embedding degradation.  The encoder is anything with
        ``encode_batch_by_field(items, fields) -> {field: [N, D]}`` and
        ``embedding_dim``."""
        if self.item_encoder is None:
            raise ValueError("item_encoder required for raw-item encoding")
        by_field = self.item_encoder.encode_batch_by_field(
            list(items), self.field_names)
        n = len(items)
        dim = self.item_encoder.embedding_dim
        emb = np.zeros((n, len(self.field_names), dim), np.float32)
        mask = np.zeros((n, len(self.field_names)), np.float32)
        for fi, f in enumerate(self.field_names):
            emb[:, fi] = by_field[f]
            for j, item in enumerate(items):
                mask[j, fi] = 0.0 if is_null_value(item.get(f)) else 1.0
        # failed encodes produce zero vectors -> masked out as well
        mask *= (np.abs(emb).sum(axis=-1) > 0).astype(np.float32)
        return emb, mask

    def generate_query_tokens_by_id(self, item_id: str, data_path: str):
        data = self._load_data(data_path)
        item = data.get(str(item_id))
        if item is None:
            return None
        emb, mask = self.encode_items([item])
        return self.query_tokens_from_embeddings(emb, mask)[0]

    def generate_query_tokens_batch_by_ids(
        self, item_ids: Sequence[str], data_path: str
    ) -> Dict[str, np.ndarray]:
        data = self._load_data(data_path)
        items, kept = [], []
        for iid in item_ids:
            item = data.get(str(iid))
            if item is not None:
                items.append(item)
                kept.append(str(iid))
        if not items:
            return {}
        emb, mask = self.encode_items(items)
        tokens = self.query_tokens_from_embeddings(emb, mask)
        return {iid: tokens[i] for i, iid in enumerate(kept)}


def run_inference(
    inference: QFormerInference,
    cache: FieldEmbeddingCache,
    output_path: str,
    item_ids: Optional[Sequence[str]] = None,
    log_fn=print,
) -> Dict[str, np.ndarray]:
    """Cache -> {item_id: [K, hidden]} pickle
    (reference: data_processing/qformer_inference.py:112-176)."""
    t0 = time.perf_counter()
    tokens = inference.query_tokens_from_cache(cache, item_ids)
    dt = time.perf_counter() - t0
    n = len(tokens)
    log_fn(f"generated query tokens for {n} items in {dt:.2f}s "
           f"({n / max(dt, 1e-9):.0f} items/s)")
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "wb") as f:
            pickle.dump(tokens, f)
        log_fn(f"saved to {output_path}")
    return tokens
