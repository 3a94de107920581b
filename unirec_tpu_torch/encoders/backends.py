"""Field-encoder backends (port of ``unirec_tpu/encoders/backends.py``).

Each backend has a batched numpy-in / numpy-out ``encode`` that the
``ItemEncoder`` orchestrates:

* ``Qwen3TextBackend``: the Qwen3-Embedding text tower, a deterministic
  Qwen3 forward (``models/qwen3.Qwen3Model`` in eval mode: its attention is
  kernel K1 on the card) pooled at each row's last valid token and L2
  normalised; ``from_local_hf`` reads a local Hugging Face checkpoint;
* ``CLIPImageBackend``: the CLIP ViT-L/14 vision tower
  (``models/clip.CLIPVisionTower``) behind host-side image loading (URLs on
  a thread pool, base64 strings, paths, PIL images; a load that fails gives
  a zero row); ``CLIPTextBackend``: the CLIP text tower with its tokenizer
  (77 tokens), for the candidate-embedding CLI;
* ``HashTextBackend`` / ``HashImageBackend``: deterministic pseudo-embeddings
  keyed by content, numpy only, bit for bit the JAX package's (for tests and
  weightless environments);
* ``MWNENumberBackend``: the math-aware number encoder
  (``models/mwne.NormalizedMathematicalEncoder`` in eval mode), then L2
  normalisation; ``from_reference_checkpoint`` reads the reference's trained
  ``.pth``.

The towers run on ``device``: the card unless the caller asks for the CPU
(``utils/device.resolve_device``).  Without weights they are drawn from
``seed`` with the Flax initialisers' distributions (not the JAX package's
bits: another generator).  ``transformers``, ``PIL`` and ``requests`` are
imported only where a checkpoint, an image or a URL is read.

The text backend's batches follow the JAX backend's regime: every chunk of a
call longer than ``batch_size`` runs at ``batch_size`` rows, its tail padded
with rows whose key 0 is marked valid (K1's contract: key 0 of every row is
valid); a lone short call runs at its own size.  A row whose text gives no
token at all is treated the same way (C-15 in ROADMAP.md).  Hugging Face
tokenizers pad on the right here whatever their ``padding_side`` says: the
pooling reads the last valid position of a right-padded row (C-14).
"""

from __future__ import annotations

import hashlib
import io
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from unirec_tpu_torch.configs import MWNEConfig, Qwen3Config
from unirec_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextTower,
    CLIPVisionConfig,
    CLIPVisionTower,
    preprocess_image,
)
from unirec_tpu_torch.models.mwne import load_mwne
from unirec_tpu_torch.models.qwen3 import Qwen3Model, last_token_pool
from unirec_tpu_torch.utils.device import resolve_device


class TextBackend:
    dim: int

    def encode(self, texts: Sequence[str]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class ImageBackend:
    dim: int

    def encode(self, images: Sequence[Any]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class NumberBackend:
    dim: int

    def encode(self, numbers: Sequence[float]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


def _l2_normalize_np(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


class HashTextBackend(TextBackend):
    """Deterministic pseudo-embeddings keyed by text content."""

    def __init__(self, dim: int = 1024):
        self.dim = dim

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            seed = int(hashlib.md5(str(t).encode()).hexdigest()[:8], 16)
            out[i] = np.random.RandomState(seed).randn(self.dim)
        return _l2_normalize_np(out)


class HashImageBackend(ImageBackend):
    """Deterministic pseudo-embeddings keyed by image reference (URL/path)."""

    def __init__(self, dim: int = 768):
        self.dim = dim

    def encode(self, images: Sequence[Any]) -> np.ndarray:
        out = np.zeros((len(images), self.dim), np.float32)
        for i, ref in enumerate(images):
            seed = int(hashlib.md5(str(ref).encode()).hexdigest()[:8], 16)
            out[i] = np.random.RandomState(seed ^ 0xBEEF).randn(self.dim)
        return _l2_normalize_np(out)


def _tower(model_cls, init_fn, config, state_dict, device, dtype, seed):
    """A tower in eval mode on ``device``: ``state_dict`` loaded, or drawn
    from ``seed``."""
    from unirec_tpu_torch.utils import weights

    if state_dict is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        return getattr(weights, init_fn)(config, gen, device=device,
                                         dtype=dtype)
    model = model_cls(config, device=device, dtype=dtype).eval()
    model.load_state_dict(state_dict)
    return model


class _RightPadded:
    """A Hugging Face tokenizer as the backend's ``encode(text, max_length)
    -> (ids [L] int32, mask [L] float32)``, padded on the right whatever the
    tokenizer's ``padding_side`` (Qwen3-Embedding's is left): the pooling
    reads the last valid position of a right-padded row, and K1 needs key 0
    of every row valid (C-14)."""

    def __init__(self, tok):
        self.tok = tok

    def encode(self, text: str, max_length: int):
        out = self.tok(text, truncation=True, max_length=max_length,
                       padding="max_length", padding_side="right",
                       return_tensors="np")
        return (out["input_ids"][0].astype(np.int32),
                out["attention_mask"][0].astype(np.float32))


class Qwen3TextBackend(TextBackend):
    """Qwen3-Embedding-style text encoder: tokenize -> decoder forward ->
    last-token pool -> L2 normalise (what
    SentenceTransformer("Qwen/Qwen3-Embedding-0.6B") computes, reference:
    models/item_encoder_pure_value.py:50, 84-86)."""

    def __init__(self, config: Optional[Qwen3Config] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 tokenizer=None, max_length: int = 128, batch_size: int = 64,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0):
        self.config = config or Qwen3Config()
        self.dim = self.config.hidden_size
        self.max_length = max_length
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if tokenizer is None:
            from unirec_tpu_torch.data.tokenizer import HashTokenizer

            tokenizer = HashTokenizer(self.config.vocab_size, 0, 0)
        self.tokenizer = tokenizer
        self.model = _tower(Qwen3Model, "init_qwen3", self.config, state_dict,
                            self.device, dtype, seed)

    @classmethod
    def from_local_hf(cls, path: str, **kw) -> "Qwen3TextBackend":
        """Load a locally available HF Qwen3 checkpoint (no network)
        through ``utils/weights.qwen3_state_dict_from_hf``."""
        from transformers import AutoConfig, AutoTokenizer

        from unirec_tpu_torch.utils.weights import qwen3_state_dict_from_hf

        hf_cfg = AutoConfig.from_pretrained(path)
        cfg = Qwen3Config(
            vocab_size=hf_cfg.vocab_size,
            hidden_size=hf_cfg.hidden_size,
            intermediate_size=hf_cfg.intermediate_size,
            num_hidden_layers=hf_cfg.num_hidden_layers,
            num_attention_heads=hf_cfg.num_attention_heads,
            num_key_value_heads=hf_cfg.num_key_value_heads,
            head_dim=getattr(hf_cfg, "head_dim", 128),
            rope_theta=hf_cfg.rope_theta,
        )
        tok = _RightPadded(AutoTokenizer.from_pretrained(path))
        return cls(cfg, qwen3_state_dict_from_hf(path, cfg), tok, **kw)

    @torch.inference_mode()
    def forward(self, ids: np.ndarray, masks: np.ndarray) -> np.ndarray:
        """One batch: ids and masks [B, L] (right padded, key 0 valid) ->
        L2-normalised pooled rows [B, D] float32 (the norm in float32,
        floored at 1e-8)."""
        ids_t = torch.from_numpy(np.asarray(ids)).to(self.device).long()
        mask_t = torch.from_numpy(np.asarray(masks, np.float32)).to(
            self.device)
        pooled = last_token_pool(self.model(ids_t, mask_t), mask_t).float()
        norm = pooled.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return (pooled / norm).cpu().numpy()

    def tokenize(self, texts: Sequence[str]):
        """(ids [B, max_length] int32, masks [B, max_length] float32), right
        padded."""
        ids, masks = zip(*(self.tokenizer.encode(t, self.max_length)
                           for t in texts))
        return np.stack(ids), np.stack(masks).astype(np.float32)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """One shape per regime: full chunks (and tails after them) run at
        ``batch_size``; a lone undersized call runs at its natural shape."""
        n = len(texts)
        out = np.zeros((n, self.dim), np.float32)
        for i in range(0, n, self.batch_size):
            chunk = list(texts[i: i + self.batch_size])
            ids, masks = self.tokenize(chunk)
            take = len(chunk)
            pad = 0 if (i == 0 and n <= self.batch_size) else (
                self.batch_size - take)
            if pad > 0:
                ids = np.pad(ids, ((0, pad), (0, 0)))
                masks = np.pad(masks, ((0, pad), (0, 0)))
            masks[masks.sum(1) == 0, 0] = 1.0  # the tail; texts of no token
            out[i: i + take] = self.forward(ids, masks)[:take]
        return out


class CLIPImageBackend(ImageBackend):
    """CLIP vision tower + host-side loading.

    Accepts URLs (parallel thread-pool download, reference
    item_encoder_pure_value.py:204-217), base64 strings, file paths, or PIL
    images.  Failures degrade to zero embeddings (reference :167-170).
    """

    def __init__(self, config: Optional[CLIPVisionConfig] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 batch_size: int = 32, download_workers: int = 16,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0):
        self.config = config or CLIPVisionConfig()
        self.dim = self.config.projection_dim
        self.batch_size = batch_size
        self.download_workers = download_workers
        self.device = resolve_device(device)
        self.model = _tower(CLIPVisionTower, "init_clip_vision", self.config,
                            state_dict, self.device, dtype, seed)

    @classmethod
    def from_local_hf(cls, path: str, **kw) -> "CLIPImageBackend":
        """The vision tower of a local HF ``CLIPModel`` checkpoint."""
        from transformers import CLIPModel

        from unirec_tpu_torch.models.clip import (
            convert_clip_vision,
            vision_config_from_hf,
        )
        from unirec_tpu_torch.utils.weights import clip_state_dict_from_flax

        hf = CLIPModel.from_pretrained(path, torch_dtype=torch.float32)
        cfg = vision_config_from_hf(hf.config)
        sd = clip_state_dict_from_flax(convert_clip_vision(hf.state_dict(),
                                                           cfg))
        return cls(cfg, sd, **kw)

    def _load_image(self, ref: Any):
        from PIL import Image

        if hasattr(ref, "convert"):  # PIL image
            return ref.convert("RGB")
        s = str(ref)
        if s.startswith("http"):
            import requests

            resp = requests.get(s, stream=True, timeout=10)
            resp.raise_for_status()
            return Image.open(resp.raw).convert("RGB")
        if s.startswith("data:image") or len(s) > 260:
            import base64

            if s.startswith("data:image"):
                s = s.split(",")[1]
            return Image.open(io.BytesIO(base64.b64decode(s))).convert("RGB")
        return Image.open(s).convert("RGB")

    def _load_all(self, refs: Sequence[Any]):
        import concurrent.futures

        def load(idx_ref):
            idx, ref = idx_ref
            try:
                return idx, self._load_image(ref)
            except Exception:  # noqa: BLE001  a failed load is a zero row
                return idx, None

        urls = [(i, r) for i, r in enumerate(refs)
                if str(r).startswith("http")]
        others = [(i, r) for i, r in enumerate(refs)
                  if not str(r).startswith("http")]
        results = {}
        if urls:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.download_workers) as ex:
                for idx, img in ex.map(load, urls):
                    results[idx] = img
        for idx, ref in others:
            results[idx] = load((idx, ref))[1]
        return results

    @torch.inference_mode()
    def forward(self, pixels: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] preprocessed pixels -> [B, projection_dim] float32."""
        x = torch.from_numpy(np.asarray(pixels, np.float32)).to(self.device)
        return self.model(x).float().cpu().numpy()

    def encode(self, images: Sequence[Any]) -> np.ndarray:
        n = len(images)
        out = np.zeros((n, self.dim), np.float32)
        valid = [(i, r) for i, r in enumerate(images)
                 if r is not None and str(r).strip()]
        if not valid:
            return out
        loaded = self._load_all([r for _, r in valid])
        pix, rows = [], []
        for j, (i, _) in enumerate(valid):
            img = loaded.get(j)
            if img is not None:
                pix.append(preprocess_image(img, self.config.image_size))
                rows.append(i)
        for i in range(0, len(pix), self.batch_size):
            emb = self.forward(np.stack(pix[i: i + self.batch_size]))
            for k, row in enumerate(rows[i: i + self.batch_size]):
                out[row] = emb[k]
        return out


class CLIPTextBackend(TextBackend):
    """The CLIP text tower behind its own tokenizer (``max_length`` 77,
    padded to it), as the candidate-embedding stage's ``clip`` mode runs it
    (reference: data_processing/item_embedding_clip.py).  ``tokenizer`` maps
    a list of texts to ``input_ids`` and ``attention_mask`` arrays, as a
    Hugging Face tokenizer called with ``return_tensors="np"`` does."""

    def __init__(self, config: Optional[CLIPTextConfig] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 tokenizer=None, max_length: int = 77,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        self.config = config or CLIPTextConfig()
        self.dim = self.config.projection_dim
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.device = resolve_device(device)
        self.model = _tower(CLIPTextTower, "init_clip_text", self.config,
                            state_dict, self.device, dtype, seed)

    @classmethod
    def from_local_hf(cls, path: str, **kw) -> "CLIPTextBackend":
        """The text tower and ``CLIPTokenizerFast`` of a local HF
        ``CLIPModel`` checkpoint."""
        from transformers import CLIPModel, CLIPTokenizerFast

        from unirec_tpu_torch.models.clip import (
            convert_clip_text,
            text_config_from_hf,
        )
        from unirec_tpu_torch.utils.weights import clip_state_dict_from_flax

        hf = CLIPModel.from_pretrained(path, torch_dtype=torch.float32)
        cfg = text_config_from_hf(hf.config)
        sd = clip_state_dict_from_flax(convert_clip_text(hf.state_dict(), cfg))
        return cls(cfg, sd, CLIPTokenizerFast.from_pretrained(path), **kw)

    @torch.inference_mode()
    def forward(self, ids: np.ndarray, masks: np.ndarray) -> np.ndarray:
        """ids and masks [B, L] -> [B, projection_dim] float32."""
        ids_t = torch.from_numpy(np.asarray(ids)).to(self.device).long()
        mask_t = torch.from_numpy(np.asarray(masks, np.float32)).to(
            self.device)
        return self.model(ids_t, mask_t).float().cpu().numpy()

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        enc = self.tokenizer(list(texts), padding="max_length",
                             truncation=True, max_length=self.max_length,
                             return_tensors="np")
        return self.forward(enc["input_ids"].astype(np.int32),
                            enc["attention_mask"].astype(np.float32))


class MWNENumberBackend(NumberBackend):
    """Normalized math-aware number encoder + L2 normalisation
    (reference: models/item_encoder_pure_value.py:290-306).

    ``state_dict``: the encoder's weights and running statistics (e.g.
    ``utils/weights.mwne_state_dict_from_flax``); without one the weights
    are drawn from ``seed`` with the Flax initialisers' distributions (not
    the JAX package's bits: another generator).  The encoder is a few
    elementwise products per number; it runs on ``device`` (default the
    CPU, where the cache precompute's numpy batches live)."""

    def __init__(self, config: Optional[MWNEConfig] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None, seed: int = 0):
        self.config = config or MWNEConfig()
        self.dim = self.config.embedding_dim
        self.device = torch.device(device or "cpu")
        self.model = load_mwne(self.config, state_dict, device=self.device,
                               seed=seed)

    @classmethod
    def from_reference_checkpoint(cls, path: str, device=None
                                  ) -> "MWNENumberBackend":
        """Load the reference's trained number-encoder checkpoint
        (number_encoders/mathematical_encoder_1024d_normalized.pth;
        reference: models/item_encoder_pure_value.py:68-70, schema
        models/mwne.py:784-806)."""
        from unirec_tpu_torch.utils.torch_convert import (
            load_reference_mwne_checkpoint,
        )
        from unirec_tpu_torch.utils.weights import mwne_state_dict_from_flax

        cfg, variables = load_reference_mwne_checkpoint(path)
        return cls(cfg, mwne_state_dict_from_flax(variables), device=device)

    @torch.no_grad()
    def encode(self, numbers: Sequence[float]) -> np.ndarray:
        # invalid values encode as 0.0 (reference :295-301)
        clean = []
        for x in numbers:
            try:
                clean.append(float(x))
            except (TypeError, ValueError):
                clean.append(0.0)
        x = torch.tensor(clean, dtype=torch.float32, device=self.device)
        emb = self.model(x, train=False).cpu().numpy().astype(np.float32)
        return _l2_normalize_np(emb)
