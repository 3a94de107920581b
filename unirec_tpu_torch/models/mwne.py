"""MWNE, the math-aware number encoder (port of the number part of
``unirec_tpu/models/mwne.py``).

* ``MathematicalEncoder``: Fourier features over log-spaced frequencies, the
  raw value and its sign, and a learned linear remainder
  (reference: models/mwne.py:91-183);
* ``NormalizedMathematicalEncoder``: the encoder followed by the running-std
  rescaling with a 50%-change guard and a [0.1, 10] scaling clamp
  (reference: models/mwne.py:9-64).  The running statistics are buffers
  (``running_std``, ``num_batches_tracked``: the JAX module's
  ``batch_stats``); ``train=True`` updates them in place;
* the user stage's context encoders: ``timestamp_features`` (Unix seconds ->
  9 trend and phase features, the JAX function's float32 operations in its
  order), ``TimestampEncoder``, ``geo_to_cartesian``,
  ``GeoCoordinateEncoder``, and ``sinusoidal_position_encoding``
  (reference: models/mwne.py:532-608, models/user_sequence_encoder.py:20-25).

Parameter names follow the Flax tree (``base.fourier_weight``,
``base.raw_scale``, ``base.extra_proj.weight``; the Flax kernel ``[1, extra]``
is stored as ``weight [extra, 1]``), so ``utils/weights.
mwne_state_dict_from_flax`` maps JAX variables one to one.  ``MWNEDecoder``
is the invertibility decoder that MWNE training (``train/mwne.py``) fits
beside the encoder.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from unirec_tpu_torch.configs import MWNEConfig
from unirec_tpu_torch.models.qformer import Linear


def log_frequencies(cfg: MWNEConfig) -> torch.Tensor:
    """The fixed frequencies 10^-2 .. max_frequency (reference:
    models/mwne.py:111) as ``jnp.logspace`` spaces them: the exponents in
    float32 (``start * (1 - i/(n-1)) + stop * i/(n-1)``, the last exactly
    ``stop``), then 10 ** exponent rounded to float32."""
    n = cfg.num_frequencies
    start = np.float32(-2.0)
    stop = np.float32(math.log10(cfg.max_frequency))
    if n == 1:
        lin = np.asarray([start], np.float32)
    else:
        j = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
        lin = np.concatenate([start * (np.float32(1) - j) + stop * j, [stop]])
    return torch.from_numpy(
        np.power(10.0, lin.astype(np.float64)).astype(np.float32))


class MathematicalEncoder(nn.Module):
    """Fourier + raw + linear number encoder; additive-friendly by design."""

    def __init__(self, config: MWNEConfig, *, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.register_buffer("frequencies", log_frequencies(cfg).to(device),
                             persistent=False)
        self.fourier_weight = nn.Parameter(
            torch.ones(cfg.fourier_dim, device=device))
        self.raw_scale = (nn.Parameter(torch.ones(2, device=device))
                          if cfg.include_raw else None)
        self.extra_proj = (nn.Linear(1, cfg.extra_dim, bias=False,
                                     device=device)
                           if cfg.extra_dim > 0 else None)

    def forward(self, numbers: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        shape = numbers.shape
        x = numbers.reshape(-1, 1).float()
        # interleaved (cos, sin) per frequency (reference: models/mwne.py:162-175)
        phases = x * self.frequencies[None, :]
        four = torch.stack([torch.cos(phases), torch.sin(phases)], dim=-1)
        components = [four.reshape(x.shape[0], -1) * self.fourier_weight[None]]
        if self.raw_scale is not None:
            raw = torch.cat([x, torch.sign(x)], dim=-1)
            components.append(raw * self.raw_scale[None])
        if self.extra_proj is not None:
            components.append(self.extra_proj(x))
        return torch.cat(components, dim=-1).reshape(*shape, cfg.embedding_dim)


class NormalizedMathematicalEncoder(nn.Module):
    """MathematicalEncoder + the running-std normalizer."""

    def __init__(self, config: MWNEConfig, *, device=None):
        super().__init__()
        self.config = config
        self.base = MathematicalEncoder(config, device=device)
        self.register_buffer("running_std",
                             torch.ones(config.embedding_dim, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int32, device=device))

    def forward(self, numbers: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg = self.config
        embeddings = self.base(numbers)
        flat = embeddings.reshape(-1, cfg.embedding_dim)
        if train:
            with torch.no_grad():
                batch_std = flat.std(dim=0, unbiased=False)
                prev = self.running_std
                # 50%-change guard: only dims whose std moved by less than
                # half the running value take the momentum update
                # (reference: models/mwne.py:36-47)
                valid = (batch_std - prev).abs() < prev * 0.5
                updated = torch.where(
                    valid, cfg.momentum * prev + (1 - cfg.momentum) * batch_std,
                    prev)
                first = bool(self.num_batches_tracked == 0)
                new_std = torch.clamp_min(batch_std if first else updated,
                                          cfg.min_std)
                self.running_std.copy_(new_std)
                self.num_batches_tracked += 1
            std = new_std
        else:
            std = self.running_std
        scaling = torch.clamp(cfg.target_std / (std[None, :] + 1e-8), 0.1, 10.0)
        return (flat * scaling).reshape(embeddings.shape)


@torch.no_grad()
def init_mwne(cfg: MWNEConfig, generator: torch.Generator,
              device=None) -> NormalizedMathematicalEncoder:
    """The encoder with the Flax initialisers' distributions: ones for the
    Fourier weights and raw scales, lecun-normal (a normal of std
    1/sqrt(fan_in) / 0.8796, truncated at two standard deviations) for
    ``extra_proj``, fan_in 1."""
    model = NormalizedMathematicalEncoder(cfg, device=device)
    if model.base.extra_proj is not None:
        w = model.base.extra_proj.weight
        std = 1.0 / 0.87962566103423978
        draw = torch.empty(w.shape, device=generator.device)
        nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        w.copy_(draw)
    return model


def load_mwne(cfg: MWNEConfig, state_dict: Optional[dict] = None,
              device=None, seed: int = 0) -> NormalizedMathematicalEncoder:
    """An eval-mode encoder from a state_dict, or seeded weights."""
    if state_dict is None:
        gen = torch.Generator(device=device or "cpu").manual_seed(seed)
        return init_mwne(cfg, gen, device=device).eval()
    model = NormalizedMathematicalEncoder(cfg, device=device)
    model.load_state_dict(state_dict)
    return model.eval()


class MWNEDecoder(nn.Module):
    """The invertibility decoder MLP: dense (d / 2) -> exact gelu -> dense
    (d / 4) -> exact gelu -> dense (1), squeezed (reference:
    models/mwne.py:237-243)."""

    def __init__(self, embedding_dim: int, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = embedding_dim
        self.fc1 = Linear(d, d // 2, device=device, dtype=dtype)
        self.fc2 = Linear(d // 2, d // 4, device=device, dtype=dtype)
        self.fc3 = Linear(d // 4, 1, device=device, dtype=dtype)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        gelu = nn.functional.gelu
        h = gelu(self.fc1(emb), approximate="none")
        h = gelu(self.fc2(h), approximate="none")
        return self.fc3(h)[..., 0]


SECONDS_IN_DAY = 24 * 60 * 60
SECONDS_IN_WEEK = 7 * SECONDS_IN_DAY
SECONDS_IN_YEAR = 365.25 * SECONDS_IN_DAY


def _f32(c: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device: tensor-by-tensor arithmetic
    is one IEEE operation on both devices (the card computes a Python-scalar
    divisor as a reciprocal multiply)."""
    return torch.tensor(c, dtype=torch.float32, device=like.device)


def timestamp_features(timestamps: torch.Tensor) -> torch.Tensor:
    """Unix seconds -> 9 features: secular trend + day/week/year/month sin-cos
    (reference: models/mwne.py:532-565), float32 ``[N, 9]``."""
    x = timestamps.float().reshape(-1, 1)
    two_pi = _f32(2 * math.pi, x)
    day, year = _f32(SECONDS_IN_DAY, x), _f32(SECONDS_IN_YEAR, x)
    secular = x / year
    day_phase = torch.remainder(x, day) / day
    week_phase = ((x / day) + _f32(4, x)) / _f32(7, x)  # epoch was a Thursday
    year_phase = torch.remainder(x, year) / year
    month_phase = year_phase * _f32(12, x)
    feats = [secular]
    for phase in (day_phase, week_phase, year_phase, month_phase):
        feats += [torch.sin(two_pi * phase), torch.cos(two_pi * phase)]
    return torch.cat(feats, dim=-1)


class _ContextMLP(nn.Module):
    """features -> Linear(2D) -> exact gelu -> Linear(D), in ``dtype``
    (Flax ``Dense(dtype=...)`` over float32 parameters)."""

    def __init__(self, in_features: int, embedding_dim: int, *, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype=None):
        super().__init__()
        lkw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.fc1 = Linear(in_features, 2 * embedding_dim, **lkw)
        self.fc2 = Linear(2 * embedding_dim, embedding_dim, **lkw)
        self.dtype = dtype

    def mlp(self, feats: torch.Tensor) -> torch.Tensor:
        h = torch.nn.functional.gelu(self.fc1(feats.to(self.dtype)),
                                     approximate="none")
        return self.fc2(h)


class TimestampEncoder(_ContextMLP):
    """9 temporal features -> Linear -> GELU -> Linear(embedding_dim)."""

    def __init__(self, embedding_dim: int, **kw):
        super().__init__(9, embedding_dim, **kw)

    def forward(self, timestamps: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestamp_features(timestamps))


def geo_to_cartesian(coordinates: torch.Tensor) -> torch.Tensor:
    """[N, 2] (lat, lon) degrees -> [N, 3] unit-sphere cartesian
    (reference: models/mwne.py:596-608)."""
    lat = torch.deg2rad(coordinates[:, 0])
    lon = torch.deg2rad(coordinates[:, 1])
    return torch.stack([torch.cos(lat) * torch.cos(lon),
                        torch.cos(lat) * torch.sin(lon), torch.sin(lat)],
                       dim=-1)


class GeoCoordinateEncoder(_ContextMLP):
    """(lat, lon) -> unit sphere -> Linear -> GELU -> Linear(embedding_dim)."""

    def __init__(self, embedding_dim: int, **kw):
        super().__init__(3, embedding_dim, **kw)

    def forward(self, coordinates: torch.Tensor) -> torch.Tensor:
        if coordinates.dim() != 2 or coordinates.shape[1] != 2:
            raise ValueError("coordinates must be [batch, 2] (lat, lon)")
        return self.mlp(geo_to_cartesian(coordinates.float()))


def sinusoidal_position_encoding(length: int, d_model: int,
                                 dtype: torch.dtype = torch.float32,
                                 device=None) -> torch.Tensor:
    """Standard sinusoidal PE table [length, d_model]
    (reference: models/user_sequence_encoder.py:20-25)."""
    position = torch.arange(length, device=device).float()[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, device=device).float()
        * _f32(-math.log(10000.0) / d_model, position))
    pe = torch.zeros(length, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe.to(dtype)
