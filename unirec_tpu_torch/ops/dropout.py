"""Dropout with masks that a recomputed forward draws again bit for bit.

The JAX trainers fold the step into a dropout key (``fold_in(key(seed),
step)``) and Flax splits it per module.  The port derives one generator per
dropout *site* from ``(seed, step, site path)``: a ``DropoutStream`` travels
down the forward as an argument, each module extends its path
(``stream.at("layers", 3).at("q_proj")``), and ``stream.dropout(x, rate)``
seeds a fresh ``torch.Generator`` on x's device from the path.  A layer that
``torch.utils.checkpoint`` recomputes in the backward receives the same
stream object and so draws the same masks; checkpoint itself restores only
the default generator's state, never an explicit one.

The bits differ from JAX's (another generator), so training parity is held
with dropout off, as the JAX package holds its own against the reference.
Flax's semantics are kept: keep with probability ``1 - rate``, scale the
kept values by ``1 / (1 - rate)``.  A tensor split over tp along its last
dim (a row-parallel layer's input, ``parallel/tensor.py``) takes its own
columns of the whole tensor's mask (``shard``), so the tp ranks together
draw the one-rank masks.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import torch


class DropoutStream:
    """The random state of one training forward: (seed, step) and the path
    of the site that draws."""

    def __init__(self, seed: int, step: int, path: Tuple = ()):
        self.seed, self.step, self.path = int(seed), int(step), tuple(path)

    def at(self, *keys) -> "DropoutStream":
        return DropoutStream(self.seed, self.step, self.path + keys)

    def generator(self, device: torch.device) -> torch.Generator:
        digest = hashlib.blake2b(
            repr((self.seed, self.step, self.path)).encode(), digest_size=8)
        gen = torch.Generator(device=device)
        gen.manual_seed(int.from_bytes(digest.digest(), "little") >> 1)
        return gen

    def dropout(self, x: torch.Tensor, rate: float,
                shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Keep each value with probability ``1 - rate``, scaled.  ``shard``
        ``(n, i)``: x is block i of n along its last dim, and takes that
        block of the whole tensor's mask."""
        if rate <= 0.0:
            return x
        n, i = shard or (1, 0)
        width = x.shape[-1]
        u = torch.rand(x.shape[:-1] + (width * n,),
                       generator=self.generator(x.device), device=x.device)
        if n > 1:
            u = u[..., i * width:(i + 1) * width]
        return torch.where(u >= rate, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, stream: Optional[DropoutStream],
            shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``stream.dropout(x, rate, shard)``; identity without a stream (a
    deterministic forward)."""
    return x if stream is None else stream.dropout(x, rate, shard)


def at(stream: Optional[DropoutStream], *keys) -> Optional[DropoutStream]:
    """``stream.at(*keys)``, or None for a deterministic forward."""
    return None if stream is None else stream.at(*keys)
