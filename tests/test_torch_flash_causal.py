"""Port parity: K1's plain version (ops/flash_causal.py) vs the JAX causal
GQA flash forward run in interpret mode, and vs the XLA additive-mask path of
``Qwen3Attention``, on the CPU (fp32, atol 2e-5).

Covers padded rows (every query row is computed), odd L and several GQA
group sizes.  The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.ops.flash_causal_vjp import flash_causal_self_attention
from unirec_tpu_torch.ops.flash_causal import (
    flash_causal_attention,
    flash_causal_attention_plain,
)


ATOL = 2e-5
SHAPES = [  # (B, L, Hq, Hkv, hd)
    (2, 40, 4, 2, 16),
    (2, 33, 4, 1, 8),  # odd L, one KV head for four query heads
    (1, 16, 2, 2, 16),  # no grouping
]


def xla_causal(q3, k3, v3, pad_mask, hq, hkv):
    """The XLA attention math of unirec_tpu/models/qwen3.Qwen3Attention."""
    b, l, dq = q3.shape
    hd = dq // hq
    q = q3.reshape(b, l, hq, hd).transpose(0, 2, 1, 3)
    k = jnp.repeat(k3.reshape(b, l, hkv, hd), hq // hkv, axis=2)
    v = jnp.repeat(v3.reshape(b, l, hkv, hd), hq // hkv, axis=2)
    k, v = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    causal = jnp.tril(jnp.ones((l, l), jnp.float32))[None, None]
    allowed = causal * pad_mask.astype(jnp.float32)[:, None, None, :]
    bias = (1.0 - allowed) * -1e9
    scale = 1.0 / jnp.sqrt(jnp.asarray(hd, jnp.float32))
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   preferred_element_type=jnp.float32) * scale
    p = jax.nn.softmax(s + bias, axis=-1)
    ctx = jnp.einsum("bhqk,bhkd->bhqd", p, v,
                     preferred_element_type=jnp.float32)
    return ctx.transpose(0, 2, 1, 3).reshape(b, l, hq * hd)


def _data(shape, seed=0):
    b, l, hq, hkv, hd = shape
    rng = np.random.RandomState(seed)
    q = rng.randn(b, l, hq * hd).astype(np.float32)
    k = rng.randn(b, l, hkv * hd).astype(np.float32)
    v = rng.randn(b, l, hkv * hd).astype(np.float32)
    mask = np.zeros((b, l), np.float32)
    for i in range(b):  # right padding, lengths from 1 to L
        mask[i, : max(1, l - 13 * i)] = 1.0
    return q, k, v, mask


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(shape, reference):
    q, k, v, mask = _data(shape)
    _, _, hq, hkv, _ = shape
    args = [jnp.asarray(a) for a in (q, k, v, mask)]
    if reference == "pallas_interpret":
        want = flash_causal_self_attention(*args, hq, hkv, block=8,
                                           interpret=True)
    else:
        want = xla_causal(*args, hq, hkv)
    got = flash_causal_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), hq, hkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v, mask = (torch.from_numpy(a) for a in _data(SHAPES[0]))
    before = flash_causal_attention.launches
    got = flash_causal_attention(q, k, v, mask, 4, 2)
    torch.testing.assert_close(
        got, flash_causal_attention_plain(q, k, v, mask, 4, 2), atol=0, rtol=0)
    assert flash_causal_attention.launches == before


def test_wrapper_refuses_zero_length_rows():
    q, k, v, mask = (torch.from_numpy(a) for a in _data(SHAPES[0]))
    mask[1] = 0.0
    with pytest.raises(ValueError, match="zero-length"):
        flash_causal_attention(q, k, v, mask, 4, 2)
    with pytest.raises(ValueError, match="multiple"):
        flash_causal_attention(q, k, v, None, 4, 3)
