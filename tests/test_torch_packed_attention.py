"""B15, the port's ``packed_item_attention``, against the JAX package's
Pallas kernel in interpret mode (``packed_item_attention(...,
interpret=True)``), case for case with ``tests/test_packed_attention.py``
and at its tolerance: atol 2e-5 (fp32 sums in another order).  On the CPU
the port runs its plain version, per-item fp32 softmax attention.  Inputs
are made with numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.ops.attention import make_additive_mask
from unirec_tpu.ops.packed_attention import packed_item_attention as jpacked
from unirec_tpu_torch.ops import packed_attention as pp

ATOL = 2e-5


def _both(q, k, v, bias=None):
    """(port output, JAX kernel output), numpy."""
    want = jpacked(*(jnp.asarray(a) for a in (q, k, v)),
                   None if bias is None else jnp.asarray(bias),
                   interpret=True)
    before = pp.packed_item_attention.launches
    got = pp.packed_item_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if bias is None else torch.from_numpy(bias))
    assert pp.packed_item_attention.launches == before  # plain on the CPU
    assert got.shape == q.shape and got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("b,h,k,f,hd", [
    (6, 4, 32, 32, 64),   # self-attention shape (the JAX kernel pads 6 -> 8)
    (4, 2, 32, 14, 64),   # cross-attention over 14 fields
    (5, 2, 2, 14, 32),    # K=2: 64 items per TPU tile
])
def test_matches_jax(b, h, k, f, hd):
    rng = np.random.RandomState(0)
    q = rng.randn(b, h, k, hd).astype(np.float32)
    kk = rng.randn(b, h, f, hd).astype(np.float32)
    v = rng.randn(b, h, f, hd).astype(np.float32)
    mask = (rng.rand(b, f) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    bias = np.array(make_additive_mask(jnp.asarray(mask)))
    got, want = _both(q, kk, v, bias)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_no_bias_matches():
    q = np.random.RandomState(1).randn(4, 2, 32, 64).astype(np.float32)
    got, want = _both(q, q, q)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_no_cross_item_leakage():
    """Changing item 1's keys moves item 1's output and no other item's."""
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(4, 2, 32, 64).astype(np.float32))
    k = torch.from_numpy(rng.randn(4, 2, 32, 64).astype(np.float32))
    o1 = pp.packed_item_attention(q, k, k)
    k2 = k.clone()
    k2[1] = 1e3
    o2 = pp.packed_item_attention(q, k2, k2)
    np.testing.assert_allclose(o1[0].numpy(), o2[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(o1[2].numpy(), o2[2].numpy(), atol=1e-5)
    assert (o1[1] - o2[1]).abs().max().item() > 1e-3


def test_all_masked_item_matches_jax_and_ignores_its_batch():
    """An item with no valid key attends uniformly over its OWN keys, as
    the JAX kernel (and XLA's per-item softmax) does, and its output does
    not depend on the other items of the batch."""
    rng = np.random.RandomState(3)
    b, h, k, f, hd = 4, 2, 32, 14, 64
    q = rng.randn(b, h, k, hd).astype(np.float32)
    kk = rng.randn(b, h, f, hd).astype(np.float32)
    v = rng.randn(b, h, f, hd).astype(np.float32)
    mask = np.ones((b, f), np.float32)
    mask[1] = 0.0  # item 1: no valid fields
    bias = np.array(make_additive_mask(jnp.asarray(mask)))
    got, want = _both(q, kk, v, bias)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), got[1].shape), atol=ATOL)
    v2 = v.copy()
    v2[0] += 100.0  # perturb item 0's values
    got2, _ = _both(q, kk, v2, bias)
    np.testing.assert_allclose(got[1], got2[1], atol=1e-5)


def test_invalid_query_count():
    q = torch.zeros(2, 2, 33, 64)
    with pytest.raises(ValueError, match="divide 128"):
        pp.packed_item_attention(q, q, q)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,k,f,hd", [
    (3, 32, 14, 200),   # head dims above the first kernel's 128
    (3, 32, 14, 256),
    (2, 32, 14, 512),
    (2, 128, 512, 64),  # one item over more keys than a block held
    (3, 2, 600, 32),    # K = 2 over 600 keys: 64 items per TPU tile
])
def test_matches_jax_at_shapes_the_first_kernel_refused(dtype, b, k, f, hd):
    """Shapes the CUDA kernels now take at any head dim and F (C-8; they are
    held to this plain version on the card by test_torch_kernels_gpu and
    chip_smoke.py): the wrapper's plain version against the JAX kernel in
    interpret mode, ~30% masked keys and an item with none; float32 at
    atol 2e-5, bf16 (both sides fp32 inside, one rounding of the output)
    within one bf16 ulp."""
    rng = np.random.RandomState(hd + f)
    h = 2
    q = rng.randn(b, h, k, hd).astype(np.float32)
    kk = rng.randn(b, h, f, hd).astype(np.float32)
    v = rng.randn(b, h, f, hd).astype(np.float32)
    mask = (rng.rand(b, f) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1] = 0.0
    bias = np.array(make_additive_mask(jnp.asarray(mask)))
    if dtype == "fp32":
        got, want = _both(q, kk, v, bias)
        np.testing.assert_allclose(got, want, atol=ATOL)
        return
    q, kk, v = (torch.from_numpy(a).bfloat16() for a in (q, kk, v))
    want = jpacked(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                     for t in (q, kk, v)), jnp.asarray(bias), interpret=True)
    got = pp.packed_item_attention(q, kk, v, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=8e-3, atol=1e-3)
