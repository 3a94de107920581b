"""Port parity: the trainable causal GQA flash attention
(``ops/flash_causal.flash_causal_attention_train``; K1 with (m, l) forward,
B7b backward) on the CPU, where it runs its plain versions, against the JAX
``flash_causal_self_attention`` run in interpret mode (its Pallas forward and
backward kernels) through ``jax.vjp``.

fp32 throughout.  Tolerances: forward atol 2e-5 (as
``tests/test_torch_flash_causal.py``); gradients atol 5e-5, rtol 1e-3 (as
``tests/test_flash_causal.py`` holds the JAX kernels to the XLA path); m and
l rtol 1e-5.  Mirrors ``tests/test_flash_causal.py``: GQA groups share dk/dv,
padded keys and future keys get zero gradient, odd L, no mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.ops.flash_causal_vjp import _fwd, flash_causal_self_attention
from unirec_tpu_torch.ops.flash_causal import (
    attention_dsum,
    flash_causal_attention,
    flash_causal_attention_bwd_plain,
    flash_causal_attention_fwd_plain,
    flash_causal_attention_plain,
    flash_causal_attention_train,
    flash_causal_bwd_dkv,
    flash_causal_bwd_dq,
)


FWD_ATOL, GRAD_ATOL, GRAD_RTOL, STAT_RTOL = 2e-5, 5e-5, 1e-3, 1e-5
SHAPES = [  # (B, L, Hq, Hkv, hd)
    (2, 40, 4, 2, 16),
    (2, 33, 4, 1, 8),   # odd L, one KV head for four query heads
    (1, 64, 2, 2, 16),  # no grouping, L = 64
]


def _data(shape, seed=0):
    b, l, hq, hkv, hd = shape
    rng = np.random.RandomState(seed)
    q = rng.randn(b, l, hq * hd).astype(np.float32)
    k = rng.randn(b, l, hkv * hd).astype(np.float32)
    v = rng.randn(b, l, hkv * hd).astype(np.float32)
    mask = (rng.rand(b, l) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1, l // 2:] = 0.0  # a right-padded row
    ct = rng.randn(b, l, hq * hd).astype(np.float32)
    return q, k, v, mask, ct


def _port_grads(q, k, v, mask, ct, hq, hkv):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_causal_attention_train(qt, kt, vt, torch.tensor(mask), hq, hkv)
    (out * torch.tensor(ct)).sum().backward()
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), \
        vt.grad.numpy()


def _jax_grads(q, k, v, mask, ct, hq, hkv, block=8):
    fn = lambda q_, k_, v_: flash_causal_self_attention(  # noqa: E731
        q_, k_, v_, jnp.asarray(mask), hq, hkv, block=block, interpret=True)
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return (np.asarray(out),) + tuple(np.asarray(g)
                                      for g in vjp(jnp.asarray(ct)))


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_gradients_match_jax_kernels(shape):
    _, _, hq, hkv, _ = shape
    q, k, v, mask, ct = _data(shape)
    got = _port_grads(q, k, v, mask, ct, hq, hkv)
    want = _jax_grads(q, k, v, mask, ct, hq, hkv)
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL, rtol=0)
    for a, b, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_saved_statistics_match_the_jax_forward_kernel():
    """(m, l) of the plain K1 training forward equal the Pallas forward's
    per-(row, head) max and sum, kept apart."""
    b, l, hq, hkv, hd = shape = SHAPES[0]
    q, k, v, mask, _ = _data(shape)
    bias3 = jnp.asarray((1.0 - mask)[:, None, :] * -1e9)
    _, m_j, l_j = _fwd(*(jnp.asarray(a) for a in (q, k, v)), bias3, hq, hkv,
                       8, True)
    o, m, den = flash_causal_attention_fwd_plain(
        *(torch.tensor(a) for a in (q, k, v, mask)), hq, hkv)
    assert m.shape == den.shape == (b, l, hq) and m.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j)[:, :, :hq],
                               rtol=STAT_RTOL, atol=1e-6)
    np.testing.assert_allclose(den.numpy(), np.asarray(l_j)[:, :, :hq],
                               rtol=STAT_RTOL)
    plain = flash_causal_attention_plain(
        *(torch.tensor(a) for a in (q, k, v, mask)), hq, hkv)
    np.testing.assert_allclose(o.numpy(), plain.numpy(), atol=FWD_ATOL)


def test_gqa_groups_share_kv_grads():
    """Heads 0 and 1 read kv head 0: a cotangent on either head alone gives
    kv head 0 a gradient and kv head 1 none, and the two add up to the
    cotangent on both."""
    b, l, hq, hkv, hd = shape = SHAPES[0]
    q, k, v, mask, ct = _data(shape)
    grads = []
    for heads in ((0,), (1,), (0, 1)):
        sel = np.zeros_like(ct)
        for h in heads:
            sel[:, :, h * hd:(h + 1) * hd] = ct[:, :, h * hd:(h + 1) * hd]
        grads.append(_port_grads(q, k, v, mask, sel, hq, hkv)[2])
    for dk in grads:
        assert np.abs(dk[:, :, :hd]).sum() > 0
        np.testing.assert_array_equal(dk[:, :, hd:], 0.0)
    np.testing.assert_allclose(grads[0] + grads[1], grads[2], atol=1e-5)


def test_padded_and_future_keys_get_zero_grad():
    shape = SHAPES[0]
    _, l, hq, hkv, _ = shape
    q, k, v, mask, ct = _data(shape)
    row0 = np.zeros_like(ct)
    row0[:, 0] = ct[:, 0]  # row 0 sees key 0 alone
    _, _, dk, dv = _port_grads(q, k, v, mask, row0, hq, hkv)
    np.testing.assert_array_equal(dv[:, 1:], 0.0)
    np.testing.assert_array_equal(dk[:, 1:], 0.0)
    assert np.abs(dv[:, 0]).sum() > 0
    _, _, dk, dv = _port_grads(q, k, v, mask, ct, hq, hkv)
    padded = mask == 0
    assert padded.any()
    np.testing.assert_array_equal(dk[padded], 0.0)
    np.testing.assert_array_equal(dv[padded], 0.0)


def test_no_mask_and_odd_length():
    b, l, hq, hkv, hd = 1, 13, 4, 2, 16
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(b, l, h * hd).astype(np.float32)
               for h in (hq, hkv, hkv))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_causal_attention_train(qt, kt, vt, None, hq, hkv)
    out.square().sum().backward()
    fn = lambda q_, k_, v_: jnp.sum(flash_causal_self_attention(  # noqa: E731
        q_, k_, v_, None, hq, hkv, interpret=True) ** 2)
    want = jax.grad(fn, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for t, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_backward_plain_is_the_autograd_backward():
    """The Function's CPU backward is exactly the plain B7b on the saved
    (m, l) and dsum = rowsum(dO * O); no kernel runs and nothing builds."""
    from unirec_tpu_torch.ops import _build

    shape = SHAPES[1]
    _, _, hq, hkv, _ = shape
    q, k, v, mask, ct = (torch.tensor(a) for a in _data(shape))
    counters = (flash_causal_attention, flash_causal_bwd_dq,
                flash_causal_bwd_dkv)
    before = [fn.launches for fn in counters]
    got = _port_grads(*(a.numpy() for a in (q, k, v, mask, ct)), hq, hkv)
    o, m, den = flash_causal_attention_fwd_plain(q, k, v, mask, hq, hkv)
    want = flash_causal_attention_bwd_plain(
        q, k, v, mask, ct, m, den, attention_dsum(ct, o, hq), hq, hkv)
    for a, b in zip(got[1:], want):
        np.testing.assert_array_equal(a, b.numpy())
    assert [fn.launches for fn in counters] == before
    assert _build.load_kernels.cache_info().currsize == 0


def test_inference_entry_refuses_a_graph_it_would_cut():
    """K1's inference entry has no gradient: on a tensor that is not on the
    CPU and needs one it raises (a meta tensor stands in for the card)."""
    q = torch.empty(1, 8, 256, device="meta", requires_grad=True)
    kv = torch.empty(1, 8, 128, device="meta")
    with pytest.raises(RuntimeError, match="flash_causal_attention_train"):
        flash_causal_attention(q, kv, kv, None, 2, 1, mask_checked=True)
    with pytest.raises(ValueError, match="zero-length"):
        flash_causal_attention_train(
            torch.zeros(1, 8, 256), torch.zeros(1, 8, 128),
            torch.zeros(1, 8, 128), torch.zeros(1, 8), 2, 1)
