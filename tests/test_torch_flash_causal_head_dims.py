"""The head dims of the causal flash kernels K1 and B7b (C-4).

The kernels are built for every multiple of 16 up to 128 and for 256
(``ops/attention.KERNEL_HEAD_DIMS``) and take every head dim: up to 256 any
other than those zero-padded to the next instance, above 256 in chunks of
256 (``csrc/flash_chunked.cuh``); the wrappers check it with
``check_head_dim`` before anything else and raise, naming the set, on a head
dim below 1.  That is checked here without a card: the kernel-only
entry points refuse CPU tensors after the head-dim check, so a head dim the
kernels take gets to the device check and 0 does not.  The head dims the
wrappers refused before the padding (8, 24, 136, 256) and before the chunked
form (272, 512) now get to the device check.

The plain versions (what a CPU tensor takes, and what the kernels are held
to on the card) at hd 64 and 32 with GQA 2:1 against the JAX
``flash_causal_self_attention`` run in interpret mode (its Pallas forward
and backward kernels) through ``jax.vjp``, fp32, with the tolerances of
``tests/test_torch_flash_causal_vjp.py``: forward atol 2e-5, gradients atol
5e-5 and rtol 1e-3, m and l rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.ops.flash_causal_vjp import _fwd, flash_causal_self_attention
from unirec_tpu_torch.ops import flash_causal as fc
from unirec_tpu_torch.ops.attention import KERNEL_HEAD_DIMS, check_head_dim

FWD_ATOL, GRAD_ATOL, GRAD_RTOL, STAT_RTOL = 2e-5, 5e-5, 1e-3, 1e-5
FORMERLY_REFUSED = (8, 24, 136, 256, 272, 512)
REFUSED = (0,)
SHAPES = [(2, 72, 4, 2, 64), (2, 72, 4, 2, 32)]  # (B, L, Hq, Hkv, hd)


def _inputs(hd, hq=4, hkv=2, b=1, l=8):
    q = torch.randn(b, l, hq * hd)
    kv = torch.randn(b, l, hkv * hd)
    return q, kv


@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
def test_wrappers_take_each_kernel_head_dim(hd):
    check_head_dim("K1", hd)
    q, kv = _inputs(hd)
    # past the head-dim check, a CPU tensor is refused by the device check
    with pytest.raises(ValueError, match="unsupported device"):
        fc._check_kernel_inputs("K1", 4, q, kv, kv)


@pytest.mark.parametrize("hd", FORMERLY_REFUSED)
def test_wrappers_take_padded_and_wide_head_dims(hd):
    check_head_dim("K1", hd)
    q, kv = _inputs(hd)
    m = torch.zeros(1, 8, 4)
    # past the head-dim check, a CPU tensor is refused by the device check
    with pytest.raises(ValueError, match="unsupported device"):
        fc._check_kernel_inputs("K1", 4, q, kv, kv)
    with pytest.raises(ValueError, match="unsupported device"):
        fc.flash_causal_bwd_dq(q, kv, kv, torch.ones(1, 8), q, m, m, m, 4, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        fc.flash_causal_bwd_dkv(q, kv, kv, torch.ones(1, 8), q, m, m, m, 4, 2)


@pytest.mark.parametrize("hd", REFUSED)
def test_wrappers_refuse_other_head_dims_naming_the_set(hd):
    with pytest.raises(ValueError, match=r"head_dim in \(16, 32"):
        check_head_dim("K1", hd)
    q, kv = _inputs(hd)
    m = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="head_dim"):
        fc._check_kernel_inputs("K1", 4, q, kv, kv)
    with pytest.raises(ValueError, match="head_dim"):
        fc.flash_causal_bwd_dq(q, kv, kv, torch.ones(1, 8), q, m, m, m, 4, 2)
    with pytest.raises(ValueError, match="head_dim"):
        fc.flash_causal_bwd_dkv(q, kv, kv, torch.ones(1, 8), q, m, m, m, 4, 2)


def _data(shape, seed):
    b, l, hq, hkv, hd = shape
    rng = np.random.RandomState(seed)
    q = rng.randn(b, l, hq * hd).astype(np.float32)
    k = rng.randn(b, l, hkv * hd).astype(np.float32)
    v = rng.randn(b, l, hkv * hd).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[0, 8:40] = 0.0   # a run of padded keys inside the row
    mask[-1, l // 2:] = 0.0  # a right-padded row
    ct = rng.randn(b, l, hq * hd).astype(np.float32)
    return q, k, v, mask, ct


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"hd{s[-1]}")
def test_plain_forward_and_backward_match_jax_kernels(shape):
    _, _, hq, hkv, _ = shape
    q, k, v, mask, ct = _data(shape, seed=shape[-1])
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fc.flash_causal_attention_train(qt, kt, vt, torch.tensor(mask), hq,
                                          hkv)
    (out * torch.tensor(ct)).sum().backward()

    fn = lambda q_, k_, v_: flash_causal_self_attention(  # noqa: E731
        q_, k_, v_, jnp.asarray(mask), hq, hkv, block=8, interpret=True)
    want, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=0)
    for got, ref, name in zip((qt.grad, kt.grad, vt.grad), vjp(
            jnp.asarray(ct)), ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    padded = torch.tensor(mask) == 0
    assert (kt.grad[padded] == 0).all() and (vt.grad[padded] == 0).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"hd{s[-1]}")
def test_plain_stats_match_jax_forward_kernel(shape):
    """K1's training form (o, m, l), plain, against the JAX forward kernel's
    (o, m, l) in interpret mode."""
    _, l, hq, hkv, _ = shape
    q, k, v, mask, _ = _data(shape, seed=shape[-1] + 1)
    o, m, den = fc.flash_causal_attention_fwd_plain(
        *(torch.tensor(a) for a in (q, k, v, mask)), hq, hkv)
    bias3 = jnp.asarray((1.0 - mask)[:, None, :] * -1e9)
    o_j, m_j, l_j = _fwd(*(jnp.asarray(a) for a in (q, k, v)), bias3, hq, hkv,
                         8, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j)[:, :l],
                               atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j)[:, :l, :hq],
                               rtol=STAT_RTOL, atol=1e-6)
    np.testing.assert_allclose(den.numpy(), np.asarray(l_j)[:, :l, :hq],
                               rtol=STAT_RTOL, atol=0)
