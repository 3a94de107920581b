"""The streaming cross-attention kernels' plain versions against the JAX
package's Pallas kernels in interpret mode, at the JAX tests' sizes and
tolerances (``tests/test_flash_vjp.py``): B13 (``flash_cross_attention``,
atol 2e-5) with and without a bias, over a memory that is not a multiple of
the kernels' tiles and with a fully masked row; B14's forward (o, m, l) and
its backward's dq / dk3 / dv3; the trainable ``flash_cross_attention_proj_vjp``
through ``torch.autograd`` against ``jax.grad`` (loss rtol 1e-5, gradients
atol 1e-4 rtol 2e-3), including a non-aligned memory and a fully masked row
with kv padding; the B13 dispatch predicate; and, in bf16, B14's gradients
of queries shared by every user against plain attention's, both held to
float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.ops import attention as jatt
from unirec_tpu.ops import flash_vjp as jvjp
from unirec_tpu_torch.ops import attention as patt
from unirec_tpu_torch.ops import flash_vjp as pvjp

HD = 16


def _bias(mask):
    return np.array(jatt.make_additive_mask(jnp.asarray(mask)))


def _mask(rng, b, lkv, masked_row=None):
    mask = (rng.rand(b, lkv) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    if masked_row is not None:
        mask[masked_row] = 0.0  # a user whose whole history is missing
    return mask


@pytest.mark.parametrize("lkv,with_bias,masked_row", [
    (150, True, None), (200, True, 1), (200, False, None), (256, True, 0)],
    ids=["ragged_150", "ragged_200_masked_row", "no_bias", "aligned_masked"])
def test_b13_plain_matches_jax_kernel(lkv, with_bias, masked_row):
    rng = np.random.RandomState(lkv)
    b, h, lq = 2, 2, 8
    q, k, v = (rng.randn(b, h, n, HD).astype(np.float32)
               for n in (lq, lkv, lkv))
    bias = _bias(_mask(rng, b, lkv, masked_row)) if with_bias else None
    want = jatt.flash_cross_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), block_kv=128,
        interpret=True)
    before = patt.flash_cross_attention.launches
    got = patt.flash_cross_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias))
    assert patt.flash_cross_attention.launches == before  # plain on the CPU
    assert got.shape == (b, h, lq, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    if masked_row is not None:  # the uniform average of the real keys
        np.testing.assert_allclose(got[masked_row].numpy(),
                                   np.broadcast_to(v[masked_row].mean(
                                       axis=1, keepdims=True), (h, lq, HD)),
                                   atol=2e-5, rtol=1e-4)


def _proj_inputs(seed, b, lq, lkv, d, masked_row=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, d).astype(np.float32)
    mem = rng.randn(b, lkv, d).astype(np.float32)
    wk, wv = (rng.randn(d, d).astype(np.float32) * 0.1 for _ in range(2))
    bk, bv = (rng.randn(d).astype(np.float32) * 0.1 for _ in range(2))
    bias = _bias(_mask(rng, b, lkv, masked_row))
    return [q, mem, wk, bk, wv, bv], bias


@pytest.mark.parametrize("lkv,masked_row", [(200, 1), (150, None)],
                         ids=["padded_masked_row", "non_aligned"])
def test_b14_fwd_and_bwd_plain_match_jax_kernels(lkv, masked_row):
    """The kernels' own contract: (o, m, l) of ``_mh_fwd`` (m and l per
    head in the lane columns) and (dq, dk3, dv3) of ``_mh_bwd``."""
    (q, mem, wk, bk, wv, _), bias = _proj_inputs(5, 2, 8, lkv, 32, masked_row)
    h = 2
    k3, v3 = mem @ wk + bk, mem @ wk.T - bk  # any two [B, Lkv, D] tensors
    do = np.random.RandomState(6).randn(*q.shape).astype(np.float32)
    jo, jm, jl = jvjp._mh_fwd(jnp.asarray(q), jnp.asarray(k3), jnp.asarray(v3),
                              jnp.asarray(bias), h, block_kv=512,
                              interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    bias32 = patt.key_bias(t(bias), 2, lkv, "cpu")
    o, m, l = pvjp.flash_cross_fwd(t(q), t(k3), t(v3), bias32, h)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=1e-4)
    # the row max of scores whose dot products round in another order
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[:, :8, :h],
                               rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[:, :8, :h],
                               rtol=1e-5)
    jdq, jdk, jdv = jvjp._mh_bwd(
        jnp.asarray(q), jnp.asarray(k3), jnp.asarray(v3), jnp.asarray(bias),
        jo, jm, jl, jnp.asarray(do), h, block_kv=512, interpret=True)
    dsum = pvjp.attention_dsum(t(do), o, h)
    got = pvjp.flash_cross_bwd(t(q), t(k3), t(v3), bias32, t(do), m, l, dsum, h)
    for g, want, name in zip(got, (jdq, jdk, jdv), ("dq", "dk3", "dv3")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("lkv,masked_row", [(256, None), (150, None),
                                            (200, 1)],
                         ids=["aligned", "non_aligned", "masked_row_kv_pad"])
def test_proj_vjp_matches_jax(lkv, masked_row):
    """The JAX test's loss, sum(out ** 2), through both gradients."""
    arrays, bias = _proj_inputs(lkv, 2, 8, lkv, 32, masked_row)
    h = 2

    def jloss(*a):
        out = jvjp.flash_cross_attention_proj_vjp(*a, jnp.asarray(bias), h,
                                                  512, True)
        return jnp.sum(out ** 2)

    jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in arrays])
    # torch weights are [out, in]: Wk^T of the JAX kernel [in, out]
    targs = [torch.tensor(a.T if i in (2, 4) else a, requires_grad=True)
             for i, a in enumerate(arrays)]
    out = pvjp.flash_cross_attention_proj_vjp(*targs, torch.from_numpy(bias),
                                              num_heads=h)
    loss = (out ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)
    for i, (t, want, name) in enumerate(zip(
            targs, jg, ("q", "mem", "wk", "bk", "wv", "bv"))):
        got = t.grad.numpy().T if i in (2, 4) else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                   rtol=2e-3, err_msg=f"d{name}")


def test_b13_dispatch_predicate():
    assert patt.FLASH_MIN_KV == jatt._FLASH_MIN_KV
    assert patt.use_flash_cross(True, True, 1024)
    assert patt.use_flash_cross(True, True, 1600)
    assert not patt.use_flash_cross(True, True, 1023)  # short memory
    assert not patt.use_flash_cross(True, False, 1600)  # training forward
    assert not patt.use_flash_cross(False, True, 1600)  # not on the card


def test_cross_attention_on_cpu_takes_the_plain_path():
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, n, HD).astype(np.float32))
               for n in (4, 1100, 1100))
    before = patt.flash_cross_attention.launches
    got = patt.cross_attention(q, k, v)
    want = jatt.attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                          jnp.asarray(v.numpy()))
    assert patt.flash_cross_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def _shared_query_grads(flash, dtype, arrays, h):
    """d(shared q) and dWk of sum(out * ct) where every user's queries are
    one tensor (the first cross layer's, before any user input), through B14
    or through plain attention with autograd."""
    q, mem, wk, bk, wv, bv, ct = (torch.from_numpy(a) for a in arrays)
    q.requires_grad_()
    wk.requires_grad_()
    qq = q.to(dtype).expand(mem.shape[0], *q.shape[1:])
    m = mem.to(dtype)
    if flash:
        out = pvjp.flash_cross_attention_proj_vjp(qq, m, wk, bk, wv, bv,
                                                  num_heads=h)
    else:
        k3 = m @ wk.to(dtype).t() + bk.to(dtype)
        v3 = m @ wv.to(dtype).t() + bv.to(dtype)
        out = patt.merge_heads(patt.attention(*(
            patt.split_heads(t, h) for t in (qq, k3, v3))))
    (out.float() * ct).sum().backward()
    return q.grad.double().flatten(), wk.grad.double().flatten()


def test_b14_bf16_gradients_keep_plain_attention_accuracy():
    """In bf16, B14's query and key weight gradients are as close to the
    float32 ones as plain attention's: with queries shared by every user
    and a memory with a common component they are sums of nearly
    cancelling terms, which a dsum taken from the bf16-rounded O (every ds
    of a row shifted by one rounding) pushed to 0.98 cosine."""
    rng = np.random.RandomState(0)
    b, lq, lkv, d, h = 8, 8, 200, 32, 2
    q = rng.randn(1, lq, d).astype(np.float32)
    mem = (rng.randn(b, lkv, d) + 3 * rng.randn(1, 1, d)).astype(np.float32)
    wk, wv = (rng.randn(d, d).astype(np.float32) * d ** -0.5
              for _ in range(2))
    bk, bv = (rng.randn(d).astype(np.float32) * 0.1 for _ in range(2))
    ct = rng.randn(b, lq, d).astype(np.float32)
    arrays = (q, mem, wk, bk, wv, bv, ct)
    ref = _shared_query_grads(False, torch.float32, arrays, h)
    plain = _shared_query_grads(False, torch.bfloat16, arrays, h)
    flash = _shared_query_grads(True, torch.bfloat16, arrays, h)

    def gap(x, y):
        return 1.0 - (x @ y / (x.norm() * y.norm())).item()

    for name, r, p, f in zip(("q", "wk"), ref, plain, flash):
        assert gap(f, r) <= 2 * gap(p, r), (name, gap(f, r), gap(p, r))
