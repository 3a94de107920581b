"""B14p, the port's ``flash_cross_attention_vjp`` (per-head trainable
streaming cross-attention), against the JAX package's Pallas kernels in
interpret mode (``flash_cross_attention_vjp(q, k, v, bias, 128, True)``),
case for case with the kernel tests of ``tests/test_flash_vjp.py`` and at
their tolerances: forward atol 2e-5 / rtol 1e-4, gradients atol 5e-5 /
rtol 1e-3 (fp32 sums in another order than XLA's on the CPU).  On the CPU
the port runs its plain versions; the kernel contract (o, m, l of ``_fwd``
and dq, dk, dv of ``_bwd``) is held the same way.  Inputs are made with
numpy from a seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.ops import attention as jatt
from unirec_tpu.ops import flash_vjp as jvjp
from unirec_tpu_torch.ops import attention as patt
from unirec_tpu_torch.ops import flash_vjp as pvjp


B, H, LQ, LKV, HD = 2, 3, 16, 384, 32
FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)


def _jax(q, k, v, bias):
    return jvjp.flash_cross_attention_vjp(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if bias is None else jnp.asarray(bias), 128, True)


def _port(q, k, v, bias):
    return pvjp.flash_cross_attention_vjp(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if bias is None else torch.from_numpy(bias))


def _grads(q, k, v, bias, ct=None):
    """d/d(q, k, v) of sum(out * ct) (sum(out ** 2) without ct), through
    jax.grad of the Pallas kernels and torch.autograd.grad of the port."""
    def jloss(a, b2, c):
        out = jvjp.flash_cross_attention_vjp(
            a, b2, c, None if bias is None else jnp.asarray(bias), 128, True)
        return jnp.sum(out * ct) if ct is not None else jnp.sum(out ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = pvjp.flash_cross_attention_vjp(
        *leaves, None if bias is None else torch.from_numpy(bias))
    loss = ((out * torch.from_numpy(ct)).sum() if ct is not None
            else (out ** 2).sum())
    got = torch.autograd.grad(loss, leaves)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    q = rng.randn(B, H, LQ, HD).astype(np.float32)
    k = rng.randn(B, H, LKV, HD).astype(np.float32)
    v = rng.randn(B, H, LKV, HD).astype(np.float32)
    mask = (rng.rand(B, LKV) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    bias = np.array(jatt.make_additive_mask(jnp.asarray(mask)))
    return q, k, v, bias


def test_forward_matches_jax(data):
    before = pvjp.flash_cross_vjp_fwd.launches
    out = _port(*data)
    assert pvjp.flash_cross_vjp_fwd.launches == before  # plain on the CPU
    assert out.shape == (B, H, LQ, HD) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(_jax(*data)),
                               **FWD_TOL)


def test_gradients_match_jax(data):
    ct = np.random.RandomState(1).randn(B, H, LQ, HD).astype(np.float32)
    got, want = _grads(*data, ct)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"d{name}")


def test_masked_keys_get_exactly_zero_grad(data):
    q, k, v, bias = data
    leaves = [torch.tensor(a, requires_grad=True) for a in (k, v)]
    out = pvjp.flash_cross_attention_vjp(torch.from_numpy(q), *leaves,
                                         torch.from_numpy(bias))
    dk, dv = torch.autograd.grad(out.sum(), leaves)
    invalid = bias[:, 0, 0, :] != 0.0  # [B, LKV]
    assert invalid.any()
    for b in range(B):
        assert (dk[b][:, invalid[b]] == 0).all()
        assert (dv[b][:, invalid[b]] == 0).all()
    want = jax.grad(lambda a, c: jnp.sum(jvjp.flash_cross_attention_vjp(
        jnp.asarray(q), a, c, jnp.asarray(bias), 128, True)),
        argnums=(0, 1))(jnp.asarray(k), jnp.asarray(v))
    for g, w in zip((dk, dv), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_fully_masked_row_is_uniform_and_finite():
    """Every key masked: the uniform average of v, as the JAX kernel and
    XLA's softmax give, with finite gradients that match the kernel's."""
    rng = np.random.RandomState(2)
    q = rng.randn(1, 1, 8, HD).astype(np.float32)
    k = rng.randn(1, 1, 128, HD).astype(np.float32)
    v = rng.randn(1, 1, 128, HD).astype(np.float32)
    bias = np.array(jatt.make_additive_mask(jnp.zeros((1, 128))))
    out = _port(q, k, v, bias).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(_jax(q, k, v, bias)),
                               **FWD_TOL)
    np.testing.assert_allclose(out, np.broadcast_to(
        v.mean(axis=2, keepdims=True), out.shape), **FWD_TOL)
    got, want = _grads(q, k, v, bias)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_odd_shapes_and_no_bias():
    rng = np.random.RandomState(3)
    q = rng.randn(1, 2, 5, HD).astype(np.float32)     # Lq 5
    k = rng.randn(1, 2, 200, HD).astype(np.float32)   # Lkv 200
    v = rng.randn(1, 2, 200, HD).astype(np.float32)
    np.testing.assert_allclose(_port(q, k, v, None).numpy(),
                               np.asarray(_jax(q, k, v, None)), **FWD_TOL)
    got, want = _grads(q, k, v, None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_fully_masked_row_with_kv_padding():
    """Lkv 200 (the JAX kernel pads it to 256) and one batch row masked
    whole: its real keys share the probability uniformly, padding none."""
    rng = np.random.RandomState(7)
    q = rng.randn(2, 2, 8, HD).astype(np.float32)
    k = rng.randn(2, 2, 200, HD).astype(np.float32)
    v = rng.randn(2, 2, 200, HD).astype(np.float32)
    mask = np.ones((2, 200), np.float32)
    mask[1, :] = 0.0
    bias = np.array(jatt.make_additive_mask(jnp.asarray(mask)))
    out = _port(q, k, v, bias).numpy()
    np.testing.assert_allclose(out, np.asarray(_jax(q, k, v, bias)),
                               **FWD_TOL)
    np.testing.assert_allclose(out[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), out[1].shape), **FWD_TOL)
    got, want = _grads(q, k, v, bias)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("lkv,masked_row", [(384, None), (200, 1)],
                         ids=["aligned", "kv_pad_masked_row"])
def test_kernel_contract_matches_jax(lkv, masked_row):
    """The kernels' own outputs: (o, m, l) of ``_fwd`` (m and l per row in
    lane column 0, here [B, Lq, H]) and (dq, dk, dv) of ``_bwd`` from the
    same (m, l) and dsum = rowsum(dO * O)."""
    rng = np.random.RandomState(lkv)
    q, k, v = (rng.randn(2, 3, n, HD).astype(np.float32)
               for n in (LQ, lkv, lkv))
    mask = (rng.rand(2, lkv) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    if masked_row is not None:
        mask[masked_row] = 0.0
    bias = np.array(jatt.make_additive_mask(jnp.asarray(mask)))
    do = rng.randn(*q.shape).astype(np.float32)
    jq, jk, jv, jb, jdo = (jnp.asarray(a) for a in (q, k, v, bias, do))
    jo, jm, jl = jvjp._fwd(jq, jk, jv, jb, block_kv=128, interpret=True)
    t = torch.from_numpy
    bias32 = patt.key_bias(t(bias), 2, lkv, "cpu")
    o, m, l = pvjp.flash_cross_vjp_fwd(t(q), t(k), t(v), bias32)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    jm_rows = np.asarray(jm)[:, :, :LQ, 0].transpose(0, 2, 1)
    jl_rows = np.asarray(jl)[:, :, :LQ, 0].transpose(0, 2, 1)
    np.testing.assert_allclose(m.numpy(), jm_rows, rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), jl_rows, rtol=1e-5)
    jdq, jdk, jdv = jvjp._bwd(jq, jk, jv, jb, jo, jm, jl, jdo, block_kv=128,
                              interpret=True)
    dsum = (t(do) * o).sum(-1).transpose(1, 2).contiguous()
    before = pvjp.flash_cross_vjp_bwd.launches
    got = pvjp.flash_cross_vjp_bwd(t(q), t(k), t(v), bias32, t(do), m, l,
                                   dsum)
    assert pvjp.flash_cross_vjp_bwd.launches == before
    for g, w, name in zip(got, (jdq, jdk, jdv), ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_bias_gets_no_gradient_and_b14_shares_the_plain_versions(data):
    """The bias is a validity mask: no gradient, as the JAX VJP's zeros.
    B14's merged-head plain forward is B14p's on per-head views."""
    q, k, v, bias = data
    tb = torch.tensor(bias, requires_grad=True)
    tq = torch.tensor(q, requires_grad=True)
    out = pvjp.flash_cross_attention_vjp(tq, torch.from_numpy(k),
                                         torch.from_numpy(v), tb)
    out.sum().backward()
    assert tb.grad is None and tq.grad is not None
    merged = [patt.merge_heads(torch.from_numpy(a)) for a in (q, k, v)]
    bias32 = patt.key_bias(torch.from_numpy(bias), B, LKV, "cpu")
    o, m, l = pvjp.flash_cross_fwd(*merged, bias32, H)
    o_h, m_h, l_h = pvjp.flash_cross_vjp_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), bias32)
    assert torch.equal(o, patt.merge_heads(o_h))
    assert torch.equal(m, m_h) and torch.equal(l, l_h)


def test_wrong_shapes_raise():
    q = torch.zeros(2, 3, 4, 32)
    with pytest.raises(ValueError, match="bad shapes"):
        pvjp.flash_cross_attention_vjp(q, torch.zeros(2, 3, 8, 16),
                                       torch.zeros(2, 3, 8, 16))


def test_b14_one_head_of_768_matches_jax_kernels():
    """B14 (merged heads) at one head of 768, three chunks of 256 on the
    card: the plain forward (o, m, l) and backward (dq, dk3, dv3) against
    ``_mh_fwd`` and ``_mh_bwd`` in interpret mode, at the B14 contract
    test's tolerances (``tests/test_torch_flash_cross.py``)."""
    rng = np.random.RandomState(768)
    b, lq, lkv, d = 2, 8, 150, 768
    q, do = (rng.randn(b, lq, d).astype(np.float32) for _ in range(2))
    k3, v3 = (rng.randn(b, lkv, d).astype(np.float32) for _ in range(2))
    mask = (rng.rand(b, lkv) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    bias = np.array(jatt.make_additive_mask(jnp.asarray(mask)))
    jq, jk, jv, jb, jdo = (jnp.asarray(a) for a in (q, k3, v3, bias, do))
    jo, jm, jl = jvjp._mh_fwd(jq, jk, jv, jb, 1, block_kv=512, interpret=True)
    t = torch.from_numpy
    bias32 = patt.key_bias(t(bias), b, lkv, "cpu")
    o, m, l = pvjp.flash_cross_fwd(t(q), t(k3), t(v3), bias32, 1)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[:, :lq, :1],
                               rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[:, :lq, :1],
                               rtol=1e-5)
    jdq, jdk, jdv = jvjp._mh_bwd(jq, jk, jv, jb, jo, jm, jl, jdo, 1,
                                 block_kv=512, interpret=True)
    dsum = pvjp.attention_dsum(t(do), o, 1)
    got = pvjp.flash_cross_bwd(t(q), t(k3), t(v3), bias32, t(do), m, l, dsum,
                               1)
    for g, want, name in zip(got, (jdq, jdk, jdv), ("dq", "dk3", "dv3")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=2e-3, err_msg=name)
